"""Synthetic argon input-tree generator (reference on-disk formats).

The reference's glow-discharge workload reads its chemistry from a
`file_input/<model>/` tree of config + LUT files (the `4_particles` model,
Becker et al. CPC 180 (2009) 1230 data). That data is not redistributed
here; instead this module *generates* a physically-plausible three-level
argon dataset from standard closed-form rate fits (Lymberopoulos &
Economou, J. Appl. Phys. 73 (1993) 3668 style Arrhenius forms) and writes
it in the exact formats the parsers consume — so the full pipeline
(speclist -> reaction matrices -> LUTs -> interpolation -> sources) is
exercised end-to-end, and a user can swap in the real Becker tables
unchanged.

The port's own copy of the JAX package's `models/argon_synth.py` (numpy
only): the files it writes are byte-identical to the JAX package's.

Scheme (same structure as the reference's
`tests/integrated_tests/glow_discharge/file_input/4_particles/reacscheme.cfg`):

  Ar[1p0] + e   -> Ar[*] + e            ex    Uin: 11.55   k_001
  Ar[1p0] + e   -> Ar[+] + e + e        io    Uin: 15.76   k_002
  Ar[*] + e     -> Ar[1p0] + e          deex  Uin: -11.55  k_003
  Ar[*] + e     -> Ar[+] + e + e        io    Uin: 4.21    k_004
  Ar[*] + Ar[*] -> Ar[+] + e + Ar[1p0]  chio  Uin: -7.34   k_005
  Ar[*]         -> 0                    loss  Uin: 0       k_lifetime
  Ar[1p0] + e   -> Ar[1p0] + e          el    Uin: 1.0     Pelastic
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..constants import M_atomic, me

M_AR = 39.948 * M_atomic

_HEADER = """\
################################################################################
#
# Description: {desc}
# Data source: synthetic fit (fedm_tpu.models.argon_synth)
# Data:        {data}
# Dependence:  {dep}
#
################################################################################

"""


def _write_lut(path: Path, desc: str, data: str, dep: str, kx, ky) -> None:
    with open(path, "w") as f:
        f.write(_HEADER.format(desc=desc, data=data, dep=dep))
        for x, y in zip(kx, ky):
            f.write(f"{x:.6E}    {y:.6E}\n")


def _write_const(path: Path, desc: str, data: str, value: float) -> None:
    with open(path, "w") as f:
        f.write(_HEADER.format(desc=desc, data=data, dep="const"))
        f.write(f"{value:.6E}\n")


# closed-form fits (mean energy eps in eV; Te = 2*eps/3)
def k_excitation(eps):
    return 2.48e-14 * eps**0.33 * np.exp(-12.78 / np.maximum(eps, 1e-3))


def k_ionization(eps):
    return 2.34e-14 * eps**0.59 * np.exp(-17.44 / np.maximum(eps, 1e-3))


def k_deexcitation(eps):
    return 4.3e-16 * eps**0.74


def k_stepwise_ionization(eps):
    return 6.8e-15 * eps**0.67 * np.exp(-4.20 / np.maximum(eps, 1e-3))


def p_elastic(eps):
    # elastic energy-loss coefficient per gas atom: 3 (me/M) k_el * (2 eps/3)
    k_el = 1.0e-13 * np.sqrt(np.maximum(eps, 1e-6)) / (1.0 + 0.1 * eps)
    return 3.0 * (me / M_AR) * k_el * (2.0 * eps / 3.0)


def n_mu_electron(eps):
    # N*mu_e [1/(V m s)], weakly energy dependent
    return 1.0e25 / np.sqrt(1.0 + eps / 4.0)


def n_d_electron(eps):
    # Einstein-like: N*D = N*mu * (2 eps / 3)
    return n_mu_electron(eps) * (2.0 * eps / 3.0)


def n_mu_ion(red_field):
    # N*mu_i [1/(V m s)] vs E/N [Td], mild field dependence
    return 4.65e21 / np.sqrt(1.0 + (red_field / 100.0) ** 2) + 1.0e21


K_CHEMO = 6.2e-16      # Ar* + Ar* -> Ar+ + e + Ar [m^3/s]
K_LIFETIME = 3.145e5   # effective Ar* loss [1/s]
N_D_ARSTAR = 2.42e20   # N*D for Ar* [1/(m s)]

SPECLIST = """\
# species list (synthetic argon model)
Ar[1p0]     file: Ar_1p0.cfg
Ar[*]       file: Ar_star.cfg
Ar[+]       file: Ar_plus.cfg
e           file: electrons.cfg

nInd = [0, 1]
iInd = 2
eInd = 3
"""

REACSCHEME = """\
# 3-level argon model: electrons (e), ions (Ar[+]), excited atoms (Ar[*])
Ar[1p0] + e   -> Ar[*] + e              Type: ex    Uin: 11.55      Qfile: Q1.dat    kfile: k_001.dat
Ar[1p0] + e   -> Ar[+] + e + e          Type: io    Uin: 15.76      Qfile: Q2.dat    kfile: k_002.dat
Ar[*] + e     -> Ar[1p0] + e            Type: deex  Uin: -11.55     Qfile: Q3.dat    kfile: k_003.dat
Ar[*] + e     -> Ar[+] + e + e          Type: io    Uin: 4.21       Qfile: Q4.dat    kfile: k_004.dat
Ar[*] + Ar[*] -> Ar[+] + e + Ar[1p0]    Type: chio  Uin: -7.34      Qfile: Q5.dat    kfile: k_005.dat
Ar[*]         -> 0                      Type: loss  Uin: 0          Qfile: Q6.dat    kfile: k_lifetime.dat

# electron energy loss by elastic collisions (Uin = 1: loss = Pelastic*N*ne)
Ar[1p0] + e -> Ar[1p0] + e          Type: el    Uin: 1.0        Qfile: Q1.dat    kfile: Pelastic.dat
"""

SPECIES = {
    "Ar_1p0.cfg": ("0", 6.633521e-26, 3),
    "Ar_star.cfg": ("0", 6.633521e-26, 2),
    "Ar_plus.cfg": ("1", 6.63352032e-26, 2),
    "electrons.cfg": ("-1", 9.10938356e-31, 3),
}


def generate_argon_input(base: Path, model: str = "argon_synth") -> Path:
    """Write the full input tree under `base/<model>/`; returns the model
    directory. `base` plays the role of `files.file_input`."""
    base = Path(base)
    root = base / model
    (root / "rate_coefficients").mkdir(parents=True, exist_ok=True)
    (root / "transport_coefficients").mkdir(exist_ok=True)
    (root / "species").mkdir(exist_ok=True)

    (root / "speclist.cfg").write_text(SPECLIST)
    (root / "reacscheme.cfg").write_text(REACSCHEME)
    for name, (z, mass, nmom) in SPECIES.items():
        (root / "species" / name).write_text(
            f"Z    = {z}\nMass = {mass}\nNmom = {nmom}\n")

    eps = np.geomspace(0.01, 100.0, 200)  # mean energy grid [eV]
    rc = root / "rate_coefficients"
    _write_lut(rc / "k_001.dat", "excitation rate", "Umean [eV]  k [m^3/s]",
               "Umean", eps, k_excitation(eps))
    _write_lut(rc / "k_002.dat", "ionisation rate", "Umean [eV]  k [m^3/s]",
               "Umean", eps, k_ionization(eps))
    _write_lut(rc / "k_003.dat", "deexcitation rate", "Umean [eV]  k [m^3/s]",
               "Umean", eps, k_deexcitation(eps))
    _write_lut(rc / "k_004.dat", "stepwise ionisation rate",
               "Umean [eV]  k [m^3/s]", "Umean", eps,
               k_stepwise_ionization(eps))
    _write_const(rc / "k_005.dat", "chemoionisation rate", "const k [m^3/s]",
                 K_CHEMO)
    _write_const(rc / "k_lifetime.dat", "metastable loss", "const k [1/s]",
                 K_LIFETIME)
    _write_lut(rc / "Pelastic.dat", "elastic energy loss",
               "Umean [eV]  Pelastic/N [eV m^3/s]", "Umean", eps,
               p_elastic(eps))

    tc = root / "transport_coefficients"
    _write_const(tc / "Ar_1p0_ND.dat", "background diffusion",
                 "const N*D [1/(m s)]", 0.0)
    _write_const(tc / "Ar_star_ND.dat", "metastable diffusion",
                 "const N*D [1/(m s)]", N_D_ARSTAR)
    red = np.geomspace(0.1, 2000.0, 120)  # E/N grid [Td]
    _write_lut(tc / "Ar_plus_Nb.dat", "ion mobility", "E/N [Td]  N*b [1/(V m s)]",
               "E/N", red, n_mu_ion(red))
    with open(tc / "Ar_plus_ND.dat", "w") as f:
        f.write(_HEADER.format(desc="ion diffusion (Einstein relation)",
                               data="ESR", dep="ESR"))
    _write_lut(tc / "electrons_Nb.dat", "electron mobility",
               "Umean [eV]  N*b [1/(V m s)]", "Umean", eps, n_mu_electron(eps))
    _write_lut(tc / "electrons_ND.dat", "electron diffusion",
               "Umean [eV]  N*D [1/(m s)]", "Umean", eps, n_d_electron(eps))
    return root


# -- extended He/air-style scheme (8 species) ---------------------------------

SPECLIST_8 = """\
# species list (extended synthetic argon model, 8 species)
Ar[1p0]     file: Ar_1p0.cfg
Ar[*]       file: Ar_star.cfg
Ar[**]      file: Ar_sstar.cfg
Ar2[*]      file: Ar2_star.cfg
Ar[r]       file: Ar_res.cfg
Ar[+]       file: Ar_plus.cfg
Ar2[+]      file: Ar2_plus.cfg
e           file: electrons.cfg

nInd = [0, 1, 2, 3, 4]
iInd = [5, 6]
eInd = 7
"""

REACSCHEME_8 = """\
# extended argon model: 4 excited levels, atomic + molecular ions
Ar[1p0] + e    -> Ar[*] + e               Type: ex    Uin: 11.55   Qfile: Q1.dat  kfile: k_001.dat
Ar[1p0] + e    -> Ar[**] + e              Type: ex    Uin: 13.10   Qfile: Q1.dat  kfile: k_002.dat
Ar[1p0] + e    -> Ar[r] + e               Type: ex    Uin: 11.72   Qfile: Q1.dat  kfile: k_003.dat
Ar[1p0] + e    -> Ar[+] + e + e           Type: io    Uin: 15.76   Qfile: Q2.dat  kfile: k_004.dat
Ar[*] + e      -> Ar[1p0] + e             Type: deex  Uin: -11.55  Qfile: Q3.dat  kfile: k_005.dat
Ar[*] + e      -> Ar[**] + e              Type: ex    Uin: 1.55    Qfile: Q3.dat  kfile: k_006.dat
Ar[*] + e      -> Ar[+] + e + e           Type: io    Uin: 4.21    Qfile: Q4.dat  kfile: k_007.dat
Ar[**] + e     -> Ar[+] + e + e           Type: io    Uin: 2.66    Qfile: Q4.dat  kfile: k_008.dat
Ar[*] + Ar[*]  -> Ar[+] + e + Ar[1p0]     Type: chio  Uin: -7.34   Qfile: Q5.dat  kfile: k_009.dat
Ar[*] + Ar[1p0] + Ar[1p0] -> Ar2[*] + Ar[1p0]  Type: conv  Uin: 0  Qfile: Q6.dat  kfile: k_010.dat
Ar[+] + Ar[1p0] + Ar[1p0] -> Ar2[+] + Ar[1p0]  Type: conv  Uin: 0  Qfile: Q6.dat  kfile: k_011.dat
Ar2[+] + e     -> Ar[**] + Ar[1p0]        Type: rec   Uin: -2.66   Qfile: Q7.dat  kfile: k_012.dat
Ar2[*] + e     -> Ar2[+] + e + e          Type: io    Uin: 3.66    Qfile: Q4.dat  kfile: k_013.dat
Ar[**]         -> 0                       Type: loss  Uin: 0       Qfile: Q8.dat  kfile: k_lifetime.dat
Ar[r]          -> 0                       Type: loss  Uin: 0       Qfile: Q8.dat  kfile: k_lifetime.dat
Ar2[*]         -> 0                       Type: loss  Uin: 0       Qfile: Q8.dat  kfile: k_lifetime.dat

# electron energy loss by elastic collisions (Uin = 1: loss = Pelastic*N*ne)
Ar[1p0] + e -> Ar[1p0] + e            Type: el    Uin: 1.0     Qfile: Q1.dat  kfile: Pelastic.dat
"""

SPECIES_8 = {
    "Ar_1p0.cfg": ("0", 6.633521e-26, 3),
    "Ar_star.cfg": ("0", 6.633521e-26, 2),
    "Ar_sstar.cfg": ("0", 6.633521e-26, 2),
    "Ar2_star.cfg": ("0", 1.3267042e-25, 2),
    "Ar_res.cfg": ("0", 6.633521e-26, 2),
    "Ar_plus.cfg": ("1", 6.63352032e-26, 2),
    "Ar2_plus.cfg": ("1", 1.3267041e-25, 2),
    "electrons.cfg": ("-1", 9.10938356e-31, 3),
}


def generate_argon8_input(base: Path, model: str = "argon_synth8") -> Path:
    """Write an extended 8-species input tree under `base/<model>/` — the
    'tens of species'-shaped configuration class of BASELINE.json, scaled
    to a test: 4 excited levels (diffusion-reaction), atomic + molecular
    ions (drift-diffusion 'Ion'), electrons, 17 reactions. Exercises the
    generic model builder (`models.generic.PlasmaModel`) on a speclist the
    4-species glow layout cannot represent."""
    base = Path(base)
    root = base / model
    (root / "rate_coefficients").mkdir(parents=True, exist_ok=True)
    (root / "transport_coefficients").mkdir(exist_ok=True)
    (root / "species").mkdir(exist_ok=True)

    (root / "speclist.cfg").write_text(SPECLIST_8)
    (root / "reacscheme.cfg").write_text(REACSCHEME_8)
    for name, (z, mass, nmom) in SPECIES_8.items():
        (root / "species" / name).write_text(
            f"Z    = {z}\nMass = {mass}\nNmom = {nmom}\n")

    eps = np.geomspace(0.01, 100.0, 200)
    rc = root / "rate_coefficients"
    luts = {
        "k_001.dat": k_excitation(eps),
        "k_002.dat": 0.4 * k_excitation(eps) * np.exp(-1.55 / np.maximum(eps, 1e-3)),
        "k_003.dat": 0.7 * k_excitation(eps),
        "k_004.dat": k_ionization(eps),
        "k_005.dat": k_deexcitation(eps),
        "k_006.dat": 1.2e-13 * eps**0.5 * np.exp(-1.55 / np.maximum(eps, 1e-3)),
        "k_007.dat": k_stepwise_ionization(eps),
        "k_008.dat": 1.8 * k_stepwise_ionization(eps),
        "k_013.dat": 1.4 * k_stepwise_ionization(eps),
        "k_012.dat": 8.5e-13 * np.maximum(eps, 1e-3) ** -0.67,
        "Pelastic.dat": p_elastic(eps),
    }
    for name, ky in luts.items():
        _write_lut(rc / name, name, "Umean [eV]  k", "Umean", eps, ky)
    _write_const(rc / "k_009.dat", "chemoionisation", "const", K_CHEMO)
    _write_const(rc / "k_010.dat", "excimer formation", "const", 1.1e-43)
    _write_const(rc / "k_011.dat", "ion conversion", "const", 2.5e-43)
    _write_const(rc / "k_lifetime.dat", "radiative loss", "const", K_LIFETIME)

    tc = root / "transport_coefficients"
    red = np.geomspace(0.1, 2000.0, 120)
    _write_const(tc / "Ar_1p0_ND.dat", "background", "const", 0.0)
    for sp, nd in (("Ar_star", N_D_ARSTAR), ("Ar_sstar", 0.8 * N_D_ARSTAR),
                   ("Ar2_star", 0.5 * N_D_ARSTAR), ("Ar_res", N_D_ARSTAR)):
        _write_const(tc / f"{sp}_ND.dat", "metastable diffusion", "const", nd)
    for sp, scale in (("Ar_plus", 1.0), ("Ar2_plus", 1.15)):
        _write_lut(tc / f"{sp}_Nb.dat", "ion mobility", "E/N [Td]  N*b",
                   "E/N", red, scale * n_mu_ion(red))
        with open(tc / f"{sp}_ND.dat", "w") as f:
            f.write(_HEADER.format(desc="ion diffusion (Einstein relation)",
                                   data="ESR", dep="ESR"))
    _write_lut(tc / "electrons_Nb.dat", "electron mobility",
               "Umean [eV]  N*b", "Umean", eps, n_mu_electron(eps))
    _write_lut(tc / "electrons_ND.dat", "electron diffusion",
               "Umean [eV]  N*D", "Umean", eps, n_d_electron(eps))
    return root


# -- parameterised N-species scheme (BASELINE.json config #5 scale) -----------

def generate_argon_n_input(base: Path, n_excited: int = 13,
                           model: str = None) -> Path:
    """Write a TENS-OF-SPECIES synthetic argon tree: `n_excited` excited
    levels + ground + excimer + atomic/molecular ions + electrons =
    n_excited + 5 species — the scale-out configuration class of
    BASELINE.json ("streamer with extended He/air reaction scheme, tens
    of species") in the reference's exact on-disk formats. Level names
    are zero-padded (`Ar[L01]`) so the reaction parser's substring-count
    convention (`chemistry.parsers.reaction_matrices`, mirroring the
    reference `fedm/file_io.py:486-487`) cannot alias levels.

    Per level k: electron-impact excitation from ground, stepwise
    ionisation, deexcitation, radiative loss; plus the 8-species model's
    chemoionisation, excimer/ion conversion, dissociative recombination
    and elastic energy loss. All rate/transport files go through the same
    LUT pipeline as the 4/8-species trees.
    """
    n_excited = int(n_excited)
    assert n_excited >= 1
    if model is None:
        model = f"argon_synth{n_excited + 5}"
    base = Path(base)
    root = base / model
    (root / "rate_coefficients").mkdir(parents=True, exist_ok=True)
    (root / "transport_coefficients").mkdir(exist_ok=True)
    (root / "species").mkdir(exist_ok=True)

    levels = [f"L{k + 1:02d}" for k in range(n_excited)]
    names = (["Ar[1p0]"] + [f"Ar[{lv}]" for lv in levels]
             + ["Ar2[*]", "Ar[+]", "Ar2[+]", "e"])
    files = (["Ar_1p0.cfg"] + [f"Ar_{lv}.cfg" for lv in levels]
             + ["Ar2_star.cfg", "Ar_plus.cfg", "Ar2_plus.cfg",
                "electrons.cfg"])
    n_sp = len(names)
    spec = ["# species list (parameterised synthetic argon model, "
            f"{n_sp} species)"]
    spec += [f"{n:<12}file: {f}" for n, f in zip(names, files)]
    spec += ["", f"nInd = {list(range(n_excited + 2))}",
             f"iInd = [{n_sp - 3}, {n_sp - 2}]", f"eInd = {n_sp - 1}"]
    (root / "speclist.cfg").write_text("\n".join(spec) + "\n")

    rx = [f"# parameterised argon model: {n_excited} excited levels"]
    kfiles = {}
    eps = np.geomspace(0.01, 100.0, 200)
    for k, lv in enumerate(levels):
        # staggered thresholds walking up toward the 15.76 eV continuum
        U_ex = 11.55 + 4.0 * k / max(n_excited, 1)
        U_io = 15.76 - U_ex
        sc = 1.0 / (1.0 + 0.35 * k)
        kfiles[f"k_ex_{lv}.dat"] = sc * k_excitation(eps) * np.exp(
            -(U_ex - 11.55) / np.maximum(eps, 1e-3))
        kfiles[f"k_io_{lv}.dat"] = (1.0 + 0.1 * k) * k_stepwise_ionization(eps)
        kfiles[f"k_dx_{lv}.dat"] = sc * k_deexcitation(eps)
        rx.append(f"Ar[1p0] + e -> Ar[{lv}] + e  Type: ex    "
                  f"Uin: {U_ex:.2f}  Qfile: Q1.dat  kfile: k_ex_{lv}.dat")
        rx.append(f"Ar[{lv}] + e -> Ar[+] + e + e  Type: io    "
                  f"Uin: {U_io:.2f}  Qfile: Q2.dat  kfile: k_io_{lv}.dat")
        rx.append(f"Ar[{lv}] + e -> Ar[1p0] + e  Type: deex  "
                  f"Uin: -{U_ex:.2f}  Qfile: Q3.dat  kfile: k_dx_{lv}.dat")
        rx.append(f"Ar[{lv}]  -> 0  Type: loss  Uin: 0  "
                  f"Qfile: Q8.dat  kfile: k_lifetime.dat")
    L1 = levels[0]
    rx += [
        f"Ar[1p0] + e -> Ar[+] + e + e  Type: io  Uin: 15.76  "
        f"Qfile: Q2.dat  kfile: k_io_gs.dat",
        f"Ar[{L1}] + Ar[{L1}] -> Ar[+] + e + Ar[1p0]  Type: chio  "
        f"Uin: -7.34  Qfile: Q5.dat  kfile: k_chio.dat",
        f"Ar[{L1}] + Ar[1p0] + Ar[1p0] -> Ar2[*] + Ar[1p0]  Type: conv  "
        f"Uin: 0  Qfile: Q6.dat  kfile: k_excimer.dat",
        "Ar[+] + Ar[1p0] + Ar[1p0] -> Ar2[+] + Ar[1p0]  Type: conv  "
        "Uin: 0  Qfile: Q6.dat  kfile: k_conv.dat",
        f"Ar2[+] + e -> Ar[{L1}] + Ar[1p0]  Type: rec  Uin: -2.66  "
        "Qfile: Q7.dat  kfile: k_rec.dat",
        "Ar2[*] + e -> Ar2[+] + e + e  Type: io  Uin: 3.66  "
        "Qfile: Q4.dat  kfile: k_io_x.dat",
        "Ar2[*]  -> 0  Type: loss  Uin: 0  Qfile: Q8.dat  "
        "kfile: k_lifetime.dat",
        "",
        "# electron energy loss by elastic collisions",
        "Ar[1p0] + e -> Ar[1p0] + e  Type: el  Uin: 1.0  "
        "Qfile: Q1.dat  kfile: Pelastic.dat",
    ]
    (root / "reacscheme.cfg").write_text("\n".join(rx) + "\n")

    for f, (z, mass, nmom) in zip(
            files,
            [("0", M_AR, 3)] + [("0", M_AR, 2)] * n_excited
            + [("0", 2 * M_AR, 2), ("1", M_AR - me, 2),
               ("1", 2 * M_AR - me, 2), ("-1", float(me), 3)]):
        (root / "species" / f).write_text(
            f"Z    = {z}\nMass = {mass}\nNmom = {nmom}\n")

    rc = root / "rate_coefficients"
    kfiles["k_io_gs.dat"] = k_ionization(eps)
    kfiles["k_io_x.dat"] = 1.4 * k_stepwise_ionization(eps)
    kfiles["k_rec.dat"] = 8.5e-13 * np.maximum(eps, 1e-3) ** -0.67
    kfiles["Pelastic.dat"] = p_elastic(eps)
    for name, ky in kfiles.items():
        _write_lut(rc / name, name, "Umean [eV]  k", "Umean", eps, ky)
    _write_const(rc / "k_chio.dat", "chemoionisation", "const", K_CHEMO)
    _write_const(rc / "k_excimer.dat", "excimer formation", "const", 1.1e-43)
    _write_const(rc / "k_conv.dat", "ion conversion", "const", 2.5e-43)
    _write_const(rc / "k_lifetime.dat", "radiative loss", "const",
                 K_LIFETIME)

    tc = root / "transport_coefficients"
    red = np.geomspace(0.1, 2000.0, 120)
    _write_const(tc / "Ar_1p0_ND.dat", "background", "const", 0.0)
    for k, lv in enumerate(levels):
        _write_const(tc / f"Ar_{lv}_ND.dat", "metastable diffusion",
                     "const", N_D_ARSTAR / (1.0 + 0.1 * k))
    _write_const(tc / "Ar2_star_ND.dat", "excimer diffusion", "const",
                 0.5 * N_D_ARSTAR)
    for sp, scale in (("Ar_plus", 1.0), ("Ar2_plus", 1.15)):
        _write_lut(tc / f"{sp}_Nb.dat", "ion mobility", "E/N [Td]  N*b",
                   "E/N", red, scale * n_mu_ion(red))
        with open(tc / f"{sp}_ND.dat", "w") as f:
            f.write(_HEADER.format(desc="ion diffusion (Einstein relation)",
                                   data="ESR", dep="ESR"))
    _write_lut(tc / "electrons_Nb.dat", "electron mobility",
               "Umean [eV]  N*b", "Umean", eps, n_mu_electron(eps))
    _write_lut(tc / "electrons_ND.dat", "electron diffusion",
               "Umean [eV]  N*D", "Umean", eps, n_d_electron(eps))
    return root
