"""Config / reaction-scheme / LUT parsers.

Reads the reference's on-disk input formats unmodified (SURVEY.md section 7
build stage 5), so a FEDM `file_input/<model>/` tree drives this framework
directly:

- `speclist.cfg`: `NAME  file: NAME.cfg` lines (+ignored index hints)
  (the reference FEDM's `fedm/file_io.py:250-270`)
- `reacscheme.cfg`: `A + B -> C + D  Type: io  Uin: 15.76  Qfile: ...
  kfile: k_002.dat` lines (`file_io.py:273-327`)
- per-species `.cfg`: `Z = ...`, `Mass = ...` (`file_io.py:478-521`)
- LUT `.dat` files with `# Dependence:` headers, `_ND.dat` (N*D) /
  `_Nb.dat` (N*b) transport suffixes, missing-mobility tolerance
  (`file_io.py:330-475`)

Reaction matrices use the reference's substring-count convention: species
occurrences are counted with `str.count` on each side of `->`, which is why
species names are bracketed (`Ar[1p0]`, `Ar[+]`, `e`) — a species name that
is a substring of another would miscount (SURVEY.md section 2, component 23).

`fun:*` expression strings are returned as *strings*; evaluation happens
through the safe ast-based compiler (`ops.exprs`), never `eval`.

The port's own copy of the JAX package's `chemistry/parsers.py` (numpy
only, the same outputs). The readers that take `file_input` need it: the
port has no global file registry.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import List, Sequence, Tuple

import numpy as np


def decomment(lines):
    """Strip `#` comments; skip blank/comment-only lines."""
    for line in lines:
        line = line.split("#", 1)[0].strip()
        if line:
            yield line


def read_and_decomment(file_name) -> List[str]:
    with open(file_name, "r", encoding="utf8") as f:
        return list(decomment(f))


def read_single_value(file_name) -> str:
    with open(file_name, "r", encoding="utf8") as f:
        for line in decomment(f):
            return line
    raise RuntimeError(f"No value found in file '{file_name}'")


def read_single_float(file_name) -> float:
    return float(read_single_value(file_name))


def read_single_string(file_name) -> str:
    return str(read_single_value(file_name))


def read_two_columns(file_name) -> Tuple[np.ndarray, np.ndarray]:
    """Whitespace-separated two-column LUT with `#` comments."""
    rows = []
    for line in read_and_decomment(file_name):
        parts = line.split()
        rows.append((float(parts[0]), float(parts[1])))
    data = np.asarray(rows, dtype=np.float64)
    return data[:, 0], data[:, 1]


# -- species list -----------------------------------------------------------


def read_speclist(path) -> Tuple[int, List[str], List[str], List[str]]:
    """Parse `speclist.cfg`; returns (count, species names, property-file
    names, transport-coefficient basenames)."""
    file_name = Path(path) / "speclist.cfg"
    lines = [ln for ln in read_and_decomment(file_name) if "file:" in ln]
    parts = [ln.replace("file:", "").split() for ln in lines]
    names = [p[0] for p in parts]
    prop_files = [p[1] for p in parts]
    tc_names = [p[1].split(".")[0] for p in parts]
    return len(names), names, prop_files, tc_names


# -- reaction scheme --------------------------------------------------------


def reaction_matrices(path, species: Sequence[str]):
    """Build (power, loss, gain) integer matrices [n_reactions, n_species]
    from `reacscheme.cfg` by substring counting on each reaction side."""
    file_name = Path(path) / "reacscheme.cfg"
    reactions = [ln.partition(" Type:")[0] for ln in read_and_decomment(file_name)]
    loss_sides = [rx.partition(" -> ")[0].rstrip() for rx in reactions]
    gain_sides = [rx.partition(" -> ")[2].rstrip() for rx in reactions]

    n_r, n_s = len(reactions), len(species)
    l_counts = np.zeros((n_r, n_s), dtype=int)
    g_counts = np.zeros((n_r, n_s), dtype=int)
    for i in range(n_r):
        for j in range(n_s):
            l_counts[i, j] = loss_sides[i].count(species[j])
            g_counts[i, j] = gain_sides[i].count(species[j])

    power_matrix = l_counts
    net = l_counts - g_counts
    loss_matrix = np.where(net > 0, net, 0)
    gain_matrix = np.where(net < 0, -net, 0)
    return power_matrix, loss_matrix, gain_matrix


_KFILE_RE = re.compile(r"kfile: ([A-Za-z0-9_]+.[A-Za-z0-9_]+)")
_UIN_RE = re.compile(r"Uin:\s?([+-]?\d+.\d+[eE]?[-+]?\d+|0|1.0)")


def rate_coefficient_file_names(path) -> List[Path]:
    """`kfile:` entries of `reacscheme.cfg`, resolved into
    `<path>/rate_coefficients/`."""
    scheme = Path(path) / "reacscheme.cfg"
    rc_dir = Path(path) / "rate_coefficients"
    names = []
    for line in read_and_decomment(scheme):
        names.extend(_KFILE_RE.findall(line))
    return [rc_dir / name for name in names]


def read_energy_loss(path) -> List[float]:
    """`Uin:` energy losses per reaction [eV]. Sentinel encodings pass
    through: values in (7e77, 8e77) later mean `(Ei - mean_energy)`, values
    in (9e99, 1e100) mean `mean_energy` (`fedm/functions.py:905-911`)."""
    scheme = Path(path) / "reacscheme.cfg"
    vals = []
    for line in read_and_decomment(scheme):
        vals.extend(float(v) for v in _UIN_RE.findall(line))
    return vals


# -- dependences and coefficient tables -------------------------------------


def read_dependence(file_name) -> str:
    file_name = Path(file_name)
    if not file_name.is_file():
        raise FileNotFoundError(f"file '{file_name}' not found")
    with open(file_name, "r", encoding="utf8") as f:
        for line in f:
            if "Dependence:" in line:
                return line.split()[2]
    raise RuntimeError(f"No dependence found in file '{file_name}'")


def read_dependences(file_names, zero_if_file_missing: bool = False) -> List:
    deps = []
    for fn in file_names:
        try:
            deps.append(read_dependence(fn))
        except FileNotFoundError:
            if zero_if_file_missing:
                deps.append(0)
            else:
                raise
    return deps


_RATE_FLOAT_DEPS = ["const"]
_RATE_STR_DEPS = ["fun:Te,Tgas", "fun:Tgas"]
_RATE_TWO_COL_DEPS = ["Umean", "E/N", "ElecDist"]


def read_rate_coefficients(rc_file_names, k_dependences):
    """Rate-coefficient tables per dependence kind. Returns (kxs, kys);
    `fun:*` entries keep the raw expression string in ky."""
    if len(rc_file_names) != len(k_dependences):
        raise ValueError("rc_file_names and k_dependences must match in length")
    all_deps = _RATE_FLOAT_DEPS + _RATE_STR_DEPS + _RATE_TWO_COL_DEPS
    for dep in k_dependences:
        if dep not in all_deps:
            raise ValueError(f"rate dependence '{dep}' not recognised")
    kxs, kys = [], []
    for dep, fn in zip(k_dependences, rc_file_names):
        if dep in _RATE_TWO_COL_DEPS:
            kx, ky = read_two_columns(fn)
        elif dep in _RATE_FLOAT_DEPS:
            kx, ky = 0.0, read_single_float(fn)
        else:
            kx, ky = 0.0, read_single_string(fn)
        kxs.append(kx)
        kys.append(ky)
    return kxs, kys


_TRANSPORT_FLOAT_DEPS = ["const", "const."]
_TRANSPORT_STR_DEPS = ["fun:Te,Tgas", "fun:E"]
_TRANSPORT_TWO_COL_DEPS = ["Umean", "E/N", "Tgas", "Te"]


def read_transport_coefficients(particle_names, transport_type: str, model,
                                file_input=None):
    """Transport-coefficient tables for 'Diffusion' (`*_ND.dat`, values N*D)
    or 'mobility' (`*_Nb.dat`, values N*b). A missing mobility file is
    tolerated and yields dependence 0 with zero tables
    (`file_io.py:444-450`). Returns (kxs, kys, dependences); `fun:*`
    expression strings are NOT evaluated here (see module docstring)."""
    if file_input is None:
        raise ValueError("file_input (the directory holding <model>/) is "
                         "required")
    path = Path(file_input) / model / "transport_coefficients"
    if not path.is_dir():
        raise FileNotFoundError(f"transport coefficient dir '{path}' not found")

    all_deps = _TRANSPORT_FLOAT_DEPS + _TRANSPORT_STR_DEPS + _TRANSPORT_TWO_COL_DEPS
    if transport_type == "Diffusion":
        all_deps = all_deps + ["ESR"]
        suffix = "_ND.dat"
    elif transport_type == "mobility":
        all_deps = all_deps + [0]
        suffix = "_Nb.dat"
    else:
        raise ValueError(
            f"transport_type '{transport_type}' must be 'Diffusion' or 'mobility'"
        )

    file_names = [path / f"{p}{suffix}" for p in particle_names]
    deps = read_dependences(file_names,
                            zero_if_file_missing=(transport_type == "mobility"))
    for dep in deps:
        if dep not in all_deps:
            raise ValueError(
                f"transport dependence '{dep}' not recognised for "
                f"'{transport_type}'"
            )

    kxs, kys = [], []
    for fn, dep in zip(file_names, deps):
        if transport_type == "mobility" and dep == 0:
            kxs.append(0)
            kys.append(0)
            continue
        if dep in _TRANSPORT_TWO_COL_DEPS:
            kx, ky = read_two_columns(fn)
        elif dep == "ESR":
            kx, ky = 0.0, 0.0
        elif dep in _TRANSPORT_FLOAT_DEPS:
            kx, ky = 0.0, read_single_float(fn)
        else:
            kx, ky = 0.0, read_single_string(fn)
        kxs.append(kx)
        kys.append(ky)
    return kxs, kys, deps


# -- particle properties ----------------------------------------------------

_MASS_RE = re.compile(r"Mass\s?=\s?([+-]?\d+.\d+[eE]?[-+]?\d+|0|1.0)")
_CHARGE_RE = re.compile(r"Z\s+?=\s+?([+-]?\d+)")


def read_particle_properties(file_names, model, file_input=None):
    """Masses and charge numbers from per-species `.cfg` files
    (`file_io.py:478-521`; `Nmom` entries are present in the files but
    unparsed, as in the reference)."""
    if file_input is None:
        raise ValueError("file_input (the directory holding <model>/) is "
                         "required")
    path = Path(file_input) / model / "species"
    masses, charges = [], []
    for fn in file_names:
        fn = path / fn
        if not fn.is_file():
            raise RuntimeError(f"File '{fn}' not found.")
        mass_found = charge_found = False
        for line in read_and_decomment(fn):
            m = _MASS_RE.findall(line)
            c = _CHARGE_RE.findall(line)
            if m:
                mass_found = True
                masses.append(float(m[0]))
            if c:
                charge_found = True
                charges.append(float(c[0]))
        if not mass_found:
            raise RuntimeError(f"No mass found in file '{fn}'.")
        if not charge_found:
            raise RuntimeError(f"No charge found in file '{fn}'.")
    return masses, charges
