"""Reference numbers for the PyTorch port's `13 post-processing` smoke
phase.

Builds the seeded run directories of `tools/series_checkpoints.py` at the
phase's sizes (the bagheri14 window's streamer trail, 30,305 dofs on two
corridors; a glow50 run, 64 x 64, 8,321 dofs) and runs the JAX package's
`tools/export_series.py` (`export_streamer`, `export_glow`) and
`tools/glow_report.py` (`profiles`, `analyze`) on them through their
functions, on the CPU. The glow tools read the reference's `4_particles`
tree, which is not in the repository: their `GlowConfig` is pointed at
the synthetic argon tree (the mesh and the state layout, all they read,
do not depend on it). Prints one JSON line:

  streamer   per VTU of the series, per field, [2-norm, max |value|]; the
             lines the export printed; the lines of `fields.pvd`;
  glow       the same per VTU of each field's series;
  report     the glow report's summary;
  control    the same numbers from the seeded states rounded to float32
             (the phase's tolerances must refuse them).

With --port it then runs the port's entry points on the CPU
(`python -m fedm_tpu_torch.export_series ... --device cpu`,
`.glow_report`) on the same directories and prints a second line: the
largest relative gap of each group and whether every file is equal byte
for byte.

    JAX_PLATFORMS=cpu python tools/port_reference_series.py [--port]
"""

import argparse
import importlib.util
import io
import json
import os
import subprocess
import sys
import tempfile
from contextlib import redirect_stdout
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tools"))

import numpy as np  # noqa: E402

import fedm_tpu  # noqa: E402,F401
import fedm_tpu.models.glow as jglow  # noqa: E402
import series_checkpoints as seeded  # noqa: E402
from fedm_tpu.io.vtu import read_vtu  # noqa: E402
from fedm_tpu.models.argon_synth import generate_argon_input  # noqa: E402

STREAMER_FIELDS = ("electrons", "ions", "potential", "E_magnitude")
GLOW_FIELDS = ("energy_density", "Ar_star_density", "Ar_plus_density",
               "electrons", "potential", "mean_energy")


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_runs(base: Path, float32: bool = False) -> dict:
    """The phase's seeded run directories under `base`; with `float32`
    every state rounded to float32 (the control)."""
    runs = {"streamer": base / "streamer", "glow": base / "glow"}
    seeded.streamer_trail(runs["streamer"], **seeded.STREAMER_WINDOW)
    seeded.glow_run(runs["glow"], seeded.GLOW50["n_dofs"])
    if float32:
        for p in base.rglob("*.npz"):
            with np.load(p) as z:
                d = {k: z[k] for k in z.files}
            for k in ("u", "u_old", "u_old1"):
                d[k] = d[k].astype(np.float32).astype(np.float64)
            with open(p, "wb") as f:
                np.savez(f, **d)
    return runs


def field_norms(out: Path, fields) -> dict:
    """{relative VTU path: {field: [2-norm, max |value|]}}."""
    res = {}
    for p in sorted(out.rglob("*.vtu")):
        vals = {}
        for name in fields:
            try:
                v = read_vtu(p, name)
            except KeyError:
                continue
            vals[name] = [float(np.linalg.norm(v)), float(np.abs(v).max())]
        res[str(p.relative_to(out))] = vals
    return res


def jax_numbers(base: Path, float32: bool = False) -> dict:
    runs = build_runs(base / "runs", float32)
    export, report = _tool("export_series"), _tool("glow_report")
    out = {}
    buf = io.StringIO()
    (base / "streamer").mkdir()
    with redirect_stdout(buf):
        export.export_streamer(runs["streamer"], base / "streamer")
    out["streamer"] = {"files": field_norms(base / "streamer",
                                            STREAMER_FIELDS),
                       "lines": buf.getvalue().splitlines(),
                       "pvd": (base / "streamer" / "fields.pvd").read_text()
                       .splitlines()}
    real = jglow.GlowConfig
    tree = base / "file_input"
    generate_argon_input(tree, model="argon_synth")
    jglow.GlowConfig = lambda **kw: real(**dict(
        kw, model="argon_synth", file_input=tree))
    try:
        with redirect_stdout(io.StringIO()):
            export.export_glow(runs["glow"], base / "glow")
        out["glow"] = {"files": field_norms(base / "glow", GLOW_FIELDS)}
        out["report"] = report.analyze(report.profiles(runs["glow"], 64, 64))
    finally:
        jglow.GlowConfig = real
    return out


def _gap(a, b) -> float:
    """The largest relative gap over the numbers of two nested records."""
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            return float("inf")
        return max([_gap(a[k], b[k]) for k in a] or [0.0])
    if isinstance(a, (list, tuple)):
        if len(a) != len(b):
            return float("inf")
        return max([_gap(x, y) for x, y in zip(a, b)] or [0.0])
    if isinstance(a, (bool, str)) or a is None:
        return 0.0 if a == b else float("inf")
    return abs(a - b) / max(abs(b), 1e-300)


def port_numbers(base: Path, ref: dict) -> dict:
    """The port's entry points on the CPU on the same directories."""
    from fedm_tpu_torch.glow_report import analyze, profiles

    runs = build_runs(base / "runs")
    env = dict(os.environ, PYTHONPATH=str(ROOT))

    def run(*argv):
        return subprocess.run([sys.executable, "-m", *argv, "--device",
                               "cpu"], capture_output=True, text=True,
                              env=env, check=True).stdout

    lines = run("fedm_tpu_torch.export_series", "--run",
                str(runs["streamer"]), "--model", "streamer", "--out",
                str(base / "streamer")).splitlines()
    run("fedm_tpu_torch.export_series", "--run", str(runs["glow"]),
        "--model", "glow", "--out", str(base / "glow"))
    got = {"streamer": {"files": field_norms(base / "streamer",
                                             STREAMER_FIELDS),
                        "lines": lines[:-1],
                        "pvd": (base / "streamer" / "fields.pvd")
                        .read_text().splitlines()},
           "glow": {"files": field_norms(base / "glow", GLOW_FIELDS)},
           "report": analyze(profiles(runs["glow"], 64, 64,
                                      device="cpu"))}
    return {k: _gap(got[k], ref[k]) for k in ("streamer", "glow", "report")}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--port", action="store_true")
    args = ap.parse_args()
    with tempfile.TemporaryDirectory() as tmp:
        ref = jax_numbers(Path(tmp) / "ref")
        ref["control"] = jax_numbers(Path(tmp) / "control", float32=True)
        print(json.dumps(ref), flush=True)
        if args.port:
            gaps = port_numbers(Path(tmp) / "port", ref)
            jax_files = {
                p.relative_to(Path(tmp) / "ref"): p.read_bytes()
                for d in ("streamer", "glow")
                for p in (Path(tmp) / "ref" / d).rglob("*") if p.is_file()}
            gaps["bytes_equal"] = all(
                (Path(tmp) / "port" / k).read_bytes() == v
                for k, v in jax_files.items())
            gaps["control"] = {k: _gap(ref["control"][k], ref[k])
                               for k in ("streamer", "glow", "report")}
            print(json.dumps(gaps), flush=True)


if __name__ == "__main__":
    main()
