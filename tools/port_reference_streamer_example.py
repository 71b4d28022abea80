"""Reference numbers for the streamer entry point in the PyTorch port's
smoke run: `examples/streamer.py --quick -T 2e-11` run with the JAX
package on the CPU in a temporary directory. Prints one JSON line: the
output tree (paths relative to the output directory), the rows of
`relative error.log` (error, dt_old, dt) and the last printed line.

    JAX_PLATFORMS=cpu python tools/port_reference_streamer_example.py
"""

import contextlib
import importlib.util
import io
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402


def main():
    spec = importlib.util.spec_from_file_location(
        "jax_example_streamer", ROOT / "examples" / "streamer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "out"
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(str(out), quick=True, T_final=2e-11)
        tree = sorted(str(p.relative_to(out)) for p in out.rglob("*"))
        rows = np.loadtxt(out / "relative error.log", ndmin=2).tolist()
    print(json.dumps({"tree": tree, "errors": rows,
                      "last_line": buf.getvalue().splitlines()[-1]}))


if __name__ == "__main__":
    main()
