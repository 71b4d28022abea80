"""The port's package boundary: it imports neither JAX nor the JAX package,
its entry points default to the GPU, and state moves between the two
packages losslessly (checkpoint restart, `fedm_tpu_torch.convert`)."""

import ast
import inspect
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fedm_tpu  # noqa: F401
from fedm_tpu.io.checkpoint import load_checkpoint as jax_load_checkpoint
from fedm_tpu.ops.exprs import ExpressionError as JaxExpressionError
from fedm_tpu.ops.exprs import compile_expression as jax_compile
from fedm_tpu_torch import convert
from fedm_tpu_torch.fem import (BCSet, CellBatch, FacetBatch, combine_bcs,
                                interpolate)
from fedm_tpu_torch.fem.postprocess import normal_vector
from fedm_tpu_torch.fem.interpolation import p1_transfer
from fedm_tpu_torch.io import load_checkpoint
from fedm_tpu_torch.examples import extended_scheme
from fedm_tpu_torch.models.generic import PlasmaModel
from fedm_tpu_torch.models.tof import TimeOfFlight1D, TimeOfFlight2D
from fedm_tpu_torch.models.streamer import (ALPHA_EXPR, D_E_EXPR, MU_E_EXPR,
                                            StreamerModel)
from fedm_tpu_torch.ops.exprs import ExpressionError, compile_expression
from fedm_tpu_torch.solvers.multigrid import GeometricMultigrid
from fedm_tpu_torch.solvers.structured_mg import StructuredPoissonMG

ROOT = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((ROOT / "fedm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "tests" / "test_torch_gpu.py"]
CKPT = ROOT / "bench_assets" / "bagheri_dz1e-5_ckpt.npz"


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_SOURCES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "fedm_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_port_source_list_is_complete():
    assert len(PORT_SOURCES) > 25
    names = {str(p.relative_to(ROOT)) for p in PORT_SOURCES}
    assert {"fedm_tpu_torch/native/__init__.py",
            "fedm_tpu_torch/mesh/reorder.py",
            "fedm_tpu_torch/mesh/io_xml.py",
            "fedm_tpu_torch/parallel/dd.py",
            "fedm_tpu_torch/examples/extended_scheme.py",
            "fedm_tpu_torch/parallel/sweep.py",
            "fedm_tpu_torch/examples/streamer.py",
            "fedm_tpu_torch/examples/glow_discharge.py",
            "fedm_tpu_torch/dd_scale.py"} <= names


def test_native_source_is_the_ports_own_copy():
    """The port builds its own C++ source, not the JAX package's."""
    from fedm_tpu_torch import native

    assert native.SOURCE == ROOT / "fedm_tpu_torch" / "csrc" / \
        "fedm_native.cpp"
    assert "fedm_tpu/native" not in native.SOURCE.read_text()


@pytest.mark.parametrize("entry", [StreamerModel.__init__, load_checkpoint,
                                   convert.state_from_arrays,
                                   PlasmaModel.__init__,
                                   TimeOfFlight1D.__init__,
                                   TimeOfFlight2D.__init__,
                                   convert.field_from_array,
                                   convert.sweep_state_from_arrays])
def test_entry_points_default_to_cuda(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_extended_scheme_defaults_to_cuda():
    assert extended_scheme.parse_args([]).device == "cuda"


@pytest.mark.parametrize("module", ["examples.streamer",
                                    "examples.glow_discharge", "dd_scale"])
def test_this_slices_entry_points_default_to_cuda(module):
    import importlib

    mod = importlib.import_module(f"fedm_tpu_torch.{module}")
    assert mod.parse_args([]).device == "cuda"


@pytest.mark.parametrize("cls", ["PlasmaModel", "StreamerModel",
                                 "DistributedSystem"])
def test_distribute_takes_its_devices_from_the_caller(cls):
    """No default: the parts' devices reach the decomposition only from
    the caller."""
    from fedm_tpu_torch.parallel import DistributedSystem

    fn = {"PlasmaModel": PlasmaModel.distribute,
          "StreamerModel": StreamerModel.distribute,
          "DistributedSystem": DistributedSystem.__init__}[cls]
    param = inspect.signature(fn).parameters["devices"]
    assert param.default is inspect.Parameter.empty


@pytest.mark.parametrize("cls", [CellBatch, FacetBatch, BCSet,
                                 StructuredPoissonMG, GeometricMultigrid,
                                 p1_transfer, combine_bcs, interpolate,
                                 normal_vector],
                         ids=lambda c: c.__name__)
def test_building_blocks_take_the_device_from_the_caller(cls):
    """No default: the device reaches them only from an entry point."""
    fn = cls.__init__ if inspect.isclass(cls) else cls
    param = inspect.signature(fn).parameters["device"]
    assert param.kind is inspect.Parameter.KEYWORD_ONLY
    assert param.default is inspect.Parameter.empty


def test_checkpoint_restart_matches_the_jax_reader():
    ref = jax_load_checkpoint(CKPT)
    s = load_checkpoint(CKPT, device="cpu")
    for k in ("u", "u_old", "u_old1"):
        got = getattr(s, k)
        assert got.dtype == torch.float64 and got.shape == (161385, 3)
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(ref, k)))
    for k in ("t", "dt", "dt_old", "n_accepted", "n_rejected"):
        assert getattr(s, k) == getattr(ref, k)
    assert s.max_error == [float(e) for e in ref.max_error]


def test_convert_round_trip():
    rng = np.random.default_rng(0)
    arrays = dict(u=rng.standard_normal((7, 3)),
                  u_old=rng.standard_normal((7, 3)),
                  u_old1=rng.standard_normal((7, 3)), t=1.5e-9, dt=3e-12,
                  dt_old=2e-12, max_error=np.array([1e-4, 2e-4, 3e-4]),
                  n_accepted=12, n_rejected=3)
    back = convert.state_to_arrays(convert.state_from_arrays(arrays, "cpu"))
    assert back.keys() == arrays.keys()
    for k, v in arrays.items():
        np.testing.assert_array_equal(np.asarray(back[k]), v)


@pytest.mark.parametrize("degree", [1, 2])
def test_convert_a_tof_state(degree):
    """A time-of-flight state (u [n_dofs, 1] float64, P2 included) moves
    from the JAX package to the port and back unchanged."""
    from fedm_tpu.models.tof import TimeOfFlight1D as JaxTof1D

    u = JaxTof1D(n_cells=50, degree=degree).initial_state()
    assert u.shape == (50 * degree + 1, 1)
    got = convert.field_from_array(np.asarray(u), device="cpu")
    assert got.dtype == torch.float64 and got.shape == u.shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(u))
    port = TimeOfFlight1D(n_cells=50, degree=degree, device="cpu")
    np.testing.assert_allclose(port.initial_state().numpy(), np.asarray(u),
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("expr", [MU_E_EXPR, D_E_EXPR, ALPHA_EXPR,
                                  "maximum(E_m, 2e6) - minimum(1e6, E_m)",
                                  "log10(abs(-E_m)) + sqrt(E_m) * pi"])
def test_expressions_match_the_jax_compiler(expr):
    E = np.geomspace(1e3, 3e7, 101)
    ref = np.asarray(jax_compile(expr)(E_m=jnp.asarray(E)))
    got = compile_expression(expr)(E_m=torch.as_tensor(E)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-14, atol=0)


@pytest.mark.parametrize("expr", ["__import__('os')", "E_m.real",
                                  "open('f')", "E_m if 1 else 0", "'s'"])
def test_expressions_reject_what_the_jax_compiler_rejects(expr):
    with pytest.raises(JaxExpressionError):
        jax_compile(expr)
    with pytest.raises(ExpressionError):
        compile_expression(expr)
