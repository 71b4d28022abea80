"""The port's example scripts: `python -m fedm_tpu_torch.examples.tof_1d`
and `python -m fedm_tpu_torch.examples.tof_2d`, the counterparts of the JAX
package's `examples/tof_1d.py` and `examples/tof_2d.py`."""
