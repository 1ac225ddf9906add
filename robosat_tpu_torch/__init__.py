"""robosat-tpu on PyTorch and CUDA: `rs train`, `rs predict` (int8 and float)
and `rs masks` of the U-Net and the fast family, and the vector tools `rs
features`, `rs merge` and `rs dedupe`.

A port of the JAX package `robosat_tpu` (kept beside it as the reference)
to PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in `csrc/`
where the JAX package ran Pallas kernels on the TPU. Public functions keep
the JAX package's NHWC activations and HWIO conv kernels, so each module
can be held against its counterpart on the same inputs. The package
imports nothing of `robosat_tpu` and no JAX: the host modules its tools
need (config, colors, tiles, the datasets and data loader, the native
image codec, the npz checkpoint format, the log and the history chart, the
geometry stack of geo/, graph/ and spatial/ with the C++ geometry engine)
are its own copies, each naming its counterpart.
"""

__version__ = "0.1.0"
