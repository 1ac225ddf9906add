"""robosat-tpu on PyTorch and CUDA: `rs predict` of the U-Net, int8 and float.

A port of the JAX package `robosat_tpu` (kept beside it as the reference)
to PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in `csrc/`
where the JAX package ran Pallas kernels on the TPU. Public functions keep
the JAX package's NHWC activations and HWIO conv kernels, so each module
can be held against its counterpart on the same inputs. The package
imports nothing of `robosat_tpu` and no JAX: the host modules `predict`
needs (config, colors, tiles, the data loader, the native image codec and
the npz checkpoint format) are its own copies, each naming its counterpart.
"""

__version__ = "0.1.0"
