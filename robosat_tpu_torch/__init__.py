"""robosat-tpu on PyTorch and CUDA: the int8 `rs predict` path of the U-Net.

A port of the JAX package `robosat_tpu` (kept beside it as the reference)
to PyTorch, with hand-written CUDA kernels for Hopper (sm_90a) in `csrc/`
where the JAX package ran Pallas kernels on the TPU. Public functions keep
the JAX package's NHWC activations and HWIO conv kernels, so each module
can be held against its counterpart on the same inputs. Host-only modules
(config, colors, tiles, the data loader, the image codec and the npz
checkpoint format) are shared with `robosat_tpu`, whose import chains for
those modules are free of JAX.
"""

__version__ = "0.1.0"
