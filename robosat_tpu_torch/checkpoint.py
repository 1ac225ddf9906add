"""Weight bridge between the JAX package's pytrees and the port's tensors.

Both packages share one checkpoint format, the `.npz` archive of
robosat_tpu.checkpoint (numpy only). The port keeps the JAX pytree's
structure and layouts (HWIO conv kernels, BN params and state as vectors),
with torch tensors for leaves, so a checkpoint written by either package
loads in the other.
"""

import numpy as np
import torch

from robosat_tpu.checkpoint import convert_torch_unet, load_checkpoint


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def from_jax(params, state, device="cpu"):
    """JAX (params, state) pytrees of numpy arrays -> the same trees of torch
    tensors on `device` (float leaves as float32)."""

    def leaf(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a, dtype=np.float32 if a.dtype.kind == "f" else a.dtype)).to(device)

    return _map(params, leaf), _map(state, leaf)


def to_jax(tree):
    """A tree of torch tensors -> the same tree of numpy arrays (the layout
    robosat_tpu.checkpoint.save_checkpoint writes)."""
    return _map(tree, lambda t: t.detach().cpu().numpy())


def load_model_checkpoint(path, num_classes=2, device="cpu"):
    """A `.npz` checkpoint, or a reference robosat `.pth` converted by the
    shared robosat_tpu.checkpoint.convert_torch_unet; returns
    (params, state, meta) with torch tensors on `device`."""
    if path.endswith((".pth", ".pt")):
        chkpt = torch.load(path, map_location="cpu", weights_only=True)
        params, state = convert_torch_unet(chkpt.get("state_dict", chkpt), num_classes)
        meta = {"epoch": int(chkpt.get("epoch", 0))}
    else:
        trees, meta = load_checkpoint(path)
        params, state = trees["params"], trees["state"]
    params, state = from_jax(params, state, device)
    return params, state, meta
