"""Checkpoints: the npz archive format, the reference-.pth converter, and
the bridge between its numpy trees and the port's tensors.

Counterpart of robosat_tpu/checkpoint.py, limited to what `predict` uses,
in numpy: a checkpoint is one `.npz` archive in which every leaf is stored
under its flattened tree path ("params/encoder/layer1/#0/conv1/w"; list
items as "#i") beside a `__meta__` JSON blob, so archives written by either
package load in the other. The port keeps the JAX pytree's structure and
layouts (HWIO conv kernels, BN params and state as vectors) with torch
tensors for leaves.
"""

import json
import os

import numpy as np
import torch

_META_KEY = "__meta__"


def _flatten(tree, prefix, out):
    if isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], prefix + (str(k),), out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, prefix + ("#{}".format(i),), out)
    else:
        out["/".join(prefix)] = np.asarray(tree)


def _unflatten(flat):
    root = {}
    for path, value in flat.items():
        parts = path.split("/")
        node = root
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value

    def listify(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.startswith("#") for k in node):
            return [listify(node["#{}".format(i)]) for i in range(len(node))]
        return {k: listify(v) for k, v in node.items()}

    return listify(root)


def save_checkpoint(path, trees, meta=None):
    """Save named trees of numpy arrays (e.g. {"params": ..., "state": ...})
    to `path`, atomically (tmp file + rename)."""
    flat = {}
    for name, tree in trees.items():
        _flatten(tree, (name,), flat)
    flat[_META_KEY] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)

    if not path.endswith(".npz"):
        path = path + ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def load_checkpoint(path):
    """Load a checkpoint; returns (trees dict, meta dict)."""
    with np.load(path) as archive:
        flat = {k: archive[k] for k in archive.files if k != _META_KEY}
        meta = json.loads(archive[_META_KEY].tobytes().decode()) if _META_KEY in archive.files else {}
    return _unflatten(flat), meta


def _strip_module(state_dict):
    return {k[len("module.") :] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def _array(v):
    v = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
    return v.astype(np.float32)


def _hwio(v):
    """An OIHW torch conv weight as an HWIO float32 array."""
    return np.transpose(_array(v), (2, 3, 1, 0))


def convert_torch_resnet50(state_dict):
    """A torchvision resnet50 state_dict (the reference encoder,
    robosat/unet.py:94) -> the encoder's (params, state): conv weights OIHW
    -> HWIO, BN weight/bias -> scale/bias params, running_mean/var -> state.
    Accepts tensors or numpy arrays as values."""

    def conv(key):
        return {"w": _hwio(state_dict[key + ".weight"])}

    def bn(key):
        params = {"scale": _array(state_dict[key + ".weight"]), "bias": _array(state_dict[key + ".bias"])}
        state = {"mean": _array(state_dict[key + ".running_mean"]), "var": _array(state_dict[key + ".running_var"])}
        return params, state

    params, state = {}, {}
    params["conv1"] = conv("conv1")
    params["bn1"], state["bn1"] = bn("bn1")
    for si, blocks in enumerate((3, 4, 6, 3)):
        stage_p, stage_s = [], []
        for bi in range(blocks):
            base = "layer{}.{}".format(si + 1, bi)
            bp, bs = {}, {}
            for ci in (1, 2, 3):
                bp["conv{}".format(ci)] = conv("{}.conv{}".format(base, ci))
                bp["bn{}".format(ci)], bs["bn{}".format(ci)] = bn("{}.bn{}".format(base, ci))
            if "{}.downsample.0.weight".format(base) in state_dict:
                bp["down_conv"] = conv("{}.downsample.0".format(base))
                bp["down_bn"], bs["down_bn"] = bn("{}.downsample.1".format(base))
            stage_p.append(bp)
            stage_s.append(bs)
        params["layer{}".format(si + 1)] = stage_p
        state["layer{}".format(si + 1)] = stage_s
    return params, state


def convert_torch_unet(state_dict, num_classes=2):
    """A reference robosat UNet state_dict -> the U-Net's (params, state).

    Reference checkpoints carry DataParallel "module." key prefixes
    (robosat/tools/train.py:156-160) and the layout of robosat/unet.py:
    resnet.* encoder, center/dec0..dec4 DecoderBlocks (x.block.block = conv),
    dec5 ConvRelu (x.block = conv), final 1x1 conv with bias.
    """
    sd = _strip_module(state_dict)
    enc_params, enc_state = convert_torch_resnet50({k[len("resnet.") :]: v for k, v in sd.items()
                                                    if k.startswith("resnet.")})
    params = {"encoder": enc_params, "center": {"w": _hwio(sd["center.block.block.weight"])}}
    for i in range(5):
        params["dec{}".format(i)] = {"w": _hwio(sd["dec{}.block.block.weight".format(i)])}
    params["dec5"] = {"w": _hwio(sd["dec5.block.weight"])}
    params["final"] = {"w": _hwio(sd["final.weight"]), "b": _array(sd["final.bias"])}
    return params, {"encoder": enc_state}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def from_jax(params, state, device="cpu"):
    """(params, state) trees of numpy arrays -> the same trees of torch
    tensors on `device` (float leaves as float32)."""

    def leaf(a):
        a = np.asarray(a)
        return torch.from_numpy(np.array(a, dtype=np.float32 if a.dtype.kind == "f" else a.dtype)).to(device)

    return _map(params, leaf), _map(state, leaf)


def to_jax(tree):
    """A tree of torch tensors -> the same tree of numpy arrays (the layout
    `save_checkpoint` writes)."""
    return _map(tree, lambda t: t.detach().cpu().numpy())


def load_model_checkpoint(path, num_classes=2, device="cpu"):
    """A `.npz` checkpoint, or a reference robosat `.pth` converted by
    `convert_torch_unet`; returns (params, state, meta) with torch tensors
    on `device`."""
    if path.endswith((".pth", ".pt")):
        chkpt = torch.load(path, map_location="cpu", weights_only=True)
        params, state = convert_torch_unet(chkpt.get("state_dict", chkpt), num_classes)
        meta = {"epoch": int(chkpt.get("epoch", 0))}
    else:
        trees, meta = load_checkpoint(path)
        params, state = trees["params"], trees["state"]
    params, state = from_jax(params, state, device)
    return params, state, meta
