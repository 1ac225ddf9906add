"""Run a function as N ranks of robosat_tpu_torch's process group, one process each.

`launch(func, size, *args)` starts `size` Python processes as a user
launches the port on N devices: RS_COORDINATOR (a free local TCP port),
RS_NUM_PROCESSES and RS_PROCESS_ID set in each, one CPU thread each. Each
runs func(*args) (a module-level function of an importable module: the
functions below, which import no JAX) and pickles its result back;
`launch` returns the ranks' results in rank order and raises if a rank
failed. The group is gloo on the CPU (`mesh.create_mesh` of the CPU);
the functions that take a `device` run on "cuda" too, over gloo (one
card holds both ranks), and `nccl_one_rank` builds a one-rank NCCL group.
"""

import os
import pickle
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))


def launch(func, size, *args, timeout=600, env=None):
    """[func(*args) on rank r for r in range(size)], each in its own process."""
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "args.pkl")
        with open(inp, "wb") as f:
            pickle.dump(args, f)
        from robosat_tpu_torch.parallel.mesh import free_port

        code = ("import sys; sys.path[:0] = {!r}; import torch_mesh_workers as w; w._child({!r}, {!r}, {!r}, {!r})")
        base = dict(os.environ, OMP_NUM_THREADS="1", RS_COORDINATOR="127.0.0.1:{}".format(free_port()),
                    RS_NUM_PROCESSES=str(size), **(env or {}))
        outs = [os.path.join(tmp, "out{}.pkl".format(r)) for r in range(size)]
        procs = [subprocess.Popen([sys.executable, "-c", code.format([HERE, os.path.dirname(HERE)], func.__module__,
                                                                    func.__name__, inp, outs[r])],
                                  env=dict(base, RS_PROCESS_ID=str(r)), stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT)
                 for r in range(size)]
        logs = []
        try:
            for p in procs:
                logs.append(p.communicate(timeout=timeout)[0].decode(errors="replace"))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for r, p in enumerate(procs):
            if p.returncode != 0:
                raise RuntimeError("rank {} exited {}:\n{}".format(r, p.returncode, logs[r][-6000:]))
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f))
        return results


def _child(module, name, inp, out):
    import importlib

    import torch

    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        args = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(*args)
    with open(out, "wb") as f:
        pickle.dump(result, f)
    import torch.distributed as dist

    if dist.is_initialized():  # leave together: a rank that exits first can abort a peer's teardown
        dist.barrier()
        dist.destroy_process_group()


def cpu_mesh(device="cpu"):
    """This rank's mesh: gloo on the CPU, and on the card too (NCCL needs a
    card per rank)."""
    import torch

    from robosat_tpu_torch.parallel.mesh import create_mesh

    return create_mesh(torch.device(device), backend="gloo")


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_np_tree(v) for v in tree]
    return tree.detach().numpy().copy()


def rs_environment():
    """What the group came up with from RS_*: (rank, world size, backend,
    device, the mesh's rows of 8)."""
    import torch.distributed as dist

    mesh = cpu_mesh()
    return mesh.rank, mesh.size, dist.get_backend(), str(mesh.device), mesh.rows(8)


def halo_site_outputs(x, w):
    """Every spatial site of the U-Net's folded forward on NHWC `x` with
    the kernels of `w` (numpy): {name: output}. Called on the whole raster,
    and on each rank's rows under `height_sharded`."""
    import torch

    from robosat_tpu_torch.models import layers

    t = {k: torch.as_tensor(v) for k, v in w.items()}
    sym = ((1, 1), (1, 1))
    return {
        "conv3x3_s1": layers.conv_nhwc(x, t["w3"], padding=sym),
        "conv3x3_s1_same": layers.conv_nhwc(x, t["w3"]),
        "conv3x3_s2": layers.conv_nhwc(x, t["w3"], stride=2, padding=sym),
        "stem7x7_s2": layers.conv_nhwc(x, t["w7"], stride=2, padding=((3, 3), (3, 3))),
        "proj1x1_s2": layers.conv_nhwc(x, t["w1"], stride=2),
        "maxpool3_s2": layers.max_pool(x, window=3, stride=2, padding=1),
        "maxpool2_s2": layers.max_pool(x, window=2, stride=2, padding=0),
        "upsample_conv_k4": layers.upsample_conv_k4(layers.fused_k4(t["w3"]), x),
        "s2d_up_conv": layers.conv_nhwc(x, layers.s2d_up_conv3x3_kernel(t["w3"])),
        "s2d_conv": layers.conv_nhwc(x, layers.s2d_conv3x3_kernel(t["w3q"])),
    }


def halo_sites(x, w, device="cpu"):
    """`halo_site_outputs` on this rank's rows of x under
    `height_sharded`, on `device`: {name: this rank's output rows as
    numpy}."""
    import torch

    from robosat_tpu_torch.models.layers import height_sharded

    mesh = cpu_mesh(device)
    local = torch.from_numpy(x)[:, mesh.rows(x.shape[1])].to(mesh.device)
    w = {k: torch.from_numpy(v).to(mesh.device) for k, v in w.items()}
    with height_sharded(mesh):
        return {k: v.cpu().numpy() for k, v in halo_site_outputs(local, w).items()}


def spatial_predict(params, state, raw, overlap):
    """make_spatial_predict_step of the U-Net over this rank's share of
    `raw`: the whole uint8 output, as every rank returns it, and the K1
    launches (the plain head on the CPU: 0)."""
    from robosat_tpu_torch.checkpoint import from_jax
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops import head
    from robosat_tpu_torch.parallel.steps import make_spatial_predict_step

    mesh = cpu_mesh()
    tp, ts = from_jax(params, state)
    step = make_spatial_predict_step(unet, mesh, overlap=overlap)
    return step(tp, ts, raw).numpy(), head.margin_head.launches


def spatial_predict_port(raw, overlap, device):
    """make_spatial_predict_step of `unet.init(0)` on `device` over this
    rank's share of `raw`: (the whole uint8 output, this rank's K1
    launches in the step, K1's blocked uint8 on the rank's own features
    and its plain version's)."""
    from robosat_tpu_torch.checkpoint import from_jax, to_jax
    from robosat_tpu_torch.device import configure_device
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops import head
    from robosat_tpu_torch.parallel.steps import make_spatial_predict_step

    configure_device(device == "cuda")
    mesh = cpu_mesh(device)
    tp, ts = from_jax(*(to_jax(t) for t in unet.init(0)), mesh.device)
    step = make_spatial_predict_step(unet, mesh, overlap=overlap)
    head.margin_head.launches = 0
    out = step(tp, ts, raw).cpu().numpy()
    launches = head.margin_head.launches
    inputs = step.head_inputs(tp, ts, raw)
    return (out, launches, head.margin_head(*inputs, 0, 4).cpu().numpy(),
            head.margin_head_plain(*inputs, 0, 4).cpu().numpy())


def nccl_one_rank():
    """A one-rank group from RS_* on the card with the default backend
    (NCCL): (backend, device, a sum, a gather, a broadcast object)."""
    import torch
    import torch.distributed as dist

    from robosat_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(torch.device("cuda"))
    t = torch.arange(4.0, device=mesh.device)
    out = (dist.get_backend(), str(mesh.device), mesh.sum(t).tolist(), mesh.gather(t[None]).tolist(),
           mesh.broadcast_object({"amaxes": [1.5, 2.5]}))
    dist.destroy_process_group()
    return out


def sync_bn(params, state, x, dy):
    """Training-mode `layers.bn_apply` under `sync_batch_norm` on this
    rank's rows of x: (y rows, new state, d(sum(y * dy))/dx rows)."""
    import torch

    from robosat_tpu_torch.models.layers import bn_apply, sync_batch_norm

    mesh = cpu_mesh()
    rows = mesh.rows(x.shape[0])
    xr = torch.from_numpy(x[rows]).requires_grad_(True)
    p = {k: torch.from_numpy(v) for k, v in params.items()}
    s = {k: torch.from_numpy(v) for k, v in state.items()}
    with sync_batch_norm(mesh):
        y, new_state = bn_apply(p, s, xr, True)
    (y * torch.from_numpy(dy[rows])).sum().backward()
    return y.detach().numpy(), _np_tree(new_state), xr.grad.numpy()


def train_step(params, state, images, masks, loss_name, weight, sync_bn, augment=False, seed=0, mesh_on=True,
               optimizer="sgd", lr=1e-3, steps=1, family="unet"):
    """`steps` of make_train_step from the JAX trees (params, state) on
    this rank's rows of (images, masks) (all of them without `mesh_on`):
    ([losses], [counts], params, state) as numpy, on every rank."""
    import torch

    from robosat_tpu_torch import optim
    from robosat_tpu_torch.checkpoint import from_jax, tree_leaves
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.mesh import shard_batch
    from robosat_tpu_torch.parallel.steps import make_train_step

    mesh = cpu_mesh() if mesh_on else None
    tp, ts = from_jax(params, state)
    opt = optim.adam(tp, lr) if optimizer == "adam" else torch.optim.SGD(tree_leaves(tp), lr=lr)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    step = make_train_step(get_model(family), get_loss(loss_name), opt, weight=weight, augment=augment, mesh=mesh,
                           sync_bn=sync_bn)
    generator = torch.Generator().manual_seed(seed)
    losses, counts = [], []
    for _ in range(steps):
        ts, loss, c = step(tp, ts, shard_batch(mesh, images), shard_batch(mesh, masks), generator)
        losses.append(float(loss))
        counts.append(c.numpy().copy())
    return losses, counts, _np_tree(tp), _np_tree(ts)


def tool_main(tool, args):
    """robosat_tpu_torch.tools.<tool>.main(args) on this rank."""
    import importlib

    return importlib.import_module("robosat_tpu_torch.tools." + tool).main(args)


def _sgd_step_setup(params, state, lr):
    import torch

    from robosat_tpu_torch.checkpoint import from_jax, tree_leaves

    tp, ts = from_jax(params, state)
    for p in tree_leaves(tp):
        p.requires_grad_(True)
    return tp, ts, torch.optim.SGD(tree_leaves(tp), lr=lr)


def qat_step(family, params, state, scales, images, masks, mesh_on=True, lr=1e-3):
    """One make_qat_train_step (Lovasz, SGD) on this rank's rows:
    (loss, counts, params) as numpy."""
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.mesh import shard_batch
    from robosat_tpu_torch.parallel.steps import make_qat_train_step

    mesh = cpu_mesh() if mesh_on else None
    tp, ts, opt = _sgd_step_setup(params, state, lr)
    step = make_qat_train_step(get_model(family), get_loss("Lovasz"), opt, scales, augment=False, mesh=mesh)
    _, loss, counts = step(tp, ts, shard_batch(mesh, images), shard_batch(mesh, masks))
    return float(loss), counts.numpy(), _np_tree(tp)


def distill_step(family, params, state, teacher_folded, images, masks, weight, mesh_on=True, lr=1e-3):
    """One make_distill_train_step (CrossEntropy with `weight`, SGD, a
    teacher of the same family) on this rank's rows: (loss, counts,
    params, state) as numpy."""
    from robosat_tpu_torch.checkpoint import from_jax
    from robosat_tpu_torch.models.registry import get_model
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.mesh import shard_batch
    from robosat_tpu_torch.parallel.steps import make_distill_train_step

    mesh = cpu_mesh() if mesh_on else None
    tp, ts, opt = _sgd_step_setup(params, state, lr)
    model = get_model(family)
    step = make_distill_train_step(model, model, get_loss("CrossEntropy"), opt, weight=weight, augment=False,
                                   mesh=mesh)
    teacher = from_jax(teacher_folded, {})[0]
    new_state, loss, counts = step(tp, ts, teacher, shard_batch(mesh, images), shard_batch(mesh, masks))
    return float(loss), counts.numpy(), _np_tree(tp), _np_tree(new_state)


def eval_and_predict(params, state, images, masks, weight, raw, overlap):
    """make_eval_step and make_predict_step (the JAX package's default
    unfused float step) on this rank's rows: (loss, counts, output rows)."""
    from robosat_tpu_torch.checkpoint import from_jax
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.ops.losses import get_loss
    from robosat_tpu_torch.parallel.mesh import shard_batch
    from robosat_tpu_torch.parallel.steps import make_eval_step, make_predict_step

    mesh = cpu_mesh()
    tp, ts = from_jax(params, state)
    loss, counts = make_eval_step(unet, get_loss("CrossEntropy"), weight=weight, mesh=mesh)(
        tp, ts, shard_batch(mesh, images), shard_batch(mesh, masks))
    out = make_predict_step(unet, overlap=overlap)(tp, ts, shard_batch(mesh, raw))
    return float(loss), counts.numpy(), out.numpy()


def int8_predict(params, state, raw, calib_amaxes=None, mesh_on=True):
    """make_int8_predict_step of the U-Net (fine input, fused head,
    overlap 0) built on this rank's rows of the global batch `raw` and run
    on them: the output rows."""
    from robosat_tpu_torch.checkpoint import from_jax
    from robosat_tpu_torch.models import unet
    from robosat_tpu_torch.parallel.mesh import shard_batch
    from robosat_tpu_torch.parallel.steps import make_int8_predict_step

    mesh = cpu_mesh() if mesh_on else None
    tp, ts = from_jax(params, state)
    rows = shard_batch(mesh, raw)
    step, qtree = make_int8_predict_step(unet, tp, ts, rows, calib_amaxes=calib_amaxes, mesh=mesh)
    return step(qtree, rows).numpy()
