"""Process groups, the mesh of ranks, and the collectives the steps and layers use.

Counterpart of robosat_tpu/parallel/mesh.py on torch.distributed, with one
process per GPU (the JAX package runs one process per host, each holding
all of its local devices). Launch N processes with RS_COORDINATOR
(host:port of rank 0), RS_NUM_PROCESSES (N) and RS_PROCESS_ID (0..N-1) set
in each; without RS_COORDINATOR nothing is initialized, `create_mesh`
returns None and every step runs as on one device.

A `Mesh` is this process's view of the group: its rank, the world size,
its device, and the collectives that the steps (parallel/steps.py) and the
layers (models/layers.py) call. They use only what NCCL and gloo both run
on CUDA tensors: `all_gather` (list form), `all_reduce` and `broadcast`;
gloo stages CUDA tensors through the host, so on one card two gloo ranks
are a test of the arithmetic, not of the links.

The layers take a Mesh through models/layers.py's contexts
`sync_batch_norm` (the global batch's statistics) and `height_sharded`
(halo rows from the neighbouring ranks, `Mesh.halo`).
"""

import os
import random
import socket

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


def maybe_init_distributed(use_cuda=False, backend=None):
    """Join the process group when launched as one of several processes.

    Reads RS_COORDINATOR (host:port), RS_NUM_PROCESSES and RS_PROCESS_ID,
    as the JAX package's function does, and calls init_process_group once
    over TCP: NCCL when the config's device is CUDA (`use_cuda`), gloo on
    the CPU, or `backend` where a caller names one (two gloo ranks on one
    card). Without RS_COORDINATOR it does nothing. Returns whether a group
    is up."""
    coordinator = os.environ.get("RS_COORDINATOR")
    if coordinator and not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if use_cuda else "gloo"),
            init_method="tcp://" + coordinator,
            world_size=int(os.environ["RS_NUM_PROCESSES"]),
            rank=int(os.environ["RS_PROCESS_ID"]),
        )
    return dist.is_initialized()


def create_mesh(device, backend=None):
    """This process's Mesh, or None without a process group (one process).

    `device` is the config's (device.configure_device): on CUDA the rank
    takes `cuda:{RS_PROCESS_ID % device_count}` and makes it current, so
    the kernels' launches go to it; on the CPU it stays the CPU."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("config sets cuda = true but no CUDA device is available")
    if not maybe_init_distributed(device.type == "cuda", backend):
        return None
    rank, size = dist.get_rank(), dist.get_world_size()
    if device.type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    return Mesh(rank, size, device)


class Mesh:
    """A 1-D mesh over the group's ranks (the JAX package's data axis)."""

    def __init__(self, rank, size, device):
        self.rank, self.size, self.device = rank, size, device

    def rows(self, n):
        """This rank's slice of `n` rows split evenly over the ranks."""
        if n % self.size:
            raise ValueError("{} rows do not split over {} ranks".format(n, self.size))
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def sum(self, tensor):
        """The elementwise sum over ranks of `tensor`, a new tensor, with
        the gradient of a sum (each rank's gradient is the ranks' summed)."""
        return dist_nn.all_reduce(tensor)

    def sum_(self, tensor):
        """Sum `tensor` over ranks in place (no gradient); returns it."""
        dist.all_reduce(tensor)
        return tensor

    def mean_(self, tensors):
        """Replace each tensor by its mean over ranks, in place."""
        self._reduce_flat_(list(tensors), mean=True)

    def sum_grads_(self, params, mean=False):
        """Sum (or with `mean` average) the gradients of `params` over ranks
        in place; a parameter without a gradient takes zeros, as every rank
        holds the same parameters."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._reduce_flat_([p.grad for p in params], mean)

    def _reduce_flat_(self, tensors, mean):
        """Sum (or average) `tensors` over ranks in place, in one all-reduce
        of their float32 values concatenated."""
        if not tensors:
            return
        flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        if mean:
            flat /= self.size
        offset = 0
        for t in tensors:
            t.copy_(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()

    def gather(self, tensor, dim=0):
        """Every rank's `tensor` (equal shapes) concatenated along `dim`,
        on every rank; no gradient."""
        parts = [torch.empty_like(tensor) for _ in range(self.size)]
        dist.all_gather(parts, tensor.contiguous())
        return torch.cat(parts, dim=dim)

    def gather_rows(self, tensor):
        """`gather` along dim 0 with a gradient: every rank computes the same
        function of the gathered rows, so this rank's rows take their own
        share of its gradient and the parameters' gradients are summed over
        ranks afterwards (`sum_grads_`)."""
        return _GatherRows.apply(tensor, self)

    def broadcast_object(self, obj, src=0):
        """Rank `src`'s picklable `obj` on every rank (one broadcast)."""
        box = [obj]
        dist.broadcast_object_list(box, src)
        return box[0]

    def halo(self, x, top, bottom, fill):
        """NHWC `x`, this rank's rows of a raster split by height over the
        ranks in order, extended by `top` rows of the rank above and
        `bottom` rows of the rank below; past the raster's top and bottom
        the rows are `fill` (0 for a conv, -inf for a max pool). One
        all-gather of every rank's edge slabs."""
        h = x.shape[1]
        if top > h or bottom > h:
            raise ValueError("a halo of {}/{} rows needs more than the {} rows of one rank".format(top, bottom, h))
        k = max(top, bottom)
        if k == 0:
            return x
        edges = self.gather(torch.cat([x[:, :k], x[:, h - k:]], dim=1).unsqueeze(0))  # (P, N, 2k, W, C)
        parts = []
        if top:
            above = edges[self.rank - 1, :, 2 * k - top:] if self.rank > 0 else torch.full_like(x[:, :top], fill)
            parts.append(above)
        parts.append(x)
        if bottom:
            below = (edges[self.rank + 1, :, :bottom] if self.rank + 1 < self.size
                     else torch.full_like(x[:, :bottom], fill))
            parts.append(below)
        return torch.cat(parts, dim=1)


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, tensor, mesh):
        ctx.mesh = mesh
        return mesh.gather(tensor)

    @staticmethod
    def backward(ctx, grad):
        return grad[ctx.mesh.rows(grad.shape[0])], None


def shard_batch(mesh, array):
    """This rank's rows of a global batch (numpy array or tensor); the whole
    batch without a mesh."""
    return array if mesh is None else array[mesh.rows(array.shape[0])]


def free_port():
    """A free local TCP port for RS_COORDINATOR, below the ephemeral range:
    one the kernel hands out for outgoing connections could be taken
    before rank 0 binds it."""
    low = 32768
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        pass
    for _ in range(100):
        port = random.randrange(max(low - 12000, 1024), low)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port
    raise RuntimeError("no free port below {}".format(low))
