"""Adam with optax.adam's arithmetic and state.

The JAX package trains with `optax.adam(lr)` (robosat_tpu/tools/train.py);
`Adam` is a torch.optim.Optimizer that updates the same way, step for step:

    mu = (1 - b1) * g + b1 * mu          nu = (1 - b2) * g**2 + b2 * nu
    count += 1
    p += -lr * (mu / (1 - b1**count)) / (sqrt(nu / (1 - b2**count)) + eps)

each product and sum rounded to float32 in that order, the bias corrections
computed in float32 from the integer count. Its state is optax's
`(count, mu, nu)`: one count for all parameters, and a first and second
moment per parameter, so a checkpoint's optimizer leaves move between the
packages (robosat_tpu_torch/checkpoint.py `opt_state_to_leaves`). A
parameter without a gradient takes a zero gradient, as every leaf of an
optax gradient tree does. The update runs as torch._foreach_* kernels over
all parameters at once.
"""

import torch

from robosat_tpu_torch.checkpoint import tree_leaves


def _bias_correction(decay, count):
    """1 - decay**count, in float32 (optax's `tree_bias_correction`)."""
    return float(1 - torch.tensor(decay, dtype=torch.float32) ** torch.tensor(float(count), dtype=torch.float32))


class Adam(torch.optim.Optimizer):
    def __init__(self, params, lr=1e-4, b1=0.9, b2=0.999, eps=1e-8):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.count = 0

    def moments(self, p):
        """The (mu, nu) of parameter `p`, created as zeros on first use."""
        state = self.state[p]
        if not state:
            state["mu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
            state["nu"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        return state["mu"], state["nu"]

    @torch.no_grad()
    def step(self):
        self.count += 1
        for group in self.param_groups:
            b1, b2, eps, lr = group["b1"], group["b2"], group["eps"], group["lr"]
            params = group["params"]
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
            mus, nus = zip(*(self.moments(p) for p in params))

            torch._foreach_mul_(mus, b1)
            torch._foreach_add_(mus, torch._foreach_mul(grads, 1 - b1))
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2))

            denom = torch._foreach_sqrt(torch._foreach_div(nus, _bias_correction(b2, self.count)))
            torch._foreach_add_(denom, eps)
            updates = torch._foreach_div(torch._foreach_div(mus, _bias_correction(b1, self.count)), denom)
            torch._foreach_mul_(updates, -lr)
            torch._foreach_add_(params, updates)


def adam(params, lr):
    """`Adam` over the leaves of a params tree, in the JAX package's tree
    order (the order of optax.adam's state), each set to require grad: the
    port's `optax.adam(lr)` with its `init(params)`."""
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    return Adam(leaves, lr=lr)
