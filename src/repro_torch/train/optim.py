"""The optimizer stack of the reference's ``repro.train.optim``, in torch:
AdamW with decoupled weight decay, global-norm gradient clipping and a
warmup + cosine learning-rate schedule, over the port's parameter trees
(nested dicts and lists of tensors, ``params.tree_map``).

Every quantity is a float32 tensor, as the reference computes it: the
schedule, the bias corrections and the step count live on the parameters'
device, so a step needs no copy to the host.  ``torch.optim.AdamW`` is not
the same function (no clipping, decay on every leaf), so it is not used.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from repro_torch.params import tree_leaves, tree_map, tree_unflatten


class OptState(NamedTuple):
    step: torch.Tensor  # int32 scalar
    mu: object  # first moment tree
    nu: object  # second moment tree


def cosine_schedule(
    base_lr: float,
    total_steps: int,
    warmup_steps: int = 0,
    final_frac: float = 0.0,
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warmup to ``base_lr`` then cosine decay to ``final_frac*base_lr``;
    the schedule maps a step (a tensor or a number) to a float32 tensor."""

    def schedule(step):
        step = torch.as_tensor(step).to(torch.float32)
        if warmup_steps > 0:
            warm = torch.clamp(step / max(warmup_steps, 1), max=1.0)
        else:
            warm = torch.ones_like(step)
        progress = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                               0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * progress))
        decay = final_frac + (1.0 - final_frac) * cos
        return base_lr * warm * decay

    return schedule


def _global_norm(leaves) -> torch.Tensor:
    """The L2 norm over every element of ``leaves``, in f32: the norm of the
    leaves' norms (one multi-tensor launch for all leaves on the card)."""
    norms = torch._foreach_norm([g.to(torch.float32) for g in leaves])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm(grads, max_norm: float):
    """Clip a gradient tree to a maximum global L2 norm; returns (grads, norm)."""
    leaves = tree_leaves(grads)
    gnorm = _global_norm(leaves)
    scale = torch.clamp(max_norm / (gnorm + 1e-12), max=1.0)
    scaled = torch._foreach_mul(leaves, scale)
    return tree_unflatten(grads, [s.to(g.dtype) for s, g in zip(scaled, leaves)]), gnorm


def adamw(
    learning_rate: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: float | None = 1.0,
):
    """Returns (init_fn, update_fn) in the optax convention.

    ``update_fn(grads, state, params) -> (new_params, new_state, aux)``.
    Weight decay is decoupled (applied to params directly, not to moments)
    and skipped for leaves of fewer than 2 dimensions (biases, GAT's
    attention vectors); clipping to ``clip_norm`` is on by default, as in
    the reference.  The new parameters are new tensors; the inputs are not
    changed.
    """
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init_fn(params) -> OptState:
        leaves = tree_leaves(params)
        device = leaves[0].device if leaves else None
        zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
                         params)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device), mu=zeros,
                        nu=tree_map(torch.clone, zeros))

    @torch.no_grad()
    def update_fn(grads, state: OptState, params):
        if clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, clip_norm)
        else:
            gnorm = _global_norm(tree_leaves(grads))
        step = state.step + 1
        lr = lr_fn(step)
        step_f = step.to(torch.float32)
        b1t = 1.0 - torch.pow(b1, step_f)     # float32 powers, on the step's device
        b2t = 1.0 - torch.pow(b2, step_f)

        # the trees are matched by key path, as by the reference's flatten_up_to;
        # each line below is one multi-tensor op over all leaves (a few
        # launches on the card, not one per leaf)
        ps = tree_leaves(params)
        gs, ms, vs = (tree_leaves(tree_map(lambda _, t: t, params, tree))
                      for tree in (grads, state.mu, state.nu))
        p32 = [p.to(torch.float32) for p in ps]
        g32 = [g.to(torch.float32) for g in gs]
        ms = torch._foreach_add(torch._foreach_mul(ms, b1), torch._foreach_mul(g32, 1.0 - b1))
        vs = torch._foreach_add(torch._foreach_mul(vs, b2),
                                torch._foreach_mul(torch._foreach_mul(g32, g32), 1.0 - b2))
        delta = list(torch._foreach_div(torch._foreach_div(ms, b1t),
                                        torch._foreach_add(torch._foreach_sqrt(
                                            torch._foreach_div(vs, b2t)), eps)))
        decayed = [i for i, p in enumerate(ps) if weight_decay and p.dim() >= 2]
        if decayed:
            with_decay = torch._foreach_add([delta[i] for i in decayed],
                                            torch._foreach_mul([p32[i] for i in decayed],
                                                               weight_decay))
            for i, d in zip(decayed, with_decay):
                delta[i] = d
        new_p = torch._foreach_sub(p32, torch._foreach_mul(delta, lr))
        new_p = tree_unflatten(params, [q.to(p.dtype) for q, p in zip(new_p, ps)])
        new_m, new_v = tree_unflatten(params, ms), tree_unflatten(params, vs)
        aux = {"grad_norm": gnorm, "lr": lr}
        return new_p, OptState(step=step, mu=new_m, nu=new_v), aux

    return init_fn, update_fn


def grad_step(loss_fn, params, state: OptState, update_fn):
    """One optimizer step: the loss and its gradients with respect to every
    leaf of ``params`` by autograd (``jax.value_and_grad`` in the
    reference), then ``update_fn``.  A leaf the loss does not reach gets a
    zero gradient.  Returns (new_params, new_state, loss) with the loss
    detached, on the device (no copy to the host)."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = loss_fn(tree_unflatten(params, leaves))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    new_params, state, _ = update_fn(tree_unflatten(params, grads), state, params)
    return new_params, state, loss.detach()
