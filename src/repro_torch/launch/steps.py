"""The zoo's train step on one card, the counterpart of the reference's
``repro.launch.steps.make_train_step``.

The reference jits the step with the parameters', optimizer state's and
batch's shardings over a device mesh; on one card the step is a plain
function.  The shardings, the abstract arguments and the prefill and serve
step builders come with the dry-run tools (ROADMAP queue 1, item 5.7).
"""
from __future__ import annotations

from repro_torch.models.config import ArchConfig
from repro_torch.models.transformer import forward_train
from repro_torch.train.optim import adamw, cosine_schedule, grad_step


def make_train_step(cfg: ArchConfig, *, use_remat: bool = True,
                    attn_impl: str = "blockwise", lr: float = 3e-4):
    """``train_step(params, opt_state, batch) -> (params, opt_state, {loss,
    grad_norm, lr})``: the loss of :func:`forward_train` and its gradient
    with respect to every leaf by autograd (``jax.value_and_grad`` in the
    reference; ``train.optim.grad_step``), then AdamW with the reference's
    settings: ``cosine_schedule(lr, 10_000, 500)``, weight decay 0.1 on
    leaves of two or more dimensions, gradients clipped to a global norm of
    1.  The outputs stay on the parameters' device (the loss detached); the
    inputs are not changed.  The optimizer state is ``adamw(...)``'s
    ``init_fn`` of the parameters (any learning rate: it holds only
    zeros)."""
    _, update_fn = adamw(cosine_schedule(lr, 10_000, 500), weight_decay=0.1)

    def train_step(params, opt_state, batch):
        aux = {}

        def update(grads, state, p):
            out = update_fn(grads, state, p)
            aux.update(out[2])
            return out

        params, opt_state, loss = grad_step(
            lambda p: forward_train(p, cfg, batch, use_remat=use_remat, attn_impl=attn_impl),
            params, opt_state, update)
        return params, opt_state, {"loss": loss, **aux}

    return train_step
