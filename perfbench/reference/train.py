"""The plain reference of a training step: the causal LM loss of
``reference/model.py``, its gradient by autograd, and AdamW, in f32.

The loss is the mean over every position of logsumexp(logits) minus the
label's logit (the vocabulary's padding columns held at -1e30).  It is
taken one sequence at a time: each sequence's summed loss over the
batch's positions, backward, the gradients summed in place, so that one
sequence's activations are held at once.

The optimizer is the one ``launch/steps.py::make_train_step`` builds,
with the workload's learning rate and the settings in ``ADAMW`` (a CPU
test holds them to the program's): the gradient clipped to a global L2
norm of ``clip`` (scale ``min(1, clip / (norm + 1e-12))``), then AdamW
with bias-corrected moments, decoupled weight decay on leaves of two or
more dimensions, and the learning rate ``lr · min(t / warmup, 1)`` times a cosine over
``total_steps`` after the warm-up.  Parameters are held as the
configuration states them: each update is worked out in f32 and stored in
the leaf's type."""
from __future__ import annotations

import math

import torch

from perfbench.reference import model as ref

#: AdamW's settings in ``make_train_step``, all but the learning rate
ADAMW = {"total_steps": 10_000, "warmup": 500, "b1": 0.9, "b2": 0.999, "eps": 1e-8,
         "weight_decay": 0.1, "clip": 1.0}


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += leaves(tree[k], prefix + (k,))
        return out
    return [("/".join(prefix), tree)]


def rebuild(tree, values: dict, prefix=()):
    if isinstance(tree, dict):
        return {k: rebuild(v, values, prefix + (k,)) for k, v in tree.items()}
    return values["/".join(prefix)]


def loss_and_grads(params, c, tokens, labels, prec):
    """The batch's mean loss and {leaf path: gradient}, a sequence at a time."""
    live = {k: v.detach().requires_grad_() for k, v in leaves(params)}
    tree = rebuild(params, live)
    total = labels.numel()
    loss = 0.0
    for b in range(tokens.shape[0]):
        lg = ref.all_logits(tree, c, tokens[b:b + 1], prec)[0]
        if lg.shape[-1] > c["vocab_size"]:
            pad = torch.arange(lg.shape[-1], device=lg.device) >= c["vocab_size"]
            lg = lg.masked_fill(pad, -1e30)
        nll = torch.logsumexp(lg, -1) - lg.gather(-1, labels[b][:, None].long())[:, 0]
        part = nll.sum() / total
        part.backward()
        loss += float(part.detach())
    return loss, {k: v.grad if v.grad is not None else torch.zeros_like(v)
                  for k, v in live.items()}


def lr_at(opt: dict, step: int) -> float:
    warm = min(step / opt["warmup"], 1.0) if opt["warmup"] else 1.0
    progress = min(max((step - opt["warmup"]) / max(opt["total_steps"] - opt["warmup"], 1), 0.0),
                   1.0)
    return opt["lr"] * warm * 0.5 * (1.0 + math.cos(math.pi * progress))


def adamw(flat: dict, grads: dict, state: dict, step: int, opt: dict, dtypes: dict) -> None:
    """One update of ``flat`` ({path: f32 tensor}) and of ``state`` ({"m",
    "v"}), in place."""
    norm = math.sqrt(sum(float(g.double().square().sum()) for g in grads.values()))
    scale = min(1.0, opt["clip"] / (norm + 1e-12))
    lr = lr_at(opt, step)
    b1t, b2t = 1.0 - opt["b1"] ** step, 1.0 - opt["b2"] ** step
    for k, p in flat.items():
        g = grads[k] * scale
        m = state["m"][k] = opt["b1"] * state["m"][k] + (1.0 - opt["b1"]) * g
        v = state["v"][k] = opt["b2"] * state["v"][k] + (1.0 - opt["b2"]) * g * g
        delta = (m / b1t) / (torch.sqrt(v / b2t) + opt["eps"])
        if p.dim() >= 2:
            delta = delta + opt["weight_decay"] * p
        p.sub_(lr * delta)
        p.copy_(p.to(dtypes[k]))


def run(params, c, batches, lr: float, dtypes: dict, prec) -> dict:
    """Follow the first ``len(batches)`` steps from ``params`` (a tree of f32
    tensors holding the configuration's values, left unchanged) at the
    learning rate ``lr``.  Returns the loss of each step, each leaf's
    gradient norm at the first step (before clipping) and each leaf's
    change after the last."""
    opt = {"lr": lr, **ADAMW}
    start = dict(leaves(params))
    flat = {k: v.detach().clone() for k, v in start.items()}
    state = {"m": {k: torch.zeros_like(v) for k, v in flat.items()},
             "v": {k: torch.zeros_like(v) for k, v in flat.items()}}
    losses, grad_norms = [], None
    for t, (tokens, labels) in enumerate(batches, start=1):
        loss, grads = loss_and_grads(rebuild(params, flat), c, tokens, labels, prec)
        losses.append(loss)
        if grad_norms is None:
            grad_norms = {k: float(g.norm()) for k, g in grads.items()}
        adamw(flat, grads, state, t, opt, dtypes)
        del grads
    change = {k: float((flat[k] - start[k]).norm()) for k in flat}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}
