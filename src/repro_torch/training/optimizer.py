"""SGD, Adam and AdamW on tensors, with the reference's arithmetic.

Counterpart of ``repro.training.optimizer`` (functional, optax-shaped):

    opt = adam(lr=1e-3)
    state = opt.init(params)                 # params: a tree of tensors
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

A tree is a tensor or a list, tuple (a NamedTuple too) or dict of
trees.  The update is the
reference's formula in its order of operations on float32 tensors —
moments first, bias corrections ``1 - b**step`` with ``step`` raised as a
float32 power, then ``-lr · m̂ / (sqrt(v̂) + eps)`` — and not
``torch.optim.Adam``, which rounds the same formula in another order: the
trainer takes hundreds of updates, and each last-bit gap in an early,
sign-like Adam step grows.  ``lr`` is a number or a callable of the
incremented step counter (``repro_torch.training.schedule``), which
stays on the device: no host sync reads it.  The ZeRO layout of
``apply_updates`` (``update_specs``) waits for the multi-card slice.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch


class Optimizer(NamedTuple):
    init: Callable[[Any], Any]
    update: Callable[..., tuple[Any, Any]]


class AdamState(NamedTuple):
    step: torch.Tensor   # () int32
    mu: Any
    nu: Any


class SgdState(NamedTuple):
    step: torch.Tensor   # () int32
    momentum: Any        # None without momentum


def tree_map(fn, tree, *rest):
    """``fn`` over the tensors of ``tree`` (and of ``rest``, which share
    its structure), keeping the structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        leaves = [tree_map(fn, *xs) for xs in zip(tree, *rest)]
        # a NamedTuple takes its fields as positional arguments
        return (type(tree)(*leaves) if hasattr(tree, "_fields")
                else type(tree)(leaves))
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def tree_where(pred: torch.Tensor, new, old):
    """Select ``new`` where the 0-dim bool ``pred`` holds, else ``old``,
    leaf by leaf, on the device: no host sync."""
    return tree_map(lambda n, o: torch.where(pred, n, o), new, old)


def _zeros_fp32_like(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _zero_step(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def adam(lr: float | Callable[[torch.Tensor], torch.Tensor] = 1e-3,
         b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
         weight_decay: float = 0.0) -> Optimizer:
    """Adam / AdamW (decoupled weight decay when ``weight_decay`` > 0);
    ``lr`` a number or a callable of the step (after its increment)."""

    def init(params) -> AdamState:
        return AdamState(_zero_step(params), _zeros_fp32_like(params),
                         _zeros_fp32_like(params))

    def update(grads, state: AdamState, params=None):
        step = state.step + 1
        lr_t = lr(step) if callable(lr) else lr
        mu = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(),
                      state.mu, grads)
        nu = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
            g.float()), state.nu, grads)
        # the reference's b ** step: a float32 power of a float32 step
        t = step.float()
        c1 = 1 - torch.pow(b1, t)
        c2 = 1 - torch.pow(b2, t)
        mu_hat = tree_map(lambda m: m / c1, mu)
        nu_hat = tree_map(lambda v: v / c2, nu)
        updates = tree_map(lambda m, v: -lr_t * m / (torch.sqrt(v) + eps),
                           mu_hat, nu_hat)
        if weight_decay and params is not None:
            updates = tree_map(
                lambda u, p: u - lr_t * weight_decay * p.float(),
                updates, params)
        return updates, AdamState(step, mu, nu)

    return Optimizer(init, update)


def adamw(lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1) -> Optimizer:
    return adam(lr, b1, b2, eps, weight_decay)


def sgd(lr: float = 1e-2, momentum: float = 0.0) -> Optimizer:
    """Plain SGD, or heavy-ball momentum (the reference's ``sgd``)."""

    def init(params) -> SgdState:
        return SgdState(_zero_step(params),
                        _zeros_fp32_like(params) if momentum else None)

    def update(grads, state: SgdState, params=None):
        step = state.step + 1
        if momentum:
            mom = tree_map(lambda m, g: momentum * m + g.float(),
                           state.momentum, grads)
            return tree_map(lambda m: -lr * m, mom), SgdState(step, mom)
        return (tree_map(lambda g: -lr * g.float(), grads),
                SgdState(step, None))

    return Optimizer(init, update)


def apply_updates(params, updates):
    """``params + updates``, the sum in float32, cast back to each
    parameter's dtype."""
    return tree_map(lambda p, u: (p.float() + u).to(p.dtype), params,
                    updates)


def global_norm(tree) -> torch.Tensor:
    leaves = tree_leaves(tree)
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves))


def clip_by_global_norm(grads, max_norm: float):
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale, grads), norm
