"""Loss and train-step factory of the LM (``repro.training.train_step``'s
counterpart).

``make_train_step(cfg, opt)`` returns ``train_step(state, batch) ->
(state, metrics)``: the loss and its gradients by autograd (on CUDA
tensors through the hand-written flash forward and backward kernels),
the gradients clipped by their global norm, one optimizer update.  The
parameters are the :class:`~repro_torch.models.transformer.LM` of the
state and are updated **in place**, leaf by leaf, each leaf's optimizer
state replaced as it goes: at full width the reference's functional
update would hold several extra copies of every parameter at once.
Metrics are 0-d float32 tensors on the parameters' device; nothing in a
step syncs with the host.

The optimizer's state is a tree over ``param_tree(lm)``, the model's
``{name: parameter}`` dict (``named_parameters``); the optimizers of
``repro_torch.training.optimizer`` take any tree, one leaf included.
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.training import optimizer as opt_lib

MESH_LATER = ("sharded gradients (grad_specs) belong to the multi-card "
              "slice: not ported yet (ROADMAP.md queue 1 item 10.5)")


class TrainState(NamedTuple):
    params: tf.LM        # updated in place by each step
    opt_state: Any       # the optimizer's state over param_tree(params)
    step: torch.Tensor   # () int32


def param_tree(params: tf.LM) -> dict:
    """``{name: parameter}`` in ``named_parameters`` order."""
    return dict(params.named_parameters())


def init_train_state(cfg: ModelConfig, opt: opt_lib.Optimizer, *,
                     seed: int = 0, device="cuda",
                     params: tf.LM | None = None) -> TrainState:
    """Fresh weights (``tf.init_params``), or ``params``, with gradients
    on, and the optimizer's initial state."""
    lm = params if params is not None else tf.init_params(cfg, seed, device)
    lm.requires_grad_(True)
    dev = next(lm.parameters()).device
    return TrainState(lm, opt.init(param_tree(lm)),
                      torch.zeros((), dtype=torch.int32, device=dev))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Mean token cross-entropy in float32.  logits (..., V); labels (...)
    integer.  The gold logit is gathered: the reference's one-hot masked
    sum adds exact zeros to it, so the two agree bit for bit."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def lm_loss(params: tf.LM, cfg: ModelConfig, batch: dict, *,
            remat: bool = True):
    """(ce + aux, (ce, aux)) of a next-token batch (labels pre-shifted by
    the data pipeline); with patch positions the patch region of the
    logits and labels is left out, as in the reference."""
    logits, aux = tf.forward(params, cfg, batch["tokens"],
                             positions=batch.get("positions"),
                             patch_embeds=batch.get("patch_embeds"),
                             remat=remat)
    labels = batch["labels"]
    if cfg.num_patch_positions:
        p = cfg.num_patch_positions
        ce = cross_entropy(logits[:, p:], labels[:, p:])
    else:
        ce = cross_entropy(logits, labels)
    return ce + aux, (ce, aux)


def split_microbatches(batch: dict, n: int) -> list[dict]:
    """The batch cut into ``n`` microbatches along its batch axis (axis 1
    of ``positions``, whose layout is (3, B, S))."""
    parts = [{} for _ in range(n)]
    for name, t in batch.items():
        axis = 1 if name == "positions" else 0
        if t.shape[axis] % n:
            raise ValueError(f"batch of {t.shape[axis]} does not split into "
                             f"{n} microbatches")
        for part, piece in zip(parts, torch.chunk(t, n, dim=axis)):
            part[name] = piece
    return parts


def _leaf_state(state, name: str):
    """One parameter's slice of an optimizer state: its entry of every
    dict field, the other fields (the step counter) as they are."""
    return type(state)(*(f[name] if isinstance(f, dict) else f
                         for f in state))


def make_train_step(cfg: ModelConfig, opt: opt_lib.Optimizer, *,
                    clip_norm: float = 1.0, remat: bool = True,
                    grad_specs=None, grad_accum: int = 1):
    """``train_step(state, batch) -> (state, metrics)``; metrics are
    ``loss``, ``ce``, ``aux`` (means over microbatches) and
    ``grad_norm`` (before clipping).

    ``remat``: per-layer recomputation (``tf.forward``).  ``grad_accum``:
    the batch in that many microbatches, their float32 gradients summed
    and divided by the count, as the reference's scan.  ``grad_specs``
    (the reference's sharding of gradients) belongs to the multi-card
    slice and raises."""
    if grad_specs is not None:
        raise NotImplementedError(MESH_LATER)
    if grad_accum < 1:
        raise ValueError(f"grad_accum must be >= 1, got {grad_accum}")

    def grads_of(leaves, params, batch):
        loss, (ce, aux) = lm_loss(params, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
        metrics = {"loss": loss.detach(), "ce": ce.detach(),
                   "aux": torch.as_tensor(aux).detach().float()}
        return grads, metrics

    def train_step(state: TrainState, batch: dict):
        tree = param_tree(state.params)
        names, leaves = list(tree), list(tree.values())
        if grad_accum > 1:
            grads = [torch.zeros(p.shape, dtype=torch.float32,
                                 device=p.device) for p in leaves]
            msum = None
            for mb in split_microbatches(batch, grad_accum):
                g, m = grads_of(leaves, state.params, mb)
                grads = [a + b.float() for a, b in zip(grads, g)]
                msum = m if msum is None else {
                    k: msum[k] + m[k] for k in msum}
                del g
            grads = [g / grad_accum for g in grads]
            metrics = {k: v / grad_accum for k, v in msum.items()}
        else:
            grads, metrics = grads_of(leaves, state.params, batch)
        grads = list(grads)
        norm = opt_lib.global_norm(grads)
        scale = torch.clamp(clip_norm / torch.clamp(norm, min=1e-9), max=1.0)
        fields = {i: dict(f) for i, f in enumerate(state.opt_state)
                  if isinstance(f, dict)}
        new_state = list(state.opt_state)
        with torch.no_grad():
            for i, (name, p) in enumerate(zip(names, leaves)):
                g, grads[i] = grads[i] * scale, None
                upd, leaf = opt.update(g, _leaf_state(state.opt_state, name),
                                       p)
                p.copy_(opt_lib.apply_updates(p, upd))
                for j, f in enumerate(leaf):
                    if j in fields:
                        fields[j][name] = f
                    else:
                        new_state[j] = f
        for j, f in fields.items():
            new_state[j] = f
        metrics["grad_norm"] = norm
        return (TrainState(state.params, type(state.opt_state)(*new_state),
                           state.step + 1), metrics)

    return train_step
