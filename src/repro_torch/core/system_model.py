"""Learned system model  System(s, a; θs) → (r̂, ŝ′)  (§III phase 2).

Counterpart of ``repro.core.system_model``: a two-headed MLP on (state ⊕
one-hot action) predicting the round's reward and the next state's
features, trained on uniform minibatches from D_world (Algorithm 1
lines 17-19) and used by Planning to simulate next states and rank
candidate actions (lines 23-26).  ``predict_all_actions`` scores every
action of a batch of states in one (B·A, D + A) product, where the
reference maps a per-state function over the batch.  ``update`` writes
into the model's parameters and moments in place, like
``repro_torch.core.dqn``'s.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.dqn import apply_step
from repro_torch.core.networks import MLP, init_mlp_net
from repro_torch.specs.observation import spec_dim
from repro_torch.training.optimizer import AdamState, adam


class SystemModelState(NamedTuple):
    params: MLP
    opt_state: AdamState
    step: torch.Tensor   # () int32


def make_system_model(spec, n_actions: int, *, hidden=(96, 96),
                      lr: float = 1e-3):
    """``spec``: an ``ObservationSpec`` (input and prediction widths
    derived from it) or a plain int state width."""
    state_dim = spec_dim(spec)
    opt = adam(lr)
    out_dim = 1 + state_dim  # [r̂, ŝ′]

    def init(key: torch.Tensor) -> SystemModelState:
        params = init_mlp_net(key, (state_dim + n_actions, *hidden, out_dim))
        return SystemModelState(params, opt.init(list(params.parameters())),
                                torch.zeros((), dtype=torch.int32,
                                            device=key.device))

    def _concat(s, a):
        slots = torch.arange(n_actions, device=s.device)
        one_hot = (a.long()[..., None] == slots).to(s.dtype)
        return torch.cat([s, one_hot], dim=-1)

    def _predict(params: MLP, s, a):
        out = params(_concat(s, a))
        return out[:, 0], out[:, 1:]

    def predict(params: MLP, s, a):
        """s: (B, D) float; a: (B,) int → (r̂ (B,), ŝ′ (B, D))."""
        with torch.no_grad():
            return _predict(params, s, a)

    def predict_all_actions(params: MLP, s):
        """s: (B, D) → r̂ (B, A) and ŝ′ (B, A, D) for every action."""
        b, d = s.shape
        sb = s[:, None, :].expand(b, n_actions, d).reshape(-1, d)
        ab = torch.arange(n_actions, device=s.device).repeat(b)
        r_hat, s2_hat = predict(params, sb, ab)
        return r_hat.reshape(b, n_actions), s2_hat.reshape(b, n_actions, d)

    def update(state: SystemModelState, batch,
               apply: torch.Tensor | None = None):
        """One Adam step on the two heads' summed mean squared errors;
        returns (state, loss) (where the 0-dim bool ``apply`` is false
        the state stays as it was)."""
        s, a, r, s2, done = batch
        params = list(state.params.parameters())
        r_hat, s2_hat = _predict(state.params, s, a)
        loss = (torch.mean(torch.square(r_hat - r))
                + torch.mean(torch.square(s2_hat - s2)))
        grads = torch.autograd.grad(loss, params)
        opt_state = apply_step(params, opt, grads, state.opt_state, apply)
        step = state.step + 1
        if apply is not None:
            step = torch.where(apply, step, state.step)
        return state._replace(opt_state=opt_state, step=step), loss.detach()

    return init, predict, predict_all_actions, update
