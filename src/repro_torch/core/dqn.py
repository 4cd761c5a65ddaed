"""DQN: the Q-update with a target network and prioritized-replay weights.

Counterpart of ``repro.core.dqn`` (the HL agent's Direct-RL and Planning
phases train through it).  The online and target networks are
:class:`~repro_torch.core.networks.MLP` modules; the gradient is
``torch.autograd`` through the online one, the optimizer the port's
:func:`~repro_torch.training.optimizer.adam`, written out on its tensors.

    init, q_values, update, sync_target = make_dqn(spec, 5)
    state = init(key)                           # DQNState on key's device
    state, loss, td = update(state, (s, a, r, s2, done), weights)

``update`` and ``sync_target`` write the new values into the state's
modules and moment tensors in place (the trainer keeps one carry) and
return the state with its new counters.  ``update(..., apply=ready)``
keeps every value as it was where the 0-dim bool tensor ``ready`` is
false, on the device: the reference's ``where`` over the whole state,
with no host sync.
"""
from __future__ import annotations

import copy
from typing import NamedTuple

import torch

from repro_torch.core.networks import MLP, init_mlp_net
from repro_torch.specs.observation import spec_dim
from repro_torch.training.optimizer import (AdamState, adam, apply_updates,
                                            tree_where)


class DQNState(NamedTuple):
    params: MLP
    target_params: MLP
    opt_state: AdamState   # moments over ``list(params.parameters())``
    step: torch.Tensor     # () int32


def copy_into(dst: MLP, src: MLP, where: torch.Tensor | None = None) -> None:
    """``dst``'s weights := ``src``'s (where the 0-dim bool ``where``
    holds, when given)."""
    with torch.no_grad():
        for d, s in zip(dst.parameters(), src.parameters()):
            d.copy_(s if where is None else torch.where(where, s, d))


def apply_step(params: list, opt, grads, opt_state: AdamState,
               apply: torch.Tensor | None = None) -> AdamState:
    """One optimizer step on a module's parameter list, in place;
    returns the new optimizer state (where ``apply`` is false, the old
    parameters and state stay)."""
    updates, new_state = opt.update(grads, opt_state, params)
    new = apply_updates([p.detach() for p in params], updates)
    if apply is not None:
        new = tree_where(apply, new, [p.detach() for p in params])
        new_state = tree_where(apply, new_state, opt_state)
    with torch.no_grad():
        for p, n in zip(params, new):
            p.copy_(n)
    return AdamState(*new_state)


def make_dqn(spec, n_actions: int, *, hidden=(64, 64), lr: float = 1e-3,
             gamma: float = 0.95):
    """``spec`` is an ``ObservationSpec`` (the network's input width is
    whatever it encodes) or a plain int input width."""
    state_dim = spec_dim(spec)
    opt = adam(lr)

    def init(key: torch.Tensor) -> DQNState:
        params = init_mlp_net(key, (state_dim, *hidden, n_actions))
        target = copy.deepcopy(params).requires_grad_(False)
        return DQNState(params, target, opt.init(list(params.parameters())),
                        torch.zeros((), dtype=torch.int32,
                                    device=key.device))

    def q_values(params: MLP, s: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return params(s)

    def loss_fn(params: MLP, target_params: MLP, batch, weights):
        s, a, r, s2, done = batch
        q_sa = params(s).gather(1, a.long()[:, None])[:, 0]
        with torch.no_grad():
            # Double DQN: the online net selects, the target net evaluates
            a_star = torch.argmax(params(s2), dim=-1)
            q_next = target_params(s2).gather(1, a_star[:, None])[:, 0]
            target = r + gamma * (1.0 - done) * q_next
        td = q_sa - target
        return torch.mean(weights * torch.square(td)), td

    def update(state: DQNState, batch, weights,
               apply: torch.Tensor | None = None):
        """One Adam step on ``mean(w · td²)``; returns (state, loss,
        td), loss and td detached."""
        params = list(state.params.parameters())
        loss, td = loss_fn(state.params, state.target_params, batch,
                           weights)
        grads = torch.autograd.grad(loss, params)
        opt_state = apply_step(params, opt, grads, state.opt_state, apply)
        step = state.step + 1
        if apply is not None:
            step = torch.where(apply, step, state.step)
        return (state._replace(opt_state=opt_state, step=step),
                loss.detach(), td.detach())

    def sync_target(state: DQNState,
                    where: torch.Tensor | None = None) -> DQNState:
        """Target := online (where the 0-dim bool ``where`` holds)."""
        copy_into(state.target_params, state.params, where)
        return state

    # greedy action selection is the repro_torch.policy dqn adapter's
    return init, q_values, update, sync_target
