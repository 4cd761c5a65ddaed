"""The Policy protocol on tensors.

Counterpart of ``repro.policy.api``.  A ``Policy`` is a pair of functions
and an explicit params object:

    params  = policy.init(seed, device)
    actions = policy.act(params, obs, key)     # (C, D) -> (C,) int32

``params`` is an ``nn.Module`` for network policies and a dict of tensors
for scenario-borne ones (constraints, round sizes), which ``refresh``
re-derives from a scenario and ``with_users`` rebinds per tick.  ``key``
is a threefry key of ``repro_torch.random``.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn


class Policy(NamedTuple):
    """``init(seed, device) -> params`` and ``act(params, obs, key) ->
    actions`` with obs (C, D) -> actions (C,) int32.  ``kind`` names the
    adapter family a ``PolicyBundle`` records; ``refresh(params,
    scenario)`` and ``with_users(params, n_users)`` are optional."""
    kind: str
    init: Callable[..., Any]
    act: Callable[[Any, Any, Any], Any]
    refresh: Optional[Callable[[Any, Any], Any]] = None
    with_users: Optional[Callable[[Any, Any], Any]] = None


def refresh_params(policy: Policy, params, scenario):
    """Apply ``policy.refresh`` if present (identity otherwise)."""
    if policy.refresh is None:
        return params
    return policy.refresh(params, scenario)


def act_batch(policy: Policy, params, obs, key, n_users=None):
    """One ``policy.act`` over all C cells, with per-cell round sizes
    rebound first when the policy conditions on them."""
    if n_users is not None and policy.with_users is not None:
        params = policy.with_users(params, n_users)
    return policy.act(params, obs, key)


def params_to(params, device):
    """``params`` (a module, or dicts/lists/tuples of tensors) on
    ``device``."""
    if isinstance(params, (torch.Tensor, nn.Module)):
        return params.to(device)
    if isinstance(params, dict):
        return {k: params_to(v, device) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_to(v, device) for v in params)
    return params
