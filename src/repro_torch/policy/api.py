"""The Policy protocol on tensors.

Counterpart of ``repro.policy.api``.  A ``Policy`` is a pair of functions
and an explicit params object:

    params  = policy.init(seed, device)
    actions = policy.act(params, obs, key)     # (C, D) -> (C,) int32

``params`` is an ``nn.Module`` for network policies and a dict of tensors
for scenario-borne ones (constraints, round sizes), which ``refresh``
re-derives from a scenario and ``with_users`` rebinds per tick.  ``key``
is a threefry key of ``repro_torch.random``.

``host_side`` marks an adapter whose ``act`` decides on the host, one
observation at a time (the tabular Q baseline); the fleet-wide harnesses
— the serving engine and the round gateway — run ``act`` on device
tensors every step and refuse such a policy up front
(:func:`require_device_side`).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
from torch import nn


class Policy(NamedTuple):
    """``init(seed, device) -> params`` and ``act(params, obs, key) ->
    actions`` with obs (C, D) -> actions (C,) int32.  ``kind`` names the
    adapter family a ``PolicyBundle`` records; ``refresh(params,
    scenario)`` and ``with_users(params, n_users)`` are optional;
    ``host_side`` says ``act`` runs on the host."""
    kind: str
    init: Callable[..., Any]
    act: Callable[[Any, Any, Any], Any]
    refresh: Optional[Callable[[Any, Any], Any]] = None
    with_users: Optional[Callable[[Any, Any], Any]] = None
    host_side: bool = False


def refresh_params(policy: Policy, params, scenario):
    """Apply ``policy.refresh`` if present (identity otherwise)."""
    if policy.refresh is None:
        return params
    return policy.refresh(params, scenario)


def require_device_side(policy: Policy, harness: str) -> None:
    """Refuse a host-side adapter before ``harness`` takes its first
    step, with a pointer instead of a failure mid-run."""
    if policy.host_side:
        raise ValueError(
            f"{harness} runs Policy.act on device tensors every step, but "
            f"the {policy.kind!r} adapter is host-side (host_side=True); "
            f"drive it one observation at a time instead")


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
