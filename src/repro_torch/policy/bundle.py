"""Versioned PolicyBundle checkpoints, byte-compatible with the reference.

Counterpart of ``repro.policy.bundle`` for the ``dqn``, ``greedy``,
``oracle``, ``qtable`` and ``cost_greedy`` kinds: a bundle is the policy's params plus
what they are (adapter kind, observation spec, ``n_max``, schema
version, metadata), written in the reference's checkpoint format, so a
bundle written by either package loads in the other.  An ``oracle``
bundle holds one fleet's action table (``{"table", "n_users"}``); a
``qtable`` bundle holds the table dict, its bytes keys as they are; a
``cost_greedy`` bundle names its economy profile (and any of
``lam_cost``, ``lam_energy``, ``tick_ms``) in its metadata.  Load is
defensive: a non-bundle file, a newer schema, an unknown spec or kind,
params whose width contradicts the declared spec, or a ``cost_greedy``
bundle without an economy spec or profile raise.

    save_bundle("hl.bundle.msgpack", PolicyBundle("dqn", "full", 5, mlp))
    policy, params = policy_from_bundle(load_bundle(path), device="cuda")
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import restore, save
from repro_torch.core.networks import MLP
from repro_torch.device import resolve_device
from repro_torch.policy import adapters
from repro_torch.policy.api import Policy, params_to
from repro_torch.specs.observation import SPEC_NAMES, make_spec

BUNDLE_FORMAT = "repro.policy.bundle"
BUNDLE_VERSION = 1
KINDS = ("dqn", "greedy", "oracle", "qtable", "cost_greedy")


class BundleError(ValueError):
    """Malformed or unsupported bundle."""


class SpecMismatchError(BundleError):
    """Declared spec / n_max contradicts the params or the caller."""


@dataclasses.dataclass(frozen=True)
class PolicyBundle:
    kind: str           # adapter family: one of KINDS
    obs_spec: str       # ObservationSpec variant name
    n_max: int          # spec width parameter the policy was trained at
    params: Any         # MLP (or its layer list) for dqn; else a dict
    meta: dict = dataclasses.field(default_factory=dict)
    version: int = BUNDLE_VERSION

    def spec(self):
        return make_spec(self.obs_spec, self.n_max)


def _layers(params) -> list:
    """dqn params as the reference's ``[{"w", "b"}]`` layer list."""
    return params.to_layers() if isinstance(params, MLP) else params


def _validate(bundle: PolicyBundle) -> None:
    if bundle.obs_spec not in SPEC_NAMES:
        raise BundleError(f"bundle declares unknown observation spec "
                          f"{bundle.obs_spec!r}; known: {SPEC_NAMES}")
    if bundle.n_max < 1:
        raise BundleError(f"bundle n_max must be >= 1, got {bundle.n_max}")
    if bundle.kind not in KINDS:
        raise BundleError(f"unknown policy kind {bundle.kind!r}")
    if bundle.kind == "cost_greedy":
        if "economy" not in bundle.spec().blocks:
            raise SpecMismatchError(
                f"cost_greedy bundles route on the 'economy' feature "
                f"block, absent from spec {bundle.obs_spec!r}; use the "
                f"'economy' or 'full_economy' variants")
        if "economy_profile" not in bundle.meta:
            raise BundleError(
                "cost_greedy bundle must record its economy profile "
                "under meta['economy_profile']")
    if bundle.kind == "dqn":
        try:
            width = int(np.asarray(_layers(bundle.params)[0]["w"]).shape[0])
        except (TypeError, KeyError, IndexError) as e:
            raise BundleError(f"dqn bundle params are not an MLP layer "
                              f"list: {e!r}") from e
        dim = bundle.spec().dim
        if width != dim:
            raise SpecMismatchError(
                f"dqn params expect {width}-dim observations but the "
                f"declared spec {bundle.obs_spec!r}/n_max={bundle.n_max} "
                f"encodes {dim} features")


def save_bundle(path: str, bundle: PolicyBundle) -> None:
    _validate(bundle)
    params = (_layers(bundle.params) if bundle.kind == "dqn"
              else bundle.params)
    save(path, {
        "format": BUNDLE_FORMAT,
        "version": int(bundle.version),
        "kind": str(bundle.kind),
        "obs_spec": str(bundle.obs_spec),
        "n_max": int(bundle.n_max),
        "params": params,
        "meta": dict(bundle.meta),
    })


def load_bundle(path: str, *, expect_spec: str | None = None,
                expect_n_max: int | None = None) -> PolicyBundle:
    """Load and validate; params come back as host tensors (a layer list
    for dqn; a qtable's rows too, under their bytes keys)."""
    raw = restore(path)
    if not isinstance(raw, dict) or raw.get("format") != BUNDLE_FORMAT:
        raise BundleError(f"{path} is not a PolicyBundle checkpoint")
    version = int(raw["version"])
    if version > BUNDLE_VERSION:
        raise BundleError(f"{path} uses bundle schema v{version}; this "
                          f"build reads <= v{BUNDLE_VERSION}")
    bundle = PolicyBundle(kind=str(raw["kind"]),
                          obs_spec=str(raw["obs_spec"]),
                          n_max=int(raw["n_max"]), params=raw["params"],
                          meta=raw.get("meta") or {}, version=version)
    _validate(bundle)
    if expect_spec is not None and expect_spec != bundle.obs_spec:
        raise SpecMismatchError(f"{path} was trained under obs spec "
                                f"{bundle.obs_spec!r}, caller expects "
                                f"{expect_spec!r}")
    if expect_n_max is not None and expect_n_max != bundle.n_max:
        raise SpecMismatchError(f"{path} was trained at n_max="
                                f"{bundle.n_max}, caller expects "
                                f"n_max={expect_n_max}")
    return bundle


def policy_from_bundle(bundle: PolicyBundle,
                       device="cuda") -> tuple[Policy, Any]:
    """The (policy, params) pair a bundle describes, params on
    ``device``."""
    dev = resolve_device(device)
    spec = bundle.spec()
    if bundle.kind == "dqn":
        net = (bundle.params if isinstance(bundle.params, MLP)
               else MLP.from_layers(bundle.params))
        hidden = net.sizes[1:-1]
        return adapters.dqn_policy(spec, hidden=hidden), net.to(dev)
    if bundle.kind in ("greedy", "oracle"):
        params = params_to({k: torch.as_tensor(v)
                            for k, v in bundle.params.items()}, dev)
        if bundle.kind == "greedy":
            return adapters.heuristic_greedy_policy(spec), params
        return adapters.oracle_policy(spec), params
    if bundle.kind == "cost_greedy":
        # lazy import: repro_torch.economy imports the policy adapters
        from repro_torch.economy import builtin_profile, cost_greedy_policy
        meta = bundle.meta  # _validate guarantees the profile record
        profile = builtin_profile(str(meta["economy_profile"]))
        kw = {k: float(meta[k]) for k in
              ("lam_cost", "lam_energy", "tick_ms") if k in meta}
        policy = cost_greedy_policy(spec, profile, **kw)
        params = params_to({k: torch.as_tensor(v)
                            for k, v in bundle.params.items()}, dev)
        return policy, params
    if bundle.kind == "qtable":
        # host-side: the rows stay numpy arrays under their bytes keys
        params = {k: np.asarray(v) for k, v in bundle.params.items()}
        return adapters.qtable_policy(), params
    raise BundleError(f"unknown policy kind {bundle.kind!r}")
