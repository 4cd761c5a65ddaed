"""Carry weights and state from the reference package into the port.

Every function takes the reference's objects as plain arrays (anything
``numpy.asarray`` reads, e.g. ``np.asarray(jax_array)``), reading fields
by name, so this module imports nothing of the reference:

    mlp_from_layers     [{"w", "b"}] layer list → MLP
    policy_params       greedy / oracle / guarded params dicts (inner MLP
                        or dict); a qtable dict stays on the host
    fleet_scenario      FleetScenario fields → port FleetScenario (from
                        random_fleet, from_table4 or one stage of
                        curriculum_fleets)
    request_stream      RequestStream arrays → port RequestStream
    key_from_data       a (2,) uint32 key_data pair → port threefry key
    lm_params           an LM params pytree → the port's LM module
    tier_economy_state  a TierEconomyState → the port's
    fleet_state         a FleetState (env carry, its ``econ`` included) →
                        port FleetState
    metric_buffer       a telemetry MetricBuffer (edges, hist, counters
                        and gauges dicts) → the port's
    dqn_state           a DQNState (online and target networks, Adam
                        moments, step) → the port's
    system_model_state  a SystemModelState (network, Adam moments,
                        step) → the port's
    hl_train_state      the fleet trainer's whole carry (HLTrainState),
                        its telemetry buffer included → the port's;
                        ``hl_train_state_arrays`` is its inverse, to numpy
                        in the reference's layout
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dqn import DQNState
from repro_torch.core.networks import MLP
from repro_torch.core.system_model import SystemModelState
from repro_torch.device import resolve_device
from repro_torch.economy.tiers import TierEconomyState
from repro_torch.fleet.env import FleetBackground, FleetState
from repro_torch.fleet.workload import FleetScenario
from repro_torch.hltrain.buffers import PlanRing, PrioRing, Ring
from repro_torch.hltrain.trainer import HLTrainState
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.random import MASK32
from repro_torch.serve.stream import RequestStream
from repro_torch.telemetry.metrics import MetricBuffer
from repro_torch.training.optimizer import AdamState, SgdState
from repro_torch.training.train_step import TrainState, param_tree


def mlp_from_layers(layers, device="cuda") -> MLP:
    return MLP.from_layers(layers).to(resolve_device(device))


def _tensors(tree, dev):
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), device=dev)


def host_tensor(a, device="cpu") -> torch.Tensor:
    """A copy of the array ``a`` as a tensor of its own dtype.  A bfloat16
    array (``ml_dtypes.bfloat16``, which torch cannot read) crosses bit for
    bit as its 16-bit words viewed as ``torch.bfloat16``, so nothing here
    needs ``ml_dtypes``."""
    arr = np.array(a)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.as_tensor(arr, device=device)


def policy_params(params, device="cuda"):
    """A params pytree of the reference's adapters: a dqn layer list
    becomes an MLP, dicts of arrays (greedy; oracle's ``table`` and
    ``n_users``; guarded, whose ``inner`` may be a layer list) become
    dicts of tensors.  A qtable dict (bytes keys) keeps its keys and
    holds its rows as numpy arrays: the adapter runs on the host."""
    dev = resolve_device(device)
    if isinstance(params, (list, tuple)):
        return mlp_from_layers(params, dev)
    if params and all(isinstance(k, bytes) for k in params):
        return {k: np.asarray(v) for k, v in params.items()}
    return {k: (policy_params(v, dev) if isinstance(v, (list, tuple, dict))
                else _tensors(v, dev))
            for k, v in params.items()}


def fleet_scenario(scenario, device="cuda") -> FleetScenario:
    """The reference's ``FleetScenario`` (fields read by name), with its
    group index."""
    dev = resolve_device(device)
    field = lambda name, dtype: (
        None if getattr(scenario, name) is None else
        torch.as_tensor(np.array(getattr(scenario, name), dtype),
                        device=dev))
    return FleetScenario(field("weak_s", bool), field("weak_e", bool),
                         field("n_users", np.int32),
                         field("constraint", np.float32),
                         latency_target=field("latency_target", np.float32),
                         edge_group=field("edge_group", np.int32)
                         ).with_group_index()


def request_stream(stream) -> RequestStream:
    """The reference's ``RequestStream`` (host arrays stay numpy)."""
    return RequestStream(np.asarray(stream.t_ms, np.float32),
                         np.asarray(stream.cell, np.int32),
                         np.asarray(stream.slo_ms, np.float32),
                         float(stream.horizon_ms), float(stream.epoch_ms),
                         int(stream.n_cells))


def key_from_data(key_data, device="cuda") -> torch.Tensor:
    """A reference key's (2,) uint32 data (``jax.random.key_data`` or a
    raw ``PRNGKey``) as the port's (2,) int64 key."""
    words = np.asarray(key_data, np.uint64).reshape(2) & MASK32
    return torch.as_tensor(words.astype(np.int64),
                           device=resolve_device(device))


def _map_tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def lm_params(params, cfg: ModelConfig, device="cuda") -> tf.LM:
    """The reference's LM params pytree (``repro.models.transformer.
    init_params``: ``embed``, ``final_norm``, ``lm_head``, the scanned
    ``segments``, each a dict of arrays with a leading layer axis, and
    zamba2's ``shared_block``) as the port's
    :class:`~repro_torch.models.transformer.LM`: every segment is
    unstacked into one block module per layer, in order, each array in
    its own dtype (the nested ``moe`` and ``mla`` trees too, the
    router float32 whatever the parameter dtype; with codebooks the
    (K, V, D) embedding and (K, D, V) head as they are)."""
    dev = resolve_device(device)
    tensor = lambda a: host_tensor(a, dev)
    blocks = []
    for (kind, n), seg in zip(tf.segment_plan(cfg), params["segments"]):
        for i in range(n):
            blocks.append(tf.BLOCKS[kind](
                _map_tree(seg, lambda a, i=i: tensor(np.asarray(a)[i]))))
    head = None if cfg.tie_embeddings else tensor(params["lm_head"])
    shared = (tf.AttnBlock(_map_tree(params["shared_block"], tensor))
              if cfg.shared_attn_every else None)
    return tf.LM(cfg, _map_tree(params["embed"], tensor),
                 _map_tree(params["final_norm"], tensor), blocks, head,
                 shared)


def lm_param_tree(tree, cfg: ModelConfig, device="cuda") -> dict:
    """A pytree shaped as the reference's LM params (its parameters, or
    an optimizer moment of them) as the port's ``{name: tensor}`` tree
    (``repro_torch.training.train_step.param_tree``)."""
    return {k: v.detach() for k, v in
            param_tree(lm_params(tree, cfg, device)).items()}


def lm_train_state(state, cfg: ModelConfig, device="cuda") -> TrainState:
    """The reference's LM ``TrainState`` (``repro.training.train_step``;
    arrays as numpy) as the port's: the LM with gradients on, the
    ``AdamState`` or ``SgdState`` over its parameter names, the step."""
    dev = resolve_device(device)
    params = lm_params(state.params, cfg, dev).requires_grad_(True)
    opt = state.opt_state
    step = _array(opt.step, np.int32, dev)
    if hasattr(opt, "mu"):
        opt_state = AdamState(step, lm_param_tree(opt.mu, cfg, dev),
                              lm_param_tree(opt.nu, cfg, dev))
    else:
        opt_state = SgdState(step, None if opt.momentum is None else
                             lm_param_tree(opt.momentum, cfg, dev))
    return TrainState(params, opt_state, _array(state.step, np.int32, dev))


# ------------------------------------------------------------ trainer carry
def _array(x, dtype=None, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.array(x, dtype=dtype), device=device)


def tier_economy_state(econ, device="cuda") -> TierEconomyState:
    """The reference's ``TierEconomyState`` (fields read by name)."""
    dev = resolve_device(device)
    return TierEconomyState(*(
        _array(getattr(econ, f),
               np.float32 if f == "slot_penalty_ms" else np.int32, dev)
        for f in TierEconomyState._fields))


def fleet_state(state, device="cuda") -> FleetState:
    """The reference's ``FleetState`` (fields read by name), its tier
    economy state included when it has one."""
    dev = resolve_device(device)
    bg = state.bg
    econ = getattr(state, "econ", None)
    return FleetState(
        key_from_data(state.key, dev),
        _array(state.actions, np.int32, dev),
        _array(state.user, np.int32, dev),
        _array(state.charged, np.float32, dev),
        FleetBackground(*(_array(getattr(bg, f), None, dev)
                          for f in FleetBackground._fields)),
        None if econ is None else tier_economy_state(econ, dev))


def _flat_layers(layers, dev) -> list:
    """A ``[{"w", "b"}]`` tree as ``list(MLP.parameters())`` orders it:
    every weight, then every bias."""
    return ([_array(l["w"], np.float32, dev) for l in layers]
            + [_array(l["b"], np.float32, dev) for l in layers])


def _layers(flat: list) -> list:
    n = len(flat) // 2
    host = lambda t: t.detach().cpu().numpy()
    return [{"w": host(flat[i]), "b": host(flat[n + i])} for i in range(n)]


def _adam(opt_state, dev) -> AdamState:
    return AdamState(_array(opt_state.step, np.int32, dev),
                     _flat_layers(opt_state.mu, dev),
                     _flat_layers(opt_state.nu, dev))


def _mlp(layers, dev) -> MLP:
    return mlp_from_layers([{k: np.array(v, np.float32)
                             for k, v in layer.items()} for layer in layers],
                           dev)


def dqn_state(state, device="cuda") -> DQNState:
    """The reference's ``DQNState`` (``make_dqn``'s: online and target
    layer lists, Adam state, step) as the port's, on ``device``."""
    dev = resolve_device(device)
    return DQNState(_mlp(state.params, dev),
                    _mlp(state.target_params, dev).requires_grad_(False),
                    _adam(state.opt_state, dev),
                    _array(state.step, np.int32, dev))


def system_model_state(state, device="cuda") -> SystemModelState:
    """The reference's ``SystemModelState`` (layer list, Adam state,
    step) as the port's, on ``device``."""
    dev = resolve_device(device)
    return SystemModelState(_mlp(state.params, dev),
                            _adam(state.opt_state, dev),
                            _array(state.step, np.int32, dev))


def _ring(ring, dev) -> Ring:
    """A reference ring with the port's trash row appended."""
    def rows(x, dtype):
        x = np.array(x, dtype)
        return _array(np.concatenate([x, np.zeros_like(x[:1])]), dtype, dev)
    return Ring(rows(ring.s, np.float32), rows(ring.a, np.int32),
                rows(ring.r, np.float32), rows(ring.s2, np.float32),
                rows(ring.done, np.float32), _array(ring.ptr, np.int32, dev),
                _array(ring.size, np.int32, dev))


def _prio(buf, dev) -> PrioRing:
    prio = np.array(buf.prio, np.float32)
    return PrioRing(_ring(buf.ring, dev),
                    _array(np.append(prio, np.float32(0)), np.float32, dev),
                    _array(buf.max_prio, np.float32, dev))


def metric_buffer(buf, device="cuda") -> MetricBuffer:
    """The reference's ``MetricBuffer``: its counters and gauges dicts
    become the port's (W, K) and (W, G) matrices, columns in dict
    order."""
    dev = resolve_device(device)
    n_windows = int(np.asarray(next(iter(
        {**buf.counters, **buf.gauges}.values()))).shape[0])

    def cols(d: dict, dtype):
        return _array(np.stack([np.array(v, dtype) for v in d.values()], 1)
                      if d else np.zeros((n_windows, 0), dtype), None, dev)

    return MetricBuffer(
        edges=_array(buf.edges, np.float32, dev),
        hist=_array(buf.hist, np.int32, dev),
        counts=cols(buf.counters, np.int64),
        snaps=cols(buf.gauges, np.float32),
        counter_names=tuple(buf.counters), gauge_names=tuple(buf.gauges))


def hl_train_state(state, device="cuda") -> HLTrainState:
    """The reference's ``HLTrainState`` — key, DQN (online, target, Adam
    moments), system model and moments, the three buffers, env state,
    observations, ε scales, counters and the telemetry buffer when it
    has one — as the port's, on ``device``."""
    dev = resolve_device(device)
    tel = getattr(state, "tel", None)
    i32 = lambda x: _array(x, np.int32, dev)
    return HLTrainState(
        key=key_from_data(state.key, dev),
        dqn=dqn_state(state.dqn, dev),
        sm=system_model_state(state.sm, dev),
        d_direct=_prio(state.d_direct, dev),
        d_world=_ring(state.d_world, dev),
        d_plan=PlanRing(_prio(state.d_plan.buf, dev),
                        _array(np.append(np.array(state.d_plan.keys,
                                                  np.int64), 0),
                               np.int64, dev)),
        env=fleet_state(state.env, dev),
        obs=_array(state.obs, np.float32, dev),
        eps_scale=_array(state.eps_scale, np.float32, dev),
        steps_per_cell=i32(state.steps_per_cell),
        direct_steps=i32(state.direct_steps),
        verify_steps=i32(state.verify_steps), sessions=i32(state.sessions),
        tel=None if tel is None else metric_buffer(tel, dev))


def hl_train_state_arrays(state: HLTrainState) -> dict:
    """The port's trainer carry as nested dicts of numpy arrays in the
    reference's layout and field names (NamedTuples as dicts, layer
    lists as ``[{"w", "b"}]``, the buffers without their trash row, keys
    as uint32)."""
    host = lambda t: t.detach().cpu().numpy()
    u32 = lambda t: host(t).astype(np.uint32)

    def adam(o):
        return {"step": host(o.step), "mu": _layers(o.mu),
                "nu": _layers(o.nu)}

    def ring(r):
        return {"s": host(r.s[:-1]), "a": host(r.a[:-1]),
                "r": host(r.r[:-1]), "s2": host(r.s2[:-1]),
                "done": host(r.done[:-1]), "ptr": host(r.ptr),
                "size": host(r.size)}

    def prio(b):
        return {"ring": ring(b.ring), "prio": host(b.prio[:-1]),
                "max_prio": host(b.max_prio)}

    dqn, sm, env = state.dqn, state.sm, state.env
    out = {
        "key": u32(state.key),
        "dqn": {"params": dqn.params.to_layers(),
                "target_params": dqn.target_params.to_layers(),
                "opt_state": adam(dqn.opt_state), "step": host(dqn.step)},
        "sm": {"params": sm.params.to_layers(),
               "opt_state": adam(sm.opt_state), "step": host(sm.step)},
        "d_direct": prio(state.d_direct), "d_world": ring(state.d_world),
        "d_plan": {"buf": prio(state.d_plan.buf),
                   "keys": u32(state.d_plan.keys[:-1])},
        "env": {"key": u32(env.key), "actions": host(env.actions),
                "user": host(env.user), "charged": host(env.charged),
                "bg": {f: host(getattr(env.bg, f))
                       for f in FleetBackground._fields}},
        "obs": host(state.obs), "eps_scale": host(state.eps_scale),
        "steps_per_cell": host(state.steps_per_cell),
        "direct_steps": host(state.direct_steps),
        "verify_steps": host(state.verify_steps),
        "sessions": host(state.sessions),
    }
    if state.tel is not None:
        out["tel"] = metric_buffer_arrays(state.tel)
    return out


def metric_buffer_arrays(buf: MetricBuffer) -> dict:
    """A port ``MetricBuffer`` as numpy in the reference's layout: edges,
    hist, and the counters and gauges as dicts of (W,) columns."""
    host = lambda t: t.detach().cpu().numpy()
    return {"edges": host(buf.edges), "hist": host(buf.hist),
            "counters": dict(zip(buf.counter_names, host(buf.counts).T)),
            "gauges": dict(zip(buf.gauge_names, host(buf.snaps).T))}
