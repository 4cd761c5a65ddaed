"""Carry weights and state from the reference package into the port.

Every function takes the reference's objects as plain arrays (anything
``numpy.asarray`` reads, e.g. ``np.asarray(jax_array)``), reading fields
by name, so this module imports nothing of the reference:

    mlp_from_layers     [{"w", "b"}] layer list → MLP
    policy_params       greedy / guarded params dicts (inner MLP or dict)
    fleet_scenario      FleetScenario fields → port FleetScenario
    request_stream      RequestStream arrays → port RequestStream
    key_from_data       a (2,) uint32 key_data pair → port threefry key
    lm_params           an LM params pytree → the port's LM module
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.networks import MLP
from repro_torch.device import resolve_device
from repro_torch.fleet.workload import FleetScenario
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.random import MASK32
from repro_torch.serve.stream import RequestStream


def mlp_from_layers(layers, device="cuda") -> MLP:
    return MLP.from_layers(layers).to(resolve_device(device))


def _tensors(tree, dev):
    if isinstance(tree, dict):
        return {k: _tensors(v, dev) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree), device=dev)


def policy_params(params, device="cuda"):
    """A params pytree of the reference's adapters: a dqn layer list
    becomes an MLP, dicts of arrays (greedy; guarded, whose ``inner`` may
    be a layer list) become dicts of tensors."""
    dev = resolve_device(device)
    if isinstance(params, (list, tuple)):
        return mlp_from_layers(params, dev)
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
    unstacked into one block module per layer, in order."""
    tf.check_supported(cfg)
    dev = resolve_device(device)
    tensor = lambda a: torch.as_tensor(np.array(a), device=dev)
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
