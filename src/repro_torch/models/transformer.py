"""The LM: attention, MLA, MoE, RWKV6 and Mamba2 blocks composed per
config (``repro.models.transformer``'s counterpart for the ``attn``,
``moe``, ``mla_dense``, ``mla_moe``, ``rwkv6`` and ``mamba2`` block
kinds, zamba2's shared attention block, qwen2-vl's M-RoPE positions
and patch embeddings, and musicgen's codebooks: (B, K, S) tokens whose K
embedding tables are summed, K heads giving (B, K, S, V) logits).

Structure: an :class:`LM` module holds the embedding, one block module
per layer (:class:`AttnBlock`, :class:`MoEBlock`, :class:`MLADenseBlock`,
:class:`MLAMoEBlock`, :class:`RWKV6Block` or :class:`Mamba2Block`,
parameters in the reference's ``(d_in, d_out)`` layout and names),
zamba2's one weight-shared ``shared_block`` (an
:class:`AttnBlock` applied after every ``shared_attn_every`` layers,
each application with its own KV ring) and the final norm and head.
The reference stacks identical layers into scanned segments; the port
keeps a plain list (``segment_plan`` still says how the reference's
segments unstack, for ``repro_torch.convert.lm_params``).

Entry points, as in the reference:
  * ``forward``      — teacher-forced logits over a full sequence.
  * ``prefill``      — the full prompt → (last-token logits, cache).
  * ``decode_step``  — one token against the cache.

Prefill runs every block's full-sequence path, which reaches the
hand-written kernels: flash attention in every ``attn``, ``moe``,
``mla_dense`` and ``mla_moe`` block (MLA at Dk 192, Dv 128) and every
application of the shared block, WKV6 in every ``rwkv6`` block, the SSD
scan in every ``mamba2`` block (on CPU tensors their plain versions).
Decode runs plain torch, as the reference does outside any kernel (MLA
in its weight-absorbed form); so does the MoE's routing, dispatch and
expert products (``repro_torch.models.moe``), which the reference
computes outside any kernel too.  Decode dispatches MoE tokens dropless
(``_dropless_cf``); prefill and forward at the config's capacity factor.

Positions: (S,) by default, or the caller's (B, S); with M-RoPE
(``cfg.mrope_sections``) (3, B, S), by default the text position on all
three rows.  ``patch_embeds`` (B, P, D) go in front of the token
embeddings.  A decode step's default position is ``cache["pos"]``, on
all three rows under M-RoPE, as in the reference.

Cache: ``{"pos": int, "layers": [per-layer dict]}`` plus, with a shared
block, ``"shared": [per-application {"k", "v"}]``; KV caches are ring
buffers of capacity ``min(max_len, window)``, MLA's latent caches
``{"ckv", "kpe"}`` hold ``max_len`` tokens.  ``decode_step`` updates the
cache **in place** (the KV or latent slot write and the recurrent
states) and returns it: the reference returns a fresh copy, which at
full width would copy the whole KV cache every token.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.utils.checkpoint
from torch import nn

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rwkv6 as r6
from repro_torch.models.attention import decode_attention
from repro_torch.models.config import ModelConfig


def segment_plan(cfg: ModelConfig) -> list[tuple[str, int]]:
    """[(kind, n_layers)] — the reference's scanned parameter segments:
    contiguous runs of identical block kinds, or, with a shared block,
    groups of ``shared_attn_every`` layers."""
    kinds = cfg.block_kinds()
    if cfg.shared_attn_every:
        every = cfg.shared_attn_every
        return [(kinds[0], min(every, cfg.n_layers - i))
                for i in range(0, cfg.n_layers, every)]
    segs: list[tuple[str, int]] = []
    for kind in kinds:
        if segs and segs[-1][0] == kind:
            segs[-1] = (kind, segs[-1][1] + 1)
        else:
            segs.append((kind, 1))
    return segs


def n_shared_applications(cfg: ModelConfig) -> int:
    """Applications of the shared block: one after every *full* group of
    ``shared_attn_every`` layers."""
    if not cfg.shared_attn_every:
        return 0
    return cfg.n_layers // cfg.shared_attn_every


def layer_schedule(cfg: ModelConfig) -> list[tuple[str, int]]:
    """The order blocks run in: ``("layer", i)`` for layer i and
    ``("shared", j)`` for the j-th application of the shared block."""
    every = cfg.shared_attn_every
    order = []
    for i in range(cfg.n_layers):
        order.append(("layer", i))
        if every and (i + 1) % every == 0:
            order.append(("shared", (i + 1) // every - 1))
    return order


# ---------------------------------------------------------------------------
# blocks
# ---------------------------------------------------------------------------

def _ring_from_prefill(k: torch.Tensor, cap: int) -> torch.Tensor:
    """The last ``cap`` tokens of k (B, S, KV, hd) at ring slots t % cap."""
    b, s, n_kv, hd = k.shape
    out = torch.zeros((b, cap, n_kv, hd), dtype=k.dtype, device=k.device)
    if s <= cap:
        out[:, :s] = k
    else:
        slots = torch.arange(s - cap, s, device=k.device) % cap
        out[:, slots] = k[:, -cap:]
    return out


def _filled(cap: int, pos: int, b: int, device) -> torch.Tensor:
    """(B, cap) bool: the cache slots a decode step at ``pos`` attends
    to (all of them once the ring has wrapped)."""
    return (torch.arange(cap, device=device)
            < min(pos + 1, cap))[None].expand(b, cap)


def _dropless_cf(cfg: ModelConfig):
    """Capacity factor making decode dispatch dropless (capacity = T)."""
    if cfg.moe is None:
        return None
    return cfg.moe.num_experts / cfg.moe.num_experts_per_tok


class AttnBlock(L.ParamTree):
    """Attention + dense MLP: ``ln1``, ``attn`` {wq, wk, wv, wo}, ``ln2``,
    ``mlp``.  ``seq`` and ``decode`` are the reference's ``block_seq`` and
    ``block_decode`` for this kind; ``seq`` returns (x, cache, aux loss)."""

    def _qkv(self, x, cos, sin, cfg: ModelConfig):
        b, s, _ = x.shape
        hd = cfg.resolved_head_dim
        h = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        a = self["attn"]
        q = (h @ a["wq"]).reshape(b, s, cfg.n_heads, hd)
        k = (h @ a["wk"]).reshape(b, s, cfg.n_kv_heads, hd)
        v = (h @ a["wv"]).reshape(b, s, cfg.n_kv_heads, hd)
        return L.apply_rope(q, cos, sin), L.apply_rope(k, cos, sin), v

    def _ffn(self, x, cfg: ModelConfig, capacity_factor=None):
        """(x + FFN(ln2(x)), aux loss)."""
        h = L.rmsnorm(self["ln2"], x, cfg.norm_eps)
        return x + L.apply_mlp(self["mlp"], h, cfg.mlp_kind), 0.0

    def seq(self, x, ctx, return_cache: bool):
        cfg: ModelConfig = ctx["cfg"]
        b, s, _ = x.shape
        q, k, v = self._qkv(x, ctx["cos"], ctx["sin"], cfg)
        o = flash_attention(q, k, v, causal=True, window=cfg.sliding_window)
        x = x + o.reshape(b, s, cfg.attn_out_dim) @ self["attn"]["wo"]
        x, aux = self._ffn(x, cfg)
        cache = None
        if return_cache:
            cap = ctx["cache_cap"]
            cache = {"k": _ring_from_prefill(k, cap),
                     "v": _ring_from_prefill(v, cap)}
        return x, cache, aux

    def decode(self, x, cache, ctx):
        cfg: ModelConfig = ctx["cfg"]
        b = x.shape[0]
        pos = ctx["pos"]
        q, k, v = self._qkv(x, ctx["cos"], ctx["sin"], cfg)
        cap = cache["k"].shape[1]
        slot = pos % cap
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        o = decode_attention(q, cache["k"], cache["v"],
                             _filled(cap, pos, b, x.device))
        x = x + o.reshape(b, 1, cfg.attn_out_dim) @ self["attn"]["wo"]
        return self._ffn(x, cfg, _dropless_cf(cfg))[0], cache


class MoEBlock(AttnBlock):
    """Attention + MoE FFN: ``ln1``, ``attn``, ``ln2``, ``moe`` (the
    reference's ``"moe"`` kind); decode dispatches dropless."""

    def _ffn(self, x, cfg: ModelConfig, capacity_factor=None):
        h = L.rmsnorm(self["ln2"], x, cfg.norm_eps)
        y, aux = moe_lib.apply_moe(self["moe"], h, cfg.moe,
                                   capacity_factor=capacity_factor)
        return x + y, aux


class MLADenseBlock(AttnBlock):
    """Multi-head latent attention + dense MLP: ``ln1``, ``mla``, ``ln2``,
    ``mlp`` (the reference's ``"mla_dense"`` kind).  ``seq`` returns the
    latent caches padded to ``ctx["max_len"]`` tokens; ``decode`` writes
    the new token's latents at slot ``pos`` in place."""

    def seq(self, x, ctx, return_cache: bool):
        cfg: ModelConfig = ctx["cfg"]
        s = x.shape[1]
        h = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        o, ckv, kpe = mla_lib.mla_prefill(self["mla"], h, ctx["cos"],
                                          ctx["sin"], cfg.n_heads, cfg.mla,
                                          cfg.norm_eps)
        x, aux = self._ffn(x + o, cfg)
        cache = None
        if return_cache:
            pad = max(0, ctx["max_len"] - s)
            cache = {"ckv": torch.nn.functional.pad(ckv, (0, 0, 0, pad)),
                     "kpe": torch.nn.functional.pad(kpe, (0, 0, 0, pad))}
        return x, cache, aux

    def decode(self, x, cache, ctx):
        cfg: ModelConfig = ctx["cfg"]
        b = x.shape[0]
        pos = ctx["pos"]
        h = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        ckv, kpe = mla_lib.mla_latents(self["mla"], h, ctx["cos"],
                                       ctx["sin"], cfg.mla, cfg.norm_eps)
        cap = cache["ckv"].shape[1]
        slot = pos % cap
        cache["ckv"][:, slot] = ckv[:, 0]
        cache["kpe"][:, slot] = kpe[:, 0]
        o = mla_lib.mla_decode(self["mla"], h, ctx["cos"], ctx["sin"],
                               cache["ckv"], cache["kpe"],
                               _filled(cap, pos, b, x.device), cfg.n_heads,
                               cfg.mla, cfg.norm_eps)
        return self._ffn(x + o, cfg, _dropless_cf(cfg))[0], cache


class MLAMoEBlock(MLADenseBlock):
    """Multi-head latent attention + MoE FFN (shared experts included):
    ``ln1``, ``mla``, ``ln2``, ``moe`` (the reference's ``"mla_moe"``
    kind)."""

    _ffn = MoEBlock._ffn


class RWKV6Block(L.ParamTree):
    """RWKV6 time-mix + channel-mix: ``tm``, ``cm``, ``ln1``, ``ln2``;
    ``seq`` / ``decode`` as :class:`AttnBlock`'s."""

    def seq(self, x, ctx, return_cache: bool):
        cfg: ModelConfig = ctx["cfg"]
        h1 = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        o, wkv_state = r6.rwkv6_time_mix(self["tm"], h1, r6.token_shift(h1),
                                         cfg.rwkv6)
        x = x + o
        h2 = L.rmsnorm(self["ln2"], x, cfg.norm_eps)
        x = x + r6.rwkv6_channel_mix(self["cm"], h2, r6.token_shift(h2))
        cache = None
        if return_cache:
            cache = {"x_tm": h1[:, -1], "x_cm": h2[:, -1], "wkv": wkv_state}
        return x, cache, 0.0

    def decode(self, x, cache, ctx):
        cfg: ModelConfig = ctx["cfg"]
        h1 = L.rmsnorm(self["ln1"], x, cfg.norm_eps)
        o, cache["wkv"] = r6.rwkv6_time_mix(
            self["tm"], h1, cache["x_tm"][:, None], cfg.rwkv6,
            wkv_state=cache["wkv"])
        x = x + o
        h2 = L.rmsnorm(self["ln2"], x, cfg.norm_eps)
        x = x + r6.rwkv6_channel_mix(self["cm"], h2, cache["x_cm"][:, None])
        cache["x_tm"], cache["x_cm"] = h1[:, 0], h2[:, 0]
        return x, cache


class Mamba2Block(L.ParamTree):
    """Pre-norm Mamba2 mixer: ``ln``, ``mamba``; ``seq`` / ``decode`` as
    :class:`AttnBlock`'s."""

    def seq(self, x, ctx, return_cache: bool):
        cfg: ModelConfig = ctx["cfg"]
        h = L.rmsnorm(self["ln"], x, cfg.norm_eps)
        y, (conv_tail, ssm) = m2.mamba2_forward(self["mamba"], h, cfg.mamba2,
                                                cfg.norm_eps)
        cache = {"conv": conv_tail, "ssm": ssm} if return_cache else None
        return x + y, cache, 0.0

    def decode(self, x, cache, ctx):
        cfg: ModelConfig = ctx["cfg"]
        h = L.rmsnorm(self["ln"], x, cfg.norm_eps)
        y, _ = m2.mamba2_decode(self["mamba"], h, (cache["conv"],
                                                    cache["ssm"]),
                                cfg.mamba2, cfg.norm_eps)
        return x + y, cache


BLOCKS = {"attn": AttnBlock, "moe": MoEBlock, "mla_dense": MLADenseBlock,
          "mla_moe": MLAMoEBlock, "rwkv6": RWKV6Block,
          "mamba2": Mamba2Block}


class LM(nn.Module):
    """Embedding, blocks, final norm and head of one config."""

    def __init__(self, cfg: ModelConfig, embed: dict, final_norm: dict,
                 blocks: list, lm_head: Optional[torch.Tensor] = None,
                 shared_block: Optional[AttnBlock] = None):
        super().__init__()
        self.cfg = cfg
        self.embed = L.ParamTree(embed)
        self.final_norm = L.ParamTree(final_norm)
        self.blocks = nn.ModuleList(blocks)
        if (lm_head is None) != cfg.tie_embeddings:
            raise ValueError("lm_head must be given iff embeddings are "
                             "not tied")
        self.lm_head = (None if lm_head is None
                        else nn.Parameter(lm_head, requires_grad=False))
        if (shared_block is None) != (not cfg.shared_attn_every):
            raise ValueError("shared_block must be given iff "
                             "cfg.shared_attn_every is set")
        self.shared_block = shared_block

    def scheduled(self):
        """(kind, index, block) in the order they run (``layer_schedule``)."""
        for kind, i in layer_schedule(self.cfg):
            yield kind, i, (self.blocks[i] if kind == "layer"
                            else self.shared_block)



# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_layer(gen: torch.Generator, kind: str, cfg: ModelConfig, device
               ) -> L.ParamTree:
    dt, d = cfg.param_torch_dtype, cfg.d_model
    if kind in ("attn", "moe", "mla_dense", "mla_moe"):
        tree = {"ln1": L.init_rmsnorm(d, dt, device)}
        if kind.startswith("mla"):
            tree["mla"] = mla_lib.init_mla(gen, d, cfg.n_heads, cfg.mla, dt,
                                           device)
        else:
            hd = cfg.resolved_head_dim
            dense = lambda shape: L.dense_init(gen, shape, dt, device)
            tree["attn"] = {"wq": dense((d, cfg.n_heads * hd)),
                            "wk": dense((d, cfg.n_kv_heads * hd)),
                            "wv": dense((d, cfg.n_kv_heads * hd)),
                            "wo": dense((cfg.n_heads * hd, d))}
        tree["ln2"] = L.init_rmsnorm(d, dt, device)
        if kind.endswith("moe"):
            tree["moe"] = moe_lib.init_moe(gen, d, cfg.moe, dt, device)
        else:
            tree["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.mlp_kind, dt,
                                     device)
        return BLOCKS[kind](tree)
    if kind == "rwkv6":
        tree = r6.init_rwkv6(gen, d, cfg.d_ff, cfg.rwkv6, dt, device)
        tree["ln1"] = L.init_rmsnorm(d, dt, device)
        tree["ln2"] = L.init_rmsnorm(d, dt, device)
        return RWKV6Block(tree)
    if kind == "mamba2":
        return Mamba2Block({
            "ln": L.init_rmsnorm(d, dt, device),
            "mamba": m2.init_mamba2(gen, d, cfg.mamba2, dt, device)})
    raise ValueError(kind)


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda") -> LM:
    """Random weights from ``torch.Generator(device).manual_seed(seed)``,
    drawn on ``device`` (the reference's distributions, not its numbers).
    With codebooks the embedding is (K, V, D) and the head (K, D, V)."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    dt = cfg.param_torch_dtype
    k = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    embed = {"tok": L.embed_init(gen, (*k, cfg.vocab_size, cfg.d_model), dt,
                                 dev)}
    head = (None if cfg.tie_embeddings else
            L.dense_init(gen, (*k, cfg.d_model, cfg.vocab_size), dt, dev))
    blocks = [init_layer(gen, kind, cfg, dev) for kind in cfg.block_kinds()]
    shared = (init_layer(gen, "attn", cfg, dev) if cfg.shared_attn_every
              else None)
    return LM(cfg, embed, L.init_rmsnorm(cfg.d_model, dt, dev), blocks, head,
              shared)


# ---------------------------------------------------------------------------
# embedding / head
# ---------------------------------------------------------------------------

def embed_inputs(params: LM, cfg: ModelConfig, tokens,
                 patch_embeds=None) -> torch.Tensor:
    """Token embeddings (B, S, D), with ``patch_embeds`` (B, P, D) in
    front when the config has patch positions; codebook tokens (B, K, S)
    sum their K tables' embeddings, in the reference's order."""
    tok = params.embed["tok"]
    if cfg.num_codebooks:
        x = tok[0][tokens[:, 0].long()]
        for i in range(1, cfg.num_codebooks):
            x = x + tok[i][tokens[:, i].long()]
    else:
        x = tok[tokens.long()]
    if cfg.num_patch_positions and patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
    return x.to(cfg.compute_torch_dtype)


def lm_logits(params: LM, cfg: ModelConfig, x) -> torch.Tensor:
    """Logits (B, S, V), or (B, K, S, V) with codebooks
    (``bsd,kdv->bksv``)."""
    x = L.rmsnorm(params.final_norm, x, cfg.norm_eps)
    if cfg.num_codebooks:
        w = (params.embed["tok"].transpose(1, 2) if cfg.tie_embeddings
             else params.lm_head)
        return torch.matmul(x[:, None], w[None])
    if cfg.tie_embeddings:
        return x @ params.embed["tok"].T
    return x @ params.lm_head


# ---------------------------------------------------------------------------
# full model entry points
# ---------------------------------------------------------------------------

def _ctx(cfg: ModelConfig, positions, b: int, s: int, device,
         start: int = 0) -> dict:
    """The rope tables of ``positions``, by default ``start, ..., start +
    s - 1`` (on all three rows under M-RoPE): at MLA's rope width when
    the config has MLA, by M-RoPE sections ((3, B, S) positions) when it
    has them."""
    if positions is None:
        positions = torch.arange(start, start + s, dtype=torch.int32,
                                 device=device)
        if cfg.mrope_sections:
            positions = positions.expand(3, b, s)
    hd = (cfg.mla.qk_rope_head_dim if cfg.mla is not None
          else cfg.resolved_head_dim)
    if cfg.mrope_sections:
        if positions.dim() != 3:
            raise ValueError(f"M-RoPE needs (3, B, S) positions, got "
                             f"{tuple(positions.shape)}")
        cos, sin = L.mrope_cos_sin(positions, hd, cfg.rope_theta,
                                   cfg.mrope_sections)
    else:
        cos, sin = L.rope_cos_sin(positions, hd, cfg.rope_theta)
    return {"cfg": cfg, "cos": cos, "sin": sin}


def _seq(block, x, ctx):
    x, _, aux = block.seq(x, ctx, return_cache=False)
    return x, aux


def forward(params: LM, cfg: ModelConfig, tokens, positions=None,
            patch_embeds=None, *, remat: bool = False):
    """Teacher-forced logits.  tokens: (B, S_text), or (B, K, S) codes;
    positions and patch embeds as the module docstring says → (logits
    (B, S, V) or (B, K, S, V), the MoE blocks' summed aux loss as a 0-d
    float32 tensor, 0 without MoE).

    ``remat``: each layer under ``torch.utils.checkpoint`` (non-reentrant),
    the counterpart of the reference's ``jax.checkpoint`` per scanned
    layer: the backward keeps each layer's input and runs its forward
    again; zamba2's shared block, outside the reference's scan, is not
    recomputed.  It changes no value."""
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    ctx = _ctx(cfg, positions, *x.shape[:2], x.device)
    aux_total = torch.zeros((), device=x.device)
    for kind, _, block in params.scheduled():
        if remat and kind == "layer" and torch.is_grad_enabled():
            x, aux = torch.utils.checkpoint.checkpoint(
                _seq, block, x, ctx, use_reentrant=False)
        else:
            x, aux = _seq(block, x, ctx)
        aux_total = aux_total + aux
    return lm_logits(params, cfg, x), aux_total


def cache_capacity(cfg: ModelConfig, max_len: int) -> int:
    return min(max_len, cfg.sliding_window) if cfg.sliding_window else max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device="cuda") -> dict:
    """Zero cache for autoregressive decoding."""
    dt = cfg.compute_torch_dtype
    zeros = lambda *shape, dtype=dt: torch.zeros(shape, dtype=dtype,
                                                 device=device)
    cap = cache_capacity(cfg, max_len)
    d, hd = cfg.d_model, cfg.resolved_head_dim
    ring = lambda: {"k": zeros(batch, cap, cfg.n_kv_heads, hd),
                    "v": zeros(batch, cap, cfg.n_kv_heads, hd)}
    layers = []
    for kind in cfg.block_kinds():
        if kind in ("attn", "moe"):
            layers.append(ring())
        elif kind in ("mla_dense", "mla_moe"):
            m = cfg.mla
            layers.append({"ckv": zeros(batch, max_len, m.kv_lora_rank),
                           "kpe": zeros(batch, max_len,
                                        m.qk_rope_head_dim)})
        elif kind == "mamba2":
            mc = cfg.mamba2
            conv_dim = mc.d_inner(d) + 2 * mc.n_groups * mc.d_state
            layers.append({"conv": zeros(batch, mc.d_conv - 1, conv_dim),
                           "ssm": zeros(batch, mc.n_heads(d), mc.head_dim,
                                        mc.d_state)})
        else:
            n = cfg.rwkv6.head_dim
            layers.append({"x_tm": zeros(batch, d), "x_cm": zeros(batch, d),
                           "wkv": zeros(batch, d // n, n, n,
                                        dtype=torch.float32)})
    cache = {"pos": 0, "layers": layers}
    if cfg.shared_attn_every:
        cache["shared"] = [ring() for _ in range(n_shared_applications(cfg))]
    return cache


def prefill(params: LM, cfg: ModelConfig, tokens, positions=None,
            patch_embeds=None, max_len: Optional[int] = None):
    """Run the full prompt (B, S_text), or (B, K, S) codes, with its patch
    embeds in front, and build the cache.  Returns (last-token logits
    (B, V) or (B, K, V), cache); ``cache["pos"]`` counts patches and
    text."""
    x = embed_inputs(params, cfg, tokens, patch_embeds)
    s = x.shape[1]
    ctx = _ctx(cfg, positions, x.shape[0], s, x.device)
    ctx["cache_cap"] = cache_capacity(cfg, max_len or s)
    ctx["max_len"] = max_len or s
    caches = {"layer": [], "shared": []}
    for kind, _, block in params.scheduled():
        x, cache, _ = block.seq(x, ctx, return_cache=True)
        caches[kind].append(cache)
    logits = lm_logits(params, cfg, x[:, -1:])
    out = {"pos": s, "layers": caches["layer"]}
    if cfg.shared_attn_every:
        out["shared"] = caches["shared"]
    return logits[..., 0, :], out


def decode_step(params: LM, cfg: ModelConfig, token, cache: dict,
                positions=None):
    """token: (B,), or (B, K) codes; positions (B, 1), or (3, B, 1) under
    M-RoPE, by default ``cache["pos"]``.  Returns (logits (B, V) or
    (B, K, V), cache) — the cache updated in place, ``pos`` advanced by
    one."""
    x = embed_inputs(params, cfg, token[..., None])
    pos = cache["pos"]
    ctx = _ctx(cfg, positions, x.shape[0], 1, x.device, start=pos)
    ctx["pos"] = pos
    for kind, i, block in params.scheduled():
        x, _ = block.decode(
            x, cache["layers" if kind == "layer" else "shared"][i], ctx)
    cache["pos"] = pos + 1
    return lm_logits(params, cfg, x)[..., 0, :], cache
