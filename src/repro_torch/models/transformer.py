"""Decoder assembly: embeddings → layer stack → head.

Counterpart of ``repro.models.transformer`` for the attention kinds
(``attn``, ``attn_local``, ``shared_attn``) and every ``pos_embed``.  The
parameter and cache trees are the JAX package's: each ``scan_unit`` slot
is stacked over ``scan_repeats`` along a leading axis, then comes the
``tail``.  JAX lowers the stack as one ``lax.scan``; here it is a Python
loop over the repeats, and there is no ``remat`` (nothing is
differentiated).  "shared_attn" blocks read one shared parameter set and
keep a cache of their own per occurrence.

Modes:
  * prefill — ``forward(..., cache=init_cache(...))``       → logits, cache
  * decode  — ``forward(..., cache=filled)`` with S=1 tokens → logits, cache
    (the given cache's buffers are updated in place and returned)
  * forward — ``forward(params, cfg, batch)``                → logits

MoE, Mamba2 and RWKV6 blocks and ``lm_loss`` wait for later slices
(ROADMAP Queue 1) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch

from ..core.pytree import tree_map
from ..device import resolve_device
from .attention import attention_block, init_attention, init_kv_cache
from .config import ModelConfig
from .layers import (embed, init_embed, init_mlp, init_normal, init_rms_norm,
                     mlp, mrope_angles, rms_norm, rope_angles,
                     sinusoidal_positions)

ATTN_KINDS = ("attn", "attn_local", "shared_attn")


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet: the port's transformer runs the attention "
        "kinds (attn, attn_local, shared_attn); see ROADMAP Queue 1")


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_block(cfg: ModelConfig, kind: str, dtype, kw, lead=()):
    if kind in ("attn", "attn_local"):
        if cfg.n_experts:
            raise _not_ported("the MoE block (models/moe.py)")
        dev = kw["device"]
        return {"ln1": init_rms_norm(cfg.d_model, device=dev, lead=lead),
                "attn": init_attention(cfg, dtype, lead=lead, **kw),
                "ln2": init_rms_norm(cfg.d_model, device=dev, lead=lead),
                "mlp": init_mlp(cfg.d_model, cfg.d_ff, cfg.mlp_gated, dtype,
                                lead=lead, **kw)}
    if kind == "shared_attn":
        return {}                    # parameters live in params["shared_attn"]
    if kind in ("mamba2", "rwkv6"):
        raise _not_ported(f"the {kind} block (models/{kind}.py)")
    raise ValueError(kind)


def init_params(cfg: ModelConfig, *, generator=None, device=None):
    """The JAX package's parameter tree for ``cfg`` (same leaves, shapes,
    scales and dtypes; each scan slot stacked over ``scan_repeats``), drawn
    from ``generator`` on ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    kw = dict(generator=generator, device=dev)
    params: dict = {"embed": init_embed(cfg.vocab_size, cfg.d_model, dtype, **kw)}
    params["scan"] = tuple(_init_block(cfg, kind, dtype, kw, (cfg.scan_repeats,))
                           for kind in cfg.scan_unit)
    params["tail"] = tuple(_init_block(cfg, kind, dtype, kw) for kind in cfg.tail)
    if "shared_attn" in cfg.scan_unit or "shared_attn" in cfg.tail:
        params["shared_attn"] = {"ln1": init_rms_norm(cfg.d_model, device=dev),
                                 "attn": init_attention(cfg, dtype, **kw)}
    if cfg.pos_embed == "learned":
        params["pos_table"] = init_normal((cfg.max_seq, cfg.d_model), 0.02,
                                          dtype, **kw)
    params["final_norm"] = init_rms_norm(cfg.d_model, device=dev)
    if not cfg.tie_embeddings:
        params["lm_head"] = init_normal((cfg.d_model, cfg.vocab_size),
                                        1.0 / math.sqrt(cfg.d_model), dtype, **kw)
    return params


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

def _init_block_cache(cfg: ModelConfig, kind: str, batch: int, s_max: int,
                      dtype, device):
    if kind in ("attn", "shared_attn"):
        w = s_max
    elif kind == "attn_local":
        w = min(cfg.sliding_window or s_max, s_max)
    elif kind in ("mamba2", "rwkv6"):
        raise _not_ported(f"the {kind} cache")
    else:
        raise ValueError(kind)
    return init_kv_cache(batch, w, cfg.n_kv_heads, cfg.head_dim, dtype,
                         quantized=cfg.kv_cache_int8, device=device)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, dtype=None,
               device=None):
    """Cache tree: per scan slot stacked over repeats, plus the tail.
    ``length`` is a Python int throughout."""
    dev = resolve_device(device)
    dtype = dtype or getattr(torch, cfg.dtype)

    def stacked(kind):
        one = _init_block_cache(cfg, kind, batch, s_max, dtype, dev)
        return tree_map(lambda a: a if isinstance(a, int) else
                        a[None].repeat((cfg.scan_repeats,) + (1,) * a.dim()), one)

    return {"scan": tuple(stacked(k) for k in cfg.scan_unit),
            "tail": tuple(_init_block_cache(cfg, k, batch, s_max, dtype, dev)
                          for k in cfg.tail),
            "length": 0}


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def _apply_block(params, cfg, kind, x, rope_cs, rope_cs_local, positions,
                 cache, shared_params, backend):
    """One layer; its cache's buffers are updated in place.  Returns x."""
    if kind not in ATTN_KINDS:
        raise _not_ported(f"the {kind} block (models/{kind}.py)")
    p = shared_params if kind == "shared_attn" else params
    window = cfg.sliding_window if kind == "attn_local" else None
    cs = rope_cs_local if (kind == "attn_local"
                           and rope_cs_local is not None) else rope_cs
    h, _ = attention_block(
        p["attn"], cfg, rms_norm(x, p["ln1"], cfg.norm_eps), rope_cs=cs,
        positions=positions, window=window, cache=cache, backend=backend)
    x = x + h
    if kind != "shared_attn":
        if cfg.n_experts:
            raise _not_ported("the MoE block (models/moe.py)")
        h2 = rms_norm(x, params["ln2"], cfg.norm_eps)
        x = x + mlp(params["mlp"], h2, cfg.mlp_act, cfg.mlp_gated)
    return x


class ForwardOut(NamedTuple):
    logits: torch.Tensor
    cache: Any
    aux_loss: torch.Tensor


def forward(params, cfg: ModelConfig, batch, cache=None,
            backend: str = "chunked") -> ForwardOut:
    """batch keys: "tokens" (B,S) integer and/or "extra_embeds" (B,S_e,D)
    prepended (VLM/audio stubs); optional "positions" (3,B,S) for M-RoPE.
    A given cache is taken over, not copied: the layers write the new
    slots into its buffers in place, and the returned cache holds those
    same buffers with the new length.  (JAX returns a new cache; a copy
    here would move every buffer each decode step.)"""
    tokens = batch.get("tokens")
    x_parts = []
    if batch.get("extra_embeds") is not None:
        x_parts.append(batch["extra_embeds"])
    if tokens is not None:
        x_parts.append(embed(params["embed"], tokens))
    x = x_parts[0] if len(x_parts) == 1 else torch.cat(x_parts, dim=1)
    b, s, _ = x.shape
    dev = x.device

    start = 0 if cache is None else cache["length"]
    positions = start + torch.arange(s, dtype=torch.int32, device=dev)

    rope_cs = rope_cs_local = None
    if cfg.pos_embed == "rope":
        rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
        pos_b = positions[None].expand(b, s)
        rope_cs = rope_angles(pos_b, rot, cfg.rope_theta)
        if cfg.rope_theta_local:
            rope_cs_local = rope_angles(pos_b, rot, cfg.rope_theta_local)
    elif cfg.pos_embed == "mrope":
        rot = int(cfg.head_dim * cfg.rotary_pct) // 2 * 2
        pos3 = batch.get("positions")
        if pos3 is None:
            pos3 = positions[None, None].expand(3, b, s)
        rope_cs = mrope_angles(pos3, rot, cfg.rope_theta)
    elif cfg.pos_embed == "learned":
        pos_emb = params["pos_table"][positions.clamp(0, cfg.max_seq - 1)]
        x = x + pos_emb[None]
    elif cfg.pos_embed == "sinusoidal":
        x = x + sinusoidal_positions(positions, cfg.d_model, x.dtype)[None]

    shared = params.get("shared_attn")
    new_cache = cache

    def layer_cache(slot_cache, r):
        return tree_map(lambda a: a if isinstance(a, int) else a[r], slot_cache)

    for r in range(cfg.scan_repeats):
        for i, kind in enumerate(cfg.scan_unit):
            p = None if kind == "shared_attn" else tree_map(
                lambda a: a[r], params["scan"][i])
            c = None if new_cache is None else layer_cache(new_cache["scan"][i], r)
            x = _apply_block(p, cfg, kind, x, rope_cs, rope_cs_local,
                             positions, c, shared, backend)
    for i, kind in enumerate(cfg.tail):
        c = None if new_cache is None else new_cache["tail"][i]
        x = _apply_block(params["tail"][i], cfg, kind, x, rope_cs,
                         rope_cs_local, positions, c, shared, backend)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"]["table"].T if cfg.tie_embeddings else params["lm_head"]
    logits = x @ head

    if new_cache is not None:
        # the layers wrote into the buffers in place; every length moves on
        new_cache = tree_map(lambda a: start + s if isinstance(a, int) else a,
                             new_cache)
    return ForwardOut(logits=logits, cache=new_cache,
                      aux_loss=torch.zeros((), device=dev))


def lm_loss(*args, **kwargs):
    raise _not_ported("lm_loss (training through core/deploy.py)")
