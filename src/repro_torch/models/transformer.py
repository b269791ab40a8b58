"""Decoder assembly: embeddings → layer stack → head, + LM loss.

Counterpart of ``repro.models.transformer`` for the attention kinds
(``attn``, ``attn_local``, ``shared_attn``) and every ``pos_embed``.  The
parameter and cache trees are the JAX package's: each ``scan_unit`` slot
is stacked over ``scan_repeats`` along a leading axis, then comes the
``tail``.  JAX lowers the stack as one ``lax.scan``; here it is a Python
loop over the repeats.  Without a cache and with autograd recording, each
scan unit (or each group of ``cfg.remat_group`` units, JAX's two-level
remat) runs under ``torch.utils.checkpoint``, as JAX wraps the scan body
in ``jax.checkpoint``: its activations are recomputed in the backward,
attention's forward kernel included.  "shared_attn" blocks read one shared
parameter set and keep a cache of their own per occurrence.

Modes:
  * train   — ``forward(params, cfg, batch)`` / ``lm_loss``  → logits, aux
  * prefill — ``forward(..., cache=init_cache(...))``       → logits, cache
  * decode  — ``forward(..., cache=filled)`` with S=1 tokens → logits, cache
    (the given cache's buffers are updated in place and returned)

MoE, Mamba2 and RWKV6 blocks wait for later slices (ROADMAP Queue 1) and
raise ``NotImplementedError``, and so does ``lm_loss`` on a config that
holds one.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..core.pytree import tree_leaves, tree_map, tree_unflatten
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


def _check_ported(cfg: ModelConfig, what: str) -> None:
    """Raise before any work when ``cfg`` holds a block of a later slice."""
    if cfg.n_experts:
        raise _not_ported(f"{what} on an MoE config (models/moe.py)")
    for kind in cfg.scan_unit + cfg.tail:
        if kind not in ATTN_KINDS:
            raise _not_ported(f"{what} on a config with {kind} blocks "
                              f"(models/{kind}.py)")


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


def _unstack(tree, n: int) -> list:
    """The ``n`` slices along the leading axis of a stacked tree, one tree
    each.  One ``unbind`` per leaf, so the backward stacks each leaf's
    gradient once (slicing ``a[r]`` per layer would build a zero-padded
    full-size gradient per slice)."""
    parts = [a.unbind(0) for a in tree_leaves(tree)]
    return [tree_unflatten(tree, [p[r] for p in parts]) for r in range(n)]


def forward(params, cfg: ModelConfig, batch, cache=None,
            backend: str = "chunked", remat: bool = True) -> ForwardOut:
    """batch keys: "tokens" (B,S) integer and/or "extra_embeds" (B,S_e,D)
    prepended (VLM/audio stubs); optional "positions" (3,B,S) for M-RoPE.
    ``remat``: without a cache and with autograd recording, checkpoint each
    scan unit (or group of ``cfg.remat_group`` units).
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

    units = _unstack(params["scan"], cfg.scan_repeats)
    remat = remat and cache is None and torch.is_grad_enabled()
    g = max(1, min(cfg.remat_group, cfg.scan_repeats)) if remat else 1
    g = g if cfg.scan_repeats % g == 0 else 1

    def run(x, r0):
        for r in range(r0, r0 + g):
            for i, kind in enumerate(cfg.scan_unit):
                c = None if cache is None else layer_cache(cache["scan"][i], r)
                x = _apply_block(None if kind == "shared_attn" else units[r][i], cfg,
                                 kind, x, rope_cs, rope_cs_local, positions, c, shared,
                                 backend)
        return x

    for r0 in range(0, cfg.scan_repeats, g):
        x = (checkpoint(run, x, r0, use_reentrant=False, preserve_rng_state=False)
             if remat else run(x, r0))
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


def lm_loss(params, cfg: ModelConfig, batch, backend: str = "chunked",
            aux_coeff: float = 0.01):
    """Next-token cross-entropy in float32; labels −1 are ignored.  Plus
    ``aux_coeff``·aux_loss (0 for the blocks ported so far)."""
    _check_ported(cfg, "lm_loss")
    out = forward(params, cfg, batch, backend=backend)
    logits = out.logits[:, :-1].to(torch.float32)
    labels = batch["labels"][:, 1:]
    valid = labels >= 0
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, labels.clamp(min=0)[..., None].to(torch.int64))[..., 0]
    nll = torch.where(valid, lse - picked, 0.0)
    loss = nll.sum() / valid.sum().clamp(min=1)
    return loss + aux_coeff * out.aux_loss
