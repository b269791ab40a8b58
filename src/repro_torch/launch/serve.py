"""Serving steps: prefill (context → KV cache) and decode (one token).

Counterpart of ``repro.launch.serve``: satellites serve the coordinator
model ŷ between training rounds (e.g. on-board inference over freshly
captured imagery).  The steps run where the parameters lie: make them
with :func:`repro_torch.models.transformer.init_params` on the card, or
with ``device="cpu"``.

    params = init_params(cfg, generator=gen)            # on the card
    logits, cache = make_prefill_step(cfg)(params, {"tokens": prompts})
    tok = logits.argmax(-1, keepdim=True)
    logits, cache = make_decode_step(cfg)(params, cache, tok)

With ``backend="chunked"`` (the default) prefill attention runs the
hand-written flash kernel, one launch per attention layer; decode runs
the plain one-token attention, as in JAX.  A decode step takes over the
cache it is given: it writes the new token's slots into its buffers in
place and returns them, so the cache passed in is not to be used again.
"""
from __future__ import annotations

import contextlib

import torch

from ..core.pytree import tree_flatten_with_names, tree_map
from ..device import is_dtensor
from ..models.transformer import forward, init_cache


def make_prefill_step(cfg, backend: str = "chunked"):
    def prefill_step(params, batch):
        first = next(t for t in (batch.get("tokens"), batch.get("extra_embeds"))
                     if t is not None)
        b = first.shape[0]
        s = batch["tokens"].shape[1] if "tokens" in batch else 0
        if batch.get("extra_embeds") is not None:
            s += batch["extra_embeds"].shape[1]
        # Every cache is sized to the prompt, as in JAX (repro/launch/
        # serve.py:21): a full-attention layer's ring is then full, and the
        # first decode step overwrites its slot 0, the oldest prompt token
        # (ROADMAP Queue 3).
        dtype = getattr(torch, cfg.dtype)
        if is_dtensor(first):
            cache = _cache_on_mesh(cfg, b, s, dtype, first)
        else:
            cache = init_cache(cfg, b, s_max=s, dtype=dtype, device=first.device)
        with _on_mesh(first):
            out = forward(params, cfg, batch, cache=cache, backend=backend)
        # next-token logits only — serving returns the sampled continuation.
        # A copy: a view would keep the (B, S, vocab) logits alive (2.1 GB
        # for danube3 at 4 x 8192).
        return out.logits[:, -1].clone(), out.cache

    return prefill_step


def _on_mesh(like):
    """Where the inputs are DTensors, the model's own plain tensors (RoPE
    tables, positions, masks) join them as replicated
    (``implicit_replication``); else nothing."""
    if not is_dtensor(like):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _cache_on_mesh(cfg, b: int, s: int, dtype, like):
    """``init_cache``'s cache laid out on ``like``'s mesh by the serving
    rules (``launch.sharding.cache_specs``), each rank allocating only its
    shard: slot positions start empty (``EMPTY_POS``), the rest zero."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..models.attention import EMPTY_POS
    from .sharding import cache_specs, full_on_mesh

    mesh = like.device_mesh
    with FakeTensorMode():          # shapes only: no global cache anywhere
        template = init_cache(cfg, b, s_max=s, dtype=dtype, device="meta")
    names, _ = tree_flatten_with_names(template)
    fills = iter(EMPTY_POS if n.endswith(".pos") else 0 for n in names)

    def place(t, spec):
        fill = next(fills)
        if not isinstance(t, torch.Tensor):
            return t
        return full_on_mesh(t.shape, fill, t.dtype, like.to_local().device, mesh, spec)

    return tree_map(place, template, cache_specs(template, mesh, shard_batch=b > 1))


def make_decode_step(cfg, backend: str = "chunked"):
    def decode_step(params, cache, tokens):
        with _on_mesh(tokens):
            out = forward(params, cfg, {"tokens": tokens}, cache=cache,
                          backend=backend)
        return out.logits[:, -1], out.cache

    return decode_step
