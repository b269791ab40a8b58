"""Catalog of the 10 assigned architectures (+ the paper's own problem).

A copy of ``repro.configs.catalog`` (the port imports nothing of the JAX
package); each entry keeps its source comment and must follow the
reference's.

Every config cites its source; reduced smoke variants (2 layers, d≤512,
≤4 experts) are derived with :func:`smoke_variant`.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    unit = cfg.scan_unit
    # keep the unit structure but only 1 repeat; drop tail to ≤ the unit
    n_layers = len(unit)
    kw = dict(
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=256,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        scan_unit=unit,
        scan_repeats=1,
        tail=(),
        max_seq=512,
        chunk_size=64,
        sliding_window=min(cfg.sliding_window, 128) if cfg.sliding_window else None,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        # dense dispatch in smokes: capacity dispatch drops tokens
        # batch-dependently, which breaks exact decode-vs-full checks
        moe_dispatch="dense",
        ssm_state=min(cfg.ssm_state, 32) if cfg.ssm_state else 0,
        ssm_head_dim=32 if cfg.ssm_state else 64,
        dtype="float32",
    )
    return dataclasses.replace(cfg, **kw)


ARCHS = {}


def _register(cfg: ModelConfig) -> ModelConfig:
    ARCHS[cfg.name] = cfg
    return cfg


# -- [audio] MusicGen-large: decoder-only over EnCodec tokens -----------------
# [arXiv:2306.05284] 48L d=2048 32H MHA d_ff=8192 vocab=2048, sinusoidal pos,
# non-gated GELU MLP.  Audio frontend (EnCodec) is a stub per the brief.
musicgen_large = _register(ModelConfig(
    name="musicgen-large", arch_type="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab_size=2048, pos_embed="sinusoidal", mlp_gated=False, mlp_act="gelu",
    tie_embeddings=False, dtype="bfloat16",
))

# -- [dense] Granite-20B code (GPT-BigCode arch): MQA ------------------------
# [arXiv:2405.04324] 52L d=6144 48H kv=1 d_ff=24576 vocab=49152, learned
# positions, non-gated GELU MLP.
granite_20b = _register(ModelConfig(
    name="granite-20b", arch_type="dense",
    n_layers=52, d_model=6144, n_heads=48, n_kv_heads=1, d_ff=24576,
    vocab_size=49152, pos_embed="learned", mlp_gated=False, mlp_act="gelu",
    tie_embeddings=True, dtype="bfloat16",
))

# -- [vlm] Qwen2-VL-7B: M-RoPE, dynamic resolution (vision tower stubbed) ----
# [arXiv:2409.12191] 28L d=3584 28H kv=4 d_ff=18944 vocab=152064.
qwen2_vl_7b = _register(ModelConfig(
    name="qwen2-vl-7b", arch_type="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab_size=152064, pos_embed="mrope", rope_theta=1e6,
    mlp_gated=True, mlp_act="silu", tie_embeddings=False, dtype="bfloat16",
))

# -- [moe] Grok-1 314B: 8 experts top-2, attn softcap ------------------------
# [hf:xai-org/grok-1] 64L d=6144 48H kv=8 d_ff=32768 vocab=131072.
grok_1_314b = _register(ModelConfig(
    name="grok-1-314b", arch_type="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=32768,
    vocab_size=131072, n_experts=8, moe_top_k=2, moe_dispatch="capacity",
    attn_logit_softcap=30.0, mlp_gated=True, mlp_act="gelu",
    tie_embeddings=True, dtype="bfloat16",
))

# -- [moe] Mixtral-8x7B: 8 experts top-2, sliding window ---------------------
# [arXiv:2401.04088] 32L d=4096 32H kv=8 d_ff=14336 vocab=32000, SWA 4096.
mixtral_8x7b = _register(ModelConfig(
    name="mixtral-8x7b", arch_type="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, d_ff=14336,
    vocab_size=32000, n_experts=8, moe_top_k=2, moe_dispatch="capacity",
    scan_unit=("attn_local",), sliding_window=4096, subquadratic=True,
    mlp_gated=True, mlp_act="silu", tie_embeddings=False, dtype="bfloat16",
))

# -- [dense] StableLM-2 1.6B: partial rotary ---------------------------------
# [hf:stabilityai/stablelm-2-1_6b] 24L d=2048 32H MHA d_ff=5632 vocab=100352.
stablelm_1_6b = _register(ModelConfig(
    name="stablelm-1.6b", arch_type="dense",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32, d_ff=5632,
    vocab_size=100352, rotary_pct=0.25,
    mlp_gated=True, mlp_act="silu", tie_embeddings=True, dtype="bfloat16",
))

# -- [dense] Gemma-3 27B: 5 local : 1 global, 128k context -------------------
# [hf:google/gemma-3-*] 62L d=5376 32H kv=16 d_ff=21504 vocab=262144,
# window 1024, qk-norm, distinct RoPE θ for local layers.
gemma3_27b = _register(ModelConfig(
    name="gemma3-27b", arch_type="dense",
    n_layers=62, d_model=5376, n_heads=32, n_kv_heads=16, d_ff=21504,
    vocab_size=262144, head_dim=128,
    scan_unit=("attn_local",) * 5 + ("attn",), scan_repeats=10,
    tail=("attn_local", "attn_local"),
    sliding_window=1024, subquadratic=True, qk_norm=True,
    rope_theta=1e6, rope_theta_local=1e4,
    mlp_gated=True, mlp_act="gelu", tie_embeddings=True, dtype="bfloat16",
))

# -- [hybrid] Zamba2-2.7B: Mamba2 backbone + weight-shared attention ---------
# [arXiv:2411.15242] 54 blocks d=2560, d_ff=10240, ssm_state=64; the shared
# full-attention block is invoked every 6th block (9 invocations).
zamba2_2_7b = _register(ModelConfig(
    name="zamba2-2.7b", arch_type="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab_size=32000, scan_unit=("mamba2",) * 5 + ("shared_attn",),
    scan_repeats=9, ssm_state=64, ssm_head_dim=64, subquadratic=True,
    mlp_gated=True, mlp_act="silu", tie_embeddings=True, dtype="bfloat16",
))

# -- [dense] H2O-Danube-3 4B: llama+mistral mix, SWA -------------------------
# [arXiv:2401.16818] 24L d=3840 32H kv=8 d_ff=10240 vocab=32000, SWA 4096.
h2o_danube3_4b = _register(ModelConfig(
    name="h2o-danube-3-4b", arch_type="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv_heads=8, d_ff=10240,
    vocab_size=32000, scan_unit=("attn_local",), sliding_window=4096,
    subquadratic=True, head_dim=120,
    mlp_gated=True, mlp_act="silu", tie_embeddings=False, dtype="bfloat16",
))

# -- [ssm] RWKV-6 "Finch" 3B: attention-free, data-dependent decay -----------
# [arXiv:2404.05892] 32L d=2560 d_ff=8960 vocab=65536.
rwkv6_3b = _register(ModelConfig(
    name="rwkv6-3b", arch_type="ssm",
    n_layers=32, d_model=2560, n_heads=1, n_kv_heads=1, head_dim=2560,
    d_ff=8960, vocab_size=65536, scan_unit=("rwkv6",), subquadratic=True,
    rwkv_head_dim=64, pos_embed="none", tie_embeddings=False, dtype="bfloat16",
))


def get(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; options: {sorted(ARCHS)}")
    return ARCHS[name]
