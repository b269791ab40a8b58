"""Model configuration for all assigned architectures.

A copy of ``repro.models.config``: the port imports nothing of the JAX
package, not even its pure-Python modules, so the dataclass is repeated
here field for field and must follow it.

One :class:`ModelConfig` describes any of the six architecture families
(dense / MoE / SSM / hybrid / VLM / audio).  The layer stack is a
repeating ``scan_unit`` (stacked parameters over ``scan_repeats``; the JAX
package lowers it as one ``lax.scan``, the port loops over the repeats)
plus an optional non-repeating ``tail``, which covers heterogeneous
patterns (gemma-3's 5 local : 1 global, zamba2's Mamba2 blocks with a
*weight-shared* attention block every 6 layers).

Layer kinds:
  "attn"        full causal self-attention
  "attn_local"  sliding-window self-attention (width = sliding_window)
  "shared_attn" full attention with parameters shared across occurrences
  "mamba2"      Mamba-2 SSD block
  "rwkv6"       RWKV-6 time-mix + channel-mix block
Every attention/ssm kind is followed by its MLP (or MoE) inside the block,
except "rwkv6" which uses its own channel-mix, and "mamba2" which is a
standalone block (Zamba2-style backbones alternate pure Mamba2 blocks).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense|moe|ssm|hybrid|vlm|audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 → d_model // n_heads

    # layer stack: scan_unit × scan_repeats, then tail
    scan_unit: Tuple[str, ...] = ("attn",)
    scan_repeats: int = 0             # 0 → n_layers (homogeneous)
    tail: Tuple[str, ...] = ()

    # attention
    pos_embed: str = "rope"           # rope|mrope|learned|sinusoidal
    rope_theta: float = 1e4
    rope_theta_local: Optional[float] = None   # separate θ for attn_local
    rotary_pct: float = 1.0
    sliding_window: Optional[int] = None
    attn_logit_softcap: Optional[float] = None
    qk_norm: bool = False

    # mlp
    mlp_gated: bool = True
    mlp_act: str = "silu"             # silu|gelu

    # moe
    n_experts: int = 0
    moe_top_k: int = 2
    moe_dispatch: str = "dense"       # dense|capacity  (perf iteration)
    capacity_factor: float = 1.25

    # ssm (mamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_n_groups: int = 1
    # rwkv6
    rwkv_head_dim: int = 64

    # embeddings / misc
    tie_embeddings: bool = True
    max_seq: int = 32768
    norm_eps: float = 1e-5
    dtype: str = "float32"
    # sub-quadratic attention available? (gates long_500k)
    subquadratic: bool = False
    # chunk size for chunked attention / ssm scans
    chunk_size: int = 128
    # unroll the layer scan (dry-run costing: XLA cost analysis counts loop
    # bodies once, so unrolling makes FLOP/byte totals exact)
    scan_unroll: bool = False
    # two-level remat: group G scan units per checkpoint boundary; saved
    # residuals drop from R·act to (R/G)·act (+G transient recompute).
    # 1 = checkpoint every unit (baseline); √R is the memory-optimal choice.
    remat_group: int = 1
    # quantize the KV cache to int8 (per-entry affine, scale from config)
    kv_cache_int8: bool = False
    # mesh axis carrying the (per-agent) batch/token dim — when set, MoE
    # dispatch applies explicit sharding constraints so GSPMD keeps tokens
    # sharded through the group reshapes (otherwise it all-gathers the full
    # token tensor per layer; see EXPERIMENTS.md §Perf iteration 2)
    act_batch_axis: Optional[str] = None

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.scan_repeats == 0:
            n_unit = len(self.scan_unit)
            reps = (self.n_layers - len(self.tail)) // n_unit
            object.__setattr__(self, "scan_repeats", reps)
        total = len(self.scan_unit) * self.scan_repeats + len(self.tail)
        if total != self.n_layers:
            raise ValueError(
                f"{self.name}: scan_unit×{self.scan_repeats} + tail = {total} "
                f"!= n_layers {self.n_layers}")

    # -- derived ----------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Approximate parameter count (used for roofline MODEL_FLOPS)."""
        kinds = list(self.scan_unit) * self.scan_repeats + list(self.tail)
        n = self.vocab_size * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab_size * self.d_model
        shared_counted = False
        for kind in kinds:
            if kind in ("attn", "attn_local", "shared_attn"):
                if kind == "shared_attn":
                    if shared_counted:
                        continue
                    shared_counted = True
                a = self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim \
                    + self.q_dim * self.d_model
                if kind == "shared_attn":
                    n += a + 2 * self.d_model  # no MLP after shared block
                    continue
                mlp = (3 if self.mlp_gated else 2) * self.d_model * self.d_ff
                if self.n_experts:
                    mlp = mlp * self.n_experts + self.d_model * self.n_experts
                n += a + mlp + 2 * self.d_model
            elif kind == "mamba2":
                d_in = self.ssm_inner
                conv_dim = d_in + 2 * self.ssm_n_groups * self.ssm_state
                n += self.d_model * (2 * d_in + 2 * self.ssm_n_groups * self.ssm_state
                                     + self.ssm_heads)
                n += conv_dim * self.ssm_conv
                n += d_in * self.d_model + 3 * self.ssm_heads + d_in + self.d_model
            elif kind == "rwkv6":
                d = self.d_model
                n += 4 * d * d + d * self.d_ff * 2 + d * self.d_ff  # time+channel mix
                n += 2 * d
        n += self.d_model  # final norm
        return n

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k of n_experts)."""
        if not self.n_experts:
            return self.param_count()
        kinds = list(self.scan_unit) * self.scan_repeats + list(self.tail)
        n_moe_layers = sum(1 for k in kinds if k in ("attn", "attn_local"))
        expert_p = (3 if self.mlp_gated else 2) * self.d_model * self.d_ff
        inactive = n_moe_layers * (self.n_experts - self.moe_top_k) * expert_p
        return self.param_count() - inactive
