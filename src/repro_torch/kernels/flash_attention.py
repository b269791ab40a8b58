"""Blocked flash attention: causal, sliding window, tanh softcap, GQA.

Counterpart of ``repro.kernels.flash_attention.flash_attention`` with the
positions of the JAX model's ``attention_chunked`` made explicit:

    s   = q·k / √D                     (float32)
    s   = cap·tanh(s / cap)            with a softcap
    s   = −1e30 unless k_pos ≤ q_pos (causal) and k_pos > q_pos − window
    out = softmax(s)·v                 cast to q's dtype once

q is (B, Sq, H, D), k and v are (B, Sk, Hkv, D) with H % Hkv == 0, and head
h reads KV head ``h // (H // Hkv)``.  ``q_pos`` (Sq,) and ``k_pos`` (Sk,)
default to ``arange``, which gives exactly the Pallas kernel's function.
The Pallas kernel takes q, k and v to float32 before its products, and so
do the CUDA kernels and the plain version; the JAX model's chunked backend
instead rounds bf16 scores before taking them to float32.

The route is chosen by the tensors' device and dtype (:func:`route`), and
nothing falls back from one route to another:

* on the CPU, the plain version in :mod:`.ref`;
* float32 on the card, ``csrc/flash_attention.cu`` (launch name
  ``flash_attention``): float32 FMAs from register micro-tiles, K and V
  through a two-stage ``cp.async`` ring.  It reads q, k and v through
  their strides, with 16-byte copies when every base, stride and D allow
  them (:func:`vec_ready`) and 4-byte copies otherwise, so no input is
  copied first.  Its geometry is :data:`F32_BLOCK_Q` by :data:`F32_BLOCK_K`
  tiles and :func:`f32_smem_bytes` of shared memory;
* bf16 on the card, ``csrc/flash_attention_sm90.cu`` (launch name
  ``flash_attention_sm90``): TMA and ``wgmma``, with P·V in two bf16 terms
  so that it keeps float32 accuracy.  It reads q, k and v through TMA
  tensor maps, which need 16-byte aligned bases, strides of whole 16 bytes
  and D a multiple of 8; an input that breaks this is first copied into a
  layout that keeps it (:func:`tma_layout`).  Each block decides which
  key tiles its query tile visits from the tiles' ranges of positions;
  :func:`tile_plan` is the CPU copy of that rule (both kernels apply it,
  each at its own tile sizes).  It takes Sk ≤ 2**23.

Both kernels take D ≤ 128.

The gradient: :class:`FlashAttention` is the ``torch.autograd.Function``
that :func:`flash_attention` (and so ``ops.attention``) goes through.  Its
forward is the routes above; its backward is :func:`flash_attention_bwd`,
routed by device and dtype as the forward is (:func:`bwd_route`), with no
fallback from one route to another:

* on the CPU, the plain version in :mod:`.ref`;
* float32 on the card, ``csrc/flash_attention_bwd.cu`` (launch name
  ``flash_attention_bwd``): ``mma.sync`` on the tensor cores, each float32
  product as three TF32 products (x = hi + lo, a·b as a_lo·b_hi +
  a_hi·b_lo + a_hi·b_hi), through ``cp.async`` rings, on the statistics
  the float32 forward saves (each row's log-sum-exp; O is its output): a
  byte-bound pass for D = rowsum(dO∘O), dK/dV per :data:`BWD_BLOCK_K` keys
  over query tiles of :data:`BWD_KV_BLOCK_Q` rows, dQ per
  :data:`BWD_BLOCK_Q` query rows over key tiles of :data:`BWD_BLOCK_K`;
  :func:`f32_bwd_smem_bytes` is its shared memory;
* bf16 on the card, ``csrc/flash_attention_bwd_sm90.cu`` (launch name
  ``flash_attention_bwd_sm90``): TMA and ``wgmma``, with P and dS in two
  bf16 terms, on the statistics the bf16 forward saves (each row's
  log-sum-exp and O in float32): a byte-bound pass for D = rowsum(dO∘O),
  dK/dV per :data:`SM90_BWD_BLOCK` keys over query tiles of
  :func:`sm90_bwd_block_q` rows, dQ per :data:`SM90_BWD_BLOCK` query rows
  over key tiles of as many keys; :func:`sm90_bwd_smem_bytes` is its
  shared memory.

:class:`FlashAttention` asks the forward for those statistics only when
autograd records the call (grad enabled and an input that needs it);
every backward route reads them.  The JAX package has no Pallas backward
(it differentiates its chunked attention in XLA), so both backward
kernels are the port's own.  Each skips, by :func:`tile_plan`'s rule,
the pairs of tiles with no visible pair.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..device import is_dtensor
from . import _build, ref

__all__ = ["FlashAttention", "bwd_route", "f32_bwd_smem_bytes",
           "f32_smem_bytes", "flash_attention", "flash_attention_bwd", "route",
           "sm90_bwd_block_q", "sm90_bwd_smem_bytes", "tile_plan", "tma_layout",
           "vec_ready"]

MAX_HEAD_DIM = 128
#: query rows and keys per tile of ``csrc/flash_attention_sm90.cu`` (BQ, BK)
BLOCK_Q = BLOCK_K = 128
#: most keys the sm90 kernel takes: its plan, a byte per key tile, is in
#: shared memory
MAX_SM90_KEYS = 2**23
#: :func:`tile_plan`'s entries: no pair visible, some visible, all visible
SKIP, MASKED, FULL = 0, 1, 2
#: ``csrc/flash_attention.cu`` (float32): query rows and keys per tile, K/V
#: stages in its ring, floats per row of a K stage (and of P^T), key tiles
#: planned at a time (a byte each)
F32_BLOCK_Q, F32_BLOCK_K, F32_STAGES, F32_K_STRIDE, F32_PLAN_TILES = 128, 64, 2, 136, 2048
#: ``csrc/flash_attention_bwd.cu`` (float32): query rows per block of the
#: dQ grid, keys per block of the dK/dV grid and per tile of the dQ grid's
#: ring, and query rows per tile of the dK/dV grid's ring
BWD_BLOCK_Q = BWD_BLOCK_K = 64
BWD_KV_BLOCK_Q = 32
#: ``csrc/flash_attention_bwd_sm90.cu`` (bf16): keys per tile of both grids
#: and query rows per tile of the dQ grid; the rows of the LSE the forward
#: saves are padded to :data:`BLOCK_Q`
SM90_BWD_BLOCK = 64
#: dynamic shared memory one block may take on an H100 (227 KB)
SMEM_LIMIT = 232_448


def f32_smem_bytes(d: int) -> int:
    """Shared memory of one block of the float32 kernel at head dim ``d``:
    Q (F32_BLOCK_Q rows of d rounded up to 8 floats), the K ring (rows of
    F32_K_STRIDE floats), the V ring (rows of 64 or 128 floats) and the
    plan.  The CPU copy of ``smem_bytes`` in ``csrc/flash_attention.cu``."""
    v_cols = 64 if d <= 64 else 128
    floats = (F32_BLOCK_Q * -(-d // 8) * 8 + F32_STAGES * F32_BLOCK_K * F32_K_STRIDE
              + F32_STAGES * F32_BLOCK_K * v_cols)
    return 4 * floats + F32_PLAN_TILES


def f32_bwd_smem_bytes(d: int):
    """(dK/dV grid, dQ grid) shared memory of one block of the float32
    backward at head dim ``d``: rows of D rounded up to 64 or 128, plus 4
    floats (no bank conflicts); K and V and two-stage rings of Q and dO
    and of their LSE and D rows, then the no-key rows' dO sum; Q and dO and
    two-stage rings of K and V.  The CPU copy of ``dkdv_floats`` and
    ``dq_floats`` in ``csrc/flash_attention_bwd.cu``."""
    dp = 64 if d <= 64 else 128
    ld, bq, stages = dp + 4, BWD_KV_BLOCK_Q, 2
    dkdv = 2 * BWD_BLOCK_K * ld + 2 * stages * bq * ld + 2 * stages * bq + dp
    dq = 2 * BWD_BLOCK_Q * ld + 2 * stages * BWD_BLOCK_K * ld
    return 4 * dkdv, 4 * dq


def sm90_bwd_block_q(d: int) -> int:
    """Query rows per tile of the bf16 backward's dK/dV grid at head dim
    ``d``: 64 for D <= 64, else 32 (dK and dV of D = 128 take 128 of a
    thread's registers)."""
    return 64 if d <= 64 else 32


def sm90_bwd_smem_bytes(d: int, sq: int, sk: int):
    """(dK/dV grid, dQ grid) shared memory of one block of the bf16
    backward: the resident tiles (K and V, or Q and dO), two-stage rings of
    the others (and the dK/dV grid's LSE and D rows), the barriers, the
    no-key rows' dO sum, the plan (a byte per tile, rounded to 16) and
    1024 bytes of alignment.  The CPU copy of ``DkdvSmem``/``DqSmem`` in
    ``csrc/flash_attention_bwd_sm90.cu``."""
    halves, bq, box = (1 if d <= 64 else 2), sm90_bwd_block_q(d), SM90_BWD_BLOCK * 128
    stages, bars = 2, 8 * (1 + 2 * 2)
    plan = lambda n: -(-n // 16) * 16
    dkdv = (2 * halves * box + 2 * stages * halves * bq * 128 + 2 * stages * bq * 4
            + bars + 4 * 128 + plan(-(-sq // bq)) + 1024)
    dq = 2 * halves * box + 2 * stages * halves * box + bars + plan(-(-sk // 64)) + 1024
    return dkdv, dq


def vec_ready(t: torch.Tensor) -> bool:
    """Whether the float32 kernel can copy the (B, S, H, D) float32 tensor
    ``t`` in 16-byte pieces: base 16-byte aligned, D and the strides of its
    dimensions of size > 1 multiples of 4 elements, the last stride 1."""
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and t.shape[-1] % 4 == 0
            and all(s % 4 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def route(dtype: torch.dtype, device) -> str:
    """What a call with q, k, v of ``dtype`` on ``device`` runs: ``"plain"``
    or the launch name of its kernel.  Raises for a dtype no kernel takes."""
    if torch.device(device).type == "cpu":
        return "plain"
    if dtype == torch.float32:
        return "flash_attention"
    if dtype == torch.bfloat16:
        return "flash_attention_sm90"
    raise TypeError(f"flash_attention takes float32 or bfloat16 on the card, "
                    f"got {dtype}")


def bwd_route(dtype: torch.dtype, device) -> str:
    """What :func:`flash_attention_bwd` runs for q, k, v of ``dtype`` on
    ``device``: ``"plain"`` or the launch name of its kernel."""
    fwd = route(dtype, device)
    return {"plain": "plain", "flash_attention": "flash_attention_bwd",
            "flash_attention_sm90": "flash_attention_bwd_sm90"}[fwd]


def _tile_ranges(pos: torch.Tensor, block: int):
    """(min, max) of ``pos`` over each tile of ``block`` entries (int64)."""
    n_tiles = -(-pos.numel() // block)
    pad = n_tiles * block - pos.numel()
    p = pos.to(torch.int64)
    lo = F.pad(p, (0, pad), value=2**62).view(n_tiles, block).amin(1)
    hi = F.pad(p, (0, pad), value=-2**62).view(n_tiles, block).amax(1)
    return lo, hi


def tile_plan(q_pos, k_pos, *, causal: bool, window=None,
              block_k: int = BLOCK_K, block_q: int = BLOCK_Q) -> torch.Tensor:
    """(ceil(Sq/block_q), ceil(Sk/block_k)) int8: for each query tile and
    key tile, SKIP when no (query, key) pair of the two can be visible,
    FULL when every pair is visible and the key tile lies inside Sk, else
    MASKED.  Decided from the tiles' ranges of positions, not from their
    indices, so any positions stay right (a ring cache's rotated ones, its
    empty slots at 2**30); for runs of consecutive positions no tile with a
    visible pair is MASKED needlessly and none without one is visited.

    The CPU copy of the rule that the kernels apply in each block
    (``tile_kind``): ``csrc/flash_attention_sm90.cu`` with key tiles of
    BLOCK_K, ``csrc/flash_attention.cu`` with F32_BLOCK_K (both take
    query tiles of 128 rows); ``csrc/flash_attention_bwd.cu`` at
    BWD_KV_BLOCK_Q by BWD_BLOCK_K (dK/dV) and BWD_BLOCK_Q by BWD_BLOCK_K
    (dQ); ``csrc/flash_attention_bwd_sm90.cu`` at
    sm90_bwd_block_q(D) by SM90_BWD_BLOCK (dK/dV) and SM90_BWD_BLOCK by
    SM90_BWD_BLOCK (dQ).
    Held against the dense mask by the tests; no route calls it."""
    qlo, qhi = _tile_ranges(q_pos, block_q)
    klo, khi = _tile_ranges(k_pos, block_k)
    n_kt = klo.numel()
    inside = torch.arange(1, n_kt + 1, device=k_pos.device) * block_k <= k_pos.numel()
    some = torch.ones((qlo.numel(), n_kt), dtype=torch.bool, device=k_pos.device)
    every = some & inside[None, :]
    if causal:
        some &= klo[None, :] <= qhi[:, None]
        every &= khi[None, :] <= qlo[:, None]
    if window is not None:
        some &= khi[None, :] > qlo[:, None] - window
        every &= klo[None, :] > qhi[:, None] - window
    return (some.to(torch.int8) + every.to(torch.int8)).contiguous()


def _tma_ready(t: torch.Tensor) -> bool:
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and t.shape[-1] % 8 == 0
            and all(s % 8 == 0 for s, n in zip(t.stride()[:3], t.shape[:3]) if n > 1))


def tma_layout(t: torch.Tensor):
    """(tensor, element strides of (B, S, H)) of a (B, S, H, D) bf16 tensor
    as the sm90 kernel's TMA reads it: ``t`` itself when its base is
    16-byte aligned, its strides whole multiples of 16 bytes and D a
    multiple of 8, else a fresh contiguous copy (zero-padded to such a D).
    The stride of a dimension of size 1 is never read; it is given as the
    contiguous one, which TMA takes."""
    d = t.shape[-1]
    if d % 8:
        t = F.pad(t, (0, 8 - d % 8))
    elif not _tma_ready(t):
        t = t.clone(memory_format=torch.contiguous_format)
    b, s, h, dp = t.shape
    dense = (s * h * dp, h * dp, dp)
    strides = tuple(st if n > 1 else c for st, n, c in zip(t.stride()[:3], t.shape[:3],
                                                            dense))
    return t, strides


def _positions(pos, n: int, device) -> torch.Tensor:
    if pos is None:
        return torch.arange(n, dtype=torch.int32, device=device)
    pos = torch.as_tensor(pos, device=device)
    if pos.shape != (n,):
        raise ValueError(f"positions of shape {tuple(pos.shape)}, expected ({n},)")
    return pos.to(torch.int32).contiguous()


def _check_inputs(q, k, v, window, softcap) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} must be (B, S, H, D), k and v alike")
    b, _, h, d = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or hkv < 1 or h % hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: batch and "
                         "head_dim must agree and H be a multiple of Hkv")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"softcap must be None or > 0, got {softcap}")


def _check_card(q, *others) -> None:
    """What both kernels' routes need of tensors on the card."""
    if any(t.dtype != q.dtype for t in others):
        raise TypeError(f"flash_attention takes q, k, v of one dtype, got "
                        f"{[t.dtype for t in (q, *others)]}")
    if any(t.device != q.device for t in others):
        raise ValueError("q, k and v must be on one device")
    b, sq, h, d = q.shape
    sk = others[0].shape[1]
    if d > MAX_HEAD_DIM:
        raise ValueError(f"head_dim {d} > {MAX_HEAD_DIM}")
    if b * h > 65535 or max(sq, sk) >= 2**31 or sk == 0:
        raise ValueError(f"B·H = {b * h} must be <= 65535 and 0 < Sk < 2**31")


def flash_attention(q, k, v, q_pos=None, k_pos=None, *, causal: bool = True,
                    window=None, softcap=None):
    """(B, Sq, H, D) attention of q over k/v (B, Sk, Hkv, D); returns
    (B, Sq, H, D) in q's dtype, differentiable in q, k and v through
    :class:`FlashAttention`.  On DTensors the kernel runs on each rank's
    local shards (:func:`on_local_heads`)."""
    if any(is_dtensor(t) for t in (q, k, v)):
        return on_local_heads(lambda *a: flash_attention(
            *a, causal=causal, window=window, softcap=softcap), q, k, v, q_pos, k_pos)
    _check_inputs(q, k, v, window, softcap)
    q_pos = _positions(q_pos, q.shape[1], q.device)
    k_pos = _positions(k_pos, k.shape[1], q.device)
    # the statistics, which every backward route reads
    stats = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return FlashAttention.apply(q, k, v, q_pos, k_pos, causal, window, softcap, stats)


def on_local_heads(fn, q, k, v, q_pos=None, k_pos=None):
    """``fn(q, k, v, q_pos, k_pos)``, an attention over (B, S, H, D) q and
    (B, S, Hkv, D) k, v, on each rank's local shards of DTensor inputs
    (``launch.sharding.map_local``; autograd goes through the local
    calls): every (batch, head) pair is independent, so the batch (dim 0)
    and the heads (dim 2) stay sharded; a shard of the sequence or head dim
    is gathered first.  k and v take q's layout; where the head shard does
    not divide the KV heads, they stay whole and each rank reads the KV
    heads its query heads map to (GQA), as a slice or, where its query
    heads straddle groups unevenly, one KV head per query head; their
    gradients are then partial sums over the head shards.  Positions are
    whole on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from ..launch.sharding import as_dtensors, map_local

    mesh, (q, k, v) = as_dtensors(q, k, v)
    whole = lambda pos: pos.full_tensor() if is_dtensor(pos) else pos

    # one layout for all three: a mesh dim that shards the batch of q or of
    # k (a decode step's KV cache, the large operand) shards the batch,
    # else one that shards q's heads shards the heads
    def kept(p, dim):
        return isinstance(p, Shard) and p.dim == dim

    q_pl = tuple(Shard(0) if kept(pq, 0) or kept(pk, 0) else
                 Shard(2) if kept(pq, 2) else Replicate()
                 for pq, pk in zip(q.placements, k.placements))
    head_dims = [i for i, p in enumerate(q_pl) if p == Shard(2)]
    head_shards = math.prod(mesh.size(i) for i in head_dims)
    n_rep = q.shape[2] // k.shape[2]
    split_kv = k.shape[2] % head_shards == 0
    kv_pl = q_pl if split_kv else tuple(Replicate() if p == Shard(2) else p
                                        for p in q_pl)
    kv_grad = q_pl if split_kv else tuple(Partial() if p == Shard(2) else p
                                          for p in q_pl)
    q_pos, k_pos = whole(q_pos), whole(k_pos)
    first = 0                       # this rank's first query head
    for i in head_dims:
        first = first * mesh.size(i) + mesh.get_local_rank(i)
    n_local = q.shape[2] // head_shards
    first *= n_local
    # the KV head of each of this rank's query heads; a slice of the KV heads
    # serves when the query heads fall into whole groups of equal size,
    # else each query head takes its own copy of its KV head
    kv_of = [(first + j) // n_rep for j in range(n_local)]
    lo, hi = kv_of[0], kv_of[-1] + 1
    sliced = n_local % (hi - lo) == 0 and all(
        h == lo + j // (n_local // (hi - lo)) for j, h in enumerate(kv_of))

    def local(ql, kl, vl):
        if not split_kv and sliced:
            kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
        elif not split_kv:
            idx = torch.tensor(kv_of, device=kl.device)
            kl, vl = kl.index_select(2, idx), vl.index_select(2, idx)
        return fn(ql, kl, vl, q_pos, k_pos)

    return map_local(local, (q, k, v), (q_pl, kv_pl, kv_pl), q_pl,
                     (q_pl, kv_grad, kv_grad))


class FlashAttention(torch.autograd.Function):
    """Attention whose forward is :func:`flash_attention`'s route and whose
    backward is :func:`flash_attention_bwd`.  It saves q, k, v and the
    positions, and, when ``stats`` (autograd records the call), the
    forward's per-row log-sum-exp and O in float32, which every backward
    route reads (on the float32 route O is the output itself, saved once)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, softcap, stats):
        ctx.options = dict(causal=causal, window=window, softcap=softcap)
        if not stats:
            ctx.save_for_backward(q, k, v, q_pos, k_pos)
            return _forward(q, k, v, q_pos, k_pos, causal, window, softcap)
        out, lse, o32 = _forward(q, k, v, q_pos, k_pos, causal, window, softcap,
                                 stats=True)
        ctx.save_for_backward(q, k, v, q_pos, k_pos, lse, o32)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, k_pos, *stats = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout, q_pos, k_pos,
                                         stats=tuple(stats) or None, **ctx.options)
        return dq, dk, dv, None, None, None, None, None, None


def _forward(q, k, v, q_pos, k_pos, causal, window, softcap, stats: bool = False):
    """The forward's route; with ``stats`` returns ``(out, lse, o)`` as
    :func:`ref.flash_attention_ref` does, except that on the card ``lse``
    is (B, H, Sq rounded up to BLOCK_Q), +inf past Sq: the rows the
    backward kernels read (the plain one takes the first Sq).  On the
    float32 route ``o`` is ``out`` itself."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, q_pos, k_pos, causal=causal,
                                       window=window, softcap=softcap, stats=stats)
    _check_card(q, k, v)
    name = route(q.dtype, q.device)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = o32 = None
    if stats:
        lse = torch.empty((b, h, -(-sq // BLOCK_Q) * BLOCK_Q), dtype=torch.float32,
                          device=q.device)
    if name == "flash_attention":
        if sq:
            _launch_f32(q, k, v, out, q_pos, k_pos, causal, window, softcap, lse)
        return (out, lse, out) if stats else out
    if sk > MAX_SM90_KEYS:
        raise ValueError(f"Sk = {sk}: the bf16 route takes at most {MAX_SM90_KEYS} keys")
    if stats:
        o32 = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    if sq:
        (q, q_st), (k, k_st), (v, v_st) = (tma_layout(t) for t in (q, k, v))
        _build.launch("flash_attention_sm90", q, k, v, out, q_pos, k_pos,
                      *q_st, *k_st, *v_st, b, h, hkv, sq, sk, d, q.shape[-1],
                      int(causal), window or 0, 1.0 / math.sqrt(d),
                      float(softcap or 0.0), lse, o32, 0 if lse is None else lse.shape[-1])
    if stats:
        return out, lse, o32
    return out


def flash_attention_bwd(q, k, v, dout, q_pos=None, k_pos=None, *, causal: bool = True,
                        window=None, softcap=None, stats=None):
    """Gradients (dq, dk, dv) of :func:`flash_attention` at ``dout``
    (B, Sq, H, D), in the inputs' dtypes, by :func:`bwd_route`: the plain
    version for a CPU tensor; on the card one launch of
    ``csrc/flash_attention_bwd.cu`` for float32 (three grids on the tensor
    cores, three TF32 products per float32 product) or of
    ``csrc/flash_attention_bwd_sm90.cu`` for bf16 (three grids on the
    tensor cores, P and dS in two bf16 terms).

    ``stats`` is the forward's ``(lse, o)`` (``_forward(..., stats=True)``,
    which :class:`FlashAttention` saves).  Every route reads it; without it
    a call first runs the forward for it (on the card one launch of the
    dtype's forward kernel, ``flash_attention`` or
    ``flash_attention_sm90``), so a call gives the bits that
    FlashAttention's backward gives."""
    _check_inputs(q, k, v, window, softcap)
    if dout.shape != q.shape:
        raise ValueError(f"dout {tuple(dout.shape)} must have q's shape {tuple(q.shape)}")
    q_pos = _positions(q_pos, q.shape[1], q.device)
    k_pos = _positions(k_pos, k.shape[1], q.device)
    if q.device.type != "cpu":
        _check_card(q, k, v, dout)
    name = bwd_route(q.dtype, q.device)
    if stats is None:
        stats = _forward(q, k, v, q_pos, k_pos, causal, window, softcap, stats=True)[1:]
    if name == "plain":
        return ref.flash_attention_bwd_ref(q, k, v, dout, q_pos, k_pos, causal=causal,
                                           window=window, softcap=softcap, stats=stats)
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sq == 0:
        return (torch.empty_like(q), torch.zeros_like(k), torch.zeros_like(v))
    lse, o32 = stats
    if not (lse.shape == (b, h, -(-sq // BLOCK_Q) * BLOCK_Q) and lse.is_contiguous()
            and lse.dtype == torch.float32 and o32.shape == q.shape
            and o32.dtype == torch.float32):
        raise ValueError("stats: the forward's own, a log-sum-exp (B, H, Sq rounded up "
                         f"to {BLOCK_Q}) float32 contiguous and O {tuple(q.shape)} float32")
    o32 = o32.contiguous()
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    # no-key counts per 64 rows (both kernels' prep blocks)
    nokey = torch.empty((b, h, lse.shape[-1] // 64), dtype=torch.int32, device=q.device)
    if name == "flash_attention_bwd":
        q, k, v, dout = (t.contiguous() for t in (q, k, v, dout))
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        _build.launch("flash_attention_bwd", q, k, v, dout, dq, dk, dv, lse, o32, delta,
                      nokey, q_pos, k_pos, b, h, hkv, sq, sk, d, lse.shape[-1],
                      int(causal), window or 0, 1.0 / math.sqrt(d), float(softcap or 0.0))
        return dq, dk, dv
    return _launch_bwd_sm90(q, k, v, dout, q_pos, k_pos, causal, window, softcap, lse, o32,
                            delta, nokey)


def _launch_bwd_sm90(q, k, v, dout, q_pos, k_pos, causal, window, softcap, lse, o32,
                     delta, nokey):
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if sk > MAX_SM90_KEYS:
        raise ValueError(f"Sk = {sk}: the bf16 route takes at most {MAX_SM90_KEYS} keys")
    smem = sm90_bwd_smem_bytes(d, sq, sk)
    tiles = (-(-sq // BLOCK_Q) * BLOCK_Q // SM90_BWD_BLOCK, -(-sk // SM90_BWD_BLOCK))
    if max(smem) > SMEM_LIMIT or max(tiles) > 65535:
        raise ValueError(f"Sq = {sq}, Sk = {sk}: past the bf16 backward's limits (its "
                         f"plans take {smem} B of shared memory, at most {SMEM_LIMIT}; "
                         f"{tiles} tiles of 64 rows, at most 65535 each)")
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, sk, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty_like(dk)
    (q, q_st), (k, k_st), (v, v_st), (dout, do_st) = (tma_layout(t)
                                                      for t in (q, k, v, dout))
    _build.launch("flash_attention_bwd_sm90", q, k, v, dout, dq, dk, dv, lse, o32, delta,
                  nokey, q_pos, k_pos, *q_st, *k_st, *v_st, *do_st, b, h, hkv, sq, sk, d,
                  q.shape[-1], lse.shape[-1], int(causal), window or 0,
                  1.0 / math.sqrt(d), float(softcap or 0.0))
    return dq, dk, dv


def _launch_f32(q, k, v, out, q_pos, k_pos, causal, window, softcap, lse=None) -> None:
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    _build.launch("flash_attention", q, k, v, out, q_pos, k_pos,
                  *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                  q.shape[0], q.shape[2], k.shape[2], q.shape[1], k.shape[1],
                  q.shape[3], int(causal), window or 0, 1.0 / math.sqrt(q.shape[3]),
                  float(softcap or 0.0), int(all(vec_ready(t) for t in (q, k, v))),
                  lse, 0 if lse is None else lse.shape[-1])
