"""Checkpointing: a tree of tensors ⇄ npz, in the JAX package's format.

Counterpart of ``repro.checkpoint.store``, with the same files, so a
checkpoint that either package saves restores in the other:

* ``<path>.npz``: arrays ``a0 … aN`` in leaf order (dict keys sorted, as
  JAX's pytrees visit them);
* ``<path>.meta.json``: ``names`` (each leaf's path as
  ``jax.tree_util.keystr`` spells it), ``step``, ``dtypes``, ``checksum``
  (sha256 of the npz) and, when given, ``extra``.

bf16 leaves are stored as float32 (exact), their dtype recorded.  A
Python ``int`` leaf, such as the port's round counter ``k``, is stored as
the 0-d ``int32`` array that the JAX package keeps in its place; restored
into a template that holds an ``int`` there, it comes back an ``int``.

Writes are crash-safe: each file goes to a temporary name, is flushed and
``fsync``-ed, and lands with ``os.replace``; the meta sidecar, which
holds the npz's checksum, is written last and so is the commit point.
:func:`verify` and :func:`latest_valid_step` reject a torn or corrupt
checkpoint.  Sharded saves and restores (``specs=``, ``mesh=``) are not
ported.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch

from ..core.pytree import tree_flatten_with_names, tree_unflatten

_NO_SHARDING = ("sharded checkpoints (specs=, mesh=) need the port's launch/ "
                "(mesh.py, sharding.py), not ported yet: ROADMAP Queue 1, "
                "the launch/ item")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.cpu().numpy()
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32)      # JAX keeps k as a 0-d int32
    return np.asarray(leaf)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    return str(_to_numpy(leaf).dtype)


def _write_atomic(path: str, write) -> None:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        write(f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def save(path: str, tree, specs=None, step: Optional[int] = None,
         extra: Optional[dict] = None) -> None:
    """Write ``tree`` to ``<path>.npz`` (+ ``<path>.meta.json``), atomically.

    ``extra`` is an optional JSON-safe dict stored in the meta sidecar
    under ``"extra"``: run state such as time cursors and byte
    accumulators (see :class:`repro_torch.checkpoint.run.RunCheckpoint`).
    """
    if specs is not None:
        raise NotImplementedError(_NO_SHARDING)
    names, leaves = tree_flatten_with_names(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    arrays = {f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    _write_atomic(path + ".npz", lambda f: np.savez(f, **arrays))
    meta = {"names": names, "step": step,
            "dtypes": [_dtype_name(leaf) for leaf in leaves],
            "checksum": _sha256(path + ".npz")}
    if extra is not None:
        meta["extra"] = extra
    _write_atomic(path + ".meta.json",
                  lambda f: f.write(json.dumps(meta).encode()))


def load_meta(path: str) -> Optional[dict]:
    """The meta sidecar of one checkpoint, or None if absent/unparsable."""
    try:
        with open(path + ".meta.json") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def verify(path: str) -> bool:
    """True when the checkpoint at ``path`` is complete and uncorrupted:
    both files exist, the meta parses, and the npz matches its recorded
    checksum (a meta without ``"checksum"`` passes when both files exist)."""
    meta = load_meta(path)
    if meta is None or not os.path.exists(path + ".npz"):
        return False
    want = meta.get("checksum")
    return want is None or _sha256(path + ".npz") == want


def _restore_leaf(arr: np.ndarray, like):
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(arr)).to(device=like.device,
                                                  dtype=like.dtype)
    if isinstance(like, int) and not isinstance(like, bool):
        return int(arr)
    return np.asarray(arr, dtype=np.asarray(like).dtype)


def restore(path: str, like, mesh=None, specs=None):
    """Restore into the structure of ``like``, each leaf on ``like``'s
    device and dtype.

    Refuses a checksum mismatch (use :func:`latest_valid_step` to fall
    back to the newest intact checkpoint) and a shape mismatch."""
    if mesh is not None or specs is not None:
        raise NotImplementedError(_NO_SHARDING)
    meta = load_meta(path)
    if meta is not None and meta.get("checksum") is not None \
            and _sha256(path + ".npz") != meta["checksum"]:
        raise ValueError(f"corrupt checkpoint (checksum mismatch): {path}")
    names, leaves = tree_flatten_with_names(like)
    restored = []
    with np.load(path + ".npz") as data:
        for i, (name, leaf) in enumerate(zip(names, leaves)):
            arr = data[f"a{i}"]
            shape = tuple(leaf.shape) if hasattr(leaf, "shape") else ()
            if arr.shape != shape:
                raise ValueError(f"shape mismatch for {name}: "
                                 f"{arr.shape} vs {shape}")
            restored.append(_restore_leaf(arr, leaf))
    return tree_unflatten(like, restored)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = []
    for f in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        if f.endswith(".meta.json"):
            meta = load_meta(os.path.join(ckpt_dir, f)[:-len(".meta.json")])
            if meta is not None and meta.get("step") is not None:
                steps.append(meta["step"])
    return max(steps) if steps else None


def latest_valid_step(ckpt_dir: str, prefix: str = "") -> Optional[int]:
    """Newest step in ``ckpt_dir`` whose checkpoint passes :func:`verify`:
    corrupt or half-written checkpoints are skipped."""
    best = None
    for f in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        if not (f.startswith(prefix) and f.endswith(".meta.json")):
            continue
        base = os.path.join(ckpt_dir, f)[:-len(".meta.json")]
        meta = load_meta(base)
        if meta is None or meta.get("step") is None:
            continue
        if (best is None or meta["step"] > best) and verify(base):
            best = meta["step"]
    return best
