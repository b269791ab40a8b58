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
checkpoint.

Sharded state: ``save`` takes DTensor leaves (each gathered whole, a
collective, so every rank of their mesh calls ``save``; rank 0 of the
default process group writes, and ``save`` returns on every rank once
the files are in place) and, with ``specs=``, records them in the
meta as ``"specs"``, by leaf name with ``str(spec)``, as the JAX package
writes them.  ``restore(mesh=, specs=)`` places each leaf on the mesh under
its spec (``launch.sharding.distribute``, JAX's ``device_put``).
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.pytree import tree_flatten_with_names, tree_map, tree_unflatten
from ..device import is_dtensor


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if is_dtensor(t):
            t = t.full_tensor()
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
    names, leaves = tree_flatten_with_names(tree)
    # a tree of DTensors is saved by every rank of its mesh together: each
    # leaf is gathered whole, rank 0 writes, and no rank returns before the
    # files are in place (the barrier is the commit point)
    sharded = any(is_dtensor(leaf) for leaf in leaves)
    arrays = {f"a{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    if not sharded or dist.get_rank() == 0:
        _write(path, arrays, names, leaves, specs, step, extra)
    if sharded:
        dist.barrier()


def _write(path, arrays, names, leaves, specs, step, extra) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)) or ".", exist_ok=True)
    _write_atomic(path + ".npz", lambda f: np.savez(f, **arrays))
    meta = {"names": names, "step": step,
            "dtypes": [_dtype_name(leaf) for leaf in leaves],
            "checksum": _sha256(path + ".npz")}
    if extra is not None:
        meta["extra"] = extra
    if specs is not None:
        meta["specs"] = spec_strings(specs)
    _write_atomic(path + ".meta.json",
                  lambda f: f.write(json.dumps(meta).encode()))


def spec_strings(specs) -> dict:
    """``{leaf name: str(spec)}`` as the JAX package records specs: a
    PartitionSpec, and any tuple, list or NamedTuple holding specs (as JAX
    sees them: nodes with an ``index`` method), is one leaf; dicts nest."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        else:
            out[path] = str(node)

    walk(specs, "")
    return out


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
    device and dtype (a DTensor's local device); with ``mesh`` and
    ``specs`` (a PartitionSpec tree like ``like``), each leaf then lands
    on the mesh as a DTensor under its spec.

    Refuses a checksum mismatch (use :func:`latest_valid_step` to fall
    back to the newest intact checkpoint) and a shape mismatch."""
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
    tree = tree_unflatten(like, restored)
    if mesh is not None and specs is not None:
        from ..launch.sharding import distribute
        tree = tree_map(lambda x, sp: distribute(x, mesh, sp), tree, specs)
    return tree


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
