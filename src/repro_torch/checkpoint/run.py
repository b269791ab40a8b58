"""Crash-consistent run recovery: per-round checkpoints of a sync run.

Counterpart of ``repro.checkpoint.run``, writing the same files.  One
:class:`RunCheckpoint` wraps a directory of atomic per-round checkpoints
(:mod:`repro_torch.checkpoint.store`): the algorithm state tree plus the
run state that makes continuation bit-identical: the round index, the
engine time cursor, the byte accumulators, and the RoundLog prefix.
Engine rounds are pure functions of ``(scenario, seed, t0)`` and round
k's generator seed depends only on the run's seed and k
(:func:`repro_torch.core.fedlt_sat.round_seeds`), so restoring exactly
this tuple and resuming at round ``k`` reproduces the uninterrupted run
bit for bit.

Recovery is corruption-aware: a writer killed mid-save leaves a
checkpoint that fails its checksum, and :meth:`load` silently falls back
to the newest *intact* round.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

from .store import latest_valid_step, load_meta, restore, save

_PREFIX = "round_"


class RunCheckpoint:
    """Per-round checkpoint directory for a :class:`SpaceRunner` sync run."""

    def __init__(self, ckpt_dir: str, keep_last: int = 3):
        self.ckpt_dir = str(ckpt_dir)
        self.keep_last = int(keep_last)

    def _base(self, step: int) -> str:
        return os.path.join(self.ckpt_dir, f"{_PREFIX}{step:06d}")

    def save_round(self, state, *, step: int, t: float, up_bytes: float,
                   isl_bytes: float, logs) -> None:
        """Checkpoint the state after round ``step - 1`` (resume at
        ``step``).  Older rounds beyond ``keep_last`` are pruned AFTER
        the new checkpoint has landed atomically."""
        extra = dict(k_next=int(step), t=float(t),
                     up_bytes=float(up_bytes), isl_bytes=float(isl_bytes),
                     logs=[dataclasses.asdict(lg) for lg in logs])
        save(self._base(step), state, step=step, extra=extra)
        if self.keep_last > 0:
            self._prune(step)

    def _prune(self, newest: int) -> None:
        for f in os.listdir(self.ckpt_dir):
            if not (f.startswith(_PREFIX) and f.endswith(".meta.json")):
                continue
            try:
                step = int(f[len(_PREFIX):-len(".meta.json")])
            except ValueError:
                continue
            if step <= newest - self.keep_last:
                for ext in (".meta.json", ".npz"):
                    try:
                        os.remove(os.path.join(
                            self.ckpt_dir, f"{_PREFIX}{step:06d}{ext}"))
                    except OSError:
                        pass

    def load(self, like) -> Optional[Tuple[object, dict]]:
        """Newest intact checkpoint as ``(state, run_meta)``, or None.

        ``run_meta`` holds ``k_next`` / ``t`` / ``up_bytes`` /
        ``isl_bytes`` / ``logs`` as saved by :meth:`save_round`; corrupt
        or half-written rounds are skipped via the store's checksums."""
        if not os.path.isdir(self.ckpt_dir):
            return None
        step = latest_valid_step(self.ckpt_dir, prefix=_PREFIX)
        if step is None:
            return None
        base = self._base(step)
        state = restore(base, like)
        meta = load_meta(base) or {}
        return state, meta.get("extra", {})
