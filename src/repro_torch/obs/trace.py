"""Structured tracer: typed event records with a zero-cost disabled path.

One :class:`Tracer` is active at a time (module global ``TRACER``); hot
paths read it ONCE per round into a local and branch on ``None`` — the
entire disabled-mode cost is that attribute read, which is why the
``sim.trace_overhead`` bench can show tracing-disabled rounds at parity
with the pre-instrumentation engine (the existing ``sim.fast_round``
gates double as the disabled-overhead regression gate: they time the
instrumented engine with the tracer off against the committed baseline).

Events are plain dicts with a ``kind`` field, buffered in memory and
flushed as JSONL (first record is a schema header, last is the
:class:`~repro_torch.obs.metrics.Metrics` snapshot).  Paths ending in ``.gz``
are gzip-compressed transparently, on write and on :func:`load` — the
mega-1000 traces CI uploads shrink ~20x.  Two clocks coexist:

* **sim time** — event fields named ``t``/``t0``/``t_done`` carry
  simulated seconds (the engine's clock);
* **host time** — :meth:`Tracer.span` records wall-clock begin/duration
  (``t_host``/``dur_host`` seconds since tracer start) for stage timings
  (uplink encode, aggregation, kernel dispatches).

Event kinds emitted by the instrumented stack:

    ``round``      one engine sync round (t0, duration, counts, air bytes)
    ``delivery``   one :class:`repro_torch.sim.engine.Delivery` (``to_dict``)
    ``arq``        a delivery that needed retransmissions or was lost
    ``cohort``     one contact-window delivery cohort
    ``async_run``  summary of one ``Engine.run_async`` stream
    ``fl_round``   one federated round (SpaceRunner: bytes, error, staleness)
    ``ef_revert``  loss-robust EF revert (lost sats + residual norm)
    ``ef_resync``  crash residual re-sync (crashed sats rebooted with an
                   empty EF cache — see :mod:`repro_torch.faults`)
    ``fault``      one injected fault (sat crash, per :mod:`repro_torch.faults`)
    ``head_failover``  a cluster-head failure mid-convergecast: salvage
                   counts + the re-elected head (``repro_torch.sim.topology``)
    ``resume``     a crash-consistent restart from a run checkpoint
                   (:mod:`repro.checkpoint.run`)
    ``kernel``     one kernel-dispatch span (repro_torch.kernels.ops)
    ``span``       generic host-time stage span
    ``link``       channel link-budget sample (elevation, fade, p_seg)
    ``outage``     blocked-window refresh summary per station
    ``series``     one (name, step, value) time-series sample — the
                   per-round convergence/byte curves the run ledger
                   (:mod:`repro.obs.ledger`) folds into cross-run tables
                   and the ``convgate`` CI gate compares (schema v2)
    ``phase``      per-(round, phase-path) wall-time rollup and
    ``phase_total``  the round's measured wall — the phase-attribution
                   profiler (:mod:`repro_torch.obs.prof`); host timing, so
                   neither is a trace-diff kind

``trace-diff`` (:mod:`repro.obs.summary`) compares the deterministic
sim-schema kinds (round/delivery/arq/cohort) and ignores host-timing
fields, so fast-vs-oracle engine traces diff clean whenever the Delivery
timelines agree — and localize the FIRST diverging record when they
don't.

Two buffering modes:

* the default buffers every record in memory until :meth:`flush` /
  :meth:`close` rewrites the whole file — what short runs and the
  overhead bench use (no I/O inside the timed region);
* ``stream_every=N`` appends to the file every N buffered records and
  drops them from memory, so week-long async mega runs trace with
  bounded memory; the header goes out first, the metrics snapshot last
  (on :meth:`close`), exactly like the buffered layout, and
  ``repro.obs watch`` tails the growing file from a separate process.
"""
from __future__ import annotations

import contextlib
import gzip
import json
import time
from typing import IO, List, Optional

from .metrics import Metrics
from .prof import PhaseAcc

# v1: header/event/metrics records.  v2 adds the ``series`` record kind
# (additive — every v1 record reads unchanged; `tests/data/
# trace_schema_v1.jsonl` pins the compatibility).
SCHEMA_VERSION = 2

# the active tracer; hot paths read this once per round via active()
TRACER: Optional["Tracer"] = None
_STACK: List["Tracer"] = []

# host-timing fields trace-diff must ignore (nondeterministic wall clock)
HOST_FIELDS = ("t_host", "dur_host")


def _open(path: str, mode: str) -> IO:
    """Open a trace path, gzip-compressed when it ends in ``.gz``."""
    if path.endswith(".gz"):
        return gzip.open(path, mode if mode.endswith("t") else mode + "t")
    return open(path, mode)


class Tracer:
    """In-memory event buffer + metrics registry with JSONL flush.

    ``path=None`` keeps everything in memory (tests, overhead benches);
    a path writes JSONL on :meth:`flush` / :meth:`close` (gzip when it
    ends in ``.gz``).  ``stream_every=N`` switches to incremental
    appends: every N records the buffer is written out and cleared, so
    memory stays bounded on long runs (``records()`` then only covers
    the not-yet-flushed tail).
    """

    __slots__ = ("events", "metrics", "prof", "path", "meta",
                 "stream_every", "_t0_host", "_closed", "_fh",
                 "_n_streamed")

    def __init__(self, path: Optional[str] = None,
                 stream_every: Optional[int] = None, **meta):
        if stream_every is not None and path is None:
            raise ValueError("stream_every needs a path to append to")
        self.events: List[dict] = []
        self.metrics = Metrics()
        # phase-attribution accumulator (repro_torch.obs.prof); the engines
        # read it once per round alongside active().  prof_sync=True in
        # the meta also times a torch.cuda.synchronize() after each kernel
        # dispatch (the host/device split; it changes timing, not results,
        # so keep it out of gated benches)
        self.prof = PhaseAcc(sync_device=bool(meta.get("prof_sync")))
        self.path = path
        self.meta = meta
        self.stream_every = stream_every
        self._t0_host = time.perf_counter()
        self._closed = False
        self._fh: Optional[IO] = None
        self._n_streamed = 0

    # -- emission ----------------------------------------------------------
    def event(self, kind: str, **fields) -> None:
        """Record one typed event (fields must be JSON-serializable)."""
        fields["kind"] = kind
        self.events.append(fields)
        if self.stream_every and len(self.events) >= self.stream_every:
            self._stream_out()

    def raw(self, record: dict) -> None:
        """Record a pre-built event dict (must carry ``kind``)."""
        self.events.append(record)
        if self.stream_every and len(self.events) >= self.stream_every:
            self._stream_out()

    def series(self, name: str, step: int, value: float, **labels) -> None:
        """Record one time-series sample: ``(name, step, value)``.

        The per-round curves (``e_K``, ``bytes_up``, ``ef_resid_norm``,
        ``staleness``, …) are emitted through here; the ledger
        (:mod:`repro.obs.ledger`) groups samples by name into
        step-ordered curves for cross-run comparison and the
        convergence gate."""
        rec = {"kind": "series", "name": name, "step": int(step),
               "value": float(value)}
        if labels:
            rec.update(labels)
        self.events.append(rec)
        if self.stream_every and len(self.events) >= self.stream_every:
            self._stream_out()

    def host_now(self) -> float:
        return time.perf_counter() - self._t0_host

    @contextlib.contextmanager
    def span(self, kind: str, **fields):
        """Host-time stage span: records begin + duration on exit."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            fields["kind"] = kind
            fields["t_host"] = t0 - self._t0_host
            fields["dur_host"] = time.perf_counter() - t0
            self.raw(fields)

    # -- output ------------------------------------------------------------
    def _header(self) -> dict:
        header = {"kind": "header", "schema": SCHEMA_VERSION}
        if self.stream_every:
            header["streamed"] = True       # n_events unknown up front
        else:
            header["n_events"] = len(self.events)
        header.update(self.meta)
        return header

    def _metrics_record(self) -> Optional[dict]:
        m = self.metrics.to_dict()
        if m["counters"] or m["histograms"]:
            return {"kind": "metrics", **m}
        return None

    def records(self) -> List[dict]:
        """Header + buffered events + metrics snapshot — what
        :meth:`flush` writes, and what :mod:`repro.obs.summary` consumes
        directly in-memory.  In streaming mode this only covers the
        not-yet-flushed tail; use :func:`load` on the closed file for
        the full record stream."""
        out = [self._header()]
        out.extend(self.events)
        m = self._metrics_record()
        if m is not None:
            out.append(m)
        return out

    def _stream_out(self) -> None:
        """Append the buffered events to the file and drop them (the
        bounded-memory path; header goes out first, exactly once)."""
        if self._fh is None:
            self._fh = _open(self.path, "wt")
            self._fh.write(json.dumps(self._header(), sort_keys=True,
                                      allow_nan=False) + "\n")
        for rec in self.events:
            self._fh.write(json.dumps(rec, sort_keys=True,
                                      allow_nan=False) + "\n")
        self._n_streamed += len(self.events)
        self.events.clear()

    def flush(self) -> Optional[str]:
        """Write the JSONL file (no-op without a path); returns the path.

        Buffered mode rewrites the whole file; streaming mode appends
        whatever is pending and flushes the handle (the metrics snapshot
        is only written by :meth:`close`)."""
        if self.path is None:
            return None
        if self.stream_every:
            self._stream_out()
            self._fh.flush()
            return self.path
        with _open(self.path, "wt") as f:
            for rec in self.records():
                f.write(json.dumps(rec, sort_keys=True,
                                   allow_nan=False) + "\n")
        return self.path

    def close(self) -> Optional[str]:
        if self._closed:
            return self.path
        self._closed = True
        if self.stream_every and self.path is not None:
            self._stream_out()
            m = self._metrics_record()
            if m is not None:
                self._fh.write(json.dumps(m, sort_keys=True,
                                          allow_nan=False) + "\n")
            self._fh.close()
            self._fh = None
            return self.path
        return self.flush()


def active() -> Optional[Tracer]:
    """The active tracer, or None (read once per round, not per event)."""
    return TRACER


def enable(path: Optional[str] = None,
           stream_every: Optional[int] = None, **meta) -> Tracer:
    """Install a fresh tracer as the active one (stackable: ``disable``
    restores whatever was active before)."""
    global TRACER
    t = Tracer(path, stream_every=stream_every, **meta)
    _STACK.append(t)
    TRACER = t
    return t


def disable() -> Optional[Tracer]:
    """Close the active tracer (flushing to its path, if any) and restore
    the previously active one.  Returns the closed tracer."""
    global TRACER
    if not _STACK:
        return None
    t = _STACK.pop()
    t.close()
    TRACER = _STACK[-1] if _STACK else None
    return t


@contextlib.contextmanager
def tracing(path: Optional[str] = None,
            stream_every: Optional[int] = None, **meta):
    """``with tracing("run.jsonl") as trc: ...`` — enable/flush scoped."""
    t = enable(path, stream_every=stream_every, **meta)
    try:
        yield t
    finally:
        disable()


def load(path: str) -> List[dict]:
    """Read a JSONL trace file back into a record list (``.gz`` ok).

    Tolerates a truncated FINAL line — the signature a streaming writer
    leaves when its process is killed mid-append: the valid prefix is
    returned with a :class:`UserWarning` instead of raising
    ``JSONDecodeError``, so ``summarize`` / ``watch`` / ``ingest`` can
    still read everything the run managed to record.  A malformed line
    anywhere *before* the last one is real corruption and still raises."""
    records = []
    with _open(path, "rt") as f:
        lines = [ln for ln in (ln.strip() for ln in f) if ln]
    for i, line in enumerate(lines):
        try:
            records.append(json.loads(line))
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                import warnings
                warnings.warn(
                    f"{path}: truncated final record dropped (writer "
                    f"killed mid-append?) — recovered {len(records)} "
                    f"records", stacklevel=2)
                break
            raise
    return records
