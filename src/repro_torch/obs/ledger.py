"""Run ledger: fold obs traces into an append-only cross-run record.

Counterpart of ``repro.obs.ledger``, entry for entry: for the same trace
records both packages build the same entry and the same ``run_id``.  A
ledger is a JSONL file (default ``runs/ledger.jsonl``; ``.gz`` ok) with
one record per ingested run:

    {"kind": "run", "ledger_schema": 1, "run_id": "…12 hex…",
     "git_sha": "…", "scenario": …, "algorithm": …, "compressor": …,
     "channel": …, "mode": …, "meta": {…header extras…},
     "final": {"e_K": …, "bytes_up": …, "rounds": …, …},
     "series": {"e_K": {"steps": […], "values": […]}, …}}

``run_id`` is a content hash (sha1 over the canonical JSON of meta +
final + series), so ingest is idempotent (re-ingesting the same trace
appends nothing) and the same run gets the same id on any machine.

The descriptive fields (scenario/algorithm/compressor/channel/mode) come
from the trace header's meta, which :class:`repro_torch.api.Experiment`
stamps; keyword args at ingest (``python -m repro_torch.obs ingest
--meta k=v``) override them.  :mod:`repro_torch.obs.report` renders
ledgers and gates convergence curves.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
from typing import List, Optional, Sequence, Tuple, Union

from .summary import summarize_dict
from .trace import _open, load

LEDGER_SCHEMA = 1
DEFAULT_LEDGER = os.path.join("runs", "ledger.jsonl")

# header-meta keys promoted to top-level ledger fields
_PROMOTED = ("scenario", "algorithm", "compressor", "channel", "mode",
             "topology", "faults")


def git_sha() -> str:
    """The current commit (``REPRO_GIT_SHA`` env override for CI /
    detached checkouts; ``unknown`` outside a git repo)."""
    sha = os.environ.get("REPRO_GIT_SHA")
    if sha:
        return sha
    try:
        return subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
            check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def run_id(entry: dict) -> str:
    """Deterministic 12-hex content hash over meta + final + series."""
    core = {k: entry.get(k) for k in
            _PROMOTED + ("meta", "final", "series")}
    blob = json.dumps(core, sort_keys=True, separators=(",", ":"),
                      allow_nan=False)
    return hashlib.sha1(blob.encode()).hexdigest()[:12]


def entry_from_records(records: Sequence[dict], *,
                       sha: Optional[str] = None, **meta_overrides) -> dict:
    """Build one ledger entry from a trace's record list."""
    s = summarize_dict(records)
    meta = dict(s["meta"])
    meta.update({k: v for k, v in meta_overrides.items() if v is not None})
    entry = {"kind": "run", "ledger_schema": LEDGER_SCHEMA,
             "trace_schema": s["schema"]}
    for key in _PROMOTED:
        entry[key] = meta.pop(key, None)
    if entry["mode"] is None:
        entry["mode"] = s["final"].get("mode")
    entry["meta"] = meta
    entry["final"] = {k: v for k, v in s["final"].items() if k != "mode"}
    entry["series"] = s["series"]
    entry["run_id"] = run_id(entry)
    entry["git_sha"] = sha if sha is not None else git_sha()
    return entry


def load_ledger(path: str) -> List[dict]:
    """Read a ledger file into its run-entry list (missing file → [])."""
    if not os.path.exists(path):
        return []
    out = []
    with _open(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return [e for e in out if e.get("kind") == "run"]


def append_entry(entry: dict, path: str) -> None:
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with _open(path, "at") as f:
        f.write(json.dumps(entry, sort_keys=True, allow_nan=False) + "\n")


def ingest(trace: Union[str, Sequence[dict]],
           ledger_path: str = DEFAULT_LEDGER, *,
           sha: Optional[str] = None,
           **meta_overrides) -> Tuple[dict, bool]:
    """Fold one trace (path or record list) into the ledger.

    Returns ``(entry, appended)`` — ``appended=False`` when a run with
    the identical content hash is already present (idempotent
    re-ingest)."""
    records = load(trace) if isinstance(trace, str) else trace
    entry = entry_from_records(records, sha=sha, **meta_overrides)
    existing = {e["run_id"] for e in load_ledger(ledger_path)}
    if entry["run_id"] in existing:
        return entry, False
    append_entry(entry, ledger_path)
    return entry, True
