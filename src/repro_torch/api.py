"""The experiment facade: ``repro_torch.api.Experiment``.

Counterpart of ``repro.api``.  One object resolves the scenario (by
registry name or instance), applies a ``topology`` override, builds the
port's engine (or reuses a caller-supplied one, so a sweep shares contact
plans and cached ARQ plans across arms), installs the channel through
:meth:`repro_torch.sim.engine.Engine.install_channel`, and wires tracing
with self-describing meta::

    from repro_torch.api import Experiment

    exp = Experiment.from_scenario("walker-kiruna", algorithm=alg,
                                   compressor=quant, measure="cohort")
    state = exp.init(torch.zeros(dim), n_agents)   # on exp.device
    result = exp.run(state, data, n_rounds=120, seed=2,
                     error_fn=err, trace=True)
    result.ingest("runs/ledger.jsonl")

The algorithm's state lives on ``exp.device``: the card unless
``device="cpu"`` is passed, and without a card construction raises.
``run(ledger=...)`` traces the run and folds it into a run ledger
(:mod:`repro_torch.obs.ledger`); ``run(checkpoint="dir")`` checkpoints
it per round (:mod:`repro_torch.checkpoint.run`) and ``resume=True``
continues from the newest intact checkpoint, bit for bit as the
uninterrupted run.  Both write the JAX package's formats.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Union

import torch

from .core.fedlt_sat import RoundLog, SpaceRunner
from .core.pytree import tree_map
from .device import resolve_device
from .faults import describe_faults
from .sim import Engine, Scenario, get_scenario, make_topology


def describe_compressor(c) -> str:
    """Short ledger label for a compressor (``quant10``, ``topk0.1``,
    ``rand0.2``, class name fallback, ``none``)."""
    if c is None:
        return "none"
    name = type(c).__name__
    if name == "UniformQuantizer":
        return f"quant{c.levels}"
    if name == "TopK":
        return f"topk{c.fraction:g}"
    if name == "RandD":
        return f"rand{c.fraction:g}"
    if name == "Identity":
        return "identity"
    return name


def describe_channel(ch) -> str:
    """Short ledger label for a channel (``lossless``, ``flat-0.1``,
    ``budget``)."""
    if ch is None:
        return "lossless"
    if getattr(ch, "budget", None) is not None:
        return "budget"
    return f"flat-{getattr(ch, 'loss', '?')}"


@dataclasses.dataclass
class ExperimentResult:
    """What one :meth:`Experiment.run` produced: the final algorithm
    state, the per-round logs, and (when tracing was on) the trace
    records plus the ledger id if they were ingested."""
    state: Any
    logs: List[RoundLog]
    records: Optional[List[dict]] = None
    run_id: Optional[str] = None

    @property
    def final(self) -> Optional[RoundLog]:
        return self.logs[-1] if self.logs else None

    def ingest(self, ledger_path: str) -> dict:
        """Fold this run's trace into a ledger; returns the entry."""
        if self.records is None:
            raise ValueError(
                "no trace records to ingest — call run(..., trace=True) "
                "(or pass ledger=... to run, which implies it)")
        from .obs.ledger import ingest as _ingest
        entry, _ = _ingest(self.records, ledger_path)
        self.run_id = entry["run_id"]
        return entry


class Experiment:
    """A configured (scenario × algorithm × compression × channel ×
    topology × mode) federated experiment.  See the module docstring."""

    def __init__(self, scenario: Union[str, Scenario, None], algorithm, *,
                 compressor=None, channel=None,
                 topology: Optional[object] = None,
                 mode: str = "sync", measure: str = "probe",
                 loss_robust: bool = True, buffer_size: int = 8,
                 staleness_alpha: float = 0.5, wire_bits: float = 32.0,
                 seed: int = 0, fast: bool = True,
                 faults: Optional[object] = None,
                 deadline: Optional[float] = None, quorum: float = 0.0,
                 engine: Optional[Engine] = None,
                 meta: Optional[Dict[str, Any]] = None,
                 device=None):
        self.device = resolve_device(device)
        if engine is not None:
            # shared-engine sweeps: the engine's scenario wins; a
            # conflicting topology request would silently not apply
            scenario = engine.scenario
            if (topology is not None
                    and make_topology(topology) != engine.topology):
                raise ValueError(
                    f"engine= carries topology "
                    f"{engine.topology.name!r} but topology="
                    f"{make_topology(topology).name!r} was requested — "
                    f"build the engine from the right scenario instead")
        else:
            if scenario is None:
                raise ValueError("pass a scenario (name or Scenario) or "
                                 "a prebuilt engine=")
            if isinstance(scenario, str):
                scenario = get_scenario(scenario)
            if topology is not None:
                scenario = dataclasses.replace(scenario, topology=topology)
            engine = Engine(scenario, seed=seed, fast=fast)
        self.scenario = scenario
        self.algorithm = algorithm
        self.meta = dict(meta or {})
        self.runner = SpaceRunner(
            engine, compressor=compressor, channel=channel, mode=mode,
            measure=measure, loss_robust=loss_robust,
            buffer_size=buffer_size, staleness_alpha=staleness_alpha,
            wire_bits=wire_bits, faults=faults, deadline=deadline,
            quorum=quorum)

    @classmethod
    def from_scenario(cls, name: Union[str, Scenario], *, algorithm,
                      **kwargs) -> "Experiment":
        """The canonical constructor spelling:
        ``Experiment.from_scenario("mega-1000", algorithm=alg, ...)``."""
        return cls(name, algorithm, **kwargs)

    # -- convenience delegation -------------------------------------------
    @property
    def engine(self) -> Engine:
        return self.runner.engine

    @property
    def topology_name(self) -> str:
        return self.engine.topology.name

    def init(self, x0, n_agents: int):
        """The algorithm's initial state, with ``x0`` moved to
        :attr:`device`."""
        x0 = tree_map(lambda a: torch.as_tensor(a).to(self.device), x0)
        return self.algorithm.init(x0, n_agents)

    def ledger_meta(self) -> Dict[str, Any]:
        """The self-describing trace meta this experiment stamps on its
        runs (caller ``meta=`` entries win)."""
        out = dict(scenario=self.scenario.name,
                   algorithm=type(self.algorithm).__name__,
                   compressor=describe_compressor(self.runner.compressor),
                   channel=describe_channel(
                       self.runner.channel
                       if self.runner.channel is not None
                       else getattr(self.engine, "channel", None)),
                   topology=self.topology_name,
                   mode=self.runner.mode,
                   faults=describe_faults(
                       getattr(self.engine, "faults", None)
                       or self.runner.faults))
        if self.runner.deadline is not None:
            out["deadline"] = self.runner.deadline
            out["quorum"] = self.runner.quorum
        out.update(self.meta)
        return out

    def run(self, state, data, n_rounds: int, seed: int = 0, *,
            error_fn: Optional[Callable] = None, log_every: int = 10,
            trace: Union[bool, str] = False,
            ledger: Optional[str] = None,
            checkpoint: Optional[str] = None, checkpoint_every: int = 1,
            resume: bool = False) -> ExperimentResult:
        """Drive the algorithm ``n_rounds`` through the engine.

        ``data`` goes to :attr:`device`; ``seed`` seeds the generators of
        the algorithm's stochastic compressors, one per round.
        ``trace=True`` records an in-memory obs trace (``trace="path"``
        streams it to a file as well); ``ledger="runs/x.jsonl"`` implies
        tracing and ingests the finished trace.  ``checkpoint="dir"``
        saves an atomic per-round checkpoint every ``checkpoint_every``
        sync rounds; ``resume=True`` restarts from the newest intact one,
        and the resumed run's state and ``e_K`` / ``bytes_up`` curves are
        bit for bit the uninterrupted run's.  Returns an
        :class:`ExperimentResult`."""
        from .obs import active as _active
        from .obs import tracing
        ckpt = None
        if checkpoint is not None:
            from .checkpoint.run import RunCheckpoint
            ckpt = RunCheckpoint(checkpoint)
        elif resume:
            raise ValueError("resume=True needs checkpoint=<dir>")
        if not trace and ledger is not None:
            trace = True
        data = tree_map(lambda a: torch.as_tensor(a).to(self.device), data)
        run_kw = dict(error_fn=error_fn, log_every=log_every, ckpt=ckpt,
                      ckpt_every=checkpoint_every, resume=resume)
        if not trace or _active() is not None:
            # no tracing requested, or the caller already opened a tracer
            # (nested tracing() scopes don't stack): run under it as-is
            state, logs = self.runner.run(self.algorithm, state, data,
                                          n_rounds, seed, **run_kw)
            return ExperimentResult(state, logs)
        path = trace if isinstance(trace, str) else None
        with tracing(path, **self.ledger_meta()) as trc:
            state, logs = self.runner.run(self.algorithm, state, data,
                                          n_rounds, seed, **run_kw)
            records = trc.records()
        result = ExperimentResult(state, logs, records)
        if ledger is not None:
            result.ingest(ledger)
        return result
