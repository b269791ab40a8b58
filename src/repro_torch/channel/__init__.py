"""Stochastic lossy-channel subsystem: link-budget loss, outages, ARQ.

The simulator's contact windows say *when* a satellite can talk; this
package says *how well*.  See :mod:`repro_torch.channel.model` for the facade
(`Scenario.channel` / ``SpaceRunner(channel=...)``) and
:mod:`repro_torch.kernels.erasure_mask` for the device-side batch erasure
kernel over packed wire words.
"""
from .arq import ArqPlan, SelectiveRepeatARQ, TxResult
from .budget import LinkBudget, elevation_at, fspl_db, slant_range
from .model import ChannelModel
from .outage import (ConjunctionBlackout, RainFade, counter_uniform,
                     counter_uniforms)

__all__ = [
    "ArqPlan", "ChannelModel", "LinkBudget", "SelectiveRepeatARQ", "TxResult",
    "RainFade", "ConjunctionBlackout", "counter_uniform",
    "counter_uniforms", "elevation_at", "fspl_db", "slant_range",
]
