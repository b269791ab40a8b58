"""Link budget / transmission-time model for GS and inter-satellite links.

Transmission times are pure functions of on-wire bytes.  Two ways to get
the byte count:

* :func:`message_bytes` — *nominal* estimate from a compressor's
  ``wire_bits_per_scalar`` (payload only, no headers);
* a measured :class:`repro_torch.wire.WireMessage` — pass its exact ``nbytes``
  into :meth:`LinkModel.gs_time` / :meth:`LinkModel.isl_time`.

The simulator (``repro_torch.sim.engine``) and :class:`repro_torch.core.fedlt_sat.
SpaceRunner` use measured bytes whenever the compressor has a wire codec.

These rates are *fixed* — an elevation-dependent profile (slant-range
link budget, SNR → BER → erasure probability) lives in
:mod:`repro_torch.channel.budget`; a :class:`repro_torch.channel.ChannelModel` with
``budget=None`` falls back to this fixed-rate model exactly.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class LinkModel:
    """Transmission times for model updates (bytes / rate + latency)."""
    gs_rate: float = 100e6 / 8        # 100 Mbit/s sat↔GS → bytes/s
    isl_rate: float = 1e9 / 8         # 1 Gbit/s optical ISL
    gs_latency: float = 0.02          # s (LEO slant range)
    isl_latency: float = 0.005

    def gs_time(self, nbytes: float) -> float:
        return self.gs_latency + nbytes / self.gs_rate

    def isl_time(self, nbytes: float, hops: int = 1) -> float:
        return hops * (self.isl_latency + nbytes / self.isl_rate)


def message_bytes(n_params: int, bits_per_scalar: float) -> float:
    """Nominal on-wire size of one model update under a given compressor
    (payload-only estimate; exact sizes come from ``repro_torch.wire``)."""
    return n_params * bits_per_scalar / 8.0
