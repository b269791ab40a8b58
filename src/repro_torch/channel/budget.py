"""Elevation-dependent link budget: slant range → SNR → BER → erasure prob.

The fixed-rate :class:`repro_torch.constellation.links.LinkModel` treats a sat↔GS
pass as a constant-capacity pipe.  Real LEO links are nothing of the sort:
free-space path loss varies ~12 dB between a 10° and a 90° pass (the slant
range shrinks from ~1900 km to ~550 km at 550 km altitude), so both the
achievable rate and the segment-erasure probability are strong functions of
elevation.  :class:`LinkBudget` models the standard chain

    slant_range(el) → FSPL → SNR = EIRP + G/T − FSPL − k − 10·log₁₀B − L
    BER  = ½·erfc(√(Eb/N0_eff))              (coherent BPSK + coding gain)
    p_seg = 1 − (1 − BER)^(8·seg_bytes)      (segment erased on any bit hit)
    rate = min(η·B·log₂(1+SNR), rate_cap)    (Shannon with efficiency η)

Everything is a pure function of elevation plus an additive ``fade_db``
term (rain / scintillation, supplied by the outage processes in
:mod:`repro_torch.channel.outage`), so the ARQ model and the engine can query
the instantaneous link state at any point of a contact window.

The fixed-rate model stays available as the special case ``budget=None``
on :class:`repro_torch.channel.model.ChannelModel` — transmission times then
come from ``LinkModel`` exactly, bit-for-bit reproducing the lossless
simulator's accounting.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..constellation.orbits import R_EARTH, GroundStation, Walker, elevation

BOLTZMANN_DBW = -228.6          # 10·log10(k), dBW/K/Hz
C_LIGHT = 299792458.0           # m/s


def slant_range(elevation_deg: float, altitude: float) -> float:
    """Slant range (m) to a satellite at ``altitude`` seen at ``elevation_deg``.

    Spherical-Earth geometry (law of cosines on the Earth-center triangle):
    ``d = √((R+h)² − R²·cos²el) − R·sin el``.
    """
    el = math.radians(max(float(elevation_deg), 0.0))
    r = R_EARTH + altitude
    return math.sqrt(r * r - (R_EARTH * math.cos(el)) ** 2) \
        - R_EARTH * math.sin(el)


def fspl_db(distance_m: float, freq_hz: float) -> float:
    """Free-space path loss in dB."""
    return 20.0 * math.log10(4.0 * math.pi * distance_m * freq_hz / C_LIGHT)


@dataclasses.dataclass(frozen=True)
class LinkBudget:
    """Elevation-dependent sat↔GS link budget (defaults ≈ a small-sat
    Ka-band downlink: 26 GHz, 100 MHz channel, modest EIRP).

    ``p_seg``/``rate`` are the two quantities the ARQ model consumes; both
    accept an additive ``fade_db`` impairment from the outage processes.
    """

    freq_hz: float = 26.0e9          # Ka band
    bandwidth_hz: float = 100.0e6
    eirp_dbw: float = 18.0           # satellite EIRP
    gt_dbk: float = 20.0             # ground station G/T
    misc_loss_db: float = 3.0        # pointing, atmosphere (clear sky), impl.
    coding_gain_db: float = 6.0      # FEC gain applied to Eb/N0
    spectral_efficiency: float = 0.75  # fraction of Shannon capacity achieved
    rate_cap_bps: float = 1.2e9      # modem ceiling
    altitude: float = 550e3          # for the slant-range geometry

    def snr_db(self, elevation_deg: float, fade_db: float = 0.0) -> float:
        d = slant_range(elevation_deg, self.altitude)
        return (self.eirp_dbw + self.gt_dbk - fspl_db(d, self.freq_hz)
                - BOLTZMANN_DBW - 10.0 * math.log10(self.bandwidth_hz)
                - self.misc_loss_db - fade_db)

    def ber(self, elevation_deg: float, fade_db: float = 0.0) -> float:
        """Coherent-BPSK bit error rate with coding gain folded into Eb/N0."""
        ebn0_db = self.snr_db(elevation_deg, fade_db) + self.coding_gain_db
        ebn0 = 10.0 ** (ebn0_db / 10.0)
        return 0.5 * math.erfc(math.sqrt(max(ebn0, 0.0)))

    def p_seg(self, elevation_deg: float, seg_bytes: int,
              fade_db: float = 0.0) -> float:
        """P(a ``seg_bytes``-byte segment is erased) — any uncorrected bit
        error kills the segment's CRC."""
        ber = self.ber(elevation_deg, fade_db)
        if ber <= 0.0:
            return 0.0
        # log1p form stays accurate when ber·bits is tiny
        return float(-np.expm1(8.0 * seg_bytes * np.log1p(-min(ber, 1.0))))

    def rate(self, elevation_deg: float, fade_db: float = 0.0) -> float:
        """Achievable link rate in BYTES/s at the given elevation."""
        snr = 10.0 ** (self.snr_db(elevation_deg, fade_db) / 10.0)
        bps = self.spectral_efficiency * self.bandwidth_hz * math.log2(1.0 + snr)
        return min(bps, self.rate_cap_bps) / 8.0


def sat_position(walker: Walker, sat: int, t: float) -> np.ndarray:
    """ECI position (3,) of ONE satellite at scalar time ``t``.

    Single-orbit mirror of :meth:`Walker.positions` — the channel layer
    queries one (gateway, instant) per rate/erasure evaluation, and
    propagating the whole constellation for a scalar lookup would make
    budget-channel scheduling O(n_sats) per window-fit check.
    """
    inc = math.radians(walker.inclination)
    n = 2.0 * math.pi / walker.period
    spp = walker.sats_per_plane
    plane, slot = sat // spp, sat % spp
    raan = 2.0 * math.pi * plane / walker.n_planes
    phase = (2.0 * math.pi * slot / spp
             + 2.0 * math.pi * walker.phasing * plane / walker.n_sats)
    u = phase + n * float(t)
    x_orb = walker.radius * math.cos(u)
    y_orb = walker.radius * math.sin(u)
    cos_r, sin_r = math.cos(raan), math.sin(raan)
    cos_i, sin_i = math.cos(inc), math.sin(inc)
    return np.array([x_orb * cos_r - y_orb * cos_i * sin_r,
                     x_orb * sin_r + y_orb * cos_i * cos_r,
                     y_orb * sin_i])


def elevation_at(walker: Walker, station: GroundStation, sat: int,
                 t: float) -> float:
    """Instantaneous elevation (deg) of ``sat`` above ``station`` at ``t``."""
    pos = sat_position(walker, sat, t)[None, :]        # (S=1, 3)
    el = elevation(pos, station.position(np.asarray(float(t))))
    return float(el[0])
