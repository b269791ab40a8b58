"""Walker constellation propagation + ground-station visibility windows.

FLySTacK-fidelity orbital model (Kim et al., 2024): circular LEO orbits,
spherical Earth, Walker-delta phasing.  Positions are propagated
analytically; a satellite can talk to the ground station when its elevation
above the GS horizon exceeds a mask angle.  NumPy only — this is host-side
scheduling substrate, not device compute.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

R_EARTH = 6371.0e3           # m
MU = 3.986004418e14          # m³/s²
OMEGA_EARTH = 7.2921159e-5   # rad/s


@dataclasses.dataclass(frozen=True)
class Walker:
    """Walker-delta constellation i:t/p/f."""
    n_sats: int = 100
    n_planes: int = 10
    altitude: float = 550e3
    inclination: float = 97.6        # degrees (sun-synchronous — polar GS)
    phasing: int = 1                 # relative spacing factor f

    @property
    def sats_per_plane(self) -> int:
        return self.n_sats // self.n_planes

    @property
    def radius(self) -> float:
        return R_EARTH + self.altitude

    @property
    def period(self) -> float:
        return 2 * np.pi * np.sqrt(self.radius ** 3 / MU)

    def positions(self, t: np.ndarray) -> np.ndarray:
        """ECI positions (…, n_sats, 3) at times t (seconds, array)."""
        t = np.asarray(t, dtype=np.float64)
        inc = np.radians(self.inclination)
        n = 2 * np.pi / self.period                       # mean motion
        spp = self.sats_per_plane
        plane = np.arange(self.n_sats) // spp             # (S,)
        slot = np.arange(self.n_sats) % spp
        raan = 2 * np.pi * plane / self.n_planes
        phase = (2 * np.pi * slot / spp
                 + 2 * np.pi * self.phasing * plane / self.n_sats)
        u = phase + n * t[..., None]                      # argument of latitude
        # orbital plane → ECI
        x_orb = self.radius * np.cos(u)
        y_orb = self.radius * np.sin(u)
        cos_r, sin_r = np.cos(raan), np.sin(raan)
        cos_i, sin_i = np.cos(inc), np.sin(inc)
        x = x_orb * cos_r - y_orb * cos_i * sin_r
        y = x_orb * sin_r + y_orb * cos_i * cos_r
        z = y_orb * sin_i
        return np.stack([x, y, z], axis=-1)


@dataclasses.dataclass(frozen=True)
class GroundStation:
    lat: float = 67.86     # Kiruna, a common polar LEO downlink site
    lon: float = 20.22
    mask_angle: float = 10.0  # degrees above horizon

    def position(self, t: np.ndarray) -> np.ndarray:
        """ECI position of the GS at times t (Earth rotation included)."""
        t = np.asarray(t, dtype=np.float64)
        lat, lon0 = np.radians(self.lat), np.radians(self.lon)
        lon = lon0 + OMEGA_EARTH * t
        return R_EARTH * np.stack(
            [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon),
             np.full_like(lon, np.sin(lat))], axis=-1)


def elevation(sat_pos: np.ndarray, gs_pos: np.ndarray) -> np.ndarray:
    """Elevation (degrees) of satellites above the GS local horizon.

    sat_pos: (..., S, 3); gs_pos: (..., 3)."""
    rel = sat_pos - gs_pos[..., None, :]
    zen = gs_pos / np.linalg.norm(gs_pos, axis=-1, keepdims=True)
    proj = np.einsum("...sk,...k->...s", rel, zen)
    dist = np.linalg.norm(rel, axis=-1)
    return np.degrees(np.arcsin(np.clip(proj / dist, -1, 1)))


def visible(walker: Walker, gs: GroundStation, t: np.ndarray) -> np.ndarray:
    """Bool (…, n_sats): GS link available at times t."""
    return elevation(walker.positions(t), gs.position(t)) > gs.mask_angle


def visibility_grid(walker: Walker, gs: GroundStation, ts: np.ndarray,
                    chunk: int = 64) -> np.ndarray:
    """Fused, chunked :func:`visible` for large (T, S) grids.

    Same spherical geometry as ``visible`` but with the elevation
    threshold evaluated in place — no (T, S, 3) position/relative-vector
    temporaries are ever materialized, peak memory is O(chunk · S), and
    the per-sample trig collapses to four multiply-adds via the angle sum
    ``u = phase + n·t`` (trig is evaluated once per satellite phase and
    once per time sample, not per (satellite, time) pair).  This is the
    contact-plan builder's hot loop: at mega-constellation scale the
    naive path moves gigabytes of float64 through memory per horizon
    doubling.

    The visibility decision ``el > mask`` is taken as the equivalent
    monotone comparison ``proj·|proj| > sin(mask)·|sin(mask)|·dist²``
    (sign-preserving squares avoid the sqrt/arcsin of the reference
    path).  Agreement with ``visible`` is exact unless a grid sample's
    elevation sits within ~1 ulp of the mask angle — regression-tested
    against the reference on every built-in scenario geometry.
    """
    ts = np.asarray(ts, dtype=np.float64)
    inc = np.radians(walker.inclination)
    n = 2.0 * np.pi / walker.period
    spp = walker.sats_per_plane
    plane = np.arange(walker.n_sats) // spp
    slot = np.arange(walker.n_sats) % spp
    raan = 2.0 * np.pi * plane / walker.n_planes
    phase = (2.0 * np.pi * slot / spp
             + 2.0 * np.pi * walker.phasing * plane / walker.n_sats)
    cos_p, sin_p = np.cos(phase), np.sin(phase)
    # pos(t, s) = R · (cos_u · A + sin_u · B); the basis vectors depend
    # only on the orbital PLANE (raan, inclination), so the station-frame
    # dot products contract at (T, n_planes) and gather out to (T, S)
    # ragged constellations can spill into plane index n_planes — cover
    # every plane value `sat // spp` actually produces
    raan_p = (2.0 * np.pi * np.arange(int(plane.max()) + 1)
              / walker.n_planes)
    cos_r, sin_r = np.cos(raan_p), np.sin(raan_p)
    cos_i, sin_i = np.cos(inc), np.sin(inc)
    A = np.stack([cos_r, sin_r, np.zeros_like(raan_p)], axis=-1)     # (P, 3)
    B = np.stack([-cos_i * sin_r, cos_i * cos_r,
                  np.full_like(raan_p, sin_i)], axis=-1)             # (P, 3)
    R = walker.radius
    s_mask = np.sin(np.radians(gs.mask_angle))
    thr = s_mask * abs(s_mask)
    out = np.empty((len(ts), walker.n_sats), dtype=bool)
    # fold the per-sat phase into the basis: pos·zen = R·(cos(nt)·P1 +
    # sin(nt)·P2) with P1 = cosφ·(A·zen) + sinφ·(B·zen) and
    # P2 = cosφ·(B·zen) − sinφ·(A·zen) — the angle sum absorbed into two
    # (T, S) fused multiply-adds instead of materializing cos_u/sin_u
    for i in range(0, len(ts), chunk):
        t = ts[i:i + chunk]
        g = gs.position(t)                                           # (T, 3)
        gn = np.linalg.norm(g, axis=-1)                              # (T,)
        zen = g / gn[:, None]
        az = np.einsum("tk,pk->tp", zen, A)[:, plane]                # (T, S)
        bz = np.einsum("tk,pk->tp", zen, B)[:, plane]
        p1 = cos_p[None, :] * az + sin_p[None, :] * bz
        p2 = cos_p[None, :] * bz - sin_p[None, :] * az
        cu, su = np.cos(n * t), np.sin(n * t)
        # pos·zen; then pos·g = |g|·(pos·zen), so both the horizon
        # projection and the slant range fold into this one matrix
        pz = R * (cu[:, None] * p1 + su[:, None] * p2)
        proj = pz - gn[:, None]                                      # rel·zen
        dist2 = R * R + gn[:, None] ** 2 - 2.0 * gn[:, None] * pz
        out[i:i + chunk] = proj * np.abs(proj) > thr * dist2
    return out


def next_window(walker: Walker, gs: GroundStation, t0: float, sat: int,
                horizon: float = 7200.0, dt: float = 10.0) -> Optional[float]:
    """Seconds from t0 until satellite `sat` next sees the GS (None if not
    within `horizon`)."""
    ts = t0 + np.arange(0.0, horizon, dt)
    vis = visible(walker, gs, ts)[:, sat]
    idx = np.argmax(vis)
    if not vis[idx]:
        return None
    return float(ts[idx] - t0)


def in_plane_neighbors(walker: Walker, sat: int) -> tuple:
    """The two ring neighbours of `sat` within its orbital plane (ISL)."""
    spp = walker.sats_per_plane
    plane, slot = sat // spp, sat % spp
    return (plane * spp + (slot - 1) % spp,
            plane * spp + (slot + 1) % spp)


def isl_neighbors(walker: Walker, sat: int, cross_plane: bool = True) -> tuple:
    """+grid ISL topology: the in-plane ring pair plus (optionally) the
    same-slot satellites in the two adjacent planes, wrapping across the
    seam (last plane ↔ plane 0).  Duplicates collapse for degenerate
    constellations (≤ 2 planes or ≤ 2 slots per plane)."""
    spp = walker.sats_per_plane
    plane, slot = sat // spp, sat % spp
    nbrs = list(in_plane_neighbors(walker, sat))
    if cross_plane and walker.n_planes > 1:
        nbrs.append(((plane - 1) % walker.n_planes) * spp + slot)
        nbrs.append(((plane + 1) % walker.n_planes) * spp + slot)
    out = []
    for nb in nbrs:
        if nb != sat and nb not in out:
            out.append(nb)
    return tuple(out)
