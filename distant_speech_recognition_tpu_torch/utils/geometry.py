"""Array geometry -> steering time delays (numpy, host side).

Units follow the reference: positions in mm, speed of sound 343740 mm/s by
default, delays in seconds.  The delay calculators of the reference
(lib/pybeamformer.py:41-154): linear, planar and circular far-field arrays,
near-field (spherical wave) arrays, and the dispatch on the array type,
with the reference-microphone conventions.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calc_la_delays", "calc_pa_delays", "calc_ca_delays", "calc_nf_delays", "calc_delays",
           "SSPEED_MM_S"]

SSPEED_MM_S = 343740.0


def calc_la_delays(mpos, azimuth, sspeed=SSPEED_MM_S, ref_micx=None):
    """Far-field delays for a linear array (pybeamformer.py:41-64).

    ``mpos``: [C, 1] (or [C]) distances of each mic from the reference axis.
    """
    mpos = np.atleast_2d(np.asarray(mpos, dtype=np.float64))
    if mpos.shape[0] == 1 and mpos.shape[1] > 1:
        mpos = mpos.T
    c = mpos.shape[0]
    if ref_micx is None:
        ref_micx = c // 2
    delays = -mpos[:, 0] * np.cos(azimuth) / sspeed
    return delays - delays[ref_micx]


def calc_pa_delays(mpos, azimuth, polar_angle, sspeed=SSPEED_MM_S, ref_micx=None):
    """Far-field delays for a planar array (pybeamformer.py:67-96).

    ``mpos``: [C, 2] xy positions.
    """
    mpos = np.asarray(mpos, dtype=np.float64)
    if ref_micx is None:
        ref_micx = mpos.shape[0] // 2
    dx = mpos[:, 0] - mpos[ref_micx, 0]
    dy = mpos[:, 1] - mpos[ref_micx, 1]
    sp = np.sin(polar_angle)
    return -(dx * np.cos(azimuth) * sp + dy * np.sin(azimuth) * sp) / sspeed


def calc_ca_delays(mpos, azimuth, polar_angle, sspeed=SSPEED_MM_S):
    """Far-field delays for a circular array (pybeamformer.py:99-121).

    ``mpos``: [C, 3] xyz positions from the array center.
    """
    mpos = np.asarray(mpos, dtype=np.float64)
    c_xyz = -np.array(
        [
            np.sin(polar_angle) * np.cos(azimuth),
            np.sin(polar_angle) * np.sin(azimuth),
            np.cos(polar_angle),
        ]
    )
    return mpos[:, :3] @ c_xyz / sspeed


def calc_nf_delays(mpos, x, y, z, sspeed=SSPEED_MM_S, ref_micx=None):
    """Near-field (spherical wave) delays from a source at (x, y, z) mm
    (pybeamformer.py:124-141), relative to microphone ``ref_micx``."""
    mpos = np.asarray(mpos, dtype=np.float64)
    if ref_micx is None:
        ref_micx = mpos.shape[0] // 2
    delays = np.sqrt(
        (x - mpos[:, 0]) ** 2 + (y - mpos[:, 1]) ** 2 + (z - mpos[:, 2]) ** 2
    ) / sspeed
    return delays - delays[ref_micx]


def calc_delays(array_type, mpos, position, sspeed=SSPEED_MM_S, ref_micx=None):
    """Delays by array type (pybeamformer.py:144-154): "linear" (azimuth),
    "planar" (azimuth, polar angle), "circular" (azimuth, polar angle),
    anything else near-field (x, y, z)."""
    if array_type == "linear":
        return calc_la_delays(mpos, position[0], sspeed=sspeed, ref_micx=ref_micx)
    if array_type == "planar":
        return calc_pa_delays(mpos, position[0], position[1], sspeed=sspeed, ref_micx=ref_micx)
    if array_type == "circular":
        return calc_ca_delays(mpos, position[0], position[1], sspeed=sspeed)
    return calc_nf_delays(mpos, position[0], position[1], position[2], sspeed=sspeed,
                          ref_micx=ref_micx)
