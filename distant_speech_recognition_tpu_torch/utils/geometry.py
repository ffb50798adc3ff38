"""Array geometry -> steering time delays (numpy, host side).

Units follow the reference: positions in mm, speed of sound 343740 mm/s by
default, delays in seconds.  The linear far-field array of the flagship and
fixed-weight configurations (lib/pybeamformer.py:41-64) and the circular
far-field array of the steered configuration (lib/pybeamformer.py:99-121)
are ported.
"""

from __future__ import annotations

import numpy as np

__all__ = ["calc_la_delays", "calc_ca_delays", "SSPEED_MM_S"]

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
