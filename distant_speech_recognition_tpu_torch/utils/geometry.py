"""Array geometry -> steering time delays (numpy, host side).

Units follow the reference: positions in mm, speed of sound 343740 mm/s by
default, delays in seconds.  Only the linear far-field array of the flagship
configuration is ported (lib/pybeamformer.py:41-64).
"""

from __future__ import annotations

import numpy as np

__all__ = ["calc_la_delays", "SSPEED_MM_S"]

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
