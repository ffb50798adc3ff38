"""Analysis windows (reference: ``get_window``, modulated/modulated.cc:47-72)."""

from __future__ import annotations

import numpy as np

__all__ = ["get_window"]


def get_window(window_type: int, win_len: int) -> np.ndarray:
    """0 -> rectangular, 2 -> Hann, anything else -> Hamming (the
    reference's default), float64 numpy."""
    n = np.arange(win_len, dtype=np.float64)
    if window_type == 0:
        return np.ones(win_len)
    if window_type == 2:
        return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (win_len - 1)))
    return 0.54 - 0.46 * np.cos(2.0 * np.pi * n / (win_len - 1))
