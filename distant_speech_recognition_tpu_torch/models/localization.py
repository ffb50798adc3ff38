"""SRP-PHAT source localization over a steering grid, plain torch.

Counterpart of the JAX package's ``models/localization.py``
(`srp_phat_steering_table`, `srp_phat`; the reference's
DOAEstimatorSRPDSBLA steering table and getSrpPhat, beamformer.cc:2879-3211,
localization/localization.cc).  No TPU kernel computes these: the SRP is a
matrix product, which `torch.matmul` runs.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.geometry import SSPEED_MM_S, calc_ca_delays
from .beamforming import array_manifold

__all__ = ["srp_phat_steering_table", "srp_phat"]

# bins per matrix product: each holds the snapshot outer products of its
# bins, [frames, bins, C, C] complex, 82 MB at a config-5 batch (64 x 10 s)
SRP_BIN_CHUNK = 16


def srp_phat_steering_table(mpos, fftlen: int, samplerate: float, thetas, phis,
                            sspeed: float = SSPEED_MM_S):
    """D&S steering table over the (theta, phi) grid of a circular array
    ``mpos [C, 3]`` (mm): ``(steering [G, F, C] complex64, grid [G, 2]
    float32)``, CPU tensors, G = len(thetas) * len(phis), theta-major."""
    mpos = np.asarray(mpos, dtype=np.float64)
    grid = np.array([(t, p) for t in np.atleast_1d(thetas) for p in np.atleast_1d(phis)])
    table = [torch.conj(array_manifold(fftlen, samplerate, calc_ca_delays(mpos, p, t, sspeed)))
             for t, p in grid]
    return torch.stack(table).resolve_conj(), torch.tensor(grid, dtype=torch.float32)


def srp_phat(X: torch.Tensor, steering: torch.Tensor, min_bin: int = 0,
             max_bin: int | None = None) -> torch.Tensor:
    """Steered response power with PHAT weighting at every grid point:
    snapshots ``X [..., T, F, C]``, ``steering [G, F, C]`` -> ``[..., T, G]``,
    summed over bins ``min_bin <= f < max_bin`` (all from ``min_bin`` when
    ``max_bin`` is None).  PHAT normalizes each bin's snapshot to unit
    magnitude per channel (a zero stays zero), so every bin votes equally.

    The power is computed as a quadratic form, one real matrix product per
    chunk of `SRP_BIN_CHUNK` bins that also sums over the chunk's bins::

        |sum_c s_c x_c|^2 = sum_{c,d} Re(s_c conj(s_d)) Re(x_c conj(x_d))
                                    - Im(s_c conj(s_d)) Im(x_c conj(x_d))

    so the complex response ``[..., T, G, F]`` never exists."""
    mag = torch.abs(X)
    Xn = X / torch.where(mag > 0, mag, torch.ones_like(mag))
    lead = X.shape[:-2]
    F, C = X.shape[-2:]
    G = steering.shape[0]
    hi = F if max_bin is None else max_bin
    Xf = Xn.reshape(-1, F, C)  # [N, F, C]
    out = torch.zeros(Xf.shape[0], G, dtype=mag.dtype, device=X.device)
    for f0 in range(min_bin, hi, SRP_BIN_CHUNK):
        f1 = min(f0 + SRP_BIN_CHUNK, hi)
        x, s = Xf[:, f0:f1], steering[:, f0:f1]
        xx = torch.view_as_real(x[..., :, None] * torch.conj(x)[..., None, :])
        ss = s[..., :, None] * torch.conj(s)[..., None, :]
        w = torch.stack([ss.real, -ss.imag], dim=-1)  # [G, fc, C, C, 2]
        out += xx.reshape(xx.shape[0], -1) @ w.reshape(G, -1).T
    return out.reshape(lead + (G,))
