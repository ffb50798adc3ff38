"""Subband multichannel WPE (weighted prediction error) dereverberation.

Counterpart of the JAX package's ``models/dereverberation.py`` (reference:
dereverberation/dereverberation.cc, MultiChannelWPEDereverberation).  Per EM
iteration: variance re-estimation, lag-covariance accumulation, max-diagonal
loading and a Gauss-Jordan solve per (target channel, bin); then the apply,
a masked prediction over the lag window.  Conventions are those of
`ops.wpe_kernels`; ``P = upperN - lowerN + 1`` taps per channel, and the lag
vector stacks all C channels (``C*P`` taps per target).

- `wpe_estimate`, `wpe_apply` and `wpe_multichannel` take one utterance's
  complex frames ``[C, T, F]`` in plain torch;
- `wpe_multichannel_packed_tm` runs the whole batch on the chain's packed
  time-major frames through the three wrappers of `ops.wpe_kernels` (CUDA
  kernels on the card, their plain versions on the CPU).
"""

from __future__ import annotations

import torch

from ..ops.wpe_kernels import (
    SUBBAND_FLOOR,
    gj_solve,
    resid_plain,
    stats_plain,
    wpe_resid,
    wpe_stats,
)
from ..ops.wpe_kernels import gj_solve_plain as _gj_solve
from ..ops.wpe_kernels import lag_tensor as _lag_tensor  # noqa: F401 (the JAX module's name)

__all__ = [
    "SUBBAND_FLOOR",
    "LOAD_DB",
    "DIAGONAL_BIAS",
    "band_limit_mask",
    "wpe_estimate",
    "wpe_apply",
    "wpe_multichannel",
    "wpe_multichannel_packed_tm",
]


def band_limit_mask(F: int, band_width: float, samplerate: float, device=None):
    """Active-bin mask ``[F]`` for the WPE ``bandWidth`` option, or ``None``
    for all bins: bins ``<= lower`` or ``>= upper`` with ``lower = (bw /
    (fs/2)) * (M/2)``, ``upper = M - lower`` (set_band_width_,
    dereverberation.cc:278-285); other bins pass through."""
    if band_width <= 0.0:
        return None
    if band_width > samplerate / 2.0:
        raise ValueError("bandWidth is greater than the Nyquist rate")
    M2 = F - 1
    lower = int((band_width / (samplerate / 2.0)) * M2)
    upper = 2 * M2 - lower
    bins = torch.arange(F, device=device)
    return (bins <= lower) | (bins >= upper)


# the EM loading every entry point uses unless told otherwise (JAX defaults)
LOAD_DB = -20.0
DIAGONAL_BIAS = 0.0


def _load(R: torch.Tensor, load_db: float = LOAD_DB,
          diagonal_bias: float = DIAGONAL_BIAS) -> torch.Tensor:
    """``diag(R) += diagonal_bias``, then max-diagonal loading (load_R_,
    dereverberation.cc:172-184): ``diag <- |diag| + max|diag| * 10^(load_db/10)``."""
    diag = torch.abs(torch.diagonal(R, dim1=-2, dim2=-1) + diagonal_bias)
    new_diag = diag + diag.amax(dim=-1, keepdim=True) * 10.0 ** (load_db / 10.0)
    R = R.clone()
    torch.diagonal(R, dim1=-2, dim2=-1).copy_(new_diag)
    return R


def _em(stats, solve, G, iterations: int, load_db: float, diagonal_bias: float):
    """EM filter estimation: ``stats(G, has_g) -> (R, r)``, ``solve(R, r) -> G``."""
    for it in range(iterations):
        R, r = stats(G, it > 0)
        G = solve(_load(R, load_db, diagonal_bias), r)
    return G


def _truncate_taps(G: torch.Tensor, C: int, lowerN: int) -> torch.Tensor:
    """The apply-time tap truncation (see `wpe_apply`) of filters ``G [...,
    C*P]``: taps ``p >= P - lowerN`` of every channel are zeroed."""
    if lowerN == 0:
        return G
    P = G.shape[-1] // C
    tap_ok = (torch.arange(P, device=G.device) < P - lowerN).repeat(C)
    return G * tap_ok.to(G.dtype)


def _mask_G(G: torch.Tensor, band_width: float, samplerate: float) -> torch.Tensor:
    """Zero the filters ``G [..., F, C*P]`` of band-limited-out bins, as the
    reference skips them (their filters stay 0, so the apply passes them)."""
    mask = band_limit_mask(G.shape[-2], band_width, samplerate, G.device)
    return G if mask is None else G * mask[:, None].to(G.dtype)


def wpe_estimate(
    Y: torch.Tensor,
    lowerN: int,
    upperN: int,
    iterations: int = 2,
    load_db: float = LOAD_DB,
    diagonal_bias: float = DIAGONAL_BIAS,
) -> torch.Tensor:
    """WPE prediction filters from a buffered utterance ``Y [C, T, F]``:
    ``G [C, F, C*P]``, per target channel and bin the conjugate-applied
    filter over the stacked channel lags (dereverberation.cc:414-433)."""
    C, _, F = Y.shape
    P = upperN - lowerN + 1
    G0 = torch.zeros((1, C, F, C * P), dtype=Y.dtype, device=Y.device)
    G = _em(lambda G, has_g: stats_plain(Y[None], G, lowerN, P, has_g), _gj_solve, G0,
            iterations, load_db, diagonal_bias)
    return G[0]


def wpe_apply(Y: torch.Tensor, G: torch.Tensor, lowerN: int) -> torch.Tensor:
    """Apply estimated filters: ``out_ct = y_ct - g_c^H l_t`` for ``t >=
    lowerN`` (dereverberation.cc:227-275 / :445-501).  ``Y [C, T, F]``,
    ``G [C, F, C*P]`` -> ``[C, T, F]``.

    Reference quirk, kept: the streaming apply holds only ``P`` frames of
    history but indexes lags ``lowerN`` deeper (dereverberation.cc:251-265),
    so its deepest ``lowerN`` taps read zeros; the filter applied drops taps
    ``p >= P - lowerN``.  Estimation buffers the whole utterance and uses the
    full window."""
    G = _truncate_taps(G, Y.shape[0], lowerN)
    return resid_plain(Y[None], G[None], lowerN)[0]


def wpe_multichannel(
    Y: torch.Tensor,
    lowerN: int,
    upperN: int,
    iterations: int = 2,
    load_db: float = LOAD_DB,
    diagonal_bias: float = DIAGONAL_BIAS,
    band_width: float = 0.0,
    samplerate: float = 16000.0,
) -> torch.Tensor:
    """Joint multichannel WPE of one utterance, ``Y [C, T, F] -> [C, T, F]``;
    ``band_width > 0`` applies the reference's band limit (`band_limit_mask`)."""
    G = wpe_estimate(Y, lowerN, upperN, iterations, load_db, diagonal_bias)
    return wpe_apply(Y, _mask_G(G, band_width, samplerate), lowerN)


def wpe_multichannel_packed_tm(
    Yp: torch.Tensor,
    lowerN: int,
    upperN: int,
    iterations: int = 2,
    load_db: float = LOAD_DB,
    diagonal_bias: float = DIAGONAL_BIAS,
    band_width: float = 0.0,
    samplerate: float = 16000.0,
) -> torch.Tensor:
    """`wpe_multichannel` of every utterance of the packed time-major frames
    ``Yp [Tf, B, C, M]`` (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes), packed in
    and packed out: per EM iteration `wpe_stats`, the loading in plain torch
    and `gj_solve`; then the tap truncation and band mask, and `wpe_resid`."""
    _, B, C, M = Yp.shape
    F = M // 2 + 1
    P = upperN - lowerN + 1
    G0 = torch.zeros((B, C, F, C * P), dtype=torch.complex64, device=Yp.device)
    G = _em(lambda G, has_g: wpe_stats(Yp, G, lowerN, P, has_g), gj_solve, G0, iterations,
            load_db, diagonal_bias)
    G = _mask_G(_truncate_taps(G, C, lowerN), band_width, samplerate)
    return wpe_resid(Yp, G, lowerN)
