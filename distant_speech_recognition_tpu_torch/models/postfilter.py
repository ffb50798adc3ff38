"""The Zelinski postfilter, plain torch.

Counterpart of the JAX package's ``models/postfilter.py`` for the Zelinski
postfilter (ZelinskiFilter_f, postfilter.cc:57-148).  One frame of its
recursion, `zelinski_step`, is shared by the fixed-weight chain
(`zelinski_postfilter`, the specification of the fixed-weight CUDA kernels)
and the fused GSC-RLS loop (`adaptive_gsc.gsc_postfilter_fused`).
"""

from __future__ import annotations

import torch

SPECTRAL_FLOOR = 1.0e-4  # postfilter.cc:56

__all__ = [
    "SPECTRAL_FLOOR", "PostFilterType", "zelinski_step", "zelinski_postfilter", "zelinski_args",
]


class PostFilterType:
    """Bit flags per postfilter.h (TYPE_ZELINSKI1_REAL etc.)."""

    ZELINSKI1_REAL = 0x01
    ZELINSKI1_ABS = 0x02
    APAB = 0x04
    ZELINSKI2 = 0x08


def _time_align(wq: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Per-channel delay compensation ``conj(wq_c) X_c`` (time_alignment_,
    postfilter.cc:30-43); ``wq [..., F, C]`` broadcasts against ``X``."""
    return torch.conj(wq) * X


def zelinski_step(phi_pair, phi_diag, aligned: torch.Tensor, t: int, alpha: float,
                  real_mode: bool):
    """One frame ``t`` of the Zelinski recursion on the time-aligned snapshot
    ``aligned [..., F, C]``.  The weight reads the cross-spectral densities
    only through the pair sum over i<j and the trace, both linear in them, so
    only those two smoothed sums are carried (``phi_pair``, ``phi_diag``;
    ignored at t < 2).  The reference keeps alpha at 0 for its first TWO
    calls: its ``frame_no_ > 0`` check reads the pre-increment counter
    (postfilter.cc:424-463).  A digitally silent bin (trace 0) gets ratio 0,
    so the 1e-4 floor, where the reference's 0/0 would be NaN.  Returns
    ``(phi_pair, phi_diag, W)``."""
    C = aligned.shape[-1]
    pair_sum = sum(aligned[..., i] * torch.conj(aligned[..., j])
                   for i in range(C) for j in range(i + 1, C))
    diag_sum = torch.sum(torch.abs(aligned) ** 2, dim=-1)
    if t > 1:
        phi_pair = alpha * phi_pair + (1.0 - alpha) * pair_sum
        phi_diag = alpha * phi_diag + (1.0 - alpha) * diag_sum
    else:
        phi_pair, phi_diag = pair_sum, diag_sum
    num = torch.clamp(torch.real(phi_pair), min=0.0) if real_mode else torch.abs(phi_pair)
    pos = phi_diag > 0
    ratio = torch.where(pos, num / torch.where(pos, phi_diag, torch.ones_like(phi_diag)),
                        torch.zeros_like(num))
    W = torch.clamp(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
    return phi_pair, phi_diag, W


def zelinski_postfilter(
    X: torch.Tensor,
    Y: torch.Tensor,
    wq: torch.Tensor,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
) -> torch.Tensor:
    """Zelinski postfilter on a beamformed signal, one loop over frames.

    ``X``: complex snapshots ``[T, ..., F, C]``; ``Y``: beamformed ``[T, ...,
    F]``; ``wq``: the alignment manifold ``[F, C]`` (the C++ ``ta_``) or one
    per utterance ``[..., F, C]``.  Per frame and bin::

        W = clip( (2/(C-1)) * num / sum_i phi_ii, 1e-4, 1 )
        num = max(Re(sum_{i<j} phi_ij), 0)  [REAL]  |  |sum_{i<j} phi_ij|  [ABS]

    applied from frame ``min_frames + 1`` on (the reference's NO_USE gate
    reads the pre-increment frame counter, postfilter.cc:468-473).
    """
    real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
    phi_pair = phi_diag = None
    outs = []
    for t in range(X.shape[0]):
        phi_pair, phi_diag, W = zelinski_step(phi_pair, phi_diag, _time_align(wq, X[t]), t,
                                              alpha, real_mode)
        outs.append(Y[t] * W if t > min_frames else Y[t])
    return torch.stack(outs, dim=0)


def zelinski_args(C: int, alpha: float, pf_type: int, min_frames: int) -> tuple:
    """The Zelinski arguments the CUDA entry points take: alpha, 1 - alpha,
    the gain 2 / (C - 1), the spectral floor, the REAL flag, min_frames."""
    return (alpha, 1.0 - alpha, 2.0 / (C - 1.0), SPECTRAL_FLOOR,
            int(bool(pf_type & PostFilterType.ZELINSKI1_REAL)), min_frames)
