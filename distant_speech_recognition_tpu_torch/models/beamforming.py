"""Subband beamforming weights (the parts the GSC pipeline reads).

Weight/output conventions follow the reference:
  - manifold  vs[f, c]   = exp(-j 2 pi f_k tau_c) / C      (pybeamformer.py:284-307)
  - quiescent wqH        = conj(vs)                        (pybeamformer.py:744, 888)
  - output    Y[t, f]    = sum_c wqH[f, c] X[t, f, c]      (= w^H X, beamformer.cc:1208-1243)
  - bins 0..M/2 computed, rest conjugate-mirrored          (beamformer.cc:1142-1152)
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["frame_energy_half", "array_manifold", "blocking_matrix"]


def frame_energy_half(subbands_half_ch0: torch.Tensor, M: int) -> torch.Tensor:
    """Per-frame energy of the reference channel's full-M spectrum / M
    (``MultiChannelSource.update_snapshot_array(chan_no=0) / fftlen``,
    pybeamformer.py:263-276), from bins ``0..M/2`` only: exact by hermitian
    symmetry, interior bins count twice, DC and Nyquist once."""
    p = torch.abs(subbands_half_ch0) ** 2
    interior = 2.0 * torch.sum(p[..., 1 : M // 2], dim=-1)
    return (p[..., 0] + p[..., M // 2] + interior) / M


def array_manifold(fftlen: int, samplerate: float, delays) -> torch.Tensor:
    """Array manifold vectors for bins ``0..M/2``: complex64 CPU tensor
    ``vs [F, C]``, ``vs[f] = exp(-j 2 pi f Delta_f tau) / C``
    (calc_array_manifold_f, pybeamformer.py:284-307).  The phase is computed
    in float32."""
    delays = torch.as_tensor(np.asarray(delays), dtype=torch.float32)
    C = delays.shape[-1]
    F = fftlen // 2 + 1
    delta_f = samplerate / float(fftlen)
    k = torch.arange(F, dtype=torch.float32)
    phase = -2.0 * math.pi * k[:, None] * delta_f * delays[None, :]
    return torch.exp(1j * phase) / C


def blocking_matrix(vs: torch.Tensor, Nc: int = 1) -> torch.Tensor:
    """Blocking matrix ``B [..., C, C-Nc]`` with ``vs^T B = 0``: perpendicular
    projection + Gram-Schmidt over the first ``C-Nc`` columns
    (calc_blocking_matrix, pybeamformer.py:310-341)."""
    C = vs.shape[-1]
    bsize = C - Nc
    norm_vs = torch.sum(vs * torch.conj(vs), dim=-1, keepdim=True)[..., None]
    eye = torch.eye(C, dtype=vs.dtype, device=vs.device)
    safe = torch.where(torch.abs(norm_vs) > 0, norm_vs, torch.ones_like(norm_vs))
    # PcPerp[i, j] = I - conj(vs_i) vs_j / ||vs||^2
    pc_perp = eye - torch.conj(vs)[..., :, None] * vs[..., None, :] / safe
    cols = []
    for idim in range(bsize):
        vec = pc_perp[..., :, idim]
        for prev in cols:
            ip = torch.sum(torch.conj(prev) * vec, dim=-1, keepdim=True)
            vec = vec - prev * ip
        nrm = torch.sqrt(torch.abs(torch.sum(torch.conj(vec) * vec, dim=-1, keepdim=True)))
        cols.append(vec / torch.where(nrm > 0, nrm, torch.ones_like(nrm)))
    B = torch.stack(cols, dim=-1)
    return torch.where(torch.abs(norm_vs) > 0, B, torch.zeros_like(B))
