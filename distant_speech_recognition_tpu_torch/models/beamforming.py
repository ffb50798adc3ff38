"""Subband beamforming weights and the fixed-weight beamformer output.

The weights are computed once at build time on the host (complex64 CPU
tensors), as the reference's out-of-loop ``wrapper_weights_calculator``
does; only `array_manifold` and `blocking_matrix` also run in the steered
pipeline's forward pass, batched over utterances, on the input's device.

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

__all__ = [
    "frame_energy_half",
    "array_manifold",
    "blocking_matrix",
    "apply_weights",
    "delay_and_sum_weights",
    "lcmv_weights",
    "diffuse_noise_coherence",
    "noise_coherence_gain",
    "mvdr_weights",
    "superdirective_weights",
]


def frame_energy_half(subbands_half_ch0: torch.Tensor, M: int) -> torch.Tensor:
    """Per-frame energy of the reference channel's full-M spectrum / M
    (``MultiChannelSource.update_snapshot_array(chan_no=0) / fftlen``,
    pybeamformer.py:263-276), from bins ``0..M/2`` only: exact by hermitian
    symmetry, interior bins count twice, DC and Nyquist once."""
    p = torch.abs(subbands_half_ch0) ** 2
    interior = 2.0 * torch.sum(p[..., 1 : M // 2], dim=-1)
    return (p[..., 0] + p[..., M // 2] + interior) / M


def array_manifold(fftlen: int, samplerate: float, delays) -> torch.Tensor:
    """Array manifold vectors for bins ``0..M/2``: complex64 ``vs [..., F, C]``
    from delays ``[..., C]`` (seconds), ``vs[f] = exp(-j 2 pi f Delta_f tau)
    / C`` (calc_array_manifold_f, pybeamformer.py:284-307).  ``delays`` is a
    numpy array (the result is a CPU tensor) or a tensor, whose device the
    result keeps.  The phase is computed in float32."""
    if isinstance(delays, torch.Tensor):
        delays = delays.to(torch.float32)
    else:
        delays = torch.as_tensor(np.asarray(delays), dtype=torch.float32)
    C = delays.shape[-1]
    F = fftlen // 2 + 1
    delta_f = samplerate / float(fftlen)
    k = torch.arange(F, dtype=torch.float32, device=delays.device)
    phase = -2.0 * math.pi * k[:, None] * delta_f * delays[..., None, :]
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


def apply_weights(wqH: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Fixed-weight beamformer output ``Y[..., t, f] = sum_c wqH[f, c]
    X[..., t, f, c]``, summed over channels in order (the order of the CUDA
    kernels).  ``wqH`` is ``[F, C]`` or carries the batch axes that follow
    the frame axis of ``X``."""
    return sum(wqH[..., c] * X[..., c] for c in range(X.shape[-1]))


def delay_and_sum_weights(fftlen: int, samplerate: float, delays) -> torch.Tensor:
    """D&S conjugate weights ``wqH [F, C]`` (SubbandDS, beamformer.cc:1095-1157)."""
    return torch.conj(array_manifold(fftlen, samplerate, delays)).resolve_conj()


# Eigenvalues at or below PINV_EPS_FACTOR x eps x the largest eigenvalue of
# their matrix are rounding, not signal: the pseudo-inverse drops them.
# Measured on LCMV constraint Grams in float32 (tests/probe_lcmv_pinv.py):
# where the manifolds coincide (the aliased bin 110 of a 50 mm linear array,
# bins of a circular one with the jammer at the target's mirror image) the
# smallest eigenvalue comes out of the manifolds' and the Gram's rounding at
# up to 0.87 eps32 x lambda_max in the port and 0.63 eps32 in the JAX
# package, and the smallest that is signal on the tested geometries is
# 5.6e-5 x lambda_max (470 eps32); 8 sits 9x above the first and 59x below
# the second.
PINV_EPS_FACTOR = 8.0


def _pinv_hermitian(R: torch.Tensor, threshold: float) -> torch.Tensor:
    """Batched pseudo-inverse of Hermitian matrices (the reference's LINPACK
    csvdc pinv, beamformer.cc:232-289): eigenvalues with magnitude at or
    below ``max(threshold, PINV_EPS_FACTOR * eps * max|eigenvalue|)`` of
    their matrix are zeroed.  The absolute ``threshold`` is the reference's;
    the relative floor keeps the decision off float rounding, where an
    eigenvalue that is zero in exact arithmetic comes out as a few ulps of
    the largest one (ROADMAP section 3)."""
    w, v = torch.linalg.eigh(R)
    floor = PINV_EPS_FACTOR * torch.finfo(w.dtype).eps * w.abs().amax(-1, keepdim=True)
    inv_w = torch.where(torch.abs(w) > floor.clamp(min=threshold), 1.0 / w, torch.zeros_like(w))
    vw = v * inv_w.to(v.dtype)[..., None, :]
    return vw @ torch.conj(v).transpose(-1, -2)


def lcmv_weights(constraints: torch.Tensor, gains) -> torch.Tensor:
    """LCMV quiescent weights ``wq = C (C^H C)^+ g`` per bin
    (calc_null_beamformer_, beamformer.cc:299-363): ``constraints [..., Nc,
    C]`` are manifold rows (target first, then jammers), ``gains [Nc]`` (1
    for targets, 0 for nulls).  The Gram is inverted through the eigenvalue
    pseudo-inverse `_pinv_hermitian` with the reference's absolute threshold
    of 1e-8 and its relative rounding floor, since it is singular where the
    manifolds coincide (bin 0, and the bins where the array aliases).
    Returns ``wqH [..., C]``."""
    g = torch.as_tensor(np.asarray(gains), dtype=constraints.dtype)
    Cm = constraints.transpose(-1, -2)  # [..., C, Nc]
    gram = torch.conj(constraints) @ Cm  # [..., Nc, Nc]
    inv = _pinv_hermitian(gram, 1.0e-8)
    v = inv @ g[:, None].expand(gram.shape[:-1] + (1,))
    return torch.conj((Cm @ v)[..., 0]).resolve_conj()


def diffuse_noise_coherence(mpos, fftlen: int, samplerate: float,
                            sspeed: float = 343740.0) -> torch.Tensor:
    """Spherically isotropic (diffuse) noise coherence ``Gamma [F, C, C]``,
    ``sinc(2 f d_mn / c)`` with the normalized sinc, computed in float64 and
    stored as complex64 (SubbandMVDR::set_diffuse_noise_model,
    beamformer.cc:2442-2509)."""
    mpos = np.asarray(mpos, dtype=np.float64)[:, :3]
    d = np.sqrt(((mpos[:, None, :] - mpos[None, :, :]) ** 2).sum(-1))  # [C, C]
    F = fftlen // 2 + 1
    freqs = np.arange(F) * samplerate / float(fftlen)
    gamma = np.sinc(2.0 * freqs[:, None, None] * d[None] / sspeed)
    return torch.from_numpy(gamma.astype(np.float32)).to(torch.complex64)


def noise_coherence_gain(Gamma: torch.Tensor, vs: torch.Tensor,
                         threshold: float = 1.0e-8) -> torch.Tensor:
    """``Lambda = d^H Gamma^+ d`` per bin, complex ``[..., F]``, for the
    coherence ``Gamma [..., F, C, C]`` and the manifold ``d = vs [..., F,
    C]``: the array's gain against that noise field, which scales the
    Lefkimmiatis postfilter's noise PSD (postfilter.cc:1098-1161).  The
    pseudo-inverse is `_pinv_hermitian`'s, with the reference's absolute
    ``threshold``; the JAX package drops eigenvalues by that threshold
    alone, the port also at its relative rounding floor, which parts the
    two only where ``Gamma`` is near singular (low bins of a small array,
    not the bins the postfilter reads Lambda at)."""
    invR = _pinv_hermitian(Gamma, threshold)
    tmp = torch.einsum("...ji,...j->...i", torch.conj(invR), vs)
    return torch.sum(torch.conj(tmp) * vs, dim=-1)


def mvdr_weights(R: torch.Tensor, vs: torch.Tensor, dthreshold: float = 1.0e-8) -> torch.Tensor:
    """MVDR conjugate weights ``wqH [F, C]`` from the noise covariance ``R
    [F, C, C]`` and the manifold ``vs [F, C]`` (SubbandMVDR::calc_mvdr_weights,
    beamformer.cc:2350-2402): ``w = R^+ d / (C d^H R^+ d)`` for bins >= 1,
    all ones at bin 0."""
    C = vs.shape[-1]
    invR = _pinv_hermitian(R, dthreshold)
    tmp = torch.einsum("...ji,...j->...i", torch.conj(invR), vs)  # R^+H d
    lam = torch.sum(torch.conj(tmp) * vs, dim=-1, keepdim=True)  # d^H R^+ d
    w = tmp / (lam * C)
    w[..., 0, :] = 1.0
    return torch.conj(w).resolve_conj()


def superdirective_weights(mpos, delays, fftlen: int, samplerate: float,
                           sspeed: float = 343740.0, mu: float = 0.01) -> torch.Tensor:
    """Super-directive MVDR against the diffuse-noise coherence with absolute
    diagonal loading ``mu`` (calc_sd_beamformer_weights, pybeamformer.py:561-586;
    loading per beamformer.cc:2511-2530).  Returns ``wqH [F, C]``."""
    vs = array_manifold(fftlen, samplerate, delays)
    R = diffuse_noise_coherence(mpos, fftlen, samplerate, sspeed)
    R = R + mu * torch.eye(R.shape[-1], dtype=R.dtype)
    return mvdr_weights(R, vs)
