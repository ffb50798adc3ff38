"""Acoustic echo cancellation in the subband domain, plain torch.

Counterpart of the JAX package's ``models/aec.py`` for the two scalar
cancellers and the block (multi-tap) Kalman canceller (reference:
aec/aec.cc).  Each is a Python loop over frames that carries per-bin state
``[*S]`` (the block Kalman's ``[*S, N]`` and ``[*S, N, N]``) for every
(utterance, channel, bin) at once.

Conventions (per bin, frame t):
  error   E = A - R V
  gating  update only when |V|^2 > threshold   (update_, aec.cc:34-39); the
          block Kalman reads the newest tap's |V_0|^2

``V``/``A`` are the played-back and recorded subband frames, time leading,
``[T, *Sv]`` / ``[T, *Sa]`` with broadcastable trailing dims: the pipeline
passes ``V [T, B, 1, F]`` against ``A [T, B, C, F]`` (one far-end reference
cancels every channel).  These loops are the plain versions of the CUDA
scan in `ops.aec_kernels` (the block Kalman at one tap), and the
specification it is held to.

The double-talk-detecting, information-filter and square-root
information-filter cancellers are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nlms_aec", "kalman_aec", "block_kalman_aec", "play_taps"]


def _aec_state_shape(V: torch.Tensor, A: torch.Tensor) -> tuple:
    """Per-frame state shape: the broadcast of ``V``'s and ``A``'s trailing dims
    (numpy's rule; ``torch.broadcast_shapes`` imports a second of torch's
    reference ops on its first call)."""
    return tuple(np.broadcast_shapes(tuple(V.shape[1:]), tuple(A.shape[1:])))


def nlms_aec(
    V: torch.Tensor,
    A: torch.Tensor,
    delta: float = 100.0,
    epsilon: float = 1.0e-4,
    threshold: float = 100.0,
):
    """NLMS echo canceller (NLMSAcousticEchoCancellationFeature,
    aec.cc:41-81)::

        E = A - R V
        R <- R - eps |V|^2/(delta + |A|^2) (R - A/V)   if |V|^2 > threshold

    The quotient ``A/V`` divides by ``V`` only where ``|V| > 0`` (by 1
    elsewhere), and the gate picks the update with a select, so a
    speculative inf or NaN on a silent bin never reaches the state.
    Returns ``(E [T, *S], R_final [*S])``.
    """
    shape = _aec_state_shape(V, A)
    R = torch.zeros(shape, dtype=A.dtype, device=A.device)
    E = []
    for Vk, Ak in zip(V, A):
        E.append(Ak - R * Vk)
        v2 = torch.abs(Vk) ** 2
        gate = v2 > threshold
        Gkhat = Ak / torch.where(torch.abs(Vk) > 0, Vk, torch.ones_like(Vk))
        deltaC = (R - Gkhat) * (epsilon * v2 / (delta + torch.abs(Ak) ** 2))
        R = torch.where(gate, R - deltaC, R)
    return torch.stack(E), R


def kalman_aec(
    V: torch.Tensor,
    A: torch.Tensor,
    beta: float = 0.95,
    sigma2: float = 10.0e-4,
    threshold: float = 100.0,
):
    """Scalar Kalman echo canceller per bin
    (KalmanFilterEchoCancellationFeature, aec.cc:118-164), with the
    observation noise smoothed by ``beta`` and process noise ``sigma2``.
    Returns ``(E [T, *S], R_final [*S])``."""
    shape = _aec_state_shape(V, A)
    real = A.real.dtype
    R = torch.zeros(shape, dtype=A.dtype, device=A.device)
    sigma2_v = torch.full(shape, sigma2, dtype=real, device=A.device)
    K_k = torch.full(shape, sigma2, dtype=real, device=A.device)
    E = []
    for Vk, Ak in zip(V, A):
        Ek = Ak - R * Vk
        E.append(Ek)
        v2 = torch.abs(Vk) ** 2
        gate = v2 > threshold
        sv = beta * sigma2_v + (1.0 - beta) * torch.abs(Ek) ** 2
        K_k_k1 = K_k + sigma2
        sigma2_s = v2 * K_k_k1 + sv
        Gk = torch.conj(Vk) * (K_k_k1 / sigma2_s)
        R = torch.where(gate, R + Gk * Ek, R)
        K_new = (1.0 - K_k_k1 * v2 / sigma2_s) * K_k_k1
        sigma2_v = torch.where(gate, sv, sigma2_v)
        K_k = torch.where(gate, K_new, K_k)
    return torch.stack(E), R


def play_taps(V: torch.Tensor, sampleN: int, amp4play: float = 1.0) -> torch.Tensor:
    """Stack the played signal into tap vectors, newest first:
    ``taps[t, ..., n] = amp * V[t - n, ...]`` (zero history).  Time is the
    leading axis, any trailing dims ride along: ``[T, ...] -> [T, ..., N]``."""
    T = V.shape[0]
    Vp = torch.cat([V.new_zeros((sampleN - 1,) + tuple(V.shape[1:])), V]) * amp4play
    return torch.stack([Vp[sampleN - 1 - n : sampleN - 1 - n + T] for n in range(sampleN)],
                       dim=-1)


def block_kalman_aec(
    V: torch.Tensor,
    A: torch.Tensor,
    sampleN: int = 1,
    beta: float = 0.95,
    sigmau2: float = 10.0e-4,
    sigmak2: float = 5.0,
    threshold: float = 100.0,
    amp4play: float = 1.0,
):
    """Multi-tap Kalman echo canceller
    (BlockKalmanFilterEchoCancellationFeature, aec.cc:244-308)::

        E  = A - R . V          (unconjugated, V the N newest far-end frames)
        Kp = K + sigmau2 I
        G  = Kp conj(V) / (Re(V . Kp conj(V)) + sigma_v)
        R += E G;   K = (I - G V^T) Kp                  if |V_0|^2 > threshold

    with ``sigma_v`` smoothed by ``beta`` as in `kalman_aec`.  The state
    starts at ``R = 0``, ``sigma_v = sigmau2`` and ``K = sigmak2 I``; ``K``
    is complex, as the JAX package carries it (its imaginary part is
    rounding).  ``V``/``A``: ``[T, *S]`` broadcastable.  Returns ``(E [T,
    *S], R_final [*S, N])``."""
    N = sampleN
    shape = _aec_state_shape(V, A)
    taps = play_taps(V, N, amp4play)  # [T, *Sv, N]
    real = A.real.dtype
    eye = torch.eye(N, dtype=A.dtype, device=A.device)
    R = torch.zeros(shape + (N,), dtype=A.dtype, device=A.device)
    sigma2_v = torch.full(shape, sigmau2, dtype=real, device=A.device)
    K_k = (sigmak2 * eye).expand(shape + (N, N))
    E = []
    for Vk, Ak in zip(taps, A):
        Ek = Ak - (R * Vk).sum(-1)
        E.append(Ek)
        gate = torch.abs(Vk[..., 0]) ** 2 > threshold
        sv = beta * sigma2_v + (1.0 - beta) * torch.abs(Ek) ** 2
        K_k_k1 = K_k + sigmau2 * eye
        scr = (K_k_k1 * torch.conj(Vk)[..., None, :]).sum(-1)
        sigma2_s = (Vk * scr).sum(-1).real + sv
        Gk = scr / sigma2_s[..., None]
        R_new = R + Ek[..., None] * Gk
        K_new = (eye - Gk[..., :, None] * Vk[..., None, :]) @ K_k_k1
        R = torch.where(gate[..., None], R_new, R)
        sigma2_v = torch.where(gate, sv, sigma2_v)
        K_k = torch.where(gate[..., None, None], K_new, K_k)
    return torch.stack(E), R
