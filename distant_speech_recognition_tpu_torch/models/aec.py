"""Acoustic echo cancellation in the subband domain, plain torch.

Counterpart of the JAX package's ``models/aec.py`` for the two scalar
cancellers (reference: aec/aec.cc).  Each is a Python loop over frames that
carries per-bin state ``[*S]`` for every (utterance, channel, bin) at once.

Conventions (per bin, frame t):
  error   E = A - R V
  gating  update only when |V|^2 > threshold   (update_, aec.cc:34-39)

``V``/``A`` are the played-back and recorded subband frames, time leading,
``[T, *Sv]`` / ``[T, *Sa]`` with broadcastable trailing dims: the pipeline
passes ``V [T, B, 1, F]`` against ``A [T, B, C, F]`` (one far-end reference
cancels every channel).  These loops are the plain versions of the CUDA
scan in `ops.aec_kernels`, and the specification it is held to.

The block (multi-tap) Kalman, double-talk-detecting, information-filter and
square-root information-filter cancellers are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["nlms_aec", "kalman_aec"]


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
