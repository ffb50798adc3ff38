"""Subband echo cancellation on packed frames, as a hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_aec.py`` (``aec_scan_pallas``).
For a CUDA tensor `aec_scan` launches ``csrc/aec_scan.cu`` or raises; for a
CPU tensor it unpacks the lanes, runs the plain loops `models.aec.nlms_aec`
/ `kalman_aec` (the specification the kernel is held to) and repacks.
"""

from __future__ import annotations

import torch

from ..models.aec import kalman_aec, nlms_aec
from .filterbank import pack_half, unpack_half

__all__ = ["AEC_KINDS", "aec_scan"]

AEC_KINDS = ("nlms", "kalman")


def aec_scan(
    Ap: torch.Tensor,
    Vp: torch.Tensor,
    kind: str = "nlms",
    p1: float = 100.0,
    p2: float = 1.0e-4,
    threshold: float = 100.0,
) -> torch.Tensor:
    """Echo-cancel packed time-major frames: mic ``Ap [Tf, B, C, M]``, far
    end ``Vp [Tf, B, M]`` or ``[Tf, B, 1, M]`` (one reference for every
    channel), float32, ``[Re(0..M/2) | Im(1..M/2-1)]`` lanes.  ``p1``/``p2``
    are delta/epsilon for ``kind="nlms"`` and beta/sigma2 for
    ``kind="kalman"``.  Returns the packed error frames ``[Tf, B, C, M]``."""
    if kind not in AEC_KINDS:
        raise NotImplementedError(f"aec kind {kind!r} is not ported; only {AEC_KINDS}")
    if Ap.dim() != 4:
        raise ValueError(f"Ap must be [Tf, B, C, M], got {tuple(Ap.shape)}")
    if Vp.dim() == 4:
        Vp = Vp[:, :, 0, :]
    Tf, B, C, M = Ap.shape
    if tuple(Vp.shape) != (Tf, B, M):
        raise ValueError(f"Vp must be [Tf, B, M] = {(Tf, B, M)}, got {tuple(Vp.shape)}")
    if Ap.device.type == "cpu":
        fn = nlms_aec if kind == "nlms" else kalman_aec
        E, _ = fn(unpack_half(Vp)[:, :, None, :], unpack_half(Ap), p1, p2, threshold)
        return pack_half(E)
    if Ap.device.type != "cuda":
        raise ValueError(f"aec_scan runs on cpu or cuda tensors, got {Ap.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    Ap = Ap.contiguous()
    Vp = Vp.contiguous()
    check_cuda_tensor("Ap", Ap)
    check_cuda_tensor("Vp", Vp)
    out = torch.empty_like(Ap)
    code = _build.library().dsr_aec_scan(
        Ap.data_ptr(), Vp.data_ptr(), out.data_ptr(), Tf, B, C, M, int(kind == "kalman"),
        p1, p2, threshold, stream_handle(Ap.device),
    )
    _build.check(code, "aec_scan")
    aec_scan.launches += 1
    return out


aec_scan.launches = 0
