"""Subband echo cancellation on packed frames, as a hand-written CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_aec.py`` (``aec_scan_pallas``).
For a CUDA tensor `aec_scan` launches ``csrc/aec_scan.cu`` or raises; for a
CPU tensor it unpacks the lanes, runs the plain loops `models.aec.nlms_aec`
/ `kalman_aec` / `block_kalman_aec` (one tap; the specification the kernel
is held to) and repacks.  The kernel runs the one-tap block Kalman as its
Kalman recursion started from ``K = sigmak2``: with one tap the two
recursions are the same, and the kernel keeps K real where the plain loop
carries it complex (its imaginary part is rounding).  The
kernel stages packed rows by 16-byte copies and takes a bin a thread, so it
takes M a multiple of 4 up to `AEC_MAX_M` (the card pipelines run M = 64 to
2048; past 1024 a channel's bins are split between two blocks, and M must
be a multiple of 16); the plain loops take any even M.
"""

from __future__ import annotations

import torch

from ..models.aec import block_kalman_aec, kalman_aec, nlms_aec
from .filterbank import pack_half, unpack_half

__all__ = ["AEC_KINDS", "AEC_MAX_M", "aec_launch_shape", "aec_scan"]

AEC_KINDS = ("nlms", "kalman", "block_kalman")
# the block Kalman's initial state variance (JAX's default, which its pipeline keeps)
SIGMAK2 = 5.0
AEC_MAX_M = 2048


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
    are delta/epsilon for ``kind="nlms"``, beta/sigma2 for ``kind="kalman"``
    and beta/sigmau2 for ``kind="block_kalman"`` (one tap, its state
    variance starting at `SIGMAK2`).  Returns the packed error frames ``[Tf,
    B, C, M]``."""
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
        V, A = unpack_half(Vp)[:, :, None, :], unpack_half(Ap)
        if kind == "block_kalman":
            E, _ = block_kalman_aec(V, A, 1, p1, p2, SIGMAK2, threshold)
        else:
            E, _ = (nlms_aec if kind == "nlms" else kalman_aec)(V, A, p1, p2, threshold)
        return pack_half(E)
    if Ap.device.type != "cuda":
        raise ValueError(f"aec_scan runs on cpu or cuda tensors, got {Ap.device}")
    if M % 4 or not 4 <= M <= AEC_MAX_M or (M > 1024 and M % 16):
        raise NotImplementedError(f"the aec_scan kernel takes M a multiple of 4 in [4, 1024] "
                                  f"or of 16 up to {AEC_MAX_M}, got M = {M}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    Ap = Ap.contiguous()
    Vp = Vp.contiguous()
    check_cuda_tensor("Ap", Ap)
    check_cuda_tensor("Vp", Vp)
    out = torch.empty_like(Ap)
    lib = _build.library()
    args = (Ap.data_ptr(), Vp.data_ptr(), out.data_ptr(), Tf, B, C, M)
    if kind == "block_kalman":
        code = lib.dsr_aec_scan_block_kalman(*args, p1, p2, SIGMAK2, threshold,
                                             stream_handle(Ap.device))
    else:
        code = lib.dsr_aec_scan(*args, int(kind == "kalman"), p1, p2, threshold,
                                stream_handle(Ap.device))
    _build.check(code, "aec_scan")
    aec_scan.launches += 1
    return out


aec_scan.launches = 0


def aec_launch_shape(B: int, C: int, M: int, kind: str = "nlms") -> dict[str, int]:
    """The launch the kernel takes for ``B`` utterances of ``C`` channels and
    ``M`` lanes on the current card: blocks, threads a block, channels a
    block (``cg``; a block takes channels ``c0 .. c0 + cg - 1`` of one
    utterance), dynamic shared memory (bytes), registers a thread, blocks
    per SM.  The block Kalman kind runs the Kalman kind's kernel."""
    import ctypes

    from ..kernels import _build

    if kind not in AEC_KINDS:
        raise NotImplementedError(f"aec kind {kind!r} is not ported; only {AEC_KINDS}")
    keys = ("blocks", "threads", "cg", "smem_bytes", "registers", "blocks_per_sm")
    vals = [ctypes.c_int() for _ in keys]
    code = _build.library().dsr_aec_scan_shape(
        B, C, M, int(kind != "nlms"), *(ctypes.addressof(v) for v in vals))
    _build.check(code, "aec_scan shape")
    return {k: v.value for k, v in zip(keys, vals)}
