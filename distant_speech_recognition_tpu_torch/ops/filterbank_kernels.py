"""Filterbank stages as hand-written CUDA kernels, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py`` (the fused
``analysis_tm_fused`` / ``synthesis_tm_fused`` TPU kernels).  For a CUDA
tensor each wrapper launches its kernel (``csrc/analysis_tm.cu``,
``csrc/synthesis_tm.cu``) or raises; for a CPU tensor it runs the plain
torch version in `ops.filterbank`, which is the specification the kernel is
held to.  Layouts are those of the JAX package: time-major, packed lanes.
"""

from __future__ import annotations

import math

import torch

from .filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    analysis_matrix_tensor,
    analysis_taps,
    num_analysis_frames,
    synthesis_half_real_tm,
    synthesis_matrix_tensor,
    synthesis_taps,
)

__all__ = ["analysis_tm_fused", "synthesis_tm_fused"]


def analysis_tm_fused(
    x: torch.Tensor, h, params: FilterbankParams, A: torch.Tensor | None = None
) -> torch.Tensor:
    """Packed time-major analysis bank: float32 ``x [..., T]`` ->
    ``Yr [n_frames, ..., M]`` (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes), equal
    to `ops.filterbank.analysis_half_real_tm(packed=True)`.  ``A`` may hold
    `filterbank.analysis_matrix_tensor(M, True, ...)` already on ``x``'s
    device."""
    if x.device.type == "cpu":
        return analysis_half_real_tm(x, h, params, packed=True, A=A)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_tm_fused runs on cpu or cuda tensors, got {x.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    p = params
    M, m, D = p.M, p.m, p.D
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    if h.shape != (p.N,):
        raise ValueError(f"analysis prototype must have length N=M*m={p.N}, got {tuple(h.shape)}")
    if A is None:
        A = analysis_matrix_tensor(M, True, x.device)
    x = x.contiguous()
    hr = analysis_taps(h, p).contiguous()
    lead = x.shape[:-1]
    T = x.shape[-1]
    BC = math.prod(lead)
    Tf = num_analysis_frames(p, T)
    check_cuda_tensor("x", x)
    check_cuda_tensor("A", A, (M, M))
    out = torch.empty((Tf,) + tuple(lead) + (M,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    code = lib.dsr_analysis_tm(
        x.data_ptr(), hr.data_ptr(), A.data_ptr(), out.data_ptr(),
        BC, T, Tf, M, m, D, p.laN - (m * p.R - 1), stream_handle(x.device),
    )
    _build.check(code, "analysis_tm")
    analysis_tm_fused.launches += 1
    return out


analysis_tm_fused.launches = 0


def synthesis_tm_fused(
    Yp: torch.Tensor, g, params: FilterbankParams, S: torch.Tensor | None = None
) -> torch.Tensor:
    """Synthesis bank on the packed time-major spectrum ``Yp [T_in, ..., M]``
    -> samples ``[..., (T_in - synthesis_delay) * D]``, equal to
    `ops.filterbank.synthesis_half_real_tm`.  ``S`` may hold
    `filterbank.synthesis_matrix_tensor` already on ``Yp``'s device."""
    if Yp.device.type == "cpu":
        return synthesis_half_real_tm(Yp, g, params, S=S)
    if Yp.device.type != "cuda":
        raise ValueError(f"synthesis_tm_fused runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    p = params
    M, m, R, D = p.M, p.m, p.R, p.D
    pd = p.synthesis_delay
    T_in = Yp.shape[0]
    T_out = T_in - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {T_in}")
    if S is None:
        S = synthesis_matrix_tensor(M, R, Yp.device)
    g = torch.as_tensor(g, dtype=torch.float32, device=Yp.device)
    gf = synthesis_taps(g, p).contiguous()
    lead = Yp.shape[1:-1]
    B = math.prod(lead)
    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    check_cuda_tensor("S", S, (M, M))
    out = torch.empty(tuple(lead) + (T_out * D,), dtype=torch.float32, device=Yp.device)
    lib = _build.library()
    code = lib.dsr_synthesis_tm(
        Yp.data_ptr(), S.data_ptr(), gf.data_ptr(), out.data_ptr(),
        T_in, B, M, m, R, D, pd, T_out, stream_handle(Yp.device),
    )
    _build.check(code, "synthesis_tm")
    synthesis_tm_fused.launches += 1
    return out


synthesis_tm_fused.launches = 0
