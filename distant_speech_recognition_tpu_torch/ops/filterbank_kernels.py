"""Filterbank stages as hand-written CUDA kernels, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``: the fused
``analysis_tm_fused`` / ``synthesis_tm_fused`` TPU kernels of the
time-major packed path, and the strided FIR ``polyphase_fir`` behind the
full-band banks ``analysis_pallas`` / ``synthesis_pallas``
(`analysis_polyphase` / `synthesis_polyphase` here).  For a CUDA tensor
each wrapper launches its kernel (``csrc/analysis_tm.cu``,
``csrc/synthesis_tm.cu``, ``csrc/polyphase_fir.cu``) or raises; for a CPU
tensor it runs the plain torch version in `ops.filterbank`, which is the
specification the kernel is held to.  Layouts are those of the JAX package.
"""

from __future__ import annotations

import functools
import math

import torch

from . import dft
from .filterbank import (
    FilterbankParams,
    _analysis_with,
    _synthesis_with,
    analysis_half_real_tm,
    analysis_taps,
    num_analysis_frames,
    polyphase_fir_plain,
    synthesis_half_real_tm,
    synthesis_taps,
)

__all__ = [
    "prototype_taps",
    "fft_twiddles_tensor",
    "analysis_tm_fused",
    "synthesis_tm_fused",
    "synthesis_tile_rows",
    "polyphase_fir",
    "polyphase_fir_plain",
    "analysis_polyphase",
    "synthesis_polyphase",
]


def prototype_taps(taps, proto, params: FilterbankParams, device) -> torch.Tensor:
    """The contiguous float32 FIR taps ``taps(proto, params)``
    (`filterbank.analysis_taps` or `filterbank.synthesis_taps`) of a
    prototype of length N = M*m, on ``device``: what the filterbank kernels
    read, computed once where a module holds them as buffers."""
    proto = torch.as_tensor(proto, dtype=torch.float32, device=device)
    if proto.shape != (params.N,):
        raise ValueError(f"prototypes must have length N=M*m={params.N}, got {tuple(proto.shape)}")
    return taps(proto, params).contiguous()


@functools.lru_cache(maxsize=None)
def fft_twiddles_tensor(M: int, device: torch.device) -> torch.Tensor:
    """`dft.fft_twiddles` ``[2, M]`` on ``device``, made once per device: the
    table the FFT kernels (K1, K3, K4/K5, K8) read their twiddles from."""
    return torch.tensor(dft.fft_twiddles(M), device=device).contiguous()


def analysis_tm_fused(
    x: torch.Tensor,
    h,
    params: FilterbankParams,
    A: torch.Tensor | None = None,
    hr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Packed time-major analysis bank: float32 ``x [..., T]`` ->
    ``Yr [n_frames, ..., M]`` (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes), equal
    to `ops.filterbank.analysis_half_real_tm(packed=True)`.  ``A`` may hold
    the plain version's `filterbank.analysis_matrix_tensor(M, True, ...)`
    and ``hr`` the kernel's taps `filterbank.analysis_taps(h)` already on
    ``x``'s device.  The kernel takes M in `dft.FFT_SIZES` (64, 128, ...,
    2048; other M raise `NotImplementedError` on a CUDA tensor), does its DFT
    as an FFT from `fft_twiddles_tensor` and never reads ``A``.  Its tiles
    hold ``x.shape[-2]`` signals (the channels of an utterance) when that is
    at most 8, as the one-kernel chains' tiles do, else one."""
    if x.device.type == "cpu":
        return analysis_half_real_tm(x, h, params, packed=True, A=A)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_tm_fused runs on cpu or cuda tensors, got {x.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    p = params
    M, m, D = p.M, p.m, p.D
    if M not in dft.FFT_SIZES:
        raise NotImplementedError(f"analysis_tm_fused on the card takes M in {dft.FFT_SIZES}, "
                                  f"got M={M}")
    if hr is None:
        hr = prototype_taps(analysis_taps, h, p, x.device)
    x = x.contiguous()
    lead = x.shape[:-1]
    T = x.shape[-1]
    BC = math.prod(lead)
    Cg = x.shape[-2] if x.dim() >= 2 and 1 <= x.shape[-2] <= 8 else 1
    Tf = num_analysis_frames(p, T)
    check_cuda_tensor("x", x)
    check_cuda_tensor("hr", hr, (m, M))
    tw = fft_twiddles_tensor(M, x.device)
    out = torch.empty((Tf,) + tuple(lead) + (M,), dtype=torch.float32, device=x.device)
    lib = _build.library()
    code = lib.dsr_analysis_tm(
        x.data_ptr(), hr.data_ptr(), tw.data_ptr(), out.data_ptr(),
        BC // Cg, Cg, T, Tf, M, m, D, p.laN - (m * p.R - 1), stream_handle(x.device),
    )
    _build.check(code, "analysis_tm")
    analysis_tm_fused.launches += 1
    return out


analysis_tm_fused.launches = 0


def synthesis_tile_rows(M: int) -> int:
    """The rows of K3's tile at M in `dft.FFT_SIZES` (``csrc/synthesis_tm.cu``
    `tile_rows`, read back by the card test): output frames plus the m*R - 1
    halo rows, so K3 takes m*R <= this.  ~70 KB of shared memory at M <= 256,
    88 KB at 512, 214 and 224 KB at 1024 and 2048 (m*R = 32 at 1024, 16 at
    2048 with output frames left over)."""
    return {64: 256, 128: 128, 256: 64, 512: 40, 1024: 48, 2048: 24}[M]


def synthesis_tm_fused(
    Yp: torch.Tensor,
    g,
    params: FilterbankParams,
    S: torch.Tensor | None = None,
    gf: torch.Tensor | None = None,
) -> torch.Tensor:
    """Synthesis bank on the packed time-major spectrum ``Yp [T_in, ..., M]``
    -> samples ``[..., (T_in - synthesis_delay) * D]``, equal to
    `ops.filterbank.synthesis_half_real_tm`.  ``S`` may hold the plain
    version's `filterbank.synthesis_matrix_tensor` and ``gf`` the taps
    `filterbank.synthesis_taps(g)` already on ``Yp``'s device; the kernel
    takes M in `dft.FFT_SIZES` with m*R <= `synthesis_tile_rows(M)` (other
    shapes raise `NotImplementedError` on a CUDA tensor), does the DFT as
    an FFT from `fft_twiddles_tensor` and never reads ``S``."""
    if Yp.device.type == "cpu":
        return synthesis_half_real_tm(Yp, g, params, S=S)
    if Yp.device.type != "cuda":
        raise ValueError(f"synthesis_tm_fused runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    p = params
    M, m, R, D = p.M, p.m, p.R, p.D
    if M not in dft.FFT_SIZES or m * R > synthesis_tile_rows(M):
        raise NotImplementedError(
            f"synthesis_tm_fused on the card takes M in {dft.FFT_SIZES} and m*R up to K3's "
            f"tile rows (`synthesis_tile_rows`), got M={M}, m*R={m * R}")
    pd = p.synthesis_delay
    T_in = Yp.shape[0]
    T_out = T_in - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {T_in}")
    if gf is None:
        gf = prototype_taps(synthesis_taps, g, p, Yp.device)
    tw = fft_twiddles_tensor(M, Yp.device)
    lead = Yp.shape[1:-1]
    B = math.prod(lead)
    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    check_cuda_tensor("gf", gf, (m, M))
    out = torch.empty(tuple(lead) + (T_out * D,), dtype=torch.float32, device=Yp.device)
    lib = _build.library()
    code = lib.dsr_synthesis_tm(
        Yp.data_ptr(), tw.data_ptr(), gf.data_ptr(), out.data_ptr(),
        T_in, B, M, m, R, D, pd, T_out, stream_handle(Yp.device),
    )
    _build.check(code, "synthesis_tm")
    synthesis_tm_fused.launches += 1
    return out


synthesis_tm_fused.launches = 0


def polyphase_fir(S: torch.Tensor, h_folded, m: int, R: int) -> torch.Tensor:
    """Strided m-tap FIR over rows, batched over leading dims:
    ``v[..., t, i] = sum_k h_folded[k, i] * S[..., t + (m-1-k) R, i]`` for
    float32 ``S [..., T + (m-1) R, M]`` -> ``v [..., T, M]`` (m <= 8 on the
    card), equal to `ops.filterbank.polyphase_fir_plain` rounding for
    rounding."""
    if S.device.type == "cpu":
        return polyphase_fir_plain(S, h_folded, m, R)
    if S.device.type != "cuda":
        raise ValueError(f"polyphase_fir runs on cpu or cuda tensors, got {S.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    M = S.shape[-1]
    T = S.shape[-2] - (m - 1) * R
    if T <= 0:
        raise ValueError(f"S needs more than (m-1)*R = {(m - 1) * R} rows, got {S.shape[-2]}")
    h = torch.as_tensor(h_folded, dtype=torch.float32, device=S.device).contiguous()
    S = S.contiguous()
    check_cuda_tensor("S", S)
    check_cuda_tensor("h_folded", h, (m, M))
    lead = tuple(S.shape[:-2])
    out = torch.empty(lead + (T, M), dtype=torch.float32, device=S.device)
    code = _build.library().dsr_polyphase_fir(
        S.data_ptr(), h.data_ptr(), out.data_ptr(), math.prod(lead), T, M, m, R,
        stream_handle(S.device),
    )
    _build.check(code, "polyphase_fir")
    polyphase_fir.launches += 1
    return out


polyphase_fir.launches = 0


def analysis_polyphase(x: torch.Tensor, h, params: FilterbankParams) -> torch.Tensor:
    """`ops.filterbank.analysis` with its FIR stage as `polyphase_fir` (the
    kernel on a CUDA tensor): ``x [..., T]`` -> complex64 ``[..., n_frames,
    M]``.  Counterpart of the JAX package's ``filterbank.analysis_pallas``;
    the DFT stays ``torch.fft``."""
    return torch.fft.ifft(_analysis_with(polyphase_fir, x, h, params), dim=-1) * params.M


def synthesis_polyphase(Y: torch.Tensor, g, params: FilterbankParams) -> torch.Tensor:
    """`ops.filterbank.synthesis` with its FIR stage as `polyphase_fir`:
    complex ``Y [..., T_in, M]`` -> samples ``[..., (T_in - synthesis_delay)
    * D]``.  Counterpart of the JAX package's ``filterbank.synthesis_pallas``."""
    return _synthesis_with(polyphase_fir, torch.fft.fft(Y, dim=-1).real, g, params)
