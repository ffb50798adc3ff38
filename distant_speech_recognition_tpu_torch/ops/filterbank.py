"""Oversampled DFT-modulated subband filterbanks, time-major, in plain torch.

Counterpart of the JAX package's ``ops/filterbank.py`` for the half-band
packed path of the enhancement pipeline (reference: modulated.cc).

Analysis (``OverSampledDFTAnalysisBank::next``, modulated.cc:375-409): the
signal is cut into D-sample blocks with ``m*R - 1`` zero blocks of history;
for frame ``t`` and block parity ``j`` the m-tap polyphase FIR is::

    w_j[t] = sum_k h_rev[k, jD:(j+1)D] * blocks[laN + t + (m-1-k)R + j]

and the packed half-band DFT is one matrix product,
``Y[t] = sum_j w_j[t] @ A[jD:(j+1)D]`` with ``A = dft.analysis_matrix_packed``.

Synthesis (``OverSampledDFTSynthesisBank::next``, modulated.cc:551-612):
``c = Yp @ S`` (segment reversal baked into S's columns), an m-tap FIR over
pushed frames with stride R, then the R-segment overlap-add; the first
``synthesis_delay`` frames prime the bank and are dropped.

These functions are the plain versions of the CUDA kernels in
`ops.filterbank_kernels`, and the specification they are held to.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import dft

__all__ = [
    "FilterbankParams",
    "num_analysis_frames",
    "analysis_half_real_tm",
    "synthesis_half_real_tm",
    "unpack_half",
    "pack_half",
]


def unpack_half(Yp: torch.Tensor) -> torch.Tensor:
    """Packed real lanes ``[..., M]`` (``[Re(0..M/2) | Im(1..M/2-1)]``) ->
    complex half band ``[..., M/2+1]``; the DC and Nyquist bins have no Im
    lane and come out real."""
    F = Yp.shape[-1] // 2 + 1
    zero = Yp.new_zeros(Yp.shape[:-1] + (1,))
    return torch.complex(Yp[..., :F], torch.cat([zero, Yp[..., F:], zero], dim=-1))


def pack_half(X: torch.Tensor) -> torch.Tensor:
    """Inverse of `unpack_half`: complex ``[..., F]`` -> packed ``[..., 2(F-1)]``
    (the Im parts of the DC and Nyquist bins are dropped)."""
    F = X.shape[-1]
    return torch.cat([X.real, X.imag[..., 1 : F - 1]], dim=-1)


@dataclasses.dataclass(frozen=True)
class FilterbankParams:
    """Static filterbank configuration.

    Mirrors the parameter conventions of ``BaseFilterBank`` (modulated.cc:76-79):
    ``M`` subbands, prototype length ``N = M*m``, decimation ``R = 2**r``,
    frame shift ``D = M / R``.  ``delay_compensation_type`` selects the latency
    bookkeeping of modulated.cc:246-264.
    """

    M: int = 256
    m: int = 4
    r: int = 1
    delay_compensation_type: int = 2

    @property
    def R(self) -> int:
        return 1 << self.r

    @property
    def D(self) -> int:
        return self.M // self.R

    @property
    def N(self) -> int:
        return self.M * self.m

    @property
    def laN(self) -> int:
        """Frames skipped at stream start by the analysis bank (type 2)."""
        if self.delay_compensation_type == 2:
            return self.m * self.R // 2 - 1
        return 0

    @property
    def analysis_delay(self) -> int:
        """Zero frames padded at end of stream by the analysis bank."""
        if self.delay_compensation_type in (1, 2):
            return self.m * self.R - 1
        return 2 * self.m - 1

    @property
    def synthesis_delay(self) -> int:
        """Subband frames consumed to prime the synthesis bank."""
        if self.delay_compensation_type == 1:
            return self.m * self.R - 1
        if self.delay_compensation_type == 2:
            return self.m * self.R // 2
        return 2 * self.m - 1


def num_analysis_frames(params: FilterbankParams, num_samples: int) -> int:
    """Number of subband frames the analysis bank emits for ``num_samples``:
    ``ceil(T/D)`` zero-padded blocks, ``laN`` skipped at the start and
    ``analysis_delay`` zero frames padded at the end (modulated.cc:440-466)."""
    n_blocks = -(-num_samples // params.D)
    return n_blocks - params.laN + params.analysis_delay


def analysis_half_real_tm(
    x: torch.Tensor,
    h,
    params: FilterbankParams,
    packed: bool = False,
    A: torch.Tensor | None = None,
) -> torch.Tensor:
    """Time-major half-band analysis: float32 ``x [..., T]`` ->
    ``Yr [n_frames, ..., Mout]``.

    ``packed=True`` gives ``Mout = M`` lanes ``[Re(0..M/2) | Im(1..M/2-1)]``;
    otherwise ``Mout = 2F`` lanes ``[Re | Im]`` of bins 0..M/2.  ``A`` may
    hold the matching DFT matrix already on ``x``'s device.
    """
    p = params
    D, M, m, R = p.D, p.M, p.m, p.R
    h = torch.as_tensor(h, dtype=x.dtype, device=x.device)
    if h.shape != (p.N,):
        raise ValueError(f"analysis prototype must have length N=M*m={p.N}, got {tuple(h.shape)}")
    if A is None:
        A = analysis_matrix_tensor(M, packed, x.device)
    h_rev = torch.flip(h.reshape(m, M), dims=[1])

    T = x.shape[-1]
    n_blocks = -(-T // D)
    n_frames = num_analysis_frames(p, T)
    front = m * R - 1
    tail = max(n_frames - 1 + p.laN + m * R - (front + n_blocks), 0)
    xx = F.pad(x, (front * D, (n_blocks * D - T) + tail * D))
    blocks = xx.reshape(x.shape[:-1] + (-1, D)).movedim(-2, 0)  # [n_blocks', ..., D]

    Y = None
    for j in range(R):
        w_j = None
        for k in range(m):
            s = p.laN + (m - 1 - k) * R + j
            term = h_rev[k, j * D : (j + 1) * D] * blocks[s : s + n_frames]
            w_j = term if w_j is None else w_j + term
        term = torch.matmul(w_j, A[j * D : (j + 1) * D])
        Y = term if Y is None else Y + term
    return Y


def analysis_matrix_tensor(M: int, packed: bool, device) -> torch.Tensor:
    """`dft.analysis_matrix_packed` (``packed``) or the ``[M, 2F]``
    half-band `dft.analysis_matrix`, as a float32 tensor on ``device``."""
    mat = dft.analysis_matrix_packed(M) if packed else dft.analysis_matrix(M, half=True)
    return torch.tensor(mat, device=device).contiguous()


def synthesis_matrix_tensor(M: int, R: int, device) -> torch.Tensor:
    """Packed synthesis matrix ``[M, M]`` with the segment reversal
    (`dft.segment_reversal_perm`) baked into its columns, on ``device``."""
    perm = list(dft.segment_reversal_perm(M, R))
    return torch.tensor(dft.synthesis_half_matrix_packed(M)[:, perm], device=device).contiguous()


def synthesis_taps(g: torch.Tensor, params: FilterbankParams) -> torch.Tensor:
    """Synthesis prototype as ``gf [m, M]``: ``gf[k, i] = g[(M-1-i) + M k]``
    with the columns permuted like `synthesis_matrix_tensor`.  Reversing
    a row and then each D-segment of it reverses only the segment order:
    ``gf[k, j*D + i] = g[k*M + (R-1-j)*D + i]``."""
    m, R, D = params.m, params.R, params.D
    return torch.flip(g.reshape(m, R, D), dims=[1]).reshape(m, R * D)


def synthesis_half_real_tm(
    Yp: torch.Tensor, g, params: FilterbankParams, S: torch.Tensor | None = None
) -> torch.Tensor:
    """Synthesis of the packed time-major spectrum ``Yp [T_in, ..., M]``
    (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes) -> samples
    ``[..., (T_in - synthesis_delay) * D]``.  ``S`` may hold
    `synthesis_matrix_tensor` already on ``Yp``'s device."""
    p = params
    M, m, R, D = p.M, p.m, p.R, p.D
    pd = p.synthesis_delay
    T_in = Yp.shape[0]
    T_out = T_in - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {T_in}")
    if S is None:
        S = synthesis_matrix_tensor(M, R, Yp.device)
    g = torch.as_tensor(g, dtype=Yp.dtype, device=Yp.device)
    gf = synthesis_taps(g, p)

    c = torch.matmul(Yp, S)  # [T_in, ..., M]
    # zero history of (m-1)*R pushed frames (buffer_ starts zeroed)
    cp = torch.cat([c.new_zeros(((m - 1) * R,) + c.shape[1:]), c], dim=0)
    s = None
    for k in range(m):
        a = pd + (m - 1 - k) * R
        term = gf[k] * cp[a : a + T_out]
        s = term if s is None else s + term  # [T_out, ..., M]

    # overlap-add of R segments (modulated.cc:603-606):
    # out_t = sum_j s_{t-j}[(R-1-j)*D : (R-j)*D]
    sp = torch.cat([s.new_zeros((R - 1,) + s.shape[1:]), s], dim=0)
    seg = sp.reshape(sp.shape[:-1] + (R, D))
    out = None
    for j in range(R):
        term = seg[R - 1 - j : R - 1 - j + T_out, ..., R - 1 - j, :]
        out = term if out is None else out + term  # [T_out, ..., D]
    out = out.movedim(0, -2)  # [..., T_out, D]
    return out.reshape(out.shape[:-2] + (T_out * D,))
