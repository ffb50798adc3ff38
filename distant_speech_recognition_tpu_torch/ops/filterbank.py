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

The full-band banks (`analysis`, `synthesis` and their half-band forms)
follow the reference literally: reversed sample windows, the m-tap
polyphase FIR over them (`polyphase_fir_plain`) and ``torch.fft``.

These functions are the plain versions of the CUDA kernels in
`ops.filterbank_kernels`, and the specification they are held to.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from . import dft
from .windows import get_window

__all__ = [
    "FilterbankParams",
    "num_analysis_frames",
    "analysis_half_real_tm",
    "synthesis_half_real_tm",
    "unpack_half",
    "pack_half",
    "polyphase_fir_plain",
    "analysis",
    "analysis_half",
    "synthesis",
    "synthesis_half",
    "hermitian_mirror",
    "analysis_frames",
    "analysis_snapshots_half",
    "stft_analysis",
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
    h_rev = analysis_taps(h, p)

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


def analysis_taps(h: torch.Tensor, params: FilterbankParams) -> torch.Tensor:
    """Analysis prototype as ``h_rev [m, M]``: ``h_rev[k, i] = h[k*M + M-1-i]``,
    the FIR taps of the polyphase form in the module docstring."""
    return torch.flip(h.reshape(params.m, params.M), dims=[1])


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


def polyphase_fir_plain(S: torch.Tensor, h_folded: torch.Tensor, m: int, R: int) -> torch.Tensor:
    """Strided m-tap FIR over rows, batched over leading dims:
    ``v[..., t, i] = sum_k h_folded[k, i] * S[..., t + (m-1-k) R, i]`` for
    ``S [..., T + (m-1) R, M]`` -> ``v [..., T, M]``, as m shifted slices
    summed from tap 0 on (the plain version of
    `filterbank_kernels.polyphase_fir`)."""
    T = S.shape[-2] - (m - 1) * R
    if T <= 0:
        raise ValueError(f"S needs more than (m-1)*R = {(m - 1) * R} rows, got {S.shape[-2]}")
    h_folded = torch.as_tensor(h_folded, dtype=S.dtype, device=S.device)
    v = None
    for k in range(m):
        a = (m - 1 - k) * R
        term = h_folded[k] * S[..., a : a + T, :]
        v = term if v is None else v + term
    return v


def _analysis_with(fir, x: torch.Tensor, h, params: FilterbankParams) -> torch.Tensor:
    """FIR output ``v [..., n_frames, M]`` of the full-band analysis bank,
    the m-tap FIR done by ``fir`` (`polyphase_fir_plain` or its kernel)
    over the reversed windows of the zero-history stream ``xx``: row ``t``
    of the FIR's input is ``S[t, i] = xx[(t + laN) D + M - 1 - i]``
    (modulated.cc:375-391)."""
    p = params
    D, M, m, R = p.D, p.M, p.m, p.R
    h = torch.as_tensor(h, dtype=torch.float32, device=x.device)
    if h.shape != (p.N,):
        raise ValueError(f"analysis prototype must have length N=M*m={p.N}, got {tuple(h.shape)}")
    T = x.shape[-1]
    n_frames = num_analysis_frames(p, T)
    hist = (m - 1) * R
    front = (m * R - 1) * D
    # the last window read ends at sample (laN + n_frames + hist - 1) D + M
    end = (p.laN + n_frames + hist - 1) * D + M
    xx = F.pad(x.to(torch.float32), (front, end - front - T))
    S = xx.unfold(-1, M, D)[..., p.laN : p.laN + n_frames + hist, :].flip(-1)
    return fir(S, h.reshape(m, M), m, R)


def _synthesis_with(fir, c: torch.Tensor, g, params: FilterbankParams) -> torch.Tensor:
    """The full-band synthesis bank from the real pre-image ``c [..., T_in,
    M]`` (``Re(fft(Y))``): the m-tap FIR done by ``fir`` over pushed frames
    with stride R (modulated.cc:594-598), then the overlap-add of R
    sample-reversed segments (modulated.cc:603-606); the first
    ``synthesis_delay`` frames prime the bank."""
    p = params
    M, m, R, D = p.M, p.m, p.R, p.D
    pd = p.synthesis_delay
    T_in = c.shape[-2]
    T_out = T_in - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {T_in}")
    g = torch.as_tensor(g, dtype=c.dtype, device=c.device)
    if g.shape != (p.N,):
        raise ValueError(f"synthesis prototype must have length N=M*m={p.N}, got {tuple(g.shape)}")
    hist = (m - 1) * R
    # zero history of (m-1)*R pushed frames; output t reads pushes t + pd - k R
    cp = F.pad(c, (0, 0, hist, 0))
    s = fir(cp[..., pd : pd + T_out + hist, :], g.reshape(m, M).flip(1), m, R)
    sp = F.pad(s, (0, 0, R - 1, 0))
    seg = sp.reshape(sp.shape[:-1] + (R, D)).flip(-1)
    out = None
    for j in range(R):
        term = seg[..., R - 1 - j : R - 1 - j + T_out, R - 1 - j, :]
        out = term if out is None else out + term  # [..., T_out, D]
    return out.reshape(out.shape[:-2] + (T_out * D,))


def analysis(x: torch.Tensor, h, params: FilterbankParams) -> torch.Tensor:
    """Full-band analysis bank: float ``x [..., T]`` -> complex64 subband
    frames ``[..., n_frames, M]``, the reference's unnormalized backward DFT
    ``M * ifft(v)`` of the polyphase FIR output ``v`` (modulated.cc:384-397)."""
    return torch.fft.ifft(_analysis_with(polyphase_fir_plain, x, h, params), dim=-1) * params.M


def analysis_half(x: torch.Tensor, h, params: FilterbankParams) -> torch.Tensor:
    """`analysis` restricted to bins ``0..M/2`` (``[..., n_frames, M//2+1]``):
    ``M * ifft(v)`` of a real ``v`` is ``conj(rfft(v))``."""
    return torch.conj_physical(torch.fft.rfft(_analysis_with(polyphase_fir_plain, x, h, params),
                                              dim=-1))


def synthesis(Y: torch.Tensor, g, params: FilterbankParams) -> torch.Tensor:
    """Full-band synthesis bank: complex ``Y [..., T_in, M]`` -> float
    samples ``[..., (T_in - synthesis_delay) * D]``, from ``Re(fft(Y))``
    (modulated.cc:556-563)."""
    return _synthesis_with(polyphase_fir_plain, torch.fft.fft(Y, dim=-1).real, g, params)


def synthesis_half(Y_half: torch.Tensor, g, params: FilterbankParams) -> torch.Tensor:
    """`synthesis` fed with bins ``0..M/2`` only (``[..., T_in, M//2+1]``):
    ``Re(fft(hermitian_mirror(Y_half)))`` is ``M * irfft(conj(Y_half))``
    (which drops the imaginary parts of DC and Nyquist, as ``Re`` does)."""
    M = params.M
    c = torch.fft.irfft(torch.conj_physical(Y_half), n=M, dim=-1) * M
    return _synthesis_with(polyphase_fir_plain, c, g, params)


def hermitian_mirror(half: torch.Tensor, M: int) -> torch.Tensor:
    """Bins ``0..M/2`` ``[..., M//2+1]`` -> all ``M`` bins by conjugate
    symmetry, as the reference mirrors its beamformer outputs
    (beamformer.cc:1142-1152)."""
    mirror = torch.conj_physical(half[..., 1 : M // 2]).flip(-1)
    return torch.cat([half, mirror], dim=-1)


# the largest M whose half-band analysis `analysis_snapshots_half` runs as
# the DFT matrix product (the JAX package's ``dft.MATMUL_MAX_M``); above it,
# as an FFT
MATMUL_MAX_M = 2048


def analysis_frames(x: torch.Tensor, params: FilterbankParams) -> torch.Tensor:
    """The chronological length-``N`` sample window of every frame: ``x
    [..., T]`` -> ``[..., n_frames, N]``, window ``t`` ending at sample ``(t
    + laN + 1) D - 1`` of the stream with ``N - D`` zeros of history and a
    zero tail (the ring buffer of modulated.cc:363-373)."""
    p = params
    D, N = p.D, p.N
    T = x.shape[-1]
    n_frames = num_analysis_frames(p, T)
    end = (p.laN + n_frames - 1) * D + N  # the last window's end in the padded stream
    xx = F.pad(x, (N - D, max(end - (N - D) - T, 0)))
    return xx.unfold(-1, N, D)[..., p.laN : p.laN + n_frames, :]


def analysis_snapshots_half(x: torch.Tensor, h, params: FilterbankParams) -> torch.Tensor:
    """Analysis bank and snapshot transpose: float32 ``x [..., C, T]`` ->
    complex64 snapshots ``X [..., n_frames, F, C]`` of bins ``0..M/2``
    (``SnapShotArray::update``, beamformer.cc:62): the DFT matrix product
    `analysis_half_real_tm` up to `MATMUL_MAX_M`, `analysis_half` (an FFT)
    above it."""
    F_ = params.M // 2 + 1
    if params.M <= MATMUL_MAX_M:
        # [Tf, ..., C, 2F] -> [..., Tf, 2F, C]
        Yr = analysis_half_real_tm(x, h, params).movedim(0, -3).transpose(-1, -2)
        return torch.complex(Yr[..., :F_, :], Yr[..., F_:, :])
    return analysis_half(x, h, params).movedim(-3, -1)


def stft_analysis(x: torch.Tensor, M: int, r: int = 1, window_type: int = 1) -> torch.Tensor:
    """Plain windowed STFT as a stream (``NormalFFTAnalysisBank``,
    modulated.cc:96-227): float ``x [..., T]`` -> complex ``[..., n_frames,
    M]``, the unnormalized forward DFT of each frame's last ``M`` samples in
    chronological order times the window (0 rectangular, 1 Hamming, 2 Hann;
    `ops.windows.get_window`), frame shift ``M / 2**r``."""
    params = FilterbankParams(M=M, m=1, r=r, delay_compensation_type=0)
    win = torch.as_tensor(get_window(window_type, M), dtype=x.dtype, device=x.device)
    return torch.fft.fft(analysis_frames(x, params) * win, dim=-1)
