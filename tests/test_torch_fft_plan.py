"""The index plan of the FFT kernels' DFT stages (``csrc/dsr_fft.h``), on the CPU.

The CUDA kernels K1 (``analysis_tm.cu`` at M = 256), K3
(``synthesis_tm.cu``), K4/K5 (``gsc_mono.cu``) and K8 (``fw_mono.cu``) do
their 256-point DFTs as FFTs in shared memory; no CUDA runs here, so this
file models their stage plan in torch, step for step: the swizzled 16 x 16 cell
layouts, the (n+1) phase as an input index shift, the radix-4 x 4 16-point
DFTs with their register order, the W256^(g k1) twiddles from
`dft.fft_twiddles`, two real rows per complex FFT and the split back, the
packed lanes and the synthesis segment reversal.  Each plan is held to the
dense matrices the plain versions multiply by (`dft.analysis_matrix_packed`,
`dft.synthesis_half_matrix_packed` with `dft.segment_reversal_perm`) at
1e-6 x max|ref|, so a wrong twiddle, index or sign fails here.  K1's whole
route (its tiles of 64 // C frames x C signals, the FIR rows of
``analysis_fir_tile``, the plan, the split and the packed lanes) is held to
`filterbank.analysis_half_real_tm(packed=True)` at 1e-6.
"""

import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu_torch.ops import dft
from distant_speech_recognition_tpu_torch.ops.filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    analysis_taps,
    num_analysis_frames,
    unpack_half,
)

N = 256
TW = torch.tensor(dft.fft_twiddles(N))
W = torch.complex(TW[0], TW[1])  # e^{-2 pi i e / N}
C1, S1, R2 = TW[0, 16].item(), -TW[1, 16].item(), TW[0, 32].item()
# dft16's twiddles W16^(m2 l1) by register index 4 l1 + m2
W16 = {5: (C1, -S1), 6: (R2, -R2), 7: (S1, -C1), 9: (R2, -R2), 10: (0.0, -1.0),
       11: (-R2, -R2), 13: (S1, -C1), 14: (-R2, -R2), 15: (-C1, S1)}


def cell(r, c):
    return 16 * r + (c ^ r)


def tpos(n):
    return cell(n & 15, n >> 4)


def npos(n):
    return cell(n >> 4, n & 15)


def reg16(k):
    return 4 * (k & 3) + (k >> 2)


def dft4(x0, x1, x2, x3):
    a, b, c, d = x0 + x2, x0 - x2, x1 + x3, x1 - x3
    return a + c, b - 1j * d, a - c, b + 1j * d


def dft16(v):
    v = list(v)
    for m2 in range(4):
        v[m2], v[4 + m2], v[8 + m2], v[12 + m2] = dft4(v[m2], v[4 + m2], v[8 + m2], v[12 + m2])
    for i, (wr, wi) in W16.items():
        v[i] = v[i] * complex(wr, wi)
    for l1 in range(4):
        v[4 * l1:4 * l1 + 4] = dft4(*v[4 * l1:4 * l1 + 4])
    return v


def packed_pair_z(a, b, k):
    if k in (0, N // 2):
        return torch.complex(a[:, k], b[:, k])
    if k < N // 2:
        return torch.complex(a[:, k] - b[:, N // 2 + k], a[:, N // 2 + k] + b[:, k])
    kk = N - k
    return torch.complex(a[:, kk] + b[:, N // 2 + kk], b[:, kk] - a[:, N // 2 + kk])


def fft_rows(buf, from_packed=False):
    """`fft_rows` on a [2P, N] buffer: pair q = rows (2q, 2q+1) = (re, im)."""
    re, im = buf[0::2], buf[1::2]
    re1, im1 = torch.empty_like(re), torch.empty_like(im)
    for g in range(16):
        if from_packed:
            v = [packed_pair_z(re, im, g + 16 * n1) for n1 in range(16)]
        else:
            v = [torch.complex(re[:, cell(g, n1)], im[:, cell(g, n1)]) for n1 in range(16)]
        V = dft16(v)
        for k1 in range(16):
            x = V[reg16(k1)] if k1 == 0 else V[reg16(k1)] * W[g * k1]
            re1[:, cell(g, k1)], im1[:, cell(g, k1)] = x.real, x.imag
    re2, im2 = torch.empty_like(re), torch.empty_like(im)
    for g in range(16):
        V = dft16([torch.complex(re1[:, cell(n2, g)], im1[:, cell(n2, g)]) for n2 in range(16)])
        for k2 in range(16):
            re2[:, cell(k2, g)], im2[:, cell(k2, g)] = V[reg16(k2)].real, V[reg16(k2)].imag
    out = torch.empty_like(buf)
    out[0::2], out[1::2] = re2, im2
    return out


def split_bins(buf):
    """`split_bin` for every row and bin f = 0..N/2: X = (Z[f] + conj(Z[-f]))
    / 2 for the even row of a pair, (Z[f] - conj(Z[-f])) / 2i for the odd."""
    re, im = buf[0::2], buf[1::2]
    a = [npos(f) for f in range(N // 2 + 1)]
    b = [npos((N - f) & (N - 1)) for f in range(N // 2 + 1)]
    out = torch.empty((buf.shape[0], N // 2 + 1), dtype=torch.complex64)
    out[0::2] = torch.complex(0.5 * (re[:, a] + re[:, b]), 0.5 * (im[:, a] - im[:, b]))
    out[1::2] = torch.complex(0.5 * (im[:, a] + im[:, b]), 0.5 * (re[:, b] - re[:, a]))
    return out


def analysis_plan(w):
    """K8 steps 1-2 and the split of step 3: FIR rows -> packed spectra."""
    buf = torch.empty_like(w)
    buf[:, [tpos((n + 1) & (N - 1)) for n in range(N)]] = w
    X = split_bins(fft_rows(buf))
    return torch.cat([X.real, X.imag[:, 1:N // 2]], dim=-1)


def analysis_route(x, h, p, rows=64):
    """K1 at M = 256 on ``x [B, C, T]``: a tile holds K = rows // C frames of
    the C signals of one utterance, row tk*C + c (`analysis_fir_tile`, taps
    in order); its rows are transformed in pairs (`analysis_plan`) and each
    row's packed lanes go to ``out [Tf, B, C, M]``."""
    B, C, T = x.shape
    D, m = p.D, p.m
    Tf = num_analysis_frames(p, T)
    K = rows // C
    shift = p.laN - (m * p.R - 1)
    hr = analysis_taps(torch.from_numpy(h), p)  # [m, N]
    k = torch.arange(N)
    j, i = k // D, k % D
    out = torch.empty((Tf, B, C, N))
    for t0 in range(0, Tf, K):
        P = torch.zeros((B, rows, N))
        for tk in range(min(K, Tf - t0)):
            for tap in range(m):
                s_ = (t0 + tk + shift + j) * D + i + (m - 1 - tap) * N
                ok = (s_ >= 0) & (s_ < T)
                xv = torch.where(ok, x[:, :, s_.clamp(0, T - 1)], torch.zeros(()))
                P[:, tk * C:(tk + 1) * C] += hr[tap] * xv
        n = min(K, Tf - t0)
        spec = analysis_plan(P.reshape(-1, N)).reshape(B, rows, N)[:, :n * C]
        out[t0:t0 + n] = spec.reshape(B, n, C, N).transpose(0, 1)
    return out


@pytest.mark.parametrize("C,fb_kw", [(4, {}), (3, dict(r=2, delay_compensation_type=0)),
                                     (1, dict(m=2))])
def test_analysis_route_matches_plain_analysis(rng, C, fb_kw):
    """K1's route against the plain analysis bank: tiles of 16 / 21 / 64
    frames, a partial last tile, the (n+1) shift, delay modes and decimations."""
    p = FilterbankParams(**{"M": N, "m": 4, "r": 1, "delay_compensation_type": 2, **fb_kw})
    x = torch.from_numpy(rng.standard_normal((2, C, 3000)).astype(np.float32) * 1500)
    h = rng.standard_normal(p.N).astype(np.float32) / 16
    ref = analysis_half_real_tm(x, h, p, packed=True)
    assert ref.shape[0] % (64 // C) != 0
    _close(analysis_route(x, h, p), ref.double())


def put_pair_bin(buf, row, f, A, B):
    re, im = buf[row], buf[row + 1]
    if f in (0, N // 2):
        re[tpos(f)], im[tpos(f)] = A.real, B.real
        return
    re[tpos(f)], im[tpos(f)] = A.real - B.imag, A.imag + B.real
    re[tpos(N - f)], im[tpos(N - f)] = A.real + B.imag, B.real - A.imag


def read_c(buf, R):
    """c as `synthesis_sample` reads it: column (R-1-j) D + i of the reversed
    segments is the FFT's element (R-1-j) D + D-1-i."""
    D = N // R
    cols = [npos(j * D + (D - 1 - i)) for j in range(R) for i in range(D)]
    return buf[:, cols]


def synthesis_plan_packed(Yp, R):
    """K3: packed rows staged raw, the FFT from packed lanes."""
    return read_c(fft_rows(Yp.clone(), from_packed=True), R)


def synthesis_plan_bins(Y, R):
    """K8 steps 3-4: complex half spectra written bin by bin as pairs (a
    zero partner after an odd last row), the FFT from layout T."""
    rows = Y.shape[0] + (Y.shape[0] & 1)
    buf = torch.zeros((rows, N), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.complex64)
    for q in range(0, Y.shape[0], 2):
        for f in range(N // 2 + 1):
            put_pair_bin(buf, q, f, Y[q, f], Y[q + 1, f] if q + 1 < Y.shape[0] else zero)
    return read_c(fft_rows(buf), R)[:Y.shape[0]]


def _close(got, ref):
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


def test_analysis_plan_matches_packed_matrix(rng):
    w = rng.standard_normal((24, N)).astype(np.float32) * 1500
    w[3] = 0.0
    w[5] = 1.0  # DC only
    ref = torch.from_numpy(w).double() @ torch.tensor(dft.analysis_matrix_packed(N)).double()
    _close(analysis_plan(torch.from_numpy(w)), ref)


def _tones_and_impulses():
    """Packed rows of pure tones at bins 0, 1, 64, 127, 128 (Re and Im
    lanes) and the spectra of single impulses."""
    rows = []
    for f in (0, 1, 64, 127, 128):
        for lane in [f] + ([N // 2 + f] if 0 < f < N // 2 else []):
            r = np.zeros(N, np.float32)
            r[lane] = 100.0
            rows.append(r)
    imp = np.zeros((4, N), np.float32)
    imp[np.arange(4), [0, 1, 100, 255]] = 1.0
    A = dft.analysis_matrix_packed(N)
    return np.concatenate([np.stack(rows), imp @ A])


@pytest.mark.parametrize("R", [1, 2, 4])
def test_synthesis_plan_from_packed_rows_matches_matrix(rng, R):
    Yp = np.concatenate([rng.standard_normal((20, N)).astype(np.float32) * 100,
                         _tones_and_impulses()])
    S = dft.synthesis_half_matrix_packed(N)[:, list(dft.segment_reversal_perm(N, R))]
    ref = torch.from_numpy(Yp).double() @ torch.from_numpy(S).double()
    _close(synthesis_plan_packed(torch.from_numpy(Yp), R), ref)


@pytest.mark.parametrize("R,rows", [(2, 12), (1, 9)])
def test_synthesis_plan_from_bins_matches_matrix(rng, R, rows):
    """Complex half spectra whose DC and Nyquist bins carry an Im part (the
    packed layout drops it), an odd row count in one case."""
    Y = (rng.standard_normal((rows, N // 2 + 1))
         + 1j * rng.standard_normal((rows, N // 2 + 1))).astype(np.complex64) * 100
    Yp = torch.cat([torch.from_numpy(Y.real), torch.from_numpy(Y.imag)[:, 1:N // 2]], dim=-1)
    assert torch.equal(unpack_half(Yp).real, torch.from_numpy(Y.real))
    S = dft.synthesis_half_matrix_packed(N)[:, list(dft.segment_reversal_perm(N, R))]
    ref = Yp.double() @ torch.from_numpy(S).double()
    _close(synthesis_plan_bins(torch.from_numpy(Y), R), ref)


def test_twiddle_table_is_float64_rounded():
    e = np.arange(N)
    assert TW.dtype == torch.float32 and TW.shape == (2, N)
    np.testing.assert_array_equal(TW[0].numpy(), np.cos(2 * np.pi * e / N).astype(np.float32))
    np.testing.assert_array_equal(TW[1].numpy(), (-np.sin(2 * np.pi * e / N)).astype(np.float32))
