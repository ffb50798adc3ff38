"""The index plan of the FFT kernels' DFT stages (``csrc/dsr_fft.h``), on the CPU.

The CUDA kernels K1 (``analysis_tm.cu``) and K3 (``synthesis_tm.cu``) at
N = M in {64, 128, ..., 2048}, and K4/K5 (``gsc_mono.cu``) and K8
(``fw_mono.cu``) at N = 256, do their N-point DFTs as FFTs in shared memory;
no CUDA runs here, so this file models their stage plan (`Shape<N>`) in
torch, step for step, at every N: the swizzled R x Q cell layouts (8 x 8,
8 x 16, 16 x 16; above 256 N / 256 sub-rows of 16 x 16 and a radix-2, 4 or
8 pass), the (n+1) phase as an input index shift, the radix-4 x 2 and 4 x 4
8- and 16-point DFTs with their register order, the pass-1 twiddles
W_N^(g k1) and the radix pass's W_N^(s k) from `dft.fft_twiddles`, two real
rows per complex
FFT and the split back, the packed lanes and the synthesis segment
reversal.  Each plan is held to the dense matrices the plain versions
multiply by (`dft.analysis_matrix_packed`, `dft.synthesis_half_matrix_packed`
with `dft.segment_reversal_perm`) at 1e-6 x max|ref|, so a wrong twiddle,
index or sign fails here.  K1's whole route (its tiles of 64 * 256 / N // C
frames x C signals, the FIR rows of ``analysis_fir_tile``, the plan, the
split and the packed lanes) is held to
`filterbank.analysis_half_real_tm(packed=True)` at 1e-6.  The shared-memory
addresses that the 32 lanes of a warp touch in each pass and twiddle read
fall in 32 distinct banks (or are one address, a broadcast) at every N.
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

SIZES = (64, 128, 256, 512, 1024, 2048)


class Shape:
    """`dsr::fft::Shape<N>`: R x Q cells of a four-step (sub-)row of NS
    points, TP threads a pair, S sub-rows SUB floats apart (N > 256), LD
    floats a row."""

    def __init__(self, N):
        self.N = N
        self.S = N // 256 if N > 256 else 1
        self.split = self.S > 1
        self.NS = 256 if self.split else N
        self.R = 16 if self.NS == 256 else 8
        self.Q = self.NS // self.R
        self.TP = 16 * self.S if self.split else self.R
        self.SUB = self.NS + 16 if self.split else 0
        self.LD = (self.S - 1) * self.SUB + self.NS if self.split else (
            264 if N == 256 else N + 4)
        self.width = (self.S - 1) * self.SUB + self.NS  # floats of a row the plan touches


def cell(N, r, c):
    s = Shape(N)
    assert 0 <= r < s.R <= s.Q and 0 <= c < s.Q
    return s.Q * r + (c ^ r)


def tpos(N, n):
    s = Shape(N)
    if s.split:
        return (n % s.S) * s.SUB + tpos(s.NS, n // s.S)
    return cell(N, n % s.R, n // s.R)


def npos(N, n):
    s = Shape(N)
    if s.split:
        return (n // s.NS) * s.SUB + npos(s.NS, n % s.NS)
    return cell(N, n // s.Q, n % s.Q)


def twiddles(N):
    tw = torch.tensor(dft.fft_twiddles(N))
    return tw, torch.complex(tw[0], tw[1])  # e^{-2 pi i e / N}


def dft4(x0, x1, x2, x3):
    a, b, c, d = x0 + x2, x0 - x2, x1 + x3, x1 - x3
    return a + c, b - 1j * d, a - c, b + 1j * d


def consts(N):
    """`consts<N>`: cos(pi/8), sin(pi/8), sqrt(1/2) from the table of N."""
    tw, _ = twiddles(N)
    return tw[0, N // 16].item(), -tw[1, N // 16].item(), tw[0, N // 8].item()


def dft16(v, kc):
    c1, s1, r2 = kc
    # dft16's twiddles W16^(m2 l1) by register index 4 l1 + m2
    w16 = {5: (c1, -s1), 6: (r2, -r2), 7: (s1, -c1), 9: (r2, -r2), 10: (0.0, -1.0),
           11: (-r2, -r2), 13: (s1, -c1), 14: (-r2, -r2), 15: (-c1, s1)}
    v = list(v)
    for m2 in range(4):
        v[m2], v[4 + m2], v[8 + m2], v[12 + m2] = dft4(v[m2], v[4 + m2], v[8 + m2], v[12 + m2])
    for i, (wr, wi) in w16.items():
        v[i] = v[i] * complex(wr, wi)
    for l1 in range(4):
        v[4 * l1:4 * l1 + 4] = dft4(*v[4 * l1:4 * l1 + 4])
    return v


def dft8(v, kc):
    r2 = kc[2]
    v = list(v)
    for m2 in range(2):
        v[m2], v[2 + m2], v[4 + m2], v[6 + m2] = dft4(v[m2], v[2 + m2], v[4 + m2], v[6 + m2])
    for i, (wr, wi) in {3: (r2, -r2), 5: (0.0, -1.0), 7: (-r2, -r2)}.items():
        v[i] = v[i] * complex(wr, wi)
    for l1 in range(4):
        a, b = v[2 * l1], v[2 * l1 + 1]
        v[2 * l1], v[2 * l1 + 1] = a + b, a - b
    return v


def dft_regs(v, kc):
    return dft16(v, kc) if len(v) == 16 else dft8(v, kc)


def reg(L, k):
    return 4 * (k & 3) + (k >> 2) if L == 16 else 2 * (k & 3) + (k >> 2)


def packed_pair_z(N, a, b, k):
    if k in (0, N // 2):
        return torch.complex(a[:, k], b[:, k])
    if k < N // 2:
        return torch.complex(a[:, k] - b[:, N // 2 + k], a[:, N // 2 + k] + b[:, k])
    kk = N - k
    return torch.complex(a[:, kk] + b[:, N // 2 + kk], b[:, kk] - a[:, N // 2 + kk])


def four_step(N, src, dst, off, h, from_packed):
    """Passes 1 and 2 of the NS-point plan on the (sub-)row at ``off`` of the
    pairs: ``src`` / ``dst`` = (re, im) of [P, width] each."""
    s = Shape(N)
    NS, R, Q, step = s.NS, s.R, s.Q, N // s.NS
    kc = consts(N)
    _, W = twiddles(N)
    mid = torch.empty((src[0].shape[0], NS), dtype=torch.complex64)
    for g in range(R):
        if from_packed:
            v = [packed_pair_z(N, *src, (g + R * n1) * step + h) for n1 in range(Q)]
        else:
            v = [torch.complex(src[0][:, off + cell(NS, g, n1)], src[1][:, off + cell(NS, g, n1)])
                 for n1 in range(Q)]
        V = dft_regs(v, kc)
        for k1 in range(Q):
            x = V[reg(Q, k1)]
            mid[:, cell(NS, g, k1)] = x if k1 == 0 else x * W[g * k1 * step]
    for c in range(Q):
        V = dft_regs([mid[:, cell(NS, n2, c)] for n2 in range(R)], kc)
        for k2 in range(R):
            dst[0][:, off + cell(NS, k2, c)] = V[reg(R, k2)].real
            dst[1][:, off + cell(NS, k2, c)] = V[reg(R, k2)].imag


def fft_rows(N, buf, from_packed=False):
    """`fft_rows<N>` on a [2P, width] buffer: pair q = rows (2q, 2q+1) = (re, im)."""
    s = Shape(N)
    src = (buf[0::2], buf[1::2])
    dst = (src[0].clone(), src[1].clone())
    for h in range(s.S):
        four_step(N, src, dst, h * s.SUB, h, from_packed)
    if s.S == 2:  # radix 2: X[k] = E[k] + W^k O[k], X[k + NS] = E[k] - W^k O[k]
        _, W = twiddles(N)
        p = [npos(s.NS, k) for k in range(s.NS)]
        po = [s.SUB + q for q in p]
        E = torch.complex(dst[0][:, p], dst[1][:, p])
        O = torch.complex(dst[0][:, po], dst[1][:, po]) * W[:s.NS]
        dst[0][:, p], dst[1][:, p] = (E + O).real, (E + O).imag
        dst[0][:, po], dst[1][:, po] = (E - O).real, (E - O).imag
    elif s.split:  # radix S: X[k + NS l] = sum_s W_S^(s l) W_N^(s k) E_s[k]
        _, W = twiddles(N)
        p = [npos(s.NS, k) for k in range(s.NS)]
        k = torch.arange(s.NS)
        v = []
        for h in range(s.S):
            po = [h * s.SUB + q for q in p]
            e = torch.complex(dst[0][:, po], dst[1][:, po])
            v.append(e if h == 0 else e * W[h * k])
        V = dft4(*v) if s.S == 4 else [dft8(v, consts(N))[reg(8, l)] for l in range(8)]
        for l in range(s.S):
            po = [l * s.SUB + q for q in p]
            dst[0][:, po], dst[1][:, po] = V[l].real, V[l].imag
    out = torch.empty_like(buf)
    out[0::2], out[1::2] = dst
    return out


def split_bins(N, buf):
    """`split_bin` for every row and bin f = 0..N/2: X = (Z[f] + conj(Z[-f]))
    / 2 for the even row of a pair, (Z[f] - conj(Z[-f])) / 2i for the odd."""
    re, im = buf[0::2], buf[1::2]
    a = [npos(N, f) for f in range(N // 2 + 1)]
    b = [npos(N, (N - f) & (N - 1)) for f in range(N // 2 + 1)]
    out = torch.empty((buf.shape[0], N // 2 + 1), dtype=torch.complex64)
    out[0::2] = torch.complex(0.5 * (re[:, a] + re[:, b]), 0.5 * (im[:, a] - im[:, b]))
    out[1::2] = torch.complex(0.5 * (im[:, a] + im[:, b]), 0.5 * (re[:, b] - re[:, a]))
    return out


def analysis_plan(N, w):
    """K1's steps 1-2 and the split of step 3: FIR rows -> packed spectra."""
    buf = torch.zeros((w.shape[0], Shape(N).width))
    buf[:, [tpos(N, (n + 1) & (N - 1)) for n in range(N)]] = w
    X = split_bins(N, fft_rows(N, buf))
    return torch.cat([X.real, X.imag[:, 1:N // 2]], dim=-1)


def analysis_route(x, h, p):
    """K1 on ``x [B, C, T]``: a tile holds K = rows // C frames of the C
    signals of one utterance, rows = 64 * 256 / M, row tk*C + c
    (`analysis_fir_tile`, taps in order); its rows are transformed in pairs
    (`analysis_plan`) and each row's packed lanes go to ``out [Tf, B, C,
    M]``."""
    B, C, T = x.shape
    N, D, m = p.M, p.D, p.m
    rows = 64 * 256 // N
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
        spec = analysis_plan(N, P.reshape(-1, N)).reshape(B, rows, N)[:, :n * C]
        out[t0:t0 + n] = spec.reshape(B, n, C, N).transpose(0, 1)
    return out


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("C,fb_kw", [(4, {}), (3, dict(r=2, delay_compensation_type=0)),
                                     (1, dict(m=2))])
def test_analysis_route_matches_plain_analysis(rng, N, C, fb_kw):
    """K1's route against the plain analysis bank at every N: tiles of
    64 * 256 / N // C frames, a partial last tile, the (n+1) shift, delay
    modes and decimations."""
    p = FilterbankParams(**{"M": N, "m": 4, "r": 1, "delay_compensation_type": 2, **fb_kw})
    K = 64 * 256 // N // C
    T = 3000
    while num_analysis_frames(p, T) % K == 0:
        T += p.D
    x = torch.from_numpy(rng.standard_normal((2, C, T)).astype(np.float32) * 1500)
    h = rng.standard_normal(p.N).astype(np.float32) / 16
    ref = analysis_half_real_tm(x, h, p, packed=True)
    assert ref.shape[0] % K != 0
    _close(analysis_route(x, h, p), ref.double())


def put_pair_bin(N, buf, row, f, A, B):
    re, im = buf[row], buf[row + 1]
    if f in (0, N // 2):
        re[tpos(N, f)], im[tpos(N, f)] = A.real, B.real
        return
    re[tpos(N, f)], im[tpos(N, f)] = A.real - B.imag, A.imag + B.real
    re[tpos(N, N - f)], im[tpos(N, N - f)] = A.real + B.imag, B.real - A.imag


def read_c(N, buf, R):
    """c as `synthesis_frames` reads it: column (R-1-j) D + i of the reversed
    segments is the FFT's element (R-1-j) D + D-1-i."""
    D = N // R
    cols = [npos(N, j * D + (D - 1 - i)) for j in range(R) for i in range(D)]
    return buf[:, cols]


def synthesis_plan_packed(N, Yp, R):
    """K3: packed rows staged raw, the FFT from packed lanes."""
    buf = torch.zeros((Yp.shape[0], Shape(N).width))
    buf[:, :N] = Yp
    return read_c(N, fft_rows(N, buf, from_packed=True), R)


def synthesis_plan_bins(N, Y, R):
    """K4/K8 steps 3-4: complex half spectra written bin by bin as pairs (a
    zero partner after an odd last row), the FFT from layout T."""
    rows = Y.shape[0] + (Y.shape[0] & 1)
    buf = torch.zeros((rows, Shape(N).width), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.complex64)
    for q in range(0, Y.shape[0], 2):
        for f in range(N // 2 + 1):
            put_pair_bin(N, buf, q, f, Y[q, f], Y[q + 1, f] if q + 1 < Y.shape[0] else zero)
    return read_c(N, fft_rows(N, buf), R)[:Y.shape[0]]


def _close(got, ref):
    err = (got.double() - ref).abs().max().item()
    assert err <= 1e-6 * ref.abs().max().item(), (err, ref.abs().max().item())


@pytest.fixture(scope="module")
def rng():
    return np.random.default_rng(1234)


@pytest.mark.parametrize("N", SIZES)
def test_analysis_plan_matches_packed_matrix(rng, N):
    w = rng.standard_normal((24, N)).astype(np.float32) * 1500
    w[3] = 0.0
    w[5] = 1.0  # DC only
    ref = torch.from_numpy(w).double() @ torch.tensor(dft.analysis_matrix_packed(N)).double()
    _close(analysis_plan(N, torch.from_numpy(w)), ref)


def _tones_and_impulses(N):
    """Packed rows of pure tones at bins 0, 1, N/4, N/2 - 1, N/2 (Re and Im
    lanes) and the spectra of single impulses."""
    rows = []
    for f in (0, 1, N // 4, N // 2 - 1, N // 2):
        for lane in [f] + ([N // 2 + f] if 0 < f < N // 2 else []):
            r = np.zeros(N, np.float32)
            r[lane] = 100.0
            rows.append(r)
    imp = np.zeros((4, N), np.float32)
    imp[np.arange(4), [0, 1, N // 3, N - 1]] = 1.0
    A = dft.analysis_matrix_packed(N)
    return np.concatenate([np.stack(rows), imp @ A])


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("R", [1, 2, 4])
def test_synthesis_plan_from_packed_rows_matches_matrix(rng, N, R):
    Yp = np.concatenate([rng.standard_normal((20, N)).astype(np.float32) * 100,
                         _tones_and_impulses(N)])
    S = dft.synthesis_half_matrix_packed(N)[:, list(dft.segment_reversal_perm(N, R))]
    ref = torch.from_numpy(Yp).double() @ torch.from_numpy(S).double()
    _close(synthesis_plan_packed(N, torch.from_numpy(Yp), R), ref)


@pytest.mark.parametrize("N", SIZES)
@pytest.mark.parametrize("R,rows", [(2, 12), (1, 9)])
def test_synthesis_plan_from_bins_matches_matrix(rng, N, R, rows):
    """Complex half spectra whose DC and Nyquist bins carry an Im part (the
    packed layout drops it), an odd row count in one case."""
    Y = (rng.standard_normal((rows, N // 2 + 1))
         + 1j * rng.standard_normal((rows, N // 2 + 1))).astype(np.complex64) * 100
    Yp = torch.cat([torch.from_numpy(Y.real), torch.from_numpy(Y.imag)[:, 1:N // 2]], dim=-1)
    assert torch.equal(unpack_half(Yp).real, torch.from_numpy(Y.real))
    S = dft.synthesis_half_matrix_packed(N)[:, list(dft.segment_reversal_perm(N, R))]
    ref = Yp.double() @ torch.from_numpy(S).double()
    _close(synthesis_plan_bins(N, torch.from_numpy(Y), R), ref)


@pytest.mark.parametrize("N", SIZES)
def test_twiddle_table_is_float64_rounded(N):
    tw, _ = twiddles(N)
    e = np.arange(N)
    assert tw.dtype == torch.float32 and tw.shape == (2, N)
    np.testing.assert_array_equal(tw[0].numpy(), np.cos(2 * np.pi * e / N).astype(np.float32))
    np.testing.assert_array_equal(tw[1].numpy(), (-np.sin(2 * np.pi * e / N)).astype(np.float32))
    # the butterflies' constants are the same float32 values at every N
    assert consts(N) == consts(256)


def _warp_accesses(N):
    """Every shared-memory access of the plan's passes as the 32 lanes of a
    warp issue it: (name, [address of each lane]).  Lane l is thread l % TP
    of pair l // TP, whose rows start 2 LD (l // TP) floats in; twiddle
    reads index the staged tables [k1][g] and, above 256, [s][k].  Above
    512 a pair is TP / 32 warps: warp w's half warps take sub-rows 2w and
    2w + 1, and its lanes k = 32 w + l, + TP, ... of the radix pass."""
    s = Shape(N)
    lanes = range(32)
    if not s.split:
        R, Q, TP = s.R, s.Q, s.TP
        base = [2 * s.LD * (l // TP) for l in lanes]
        acc = [(f"pass 1 cells (g, {n1})", [b + cell(N, l % TP, n1) for b, l in zip(base, lanes)])
               for n1 in range(Q)]
        acc += [(f"pass 1 twiddle k1={k1}", [R * k1 + l % TP for l in lanes]) for k1 in range(Q)]
        acc += [(f"pass 2 cells ({n2}, c + {TP * b_})",
                 [b + cell(N, n2, l % TP + TP * b_) for b, l in zip(base, lanes)])
                for b_ in range(Q // TP) for n2 in range(R)]
        return acc
    acc = []
    for w in range(s.TP // 32):
        half = [(2 * w + ((l >> 4) & 1)) * s.SUB for l in lanes]
        acc += [(f"warp {w} pass 1 cells (g, {n1})",
                 [o + cell(256, l & 15, n1) for o, l in zip(half, lanes)]) for n1 in range(16)]
        acc += [(f"warp {w} pass 1 twiddle k1={k1}", [16 * k1 + (l & 15) for l in lanes])
                for k1 in range(16)]
        acc += [(f"warp {w} pass 2 cells ({n2}, g)",
                 [o + cell(256, n2, l & 15) for o, l in zip(half, lanes)]) for n2 in range(16)]
        for i in range(256 // s.TP):
            ks = [32 * w + l + s.TP * i for l in lanes]
            for h in range(s.S):
                acc.append((f"warp {w} radix {s.S} sub-row {h}, k = {32 * w} + l + {s.TP * i}",
                            [h * s.SUB + npos(256, k) for k in ks]))
                if h > 0:
                    acc.append((f"warp {w} radix {s.S} twiddle {h}, k = {32 * w} + l + {s.TP * i}",
                                [2 * 256 * h + k for k in ks]))
    return acc


@pytest.mark.parametrize("N", SIZES)
def test_plan_passes_touch_distinct_banks(N):
    """Each pass's and twiddle read's addresses of a warp fall in 32
    distinct banks of 4 bytes, or are one address for several lanes (a
    broadcast): no access of the plan waits on a bank conflict."""
    for name, addrs in _warp_accesses(N):
        by_bank = {}
        for a in addrs:
            by_bank.setdefault(a % 32, set()).add(a)
        worst = max(len(v) for v in by_bank.values())
        assert worst == 1, (N, name, worst)
    s = Shape(N)
    assert s.LD % 4 == 0 and s.LD >= s.width  # 16-byte rows for cp.async, room for the plan
