// The 256-point DFTs of the filterbank kernels as FFTs in shared memory
// (K1 analysis_tm.cu, K3 synthesis_tm.cu, K4/K5 gsc_mono.cu, K8
// fw_mono.cu), and the analysis FIR rows that K1, K4/K5 and K8 transform
// (`analysis_fir_tile`: one function, so all three form the same sums in the
// same order and pair the same rows in their FFTs).
//
// What they compute (ops/dft.py):
//   - analysis: the packed row Y[f] = e^{-2 pi i f/M} fft(w)[f], f = 0..M/2,
//     of a real FIR row w (`analysis_matrix_packed`).  The phase is an index
//     shift of the input: w[n] is stored as element (n + 1) mod M.
//   - synthesis: c = M irfft(conj(Y)) of a packed row Y
//     (`synthesis_half_matrix_packed`), which is the forward FFT of Y's
//     Hermitian extension; the per-segment sample reversal
//     (`segment_reversal_perm`) is an index map where c is read.
// Both are the same forward 256-point complex FFT, run on two real rows at
// once: the rows (2q, 2q+1) of a buffer hold the real and imaginary parts of
// one complex row (two-for-one), and `split_bin` / `put_pair_bin` convert
// between the pair and its two real rows' spectra.
//
// Stage plan (tests/test_torch_fft_plan.py follows it on the CPU): the 256
// elements of a row are a 16 x 16 matrix of cells; element n sits in cell
// (n % 16, n / 16) before the FFT (layout T) and X[k] in cell (k / 16, k % 16)
// after it (natural layout).  Pass 1: thread g takes cell row g (n = 16 n1 +
// g), a 16-point DFT over n1 (radix 4 x 4, in registers), times the twiddle
// W256^(g k1), back into cells (g, k1).  Pass 2: thread g takes cell column
// g (k1 = g), a 16-point DFT over the rows into cells (k2, g): X[g + 16 k2].
// A pair's 16 threads are one half warp, so the passes synchronise with
// __syncwarp only.  Cells are XOR-swizzled (cell (r, c) at 16 r + (c ^ r))
// and rows are LD = 264 floats apart, so the half warps of a warp (two pairs,
// rows 2 LD apart, 16 banks) and every pass, split and FIR store touch 32
// distinct banks.  Twiddles come from the host's float64 table rounded to
// float32 (dft.fft_twiddles), never from __sinf/__cosf; plain IEEE FP32,
// with the complex products' FMAs written out (`twiddle`).
#pragma once

#include <cuda_runtime.h>

#include "dsr_device.h"

namespace dsr {
namespace fft {

constexpr int N = 256;
constexpr int LD = 264;  // floats per row in shared memory

__device__ __forceinline__ int cell(int r, int c) { return 16 * r + (c ^ r); }
// element n of a row before the FFT (layout T) and after it (natural)
__device__ __forceinline__ int tpos(int n) { return cell(n & 15, n >> 4); }
__device__ __forceinline__ int npos(int n) { return cell(n >> 4, n & 15); }

// cos(pi/8), sin(pi/8), sqrt(1/2): the radix-16 butterflies' own twiddles,
// read from the host's table
struct Consts {
  float c1, s1, r;
};

__device__ __forceinline__ Consts consts(const float* __restrict__ tw) {
  return {__ldg(tw + 16), -__ldg(tw + N + 16), __ldg(tw + 32)};
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// pass 1's twiddles W256^(g k1) from the table [2][N] (cos, -sin of
// 2 pi e / N) into shared memory in the order [2][k1][g], so that the 16
// threads of a pair read 16 consecutive floats (the table's own order puts
// up to four of them in one bank); the caller synchronises the block before
// the first pass
__device__ __forceinline__ void stage_twiddles(float* sm, const float* __restrict__ tw) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int e = (i & 15) * (i >> 4);
    sm[i] = __ldg(tw + e);
    sm[N + i] = __ldg(tw + N + e);
  }
}

// y[l] = sum_m x[m] (-i)^(m l), in place
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1, float& r2,
                                     float& i2, float& r3, float& i3) {
  const float ar = r0 + r2, ai = i0 + i2;
  const float br = r0 - r2, bi = i0 - i2;
  const float cr = r1 + r3, ci = i1 + i3;
  const float dr = r1 - r3, di = i1 - i3;
  r0 = ar + cr;
  i0 = ai + ci;
  r2 = ar - cr;
  i2 = ai - ci;
  r1 = br + di;  // b - i d
  i1 = bi - dr;
  r3 = br - di;  // b + i d
  i3 = bi + dr;
}

// x *= w, each part one product and one FMA written out, so that every
// kernel that inlines the FFT rounds alike (left to the compiler, the
// contraction of a*b - c*d into an FMA differs from kernel to kernel)
__device__ __forceinline__ void twiddle(float& xr, float& xi, float wr, float wi) {
  const float t = fmaf(xr, wr, -(xi * wi));
  xi = fmaf(xr, wi, xi * wr);
  xr = t;
}

// V[k] = sum_n v[n] W16^(n k) in place; V[k] ends at register index
// 4 (k % 4) + k / 4 (`reg16`).  n = 4 m1 + m2, k = l1 + 4 l2.
__device__ __forceinline__ void dft16(float (&r)[16], float (&i)[16], const Consts& k) {
#pragma unroll
  for (int m2 = 0; m2 < 4; ++m2)
    dft4(r[m2], i[m2], r[4 + m2], i[4 + m2], r[8 + m2], i[8 + m2], r[12 + m2], i[12 + m2]);
  // index 4 l1 + m2 holds the m2-th DFT's output l1: times W16^(m2 l1)
  twiddle(r[5], i[5], k.c1, -k.s1);   // W^1
  twiddle(r[6], i[6], k.r, -k.r);     // W^2
  twiddle(r[7], i[7], k.s1, -k.c1);   // W^3
  twiddle(r[9], i[9], k.r, -k.r);     // W^2
  {                                   // W^4 = -i
    const float t = r[10];
    r[10] = i[10];
    i[10] = -t;
  }
  twiddle(r[11], i[11], -k.r, -k.r);  // W^6
  twiddle(r[13], i[13], k.s1, -k.c1); // W^3
  twiddle(r[14], i[14], -k.r, -k.r);  // W^6
  twiddle(r[15], i[15], -k.c1, k.s1); // W^9
#pragma unroll
  for (int l1 = 0; l1 < 4; ++l1)
    dft4(r[4 * l1], i[4 * l1], r[4 * l1 + 1], i[4 * l1 + 1], r[4 * l1 + 2], i[4 * l1 + 2],
         r[4 * l1 + 3], i[4 * l1 + 3]);
}

__host__ __device__ constexpr int reg16(int k) { return 4 * (k & 3) + (k >> 2); }

// Z[k] of the complex row a + i b formed from two packed rows a, b
// ([Re(0..N/2) | Im(1..N/2-1)], raw lanes): the Hermitian extensions of the
// two half spectra, the second times i
__device__ __forceinline__ void packed_pair_z(const float* a, const float* b, int k, float& zr,
                                              float& zi) {
  if (k == 0 || k == N / 2) {
    zr = a[k];
    zi = b[k];
  } else if (k < N / 2) {
    zr = a[k] - b[N / 2 + k];
    zi = a[N / 2 + k] + b[k];
  } else {
    const int kk = N - k;
    zr = a[kk] + b[N / 2 + kk];
    zi = b[kk] - a[N / 2 + kk];
  }
}

// Element k (k = j*D + i, at `pos` = tpos((k + 1) mod N)) of the eight
// analysis FIR rows r0..r0+7 of a frame tile: row r = tk*C + c of `P` (LD
// apart) holds frame t0 + tk of signal c of `xb` (signals T apart), tk < K
// = ROWS / C:
//   w[t, k] = sum_tap hr[tap, k] * x[(t + shift + j)*D + i + (m-1-tap)*N],
// with x zero outside [0, T) (`dsr::analysis_fir`'s sum, taps in order,
// fmaf), rows past K*C and frames past Tf zero.  The taps are outer and
// unrolled, so the thread keeps up to 32 loads of x in flight.
template <int ROWS, int C>
__device__ __forceinline__ void analysis_fir_rows8(float* P, int r0, const float* __restrict__ xb,
                                                   const float* __restrict__ hr, int t0, int Tf,
                                                   int T, int m, int D, int shift, int k,
                                                   int pos) {
  constexpr int K = ROWS / C;
  const int fj = k / D;
  const int fi = k - fj * D;
  float acc[8];
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) acc[rr] = 0.f;
#pragma unroll 4
  for (int tap = 0; tap < m; ++tap) {
    const float hv = __ldg(hr + tap * N + k);
#pragma unroll
    for (int rr = 0; rr < 8; ++rr) {
      const int r = r0 + rr;
      const int tk = r / C;
      const int t = t0 + tk;
      const long long s = (long long)(t + shift + fj) * D + fi + (long long)(m - 1 - tap) * N;
      const float xv = (r < K * C && t < Tf && s >= 0 && s < T)
                           ? __ldg(xb + (size_t)(r - tk * C) * T + s)
                           : 0.f;
      acc[rr] = fmaf(hv, xv, acc[rr]);
    }
  }
#pragma unroll
  for (int rr = 0; rr < 8; ++rr) P[(r0 + rr) * LD + pos] = acc[rr];
}

// The analysis FIR rows of one frame tile at fixed m = MT and R = RT, by
// every thread of a block of THREADS (element k to thread k mod THREADS):
// `analysis_fir_rows8`'s sums, term for term, with each sample of x loaded
// once per chunk of FR = min(CHUNK, K) frames of one signal instead of once
// per (frame, tap).  Frame f of a chunk reads its tap `tap` at sample f +
// (MT-1-tap)*RT of the chunk's FR + (MT-1)*RT consecutive frames, all held
// in registers.
template <int ROWS, int C, int THREADS, int CHUNK, int MT, int RT>
__device__ __forceinline__ void analysis_fir_tile_fixed(float* P, const float* __restrict__ xb,
                                                        const float* __restrict__ hr, int t0,
                                                        int Tf, int T, int shift) {
  constexpr int K = ROWS / C;
  constexpr int D = N / RT;
  constexpr int FR = K < CHUNK ? K : CHUNK;  // frames per chunk
  constexpr int NV = FR + (MT - 1) * RT;     // samples a chunk reads per element
  constexpr int PASSES = (N + THREADS - 1) / THREADS;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int k = threadIdx.x + pass * THREADS;
    if (PASSES * THREADS > N && k >= N) break;
    const int fj = k / D;
    const int fi = k - fj * D;
    const int pos = tpos((k + 1) & (N - 1));
    float hv[MT];
#pragma unroll
    for (int tap = 0; tap < MT; ++tap) hv[tap] = __ldg(hr + tap * N + k);
    for (int c = 0; c < C; ++c) {
      const float* xr = xb + (size_t)c * T;
      for (int f0 = 0; f0 < K; f0 += FR) {
        const long long s0 = (long long)(t0 + f0 + shift + fj) * D + fi;
        float xs[NV];
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const long long s = s0 + (long long)v * D;
          xs[v] = (s >= 0 && s < T) ? __ldg(xr + s) : 0.f;
        }
#pragma unroll
        for (int f = 0; f < FR; ++f) {
          const int tk = f0 + f;
          if (K % FR != 0 && tk >= K) break;
          float acc = 0.f;
#pragma unroll
          for (int tap = 0; tap < MT; ++tap)
            acc = fmaf(hv[tap], xs[f + (MT - 1 - tap) * RT], acc);
          P[(tk * C + c) * LD + pos] = t0 + tk < Tf ? acc : 0.f;
        }
      }
    }
    for (int r = K * C; r < ROWS; ++r) P[r * LD + pos] = 0.f;  // zero partners
  }
}

// The analysis FIR rows of one frame tile (`analysis_fir_rows8` for every
// eight rows), by every thread of a block of THREADS: element k goes to
// thread k mod THREADS, in layout T with the (n+1) phase as an index shift.
// The flagship's m = 4, R = 2 takes `analysis_fir_tile_fixed` (the same
// sums, each sample of x loaded once per chunk of CHUNK frames).
template <int ROWS, int C, int THREADS, int CHUNK>
__device__ __forceinline__ void analysis_fir_tile(float* P, const float* __restrict__ xb,
                                                  const float* __restrict__ hr, int t0, int Tf,
                                                  int T, int m, int D, int shift) {
  if (m == 4 && 2 * D == N) {
    analysis_fir_tile_fixed<ROWS, C, THREADS, CHUNK, 4, 2>(P, xb, hr, t0, Tf, T, shift);
    return;
  }
  constexpr int PASSES = (N + THREADS - 1) / THREADS;
#pragma unroll
  for (int pass = 0; pass < PASSES; ++pass) {
    const int k = threadIdx.x + pass * THREADS;
    if (PASSES * THREADS > N && k >= N) break;
    const int pos = tpos((k + 1) & (N - 1));
    for (int r0 = 0; r0 < ROWS; r0 += 8)
      analysis_fir_rows8<ROWS, C>(P, r0, xb, hr, t0, Tf, T, m, D, shift, k, pos);
  }
}

// In-place forward FFT of `pairs` row pairs, pair q = rows (2q, 2q+1) of
// `rows` (re, im), by the NT threads tid = 0..NT-1 of a warp-aligned set
// (16 per pair).  Input in layout T, or, with FROM_PACKED, two packed half
// spectra per pair in raw lanes (`packed_pair_z`); output in natural layout.
template <bool FROM_PACKED, int NT>
__device__ __forceinline__ void fft_rows(float* rows, int pairs, const float* tc, const float* ts,
                                         const Consts& kc, int tid) {
  const int g = tid & 15;
  for (int q0 = 0; q0 < pairs; q0 += NT / 16) {
    const int q = q0 + (tid >> 4);
    const bool on = q < pairs;
    float* re = rows + (size_t)(2 * q) * LD;
    float* im = re + LD;
    float vr[16], vi[16];
    if (on) {
#pragma unroll
      for (int n1 = 0; n1 < 16; ++n1) {
        if (FROM_PACKED) {
          packed_pair_z(re, im, g + 16 * n1, vr[n1], vi[n1]);
        } else {
          vr[n1] = re[cell(g, n1)];
          vi[n1] = im[cell(g, n1)];
        }
      }
    }
    if (FROM_PACKED) __syncwarp();  // the pair's packed lanes are read before any cell is written
    if (on) {
      dft16(vr, vi, kc);
      re[cell(g, 0)] = vr[0];
      im[cell(g, 0)] = vi[0];
#pragma unroll
      for (int k1 = 1; k1 < 16; ++k1) {
        float xr = vr[reg16(k1)], xi = vi[reg16(k1)];
        twiddle(xr, xi, tc[16 * k1 + g], ts[16 * k1 + g]);
        re[cell(g, k1)] = xr;
        im[cell(g, k1)] = xi;
      }
    }
    __syncwarp();
    if (on) {
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        vr[n2] = re[cell(n2, g)];
        vi[n2] = im[cell(n2, g)];
      }
      dft16(vr, vi, kc);
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        re[cell(k2, g)] = vr[reg16(k2)];
        im[cell(k2, g)] = vi[reg16(k2)];
      }
    }
  }
}

// Bin f of real row r of a transformed pair buffer (pair r / 2 in natural
// layout): the two-for-one split, X = (Z[f] + conj(Z[-f])) / 2 for the even
// row and (Z[f] - conj(Z[-f])) / 2i for the odd one.  DC and Nyquist come
// out real.
__device__ __forceinline__ cf split_bin(const float* rows, int r, int f) {
  const float* re = rows + (size_t)(r & ~1) * LD;
  const float* im = re + LD;
  const int a = npos(f), b = npos((N - f) & (N - 1));
  if (r & 1) return {0.5f * (im[a] + im[b]), 0.5f * (re[b] - re[a])};
  return {0.5f * (re[a] + re[b]), 0.5f * (im[a] - im[b])};
}

// Bins f and N - f of the pair row (layout T) whose FFT gives the synthesis
// rows of the half spectra A (row 2q) and B (row 2q+1); the Im parts of DC
// and Nyquist are dropped, as the packed layout drops them.
__device__ __forceinline__ void put_pair_bin(float* row, int f, cf A, cf B) {
  float* im = row + LD;
  if (f == 0 || f == N / 2) {
    row[tpos(f)] = A.r;
    im[tpos(f)] = B.r;
    return;
  }
  row[tpos(f)] = A.r - B.i;
  im[tpos(f)] = A.i + B.r;
  row[tpos(N - f)] = A.r + B.i;
  im[tpos(N - f)] = B.r - A.i;
}

// The synthesis FIR + overlap-add of local output frames ul = 0..nfr-1,
// frame u = u_first + ul (those outside [0, T_out) skipped), from c rows in
// natural layout, LD apart: local row l holds c[u - ul + pd - (m*R-1) + l],
// so frame u reads rows ul - j + (m-1-k)*R + (R-1):
//   out[u][i] = sum_{j < R, u-j >= 0} sum_k gf[k, col] * c[u + pd - j - k*R][col],
// col = (R-1-j) D + i, summed j outer, k inner (fmaf); column col of the
// reversed segments is c's element (R-1-j) D + D-1-i.  Threads tid =
// 0..nt-1 take (column i, group of S consecutive frames) items in turn:
// each tap is loaded once per S samples and each sample costs one shared
// load and one FMA per tap.
template <int S>
__device__ __forceinline__ void synthesis_frames(const float* __restrict__ gf, const float* cs,
                                                 int m, int R, int D, int nfr, int u_first,
                                                 int T_out, float* __restrict__ ob, int tid,
                                                 int nt) {
  const int items = (nfr + S - 1) / S * D;
  for (int idx = tid; idx < items; idx += nt) {
    const int i = idx % D;
    const int c0 = idx / D * S;
    float o[S];
#pragma unroll
    for (int s = 0; s < S; ++s) o[s] = 0.f;
    for (int j = 0; j < R; ++j) {
      const int col = (R - 1 - j) * D + i;
      const int p = npos((R - 1 - j) * D + (D - 1 - i));
      float sj[S];
#pragma unroll
      for (int s = 0; s < S; ++s) sj[s] = 0.f;
      for (int k = 0; k < m; ++k) {
        const float gv = __ldg(gf + k * N + col);
        const float* row = cs + (c0 - j + (m - 1 - k) * R + (R - 1)) * LD + p;
#pragma unroll
        for (int s = 0; s < S; ++s) sj[s] = fmaf(gv, c0 + s < nfr ? row[s * LD] : 0.f, sj[s]);
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (u_first + c0 + s - j >= 0) o[s] += sj[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int ul = c0 + s;
      const int u = u_first + ul;
      if (ul < nfr && u >= 0 && u < T_out) ob[(size_t)u * D + i] = o[s];
    }
  }
}

}  // namespace fft
}  // namespace dsr
