// The N-point DFTs of the filterbank kernels as FFTs in shared memory, N in
// {64, 128, ..., 2048} (K1 analysis_tm.cu and K3 synthesis_tm.cu at every
// such N; K4/K5 gsc_mono.cu and K8 fw_mono.cu at N = 256), and the analysis
// FIR rows that K1, K4/K5 and K8 transform (`analysis_fir_tile`: one
// function, so all three form the same sums in the same order and pair the
// same rows in their FFTs).
//
// What they compute (ops/dft.py):
//   - analysis: the packed row Y[f] = e^{-2 pi i f/N} fft(w)[f], f = 0..N/2,
//     of a real FIR row w (`analysis_matrix_packed`).  The phase is an index
//     shift of the input: w[n] is stored as element (n + 1) mod N.
//   - synthesis: c = N irfft(conj(Y)) of a packed row Y
//     (`synthesis_half_matrix_packed`), which is the forward FFT of Y's
//     Hermitian extension; the per-segment sample reversal
//     (`segment_reversal_perm`) is an index map where c is read.
// Both are the same forward N-point complex FFT, run on two real rows at
// once: the rows (2q, 2q+1) of a buffer hold the real and imaginary parts of
// one complex row (two-for-one), and `split_bin` / `put_pair_bin` convert
// between the pair and its two real rows' spectra.
//
// Stage plan (`Shape<N>`; tests/test_torch_fft_plan.py follows it on the
// CPU at every N).  N <= 256 is a four-step plan on R x Q cells (8 x 8, 8 x
// 16, 16 x 16): element n sits in cell (n % R, n / R) before the FFT (layout
// T) and X[k] in cell (k / Q, k % Q) after it (natural layout).  Pass 1:
// thread g of a pair takes cell row g (n = R n1 + g), a Q-point DFT over n1
// in registers, times the twiddle W_N^(g k1), back into cells (g, k1).  Pass
// 2: cell column k1 (TP = R threads a pair take the Q columns in turn), an
// R-point DFT over the rows into cells (k2, k1): X[k1 + Q k2].  The 8- and
// 16-point DFTs are radix 4 x 2 and 4 x 4 in registers.  N = 512, 1024 and
// 2048 are S = N / 256 sub-rows of 256 points, SUB floats apart (element n
// in sub-row n % S), each run through the 16 x 16 plan by one half warp, and
// a radix-S pass over the sub-rows: X[k + 256 l] = sum_s W_S^(s l) W_N^(s k)
// E_s[k] in place (X[k] in sub-row k / 256, the 256-point natural cell of k %
// 256); at 512 that is the radix-2 butterfly X[k] = E[k] + W512^k O[k],
// X[k + 256] = E[k] - W512^k O[k], at 1024 and 2048 a 4- and 8-point DFT
// in registers after the twiddles.  A pair's TP threads (8, 8, 16, 32; 64
// and 128 above 512) share one warp up to 512, and the passes synchronise
// with __syncwarp; above 512 they are two and four warps, which synchronise
// at a named barrier of their own (`pair_sync`: the kernel's NT threads are
// its whole block, every thread reaching each barrier).  Cells are
// XOR-swizzled (cell (r, c) at Q r + (c ^ r), r < R <= Q) and rows are LD
// floats apart (N + 4; 264 at 256; (S - 1) SUB + 256 above, SUB = 272), so
// that the four, four, two and one pairs of a warp, and the two sub-rows of
// a warp above 256, touch 32 distinct banks in every pass and twiddle read
// (the test checks it).  Cell and element indices are shifts and masks: a signed
// division or remainder by a power of two costs a sign correction each
// time, in the FFT's inner loops.  Twiddles come from the host's float64 table
// of the same N rounded to float32 (dft.fft_twiddles), never from
// __sinf/__cosf; plain IEEE FP32, with the complex products' FMAs written
// out (`twiddle`).  At N = 256 the plan, the arithmetic and its order are
// those K4/K5 and K8 were built with, so they keep their bits
// (tests/probe_filterbank_bits.py, the stored filterbank case).
#pragma once

#include <cuda_runtime.h>

#include "dsr_device.h"

namespace dsr {
namespace fft {

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

template <int N>
struct Shape {
  static_assert(N == 64 || N == 128 || N == 256 || N == 512 || N == 1024 || N == 2048,
                "FFT sizes 64..2048");
  static constexpr int S = N > 256 ? N / 256 : 1;  // sub-rows of 256 points (radix-S pass)
  static constexpr bool SPLIT = S > 1;
  static constexpr int NS = SPLIT ? 256 : N;       // points of a four-step (sub-)row
  static constexpr int R = NS == 256 ? 16 : 8;     // cell rows: pass 1's DFTs, threads
  static constexpr int Q = NS / R;                 // cell columns: pass 2's DFTs
  static constexpr int TP = SPLIT ? 16 * S : R;    // threads a pair
  static constexpr int SUB = SPLIT ? NS + 16 : 0;  // floats from a sub-row to the next
  static constexpr int LD = SPLIT ? (S - 1) * SUB + NS : N == 256 ? 264 : N + 4;  // a row
  static constexpr int TWF = 2 * N;  // twiddle floats in shared memory (`stage_twiddles`)
  static constexpr int LR = ilog2(R), LQ = ilog2(Q), LTP = ilog2(TP), LS = ilog2(S);
};

template <int N>
__host__ __device__ constexpr int ld() {
  return Shape<N>::LD;
}

// cell (r, c), r < R <= Q; index arithmetic in shifts and masks (as
// divisions of a signed index, each costs a sign correction)
template <int N>
__device__ __forceinline__ int cell(int r, int c) {
  return Shape<N>::Q * r + (c ^ r);
}
// element n of a row before the FFT (layout T) and after it (natural)
template <int N>
__device__ __forceinline__ int tpos(int n) {
  using S = Shape<N>;
  if constexpr (S::SPLIT) return (n & (S::S - 1)) * S::SUB + tpos<S::NS>(n >> S::LS);
  else return cell<N>(n & (S::R - 1), n >> S::LR);
}
template <int N>
__device__ __forceinline__ int npos(int n) {
  using S = Shape<N>;
  if constexpr (S::SPLIT) return (n >> ilog2(S::NS)) * S::SUB + npos<S::NS>(n & (S::NS - 1));
  else return cell<N>(n >> S::LQ, n & (S::Q - 1));
}

// cos(pi/8), sin(pi/8), sqrt(1/2): the radix-8 and radix-16 butterflies' own
// twiddles, read from the host's table of N
struct Consts {
  float c1, s1, r;
};

template <int N>
__device__ __forceinline__ Consts consts(const float* __restrict__ tw) {
  return {__ldg(tw + N / 16), -__ldg(tw + N + N / 16), __ldg(tw + N / 8)};
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

// The twiddles from the table tw [2][N] (cos, -sin of 2 pi e / N) into the
// TWF floats at sm: pass 1's W_NS^(g k1) in the order [2][k1][g], so that
// the threads of a pair read consecutive floats (the table's own order puts
// up to four of them in one bank); above 256 (NS = 256) read as W_N^(S g
// k1), then the radix-S pass's W_N^(s k), k < 256, [s - 1][2][k] for s = 1
// .. S - 1.  The caller synchronises the block before the first pass.
template <int N>
__device__ __forceinline__ void stage_twiddles(float* sm, const float* __restrict__ tw) {
  using S = Shape<N>;
  for (int i = threadIdx.x; i < S::NS; i += blockDim.x) {
    const int e = (i & (S::R - 1)) * (i >> S::LR) * (N / S::NS);
    sm[i] = __ldg(tw + e);
    sm[S::NS + i] = __ldg(tw + N + e);
#pragma unroll
    for (int s = 1; s < S::S; ++s) {
      sm[2 * S::NS * s + i] = __ldg(tw + s * i);
      sm[2 * S::NS * s + S::NS + i] = __ldg(tw + N + s * i);
    }
  }
}

// The barrier of one pair's TP threads (thread tid of the fft_rows set):
// the warp's up to 512, else named barrier 1 + tid / TP of TP threads
template <int N>
__device__ __forceinline__ void pair_sync(int tid) {
  using S = Shape<N>;
  if constexpr (S::TP <= 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;" ::"r"(1 + (tid >> S::LTP)), "n"(S::TP) : "memory");
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

// V[k] = sum_n v[n] W8^(n k) in place; V[k] ends at register index
// 2 (k % 4) + k / 4 (`reg8`).  n = 2 m1 + m2, k = l1 + 4 l2.
__device__ __forceinline__ void dft8(float (&r)[8], float (&i)[8], const Consts& k) {
#pragma unroll
  for (int m2 = 0; m2 < 2; ++m2)
    dft4(r[m2], i[m2], r[2 + m2], i[2 + m2], r[4 + m2], i[4 + m2], r[6 + m2], i[6 + m2]);
  // index 2 l1 + 1 holds the odd DFT's output l1: times W8^l1
  twiddle(r[3], i[3], k.r, -k.r);   // W^1
  {                                 // W^2 = -i
    const float t = r[5];
    r[5] = i[5];
    i[5] = -t;
  }
  twiddle(r[7], i[7], -k.r, -k.r);  // W^3
#pragma unroll
  for (int l1 = 0; l1 < 4; ++l1) {
    const float tr = r[2 * l1 + 1], ti = i[2 * l1 + 1];
    r[2 * l1 + 1] = r[2 * l1] - tr;
    i[2 * l1 + 1] = i[2 * l1] - ti;
    r[2 * l1] = r[2 * l1] + tr;
    i[2 * l1] = i[2 * l1] + ti;
  }
}

template <int L>
__device__ __forceinline__ void dft(float (&r)[L], float (&i)[L], const Consts& k) {
  static_assert(L == 8 || L == 16, "8- and 16-point DFTs");
  if constexpr (L == 16) dft16(r, i, k);
  else dft8(r, i, k);
}

// register index of V[k] after dft<L>
template <int L>
__host__ __device__ constexpr int reg(int k) {
  return L == 16 ? 4 * (k & 3) + (k >> 2) : 2 * (k & 3) + (k >> 2);
}

// Z[k] of the complex row a + i b formed from two packed rows a, b
// ([Re(0..N/2) | Im(1..N/2-1)], raw lanes): the Hermitian extensions of the
// two half spectra, the second times i
template <int N>
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
template <int N, int ROWS, int C>
__device__ __forceinline__ void analysis_fir_rows8(float* P, int r0, const float* __restrict__ xb,
                                                   const float* __restrict__ hr, int t0, int Tf,
                                                   int T, int m, int D, int shift, int k,
                                                   int pos) {
  constexpr int K = ROWS / C;
  constexpr int LD = ld<N>();
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

// Threads of a block of THREADS on the N elements of a row: element k to
// thread k mod THREADS (PASSES elements a thread) when N >= THREADS; else
// element tid mod N, and the GROUPS = THREADS / N threads of an element share
// its rows (group `group()`).  `element(pass)`: this thread's element.
template <int N, int THREADS>
struct FirSplit {
  static constexpr int EL = N < THREADS ? N : THREADS;
  static constexpr int GROUPS = THREADS / EL;
  static constexpr int PASSES = (N + THREADS - 1) / THREADS;
  __device__ static int group() { return GROUPS == 1 ? 0 : (int)(threadIdx.x / EL); }
  __device__ static int element(int pass) {
    return (GROUPS == 1 ? (int)threadIdx.x : (int)(threadIdx.x % EL)) + pass * THREADS;
  }
};

// The analysis FIR rows of one frame tile at fixed m = MT and R = RT, by
// every thread of a block of THREADS (`FirSplit`): `analysis_fir_rows8`'s
// sums, term for term, with each sample of x loaded once per chunk of FR =
// min(CHUNK, K) frames of one signal instead of once per (frame, tap).
// Frame f of a chunk reads its tap `tap` at sample f + (MT-1-tap)*RT of the
// chunk's FR + (MT-1)*RT consecutive frames, all held in registers.  The
// chunks of a signal go to an element's GROUPS threads in turn.
template <int N, int ROWS, int C, int THREADS, int CHUNK, int MT, int RT>
__device__ __forceinline__ void analysis_fir_tile_fixed(float* P, const float* __restrict__ xb,
                                                        const float* __restrict__ hr, int t0,
                                                        int Tf, int T, int shift) {
  using SP = FirSplit<N, THREADS>;
  constexpr int LD = ld<N>();
  constexpr int K = ROWS / C;
  constexpr int D = N / RT;
  constexpr int FR = K < CHUNK ? K : CHUNK;  // frames per chunk
  constexpr int NV = FR + (MT - 1) * RT;     // samples a chunk reads per element
  const int gi = SP::group();
#pragma unroll
  for (int pass = 0; pass < SP::PASSES; ++pass) {
    const int k = SP::element(pass);
    if (SP::PASSES * THREADS > N && k >= N) break;
    const int fj = k / D;
    const int fi = k - fj * D;
    const int pos = tpos<N>((k + 1) & (N - 1));
    float hv[MT];
#pragma unroll
    for (int tap = 0; tap < MT; ++tap) hv[tap] = __ldg(hr + tap * N + k);
    for (int c = 0; c < C; ++c) {
      const float* xr = xb + (size_t)c * T;
      for (int f0 = FR * gi; f0 < K; f0 += FR * SP::GROUPS) {
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
    for (int r = K * C + gi; r < ROWS; r += SP::GROUPS) P[r * LD + pos] = 0.f;  // zero partners
  }
}

// The analysis FIR rows of one frame tile (`analysis_fir_rows8` for every
// eight rows), by every thread of a block of THREADS (`FirSplit`: an
// element's GROUPS threads take its eights of rows in turn), in layout T
// with the (n+1) phase as an index shift.  The flagship's m = 4, R = 2
// takes `analysis_fir_tile_fixed` (the same sums, each sample of x loaded
// once per chunk of CHUNK frames).
template <int N, int ROWS, int C, int THREADS, int CHUNK>
__device__ __forceinline__ void analysis_fir_tile(float* P, const float* __restrict__ xb,
                                                  const float* __restrict__ hr, int t0, int Tf,
                                                  int T, int m, int D, int shift) {
  using SP = FirSplit<N, THREADS>;
  if (m == 4 && 2 * D == N) {
    analysis_fir_tile_fixed<N, ROWS, C, THREADS, CHUNK, 4, 2>(P, xb, hr, t0, Tf, T, shift);
    return;
  }
  const int gi = SP::group();
#pragma unroll
  for (int pass = 0; pass < SP::PASSES; ++pass) {
    const int k = SP::element(pass);
    if (SP::PASSES * THREADS > N && k >= N) break;
    const int pos = tpos<N>((k + 1) & (N - 1));
    for (int r0 = 8 * gi; r0 < ROWS; r0 += 8 * SP::GROUPS)
      analysis_fir_rows8<N, ROWS, C>(P, r0, xb, hr, t0, Tf, T, m, D, shift, k, pos);
  }
}

// Pass 1 of the four-step plan of NS points on cell row g of one (sub-)row
// (sre, sim): the Q values of the row (from layout T, or, with FROM_PACKED,
// Z[(g + R n1) * STEP + H] of the pair's packed lanes at (re, im)), a
// Q-point DFT, the twiddles W_NS^(g k1) from tc/ts ([k1][g]), back into the
// row's cells.  The pair's packed lanes are all read before any cell is
// written (`pair_sync` between).
template <int NS, int N, bool FROM_PACKED, int STEP>
__device__ __forceinline__ void pass1(float* sre, float* sim, const float* re, const float* im,
                                      int g, int H, const float* tc, const float* ts,
                                      const Consts& kc, bool on, int tid) {
  using S = Shape<NS>;
  constexpr int R = S::R, Q = S::Q;
  float vr[Q], vi[Q];
  if (on) {
#pragma unroll
    for (int n1 = 0; n1 < Q; ++n1) {
      if (FROM_PACKED) {
        packed_pair_z<N>(re, im, (g + R * n1) * STEP + H, vr[n1], vi[n1]);
      } else {
        vr[n1] = sre[cell<NS>(g, n1)];
        vi[n1] = sim[cell<NS>(g, n1)];
      }
    }
  }
  if (FROM_PACKED) pair_sync<N>(tid);  // the pair's packed lanes are read before any cell is written
  if (on) {
    dft<Q>(vr, vi, kc);
    sre[cell<NS>(g, 0)] = vr[0];
    sim[cell<NS>(g, 0)] = vi[0];
#pragma unroll
    for (int k1 = 1; k1 < Q; ++k1) {
      float xr = vr[reg<Q>(k1)], xi = vi[reg<Q>(k1)];
      twiddle(xr, xi, tc[R * k1 + g], ts[R * k1 + g]);
      sre[cell<NS>(g, k1)] = xr;
      sim[cell<NS>(g, k1)] = xi;
    }
  }
}

// Pass 2 of the four-step plan on cell column c: an R-point DFT over the
// rows, in place
template <int NS>
__device__ __forceinline__ void pass2(float* sre, float* sim, int c, const Consts& kc) {
  constexpr int R = Shape<NS>::R;
  float vr[R], vi[R];
#pragma unroll
  for (int n2 = 0; n2 < R; ++n2) {
    vr[n2] = sre[cell<NS>(n2, c)];
    vi[n2] = sim[cell<NS>(n2, c)];
  }
  dft<R>(vr, vi, kc);
#pragma unroll
  for (int k2 = 0; k2 < R; ++k2) {
    sre[cell<NS>(k2, c)] = vr[reg<R>(k2)];
    sim[cell<NS>(k2, c)] = vi[reg<R>(k2)];
  }
}

// In-place forward N-point FFT of `pairs` row pairs, pair q = rows (2q,
// 2q+1) of `rows` (re, im), by the NT threads tid = 0..NT-1 of a
// warp-aligned set (TP per pair; above N = 512 the NT threads must be the
// whole block, for `pair_sync`'s named barriers), with the twiddles
// `stage_twiddles` put at `tws`.  Input in layout T, or, with FROM_PACKED,
// two packed half spectra per pair in raw lanes (`packed_pair_z`); output
// in natural layout.
template <int N, bool FROM_PACKED, int NT>
__device__ __forceinline__ void fft_rows(float* rows, int pairs, const float* tws,
                                         const Consts& kc, int tid) {
  using S = Shape<N>;
  constexpr int LD = S::LD, NS = S::NS, TP = S::TP;
  const float* tc = tws;
  const float* ts = tws + NS;
  const int g = tid & (TP - 1);
  for (int q0 = 0; q0 < pairs; q0 += NT / TP) {
    const int q = q0 + (tid >> S::LTP);
    const bool on = q < pairs;
    float* re = rows + (size_t)(2 * q) * LD;
    float* im = re + LD;
    if constexpr (!S::SPLIT) {
      pass1<N, N, FROM_PACKED, 1>(re, im, re, im, g, 0, tc, ts, kc, on, tid);
      __syncwarp();
      if (on) {
        if constexpr (S::Q == TP) {
          pass2<N>(re, im, g, kc);
        } else {
#pragma unroll
          for (int b = 0; b < S::Q / TP; ++b) pass2<N>(re, im, g + TP * b, kc);
        }
      }
    } else {
      // half warp h of the pair runs the 256-point plan on sub-row h
      // (elements S j + h)
      const int h = g >> 4;
      float* sre = re + h * S::SUB;
      float* sim = im + h * S::SUB;
      pass1<NS, N, FROM_PACKED, S::S>(sre, sim, re, im, g & 15, h, tc, ts, kc, on, tid);
      pair_sync<N>(tid);
      if (on) pass2<NS>(sre, sim, g & 15, kc);
      pair_sync<N>(tid);
      if constexpr (S::S > 2) {
        // radix S: sub-row s's E_s[k] times W_N^(s k), an S-point DFT over
        // s, X[k + NS l] into sub-row l's cell of k
        if (on) {
#pragma unroll 2
          for (int k = g; k < NS; k += TP) {
            const int p = npos<NS>(k);
            float vr[S::S], vi[S::S];
#pragma unroll
            for (int s = 0; s < S::S; ++s) {
              vr[s] = re[s * S::SUB + p];
              vi[s] = im[s * S::SUB + p];
              if (s > 0) twiddle(vr[s], vi[s], tws[2 * NS * s + k], tws[2 * NS * s + NS + k]);
            }
            if constexpr (S::S == 4) {
              dft4(vr[0], vi[0], vr[1], vi[1], vr[2], vi[2], vr[3], vi[3]);
#pragma unroll
              for (int l = 0; l < 4; ++l) {
                re[l * S::SUB + p] = vr[l];
                im[l * S::SUB + p] = vi[l];
              }
            } else {
              dft8(vr, vi, kc);
#pragma unroll
              for (int l = 0; l < 8; ++l) {
                re[l * S::SUB + p] = vr[reg<8>(l)];
                im[l * S::SUB + p] = vi[reg<8>(l)];
              }
            }
          }
        }
      } else if (on) {
        // radix 2: X[k] = E[k] + W^k O[k] into E's cell, X[k + NS] = E[k] - W^k O[k] into O's
        const float* cc = tws + 2 * NS;
        const float* cs = tws + 3 * NS;
#pragma unroll 4
        for (int k = tid & 31; k < NS; k += 32) {
          const int p = npos<NS>(k);
          const float er = re[p], ei = im[p];
          float orr = re[S::SUB + p], oi = im[S::SUB + p];
          twiddle(orr, oi, cc[k], cs[k]);
          re[p] = er + orr;
          im[p] = ei + oi;
          re[S::SUB + p] = er - orr;
          im[S::SUB + p] = ei - oi;
        }
      }
    }
  }
}

// Bin f of real row r of a transformed pair buffer (pair r / 2 in natural
// layout): the two-for-one split, X = (Z[f] + conj(Z[-f])) / 2 for the even
// row and (Z[f] - conj(Z[-f])) / 2i for the odd one.  DC and Nyquist come
// out real.
template <int N>
__device__ __forceinline__ cf split_bin(const float* rows, int r, int f) {
  const float* re = rows + (size_t)(r & ~1) * ld<N>();
  const float* im = re + ld<N>();
  const int a = npos<N>(f), b = npos<N>((N - f) & (N - 1));
  if (r & 1) return {0.5f * (im[a] + im[b]), 0.5f * (re[b] - re[a])};
  return {0.5f * (re[a] + re[b]), 0.5f * (im[a] - im[b])};
}

// Bins f and N - f of the pair row (layout T) whose FFT gives the synthesis
// rows of the half spectra A (row 2q) and B (row 2q+1); the Im parts of DC
// and Nyquist are dropped, as the packed layout drops them.
template <int N>
__device__ __forceinline__ void put_pair_bin(float* row, int f, cf A, cf B) {
  float* im = row + ld<N>();
  if (f == 0 || f == N / 2) {
    row[tpos<N>(f)] = A.r;
    im[tpos<N>(f)] = B.r;
    return;
  }
  row[tpos<N>(f)] = A.r - B.i;
  im[tpos<N>(f)] = A.i + B.r;
  row[tpos<N>(N - f)] = A.r + B.i;
  im[tpos<N>(N - f)] = B.r - A.i;
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
template <int N, int S>
__device__ __forceinline__ void synthesis_frames(const float* __restrict__ gf, const float* cs,
                                                 int m, int R, int D, int nfr, int u_first,
                                                 int T_out, float* __restrict__ ob, int tid,
                                                 int nt) {
  constexpr int LD = ld<N>();
  const int items = (nfr + S - 1) / S * D;
  for (int idx = tid; idx < items; idx += nt) {
    const int i = idx % D;
    const int c0 = idx / D * S;
    float o[S];
#pragma unroll
    for (int s = 0; s < S; ++s) o[s] = 0.f;
    for (int j = 0; j < R; ++j) {
      const int col = (R - 1 - j) * D + i;
      const int p = npos<N>((R - 1 - j) * D + (D - 1 - i));
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
