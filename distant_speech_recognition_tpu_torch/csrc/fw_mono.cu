// The whole fixed-weight chain in one kernel: analysis bank -> Y = wqH X ->
// Zelinski postfilter -> synthesis bank, raw samples in, samples out.
//
// Replaces the Pallas TPU kernel models/pallas_fused_scan.py
// analysis_fw_synthesis_pallas (_call_fw_mono / _make_fw_kernel with the
// filterbank stages) of distant_speech_recognition_tpu, and computes what the
// chain of the port's three split kernels computes, operation for operation
// (the same device helpers, the same summation orders):
//   analysis_tm (K1) -> zelinski_apply (K7) -> synthesis_tm (K3),
// i.e. models/fixed_weight.analysis_fw_synthesis.  Neither the input
// spectrum [Tf, B, C, M] nor the beamformed one [Tf, B, M] touches device
// memory.
//
// What bounds the function on an H100: its 0.82 GB of samples in and out at
// B=256 x 4 ch x 10 s, 0.25 ms at 3.35 TB/s; done by FFT, its transforms
// need ~5k flops per 256-point row, 12 GFLOP in all.  What bounds this
// kernel: it does each transform as a dense product, 2*M*M flops per
// analysis row (C rows per frame) and per synthesis row (one per frame),
// 210 GFLOP, 3.1 ms at the FP32 peak.  Design: one block per utterance
// walks the frames in tiles of K = 64 / C frames.  Per tile it
//   1. forms the K*C analysis FIR rows straight from x (as K1 does) in
//      16-column chunks in shared memory and multiplies them by the packed
//      DFT matrix A, streamed from L2 in 16-row chunks (A and S are 256 KB
//      each, more than an SM's shared memory), 8x8 register tiles per
//      thread, into the tile's packed spectra P [K*C, M] in shared memory;
//   2. runs the fixed weights and the Zelinski recursion, one thread per bin,
//      frames in order, the two smoothed sums in that thread's registers for
//      the whole utterance, into the beamformed rows ys [K, M];
//   3. multiplies ys by the packed synthesis matrix S (streamed likewise)
//      into a window of c rows that keeps the previous tile's last m*R - 1
//      rows as its halo (zero before the first frame);
//   4. runs the m-tap synthesis FIR and the R-segment overlap-add from the
//      window and writes D samples for each of its K output frames, which
//      lag the spectrum frames by the synthesis delay pd.
// The grid is B blocks of 256 threads with ~126 KB of shared memory each
// (C = 4), one block per SM.  Plain IEEE FP32 FMA, no TF32, no tensor cores.
#include "dsr_device.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

using namespace dsr;

constexpr int M_ = 256;  // subbands (the kernel is built for M = 256)
constexpr int ROWS = 64;  // analysis rows per tile: K frames x C channels, K = ROWS / C
constexpr int BK = 16;    // reduction chunk of both DFT products
constexpr int WS_LD = ROWS + 4;
constexpr int THREADS = 256;

// shared floats: FIR chunk [BK][WS_LD], A or S chunk [BK][M_], spectra
// [ROWS][M_], beamformed rows [K][M_], c window [halo + K][M_]
size_t smem_bytes(int K, int halo) {
  return sizeof(float) * ((size_t)BK * WS_LD + BK * M_ + ROWS * M_ + K * M_ + (halo + K) * M_);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 1)
fw_mono_kernel(const float* __restrict__ x, const float* __restrict__ hr,
               const float* __restrict__ A, const float* __restrict__ S,
               const float* __restrict__ gf, const float* __restrict__ wq,
               const float* __restrict__ ta, float* __restrict__ out, int T, int Tf, int m, int R,
               int D, int shift, int pd, int T_out, ZelinskiParams p) {
  constexpr int K = ROWS / C;       // frames per tile
  constexpr int KR = (K + 7) / 8;   // synthesis rows per thread
  constexpr int F = M_ / 2 + 1;
  extern __shared__ __align__(16) float smem[];
  float* Ws = smem;
  float* Bs = Ws + BK * WS_LD;
  float* P = Bs + BK * M_;
  float* ys = P + ROWS * M_;
  float* cw = ys + K * M_;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int halo = m * R - 1;
  const int tx = tid % 32;  // columns tx*4 .. +3 and 128 + tx*4 .. +3
  const int ty = tid / 32;  // analysis rows ty*4 .. +3 and 32 + ty*4 .. +3
  const float* xb = x + (size_t)b * C * T;
  float* ob = out + (size_t)b * T_out * D;

  // thread f < F owns bin f: its weights and Zelinski sums for the utterance
  const int f = tid;
  const bool owns_bin = f < F;
  const bool has_im = f >= 1 && f <= F - 2;
  cf wqc[C], tac[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w = owns_bin ? f * C + c : c;
    wqc[c] = {wq[w * 2], wq[w * 2 + 1]};
    tac[c] = {ta[w * 2], -ta[w * 2 + 1]};  // conj(ta)
  }
  cf phi_pair = {0.f, 0.f};
  float phi_diag = 0.f;

  for (int idx = tid; idx < halo * M_; idx += THREADS) cw[idx] = 0.f;

  for (int t0 = 0; t0 < Tf; t0 += K) {
    // 1. analysis: P[tk*C + c] = w[t0 + tk, c] @ A
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < M_; k0 += BK) {
#pragma unroll
      for (int e = 0; e < (ROWS * BK) / THREADS; ++e) {
        const int idx = e * THREADS + tid;
        const int kk = idx % BK;
        const int r = idx / BK;
        const int tk = r / C;
        const int t = t0 + tk;
        Ws[kk * WS_LD + r] = (r < K * C && t < Tf)
            ? analysis_fir(xb + (size_t)(r - tk * C) * T, hr, T, M_, m, D, shift, t, k0 + kk)
            : 0.f;
      }
#pragma unroll
      for (int e = 0; e < (BK * M_) / (4 * THREADS); ++e) {
        const int idx = e * THREADS + tid;
        const int kk = idx / (M_ / 4);
        const int c4 = (idx % (M_ / 4)) * 4;
        *reinterpret_cast<float4*>(Bs + kk * M_ + c4) =
            __ldg(reinterpret_cast<const float4*>(A + (size_t)(k0 + kk) * M_ + c4));
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(Ws + kk * WS_LD + ty * 4);
        const float4 a1 = *reinterpret_cast<const float4*>(Ws + kk * WS_LD + 32 + ty * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * M_ + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * M_ + 128 + tx * 4);
        const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float* row = P + (i < 4 ? ty * 4 + i : 32 + ty * 4 + (i - 4)) * M_;
      *reinterpret_cast<float4*>(row + tx * 4) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(row + 128 + tx * 4) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();

    // 2. fixed weights + Zelinski, one thread per bin, frames in order
    if (owns_bin) {
      for (int tk = 0; tk < K; ++tk) {
        const int t = t0 + tk;
        float* yrow = ys + tk * M_;
        cf Y = {0.f, 0.f};
        if (t < Tf) {
          cf X[C];
#pragma unroll
          for (int c = 0; c < C; ++c) X[c] = packed_bin(P + (tk * C + c) * M_, F, f);
#pragma unroll
          for (int c = 0; c < C; ++c) Y = cadd(Y, cmul(wqc[c], X[c]));
          const float W = zelinski_gain<C>(phi_pair, phi_diag, tac, X, t, p);
          if (t > p.min_frames) Y = cscale(Y, W);
        }
        yrow[f] = Y.r;
        if (has_im) yrow[F + f - 1] = Y.i;
      }
    }
    __syncthreads();

    // 3. synthesis DFT: window row halo + tk = ys[tk] @ S
    float acc2[KR][8];
#pragma unroll
    for (int i = 0; i < KR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc2[i][j] = 0.f;
    for (int k0 = 0; k0 < M_; k0 += BK) {
#pragma unroll
      for (int e = 0; e < (BK * M_) / (4 * THREADS); ++e) {
        const int idx = e * THREADS + tid;
        const int kk = idx / (M_ / 4);
        const int c4 = (idx % (M_ / 4)) * 4;
        *reinterpret_cast<float4*>(Bs + kk * M_ + c4) =
            __ldg(reinterpret_cast<const float4*>(S + (size_t)(k0 + kk) * M_ + c4));
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + kk * M_ + tx * 4);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + kk * M_ + 128 + tx * 4);
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < KR; ++i) {
          const int row = ty + 8 * i;
          const float a = row < K ? ys[row * M_ + k0 + kk] : 0.f;
#pragma unroll
          for (int j = 0; j < 8; ++j) acc2[i][j] = fmaf(a, bv[j], acc2[i][j]);
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < KR; ++i) {
      const int row = ty + 8 * i;
      if (row >= K) continue;
      float* crow = cw + (halo + row) * M_;
      *reinterpret_cast<float4*>(crow + tx * 4) =
          make_float4(acc2[i][0], acc2[i][1], acc2[i][2], acc2[i][3]);
      *reinterpret_cast<float4*>(crow + 128 + tx * 4) =
          make_float4(acc2[i][4], acc2[i][5], acc2[i][6], acc2[i][7]);
    }
    __syncthreads();

    // 4. FIR + overlap-add: output frame u = t0 - pd + ul reads window rows
    //    ul - j + (m-1-k)*R + (R-1), i.e. c[u + pd - j - k*R]
    for (int idx = tid; idx < K * D; idx += THREADS) {
      const int ul = idx / D;
      const int i = idx - ul * D;
      const int u = t0 - pd + ul;
      if (u < 0 || u >= T_out) continue;
      ob[(size_t)u * D + i] = synthesis_sample(gf, cw, M_, m, R, D, ul, u, i);
    }
    __syncthreads();
    // the next tile's halo: this window's last halo rows (K >= halo: no overlap)
    for (int idx = tid; idx < halo * M_; idx += THREADS) cw[idx] = cw[K * M_ + idx];
    __syncthreads();
  }
}

template <int C>
int launch(const float* x, const float* hr, const float* A, const float* S, const float* gf,
           const float* wq, const float* ta, float* out, int B, int T, int Tf, int m, int R,
           int D, int shift, int pd, int T_out, const ZelinskiParams& p, cudaStream_t stream) {
  constexpr int K = ROWS / C;
  const int halo = m * R - 1;
  if (halo > K) return DSR_ERR_ARGS;
  const size_t bytes = smem_bytes(K, halo);
  cudaError_t err = cudaFuncSetAttribute(fw_mono_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fw_mono_kernel<C><<<B, THREADS, bytes, stream>>>(x, hr, A, S, gf, wq, ta, out, T, Tf, m, R, D,
                                                   shift, pd, T_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsr_fw_mono(const float* x, const float* hr, const float* A, const float* S,
                           const float* gf, const float* wq, const float* ta, float* out, int B,
                           int C, int T, int Tf, int M, int m, int R, int D, int shift, int pd,
                           int T_out, int rows, float pf_alpha, float one_minus_pf_alpha,
                           float pf_gain, float spectral_floor, int real_mode, int pf_min_frames,
                           cudaStream_t stream) {
  // rows: the tile the caller's shape rule assumed (fixed_weight.FW_MONO_ROWS)
  if (rows != ROWS || M != M_ || B <= 0 || T <= 0 || Tf <= 0 || m <= 0 || R <= 0 ||
      D * R != M || pd < 0 || T_out <= 0 || T_out + pd != Tf)
    return DSR_ERR_ARGS;
  const ZelinskiParams p = {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                            pf_min_frames};
  switch (C) {
    case 2: return launch<2>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 3: return launch<3>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 4: return launch<4>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 5: return launch<5>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 6: return launch<6>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 7: return launch<7>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 8: return launch<8>(x, hr, A, S, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    default: return DSR_ERR_ARGS;
  }
}
