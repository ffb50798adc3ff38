// The whole fixed-weight chain in one kernel: analysis bank -> Y = wqH X ->
// Zelinski postfilter -> synthesis bank, raw samples in, samples out.
//
// Replaces the Pallas TPU kernel models/pallas_fused_scan.py
// analysis_fw_synthesis_pallas (_call_fw_mono / _make_fw_kernel with the
// filterbank stages) of distant_speech_recognition_tpu, and computes what
// models/fixed_weight.analysis_fw_synthesis's plain chain computes (and the
// port's split kernels analysis_tm (K1) -> zelinski_apply (K7) ->
// synthesis_tm (K3), within rounding: K3 pairs its rows in its FFT
// otherwise).
// Neither the input spectrum [Tf, B, C, M] nor the beamformed one [Tf, B, M]
// touches device memory.
//
// What bounds the function on an H100: its 0.82 GB of samples in and out at
// B=256 x 4 ch x 10 s, 0.25 ms at 3.35 TB/s; its FFTs need ~5k flops per
// 256-point row, 12 GFLOP in all, 0.18 ms at the FP32 peak.  Design: one
// block per utterance walks the frames in tiles of K = 64 / C frames.  Per
// tile it
//   1. forms the K*C analysis FIR rows straight from x into the tile's rows
//      P [64][LD] in shared memory, in the FFT's input layout with the (n+1)
//      phase as an index shift (dsr::fft::analysis_fir_tile, as K1 and K4
//      form them);
//   2. runs the analysis FFT in place, two rows per complex FFT
//      (csrc/dsr_fft.h);
//   3. runs the fixed weights and the Zelinski recursion, one thread per bin,
//      frames in order, the two smoothed sums in that thread's registers for
//      the whole utterance, reading each bin with the two-for-one split and
//      writing the beamformed bins of two frames as one synthesis pair into
//      a window of c rows that keeps the previous tile's last m*R - 1 rows
//      as its halo (zero before the first frame);
//   4. runs the synthesis FFT in place on the window's new rows;
//   5. runs the m-tap synthesis FIR and the R-segment overlap-add from the
//      window and writes D samples for each of its K output frames, which
//      lag the spectrum frames by the synthesis delay pd.
// Nothing is streamed from device memory but x and the taps (through L1)
// and the 2 KB twiddle table (once).  The grid is B blocks of 256 threads
// with 94 KB of shared memory at C = 4 (111 KB at C = 2, m*R = 8), two
// blocks per SM, so one block's serial Zelinski frames overlap the other's
// FIR and FFTs; what is left is mostly the serial Zelinski frames (PERF.md).
// Plain IEEE FP32, no TF32, no tensor cores.
#include "dsr_device.h"
#include "dsr_fft.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

using namespace dsr;
constexpr int M_ = 256;  // subbands (the kernel is built for M = 256)
constexpr int LD = fft::ld<M_>();
constexpr int ROWS = 64;    // analysis rows per tile: K frames x C channels, K = ROWS / C
constexpr int THREADS = 256;

// window rows: halo + K, and a spare zero partner row when K is odd
constexpr int window_rows(int K, int halo) { return halo + K + (K & 1); }

// shared floats: twiddles [2][M], analysis rows [ROWS][LD], c window
size_t smem_bytes(int K, int halo) {
  return sizeof(float) * (2 * M_ + (size_t)(ROWS + window_rows(K, halo)) * LD);
}

template <int C>
__global__ void __launch_bounds__(THREADS, 2)
fw_mono_kernel(const float* __restrict__ x, const float* __restrict__ hr,
               const float* __restrict__ tw, const float* __restrict__ gf,
               const float* __restrict__ wq, const float* __restrict__ ta,
               float* __restrict__ out, int T, int Tf, int m, int R, int D, int shift, int pd,
               int T_out, ZelinskiParams p) {
  constexpr int K = ROWS / C;       // frames per tile
  constexpr int KP = (K + 1) / 2;   // synthesis row pairs per tile
  constexpr int F = M_ / 2 + 1;
  extern __shared__ __align__(16) float smem[];
  float* tc = smem;
  float* ts = tc + M_;
  float* P = ts + M_;
  float* cw = P + ROWS * LD;

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int halo = m * R - 1;
  const float* xb = x + (size_t)b * C * T;
  float* ob = out + (size_t)b * T_out * D;

  // thread f < F owns bin f: its weights and Zelinski sums for the utterance
  const int f = tid;
  const bool owns_bin = f < F;
  cf wqc[C], tac[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int w = owns_bin ? f * C + c : c;
    wqc[c] = {wq[w * 2], wq[w * 2 + 1]};
    tac[c] = {ta[w * 2], -ta[w * 2 + 1]};  // conj(ta)
  }
  cf phi_pair = {0.f, 0.f};
  float phi_diag = 0.f;

  fft::stage_twiddles<M_>(smem, tw);
  const fft::Consts kc = fft::consts<M_>(tw);
  for (int idx = tid; idx < halo * LD; idx += THREADS) cw[idx] = 0.f;

  for (int t0 = 0; t0 < Tf; t0 += K) {
    // 1. analysis FIR rows: row tk*C + c, element n at (n + 1) mod M
    fft::analysis_fir_tile<M_, ROWS, C, THREADS, 16>(P, xb, hr, t0, Tf, T, m, D, shift);
    __syncthreads();
    // 2. analysis FFT, rows (2q, 2q+1) as one complex row
    fft::fft_rows<M_, false, THREADS>(P, ROWS / 2, tc, kc, tid);
    __syncthreads();

    // 3. fixed weights + Zelinski, one thread per bin, frames in order;
    //    frames (2q, 2q+1) of the tile become window pair q
    if (owns_bin) {
      cf Ya = {0.f, 0.f};
      for (int tk = 0; tk < K; ++tk) {
        const int t = t0 + tk;
        cf Y = {0.f, 0.f};
        if (t < Tf) {
          cf X[C];
#pragma unroll
          for (int c = 0; c < C; ++c) X[c] = fft::split_bin<M_>(P, tk * C + c, f);
#pragma unroll
          for (int c = 0; c < C; ++c) Y = cadd(Y, cmul(wqc[c], X[c]));
          const float W = zelinski_gain<C>(phi_pair, phi_diag, tac, X, t, p);
          if (t > p.min_frames) Y = cscale(Y, W);
        }
        if (tk & 1) {
          fft::put_pair_bin<M_>(cw + (halo + tk - 1) * LD, f, Ya, Y);
        } else {
          Ya = Y;
          if (tk == K - 1) fft::put_pair_bin<M_>(cw + (halo + tk) * LD, f, Ya, {0.f, 0.f});
        }
      }
    }
    __syncthreads();

    // 4. synthesis FFT of the window's new rows
    fft::fft_rows<M_, false, THREADS>(cw + halo * LD, KP, tc, kc, tid);
    __syncthreads();

    // 5. FIR + overlap-add: output frame u = t0 - pd + ul reads window rows
    //    ul - j + (m-1-k)*R + (R-1), i.e. c[u + pd - j - k*R]
    fft::synthesis_frames<M_, 4>(gf, cw, m, R, D, K, t0 - pd, T_out, ob, tid, THREADS);
    __syncthreads();
    // the next tile's halo: this window's last halo rows (K >= halo: no overlap)
    for (int idx = tid; idx < halo * LD; idx += THREADS) cw[idx] = cw[K * LD + idx];
    __syncthreads();
  }
}

template <int C>
int launch(const float* x, const float* hr, const float* tw, const float* gf,
           const float* wq, const float* ta, float* out, int B, int T, int Tf, int m, int R,
           int D, int shift, int pd, int T_out, const ZelinskiParams& p, cudaStream_t stream) {
  constexpr int K = ROWS / C;
  const int halo = m * R - 1;
  if (halo > K) return DSR_ERR_ARGS;
  const size_t bytes = smem_bytes(K, halo);
  cudaError_t err = cudaFuncSetAttribute(fw_mono_kernel<C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  fw_mono_kernel<C><<<B, THREADS, bytes, stream>>>(x, hr, tw, gf, wq, ta, out, T, Tf, m, R, D,
                                                   shift, pd, T_out, p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsr_fw_mono(const float* x, const float* hr, const float* tw, const float* gf,
                           const float* wq, const float* ta, float* out, int B, int C, int T,
                           int Tf, int M, int m, int R, int D, int shift, int pd, int T_out,
                           int rows, float pf_alpha, float one_minus_pf_alpha,
                           float pf_gain, float spectral_floor, int real_mode, int pf_min_frames,
                           cudaStream_t stream) {
  // rows: the tile the caller's shape rule assumed (fixed_weight.FW_MONO_ROWS)
  if (rows != ROWS || M != M_ || B <= 0 || T <= 0 || Tf <= 0 || m <= 0 || R <= 0 ||
      D * R != M || pd < 0 || T_out <= 0 || T_out + pd != Tf)
    return DSR_ERR_ARGS;
  const ZelinskiParams p = {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                            pf_min_frames};
  switch (C) {
    case 2: return launch<2>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 3: return launch<3>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 4: return launch<4>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 5: return launch<5>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 6: return launch<6>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 7: return launch<7>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    case 8: return launch<8>(x, hr, tw, gf, wq, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    default: return DSR_ERR_ARGS;
  }
}
