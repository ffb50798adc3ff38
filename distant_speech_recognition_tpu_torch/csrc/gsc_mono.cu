// The flagship chain in one kernel: analysis bank -> GSC-RLS beamformer +
// Zelinski postfilter -> [synthesis bank], raw samples in.
//
// Two entry points share one kernel (a template flag):
//   dsr_gsc_mono (K4) replaces the Pallas TPU kernel
//     models/pallas_fused_scan.py analysis_gsc_synthesis_pallas
//     (_call_fused_mono) of distant_speech_recognition_tpu: samples out,
//     [B, T_out * D];
//   dsr_gsc_analysis (K5) replaces analysis_gsc_rls_zelinski_pallas
//     (_call_fused_analysis): the beamformed packed spectrum out, [Tf, B, M].
// They compute what models/fused_scan.analysis_gsc_synthesis's plain chain
// computes, and what the port's split kernels analysis_tm (K1) ->
// gsc_rls_zelinski (K2) [-> synthesis_tm (K3)] compute: K5 to the bit (the
// same FIR rows, FFT pairs, split and RLS step in the same order), K4
// within rounding (K3 pairs its synthesis rows otherwise).  The input
// spectrum [Tf, B, C, M] never touches device memory, and in K4 neither does
// the beamformed one [Tf, B, M].
//
// What bounds the function on an H100: K4's 0.82 GB of samples in and out
// at B=256 x 4 ch x 10 s (0.25 ms at 3.35 TB/s; K5's 0.98 GB); its
// transforms done by FFT and the RLS step need ~39 GFLOP (0.59 ms at the
// FP32 peak).  What bounds this kernel: the RLS recursion, sequential over
// an utterance's frames, ~2.2k cycles a frame (PERF.md), with a block
// reduction for the silence gate.  Design (K8's, csrc/fw_mono.cu, with the
// RLS step in place of the fixed-weight one): one block of 256 threads per
// utterance walks the frames in tiles of K = 64 / C frames; per tile it
//   1. forms the K*C analysis FIR rows from x into the tile's rows P
//      [64][LD] in the FFT's input layout (dsr::fft::analysis_fir_tile, as
//      K1 and K8 form them);
//   2. runs the analysis FFT in place, two rows per complex FFT
//      (csrc/dsr_fft.h);
//   3. runs the GSC-RLS + Zelinski step (csrc/gsc_step.h) over the tile's
//      frames in order on five warps (thread f < F = 129 owns bin f),
//      reading each bin with the two-for-one split: the bin's adaptive state
//      (active weights, compressed precision, CSD sums, gate energy) stays in
//      its thread's registers for the whole utterance; the bin's fixed
//      weights (wqH, BmH, conj of the manifold) sit in shared memory, read
//      per frame (at C = 8 they are 144 floats a bin); the frame energy's
//      reduction is a named barrier over those five warps;
//   4. (K4) writes the beamformed bins of two frames as one synthesis pair
//      into a window of c rows that keeps the previous tile's last m*R - 1
//      rows as its halo, runs the synthesis FFT on the window's new rows, and
//   5. (K4) runs the m-tap synthesis FIR and the R-segment overlap-add from
//      the window and writes D samples per output frame;
//   (K5 writes the beamformed rows to [Tf, B, M] instead of 4-5).
// Nothing is streamed from device memory but x and the taps (through L1)
// and the 2 KB twiddle table.  At C = 3 and 4 two blocks fit on an SM (112
// KB of shared memory at m*R = 8, 128 registers), so B = 256 utterances run
// in one wave and one block's serial RLS frames overlap the other's FIR and
// FFTs; C = 2 (shared memory) and C = 5..8 (registers) run one (PERF.md).  Tried and not kept:
// three warps that form tile t+1's analysis while five run tile t's frames
// (slower: their loads of x and the frames slowed each other).  Plain IEEE
// FP32, no TF32, no tensor cores.
#include "dsr_fft.h"
#include "dsr_kernels.h"
#include "gsc_step.h"

#include <cstdint>

namespace {

using namespace dsr;
constexpr int M_ = 256;  // subbands (the kernel is built for M = 256)
constexpr int LD = fft::ld<M_>();
constexpr int F_ = M_ / 2 + 1;
constexpr int ROWS = 64;    // analysis rows per tile: K frames x C channels, K = ROWS / C
constexpr int THREADS = 256;
constexpr int SCAN_THREADS = 160;  // warps 0-4: thread f < F owns bin f
constexpr int BAR_SCAN = 1;        // the named barrier of the scan warps
constexpr int SM_SHARED = 233472;         // shared memory per SM on an H100
constexpr int BLOCK_RESERVED = 1024 + 256;  // the runtime's per-block share and `red`

// fixed weights per bin: wqH and conj(manifold) (C complex each), BmH (C-1 x C)
__host__ __device__ constexpr int n_weights(int C) { return 2 * C * (C + 1); }

// window rows: halo + K, and a spare zero partner row when K is odd
__host__ __device__ constexpr int window_rows(int K, int halo) { return halo + K + (K & 1); }

// shared floats: twiddles [2][M], analysis rows [ROWS][LD], (K4) the c
// window [window_rows][LD], the weights [n_weights][F]
__host__ __device__ constexpr size_t smem_bytes(int C, int halo, bool synth) {
  return sizeof(float) * (2 * M_ + (size_t)ROWS * LD +
                          (synth ? (size_t)window_rows(ROWS / C, halo) * LD : 0) +
                          (size_t)n_weights(C) * F_);
}

// blocks per SM the register budget plans for: two (128 registers a
// thread) at C = 4, whose RLS state fits them, where two fit in shared
// memory at the flagship's halo (m*R - 1 = 7); one (up to 255) elsewhere:
// C = 5..8 take 153-254 registers, C = 2 and 3 fit in 128 all the same
// (PERF.md)
__host__ __device__ constexpr int plan_blocks(int C, bool synth) {
  return C == 4 && 2 * (smem_bytes(C, 7, synth) + BLOCK_RESERVED) <= (size_t)SM_SHARED ? 2 : 1;
}

template <int C, bool SYNTH>
__global__ void __launch_bounds__(THREADS, plan_blocks(C, SYNTH))
gsc_mono_kernel(const float* __restrict__ x, const float* __restrict__ hr,
                const float* __restrict__ tw, const float* __restrict__ gf,
                const float* __restrict__ wq, const float* __restrict__ bm,
                const float* __restrict__ ta, float* __restrict__ out, int B, int T, int Tf,
                int m, int R, int D, int shift, int pd, int T_out, GscParams p) {
  constexpr int BC = C - 1;
  constexpr int K = ROWS / C;      // frames per tile
  constexpr int KP = (K + 1) / 2;  // synthesis row pairs per tile
  constexpr int F = F_;
  constexpr int NW = n_weights(C);
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][32];
  const int halo = SYNTH ? m * R - 1 : 0;
  float* tc = smem;
  float* ts = tc + M_;
  float* P = ts + M_;
  float* cw = P + ROWS * LD;
  float* sw = cw + (SYNTH ? window_rows(K, halo) * LD : 0);

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const float* xb = x + (size_t)b * C * T;
  float* ob = out + (size_t)b * T_out * D;

  // the bins' weights, component-major so that thread f reads sw[j*F + f]:
  // j < 2C wqH (re, im), then conj(manifold), then BmH row-major
  for (int idx = tid; idx < NW * F; idx += THREADS) {
    const int f = idx % F;
    const int j = idx / F;
    float v;
    if (j < 2 * C) {
      v = wq[(size_t)f * 2 * C + j];
    } else if (j < 4 * C) {
      v = ta[(size_t)f * 2 * C + (j - 2 * C)];
      if (j & 1) v = -v;
    } else {
      v = bm[(size_t)f * 2 * BC * C + (j - 4 * C)];
    }
    sw[idx] = v;
  }
  if (SYNTH)
    for (int idx = tid; idx < halo * LD; idx += THREADS) cw[idx] = 0.f;

  // thread f < F owns bin f; the other lanes of the last scan warp shadow
  // the last bin and never write
  const int f = tid;
  const bool scans = tid < SCAN_THREADS;
  const bool owns_bin = f < F;
  const int fc = owns_bin ? f : F - 1;
  const bool has_im = f >= 1 && f <= F - 2;
  const float ew = (fc == 0 || fc == F - 1) ? 1.f : 2.f;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  constexpr int nwarps = SCAN_THREADS / 32;
  GscState<BC> S = gsc_start<BC>(p);
  GscFrontState fs = {{0.f, 0.f}, 0.f, p.delta};

  fft::stage_twiddles<M_>(smem, tw);
  const fft::Consts kc = fft::consts<M_>(tw);
  __syncthreads();

  for (int t0 = 0; t0 < Tf; t0 += K) {
    // 1. analysis FIR rows: row tk*C + c, element n at (n + 1) mod M
    fft::analysis_fir_tile<M_, ROWS, C, THREADS, 16>(P, xb, hr, t0, Tf, T, m, D, shift);
    __syncthreads();
    // 2. analysis FFT, rows (2q, 2q+1) as one complex row
    fft::fft_rows<M_, false, THREADS>(P, ROWS / 2, tc, kc, tid);
    __syncthreads();

    // 3. GSC-RLS + Zelinski by the scan warps, frames in order (t is the
    //    same for the block); (K4) frames (2q, 2q+1) of the tile become
    //    window pair q
    if (scans) {
      cf Ya = {0.f, 0.f};
      for (int tk = 0; tk < K; ++tk) {
        const int t = t0 + tk;
        cf Y = {0.f, 0.f};
        if (t < Tf) {
          cf X[C];
#pragma unroll
          for (int c = 0; c < C; ++c) X[c] = fft::split_bin<M_>(P, tk * C + c, fc);
          // reference-channel frame energy of this utterance (all bins)
          const float e = owns_bin ? ew * cabs2(X[0]) : 0.f;
          const float energy_t =
              block_sum<BAR_SCAN>(e, red[t & 1], lane, warp, nwarps) / (float)M_;
          cf wqc[C], tac[C], bmc[BC][C];
#pragma unroll
          for (int c = 0; c < C; ++c) {
            wqc[c] = {sw[(2 * c) * F + fc], sw[(2 * c + 1) * F + fc]};
            tac[c] = {sw[(2 * C + 2 * c) * F + fc], sw[(2 * C + 2 * c + 1) * F + fc]};
          }
#pragma unroll
          for (int i = 0; i < BC; ++i)
#pragma unroll
            for (int c = 0; c < C; ++c)
              bmc[i][c] = {sw[(4 * C + 2 * (i * C + c)) * F + fc],
                           sw[(4 * C + 2 * (i * C + c) + 1) * F + fc]};
          Y = gsc_rls_zelinski_step<C, BC>(S, fs, wqc, bmc, tac, X, energy_t, t, p);
          if (!SYNTH && owns_bin) {
            float* yrow = out + ((size_t)t * B + b) * M_;
            yrow[f] = Y.r;
            if (has_im) yrow[F + f - 1] = Y.i;
          }
        }
        if (SYNTH && owns_bin) {
          if (tk & 1) {
            fft::put_pair_bin<M_>(cw + (halo + tk - 1) * LD, f, Ya, Y);
          } else {
            Ya = Y;
            if (tk == K - 1) fft::put_pair_bin<M_>(cw + (halo + tk) * LD, f, Ya, {0.f, 0.f});
          }
        }
      }
    }
    __syncthreads();
    if constexpr (SYNTH) {
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
}

// the kernel's shared memory limit and carveout, set before a launch or an
// occupancy query
template <int C, bool SYNTH>
cudaError_t prepare(size_t bytes) {
  cudaError_t err = cudaFuncSetAttribute(gsc_mono_kernel<C, SYNTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(gsc_mono_kernel<C, SYNTH>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int C, bool SYNTH>
int launch(const float* x, const float* hr, const float* tw, const float* gf, const float* wq,
           const float* bm, const float* ta, float* out, int B, int T, int Tf, int m, int R,
           int D, int shift, int pd, int T_out, const GscParams& p, cudaStream_t stream) {
  const int halo = SYNTH ? m * R - 1 : 0;
  if (halo > ROWS / C) return DSR_ERR_ARGS;
  const size_t bytes = smem_bytes(C, halo, SYNTH);
  cudaError_t err = prepare<C, SYNTH>(bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gsc_mono_kernel<C, SYNTH><<<B, THREADS, bytes, stream>>>(x, hr, tw, gf, wq, bm, ta, out, B, T,
                                                           Tf, m, R, D, shift, pd, T_out, p);
  return static_cast<int>(cudaGetLastError());
}

template <int C, bool SYNTH>
int occupancy(int halo, int* blocks, int* smem) {
  const size_t bytes = smem_bytes(C, SYNTH ? halo : 0, SYNTH);
  cudaError_t err = prepare<C, SYNTH>(bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, gsc_mono_kernel<C, SYNTH>,
                                                        THREADS, bytes);
  *smem = (int)bytes;
  return static_cast<int>(err);
}

#define DSR_CHANNELS(X) X(2) X(3) X(4) X(5) X(6) X(7) X(8)

template <bool SYNTH>
int run(const float* x, const float* hr, const float* tw, const float* gf, const float* wq,
        const float* bm, const float* ta, float* out, int B, int C, int T, int Tf, int m, int R,
        int D, int shift, int pd, int T_out, const GscParams& p, cudaStream_t stream) {
  switch (C) {
#define DSR_CASE(n) \
    case n: return launch<n, SYNTH>(x, hr, tw, gf, wq, bm, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    DSR_CHANNELS(DSR_CASE)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

template <bool SYNTH>
int occupancy_of(int C, int halo, int* blocks, int* smem) {
  switch (C) {
#define DSR_CASE(n) \
    case n: return occupancy<n, SYNTH>(halo, blocks, smem);
    DSR_CHANNELS(DSR_CASE)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

GscParams gsc_params(float beta, float one_minus_beta, float gamma, float mu, float delta,
                     float inv_delta, float reg_param, float sil_thresh, int constraint_option,
                     float alpha2, float max_wa_l2norm, int min_frames, float pf_alpha,
                     float one_minus_pf_alpha, float pf_gain, float spectral_floor,
                     int real_mode, int pf_min_frames) {
  return {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
          constraint_option, alpha2, max_wa_l2norm, min_frames,
          {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode, pf_min_frames}};
}

}  // namespace

extern "C" int dsr_gsc_mono(const float* x, const float* hr, const float* tw, const float* gf,
                            const float* wq, const float* bm, const float* ta, float* out, int B,
                            int C, int Bc, int T, int Tf, int M, int m, int R, int D, int shift,
                            int pd, int T_out, int rows, float beta, float one_minus_beta,
                            float gamma, float mu, float delta, float inv_delta, float reg_param,
                            float sil_thresh, int constraint_option, float alpha2,
                            float max_wa_l2norm, int min_frames, float pf_alpha,
                            float one_minus_pf_alpha, float pf_gain, float spectral_floor,
                            int real_mode, int pf_min_frames, cudaStream_t stream) {
  // rows: the tile the caller's shape rule assumed (fused_scan.GSC_MONO_ROWS)
  if (rows != ROWS || M != M_ || Bc != C - 1 || B <= 0 || T <= 0 || Tf <= 0 || m <= 0 ||
      R <= 0 || D * R != M || pd < 0 || T_out <= 0 || T_out + pd != Tf)
    return DSR_ERR_ARGS;
  const GscParams p = gsc_params(beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param,
                                 sil_thresh, constraint_option, alpha2, max_wa_l2norm, min_frames,
                                 pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                                 pf_min_frames);
  return run<true>(x, hr, tw, gf, wq, bm, ta, out, B, C, T, Tf, m, R, D, shift, pd, T_out, p,
                   stream);
}

extern "C" int dsr_gsc_analysis(const float* x, const float* hr, const float* tw, const float* wq,
                                const float* bm, const float* ta, float* out, int B, int C,
                                int Bc, int T, int Tf, int M, int m, int D, int shift, int rows,
                                float beta, float one_minus_beta, float gamma, float mu,
                                float delta, float inv_delta, float reg_param, float sil_thresh,
                                int constraint_option, float alpha2, float max_wa_l2norm,
                                int min_frames, float pf_alpha, float one_minus_pf_alpha,
                                float pf_gain, float spectral_floor, int real_mode,
                                int pf_min_frames, cudaStream_t stream) {
  if (rows != ROWS || M != M_ || Bc != C - 1 || B <= 0 || T <= 0 || Tf <= 0 || m <= 0 ||
      D <= 0 || M % D != 0)
    return DSR_ERR_ARGS;
  const GscParams p = gsc_params(beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param,
                                 sil_thresh, constraint_option, alpha2, max_wa_l2norm, min_frames,
                                 pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                                 pf_min_frames);
  return run<false>(x, hr, tw, nullptr, wq, bm, ta, out, B, C, T, Tf, m, 1, D, shift, 0, 0, p,
                    stream);
}

extern "C" int dsr_gsc_mono_occupancy(int C, int synth, int halo, int* blocks_per_sm,
                                      int* smem_bytes) {
  if (C < 2 || C > 8 || halo < 0 || (synth && halo > ROWS / C)) return DSR_ERR_ARGS;
  return synth ? occupancy_of<true>(C, halo, blocks_per_sm, smem_bytes)
               : occupancy_of<false>(C, halo, blocks_per_sm, smem_bytes);
}
