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
// They compute what the chain of the port's split kernels computes,
// operation for operation (the same device helpers in the same summation
// orders): analysis_tm (K1) -> gsc_rls_zelinski (K2) [-> synthesis_tm (K3)],
// i.e. models/fused_scan.analysis_gsc_synthesis.  The input spectrum
// [Tf, B, C, M] never touches device memory, and in K4 neither does the
// beamformed one [Tf, B, M].
//
// What bounds the function on an H100: K4's 0.82 GB of samples in and out
// at B=256 x 4 ch x 10 s (0.25 ms at 3.35 TB/s; K5's 0.98 GB); its
// transforms done by FFT and the RLS step need ~20 GFLOP.  What bounds this
// kernel: the transforms as dense products (2*M*M flops per row, 210 GFLOP
// for K4) and the RLS recursion, sequential over frames, which runs after
// each tile's products with nothing to hide its latency.  Design (K8's,
// csrc/fw_mono.cu, with the RLS step in place of the fixed-weight one):
// one block of 256 threads per utterance walks the frames in tiles of
// K = 64 / C frames; per tile it
//   1. forms the K*C analysis FIR rows from x (K1's helper) in 16-column
//      chunks in shared memory and multiplies them by the packed DFT matrix
//      A, streamed from L2 in 16-row chunks, into the tile's spectra P;
//   2. runs the GSC-RLS + Zelinski step (csrc/gsc_step.h) over the tile's
//      frames in order: thread f < F owns bin f and keeps its adaptive state
//      (active weights, compressed precision, CSD sums, gate energy) in
//      registers for the whole utterance; the bin's fixed weights (wqH,
//      BmH, conj of the manifold) sit in shared memory, read per frame (at
//      C = 8 they are 144 floats a bin, which registers cannot hold beside
//      the state); all 256 threads join each frame's energy reduction,
//      the warps that own no bin skip the step;
//   3. (K4) multiplies the beamformed rows by the packed synthesis matrix S
//      into a window of c rows that keeps the previous tile's last m*R - 1
//      rows as its halo, and
//   4. (K4) runs the m-tap synthesis FIR and the R-segment overlap-add from
//      the window (K3's helper) and writes D samples per output frame;
//   (K5 writes the beamformed rows to [Tf, B, M] instead).
// One block per SM (up to ~185 KB of shared memory at C = 8).  Plain IEEE
// FP32 FMA, no TF32, no tensor cores.
#include "dsr_kernels.h"
#include "gsc_step.h"

#include <cstdint>

namespace {

using namespace dsr;

constexpr int M_ = 256;   // subbands (the kernel is built for M = 256)
constexpr int F_ = M_ / 2 + 1;
constexpr int ROWS = 64;  // analysis rows per tile: K frames x C channels, K = ROWS / C
constexpr int BK = 16;    // reduction chunk of both DFT products
constexpr int WS_LD = ROWS + 4;
constexpr int THREADS = 256;

// fixed weights per bin: wqH and conj(manifold) (C complex each), BmH (C-1 x C)
__host__ __device__ constexpr int n_weights(int C) { return 2 * C * (C + 1); }

// shared floats: FIR chunk [BK][WS_LD], A or S chunk [BK][M_], spectra
// [ROWS][M_], with synthesis beamformed rows [K][M_] and the c window
// [halo + K][M_], then the weights [n_weights][F_]
size_t smem_bytes(int C, int K, int halo, bool synth) {
  const size_t syn = synth ? (size_t)K * M_ + (size_t)(halo + K) * M_ : 0;
  return sizeof(float) * ((size_t)BK * WS_LD + BK * M_ + ROWS * M_ + syn +
                          (size_t)n_weights(C) * F_);
}

template <int C, bool SYNTH>
__global__ void __launch_bounds__(THREADS, 1)
gsc_mono_kernel(const float* __restrict__ x, const float* __restrict__ hr,
                const float* __restrict__ A, const float* __restrict__ S,
                const float* __restrict__ gf, const float* __restrict__ wq,
                const float* __restrict__ bm, const float* __restrict__ ta,
                float* __restrict__ out, int B, int T, int Tf, int m, int R, int D, int shift,
                int pd, int T_out, GscParams p) {
  constexpr int BC = C - 1;
  constexpr int K = ROWS / C;      // frames per tile
  constexpr int KR = (K + 7) / 8;  // synthesis rows per thread
  constexpr int F = F_;
  constexpr int NW = n_weights(C);
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2][32];
  const int halo = SYNTH ? m * R - 1 : 0;
  float* Ws = smem;
  float* Bs = Ws + BK * WS_LD;
  float* P = Bs + BK * M_;
  float* ys = P + ROWS * M_;
  float* cw = ys + (SYNTH ? K * M_ : 0);
  float* sw = cw + (SYNTH ? (halo + K) * M_ : 0);

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int tx = tid % 32;  // columns tx*4 .. +3 and 128 + tx*4 .. +3
  const int ty = tid / 32;  // analysis rows ty*4 .. +3 and 32 + ty*4 .. +3
  const float* xb = x + (size_t)b * C * T;

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
    for (int idx = tid; idx < halo * M_; idx += THREADS) cw[idx] = 0.f;

  // thread f < F owns bin f; the other lanes of a warp that owns bins shadow
  // the last bin and never write; the warps past the bins skip the step
  const int f = tid;
  const bool owns_bin = f < F;
  const bool scan_warp = (tid & ~31) < F;
  const int fc = owns_bin ? f : F - 1;
  const bool has_im = f >= 1 && f <= F - 2;
  const float ew = (fc == 0 || fc == F - 1) ? 1.f : 2.f;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = THREADS / 32;
  cf waH[BC], off[gsc_np(BC)];
  float d[BC];
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    waH[i] = {0.f, 0.f};
    d[i] = p.inv_delta;
  }
#pragma unroll
  for (int n = 0; n < gsc_np(BC); ++n) off[n] = {0.f, 0.f};
  cf phi_pair = {0.f, 0.f};
  float phi_diag = 0.f;
  float energy = p.delta;
  __syncthreads();

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

    // 2. GSC-RLS + Zelinski, frames in order (t is the same for the block)
    for (int tk = 0; tk < K; ++tk) {
      const int t = t0 + tk;
      if (t >= Tf) {
        if (SYNTH && owns_bin) {
          ys[tk * M_ + f] = 0.f;
          if (has_im) ys[tk * M_ + F + f - 1] = 0.f;
        }
        continue;
      }
      cf X[C];
#pragma unroll
      for (int c = 0; c < C; ++c)
        X[c] = scan_warp ? packed_bin(P + (tk * C + c) * M_, F, fc) : cf{0.f, 0.f};
      // reference-channel frame energy of this utterance (all bins)
      const float e = owns_bin ? ew * cabs2(X[0]) : 0.f;
      const float energy_t = block_sum(e, red[t & 1], lane, warp, nwarps) / (float)M_;
      if (!scan_warp) continue;
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
      const cf Y = gsc_rls_zelinski_step<C, BC>(waH, off, d, phi_pair, phi_diag, energy, wqc,
                                                bmc, tac, X, energy_t, t, p);
      if (owns_bin) {
        float* yrow = SYNTH ? ys + tk * M_ : out + ((size_t)t * B + b) * M_;
        yrow[f] = Y.r;
        if (has_im) yrow[F + f - 1] = Y.i;
      }
    }
    __syncthreads();
    if constexpr (SYNTH) {
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
      float* ob = out + (size_t)b * T_out * D;
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
}

template <int C, bool SYNTH>
int launch(const float* x, const float* hr, const float* A, const float* S, const float* gf,
           const float* wq, const float* bm, const float* ta, float* out, int B, int T, int Tf,
           int m, int R, int D, int shift, int pd, int T_out, const GscParams& p,
           cudaStream_t stream) {
  constexpr int K = ROWS / C;
  const int halo = SYNTH ? m * R - 1 : 0;
  if (halo > K) return DSR_ERR_ARGS;
  const size_t bytes = smem_bytes(C, K, halo, SYNTH);
  cudaError_t err = cudaFuncSetAttribute(gsc_mono_kernel<C, SYNTH>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gsc_mono_kernel<C, SYNTH><<<B, THREADS, bytes, stream>>>(x, hr, A, S, gf, wq, bm, ta, out, B,
                                                           T, Tf, m, R, D, shift, pd, T_out, p);
  return static_cast<int>(cudaGetLastError());
}

template <bool SYNTH>
int run(const float* x, const float* hr, const float* A, const float* S, const float* gf,
        const float* wq, const float* bm, const float* ta, float* out, int B, int C, int T,
        int Tf, int m, int R, int D, int shift, int pd, int T_out, const GscParams& p,
        cudaStream_t stream) {
  switch (C) {
#define DSR_CASE(n) \
    case n: return launch<n, SYNTH>(x, hr, A, S, gf, wq, bm, ta, out, B, T, Tf, m, R, D, shift, pd, T_out, p, stream);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

}  // namespace

extern "C" int dsr_gsc_mono(const float* x, const float* hr, const float* A, const float* S,
                            const float* gf, const float* wq, const float* bm, const float* ta,
                            float* out, int B, int C, int Bc, int T, int Tf, int M, int m, int R,
                            int D, int shift, int pd, int T_out, int rows, float beta,
                            float one_minus_beta, float gamma, float mu, float delta,
                            float inv_delta, float reg_param, float sil_thresh,
                            int constraint_option, float alpha2, float max_wa_l2norm,
                            int min_frames, float pf_alpha, float one_minus_pf_alpha,
                            float pf_gain, float spectral_floor, int real_mode, int pf_min_frames,
                            cudaStream_t stream) {
  // rows: the tile the caller's shape rule assumed (fused_scan.GSC_MONO_ROWS)
  if (rows != ROWS || M != M_ || Bc != C - 1 || B <= 0 || T <= 0 || Tf <= 0 || m <= 0 ||
      R <= 0 || D * R != M || pd < 0 || T_out <= 0 || T_out + pd != Tf)
    return DSR_ERR_ARGS;
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                       constraint_option, alpha2, max_wa_l2norm, min_frames,
                       {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                        pf_min_frames}};
  return run<true>(x, hr, A, S, gf, wq, bm, ta, out, B, C, T, Tf, m, R, D, shift, pd, T_out, p,
                   stream);
}

extern "C" int dsr_gsc_analysis(const float* x, const float* hr, const float* A, const float* wq,
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
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                       constraint_option, alpha2, max_wa_l2norm, min_frames,
                       {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                        pf_min_frames}};
  return run<false>(x, hr, A, nullptr, nullptr, wq, bm, ta, out, B, C, T, Tf, m, 1, D, shift, 0,
                    0, p, stream);
}
