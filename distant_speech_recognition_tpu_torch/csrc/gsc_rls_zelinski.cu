// Adaptive GSC-RLS beamformer + Zelinski postfilter, one recursion over frames.
//
// Two entry points share one kernel:
//   dsr_gsc_rls_zelinski (K2) replaces the Pallas TPU kernel
//     models/pallas_fused_scan.py gsc_rls_zelinski_pallas (_call /
//     _make_kernel) of distant_speech_recognition_tpu: one set of weights
//     [F, ...] for every utterance;
//   dsr_gsc_rls_zelinski_steered (K6) replaces
//     gsc_rls_zelinski_steered_pallas (_call with per-utterance weight
//     planes): weights [B, F, ...], one steering per utterance, as the
//     SRP-PHAT-steered pipeline computes them.
// The only difference is the weights' batch stride (0 for K2, one F-bin
// table per utterance for K6), so K2's arithmetic is untouched by K6.
// Both compute what
// models/adaptive_gsc.gsc_postfilter_fused(kind="rls", real_packed=True,
// energy=None) computes, one frame at a time through the step shared with
// the one-kernel chains K4/K5 (csrc/gsc_step.h).
// Input and output keep the packed time-major lanes [Re(0..M/2) | Im(1..M/2-1)].
//
// What bounds it on an H100: the recursion is sequential over frames and
// independent over (utterance, bin); per frame each (utterance, bin) reads
// C*8 bytes and does a few hundred flops, so it is bound by the latency of
// one frame's dependent chain, not by bandwidth or flops.  Design: one block
// per utterance, one thread per bin (all F bins, Nyquist included, run the
// same code), the whole state (active weights, Pz, CSD sums, the bin's
// weights) in registers for the whole utterance; the next frame's snapshot
// is loaded before the current one is processed.  The silence gate couples
// the bins of an utterance through the frame energy of channel 0, so each
// frame does one block reduction (warp shuffles, one barrier; the two shared
// slots alternate by frame parity so no second barrier is needed).
#include "dsr_kernels.h"
#include "gsc_step.h"

#include <cstdint>

namespace {

using namespace dsr;

template <int C, int BC>
__global__ void gsc_rls_zelinski_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                                        const float* __restrict__ bm, const float* __restrict__ ta,
                                        float* __restrict__ out, int Tf, int B, int M,
                                        bool per_utt, GscParams p) {
  __shared__ float red[2][32];

  const int F = M / 2 + 1;
  const int f = threadIdx.x;
  const int b = blockIdx.x;
  const bool active = f < F;
  const int fc = active ? f : F - 1;  // idle lanes shadow the last bin and never write
  const bool has_im = fc >= 1 && fc <= F - 2;
  const float ew = (fc == 0 || fc == F - 1) ? 1.f : 2.f;
  const size_t wf = (per_utt ? (size_t)b * F : 0) + fc;  // this utterance's row of bin fc
  const int lane = f & 31;
  const int warp = f >> 5;
  const int nwarps = blockDim.x >> 5;

  cf wqc[C], tac[C], bmc[BC][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wqc[c] = {wq[(wf * C + c) * 2], wq[(wf * C + c) * 2 + 1]};
    tac[c] = {ta[(wf * C + c) * 2], -ta[(wf * C + c) * 2 + 1]};  // conj(ta)
  }
#pragma unroll
  for (int i = 0; i < BC; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
      bmc[i][c] = {bm[((wf * BC + i) * C + c) * 2], bm[((wf * BC + i) * C + c) * 2 + 1]};

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

  const size_t frame_stride = (size_t)B * C * M;
  const float* src = Yp + (size_t)b * C * M;
  cf X[C], Xn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) X[c] = packed_bin(src + c * M, F, fc);

  for (int t = 0; t < Tf; ++t) {
    if (t + 1 < Tf) {
      const float* nx = src + (size_t)(t + 1) * frame_stride;
#pragma unroll
      for (int c = 0; c < C; ++c) Xn[c] = packed_bin(nx + c * M, F, fc);
    }

    // reference-channel frame energy of this utterance (all bins)
    const float e = active ? ew * cabs2(X[0]) : 0.f;
    const float energy_t = block_sum(e, red[t & 1], lane, warp, nwarps) / (float)M;
    const cf Y = gsc_rls_zelinski_step<C, BC>(waH, off, d, phi_pair, phi_diag, energy, wqc, bmc,
                                              tac, X, energy_t, t, p);
    if (active) {
      float* o = out + ((size_t)t * B + b) * M;
      o[f] = Y.r;
      if (has_im) o[F + f - 1] = Y.i;
    }
#pragma unroll
    for (int c = 0; c < C; ++c) X[c] = Xn[c];
  }
}

template <int C>
int launch(const float* Yp, const float* wq, const float* bm, const float* ta, float* out,
           int Tf, int B, int M, bool per_utt, const GscParams& p, cudaStream_t stream) {
  const int F = M / 2 + 1;
  const int threads = (F + 31) / 32 * 32;
  gsc_rls_zelinski_kernel<C, C - 1><<<B, threads, 0, stream>>>(Yp, wq, bm, ta, out, Tf, B, M,
                                                               per_utt, p);
  return static_cast<int>(cudaGetLastError());
}

int scan(const float* Yp, const float* wq, const float* bm, const float* ta, float* out, int Tf,
         int B, int C, int Bc, int M, bool per_utt, const GscParams& p, cudaStream_t stream) {
  // one thread per bin, at most 256 bins (M <= 510) per block
  if (Tf <= 0 || B <= 0 || M < 4 || M % 2 != 0 || M / 2 + 1 > 256 || Bc != C - 1)
    return DSR_ERR_ARGS;
  switch (C) {
    case 2: return launch<2>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    case 3: return launch<3>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    case 4: return launch<4>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    case 5: return launch<5>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    case 6: return launch<6>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    case 7: return launch<7>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    case 8: return launch<8>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    default: return DSR_ERR_ARGS;
  }
}

}  // namespace

extern "C" int dsr_gsc_rls_zelinski(const float* Yp, const float* wq, const float* bm,
                                    const float* ta, float* out, int Tf, int B, int C, int Bc,
                                    int M, float beta, float one_minus_beta, float gamma,
                                    float mu, float delta, float inv_delta, float reg_param,
                                    float sil_thresh, int constraint_option, float alpha2,
                                    float max_wa_l2norm, int min_frames, float pf_alpha,
                                    float one_minus_pf_alpha, float pf_gain,
                                    float spectral_floor, int real_mode, int pf_min_frames,
                                    cudaStream_t stream) {
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames,
                    {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                     pf_min_frames}};
  return scan(Yp, wq, bm, ta, out, Tf, B, C, Bc, M, false, p, stream);
}

extern "C" int dsr_gsc_rls_zelinski_steered(const float* Yp, const float* wq, const float* bm,
                                            const float* ta, float* out, int Tf, int B, int C,
                                            int Bc, int M, float beta, float one_minus_beta,
                                            float gamma, float mu, float delta, float inv_delta,
                                            float reg_param, float sil_thresh,
                                            int constraint_option, float alpha2,
                                            float max_wa_l2norm, int min_frames, float pf_alpha,
                                            float one_minus_pf_alpha, float pf_gain,
                                            float spectral_floor, int real_mode,
                                            int pf_min_frames, cudaStream_t stream) {
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames,
                    {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                     pf_min_frames}};
  return scan(Yp, wq, bm, ta, out, Tf, B, C, Bc, M, true, p, stream);
}
