// Fixed-weight beamformer + Zelinski postfilter over packed time-major frames.
//
// Replaces the Pallas TPU kernel models/pallas_fused_scan.py
// zelinski_apply_pallas (_call_fw / _make_fw_kernel without the filterbank
// stages) of distant_speech_recognition_tpu, and computes what
// models/fixed_weight.zelinski_apply_plain computes:
//   Y[t, b, f] = sum_c wqH[f, c] X[t, b, c, f];  the Zelinski gain of the
//   time-aligned snapshot conj(ta) X (pair sum and trace smoothed from the
//   third frame on), applied from frame pf_min_frames + 1 on.
// Input [Tf, B, C, M] and output [Tf, B, M] keep the packed lanes
// [Re(0..M/2) | Im(1..M/2-1)]; all M/2 + 1 bins run the same code.  The
// weights and the manifold are one set [F, C] for every utterance
// (dsr_zelinski_apply) or one per utterance [B, F, C]
// (dsr_zelinski_apply_steered: the steered D&S, whose utterances each look
// at their own DOA estimate); only the row a thread reads differs.
//
// What bounds it on an H100: each (utterance, bin) reads C*8 bytes and
// writes 8 per frame for ~12*C^2 flops, so it is bound by memory bytes
// (1.65 GB at B=256 x 4 ch x 10 s, 0.49 ms at 3.35 TB/s), provided enough
// loads are in flight: the recursion is sequential over frames.  Design:
// one thread per (utterance, bin), consecutive threads on consecutive bins
// (loads and stores coalesce along the bins), the two smoothed sums in
// registers; frames are loaded FRAMES at a time, all loads of a group in flight
// before any is used.
#include "dsr_device.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

using namespace dsr;

constexpr int THREADS = 128;
constexpr int FRAMES = 4;  // frames loaded together

template <int C>
__global__ void __launch_bounds__(THREADS)
zelinski_apply_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                      const float* __restrict__ ta, float* __restrict__ out, int Tf, int B, int M,
                      bool per_utt, ZelinskiParams p) {
  const int F = M / 2 + 1;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx - (long long)b * F);
  const bool has_im = f >= 1 && f <= F - 2;
  const size_t wf = (per_utt ? (size_t)b * F : 0) + f;  // this utterance's row of bin f

  cf wqc[C], tac[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wqc[c] = {wq[(wf * C + c) * 2], wq[(wf * C + c) * 2 + 1]};
    tac[c] = {ta[(wf * C + c) * 2], -ta[(wf * C + c) * 2 + 1]};  // conj(ta)
  }
  cf phi_pair = {0.f, 0.f};
  float phi_diag = 0.f;

  const size_t in_stride = (size_t)B * C * M;
  const size_t out_stride = (size_t)B * M;
  const float* src = Yp + (size_t)b * C * M;
  float* dst = out + (size_t)b * M;
  for (int t0 = 0; t0 < Tf; t0 += FRAMES) {
    cf X[FRAMES][C];
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) {
      if (t0 + u < Tf) {
#pragma unroll
        for (int c = 0; c < C; ++c) X[u][c] = packed_bin(src + (t0 + u) * in_stride + c * M, F, f);
      }
    }
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) {
      const int t = t0 + u;
      if (t >= Tf) break;
      cf Y = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < C; ++c) Y = cadd(Y, cmul(wqc[c], X[u][c]));
      const float W = zelinski_gain<C>(phi_pair, phi_diag, tac, X[u], t, p);
      if (t > p.min_frames) Y = cscale(Y, W);
      float* o = dst + t * out_stride;
      o[f] = Y.r;
      if (has_im) o[F + f - 1] = Y.i;
    }
  }
}

template <int C>
int launch(const float* Yp, const float* wq, const float* ta, float* out, int Tf, int B, int M,
           bool per_utt, const ZelinskiParams& p, cudaStream_t stream) {
  const long long n = (long long)B * (M / 2 + 1);
  zelinski_apply_kernel<C><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(
      Yp, wq, ta, out, Tf, B, M, per_utt, p);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* Yp, const float* wq, const float* ta, float* out, int Tf, int B, int C,
             int M, bool per_utt, const ZelinskiParams& p, cudaStream_t stream) {
  if (Tf <= 0 || B <= 0 || M < 4 || M % 2 != 0) return DSR_ERR_ARGS;
  switch (C) {
    case 2: return launch<2>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    case 3: return launch<3>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    case 4: return launch<4>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    case 5: return launch<5>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    case 6: return launch<6>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    case 7: return launch<7>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    case 8: return launch<8>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    default: return DSR_ERR_ARGS;
  }
}

}  // namespace

extern "C" int dsr_zelinski_apply(const float* Yp, const float* wq, const float* ta, float* out,
                                  int Tf, int B, int C, int M, float pf_alpha,
                                  float one_minus_pf_alpha, float pf_gain, float spectral_floor,
                                  int real_mode, int pf_min_frames, cudaStream_t stream) {
  const ZelinskiParams p = {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                            pf_min_frames};
  return dispatch(Yp, wq, ta, out, Tf, B, C, M, false, p, stream);
}

extern "C" int dsr_zelinski_apply_steered(const float* Yp, const float* wq, const float* ta,
                                          float* out, int Tf, int B, int C, int M,
                                          float pf_alpha, float one_minus_pf_alpha,
                                          float pf_gain, float spectral_floor, int real_mode,
                                          int pf_min_frames, cudaStream_t stream) {
  const ZelinskiParams p = {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                            pf_min_frames};
  return dispatch(Yp, wq, ta, out, Tf, B, C, M, true, p, stream);
}
