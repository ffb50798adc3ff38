// Subband echo canceller scan (NLMS or scalar Kalman), one recursion over frames.
//
// Replaces the Pallas TPU kernel ops/pallas_aec.py aec_scan_pallas
// (_make_kernel / _call) of distant_speech_recognition_tpu, and computes what
// models/aec.nlms_aec / kalman_aec compute on the unpacked spectrum, per
// (utterance, channel, bin):
//   E = A - R V
//   nlms:   R <- R - eps |V|^2/(delta + |A|^2) (R - A/V)          if |V|^2 > thr
//   kalman: sv' = beta sv + (1-beta)|E|^2, K' = K + sigma2,
//           R <- R + conj(V) E K'/(|V|^2 K' + sv'), K <- (1 - K'|V|^2/(..)) K'
//                                                                  if |V|^2 > thr
// A [Tf, B, C, M] and V [Tf, B, M] (one far-end reference for every channel)
// in the packed lanes [Re(0..M/2) | Im(1..M/2-1)]; E has A's layout.
//
// What bounds it on an H100: each (utterance, channel, bin) reads 16 bytes
// and writes 8 per frame for a few dozen flops, so it is bound by memory
// (2.96 GB at B=256 x 4 ch x 10 s, 0.88 ms at 3.35 TB/s).  Design: one thread
// per (utterance, channel, bin), the filter (and the Kalman state) in
// registers for the whole utterance; neighbouring threads take neighbouring
// bins of one packed row, so every frame's reads and writes are coalesced;
// frames go in groups of K, and the next group's loads start before the
// current group is processed, so K frames of loads are in flight per thread.
// The DC and Nyquist bins have no Im lane and read it as 0.  The gate and the
// guarded quotient A conj(V)/|V|^2 are branches (selects), never blends: a
// speculative quotient on a silent bin never reaches the state.
#include "dsr_kernels.h"

namespace {

constexpr int THREADS = 128;
constexpr int K = 4;  // frames per group; the next group is loaded while one is processed

struct Frame {
  float ar, ai, vr, vi;
};

__device__ __forceinline__ Frame load_frame(const float* a, const float* v, int f, int F,
                                            bool has_im) {
  Frame x;
  x.ar = a[f];
  x.ai = has_im ? a[F - 1 + f] : 0.f;
  x.vr = v[f];
  x.vi = has_im ? v[F - 1 + f] : 0.f;
  return x;
}

__global__ void __launch_bounds__(THREADS)
aec_scan_kernel(const float* __restrict__ A, const float* __restrict__ V, float* __restrict__ E,
                int Tf, int B, int C, int M, int kalman, float p1, float p2, float thr) {
  const int F = M / 2 + 1;
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= B * C * F) return;
  const int f = idx % F;
  const int row = idx / F;  // b * C + c
  const int b = row / C;
  const bool has_im = f >= 1 && f <= F - 2;
  const size_t a_stride = (size_t)B * C * M;
  const size_t v_stride = (size_t)B * M;
  const float* a = A + (size_t)row * M;
  const float* v = V + (size_t)b * M;
  float* e = E + (size_t)row * M;

  float Rr = 0.f, Ri = 0.f;
  float sv = p2, kk = p2;  // Kalman observation noise and state variance
  Frame cur[K], nxt[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    cur[k] = nxt[k] = Frame{0.f, 0.f, 0.f, 0.f};
    if (k < Tf) cur[k] = load_frame(a + k * a_stride, v + k * v_stride, f, F, has_im);
  }
  for (int t0 = 0; t0 < Tf; t0 += K) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + K + k;
      if (t < Tf) nxt[k] = load_frame(a + t * a_stride, v + t * v_stride, f, F, has_im);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k;
      if (t >= Tf) continue;
      const Frame x = cur[k];
      const float Er = x.ar - (Rr * x.vr - Ri * x.vi);
      const float Ei = x.ai - (Rr * x.vi + Ri * x.vr);
      const float v2 = x.vr * x.vr + x.vi * x.vi;
      if (v2 > thr) {
        if (kalman) {
          const float svn = p1 * sv + (1.f - p1) * (Er * Er + Ei * Ei);
          const float kp = kk + p2;
          const float ss = v2 * kp + svn;
          const float gk = kp / ss;
          Rr += (x.vr * Er + x.vi * Ei) * gk;
          Ri += (x.vr * Ei - x.vi * Er) * gk;
          sv = svn;
          kk = (1.f - kp * v2 / ss) * kp;
        } else {
          const float den = v2 > 0.f ? v2 : 1.f;
          const float Gr = (x.ar * x.vr + x.ai * x.vi) / den;
          const float Gi = (x.ai * x.vr - x.ar * x.vi) / den;
          const float mu = p2 * v2 / (p1 + (x.ar * x.ar + x.ai * x.ai));
          Rr = Rr - (Rr - Gr) * mu;
          Ri = Ri - (Ri - Gi) * mu;
        }
      }
      float* o = e + t * a_stride;
      o[f] = Er;
      if (has_im) o[F - 1 + f] = Ei;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) cur[k] = nxt[k];
  }
}

}  // namespace

extern "C" int dsr_aec_scan(const float* A, const float* V, float* E, int Tf, int B, int C, int M,
                            int kalman, float p1, float p2, float thr, cudaStream_t stream) {
  if (Tf <= 0 || B <= 0 || C <= 0 || M < 4 || M % 2 != 0 ||
      (long long)B * C * (M / 2 + 1) > 0x7fffffffLL)
    return DSR_ERR_ARGS;
  const int n = B * C * (M / 2 + 1);
  aec_scan_kernel<<<(n + THREADS - 1) / THREADS, THREADS, 0, stream>>>(A, V, E, Tf, B, C, M,
                                                                        kalman, p1, p2, thr);
  return static_cast<int>(cudaGetLastError());
}
