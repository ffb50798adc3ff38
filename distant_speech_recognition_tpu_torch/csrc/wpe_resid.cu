// WPE prediction residual (the dereverberated output when G is the final filter).
//
// Replaces the Pallas TPU kernel ops/pallas_wpe.py wpe_resid_pallas /
// wpe_resid_from_planes (_make_kernel in mode "resid", _call) of
// distant_speech_recognition_tpu, and computes what
// models/dereverberation.wpe_apply computes after its tap truncation, per
// (utterance b, channel c, bin f, frame t):
//   out_c[t] = y_c[t] - (t >= lowerN) conj(G[c, :]) . L_t,
//   L_t[j]   = y_a[t - lowerN - dp],  j = a*P + dp   (zero before t = 0)
// on the packed frames Yp [Tf, B, C, M] ([Re(0..M/2) | Im(1..M/2-1)] lanes)
// with G [B, C, F, CP] complex, into the same packed layout.
//
// What bounds it on an H100: it reads and writes the packed spectrum once
// (2.65 GB at B=256 x 4 ch x 10 s, 0.79 ms at 3.35 TB/s) for CP complex
// multiply-adds per output (~0.1 ms of FP32 arithmetic): bound by memory.
// Design: one block per (utterance, group of 32 bins), one warp per target
// channel, a thread's conj(G) row in registers for the whole utterance; the
// frames are walked in chunks of TC, staged with their lowerN + P - 1 frames
// of history in shared memory, so each input value is read from device
// memory about once (and the history once more per chunk) although C*P
// outputs use it.  Reads and writes of 32 neighbouring bins are coalesced.
#include "dsr_kernels.h"

namespace {

constexpr int TC = 32;     // frames per chunk
constexpr int FB = 32;     // bins per block (one warp)
constexpr int MAX_CP = 24;

struct cf {
  float r, i;
};

__global__ void __launch_bounds__(FB * 8)
wpe_resid_kernel(const float* __restrict__ Yp, const cf* __restrict__ G, float* __restrict__ out,
                 int Tf, int B, int C, int M, int P, int lowerN) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = M / 2 + 1;
  const int CP = C * P;
  const int S = lowerN + P - 1;
  const int CF = C * FB;
  cf* Ys = reinterpret_cast<cf*>(smem);  // [TC + S][C][FB]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int f = tid % FB;
  const int c = tid / FB;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FB;
  const int fg = f0 + f;
  const bool active = fg < F;
  const bool has_im = fg >= 1 && fg <= F - 2;
  const size_t frame_stride = (size_t)B * C * M;

  cf g[MAX_CP];
  int off[MAX_CP];
#pragma unroll
  for (int j = 0; j < MAX_CP; ++j) {
    g[j] = {0.f, 0.f};
    off[j] = f;
    if (j < CP) {
      const int a = j / P, dp = j - (j / P) * P;
      off[j] = ((S - lowerN - dp) * C + a) * FB + f;
      if (active) {
        g[j] = G[(((size_t)b * C + c) * F + fg) * CP + j];
        g[j].i = -g[j].i;  // conj(G)
      }
    }
  }
  const int offy = (S * C + c) * FB + f;
  float* orow = out + ((size_t)b * C + c) * M;

  for (int t0 = 0; t0 < Tf; t0 += TC) {
    const int nt = min(TC, Tf - t0);
    __syncthreads();
    // unrolled so that four loads are in flight before their stores
#pragma unroll 4
    for (int idx = tid; idx < (nt + S) * CF; idx += nthr) {
      const int ff = idx % FB, a = (idx / FB) % C, tt = idx / CF;
      const int t = t0 - S + tt, gf = f0 + ff;
      cf y = {0.f, 0.f};
      if (t >= 0 && gf < F) {
        const float* row = Yp + t * frame_stride + ((size_t)b * C + a) * M;
        y.r = row[gf];
        if (gf >= 1 && gf <= F - 2) y.i = row[F - 1 + gf];
      }
      Ys[idx] = y;
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const int t = t0 + tt;
      const int base = tt * CF;
      cf e = Ys[base + offy];
      if (t >= lowerN) {
        float pr = 0.f, pi = 0.f;
#pragma unroll
        for (int j = 0; j < MAX_CP; ++j) {
          if (j < CP) {
            const cf l = Ys[base + off[j]];
            pr += g[j].r * l.r - g[j].i * l.i;
            pi += g[j].r * l.i + g[j].i * l.r;
          }
        }
        e.r -= pr;
        e.i -= pi;
      }
      float* o = orow + t * frame_stride;
      o[fg] = e.r;
      if (has_im) o[F - 1 + fg] = e.i;
    }
  }
}

}  // namespace

extern "C" int dsr_wpe_resid(const float* Yp, const float* G, float* out, int Tf, int B, int C,
                             int M, int P, int lowerN, cudaStream_t stream) {
  if (Tf <= 0 || B <= 0 || B > 65535 || C <= 0 || C > 8 || P <= 0 || lowerN < 0 || M < 4 ||
      M % 2 != 0 || C * P > MAX_CP)
    return DSR_ERR_ARGS;
  const size_t smem = sizeof(cf) * (size_t)(TC + lowerN + P - 1) * C * FB;
  if (smem > 227 * 1024) return DSR_ERR_ARGS;
  cudaError_t err = cudaFuncSetAttribute(wpe_resid_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int F = M / 2 + 1;
  const dim3 grid((F + FB - 1) / FB, B);
  wpe_resid_kernel<<<grid, C * FB, smem, stream>>>(Yp, reinterpret_cast<const cf*>(G), out, Tf,
                                                   B, C, M, P, lowerN);
  return static_cast<int>(cudaGetLastError());
}
