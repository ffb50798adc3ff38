// WPE normal-equation statistics for one EM iteration.
//
// Replaces the Pallas TPU kernel ops/pallas_wpe.py wpe_stats_pallas /
// wpe_stats_from_planes (_make_kernel in mode "stats", _call) of
// distant_speech_recognition_tpu, and computes what one EM iteration of
// models/dereverberation.wpe_estimate accumulates, per (utterance b, bin f):
//   lags      L_t[j] = y_a[t - lowerN - dp],  j = a*P + dp   (zero before t = 0)
//   residual  e_c[t] = y_c[t] - conj(G[c, :]) . L_t          (has_g; else y_c[t])
//   weights   w_c[t] = 1 / max(|e_c[t]|, 1e-3)^2  for lowerN <= t < Tf, else 0
//   R[c,p,q]  = sum_t w_c[t] L_t[p] conj(L_t[q])
//   r[c,p]    = sum_t w_c[t] L_t[p] conj(y_c[t])
// from the packed frames Yp [Tf, B, C, M] ([Re(0..M/2) | Im(1..M/2-1)] lanes)
// and G [B, C, F, CP] (complex, CP = C*P), into R [B, C, F, CP, CP] (both
// triangles) and r [B, C, F, CP], complex.
//
// What bounds it on an H100: the accumulation, C * CP(CP+1)/2 complex
// multiply-adds per (utterance, bin, frame): about 3.3e11 FP32 flops per call
// at B=256 x 4 ch x 10 s with P=5, ~5 ms at the 67 TFLOP/s FP32 peak, against
// 1.3 GB of input (0.4 ms): it is bound by FP32 arithmetic.  The JAX package
// runs it at HIGHEST precision, so no TF32.  Design: one block per
// (utterance, group of FB bins); the frames are walked in chunks of TC.  Per
// chunk the block stages the complex frames of all C channels (with the
// lowerN + P - 1 frames of lag history) in shared memory, computes the C
// weight tracks there once, then every thread accumulates a 4x4 tile of the
// upper triangle of one target's R in registers, reading its lags from
// shared memory (one 8-byte load feeds four complex multiply-adds; tap slots
// past C*P read a channel of zeros that the stage carries for them).  The
// threads of a diagonal tile, which need only 10 of their 16 entries, take
// the 4 entries of r for the same rows, so every thread carries about the
// same load.  Sums run in frame order in FP32, IEEE division and sqrtf.
//
// The residual that sets the weights is computed in FP64 (from the FP32
// inputs, rounded to FP32 at the end): where a prediction cancels its target
// to a fraction of a percent (|e| ~ 1e-3 |y| with terms ~500 |y|, seen on the
// chain's own frames), 1/|e|^2 carries the prediction's rounding amplified
// by |pred terms|/|e|, and two FP32 evaluations of one EM iteration's R then
// differ by ~0.3% of max|R|.  In FP64 the weights are those of the inputs to
// FP32 precision.  It is CP complex multiply-adds (8 CP flops) per (target,
// frame, bin) in FP64 beside about 8 CP(CP+1)/2 + 10 CP in FP32: 8% of the
// flops, but an H100 runs FP64 at half its FP32 rate (34 against 67 TFLOP/s),
// so about 15% of the arithmetic time.
#include "dsr_kernels.h"

namespace {

constexpr int TC = 64;     // frames per chunk
constexpr int TILE = 4;    // rows and columns of a thread's tile
constexpr int MAX_THREADS = 512;
constexpr float SUBBAND_FLOOR = 1.0e-3f;  // dereverberation.cc:144

struct cf {
  float r, i;
};

// acc += a * conj(b)
__device__ __forceinline__ void cmac_conj(cf& acc, cf a, cf b) {
  acc.r += a.r * b.r + a.i * b.i;
  acc.i += a.i * b.r - a.r * b.i;
}

__global__ void __launch_bounds__(MAX_THREADS)
wpe_stats_kernel(const float* __restrict__ Yp, const cf* __restrict__ G, cf* __restrict__ R,
                 cf* __restrict__ r, int Tf, int B, int C, int M, int P, int lowerN, int has_g,
                 int FB, int nT) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int F = M / 2 + 1;
  const int CP = C * P;
  const int S = lowerN + P - 1;   // deepest lag
  const int CF = C * FB;          // one frame of weights
  const int RS = CF + FB;         // one frame of staged data: C channels + a zero one
  const int NJ = nT * TILE;       // tap slots of the tiles, CP of them used
  cf* Ys = reinterpret_cast<cf*>(smem);             // [TC + S][C + 1][FB]
  cf* Gs = Ys + (TC + S) * RS;                      // [C][CP][FB], conj(G)
  float* Ws = reinterpret_cast<float*>(Gs + C * CP * FB);  // [TC][C][FB]
  int* lagoff = reinterpret_cast<int*>(Ws + TC * CF);      // [NJ]

  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int b = blockIdx.y;
  const int f0 = blockIdx.x * FB;
  const size_t frame_stride = (size_t)B * C * M;

  // frame t0 + tt is staged at row tt + S, so its lag j = a*P + dp sits at
  // row tt + S - lowerN - dp, channel a; the tap slots past CP read the
  // zero channel C, so the tiles need no selects
  for (int j = tid; j < NJ; j += nthr) {
    const int a = j < CP ? j / P : C, dp = j < CP ? j - (j / P) * P : 0;
    lagoff[j] = ((S - lowerN - dp) * (C + 1) + a) * FB;
  }
  for (int idx = tid; idx < (TC + S) * FB; idx += nthr)
    Ys[(idx / FB) * RS + CF + idx % FB] = cf{0.f, 0.f};
  for (int idx = tid; idx < C * CP * FB; idx += nthr) {
    const int ff = idx % FB, j = (idx / FB) % CP, c = idx / (FB * CP);
    cf g = {0.f, 0.f};
    if (has_g && f0 + ff < F) {
      g = G[(((size_t)b * C + c) * F + f0 + ff) * CP + j];
      g.i = -g.i;
    }
    Gs[(c * CP + j) * FB + ff] = g;
  }

  // this thread's tile (ti, tj), ti <= tj, of target c and bin f0 + f
  const int f = tid % FB;
  const int c = (tid / FB) % C;
  const bool active = tid < nT * (nT + 1) / 2 * CF;
  int ti = 0, tj = 0;
  {
    int k = active ? tid / CF : 0;
    while (k >= nT - ti) {
      k -= nT - ti;
      ++ti;
    }
    tj = ti + k;
  }
  const bool diag = ti == tj;

  cf acc[TILE][TILE], racc[TILE];
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    racc[u] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < TILE; ++v) acc[u][v] = {0.f, 0.f};
  }
  __syncthreads();
  int offp[TILE], offq[TILE];
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    offp[u] = lagoff[ti * TILE + u] + f;
    offq[u] = lagoff[tj * TILE + u] + f;
  }
  const int offy = (S * (C + 1) + c) * FB + f;

  for (int t0 = 0; t0 < Tf; t0 += TC) {
    const int nt = min(TC, Tf - t0);
    __syncthreads();  // the previous chunk is consumed
    // stage frames t0 - S .. t0 + nt - 1 of every channel (zero before t = 0);
    // unrolled so that four loads are in flight before their stores
#pragma unroll 4
    for (int idx = tid; idx < (nt + S) * CF; idx += nthr) {
      const int ff = idx % FB, a = (idx / FB) % C, tt = idx / CF;
      const int t = t0 - S + tt, fg = f0 + ff;
      cf y = {0.f, 0.f};
      if (t >= 0 && fg < F) {
        const float* row = Yp + t * frame_stride + ((size_t)b * C + a) * M;
        y.r = row[fg];
        if (fg >= 1 && fg <= F - 2) y.i = row[F - 1 + fg];
      }
      Ys[tt * RS + a * FB + ff] = y;
    }
    __syncthreads();
    // weight tracks of the chunk, w = 0 outside lowerN <= t < Tf
    for (int idx = tid; idx < nt * CF; idx += nthr) {
      const int ff = idx % FB, cc = (idx / FB) % C, tt = idx / CF;
      const int t = t0 + tt;
      float w = 0.f;
      if (t >= lowerN) {
        cf e = Ys[(tt + S) * RS + cc * FB + ff];
        if (has_g) {
          // in float64: see the note on the residual at the top
          const cf* g = Gs + cc * CP * FB + ff;
          const cf* l = Ys + tt * RS + ff;
          double pr = 0.0, pi = 0.0;
          for (int j = 0; j < CP; ++j) {
            const cf gv = g[j * FB], lv = l[lagoff[j]];
            pr += (double)gv.r * lv.r - (double)gv.i * lv.i;
            pi += (double)gv.r * lv.i + (double)gv.i * lv.r;
          }
          e.r = (float)((double)e.r - pr);
          e.i = (float)((double)e.i - pi);
        }
        const float th = fmaxf(sqrtf(e.r * e.r + e.i * e.i), SUBBAND_FLOOR);
        w = 1.f / (th * th);
      }
      Ws[tt * CF + cc * FB + ff] = w;
    }
    __syncthreads();
    if (!active) continue;
    for (int tt = 0; tt < nt; ++tt) {
      const float w = Ws[tt * CF + c * FB + f];
      const int base = tt * RS;
      cf lp[TILE], lq[TILE];
#pragma unroll
      for (int u = 0; u < TILE; ++u) {
        const cf zp = Ys[base + offp[u]];
        lp[u] = cf{w * zp.r, w * zp.i};
        lq[u] = Ys[base + offq[u]];
      }
      if (diag) {
        const cf y = Ys[base + offy];
#pragma unroll
        for (int u = 0; u < TILE; ++u) {
          cmac_conj(racc[u], lp[u], y);
#pragma unroll
          for (int v = u; v < TILE; ++v) cmac_conj(acc[u][v], lp[u], lq[v]);
        }
      } else {
#pragma unroll
        for (int u = 0; u < TILE; ++u)
#pragma unroll
          for (int v = 0; v < TILE; ++v) cmac_conj(acc[u][v], lp[u], lq[v]);
      }
    }
  }

  const int fg = f0 + f;
  if (!active || fg >= F) return;
  const size_t sys = ((size_t)b * C + c) * F + fg;
  cf* Rs = R + sys * CP * CP;
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    const int p = ti * TILE + u;
    if (p >= CP) continue;
#pragma unroll
    for (int v = 0; v < TILE; ++v) {
      const int q = tj * TILE + v;
      if (q >= CP || (diag && v < u)) continue;
      Rs[p * CP + q] = acc[u][v];
      if (q != p) Rs[q * CP + p] = cf{acc[u][v].r, -acc[u][v].i};
    }
    if (diag) r[sys * CP + p] = racc[u];
  }
}

}  // namespace

extern "C" int dsr_wpe_stats(const float* Yp, const float* G, float* R, float* r, int Tf, int B,
                             int C, int M, int P, int lowerN, int has_g, cudaStream_t stream) {
  if (Tf <= 0 || B <= 0 || B > 65535 || C <= 0 || P <= 0 || lowerN < 0 || M < 4 ||
      M % 2 != 0 || C * P > 6 * TILE)
    return DSR_ERR_ARGS;
  const int CP = C * P;
  const int nT = (CP + TILE - 1) / TILE;
  const int ntiles = nT * (nT + 1) / 2;
  int FB = 8;
  while (FB > 1 && ntiles * C * FB > MAX_THREADS) FB /= 2;
  if (ntiles * C * FB > MAX_THREADS) return DSR_ERR_ARGS;
  const int S = lowerN + P - 1;
  const size_t smem = sizeof(cf) * ((size_t)(TC + S) * (C + 1) * FB + (size_t)C * CP * FB) +
                      sizeof(float) * (size_t)TC * C * FB + sizeof(int) * nT * TILE;
  if (smem > 227 * 1024) return DSR_ERR_ARGS;
  cudaError_t err = cudaFuncSetAttribute(wpe_stats_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int F = M / 2 + 1;
  const dim3 grid((F + FB - 1) / FB, B);
  const int threads = (ntiles * C * FB + 31) / 32 * 32;
  wpe_stats_kernel<<<grid, threads, smem, stream>>>(
      Yp, reinterpret_cast<const cf*>(G), reinterpret_cast<cf*>(R), reinterpret_cast<cf*>(r),
      Tf, B, C, M, P, lowerN, has_g, FB, nT);
  return static_cast<int>(cudaGetLastError());
}
