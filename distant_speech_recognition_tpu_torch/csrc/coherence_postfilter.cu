// McCowan, Lefkimmiatis and APAB postfilters over packed time-major frames.
//
// Replaces no TPU kernel: the JAX package runs these postfilters in XLA
// (models/postfilter.py mccowan_postfilter, lefkimmiatis_postfilter,
// apab_postfilter: scans over frames of two smoothed pair series).  Computes
// what models/coherence_postfilter.coherence_postfilter_plain computes, i.e.
// models/postfilter.coherence_apply on the unpacked frames:
//   a = conj(ta) X;  d_c = |a_c|^2;  per channel pair p = (i, j), i < j,
//   ss += (a_i conj(a_j) - 0.5 Rc_p (d_i + d_j)) / (1 - Rc_p)
//   vv += (0.5 (d_i + d_j) - a_i conj(a_j)) / (1 - Rn_p)     (Lefkimmiatis)
// each division a product with the host's reciprocal; the series smoothed
// from the third frame on (the reference's pre-increment frame counter),
// and the gain
//   McCowan       clip((2 v(ss) / (C (C-1))) / (sum_c d_c / C), 1e-4, 1)
//   Lefkimmiatis  clip(s / (s + n), 1e-4, 1), s = v(ss) k, n = v(vv) k / Lambda
//   APAB          clip(|Y|^2 / |sum_c a_c|^2, -1, 1), 1 where the reference
//                 is 0 and at the Nyquist bin, every frame
// with v the real part (REAL kinds) or the modulus (ABS kinds) and k =
// 2 / (C (C-1)); McCowan and Lefkimmiatis apply theirs from frame
// pf_min_frames + 1 on.  The clips pass a NaN through, as jnp.clip and
// torch.clamp do: like the JAX functions, McCowan and Lefkimmiatis have no
// guard for a silent bin.
// Input X [Tf, B, C, M] and output [Tf, B, M] keep the packed lanes
// [Re(0..M/2) | Im(1..M/2-1)]; the beamformer output Y is read from a packed
// [Tf, B, M] (a scan's) or, where none is given, formed here as
// sum_c wqH[c] X[c] (fixed weights, as K7 forms it).  All M/2 + 1 bins run
// the same code.  The per-bin constants k [K, F] (rows 0.5 Rc_p, 1/(1-Rc_p),
// 1/(1-Rn_p), Lambda; models/postfilter.coherence_constants) are real: the
// pipeline's coherence is the diffuse field's.
//
// What bounds it on an H100: each (utterance, bin) reads C*8 bytes of X (and
// 8 of Y) and writes 8 per frame for ~13 (McCowan) to ~22 (Lefkimmiatis)
// flops a channel pair, so it is bound by memory bytes (1.97 GB at B=256 x 4
// ch x 10 s with Y given, 0.59 ms at 3.35 TB/s) while enough loads are in
// flight: the smoothing is sequential over frames.  Design (K7's): one
// thread per (utterance, bin), consecutive threads on consecutive bins
// (loads and stores coalesce along the bins), the smoothed series in
// registers; FRAMES frames loaded together, all their loads in flight
// before any is used; the pair sums of those frames computed pair by pair,
// so each constant is read once (from L1) for FRAMES frames.  REAL kinds
// carry only the real parts of the series: the smoothing is real and
// linear and the constants are real.
#include "dsr_device.h"
#include "dsr_kernels.h"

namespace {

using namespace dsr;

constexpr int THREADS = 128;
constexpr int FRAMES = 4;  // frames loaded together

// the kinds of dsr_coherence_postfilter
enum Kind { MCCOWAN_REAL = 0, MCCOWAN_ABS = 1, LEFK_REAL = 2, LEFK_ABS = 3, APAB = 4 };

struct CoherenceParams {
  float alpha, one_minus_alpha, norm, spectral_floor;  // norm = 2 / (C (C-1))
  int min_frames;
};

// jnp.clip / torch.clamp: a NaN passes (both comparisons are false)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

template <int C, int KIND>
__global__ void __launch_bounds__(THREADS)
coherence_postfilter_kernel(const float* __restrict__ Xp, const float* __restrict__ Yp,
                            const float* __restrict__ wq, const float* __restrict__ ta,
                            const float* __restrict__ k, float* __restrict__ out, int Tf, int B,
                            int M, CoherenceParams p) {
  constexpr int NP = C * (C - 1) / 2;
  constexpr bool LEFK = KIND == LEFK_REAL || KIND == LEFK_ABS;
  constexpr bool REAL = KIND == MCCOWAN_REAL || KIND == LEFK_REAL;
  const int F = M / 2 + 1;
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long long)B * F) return;
  const int b = (int)(idx / F);
  const int f = (int)(idx - (long long)b * F);
  const bool has_im = f >= 1 && f <= F - 2;
  const bool form_y = Yp == nullptr;

  cf wqc[C], tac[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wqc[c] = form_y ? cf{wq[(f * C + c) * 2], wq[(f * C + c) * 2 + 1]} : cf{0.f, 0.f};
    tac[c] = {ta[(f * C + c) * 2], -ta[(f * C + c) * 2 + 1]};  // conj(ta)
  }
  const float lam = LEFK ? __ldg(k + (size_t)3 * NP * F + f) : 1.f;
  // the smoothed series: ss (McCowan's nu), vv, and McCowan's trace / C
  cf s_ss = {0.f, 0.f}, s_vv = {0.f, 0.f};
  float s_de = 0.f;

  const size_t in_stride = (size_t)B * C * M;
  const size_t out_stride = (size_t)B * M;
  const float* src = Xp + (size_t)b * C * M;
  const float* ysrc = form_y ? nullptr : Yp + (size_t)b * M;
  float* dst = out + (size_t)b * M;
  for (int t0 = 0; t0 < Tf; t0 += FRAMES) {
    cf a[FRAMES][C], Y[FRAMES];
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) {
      if (t0 + u < Tf) {
#pragma unroll
        for (int c = 0; c < C; ++c) a[u][c] = packed_bin(src + (t0 + u) * in_stride + c * M, F, f);
        if (!form_y) Y[u] = packed_bin(ysrc + (t0 + u) * out_stride, F, f);
      }
    }
    // the beamformer output where it is formed here, then the aligned snapshot
    float d[FRAMES][C];
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) {
      if (form_y) {
        Y[u] = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < C; ++c) Y[u] = cadd(Y[u], cmul(wqc[c], a[u][c]));
      }
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a[u][c] = cmul(tac[c], a[u][c]);
        d[u][c] = cabs2(a[u][c]);
      }
    }
    // this group's pair sums, each pair's constants read once for all frames
    cf ss[FRAMES], vv[FRAMES];
    if (KIND != APAB) {
#pragma unroll
      for (int u = 0; u < FRAMES; ++u) ss[u] = vv[u] = {0.f, 0.f};
      int pi = 0;
#pragma unroll
      for (int i = 0; i < C; ++i) {
#pragma unroll
        for (int j = i + 1; j < C; ++j, ++pi) {
          const float hc = __ldg(k + (size_t)pi * F + f);
          const float qc = __ldg(k + (size_t)(NP + pi) * F + f);
          const float qn = LEFK ? __ldg(k + (size_t)(2 * NP + pi) * F + f) : 0.f;
#pragma unroll
          for (int u = 0; u < FRAMES; ++u) {
            const cf x = cmulc(a[u][i], a[u][j]);
            const float dsum = d[u][i] + d[u][j];
            ss[u].r += (x.r - hc * dsum) * qc;
            if (!REAL) ss[u].i += x.i * qc;
            if (LEFK) {
              vv[u].r += (0.5f * dsum - x.r) * qn;
              if (!REAL) vv[u].i += -x.i * qn;
            }
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < FRAMES; ++u) {
      const int t = t0 + u;
      if (t >= Tf) break;
      float W;
      if (KIND == APAB) {
        cf ref = {0.f, 0.f};
#pragma unroll
        for (int c = 0; c < C; ++c) ref = cadd(ref, a[u][c]);
        const float xx = cabs2(ref);
        W = (f == F - 1 || !(xx > 0.f)) ? 1.f : clip(cabs2(Y[u]) / xx, -1.f, 1.f);
      } else {
        float de = 0.f;
        if (!LEFK) {
#pragma unroll
          for (int c = 0; c < C; ++c) de += d[u][c];
          de = de / (float)C;
        }
        if (t > 1 && p.alpha > 0.f) {
          s_ss.r = p.alpha * s_ss.r + p.one_minus_alpha * ss[u].r;
          if (!REAL) s_ss.i = p.alpha * s_ss.i + p.one_minus_alpha * ss[u].i;
          if (LEFK) {
            s_vv.r = p.alpha * s_vv.r + p.one_minus_alpha * vv[u].r;
            if (!REAL) s_vv.i = p.alpha * s_vv.i + p.one_minus_alpha * vv[u].i;
          } else {
            s_de = p.alpha * s_de + p.one_minus_alpha * de;
          }
        } else {
          s_ss = ss[u];
          s_vv = vv[u];
          s_de = de;
        }
        const float v_ss = REAL ? s_ss.r : sqrtf(cabs2(s_ss));
        if (LEFK) {
          const float v_vv = REAL ? s_vv.r : sqrtf(cabs2(s_vv));
          const float phi_ss = v_ss * p.norm;
          const float phi_nn = v_vv * p.norm / lam;
          W = clip(phi_ss / (phi_ss + phi_nn), p.spectral_floor, 1.f);
        } else {
          W = clip(2.f * v_ss / (float)(C * (C - 1)) / s_de, p.spectral_floor, 1.f);
        }
        if (t <= p.min_frames) W = 1.f;
      }
      const cf y = cscale(Y[u], W);
      float* o = dst + t * out_stride;
      o[f] = y.r;
      if (has_im) o[F + f - 1] = y.i;
    }
  }
}

template <int C, int KIND>
int launch(const float* Xp, const float* Yp, const float* wq, const float* ta, const float* k,
           float* out, int Tf, int B, int M, const CoherenceParams& p, cudaStream_t stream) {
  const long long n = (long long)B * (M / 2 + 1);
  coherence_postfilter_kernel<C, KIND>
      <<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, stream>>>(Xp, Yp, wq, ta, k, out,
                                                                        Tf, B, M, p);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch_kind(int kind, const float* Xp, const float* Yp, const float* wq, const float* ta,
                const float* k, float* out, int Tf, int B, int M, const CoherenceParams& p,
                cudaStream_t stream) {
  switch (kind) {
    case MCCOWAN_REAL: return launch<C, MCCOWAN_REAL>(Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case MCCOWAN_ABS: return launch<C, MCCOWAN_ABS>(Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case LEFK_REAL: return launch<C, LEFK_REAL>(Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case LEFK_ABS: return launch<C, LEFK_ABS>(Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case APAB: return launch<C, APAB>(Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    default: return DSR_ERR_ARGS;
  }
}

}  // namespace

extern "C" int dsr_coherence_postfilter(const float* Xp, const float* Yp, const float* wq,
                                        const float* ta, const float* k, float* out, int Tf,
                                        int B, int C, int M, int kind, float pf_alpha,
                                        float one_minus_pf_alpha, float pf_norm,
                                        float spectral_floor, int pf_min_frames,
                                        cudaStream_t stream) {
  if (Tf <= 0 || B <= 0 || M < 4 || M % 2 != 0 || kind < 0 || kind > APAB) return DSR_ERR_ARGS;
  if ((Yp == nullptr && wq == nullptr) || (kind != APAB && k == nullptr)) return DSR_ERR_ARGS;
  const CoherenceParams p = {pf_alpha, one_minus_pf_alpha, pf_norm, spectral_floor,
                             pf_min_frames};
  switch (C) {
    case 2: return launch_kind<2>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case 3: return launch_kind<3>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case 4: return launch_kind<4>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case 5: return launch_kind<5>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case 6: return launch_kind<6>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case 7: return launch_kind<7>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    case 8: return launch_kind<8>(kind, Xp, Yp, wq, ta, k, out, Tf, B, M, p, stream);
    default: return DSR_ERR_ARGS;
  }
}
