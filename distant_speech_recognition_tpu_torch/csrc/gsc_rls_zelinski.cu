// Adaptive GSC-RLS beamformer + Zelinski postfilter, one recursion over frames.
//
// Replaces the Pallas TPU kernel models/pallas_fused_scan.py
// gsc_rls_zelinski_pallas (_call / _make_kernel) of
// distant_speech_recognition_tpu, and computes what
// models/adaptive_gsc.gsc_postfilter_fused(kind="rls", real_packed=True,
// energy=None) computes, operation for operation:
//   blocking output Z = BmH X, quiescent output Yc = wqH X; RLS gain with the
//   compressed Hermitian precision Pz (real diagonal + upper triangle);
//   active-weight update with regularisation; quadratic constraint and norm
//   cap with precision reset; the silence gate on the smoothed reference-
//   channel frame energy; the Zelinski pair/trace CSD EMA and clamped gain.
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
// Speculative values never meet a blend: the norm cap's sqrt(max/||wa||^2)
// is computed only inside the branch that uses it.  IEEE division and sqrtf.
#include "dsr_kernels.h"

#include <cstdint>

namespace {

struct cf {
  float r, i;
};

__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.r + b.r, a.i + b.i}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.r - b.r, a.i - b.i}; }
__device__ __forceinline__ cf cconj(cf a) { return {a.r, -a.i}; }
__device__ __forceinline__ cf cscale(cf a, float s) { return {a.r * s, a.i * s}; }
__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.r * b.r - a.i * b.i, a.r * b.i + a.i * b.r};
}
// a * conj(b)
__device__ __forceinline__ cf cmulc(cf a, cf b) {
  return {a.r * b.r + a.i * b.i, a.i * b.r - a.r * b.i};
}
__device__ __forceinline__ cf cdiv(cf a, cf b) {
  float s = b.r * b.r + b.i * b.i;
  s = s > 0.f ? s : 1.f;
  return {(a.r * b.r + a.i * b.i) / s, (a.i * b.r - a.r * b.i) / s};
}
__device__ __forceinline__ float cabs2(cf a) { return a.r * a.r + a.i * a.i; }

struct Params {
  float beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh;
  int constraint_option;
  float alpha2, max_wa_l2norm;
  int min_frames;
  float pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor;
  int real_mode, pf_min_frames;
};

// index of the pair (i, j), i < j, in the row-major upper triangle
template <int BC>
__device__ __forceinline__ constexpr int pidx(int i, int j) {
  return i * BC - i * (i + 1) / 2 + (j - i - 1);
}

// (Pz v)_i = d_i v_i + sum_{j>i} off_ij v_j + sum_{j<i} conj(off_ji) v_j
template <int BC>
__device__ __forceinline__ void pz_matvec(const float (&d)[BC], const cf* off, const cf (&v)[BC],
                                          cf (&out)[BC]) {
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    cf acc = cscale(v[i], d[i]);
#pragma unroll
    for (int j = i + 1; j < BC; ++j) acc = cadd(acc, cmul(off[pidx<BC>(i, j)], v[j]));
#pragma unroll
    for (int j = 0; j < i; ++j) acc = cadd(acc, cmul(cconj(off[pidx<BC>(j, i)]), v[j]));
    out[i] = acc;
  }
}

template <int C, int BC>
__global__ void gsc_rls_zelinski_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                                        const float* __restrict__ bm, const float* __restrict__ ta,
                                        float* __restrict__ out, int Tf, int B, int M, Params p) {
  constexpr int NP = BC * (BC - 1) / 2 > 0 ? BC * (BC - 1) / 2 : 1;
  __shared__ float red[2][32];

  const int F = M / 2 + 1;
  const int f = threadIdx.x;
  const int b = blockIdx.x;
  const bool active = f < F;
  const int fc = active ? f : F - 1;  // idle lanes shadow the last bin and never write
  const bool has_im = fc >= 1 && fc <= F - 2;
  const float ew = (fc == 0 || fc == F - 1) ? 1.f : 2.f;
  const int lane = f & 31;
  const int warp = f >> 5;
  const int nwarps = blockDim.x >> 5;

  cf wqc[C], tac[C], bmc[BC][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wqc[c] = {wq[(fc * C + c) * 2], wq[(fc * C + c) * 2 + 1]};
    tac[c] = {ta[(fc * C + c) * 2], -ta[(fc * C + c) * 2 + 1]};  // conj(ta)
  }
#pragma unroll
  for (int i = 0; i < BC; ++i)
#pragma unroll
    for (int c = 0; c < C; ++c)
      bmc[i][c] = {bm[((fc * BC + i) * C + c) * 2], bm[((fc * BC + i) * C + c) * 2 + 1]};

  cf waH[BC], off[NP];
  float d[BC];
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    waH[i] = {0.f, 0.f};
    d[i] = p.inv_delta;
  }
#pragma unroll
  for (int n = 0; n < NP; ++n) off[n] = {0.f, 0.f};
  cf phi_pair = {0.f, 0.f};
  float phi_diag = 0.f;
  float energy = p.delta;

  const size_t frame_stride = (size_t)B * C * M;
  const float* src = Yp + (size_t)b * C * M;
  cf X[C], Xn[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    X[c].r = src[c * M + fc];
    X[c].i = has_im ? src[c * M + F + fc - 1] : 0.f;
  }

  for (int t = 0; t < Tf; ++t) {
    if (t + 1 < Tf) {
      const float* nx = src + (size_t)(t + 1) * frame_stride;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        Xn[c].r = nx[c * M + fc];
        Xn[c].i = has_im ? nx[c * M + F + fc - 1] : 0.f;
      }
    }

    // reference-channel frame energy of this utterance (all bins)
    float e = active ? ew * cabs2(X[0]) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) e += __shfl_xor_sync(0xffffffffu, e, o);
    if (lane == 0) red[t & 1][warp] = e;
    __syncthreads();
    float esum = 0.f;
    for (int w = 0; w < nwarps; ++w) esum += red[t & 1][w];
    const float energy_t = esum / (float)M;
    const bool gate = energy_t > energy / p.sil_thresh;

    cf Z[BC];
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      cf z = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < C; ++c) z = cadd(z, cmul(bmc[i][c], X[c]));
      Z[i] = z;
    }
    cf Yc = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) Yc = cadd(Yc, cmul(wqc[c], X[c]));

    // gain vector and precision update
    cf PzZ[BC];
    pz_matvec<BC>(d, off, Z, PzZ);
    cf ip = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BC; ++i) ip = cadd(ip, cmul(cconj(Z[i]), PzZ[i]));
    const cf den = {p.mu + ip.r, ip.i};
    cf gz[BC];
    float dK[BC];
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      gz[i] = cdiv(PzZ[i], den);
      dK[i] = (d[i] - cmulc(gz[i], PzZ[i]).r) / p.mu;
    }
    cf offK[NP];
#pragma unroll
    for (int n = 0; n < NP; ++n) offK[n] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < BC; ++i)
#pragma unroll
      for (int j = i + 1; j < BC; ++j) {
        const int n = pidx<BC>(i, j);
        const cf v = csub(off[n], cmulc(gz[i], PzZ[j]));
        offK[n] = {v.r / p.mu, v.i / p.mu};
      }

    // active weight update
    cf ep = Yc;
#pragma unroll
    for (int i = 0; i < BC; ++i) ep = csub(ep, cmul(waH[i], Z[i]));
    cf wn[BC];
#pragma unroll
    for (int i = 0; i < BC; ++i) wn[i] = cadd(waH[i], cmul(cscale(cconj(gz[i]), p.gamma), ep));
    if (p.reg_param > 0.f) {
      // conj(PzK) matvec on the old weights
#pragma unroll
      for (int i = 0; i < BC; ++i) {
        cf r = cscale(waH[i], dK[i]);
#pragma unroll
        for (int j = i + 1; j < BC; ++j) r = cadd(r, cmul(cconj(offK[pidx<BC>(i, j)]), waH[j]));
#pragma unroll
        for (int j = 0; j < i; ++j) r = cadd(r, cmul(offK[pidx<BC>(j, i)], waH[j]));
        wn[i] = csub(wn[i], cscale(r, p.reg_param));
      }
    }

    if (p.constraint_option > 0) {
      float waK2 = 0.f;
#pragma unroll
      for (int i = 0; i < BC; ++i) waK2 += cabs2(wn[i]);
      if ((p.constraint_option == 1 || p.constraint_option == 3) && waK2 > p.alpha2) {
        // quadratic constraint (pybeamformer.py:849-861)
        cf waK[BC], va[BC];
#pragma unroll
        for (int i = 0; i < BC; ++i) waK[i] = cconj(wn[i]);
        pz_matvec<BC>(dK, offK, waK, va);
        float a = 0.f, bsum = 0.f;
#pragma unroll
        for (int i = 0; i < BC; ++i) {
          a += cabs2(va[i]);
          bsum += cmulc(waK[i], va[i]).r;  // Re(conj(va) waK)
        }
        const float bq = -2.f * bsum;
        const float cc = waK2 - p.alpha2;
        const float arg = bq * bq - 4.f * a * cc;
        const float a_safe = a > 0.f ? a : 1.f;
        const float betaK = arg > 0.f ? -(bq + sqrtf(arg)) / (2.f * a_safe) : -bq / (2.f * a_safe);
#pragma unroll
        for (int i = 0; i < BC; ++i) wn[i] = csub(wn[i], cscale(cconj(va[i]), betaK));
      }
      // norm cap + precision reset (pybeamformer.py:862-865), on the
      // pre-constraint norm like the reference
      if (p.constraint_option >= 2 && waK2 > p.max_wa_l2norm) {
        const float scale = sqrtf(p.max_wa_l2norm / waK2);
#pragma unroll
        for (int i = 0; i < BC; ++i) {
          wn[i] = cscale(wn[i], scale);
          dK[i] = p.inv_delta;
        }
#pragma unroll
        for (int n = 0; n < NP; ++n) offK[n] = {0.f, 0.f};
      }
    }

    if (gate) {
#pragma unroll
      for (int i = 0; i < BC; ++i) {
        waH[i] = wn[i];
        d[i] = dK[i];
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) off[n] = offK[n];
    }
    cf Y = Yc;
    if (t >= p.min_frames) {
#pragma unroll
      for (int i = 0; i < BC; ++i) Y = csub(Y, cmul(waH[i], Z[i]));
    }
    energy = energy * p.beta + p.one_minus_beta * energy_t;

    // Zelinski postfilter on the time-aligned snapshot
    cf al[C];
#pragma unroll
    for (int c = 0; c < C; ++c) al[c] = cmul(tac[c], X[c]);
    cf ps = {0.f, 0.f};
    float ds = 0.f;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      ds += cabs2(al[i]);
#pragma unroll
      for (int j = i + 1; j < C; ++j) ps = cadd(ps, cmulc(al[i], al[j]));
    }
    if (t > 1) {
      phi_pair = cadd(cscale(phi_pair, p.pf_alpha), cscale(ps, p.one_minus_pf_alpha));
      phi_diag = p.pf_alpha * phi_diag + p.one_minus_pf_alpha * ds;
    } else {
      phi_pair = ps;
      phi_diag = ds;
    }
    const float num = p.real_mode ? fmaxf(phi_pair.r, 0.f) : sqrtf(cabs2(phi_pair));
    const float ratio = phi_diag > 0.f ? num / phi_diag : 0.f;
    const float W = fminf(fmaxf(ratio * p.pf_gain, p.spectral_floor), 1.f);
    if (t > p.pf_min_frames) Y = cscale(Y, W);

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
           int Tf, int B, int M, const Params& p, cudaStream_t stream) {
  const int F = M / 2 + 1;
  const int threads = (F + 31) / 32 * 32;
  gsc_rls_zelinski_kernel<C, C - 1><<<B, threads, 0, stream>>>(Yp, wq, bm, ta, out, Tf, B, M, p);
  return static_cast<int>(cudaGetLastError());
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
  // one thread per bin, at most 256 bins (M <= 510) per block
  if (Tf <= 0 || B <= 0 || M < 4 || M % 2 != 0 || M / 2 + 1 > 256 || Bc != C - 1)
    return DSR_ERR_ARGS;
  const Params p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames, pf_alpha,
                    one_minus_pf_alpha, pf_gain, spectral_floor, real_mode, pf_min_frames};
  switch (C) {
    case 2: return launch<2>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    case 3: return launch<3>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    case 4: return launch<4>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    case 5: return launch<5>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    case 6: return launch<6>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    case 7: return launch<7>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    case 8: return launch<8>(Yp, wq, bm, ta, out, Tf, B, M, p, stream);
    default: return DSR_ERR_ARGS;
  }
}
