// One frame of the GSC-RLS beamformer + Zelinski postfilter for one bin,
// shared by the scan kernels (K2/K6, csrc/gsc_rls_zelinski.cu) and the
// one-kernel chains (K4/K5, csrc/gsc_mono.cu), so they round alike.  It
// computes what models/adaptive_gsc.gsc_postfilter_fused(kind="rls",
// real_packed=True, energy=None) computes for one frame, operation for
// operation:
//   blocking output Z = BmH X, quiescent output Yc = wqH X; RLS gain with the
//   compressed Hermitian precision Pz (real diagonal + upper triangle);
//   active-weight update with regularisation; quadratic constraint and norm
//   cap with precision reset; the silence gate on the smoothed reference-
//   channel frame energy; the Zelinski pair/trace CSD EMA and clamped gain.
// The frame energy couples the bins of an utterance: `block_sum` adds one
// value per thread over the block (warp shuffles, one barrier).
// Speculative values never meet a blend: the norm cap's sqrt(max/||wa||^2)
// is computed only inside the branch that uses it.  IEEE division and sqrtf.
#pragma once

#include "dsr_device.h"

namespace dsr {

__device__ __forceinline__ cf cdiv(cf a, cf b) {
  float s = b.r * b.r + b.i * b.i;
  s = s > 0.f ? s : 1.f;
  return {(a.r * b.r + a.i * b.i) / s, (a.i * b.r - a.r * b.i) / s};
}

struct GscParams {
  float beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh;
  int constraint_option;
  float alpha2, max_wa_l2norm;
  int min_frames;
  ZelinskiParams pf;
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

// Pairs (i < j) of BC blocking channels: the compressed precision's
// off-diagonal entries
__host__ __device__ constexpr int gsc_np(int BC) {
  return BC * (BC - 1) / 2 > 0 ? BC * (BC - 1) / 2 : 1;
}

// Sum of ``v`` over the block's threads: a shuffle reduction per warp, one
// barrier, then every thread adds the warps' sums in warp order.  ``red``
// holds 32 floats of shared memory; callers alternate two such slots by
// frame parity, so no second barrier is needed before the next call.  With
// BAR > 0 the threads are the first nwarps warps of the block only, and the
// barrier is the named barrier BAR over them.
template <int BAR = 0>
__device__ __forceinline__ float block_sum(float v, float* red, int lane, int warp, int nwarps) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if (lane == 0) red[warp] = v;
  if (BAR == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(BAR), "r"(32 * nwarps) : "memory");
  float sum = 0.f;
  for (int w = 0; w < nwarps; ++w) sum += red[w];
  return sum;
}

// Frame t of one bin: snapshot X, the bin's weights (wqc = wqH, bmc = BmH,
// tac = conj of the alignment manifold) and the utterance's reference-channel
// frame energy energy_t -> the beamformed, postfiltered output.  The bin's
// adaptive state for the whole utterance: the active weights waH, the
// compressed precision (diagonal d, upper triangle off), the Zelinski sums
// phi_pair and phi_diag and the smoothed frame energy; a new utterance
// starts from waH = 0, d = 1/delta, off = 0, phi = 0, energy = delta.
template <int C, int BC>
__device__ __forceinline__ cf gsc_rls_zelinski_step(cf (&waH)[BC], cf (&off)[gsc_np(BC)],
                                                    float (&d)[BC], cf& phi_pair, float& phi_diag,
                                                    float& energy, const cf (&wqc)[C],
                                                    const cf (&bmc)[BC][C], const cf (&tac)[C],
                                                    const cf (&X)[C], float energy_t, int t,
                                                    const GscParams& p) {
  constexpr int NP = gsc_np(BC);
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
  const float W = zelinski_gain<C>(phi_pair, phi_diag, tac, X, t, p.pf);
  if (t > p.pf.min_frames) Y = cscale(Y, W);
  return Y;
}

}  // namespace dsr
