// One frame of the GSC-RLS beamformer + Zelinski postfilter for one bin,
// shared by the scan kernels (K2/K6, csrc/gsc_rls_zelinski.cu) and the
// one-kernel chains (K4/K5, csrc/gsc_mono.cu), so they round alike.  The RLS
// step computes what models/adaptive_gsc.gsc_postfilter_fused(kind="rls",
// real_packed=True, energy=None) computes for one frame, operation for
// operation, in two halves:
//   - the state-free front (`gsc_front`): blocking output Z = BmH X,
//     quiescent output Yc = wqH X, the silence gate on the smoothed
//     reference-channel frame energy, the Zelinski pair/trace CSD EMA and
//     clamped gain; it reads the bin's snapshot and fixed weights and carries
//     only the energy and CSD recursions, none of the RLS state;
//   - the state update (`gsc_update`): RLS gain with the compressed Hermitian
//     precision Pz (real diagonal + upper triangle); active-weight update with
//     regularisation; quadratic constraint and norm cap with precision reset;
//     the gated commit; the output.
// Each half runs its divisions through a policy (dsr_device.h):
// BranchFreeOps, and where it cannot vouch for a quotient, IeeeOps again
// from the same inputs, so both give the IEEE operators' bits.  The halves'
// other operations are the ones the step had in one piece, in the same
// order; the front has no branch, so a compiler can interleave it with
// other work.  Speculative values never meet a blend: the norm cap's
// sqrt(max/||wa||^2) is computed only inside the branch that uses it (IEEE
// sqrtf there).
// The frame energy couples the bins of an utterance: K4/K5 reduce it each
// frame with `block_sum` (warp shuffles, one barrier); K2/K6 compute it a
// chunk of frames at a time in the same order, from `energy_term`.
#pragma once

#include "dsr_device.h"

namespace dsr {

// a / b for complex a, b: a conj(b) / |b|^2 (1 where |b|^2 is 0); rb is
// op.recip of that divisor, shared by the quotients of one b
__device__ __forceinline__ float cdiv_divisor(cf b) {
  const float s = b.r * b.r + b.i * b.i;
  return s > 0.f ? s : 1.f;
}
template <class Ops>
__device__ __forceinline__ cf cdiv(cf a, cf b, typename Ops::R rb, Ops& op) {
  return {op.div(a.r * b.r + a.i * b.i, rb), op.div(a.i * b.r - a.r * b.i, rb)};
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

// One reference-channel bin's term of the frame energy: ew |X0|^2 (ew = 1 at
// DC and Nyquist, 2 elsewhere), with nvcc's contraction of cabs2 written out
__device__ __forceinline__ float energy_term(float ew, cf x0) {
  return __fmul_rn(ew, __fmaf_rn(x0.r, x0.r, __fmul_rn(x0.i, x0.i)));
}

// The adaptive state of one bin for the whole utterance: the active weights
// waH and the compressed precision (diagonal d, upper triangle off); a new
// utterance starts from waH = 0, d = 1/delta, off = 0
template <int BC>
struct GscState {
  cf waH[BC];
  cf off[gsc_np(BC)];
  float d[BC];
};

// The recursions of the front: the Zelinski sums and the smoothed frame
// energy; a new utterance starts from phi = 0, energy = delta
struct GscFrontState {
  cf phi_pair;
  float phi_diag;
  float energy;
};

// A new utterance's state
template <int BC>
__device__ __forceinline__ GscState<BC> gsc_start(const GscParams& p) {
  GscState<BC> S;
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    S.waH[i] = {0.f, 0.f};
    S.d[i] = p.inv_delta;
  }
#pragma unroll
  for (int n = 0; n < gsc_np(BC); ++n) S.off[n] = {0.f, 0.f};
  return S;
}

// What the front hands the update for one frame
template <int BC>
struct GscFront {
  cf Z[BC];
  cf Yc;
  float W;    // Zelinski gain
  bool gate;  // the frame adapts
};

// The state-free front of frame t of one bin: snapshot X, the bin's weights
// (wqc = wqH, bmc = BmH, tac = conj of the alignment manifold) and the
// utterance's reference-channel frame energy energy_t.
template <int C, int BC, class Ops>
__device__ __forceinline__ void gsc_front(GscFront<BC>& o, GscFrontState& s, const cf (&wqc)[C],
                                          const cf (&bmc)[BC][C], const cf (&tac)[C],
                                          const cf (&X)[C], float energy_t, int t,
                                          const GscParams& p, Ops& op) {
  o.gate = energy_t > op.div(s.energy, op.recip(p.sil_thresh));
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    cf z = {0.f, 0.f};
#pragma unroll
    for (int c = 0; c < C; ++c) z = cadd(z, cmul(bmc[i][c], X[c]));
    o.Z[i] = z;
  }
  cf Yc = {0.f, 0.f};
#pragma unroll
  for (int c = 0; c < C; ++c) Yc = cadd(Yc, cmul(wqc[c], X[c]));
  o.Yc = Yc;
  s.energy = s.energy * p.beta + p.one_minus_beta * energy_t;
  // Zelinski postfilter on the time-aligned snapshot: dsr_device.h's
  // zelinski_gain without a branch (the frame count and the trace pick with
  // selects, the quotient by 1 where the trace is 0), |phi_pair|^2 fused as
  // nvcc fused it there
  cf ps;
  float ds;
  zelinski_sums<C>(tac, X, ps, ds);
  const ZelinskiParams& z = p.pf;
  const cf pe = cadd(cscale(s.phi_pair, z.alpha), cscale(ps, z.one_minus_alpha));
  const float de = z.alpha * s.phi_diag + z.one_minus_alpha * ds;
  s.phi_pair = t > 1 ? pe : ps;
  s.phi_diag = t > 1 ? de : ds;
  const cf& ph = s.phi_pair;
  const float mod = op.sqrt(z.real_mode ? 1.f : __fmaf_rn(ph.r, ph.r, __fmul_rn(ph.i, ph.i)));
  const float num = z.real_mode ? fmaxf(ph.r, 0.f) : mod;
  const bool trace = s.phi_diag > 0.f;
  const float q = op.div(num, op.recip(trace ? s.phi_diag : 1.f));
  o.W = fminf(fmaxf((trace ? q : 0.f) * z.gain, z.spectral_floor), 1.f);
}

// The state update of frame t of one bin from its front: the new state in S,
// the beamformed, postfiltered output returned.
template <int BC, class Ops>
__device__ __forceinline__ cf gsc_update(GscState<BC>& S, const GscFront<BC>& fr, int t,
                                         const GscParams& p, Ops& op) {
  constexpr int NP = gsc_np(BC);
  cf(&waH)[BC] = S.waH;
  cf(&off)[NP] = S.off;
  float(&d)[BC] = S.d;
  const cf(&Z)[BC] = fr.Z;

  // gain vector and precision update
  cf PzZ[BC];
  pz_matvec<BC>(d, off, Z, PzZ);
  cf ip = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BC; ++i) ip = cadd(ip, cmul(cconj(Z[i]), PzZ[i]));
  const cf den = {p.mu + ip.r, ip.i};
  const typename Ops::R rmu = op.recip(p.mu);
  const typename Ops::R rden = op.recip(cdiv_divisor(den));
  cf gz[BC];
  float dK[BC];
#pragma unroll
  for (int i = 0; i < BC; ++i) {
    gz[i] = cdiv(PzZ[i], den, rden, op);
    dK[i] = op.div(d[i] - cmulc(gz[i], PzZ[i]).r, rmu);
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
      offK[n] = {op.div(v.r, rmu), op.div(v.i, rmu)};
    }

  // active weight update
  cf ep = fr.Yc;
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
      const typename Ops::R r2a = op.recip(2.f * a_safe);
      const float betaK = arg > 0.f ? op.div(-(bq + sqrtf(arg)), r2a) : op.div(-bq, r2a);
#pragma unroll
      for (int i = 0; i < BC; ++i) wn[i] = csub(wn[i], cscale(cconj(va[i]), betaK));
    }
    // norm cap + precision reset (pybeamformer.py:862-865), on the
    // pre-constraint norm like the reference
    if (p.constraint_option >= 2 && waK2 > p.max_wa_l2norm) {
      const float scale = sqrtf(op.div(p.max_wa_l2norm, op.recip(waK2)));
#pragma unroll
      for (int i = 0; i < BC; ++i) {
        wn[i] = cscale(wn[i], scale);
        dK[i] = p.inv_delta;
      }
#pragma unroll
      for (int n = 0; n < NP; ++n) offK[n] = {0.f, 0.f};
    }
  }

  if (fr.gate) {
#pragma unroll
    for (int i = 0; i < BC; ++i) {
      waH[i] = wn[i];
      d[i] = dK[i];
    }
#pragma unroll
    for (int n = 0; n < NP; ++n) off[n] = offK[n];
  }
  cf Y = fr.Yc;
  if (t >= p.min_frames) {
#pragma unroll
    for (int i = 0; i < BC; ++i) Y = csub(Y, cmul(waH[i], Z[i]));
  }
  if (t > p.pf.min_frames) Y = cscale(Y, fr.W);
  return Y;
}

// Frame t of one bin in one piece: the front, then the update, both with
// BranchFreeOps, and both again with IeeeOps where it could not vouch for a
// result.  The state (S, s) moves to frame t + 1.
template <int C, int BC>
__device__ __forceinline__ cf gsc_rls_zelinski_step(GscState<BC>& S, GscFrontState& s,
                                                    const cf (&wqc)[C], const cf (&bmc)[BC][C],
                                                    const cf (&tac)[C], const cf (&X)[C],
                                                    float energy_t, int t, const GscParams& p) {
  BranchFreeOps op;
  GscFront<BC> fr;
  GscFrontState s1 = s;
  gsc_front<C, BC>(fr, s1, wqc, bmc, tac, X, energy_t, t, p, op);
  GscState<BC> S1 = S;
  cf Y = gsc_update<BC>(S1, fr, t, p, op);
  if (!op.ok) {
    IeeeOps iv;
    s1 = s;
    gsc_front<C, BC>(fr, s1, wqc, bmc, tac, X, energy_t, t, p, iv);
    S1 = S;
    Y = gsc_update<BC>(S1, fr, t, p, iv);
  }
  S = S1;
  s = s1;
  return Y;
}

}  // namespace dsr
