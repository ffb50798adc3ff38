// GSC with the leaky power-normalised LMS active weight vector + Zelinski
// postfilter, one recursion over frames (BASELINE config 3).
//
// dsr_gsc_lms_zelinski computes what
// models/adaptive_gsc.gsc_postfilter_fused(kind="lms", real_packed=True,
// energy=None) computes, one frame at a time, within rounding: the same
// front as the GSC-RLS scan (Z = BmH X, Yc = wqH X, the silence gate on the
// smoothed reference-channel frame energy, the Zelinski gain;
// csrc/gsc_step.h's gsc_front) and the snapshot's power, then the LMS update
// (lms_update: the step size halved every slowdown_after frames, the
// smoothed subband power, the leaky normalised update on the old weights,
// the norm cap, the gated commit, the output on the committed weights).
// Input and output keep the packed time-major lanes [Re(0..M/2) | Im(1..M/2-1)].
// With pf_min_frames past the last frame the gain is never applied: the
// beamformer's output alone (postfilter "none").
//
// It replaces no TPU kernel: the JAX package runs this recursion in XLA, and a
// plain torch loop over the frames takes seconds a batch on a GPU.  Like the
// GSC-RLS scan (csrc/gsc_rls_zelinski.cu, whose design notes hold here) it is
// bound by the latency of a frame's dependent chain at small batches and by
// instruction issue at large ones, not by its bytes: one thread per
// (utterance, bin) in blocks of THREADS with the bin's weights and state in
// registers, the frames of a chunk staged ahead by cp.async with their frame
// energies computed a chunk at a time (two barriers a chunk), and frame t +
// 1's front beside frame t's update; the launch plan, the ring, the chunk
// energies and the snapshot read are the RLS scan's (csrc/gsc_scan.h).  The
// update is far shorter than the RLS one (no precision matrix), so the
// front, longer at C = 8 (56 complex products for Z), takes most of a frame.
// Its two divisions (gamma / se, and max_wa_l2norm / ||wa||^2 where the cap
// fires) run branch-free through BranchFreeOps, redone with the IEEE
// operators where it cannot vouch for a result.
#include "dsr_kernels.h"
#include "gsc_step.h"
#include "gsc_scan.h"

namespace {

using namespace dsr;

template <int C, int BC>
__global__ void __launch_bounds__(THREADS)
    gsc_lms_zelinski_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                            const float* __restrict__ bm, const float* __restrict__ ta,
                            float* __restrict__ out, int Tf, int B, int M, LmsParams p,
                            Plan pl) {
  extern __shared__ __align__(16) float smem[];
  const int F = M / 2 + 1;
  const long long n = (long long)B * F;
  const long long i0 = (long long)blockIdx.x * THREADS;
  const long long i = i0 + threadIdx.x;
  Blk k;
  k.Yp = Yp;
  k.B = B;
  k.M = M;
  k.F = F;
  k.valid = i < n;
  const long long ic = k.valid ? i : n - 1;  // idle lanes shadow the last bin, never write
  k.b = (int)(ic / F);
  k.f = (int)(ic - (long long)k.b * F);
  k.has_im = k.f >= 1 && k.f <= F - 2;
  k.b_lo = (int)(i0 / F);
  k.nu = (int)(((i0 + THREADS - 1 < n ? i0 + THREADS - 1 : n - 1) / F) - k.b_lo + 1);

  // ring slot j of the two at smem + j * pl.stage, then the energies
  float* en = smem + 2 * pl.stage;

  const size_t wf = k.f;  // one set of weights [F, ...] for every utterance
  cf wqc[C], tac[C], bmc[BC][C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wqc[c] = {wq[(wf * C + c) * 2], wq[(wf * C + c) * 2 + 1]};
    tac[c] = {ta[(wf * C + c) * 2], -ta[(wf * C + c) * 2 + 1]};  // conj(ta)
  }
#pragma unroll
  for (int q = 0; q < BC; ++q)
#pragma unroll
    for (int c = 0; c < C; ++c)
      bmc[q][c] = {bm[((wf * BC + q) * C + c) * 2], bm[((wf * BC + q) * C + c) * 2 + 1]};

  LmsState<BC> S = lms_start<BC>(p);
  GscFrontState fs = {{0.f, 0.f}, 0.f, p.g.delta};

  const int nchunks = (Tf + pl.TC - 1) / pl.TC;
  stage_chunk<C>(k, pl, smem, 0, min(pl.TC, Tf));
  if (nchunks > 1) {
    stage_chunk<C>(k, pl, smem + pl.stage, pl.TC, min(pl.TC, Tf - pl.TC));
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncthreads();
  chunk_energies(k, pl, smem, en, min(pl.TC, Tf));

  // the front of frame 0
  LmsFront<BC> fr;
  {
    cf X[C];
    read_snapshot<C>(k, pl, smem, 0, X);
    const float et = en[k.b - k.b_lo];
    BranchFreeOps op;
    GscFrontState s1 = fs;
    lms_front<C, BC>(fr, s1, wqc, bmc, tac, X, et, 0, p, op);
    if (!op.ok) {
      IeeeOps iv;
      s1 = fs;
      lms_front<C, BC>(fr, s1, wqc, bmc, tac, X, et, 0, p, iv);
    }
    fs = s1;
  }

  float* o = out + (size_t)k.b * M + k.f;  // this bin's lane of frame t's output row
  for (int t = 0; t < Tf; ++t) {
    const int t1 = t + 1;
    if (t1 < Tf && t1 % pl.TC == 0) {  // chunk t1 / TC starts: its copies were started a chunk ago
      const int kc = t1 / pl.TC;
      cp_wait<0>();
      __syncthreads();
      if (kc + 1 < nchunks)
        stage_chunk<C>(k, pl, smem + ((kc + 1) & 1) * pl.stage, t1 + pl.TC,
                       min(pl.TC, Tf - t1 - pl.TC));
      chunk_energies(k, pl, smem + (kc & 1) * pl.stage, en, min(pl.TC, Tf - t1));
    }
    // frame t1's front (frame Tf - 1's inputs again after the last frame,
    // and dropped) beside frame t's update
    const int tr = t1 < Tf ? t1 : Tf - 1;
    const int tt = tr % pl.TC;
    cf X[C];
    read_snapshot<C>(k, pl, smem + ((tr / pl.TC) & 1) * pl.stage, tt, X);
    const float et = en[tt * pl.NU + k.b - k.b_lo];
    BranchFreeOps op;
    LmsFront<BC> fn;
    GscFrontState s1 = fs;
    lms_front<C, BC>(fn, s1, wqc, bmc, tac, X, et, t1, p, op);
    LmsState<BC> S1 = S;
    cf Y = lms_update<BC>(S1, fr, t, p, op);
    if (!op.ok) {
      IeeeOps iv;
      s1 = fs;
      lms_front<C, BC>(fn, s1, wqc, bmc, tac, X, et, t1, p, iv);
      S1 = S;
      Y = lms_update<BC>(S1, fr, t, p, iv);
    }
    S = S1;
    fs = s1;
    fr = fn;
    if (k.valid) {
      o[0] = Y.r;
      if (k.has_im) o[F - 1] = Y.i;
    }
    o += (size_t)B * M;
  }
}

template <int C>
int launch(const float* Yp, const float* wq, const float* bm, const float* ta, float* out,
           int Tf, int B, int M, const LmsParams& p, const Plan& pl, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gsc_lms_zelinski_kernel<C, C - 1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gsc_lms_zelinski_kernel<C, C - 1><<<pl.blocks, THREADS, pl.bytes, stream>>>(
      Yp, wq, bm, ta, out, Tf, B, M, p, pl);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsr_gsc_lms_zelinski(const float* Yp, const float* wq, const float* bm,
                                    const float* ta, float* out, int Tf, int B, int C, int Bc,
                                    int M, float beta, float one_minus_beta, float gamma,
                                    float delta, float reg_param, float sil_thresh,
                                    float energy_floor, float max_wa_l2norm, int min_frames,
                                    int slowdown_after, float pf_alpha,
                                    float one_minus_pf_alpha, float pf_gain,
                                    float spectral_floor, int real_mode, int pf_min_frames,
                                    cudaStream_t stream) {
  if (!args_ok(Tf, B, C, Bc, M) || slowdown_after < 1) return DSR_ERR_ARGS;
  // the GscParams fields the LMS step does not read (mu, inv_delta,
  // constraint_option, alpha2) are zero
  const LmsParams p = {{beta, one_minus_beta, gamma, 0.f, delta, 0.f, reg_param, sil_thresh, 0,
                        0.f, max_wa_l2norm, min_frames,
                        {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                         pf_min_frames}},
                       energy_floor,
                       slowdown_after};
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan(B, C, M, sms);
  switch (C) {
#define DSR_CASE(c) \
  case c: return launch<c>(Yp, wq, bm, ta, out, Tf, B, M, p, pl, stream);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}
