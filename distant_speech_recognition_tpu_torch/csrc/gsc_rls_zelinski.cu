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
// the one-kernel chains K4/K5 (csrc/gsc_step.h), to the bit.
// Input and output keep the packed time-major lanes [Re(0..M/2) | Im(1..M/2-1)].
//
// What bounds it on an H100: the recursion is sequential over frames and
// independent over (utterance, bin); per frame each (utterance, bin) reads
// C*8 bytes and does a few hundred flops, so it is bound by the latency of
// one frame's dependent chain (at small batches) and by instruction issue
// (at large ones), not by bandwidth or flops.  Design:
//   - one thread per (utterance, bin), the flattened index b*F + f cut into
//     blocks of 128 threads, so that no lane idles; the bin's state and
//     weights live in its thread's registers for the whole utterance.  At
//     B = 64 that is 65 blocks, one warp per scheduler of 65 SMs; blocks of
//     64 threads over 129 SMs were slower, each block redoing the frame
//     energies of the utterances it touches (PERF.md);
//   - the silence gate couples the bins of an utterance through the
//     reference channel's frame energy.  Each block computes the energy of
//     every utterance it touches itself, for a chunk of TC frames at once
//     (one shuffle tree per group of 32 bins and frame, then the groups in
//     order: `block_sum`'s bits), behind two barriers a chunk instead of one
//     a frame;
//   - a ring of two chunks in shared memory, filled by cp.async one chunk
//     ahead: the reference channel's whole rows of the utterances the block
//     touches, and each thread's own bin of the other channels;
//   - above 257 bins (M = 1024, 2048; PRE) an utterance spans up to nine
//     blocks, so the energies come from a pre-pass on the stream, once per
//     (frame, utterance) and in the blocks' order, into the caller's buffer
//     of `dsr_gsc_rls_zelinski_energy_floats` floats
//     (`energy_prepass_kernel`, csrc/gsc_scan.h), and a chunk
//     stages each thread's bin of every channel and those energies instead
//     of the reference rows;
//   - the state-free front of frame t + 1 (Z, Yc, gate, Zelinski gain) is
//     computed beside frame t's state update; the front has no branch and
//     the divisions of both run branch-free (BranchFreeOps, dsr_device.h),
//     so the compiler can interleave the front with the update.  The IEEE
//     division nvcc emits is a fast path, a range check and a branch around
//     a slow-path call, and a frame has ~17 of them, which then run one
//     after the other.  A frame that BranchFreeOps cannot vouch for is
//     redone with the IEEE operators (not on ordinary data).
// The launch plan, the frame ring, the chunk energies and the snapshot read
// live in csrc/gsc_scan.h.  This kernel's own text is left as it was: the
// same step reached through a step policy was rounded otherwise by nvcc at
// C = 2 (PERF.md).
#include "dsr_kernels.h"
#include "gsc_step.h"
#include "gsc_scan.h"

#include <cstdint>

namespace {

using namespace dsr;

template <int C, int BC, bool PRE>
__global__ void __launch_bounds__(THREADS)
    gsc_rls_zelinski_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                            const float* __restrict__ bm, const float* __restrict__ ta,
                            float* __restrict__ out, const float* __restrict__ en_pre, int Tf,
                            int B, int M, bool per_utt, GscParams p, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  // probe: kernel start
  const int F = M / 2 + 1;
  const long long n = (long long)B * F;
  const long long i0 = (long long)blockIdx.x * THREADS;
  const long long i = i0 + threadIdx.x;
  Blk k;
  k.Yp = Yp;
  k.en = en_pre;
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

  const size_t wf = (per_utt ? (size_t)k.b * F : 0) + k.f;  // this utterance's row of bin f
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

  GscState<BC> S = gsc_start<BC>(p);
  GscFrontState fs = {{0.f, 0.f}, 0.f, p.delta};
  // probe: set-up done

  const int nchunks = (Tf + pl.TC - 1) / pl.TC;
  stage_chunk<C, PRE>(k, pl, smem, 0, min(pl.TC, Tf));
  if (nchunks > 1) {
    stage_chunk<C, PRE>(k, pl, smem + pl.stage, pl.TC, min(pl.TC, Tf - pl.TC));
    cp_wait<1>();
  } else {
    cp_wait<0>();
  }
  __syncthreads();
  chunk_energies<PRE>(k, pl, smem, en, min(pl.TC, Tf));

  // the front of frame 0
  GscFront<BC> fr;
  {
    cf X[C];
    read_snapshot<C, PRE>(k, pl, smem, 0, X);
    const float et = chunk_energy_rows<C, PRE>(pl, smem, en)[k.b - k.b_lo];
    BranchFreeOps op;
    GscFrontState s1 = fs;
    gsc_front<C, BC>(fr, s1, wqc, bmc, tac, X, et, 0, p, op);
    if (!op.ok) {
      IeeeOps iv;
      s1 = fs;
      gsc_front<C, BC>(fr, s1, wqc, bmc, tac, X, et, 0, p, iv);
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
      // probe: chunk staged
      if (kc + 1 < nchunks)
        stage_chunk<C, PRE>(k, pl, smem + ((kc + 1) & 1) * pl.stage, t1 + pl.TC,
                            min(pl.TC, Tf - t1 - pl.TC));
      chunk_energies<PRE>(k, pl, smem + (kc & 1) * pl.stage, en, min(pl.TC, Tf - t1));
    }
    // frame t1's front (frame Tf - 1's inputs again after the last frame,
    // and dropped) beside frame t's update
    const int tr = t1 < Tf ? t1 : Tf - 1;
    const int tt = tr % pl.TC;
    cf X[C];
    const float* slot = smem + ((tr / pl.TC) & 1) * pl.stage;
    read_snapshot<C, PRE>(k, pl, slot, tt, X);
    const float et = chunk_energy_rows<C, PRE>(pl, slot, en)[tt * pl.NU + k.b - k.b_lo];
    BranchFreeOps op;
    GscFront<BC> fn;
    GscFrontState s1 = fs;
    gsc_front<C, BC>(fn, s1, wqc, bmc, tac, X, et, t1, p, op);
    // probe: front done
    GscState<BC> S1 = S;
    cf Y = gsc_update<BC>(S1, fr, t, p, op);
    if (!op.ok) {
      IeeeOps iv;
      s1 = fs;
      gsc_front<C, BC>(fn, s1, wqc, bmc, tac, X, et, t1, p, iv);
      S1 = S;
      Y = gsc_update<BC>(S1, fr, t, p, iv);
    }
    S = S1;
    fs = s1;
    fr = fn;
    // probe: chain done
    if (k.valid) {
      o[0] = Y.r;
      if (k.has_im) o[F - 1] = Y.i;
    }
    o += (size_t)B * M;
    // probe: stored
  }
  // probe: kernel end
}

// the kernel of (C, M): PRE above 257 bins
template <int C>
const void* kernel_of(int M) {
  return pre_pass(M) ? (const void*)gsc_rls_zelinski_kernel<C, C - 1, true>
                     : (const void*)gsc_rls_zelinski_kernel<C, C - 1, false>;
}

template <int C, bool PRE>
int launch_kernel(const float* Yp, const float* wq, const float* bm, const float* ta, float* out,
                  float* en, int Tf, int B, int M, bool per_utt, const GscParams& p,
                  const Plan& pl, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gsc_rls_zelinski_kernel<C, C - 1, PRE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  // PRE: the energies into en, first
  if (PRE && (err = energy_prepass(Yp, en, Tf, B, C, M, stream)) != cudaSuccess)
    return static_cast<int>(err);
  gsc_rls_zelinski_kernel<C, C - 1, PRE><<<pl.blocks, THREADS, pl.bytes, stream>>>(
      Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int launch(const float* Yp, const float* wq, const float* bm, const float* ta, float* out,
           float* en, int Tf, int B, int M, bool per_utt, const GscParams& p, const Plan& pl,
           cudaStream_t stream) {
  return pre_pass(M) ? launch_kernel<C, true>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl,
                                               stream)
                     : launch_kernel<C, false>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl,
                                                stream);
}

int scan(const float* Yp, const float* wq, const float* bm, const float* ta, float* out,
         float* en, int Tf, int B, int C, int Bc, int M, bool per_utt, const GscParams& p,
         cudaStream_t stream) {
  if (!args_ok(Tf, B, C, Bc, M) || (pre_pass(M) && en == nullptr)) return DSR_ERR_ARGS;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan(B, C, M, sms);
  switch (C) {
    case 2: return launch<2>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    case 3: return launch<3>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    case 4: return launch<4>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    case 5: return launch<5>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    case 6: return launch<6>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    case 7: return launch<7>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    case 8: return launch<8>(Yp, wq, bm, ta, out, en, Tf, B, M, per_utt, p, pl, stream);
    default: return DSR_ERR_ARGS;
  }
}

// the launch shape of (B, C, M), frames per chunk, and the kernel's registers
// and blocks per SM
template <int C>
int shape(int B, int M, int* blocks, int* threads, int* frames, int* smem_bytes, int* regs,
          int* blocks_per_sm) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan(B, C, M, sms);
  *blocks = pl.blocks;
  *threads = THREADS;
  *frames = pl.TC;
  *smem_bytes = (int)pl.bytes;
  cudaFuncAttributes a;
  const void* kern = kernel_of<C>(M);
  err = cudaFuncGetAttributes(&a, kern);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kern, THREADS, pl.bytes);
  return static_cast<int>(err);
}

}  // namespace

extern "C" int dsr_gsc_rls_zelinski_energy_floats(int Tf, int B, int M) {
  return pre_pass(M) ? Tf * B : 0;
}

extern "C" int dsr_gsc_rls_zelinski(const float* Yp, const float* wq, const float* bm,
                                    const float* ta, float* out, float* en, int Tf, int B,
                                    int C, int Bc, int M, float beta, float one_minus_beta,
                                    float gamma, float mu, float delta, float inv_delta,
                                    float reg_param, float sil_thresh, int constraint_option,
                                    float alpha2,
                                    float max_wa_l2norm, int min_frames, float pf_alpha,
                                    float one_minus_pf_alpha, float pf_gain,
                                    float spectral_floor, int real_mode, int pf_min_frames,
                                    cudaStream_t stream) {
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames,
                    {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                     pf_min_frames}};
  return scan(Yp, wq, bm, ta, out, en, Tf, B, C, Bc, M, false, p, stream);
}

extern "C" int dsr_gsc_rls_zelinski_steered(const float* Yp, const float* wq, const float* bm,
                                            const float* ta, float* out, float* en, int Tf,
                                            int B, int C, int Bc, int M, float beta,
                                            float one_minus_beta, float gamma, float mu,
                                            float delta, float inv_delta, float reg_param,
                                            float sil_thresh,
                                            int constraint_option, float alpha2,
                                            float max_wa_l2norm, int min_frames, float pf_alpha,
                                            float one_minus_pf_alpha, float pf_gain,
                                            float spectral_floor, int real_mode,
                                            int pf_min_frames, cudaStream_t stream) {
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames,
                    {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                     pf_min_frames}};
  return scan(Yp, wq, bm, ta, out, en, Tf, B, C, Bc, M, true, p, stream);
}

extern "C" int dsr_gsc_rls_zelinski_shape(int B, int C, int M, int* blocks, int* threads,
                                          int* frames, int* smem_bytes, int* regs,
                                          int* blocks_per_sm) {
  if (!args_ok(1, B, C, C - 1, M)) return DSR_ERR_ARGS;
  switch (C) {
#define DSR_CASE(c) \
  case c: return shape<c>(B, M, blocks, threads, frames, smem_bytes, regs, blocks_per_sm);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}
