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
//   - the state-free front of frame t + 1 (Z, Yc, gate, Zelinski gain) is
//     computed beside frame t's state update; the front has no branch and
//     the divisions of both run branch-free (BranchFreeOps, dsr_device.h),
//     so the compiler can interleave the front with the update.  The IEEE
//     division nvcc emits is a fast path, a range check and a branch around
//     a slow-path call, and a frame has ~17 of them, which then run one
//     after the other.  A frame that BranchFreeOps cannot vouch for is
//     redone with the IEEE operators (not on ordinary data).
#include "dsr_kernels.h"
#include "gsc_step.h"

#include <cstdint>

namespace {

using namespace dsr;

constexpr int THREADS = 128;  // bins a block: 4 warps, one a scheduler of an SM
constexpr int MAX_CHUNK = 16;
// shared memory a block may take: two blocks an SM where the launch has
// more blocks than SMs, else one
constexpr size_t SMEM_SHARED_SM = 100 * 1024;
constexpr size_t SMEM_OWN_SM = 200 * 1024;

// The launch shape, a function of (B, C, M) and the card's SM count only
struct Plan {
  int TC;  // frames per chunk
  int NU;  // utterances a block can touch
  int NG;  // groups of 32 bins of an utterance
  int blocks;
  size_t stage;  // floats per ring slot (one chunk)
  size_t bytes;  // dynamic shared memory
};

// a ring slot: reference rows [TC][NU][M], then own bins of channels 1..C-1
// [TC][C-1][2][THREADS]; after both slots: the energies [TC][NU]
size_t stage_floats(int TC, int NU, int C, int M) {
  return (size_t)TC * ((size_t)NU * M + 2 * (size_t)(C - 1) * THREADS);
}

Plan plan(int B, int C, int M, int sms) {
  Plan p;
  const int F = M / 2 + 1;
  const long long n = (long long)B * F;
  p.NU = (THREADS - 1) / F + 2 < B ? (THREADS - 1) / F + 2 : B;
  p.NG = (F + 31) / 32;
  p.blocks = (int)((n + THREADS - 1) / THREADS);
  const size_t budget = p.blocks > sms ? SMEM_SHARED_SM : SMEM_OWN_SM;
  for (p.TC = MAX_CHUNK;; p.TC /= 2) {
    p.stage = stage_floats(p.TC, p.NU, C, M);
    p.bytes = 4 * (2 * p.stage + (size_t)p.TC * p.NU);
    if (p.bytes <= budget || p.TC == 1) break;
  }
  return p;
}

__device__ __forceinline__ unsigned smem_addr(const float* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 4 bytes, zero-filled when !valid (the source is then not read)
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// What a block needs to know of its bins and of the input
struct Blk {
  const float* Yp;
  int B, M, F;
  int b_lo, nu;  // the utterances b_lo .. b_lo + nu - 1 the block touches
  int b, f;      // this thread's bin (a valid one for every thread)
  bool valid, has_im;
};

// Start the copies of chunk k (frames t0 .. t0 + nk - 1) into ring slot R
template <int C>
__device__ __forceinline__ void stage_chunk(const Blk& k, const Plan& pl, float* R, int t0,
                                            int nk) {
  const int tid = threadIdx.x;
  const size_t frame = (size_t)k.B * C * k.M;
  // reference-channel rows of the touched utterances, [tt][u][M]: with
  // per_row vectors a row, THREADS / per_row rows at a time, else row by row
  const int vec = k.M % 4 == 0 ? 4 : 2;
  const int per_row = k.M / vec;
  const int rows = nk * k.nu;
  auto copy = [&](int row, int e) {
    const int tt = row / k.nu;
    const int u = row - tt * k.nu;
    const float* src = k.Yp + (size_t)(t0 + tt) * frame + (size_t)(k.b_lo + u) * C * k.M + e;
    float* dst = R + ((size_t)tt * pl.NU + u) * k.M + e;
    if (vec == 4)
      cp_async16(dst, src);
    else
      cp_async8(dst, src);
  };
  if (THREADS >= per_row) {
    const int step = THREADS / per_row;
    if (tid < step * per_row)
      for (int row = tid / per_row; row < rows; row += step) copy(row, (tid % per_row) * vec);
  } else {
    for (int row = 0; row < rows; ++row)
      for (int e = tid * vec; e < k.M; e += THREADS * vec) copy(row, e);
  }
  // this thread's bin of the other channels, [tt][c-1][re|im][tid]
  const int im = k.has_im ? k.F - 1 : 0;
  const float* src = k.Yp + ((size_t)t0 * k.B + k.b) * C * k.M + k.f;
  float* dst = R + (size_t)pl.TC * pl.NU * k.M + tid;
  for (int tt = 0; tt < nk; ++tt, src += frame) {
#pragma unroll
    for (int c = 1; c < C; ++c, dst += 2 * THREADS) {
      cp_async4(dst, src + c * k.M, k.valid);
      cp_async4(dst + THREADS, src + c * k.M + im, k.valid && k.has_im);
    }
  }
  cp_commit();
  // probe: copies started
}

// The reference-channel frame energies of chunk k's nk frames for the
// touched utterances into en[tt * NU + u], one warp a row: lane l holds bin
// g*32 + l of each of the NG groups g of 32 bins (bins past F hold 0), the
// warp runs one shuffle tree per group, all groups at once, and lane 0 adds
// 0 + group 0 + group 1 + ... and divides by M: block_sum's order.
template <int NG>
__device__ __forceinline__ void chunk_energies_ng(const Blk& k, const Plan& pl, const float* R,
                                                  float* en, int nk) {
  const int lane = threadIdx.x & 31;
  const int F = k.F;
#pragma unroll 2
  for (int row = threadIdx.x >> 5; row < nk * k.nu; row += THREADS / 32) {
    const int tt = row / k.nu;
    const int u = row - tt * k.nu;
    const float* x = R + ((size_t)tt * pl.NU + u) * k.M;
    float v[NG];
#pragma unroll
    for (int g = 0; g < NG; ++g) {
      const int bin = g * 32 + lane;
      const float re = bin < F ? x[bin] : 0.f;
      const float im = bin >= 1 && bin <= F - 2 ? x[F + bin - 1] : 0.f;
      v[g] = bin < F ? energy_term(bin == 0 || bin == F - 1 ? 1.f : 2.f, {re, im}) : 0.f;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
#pragma unroll
      for (int g = 0; g < NG; ++g) v[g] += __shfl_xor_sync(0xffffffffu, v[g], o);
    if (lane == 0) {
      float sum = 0.f;
#pragma unroll
      for (int g = 0; g < NG; ++g) sum += v[g];
      en[tt * pl.NU + u] = sum / (float)k.M;
    }
  }
}

__device__ __forceinline__ void chunk_energies(const Blk& k, const Plan& pl, const float* R,
                                               float* en, int nk) {
  switch (pl.NG) {  // F <= 256: at most 8 groups
    case 1: chunk_energies_ng<1>(k, pl, R, en, nk); break;
    case 2: chunk_energies_ng<2>(k, pl, R, en, nk); break;
    case 3: chunk_energies_ng<3>(k, pl, R, en, nk); break;
    case 4: chunk_energies_ng<4>(k, pl, R, en, nk); break;
    case 5: chunk_energies_ng<5>(k, pl, R, en, nk); break;
    case 6: chunk_energies_ng<6>(k, pl, R, en, nk); break;
    case 7: chunk_energies_ng<7>(k, pl, R, en, nk); break;
    default: chunk_energies_ng<8>(k, pl, R, en, nk); break;
  }
  __syncthreads();
  // probe: energies done
}

template <int C>
__device__ __forceinline__ void read_snapshot(const Blk& k, const Plan& pl, const float* R, int tt,
                                              cf (&X)[C]) {
  const float* x = R + ((size_t)tt * pl.NU + (k.b - k.b_lo)) * k.M;
  X[0] = {x[k.f], k.has_im ? x[k.F + k.f - 1] : 0.f};
  const float* G = R + (size_t)pl.TC * pl.NU * k.M + threadIdx.x;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const float* g = G + ((size_t)(tt * (C - 1) + c - 1) * 2) * THREADS;
    X[c] = {g[0], g[THREADS]};
  }
}

template <int C, int BC>
__global__ void __launch_bounds__(THREADS)
    gsc_rls_zelinski_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                            const float* __restrict__ bm, const float* __restrict__ ta,
                            float* __restrict__ out, int Tf, int B, int M, bool per_utt,
                            GscParams p, Plan pl) {
  extern __shared__ __align__(16) float smem[];
  // probe: kernel start
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
  GscFront<BC> fr;
  {
    cf X[C];
    read_snapshot<C>(k, pl, smem, 0, X);
    const float et = en[k.b - k.b_lo];
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

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

template <int C>
int launch(const float* Yp, const float* wq, const float* bm, const float* ta, float* out,
           int Tf, int B, int M, bool per_utt, const GscParams& p, const Plan& pl,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(gsc_rls_zelinski_kernel<C, C - 1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gsc_rls_zelinski_kernel<C, C - 1><<<pl.blocks, THREADS, pl.bytes, stream>>>(
      Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl);
  return static_cast<int>(cudaGetLastError());
}

// one thread per bin, at most 256 bins (M <= 510)
bool args_ok(int Tf, int B, int C, int Bc, int M) {
  return Tf > 0 && B > 0 && M >= 4 && M % 2 == 0 && M / 2 + 1 <= 256 && C >= 2 && C <= 8 &&
         Bc == C - 1 && (long long)B * (M / 2 + 1) <= 0x7fffffffLL;
}

int scan(const float* Yp, const float* wq, const float* bm, const float* ta, float* out, int Tf,
         int B, int C, int Bc, int M, bool per_utt, const GscParams& p, cudaStream_t stream) {
  if (!args_ok(Tf, B, C, Bc, M)) return DSR_ERR_ARGS;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Plan pl = plan(B, C, M, sms);
  switch (C) {
    case 2: return launch<2>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
    case 3: return launch<3>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
    case 4: return launch<4>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
    case 5: return launch<5>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
    case 6: return launch<6>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
    case 7: return launch<7>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
    case 8: return launch<8>(Yp, wq, bm, ta, out, Tf, B, M, per_utt, p, pl, stream);
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
  err = cudaFuncGetAttributes(&a, gsc_rls_zelinski_kernel<C, C - 1>);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    err = cudaFuncSetAttribute(gsc_rls_zelinski_kernel<C, C - 1>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gsc_rls_zelinski_kernel<C, C - 1>, THREADS, pl.bytes);
  return static_cast<int>(err);
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
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames,
                    {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                     pf_min_frames}};
  return scan(Yp, wq, bm, ta, out, Tf, B, C, Bc, M, false, p, stream);
}

extern "C" int dsr_gsc_rls_zelinski_steered(const float* Yp, const float* wq, const float* bm,
                                            const float* ta, float* out, int Tf, int B, int C,
                                            int Bc, int M, float beta, float one_minus_beta,
                                            float gamma, float mu, float delta, float inv_delta,
                                            float reg_param, float sil_thresh,
                                            int constraint_option, float alpha2,
                                            float max_wa_l2norm, int min_frames, float pf_alpha,
                                            float one_minus_pf_alpha, float pf_gain,
                                            float spectral_floor, int real_mode,
                                            int pf_min_frames, cudaStream_t stream) {
  const GscParams p = {beta, one_minus_beta, gamma, mu, delta, inv_delta, reg_param, sil_thresh,
                    constraint_option, alpha2, max_wa_l2norm, min_frames,
                    {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                     pf_min_frames}};
  return scan(Yp, wq, bm, ta, out, Tf, B, C, Bc, M, true, p, stream);
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
