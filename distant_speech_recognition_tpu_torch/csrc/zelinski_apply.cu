// Fixed-weight beamformer + Zelinski postfilter over packed time-major frames.
//
// Replaces the Pallas TPU kernel models/pallas_fused_scan.py
// zelinski_apply_pallas (_call_fw / _make_fw_kernel without the filterbank
// stages) of distant_speech_recognition_tpu, and computes what
// models/fixed_weight.zelinski_apply_plain computes:
//   Y[t, b, f] = sum_c wqH[f, c] X[t, b, c, f];  the Zelinski gain of the
//   time-aligned snapshot conj(ta) X (pair sum and trace smoothed from the
//   third frame on), applied from frame pf_min_frames + 1 on.
// Input [Tf, B, C, M] and output [Tf, B, M] keep the packed lanes
// [Re(0..M/2) | Im(1..M/2-1)]; all M/2 + 1 bins run the same code.  The
// weights and the manifold are one set [F, C] for every utterance
// (dsr_zelinski_apply) or one per utterance [B, F, C]
// (dsr_zelinski_apply_steered: the steered D&S, whose utterances each look
// at their own DOA estimate); only the row a thread reads differs.
//
// What bounds it on an H100: each (utterance, bin) reads C*8 bytes and
// writes 8 per frame for ~12*C^2 flops, so it is bound by memory bytes
// (1.65 GB at B=256 x 4 ch x 10 s, 0.49 ms at 3.35 TB/s; 0.12 ms at config
// 5's B=64), provided enough bytes are in flight on every SM.  The recursion
// carried from frame to frame is two smoothed sums, a few FMAs; each lane
// walks all Tf frames of its bin, so its frames must be in flight long
// before it reaches them, and at small batches a lane's own instructions
// (~100 a frame at C = 4) pace it.  Design:
//   - a warp a block (K7_WARPS: more were no faster), 32 consecutive bins
//     of one utterance (M/64 + 1 warps an utterance, the last one the
//     Nyquist bin alone), so that B=64 spreads over every SM (320 blocks at
//     M = 256); loads and stores coalesce along the bins;
//   - each warp stages its frames by 16-byte cp.async (the Re and Im runs
//     of its 32 bins start on 128 bytes for M a multiple of 64), four frames
//     a group, into its ring of 8 to 32 frames in shared memory, as deep as
//     the blocks an SM must hold let it be (28 frames ahead at B=64); the
//     warp waits only for its own copies (cp.async.wait_group, __syncwarp);
//   - the frames of a group are one straight run of code: their sums
//     and outputs interleave, the recursion goes frame by frame, and the
//     gain's square root and division take the IEEE operators' fast paths
//     without a branch (`BranchFreeOps::sqrt`, `fast_div<32>`), the IEEE
//     operators only where those cannot vouch; the Zelinski mode is
//     compiled in;
//   - each frame's arithmetic is the first design's (`zelinski_gain`'s),
//     operation for operation, so the outputs keep its bits.
#include "dsr_device.h"
#include "dsr_kernels.h"
#include "gsc_scan.h"  // cp.async, sm_count

#include <cstdint>
#include <type_traits>

namespace {

using namespace dsr;

constexpr int K7_WARPS = 1;       // warps a block, each its own 32 bins of an utterance
constexpr int K7_THREADS = 32 * K7_WARPS;
constexpr int K7_GROUP = 4;       // frames staged and computed together
constexpr int K7_MAX_SLOTS = 32;  // frames of a warp's ring at most
constexpr int K7_MIN_SLOTS = 2 * K7_GROUP;
// shared memory of an SM that the launch plan may fill, and what the card
// reserves for each block besides its own
constexpr size_t K7_SMEM_SM = 227 * 1024;
constexpr size_t K7_SMEM_RESERVED = 1024;
constexpr int K7_PLAN_BLOCKS_SM = 16;  // the most blocks an SM is planned to hold at once

// the Zelinski numerator compiled in: the positive real part of the pair
// sum (pf_type & 1), or its modulus
enum { ZEL_REAL = 1, ZEL_ABS = 2 };

// a ring slot: a warp's 32 bins of channels 0..C-1, [C][Re 32 | Im 32]
__host__ __device__ constexpr int k7_slot_floats(int C) { return C * 64; }
// warps of 32 bins an utterance: M/2 + 1 bins, the last warp the Nyquist
// bin alone
__host__ __device__ constexpr int k7_bin_groups(int M) { return (M / 2 + 32) / 32; }

// 16 bytes global -> shared, zero-filled (the source not read) when !on
__device__ __forceinline__ void cp_async16_zfill(float* dst, const float* src, bool on) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(on ? 16 : 0)
               : "memory");
}

// Frame t of the Zelinski recursion as `zelinski_gain` runs it, operation
// for operation, up to the numerator: the sums, smoothed from the third
// frame on, and num = max(Re, 0) of the smoothed pair sum (ZM = ZEL_REAL)
// or its squared modulus (ZEL_ABS, whose square root the caller takes)
template <int C, int ZM>
__device__ __forceinline__ float zelinski_smooth(cf& phi_pair, float& phi_diag,
                                                 const cf (&tac)[C], const cf (&X)[C], int t,
                                                 const ZelinskiParams& p) {
  cf ps;
  float ds;
  zelinski_sums<C>(tac, X, ps, ds);
  if (t > 1) {
    phi_pair = cadd(cscale(phi_pair, p.alpha), cscale(ps, p.one_minus_alpha));
    phi_diag = p.alpha * phi_diag + p.one_minus_alpha * ds;
  } else {
    phi_pair = ps;
    phi_diag = ds;
  }
  return ZM == ZEL_REAL ? fmaxf(phi_pair.r, 0.f) : cabs2(phi_pair);
}

// The ratio num / trace of `zelinski_gain` (its gain is `zelinski_clip` of
// it) from the numerator (the squared modulus under ZEL_ABS) and the trace,
// with the IEEE square root's and division's bits: their fast paths without
// a branch (`BranchFreeOps::sqrt`, `fast_div<32>`), `ok` false where those
// cannot vouch, and the caller then redoes the ratio with
// `zelinski_ratio_ieee`.  A zero trace gives ratio 0, a zero numerator ratio
// num (+-0, num / trace's bits); both give the floor.
template <int ZM>
__device__ __forceinline__ float zelinski_ratio(float num, float trace, bool& ok) {
  if (ZM == ZEL_ABS) {
    BranchFreeOps op;
    const float r = op.sqrt(num);
    ok = op.ok | (num == 0.f);
    num = num == 0.f ? 0.f : r;
  } else {
    ok = true;
  }
  bool ok_div;
  const float q = fast_div<32>(num, trace, ok_div);
  ok &= ok_div | (num == 0.f) | !(trace > 0.f);
  return trace > 0.f ? (num == 0.f ? num : q) : 0.f;
}

template <int ZM>
__device__ __forceinline__ float zelinski_ratio_ieee(float num, float trace) {
  if (ZM == ZEL_ABS) num = sqrtf(num);
  return trace > 0.f ? num / trace : 0.f;
}

__device__ __forceinline__ float zelinski_clip(float ratio, const ZelinskiParams& p) {
  return fminf(fmaxf(ratio * p.gain, p.spectral_floor), 1.f);
}

template <int C, int ZM, int SLOTS>
__global__ void __launch_bounds__(K7_THREADS)
zelinski_apply_kernel(const float* __restrict__ Yp, const float* __restrict__ wq,
                      const float* __restrict__ ta, float* __restrict__ out, int Tf, int B, int M,
                      bool per_utt, ZelinskiParams p) {
  constexpr int G = K7_GROUP;
  constexpr int SLOT = k7_slot_floats(C);
  constexpr int NG = SLOTS / G;             // groups of frames in the ring
  constexpr int PIECES = (16 * C + 31) / 32;  // 16-byte pieces of a frame a lane copies
  extern __shared__ __align__(16) float smem[];
  // probe: kernel start
  const int F = M / 2 + 1;
  const int groups = k7_bin_groups(M);  // warps an utterance
  const int lane = threadIdx.x & 31;
  const int item = blockIdx.x * K7_WARPS + (threadIdx.x >> 5);
  if (item >= B * groups) return;
  const int b = item / groups;
  const int j = item - b * groups;  // the warp's group of 32 bins
  const bool nyquist = j == groups - 1;  // the last group: the Nyquist bin alone
  const int f = 32 * j + lane;
  const bool valid = f < F;
  const bool has_im = f >= 1 && f <= F - 2;
  const size_t wf = (per_utt ? (size_t)b * F : 0) + (valid ? f : F - 1);  // this lane's row
  float* ring = smem + (size_t)(threadIdx.x >> 5) * SLOTS * SLOT;

  cf wqc[C], tac[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    wqc[c] = {wq[(wf * C + c) * 2], wq[(wf * C + c) * 2 + 1]};
    tac[c] = {ta[(wf * C + c) * 2], -ta[(wf * C + c) * 2 + 1]};  // conj(ta)
  }
  cf phi_pair = {0.f, 0.f};
  float phi_diag = 0.f;

  // a frame's 16-byte pieces: 8 of the Re run and 8 of the Im run of each
  // channel (the Nyquist warp: its one Re piece a channel, the bin in its
  // first float), lane l copying pieces l, l + 32, ...: piece k is 4 floats
  // of channel c, Re (part 0) or Im (part 1), at e
  int s_off[PIECES], g_off[PIECES];
  bool copies[PIECES];
#pragma unroll
  for (int i = 0; i < PIECES; ++i) {
    const int k = 32 * i + lane;
    const int c = nyquist ? k : k >> 4, part = nyquist ? 0 : (k >> 3) & 1;
    const int e = nyquist ? 0 : 4 * (k & 7);
    copies[i] = k < (nyquist ? C : 16 * C);
    s_off[i] = 64 * c + 32 * part + e;
    g_off[i] = c * M + part * (F - 1) + e;
  }
  const size_t frame = (size_t)B * C * M;
  const float* x = Yp + (size_t)b * C * M + 32 * j;  // the next frame to stage
  int t_next = 0;
  auto stage_group = [&](int s) {  // the next G frames into slots s ..
#pragma unroll
    for (int u = 0; u < G; ++u, ++t_next, x += frame) {
      float* d = ring + (s + u) * SLOT;
#pragma unroll
      for (int i = 0; i < PIECES; ++i)
        if (copies[i]) cp_async16_zfill(d + s_off[i], x + g_off[i], t_next < Tf);
    }
    cp_commit();
  };
  for (int g = 0; g < NG - 1; ++g) stage_group(g * G);
  // probe: set-up done

  const size_t out_stride = (size_t)B * M;
  float* o = out + (size_t)b * M + f;  // Re of frame t; its Im F - 1 further
  for (int g = 0, s = 0; g * G < Tf; ++g) {
    // group g + NG - 1 into the slots of group g - 1, which every lane of
    // the warp is done with; then group g's copies are in
    __syncwarp();
    stage_group((s == 0 ? SLOTS : s) - G);
    // probe: copies issued
    cp_wait<NG - 1>();
    __syncwarp();
    // probe: group in
    cf X[G][C];
#pragma unroll
    for (int u = 0; u < G; ++u) {
      const float* r = ring + (s + u) * SLOT + lane;
#pragma unroll
      for (int c = 0; c < C; ++c) X[u][c] = {r[64 * c], has_im ? r[64 * c + 32] : 0.f};
    }
    s = s + G == SLOTS ? 0 : s + G;
    // probe: group read
    // the group's frames as `zelinski_gain` runs them, the recursion frame
    // by frame and the gains of all G frames after it, branch-free unless a
    // quotient needs the IEEE operators; frames past Tf (of stale slots)
    // are computed and never stored
    const int t0 = g * G;
    cf Y[G];
    float num[G], trace[G], W[G];
    bool ok = true;
#pragma unroll
    for (int u = 0; u < G; ++u) {
      Y[u] = {0.f, 0.f};
#pragma unroll
      for (int c = 0; c < C; ++c) Y[u] = cadd(Y[u], cmul(wqc[c], X[u][c]));
      num[u] = zelinski_smooth<C, ZM>(phi_pair, phi_diag, tac, X[u], t0 + u, p);
      trace[u] = phi_diag;
    }
#pragma unroll
    for (int u = 0; u < G; ++u) {
      bool ok_u;
      W[u] = zelinski_ratio<ZM>(num[u], trace[u], ok_u);
      ok &= ok_u;
    }
    if (!ok && valid) {  // (an idle lane's stale slots never hold up the block)
#pragma unroll
      for (int u = 0; u < G; ++u) W[u] = zelinski_ratio_ieee<ZM>(num[u], trace[u]);
    }
    // probe: group computed
#pragma unroll
    for (int u = 0; u < G; ++u, o += out_stride) {
      const int t = t0 + u;
      const cf y = t > p.min_frames ? cscale(Y[u], zelinski_clip(W[u], p)) : Y[u];
      if (valid && t < Tf) {
        o[0] = y.r;
        if (has_im) o[F - 1] = y.i;
      }
    }
    // probe: group stored
  }
  // probe: kernel end
}

// The launch: one block a warp of (utterance, bin) lanes; the ring as deep
// as the blocks an SM will hold let it be
struct K7Plan {
  int blocks, slots;
  size_t bytes;
};

size_t k7_bytes(int C, int slots) { return 4 * (size_t)K7_WARPS * slots * k7_slot_floats(C); }

K7Plan k7_plan(int B, int C, int M, int sms) {
  K7Plan pl;
  pl.blocks = (B * k7_bin_groups(M) + K7_WARPS - 1) / K7_WARPS;
  int per_sm = (pl.blocks + sms - 1) / sms;
  per_sm = per_sm < K7_PLAN_BLOCKS_SM ? per_sm : K7_PLAN_BLOCKS_SM;
  for (pl.slots = K7_MAX_SLOTS;; pl.slots /= 2) {
    pl.bytes = k7_bytes(C, pl.slots);
    if ((size_t)per_sm * (pl.bytes + K7_SMEM_RESERVED) <= K7_SMEM_SM ||
        pl.slots == K7_MIN_SLOTS)
      break;
  }
  return pl;
}

template <int C, int ZM, int SLOTS>
cudaError_t k7_launch(const K7Plan& pl, const float* Yp, const float* wq, const float* ta,
                      float* out, int Tf, int B, int M, bool per_utt, const ZelinskiParams& p,
                      cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(zelinski_apply_kernel<C, ZM, SLOTS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)pl.bytes);
  if (err != cudaSuccess) return err;
  zelinski_apply_kernel<C, ZM, SLOTS><<<pl.blocks, K7_THREADS, pl.bytes, stream>>>(
      Yp, wq, ta, out, Tf, B, M, per_utt, p);
  return cudaGetLastError();
}

// the registers and local memory (spills) a thread and the blocks an SM
// holds of the plan's kernel in Zelinski mode ZM, folded into the worst of
// the modes seen so far
template <int C, int ZM, int SLOTS>
cudaError_t k7_shape(const K7Plan& pl, int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes a;
  int bps = 0;
  cudaError_t err = cudaFuncGetAttributes(&a, zelinski_apply_kernel<C, ZM, SLOTS>);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(zelinski_apply_kernel<C, ZM, SLOTS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)pl.bytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &bps, zelinski_apply_kernel<C, ZM, SLOTS>, K7_THREADS, pl.bytes);
  if (err == cudaSuccess) {
    *regs = a.numRegs > *regs ? a.numRegs : *regs;
    *local_bytes = (int)a.localSizeBytes > *local_bytes ? (int)a.localSizeBytes : *local_bytes;
    *blocks_per_sm = bps < *blocks_per_sm ? bps : *blocks_per_sm;
  }
  return err;
}

// fn(std::integral_constant<int, ZM>, std::integral_constant<int, SLOTS>)
// for the Zelinski mode and the plan's ring depth
template <typename Fn>
cudaError_t k7_by_mode_slots(int real_mode, int slots, Fn&& fn) {
  auto by_slots = [&](auto zm) {
    switch (slots) {
      case 32: return fn(zm, std::integral_constant<int, 32>{});
      case 16: return fn(zm, std::integral_constant<int, 16>{});
      default: return fn(zm, std::integral_constant<int, K7_MIN_SLOTS>{});
    }
  };
  return real_mode ? by_slots(std::integral_constant<int, ZEL_REAL>{})
                   : by_slots(std::integral_constant<int, ZEL_ABS>{});
}

template <int C>
int launch(const float* Yp, const float* wq, const float* ta, float* out, int Tf, int B, int M,
           bool per_utt, const ZelinskiParams& p, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const K7Plan pl = k7_plan(B, C, M, sms);
  return static_cast<int>(k7_by_mode_slots(p.real_mode, pl.slots, [&](auto zm, auto s) {
    return k7_launch<C, decltype(zm)::value, decltype(s)::value>(pl, Yp, wq, ta, out, Tf, B, M,
                                                                  per_utt, p, stream);
  }));
}

// M a multiple of 64: every Re and Im run of 32 bins starts on 128 bytes
bool k7_args_ok(int Tf, int B, int C, int M) {
  return Tf > 0 && B > 0 && M >= 64 && M % 64 == 0 && C >= 2 && C <= 8 &&
         (long long)B * k7_bin_groups(M) <= 0x7fffffffLL;
}

int dispatch(const float* Yp, const float* wq, const float* ta, float* out, int Tf, int B, int C,
             int M, bool per_utt, const ZelinskiParams& p, cudaStream_t stream) {
  if (!k7_args_ok(Tf, B, C, M)) return DSR_ERR_ARGS;
  switch (C) {
#define DSR_CASE(c) \
  case c: return launch<c>(Yp, wq, ta, out, Tf, B, M, per_utt, p, stream);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

template <int C>
int shape(const K7Plan& pl, int* regs, int* local_bytes, int* blocks_per_sm) {
  *regs = *local_bytes = 0;
  *blocks_per_sm = 1 << 30;  // the least of the modes' below
  for (int real_mode = 0; real_mode < 2; ++real_mode) {
    const cudaError_t err = k7_by_mode_slots(real_mode, pl.slots, [&](auto zm, auto s) {
      return k7_shape<C, decltype(zm)::value, decltype(s)::value>(pl, regs, local_bytes,
                                                                  blocks_per_sm);
    });
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

}  // namespace

extern "C" int dsr_zelinski_apply(const float* Yp, const float* wq, const float* ta, float* out,
                                  int Tf, int B, int C, int M, float pf_alpha,
                                  float one_minus_pf_alpha, float pf_gain, float spectral_floor,
                                  int real_mode, int pf_min_frames, cudaStream_t stream) {
  const ZelinskiParams p = {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                            pf_min_frames};
  return dispatch(Yp, wq, ta, out, Tf, B, C, M, false, p, stream);
}

extern "C" int dsr_zelinski_apply_steered(const float* Yp, const float* wq, const float* ta,
                                          float* out, int Tf, int B, int C, int M,
                                          float pf_alpha, float one_minus_pf_alpha,
                                          float pf_gain, float spectral_floor, int real_mode,
                                          int pf_min_frames, cudaStream_t stream) {
  const ZelinskiParams p = {pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor, real_mode,
                            pf_min_frames};
  return dispatch(Yp, wq, ta, out, Tf, B, C, M, true, p, stream);
}

extern "C" int dsr_zelinski_apply_shape(int B, int C, int M, int* blocks, int* threads,
                                        int* frames, int* smem_bytes, int* regs, int* local_bytes,
                                        int* blocks_per_sm) {
  if (!k7_args_ok(1, B, C, M)) return DSR_ERR_ARGS;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return static_cast<int>(err);
  const K7Plan pl = k7_plan(B, C, M, sms);
  *blocks = pl.blocks;
  *threads = K7_THREADS;
  *frames = pl.slots;
  *smem_bytes = (int)pl.bytes;
  switch (C) {
#define DSR_CASE(c) \
  case c: return shape<c>(pl, regs, local_bytes, blocks_per_sm);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}
