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
// multiply-adds per output (~0.4 ms of FP32 arithmetic): bound by memory,
// with the arithmetic at half that bound.
//
// Design.  The residual has no recurrence over time, so a block takes one
// utterance and a chunk of TC frames (with the lowerN + P - 1 frames of
// history before it): the grid is B x ceil(Tf / TC) blocks.  One frame of one
// utterance is C*M contiguous floats of Yp (4 KB in config 4).
//   - The block stages whole frames with 16-byte cp.async copies into a ring
//     of frame slots in shared memory, DG steps of STEP frames ahead of the
//     step it computes (4 frames and 2 steps up to 4 KB frames), and writes each output frame back as one row with one
//     bulk (TMA) copy from a double buffer, so that loads, arithmetic and
//     stores of different steps overlap and no warp waits on a store.
//   - The first slots of the ring are repeated past its end, so that the lag
//     frames of a step are consecutive slots: every lag offset is an
//     immediate (C and M are template parameters), and each lag value read
//     from shared memory feeds the STEP frames that use it.
//   - Thread (c0, k) computes packed lanes k and M/2 + k (Re and Im of bin k,
//     0 < k < M/2) of targets c0 and c0 + H, with both conj(G) rows in
//     registers (PM >= P taps a channel, zeros past P); one more warp
//     computes the real bins 0 and M/2 of every target, so that no warp runs
//     two paths (the block waits for its slowest warp at every step).
//   - Where the frames from t - lowerN - P + 1 to t do not fit in one ring
//     beside the lead (deep lags, many channels), the current frames and the
//     lag frames run in two rings, and each frame is copied twice.
//
// C*P > 24 (up to 40: BASELINE config 4's default taps at 8 channels) runs
// in a kernel of its own, wpe_resid_wide_kernel; the kernel above keeps the
// shapes up to 24 taps as it was.  There conj(G) of two targets no longer
// fits a thread's registers, so a lag value read from shared memory would
// feed one target only, and a whole frame of 8 channels (8 KB) leaves room
// for few frames in a ring.  At (8, 5) the FP32 operations (~1.3 ms) come
// close to the bytes (1.6 ms), so the design has to issue little besides
// its FMAs.  Per (utterance, bin) the residual is a [C x CP] by [CP x T]
// product whose lag matrix is Toeplitz in t, and the wide kernel tiles it:
//   - a block takes one utterance, a group of 32 bins and a chunk of TC
//     frames: grid (chunks x groups, B), the chunks of a group neighbours in
//     x, so that the later ones find the group's conj(G) in L2;
//   - it stages only its group's lanes of each frame (C x 64 floats, 2 KB at
//     8 channels), every thread copying 16 bytes of every second frame, into
//     a ring of slots one step of WSTEP = 8 frames ahead (one barrier a
//     step), the first slots repeated past its end as above;
//   - warp c computes target c, lane l bin 32 grp + l, with conj(G[c, bin])
//     in registers (PM = 40 / C taps a channel, zeros past P), 16 warps an
//     SM; each lag value read from shared memory feeds the up to 8 frames of
//     the step that use it (a 1 x 8 tile of the product a thread: 1,280 FMAs
//     and 192 lag loads a step at (8, 5)), the CP terms of an output in the
//     order of the kernel above, so the same bits;
//   - outputs leave from registers, 128 contiguous bytes a warp a row;
//   - bin 0 (DC, real) runs in the same path as lane 0 of group 0, with
//     conj(G) = (Re G, 0): its imaginary term adds an exact zero; the
//     Nyquist bin M/2 (real) is computed after each step by lanes 0 .. 7 of
//     each warp of group 0, a frame each, its coefficients from shared
//     memory (a slot is C x 64 + 4 floats, so those lanes read distinct banks).
// M is 64, 128, ..., 2048 (lane offsets compiled in).  At M = 512 a narrow
// block of C >= 5 channels would take 800 threads (1,056 at C >= 7, more
// than a block may have), and 80 registers a thread spill its filters: those
// shapes run in the wide kernel.  At M = 1024 and 2048 every shape runs in
// the wide kernel, whose block takes 32 bins whatever M is (a narrow block
// would take a thread a bin of half the channels).
#include <algorithm>

#include "dsr_kernels.h"

namespace {

constexpr int TC = 256;  // output frames per block
constexpr size_t ONE_RING_MAX = 160 * 1024;  // shared memory of a block that keeps one ring

// output frames of a step (one barrier a step) and steps of frames staged
// ahead of the one computed: 4 and 2 up to 4 KB frames, 2 and 1 above, so
// that the rings of 8 channels x 256 lanes fit in shared memory
__host__ __device__ constexpr int step_frames(int C, int MH) { return C * MH <= 512 ? 4 : 2; }
__host__ __device__ constexpr int lead_steps(int C, int MH) { return C * MH <= 512 ? 2 : 1; }
template <int C, int MH>
__host__ __device__ constexpr int step_frames() {
  return step_frames(C, MH);
}
template <int C, int MH>
__host__ __device__ constexpr int lead_steps() {
  return lead_steps(C, MH);
}

struct cf {
  float r, i;
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
// bulk (TMA) copy of one row shared -> global, and its bookkeeping
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(src));
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst), "r"(s),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
// makes this thread's shared-memory writes visible to the bulk copies
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// targets a thread computes: two (each lag read from shared memory feeds
// both), one at C = 1
template <int C>
__host__ __device__ constexpr int targets() {
  return C == 1 ? 1 : 2;
}
// threads of a block: (target groups c0 < H) x (lanes k < MH), then one warp
// for the real bins 0 and M/2
template <int C, int MH>
__host__ __device__ constexpr int block_threads() {
  return MH * ((C + targets<C>() - 1) / targets<C>()) + 32;
}

// C channels, MH = M/2 lanes, PM >= P lag slots per channel held in
// registers.  Frame r of the block (absolute t0 - S + r) sits in lag slot
// r % NL, and again in slot NL + r % NL when r % NL < PM + STEP - 2, so that
// the PM + STEP - 1 lag frames of a step's STEP outputs are consecutive
// slots and lag offsets are immediates; an output's current frame sits in
// slot CB + r % NC (one ring: CB = 0, NC = NL).
template <int C, int MH, int PM>
__global__ void __launch_bounds__(block_threads<C, MH>())
wpe_resid_kernel(const float* __restrict__ Yp, const cf* __restrict__ G, float* __restrict__ out,
                 int Tf, int B, int P, int lowerN, int NL, int CB, int NC) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int STEP = step_frames<C, MH>();
  constexpr int DG = lead_steps<C, MH>();
  constexpr int TT = targets<C>();
  constexpr int H = (C + TT - 1) / TT;  // a thread's targets are c0 (and c0 + H)
  constexpr int M = 2 * MH;
  constexpr int F = MH + 1;
  constexpr int CM = C * M;       // one frame of the utterance
  const int CP = C * P;
  const int S = lowerN + P - 1;   // deepest lag
  const int NS = CB == 0 ? NL + PM + STEP - 2 : CB + NC;  // slots
  float* ring = reinterpret_cast<float*>(smem);   // [NS][C][M]
  float* outs = ring + (size_t)NS * CM;           // [2][STEP][C][M]

  const int tid = threadIdx.x;
  constexpr int nthr = block_threads<C, MH>();
  // complex bins: lanes k and MH + k (Re and Im of bin k, 1 <= k < MH)
  const bool cplx = tid < MH * H && tid % MH > 0;
  const int k = tid % MH;
  const int c0 = tid / MH;
  const int c1 = c0 + H;
  const bool two = cplx && TT == 2 && c1 < C;
  // real bins: lane rl of target rc, rl = 0 (bin 0) or MH (bin M/2)
  const int rq = tid - MH * H;
  const bool real = rq >= 0 && rq < 2 * C;
  const int rc = real ? rq % C : 0;
  const int rl = rq >= C ? MH : 0;
  const int lane = cplx ? k : rl;  // the lane whose lags this thread reads
  const int b = blockIdx.y;
  const int t0 = blockIdx.x * TC;
  const int nt = min(TC, Tf - t0);
  const size_t frame_stride = (size_t)B * CM;
  const float* Yb = Yp + (size_t)b * CM;
  float* Ob = out + (size_t)b * CM;

  // conj(G) of (c0, bin k) and (c1, bin k) at slot a*PM + dp; for a real
  // bin, Re G of (rc, bin rl) in g0[].r (its lags are real)
  cf g0[C * PM], g1[TT == 2 ? C * PM : 1];
#pragma unroll
  for (int a = 0; a < C; ++a)
#pragma unroll
    for (int dp = 0; dp < PM; ++dp) {
      const int j = a * P + dp;
      cf v0 = {0.f, 0.f}, v1 = {0.f, 0.f};
      if (dp < P) {
        if (cplx) {
          v0 = G[(((size_t)b * C + c0) * F + k) * CP + j];
          v0.i = -v0.i;
          if (two) {
            v1 = G[(((size_t)b * C + c1) * F + k) * CP + j];
            v1.i = -v1.i;
          }
        } else if (real) {
          v0 = {G[(((size_t)b * C + rc) * F + rl) * CP + j].r, 0.f};
        }
      }
      g0[a * PM + dp] = v0;
      if constexpr (TT == 2) g1[a * PM + dp] = v1;
    }

  auto copy = [&](int rr, int slot) {  // block frame rr into a slot, zero before t = 0
    const int t = t0 - S + rr;
    const float* src = Yb + (size_t)max(t, 0) * frame_stride;
    float* dst = ring + (size_t)slot * CM;
    for (int idx = 4 * tid; idx < CM; idx += 4 * nthr) cp_async16(dst + idx, src + idx, t >= 0);
  };
  auto copy_lag = [&](int rr) {
    const int sl = rr % NL;
    copy(rr, sl);
    if (sl < PM + STEP - 2) copy(rr, NL + sl);
  };
  auto fetch = [&](int g) {  // the frames that outputs of step g are the first to need
    for (int i = g * STEP; i < min(g * STEP + STEP, nt); ++i) {
      if (CB == 0) {  // one ring
        if (i == 0) {
          for (int rr = 0; rr <= S; ++rr) copy_lag(rr);
        } else {
          copy_lag(S + i);
        }
      } else {
        if (i == 0) {
          for (int rr = 0; rr <= S - lowerN; ++rr) copy_lag(rr);
        } else {
          copy_lag(S + i - lowerN);
        }
        copy(S + i, CB + (S + i) % NC);
      }
    }
    cp_commit();
  };
  auto flush = [&](int g) {  // outputs of step g, one bulk copy a row (thread 0)
    if (tid == 0) {
      for (int s = 0; s < STEP && g * STEP + s < nt; ++s)
        bulk_store(Ob + (size_t)(t0 + g * STEP + s) * frame_stride,
                   outs + ((g & 1) * STEP + s) * CM, CM * (int)sizeof(float));
      bulk_commit();
    }
  };
  // output frames i0 .. i0 + STEP - 1 into output rows o + fr * CM.  Their
  // lag frames are the PM + STEP - 1 consecutive slots top - m: lag dp of
  // frame i0 + fr is m = dp + STEP - 1 - fr, so each lag value is read once
  // for all STEP frames; slots past the P taps (g = 0) hold earlier frames or
  // zeros.  sl: the slot of lag 0 of frame i0, sc: its current slot, less CB
  auto predict_step = [&](int i0, int sl, int sc, float* o) {
    const float* L = ring + (size_t)((sl < PM - 1 ? sl + NL : sl) + STEP - 1) * CM + lane;
    if (cplx) {
      // [frame]: Re and Im of targets c0 (a) and c1 (b)
      float a0[STEP] = {}, a1[STEP] = {}, b0[STEP] = {}, b1[STEP] = {};
#pragma unroll
      for (int m = 0; m < PM + STEP - 1; ++m) {
#pragma unroll
        for (int a = 0; a < C; ++a) {
          const float x0 = L[a * M - m * CM], x1 = L[a * M + MH - m * CM];
#pragma unroll
          for (int fr = 0; fr < STEP; ++fr) {
            const int dp = m - (STEP - 1 - fr);
            if (dp >= 0 && dp < PM) {
              const cf ga = g0[a * PM + dp];
              a0[fr] = fmaf(ga.r, x0, a0[fr]);
              a0[fr] = fmaf(-ga.i, x1, a0[fr]);
              a1[fr] = fmaf(ga.r, x1, a1[fr]);
              a1[fr] = fmaf(ga.i, x0, a1[fr]);
              if constexpr (TT == 2) {
                const cf gb = g1[a * PM + dp];
                b0[fr] = fmaf(gb.r, x0, b0[fr]);
                b0[fr] = fmaf(-gb.i, x1, b0[fr]);
                b1[fr] = fmaf(gb.r, x1, b1[fr]);
                b1[fr] = fmaf(gb.i, x0, b1[fr]);
              }
            }
          }
        }
      }
#pragma unroll
      for (int fr = 0; fr < STEP; ++fr) {
        const int scf = sc + fr >= NC ? sc + fr - NC : sc + fr;
        const float* cur = ring + (size_t)(CB + scf) * CM;
        const bool pr = t0 + i0 + fr >= lowerN;
        float* of = o + fr * CM;
        of[c0 * M + k] = cur[c0 * M + k] - (pr ? a0[fr] : 0.f);
        of[c0 * M + MH + k] = cur[c0 * M + MH + k] - (pr ? a1[fr] : 0.f);
        if (two) {
          of[c1 * M + k] = cur[c1 * M + k] - (pr ? b0[fr] : 0.f);
          of[c1 * M + MH + k] = cur[c1 * M + MH + k] - (pr ? b1[fr] : 0.f);
        }
      }
    } else if (real) {
      float a0[STEP] = {};
#pragma unroll
      for (int m = 0; m < PM + STEP - 1; ++m) {
#pragma unroll
        for (int a = 0; a < C; ++a) {
          const float x = L[a * M - m * CM];
#pragma unroll
          for (int fr = 0; fr < STEP; ++fr) {
            const int dp = m - (STEP - 1 - fr);
            if (dp >= 0 && dp < PM) a0[fr] = fmaf(g0[a * PM + dp].r, x, a0[fr]);
          }
        }
      }
#pragma unroll
      for (int fr = 0; fr < STEP; ++fr) {
        const int scf = sc + fr >= NC ? sc + fr - NC : sc + fr;
        const float* cur = ring + (size_t)(CB + scf) * CM;
        o[fr * CM + rc * M + rl] = cur[rc * M + rl] - (t0 + i0 + fr >= lowerN ? a0[fr] : 0.f);
      }
    }
  };

  const int nsteps = (nt + STEP - 1) / STEP;
  // slots hold zeros until their first copy: the padded taps dp >= P (g = 0)
  // read them
  for (int idx = tid; idx < NS * CM; idx += nthr) ring[idx] = 0.f;
  __syncthreads();
#pragma unroll 1
  for (int g = 0; g < DG; ++g) fetch(g);
  int sl = (S - lowerN) % NL;  // lag slot of dp = 0 of the step's first output
  int sc = S % NC;             // its current slot, less CB
  // probe: set-up done
  for (int g = 0; g < nsteps; ++g) {
    cp_wait<DG - 1>();
    if (tid == 0) bulk_wait_read();  // step g - 2's rows have left their buffer
    __syncthreads();
    // probe: frame staged
    if (g > 0) flush(g - 1);
    fetch(g + DG);
    // probe: stored
    // both frames, also where the second is past the chunk (its row is
    // computed from stale slots and not stored)
    predict_step(g * STEP, sl, sc, outs + (g & 1) * STEP * CM);
    sl = sl + STEP >= NL ? sl + STEP - NL : sl + STEP;
    sc = sc + STEP >= NC ? sc + STEP - NC : sc + STEP;
    fence_async_shared();
    // probe: predicted
  }
  __syncthreads();
  if (nsteps > 0) flush(nsteps - 1);
  if (tid == 0) bulk_wait();
  // probe: kernel end
}

// ring sizes and shared memory of a launch
struct Plan {
  int NL, CB, NC;
  size_t bytes;
};

Plan plan(int C, int M, int P, int PM, int lowerN, int STEP, int DG) {
  const int S = lowerN + P - 1;
  const size_t frame = sizeof(float) * (size_t)C * M;
  // lags of DG + 1 steps, and the current frames of as many in the same ring
  const int MIR = PM + STEP - 2;  // slots repeated past the end of the lag ring
  const int NL = std::max(S + (DG + 1) * STEP, PM + STEP);
  Plan p{NL, 0, NL, 0};
  p.bytes = (size_t)(p.NL + MIR + 2 * STEP) * frame;
  if (p.bytes > ONE_RING_MAX) {  // lags in one ring, current frames in another
    p = Plan{std::max(P - 1 + (DG + 1) * STEP, PM + STEP), 0, (DG + 1) * STEP, 0};
    p.CB = p.NL + MIR;
    p.bytes = (size_t)(p.CB + p.NC + 2 * STEP) * frame;
  }
  return p;
}

template <int C, int MH, int PM>
struct Launch {
  static constexpr int threads = block_threads<C, MH>();
  static cudaError_t prepare(size_t bytes) {
    return cudaFuncSetAttribute(wpe_resid_kernel<C, MH, PM>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  static int run(const float* Yp, const float* G, float* out, int Tf, int B, int P, int lowerN,
                 cudaStream_t stream) {
    const Plan p = plan(C, 2 * MH, P, PM, lowerN, step_frames<C, MH>(), lead_steps<C, MH>());
    if (p.bytes > 227 * 1024) return DSR_ERR_ARGS;
    cudaError_t err = prepare(p.bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Tf + TC - 1) / TC, B);
    wpe_resid_kernel<C, MH, PM><<<grid, threads, p.bytes, stream>>>(
        Yp, reinterpret_cast<const cf*>(G), out, Tf, B, P, lowerN, p.NL, p.CB, p.NC);
    return static_cast<int>(cudaGetLastError());
  }
  static int occupancy(int P, int lowerN, int* blocks, int* smem_bytes, int* nthreads) {
    const Plan p = plan(C, 2 * MH, P, PM, lowerN, step_frames<C, MH>(), lead_steps<C, MH>());
    *smem_bytes = (int)p.bytes;
    *nthreads = threads;
    if (p.bytes > 227 * 1024) return DSR_ERR_ARGS;
    cudaError_t err = prepare(p.bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wpe_resid_kernel<C, MH, PM>,
                                                          threads, p.bytes);
    return static_cast<int>(err);
  }
};

// ---- C*P > 24 ----
constexpr int WSTEP = 8;  // output frames a step of the wide kernel
constexpr int WPAD = 4;   // floats past a slot's C x 64: consecutive slots start on distinct banks

// blocks an SM each channel count is compiled for: 16 warps an SM where C
// divides 16 (128 registers a thread)
template <int C>
__host__ __device__ constexpr int wide_min_blocks() {
  return C >= 8 ? 2 : 16 / C;
}

// C channels, MH = M/2 lanes, PM >= P lag slots per channel held in
// registers.  Frame r of the block (absolute t0 - S + r) sits in slot r % NL,
// and again in slot NL + r % NL when r % NL < PM + WSTEP - 2 (one ring: the
// current frames are its slots too).
template <int C, int MH, int PM>
__global__ void __launch_bounds__(32 * C, wide_min_blocks<C>())
wpe_resid_wide_kernel(const float* __restrict__ Yp, const cf* __restrict__ G,
                      float* __restrict__ out, int Tf, int B, int P, int lowerN, int NL) {
  extern __shared__ __align__(16) unsigned char smem_w[];
  // probe (wide): kernel start
  constexpr int M = 2 * MH;
  constexpr int F = MH + 1;
  constexpr int CM = C * M;          // one frame of the utterance
  constexpr int SL = C * 64 + WPAD;  // one slot: [a][Re of 32 bins | Im of 32 bins], the pad
  constexpr int MIR = PM + WSTEP - 2;  // slots repeated past the end of the ring
  constexpr int CPM = C * PM;
  const int CP = C * P;
  const int S = lowerN + P - 1;  // deepest lag
  const int NS = NL + MIR;
  float* ring = reinterpret_cast<float*>(smem_w);  // [NS][SL]
  float* gnyq = ring + (size_t)NS * SL;            // Re G of bin M/2: [C][CPM] (group 0)

  const int tid = threadIdx.x;
  const int c = tid >> 5;  // target
  const int lane = tid & 31;
  const int nch = (Tf + TC - 1) / TC;
  const int grp = blockIdx.x / nch;
  const int t0 = (blockIdx.x - grp * nch) * TC;
  const int k = 32 * grp + lane;  // bin (0: DC)
  const int b = blockIdx.y;
  const int nt = min(TC, Tf - t0);
  const size_t frame_stride = (size_t)B * CM;
  const float* Yb = Yp + (size_t)b * CM + 32 * grp;  // this group's lanes of each row
  float* Oc = out + (size_t)b * CM + c * M;          // target c's row

  // conj(G) of (c, bin k) at slot a*PM + dp; (Re G, 0) at the DC bin
  cf g[CPM];
  {
    const cf* Gk = G + (((size_t)b * C + c) * F + k) * CP;
#pragma unroll
    for (int a = 0; a < C; ++a)
#pragma unroll
      for (int dp = 0; dp < PM; ++dp) {
        cf v = {0.f, 0.f};
        if (dp < P) {
          v = Gk[a * P + dp];
          v.i = k == 0 ? 0.f : -v.i;
        }
        g[a * PM + dp] = v;
      }
  }
  if (grp == 0)
    for (int i = tid; i < C * CPM; i += 32 * C) {
      const int cc = i / CPM, a = (i % CPM) / PM, dp = i % PM;
      gnyq[i] = dp < P ? G[(((size_t)b * C + cc) * F + MH) * CP + a * P + dp].r : 0.f;
    }

  // A frame's lanes of this group are 16 C pieces of 16 bytes; thread tid
  // copies piece tid % 16C of every second frame, from frame tid / 16C on
  // (channel a, half, piece of 8), zeros before t = 0
  const int cpiece = tid % (16 * C), cfirst = tid / (16 * C);
  const int src_off = (cpiece >> 4) * M + ((cpiece >> 3) & 1) * MH + (cpiece & 7) * 4;
  const int dst_off = (cpiece >> 4) * 64 + ((cpiece >> 3) & 1) * 32 + (cpiece & 7) * 4;
  auto fetch = [&](int st) {  // the frames that outputs of step st are the first to need
    const int r0 = st == 0 ? 0 : S + st * WSTEP;
    const int r1 = min(S + st * WSTEP + WSTEP, S + nt);
    int sl = (r0 + cfirst) % NL;
    for (int r = r0 + cfirst; r < r1; r += 2) {
      const int t = t0 - S + r;
      const float* src = Yb + (size_t)max(t, 0) * frame_stride + src_off;
      float* dst = ring + (size_t)sl * SL + dst_off;
      cp_async16(dst, src, t >= 0);
      if (sl < MIR) cp_async16(dst + (size_t)NL * SL, src, t >= 0);
      sl = sl + 2 >= NL ? sl + 2 - NL : sl + 2;
    }
    cp_commit();
  };

  const int nsteps = (nt + WSTEP - 1) / WSTEP;
  // slots hold zeros until their first copy: the padded taps dp >= P read them
  if (P < PM)
    for (int idx = tid; idx < NS * SL; idx += 32 * C) ring[idx] = 0.f;
  __syncthreads();
  fetch(0);
  int sl = (S - lowerN) % NL;  // slot of lag dp = 0 of the step's first output
  int sc = S % NL;             // slot of its current frame
  // probe (wide): set-up done
  for (int st = 0; st < nsteps; ++st) {
    cp_wait<0>();
    __syncthreads();
    // probe (wide): frame staged
    fetch(st + 1);
    // probe (wide): copies started
    // outputs st*WSTEP + fr: lag dp of frame fr is slot lb + fr - dp, read
    // here as m = dp + WSTEP - 1 - fr slots below lb + WSTEP - 1, so each lag
    // value is read once for all the frames that use it; slots past the P
    // taps (g = 0) hold earlier frames or zeros
    const int lb = sl < PM - 1 ? sl + NL : sl;
    {
      const float* L = ring + (size_t)(lb + WSTEP - 1) * SL + lane;
      float a0[WSTEP] = {}, a1[WSTEP] = {};  // [frame]: Re and Im of the residual's prediction
#pragma unroll
      for (int m = 0; m < PM + WSTEP - 1; ++m) {
#pragma unroll
        for (int a = 0; a < C; ++a) {
          const float x0 = L[a * 64 - m * SL], x1 = L[a * 64 + 32 - m * SL];
#pragma unroll
          for (int fr = 0; fr < WSTEP; ++fr) {
            const int dp = m - (WSTEP - 1 - fr);
            if (dp >= 0 && dp < PM) {
              const cf ga = g[a * PM + dp];
              a0[fr] = fmaf(ga.r, x0, a0[fr]);
              a0[fr] = fmaf(-ga.i, x1, a0[fr]);
              a1[fr] = fmaf(ga.r, x1, a1[fr]);
              a1[fr] = fmaf(ga.i, x0, a1[fr]);
            }
          }
        }
      }
      float* o = Oc + (size_t)(t0 + st * WSTEP) * frame_stride + k;
#pragma unroll
      for (int fr = 0; fr < WSTEP; ++fr, o += frame_stride) {
        const int i = st * WSTEP + fr;
        if (i < nt) {
          const int scf = sc + fr >= NL ? sc + fr - NL : sc + fr;
          const float* cur = ring + (size_t)scf * SL + c * 64 + lane;
          const bool pr = t0 + i >= lowerN;
          o[0] = cur[0] - (pr ? a0[fr] : 0.f);
          if (k > 0) o[MH] = cur[32] - (pr ? a1[fr] : 0.f);  // lane M/2 of bin 0 is the Nyquist bin
        }
      }
    }
    // probe (wide): predicted
    if (grp == 0 && lane < WSTEP) {  // the Nyquist bin of target c, frame lane of the step
      const int fr = lane;
      const float* Ln = ring + (size_t)(lb + fr) * SL + 32;
      float a0 = 0.f;
#pragma unroll
      for (int dp = 0; dp < PM; ++dp)
#pragma unroll
        for (int a = 0; a < C; ++a)
          a0 = fmaf(gnyq[c * CPM + a * PM + dp], Ln[a * 64 - dp * SL], a0);
      const int i = st * WSTEP + fr;
      if (i < nt) {
        const int scf = sc + fr >= NL ? sc + fr - NL : sc + fr;
        Oc[(size_t)(t0 + i) * frame_stride + MH] =
            ring[(size_t)scf * SL + c * 64 + 32] - (t0 + i >= lowerN ? a0 : 0.f);
      }
    }
    // probe (wide): nyquist
    sl = sl + WSTEP >= NL ? sl + WSTEP - NL : sl + WSTEP;
    sc = sc + WSTEP >= NL ? sc + WSTEP - NL : sc + WSTEP;
  }
  // probe (wide): kernel end
}

// ring slots of a wide launch (one ring, one step ahead), and its shared memory
int wide_slots(int P, int PM, int lowerN) {
  return std::max(lowerN + P - 1 + 2 * WSTEP, PM + WSTEP);
}
size_t wide_bytes(int C, int PM, int NL) {
  return sizeof(float) * ((size_t)(NL + PM + WSTEP - 2) * (C * 64 + WPAD) + (size_t)C * C * PM);
}

template <int C, int MH, int PM>
struct WideLaunch {
  static constexpr int threads = 32 * C;
  static cudaError_t prepare(size_t bytes) {
    return cudaFuncSetAttribute(wpe_resid_wide_kernel<C, MH, PM>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  static int run(const float* Yp, const float* G, float* out, int Tf, int B, int P, int lowerN,
                 cudaStream_t stream) {
    const int NL = wide_slots(P, PM, lowerN);
    const size_t bytes = wide_bytes(C, PM, NL);
    if (bytes > 227 * 1024) return DSR_ERR_ARGS;
    cudaError_t err = prepare(bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((Tf + TC - 1) / TC * (MH / 32), B);
    wpe_resid_wide_kernel<C, MH, PM><<<grid, threads, bytes, stream>>>(
        Yp, reinterpret_cast<const cf*>(G), out, Tf, B, P, lowerN, NL);
    return static_cast<int>(cudaGetLastError());
  }
  static int occupancy(int P, int lowerN, int* blocks, int* smem_bytes, int* nthreads) {
    const size_t bytes = wide_bytes(C, PM, wide_slots(P, PM, lowerN));
    *smem_bytes = (int)bytes;
    *nthreads = threads;
    if (bytes > 227 * 1024) return DSR_ERR_ARGS;
    cudaError_t err = prepare(bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          blocks, wpe_resid_wide_kernel<C, MH, PM>, threads, bytes);
    return static_cast<int>(err);
  }
};

// (C, PM): the registers hold PM = 24 / C lag slots a channel, and 5 at C = 4;
// past 24 / C taps the wide kernel, PM = 40 / C
#define DSR_SHAPES(X) \
  X(1, 24) X(2, 12) X(3, 8) X(4, 5) X(4, 6) X(5, 4) X(6, 4) X(7, 3) X(8, 3)
#define DSR_WIDE_SHAPES(X) \
  X(1, 40) X(2, 20) X(3, 13) X(4, 10) X(5, 8) X(6, 6) X(7, 5) X(8, 5)

// threads of a narrow block (`block_threads`), and its lag slots a channel
int narrow_threads(int C, int MH) {
  const int TT = C == 1 ? 1 : 2;
  return MH * ((C + TT - 1) / TT) + 32;
}
int narrow_slots(int C, int P) { return C == 4 && P <= 5 ? 5 : 24 / C; }
// the wide kernel takes (C, P, lowerN) past 24 / C taps, and where a narrow
// block would take more than 544 threads (the most at M <= 256; C >= 5 at
// M = 512) or 227 KB; every shape above M = 512
constexpr int NARROW_MAX_THREADS = 544;
bool wide(int C, int P, int lowerN, int MH) {
  if (MH > 256 || P > 24 / C || narrow_threads(C, MH) > NARROW_MAX_THREADS) return true;
  return plan(C, 2 * MH, P, narrow_slots(C, P), lowerN, step_frames(C, MH), lead_steps(C, MH))
             .bytes > 227 * 1024;
}
int slots(int C, int P, int lowerN, int MH) {
  return wide(C, P, lowerN, MH) ? 40 / C : narrow_slots(C, P);
}

bool args_ok(int Tf, int B, int C, int M, int P, int lowerN) {
  return Tf > 0 && B > 0 && B <= 65535 && C > 0 && C <= 8 && P > 0 && C * P <= 40 &&
         lowerN >= 0 && (M == 64 || M == 128 || M == 256 || M == 512 || M == 1024 || M == 2048);
}

// the launch of (C, P) at MH = M/2 lanes, or its occupancy (blocks, smem,
// threads non-null)
template <int MH>
int dispatch(const float* Yp, const float* G, float* out, int Tf, int B, int C, int P, int lowerN,
             cudaStream_t stream, int* blocks, int* smem, int* threads) {
  const int PM = slots(C, P, lowerN, MH);
#define DSR_CASE(c, pm, L)                                                          \
  if (C == c && PM == pm)                                                           \
    return blocks ? L<c, MH, pm>::occupancy(P, lowerN, blocks, smem, threads)       \
                  : L<c, MH, pm>::run(Yp, G, out, Tf, B, P, lowerN, stream);
#define DSR_NARROW(c, pm)                                                 \
  if constexpr (MH <= 256 && block_threads<c, MH>() <= NARROW_MAX_THREADS) { \
    DSR_CASE(c, pm, Launch)                                 \
  }
#define DSR_WIDE(c, pm) DSR_CASE(c, pm, WideLaunch)
  if (wide(C, P, lowerN, MH)) {
    DSR_WIDE_SHAPES(DSR_WIDE)
  } else {
    DSR_SHAPES(DSR_NARROW)
  }
#undef DSR_WIDE
#undef DSR_NARROW
#undef DSR_CASE
  return DSR_ERR_ARGS;
}

int dispatch_m(const float* Yp, const float* G, float* out, int Tf, int B, int C, int M, int P,
               int lowerN, cudaStream_t stream, int* blocks, int* smem, int* threads) {
  switch (M) {
    case 64: return dispatch<32>(Yp, G, out, Tf, B, C, P, lowerN, stream, blocks, smem, threads);
    case 128: return dispatch<64>(Yp, G, out, Tf, B, C, P, lowerN, stream, blocks, smem, threads);
    case 256:
      return dispatch<128>(Yp, G, out, Tf, B, C, P, lowerN, stream, blocks, smem, threads);
    case 512:
      return dispatch<256>(Yp, G, out, Tf, B, C, P, lowerN, stream, blocks, smem, threads);
    case 1024:
      return dispatch<512>(Yp, G, out, Tf, B, C, P, lowerN, stream, blocks, smem, threads);
    default:
      return dispatch<1024>(Yp, G, out, Tf, B, C, P, lowerN, stream, blocks, smem, threads);
  }
}

}  // namespace

extern "C" int dsr_wpe_resid(const float* Yp, const float* G, float* out, int Tf, int B, int C,
                             int M, int P, int lowerN, cudaStream_t stream) {
  if (!args_ok(Tf, B, C, M, P, lowerN)) return DSR_ERR_ARGS;
  return dispatch_m(Yp, G, out, Tf, B, C, M, P, lowerN, stream, nullptr, nullptr, nullptr);
}

extern "C" int dsr_wpe_resid_occupancy(int C, int P, int lowerN, int M, int* blocks_per_sm,
                                       int* smem_bytes, int* threads) {
  if (!args_ok(1, 1, C, M, P, lowerN)) return DSR_ERR_ARGS;
  return dispatch_m(nullptr, nullptr, nullptr, 1, 1, C, M, P, lowerN, nullptr, blocks_per_sm,
                    smem_bytes, threads);
}
