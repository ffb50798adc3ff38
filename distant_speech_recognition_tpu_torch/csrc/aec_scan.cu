// Subband echo canceller scan (NLMS, scalar Kalman or one-tap block Kalman),
// one recursion over frames.
//
// Replaces the Pallas TPU kernel ops/pallas_aec.py aec_scan_pallas
// (_make_kernel / _call) of distant_speech_recognition_tpu, and computes what
// models/aec.nlms_aec / kalman_aec / block_kalman_aec (sampleN = 1) compute
// on the unpacked spectrum, per (utterance, channel, bin):
//   E = A - R V
//   nlms:   R <- R - eps |V|^2/(delta + |A|^2) (R - A/V)          if |V|^2 > thr
//   kalman: sv' = beta sv + (1-beta)|E|^2, K' = K + sigma2,
//           R <- R + conj(V) E K'/(|V|^2 K' + sv'), K <- (1 - K'|V|^2/(..)) K'
//                                                                  if |V|^2 > thr
//   with sv and K starting at sigma2; the one-tap block Kalman is the same
//   recursion (its G = K' conj(V)/(Re(V K' conj(V)) + sv') is the gain
//   above) with sv starting at sigmau2 and K at sigmak2: the Kalman kernel
//   with another initial K.  K stays real here, where the plain block Kalman
//   carries it complex with an imaginary part of rounding.
// A [Tf, B, C, M] and V [Tf, B, M] (one far-end reference for every channel)
// in the packed lanes [Re(0..M/2) | Im(1..M/2-1)]; E has A's layout.
//
// What bounds it on an H100: each (utterance, channel, bin) reads 16 bytes
// and writes 8 per frame for a few dozen flops, so it is bound by memory
// (2.96 GB at B=256 x 4 ch x 10 s, 0.88 ms at 3.35 TB/s).  Design:
//   - A block takes one utterance and a group of cg channels (cg divides C;
//     the host takes the largest that fits a block of THREADS and still
//     gives the card a block for each SM), one thread a (channel, bin) of the
//     group, the filter (and the Kalman state) in registers for the whole
//     utterance.  Where one channel's F bins do not fit a block (M = 2048:
//     1,025 bins), the bins are cut into `parts` parts of H = M / (2 parts)
//     bins, a block each: part p holds the Re lanes p H .. p H + H - 1 and
//     the same run of lanes M/2 further (part 0's first of those is the
//     Nyquist bin's Re lane, the others the Im lanes of its bins), so a
//     slot row is two runs of H lanes and a part has H bins (H + 1 in part
//     0).  The bins are independent, so the split leaves each bin's
//     arithmetic as it is; with one part (M <= 1024) the slot is the whole
//     row.
//   - A frame's rows of the group (cg x M floats of A, contiguous) and its
//     far-end row (M floats of V, read once for the group's channels) are
//     staged into a shared-memory ring by 16-byte cp.async copies, DG steps
//     of S frames ahead of the step computed, one block barrier a step; E is
//     written over A's rows in the ring and leaves as one bulk (TMA) copy a
//     frame, issued by a warp of its own, so that loads, recursion and
//     stores of different steps overlap.
//   - A step first computes the state-free front of its S frames (|V|^2,
//     the gate, and NLMS's quotient A conj(V)/|V|^2 and step size), which
//     depends on no state, so the S frames' divisions overlap; then the
//     recursion runs the S frames one after the other.  The divisions run
//     branch-free with the IEEE bits (FastDivOps, dsr_device.h: the
//     instructions of an IEEE division's fast path without its range check
//     and branch), one
//     reciprocal a shared divisor (|V|^2; Kalman's gain and its variance
//     update share one); a gated frame whose quotient it cannot vouch for is
//     redone with the IEEE operators.  The gate and the guarded quotient
//     stay selects of computed values, never blends: a speculative quotient
//     on a silent bin never reaches the state.
// The DC and Nyquist bins have no Im lane and read it as 0.  The arithmetic
// is the first design's (one thread loading groups of 4 frames from device
// memory), operation for operation, so E has the same bits.
#include "dsr_device.h"
#include "dsr_kernels.h"

namespace {

using dsr::FastDivOps;
using dsr::IeeeOps;

constexpr int S = 4;         // frames a step: one block barrier a step
constexpr int DG = 3;        // steps staged ahead of the one computed
constexpr int NSS = DG + 2;  // steps in the ring: stored, computed, staged ahead
constexpr int RING = NSS * S;  // frame slots
// the largest block (4 channels of M = 256 and the store warp), compiled for
// two an SM so that their registers leave room for both
constexpr int THREADS = 576;
constexpr size_t MAX_SMEM = 227 * 1024;
static_assert(RING % S == 0, "a step's slots are consecutive");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
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
// bulk (TMA) copy of one row shared -> global, and its bookkeeping
__device__ __forceinline__ void bulk_store(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;" ::"l"(dst),
               "r"(smem_addr(src)), "r"(bytes)
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

struct Frame {
  float ar, ai, vr, vi;
};

// The first design's arithmetic, with each contraction nvcc chose for it
// written out (its SASS): intrinsics are never contracted again, so the bits
// cannot depend on the context.
__device__ __forceinline__ float abs2(float re, float im) {
  return __fmaf_rn(re, re, __fmul_rn(im, im));
}
// E = A - R V (the imaginary part's second product is the fused one)
__device__ __forceinline__ void aec_error(const Frame& x, float Rr, float Ri, float& Er,
                                          float& Ei) {
  Er = __fsub_rn(x.ar, __fmaf_rn(Rr, x.vr, -__fmul_rn(Ri, x.vi)));
  Ei = __fsub_rn(x.ai, __fmaf_rn(Ri, x.vr, __fmul_rn(Rr, x.vi)));
}

// NLMS's state-free front of one frame: the gate, the quotient A/V (by 1
// where |V| = 0) and the step size
struct NlmsFront {
  bool gate;
  float Gr, Gi, mu;
};

template <class Ops>
__device__ __forceinline__ void nlms_quotients(NlmsFront& q, const Frame& x, float v2, float p1,
                                               float p2, Ops& op) {
  const float den = v2 > 0.f ? v2 : 1.f;
  const typename Ops::R rd = op.recip(den);
  q.Gr = op.div(__fmaf_rn(x.ar, x.vr, __fmul_rn(x.ai, x.vi)), rd);
  q.Gi = op.div(__fmaf_rn(x.ai, x.vr, -__fmul_rn(x.ar, x.vi)), rd);
  q.mu = op.div(__fmul_rn(v2, p2), op.recip(__fadd_rn(abs2(x.ar, x.ai), p1)));
}

__device__ __forceinline__ NlmsFront nlms_front(const Frame& x, float v2, float p1, float p2,
                                                float thr) {
  NlmsFront q;
  q.gate = v2 > thr;
  FastDivOps op;
  nlms_quotients(q, x, v2, p1, p2, op);
  if (q.gate && !op.ok) {
    IeeeOps iv;
    nlms_quotients(q, x, v2, p1, p2, iv);
  }
  return q;
}

// R <- R - mu (R - G)
__device__ __forceinline__ void nlms_update(float& Rr, float& Ri, const NlmsFront& q) {
  Rr = __fmaf_rn(__fsub_rn(Rr, q.Gr), -q.mu, Rr);
  Ri = __fmaf_rn(__fsub_rn(Ri, q.Gi), -q.mu, Ri);
}

struct KalmanState {
  float Rr, Ri, sv, kk;  // filter, observation noise, state variance
};

template <class Ops>
__device__ __forceinline__ void kalman_update(KalmanState& st, const Frame& x, float Er, float Ei,
                                              float v2, float p1, float p2, Ops& op) {
  const float svn = __fmaf_rn(st.sv, p1, __fmul_rn(__fsub_rn(1.f, p1), abs2(Er, Ei)));
  const float kp = __fadd_rn(st.kk, p2);
  const float vk = __fmul_rn(v2, kp);
  const typename Ops::R rs = op.recip(__fadd_rn(svn, vk));
  const float gk = op.div(kp, rs);
  st.Rr = __fmaf_rn(__fmaf_rn(Er, x.vr, __fmul_rn(Ei, x.vi)), gk, st.Rr);
  st.Ri = __fmaf_rn(__fmaf_rn(Ei, x.vr, -__fmul_rn(Er, x.vi)), gk, st.Ri);
  st.sv = svn;
  st.kk = __fmul_rn(kp, __fsub_rn(1.f, op.div(vk, rs)));
}

// One block: utterance b, channels c0 .. c0 + cg - 1, lane part `part` of
// `parts` (W = M / parts lanes a row, H = W / 2 bins, H + 1 in part 0);
// thread (cl, fl) = (tid / (H + 1), tid % (H + 1)).  Ring slot t % RING
// holds frame t: the group's rows of the part [cg][W] (A in, E out) then
// the far-end row's [W].
template <bool KALMAN>
__global__ void __launch_bounds__(THREADS, 2)
aec_scan_kernel(const float* __restrict__ A, const float* __restrict__ V, float* __restrict__ E,
                int Tf, int B, int C, int M, int cg, int parts, float p1, float p2, float k0,
                float thr) {
  extern __shared__ __align__(16) float ring[];
  // probe: kernel start
  const int F = M / 2 + 1;
  const int groups = C / cg;
  const int W = M / parts, H = W / 2;
  const int b = blockIdx.x / (groups * parts);
  const int gp = blockIdx.x - b * groups * parts;
  const int c0 = gp / parts * cg;
  const int part = gp - gp / parts * parts;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int cl = tid / (H + 1);
  const int fl = tid - cl * (H + 1);
  const bool active = cl < cg && (part == 0 || fl < H);
  const int f = part == 0 && fl == H ? M / 2 : part * H + fl;  // part 0's bin H: Nyquist's
  const bool has_im = f >= 1 && f <= F - 2;
  const int slot_floats = (cg + 1) * W;
  // this thread's lanes in a slot (a real bin reads its Re lane twice, and
  // takes 0 for the second)
  const int ia = cl * W + fl;
  const int ia_im = has_im ? ia + H : ia;
  const int iv = cg * W + fl;
  const int iv_im = has_im ? iv + H : iv;
  const size_t a_frame = (size_t)B * C * M, v_frame = (size_t)B * M;
  const float* Ab = A + ((size_t)b * C + c0) * M;
  const float* Vb = V + (size_t)b * M;
  float* Eb = E + ((size_t)b * C + c0) * M;
  const int nsteps = (Tf + S - 1) / S;
  // the copies: 16 bytes of a frame's slot a thread (a frame has no more
  // 16-byte pieces, (cg + 1) W / 4, than the block has threads); piece q4 of
  // a part's row is row lane q4 of the whole row with one part, else lane
  // part H + q4 of its first run or M/2 + part H + q4 - H of its second
  const int row16 = cg * W / 4;
  const bool copier = tid < row16 + W / 4;
  const int q4 = 4 * (tid < row16 ? tid % (W / 4) : tid - row16);
  const int lane = parts == 1 ? q4 : q4 < H ? part * H + q4 : M / 2 + part * H + q4 - H;
  const float* src0 = tid < row16 ? Ab + (size_t)(tid / (W / 4)) * M + lane : Vb + lane;
  const size_t src_frame = tid < row16 ? a_frame : v_frame;

  auto fetch = [&](int st) {  // the frames of step st into their slots
#pragma unroll
    for (int tt = 0; tt < S; ++tt) {
      const int t = st * S + tt;
      if (copier && t < Tf)
        cp_async16(ring + (size_t)(t % RING) * slot_floats + 4 * tid, src0 + t * src_frame);
    }
    cp_commit();
  };
  // the store warp, the block's last, computes nothing: its first thread
  // issues the bulk stores, off the recursion's warps
  const bool storer = tid == nthr - 32;
  auto flush = [&](int st) {  // E of step st's frames, one bulk copy a frame (a run with parts)
    if (storer) {
      for (int t = st * S; t < min(st * S + S, Tf); ++t) {
        const float* sl = ring + (size_t)(t % RING) * slot_floats;
        if (parts == 1) {
          bulk_store(Eb + t * a_frame, sl, cg * M * (int)sizeof(float));
        } else {
          for (int c = 0; c < cg; ++c)
            for (int run = 0; run < 2; ++run)
              bulk_store(Eb + t * a_frame + (size_t)c * M + run * (M / 2) + part * H,
                         sl + c * W + run * H, H * (int)sizeof(float));
        }
      }
      bulk_commit();
    }
  };

  KalmanState ks{0.f, 0.f, p2, k0};  // NLMS keeps its filter in Rr, Ri
#pragma unroll
  for (int st = 0; st < DG; ++st)
    if (st < nsteps) fetch(st);
    else cp_commit();
  // probe: set-up done
  for (int st = 0; st < nsteps; ++st) {
    cp_wait<DG - 1>();
    if (storer) bulk_wait_read();  // the slots refilled below have left for E
    __syncthreads();
    // probe: step staged
    if (st > 0) flush(st - 1);
    if (st + DG < nsteps) fetch(st + DG);
    else cp_commit();
    // probe: copies started
    if (active) {
      const int t0 = st * S;
      const int slot0 = t0 % RING;  // the step's S slots are consecutive
      float* sl = ring + slot0 * slot_floats;
      Frame x[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        const float* fr = sl + s * slot_floats;
        const float ai = fr[ia_im], vi = fr[iv_im];
        x[s] = Frame{fr[ia], has_im ? ai : 0.f, fr[iv], has_im ? vi : 0.f};
      }
      // the state-free front of the step's frames (past Tf: stale slots,
      // computed and dropped)
      NlmsFront q[S];
      float v2[S];
#pragma unroll
      for (int s = 0; s < S; ++s) {
        v2[s] = abs2(x[s].vr, x[s].vi);
        if constexpr (!KALMAN) q[s] = nlms_front(x[s], v2[s], p1, p2, thr);
      }
      // probe: front done
#pragma unroll
      for (int s = 0; s < S; ++s) {
        if (t0 + s >= Tf) break;  // uniform over the block
        const Frame& xs = x[s];
        float Er, Ei;
        aec_error(xs, ks.Rr, ks.Ri, Er, Ei);
        if constexpr (KALMAN) {
          if (v2[s] > thr) {
            FastDivOps op;
            KalmanState k1 = ks;
            kalman_update(k1, xs, Er, Ei, v2[s], p1, p2, op);
            if (!op.ok) {
              IeeeOps iv_;
              k1 = ks;
              kalman_update(k1, xs, Er, Ei, v2[s], p1, p2, iv_);
            }
            ks = k1;
          }
        } else if (q[s].gate) {
          nlms_update(ks.Rr, ks.Ri, q[s]);
        }
        sl[s * slot_floats + ia] = Er;
        if (has_im) sl[s * slot_floats + ia_im] = Ei;
      }
      // probe: recursion done
    }
    fence_async_shared();
    // probe: stored
  }
  __syncthreads();
  if (nsteps > 0) flush(nsteps - 1);
  if (storer) bulk_wait();
  // probe: kernel end
}

// The launch: lane parts a row (the fewest, a power of two, whose H + 1
// bins fit a block beside the store warp: one up to M = 1024), channels a
// block (a divisor cg of C whose block fits in THREADS and the shared
// memory), threads and ring bytes.  Fewest waves of blocks first; then,
// where some cg gives every SM a block, the largest such cg (the far-end
// row is staged once for cg channels); else cg = 1, the most blocks (a
// step's front then shares an SM with the fewest warps)
struct Plan {
  int cg, parts, threads, per_sm;
  size_t bytes;
};

int lane_parts(int M) {
  int parts = 1;
  while ((M / (2 * parts) + 1 + 31) / 32 * 32 + 32 > THREADS) parts *= 2;
  return parts;
}

template <bool KALMAN>
cudaError_t plan(int B, int C, int M, Plan* out) {
  const void* kern = (const void*)aec_scan_kernel<KALMAN>;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // once for every candidate: the occupancy query takes the ring's bytes
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)MAX_SMEM);
  if (err != cudaSuccess) return err;
  const int parts = lane_parts(M);
  const int W = M / parts;
  *out = Plan{0, 0, 0, 0, 0};
  long long best_waves = 0;
  for (int cg = 1; cg <= C; ++cg) {
    if (C % cg) continue;
    const int threads = (cg * (W / 2 + 1) + 31) / 32 * 32 + 32;  // and the store warp
    const size_t bytes = sizeof(float) * RING * (size_t)(cg + 1) * W;
    if (threads > THREADS || bytes > MAX_SMEM) break;
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, bytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) break;
    const long long blocks = (long long)B * (C / cg) * parts;
    const long long waves = (blocks + (long long)per_sm * sms - 1) / ((long long)per_sm * sms);
    if (out->cg == 0 || waves < best_waves || (waves == best_waves && blocks >= sms)) {
      *out = Plan{cg, parts, threads, per_sm, bytes};
      best_waves = waves;
    }
  }
  return cudaSuccess;
}

template <bool KALMAN>
int launch(const float* A, const float* V, float* E, int Tf, int B, int C, int M, float p1,
           float p2, float k0, float thr, cudaStream_t stream) {
  Plan p;
  const cudaError_t err = plan<KALMAN>(B, C, M, &p);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.cg == 0) return DSR_ERR_ARGS;
  aec_scan_kernel<KALMAN><<<B * (C / p.cg) * p.parts, p.threads, p.bytes, stream>>>(
      A, V, E, Tf, B, C, M, p.cg, p.parts, p1, p2, k0, thr);
  return static_cast<int>(cudaGetLastError());
}

template <bool KALMAN>
int shape(int B, int C, int M, int* blocks, int* threads, int* cg, int* smem_bytes, int* regs,
          int* blocks_per_sm) {
  Plan p;
  cudaFuncAttributes attr;
  cudaError_t err = plan<KALMAN>(B, C, M, &p);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, aec_scan_kernel<KALMAN>);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (p.cg == 0) return DSR_ERR_ARGS;
  *blocks = B * (C / p.cg) * p.parts;
  *threads = p.threads;
  *cg = p.cg;
  *smem_bytes = (int)p.bytes;
  *regs = attr.numRegs;
  *blocks_per_sm = p.per_sm;
  return 0;
}

// M a multiple of 4 up to 1024, where a row is one part, and of 8 a part
// above (16-byte runs)
bool args_ok(int Tf, int B, int C, int M) {
  return Tf > 0 && B > 0 && C > 0 && M >= 4 && M <= 2048 && M % 4 == 0 &&
         (lane_parts(M) == 1 || (M / lane_parts(M)) % 8 == 0) &&
         (long long)B * C * lane_parts(M) <= 0x7fffffffLL;
}

}  // namespace

extern "C" int dsr_aec_scan(const float* A, const float* V, float* E, int Tf, int B, int C, int M,
                            int kalman, float p1, float p2, float thr, cudaStream_t stream) {
  if (!args_ok(Tf, B, C, M)) return DSR_ERR_ARGS;
  return kalman ? launch<true>(A, V, E, Tf, B, C, M, p1, p2, p2, thr, stream)
                : launch<false>(A, V, E, Tf, B, C, M, p1, p2, p2, thr, stream);
}

// The one-tap block Kalman: the Kalman kernel with sv starting at sigmau2
// and K at sigmak2
extern "C" int dsr_aec_scan_block_kalman(const float* A, const float* V, float* E, int Tf, int B,
                                         int C, int M, float beta, float sigmau2, float sigmak2,
                                         float thr, cudaStream_t stream) {
  if (!args_ok(Tf, B, C, M)) return DSR_ERR_ARGS;
  return launch<true>(A, V, E, Tf, B, C, M, beta, sigmau2, sigmak2, thr, stream);
}

extern "C" int dsr_aec_scan_shape(int B, int C, int M, int kalman, int* blocks, int* threads,
                                  int* cg, int* smem_bytes, int* regs, int* blocks_per_sm) {
  if (!args_ok(1, B, C, M)) return DSR_ERR_ARGS;
  return kalman ? shape<true>(B, C, M, blocks, threads, cg, smem_bytes, regs, blocks_per_sm)
                : shape<false>(B, C, M, blocks, threads, cg, smem_bytes, regs, blocks_per_sm);
}
