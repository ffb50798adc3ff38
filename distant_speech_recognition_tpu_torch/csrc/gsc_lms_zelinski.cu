// GSC with the leaky power-normalised LMS active weight vector + Zelinski
// postfilter, one recursion over frames (BASELINE config 3).
//
// dsr_gsc_lms_zelinski computes what
// models/adaptive_gsc.gsc_postfilter_fused(kind="lms", real_packed=True,
// energy=None) computes, within rounding: per frame the blocking and
// quiescent outputs Z = BmH X and Yc = wqH X, the silence gate on the
// smoothed reference-channel frame energy, the Zelinski gain on the
// time-aligned snapshot, and the LMS update (the step size halved every
// slowdown_after frames, the smoothed subband power, the leaky normalised
// update on the old weights, the norm cap, the gated commit, the output on
// the committed weights).  Input and output keep the packed time-major lanes
// [Re(0..M/2) | Im(1..M/2-1)].  With pf_min_frames at or past the last frame
// the gain is computed and never applied (postfilter "none").  The weights
// and the manifold are one set [F, ...] for every utterance
// (dsr_gsc_lms_zelinski) or one per utterance [B, F, ...]
// (dsr_gsc_lms_zelinski_steered: the steered GSC-LMS, each utterance at its
// own DOA estimate, as K6 is for the RLS); only the row a lane reads
// differs.  It replaces no TPU kernel: the JAX package runs this recursion
// in XLA.
//
// What bounds it on an H100: the recursion is serial over frames and
// independent over (utterance, bin).  A frame of a bin reads C complex
// values and multiplies them by the C x C matrix [wqH; BmH] (C^2 complex
// products), so the scan is bound by instruction issue at large batches and
// by the latency of one frame's chain at small ones, not by its bytes.
// Design:
//   - two kernels on the stream, each with its C entry: the silence gates
//     first, once per (utterance, frame) (dsr_lms_gates), then the scan
//     (dsr_gsc_lms_zelinski).  The gate compares the frame's
//     reference-channel energy with the smoothed energy before its update,
//     divided by sil_thresh (the JAX step's order, the IEEE division).  The
//     gate pass is two launches: blocks of (utterance, tile of frames) sum
//     the frames' energies into the gates' own buffer (a warp a frame, a
//     shuffle butterfly over the lanes' partial sums), then blocks of 32
//     utterances run the recursion from delta, a lane an utterance, and
//     overwrite each energy with its flag, coalesced along the utterances.
//     The scan reads one flag a bin-frame: neither the
//     reference rows of the utterances a block touches nor the recursion and
//     its division are in the scan;
//   - two lanes a bin, adjacent lanes of a warp.  Lane h holds rows h R ..
//     h R + R - 1 (R = ceil(C/2)) of [wqH; BmH] in registers, so a bin's
//     constants are split between its lanes, not copied, and each lane forms
//     its rows of [Yc; Z] from the whole snapshot.  The active weights are
//     split the same way and carried as v = -waH, beside a fixed 1 for the Yc
//     row: the error Yc - waH Z and the output are each a lane's partial sum
//     and one shuffle, the weights' squared norm one more.  Lane h also takes
//     channels h R .. of the snapshot's power and of the Zelinski sums, one
//     butterfly step for all of them.  Both lanes then run the scalar part of
//     the update alike (same operands, same bits), so neither waits on the
//     other's quotients.  At most 128 registers a lane: four blocks of 128
//     lanes fill an SM, and B = 256 utterances at M = 256 run in one wave;
//   - each warp stages its own 16 bins, a frame at a time and RING frames
//     ahead, by cp.async into a ring of its own in shared memory (lane 0 of a
//     bin copies the real parts and the gate, lane 1 the imaginary parts).
//     The copies are spread evenly over the frames, so the load unit never
//     holds the lanes up the way a whole chunk's copies at once did, and a
//     warp waits only for its own copies (cp.async.wait_group, __syncwarp):
//     no block barrier;
//   - the Zelinski pair sum in O(C) work: for pf_type & 1 only
//     Re sum_{i<j} a_i conj(a_j) = (|sum_c a_c|^2 - sum_c |a_c|^2) / 2 is
//     read; otherwise sum_j (sum_{i<j} a_i) conj(a_j) within each lane's
//     channels, and the two lanes' halves joined by A_lo conj(A_hi);
//   - the divisions gamma / se and the Zelinski quotient (and the norm cap's,
//     where it fires) through FastDivOps (dsr_device.h) on the dividend
//     scaled by 2^32, which is exact and moves these quotients into the range
//     it vouches for; the IEEE operator where it cannot vouch.
#include "dsr_kernels.h"
#include "gsc_scan.h"  // cp.async, args_ok

namespace {

using namespace dsr;

constexpr int LMS_THREADS = 128;
constexpr int LMS_LANES = 2;      // lanes a bin
constexpr int LMS_BLOCKS_SM = 4;  // blocks an SM holds at 128 registers a lane
constexpr int LMS_RING = 12;      // frames a warp stages ahead: its ring's slots
constexpr int ENERGY_THREADS = 256;
constexpr int ENERGY_FRAMES = 64;   // frames of an utterance a block sums
constexpr int ENERGY_AHEAD = 4;     // frames a warp loads before it sums them
constexpr int RECURSION_THREADS = 256;
constexpr int RECURSION_TILE = 128;  // frames of 32 utterances a tile (a multiple of 16)

// the Zelinski stage compiled in: the positive real part of the pair sum
// (pf_type & 1), or its modulus
enum { ZEL_REAL = 1, ZEL_ABS = 2 };

struct LmsParams {
  float beta, one_minus_beta, gamma, delta, reg_param, energy_floor, max_wa_l2norm;
  int min_frames, slowdown_after;
  float pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor;
  int pf_min_frames;
};

// a ring slot of a warp: its 16 bins of channels 0..C-1 [C][16] as float2,
// then their gates [16]
__host__ __device__ constexpr int slot_floats(int C) { return C * 32 + 16; }
size_t lms_smem_bytes(int C) {
  return 4 * (size_t)(LMS_THREADS / 32) * LMS_RING * slot_floats(C);
}
int lms_blocks(int B, int M) {
  return (int)(((long long)B * (M / 2 + 1) * LMS_LANES + LMS_THREADS - 1) / LMS_THREADS);
}

// The gate pass, first launch: the reference channel's frame energies
// en[t * B + b] (in the gates' buffer) of utterance b and frames t0 .. t0 +
// ENERGY_FRAMES - 1 of block (b, tile): warp w takes frames t0 + w, t0 + w +
// 8, ..., ENERGY_AHEAD at a time, the loads of NGB groups of 32 bins of
// them all issued before any is summed (all groups at F <= 32 NGB, else
// batches of NGB in turn); lane l adds ew |X0|^2 of bins l, l + 32, ... in
// order, a shuffle butterfly adds the lanes (every lane ends with the same
// sum) and the sum over M is the frame's energy
template <int NGB>
__global__ void __launch_bounds__(ENERGY_THREADS)
    lms_energy_kernel(const float* __restrict__ Yp, float* __restrict__ en, int Tf, int B, int C,
                      int M) {
  constexpr int WARPS = ENERGY_THREADS / 32;
  const int tiles = (Tf + ENERGY_FRAMES - 1) / ENERGY_FRAMES;
  const int b = blockIdx.x / tiles;
  const int t0 = (blockIdx.x - b * tiles) * ENERGY_FRAMES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int F = M / 2 + 1;
  const int ng = (F + 31) / 32;
  const int nt = min(ENERGY_FRAMES, Tf - t0);
  for (int k = warp; k < nt; k += WARPS * ENERGY_AHEAD) {
    float s[ENERGY_AHEAD];
#pragma unroll
    for (int u = 0; u < ENERGY_AHEAD; ++u) s[u] = 0.f;
    for (int g0 = 0; g0 < ng; g0 += NGB) {
      float re[ENERGY_AHEAD][NGB], im[ENERGY_AHEAD][NGB];
#pragma unroll
      for (int u = 0; u < ENERGY_AHEAD; ++u) {
        const int tt = k + u * WARPS;
        const float* x = Yp + ((size_t)(t0 + tt) * B + b) * C * M;
#pragma unroll
        for (int g = 0; g < NGB; ++g) {
          const int bin = (g0 + g) * 32 + lane;
          re[u][g] = tt < nt && bin < F ? __ldg(x + bin) : 0.f;
          im[u][g] = tt < nt && bin >= 1 && bin <= F - 2 ? __ldg(x + F + bin - 1) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < ENERGY_AHEAD; ++u) {
#pragma unroll
        for (int g = 0; g < NGB; ++g) {
          const int bin = (g0 + g) * 32 + lane;
          if (bin < F)
            s[u] += energy_term(bin == 0 || bin == F - 1 ? 1.f : 2.f, {re[u][g], im[u][g]});
        }
      }
    }
#pragma unroll
    for (int u = 0; u < ENERGY_AHEAD; ++u) {
      const int tt = k + u * WARPS;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
      if (lane == 0 && tt < nt) en[(size_t)(t0 + tt) * B + b] = s[u] / (float)M;
    }
  }
}

// The gate pass, second launch: utterance b's smoothed-energy recursion over
// its energies g[t * B + b] (the energy before each frame's update, starting
// at delta), each energy overwritten with the frame's gate, the energy
// against that smoothed energy divided by sil_thresh.  A block takes 32
// utterances, a tile of RECURSION_TILE frames at a time in shared memory:
// warp 0 runs the tile's recursion, a lane an utterance, while the other
// warps load the next tile (cp.async); then every warp takes frames in turn
// for the divisions (`fast_div<32>`, the IEEE operator where it cannot
// vouch), the comparisons and the stores, each frame's 32 utterances one
// coalesced row
__global__ void __launch_bounds__(RECURSION_THREADS)
    lms_gate_recursion_kernel(float* g, int Tf, int B, float beta, float one_minus_beta,
                              float delta, float sil_thresh) {
  constexpr int WARPS = RECURSION_THREADS / 32;
  constexpr int TILE = RECURSION_TILE;
  constexpr int ROWS = TILE / WARPS;  // rows of a tile a warp turns into gates
  __shared__ float en[2][TILE][32], sm[TILE][32];  // energies (two tiles), smoothed energies
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x * 32 + lane;
  const bool valid = b < B;
  float* col = g + b;
  // a tile's rows tt = w - w0, w - w0 + nw, ... by warps w0 .. w0 + nw - 1, all
  // in flight at once, in before the warp's next barrier
  auto load = [&](int t0, float (*e)[32], int w0, int nw) {
    const int nt = min(TILE, Tf - t0);
    for (int tt = warp - w0; tt < nt; tt += nw)
      cp_async4(&e[tt][lane], col + (size_t)(t0 + tt) * B, valid);
    cp_commit();
    cp_wait<0>();
  };
  load(0, en[0], 0, WARPS);
  float st = delta;
  for (int t0 = 0, k = 0; t0 < Tf; t0 += TILE, k ^= 1) {
    const int nt = min(TILE, Tf - t0);
    __syncthreads();  // this tile is in, and the last tile's gates are out
    if (warp == 0) {
      // 16 energies into registers before their 16 steps, so that the reads
      // stay off the chain; the steps past the last frame (of a stale tile
      // row) are never read
      for (int tt0 = 0; tt0 < nt; tt0 += 16) {
        float e[16];
#pragma unroll
        for (int u = 0; u < 16; ++u) e[u] = en[k][tt0 + u][lane];
#pragma unroll
        for (int u = 0; u < 16; ++u) {
          sm[tt0 + u][lane] = st;
          st = __fadd_rn(__fmul_rn(st, beta), __fmul_rn(one_minus_beta, e[u]));
        }
      }
    } else if (t0 + TILE < Tf) {
      load(t0 + TILE, en[k ^ 1], 1, WARPS - 1);
    }
    __syncthreads();  // the tile's smoothed energies, and the next tile
    // warp w's frames w, w + 8, ...: the quotients without a branch, the
    // IEEE operator for all of them where one cannot be vouched for
    float q[ROWS];
    bool ok = true;
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      bool ok_i;
      q[i] = fast_div<32>(sm[warp + WARPS * i][lane], sil_thresh, ok_i);
      ok &= ok_i;
    }
    if (!ok) {
#pragma unroll
      for (int i = 0; i < ROWS; ++i) q[i] = sm[warp + WARPS * i][lane] / sil_thresh;
    }
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int tt = warp + WARPS * i;
      if (valid && tt < nt) col[(size_t)(t0 + tt) * B] = en[k][tt][lane] > q[i] ? 1.f : 0.f;
    }
  }
}

template <int NGB>
cudaError_t lms_energy_launch(const float* Yp, float* en, int Tf, int B, int C, int M,
                              cudaStream_t stream) {
  const long long blocks = (long long)B * ((Tf + ENERGY_FRAMES - 1) / ENERGY_FRAMES);
  lms_energy_kernel<NGB><<<(unsigned)blocks, ENERGY_THREADS, 0, stream>>>(Yp, en, Tf, B, C, M);
  return cudaGetLastError();
}

int lms_gate_pass(const float* Yp, float* gates, int Tf, int B, int C, int M, float beta,
                  float one_minus_beta, float delta, float sil_thresh, cudaStream_t stream) {
  cudaError_t err;
  const int ng = (M / 2 + 32) / 32;  // groups of 32 bins: all in one batch up to 9 (F <= 257)
  switch (ng < 9 ? ng : 9) {
#define DSR_CASE(ng) \
  case ng: err = lms_energy_launch<ng>(Yp, gates, Tf, B, C, M, stream); break;
    DSR_CASE(1) DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7)
    DSR_CASE(8) DSR_CASE(9)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  lms_gate_recursion_kernel<<<(B + 31) / 32, RECURSION_THREADS, 0, stream>>>(
      gates, Tf, B, beta, one_minus_beta, delta, sil_thresh);
  return static_cast<int>(cudaGetLastError());
}

// acc + a x
__device__ __forceinline__ cf cfma(cf a, cf x, cf acc) {
  return {__fmaf_rn(-a.i, x.i, __fmaf_rn(a.r, x.r, acc.r)),
          __fmaf_rn(a.i, x.r, __fmaf_rn(a.r, x.i, acc.i))};
}

// v summed over the bin's two lanes; both lanes get the same bits (IEEE
// addition commutes)
__device__ __forceinline__ float pair_sum(float v) {
  return v + __shfl_xor_sync(0xffffffffu, v, 1);
}

// a / b with IEEE division's bits: FastDivOps at 2^32 (gamma / se ~ 1e-12
// and the Zelinski ratio both lie inside its range), the operator where it
// cannot vouch
__device__ __forceinline__ float lms_div(float a, float b) {
  bool ok;
  float q = fast_div<32>(a, b, ok);
  if (!ok) q = a / b;
  return q;
}

template <int C, int ZM>
__global__ void __launch_bounds__(LMS_THREADS, LMS_BLOCKS_SM)
    gsc_lms_zelinski_kernel(const float* __restrict__ Yp, const float* __restrict__ gates,
                            const float* __restrict__ wq, const float* __restrict__ bm,
                            const float* __restrict__ ta, float* __restrict__ out, int Tf, int B,
                            int M, bool per_utt, LmsParams p) {
  // rows of [wqH; BmH] a lane holds, and channels of its partial sums
  constexpr int R = (C + 1) / 2;
  constexpr int SLOT = slot_floats(C);
  extern __shared__ __align__(16) float smem[];
  // probe: kernel start
  const int F = M / 2 + 1;
  const long long n = (long long)B * F;
  const int h = threadIdx.x & 1;          // the lane in the bin
  const int j = (threadIdx.x & 31) >> 1;  // the bin in the warp
  const long long i = (long long)blockIdx.x * (LMS_THREADS / 2) + (threadIdx.x >> 1);
  const bool valid = i < n;
  const long long ic = valid ? i : n - 1;  // idle lanes shadow the last bin, never write
  const int b = (int)(ic / F);
  const int f = (int)(ic - (long long)b * F);
  const bool has_im = f >= 1 && f <= F - 2;
  const bool yc = h == 0;  // this lane's row 0 is Yc's

  // this lane's rows of [wqH; BmH] (zero past row C - 1) from this
  // utterance's row of bin f: one set of weights [F, ...] for every
  // utterance, or one per utterance [B, F, ...]
  const size_t wf = (per_utt ? (size_t)b * F : 0) + f;
  cf W[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = h * R + r;
    const float* w = g == 0 ? wq + wf * C * 2 : bm + (wf * (C - 1) + (g - 1)) * C * 2;
#pragma unroll
    for (int c = 0; c < C; ++c) W[r][c] = g < C ? cf{w[2 * c], w[2 * c + 1]} : cf{0.f, 0.f};
  }
  // conj of the alignment manifold at this lane's channels h R + r, and |.|^2
  cf tz[R];
  float t2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int c = h * R + r;
    tz[r] = c < C ? cf{ta[(wf * C + c) * 2], -ta[(wf * C + c) * 2 + 1]} : cf{0.f, 0.f};
    t2[r] = cabs2(tz[r]);
  }

  // v: -waH of this lane's Z rows, and 1 for the Yc row; a new utterance
  // starts from waH = 0, the smoothed subband power at delta
  cf v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = {yc && r == 0 ? 1.f : 0.f, 0.f};
  float se = p.delta, gamma = p.gamma;
  int until_slow = p.slowdown_after;  // frames until the step size halves
  float phr = 0.f, phi = 0.f, phd = 0.f;  // the smoothed Zelinski pair sum and trace

  // this warp's ring, and this lane's part of its bin in a slot: the real
  // (lane 0) or imaginary (lane 1, zero at DC and Nyquist) parts of
  // channels 0..C-1, and lane 0 the gate
  float* ring = smem + (size_t)(threadIdx.x >> 5) * LMS_RING * SLOT;
  const bool on = valid && (h == 0 || has_im);
  const size_t frame = (size_t)B * C * M;
  auto stage = [&](const float* x, const float* g, float* slot) {
#pragma unroll
    for (int c = 0; c < C; ++c) cp_async4(slot + c * 32 + 2 * j + h, x + (size_t)c * M, on);
    if (h == 0) cp_async4(slot + C * 32 + j, g, valid);
  };
  // the next frame to stage, and its gate
  const float* x = Yp + (size_t)b * C * M + (h ? (has_im ? F - 1 + f : 0) : f);
  const float* g = gates + b;
  for (int t = 0; t < LMS_RING - 1; ++t, x += frame, g += B) {
    if (t < Tf) stage(x, g, ring + t * SLOT);
    cp_commit();
  }
  // probe: set-up done

  float* o = out + (size_t)b * M + (h ? F - 1 + f : f);  // lane 0 stores Re, lane 1 Im
  const bool store = valid && (h == 0 || has_im);
  for (int t = 0, s = 0, s1 = LMS_RING - 1; t < Tf; ++t) {
    // frame t + RING - 1 into the slot of frame t - 1, which both lanes of
    // every bin of the warp are done with; then frame t's copies are in
    __syncwarp();
    if (t + LMS_RING - 1 < Tf) stage(x, g, ring + s1 * SLOT);
    cp_commit();
    x += frame;
    g += B;
    cp_wait<LMS_RING - 1>();
    __syncwarp();
    // probe: frame staged
    const float2* X = reinterpret_cast<const float2*>(ring + s * SLOT) + j;
    const bool gate = ring[s * SLOT + C * 32 + j] != 0.f;
    s = s + 1 == LMS_RING ? 0 : s + 1;
    s1 = s1 + 1 == LMS_RING ? 0 : s1 + 1;

    // front: this lane's rows of [Yc; Z] from the whole snapshot, and the
    // partial sums over its channels h R + r: the snapshot's power and the
    // Zelinski sums (A = sum of the aligned channels, ds = their power,
    // P = sum_j (sum_{i<j} a_i) conj(a_j))
    cf row[R];
#pragma unroll
    for (int r = 0; r < R; ++r) row[r] = {0.f, 0.f};
    float xp = 0.f, ds = 0.f;
    cf A = {0.f, 0.f}, P = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float2 ga = X[r * 16];
      const float2 gb = R + r < C ? X[(R + r < C ? R + r : 0) * 16] : float2{0.f, 0.f};
      const cf xa = {ga.x, ga.y}, xb = {gb.x, gb.y};
#pragma unroll
      for (int q = 0; q < R; ++q) {
        row[q] = cfma(W[q][r], xa, row[q]);
        if (R + r < C) row[q] = cfma(W[q][R + r < C ? R + r : 0], xb, row[q]);
      }
      const cf x = h ? xb : xa;
      const float x2 = __fmaf_rn(x.r, x.r, __fmul_rn(x.i, x.i));
      xp += x2;
      if constexpr (ZM == ZEL_REAL) {
        A = cfma(tz[r], x, A);
        ds = __fmaf_rn(t2[r], x2, ds);
      } else if constexpr (ZM == ZEL_ABS) {
        const cf al = cmul(tz[r], x);
        ds = __fmaf_rn(al.r, al.r, __fmaf_rn(al.i, al.i, ds));
        P = {__fmaf_rn(A.i, al.i, __fmaf_rn(A.r, al.r, P.r)),
             __fmaf_rn(-A.r, al.i, __fmaf_rn(A.i, al.r, P.i))};  // P + A conj(al)
        A = cadd(A, al);
      }
    }
    // probe: front done

    // the bin's sums: one butterfly step
    xp = pair_sum(xp);
    float Wz;  // the Zelinski gain
    {
      ds = pair_sum(ds);
      float psr, psi = 0.f;
      if constexpr (ZM == ZEL_REAL) {
        A.r = pair_sum(A.r);
        A.i = pair_sum(A.i);
        psr = 0.5f * (__fmaf_rn(A.r, A.r, __fmul_rn(A.i, A.i)) - ds);
      } else {
        const cf Ao = {__shfl_xor_sync(0xffffffffu, A.r, 1),
                       __shfl_xor_sync(0xffffffffu, A.i, 1)};
        const cf lo = h ? Ao : A, hi = h ? A : Ao;
        const cf cross = cmulc(lo, hi);  // the pairs across the halves
        psr = pair_sum(P.r) + cross.r;
        psi = pair_sum(P.i) + cross.i;
      }
      // smoothed from the third frame on (postfilter.cc:424-463)
      if (t > 1) {
        phr = p.pf_alpha * phr + p.one_minus_pf_alpha * psr;
        phi = p.pf_alpha * phi + p.one_minus_pf_alpha * psi;
        phd = p.pf_alpha * phd + p.one_minus_pf_alpha * ds;
      } else {
        phr = psr;
        phi = psi;
        phd = ds;
      }
      const float num = ZM == ZEL_REAL ? fmaxf(phr, 0.f)
                                       : sqrtf(__fmaf_rn(phr, phr, __fmul_rn(phi, phi)));
      // a zero trace gives ratio 0, a zero numerator quotient 0
      const float q = phd > 0.f && num != 0.f ? lms_div(num, phd) : 0.f;
      Wz = fminf(fmaxf(q * p.pf_gain, p.spectral_floor), 1.f);
    }
    // probe: sums done

    // the LMS update, the scalars alike in both lanes: the step size, the
    // smoothed subband power, the error on the old weights
    if (until_slow == 0) {
      gamma *= 0.5f;
      until_slow = p.slowdown_after;
    }
    --until_slow;
    const float sn = fmaxf(t > 0 ? se * p.beta + p.one_minus_beta * xp : xp, p.energy_floor);
    cf e = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < R; ++r) e = cfma(v[r], row[r], e);
    e.r = pair_sum(e.r);
    e.i = pair_sum(e.i);
    const float alpha = lms_div(gamma, sn);
    const float leak = alpha * p.reg_param;
    const cf ea = {e.r * alpha, e.i * alpha};
    // -waH_new = v - leak v - alpha e conj(Z)
    cf vn[R];
    float nrm = 0.f;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const cf z = row[r];
      vn[r] = {__fmaf_rn(-ea.i, z.i, __fmaf_rn(-ea.r, z.r, __fmaf_rn(-leak, v[r].r, v[r].r))),
               __fmaf_rn(ea.r, z.i, __fmaf_rn(-ea.i, z.r, __fmaf_rn(-leak, v[r].i, v[r].i)))};
      const float n2 = cabs2(vn[r]);
      nrm += r == 0 && yc ? 0.f : n2;
    }
    nrm = pair_sum(nrm);
    if (nrm > p.max_wa_l2norm) {
      const float scale = sqrtf(lms_div(p.max_wa_l2norm, nrm));
#pragma unroll
      for (int r = 0; r < R; ++r) vn[r] = cscale(vn[r], scale);
    }
    if (yc) vn[0] = {1.f, 0.f};
    if (gate) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = vn[r];
      se = sn;
    }
    // probe: update done

    // the output on the committed weights, Re summed in lane 0, Im in lane 1
    cf y = {0.f, 0.f};
    if (t >= p.min_frames) {
#pragma unroll
      for (int r = 0; r < R; ++r) y = cfma(v[r], row[r], y);
    } else if (yc) {
      y = row[0];
    }
    float val = (h ? y.i : y.r) + __shfl_xor_sync(0xffffffffu, h ? y.r : y.i, 1);
    if (t > p.pf_min_frames) val *= Wz;
    if (store) *o = val;
    o += (size_t)B * M;
    // probe: stored
  }
  // probe: kernel end
}

// args_ok, and a frame's offsets in int
bool lms_args_ok(int Tf, int B, int C, int Bc, int M) {
  return args_ok(Tf, B, C, Bc, M) && (long long)B * C * M <= 0x7fffffffLL;
}

template <int C, int ZM>
int lms_launch(const float* Yp, const float* gates, const float* wq, const float* bm,
               const float* ta, float* out, int Tf, int B, int M, bool per_utt,
               const LmsParams& p, cudaStream_t stream) {
  const size_t bytes = lms_smem_bytes(C);
  cudaError_t err = cudaFuncSetAttribute(gsc_lms_zelinski_kernel<C, ZM>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  gsc_lms_zelinski_kernel<C, ZM><<<lms_blocks(B, M), LMS_THREADS, bytes, stream>>>(
      Yp, gates, wq, bm, ta, out, Tf, B, M, per_utt, p);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int lms_launch_mode(int zm, const float* Yp, const float* gates, const float* wq,
                    const float* bm, const float* ta, float* out, int Tf, int B, int M,
                    bool per_utt, const LmsParams& p, cudaStream_t stream) {
  return zm == ZEL_REAL
             ? lms_launch<C, ZEL_REAL>(Yp, gates, wq, bm, ta, out, Tf, B, M, per_utt, p, stream)
             : lms_launch<C, ZEL_ABS>(Yp, gates, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
}

int lms_scan(const float* Yp, const float* gates, const float* wq, const float* bm,
             const float* ta, float* out, int Tf, int B, int C, int Bc, int M, bool per_utt,
             float beta, float one_minus_beta, float gamma, float delta, float reg_param,
             float energy_floor, float max_wa_l2norm, int min_frames, int slowdown_after,
             float pf_alpha, float one_minus_pf_alpha, float pf_gain, float spectral_floor,
             int real_mode, int pf_min_frames, cudaStream_t stream) {
  if (const int code = dsr_gsc_lms_zelinski_args_ok(Tf, B, C, Bc, M, slowdown_after))
    return code;
  const LmsParams p = {beta,           one_minus_beta, gamma,      delta,
                       reg_param,      energy_floor,   max_wa_l2norm,
                       min_frames,     slowdown_after, pf_alpha,   one_minus_pf_alpha,
                       pf_gain,        spectral_floor, pf_min_frames};
  const int zm = real_mode ? ZEL_REAL : ZEL_ABS;
  switch (C) {
#define DSR_CASE(c) \
  case c: return lms_launch_mode<c>(zm, Yp, gates, wq, bm, ta, out, Tf, B, M, per_utt, p, stream);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

// the kernel's registers and local memory (spills) in Zelinski mode ZM, and
// the blocks an SM holds with its shared memory
template <int C, int ZM>
int lms_shape(int* regs, int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, gsc_lms_zelinski_kernel<C, ZM>);
  const size_t bytes = lms_smem_bytes(C);
  if (err == cudaSuccess) {
    *regs = a.numRegs;
    *local_bytes = (int)a.localSizeBytes;
    err = cudaFuncSetAttribute(gsc_lms_zelinski_kernel<C, ZM>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  }
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, gsc_lms_zelinski_kernel<C, ZM>, LMS_THREADS, bytes);
  return static_cast<int>(err);
}

template <int C>
int lms_shape_mode(int zm, int* regs, int* local_bytes, int* blocks_per_sm) {
  return zm == ZEL_REAL ? lms_shape<C, ZEL_REAL>(regs, local_bytes, blocks_per_sm)
                        : lms_shape<C, ZEL_ABS>(regs, local_bytes, blocks_per_sm);
}

}  // namespace

extern "C" int dsr_lms_gates(const float* Yp, float* gates, int Tf, int B, int C, int M,
                             float beta, float one_minus_beta, float delta, float sil_thresh,
                             cudaStream_t stream) {
  if (!lms_args_ok(Tf, B, C, C - 1, M)) return DSR_ERR_ARGS;
  return lms_gate_pass(Yp, gates, Tf, B, C, M, beta, one_minus_beta, delta, sil_thresh, stream);
}

extern "C" int dsr_gsc_lms_zelinski_args_ok(int Tf, int B, int C, int Bc, int M,
                                            int slowdown_after) {
  return lms_args_ok(Tf, B, C, Bc, M) && slowdown_after >= 1 ? 0 : DSR_ERR_ARGS;
}

extern "C" int dsr_gsc_lms_zelinski(const float* Yp, const float* gates, const float* wq,
                                    const float* bm, const float* ta, float* out, int Tf, int B,
                                    int C, int Bc, int M, float beta, float one_minus_beta,
                                    float gamma, float delta, float reg_param,
                                    float energy_floor, float max_wa_l2norm, int min_frames,
                                    int slowdown_after, float pf_alpha,
                                    float one_minus_pf_alpha, float pf_gain,
                                    float spectral_floor, int real_mode, int pf_min_frames,
                                    cudaStream_t stream) {
  return lms_scan(Yp, gates, wq, bm, ta, out, Tf, B, C, Bc, M, false, beta, one_minus_beta,
                  gamma, delta, reg_param, energy_floor, max_wa_l2norm, min_frames,
                  slowdown_after, pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor,
                  real_mode, pf_min_frames, stream);
}

extern "C" int dsr_gsc_lms_zelinski_steered(
    const float* Yp, const float* gates, const float* wq, const float* bm, const float* ta,
    float* out, int Tf, int B, int C, int Bc, int M, float beta, float one_minus_beta,
    float gamma, float delta, float reg_param, float energy_floor, float max_wa_l2norm,
    int min_frames, int slowdown_after, float pf_alpha, float one_minus_pf_alpha, float pf_gain,
    float spectral_floor, int real_mode, int pf_min_frames, cudaStream_t stream) {
  return lms_scan(Yp, gates, wq, bm, ta, out, Tf, B, C, Bc, M, true, beta, one_minus_beta,
                  gamma, delta, reg_param, energy_floor, max_wa_l2norm, min_frames,
                  slowdown_after, pf_alpha, one_minus_pf_alpha, pf_gain, spectral_floor,
                  real_mode, pf_min_frames, stream);
}

extern "C" int dsr_gsc_lms_zelinski_shape(int B, int C, int M, int zmode, int* lanes, int* blocks,
                                          int* threads, int* frames, int* smem_bytes, int* regs,
                                          int* local_bytes, int* blocks_per_sm) {
  if (!lms_args_ok(1, B, C, C - 1, M) || (zmode != ZEL_REAL && zmode != ZEL_ABS))
    return DSR_ERR_ARGS;
  *lanes = LMS_LANES;
  *blocks = lms_blocks(B, M);
  *threads = LMS_THREADS;
  *frames = LMS_RING;
  *smem_bytes = (int)lms_smem_bytes(C);
  switch (C) {
#define DSR_CASE(c) \
  case c: return lms_shape_mode<c>(zmode, regs, local_bytes, blocks_per_sm);
    DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}
