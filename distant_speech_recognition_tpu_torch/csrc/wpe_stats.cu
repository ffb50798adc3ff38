// WPE normal-equation statistics for one EM iteration.
//
// Replaces the Pallas TPU kernel ops/pallas_wpe.py wpe_stats_pallas /
// wpe_stats_from_planes (_make_kernel in mode "stats", _call) of
// distant_speech_recognition_tpu, and computes what one EM iteration of
// models/dereverberation.wpe_estimate accumulates, per (utterance b, bin f):
//   lags      L_t[j] = y_a[t - lowerN - dp],  j = a*P + dp   (zero before t = 0)
//   residual  e_c[t] = y_c[t] - conj(G[c, :]) . L_t          (has_g; else y_c[t])
//   weights   w_c[t] = 1 / max(|e_c[t]|, 1e-3)^2  for lowerN <= t < Tf, else 0
//   R[c,p,q]  = sum_t w_c[t] L_t[p] conj(L_t[q])
//   r[c,p]    = sum_t w_c[t] L_t[p] conj(y_c[t])
// from the packed frames Yp [Tf, B, C, M] ([Re(0..M/2) | Im(1..M/2-1)] lanes)
// and G [B, C, F, CP] (complex, CP = C*P), into R [B, C, F, CP, CP] (both
// triangles) and r [B, C, F, CP], complex.
//
// What bounds it on an H100: the accumulation, C * CP(CP+1)/2 complex
// multiply-adds per (utterance, bin, frame): about 3.3e11 FP32 flops per call
// at B=256 x 4 ch x 10 s with P=5, ~5 ms at the 67 TFLOP/s FP32 peak, against
// 1.3 GB of input (0.4 ms): it is bound by FP32 arithmetic.  At 8 channels
// (CP = 40, BASELINE config 4's default taps) the accumulation grows to
// ~2.2e12 flops a call, ~33 ms.  The JAX package runs it at HIGHEST
// precision, so no TF32.
//
// Design.  A block takes FB consecutive systems (utterance, bin) of the
// flattened B*F (so no bin group idles at the top of an utterance) and walks
// all their frames in chunks of TC.  Each thread holds a 4x4 tile of the upper
// triangle of one target's R in registers (the threads of a diagonal tile,
// which need only 10 of its 16 entries, take the 4 entries of r for the same
// rows) and reads its lags from shared memory: one 8-byte load feeds four
// complex multiply-adds, and tap slots past C*P read a channel of zeros.
//   - The chunks pass through a ring of NSTAGE buffers filled by cp.async
//     (4-byte copies: the ring interleaves Re and Im, which the packed rows
//     keep apart, and zero-fills the history before t = 0 and the missing Im
//     lanes), started two chunks ahead, so staging never waits on memory.
//   - A chunk is stored frame-fastest ([channel][system][frame], rows padded
//     to an odd length so that the eight systems of a warp fall in distinct
//     banks): a thread's nine lag, target and weight addresses all advance by
//     one element a frame, and the accumulation, unrolled by U frames, loads
//     at immediate offsets with no address arithmetic.
//   - Every warp weighs its share of chunk k+1 before it accumulates chunk
//     k, with no barrier between the two, so a warp that is done weighing
//     accumulates while others still weigh.
// Sums run in frame order in FP32, one FMA per real product (written out, so
// that nvcc does not split them into a multiply and an add), IEEE division
// and sqrtf; every block walks all frames of its systems, so the result is
// deterministic.  Frames past the end of the last chunk, up to a multiple of
// U, carry weight 0 and add exact zeros.
//
// The residual that sets the weights is computed in FP64 (from the FP32
// inputs, rounded to FP32 at the end): where a prediction cancels its target
// to a fraction of a percent (|e| ~ 1e-3 |y| with terms ~500 |y|, seen on the
// chain's own frames), 1/|e|^2 carries the prediction's rounding amplified
// by |pred terms|/|e|, and two FP32 evaluations of one EM iteration's R then
// differ by ~0.3% of max|R|.  In FP64 the weights are those of the inputs to
// FP32 precision.  The prediction of a system's C targets over 8 frames is a
// real product [2C x 2 C*P] x [2 C*P x 8], which the FP64 tensor cores take
// as mma.m8n8k4 steps (each chunk's lags converted to FP64 once, conj(G) held
// in shared memory as the real matrix): on the FP64 pipe of the CUDA cores,
// with their conversions, the same products took a quarter of the block.
#include <type_traits>

#include "dsr_kernels.h"

namespace {

constexpr int TC = 64;       // frames per chunk
constexpr int TCP = TC + 1;  // padded frames of a weight row
constexpr int U = 8;         // frames of one step of the accumulation
constexpr int NSTAGE = 3;    // chunks in the ring
constexpr int TILE = 4;      // rows and columns of a thread's tile
constexpr int IB = 4;        // weight items a thread runs side by side (no filters)
constexpr int MAX_THREADS = 512;
constexpr size_t MAX_SMEM = 227 * 1024;  // dynamic shared memory of a block
constexpr int MAX_FB = 8;    // systems per block
constexpr float SUBBAND_FLOOR = 1.0e-3f;  // dereverberation.cc:144

struct cf {
  float r, i;
};

// Per tap slot j (lag j = a*P + dp): the offset a*FB*ROWS + S - lowerN - dp
// of its frame-0 element in a staged chunk and in its FP64 copy (slots past
// C*P read the zero channel C of the staged chunk).  Up to six tiles a side
// (C*P <= 24) the argument keeps the size it had before the wider tiles
// were added; seven to ten tiles (C*P <= 40) take the longer one.
template <int NJ>
struct LagSlots {
  int lag[NJ];
};
template <int NT>
using Lags = LagSlots<(NT <= 6 ? 6 : 10) * TILE>;

// acc += a * conj(b), one FMA per real product
__device__ __forceinline__ void cmac_conj(cf& acc, cf a, cf b) {
  acc.r = fmaf(a.r, b.r, acc.r);
  acc.r = fmaf(a.i, b.i, acc.r);
  acc.i = fmaf(a.i, b.r, acc.i);
  acc.i = fmaf(-a.r, b.i, acc.i);
}

// 4-byte asynchronous copy global -> shared, zero-filled when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ float weight(float er, float ei) {
  const float th = fmaxf(sqrtf(er * er + ei * ei), SUBBAND_FLOOR);
  return 1.f / (th * th);
}

// NT: tiles along a side of R, NJ = NT * TILE >= C*P tap slots
template <int NT>
__global__ void __launch_bounds__(MAX_THREADS)
wpe_stats_kernel(const float* __restrict__ Yp, const cf* __restrict__ G, cf* __restrict__ R,
                 cf* __restrict__ r, int Tf, int B, int C, int M, int P, int lowerN, int has_g,
                 int FB, const Lags<NT> lags) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int NJ = NT * TILE;
  constexpr int NTILES = NT * (NT + 1) / 2;
  constexpr int KA = 2 * NJ + 2;             // a row of the residual's real matrix, padded
  const int F = M / 2 + 1;
  const int CP = C * P;
  const int S = lowerN + P - 1;              // deepest lag
  const int ROWS = (TC + S) | 1;             // staged frames of a lane, odd
  const int CF = C * FB;
  const int STAGE = (C + 1) * FB * ROWS;     // cf of one chunk, zero channel included
  const int nsys = B * F;
  const int sys0 = blockIdx.x * FB;
  const int nchunks = (Tf + TC - 1) / TC;
  const size_t frame_stride = (size_t)B * C * M;
  const int tid = threadIdx.x;
  const int nthr = blockDim.x;
  const int MT = (2 * C + 7) / 8;             // 8-row tiles of the residual's rows
  // regions of 16-byte multiples
  cf* Ys = reinterpret_cast<cf*>(smem);                                   // [NSTAGE][C + 1][FB][ROWS]
  float* Ws = reinterpret_cast<float*>(Ys + (NSTAGE * STAGE + 1) / 2 * 2);  // [2][C][FB][TCP]
  double2* Yd = reinterpret_cast<double2*>(Ws + (2 * CF * TCP + 3) / 4 * 4);  // [C][FB][ROWS]
  double* Ad = reinterpret_cast<double*>(Yd + CF * ROWS);                // [FB][MT * 8][KA]

  for (int idx = tid; idx < NSTAGE * STAGE; idx += nthr) Ys[idx] = cf{0.f, 0.f};
  if (has_g) {
    // the residual's prediction as a real product: row (c, Re | Im) of A
    // times column (tap j, Re | Im) of the lags, A = [[Re g, -Im g], [Im g,
    // Re g]] per tap with g = conj(G[c, j])
    for (int idx = tid; idx < FB * MT * 8 * KA; idx += nthr) {
      const int k = idx % KA, row = (idx / KA) % (MT * 8), ff = idx / (KA * MT * 8);
      const int c = row >> 1, j = k >> 1, sys = sys0 + ff;
      double v = 0.0;
      if (c < C && j < CP && sys < nsys) {
        const int b = sys / F, fg = sys - (sys / F) * F;
        const cf g = G[(((size_t)b * C + c) * F + fg) * CP + j];
        const double gr = g.r, gi = -(double)g.i;
        v = (row & 1) == 0 ? ((k & 1) == 0 ? gr : -gi) : ((k & 1) == 0 ? gi : gr);
      }
      Ad[idx] = v;
    }
  }
  __syncthreads();
  // probe: set-up done

  // staging: thread tid < nlanes * nrow copies element e = (channel a,
  // system ff, Re or Im) of rows row0, row0 + nrow, ... of each chunk
  const int nrow = nthr / (2 * CF);
  const int e = tid % (2 * CF), row0 = tid / (2 * CF);
  const int part = e & 1, eff = (e >> 1) % FB, ea = (e >> 1) / FB;
  const float* esrc = Yp;
  bool elane = false;
  {
    const int sys = sys0 + eff;
    const int b = sys / F, fg = sys - (sys / F) * F;
    elane = row0 < nrow && sys < nsys && (part == 0 || (fg >= 1 && fg <= F - 2));
    if (elane) esrc = Yp + ((size_t)b * C + ea) * M + (part ? F - 1 + fg : fg);
  }
  auto fetch = [&](int k) {  // chunk k's rows into stage k % NSTAGE
    if (row0 < nrow && k < nchunks) {
      const int t0 = k * TC;
      const int rows = min(TC, Tf - t0) + S;
      float* dst = reinterpret_cast<float*>(Ys + (k % NSTAGE) * STAGE + (ea * FB + eff) * ROWS) +
                   part;
      for (int tt = row0; tt < rows; tt += nrow) {
        const int t = t0 - S + tt;
        const bool ok = elane && t >= 0;
        cp_async4(dst + 2 * tt, ok ? esrc + (size_t)t * frame_stride : Yp, ok);
      }
    }
    cp_commit();
  };

  // this thread's tile (ti, tj), ti <= tj, of target c and system sys0 + f
  const int f = tid % FB;
  const int c = (tid / FB) % C;
  const int tile = tid / CF;
  const bool active = tile < NTILES;
  int ti = 0, tj = 0;
  {
    int k = active ? tile : 0;
    while (k >= NT - ti) {
      k -= NT - ti;
      ++ti;
    }
    tj = ti + k;
  }
  const bool diag = ti == tj;

  // weights of chunk k without filters (frames tile, tile + NTILES, ... of
  // target c, system f) into weight buffer k % 2, from stage k % NSTAGE
  auto weigh = [&](int k) {
    if (!active) return;
    const int t0 = k * TC;
    const int nt = min(TC, Tf - t0);
    const int ntp = (nt + U - 1) / U * U;
    const cf* Yc = Ys + (k % NSTAGE) * STAGE + (c * FB + f) * ROWS + S;  // y_c of frame 0
    float* Wc = Ws + (k % 2) * CF * TCP + (c * FB + f) * TCP;
    for (int tb = tile; tb < ntp; tb += IB * NTILES) {
#pragma unroll
      for (int i = 0; i < IB; ++i) {
        const int tt = tb + i * NTILES;
        if (tt < ntp) {
          const cf y = Yc[tt];
          Wc[tt] = tt < nt && t0 + tt >= lowerN ? weight(y.r, y.i) : 0.f;
        }
      }
    }
  };
  // the same with filters: a warp takes one (system, 8 rows of residual,
  // 8 frames) unit at a time and forms its prediction with FP64 tensor-core
  // products (exact products of the FP32 inputs, FP64 sums: see the note on
  // the residual at the top)
  auto weigh_fp64 = [&](int k) {
    const int t0 = k * TC;
    const int nt = min(TC, Tf - t0);
    const int ntp = (nt + U - 1) / U * U;
    const int lane = tid & 31, warp = tid >> 5, nwarps = nthr >> 5;
    const int units = FB * MT * ((ntp + 7) / 8);
    const double* Ydd = reinterpret_cast<const double*>(Yd);
    for (int unit = warp; unit < units; unit += nwarps) {
      const int ff = unit % FB, m = (unit / FB) % MT, n0 = unit / (FB * MT) * 8;
      // A[row][k] at lane (row = lane / 4, k = lane % 4) of each k-step,
      // B[k][n] at (k = lane % 4, n = lane / 4): tap 2 kk + (lane / 2) % 2,
      // Re or Im by lane % 2, frame n0 + lane / 4
      const double* Ar = Ad + (ff * MT * 8 + m * 8 + (lane >> 2)) * KA + (lane & 3);
      const double* Bl = Ydd + 2 * (ff * ROWS + n0 + (lane >> 2)) + (lane & 1);
      double d0 = 0.0, d1 = 0.0;
#pragma unroll
      for (int kk = 0; kk < NJ / 2; ++kk) {
        const bool hi = (lane & 2) != 0;
        const int j = 2 * kk + (hi ? 1 : 0);
        const double a = Ar[4 * kk];
        const double b = j < CP ? Bl[2 * (hi ? lags.lag[2 * kk + 1] : lags.lag[2 * kk])] : 0.0;
        asm volatile("mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};"
                     : "+d"(d0), "+d"(d1)
                     : "d"(a), "d"(b));
      }
      // D[row][n] at (row = lane / 4, n = 2 (lane % 4) + {0, 1}); rows 2c and
      // 2c + 1 hold Re and Im of target c: lanes 4 apart swap halves, and
      // each takes one of the two frames
      const double o0 = __shfl_xor_sync(0xffffffffu, d0, 4);
      const double o1 = __shfl_xor_sync(0xffffffffu, d1, 4);
      const int row = lane >> 2, part = row & 1;
      const int cw = m * 4 + (row >> 1);
      const int tt = n0 + 2 * (lane & 3) + part;
      const double pr = part ? o1 : d0, pim = part ? d1 : o0;
      if (cw < C && tt < ntp) {
        const cf y = Ys[(k % NSTAGE) * STAGE + (cw * FB + ff) * ROWS + S + tt];
        Ws[(k % 2) * CF * TCP + (cw * FB + ff) * TCP + tt] =
            tt < nt && t0 + tt >= lowerN
                ? weight((float)((double)y.r - pr), (float)((double)y.i - pim))
                : 0.f;
      }
    }
  };
  // chunk k's rows (stage k % NSTAGE) in FP64, for its weights
  auto widen = [&](int k) {
    const cf* Yc = Ys + (k % NSTAGE) * STAGE;
    const int rows = min(TC, Tf - k * TC) + S;
    for (int idx = tid; idx < CF * rows; idx += nthr) {
      const int lane = idx / rows, tt = idx - lane * rows;
      const cf v = Yc[lane * ROWS + tt];
      Yd[lane * ROWS + tt] = make_double2(v.r, v.i);
    }
  };

  cf acc[TILE][TILE], racc[TILE];
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    racc[u] = {0.f, 0.f};
#pragma unroll
    for (int v = 0; v < TILE; ++v) acc[u][v] = {0.f, 0.f};
  }
  // frame-0 offsets of this thread's lags (rows p and q of its tile), its
  // target y_c and its weight, within a stage / weight buffer
  int offp[TILE], offq[TILE];
#pragma unroll
  for (int u = 0; u < TILE; ++u) {
    offp[u] = lags.lag[0];
    offq[u] = lags.lag[0];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j == ti * TILE + u) offp[u] = lags.lag[j];
      if (j == tj * TILE + u) offq[u] = lags.lag[j];
    }
    offp[u] += f * ROWS;
    offq[u] += f * ROWS;
  }
  const int offy = (c * FB + f) * ROWS + S;
  const int offw = (c * FB + f) * TCP;

  // chunk k into this thread's tile; DIAG: a diagonal tile, which also
  // takes r's rows
  auto accumulate = [&](int k, auto diag_tile) {
    constexpr bool DIAG = decltype(diag_tile)::value;
    const int ntp = (min(TC, Tf - k * TC) + U - 1) / U * U;
    const cf* Yc = Ys + (k % NSTAGE) * STAGE;
    const cf* Pp[TILE];
    const cf* Pq[TILE];
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      Pp[u] = Yc + offp[u];
      Pq[u] = Yc + offq[u];
    }
    const cf* Py = Yc + offy;
    const float* Pw = Ws + (k % 2) * CF * TCP + offw;
    for (int tt = 0; tt < ntp; tt += U) {
#pragma unroll
      for (int s = 0; s < U; ++s) {
        const float w = Pw[s];
        cf lp[TILE], lq[TILE];
#pragma unroll
        for (int u = 0; u < TILE; ++u) {
          const cf zp = Pp[u][s];
          lp[u] = cf{w * zp.r, w * zp.i};
          lq[u] = Pq[u][s];
        }
        if constexpr (DIAG) {
          const cf y = Py[s];
#pragma unroll
          for (int u = 0; u < TILE; ++u) {
            cmac_conj(racc[u], lp[u], y);
#pragma unroll
            for (int v = u; v < TILE; ++v) cmac_conj(acc[u][v], lp[u], lq[v]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < TILE; ++u)
#pragma unroll
            for (int v = 0; v < TILE; ++v) cmac_conj(acc[u][v], lp[u], lq[v]);
        }
      }
#pragma unroll
      for (int u = 0; u < TILE; ++u) {
        Pp[u] += U;
        Pq[u] += U;
      }
      Py += U;
      Pw += U;
    }
  };

  fetch(0);
  fetch(1);
  cp_wait<1>();
  __syncthreads();
  if (has_g) {
    widen(0);
    __syncthreads();
  }
  has_g ? weigh_fp64(0) : weigh(0);
  // probe: prologue done
  for (int k = 0; k < nchunks; ++k) {
    cp_wait<0>();     // this thread's copies of chunk k + 1
    __syncthreads();  // everyone's; chunk k weighed; chunk k - 1 consumed
    // probe: waited for chunk k + 1
    fetch(k + 2);
    // probe: fetching chunk k + 2
    if (has_g && k + 1 < nchunks) widen(k + 1);
    if (has_g) __syncthreads();
    // probe: widened chunk k + 1
    if (k + 1 < nchunks) has_g ? weigh_fp64(k + 1) : weigh(k + 1);
    // probe: weighed chunk k + 1
    // the tile's type is decided once a chunk, so that the unrolled frames
    // have no branch between them and the loads of one frame can start
    // while the previous one's products issue
    if (active) diag ? accumulate(k, std::true_type{}) : accumulate(k, std::false_type{});
    // probe: accumulated chunk k
  }

  const int sys = sys0 + f;
  if (active && sys < nsys) {
    const int b = sys / F, fg = sys - (sys / F) * F;
    const size_t id = ((size_t)b * C + c) * F + fg;
    cf* Rs = R + id * CP * CP;
#pragma unroll
    for (int u = 0; u < TILE; ++u) {
      const int p = ti * TILE + u;
      if (p >= CP) continue;
#pragma unroll
      for (int v = 0; v < TILE; ++v) {
        const int q = tj * TILE + v;
        if (q >= CP || (diag && v < u)) continue;
        Rs[p * CP + q] = acc[u][v];
        if (q != p) Rs[q * CP + p] = cf{acc[u][v].r, -acc[u][v].i};
      }
      if (diag) r[id * CP + p] = racc[u];
    }
  }
  // probe: kernel end
}

template <int NT>
struct Launch {
  static size_t smem(int C, int P, int lowerN, int FB, int has_g) {
    const size_t S = lowerN + P - 1, ROWS = (TC + S) | 1;
    const size_t CF = (size_t)C * FB, MT = (2 * C + 7) / 8, KA = 2 * NT * TILE + 2;
    return sizeof(cf) * ((NSTAGE * (C + 1) * FB * ROWS + 1) / 2 * 2) +
           sizeof(float) * ((2 * CF * TCP + 3) / 4 * 4) +
           (has_g ? sizeof(double2) * CF * ROWS + sizeof(double) * FB * MT * 8 * KA : 0);
  }
  // the tiles' threads, and at least one a staged element of a frame
  static int threads(int C, int FB) {
    return (max(NT * (NT + 1) / 2, 2) * C * FB + 31) / 32 * 32;
  }
  // systems per block: up to MAX_FB, as many as the threads and the shared
  // memory allow
  static int systems(int C, int P, int lowerN, int has_g) {
    int FB = MAX_FB;
    while (FB > 1 && (threads(C, FB) > MAX_THREADS || smem(C, P, lowerN, FB, has_g) > MAX_SMEM))
      FB /= 2;
    return threads(C, FB) <= MAX_THREADS && smem(C, P, lowerN, FB, has_g) <= MAX_SMEM ? FB : 0;
  }
  static cudaError_t prepare(size_t bytes) {
    return cudaFuncSetAttribute(wpe_stats_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)bytes);
  }
  static int run(const float* Yp, const float* G, float* R, float* r, int Tf, int B, int C, int M,
                 int P, int lowerN, int has_g, cudaStream_t stream) {
    const int FB = systems(C, P, lowerN, has_g);
    if (FB == 0) return DSR_ERR_ARGS;
    const size_t bytes = smem(C, P, lowerN, FB, has_g);
    cudaError_t err = prepare(bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    const int CP = C * P, S = lowerN + P - 1;
    const int ROWS = (TC + S) | 1;
    Lags<NT> lags;
    for (int j = 0; j < NT * TILE; ++j) {
      // tap slots past CP read the zero channel C
      const int a = j < CP ? j / P : C, dp = j < CP ? j - (j / P) * P : 0;
      lags.lag[j] = a * FB * ROWS + S - lowerN - dp;
    }
    const int F = M / 2 + 1;
    const unsigned blocks = (unsigned)(((size_t)B * F + FB - 1) / FB);
    wpe_stats_kernel<NT><<<blocks, threads(C, FB), bytes, stream>>>(
        Yp, reinterpret_cast<const cf*>(G), reinterpret_cast<cf*>(R), reinterpret_cast<cf*>(r),
        Tf, B, C, M, P, lowerN, has_g, FB, lags);
    return static_cast<int>(cudaGetLastError());
  }
  static int occupancy(int C, int P, int lowerN, int* blocks, int* smem_bytes, int* nthreads) {
    const int FB = systems(C, P, lowerN, 1);
    if (FB == 0) return DSR_ERR_ARGS;
    const size_t bytes = smem(C, P, lowerN, FB, 1);
    *smem_bytes = (int)bytes;
    *nthreads = threads(C, FB);
    cudaError_t err = prepare(bytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, wpe_stats_kernel<NT>, *nthreads,
                                                          bytes);
    return static_cast<int>(err);
  }
};

#define DSR_TILES(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

bool args_ok(int Tf, int B, int C, int M, int P, int lowerN) {
  return Tf > 0 && B > 0 && C > 0 && C <= 8 && P > 0 && lowerN >= 0 && M >= 4 && M % 2 == 0 &&
         C * P <= 10 * TILE && (long long)B * (M / 2 + 1) <= 0x7fffffffLL;
}

}  // namespace

extern "C" int dsr_wpe_stats(const float* Yp, const float* G, float* R, float* r, int Tf, int B,
                             int C, int M, int P, int lowerN, int has_g, cudaStream_t stream) {
  if (!args_ok(Tf, B, C, M, P, lowerN)) return DSR_ERR_ARGS;
  switch ((C * P + TILE - 1) / TILE) {
#define DSR_CASE(n) \
    case n: return Launch<n>::run(Yp, G, R, r, Tf, B, C, M, P, lowerN, has_g, stream);
    DSR_TILES(DSR_CASE)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

extern "C" int dsr_wpe_stats_occupancy(int C, int P, int lowerN, int* blocks_per_sm,
                                       int* smem_bytes, int* threads) {
  if (!args_ok(1, 1, C, 256, P, lowerN)) return DSR_ERR_ARGS;
  switch ((C * P + TILE - 1) / TILE) {
#define DSR_CASE(n) \
    case n: return Launch<n>::occupancy(C, P, lowerN, blocks_per_sm, smem_bytes, threads);
    DSR_TILES(DSR_CASE)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}
