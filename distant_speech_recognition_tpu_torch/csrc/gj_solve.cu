// Batched complex Gauss-Jordan solve R x = r, no row swaps.
//
// Replaces the Pallas TPU kernel ops/pallas_wpe.py gj_solve_pallas
// (_make_gj_kernel) of distant_speech_recognition_tpu, and computes what
// models/dereverberation._gj_solve computes on the augmented matrix
// [R | r]: for k = 0..n-1, q = row_k conj(A_kk) / |A_kk|^2 (the divisor
// taken as 1 where it is 0, as the Pallas kernel does; on the diagonally
// loaded Hermitian positive-definite systems WPE builds it never is), every
// other row i -= A_ik q, row_k = q; x is the last column.
// R [N, n, n] and r [N, n] complex (row-major), x [N, n] complex.
//
// What bounds it on an H100: each system is read once and its solution
// written once (0.46 GB for 132,096 systems of n=20, 0.14 ms at 3.35 TB/s)
// for about 8 n^2 (n+1) flops, so memory and instruction throughput are of
// the same order.  Design:
//   - One warp a system, lane i holding row i of [R | r] in registers; the
//     row width NW (4, 8, ..., 24, and 32 for n <= 31) is compiled in, so
//     every loop is unrolled with static register indices and the only
//     runtime test is one uniform `k < n` a pivot step.
//   - At step k the pivot lane writes its row to shared memory, lane l
//     forms the quotient of column k + 1 + l, and every lane reads the
//     quotients back (broadcasts) and updates its row with its own factor
//     A_ik: two __syncwarp a step, no shuffle.  Only the columns right of
//     the pivot are computed: the columns left of it never reach x.
//   - The quotients share one reciprocal of |A_kk|^2 a step and run
//     branch-free with the IEEE bits (FastDivOps, dsr_device.h: the
//     instructions of an IEEE division's fast path, without its range check
//     and branch); a quotient it cannot vouch for is redone with the IEEE
//     operators.
//   - Each warp walks its systems (one every gridDim.x * WARPS) on its own,
//     with no block barrier: the next system's R and r are staged into the
//     warp's second shared-memory slot by cp.async copies (16 bytes at even
//     n, 8 at odd) while it solves the current one; x leaves as one
//     coalesced row a system.
// The arithmetic is the first design's (a lane per column, factors by
// shuffle), operation for operation, so x has the same bits.
//
// Systems of n = 32 .. 40 (C*P = 40 is BASELINE config 4 at 8 channels)
// have more rows than a warp has lanes.  They run in a kernel of their own
// (gj_solve_wide_kernel; the kernel above is left as it was, so n <= 31
// keeps its bits): lane l holds row l whole, as above, and rows 32 .. 39 are
// each split across four lanes by columns, cyclically (lane l holds columns
// 4m + l % 4 of row 32 + l / 4, and that row's right-hand side).  Why this
// split and not another:
//   - two rows a lane (rows 32..39 on lanes 0..7) would hold 164 floats a
//     lane at the first step and leave lanes 8..31 idle for half of every
//     update: a warp issues the instructions of two rows either way;
//   - two warps a system, one row a lane, would leave 24 of 64 lanes idle
//     and need two named barriers a step;
//   - the cyclic split gives every lane 1.25 rows of work at every step
//     (the columns right of the pivot stay spread over the four lanes), at
//     104 floats of rows a lane, for one pair of shuffles a step (the
//     split row's factor, from the lane holding column k).
// Each entry goes through the same operations, in the same order, as in the
// kernel above.  The wide systems need 13 KB of shared memory each, so a
// warp stages one: it loads its rows into registers, and only then stages
// the next system into the same slot, which arrives while it eliminates.
#include "dsr_device.h"
#include "dsr_kernels.h"

namespace {

using dsr::cf;
using dsr::FastDivOps;
using dsr::IeeeOps;

constexpr int MAXN = 31;   // the kernel of one row a lane
constexpr int WIDE_MAXN = 40;  // the wide kernel's rows
constexpr int WARPS = 4;  // warps a block, each solving systems of its own
constexpr int THREADS = 32 * WARPS;
// blocks an SM each width is compiled for (registers: 65536 / (128 x this));
// the elimination's chain of dependent steps needs warps to hide it
template <int NW>
constexpr int min_blocks() {
  return NW <= 20 ? 6 : NW <= 24 ? 5 : 4;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// The first design's arithmetic, with each contraction nvcc chose for it
// written out (its SASS: the first product of each sum fused): intrinsics
// are never contracted again, so the bits cannot depend on the context.
// |p|^2, the pivot's divisor before the zero guard
__device__ __forceinline__ float gj_den(cf p) {
  return __fmaf_rn(p.r, p.r, __fmul_rn(p.i, p.i));
}
// a conj(p), the quotient's dividends
__device__ __forceinline__ cf gj_num(cf a, cf p) {
  return {__fmaf_rn(a.r, p.r, __fmul_rn(a.i, p.i)), __fmaf_rn(a.i, p.r, -__fmul_rn(a.r, p.i))};
}
// v - f q, the update of an entry by its row's factor f and its column's q
__device__ __forceinline__ cf gj_update(cf v, cf f, cf q) {
  return {__fsub_rn(v.r, __fmaf_rn(f.r, q.r, -__fmul_rn(f.i, q.i))),
          __fsub_rn(v.i, __fmaf_rn(f.r, q.i, __fmul_rn(f.i, q.r)))};
}

template <class Ops>
__device__ __forceinline__ cf gj_quotient(cf a, cf p, Ops& op) {
  float den = gj_den(p);
  den = den > 0.f ? den : 1.f;
  const cf u = gj_num(a, p);
  const typename Ops::R rd = op.recip(den);
  return {op.div(u.r, rd), op.div(u.i, rd)};
}

// Row width NW: row i of [R | r] is row[0 .. n-1] and row[NW] (columns
// n .. NW-1 hold zeros and are computed but never read into x)
template <int NW>
__global__ void __launch_bounds__(THREADS, min_blocks<NW>())
gj_solve_kernel(const float* __restrict__ R, const float* __restrict__ r, cf* __restrict__ x,
                int N, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  // probe: kernel start
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sys_floats = 2 * n * (n + 1);  // [R | r] of one system
  // this warp's two system slots, then its pivot row and quotients
  float* slots = reinterpret_cast<float*>(smem) + warp * 2 * sys_floats;
  cf* rowbuf = reinterpret_cast<cf*>(reinterpret_cast<float*>(smem) + WARPS * 2 * sys_floats) +
               warp * 2 * (NW + 2);
  cf* qbuf = rowbuf + (NW + 2);
  const int gwarps = gridDim.x * WARPS;
  const bool even = (n & 1) == 0;  // rows and systems then start on 16 bytes

  auto fetch = [&](int s, float* dst) {  // system s into a slot: R, then r
    if (s < N) {
      const float* srcR = R + (long long)s * 2 * n * n;
      const float* srcr = r + (long long)s * 2 * n;
      if (even) {  // 16 bytes a copy
        for (int e = 4 * lane; e < 2 * n * n; e += 128) cp_async16(dst + e, srcR + e);
        for (int e = 4 * lane; e < 2 * n; e += 128) cp_async16(dst + 2 * n * n + e, srcr + e);
      } else {  // 8 bytes a copy
        for (int e = 2 * lane; e < 2 * n * n; e += 64) cp_async8(dst + e, srcR + e);
        for (int e = 2 * lane; e < 2 * n; e += 64) cp_async8(dst + 2 * n * n + e, srcr + e);
      }
    }
    cp_commit();
  };
  int s = blockIdx.x * WARPS + warp;
  fetch(s, slots);
  // probe: set-up done
  for (int i = 0; s < N; ++i, s += gwarps) {  // uniform over the warp
    const float* sys = slots + (i & 1) * sys_floats;
    // the next system into the other slot: every lane read its rows of the
    // system before that one several __syncwarp ago
    fetch(s + gwarps, slots + ((i + 1) & 1) * sys_floats);
    cp_wait<1>();
    __syncwarp();
    // probe: staged
    {
      cf row[NW + 1];
      const bool live = lane < n;
      const float* Rs = sys + 2 * lane * n;
      if (even) {
#pragma unroll
        for (int j = 0; j < NW; j += 2) {
          const float4 v = live && j < n ? *reinterpret_cast<const float4*>(Rs + 2 * j)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          row[j] = cf{v.x, v.y};
          row[j + 1] = cf{v.z, v.w};
        }
      } else {
#pragma unroll
        for (int j = 0; j < NW; ++j)
          row[j] = live && j < n ? reinterpret_cast<const cf*>(Rs)[j] : cf{0.f, 0.f};
      }
      row[NW] = live ? reinterpret_cast<const cf*>(sys + 2 * n * n)[lane] : cf{0.f, 0.f};
      // probe: loaded
#pragma unroll
      for (int k = 0; k < NW; ++k) {
        if (k >= n) break;  // uniform over the warp
        const bool piv = lane == k;
        // (the loops below run over constant bounds with tests of k, which
        // fold away once the loop over k is unrolled)
        if (piv) {  // the pivot row, columns k .. NW, in pairs from an even column
#pragma unroll
          for (int j = 0; j < NW; j += 2)
            if (j + 1 >= k)
              *reinterpret_cast<float4*>(rowbuf + j) = make_float4(row[j].r, row[j].i,
                                                                   row[j + 1].r, row[j + 1].i);
          rowbuf[NW] = row[NW];
        }
        __syncwarp();
        const int c = k + 1 + lane;
        if (c <= NW) {
          const cf p = rowbuf[k];
          const cf a = rowbuf[c];
          FastDivOps op;
          cf q = gj_quotient(a, p, op);
          if (!op.ok && (c < n || c == NW)) {  // the zero columns n .. NW-1 never reach x
            IeeeOps iv;
            q = gj_quotient(a, p, iv);
          }
          qbuf[c] = q;
        }
        __syncwarp();
        // probe: quotients
        const cf f = row[k];
        auto upd = [&](int j, cf q) { row[j] = piv ? q : gj_update(row[j], f, q); };
#pragma unroll
        for (int j = 0; j < NW; j += 2) {
          if (j > k) {
            const float4 v = *reinterpret_cast<const float4*>(qbuf + j);
            upd(j, cf{v.x, v.y});
            upd(j + 1, cf{v.z, v.w});
          } else if (j + 1 > k) {
            upd(j + 1, qbuf[j + 1]);
          }
        }
        upd(NW, qbuf[NW]);
        // probe: updated
      }
      if (live) x[(long long)s * n + lane] = row[NW];
      // probe: stored
    }
  }
  // probe: kernel end
}

// Row width of the wide kernel, the columns of its split rows' quarters,
// and its blocks an SM (registers: 65536 / (128 x this))
constexpr int NWW = WIDE_MAXN;
constexpr int QW = NWW / 4;
constexpr int WIDE_MIN_BLOCKS = 3;

// n = 32 .. 40: lane l holds row l (row[0 .. NWW-1], row[NWW] the
// right-hand side) and columns 4m + l % 4 of row 32 + l / 4 (rq[m], its
// right-hand side in rqr); rows and columns past n hold zeros
__global__ void __launch_bounds__(THREADS, WIDE_MIN_BLOCKS)
gj_solve_wide_kernel(const float* __restrict__ R, const float* __restrict__ r,
                     cf* __restrict__ x, int N, int n) {
  extern __shared__ __align__(16) unsigned char smem[];
  // probe (wide): kernel start
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int sub = lane & 3;        // this lane's quarter of its split row
  const int i2 = 32 + (lane >> 2);  // its split row
  const int sys_floats = 2 * n * (n + 1);  // [R | r] of one system (a multiple of 4)
  // this warp's system slot, then its pivot row and quotients
  float* slot = reinterpret_cast<float*>(smem) + warp * sys_floats;
  cf* rowbuf = reinterpret_cast<cf*>(reinterpret_cast<float*>(smem) + WARPS * sys_floats) +
               warp * 2 * (NWW + 2);
  cf* qbuf = rowbuf + (NWW + 2);
  const int gwarps = gridDim.x * WARPS;
  const bool even = (n & 1) == 0;  // rows and systems then start on 16 bytes

  auto fetch = [&](int s) {  // system s into the slot: R, then r
    if (s < N) {
      const float* srcR = R + (long long)s * 2 * n * n;
      const float* srcr = r + (long long)s * 2 * n;
      if (even) {  // 16 bytes a copy
        for (int e = 4 * lane; e < 2 * n * n; e += 128) cp_async16(slot + e, srcR + e);
        for (int e = 4 * lane; e < 2 * n; e += 128) cp_async16(slot + 2 * n * n + e, srcr + e);
      } else {  // 8 bytes a copy
        for (int e = 2 * lane; e < 2 * n * n; e += 64) cp_async8(slot + e, srcR + e);
        for (int e = 2 * lane; e < 2 * n; e += 64) cp_async8(slot + 2 * n * n + e, srcr + e);
      }
    }
    cp_commit();
  };
  int s = blockIdx.x * WARPS + warp;
  fetch(s);
  // probe (wide): set-up done
  for (; s < N; s += gwarps) {  // uniform over the warp
    cp_wait<0>();
    __syncwarp();
    // probe (wide): staged
    cf row[NWW + 1], rq[QW], rqr;
    {
      const bool live = lane < n;
      const float* Rs = slot + 2 * lane * n;
      if (even) {
#pragma unroll
        for (int j = 0; j < NWW; j += 2) {
          const float4 v = live && j < n ? *reinterpret_cast<const float4*>(Rs + 2 * j)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
          row[j] = cf{v.x, v.y};
          row[j + 1] = cf{v.z, v.w};
        }
      } else {
#pragma unroll
        for (int j = 0; j < NWW; ++j)
          row[j] = live && j < n ? reinterpret_cast<const cf*>(Rs)[j] : cf{0.f, 0.f};
      }
      const cf* rhs = reinterpret_cast<const cf*>(slot + 2 * n * n);
      row[NWW] = live ? rhs[lane] : cf{0.f, 0.f};
      const bool live2 = i2 < n;
      const cf* Rq = reinterpret_cast<const cf*>(slot + 2 * i2 * n);
#pragma unroll
      for (int m = 0; m < QW; ++m)
        rq[m] = live2 && 4 * m + sub < n ? Rq[4 * m + sub] : cf{0.f, 0.f};
      rqr = live2 ? rhs[i2] : cf{0.f, 0.f};
    }
    // every lane has its rows: the slot takes the next system while this
    // one is eliminated
    __syncwarp();
    fetch(s + gwarps);
    // probe (wide): loaded
#pragma unroll
    for (int k = 0; k < NWW; ++k) {
      if (k >= n) break;  // uniform over the warp
      // (the tests of k below fold away once the loop over k is unrolled)
      const bool piv = k < 32 && lane == k;
      const bool piv2 = k >= 32 && i2 == k;
      if (piv) {  // the pivot row, columns k .. NWW, in pairs from an even column
#pragma unroll
        for (int j = 0; j < NWW; j += 2)
          if (j + 1 >= k)
            *reinterpret_cast<float4*>(rowbuf + j) = make_float4(row[j].r, row[j].i,
                                                                 row[j + 1].r, row[j + 1].i);
        rowbuf[NWW] = row[NWW];
      }
      if (piv2) {  // a split pivot row: each of its four lanes writes its columns
#pragma unroll
        for (int m = 0; m < QW; ++m)
          if (4 * m + 3 >= k && 4 * m + sub >= k) rowbuf[4 * m + sub] = rq[m];
        if (sub == 0) rowbuf[NWW] = rqr;
      }
      __syncwarp();
      {
        const cf p = rowbuf[k];
#pragma unroll
        for (int h = 0; h < 2; ++h) {  // columns k + 1 + lane and k + 33 + lane
          const int c = k + 1 + 32 * h + lane;
          if (c <= NWW) {
            const cf a = rowbuf[c];
            FastDivOps op;
            cf q = gj_quotient(a, p, op);
            if (!op.ok && (c < n || c == NWW)) {  // the zero columns n .. NWW-1 never reach x
              IeeeOps iv;
              q = gj_quotient(a, p, iv);
            }
            qbuf[c] = q;
          }
        }
      }
      __syncwarp();
      // probe (wide): quotients
      const cf f = row[k];
      // the split row's factor: its column k, held by lane 4 (lane / 4) + k % 4
      const int src = (lane & ~3) | (k & 3);
      const cf f2 = {__shfl_sync(0xffffffffu, rq[k >> 2].r, src),
                     __shfl_sync(0xffffffffu, rq[k >> 2].i, src)};
      auto upd = [&](int j, cf q) { row[j] = piv ? q : gj_update(row[j], f, q); };
#pragma unroll
      for (int j = 0; j < NWW; j += 2) {
        if (j > k) {
          const float4 v = *reinterpret_cast<const float4*>(qbuf + j);
          upd(j, cf{v.x, v.y});
          upd(j + 1, cf{v.z, v.w});
        } else if (j + 1 > k) {
          upd(j + 1, qbuf[j + 1]);
        }
      }
      const cf qr = qbuf[NWW];
      upd(NWW, qr);
#pragma unroll
      for (int m = 0; m < QW; ++m) {
        if (4 * m + 3 > k && 4 * m + sub > k) {
          const cf q = qbuf[4 * m + sub];
          rq[m] = piv2 ? q : gj_update(rq[m], f2, q);
        }
      }
      rqr = piv2 ? qr : gj_update(rqr, f2, qr);
      // probe (wide): updated
    }
    if (lane < n) x[(long long)s * n + lane] = row[NWW];
    if (sub == 0 && i2 < n) x[(long long)s * n + i2] = rqr;
    // probe (wide): stored
  }
  // probe (wide): kernel end
}

size_t smem_bytes_wide(int n) {
  return sizeof(float) * WARPS * ((size_t)2 * n * (n + 1) + 2 * 2 * (NWW + 2));
}

int launch_wide(const float* R, const float* r, float* x, int N, int n, cudaStream_t stream) {
  const size_t bytes = smem_bytes_wide(n);
  cudaError_t err = cudaFuncSetAttribute(gj_solve_wide_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gj_solve_wide_kernel, THREADS,
                                                        bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return DSR_ERR_ARGS;
  const int blocks = min((N + WARPS - 1) / WARPS, per_sm * sms);
  gj_solve_wide_kernel<<<blocks, THREADS, bytes, stream>>>(R, r, reinterpret_cast<cf*>(x), N, n);
  return static_cast<int>(cudaGetLastError());
}

size_t smem_bytes(int n, int NW) {
  return sizeof(float) * WARPS * ((size_t)2 * 2 * n * (n + 1) + 2 * 2 * (NW + 2));
}

template <int NW>
int launch(const float* R, const float* r, float* x, int N, int n, cudaStream_t stream) {
  const size_t bytes = smem_bytes(n, NW);
  cudaError_t err = cudaFuncSetAttribute(gj_solve_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gj_solve_kernel<NW>, THREADS,
                                                        bytes);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return DSR_ERR_ARGS;
  const int blocks = min((N + WARPS - 1) / WARPS, per_sm * sms);
  gj_solve_kernel<NW><<<blocks, THREADS, bytes, stream>>>(R, r, reinterpret_cast<cf*>(x), N, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsr_gj_solve(const float* R, const float* r, float* x, int N, int n,
                            cudaStream_t stream) {
  if (N <= 0 || n <= 0 || n > WIDE_MAXN || (long long)N * n * n > 0x7fffffffLL / 2)
    return DSR_ERR_ARGS;
  if (n > MAXN) return launch_wide(R, r, x, N, n, stream);
  if (n <= 4) return launch<4>(R, r, x, N, n, stream);
  if (n <= 8) return launch<8>(R, r, x, N, n, stream);
  if (n <= 12) return launch<12>(R, r, x, N, n, stream);
  if (n <= 16) return launch<16>(R, r, x, N, n, stream);
  if (n <= 20) return launch<20>(R, r, x, N, n, stream);
  if (n <= 24) return launch<24>(R, r, x, N, n, stream);
  return launch<32>(R, r, x, N, n, stream);
}
