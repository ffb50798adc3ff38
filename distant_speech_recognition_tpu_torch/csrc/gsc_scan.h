// The parts of the GSC-RLS + Zelinski scan (K2/K6, csrc/gsc_rls_zelinski.cu)
// that do not depend on the update: the launch plan (blocks of THREADS
// (utterance, bin) threads, frames a chunk), the cp.async ring that stages a
// chunk of frames ahead (the reference channel's rows of the utterances a
// block touches and each thread's bin of the other channels), the chunk's
// reference-channel frame energies (the silence gate's), and the read of a
// frame's snapshot.  Above 257 bins (M = 1024, 2048) an utterance spans up
// to nine blocks, and each would re-read its reference rows only to sum
// their energies: there (PRE) a pre-pass (`energy_prepass_kernel`) sums
// each (frame, utterance) energy once, in the order the blocks sum them,
// and a ring slot stages each thread's bin of every channel and the
// chunk's energies [TC][NU] instead of the reference rows.  The design and
// what bounds it are described atop csrc/gsc_rls_zelinski.cu.  The GSC-LMS
// scan (csrc/gsc_lms_zelinski.cu) takes only the cp.async helpers and
// args_ok from here.
#pragma once

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

// PRE: the energies from the pre-pass, above 257 bins
__host__ __device__ constexpr bool pre_pass(int M) { return M / 2 + 1 > 257; }

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
// [TC][C-1][2][THREADS]; after both slots: the energies [TC][NU].  PRE: own
// bins of channels 0..C-1 [TC][C][2][THREADS], then the energies [TC][NU]
size_t stage_floats(int TC, int NU, int C, int M) {
  if (pre_pass(M)) return (size_t)TC * (2 * (size_t)C * THREADS + NU);
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
    p.bytes = 4 * (2 * p.stage + (pre_pass(M) ? 0 : (size_t)p.TC * p.NU));
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
  const float* en;  // PRE: the pre-pass's energies [Tf][B]
  int B, M, F;
  int b_lo, nu;  // the utterances b_lo .. b_lo + nu - 1 the block touches
  int b, f;      // this thread's bin (a valid one for every thread)
  bool valid, has_im;
};

// Start the copies of chunk k (frames t0 .. t0 + nk - 1) into ring slot R
template <int C, bool PRE>
__device__ __forceinline__ void stage_chunk(const Blk& k, const Plan& pl, float* R, int t0,
                                            int nk) {
  const int tid = threadIdx.x;
  const size_t frame = (size_t)k.B * C * k.M;
  if constexpr (PRE) {
    // this thread's bin of every channel, [tt][c][re|im][tid], then the
    // energies of the touched utterances [tt][u]
    const int im = k.has_im ? k.F - 1 : 0;
    const float* src = k.Yp + ((size_t)t0 * k.B + k.b) * C * k.M + k.f;
    float* dst = R + tid;
    for (int tt = 0; tt < nk; ++tt, src += frame) {
#pragma unroll
      for (int c = 0; c < C; ++c, dst += 2 * THREADS) {
        cp_async4(dst, src + c * k.M, k.valid);
        cp_async4(dst + THREADS, src + c * k.M + im, k.valid && k.has_im);
      }
    }
    float* en = R + (size_t)pl.TC * C * 2 * THREADS;
    for (int e = tid; e < nk * k.nu; e += THREADS) {
      const int tt = e / k.nu;
      const int u = e - tt * k.nu;
      cp_async4(en + tt * pl.NU + u, k.en + (size_t)(t0 + tt) * k.B + k.b_lo + u, true);
    }
    cp_commit();
    return;
  }
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

template <bool PRE>
__device__ __forceinline__ void chunk_energies(const Blk& k, const Plan& pl, const float* R,
                                               float* en, int nk) {
  if constexpr (PRE) return;  // staged with the chunk
  switch (pl.NG) {  // F <= 257: at most 9 groups
    case 1: chunk_energies_ng<1>(k, pl, R, en, nk); break;
    case 2: chunk_energies_ng<2>(k, pl, R, en, nk); break;
    case 3: chunk_energies_ng<3>(k, pl, R, en, nk); break;
    case 4: chunk_energies_ng<4>(k, pl, R, en, nk); break;
    case 5: chunk_energies_ng<5>(k, pl, R, en, nk); break;
    case 6: chunk_energies_ng<6>(k, pl, R, en, nk); break;
    case 7: chunk_energies_ng<7>(k, pl, R, en, nk); break;
    case 8: chunk_energies_ng<8>(k, pl, R, en, nk); break;
    default: chunk_energies_ng<9>(k, pl, R, en, nk); break;
  }
  __syncthreads();
  // probe: energies done
}

// The energies of a chunk [TC][NU]: PRE's in its ring slot R, else `en`
template <int C, bool PRE>
__device__ __forceinline__ const float* chunk_energy_rows(const Plan& pl, const float* R,
                                                          const float* en) {
  return PRE ? R + (size_t)pl.TC * C * 2 * THREADS : en;
}

template <int C, bool PRE>
__device__ __forceinline__ void read_snapshot(const Blk& k, const Plan& pl, const float* R, int tt,
                                              cf (&X)[C]) {
  if constexpr (PRE) {
    const float* g = R + (size_t)tt * C * 2 * THREADS + threadIdx.x;
#pragma unroll
    for (int c = 0; c < C; ++c) X[c] = {g[2 * c * THREADS], g[(2 * c + 1) * THREADS]};
    return;
  }
  const float* x = R + ((size_t)tt * pl.NU + (k.b - k.b_lo)) * k.M;
  X[0] = {x[k.f], k.has_im ? x[k.F + k.f - 1] : 0.f};
  const float* G = R + (size_t)pl.TC * pl.NU * k.M + threadIdx.x;
#pragma unroll
  for (int c = 1; c < C; ++c) {
    const float* g = G + ((size_t)(tt * (C - 1) + c - 1) * 2) * THREADS;
    X[c] = {g[0], g[THREADS]};
  }
}

cudaError_t sm_count(int* sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  return err;
}

// The pre-pass of PRE: en[t * B + b] = the reference channel's energy of
// frame t of utterance b, a warp a (frame, utterance) row: lane l takes bin
// g*32 + l of each group g of 32 bins (bins past F: 0), a shuffle tree a
// group, the groups added in order from 0 and divided by M, so each sum
// has the bits `chunk_energies_ng` gives it
constexpr int PRE_THREADS = 256;

__global__ void __launch_bounds__(PRE_THREADS)
    energy_prepass_kernel(const float* __restrict__ Yp, float* __restrict__ en, int Tf, int B,
                          int C, int M) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * (PRE_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= (long long)Tf * B) return;
  const int F = M / 2 + 1;
  const float* x = Yp + row * C * M;  // row t * B + b: channel 0 of utterance b, frame t
  float sum = 0.f;
  for (int g = 0; g < (F + 31) / 32; ++g) {
    const int bin = g * 32 + lane;
    const float re = bin < F ? __ldg(x + bin) : 0.f;
    const float im = bin >= 1 && bin <= F - 2 ? __ldg(x + F + bin - 1) : 0.f;
    float v = bin < F ? energy_term(bin == 0 || bin == F - 1 ? 1.f : 2.f, {re, im}) : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    sum += v;
  }
  if (lane == 0) en[row] = sum / (float)M;
}

cudaError_t energy_prepass(const float* Yp, float* en, int Tf, int B, int C, int M,
                           cudaStream_t stream) {
  const long long rows = (long long)Tf * B;
  energy_prepass_kernel<<<(unsigned)((rows + PRE_THREADS / 32 - 1) / (PRE_THREADS / 32)),
                          PRE_THREADS, 0, stream>>>(Yp, en, Tf, B, C, M);
  return cudaGetLastError();
}

// one thread per bin, at most 1025 bins (M <= 2048)
bool args_ok(int Tf, int B, int C, int Bc, int M) {
  return Tf > 0 && B > 0 && M >= 4 && M % 2 == 0 && M / 2 + 1 <= 1025 && C >= 2 && C <= 8 &&
         Bc == C - 1 && (long long)B * (M / 2 + 1) <= 0x7fffffffLL;
}

}  // namespace
