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
// the same order.  Design: one warp per system, lane j holds column j of the
// augmented n x (n+1) matrix in registers (n <= 31); at step k the pivot and
// the factors A_ik come from lane k by warp shuffles, every lane updates its
// own column, and no shared memory or barrier is needed.  Loads of a row
// across the lanes are coalesced.  IEEE division.
#include "dsr_kernels.h"

namespace {

constexpr int MAXN = 31;
constexpr int THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;

struct cf {
  float r, i;
};

__global__ void __launch_bounds__(THREADS)
gj_solve_kernel(const cf* __restrict__ R, const cf* __restrict__ r, cf* __restrict__ x, int N,
                int n) {
  const int sys = (blockIdx.x * THREADS + threadIdx.x) / 32;
  const int lane = threadIdx.x & 31;
  if (sys >= N) return;  // uniform over the warp
  const cf* Rs = R + (size_t)sys * n * n;
  const cf* rs = r + (size_t)sys * n;

  cf col[MAXN];
#pragma unroll
  for (int i = 0; i < MAXN; ++i) {
    col[i] = {0.f, 0.f};
    if (i < n) {
      if (lane < n) col[i] = Rs[i * n + lane];
      else if (lane == n) col[i] = rs[i];
    }
  }
  // n is uniform over the warp, so every lane takes part in each shuffle;
  // the guards (not breaks) keep both loops fully unrolled and col in registers
#pragma unroll
  for (int k = 0; k < MAXN; ++k) {
    if (k < n) {
      const float pr = __shfl_sync(FULL, col[k].r, k);
      const float pi = __shfl_sync(FULL, col[k].i, k);
      float den = pr * pr + pi * pi;
      den = den > 0.f ? den : 1.f;
      const cf q = {(col[k].r * pr + col[k].i * pi) / den,
                    (col[k].i * pr - col[k].r * pi) / den};
#pragma unroll
      for (int i = 0; i < MAXN; ++i) {
        if (i != k && i < n) {
          const float fr = __shfl_sync(FULL, col[i].r, k);
          const float fi = __shfl_sync(FULL, col[i].i, k);
          col[i].r -= fr * q.r - fi * q.i;
          col[i].i -= fr * q.i + fi * q.r;
        }
      }
      col[k] = q;
    }
  }
  if (lane == n) {
    cf* xs = x + (size_t)sys * n;
#pragma unroll
    for (int i = 0; i < MAXN; ++i)
      if (i < n) xs[i] = col[i];
  }
}

}  // namespace

extern "C" int dsr_gj_solve(const float* R, const float* r, float* x, int N, int n,
                            cudaStream_t stream) {
  if (N <= 0 || n <= 0 || n > MAXN || (long long)N * 32 > 0x7fffffffLL) return DSR_ERR_ARGS;
  const int per_block = THREADS / 32;
  gj_solve_kernel<<<(N + per_block - 1) / per_block, THREADS, 0, stream>>>(
      reinterpret_cast<const cf*>(R), reinterpret_cast<const cf*>(r), reinterpret_cast<cf*>(x),
      N, n);
  return static_cast<int>(cudaGetLastError());
}
