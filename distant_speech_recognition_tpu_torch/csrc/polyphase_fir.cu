// Strided m-tap FIR over rows, batched:
//
//   v[n, t, i] = sum_k h[k, i] * S[n, t + (m-1-k)*R, i],   t < T,
//
// S [N, T + (m-1)*R, M], h [m, M], v [N, T, M], float32.  Replaces the Pallas
// TPU kernel ops/pallas_kernels.py polyphase_fir (_make_kernel) of
// distant_speech_recognition_tpu, the FIR stage of the full-band filterbanks
// (ops/filterbank.analysis_pallas / synthesis_pallas there;
// ops/filterbank_kernels.analysis_polyphase / synthesis_polyphase here), and
// computes what ops/filterbank.polyphase_fir_plain computes, rounding for
// rounding: the products and sums are separately rounded (no FMA), tap 0
// first, as the m shifted slices of the plain version are.
//
// What bounds it on an H100: its bytes, S read once and v written once, 8
// bytes per output for 2m flops (2.6 GB, 0.78 ms at 3.35 TB/s, for the
// round trip's analysis at B=256 x 4 ch x 10 s).  Design: a thread owns one
// column i, one residue of t modulo R and a run of RUN rows of that residue
// (t, t+R, t+2R, ...): consecutive rows share m-1 of their m inputs, so the
// thread keeps the m taps and a window of m inputs in registers and loads
// one new input per output; consecutive threads take consecutive columns,
// so every load and store is coalesced.
#include "dsr_kernels.h"

#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int RUN = 16;  // outputs per thread
constexpr int MAX_M = 8;

template <int m>
__global__ void __launch_bounds__(THREADS)
polyphase_fir_kernel(const float* __restrict__ S, const float* __restrict__ h,
                     float* __restrict__ v, long long n_threads, int T, int M, int R, int n_runs) {
  const long long id = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (id >= n_threads) return;
  const int i = (int)(id % M);
  long long rest = id / M;
  const int run = (int)(rest % n_runs);
  rest /= n_runs;
  const int r = (int)(rest % R);
  const long long n = rest / R;
  const int t0 = r + run * RUN * R;  // first output row
  if (t0 >= T) return;
  const int rows_in = T + (m - 1) * R;
  const float* s = S + (size_t)n * rows_in * M + i;
  float* o = v + (size_t)n * T * M + i;

  float hk[m];
#pragma unroll
  for (int k = 0; k < m; ++k) hk[k] = __ldg(h + k * M + i);
  // w[j] = S[t + j*R] for the current output row t
  float w[m];
#pragma unroll
  for (int j = 0; j < m - 1; ++j) w[j] = __ldg(s + (size_t)(t0 + j * R) * M);
  for (int q = 0, t = t0; q < RUN && t < T; ++q, t += R) {
    w[m - 1] = __ldg(s + (size_t)(t + (m - 1) * R) * M);
    float acc = __fmul_rn(hk[0], w[m - 1]);
#pragma unroll
    for (int k = 1; k < m; ++k) acc = __fadd_rn(acc, __fmul_rn(hk[k], w[m - 1 - k]));
    o[(size_t)t * M] = acc;
#pragma unroll
    for (int j = 0; j < m - 1; ++j) w[j] = w[j + 1];
  }
}

template <int m>
int launch(const float* S, const float* h, float* v, int N, int T, int M, int R,
           cudaStream_t stream) {
  const int rows_per_residue = (T + R - 1) / R;
  const int n_runs = (rows_per_residue + RUN - 1) / RUN;
  const long long n_threads = (long long)N * R * n_runs * M;
  const long long blocks = (n_threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return DSR_ERR_ARGS;
  polyphase_fir_kernel<m><<<(unsigned)blocks, THREADS, 0, stream>>>(S, h, v, n_threads, T, M, R,
                                                                     n_runs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsr_polyphase_fir(const float* S, const float* h, float* v, int N, int T, int M,
                                 int m, int R, cudaStream_t stream) {
  if (N <= 0 || T <= 0 || M <= 0 || R <= 0 || m <= 0 || m > MAX_M) return DSR_ERR_ARGS;
  switch (m) {
#define DSR_CASE(k) \
    case k: return launch<k>(S, h, v, N, T, M, R, stream);
    DSR_CASE(1) DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7) DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}
