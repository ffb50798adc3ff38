// Analysis filterbank kernel: m-tap polyphase FIR + packed half-band DFT.
//
// Replaces the Pallas TPU kernel ops/pallas_kernels.py analysis_tm_fused
// (_analysis_tm_fused_call / _analysis_tm_blocked_call / _analysis_tm_nopad_call)
// of distant_speech_recognition_tpu, and computes what
// ops/filterbank.analysis_half_real_tm(packed=True) computes:
//
//   w[t, bc, j*D + i] = sum_k hr[k, j*D + i] * x[bc, (t + shift + j)*D + i + (m-1-k)*M]
//   out[t, bc, :]     = w[t, bc, :] @ A                       (A: [M, M] packed DFT)
//
// with x read as zero outside [0, T): the zero history and the zero tail of
// the filterbank come from that mask, so no padded copy of the signal exists.
// (shift = laN - (m*R - 1); hr = the prototype reshaped [m, M], columns reversed.)
//
// What bounds the function on an H100: its bytes, 2.0 GB of samples in and
// spectra out at B=256 x 4 ch x 10 s (0.59 ms at 3.35 TB/s); done by FFT,
// each 256-point row needs ~5k flops plus the FIR's 2*m*M, 9 GFLOP in all.
//
// M in {64, 128, ..., 2048} (every pipeline on the card): the product with A
// is an FFT in shared memory (csrc/dsr_fft.h, one plan for every such M).
// A block of 256 threads owns a tile of ROWS = 64 * 256 / M rows (256, 128,
// 64, 32, 16, 8: ~70 KB of rows at every M, beside 8 and 16 KB of
// twiddles at 1024 and 2048; at 2048 eight channels fill one frame), K =
// ROWS / Cg frames of Cg consecutive
// signals (the channels of one utterance, Cg = the channel count); at M =
// 256 laid out and paired in the FFT exactly as the one-kernel chains K4/K5
// and K8 lay out theirs, so K1 -> K2 equals K5 to the bit.  It
//   1. forms the rows' FIR sums from x (dsr::fft::analysis_fir_tile; at
//      m = 4, R = 2 each sample of x is loaded once per chunk of 8 frames and
//      reused from registers by the taps; below M = 256 the 256 / M threads
//      of an element share its rows) in the FFT's input layout with the (n+1)
//      phase as an index shift;
//   2. runs the FFT in place, two rows per complex FFT;
//   3. splits each row's bins off its pair (dsr::fft::split_bin) and writes
//      them as whole packed rows [Re(0..M/2) | Im(1..M/2-1)] of out (256 / M
//      rows at a time below M = 256, a row in M / 256 parts above).
// Up to 128 registers: two blocks per SM, so one block's loads of x and
// stores of out overlap the other's FFT (three blocks at 80 registers
// spilled and were slower, M = 256).  Plain IEEE FP32.
//
// The dense-product route (dsr_analysis_tm_dense, M % 128 == 0) is no
// pipeline's: it stays as a yardstick (chip_smoke.py phase 5).  A tiled
// SGEMM against A whose left operand is never stored: each 128-frame x
// 8-column tile of w is formed in shared memory from x (dsr::analysis_fir)
// and consumed at once; a block owns 128 frames of one signal and 128 output
// columns, 256 threads each hold an 8x8 register tile.  It does 2*M*M flops
// per row (168 GFLOP at the flagship's shape).
#include "dsr_device.h"
#include "dsr_fft.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// ---- M in {64, 128, ..., 2048}: FIR rows + shared-memory FFT ----------------

// rows per tile: K = ROWS / Cg frames x Cg signals, ~70 KB at every M
template <int M>
__host__ __device__ constexpr int tile_rows() {
  return 64 * 256 / M;
}
template <int M>
__host__ __device__ constexpr size_t fft_smem_bytes() {
  return sizeof(float) * (dsr::fft::Shape<M>::TWF + (size_t)tile_rows<M>() * dsr::fft::ld<M>());
}

template <int M, int C>
__global__ void __launch_bounds__(THREADS, 2)
analysis_fft_kernel(const float* __restrict__ x, const float* __restrict__ hr,
                    const float* __restrict__ tw, float* __restrict__ out, int BC, int T, int Tf,
                    int m, int D, int shift) {
  constexpr int ROWS = tile_rows<M>();
  constexpr int K = ROWS / C;
  extern __shared__ __align__(16) float smem[];
  float* tws = smem;
  float* P = smem + dsr::fft::Shape<M>::TWF;

  const int t0 = blockIdx.x * K;
  const int g = blockIdx.y;  // signals g*C .. g*C + C-1
  dsr::fft::stage_twiddles<M>(smem, tw);
  const dsr::fft::Consts kc = dsr::fft::consts<M>(tw);
  dsr::fft::analysis_fir_tile<M, ROWS, C, THREADS, 8>(P, x + (size_t)g * C * T, hr, t0, Tf, T,
                                                       m, D, shift);
  __syncthreads();
  dsr::fft::fft_rows<M, false, THREADS>(P, ROWS / 2, tws, kc, threadIdx.x);
  __syncthreads();

  // lane l of a packed row: Re(bin l) for l < F, Im(bin l - (F - 1)) after;
  // LANES threads a row, GROUPS rows at a time, LP lanes a thread
  constexpr int F = M / 2 + 1;
  constexpr int LANES = M < THREADS ? M : THREADS;
  constexpr int GROUPS = THREADS / LANES;
  constexpr int LP = M / LANES;
  const int l0 = GROUPS == 1 ? (int)threadIdx.x : (int)(threadIdx.x % LANES);
  int fl[LP];  // the bin of lane l0 + j LANES
#pragma unroll
  for (int j = 0; j < LP; ++j) {
    const int l = l0 + LANES * j;
    fl[j] = l < F ? l : l - (F - 1);
  }
#pragma unroll 4
  for (int r = GROUPS == 1 ? 0 : (int)(threadIdx.x / LANES); r < K * C; r += GROUPS) {
    const int t = t0 + r / C;
    if (t >= Tf) break;
#pragma unroll
    for (int j = 0; j < LP; ++j) {
      const int l = l0 + LANES * j;
      const dsr::cf X = dsr::fft::split_bin<M>(P, r, fl[j]);
      out[((size_t)t * BC + (size_t)g * C + r % C) * M + l] = l < F ? X.r : X.i;
    }
  }
}

template <int M, int C>
int launch_fft(const float* x, const float* hr, const float* tw, float* out, int G, int T, int Tf,
               int m, int D, int shift, cudaStream_t stream) {
  constexpr int K = tile_rows<M>() / C;
  constexpr size_t bytes = fft_smem_bytes<M>();
  cudaError_t err = cudaFuncSetAttribute(analysis_fft_kernel<M, C>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((Tf + K - 1) / K, G);
  analysis_fft_kernel<M, C><<<grid, THREADS, bytes, stream>>>(x, hr, tw, out, G * C, T, Tf, m, D,
                                                              shift);
  return static_cast<int>(cudaGetLastError());
}

template <int M>
int launch_fft_c(const float* x, const float* hr, const float* tw, float* out, int G, int Cg,
                 int T, int Tf, int m, int D, int shift, cudaStream_t stream) {
  switch (Cg) {
#define DSR_CASE(n) \
    case n: return launch_fft<M, n>(x, hr, tw, out, G, T, Tf, m, D, shift, stream);
    DSR_CASE(1) DSR_CASE(2) DSR_CASE(3) DSR_CASE(4) DSR_CASE(5) DSR_CASE(6) DSR_CASE(7)
    DSR_CASE(8)
#undef DSR_CASE
    default: return DSR_ERR_ARGS;
  }
}

// ---- other M: FIR tiles + dense DFT product ---------------------------------

constexpr int BM = 128;  // frames per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 8;    // reduction chunk

__global__ void __launch_bounds__(THREADS)
analysis_tm_kernel(const float* __restrict__ x, const float* __restrict__ hr,
                   const float* __restrict__ A, float* __restrict__ out,
                   int BC, int T, int Tf, int M, int m, int D, int shift) {
  __shared__ __align__(16) float Ws[BK][BM + 4];
  __shared__ __align__(16) float As[BK][BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int t0 = blockIdx.y * BM;
  const int bc = blockIdx.z;
  const float* xr = x + (size_t)bc * T;
  const int tx = tid % 16;
  const int ty = tid / 16;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < M; k0 += BK) {
    // FIR tile w[t0 .. t0+BM, k0 .. k0+BK), stored k-major.
#pragma unroll
    for (int e = 0; e < (BM * BK) / THREADS; ++e) {
      const int idx = e * THREADS + tid;
      const int kk = idx % BK;
      const int r = idx / BK;
      const int t = t0 + r;
      const int k = k0 + kk;
      Ws[kk][r] = t < Tf ? dsr::analysis_fir(xr, hr, T, M, m, D, shift, t, k) : 0.f;
    }
    // DFT matrix tile A[k0 .. k0+BK, n0 .. n0+BN).
    {
      const int kk = tid / (BN / 4);
      const int c4 = (tid % (BN / 4)) * 4;
      *reinterpret_cast<float4*>(&As[kk][c4]) =
          __ldg(reinterpret_cast<const float4*>(A + (size_t)(k0 + kk) * M + n0 + c4));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Ws[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&Ws[kk][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&As[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&As[kk][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = t0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (t >= Tf) continue;
    float* o = out + ((size_t)t * BC + bc) * M + n0;
    *reinterpret_cast<float4*>(o + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(o + 64 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
}

}  // namespace

extern "C" const char* dsr_error_string(int code) {
  if (code == DSR_ERR_ARGS) return "shape outside what the kernel takes";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int dsr_analysis_tm_dense(const float* x, const float* hr, const float* A, float* out,
                                     int BC, int T, int Tf, int M, int m, int D, int shift,
                                     cudaStream_t stream) {
  if (BC <= 0 || BC > 65535 || T <= 0 || Tf <= 0 || m <= 0 || D <= 0 || M % BN != 0 ||
      M % BK != 0 || M % D != 0)
    return DSR_ERR_ARGS;
  const dim3 grid(M / BN, (Tf + BM - 1) / BM, BC);
  analysis_tm_kernel<<<grid, THREADS, 0, stream>>>(x, hr, A, out, BC, T, Tf, M, m, D, shift);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int dsr_analysis_tm(const float* x, const float* hr, const float* tw, float* out,
                               int G, int Cg, int T, int Tf, int M, int m, int D, int shift,
                               cudaStream_t stream) {
  if (G <= 0 || G > 65535 || T <= 0 || Tf <= 0 || m <= 0 || D <= 0 || M % D != 0)
    return DSR_ERR_ARGS;
  switch (M) {
    case 64: return launch_fft_c<64>(x, hr, tw, out, G, Cg, T, Tf, m, D, shift, stream);
    case 128: return launch_fft_c<128>(x, hr, tw, out, G, Cg, T, Tf, m, D, shift, stream);
    case 256: return launch_fft_c<256>(x, hr, tw, out, G, Cg, T, Tf, m, D, shift, stream);
    case 512: return launch_fft_c<512>(x, hr, tw, out, G, Cg, T, Tf, m, D, shift, stream);
    case 1024: return launch_fft_c<1024>(x, hr, tw, out, G, Cg, T, Tf, m, D, shift, stream);
    case 2048: return launch_fft_c<2048>(x, hr, tw, out, G, Cg, T, Tf, m, D, shift, stream);
    default: return DSR_ERR_ARGS;
  }
}
