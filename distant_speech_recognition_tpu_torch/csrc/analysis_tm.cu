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
// What bounds this kernel: it does the DFT as a dense product, 2*M*M flops
// per output row, 168 GFLOP, 2.5 ms at the FP32 peak.  Design: a classic
// tiled SGEMM whose
// left operand is never stored: each 128-frame x 8-column tile of w is formed
// in shared memory from x (m FMAs per element, x reads are contiguous along
// the column) and immediately consumed; a block owns 128 frames of one
// (utterance, channel) row and 128 output columns, 256 threads each hold an
// 8x8 register tile.  Plain IEEE FP32 FMA, no TF32, no tensor cores.
#include "dsr_device.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

constexpr int BM = 128;  // frames per block
constexpr int BN = 128;  // output columns per block
constexpr int BK = 8;    // reduction chunk
constexpr int THREADS = 256;

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

extern "C" int dsr_analysis_tm(const float* x, const float* hr, const float* A, float* out,
                               int BC, int T, int Tf, int M, int m, int D, int shift,
                               cudaStream_t stream) {
  if (BC <= 0 || BC > 65535 || T <= 0 || Tf <= 0 || m <= 0 || D <= 0 ||
      M % BN != 0 || M % BK != 0 || M % D != 0)
    return DSR_ERR_ARGS;
  const dim3 grid(M / BN, (Tf + BM - 1) / BM, BC);
  analysis_tm_kernel<<<grid, THREADS, 0, stream>>>(x, hr, A, out, BC, T, Tf, M, m, D, shift);
  return static_cast<int>(cudaGetLastError());
}
