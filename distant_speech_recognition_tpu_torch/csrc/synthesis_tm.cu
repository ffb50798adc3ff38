// Synthesis filterbank kernel: packed DFT + m-tap polyphase FIR + overlap-add.
//
// Replaces the Pallas TPU kernel ops/pallas_kernels.py synthesis_tm_fused
// (_synthesis_tm_fused_call / _synthesis_tm_nopad_call) of
// distant_speech_recognition_tpu, and computes what
// ops/filterbank.synthesis_half_real_tm computes:
//
//   c[q]       = Yp[q, b, :] @ S                 (S: [M, M], segment reversal in its columns)
//   s[u]       = sum_k gf[k] * c[u + pd - k*R]    (c at a negative index is zero)
//   out[b, u]  = sum_j s[u - j][(R-1-j)*D : (R-j)*D]   (s at a negative index is zero)
//
// for u = 0 .. T_out-1, T_out = T_in - pd (pd = synthesis_delay frames prime
// the bank and are dropped).
//
// What bounds the function on an H100: its bytes, M*4 read and D*4 written
// per spectrum row, 0.49 GB at B=256 x 10 s (0.15 ms at 3.35 TB/s); done by
// FFT, each row needs ~5k flops plus the FIR's.  What bounds this kernel: it
// does the DFT as a dense product, 2*M*M flops per spectrum row, about 43
// GFLOP with the halo, 0.64 ms at the FP32 peak.  Design: a block
// owns one utterance and Tt = ROWS - (m*R - 1) output frames; it computes the
// c rows of its frames plus the m*R-1 halo rows they reach back to (the halo
// is recomputed by the neighbouring block, as the TPU kernel does) into
// shared memory with a tiled SGEMM (256 threads, 9x8 register tiles), then
// runs the FIR and overlap-add from shared memory and writes D contiguous
// samples per frame.  Plain IEEE FP32 FMA, no TF32, no tensor cores.
#include "dsr_device.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

constexpr int M_ = 256;     // subbands (the kernel is built for M = 256)
constexpr int ROWS = 72;    // c rows per block: output frames + halo
constexpr int RPT = 9;      // c rows per thread (ROWS / 8)
constexpr int BK = 16;      // reduction chunk
constexpr int YS_LD = ROWS + 4;
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = sizeof(float) * ((size_t)ROWS * M_ + BK * YS_LD + BK * M_);

__global__ void __launch_bounds__(THREADS)
synthesis_tm_kernel(const float* __restrict__ Yp, const float* __restrict__ S,
                    const float* __restrict__ gf, float* __restrict__ out,
                    int T_in, int B, int m, int R, int D, int pd, int T_out, int Tt) {
  extern __shared__ __align__(16) float smem[];
  float* cs = smem;                    // [ROWS][M_]
  float* Ys = cs + ROWS * M_;          // [BK][YS_LD]
  float* Ss = Ys + BK * YS_LD;         // [BK][M_]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * Tt;
  const int b = blockIdx.y;
  const int halo = m * R - 1;
  const int rows = Tt + halo;
  // global c index of local row 0
  const int cbase = u0 + pd - (m - 1) * R - (R - 1);
  const int tx = tid % 32;  // columns q*128 + tx*4 + e
  const int ty = tid / 32;  // rows ty*RPT .. ty*RPT + RPT

  float acc[RPT][8];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < M_; k0 += BK) {
    for (int idx = tid; idx < BK * ROWS; idx += THREADS) {
      const int kk = idx % BK;
      const int l = idx / BK;
      const int q = cbase + l;
      float v = 0.f;
      if (l < rows && q >= 0 && q < T_in) v = __ldg(Yp + ((size_t)q * B + b) * M_ + k0 + kk);
      Ys[kk * YS_LD + l] = v;
    }
#pragma unroll
    for (int e = 0; e < (BK * M_) / (4 * THREADS); ++e) {
      const int idx = e * THREADS + tid;
      const int kk = idx / (M_ / 4);
      const int c4 = (idx % (M_ / 4)) * 4;
      *reinterpret_cast<float4*>(Ss + kk * M_ + c4) =
          __ldg(reinterpret_cast<const float4*>(S + (size_t)(k0 + kk) * M_ + c4));
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 b0 = *reinterpret_cast<const float4*>(Ss + kk * M_ + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Ss + kk * M_ + 128 + tx * 4);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float a = Ys[kk * YS_LD + ty * RPT + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a, bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    float* row = cs + (ty * RPT + i) * M_;
    *reinterpret_cast<float4*>(row + tx * 4) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(row + 128 + tx * 4) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  __syncthreads();

  // polyphase FIR over pushed frames + R-segment overlap-add
  float* ob = out + (size_t)b * T_out * D;
  for (int idx = tid; idx < Tt * D; idx += THREADS) {
    const int ul = idx / D;
    const int i = idx - ul * D;
    const int u = u0 + ul;
    if (u >= T_out) break;
    ob[(size_t)u * D + i] = dsr::synthesis_sample(gf, cs, M_, m, R, D, ul, u, i);
  }
}

}  // namespace

extern "C" int dsr_synthesis_tm(const float* Yp, const float* S, const float* gf, float* out,
                                int T_in, int B, int M, int m, int R, int D, int pd, int T_out,
                                cudaStream_t stream) {
  const int halo = m * R - 1;
  const int Tt = ROWS - halo;
  if (M != M_ || R <= 0 || m <= 0 || D * R != M || Tt < 1 || B <= 0 || B > 65535 ||
      T_out <= 0 || T_out + pd != T_in)
    return DSR_ERR_ARGS;
  cudaError_t err = cudaFuncSetAttribute(synthesis_tm_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM_BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_out + Tt - 1) / Tt, B);
  synthesis_tm_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(Yp, S, gf, out, T_in, B, m, R, D,
                                                             pd, T_out, Tt);
  return static_cast<int>(cudaGetLastError());
}
