// Synthesis filterbank kernel: packed inverse DFT + m-tap polyphase FIR + overlap-add.
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
// the bank and are dropped).  The product with S is done as an FFT
// (csrc/dsr_fft.h): c = M irfft(conj(Yp[q])), the segment reversal an index
// map where c is read.
//
// What bounds the function on an H100: its bytes, M*4 read and D*4 written
// per spectrum row, 0.49 GB at B=256 x 10 s (0.15 ms at 3.35 TB/s); the FFT
// needs ~5k flops per row, the FIR 2*m*D.  Design: a block owns one
// utterance and Tt = ROWS - (m*R - 1) output frames; it stages the packed
// rows of its frames plus the m*R-1 halo rows they reach back to (the halo
// is recomputed by the neighbouring block, as the TPU kernel does) into
// shared memory with cp.async, all in flight at once, runs the inverse FFT
// in place, two rows per complex FFT, then the FIR and overlap-add from
// shared memory, and writes D contiguous samples per frame.  ~70 KB of
// shared memory: three blocks of 256 threads per SM, so that one block's
// copies are in flight while the others compute.  Plain IEEE FP32.
#include "dsr_fft.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

using dsr::fft::LD;

constexpr int M_ = dsr::fft::N;  // subbands (the kernel is built for M = 256)
constexpr int ROWS = 64;         // c rows per block: output frames + halo (even: row pairs)
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = sizeof(float) * (2 * M_ + (size_t)ROWS * LD);

__global__ void __launch_bounds__(THREADS, 3)
synthesis_tm_kernel(const float* __restrict__ Yp, const float* __restrict__ tw,
                    const float* __restrict__ gf, float* __restrict__ out,
                    int T_in, int B, int m, int R, int D, int pd, int T_out, int Tt) {
  extern __shared__ __align__(16) float smem[];
  float* tc = smem;
  float* ts = tc + M_;
  float* cs = ts + M_;  // [ROWS][LD]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * Tt;
  const int b = blockIdx.y;
  // global c index of local row 0
  const int cbase = u0 + pd - (m - 1) * R - (R - 1);

  // the block's packed rows, zero outside [0, T_in)
  for (int idx = tid; idx < ROWS * (M_ / 4); idx += THREADS) {
    const int l = idx / (M_ / 4);
    const int c4 = (idx - l * (M_ / 4)) * 4;
    const int q = cbase + l;
    const bool in = q >= 0 && q < T_in;
    dsr::fft::cp_async16(cs + l * LD + c4, in ? Yp + ((size_t)q * B + b) * M_ + c4 : Yp,
                         in ? 16 : 0);
  }
  dsr::fft::cp_async_wait_all();
  dsr::fft::stage_twiddles(smem, tw);
  const dsr::fft::Consts kc = dsr::fft::consts(tw);
  __syncthreads();

  dsr::fft::fft_rows<true, THREADS>(cs, ROWS / 2, tc, ts, kc, threadIdx.x);
  __syncthreads();

  // polyphase FIR over pushed frames + R-segment overlap-add
  dsr::fft::synthesis_frames<8>(gf, cs, m, R, D, Tt, u0, T_out, out + (size_t)b * T_out * D,
                                 threadIdx.x, THREADS);
}

}  // namespace

extern "C" int dsr_synthesis_tm(const float* Yp, const float* tw, const float* gf, float* out,
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
  synthesis_tm_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(Yp, tw, gf, out, T_in, B, m, R, D,
                                                             pd, T_out, Tt);
  return static_cast<int>(cudaGetLastError());
}
