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
// per spectrum row, 0.49 GB at B=256 x 10 s, M = 256 (0.15 ms at 3.35
// TB/s); the FFT needs ~2.5 M log2 M flops per row, the FIR 2*m*D.  Design,
// at every M in {64, 128, ..., 2048} (one FFT plan, csrc/dsr_fft.h): a block
// owns one utterance and Tt = ROWS - (m*R - 1) output frames, ROWS = 256,
// 128, 64, 40, 48, 24 rows (~70 KB at M <= 256, three blocks of 256 threads
// an SM; 88 KB at 512, two; 214 and 224 KB at 1024 and 2048, one: the tile
// holds m*R = 32 rows at 1024 (m = 4, r = 3) and 16 at 2048 with frames
// left over); it stages the packed rows of its frames plus the m*R-1
// halo rows they reach back to (the halo is recomputed by the neighbouring
// block, as the TPU kernel does) into shared memory with cp.async, all in
// flight at once, runs the inverse FFT in place, two rows per complex FFT,
// then the FIR and overlap-add from shared memory, and writes D contiguous
// samples per frame.  The blocks an SM holds keep one block's copies in
// flight while the others compute.  Plain IEEE FP32.
#include "dsr_fft.h"
#include "dsr_kernels.h"

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// c rows per block at M: output frames + halo (even: row pairs)
__host__ __device__ constexpr int tile_rows(int M) {
  return M == 64 ? 256 : M == 128 ? 128 : M == 256 ? 64 : M == 512 ? 40 : M == 1024 ? 48
         : M == 2048 ? 24 : 0;
}
template <int M>
constexpr size_t smem_bytes() {
  return sizeof(float) * (dsr::fft::Shape<M>::TWF + (size_t)tile_rows(M) * dsr::fft::ld<M>());
}

template <int M>
__global__ void __launch_bounds__(THREADS, M > 512 ? 1 : M == 512 ? 2 : 3)
synthesis_tm_kernel(const float* __restrict__ Yp, const float* __restrict__ tw,
                    const float* __restrict__ gf, float* __restrict__ out,
                    int T_in, int B, int m, int R, int D, int pd, int T_out, int Tt) {
  constexpr int ROWS = tile_rows(M);
  constexpr int LD = dsr::fft::ld<M>();
  extern __shared__ __align__(16) float smem[];
  float* tws = smem;
  float* cs = smem + dsr::fft::Shape<M>::TWF;  // [ROWS][LD]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * Tt;
  const int b = blockIdx.y;
  // global c index of local row 0
  const int cbase = u0 + pd - (m - 1) * R - (R - 1);

  // the block's packed rows, zero outside [0, T_in)
  for (int idx = tid; idx < ROWS * (M / 4); idx += THREADS) {
    const int l = idx / (M / 4);
    const int c4 = (idx - l * (M / 4)) * 4;
    const int q = cbase + l;
    const bool in = q >= 0 && q < T_in;
    dsr::fft::cp_async16(cs + l * LD + c4, in ? Yp + ((size_t)q * B + b) * M + c4 : Yp,
                         in ? 16 : 0);
  }
  dsr::fft::cp_async_wait_all();
  dsr::fft::stage_twiddles<M>(smem, tw);
  const dsr::fft::Consts kc = dsr::fft::consts<M>(tw);
  __syncthreads();

  dsr::fft::fft_rows<M, true, THREADS>(cs, ROWS / 2, tws, kc, threadIdx.x);
  __syncthreads();

  // polyphase FIR over pushed frames + R-segment overlap-add
  dsr::fft::synthesis_frames<M, 8>(gf, cs, m, R, D, Tt, u0, T_out, out + (size_t)b * T_out * D,
                                   threadIdx.x, THREADS);
}

template <int M>
int launch(const float* Yp, const float* tw, const float* gf, float* out, int T_in, int B, int m,
           int R, int D, int pd, int T_out, int Tt, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<M>();
  cudaError_t err = cudaFuncSetAttribute(synthesis_tm_kernel<M>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((T_out + Tt - 1) / Tt, B);
  synthesis_tm_kernel<M><<<grid, THREADS, bytes, stream>>>(Yp, tw, gf, out, T_in, B, m, R, D, pd,
                                                           T_out, Tt);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dsr_synthesis_tm_rows(int M) { return tile_rows(M); }

extern "C" int dsr_synthesis_tm(const float* Yp, const float* tw, const float* gf, float* out,
                                int T_in, int B, int M, int m, int R, int D, int pd, int T_out,
                                cudaStream_t stream) {
  const int halo = m * R - 1;
  const int Tt = tile_rows(M) - halo;
  if (tile_rows(M) == 0 || R <= 0 || m <= 0 || D * R != M || Tt < 1 || B <= 0 || B > 65535 ||
      T_out <= 0 || T_out + pd != T_in)
    return DSR_ERR_ARGS;
  switch (M) {
    case 64: return launch<64>(Yp, tw, gf, out, T_in, B, m, R, D, pd, T_out, Tt, stream);
    case 128: return launch<128>(Yp, tw, gf, out, T_in, B, m, R, D, pd, T_out, Tt, stream);
    case 256: return launch<256>(Yp, tw, gf, out, T_in, B, m, R, D, pd, T_out, Tt, stream);
    case 512: return launch<512>(Yp, tw, gf, out, T_in, B, m, R, D, pd, T_out, Tt, stream);
    case 1024: return launch<1024>(Yp, tw, gf, out, T_in, B, m, R, D, pd, T_out, Tt, stream);
    default: return launch<2048>(Yp, tw, gf, out, T_in, B, m, R, D, pd, T_out, Tt, stream);
  }
}
