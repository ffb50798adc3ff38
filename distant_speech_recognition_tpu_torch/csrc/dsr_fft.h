// The 256-point DFTs of the filterbank kernels as FFTs in shared memory
// (K3 synthesis_tm.cu, K8 fw_mono.cu).
//
// What they compute (ops/dft.py):
//   - analysis: the packed row Y[f] = e^{-2 pi i f/M} fft(w)[f], f = 0..M/2,
//     of a real FIR row w (`analysis_matrix_packed`).  The phase is an index
//     shift of the input: w[n] is stored as element (n + 1) mod M.
//   - synthesis: c = M irfft(conj(Y)) of a packed row Y
//     (`synthesis_half_matrix_packed`), which is the forward FFT of Y's
//     Hermitian extension; the per-segment sample reversal
//     (`segment_reversal_perm`) is an index map where c is read.
// Both are the same forward 256-point complex FFT, run on two real rows at
// once: the rows (2q, 2q+1) of a buffer hold the real and imaginary parts of
// one complex row (two-for-one), and `split_bin` / `put_pair_bin` convert
// between the pair and its two real rows' spectra.
//
// Stage plan (tests/test_torch_fft_plan.py follows it on the CPU): the 256
// elements of a row are a 16 x 16 matrix of cells; element n sits in cell
// (n % 16, n / 16) before the FFT (layout T) and X[k] in cell (k / 16, k % 16)
// after it (natural layout).  Pass 1: thread g takes cell row g (n = 16 n1 +
// g), a 16-point DFT over n1 (radix 4 x 4, in registers), times the twiddle
// W256^(g k1), back into cells (g, k1).  Pass 2: thread g takes cell column
// g (k1 = g), a 16-point DFT over the rows into cells (k2, g): X[g + 16 k2].
// A pair's 16 threads are one half warp, so the passes synchronise with
// __syncwarp only.  Cells are XOR-swizzled (cell (r, c) at 16 r + (c ^ r))
// and rows are LD = 264 floats apart, so the half warps of a warp (two pairs,
// rows 2 LD apart, 16 banks) and every pass, split and FIR store touch 32
// distinct banks.  Twiddles come from the host's float64 table rounded to
// float32 (dft.fft_twiddles), never from __sinf/__cosf; plain IEEE FP32.
#pragma once

#include <cuda_runtime.h>

#include "dsr_device.h"

namespace dsr {
namespace fft {

constexpr int N = 256;
constexpr int LD = 264;  // floats per row in shared memory

__device__ __forceinline__ int cell(int r, int c) { return 16 * r + (c ^ r); }
// element n of a row before the FFT (layout T) and after it (natural)
__device__ __forceinline__ int tpos(int n) { return cell(n & 15, n >> 4); }
__device__ __forceinline__ int npos(int n) { return cell(n >> 4, n & 15); }

// cos(pi/8), sin(pi/8), sqrt(1/2): the radix-16 butterflies' own twiddles,
// read from the host's table
struct Consts {
  float c1, s1, r;
};

__device__ __forceinline__ Consts consts(const float* __restrict__ tw) {
  return {__ldg(tw + 16), -__ldg(tw + N + 16), __ldg(tw + 32)};
}

// 16-byte asynchronous copy global -> shared; src_bytes = 0 writes zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// the twiddle table [2][N] (cos, -sin of 2 pi e / N) into shared memory;
// the caller synchronises the block before the first pass
__device__ __forceinline__ void stage_twiddles(float* sm, const float* __restrict__ tw) {
  for (int i = threadIdx.x; i < 2 * N / 4; i += blockDim.x) cp_async16(sm + 4 * i, tw + 4 * i, 16);
  cp_async_wait_all();
}

// y[l] = sum_m x[m] (-i)^(m l), in place
__device__ __forceinline__ void dft4(float& r0, float& i0, float& r1, float& i1, float& r2,
                                     float& i2, float& r3, float& i3) {
  const float ar = r0 + r2, ai = i0 + i2;
  const float br = r0 - r2, bi = i0 - i2;
  const float cr = r1 + r3, ci = i1 + i3;
  const float dr = r1 - r3, di = i1 - i3;
  r0 = ar + cr;
  i0 = ai + ci;
  r2 = ar - cr;
  i2 = ai - ci;
  r1 = br + di;  // b - i d
  i1 = bi - dr;
  r3 = br - di;  // b + i d
  i3 = bi + dr;
}

__device__ __forceinline__ void twiddle(float& xr, float& xi, float wr, float wi) {
  const float t = xr * wr - xi * wi;
  xi = xr * wi + xi * wr;
  xr = t;
}

// V[k] = sum_n v[n] W16^(n k) in place; V[k] ends at register index
// 4 (k % 4) + k / 4 (`reg16`).  n = 4 m1 + m2, k = l1 + 4 l2.
__device__ __forceinline__ void dft16(float (&r)[16], float (&i)[16], const Consts& k) {
#pragma unroll
  for (int m2 = 0; m2 < 4; ++m2)
    dft4(r[m2], i[m2], r[4 + m2], i[4 + m2], r[8 + m2], i[8 + m2], r[12 + m2], i[12 + m2]);
  // index 4 l1 + m2 holds the m2-th DFT's output l1: times W16^(m2 l1)
  twiddle(r[5], i[5], k.c1, -k.s1);   // W^1
  twiddle(r[6], i[6], k.r, -k.r);     // W^2
  twiddle(r[7], i[7], k.s1, -k.c1);   // W^3
  twiddle(r[9], i[9], k.r, -k.r);     // W^2
  {                                   // W^4 = -i
    const float t = r[10];
    r[10] = i[10];
    i[10] = -t;
  }
  twiddle(r[11], i[11], -k.r, -k.r);  // W^6
  twiddle(r[13], i[13], k.s1, -k.c1); // W^3
  twiddle(r[14], i[14], -k.r, -k.r);  // W^6
  twiddle(r[15], i[15], -k.c1, k.s1); // W^9
#pragma unroll
  for (int l1 = 0; l1 < 4; ++l1)
    dft4(r[4 * l1], i[4 * l1], r[4 * l1 + 1], i[4 * l1 + 1], r[4 * l1 + 2], i[4 * l1 + 2],
         r[4 * l1 + 3], i[4 * l1 + 3]);
}

__host__ __device__ constexpr int reg16(int k) { return 4 * (k & 3) + (k >> 2); }

// Z[k] of the complex row a + i b formed from two packed rows a, b
// ([Re(0..N/2) | Im(1..N/2-1)], raw lanes): the Hermitian extensions of the
// two half spectra, the second times i
__device__ __forceinline__ void packed_pair_z(const float* a, const float* b, int k, float& zr,
                                              float& zi) {
  if (k == 0 || k == N / 2) {
    zr = a[k];
    zi = b[k];
  } else if (k < N / 2) {
    zr = a[k] - b[N / 2 + k];
    zi = a[N / 2 + k] + b[k];
  } else {
    const int kk = N - k;
    zr = a[kk] + b[N / 2 + kk];
    zi = b[kk] - a[N / 2 + kk];
  }
}

// In-place forward FFT of `pairs` row pairs, pair q = rows (2q, 2q+1) of
// `rows` (re, im), by every thread of the block (16 per pair).  Input in
// layout T, or, with FROM_PACKED, two packed half spectra per pair in raw
// lanes (`packed_pair_z`); output in natural layout.
template <bool FROM_PACKED>
__device__ __forceinline__ void fft_rows(float* rows, int pairs, const float* tc, const float* ts,
                                         const Consts& kc) {
  const int g = threadIdx.x & 15;
  for (int q0 = 0; q0 < pairs; q0 += blockDim.x / 16) {
    const int q = q0 + (threadIdx.x >> 4);
    const bool on = q < pairs;
    float* re = rows + (size_t)(2 * q) * LD;
    float* im = re + LD;
    float vr[16], vi[16];
    if (on) {
#pragma unroll
      for (int n1 = 0; n1 < 16; ++n1) {
        if (FROM_PACKED) {
          packed_pair_z(re, im, g + 16 * n1, vr[n1], vi[n1]);
        } else {
          vr[n1] = re[cell(g, n1)];
          vi[n1] = im[cell(g, n1)];
        }
      }
    }
    if (FROM_PACKED) __syncwarp();  // the pair's packed lanes are read before any cell is written
    if (on) {
      dft16(vr, vi, kc);
      re[cell(g, 0)] = vr[0];
      im[cell(g, 0)] = vi[0];
#pragma unroll
      for (int k1 = 1; k1 < 16; ++k1) {
        const int e = g * k1;
        float xr = vr[reg16(k1)], xi = vi[reg16(k1)];
        twiddle(xr, xi, tc[e], ts[e]);
        re[cell(g, k1)] = xr;
        im[cell(g, k1)] = xi;
      }
    }
    __syncwarp();
    if (on) {
#pragma unroll
      for (int n2 = 0; n2 < 16; ++n2) {
        vr[n2] = re[cell(n2, g)];
        vi[n2] = im[cell(n2, g)];
      }
      dft16(vr, vi, kc);
#pragma unroll
      for (int k2 = 0; k2 < 16; ++k2) {
        re[cell(k2, g)] = vr[reg16(k2)];
        im[cell(k2, g)] = vi[reg16(k2)];
      }
    }
  }
}

// Bin f of real row r of a transformed pair buffer (pair r / 2 in natural
// layout): the two-for-one split, X = (Z[f] + conj(Z[-f])) / 2 for the even
// row and (Z[f] - conj(Z[-f])) / 2i for the odd one.  DC and Nyquist come
// out real.
__device__ __forceinline__ cf split_bin(const float* rows, int r, int f) {
  const float* re = rows + (size_t)(r & ~1) * LD;
  const float* im = re + LD;
  const int a = npos(f), b = npos((N - f) & (N - 1));
  if (r & 1) return {0.5f * (im[a] + im[b]), 0.5f * (re[b] - re[a])};
  return {0.5f * (re[a] + re[b]), 0.5f * (im[a] - im[b])};
}

// Bins f and N - f of the pair row (layout T) whose FFT gives the synthesis
// rows of the half spectra A (row 2q) and B (row 2q+1); the Im parts of DC
// and Nyquist are dropped, as the packed layout drops them.
__device__ __forceinline__ void put_pair_bin(float* row, int f, cf A, cf B) {
  float* im = row + LD;
  if (f == 0 || f == N / 2) {
    row[tpos(f)] = A.r;
    im[tpos(f)] = B.r;
    return;
  }
  row[tpos(f)] = A.r - B.i;
  im[tpos(f)] = A.i + B.r;
  row[tpos(N - f)] = A.r + B.i;
  im[tpos(N - f)] = B.r - A.i;
}

// The synthesis FIR + overlap-add (`dsr::synthesis_sample`, summed in its
// order) of local output frames ul = 0..nfr-1, frame u = u_first + ul
// (those outside [0, T_out) skipped), from c rows in natural layout, LD
// apart: local row l holds c[u - ul + pd - (m*R-1) + l]; column col =
// (R-1-j) D + i of the reversed segments is c's element (R-1-j) D + D-1-i.
// Thread t owns column i = t % D and frames t / D + n * (blockDim / D) (D
// divides blockDim), S at a time: each tap is loaded once per S samples and
// each sample costs one shared load and one FMA per tap.
template <int S>
__device__ __forceinline__ void synthesis_frames(const float* __restrict__ gf, const float* cs,
                                                 int m, int R, int D, int nfr, int u_first,
                                                 int T_out, float* __restrict__ ob) {
  const int step = blockDim.x / D;
  const int i = threadIdx.x % D;
  for (int c0 = threadIdx.x / D; c0 < nfr; c0 += S * step) {
    float o[S];
#pragma unroll
    for (int s = 0; s < S; ++s) o[s] = 0.f;
    for (int j = 0; j < R; ++j) {
      const int col = (R - 1 - j) * D + i;
      const int p = npos((R - 1 - j) * D + (D - 1 - i));
      float sj[S];
#pragma unroll
      for (int s = 0; s < S; ++s) sj[s] = 0.f;
      for (int k = 0; k < m; ++k) {
        const float gv = __ldg(gf + k * N + col);
        const float* row = cs + (c0 - j + (m - 1 - k) * R + (R - 1)) * LD + p;
#pragma unroll
        for (int s = 0; s < S; ++s)
          sj[s] = fmaf(gv, c0 + s * step < nfr ? row[s * step * LD] : 0.f, sj[s]);
      }
#pragma unroll
      for (int s = 0; s < S; ++s)
        if (u_first + c0 + s * step - j >= 0) o[s] += sj[s];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const int ul = c0 + s * step;
      const int u = u_first + ul;
      if (ul < nfr && u >= 0 && u < T_out) ob[(size_t)u * D + i] = o[s];
    }
  }
}

}  // namespace fft
}  // namespace dsr
