// Plain C interface of the port's CUDA kernels, loaded with ctypes by
// distant_speech_recognition_tpu_torch/kernels/_build.py.
//
// Every pointer is a device pointer to contiguous float32 data and every
// entry point enqueues on the given stream without synchronising.  Each
// returns 0 on success, a cudaError_t from cudaGetLastError() after the
// launch, or DSR_ERR_ARGS when the shapes are outside what the kernel takes.
#pragma once

#include <cuda_runtime.h>

#define DSR_ERR_ARGS 100000

#ifdef __cplusplus
extern "C" {
#endif

const char* dsr_error_string(int code);

int dsr_analysis_tm(const float* x, const float* hr, const float* A, float* out,
                    int BC, int T, int Tf, int M, int m, int D, int shift,
                    cudaStream_t stream);

int dsr_synthesis_tm(const float* Yp, const float* S, const float* gf, float* out,
                     int T_in, int B, int M, int m, int R, int D, int pd, int T_out,
                     cudaStream_t stream);

int dsr_gsc_rls_zelinski(const float* Yp, const float* wq, const float* bm,
                         const float* ta, float* out, int Tf, int B, int C, int Bc,
                         int M, float beta, float one_minus_beta, float gamma,
                         float mu, float delta, float inv_delta, float reg_param,
                         float sil_thresh, int constraint_option, float alpha2,
                         float max_wa_l2norm, int min_frames, float pf_alpha,
                         float one_minus_pf_alpha, float pf_gain,
                         float spectral_floor, int real_mode, int pf_min_frames,
                         cudaStream_t stream);

// kalman = 0: NLMS with p1 = delta, p2 = epsilon; kalman = 1: p1 = beta, p2 = sigma2
int dsr_aec_scan(const float* A, const float* V, float* E, int Tf, int B, int C, int M,
                 int kalman, float p1, float p2, float thr, cudaStream_t stream);

// G, R, r: interleaved complex64
int dsr_wpe_stats(const float* Yp, const float* G, float* R, float* r, int Tf, int B, int C,
                  int M, int P, int lowerN, int has_g, cudaStream_t stream);

int dsr_wpe_resid(const float* Yp, const float* G, float* out, int Tf, int B, int C, int M,
                  int P, int lowerN, cudaStream_t stream);

// R, r, x: interleaved complex64
int dsr_gj_solve(const float* R, const float* r, float* x, int N, int n, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
