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

// x: G groups of Cg signals [G * Cg, T], 1 <= Cg <= 8; tw: the FFT
// twiddle table [2, M] (cos, -sin of 2 pi e / M), ops/dft.fft_twiddles;
// M in {64, 128, ..., 2048} (the shared-memory FFT of dsr_fft.h)
int dsr_analysis_tm(const float* x, const float* hr, const float* tw, float* out, int G, int Cg,
                    int T, int Tf, int M, int m, int D, int shift, cudaStream_t stream);

// K1's dense-product route at any M % 128 == 0, on BC signals: no
// pipeline's, a yardstick beside the FFT route
int dsr_analysis_tm_dense(const float* x, const float* hr, const float* A, float* out, int BC,
                          int T, int Tf, int M, int m, int D, int shift, cudaStream_t stream);

// tw: as for dsr_analysis_tm
// M in {64, 128, ..., 2048}; m*R - 1 halo rows within the tile of
// dsr_synthesis_tm_rows(M) rows
int dsr_synthesis_tm(const float* Yp, const float* tw, const float* gf, float* out,
                     int T_in, int B, int M, int m, int R, int D, int pd, int T_out,
                     cudaStream_t stream);

// the rows of K3's tile at M (output frames + halo), 0 for an M it refuses
int dsr_synthesis_tm_rows(int M);

// the floats of K2/K6's energy buffer en at (Tf, B, M): Tf * B above 257
// bins (M = 1024, 2048), where a pre-pass launched first puts the
// reference channel's frame energies there, else 0 (en may be null)
int dsr_gsc_rls_zelinski_energy_floats(int Tf, int B, int M);

// K2: M/2 + 1 <= 1025 bins; en as `dsr_gsc_rls_zelinski_energy_floats` says
int dsr_gsc_rls_zelinski(const float* Yp, const float* wq, const float* bm,
                         const float* ta, float* out, float* en, int Tf, int B, int C, int Bc,
                         int M, float beta, float one_minus_beta, float gamma,
                         float mu, float delta, float inv_delta, float reg_param,
                         float sil_thresh, int constraint_option, float alpha2,
                         float max_wa_l2norm, int min_frames, float pf_alpha,
                         float one_minus_pf_alpha, float pf_gain,
                         float spectral_floor, int real_mode, int pf_min_frames,
                         cudaStream_t stream);

// K6: gsc_rls_zelinski with one set of weights per utterance
// (wq, ta [B, F, C], bm [B, F, Bc, C] instead of [F, ...]); out and en as
// K2's
int dsr_gsc_rls_zelinski_steered(const float* Yp, const float* wq, const float* bm,
                                 const float* ta, float* out, float* en, int Tf, int B, int C,
                                 int Bc, int M, float beta, float one_minus_beta, float gamma,
                                 float mu, float delta, float inv_delta, float reg_param,
                                 float sil_thresh, int constraint_option, float alpha2,
                                 float max_wa_l2norm, int min_frames, float pf_alpha,
                                 float one_minus_pf_alpha, float pf_gain,
                                 float spectral_floor, int real_mode, int pf_min_frames,
                                 cudaStream_t stream);

// the silence gates of the GSC-LMS, gates[t * B + b] = 1 or 0: the
// reference channel's frame energy of utterance b against its smoothed
// energy before frame t's update (from delta) divided by sil_thresh; two
// launches on the stream, the energies first (into gates), then the
// recursion
int dsr_lms_gates(const float* Yp, float* gates, int Tf, int B, int C, int M, float beta,
                  float one_minus_beta, float delta, float sil_thresh, cudaStream_t stream);

// the GSC with the leaky power-normalised LMS active weight vector + Zelinski
// (no TPU kernel: the JAX package's XLA scan gsc_postfilter_fused(kind="lms")),
// one set of weights [F, ...], on the gates [Tf, B] of dsr_lms_gates: two
// lanes a bin
int dsr_gsc_lms_zelinski(const float* Yp, const float* gates, const float* wq, const float* bm,
                         const float* ta, float* out, int Tf, int B, int C, int Bc,
                         int M, float beta, float one_minus_beta, float gamma,
                         float delta, float reg_param, float energy_floor,
                         float max_wa_l2norm, int min_frames, int slowdown_after,
                         float pf_alpha, float one_minus_pf_alpha, float pf_gain,
                         float spectral_floor, int real_mode, int pf_min_frames,
                         cudaStream_t stream);

// dsr_gsc_lms_zelinski with one set of weights per utterance: wq, ta
// interleaved complex64 [B, F, C], bm [B, F, Bc, C] (the steered GSC-LMS)
int dsr_gsc_lms_zelinski_steered(const float* Yp, const float* gates, const float* wq,
                                 const float* bm, const float* ta, float* out, int Tf, int B,
                                 int C, int Bc, int M, float beta, float one_minus_beta,
                                 float gamma, float delta, float reg_param, float energy_floor,
                                 float max_wa_l2norm, int min_frames, int slowdown_after,
                                 float pf_alpha, float one_minus_pf_alpha, float pf_gain,
                                 float spectral_floor, int real_mode, int pf_min_frames,
                                 cudaStream_t stream);

// 0 where dsr_gsc_lms_zelinski takes these shapes and step-size countdown,
// else DSR_ERR_ARGS (its wrapper asks before either kernel launches)
int dsr_gsc_lms_zelinski_args_ok(int Tf, int B, int C, int Bc, int M, int slowdown_after);

// the launch dsr_gsc_lms_zelinski's scan takes for (B, C, M) with the
// Zelinski stage zmode (1 real part, 2 modulus): lanes a bin, blocks,
// threads a block, frames a warp stages ahead, dynamic shared memory, the
// kernel's registers and local memory bytes, and the blocks an SM holds
int dsr_gsc_lms_zelinski_shape(int B, int C, int M, int zmode, int* lanes, int* blocks,
                               int* threads, int* frames, int* smem_bytes, int* regs,
                               int* local_bytes, int* blocks_per_sm);

// test entry (fastdiv_check.cu): q[i] = fast_div<scale_exp>(a[i], b[i])
// (dsr_device.h; scale_exp 0 or 32, the LMS scan's), and ok[i] whether it
// vouches for it
int dsr_fastdiv_check(const float* a, const float* b, float* q, int* ok, int n, int scale_exp,
                      cudaStream_t stream);

// the launch shape that dsr_gsc_rls_zelinski(_steered) takes for (B, C, M):
// blocks, threads a block, frames a chunk, dynamic shared memory, the
// kernel's registers a thread and blocks per SM
int dsr_gsc_rls_zelinski_shape(int B, int C, int M, int* blocks, int* threads, int* frames,
                               int* smem_bytes, int* regs, int* blocks_per_sm);

// wq, ta: interleaved complex64 [F, C]
int dsr_zelinski_apply(const float* Yp, const float* wq, const float* ta, float* out, int Tf,
                       int B, int C, int M, float pf_alpha, float one_minus_pf_alpha,
                       float pf_gain, float spectral_floor, int real_mode, int pf_min_frames,
                       cudaStream_t stream);

// dsr_zelinski_apply with one set per utterance: wq, ta interleaved
// complex64 [B, F, C] (the steered D&S)
int dsr_zelinski_apply_steered(const float* Yp, const float* wq, const float* ta, float* out,
                               int Tf, int B, int C, int M, float pf_alpha,
                               float one_minus_pf_alpha, float pf_gain, float spectral_floor,
                               int real_mode, int pf_min_frames, cudaStream_t stream);

// K7's launch for B utterances of C channels and M lanes on the current card:
// blocks, threads a block, frames of a warp's ring, dynamic shared memory,
// the kernel's registers and local memory (bytes) a thread, blocks per SM
int dsr_zelinski_apply_shape(int B, int C, int M, int* blocks, int* threads, int* frames,
                             int* smem_bytes, int* regs, int* local_bytes, int* blocks_per_sm);

// the McCowan (kind 0 real part, 1 modulus), Lefkimmiatis (2, 3) and APAB (4)
// postfilters (no TPU kernel: the JAX package's XLA scans) on X [Tf, B, C, M]
// and the beamformer output Yp [Tf, B, M], or, where Yp is null, Y = wqH X
// formed in the kernel; wq, ta: interleaved complex64 [F, C]; k: the per-bin
// constants [K, F] (null for APAB); pf_norm = 2 / (C (C-1))
int dsr_coherence_postfilter(const float* Xp, const float* Yp, const float* wq, const float* ta,
                             const float* k, float* out, int Tf, int B, int C, int M, int kind,
                             float pf_alpha, float one_minus_pf_alpha, float pf_norm,
                             float spectral_floor, int pf_min_frames, cudaStream_t stream);

// wq, ta: interleaved complex64 [F, C]; tw: as for dsr_analysis_tm; out
// [B, T_out * D]; rows: the caller's analysis rows per frame tile, refused
// unless the kernel's own
int dsr_fw_mono(const float* x, const float* hr, const float* tw, const float* gf,
                const float* wq, const float* ta, float* out, int B, int C, int T, int Tf, int M,
                int m, int R, int D, int shift, int pd, int T_out, int rows, float pf_alpha,
                float one_minus_pf_alpha, float pf_gain, float spectral_floor, int real_mode,
                int pf_min_frames, cudaStream_t stream);

// K4 (samples out, [B, T_out * D]) and K5 (packed beamformed spectrum out,
// [Tf, B, M]): the GSC-RLS + Zelinski chain from raw samples in one launch.
// tw: as for dsr_analysis_tm; wq, ta: interleaved complex64 [F, C]; bm:
// [F, Bc, C]; rows: the caller's analysis rows per frame tile, refused
// unless the kernel's own
int dsr_gsc_mono(const float* x, const float* hr, const float* tw, const float* gf,
                 const float* wq, const float* bm, const float* ta, float* out, int B, int C,
                 int Bc, int T, int Tf, int M, int m, int R, int D, int shift, int pd, int T_out,
                 int rows, float beta, float one_minus_beta, float gamma, float mu, float delta,
                 float inv_delta, float reg_param, float sil_thresh, int constraint_option,
                 float alpha2, float max_wa_l2norm, int min_frames, float pf_alpha,
                 float one_minus_pf_alpha, float pf_gain, float spectral_floor, int real_mode,
                 int pf_min_frames, cudaStream_t stream);

int dsr_gsc_analysis(const float* x, const float* hr, const float* tw, const float* wq,
                     const float* bm, const float* ta, float* out, int B, int C, int Bc, int T,
                     int Tf, int M, int m, int D, int shift, int rows, float beta,
                     float one_minus_beta, float gamma, float mu, float delta, float inv_delta,
                     float reg_param, float sil_thresh, int constraint_option, float alpha2,
                     float max_wa_l2norm, int min_frames, float pf_alpha,
                     float one_minus_pf_alpha, float pf_gain, float spectral_floor,
                     int real_mode, int pf_min_frames, cudaStream_t stream);

// K4 (synth = 1) or K5 (0) at C channels and synthesis halo m*R - 1: the
// kernel's blocks per SM (cudaOccupancyMaxActiveBlocksPerMultiprocessor)
// and dynamic shared bytes per block; returns 0 or an error code
int dsr_gsc_mono_occupancy(int C, int synth, int halo, int* blocks_per_sm, int* smem_bytes);

// K13: v[n, t, i] = sum_k h[k, i] * S[n, t + (m-1-k)*R, i]; S [N, T + (m-1)*R, M],
// h [m, M], v [N, T, M]; m <= 8
int dsr_polyphase_fir(const float* S, const float* h, float* v, int N, int T, int M, int m, int R,
                      cudaStream_t stream);

// kalman = 0: NLMS with p1 = delta, p2 = epsilon; kalman = 1: p1 = beta, p2 = sigma2
int dsr_aec_scan(const float* A, const float* V, float* E, int Tf, int B, int C, int M,
                 int kalman, float p1, float p2, float thr, cudaStream_t stream);

// the one-tap block Kalman canceller: the Kalman recursion with its
// observation noise starting at sigmau2 and its state variance at sigmak2
int dsr_aec_scan_block_kalman(const float* A, const float* V, float* E, int Tf, int B, int C,
                              int M, float beta, float sigmau2, float sigmak2, float thr,
                              cudaStream_t stream);

// the launch that dsr_aec_scan takes for (B, C, M) and its kind (the block
// Kalman entry: kalman = 1's): blocks,
// threads a block, channels a block, dynamic shared memory, the kernel's
// registers a thread and blocks per SM
int dsr_aec_scan_shape(int B, int C, int M, int kalman, int* blocks, int* threads, int* cg,
                       int* smem_bytes, int* regs, int* blocks_per_sm);

// G, R, r: interleaved complex64
int dsr_wpe_stats(const float* Yp, const float* G, float* R, float* r, int Tf, int B, int C,
                  int M, int P, int lowerN, int has_g, cudaStream_t stream);

int dsr_wpe_resid(const float* Yp, const float* G, float* out, int Tf, int B, int C, int M,
                  int P, int lowerN, cudaStream_t stream);

// K10 (with filters) at M = 256 / K11 at M: blocks per SM, dynamic shared
// bytes and threads per block of the launch at C channels, P taps and delay
// lowerN; returns 0 or an error code
int dsr_wpe_stats_occupancy(int C, int P, int lowerN, int* blocks_per_sm, int* smem_bytes,
                            int* threads);
int dsr_wpe_resid_occupancy(int C, int P, int lowerN, int M, int* blocks_per_sm,
                            int* smem_bytes, int* threads);

// R, r, x: interleaved complex64; n <= 40
int dsr_gj_solve(const float* R, const float* r, float* x, int N, int n, cudaStream_t stream);

#ifdef __cplusplus
}
#endif
