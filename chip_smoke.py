#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
     fails when torch sees no CUDA device;
  2. build of the CUDA kernels from distant_speech_recognition_tpu_torch/csrc
     (one nvcc per source, all started together);
  3. each kernel against its plain torch version on the card, at B=8 x 4 ch
     x 2 s: the filterbank and scan kernels (plus the near-silent-bin
     trigger for the scan) and the flagship chain; then the echo canceller
     (NLMS and Kalman, with far-end bins that are zero and a stretch where
     the gate closes), the WPE stats (first and later EM iteration), the
     Gauss-Jordan solve and the WPE residual; the WPE stats and solve are
     held per system (utterance, channel, bin) against that system's own
     scale, and a planted fault that the largest entry hides (R left at
     zero in the systems of small scale) must fail that check;
  4. the flagship path: build_pipeline() with the default device on B=256
     utterances x 4 channels x 10 s, with every kernel's launch count read
     around the call (exactly one each of K1, K2, K3, no other); then each kernel against its plain version at that
     shape, and the path's output against the plain chain;
  5. CUDA-event times of the flagship kernels and path, beside the plain
     versions and one PyTorch call for the GEMM part of each filterbank;
  6. the config-4 path (NLMS AEC -> multichannel WPE -> GSC-RLS + Zelinski):
     build_pipeline() with the default device on the same B=256 x 4 ch x
     10 s plus a far-end playback, launch counts around one forward (each
     kernel exactly as often as the path needs it); each of
     its new kernels against its plain version at that shape and the path's
     output against the plain chain; CUDA-event times of each kernel (beside
     its plain version, its least time on the card and, where one exists, one
     PyTorch call computing the same function) and of the whole path;
  7. torch.profiler over three config-4 forwards: device time per kernel and
     the device's idle share (reported, not checked).
The line before the last two is a JSON object with one entry per kernel
("launches" counts both paths' runs, "launches_by_path" each path's);
the line before the last is the card's name and power limit; the last line
is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time

import numpy as np

FS = 16000
C = 4
SEED = 0
# K12 against its plain version, per system: both eliminate in FP32 without
# pivoting and round differently, so each sits about cond x 6e-8 from the
# exact solution; the loaded systems of the chain's frames have condition
# numbers up to ~1000, and 1e-3 of a system's own max|x| leaves ~10x
GJ_SYS_BUDGET = 1e-3
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s and
# FP32 and FP64 flop/s outside the tensor cores
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 34e12


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return res.stdout.strip().splitlines()[0]


def signal(rng, shape) -> np.ndarray:
    """int16-scale white noise, the scale the adaptive gates are calibrated for."""
    return rng.standard_normal(shape, dtype=np.float32) * np.float32(1500.0)


def bound(nbytes: float, flops: float, flops64: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) for moving ``nbytes`` and doing ``flops``
    FP32 and ``flops64`` FP64 operations, each at its own peak, and which of
    the two (bytes or operations) bounds it."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_f = (flops / FP32_FLOP_S + flops64 / FP64_FLOP_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")

    from distant_speech_recognition_tpu_torch import kernels
    from distant_speech_recognition_tpu_torch.kernels import _build
    from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (
        GSCRLSConfig,
        gsc_postfilter_fused,
    )
    from distant_speech_recognition_tpu_torch.models.aec import kalman_aec, nlms_aec
    # the packed WPE path's loading (with its default constants) and
    # apply-time tap truncation, between the kernels held below
    from distant_speech_recognition_tpu_torch.models.dereverberation import _load as wpe_load
    from distant_speech_recognition_tpu_torch.models.dereverberation import (
        _truncate_taps as wpe_truncate_taps,
    )
    from distant_speech_recognition_tpu_torch.models.dereverberation import wpe_multichannel
    from distant_speech_recognition_tpu_torch.models.fused_scan import (
        analysis_gsc_synthesis,
        gsc_rls_zelinski,
    )
    from distant_speech_recognition_tpu_torch.models.pipeline import (
        PipelineConfig,
        build_pipeline,
    )
    from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_scan
    from distant_speech_recognition_tpu_torch.ops.filterbank import (
        FilterbankParams,
        analysis_half_real_tm,
        num_analysis_frames,
        pack_half,
        synthesis_half_real_tm,
        unpack_half,
    )
    from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
        analysis_tm_fused,
        synthesis_tm_fused,
    )
    from distant_speech_recognition_tpu_torch.ops.wpe_kernels import (
        gj_solve,
        gj_solve_plain,
        resid_plain,
        stats_plain,
        wpe_resid,
        wpe_stats,
    )
    from distant_speech_recognition_tpu_torch.utils import geometry
    from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair

    t_script = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # -- 1. environment ------------------------------------------------------
    log("== 1. environment")
    log("nvidia-smi:", smi_line())
    nvcc = subprocess.run([_build.nvcc_path(), "--version"], check=True, capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    log(f"torch {torch.__version__}  cuda {torch.version.cuda}  nvcc: {nvcc}")
    log(f"device: {torch.cuda.get_device_name(0)}  count={torch.cuda.device_count()}")
    log(f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}  "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    # -- 2. build -------------------------------------------------------------
    log("== 2. build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.1f} s")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line or "Used" in line or "spill" in line:
            log("  ptxas:", line.strip())

    # the flagship configuration of bench.py, and config 4 on top of it
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=float(FS), beamformer="gsc_rls",
                         postfilter="zelinski", pf_min_frames=2)
    cfg4 = dataclasses.replace(cfg, aec="nlms", wpe=True, wpe_iterations=2)
    lower, P = cfg4.wpe_lower, cfg4.wpe_upper - cfg4.wpe_lower + 1
    h, g = load_pair(fb.M, fb.m, fb.r)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    enh = build_pipeline(cfg, mpos, delays, h, g)
    if enh.h.device.type != "cuda":
        raise AssertionError(f"build_pipeline's default device is {enh.h.device}, not the card")
    scan_args = (enh.wqH, enh.BmH, enh.wq_manifold, cfg.rls, cfg.pf_alpha, cfg.pf_type,
                 cfg.pf_min_frames)
    M = fb.M
    F = M // 2 + 1

    def plain_analysis(x):
        return analysis_half_real_tm(x, enh.h, fb, packed=True, A=enh.A)

    def plain_scan(Yr, args=scan_args):
        wqH, BmH, wqm, rls, alpha, pf_type, pf_min = args
        return gsc_postfilter_fused(Yr, None, wqH, BmH, wqm, "rls", rls, alpha, pf_type,
                                    pf_min, True)

    def plain_synthesis(Yp):
        return synthesis_half_real_tm(Yp, enh.g, fb, S=enh.S)

    def plain_chain(x):
        return plain_synthesis(plain_scan(plain_analysis(x)))

    def kernel_chain(x):
        return analysis_gsc_synthesis(x, enh.h, enh.g, fb, *scan_args, A=enh.A, S=enh.S)

    def plain_aec(Ap, Vp, kind="nlms", p1=cfg4.aec_delta, p2=cfg4.aec_epsilon,
                  thr=cfg4.aec_threshold):
        fn = nlms_aec if kind == "nlms" else kalman_aec
        E, _ = fn(unpack_half(Vp)[:, :, None, :], unpack_half(Ap), p1, p2, thr)
        return pack_half(E)

    def frames(Yp):  # packed [Tf, B, C, M] -> complex [B, C, Tf, F]
        return unpack_half(Yp).permute(1, 2, 0, 3)

    def plain_wpe(Yp):
        """The WPE stage of the plain chain: per-utterance `wpe_multichannel`."""
        X = frames(Yp)
        Y = torch.stack([wpe_multichannel(X[b], cfg4.wpe_lower, cfg4.wpe_upper,
                                          cfg4.wpe_iterations, samplerate=cfg4.samplerate)
                         for b in range(X.shape[0])])
        return pack_half(Y.permute(2, 0, 1, 3))

    def plain_chain4(x, play):
        Yr = plain_analysis(x)
        Yr = plain_aec(Yr, plain_analysis(play[:, None, :])[:, :, 0, :])
        return plain_synthesis(plain_scan(plain_wpe(Yr)))

    results = {}

    def per_system(got, ref, lead):
        """Largest over systems (the indices of the first ``lead`` dims) of
        max|got - ref| / max|ref| within the system; a system whose ``ref``
        is all zero must match it exactly."""
        if got.is_complex():
            got, ref = torch.view_as_real(got), torch.view_as_real(ref)
        d = (got - ref).abs().flatten(lead).amax(-1)
        m = ref.abs().flatten(lead).amax(-1)
        rel = torch.where(m > 0, d / m, torch.where(d > 0, torch.inf, 0.0))
        return rel.max().item()

    def compare(name, got, ref, rel_budget, key=None, lead=0, sys_budget=None):
        """Max abs error against ``rel_budget`` x max|ref|.  With ``lead`` > 0
        also every system (an index of the first ``lead`` dims: one
        (utterance, channel, bin) of the WPE statistics or solve) against
        ``sys_budget`` (default ``rel_budget``) x its own max|ref|, so that
        no system hides under the scale of the largest one."""
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        if got.is_complex():
            got, ref = torch.view_as_real(got), torch.view_as_real(ref)
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite values in the kernel output")
        err = (got - ref).abs().max().item()
        budget = rel_budget * ref.abs().max().item()
        ok = err <= budget
        msg = f"  {name}: max_abs_err={err:.6g}  budget={budget:.6g} ({rel_budget:g} x max|ref|)"
        if lead:
            worst = per_system(got, ref, lead)
            sys_budget = rel_budget if sys_budget is None else sys_budget
            ok = ok and worst <= sys_budget
            msg += f"  worst system {worst:.3g} x its max|ref| (budget {sys_budget:g})"
        log(f"{msg}  {'ok' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name}: over budget")
        if key is not None:
            results[key] = max(results.get(key, 0.0), err)
        return err

    # -- 3. kernels against their plain versions -------------------------------
    log("== 3. kernels vs plain torch on the card (B=8, 4 ch, 2 s)")
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(signal(rng, (8, C, 2 * FS))).to(dev)
    Yr_ref = plain_analysis(xs)
    compare("analysis_tm", analysis_tm_fused(xs, enh.h, fb, A=enh.A), Yr_ref, 2e-5,
            "analysis_tm")
    Yp_ref = plain_scan(Yr_ref)
    compare("gsc_rls_zelinski", gsc_rls_zelinski(Yr_ref, *scan_args), Yp_ref, 2e-4,
            "gsc_rls_zelinski")
    # near-silent top bins: the first adapted frame's ||wa||^2 is where
    # max_wa/||wa||^2 overflows to inf (the norm-cap trigger)
    Yns = rng.standard_normal((10, 2, C, M), dtype=np.float32) * np.float32(100.0)
    lo, hi = 3 * M // 8, M // 2
    Yns[..., lo:hi + 1] *= np.float32(1.8e-8)
    Yns[..., lo + M // 2:] *= np.float32(1.8e-8)
    Yns = torch.from_numpy(Yns).to(dev)
    ns_args = (enh.wqH, enh.BmH, enh.wq_manifold, GSCRLSConfig(min_frames=2), 0.6, 1, 0)
    compare("gsc_rls_zelinski near-silent", gsc_rls_zelinski(Yns, *ns_args),
            plain_scan(Yns, ns_args), 2e-4, "gsc_rls_zelinski")
    compare("synthesis_tm", synthesis_tm_fused(Yp_ref, enh.g, fb, S=enh.S),
            plain_synthesis(Yp_ref), 2e-5, "synthesis_tm")
    compare("chain K1->K2->K3", kernel_chain(xs), plain_chain(xs), 3e-4)

    # far end: some bins exactly zero (the guarded quotient) and a stretch
    # 60 dB down, where |V|^2 < threshold and the gate closes
    play_s = torch.from_numpy(signal(rng, (8, 2 * FS))).to(dev)
    Vs = plain_analysis(play_s[:, None, :])[:, :, 0, :].clone()
    Vs[:, 0, 10:20] = 0.0
    Vs[:, 0, F + 9:F + 19] = 0.0
    Vs[40:80, 1:4] *= 1e-3
    n_closed = (unpack_half(Vs).abs() ** 2 <= cfg4.aec_threshold).sum().item()
    log(f"  far end: {n_closed} of {Vs.numel() // M * F} (frame, utterance, bin) gates closed")
    for kind, p1, p2 in (("nlms", cfg4.aec_delta, cfg4.aec_epsilon), ("kalman", 0.95, 1e-3)):
        compare(f"aec_scan {kind}", aec_scan(Yr_ref, Vs, kind, p1, p2, cfg4.aec_threshold),
                plain_aec(Yr_ref, Vs, kind, p1, p2), 1e-4, "aec_scan")
    Ya = plain_aec(Yr_ref, Vs)
    Xa = frames(Ya)
    G0 = torch.zeros((8, C, F, C * P), dtype=torch.complex64, device=dev)
    R0, r0 = stats_plain(Xa, G0, lower, P, False)
    Rk, rk = wpe_stats(Ya, G0, lower, P, has_g=False)
    compare("wpe_stats R, first iteration", Rk, R0, 2e-4, "wpe_stats", lead=3)
    compare("wpe_stats r, first iteration", rk, r0, 2e-4, "wpe_stats", lead=3)
    R0 = wpe_load(R0)
    G1 = gj_solve_plain(R0, r0)
    compare("gj_solve", gj_solve(R0, r0), G1, 1e-4, "gj_solve", lead=3, sys_budget=GJ_SYS_BUDGET)
    # a later iteration with filters that cancel no target (0.1-scale noise,
    # as the JAX package's own kernel test takes them) ...
    Gn = torch.from_numpy((0.1 * (rng.standard_normal((8, C, F, C * P))
                                  + 1j * rng.standard_normal((8, C, F, C * P)))
                           ).astype(np.complex64)).to(dev)
    R1, r1 = stats_plain(Xa, Gn, lower, P, True)
    Rk, rk = wpe_stats(Ya, Gn, lower, P, has_g=True)
    compare("wpe_stats R, later iteration, noise filters", Rk, R1, 2e-4, "wpe_stats", lead=3)
    compare("wpe_stats r, later iteration, noise filters", rk, r1, 2e-4, "wpe_stats", lead=3)
    # ... and with the chain's own first-iteration filters
    R1, r1 = stats_plain(Xa, G1, lower, P, True)
    Rk, rk = wpe_stats(Ya, G1, lower, P, has_g=True)
    compare("wpe_stats R, later iteration", Rk, R1, 2e-4, "wpe_stats", lead=3)
    compare("wpe_stats r, later iteration", rk, r1, 2e-4, "wpe_stats", lead=3)
    # a fault the largest entry hides must fail the per-system form: R left
    # at zero in every system whose own max is under 1e-4 x max|R| (most of
    # them here, the scale of a few cancelling frames sets max|R|)
    sys_max = torch.view_as_real(R1).abs().flatten(3).amax(-1)
    small = sys_max < 1e-4 * sys_max.max()
    planted = torch.where(small[..., None, None], torch.zeros_like(Rk), Rk)
    worst = per_system(planted, R1, 3)
    log(f"  planted fault (R = 0 in the {small.float().mean().item():.1%} of systems under "
        f"1e-4 x max|R|): worst system {worst:.3g} x its max|R|, largest entry "
        f"{(planted - R1).abs().max().item() / R1.abs().max().item():.3g} x max|R| "
        f"(budget 2e-4 for both)")
    if not worst > 2e-4:
        raise AssertionError("the per-system check passes R zeroed in most systems")
    del Gn, planted
    G2 = wpe_truncate_taps(gj_solve_plain(wpe_load(R1), r1), C, lower)
    compare("wpe_resid", wpe_resid(Ya, G2, lower),
            pack_half(resid_plain(Xa, G2, lower).permute(2, 0, 1, 3)), 1e-5, "wpe_resid")
    del xs, Yr_ref, Yp_ref, Yns, play_s, Vs, Ya, Xa, G0, R0, r0, Rk, rk, R1, r1, G1, G2

    # -- 4. flagship path at real size ----------------------------------------
    B, secs = 256, 10
    T = secs * FS
    log(f"== 4. flagship path: build_pipeline() on the card, B={B} x {C} ch x {secs} s")
    x = torch.from_numpy(signal(rng, (B, C, T))).to(dev)
    Tf = num_analysis_frames(fb, T)
    T_out = (Tf - fb.synthesis_delay) * fb.D
    log(f"  input {tuple(x.shape)} ({x.numel() * 4 / 1e6:.0f} MB), Tf={Tf}, "
        f"packed spectrum {Tf * B * C * M * 4 / 1e9:.2f} GB")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        y = enh(x)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = kernels.launch_counts()
    log(f"  forward wall {wall * 1e3:.1f} ms (first call), launches {counts}")
    if tuple(y.shape) != (B, T_out):
        raise AssertionError(f"flagship output {tuple(y.shape)} != {(B, T_out)}")
    if not torch.isfinite(y).all():
        raise AssertionError("flagship output has non-finite values")
    want = dict.fromkeys(counts, 0) | {"analysis_tm": 1, "gsc_rls_zelinski": 1,
                                       "synthesis_tm": 1}
    if counts != want:
        raise AssertionError(f"flagship launches {counts}, the path needs {want}")

    log(f"== 4b. kernels vs plain torch at the flagship shape (B={B}, {C} ch, {secs} s)")
    with torch.no_grad():
        Yr_ref = plain_analysis(x)
        compare("analysis_tm", analysis_tm_fused(x, enh.h, fb, A=enh.A), Yr_ref, 2e-5,
                "analysis_tm")
        Yp_ref = plain_scan(Yr_ref)
        compare("gsc_rls_zelinski", gsc_rls_zelinski(Yr_ref, *scan_args), Yp_ref, 2e-4,
                "gsc_rls_zelinski")
        del Yr_ref
        y_ref = plain_synthesis(Yp_ref)  # = plain_chain(x)
        compare("synthesis_tm", synthesis_tm_fused(Yp_ref, enh.g, fb, S=enh.S), y_ref, 2e-5,
                "synthesis_tm")
        compare("flagship path (build_pipeline) vs plain chain", y, y_ref, 3e-4)
        del Yp_ref, y_ref, y

    # -- 5. times ----------------------------------------------------------------
    log("== 5. CUDA-event times at the flagship shape")

    def time_ms(fn, reps, warmup=1):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    times, library = {}, {}
    with torch.no_grad():
        Yr = analysis_tm_fused(x, enh.h, fb, A=enh.A)
        Yp = gsc_rls_zelinski(Yr, *scan_args)
        times["analysis_tm"] = (time_ms(lambda: analysis_tm_fused(x, enh.h, fb, A=enh.A), 5),
                                time_ms(lambda: plain_analysis(x), 5))
        times["gsc_rls_zelinski"] = (time_ms(lambda: gsc_rls_zelinski(Yr, *scan_args), 5),
                                     time_ms(lambda: plain_scan(Yr), 1))
        times["synthesis_tm"] = (time_ms(lambda: synthesis_tm_fused(Yp, enh.g, fb, S=enh.S), 5),
                                 time_ms(lambda: plain_synthesis(Yp), 5))
        # one PyTorch call for the GEMM part of each filterbank kernel
        W = torch.randn((Tf * B * C, M), device=dev)
        library["analysis_tm"] = time_ms(lambda: torch.matmul(W, enh.A), 5)
        library["synthesis_tm"] = time_ms(lambda: torch.matmul(Yp.reshape(-1, M), enh.S), 5)
        library["gsc_rls_zelinski"] = None
        del Yr, Yp, W
        path_ms = time_ms(lambda: enh(x), 3)
        plain_path_ms = time_ms(lambda: plain_chain(x), 1)
    audio_s = B * secs
    for name in ("analysis_tm", "gsc_rls_zelinski", "synthesis_tm"):
        k_ms, p_ms = times[name]
        lib = library[name]
        log(f"  {name}: kernel {k_ms:.3f} ms   plain {p_ms:.3f} ms   "
            f"library {'-' if lib is None else f'{lib:.3f} ms (GEMM part only)'}")
    log(f"  flagship path: kernels {path_ms:.3f} ms "
        f"({audio_s / (path_ms / 1e3):.1f} audio-s/s/GPU)   plain {plain_path_ms:.3f} ms "
        f"({audio_s / (plain_path_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # -- 6. config-4 path at real size -----------------------------------------
    log(f"== 6. config-4 path (nlms AEC -> WPE -> GSC-RLS + Zelinski): build_pipeline() "
        f"on the card, B={B} x {C} ch x {secs} s + far end")
    enh4 = build_pipeline(cfg4, mpos, delays, h, g)
    play = torch.from_numpy(signal(rng, (B, T))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        y4 = enh4(x, play)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts4 = kernels.launch_counts()
    log(f"  forward wall {wall * 1e3:.1f} ms (first call), launches {counts4}")
    if tuple(y4.shape) != (B, T_out):
        raise AssertionError(f"config-4 output {tuple(y4.shape)} != {(B, T_out)}")
    if not torch.isfinite(y4).all():
        raise AssertionError("config-4 output has non-finite values")
    want = {"analysis_tm": 2, "aec_scan": 1, "wpe_stats": cfg4.wpe_iterations,
            "gj_solve": cfg4.wpe_iterations, "wpe_resid": 1, "gsc_rls_zelinski": 1,
            "synthesis_tm": 1}
    if counts4 != want:
        raise AssertionError(f"config-4 launches {counts4}, the path needs {want}")

    log(f"== 6b. new kernels vs plain torch at the config-4 shape (B={B}, {C} ch, {secs} s)")
    with torch.no_grad():
        Yr = analysis_tm_fused(x, enh4.h, fb, A=enh4.A)
        Vp = analysis_tm_fused(play[:, None, :], enh4.h, fb, A=enh4.A)[:, :, 0, :]
        Ya_ref = plain_aec(Yr, Vp)
        compare("aec_scan", aec_scan(Yr, Vp, "nlms", cfg4.aec_delta, cfg4.aec_epsilon,
                                     cfg4.aec_threshold), Ya_ref, 1e-4, "aec_scan")
        del Yr
        G0 = torch.zeros((B, C, F, C * P), dtype=torch.complex64, device=dev)
        Xa = frames(Ya_ref)
        R, r = stats_plain(Xa, G0, lower, P, False)
        Rk, rk = wpe_stats(Ya_ref, G0, lower, P, False)
        compare("wpe_stats R, first iteration", Rk, R, 2e-4, "wpe_stats", lead=3)
        compare("wpe_stats r, first iteration", rk, r, 2e-4, "wpe_stats", lead=3)
        del Rk, rk
        R = wpe_load(R)
        G1 = gj_solve_plain(R, r)
        compare("gj_solve", gj_solve(R, r), G1, 1e-4, "gj_solve", lead=3,
                sys_budget=GJ_SYS_BUDGET)
        R, r = stats_plain(Xa, G1, lower, P, True)
        Rk, rk = wpe_stats(Ya_ref, G1, lower, P, True)
        compare("wpe_stats R, later iteration", Rk, R, 2e-4, "wpe_stats", lead=3)
        compare("wpe_stats r, later iteration", rk, r, 2e-4, "wpe_stats", lead=3)
        del Rk, rk
        G2 = wpe_truncate_taps(gj_solve_plain(wpe_load(R), r), C, lower)
        del R, r
        compare("wpe_resid", wpe_resid(Ya_ref, G2, lower),
                pack_half(resid_plain(Xa, G2, lower).permute(2, 0, 1, 3)), 1e-5, "wpe_resid")
        del Xa
        y4_ref = plain_chain4(x, play)
        compare("config-4 path (build_pipeline) vs plain chain", y4, y4_ref, 3e-4)
        del y4, y4_ref

    log("== 6c. CUDA-event times at the config-4 shape")
    with torch.no_grad():
        Ya = Ya_ref
        times["aec_scan"] = (
            time_ms(lambda: aec_scan(Ya, Vp, "nlms", cfg4.aec_delta, cfg4.aec_epsilon,
                                     cfg4.aec_threshold), 5),
            time_ms(lambda: plain_aec(Ya, Vp), 1))
        library["aec_scan"] = None
        times["wpe_stats"] = (time_ms(lambda: wpe_stats(Ya, G1, lower, P, True), 3),
                              time_ms(lambda: stats_plain(frames(Ya), G1, lower, P, True), 1))
        # one batched matmul of the weighted lag matrix with the lag matrix on a
        # 16-utterance chunk, scaled to B (the lag construction excluded)
        Xc = frames(Ya[:, :16])
        L = torch.stack([torch.nn.functional.pad(Xc, (0, 0, lower + dp, 0))[:, :, :Tf]
                         for dp in range(P)], dim=-1)  # [16, C, Tf, F, P]
        L = L.permute(0, 3, 1, 4, 2).reshape(16, F, C * P, Tf)  # [16, F, CP, Tf]
        Lw = L[:, None] * torch.rand((16, C, F, 1, Tf), device=dev)  # [16, C, F, CP, Tf]
        LH = L.conj().transpose(-1, -2)[:, None].resolve_conj()  # [16, 1, F, Tf, CP]
        library["wpe_stats"] = time_ms(lambda: torch.matmul(Lw, LH), 3) * B / 16
        del Xc, L, Lw, LH
        R, r = wpe_stats(Ya, G1, lower, P, True)
        R = wpe_load(R)
        times["gj_solve"] = (time_ms(lambda: gj_solve(R, r), 5),
                             time_ms(lambda: gj_solve_plain(R, r), 1))
        library["gj_solve"] = time_ms(lambda: torch.linalg.solve(R, r[..., None]), 3)
        n_sys = r.numel() // (C * P)
        del R, r
        times["wpe_resid"] = (time_ms(lambda: wpe_resid(Ya, G2, lower), 5),
                              time_ms(lambda: resid_plain(frames(Ya), G2, lower), 1))
        library["wpe_resid"] = None
        del Ya, Ya_ref, Vp, G0, G1, G2
        path4_ms = time_ms(lambda: enh4(x, play), 3)
        plain_path4_ms = time_ms(lambda: plain_chain4(x, play), 1)
    for name in ("aec_scan", "wpe_stats", "gj_solve", "wpe_resid"):
        k_ms, p_ms = times[name]
        lib = library[name]
        log(f"  {name}: kernel {k_ms:.3f} ms   plain {p_ms:.3f} ms   "
            f"library {'-' if lib is None else f'{lib:.3f} ms'}")
    log(f"  config-4 path: kernels {path4_ms:.3f} ms "
        f"({audio_s / (path4_ms / 1e3):.1f} audio-s/s/GPU)   plain {plain_path4_ms:.3f} ms "
        f"({audio_s / (plain_path4_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory of phase 6 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    log("== 7. torch.profiler over 3 back-to-back config-4 forwards")
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                enh4(x, play)
            torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("  the profiler recorded no device time")
    else:
        busy, (lo, hi) = 0.0, spans[0]
        for s0, s1 in spans[1:]:  # union of the device intervals
            if s0 > hi:
                busy, lo = busy + hi - lo, s0
            hi = max(hi, s1)
        busy += hi - lo
        span = spans[-1][1] - spans[0][0]
        per_kernel = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
                name = re.split(r"[<(]", name)[0].split("::")[-1][:40]
                per_kernel[name] = per_kernel.get(name, 0.0) + e.time_range.elapsed_us()
        log(f"  device busy {busy / 3e3:.3f} ms per forward of a {span / 3e3:.3f} ms span: "
            f"idle {100 * (1 - busy / span):.2f}%")
        for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
            log(f"  {name:40s} {us / 3e3:9.3f} ms per forward  {100 * us / busy:5.1f}%")

    # least time on the card for the work of each timed call, from its shapes
    CP = C * P
    valid = Tf - lower  # frames that carry WPE weight
    Bc = C - 1
    scan_macs = (Bc * C + C + 3 * Bc * Bc + 8 * Bc + Bc * (Bc - 1) // 2 + 2 * C
                 + C * (C - 1) // 2)  # complex multiply-adds per (frame, utterance, bin)
    rows = Tf * B * C
    bounds = {
        "analysis_tm": bound(4 * (B * C * T + rows * M + M * M + fb.N),
                             rows * (2 * M * M + 2 * fb.m * M)),
        "gsc_rls_zelinski": bound(4 * (rows * M + Tf * B * M) + 8 * F * C * (2 + Bc),
                                  8 * scan_macs * Tf * B * F),
        "synthesis_tm": bound(4 * (Tf * B * M + B * T_out + M * M + fb.N),
                              2 * M * M * Tf * B + 2 * fb.m * M * (T_out // fb.D) * B),
        "aec_scan": bound(4 * (2 * rows * M + Tf * B * M), 30 * rows * F),
        # the timed call has filters: its weight residual runs in FP64
        "wpe_stats": bound(4 * rows * M + 8 * B * C * F * (CP * CP + 2 * CP),
                           B * C * F * valid * (8 * CP * (CP + 1) // 2 + 2 * CP + 8 * CP),
                           B * C * F * valid * 8 * CP),
        "gj_solve": bound(8 * n_sys * (CP * CP + 2 * CP), n_sys * 8 * CP * CP * (CP + 1)),
        "wpe_resid": bound(8 * rows * M + 8 * B * C * F * CP, 8 * CP * B * C * F * valid),
    }
    sources = {
        "analysis_tm": ("analysis_tm.cu",
                        "distant_speech_recognition_tpu/ops/pallas_kernels.py:297"),
        "gsc_rls_zelinski": ("gsc_rls_zelinski.cu",
                             "distant_speech_recognition_tpu/models/pallas_fused_scan.py:1204"),
        "synthesis_tm": ("synthesis_tm.cu",
                         "distant_speech_recognition_tpu/ops/pallas_kernels.py:562"),
        "aec_scan": ("aec_scan.cu", "distant_speech_recognition_tpu/ops/pallas_aec.py:144"),
        "wpe_stats": ("wpe_stats.cu", "distant_speech_recognition_tpu/ops/pallas_wpe.py:333"),
        "gj_solve": ("gj_solve.cu", "distant_speech_recognition_tpu/ops/pallas_wpe.py:400"),
        "wpe_resid": ("wpe_resid.cu", "distant_speech_recognition_tpu/ops/pallas_wpe.py:348"),
    }
    rows_json = []
    for name, (src, rep) in sources.items():
        b_ms, b_by = bounds[name]
        log(f"  {name}: bound {b_ms:.3f} ms ({b_by}), kernel at "
            f"{100 * b_ms / times[name][0]:.1f}% of it")
        rows_json.append({
            "name": name, "route": "cuda",
            "source": f"distant_speech_recognition_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": counts[name] + counts4[name],
            "launches_by_path": {"flagship": counts[name], "config4": counts4[name]},
            "max_abs_err": results[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library[name],
        })
    log(f"script time {time.perf_counter() - t_script:.1f} s")
    log(json.dumps({"kernels": rows_json}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
