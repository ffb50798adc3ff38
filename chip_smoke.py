#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
     fails when torch sees no CUDA device;
  2. build of the CUDA kernels from distant_speech_recognition_tpu_torch/csrc;
  3. each kernel against its plain torch version on the card, at B=8 x 4 ch
     x 2 s (plus the near-silent-bin trigger for the scan), and the
     kernel chain against the plain chain;
  4. the main path: build_pipeline(device="cuda") on B=256 utterances x 4
     channels x 10 s, with every kernel's launch count read around the call;
     then each kernel against its plain version at that shape (same
     budgets as phase 3), and the main path's output against the plain chain;
  5. CUDA-event times of each kernel and of the whole path, beside the plain
     versions, at the main-path shape.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

FS = 16000
C = 4
SEED = 0


def log(*args) -> None:
    print(*args, flush=True)


def smi_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    )
    return res.stdout.strip().splitlines()[0]


def signal(rng, B: int, T: int) -> np.ndarray:
    """int16-scale white noise, the scale the adaptive gates are calibrated for."""
    return rng.standard_normal((B, C, T), dtype=np.float32) * np.float32(1500.0)


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
    from distant_speech_recognition_tpu_torch.models.fused_scan import (
        analysis_gsc_synthesis,
        gsc_rls_zelinski,
    )
    from distant_speech_recognition_tpu_torch.models.pipeline import (
        PipelineConfig,
        build_pipeline,
    )
    from distant_speech_recognition_tpu_torch.ops.filterbank import (
        FilterbankParams,
        analysis_half_real_tm,
        num_analysis_frames,
        synthesis_half_real_tm,
    )
    from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
        analysis_tm_fused,
        synthesis_tm_fused,
    )
    from distant_speech_recognition_tpu_torch.utils import geometry
    from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair

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

    # the flagship configuration of bench.py
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=float(FS), beamformer="gsc_rls",
                         postfilter="zelinski", pf_min_frames=2)
    h, g = load_pair(fb.M, fb.m, fb.r)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    enh = build_pipeline(cfg, mpos, delays, h, g, device=dev)
    scan_args = (enh.wqH, enh.BmH, enh.wq_manifold, cfg.rls, cfg.pf_alpha, cfg.pf_type,
                 cfg.pf_min_frames)

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

    results = {}

    def compare(name, got, ref, rel_budget):
        torch.cuda.synchronize()
        if got.shape != ref.shape:
            raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: non-finite values in the kernel output")
        err = (got - ref).abs().max().item()
        budget = rel_budget * ref.abs().max().item()
        log(f"  {name}: max_abs_err={err:.6g}  budget={budget:.6g} "
            f"({rel_budget:g} x max|ref|)  {'ok' if err <= budget else 'FAIL'}")
        if not err <= budget:
            raise AssertionError(f"{name}: error {err} over budget {budget}")
        return err

    # -- 3. kernels against their plain versions -------------------------------
    log("== 3. kernels vs plain torch on the card (B=8, 4 ch, 2 s)")
    rng = np.random.default_rng(SEED)
    xs = torch.from_numpy(signal(rng, 8, 2 * FS)).to(dev)
    Yr_ref = plain_analysis(xs)
    results["analysis_tm"] = compare("analysis_tm", analysis_tm_fused(xs, enh.h, fb, A=enh.A),
                                     Yr_ref, 2e-5)
    Yp_ref = plain_scan(Yr_ref)
    err_scan = compare("gsc_rls_zelinski", gsc_rls_zelinski(Yr_ref, *scan_args), Yp_ref, 2e-4)
    # near-silent top bins: the first adapted frame's ||wa||^2 is where
    # max_wa/||wa||^2 overflows to inf (the norm-cap trigger)
    M = fb.M
    Yns = rng.standard_normal((10, 2, C, M), dtype=np.float32) * np.float32(100.0)
    lo, hi = 3 * M // 8, M // 2
    Yns[..., lo:hi + 1] *= np.float32(1.8e-8)
    Yns[..., lo + M // 2:] *= np.float32(1.8e-8)
    Yns = torch.from_numpy(Yns).to(dev)
    ns_args = (enh.wqH, enh.BmH, enh.wq_manifold, GSCRLSConfig(min_frames=2), 0.6, 1, 0)
    err_ns = compare("gsc_rls_zelinski near-silent", gsc_rls_zelinski(Yns, *ns_args),
                     plain_scan(Yns, ns_args), 2e-4)
    results["gsc_rls_zelinski"] = max(err_scan, err_ns)
    results["synthesis_tm"] = compare("synthesis_tm", synthesis_tm_fused(Yp_ref, enh.g, fb, S=enh.S),
                                      plain_synthesis(Yp_ref), 2e-5)
    compare("chain K1->K2->K3", kernel_chain(xs), plain_chain(xs), 3e-4)
    del xs, Yr_ref, Yp_ref, Yns

    # -- 4. main path at real size --------------------------------------------
    B, secs = 256, 10
    T = secs * FS
    log(f"== 4. main path: build_pipeline(device='cuda'), B={B} x {C} ch x {secs} s")
    x_host = signal(rng, B, T)
    x = torch.from_numpy(x_host).to(dev)
    del x_host
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
        raise AssertionError(f"main path output {tuple(y.shape)} != {(B, T_out)}")
    if not torch.isfinite(y).all():
        raise AssertionError("main path output has non-finite values")
    missing = [k for k, n in counts.items() if n < 1]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    log(f"== 4b. kernels vs plain torch at the main-path shape (B={B}, {C} ch, {secs} s)")
    with torch.no_grad():
        Yr_ref = plain_analysis(x)
        err = compare("analysis_tm", analysis_tm_fused(x, enh.h, fb, A=enh.A), Yr_ref, 2e-5)
        results["analysis_tm"] = max(results["analysis_tm"], err)
        Yp_ref = plain_scan(Yr_ref)
        err = compare("gsc_rls_zelinski", gsc_rls_zelinski(Yr_ref, *scan_args), Yp_ref, 2e-4)
        results["gsc_rls_zelinski"] = max(results["gsc_rls_zelinski"], err)
        del Yr_ref
        y_ref = plain_synthesis(Yp_ref)  # = plain_chain(x)
        err = compare("synthesis_tm", synthesis_tm_fused(Yp_ref, enh.g, fb, S=enh.S), y_ref, 2e-5)
        results["synthesis_tm"] = max(results["synthesis_tm"], err)
        compare("main path (build_pipeline) vs plain chain", y, y_ref, 3e-4)
        del Yp_ref, y_ref, y

    # -- 5. times ----------------------------------------------------------------
    log("== 5. CUDA-event times at the main-path shape")

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

    with torch.no_grad():
        Yr = analysis_tm_fused(x, enh.h, fb, A=enh.A)
        Yp = gsc_rls_zelinski(Yr, *scan_args)
        times = {
            "analysis_tm": (time_ms(lambda: analysis_tm_fused(x, enh.h, fb, A=enh.A), 5),
                            time_ms(lambda: plain_analysis(x), 5)),
            "gsc_rls_zelinski": (time_ms(lambda: gsc_rls_zelinski(Yr, *scan_args), 5),
                                 time_ms(lambda: plain_scan(Yr), 1)),
            "synthesis_tm": (time_ms(lambda: synthesis_tm_fused(Yp, enh.g, fb, S=enh.S), 5),
                             time_ms(lambda: plain_synthesis(Yp), 5)),
        }
        del Yr, Yp
        path_ms = time_ms(lambda: enh(x), 3)
        plain_path_ms = time_ms(lambda: plain_chain(x), 1)
    audio_s = B * secs
    for name, (k_ms, p_ms) in times.items():
        log(f"  {name}: kernel {k_ms:.3f} ms   plain {p_ms:.3f} ms")
    log(f"  whole path: kernels {path_ms:.3f} ms ({audio_s / (path_ms / 1e3):.1f} audio-s/s/GPU)"
        f"   plain {plain_path_ms:.3f} ms ({audio_s / (plain_path_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    sources = {
        "analysis_tm": ("distant_speech_recognition_tpu_torch/csrc/analysis_tm.cu",
                        "distant_speech_recognition_tpu/ops/pallas_kernels.py:297"),
        "gsc_rls_zelinski": ("distant_speech_recognition_tpu_torch/csrc/gsc_rls_zelinski.cu",
                             "distant_speech_recognition_tpu/models/pallas_fused_scan.py:1204"),
        "synthesis_tm": ("distant_speech_recognition_tpu_torch/csrc/synthesis_tm.cu",
                         "distant_speech_recognition_tpu/ops/pallas_kernels.py:562"),
    }
    rows = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": counts[name], "max_abs_err": results[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()
    ]
    log(json.dumps({"kernels": rows}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
    sys.exit(0)
