#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py
(``python3 chip_smoke.py --profile-flagship M`` profiles only the flagship
at filterbank size M, as phase 16 does in a process of its own.)

Phases (each raises on failure; the script then exits non-zero):
  1. environment: the card's name and power limit, torch/CUDA/nvcc versions;
     fails when torch sees no CUDA device;
  2. build of the CUDA kernels from distant_speech_recognition_tpu_torch/csrc
     (one nvcc per source, all started together);
  3. each kernel against its plain torch version on the card, at B=8 x 4 ch
     x 2 s: the filterbank and scan kernels (plus the near-silent-bin
     trigger for the scan) and the flagship chain; then the echo canceller
     (NLMS, Kalman and the one-tap block Kalman, with far-end bins that are
     zero and a stretch where the gate closes), the WPE stats (first and
     later EM iteration, also at C*P = 28, 32 and 40), the Gauss-Jordan
     solve (also at n = 32, 33 and 40 on 20,000 systems, more than the card
     holds warps, with a zero first pivot in every third at n = 40) and the
     WPE residual (also at (C, P) = (8, 5), (5, 8), (7, 5), (6, 6)); the
     WPE stats and solve are held per system (utterance, channel, bin)
     against that system's own scale, and a planted fault that the largest
     entry hides (R left at zero in the systems of small scale) must fail
     that check;
  4. the flagship path: build_pipeline() with the default device on B=256
     utterances x 4 channels x 10 s, with every kernel's launch count read
     around the call (exactly one launch of the one-kernel chain K4, no
     other kernel); then K1, K2 and K3 (config 4 runs them) against their
     plain versions at that shape, the path's output against the plain chain
     and the split kernels K1 -> K2 -> K3, and K5 against the plain loop and
     K1 -> K2;
  5. CUDA-event times of K1, K2, K3, K4 (the flagship path), the chain
     K1 -> K2 -> K3 on the same input, K5 and K5 -> K3, beside the plain
     versions, one PyTorch call for the GEMM part of each filterbank and one
     torch.fft call over the same rows, and K1's dense-product route at
     M = 256 (what K1 ran before its FFT) as a yardstick;
  6. the config-4 path (NLMS AEC -> multichannel WPE -> GSC-RLS + Zelinski):
     build_pipeline() with the default device on the same B=256 x 4 ch x
     10 s plus a far-end playback, launch counts around one forward (each
     kernel exactly as often as the path needs it); each of
     its new kernels against its plain version at that shape (the echo
     canceller also in its Kalman and block Kalman forms, the solve also at
     C*P = 24 and at the widest systems WPE takes, C*P = 40) and the path's
     output against the plain chain; CUDA-event times of each kernel (beside
     its plain version, its least time on the card and, where one exists,
     one PyTorch call computing the same function; both Kalman forms and n
     = 24 and 40 too) and of the whole path; then (6d) the same chain with
     the one-tap block Kalman canceller: launch counts, its first 32
     utterances against the plain chain, its time;
  7. torch.profiler over three flagship and three config-4 forwards: device
     time per kernel and the device's idle share (reported, not checked);
  8. the fixed-weight path (BASELINE configs 1-2, D&S and SD-MVDR +
     Zelinski): build_pipeline() with the default device on B=256 x 4 ch x
     10 s, launch counts around one forward (exactly one fixed-weight
     one-kernel chain, no other kernel), the output and the fixed-weight
     Zelinski kernel against their plain versions at that shape, CUDA-event
     times of the path, the one-kernel chain, the Zelinski kernel alone
     (also at B = 64 and 1, each beside its bound and launch) and
     the chain of split kernels, and a profile of three D&S forwards; then
     the split form of the path, where the one-kernel chain's frame tiles
     cannot hold the synthesis halo (8 channels, r=2, B=32): exactly one
     launch each of the analysis, fixed-weight Zelinski and synthesis
     kernels, held against the plain chain, the Zelinski kernel timed alone
     at that shape beside its bound;
  9. the config-5 path (SRP-PHAT DOA -> per-utterance steered GSC-RLS +
     Zelinski): build_steered_pipeline() with the default device on B=64 x
     4 ch x 10 s from a circular array, one source per utterance placed at a
     direction of the 72-point grid, launch counts around one forward
     (analysis, steered scan, synthesis once each, no other kernel), the
     DOA equal to the plain chain's, the output and the steered scan against
     their plain versions, CUDA-event times of the path, the steered scan and
     the SRP stage, and a profile of three forwards;
 10. the full-band filterbank: analysis_polyphase -> synthesis_polyphase on
     B=256 x 4 ch x 10 s (the strided FIR K13 twice, no other kernel), the
     reconstruction SNR (>= 50 dB), both banks against their plain versions,
     CUDA-event times of the round trip and of K13 alone beside its plain
     version and one grouped conv1d;
 11. BASELINE config 3 (cell gsc-lms-c8-b256: GSC with the NLMS active weight
     vector + Zelinski): build_pipeline() with the default device on B=256
     utterances x 8 channels x 10 s, launch counts around one forward
     (exactly one each of the analysis kernel, the LMS scan's gate pass, the
     LMS scan and the synthesis kernel, nothing else); the gate pass against
     its plain version (flag for flag), the LMS scan against its plain loop
     (2e-4), K1 and K3 at 8 channels against their plain versions and the
     path against the plain chain (3e-4); the LMS scan's launch (lanes a bin,
     blocks, frames staged ahead, registers, spills, blocks per SM);
     CUDA-event times of the path, of the gate pass (also alone at B = 64
     and 1, flag for flag against the plain gates, each beside its bound),
     of the LMS scan (with
     its gate pass) at B = 256, 64 and 1 and without the gain at B = 256,
     and of K1 -> K2 -> K3 and K4
     (the RLS flagship's kernels) on the same input, K2 and K4 beside their
     bounds at 8 channels; the peak device memory and a profile of three
     forwards; then the pipelines without a postfilter at B=8 x 4 ch x 2 s
     (gsc_lms, gsc_rls and ds + "none"): K1, the scan (none for fixed
     weights) and K3 once each, against the plain beamformers alone;
 12. BASELINE config 4 at 8 channels (cell config4-c8-b256: NLMS AEC -> WPE
     with the default taps, C*P = 40 -> GSC-LMS + Zelinski): build_pipeline()
     with the default device on B=256 x 8 ch x 10 s plus a far end, launch
     counts around one forward (K1 twice, K9, K10 and K12 twice each, K11,
     the LMS gate pass and scan, K3, nothing else); K9 (NLMS and block
     Kalman), K10 (both EM iterations), K12 at n = 40 and K11 at (8, 5)
     against their plain versions at that shape (K10/K12 per system), the
     path's first 32 utterances against the plain chain (the plain chain at
     B = 256 would take minutes); CUDA-event times of each widened kernel
     beside its plain version, its bound and its library call (K10/K11: a
     batched torch.matmul, K12: torch.linalg.solve), of the path, its peak
     memory and a profile of three forwards; then (12d) the same input
     through the gsc_rls route (K2 at 8 channels): launch counts, its first
     32 utterances against its plain chain, its time;
 13. the McCowan, Lefkimmiatis and APAB postfilters (one kernel, no TPU
     counterpart): the kernel against its plain version at B=8 x 2 s for
     each kind, REAL and ABS mode, C = 2, 4 and 8, given the beamformer's
     output and forming wqH X itself (1e-4); at B=256 x 4 ch x 10 s each
     kind against its plain version and its CUDA-event times (output given
     and formed), and McCowan's at 8 channels; then five paths through
     build_pipeline() with the default device, each with its launch counts
     (exactly the route's kernels), its first 32 utterances against the
     plain chain (3e-4), its time, audio-s/s and peak memory:
     gsc-rls-mccowan-b256 (K1, K2 without its gain, the postfilter kernel,
     K3), ds-lefkimmiatis-b256, sdmvdr-apab-b256 (K1, the kernel forming
     wqH X, K3), gsc-lms-mccowan-c8-b256 (8 channels: K1, the LMS gate pass
     and scan, the postfilter, K3) and ds-config4-b32 (D&S + Zelinski
     behind the NLMS canceller and WPE: K1 twice, K9, K10 and K12 twice,
     K11, K7, K3);
 14. the filterbank sizes M = 64, 128 and 512 (the one-kernel chains K4/K8
     take M = 256 only, so the split routes run): config1-m64-b256
     (BASELINE config 1: 2-channel D&S without a postfilter at M = 64,
     B=256 x 10 s: K1, the plain product wqH X, K3), flagship-m128-b256 and
     flagship-m512-b256 (GSC-RLS + Zelinski, 4 ch: K1, K2, K3) through
     build_pipeline() with the default device, each with its launch counts
     (exactly the route's kernels), its first 32 utterances against the
     plain chain (3e-4), its time, audio-s/s/GPU and peak memory, config 1
     also with K1 and K3 timed beside their
     bounds, plain versions, torch.fft and GEMM over the same rows; at each
     of the three sizes every kernel of the paths timed at B=256 x 4 ch x 10
     s (the LMS scan at 8 ch) beside its bound: K1 and K3 (with plain,
     torch.fft and GEMM times), K2, K6 (one steering per utterance), K11 at
     (4, 5) (with one batched torch.matmul) and the LMS scan with its gate
     pass (the plain scans timed on the first 32 utterances); then the
     other paths at B=8 x 10 s: config3-m512 (8 ch, LMS), ds-zelinski-m512
     (K7), gsc-rls-mccowan-m64 (the postfilter kernel), config4-m64 and
     config4-m512 (NLMS AEC, WPE: K9, K10, K12, K11 at the new M) with their
     launch counts and the plain chain, and config5-m512 (SRP-PHAT DOA ->
     K6) with the DOA equal to the plain chain's;
 15. the steered routes at config 5's shape (B=64 x 4 ch x 10 s, one
     placed source per utterance, the 72-point grid) through
     build_steered_pipeline() with the default device: steered-ds-zelinski-
     b64 and steered-ds-none-b64 (K1, K7 with one steering per utterance,
     K3), steered-lms-zelinski-b64 and steered-lms-none-b64 (K1, the LMS
     gate pass, the LMS scan with one steering per utterance, K3),
     steered-rls-none-b64 (K1, K6 without its gain, K3) and steered-dsbla-b64
     (GSC-RLS + Zelinski behind the DSBLA DOA protocol: K1, K6, K3), each
     with its launch counts (exactly the route's kernels), its DOA equal to
     the plain chain's, its first 16 utterances against the plain chain
     (3e-4), CUDA-event times of the path, its DOA stage and its beamformer
     stage, audio-s/s/GPU and peak memory; the two per-utterance kernels
     timed alone at that shape beside their bounds and plain loops, K7 with
     one steering per utterance also at the batch four times and at one
     utterance, and the gate pass alone at that shape (its own line), four
     times and one, flag for flag against the plain gates, each beside its
     bound;
 16. the filterbank sizes M = 1024 and 2048 (designed prototypes, stored in
     tests/data/prototypes; the split routes): flagship-m1024-b256 and
     flagship-m2048-b256 (K1, K2, K3), config4-m1024-b256 (NLMS AEC, WPE,
     GSC-RLS + Zelinski), gsc-lms-c8-m2048-b256 (8 ch) and
     ds-zelinski-m2048-b256 (K1, K7, K3) through build_pipeline() with the
     default device at B=256 x 10 s, each with its launch counts (exactly the
     route's kernels), its first 32 utterances against the plain chain
     (3e-4), its time, audio-s/s/GPU and peak memory, the flagships also
     profiled, each in a process of its own (`--profile-flagship M`: late in
     this long process the profiler records few or none of a session's
     kernels); at each of the two sizes every kernel of the paths timed at
     B=256 x 4 ch x 10 s (the LMS scan and its gate pass at 8 ch) beside its
     bound, its plain version (the scans, K10, K11 and K12 on the first 32
     utterances) and torch.fft or one library call; then, at B=8 x 2 s and
     checked only, config 4 at 8 channels (C*P = 40) at 1024, config 4 with
     the block Kalman canceller and D&S + McCowan at 2048, GSC-RLS + Zelinski
     at 1024 with r = 3 (m*R = 32), and config 5 (SRP-PHAT DOA -> K6) at
     1024 and 2048 with the DOA equal to the plain chain's.
Phase 3 also runs, at B=8 (phase 3z), K1 and K3 at M = 64, 128, 512, 1024
and 2048 on noise, on pure tones at bins 0, 1, M/4, M/2 - 1 and M/2 and on
impulse trains, K11 at M = 64, 512, 1024 and 2048 at (4, 5) and (8, 5),
and at M = 512, 1024 and 2048 K2, K6, the LMS scan and its gate pass, K7,
the postfilter kernel, K9 (above 512 in all three kinds), K10 and (above
512) K12 against their plain versions.
Phase 2 also prints K2/K6's launch (blocks, threads, frames a chunk, shared
memory, registers, blocks per SM) at B = 256, 132, 64 and 1 (C = 4) and at
B = 256, C = 8; phase 5 also times K2 on the first 64 utterances and on the
first alone, phase 9 K6 at B = 256 (the batch four times).  Phase 2 also
prints K4's and K5's blocks per SM and shared memory at
C = 2..8, and K10's and K11's blocks per SM, threads and shared memory at the
config-4 shape, at C*P = 24 with lowerN = 32 and at C*P = 40 (C = 8, lowerN 2
and 32; the compiler's registers and spills are in its report above them).  Phase 6c times K10 in both of the
path's calls (the first EM iteration has no filters and no FP64 residual).
Phase 3 also holds, at B=8: K1, K3, K4/K5 and K8 (whose DFTs are FFTs) on pure tones at bins 0,
1, 64, 127 and 128 and on impulse trains, one case per bin (K4 against the
plain chain with sensor noise 20 dB down added, as config 5's inputs); K4
against K1 -> K2 -> K3 and the plain chain and K5 against K1 -> K2 (bit for
bit) and the plain loop (C = 2, 4, 8, delay compensation
0/1/2, both Zelinski modes, pf_min_frames 0 and 2, near-silent top bins);
K13 against its plain version at M in {8, 128, 256}, m in {2, 4}, R in
{1, 2, 4}, and the full-band banks against their plain versions; the
fixed-weight Zelinski kernel against its plain version and the one-kernel
fixed-weight chain against the chain of
split kernels and against the plain chain (D&S, SD-MVDR and LCMV weights,
both Zelinski modes, pf_min_frames 0 and 2), the steered scan against
its plain version with eight different steerings and, given one steering for
all, against the flagship scan bit for bit, and likewise K7 and the LMS scan
with one steering per utterance (C = 2, 4 and 8, both Zelinski modes, the
gain from frame 1, 3 or never) against their plain versions (3e-5, 2e-4)
and, given one steering for all, against K7 and the LMS scan bit for bit;
K7 (both entries) at the edges of its launch, B = 1, 64 and 257, Tf = 1, 2
and one frame either side of its ring of frames, M = 64 to 512, C = 2..8
in turn, against its plain version (3e-5) and, given one steering for all,
the per-utterance entry against the shared one bit for bit; the gate pass
flag for flag at B = 1 and 64 across 1254 and 2100 frames.
The line before the last two is a JSON object with one entry per kernel
("launches" counts the runs of all the paths, "launches_by_path" each
path's, one forward each; K4, K5 and K8 also carry their error against the
split kernels, K1, K3 and K8 the time of torch.fft over the same rows as a
second yardstick, "fft_ms", K1 its dense-product route's time at M = 256,
"dense_route_ms"; K2 and K6 their times and launches at other batches,
"ms_by_batch" and "launch_by_batch", and at 8 channels, "c8"; the LMS scan
its launch, "launch", and its time without the gain, "none_ms" (its times
include its gate pass, which has a row of its own, "lms_gates"); K4 its time
and bound at 8 channels, "c8"; K9 its Kalman form's time,
"kalman_ms", and its block Kalman form's, "block_kalman_ms"; K12 its time,
bound and library time at n = 24 and 40, "n24" and "n40"; K9-K12 their
forms at config 4's 8 channels, "c8"; the postfilter kernel its times by
kind, "by_kind", at 8 channels, "c8", and phase 13's paths, "paths"; K1,
K3, K2, K6, the LMS scan and K11 their times, bounds, plain, torch.fft or
library times and launches at M = 64, 128, 512, 1024 and 2048, and K7, the
postfilter kernel, K9, K10, K12 and the gate pass at 1024 and 2048, "by_M";
the per-utterance
K7 and LMS scan their plain loops' utterances, "plain_ms_utterances", and
the LMS scan's row phase 15's paths, "steered_paths"; K7 (both entries)
and the gate pass their times alone at other batches and shapes, each
beside its bound (K7 also its launch), "by_batch"); the
line before the last is the card's name and
power limit; the last line is {"ok": true, "device": {...}}.  Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np

FS = 16000
C = 4
SEED = 0
# K12 against its plain version, per system: both eliminate in FP32 without
# pivoting and round differently, so each sits about cond x 6e-8 from the
# exact solution; the loaded systems of the chain's frames have condition
# numbers up to ~1000, and 1e-3 of a system's own max|x| leaves ~10x
GJ_SYS_BUDGET = 1e-3
# the Kalman echo canceller's beta and sigma2 where the smoke runs it (the
# JAX package's test values)
KALMAN_P = (0.95, 1e-3)
# H100 SXM peaks (NVIDIA's data sheet, at the 700 W limit): HBM bytes/s, FP32
# flop/s outside the tensor cores, FP64 flop/s on the tensor cores (34e12 on
# the CUDA cores), which K10's FP64 residual runs on
HBM_BYTES_S = 3.35e12
FP32_FLOP_S = 67e12
FP64_FLOP_S = 67e12


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


# the designed Nyquist(M) prototypes at M = 1024 and 2048 (`design_nyquist_pair`
# of (1024, 4, 1 and 3) and (2048, 4, 1 and 2)), stored: designing one pair
# takes half a minute at 1024 and minutes at 2048
PROTO_DIR = Path(__file__).resolve().parent / "tests" / "data" / "prototypes"


def prototypes_at(M: int, r: int = 1) -> tuple:
    """The filterbank prototypes (h, g) at (M, m = 4, r): designed
    (`load_pair`) up to 512, read from `PROTO_DIR` above."""
    from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair, prototype_path

    if M <= 512:
        return load_pair(M, 4, r)
    if not Path(prototype_path("h", M, 4, r, str(PROTO_DIR))).is_file():
        raise FileNotFoundError(f"no stored prototypes for (M, m, r) = ({M}, 4, {r}) in "
                                f"{PROTO_DIR}")
    return load_pair(M, 4, r, proto_dir=str(PROTO_DIR))


def bound(nbytes: float, flops: float, flops64: float = 0.0) -> tuple[float, str]:
    """Least time on the card (ms) for moving ``nbytes`` and doing ``flops``
    FP32 and ``flops64`` FP64 operations, each at its own peak, and which of
    the two (bytes or operations) bounds it."""
    t_b = nbytes / HBM_BYTES_S * 1e3
    t_f = (flops / FP32_FLOP_S + flops64 / FP64_FLOP_S) * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def gj_bound(n: int, n_sys: int) -> tuple[float, str]:
    """K12's least time for ``n_sys`` systems of ``n``: R, r read once, x
    written once.  Step k: n - k quotients of the columns right of the pivot
    (a complex product and two divisions, 8 flops each), and the other n - 1
    rows' complex multiply-adds on those columns (8 each): in all 4 n (n + 1)
    + 4 (n - 1) n (n + 1) = 4 n^2 (n + 1) flops a system."""
    return bound(8 * n_sys * (n * n + 2 * n), n_sys * 4 * n * n * (n + 1))


def profile_path(fn, n: int = 3) -> dict:
    """Device busy time and idle share over ``n`` back-to-back calls of
    ``fn``, and device time per kernel (reported, not checked).  One call
    runs first inside the session and is left out: a session has been seen
    to miss the first call's kernels.  The measured calls' kernels are those
    that start after a marker kernel (aten's ``spin_kernel``) launched
    between the two: the device's clock alone decides, since a kernel has
    been seen to start 0.28 ms before the host's record of the range that
    launched it.  Raises if the session recorded none of the measured
    calls' kernels; returns the busy time, the span and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    with torch.no_grad():
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
            torch.cuda._sleep(1000)
            with record_function("dsr_measured"):
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
    cuda_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e.time_range.start for e in cuda_events if "spin_kernel" in e.name]
    # the device events of the measured calls (the range's own mark on the
    # device timeline is no kernel)
    device = [e for e in cuda_events if marks and e.time_range.start > max(marks)
              and e.name != "dsr_measured"]
    spans = sorted((e.time_range.start, e.time_range.end) for e in device)
    if not spans:
        raise AssertionError(
            f"the profiler recorded no device time for the measured calls: "
            f"{len(cuda_events)} device events ({dict(Counter(e.name[:40] for e in cuda_events))}), "
            f"{len(marks)} markers")
    busy, (lo, hi) = 0.0, spans[0]
    for s0, s1 in spans[1:]:  # union of the device intervals
        if s0 > hi:
            busy, lo = busy + hi - lo, s0
        hi = max(hi, s1)
    busy += hi - lo
    span = spans[-1][1] - spans[0][0]
    per_kernel, recorded = {}, {}
    for e in device:
        name = e.name.replace("(anonymous namespace)::", "").removeprefix("void ")
        name = re.split(r"[<(]", name)[0].split("::")[-1][:40]
        per_kernel[name] = per_kernel.get(name, 0.0) + e.time_range.elapsed_us()
        recorded[name] = recorded.get(name, 0) + 1
    idle = 100 * (1 - busy / span)
    log(f"  device busy {busy / (1e3 * n):.3f} ms per forward of a {span / (1e3 * n):.3f} ms "
        f"span: idle {idle:.2f}%")
    for name, us in sorted(per_kernel.items(), key=lambda kv: -kv[1]):
        log(f"  {name:40s} {us / (1e3 * n):9.3f} ms per forward  {100 * us / busy:5.1f}%  "
            f"({recorded[name]} launches recorded)")
    return dict(busy_ms=busy / (1e3 * n), span_ms=span / (1e3 * n), idle_pct=idle,
                per_kernel_ms={k: v / (1e3 * n) for k, v in per_kernel.items()})


def profile_flagship(M: int) -> None:
    """``--profile-flagship M``: `profile_path` over the flagship (GSC-RLS +
    Zelinski, m = 4, r = 1; `build_pipeline` with the default device) at
    filterbank size M, at phase 16's shape (B=256 x 4 ch x 10 s), in a
    process of its own: late in the smoke's long process the profiler's
    sessions record few or none of their kernels (PERF.md §7).  Its last
    line is the profile as JSON."""
    import torch

    from distant_speech_recognition_tpu_torch.models.pipeline import PipelineConfig, build_pipeline
    from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams
    from distant_speech_recognition_tpu_torch.utils import geometry

    fb = FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=float(FS), beamformer="gsc_rls",
                         postfilter="zelinski", pf_min_frames=2)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    enh = build_pipeline(cfg, mpos, delays, *prototypes_at(M))
    x = torch.from_numpy(signal(np.random.default_rng(SEED), (256, C, 10 * FS))).cuda()
    print(json.dumps(profile_path(lambda: enh(x))), flush=True)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")

    from distant_speech_recognition_tpu_torch import kernels
    from distant_speech_recognition_tpu_torch.kernels import _build
    from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (
        GSCLMSConfig,
        GSCRLSConfig,
        gsc_lms,
        gsc_postfilter_fused,
        gsc_rls,
        gsc_weights,
        lms_silence_gates,
    )
    from distant_speech_recognition_tpu_torch.models.aec import (
        block_kalman_aec,
        kalman_aec,
        nlms_aec,
    )
    from distant_speech_recognition_tpu_torch.models.beamforming import (
        apply_weights,
        array_manifold,
        diffuse_noise_coherence,
        frame_energy_half,
        superdirective_weights,
    )
    from distant_speech_recognition_tpu_torch.models.coherence_postfilter import (
        coherence_postfilter,
        coherence_postfilter_plain,
    )
    # the packed WPE path's loading (with its default constants) and
    # apply-time tap truncation, between the kernels held below
    from distant_speech_recognition_tpu_torch.models.dereverberation import _load as wpe_load
    from distant_speech_recognition_tpu_torch.models.dereverberation import (
        _truncate_taps as wpe_truncate_taps,
    )
    from distant_speech_recognition_tpu_torch.models.dereverberation import wpe_multichannel
    from distant_speech_recognition_tpu_torch.models.fixed_weight import (
        analysis_fw_synthesis,
        zelinski_apply,
        zelinski_apply_plain,
        zelinski_apply_steered,
        zelinski_launch_shape,
    )
    from distant_speech_recognition_tpu_torch.models.fused_scan import (
        NO_POSTFILTER,
        analysis_gsc_rls_zelinski,
        analysis_gsc_synthesis,
        gsc_lms_zelinski,
        gsc_lms_zelinski_steered,
        gsc_rls_zelinski,
        gsc_rls_zelinski_steered,
        lms_gates,
        lms_launch_shape,
        scan_launch_shape,
    )
    from distant_speech_recognition_tpu_torch.models.pipeline import (
        FIXED_WEIGHT,
        PipelineConfig,
        build_pipeline,
    )
    from distant_speech_recognition_tpu_torch.models.postfilter import coherence_constants
    from distant_speech_recognition_tpu_torch.models.steered import (
        build_steered_pipeline,
        steering_weights,
    )
    from distant_speech_recognition_tpu_torch.ops import dft
    from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_launch_shape, aec_scan
    from distant_speech_recognition_tpu_torch.ops.filterbank import (
        FilterbankParams,
        _analysis_with,
        analysis,
        analysis_half_real_tm,
        num_analysis_frames,
        pack_half,
        polyphase_fir_plain,
        synthesis,
        synthesis_half_real_tm,
        unpack_half,
    )
    from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
        analysis_polyphase,
        analysis_tm_fused,
        polyphase_fir,
        synthesis_polyphase,
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
    torch.manual_seed(SEED)
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
    # the one-kernel flagship chains' residency at the flagship's halo (m*R - 1 = 7)
    for synth, name in ((1, "gsc_mono"), (0, "gsc_analysis")):
        for C_ in range(2, 9):
            blocks, smem = ctypes.c_int(), ctypes.c_int()
            _build.check(_build.library().dsr_gsc_mono_occupancy(
                C_, synth, 7, ctypes.addressof(blocks), ctypes.addressof(smem)), name)
            log(f"  {name} C={C_}: {blocks.value} blocks per SM, {smem.value} bytes of dynamic "
                f"shared memory per block")
    # K2/K6's launch at the batches timed below (C = 4, M = 256) and at C = 8
    scan_shapes = {}
    for B_, C_ in ((256, 4), (132, 4), (64, 4), (1, 4), (256, 8)):
        sh = scan_launch_shape(B_, C_, 256)
        scan_shapes[f"B={B_} C={C_}"] = sh
        log(f"  gsc_rls_zelinski(_steered) B={B_} C={C_}: {sh['blocks']} blocks x "
            f"{sh['threads']} threads, {sh['frames']} frames a chunk, {sh['smem_bytes']} bytes of "
            f"dynamic shared memory, {sh['registers']} registers, {sh['blocks_per_sm']} blocks "
            f"per SM")
    # K9's launch at the config-4 shape, and where an utterance takes several blocks
    aec_shapes = {}
    for B_, C_, kind in ((256, 4, "nlms"), (256, 4, "kalman"), (40, 8, "nlms"), (132, 6, "nlms"),
                         (256, 8, "nlms"), (256, 4, "block_kalman")):
        sh = aec_launch_shape(B_, C_, 256, kind)
        aec_shapes[f"B={B_} C={C_} {kind}"] = sh
        log(f"  aec_scan {kind} B={B_} C={C_}: {sh['blocks']} blocks x {sh['threads']} threads "
            f"({sh['cg']} channels a block), {sh['smem_bytes']} bytes of dynamic shared memory, "
            f"{sh['registers']} registers, {sh['blocks_per_sm']} blocks per SM")
    # K10 and K11 at the config-4 shape (C = 4, P = 5, lowerN = 2, M = 256), at
    # C*P = 24 with the deepest delay, and at C*P = 40 (config 4 at 8
    # channels, and with the deepest delay)
    for C_, P_, low_ in ((4, 5, 2), (8, 3, 32), (8, 5, 2), (8, 5, 32)):
        for name, fn, extra in (("wpe_stats", "dsr_wpe_stats_occupancy", ()),
                                ("wpe_resid", "dsr_wpe_resid_occupancy", (256,))):
            blocks, smem, nthr = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
            _build.check(getattr(_build.library(), fn)(
                C_, P_, low_, *extra, ctypes.addressof(blocks), ctypes.addressof(smem),
                ctypes.addressof(nthr)), name)
            log(f"  {name} C={C_} P={P_} lowerN={low_}: {blocks.value} blocks per SM, "
                f"{nthr.value} threads, {smem.value} bytes of dynamic shared memory per block")

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
        """The split kernels K1 -> K2 -> K3 (K4 fuses them)."""
        Yr = analysis_tm_fused(x, enh.h, fb, A=enh.A, hr=enh.hr)
        return synthesis_tm_fused(gsc_rls_zelinski(Yr, *scan_args), enh.g, fb, S=enh.S, gf=enh.gf)

    def k4(x):
        return analysis_gsc_synthesis(x, enh.h, enh.g, fb, *scan_args, A=enh.A, S=enh.S,
                                      hr=enh.hr, gf=enh.gf)

    def k5(x):
        return analysis_gsc_rls_zelinski(x, enh.h, fb, *scan_args, A=enh.A, hr=enh.hr)

    def plain_aec(Ap, Vp, kind="nlms", p1=cfg4.aec_delta, p2=cfg4.aec_epsilon,
                  thr=cfg4.aec_threshold):
        V, A = unpack_half(Vp)[:, :, None, :], unpack_half(Ap)
        if kind == "block_kalman":  # one tap, sigmak2 at its default
            E, _ = block_kalman_aec(V, A, 1, p1, p2, threshold=thr)
        else:
            E, _ = (nlms_aec if kind == "nlms" else kalman_aec)(V, A, p1, p2, thr)
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

    def plain_chain4(x, play, kind="nlms", p=(cfg4.aec_delta, cfg4.aec_epsilon)):
        Yr = plain_analysis(x)
        Yr = plain_aec(Yr, plain_analysis(play[:, None, :])[:, :, 0, :], kind, *p)
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

    def hpd_systems(N, n, chunk=16384):
        """Diagonally loaded Hermitian positive-definite systems, as WPE builds
        them, and right-hand sides (complex64, made on the card from its
        generator)."""
        Rs, rs = [], []
        for s0 in range(0, N, chunk):
            k = min(chunk, N - s0)
            L = torch.complex(torch.randn(k, n, 3 * n, device=dev, dtype=torch.float64),
                              torch.randn(k, n, 3 * n, device=dev, dtype=torch.float64))
            R = L @ L.conj().transpose(-1, -2)
            load = torch.diagonal(R, dim1=-2, dim2=-1).abs().amax(-1) * 0.01
            Rs.append((R + load[:, None, None] * torch.eye(n, device=dev)).to(torch.complex64))
            rs.append(torch.complex(torch.randn(k, n, device=dev), torch.randn(k, n, device=dev)))
        return torch.cat(Rs), torch.cat(rs)

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
    for kind, p1, p2 in (("nlms", cfg4.aec_delta, cfg4.aec_epsilon), ("kalman", *KALMAN_P),
                         ("block_kalman", *KALMAN_P)):
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
    # past C*P = 24: K10 at seven, eight and ten tiles a side (C*P = 28, 32,
    # 40 on these 4 channels), both EM iterations
    for P_ in (7, 8, 10):
        Gw = torch.from_numpy((0.1 * (rng.standard_normal((8, C, F, C * P_))
                                      + 1j * rng.standard_normal((8, C, F, C * P_)))
                               ).astype(np.complex64)).to(dev)
        for has_g in (False, True):
            Rw, rw = stats_plain(Xa, Gw, lower, P_, has_g)
            Rk, rk = wpe_stats(Ya, Gw, lower, P_, has_g)
            compare(f"wpe_stats R, C*P={C * P_}, has_g={has_g}", Rk, Rw, 2e-4, "wpe_stats", lead=3)
            compare(f"wpe_stats r, C*P={C * P_}, has_g={has_g}", rk, rw, 2e-4, "wpe_stats", lead=3)
    del Gw, Rw, rw
    # K11 past 24 taps a target (one target a thread; two blocks an
    # utterance's chunk at C >= 5), on packed frames of C channels
    Tf_s = Ya.shape[0]
    for C_, P_ in ((8, 5), (5, 8), (7, 5), (6, 6)):
        Yw = torch.from_numpy(rng.standard_normal((Tf_s, 8, C_, M), dtype=np.float32)
                              * np.float32(30.0)).to(dev)
        Gw = torch.from_numpy((0.1 * (rng.standard_normal((8, C_, F, C_ * P_))
                                      + 1j * rng.standard_normal((8, C_, F, C_ * P_)))
                               ).astype(np.complex64)).to(dev)
        compare(f"wpe_resid C={C_} P={P_}", wpe_resid(Yw, Gw, lower),
                pack_half(resid_plain(frames(Yw), Gw, lower).permute(2, 0, 1, 3)), 1e-5,
                "wpe_resid")
    del Yw, Gw
    # K12 at n = 32, 33 and 40 (rows 32 .. 39 split across four lanes), more
    # systems than the card holds warps, and a zero first pivot at n = 40
    for n_ in (32, 33, 40):
        Rg, rg = hpd_systems(20000, n_)
        if n_ == 40:
            Rg[::3, 0, 0] = 0
        compare(f"gj_solve n={n_}, 20000 systems" + (", every third pivot 0" if n_ == 40 else ""),
                gj_solve(Rg, rg), gj_solve_plain(Rg, rg), 1e-4, "gj_solve", lead=1,
                sys_budget=GJ_SYS_BUDGET)
    del Rg, rg
    del Yp_ref, Yns, play_s, Vs, Ya, Xa, G0, R0, r0, Rk, rk, R1, r1, G1, G2

    # fixed weights (configs 1-2; LCMV with one jammer at 2 pi/3): K7 against
    # its plain version, K8 against the chain of split kernels K1 -> K7 -> K3
    # (2e-4, the JAX package's mono-vs-split budget) and the plain chain (3e-4)
    noise_delays = [geometry.calc_la_delays(mpos[:, :1], azimuth=2 * np.pi / 3)]
    fixed = {bf: build_pipeline(dataclasses.replace(cfg, beamformer=bf), mpos, delays, h, g,
                                noise_delays=noise_delays) for bf in FIXED_WEIGHT}
    Yr_k1 = analysis_tm_fused(xs, enh.h, fb, A=enh.A)
    for bf, enh_f in fixed.items():
        w = (enh_f.wqH, enh_f.wq_manifold)
        for pf_type, pf_min in ((1, 0), (1, 2), (2, 0), (2, 2)):
            a = (cfg.pf_alpha, pf_type, pf_min)
            tag = f"{bf}, pf_type {pf_type}, pf_min_frames {pf_min}"
            Yz_ref = zelinski_apply_plain(Yr_ref, *w, *a)
            compare(f"zelinski_apply {tag}", zelinski_apply(Yr_ref, *w, *a), Yz_ref, 3e-5,
                    "zelinski_apply")
            y8 = analysis_fw_synthesis(xs, enh.h, enh.g, fb, *w, *a, A=enh.A, S=enh.S)
            compare(f"fw_mono vs K1->K7->K3 {tag}", y8,
                    synthesis_tm_fused(zelinski_apply(Yr_k1, *w, *a), enh.g, fb, S=enh.S), 2e-4,
                    "fw_mono_vs_split")
            compare(f"fw_mono vs plain chain {tag}", y8, plain_synthesis(Yz_ref), 3e-4, "fw_mono")
    del Yr_k1, Yz_ref, y8

    # K3's, K1's, K8's and K4/K5's FFTs one bin at a time: packed frames
    # holding only bin f (its phase turning from frame to frame) or the
    # spectra of single impulses for K3; a cosine at bin f's centre (each
    # channel 2 samples later) or one impulse per 256-sample block for the
    # others, so that a wrong twiddle, split, pairing, packing or
    # segment-reversal index fails on a named bin
    w_ds = (fixed["ds"].wqH, fixed["ds"].wq_manifold, cfg.pf_alpha, 1, 2)
    t_in = np.arange(150)[:, None, None]
    amp = 100.0 / (1.0 + np.arange(8))[None, :, None]
    n_t = np.arange(2 * FS)
    A_np = enh.A.double().cpu().numpy()
    for case in ("bin0", "bin1", "bin64", "bin127", "bin128", "impulses"):
        if case == "impulses":
            Yt = A_np[(37 * t_in[:, 0, 0] + 5) % M][:, None, :] * amp
            blocks = np.arange(0, 2 * FS, M)
            xt = np.zeros((8, C, 2 * FS))
            for c in range(C):
                xt[:, c, blocks + (37 * (blocks // M) + 11 * c) % M] = 1500.0
        else:
            f = int(case[3:])
            Yt = np.zeros((150, 8, M))
            Yt[..., f:f + 1] = amp * np.cos(0.7 * t_in + 0.3)
            if 0 < f < M // 2:
                Yt[..., M // 2 + f:M // 2 + f + 1] = amp * np.sin(0.7 * t_in + 0.3)
            xt = np.stack([1500.0 * np.cos(2 * np.pi * f * (n_t - 2 * c) / M + 0.4)
                           for c in range(C)])[None].repeat(8, 0)
        xt *= (1.0 / (1.0 + np.arange(8)))[:, None, None]
        Yt = torch.from_numpy(Yt.astype(np.float32)).to(dev)
        xt = torch.from_numpy(xt.astype(np.float32)).to(dev)
        compare(f"synthesis_tm, {case}", synthesis_tm_fused(Yt, enh.g, fb, S=enh.S),
                plain_synthesis(Yt), 2e-5, "synthesis_tm")
        y8 = analysis_fw_synthesis(xt, enh.h, enh.g, fb, *w_ds, A=enh.A, S=enh.S)
        compare(f"fw_mono vs K1->K7->K3, {case}", y8, synthesis_tm_fused(
            zelinski_apply(analysis_tm_fused(xt, enh.h, fb, A=enh.A), *w_ds), enh.g, fb), 2e-4,
            "fw_mono_vs_split")
        compare(f"fw_mono vs plain chain, {case}", y8,
                plain_synthesis(zelinski_apply_plain(plain_analysis(xt), *w_ds)), 3e-4, "fw_mono")
        Yr_t = analysis_tm_fused(xt, enh.h, fb)
        compare(f"analysis_tm, {case}", Yr_t, plain_analysis(xt), 2e-5, "analysis_tm")
        Yk = gsc_rls_zelinski(Yr_t, *scan_args)
        if not torch.equal(k5(xt), Yk):
            raise AssertionError(f"gsc_analysis differs from K1->K2 ({case}): not bit for bit")
        compare(f"gsc_mono vs K1->K2->K3, {case}", k4(xt), synthesis_tm_fused(Yk, enh.g, fb),
                3e-4, "gsc_mono_vs_split")
        # against the plain chain with sensor noise 20 dB down on every
        # channel: a tone that every channel hears as an exact delayed copy
        # is noise-free coherent input, on which the GSC-RLS recursion
        # amplifies float32 rounding once it adapts (ROADMAP section 3): on
        # the bin-1 tone, adapting from frame 128, K4 and the plain chain
        # part by 7.1e-4 x max|y| (NVIDIA H100 80GB HBM3)
        xn = xt + 0.1 * xt.pow(2).mean(-1, keepdim=True).sqrt() * torch.from_numpy(
            rng.standard_normal(tuple(xt.shape), dtype=np.float32)).to(dev)
        compare(f"gsc_mono vs plain chain, {case} + sensor noise", k4(xn), plain_chain(xn), 3e-4,
                "gsc_mono")
    del A_np, Yt, xt, y8, Yr_t, Yk, xn

    # one steering per utterance (eight directions of a circular 100 mm
    # array): K6 against its plain version; one steering for all: K6 is K2
    ang = 2 * np.pi * np.arange(C) / C
    mpos5 = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    d8 = np.stack([geometry.calc_ca_delays(mpos5, az, np.pi / 2)
                   for az in np.deg2rad(10.0 + 45.0 * np.arange(8))])
    vs8 = array_manifold(M, float(FS), torch.tensor(d8, dtype=torch.float32, device=dev))
    steer8 = steering_weights(vs8)
    scan_tail = scan_args[3:]
    compare("gsc_rls_zelinski_steered, 8 steerings", gsc_rls_zelinski_steered(
        Yr_ref, *steer8, *scan_tail), plain_scan(Yr_ref, steer8 + scan_tail), 2e-4,
        "gsc_rls_zelinski_steered")
    rows = [t.expand((8,) + t.shape) for t in scan_args[:3]]
    same = torch.equal(gsc_rls_zelinski_steered(Yr_ref, *rows, *scan_tail),
                       gsc_rls_zelinski(Yr_ref, *scan_args))
    log(f"  gsc_rls_zelinski_steered, one steering for all, vs gsc_rls_zelinski: "
        f"{'bit-identical' if same else 'DIFFERS'}")
    if not same:
        raise AssertionError("the steered scan with identical rows differs from the flagship scan")
    del vs8, steer8, rows

    # one steering per utterance for the D&S and the GSC-LMS (eight
    # directions of a circular 100 mm array of C_ mics, C_ = 2, 4, 8): the
    # steered K7 and LMS scan against their plain versions, both Zelinski
    # modes, the gain from frame 1, 3 or never, on packed noise with silent
    # opening frames (the LMS gate shut) and an LMS norm cap that fires; one
    # steering for all: each is its shared-weight kernel bit for bit
    lms_p3 = GSCLMSConfig(min_frames=6, slowdown_after=7, max_wa_l2norm=5e-7)
    rng_st = np.random.default_rng(SEED + 3)  # the later phases' inputs stay as they were
    for C_ in (2, 4, 8):
        angC = 2 * np.pi * np.arange(C_) / C_
        mposC = np.c_[100.0 * np.cos(angC), 100.0 * np.sin(angC), np.zeros(C_)]
        dC = np.stack([geometry.calc_ca_delays(mposC, az, np.pi / 2)
                       for az in np.deg2rad(10.0 + 45.0 * np.arange(8))])
        wC = steering_weights(array_manifold(M, float(FS), torch.tensor(
            dC, dtype=torch.float32, device=dev)))
        one = [w[:1].expand_as(w) for w in wC]
        YC = torch.from_numpy(rng_st.standard_normal((60, 8, C_, M), dtype=np.float32)
                              * np.float32(100.0)).to(dev)
        YC[:3] *= 1e-6
        for pf_type in (1, 2):
            for pf_min in (0, 2, NO_POSTFILTER):
                a = (cfg.pf_alpha, pf_type, pf_min)
                tag = f"C={C_}, pf_type {pf_type}, pf_min_frames {pf_min}"
                compare(f"zelinski_apply_steered, 8 steerings, {tag}",
                        zelinski_apply_steered(YC, wC[0], wC[2], *a),
                        zelinski_apply_plain(YC, wC[0], wC[2], *a), 3e-5,
                        "zelinski_apply_steered")
                compare(f"gsc_lms_zelinski_steered, 8 steerings, {tag}",
                        gsc_lms_zelinski_steered(YC, *wC, lms_p3, *a),
                        gsc_postfilter_fused(YC, None, *wC, "lms", lms_p3, *a, True), 2e-4,
                        "gsc_lms_zelinski_steered")
                if not (torch.equal(zelinski_apply_steered(YC, one[0], one[2], *a),
                                    zelinski_apply(YC, wC[0][0], wC[2][0], *a))
                        and torch.equal(gsc_lms_zelinski_steered(YC, *one, lms_p3, *a),
                                        gsc_lms_zelinski(YC, *(w[0] for w in wC), lms_p3, *a))):
                    raise AssertionError(f"a steered kernel given one steering for all differs "
                                         f"from its shared-weight kernel ({tag})")
        log(f"  zelinski_apply_steered / gsc_lms_zelinski_steered, one steering for all, C={C_}: "
            f"bit-identical to zelinski_apply / gsc_lms_zelinski")
    del wC, one, YC

    # K7 at the edges of its launch (a warp a block, 32 bins of one
    # utterance, M/64 + 1 warps an utterance, frames staged a ring ahead in
    # groups of 4): both entries against the plain version at B = 1, 64 and
    # 257, Tf = 1, 2 and one frame either side of the ring, M = 64, 128, 256
    # and 512, C = 2..8 in turn, both Zelinski modes, a silent utterance;
    # given one steering for all, the per-utterance entry is the shared one
    # bit for bit; the gate pass flag for flag at B = 1 and 64 across 1254
    # and 2100 frames
    rng_k7 = np.random.default_rng(SEED + 7)  # the later phases' inputs stay as they were
    k7_edges = ((1, 1, 64), (64, "ring-1", 512), (257, "ring+1", 128), (64, 2, 64),
                (257, "ring-1", 512), (1, "ring+1", 128), (64, "ring+1", 256))
    for i_, (B_, Tf_, M_) in enumerate(k7_edges):
        C_ = 2 + i_ % 7
        ring_ = zelinski_launch_shape(B_, C_, M_)["frames"]
        Tf_ = ring_ + int(Tf_[4:]) if isinstance(Tf_, str) else Tf_
        Y_ = torch.from_numpy(rng_k7.standard_normal((Tf_, B_, C_, M_), dtype=np.float32)
                              * np.float32(100.0)).to(dev)
        if B_ > 1:
            Y_[:, B_ // 2] = 0.0
        d_ = geometry.calc_la_delays(np.c_[np.arange(C_) * 50.0][:, :1], azimuth=np.pi / 3)
        vs_ = array_manifold(M_, float(FS), d_).to(dev)
        angC = 2 * np.pi * np.arange(C_) / C_
        mposC = np.c_[100.0 * np.cos(angC), 100.0 * np.sin(angC), np.zeros(C_)]
        vsb_ = array_manifold(M_, float(FS), torch.tensor(np.stack([
            geometry.calc_ca_delays(mposC, az, np.pi / 2) for az in np.linspace(0.3, 5.9, B_)]),
            dtype=torch.float32, device=dev))
        wq_, wqb_ = vs_.conj().resolve_conj(), vsb_.conj().resolve_conj()
        for pf_type, pf_min in ((1 + i_ % 2, 2), (2 - i_ % 2, NO_POSTFILTER)):
            a = (cfg.pf_alpha, pf_type, pf_min)
            tag = (f"B={B_} Tf={Tf_} (ring {ring_}) M={M_} C={C_}, pf_type {pf_type}, "
                   f"pf_min {pf_min}")
            k7_ = zelinski_apply(Y_, wq_, vs_, *a)
            compare(f"zelinski_apply edge {tag}", k7_, zelinski_apply_plain(Y_, wq_, vs_, *a), 3e-5,
                    "zelinski_apply")
            compare(f"zelinski_apply_steered edge {tag}",
                    zelinski_apply_steered(Y_, wqb_, vsb_, *a),
                    zelinski_apply_plain(Y_, wqb_, vsb_, *a), 3e-5, "zelinski_apply_steered")
            rows_ = [t.expand((B_,) + t.shape) for t in (wq_, vs_)]
            if not torch.equal(zelinski_apply_steered(Y_, *rows_, *a), k7_):
                raise AssertionError(f"zelinski_apply_steered given one steering for all "
                                     f"differs from zelinski_apply ({tag})")
    for B_, Tf_, C_ in ((1, 1254, 4), (64, 1254, 8), (1, 2100, 2), (64, 2100, 2)):
        Y_ = torch.from_numpy(signal(rng_k7, (Tf_, B_, C_, M)) / np.float32(15.0)).to(dev)
        Y_[:3] *= 1e-6
        Y_[500:540, B_ // 2] *= 1e-6
        g_ = lms_gates(Y_, GSCLMSConfig())
        if not torch.equal(g_, lms_silence_gates(Y_, GSCLMSConfig())):
            raise AssertionError(f"lms_gates at B={B_} Tf={Tf_} C={C_} differs from the plain "
                                 f"gates")
        log(f"  lms_gates B={B_} Tf={Tf_} C={C_}: equal to the plain gates, flag for flag "
            f"({int(g_.sum().item())} of {g_.numel()} open)")
    del Y_, vs_, vsb_, wq_, wqb_, rows_, k7_, g_

    # the one-kernel flagship chains: K4 against the split kernels K1 -> K2 ->
    # K3 (3e-4: K3 pairs its synthesis rows in its FFT otherwise than K4) and
    # the plain chain (3e-4), K5 against K1 -> K2 (bit for bit: the same
    # device code in the same order) and the plain loop (2e-4): both
    # Zelinski modes, pf_min_frames 0 and 2, delay compensation 0/1/2, C = 2,
    # 4 and 8 (frame counts that leave a partial last tile of 64 / C frames),
    # the default RLS and one that adapts from frame 8, and a band-limited
    # input whose top bins are near-silent (the norm cap's overflow)
    n_s = xs.shape[-1]
    band = torch.arange(n_s // 2 + 1, device=dev) < 3 * n_s // 8
    xs_bl = torch.fft.irfft(torch.fft.rfft(xs) * band, n=n_s)
    rls8 = GSCRLSConfig(min_frames=8)
    mono_cases = [
        ("C=4, delay comp 2, pf_type 1, pf_min_frames 2", 4, fb, (1, 2), cfg.rls, xs),
        ("C=4, delay comp 0, pf_type 2, pf_min_frames 0", 4,
         dataclasses.replace(fb, delay_compensation_type=0), (2, 0), rls8, xs),
        ("C=4, delay comp 1, pf_type 1, pf_min_frames 0", 4,
         dataclasses.replace(fb, delay_compensation_type=1), (1, 0), rls8, xs),
        ("C=2, pf_type 2, pf_min_frames 2", 2, fb, (2, 2), rls8, xs[:, :2]),
        ("C=8, pf_type 1, pf_min_frames 2", 8, fb, (1, 2), rls8,
         torch.from_numpy(signal(rng, (8, 8, 2 * FS))).to(dev)),
        ("C=4, band-limited input (near-silent top bins)", 4, fb, (1, 0),
         GSCRLSConfig(min_frames=2), xs_bl),
    ]
    for tag, C_, fb_, pf, rls, x_ in mono_cases:
        d_ = geometry.calc_la_delays(np.c_[np.arange(C_) * 50.0, np.zeros((C_, 2))][:, :1],
                                     azimuth=np.pi / 3)
        wq_, bm_ = gsc_weights(M, float(FS), d_, 1)
        w_ = (wq_.to(dev), bm_.to(dev), array_manifold(M, float(FS), d_).to(dev), rls,
              cfg.pf_alpha, *pf)
        h_, g_ = enh.h, enh.g
        Yp_k = gsc_rls_zelinski(analysis_tm_fused(x_, h_, fb_), *w_)
        Yp_plain = plain_scan(analysis_half_real_tm(x_, h_, fb_, packed=True), w_)
        y5 = analysis_gsc_rls_zelinski(x_, h_, fb_, *w_)
        compare(f"gsc_analysis vs K1->K2, {tag}", y5, Yp_k, 2e-4, "gsc_analysis_vs_split")
        if not torch.equal(y5, Yp_k):
            raise AssertionError(f"gsc_analysis differs from K1->K2 ({tag}): not bit for bit")
        compare(f"gsc_analysis vs plain loop, {tag}", y5, Yp_plain, 2e-4, "gsc_analysis")
        y4 = analysis_gsc_synthesis(x_, h_, g_, fb_, *w_)
        compare(f"gsc_mono vs K1->K2->K3, {tag}", y4, synthesis_tm_fused(Yp_k, g_, fb_), 3e-4,
                "gsc_mono_vs_split")
        compare(f"gsc_mono vs plain chain, {tag}", y4,
                synthesis_half_real_tm(Yp_plain, g_, fb_), 3e-4, "gsc_mono")
    del xs_bl, mono_cases, Yp_k, Yp_plain, y4, y5

    # the strided FIR (K13) over its shapes, and the full-band banks it serves
    for M_ in (8, 128, 256):
        for m_ in (2, 4):
            for R_ in (1, 2, 4):
                S_ = torch.from_numpy(signal(rng, (8, 300 + (m_ - 1) * R_, M_))).to(dev)
                h_ = torch.from_numpy(rng.standard_normal((m_, M_), dtype=np.float32)).to(dev)
                compare(f"polyphase_fir M={M_} m={m_} R={R_}", polyphase_fir(S_, h_, m_, R_),
                        polyphase_fir_plain(S_, h_, m_, R_), 2e-5, "polyphase_fir")
    Ys = analysis_polyphase(xs, enh.h, fb)
    compare("analysis_polyphase vs analysis", Ys, analysis(xs, enh.h, fb), 2e-5, "polyphase_fir")
    compare("synthesis_polyphase vs synthesis", synthesis_polyphase(Ys, enh.g, fb),
            synthesis(Ys, enh.g, fb), 2e-5, "polyphase_fir")
    del Ys, S_, h_

    # the other filterbank sizes: K1 and K3 on noise, on pure tones at bins
    # 0, 1, M/4, M/2 - 1 and M/2 and on impulse trains (one impulse an
    # M-sample block), at M = 64, 128, 512, 1024 and 2048; at M = 512, 1024
    # and 2048 (F = 257, 513, 1025) the scans K2, K6 (8 steerings) and LMS
    # with its gate pass, K7 and the postfilter kernel, K9 (NLMS; above 512
    # all three kinds), K10 and (above 512) K12 on K10's systems; K11 at M =
    # 64, 512, 1024 and 2048, at (4, 5) and (8, 5)
    log("== 3z. kernels at M = 64, 128, 512, 1024 and 2048 vs plain torch on the card (B=8, 2 s)")
    for M_ in (64, 128, 512, 1024, 2048):
        fb_ = FilterbankParams(M=M_, m=4, r=1, delay_compensation_type=2)
        h_, g_ = (torch.as_tensor(a, dtype=torch.float32).to(dev) for a in prototypes_at(M_))
        F_ = M_ // 2 + 1
        Yr_ = analysis_half_real_tm(xs, h_, fb_, packed=True)
        compare(f"analysis_tm M={M_}", analysis_tm_fused(xs, h_, fb_), Yr_, 2e-5, "analysis_tm")
        Yn_ = torch.from_numpy(signal(rng, (150, 8, M_)) / np.float32(15.0)).to(dev)
        compare(f"synthesis_tm M={M_}", synthesis_tm_fused(Yn_, g_, fb_),
                synthesis_half_real_tm(Yn_, g_, fb_), 2e-5, "synthesis_tm")
        A_ = dft.analysis_matrix_packed(M_).astype(np.float64)
        t_ = np.arange(150)[:, None, None]
        amp_ = 100.0 / (1.0 + np.arange(8))[None, :, None]
        for f_ in (0, 1, M_ // 4, M_ // 2 - 1, M_ // 2, None):
            if f_ is None:  # impulses
                Yt_ = A_[(37 * t_[:, 0, 0] + 5) % M_][:, None, :] * amp_
                blocks_ = np.arange(0, 2 * FS, M_)
                xt_ = np.zeros((8, C, 2 * FS))
                for c in range(C):
                    pos_ = blocks_ + (37 * (blocks_ // M_) + 11 * c) % M_
                    xt_[:, c, pos_[pos_ < 2 * FS]] = 1500.0
                tag_ = "impulses"
            else:
                Yt_ = np.zeros((150, 8, M_))
                Yt_[..., f_:f_ + 1] = amp_ * np.cos(0.7 * t_ + 0.3)
                if 0 < f_ < M_ // 2:
                    Yt_[..., M_ // 2 + f_:M_ // 2 + f_ + 1] = amp_ * np.sin(0.7 * t_ + 0.3)
                xt_ = np.stack([1500.0 * np.cos(2 * np.pi * f_ * (n_t - 2 * c) / M_ + 0.4)
                                for c in range(C)])[None].repeat(8, 0)
                tag_ = f"bin {f_}"
            xt_ *= (1.0 / (1.0 + np.arange(8)))[:, None, None]
            Yt_ = torch.from_numpy(Yt_.astype(np.float32)).to(dev)
            xt_ = torch.from_numpy(xt_.astype(np.float32)).to(dev)
            compare(f"analysis_tm M={M_}, {tag_}", analysis_tm_fused(xt_, h_, fb_),
                    analysis_half_real_tm(xt_, h_, fb_, packed=True), 2e-5, "analysis_tm")
            compare(f"synthesis_tm M={M_}, {tag_}", synthesis_tm_fused(Yt_, g_, fb_),
                    synthesis_half_real_tm(Yt_, g_, fb_), 2e-5, "synthesis_tm")
        if M_ != 128:  # K11 at (4, 5) and (8, 5): narrow and wide at 64 and 512, wide above
            for C_, P_ in ((4, 5), (8, 5)):
                Yw_ = torch.from_numpy(signal(rng, (Tf_s, 8, C_, M_)) / np.float32(50.0)).to(dev)
                Gw_ = torch.from_numpy((0.1 * (rng.standard_normal((8, C_, F_, C_ * P_))
                                               + 1j * rng.standard_normal((8, C_, F_, C_ * P_)))
                                        ).astype(np.complex64)).to(dev)
                compare(f"wpe_resid M={M_} C={C_} P={P_}", wpe_resid(Yw_, Gw_, lower),
                        pack_half(resid_plain(frames(Yw_), Gw_, lower).permute(2, 0, 1, 3)),
                        1e-5, "wpe_resid")
            del Yw_, Gw_
        if M_ < 512:
            continue
        d_ = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
        wq_, bm_ = gsc_weights(M_, float(FS), d_, 1)
        vs_ = array_manifold(M_, float(FS), d_)
        w_ = (wq_.to(dev), bm_.to(dev), vs_.to(dev))
        rls_ = GSCRLSConfig(min_frames=8)
        compare(f"gsc_rls_zelinski M={M_}", gsc_rls_zelinski(Yr_, *w_, rls_, 0.6, 1, 2),
                gsc_postfilter_fused(Yr_, None, *w_, "rls", rls_, 0.6, 1, 2, True), 2e-4,
                "gsc_rls_zelinski")
        vs8_ = array_manifold(M_, float(FS), torch.tensor(d8, dtype=torch.float32, device=dev))
        st8_ = steering_weights(vs8_)
        compare(f"gsc_rls_zelinski_steered M={M_}, 8 steerings",
                gsc_rls_zelinski_steered(Yr_, *st8_, rls_, 0.6, 1, 2),
                gsc_postfilter_fused(Yr_, None, *st8_, "rls", rls_, 0.6, 1, 2, True), 2e-4,
                "gsc_rls_zelinski_steered")
        lms_ = GSCLMSConfig(min_frames=6, slowdown_after=7)
        compare(f"gsc_lms_zelinski M={M_}", gsc_lms_zelinski(Yr_, *w_, lms_, 0.6, 2, 0),
                gsc_postfilter_fused(Yr_, None, *w_, "lms", lms_, 0.6, 2, 0, True), 2e-4,
                "gsc_lms_zelinski")
        gates_ = lms_gates(Yr_, lms_)
        if not torch.equal(gates_, lms_silence_gates(Yr_, lms_)):
            raise AssertionError(f"lms_gates at M={M_} differs from the plain gates")
        log(f"  lms_gates M={M_}: equal to the plain gates, flag for flag "
            f"({int(gates_.sum().item())} of {gates_.numel()} open)")
        wf_ = (vs_.conj().resolve_conj().to(dev), vs_.to(dev))
        compare(f"zelinski_apply M={M_}", zelinski_apply(Yr_, *wf_, 0.6, 1, 2),
                zelinski_apply_plain(Yr_, *wf_, 0.6, 1, 2), 3e-5, "zelinski_apply")
        Gam_ = diffuse_noise_coherence(mpos, M_, float(FS))
        pc_ = coherence_constants("mccowan", Gam_, vs_, 1).to(dev)
        Yb_ = pack_half(apply_weights(wf_[0], unpack_half(Yr_).movedim(-2, -1)))
        compare(f"coherence_postfilter mccowan M={M_}",
                coherence_postfilter(Yr_, Yb_, *wf_, "mccowan", pc_, 0.6, 1, 2),
                coherence_postfilter_plain(Yr_, Yb_, *wf_, "mccowan", pc_, 0.6, 1, 2), 1e-4,
                "coherence_postfilter")
        Vs_ = analysis_half_real_tm(torch.from_numpy(signal(rng, (8, 1, 2 * FS))).to(dev), h_,
                                    fb_, packed=True)[:, :, 0, :]
        for kind, p1, p2 in (("nlms", cfg4.aec_delta, cfg4.aec_epsilon), ("kalman", *KALMAN_P),
                             ("block_kalman", *KALMAN_P))[:1 if M_ == 512 else 3]:
            compare(f"aec_scan {kind} M={M_}", aec_scan(Yr_, Vs_, kind, p1, p2,
                                                        cfg4.aec_threshold),
                    plain_aec(Yr_, Vs_, kind, p1, p2), 1e-4, "aec_scan")
        Gn_ = torch.from_numpy((0.1 * (rng.standard_normal((8, C, F_, C * P))
                                       + 1j * rng.standard_normal((8, C, F_, C * P)))
                                ).astype(np.complex64)).to(dev)
        Rs_, rs_ = stats_plain(frames(Yr_), Gn_, lower, P, True)
        Rk_, rk_ = wpe_stats(Yr_, Gn_, lower, P, has_g=True)
        compare(f"wpe_stats R M={M_}", Rk_, Rs_, 2e-4, "wpe_stats", lead=3)
        compare(f"wpe_stats r M={M_}", rk_, rs_, 2e-4, "wpe_stats", lead=3)
        if M_ > 512:  # K12 on the statistics' 8 x C x F systems
            Rl_ = wpe_load(Rs_)
            compare(f"gj_solve M={M_}", gj_solve(Rl_, rs_), gj_solve_plain(Rl_, rs_), 1e-4,
                    "gj_solve", lead=3, sys_budget=GJ_SYS_BUDGET)
            del Rl_
        del Vs_, Gn_, Rs_, rs_, Rk_, rk_, Yb_, vs8_, st8_
    del xs, Yr_ref, Yr_, Yn_, Yt_, xt_, A_

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
    want = dict.fromkeys(counts, 0) | {"gsc_mono": 1}
    if counts != want:
        raise AssertionError(f"flagship launches {counts}, the path needs one gsc_mono and "
                             f"nothing else")

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

    def timed(fn):
        """``fn()`` once, with its CUDA-event time in ms."""
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize()
        return out, start.elapsed_time(end)

    # K7 and the LMS gate pass alone at several batches, each beside its
    # least time (bytes: the rows in once, the output out once, the weights):
    # {name: {tag: {"ms", "bound_ms", "bound_by"[, "launch"]}}}
    alone = {"zelinski_apply": {}, "zelinski_apply_steered": {}, "lms_gates": {}}

    def k7_cost(Tf_, B_, Cx, M_, per_utt):
        F_ = M_ // 2 + 1
        return (4 * (Tf_ * B_ * Cx * M_ + Tf_ * B_ * M_) + 16 * F_ * Cx * (B_ if per_utt else 1),
                8 * (3 * Cx + Cx * (Cx - 1) // 2) * Tf_ * B_ * F_)

    def gates_cost(Tf_, B_, M_):
        return 4 * (Tf_ * B_ * M_ + Tf_ * B_), 2 * Tf_ * B_ * M_

    def time_alone(name, tag, fn, cost, launch=None):
        ms_ = time_ms(fn, 5)
        b_ms, b_by = bound(*cost)
        alone[name][tag] = {"ms": ms_, "bound_ms": b_ms, "bound_by": b_by} | (
            {"launch": launch} if launch else {})
        log(f"  {name} alone {tag}: {ms_:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
            f"{100 * b_ms / ms_:.1f}% of it" + (f", launch {launch}" if launch else ""))

    log(f"== 4b. kernels vs plain torch at the flagship shape (B={B}, {C} ch, {secs} s)")
    with torch.no_grad():
        Yr_ref = plain_analysis(x)
        compare("analysis_tm", analysis_tm_fused(x, enh.h, fb, A=enh.A), Yr_ref, 2e-5,
                "analysis_tm")
        # the plain scan runs for seconds: timed here, once, not again in phase 5
        Yp_ref, plain_k2_ms = timed(lambda: plain_scan(Yr_ref))
        compare("gsc_rls_zelinski", gsc_rls_zelinski(Yr_ref, *scan_args), Yp_ref, 2e-4,
                "gsc_rls_zelinski")
        del Yr_ref
        y_ref = plain_synthesis(Yp_ref)  # = plain_chain(x)
        compare("synthesis_tm", synthesis_tm_fused(Yp_ref, enh.g, fb, S=enh.S), y_ref, 2e-5,
                "synthesis_tm")
        compare("flagship path (build_pipeline, gsc_mono) vs plain chain", y, y_ref, 3e-4,
                "gsc_mono")
        compare("flagship path (gsc_mono) vs K1->K2->K3", y, kernel_chain(x), 3e-4,
                "gsc_mono_vs_split")
        compare("gsc_analysis vs plain loop", k5(x), Yp_ref, 2e-4, "gsc_analysis")
        y5, Yk = k5(x), gsc_rls_zelinski(analysis_tm_fused(x, enh.h, fb, A=enh.A), *scan_args)
        compare("gsc_analysis vs K1->K2", y5, Yk, 2e-4, "gsc_analysis_vs_split")
        if not torch.equal(y5, Yk):
            raise AssertionError("gsc_analysis differs from K1->K2: not bit for bit")
        del y5, Yk
        del Yp_ref, y_ref, y

    # -- 5. times ----------------------------------------------------------------
    log("== 5. CUDA-event times at the flagship shape")

    times, library = {}, {}
    with torch.no_grad():
        Yr = analysis_tm_fused(x, enh.h, fb, A=enh.A)
        Yp = gsc_rls_zelinski(Yr, *scan_args)
        times["analysis_tm"] = (time_ms(lambda: analysis_tm_fused(x, enh.h, fb, A=enh.A), 5),
                                time_ms(lambda: plain_analysis(x), 5))
        times["gsc_rls_zelinski"] = (time_ms(lambda: gsc_rls_zelinski(Yr, *scan_args), 5),
                                     plain_k2_ms)
        Yr64 = Yr[:, :64].contiguous()
        scan_ms = {"gsc_rls_zelinski": {
            "B=256": times["gsc_rls_zelinski"][0],
            "B=64": time_ms(lambda: gsc_rls_zelinski(Yr64, *scan_args), 5),
            # one utterance alone: the latency of the frame chain times Tf
            "B=1": time_ms(lambda: gsc_rls_zelinski(Yr64[:, :1].contiguous(), *scan_args), 5)}}
        del Yr64
        times["synthesis_tm"] = (time_ms(lambda: synthesis_tm_fused(Yp, enh.g, fb, S=enh.S), 5),
                                 time_ms(lambda: plain_synthesis(Yp), 5))
        # the one-kernel chains beside the split kernels on the same input;
        # the plain versions: the plain stages timed here
        plain_a_ms, plain_s_ms = times["analysis_tm"][1], times["synthesis_tm"][1]
        times["gsc_mono"] = (time_ms(lambda: k4(x), 5), plain_a_ms + plain_k2_ms + plain_s_ms)
        times["gsc_analysis"] = (time_ms(lambda: k5(x), 5), plain_a_ms + plain_k2_ms)
        chain_ms = time_ms(lambda: kernel_chain(x), 5)
        k5k3_ms = time_ms(lambda: synthesis_tm_fused(k5(x), enh.g, fb, S=enh.S, gf=enh.gf), 5)
        library["gsc_mono"] = library["gsc_analysis"] = None
        # one PyTorch call for the GEMM part of each filterbank kernel
        W = torch.randn((Tf * B * C, M), device=dev)
        library["analysis_tm"] = time_ms(lambda: torch.matmul(W, enh.A), 5)
        library["synthesis_tm"] = time_ms(lambda: torch.matmul(Yp.reshape(-1, M), enh.S), 5)
        library["gsc_rls_zelinski"] = None
        # the second yardstick: one cuFFT call over the same rows (real in,
        # half spectrum out; half spectrum in, real out)
        Yc = unpack_half(Yp.reshape(-1, M))
        fft_ms = {"analysis_tm": time_ms(lambda: torch.fft.rfft(W, dim=-1), 5),
                  "synthesis_tm": time_ms(lambda: torch.fft.irfft(Yc, n=M, dim=-1), 5)}
        fft_ms["fw_mono"] = fft_ms["analysis_tm"] + fft_ms["synthesis_tm"]
        # K1's dense-product route at M = 256 (what it ran before its FFT): a
        # yardstick, launched through its C entry, not a path's launch
        Yd = torch.empty_like(Yr)
        dense_args = (x.data_ptr(), enh.hr.data_ptr(), enh.A.data_ptr(), Yd.data_ptr(), B * C, T,
                      Tf, M, fb.m, fb.D, fb.laN - (fb.m * fb.R - 1), kernels.stream_handle(dev))
        lib_k = _build.library()
        dense_route = lambda: _build.check(lib_k.dsr_analysis_tm_dense(*dense_args), "dense")
        dense_route()
        compare("analysis_tm dense-product route at M=256 vs K1", Yd, Yr, 2e-5)
        dense_route_ms = time_ms(dense_route, 5)
        del Yr, Yp, W, Yc, Yd
        path_ms = time_ms(lambda: enh(x), 3)
    # the plain chain's time: its three stages as timed above
    plain_path_ms = sum(times[name][1] for name in ("analysis_tm", "gsc_rls_zelinski",
                                                    "synthesis_tm"))
    audio_s = B * secs
    log(f"  gsc_rls_zelinski on the same input's first 64 utterances: kernel "
        f"{scan_ms['gsc_rls_zelinski']['B=64']:.3f} ms; first utterance alone (the frame "
        f"chain's latency x Tf): {scan_ms['gsc_rls_zelinski']['B=1']:.3f} ms")
    for name in ("analysis_tm", "gsc_rls_zelinski", "synthesis_tm", "gsc_analysis", "gsc_mono"):
        k_ms, p_ms = times[name]
        lib = library[name]
        log(f"  {name}: kernel {k_ms:.3f} ms   plain {p_ms:.3f} ms   "
            f"library {'-' if lib is None else f'{lib:.3f} ms (GEMM part only)'}"
            + (f"   torch.fft {fft_ms[name]:.3f} ms" if name in fft_ms else "")
            + (f"   dense-product route {dense_route_ms:.3f} ms" if name == "analysis_tm" else ""))
    log(f"  flagship path (gsc_mono): {path_ms:.3f} ms "
        f"({audio_s / (path_ms / 1e3):.1f} audio-s/s/GPU)   plain {plain_path_ms:.3f} ms "
        f"({audio_s / (plain_path_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  same input: K1->K2->K3 {chain_ms:.3f} ms ({audio_s / (chain_ms / 1e3):.1f} "
        f"audio-s/s/GPU)   gsc_analysis->K3 {k5k3_ms:.3f} ms")
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
    want = dict.fromkeys(counts4, 0) | {
        "analysis_tm": 2, "aec_scan": 1, "wpe_stats": cfg4.wpe_iterations,
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
        # the Kalman form at the same shape (config 4 runs NLMS)
        compare("aec_scan kalman", aec_scan(Yr, Vp, "kalman", *KALMAN_P, cfg4.aec_threshold),
                plain_aec(Yr, Vp, "kalman", *KALMAN_P), 1e-4, "aec_scan")
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
        # the solve at the widest systems WPE took before 8 channels, C*P = 24
        # (P + 1 taps), and at the widest it takes now, C*P = 40 (10 taps)
        R24, r24 = wpe_stats(Ya_ref, torch.zeros((B, C, F, C * (P + 1)), dtype=torch.complex64,
                                                 device=dev), lower, P + 1, False)
        R24 = wpe_load(R24)
        compare("gj_solve n=24", gj_solve(R24, r24), gj_solve_plain(R24, r24), 1e-4, "gj_solve",
                lead=3, sys_budget=GJ_SYS_BUDGET)
        R40, r40 = wpe_stats(Ya_ref, torch.zeros((B, C, F, C * 10), dtype=torch.complex64,
                                                 device=dev), lower, 10, False)
        R40 = wpe_load(R40)
        compare("gj_solve n=40", gj_solve(R40, r40), gj_solve_plain(R40, r40), 1e-4, "gj_solve",
                lead=3, sys_budget=GJ_SYS_BUDGET)
        compare("wpe_resid", wpe_resid(Ya_ref, G2, lower),
                pack_half(resid_plain(Xa, G2, lower).permute(2, 0, 1, 3)), 1e-5, "wpe_resid")
        del Xa
        y4_ref, plain_path4_ms = timed(lambda: plain_chain4(x, play))
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
        kalman_ms = (time_ms(lambda: aec_scan(Ya, Vp, "kalman", *KALMAN_P, cfg4.aec_threshold), 5),
                     time_ms(lambda: plain_aec(Ya, Vp, "kalman", *KALMAN_P), 1))
        block_kalman_ms = (
            time_ms(lambda: aec_scan(Ya, Vp, "block_kalman", *KALMAN_P, cfg4.aec_threshold), 5),
            time_ms(lambda: plain_aec(Ya, Vp, "block_kalman", *KALMAN_P), 1))
        # both of the path's calls: the first EM iteration (no filters, no
        # FP64 residual) and the later one
        stats_first_ms = time_ms(lambda: wpe_stats(Ya, G0, lower, P, False), 3)
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
        # K11's prediction conj(G) . lags as one batched matmul of the filters
        # with the same lag matrix, scaled likewise
        G16 = G2[:16].conj()[:, :, :, None, :].resolve_conj()  # [16, C, F, 1, CP]
        library["wpe_resid"] = time_ms(lambda: torch.matmul(G16, L[:, None]), 3) * B / 16
        del Xc, L, Lw, LH, G16
        R, r = wpe_stats(Ya, G1, lower, P, True)
        R = wpe_load(R)
        times["gj_solve"] = (time_ms(lambda: gj_solve(R, r), 5),
                             time_ms(lambda: gj_solve_plain(R, r), 1))
        library["gj_solve"] = time_ms(lambda: torch.linalg.solve(R, r[..., None]), 3)
        n_sys = r.numel() // (C * P)
        del R, r
        gj24_ms = (time_ms(lambda: gj_solve(R24, r24), 5),
                   time_ms(lambda: gj_solve_plain(R24, r24), 1),
                   time_ms(lambda: torch.linalg.solve(R24, r24[..., None]), 3))
        del R24, r24
        gj40_ms = (time_ms(lambda: gj_solve(R40, r40), 5),
                   time_ms(lambda: gj_solve_plain(R40, r40), 1),
                   time_ms(lambda: torch.linalg.solve(R40, r40[..., None]), 3))
        n_sys40 = r40.numel() // 40
        del R40, r40
        times["wpe_resid"] = (time_ms(lambda: wpe_resid(Ya, G2, lower), 5),
                              time_ms(lambda: resid_plain(frames(Ya), G2, lower), 1))
        del Ya, Ya_ref, Vp, G0, G1, G2
        path4_ms = time_ms(lambda: enh4(x, play), 3)
    for name in ("aec_scan", "wpe_stats", "gj_solve", "wpe_resid"):
        k_ms, p_ms = times[name]
        lib = library[name]
        log(f"  {name}: kernel {k_ms:.3f} ms   plain {p_ms:.3f} ms   "
            f"library {'-' if lib is None else f'{lib:.3f} ms'}")
    log(f"  aec_scan kalman: kernel {kalman_ms[0]:.3f} ms   plain {kalman_ms[1]:.3f} ms")
    log(f"  aec_scan block_kalman: kernel {block_kalman_ms[0]:.3f} ms   plain "
        f"{block_kalman_ms[1]:.3f} ms")
    log(f"  gj_solve n=24: kernel {gj24_ms[0]:.3f} ms   plain {gj24_ms[1]:.3f} ms   "
        f"library {gj24_ms[2]:.3f} ms")
    log(f"  gj_solve n=40 ({n_sys40} systems): kernel {gj40_ms[0]:.3f} ms   plain "
        f"{gj40_ms[1]:.3f} ms   library {gj40_ms[2]:.3f} ms")
    log(f"  wpe_stats, first EM iteration (no filters): kernel {stats_first_ms:.3f} ms")
    log(f"  config-4 path: kernels {path4_ms:.3f} ms "
        f"({audio_s / (path4_ms / 1e3):.1f} audio-s/s/GPU)   plain {plain_path4_ms:.3f} ms "
        f"({audio_s / (plain_path4_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory of phase 6 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")

    # the one-tap block Kalman canceller in config 4's chain (beta 0.95,
    # sigmau2 1e-3, sigmak2 5): the Kalman kernel from another initial state
    BK = 32  # utterances held against the plain chain (each is independent of the others)
    log(f"== 6d. config-4 path with aec='block_kalman': build_pipeline() on the card, B={B} x "
        f"{C} ch x {secs} s + far end; the first {BK} utterances against the plain chain")
    cfg4bk = dataclasses.replace(cfg4, aec="block_kalman", aec_delta=KALMAN_P[0],
                                 aec_epsilon=KALMAN_P[1])
    enh4bk = build_pipeline(cfg4bk, mpos, delays, h, g)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y4bk = enh4bk(x, play)
    torch.cuda.synchronize()
    counts4bk = kernels.launch_counts()
    if counts4bk != counts4:  # the same kernels as the NLMS chain, as often
        raise AssertionError(f"config-4 block Kalman launches {counts4bk}, the path needs "
                             f"{counts4}")
    if tuple(y4bk.shape) != (B, T_out) or not torch.isfinite(y4bk).all():
        raise AssertionError(f"config-4 block Kalman output {tuple(y4bk.shape)} is not finite")
    with torch.no_grad():
        compare(f"config-4 block Kalman path (build_pipeline) vs plain chain, first {BK}",
                y4bk[:BK], plain_chain4(x[:BK], play[:BK], "block_kalman", KALMAN_P), 3e-4)
        path4bk_ms = time_ms(lambda: enh4bk(x, play), 3)
    log(f"  config-4 path with the block Kalman canceller: {path4bk_ms:.3f} ms "
        f"({audio_s / (path4bk_ms / 1e3):.1f} audio-s/s/GPU); aec_scan block_kalman kernel "
        f"{block_kalman_ms[0]:.3f} ms beside nlms {times['aec_scan'][0]:.3f} ms and kalman "
        f"{kalman_ms[0]:.3f} ms")
    del enh4bk, y4bk

    log("== 7. torch.profiler over 3 back-to-back flagship (gsc_mono) forwards")
    profile_path(lambda: enh(x))
    log("   torch.profiler over 3 back-to-back config-4 forwards")
    profile_path(lambda: enh4(x, play))
    del enh4, play

    # -- 8. fixed-weight path at real size ----------------------------------------
    log(f"== 8. fixed-weight path (D&S and SD-MVDR + Zelinski): build_pipeline() on the card, "
        f"B={B} x {C} ch x {secs} s")
    path_fw = {}
    counts_fw = None
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        Yr, plain_a_ms = timed(lambda: plain_analysis(x))
        for bf in ("ds", "sd_mvdr"):
            enh_f = fixed[bf]
            w = (enh_f.wqH, enh_f.wq_manifold, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            y = enh_f(x)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            c_fw = kernels.launch_counts()
            log(f"  {bf} forward wall {wall * 1e3:.1f} ms (first call), launches {c_fw}")
            if tuple(y.shape) != (B, T_out) or not torch.isfinite(y).all():
                raise AssertionError(f"{bf} output {tuple(y.shape)} is not finite {(B, T_out)}")
            if c_fw != dict.fromkeys(c_fw, 0) | {"fw_mono": 1}:
                raise AssertionError(f"{bf} launches {c_fw}, the path needs one fw_mono")
            counts_fw = counts_fw or c_fw
            Yz_ref, plain_k7_ms = timed(lambda: zelinski_apply_plain(Yr, *w))
            compare(f"zelinski_apply {bf}", zelinski_apply(Yr, *w), Yz_ref, 3e-5, "zelinski_apply")
            y_ref, plain_s_ms = timed(lambda: plain_synthesis(Yz_ref))
            compare(f"fixed-weight path {bf} (build_pipeline) vs plain chain", y, y_ref, 3e-4,
                    "fw_mono")
            del y, Yz_ref, y_ref
            # the plain chain's time: its three stages as timed above
            path_fw[bf] = (time_ms(lambda: enh_f(x), 3), plain_a_ms + plain_k7_ms + plain_s_ms)
            if bf == "ds":
                Yk = analysis_tm_fused(x, enh.h, fb, A=enh.A)
                times["zelinski_apply"] = (time_ms(lambda: zelinski_apply(Yk, *w), 5), plain_k7_ms)
                for b_ in (B, 64, 1):
                    Yb_ = Yk if b_ == B else Yk[:, :b_].contiguous()
                    time_alone("zelinski_apply", f"B={b_} C={C}",
                               lambda: zelinski_apply(Yb_, *w), k7_cost(Tf, b_, C, M, False),
                               zelinski_launch_shape(b_, C, M))
                del Yb_
                chain_fw_ms = time_ms(lambda: synthesis_tm_fused(
                    zelinski_apply(analysis_tm_fused(x, enh.h, fb, A=enh.A), *w), enh.g, fb,
                    S=enh.S), 3)
                times["fw_mono"] = (time_ms(lambda: analysis_fw_synthesis(
                    x, enh.h, enh.g, fb, *w, A=enh.A, S=enh.S), 3), path_fw[bf][1])
                del Yk
        del Yr
    library["zelinski_apply"] = None
    # the GEMM part: the analysis and the synthesis DFT products, one torch.matmul
    # each, at the same shapes as phase 5's
    library["fw_mono"] = library["analysis_tm"] + library["synthesis_tm"]
    log(f"  fw_mono: kernel {times['fw_mono'][0]:.3f} ms   K1->K7->K3 chain {chain_fw_ms:.3f} ms   "
        f"plain chain {times['fw_mono'][1]:.3f} ms   library {library['fw_mono']:.3f} ms "
        f"(GEMM part only, two torch.matmul calls)   torch.fft {fft_ms['fw_mono']:.3f} ms "
        f"(rfft + irfft)")
    log(f"  zelinski_apply: kernel {times['zelinski_apply'][0]:.3f} ms   "
        f"plain {times['zelinski_apply'][1]:.3f} ms   library -")
    for bf, (k_ms, p_ms) in path_fw.items():
        log(f"  fixed-weight path {bf}: kernels {k_ms:.3f} ms "
            f"({audio_s / (k_ms / 1e3):.1f} audio-s/s/GPU)   plain {p_ms:.3f} ms "
            f"({audio_s / (p_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory of phase 8 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("  torch.profiler over 3 back-to-back D&S forwards")
    profile_path(lambda: fixed["ds"](x))
    del x, fixed

    # the split form: an 8-channel array with a 4x oversampled bank (r=2)
    # has a 15-frame synthesis halo, more than the 8-frame tiles the
    # one-kernel chain holds at C=8, so the pipeline runs K1 -> K7 -> K3
    B8, C8 = 32, 8
    fb8 = FilterbankParams(M=256, m=4, r=2, delay_compensation_type=2)
    mpos8 = np.c_[np.arange(C8) * 50.0, np.zeros((C8, 2))]
    enh8 = build_pipeline(dataclasses.replace(cfg, fb=fb8, beamformer="ds"), mpos8,
                          geometry.calc_la_delays(mpos8[:, :1], azimuth=np.pi / 3),
                          *load_pair(fb8.M, fb8.m, fb8.r))
    log(f"== 8b. fixed-weight split path (D&S, {C8} ch, m={fb8.m}, r={fb8.r}): build_pipeline() "
        f"on the card, B={B8} x {C8} ch x {secs} s")
    x8 = torch.from_numpy(signal(rng, (B8, C8, T))).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        y8 = enh8(x8)
    torch.cuda.synchronize()
    counts_split = kernels.launch_counts()
    log(f"  launches {counts_split}")
    want = dict.fromkeys(counts_split, 0) | {"analysis_tm": 1, "zelinski_apply": 1,
                                             "synthesis_tm": 1}
    if counts_split != want:
        raise AssertionError(f"split fixed-weight launches {counts_split}, the path needs {want}")
    with torch.no_grad():
        w8 = (enh8.wqH, enh8.wq_manifold, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
        Yr8 = analysis_half_real_tm(x8, enh8.h, fb8, packed=True, A=enh8.A)
        compare("zelinski_apply, 8 channels", zelinski_apply(Yr8, *w8),
                zelinski_apply_plain(Yr8, *w8), 3e-5, "zelinski_apply")
        compare("fixed-weight split path (build_pipeline) vs plain chain", y8,
                synthesis_half_real_tm(zelinski_apply_plain(Yr8, *w8), enh8.g, fb8, S=enh8.S),
                3e-4)
        split_ms = time_ms(lambda: enh8(x8), 3)
        time_alone("zelinski_apply", f"B={B8} C={C8} (split path, r={fb8.r})",
                   lambda: zelinski_apply(Yr8, *w8), k7_cost(Yr8.shape[0], B8, C8, M, False),
                   zelinski_launch_shape(B8, C8, M))
    log(f"  fixed-weight split path: kernels {split_ms:.3f} ms "
        f"({B8 * secs / (split_ms / 1e3):.1f} audio-s/s/GPU)")
    del enh8, x8, y8, Yr8

    # -- 9. config-5 path at real size ---------------------------------------------
    B5 = 64
    phis5 = np.deg2rad(np.arange(0.0, 360.0, 5.0))
    log(f"== 9. config-5 path (SRP-PHAT DOA -> steered GSC-RLS + Zelinski): "
        f"build_steered_pipeline() on the card, B={B5} x {C} ch x {secs} s, circular array "
        f"r=100 mm, {len(phis5)}-point azimuth grid")
    enh5 = build_steered_pipeline(cfg, mpos5, h, g, [np.pi / 2], phis5)
    if enh5.h.device.type != "cuda":
        raise AssertionError(f"build_steered_pipeline's default device is {enh5.h.device}")
    # one source per utterance at a grid direction (channel c hears it
    # round(delay_c * fs) samples late) plus independent sensor noise 20 dB
    # down: without it the four channels are exact copies, the blocking
    # matrix cancels the source to rounding level and the adaptive filter
    # amplifies that rounding (two float32 evaluations of the plain chain
    # then differ by 0.4-0.8 x max|y|, float32 against float64 likewise)
    placed = (7 * np.arange(B5)) % len(phis5)
    src = signal(rng, (B5, T + 64))
    x5 = 0.1 * signal(rng, (B5, C, T))
    for b, gi in enumerate(placed):
        d = geometry.calc_ca_delays(mpos5, phis5[gi], np.pi / 2)
        for c in range(C):
            off = 8 - int(round(float(d[c]) * FS))
            x5[b, c] += src[b, off:off + T]
    x5 = torch.from_numpy(x5).to(dev)
    del src

    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        y5, doa5 = enh5(x5)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts5 = kernels.launch_counts()
    log(f"  forward wall {wall * 1e3:.1f} ms (first call), launches {counts5}")
    if tuple(y5.shape) != (B5, T_out) or not torch.isfinite(y5).all():
        raise AssertionError(f"config-5 output {tuple(y5.shape)} is not finite {(B5, T_out)}")
    want = dict.fromkeys(counts5, 0) | {"analysis_tm": 1, "gsc_rls_zelinski_steered": 1,
                                        "synthesis_tm": 1}
    if counts5 != want:
        raise AssertionError(f"config-5 launches {counts5}, the path needs {want}")
    with torch.no_grad():
        # the plain chain, stage by stage
        Yp5, plain_a_ms = timed(lambda: plain_analysis(x5))
        # the SRP stage (plain torch on either path): DOA grid index and
        # steering per utterance
        (gidx5, vs5), plain_srp_ms = timed(lambda: enh5.steer(Yp5))
        steer5 = steering_weights(vs5)
        Yb_ref, plain_k6_ms = timed(lambda: plain_scan(Yp5, steer5 + scan_tail))
        y5_ref, plain_s_ms = timed(lambda: plain_synthesis(Yb_ref))
        plain_path5_ms = plain_a_ms + plain_srp_ms + plain_k6_ms + plain_s_ms
        doa5_ref = enh5.grid[gidx5]
        same_doa = torch.equal(doa5, doa5_ref)
        n_placed = (doa5[:, 1].cpu() == torch.tensor(phis5[placed], dtype=torch.float32)).sum()
        log(f"  DOA equal to the plain chain's: {same_doa}; at the placed direction: "
            f"{n_placed.item()} of {B5} utterances")
        if not same_doa:
            raise AssertionError("config-5 DOA differs from the plain chain's")
        compare("config-5 path (build_steered_pipeline) vs plain chain", y5, y5_ref, 3e-4)
        del y5, y5_ref
        compare("gsc_rls_zelinski_steered at the config-5 shape",
                gsc_rls_zelinski_steered(Yp5, *steer5, *scan_tail), Yb_ref, 2e-4,
                "gsc_rls_zelinski_steered")
        del Yb_ref
        times["gsc_rls_zelinski_steered"] = (
            time_ms(lambda: gsc_rls_zelinski_steered(Yp5, *steer5, *scan_tail), 3), plain_k6_ms)
        # four copies of the batch, each utterance with its own steering
        Yp5x4 = Yp5.repeat(1, 4, 1, 1)
        steer5x4 = [w.repeat((4,) + (1,) * (w.dim() - 1)) for w in steer5]
        scan_ms["gsc_rls_zelinski_steered"] = {
            "B=64": times["gsc_rls_zelinski_steered"][0],
            "B=256": time_ms(lambda: gsc_rls_zelinski_steered(Yp5x4, *steer5x4, *scan_tail), 3)}
        del Yp5x4, steer5x4
        library["gsc_rls_zelinski_steered"] = None
        srp_ms = time_ms(lambda: steering_weights(enh5.steer(Yp5)[1]), 3)
        path5_ms = time_ms(lambda: enh5(x5), 3)
        del Yp5, steer5, vs5
    audio5_s = B5 * secs
    log(f"  gsc_rls_zelinski_steered: kernel {times['gsc_rls_zelinski_steered'][0]:.3f} ms   "
        f"plain {plain_k6_ms:.3f} ms   library -   at B=256 (the batch four times): "
        f"{scan_ms['gsc_rls_zelinski_steered']['B=256']:.3f} ms")
    log(f"  SRP stage (unpack, SRP-PHAT over {len(phis5)} points, argmax, manifolds, blocking "
        f"matrices): {srp_ms:.3f} ms")
    log(f"  config-5 path: kernels {path5_ms:.3f} ms ({audio5_s / (path5_ms / 1e3):.1f} "
        f"audio-s/s/GPU)   plain {plain_path5_ms:.3f} ms "
        f"({audio5_s / (plain_path5_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory of phase 9 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    log("  torch.profiler over 3 back-to-back config-5 forwards")
    profile_path(lambda: enh5(x5))
    del enh5  # x5 serves phase 15 too

    # -- 10. full-band filterbank round trip at real size ---------------------------
    log(f"== 10. full-band filterbank: analysis_polyphase -> synthesis_polyphase, B={B} x {C} ch "
        f"x {secs} s, prototypes design_nyquist_pair({M}, {fb.m}, {fb.r}) (load_pair's design)")
    torch.cuda.reset_peak_memory_stats()
    x10 = torch.from_numpy(signal(rng, (B, C, T))).to(dev)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    with torch.no_grad():
        Y10 = analysis_polyphase(x10, enh.h, fb)
        y10 = synthesis_polyphase(Y10, enh.g, fb)
    torch.cuda.synchronize()
    counts_fb = kernels.launch_counts()
    log(f"  complex spectrum {tuple(Y10.shape)} ({Y10.numel() * 8 / 1e9:.2f} GB), launches "
        f"{counts_fb}")
    if counts_fb != dict.fromkeys(counts_fb, 0) | {"polyphase_fir": 2}:
        raise AssertionError(f"round-trip launches {counts_fb}, the path needs two polyphase_fir")
    if tuple(y10.shape) != (B, C, T_out) or not torch.isfinite(y10).all():
        raise AssertionError(f"round-trip output {tuple(y10.shape)} is not finite {(B, C, T_out)}")
    # reconstruction SNR away from the edge transients (SKILL.md's criterion)
    seg = slice(2048, T - 2048)
    err = (y10[..., seg] - x10[..., seg]).double()
    snr = 10 * np.log10((x10[..., seg].double() ** 2).mean().item() / (err ** 2).mean().item())
    log(f"  reconstruction SNR {snr:.2f} dB (required >= 50)")
    if not snr >= 50.0:
        raise AssertionError(f"round-trip SNR {snr:.2f} dB < 50 dB")
    del err
    with torch.no_grad():
        Y10_ref, plain_ana_ms = timed(lambda: analysis(x10, enh.h, fb))
        compare("analysis_polyphase vs analysis at B=256", Y10, Y10_ref, 2e-5, "polyphase_fir")
        del Y10_ref
        y10_ref, plain_syn_ms = timed(lambda: synthesis(Y10, enh.g, fb))
        compare("round trip vs plain round trip", y10, y10_ref, 2e-5, "polyphase_fir")
        del Y10, y10, y10_ref
        fb_ms = time_ms(lambda: synthesis_polyphase(analysis_polyphase(x10, enh.h, fb), enh.g, fb),
                        3)
        # K13 alone on the analysis FIR's input (the reversed windows)
        S10 = _analysis_with(lambda S_, *_: S_, x10, enh.h, fb)
        hf10 = enh.h.reshape(fb.m, M)
        v10 = polyphase_fir(S10, hf10, fb.m, fb.R)
        times["polyphase_fir"] = (time_ms(lambda: polyphase_fir(S10, hf10, fb.m, fb.R), 5),
                                  time_ms(lambda: polyphase_fir_plain(S10, hf10, fb.m, fb.R), 5))
        # one PyTorch call for the same function: a grouped, dilated conv1d
        # (taps reversed: conv1d correlates) on the channel-major input
        Sc = S10.reshape(-1, S10.shape[-2], M).transpose(1, 2).contiguous()
        wc = hf10.flip(0).t().contiguous()[:, None, :]  # [M, 1, m]
        conv = lambda: torch.nn.functional.conv1d(Sc, wc, groups=M, dilation=fb.R)
        lib_err = (conv().transpose(1, 2).reshape(v10.shape) - v10).abs().max().item()
        library["polyphase_fir"] = time_ms(conv, 5)
        fir_shape = (tuple(S10.shape), tuple(v10.shape))
        del S10, v10, Sc
    log(f"  polyphase_fir {fir_shape[0]} -> {fir_shape[1]}: kernel "
        f"{times['polyphase_fir'][0]:.3f} ms   plain {times['polyphase_fir'][1]:.3f} ms   "
        f"library {library['polyphase_fir']:.3f} ms (conv1d, groups={M}, dilation={fb.R}; "
        f"max |conv1d - kernel| {lib_err:.3g})")
    log(f"  round trip: kernels {fb_ms:.3f} ms ({B * C * secs / (fb_ms / 1e3):.1f} "
        f"channel-audio-s/s/GPU)   plain {plain_ana_ms + plain_syn_ms:.3f} ms")
    log(f"  peak device memory of phase 10 {torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del x10

    # -- 11. BASELINE config 3 at real size: GSC-LMS + Zelinski, 8 channels -------
    C3 = 8
    cfg3 = dataclasses.replace(cfg, beamformer="gsc_lms")
    mpos3 = np.c_[np.arange(C3) * 50.0, np.zeros((C3, 2))]
    delays3 = geometry.calc_la_delays(mpos3[:, :1], azimuth=np.pi / 3)
    log(f"== 11. config-3 path (gsc-lms-c8-b256: GSC-LMS + Zelinski): build_pipeline() on the "
        f"card, B={B} x {C3} ch x {secs} s")
    enh3 = build_pipeline(cfg3, mpos3, delays3, h, g)
    lms_shape = lms_launch_shape(B, C3, M)
    sh = lms_shape
    log(f"  gsc_lms_zelinski B={B} C={C3}: {sh['lanes']} lanes a bin, {sh['blocks']} "
        f"blocks x {sh['threads']} threads, {sh['frames']} frames staged ahead, "
        f"{sh['smem_bytes']} bytes of dynamic shared memory, {sh['registers']} registers, "
        f"{sh['local_bytes']} bytes of local memory, {sh['blocks_per_sm']} blocks per SM")
    torch.cuda.reset_peak_memory_stats()
    x3 = torch.from_numpy(signal(rng, (B, C3, T))).to(dev)
    log(f"  input {tuple(x3.shape)} ({x3.numel() * 4 / 1e9:.2f} GB), packed spectrum "
        f"{Tf * B * C3 * M * 4 / 1e9:.2f} GB")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        y3 = enh3(x3)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts3 = kernels.launch_counts()
    log(f"  forward wall {wall * 1e3:.1f} ms (first call), launches {counts3}")
    if tuple(y3.shape) != (B, T_out) or not torch.isfinite(y3).all():
        raise AssertionError(f"config-3 output {tuple(y3.shape)} is not finite {(B, T_out)}")
    want = dict.fromkeys(counts3, 0) | {"analysis_tm": 1, "lms_gates": 1,
                                        "gsc_lms_zelinski": 1, "synthesis_tm": 1}
    if counts3 != want:
        raise AssertionError(f"config-3 launches {counts3}, the path needs {want}")
    lms_args = (enh3.wqH, enh3.BmH, enh3.wq_manifold, cfg3.lms, cfg3.pf_alpha, cfg3.pf_type,
                cfg3.pf_min_frames)
    rls_args3 = (enh3.wqH, enh3.BmH, enh3.wq_manifold, cfg.rls, cfg.pf_alpha, cfg.pf_type,
                 cfg.pf_min_frames)

    def plain_lms(Yr):
        wqH, BmH, wqm, lms_cfg, alpha, pf_type, pf_min = lms_args
        return gsc_postfilter_fused(Yr, None, wqH, BmH, wqm, "lms", lms_cfg, alpha, pf_type,
                                    pf_min, True)

    with torch.no_grad():
        Yr3_ref = analysis_half_real_tm(x3, enh3.h, fb, packed=True, A=enh3.A)
        compare("analysis_tm, 8 channels", analysis_tm_fused(x3, enh3.h, fb, A=enh3.A, hr=enh3.hr),
                Yr3_ref, 2e-5, "analysis_tm")
        gates_ref, plain_gates_ms = timed(lambda: lms_silence_gates(Yr3_ref, cfg3.lms))
        compare("lms_gates", lms_gates(Yr3_ref, cfg3.lms), gates_ref, 0.0, "lms_gates")
        del gates_ref
        # the plain loop runs for seconds: timed here, once
        Yp3_ref, plain_lms_ms = timed(lambda: plain_lms(Yr3_ref))
        compare("gsc_lms_zelinski", gsc_lms_zelinski(Yr3_ref, *lms_args), Yp3_ref, 2e-4,
                "gsc_lms_zelinski")
        y3_ref = synthesis_half_real_tm(Yp3_ref, enh3.g, fb, S=enh3.S)
        compare("synthesis_tm of the config-3 spectrum",
                synthesis_tm_fused(Yp3_ref, enh3.g, fb, S=enh3.S, gf=enh3.gf), y3_ref, 2e-5,
                "synthesis_tm")
        compare("config-3 path (build_pipeline) vs plain chain", y3, y3_ref, 3e-4)
        del Yp3_ref, y3_ref, y3
        Yr3 = analysis_tm_fused(x3, enh3.h, fb, A=enh3.A, hr=enh3.hr)
        times["gsc_lms_zelinski"] = (time_ms(lambda: gsc_lms_zelinski(Yr3, *lms_args), 5),
                                     plain_lms_ms)
        Yr3_64 = Yr3[:, :64].contiguous()
        Yr3_1 = Yr3[:, :1].contiguous()
        scan_ms["gsc_lms_zelinski"] = {
            "B=256": times["gsc_lms_zelinski"][0],
            "B=64": time_ms(lambda: gsc_lms_zelinski(Yr3_64, *lms_args), 5),
            # one utterance alone: the latency of the frame chain times Tf
            "B=1": time_ms(lambda: gsc_lms_zelinski(Yr3_1, *lms_args), 5)}
        # without the gain (postfilter "none"): the gain computed, never applied
        lms_none_ms = time_ms(lambda: gsc_lms_zelinski(Yr3, *lms_args[:-1], NO_POSTFILTER), 5)
        library["gsc_lms_zelinski"] = None
        times["lms_gates"] = (time_ms(lambda: lms_gates(Yr3, cfg3.lms), 5), plain_gates_ms)
        library["lms_gates"] = None
        for b_, Yb_ in ((B, Yr3), (64, Yr3_64), (1, Yr3_1)):
            if b_ != B and not torch.equal(lms_gates(Yb_, cfg3.lms),
                                           lms_silence_gates(Yb_, cfg3.lms)):
                raise AssertionError(f"lms_gates at B={b_} x {C3} ch differs from the plain gates")
            time_alone("lms_gates", f"B={b_} C={C3}", lambda: lms_gates(Yb_, cfg3.lms),
                       gates_cost(Tf, b_, M))
        del Yb_
        k1_8_ms = time_ms(lambda: analysis_tm_fused(x3, enh3.h, fb, A=enh3.A, hr=enh3.hr), 5)
        Yp3 = gsc_lms_zelinski(Yr3, *lms_args)
        k3_8_ms = time_ms(lambda: synthesis_tm_fused(Yp3, enh3.g, fb, S=enh3.S, gf=enh3.gf), 5)
        k2_8_ms = time_ms(lambda: gsc_rls_zelinski(Yr3, *rls_args3), 5)
        del Yr3, Yr3_ref, Yr3_64, Yr3_1, Yp3
        # the RLS flagship's kernels on the same input: K1 -> K2 -> K3 and K4
        rls_chain3_ms = time_ms(lambda: synthesis_tm_fused(
            gsc_rls_zelinski(analysis_tm_fused(x3, enh3.h, fb, A=enh3.A, hr=enh3.hr),
                             *rls_args3), enh3.g, fb, S=enh3.S, gf=enh3.gf), 3)
        k4_8_ms = time_ms(lambda: analysis_gsc_synthesis(
            x3, enh3.h, enh3.g, fb, *rls_args3, A=enh3.A, S=enh3.S, hr=enh3.hr, gf=enh3.gf), 3)
        path3_ms = time_ms(lambda: enh3(x3), 3)
    peak3 = torch.cuda.max_memory_allocated() / 1e9
    lms_ms = scan_ms["gsc_lms_zelinski"]
    log(f"  gsc_lms_zelinski: kernel {lms_ms['B=256']:.3f} ms   B=64 {lms_ms['B=64']:.3f} ms   "
        f"B=1 {lms_ms['B=1']:.3f} ms   without the gain {lms_none_ms:.3f} ms   plain "
        f"{plain_lms_ms:.3f} ms   library -   (each with its gate pass: "
        f"lms_gates {times['lms_gates'][0]:.3f} ms, plain {plain_gates_ms:.3f} ms)")
    # K1's least time at 8 channels (as for the kernel table below: samples in,
    # packed rows out, FFT-cost DFT rows)
    rows3 = Tf * B * C3
    k1_8_bound = bound(4 * (B * C3 * T + rows3 * M + 2 * M + fb.N),
                       rows3 * 2.5 * M * np.log2(M) + 2 * fb.m * M * rows3)
    log(f"  at 8 channels: analysis_tm {k1_8_ms:.3f} ms (bound {k1_8_bound[0]:.3f} ms, "
        f"{k1_8_bound[1]})   synthesis_tm {k3_8_ms:.3f} ms   gsc_rls_zelinski {k2_8_ms:.3f} ms")
    log(f"  config-3 path (K1 -> LMS scan -> K3): {path3_ms:.3f} ms "
        f"({audio_s / (path3_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  same input, the RLS flagship's kernels: K1->K2->K3 {rls_chain3_ms:.3f} ms "
        f"({audio_s / (rls_chain3_ms / 1e3):.1f} audio-s/s/GPU)   gsc_mono (K4) {k4_8_ms:.3f} ms "
        f"({audio_s / (k4_8_ms / 1e3):.1f} audio-s/s/GPU)")
    log(f"  peak device memory of phase 11 {peak3:.2f} GB   ({smi_line()})")
    log("  torch.profiler over 3 back-to-back config-3 forwards")
    profile_path(lambda: enh3(x3))
    del enh3, x3

    # postfilter "none": the scan without the gain, or the fixed weights' plain
    # product, between K1 and K3, against the plain beamformers alone
    B11, T11 = 8, 2 * FS
    log(f"== 11b. pipelines without a postfilter: build_pipeline() on the card, B={B11} x {C} ch "
        f"x 2 s")
    x11 = torch.from_numpy(signal(rng, (B11, C, T11))).to(dev)
    counts_none = {}
    for bf11, scan_name in (("gsc_lms", "gsc_lms_zelinski"), ("gsc_rls", "gsc_rls_zelinski"),
                            ("ds", None)):
        cfg11 = dataclasses.replace(cfg, beamformer=bf11, postfilter="none",
                                    lms=GSCLMSConfig(min_frames=8),
                                    rls=GSCRLSConfig(min_frames=8))
        enh11 = build_pipeline(cfg11, mpos, delays, h, g)
        kernels.reset_launch_counts()
        with torch.no_grad():
            y11 = enh11(x11)
        torch.cuda.synchronize()
        c11 = kernels.launch_counts()
        want = dict.fromkeys(c11, 0) | {"analysis_tm": 1, "synthesis_tm": 1}
        if scan_name:
            want[scan_name] = 1
        if bf11 == "gsc_lms":
            want["lms_gates"] = 1
        if c11 != want:
            raise AssertionError(f"{bf11} + none launches {c11}, the path needs {want}")
        counts_none[bf11] = c11
        with torch.no_grad():
            X11 = unpack_half(analysis_half_real_tm(x11, enh11.h, fb, packed=True,
                                                    A=enh11.A)).movedim(-2, -1)
            if bf11 == "ds":
                Y11 = apply_weights(enh11.wqH, X11)
            else:
                plain_bf = gsc_lms if bf11 == "gsc_lms" else gsc_rls
                Y11 = plain_bf(X11, frame_energy_half(X11[..., 0], M), enh11.wqH, enh11.BmH,
                               cfg11.lms if bf11 == "gsc_lms" else cfg11.rls)[0]
            compare(f"{bf11} + none (build_pipeline) vs the plain beamformer alone", y11,
                    synthesis_half_real_tm(pack_half(Y11), enh11.g, fb, S=enh11.S), 3e-4)
        del enh11, y11, X11, Y11
    del x11

    # -- 12. BASELINE config 4 at 8 channels: the full enhancement stack ----------
    C12 = C3
    cfg12 = dataclasses.replace(cfg3, aec="nlms", wpe=True, wpe_iterations=2)
    P12 = cfg12.wpe_upper - cfg12.wpe_lower + 1
    CP12 = C12 * P12
    B12 = 32  # utterances held against the plain chain (each is independent of the others)
    log(f"== 12. config-4 path at 8 channels (config4-c8-b256: NLMS AEC -> WPE, C*P = {CP12} "
        f"-> GSC-LMS + Zelinski): build_pipeline() on the card, B={B} x {C12} ch x {secs} s + "
        f"far end")
    enh12 = build_pipeline(cfg12, mpos3, delays3, h, g)
    x12 = torch.from_numpy(signal(rng, (B, C12, T))).to(dev)
    play12 = torch.from_numpy(signal(rng, (B, T))).to(dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with torch.no_grad():
        y12 = enh12(x12, play12)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts12 = kernels.launch_counts()
    log(f"  forward wall {wall * 1e3:.1f} ms (first call), peak device memory of the forward "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches {counts12}")
    if tuple(y12.shape) != (B, T_out) or not torch.isfinite(y12).all():
        raise AssertionError(f"config-4 C=8 output {tuple(y12.shape)} is not finite {(B, T_out)}")
    want12 = dict.fromkeys(counts12, 0) | {
        "analysis_tm": 2, "aec_scan": 1, "wpe_stats": cfg12.wpe_iterations,
        "gj_solve": cfg12.wpe_iterations, "wpe_resid": 1, "lms_gates": 1,
        "gsc_lms_zelinski": 1, "synthesis_tm": 1}
    if counts12 != want12:
        raise AssertionError(f"config-4 C=8 launches {counts12}, the path needs {want12}")
    lms_args12 = (enh12.wqH, enh12.BmH, enh12.wq_manifold, cfg12.lms, cfg12.pf_alpha,
                  cfg12.pf_type, cfg12.pf_min_frames)

    def plain_chain12(x_, play_, scan_args_, kind):
        """The plain chain at 8 channels: analysis, NLMS AEC, per-utterance
        WPE, the GSC scan's plain loop (``kind`` "lms" or "rls"), synthesis."""
        Yr_ = plain_analysis(x_)
        Yr_ = plain_aec(Yr_, plain_analysis(play_[:, None, :])[:, :, 0, :])
        wqH_, BmH_, wqm_, gcfg_, alpha_, pf_type_, pf_min_ = scan_args_
        Yp_ = gsc_postfilter_fused(plain_wpe(Yr_), None, wqH_, BmH_, wqm_, kind, gcfg_, alpha_,
                                   pf_type_, pf_min_, True)
        return plain_synthesis(Yp_)

    log(f"== 12b. the widened kernels vs plain torch at that shape (B={B}, {C12} ch, C*P = "
        f"{CP12}); the path against the plain chain on its first {B12} utterances")
    wide8 = {}  # the 8-channel forms of K9-K12: times, plain times, library times, bounds
    with torch.no_grad():
        Yr12 = analysis_tm_fused(x12, enh12.h, fb, A=enh12.A, hr=enh12.hr)
        V12 = analysis_tm_fused(play12[:, None, :], enh12.h, fb, A=enh12.A, hr=enh12.hr)[:, :, 0]
        Ya12, plain_aec12_ms = timed(lambda: plain_aec(Yr12, V12))
        compare("aec_scan, 8 channels", aec_scan(Yr12, V12, "nlms", cfg12.aec_delta,
                                                 cfg12.aec_epsilon, cfg12.aec_threshold),
                Ya12, 1e-4, "aec_scan")
        compare("aec_scan block_kalman, 8 channels",
                aec_scan(Yr12, V12, "block_kalman", *KALMAN_P, cfg12.aec_threshold),
                plain_aec(Yr12, V12, "block_kalman", *KALMAN_P), 1e-4, "aec_scan")
        X12 = frames(Ya12)
        G0_12 = torch.zeros((B, C12, F, CP12), dtype=torch.complex64, device=dev)
        (R12, r12), plain_stats12_first_ms = timed(lambda: stats_plain(X12, G0_12, lower, P12,
                                                                        False))
        Rk, rk = wpe_stats(Ya12, G0_12, lower, P12, False)
        compare(f"wpe_stats R, first iteration, C*P={CP12}", Rk, R12, 2e-4, "wpe_stats", lead=3)
        compare(f"wpe_stats r, first iteration, C*P={CP12}", rk, r12, 2e-4, "wpe_stats", lead=3)
        del Rk, rk
        R12 = wpe_load(R12)
        G1_12, plain_gj12_ms = timed(lambda: gj_solve_plain(R12, r12))
        compare(f"gj_solve n={CP12}", gj_solve(R12, r12), G1_12, 1e-4, "gj_solve", lead=3,
                sys_budget=GJ_SYS_BUDGET)
        (R12, r12), plain_stats12_ms = timed(lambda: stats_plain(X12, G1_12, lower, P12, True))
        Rk, rk = wpe_stats(Ya12, G1_12, lower, P12, True)
        compare(f"wpe_stats R, later iteration, C*P={CP12}", Rk, R12, 2e-4, "wpe_stats", lead=3)
        compare(f"wpe_stats r, later iteration, C*P={CP12}", rk, r12, 2e-4, "wpe_stats", lead=3)
        del Rk, rk
        G2_12 = wpe_truncate_taps(gj_solve_plain(wpe_load(R12), r12), C12, lower)
        ref12, plain_resid12_ms = timed(
            lambda: pack_half(resid_plain(X12, G2_12, lower).permute(2, 0, 1, 3)))
        compare(f"wpe_resid C={C12} P={P12}", wpe_resid(Ya12, G2_12, lower), ref12, 1e-5,
                "wpe_resid")
        del ref12, X12
        y12_ref, plain_path12_ms = timed(lambda: plain_chain12(x12[:B12], play12[:B12],
                                                               lms_args12, "lms"))
        compare(f"config-4 C=8 path (build_pipeline) vs plain chain, first {B12}", y12[:B12],
                y12_ref, 3e-4)
        del y12_ref, y12

    log("== 12c. CUDA-event times at that shape")
    with torch.no_grad():
        R12 = wpe_load(R12)
        wide8["aec_scan"] = dict(
            ms=time_ms(lambda: aec_scan(Yr12, V12, "nlms", cfg12.aec_delta, cfg12.aec_epsilon,
                                        cfg12.aec_threshold), 5),
            plain_ms=plain_aec12_ms,
            block_kalman_ms=time_ms(lambda: aec_scan(Yr12, V12, "block_kalman", *KALMAN_P,
                                                     cfg12.aec_threshold), 5))
        del Yr12
        wide8["wpe_stats"] = dict(
            ms=time_ms(lambda: wpe_stats(Ya12, G1_12, lower, P12, True), 3),
            first_iteration_ms=time_ms(lambda: wpe_stats(Ya12, G0_12, lower, P12, False), 3),
            plain_ms=plain_stats12_ms, first_iteration_plain_ms=plain_stats12_first_ms)
        # the library yardsticks on 16 utterances, scaled to B, as in phase 6c
        Xc = frames(Ya12[:, :16])
        L = torch.stack([torch.nn.functional.pad(Xc, (0, 0, lower + dp, 0))[:, :, :Tf]
                         for dp in range(P12)], dim=-1)  # [16, C, Tf, F, P]
        L = L.permute(0, 3, 1, 4, 2).reshape(16, F, CP12, Tf)
        Lw = L[:, None] * torch.rand((16, C12, F, 1, Tf), device=dev)
        LH = L.conj().transpose(-1, -2)[:, None].resolve_conj()
        wide8["wpe_stats"]["library_ms"] = time_ms(lambda: torch.matmul(Lw, LH), 3) * B / 16
        del Lw, LH
        G16 = G2_12[:16].conj()[:, :, :, None, :].resolve_conj()
        wide8["wpe_resid"] = dict(
            ms=time_ms(lambda: wpe_resid(Ya12, G2_12, lower), 5), plain_ms=plain_resid12_ms,
            library_ms=time_ms(lambda: torch.matmul(G16, L[:, None]), 3) * B / 16)
        del Xc, L, G16
        wide8["gj_solve"] = dict(
            ms=time_ms(lambda: gj_solve(R12, r12), 5), plain_ms=plain_gj12_ms,
            library_ms=time_ms(lambda: torch.linalg.solve(R12, r12[..., None]), 3))
        n_sys12 = r12.numel() // CP12
        del R12, r12, G0_12, G1_12, G2_12, Ya12, V12
        path12_ms = time_ms(lambda: enh12(x12, play12), 3)
    peak12 = torch.cuda.max_memory_allocated() / 1e9
    rows12 = Tf * B * C12
    valid12 = Tf - lower
    bounds12 = {
        "aec_scan": bound(4 * (2 * rows12 * M + Tf * B * M), 30 * rows12 * F),
        "wpe_stats": bound(4 * rows12 * M + 8 * B * C12 * F * (CP12 * CP12 + 2 * CP12),
                           B * C12 * F * valid12 * (8 * CP12 * (CP12 + 1) // 2 + 2 * CP12
                                                    + 8 * CP12),
                           B * C12 * F * valid12 * 8 * CP12),
        "wpe_resid": bound(8 * rows12 * M + 8 * B * C12 * F * CP12,
                           8 * CP12 * B * C12 * F * valid12),
        "gj_solve": gj_bound(CP12, n_sys12),
    }
    for name, row in wide8.items():
        row["bound_ms"], row["bound_by"] = bounds12[name]
        log(f"  {name} at {C12} channels: kernel {row['ms']:.3f} ms   plain "
            f"{row['plain_ms']:.3f} ms   library "
            + (f"{row['library_ms']:.3f} ms" if "library_ms" in row else "-")
            + f"   bound {row['bound_ms']:.3f} ms ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / row['ms']:.1f}% of it"
            + (f"   first EM iteration {row['first_iteration_ms']:.3f} ms (plain "
               f"{row['first_iteration_plain_ms']:.3f})" if name == "wpe_stats" else "")
            + (f"   block Kalman {row['block_kalman_ms']:.3f} ms" if name == "aec_scan" else ""))
    log(f"  config-4 C=8 path (gsc_lms): {path12_ms:.3f} ms "
        f"({audio_s / (path12_ms / 1e3):.1f} audio-s/s/GPU)   plain chain on {B12} utterances "
        f"{plain_path12_ms:.3f} ms")
    log(f"  peak device memory of phase 12 (with the plain comparisons) {peak12:.2f} GB   "
        f"({smi_line()})")
    log("  torch.profiler over 3 back-to-back config-4 C=8 forwards")
    profile_path(lambda: enh12(x12, play12))
    del enh12

    # the same chain with the GSC-RLS scan (bench.py's config 4): K2 at 8 channels
    log(f"== 12d. config-4 path at 8 channels with gsc_rls: build_pipeline() on the card, the "
        f"same input; the first {B12} utterances against the plain chain")
    cfg12r = dataclasses.replace(cfg12, beamformer="gsc_rls")
    enh12r = build_pipeline(cfg12r, mpos3, delays3, h, g)
    kernels.reset_launch_counts()
    with torch.no_grad():
        y12r = enh12r(x12, play12)
    torch.cuda.synchronize()
    counts12r = kernels.launch_counts()
    want12r = dict.fromkeys(counts12r, 0) | {
        "analysis_tm": 2, "aec_scan": 1, "wpe_stats": cfg12.wpe_iterations,
        "gj_solve": cfg12.wpe_iterations, "wpe_resid": 1, "gsc_rls_zelinski": 1,
        "synthesis_tm": 1}
    if counts12r != want12r:
        raise AssertionError(f"config-4 C=8 gsc_rls launches {counts12r}, the path needs "
                             f"{want12r}")
    rls_args12 = (enh12r.wqH, enh12r.BmH, enh12r.wq_manifold, cfg12r.rls, cfg12r.pf_alpha,
                  cfg12r.pf_type, cfg12r.pf_min_frames)
    with torch.no_grad():
        compare(f"config-4 C=8 gsc_rls path (build_pipeline) vs plain chain, first {B12}",
                y12r[:B12], plain_chain12(x12[:B12], play12[:B12], rls_args12, "rls"), 3e-4)
        del y12r
        path12r_ms = time_ms(lambda: enh12r(x12, play12), 3)
    log(f"  config-4 C=8 path (gsc_rls): {path12r_ms:.3f} ms "
        f"({audio_s / (path12r_ms / 1e3):.1f} audio-s/s/GPU)")
    del enh12r, x12, play12

    # -- 13. the McCowan, Lefkimmiatis and APAB postfilters ------------------------
    kinds13 = (("mccowan", 1), ("mccowan", 2), ("lefkimmiatis", 1), ("lefkimmiatis", 2),
               ("apab", 1))

    def pf_setup(C_):
        """SD-MVDR weights, the manifold and the diffuse coherence of the
        bench.py array widened to ``C_`` mics."""
        mpos_ = np.c_[np.arange(C_) * 50.0, np.zeros((C_, 2))]
        delays_ = geometry.calc_la_delays(mpos_[:, :1], azimuth=np.pi / 3)
        return (superdirective_weights(mpos_, delays_, M, float(FS)).to(dev),
                array_manifold(M, float(FS), delays_).to(dev),
                diffuse_noise_coherence(mpos_, M, float(FS)))

    def pf_consts(kind, pf_type, vs_, Gamma_):
        c_ = coherence_constants(kind, Gamma_, vs_.cpu(), pf_type)
        return None if c_ is None else c_.to(dev)

    log("== 13. coherence postfilter kernel (McCowan, Lefkimmiatis, APAB) vs plain torch on the "
        "card (B=8, 2 s; SD-MVDR output given, and formed in the kernel)")
    for C_ in (2, 4, 8):
        wqH_, vs_, Gamma_ = pf_setup(C_)
        with torch.no_grad():
            Yr_ = analysis_tm_fused(torch.from_numpy(signal(rng, (8, C_, 2 * FS))).to(dev),
                                    enh.h, fb, A=enh.A, hr=enh.hr)
            Yp_ = pack_half(apply_weights(wqH_, unpack_half(Yr_).movedim(-2, -1)))
            for kind, pf_type in kinds13:
                a_ = (wqH_, vs_, kind, pf_consts(kind, pf_type, vs_, Gamma_), 0.6, pf_type, 2)
                ref_ = coherence_postfilter_plain(Yr_, Yp_, *a_)
                name_ = f"coherence_postfilter {kind} {'real' if pf_type == 1 else 'abs'} C={C_}"
                compare(name_, coherence_postfilter(Yr_, Yp_, *a_), ref_, 1e-4,
                        "coherence_postfilter")
                compare(name_ + " fixed weights", coherence_postfilter(Yr_, None, *a_),
                        coherence_postfilter_plain(Yr_, None, *a_), 1e-4, "coherence_postfilter")
        del Yr_, Yp_, ref_

    # the kernel alone at the flagship shape, the beamformer output given
    log(f"== 13b. coherence postfilter kernel at B={B} x {C} ch x {secs} s")
    x13 = torch.from_numpy(signal(rng, (B, C, T))).to(dev)
    pf13 = {}  # kind -> kernel ms, plain ms, fixed-weight form ms
    wqH13, vs13, Gamma13 = pf_setup(C)
    with torch.no_grad():
        Yr13 = analysis_tm_fused(x13, enh.h, fb, A=enh.A, hr=enh.hr)
        Yp13 = pack_half(apply_weights(wqH13, unpack_half(Yr13).movedim(-2, -1)))
        for kind in ("mccowan", "lefkimmiatis", "apab"):
            a_ = (wqH13, vs13, kind, pf_consts(kind, 1, vs13, Gamma13), cfg.pf_alpha, 1, 2)
            ref_, plain_ms_ = timed(lambda: coherence_postfilter_plain(Yr13, Yp13, *a_))
            compare(f"coherence_postfilter {kind} at B={B}", coherence_postfilter(Yr13, Yp13, *a_),
                    ref_, 1e-4, "coherence_postfilter")
            del ref_
            pf13[kind] = (time_ms(lambda: coherence_postfilter(Yr13, Yp13, *a_), 5), plain_ms_,
                          time_ms(lambda: coherence_postfilter(Yr13, None, *a_), 5))
            log(f"  {kind}: kernel {pf13[kind][0]:.3f} ms (Y given)   {pf13[kind][2]:.3f} ms (Y "
                f"formed)   plain {plain_ms_:.3f} ms   ({smi_line()})")
        del Yr13, Yp13
        # McCowan at 8 channels (gsc-lms-mccowan-c8-b256's shape), Y given
        x13_8 = torch.from_numpy(signal(rng, (B, C3, T))).to(dev)
        wqH13, vs13, Gamma13 = pf_setup(C3)
        Yr13 = analysis_tm_fused(x13_8, enh.h, fb, A=enh.A, hr=enh.hr)
        Yp13 = pack_half(apply_weights(wqH13, unpack_half(Yr13).movedim(-2, -1)))
        a_ = (wqH13, vs13, "mccowan", pf_consts("mccowan", 1, vs13, Gamma13), cfg.pf_alpha, 1, 2)
        pf13_c8_ms = time_ms(lambda: coherence_postfilter(Yr13, Yp13, *a_), 5)
        log(f"  mccowan at {C3} channels: kernel {pf13_c8_ms:.3f} ms (Y given)")
        del Yr13, Yp13

    # the paths: K1 -> [K9 -> WPE] -> beamformer -> postfilter -> K3, each with
    # its launch counts, time, peak memory and its first 32 utterances against
    # the plain chain
    B13 = min(32, B)

    def plain_chain_of(enh_, x_, play_=None):
        """The plain chain of a pipeline at its own filterbank: analysis,
        [NLMS AEC, WPE], the plain beamformer (fixed weights: wqH X, or K7's
        plain version with Zelinski; a GSC's scan with or without its gain),
        the plain coherence postfilter, synthesis."""
        c_, fb_ = enh_.cfg, enh_.cfg.fb
        Yr_ = analysis_half_real_tm(x_, enh_.h, fb_, packed=True, A=enh_.A)
        if play_ is not None:
            Vp_ = analysis_half_real_tm(play_[:, None, :], enh_.h, fb_, packed=True, A=enh_.A)
            Yr_ = plain_wpe(plain_aec(Yr_, Vp_[:, :, 0, :], c_.aec, c_.aec_delta, c_.aec_epsilon,
                                      c_.aec_threshold))
        zel = c_.postfilter == "zelinski"
        w_ = (enh_.wqH, enh_.wq_manifold)
        if c_.beamformer in FIXED_WEIGHT:
            Yp_ = None
            if zel:
                Yp_ = zelinski_apply_plain(Yr_, *w_, c_.pf_alpha, c_.pf_type, c_.pf_min_frames)
            elif c_.postfilter == "none":
                Yp_ = pack_half(apply_weights(enh_.wqH, unpack_half(Yr_).movedim(-2, -1)))
        else:
            lms_ = c_.beamformer == "gsc_lms"
            Yp_ = gsc_postfilter_fused(Yr_, None, enh_.wqH, enh_.BmH, enh_.wq_manifold,
                                       "lms" if lms_ else "rls", c_.lms if lms_ else c_.rls,
                                       c_.pf_alpha, c_.pf_type,
                                       c_.pf_min_frames if zel else NO_POSTFILTER, True)
        if c_.postfilter not in ("zelinski", "none"):
            Yp_ = coherence_postfilter_plain(Yr_, Yp_, *w_, c_.postfilter, enh_.pf_consts,
                                             c_.pf_alpha, c_.pf_type, c_.pf_min_frames)
        return synthesis_half_real_tm(Yp_, enh_.g, fb_, S=enh_.S)

    def check_path(name_, enh_, args_, want_):
        """One path through build_pipeline's module: its launches around one
        forward (exactly ``want_``, nothing else), its first 32 utterances
        against the plain chain (3e-4), its CUDA-event time, audio-s/s/GPU
        and peak memory."""
        B_, secs_ = args_[0].shape[0], args_[0].shape[-1] / FS
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with torch.no_grad():
            y_ = enh_(*args_)
        torch.cuda.synchronize()
        c_ = kernels.launch_counts()
        peak_ = torch.cuda.max_memory_allocated() / 1e9
        want = dict.fromkeys(c_, 0) | want_
        log(f"  {name_} launches {c_}")
        if c_ != want:
            raise AssertionError(f"{name_} launches {c_}, the path needs {want}")
        T_ = args_[0].shape[-1]
        fb_ = enh_.cfg.fb
        T_out_ = (num_analysis_frames(fb_, T_) - fb_.synthesis_delay) * fb_.D
        if tuple(y_.shape) != (B_, T_out_) or not torch.isfinite(y_).all():
            raise AssertionError(f"{name_} output {tuple(y_.shape)} is not finite {(B_, T_out_)}")
        n_ = min(32, B_)
        with torch.no_grad():
            ref_ = plain_chain_of(enh_, *(a[:n_] for a in args_))
            err_ = compare(f"{name_} (build_pipeline) vs plain chain, first {n_}", y_[:n_], ref_,
                           3e-4)
            del y_, ref_
            ms_ = time_ms(lambda: enh_(*args_), 3)
        log(f"  {name_}: {ms_:.3f} ms ({B_ * secs_ / (ms_ / 1e3):.1f} audio-s/s/GPU), peak device "
            f"memory of one forward {peak_:.2f} GB   ({smi_line()})")
        return dict(ms=ms_, audio_s_per_s=B_ * secs_ / (ms_ / 1e3), peak_gb=peak_,
                    max_abs_err=err_, launches=c_)

    play13 = torch.from_numpy(signal(rng, (B13, T))).to(dev)
    paths13 = (
        ("gsc-rls-mccowan-b256", dict(beamformer="gsc_rls", postfilter="mccowan"), C, B,
         {"gsc_rls_zelinski": 1}),
        ("ds-lefkimmiatis-b256", dict(beamformer="ds", postfilter="lefkimmiatis"), C, B, {}),
        ("sdmvdr-apab-b256", dict(beamformer="sd_mvdr", postfilter="apab"), C, B, {}),
        ("gsc-lms-mccowan-c8-b256", dict(beamformer="gsc_lms", postfilter="mccowan"), C3, B,
         {"lms_gates": 1, "gsc_lms_zelinski": 1}),
        ("ds-config4-b32", dict(beamformer="ds", postfilter="zelinski", aec="nlms", wpe=True,
                                wpe_iterations=2), C, B13,
         {"analysis_tm": 2, "aec_scan": 1, "wpe_stats": 2, "gj_solve": 2, "wpe_resid": 1,
          "zelinski_apply": 1}),
    )
    path13, counts13 = {}, {}
    for name13, kw13, C_, B_, extra in paths13:
        cfg13 = dataclasses.replace(cfg, **kw13)
        mpos_ = mpos3 if C_ == C3 else mpos
        enh13 = build_pipeline(cfg13, mpos_, delays3 if C_ == C3 else delays, h, g)
        xin = (x13_8 if C_ == C3 else x13)[:B_]
        args13 = (xin,) + ((play13[:B_],) if cfg13.aec != "none" else ())
        log(f"== 13c. {name13}: build_pipeline(beamformer={cfg13.beamformer!r}, "
            f"postfilter={cfg13.postfilter!r}, aec={cfg13.aec!r}, wpe={cfg13.wpe}) on the card, "
            f"B={B_} x {C_} ch x {secs} s")
        want13 = {"analysis_tm": 1, "synthesis_tm": 1} | extra | (
            {"coherence_postfilter": 1} if cfg13.postfilter != "zelinski" else {})
        path13[name13] = check_path(name13, enh13, args13, want13)
        counts13[name13] = path13[name13]["launches"]
        del enh13
    del x13, x13_8, play13

    # least time on the card for the work of each timed call, from its shapes
    def rls_macs(Cx):  # K2's complex multiply-adds per (frame, utterance, bin) at Cx channels
        Bx = Cx - 1
        return (Bx * Cx + Cx + 3 * Bx * Bx + 8 * Bx + Bx * (Bx - 1) // 2 + 2 * Cx
                + Cx * (Cx - 1) // 2)

    # -- 14. the filterbanks at M = 64, 128 and 512 ---------------------------------
    # the least times of phase 14's calls at filterbank fb_, B_ utterances, C_
    # channels: the formulas of the M = 256 rows below, at that M
    def fft_flops_at(M_):
        return 2.5 * M_ * np.log2(M_)

    def k1_bound_at(fb_, B_, C_, T_):
        rows_ = num_analysis_frames(fb_, T_) * B_ * C_
        return bound(4 * (B_ * C_ * T_ + rows_ * fb_.M + 2 * fb_.M + fb_.N),
                     rows_ * fft_flops_at(fb_.M) + 2 * fb_.m * fb_.M * rows_)

    def k3_bound_at(fb_, B_, Tf_):
        T_out_ = (Tf_ - fb_.synthesis_delay) * fb_.D
        return bound(4 * (Tf_ * B_ * fb_.M + B_ * T_out_ + 2 * fb_.M + fb_.N),
                     Tf_ * B_ * fft_flops_at(fb_.M) + 2 * fb_.m * fb_.M * (T_out_ // fb_.D) * B_)

    def k2_bound_at(M_, Tf_, B_, Cx):
        F_ = M_ // 2 + 1
        return bound(4 * (Tf_ * B_ * Cx * M_ + Tf_ * B_ * M_) + 8 * F_ * Cx * (1 + Cx),
                     8 * rls_macs(Cx) * Tf_ * B_ * F_)

    def k6_bound_at(M_, Tf_, B_, Cx):
        F_ = M_ // 2 + 1
        return bound(4 * (Tf_ * B_ * Cx * M_ + Tf_ * B_ * M_) + 8 * B_ * F_ * Cx * (1 + Cx),
                     8 * rls_macs(Cx) * Tf_ * B_ * F_)

    def lms_bound_at(M_, Tf_, B_, Cx):
        F_, Bx = M_ // 2 + 1, Cx - 1
        macs = Bx * Cx + Cx + 2 * Cx + Cx * (Cx - 1) // 2 + Cx + 5 * Bx
        return bound(4 * (Tf_ * B_ * Cx * M_ + Tf_ * B_ * M_) + 8 * F_ * Cx * (2 + Bx),
                     8 * macs * Tf_ * B_ * F_)

    def k11_bound_at(M_, Tf_, B_, Cx, P_):
        F_, CP_ = M_ // 2 + 1, Cx * P_
        return bound(8 * Tf_ * B_ * Cx * M_ + 8 * B_ * Cx * F_ * CP_,
                     8 * CP_ * B_ * Cx * F_ * (Tf_ - lower))

    def kernel_row(name_, ms_, b_, **extra):
        """A by_M entry: its time beside its least time, logged."""
        log(f"  {name_}: kernel {ms_:.3f} ms   bound {b_[0]:.3f} ms ({b_[1]}), "
            f"{100 * b_[0] / ms_:.1f}% of it   "
            + "   ".join(f"{k} {v:.3f} ms" for k, v in extra.items() if v is not None))
        return dict(ms=ms_, bound_ms=b_[0], bound_by=b_[1], **extra)

    log(f"== 14. the filterbank sizes M = 64, 128 and 512 (B={B} x {secs} s; K4/K8 take "
        "M = 256 only, so the split routes run)")
    by_M = {k: {} for k in ("analysis_tm", "synthesis_tm", "gsc_rls_zelinski",
                            "gsc_rls_zelinski_steered", "gsc_lms_zelinski", "wpe_resid")}
    cells14, counts14 = {}, {}
    x14 = torch.from_numpy(signal(rng, (B, C, T))).to(dev)
    x14_8 = torch.from_numpy(signal(rng, (B, C3, T))).to(dev)
    n32 = 32
    # BASELINE config 1 (config1-m64-b256): 2-channel D&S at M = 64, no
    # postfilter: K1, the plain product wqH X, K3
    fb1 = FilterbankParams(M=64, m=4, r=1)
    cfg1 = PipelineConfig(fb=fb1, samplerate=float(FS), beamformer="ds", postfilter="none")
    mpos1 = mpos[:2]
    delays1 = geometry.calc_la_delays(mpos1[:, :1], azimuth=np.pi / 3)
    h1, g1 = load_pair(64, 4, 1)
    enh1 = build_pipeline(cfg1, mpos1, delays1, h1, g1)
    x1 = x14[:, :2].contiguous()
    log(f"== 14a. config1-m64-b256: {cfg1.beamformer} + {cfg1.postfilter}, M=64 m=4 r=1, "
        f"B={B} x 2 ch x {secs} s")
    cells14["config1-m64-b256"] = check_path("config1-m64-b256", enh1, (x1,),
                                             {"analysis_tm": 1, "synthesis_tm": 1})
    counts14["config1-m64-b256"] = cells14["config1-m64-b256"]["launches"]
    with torch.no_grad():
        Tf1 = num_analysis_frames(fb1, T)
        Yr1 = analysis_tm_fused(x1, enh1.h, fb1, hr=enh1.hr)
        Yp1 = pack_half(apply_weights(enh1.wqH, unpack_half(Yr1).movedim(-2, -1)))
        W1 = torch.randn((Tf1 * B * 2, 64), device=dev)
        cell_k = {
            "analysis_tm": kernel_row(
                "analysis_tm M=64 C=2", time_ms(lambda: analysis_tm_fused(x1, enh1.h, fb1,
                                                                          hr=enh1.hr), 5),
                k1_bound_at(fb1, B, 2, T),
                plain_ms=time_ms(lambda: analysis_half_real_tm(x1, enh1.h, fb1, packed=True,
                                                               A=enh1.A), 1),
                fft_ms=time_ms(lambda: torch.fft.rfft(W1, dim=-1), 5),
                library_ms=time_ms(lambda: torch.matmul(W1, enh1.A), 5)),
            "wqH X (torch)": time_ms(lambda: pack_half(apply_weights(
                enh1.wqH, unpack_half(Yr1).movedim(-2, -1))), 3),
            "synthesis_tm": kernel_row(
                "synthesis_tm M=64", time_ms(lambda: synthesis_tm_fused(Yp1, enh1.g, fb1,
                                                                        gf=enh1.gf), 5),
                k3_bound_at(fb1, B, Tf1),
                plain_ms=time_ms(lambda: synthesis_half_real_tm(Yp1, enh1.g, fb1, S=enh1.S), 1),
                fft_ms=time_ms(lambda: torch.fft.irfft(unpack_half(Yp1.reshape(-1, 64)), n=64,
                                                       dim=-1), 5),
                library_ms=time_ms(lambda: torch.matmul(Yp1.reshape(-1, 64), enh1.S), 5)),
        }
        log(f"  wqH X (plain torch, XLA's in the JAX package): {cell_k['wqH X (torch)']:.3f} ms")
        cells14["config1-m64-b256"]["kernels"] = cell_k
        del Yr1, Yp1, W1, x1, enh1

    # the flagship at M = 128 and 512 (flagship-m128-b256, flagship-m512-b256:
    # K1, K2, K3), and every kernel of phase 14's paths timed at B=256 x 4 ch
    # x 10 s (LMS: 8 ch) at M = 64, 128 and 512
    ang_ = np.deg2rad(np.linspace(10.0, 350.0, B))
    for M_ in (64, 128, 512):
        fb_ = FilterbankParams(M=M_, m=4, r=1, delay_compensation_type=2)
        h_, g_ = load_pair(M_, 4, 1)
        cfgM = dataclasses.replace(cfg, fb=fb_)
        enhM = build_pipeline(cfgM, mpos, delays, h_, g_)
        name_ = f"flagship-m{M_}-b256"
        if M_ != 64:
            log(f"== 14b. {name_}: gsc_rls + zelinski, M={M_} m=4 r=1, B={B} x {C} ch x {secs} s")
            cells14[name_] = check_path(name_, enhM, (x14,),
                                        {"analysis_tm": 1, "gsc_rls_zelinski": 1,
                                         "synthesis_tm": 1})
            counts14[name_] = cells14[name_]["launches"]
        log(f"== 14c. the kernels at M={M_}, B={B} x {C} ch x {secs} s (LMS: {C3} ch; plain "
            f"scans timed on the first {n32} utterances at M = 512)")
        TfM = num_analysis_frames(fb_, T)
        F_ = M_ // 2 + 1

        def plain_b32(fn):
            """The plain scan's time on the first 32 utterances, at M = 512
            only: its Python loop over frames takes ~20 s at M = 128 and
            ~40 s at 64 (2,508 and 5,016 frames)."""
            return timed(fn)[1] if M_ == 512 else None

        sargs = (enhM.wqH, enhM.BmH, enhM.wq_manifold, cfgM.rls, cfgM.pf_alpha, cfgM.pf_type,
                 cfgM.pf_min_frames)
        with torch.no_grad():
            YrM = analysis_tm_fused(x14, enhM.h, fb_, hr=enhM.hr)
            W_ = torch.randn((TfM * B * C, M_), device=dev)
            by_M["analysis_tm"][M_] = kernel_row(
                f"analysis_tm M={M_}",
                time_ms(lambda: analysis_tm_fused(x14, enhM.h, fb_, hr=enhM.hr), 5),
                k1_bound_at(fb_, B, C, T),
                plain_ms=time_ms(lambda: analysis_half_real_tm(x14, enhM.h, fb_, packed=True,
                                                               A=enhM.A), 1),
                fft_ms=time_ms(lambda: torch.fft.rfft(W_, dim=-1), 5),
                library_ms=time_ms(lambda: torch.matmul(W_, enhM.A), 5))
            del W_
            YpM = gsc_rls_zelinski(YrM, *sargs)
            by_M["gsc_rls_zelinski"][M_] = kernel_row(
                f"gsc_rls_zelinski M={M_}", time_ms(lambda: gsc_rls_zelinski(YrM, *sargs), 3),
                k2_bound_at(M_, TfM, B, C),
                plain_ms_b32=plain_b32(lambda: gsc_postfilter_fused(
                    YrM[:, :n32], None, *sargs[:3], "rls", *sargs[3:], True)),
                library_ms=None)
            by_M["synthesis_tm"][M_] = kernel_row(
                f"synthesis_tm M={M_}",
                time_ms(lambda: synthesis_tm_fused(YpM, enhM.g, fb_, gf=enhM.gf), 5),
                k3_bound_at(fb_, B, TfM),
                plain_ms=time_ms(lambda: synthesis_half_real_tm(YpM, enhM.g, fb_, S=enhM.S), 1),
                fft_ms=time_ms(lambda: torch.fft.irfft(unpack_half(YpM.reshape(-1, M_)), n=M_,
                                                       dim=-1), 5),
                library_ms=time_ms(lambda: torch.matmul(YpM.reshape(-1, M_), enhM.S), 5))
            del YpM
            # K6: one steering per utterance, B directions on the circular array
            dM = np.stack([geometry.calc_ca_delays(mpos5, az, np.pi / 2) for az in ang_])
            stM = steering_weights(array_manifold(M_, float(FS), torch.tensor(
                dM, dtype=torch.float32, device=dev)))
            by_M["gsc_rls_zelinski_steered"][M_] = kernel_row(
                f"gsc_rls_zelinski_steered M={M_}",
                time_ms(lambda: gsc_rls_zelinski_steered(YrM, *stM, *sargs[3:]), 3),
                k6_bound_at(M_, TfM, B, C),
                plain_ms_b32=plain_b32(lambda: gsc_postfilter_fused(
                    YrM[:, :n32], None, *(t[:n32] for t in stM), "rls", *sargs[3:], True)),
                library_ms=None)
            del stM
            # K11 at config 4's (4, 5) with filters of 0.1-scale noise
            GM = torch.from_numpy((0.1 * (rng.standard_normal((B, C, F_, C * P))
                                          + 1j * rng.standard_normal((B, C, F_, C * P)))
                                   ).astype(np.complex64)).to(dev)
            Xc = frames(YrM[:, :16])
            Lg = torch.stack([torch.nn.functional.pad(Xc, (0, 0, lower + dp, 0))[:, :, :TfM]
                              for dp in range(P)], dim=-1)  # [16, C, Tf, F, P]
            Lg = Lg.permute(0, 3, 1, 4, 2).reshape(16, F_, C * P, TfM)
            G16 = GM[:16].conj()[:, :, :, None, :].resolve_conj()
            by_M["wpe_resid"][M_] = kernel_row(
                f"wpe_resid M={M_} (C, P) = ({C}, {P})",
                time_ms(lambda: wpe_resid(YrM, GM, lower), 5), k11_bound_at(M_, TfM, B, C, P),
                plain_ms_b32=timed(lambda: resid_plain(frames(YrM[:, :n32]), GM[:n32],
                                                       lower))[1],
                library_ms=time_ms(lambda: torch.matmul(G16, Lg[:, None]), 3) * B / 16)
            del GM, Xc, Lg, G16, YrM
            # the LMS scan (with its gate pass) at 8 channels
            wq8, bm8 = gsc_weights(M_, float(FS), delays3, 1)
            w8 = (wq8.to(dev), bm8.to(dev), array_manifold(M_, float(FS), delays3).to(dev),
                  cfg.lms, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
            Yr8 = analysis_tm_fused(x14_8, enhM.h, fb_, hr=enhM.hr)
            by_M["gsc_lms_zelinski"][M_] = kernel_row(
                f"gsc_lms_zelinski M={M_} C={C3} (gate pass included)",
                time_ms(lambda: gsc_lms_zelinski(Yr8, *w8), 3), lms_bound_at(M_, TfM, B, C3),
                plain_ms_b32=plain_b32(lambda: gsc_postfilter_fused(
                    Yr8[:, :n32], None, *w8[:3], "lms", *w8[3:], True)),
                library_ms=None)
            del Yr8, w8
        del enhM

    # the other paths at M = 64 and 512, B = 8 x 2 s: launch counts and the
    # plain chain
    T14 = min(2 * FS, T)
    x14s = x14[:8, :, :T14].contiguous()
    play14 = torch.from_numpy(signal(rng, (8, T14))).to(dev)
    x14s_8 = x14_8[:8, :, :T14].contiguous()
    paths14 = (
        ("config3-m512-b8", 512, dict(beamformer="gsc_lms", postfilter="zelinski"), C3,
         {"analysis_tm": 1, "lms_gates": 1, "gsc_lms_zelinski": 1, "synthesis_tm": 1}),
        ("ds-zelinski-m512-b8", 512, dict(beamformer="ds", postfilter="zelinski"), C,
         {"analysis_tm": 1, "zelinski_apply": 1, "synthesis_tm": 1}),
        ("gsc-rls-mccowan-m64-b8", 64, dict(beamformer="gsc_rls", postfilter="mccowan"), C,
         {"analysis_tm": 1, "gsc_rls_zelinski": 1, "coherence_postfilter": 1,
          "synthesis_tm": 1}),
        ("config4-m64-b8", 64, dict(aec="nlms", wpe=True, wpe_iterations=2), C,
         {"analysis_tm": 2, "aec_scan": 1, "wpe_stats": 2, "gj_solve": 2, "wpe_resid": 1,
          "gsc_rls_zelinski": 1, "synthesis_tm": 1}),
        ("config4-m512-b8", 512, dict(aec="nlms", wpe=True, wpe_iterations=2), C,
         {"analysis_tm": 2, "aec_scan": 1, "wpe_stats": 2, "gj_solve": 2, "wpe_resid": 1,
          "gsc_rls_zelinski": 1, "synthesis_tm": 1}),
    )
    for name_, M_, kw_, C_, want_ in paths14:
        fb_ = FilterbankParams(M=M_, m=4, r=1, delay_compensation_type=2)
        h_, g_ = load_pair(M_, 4, 1)
        cfg_ = dataclasses.replace(cfg, fb=fb_, **kw_)
        enh_ = build_pipeline(cfg_, mpos3 if C_ == C3 else mpos, delays3 if C_ == C3 else delays,
                              h_, g_)
        args_ = ((x14s_8 if C_ == C3 else x14s),) + ((play14,) if cfg_.aec != "none" else ())
        log(f"== 14d. {name_}: build_pipeline(beamformer={cfg_.beamformer!r}, "
            f"postfilter={cfg_.postfilter!r}, aec={cfg_.aec!r}, wpe={cfg_.wpe}), M={M_}, "
            f"8 x {C_} ch x 2 s")
        cells14[name_] = check_path(name_, enh_, args_, want_)
        counts14[name_] = cells14[name_]["launches"]
        del enh_
    # config 5 at M = 512: SRP-PHAT DOA -> steered GSC-RLS + Zelinski, one
    # source per utterance at a grid direction plus sensor noise 20 dB down
    fb_ = FilterbankParams(M=512, m=4, r=1, delay_compensation_type=2)
    h_, g_ = load_pair(512, 4, 1)
    cfg_ = dataclasses.replace(cfg, fb=fb_)
    enh_ = build_steered_pipeline(cfg_, mpos5, h_, g_, [np.pi / 2], phis5)
    placed_ = (11 * np.arange(8)) % len(phis5)
    src_ = signal(rng, (8, T14 + 64))
    x5_ = 0.1 * signal(rng, (8, C, T14))
    for b, gi in enumerate(placed_):
        d = geometry.calc_ca_delays(mpos5, phis5[gi], np.pi / 2)
        for c in range(C):
            off = 8 - int(round(float(d[c]) * FS))
            x5_[b, c] += src_[b, off:off + T14]
    x5_ = torch.from_numpy(x5_).to(dev)
    log(f"== 14d. config5-m512-b8: build_steered_pipeline(), M=512, 8 x {C} ch x 2 s")
    kernels.reset_launch_counts()
    with torch.no_grad():
        y_, doa_ = enh_(x5_)
    torch.cuda.synchronize()
    c_ = kernels.launch_counts()
    log(f"  config5-m512-b8 launches {c_}")
    want = dict.fromkeys(c_, 0) | {"analysis_tm": 1, "gsc_rls_zelinski_steered": 1,
                                   "synthesis_tm": 1}
    if c_ != want:
        raise AssertionError(f"config5-m512-b8 launches {c_}, the path needs {want}")
    with torch.no_grad():
        Yr_ = analysis_half_real_tm(x5_, enh_.h, fb_, packed=True, A=enh_.A)
        gidx_, vs_ = enh_.steer(Yr_)
        ref_ = synthesis_half_real_tm(gsc_postfilter_fused(
            Yr_, None, *steering_weights(vs_), "rls", cfg_.rls, cfg_.pf_alpha, cfg_.pf_type, cfg_.pf_min_frames,
            True), enh_.g, fb_, S=enh_.S)
        if not torch.equal(doa_, enh_.grid[gidx_]):
            raise AssertionError("config5-m512-b8 DOA differs from the plain chain's")
        n_placed = (doa_[:, 1].cpu() == torch.tensor(phis5[placed_], dtype=torch.float32)).sum()
        log(f"  DOA equal to the plain chain's; at the placed direction: {n_placed.item()} of 8")
        err_ = compare("config5-m512-b8 (build_steered_pipeline) vs plain chain", y_, ref_, 3e-4)
        ms_ = time_ms(lambda: enh_(x5_), 3)
    cells14["config5-m512-b8"] = dict(ms=ms_, audio_s_per_s=8 * 2 / (ms_ / 1e3),
                                      max_abs_err=err_, launches=c_)
    counts14["config5-m512-b8"] = c_
    log(f"  config5-m512-b8: {ms_:.3f} ms ({8 * 2 / (ms_ / 1e3):.1f} audio-s/s/GPU)")
    del enh_, x5_, src_, y_, ref_, Yr_, x14, x14_8, x14s, x14s_8, play14
    for name_, cell_ in cells14.items():
        log(f"  phase 14 {name_}: {cell_['ms']:.3f} ms, {cell_['audio_s_per_s']:.1f} "
            f"audio-s/s/GPU, {cell_['max_abs_err']:.3g} max abs error against the plain chain")

    # -- 15. the steered routes at config 5's shape ----------------------------------
    # build_steered_pipeline with the default device on config 5's input (B=64
    # x 4 ch x 10 s, one source per utterance at a grid direction plus sensor
    # noise 20 dB down, the 72-point grid): each route's launches (exactly its
    # kernels), its DOA against the plain chain's (equal; the plain DOA stage
    # is torch on the card on either path, from the plain analysis), its first
    # 16 utterances against the plain chain (3e-4), CUDA-event times of the
    # path, the DOA stage and the beamformer stage (the steering weights and
    # the route's kernel), audio-s/s/GPU and peak memory
    B15 = 16

    def plain_beamform(c_, Yp_, vs_):
        """The plain version of `SteeredEnhancer.beamform` (K7's or the
        scans' plain loops) at the manifolds ``vs_``."""
        pf_ = (c_.pf_alpha, c_.pf_type,
               c_.pf_min_frames if c_.postfilter == "zelinski" else NO_POSTFILTER)
        if c_.beamformer == "ds":
            return zelinski_apply_plain(Yp_, torch.conj(vs_).resolve_conj(), vs_, *pf_)
        lms_ = c_.beamformer == "gsc_lms"
        return gsc_postfilter_fused(Yp_, None, *steering_weights(vs_), "lms" if lms_ else "rls",
                                    c_.lms if lms_ else c_.rls, *pf_, True)

    paths15 = (
        ("steered-ds-zelinski-b64", dict(beamformer="ds", postfilter="zelinski"), {},
         {"zelinski_apply_steered": 1}),
        ("steered-ds-none-b64", dict(beamformer="ds", postfilter="none"), {},
         {"zelinski_apply_steered": 1}),
        ("steered-lms-zelinski-b64", dict(beamformer="gsc_lms", postfilter="zelinski"), {},
         {"lms_gates": 1, "gsc_lms_zelinski_steered": 1}),
        ("steered-lms-none-b64", dict(beamformer="gsc_lms", postfilter="none"), {},
         {"lms_gates": 1, "gsc_lms_zelinski_steered": 1}),
        ("steered-rls-none-b64", dict(beamformer="gsc_rls", postfilter="none"), {},
         {"gsc_rls_zelinski_steered": 1}),
        ("steered-dsbla-b64", dict(beamformer="gsc_rls", postfilter="zelinski"),
         dict(doa_protocol="dsbla"), {"gsc_rls_zelinski_steered": 1}),
    )
    cells15, counts15 = {}, {}
    t15 = time.perf_counter()
    for name15, kw15, skw15, extra in paths15:
        cfg15 = dataclasses.replace(cfg, **kw15)
        enh15 = build_steered_pipeline(cfg15, mpos5, h, g, [np.pi / 2], phis5, **skw15)
        log(f"== 15. {name15}: build_steered_pipeline(beamformer={cfg15.beamformer!r}, "
            f"postfilter={cfg15.postfilter!r}, doa_protocol="
            f"{skw15.get('doa_protocol', 'srp_phat')!r}) on the card, B={B5} x {C} ch x {secs} s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with torch.no_grad():
            y15, doa15 = enh15(x5)
        torch.cuda.synchronize()
        c15 = kernels.launch_counts()
        peak15 = torch.cuda.max_memory_allocated() / 1e9
        want15 = dict.fromkeys(c15, 0) | {"analysis_tm": 1, "synthesis_tm": 1} | extra
        log(f"  {name15} launches {c15}")
        if c15 != want15:
            raise AssertionError(f"{name15} launches {c15}, the route needs {want15}")
        if tuple(y15.shape) != (B5, T_out) or not torch.isfinite(y15).all():
            raise AssertionError(f"{name15} output {tuple(y15.shape)} is not finite {(B5, T_out)}")
        with torch.no_grad():
            # the plain analysis, and K1's for the stages' times, after the
            # forward's peak memory is read
            Yr15 = plain_analysis(x5)
            Yk15 = analysis_tm_fused(x5, enh.h, fb, A=enh.A, hr=enh.hr)
            gidx15, vs15 = enh15.steer(Yr15)  # the plain chain's DOA stage
            if not torch.equal(doa15, enh15.grid[gidx15]):
                raise AssertionError(f"{name15} DOA differs from the plain chain's")
            n15 = (doa15[:, 1].cpu() == torch.tensor(phis5[placed], dtype=torch.float32)).sum()
            log(f"  DOA equal to the plain chain's; at the placed direction: {n15.item()} of {B5}")
            Yb15, plain15_ms = timed(lambda: plain_beamform(cfg15, Yr15[:, :B15], vs15[:B15]))
            err15 = compare(f"{name15} (build_steered_pipeline) vs plain chain, first {B15}",
                            y15[:B15], plain_synthesis(Yb15), 3e-4)
            del y15, Yb15
            ms15 = time_ms(lambda: enh15(x5), 3)
            doa_ms15 = time_ms(lambda: enh15.steer(Yk15), 3)
            _, vsk15 = enh15.steer(Yk15)
            bf_ms15 = time_ms(lambda: enh15.beamform(Yk15, vsk15), 3)
        cells15[name15] = dict(ms=ms15, audio_s_per_s=B5 * secs / (ms15 / 1e3), peak_gb=peak15,
                               max_abs_err=err15, doa_ms=doa_ms15, beamformer_ms=bf_ms15,
                               plain_beamformer_ms_16=plain15_ms, launches=c15)
        counts15[name15] = c15
        log(f"  {name15}: {ms15:.3f} ms ({B5 * secs / (ms15 / 1e3):.1f} audio-s/s/GPU), DOA stage "
            f"{doa_ms15:.3f} ms, beamformer stage {bf_ms15:.3f} ms (plain, first {B15}: "
            f"{plain15_ms:.3f} ms), peak device memory of one forward {peak15:.2f} GB   "
            f"({smi_line()})")
        with torch.no_grad():  # the new kernels alone at this shape, beside the plain loops
            if name15 == "steered-ds-zelinski-b64":
                a15 = (torch.conj(vsk15).resolve_conj(), vsk15, cfg.pf_alpha, cfg.pf_type,
                       cfg.pf_min_frames)
                compare("zelinski_apply_steered at the config-5 shape",
                        zelinski_apply_steered(Yr15, *a15), zelinski_apply_plain(Yr15, *a15),
                        3e-5, "zelinski_apply_steered")
                times["zelinski_apply_steered"] = (
                    time_ms(lambda: zelinski_apply_steered(Yk15, *a15), 5), plain15_ms)
                # alone at B5, 4 B5 (the batch four times, each utterance its
                # own row of weights) and one utterance
                for b_ in (B5, 4 * B5, 1):
                    r_ = (b_ + B5 - 1) // B5
                    Yb_ = Yk15.repeat(1, r_, 1, 1)[:, :b_].contiguous()
                    ab_ = tuple(t.repeat(r_, 1, 1)[:b_].contiguous() for t in a15[:2]) + a15[2:]
                    time_alone("zelinski_apply_steered", f"B={b_} C={C}",
                               lambda: zelinski_apply_steered(Yb_, *ab_),
                               k7_cost(Tf, b_, C, M, True), zelinski_launch_shape(b_, C, M))
                del Yb_, ab_
            if name15 == "steered-lms-zelinski-b64":
                a15 = (*steering_weights(vsk15), cfg15.lms, cfg.pf_alpha, cfg.pf_type,
                       cfg.pf_min_frames)
                times["gsc_lms_zelinski_steered"] = (
                    time_ms(lambda: gsc_lms_zelinski_steered(Yk15, *a15), 5), plain15_ms)
                # the gate pass alone at this shape (the steered LMS routes'),
                # at the batch four times and at one utterance
                for b_ in (B5, 4 * B5, 1):
                    Yb_ = Yk15.repeat(1, (b_ + B5 - 1) // B5, 1, 1)[:, :b_].contiguous()
                    if not torch.equal(lms_gates(Yb_, cfg15.lms),
                                       lms_silence_gates(Yb_, cfg15.lms)):
                        raise AssertionError(f"lms_gates at B={b_} x {C} ch differs from the "
                                             f"plain gates")
                    time_alone("lms_gates", f"B={b_} C={C}" + (" (config 5)" if b_ == B5 else ""),
                               lambda: lms_gates(Yb_, cfg15.lms), gates_cost(Tf, b_, M))
                del Yb_
        del enh15, vs15, vsk15, Yk15, Yr15
    del x5
    library["zelinski_apply_steered"] = library["gsc_lms_zelinski_steered"] = None
    for name_, cell_ in cells15.items():
        log(f"  phase 15 {name_}: {cell_['ms']:.3f} ms, {cell_['audio_s_per_s']:.1f} "
            f"audio-s/s/GPU, DOA {cell_['doa_ms']:.3f} ms, beamformer {cell_['beamformer_ms']:.3f} "
            f"ms, {cell_['max_abs_err']:.3g} max abs error against the plain chain")
    log(f"  phase 15 took {time.perf_counter() - t15:.1f} s")

    def k2_bound(Cx):  # Cx channels in, one out, the weights read once
        return bound(4 * (Tf * B * Cx * M + Tf * B * M) + 8 * F * Cx * (1 + Cx),
                     8 * rls_macs(Cx) * Tf * B * F)

    def k4_bound(Cx):  # samples in and out; the spectra never leave the chip
        rows_x = Tf * B * Cx
        return bound(4 * (B * Cx * T + B * T_out + 2 * M + 2 * fb.N) + 8 * F * Cx * (1 + Cx),
                     (rows_x + Tf * B) * fft_flops + 2 * fb.m * M * rows_x + fir_out
                     + 8 * rls_macs(Cx) * Tf * B * F)

    def pf_flops(kind, Cx):
        """The coherence postfilter's flops a (frame, utterance, bin): the
        aligned snapshot and its powers (9 a channel), the pair terms of both
        parts of the cross product with the constants (14 a pair; the
        Lefkimmiatis noise series 8 more), the smoothing and the gain (~16);
        APAB's reference sum and gain instead of the pairs."""
        NPx = Cx * (Cx - 1) // 2
        per_pair = {"mccowan": 14, "lefkimmiatis": 22, "apab": 0}[kind]
        return 9 * Cx + per_pair * NPx + (4 * Cx + 8 if kind == "apab" else 16)

    def pf_bound(kind, Cx=C, given=True):
        """The coherence postfilter's least time at B x Cx ch: X (and the
        beamformer output where it is given) read, the output written."""
        return bound(4 * Tf * B * M * (Cx + (2 if given else 1)), pf_flops(kind, Cx) * Tf * B * F)

    CP = C * P
    valid = Tf - lower  # frames that carry WPE weight
    Bc = C - 1
    scan_macs = rls_macs(C)
    rows = Tf * B * C
    # the least work of one row's M-point real DFT is an FFT's, ~2.5 M log2 M
    # flops (half of a complex FFT's 5 N log2 N); the kernels do FFTs
    fft_flops = 2.5 * M * np.log2(M)
    fir_in, fir_out = 2 * fb.m * M * rows, 2 * fb.m * M * (T_out // fb.D) * B
    zel_flops = 8 * (3 * C + C * (C - 1) // 2)  # K7's per (frame, utterance, bin)
    rls_flops = 8 * scan_macs * Tf * B * F  # the scan's per (frame, utterance, bin) work
    fir_rows = B * C * Tf  # the round trip's analysis FIR: rows out, and (m-1)*R more in
    bounds = {
        "analysis_tm": bound(4 * (B * C * T + rows * M + 2 * M + fb.N),
                             rows * fft_flops + fir_in),
        "gsc_rls_zelinski": k2_bound(C),
        "synthesis_tm": bound(4 * (Tf * B * M + B * T_out + 2 * M + fb.N),
                              Tf * B * fft_flops + fir_out),
        "aec_scan": bound(4 * (2 * rows * M + Tf * B * M), 30 * rows * F),
        # the timed call has filters: its weight residual runs in FP64
        "wpe_stats": bound(4 * rows * M + 8 * B * C * F * (CP * CP + 2 * CP),
                           B * C * F * valid * (8 * CP * (CP + 1) // 2 + 2 * CP + 8 * CP),
                           B * C * F * valid * 8 * CP),
        "gj_solve": gj_bound(CP, n_sys),
        "wpe_resid": bound(8 * rows * M + 8 * B * C * F * CP, 8 * CP * B * C * F * valid),
    }
    rows5 = Tf * B5 * C
    # the LMS scan at config 3's shape: C3 channels in, one out; its complex
    # multiply-adds per (frame, utterance, bin): Z, Yc, the Zelinski sums,
    # xpow, the error, the update with its leak, the norm and the output
    Bc3 = C3 - 1
    lms_macs = Bc3 * C3 + C3 + 2 * C3 + C3 * (C3 - 1) // 2 + C3 + 5 * Bc3
    bounds["gsc_lms_zelinski"] = bound(4 * (Tf * B * C3 * M + Tf * B * M) + 8 * F * C3 * (2 + Bc3),
                                       8 * lms_macs * Tf * B * F)
    # the gate pass: the reference channel's rows in, a flag per (frame,
    # utterance) out; a square and an add per lane
    bounds["lms_gates"] = bound(4 * (Tf * B * M + Tf * B), 2 * Tf * B * M)
    # the steered LMS scan at config 5's shape (B5 utterances, C channels), its
    # weights one set per utterance
    lms_macs4 = Bc * C + C + 2 * C + C * (C - 1) // 2 + C + 5 * Bc
    bounds["gsc_lms_zelinski_steered"] = bound(
        4 * (rows5 * M + Tf * B5 * M) + 8 * B5 * F * C * (2 + Bc), 8 * lms_macs4 * Tf * B5 * F)
    bounds |= {
        "gsc_rls_zelinski_steered": bound(4 * (rows5 * M + Tf * B5 * M) + 8 * B5 * F * C * (2 + Bc),
                                          8 * scan_macs * Tf * B5 * F),
        # K7's complex multiply-adds per (frame, utterance, bin): wqH X,
        # conj(ta) X, the pair sum and the trace
        "zelinski_apply": bound(4 * (rows * M + Tf * B * M) + 16 * F * C, zel_flops * Tf * B * F),
        # at config 5's B5 utterances, each with its own weights and manifold
        "zelinski_apply_steered": bound(4 * (rows5 * M + Tf * B5 * M) + 16 * B5 * F * C,
                                        zel_flops * Tf * B5 * F),
        # samples in and out; the spectra never leave the chip
        "fw_mono": bound(4 * (B * C * T + B * T_out + 2 * M + 2 * fb.N) + 16 * F * C,
                         (rows + Tf * B) * fft_flops + fir_in + fir_out
                         + zel_flops * Tf * B * F),
        # samples in, samples (K4) or the beamformed spectrum (K5) out
        "gsc_mono": k4_bound(C),
        "gsc_analysis": bound(4 * (B * C * T + Tf * B * M + 2 * M + fb.N) + 8 * F * C * (2 + Bc),
                              rows * fft_flops + fir_in + rls_flops),
        # X and the beamformer output in, the output out (the constants and
        # weights are a few hundred KB); flops of one (frame, utterance,
        # bin) in `pf_flops`
        "coherence_postfilter": pf_bound("mccowan"),
        # the reversed windows in, the FIR rows out
        "polyphase_fir": bound(4 * ((2 * fir_rows + B * C * (fb.m - 1) * fb.R) * M + fb.N),
                               2 * fb.m * M * fir_rows),
    }
    # -- 16. the filterbanks at M = 1024 and 2048 ------------------------------------
    # designed prototypes (`prototypes_at`); every route is the split one (K4/K8
    # take M = 256 only).  At B=256 x 10 s (4 ch unless named): each path's
    # launches (exactly its kernels), its first 32 utterances against the
    # plain chain (3e-4), its time, audio-s/s/GPU and peak memory; every
    # kernel of the paths timed at each M beside its bound, its plain version
    # (the scans' and K10/K11's on the first 32 utterances) and torch.fft or
    # a library call; then the other paths at B=8 x 2 s, checked only
    t16 = time.perf_counter()
    log(f"== 16. the filterbank sizes M = 1024 and 2048 (B={B} x {secs} s; designed prototypes "
        "from tests/data/prototypes; the split routes)")
    cells16 = {}
    x16 = torch.from_numpy(signal(rng, (B, C, T))).to(dev)
    x16_8 = torch.from_numpy(signal(rng, (B, C3, T))).to(dev)
    play16 = torch.from_numpy(signal(rng, (B, T))).to(dev)
    for k_ in ("zelinski_apply", "coherence_postfilter", "aec_scan", "wpe_stats", "gj_solve",
               "lms_gates"):
        by_M.setdefault(k_, {})

    def aec_bound_at(M_, Tf_, B_, Cx):
        rows_ = Tf_ * B_ * Cx
        return bound(4 * (2 * rows_ * M_ + Tf_ * B_ * M_), 30 * rows_ * (M_ // 2 + 1))

    def stats_bound_at(M_, Tf_, B_, Cx, P_):
        F_, CP_, valid_ = M_ // 2 + 1, Cx * P_, Tf_ - lower
        return bound(4 * Tf_ * B_ * Cx * M_ + 8 * B_ * Cx * F_ * (CP_ * CP_ + 2 * CP_),
                     B_ * Cx * F_ * valid_ * (8 * CP_ * (CP_ + 1) // 2 + 2 * CP_ + 8 * CP_),
                     B_ * Cx * F_ * valid_ * 8 * CP_)

    def pf_bound_at(M_, Tf_, B_, Cx):  # McCowan, the beamformer's output given
        return bound(4 * Tf_ * B_ * M_ * (Cx + 2), pf_flops("mccowan", Cx) * Tf_ * B_ * (M_ // 2 + 1))

    for M_ in (1024, 2048):
        fb_ = FilterbankParams(M=M_, m=4, r=1, delay_compensation_type=2)
        h_, g_ = prototypes_at(M_)
        cfgM = dataclasses.replace(cfg, fb=fb_)
        enhM = build_pipeline(cfgM, mpos, delays, h_, g_)
        name_ = f"flagship-m{M_}-b256"
        log(f"== 16a. {name_}: gsc_rls + zelinski, M={M_} m=4 r=1, B={B} x {C} ch x {secs} s")
        cells16[name_] = check_path(name_, enhM, (x16,), {"analysis_tm": 1, "gsc_rls_zelinski": 1,
                                                          "synthesis_tm": 1})
        log(f"  torch.profiler over 3 back-to-back {name_} forwards, in a process of its own "
            f"(`--profile-flagship {M_}`, its own noise)")
        child = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                                "--profile-flagship", str(M_)], capture_output=True, text=True,
                               timeout=600)
        out_ = child.stdout.strip().splitlines()
        for line_ in out_[:-1]:
            log(line_)
        if child.returncode != 0:
            raise AssertionError(f"profiling {name_} in its own process failed "
                                 f"(rc {child.returncode}): {child.stderr[-3000:]}")
        cells16[name_]["profile"] = json.loads(out_[-1])
        log(f"== 16b. the kernels at M={M_}, B={B} x {C} ch x {secs} s (LMS: {C3} ch; plain "
            f"scans, K10 and K11 timed on the first {n32} utterances)")
        TfM = num_analysis_frames(fb_, T)
        F_ = M_ // 2 + 1
        sargs = (enhM.wqH, enhM.BmH, enhM.wq_manifold, cfgM.rls, cfgM.pf_alpha, cfgM.pf_type,
                 cfgM.pf_min_frames)
        with torch.no_grad():
            YrM = analysis_tm_fused(x16, enhM.h, fb_, hr=enhM.hr)
            W_ = torch.randn((TfM * B * C, M_), device=dev)
            by_M["analysis_tm"][M_] = kernel_row(
                f"analysis_tm M={M_}",
                time_ms(lambda: analysis_tm_fused(x16, enhM.h, fb_, hr=enhM.hr), 5),
                k1_bound_at(fb_, B, C, T),
                plain_ms=time_ms(lambda: analysis_half_real_tm(x16, enhM.h, fb_, packed=True,
                                                               A=enhM.A), 1),
                fft_ms=time_ms(lambda: torch.fft.rfft(W_, dim=-1), 5),
                library_ms=time_ms(lambda: torch.matmul(W_, enhM.A), 3))
            del W_
            YpM = gsc_rls_zelinski(YrM, *sargs)
            by_M["gsc_rls_zelinski"][M_] = kernel_row(
                f"gsc_rls_zelinski M={M_}", time_ms(lambda: gsc_rls_zelinski(YrM, *sargs), 3),
                k2_bound_at(M_, TfM, B, C),
                plain_ms_b32=timed(lambda: gsc_postfilter_fused(
                    YrM[:, :n32], None, *sargs[:3], "rls", *sargs[3:], True))[1],
                library_ms=None)
            by_M["synthesis_tm"][M_] = kernel_row(
                f"synthesis_tm M={M_}",
                time_ms(lambda: synthesis_tm_fused(YpM, enhM.g, fb_, gf=enhM.gf), 5),
                k3_bound_at(fb_, B, TfM),
                plain_ms=time_ms(lambda: synthesis_half_real_tm(YpM, enhM.g, fb_, S=enhM.S), 1),
                fft_ms=time_ms(lambda: torch.fft.irfft(unpack_half(YpM.reshape(-1, M_)), n=M_,
                                                       dim=-1), 5),
                library_ms=time_ms(lambda: torch.matmul(YpM.reshape(-1, M_), enhM.S), 3))
            del YpM
            dM = np.stack([geometry.calc_ca_delays(mpos5, az, np.pi / 2) for az in ang_])
            stM = steering_weights(array_manifold(M_, float(FS), torch.tensor(
                dM, dtype=torch.float32, device=dev)))
            by_M["gsc_rls_zelinski_steered"][M_] = kernel_row(
                f"gsc_rls_zelinski_steered M={M_}",
                time_ms(lambda: gsc_rls_zelinski_steered(YrM, *stM, *sargs[3:]), 3),
                k6_bound_at(M_, TfM, B, C),
                plain_ms_b32=timed(lambda: gsc_postfilter_fused(
                    YrM[:, :n32], None, *(t[:n32] for t in stM), "rls", *sargs[3:], True))[1],
                library_ms=None)
            del stM
            # K7 and the McCowan postfilter kernel (the beamformer's output
            # given) at the D&S weights
            wf_ = (torch.conj(enhM.wq_manifold).resolve_conj(), enhM.wq_manifold)
            zargs = (*wf_, cfgM.pf_alpha, cfgM.pf_type, cfgM.pf_min_frames)
            by_M["zelinski_apply"][M_] = kernel_row(
                f"zelinski_apply M={M_}", time_ms(lambda: zelinski_apply(YrM, *zargs), 5),
                bound(*k7_cost(TfM, B, C, M_, False)),
                plain_ms=time_ms(lambda: zelinski_apply_plain(YrM, *zargs), 1), library_ms=None)
            pcM = coherence_constants("mccowan", diffuse_noise_coherence(mpos, M_, float(FS)),
                                      enhM.wq_manifold, 1).to(dev)
            YbM = pack_half(apply_weights(wf_[0], unpack_half(YrM).movedim(-2, -1)))
            pargs = (*wf_, "mccowan", pcM, cfgM.pf_alpha, cfgM.pf_type, cfgM.pf_min_frames)
            by_M["coherence_postfilter"][M_] = kernel_row(
                f"coherence_postfilter mccowan M={M_}",
                time_ms(lambda: coherence_postfilter(YrM, YbM, *pargs), 5),
                pf_bound_at(M_, TfM, B, C),
                plain_ms=time_ms(lambda: coherence_postfilter_plain(YrM, YbM, *pargs), 1),
                library_ms=None)
            del YbM
            # config 4's kernels: K9 (NLMS) on the far end, K10 with 0.1-scale
            # noise filters, K12 on the first iteration's systems, K11
            VpM = analysis_tm_fused(play16[:, None, :], enhM.h, fb_, hr=enhM.hr)[:, :, 0, :]
            aargs = ("nlms", cfg4.aec_delta, cfg4.aec_epsilon, cfg4.aec_threshold)
            by_M["aec_scan"][M_] = kernel_row(
                f"aec_scan nlms M={M_}", time_ms(lambda: aec_scan(YrM, VpM, *aargs), 5),
                aec_bound_at(M_, TfM, B, C),
                plain_ms=time_ms(lambda: plain_aec(YrM, VpM), 1), library_ms=None)
            log(f"  aec_scan nlms M={M_} launch {aec_launch_shape(B, C, M_, 'nlms')}")
            del VpM
            GM = torch.from_numpy((0.1 * (rng.standard_normal((B, C, F_, C * P))
                                          + 1j * rng.standard_normal((B, C, F_, C * P)))
                                   ).astype(np.complex64)).to(dev)
            Xc = frames(YrM[:, :n32])
            by_M["wpe_stats"][M_] = kernel_row(
                f"wpe_stats M={M_} (C, P) = ({C}, {P}), filters",
                time_ms(lambda: wpe_stats(YrM, GM, lower, P, has_g=True), 3),
                stats_bound_at(M_, TfM, B, C, P),
                plain_ms_b32=timed(lambda: stats_plain(Xc, GM[:n32], lower, P, True))[1],
                library_ms=None)
            R0M, r0M = wpe_stats(YrM, torch.zeros_like(GM), lower, P, has_g=False)
            R0M = wpe_load(R0M)
            by_M["gj_solve"][M_] = kernel_row(
                f"gj_solve M={M_} n = {C * P}, {B * C * F_} systems",
                time_ms(lambda: gj_solve(R0M, r0M), 5), gj_bound(C * P, B * C * F_),
                plain_ms_b32=timed(lambda: gj_solve_plain(R0M[:n32], r0M[:n32]))[1],
                library_ms=time_ms(lambda: torch.linalg.solve(R0M, r0M), 1))
            del R0M, r0M
            Lg = torch.stack([torch.nn.functional.pad(Xc[:16], (0, 0, lower + dp, 0))[:, :, :TfM]
                              for dp in range(P)], dim=-1)  # [16, C, Tf, F, P]
            Lg = Lg.permute(0, 3, 1, 4, 2).reshape(16, F_, C * P, TfM)
            G16 = GM[:16].conj()[:, :, :, None, :].resolve_conj()
            by_M["wpe_resid"][M_] = kernel_row(
                f"wpe_resid M={M_} (C, P) = ({C}, {P})",
                time_ms(lambda: wpe_resid(YrM, GM, lower), 5), k11_bound_at(M_, TfM, B, C, P),
                plain_ms_b32=timed(lambda: resid_plain(Xc, GM[:n32], lower))[1],
                library_ms=time_ms(lambda: torch.matmul(G16, Lg[:, None]), 3) * B / 16)
            del GM, Xc, Lg, G16, YrM
            # the LMS scan (with its gate pass) and the gate pass alone at 8 channels
            wq8, bm8 = gsc_weights(M_, float(FS), delays3, 1)
            w8 = (wq8.to(dev), bm8.to(dev), array_manifold(M_, float(FS), delays3).to(dev),
                  cfg.lms, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
            Yr8 = analysis_tm_fused(x16_8, enhM.h, fb_, hr=enhM.hr)
            by_M["gsc_lms_zelinski"][M_] = kernel_row(
                f"gsc_lms_zelinski M={M_} C={C3} (gate pass included)",
                time_ms(lambda: gsc_lms_zelinski(Yr8, *w8), 3), lms_bound_at(M_, TfM, B, C3),
                plain_ms_b32=timed(lambda: gsc_postfilter_fused(
                    Yr8[:, :n32], None, *w8[:3], "lms", *w8[3:], True))[1],
                library_ms=None)
            if not torch.equal(lms_gates(Yr8, cfg.lms), lms_silence_gates(Yr8, cfg.lms)):
                raise AssertionError(f"lms_gates at M={M_} x {C3} ch differs from the plain gates")
            by_M["lms_gates"][M_] = kernel_row(
                f"lms_gates M={M_} C={C3} (flag for flag equal to the plain gates)",
                time_ms(lambda: lms_gates(Yr8, cfg.lms), 5), bound(*gates_cost(TfM, B, M_)),
                plain_ms=time_ms(lambda: lms_silence_gates(Yr8, cfg.lms), 1), library_ms=None)
            del Yr8, w8
        del enhM
    # the other paths at B=256 x 10 s: (name, M, r, configuration fields,
    # channels, launches of one forward)
    k4 = {"analysis_tm": 2, "aec_scan": 1, "wpe_stats": 2, "gj_solve": 2, "wpe_resid": 1}
    rls16 = {"gsc_rls_zelinski": 1, "synthesis_tm": 1}
    lms16 = {"lms_gates": 1, "gsc_lms_zelinski": 1, "synthesis_tm": 1}
    chain4 = dict(aec="nlms", wpe=True, wpe_iterations=2)
    paths16 = (
        ("config4-m1024-b256", 1024, 1, chain4, C, k4 | rls16),
        ("gsc-lms-c8-m2048-b256", 2048, 1, dict(beamformer="gsc_lms"), C3,
         {"analysis_tm": 1} | lms16),
        ("ds-zelinski-m2048-b256", 2048, 1, dict(beamformer="ds"), C,
         {"analysis_tm": 1, "zelinski_apply": 1, "synthesis_tm": 1}),
        # then at B=8 x 2 s, checked only: config 4 at 8 channels (C*P = 40)
        # and with the block Kalman canceller, D&S + McCowan, GSC-RLS +
        # Zelinski at r = 3 (m*R = 32 in K3's tile of 48 rows)
        ("config4-c8-m1024-b8", 1024, 1, dict(beamformer="gsc_lms", **chain4), C3, k4 | lms16),
        ("config4-block-kalman-m2048-b8", 2048, 1,
         chain4 | dict(aec="block_kalman", aec_delta=KALMAN_P[0], aec_epsilon=KALMAN_P[1]), C,
         k4 | rls16),
        ("ds-mccowan-m2048-b8", 2048, 1, dict(beamformer="ds", postfilter="mccowan"), C,
         {"analysis_tm": 1, "coherence_postfilter": 1, "synthesis_tm": 1}),
        ("flagship-r3-m1024-b8", 1024, 3, {}, C, {"analysis_tm": 1} | rls16),
    )
    T16 = min(2 * FS, T)
    for name_, M_, r_, kw_, C_, want_ in paths16:
        fb_ = FilterbankParams(M=M_, m=4, r=r_, delay_compensation_type=2)
        cfg_ = dataclasses.replace(cfg, fb=fb_, **kw_)
        enh_ = build_pipeline(cfg_, mpos3 if C_ == C3 else mpos, delays3 if C_ == C3 else delays,
                              *prototypes_at(M_, r_))
        n_ = 8 if name_.endswith("-b8") else B
        xin = (x16_8 if C_ == C3 else x16)[:n_]
        if n_ == 8:
            xin = xin[..., :T16].contiguous()
        args_ = (xin,) + ((play16[:n_, :xin.shape[-1]].contiguous(),)
                          if cfg_.aec != "none" else ())
        log(f"== 16c. {name_}: build_pipeline(beamformer={cfg_.beamformer!r}, "
            f"postfilter={cfg_.postfilter!r}, aec={cfg_.aec!r}, wpe={cfg_.wpe}), M={M_} "
            f"r={fb_.r}, {n_} x {C_} ch x {xin.shape[-1] / FS:g} s")
        cells16[name_] = check_path(name_, enh_, args_, want_)
        del enh_
    # config 5 at M = 1024 and 2048: SRP-PHAT DOA -> steered GSC-RLS +
    # Zelinski, one source per utterance at a grid direction plus sensor
    # noise 20 dB down
    src16 = signal(rng, (8, T16 + 64))
    x516 = 0.1 * signal(rng, (8, C, T16))
    for b, gi in enumerate(placed_):
        d = geometry.calc_ca_delays(mpos5, phis5[gi], np.pi / 2)
        for c in range(C):
            off = 8 - int(round(float(d[c]) * FS))
            x516[b, c] += src16[b, off:off + T16]
    x516 = torch.from_numpy(x516).to(dev)
    for M_ in (1024, 2048):
        name_ = f"config5-m{M_}-b8"
        fb_ = FilterbankParams(M=M_, m=4, r=1, delay_compensation_type=2)
        cfg_ = dataclasses.replace(cfg, fb=fb_)
        enh_ = build_steered_pipeline(cfg_, mpos5, *prototypes_at(M_), [np.pi / 2], phis5)
        log(f"== 16d. {name_}: build_steered_pipeline(), M={M_}, 8 x {C} ch x 2 s")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        with torch.no_grad():
            y_, doa_ = enh_(x516)
        torch.cuda.synchronize()
        c_ = kernels.launch_counts()
        peak_ = torch.cuda.max_memory_allocated() / 1e9
        log(f"  {name_} launches {c_}")
        want = dict.fromkeys(c_, 0) | {"analysis_tm": 1, "gsc_rls_zelinski_steered": 1,
                                       "synthesis_tm": 1}
        if c_ != want:
            raise AssertionError(f"{name_} launches {c_}, the path needs {want}")
        with torch.no_grad():
            Yr_ = analysis_half_real_tm(x516, enh_.h, fb_, packed=True, A=enh_.A)
            gidx_, vs_ = enh_.steer(Yr_)
            ref_ = synthesis_half_real_tm(gsc_postfilter_fused(
                Yr_, None, *steering_weights(vs_), "rls", cfg_.rls, cfg_.pf_alpha,
                cfg_.pf_type, cfg_.pf_min_frames, True), enh_.g, fb_, S=enh_.S)
            if not torch.equal(doa_, enh_.grid[gidx_]):
                raise AssertionError(f"{name_} DOA differs from the plain chain's")
            n_placed = (doa_[:, 1].cpu() == torch.tensor(phis5[placed_],
                                                         dtype=torch.float32)).sum()
            log(f"  DOA equal to the plain chain's; at the placed direction: {n_placed.item()} "
                f"of 8")
            err_ = compare(f"{name_} (build_steered_pipeline) vs plain chain", y_, ref_, 3e-4)
            ms_ = time_ms(lambda: enh_(x516), 3)
        cells16[name_] = dict(ms=ms_, audio_s_per_s=8 * T16 / FS / (ms_ / 1e3), peak_gb=peak_,
                              max_abs_err=err_, launches=c_)
        log(f"  {name_}: {ms_:.3f} ms ({8 * T16 / FS / (ms_ / 1e3):.1f} audio-s/s/GPU)")
        del enh_, y_, ref_, Yr_
    del x16, x16_8, play16, x516, src16
    counts16 = {k: v.pop("launches") for k, v in cells16.items()}
    for name_, cell_ in cells16.items():
        log(f"  phase 16 {name_}: {cell_['ms']:.3f} ms, {cell_['audio_s_per_s']:.1f} "
            f"audio-s/s/GPU, peak {cell_['peak_gb']:.2f} GB, {cell_['max_abs_err']:.3g} max abs "
            f"error against the plain chain")
    log("  phase 16's paths: " + json.dumps(cells16))
    log(f"  phase 16 took {time.perf_counter() - t16:.1f} s")

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
        "gsc_rls_zelinski_steered": (
            "gsc_rls_zelinski.cu", "distant_speech_recognition_tpu/models/pallas_fused_scan.py:1318"),
        "zelinski_apply": ("zelinski_apply.cu",
                           "distant_speech_recognition_tpu/models/pallas_fused_scan.py:1571"),
        "fw_mono": ("fw_mono.cu", "distant_speech_recognition_tpu/models/pallas_fused_scan.py:1661"),
        "gsc_mono": ("gsc_mono.cu",
                     "distant_speech_recognition_tpu/models/pallas_fused_scan.py:999"),
        "gsc_analysis": ("gsc_mono.cu",
                         "distant_speech_recognition_tpu/models/pallas_fused_scan.py:876"),
        "polyphase_fir": ("polyphase_fir.cu",
                          "distant_speech_recognition_tpu/ops/pallas_kernels.py:674"),
        # no TPU kernel: the JAX package runs this scan in XLA
        "gsc_lms_zelinski": ("gsc_lms_zelinski.cu",
                             "distant_speech_recognition_tpu/models/adaptive_gsc.py:346 "
                             "(XLA scan, kind='lms'; no TPU kernel)"),
        "lms_gates": ("gsc_lms_zelinski.cu",
                      "distant_speech_recognition_tpu/models/adaptive_gsc.py:169 "
                      "(the LMS step's silence gate in the XLA scan; no TPU kernel)"),
        "coherence_postfilter": (
            "coherence_postfilter.cu",
            "distant_speech_recognition_tpu/models/postfilter.py:178/:223/:287 "
            "(XLA scans of mccowan / lefkimmiatis / apab_postfilter; no TPU kernel)"),
        # the per-utterance forms of K7 and of the LMS scan (the steered D&S
        # and GSC-LMS; the JAX package's steered chain runs both in XLA)
        "zelinski_apply_steered": (
            "zelinski_apply.cu",
            "distant_speech_recognition_tpu/models/pallas_fused_scan.py:1571 "
            "(zelinski_apply_pallas, with one set of weights per utterance)"),
        "gsc_lms_zelinski_steered": (
            "gsc_lms_zelinski.cu",
            "distant_speech_recognition_tpu/models/adaptive_gsc.py:346 "
            "(XLA scan, kind='lms', one steering per utterance; no TPU kernel)"),
    }
    times["coherence_postfilter"] = pf13["mccowan"][:2]  # McCowan REAL, Y given: gsc-rls-mccowan's
    log("  phase 14's paths: " + json.dumps({k: {k2: v2 for k2, v2 in v.items()
                                                if k2 != "launches"}
                                            for k, v in cells14.items()}))
    library["coherence_postfilter"] = None
    by_path = {"flagship": counts, "config4": counts4, "config4_block_kalman": counts4bk,
               "fixed_weight": counts_fw, "fixed_weight_split": counts_split,
               "config5": counts5, "filterbank": counts_fb, "config3": counts3,
               "config4_c8": counts12, "config4_c8_rls": counts12r} | {
                   f"{bf}_none": c for bf, c in counts_none.items()} | counts13 | counts14 | counts15 | (
                       counts16)
    # the RLS kernels at config 3's 8 channels (phase 11)
    c8 = {"gsc_rls_zelinski": (k2_8_ms, k2_bound(C3)), "gsc_mono": (k4_8_ms, k4_bound(C3))}
    for name, (ms_, (b_ms, b_by)) in c8.items():
        log(f"  {name} at {C3} channels: {ms_:.3f} ms, bound {b_ms:.3f} ms ({b_by}), "
            f"{100 * b_ms / ms_:.1f}% of it")
    rows_json = []
    for name, (src, rep) in sources.items():
        b_ms, b_by = bounds[name]
        log(f"  {name}: bound {b_ms:.3f} ms ({b_by}), kernel at "
            f"{100 * b_ms / times[name][0]:.1f}% of it")
        row = {
            "name": name, "route": "cuda",
            "source": f"distant_speech_recognition_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": sum(c[name] for c in by_path.values()),
            "launches_by_path": {path: c[name] for path, c in by_path.items()},
            "max_abs_err": results[name],
            "ms": times[name][0], "plain_ms": times[name][1],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": library[name],
        }
        if name + "_vs_split" in results:  # the one-kernel chains against the split kernels
            row["max_abs_err_vs_split"] = results[name + "_vs_split"]
        if name in fft_ms:
            row["fft_ms"] = fft_ms[name]
        if name in by_M:  # phases 14 and 16: the kernel at M = 64 .. 2048, B=256 x 10 s
            row["by_M"] = {str(M_): e | {"launches": sum(
                c[name] for p_, c in (counts14 | counts16).items() if f"-m{M_}-" in p_)}
                for M_, e in by_M[name].items()}
        if name == "analysis_tm":
            row["dense_route_ms"] = dense_route_ms
        if name in scan_ms:  # the scans: times at other batches, and K2/K6's launch at each
            row["ms_by_batch"] = scan_ms[name]
            if name != "gsc_lms_zelinski":
                row["launch_by_batch"] = {b: scan_shapes[f"{b} C=4"] for b in scan_ms[name]}
        if name in c8:
            row["c8"] = {"ms": c8[name][0], "bound_ms": c8[name][1][0],
                         "bound_by": c8[name][1][1]}
        if name == "gsc_lms_zelinski":  # "ms" includes the gate pass it launches first
            row["launch"] = lms_shape
            row["none_ms"] = lms_none_ms
        if name in alone:  # alone at other batches and shapes, each beside its bound
            row["by_batch"] = alone[name]
        if name in ("zelinski_apply_steered", "gsc_lms_zelinski_steered"):
            row["plain_ms_utterances"] = B15  # the plain loop timed on the first 16
        if name == "gsc_lms_zelinski_steered":  # "ms" includes the gate pass it launches first
            row["steered_paths"] = {k: {k2: v2 for k2, v2 in v.items() if k2 != "launches"}
                                    for k, v in cells15.items()}
        if name == "wpe_stats":  # "ms" is the later EM iteration's, with filters
            row["first_iteration_ms"] = stats_first_ms
        if name in wide8:  # K9-K12 at config 4's 8 channels (C*P = 40; phase 12)
            row["c8"] = wide8[name]
        if name == "aec_scan":  # "ms" is NLMS's, the path's
            row["kalman_ms"], row["kalman_plain_ms"] = kalman_ms
            row["block_kalman_ms"], row["block_kalman_plain_ms"] = block_kalman_ms
            row["launch"] = aec_shapes[f"B={B} C={C} nlms"]
        if name == "coherence_postfilter":  # "ms" is McCowan's in REAL mode, Y given
            row["by_kind"] = {
                k_: {"ms": v[0], "plain_ms": v[1], "fixed_weight_ms": v[2],
                     "bound_ms": pf_bound(k_)[0], "bound_by": pf_bound(k_)[1],
                     "fixed_weight_bound_ms": pf_bound(k_, given=False)[0]}
                for k_, v in pf13.items()}
            row["c8"] = {"ms": pf13_c8_ms, "bound_ms": pf_bound("mccowan", C3)[0],
                         "bound_by": pf_bound("mccowan", C3)[1]}
            row["paths"] = path13
        if name == "gj_solve":  # "ms" is n = C*P = 20's, the path's
            b24 = gj_bound(C * (P + 1), n_sys)
            row["n24"] = {"ms": gj24_ms[0], "plain_ms": gj24_ms[1], "library_ms": gj24_ms[2],
                          "bound_ms": b24[0], "bound_by": b24[1]}
            b40 = gj_bound(40, n_sys40)
            row["n40"] = {"ms": gj40_ms[0], "plain_ms": gj40_ms[1], "library_ms": gj40_ms[2],
                          "bound_ms": b40[0], "bound_by": b40[1]}
        rows_json.append(row)
    log(f"script time {time.perf_counter() - t_script:.1f} s")
    log(json.dumps({"kernels": rows_json}))
    log(smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--profile-flagship"]:
        profile_flagship(int(sys.argv[2]))
    else:
        main()
    sys.exit(0)
