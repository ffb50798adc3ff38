"""Compare this checkout's CUDA kernels with another checkout's, bit for bit, on the card.

A refactor of kernel code that keeps the arithmetic (a shared device
function, a moved helper) should leave every output unchanged to the bit.
This script builds the kernels of this checkout and of ``OTHER`` (a
directory holding another version of ``distant_speech_recognition_tpu_torch``,
for example ``git archive <commit> | tar -x -C OTHER``), runs the analysis
(K1), scan (K2), synthesis (K3) and steered scan (K6) of both on the same
inputs through this checkout's wrappers, and prints whether each pair is
equal, with K2 at every channel count C = 2..8 and two constraint options.
It also times, at the flagship shape (B=256 x 4 ch x 10 s), the one-kernel
flagship chain (K4) beside K1 -> K2 -> K3 and K5, with CUDA events.

    python3 tests/probe_kernel_builds.py OTHER

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from distant_speech_recognition_tpu_torch.kernels import _build  # noqa: E402
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (  # noqa: E402
    GSCRLSConfig,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fused_scan import (  # noqa: E402
    analysis_gsc_rls_zelinski,
    analysis_gsc_synthesis,
    gsc_rls_zelinski,
    gsc_rls_zelinski_steered,
)
from distant_speech_recognition_tpu_torch.models.steered import steering_weights  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (  # noqa: E402
    analysis_tm_fused,
    synthesis_tm_fused,
)
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

FS = 16000.0


def other_library(root: Path):
    """The other checkout's kernel library, built with its own build module."""
    path = root / "distant_speech_recognition_tpu_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def main() -> None:
    if len(sys.argv) != 2 or not torch.cuda.is_available():
        raise SystemExit(__doc__)
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    libs = {"this": _build.library(), "other": other_library(Path(sys.argv[1]))}

    def both(fn):
        """``fn()`` through each library: this checkout's wrappers, each build's kernels."""
        outs = {}
        for name, lib in libs.items():
            _build._lib = lib
            outs[name] = fn()
            torch.cuda.synchronize()
        _build._lib = libs["this"]
        return outs

    def report(what, outs):
        a, b = outs["this"], outs["other"]
        same = torch.equal(a, b)
        print(f"{what}: {'bit-identical' if same else 'DIFFERS'}  max diff "
              f"{(a - b).abs().max().item():.3g} of max {b.abs().max().item():.3g}", flush=True)

    def delays(C):
        mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
        return geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)

    def weights(C):
        wq, bm = gsc_weights(256, FS, delays(C), 1)
        return wq.to(dev), bm.to(dev), array_manifold(256, FS, delays(C)).to(dev)

    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, g = (torch.tensor(p, dtype=torch.float32, device=dev) for p in load_pair(256, 4, 1))
    rng = np.random.default_rng(0)
    B, C, T = 256, 4, 160000
    x = torch.from_numpy(rng.standard_normal((B, C, T), dtype=np.float32) * np.float32(1500))
    x = x.to(dev)
    args = (*weights(C), GSCRLSConfig(), 0.6, 1, 2)
    with torch.no_grad():
        Yr = analysis_tm_fused(x, h, fb)
        report("K1 analysis, B=256", both(lambda: analysis_tm_fused(x, h, fb)))
        Yp = gsc_rls_zelinski(Yr, *args)
        report("K2 scan, B=256, C=4", both(lambda: gsc_rls_zelinski(Yr, *args)))
        report("K3 synthesis, B=256", both(lambda: synthesis_tm_fused(Yp, g, fb)))
        ang = 2 * np.pi * np.arange(C) / C
        circle = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
        d64 = np.stack([geometry.calc_ca_delays(circle, az, np.pi / 2)
                        for az in np.linspace(0.0, 6.0, 64)])
        steer = steering_weights(array_manifold(256, FS, torch.tensor(d64, dtype=torch.float32,
                                                                       device=dev)))
        report("K6 steered scan, B=64", both(lambda: gsc_rls_zelinski_steered(
            Yr[:, :64].contiguous(), *steer, GSCRLSConfig(), 0.6, 1, 2)))
        for C_ in range(2, 9):
            x_ = torch.from_numpy(rng.standard_normal((32, C_, 48000), dtype=np.float32)
                                  * np.float32(1500)).to(dev)
            Y_ = analysis_tm_fused(x_, h, fb)
            quadratic = GSCRLSConfig(min_frames=8, constraint_option=1, alpha2=0.01)
            for rls, pf in ((GSCRLSConfig(min_frames=8), (2, 0)), (quadratic, (1, 2))):
                a_ = (*weights(C_), rls, 0.6, *pf)
                report(f"K2 scan, B=32, C={C_}, constraint option {rls.constraint_option}",
                       both(lambda: gsc_rls_zelinski(Y_, *a_)))

        def time_ms(fn, reps=3):
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

        k4 = time_ms(lambda: analysis_gsc_synthesis(x, h, g, fb, *args))
        chain = time_ms(lambda: synthesis_tm_fused(
            gsc_rls_zelinski(analysis_tm_fused(x, h, fb), *args), g, fb))
        k5 = time_ms(lambda: analysis_gsc_rls_zelinski(x, h, fb, *args))
        k2 = time_ms(lambda: gsc_rls_zelinski(Yr, *args))
        print(f"B=256 x 4 ch x 10 s: K4 {k4:.3f} ms  K1->K2->K3 {chain:.3f} ms  K5 {k5:.3f} ms  "
              f"K2 {k2:.3f} ms")


if __name__ == "__main__":
    main()
