"""Where the one-kernel fixed-weight chain (K8, ``csrc/fw_mono.cu``) spends its time, on the card.

The script builds a copy of the kernels in which K8 reads ``clock64()``
after each block barrier of its frame-tile loop and sums the cycles of each
stage between barriers: (1) the analysis FIR rows, (2) the analysis FFT,
(3) fixed weights + Zelinski, (4) the synthesis FFT, (5) the synthesis FIR
and overlap-add, (6) the halo copy.  It runs that copy through this
checkout's wrapper at the fixed-weight cell's shape (D&S, M=256, m=4, r=1,
4 ch x 10 s of int16-scale noise) with B = 256 (two utterances per SM), 132
(one per SM) and 1 (one on the whole card), and prints each stage's
thousands of cycles per block (mean over blocks; thread 0's clock) beside
the kernel's CUDA-event time.  The instrumented kernel overwrites the first
samples of each output; nothing else differs from ``fw_mono.cu``.

    python3 tests/probe_fw_mono_phases.py

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from distant_speech_recognition_tpu_torch.kernels import _build  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fixed_weight import (  # noqa: E402
    analysis_fw_synthesis,
)
from distant_speech_recognition_tpu_torch.models.pipeline import (  # noqa: E402
    PipelineConfig,
    build_pipeline,
)
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

STAGES = ("analysis FIR", "analysis FFT", "weights + Zelinski", "synthesis FFT",
          "synthesis FIR + OLA", "halo copy")
LOOP = "  for (int t0 = 0; t0 < Tf; t0 += K) {"


def instrumented(src: str, end: str, stages, store: str) -> str:
    """A kernel source with a cycle count per stage of its frame-tile loop
    (the text from `LOOP` to ``end``, one stage per block barrier): thread 0
    sums stage i's ``clock64()`` cycles in ``ph[i]`` (16 slots; ``last``
    holds the clock at the last mark) and, after the loop, runs ``store``
    (a statement that writes the ``ph[i]`` it wants)."""
    start = src.index(LOOP)
    stop = src.index(end)
    parts = src[start:stop].split("__syncthreads();")
    if len(parts) - 1 != len(stages):
        raise RuntimeError(f"the tile loop has {len(parts) - 1} barriers, "
                           f"the probe knows {len(stages)} stages")
    body = parts[0].replace(LOOP, "  long long ph[16] = {};\n  long long last = clock64();\n" + LOOP)
    for i, part in enumerate(parts[1:]):
        body += ("__syncthreads(); { const long long now = clock64(); "
                 f"ph[{i}] += now - last; last = now; }}" + part)
    tail = body.rindex("  }\n}\n")
    body = body[:tail] + f"  }}\n  {store}\n}}\n" + body[tail + len("  }\n}\n"):]
    return src[:start] + body + src[stop:]


def instrumented_library(name: str, transform):
    """Build the kernels with ``csrc/<name>`` rewritten by ``transform``
    (source text -> source text) under the package's (ignored) build dir
    and load them."""
    root = _build.BUILD_DIR / f"{name.split('.')[0]}_phases"
    pkg = root / "distant_speech_recognition_tpu_torch"
    if root.exists():
        shutil.rmtree(root)
    for sub in ("csrc", "kernels"):
        shutil.copytree(_build.CSRC_DIR.parent / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    src = pkg / "csrc" / name
    src.write_text(transform(src.read_text()))
    spec = importlib.util.spec_from_file_location("phases_build", pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def report(run, stages, batches) -> None:
    """Run ``run(B)`` (returns samples [B, ...] whose first entries are the
    stage counts) for each B after a warm-up and print each stage's
    thousands of cycles per block beside the CUDA-event time (``sum``: of
    all stages, which is one block's time where they run one after the
    other)."""
    for B in batches:
        run(B)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        y = run(B)
        end.record()
        torch.cuda.synchronize()
        kc = y[:, :len(stages)].double().mean(0).cpu().numpy() / 1e3
        text = "  ".join(f"{n} {v:.0f}" for n, v in zip(stages, kc))
        print(f"B={B}: {start.elapsed_time(end):.3f} ms; kcycles per block: {text}; "
              f"sum {kc.sum():.0f}")


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    _build.library()
    _build._lib = instrumented_library("fw_mono.cu", lambda src: instrumented(
        src, "template <int C>\nint launch(", STAGES,
        "if (tid == 0) for (int i = 0; i < 8; ++i) ob[i] = (float)ph[i];"))
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=16000.0, beamformer="ds", postfilter="zelinski",
                         pf_min_frames=2)
    mpos = np.c_[np.arange(4) * 50.0, np.zeros((4, 2))]
    enh = build_pipeline(cfg, mpos, geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3),
                         *load_pair(256, 4, 1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 4, 160000), dtype=np.float32) * 1500).cuda()
    w = (enh.wqH, enh.wq_manifold, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
    report(lambda B: analysis_fw_synthesis(x[:B], enh.h, enh.g, fb, *w, hr=enh.hr, gf=enh.gf),
           STAGES, (256, 132, 1))


if __name__ == "__main__":
    main()
