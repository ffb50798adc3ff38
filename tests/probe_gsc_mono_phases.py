"""Where the one-kernel flagship chain (K4, ``csrc/gsc_mono.cu``) spends its time, on the card.

The script builds a copy of the kernels in which K4 reads ``clock64()``
after each block barrier of its frame-tile loop and thread 0 sums the
cycles of each stage between barriers: the analysis FIR rows, the analysis
FFT, the GSC-RLS + Zelinski frames, the synthesis FFT, the synthesis FIR
and overlap-add, the halo copy.  The copy splits the frames further with
marks inside the frame loop: the split reads of the frame's bins, the
frame-energy reduction (a named barrier over the scan warps), the weight
reads and the RLS + Zelinski step, the window writes, and the wait at the
barrier after the tile's frames.  It runs that copy through this
checkout's wrapper at the flagship cell's shape (GSC-RLS + Zelinski, M=256,
m=4, r=1, 4 ch x 10 s of int16-scale noise) with B = 256 (two utterances
per SM), 132 (one per SM) and 1 (one on the whole card), and prints each
stage's thousands of cycles per block (mean over blocks) beside the
kernel's CUDA-event time.  The instrumented kernel overwrites the first
samples of each output; nothing else differs from ``gsc_mono.cu``.

    python3 tests/probe_gsc_mono_phases.py

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "tests"))

from probe_fw_mono_phases import instrumented, instrumented_library, report  # noqa: E402

from distant_speech_recognition_tpu_torch.kernels import _build  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fused_scan import (  # noqa: E402
    analysis_gsc_synthesis,
)
from distant_speech_recognition_tpu_torch.models.pipeline import (  # noqa: E402
    PipelineConfig,
    build_pipeline,
)
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

# ph[i] holds stage i: 0-5 end at the tile loop's block barriers (2 is what
# is left of the frames after 6-9), 6-9 at the marks inside the frame loop
STAGES = ("analysis FIR", "analysis FFT", "frames: barrier after the tile", "synthesis FFT",
          "synthesis FIR + OLA", "halo copy", "frames: split reads", "frames: energy reduction",
          "frames: weights + step", "frames: window writes")
# the marks inside the frame loop: (text they follow, stage)
FRAME_MARKS = (
    ("X[c] = fft::split_bin<M_>(P, tk * C + c, fc);\n", 6),
    ("block_sum<BAR_SCAN>(e, red[t & 1], lane, warp, nwarps) / (float)M_;\n", 7),
    ("tac, X, energy_t, t, p);\n", 8),
    ("fft::put_pair_bin<M_>(cw + (halo + tk) * LD, f, Ya, {0.f, 0.f});\n"
     "          }\n        }\n", 9),
)
STORE = ("if (SYNTH && tid == 0) for (int i = 0; i < 10; ++i) "
         "out[(size_t)b * T_out * D + i] = (float)ph[i];")


def with_marks(src: str) -> str:
    """``gsc_mono.cu`` with the stage counts of `instrumented` and the
    frame-loop marks."""
    src = instrumented(src, "// the kernel's shared memory limit and carveout", STAGES[:6], STORE)
    for anchor, stage in FRAME_MARKS:
        if src.count(anchor) != 1:
            raise RuntimeError(f"gsc_mono.cu no longer has one {anchor!r}")
        src = src.replace(anchor, anchor + "{ const long long now = clock64(); "
                          f"ph[{stage}] += now - last; last = now; }}\n")
    return src


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    _build.library()
    _build._lib = instrumented_library("gsc_mono.cu", with_marks)
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=16000.0, beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2)
    mpos = np.c_[np.arange(4) * 50.0, np.zeros((4, 2))]
    enh = build_pipeline(cfg, mpos, geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3),
                         *load_pair(256, 4, 1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 4, 160000), dtype=np.float32) * 1500).cuda()
    w = (enh.wqH, enh.BmH, enh.wq_manifold, cfg.rls, cfg.pf_alpha, cfg.pf_type, cfg.pf_min_frames)
    report(lambda B: analysis_gsc_synthesis(x[:B], enh.h, enh.g, fb, *w, hr=enh.hr, gf=enh.gf),
           STAGES, (256, 132, 1))


if __name__ == "__main__":
    main()
