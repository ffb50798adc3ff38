"""The M = 256 filterbank kernels of this checkout against another's, bit for bit, on the card.

K1 (``csrc/analysis_tm.cu``), K3 (``csrc/synthesis_tm.cu``), K4/K5
(``csrc/gsc_mono.cu``) and K8 (``csrc/fw_mono.cu``) share the
shared-memory FFT plan of ``csrc/dsr_fft.h``.  ``--root DIR`` builds the
kernels of another checkout of the repository (e.g. the parent commit
unpacked with ``git archive``) with that checkout's own build module, runs
both on the same inputs and prints, per case, whether this checkout's
output equals the other's bit for bit: the stored cases below (hash-noise
inputs, K1 at C = 4 and at C = 3 with r = 2, K3 at R = 2 and 4, K4 at C = 2
and 4, K5 and K8 at C = 4) and the flagship shape (B = 256 x 4 ch x 10 s of
numpy noise, seed 0) for K1, K3, K4, K5 and K8, and there K7
(``csrc/zelinski_apply.cu``, the fixed-weight Zelinski kernel, which uses no
FFT) on K1's output in both Zelinski modes, the gain from frame 3 and
never.  It also times K1, K3, K4, K5, K8 and K7 of both checkouts at that
shape in turns (other, this, this, other; CUDA events, mean of 5 after a
warm-up).  ``--write-case PATH`` stores the
other checkout's outputs of the stored cases (with their prototypes and
weights) for ``tests/test_torch_kernels.py::
test_filterbank_kernels_equal_stored_outputs``.

    python3 tests/probe_filterbank_bits.py --root DIR [--write-case PATH]

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from distant_speech_recognition_tpu_torch.kernels import _build, stream_handle  # noqa: E402
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (  # noqa: E402
    GSCRLSConfig,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fixed_weight import (  # noqa: E402
    analysis_fw_synthesis,
    zelinski_apply,
)
from distant_speech_recognition_tpu_torch.models.fused_scan import NO_POSTFILTER  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fused_scan import (  # noqa: E402
    analysis_gsc_rls_zelinski,
    analysis_gsc_synthesis,
)
from distant_speech_recognition_tpu_torch.ops.filterbank import (  # noqa: E402
    FilterbankParams,
    analysis_taps,
    num_analysis_frames,
)
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (  # noqa: E402
    fft_twiddles_tensor,
    prototype_taps,
    synthesis_tm_fused,
)
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

FS = 16000.0
PF = (0.6, 1, 2)  # Zelinski alpha, REAL mode, pf_min_frames
# stored cases: (tag, kernel, B, C or T_in, fb keywords)
CASES = (
    ("k1_c4", "K1", 1, 4, dict(r=1, delay_compensation_type=2)),
    ("k1_c3_r2", "K1", 1, 3, dict(r=2, delay_compensation_type=0)),
    ("k3", "K3", 2, 40, dict(r=1, delay_compensation_type=2)),
    ("k3_r2", "K3", 1, 40, dict(r=2, delay_compensation_type=1)),
    ("k4_c2", "K4", 1, 2, dict(r=1, delay_compensation_type=2)),
    ("k4_c4", "K4", 1, 4, dict(r=1, delay_compensation_type=2)),
    ("k5_c4", "K5", 1, 4, dict(r=1, delay_compensation_type=2)),
    ("k8_c4", "K8", 1, 4, dict(r=1, delay_compensation_type=2)),
)
CASE_T = 1500  # samples of a stored case's utterances


def hash_noise(shape, seed) -> np.ndarray:
    """`tests/test_torch_kernels.py`'s ``_hash_noise``: the same bits on
    every machine."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


def case_input(tag: str, kernel: str, B: int, n: int) -> np.ndarray:
    """A stored case's input: samples [B, C, T] (x 15: int16 scale) or, for
    K3, packed frames [T_in, B, 256]."""
    if kernel == "K3":
        return hash_noise((n, B, 256), sum(map(ord, tag)))
    return hash_noise((B, n, CASE_T), sum(map(ord, tag))) * np.float32(15.0)


def load_root(root: Path):
    """Build ``root``'s kernels under this checkout's (ignored) build dir
    with ``root``'s own build module and load them."""
    out = _build.BUILD_DIR / "filterbank_bits_root"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(root / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    spec = importlib.util.spec_from_file_location("filterbank_bits_root_build",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def k1(lib, x: torch.Tensor, h, fb: FilterbankParams) -> torch.Tensor:
    """K1 through ``lib``'s C entry: this checkout's, or an older one that
    still takes the dense-product matrix A (passed as null) after the
    twiddles."""
    hr = prototype_taps(analysis_taps, h, fb, x.device)
    tw = fft_twiddles_tensor(fb.M, x.device)
    B, C, T = x.shape
    Tf = num_analysis_frames(fb, T)
    out = torch.empty((Tf, B, C, fb.M), device=x.device)
    ptrs = [x.data_ptr(), hr.data_ptr(), tw.data_ptr()]
    if len(lib.dsr_analysis_tm.argtypes) == 14:
        ptrs.append(None)
    code = lib.dsr_analysis_tm(*ptrs, out.data_ptr(), B, C, T, Tf, fb.M, fb.m, fb.D,
                               fb.laN - (fb.m * fb.R - 1), stream_handle(x.device))
    _build.check(code, "analysis_tm")
    return out


def weights(C: int, dev):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    wqH, BmH = gsc_weights(256, FS, delays, 1)
    vs = array_manifold(256, FS, delays)
    return wqH.to(dev), BmH.to(dev), vs.to(dev)


def run(lib, kernel: str, inp: torch.Tensor, fb, h, g, w) -> torch.Tensor:
    """One kernel of ``lib`` (K3-K8 through this checkout's wrappers, whose C
    interface is the same in both checkouts)."""
    own = _build._lib
    _build._lib = lib
    try:
        if kernel == "K1":
            return k1(lib, inp, h, fb)
        if kernel == "K3":
            return synthesis_tm_fused(inp, g, fb)
        wqH, BmH, vs = w
        if kernel.startswith("K7"):  # K7r: real mode, gain from frame 3; K7a: modulus, none
            pf = PF if kernel == "K7r" else (0.6, 2, NO_POSTFILTER)
            return zelinski_apply(inp, vs.conj().resolve_conj(), vs, *pf)
        if kernel == "K4":
            return analysis_gsc_synthesis(inp, h, g, fb, wqH, BmH, vs, GSCRLSConfig(min_frames=4),
                                          *PF)
        if kernel == "K5":
            return analysis_gsc_rls_zelinski(inp, h, fb, wqH, BmH, vs, GSCRLSConfig(min_frames=4),
                                             *PF)
        return analysis_fw_synthesis(inp, h, g, fb, vs.conj().resolve_conj(), vs, *PF)
    finally:
        _build._lib = own


def event_ms(fn, reps=5) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, required=True, help="the other checkout")
    ap.add_argument("--write-case", type=Path, default=None,
                    help="store the other checkout's outputs of the stored cases here")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    own = _build.library()
    other = load_root(args.root.resolve())
    h, g = (torch.as_tensor(a, dtype=torch.float32) for a in load_pair(256, 4, 1))
    hd, gd = h.to(dev), g.to(dev)
    z = {"h": h.numpy(), "g": g.numpy()}
    same_all = []
    for tag, kernel, B, n, kw in CASES:
        fb = FilterbankParams(**{"M": 256, "m": 4, **kw})
        C = n if kernel != "K3" else 1
        w = weights(C, dev) if kernel in ("K4", "K5", "K8") else None
        inp = torch.from_numpy(case_input(tag, kernel, B, n)).to(dev)
        a, b = run(other, kernel, inp, fb, hd, gd, w), run(own, kernel, inp, fb, hd, gd, w)
        same = torch.equal(a, b)
        same_all.append(same)
        print(f"{tag} ({kernel}): this checkout equals the other bit for bit: {same}"
              + ("" if same else f" (max diff {(a - b).abs().max().item():.3g})"))
        z[f"{tag}_out"] = a.cpu().numpy()
        if w is not None:
            for k, t in zip(("wqH", "BmH", "vs"), w):
                z[f"{tag}_{k}"] = t.cpu().numpy()
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((256, 4, 160000), dtype=np.float32) * 1500).to(dev)
    w4 = weights(4, dev)
    outs = {}
    for kernel in ("K1", "K3", "K4", "K5", "K8"):
        inp = outs["K1"][..., 0, :].contiguous() if kernel == "K3" else x
        a, b = run(other, kernel, inp, fb, hd, gd, w4), run(own, kernel, inp, fb, hd, gd, w4)
        outs[kernel] = b
        same_all.append(torch.equal(a, b))
        print(f"flagship shape {kernel}: this checkout equals the other bit for bit: "
              f"{same_all[-1]}")
        del a
    Yp = outs["K1"][..., 0, :].contiguous()
    for kernel in ("K7r", "K7a"):
        a, b = (run(lib, kernel, outs["K1"], fb, hd, gd, w4) for lib in (other, own))
        same_all.append(torch.equal(a, b))
        print(f"flagship shape {kernel}: this checkout equals the other bit for bit: "
              f"{same_all[-1]}")
        del a, b
    Yr = outs["K1"]
    del outs
    for kernel, inp in (("K1", x), ("K3", Yp), ("K4", x), ("K5", x), ("K8", x), ("K7r", Yr)):
        t = [event_ms(lambda: run(lib, kernel, inp, fb, hd, gd, w4))
             for lib in (other, own, own, other)]
        print(f"{kernel} at B=256 x 4 ch x 10 s, ms in turns (other, this, this, other): "
              + ", ".join(f"{v:.4f}" for v in t))
    print(f"{sum(same_all)} of {len(same_all)} cases equal bit for bit")
    if args.write_case is not None:
        args.write_case.parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(args.write_case, **z)
        print(f"wrote {args.write_case} ({args.write_case.stat().st_size} bytes)")


if __name__ == "__main__":
    main()
