"""Where the GSC-LMS + Zelinski scan (``csrc/gsc_lms_zelinski.cu``) spends
its time, on the card.

The script builds a copy of the kernels in which the scan kernel reads
``clock64()`` at the ``// probe:`` marks of its source, and thread 0 of each
block (lane 0 of the block's first bin) sums the cycles between consecutive
marks per stage; the sums of all blocks are added up in device memory and
read back through a C function that the copy gains.  The stages of a frame:
the wait for its copies (with the start of the copies of the frame a ring
ahead and the two warp syncs), the front (the snapshot's reads, this lane's
rows of [Yc; Z] and its partial sums), the cross-lane sums with the
Zelinski gain, the LMS update (with its own shuffles), and the output
store; and the set-up.  It runs that copy through the C entry at BASELINE
config 3's shape (C = 8, M = 256, Tf = 1254 frames of K1's analysis of
int16-scale noise, the bench array) with B = 256, 64 and 1, the Zelinski
gain in its real mode, and at B = 256 without the gain, and prints each
stage's cycles per frame (thread 0's clock, mean over blocks) beside the
CUDA-event times of the instrumented and of the uninstrumented entries, the
device time of each of the two kernels (the gate pass and the scan, each
launched by its own C entry; torch.profiler) and the launch
(``lms_launch_shape``).  B = 1 gives the
latency of one frame's chain.  It also prints the compiler's registers and
spills of every instantiation (``-Xptxas=-v``) and, from the SASS of C = 8,
the instructions and the divisions' traces in it (FCHK, the IEEE division's
range check; MUFU.RCP; FP64 instructions; CALL, the slow paths).

``--root DIR`` also builds another checkout's kernels (e.g. the parent
commit unpacked with ``git archive``), runs its LMS scan through its C
entries on the same inputs (a library without the gate pass's entry, the
one-kernel scan that came before it, is called as that scan was), times
both in turns on this card (other, this, this, other)
and prints the largest difference of this checkout's output from the
other's over max|other|.
``--write-case PATH`` stores the cases of
``tests/test_torch_kernels.py::test_lms_scan_equals_stored_outputs`` from
this checkout's kernel.

    python3 tests/probe_gsc_lms_phases.py [--root DIR] [--write-case PATH]

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from distant_speech_recognition_tpu_torch.kernels import (  # noqa: E402
    _build,
    complex_view,
    stream_handle,
)
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (  # noqa: E402
    GSCLMSConfig,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fused_scan import (  # noqa: E402
    NO_POSTFILTER,
    _lms_args,
    gsc_lms_zelinski,
    lms_launch_shape,
)
from distant_speech_recognition_tpu_torch.models.postfilter import zelinski_args  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (  # noqa: E402
    analysis_tm_fused,
)
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

FS = 16000.0
KERNEL = "gsc_lms_zelinski.cu"
NSLOT = 6
# (the mark's comment, the stage it closes)
MARKS = (("  // probe: set-up done\n", 5), ("    // probe: frame staged\n", 0),
         ("    // probe: front done\n", 1), ("    // probe: sums done\n", 2),
         ("    // probe: update done\n", 3), ("    // probe: stored\n", 4))
STAGES = ("frame wait", "front", "cross-lane sums + gain", "update", "store", "set-up")
# thread 0 adds the cycles since the last mark to the stage's slot; both
# live in shared memory, not in registers
MARK_DEF = (
    "__shared__ long long dsr_probe_ph[%d];\n"
    "__shared__ long long dsr_probe_last;\n"
    "__device__ unsigned long long dsr_probe_acc[%d];\n"
    "#define DSR_PROBE_MARK(slot) do { if (threadIdx.x == 0) { const long long now_ = clock64(); "
    "dsr_probe_ph[slot] += now_ - dsr_probe_last; dsr_probe_last = now_; } } while (0)\n"
) % (NSLOT, NSLOT + 1)
INIT = ("  if (threadIdx.x == 0) { for (int i_ = 0; i_ < %d; ++i_) dsr_probe_ph[i_] = 0; "
        "dsr_probe_last = clock64(); }\n") % NSLOT
FLUSH = ("  if (threadIdx.x == 0) { for (int i_ = 0; i_ < %d; ++i_) "
         "atomicAdd(&dsr_probe_acc[i_], (unsigned long long)dsr_probe_ph[i_]); "
         "atomicAdd(&dsr_probe_acc[%d], 1ull); }\n") % (NSLOT, NSLOT)
READ = (f'\nextern "C" int dsr_probe_gsc_lms(unsigned long long* host) {{\n'
        f"  cudaError_t e = cudaMemcpyFromSymbol(host, dsr_probe_acc, sizeof(dsr_probe_acc));\n"
        f"  if (e != cudaSuccess) return (int)e;\n"
        f"  static const unsigned long long zero[{NSLOT + 1}] = {{}};\n"
        f"  return (int)cudaMemcpyToSymbol(dsr_probe_acc, zero, sizeof(zero));\n}}\n")
START, END = "  // probe: kernel start\n", "  // probe: kernel end\n"


def instrument(pkg: Path) -> None:
    """Put the marks into ``pkg``'s copy of the LMS scan."""
    path = pkg / "csrc" / KERNEL
    k = path.read_text()
    for anchor in [a for a, _ in MARKS] + [START, END]:
        if k.count(anchor) != 1:
            raise RuntimeError(f"{KERNEL}: mark {anchor.strip()!r} not found once")
    for anchor, slot in MARKS:
        k = k.replace(anchor, anchor + f"DSR_PROBE_MARK({slot});\n")
    k = k.replace(START, START + INIT).replace(END, END + FLUSH)
    path.write_text(MARK_DEF + k + READ)


def load_copy(root: Path, tag: str, instrumented: bool):
    """Build ``root``'s kernels (the LMS scan instrumented, or as they are)
    under this checkout's (ignored) build dir with ``root``'s own build
    module; return the loaded library."""
    out = _build.BUILD_DIR / f"gsc_lms_phases_{tag}"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(root / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    if instrumented:
        instrument(pkg)
    spec = importlib.util.spec_from_file_location(f"lms_phases_build_{tag}",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library()
    if instrumented:
        lib.dsr_probe_gsc_lms.argtypes = [ctypes.c_void_p]
        lib.dsr_probe_gsc_lms.restype = ctypes.c_int
    return lib


def compiled_report(root: Path) -> None:
    """Registers and spills of each instantiation, and SASS counts of C = 8."""
    nvcc = _build.nvcc_path()
    csrc = root / "distant_speech_recognition_tpu_torch" / "csrc"
    nvdisasm = Path(nvcc).with_name("nvdisasm")
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        cubin = Path(tmp) / "k.cubin"
        flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
        res = subprocess.run([nvcc, *flags, "-I", str(csrc), "-cubin", "-o", str(cubin),
                              str(csrc / KERNEL)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(res.stdout + res.stderr)
        kernel = None
        for line in (res.stdout + res.stderr).splitlines():
            if "Compiling entry" in line:
                m = re.search(r"gsc_lms_zelinski_kernel\w*?ILi(\d+)ELi(\d+)E", line)
                kernel = f"<C={m.group(1)},Z={m.group(2)}>" if m else None
            elif kernel and ("Used" in line or "spill" in line):
                print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")
        sass = subprocess.run([str(nvdisasm), "-c", str(cubin)], capture_output=True,
                              text=True).stdout
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*\.section\s+\.text\.(\S+?),", line)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    for name, lines in funcs.items():
        m = re.search(r"gsc_lms_zelinski_kernel\w*?ILi(\d+)ELi(\d+)E", name)
        if not m or m.group(1) != "8":
            continue
        ins = [ln for ln in lines if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]

        def count(op):
            return sum(1 for ln in ins if re.search(rf"\b{op}\b", ln))

        fp64 = sum(count(op) for op in ("DMUL", "DFMA", "DADD", "F2F.F64.F32", "F2F.F32.F64"))
        print(f"  SASS <C=8,Z={m.group(2)}>: {len(ins)} instructions, BRA {count('BRA')}, "
              f"CALL {count('CALL.REL.NOINC') + count('CALL.ABS.NOINC')}, FCHK {count('FCHK')}, "
              f"MUFU.RCP {count('MUFU.RCP')}, MUFU.RSQ {count('MUFU.RSQ')}, FP64 {fp64}, "
              f"SHFL {count('SHFL.BFLY')}, BAR {count('BAR.SYNC')}, LDGSTS {count('LDGSTS')}, "
              f"LDS {count('LDS')}, FFMA {count('FFMA')}")


def read(lib) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (NSLOT + 1))()
    code = lib.dsr_probe_gsc_lms(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"probe read failed ({code})")
    return np.array(buf, dtype=np.float64)


def lms_call(lib, Yp, w, cfg, pf_type, pf_min):
    """The LMS scan of library ``lib`` on ``Yp [Tf, B, C, M]``, through its C
    entries as this checkout's wrapper calls them: the gate pass, then the
    scan; a library without the gate pass (the one-kernel scan that came
    before it) takes the silence threshold in the scan's own arguments."""
    Tf, B, C, M = Yp.shape
    F = M // 2 + 1
    wq, bm, ta = (complex_view(nm, t, sh) for nm, t, sh in (
        ("wqH", w[0], (F, C)), ("BmH", w[1], (F, C - 1, C)), ("wq_manifold", w[2], (F, C))))
    out = torch.empty((Tf, B, M), dtype=torch.float32, device=Yp.device)
    stream = stream_handle(Yp.device)
    args = _lms_args(cfg)
    if hasattr(lib, "dsr_lms_gates"):
        gates = torch.empty((Tf, B), dtype=torch.float32, device=Yp.device)
        code = lib.dsr_lms_gates(Yp.data_ptr(), gates.data_ptr(), Tf, B, C, M, cfg.beta,
                                 1.0 - cfg.beta, cfg.init_diagonal_load, cfg.sil_thresh, stream)
        if code:
            raise RuntimeError(f"LMS gate pass failed ({code})")
        inputs = [Yp.data_ptr(), gates.data_ptr()]
    else:
        inputs = [Yp.data_ptr()]
        args = args[:5] + (cfg.sil_thresh,) + args[5:]
    code = lib.dsr_gsc_lms_zelinski(*inputs, wq.data_ptr(), bm.data_ptr(), ta.data_ptr(),
                                    out.data_ptr(), Tf, B, C, C - 1, M, *args,
                                    *zelinski_args(C, 0.6, pf_type, pf_min), stream)
    if code:
        raise RuntimeError(f"LMS scan failed ({code})")
    return out


def kernel_ms(fn, reps=3) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches, by torch.profiler
    (the gate pass and the scan)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / reps for e in prof.key_averages()
            if e.device_time_total > 0}


def kernel_name(key: str) -> str:
    """The kernel's name in a profiler key such as ``void (anonymous
    namespace)::gsc_lms_zelinski_kernel<8, 1>(float const*, ...)``."""
    m = re.search(r"(\w+_kernel)\b", key)
    return m.group(1) if m else key


def event_ms(fn, reps=3) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def linear_weights(C: int):
    """The bench array (linear, 50 mm) steered at pi/3: wqH, BmH, manifold."""
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    d = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    wqH, BmH = gsc_weights(256, FS, d, 1)
    return wqH, BmH, array_manifold(256, FS, d)


def hash_noise(shape, seed) -> np.ndarray:
    """`tests/test_torch_kernels.py`'s ``_hash_noise``: the same bits on
    every machine."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


# `test_lms_scan_equals_stored_outputs`' cases: (tag, C, pf_type,
# pf_min_frames, max_wa_l2norm), M = 256, B = 3, Tf = 37
LMS_STORED = (("r", 4, 1, 2, 5e-7), ("a", 8, 2, 0, 100.0), ("n", 8, 1, NO_POSTFILTER, 5e-7))


def stored_input(tag: str, C: int) -> np.ndarray:
    """A stored case's snapshot: hash noise, utterance 1 quiet for frames
    8-11 (the gate closes) and the last utterance's top bins near-silent."""
    Tf, B, M = 37, 3, 256
    Yp = hash_noise((Tf, B, C, M), ord(tag) + 1000)
    Yp[8:12, 1] *= np.float32(1e-6)
    Yp[:, -1, :, 3 * M // 8:M // 2 + 1] *= np.float32(1.8e-8)
    Yp[:, -1, :, 3 * M // 8 + M // 2:] *= np.float32(1.8e-8)
    return Yp


def write_case(path: Path) -> None:
    """Store the LMS cases from the kernels now loaded."""
    dev = torch.device("cuda", 0)
    z = {}
    for tag, C, pf_type, pf_min, cap in LMS_STORED:
        w = linear_weights(C)
        cfg = GSCLMSConfig(max_wa_l2norm=cap, min_frames=4, slowdown_after=9)
        out = gsc_lms_zelinski(torch.from_numpy(stored_input(tag, C)).to(dev),
                               *(t.to(dev) for t in w), cfg, 0.6, pf_type, pf_min)
        for k, t in zip(("wqH", "BmH", "vs"), w):
            z[f"{tag}_{k}"] = t.numpy()
        z[f"{tag}_out"] = out.cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **z)
    print(f"wrote {path} ({path.stat().st_size} bytes): " + ", ".join(sorted(z)))


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=None,
                    help="another checkout whose LMS scan is timed and compared with this one's")
    ap.add_argument("--write-case", type=Path, default=None,
                    help="store the LMS cases of the card tests from this checkout's kernel here")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    own = _build.library()
    compiled_report(REPO)
    marked = load_copy(REPO, "marked", True)
    other = load_copy(args.root.resolve(), "other", False) if args.root else None
    dev = torch.device("cuda", 0)
    if args.write_case is not None:
        write_case(args.write_case)

    C, B = 8, 256
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, _ = load_pair(256, 4, 1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((B, C, 160000), dtype=np.float32) * 1500).to(dev)
    Yp = analysis_tm_fused(x, torch.as_tensor(h).to(dev), fb)
    del x
    Tf = Yp.shape[0]
    w = [t.to(dev) for t in linear_weights(C)]
    cfg = GSCLMSConfig()
    runs = [(f"B={b} real", b, 2, "real") for b in (256, 64, 1)]
    runs.append(("B=256 none", 256, NO_POSTFILTER, "real"))
    for label, b, pf_min, zel in runs:
        Yb = Yp[:, :b].contiguous()
        ms = event_ms(lambda: lms_call(own, Yb, w, cfg, 1, pf_min))
        lms_call(marked, Yb, w, cfg, 1, pf_min)
        torch.cuda.synchronize()
        read(marked)  # drop the warm-up's counts
        marked_ms = event_ms(lambda: lms_call(marked, Yb, w, cfg, 1, pf_min), 1)
        acc = read(marked) / 2  # the warm-up call of event_ms and the timed one
        blocks = int(acc[NSLOT])
        per_frame = acc[:NSLOT] / max(blocks, 1) / Tf
        split = kernel_ms(lambda: lms_call(own, Yb, w, cfg, 1, pf_min))
        print(f"{label}: {ms:.3f} ms ({marked_ms:.3f} ms instrumented), {blocks} blocks, launch "
              f"{lms_launch_shape(b, C, 256, zel)}; cycles per frame: "
              + "  ".join(f"{STAGES[i]} {per_frame[i]:.0f}" for i in range(NSLOT))
              + f"  (sum {per_frame.sum():.0f}); device ms a call: "
              + "  ".join(f"{kernel_name(k)} {v:.3f}" for k, v in split.items()))
        if other is not None:
            outs, times = {}, {"other": [], "this": []}
            for side in ("other", "this", "this", "other"):
                lib = other if side == "other" else own

                def fn():
                    return lms_call(lib, Yb, w, cfg, 1, pf_min)

                times[side].append(event_ms(fn))
                outs[side] = fn()
            ref = outs["other"]
            err = (outs["this"] - ref).abs().max().item() / ref.abs().max().item()
            print(f"  {args.root}: {' '.join(f'{t:.3f}' for t in times['other'])} ms; this "
                  f"checkout {' '.join(f'{t:.3f}' for t in times['this'])} ms; max|this - other| / "
                  f"max|other| = {err:.3g}")


if __name__ == "__main__":
    main()
