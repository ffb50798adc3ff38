"""Where the GSC-RLS + Zelinski scan (K2 and its steered form K6,
``csrc/gsc_rls_zelinski.cu``) spends its time, on the card.

The script builds a copy of the kernels in which the scan reads
``clock64()`` at marks placed in its source and thread 0 of each block sums
the cycles between consecutive marks, per stage; the sums of all blocks are
added up in device memory and read back through a C function that the copy
gains.  The stages: the wait for the frame's snapshot (with the start of
the next copies), the frame energy of the silence gate with its barrier, the
state-free front (the blocking and quiescent outputs Z and Yc, the gate, the
Zelinski gain), the state chain (RLS gain, precision and weight update,
constraint, gated commit, the output), the output store and the set-up.  It
runs that copy through this checkout's wrappers at the config-4 shape (K2,
the flagship's linear array, C = 4, M = 256, Tf = 1254 frames of K1's
analysis of int16-scale noise) with B = 256, 132, 64 and 1 and at the
config-5 shape (K6, one steering per utterance of a circular array) with
B = 64, 256 and 1, and prints each stage's cycles per frame (thread 0's clock,
mean over blocks) beside the CUDA-event times of the instrumented and of the
uninstrumented kernel, the kernel's launch shape and its registers, spills
and the IEEE divisions' checks and branches in its SASS (``-Xptxas=-v``,
``nvdisasm``).  B = 1 gives the latency of one frame's chain.

The marks are tied to the text of the kernels.  Two designs are known: the
one written first (one block per utterance, one frame per block barrier)
and the chunked one (blocks over bin ranges of the flattened (utterance,
bin) index, the frame energies and snapshots of a chunk of frames staged
ahead, the state-free front of frame t + 1 computed beside frame t's state
chain), the latter with its staging and frame energies in the kernel's file
or in ``csrc/gsc_scan.h``, which it shares with the GSC-LMS scan.  ``--root DIR`` measures the kernels of another checkout of the
repository (e.g. the parent commit unpacked with ``git archive``) with this
checkout's wrappers (the C interface is the same), and then also holds this
checkout's uninstrumented kernels to that checkout's, bit for bit, at C = 2..8
and at both shapes.  ``--write-case PATH`` stores the scan cases of
``tests/test_torch_kernels.py::test_scan_kernels_equal_stored_outputs`` at
M = 256 from the measured checkout's kernels.

    python3 tests/probe_gsc_scan_phases.py [--root DIR] [--write-case PATH]

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
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

from distant_speech_recognition_tpu_torch.kernels import _build  # noqa: E402
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (  # noqa: E402
    GSCRLSConfig,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold  # noqa: E402
from distant_speech_recognition_tpu_torch.models.fused_scan import (  # noqa: E402
    gsc_rls_zelinski,
    gsc_rls_zelinski_steered,
    scan_launch_shape,
)
from distant_speech_recognition_tpu_torch.models.steered import steering_weights  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (  # noqa: E402
    analysis_tm_fused,
)
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

FS = 16000.0
KERNEL = "gsc_rls_zelinski.cu"
SCAN_H = "gsc_scan.h"
NSLOT = 16
STAGES = ("wait for the snapshot", "frame energy + barrier", "state-free front", "state chain",
          "output store", "start copies", "set-up")
# the text every mark expands to: thread 0 adds the cycles since the last
# mark to the stage's slot (both live in shared memory, so that the marks
# inside the step header, a separate function, reach them)
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
READ = (f'\nextern "C" int dsr_probe_gsc_scan(unsigned long long* host) {{\n'
        f"  cudaError_t e = cudaMemcpyFromSymbol(host, dsr_probe_acc, sizeof(dsr_probe_acc));\n"
        f"  if (e != cudaSuccess) return (int)e;\n"
        f"  static const unsigned long long zero[{NSLOT + 1}] = {{}};\n"
        f"  return (int)cudaMemcpyToSymbol(dsr_probe_acc, zero, sizeof(zero));\n}}\n")
# forces the snapshot's registers to be ready: the wait for its loads
WAIT_X = "#pragma unroll\n    for (int c_ = 0; c_ < C; ++c_) asm volatile(\"\" :: \"f\"(X[c_].r), \"f\"(X[c_].i));\n"

# per design: marks as (file, text the mark follows, stage it closes, extra
# code put before the mark), the text after which the counters start and the
# text before which they are flushed (both in the kernel's file)
DESIGNS = {
    "per-frame barrier": dict(
        marks=(
            (KERNEL, "for (int c = 0; c < C; ++c) X[c] = packed_bin(src + c * M, F, fc);\n", 6, ""),
            (KERNEL, "      for (int c = 0; c < C; ++c) Xn[c] = packed_bin(nx + c * M, F, fc);\n"
                     "    }\n", 0, WAIT_X),
            (KERNEL, "block_sum(e, red[t & 1], lane, warp, nwarps) / (float)M;\n", 1, ""),
            ("gsc_step.h", "  for (int c = 0; c < C; ++c) Yc = cadd(Yc, cmul(wqc[c], X[c]));\n", 2, ""),
            ("gsc_step.h", "    for (int i = 0; i < BC; ++i) Y = csub(Y, cmul(waH[i], Z[i]));\n  }\n",
             3, ""),
            ("gsc_step.h", "  if (t > p.pf.min_frames) Y = cscale(Y, W);\n", 2, ""),
            (KERNEL, "      if (has_im) o[F + f - 1] = Y.i;\n    }\n", 4, ""),
        ),
        start="  __shared__ float red[2][32];\n",
        end="    for (int c = 0; c < C; ++c) X[c] = Xn[c];\n  }\n",
    ),
    "chunked": dict(
        marks=(
            (KERNEL, "  // probe: set-up done\n", 6, ""),
            (KERNEL, "      // probe: chunk staged\n", 0, ""),
            (KERNEL, "  // probe: copies started\n", 5, ""),
            (KERNEL, "  // probe: energies done\n", 1, ""),
            (KERNEL, "    // probe: front done\n", 2, ""),
            (KERNEL, "    // probe: chain done\n", 3, ""),
            (KERNEL, "    // probe: stored\n", 4, ""),
        ),
        start="  // probe: kernel start\n",
        end="  // probe: kernel end\n",
    ),
    "chunked, staging in gsc_scan.h": dict(
        marks=(
            (KERNEL, "  // probe: set-up done\n", 6, ""),
            (KERNEL, "      // probe: chunk staged\n", 0, ""),
            (SCAN_H, "  // probe: copies started\n", 5, ""),
            (SCAN_H, "  // probe: energies done\n", 1, ""),
            (KERNEL, "    // probe: front done\n", 2, ""),
            (KERNEL, "    // probe: chain done\n", 3, ""),
            (KERNEL, "    // probe: stored\n", 4, ""),
        ),
        start="  // probe: kernel start\n",
        end="  // probe: kernel end\n",
    ),
}


def instrument(pkg: Path) -> str:
    """Put the marks of the matching design into ``pkg``'s csrc; return the
    design's name."""
    csrc = pkg / "csrc"
    texts = {name: (csrc / name).read_text() for name in (KERNEL, "gsc_step.h", SCAN_H)
             if (csrc / name).exists()}
    for design, d in DESIGNS.items():
        if all(texts.get(f, "").count(a) == 1 for f, a, _, _ in d["marks"]) and \
                texts[KERNEL].count(d["start"]) == 1 and texts[KERNEL].count(d["end"]) == 1:
            break
    else:
        raise RuntimeError(f"{KERNEL}: no known design's marks all match the source")
    for f, anchor, slot, extra in d["marks"]:
        texts[f] = texts[f].replace(anchor, anchor + extra + f"DSR_PROBE_MARK({slot});\n")
    k = texts[KERNEL]
    k = k.replace(d["start"], d["start"] + INIT)
    k = k.replace(d["end"], d["end"] + FLUSH)
    texts[KERNEL] = MARK_DEF + k + READ
    # the other kernels that include the step and scan headers see no marks
    for name in texts:
        if name != KERNEL:
            texts[name] = "#ifndef DSR_PROBE_MARK\n#define DSR_PROBE_MARK(slot)\n#endif\n" + texts[name]
    for name, text in texts.items():
        (csrc / name).write_text(text)
    return design


def load_copy(root: Path, tag: str, instrumented: bool):
    """Build ``root``'s kernels (with the scan instrumented, or as they are)
    under this checkout's (ignored) build dir with ``root``'s own build
    module; return the loaded library and the design's name."""
    out = _build.BUILD_DIR / f"gsc_scan_phases_{tag}"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(root / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    design = instrument(pkg) if instrumented else None
    spec = importlib.util.spec_from_file_location(f"scan_phases_build_{tag}",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library()
    if instrumented:
        lib.dsr_probe_gsc_scan.argtypes = [ctypes.c_void_p]
        lib.dsr_probe_gsc_scan.restype = ctypes.c_int
    return lib, design


def compiled_report(root: Path) -> None:
    """Registers and spills (``-Xptxas=-v``) and, from the SASS, the
    instructions, basic blocks (branch-target labels), branches, calls,
    FCHK (an IEEE division's range check) and MUFU instructions of each
    instantiation of the scan kernel in ``root``."""
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
        kernel = "?"
        for line in (res.stdout + res.stderr).splitlines():
            if "Compiling entry" in line:
                kernel = "<" + ",".join(re.findall(r"Li(\d+)E", line.split("kernel")[-1])[:2]) + ">"
            elif ("Used" in line or "spill" in line) and kernel in ("<4,3>", "<8,7>"):
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
        targs = re.findall(r"Li(\d+)E", name)
        if "gsc_rls_zelinski" not in name or targs[:2] not in (["4", "3"], ["8", "7"]):
            continue
        ins = [ln for ln in lines if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]

        def count(op):
            return sum(1 for ln in ins if re.search(rf"\b{op}\b", ln))

        labels = sum(1 for ln in lines if re.match(r"\.L_x_\d+:", ln.strip()))
        print(f"  SASS <{','.join(targs[:2])}>: {len(ins)} instructions, {labels} branch-target "
              f"labels, BRA {count('BRA')}, CALL {count('CALL.REL.NOINC') + count('CALL.ABS.NOINC')}"
              f", FCHK {count('FCHK')}, MUFU.RCP {count('MUFU.RCP')}, MUFU.RSQ "
              f"{count('MUFU.RSQ')}, BAR {count('BAR')}"
              f", LDGSTS {count('LDGSTS')}, FFMA {count('FFMA')}")


def read(lib) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (NSLOT + 1))()
    code = lib.dsr_probe_gsc_scan(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"probe read failed ({code})")
    return np.array(buf, dtype=np.float64)


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
    """The flagship's linear 50 mm array steered at pi/3: wqH, BmH, manifold."""
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    d = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    wqH, BmH = gsc_weights(256, FS, d, 1)
    return wqH, BmH, array_manifold(256, FS, d)


def circular_steerings(C: int, B: int):
    """Per-utterance weights of a circular 100 mm array steered at B azimuths."""
    ang = 2 * np.pi * np.arange(C) / C
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    d = np.stack([geometry.calc_ca_delays(mpos, az, np.pi / 2)
                  for az in np.linspace(0.3, 5.9, B)]).astype(np.float32)
    return steering_weights(array_manifold(256, FS, torch.from_numpy(d)))


def hash_noise(shape, seed) -> np.ndarray:
    """`tests/test_torch_kernels.py`'s ``_hash_noise``: the same bits on
    every machine."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


# the M = 256 stored cases: (tag, Tf, B, C, pf_type, pf_min_frames); "s" is K6
M256_CASES = (("a", 37, 2, 4, 1, 2), ("b", 37, 2, 8, 2, 0), ("s", 37, 3, 4, 1, 2))


def m256_input(tag: str, Tf: int, B: int, C: int) -> np.ndarray:
    """A stored case's snapshot: hash noise, utterance 1 quiet for frames
    8-11 (the gate closes) and the last utterance's top bins near-silent
    (the norm cap's max/||wa||^2 overflows to inf there)."""
    M = 256
    Yp = hash_noise((Tf, B, C, M), ord(tag) + 256)
    Yp[8:12, 1] *= np.float32(1e-6)
    lo, hi = 3 * M // 8, M // 2
    Yp[:, -1, :, lo:hi + 1] *= np.float32(1.8e-8)
    Yp[:, -1, :, lo + M // 2:] *= np.float32(1.8e-8)
    return Yp


def write_case(path: Path) -> None:
    """Store the M = 256 scan cases from the kernels now loaded."""
    dev = torch.device("cuda", 0)
    z = {}
    for tag, Tf, B, C, pf_type, pf_min in M256_CASES:
        w = circular_steerings(C, B) if tag == "s" else linear_weights(C)
        fn = gsc_rls_zelinski_steered if tag == "s" else gsc_rls_zelinski
        out = fn(torch.from_numpy(m256_input(tag, Tf, B, C)).to(dev), *(t.to(dev) for t in w),
                 GSCRLSConfig(min_frames=4), 0.6, pf_type, pf_min)
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
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose kernels are measured (default: this one)")
    ap.add_argument("--write-case", type=Path, default=None,
                    help="store the M = 256 scan cases from the measured kernels here")
    args = ap.parse_args()
    root = args.root.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"kernels of {root}")
    own = _build.library()
    compiled_report(root)
    plain_lib, _ = load_copy(root, "plain", False)
    lib, design = load_copy(root, "marked", True)
    print(f"design: {design}")
    dev = torch.device("cuda", 0)
    cfg = GSCRLSConfig()
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, _ = load_pair(256, 4, 1)
    hd = torch.as_tensor(h).to(dev)

    def spectrum(B, C, seed):
        rng = np.random.default_rng(seed)
        x = torch.from_numpy(rng.standard_normal((B, C, 160000), dtype=np.float32) * 1500)
        _build._lib = own
        return analysis_tm_fused(x.to(dev), hd, fb)

    def k2(Yp, w, pf=(1, 2), c=cfg):
        return gsc_rls_zelinski(Yp, *w, c, 0.6, *pf)

    def k6(Yp, w, pf=(1, 2), c=cfg):
        return gsc_rls_zelinski_steered(Yp, *w, c, 0.6, *pf)

    if args.write_case is not None:
        _build._lib = plain_lib
        write_case(args.write_case)

    Yp = spectrum(256, 4, 0)
    Tf = Yp.shape[0]
    w4 = [t.to(dev) for t in linear_weights(4)]
    w5 = [t.to(dev) for t in circular_steerings(4, 256)]
    runs = [(f"K2 config-4 shape B={B}", k2, B, w4) for B in (256, 132, 64, 1)]
    runs += [(f"K6 config-5 shape B={B}", k6, B, [t[:B] for t in w5]) for B in (64, 256, 1)]
    for label, fn, B, w in runs:
        Yb = Yp[:, :B].contiguous()
        _build._lib = plain_lib
        ms = event_ms(lambda: fn(Yb, w))
        _build._lib = lib
        fn(Yb, w)
        torch.cuda.synchronize()
        read(lib)  # drop the warm-up's counts
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn(Yb, w)
        end.record()
        torch.cuda.synchronize()
        marked_ms = start.elapsed_time(end)
        acc = read(lib)
        blocks = int(acc[NSLOT])
        per_frame = acc[:NSLOT] / max(blocks, 1) / Tf
        used = [i for i in range(len(STAGES)) if acc[i] > 0]
        print(f"{label}: {ms:.3f} ms ({marked_ms:.3f} ms instrumented), {blocks} blocks; "
              "cycles per frame: " + "  ".join(f"{STAGES[i]} {per_frame[i]:.0f}" for i in used)
              + f"  (sum {per_frame.sum():.0f})")

    if root == REPO:
        _build._lib = own
        for B in (256, 132, 64, 1):
            print(f"launch at B={B}, C=4: {scan_launch_shape(B, 4, 256)}")

    # K2 at the other channel counts (times only) and, for another checkout,
    # this checkout's kernels against it to the bit: both Zelinski modes, and
    # at C = 4 every constraint option, no regularisation and an early,
    # tight norm cap
    other = root != REPO
    variants = [(cfg, (1, 2)), (cfg, (2, 0))]
    for C in (2, 3, 4, 5, 6, 7, 8):
        YpC = Yp[:, :64].contiguous() if C == 4 else spectrum(64, C, C)
        wC = [t.to(dev) for t in linear_weights(C)]
        wS = [t.to(dev) for t in circular_steerings(C, 64)]
        _build._lib = plain_lib
        line = f"K2 C={C} B=64: {event_ms(lambda: k2(YpC, wC)):.3f} ms"
        if other:
            cases = [(k2, wC, c, pf) for c, pf in variants] + [(k6, wS, cfg, (1, 2))]
            if C == 4:
                cases += [(k2, wC, dataclasses.replace(cfg, **kw), pf) for kw, pf in (
                    (dict(constraint_option=0), (1, 2)), (dict(constraint_option=1), (2, 2)),
                    (dict(constraint_option=2), (1, 0)), (dict(regularization_param=0.0), (2, 2)),
                    (dict(min_frames=0, alpha2=0.5, max_wa_l2norm=1.0), (2, 5)))]
            outs = []
            for lib_ in (plain_lib, own):
                _build._lib = lib_
                outs.append([fn(YpC, w, pf, c) for fn, w, c, pf in cases])
            same = [torch.equal(a, b) for a, b in zip(*outs)]
            _build._lib = own
            line += (f" (this checkout {event_ms(lambda: k2(YpC, wC)):.3f} ms); this checkout "
                     f"equals it bit for bit in {sum(same)} of {len(same)} cases: {same}")
        print(line)
    if other:
        outs = []
        for lib_ in (plain_lib, own):
            _build._lib = lib_
            outs.append((k2(Yp, w4), k6(Yp[:, :64].contiguous(), [t[:64] for t in w5])))
        print("config-4 shape (K2, B=256) and config-5 shape (K6, B=64): this checkout equals "
              f"it bit for bit: {[torch.equal(a, b) for a, b in zip(*outs)]}")
    _build._lib = own


if __name__ == "__main__":
    main()
