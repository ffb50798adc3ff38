"""K7 (``csrc/zelinski_apply.cu``, both entries) and the LMS scan's gate
pass (``csrc/gsc_lms_zelinski.cu``, ``dsr_lms_gates``) of this checkout,
timed on the card and held bit for bit to another checkout's.

At the path shapes (K1's analysis of int16-scale noise, numpy seed 0, B =
256 x C ch x 10 s, M = 256, Tf = 1254; C = 4 and 8) and at B = 256, 64 and 1
(the first utterances), the script prints K7's launch
(``fixed_weight.zelinski_launch_shape``), the CUDA-event times of K7 with
one set of weights (D&S on the bench's linear array) and with one steering
per utterance (a circular array steered at B azimuths), of the gate pass
and of each of its two launches (torch.profiler), each beside its least
time on the card (bytes at 3.35 TB/s: the input rows once, the output
once), and that the gate pass equals the plain
`adaptive_gsc.lms_silence_gates` flag for flag.  It also prints the
compiler's registers and spills of K7's and the gate pass's kernels, and
runs a copy of K7 in which lane 0 of each block reads ``clock64()`` at the
``// probe:`` marks of its source and sums the cycles of each stage of a
group of frames (the copies of the group a ring ahead, the wait for the
group's own copies, its reads from the ring, its arithmetic, its stores;
and the set-up), printed per frame beside the copy's own time (B = 256, 64
and 1 at C = 4).  ``--sass DIR`` writes the SASS of K7 at C = 4 and 8 (real
mode, 32 slots) and of the gate pass's kernels there, with instruction
counts.  ``--variants`` also builds K7 alone from copies of its source
with one launch constant changed each (`VARIANTS`: frames a group, warps a
block, the deepest ring) and times them in turns beside this checkout's
kernel, with their outputs against it bit for bit.

``--root DIR`` also builds another checkout's kernels (e.g. the parent
commit unpacked with ``git archive``) with that checkout's own build
module, runs its K7 (both entries, the Zelinski gain in its real mode from
frame 3, and in its modulus mode never applied) and its gate pass through
the same C entries on the same inputs, prints whether this checkout's
outputs equal the other's bit for bit, and times both in turns (other,
this, this, other; CUDA events, mean of 5 after a warm-up).
``--write-case PATH`` stores the cases of
``tests/test_torch_kernels.py::test_zelinski_apply_equals_stored_outputs``
from the other checkout's K7 where ``--root`` is given, else from this
one's: both entries, C = 2, 4 and 8, M = 64 and 256, B = 3 (utterance 1
digitally silent), Tf = 37 frames of hash noise, each in the real and the
modulus mode with the gain from frame 1, from frame 3 and never; the SHA-256
of each output's bytes, and the whole outputs at M = 64 in the real mode
from frame 3.

    python3 tests/probe_zelinski_apply_phases.py [--root DIR] [--write-case PATH] [--sass DIR]
        [--variants]

Needs an NVIDIA GPU and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import re
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from distant_speech_recognition_tpu_torch.kernels import _build  # noqa: E402
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (  # noqa: E402
    GSCLMSConfig,
    lms_silence_gates,
)
from distant_speech_recognition_tpu_torch.models.beamforming import (  # noqa: E402
    array_manifold,
    superdirective_weights,
)
from distant_speech_recognition_tpu_torch.models.fixed_weight import (  # noqa: E402
    zelinski_apply,
    zelinski_apply_steered,
    zelinski_launch_shape,
)
from distant_speech_recognition_tpu_torch.models.fused_scan import (  # noqa: E402
    NO_POSTFILTER,
    lms_gates,
)
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (  # noqa: E402
    analysis_tm_fused,
)
from distant_speech_recognition_tpu_torch.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair  # noqa: E402

FS = 16000.0
HBM = 3.35e12  # bytes/s, H100 SXM
# the stored cases: entries, channel counts, sizes, and for each the
# Zelinski settings (pf_type, pf_min_frames); Tf = 37 frames, B = 3
FORMS = ("shared", "steered")
CASE_C = (2, 4, 8)
CASE_M = (64, 256)
CASE_PF = tuple((pf_type, pf_min) for pf_type in (1, 2) for pf_min in (0, 2, NO_POSTFILTER))
CASE_TF, CASE_B = 37, 3
FULL_PF = (1, 2)  # the setting whose whole outputs are stored at M = 64


def hash_noise(shape, seed) -> np.ndarray:
    """`tests/test_torch_kernels.py`'s ``_hash_noise``: the same bits on
    every machine."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


def case_tag(form: str, C: int, M: int) -> str:
    return f"{form}_c{C}_m{M}"


def case_input(form: str, C: int, M: int) -> np.ndarray:
    """A stored case's packed spectrum [Tf, B, C, M]: hash noise, utterance 1
    digitally silent."""
    Yp = hash_noise((CASE_TF, CASE_B, C, M), sum(map(ord, case_tag(form, C, M))))
    Yp[:, 1] = 0.0
    return Yp


def linear_delays(C: int, azimuth: float = np.pi / 3) -> np.ndarray:
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)


def case_weights(form: str, C: int, M: int, B: int = CASE_B):
    """The weights and manifold of a case (CPU complex64): SD-MVDR weights of
    the linear 50 mm array steered at pi/3, or, one per utterance, D&S on a
    circular 100 mm array steered at B azimuths."""
    if form == "shared":
        mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
        d = linear_delays(C)
        return superdirective_weights(mpos, d, M, FS), array_manifold(M, FS, d)
    ang = 2 * np.pi * np.arange(C) / C
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    d = np.stack([geometry.calc_ca_delays(mpos, az, np.pi / 2)
                  for az in np.linspace(0.3, 5.9, B)]).astype(np.float32)
    vs = array_manifold(M, FS, torch.from_numpy(d))
    return torch.conj(vs).resolve_conj(), vs


def run_k7(lib, form: str, Yp, wq, ta, pf_type: int, pf_min: int) -> torch.Tensor:
    """K7 of library ``lib`` through this checkout's wrapper (the C entries
    take the same arguments in both checkouts)."""
    own = _build._lib
    _build._lib = lib
    try:
        fn = zelinski_apply if form == "shared" else zelinski_apply_steered
        return fn(Yp, wq, ta, 0.6, pf_type, pf_min)
    finally:
        _build._lib = own


def run_gates(lib, Yp, cfg) -> torch.Tensor:
    own = _build._lib
    _build._lib = lib
    try:
        return lms_gates(Yp, cfg)
    finally:
        _build._lib = own


def digest(t: torch.Tensor) -> str:
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def write_case(lib, path: Path) -> None:
    """Store the K7 cases from library ``lib``."""
    dev = torch.device("cuda", 0)
    z = {}
    for form in FORMS:
        for C in CASE_C:
            for M in CASE_M:
                tag = case_tag(form, C, M)
                wq, ta = case_weights(form, C, M)
                z[f"{tag}_wq"], z[f"{tag}_ta"] = wq.numpy(), ta.numpy()
                Yp = torch.from_numpy(case_input(form, C, M)).to(dev)
                for pf_type, pf_min in CASE_PF:
                    out = run_k7(lib, form, Yp, wq.to(dev), ta.to(dev), pf_type, pf_min)
                    key = f"{tag}_p{pf_type}_{min(pf_min, CASE_TF)}"
                    z[f"{key}_sha256"] = np.array(digest(out))
                    if M == 64 and (pf_type, pf_min) == FULL_PF:
                        z[f"{key}_out"] = out.cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **z)
    print(f"wrote {path} ({path.stat().st_size} bytes, {len(z)} arrays)")


def load_root(root: Path):
    """Build ``root``'s kernels under this checkout's (ignored) build dir
    with ``root``'s own build module and load them."""
    out = _build.BUILD_DIR / "zelinski_apply_root"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(root / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    spec = importlib.util.spec_from_file_location("zelinski_apply_root_build",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


KERNEL = "zelinski_apply.cu"
NSLOT = 6
# (the mark's comment, the stage it closes)
MARKS = (("  // probe: set-up done\n", 5), ("    // probe: copies issued\n", 0),
         ("    // probe: group in\n", 1), ("    // probe: group read\n", 2),
         ("    // probe: group computed\n", 3), ("    // probe: group stored\n", 4))
STAGES = ("copies", "wait", "ring reads", "arithmetic", "stores", "set-up")
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
READ = (f'\nextern "C" int dsr_probe_zelinski(unsigned long long* host) {{\n'
        f"  cudaError_t e = cudaMemcpyFromSymbol(host, dsr_probe_acc, sizeof(dsr_probe_acc));\n"
        f"  if (e != cudaSuccess) return (int)e;\n"
        f"  static const unsigned long long zero[{NSLOT + 1}] = {{}};\n"
        f"  return (int)cudaMemcpyToSymbol(dsr_probe_acc, zero, sizeof(zero));\n}}\n")
START, END = "  // probe: kernel start\n", "  // probe: kernel end\n"


def load_marked():
    """Build this checkout's kernels with K7's marks in, and load them."""
    import ctypes

    out = _build.BUILD_DIR / "zelinski_apply_marked"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(REPO / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    path = pkg / "csrc" / KERNEL
    k = path.read_text()
    for anchor in [a for a, _ in MARKS] + [START, END]:
        if k.count(anchor) != 1:
            raise RuntimeError(f"{KERNEL}: mark {anchor.strip()!r} not found once")
    for anchor, slot in MARKS:
        k = k.replace(anchor, anchor + f"DSR_PROBE_MARK({slot});\n")
    k = k.replace(START, START + INIT).replace(END, END + FLUSH)
    path.write_text(MARK_DEF + k + READ)
    spec = importlib.util.spec_from_file_location("zelinski_apply_marked_build",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library()
    lib.dsr_probe_zelinski.argtypes = [ctypes.c_void_p]
    lib.dsr_probe_zelinski.restype = ctypes.c_int
    return lib


def read_marks(lib) -> np.ndarray:
    import ctypes

    buf = (ctypes.c_ulonglong * (NSLOT + 1))()
    code = lib.dsr_probe_zelinski(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"probe read failed ({code})")
    return np.array(buf, dtype=np.float64)


def write_sass(out_dir: Path) -> None:
    """The SASS of K7 <C, real, 32 slots> at C = 4 and 8 and of the gate
    pass's kernels at M = 256, each in a file of ``out_dir``, with counts."""
    nvcc = _build.nvcc_path()
    csrc = REPO / "distant_speech_recognition_tpu_torch" / "csrc"
    nvdisasm = Path(nvcc).with_name("nvdisasm")
    out_dir.mkdir(parents=True, exist_ok=True)
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC", "-Xptxas=-v")]
    for src, pat in (("zelinski_apply.cu", r"(zelinski_apply_kernel)ILi([48])ELi1ELi32E"),
                     ("gsc_lms_zelinski.cu",
                      r"(lms_energy_kernel)ILi(5)E|(lms_gate_recursion_kernel)")):
        cubin = out_dir / (src + ".cubin")
        res = subprocess.run([nvcc, *flags, "-I", str(csrc), "-cubin", "-o", str(cubin),
                              str(csrc / src)], capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(res.stdout + res.stderr)
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
            m = re.search(pat, name)
            if not m:
                continue
            label = "_".join(v for v in m.groups() if v)
            ins = [ln for ln in lines if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
            (out_dir / f"{label}.sass").write_text("\n".join(lines))

            def count(op):
                return sum(1 for ln in ins if re.search(rf"\b{op}\b", ln))

            print(f"  SASS {label}: {len(ins)} instructions, BRA {count('BRA')}, "
                  f"CALL {count('CALL.REL.NOINC') + count('CALL.ABS.NOINC')}, FCHK "
                  f"{count('FCHK')}, MUFU {count('MUFU')}, LDGSTS {count('LDGSTS')}, "
                  f"LDS {count('LDS')}, LDG {count('LDG')}, STG {count('STG')}, "
                  f"FFMA {count('FFMA')}, FMUL {count('FMUL')}, FADD {count('FADD')}, "
                  f"DEPBAR {count('DEPBAR')}")


# K7 with one launch constant of its source changed: (name, [(text, new text)])
VARIANTS = (
    ("two frames a group", [("K7_GROUP = 4;", "K7_GROUP = 2;")]),
    ("two warps a block", [("K7_WARPS = 1;", "K7_WARPS = 2;")]),
    ("rings of 16 frames at most", [("K7_MAX_SLOTS = 32;", "K7_MAX_SLOTS = 16;")]),
)


def build_variants() -> dict:
    """K7 alone (``zelinski_apply.cu``) from each of `VARIANTS`' sources, one
    nvcc each, all started together; the loaded libraries by name."""
    import ctypes

    nvcc = _build.nvcc_path()
    csrc = REPO / "distant_speech_recognition_tpu_torch" / "csrc"
    out = _build.BUILD_DIR / "zelinski_apply_variants"
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    text = (csrc / KERNEL).read_text()
    procs = {}
    for k, (name, subs) in enumerate(VARIANTS):
        v = text
        for old, new in subs:
            if v.count(old) != 1:
                raise RuntimeError(f"{KERNEL}: {old!r} not found once")
            v = v.replace(old, new)
        src = out / f"v{k}.cu"
        src.write_text(v)
        procs[name] = (out / f"v{k}.so", subprocess.Popen(
            [nvcc, *[f for f in _build.NVCC_FLAGS if f != "-Xptxas=-v"], "-I", str(csrc),
             "-shared", "-o", str(out / f"v{k}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        lib = ctypes.CDLL(str(so))
        for entry in ("dsr_zelinski_apply", "dsr_zelinski_apply_steered"):
            fn = getattr(lib, entry)
            fn.argtypes = _build._SIGNATURES[entry]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


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


def kernel_ms(fn, reps=5) -> dict[str, float]:
    """Device time per call of each kernel ``fn`` launches (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_time_total > 0:
            m = re.search(r"(\w+_kernel)\b", e.key)
            out[m.group(1) if m else e.key] = e.device_time_total / 1e3 / reps
    return out


def compiled_report() -> None:
    """Registers and spills of K7's and the gate pass's kernels, from the
    build's ``-Xptxas=-v`` report (present when this process built them)."""
    kernel = None
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line:
            m = re.search(r"(zelinski_apply_kernel|lms_energy_kernel|lms_gate_recursion_kernel)"
                          r"(I(?:Li\d+E)+E)?", line)
            kernel = None
            if m:
                args = re.findall(r"Li(\d+)E", m.group(2) or "")
                kernel = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif kernel and ("Used" in line or "spill" in line):
            print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")


def steered_weights(C: int, B: int, dev):
    wq, ta = case_weights("steered", C, 256, B)
    return wq.to(dev), ta.to(dev)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=None,
                    help="another checkout whose K7 and gate pass are timed and compared")
    ap.add_argument("--write-case", type=Path, default=None,
                    help="store the K7 cases of the card tests here (from --root's kernel, if "
                         "given)")
    ap.add_argument("--sass", type=Path, default=None,
                    help="write the SASS of K7 and of the gate pass's kernels into this directory")
    ap.add_argument("--variants", action="store_true",
                    help="time K7 with each of VARIANTS' launch constants beside this one")
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    other = load_root(args.root.resolve()) if args.root else None
    if args.write_case is not None:
        write_case(other if other is not None else _build.library(), args.write_case)
    own = _build.library()
    compiled_report()
    if args.sass is not None:
        write_sass(args.sass)
    marked = load_marked()
    variants = build_variants() if args.variants else {}
    dev = torch.device("cuda", 0)
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h = torch.as_tensor(load_pair(256, 4, 1)[0], dtype=torch.float32).to(dev)
    rng = np.random.default_rng(0)
    cfg = GSCLMSConfig()
    same_all = []
    for C in (4, 8):
        x = torch.from_numpy(rng.standard_normal((256, C, 160000), dtype=np.float32)
                             * np.float32(1500.0)).to(dev)
        Yp = analysis_tm_fused(x, h, fb)
        del x
        Tf, _, _, M = Yp.shape
        F = M // 2 + 1
        vs = array_manifold(M, FS, linear_delays(C)).to(dev)
        shared = (torch.conj(vs).resolve_conj(), vs)
        for B in (256, 64, 1):
            Yb = Yp[:, :B].contiguous()
            weights = {"shared": shared, "steered": steered_weights(C, B, dev)}
            sh = zelinski_launch_shape(B, C, M)
            for form, (wq, ta) in weights.items():
                w_bytes = 16 * F * C * (B if form == "steered" else 1)
                bound = (4 * (Tf * B * C * M + Tf * B * M) + w_bytes) / HBM * 1e3
                line = f"K7 {form} B={B} C={C}: bound {bound:.4f} ms (bytes)"
                if other is not None:
                    for pf in ((1, 2), (2, NO_POSTFILTER)):
                        same = torch.equal(run_k7(other, form, Yb, wq, ta, *pf),
                                           run_k7(own, form, Yb, wq, ta, *pf))
                        same_all.append(same)
                        line += f"; pf {pf[0]}/{min(pf[1], Tf)} equal to the other: {same}"
                    t = [event_ms(lambda: run_k7(lib, form, Yb, wq, ta, 1, 2))
                         for lib in (other, own, own, other)]
                    line += "; ms in turns (other, this, this, other): " + ", ".join(
                        f"{v:.4f}" for v in t)
                else:
                    line += f"; {event_ms(lambda: run_k7(own, form, Yb, wq, ta, 1, 2)):.4f} ms"
                print(line)
            print(f"  K7 launch B={B} C={C}: {sh}")
            if variants and B in (256, 64):
                wq, ta = shared
                ref = run_k7(own, "shared", Yb, wq, ta, 1, 2)
                libs = [("this", own)] + list(variants.items())
                t = {name: [] for name, _ in libs}
                for order in (libs, libs[::-1]):
                    for name, lib in order:
                        t[name].append(event_ms(lambda: run_k7(lib, "shared", Yb, wq, ta, 1, 2)))
                for name, lib in libs:
                    same = torch.equal(run_k7(lib, "shared", Yb, wq, ta, 1, 2), ref)
                    print(f"  K7 shared B={B} C={C} variant {name}: ms "
                          + ", ".join(f"{v:.4f}" for v in t[name])
                          + f"; equal to this checkout's: {same}")
            if C == 4:
                wq, ta = shared
                run_k7(marked, "shared", Yb, wq, ta, 1, 2)
                torch.cuda.synchronize()
                read_marks(marked)  # drop the warm-up's counts
                marked_ms = event_ms(lambda: run_k7(marked, "shared", Yb, wq, ta, 1, 2), 1)
                acc = read_marks(marked) / 2  # the warm-up call of event_ms and the timed one
                blocks = int(acc[NSLOT])
                per_frame = acc[:NSLOT] / max(blocks, 1) / Tf
                print(f"  K7 shared B={B} C={C} marked copy: {marked_ms:.4f} ms, {blocks} blocks; "
                      "cycles per frame (lane 0 of a block): "
                      + "  ".join(f"{STAGES[i]} {per_frame[i]:.0f}" for i in range(NSLOT))
                      + f"  (sum {per_frame.sum():.0f})")
            bound = 4 * (Tf * B * M + Tf * B) / HBM * 1e3
            g_own = run_gates(own, Yb, cfg)
            plain = torch.equal(g_own, lms_silence_gates(Yb, cfg))
            line = (f"gate pass B={B} C={C}: bound {bound:.4f} ms (bytes); equal to the plain "
                    f"gates flag for flag: {plain} ({int(g_own.sum().item())} of "
                    f"{g_own.numel()} open)")
            same_all.append(plain)
            if other is not None:
                same = torch.equal(run_gates(other, Yb, cfg), g_own)
                same_all.append(same)
                t = [event_ms(lambda: run_gates(lib, Yb, cfg)) for lib in (other, own, own, other)]
                line += f"; equal to the other: {same}; ms in turns (other, this, this, other): "
                line += ", ".join(f"{v:.4f}" for v in t)
            else:
                line += f"; {event_ms(lambda: run_gates(own, Yb, cfg)):.4f} ms"
            split = kernel_ms(lambda: run_gates(own, Yb, cfg))
            line += "; device ms a call: " + "  ".join(f"{k} {v:.4f}" for k, v in split.items())
            print(line)
            del Yb
        del Yp
    print(f"{sum(same_all)} of {len(same_all)} checks equal bit for bit")


if __name__ == "__main__":
    main()
