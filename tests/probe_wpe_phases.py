"""Where the WPE stats (K10, ``csrc/wpe_stats.cu``) and the WPE residual (K11,
``csrc/wpe_resid.cu``) spend their time, on the card.

The script builds a copy of the kernels in which K10 and K11 read
``clock64()`` at marks placed in their sources (at the block barriers, and
around the stores of K11's frame loop) and one thread per block sums the
cycles between consecutive marks, per stage; the sums of all blocks are added
up in device memory and read back through a C function that the copy gains.
It runs that copy through this checkout's wrappers at the config-4 shape (C = 4,
P = 5, lowerN = 2, M = 256, Tf = 1254, 0.1-scale noise filters) with B = 256
and B = 1, and, for this checkout's kernels, at 8 channels (C*P = 40,
BASELINE config 4's default taps) with B = 256 and 1, K10 with ``has_g``
false and true, and prints each stage's thousands of cycles per block (mean
over blocks) beside the kernel's CUDA-event time and the registers, spills
and shared memory that ptxas reports for the uninstrumented kernel.

The marks are tied to the text of the kernels.  Two designs are known: the
one written first (K10: one block per bin group, each chunk of frames staged,
weighed and accumulated one after the other behind block barriers; K11: one
block per group of 32 bins walking all frames) and the pipelined one (K10: a
ring of chunks filled by ``cp.async`` two chunks ahead, the next chunk
weighed before the current one is accumulated; K11: blocks over frame chunks
that stage whole packed rows D frames ahead).  K11's kernel of C*P > 24
(``wpe_resid_wide_kernel``: blocks over (chunk, group of 32 bins,
utterance), a warp a target, 8 frames a step) has marks of its own and its
own stages, summed per block by thread 1; before it had one, those shapes
ran instantiations of the pipelined kernel, measured with its marks.
``--root DIR`` measures the kernels of another checkout of the repository
(e.g. the parent commit unpacked with ``git archive``) with this checkout's
wrappers; the kernels' C interface is the same.  With ``--root`` it also
holds this checkout's uninstrumented K10 and K11 to that checkout's, bit for
bit, at every shape that checkout takes among `OLD_SHAPES` (C*P <= 24: every
instantiation of K11's narrow kernel, both EM iterations of K10's, deep
delays and two rings) and `WIDE_SHAPES` (C*P > 24: every channel count of
K11's wide kernel, M = 128 and 256, chunks of frames, frame counts within
the lag history and no multiple of a step, B = 1).  ``--write-wide-case
PATH`` stores the K11 cases of
``tests/test_torch_kernels.py::test_wpe_wide_kernels_equal_stored_outputs``
from the measured checkout's kernels (the K12 cases of that file come from
``tests/probe_aec_gj_phases.py --write-wide-case``).

    python3 tests/probe_wpe_phases.py [--root DIR] [--write-wide-case PATH]

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

from distant_speech_recognition_tpu_torch.kernels import _build  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.wpe_kernels import wpe_resid, wpe_stats  # noqa: E402

C, P, LOWER, M, TF = 4, 5, 2, 256, 1254
C8 = 8  # BASELINE config 4 at 8 channels: C*P = 40
# (C, P, lowerN, M, B, Tf) held bit for bit against another checkout
OLD_SHAPES = (
    (4, 5, 2, 256, 16, 1254), (4, 5, 2, 256, 3, 90), (2, 3, 1, 128, 5, 90), (3, 7, 1, 128, 2, 90),
    (3, 8, 2, 256, 2, 90), (8, 3, 2, 128, 2, 90), (8, 3, 32, 256, 2, 100), (8, 1, 32, 256, 2, 100),
    (1, 24, 2, 128, 2, 90), (2, 12, 2, 256, 2, 90), (5, 4, 0, 256, 2, 70), (6, 4, 3, 256, 3, 90),
    (7, 3, 2, 256, 2, 90), (4, 6, 32, 256, 2, 100), (4, 3, 2, 128, 1, 40), (4, 5, 2, 256, 2, 6),
)
# the same past 24 taps a target, where the other checkout takes them
WIDE_SHAPES = (
    (8, 5, 2, 256, 2, 300), (8, 5, 2, 128, 2, 90), (8, 4, 32, 256, 2, 100), (8, 5, 0, 256, 3, 270),
    (8, 5, 2, 256, 1, 7), (7, 5, 2, 256, 2, 90), (6, 6, 3, 256, 2, 90), (5, 8, 2, 256, 2, 90),
    (4, 10, 2, 256, 2, 90), (4, 7, 32, 256, 1, 100), (3, 13, 1, 128, 2, 90), (2, 20, 2, 256, 2, 90),
    (1, 40, 2, 128, 2, 90),
)
# the stored K11 cases: (tag, C, P, lowerN, M, B, Tf, seed) from hash noise
RESID_WIDE_CASES = (("r8x5", 8, 5, 2, 256, 1, 30, 1100), ("r8x4", 8, 4, 32, 256, 1, 30, 1200),
                    ("r1x40", 1, 40, 2, 128, 2, 30, 1300))
NSLOT = 16
ROWS = 2  # counters: the kernel of a design (row 0), K11's wide kernel (row 1)
HEAD = "  extern __shared__ __align__(16) unsigned char smem[];\n"
# the end of the kernel, where the sums are flushed: the first design's
# kernel is the last thing in its namespace
END = "\n}\n\n}  // namespace"

# per kernel design: the stages' names, and the marks as (text the mark
# follows, stage it closes); the clock of thread "tid" (default 0) is summed
DESIGNS = {
    "wpe_stats.cu": {
        "first": dict(
            stages=("stage", "FP64 weights", "accumulate", "write-out", "set-up"),
            marks=(
                ("  const int offy = (S * (C + 1) + c) * FB + f;\n", 4),
                ("    __syncthreads();  // the previous chunk is consumed\n", 2),
                ("      Ys[tt * RS + a * FB + ff] = y;\n    }\n    __syncthreads();\n", 0),
                ("      Ws[tt * CF + cc * FB + ff] = w;\n    }\n    __syncthreads();\n", 1),
                ("  const int fg = f0 + f;\n", 2),
            ),
            end_stage=3,
        ),
        "pipelined": dict(
            stages=("set-up", "stage and weigh chunk 0", "wait for the next chunk's copies",
                    "start copies", "widen the next chunk to FP64", "FP64 weights",
                    "accumulate", "write-out"),
            marks=(
                ("  // probe: set-up done\n", 0),
                ("  // probe: prologue done\n", 1),
                ("  // probe: waited for chunk k + 1\n", 2),
                ("  // probe: fetching chunk k + 2\n", 3),
                ("  // probe: widened chunk k + 1\n", 4),
                ("  // probe: weighed chunk k + 1\n", 5),
                ("  // probe: accumulated chunk k\n", 6),
            ),
            end_stage=7,
            end="  // probe: kernel end\n",
        ),
    },
    "wpe_resid.cu": {
        "first": dict(
            stages=("stage", "predict", "store", "barrier after the chunk"),
            marks=(
                ("    const int nt = min(TC, Tf - t0);\n    __syncthreads();\n", 3),
                ("      Ys[idx] = y;\n    }\n    __syncthreads();\n", 0),
                ("      cf e = Ys[base + offy];\n", 1),
                ("        e.i -= pi;\n      }\n", 1),
                ("      if (has_im) o[F - 1 + fg] = e.i;\n", 2),
            ),
            end_stage=3,
        ),
        "pipelined": dict(
            stages=("wait for a frame", "predict", "store the last step + start copies", "set-up"),
            tid="1",  # a thread of a complex bin (thread 0 idles: bin 0 is real)
            marks=(
                ("  // probe: set-up done\n", 3),
                ("    // probe: frame staged\n", 0),
                ("    // probe: predicted\n", 1),
                ("    // probe: stored\n", 2),
            ),
            end_stage=2,
            end="  // probe: kernel end\n",
        ),
    },
}
# K11's wide kernel, where the source has it: its first line, marks, end and
# stages (counter row 1)
WIDE = dict(
    stages=("wait for a step's frames", "start copies", "predict and store", "Nyquist bin",
            "set-up"),
    head="  extern __shared__ __align__(16) unsigned char smem_w[];\n",
    tid="1",  # lane 1 of warp 0: a complex bin, and one of the Nyquist lanes in group 0
    marks=(
        ("  // probe (wide): set-up done\n", 4),
        ("    // probe (wide): frame staged\n", 0),
        ("    // probe (wide): copies started\n", 1),
        ("    // probe (wide): predicted\n", 2),
        ("    // probe (wide): nyquist\n", 3),
    ),
    end_stage=2,
    end="  // probe (wide): kernel end\n",
)


def mark(slot: int) -> str:
    return ("{ if (probe_row >= 0) { const long long now_ = clock64(); "
            f"probe_ph[probe_row][{slot}] += now_ - probe_last; probe_last = now_; }} }}\n")


def _mark_kernel(src: str, d: dict, head: str, end: str, row: int) -> str:
    """Marks, counters and their flush in one kernel of ``src``."""
    if src.count(head) != 1 or src.count(end) != 1:
        raise RuntimeError("the kernel's first or last line moved")
    for anchor, slot in d["marks"]:
        src = src.replace(anchor, anchor + mark(slot))
    decl = (f"  __shared__ long long probe_ph[{ROWS}][{NSLOT}];\n"
            f"  const int probe_row = (int)threadIdx.x == {d.get('tid', '0')} ? {row} : -1;\n"
            f"  if (probe_row >= 0) for (int i = 0; i < {NSLOT}; ++i) probe_ph[probe_row][i] = 0;\n"
            "  long long probe_last = clock64();\n")
    flush = (mark(d["end_stage"]) + "  if (probe_row >= 0) {\n"
             f"    for (int i = 0; i < {NSLOT}; ++i)\n"
             "      atomicAdd(&probe_acc[probe_row][i], (unsigned long long)probe_ph[probe_row][i]);\n"
             f"    atomicAdd(&probe_acc[probe_row][{NSLOT}], 1ull);\n  }}\n")
    return src.replace(head, head + decl).replace(end, flush + end)


def instrument(src: str, name: str) -> tuple[str, str, dict]:
    """The source with the marks of its design (and of K11's wide kernel,
    where it has one); the design's name and the stages of each counter row.
    The sums live in shared memory, so the marks cost the kernel two
    registers and a few instructions."""
    for design, d in DESIGNS[name].items():
        if all(src.count(anchor) == 1 for anchor, _ in d["marks"]):
            break
    else:
        raise RuntimeError(f"{name}: no known design's marks all match the source")
    src = _mark_kernel(src, d, HEAD, d.get("end", END), 0)
    stages = {0: d["stages"]}
    if name == "wpe_resid.cu" and all(src.count(a) == 1 for a, _ in WIDE["marks"]):
        src = _mark_kernel(src, WIDE, WIDE["head"], WIDE["end"], 1)
        stages[1] = WIDE["stages"]
        design += " + wide kernel"
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                      f"probe_acc[{ROWS}][{NSLOT + 1}];\n", 1)
    tag = name.split(".")[0]
    src += (f'\nextern "C" int dsr_probe_{tag}(unsigned long long* host) {{\n'
            f"  cudaError_t e = cudaMemcpyFromSymbol(host, probe_acc, sizeof(probe_acc));\n"
            f"  if (e != cudaSuccess) return (int)e;\n"
            f"  static const unsigned long long zero[{ROWS}][{NSLOT + 1}] = {{}};\n"
            f"  return (int)cudaMemcpyToSymbol(probe_acc, zero, sizeof(zero));\n}}\n")
    return src, design, stages


def build(root: Path):
    """Build the kernels of ``root``'s csrc with K10 and K11 instrumented;
    return the loaded library and each kernel's (design, stages)."""
    out = _build.BUILD_DIR / "wpe_phases"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    src_pkg = root / "distant_speech_recognition_tpu_torch"
    for sub in ("csrc", "kernels"):  # its own build module, for its own entry points
        shutil.copytree(src_pkg / sub, pkg / sub, ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    designs = {}
    for name in DESIGNS:
        path = pkg / "csrc" / name
        text, design, stages = instrument(path.read_text(), name)
        path.write_text(text)
        designs[name] = (design, stages)
    spec = importlib.util.spec_from_file_location("wpe_phases_build", pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library()
    for name in DESIGNS:
        fn = getattr(lib, f"dsr_probe_{name.split('.')[0]}")
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, designs


def ptxas_report(root: Path) -> None:
    """Registers, spills and shared memory of the uninstrumented K10 / K11."""
    nvcc = _build.nvcc_path()
    csrc = root / "distant_speech_recognition_tpu_torch" / "csrc"
    for name in DESIGNS:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            res = subprocess.run([nvcc, *_build.NVCC_FLAGS, "-I", str(csrc), "-c", "-o",
                                  str(Path(tmp) / "k.o"), str(csrc / name)],
                                 capture_output=True, text=True)
        kernel = name
        for line in (res.stdout + res.stderr).splitlines():
            if "Compiling entry" in line:  # the template arguments of the instantiation
                args = ",".join(re.findall(r"Li(\d+)E", line.split("kernel")[-1]))
                kernel = f"{name}{' wide' if 'wide_kernel' in line else ''}<{args}>"
            elif "Used" in line or "spill" in line:
                print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")


def read(lib, name: str) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (ROWS * (NSLOT + 1)))()
    code = getattr(lib, f"dsr_probe_{name.split('.')[0]}")(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"probe read failed ({code})")
    return np.array(buf, dtype=np.float64).reshape(ROWS, NSLOT + 1)


def report(lib, name: str, stages: dict, label: str, run) -> None:
    """Time ``run`` and print the stages of the counter row its kernel fed."""
    run()
    torch.cuda.synchronize()
    read(lib, name)  # drop the warm-up's counts
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    acc = read(lib, name)
    row = next(r for r in stages if acc[r, NSLOT] > 0)
    kc = acc[row, :NSLOT] / acc[row, NSLOT] / 1e3
    print(f"{label}: {start.elapsed_time(end):.3f} ms, {int(acc[row, NSLOT])} blocks"
          + (" (wide kernel)" if row else "") + "; kcycles per block: "
          + "  ".join(f"{n} {kc[i]:.1f}" for i, n in enumerate(stages[row]))
          + f"  (sum {kc.sum():.1f})")


def load_plain(root: Path):
    """``root``'s kernels as they are, built with its own build module."""
    out = _build.BUILD_DIR / "wpe_phases_plain"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(root / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    spec = importlib.util.spec_from_file_location("wpe_phases_plain_build",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (a signed zero or a NaN payload counts)."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def hash_noise(shape, seed) -> np.ndarray:
    """`tests/test_torch_kernels.py`'s ``_hash_noise``: the same bits on
    every machine."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


def resid_case_input(C: int, P: int, M: int, B: int, Tf: int, seed: int):
    """A stored K11 case's frames and filters: hash noise, G 1e-3 of it."""
    F = M // 2 + 1
    Yp = hash_noise((Tf, B, C, M), seed)
    G = (hash_noise((B, C, F, C * P), seed + 1) * np.float32(1e-3)
         + 1j * (hash_noise((B, C, F, C * P), seed + 2) * np.float32(1e-3)))
    return Yp, G.astype(np.complex64)


def write_wide_case(path: Path) -> None:
    """Store the K11 cases of `RESID_WIDE_CASES` from the kernels now
    loaded into the npz at ``path``, keeping its other entries."""
    z = {}
    for tag, Cs, Ps, low, Ms, Bs, Tfs, seed in RESID_WIDE_CASES:
        Yp, G = resid_case_input(Cs, Ps, Ms, Bs, Tfs, seed)
        z[f"{tag}_out"] = wpe_resid(torch.from_numpy(Yp).cuda(), torch.from_numpy(G).cuda(),
                                    low).cpu().numpy()
    old = dict(np.load(path)) if path.exists() else {}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **(old | z))
    print(f"wrote {path} ({path.stat().st_size} bytes): " + ", ".join(sorted(z)))


def takes_wide() -> bool:
    """Whether the kernels now loaded take C*P = 40 (older checkouts refuse it)."""
    Yp = torch.zeros((1, 1, C8, M), device="cuda")
    G = torch.zeros((1, C8, M // 2 + 1, C8 * P), dtype=torch.complex64, device="cuda")
    try:
        wpe_resid(Yp, G, LOWER)
    except RuntimeError:
        return False
    return True


def same_bits(own, other) -> None:
    """This checkout's K10 and K11 against ``other``'s, at `OLD_SHAPES` and,
    where ``other`` takes them, `WIDE_SHAPES`."""
    same = {}
    _build._lib = other
    wide = takes_wide()
    for Cs, Ps, low, Ms, Bs, Tfs in OLD_SHAPES + (WIDE_SHAPES if wide else ()):
        rng = np.random.default_rng(Cs * 100 + Ps + low)
        Fs = Ms // 2 + 1
        Yp = torch.from_numpy((rng.standard_normal((Tfs, Bs, Cs, Ms)) * 30)
                              .astype(np.float32)).cuda()
        G = torch.from_numpy((0.1 * (rng.standard_normal((Bs, Cs, Fs, Cs * Ps))
                                     + 1j * rng.standard_normal((Bs, Cs, Fs, Cs * Ps))))
                             .astype(np.complex64)).cuda()
        tag = f"C={Cs} P={Ps} lowerN={low} M={Ms} B={Bs} Tf={Tfs}"
        for name, run in [(f"K10 has_g={hg}", lambda hg=hg: wpe_stats(Yp, G, low, Ps, hg))
                          for hg in (False, True)] + [("K11", lambda: wpe_resid(Yp, G, low))]:
            outs = []
            for lib_ in (other, own):
                _build._lib = lib_
                out = run()
                outs.append(out if isinstance(out, tuple) else (out,))
            same[f"{name} {tag}"] = all(bits_equal(a, b) for a, b in zip(*outs))
    _build._lib = own
    differ = [k for k, v in same.items() if not v]
    print(f"this checkout equals the measured one bit for bit in {len(same) - len(differ)} of "
          f"{len(same)} cases; differs in: {', '.join(differ) or 'none'}")


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


def in_turns(own, other) -> None:
    """CUDA-event times of ``other``'s and this checkout's uninstrumented K11
    at the config-4 shape, B = 256, at 4 channels and, where ``other`` takes
    it, at 8 (C*P = 40), in turns: other, this, this, other."""
    rng = np.random.default_rng(3)
    F = M // 2 + 1
    _build._lib = other
    for Cs in (C, C8) if takes_wide() else (C,):
        Yp = torch.from_numpy((rng.standard_normal((TF, 256, Cs, M)) * 30)
                              .astype(np.float32)).cuda()
        G = torch.from_numpy((0.1 * (rng.standard_normal((256, Cs, F, Cs * P))
                                     + 1j * rng.standard_normal((256, Cs, F, Cs * P))))
                             .astype(np.complex64)).cuda()
        ms = []
        for lib_ in (other, own, own, other):
            _build._lib = lib_
            ms.append(event_ms(lambda: wpe_resid(Yp, G, LOWER)))
        print(f"K11 C={Cs} P={P} B=256 (uninstrumented): measured checkout {ms[0]:.3f} / "
              f"{ms[3]:.3f} ms, this checkout {ms[1]:.3f} / {ms[2]:.3f} ms")
        del Yp, G
    _build._lib = own


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose kernels are measured (default: this one)")
    ap.add_argument("--write-wide-case", type=Path, default=None,
                    help="store K11's cases of C*P > 24 from the measured kernels here")
    args = ap.parse_args()
    root = args.root.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"kernels of {root}")
    own = _build.library()
    other = root != REPO
    ptxas_report(root)
    lib, designs = build(root)
    plain = load_plain(root) if other or args.write_wide_case is not None else None
    if args.write_wide_case is not None:
        _build._lib = plain
        write_wide_case(args.write_wide_case)
    _build._lib = lib
    rng = np.random.default_rng(0)
    F = M // 2 + 1
    Yp = torch.from_numpy((rng.standard_normal((TF, 256, C, M)) * 30).astype(np.float32)).cuda()
    G = torch.from_numpy((0.1 * (rng.standard_normal((256, C, F, C * P))
                                 + 1j * rng.standard_normal((256, C, F, C * P))))
                         .astype(np.complex64)).cuda()
    for name, (design, stages) in designs.items():
        print(f"{name}: {design} design")
        for B in (256, 1):
            Yb = Yp[:, :B].contiguous()
            if name == "wpe_stats.cu":
                for has_g in (False, True):
                    report(lib, name, stages, f"  B={B} has_g={has_g}",
                           lambda: wpe_stats(Yb, G[:B], LOWER, P, has_g))
            else:
                report(lib, name, stages, f"  B={B}", lambda: wpe_resid(Yb, G[:B], LOWER))
    if takes_wide():  # the 8-channel shape, which checkouts before it refuse
        Y8 = torch.from_numpy((rng.standard_normal((TF, 256, C8, M)) * 30)
                              .astype(np.float32)).cuda()
        G8 = torch.from_numpy((0.1 * (rng.standard_normal((256, C8, F, C8 * P))
                                      + 1j * rng.standard_normal((256, C8, F, C8 * P))))
                              .astype(np.complex64)).cuda()
        for name, (design, stages) in designs.items():
            print(f"{name} at C = {C8}, C*P = {C8 * P}:")
            for B in (256, 1):
                Yb = Y8[:, :B].contiguous()
                if name == "wpe_stats.cu":
                    for has_g in (False, True):
                        report(lib, name, stages, f"  B={B} has_g={has_g}",
                               lambda: wpe_stats(Yb, G8[:B], LOWER, P, has_g))
                else:
                    report(lib, name, stages, f"  B={B}", lambda: wpe_resid(Yb, G8[:B], LOWER))
        del Y8, G8
    _build._lib = own
    if other:
        same_bits(own, plain)
        in_turns(own, plain)


if __name__ == "__main__":
    main()
