"""Where the echo-canceller scan (K9, ``csrc/aec_scan.cu``) and the batched
Gauss-Jordan solve (K12, ``csrc/gj_solve.cu``) spend their time, on the card.

The script builds a copy of the kernels in which K9 and K12 read
``clock64()`` at marks placed in their sources; one thread per block sums
the cycles between consecutive marks, per stage, and the sums of all blocks
are added up in device memory and read back through a C function that the
copy gains.  K9's stages: set-up, the wait for a frame's loads, the issue
of loads (or of the ring's copies and the bulk stores), the error and
|V|^2, the state-free front (gate and quotients), the update of the state,
and the store.  K12's: set-up, loading or staging the system, the pivot row
and its quotients, the update of the other rows, and the store.  It runs
that copy through this checkout's wrappers at the config-4 shape (K9: NLMS
and Kalman, Tf = 1254, C = 4, M = 256, B = 256, 8 and 1; K12: B·C·F =
132,096 systems of n = C·P = 20, and of n = 24; for this checkout's
kernels also the block Kalman kind at B = 256 and C = 4 and 8, and K12's
264,192 systems of n = 40, config 4 at 8 channels) and prints each stage's
cycles (K9: per frame of thread 1, a complex bin; K12: per system of warp
0's lane 0, mean over what it solved) beside the CUDA-event times of the
instrumented and of the uninstrumented kernels, and, per kernel, the
registers and spills that ptxas reports and the SASS counts of SHFL, FCHK
(an IEEE division's range check), BRA, CALL and the arithmetic.

The marks are tied to the text of the kernels.  Two designs of each are
known: the one written first (K9: one thread per (utterance, channel, bin)
loading groups of 4 frames from device memory; K12: one warp per system,
lane j holding column j, factors by shuffle) and the staged one (K9: blocks
over (utterance, channel group), frames staged into a shared-memory ring by
``cp.async`` ahead of the recursion, the state-free front of a step's
frames computed before its recursion, E written by bulk copies from a
store warp; K12: a lane per row, each warp staging its next system into
shared memory by ``cp.async`` while it solves the current one, the pivot
row and its quotients broadcast through shared memory).  K12's kernel of
n = 32 .. 40 (rows 32 .. 39 split across four lanes) carries marks of the
same names.
``--root DIR`` measures the kernels of another checkout of the repository
(e.g. the parent commit unpacked with ``git archive``) with this checkout's
wrappers (the C interface is the same), times both in the same call
(other, this, this, other; K12 at n = 40 and K9's block Kalman where that
checkout takes them), and holds this checkout's uninstrumented kernels to
that checkout's, bit for bit (K12 also at n = 32 .. 40 where it takes
them).  ``--write-case PATH`` stores the cases of
``tests/test_torch_kernels.py::test_aec_gj_kernels_equal_stored_outputs``
from the measured checkout's kernels, ``--write-wide-case PATH`` the K12
cases of ``test_wpe_wide_kernels_equal_stored_outputs`` (n = 33 with a zero
first pivot, and 40; the K11 cases of that file come from
``tests/probe_wpe_phases.py --write-wide-case``).

    python3 tests/probe_aec_gj_phases.py [--root DIR] [--write-case PATH]
        [--write-wide-case PATH]

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
from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_scan  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.wpe_kernels import gj_solve  # noqa: E402

NSLOT = 8
KINDS = {"nlms": (100.0, 1e-4), "kalman": (0.95, 1e-3)}  # p1, p2
THR = 100.0
TF, C4, M4 = 1254, 4, 256
STAGES = {
    "aec_scan.cu": ("set-up", "wait for the frame's loads", "issue loads / copies and stores",
                    "error and |V|^2", "state-free front", "update of the state", "store"),
    "gj_solve.cu": ("set-up", "load / stage the system", "pivot row and quotients",
                    "update of the other rows", "store"),
}
# forces a value's registers to be ready: the wait for its loads
_WAIT_FRAMES = ("#pragma unroll\n    for (int k_ = 0; k_ < K; ++k_) asm volatile(\"\" :: "
                "\"f\"(cur[k_].ar), \"f\"(cur[k_].ai), \"f\"(cur[k_].vr), \"f\"(cur[k_].vi));\n")
_WAIT_COL = ("#pragma unroll\n  for (int i_ = 0; i_ < MAXN; ++i_) "
             "asm volatile(\"\" :: \"f\"(col[i_].r), \"f\"(col[i_].i));\n")
# per kernel and design: marks as (text the mark follows, stage it closes,
# code put before the mark), the thread that measures, the text after which
# the counters start, the text before which they are flushed, and the mark
# after which one item (K12: a system) is counted
DESIGNS = {
    "aec_scan.cu": {
        "per-thread groups": dict(
            tid=1,
            marks=(
                ("    if (k < Tf) cur[k] = load_frame(a + k * a_stride, v + k * v_stride, f, F, "
                 "has_im);\n  }\n", 0, ""),
                ("      if (t < Tf) nxt[k] = load_frame(a + t * a_stride, v + t * v_stride, f, F, "
                 "has_im);\n    }\n", 2, ""),
                ("      const float v2 = x.vr * x.vr + x.vi * x.vi;\n", 3, ""),
                ("          Ri = Ri - (Ri - Gi) * mu;\n        }\n      }\n", 5, ""),
                ("      if (has_im) o[F - 1 + f] = Ei;\n", 6, ""),
                ("    for (int k = 0; k < K; ++k) cur[k] = nxt[k];\n", 1, _WAIT_FRAMES),
            ),
            start="  float* e = E + (size_t)row * M;\n",
            end="    for (int k = 0; k < K; ++k) cur[k] = nxt[k];\n  }\n",
        ),
        "staged": dict(
            tid=1,
            marks=(
                ("  // probe: set-up done\n", 0, ""),
                ("    // probe: step staged\n", 1, ""),
                ("    // probe: copies started\n", 2, ""),
                ("    // probe: front done\n", 4, ""),
                ("    // probe: recursion done\n", 5, ""),
                ("    // probe: stored\n", 6, ""),
            ),
            start="  // probe: kernel start\n",
            end="  // probe: kernel end\n",
        ),
    },
    "gj_solve.cu": {
        "warp per system, shuffles": dict(
            tid=0,
            marks=(
                ("      else if (lane == n) col[i] = rs[i];\n    }\n  }\n", 1, _WAIT_COL),
                ("                (col[k].i * pr - col[k].r * pi) / den};\n", 2, ""),
                ("      col[k] = q;\n", 3, ""),
                ("      if (i < n) xs[i] = col[i];\n  }\n", 4, ""),
            ),
            item="      if (i < n) xs[i] = col[i];\n  }\n",
            start="  const cf* rs = r + (size_t)sys * n;\n",
            end="      if (i < n) xs[i] = col[i];\n  }\n",
        ),
        "staged": dict(
            tid=0,
            marks=(
                ("  // probe: set-up done\n", 0, ""),
                ("    // probe: staged\n", 1, ""),
                ("      // probe: loaded\n", 1, ""),
                ("        // probe: quotients\n", 2, ""),
                ("        // probe: updated\n", 3, ""),
                ("      // probe: stored\n", 4, ""),
            ),
            item="      // probe: stored\n",
            start="  // probe: kernel start\n",
            end="  // probe: kernel end\n",
            # the kernel of n = 32 .. 40 (rows 32 .. 39 split across four
            # lanes), where the source has it: the same stages and counters
            extra=(dict(
                marks=(
                    ("  // probe (wide): set-up done\n", 0, ""),
                    ("    // probe (wide): staged\n", 1, ""),
                    ("    // probe (wide): loaded\n", 1, ""),
                    ("      // probe (wide): quotients\n", 2, ""),
                    ("      // probe (wide): updated\n", 3, ""),
                    ("    // probe (wide): stored\n", 4, ""),
                ),
                item="    // probe (wide): stored\n",
                start="  // probe (wide): kernel start\n",
                end="  // probe (wide): kernel end\n",
            ),),
        ),
    },
}


def _tag(name: str) -> str:
    return name.split(".")[0].split("_")[0]  # "aec" / "gj"


def instrument(src: str, name: str) -> tuple[str, str]:
    """The source with the marks of its design, and the design's name."""
    for design, d in DESIGNS[name].items():
        anchors = [a for a, _, _ in d["marks"]] + [d["start"], d["end"]]
        if all(src.count(a) == 1 for a in anchors):
            break
    else:
        raise RuntimeError(f"{name}: no known design's marks all match the source")
    t = _tag(name)
    head = (f"__shared__ long long dsr_probe_ph_{t}[{NSLOT}];\n"
            f"__shared__ long long dsr_probe_last_{t};\n"
            f"__shared__ long long dsr_probe_items_{t};\n"
            f"__device__ unsigned long long dsr_probe_acc_{t}[{NSLOT + 2}];\n")
    who = f"(threadIdx.x == {d['tid']})"
    mark = (f"if {who} {{ const long long now_ = clock64(); dsr_probe_ph_{t}[%d] += now_ - "
            f"dsr_probe_last_{t}; dsr_probe_last_{t} = now_; }}\n")
    init = (f"  if {who} {{ for (int i_ = 0; i_ < {NSLOT}; ++i_) dsr_probe_ph_{t}[i_] = 0; "
            f"dsr_probe_items_{t} = 0; dsr_probe_last_{t} = clock64(); }}\n")
    flush = (f"  if {who} {{ for (int i_ = 0; i_ < {NSLOT}; ++i_) "
             f"atomicAdd(&dsr_probe_acc_{t}[i_], (unsigned long long)dsr_probe_ph_{t}[i_]); "
             f"atomicAdd(&dsr_probe_acc_{t}[{NSLOT}], 1ull); "
             f"atomicAdd(&dsr_probe_acc_{t}[{NSLOT + 1}], (unsigned long long)dsr_probe_items_{t}); }}\n")
    parts = [d] + [e for e in d.get("extra", ())
                   if all(src.count(a) == 1 for a in [a for a, _, _ in e["marks"]]
                          + [e["start"], e["end"]])]
    for part in parts:
        src = src.replace(part["end"], part["end"] + "@@FLUSH@@")
        for anchor, slot, extra in part["marks"]:
            code = extra + mark % slot
            if anchor == part.get("item"):
                code += f"if {who} ++dsr_probe_items_{t};\n"
            src = src.replace(anchor, anchor + code)
        src = src.replace(part["start"], part["start"] + init)
        src = src.replace("@@FLUSH@@", flush)
    src = src.replace('#include "dsr_kernels.h"\n', '#include "dsr_kernels.h"\n' + head, 1)
    # the counters are static shared memory: K9's plan asks for the whole of
    # a block's dynamic shared memory, which then no longer exists (its ring
    # needs far less, so the plan is the same)
    src = src.replace("constexpr size_t MAX_SMEM = 227 * 1024;",
                      "constexpr size_t MAX_SMEM = 227 * 1024 - 1024;")
    src += (f'\nextern "C" int dsr_probe_{t}(unsigned long long* host) {{\n'
            f"  cudaError_t e = cudaMemcpyFromSymbol(host, dsr_probe_acc_{t}, "
            f"sizeof(dsr_probe_acc_{t}));\n"
            f"  if (e != cudaSuccess) return (int)e;\n"
            f"  static const unsigned long long zero[{NSLOT + 2}] = {{}};\n"
            f"  return (int)cudaMemcpyToSymbol(dsr_probe_acc_{t}, zero, sizeof(zero));\n}}\n")
    return src, design


def load_copy(root: Path, tag: str, instrumented: bool):
    """Build ``root``'s kernels (K9 and K12 instrumented, or as they are)
    under this checkout's (ignored) build dir with ``root``'s own build
    module; return the loaded library and the designs' names."""
    out = _build.BUILD_DIR / f"aec_gj_phases_{tag}"
    pkg = out / "distant_speech_recognition_tpu_torch"
    if out.exists():
        shutil.rmtree(out)
    for sub in ("csrc", "kernels"):
        shutil.copytree(root / "distant_speech_recognition_tpu_torch" / sub, pkg / sub,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (pkg / "__init__.py").touch()
    designs = {}
    if instrumented:
        for name in STAGES:
            path = pkg / "csrc" / name
            text, designs[name] = instrument(path.read_text(), name)
            path.write_text(text)
    spec = importlib.util.spec_from_file_location(f"aec_gj_phases_build_{tag}",
                                                  pkg / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    lib = mod.library()
    if instrumented:
        for name in STAGES:
            fn = getattr(lib, f"dsr_probe_{_tag(name)}")
            fn.argtypes = [ctypes.c_void_p]
            fn.restype = ctypes.c_int
    return lib, designs


def compiled_report(root: Path) -> None:
    """Registers and spills (``-Xptxas=-v``) and, from the SASS
    (``cuobjdump -sass``), the counts of instructions, SHFL, FCHK, BRA,
    CALL, MUFU.RCP, FFMA, DFMA, DMUL, F2F, LDS, STS, LDGSTS and BAR of every
    kernel of K9's and K12's sources."""
    nvcc = _build.nvcc_path()
    csrc = root / "distant_speech_recognition_tpu_torch" / "csrc"
    cuobjdump = Path(nvcc).with_name("cuobjdump")
    flags = [f for f in _build.NVCC_FLAGS if f not in ("-Xcompiler", "-fPIC")]
    for name in STAGES:
        with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
            cubin = Path(tmp) / "k.cubin"
            res = subprocess.run([nvcc, *flags, "-I", str(csrc), "-cubin", "-o", str(cubin),
                                  str(csrc / name)], capture_output=True, text=True)
            if res.returncode:
                raise RuntimeError(res.stdout + res.stderr)
            kernel = "?"
            for line in (res.stdout + res.stderr).splitlines():
                if "Compiling entry" in line or "Function properties for" in line:
                    kernel = line.split()[-1].strip("'")
                elif "Used" in line or "spill" in line:
                    print(f"  ptxas {name} {kernel}: {line.split(':', 1)[-1].strip()}")
            sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                                  text=True).stdout
        for block in re.split(r"\n\s*Function : ", sass)[1:]:
            fn = block.split("\n", 1)[0].strip()
            ins = [m.split() for m in re.findall(r"/\*[0-9a-f]{4,}\*/\s+([^;]*);", block)]
            ops = [(i[1] if i[0].startswith("@") else i[0]).split(".")[0] for i in ins if i]

            def count(op):
                return sum(1 for o in ops if o == op)

            print(f"  SASS {name} {fn}: {len(ops)} instructions, SHFL {count('SHFL')}, "
                  f"FCHK {count('FCHK')}, BRA {count('BRA')}, CALL {count('CALL')}, "
                  f"MUFU {count('MUFU')}, FFMA {count('FFMA')}, DFMA {count('DFMA')}, "
                  f"DMUL {count('DMUL')}, F2F {count('F2F')}, LDS {count('LDS')}, "
                  f"STS {count('STS')}, LDGSTS {count('LDGSTS')}, BAR {count('BAR')}")


def read(lib, name: str) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (NSLOT + 2))()
    code = getattr(lib, f"dsr_probe_{_tag(name)}")(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"probe read failed ({code})")
    return np.array(buf, dtype=np.float64)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal to the bit (a signed zero or a NaN payload counts)."""
    if a.is_complex():
        a, b = torch.view_as_real(a), torch.view_as_real(b)
    return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


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


def hash_noise(shape, seed) -> np.ndarray:
    """`tests/test_torch_kernels.py`'s ``_hash_noise``: the same bits on
    every machine."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


# the stored K9 cases: (tag, kind, Tf, B, C, M); 17 and 23 frames, no
# multiple of a step of frames
AEC_CASES = (("n256", "nlms", 17, 2, 2, 256), ("k256", "kalman", 17, 2, 2, 256),
             ("n128", "nlms", 23, 1, 3, 128), ("k128", "kalman", 23, 1, 3, 128))
# the stored K12 cases: (n, systems); system 0 of n = 6 has a zero first pivot
GJ_CASES = ((6, 37), (20, 9), (24, 9), (31, 3))
# the stored cases of the kernel of n = 32 .. 40, from hash noise: (n,
# systems, seed); system 0 of n = 33 has a zero first pivot
GJ_WIDE_CASES = ((33, 11, 33), (40, 7, 40))


def aec_case_input(tag: str, Tf: int, B: int, C: int, M: int):
    """A stored K9 case's frames: hash noise, with far-end bins 3-8 of
    utterance 0 zero (the guarded quotient) and frames 5-10 60 dB down (the
    gate closes)."""
    F = M // 2 + 1
    A = hash_noise((Tf, B, C, M), ord(tag[0]) + M)
    V = hash_noise((Tf, B, M), ord(tag[0]) + M + 1)
    V[:, 0, 3:9] = 0.0
    V[:, 0, F + 2:F + 8] = 0.0
    V[5:11] *= np.float32(1e-3)
    return A, V


def hpd_systems(rng, N: int, n: int):
    """Diagonally loaded Hermitian positive-definite systems, as WPE builds
    them, and right-hand sides (complex64, numpy)."""
    L = rng.standard_normal((N, n, 3 * n)) + 1j * rng.standard_normal((N, n, 3 * n))
    R = np.einsum("npt,nqt->npq", L, L.conj())
    R += (np.abs(np.diagonal(R, axis1=1, axis2=2)).max(-1) * 0.01)[:, None, None] * np.eye(n)
    r = rng.standard_normal((N, n)) + 1j * rng.standard_normal((N, n))
    return R.astype(np.complex64), r.astype(np.complex64)


def write_case(path: Path) -> None:
    """Store the K9 and K12 cases from the kernels now loaded."""
    dev = torch.device("cuda", 0)
    z = {}
    for tag, kind, Tf, B, C, M in AEC_CASES:
        A, V = aec_case_input(tag, Tf, B, C, M)
        E = aec_scan(torch.from_numpy(A).to(dev), torch.from_numpy(V).to(dev), kind,
                     *KINDS[kind], THR)
        z[f"{tag}_E"] = E.cpu().numpy()
    rng = np.random.default_rng(2024)
    for n, N in GJ_CASES:
        R, r = hpd_systems(rng, N, n)
        if n == 6:
            R[0, 0, 0] = 0
        x = gj_solve(torch.from_numpy(R).to(dev), torch.from_numpy(r).to(dev))
        z[f"gj{n}_R"], z[f"gj{n}_r"], z[f"gj{n}_x"] = R, r, x.cpu().numpy()
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **z)
    print(f"wrote {path} ({path.stat().st_size} bytes): " + ", ".join(sorted(z)))


def hash_systems(N: int, n: int, seed: int):
    """`hpd_systems` from `hash_noise` (float64 products, rounded once)."""
    h = hash_noise((4, N, n, 3 * n), seed).astype(np.float64)
    L = h[0] + 1j * h[1]
    R = np.einsum("npt,nqt->npq", L, L.conj())
    R += (np.abs(np.diagonal(R, axis1=1, axis2=2)).max(-1) * 0.01)[:, None, None] * np.eye(n)
    r = (h[2, :, :, 0] + 1j * h[3, :, :, 0]) * 0.01
    return R.astype(np.complex64), r.astype(np.complex64)


def update_npz(path: Path, z: dict) -> None:
    """Write ``z`` into the npz at ``path``, keeping its other entries."""
    old = dict(np.load(path)) if path.exists() else {}
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **(old | z))
    print(f"wrote {path} ({path.stat().st_size} bytes): " + ", ".join(sorted(z)))


def write_wide_case(path: Path) -> None:
    """Store the K12 cases of n = 33 and 40 from the kernels now loaded."""
    dev = torch.device("cuda", 0)
    z = {}
    for n, N, seed in GJ_WIDE_CASES:
        R, r = hash_systems(N, n, seed)
        if n == 33:
            R[0, 0, 0] = 0
        x = gj_solve(torch.from_numpy(R).to(dev), torch.from_numpy(r).to(dev))
        z[f"gj{n}_R"], z[f"gj{n}_r"], z[f"gj{n}_x"] = R, r, x.cpu().numpy()
    update_npz(path, z)


def takes(fn) -> bool:
    """Whether the kernels now loaded take the call (an older checkout
    refuses the shapes of config 4 at 8 channels)."""
    try:
        fn()
    except (RuntimeError, AttributeError):  # a refused shape, or an entry it lacks
        return False
    torch.cuda.synchronize()
    return True


def aec_inputs(rng, Tf, B, C, M, dev):
    """Packed frames at 100 x standard normal, with zero far-end bins and a
    stretch 60 dB down (the gate closes there)."""
    F = M // 2 + 1
    A = torch.from_numpy((rng.standard_normal((Tf, B, C, M), dtype=np.float32) * 100)).to(dev)
    V = torch.from_numpy((rng.standard_normal((Tf, B, M), dtype=np.float32) * 100)).to(dev)
    V[:, 0, 10:20] = 0.0
    V[:, 0, F + 9:F + 19] = 0.0
    V[Tf // 3:Tf // 3 + Tf // 10, 1 % B] *= 1e-3
    return A, V


def gj_inputs(N, n, dev, chunk=16384):
    """`hpd_systems` made on the card in chunks (N can be 132,096)."""
    Rs, rs = [], []
    for s in range(0, N, chunk):
        k = min(chunk, N - s)
        L = torch.complex(torch.randn(k, n, 3 * n, device=dev, dtype=torch.float64),
                          torch.randn(k, n, 3 * n, device=dev, dtype=torch.float64))
        R = L @ L.conj().transpose(-1, -2)
        load = torch.diagonal(R, dim1=-2, dim2=-1).abs().amax(-1) * 0.01
        R = R + load[:, None, None] * torch.eye(n, device=dev, dtype=torch.float64)
        Rs.append(R.to(torch.complex64))
        rs.append(torch.complex(torch.randn(k, n, device=dev), torch.randn(k, n, device=dev)))
    return torch.cat(Rs), torch.cat(rs)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose kernels are measured (default: this one)")
    ap.add_argument("--write-case", type=Path, default=None,
                    help="store the K9 / K12 cases from the measured kernels here")
    ap.add_argument("--write-wide-case", type=Path, default=None,
                    help="store K12's cases of n = 33 and 40 from the measured kernels here")
    args = ap.parse_args()
    root = args.root.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"kernels of {root}")
    own = _build.library()
    other = root != REPO
    if other:
        print("this checkout's kernels:")
        compiled_report(REPO)
        print(f"the kernels of {root}:")
    compiled_report(root)
    plain_lib, _ = load_copy(root, "plain", False)
    lib, designs = load_copy(root, "marked", True)
    print("designs: " + ", ".join(f"{k} {v}" for k, v in designs.items()))
    dev = torch.device("cuda", 0)
    _build._lib = plain_lib
    if args.write_case is not None:
        write_case(args.write_case)
    if args.write_wide_case is not None:
        write_wide_case(args.write_wide_case)
    # the shapes of config 4 at 8 channels, which checkouts before it refuse
    wide = takes(lambda: gj_solve(*gj_inputs(1, 40, dev)))
    block_kalman = takes(lambda: aec_scan(*aec_inputs(np.random.default_rng(1), 3, 1, 1, M4, dev),
                                          "block_kalman", *KINDS["kalman"], THR))
    print(f"the measured checkout takes n = 40: {wide}, the block Kalman kind: {block_kalman}")

    def measure(label, name, fn, per):
        """CUDA-event times (the measured checkout's kernel; with --root this
        checkout's too, in turns) and the instrumented copy's cycles per
        stage, divided by ``per(acc)``."""
        _build._lib = plain_lib
        ms = [event_ms(fn)]
        line = f"{label}: {ms[0]:.3f} ms"
        if other:
            _build._lib = own
            ms += [event_ms(fn), event_ms(fn)]
            _build._lib = plain_lib
            ms.append(event_ms(fn))
            line = (f"{label}: measured {ms[0]:.3f} / {ms[3]:.3f} ms, this checkout "
                    f"{ms[1]:.3f} / {ms[2]:.3f} ms")
        _build._lib = lib
        fn()
        torch.cuda.synchronize()
        read(lib, name)  # drop the warm-up's counts
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        acc = read(lib, name)
        d = per(acc)
        used = [i for i in range(len(STAGES[name])) if acc[i] > 0]
        print(f"{line} ({start.elapsed_time(end):.3f} ms instrumented), {int(acc[NSLOT])} "
              f"blocks; cycles per {'frame' if name == 'aec_scan.cu' else 'system'}: "
              + "  ".join(f"{STAGES[name][i]} {acc[i] / d:.0f}" for i in used)
              + f"  (sum {acc[:NSLOT].sum() / d:.0f})")

    rng = np.random.default_rng(0)
    A, V = aec_inputs(rng, TF, 256, C4, M4, dev)
    for kind, (p1, p2) in KINDS.items():
        for B in (256, 8, 1):
            Ab, Vb = A[:, :B].contiguous(), V[:, :B].contiguous()
            measure(f"K9 {kind} Tf={TF} B={B} C={C4} M={M4}", "aec_scan.cu",
                    lambda: aec_scan(Ab, Vb, kind, p1, p2, THR),
                    lambda acc: max(acc[NSLOT], 1) * TF)
    systems = {}
    for n in (20, 24):
        torch.manual_seed(n)
        R, r = gj_inputs(132096, n, dev)
        systems[n] = (R, r)
        measure(f"K12 N=132096 n={n}", "gj_solve.cu", lambda: gj_solve(R, r),
                lambda acc: max(acc[NSLOT + 1], 1))
    if block_kalman:
        A8, V8 = aec_inputs(rng, TF, 256, 8, M4, dev)
        p1, p2 = KINDS["kalman"]
        for Cb, Ab in ((C4, A[:, :, :C4].contiguous()), (8, A8)):
            measure(f"K9 block_kalman Tf={TF} B=256 C={Cb} M={M4}", "aec_scan.cu",
                    lambda: aec_scan(Ab, V if Cb == C4 else V8, "block_kalman", p1, p2, THR),
                    lambda acc: max(acc[NSLOT], 1) * TF)
        del A8, V8
    if wide:
        torch.manual_seed(40)
        R, r = gj_inputs(264192, 40, dev)
        measure("K12 N=264192 n=40", "gj_solve.cu", lambda: gj_solve(R, r),
                lambda acc: max(acc[NSLOT + 1], 1))
        del R, r
    if other:
        same = {}
        _build._lib = own
        for n, (R, r) in systems.items():
            outs = []
            for lib_ in (plain_lib, own):
                _build._lib = lib_
                outs.append(gj_solve(R, r))
            same[f"K12 N=132096 n={n}"] = bits_equal(*outs)
        for n, N in ((1, 1000), (4, 333), (5, 77), (6, 37), (19, 100), (20, 1001), (21, 5),
                     (24, 64), (25, 9), (31, 3), (31, 40),
                     # several systems a warp
                     (5, 16901), (20, 16901), (31, 3301),
                     # the kernel of n = 32 .. 40: systems left partial in a
                     # block, several a warp, odd n (8-byte copies)
                     *(((32, 7), (33, 77), (36, 5), (39, 9), (40, 1001), (33, 16901),
                        (40, 16901)) if wide else ())):
            R, r = gj_inputs(N, n, dev)
            R[0, 0, 0] = 0  # a zero first pivot: the divisor taken as 1
            outs = []
            for lib_ in (plain_lib, own):
                _build._lib = lib_
                outs.append(gj_solve(R, r))
            same[f"K12 N={N} n={n}"] = bits_equal(*outs)
        for kind, (p1, p2) in KINDS.items():
            for Tf, B, C, M in ((TF, 256, 4, 256), (1, 1, 1, 256), (3, 2, 4, 256),
                                (37, 3, 8, 256), (23, 5, 1, 128), (50, 9, 3, 128),
                                (41, 2, 2, 8),
                                # several channels a block, several blocks an utterance
                                (45, 40, 8, 256), (45, 132, 6, 256)):
                Ac, Vc = aec_inputs(rng, Tf, B, C, M, dev)
                outs = []
                for lib_ in (plain_lib, own):
                    _build._lib = lib_
                    outs.append(aec_scan(Ac, Vc, kind, p1, p2, THR))
                same[f"K9 {kind} Tf={Tf} B={B} C={C} M={M}"] = bits_equal(*outs)
        differ = [k for k, v in same.items() if not v]
        print(f"this checkout equals the measured one bit for bit in {len(same) - len(differ)} "
              f"of {len(same)} cases; differs in: {', '.join(differ) or 'none'}")
    _build._lib = own


if __name__ == "__main__":
    main()
