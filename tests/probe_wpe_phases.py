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
that stage whole packed rows D frames ahead).  ``--root DIR`` measures the
kernels of another checkout of the repository (e.g. the parent commit
unpacked with ``git archive``) with this checkout's wrappers; the kernels' C
interface is the same.  With ``--root`` it also holds this checkout's
uninstrumented K10 and K11 to that checkout's, bit for bit, at every shape
that checkout takes among `OLD_SHAPES` (C*P <= 24: every instantiation of
K11's, both EM iterations of K10's, deep delays and two rings).

    python3 tests/probe_wpe_phases.py [--root DIR]

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
NSLOT = 16
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


def mark(slot: int) -> str:
    return ("{ if (probe_row >= 0) { const long long now_ = clock64(); "
            f"probe_ph[probe_row][{slot}] += now_ - probe_last; probe_last = now_; }} }}\n")


def instrument(src: str, name: str) -> tuple[str, str, tuple]:
    """The source with the marks of its design; the design's name and stages.
    The sums live in shared memory, so the marks cost the kernel two
    registers and a few instructions."""
    for design, d in DESIGNS[name].items():
        if all(src.count(anchor) == 1 for anchor, _ in d["marks"]):
            break
    else:
        raise RuntimeError(f"{name}: no known design's marks all match the source")
    end = d.get("end", END)
    if src.count(HEAD) != 1 or src.count(end) != 1:
        raise RuntimeError(f"{name}: the kernel's first or last line moved")
    for anchor, slot in d["marks"]:
        src = src.replace(anchor, anchor + mark(slot))
    decl = (f"  __shared__ long long probe_ph[1][{NSLOT}];\n"
            f"  const int probe_row = (int)threadIdx.x == {d.get('tid', '0')} ? 0 : -1;\n"
            f"  if (probe_row >= 0) for (int i = 0; i < {NSLOT}; ++i) probe_ph[probe_row][i] = 0;\n"
            "  long long probe_last = clock64();\n")
    flush = (mark(d["end_stage"]) + "  if (probe_row >= 0) {\n"
             f"    for (int i = 0; i < {NSLOT}; ++i)\n"
             "      atomicAdd(&probe_acc[probe_row][i], (unsigned long long)probe_ph[probe_row][i]);\n"
             f"    atomicAdd(&probe_acc[probe_row][{NSLOT}], 1ull);\n  }}\n")
    src = src.replace(HEAD, HEAD + decl)
    src = src.replace(end, flush + end)
    src = src.replace("namespace {\n", "namespace {\n__device__ unsigned long long "
                      f"probe_acc[1][{NSLOT + 1}];\n", 1)
    tag = name.split(".")[0]
    src += (f'\nextern "C" int dsr_probe_{tag}(unsigned long long* host) {{\n'
            f"  cudaError_t e = cudaMemcpyFromSymbol(host, probe_acc, sizeof(probe_acc));\n"
            f"  if (e != cudaSuccess) return (int)e;\n"
            f"  static const unsigned long long zero[1][{NSLOT + 1}] = {{}};\n"
            f"  return (int)cudaMemcpyToSymbol(probe_acc, zero, sizeof(zero));\n}}\n")
    return src, design, d["stages"]


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
                kernel = name + "<" + ",".join(re.findall(r"Li(\d+)E", line.split("kernel")[-1])) + ">"
            elif "Used" in line or "spill" in line:
                print(f"  ptxas {kernel}: {line.split(':', 1)[-1].strip()}")


def read(lib, name: str) -> np.ndarray:
    buf = (ctypes.c_ulonglong * (NSLOT + 1))()
    code = getattr(lib, f"dsr_probe_{name.split('.')[0]}")(ctypes.addressof(buf))
    if code:
        raise RuntimeError(f"probe read failed ({code})")
    return np.array(buf, dtype=np.float64).reshape(1, NSLOT + 1)


def report(lib, name: str, stages, label: str, run) -> None:
    run()
    torch.cuda.synchronize()
    read(lib, name)  # drop the warm-up's counts
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    acc = read(lib, name)
    kc = acc[0, :NSLOT] / acc[0, NSLOT] / 1e3
    print(f"{label}: {start.elapsed_time(end):.3f} ms, {int(acc[0, NSLOT])} blocks; "
          "kcycles per block: " + "  ".join(f"{n} {kc[i]:.1f}" for i, n in enumerate(stages))
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


def same_bits(own, other) -> None:
    """This checkout's K10 and K11 against ``other``'s, at `OLD_SHAPES`."""
    same = {}
    for Cs, Ps, low, Ms, Bs, Tfs in OLD_SHAPES:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit(__doc__)
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", type=Path, default=REPO,
                    help="checkout whose kernels are measured (default: this one)")
    root = ap.parse_args().root.resolve()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    print(f"kernels of {root}")
    own = _build.library()
    other = root != REPO
    ptxas_report(root)
    lib, designs = build(root)
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
    if not other:  # the 8-channel shape, which checkouts before it refuse
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
        same_bits(own, load_plain(root))


if __name__ == "__main__":
    main()
