"""The adaptive GSC + Zelinski as hand-written CUDA kernels: the scans and the
one-kernel chains.

Counterpart of the JAX package's ``models/pallas_fused_scan.py`` and, for
the LMS form, of its XLA scan ``models/adaptive_gsc.gsc_postfilter_fused(
kind="lms")``:

- `gsc_rls_zelinski` (K2) replaces ``gsc_rls_zelinski_pallas``: one set of
  weights for every utterance.
- `gsc_rls_zelinski_steered` (K6) replaces
  ``gsc_rls_zelinski_steered_pallas``: one set of weights per utterance (the
  SRP-PHAT-steered pipeline).  Both launch ``csrc/gsc_rls_zelinski.cu``
  for a CUDA tensor or raise; for a CPU tensor they run the plain loop
  `models.adaptive_gsc.gsc_postfilter_fused`, the specification the kernel
  is held to.
- `gsc_lms_zelinski` runs the GSC with the NLMS active weight vector
  (BASELINE config 3), ``csrc/gsc_lms_zelinski.cu``: `lms_gates` first, the
  silence gate once per (utterance, frame), then the scan, two lanes a bin;
  neither has a TPU counterpart (the JAX package runs this recursion in
  XLA).  `gsc_lms_zelinski_steered` is the same scan with one set of
  weights per utterance (the steered GSC-LMS), its own entry and launch
  count.  `lms_launch_shape` reads the scan's launch.
- Passing ``pf_min_frames=NO_POSTFILTER`` to a scan gives the beamformer's
  output without the gain (``postfilter="none"``), to the bit.
- `analysis_gsc_synthesis` (K4) replaces ``analysis_gsc_synthesis_pallas``
  (raw samples in, samples out) and `analysis_gsc_rls_zelinski` (K5)
  replaces ``analysis_gsc_rls_zelinski_pallas`` (raw samples in, the packed
  beamformed spectrum out), both ``csrc/gsc_mono.cu``, for the shapes
  `gsc_mono_supported` accepts; for a CPU tensor they run the plain chain
  (`filterbank.analysis_half_real_tm`, the plain loop,
  `filterbank.synthesis_half_real_tm`).  The pipeline runs K1 -> K2 -> K3
  for the shapes K4 refuses, as the JAX package runs its split kernels.
"""

from __future__ import annotations

import torch

from ..ops.filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    analysis_taps,
    num_analysis_frames,
    synthesis_half_real_tm,
    synthesis_taps,
)
from ..ops.filterbank_kernels import fft_twiddles_tensor, prototype_taps
from .adaptive_gsc import GSCLMSConfig, GSCRLSConfig, gsc_postfilter_fused, lms_silence_gates
from .postfilter import PostFilterType, zelinski_args

__all__ = [
    "NO_POSTFILTER",
    "gsc_lms_zelinski",
    "gsc_lms_zelinski_steered",
    "lms_gates",
    "gsc_rls_zelinski",
    "gsc_rls_zelinski_steered",
    "scan_launch_shape",
    "lms_launch_shape",
    "gsc_mono_supported",
    "analysis_gsc_rls_zelinski",
    "analysis_gsc_synthesis",
]

# analysis rows per tile of the one-kernel chains: a tile holds 64 // C
# frames, and K4's synthesis halo of m*R - 1 frames must fit.  Every launch
# passes it to csrc/gsc_mono.cu, which refuses it unless it equals its ROWS
GSC_MONO_ROWS = 64

# a pf_min_frames that no frame index passes (the kernels take an int32):
# the Zelinski gain is computed and never applied
NO_POSTFILTER = 2**31 - 1


def _lms_args(cfg: GSCLMSConfig) -> tuple:
    """The LMS arguments the scan's CUDA entry point takes, in its order."""
    c = cfg
    return (c.beta, 1.0 - c.beta, c.gamma, c.init_diagonal_load, c.regularization_param,
            c.energy_floor, c.max_wa_l2norm, c.min_frames, c.slowdown_after)


def _rls_args(cfg: GSCRLSConfig) -> tuple:
    """The RLS arguments the CUDA entry points take, in their order."""
    c = cfg
    return (c.beta, 1.0 - c.beta, c.gamma, c.mu, c.init_diagonal_load,
            1.0 / c.init_diagonal_load, c.regularization_param, c.sil_thresh,
            c.constraint_option, c.alpha2, c.max_wa_l2norm, c.min_frames)


def _scan(wrapper, entry: str, kind: str, Yp, wqH, BmH, wq_manifold, cfg, pf_alpha, pf_type,
          pf_min_frames, lead: tuple) -> torch.Tensor:
    """Run the GSC (``kind`` "lms" or "rls") + Zelinski scan on ``Yp [Tf, B,
    C, M]``: the plain loop for a CPU tensor, else the kernel's C entry point
    ``entry`` with weights ``lead + [F, ...]`` (``lead`` is ``()`` for one
    steering, ``(B,)`` for K6)."""
    if Yp.device.type == "cpu":
        return gsc_postfilter_fused(
            Yp, None, wqH, BmH, wq_manifold, kind, cfg, pf_alpha, pf_type, pf_min_frames, True
        )
    if Yp.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, complex_view, stream_handle

    if Yp.dim() != 4:
        raise ValueError(f"Yp must be [Tf, B, C, M], got {tuple(Yp.shape)}")
    Tf, B, C, M = Yp.shape
    F = M // 2 + 1
    Bc = BmH.shape[-2]
    wq = complex_view("wqH", wqH, lead + (F, C))
    bm = complex_view("BmH", BmH, lead + (F, Bc, C))
    ta = complex_view("wq_manifold", wq_manifold, lead + (F, C))
    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    lib = _build.library()
    # the LMS scan's silence gates [Tf, B]; K2/K6's energy buffer, of the size
    # their C side asks for (empty, a null pointer, where they need none)
    gates = energies = ()
    if kind == "lms":
        # a shape the scan refuses raises before either kernel launches
        _build.check(lib.dsr_gsc_lms_zelinski_args_ok(Tf, B, C, Bc, M, cfg.slowdown_after),
                     wrapper.__name__)
        gates = (lms_gates(Yp, cfg),)
    else:
        n_en = lib.dsr_gsc_rls_zelinski_energy_floats(Tf, B, M)
        energies = (torch.empty(n_en, dtype=torch.float32, device=Yp.device),)
    out = torch.empty((Tf, B, M), dtype=torch.float32, device=Yp.device)
    code = getattr(lib, entry)(
        Yp.data_ptr(), *(t.data_ptr() for t in gates), wq.data_ptr(), bm.data_ptr(),
        ta.data_ptr(), out.data_ptr(), *(t.data_ptr() for t in energies),
        Tf, B, C, Bc, M, *(_lms_args(cfg) if kind == "lms" else _rls_args(cfg)),
        *zelinski_args(C, pf_alpha, pf_type, pf_min_frames), stream_handle(Yp.device),
    )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return out


def gsc_rls_zelinski(
    Yp: torch.Tensor,
    wqH: torch.Tensor,
    BmH: torch.Tensor,
    wq_manifold: torch.Tensor,
    cfg: GSCRLSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """GSC-RLS beamformer + Zelinski postfilter over the packed time-major
    spectrum ``Yp [Tf, B, C, M]`` -> packed ``[Tf, B, M]``.  Weights are
    complex64: ``wqH [F, C]``, ``BmH [F, C-1, C]``, ``wq_manifold [F, C]``
    on ``Yp``'s device."""
    return _scan(gsc_rls_zelinski, "dsr_gsc_rls_zelinski", "rls", Yp, wqH, BmH, wq_manifold,
                 cfg, pf_alpha, pf_type, pf_min_frames, ())


gsc_rls_zelinski.launches = 0


def gsc_rls_zelinski_steered(
    Yp: torch.Tensor,
    wq_b: torch.Tensor,
    bm_b: torch.Tensor,
    ta_b: torch.Tensor,
    cfg: GSCRLSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """`gsc_rls_zelinski` with one steering per utterance: complex64
    ``wq_b [B, F, C]``, ``bm_b [B, F, C-1, C]`` and the alignment manifolds
    ``ta_b [B, F, C]`` on ``Yp``'s device."""
    return _scan(gsc_rls_zelinski_steered, "dsr_gsc_rls_zelinski_steered", "rls", Yp, wq_b,
                 bm_b, ta_b, cfg, pf_alpha, pf_type, pf_min_frames, (Yp.shape[1],))


gsc_rls_zelinski_steered.launches = 0


def gsc_lms_zelinski(
    Yp: torch.Tensor,
    wqH: torch.Tensor,
    BmH: torch.Tensor,
    wq_manifold: torch.Tensor,
    cfg: GSCLMSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """GSC with the leaky power-normalised LMS active weight vector + Zelinski
    postfilter over the packed time-major spectrum ``Yp [Tf, B, C, M]`` ->
    packed ``[Tf, B, M]``; weights as for `gsc_rls_zelinski`.  On a CUDA
    tensor it launches `lms_gates` and then the scan of
    ``csrc/gsc_lms_zelinski.cu`` (counted here), on a CPU tensor it runs
    `adaptive_gsc.gsc_postfilter_fused(kind="lms")`."""
    return _scan(gsc_lms_zelinski, "dsr_gsc_lms_zelinski", "lms", Yp, wqH, BmH, wq_manifold,
                 cfg, pf_alpha, pf_type, pf_min_frames, ())


gsc_lms_zelinski.launches = 0


def gsc_lms_zelinski_steered(
    Yp: torch.Tensor,
    wq_b: torch.Tensor,
    bm_b: torch.Tensor,
    ta_b: torch.Tensor,
    cfg: GSCLMSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """`gsc_lms_zelinski` with one steering per utterance: complex64 ``wq_b
    [B, F, C]``, ``bm_b [B, F, C-1, C]`` and ``ta_b [B, F, C]`` on ``Yp``'s
    device.  On a CUDA tensor it launches `lms_gates` (which reads no
    weights) and then the scan's per-utterance entry (counted here)."""
    return _scan(gsc_lms_zelinski_steered, "dsr_gsc_lms_zelinski_steered", "lms", Yp, wq_b,
                 bm_b, ta_b, cfg, pf_alpha, pf_type, pf_min_frames, (Yp.shape[1],))


gsc_lms_zelinski_steered.launches = 0


def lms_gates(Yp: torch.Tensor, cfg: GSCLMSConfig) -> torch.Tensor:
    """The LMS scan's silence gates of the packed time-major spectrum ``Yp
    [Tf, B, C, M]``: float ``[Tf, B]``, 1 where frame t of utterance b
    adapts.  On a CUDA tensor it launches the gate kernel of
    ``csrc/gsc_lms_zelinski.cu``, on a CPU tensor it runs
    `adaptive_gsc.lms_silence_gates`."""
    if Yp.device.type == "cpu":
        return lms_silence_gates(Yp, cfg)
    from ..kernels import _build, check_cuda_tensor, stream_handle

    if Yp.dim() != 4:
        raise ValueError(f"Yp must be [Tf, B, C, M], got {tuple(Yp.shape)}")
    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    Tf, B, C, M = Yp.shape
    gates = torch.empty((Tf, B), dtype=torch.float32, device=Yp.device)
    c = cfg
    code = _build.library().dsr_lms_gates(
        Yp.data_ptr(), gates.data_ptr(), Tf, B, C, M, c.beta, 1.0 - c.beta,
        c.init_diagonal_load, c.sil_thresh, stream_handle(Yp.device))
    _build.check(code, "lms_gates")
    lms_gates.launches += 1
    return gates


lms_gates.launches = 0


def scan_launch_shape(B: int, C: int, M: int) -> dict[str, int]:
    """The launch K2 and K6 take for ``B`` utterances of ``C`` channels and
    ``M`` lanes on the current card: blocks, threads a block, frames a chunk,
    dynamic shared memory (bytes), registers a thread, blocks per SM."""
    import ctypes

    from ..kernels import _build

    keys = ("blocks", "threads", "frames", "smem_bytes", "registers", "blocks_per_sm")
    vals = [ctypes.c_int() for _ in keys]
    code = _build.library().dsr_gsc_rls_zelinski_shape(
        B, C, M, *(ctypes.addressof(v) for v in vals))
    _build.check(code, "gsc_rls_zelinski shape")
    return {k: v.value for k, v in zip(keys, vals)}


# the LMS scan's Zelinski stages (csrc/gsc_lms_zelinski.cu)
LMS_ZELINSKI_MODES = {"real": 1, "abs": 2}


def lms_launch_shape(B: int, C: int, M: int, zelinski: str = "real") -> dict[str, int]:
    """The launch the LMS scan takes for ``B`` utterances of ``C`` channels
    and ``M`` lanes on the current card, with its Zelinski stage ``zelinski``
    ("real": ``pf_type & 1``, or "abs"): lanes a bin,
    blocks, threads a block, frames a warp stages ahead, dynamic shared
    memory (bytes), registers a thread, local memory a thread (bytes;
    spills), blocks per SM."""
    import ctypes

    from ..kernels import _build

    keys = ("lanes", "blocks", "threads", "frames", "smem_bytes", "registers", "local_bytes",
            "blocks_per_sm")
    vals = [ctypes.c_int() for _ in keys]
    code = _build.library().dsr_gsc_lms_zelinski_shape(
        B, C, M, LMS_ZELINSKI_MODES[zelinski], *(ctypes.addressof(v) for v in vals))
    _build.check(code, "gsc_lms_zelinski shape")
    return {k: v.value for k, v in zip(keys, vals)}


def gsc_mono_supported(fb: FilterbankParams, C: int) -> bool:
    """Whether K4 takes this filterbank and channel count: M = 256, 2 <= C
    <= 8 and a synthesis halo of m*R - 1 frames within one frame tile (K5
    takes M = 256 and 2 <= C <= 8 with any halo)."""
    return fb.M == 256 and 2 <= C <= 8 and fb.m * fb.R - 1 <= GSC_MONO_ROWS // C


def _mono(synth: bool, x, h, g, fb, wqH, BmH, wq_manifold, cfg, pf, hr, gf):
    """Launch K4 (``synth``) or K5 on the CUDA tensor ``x [B, C, T]``; the
    kernel does its DFTs as FFTs from `fft_twiddles_tensor`."""
    from ..kernels import _build, check_cuda_tensor, complex_view, stream_handle

    name = "gsc_mono" if synth else "gsc_analysis"
    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    M, m, R, D = fb.M, fb.m, fb.R, fb.D
    F = M // 2 + 1
    Bc = BmH.shape[-2]
    Tf = num_analysis_frames(fb, T)
    if hr is None:
        hr = prototype_taps(analysis_taps, h, fb, x.device)
    tw = fft_twiddles_tensor(M, x.device)
    wq = complex_view("wqH", wqH, (F, C))
    bm = complex_view("BmH", BmH, (F, Bc, C))
    ta = complex_view("wq_manifold", wq_manifold, (F, C))
    x = x.contiguous()
    check_cuda_tensor("x", x)
    check_cuda_tensor("hr", hr, (m, M))
    shift = fb.laN - (m * R - 1)
    lib = _build.library()
    tail = (GSC_MONO_ROWS, *_rls_args(cfg), *zelinski_args(C, *pf), stream_handle(x.device))
    if synth:
        pd = fb.synthesis_delay
        T_out = Tf - pd
        if T_out <= 0:
            raise ValueError(f"need more than {pd} subband frames, got {Tf}")
        if gf is None:
            gf = prototype_taps(synthesis_taps, g, fb, x.device)
        check_cuda_tensor("gf", gf, (m, M))
        out = torch.empty((B, T_out * D), dtype=torch.float32, device=x.device)
        code = lib.dsr_gsc_mono(
            x.data_ptr(), hr.data_ptr(), tw.data_ptr(), gf.data_ptr(),
            wq.data_ptr(), bm.data_ptr(), ta.data_ptr(), out.data_ptr(),
            B, C, Bc, T, Tf, M, m, R, D, shift, pd, T_out, *tail,
        )
    else:
        out = torch.empty((Tf, B, M), dtype=torch.float32, device=x.device)
        code = lib.dsr_gsc_analysis(
            x.data_ptr(), hr.data_ptr(), tw.data_ptr(), wq.data_ptr(), bm.data_ptr(),
            ta.data_ptr(), out.data_ptr(), B, C, Bc, T, Tf, M, m, D, shift, *tail,
        )
    _build.check(code, name)
    return out


def analysis_gsc_rls_zelinski(
    x: torch.Tensor,
    h,
    fb: FilterbankParams,
    wqH: torch.Tensor,
    BmH: torch.Tensor,
    wq_manifold: torch.Tensor,
    cfg: GSCRLSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
    A: torch.Tensor | None = None,
    hr: torch.Tensor | None = None,
) -> torch.Tensor:
    """Raw samples ``x [B, C, T]`` -> the packed beamformed spectrum ``[Tf,
    B, M]``: analysis and GSC-RLS + Zelinski in one kernel launch (K5) on a
    CUDA tensor.  ``A`` may hold the plain version's packed analysis matrix
    and ``hr`` the prototype taps (`filterbank_kernels.prototype_taps`)
    already on ``x``'s device; the kernel does its DFT as an FFT and never
    reads ``A``."""
    pf = (pf_alpha, pf_type, pf_min_frames)
    if x.device.type == "cpu":
        Yr = analysis_half_real_tm(x, h, fb, packed=True, A=A)
        return gsc_postfilter_fused(Yr, None, wqH, BmH, wq_manifold, "rls", cfg, *pf, True)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_gsc_rls_zelinski runs on cpu or cuda tensors, got {x.device}")
    out = _mono(False, x, h, None, fb, wqH, BmH, wq_manifold, cfg, pf, hr, None)
    analysis_gsc_rls_zelinski.launches += 1
    return out


analysis_gsc_rls_zelinski.launches = 0


def analysis_gsc_synthesis(
    x: torch.Tensor,
    h,
    g,
    fb: FilterbankParams,
    wqH: torch.Tensor,
    BmH: torch.Tensor,
    wq_manifold: torch.Tensor,
    cfg: GSCRLSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
    A: torch.Tensor | None = None,
    S: torch.Tensor | None = None,
    hr: torch.Tensor | None = None,
    gf: torch.Tensor | None = None,
) -> torch.Tensor:
    """Raw samples ``x [B, C, T]`` -> enhanced samples ``[B, T_out]``:
    analysis, GSC-RLS + Zelinski and synthesis in one kernel launch (K4) on
    a CUDA tensor, for the shapes `gsc_mono_supported` accepts.  ``A``/``S``
    may hold the plain version's packed DFT matrices and ``hr``/``gf`` the
    prototype taps already on ``x``'s device; the kernel does its DFTs as
    FFTs and never reads ``A``/``S``."""
    pf = (pf_alpha, pf_type, pf_min_frames)
    if x.device.type == "cpu":
        Yr = analysis_half_real_tm(x, h, fb, packed=True, A=A)
        Yp = gsc_postfilter_fused(Yr, None, wqH, BmH, wq_manifold, "rls", cfg, *pf, True)
        return synthesis_half_real_tm(Yp, g, fb, S=S)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_gsc_synthesis runs on cpu or cuda tensors, got {x.device}")
    out = _mono(True, x, h, g, fb, wqH, BmH, wq_manifold, cfg, pf, hr, gf)
    analysis_gsc_synthesis.launches += 1
    return out


analysis_gsc_synthesis.launches = 0
