"""Fixed-weight beamformer + Zelinski postfilter as hand-written CUDA kernels.

Counterpart of the fixed-weight half of the JAX package's
``models/pallas_fused_scan.py`` (BASELINE configs 1-2: D&S, SD-MVDR or LCMV
weights, then the Zelinski postfilter):

- `zelinski_apply` (K7) replaces ``zelinski_apply_pallas``: ``Y = wqH X``
  and the Zelinski recursion over the packed time-major spectrum;
  `zelinski_apply_steered` is K7 with one set of weights per utterance (the
  steered D&S of `models.steered`), its own entry and launch count.
- `analysis_fw_synthesis` (K8) replaces ``analysis_fw_synthesis_pallas``:
  analysis bank, K7's per-bin step and synthesis bank in one launch, raw
  samples in, samples out, for the shapes `fw_mono_supported` accepts; the
  pipeline runs the split kernels K1 -> K7 -> K3 for the others, as the JAX
  package runs ``zelinski_apply_pallas`` where its one-kernel chain does not
  fit.

For a CUDA tensor each wrapper launches its kernel (``csrc/zelinski_apply.cu``,
``csrc/fw_mono.cu``) or raises; for a CPU tensor it runs its plain version
(`zelinski_apply_plain`; for K8 the plain analysis, `zelinski_apply_plain`
and the plain synthesis), the specification the kernel is held to.
"""

from __future__ import annotations

import torch

from ..ops.filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    analysis_taps,
    num_analysis_frames,
    pack_half,
    synthesis_half_real_tm,
    synthesis_taps,
    unpack_half,
)
from ..ops.filterbank_kernels import fft_twiddles_tensor, prototype_taps
from .beamforming import apply_weights
from .postfilter import PostFilterType, zelinski_args, zelinski_postfilter

__all__ = ["zelinski_apply_plain", "zelinski_apply", "zelinski_apply_steered",
           "zelinski_launch_shape", "fw_mono_supported", "analysis_fw_synthesis"]

# analysis rows per tile of the one-kernel chain: a tile holds 64 // C
# frames, and the synthesis halo of m*R - 1 frames must fit.  Every launch
# passes it to csrc/fw_mono.cu, which refuses it unless it equals its ROWS,
# so the two tile rules cannot drift apart
FW_MONO_ROWS = 64


def zelinski_apply_plain(
    Yp: torch.Tensor,
    wqH: torch.Tensor,
    wq_manifold: torch.Tensor,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """The plain version of K7: complex snapshots from the packed lanes,
    `beamforming.apply_weights`, `postfilter.zelinski_postfilter`, packed
    again (the DC and Nyquist bins lose their Im part, as synthesis does)."""
    X = unpack_half(Yp).movedim(-2, -1)  # [Tf, B, F, C]
    Y = zelinski_postfilter(X, apply_weights(wqH, X), wq_manifold, pf_alpha, pf_type,
                            pf_min_frames)
    return pack_half(Y)


def zelinski_apply(
    Yp: torch.Tensor,
    wqH: torch.Tensor,
    wq_manifold: torch.Tensor,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """Fixed-weight beamformer + Zelinski postfilter over the packed
    time-major spectrum ``Yp [Tf, B, C, M]`` -> packed ``[Tf, B, M]``.
    ``wqH [F, C]`` are the conjugate apply weights, ``wq_manifold [F, C]``
    the alignment manifold (the C++ ``ta_``), complex64 on ``Yp``'s device.
    The kernel takes M a multiple of 64 (every size the card pipelines run)
    and raises `RuntimeError` for another."""
    return _zelinski(zelinski_apply, "dsr_zelinski_apply", False, Yp, wqH, wq_manifold,
                     pf_alpha, pf_type, pf_min_frames)


zelinski_apply.launches = 0


def zelinski_apply_steered(
    Yp: torch.Tensor,
    wq_b: torch.Tensor,
    ta_b: torch.Tensor,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """`zelinski_apply` with one steering per utterance: complex64 ``wq_b
    [B, F, C]`` and the alignment manifolds ``ta_b [B, F, C]`` on ``Yp``'s
    device.  On a CPU tensor it runs `zelinski_apply_plain` with those
    weights; given one set broadcast to every utterance it gives
    `zelinski_apply`'s output bit for bit."""
    return _zelinski(zelinski_apply_steered, "dsr_zelinski_apply_steered", True, Yp, wq_b, ta_b,
                     pf_alpha, pf_type, pf_min_frames)


zelinski_apply_steered.launches = 0


def _zelinski(wrapper, entry: str, per_utt: bool, Yp, wqH, wq_manifold, pf_alpha, pf_type,
              pf_min_frames) -> torch.Tensor:
    """K7 on ``Yp [Tf, B, C, M]``: the plain version for a CPU tensor, else
    the C entry point ``entry`` with weights ``[F, C]`` or, with
    ``per_utt``, ``[B, F, C]``."""
    if Yp.device.type == "cpu":
        return zelinski_apply_plain(Yp, wqH, wq_manifold, pf_alpha, pf_type, pf_min_frames)
    if Yp.device.type != "cuda":
        raise ValueError(f"{wrapper.__name__} runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, complex_view, stream_handle

    if Yp.dim() != 4:
        raise ValueError(f"Yp must be [Tf, B, C, M], got {tuple(Yp.shape)}")
    Tf, B, C, M = Yp.shape
    shape = ((B,) if per_utt else ()) + (M // 2 + 1, C)
    wq = complex_view("wqH", wqH, shape)
    ta = complex_view("wq_manifold", wq_manifold, shape)
    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    if Yp.data_ptr() % 16:  # the kernel copies 16-byte pieces of the rows
        Yp = Yp.clone()
    out = torch.empty((Tf, B, M), dtype=torch.float32, device=Yp.device)
    code = getattr(_build.library(), entry)(
        Yp.data_ptr(), wq.data_ptr(), ta.data_ptr(), out.data_ptr(), Tf, B, C, M,
        *zelinski_args(C, pf_alpha, pf_type, pf_min_frames), stream_handle(Yp.device),
    )
    _build.check(code, wrapper.__name__)
    wrapper.launches += 1
    return out


def zelinski_launch_shape(B: int, C: int, M: int) -> dict[str, int]:
    """The launch K7 takes (both entries) for ``B`` utterances of ``C``
    channels and ``M`` lanes on the current card: blocks, threads a block,
    frames of a warp's ring, dynamic shared memory (bytes), registers a
    thread, local memory a thread (bytes; spills), blocks per SM."""
    import ctypes

    from ..kernels import _build

    keys = ("blocks", "threads", "frames", "smem_bytes", "registers", "local_bytes",
            "blocks_per_sm")
    vals = [ctypes.c_int() for _ in keys]
    code = _build.library().dsr_zelinski_apply_shape(B, C, M, *(ctypes.addressof(v) for v in vals))
    _build.check(code, "zelinski_apply shape")
    return {k: v.value for k, v in zip(keys, vals)}


def fw_mono_supported(fb: FilterbankParams, C: int) -> bool:
    """Whether K8 takes this filterbank and channel count: M = 256, 2 <= C
    <= 8 and a synthesis halo of m*R - 1 frames within one frame tile."""
    return fb.M == 256 and 2 <= C <= 8 and fb.m * fb.R - 1 <= FW_MONO_ROWS // C


def analysis_fw_synthesis(
    x: torch.Tensor,
    h,
    g,
    fb: FilterbankParams,
    wqH: torch.Tensor,
    wq_manifold: torch.Tensor,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
    A: torch.Tensor | None = None,
    S: torch.Tensor | None = None,
    hr: torch.Tensor | None = None,
    gf: torch.Tensor | None = None,
) -> torch.Tensor:
    """Raw samples ``x [B, C, T]`` -> enhanced samples ``[B, T_out]``: the
    analysis bank, fixed weights + Zelinski, the synthesis bank, in one
    kernel launch on a CUDA tensor.  ``A``/``S`` may hold the plain
    version's packed DFT matrices (`filterbank.analysis_matrix_tensor(M,
    True, ...)`, `filterbank.synthesis_matrix_tensor`) and ``hr``/``gf`` the
    prototype taps (`filterbank_kernels.prototype_taps`) already on ``x``'s
    device; the kernel does its DFTs as FFTs from
    `filterbank_kernels.fft_twiddles_tensor` and never reads ``A``/``S``."""
    if x.device.type == "cpu":
        Yr = analysis_half_real_tm(x, h, fb, packed=True, A=A)
        Yp = zelinski_apply_plain(Yr, wqH, wq_manifold, pf_alpha, pf_type, pf_min_frames)
        return synthesis_half_real_tm(Yp, g, fb, S=S)
    if x.device.type != "cuda":
        raise ValueError(f"analysis_fw_synthesis runs on cpu or cuda tensors, got {x.device}")
    from ..kernels import _build, check_cuda_tensor, complex_view, stream_handle

    if x.dim() != 3:
        raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
    B, C, T = x.shape
    M, m, R, D = fb.M, fb.m, fb.R, fb.D
    pd = fb.synthesis_delay
    Tf = num_analysis_frames(fb, T)
    T_out = Tf - pd
    if T_out <= 0:
        raise ValueError(f"need more than {pd} subband frames, got {Tf}")
    if hr is None:
        hr = prototype_taps(analysis_taps, h, fb, x.device)
    if gf is None:
        gf = prototype_taps(synthesis_taps, g, fb, x.device)
    tw = fft_twiddles_tensor(M, x.device)
    wq = complex_view("wqH", wqH, (M // 2 + 1, C))
    ta = complex_view("wq_manifold", wq_manifold, (M // 2 + 1, C))
    x = x.contiguous()
    check_cuda_tensor("x", x)
    check_cuda_tensor("hr", hr, (m, M))
    check_cuda_tensor("gf", gf, (m, M))
    out = torch.empty((B, T_out * D), dtype=torch.float32, device=x.device)
    code = _build.library().dsr_fw_mono(
        x.data_ptr(), hr.data_ptr(), tw.data_ptr(), gf.data_ptr(), wq.data_ptr(),
        ta.data_ptr(), out.data_ptr(), B, C, T, Tf, M, m, R, D, fb.laN - (m * R - 1), pd, T_out,
        FW_MONO_ROWS,
        *zelinski_args(C, pf_alpha, pf_type, pf_min_frames), stream_handle(x.device),
    )
    _build.check(code, "fw_mono")
    analysis_fw_synthesis.launches += 1
    return out


analysis_fw_synthesis.launches = 0
