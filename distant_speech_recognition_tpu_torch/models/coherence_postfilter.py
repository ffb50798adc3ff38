"""The McCowan, Lefkimmiatis and APAB postfilters as one hand-written CUDA kernel.

The JAX package runs these postfilters in XLA (``models/postfilter.py``
``mccowan_postfilter``, ``lefkimmiatis_postfilter``, ``apab_postfilter``),
with no TPU kernel; the port runs them on the card through one kernel,
``csrc/coherence_postfilter.cu``, after any non-steered beamformer:

- behind an adaptive GSC it is given the scan's packed output ``Yp`` (the
  scan run without its own Zelinski gain, ``pf_min_frames=NO_POSTFILTER``);
- behind fixed weights it forms ``Y = wqH X`` itself, as K7 does.

For a CUDA tensor `coherence_postfilter` launches the kernel or raises; for
a CPU tensor it runs `coherence_postfilter_plain`, the specification the
kernel is held to: `postfilter.coherence_apply` on the unpacked frames.
"""

from __future__ import annotations

import torch

from ..ops.filterbank import pack_half, unpack_half
from .beamforming import apply_weights
from .postfilter import COHERENCE_POSTFILTERS, SPECTRAL_FLOOR, PostFilterType, coherence_apply

__all__ = ["coherence_postfilter_plain", "coherence_postfilter"]


def _kernel_kind(kind: str, pf_type: int) -> int:
    """The kernel's kind: McCowan REAL / ABS 0 / 1, Lefkimmiatis 2 / 3, APAB 4."""
    if kind not in COHERENCE_POSTFILTERS:
        raise ValueError(f"unknown coherence postfilter {kind!r}; one of {COHERENCE_POSTFILTERS}")
    if kind == "apab":
        return 4
    real = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
    return 2 * COHERENCE_POSTFILTERS.index(kind) + (0 if real else 1)


def coherence_postfilter_plain(
    Yr: torch.Tensor,
    Yp: torch.Tensor | None,
    wqH: torch.Tensor,
    wq_manifold: torch.Tensor,
    kind: str,
    consts: torch.Tensor | None,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """The plain version of the kernel: complex snapshots from the packed
    lanes, the beamformer output ``Yp`` unpacked (or `beamforming.apply_weights`
    of ``wqH`` where it is None), `postfilter.coherence_apply`, packed again
    (the DC and Nyquist bins lose their Im part, as synthesis does)."""
    X = unpack_half(Yr).movedim(-2, -1)  # [Tf, B, F, C]
    Y = apply_weights(wqH, X) if Yp is None else unpack_half(Yp)
    return pack_half(coherence_apply(kind, X, Y, wq_manifold, consts, pf_alpha, pf_type,
                                     pf_min_frames))


def coherence_postfilter(
    Yr: torch.Tensor,
    Yp: torch.Tensor | None,
    wqH: torch.Tensor,
    wq_manifold: torch.Tensor,
    kind: str,
    consts: torch.Tensor | None,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
) -> torch.Tensor:
    """The McCowan, Lefkimmiatis or APAB postfilter (``kind``) over the
    packed time-major spectrum ``Yr [Tf, B, C, M]`` -> packed ``[Tf, B,
    M]``.  ``Yp [Tf, B, M]`` is the beamformer's packed output, or None for
    fixed weights, whose output ``wqH [F, C]`` forms (``wqH`` is read only
    then); ``wq_manifold [F, C]`` is the alignment manifold (the C++
    ``ta_``), complex64 on ``Yr``'s device; ``consts [K, F]`` float32 are
    `postfilter.coherence_constants` of ``kind`` (None for APAB)."""
    if Yr.device.type == "cpu":
        return coherence_postfilter_plain(Yr, Yp, wqH, wq_manifold, kind, consts, pf_alpha,
                                          pf_type, pf_min_frames)
    if Yr.device.type != "cuda":
        raise ValueError(f"coherence_postfilter runs on cpu or cuda tensors, got {Yr.device}")
    from ..kernels import _build, check_cuda_tensor, complex_view, stream_handle

    if Yr.dim() != 4:
        raise ValueError(f"Yr must be [Tf, B, C, M], got {tuple(Yr.shape)}")
    Tf, B, C, M = Yr.shape
    F = M // 2 + 1
    code = _kernel_kind(kind, pf_type)
    Yr = Yr.contiguous()
    check_cuda_tensor("Yr", Yr)
    ta = complex_view("wq_manifold", wq_manifold, (F, C))
    wq = None
    if Yp is None:
        wq = complex_view("wqH", wqH, (F, C))
    else:
        Yp = Yp.contiguous()
        check_cuda_tensor("Yp", Yp, (Tf, B, M))
    if kind == "apab":
        consts = None
    elif consts is None:
        raise ValueError(f"postfilter {kind!r} needs the constants of its coherence")
    else:
        NP = C * (C - 1) // 2
        check_cuda_tensor("consts", consts, (2 * NP if kind == "mccowan" else 3 * NP + 1, F))
    out = torch.empty((Tf, B, M), dtype=torch.float32, device=Yr.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    status = _build.library().dsr_coherence_postfilter(
        Yr.data_ptr(), ptr(Yp), ptr(wq), ta.data_ptr(), ptr(consts), out.data_ptr(), Tf, B, C,
        M, code, pf_alpha, 1.0 - pf_alpha, 2.0 / (C * (C - 1.0)), SPECTRAL_FLOOR, pf_min_frames,
        stream_handle(Yr.device),
    )
    _build.check(status, "coherence_postfilter")
    coherence_postfilter.launches += 1
    return out


coherence_postfilter.launches = 0
