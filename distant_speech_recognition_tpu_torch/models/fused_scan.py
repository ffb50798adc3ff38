"""GSC-RLS + Zelinski scan as a hand-written CUDA kernel, and the K1->K2->K3 chain.

Counterpart of the JAX package's ``models/pallas_fused_scan.py``:

- `gsc_rls_zelinski` replaces ``gsc_rls_zelinski_pallas``.  For a CUDA
  tensor it launches ``csrc/gsc_rls_zelinski.cu`` or raises; for a CPU
  tensor it runs the plain loop `models.adaptive_gsc.gsc_postfilter_fused`,
  the specification the kernel is held to.
- `analysis_gsc_synthesis` has the signature and output of
  ``analysis_gsc_synthesis_pallas`` (raw samples in, samples out), served by
  the three kernels in a row: analysis, scan, synthesis.
"""

from __future__ import annotations

import torch

from ..ops.filterbank import FilterbankParams
from ..ops.filterbank_kernels import analysis_tm_fused, synthesis_tm_fused
from .adaptive_gsc import GSCRLSConfig, gsc_postfilter_fused
from .postfilter import SPECTRAL_FLOOR, PostFilterType

__all__ = ["gsc_rls_zelinski", "analysis_gsc_synthesis"]


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
    if Yp.device.type == "cpu":
        return gsc_postfilter_fused(
            Yp, None, wqH, BmH, wq_manifold, "rls", cfg, pf_alpha, pf_type, pf_min_frames, True
        )
    if Yp.device.type != "cuda":
        raise ValueError(f"gsc_rls_zelinski runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    if Yp.dim() != 4:
        raise ValueError(f"Yp must be [Tf, B, C, M], got {tuple(Yp.shape)}")
    Tf, B, C, M = Yp.shape
    F = M // 2 + 1
    Bc = BmH.shape[1]
    planes = {}
    for name, w, shape in (
        ("wqH", wqH, (F, C)),
        ("BmH", BmH, (F, Bc, C)),
        ("wq_manifold", wq_manifold, (F, C)),
    ):
        if w.dtype != torch.complex64 or tuple(w.shape) != shape:
            raise ValueError(f"{name} must be complex64 {shape}, got {w.dtype} {tuple(w.shape)}")
        planes[name] = torch.view_as_real(w.resolve_conj().contiguous())
        check_cuda_tensor(name, planes[name])
    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    out = torch.empty((Tf, B, M), dtype=torch.float32, device=Yp.device)
    c = cfg
    lib = _build.library()
    code = lib.dsr_gsc_rls_zelinski(
        Yp.data_ptr(), planes["wqH"].data_ptr(), planes["BmH"].data_ptr(),
        planes["wq_manifold"].data_ptr(), out.data_ptr(), Tf, B, C, Bc, M,
        c.beta, 1.0 - c.beta, c.gamma, c.mu, c.init_diagonal_load,
        1.0 / c.init_diagonal_load, c.regularization_param, c.sil_thresh,
        c.constraint_option, c.alpha2, c.max_wa_l2norm, c.min_frames,
        pf_alpha, 1.0 - pf_alpha, 2.0 / (C - 1.0), SPECTRAL_FLOOR,
        int(bool(pf_type & PostFilterType.ZELINSKI1_REAL)), pf_min_frames,
        stream_handle(Yp.device),
    )
    _build.check(code, "gsc_rls_zelinski")
    gsc_rls_zelinski.launches += 1
    return out


gsc_rls_zelinski.launches = 0


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
) -> torch.Tensor:
    """Raw samples ``x [B, C, T]`` -> enhanced samples ``[B, T_out]``:
    analysis, GSC-RLS + Zelinski, synthesis (``A``/``S``: optional DFT
    matrices already on ``x``'s device)."""
    Yr = analysis_tm_fused(x, h, fb, A=A)  # [Tf, B, C, M]
    Yp = gsc_rls_zelinski(Yr, wqH, BmH, wq_manifold, cfg, pf_alpha, pf_type, pf_min_frames)
    return synthesis_tm_fused(Yp, g, fb, S=S)
