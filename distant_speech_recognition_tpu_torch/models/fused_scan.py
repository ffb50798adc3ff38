"""GSC-RLS + Zelinski scans as hand-written CUDA kernels, and the K1->K2->K3 chain.

Counterpart of the JAX package's ``models/pallas_fused_scan.py``:

- `gsc_rls_zelinski` (K2) replaces ``gsc_rls_zelinski_pallas``: one set of
  weights for every utterance.
- `gsc_rls_zelinski_steered` (K6) replaces
  ``gsc_rls_zelinski_steered_pallas``: one set of weights per utterance (the
  SRP-PHAT-steered pipeline).  Both launch ``csrc/gsc_rls_zelinski.cu``
  for a CUDA tensor or raise; for a CPU tensor they run the plain loop
  `models.adaptive_gsc.gsc_postfilter_fused`, the specification the kernel
  is held to.
- `analysis_gsc_synthesis` has the signature and output of
  ``analysis_gsc_synthesis_pallas`` (raw samples in, samples out), served by
  the three kernels in a row: analysis, scan, synthesis.
"""

from __future__ import annotations

import torch

from ..ops.filterbank import FilterbankParams
from ..ops.filterbank_kernels import analysis_tm_fused, synthesis_tm_fused
from .adaptive_gsc import GSCRLSConfig, gsc_postfilter_fused
from .postfilter import PostFilterType, zelinski_args

__all__ = ["gsc_rls_zelinski", "gsc_rls_zelinski_steered", "analysis_gsc_synthesis"]


def _scan(wrapper, entry: str, Yp, wqH, BmH, wq_manifold, cfg: GSCRLSConfig, pf_alpha,
          pf_type, pf_min_frames, lead: tuple) -> torch.Tensor:
    """Run the GSC-RLS + Zelinski scan on ``Yp [Tf, B, C, M]``: the plain
    loop for a CPU tensor, else the kernel's C entry point ``entry`` with
    weights ``lead + [F, ...]`` (``lead`` is ``()`` for K2, ``(B,)`` for K6)."""
    if Yp.device.type == "cpu":
        return gsc_postfilter_fused(
            Yp, None, wqH, BmH, wq_manifold, "rls", cfg, pf_alpha, pf_type, pf_min_frames, True
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
    out = torch.empty((Tf, B, M), dtype=torch.float32, device=Yp.device)
    c = cfg
    code = getattr(_build.library(), entry)(
        Yp.data_ptr(), wq.data_ptr(), bm.data_ptr(), ta.data_ptr(), out.data_ptr(),
        Tf, B, C, Bc, M,
        c.beta, 1.0 - c.beta, c.gamma, c.mu, c.init_diagonal_load,
        1.0 / c.init_diagonal_load, c.regularization_param, c.sil_thresh,
        c.constraint_option, c.alpha2, c.max_wa_l2norm, c.min_frames,
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
    return _scan(gsc_rls_zelinski, "dsr_gsc_rls_zelinski", Yp, wqH, BmH, wq_manifold, cfg,
                 pf_alpha, pf_type, pf_min_frames, ())


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
    return _scan(gsc_rls_zelinski_steered, "dsr_gsc_rls_zelinski_steered", Yp, wq_b, bm_b, ta_b,
                 cfg, pf_alpha, pf_type, pf_min_frames, (Yp.shape[1],))


gsc_rls_zelinski_steered.launches = 0


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
