"""End-to-end enhancement pipeline: analysis -> GSC-RLS + Zelinski -> synthesis.

The flagship chain of the reference's canonical pull graph
(unit_test/test_online_beamforming.py:82-159: SampleFeature ->
OverSampledDFTAnalysisBank per channel -> beamformer -> ZelinskiPostFilter
-> OverSampledDFTSynthesisBank) over an utterance batch ``x [B, C, T]``.

`build_pipeline` computes the weights once on the host, as the reference's
out-of-loop ``wrapper_weights_calculator`` does, and returns an `Enhancer`
module whose buffers live on the requested device.  On a CUDA device its
forward pass runs the three CUDA kernels; on the CPU, their plain versions.
Only ``beamformer="gsc_rls"`` with ``postfilter="zelinski"`` is ported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.filterbank import FilterbankParams, analysis_matrix_tensor, synthesis_matrix_tensor
from .adaptive_gsc import GSCRLSConfig, gsc_weights
from .beamforming import array_manifold
from .fused_scan import analysis_gsc_synthesis
from .postfilter import PostFilterType

__all__ = ["PipelineConfig", "Enhancer", "build_pipeline", "from_jax_params"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration mirroring the reference's JSON config surface
    (unit_test/confs/*.json: beamformer{type}, postfilter{type,subtype,alpha}).

    The ported chain has one look direction constraint, so unlike the JAX
    package's config this one has no ``Nc``: it is always 1."""

    fb: FilterbankParams = FilterbankParams()
    samplerate: float = 16000.0
    beamformer: str = "ds"  # only "gsc_rls" is ported
    postfilter: str = "none"  # only "zelinski" is ported
    pf_alpha: float = 0.6
    pf_type: int = PostFilterType.ZELINSKI1_REAL
    pf_min_frames: int = 0
    rls: GSCRLSConfig = GSCRLSConfig()


def _check_supported(cfg: PipelineConfig) -> None:
    if cfg.beamformer != "gsc_rls" or cfg.postfilter != "zelinski":
        raise NotImplementedError(
            f"beamformer={cfg.beamformer!r} postfilter={cfg.postfilter!r} is not ported; "
            "only beamformer='gsc_rls' with postfilter='zelinski'"
        )


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch sees none")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the pipeline runs on cpu or cuda, got {dev}")
    return dev


class Enhancer(nn.Module):
    """``forward(x [B, C, T]) -> [B, T_out]`` for a fixed array and steering.

    Buffers: prototypes ``h``, ``g``; packed DFT matrices ``A`` (analysis)
    and ``S`` (synthesis, segment reversal baked in); complex64 weights
    ``wqH [F, C]``, ``BmH [F, C-1, C]`` and the postfilter alignment
    manifold ``wq_manifold [F, C]``.
    """

    def __init__(self, cfg: PipelineConfig, h, g, wqH, BmH, wq_manifold, device="cpu"):
        super().__init__()
        _check_supported(cfg)
        dev = _device(device)
        fb = cfg.fb
        self.cfg = cfg

        def real(a):
            return torch.tensor(np.asarray(a, np.float32), device=dev)

        def cplx(a):
            if isinstance(a, torch.Tensor):
                return a.resolve_conj().to(device=dev, dtype=torch.complex64).contiguous()
            return torch.tensor(np.asarray(a, np.complex64), device=dev)

        self.register_buffer("h", real(h))
        self.register_buffer("g", real(g))
        self.register_buffer("A", analysis_matrix_tensor(fb.M, True, dev))
        self.register_buffer("S", synthesis_matrix_tensor(fb.M, fb.R, dev))
        self.register_buffer("wqH", cplx(wqH))
        self.register_buffer("BmH", cplx(BmH))
        self.register_buffer("wq_manifold", cplx(wq_manifold))
        if self.h.shape != (fb.N,) or self.g.shape != (fb.N,):
            raise ValueError(f"prototypes must have length N=M*m={fb.N}")
        F, C = self.wqH.shape
        if self.BmH.shape != (F, C - 1, C):
            raise NotImplementedError(
                f"BmH {tuple(self.BmH.shape)}: only one constraint (Nc=1, BmH [F, C-1, C]) is ported"
            )

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
        if x.device != self.h.device:
            raise ValueError(f"x is on {x.device}, the pipeline on {self.h.device}")
        if x.shape[1] != self.wqH.shape[1]:
            raise ValueError(f"x has {x.shape[1]} channels, the weights {self.wqH.shape[1]}")
        c = self.cfg
        return analysis_gsc_synthesis(
            x.to(torch.float32), self.h, self.g, c.fb, self.wqH, self.BmH, self.wq_manifold,
            c.rls, c.pf_alpha, c.pf_type, c.pf_min_frames, A=self.A, S=self.S,
        )


def build_pipeline(cfg: PipelineConfig, mpos, delays, h, g, device="cpu") -> Enhancer:
    """Build the enhancer for an array steered by ``delays`` (seconds, one
    per channel).  ``mpos`` (mic positions) is accepted for signature parity
    with the JAX package; the GSC + Zelinski chain reads only ``delays``.
    ``device`` is where the buffers live and the forward pass runs."""
    _check_supported(cfg)
    dev = _device(device)
    delays = np.asarray(delays)
    M, fs = cfg.fb.M, cfg.samplerate
    wqH, BmH = gsc_weights(M, fs, delays)
    # Postfilter alignment = the C++ ta_ (e^{-j2 pi f tau}/C, beamformer.cc:960-965)
    wq_manifold = array_manifold(M, fs, delays)
    return Enhancer(cfg, h, g, wqH, BmH, wq_manifold, device=dev)


def from_jax_params(params: dict, cfg: PipelineConfig, device="cpu") -> Enhancer:
    """The same `Enhancer` from parameters computed by the JAX package, given
    as numpy arrays: ``h``, ``g``, ``wqH``, ``BmH``, ``wq_manifold``."""
    missing = {"h", "g", "wqH", "BmH", "wq_manifold"} - set(params)
    if missing:
        raise KeyError(f"missing parameters: {sorted(missing)}")
    return Enhancer(
        cfg, params["h"], params["g"], params["wqH"], params["BmH"], params["wq_manifold"],
        device=device,
    )
