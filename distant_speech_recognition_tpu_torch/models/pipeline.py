"""End-to-end enhancement pipeline: analysis -> [AEC] -> [WPE] -> GSC-RLS +
Zelinski -> synthesis.

The flagship chain of the reference's canonical pull graph
(unit_test/test_online_beamforming.py:82-159: SampleFeature ->
OverSampledDFTAnalysisBank per channel -> beamformer -> ZelinskiPostFilter
-> OverSampledDFTSynthesisBank) over an utterance batch ``x [B, C, T]``,
optionally with an echo canceller fed by the far-end playback ``play [B, T]``
and multichannel WPE dereverberation between analysis and the beamformer
(BASELINE config 4; the reference chains the same feature nodes per
channel, aec.cc:41-81 -> dereverberation.cc:214-275).

`build_pipeline` computes the weights once on the host, as the reference's
out-of-loop ``wrapper_weights_calculator`` does, and returns an `Enhancer`
module whose buffers live on the requested device, the card unless the
caller asks for the CPU.  On a CUDA device its forward pass runs the CUDA
kernels; on the CPU, their plain versions.  Only ``beamformer="gsc_rls"``
with ``postfilter="zelinski"`` is ported, with ``aec`` in none | nlms |
kalman and WPE on or off.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.aec_kernels import AEC_KINDS, aec_scan
from ..ops.filterbank import FilterbankParams, analysis_matrix_tensor, synthesis_matrix_tensor
from ..ops.filterbank_kernels import analysis_tm_fused, synthesis_tm_fused
from ..ops.wpe_kernels import WPE_MAX_CHANNELS, WPE_MAX_CP, WPE_MAX_LOWER, wpe_supported
from .adaptive_gsc import GSCRLSConfig, gsc_weights
from .beamforming import array_manifold
from .dereverberation import wpe_multichannel_packed_tm
from .fused_scan import gsc_rls_zelinski
from .postfilter import PostFilterType

__all__ = ["PipelineConfig", "Enhancer", "build_pipeline", "from_jax_params"]


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration mirroring the reference's JSON config surface
    (unit_test/confs/*.json: beamformer{type}, postfilter{type,subtype,alpha}).

    Unlike the JAX package's config this one has no ``Nc`` (the ported chain
    has one look direction constraint, always 1), no ``aec_taps`` (the block
    Kalman canceller is not ported), no ``wpe_batch_chunk`` (a memory knob of
    the JAX package's per-utterance vmap path, which the port does not have)
    and no ``wpe_bf16_stats`` (the JAX package's bf16 WPE path fails its own
    accuracy contract; the port runs WPE in float32 only)."""

    fb: FilterbankParams = FilterbankParams()
    samplerate: float = 16000.0
    beamformer: str = "ds"  # only "gsc_rls" is ported
    postfilter: str = "none"  # only "zelinski" is ported
    pf_alpha: float = 0.6
    pf_type: int = PostFilterType.ZELINSKI1_REAL
    pf_min_frames: int = 0
    rls: GSCRLSConfig = GSCRLSConfig()
    # full-chain extensions (BASELINE config 4: AEC -> WPE -> GSC -> postfilter)
    aec: str = "none"  # none | nlms | kalman
    aec_delta: float = 100.0  # nlms delta | kalman beta
    aec_epsilon: float = 1.0e-4  # nlms epsilon | kalman sigma2
    aec_threshold: float = 100.0
    wpe: bool = False
    wpe_lower: int = 2
    wpe_upper: int = 6
    wpe_iterations: int = 2
    wpe_band_width: float = 0.0  # >0: reference band limit (dereverberation.h:38)


def _check_supported(cfg: PipelineConfig, n_chan: int | None = None) -> None:
    """Raise `NotImplementedError` for what the port does not run, on every
    device; ``n_chan``, where known, is checked against the WPE kernels'
    limits."""
    if cfg.beamformer != "gsc_rls" or cfg.postfilter != "zelinski":
        raise NotImplementedError(
            f"beamformer={cfg.beamformer!r} postfilter={cfg.postfilter!r} is not ported; "
            "only beamformer='gsc_rls' with postfilter='zelinski'"
        )
    if cfg.aec != "none" and cfg.aec not in AEC_KINDS:
        raise NotImplementedError(f"aec={cfg.aec!r} is not ported; only none | nlms | kalman")
    if not cfg.wpe:
        return
    P = cfg.wpe_upper - cfg.wpe_lower + 1
    if cfg.wpe_lower < 0 or P < 1:
        raise ValueError(f"need 0 <= wpe_lower <= wpe_upper, got {cfg.wpe_lower}, {cfg.wpe_upper}")
    if n_chan is not None and not wpe_supported(n_chan, P, cfg.wpe_lower):
        raise NotImplementedError(
            f"WPE with C={n_chan}, P={P}, wpe_lower={cfg.wpe_lower} is not ported: the kernels "
            f"take C <= {WPE_MAX_CHANNELS}, C*P <= {WPE_MAX_CP}, wpe_lower <= {WPE_MAX_LOWER}"
        )


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was requested but torch sees none")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the pipeline runs on cpu or cuda, got {dev}")
    return dev


class Enhancer(nn.Module):
    """``forward(x [B, C, T], play [B, T] | None) -> [B, T_out]`` for a fixed
    array and steering; ``play``, the far-end playback, is required exactly
    when ``cfg.aec`` is not ``"none"``.

    Buffers: prototypes ``h``, ``g``; packed DFT matrices ``A`` (analysis)
    and ``S`` (synthesis, segment reversal baked in); complex64 weights
    ``wqH [F, C]``, ``BmH [F, C-1, C]`` and the postfilter alignment
    manifold ``wq_manifold [F, C]``.
    """

    def __init__(self, cfg: PipelineConfig, h, g, wqH, BmH, wq_manifold, device="cuda"):
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
        _check_supported(cfg, C)

    def forward(self, x: torch.Tensor, play: torch.Tensor | None = None) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
        if x.device != self.h.device:
            raise ValueError(f"x is on {x.device}, the pipeline on {self.h.device}")
        if x.shape[1] != self.wqH.shape[1]:
            raise ValueError(f"x has {x.shape[1]} channels, the weights {self.wqH.shape[1]}")
        c = self.cfg
        if (play is None) != (c.aec == "none"):
            raise ValueError(f"aec={c.aec!r}: play is required exactly when aec is not 'none'")
        B, _, T = x.shape
        if play is not None and (tuple(play.shape) != (B, T) or play.device != x.device):
            raise ValueError(f"play must be [B, T] = {(B, T)} on {x.device}, got "
                             f"{tuple(play.shape)} on {play.device}")
        Yr = analysis_tm_fused(x.to(torch.float32), self.h, c.fb, A=self.A)  # [Tf, B, C, M]
        if play is not None:
            Vp = analysis_tm_fused(play.to(torch.float32)[:, None, :], self.h, c.fb, A=self.A)
            Yr = aec_scan(Yr, Vp, c.aec, c.aec_delta, c.aec_epsilon, c.aec_threshold)
        if c.wpe:
            Yr = wpe_multichannel_packed_tm(
                Yr, c.wpe_lower, c.wpe_upper, c.wpe_iterations,
                band_width=c.wpe_band_width, samplerate=c.samplerate,
            )
        Yp = gsc_rls_zelinski(Yr, self.wqH, self.BmH, self.wq_manifold, c.rls, c.pf_alpha,
                              c.pf_type, c.pf_min_frames)
        return synthesis_tm_fused(Yp, self.g, c.fb, S=self.S)


def build_pipeline(cfg: PipelineConfig, mpos, delays, h, g, device="cuda") -> Enhancer:
    """Build the enhancer for an array steered by ``delays`` (seconds, one
    per channel).  ``mpos`` (mic positions) is accepted for signature parity
    with the JAX package; the GSC + Zelinski chain reads only ``delays``.
    ``device`` is where the buffers live and the forward pass runs; without
    a card the default raises `RuntimeError`, so CPU callers pass ``"cpu"``."""
    delays = np.asarray(delays)
    _check_supported(cfg, delays.shape[0])
    dev = _device(device)
    M, fs = cfg.fb.M, cfg.samplerate
    wqH, BmH = gsc_weights(M, fs, delays)
    # Postfilter alignment = the C++ ta_ (e^{-j2 pi f tau}/C, beamformer.cc:960-965)
    wq_manifold = array_manifold(M, fs, delays)
    return Enhancer(cfg, h, g, wqH, BmH, wq_manifold, device=dev)


def from_jax_params(params: dict, cfg: PipelineConfig, device="cuda") -> Enhancer:
    """The same `Enhancer` from parameters computed by the JAX package, given
    as numpy arrays: ``h``, ``g``, ``wqH``, ``BmH``, ``wq_manifold``."""
    missing = {"h", "g", "wqH", "BmH", "wq_manifold"} - set(params)
    if missing:
        raise KeyError(f"missing parameters: {sorted(missing)}")
    return Enhancer(
        cfg, params["h"], params["g"], params["wqH"], params["BmH"], params["wq_manifold"],
        device=device,
    )
