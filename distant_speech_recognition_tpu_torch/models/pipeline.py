"""End-to-end enhancement pipelines: analysis -> [AEC] -> [WPE] ->
beamformer (adaptive GSC, RLS or LMS, or fixed weights) -> [postfilter] ->
synthesis.

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
kernels; on the CPU, their plain versions.  Ported: ``beamformer`` in
gsc_rls | gsc_lms (BASELINE config 3) | ds | sd_mvdr | lcmv (BASELINE configs
1-2), ``postfilter`` in none | zelinski | mccowan | lefkimmiatis | apab,
``aec`` in none | nlms | kalman | block_kalman (one tap) and WPE on or off
(C*P <= 40: BASELINE config 4 at 8 channels), in every combination.  The
flagship chain (GSC-RLS + Zelinski without AEC and WPE) and the
fixed-weight chains with Zelinski and without AEC and WPE are each one
kernel (`fused_scan.analysis_gsc_synthesis`,
`fixed_weight.analysis_fw_synthesis`) where its frame tiles take the shape
(`fused_scan.gsc_mono_supported`, `fixed_weight.fw_mono_supported`), else
the analysis, [echo canceller, WPE,] beamformer and synthesis kernels in a
row: the adaptive beamformers through their scan kernels
(`fused_scan.gsc_rls_zelinski`, `gsc_lms_zelinski`; with any postfilter
but Zelinski the scan's gain is never applied), the fixed weights through
K7 with Zelinski or a plain product ``wqH X`` without a postfilter (XLA's
`apply_weights` in the JAX package); the McCowan, Lefkimmiatis and APAB
postfilters through `coherence_postfilter.coherence_postfilter`, given the
scan's output or, behind fixed weights, forming ``wqH X`` itself.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from ..ops.aec_kernels import AEC_KINDS, aec_scan
from ..ops.dft import FFT_SIZES
from ..ops.filterbank import (
    FilterbankParams,
    analysis_matrix_tensor,
    analysis_taps,
    pack_half,
    synthesis_matrix_tensor,
    synthesis_taps,
    unpack_half,
)
from ..ops.filterbank_kernels import (
    analysis_tm_fused,
    prototype_taps,
    synthesis_tile_rows,
    synthesis_tm_fused,
)
from ..ops.wpe_kernels import WPE_MAX_CHANNELS, WPE_MAX_CP, WPE_MAX_LOWER, wpe_supported
from . import beamforming as bf
from .adaptive_gsc import GSCLMSConfig, GSCRLSConfig, gsc_weights
from .dereverberation import wpe_multichannel_packed_tm
from .coherence_postfilter import coherence_postfilter
from .fixed_weight import analysis_fw_synthesis, fw_mono_supported, zelinski_apply
from .fused_scan import (
    NO_POSTFILTER,
    analysis_gsc_synthesis,
    gsc_lms_zelinski,
    gsc_mono_supported,
    gsc_rls_zelinski,
)
from .postfilter import COHERENCE_POSTFILTERS, PostFilterType, coherence_constants

__all__ = ["PipelineConfig", "Enhancer", "build_pipeline", "from_jax_params", "enhance",
           "FIXED_WEIGHT", "POSTFILTERS", "check_card_shapes"]

# beamformers whose weights are fixed at build time (BASELINE configs 1-2)
FIXED_WEIGHT = ("ds", "sd_mvdr", "lcmv")
# adaptive GSCs: quiescent weights and a blocking matrix at build time, the
# active weights adapted per frame (BASELINE configs 3-5)
ADAPTIVE = ("gsc_lms", "gsc_rls")
POSTFILTERS = ("none", "zelinski") + COHERENCE_POSTFILTERS
# the postfilters that read the noise coherence Gamma
GAMMA_POSTFILTERS = ("mccowan", "lefkimmiatis")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Static configuration mirroring the reference's JSON config surface
    (unit_test/confs/*.json: beamformer{type}, postfilter{type,subtype,alpha}).

    Unlike the JAX package's config this one has no ``Nc`` (the ported chain
    has one look direction constraint, always 1), no ``wpe_batch_chunk`` (a
    memory knob of the JAX package's per-utterance vmap path, which the port
    does not have) and no ``wpe_bf16_stats`` (the JAX package's bf16 WPE path
    fails its own accuracy contract; the port runs WPE in float32 only).
    ``aec_taps`` is JAX's field; the port runs the block Kalman canceller at
    one tap only, as JAX's time-major chain does."""

    fb: FilterbankParams = FilterbankParams()
    samplerate: float = 16000.0
    beamformer: str = "ds"  # ds | sd_mvdr | lcmv | gsc_lms | gsc_rls
    postfilter: str = "none"  # none | zelinski | mccowan | lefkimmiatis | apab
    pf_alpha: float = 0.6
    pf_type: int = PostFilterType.ZELINSKI1_REAL
    pf_min_frames: int = 0
    sd_mu: float = 0.01  # sd_mvdr's absolute diagonal loading
    lms: GSCLMSConfig = GSCLMSConfig()
    rls: GSCRLSConfig = GSCRLSConfig()
    # full-chain extensions (BASELINE config 4: AEC -> WPE -> GSC -> postfilter)
    aec: str = "none"  # none | nlms | kalman | block_kalman
    aec_delta: float = 100.0  # nlms delta | kalman beta | block_kalman beta
    aec_epsilon: float = 1.0e-4  # nlms epsilon | (block_)kalman sigma2
    aec_threshold: float = 100.0
    aec_taps: int = 1  # block_kalman sampleN; only 1 is ported (JAX's time-major chain)
    wpe: bool = False
    wpe_lower: int = 2
    wpe_upper: int = 6
    wpe_iterations: int = 2
    wpe_band_width: float = 0.0  # >0: reference band limit (dereverberation.h:38)


def _check_supported(cfg: PipelineConfig, n_chan: int | None = None) -> None:
    """Raise `NotImplementedError` for what the port does not run, on every
    device: a beamformer or postfilter it does not have, the block Kalman
    canceller with more than one tap (the JAX package leaves it off its
    time-major chain), and, with ``n_chan`` where known, a WPE shape past
    the kernels' limits (C <= 8, C*P <= 40, wpe_lower <= 32)."""
    if cfg.beamformer not in FIXED_WEIGHT + ADAPTIVE or cfg.postfilter not in POSTFILTERS:
        raise NotImplementedError(
            f"beamformer={cfg.beamformer!r} postfilter={cfg.postfilter!r} is not ported; "
            f"only beamformer in {FIXED_WEIGHT + ADAPTIVE} with postfilter in {POSTFILTERS}"
        )
    if cfg.aec != "none" and cfg.aec not in AEC_KINDS:
        raise NotImplementedError(f"aec={cfg.aec!r} is not ported; only none | "
                                  + " | ".join(AEC_KINDS))
    if cfg.aec == "block_kalman" and cfg.aec_taps != 1:
        raise NotImplementedError(f"aec='block_kalman' with aec_taps={cfg.aec_taps} is not "
                                  "ported; only one tap")
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


# the shapes the card's kernels take: the filterbank kernels do their DFTs
# with the shared-memory FFT of csrc/dsr_fft.h, built for M in FFT_SIZES
# (64, 128, ..., 2048); the synthesis kernel (K3) holds the m*R - 1 halo rows
# in its tile of `synthesis_tile_rows(M)` rows (256, 128, 64, 40, 48, 24); the
# beamformer kernels are built for 2 <= C <= 8
CARD_M = FFT_SIZES
CARD_CHANNELS = (2, 8)


def check_card_shapes(fb: FilterbankParams, n_chan: int, device_type: str) -> None:
    """Raise `NotImplementedError` when a pipeline built for ``device_type``
    ``"cuda"`` has a filterbank or channel count its kernels cannot take;
    on the CPU every shape runs (the plain versions).  A pure function of the
    configuration, called by the constructors before any launch."""
    if device_type != "cuda":
        return
    lo, hi = CARD_CHANNELS
    if (fb.M not in CARD_M or fb.m * fb.R > synthesis_tile_rows(fb.M)
            or not lo <= n_chan <= hi):
        rows = ", ".join(f"{synthesis_tile_rows(M)} at M={M}" for M in CARD_M)
        raise NotImplementedError(
            f"M={fb.M}, m*R={fb.m * fb.R}, C={n_chan} is not ported to the card: its kernels take "
            f"M in {CARD_M}, m*R up to K3's tile rows ({rows}) and {lo} <= C <= {hi}; run on "
            "the CPU"
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

    Buffers: prototypes ``h``, ``g`` and the filterbank kernels' taps made
    from them, ``hr``, ``gf`` (`filterbank_kernels.prototype_taps`); packed
    DFT matrices ``A`` (analysis) and ``S`` (synthesis, segment reversal
    baked in); complex64 weights
    ``wqH [F, C]``, for the adaptive GSCs ``BmH [F, C-1, C]`` (None for the
    fixed-weight beamformers, which have no blocking matrix), and the
    postfilter alignment manifold ``wq_manifold [F, C]``; for the McCowan
    and Lefkimmiatis postfilters (and only for them) the real noise
    coherence ``Gamma [F, C, C]`` (complex64) and the per-bin constants the
    postfilter reads it through, ``pf_consts [K, F]``
    (`postfilter.coherence_constants`).
    """

    def __init__(self, cfg: PipelineConfig, h, g, wqH, BmH, wq_manifold, Gamma=None,
                 device="cuda"):
        super().__init__()
        _check_supported(cfg)
        check_card_shapes(cfg.fb, wqH.shape[-1], torch.device(device).type)
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
        self.register_buffer("wq_manifold", cplx(wq_manifold))
        if self.h.shape != (fb.N,) or self.g.shape != (fb.N,):
            raise ValueError(f"prototypes must have length N=M*m={fb.N}")
        # the filterbank kernels' taps, computed once
        self.register_buffer("hr", prototype_taps(analysis_taps, self.h, fb, dev))
        self.register_buffer("gf", prototype_taps(synthesis_taps, self.g, fb, dev))
        F, C = self.wqH.shape
        if self.wq_manifold.shape != (F, C):
            raise ValueError(f"wq_manifold must be {(F, C)}, got {tuple(self.wq_manifold.shape)}")
        if cfg.beamformer in FIXED_WEIGHT:
            if BmH is not None:
                raise ValueError(f"beamformer={cfg.beamformer!r} takes no blocking matrix")
            self.register_buffer("BmH", None)
        elif BmH is None:
            raise ValueError(f"beamformer={cfg.beamformer!r} needs the blocking matrix BmH")
        else:
            self.register_buffer("BmH", cplx(BmH))
        if self.BmH is not None and self.BmH.shape != (F, C - 1, C):
            raise NotImplementedError(
                f"BmH {tuple(self.BmH.shape)}: only one constraint (Nc=1, BmH [F, C-1, C]) is ported"
            )
        if (Gamma is None) == (cfg.postfilter in GAMMA_POSTFILTERS):
            raise ValueError(f"postfilter={cfg.postfilter!r}: the noise coherence Gamma is "
                             f"required exactly for {GAMMA_POSTFILTERS}")
        self.register_buffer("Gamma", None if Gamma is None else cplx(Gamma))
        if self.Gamma is not None and self.Gamma.shape != (F, C, C):
            raise ValueError(f"Gamma must be {(F, C, C)}, got {tuple(self.Gamma.shape)}")
        consts = None
        if self.Gamma is not None:  # computed once, on the host
            consts = coherence_constants(cfg.postfilter, self.Gamma.cpu(),
                                         self.wq_manifold.cpu(), cfg.pf_type).to(dev)
        self.register_buffer("pf_consts", consts)
        _check_supported(cfg, C)

    def _subbands(self, x: torch.Tensor, play: torch.Tensor | None) -> torch.Tensor:
        """The packed time-major snapshots ``[Tf, B, C, M]`` the beamformer
        reads: the analysis bank, then the echo canceller where there is a far
        end and WPE where configured."""
        c = self.cfg
        taps = dict(A=self.A, hr=self.hr)
        Yr = analysis_tm_fused(x, self.h, c.fb, **taps)
        if play is not None:
            Vp = analysis_tm_fused(play.to(torch.float32)[:, None, :], self.h, c.fb, **taps)
            # block_kalman: beta = aec_delta, sigmau2 = aec_epsilon (JAX's call)
            Yr = aec_scan(Yr, Vp, c.aec, c.aec_delta, c.aec_epsilon, c.aec_threshold)
        if c.wpe:
            Yr = wpe_multichannel_packed_tm(
                Yr, c.wpe_lower, c.wpe_upper, c.wpe_iterations,
                band_width=c.wpe_band_width, samplerate=c.samplerate,
            )
        return Yr

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
        x = x.to(torch.float32)
        C = x.shape[1]
        taps = dict(A=self.A, hr=self.hr)
        synth = dict(S=self.S, gf=self.gf)
        zelinski = c.postfilter == "zelinski"
        coherence = c.postfilter in COHERENCE_POSTFILTERS
        pf = (c.pf_alpha, c.pf_type, c.pf_min_frames if zelinski else NO_POSTFILTER)
        bare = play is None and not c.wpe  # no echo canceller, no WPE
        fixed = c.beamformer in FIXED_WEIGHT
        lms = c.beamformer == "gsc_lms"
        gsc = (self.wqH, self.BmH, self.wq_manifold, c.lms if lms else c.rls, *pf)
        if fixed and zelinski and bare and fw_mono_supported(c.fb, C):
            return analysis_fw_synthesis(x, self.h, self.g, c.fb, self.wqH, self.wq_manifold,
                                         *pf, **taps, **synth)
        if c.beamformer == "gsc_rls" and zelinski and bare and gsc_mono_supported(c.fb, C):
            # the flagship chain in one kernel, as the JAX package runs it
            return analysis_gsc_synthesis(x, self.h, self.g, c.fb, *gsc, **taps, **synth)
        Yr = self._subbands(x, play)  # [Tf, B, C, M]
        if fixed and zelinski:
            Yp = zelinski_apply(Yr, self.wqH, self.wq_manifold, *pf)
        elif fixed and coherence:  # the kernel forms wqH X itself
            Yp = coherence_postfilter(Yr, None, self.wqH, self.wq_manifold, c.postfilter,
                                      self.pf_consts, c.pf_alpha, c.pf_type, c.pf_min_frames)
        elif fixed:  # wqH X, a plain product (XLA's in the JAX package)
            Yp = pack_half(bf.apply_weights(self.wqH, unpack_half(Yr).movedim(-2, -1)))
        else:
            Yp = (gsc_lms_zelinski if lms else gsc_rls_zelinski)(Yr, *gsc)
            if coherence:
                Yp = coherence_postfilter(Yr, Yp, self.wqH, self.wq_manifold, c.postfilter,
                                          self.pf_consts, c.pf_alpha, c.pf_type,
                                          c.pf_min_frames)
        return synthesis_tm_fused(Yp, self.g, c.fb, **synth)


def build_pipeline(cfg: PipelineConfig, mpos, delays, h, g, noise_delays=None,
                   device="cuda") -> Enhancer:
    """Build the enhancer for an array steered by ``delays`` (seconds, one
    per channel), with the weights computed once on the host as JAX
    `build_pipeline` computes them: the adaptive GSCs' quiescent weights and
    blocking matrix; D&S ``conj(vs)``; super-directive MVDR against the diffuse
    noise field of the mic positions ``mpos`` (mm) with loading
    ``cfg.sd_mu``; LCMV with the target's manifold and one null per entry of
    ``noise_delays`` (a list of per-channel delays).  The postfilter's
    alignment manifold is ``vs`` itself, not the conjugated apply weights
    (the C++ ``ta_``, beamformer.cc:960-965); the McCowan and Lefkimmiatis
    postfilters read the diffuse noise coherence of ``mpos``
    (`beamforming.diffuse_noise_coherence`, as JAX computes it for them).
    ``device`` is where the
    buffers live and the forward pass runs; without a card the default
    raises `RuntimeError`, so CPU callers pass ``"cpu"``; on the card a
    shape its kernels cannot take raises `NotImplementedError`
    (`check_card_shapes`)."""
    delays = np.asarray(delays)
    _check_supported(cfg, delays.shape[0])
    check_card_shapes(cfg.fb, delays.shape[0], torch.device(device).type)
    dev = _device(device)
    M, fs = cfg.fb.M, cfg.samplerate
    vs = bf.array_manifold(M, fs, delays)
    BmH = None
    if cfg.beamformer in ADAPTIVE:
        wqH, BmH = gsc_weights(M, fs, delays)
    elif cfg.beamformer == "ds":
        wqH = bf.delay_and_sum_weights(M, fs, delays)
    elif cfg.beamformer == "sd_mvdr":
        wqH = bf.superdirective_weights(mpos, delays, M, fs, mu=cfg.sd_mu)
    else:  # lcmv: target + jammer manifolds as constraints, gain 1 then 0s
        njs = [bf.array_manifold(M, fs, np.asarray(d)) for d in (noise_delays or [])]
        gains = np.zeros(1 + len(njs))
        gains[0] = 1.0
        wqH = bf.lcmv_weights(torch.stack([vs] + njs, dim=1), gains)
    Gamma = bf.diffuse_noise_coherence(mpos, M, fs) if cfg.postfilter in GAMMA_POSTFILTERS else None
    return Enhancer(cfg, h, g, wqH, BmH, vs, Gamma, device=dev)


def from_jax_params(params: dict, cfg: PipelineConfig, device="cuda") -> Enhancer:
    """The same `Enhancer` from parameters computed by the JAX package, given
    as numpy arrays: ``h``, ``g``, ``wqH``, ``wq_manifold``, for the
    adaptive GSCs ``BmH`` and for the McCowan and Lefkimmiatis postfilters
    the noise coherence ``Gamma`` (JAX's, so that no clamp of its entries
    parts on rounding).  ``params["lms"]``, where given, holds the JAX
    configuration's `GSCLMSConfig` fields (``dataclasses.asdict``) and
    replaces ``cfg.lms``; ``params["aec_taps"]``, where given, replaces
    ``cfg.aec_taps`` (JAX's `PipelineConfig` field of that name)."""
    need = ({"h", "g", "wqH", "wq_manifold"} | ({"BmH"} if cfg.beamformer in ADAPTIVE else set())
            | ({"Gamma"} if cfg.postfilter in GAMMA_POSTFILTERS else set()))
    missing = need - set(params)
    if missing:
        raise KeyError(f"missing parameters: {sorted(missing)}")
    if "lms" in params:
        cfg = dataclasses.replace(cfg, lms=GSCLMSConfig(**params["lms"]))
    if "aec_taps" in params:
        cfg = dataclasses.replace(cfg, aec_taps=int(params["aec_taps"]))
    return Enhancer(
        cfg, params["h"], params["g"], params["wqH"], params.get("BmH"), params["wq_manifold"],
        params.get("Gamma") if cfg.postfilter in GAMMA_POSTFILTERS else None, device=device,
    )


def enhance(cfg: PipelineConfig, mpos, delays, h, g, x, play=None, device="cuda") -> torch.Tensor:
    """One-shot `build_pipeline` and forward: samples ``x [B, C, T]`` (and,
    with an echo canceller, the far end ``play [B, T]``; numpy or tensors)
    -> ``[B, T_out]`` on ``device``, which defaults to the card and raises
    without one."""
    enh = build_pipeline(cfg, mpos, delays, h, g, device=device)
    dev = enh.h.device

    def on_dev(a):
        return None if a is None else torch.as_tensor(a, dtype=torch.float32).to(dev)

    with torch.no_grad():
        return enh(on_dev(x), on_dev(play))
