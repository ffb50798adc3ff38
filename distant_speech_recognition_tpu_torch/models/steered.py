"""SRP-PHAT-steered adaptive beamforming (BASELINE config 5).

Counterpart of the JAX package's ``models/steered.py``: per utterance, find
the talker by SRP-PHAT over a steering grid, steer a GSC-RLS beamformer at
that direction, and enhance with the Zelinski postfilter (the batched
equivalent of chaining DOAEstimatorSRPDSBLA, beamformer.cc:2879-3211, into
SubbandGSCRLS steering).  The forward pass follows the JAX package's
batched path (``_build_steered_pallas``): the analysis bank (K1), SRP-PHAT
on the complex snapshots unpacked from its output, the per-utterance
manifold and blocking matrix, the scan with per-utterance weights (K6), the
synthesis bank (K3).  On a CUDA device it launches those three kernels; on
the CPU their plain versions run.

Only ``beamformer="gsc_rls"``, ``postfilter="zelinski"``,
``doa_protocol="srp_phat"`` with bins ``min_bin=1, max_bin=None`` is ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..ops.filterbank import (
    analysis_matrix_tensor,
    analysis_taps,
    synthesis_matrix_tensor,
    synthesis_taps,
    unpack_half,
)
from ..ops.filterbank_kernels import analysis_tm_fused, prototype_taps, synthesis_tm_fused
from ..utils.geometry import SSPEED_MM_S, calc_ca_delays
from . import beamforming as bf
from .fused_scan import gsc_rls_zelinski_steered
from .localization import srp_phat, srp_phat_steering_table
from .pipeline import PipelineConfig, _device, check_card_shapes

__all__ = ["SteeredEnhancer", "build_steered_pipeline", "steered_from_jax_params",
           "steering_weights"]


def _check_steered(cfg: PipelineConfig, min_bin: int = 1, max_bin=None,
                   doa_protocol: str = "srp_phat") -> None:
    """Raise `NotImplementedError`, on every device, for the steered
    variants the port does not run."""
    if (cfg.beamformer, cfg.postfilter, doa_protocol) != ("gsc_rls", "zelinski", "srp_phat"):
        raise NotImplementedError(
            f"steered beamformer={cfg.beamformer!r} postfilter={cfg.postfilter!r} "
            f"doa_protocol={doa_protocol!r} is not ported; only gsc_rls + zelinski + srp_phat"
        )
    if (min_bin, max_bin) != (1, None):
        raise NotImplementedError(
            f"SRP bins min_bin={min_bin} max_bin={max_bin} are not ported; only 1, None")
    if cfg.aec != "none" or cfg.wpe:
        raise NotImplementedError("the steered pipeline runs without AEC and WPE")


class SteeredEnhancer(nn.Module):
    """``forward(x [B, C, T]) -> (y [B, T_out], doa [B, 2])``: each utterance
    steered at its own SRP-PHAT estimate, ``doa`` its (theta, phi) grid
    point.

    Buffers: prototypes ``h``, ``g`` and the filterbank kernels' taps
    ``hr``, ``gf``; packed DFT matrices ``A``, ``S``; the
    SRP steering table ``steering [G, F, C]`` (complex64), its grid ``grid
    [G, 2]`` and each grid point's steering delays ``delay_table [G, C]``
    (float32 seconds).
    """

    def __init__(self, cfg: PipelineConfig, h, g, steering, grid, delay_table, device="cuda"):
        super().__init__()
        _check_steered(cfg)
        check_card_shapes(cfg.fb, steering.shape[-1], torch.device(device).type)
        dev = _device(device)
        fb = cfg.fb
        self.cfg = cfg
        self.register_buffer("h", torch.tensor(np.asarray(h, np.float32), device=dev))
        self.register_buffer("g", torch.tensor(np.asarray(g, np.float32), device=dev))
        self.register_buffer("A", analysis_matrix_tensor(fb.M, True, dev))
        self.register_buffer("S", synthesis_matrix_tensor(fb.M, fb.R, dev))

        def table(a, dtype):
            if isinstance(a, torch.Tensor):
                return a.to(device=dev, dtype=dtype).contiguous()
            return torch.tensor(np.asarray(a), dtype=dtype, device=dev)

        self.register_buffer("steering", table(steering, torch.complex64))
        self.register_buffer("grid", table(grid, torch.float32))
        self.register_buffer("delay_table", table(delay_table, torch.float32))
        if self.h.shape != (fb.N,) or self.g.shape != (fb.N,):
            raise ValueError(f"prototypes must have length N=M*m={fb.N}")
        # the filterbank kernels' taps, computed once
        self.register_buffer("hr", prototype_taps(analysis_taps, self.h, fb, dev))
        self.register_buffer("gf", prototype_taps(synthesis_taps, self.g, fb, dev))
        G, F, C = self.steering.shape
        if F != fb.M // 2 + 1 or self.grid.shape != (G, 2) or self.delay_table.shape != (G, C):
            raise ValueError(
                f"need steering [G, {fb.M // 2 + 1}, C], grid [G, 2], delay_table [G, C], got "
                f"{tuple(self.steering.shape)}, {tuple(self.grid.shape)}, "
                f"{tuple(self.delay_table.shape)}"
            )

    def forward(self, x: torch.Tensor):
        if x.dim() != 3:
            raise ValueError(f"x must be [B, C, T], got {tuple(x.shape)}")
        if x.device != self.h.device:
            raise ValueError(f"x is on {x.device}, the pipeline on {self.h.device}")
        if x.shape[1] != self.steering.shape[2]:
            raise ValueError(f"x has {x.shape[1]} channels, the steering table "
                             f"{self.steering.shape[2]}")
        c = self.cfg
        Yp = analysis_tm_fused(x.to(torch.float32), self.h, c.fb, A=self.A, hr=self.hr)
        gidx, weights = self.steer(Yp)
        Yb = gsc_rls_zelinski_steered(Yp, *weights, c.rls, c.pf_alpha, c.pf_type, c.pf_min_frames)
        return synthesis_tm_fused(Yb, self.g, c.fb, S=self.S, gf=self.gf), self.grid[gidx]

    def steer(self, Yp: torch.Tensor):
        """The per-utterance steering decision from the packed spectrum ``Yp
        [Tf, B, C, M]``: the SRP-PHAT grid index ``gidx [B]`` (argmax of the
        sum over frames) and `steering_weights` at that grid point's delays."""
        X = unpack_half(Yp).permute(1, 0, 3, 2)  # complex snapshots [B, Tf, F, C]
        gidx = torch.argmax(srp_phat(X, self.steering, 1, None).sum(dim=1), dim=-1)
        del X
        vs = bf.array_manifold(self.cfg.fb.M, self.cfg.samplerate, self.delay_table[gidx])
        return gidx, steering_weights(vs)


def steering_weights(vs: torch.Tensor):
    """The steered scan's weights from per-utterance manifolds ``vs [B, F,
    C]``: ``(wq_b = conj(vs), bm_b = blocking_matrix(vs)^T [B, F, C-1, C],
    vs)``, the argument triple of `fused_scan.gsc_rls_zelinski_steered`."""
    return (torch.conj(vs).resolve_conj(), bf.blocking_matrix(vs).transpose(-1, -2).contiguous(),
            vs)


def build_steered_pipeline(cfg: PipelineConfig, mpos, h, g, thetas, phis,
                           sspeed: float = SSPEED_MM_S, min_bin: int = 1, max_bin=None,
                           doa_protocol: str = "srp_phat", device="cuda") -> SteeredEnhancer:
    """Build the steered enhancer for a circular array ``mpos [C, 3]`` (mm)
    and the polar/azimuth search grid ``thetas`` x ``phis`` (radians).  The
    tables are computed once on the host as the JAX package computes them:
    the steering delays of each grid point from its float32 angles.
    ``device`` defaults to the card and raises without one."""
    _check_steered(cfg, min_bin, max_bin, doa_protocol)
    mpos = np.asarray(mpos, np.float64)
    check_card_shapes(cfg.fb, mpos.shape[0], torch.device(device).type)
    steering, grid = srp_phat_steering_table(mpos, cfg.fb.M, cfg.samplerate, thetas, phis,
                                             sspeed)
    delay_table = np.stack([calc_ca_delays(mpos, p, t, sspeed) for t, p in grid.numpy()])
    return SteeredEnhancer(cfg, h, g, steering, grid, delay_table.astype(np.float32),
                           device=device)


def steered_from_jax_params(params: dict, cfg: PipelineConfig, device="cuda") -> SteeredEnhancer:
    """The same `SteeredEnhancer` from tables computed by the JAX package,
    given as numpy arrays: ``h``, ``g``, ``steering``, ``grid``,
    ``delay_table``."""
    missing = {"h", "g", "steering", "grid", "delay_table"} - set(params)
    if missing:
        raise KeyError(f"missing parameters: {sorted(missing)}")
    return SteeredEnhancer(cfg, params["h"], params["g"], params["steering"], params["grid"],
                           params["delay_table"], device=device)
