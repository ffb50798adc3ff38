"""DOA-steered beamforming (BASELINE config 5 and its variants).

Counterpart of the JAX package's ``models/steered.py``: per utterance, find
the talker over a steering grid, steer the beamformer at that direction and
enhance (the batched equivalent of chaining DOAEstimatorSRPDSBLA,
beamformer.cc:2879-3211, into the beamformer's steering).  The forward pass
follows the JAX package's batched path (``_build_steered_pallas``) for
every configuration its ``build_steered_pipeline`` takes: the analysis bank
(K1); the DOA on the complex snapshots unpacked from its output (SRP-PHAT,
or the reference's DSBLA protocol, `localization.srp_dsbla`, over any bin
range; plain torch, as XLA runs it in JAX); the per-utterance manifold (and
blocking matrix); the beamformer with one steering per utterance; the
synthesis bank (K3).  The beamformer's kernel follows from the
configuration alone:

- ``gsc_rls``: the steered RLS scan K6 (`fused_scan.gsc_rls_zelinski_steered`);
- ``gsc_lms``: the LMS gate pass and the steered LMS scan
  (`fused_scan.gsc_lms_zelinski_steered`);
- ``ds``: the steered K7 (`fixed_weight.zelinski_apply_steered`), ``Y =
  conj(vs)^T X``;

each with the Zelinski gain aligned with the manifold ``vs`` (the C++
``ta_``), or, for ``postfilter="none"``, with ``pf_min_frames=NO_POSTFILTER``
(the gain computed and never applied).  On a CUDA device it launches those
kernels; on the CPU their plain versions run.  The steered chain has no
echo canceller or WPE (`NotImplementedError`).
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
from .fixed_weight import zelinski_apply_steered
from .fused_scan import NO_POSTFILTER, gsc_lms_zelinski_steered, gsc_rls_zelinski_steered
from .localization import srp_dsbla, srp_phat, srp_phat_steering_table
from .pipeline import PipelineConfig, _device, check_card_shapes

__all__ = ["SteeredEnhancer", "build_steered_pipeline", "steered_from_jax_params",
           "steering_weights", "STEERED_BEAMFORMERS", "DOA_PROTOCOLS"]

STEERED_BEAMFORMERS = ("ds", "gsc_lms", "gsc_rls")
DOA_PROTOCOLS = ("srp_phat", "dsbla")


def _check_steered(cfg: PipelineConfig, doa_protocol: str) -> None:
    """`ValueError` where the JAX package raises (a beamformer, postfilter or
    DOA protocol the steered chain has not), `NotImplementedError` for an
    echo canceller or WPE, which it has not either."""
    if cfg.beamformer not in STEERED_BEAMFORMERS:
        raise ValueError(f"steered pipeline supports beamformer ds|gsc_lms|gsc_rls, got "
                         f"{cfg.beamformer}")
    if cfg.postfilter not in ("none", "zelinski"):
        raise ValueError(f"steered pipeline supports postfilter none|zelinski, got "
                         f"{cfg.postfilter}")
    if doa_protocol not in DOA_PROTOCOLS:
        raise ValueError(f"unknown doa_protocol {doa_protocol!r}")
    if cfg.aec != "none" or cfg.wpe:
        raise NotImplementedError("the steered pipeline runs without AEC and WPE")


class SteeredEnhancer(nn.Module):
    """``forward(x [B, C, T]) -> (y [B, T_out], doa [B, 2])``: each utterance
    steered at its own DOA estimate, ``doa`` its (theta, phi) grid point.

    Buffers: prototypes ``h``, ``g`` and the filterbank kernels' taps
    ``hr``, ``gf``; packed DFT matrices ``A``, ``S``; the SRP steering table
    ``steering [G, F, C]`` (complex64), its grid ``grid [G, 2]``, each grid
    point's steering delays ``delay_table [G, C]`` (float32 seconds) and,
    for ``doa_protocol="dsbla"``, DSBLA's table ``wq_table [G, F, C]``
    (complex64, the manifolds in the wq convention).  The DOA sums bins
    ``min_bin <= f < max_bin`` (SRP-PHAT) or ``min_bin <= f <= max_bin``
    (DSBLA, default ``max_bin`` the Nyquist bin), each function's own
    convention; DSBLA skips frames whose energy is under
    ``energy_threshold``.
    """

    def __init__(self, cfg: PipelineConfig, h, g, steering, grid, delay_table, min_bin: int = 1,
                 max_bin: int | None = None, doa_protocol: str = "srp_phat",
                 energy_threshold: float = 0.0, wq_table=None, device="cuda"):
        super().__init__()
        _check_steered(cfg, doa_protocol)
        check_card_shapes(cfg.fb, steering.shape[-1], torch.device(device).type)
        if (doa_protocol == "dsbla") != (wq_table is not None):
            raise ValueError("wq_table is required exactly when doa_protocol is 'dsbla'")
        dev = _device(device)
        fb = cfg.fb
        self.cfg = cfg
        self.min_bin, self.max_bin = min_bin, max_bin
        self.doa_protocol, self.energy_threshold = doa_protocol, energy_threshold
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
        self.register_buffer("wq_table",
                             None if wq_table is None else table(wq_table, torch.complex64))
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
        if self.wq_table is not None and self.wq_table.shape != (G, F, C):
            raise ValueError(f"need wq_table [{G}, {F}, {C}], got {tuple(self.wq_table.shape)}")

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
        gidx, vs = self.steer(Yp)
        Yb = self.beamform(Yp, vs)
        return synthesis_tm_fused(Yb, self.g, c.fb, S=self.S, gf=self.gf), self.grid[gidx]

    def steer(self, Yp: torch.Tensor):
        """The per-utterance steering decision from the packed spectrum ``Yp
        [Tf, B, C, M]``: the grid index ``gidx [B]`` (SRP-PHAT: the argmax of
        the sum over frames; DSBLA: the best of the accumulated powers) and
        the manifold ``vs [B, F, C]`` at that grid point's delays."""
        X = unpack_half(Yp).permute(1, 0, 3, 2)  # complex snapshots [B, Tf, F, C]
        if self.doa_protocol == "dsbla":
            gidx = srp_dsbla(X, self.wq_table, self.min_bin, self.max_bin,
                             self.energy_threshold, 1)[0][:, 0]
        else:
            srp = srp_phat(X, self.steering, self.min_bin, self.max_bin)
            gidx = torch.argmax(srp.sum(dim=1), dim=-1)
        del X
        return gidx, bf.array_manifold(self.cfg.fb.M, self.cfg.samplerate, self.delay_table[gidx])

    def beamform(self, Yp: torch.Tensor, vs: torch.Tensor) -> torch.Tensor:
        """The beamformer (and Zelinski gain) steered per utterance at the
        manifolds ``vs [B, F, C]``: ``Yp [Tf, B, C, M]`` -> packed ``[Tf, B,
        M]``, through the configuration's kernel."""
        c = self.cfg
        pf = (c.pf_alpha, c.pf_type, c.pf_min_frames if c.postfilter == "zelinski"
              else NO_POSTFILTER)
        if c.beamformer == "ds":
            return zelinski_apply_steered(Yp, torch.conj(vs).resolve_conj(), vs, *pf)
        if c.beamformer == "gsc_lms":
            return gsc_lms_zelinski_steered(Yp, *steering_weights(vs), c.lms, *pf)
        return gsc_rls_zelinski_steered(Yp, *steering_weights(vs), c.rls, *pf)


def steering_weights(vs: torch.Tensor):
    """The steered scans' weights from per-utterance manifolds ``vs [B, F,
    C]``: ``(wq_b = conj(vs), bm_b = blocking_matrix(vs)^T [B, F, C-1, C],
    vs)``, the argument triple of `fused_scan.gsc_rls_zelinski_steered` and
    `fused_scan.gsc_lms_zelinski_steered`."""
    return (torch.conj(vs).resolve_conj(), bf.blocking_matrix(vs).transpose(-1, -2).contiguous(),
            vs)


def build_steered_pipeline(cfg: PipelineConfig, mpos, h, g, thetas, phis,
                           sspeed: float = SSPEED_MM_S, min_bin: int = 1, max_bin=None,
                           doa_protocol: str = "srp_phat", energy_threshold: float = 0.0,
                           device="cuda") -> SteeredEnhancer:
    """Build the steered enhancer for a circular array ``mpos [C, 3]`` (mm)
    and the polar/azimuth search grid ``thetas`` x ``phis`` (radians), with
    ``cfg.beamformer`` ds | gsc_lms | gsc_rls and ``cfg.postfilter`` none |
    zelinski.  The tables are computed once on the host as the JAX package
    computes them: the steering delays of each grid point from its angles in
    float64, the SRP table from them, and for ``doa_protocol="dsbla"`` the
    manifolds of those float64 delays (``wq_table``).  ``device`` defaults
    to the card and raises without one."""
    _check_steered(cfg, doa_protocol)
    mpos = np.asarray(mpos, np.float64)
    check_card_shapes(cfg.fb, mpos.shape[0], torch.device(device).type)
    M, fs = cfg.fb.M, cfg.samplerate
    steering, grid = srp_phat_steering_table(mpos, M, fs, thetas, phis, sspeed)
    delay_table = np.stack([calc_ca_delays(mpos, p, t, sspeed) for t, p in grid.numpy()])
    wq_table = None
    if doa_protocol == "dsbla":
        wq_table = torch.stack([bf.array_manifold(M, fs, d) for d in delay_table])
    return SteeredEnhancer(cfg, h, g, steering, grid, delay_table.astype(np.float32), min_bin,
                           max_bin, doa_protocol, energy_threshold, wq_table, device=device)


def steered_from_jax_params(params: dict, cfg: PipelineConfig, min_bin: int = 1, max_bin=None,
                            doa_protocol: str = "srp_phat", energy_threshold: float = 0.0,
                            device="cuda") -> SteeredEnhancer:
    """The same `SteeredEnhancer` from tables computed by the JAX package,
    given as numpy arrays: ``h``, ``g``, ``steering``, ``grid``,
    ``delay_table`` and, for ``doa_protocol="dsbla"``, ``wq_table``."""
    need = {"h", "g", "steering", "grid", "delay_table"} | (
        {"wq_table"} if doa_protocol == "dsbla" else set())
    missing = need - set(params)
    if missing:
        raise KeyError(f"missing parameters: {sorted(missing)}")
    return SteeredEnhancer(cfg, params["h"], params["g"], params["steering"], params["grid"],
                           params["delay_table"], min_bin, max_bin, doa_protocol,
                           energy_threshold,
                           params["wq_table"] if doa_protocol == "dsbla" else None,
                           device=device)
