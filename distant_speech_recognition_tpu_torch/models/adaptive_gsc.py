"""Adaptive GSC beamformers (LMS and RLS), alone or fused with the Zelinski
postfilter, plain torch.

The reference adapts the active weight vector ``wa`` per frame per bin
(SubbandGSCLMSBeamformer.__iter__, pybeamformer.py:659-762;
SubbandGSCRLSBeamformer.__iter__, pybeamformer.py:816-898, whose C++ twin is
SubbandGSCRLS::update_active_weight_vector2_, beamformer.cc:1576-1645) and
runs the Zelinski postfilter on the same snapshots (postfilter.cc:424-473).
Here one Python loop over frames carries the state of every (utterance,
bin) pair at once: all operations are vectorised over ``[B, F]``.

`gsc_lms` and `gsc_rls` run the beamformer alone on complex snapshots (the
JAX package's route for ``postfilter="none"``).  `gsc_postfilter_fused` is
the specification the CUDA scan kernels (`models.fused_scan.gsc_rls_zelinski`
and `gsc_lms_zelinski`, ``csrc/gsc_rls_zelinski.cu`` and
``csrc/gsc_lms_zelinski.cu``) are held to, and their
plain version on the CPU.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..ops.filterbank import pack_half, unpack_half
from .beamforming import array_manifold, blocking_matrix, frame_energy_half
from .postfilter import PostFilterType, zelinski_step

__all__ = [
    "GSCLMSConfig", "GSCRLSConfig", "LMSState", "RLSState", "gsc_weights", "lms_init_state",
    "rls_init_state", "gsc_lms", "gsc_rls", "lms_silence_gates", "gsc_postfilter_fused",
]


@dataclasses.dataclass(frozen=True)
class GSCLMSConfig:
    """Defaults per SubbandGSCLMSBeamformer.__init__ (pybeamformer.py:595-607)."""

    beta: float = 0.97
    gamma: float = 0.01
    init_diagonal_load: float = 1.0e6
    regularization_param: float = 1.0e-4
    energy_floor: float = 90.0
    sil_thresh: float = 1.0e8
    max_wa_l2norm: float = 100.0
    min_frames: int = 128
    slowdown_after: int = 4096


@dataclasses.dataclass(frozen=True)
class GSCRLSConfig:
    """Defaults per SubbandGSCRLSBeamformer.__init__ (pybeamformer.py:770-783)."""

    beta: float = 0.97
    gamma: float = 0.04
    mu: float = 0.97
    init_diagonal_load: float = 1.0e6
    regularization_param: float = 1.0e-2
    sil_thresh: float = 1.0e8
    constraint_option: int = 3  # 0: none, 1: quadratic, 2: norm cap, 3: both
    alpha2: float = 10.0
    max_wa_l2norm: float = 100.0
    min_frames: int = 128


class LMSState(NamedTuple):
    """The LMS carry: the JAX package's ``_LMSState``."""

    waH: torch.Tensor  # [..., F, Bc] conjugate active weights
    subband_energy: torch.Tensor  # [..., F] smoothed sum_c |X_c|^2
    energy: torch.Tensor  # [...] smoothed reference-channel frame energy
    gamma: torch.Tensor  # 0-d step size, halved every slowdown_after frames
    isamp: int  # frames seen


class RLSState(NamedTuple):
    """The RLS carry: the JAX package's ``_RLSState``.  The Hermitian
    precision Pz is carried as its real diagonal and its upper triangle
    (pairs (i, j), i < j, row-major)."""

    waH: torch.Tensor  # [..., F, Bc]
    pz_diag: torch.Tensor  # [..., F, Bc]
    pz_off: torch.Tensor  # [..., F, Bc*(Bc-1)/2]
    energy: torch.Tensor  # [...]
    isamp: int


def _real_dtype(cdtype: torch.dtype) -> torch.dtype:
    return torch.float32 if cdtype == torch.complex64 else torch.float64


def lms_init_state(batch: tuple, F: int, Bc: int, c: GSCLMSConfig, cdtype=torch.complex64,
                   device=None) -> LMSState:
    """Fresh LMS state: wa = 0, the smoothed energies at the initial diagonal
    load, the initial step size (pybeamformer.py:620-640)."""
    rdt = _real_dtype(cdtype)
    return LMSState(
        waH=torch.zeros(batch + (F, Bc), dtype=cdtype, device=device),
        subband_energy=torch.full(batch + (F,), c.init_diagonal_load, dtype=rdt, device=device),
        energy=torch.full(batch, c.init_diagonal_load, dtype=rdt, device=device),
        gamma=torch.tensor(c.gamma, dtype=rdt, device=device),
        isamp=0,
    )


def rls_init_state(batch: tuple, F: int, B: int, init_diagonal_load: float,
                   cdtype=torch.complex64, device=None) -> RLSState:
    """Fresh RLS state: wa = 0, Pz = I / delta (pybeamformer.py:795-807)."""
    rdt = _real_dtype(cdtype)
    return RLSState(
        waH=torch.zeros(batch + (F, B), dtype=cdtype, device=device),
        pz_diag=torch.full(batch + (F, B), 1.0 / init_diagonal_load, dtype=rdt, device=device),
        pz_off=torch.zeros(batch + (F, B * (B - 1) // 2), dtype=cdtype, device=device),
        energy=torch.full(batch, init_diagonal_load, dtype=rdt, device=device),
        isamp=0,
    )


def gsc_weights(fftlen: int, samplerate: float, delays, Nc: int = 1):
    """Quiescent weights + blocking matrix for a GSC
    (calc_beamformer_weights, pybeamformer.py:739-746 / 882-889).

    Returns complex64 CPU tensors ``(wqH [F, C], BmH [F, C-Nc, C])`` with
    ``BmH = B^T`` (transpose, not conjugate — the reference's convention).
    """
    vs = array_manifold(fftlen, samplerate, delays)
    B = blocking_matrix(vs, Nc)
    return torch.conj(vs).resolve_conj(), B.transpose(-1, -2).contiguous()


def _lms_step_factory(c: GSCLMSConfig, wqH: torch.Tensor, BmH: torch.Tensor):
    """One leaky power-normalised LMS frame update (pybeamformer.py:659-762),
    shape-generic over the batch axes: ``step(state, Xt [..., F, C],
    energy_t [...]) -> (state, Y [..., F])``."""
    Bc, C = BmH.shape[-2], BmH.shape[-1]

    def step(state: LMSState, Xt, energy_t):
        # step-size slowdown (pybeamformer.py:669-671)
        slow = state.isamp > 0 and state.isamp % c.slowdown_after == 0
        gamma = state.gamma / 2.0 if slow else state.gamma

        gate = energy_t > state.energy / c.sil_thresh  # [...]

        Z = torch.stack([sum(BmH[..., i, ch] * Xt[..., ch] for ch in range(C))
                         for i in range(Bc)], dim=-1)  # blocking-matrix outputs
        Yc = sum(wqH[..., ch] * Xt[..., ch] for ch in range(C))  # upper branch

        xpow = torch.sum(torch.abs(Xt) ** 2, dim=-1)  # per-bin cross-channel power
        if state.isamp > 0:
            se = state.subband_energy * c.beta + (1.0 - c.beta) * xpow
        else:
            se = xpow
        se = torch.clamp(se, min=c.energy_floor)

        # leak and error both on the old weights
        epa = Yc - torch.sum(state.waH * Z, dim=-1)
        alpha = gamma / se  # [..., F]
        watH = state.waH + epa[..., None] * torch.conj(Z) * alpha[..., None]
        if c.regularization_param > 0:
            watH = watH - alpha[..., None] * c.regularization_param * state.waH
        norm = torch.abs(torch.sum(watH * torch.conj(watH), dim=-1))
        # the select never lets the speculative inf scale of a zero norm through
        scale = torch.where(norm > c.max_wa_l2norm, torch.sqrt(c.max_wa_l2norm / norm),
                            torch.ones_like(norm))
        waH_new = watH * scale[..., None]

        waH = torch.where(gate[..., None, None], waH_new, state.waH)
        subband_energy = torch.where(gate[..., None], se, state.subband_energy)

        if state.isamp >= c.min_frames:
            Y = Yc - torch.sum(waH * Z, dim=-1)
        else:
            Y = Yc
        new_state = LMSState(
            waH=waH,
            subband_energy=subband_energy,
            energy=state.energy * c.beta + (1.0 - c.beta) * energy_t,
            gamma=gamma,
            isamp=state.isamp + 1,
        )
        return new_state, Y

    return step


def _pz_pairs(B: int):
    """Upper-triangle pairs ``(i, j)``, i<j, row-major: the compressed
    layout of the Hermitian RLS precision matrix Pz."""
    return [(i, j) for i in range(B) for j in range(B) if i < j]


def _rls_step_factory(c: GSCRLSConfig, wqH: torch.Tensor, BmH: torch.Tensor):
    """One RLS frame update over state lists (see `gsc_postfilter_fused`).

    Pz is Hermitian throughout (Pz0 = I/delta, rank-1 Hermitian updates,
    reset to I/delta), so only its real diagonal ``d`` and upper triangle
    ``off`` are carried; the lower triangle is ``conj(upper)``.
    """
    Bc, C = BmH.shape[-2], BmH.shape[-1]
    pairs = _pz_pairs(Bc)
    pidx = {p: n for n, p in enumerate(pairs)}

    # (Pz v)_i = d_i v_i + sum_{j>i} off_ij v_j + sum_{j<i} conj(off_ji) v_j
    def _pz_matvec(d, off, v):
        return [
            d[i] * v[i]
            + sum(off[pidx[(i, j)]] * v[j] for j in range(i + 1, Bc))
            + sum(torch.conj(off[pidx[(j, i)]]) * v[j] for j in range(i))
            for i in range(Bc)
        ]

    def step(state, Xt, energy_t, isamp):
        waH_l, d, off, energy = state
        gate = energy_t > energy / c.sil_thresh  # [...]

        Zl = [sum(BmH[..., i, ch] * Xt[..., ch] for ch in range(C)) for i in range(Bc)]
        Yc = sum(wqH[..., ch] * Xt[..., ch] for ch in range(C))

        # Gain vector & precision update; Z^H Pz (pybeamformer.py:838) is
        # conj(Pz Z) by hermitianity.
        PzZ = _pz_matvec(d, off, Zl)
        ip = sum(torch.conj(Zl[i]) * PzZ[i] for i in range(Bc))
        den = c.mu + ip
        gz = [PzZ[i] / den for i in range(Bc)]
        dK = [(d[i] - torch.real(gz[i] * torch.conj(PzZ[i]))) / c.mu for i in range(Bc)]
        offK = [(off[n] - gz[i] * torch.conj(PzZ[j])) / c.mu for n, (i, j) in enumerate(pairs)]

        # Active weight update.
        ep = Yc - sum(waH_l[i] * Zl[i] for i in range(Bc))
        waH = [waH_l[i] + c.gamma * torch.conj(gz[i]) * ep for i in range(Bc)]
        if c.regularization_param > 0:
            # conj(PzK) matvec on the OLD weights
            reg = [
                dK[i] * waH_l[i]
                + sum(torch.conj(offK[pidx[(i, j)]]) * waH_l[j] for j in range(i + 1, Bc))
                + sum(offK[pidx[(j, i)]] * waH_l[j] for j in range(i))
                for i in range(Bc)
            ]
            waH = [waH[i] - reg[i] * c.regularization_param for i in range(Bc)]

        if c.constraint_option > 0:
            waK2 = sum(torch.abs(waH[i]) ** 2 for i in range(Bc))
            if c.constraint_option in (1, 3):
                # Quadratic constraint (pybeamformer.py:849-861).
                waK = [torch.conj(waH[i]) for i in range(Bc)]
                va = _pz_matvec(dK, offK, waK)
                a = sum(torch.abs(va[i]) ** 2 for i in range(Bc))
                b = -2.0 * sum(torch.real(torch.conj(va[i]) * waK[i]) for i in range(Bc))
                cc = waK2 - c.alpha2
                arg = b * b - 4.0 * a * cc
                a_safe = torch.where(a > 0, a, torch.ones_like(a))
                betaK = torch.where(
                    arg > 0,
                    -(b + torch.sqrt(torch.clamp(arg, min=0.0))) / (2.0 * a_safe),
                    -b / (2.0 * a_safe),
                )
                hit = waK2 > c.alpha2
                waH = [torch.where(hit, waH[i] - betaK * torch.conj(va[i]), waH[i]) for i in range(Bc)]
                # the norm cap below reuses the pre-constraint waK2, like the
                # reference (pybeamformer.py:849)
            if c.constraint_option >= 2:
                # Norm cap + precision reset (pybeamformer.py:862-865): the
                # select never lets the speculative inf scale of a silent
                # bin reach the result.
                over = waK2 > c.max_wa_l2norm
                scale = torch.sqrt(c.max_wa_l2norm / waK2)
                waH = [torch.where(over, waH[i] * scale, waH[i]) for i in range(Bc)]
                reset = torch.full_like(dK[0], 1.0 / c.init_diagonal_load)
                dK = [torch.where(over, reset, dK[i]) for i in range(Bc)]
                offK = [torch.where(over, torch.zeros_like(offK[n]), offK[n]) for n in range(len(pairs))]

        g = gate[..., None]  # the per-frame gate broadcast over bins
        d_new = [torch.where(g, dK[i], d[i]) for i in range(Bc)]
        off_new = [torch.where(g, offK[n], off[n]) for n in range(len(pairs))]
        waH_new = [torch.where(g, waH[i], waH_l[i]) for i in range(Bc)]

        if isamp >= c.min_frames:
            Y = Yc - sum(waH_new[i] * Zl[i] for i in range(Bc))
        else:
            Y = Yc
        new_energy = energy * c.beta + (1.0 - c.beta) * energy_t
        return (waH_new, d_new, off_new, new_energy), Y

    return step


def gsc_lms(X: torch.Tensor, energy: torch.Tensor, wqH: torch.Tensor, BmH: torch.Tensor,
            config: GSCLMSConfig = GSCLMSConfig(), init_state: LMSState | None = None):
    """Leaky power-normalised LMS GSC over an utterance (pybeamformer.py:659-762).

    ``X``: complex snapshots ``[T, ..., F, C]`` (batch axes ``...`` between
    time and bins); ``energy [T, ...]``: the reference channel's frame
    energies (`beamforming.frame_energy_half`); ``wqH [F, C]``, ``BmH [F,
    C-Nc, C]`` from `gsc_weights`.  Returns ``(Y [T, ..., F], final_state)``.
    """
    F, Bc = BmH.shape[-3], BmH.shape[-2]
    state = init_state
    if state is None:
        state = lms_init_state(X.shape[1:-2], F, Bc, config, X.dtype, X.device)
    step = _lms_step_factory(config, wqH, BmH)
    outs = []
    for t in range(X.shape[0]):
        state, Y = step(state, X[t], energy[t].to(state.energy.dtype))
        outs.append(Y)
    return torch.stack(outs, dim=0), state


def lms_silence_gates(X: torch.Tensor, config: GSCLMSConfig) -> torch.Tensor:
    """The LMS update's silence gates over the packed spectrum ``X [T, ...,
    C, M]``: 1 where the reference channel's frame energy exceeds the
    smoothed energy before the frame's update (from ``init_diagonal_load``)
    divided by ``sil_thresh``, else 0, float ``[T, ...]``; what the LMS step
    of `gsc_postfilter_fused` gates on."""
    c = config
    energy = frame_energy_half(unpack_half(X[..., 0, :]), X.shape[-1])  # [T, ...]
    smoothed = torch.full(energy.shape[1:], c.init_diagonal_load, dtype=energy.dtype,
                          device=energy.device)
    gates = []
    for energy_t in energy:
        gates.append(energy_t > smoothed / c.sil_thresh)
        smoothed = smoothed * c.beta + (1.0 - c.beta) * energy_t
    return torch.stack(gates).to(X.dtype)


def gsc_rls(X: torch.Tensor, energy: torch.Tensor, wqH: torch.Tensor, BmH: torch.Tensor,
            config: GSCRLSConfig = GSCRLSConfig(), init_state: RLSState | None = None):
    """RLS GSC with quadratic constraint over an utterance
    (pybeamformer.py:816-898).  Same interface as `gsc_lms`."""
    F, Bc = BmH.shape[-3], BmH.shape[-2]
    s = init_state
    if s is None:
        s = rls_init_state(X.shape[1:-2], F, Bc, config.init_diagonal_load, X.dtype, X.device)
    step = _rls_step_factory(config, wqH, BmH)
    npair = Bc * (Bc - 1) // 2
    state = ([s.waH[..., i] for i in range(Bc)], [s.pz_diag[..., i] for i in range(Bc)],
             [s.pz_off[..., n] for n in range(npair)], s.energy)
    outs = []
    for t in range(X.shape[0]):
        state, Y = step(state, X[t], energy[t].to(s.energy.dtype), s.isamp + t)
        outs.append(Y)
    waH, d, off, en = state
    final = RLSState(torch.stack(waH, dim=-1), torch.stack(d, dim=-1),
                     torch.stack(off, dim=-1) if npair else s.pz_off, en, s.isamp + X.shape[0])
    return torch.stack(outs, dim=0), final


def gsc_postfilter_fused(
    X: torch.Tensor,
    energy,
    wqH: torch.Tensor,
    BmH: torch.Tensor,
    wq_manifold: torch.Tensor,
    kind: str,
    config: GSCLMSConfig | GSCRLSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
    real_packed: bool = True,
) -> torch.Tensor:
    """Adaptive GSC (``kind`` "lms" with a `GSCLMSConfig`, "rls" with a
    `GSCRLSConfig`) + Zelinski postfilter in one loop over frames.

    ``X``: the packed real analysis output ``[T, ..., C, M]``
    (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes); the complex snapshot
    ``[..., F, C]`` is formed per frame and the reference-channel frame
    energy is computed from it (``energy`` must be None).  ``wqH [F, C]``
    and ``BmH [F, C-Nc, C]`` come from `gsc_weights`; ``wq_manifold
    [F, C]`` is the postfilter alignment manifold, conjugated per channel
    (postfilter.cc:30-43).  The weights may instead carry the batch axes
    ``...`` in front (``[..., F, C]``, ``[..., F, C-Nc, C]``): one steering
    per utterance, as the steered pipeline has; weights broadcast from
    ``[F, ...]`` give the shared-weight result bit for bit.  Returns the
    postfiltered output in the same packed layout, ``[T, ..., M]`` float32.

    The gain is applied from frame ``pf_min_frames + 1`` on; a
    ``pf_min_frames`` past the last frame gives the beamformer's output
    alone, as `gsc_lms` / `gsc_rls` compute it.  Only the packed layout with
    in-loop energy is ported.
    """
    if kind not in ("lms", "rls"):
        raise ValueError(f"unknown gsc kind {kind!r}")
    if not real_packed or energy is not None:
        raise NotImplementedError("only the packed layout with in-loop frame energy is ported")
    c = config
    F, Bc = BmH.shape[-3], BmH.shape[-2]
    M = 2 * (F - 1)
    if X.shape[-1] != M:
        raise ValueError(f"packed lane dim must be M={M}, got {X.shape[-1]}")
    batch = X.shape[1:-2]
    dev = X.device
    cdtype = torch.complex64 if X.dtype == torch.float32 else torch.complex128
    real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
    if kind == "lms":
        lms_step = _lms_step_factory(c, wqH, BmH)
        state = lms_init_state(batch, F, Bc, c, cdtype, dev)

        def gsc_step(state, Xt, energy_t, t):
            return lms_step(state, Xt, energy_t)
    else:
        gsc_step = _rls_step_factory(c, wqH, BmH)
        zc = torch.zeros(batch + (F,), dtype=cdtype, device=dev)
        state = (
            [zc] * Bc,
            [torch.full(batch + (F,), 1.0 / c.init_diagonal_load, dtype=X.dtype, device=dev)] * Bc,
            [zc] * (Bc * (Bc - 1) // 2),
            torch.full(batch, c.init_diagonal_load, dtype=X.dtype, device=dev),
        )
    phi_pair = phi_diag = None
    ta_conj = torch.conj(wq_manifold)

    outs = []
    for t in range(X.shape[0]):
        Xt = unpack_half(X[t]).movedim(-2, -1)  # [..., F, C]
        energy_t = frame_energy_half(Xt[..., 0], M)
        state, Y = gsc_step(state, Xt, energy_t, t)
        phi_pair, phi_diag, W = zelinski_step(phi_pair, phi_diag, ta_conj * Xt, t, pf_alpha,
                                              real_mode)
        out = Y * W if t > pf_min_frames else Y
        outs.append(pack_half(out))
    return torch.stack(outs, dim=0)
