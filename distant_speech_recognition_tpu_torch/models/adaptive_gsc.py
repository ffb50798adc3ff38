"""Adaptive GSC beamformer (RLS) fused with the Zelinski postfilter, plain torch.

The reference adapts the active weight vector ``wa`` per frame per bin
(SubbandGSCRLSBeamformer.__iter__, pybeamformer.py:816-898; the C++ twin is
SubbandGSCRLS::update_active_weight_vector2_, beamformer.cc:1576-1645) and
runs the Zelinski postfilter on the same snapshots (postfilter.cc:424-473).
Here one Python loop over frames carries the state of every (utterance,
bin) pair at once: all operations are vectorised over ``[B, F]``.

`gsc_postfilter_fused` is the specification the CUDA scan kernel
(`models.fused_scan.gsc_rls_zelinski`, ``csrc/gsc_rls_zelinski.cu``) is
held to, and its plain version on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops.filterbank import pack_half, unpack_half
from .beamforming import array_manifold, blocking_matrix, frame_energy_half
from .postfilter import SPECTRAL_FLOOR, PostFilterType

__all__ = ["GSCRLSConfig", "gsc_weights", "gsc_postfilter_fused"]


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


def gsc_weights(fftlen: int, samplerate: float, delays, Nc: int = 1):
    """Quiescent weights + blocking matrix for a GSC
    (calc_beamformer_weights, pybeamformer.py:739-746 / 882-889).

    Returns complex64 CPU tensors ``(wqH [F, C], BmH [F, C-Nc, C])`` with
    ``BmH = B^T`` (transpose, not conjugate — the reference's convention).
    """
    vs = array_manifold(fftlen, samplerate, delays)
    B = blocking_matrix(vs, Nc)
    return torch.conj(vs).resolve_conj(), B.transpose(-1, -2).contiguous()


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
    Bc, C = BmH.shape[1], BmH.shape[2]
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

        Zl = [sum(BmH[:, i, ch] * Xt[..., ch] for ch in range(C)) for i in range(Bc)]
        Yc = sum(wqH[:, ch] * Xt[..., ch] for ch in range(C))

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


def gsc_postfilter_fused(
    X: torch.Tensor,
    energy,
    wqH: torch.Tensor,
    BmH: torch.Tensor,
    wq_manifold: torch.Tensor,
    kind: str,
    config: GSCRLSConfig,
    pf_alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    pf_min_frames: int = 0,
    real_packed: bool = True,
) -> torch.Tensor:
    """Adaptive GSC-RLS + Zelinski postfilter in one loop over frames.

    ``X``: the packed real analysis output ``[T, ..., C, M]``
    (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes); the complex snapshot
    ``[..., F, C]`` is formed per frame and the reference-channel frame
    energy is computed from it (``energy`` must be None).  ``wqH [F, C]``
    and ``BmH [F, C-Nc, C]`` come from `gsc_weights`; ``wq_manifold
    [F, C]`` is the postfilter alignment manifold, conjugated per channel
    (postfilter.cc:30-43).  Returns the postfiltered output in the same
    packed layout, ``[T, ..., M]`` float32.

    Only ``kind="rls"`` on the packed layout with in-loop energy is ported.
    """
    if kind != "rls":
        raise NotImplementedError(f"gsc_postfilter_fused kind={kind!r} is not ported; only 'rls'")
    if not real_packed or energy is not None:
        raise NotImplementedError("only the packed layout with in-loop frame energy is ported")
    c = config
    F, Bc = BmH.shape[0], BmH.shape[1]
    M = 2 * (F - 1)
    if X.shape[-1] != M:
        raise ValueError(f"packed lane dim must be M={M}, got {X.shape[-1]}")
    C = X.shape[-2]
    batch = X.shape[1:-2]
    dev = X.device
    cdtype = torch.complex64 if X.dtype == torch.float32 else torch.complex128
    real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
    pairs = [(i, j) for i in range(C) for j in range(C) if i < j]
    rls_step = _rls_step_factory(c, wqH, BmH)

    zc = torch.zeros(batch + (F,), dtype=cdtype, device=dev)
    state = (
        [zc] * Bc,
        [torch.full(batch + (F,), 1.0 / c.init_diagonal_load, dtype=X.dtype, device=dev)] * Bc,
        [zc] * (Bc * (Bc - 1) // 2),
        torch.full(batch, c.init_diagonal_load, dtype=X.dtype, device=dev),
    )
    phi_pair = zc
    phi_diag = torch.zeros(batch + (F,), dtype=X.dtype, device=dev)
    ta_conj = torch.conj(wq_manifold)

    outs = []
    for t in range(X.shape[0]):
        Xt = unpack_half(X[t]).movedim(-2, -1)  # [..., F, C]
        energy_t = frame_energy_half(Xt[..., 0], M)
        state, Y = rls_step(state, Xt, energy_t, t)

        aligned = ta_conj * Xt
        pair_sum = sum(aligned[..., i] * torch.conj(aligned[..., j]) for i, j in pairs)
        diag_sum = torch.sum(torch.abs(aligned) ** 2, dim=-1)
        # the reference smooths from its THIRD call and applies from
        # min_frames+1 (pre-increment frame_no_ checks, postfilter.cc:424-473)
        if t > 1:
            phi_pair = pf_alpha * phi_pair + (1.0 - pf_alpha) * pair_sum
            phi_diag = pf_alpha * phi_diag + (1.0 - pf_alpha) * diag_sum
        else:
            phi_pair, phi_diag = pair_sum, diag_sum

        num = torch.clamp(torch.real(phi_pair), min=0.0) if real_mode else torch.abs(phi_pair)
        pos = phi_diag > 0
        ratio = torch.where(pos, num / torch.where(pos, phi_diag, torch.ones_like(phi_diag)),
                            torch.zeros_like(num))
        W = torch.clamp(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
        out = Y * W if t > pf_min_frames else Y
        outs.append(pack_half(out))
    return torch.stack(outs, dim=0)
