"""The Zelinski, McCowan, Lefkimmiatis and APAB postfilters, plain torch.

Counterpart of the JAX package's ``models/postfilter.py`` for the
postfilters its pipeline runs:

- Zelinski (ZelinskiFilter_f, postfilter.cc:57-148).  One frame of its
  recursion, `zelinski_step`, is shared by the fixed-weight chain
  (`zelinski_postfilter`, the specification of the fixed-weight CUDA
  kernels) and the fused GSC-RLS loop (`adaptive_gsc.gsc_postfilter_fused`).
- McCowan and Lefkimmiatis (postfilter.cc:843-901, 1098-1161), Zelinski
  generalised with a noise coherence ``Gamma [F, C, C]``, and APAB
  (postfilter.cc:224-330): `mccowan_postfilter`, `lefkimmiatis_postfilter`,
  `apab_postfilter`, each the JAX function's counterpart.  The first two
  read ``Gamma`` only through per-bin constants (`coherence_constants`), the
  form the CUDA kernel takes (`models/coherence_postfilter.py`); they share
  `coherence_apply`, which is that kernel's specification.
"""

from __future__ import annotations

import torch

from .beamforming import noise_coherence_gain

SPECTRAL_FLOOR = 1.0e-4  # postfilter.cc:56

__all__ = [
    "SPECTRAL_FLOOR", "PostFilterType", "zelinski_step", "zelinski_postfilter", "zelinski_args",
    "COHERENCE_POSTFILTERS", "coherence_constants", "coherence_apply", "mccowan_postfilter",
    "lefkimmiatis_postfilter", "apab_postfilter",
]

# the postfilters of `coherence_apply`, in the order of the CUDA kernel's kinds
COHERENCE_POSTFILTERS = ("mccowan", "lefkimmiatis", "apab")


class PostFilterType:
    """Bit flags per postfilter.h (TYPE_ZELINSKI1_REAL etc.)."""

    ZELINSKI1_REAL = 0x01
    ZELINSKI1_ABS = 0x02
    APAB = 0x04
    ZELINSKI2 = 0x08


def _time_align(wq: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Per-channel delay compensation ``conj(wq_c) X_c`` (time_alignment_,
    postfilter.cc:30-43); ``wq [..., F, C]`` broadcasts against ``X``."""
    return torch.conj(wq) * X


def zelinski_step(phi_pair, phi_diag, aligned: torch.Tensor, t: int, alpha: float,
                  real_mode: bool):
    """One frame ``t`` of the Zelinski recursion on the time-aligned snapshot
    ``aligned [..., F, C]``.  The weight reads the cross-spectral densities
    only through the pair sum over i<j and the trace, both linear in them, so
    only those two smoothed sums are carried (``phi_pair``, ``phi_diag``;
    ignored at t < 2).  The reference keeps alpha at 0 for its first TWO
    calls: its ``frame_no_ > 0`` check reads the pre-increment counter
    (postfilter.cc:424-463).  A digitally silent bin (trace 0) gets ratio 0,
    so the 1e-4 floor, where the reference's 0/0 would be NaN.  Returns
    ``(phi_pair, phi_diag, W)``."""
    C = aligned.shape[-1]
    pair_sum = sum(aligned[..., i] * torch.conj(aligned[..., j])
                   for i in range(C) for j in range(i + 1, C))
    diag_sum = torch.sum(torch.abs(aligned) ** 2, dim=-1)
    if t > 1:
        phi_pair = alpha * phi_pair + (1.0 - alpha) * pair_sum
        phi_diag = alpha * phi_diag + (1.0 - alpha) * diag_sum
    else:
        phi_pair, phi_diag = pair_sum, diag_sum
    num = torch.clamp(torch.real(phi_pair), min=0.0) if real_mode else torch.abs(phi_pair)
    pos = phi_diag > 0
    ratio = torch.where(pos, num / torch.where(pos, phi_diag, torch.ones_like(phi_diag)),
                        torch.zeros_like(num))
    W = torch.clamp(ratio * (2.0 / (C - 1.0)), SPECTRAL_FLOOR, 1.0)
    return phi_pair, phi_diag, W


def zelinski_postfilter(
    X: torch.Tensor,
    Y: torch.Tensor,
    wq: torch.Tensor,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
) -> torch.Tensor:
    """Zelinski postfilter on a beamformed signal, one loop over frames.

    ``X``: complex snapshots ``[T, ..., F, C]``; ``Y``: beamformed ``[T, ...,
    F]``; ``wq``: the alignment manifold ``[F, C]`` (the C++ ``ta_``) or one
    per utterance ``[..., F, C]``.  Per frame and bin::

        W = clip( (2/(C-1)) * num / sum_i phi_ii, 1e-4, 1 )
        num = max(Re(sum_{i<j} phi_ij), 0)  [REAL]  |  |sum_{i<j} phi_ij|  [ABS]

    applied from frame ``min_frames + 1`` on (the reference's NO_USE gate
    reads the pre-increment frame counter, postfilter.cc:468-473).
    """
    real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
    phi_pair = phi_diag = None
    outs = []
    for t in range(X.shape[0]):
        phi_pair, phi_diag, W = zelinski_step(phi_pair, phi_diag, _time_align(wq, X[t]), t,
                                              alpha, real_mode)
        outs.append(Y[t] * W if t > min_frames else Y[t])
    return torch.stack(outs, dim=0)


def zelinski_args(C: int, alpha: float, pf_type: int, min_frames: int) -> tuple:
    """The Zelinski arguments the CUDA entry points take: alpha, 1 - alpha,
    the gain 2 / (C - 1), the spectral floor, the REAL flag, min_frames."""
    return (alpha, 1.0 - alpha, 2.0 / (C - 1.0), SPECTRAL_FLOOR,
            int(bool(pf_type & PostFilterType.ZELINSKI1_REAL)), min_frames)


def _clamp_Rij_mccowan(Rij: torch.Tensor, threshold: float) -> torch.Tensor:
    """McCowan R_ij clamp (postfilter.cc:816-819): if Re > threshold and
    Im <= 0, replace by the real threshold."""
    cond = (Rij.real > threshold) & (Rij.imag <= 0.0)
    return torch.where(cond, torch.full_like(Rij, threshold), Rij)


def _clamp_Rij_lefk(Rij: torch.Tensor, threshold: float) -> torch.Tensor:
    """Lefkimmiatis noise-PSD clamp (postfilter.cc:1082-1087)."""
    out = torch.where(Rij.real > threshold, torch.full_like(Rij, threshold), Rij)
    return torch.where(Rij.real == 1.0, torch.full_like(Rij, 0.99), out)


def _pairs(C: int) -> list[tuple[int, int]]:
    return [(i, j) for i in range(C) for j in range(i + 1, C)]


def coherence_constants(
    kind: str,
    Gamma: torch.Tensor,
    wq: torch.Tensor,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    threshold_Rij: float = 0.99,
    min_sv: float = 1.0e-8,
    fbin_no1: int = 128,
) -> torch.Tensor | None:
    """The per-bin constants through which the McCowan (``kind``
    "mccowan") and Lefkimmiatis ("lefkimmiatis") postfilters read the noise
    coherence ``Gamma [F, C, C]``, float32 rows ``[K, F]`` over the channel
    pairs p = (i, j), i < j, in order:

    - rows p, NP + p: ``0.5 Rc_p`` and ``1 / (1 - Rc_p)``, Rc McCowan's clamp
      of ``Gamma`` (NP = C (C - 1) / 2);
    - Lefkimmiatis also rows 2 NP + p, ``1 / (1 - Rn_p)`` with Rn its noise
      clamp, and a last row ``Lambda``: ``d^H Gamma^+ d`` of the manifold
      ``wq [F, C]`` (its real part in REAL mode, its modulus in ABS mode)
      from bin ``fbin_no1`` on, 1 below, where it is not used.

    None for "apab", which reads no coherence.  The coherence must be real
    (the diffuse field's, the only one the JAX pipeline builds): the
    constants have no imaginary part."""
    if kind == "apab":
        return None
    if kind not in COHERENCE_POSTFILTERS:
        raise ValueError(f"unknown coherence postfilter {kind!r}")
    Gamma = Gamma.to(torch.complex64)
    if bool((Gamma.imag != 0).any()):
        raise ValueError("the coherence Gamma must be real (a diffuse noise field)")
    F, C, _ = Gamma.shape
    I, J = (list(ix) for ix in zip(*_pairs(C)))
    one = torch.ones((), dtype=torch.complex64, device=Gamma.device)
    Rc = _clamp_Rij_mccowan(Gamma, threshold_Rij)[:, I, J].T  # [NP, F]
    rows = [0.5 * Rc.real, (one / (1.0 - Rc)).real]
    if kind == "lefkimmiatis":
        Rn = _clamp_Rij_lefk(Gamma, threshold_Rij)[:, I, J].T
        lam = torch.ones(1, F, device=Gamma.device)
        if fbin_no1 < F:
            g = noise_coherence_gain(Gamma[fbin_no1:], wq.to(torch.complex64)[fbin_no1:], min_sv)
            real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)
            lam[0, fbin_no1:] = g.real if real_mode else torch.abs(g)
        rows += [(one / (1.0 - Rn)).real, lam]
    return torch.cat(rows).to(torch.float32).contiguous()


def _ema(seq: torch.Tensor, alpha: float) -> torch.Tensor:
    """The JAX package's ``_ema_scan`` as a loop over frames (axis 0):
    ``s_t = x_t`` for the first two frames, then ``alpha s_{t-1} + (1 -
    alpha) x_t`` (the reference's pre-increment frame counter,
    postfilter.cc:424-463); the series itself where ``alpha <= 0``."""
    if alpha <= 0.0:
        return seq
    outs, s = [], None
    for t in range(seq.shape[0]):
        s = seq[t] if t < 2 else alpha * s + (1.0 - alpha) * seq[t]
        outs.append(s)
    return torch.stack(outs, dim=0)


def _gate(W: torch.Tensor, min_frames: int) -> torch.Tensor:
    """The reference's pre-increment frame gate: the weight applies from
    frame ``min_frames + 1`` on (postfilter.cc:889, 1148), 1 before."""
    t = torch.arange(W.shape[0], device=W.device).reshape((-1,) + (1,) * (W.ndim - 1))
    return torch.where(t > min_frames, W, torch.ones_like(W))


def _apab(Y: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """APAB's gain on ``Y`` against the reference ``ref``: ``clip(|Y|^2 /
    |ref|^2, -1, 1)``, 1 where ``|ref|^2`` is 0 (the reference's 0 / 0 is
    NaN) and at the Nyquist bin (the last)."""
    phi_xx = torch.abs(ref) ** 2
    pos = phi_xx > 0
    one = torch.ones_like(phi_xx)
    W = torch.where(pos, torch.abs(Y) ** 2 / torch.where(pos, phi_xx, one), one).clamp(-1.0, 1.0)
    nyquist = torch.arange(W.shape[-1], device=W.device) == W.shape[-1] - 1
    return Y * torch.where(nyquist, one, W)


def coherence_apply(
    kind: str,
    X: torch.Tensor,
    Y: torch.Tensor,
    wq: torch.Tensor,
    consts: torch.Tensor | None,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
) -> torch.Tensor:
    """The McCowan, Lefkimmiatis or APAB postfilter (``kind``) on a
    beamformed signal: ``X`` complex snapshots ``[T, ..., F, C]``, ``Y`` the
    beamformer's output ``[T, ..., F]``, ``wq`` the alignment manifold ``[F,
    C]`` (the C++ ``ta_``), ``consts`` the `coherence_constants` of the same
    kind (None for APAB).  Returns the filtered ``[T, ..., F]``.

    With a = conj(wq) X, d_i = |a_i|^2, the pair series, smoothed as the
    JAX package's ``_ema_scan`` smooths them, are::

        McCowan / Lefkimmiatis ss:  sum_p (a_i conj(a_j) - 0.5 Rc_p (d_i + d_j)) / (1 - Rc_p)
        Lefkimmiatis vv:            sum_p (0.5 (d_i + d_j) - a_i conj(a_j)) / (1 - Rn_p)

    (each division a product with the constant reciprocal), and with v the
    real part (REAL) or modulus (ABS) of a smoothed series:

        McCowan       W = clip((2 v(ss) / (C (C-1))) / (sum_i d_i / C)_smoothed, 1e-4, 1)
        Lefkimmiatis  W = clip(s / (s + n), 1e-4, 1),  s = v(ss) k,  n = v(vv) k / Lambda
        APAB          W = clip(|Y|^2 / |sum_c a_c|^2, -1, 1), 1 where the reference is 0
                      and at the Nyquist bin

    with k = 2 / (C (C-1)); McCowan and Lefkimmiatis apply W from frame
    ``min_frames + 1`` on, APAB from the first and ignores ``alpha``,
    ``pf_type`` and ``min_frames``.  Like the JAX functions, McCowan and
    Lefkimmiatis have no guard for a silent bin: 0 / 0 gives NaN."""
    C = X.shape[-1]
    al = torch.conj(wq) * X
    if kind == "apab":
        return _apab(Y, sum(al[..., c] for c in range(C)))
    lefk = kind == "lefkimmiatis"
    pairs = _pairs(C)
    NP = len(pairs)
    d = torch.abs(al) ** 2
    ss = vv = 0
    for p, (i, j) in enumerate(pairs):
        cross = al[..., i] * torch.conj(al[..., j])
        dsum = d[..., i] + d[..., j]
        ss = ss + (cross - consts[p] * dsum) * consts[NP + p]
        if lefk:
            vv = vv + (0.5 * dsum - cross) * consts[2 * NP + p]
    real_mode = bool(pf_type & PostFilterType.ZELINSKI1_REAL)

    def value(s):
        return torch.real(s) if real_mode else torch.abs(s)

    if lefk:
        norm = 2.0 / (C * (C - 1.0))
        phi_ss = value(_ema(ss, alpha)) * norm
        phi_nn = value(_ema(vv, alpha)) * norm / consts[3 * NP]
        W = phi_ss / (phi_ss + phi_nn)
    else:
        nu = 2.0 * value(_ema(ss, alpha)) / (C * (C - 1.0))
        W = nu / _ema(torch.sum(d, dim=-1) / C, alpha)
    return Y * _gate(torch.clamp(W, SPECTRAL_FLOOR, 1.0), min_frames)


def mccowan_postfilter(
    X: torch.Tensor,
    Y: torch.Tensor,
    wq: torch.Tensor,
    Gamma: torch.Tensor,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
    threshold_Rij: float = 0.99,
) -> torch.Tensor:
    """McCowan postfilter (McCowanPostFilter, postfilter.cc:843-901): X
    ``[T, ..., F, C]``, Y ``[T, ..., F]``, the manifold ``wq [F, C]`` and a
    real coherence ``Gamma [F, C, C]``; see `coherence_apply`."""
    consts = coherence_constants("mccowan", Gamma, wq, pf_type, threshold_Rij)
    return coherence_apply("mccowan", X, Y, wq, consts, alpha, pf_type, min_frames)


def lefkimmiatis_postfilter(
    X: torch.Tensor,
    Y: torch.Tensor,
    wq: torch.Tensor,
    Gamma: torch.Tensor,
    alpha: float = 0.6,
    pf_type: int = PostFilterType.ZELINSKI1_REAL,
    min_frames: int = 0,
    threshold_Rij: float = 0.99,
    min_sv: float = 1.0e-8,
    fbin_no1: int = 128,
) -> torch.Tensor:
    """Lefkimmiatis Wiener postfilter with the diffuse-field noise PSD
    estimate (LefkimmiatisPostFilter::post_filtering_,
    postfilter.cc:1098-1161): from bin ``fbin_no1`` on the noise PSD is
    scaled by ``1 / Lambda``, ``Lambda = d^H Gamma^+ d``
    (`beamforming.noise_coherence_gain`); see `coherence_apply`."""
    consts = coherence_constants("lefkimmiatis", Gamma, wq, pf_type, threshold_Rij, min_sv,
                                 fbin_no1)
    return coherence_apply("lefkimmiatis", X, Y, wq, consts, alpha, pf_type, min_frames)


def apab_postfilter(X: torch.Tensor, Y: torch.Tensor, wq: torch.Tensor,
                    channel: int = -1) -> torch.Tensor:
    """Adaptive post-filter for arbitrary beamformers (ApabFilter,
    postfilter.cc:224-330): ``W = clip(|Y|^2 / |x_ref|^2, -1, 1)`` with
    ``x_ref`` the D&S output ``sum_c conj(wq_c) X_c`` (``channel < 0``, the
    pipeline's) or one aligned channel; the Nyquist bin passes unchanged,
    as the reference computes weights below M/2 only."""
    if channel < 0:
        return coherence_apply("apab", X, Y, wq, None)
    return _apab(Y, torch.conj(wq[..., channel]) * X[..., channel])
