"""WPE stages as hand-written CUDA kernels, with their plain versions.

Counterpart of the JAX package's ``ops/pallas_wpe.py``:

- `wpe_stats` replaces ``wpe_stats_pallas`` / ``wpe_stats_from_planes``
  (``csrc/wpe_stats.cu``): the normal equations of one EM iteration;
- `wpe_resid` replaces ``wpe_resid_pallas`` / ``wpe_resid_from_planes``
  (``csrc/wpe_resid.cu``): the prediction residual, which is the WPE output
  when given the final filters;
- `gj_solve` replaces ``gj_solve_pallas`` (``csrc/gj_solve.cu``): the
  batched Gauss-Jordan solve of those equations.

For a CUDA tensor each wrapper launches its kernel or raises; for a CPU
tensor it runs the plain torch version beside it (`stats_plain`,
`resid_plain`, `gj_solve_plain`), the specification the kernel is held to.
The stats and the residual read and write the packed time-major frames
``[Tf, B, C, M]`` (``[Re(0..M/2) | Im(1..M/2-1)]`` lanes) of the chain.

Conventions (reference: dereverberation.cc), per (utterance, bin):
  lags      L_t[j]  = y_a[t - lowerN - dp],  j = a*P + dp  (zero history)
  residual  e_c[t]  = y_c[t] - (t >= lowerN) conj(G[c]) . L_t
  weights   w_c[t]  = 1/max(|e_c[t]|, 1e-3)^2 on lowerN <= t < T, else 0
  stats     R[c,p,q] = sum_t w_c L_t[p] conj(L_t[q]),
            r[c,p]   = sum_t w_c conj(y_c) L_t[p]

The residual that sets the weights is evaluated in float64 and rounded to
float32 (the sums stay float32): where a prediction cancels its target to a
fraction of a percent, as it does on real frames, 1/|e|^2 amplifies the
rounding of a float32 prediction so far that two float32 evaluations of R
differ by ~0.3% of max|R|.  The JAX package evaluates it in float32.
"""

from __future__ import annotations

import torch

from .filterbank import pack_half, unpack_half

__all__ = [
    "SUBBAND_FLOOR",
    "WPE_MAX_CP",
    "WPE_MAX_LOWER",
    "WPE_MAX_CHANNELS",
    "wpe_supported",
    "lag_tensor",
    "stats_plain",
    "resid_plain",
    "gj_solve_plain",
    "wpe_stats",
    "wpe_resid",
    "gj_solve",
]

SUBBAND_FLOOR = 1.0e-3  # dereverberation.cc:144
# What the three kernels take: C*P prediction taps per target (K10's 4x4
# tiles, K11's registers; K12 solves n <= 31), up to 8 channels (K11: one
# warp per channel), and lowerN + P - 1 frames of lag history in shared memory.
WPE_MAX_CP = 24
WPE_MAX_CHANNELS = 8
WPE_MAX_LOWER = 32
# utterances per step of the plain versions: bounds their lag tensors
_CHUNK = 16


def wpe_supported(C: int, P: int, lowerN: int) -> bool:
    """Whether the CUDA kernels take ``C`` channels, ``P`` taps and delay ``lowerN``."""
    return 1 <= C <= WPE_MAX_CHANNELS and P >= 1 and C * P <= WPE_MAX_CP and (
        0 <= lowerN <= WPE_MAX_LOWER
    )


def lag_tensor(Y: torch.Tensor, lowerN: int, P: int) -> torch.Tensor:
    """Stacked lag windows ``L[..., t, f, p] = Y[..., t - lowerN - p, f]``
    (zero history): ``Y [..., T, F] -> [..., T, F, P]``."""
    T = Y.shape[-2]
    pad = Y.new_zeros(Y.shape[:-2] + (lowerN + P - 1, Y.shape[-1]))
    Yp = torch.cat([pad, Y], dim=-2)
    return torch.stack([Yp[..., P - 1 - p : P - 1 - p + T, :] for p in range(P)], dim=-1)


def _stacked_lags(X: torch.Tensor, lowerN: int, P: int) -> torch.Tensor:
    """``X [b, C, T, F] -> L [b, T, F, C*P]`` with lag index ``a*P + dp``."""
    b, C, T, F = X.shape
    return lag_tensor(X, lowerN, P).permute(0, 2, 3, 1, 4).reshape(b, T, F, C * P)


def _predict(X, G, L, lowerN):
    """``X - (t >= lowerN) conj(G) . L`` for ``X [b, C, T, F]``, ``G [b, C, F, CP]``."""
    pred = torch.einsum("bcfp,btfp->bctf", torch.conj(G), L)
    valid = (torch.arange(X.shape[2], device=X.device) >= lowerN)[:, None]
    return X - torch.where(valid, pred, torch.zeros_like(pred))


def stats_plain(X: torch.Tensor, G: torch.Tensor, lowerN: int, P: int, has_g: bool = True):
    """Plain version of `wpe_stats` on complex frames ``X [B, C, T, F]`` and
    filters ``G [B, C, F, C*P]`` (unread when ``has_g`` is false: the first
    EM iteration, G = 0).  Returns ``(R [B, C, F, CP, CP], r [B, C, F, CP])``."""
    T = X.shape[2]
    valid = (torch.arange(T, device=X.device) >= lowerN)[:, None]
    Rs, rs = [], []
    for b0 in range(0, X.shape[0], _CHUNK):
        Xc = X[b0 : b0 + _CHUNK]
        L = _stacked_lags(Xc, lowerN, P)
        resid = Xc
        if has_g:  # in float64, rounded back: see the module docstring
            wide = torch.complex128
            resid = _predict(Xc.to(wide), G[b0 : b0 + _CHUNK].to(wide), L.to(wide),
                             lowerN).to(X.dtype)
        theta = torch.clamp(torch.abs(resid), min=SUBBAND_FLOOR) ** 2
        w = torch.where(valid, 1.0 / theta, torch.zeros_like(theta))  # [b, C, T, F]
        Lw = w[..., None] * L[:, None]
        Rs.append(torch.einsum("bctfp,btfq->bcfpq", Lw, torch.conj(L)))
        rs.append(torch.einsum("bctf,btfp->bcfp", w * torch.conj(Xc), L))
    return torch.cat(Rs), torch.cat(rs)


def resid_plain(X: torch.Tensor, G: torch.Tensor, lowerN: int) -> torch.Tensor:
    """Plain version of `wpe_resid` on complex frames ``X [B, C, T, F]``
    with ``G [B, C, F, C*P]``: returns ``[B, C, T, F]``."""
    P = G.shape[-1] // X.shape[1]
    return torch.cat([
        _predict(X[b0 : b0 + _CHUNK], G[b0 : b0 + _CHUNK],
                 _stacked_lags(X[b0 : b0 + _CHUNK], lowerN, P), lowerN)
        for b0 in range(0, X.shape[0], _CHUNK)
    ])


def gj_solve_plain(R: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Batched solve ``R x = r`` by Gauss-Jordan elimination without row
    swaps: ``R [..., n, n]``, ``r [..., n] -> [..., n]``.  Diagonal pivoting
    is safe for the diagonally loaded Hermitian positive-definite systems
    WPE builds; a zero pivot divides by 1, as the CUDA kernel does."""
    n = R.shape[-1]
    A = torch.cat([R, r[..., None]], dim=-1)  # [..., n, n+1]
    for k in range(n):
        p = A[..., k, k]
        den = p.real**2 + p.imag**2
        den = torch.where(den > 0, den, torch.ones_like(den))
        piv = (A[..., k, :] * torch.conj(p)[..., None]) / den[..., None]
        A = A - A[..., :, k : k + 1] * piv[..., None, :]
        A[..., k, :] = piv
    return A[..., :, n]


def _frames(Yp: torch.Tensor) -> torch.Tensor:
    """Packed ``[Tf, B, C, M]`` -> complex ``[B, C, Tf, F]``."""
    return unpack_half(Yp).permute(1, 2, 0, 3)


def _check_G(G: torch.Tensor, B: int, C: int, F: int, P: int | None = None) -> int:
    if G.dim() != 4 or tuple(G.shape[:3]) != (B, C, F) or G.shape[3] % C:
        raise ValueError(f"G must be [B, C, F, C*P] with (B, C, F) = {(B, C, F)}, "
                         f"got {tuple(G.shape)}")
    if P is not None and G.shape[3] != C * P:
        raise ValueError(f"G has {G.shape[3]} taps per target, expected C*P = {C * P}")
    if G.dtype != torch.complex64:
        raise ValueError(f"G must be complex64, got {G.dtype}")
    return G.shape[3] // C


def _complex_view(name: str, t: torch.Tensor) -> torch.Tensor:
    """Validated float32 view of a contiguous complex64 CUDA tensor."""
    from ..kernels import check_cuda_tensor

    if t.dtype != torch.complex64:
        raise ValueError(f"{name} must be complex64, got {t.dtype}")
    v = torch.view_as_real(t.resolve_conj().contiguous())
    check_cuda_tensor(name, v)
    return v


def wpe_stats(Yp: torch.Tensor, G: torch.Tensor, lowerN: int, P: int, has_g: bool = True):
    """Normal-equation stats of one WPE EM iteration from the packed frames
    ``Yp [Tf, B, C, M]`` (float32) and the current filters ``G [B, C, F,
    C*P]`` (complex64; unread when ``has_g`` is false).  Returns complex64
    ``(R [B, C, F, CP, CP], r [B, C, F, CP])``."""
    if Yp.dim() != 4:
        raise ValueError(f"Yp must be [Tf, B, C, M], got {tuple(Yp.shape)}")
    Tf, B, C, M = Yp.shape
    F = M // 2 + 1
    _check_G(G, B, C, F, P)
    if Yp.device.type == "cpu":
        return stats_plain(_frames(Yp), G, lowerN, P, has_g)
    if Yp.device.type != "cuda":
        raise ValueError(f"wpe_stats runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    Gv = _complex_view("G", G)
    CP = C * P
    R = torch.empty((B, C, F, CP, CP), dtype=torch.complex64, device=Yp.device)
    r = torch.empty((B, C, F, CP), dtype=torch.complex64, device=Yp.device)
    code = _build.library().dsr_wpe_stats(
        Yp.data_ptr(), Gv.data_ptr(), R.data_ptr(), r.data_ptr(), Tf, B, C, M, P, lowerN,
        int(bool(has_g)), stream_handle(Yp.device),
    )
    _build.check(code, "wpe_stats")
    wpe_stats.launches += 1
    return R, r


wpe_stats.launches = 0


def wpe_resid(Yp: torch.Tensor, G: torch.Tensor, lowerN: int) -> torch.Tensor:
    """``y - (t >= lowerN) conj(G) . lags`` on the packed frames ``Yp [Tf, B,
    C, M]`` with ``G [B, C, F, C*P]`` (complex64, applied as given: the
    caller truncates taps and masks bands).  Returns packed ``[Tf, B, C, M]``."""
    if Yp.dim() != 4:
        raise ValueError(f"Yp must be [Tf, B, C, M], got {tuple(Yp.shape)}")
    Tf, B, C, M = Yp.shape
    P = _check_G(G, B, C, M // 2 + 1)
    if Yp.device.type == "cpu":
        return pack_half(resid_plain(_frames(Yp), G, lowerN).permute(2, 0, 1, 3))
    if Yp.device.type != "cuda":
        raise ValueError(f"wpe_resid runs on cpu or cuda tensors, got {Yp.device}")
    from ..kernels import _build, check_cuda_tensor, stream_handle

    Yp = Yp.contiguous()
    check_cuda_tensor("Yp", Yp)
    Gv = _complex_view("G", G)
    out = torch.empty_like(Yp)
    code = _build.library().dsr_wpe_resid(
        Yp.data_ptr(), Gv.data_ptr(), out.data_ptr(), Tf, B, C, M, P, lowerN,
        stream_handle(Yp.device),
    )
    _build.check(code, "wpe_resid")
    wpe_resid.launches += 1
    return out


wpe_resid.launches = 0


def gj_solve(R: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Batched complex solve ``R x = r`` by Gauss-Jordan elimination without
    row swaps: ``R [..., n, n]``, ``r [..., n]`` complex64 -> ``[..., n]``."""
    n = R.shape[-1]
    if R.dim() < 2 or R.shape[-2] != n or tuple(r.shape) != tuple(R.shape[:-1]):
        raise ValueError(f"need R [..., n, n] and r [..., n], got {tuple(R.shape)}, "
                         f"{tuple(r.shape)}")
    if R.device.type == "cpu":
        return gj_solve_plain(R, r)
    if R.device.type != "cuda":
        raise ValueError(f"gj_solve runs on cpu or cuda tensors, got {R.device}")
    from ..kernels import _build, stream_handle

    Rv = _complex_view("R", R)
    rv = _complex_view("r", r)
    x = torch.empty(r.shape, dtype=torch.complex64, device=R.device)
    N = r.numel() // n
    code = _build.library().dsr_gj_solve(Rv.data_ptr(), rv.data_ptr(), x.data_ptr(), N, n,
                                         stream_handle(R.device))
    _build.check(code, "gj_solve")
    gj_solve.launches += 1
    return x


gj_solve.launches = 0
