"""Nyquist(M) filterbank prototype design.

Offline (numpy, float64) design of analysis/synthesis prototypes for the
oversampled DFT filterbank by minimization of individual aliasing terms
(Kumatani et al., ICASSP 2008/2018; reference implementation:
tools/filterbank/design_nyquist_filter.py).

Analysis: minimize the inband aliasing quadratic ``h^T C h`` subject to the
Nyquist(M) constraint ``h[kM] = 0 for kM != md`` — either the smallest
eigenvector of the reduced C (full rank) or a null-space-constrained
passband least squares.

Synthesis: minimize residual aliasing ``g^T P g`` subject to the perfect
reconstruction constraints ``H g = c0`` via Lagrange multipliers (or the
null space of P when singular).
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "design_nyquist_analysis",
    "design_nyquist_synthesis",
    "design_nyquist_pair",
]


def _sinc_ratio(x: np.ndarray) -> np.ndarray:
    """sin(x)/x with the x=0 limit."""
    out = np.ones_like(x)
    nz = x != 0
    out[nz] = np.sin(x[nz]) / x[nz]
    return out


def _alias_factor(lags: np.ndarray, D: int) -> np.ndarray:
    """(D-1) on multiples of D, -1 elsewhere — the inband aliasing weighting."""
    return np.where(lags % D == 0, float(D - 1), -1.0)


def design_nyquist_analysis(M: int, m: int, D: int, wp_factor: float = 1.0):
    """Design the analysis prototype ``h`` of length ``L = M*m``.

    Returns ``(h [L], inband_aliasing_error)``.
    """
    L = M * m
    md = L // 2 if m != 1 else 0  # group-delay tap pinned to the constraint
    tau_h = L // 2
    w_p = np.pi / (wp_factor * M)

    i = np.arange(L)[:, None]
    j = np.arange(L)[None, :]
    lag = j - i

    factor = _alias_factor(lag, D)
    # Inband aliasing quadratic form.
    C = np.where(
        lag == 0,
        factor / D,
        factor * np.divide(np.sin(np.pi * lag / D), np.pi * np.where(lag == 0, 1, lag)),
    )
    # Passband response quadratic form and linear term.
    A = _sinc_ratio(w_p * lag.astype(np.float64))
    b = _sinc_ratio(w_p * (tau_h - np.arange(L)).astype(np.float64))

    # Free coefficients: k == md or k not a multiple of M.
    free = np.array([(k == md) or (k % M != 0) for k in range(L)])
    Cf = C[np.ix_(free, free)]
    Af = A[np.ix_(free, free)]
    bf = b[free]

    if np.linalg.matrix_rank(Cf) == Cf.shape[0]:
        # Full rank: the aliasing-minimal direction is the smallest eigenvector.
        w, v = np.linalg.eigh(Cf)
        rh = v[:, np.argmin(w)]
        # The eigenvector's sign is arbitrary; canonicalize to positive DC
        # gain (matches the prototypes shipped with the reference).
        if rh.sum() < 0:
            rh = -rh
    else:
        # Singular: restrict the passband LS problem to the null space of C.
        _, s, vh = np.linalg.svd(Cf)
        tol = max(Cf.shape) * s.max() * np.finfo(np.float64).eps
        null = vh[s.size - (s <= tol).sum():].conj().T if (s <= tol).any() else None
        rank = int((s > tol).sum())
        null = vh[rank:].conj().T
        if null.shape[1] == 0:
            raise ArithmeticError("no null-space basis for the aliasing form")
        T1 = Af @ null
        T2 = null.T @ T1
        if np.linalg.matrix_rank(T2) == T2.shape[0]:
            x = np.linalg.solve(T2, null.T @ bf)
        else:
            x = np.linalg.pinv(T1) @ bf
        rh = null @ x

    h = np.zeros(L)
    h[free] = np.real(rh)
    beta = float(h @ C @ h)
    return h, beta


def design_nyquist_synthesis(h: np.ndarray, M: int, m: int, D: int):
    """Design the synthesis prototype ``g`` for a given analysis prototype.

    Returns ``(g [L], residual_aliasing)``.
    """
    h = np.asarray(h, np.float64).ravel()
    L_h = len(h)
    L_g = M * m
    md = L_h // 2 if m != 1 else 0
    tau_t = md + L_g // 2  # total analysis+synthesis group delay

    idx = np.arange(L_g)
    lag = idx[None, :] - idx[:, None]  # j - i

    # Residual aliasing form P[i,j] = factor(i-j) * autocorr_h(i-j).
    acorr = np.correlate(h, h, mode="full")  # lags -(L_h-1)..(L_h-1)

    def acorr_at(lags):
        out = np.zeros(lags.shape)
        valid = np.abs(lags) <= L_h - 1
        out[valid] = acorr[lags[valid] + L_h - 1]
        return out

    P = _alias_factor(idx[:, None] - idx[None, :], D) * acorr_at(lag) * (M / float(D * D))

    # PR constraints: rows are M-shifted time-reversed copies of h.
    rows = 2 * m - 1
    H = np.zeros((rows, L_g))
    for r_ in range(rows):
        src = (r_ + 1) * M - 1 - idx  # h index per column
        valid = (src >= 0) & (src < L_h)
        H[r_, valid] = h[src[valid]]
    c0 = np.zeros(rows)
    c0[m - 1] = D / float(M)

    if np.linalg.matrix_rank(P) == L_g:
        invP = np.linalg.inv(P)
        HPH = H @ invP @ H.T
        g = invP @ H.T @ np.linalg.solve(HPH, c0)
    else:
        _, s, vh = np.linalg.svd(P)
        tol = L_g * s.max() * np.finfo(np.float64).eps
        rank = int((s > tol).sum())
        if rank <= L_g - rows:
            null = vh[rank:].conj().T
            y = np.linalg.pinv(H @ null) @ c0
            g = null @ y
        else:
            pnull = vh[L_g - rows:].conj().T
            y = np.linalg.solve(H @ pnull, c0)
            g = pnull @ y

    epsir = float(g @ P @ g)
    return g, epsir


def design_nyquist_pair(M: int, m: int, r: int, wp_factor: float = 1.0):
    """Design (h, g) for a (M, m, r) filterbank configuration."""
    D = max(M >> r, 1)
    h, _ = design_nyquist_analysis(M, m, D, wp_factor)
    g, _ = design_nyquist_synthesis(h, M, m, D)
    return h, g
