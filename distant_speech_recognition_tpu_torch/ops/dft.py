"""DFT matrices of the subband transforms (numpy, built once per M).

The filterbanks run their DFTs as dense matrix products against these
matrices, which also fold in the filterbank's modulation conventions:

- analysis (`OverSampledDFTAnalysisBank::next` applies an unnormalized
  backward DFT to the time-REVERSED polyphase FIR output,
  modulated.cc:384-397): the FIR runs on the unreversed stream ``w`` and the
  reversal becomes a per-bin twiddle inside the matrix,
  ``M*ifft(w[::-1])[f] = e^{-2 pi i f/M} * fft(w)[f]``.
- synthesis (`OverSampledDFTSynthesisBank` takes ``Re(fft(Y))`` of the
  conjugate-mirrored spectrum, modulated.cc:556-563): with only bins 0..M/2
  kept, that is one real matrix product.

The packed layout ``[Re(0..M/2) | Im(1..M/2-1)]`` drops the two imaginary
parts that are structurally zero (Im of DC and Nyquist), so both matrices
are square ``[M, M]``.  Arrays returned here are cached and read-only.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "analysis_matrix",
    "analysis_matrix_packed",
    "synthesis_half_matrix",
    "synthesis_half_matrix_packed",
    "segment_reversal_perm",
]


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False
    return a


@lru_cache(maxsize=None)
def analysis_matrix(M: int, half: bool) -> np.ndarray:
    """[M, 2F] real matrix computing ``e^{-2 pi i f/M} * fft(w)[f]`` (the
    reversed-input backward DFT of the analysis bank) as [Re | Im] columns."""
    F = M // 2 + 1 if half else M
    n = np.arange(M)[:, None]
    f = np.arange(F)[None, :]
    ang = 2.0 * np.pi * f * (n + 1) / M  # (n+1): folded e^{-2 pi i f/M} twiddle
    return _frozen(np.concatenate([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32))


@lru_cache(maxsize=None)
def synthesis_half_matrix(M: int) -> np.ndarray:
    """[2F, M] real matrix computing ``M * irfft(conj(Y), n=M)`` — i.e.
    ``Re(fft(mirror(Y)))`` (modulated.cc:556-563) from [Re(Y) | Im(Y)] rows."""
    F = M // 2 + 1
    f = np.arange(F)[:, None]
    n = np.arange(M)[None, :]
    ang = 2.0 * np.pi * f * n / M
    wf = np.full((F, 1), 2.0)
    wf[0] = 1.0
    if M % 2 == 0:
        wf[M // 2] = 1.0
    top = wf * np.cos(ang)   # Re(Y[f]) rows
    bot = wf * np.sin(ang)   # Im(Y[f]) rows (conj folded in)
    return _frozen(np.concatenate([top, bot], axis=0).astype(np.float32))


@lru_cache(maxsize=None)
def analysis_matrix_packed(M: int) -> np.ndarray:
    """[M, M] `analysis_matrix(half=True)` without the two identically-zero
    imaginary columns (``-sin(2 pi f (n+1)/M)`` vanishes for f=0 and
    f=M/2): output lanes ``[Re(0..M/2) | Im(1..M/2-1)]``."""
    F = M // 2 + 1
    A = analysis_matrix(M, half=True)  # [M, 2F]
    return _frozen(np.ascontiguousarray(np.delete(A, [F, F + M // 2], axis=1)))


@lru_cache(maxsize=None)
def synthesis_half_matrix_packed(M: int) -> np.ndarray:
    """[M, M] `synthesis_half_matrix` without the rows of Im(DC) and
    Im(Nyquist) — the parts ``Re(fft(mirror(Y)))`` discards — matching the
    packed ``[Re(0..M/2) | Im(1..M/2-1)]`` lane layout."""
    F = M // 2 + 1
    S = synthesis_half_matrix(M)  # [2F, M]
    return _frozen(np.ascontiguousarray(np.delete(S, [F, F + M // 2], axis=0)))


@lru_cache(maxsize=None)
def segment_reversal_perm(M: int, R: int) -> tuple:
    """Column permutation folding the synthesis overlap-add's per-segment
    sample reversal (modulated.cc:603-606) into the synthesis matrix:
    index ``j*D + i -> j*D + (D-1-i)``."""
    D = M // R
    perm = np.arange(M).reshape(R, D)[:, ::-1].reshape(-1)
    return tuple(perm.tolist())
