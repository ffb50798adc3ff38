"""Filterbank prototype loading/saving (numpy, host side).

The reference ships pre-designed Nyquist(M) prototypes as numpy pickles
``h/g-M{M}-m{m}-r{r}.pickle`` (unit_test/prototype.ny/) written by
tools/filterbank/design_nyquist_filter.py.  This module loads those files by
(M, m, r) convention from a caller-given directory, and designs the pair
when no directory is given or the files are missing.
"""

from __future__ import annotations

import os
import pickle

import numpy as np

__all__ = ["load_prototype", "save_prototype", "prototype_path", "load_pair"]


def load_prototype(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        try:
            v = pickle.load(f)
        except UnicodeDecodeError:
            f.seek(0)
            v = pickle.load(f, encoding="latin1")
    return np.asarray(v, dtype=np.float64)


def save_prototype(path: str, proto: np.ndarray) -> None:
    with open(path, "wb") as f:
        pickle.dump(np.asarray(proto, dtype=np.float64), f, protocol=2)


def prototype_path(kind: str, M: int, m: int, r: int, proto_dir: str) -> str:
    """``kind`` is 'h' (analysis) or 'g' (synthesis)."""
    return os.path.join(proto_dir, f"{kind}-M{M}-m{m}-r{r}.pickle")


def load_pair(M: int, m: int, r: int, proto_dir: str | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Load (h, g) prototypes for a configuration from ``proto_dir``,
    designing them on the fly if no directory is given or no pickle exists
    for this (M, m, r).

    Unlike the JAX package's ``load_pair``, which defaults to the reference
    checkout's prototype directory, this one reads no directory unless it
    is given one.  The designed pair differs from the shipped pickles, so
    pass the shipped pickles' ``proto_dir`` to get the JAX package's
    prototypes where they exist."""
    if proto_dir is not None:
        try:
            h = load_prototype(prototype_path("h", M, m, r, proto_dir))
            g = load_prototype(prototype_path("g", M, m, r, proto_dir))
            return h, g
        except FileNotFoundError:
            pass
    from ..design.nyquist import design_nyquist_pair

    return design_nyquist_pair(M, m, r)
