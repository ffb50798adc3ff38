"""The PyTorch port's echo cancellers against the JAX package's.

The port's plain loops `models.aec.nlms_aec` / `kalman_aec` /
`block_kalman_aec` (one and three taps) and the packed wrapper
`ops.aec_kernels.aec_scan` (its plain version on the CPU; the block Kalman
at one tap) take the same numpy frames as JAX's ``models/aec.py`` scans
(XLA, CPU): one far-end reference ``V [T, B, 1, F]`` against mic frames ``A
[T, B, C, F]``.  Some far-end bins are zero or below the gate threshold, so
the guarded quotient and a closed gate are exercised.  Budget 1e-4 x
max|ref|, the JAX package's Pallas-vs-XLA AEC budget
(tests/test_pallas_aec.py); the block Kalman measured 8.2e-6 (one tap) and
1.7e-6 (three) x max|E| from JAX before it was set.
"""

import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import aec as j_aec
from distant_speech_recognition_tpu_torch.models import aec as t_aec
from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_scan

BUDGET = 1e-4
KINDS = [("nlms", 100.0, 1e-4), ("kalman", 0.95, 1e-3)]
# beta, sigmau2 of the block Kalman (the JAX package's test values; sigmak2 its default)
BLOCK = (0.95, 1e-3)


def _frames(seed, T=40, B=2, C=4, F=129):
    rng = np.random.default_rng(seed)

    def cplx(*shape):
        return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 30).astype(
            np.complex64)

    V, A = cplx(T, B, 1, F), cplx(T, B, C, F)
    V[:, 0, 0, 5:9] = 0  # |V| = 0: the guarded quotient
    V[10:20, 1, 0, 20:40] *= np.float32(0.1)  # |V|^2 < threshold: the gate closes
    # DC and Nyquist have no Im lane in the packed layout
    for Z in (V, A):
        Z.imag[..., 0] = 0
        Z.imag[..., -1] = 0
    return V, A


def _pack(X):
    F = X.shape[-1]
    return np.concatenate([X.real, X.imag[..., 1:F - 1]], axis=-1).astype(np.float32)


def _check(got, want):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BUDGET * np.abs(want).max())


@pytest.mark.parametrize("kind,p1,p2", KINDS)
def test_scan_matches_jax(kind, p1, p2):
    V, A = _frames(0)
    E_j, R_j = getattr(j_aec, f"{kind}_aec")(V, A, p1, p2, 100.0)
    E_t, R_t = getattr(t_aec, f"{kind}_aec")(torch.from_numpy(V), torch.from_numpy(A), p1, p2,
                                              100.0)
    _check(E_t.numpy(), np.asarray(E_j))
    _check(R_t.numpy(), np.asarray(R_j))


@pytest.mark.parametrize("kind,p1,p2", KINDS)
def test_packed_aec_scan_matches_jax_on_unpacked_frames(kind, p1, p2):
    V, A = _frames(1, T=30, B=3, C=2)
    E_j, _ = getattr(j_aec, f"{kind}_aec")(V, A, p1, p2, 100.0)
    for Vp in (_pack(V)[:, :, 0, :], _pack(V)):  # [Tf, B, M] and [Tf, B, 1, M]
        got = aec_scan(torch.from_numpy(_pack(A)), torch.from_numpy(Vp), kind, p1, p2, 100.0)
        _check(got.numpy(), _pack(np.asarray(E_j)))


@pytest.mark.parametrize("taps", [1, 3])
def test_block_kalman_matches_jax(taps):
    V, A = _frames(2)
    E_j, R_j = j_aec.block_kalman_aec(V, A, taps, *BLOCK)
    E_t, R_t = t_aec.block_kalman_aec(torch.from_numpy(V), torch.from_numpy(A), taps, *BLOCK)
    _check(E_t.numpy(), np.asarray(E_j))
    _check(R_t.numpy(), np.asarray(R_j))


def test_play_taps_match_jax():
    V, _ = _frames(4, T=9)
    want = j_aec.play_taps(V, 3, 0.5)
    np.testing.assert_array_equal(t_aec.play_taps(torch.from_numpy(V), 3, 0.5).numpy(),
                                  np.asarray(want))


def test_packed_aec_scan_block_kalman_matches_jax_on_unpacked_frames():
    V, A = _frames(3, T=30, B=3, C=2)
    E_j, _ = j_aec.block_kalman_aec(V, A, 1, *BLOCK)
    for Vp in (_pack(V)[:, :, 0, :], _pack(V)):  # [Tf, B, M] and [Tf, B, 1, M]
        got = aec_scan(torch.from_numpy(_pack(A)), torch.from_numpy(Vp), "block_kalman", *BLOCK,
                       100.0)
        _check(got.numpy(), _pack(np.asarray(E_j)))


def test_aec_scan_rejects_what_it_does_not_take():
    A = torch.zeros((4, 2, 3, 16))
    with pytest.raises(NotImplementedError, match="dtd_block_kalman"):
        aec_scan(A, torch.zeros((4, 2, 16)), "dtd_block_kalman")
    with pytest.raises(ValueError, match="Vp"):
        aec_scan(A, torch.zeros((4, 3, 16)))
    with pytest.raises(ValueError, match="Ap"):
        aec_scan(A[0], torch.zeros((4, 2, 16)))
