"""The port's WPE at BASELINE config 4's 8-channel width against the JAX
package's.

The default taps (``wpe_lower=2``, ``wpe_upper=6``: P = 5) at 8 channels
give C*P = 40 prediction taps per target, the widest the port takes
(`ops.wpe_kernels.WPE_MAX_CP`); C = 5, P = 8 is a second shape past the
earlier limit of 24.  The same numpy frames go through JAX's XLA
``wpe_multichannel`` (CPU) and the port's plain versions: the Gauss-Jordan
solve at n = 40, `wpe_multichannel` per utterance and the chain's packed
batch path `wpe_multichannel_packed_tm`.

Budget 3e-4 x max|ref|, the EM budget of ``tests/test_torch_wpe.py`` (the
JAX package's Pallas-vs-XLA one).  Measured before it was set, against a
float64 evaluation of the same EM (the port's plain versions in complex128),
on three utterances of 150 frames x 65 bins: at C = 8, P = 5 JAX is 1.4e-5
x max|ref| from float64, the port 2.4e-5 and the two 3.4e-5 apart; at C =
5, P = 8 1.3e-5, 1.6e-5 and 9.1e-6; at C = 4, P = 5 (n = 20) 2.9e-6, 3.9e-6
and 2.6e-6.  The unpivoted float32 solve at n = 40 thus parts from float64
by about ten times what it does at n = 20, and JAX and the port stay an
order of magnitude inside the budget; the port is also held to float64.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import dereverberation as j_wpe
from distant_speech_recognition_tpu_torch.models import dereverberation as t_wpe
from distant_speech_recognition_tpu_torch.ops import wpe_kernels

LOWER = 2
BUDGET = 3e-4
T, F = 150, 65  # M = 128
SHAPES = [(8, 5), (5, 8)]  # (C, P)


def _frames(C, seed=3):
    rng = np.random.default_rng(seed)
    X = (30.0 * (rng.standard_normal((3, C, T, F)) + 1j * rng.standard_normal((3, C, T, F))))
    X = X.astype(np.complex64)
    X.imag[..., 0] = 0
    X.imag[..., -1] = 0
    return X


@pytest.fixture(scope="module", params=SHAPES, ids=lambda s: f"C{s[0]}-P{s[1]}")
def case(request):
    """Frames and JAX ``wpe_multichannel`` of each utterance (one compile a shape)."""
    C, P = request.param
    X = _frames(C)
    upper = LOWER + P - 1
    want = np.stack([np.asarray(j_wpe.wpe_multichannel(jnp.asarray(Xb), LOWER, upper, 2))
                     for Xb in X])
    return dict(C=C, P=P, upper=upper, X=X, want=want)


def _close(got, want, budget=BUDGET):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=budget * np.abs(want).max())


def test_limits_take_config4_at_8_channels():
    assert wpe_kernels.WPE_MAX_CP == 40
    assert wpe_kernels.wpe_supported(8, 5, 2)
    assert wpe_kernels.wpe_supported(1, 40, 32)
    assert wpe_kernels.wpe_supported(5, 8, 0)
    assert not wpe_kernels.wpe_supported(8, 6, 2)  # C*P = 48
    assert not wpe_kernels.wpe_supported(4, 11, 2)  # C*P = 44
    assert not wpe_kernels.wpe_supported(9, 1, 2)
    assert not wpe_kernels.wpe_supported(8, 5, 33)


def test_gj_solve_matches_jax_at_n40():
    """Loaded Hermitian positive-definite systems of n = 40, as WPE builds them."""
    n = 40
    rng = np.random.default_rng(40)
    L = rng.standard_normal((16, n, 3 * n)) + 1j * rng.standard_normal((16, n, 3 * n))
    R = np.einsum("npt,nqt->npq", L, L.conj())
    R += (np.abs(np.diagonal(R, axis1=1, axis2=2)).max(-1) * 0.01)[:, None, None] * np.eye(n)
    R = R.astype(np.complex64)
    r = (rng.standard_normal((16, n)) + 1j * rng.standard_normal((16, n))).astype(np.complex64)
    want = np.asarray(j_wpe._gj_solve(jnp.asarray(R), jnp.asarray(r)))
    got = wpe_kernels.gj_solve(torch.from_numpy(R), torch.from_numpy(r))
    _close(got, want, 1e-4)


def test_multichannel_matches_jax_and_float64(case):
    got = np.stack([t_wpe.wpe_multichannel(torch.from_numpy(Xb), LOWER, case["upper"], 2).numpy()
                    for Xb in case["X"]])
    _close(got, case["want"])
    exact = np.stack([t_wpe.wpe_multichannel(torch.from_numpy(Xb).to(torch.complex128), LOWER,
                                             case["upper"], 2).numpy() for Xb in case["X"]])
    _close(got, exact)
    _close(case["want"], exact)


def test_packed_wpe_matches_jax_per_utterance(case):
    """The chain's packed batch WPE (the wrappers' plain versions on the CPU)
    against JAX ``wpe_multichannel`` on each utterance's complex frames."""
    X = case["X"]
    Yp = np.concatenate([X.real, X.imag[..., 1:F - 1]], axis=-1)
    Yp = torch.from_numpy(np.ascontiguousarray(np.moveaxis(Yp, 2, 0), np.float32))
    got = t_wpe.wpe_multichannel_packed_tm(Yp, LOWER, case["upper"], 2).numpy()
    zero = np.zeros(got.shape[:-1] + (1,), np.float32)
    got = got[..., :F] + 1j * np.concatenate([zero, got[..., F:], zero], axis=-1)
    _close(np.moveaxis(got, 0, 2), case["want"])
