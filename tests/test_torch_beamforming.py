"""The PyTorch port's fixed beamformer weights against the JAX package.

Both compute the weights once on the host in complex64.  Where the JAX
package inverts a matrix (SD-MVDR's loaded diffuse coherence, LCMV's
constraint Gram) it uses a float32 eigenvalue pseudo-inverse; the port does
the same with `torch.linalg.eigh`, and the two eigensolvers round
differently.  The loaded coherence has condition numbers up to ~400, so
each float32 inverse sits ~4e-5 x max from the float64 one and the two
packages ~6e-5 x max|ref| apart (measured: SD-MVDR 6.1e-5; LCMV with the
target at pi/3 and a jammer at 2 pi/3, bins >= 2, 7.3e-5, worst at bins
109-112, where the 50 mm array aliases and the two manifolds nearly
coincide again): held to 3e-4 x max|ref|, the chain budget.  LCMV's bins
0-1, where the manifolds nearly coincide (bin 0's Gram is singular, bin 1's
small eigenvalue is 5.1e-4 and |wqH| reaches 21), get their own budget of
1e-4 x their own max (measured 9.1e-8).  A jammer at 2.1 rad instead puts
both packages 1.6e-4 (port) and 4.4e-4 (JAX) x max from a float64 solve,
5.3e-4 apart: the budget holds for this geometry, not for every one.
Everything else is exact or within float32 rounding (rtol 1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.utils import geometry as j_geometry
from distant_speech_recognition_tpu_torch.models import beamforming as t_bf
from distant_speech_recognition_tpu_torch.utils import geometry as t_geometry

M, C, FS = 256, 4, 16000.0
WEIGHT_BUDGET = 3e-4
LCMV_LOW_BUDGET = 1e-4
MPOS = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]


def _la(azimuth):
    return j_geometry.calc_la_delays(MPOS[:, :1], azimuth=azimuth)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("azimuth,polar", [(0.0, np.pi / 2), (np.pi / 3, np.pi / 2),
                                           (2.5, 0.7), (np.float32(5.0), np.float32(1.2))])
def test_calc_ca_delays_equal(azimuth, polar):
    ang = 2 * np.pi * np.arange(6) / 6
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.linspace(-5, 5, 6)]
    want = j_geometry.calc_ca_delays(mpos, azimuth, polar)
    got = t_geometry.calc_ca_delays(mpos, azimuth, polar)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_delay_and_sum_weights_match_jax():
    want = np.asarray(j_bf.delay_and_sum_weights(M, FS, _la(np.pi / 3)))
    got = t_bf.delay_and_sum_weights(M, FS, _la(np.pi / 3))
    assert got.dtype == torch.complex64 and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_diffuse_noise_coherence_equal():
    want = np.asarray(j_bf.diffuse_noise_coherence(MPOS, M, FS))
    got = t_bf.diffuse_noise_coherence(MPOS, M, FS)
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mu", [0.01, 0.1])
def test_superdirective_weights_match_jax(mu):
    want = np.asarray(j_bf.superdirective_weights(MPOS, _la(np.pi / 3), M, FS, mu=mu))
    got = t_bf.superdirective_weights(MPOS, _la(np.pi / 3), M, FS, mu=mu).numpy()
    np.testing.assert_array_equal(got[0], np.ones(C, np.complex64))  # bin 0 (:213)
    assert _rel(got, want) <= WEIGHT_BUDGET


def test_mvdr_weights_match_jax(rng):
    """A random loaded covariance per bin, another array's manifold."""
    F = M // 2 + 1  # the shapes of the SD-MVDR test: JAX reuses its compiled ops
    L = rng.standard_normal((F, C, 2 * C)) + 1j * rng.standard_normal((F, C, 2 * C))
    R = (L @ L.conj().transpose(0, 2, 1) + 0.1 * np.eye(C)).astype(np.complex64)
    vs = np.array(j_bf.array_manifold(M, FS, np.linspace(0, 2e-4, C)))
    want = np.asarray(j_bf.mvdr_weights(jnp.asarray(R), jnp.asarray(vs)))
    got = t_bf.mvdr_weights(torch.from_numpy(R), torch.from_numpy(vs)).numpy()
    assert _rel(got, want) <= WEIGHT_BUDGET


def test_lcmv_weights_match_jax():
    """Target at pi/3, one jammer at 2 pi/3, as the fixed-weight pipeline
    builds them; the badly conditioned bins 0-1 against their own scale."""
    jam = 2 * np.pi / 3
    vs, nj = j_bf.array_manifold(M, FS, _la(np.pi / 3)), j_bf.array_manifold(M, FS, _la(jam))
    want = np.asarray(j_bf.lcmv_weights(jnp.stack([vs, nj], axis=1), [1.0, 0.0]))
    tv = torch.stack([t_bf.array_manifold(M, FS, _la(np.pi / 3)),
                      t_bf.array_manifold(M, FS, _la(jam))], dim=1)
    got = t_bf.lcmv_weights(tv, np.array([1.0, 0.0])).numpy()
    assert got.shape == (M // 2 + 1, C)
    assert _rel(got[2:], want[2:]) <= WEIGHT_BUDGET
    assert _rel(got[:2], want[:2]) <= LCMV_LOW_BUDGET
    # the constraints hold: unit gain on the target, a null on the jammer; not
    # at bins 0 and 110, where the two manifolds coincide (the 50 mm array
    # aliases at bin 110) and the pseudo-inverse splits the gain between them
    ok = np.ones(M // 2 + 1, bool)
    ok[[0, 110]] = False
    np.testing.assert_allclose(np.einsum("fc,fc->f", got, np.asarray(vs))[ok], 1.0, atol=1e-4)
    np.testing.assert_allclose(np.einsum("fc,fc->f", got, np.asarray(nj))[ok], 0.0, atol=1e-4)


def _lcmv_geometry(kind, n_chan):
    """Target and jammer delays: the bench array (linear, 50 mm) with the
    target at pi/3 and the jammer at 2 pi/3, or a circular array (r = 100
    mm, in the plane) with the target at pi/3 and the jammer at 2.4 rad."""
    if kind == "linear":
        mpos = np.c_[np.arange(n_chan) * 50.0, np.zeros((n_chan, 2))]
        return [j_geometry.calc_la_delays(mpos[:, :1], azimuth=a) for a in (np.pi / 3, 2 * np.pi / 3)]
    ang = 2 * np.pi * np.arange(n_chan) / n_chan
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(n_chan)]
    return [j_geometry.calc_ca_delays(mpos, a, np.pi / 2) for a in (np.pi / 3, 2.4)]


@pytest.mark.parametrize("kind", ["linear", "circular"])
@pytest.mark.parametrize("n_chan", [2, 3, 4, 5, 6, 7, 8])
def test_lcmv_weights_match_jax_channel_counts(kind, n_chan):
    """LCMV weights at C = 2..8 on two geometries, every bin against
    3e-4 x max|ref|.  At C = 6 and 7 the linear array's bin 110 (where 50 mm
    is one wavelength) has a constraint Gram whose smallest eigenvalue is
    rounding in float32 (JAX returns 0, torch 1.5e-8 and 3.0e-8 where
    lambda_max is 0.33 and 0.29); with the absolute 1e-8 threshold alone the
    port inverted it and its weights reached 2.6e3 against JAX's 15.  The
    pseudo-inverse's relative floor (`PINV_EPS_FACTOR`) drops it."""
    tv = torch.stack([t_bf.array_manifold(M, FS, d) for d in _lcmv_geometry(kind, n_chan)], dim=1)
    # both packages get the port's manifolds (held to JAX's at 1e-6 in
    # test_batched_manifold_and_blocking_matrix_match_jax), so only the
    # Gram's pseudo-inverse differs
    want = np.asarray(j_bf.lcmv_weights(jnp.asarray(tv.numpy()), [1.0, 0.0]))
    got = t_bf.lcmv_weights(tv, np.array([1.0, 0.0])).numpy()
    assert got.shape == (M // 2 + 1, n_chan) and np.isfinite(got).all()
    assert _rel(got, want) <= WEIGHT_BUDGET


def test_pinv_drops_rounding_level_eigenvalues():
    """An eigenvalue a few ulps of the largest is dropped even where it is
    above the absolute threshold; one well above the floor is inverted."""
    eps = np.finfo(np.float32).eps
    q = np.linalg.qr(np.random.default_rng(5).standard_normal((3, 3)))[0]
    for small, kept in ((2 * eps, False), (100 * eps, True)):
        R = torch.from_numpy((q * np.array([1.0, 0.5, small])) @ q.T).to(torch.complex64)
        inv = t_bf._pinv_hermitian(R, 1e-8)
        w = torch.linalg.eigvalsh(inv.to(torch.complex128))
        assert (w.abs().max().item() > 1e4) == kept, (small, w)


def test_apply_weights_matches_jax(rng):
    X = (rng.standard_normal((3, 7, 5, C)) + 1j * rng.standard_normal((3, 7, 5, C))).astype(
        np.complex64)
    w = (rng.standard_normal((5, C)) + 1j * rng.standard_normal((5, C))).astype(np.complex64)
    want = np.asarray(j_bf.apply_weights(jnp.asarray(w), jnp.asarray(X)))
    got = t_bf.apply_weights(torch.from_numpy(w), torch.from_numpy(X)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_batched_manifold_and_blocking_matrix_match_jax():
    """Delays [B, C] (one steering per utterance, as the steered pipeline
    has) give each utterance's unbatched manifold and blocking matrix."""
    ang = 2 * np.pi * np.arange(C) / C
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    delays = np.stack([j_geometry.calc_ca_delays(mpos, az, np.pi / 2)
                       for az in (0.0, 1.0, 4.0)]).astype(np.float32)
    vs = t_bf.array_manifold(M, FS, torch.from_numpy(delays))
    assert vs.shape == (3, M // 2 + 1, C)
    bm = t_bf.blocking_matrix(vs)
    for b in range(3):
        jv = np.asarray(j_bf.array_manifold(M, FS, delays[b]))
        np.testing.assert_allclose(vs[b].numpy(), jv, rtol=1e-6, atol=0)
        jb = np.asarray(j_bf.blocking_matrix(jnp.asarray(jv)))
        np.testing.assert_allclose(bm[b].numpy(), jb, rtol=1e-6, atol=1e-6 * np.abs(jb).max())
