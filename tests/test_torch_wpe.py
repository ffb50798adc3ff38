"""The PyTorch port's WPE against the JAX package's.

The same numpy frames go through JAX's ``models/dereverberation.py`` (XLA,
CPU) and the port's `models.dereverberation` / `ops.wpe_kernels` (plain
versions on the CPU): the Gauss-Jordan solve, the EM statistics, the apply,
one utterance end to end (with and without the band limit), and the packed
time-major batch path of the chain against JAX ``wpe_multichannel`` per
utterance.  Budgets (x max|ref|) start from the JAX package's own
Pallas-vs-XLA ones (tests/test_pallas_wpe.py): 2e-4 for the statistics,
1e-5 for the residual, 3e-4 for the EM end to end.  On the chain's own
frames, where the EM filters nearly cancel their targets, the statistics
are also held per system (see `test_stats_on_chain_frames_with_em_filters`).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import dereverberation as j_wpe
from distant_speech_recognition_tpu.ops.complex_ops import ceinsum
from distant_speech_recognition_tpu.utils.prototypes import load_pair
from distant_speech_recognition_tpu_torch.models import dereverberation as t_wpe
from distant_speech_recognition_tpu_torch.ops import wpe_kernels
from distant_speech_recognition_tpu_torch.ops.filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    unpack_half,
)

C, T, F = 4, 150, 65  # M = 128
LOWER, UPPER = 2, 6
P = UPPER - LOWER + 1
CP = C * P


def _cplx(rng, *shape, scale=1.0):
    return (scale * (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))).astype(
        np.complex64)


@pytest.fixture(scope="module")
def frames():
    """Three utterances ``[B, C, T, F]`` with real DC and Nyquist bins."""
    X = _cplx(np.random.default_rng(3), 3, C, T, F, scale=30.0)
    X.imag[..., 0] = 0
    X.imag[..., -1] = 0
    return X


def _close(got, want, budget):
    got = np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=budget * np.abs(want).max())


def _worst_system(got, want, lead=3):
    """Largest over systems (indices of the first ``lead`` dims) of
    max|got - want| / max|want| within the system."""
    d = np.abs(np.asarray(got) - np.asarray(want))
    d = d.reshape(d.shape[:lead] + (-1,)).max(-1)
    m = np.abs(np.asarray(want)).reshape(d.shape + (-1,)).max(-1)
    return (d / m).max()


def _jax_stats(Xb, Gb, lowerN=LOWER):
    """R and r of one EM iteration of one utterance ``Xb [C, T, F]`` with
    filters ``Gb [C, F, CP]``, in the einsum formulation of JAX
    ``wpe_estimate`` (as tests/test_pallas_wpe.py states it)."""
    C_, T_, F_ = Xb.shape
    L = j_wpe._lag_tensor(jnp.asarray(Xb), lowerN, P)
    L = jnp.moveaxis(L, 0, -2).reshape(T_, F_, C_ * P)
    valid = (jnp.arange(T_) >= lowerN)[:, None]
    pred = ceinsum("cfp,tfp->ctf", jnp.conj(jnp.asarray(Gb)), L)
    resid = jnp.asarray(Xb) - jnp.where(valid, pred, 0.0)
    theta = jnp.maximum(jnp.abs(resid), j_wpe.SUBBAND_FLOOR) ** 2
    w = jnp.where(valid, 1.0 / theta, 0.0)
    R = ceinsum("ctfp,tfq->cfpq", w[..., None].astype(L.dtype) * L[None], jnp.conj(L))
    r = ceinsum("ctf,tfp->cfp", w.astype(L.dtype) * jnp.conj(jnp.asarray(Xb)), L)
    return np.asarray(R), np.asarray(r)


def test_lag_tensor_and_band_mask_equal_jax(frames):
    Y = frames[0]
    np.testing.assert_array_equal(t_wpe._lag_tensor(torch.from_numpy(Y), LOWER, P).numpy(),
                                  np.asarray(j_wpe._lag_tensor(jnp.asarray(Y), LOWER, P)))
    for bw in (0.0, 3000.0, 8000.0):
        want = j_wpe.band_limit_mask(F, bw, 16000.0)
        got = t_wpe.band_limit_mask(F, bw, 16000.0)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        t_wpe.band_limit_mask(F, 9000.0, 16000.0)


def test_gj_solve_matches_jax():
    """Loaded Hermitian positive-definite systems, as WPE builds them."""
    rng = np.random.default_rng(5)
    Lm = _cplx(rng, 64, CP, 3 * CP)
    R = np.einsum("npt,nqt->npq", Lm, Lm.conj()).astype(np.complex64)
    R += (np.abs(np.diagonal(R, axis1=1, axis2=2)).max(-1) * 0.01)[:, None, None] * np.eye(CP)
    r = _cplx(rng, 64, CP)
    want = np.asarray(j_wpe._gj_solve(jnp.asarray(R), jnp.asarray(r)))
    got = t_wpe._gj_solve(torch.from_numpy(R), torch.from_numpy(r))
    _close(got, want, 1e-5)
    # the wrapper's plain version is the same function
    np.testing.assert_array_equal(wpe_kernels.gj_solve(torch.from_numpy(R),
                                                       torch.from_numpy(r)).numpy(), got.numpy())


def test_gj_solve_zero_pivot_is_guarded():
    """A zero pivot divides by 1 (the kernel's guard), not by 0."""
    R = torch.zeros((1, 3, 3), dtype=torch.complex64)
    r = torch.ones((1, 3), dtype=torch.complex64)
    assert torch.isfinite(torch.view_as_real(wpe_kernels.gj_solve(R, r))).all()


@pytest.mark.parametrize("has_g", [False, True])
def test_stats_match_jax_formulation(frames, has_g):
    """R and r of one EM iteration, against the einsum formulation of JAX
    ``wpe_estimate`` (as tests/test_pallas_wpe.py states it)."""
    X = frames[:2]
    G = _cplx(np.random.default_rng(6), 2, C, F, CP, scale=0.1)
    if not has_g:
        G[:] = 0
    Rw, rw = zip(*(_jax_stats(X[b], G[b]) for b in range(2)))
    R, r = wpe_kernels.stats_plain(torch.from_numpy(X), torch.from_numpy(G), LOWER, P, has_g)
    _close(R, np.stack(Rw), 2e-4)
    _close(r, np.stack(rw), 2e-4)


# where the card kernels' history logic sits: T within the delay (no frame
# carries weight), T within the lag history (T = lowerN + P - 1), no delay
EDGES = [(LOWER, LOWER), (LOWER, LOWER + P - 1), (0, 40)]


@pytest.mark.parametrize("has_g", [False, True])
@pytest.mark.parametrize("lowerN,T_", EDGES)
def test_stats_match_jax_formulation_at_history_edges(lowerN, T_, has_g):
    """`stats_plain`, the specification the card kernel is held to, against
    the JAX formulation where the lag history is all or part of the frames."""
    rng = np.random.default_rng(10 * lowerN + T_)
    X = _cplx(rng, 2, 2, T_, 17, scale=30.0)
    X.imag[..., 0] = 0
    X.imag[..., -1] = 0
    G = _cplx(rng, 2, 2, 17, 2 * P, scale=0.1) if has_g else np.zeros((2, 2, 17, 2 * P),
                                                                       np.complex64)
    Rw, rw = zip(*(_jax_stats(X[b], G[b], lowerN) for b in range(2)))
    R, r = wpe_kernels.stats_plain(torch.from_numpy(X), torch.from_numpy(G), lowerN, P, has_g)
    _close(R, np.stack(Rw), 2e-4)
    _close(r, np.stack(rw), 2e-4)
    if T_ <= lowerN:  # no frame carries weight
        assert not R.abs().any() and not r.abs().any()


@pytest.mark.parametrize("lowerN,T_", EDGES)
def test_apply_matches_jax_at_history_edges(lowerN, T_):
    rng = np.random.default_rng(20 * lowerN + T_)
    X = _cplx(rng, 3, T_, 17, scale=30.0)
    G = _cplx(rng, 3, 17, 3 * P, scale=0.1)
    want = j_wpe.wpe_apply(jnp.asarray(X), jnp.asarray(G), lowerN)
    _close(t_wpe.wpe_apply(torch.from_numpy(X), torch.from_numpy(G), lowerN), want, 1e-5)


def test_stats_on_chain_frames_with_em_filters():
    """The second EM iteration's R and r on the chain's own frames (analysis
    of int16-scale white noise, one utterance of 8000 samples, M=256) with
    the first iteration's JAX filters, which cancel some targets to ~1e-3:
    there 1/|e|^2 magnifies the float32 rounding of the prediction.  The
    port evaluates that residual in float64 (`ops.wpe_kernels`), JAX in
    float32.  Measured, port against JAX: R 6.8e-6 x max|R| overall, r
    2.8e-4 x max|r|, and both 8.9e-4 of a system's own max at worst.  That
    gap is JAX's rounding: against a float64 evaluation JAX is 8.9e-4 off
    per system, the port 2.7e-7."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, _ = load_pair(256, 4, 1)
    x = (np.random.default_rng(0).standard_normal((1, C, 8000)) * 1500).astype(np.float32)
    Yp = analysis_half_real_tm(torch.from_numpy(x), torch.from_numpy(h), fb, packed=True)
    X = unpack_half(Yp).permute(1, 2, 0, 3).contiguous()  # [1, C, Tf, F]
    G = np.asarray(j_wpe.wpe_estimate(jnp.asarray(X[0].numpy()), LOWER, UPPER, 1))[None]
    Rj, rj = _jax_stats(X[0].numpy(), G[0])
    R, r = wpe_kernels.stats_plain(X, torch.from_numpy(G), LOWER, P, True)
    R64, r64 = wpe_kernels.stats_plain(X.to(torch.complex128), torch.from_numpy(G).to(
        torch.complex128), LOWER, P, True)
    R64, r64 = R64.numpy(), r64.numpy()
    _close(R, Rj[None], 2e-4)
    for got, jax_ref, exact in ((R, Rj[None], R64), (r, rj[None], r64)):
        assert _worst_system(got, jax_ref) <= 2e-3
        assert _worst_system(got, exact) <= 1e-5 < _worst_system(jax_ref, exact)


def test_apply_matches_jax(frames):
    G = _cplx(np.random.default_rng(7), C, F, CP, scale=0.1)
    want = j_wpe.wpe_apply(jnp.asarray(frames[0]), jnp.asarray(G), LOWER)
    _close(t_wpe.wpe_apply(torch.from_numpy(frames[0]), torch.from_numpy(G), LOWER), want, 1e-5)


def test_estimate_matches_jax(frames):
    want = j_wpe.wpe_estimate(jnp.asarray(frames[0]), LOWER, UPPER, 2)
    _close(t_wpe.wpe_estimate(torch.from_numpy(frames[0]), LOWER, UPPER, 2), want, 3e-4)


@pytest.mark.parametrize("band_width", [0.0, 3000.0])
def test_multichannel_matches_jax(frames, band_width):
    want = j_wpe.wpe_multichannel(jnp.asarray(frames[1]), LOWER, UPPER, 2,
                                  band_width=band_width)
    got = t_wpe.wpe_multichannel(torch.from_numpy(frames[1]), LOWER, UPPER, 2,
                                 band_width=band_width)
    _close(got, want, 3e-4)


@pytest.mark.parametrize("band_width", [0.0, 3000.0])
def test_packed_wpe_matches_jax_per_utterance(frames, band_width):
    """The chain's packed batch WPE (the wrappers' plain versions on the
    CPU) against JAX ``wpe_multichannel`` on each utterance's complex frames."""
    want = np.stack([np.asarray(j_wpe.wpe_multichannel(jnp.asarray(X), LOWER, UPPER, 2,
                                                       band_width=band_width))
                     for X in frames])
    Yp = np.concatenate([frames.real, frames.imag[..., 1:F - 1]], axis=-1)
    Yp = torch.from_numpy(np.ascontiguousarray(np.moveaxis(Yp, 2, 0), np.float32))
    got = t_wpe.wpe_multichannel_packed_tm(Yp, LOWER, UPPER, 2, band_width=band_width).numpy()
    zero = np.zeros(got.shape[:-1] + (1,), np.float32)
    got = got[..., :F] + 1j * np.concatenate([zero, got[..., F:], zero], axis=-1)
    _close(np.moveaxis(got, 0, 2), want, 3e-4)


def test_wrappers_reject_malformed_input(frames):
    Yp = torch.zeros((T, 2, C, 2 * (F - 1)))
    G = torch.zeros((2, C, F, CP), dtype=torch.complex64)
    with pytest.raises(ValueError, match="G"):
        wpe_kernels.wpe_stats(Yp, G[..., :-1], LOWER, P)
    with pytest.raises(ValueError, match="complex64"):
        wpe_kernels.wpe_resid(Yp, G.to(torch.complex128), LOWER)
    with pytest.raises(ValueError, match="Yp"):
        wpe_kernels.wpe_resid(Yp[0], G, LOWER)
    with pytest.raises(ValueError):
        wpe_kernels.gj_solve(torch.zeros((2, 3, 4), dtype=torch.complex64),
                             torch.zeros((2, 3), dtype=torch.complex64))
