"""The PyTorch port's GSC-RLS + Zelinski recursion and GSC weights against
the JAX package.

The port's plain loop `adaptive_gsc.gsc_postfilter_fused` (the specification
of the CUDA scan kernel) against JAX `gsc_postfilter_fused(..., "rls", ...,
real_packed=True)` on the CPU, at the JAX package's Pallas-vs-XLA budget of
2e-4 x max|ref| (tests/test_pallas_fused.py::
test_pallas_rls_zelinski_scan_matches_xla).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import adaptive_gsc as t_gsc
from distant_speech_recognition_tpu_torch.models import beamforming as t_bf
from distant_speech_recognition_tpu_torch.models.fused_scan import gsc_rls_zelinski

M, C, FS = 256, 4, 16000.0
BUDGET = 2e-4


def _delays(azimuth=np.pi / 3):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)


@pytest.fixture(scope="module")
def weights():
    delays = _delays()
    wqH, BmH = j_gsc.gsc_weights(M, FS, delays, 1)
    vs = j_bf.array_manifold(M, FS, delays)
    return np.array(wqH), np.array(BmH), np.array(vs)


def _both(Yp, weights, cfg_kw, pf_type, min_frames):
    wqH, BmH, vs = weights
    want = np.asarray(j_gsc.gsc_postfilter_fused(
        jnp.asarray(Yp), None, jnp.asarray(wqH), jnp.asarray(BmH), jnp.asarray(vs),
        "rls", j_gsc.GSCRLSConfig(**cfg_kw), 0.6, pf_type, min_frames, True,
    ))
    got = t_gsc.gsc_postfilter_fused(
        torch.from_numpy(Yp), None, torch.from_numpy(wqH), torch.from_numpy(BmH),
        torch.from_numpy(vs), "rls", t_gsc.GSCRLSConfig(**cfg_kw), 0.6, pf_type, min_frames, True,
    ).numpy()
    return got, want


@pytest.mark.parametrize("pf_type,min_frames", [(1, 2), (2, 0)])
def test_rls_zelinski_scan_matches_jax(rng, weights, pf_type, min_frames):
    Tf, B = 19, 3
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    got, want = _both(Yp, weights, {"min_frames": 4}, pf_type, min_frames)
    assert got.shape == want.shape == (Tf, B, M)
    np.testing.assert_allclose(got, want, rtol=0, atol=BUDGET * np.abs(want).max())


def test_rls_near_silent_bins_finite_and_match(rng, weights):
    """Near-silent top bins put an adapted frame's ||wa||^2 where
    max_wa/||wa||^2 overflows to inf (the norm cap, pybeamformer.py:862-865);
    the result must stay finite and equal to JAX's.  (Same shapes and static
    configuration as the scan test above, so JAX reuses its compiled scan.)"""
    Tf, B = 19, 3
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    lo, hi = 3 * M // 8, M // 2
    Yp[..., lo:hi + 1] *= 1.8e-8
    Yp[..., lo + M // 2:] *= 1.8e-8
    got, want = _both(Yp, weights, {"min_frames": 4}, 1, 2)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=BUDGET * np.abs(want).max())


@pytest.mark.parametrize("azimuth", [np.pi / 3, 0.4])
def test_gsc_weights_match_jax(azimuth):
    """Weights at rtol 1e-6; entries that are zero by construction (the
    blocking matrix's Gram-Schmidt zeros) sit at rounding level, so they
    are held to an absolute 1e-6 x max|ref| instead."""
    delays = _delays(azimuth)
    jw, jb = (np.asarray(a) for a in j_gsc.gsc_weights(M, FS, delays, 1))
    tw, tb = (a.numpy() for a in t_gsc.gsc_weights(M, FS, delays, 1))
    assert tw.dtype == tb.dtype == np.complex64
    np.testing.assert_allclose(tw, jw, rtol=1e-6, atol=0)
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-6 * np.abs(jb).max())


def test_array_manifold_and_blocking_matrix_match_jax():
    delays = _delays()
    jv = np.asarray(j_bf.array_manifold(M, FS, delays))
    tv = t_bf.array_manifold(M, FS, delays)
    assert tv.dtype == torch.complex64
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=0)
    jb = np.asarray(j_bf.blocking_matrix(jnp.asarray(jv)))
    tb = t_bf.blocking_matrix(torch.from_numpy(jv.copy())).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-6, atol=1e-6 * np.abs(jb).max())
    # vs^T B = 0
    assert np.abs(np.einsum("fc,fcb->fb", jv, tb)).max() < 1e-6


def test_frame_energy_half_matches_jax(rng):
    X = (rng.standard_normal((5, 3, M // 2 + 1)) + 1j * rng.standard_normal((5, 3, M // 2 + 1)))
    X = X.astype(np.complex64)
    want = np.asarray(j_bf.frame_energy_half(jnp.asarray(X), M))
    got = t_bf.frame_energy_half(torch.from_numpy(X), M).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_unported_variants_raise(weights):
    wqH, BmH, vs = (torch.from_numpy(a) for a in weights)
    Yp = torch.zeros((3, 1, C, M))
    with pytest.raises(NotImplementedError):
        t_gsc.gsc_postfilter_fused(Yp, None, wqH, BmH, vs, "lms", t_gsc.GSCRLSConfig())
    with pytest.raises(NotImplementedError):
        t_gsc.gsc_postfilter_fused(Yp, torch.zeros(3, 1), wqH, BmH, vs, "rls", t_gsc.GSCRLSConfig())


def test_scan_wrapper_on_cpu_runs_the_plain_loop(rng, weights):
    wqH, BmH, vs = (torch.from_numpy(a) for a in weights)
    Yp = torch.from_numpy((rng.standard_normal((8, 2, C, M)) * 100).astype(np.float32))
    cfg = t_gsc.GSCRLSConfig(min_frames=2)
    kernels.reset_launch_counts()
    got = gsc_rls_zelinski(Yp, wqH, BmH, vs, cfg, 0.6, 1, 2)
    want = t_gsc.gsc_postfilter_fused(Yp, None, wqH, BmH, vs, "rls", cfg, 0.6, 1, 2, True)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert kernels.launch_counts()["gsc_rls_zelinski"] == 0
