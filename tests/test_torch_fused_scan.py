"""The PyTorch port's GSC-RLS + Zelinski recursion and GSC weights against
the JAX package.

The port's plain loop `adaptive_gsc.gsc_postfilter_fused` (the specification
of the CUDA scan kernel) against JAX `gsc_postfilter_fused(..., "rls", ...,
real_packed=True)` on the CPU, at the JAX package's Pallas-vs-XLA budget of
2e-4 x max|ref| (tests/test_pallas_fused.py::
test_pallas_rls_zelinski_scan_matches_xla).  The one-kernel chains' wrappers
(`fused_scan.analysis_gsc_rls_zelinski`, K5, and
`fused_scan.analysis_gsc_synthesis`, K4) on CPU tensors against the XLA
composition their TPU kernels are held to, at 3e-4 x max|ref|
(tests/test_pallas_fused.py::test_fused_analysis_scan_matches_split and
test_fused_mono_kernel_matches_split).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.ops import filterbank as j_fb
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import adaptive_gsc as t_gsc
from distant_speech_recognition_tpu_torch.models import beamforming as t_bf
from distant_speech_recognition_tpu_torch.models.fused_scan import (
    analysis_gsc_rls_zelinski,
    analysis_gsc_synthesis,
    gsc_rls_zelinski,
)
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams

M, C, FS = 256, 4, 16000.0
BUDGET = 2e-4
# frames of the scan tests: T=5000 samples' worth (the one-kernel chain
# tests' longer input), so that JAX compiles its scan once for all of them
SCAN_TF = 44


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
    Tf, B = SCAN_TF, 3
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    got, want = _both(Yp, weights, {"min_frames": 4}, pf_type, min_frames)
    assert got.shape == want.shape == (Tf, B, M)
    np.testing.assert_allclose(got, want, rtol=0, atol=BUDGET * np.abs(want).max())


def test_rls_near_silent_bins_finite_and_match(rng, weights):
    """Near-silent top bins put an adapted frame's ||wa||^2 where
    max_wa/||wa||^2 overflows to inf (the norm cap, pybeamformer.py:862-865);
    the result must stay finite and equal to JAX's.  (Same shapes and static
    configuration as the scan test above, so JAX reuses its compiled scan.)"""
    Tf, B = SCAN_TF, 3
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
    with pytest.raises(NotImplementedError):  # LMS with the frame energies given
        t_gsc.gsc_postfilter_fused(Yp, torch.zeros(3, 1), wqH, BmH, vs, "lms",
                                   t_gsc.GSCLMSConfig())
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


@pytest.fixture(scope="module")
def chain_refs(weights):
    """Per sample count: the input, random prototypes and the JAX XLA
    chain's beamformed spectrum and samples (B=3 x 4 ch; T=5000 leaves a
    partial last block).  The shorter input is analysed and resynthesized
    zero-padded to the longer one's length and the results cut to its own
    frames and samples (the bank and the scan are causal), so JAX compiles
    each stage once, and its scan at the scan tests' shape."""
    wqH, BmH, vs = weights
    p = j_fb.FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    cfg = j_gsc.GSCRLSConfig(min_frames=4)
    rng = np.random.default_rng(5000)
    h, g = (rng.standard_normal(p.N).astype(np.float32) / 32 for _ in range(2))
    xs = {T: (rng.standard_normal((3, C, T)) * 1500).astype(np.float32) for T in (5000, 4096)}
    x_all = np.concatenate([xs[5000], np.pad(xs[4096], ((0, 0), (0, 0), (0, 5000 - 4096)))])
    Yr = jax.jit(lambda x, h: j_fb.analysis_half_real_tm(x, h, p, packed=True))(x_all, h)
    Yp = jnp.concatenate([
        j_gsc.gsc_postfilter_fused(Yr[:, b:b + 3], None, jnp.asarray(wqH), jnp.asarray(BmH),
                                   jnp.asarray(vs), "rls", cfg, 0.6, 1, 2, True)
        for b in (0, 3)], axis=1)
    y = np.asarray(j_fb.synthesis_half_real_tm(Yp, jnp.asarray(g), p))
    Yp = np.asarray(Yp)
    refs = {}
    for T, b in ((5000, 0), (4096, 3)):
        Tf = j_fb.num_analysis_frames(p, T)
        refs[T] = (xs[T], h, g, Yp[:Tf, b:b + 3], y[b:b + 3, :(Tf - p.synthesis_delay) * p.D])
    return refs


@pytest.mark.parametrize("T", [5000, 4096])
@pytest.mark.parametrize("which", ["analysis_gsc_rls_zelinski", "analysis_gsc_synthesis"])
def test_one_kernel_chain_wrappers_on_cpu_match_jax(chain_refs, weights, which, T):
    """K5's and K4's wrappers on CPU tensors run the plain chain (no launch)
    and equal JAX's analysis -> GSC-RLS + Zelinski [-> synthesis]."""
    x, h, g, Yp_ref, y_ref = chain_refs[T]
    wqH, BmH, vs = (torch.from_numpy(a) for a in weights)
    fb = FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    args = (wqH, BmH, vs, t_gsc.GSCRLSConfig(min_frames=4), 0.6, 1, 2)
    kernels.reset_launch_counts()
    if which == "analysis_gsc_rls_zelinski":
        got, want = analysis_gsc_rls_zelinski(torch.from_numpy(x), h, fb, *args), Yp_ref
    else:
        got, want = analysis_gsc_synthesis(torch.from_numpy(x), h, g, fb, *args), y_ref
    assert set(kernels.launch_counts().values()) == {0}
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=3e-4 * np.abs(want).max())
