"""The port's McCowan, Lefkimmiatis and APAB postfilters against the JAX
package, on the CPU.

- `postfilter.mccowan_postfilter`, `lefkimmiatis_postfilter` (at its default
  ``fbin_no1=128``, which F = 33 never reaches, and at ``fbin_no1=16``,
  where Lambda scales the noise PSD of bins 16..32) and `apab_postfilter`
  (the D&S reference and one aligned channel) against JAX's functions on
  the same numpy input: X ``[T=200, F=33, C]``, a source steered at pi/3
  plus sensor noise whose level rises with the bin (so that most gains lie
  between their floor and 1, not at the floor as on noise alone), Y its D&S output,
  the manifold and JAX's diffuse coherence of a linear 50 mm array; C = 2,
  3, 4 and 8, REAL and ABS mode, ``min_frames`` 0 and 3.  Budget 2e-5 x
  max|ref|: JAX smooths by an associative scan on the CPU
  (``ops.recursions.ema``), the port by the sequential recursion the kernel
  runs, and divides by 1 - R where the port multiplies by its reciprocal;
  measured up to 3.6e-6 (C = 8, REAL mode; ``PYTHONPATH=.:tests python
  tests/test_torch_postfilter.py`` prints every case's error).
- The kernel's plain version on the packed time-major layout
  (`coherence_postfilter.coherence_postfilter_plain`, also through the CUDA
  wrapper on CPU tensors) against JAX per utterance, given the beamformer's
  output and forming SD-MVDR's wqH X itself, as `zelinski_apply_plain` is
  tested; the packed lanes have no slot for Im(DC) and Im(Nyquist), so the
  reference's input drops them too.
- Lambda = d^H Gamma^+ d (`beamforming.noise_coherence_gain`) against
  JAX's where Lefkimmiatis reads it.
- `build_pipeline` builds and runs on the CPU for every beamformer and
  every postfilter, with and without the echo canceller and WPE; what is
  not ported still raises.

The JAX references are compiled once per channel count.  The pipelines
against JAX are in tests/test_torch_postfilter_chain.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import postfilter as j_pf
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair
from distant_speech_recognition_tpu_torch.models import beamforming as t_bf
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.models import postfilter as t_pf
from distant_speech_recognition_tpu_torch.models import steered as t_steered
from distant_speech_recognition_tpu_torch.models.coherence_postfilter import (
    coherence_postfilter,
    coherence_postfilter_plain,
)
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams, pack_half

M, FS, T = 64, 16000.0, 200
F = M // 2 + 1
BUDGET = 2e-5
CHANNELS = (2, 3, 4, 8)
FBIN_SMALL = 16
# (pf_type, min_frames) of the McCowan and Lefkimmiatis cases
MODES = [(1, 0), (1, 3), (2, 0), (2, 3)]


def _array(C):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return mpos, geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)


def _inputs(C, batch=()):
    """X ``[T, *batch, F, C]`` (a steered source plus sensor noise rising
    with the bin), its D&S output, the manifold, JAX's diffuse coherence
    and SD-MVDR's weights, as numpy."""
    mpos, delays = _array(C)
    wq = np.asarray(j_bf.array_manifold(M, FS, delays))
    rng = np.random.default_rng(C)
    shape = (T,) + batch + (F,)
    s = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape))[..., None] * 100.0
    n = (rng.standard_normal(shape + (C,)) + 1j * rng.standard_normal(shape + (C,))) * 100.0
    X = (s * wq * C + n * np.linspace(0.2, 3.0, F)[:, None]).astype(np.complex64)
    Y = np.einsum("fc,...fc->...f", np.conj(wq), X).astype(np.complex64)
    G = np.asarray(j_bf.diffuse_noise_coherence(mpos, M, FS))
    wqH = np.asarray(j_bf.superdirective_weights(mpos, delays, M, FS))
    return X, Y, wq, G, wqH


def _jax_all(X, Y, wq, G):
    """Every JAX reference of one channel count, in one function to jit."""
    out = {}
    for pf_type, mf in MODES:
        out[f"mccowan {pf_type} {mf}"] = j_pf.mccowan_postfilter(X, Y, wq, G, 0.6, pf_type, mf)
        out[f"lefkimmiatis {pf_type} {mf}"] = j_pf.lefkimmiatis_postfilter(X, Y, wq, G, 0.6,
                                                                        pf_type, mf)
    for pf_type in (1, 2):
        out[f"lefk_small {pf_type}"] = j_pf.lefkimmiatis_postfilter(
            X, Y, wq, G, 0.6, pf_type, 3, fbin_no1=FBIN_SMALL)
    out["apab"] = j_pf.apab_postfilter(X, Y, wq)
    out["apab_ch1"] = j_pf.apab_postfilter(X, Y, wq, channel=1)
    return out


@pytest.fixture(scope="module")
def refs():
    run = jax.jit(_jax_all)
    out = {}
    for C in CHANNELS:
        X, Y, wq, G, _ = _inputs(C)
        out[C] = ((X, Y, wq, G), {k: np.asarray(v) for k, v in run(X, Y, wq, G).items()})
    return out


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


def _close(got, want, budget=BUDGET):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=budget * np.abs(want).max())


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("pf_type,min_frames", MODES)
def test_mccowan_matches_jax(refs, C, pf_type, min_frames):
    (X, Y, wq, G), ref = refs[C]
    got = t_pf.mccowan_postfilter(*_t(X, Y, wq, G), 0.6, pf_type, min_frames)
    _close(got.numpy(), ref[f"mccowan {pf_type} {min_frames}"])


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("pf_type,min_frames", MODES)
def test_lefkimmiatis_matches_jax(refs, C, pf_type, min_frames):
    (X, Y, wq, G), ref = refs[C]
    got = t_pf.lefkimmiatis_postfilter(*_t(X, Y, wq, G), 0.6, pf_type, min_frames)
    _close(got.numpy(), ref[f"lefkimmiatis {pf_type} {min_frames}"])


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("pf_type", [1, 2])
def test_lefkimmiatis_lambda_bins_match_jax(refs, C, pf_type):
    """``fbin_no1=16`` on both sides: the noise PSD of bins 16..32 scaled by
    1 / Lambda (at M = 256 only the Nyquist bin reaches the default 128)."""
    (X, Y, wq, G), ref = refs[C]
    got = t_pf.lefkimmiatis_postfilter(*_t(X, Y, wq, G), 0.6, pf_type, 3, fbin_no1=FBIN_SMALL)
    _close(got.numpy(), ref[f"lefk_small {pf_type}"])
    plain = t_pf.lefkimmiatis_postfilter(*_t(X, Y, wq, G), 0.6, pf_type, 3, fbin_no1=F)
    assert not np.allclose(got.numpy()[:, FBIN_SMALL:], plain.numpy()[:, FBIN_SMALL:])


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("channel", [-1, 1])
def test_apab_matches_jax(refs, C, channel):
    (X, Y, wq, _), ref = refs[C]
    got = t_pf.apab_postfilter(*_t(X, Y, wq), channel=channel)
    _close(got.numpy(), ref["apab" if channel < 0 else "apab_ch1"])


@pytest.mark.parametrize("C", CHANNELS)
@pytest.mark.parametrize("M_,fbin_no1", [(64, FBIN_SMALL), (256, 128)])
def test_noise_coherence_gain_matches_jax_where_read(C, M_, fbin_no1):
    """The port's pseudo-inverse drops eigenvalues at or below max(1e-8, 8
    eps32 lambda_max), JAX's at 1e-8 alone; they part only where Gamma is
    near singular.  Where Lefkimmiatis reads Lambda (bins >= fbin_no1: 4 kHz
    and up for these arrays) the diffuse coherence of the linear 50 mm
    arrays is well conditioned (smallest eigenvalue >= 0.4 of the largest),
    so both keep every eigenvalue and Lambda agrees to float32 rounding."""
    mpos, delays = _array(C)
    G = np.asarray(j_bf.diffuse_noise_coherence(mpos, M_, FS))[fbin_no1:]
    wq = np.asarray(j_bf.array_manifold(M_, FS, delays))[fbin_no1:]
    w = np.linalg.eigvalsh(G.astype(np.complex128))
    assert (w[:, 0] >= 0.4 * w[:, -1]).all()
    tmp = jnp.einsum("fji,fj->fi", jnp.conj(j_bf._pinv_hermitian(jnp.asarray(G), 1e-8)), wq)
    want = np.asarray(jnp.sum(jnp.conj(tmp) * wq, axis=-1))
    got = t_bf.noise_coherence_gain(*_t(G, wq)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.fixture(scope="module")
def packed_case():
    """Two utterances at C = 4 in the packed time-major layout, Im(DC) and
    Im(Nyquist) dropped, and JAX's references per utterance."""
    X, Y, wq, G, wqH = _inputs(4, batch=(2,))
    X[..., 0, :] = X[..., 0, :].real
    X[..., -1, :] = X[..., -1, :].real
    Yw = np.einsum("fc,tbfc->tbf", wqH, X)
    Yr = pack_half(torch.from_numpy(X).movedim(-1, -2))  # [T, B, C, M]

    def jax_refs(X, Y, Yw):
        out = {}
        for b in range(2):
            for formed, Y_ in ((False, Y[:, b]), (True, Yw[:, b])):
                out[f"mccowan {formed} {b}"] = j_pf.mccowan_postfilter(X[:, b], Y_, wq, G, 0.6,
                                                                       2, 2)
                out[f"lefkimmiatis {formed} {b}"] = j_pf.lefkimmiatis_postfilter(
                    X[:, b], Y_, wq, G, 0.6, 1, 2, fbin_no1=FBIN_SMALL)
                out[f"apab {formed} {b}"] = j_pf.apab_postfilter(X[:, b], Y_, wq)
        return out

    ref = {k: np.asarray(v) for k, v in jax.jit(jax_refs)(X, Y, Yw).items()}
    return dict(Yr=Yr, Y=Y, wq=wq, G=G, wqH=wqH, ref=ref)


@pytest.mark.parametrize("kind,pf_type", [("mccowan", 2), ("lefkimmiatis", 1), ("apab", 1)])
@pytest.mark.parametrize("formed", [False, True])
def test_packed_plain_matches_jax(packed_case, kind, pf_type, formed):
    """The kernel's plain version, and the CUDA wrapper on CPU tensors (which
    runs it and launches nothing), against JAX per utterance."""
    c = packed_case
    wqH, wq, G = _t(c["wqH"], c["wq"], c["G"])
    consts = t_pf.coherence_constants(kind, G, wq, pf_type, fbin_no1=FBIN_SMALL)
    Yp = None if formed else pack_half(torch.from_numpy(c["Y"]))
    args = (c["Yr"], Yp, wqH, wq, kind, consts, 0.6, pf_type, 2)
    kernels.reset_launch_counts()
    got = coherence_postfilter(*args)
    assert set(kernels.launch_counts().values()) == {0}
    assert torch.equal(got, coherence_postfilter_plain(*args))
    want = np.stack([c["ref"][f"{kind} {formed} {b}"] for b in range(2)], axis=1)
    _close(got.numpy(), pack_half(torch.from_numpy(want)).numpy())


def test_coherence_constants_refuse_a_complex_coherence():
    G = torch.eye(3, dtype=torch.complex64).expand(F, 3, 3).clone()
    G[:, 0, 1] = 0.5j
    with pytest.raises(ValueError, match="real"):
        t_pf.coherence_constants("mccowan", G, torch.ones(F, 3, dtype=torch.complex64))
    assert t_pf.coherence_constants("apab", G, None) is None


@pytest.fixture(scope="module")
def grid_inputs():
    C = 3
    mpos, delays = _array(C)
    h, g = design_nyquist_pair(M, 2, 1)
    rng = np.random.default_rng(3)
    x = torch.from_numpy((rng.standard_normal((1, C, 1200)) * 1500).astype(np.float32))
    play = torch.from_numpy((rng.standard_normal((1, 1200)) * 1500).astype(np.float32))
    noise = [geometry.calc_la_delays(mpos[:, :1], azimuth=2 * np.pi / 3)]
    return dict(mpos=mpos, delays=delays, h=h, g=g, x=x, play=play, noise=noise)


@pytest.mark.parametrize("chain", ["bare", "aec_wpe"])
@pytest.mark.parametrize("postfilter", t_pipe.POSTFILTERS)
@pytest.mark.parametrize("beamformer", ["ds", "sd_mvdr", "lcmv", "gsc_lms", "gsc_rls"])
def test_every_pipeline_builds_and_runs(grid_inputs, beamformer, postfilter, chain):
    """Every beamformer with every postfilter, bare and behind the NLMS
    canceller and WPE (taps 2..3), builds and runs on the CPU (M = 64,
    C = 3, 1200 samples): finite output of the expected shape, the
    coherence only where McCowan or Lefkimmiatis read it."""
    i = grid_inputs
    cfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=2, r=1, delay_compensation_type=2),
                                beamformer=beamformer, postfilter=postfilter, pf_min_frames=2)
    if chain == "aec_wpe":
        cfg = dataclasses.replace(cfg, aec="nlms", wpe=True, wpe_upper=3)
    enh = t_pipe.build_pipeline(cfg, i["mpos"], i["delays"], i["h"], i["g"],
                                noise_delays=i["noise"] if beamformer == "lcmv" else None,
                                device="cpu")
    assert (enh.Gamma is not None) == (postfilter in ("mccowan", "lefkimmiatis"))
    with torch.no_grad():
        y = enh(i["x"], i["play"] if chain == "aec_wpe" else None)
    assert y.shape == (1, 1216) and torch.isfinite(y).all()


@pytest.mark.parametrize("kw", [dict(postfilter="wiener"), dict(postfilter="binary_mask"),
                                dict(aec="block_kalman", aec_taps=2),
                                dict(aec="information_filter")])
def test_still_unported_configurations_raise(grid_inputs, kw):
    i = grid_inputs
    cfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=2, r=1), beamformer="sd_mvdr", **kw)
    with pytest.raises(NotImplementedError):
        t_pipe.build_pipeline(cfg, i["mpos"], i["delays"], i["h"], i["g"], device="cpu")


@pytest.mark.parametrize("postfilter", ["mccowan", "lefkimmiatis", "apab"])
def test_steered_pipeline_refuses_the_coherence_postfilters(grid_inputs, postfilter):
    """JAX's steered pipeline raises `ValueError` for them (its
    models/steered.py:60-61), and so does the port's."""
    i = grid_inputs
    cfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=2, r=1), beamformer="gsc_rls",
                                postfilter=postfilter)
    with pytest.raises(ValueError, match="postfilter"):
        t_steered.build_steered_pipeline(cfg, i["mpos"], i["h"], i["g"], [np.pi / 2],
                                         np.deg2rad(np.arange(0.0, 360.0, 30.0)), device="cpu")


def test_gamma_is_required_exactly_for_the_coherence_postfilters(grid_inputs):
    i = grid_inputs
    base = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=2, r=1), beamformer="ds")
    params = dict(h=i["h"], g=i["g"], wqH=np.ones((F, 3), np.complex64),
                  wq_manifold=np.ones((F, 3), np.complex64))
    with pytest.raises(KeyError, match="Gamma"):
        t_pipe.from_jax_params(params, dataclasses.replace(base, postfilter="mccowan"),
                               device="cpu")
    G = np.broadcast_to(np.eye(3, dtype=np.complex64), (F, 3, 3))
    t_pipe.from_jax_params(dict(params, Gamma=G), dataclasses.replace(base, postfilter="apab"),
                           device="cpu")  # read by neither APAB nor its constants
    with pytest.raises(ValueError, match="Gamma"):
        t_pipe.Enhancer(dataclasses.replace(base, postfilter="apab"), i["h"], i["g"],
                        params["wqH"], None, params["wq_manifold"], G, device="cpu")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    run = jax.jit(_jax_all)
    for C in CHANNELS:
        X, Y, wq, G, _ = _inputs(C)
        ref = {k: np.asarray(v) for k, v in run(X, Y, wq, G).items()}
        args = _t(X, Y, wq, G)
        got = {}
        for pf_type, mf in MODES:
            got[f"mccowan {pf_type} {mf}"] = t_pf.mccowan_postfilter(*args, 0.6, pf_type, mf)
            got[f"lefkimmiatis {pf_type} {mf}"] = t_pf.lefkimmiatis_postfilter(*args, 0.6,
                                                                               pf_type, mf)
        for pf_type in (1, 2):
            got[f"lefk_small {pf_type}"] = t_pf.lefkimmiatis_postfilter(
                *args, 0.6, pf_type, 3, fbin_no1=FBIN_SMALL)
        got["apab"] = t_pf.apab_postfilter(*args[:3])
        got["apab_ch1"] = t_pf.apab_postfilter(*args[:3], channel=1)
        errs = {k: np.abs(v.numpy() - ref[k]).max() / np.abs(ref[k]).max() for k, v in got.items()}
        worst = max(errs, key=errs.get)
        print(f"C={C}: worst {worst!r} {errs[worst]:.3g} x max|ref|; "
              + ", ".join(f"{k} {v:.2g}" for k, v in errs.items()))
