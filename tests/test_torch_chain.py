"""The port's config-4 chain (NLMS AEC -> multichannel WPE -> GSC-RLS +
Zelinski) end to end against the JAX package.

JAX `build_pipeline` (XLA path on the CPU: ``nlms_aec`` on the unpacked
spectrum, ``wpe_multichannel`` per utterance, ``gsc_postfilter_fused``) and
the port's `build_pipeline` / `from_jax_params` on the CPU take the same
numpy batch: B=2 utterances x 4 channels x 8000 samples plus the far-end
playback ``play [B, T]``, both int16-scale white noise from numpy seed 0;
the bench.py config-4 configuration (M=256, m=4, r=1, linear array 50 mm,
azimuth pi/3, pf_min_frames=2, aec="nlms", wpe=True, 2 EM iterations) with
``rls.min_frames=4`` so the adaptive branch runs.

Budget 3e-4 x max|ref|, the flagship chain's, which holds here too:
measured 2.7e-7 x max|ref| (the WPE EM feedback does not amplify the
float32 rounding past it at these sizes).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only matters when test workers share the cores
    from contextlib import nullcontext as threadpool_limits

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu.utils.prototypes import load_pair
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import GSCRLSConfig
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams

B, C, T, FS = 2, 4, 8000, 16000.0
BUDGET = 3e-4
CHAIN = dict(aec="nlms", wpe=True, wpe_iterations=2)


def _port_cfg(**kw):
    base = dict(fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2),
                samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                pf_min_frames=2, rls=GSCRLSConfig(min_frames=4), **CHAIN)
    base.update(kw)
    return t_pipe.PipelineConfig(**base)


@pytest.fixture(scope="module")
def case():
    with threadpool_limits(1):
        h, g = load_pair(256, 4, 1)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((B, C, T)) * 1500.0).astype(np.float32)
    play = (rng.standard_normal((B, T)) * 1500.0).astype(np.float32)
    jcfg = j_pipe.PipelineConfig(
        fb=JParams(M=256, m=4, r=1, delay_compensation_type=2), samplerate=FS,
        beamformer="gsc_rls", postfilter="zelinski", pf_min_frames=2,
        rls=j_gsc.GSCRLSConfig(min_frames=4),
    )
    jcfg = dataclasses.replace(jcfg, **CHAIN)
    ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, delays, h, g)(x, play))
    # the JAX weights as JAX build_pipeline computes them (on the CPU device,
    # so its compiled ops are reused)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        wqH, BmH = j_gsc.gsc_weights(256, FS, delays, 1)
        params = dict(h=h, g=g, wqH=np.asarray(wqH), BmH=np.asarray(BmH),
                      wq_manifold=np.asarray(j_bf.array_manifold(256, FS, delays)))
    return dict(h=h, g=g, mpos=mpos, delays=delays, x=x, play=play, ref=ref, params=params)


def _run(enh, case):
    with torch.no_grad():
        return enh(torch.from_numpy(case["x"]), torch.from_numpy(case["play"])).numpy()


def _check(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


def _build(case, device="cpu", **kw):
    return t_pipe.build_pipeline(_port_cfg(**kw), case["mpos"], case["delays"], case["h"],
                                 case["g"], device=device)


def test_build_pipeline_matches_jax(case):
    enh = _build(case)
    kernels.reset_launch_counts()
    _check(_run(enh, case), case["ref"])
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions


def test_from_jax_params_matches_jax(case):
    enh = t_pipe.from_jax_params(case["params"], _port_cfg(), device="cpu")
    _check(_run(enh, case), case["ref"])


def test_play_is_required_exactly_with_aec(case):
    x = torch.from_numpy(case["x"][:, :, :2000])
    play = torch.from_numpy(case["play"][:, :2000])
    with pytest.raises(ValueError, match="play"):
        _build(case)(x)
    with pytest.raises(ValueError, match="play"):
        _build(case, aec="none")(x, play)
    with pytest.raises(ValueError, match="play"):
        _build(case)(x, play[:, :1000])


@pytest.mark.parametrize("kw", [dict(aec="block_kalman"), dict(aec="dtd_block_kalman"),
                                dict(wpe_upper=10), dict(wpe_lower=40, wpe_upper=42)])
def test_unported_chains_raise_on_every_device(case, kw):
    """An AEC the port lacks, or a WPE shape past the kernels' limits (C*P
    <= 24, wpe_lower <= 32), is refused at build time, also on the CPU."""
    with pytest.raises(NotImplementedError):
        _build(case, **kw)


def test_default_device_is_the_card(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.build_pipeline(_port_cfg(), case["mpos"], case["delays"], case["h"], case["g"])
    enh = _build(case)
    params = dict(h=case["h"], g=case["g"], wqH=enh.wqH, BmH=enh.BmH, wq_manifold=enh.wq_manifold)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.from_jax_params(params, _port_cfg())
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.Enhancer(_port_cfg(), **params)
