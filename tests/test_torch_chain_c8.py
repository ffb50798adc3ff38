"""BASELINE config 4 at 8 channels end to end, the port against the JAX
package, on the CPU.

JAX `build_pipeline` (XLA path on the CPU: the echo canceller on the
unpacked spectrum, ``wpe_multichannel`` per utterance, the fused GSC-LMS +
Zelinski scan) and the port's `build_pipeline` / `from_jax_params` on the
CPU take the same numpy batch: B = 2 utterances x 8 channels x 3000 samples
plus the far-end playback, int16-scale white noise from numpy seed 8; M =
128, m = 4, r = 1 (prototypes from `design.nyquist.design_nyquist_pair`),
the bench.py array widened to 8 mics (linear, 50 mm, azimuth pi/3),
``beamformer="gsc_lms"`` + Zelinski, WPE with the default taps (2..6: P =
5, C*P = 40) and 2 EM iterations, ``min_frames=4`` so the adaptive branch
runs.  Two echo cancellers: NLMS (BASELINE config 4's) and the one-tap
block Kalman (beta 0.95, sigmau2 1e-3, sigmak2 5).

Budget 3e-4 x max|ref|, the chains' budget (tests/test_torch_chain.py).
The WPE stage at C*P = 40 parts from a float64 evaluation by about ten
times what it does at C*P = 20, and stays far inside it
(tests/test_torch_wpe_c8.py).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair
from distant_speech_recognition_tpu_torch.models import adaptive_gsc as t_gsc
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams
from distant_speech_recognition_tpu_torch.utils import geometry

B, C, T, FS, M = 2, 8, 3000, 16000.0, 128
BUDGET = 3e-4
AECS = {"nlms": dict(aec="nlms"),
        "block_kalman": dict(aec="block_kalman", aec_delta=0.95, aec_epsilon=1e-3)}


def _kw(aec):
    return dict(samplerate=FS, beamformer="gsc_lms", postfilter="zelinski", pf_min_frames=2,
                wpe=True, wpe_iterations=2, **AECS[aec])


@pytest.fixture(scope="module")
def inputs():
    h, g = (np.asarray(a, np.float32) for a in design_nyquist_pair(M, 4, 1))
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((B, C, T)) * 1500.0).astype(np.float32)
    play = (rng.standard_normal((B, T)) * 1500.0).astype(np.float32)
    return dict(h=h, g=g, mpos=mpos, delays=delays, x=x, play=play)


@pytest.fixture(scope="module", params=list(AECS))
def case(request, inputs):
    """JAX `build_pipeline`'s output for one echo canceller (one compile each)."""
    jcfg = j_pipe.PipelineConfig(fb=JParams(M=M, m=4, r=1, delay_compensation_type=2),
                                 lms=j_gsc.GSCLMSConfig(min_frames=4, slowdown_after=8),
                                 **_kw(request.param))
    i = inputs
    ref = np.asarray(j_pipe.build_pipeline(jcfg, i["mpos"], i["delays"], i["h"], i["g"])(
        i["x"], i["play"]))
    tcfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2),
                                 lms=t_gsc.GSCLMSConfig(min_frames=4, slowdown_after=8),
                                 **_kw(request.param))
    return dict(i, ref=ref, jcfg=jcfg, tcfg=tcfg)


def _run(enh, case):
    with torch.no_grad():
        return enh(torch.from_numpy(case["x"]), torch.from_numpy(case["play"])).numpy()


def _check(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


def test_build_pipeline_matches_jax(case):
    enh = t_pipe.build_pipeline(case["tcfg"], case["mpos"], case["delays"], case["h"],
                                case["g"], device="cpu")
    kernels.reset_launch_counts()
    _check(_run(enh, case), case["ref"])
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions


def test_from_jax_params_matches_jax(case):
    """The JAX build-time tables, its `GSCLMSConfig` and its ``aec_taps``
    reach the port."""
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        wqH, BmH = j_gsc.gsc_weights(M, FS, case["delays"], 1)
        wqm = j_bf.array_manifold(M, FS, case["delays"])
    params = dict(h=case["h"], g=case["g"], wqH=np.asarray(wqH), BmH=np.asarray(BmH),
                  wq_manifold=np.asarray(wqm), lms=dataclasses.asdict(case["jcfg"].lms),
                  aec_taps=case["jcfg"].aec_taps)
    cfg = dataclasses.replace(case["tcfg"], lms=t_gsc.GSCLMSConfig(), aec_taps=3)
    enh = t_pipe.from_jax_params(params, cfg, device="cpu")
    assert enh.cfg.aec_taps == 1
    _check(_run(enh, case), case["ref"])
    with pytest.raises(NotImplementedError, match="aec_taps"):
        t_pipe.from_jax_params(dict(params, aec_taps=2),
                               dataclasses.replace(case["tcfg"], aec="block_kalman"),
                               device="cpu")
