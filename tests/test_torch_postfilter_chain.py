"""Pipelines with the McCowan, Lefkimmiatis and APAB postfilters, and fixed
weights behind the echo canceller and WPE, the port against the JAX
package, on the CPU.

JAX `build_pipeline` (its per-utterance XLA path on the CPU: the echo
canceller on the unpacked spectrum, ``wpe_multichannel`` per utterance, the
beamformer, then the postfilter's XLA scans) and the port's
`from_jax_params` (JAX's weights, manifold and, for McCowan and
Lefkimmiatis, JAX's diffuse coherence ``Gamma``, so that no clamp of its
entries parts on rounding) take the same numpy batch: B = 2 utterances x 3000
samples of int16-scale white noise (and a far end where there is an echo
canceller) from numpy seed 13, the bench.py array (linear, 50 mm, azimuth
pi/3), m = 4, r = 1, ``pf_min_frames=2``, ``min_frames=4`` for the adaptive
GSCs so that they adapt.  Six cases:

- gsc_rls + mccowan (M = 128, C = 4);
- gsc_lms + lefkimmiatis at M = 256 (C = 4), so that the Nyquist bin reads
  Lambda (bins >= 128);
- ds + apab (M = 128, C = 4);
- sd_mvdr + mccowan behind the Kalman echo canceller (M = 128, C = 3);
- lcmv + lefkimmiatis, one jammer at 2 pi/3 (M = 128, C = 4);
- ds + zelinski behind the NLMS canceller and WPE with taps 1..3 (M = 128,
  C = 4), which JAX runs through ``wpe_multichannel`` per utterance where
  the port runs its packed time-major WPE.

Budget 3e-4 x max|ref|, the chains' budget (tests/test_torch_chain.py);
`__main__` prints each case's error.  Each JAX pipeline compiles once.
"""

import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair
from distant_speech_recognition_tpu_torch.models import adaptive_gsc as t_gsc
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams
from distant_speech_recognition_tpu_torch.utils import geometry

B, T, FS = 2, 3000, 16000.0
BUDGET = 3e-4
KALMAN = dict(aec="kalman", aec_delta=0.95, aec_epsilon=1e-3)
# name: (M, C, configuration)
CASES = {
    "gsc_rls-mccowan": (128, 4, dict(beamformer="gsc_rls", postfilter="mccowan")),
    "gsc_lms-lefkimmiatis-m256": (256, 4, dict(beamformer="gsc_lms", postfilter="lefkimmiatis")),
    "ds-apab": (128, 4, dict(beamformer="ds", postfilter="apab")),
    "sd_mvdr-mccowan-kalman": (128, 3, dict(beamformer="sd_mvdr", postfilter="mccowan",
                                            **KALMAN)),
    "lcmv-lefkimmiatis": (128, 4, dict(beamformer="lcmv", postfilter="lefkimmiatis")),
    "ds-zelinski-nlms-wpe": (128, 4, dict(beamformer="ds", postfilter="zelinski", aec="nlms",
                                          wpe=True, wpe_lower=1, wpe_upper=3)),
}


def _array(C):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return (mpos, geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3),
            [geometry.calc_la_delays(mpos[:, :1], azimuth=2 * np.pi / 3)])


def _jax_params(jcfg, mpos, delays, noise, h, g):
    """The parameters JAX's `build_pipeline` computes, as numpy."""
    M, fs = jcfg.fb.M, jcfg.samplerate
    vs = j_bf.array_manifold(M, fs, delays)
    p = dict(h=h, g=g, wq_manifold=np.asarray(vs))
    if jcfg.beamformer in ("gsc_lms", "gsc_rls"):
        wqH, BmH = j_gsc.gsc_weights(M, fs, delays, 1)
        p.update(wqH=np.asarray(wqH), BmH=np.asarray(BmH))
    elif jcfg.beamformer == "ds":
        p["wqH"] = np.conj(p["wq_manifold"])
    elif jcfg.beamformer == "sd_mvdr":
        p["wqH"] = np.asarray(j_bf.superdirective_weights(mpos, delays, M, fs, mu=jcfg.sd_mu))
    else:
        cons = np.stack([np.asarray(vs), np.asarray(j_bf.array_manifold(M, fs, noise[0]))], 1)
        p["wqH"] = np.asarray(j_bf.lcmv_weights(cons, np.array([1.0, 0.0])))
    if jcfg.postfilter in ("mccowan", "lefkimmiatis"):
        p["Gamma"] = np.asarray(j_bf.diffuse_noise_coherence(mpos, M, fs))
    return p


def _case(name):
    M, C, kw = CASES[name]
    h, g = (np.asarray(a, np.float32) for a in design_nyquist_pair(M, 4, 1))
    mpos, delays, noise = _array(C)
    rng = np.random.default_rng(13)
    x = (rng.standard_normal((B, C, T)) * 1500.0).astype(np.float32)
    play = (rng.standard_normal((B, T)) * 1500.0).astype(np.float32)
    common = dict(samplerate=FS, pf_min_frames=2, **kw)
    jcfg = j_pipe.PipelineConfig(fb=JParams(M=M, m=4, r=1, delay_compensation_type=2),
                                 lms=j_gsc.GSCLMSConfig(min_frames=4),
                                 rls=j_gsc.GSCRLSConfig(min_frames=4), **common)
    tcfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2),
                                 lms=t_gsc.GSCLMSConfig(min_frames=4),
                                 rls=t_gsc.GSCRLSConfig(min_frames=4), **common)
    args = (x,) + ((play,) if jcfg.aec != "none" else ())
    ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, delays, h, g,
                                           noise_delays=noise if kw["beamformer"] == "lcmv"
                                           else None)(*args))
    enh = t_pipe.from_jax_params(_jax_params(jcfg, mpos, delays, noise, h, g), tcfg,
                                 device="cpu")
    with torch.no_grad():
        got = enh(*(torch.from_numpy(a) for a in args)).numpy()
    return got, ref


@pytest.mark.parametrize("name", list(CASES))
def test_pipeline_matches_jax(name):
    got, ref = _case(name)
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name in CASES:
        got, ref = _case(name)
        print(f"{name}: {np.abs(got - ref).max() / np.abs(ref).max():.3g} x max|ref|")
