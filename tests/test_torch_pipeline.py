"""The PyTorch port's enhancement pipeline end to end against the JAX package.

JAX `build_pipeline` (XLA path on the CPU) and the port's `build_pipeline`
/ `from_jax_params` on the same numpy batch: B=2 utterances x 4 channels x
8000 samples, the bench.py flagship configuration (GSC-RLS + Zelinski,
M=256, m=4, r=1, linear array 50 mm, azimuth pi/3, pf_min_frames=2) with
``rls.min_frames=4`` so the adaptive branch runs.  Budget 3e-4 x max|ref|,
the JAX package's one-kernel-vs-split budget
(tests/test_pallas_fused.py::test_fused_mono_kernel_matches_split).
"""

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


def _port_cfg(**kw):
    base = dict(fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2),
                samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                pf_min_frames=2, rls=GSCRLSConfig(min_frames=4))
    base.update(kw)
    return t_pipe.PipelineConfig(**base)


@pytest.fixture(scope="module")
def case():
    with threadpool_limits(1):
        h, g = load_pair(256, 4, 1)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    x = (np.random.default_rng(0).standard_normal((B, C, T)) * 1500.0).astype(np.float32)
    jcfg = j_pipe.PipelineConfig(
        fb=JParams(M=256, m=4, r=1, delay_compensation_type=2), samplerate=FS,
        beamformer="gsc_rls", postfilter="zelinski", pf_min_frames=2,
        rls=j_gsc.GSCRLSConfig(min_frames=4),
    )
    ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, delays, h, g)(x))
    return dict(h=h, g=g, mpos=mpos, delays=delays, x=x, ref=ref)


def _check(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


def test_build_pipeline_matches_jax(case):
    enh = t_pipe.build_pipeline(_port_cfg(), case["mpos"], case["delays"], case["h"], case["g"],
                                device="cpu")
    assert isinstance(enh, torch.nn.Module)
    buffers = dict(enh.named_buffers())
    for name in ("h", "g", "A", "S", "wqH", "BmH", "wq_manifold"):
        # the CUDA kernels take these pointers as dense row-major arrays
        assert buffers[name].is_contiguous(), name
        assert buffers[name].dtype in (torch.float32, torch.complex64), name
    with torch.no_grad():
        got = enh(torch.from_numpy(case["x"])).numpy()
    _check(got, case["ref"])


def test_from_jax_params_matches_jax(case):
    wqH, BmH = j_gsc.gsc_weights(256, FS, case["delays"], 1)
    params = dict(h=case["h"], g=case["g"], wqH=np.asarray(wqH), BmH=np.asarray(BmH),
                  wq_manifold=np.asarray(j_bf.array_manifold(256, FS, case["delays"])))
    enh = t_pipe.from_jax_params(params, _port_cfg(), device="cpu")
    with torch.no_grad():
        got = enh(torch.from_numpy(case["x"])).numpy()
    _check(got, case["ref"])


def test_cpu_run_launches_no_kernel(case):
    enh = t_pipe.build_pipeline(_port_cfg(), case["mpos"], case["delays"], case["h"], case["g"],
                                device="cpu")
    kernels.reset_launch_counts()
    with torch.no_grad():
        enh(torch.from_numpy(case["x"][:1, :, :2000]))
    counts = kernels.launch_counts()
    assert {"analysis_tm", "gsc_rls_zelinski", "synthesis_tm"} <= set(counts)
    assert set(counts.values()) == {0}


def test_cuda_device_raises_without_a_card(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_pipe.build_pipeline(_port_cfg(), case["mpos"], case["delays"], case["h"], case["g"],
                              device="cuda")


@pytest.mark.parametrize("kw", [dict(beamformer="ds"), dict(beamformer="gsc_lms"),
                                dict(postfilter="mccowan"), dict(postfilter="none")])
def test_unported_configurations_raise(case, kw):
    with pytest.raises(NotImplementedError):
        t_pipe.build_pipeline(_port_cfg(**kw), case["mpos"], case["delays"], case["h"], case["g"],
                              device="cpu")


def test_more_than_one_constraint_raises(case):
    """Nc=2 weights are refused on every device, not only by the CUDA scan."""
    wqH, BmH = j_gsc.gsc_weights(256, FS, case["delays"], 2)
    assert np.asarray(BmH).shape[1] == C - 2
    params = dict(h=case["h"], g=case["g"], wqH=np.asarray(wqH), BmH=np.asarray(BmH),
                  wq_manifold=np.asarray(j_bf.array_manifold(256, FS, case["delays"])))
    with pytest.raises(NotImplementedError, match="Nc=1"):
        t_pipe.from_jax_params(params, _port_cfg(), device="cpu")


def test_input_on_another_device_or_shape_raises(case):
    enh = t_pipe.build_pipeline(_port_cfg(), case["mpos"], case["delays"], case["h"], case["g"],
                                device="cpu")
    with pytest.raises(ValueError):
        enh(torch.zeros(C, T))
    with pytest.raises(ValueError):
        enh(torch.zeros(1, C + 1, T))
