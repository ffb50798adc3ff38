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


def test_enhance_matches_jax(case):
    """The one-shot `enhance` (JAX's is ``build_pipeline(...)(x)``) on numpy
    input; its default device is the card and raises without one."""
    args = (_port_cfg(), case["mpos"], case["delays"], case["h"], case["g"], case["x"])
    got = t_pipe.enhance(*args, device="cpu")
    assert got.device.type == "cpu"
    _check(got.numpy(), case["ref"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            t_pipe.enhance(*args)


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


@pytest.mark.parametrize("kw", [dict(aec="block_kalman", aec_taps=2),
                                dict(postfilter="wiener"),
                                dict(aec="information_filter"),
                                dict(wpe=True, wpe_lower=33, wpe_upper=33)])
def test_unported_configurations_raise(case, kw):
    with pytest.raises(NotImplementedError):
        t_pipe.build_pipeline(_port_cfg(**kw), case["mpos"], case["delays"], case["h"], case["g"],
                              device="cpu")


@pytest.mark.parametrize("kw", [dict(beamformer="ds", aec="nlms"),
                                dict(beamformer="gsc_lms", postfilter="lefkimmiatis"),
                                dict(postfilter="mccowan"),
                                dict(beamformer="ds", postfilter="none", wpe=True)])
def test_postfilters_and_fixed_weight_chains_run(case, kw):
    """Configurations the port refused before it ran every postfilter and
    fixed weights behind the echo canceller and WPE: they build and run on
    the CPU (held to JAX in tests/test_torch_postfilter_chain.py)."""
    enh = t_pipe.build_pipeline(_port_cfg(**kw), case["mpos"], case["delays"], case["h"],
                                case["g"], device="cpu")
    x = torch.from_numpy(case["x"][:1, :, :2000])
    play = torch.from_numpy(case["x"][:1, 0, :2000]) if enh.cfg.aec != "none" else None
    with torch.no_grad():
        y = enh(x, play)
    assert y.shape[0] == 1 and y.shape[1] > 0 and torch.isfinite(y).all()


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


@pytest.mark.parametrize("M,C_", [(4096, C), (32, C), (96, C), (256, 9)])
def test_card_refuses_other_filterbanks_at_build(M, C_):
    """The card's filterbank kernels take M in {64, 128, ..., 2048} and its
    beamformer kernels 2 <= C <= 8: a pipeline for the card with M = 4096,
    32, a size that is no power of two, or 9 channels raises at
    construction (`check_card_shapes`, decided from the configuration, so
    no card is needed to see it), while the same pipeline builds and runs on
    the CPU."""
    fb = FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    what = f"M={M}" if C_ == C else f"C={C_}"
    with pytest.raises(NotImplementedError, match=what):
        t_pipe.check_card_shapes(fb, C_, "cuda")
    t_pipe.check_card_shapes(fb, C_, "cpu")
    cfg = _port_cfg(fb=fb)
    mpos = np.c_[np.arange(C_) * 50.0, np.zeros((C_, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    rng = np.random.default_rng(M)
    h, g = (rng.standard_normal(fb.N).astype(np.float32) / 16 for _ in range(2))
    with pytest.raises(NotImplementedError, match=what):
        t_pipe.build_pipeline(cfg, mpos, delays, h, g, device="cuda")
    cpu = t_pipe.build_pipeline(cfg, mpos, delays, h, g, device="cpu")
    with pytest.raises(NotImplementedError, match=what):
        t_pipe.Enhancer(cfg, h, g, cpu.wqH, cpu.BmH, cpu.wq_manifold, device="cuda")
    x = torch.from_numpy((rng.standard_normal((1, C_, 2000)) * 1500).astype(np.float32))
    with torch.no_grad():
        assert torch.isfinite(cpu(x)).all()


def test_card_shape_limits():
    """What `check_card_shapes` lets through to the card: M in {64, 128,
    ..., 2048}, K3's tile (256, 128, 64, 40, 48, 24 rows) holding the m*R - 1
    halo rows (m*R = 32 at M = 1024, 16 at 2048), 2 <= C <= 8."""
    ok = [(FilterbankParams(M=256, m=4, r=1), c) for c in range(2, 9)]
    ok += [(FilterbankParams(M=256, m=4, r=4), 4), (FilterbankParams(M=256, m=2, r=5), 8)]
    ok += [(FilterbankParams(M=M, m=4, r=1), c) for M in (64, 128, 512, 1024, 2048)
           for c in (2, 4, 8)]
    ok += [(FilterbankParams(M=64, m=4, r=5), 2), (FilterbankParams(M=512, m=5, r=3), 4)]
    ok += [(FilterbankParams(M=1024, m=4, r=3), 4), (FilterbankParams(M=2048, m=4, r=2), 8)]
    for fb, c in ok:
        t_pipe.check_card_shapes(fb, c, "cuda")
    bad = [(FilterbankParams(M=4096, m=4, r=1), 4), (FilterbankParams(M=2048, m=4, r=3), 4),
           (FilterbankParams(M=32, m=4, r=1), 4), (FilterbankParams(M=256, m=8, r=4), 4),
           (FilterbankParams(M=512, m=4, r=4), 4), (FilterbankParams(M=256, m=4, r=1), 1),
           (FilterbankParams(M=256, m=4, r=1), 9), (FilterbankParams(M=512, m=4, r=1), 9),
           (FilterbankParams(M=1024, m=4, r=4), 4), (FilterbankParams(M=2048, m=4, r=1), 9)]
    for fb, c in bad:
        with pytest.raises(NotImplementedError):
            t_pipe.check_card_shapes(fb, c, "cuda")
        t_pipe.check_card_shapes(fb, c, "cpu")
