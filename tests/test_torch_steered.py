"""The PyTorch port's SRP-PHAT-steered chain (BASELINE config 5) against the
JAX package.

JAX `build_steered_pipeline` (its XLA vmap chain on the CPU) and the port's
`build_steered_pipeline` / `steered_from_jax_params` on the CPU take the
same numpy batch: B=3 utterances on a 4-mic circular array (r = 100 mm),
8000 samples each, one white-noise source per utterance placed at a grid
direction by per-channel sample delays (so the SRP argmax is unambiguous
and equals the placed direction) plus independent sensor noise 20 dB down,
a 12-point azimuth grid at theta = pi/2, GSC-RLS + Zelinski with
pf_min_frames=2 and ``rls.min_frames=4`` so the adaptive branch runs.  The
DOA must be equal; the output is held to 3e-4 x max|ref| (measured
7.9e-7), well under the JAX package's own 2e-3 for its steered kernel
(tests/test_steered_pallas.py).  Without the sensor noise the channels are
exact copies, the blocking matrix cancels the source to rounding level and
the adaptive filter amplifies that rounding: two float32 evaluations then
differ by up to ~0.8 x max|y| once it adapts (ROADMAP.md section 3).  SRP-PHAT
itself is held to 1e-6 x max|ref| (measured 1.8e-7) and the tables are
equal.  The scan with per-utterance weights, given weights broadcast from
one set, is bit-equal to the shared-weight scan.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import localization as j_loc
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.models import steered as j_steered
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils.geometry import calc_ca_delays
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair
from distant_speech_recognition_tpu_torch.models import localization as t_loc
from distant_speech_recognition_tpu_torch.models import steered as t_steered
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (
    GSCRLSConfig,
    gsc_postfilter_fused,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold
from distant_speech_recognition_tpu_torch.models.fused_scan import gsc_rls_zelinski_steered
from distant_speech_recognition_tpu_torch.models.pipeline import PipelineConfig
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams
from distant_speech_recognition_tpu_torch.utils.prototypes import (
    load_pair,
    prototype_path,
    save_prototype,
)

B, C, T, M, FS = 3, 4, 8000, 256, 16000.0
BUDGET = 3e-4
ANG = 2 * np.pi * np.arange(C) / C
MPOS = np.c_[100.0 * np.cos(ANG), 100.0 * np.sin(ANG), np.zeros(C)]
THETAS = [np.pi / 2]
PHIS = np.deg2rad(np.arange(0.0, 360.0, 30.0))
PLACED = [1, 6, 11]  # grid index of each utterance's source


def _port_cfg(**kw):
    base = dict(fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2), samplerate=FS,
                beamformer="gsc_rls", postfilter="zelinski", pf_min_frames=2,
                rls=GSCRLSConfig(min_frames=4))
    return PipelineConfig(**(base | kw))


def _placed_sources(rng):
    """One source per utterance at azimuth PHIS[PLACED[b]] (channel c hears
    it round(delay_c * fs) samples late) plus sensor noise 20 dB down."""
    x = rng.standard_normal((B, C, T)).astype(np.float32) * 150
    src = rng.standard_normal((B, T + 64)).astype(np.float32) * 1500
    for b, gi in enumerate(PLACED):
        d = calc_ca_delays(MPOS, PHIS[gi], np.pi / 2)
        for c in range(C):
            off = 8 - int(round(float(d[c]) * FS))
            x[b, c] += src[b, off:off + T]
    return x


def _prototypes(tmp_path_factory):
    """``design_nyquist_pair(256, 4, 1)``, designed once per test process
    (1.5-2 s) and kept as pickles in the session's temporary directory."""
    d = str(tmp_path_factory.getbasetemp())
    paths = [prototype_path(k, 256, 4, 1, d) for k in "hg"]
    if not all(os.path.exists(p) for p in paths):
        for p, proto in zip(paths, design_nyquist_pair(256, 4, 1)):
            save_prototype(p, proto)
    return load_pair(256, 4, 1, proto_dir=d)


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    h, g = _prototypes(tmp_path_factory)
    x = _placed_sources(np.random.default_rng(0))
    jcfg = j_pipe.PipelineConfig(fb=JParams(M=256, m=4, r=1, delay_compensation_type=2),
                                 samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                                 pf_min_frames=2, rls=j_gsc.GSCRLSConfig(min_frames=4))
    y, doa = j_steered.build_steered_pipeline(jcfg, MPOS, h, g, THETAS, PHIS)(jnp.asarray(x))
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        steering, grid = j_loc.srp_phat_steering_table(MPOS, M, FS, THETAS, PHIS)
    # the delay table exactly as JAX build_steered_pipeline makes it
    delay_table = np.stack([calc_ca_delays(MPOS, p, t) for t, p in np.asarray(grid)])
    params = dict(h=h, g=g, steering=np.array(steering), grid=np.array(grid),
                  delay_table=delay_table.astype(np.float32))
    return dict(h=h, g=g, x=x, y=np.asarray(y), doa=np.asarray(doa), params=params)


def _check(enh, case):
    kernels.reset_launch_counts()
    with torch.no_grad():
        y, doa = enh(torch.from_numpy(case["x"]))
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions
    np.testing.assert_array_equal(doa.numpy(), case["doa"])
    np.testing.assert_array_equal(doa.numpy()[:, 1], np.float32(PHIS[PLACED]))
    y = y.numpy()
    assert y.shape == case["y"].shape and np.isfinite(y).all()
    np.testing.assert_allclose(y, case["y"], rtol=0, atol=BUDGET * np.abs(case["y"]).max())


def test_steered_chain_matches_jax(case):
    enh = t_steered.build_steered_pipeline(_port_cfg(), MPOS, case["h"], case["g"], THETAS, PHIS,
                                           device="cpu")
    for name in ("steering", "grid", "delay_table"):
        np.testing.assert_array_equal(getattr(enh, name).numpy(), case["params"][name])
    _check(enh, case)


def test_steered_from_jax_params_matches_jax(case):
    _check(t_steered.steered_from_jax_params(case["params"], _port_cfg(), device="cpu"), case)


@pytest.mark.parametrize("min_bin,max_bin", [(1, None), (0, None), (5, 100)])
def test_srp_phat_matches_jax(rng, case, min_bin, max_bin):
    """With a zero snapshot entry (PHAT leaves it zero) and more bins than
    one chunk of the port's bin loop."""
    X = (rng.standard_normal((2, 9, M // 2 + 1, C))
         + 1j * rng.standard_normal((2, 9, M // 2 + 1, C))).astype(np.complex64)
    X[0, 3, 7] = 0.0
    X[1, 2, 9, 1] = 0.0
    steering = case["params"]["steering"]
    want = np.asarray(j_loc.srp_phat(jnp.asarray(X), jnp.asarray(steering), min_bin, max_bin))
    got = t_loc.srp_phat(torch.from_numpy(X), torch.from_numpy(steering), min_bin, max_bin)
    assert got.shape == want.shape == (2, 9, len(PHIS))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * np.abs(want).max())


def test_broadcast_weight_scan_is_bit_equal(rng):
    """The plain scan with per-utterance weights broadcast from one set
    equals the shared-weight plain scan bit for bit, and K6's wrapper on the
    CPU is that plain scan."""
    d = calc_ca_delays(MPOS, 1.0, np.pi / 2)
    wqH, BmH = gsc_weights(M, FS, d)
    vs = array_manifold(M, FS, d)
    Yp = torch.from_numpy((rng.standard_normal((12, B, C, M)) * 100).astype(np.float32))
    cfg = GSCRLSConfig(min_frames=4)
    shared = gsc_postfilter_fused(Yp, None, wqH, BmH, vs, "rls", cfg, 0.6, 1, 2, True)
    per_utt = [w.expand((B,) + w.shape) for w in (wqH, BmH, vs)]
    assert torch.equal(gsc_postfilter_fused(Yp, None, *per_utt, "rls", cfg, 0.6, 1, 2, True),
                       shared)
    kernels.reset_launch_counts()
    assert torch.equal(gsc_rls_zelinski_steered(Yp, *per_utt, cfg, 0.6, 1, 2), shared)
    assert kernels.launch_counts()["gsc_rls_zelinski_steered"] == 0


@pytest.mark.parametrize("cfg_kw,kw,exc", [
    (dict(aec="nlms"), {}, NotImplementedError),
    (dict(aec="kalman"), {}, NotImplementedError),
    (dict(wpe=True), {}, NotImplementedError),
    (dict(beamformer="sd_mvdr"), {}, ValueError),
    (dict(beamformer="lcmv"), {}, ValueError),
    (dict(postfilter="mccowan"), {}, ValueError),
    ({}, dict(doa_protocol="foo"), ValueError),
])
def test_unported_steered_variants_raise(case, cfg_kw, kw, exc):
    """`ValueError` where JAX's `build_steered_pipeline` raises (a
    beamformer, postfilter or DOA protocol the steered chain has not),
    `NotImplementedError` for an echo canceller or WPE (JAX's steered chain
    has neither); `SteeredEnhancer` raises alike, on every device."""
    with pytest.raises(exc):
        t_steered.build_steered_pipeline(_port_cfg(**cfg_kw), MPOS, case["h"], case["g"], THETAS,
                                         PHIS, device="cpu", **kw)
    p = case["params"]
    with pytest.raises(exc):
        t_steered.SteeredEnhancer(_port_cfg(**cfg_kw), p["h"], p["g"], p["steering"], p["grid"],
                                  p["delay_table"], device="cpu", **kw)


def test_steered_default_device_is_the_card(case):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        t_steered.build_steered_pipeline(_port_cfg(), MPOS, case["h"], case["g"], THETAS, PHIS)
    with pytest.raises(RuntimeError, match="CUDA"):
        t_steered.steered_from_jax_params(case["params"], _port_cfg())


def test_steered_card_refuses_other_filterbanks_at_build():
    """`SteeredEnhancer` on the card raises at construction for M = 4096
    (`pipeline.check_card_shapes`), before any launch and without a card."""
    cfg = _port_cfg(fb=FilterbankParams(M=4096, m=4, r=1, delay_compensation_type=2))
    h = np.zeros(cfg.fb.N, np.float32)
    with pytest.raises(NotImplementedError, match="M=4096"):
        t_steered.build_steered_pipeline(cfg, MPOS, h, h, THETAS, PHIS, device="cuda")
    cpu = t_steered.build_steered_pipeline(cfg, MPOS, h, h, THETAS, PHIS, device="cpu")
    with pytest.raises(NotImplementedError, match="M=4096"):
        t_steered.SteeredEnhancer(cfg, h, h, cpu.steering, cpu.grid, cpu.delay_table,
                                  device="cuda")
