"""Every configuration of the port's steered chain against the JAX package.

JAX's `build_steered_pipeline` (its XLA vmap chain `_one` on the CPU) and
the port's `build_steered_pipeline` / `steered_from_jax_params` on the CPU
(the plain versions of K1, K7, the LMS and RLS scans and K3) take the same
numpy batch as ``tests/test_torch_steered.py``: B=3 utterances on a 4-mic
circular array, 8000 samples each, one source per utterance placed at a
grid direction plus sensor noise 20 dB down, a 12-point azimuth grid, the
adaptive GSCs from frame 4.  Each case is one JAX compile.  The DOA must be
equal (and the placed direction) and the output within 3e-4 x max|ref|
(measured 4.3e-7 to 7.9e-7) for D&S, GSC-LMS and GSC-RLS with and without
the Zelinski postfilter, the DSBLA protocol (with and without an energy
threshold, the threshold on an utterance zero-padded after 5000 samples,
whose silent frames it skips) and an SRP bin range; `steered_from_jax_params`
takes JAX's DSBLA table.  Given one steering broadcast to every utterance,
the steered K7's and LMS scan's plain versions give the shared-weight
kernels' plain output bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import localization as j_loc
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.models import steered as j_steered
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils.geometry import calc_ca_delays
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import steered as t_steered
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (
    GSCLMSConfig,
    GSCRLSConfig,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold
from distant_speech_recognition_tpu_torch.models.fixed_weight import (
    zelinski_apply,
    zelinski_apply_steered,
)
from distant_speech_recognition_tpu_torch.models.fused_scan import (
    NO_POSTFILTER,
    gsc_lms_zelinski,
    gsc_lms_zelinski_steered,
)
from distant_speech_recognition_tpu_torch.models.localization import srp_dsbla
from distant_speech_recognition_tpu_torch.models.pipeline import PipelineConfig
from distant_speech_recognition_tpu_torch.ops.filterbank import (
    FilterbankParams,
    analysis_snapshots_half,
)
from test_torch_steered import FS, MPOS, PHIS, PLACED, THETAS, _placed_sources, _prototypes

M = 256
BUDGET = 3e-4
PAD_FROM = 5000  # utterance 1 of the DSBLA threshold case is silent from here on
# between the placed sources' frame energies (3.8e3 at a fading last frame
# up to ~1e14) and above the fading frames of the padded utterance (6.7e7
# and below): skips them and its silent frames
ENERGY_THRESHOLD = 1e10

# (port beamformer, postfilter, build_steered_pipeline keywords, zero-padded)
CASES = {
    "ds-zelinski": ("ds", "zelinski", {}, False),
    "ds-none": ("ds", "none", {}, False),
    "lms-zelinski": ("gsc_lms", "zelinski", {}, False),
    "lms-none": ("gsc_lms", "none", {}, False),
    "rls-none": ("gsc_rls", "none", {}, False),
    "rls-zelinski-dsbla": ("gsc_rls", "zelinski", dict(doa_protocol="dsbla"), False),
    "rls-zelinski-dsbla-threshold": (
        "gsc_rls", "zelinski", dict(doa_protocol="dsbla", energy_threshold=ENERGY_THRESHOLD),
        True),
    "lms-zelinski-bins-5-100": ("gsc_lms", "zelinski", dict(min_bin=5, max_bin=100), False),
}


def _port_cfg(bf, pf):
    return PipelineConfig(fb=FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2),
                          samplerate=FS, beamformer=bf, postfilter=pf, pf_min_frames=2,
                          rls=GSCRLSConfig(min_frames=4), lms=GSCLMSConfig(min_frames=4))


def _input(padded):
    x = _placed_sources(np.random.default_rng(0))
    if padded:
        x[1, :, PAD_FROM:] = 0.0
    return x


@pytest.fixture(scope="module")
def protos(tmp_path_factory):
    return _prototypes(tmp_path_factory)


_JAX = {}


def _jax_case(name, protos):
    """JAX's output and DOA for case ``name``, computed once per process."""
    if name not in _JAX:
        bf, pf, kw, padded = CASES[name]
        jcfg = j_pipe.PipelineConfig(
            fb=JParams(M=M, m=4, r=1, delay_compensation_type=2), samplerate=FS, beamformer=bf,
            postfilter=pf, pf_min_frames=2, rls=j_gsc.GSCRLSConfig(min_frames=4),
            lms=j_gsc.GSCLMSConfig(min_frames=4))
        y, doa = j_steered.build_steered_pipeline(jcfg, MPOS, *protos, THETAS, PHIS, **kw)(
            jnp.asarray(_input(padded)))
        _JAX[name] = (np.asarray(y), np.asarray(doa))
    return _JAX[name]


def _check(enh, x, want):
    y_ref, doa_ref = want
    kernels.reset_launch_counts()
    with torch.no_grad():
        y, doa = enh(torch.from_numpy(x))
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions
    np.testing.assert_array_equal(doa.numpy(), doa_ref)
    np.testing.assert_array_equal(doa.numpy()[:, 1], np.float32(PHIS[PLACED]))
    y = y.numpy()
    assert y.shape == y_ref.shape and np.isfinite(y).all()
    np.testing.assert_allclose(y, y_ref, rtol=0, atol=BUDGET * np.abs(y_ref).max())


@pytest.mark.parametrize("name", list(CASES))
def test_steered_variant_matches_jax(protos, name):
    bf, pf, kw, padded = CASES[name]
    enh = t_steered.build_steered_pipeline(_port_cfg(bf, pf), MPOS, *protos, THETAS, PHIS,
                                           device="cpu", **kw)
    x = _input(padded)
    _check(enh, x, _jax_case(name, protos))
    if padded:  # the threshold skips the padded utterance's silent frames, and only there
        X = analysis_snapshots_half(torch.from_numpy(x), enh.h, enh.cfg.fb)
        ok = srp_dsbla(X, enh.wq_table, 1, None, ENERGY_THRESHOLD)[2]
        assert (~ok[1]).sum() >= 20 and ok[0, :-3].all() and ok[2, :-3].all()


def test_steered_from_jax_params_dsbla(protos):
    """`steered_from_jax_params` with JAX's tables, DSBLA's ``wq_table``
    built as JAX builds it (the manifolds of the float64 delays), equals
    JAX's chain; without the table it raises `KeyError`."""
    h, g = protos
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        steering, grid = j_loc.srp_phat_steering_table(MPOS, M, FS, THETAS, PHIS)
        delay_table = np.stack([calc_ca_delays(MPOS, p, t) for t, p in np.asarray(grid)])
        wq_table = np.stack([np.asarray(j_bf.array_manifold(M, FS, d)) for d in delay_table])
    params = dict(h=h, g=g, steering=np.asarray(steering), grid=np.asarray(grid),
                  delay_table=delay_table.astype(np.float32), wq_table=wq_table)
    cfg = _port_cfg("gsc_rls", "zelinski")
    enh = t_steered.steered_from_jax_params(params, cfg, doa_protocol="dsbla", device="cpu")
    built = t_steered.build_steered_pipeline(cfg, MPOS, h, g, THETAS, PHIS, device="cpu",
                                             doa_protocol="dsbla")
    np.testing.assert_array_equal(built.wq_table.numpy(), wq_table)
    _check(enh, _input(False), _jax_case("rls-zelinski-dsbla", protos))
    del params["wq_table"]
    with pytest.raises(KeyError, match="wq_table"):
        t_steered.steered_from_jax_params(params, cfg, doa_protocol="dsbla", device="cpu")


@pytest.mark.parametrize("pf_min_frames", [2, NO_POSTFILTER])
def test_steered_wrappers_broadcast_is_bit_equal(rng, pf_min_frames):
    """The steered K7 and LMS scan wrappers on CPU tensors (their plain
    versions, no launch) with one steering broadcast to every utterance
    equal the shared-weight wrappers bit for bit."""
    d = calc_ca_delays(MPOS, 1.0, np.pi / 2)
    wqH, BmH = gsc_weights(M, FS, d)
    vs = array_manifold(M, FS, d)
    Yp = torch.from_numpy((rng.standard_normal((12, 3, 4, M)) * 100).astype(np.float32))
    rows = [w.expand((3,) + w.shape) for w in (wqH, BmH, vs)]
    cfg = GSCLMSConfig(min_frames=4)
    kernels.reset_launch_counts()
    assert torch.equal(zelinski_apply_steered(Yp, rows[0], rows[2], 0.6, 1, pf_min_frames),
                       zelinski_apply(Yp, wqH, vs, 0.6, 1, pf_min_frames))
    assert torch.equal(gsc_lms_zelinski_steered(Yp, *rows, cfg, 0.6, 2, pf_min_frames),
                       gsc_lms_zelinski(Yp, wqH, BmH, vs, cfg, 0.6, 2, pf_min_frames))
    assert set(kernels.launch_counts().values()) == {0}
