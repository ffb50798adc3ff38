"""The PyTorch port's fixed-weight chains (D&S / SD-MVDR / LCMV + Zelinski,
BASELINE configs 1-2) against the JAX package.

- The plain K7 (`fixed_weight.zelinski_apply_plain`) against JAX
  `apply_weights` + `zelinski_postfilter` per utterance, to 3e-5 x max|ref|,
  the JAX package's budget for its fixed-weight kernel
  (tests/test_pallas_fused.py::test_zelinski_apply_pallas_matches_xla);
  the packed lanes have no slot for Im(DC) and Im(Nyquist), so they are
  dropped from the reference as there.
- The port's `build_pipeline` and `from_jax_params` against JAX
  `build_pipeline` (its XLA vmap path on the CPU) on the same numpy batch:
  B=2 utterances x 4 channels x 8000 samples of int16-scale white noise,
  the bench.py array (linear, 50 mm, azimuth pi/3), M=256, m=4, r=1,
  pf_min_frames=2, LCMV with one jammer at 2 pi/3; 3e-4 x max|ref|, the
  JAX package's one-kernel-vs-split budget.  Measured: ds 3.8e-7,
  sd_mvdr 1.3e-5, lcmv 2.9e-5 with the port's own weights (the float32
  eigensolvers of the two packages differ, tests/test_torch_beamforming.py),
  and within 1e-6 with the JAX weights carried across.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.models.postfilter import zelinski_postfilter
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair
from distant_speech_recognition_tpu_torch.models import fixed_weight as t_fw
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.models.beamforming import superdirective_weights
from distant_speech_recognition_tpu_torch.ops.filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    synthesis_half_real_tm,
)
from distant_speech_recognition_tpu_torch.utils.prototypes import (
    load_pair,
    prototype_path,
    save_prototype,
)

B, C, T, M, FS = 2, 4, 8000, 256, 16000.0
BUDGET = 3e-4
K7_BUDGET = 3e-5
BEAMFORMERS = ("ds", "sd_mvdr", "lcmv")
MPOS = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
DELAYS = geometry.calc_la_delays(MPOS[:, :1], azimuth=np.pi / 3)
NOISE_DELAYS = [geometry.calc_la_delays(MPOS[:, :1], azimuth=2 * np.pi / 3)]


def _port_cfg(beamformer, **kw):
    base = dict(fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2), samplerate=FS,
                beamformer=beamformer, postfilter="zelinski", pf_min_frames=2)
    return t_pipe.PipelineConfig(**(base | kw))


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
    """The JAX references, each built once: its pipeline's output and the
    weights it computes, for every fixed-weight beamformer."""
    h, g = _prototypes(tmp_path_factory)
    x = (np.random.default_rng(0).standard_normal((B, C, T)) * 1500.0).astype(np.float32)
    ref, params = {}, {}
    cpu = jax.local_devices(backend="cpu")[0]
    for bf in BEAMFORMERS:
        jcfg = j_pipe.PipelineConfig(fb=JParams(M=256, m=4, r=1, delay_compensation_type=2),
                                     samplerate=FS, beamformer=bf, postfilter="zelinski",
                                     pf_min_frames=2)
        ref[bf] = np.asarray(j_pipe.build_pipeline(jcfg, MPOS, DELAYS, h, g,
                                                   noise_delays=NOISE_DELAYS)(x))
    with jax.default_device(cpu):
        vs = j_bf.array_manifold(M, FS, DELAYS)
        nj = j_bf.array_manifold(M, FS, NOISE_DELAYS[0])
        wqH = {"ds": np.conj(np.asarray(vs)),
               "sd_mvdr": np.asarray(j_bf.superdirective_weights(MPOS, DELAYS, M, FS, mu=0.01)),
               "lcmv": np.asarray(j_bf.lcmv_weights(jnp.stack([vs, nj], axis=1), [1.0, 0.0]))}
    for bf in BEAMFORMERS:
        params[bf] = dict(h=h, g=g, wqH=wqH[bf], wq_manifold=np.asarray(vs))
    return dict(h=h, g=g, x=x, ref=ref, params=params)


def _check(got, ref):
    assert got.shape == ref.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


def _run(enh, case):
    with torch.no_grad():
        return enh(torch.from_numpy(case["x"])).numpy()


@pytest.mark.parametrize("pf_type,pf_min_frames", [(1, 2), (2, 0)])
def test_zelinski_apply_plain_matches_jax(rng, pf_type, pf_min_frames):
    Tf, Bz, F = 23, 3, M // 2 + 1
    delays = np.linspace(0, 3e-4, C)
    ta = np.array(j_bf.array_manifold(M, FS, delays))
    wqH = superdirective_weights(MPOS, delays, M, FS).numpy()
    Yr = (rng.standard_normal((Tf, Bz, C, M)) * 100).astype(np.float32)
    Yr[:, 1, :, :] = 0.0  # a digitally silent utterance: trace 0, the floor, no NaN
    zero = np.zeros((Tf, Bz, C, 1), np.float32)
    X = np.moveaxis(Yr[..., :F] + 1j * np.concatenate([zero, Yr[..., F:], zero], axis=-1),
                    2, 3).astype(np.complex64)  # [Tf, B, F, C]
    ref = np.array(jax.jit(jax.vmap(lambda Xb: zelinski_postfilter(
        Xb, j_bf.apply_weights(jnp.asarray(wqH), Xb), jnp.asarray(ta), 0.6, pf_type,
        pf_min_frames), in_axes=1, out_axes=1))(X))
    ref[..., 0] = ref[..., 0].real
    ref[..., -1] = ref[..., -1].real
    out = t_fw.zelinski_apply_plain(torch.from_numpy(Yr), torch.from_numpy(wqH),
                                    torch.from_numpy(ta), 0.6, pf_type, pf_min_frames).numpy()
    assert out.shape == (Tf, Bz, M) and np.isfinite(out).all()
    got = out[..., :F] + 1j * np.concatenate(
        [np.zeros((Tf, Bz, 1)), out[..., F:], np.zeros((Tf, Bz, 1))], axis=-1)
    np.testing.assert_allclose(got, ref, rtol=0, atol=K7_BUDGET * np.abs(ref).max())
    assert not got[:, 1].any()


@pytest.mark.parametrize("bf", BEAMFORMERS)
def test_build_pipeline_matches_jax(case, bf):
    enh = t_pipe.build_pipeline(_port_cfg(bf), MPOS, DELAYS, case["h"], case["g"],
                                noise_delays=NOISE_DELAYS, device="cpu")
    assert enh.BmH is None
    for name in ("h", "g", "A", "S", "wqH", "wq_manifold"):
        assert getattr(enh, name).is_contiguous(), name
    kernels.reset_launch_counts()
    _check(_run(enh, case), case["ref"][bf])
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions


@pytest.mark.parametrize("bf", BEAMFORMERS)
def test_from_jax_params_matches_jax(case, bf):
    enh = t_pipe.from_jax_params(case["params"][bf], _port_cfg(bf), device="cpu")
    _check(_run(enh, case), case["ref"][bf])


def test_wrappers_on_cpu_run_the_plain_versions(case):
    """On CPU tensors K7's and K8's wrappers are their plain versions: K8's
    is the plain analysis -> plain K7 -> plain synthesis chain."""
    enh = t_pipe.from_jax_params(case["params"]["ds"], _port_cfg("ds"), device="cpu")
    x = torch.from_numpy(case["x"][:1, :, :2000])
    fb = enh.cfg.fb
    kernels.reset_launch_counts()
    with torch.no_grad():
        y = t_fw.analysis_fw_synthesis(x, enh.h, enh.g, fb, enh.wqH, enh.wq_manifold, 0.6, 1, 2,
                                       A=enh.A, S=enh.S)
        Yr = analysis_half_real_tm(x, enh.h, fb, packed=True, A=enh.A)
        Yp = t_fw.zelinski_apply(Yr, enh.wqH, enh.wq_manifold, 0.6, 1, 2)
        assert torch.equal(Yp, t_fw.zelinski_apply_plain(Yr, enh.wqH, enh.wq_manifold, 0.6, 1, 2))
        assert torch.equal(y, synthesis_half_real_tm(Yp, enh.g, fb, S=enh.S))
    assert set(kernels.launch_counts().values()) == {0}


def test_one_kernel_chain_shape_limits():
    """K8 holds 64 // C frames per tile, which must cover the synthesis
    halo of m*R - 1 frames; other shapes run K1 -> K7 -> K3."""
    fb = FilterbankParams(M=256, m=4, r=1)
    assert all(t_fw.fw_mono_supported(fb, c) for c in range(2, 9))
    r2 = FilterbankParams(M=256, m=4, r=2)  # halo 15
    assert [c for c in range(2, 9) if t_fw.fw_mono_supported(r2, c)] == [2, 3, 4]
    assert not t_fw.fw_mono_supported(FilterbankParams(M=512, m=4, r=1), 4)
    assert not t_fw.fw_mono_supported(fb, 9)


@pytest.mark.parametrize("kw", [dict(aec="block_kalman", aec_taps=2), dict(wpe=True, wpe_upper=12),
                                dict(postfilter="wiener"), dict(aec="dtd_block_kalman")])
def test_unported_fixed_weight_configurations_raise(kw):
    """What the port still does not run is refused at build time on every
    device: the block Kalman canceller with more than one tap, WPE past C*P
    = 40 (here 4 x 11), a postfilter or echo canceller it does not have."""
    with pytest.raises(NotImplementedError):
        t_pipe.build_pipeline(_port_cfg("sd_mvdr", **kw), MPOS, DELAYS, np.zeros(1024),
                              np.zeros(1024), device="cpu")


@pytest.mark.parametrize("kw", [dict(aec="nlms"), dict(wpe=True), dict(postfilter="apab"),
                                dict(postfilter="mccowan")])
def test_fixed_weights_with_aec_wpe_or_coherence_postfilters_run(case, kw):
    """Fixed weights behind the echo canceller or WPE, and with the APAB or
    McCowan postfilter, build and run on the CPU (held to JAX in
    tests/test_torch_postfilter_chain.py): finite output of the plain
    chain's length."""
    enh = t_pipe.build_pipeline(_port_cfg("sd_mvdr", **kw), MPOS, DELAYS, case["h"], case["g"],
                                device="cpu")
    x = torch.from_numpy(case["x"][:1, :, :2000])
    play = torch.from_numpy(case["x"][:1, 0, :2000]) if enh.cfg.aec != "none" else None
    with torch.no_grad():
        y = enh(x, play)
    assert y.shape[0] == 1 and y.shape[1] > 0 and torch.isfinite(y).all()


def test_fixed_weight_parameters_are_checked(case):
    params = dict(case["params"]["ds"])
    with pytest.raises(ValueError, match="blocking"):
        t_pipe.from_jax_params(dict(params, BmH=np.zeros((M // 2 + 1, C - 1, C), np.complex64)),
                               _port_cfg("ds"), device="cpu")
    del params["wq_manifold"]
    with pytest.raises(KeyError, match="wq_manifold"):
        t_pipe.from_jax_params(params, _port_cfg("ds"), device="cpu")
