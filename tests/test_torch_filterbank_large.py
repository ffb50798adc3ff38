"""The port's pipelines at the largest filterbanks the card takes, M = 1024
and 2048, against the JAX package on the CPU.

JAX `build_pipeline` / `build_steered_pipeline` (XLA on the CPU) and the
port's `build_pipeline` / `from_jax_params` / `build_steered_pipeline` (the
plain versions of the kernels) on the same numpy batch: B = 2 utterances of
int16-scale noise (3 placed sources plus sensor noise for the steered
chain), the designed Nyquist(M) prototypes stored in
``tests/data/prototypes`` (`design_nyquist_pair`, which takes minutes at
2048), ``min_frames=4`` so the
adaptive branches run.  The cases: GSC-RLS + Zelinski at M = 2048 (3
channels), the NLMS canceller -> WPE -> GSC-LMS + Zelinski at M = 1024 (4
channels and a far end), D&S + McCowan at M = 2048 (2 channels), GSC-RLS +
Zelinski at M = 1024 with r = 3 (the m*R = 32 halo K3's tile holds there),
and the SRP-PHAT-steered GSC-RLS + Zelinski at M = 1024 with its DOA equal
to JAX's and at the placed sources.  Budget 3e-4 x max|ref|, the JAX package's one-kernel-vs-split
budget.  Each configuration passes `check_card_shapes` for the card, where
the same pipelines run K1 -> [K9 -> WPE ->] K2 / the LMS scan / the
postfilter kernel -> K3 and K1 -> DOA -> K6 -> K3 (chip_smoke.py phase 16).
"""

from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.models import steered as j_steered
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.models import steered as t_steered
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import GSCLMSConfig, GSCRLSConfig
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair
from test_torch_steered import MPOS, PHIS, PLACED, THETAS, _placed_sources

PROTO_DIR = str(Path(__file__).parent / "data" / "prototypes")

B, FS = 2, 16000.0
BUDGET = 3e-4
CHAIN = dict(aec="nlms", wpe=True, wpe_iterations=2)
# name: (M, r, C, configuration fields shared by both packages)
CASES = {
    "gsc_rls+zelinski M=2048 C=3": (2048, 1, 3, dict(beamformer="gsc_rls",
                                                      postfilter="zelinski")),
    "nlms+wpe+gsc_lms+zelinski M=1024 C=4": (1024, 1, 4, dict(beamformer="gsc_lms",
                                                              postfilter="zelinski", **CHAIN)),
    "ds+mccowan M=2048 C=2": (2048, 1, 2, dict(beamformer="ds", postfilter="mccowan")),
    "gsc_rls+zelinski M=1024 r=3 C=3": (1024, 3, 3, dict(beamformer="gsc_rls",
                                                         postfilter="zelinski")),
}
STEERED_M = 1024
STEERED = "steered gsc_rls+zelinski M=1024"


def _fb(M, r, pkg=FilterbankParams):
    return pkg(M=M, m=4, r=r, delay_compensation_type=2)


def _prototypes(M, r):
    return load_pair(M, 4, r, proto_dir=PROTO_DIR)


def _case(name):
    """The inputs, the JAX parameters and JAX `build_pipeline`'s output."""
    M, r, C, kw = CASES[name]
    rng = np.random.default_rng(M + r + C)
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
    h, g = _prototypes(M, r)
    T = 4 * M if r == 1 else 3 * M  # frames past min_frames: the adaptive branches run
    args = ((rng.standard_normal((B, C, T)) * 1500.0).astype(np.float32),)
    if "aec" in kw:
        args += ((rng.standard_normal((B, T)) * 1500.0).astype(np.float32),)
    common = dict(samplerate=FS, pf_min_frames=2, **kw)
    jcfg = j_pipe.PipelineConfig(fb=_fb(M, r, JParams), rls=j_gsc.GSCRLSConfig(min_frames=4),
                                 lms=j_gsc.GSCLMSConfig(min_frames=4), **common)
    ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, delays, h, g)(*args))
    vs = np.asarray(j_bf.array_manifold(M, FS, delays))
    params = dict(h=h, g=g, wq_manifold=vs)
    if kw["beamformer"] == "ds":
        params["wqH"] = np.conj(vs)
        params["Gamma"] = np.asarray(j_bf.diffuse_noise_coherence(mpos, M, FS))
    else:
        wqH, BmH = j_gsc.gsc_weights(M, FS, delays, 1)
        params |= dict(wqH=np.asarray(wqH), BmH=np.asarray(BmH))
    tcfg = t_pipe.PipelineConfig(fb=_fb(M, r), rls=GSCRLSConfig(min_frames=4),
                                 lms=GSCLMSConfig(min_frames=4), **common)
    return dict(mpos=mpos, delays=delays, args=args, ref=ref, params=params, tcfg=tcfg)


def _steered_case():
    """The steered chain's input, configuration and JAX output and DOA."""
    M = STEERED_M
    h, g = _prototypes(M, 1)
    x = _placed_sources(np.random.default_rng(0))
    common = dict(samplerate=FS, beamformer="gsc_rls", postfilter="zelinski", pf_min_frames=2)
    jcfg = j_pipe.PipelineConfig(fb=_fb(M, 1, JParams), rls=j_gsc.GSCRLSConfig(min_frames=4),
                                 **common)
    y_ref, doa_ref = (np.asarray(a) for a in j_steered.build_steered_pipeline(
        jcfg, MPOS, h, g, THETAS, PHIS)(jnp.asarray(x)))
    cfg = t_pipe.PipelineConfig(fb=_fb(M, 1), rls=GSCRLSConfig(min_frames=4), **common)
    return dict(h=h, g=g, x=x, cfg=cfg, ref=y_ref, doa_ref=doa_ref)


def _refs():
    """Every case's JAX reference, the steered chain's under ``STEERED``.
    Nearly all of each one's time is XLA compiling, which runs outside the
    GIL, so the cases run side by side in threads."""
    jobs = {name: partial(_case, name) for name in CASES} | {STEERED: _steered_case}
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {name: pool.submit(job) for name, job in jobs.items()}
        return {name: f.result() for name, f in futures.items()}


@pytest.fixture(scope="module")
def cases():
    return _refs()


def _run(enh, args):
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = enh(*(torch.from_numpy(a) for a in args))
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions
    return got


def _err(got, ref):
    got = got.numpy()
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", list(CASES))
def test_build_pipeline_matches_jax(cases, name):
    c = cases[name]
    p = c["params"]
    enh = t_pipe.build_pipeline(c["tcfg"], c["mpos"], c["delays"], p["h"], p["g"], device="cpu")
    assert _err(_run(enh, c["args"]), c["ref"]) <= BUDGET


@pytest.mark.parametrize("name", list(CASES))
def test_from_jax_params_matches_jax(cases, name):
    c = cases[name]
    enh = t_pipe.from_jax_params(c["params"], c["tcfg"], device="cpu")
    assert _err(_run(enh, c["args"]), c["ref"]) <= BUDGET


@pytest.mark.parametrize("name", list(CASES))
def test_card_takes_the_configuration(name):
    M, r, C, _ = CASES[name]
    t_pipe.check_card_shapes(_fb(M, r), C, "cuda")


def test_steered_chain_matches_jax(cases):
    """SRP-PHAT DOA -> steered GSC-RLS + Zelinski at M = 1024 on the
    4-mic circular array: the DOA equal to JAX's and at the placed sources,
    the output within budget."""
    assert _steered_err(cases[STEERED]) <= BUDGET


def _steered_err(c):
    t_pipe.check_card_shapes(c["cfg"].fb, MPOS.shape[0], "cuda")
    enh = t_steered.build_steered_pipeline(c["cfg"], MPOS, c["h"], c["g"], THETAS, PHIS,
                                           device="cpu")
    y, doa = _run(enh, (c["x"],))
    np.testing.assert_array_equal(doa.numpy(), c["doa_ref"])
    np.testing.assert_array_equal(doa.numpy()[:, 1], np.float32(PHIS[PLACED]))
    return _err(y, c["ref"])


if __name__ == "__main__":
    # the errors PERF.md records: PYTHONPATH=.:tests python tests/test_torch_filterbank_large.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    refs = _refs()
    for name in CASES:
        c = refs[name]
        p = c["params"]
        built = t_pipe.build_pipeline(c["tcfg"], c["mpos"], c["delays"], p["h"], p["g"],
                                      device="cpu")
        carried = t_pipe.from_jax_params(p, c["tcfg"], device="cpu")
        e_built, e_carried = (_err(_run(e, c["args"]), c["ref"]) for e in (built, carried))
        print(f"{name}: build_pipeline {e_built:.3g}, from_jax_params {e_carried:.3g} x max|ref| "
              f"(budget {BUDGET:g})")
    print(f"steered gsc_rls+zelinski M={STEERED_M}: {_steered_err(refs[STEERED]):.3g} x "
          f"max|ref|, DOA equal")
