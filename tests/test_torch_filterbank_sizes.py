"""The port's pipelines at the card's other filterbank sizes, against the JAX package on the CPU.

BASELINE config 1 (2-channel delay-and-sum at M = 64, m = 4, r = 1, no
postfilter: analysis, the plain product ``wqH X``, synthesis) and the
flagship GSC-RLS + Zelinski at M = 512 (3 channels, ``rls.min_frames=4`` so
the adaptive branch runs): JAX `build_pipeline` (XLA on the CPU) and the
port's `build_pipeline` / `from_jax_params` (the plain versions of the
kernels) on the same numpy batch, B = 2 utterances x 4000 samples of
int16-scale noise from a seed, with prototypes drawn from the same seed.
Budget 3e-4 x max|ref|, the JAX package's one-kernel-vs-split budget
(tests/test_pallas_fused.py::test_fused_mono_kernel_matches_split).  Both
configurations pass `check_card_shapes` for the card, where the same
pipelines run K1 -> [wqH X | K2] -> K3 (chip_smoke.py phase 14).
"""

import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import GSCRLSConfig
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams

B, T, FS = 2, 4000, 16000.0
BUDGET = 3e-4
# name: (M, C, configuration fields shared by both packages)
CASES = {
    "config1 ds+none M=64 C=2": (64, 2, dict(beamformer="ds", postfilter="none")),
    "gsc_rls+zelinski M=512 C=3": (512, 3, dict(beamformer="gsc_rls", postfilter="zelinski",
                                                pf_min_frames=2)),
}


def _refs():
    """Per case: the inputs, the JAX weights and JAX `build_pipeline`'s output."""
    out = {}
    for name, (M, C, kw) in CASES.items():
        rng = np.random.default_rng(M + C)
        mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
        delays = geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3)
        h, g = (rng.standard_normal(M * 4).astype(np.float32) / 16 for _ in range(2))
        x = (rng.standard_normal((B, C, T)) * 1500.0).astype(np.float32)
        jcfg = j_pipe.PipelineConfig(fb=JParams(M=M, m=4, r=1, delay_compensation_type=2),
                                     samplerate=FS, rls=j_gsc.GSCRLSConfig(min_frames=4), **kw)
        ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, delays, h, g)(x))
        vs = np.asarray(j_bf.array_manifold(M, FS, delays))
        params = dict(h=h, g=g, wq_manifold=vs)
        if kw["beamformer"] == "ds":
            params["wqH"] = np.conj(vs)
        else:
            wqH, BmH = j_gsc.gsc_weights(M, FS, delays, 1)
            params |= dict(wqH=np.asarray(wqH), BmH=np.asarray(BmH))
        tcfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=4, r=1,
                                                         delay_compensation_type=2),
                                     samplerate=FS, rls=GSCRLSConfig(min_frames=4), **kw)
        out[name] = dict(mpos=mpos, delays=delays, x=x, ref=ref, params=params, tcfg=tcfg)
    return out


@pytest.fixture(scope="module")
def cases():
    return _refs()


def _run(enh, x):
    kernels.reset_launch_counts()
    with torch.no_grad():
        got = enh(torch.from_numpy(x)).numpy()
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions
    return got


def _err(got, ref):
    assert got.shape == ref.shape and np.isfinite(got).all()
    return np.abs(got - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("name", list(CASES))
def test_build_pipeline_matches_jax(cases, name):
    c = cases[name]
    p = c["params"]
    enh = t_pipe.build_pipeline(c["tcfg"], c["mpos"], c["delays"], p["h"], p["g"], device="cpu")
    assert _err(_run(enh, c["x"]), c["ref"]) <= BUDGET


@pytest.mark.parametrize("name", list(CASES))
def test_from_jax_params_matches_jax(cases, name):
    c = cases[name]
    enh = t_pipe.from_jax_params(c["params"], c["tcfg"], device="cpu")
    assert _err(_run(enh, c["x"]), c["ref"]) <= BUDGET


@pytest.mark.parametrize("name", list(CASES))
def test_card_takes_the_configuration(name):
    M, C, _ = CASES[name]
    t_pipe.check_card_shapes(FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2), C,
                             "cuda")


if __name__ == "__main__":
    # the errors PERF.md records: PYTHONPATH=. python tests/test_torch_filterbank_sizes.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, c in _refs().items():
        p = c["params"]
        built = t_pipe.build_pipeline(c["tcfg"], c["mpos"], c["delays"], p["h"], p["g"],
                                      device="cpu")
        carried = t_pipe.from_jax_params(p, c["tcfg"], device="cpu")
        e_built, e_carried = (_err(_run(e, c["x"]), c["ref"]) for e in (built, carried))
        print(f"{name}: build_pipeline {e_built:.3g}, from_jax_params {e_carried:.3g} x max|ref| "
              f"(budget {BUDGET:g})")
