"""The PyTorch port's filterbank stages against the JAX package's XLA stages.

Same numpy inputs through JAX `analysis_half_real_tm(packed=True)` /
`synthesis_half_real_tm` on the CPU and through the port's plain torch
versions and its kernel wrappers on CPU tensors.  Budget: 2e-5 x max|ref|,
the JAX package's own analysis->synthesis budget
(tests/test_pallas_fused.py::test_fused_roundtrip_reconstruction).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only matters when test workers share the cores
    from contextlib import nullcontext as threadpool_limits

from distant_speech_recognition_tpu.ops import filterbank as j_fb
from distant_speech_recognition_tpu.utils.prototypes import load_pair
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.ops import filterbank as t_fb
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
    analysis_tm_fused,
    synthesis_tm_fused,
)

BUDGET = 2e-5


@pytest.fixture(scope="module")
def protos():
    with threadpool_limits(1):
        return load_pair(256, 4, 1)


def _signal(T):
    rng = np.random.default_rng(12345 + T)
    return (rng.standard_normal((2, 4, T)) * 1500).astype(np.float32)


def _params(dct=2):
    return (
        j_fb.FilterbankParams(M=256, m=4, r=1, delay_compensation_type=dct),
        t_fb.FilterbankParams(M=256, m=4, r=1, delay_compensation_type=dct),
    )


@pytest.mark.parametrize("T", [4096, 5000])
def test_analysis_matches_jax(protos, T):
    h, _ = protos
    jp, tp = _params()
    x = _signal(T)
    ref = np.asarray(j_fb.analysis_half_real_tm(jnp.asarray(x), jnp.asarray(h), jp, packed=True))
    got = t_fb.analysis_half_real_tm(torch.from_numpy(x), h, tp, packed=True).numpy()
    assert got.shape == ref.shape == (t_fb.num_analysis_frames(tp, T), 2, 4, 256)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


@pytest.mark.parametrize("dct", [0, 1])
def test_analysis_other_delay_modes_match_jax(protos, dct):
    h, _ = protos
    jp, tp = _params(dct)
    x = _signal(3000)[:1, :2]
    for packed in (True, False):
        ref = np.asarray(j_fb.analysis_half_real_tm(jnp.asarray(x), jnp.asarray(h), jp, packed=packed))
        got = t_fb.analysis_half_real_tm(torch.from_numpy(x), h, tp, packed=packed).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


@pytest.mark.parametrize("T", [4096, 5000])
def test_synthesis_matches_jax(protos, T):
    h, g = protos
    jp, tp = _params()
    x = _signal(T)
    Yp = np.array(j_fb.analysis_half_real_tm(jnp.asarray(x), jnp.asarray(h), jp, packed=True))
    ref = np.asarray(j_fb.synthesis_half_real_tm(jnp.asarray(Yp), jnp.asarray(g), jp))
    got = t_fb.synthesis_half_real_tm(torch.from_numpy(Yp), g, tp).numpy()
    assert got.shape == ref.shape == (2, 4, (Yp.shape[0] - tp.synthesis_delay) * tp.D)
    np.testing.assert_allclose(got, ref, rtol=0, atol=BUDGET * np.abs(ref).max())


def test_kernel_wrappers_on_cpu_run_the_plain_versions(protos):
    """On CPU tensors the wrappers give the plain result and launch nothing."""
    h, g = protos
    _, tp = _params()
    x = torch.from_numpy(_signal(4096))
    kernels.reset_launch_counts()
    Yr = analysis_tm_fused(x, h, tp)
    torch.testing.assert_close(Yr, t_fb.analysis_half_real_tm(x, h, tp, packed=True), rtol=0, atol=0)
    y = synthesis_tm_fused(Yr[:, :, 0], g, tp)
    torch.testing.assert_close(y, t_fb.synthesis_half_real_tm(Yr[:, :, 0], g, tp), rtol=0, atol=0)
    counts = kernels.launch_counts()
    assert {"analysis_tm", "synthesis_tm"} <= set(counts)
    assert set(counts.values()) == {0}


def test_round_trip_reconstructs(protos):
    """analysis -> synthesis returns the signal (the filterbank's PR design):
    better than 40 dB away from the utterance edges."""
    h, g = protos
    _, tp = _params()
    x = _signal(8000)[0, 0]
    y = t_fb.synthesis_half_real_tm(t_fb.analysis_half_real_tm(torch.from_numpy(x), h, tp, packed=True),
                                    g, tp).numpy()
    n = len(x)
    seg = slice(2048, n - 2048)
    err = y[:n][seg] - x[seg]
    snr = 10 * np.log10((x[seg] ** 2).mean() / (err ** 2).mean())
    assert snr > 40, snr
