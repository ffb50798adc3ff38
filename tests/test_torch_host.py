"""The PyTorch port's numpy host code equals the JAX package's exactly, and
the port imports without jax.

The port keeps its own copies of the numpy-only modules (prototype design
and loading, array geometry, WAV I/O, DFT matrix builders, filterbank
parameters) because importing any JAX submodule imports jax.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only matters when test workers share the cores
    from contextlib import nullcontext as threadpool_limits

from distant_speech_recognition_tpu.design import nyquist as j_nyquist
from distant_speech_recognition_tpu.ops import dft as j_dft
from distant_speech_recognition_tpu.ops import filterbank as j_fb
from distant_speech_recognition_tpu.utils import geometry as j_geometry
from distant_speech_recognition_tpu.utils import prototypes as j_prototypes
from distant_speech_recognition_tpu.utils import wavio as j_wavio
from distant_speech_recognition_tpu_torch.design import nyquist as t_nyquist
from distant_speech_recognition_tpu_torch.ops import dft as t_dft
from distant_speech_recognition_tpu_torch.ops import filterbank as t_fb
from distant_speech_recognition_tpu_torch.utils import geometry as t_geometry
from distant_speech_recognition_tpu_torch.utils import prototypes as t_prototypes
from distant_speech_recognition_tpu_torch.utils import wavio as t_wavio

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def flagship_designs():
    with threadpool_limits(1):
        return j_nyquist.design_nyquist_pair(256, 4, 1), t_nyquist.design_nyquist_pair(256, 4, 1)


@pytest.mark.parametrize("which", [0, 1], ids=["h", "g"])
def test_design_nyquist_pair_256_4_1_equal(flagship_designs, which):
    want, got = flagship_designs
    np.testing.assert_array_equal(got[which], want[which])


@pytest.mark.parametrize("M,m,r", [(64, 4, 1), (128, 2, 2), (32, 3, 0)])
def test_design_nyquist_pair_small_equal(M, m, r):
    with threadpool_limits(1):
        want = j_nyquist.design_nyquist_pair(M, m, r)
        got = t_nyquist.design_nyquist_pair(M, m, r)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_load_pair_falls_back_to_design(tmp_path):
    with threadpool_limits(1):
        want = j_prototypes.load_pair(64, 4, 1, proto_dir=str(tmp_path))
        got = t_prototypes.load_pair(64, 4, 1, proto_dir=str(tmp_path))
        no_dir = t_prototypes.load_pair(64, 4, 1)
    for a, b, c in zip(got, want, no_dir):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(c, b)


def test_load_pair_reads_pickles(tmp_path, flagship_designs):
    h, g = flagship_designs[0]
    j_prototypes.save_prototype(j_prototypes.prototype_path("h", 256, 4, 1, str(tmp_path)), h)
    j_prototypes.save_prototype(j_prototypes.prototype_path("g", 256, 4, 1, str(tmp_path)), g)
    want = j_prototypes.load_pair(256, 4, 1, proto_dir=str(tmp_path))
    got = t_prototypes.load_pair(256, 4, 1, proto_dir=str(tmp_path))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == np.float64
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("azimuth", [0.0, np.pi / 3, 2.0])
@pytest.mark.parametrize("C", [2, 4, 7])
def test_calc_la_delays_equal(C, azimuth):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    want = j_geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)
    got = t_geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("M", [64, 256, 512])
@pytest.mark.parametrize(
    "builder",
    ["analysis_full", "analysis_half", "analysis_packed", "synthesis_half", "synthesis_packed"],
)
def test_dft_matrix_builders_equal(builder, M):
    want, got = {
        "analysis_full": (j_dft._analysis_matrix(M, False), t_dft.analysis_matrix(M, False)),
        "analysis_half": (j_dft._analysis_matrix(M, True), t_dft.analysis_matrix(M, True)),
        "analysis_packed": (j_dft._analysis_matrix_packed(M), t_dft.analysis_matrix_packed(M)),
        "synthesis_half": (j_dft._synthesis_half_matrix(M), t_dft.synthesis_half_matrix(M)),
        "synthesis_packed": (
            j_dft._synthesis_half_matrix_packed(M), t_dft.synthesis_half_matrix_packed(M)
        ),
    }[builder]
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_dft_matrices_are_read_only():
    with pytest.raises(ValueError):
        t_dft.analysis_matrix_packed(256)[0, 0] = 1.0


@pytest.mark.parametrize("M,R", [(256, 2), (256, 1), (512, 4), (64, 8)])
def test_segment_reversal_perm_equal(M, R):
    assert t_dft.segment_reversal_perm(M, R) == j_dft.segment_reversal_perm(M, R)


@pytest.mark.parametrize("dct", [0, 1, 2])
@pytest.mark.parametrize("M,m,r", [(256, 4, 1), (512, 2, 3), (64, 3, 0)])
def test_filterbank_params_equal(M, m, r, dct):
    j = j_fb.FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dct)
    t = t_fb.FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dct)
    for prop in ("R", "D", "N", "laN", "analysis_delay", "synthesis_delay"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for T in (1, 255, 256, 4096, 5000, 160000):
        assert t_fb.num_analysis_frames(t, T) == j_fb.num_analysis_frames(j, T)


@pytest.mark.parametrize("dtype", ["int16", "float32"])
def test_wavio_round_trip_across_packages(tmp_path, rng, dtype):
    x = (rng.standard_normal((2, 1000)) * 0.1).astype(np.float32)
    a, b = tmp_path / "a.wav", tmp_path / "b.wav"
    t_wavio.write_wav(str(a), x, 16000, dtype=dtype)
    j_wavio.write_wav(str(b), x, 16000, dtype=dtype)
    assert a.read_bytes() == b.read_bytes()
    got, rate = t_wavio.read_wav(str(b))
    want, rate_j = j_wavio.read_wav(str(a))
    assert rate == rate_j == 16000
    np.testing.assert_array_equal(got, want)


def test_port_imports_without_jax():
    """Every module of the port imports in a fresh interpreter with no jax."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import distant_speech_recognition_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "want = {'models.aec', 'models.dereverberation', 'ops.aec_kernels', 'ops.wpe_kernels',\n"
        "        'models.fixed_weight', 'models.localization', 'models.steered',\n"
        "        'models.fused_scan', 'ops.filterbank', 'ops.filterbank_kernels'}\n"
        "missing = {pkg.__name__ + '.' + w for w in want} - set(names)\n"
        "assert not missing, missing\n"
        "assert len(names) >= 22, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('distant_speech_recognition_tpu.'))\n"
        "assert not bad, bad\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 22
