"""The port's localization layer, array geometry, windows and STFT against
the JAX package, on seeded numpy input (plain torch on the CPU; no kernel).

Each function of ``models/localization.py`` (GCC-PHAT and weighted GCC in
all six modes with and without cross-spectrum smoothing, the noise spectra,
TDOA peaks, feature gating and the pair model, SRP and DSBLA, linear SRP,
the CC peak search, MCC on a delay grid and the reference's block protocol
and grid), the geometry delays, `get_window`, `stft_analysis` and
`analysis_snapshots_half` take the same numpy input as its JAX counterpart.
Tolerances, each against max|ref| of the compared output (measured on this
input, CPU): 2e-6 for the GCC family and the noise spectra (float32 FFTs
and sums in another order; measured at most 2.3e-7), 2e-6 for DSBLA's
powers and its frame energy (a quadratic form summed in another order;
2.1e-7), 1e-6 for the linear SRP (1.0e-7), 1e-6 for the pair TDOA model
and Jacobian and the CC peak's delay (measured equal), 2e-5 for the STFT
and the snapshots (the analysis bank's own budget; 2.3e-7), 1e-5 for MCC's
MCCC (a float32 log-determinant; 1.1e-6); integer and boolean
outputs (peaks' lags, gates, grids, N-best indices, frame masks) and the
numpy functions (geometry, windows, MCC grid and blocks) are equal.
DSBLA's N-best order on tied powers (exact integer arithmetic) is JAX's
``top_k`` order, the lower index first.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.models import localization as j_loc
from distant_speech_recognition_tpu.ops import filterbank as j_fb
from distant_speech_recognition_tpu.ops import windows as j_win
from distant_speech_recognition_tpu.utils import geometry as j_geo
from distant_speech_recognition_tpu_torch.models import localization as t_loc
from distant_speech_recognition_tpu_torch.ops import filterbank as t_fb
from distant_speech_recognition_tpu_torch.ops import windows as t_win
from distant_speech_recognition_tpu_torch.utils import geometry as t_geo

FS = 16000.0


def _close(got, want, rel):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.shape, got.dtype,
                                                                want.shape, want.dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _cplx(rng, shape, scale=1.0):
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale).astype(
        np.complex64)


@pytest.fixture(scope="module")
def spectra():
    """Two channels' half-band spectra [T=40, F=65]: frames 5-9 quiet (below
    gcc_phat's energy threshold), a zero bin, a noise mask."""
    rng = np.random.default_rng(3)
    X1, X2 = _cplx(rng, (40, 65), 10.0), _cplx(rng, (40, 65), 10.0)
    X2 = (0.7 * X2 + 0.5 * np.roll(X1, 1, axis=0)).astype(np.complex64)
    X1[5:10] *= np.float32(1e-3)
    X2[5:10] *= np.float32(1e-3)
    X1[12, 7] = 0.0
    mask = rng.random(40) < 0.4
    return X1, X2, mask


def test_mic_pairs():
    assert t_loc.mic_pairs(5) == j_loc.mic_pairs(5)


def test_gcc_phat_and_tdoa_peaks(spectra):
    X1, X2, _ = spectra
    want = np.asarray(j_loc.gcc_phat(jnp.asarray(X1), jnp.asarray(X2), 128, 64.0))
    got = t_loc.gcc_phat(torch.from_numpy(X1), torch.from_numpy(X2), 128, 64.0)
    _close(got, want, 2e-6)
    assert not want[5:10].any() and not got[5:10].any()
    # the peaks of the same CC: lags equal, heights the CC's own values
    d_j, h_j = j_loc.tdoa_peaks(jnp.asarray(want), FS)
    d_t, h_t = t_loc.tdoa_peaks(torch.from_numpy(want.copy()), FS)
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    # gating by height and pair count
    rng = np.random.default_rng(4)
    delays = rng.standard_normal((7, 6)).astype(np.float32) * 1e-4
    heights = rng.random((7, 6)).astype(np.float32) * 0.3
    for got_, want_ in zip(t_loc.tdoa_feature_vectors(torch.from_numpy(delays),
                                                      torch.from_numpy(heights), 0.12, 3),
                           j_loc.tdoa_feature_vectors(jnp.asarray(delays), jnp.asarray(heights),
                                                      0.12, 3)):
        np.testing.assert_array_equal(got_.numpy(), np.asarray(want_))


def test_pair_tdoa_model_and_jacobian():
    rng = np.random.default_rng(5)
    mpos = rng.standard_normal((5, 3)) * 100.0
    pairs = j_loc.mic_pairs(5)
    for x in (np.array([1200.0, -300.0, 250.0]), rng.standard_normal(3) * 2000.0):
        _close(t_loc.pair_tdoa_model(x, mpos, pairs), j_loc.pair_tdoa_model(x, mpos, pairs), 1e-6)
        _close(t_loc.pair_tdoa_jacobian(torch.tensor(x, dtype=torch.float32), mpos, pairs),
               j_loc.pair_tdoa_jacobian(jnp.asarray(x, jnp.float32), mpos, pairs), 1e-6)


def test_snapshot_energy_and_srp_dsbla():
    """The energies, powers and gates of DSBLA at a bin range and with a
    threshold between the frames' energies, and its 3 best directions."""
    rng = np.random.default_rng(6)
    X = _cplx(rng, (2, 20, 33, 4), 30.0)
    X[:, 4:8] *= np.float32(1e-2)  # quiet frames under the threshold
    W = _cplx(rng, (9, 33, 4)) / 4
    Xj, Wj = jnp.asarray(X), jnp.asarray(W)
    for lo, hi in ((1, None), (3, 20), (0, 32)):
        e_j = np.asarray(j_loc.snapshot_energy(Xj, lo, 32 if hi is None else hi, 32))
        _close(t_loc.snapshot_energy(torch.from_numpy(X), lo, 32 if hi is None else hi, 32), e_j,
               2e-6)
        thr = float(np.median(e_j))
        idx_j, acc_j, ok_j = j_loc.srp_dsbla(Xj, Wj, lo, hi, thr, 3)
        idx_t, acc_t, ok_t = t_loc.srp_dsbla(torch.from_numpy(X), torch.from_numpy(W), lo, hi,
                                             thr, 3)
        np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
        assert not np.asarray(ok_j)[:, 4:8].any() and np.asarray(ok_j).any()
        _close(acc_t, acc_j, 2e-6)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_srp_dsbla_ties_take_the_lower_index():
    """Snapshots and steering of small Gaussian integers, so every power is
    exact in float32 and rows 1, 3 and 5 (w, j w, -w: the same power) tie
    at the top; both give [1, 3, 5], JAX's ``top_k`` order."""
    rng = np.random.default_rng(7)
    units = np.array([1, -1, 1j, -1j], np.complex64)
    W = units[rng.integers(0, 4, (8, 17, 4))]
    W[3], W[5] = 1j * W[1], -W[1]
    noise = rng.integers(-1, 2, (12, 17, 4)) + 1j * rng.integers(-1, 2, (12, 17, 4))
    X = (W[1][None] * rng.integers(2, 5, (12, 1, 1)) + noise).astype(np.complex64)
    idx_j, acc_j, _ = j_loc.srp_dsbla(jnp.asarray(X), jnp.asarray(W), 1, None, 0.0, 3)
    idx_t, acc_t, _ = t_loc.srp_dsbla(torch.from_numpy(X), torch.from_numpy(W), 1, None, 0.0, 3)
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    assert acc_t[1] == acc_t[3] == acc_t[5] == acc_t.max()
    np.testing.assert_array_equal(idx_t.numpy(), [1, 3, 5])
    np.testing.assert_array_equal(np.asarray(idx_j), [1, 3, 5])
    assert t_loc.srp_dsbla(torch.from_numpy(X), torch.from_numpy(W))[0].item() == 1


def test_linear_srp():
    xpos = np.array([-75.0, -25.0, 25.0, 75.0])
    W_j, s_j = j_loc.linear_srp_steering_table(xpos, 128, FS)
    W_t, s_t = t_loc.linear_srp_steering_table(xpos, 128, FS)
    np.testing.assert_array_equal(W_t.numpy(), np.asarray(W_j))
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    rng = np.random.default_rng(8)
    X = (np.asarray(W_j)[7][None] * 40 + _cplx(rng, (3, 65, 4))).astype(np.complex64)
    for lo, hi in ((1, None), (4, 50)):
        doa_j, srp_j = j_loc.linear_srp_doa(jnp.asarray(X), W_j, s_j, lo, hi)
        doa_t, srp_t = t_loc.linear_srp_doa(torch.from_numpy(X), W_t, s_t, lo, hi)
        _close(srp_t, srp_j, 1e-6)
        np.testing.assert_array_equal(doa_t.numpy(), np.asarray(doa_j))


@pytest.mark.parametrize("smooth_beta", [0.0, 0.7])
@pytest.mark.parametrize("mode", ["raw", "gnn_sub", "phat", "gnn_sub_phat", "mlr_raw",
                                  "mlr_gnn_sub"])
def test_gcc_weighted(spectra, mode, smooth_beta):
    """Each weighting, with the noise statistics of `noise_spectra` over the
    masked frames (held to JAX's too) and for the modes that take them also
    without."""
    X1, X2, mask = spectra
    nj = j_loc.noise_spectra(jnp.asarray(X1), jnp.asarray(X2), mask, 0.9)
    nt = t_loc.noise_spectra(torch.from_numpy(X1), torch.from_numpy(X2), mask, 0.9)
    for a, b in zip(nt, nj):
        _close(a, b, 2e-6)
    N1, N2, G = (np.asarray(a) for a in nj)
    variants = [dict(Gn1n2=G, N1=N1, N2=N2)]
    if mode != "gnn_sub":
        variants.append({})
    for kw in variants:
        want = j_loc.gcc_weighted(jnp.asarray(X1), jnp.asarray(X2), 128, mode, q=0.4,
                                  smooth_beta=smooth_beta, **kw)
        got = t_loc.gcc_weighted(torch.from_numpy(X1), torch.from_numpy(X2), 128, mode, q=0.4,
                                 smooth_beta=smooth_beta, **kw)
        _close(got, want, 2e-6)
    if mode == "gnn_sub":
        with pytest.raises(ValueError, match="Gn1n2"):
            t_loc.gcc_weighted(torch.from_numpy(X1), torch.from_numpy(X2), 128, mode)


@pytest.mark.parametrize("interpolate", [True, False])
def test_find_cc_peak(interpolate):
    rng = np.random.default_rng(9)
    cc = rng.standard_normal((4, 5, 64)).astype(np.float32)
    for lo, hi in ((-np.inf, np.inf), (-8 / FS, 5 / FS)):
        d_j, p_j = j_loc.find_cc_peak(jnp.asarray(cc), FS, lo, hi, interpolate)
        d_t, p_t = t_loc.find_cc_peak(torch.from_numpy(cc), FS, lo, hi, interpolate)
        np.testing.assert_array_equal(p_t.numpy(), np.asarray(p_j))
        _close(d_t, d_j, 1e-6)


def test_mcc_grids_and_blocks():
    """The delay grid and the reference's MCC grid equal JAX's (the grid
    walk bit for bit), and so does the block protocol (both numpy)."""
    for got, want in zip(t_loc.linear_array_delay_grid([0.0, 40.0, 80.0, 120.0], 19),
                         j_loc.linear_array_delay_grid([0.0, 40.0, 80.0, 120.0], 19)):
        np.testing.assert_array_equal(got, want)
    for nc, dist in ((4, 40.0), (3, 100.0), (8, 25.0)):
        got, want = t_loc.mcc_reference_grid(nc, dist), j_loc.mcc_reference_grid(nc, dist)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    tau, _, maxd = j_loc.mcc_reference_grid(4, 40.0)
    x = np.random.default_rng(10).standard_normal((4, 1600))
    for a, b in zip(t_loc.mcc_localize_blocks(x, 400, tau, maxd, 3),
                    j_loc.mcc_localize_blocks(x, 400, tau, maxd, 3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("normalize_variance", [True, False])
def test_mcc_localize(normalize_variance):
    """A source that the channels hear at grid point 5's sample delays plus
    noise: the best hypotheses and the MCCC of every grid point."""
    delays, _ = j_loc.linear_array_delay_grid([0.0, 40.0, 80.0, 120.0], 12)
    rng = np.random.default_rng(11)
    src = rng.standard_normal(1400)
    x = np.stack([src[40 - d:40 - d + 1200] for d in delays[5]])
    x = (x + 0.3 * rng.standard_normal(x.shape)).astype(np.float32)
    b_j, m_j = j_loc.mcc_localize(jnp.asarray(x), delays, 3, normalize_variance)
    b_t, m_t = t_loc.mcc_localize(torch.from_numpy(x), delays, 3, normalize_variance)
    np.testing.assert_array_equal(b_t.numpy(), np.asarray(b_j))
    _close(m_t, m_j, 1e-5)


def test_geometry_delays():
    rng = np.random.default_rng(12)
    m3 = rng.standard_normal((5, 3)) * 100.0
    cases = [
        ("calc_pa_delays", (m3[:, :2], 0.7, 1.1), {}),
        ("calc_pa_delays", (m3[:, :2], 2.0, 0.4), dict(ref_micx=0, sspeed=340000.0)),
        ("calc_nf_delays", (m3, 500.0, -200.0, 1000.0), {}),
        ("calc_nf_delays", (m3, 50.0, 20.0, -300.0), dict(ref_micx=4)),
        ("calc_la_delays", (m3[:, :1], 0.3), {}),
        ("calc_ca_delays", (m3, 0.3, 1.2), {}),
    ]
    for name, args, kw in cases:
        np.testing.assert_array_equal(getattr(t_geo, name)(*args, **kw),
                                      getattr(j_geo, name)(*args, **kw))
    for kind, pos in (("linear", (0.4,)), ("planar", (0.4, 1.0)), ("circular", (0.4, 1.0)),
                      ("near", (300.0, 100.0, 900.0))):
        mp = m3[:, :2] if kind == "planar" else (m3[:, :1] if kind == "linear" else m3)
        np.testing.assert_array_equal(t_geo.calc_delays(kind, mp, pos),
                                      j_geo.calc_delays(kind, mp, pos))


def test_get_window():
    for wt in (0, 1, 2, 5):
        for n in (8, 255):
            np.testing.assert_array_equal(t_win.get_window(wt, n), j_win.get_window(wt, n))


@pytest.mark.parametrize("r,window_type", [(0, 1), (1, 2), (2, 0)])
def test_stft_analysis(r, window_type):
    x = (np.random.default_rng(13).standard_normal((2, 3001)) * 1500).astype(np.float32)
    want = np.asarray(j_fb.stft_analysis(jnp.asarray(x), 64, r, window_type))
    _close(t_fb.stft_analysis(torch.from_numpy(x), 64, r, window_type), want, 2e-5)


@pytest.mark.parametrize("M,m,r,dct,T", [(64, 4, 1, 2, 3000), (128, 2, 2, 0, 2500),
                                         (4096, 1, 0, 1, 20000)])
def test_analysis_snapshots_half(M, m, r, dct, T):
    """The matrix-product route and, above ``MATMUL_MAX_M``, the FFT route."""
    rng = np.random.default_rng(14)
    h = (rng.standard_normal(M * m) / np.sqrt(M * m)).astype(np.float32)
    x = (rng.standard_normal((2, 3, T)) * 1500).astype(np.float32)
    with jax.default_device(jax.local_devices(backend="cpu")[0]):
        want = np.asarray(j_fb.analysis_snapshots_half(
            jnp.asarray(x), jnp.asarray(h), j_fb.FilterbankParams(M=M, m=m, r=r,
                                                                   delay_compensation_type=dct)))
    got = t_fb.analysis_snapshots_half(torch.from_numpy(x), torch.from_numpy(h),
                                       t_fb.FilterbankParams(M=M, m=m, r=r,
                                                             delay_compensation_type=dct))
    _close(got, want, 2e-5)
