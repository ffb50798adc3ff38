"""The port's CUDA kernels against their plain torch versions, on the card.

Every test here needs an NVIDIA GPU with nvcc and skips without a CUDA
device.  On a GPU machine, from the repository root:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py -q

(``--noconftest`` because the suite's conftest imports jax, which neither
the port nor these tests need.)  The references are the plain versions run
on CPU tensors, in IEEE float32, from the same numpy inputs.  Budgets are
those of ``chip_smoke.py``: 2e-5 x max|ref| for the filterbank kernels,
2e-4 for the scan, 3e-4 for the whole chain; for the config-4 kernels 1e-4
for the echo canceller, 2e-4 for the WPE stats, 1e-5 for the WPE residual,
1e-4 for the Gauss-Jordan solve and 3e-4 for the chain.  The shapes reach
past the flagship's and config 4's: partial last blocks, other delay modes,
decimations and channel counts, every constraint option, gates that close,
far-end bins that are zero, other WPE delays, tap counts and band limits,
batches that fill no block and M=128.
"""

import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (
    GSCRLSConfig,
    gsc_postfilter_fused,
    gsc_weights,
)
from distant_speech_recognition_tpu_torch.models.beamforming import array_manifold
from distant_speech_recognition_tpu_torch.models.fused_scan import (
    analysis_gsc_synthesis,
    gsc_rls_zelinski,
)
from distant_speech_recognition_tpu_torch.models.dereverberation import (
    wpe_multichannel_packed_tm,
)
from distant_speech_recognition_tpu_torch.models.pipeline import PipelineConfig, build_pipeline
from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_scan
from distant_speech_recognition_tpu_torch.ops.filterbank import (
    FilterbankParams,
    analysis_half_real_tm,
    synthesis_half_real_tm,
)
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
    analysis_tm_fused,
    synthesis_tm_fused,
)
from distant_speech_recognition_tpu_torch.ops.wpe_kernels import gj_solve, wpe_resid, wpe_stats
from distant_speech_recognition_tpu_torch.utils import geometry

pytestmark = pytest.mark.cuda

FS = 16000.0


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA) and nvcc")
    return torch.device("cuda", 0)


def _close(got: torch.Tensor, ref: torch.Tensor, budget: float) -> None:
    got = got.cpu()
    if got.is_complex():
        got, ref = torch.view_as_real(got), torch.view_as_real(ref)
    assert got.shape == ref.shape
    assert torch.isfinite(got).all()
    err = (got - ref).abs().max().item()
    assert err <= budget * ref.abs().max().item(), (err, ref.abs().max().item())


def _close_per_system(got: torch.Tensor, ref: torch.Tensor, budget: float, lead: int) -> None:
    """`_close`, and every system (an index of the first ``lead`` dims: one
    (utterance, channel, bin) of the WPE statistics, one solve) within
    ``budget`` x its own max|ref|, so no system hides under the largest."""
    _close(got, ref, budget)
    got, ref = torch.view_as_real(got.cpu()), torch.view_as_real(ref)
    d = (got - ref).abs().flatten(lead).amax(-1)
    m = ref.abs().flatten(lead).amax(-1)
    assert (d <= budget * m).all(), (d / m).max().item()


def _delays(C, azimuth=np.pi / 3):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)


@pytest.mark.parametrize(
    "M,m,r,dct,T",
    [
        (256, 4, 1, 2, 5000),  # flagship widths, partial last block
        (256, 4, 1, 0, 4096),
        (256, 4, 1, 1, 777),
        (256, 2, 2, 2, 3001),
        (512, 4, 1, 2, 6000),
        (128, 3, 0, 2, 1000),
    ],
)
def test_analysis_kernel_matches_plain(dev, M, m, r, dct, T):
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dct)
    rng = np.random.default_rng(T)
    x = torch.from_numpy((rng.standard_normal((2, 3, T)) * 1500).astype(np.float32))
    h = rng.standard_normal(p.N).astype(np.float32) / np.sqrt(p.N)
    ref = analysis_half_real_tm(x, h, p, packed=True)
    before = analysis_tm_fused.launches
    got = analysis_tm_fused(x.to(dev), torch.from_numpy(h).to(dev), p)
    assert analysis_tm_fused.launches == before + 1
    _close(got, ref, 2e-5)


@pytest.mark.parametrize(
    "m,r,dct,T_in,lead",
    [
        (4, 1, 2, 300, (3,)),  # flagship widths
        (4, 1, 0, 131, (2,)),
        (2, 2, 1, 100, (2, 2)),
        (4, 0, 2, 70, (1,)),
        (3, 2, 2, 257, (2,)),
        (4, 3, 2, 90, (1,)),
    ],
)
def test_synthesis_kernel_matches_plain(dev, m, r, dct, T_in, lead):
    p = FilterbankParams(M=256, m=m, r=r, delay_compensation_type=dct)
    rng = np.random.default_rng(T_in)
    Yp = torch.from_numpy((rng.standard_normal((T_in,) + lead + (256,)) * 100).astype(np.float32))
    g = rng.standard_normal(p.N).astype(np.float32) / np.sqrt(p.N)
    ref = synthesis_half_real_tm(Yp, g, p)
    before = synthesis_tm_fused.launches
    got = synthesis_tm_fused(Yp.to(dev), torch.from_numpy(g).to(dev), p)
    assert synthesis_tm_fused.launches == before + 1
    _close(got, ref, 2e-5)


def _scan_case(C, M, seed, Tf=40, B=3):
    """Packed spectrum with a silent stretch in utterance 1 (the gate
    closes there) and near-silent top bins in utterance 2 (the norm cap's
    max/||wa||^2 overflows to inf there)."""
    rng = np.random.default_rng(seed)
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    Yp[10:16, 1] *= np.float32(1e-6)
    lo, hi = 3 * M // 8, M // 2
    Yp[:, 2, :, lo:hi + 1] *= np.float32(1.8e-8)
    Yp[:, 2, :, lo + M // 2:] *= np.float32(1.8e-8)
    wqH, BmH = gsc_weights(M, FS, _delays(C), 1)
    vs = array_manifold(M, FS, _delays(C))
    return torch.from_numpy(Yp), wqH, BmH, vs


def _scan_vs_plain(dev, Yp, wqH, BmH, vs, cfg, pf_type, pf_min_frames):
    ref = gsc_postfilter_fused(Yp, None, wqH, BmH, vs, "rls", cfg, 0.6, pf_type, pf_min_frames, True)
    before = gsc_rls_zelinski.launches
    got = gsc_rls_zelinski(Yp.to(dev), wqH.to(dev), BmH.to(dev), vs.to(dev), cfg, 0.6, pf_type,
                           pf_min_frames)
    assert gsc_rls_zelinski.launches == before + 1
    _close(got, ref, 2e-4)


@pytest.mark.parametrize("C", [2, 3, 4, 5, 6, 7, 8])
def test_scan_kernel_matches_plain_channel_counts(dev, C):
    Yp, wqH, BmH, vs = _scan_case(C, 256, seed=C)
    _scan_vs_plain(dev, Yp, wqH, BmH, vs, GSCRLSConfig(min_frames=8), 1, 2)


@pytest.mark.parametrize(
    "cfg_kw,pf_type,pf_min_frames,M",
    [
        (dict(constraint_option=0), 1, 2, 256),
        (dict(constraint_option=1), 1, 2, 256),
        (dict(constraint_option=2), 1, 2, 256),
        (dict(regularization_param=0.0), 2, 0, 256),
        (dict(min_frames=0, alpha2=0.5, max_wa_l2norm=1.0), 2, 5, 256),
        (dict(), 1, 2, 64),  # F=33: a block with idle lanes
    ],
)
def test_scan_kernel_matches_plain_options(dev, cfg_kw, pf_type, pf_min_frames, M):
    Yp, wqH, BmH, vs = _scan_case(4, M, seed=M)
    cfg = GSCRLSConfig(**{"min_frames": 8, **cfg_kw})
    _scan_vs_plain(dev, Yp, wqH, BmH, vs, cfg, pf_type, pf_min_frames)


def test_chain_and_pipeline_match_plain(dev):
    """K1 -> K2 -> K3 on the card against the same chain on the CPU, both
    through `analysis_gsc_synthesis` and through the built `Enhancer`."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2, rls=GSCRLSConfig(min_frames=4))
    rng = np.random.default_rng(7)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    delays = _delays(4)
    mpos = np.c_[np.arange(4) * 50.0, np.zeros((4, 2))]
    x = torch.from_numpy((rng.standard_normal((2, 4, 5000)) * 1500).astype(np.float32))
    cpu = build_pipeline(cfg, mpos, delays, h, g, device="cpu")
    gpu = build_pipeline(cfg, mpos, delays, h, g, device=dev)
    with torch.no_grad():
        ref = cpu(x)
        kernels.reset_launch_counts()
        got = gpu(x.to(dev))
        assert kernels.launch_counts() == {"analysis_tm": 1, "gsc_rls_zelinski": 1,
                                           "synthesis_tm": 1, "aec_scan": 0, "wpe_stats": 0,
                                           "wpe_resid": 0, "gj_solve": 0}
        _close(got, ref, 3e-4)
        args = (gpu.wqH, gpu.BmH, gpu.wq_manifold, cfg.rls, cfg.pf_alpha, cfg.pf_type,
                cfg.pf_min_frames)
        _close(analysis_gsc_synthesis(x.to(dev), gpu.h, gpu.g, fb, *args), ref, 3e-4)


def _packed(rng, Tf, B, C, M, scale=100.0):
    return torch.from_numpy((rng.standard_normal((Tf, B, C, M)) * scale).astype(np.float32))


@pytest.mark.parametrize(
    "kind,p1,p2,C,M,B",
    [
        ("nlms", 100.0, 1e-4, 4, 256, 3),
        ("kalman", 0.95, 1e-3, 4, 256, 3),
        ("nlms", 100.0, 1e-4, 2, 128, 5),
        ("kalman", 0.95, 1e-3, 3, 128, 1),
    ],
)
def test_aec_kernel_matches_plain(dev, kind, p1, p2, C, M, B):
    """A far end with bins that are zero (the guarded quotient) and a stretch
    where |V|^2 < threshold (the gate closes)."""
    rng = np.random.default_rng(C * M + B)
    F = M // 2 + 1
    A = _packed(rng, 60, B, C, M)
    V = _packed(rng, 60, B, 1, M)[:, :, 0]
    V[:, 0, 3:9] = 0.0
    V[:, 0, F + 2:F + 8] = 0.0
    V[20:35] *= 1e-3
    ref = aec_scan(A, V, kind, p1, p2, 100.0)
    before = aec_scan.launches
    got = aec_scan(A.to(dev), V.to(dev), kind, p1, p2, 100.0)
    assert aec_scan.launches == before + 1
    _close(got, ref, 1e-4)


def _wpe_case(seed, Tf, B, C, M, P):
    rng = np.random.default_rng(seed)
    F = M // 2 + 1
    Yp = _packed(rng, Tf, B, C, M, scale=30.0)
    G = 0.1 * (rng.standard_normal((B, C, F, C * P)) + 1j * rng.standard_normal((B, C, F, C * P)))
    return Yp, torch.from_numpy(G.astype(np.complex64))


@pytest.mark.parametrize(
    "C,P,lowerN,M,B,has_g",
    [
        (4, 5, 2, 256, 3, False),  # config-4 widths, first EM iteration
        (4, 5, 2, 256, 3, True),
        (2, 3, 1, 128, 5, True),
        (3, 4, 3, 256, 2, True),
        (2, 5, 2, 128, 1, False),
        (3, 7, 1, 128, 2, True),  # C*P = 21, the JAX kernel's largest
    ],
)
def test_wpe_stats_kernel_matches_plain(dev, C, P, lowerN, M, B, has_g):
    Yp, G = _wpe_case(C * P + lowerN, 90, B, C, M, P)
    R_ref, r_ref = wpe_stats(Yp, G, lowerN, P, has_g)
    before = wpe_stats.launches
    R, r = wpe_stats(Yp.to(dev), G.to(dev), lowerN, P, has_g)
    assert wpe_stats.launches == before + 1
    _close_per_system(R, R_ref, 2e-4, 3)
    _close_per_system(r, r_ref, 2e-4, 3)


@pytest.mark.parametrize(
    "C,P,lowerN,M,B",
    [(4, 5, 2, 256, 3), (2, 3, 1, 128, 5), (3, 4, 3, 256, 2), (8, 3, 2, 128, 1)],
)
def test_wpe_resid_kernel_matches_plain(dev, C, P, lowerN, M, B):
    Yp, G = _wpe_case(C * P + lowerN, 70, B, C, M, P)
    ref = wpe_resid(Yp, G, lowerN)
    before = wpe_resid.launches
    got = wpe_resid(Yp.to(dev), G.to(dev), lowerN)
    assert wpe_resid.launches == before + 1
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("n,N", [(20, 1000), (6, 37), (21, 5), (31, 3)])
def test_gj_solve_kernel_matches_plain(dev, n, N):
    """Diagonally loaded Hermitian positive-definite systems, as WPE builds them."""
    rng = np.random.default_rng(n * N)
    L = rng.standard_normal((N, n, 3 * n)) + 1j * rng.standard_normal((N, n, 3 * n))
    R = np.einsum("npt,nqt->npq", L, L.conj())
    R += (np.abs(np.diagonal(R, axis1=1, axis2=2)).max(-1) * 0.01)[:, None, None] * np.eye(n)
    R = torch.from_numpy(R.astype(np.complex64))
    r = torch.from_numpy((rng.standard_normal((N, n)) + 1j * rng.standard_normal((N, n))).astype(
        np.complex64))
    ref = gj_solve(R, r)
    before = gj_solve.launches
    got = gj_solve(R.to(dev), r.to(dev))
    assert gj_solve.launches == before + 1
    _close_per_system(got, ref, 1e-4, 1)


@pytest.mark.parametrize("band_width", [0.0, 3000.0])
def test_packed_wpe_matches_plain(dev, band_width):
    """Two EM iterations (stats, loading, solve) then the residual, with the
    tap truncation and the band limit, on the card against the CPU."""
    Yp, _ = _wpe_case(11, 120, 3, 4, 256, 5)
    Yp[..., :] *= torch.linspace(0.2, 1.0, 120)[:, None, None, None]
    ref = wpe_multichannel_packed_tm(Yp, 2, 6, 2, band_width=band_width)
    kernels.reset_launch_counts()
    got = wpe_multichannel_packed_tm(Yp.to(dev), 2, 6, 2, band_width=band_width)
    counts = kernels.launch_counts()
    assert (counts["wpe_stats"], counts["gj_solve"], counts["wpe_resid"]) == (2, 2, 1)
    _close(got, ref, 3e-4)


@pytest.mark.parametrize("aec", ["nlms", "kalman"])
def test_config4_pipeline_matches_plain(dev, aec):
    """The config-4 `Enhancer` (AEC -> WPE -> GSC-RLS + Zelinski) on the card
    against the same module on the CPU, with every kernel's launch count."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2, rls=GSCRLSConfig(min_frames=4), aec=aec, wpe=True)
    rng = np.random.default_rng(9)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    mpos = np.c_[np.arange(4) * 50.0, np.zeros((4, 2))]
    x = torch.from_numpy((rng.standard_normal((3, 4, 9000)) * 1500).astype(np.float32))
    play = torch.from_numpy((rng.standard_normal((3, 9000)) * 1500).astype(np.float32))
    cpu = build_pipeline(cfg, mpos, _delays(4), h, g, device="cpu")
    gpu = build_pipeline(cfg, mpos, _delays(4), h, g)
    with torch.no_grad():
        ref = cpu(x, play)
        kernels.reset_launch_counts()
        got = gpu(x.to(dev), play.to(dev))
    assert kernels.launch_counts() == {"analysis_tm": 2, "gsc_rls_zelinski": 1,
                                       "synthesis_tm": 1, "aec_scan": 1, "wpe_stats": 2,
                                       "wpe_resid": 1, "gj_solve": 2}
    _close(got, ref, 3e-4)


def test_wrappers_raise_on_bad_cuda_input(dev):
    """A CUDA call either launches its kernel or raises; it never falls back."""
    p = FilterbankParams()
    x = torch.zeros((1, 2, 4096), device=dev)
    h = torch.zeros(p.N, device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="float32"):
        analysis_tm_fused(x.double(), h, p)
    with pytest.raises(ValueError, match="CUDA"):
        analysis_tm_fused(x, h, p, A=torch.zeros((256, 256)))
    with pytest.raises(ValueError, match="float32"):
        synthesis_tm_fused(torch.zeros((10, 1, 256), device=dev, dtype=torch.float64), h, p)
    Yp, wqH, BmH, vs = _scan_case(4, 256, seed=0, Tf=4)
    with pytest.raises(ValueError, match="complex64"):
        gsc_rls_zelinski(Yp.to(dev), wqH.to(dev, torch.complex128), BmH.to(dev), vs.to(dev),
                         GSCRLSConfig())
    with pytest.raises(ValueError, match="CUDA"):
        gsc_rls_zelinski(Yp.to(dev), wqH, BmH.to(dev), vs.to(dev), GSCRLSConfig())
    A = torch.zeros((8, 2, 4, 256), device=dev)
    with pytest.raises(ValueError, match="float32"):
        aec_scan(A, torch.zeros((8, 2, 256), device=dev, dtype=torch.float64))
    with pytest.raises(ValueError, match="CUDA"):
        aec_scan(A, torch.zeros((8, 2, 256)))
    G = torch.zeros((2, 4, 129, 20), dtype=torch.complex64, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        wpe_stats(A, G.cpu(), 2, 5)
    with pytest.raises(RuntimeError, match="shape outside"):
        wpe_stats(A, torch.zeros((2, 4, 129, 28), dtype=torch.complex64, device=dev), 2, 7)
    with pytest.raises(ValueError, match="complex64"):
        wpe_resid(A, G.to(torch.complex128), 2)
    R = torch.zeros((5, 32, 32), dtype=torch.complex64, device=dev)
    with pytest.raises(RuntimeError, match="shape outside"):
        gj_solve(R, torch.zeros((5, 32), dtype=torch.complex64, device=dev))
    assert set(kernels.launch_counts().values()) == {0}
