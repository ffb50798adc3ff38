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
1e-4 for the Gauss-Jordan solve and 3e-4 for the chain; 3e-5 for the
fixed-weight Zelinski kernel (K7), 2e-4 for the one-kernel fixed-weight
chain (K8) against the chain of split kernels K1 -> K7 -> K3 and 3e-4
against the plain chain, 2e-4 for the steered scan (K6), which given one
steering for every utterance equals K2 bit for bit; for the one-kernel
flagship chains 3e-4 (K4) against K1 -> K2 -> K3 (K3 pairs its synthesis
rows in its FFT otherwise than K4) and 2e-4 (K5) against K1 -> K2, which
it equals bit for bit (the same FIR rows, FFT pairs and split), and both
against the plain chain; 2e-5
for the strided FIR (K13), which rounds like its plain version.  K2 and K6
are also held bit for bit to outputs their kernels gave on an H100 before
their per-frame step moved into ``csrc/gsc_step.h``
(``tests/data/gsc_scan_case.npz``), K9 and K12 to outputs of their first
designs (``tests/data/aec_gj_case.npz``), and K11 and K12 past 24 taps a
target to outputs of their first designs for those shapes
(``tests/data/wpe_wide_case.npz``).  The shapes reach
past the flagship's and config 4's: partial last blocks, other delay modes,
decimations and channel counts, every constraint option, gates that close,
far-end bins that are zero, other WPE delays, tap counts and band limits,
batches that fill no block and M=128; for K6-K8 C = 2..8, both Zelinski
modes, pf_min_frames 0 and 2, digitally silent utterances and frame counts
that are no multiple of the kernels' frame groups and tiles.  K1 (at M =
256), K3, K4/K5 and K8, whose DFTs are FFTs (``csrc/dsr_fft.h``), also take
pure tones at bins 0, 1, 64, 127 and 128 and impulse trains, one case per
bin; K1 also takes tiles of 1 to 8 signals.  At M = 64, 128, 512, 1024
and 2048 (the FFT plans of 8 x 8, 8 x 16 and 2, 4, 8 x 16 x 16 cells) K1
and K3 are held to their plain versions on noise, pure tones at bins 0, 1,
M/4, M/2 - 1 and M/2 and impulse trains (2e-5), K3 at the largest halo its
tile takes; K2, K6, the LMS scan and its gate pass at M = 512, 1024 and
2048 (F = 257, 513, 1025; K2/K6's energies from their pre-pass above 257)
to their plain loops (2e-4); K7, K9 (two blocks a channel at 2048), K10,
K11 (narrow, and (8, 5) and (8, 3) in the wide kernel; only the wide one
above 512), K12 at the systems of 1025 bins and the postfilter kernel at M
= 64, 512, 1024 and 2048; and the card pipelines at those sizes (BASELINE
config 1 at M = 64, the flagship at 128, 512 and 2048, configs 3-5, D&S +
Zelinski and McCowan) to the same modules on the CPU with exactly their
routes' launches.  K1, K3,
K4/K5 and K8 at M = 256 give, bit for bit, the outputs stored from their
kernels before the FFT plan took other sizes
(``tests/data/filterbank_case_m256.npz``, ``tests/probe_filterbank_bits.py
--root``).  The LMS scan (two lanes a bin, no TPU
counterpart) is held to its plain loop at 2e-4, K2's budget, at C = 2..8, M
= 256, 40 and 32, B = 1, 3, 5, 33, 64 and 256 (blocks and lane pairs across
utterance boundaries), frame counts around its ring of staged frames and
across the gate pass's tiles, both Zelinski modes
and the gain applied at the last frame only, across step-size halvings,
with silent opening frames and a norm cap that fires; bit for bit to outputs
it gave on an H100 (``tests/data/gsc_lms_case.npz``); its launch plan to the
registers, spills and residency it reports; its silence gates (a kernel of
their own, launched first) to their plain version, exactly, across the gate
pass's tiles of frames; the scans without the gain (``postfilter="none"``)
to the plain `gsc_lms` / `gsc_rls`; and the `Enhancer` with ``gsc_lms`` (alone, at C
= 8, and after the echo canceller and WPE) and with ``postfilter="none"`` to
the same module on the CPU.  `FastDivOps`, the division the LMS scan, K9 and
K12 rest on, is held to the card's IEEE division over edge operands.
BASELINE config 4 at 8 channels widens the WPE kernels to C*P = 40: K10 at
seven to ten tiles a side (C*P = 28 to 40, C = 1..8, deep delays), K11 past
24 taps a target (one target a thread, target groups at C >= 5 on M = 256,
two rings) and K12 at n = 32..40 (rows 32..39 split across four lanes; more
systems than warps, zero pivots), and the config-4 `Enhancer` with the LMS
GSC runs at C = 8; the one-tap block Kalman canceller (the Kalman kernel
from another initial state) is held to its plain loop, which carries its
state variance complex, alone and in the config-4 chain.  The McCowan,
Lefkimmiatis and APAB postfilter kernel (no TPU counterpart) is held to its
plain version at 1e-4 (its pair sums divide by 1 - Rc, up to 100) at C = 2,
4 and 8, both modes, given the beamformer's output or forming wqH X itself,
with a silent utterance that gives NaN where the plain version does.
K7 and the LMS scan with one steering per utterance (the steered D&S and
GSC-LMS) are held to their plain versions with eight steerings at B = 8
(3e-5 and 2e-4), both Zelinski modes, pf_min_frames 0, 2 and
``NO_POSTFILTER``, C = 2, 4 and 8, and, given one steering broadcast to
every utterance, to the shared-weight kernels bit for bit; the steered
pipeline on the card runs every route (``ds``, ``gsc_lms``, ``gsc_rls`` with
and without Zelinski, the DSBLA protocol, a bin range) with exactly its
kernels and equals the same module on the CPU.
"""

import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu_torch import kernels
from pathlib import Path

from distant_speech_recognition_tpu_torch.models import fixed_weight, fused_scan
from distant_speech_recognition_tpu_torch.models.adaptive_gsc import (
    GSCLMSConfig,
    GSCRLSConfig,
    gsc_lms,
    gsc_postfilter_fused,
    gsc_rls,
    gsc_weights,
    lms_silence_gates,
)
from distant_speech_recognition_tpu_torch.models.beamforming import (
    apply_weights,
    array_manifold,
    frame_energy_half,
    superdirective_weights,
)
from distant_speech_recognition_tpu_torch.models.fixed_weight import (
    analysis_fw_synthesis,
    zelinski_apply,
    zelinski_apply_steered,
)
from distant_speech_recognition_tpu_torch.models.fused_scan import (
    NO_POSTFILTER,
    analysis_gsc_rls_zelinski,
    analysis_gsc_synthesis,
    gsc_lms_zelinski,
    gsc_lms_zelinski_steered,
    gsc_rls_zelinski,
    gsc_rls_zelinski_steered,
    lms_gates,
)
from distant_speech_recognition_tpu_torch.models.dereverberation import (
    wpe_multichannel_packed_tm,
)
from distant_speech_recognition_tpu_torch.models.pipeline import PipelineConfig, build_pipeline
from distant_speech_recognition_tpu_torch.models.steered import (
    build_steered_pipeline,
    steering_weights,
)
from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_scan
from distant_speech_recognition_tpu_torch.ops.filterbank import (
    FilterbankParams,
    analysis,
    analysis_half_real_tm,
    num_analysis_frames,
    pack_half,
    polyphase_fir_plain,
    synthesis,
    synthesis_half_real_tm,
    unpack_half,
)
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
    analysis_polyphase,
    analysis_tm_fused,
    polyphase_fir,
    synthesis_polyphase,
    synthesis_tm_fused,
)
from distant_speech_recognition_tpu_torch.ops.wpe_kernels import gj_solve, wpe_resid, wpe_stats
from distant_speech_recognition_tpu_torch.ops.dft import (
    analysis_matrix_packed as analysis_matrix_packed_np,
)
from distant_speech_recognition_tpu_torch.utils import geometry
from distant_speech_recognition_tpu_torch.utils.prototypes import load_pair

pytestmark = pytest.mark.cuda

FS = 16000.0
# the designed prototypes above M = 512 (tests/data/prototypes)
PROTO_DIR = str(Path(__file__).parent / "data" / "prototypes")


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


def _only(**launches):
    """Every kernel's launch count: the given ones, 0 for the others."""
    return dict.fromkeys(kernels.launch_counts(), 0) | launches


def _delays(C, azimuth=np.pi / 3):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)


@pytest.mark.parametrize(
    "M,m,r,dct,T,lead",
    [
        (256, 4, 1, 2, 5000, (2, 3)),  # flagship widths, partial last tile
        (256, 4, 1, 0, 4096, (2, 3)),
        (256, 4, 1, 1, 777, (2, 3)),
        (256, 2, 2, 2, 3001, (2, 3)),
        (512, 4, 1, 2, 6000, (2, 3)),  # other M: the FFT plans of 512 and 128
        (128, 3, 0, 2, 1000, (2, 3)),
        (256, 4, 1, 2, 5000, (2, 8)),  # tiles of 8 frames x 8 channels
        (256, 4, 1, 2, 3000, (3, 1)),  # one signal per tile (the far end)
        (256, 4, 3, 2, 4000, (5,)),
        (256, 4, 1, 2, 2000, (2, 12)),  # more signals than a tile groups
        # M = 64, 128 and 512: tiles of 256 / 128 / 32 rows, 1 to 8 signals
        # a tile, the FIR of m = 4, R = 2 and the general one, partial tiles
        (64, 4, 1, 2, 5000, (2, 2)),  # BASELINE config 1
        (64, 4, 1, 2, 3001, (3, 1)),
        (64, 2, 3, 0, 4000, (2, 8)),
        (64, 4, 1, 1, 777, (1, 5)),
        (128, 4, 1, 2, 5000, (2, 4)),
        (128, 4, 2, 2, 3000, (2, 7)),
        (512, 4, 1, 2, 7000, (2, 8)),
        (512, 4, 1, 0, 5000, (2, 1)),
        (512, 3, 2, 1, 6000, (1, 3)),
        (512, 4, 1, 2, 3000, (2, 12)),
        # M = 1024 and 2048: tiles of 16 and 8 rows (eight channels fill one
        # frame's tile at 2048), 2, 4 and 8 signals, one and nine utterances
        (1024, 4, 1, 2, 9000, (2, 8)),
        (1024, 4, 3, 2, 6001, (9, 2)),
        (1024, 4, 1, 0, 7000, (1, 4)),
        (2048, 4, 1, 2, 15000, (2, 8)),
        (2048, 4, 2, 1, 11001, (9, 4)),
        (2048, 4, 1, 2, 9000, (1, 2)),
    ],
)
def test_analysis_kernel_matches_plain(dev, M, m, r, dct, T, lead):
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dct)
    rng = np.random.default_rng(T)
    x = torch.from_numpy((rng.standard_normal(lead + (T,)) * 1500).astype(np.float32))
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


TONE_CASES = ["bin0", "bin1", "bin64", "bin127", "bin128", "impulses"]


def _tone_spectrum(case, T_in, B):
    """Packed frames [T_in, B, 256] holding one bin whose phase turns from
    frame to frame (utterance b at amplitude 100 / (b + 1)), or the packed
    spectra of single impulses at a position that moves by 37 per frame."""
    t = np.arange(T_in)[:, None, None]
    amp = 100.0 / (1.0 + np.arange(B))[None, :, None]
    if case == "impulses":
        A = np.asarray(analysis_matrix_packed_np(256), np.float64)
        Yp = A[(37 * np.arange(T_in) + 5) % 256][:, None, :] * amp
        return torch.from_numpy(Yp.astype(np.float32))
    Yp = np.zeros((T_in, B, 256), np.float64)
    f = int(case[3:])
    phase = 0.7 * t + 0.3
    Yp[..., f:f + 1] = amp * np.cos(phase)
    if 0 < f < 128:
        Yp[..., 128 + f:129 + f] = amp * np.sin(phase)
    return torch.from_numpy(Yp.astype(np.float32))


@pytest.mark.parametrize("case", TONE_CASES)
def test_synthesis_kernel_tones_and_impulses(dev, case):
    """One bin at a time (and impulses), so a wrong twiddle, packing or
    segment-reversal index of K3's FFT fails on a named bin."""
    p = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    g = np.random.default_rng(3).standard_normal(p.N).astype(np.float32) / 32
    Yp = _tone_spectrum(case, 150, 2)
    ref = synthesis_half_real_tm(Yp, g, p)
    _close(synthesis_tm_fused(Yp.to(dev), torch.from_numpy(g).to(dev), p), ref, 2e-5)


def _tone_signal(case, C, T, B=2):
    """Samples [B, C, T]: a cosine at the centre of one bin (channel c a
    little later than c - 1), or one impulse per 256-sample block at a
    position that moves by 37 per block."""
    n = np.arange(T)
    x = np.zeros((B, C, T), np.float64)
    for c in range(C):
        if case == "impulses":
            blocks = np.arange(0, T, 256)
            pos = blocks + (37 * (blocks // 256) + 11 * c) % 256
            x[:, c, pos[pos < T]] = 1500.0
        else:
            x[:, c] = 1500.0 * np.cos(2 * np.pi * int(case[3:]) * (n - 2 * c) / 256 + 0.4)
    x[1] *= 0.25
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("case", TONE_CASES)
def test_analysis_kernel_tones_and_impulses(dev, case):
    """K1's FFT route on one bin at a time (and impulse trains): a wrong
    twiddle, split or packing index fails on a named bin."""
    p = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, _ = load_pair(256, 4, 1)
    x = _tone_signal(case, 4, 5000)
    ref = analysis_half_real_tm(x, h, p, packed=True)
    _close(analysis_tm_fused(x.to(dev), torch.as_tensor(h).to(dev), p), ref, 2e-5)


def _scan_case(C, M, seed, Tf=40, B=3):
    """Packed spectrum with a silent stretch in utterance 1 (the gate
    closes there) and near-silent top bins in utterance 2 (the norm cap's
    max/||wa||^2 overflows to inf there)."""
    rng = np.random.default_rng(seed)
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    Yp[10:16, 1:2] *= np.float32(1e-6)
    lo, hi = 3 * M // 8, M // 2
    Yp[:, 2:3, :, lo:hi + 1] *= np.float32(1.8e-8)
    Yp[:, 2:3, :, lo + M // 2:] *= np.float32(1.8e-8)
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


@pytest.mark.parametrize("C,B", [(2, 3), (3, 3), (4, 3), (5, 3), (6, 3), (7, 3), (8, 3),
                                 (2, 1), (8, 1)])
def test_scan_kernel_matches_plain_channel_counts(dev, C, B):
    Yp, wqH, BmH, vs = _scan_case(C, 256, seed=C, B=B)
    _scan_vs_plain(dev, Yp, wqH, BmH, vs, GSCRLSConfig(min_frames=8), 1, 2)


@pytest.mark.parametrize("C", [2, 4, 8])
def test_scan_kernels_around_a_chunk_of_frames(dev, C):
    """K2 against its plain version, and K6 under one steering for all equal
    to K2, at 1 frame, one frame fewer than a chunk of the kernel's frame
    ring, and one and two chunks and a frame."""
    tc = fused_scan.scan_launch_shape(2, C, 256)["frames"]
    _, wqH, BmH, vs = _scan_case(C, 256, seed=30 + C, Tf=1, B=2)
    cfg = GSCRLSConfig(min_frames=2)
    for Tf in sorted({1, max(tc - 1, 1), tc + 1, 2 * tc + 1}):
        Yp = _scan_case(C, 256, seed=30 + C + Tf, Tf=Tf, B=2)[0]
        _scan_vs_plain(dev, Yp, wqH, BmH, vs, cfg, 1, 0)
        Yd = Yp.to(dev)
        shared = [w.to(dev) for w in (wqH, BmH, vs)]
        rows = [w.expand((2,) + w.shape) for w in shared]
        assert torch.equal(gsc_rls_zelinski_steered(Yd, *rows, cfg, 0.6, 1, 0),
                           gsc_rls_zelinski(Yd, *shared, cfg, 0.6, 1, 0))


@pytest.mark.parametrize(
    "cfg_kw,pf_type,pf_min_frames,M",
    [
        (dict(constraint_option=0), 1, 2, 256),
        (dict(constraint_option=1), 1, 2, 256),
        (dict(constraint_option=2), 1, 2, 256),
        (dict(regularization_param=0.0), 2, 0, 256),
        (dict(min_frames=0, alpha2=0.5, max_wa_l2norm=1.0), 2, 5, 256),
        (dict(), 1, 2, 64),  # F=33: a block with idle lanes
        (dict(), 1, 2, 512),  # F=257: nine groups of 32 bins, the last with one
        (dict(constraint_option=0), 2, 0, 512),
        # F = 513 and 1025: the energies from the pre-pass
        (dict(), 1, 2, 1024),
        (dict(constraint_option=0), 2, 0, 2048),
    ],
)
def test_scan_kernel_matches_plain_options(dev, cfg_kw, pf_type, pf_min_frames, M):
    Yp, wqH, BmH, vs = _scan_case(4, M, seed=M)
    cfg = GSCRLSConfig(**{"min_frames": 8, **cfg_kw})
    _scan_vs_plain(dev, Yp, wqH, BmH, vs, cfg, pf_type, pf_min_frames)


def test_chain_and_pipeline_match_plain(dev):
    """The flagship `Enhancer` on the card (one launch of K4, nothing else)
    and `analysis_gsc_synthesis` against the same chain on the CPU."""
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
        assert kernels.launch_counts() == _only(gsc_mono=1)
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
        # one channel an utterance, and eight (at these few utterances the
        # plan takes one channel a block: test_aec_kernel_channel_groups
        # holds the blocks of several channels)
        ("nlms", 100.0, 1e-4, 1, 256, 2),
        ("kalman", 0.95, 1e-3, 1, 128, 2),
        ("nlms", 100.0, 1e-4, 8, 256, 2),
        ("kalman", 0.95, 1e-3, 8, 128, 1),
        ("nlms", 100.0, 1e-4, 4, 128, 1),
        # the one-tap block Kalman: the Kalman kernel started from K = sigmak2,
        # against the plain loop that carries K complex
        ("block_kalman", 0.95, 1e-3, 4, 256, 3),
        ("block_kalman", 0.95, 1e-3, 8, 256, 2),
        ("block_kalman", 0.95, 1e-3, 3, 128, 1),
        # M = 64 and 512
        ("nlms", 100.0, 1e-4, 2, 64, 3),
        ("nlms", 100.0, 1e-4, 4, 512, 2),
        ("kalman", 0.95, 1e-3, 8, 512, 1),
        ("block_kalman", 0.95, 1e-3, 4, 512, 2),
        # M = 1024 (one block a channel) and 2048 (two blocks a channel)
        ("nlms", 100.0, 1e-4, 4, 1024, 9),
        ("kalman", 0.95, 1e-3, 2, 1024, 1),
        ("nlms", 100.0, 1e-4, 8, 2048, 1),
        ("kalman", 0.95, 1e-3, 4, 2048, 9),
        ("block_kalman", 0.95, 1e-3, 2, 2048, 2),
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


@pytest.mark.parametrize("kind,p1,p2", [("nlms", 100.0, 1e-4), ("kalman", 0.95, 1e-3),
                                       ("block_kalman", 0.95, 1e-3)])
@pytest.mark.parametrize("B,C", [(40, 8), (132, 6)])
def test_aec_kernel_channel_groups(dev, kind, p1, p2, B, C):
    """Enough utterances that the plan gives a block several channels and an
    utterance several blocks (channels c0 > 0 in a block, the far-end row
    staged once for the block's channels); 45 frames, no multiple of a step
    or of the ring, zero far-end bins and a stretch where the gate closes."""
    from distant_speech_recognition_tpu_torch.ops.aec_kernels import aec_launch_shape

    M = 256
    sh = aec_launch_shape(B, C, M, kind)
    assert 1 < sh["cg"] < C and sh["blocks"] == B * (C // sh["cg"]), sh
    rng = np.random.default_rng(B * 10 + C)
    F = M // 2 + 1
    A = _packed(rng, 45, B, C, M)
    V = _packed(rng, 45, B, 1, M)[:, :, 0]
    V[:, :, 3:9] = 0.0
    V[:, :, F + 2:F + 8] = 0.0
    V[20:35] *= 1e-3
    ref = aec_scan(A, V, kind, p1, p2, 100.0)
    before = aec_scan.launches
    got = aec_scan(A.to(dev), V.to(dev), kind, p1, p2, 100.0)
    assert aec_scan.launches == before + 1
    _close(got, ref, 1e-4)


@pytest.mark.parametrize("kind,p1,p2", [("nlms", 100.0, 1e-4), ("kalman", 0.95, 1e-3),
                                       ("block_kalman", 0.95, 1e-3)])
@pytest.mark.parametrize("Tf,B,C,M", [(1, 2, 4, 256), (3, 1, 2, 256), (23, 3, 4, 256),
                                      (37, 2, 1, 128), (38, 1, 8, 128)])
def test_aec_kernel_frame_counts(dev, kind, p1, p2, Tf, B, C, M):
    """Frame counts below one step of the kernel's ring (4 frames) and no
    multiple of it or of the ring (16 frames); zero far-end bins everywhere
    and, past frame 2, a stretch where the gate closes."""
    rng = np.random.default_rng(Tf * 1000 + B * 100 + C)
    F = M // 2 + 1
    A = _packed(rng, Tf, B, C, M)
    V = _packed(rng, Tf, B, 1, M)[:, :, 0]
    V[:, :, 3:9] = 0.0
    V[:, :, F + 2:F + 8] = 0.0
    V[2:9] *= 1e-3
    ref = aec_scan(A, V, kind, p1, p2, 100.0)
    before = aec_scan.launches
    got = aec_scan(A.to(dev), V.to(dev), kind, p1, p2, 100.0)
    assert aec_scan.launches == before + 1
    _close(got, ref, 1e-4)


def test_aec_kernel_refuses_what_it_does_not_take(dev):
    """The kernel stages rows by 16-byte copies and takes a bin a thread:
    M a multiple of 4 up to 1024, and of 16 up to 2048 (two blocks a
    channel, each two runs of M/4 lanes).  The wrapper raises on the rest
    before any launch; the plain loops on the CPU still take them."""
    kernels.reset_launch_counts()
    for M in (6, 130, 1028, 4096):
        A = torch.zeros((3, 1, 2, M), device=dev)
        with pytest.raises(NotImplementedError, match="multiple of 4"):
            aec_scan(A, torch.zeros((3, 1, M), device=dev))
    assert set(kernels.launch_counts().values()) == {0}
    assert aec_scan(torch.ones((3, 1, 2, 6)), torch.ones((3, 1, 6))).shape == (3, 1, 2, 6)


def _wpe_case(seed, Tf, B, C, M, P):
    rng = np.random.default_rng(seed)
    F = M // 2 + 1
    Yp = _packed(rng, Tf, B, C, M, scale=30.0)
    G = 0.1 * (rng.standard_normal((B, C, F, C * P)) + 1j * rng.standard_normal((B, C, F, C * P)))
    return Yp, torch.from_numpy(G.astype(np.complex64))


def _old(*args):
    """A case of the first parameter list, under its first id."""
    return pytest.param(*args, id="-".join(str(a) for a in args[:-1]))


@pytest.mark.parametrize(
    "C,P,lowerN,M,B,has_g,Tf",
    [
        _old(4, 5, 2, 256, 3, False, 90),  # config-4 widths, first EM iteration
        _old(4, 5, 2, 256, 3, True, 90),
        _old(2, 3, 1, 128, 5, True, 90),
        _old(3, 4, 3, 256, 2, True, 90),
        _old(2, 5, 2, 128, 1, False, 90),
        _old(3, 7, 1, 128, 2, True, 90),  # C*P = 21, the JAX kernel's largest
        # the chunked ring's edges: Tf past a multiple of the 64-frame chunk,
        # shorter than the lag history, the shallowest and deepest delay, one
        # utterance, C*P = 24, and the config-4 widths over a whole 10 s
        pytest.param(4, 5, 2, 256, 2, True, 130, id="Tf130"),
        pytest.param(4, 5, 2, 256, 2, True, 6, id="Tf6-within-history"),
        pytest.param(3, 4, 2, 128, 3, False, 3, id="Tf3-within-history-first-iteration"),
        pytest.param(4, 5, 0, 256, 2, True, 90, id="lowerN0"),
        pytest.param(3, 4, 32, 128, 2, True, 100, id="lowerN32"),
        pytest.param(4, 5, 2, 256, 1, True, 90, id="B1"),
        pytest.param(8, 3, 2, 128, 2, True, 90, id="C8-P3"),
        pytest.param(8, 1, 32, 256, 2, True, 100, id="C8-P1-lowerN32-fewer-systems"),
        pytest.param(4, 5, 2, 256, 2, True, 1254, id="config4-Tf1254"),
        # past C*P = 24: seven to ten 4x4 tiles a side, one system a block at
        # C = 8 (440 threads)
        pytest.param(4, 7, 2, 256, 2, True, 90, id="CP28"),
        pytest.param(8, 4, 2, 256, 2, True, 90, id="C8-P4-CP32"),
        pytest.param(8, 5, 2, 256, 2, False, 90, id="C8-P5-CP40-first-iteration"),
        pytest.param(8, 5, 2, 256, 2, True, 130, id="C8-P5-CP40"),
        pytest.param(8, 5, 32, 128, 1, True, 100, id="C8-P5-lowerN32"),
        pytest.param(5, 8, 2, 128, 2, True, 90, id="C5-P8"),
        pytest.param(3, 13, 1, 128, 2, True, 90, id="C3-P13-CP39"),
        pytest.param(1, 40, 2, 128, 3, True, 90, id="C1-P40"),
        # M = 64 and 512 (the kernel takes any even M)
        pytest.param(4, 5, 2, 64, 2, True, 90, id="M64"),
        pytest.param(4, 5, 2, 512, 2, True, 90, id="M512"),
        pytest.param(8, 5, 2, 512, 1, False, 90, id="C8-P5-M512-first-iteration"),
        pytest.param(4, 5, 2, 1024, 2, True, 45, id="M1024"),
        pytest.param(2, 5, 2, 2048, 9, True, 37, id="C2-B9-M2048"),
        pytest.param(8, 5, 2, 2048, 1, False, 30, id="C8-P5-M2048-first-iteration"),
    ],
)
def test_wpe_stats_kernel_matches_plain(dev, C, P, lowerN, M, B, has_g, Tf):
    Yp, G = _wpe_case(C * P + lowerN, Tf, B, C, M, P)
    R_ref, r_ref = wpe_stats(Yp, G, lowerN, P, has_g)
    before = wpe_stats.launches
    R, r = wpe_stats(Yp.to(dev), G.to(dev), lowerN, P, has_g)
    assert wpe_stats.launches == before + 1
    _close_per_system(R, R_ref, 2e-4, 3)
    _close_per_system(r, r_ref, 2e-4, 3)


@pytest.mark.parametrize("has_g", [False, True])
def test_wpe_stats_kernel_repeats_to_the_bit(dev, has_g):
    """Every block walks all frames of its systems in one order, with no
    atomics: two launches on the same input give the same bits."""
    Yp, G = _wpe_case(7, 200, 3, 4, 256, 5)
    Yp, G = Yp.to(dev), G.to(dev)
    R1, r1 = wpe_stats(Yp, G, 2, 5, has_g)
    R2, r2 = wpe_stats(Yp, G, 2, 5, has_g)
    assert torch.equal(torch.view_as_real(R1), torch.view_as_real(R2))
    assert torch.equal(torch.view_as_real(r1), torch.view_as_real(r2))


@pytest.mark.parametrize(
    "C,P,lowerN,M,B,Tf",
    [
        _old(4, 5, 2, 256, 3, 70),
        _old(2, 3, 1, 128, 5, 70),
        _old(3, 4, 3, 256, 2, 70),
        _old(8, 3, 2, 128, 1, 70),
        # the frame chunks' edges, as for the stats; lowerN = 32 at 8 x 256
        # lanes keeps the current frames and the lags in two rings
        pytest.param(4, 5, 2, 256, 2, 130, id="Tf130"),
        pytest.param(4, 5, 2, 256, 2, 6, id="Tf6-within-history"),
        pytest.param(2, 3, 1, 128, 3, 2, id="Tf2-within-history"),
        pytest.param(4, 5, 0, 256, 2, 90, id="lowerN0"),
        pytest.param(3, 4, 32, 128, 2, 100, id="lowerN32"),
        pytest.param(8, 3, 32, 256, 2, 100, id="lowerN32-two-rings"),
        pytest.param(4, 5, 2, 256, 1, 90, id="B1"),
        pytest.param(8, 3, 2, 256, 2, 90, id="C8-P3"),
        pytest.param(1, 24, 2, 128, 2, 90, id="C1-P24"),
        pytest.param(5, 4, 1, 128, 2, 90, id="C5-P4"),
        pytest.param(6, 4, 3, 128, 2, 90, id="C6-P4"),
        pytest.param(7, 3, 2, 128, 2, 90, id="C7-P3"),
        pytest.param(4, 6, 2, 256, 2, 90, id="C4-P6"),
        pytest.param(4, 6, 32, 256, 2, 100, id="C4-P6-lowerN32-two-rings"),
        pytest.param(4, 5, 2, 256, 2, 1254, id="config4-Tf1254"),
        # past 24 taps a target, the wide kernel: a warp a target, blocks of
        # 32 bins (four groups at M = 256, two at 128; the DC bin in lane 0
        # of the first, the Nyquist bin after each step), 8 frames a step
        # (the ids keep the names of the earlier design's cases)
        pytest.param(8, 5, 2, 256, 2, 300, id="C8-P5"),
        pytest.param(8, 5, 2, 128, 2, 90, id="C8-P5-M128"),
        pytest.param(8, 4, 32, 256, 2, 100, id="C8-P4-lowerN32-two-rings"),
        pytest.param(5, 8, 2, 256, 2, 90, id="C5-P8"),
        pytest.param(7, 5, 2, 256, 2, 90, id="C7-P5"),
        pytest.param(6, 6, 3, 256, 2, 90, id="C6-P6"),
        pytest.param(4, 10, 2, 256, 2, 90, id="C4-P10"),
        pytest.param(4, 7, 32, 256, 1, 100, id="C4-P7-lowerN32-two-rings"),
        pytest.param(3, 13, 1, 128, 2, 90, id="C3-P13"),
        pytest.param(2, 20, 2, 256, 2, 90, id="C2-P20"),
        pytest.param(1, 40, 2, 128, 2, 90, id="C1-P40"),
        # its edges: frame counts within one step, within the lag history
        # and no multiple of a step; three chunks of frames, the last ragged;
        # no delay; one utterance; taps past P (zeros) at C = 3 and 2; M = 256
        # at one channel; the config-4 shape over 10 s
        pytest.param(8, 5, 2, 256, 1, 1, id="wide-Tf1"),
        pytest.param(8, 5, 2, 256, 2, 7, id="wide-Tf7-within-a-step"),
        pytest.param(8, 5, 32, 256, 2, 20, id="wide-Tf20-within-history"),
        pytest.param(8, 5, 2, 256, 2, 531, id="wide-Tf531-three-chunks"),
        pytest.param(8, 5, 0, 256, 3, 261, id="wide-lowerN0"),
        pytest.param(8, 4, 0, 128, 1, 45, id="wide-C8-P4-M128-B1"),
        pytest.param(3, 9, 2, 256, 2, 90, id="wide-C3-P9-padded-taps"),
        pytest.param(2, 13, 3, 128, 2, 90, id="wide-C2-P13-padded-taps"),
        pytest.param(1, 40, 32, 256, 1, 70, id="wide-C1-P40-M256-lowerN32"),
        pytest.param(8, 5, 2, 256, 1, 1254, id="wide-config4-c8-Tf1254"),
        # M = 64 and 512: narrow (32 and 256 lanes), the wide kernel at one
        # and eight groups of 32 bins, and at M = 512 the narrow shapes of 5
        # to 8 channels (a block would take 800 or 1,056 threads) in the wide
        # kernel
        pytest.param(4, 5, 2, 64, 2, 90, id="M64"),
        pytest.param(1, 24, 2, 64, 2, 90, id="C1-P24-M64"),
        pytest.param(8, 3, 32, 64, 2, 100, id="C8-P3-lowerN32-M64"),
        pytest.param(8, 5, 2, 64, 2, 90, id="wide-C8-P5-M64"),
        pytest.param(4, 5, 2, 512, 2, 90, id="M512"),
        pytest.param(4, 6, 32, 512, 2, 100, id="C4-P6-lowerN32-two-rings-M512"),
        pytest.param(6, 4, 3, 512, 2, 90, id="C6-P4-M512-in-the-wide-kernel"),
        pytest.param(5, 4, 1, 512, 2, 90, id="C5-P4-M512-in-the-wide-kernel"),
        pytest.param(8, 3, 2, 512, 2, 90, id="C8-P3-M512-in-the-wide-kernel"),
        pytest.param(7, 3, 2, 512, 1, 45, id="C7-P3-M512-in-the-wide-kernel"),
        pytest.param(8, 5, 2, 512, 2, 300, id="wide-C8-P5-M512"),
        # M = 1024 and 2048: every shape in the wide kernel (32 and 64 groups)
        pytest.param(4, 5, 2, 1024, 2, 90, id="M1024"),
        pytest.param(2, 3, 1, 1024, 9, 45, id="C2-P3-B9-M1024"),
        pytest.param(8, 5, 2, 2048, 1, 37, id="wide-C8-P5-M2048"),
        pytest.param(4, 6, 32, 2048, 2, 70, id="C4-P6-lowerN32-M2048"),
    ],
)
def test_wpe_resid_kernel_matches_plain(dev, C, P, lowerN, M, B, Tf):
    Yp, G = _wpe_case(C * P + lowerN, Tf, B, C, M, P)
    ref = wpe_resid(Yp, G, lowerN)
    before = wpe_resid.launches
    got = wpe_resid(Yp.to(dev), G.to(dev), lowerN)
    assert wpe_resid.launches == before + 1
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("n,N", [(20, 1000), (6, 37), (21, 5), (31, 3),
                                 # the edges of the kernel's compiled row widths (4, 8,
                                 # ..., 24, 32), and batches of 4 systems left partial
                                 (1, 7), (4, 33), (5, 9), (20, 1001), (24, 61), (25, 6),
                                 (31, 10),
                                 # more systems than warps the card holds (at most 16
                                 # blocks of 4 warps an SM; at n = 31, 3 by shared
                                 # memory): every warp solves several, staging the
                                 # next into its second slot
                                 (20, 16901), (5, 16901), (31, 3301),
                                 # n = 32 .. 40: rows 32 .. 39 split across four lanes
                                 # each, one system a warp's slot; more systems than
                                 # warps at n = 33 and 40
                                 (32, 7), (33, 16901), (36, 5), (39, 9), (40, 1001),
                                 (40, 16901),
                                 # its edges: one system, blocks of 4 warps left
                                 # partial, just below and above the 1584 warps the
                                 # card holds at 3 blocks an SM, odd n (8-byte copies)
                                 (40, 1), (37, 3), (34, 1583), (40, 1585), (35, 11),
                                 (38, 3169),
                                 # the counts of M = 2048 (1025 bins): config 4 at 32
                                 # utterances x 4 channels, 8 channels at 2 utterances
                                 (20, 131200), (40, 16400)])
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


@pytest.mark.parametrize("n", [1, 6, 20, 24, 31, 33, 40, 32, 39])
def test_gj_solve_kernel_zero_pivot(dev, n):
    """A zero pivot divides by 1, as the plain version does: R's first
    diagonal entry set to zero in every third system."""
    rng = np.random.default_rng(n + 77)
    N = 10
    L = rng.standard_normal((N, n, 3 * n)) + 1j * rng.standard_normal((N, n, 3 * n))
    R = np.einsum("npt,nqt->npq", L, L.conj())
    R += (np.abs(np.diagonal(R, axis1=1, axis2=2)).max(-1) * 0.01)[:, None, None] * np.eye(n)
    R[::3, 0, 0] = 0
    R = torch.from_numpy(R.astype(np.complex64))
    r = torch.from_numpy((rng.standard_normal((N, n)) + 1j * rng.standard_normal((N, n))).astype(
        np.complex64))
    ref = gj_solve(R, r)
    got = gj_solve(R.to(dev), r.to(dev))
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
    assert kernels.launch_counts() == _only(analysis_tm=2, gsc_rls_zelinski=1, synthesis_tm=1,
                                            aec_scan=1, wpe_stats=2, wpe_resid=1, gj_solve=2)
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
        analysis_tm_fused(x, h, p, hr=torch.zeros((4, 256)))
    with pytest.raises(NotImplementedError, match="M=4096"):  # no FFT plan, no other route
        analysis_tm_fused(x, torch.zeros(16384, device=dev), FilterbankParams(M=4096),
                          A=torch.zeros((4096, 4096)))
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
    with pytest.raises(RuntimeError, match="shape outside"):  # C*P = 44 > 40
        wpe_stats(A, torch.zeros((2, 4, 129, 44), dtype=torch.complex64, device=dev), 2, 11)
    with pytest.raises(RuntimeError, match="shape outside"):
        wpe_resid(A, torch.zeros((2, 4, 129, 44), dtype=torch.complex64, device=dev), 2)
    with pytest.raises(ValueError, match="complex64"):
        wpe_resid(A, G.to(torch.complex128), 2)
    R = torch.zeros((5, 41, 41), dtype=torch.complex64, device=dev)
    with pytest.raises(RuntimeError, match="shape outside"):  # n = 41 > 40
        gj_solve(R, torch.zeros((5, 41), dtype=torch.complex64, device=dev))
    assert set(kernels.launch_counts().values()) == {0}


def _fixed_weights(C, M=256):
    """SD-MVDR weights and the alignment manifold of a linear 50 mm array."""
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return (superdirective_weights(mpos, _delays(C), M, FS),
            array_manifold(M, FS, _delays(C)))


@pytest.mark.parametrize("C,pf_type,pf_min_frames", [
    (2, 1, 0), (2, 2, 2), (4, 1, 2), (4, 2, 0), (8, 1, 0), (8, 2, 2),
])
def test_zelinski_apply_kernel_matches_plain(dev, C, pf_type, pf_min_frames):
    """Tf = 43 frames (the kernel loads frames in groups of 4), utterance 1
    digitally silent (trace 0: the floor, no NaN)."""
    rng = np.random.default_rng(10 * C + pf_type)
    Yp = _packed(rng, 43, 3, C, 256)
    Yp[:, 1] = 0.0
    wqH, vs = _fixed_weights(C)
    ref = zelinski_apply(Yp, wqH, vs, 0.6, pf_type, pf_min_frames)
    before = zelinski_apply.launches
    got = zelinski_apply(Yp.to(dev), wqH.to(dev), vs.to(dev), 0.6, pf_type, pf_min_frames)
    assert zelinski_apply.launches == before + 1
    _close(got, ref, 3e-5)
    assert not got[:, 1].any()


@pytest.mark.parametrize("C,pf_type,pf_min_frames,T,fb_kw", [
    (2, 1, 2, 5000, {}),
    (3, 2, 0, 4100, {}),
    (4, 1, 2, 5000, {}),
    (4, 2, 0, 7000, {}),
    (8, 1, 0, 4700, {}),
    (8, 2, 2, 3000, {}),
    (4, 1, 2, 5000, dict(delay_compensation_type=0)),
    (4, 2, 2, 6000, dict(m=2, r=2)),
])
def test_fw_mono_kernel_matches_chain_and_plain(dev, C, pf_type, pf_min_frames, T, fb_kw):
    """K8 against K1 -> K7 -> K3 on the card and against the plain chain on
    the CPU; every frame count here leaves a partial last tile of K = 64 / C
    frames, and utterance 1 is digitally silent."""
    fb = FilterbankParams(**{"M": 256, "m": 4, "r": 1, "delay_compensation_type": 2, **fb_kw})
    assert num_analysis_frames(fb, T) % (64 // C) != 0
    rng = np.random.default_rng(T + C)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    x = torch.from_numpy((rng.standard_normal((3, C, T)) * 1500).astype(np.float32))
    x[1] = 0.0
    wqH, vs = _fixed_weights(C)
    args = (0.6, pf_type, pf_min_frames)
    ref = analysis_fw_synthesis(x, h, g, fb, wqH, vs, *args)
    xd, hd, gd, wd, vd = (t.to(dev) for t in (x, torch.from_numpy(h), torch.from_numpy(g), wqH,
                                               vs))
    kernels.reset_launch_counts()
    got = analysis_fw_synthesis(xd, hd, gd, fb, wd, vd, *args)
    assert kernels.launch_counts() == _only(fw_mono=1)
    chain = synthesis_tm_fused(zelinski_apply(analysis_tm_fused(xd, hd, fb), wd, vd, *args), gd,
                               fb)
    _close(got, chain.cpu(), 2e-4)
    _close(got, ref, 3e-4)
    assert not got[1].any()


@pytest.mark.parametrize("case", TONE_CASES)
def test_fw_mono_kernel_tones_and_impulses(dev, case):
    """K8 on one bin at a time (and impulse trains) against K1 -> K7 -> K3
    and the plain chain: a wrong twiddle, split, packing or segment-reversal
    index of its FFTs fails on a named bin."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, g = load_pair(256, 4, 1)
    x = _tone_signal(case, 4, 5000)
    wqH, vs = _fixed_weights(4)
    args = (0.6, 1, 2)
    ref = analysis_fw_synthesis(x, h, g, fb, wqH, vs, *args)
    xd, hd, gd, wd, vd = (torch.as_tensor(t).to(dev) for t in (x, h, g, wqH, vs))
    got = analysis_fw_synthesis(xd, hd, gd, fb, wd, vd, *args)
    chain = synthesis_tm_fused(zelinski_apply(analysis_tm_fused(xd, hd, fb), wd, vd, *args), gd,
                               fb)
    _close(got, chain.cpu(), 2e-4)
    _close(got, ref, 3e-4)


def test_fw_mono_refuses_another_tile(dev, monkeypatch):
    """The Python shape rule's tile (`fixed_weight.FW_MONO_ROWS`) must be
    the kernel's own: a launch that assumes another is refused."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, g = (torch.ones(fb.N, device=dev) for _ in range(2))
    wqH, vs = (w.to(dev) for w in _fixed_weights(4))
    monkeypatch.setattr(fixed_weight, "FW_MONO_ROWS", 32)
    with pytest.raises(RuntimeError, match="fw_mono"):
        analysis_fw_synthesis(torch.zeros((1, 4, 4000), device=dev), h, g, fb, wqH, vs)


def _steerings(C, B):
    """Per-utterance manifolds of a circular 100 mm array steered at B
    different azimuths, with their conjugates and blocking matrices."""
    ang = 2 * np.pi * np.arange(C) / C
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(C)]
    delays = np.stack([geometry.calc_ca_delays(mpos, az, np.pi / 2)
                       for az in np.linspace(0.3, 5.9, B)]).astype(np.float32)
    return steering_weights(array_manifold(256, FS, torch.from_numpy(delays)))


@pytest.mark.parametrize("C,B", [(2, 3), (4, 3), (8, 3), (4, 1), (4, 63), (4, 64), (4, 133)])
def test_steered_scan_kernel_matches_plain(dev, C, B):
    """K6 with one steering per utterance against its plain version (the
    case has a gate that closes and near-silent bins), and with one
    steering for all, against K2 bit for bit; batches that take blocks of
    64 and of 128 threads, with blocks that straddle utterances."""
    Yp, wqH, BmH, vs = _scan_case(C, 256, seed=20 + C, B=B)
    cfg = GSCRLSConfig(min_frames=8)
    per_utt = _steerings(C, Yp.shape[1])
    ref = gsc_rls_zelinski_steered(Yp, *per_utt, cfg, 0.6, 1, 2)
    Yd = Yp.to(dev)
    before = gsc_rls_zelinski_steered.launches
    got = gsc_rls_zelinski_steered(Yd, *(w.to(dev) for w in per_utt), cfg, 0.6, 1, 2)
    assert gsc_rls_zelinski_steered.launches == before + 1
    _close(got, ref, 2e-4)
    shared = [w.to(dev) for w in (wqH, BmH, vs)]
    k2 = gsc_rls_zelinski(Yd, *shared, cfg, 0.6, 2, 0)
    rows = [w.expand((Yp.shape[1],) + w.shape) for w in shared]
    assert torch.equal(gsc_rls_zelinski_steered(Yd, *rows, cfg, 0.6, 2, 0), k2)


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("pf_type", [1, 2])
def test_steered_zelinski_apply_kernel_matches_plain(dev, C, pf_type):
    """K7 with one steering per utterance (eight azimuths, B = 8, Tf = 43,
    utterance 3 digitally silent) against its plain version, the gain from
    frame 1, 3 or never; given one steering for all, against K7 bit for
    bit."""
    rng = np.random.default_rng(40 + 10 * C + pf_type)
    Yp = _packed(rng, 43, 8, C, 256)
    Yp[:, 3] = 0.0
    wq_b, _, vs_b = _steerings(C, 8)
    Yd = Yp.to(dev)
    wqH, vs = _fixed_weights(C)
    shared = [w.to(dev) for w in (wqH, vs)]
    rows = [w.expand((8,) + w.shape) for w in shared]
    for pf_min_frames in (0, 2, NO_POSTFILTER):
        ref = zelinski_apply_steered(Yp, wq_b, vs_b, 0.6, pf_type, pf_min_frames)
        before = zelinski_apply_steered.launches, zelinski_apply.launches
        got = zelinski_apply_steered(Yd, wq_b.to(dev), vs_b.to(dev), 0.6, pf_type, pf_min_frames)
        assert (zelinski_apply_steered.launches, zelinski_apply.launches) == (before[0] + 1,
                                                                              before[1])
        _close(got, ref, 3e-5)
        assert not got[:, 3].any()
        assert torch.equal(zelinski_apply_steered(Yd, *rows, 0.6, pf_type, pf_min_frames),
                           zelinski_apply(Yd, *shared, 0.6, pf_type, pf_min_frames))


@pytest.mark.parametrize("C", [2, 4, 8])
@pytest.mark.parametrize("pf_type", [1, 2])
def test_steered_lms_scan_kernel_matches_plain(dev, C, pf_type):
    """The LMS scan with one steering per utterance (eight azimuths, B = 8,
    silent opening frames, a silent stretch, a norm cap that fires) against
    its plain loop, the gain from frame 1, 3 or never; each call launches
    the gate pass and the per-utterance scan once; given one steering for
    all, against the shared-weight scan bit for bit."""
    Yp, wqH, BmH, vs = _lms_case(C, 256, 8, 40, seed=500 + C + pf_type)
    cfg = GSCLMSConfig(max_wa_l2norm=5e-7, **LMS_CARD)
    per_utt = _steerings(C, 8)
    Yd = Yp.to(dev)
    w_b = [w.to(dev) for w in per_utt]
    shared = [w.to(dev) for w in (wqH, BmH, vs)]
    rows = [w.expand((8,) + w.shape) for w in shared]
    for pf_min_frames in (0, 2, NO_POSTFILTER):
        ref = gsc_postfilter_fused(Yp, None, *per_utt, "lms", cfg, 0.6, pf_type, pf_min_frames,
                                   True)
        before = (gsc_lms_zelinski_steered.launches, lms_gates.launches,
                  gsc_lms_zelinski.launches)
        got = gsc_lms_zelinski_steered(Yd, *w_b, cfg, 0.6, pf_type, pf_min_frames)
        assert (gsc_lms_zelinski_steered.launches, lms_gates.launches,
                gsc_lms_zelinski.launches) == (before[0] + 1, before[1] + 1, before[2])
        _close(got, ref, 2e-4)
        assert torch.equal(gsc_lms_zelinski_steered(Yd, *rows, cfg, 0.6, pf_type, pf_min_frames),
                           gsc_lms_zelinski(Yd, *shared, cfg, 0.6, pf_type, pf_min_frames))


@pytest.mark.parametrize("bf", ["ds", "sd_mvdr", "lcmv"])
def test_fixed_weight_pipeline_matches_plain(dev, bf):
    """The fixed-weight `Enhancer` on the card launches K8 once and nothing
    else, and equals the same module on the CPU."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer=bf, postfilter="zelinski",
                         pf_min_frames=2)
    rng = np.random.default_rng(5)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    mpos = np.c_[np.arange(4) * 50.0, np.zeros((4, 2))]
    x = torch.from_numpy((rng.standard_normal((3, 4, 9000)) * 1500).astype(np.float32))
    noise = [_delays(4, 2 * np.pi / 3)]
    cpu = build_pipeline(cfg, mpos, _delays(4), h, g, noise_delays=noise, device="cpu")
    gpu = build_pipeline(cfg, mpos, _delays(4), h, g, noise_delays=noise)
    with torch.no_grad():
        ref = cpu(x)
        kernels.reset_launch_counts()
        got = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(fw_mono=1)
    _close(got, ref, 3e-4)


def test_fixed_weight_split_pipeline_matches_plain(dev):
    """Where K8's frame tiles cannot hold the synthesis halo (8 channels,
    r=2: 15 halo frames, 8-frame tiles) the fixed-weight `Enhancer` runs
    K1 -> K7 -> K3, once each, and equals the same module on the CPU."""
    fb = FilterbankParams(M=256, m=4, r=2, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer="sd_mvdr", postfilter="zelinski",
                         pf_min_frames=2)
    rng = np.random.default_rng(8)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    mpos = np.c_[np.arange(8) * 50.0, np.zeros((8, 2))]
    x = torch.from_numpy((rng.standard_normal((3, 8, 7000)) * 1500).astype(np.float32))
    cpu = build_pipeline(cfg, mpos, _delays(8), h, g, device="cpu")
    gpu = build_pipeline(cfg, mpos, _delays(8), h, g)
    with torch.no_grad():
        ref = cpu(x)
        kernels.reset_launch_counts()
        got = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(analysis_tm=1, zelinski_apply=1, synthesis_tm=1)
    _close(got, ref, 3e-4)


def test_steered_pipeline_matches_plain(dev):
    """The config-5 `SteeredEnhancer` on the card (K1, K6, K3 once each)
    against the same module on the CPU: sources placed at grid directions,
    so both find the placed direction."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2, rls=GSCRLSConfig(min_frames=4))
    rng = np.random.default_rng(6)
    h, g = load_pair(256, 4, 1)  # the SRP needs a real filterbank to find the sources
    ang = 2 * np.pi * np.arange(4) / 4
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(4)]
    phis = np.deg2rad(np.arange(0.0, 360.0, 30.0))
    placed = [1, 4, 7, 10]
    T = 9000
    src = rng.standard_normal((4, T + 64)).astype(np.float32) * 1500
    # sensor noise 20 dB down: exact copies would make the adaptive filter
    # amplify rounding (tests/test_torch_steered.py)
    x = rng.standard_normal((4, 4, T)).astype(np.float32) * 150
    for b, gi in enumerate(placed):
        d = geometry.calc_ca_delays(mpos, phis[gi], np.pi / 2)
        for c in range(4):
            off = 8 - int(round(float(d[c]) * FS))
            x[b, c] += src[b, off:off + T]
    x = torch.from_numpy(x)
    cpu = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis, device="cpu")
    gpu = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis)
    with torch.no_grad():
        ref, doa_ref = cpu(x)
        kernels.reset_launch_counts()
        got, doa = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(analysis_tm=1, gsc_rls_zelinski_steered=1,
                                            synthesis_tm=1)
    assert torch.equal(doa.cpu(), doa_ref)
    assert torch.equal(doa_ref[:, 1], torch.tensor(phis[placed], dtype=torch.float32))
    _close(got, ref, 3e-4)


# the steered routes: (beamformer, postfilter, build_steered_pipeline
# keywords, the beamformer's launches)
STEERED_ROUTES = (
    ("ds", "zelinski", {}, dict(zelinski_apply_steered=1)),
    ("ds", "none", {}, dict(zelinski_apply_steered=1)),
    ("gsc_lms", "zelinski", {}, dict(lms_gates=1, gsc_lms_zelinski_steered=1)),
    ("gsc_lms", "none", dict(min_bin=5, max_bin=100),
     dict(lms_gates=1, gsc_lms_zelinski_steered=1)),
    ("gsc_rls", "none", {}, dict(gsc_rls_zelinski_steered=1)),
    ("gsc_rls", "zelinski", dict(doa_protocol="dsbla", energy_threshold=1e10),
     dict(gsc_rls_zelinski_steered=1)),
)


@pytest.mark.parametrize("bf,pf,kw,launches", STEERED_ROUTES)
def test_steered_routes_match_plain(dev, bf, pf, kw, launches):
    """Every route of the `SteeredEnhancer` on the card (K1, the route's
    beamformer kernel, K3 once each) against the same module on the CPU:
    the DOA equal, the output within 3e-4."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer=bf, postfilter=pf, pf_min_frames=2,
                         rls=GSCRLSConfig(min_frames=4), lms=GSCLMSConfig(min_frames=4))
    rng = np.random.default_rng(7)
    h, g = load_pair(256, 4, 1)
    ang = 2 * np.pi * np.arange(4) / 4
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(4)]
    phis = np.deg2rad(np.arange(0.0, 360.0, 30.0))
    placed = [2, 5, 8, 11]
    T = 9000
    src = rng.standard_normal((4, T + 64)).astype(np.float32) * 1500
    x = rng.standard_normal((4, 4, T)).astype(np.float32) * 150
    for b, gi in enumerate(placed):
        d = geometry.calc_ca_delays(mpos, phis[gi], np.pi / 2)
        for c in range(4):
            off = 8 - int(round(float(d[c]) * FS))
            x[b, c] += src[b, off:off + T]
    x[1, :, 6000:] = 0.0  # a zero-padded utterance
    x = torch.from_numpy(x)
    cpu = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis, device="cpu", **kw)
    gpu = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis, **kw)
    with torch.no_grad():
        ref, doa_ref = cpu(x)
        kernels.reset_launch_counts()
        got, doa = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(analysis_tm=1, synthesis_tm=1, **launches)
    assert torch.equal(doa.cpu(), doa_ref)
    assert torch.equal(doa_ref[:, 1], torch.tensor(phis[placed], dtype=torch.float32))
    _close(got, ref, 3e-4)


def test_new_wrappers_raise_on_bad_cuda_input(dev):
    """K6, K7 and K8 on CUDA tensors launch or raise; they never fall back."""
    fb = FilterbankParams()
    wqH, vs = (w.to(dev) for w in _fixed_weights(4))
    Yp = torch.zeros((8, 2, 4, 256), device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="complex64"):
        zelinski_apply(Yp, wqH.to(torch.complex128), vs)
    with pytest.raises(ValueError, match="CUDA"):
        zelinski_apply(Yp, wqH.cpu(), vs)
    x = torch.zeros((2, 4, 4096), device=dev)
    h = torch.zeros(fb.N, device=dev)
    with pytest.raises(ValueError, match="CUDA"):
        analysis_fw_synthesis(x, h, h, fb, wqH, vs.cpu())
    fb128 = FilterbankParams(M=128, m=4, r=1)
    w128 = torch.zeros((65, 4), dtype=torch.complex64, device=dev)
    with pytest.raises(RuntimeError, match="shape outside"):
        analysis_fw_synthesis(x, torch.zeros(fb128.N, device=dev), torch.zeros(fb128.N, device=dev),
                              fb128, w128, w128)
    _, BmH = gsc_weights(256, FS, _delays(4), 1)
    with pytest.raises(ValueError, match="shape"):
        gsc_rls_zelinski_steered(Yp, wqH, BmH.to(dev), vs, GSCRLSConfig())
    assert set(kernels.launch_counts().values()) == {0}


def _hash_noise(shape, seed):
    """Float32 noise in [-100, 100) from integer hashing: exact arithmetic,
    so every machine makes the same bits (the stored scan cases' inputs)."""
    n = np.arange(int(np.prod(shape)), dtype=np.uint64) + np.uint64(seed) * np.uint64(1 << 32)
    h = (n * np.uint64(6364136223846793005) + np.uint64(1442695040888963407)) >> np.uint64(40)
    v = (h.astype(np.float32) - np.float32(1 << 23)) * np.float32(100.0 / (1 << 23))
    return v.reshape(shape)


@pytest.mark.parametrize("tag,Tf,B,C,pf_type,pf_min_frames,M", [
    ("a", 24, 2, 3, 1, 2, 32),  # K2, a gate that closes and near-silent bins
    ("b", 16, 2, 8, 2, 0, 32),  # K2 at C = 8
    ("s", 16, 3, 4, 1, 2, 32),  # K6, one steering per utterance
    # F = 129: five groups of 32 bins, the last with one; 37 frames, no
    # multiple of a chunk of frames; the gate closes and the top bins are
    # near-silent in each case
    ("a", 37, 2, 4, 1, 2, 256),  # K2
    ("b", 37, 2, 8, 2, 0, 256),  # K2 at C = 8
    ("s", 37, 3, 4, 1, 2, 256),  # K6, three steerings
])
def test_scan_kernels_equal_stored_outputs(dev, tag, Tf, B, C, pf_type, pf_min_frames, M):
    """K2 and K6 give, bit for bit, the outputs stored from their kernels as
    they were before the per-frame step became a shared device function (M =
    32, ``gsc_scan_case.npz``) and before the scan was cut into chunks of
    frames and blocks of bins (M = 256, ``gsc_scan_case_m256.npz``, from
    ``tests/probe_gsc_scan_phases.py --write-case``)."""
    z = np.load(Path(__file__).parent / "data" /
                ("gsc_scan_case.npz" if M == 32 else "gsc_scan_case_m256.npz"))
    Yp = _hash_noise((Tf, B, C, M), ord(tag) + (M if M == 256 else 0))
    if tag != "s" or M == 256:
        Yp[8:12, 1] *= np.float32(1e-6)
        lo, hi = 3 * M // 8, M // 2
        Yp[:, -1, :, lo:hi + 1] *= np.float32(1.8e-8)
        Yp[:, -1, :, lo + M // 2:] *= np.float32(1.8e-8)
    w = [torch.from_numpy(z[f"{tag}_{k}"]).to(dev) for k in ("wqH", "BmH", "vs")]
    fn = gsc_rls_zelinski_steered if tag == "s" else gsc_rls_zelinski
    got = fn(torch.from_numpy(Yp).to(dev), *w, GSCRLSConfig(min_frames=4), 0.6, pf_type,
             pf_min_frames)
    assert torch.equal(got.cpu(), torch.from_numpy(z[f"{tag}_out"]))


@pytest.mark.parametrize("case", ["n256", "k256", "n128", "k128", "gj6", "gj20", "gj24", "gj31"])
def test_aec_gj_kernels_equal_stored_outputs(dev, case):
    """K9 and K12 give, bit for bit, the outputs stored from their first
    designs (K9: a thread loading groups of 4 frames from device memory; K12:
    a lane per column, factors by shuffle) by ``tests/probe_aec_gj_phases.py
    --write-case`` (``tests/data/aec_gj_case.npz``): K9 at M = 256 and 128,
    17 and 23 frames, far-end bins that are zero and frames where the gate
    closes; K12 at n = 6 (one zero first pivot), 20, 24 and 31."""
    z = np.load(Path(__file__).parent / "data" / "aec_gj_case.npz")
    if case.startswith("gj"):
        got = gj_solve(torch.from_numpy(z[f"{case}_R"]).to(dev),
                       torch.from_numpy(z[f"{case}_r"]).to(dev))
        assert torch.equal(torch.view_as_real(got.cpu()).view(torch.int32),
                           torch.view_as_real(torch.from_numpy(z[f"{case}_x"])).view(torch.int32))
        return
    kind, M = ("nlms" if case[0] == "n" else "kalman"), int(case[1:])
    Tf, B, C = (17, 2, 2) if M == 256 else (23, 1, 3)
    F = M // 2 + 1
    A = _hash_noise((Tf, B, C, M), ord(case[0]) + M)
    V = _hash_noise((Tf, B, M), ord(case[0]) + M + 1)
    V[:, 0, 3:9] = 0.0
    V[:, 0, F + 2:F + 8] = 0.0
    V[5:11] *= np.float32(1e-3)
    p1, p2 = (100.0, 1e-4) if kind == "nlms" else (0.95, 1e-3)
    got = aec_scan(torch.from_numpy(A).to(dev), torch.from_numpy(V).to(dev), kind, p1, p2, 100.0)
    assert torch.equal(got.cpu().view(torch.int32), torch.from_numpy(z[f"{case}_E"]).view(torch.int32))


@pytest.mark.parametrize("case", ["gj33", "gj40", "r8x5", "r8x4", "r1x40"])
def test_wpe_wide_kernels_equal_stored_outputs(dev, case):
    """K12 at n = 33 (system 0 with a zero first pivot) and 40, and K11 at
    (C, P) = (8, 5) with M = 256, (8, 4) with lowerN = 32 and (1, 40) with M
    = 128, give, bit for bit, the outputs stored from their first designs for
    C*P > 24 (K12: rows 32 .. 39 split across four lanes, two __syncwarp a
    step; K11: one target a thread, an utterance's frames a block) by
    ``tests/probe_aec_gj_phases.py --write-wide-case`` and
    ``tests/probe_wpe_phases.py --write-wide-case``
    (``tests/data/wpe_wide_case.npz``, inputs from hash noise)."""
    z = np.load(Path(__file__).parent / "data" / "wpe_wide_case.npz")
    if case.startswith("gj"):
        got = gj_solve(torch.from_numpy(z[f"{case}_R"]).to(dev),
                       torch.from_numpy(z[f"{case}_r"]).to(dev))
        want = torch.from_numpy(z[f"{case}_x"])
        assert torch.equal(torch.view_as_real(got.cpu()).view(torch.int32),
                           torch.view_as_real(want).view(torch.int32))
        return
    C, P, lowerN, M, B, Tf, seed = {"r8x5": (8, 5, 2, 256, 1, 30, 1100),
                                    "r8x4": (8, 4, 32, 256, 1, 30, 1200),
                                    "r1x40": (1, 40, 2, 128, 2, 30, 1300)}[case]
    F = M // 2 + 1
    Yp = _hash_noise((Tf, B, C, M), seed)
    G = (_hash_noise((B, C, F, C * P), seed + 1) * np.float32(1e-3)
         + 1j * (_hash_noise((B, C, F, C * P), seed + 2) * np.float32(1e-3)))
    got = wpe_resid(torch.from_numpy(Yp).to(dev), torch.from_numpy(G.astype(np.complex64)).to(dev),
                    lowerN).cpu()
    assert torch.equal(got.view(torch.int32), torch.from_numpy(z[f"{case}_out"]).view(torch.int32))


def _gsc_args(C, pf_type, pf_min_frames, min_frames=8):
    wqH, BmH = gsc_weights(256, FS, _delays(C), 1)
    vs = array_manifold(256, FS, _delays(C))
    return wqH, BmH, vs, GSCRLSConfig(min_frames=min_frames), 0.6, pf_type, pf_min_frames


@pytest.mark.parametrize("C,pf_type,pf_min_frames,T,fb_kw", [
    (2, 1, 2, 5000, {}),
    (3, 2, 0, 4100, {}),
    (4, 1, 2, 5000, {}),
    (5, 2, 2, 4700, {}),
    (6, 1, 0, 4400, {}),
    (7, 2, 0, 3900, {}),
    (8, 1, 2, 4700, {}),
    (4, 1, 2, 5000, dict(delay_compensation_type=0)),
    (4, 2, 0, 5000, dict(delay_compensation_type=1)),
    (4, 2, 2, 6000, dict(m=2, r=2)),
])
def test_gsc_mono_kernels_match_chain_and_plain(dev, C, pf_type, pf_min_frames, T, fb_kw):
    """K4 against K1 -> K2 -> K3 (3e-4) and K5 against K1 -> K2 (bit for
    bit) on the card, both against the plain chain on the CPU; every frame count
    leaves a partial last tile of 64 / C frames, utterance 1 is digitally
    silent and utterance 2 has a silent stretch (the gate closes)."""
    fb = FilterbankParams(**{"M": 256, "m": 4, "r": 1, "delay_compensation_type": 2, **fb_kw})
    assert num_analysis_frames(fb, T) % (64 // C) != 0
    rng = np.random.default_rng(T + C)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    x = torch.from_numpy((rng.standard_normal((3, C, T)) * 1500).astype(np.float32))
    x[1] = 0.0
    x[2, :, 1000:2000] *= 1e-6
    args = _gsc_args(C, pf_type, pf_min_frames)
    ref5 = analysis_gsc_rls_zelinski(x, h, fb, *args)
    ref4 = analysis_gsc_synthesis(x, h, g, fb, *args)
    xd, hd, gd = (t.to(dev) for t in (x, torch.from_numpy(h), torch.from_numpy(g)))
    ad = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    kernels.reset_launch_counts()
    got5 = analysis_gsc_rls_zelinski(xd, hd, fb, *ad)
    got4 = analysis_gsc_synthesis(xd, hd, gd, fb, *ad)
    assert kernels.launch_counts() == _only(gsc_analysis=1, gsc_mono=1)
    Yk = gsc_rls_zelinski(analysis_tm_fused(xd, hd, fb), *ad)
    assert torch.equal(got5, Yk)
    _close(got4, synthesis_tm_fused(Yk, gd, fb).cpu(), 3e-4)
    _close(got5, ref5, 2e-4)
    _close(got4, ref4, 3e-4)
    assert not got4[1].any()


@pytest.mark.parametrize("case", TONE_CASES)
def test_gsc_mono_kernel_tones_and_impulses(dev, case):
    """K4 on one bin at a time (and impulse trains) against K1 -> K2 -> K3
    and the plain chain, and K5 against K1 -> K2 bit for bit: a wrong
    twiddle, split, pairing or segment-reversal index of their FFTs fails on
    a named bin."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    h, g = load_pair(256, 4, 1)
    x = _tone_signal(case, 4, 5000)
    args = _gsc_args(4, 1, 2)
    ref = analysis_gsc_synthesis(x, h, g, fb, *args)
    xd, hd, gd = (torch.as_tensor(t).to(dev) for t in (x, h, g))
    ad = tuple(a.to(dev) if torch.is_tensor(a) else a for a in args)
    got = analysis_gsc_synthesis(xd, hd, gd, fb, *ad)
    Yk = gsc_rls_zelinski(analysis_tm_fused(xd, hd, fb), *ad)
    assert torch.equal(analysis_gsc_rls_zelinski(xd, hd, fb, *ad), Yk)
    _close(got, synthesis_tm_fused(Yk, gd, fb).cpu(), 3e-4)
    _close(got, ref, 3e-4)


def test_gsc_mono_refuses_another_tile(dev, monkeypatch):
    """The Python shape rule's tile (`fused_scan.GSC_MONO_ROWS`) must be
    K4's and K5's own: a launch that assumes another is refused."""
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    a4 = tuple(a.to(dev) if torch.is_tensor(a) else a for a in _gsc_args(4, 1, 2))
    h4 = torch.ones(fb.N, device=dev)
    x = torch.zeros((1, 4, 4000), device=dev)
    for rows in (32, 128):
        monkeypatch.setattr(fused_scan, "GSC_MONO_ROWS", rows)
        kernels.reset_launch_counts()
        with pytest.raises(RuntimeError, match="gsc_mono"):
            analysis_gsc_synthesis(x, h4, h4, fb, *a4)
        with pytest.raises(RuntimeError, match="gsc_analysis"):
            analysis_gsc_rls_zelinski(x, h4, fb, *a4)
        assert set(kernels.launch_counts().values()) == {0}


def test_gsc_mono_refuses_what_its_tiles_cannot_hold(dev, monkeypatch):
    """K4 refuses a synthesis halo beyond its frame tile (C = 8 with r = 2:
    15 halo frames, 8-frame tiles), where the flagship `Enhancer` runs K1 ->
    K2 -> K3, and a launch whose caller assumes another tile."""
    fb = FilterbankParams(M=256, m=4, r=2, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2, rls=GSCRLSConfig(min_frames=4))
    rng = np.random.default_rng(9)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    mpos = np.c_[np.arange(8) * 50.0, np.zeros((8, 2))]
    x = torch.from_numpy((rng.standard_normal((2, 8, 6000)) * 1500).astype(np.float32))
    cpu = build_pipeline(cfg, mpos, _delays(8), h, g, device="cpu")
    gpu = build_pipeline(cfg, mpos, _delays(8), h, g)
    args = (gpu.wqH, gpu.BmH, gpu.wq_manifold, cfg.rls)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match="gsc_mono"):
        analysis_gsc_synthesis(x.to(dev), gpu.h, gpu.g, fb, *args)
    with torch.no_grad():
        ref = cpu(x)
        got = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(analysis_tm=1, gsc_rls_zelinski=1, synthesis_tm=1)
    _close(got, ref, 3e-4)
    fb4 = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    a4 = tuple(a.to(dev) if torch.is_tensor(a) else a for a in _gsc_args(4, 1, 2))
    h4 = torch.ones(fb4.N, device=dev)
    monkeypatch.setattr(fused_scan, "GSC_MONO_ROWS", 32)
    with pytest.raises(RuntimeError, match="gsc_mono"):
        analysis_gsc_synthesis(torch.zeros((1, 4, 4000), device=dev), h4, h4, fb4, *a4)
    with pytest.raises(RuntimeError, match="gsc_analysis"):
        analysis_gsc_rls_zelinski(torch.zeros((1, 4, 4000), device=dev), h4, fb4, *a4)


@pytest.mark.parametrize("M", [8, 128, 256])
@pytest.mark.parametrize("m,R", [(2, 1), (2, 4), (4, 2), (4, 4), (1, 1), (8, 2)])
def test_polyphase_fir_kernel_matches_plain(dev, M, m, R):
    """K13 rounds like its plain version (0 expected), batched over two
    leading dims, with a row count that is no multiple of its runs."""
    rng = np.random.default_rng(M + 10 * m + R)
    S = torch.from_numpy(rng.standard_normal((2, 3, 203 + (m - 1) * R, M)).astype(np.float32))
    h = torch.from_numpy(rng.standard_normal((m, M)).astype(np.float32))
    before = polyphase_fir.launches
    got = polyphase_fir(S.to(dev), h.to(dev), m, R)
    assert polyphase_fir.launches == before + 1
    _close(got, polyphase_fir_plain(S, h, m, R), 2e-5)


@pytest.mark.parametrize("M,m,r,dct", [(256, 4, 1, 2), (128, 2, 2, 0), (64, 4, 0, 1)])
def test_polyphase_banks_match_plain(dev, M, m, r, dct):
    """`analysis_polyphase` / `synthesis_polyphase` (K13 once each) against
    the plain full-band banks on the CPU."""
    fb = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dct)
    rng = np.random.default_rng(M + m)
    h = rng.standard_normal(fb.N).astype(np.float32) / 16
    x = torch.from_numpy((rng.standard_normal((2, 2, 3000)) * 1500).astype(np.float32))
    kernels.reset_launch_counts()
    Y = analysis_polyphase(x.to(dev), torch.from_numpy(h).to(dev), fb)
    y = synthesis_polyphase(Y, torch.from_numpy(h).to(dev), fb)
    assert kernels.launch_counts() == _only(polyphase_fir=2)
    Y_ref = analysis(x, h, fb)
    _close(Y, Y_ref, 2e-5)
    _close(y, synthesis(Y_ref, h, fb), 2e-5)


def test_port_kernels_raise_on_bad_cuda_input(dev):
    """K4, K5 and K13 on CUDA tensors launch or raise; they never fall back."""
    fb = FilterbankParams()
    wqH, BmH, vs, cfg = (a.to(dev) if torch.is_tensor(a) else a for a in _gsc_args(4, 1, 2)[:4])
    x = torch.zeros((2, 4, 4096), device=dev)
    h = torch.zeros(fb.N, device=dev)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA"):
        analysis_gsc_synthesis(x, h, h, fb, wqH, BmH.cpu(), vs, cfg)
    with pytest.raises(ValueError, match="float32"):
        analysis_gsc_rls_zelinski(x.double(), h, fb, wqH, BmH, vs, cfg)
    with pytest.raises(RuntimeError, match="shape outside"):
        analysis_gsc_rls_zelinski(torch.zeros((2, 9, 4096), device=dev), h, fb,
                                  *(torch.zeros((129,) + s, dtype=torch.complex64, device=dev)
                                    for s in ((9,), (8, 9), (9,))), cfg)
    with pytest.raises(RuntimeError, match="shape outside"):
        polyphase_fir(torch.zeros((40, 8), device=dev), torch.zeros((9, 8), device=dev), 9, 1)
    with pytest.raises(ValueError, match="float32"):
        polyphase_fir(torch.zeros((40, 8), device=dev, dtype=torch.float64),
                      torch.zeros((2, 8), device=dev), 2, 1)
    assert set(kernels.launch_counts().values()) == {0}


def _lms_case(C, M, B, Tf, seed):
    """Packed spectrum whose first 3 frames are silent (the gate stays shut)
    and with a silent stretch in the middle utterance."""
    rng = np.random.default_rng(seed)
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    Yp[:3] *= np.float32(1e-6)
    Yp[10:14, B // 2] *= np.float32(1e-6)
    wqH, BmH = gsc_weights(M, FS, _delays(C), 1)
    vs = array_manifold(M, FS, _delays(C))
    return torch.from_numpy(Yp), wqH, BmH, vs


# adapts from frame 6, halves its step at frames 7, 14, ...; the small cap
# makes the norm cap fire (the weights' norm reaches ~1e-6 on this input)
LMS_CARD = dict(min_frames=6, slowdown_after=7)


@pytest.mark.parametrize("C,M,B,Tf,cap", [(c, 256, 3, 40, 5e-7) for c in range(2, 9)] + [
    (4, 32, 3, 40, 5e-7), (8, 32, 2, 40, 100.0), (4, 256, 1, 37, 5e-7), (8, 256, 64, 30, 5e-7),
    (8, 256, 256, 20, 5e-7), (4, 256, 256, 20, 100.0),
    # odd batches: blocks of 64 bins start and end inside utterances
    (8, 256, 5, 23, 5e-7), (3, 256, 33, 21, 5e-7), (7, 32, 5, 40, 5e-7), (8, 256, 257, 23, 5e-7),
    # the gate pass's tiles of 2048 frames
    (2, 32, 2, 2100, 5e-7),
    # F = 21: blocks of 64 bins over three utterances and a part
    (4, 40, 3, 30, 5e-7),
    # F = 257 (M = 512) and F = 33 (M = 64)
    (2, 512, 3, 40, 5e-7), (8, 512, 3, 40, 5e-7), (4, 512, 2, 30, 100.0), (3, 64, 5, 40, 5e-7),
    # F = 513 and 1025: the gate pass's energies in batches of nine groups
    (2, 1024, 9, 37, 5e-7), (8, 2048, 1, 30, 5e-7), (4, 2048, 9, 23, 100.0)])
def test_lms_scan_kernel_matches_plain(dev, C, M, B, Tf, cap):
    """The LMS scan against its plain loop, both Zelinski modes, and the
    gain applied from the first frames on, at the last frame only or never;
    each call launches the gate pass and the scan once."""
    Yp, wqH, BmH, vs = _lms_case(C, M, B, Tf, seed=100 + C + M + B)
    cfg = GSCLMSConfig(max_wa_l2norm=cap, **LMS_CARD)
    w = [a.to(dev) for a in (wqH, BmH, vs)]
    for pf_type, pf_min_frames in ((1, 2), (2, 0), (1, Tf - 2), (2, Tf - 1)):
        ref = gsc_postfilter_fused(Yp, None, wqH, BmH, vs, "lms", cfg, 0.6, pf_type,
                                   pf_min_frames, True)
        before = gsc_lms_zelinski.launches, lms_gates.launches
        got = gsc_lms_zelinski(Yp.to(dev), *w, cfg, 0.6, pf_type, pf_min_frames)
        assert (gsc_lms_zelinski.launches, lms_gates.launches) == (before[0] + 1, before[1] + 1)
        _close(got, ref, 2e-4)


@pytest.mark.parametrize("kind,C", [("lms", 2), ("lms", 3), ("lms", 5), ("lms", 8), ("rls", 2),
                                    ("rls", 8)])
def test_scans_without_the_gain_match_the_plain_beamformers(dev, kind, C):
    """``pf_min_frames=NO_POSTFILTER``: the scans give the beamformer alone,
    held to the plain `gsc_lms` / `gsc_rls` on the complex snapshots
    (postfilter "none")."""
    Yp, wqH, BmH, vs = _lms_case(C, 256, 3, 40, seed=200 + C)
    X = unpack_half(Yp).movedim(-2, -1)  # [Tf, B, F, C]
    energy = frame_energy_half(X[..., 0], 256)
    if kind == "lms":
        cfg, plain, scan = GSCLMSConfig(max_wa_l2norm=5e-7, **LMS_CARD), gsc_lms, gsc_lms_zelinski
    else:
        cfg, plain, scan = GSCRLSConfig(min_frames=6), gsc_rls, gsc_rls_zelinski
    ref = pack_half(plain(X, energy, wqH, BmH, cfg)[0])
    got = scan(Yp.to(dev), *(a.to(dev) for a in (wqH, BmH, vs)), cfg, 0.6, 1, NO_POSTFILTER)
    _close(got, ref, 2e-4)


def _pipe_case(C, T, seed, **kw):
    fb = FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, pf_min_frames=2, rls=GSCRLSConfig(min_frames=4),
                         lms=GSCLMSConfig(min_frames=4, slowdown_after=8), **kw)
    rng = np.random.default_rng(seed)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    x = torch.from_numpy((rng.standard_normal((3, C, T)) * 1500).astype(np.float32))
    cpu = build_pipeline(cfg, mpos, _delays(C), h, g, device="cpu")
    gpu = build_pipeline(cfg, mpos, _delays(C), h, g)
    return cpu, gpu, x


@pytest.mark.parametrize("C,bf,pf,launches", [
    (8, "gsc_lms", "zelinski", dict(analysis_tm=1, lms_gates=1, gsc_lms_zelinski=1,
                                    synthesis_tm=1)),
    (4, "gsc_lms", "none", dict(analysis_tm=1, lms_gates=1, gsc_lms_zelinski=1, synthesis_tm=1)),
    (4, "gsc_rls", "none", dict(analysis_tm=1, gsc_rls_zelinski=1, synthesis_tm=1)),
    (4, "ds", "none", dict(analysis_tm=1, synthesis_tm=1)),
    (8, "sd_mvdr", "none", dict(analysis_tm=1, synthesis_tm=1)),
])
def test_lms_and_no_postfilter_pipelines_match_plain(dev, C, bf, pf, launches):
    """The `Enhancer` with the LMS GSC (BASELINE config 3) or without a
    postfilter: K1, the scan (none for fixed weights: a plain product) and
    K3, once each, against the same module on the CPU."""
    cpu, gpu, x = _pipe_case(C, 7000, seed=C, beamformer=bf, postfilter=pf)
    with torch.no_grad():
        ref = cpu(x)
        kernels.reset_launch_counts()
        got = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(**launches)
    _close(got, ref, 3e-4)


@pytest.mark.parametrize("aec,C", [
    pytest.param("nlms", 4, id="nlms"), pytest.param("kalman", 4, id="kalman"),
    # BASELINE config 4 at 8 channels: the default taps give C*P = 40
    pytest.param("nlms", 8, id="nlms-C8"), pytest.param("block_kalman", 8, id="block_kalman-C8"),
    pytest.param("block_kalman", 4, id="block_kalman"),
])
def test_config4_lms_pipeline_matches_plain(dev, aec, C):
    """Config 4's chain with the LMS GSC: AEC -> WPE -> LMS scan, on the card
    against the same module on the CPU, with every kernel's launch count.
    The block Kalman runs with the Kalman values of the JAX package's tests
    (beta = 0.95, sigmau2 = 1e-3)."""
    p = dict(aec_delta=0.95, aec_epsilon=1e-3) if aec == "block_kalman" else {}
    cpu, gpu, x = _pipe_case(C, 9000, seed=11, beamformer="gsc_lms", postfilter="zelinski",
                             aec=aec, wpe=True, **p)
    play = torch.from_numpy((np.random.default_rng(12).standard_normal((3, 9000)) * 1500)
                            .astype(np.float32))
    with torch.no_grad():
        ref = cpu(x, play)
        kernels.reset_launch_counts()
        got = gpu(x.to(dev), play.to(dev))
    assert kernels.launch_counts() == _only(analysis_tm=2, lms_gates=1, gsc_lms_zelinski=1,
                                            synthesis_tm=1, aec_scan=1, wpe_stats=2, wpe_resid=1,
                                            gj_solve=2)
    _close(got, ref, 3e-4)


def test_lms_wrapper_raises_on_bad_cuda_input(dev):
    """The LMS scan on CUDA tensors launches or raises; it never falls back."""
    Yp, wqH, BmH, vs = _lms_case(4, 256, 2, 8, seed=0)
    Yd = Yp.to(dev)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="complex64"):
        gsc_lms_zelinski(Yd, wqH.to(dev, torch.complex128), BmH.to(dev), vs.to(dev),
                         GSCLMSConfig())
    with pytest.raises(ValueError, match="CUDA"):
        gsc_lms_zelinski(Yd, wqH.to(dev), BmH, vs.to(dev), GSCLMSConfig())
    with pytest.raises(RuntimeError, match="shape outside"):
        gsc_lms_zelinski(Yd, *(a.to(dev) for a in (wqH, BmH, vs)), GSCLMSConfig(slowdown_after=0))
    assert set(kernels.launch_counts().values()) == {0}


def test_steered_wrappers_raise_on_bad_cuda_input(dev):
    """The per-utterance K7 and LMS scan on CUDA tensors launch or raise:
    one set of weights where one per utterance is needed, a complex128 or a
    CPU weight, and a refused step countdown (before the gate pass) raise,
    and nothing launches."""
    Yp, wqH, BmH, vs = _lms_case(4, 256, 2, 8, seed=1)
    Yd = Yp.to(dev)
    shared = [a.to(dev) for a in (wqH, BmH, vs)]
    per_utt = [a.expand((2,) + a.shape) for a in shared]
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="shape"):
        zelinski_apply_steered(Yd, shared[0], shared[2])
    with pytest.raises(ValueError, match="complex64"):
        zelinski_apply_steered(Yd, per_utt[0].to(torch.complex128), per_utt[2])
    with pytest.raises(ValueError, match="shape"):
        gsc_lms_zelinski_steered(Yd, *shared, GSCLMSConfig())
    with pytest.raises(ValueError, match="CUDA"):
        gsc_lms_zelinski_steered(Yd, per_utt[0], per_utt[1].cpu(), per_utt[2], GSCLMSConfig())
    with pytest.raises(RuntimeError, match="shape outside"):
        gsc_lms_zelinski_steered(Yd, *per_utt, GSCLMSConfig(slowdown_after=0))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("C,M,B,Tf", [(4, 256, 3, 40), (8, 256, 257, 23), (2, 32, 2, 2100),
                                      (3, 32, 5, 4200), (8, 40, 1, 7), (8, 512, 3, 40),
                                      (2, 64, 4, 40), (4, 1024, 9, 70), (8, 2048, 1, 45),
                                      (2, 2048, 9, 130),
                                      # config 5's and config 3's frame count, and past 2048
                                      # frames, at one utterance and at B = 64
                                      (4, 256, 1, 1254), (8, 256, 64, 1254), (2, 256, 1, 2100),
                                      (2, 256, 64, 2100)])
def test_lms_gates_kernel_matches_plain(dev, C, M, B, Tf):
    """The gate pass against `adaptive_gsc.lms_silence_gates`, flag for
    flag, with silent frames, at frame counts that leave a partial tile of
    the energy launch and a partial group of the recursion's loads, and
    past 2048 frames; one count a call."""
    Yp = _lms_case(C, M, B, Tf, seed=400 + C + B)[0]
    cfg = GSCLMSConfig()
    ref = lms_silence_gates(Yp, cfg)
    before = lms_gates.launches
    got = lms_gates(Yp.to(dev), cfg)
    assert lms_gates.launches == before + 1
    assert torch.equal(got.cpu(), ref)
    assert not ref[:3].any() and ref.any()


@pytest.mark.parametrize("C", [2, 4, 8])
def test_lms_scan_around_its_ring_of_frames(dev, C):
    """The LMS scan against its plain loop at 1 frame, one frame fewer than
    its ring of staged frames, and one and two rings and a frame, at a batch
    that takes the whole card and at one of two utterances."""
    cfg = GSCLMSConfig(max_wa_l2norm=5e-7, **LMS_CARD)
    for B in (2, 200):
        tc = fused_scan.lms_launch_shape(B, C, 256)["frames"]
        for Tf in sorted({1, max(tc - 1, 1), tc + 1, 2 * tc + 1}):
            Yp, wqH, BmH, vs = _lms_case(C, 256, B, Tf, seed=300 + C + Tf + B)
            ref = gsc_postfilter_fused(Yp, None, wqH, BmH, vs, "lms", cfg, 0.6, 1, 0, True)
            got = gsc_lms_zelinski(Yp.to(dev), *(a.to(dev) for a in (wqH, BmH, vs)), cfg, 0.6, 1, 0)
            _close(got, ref, 2e-4)


@pytest.mark.parametrize("C", range(2, 9))
def test_lms_launch_shape(dev, C):
    """The LMS scan's launch against what the card reports: two lanes a bin,
    blocks of 128 lanes over the (utterance, bin) pairs, no spill and at
    most 128 registers in every Zelinski stage, and at B = 256 one wave with
    four blocks (16 warps) an SM, each warp staging more frames ahead than
    the chunk of 4 of the one-lane scan at C = 8."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for zel in fused_scan.LMS_ZELINSKI_MODES:
        for B, M in ((256, 256), (1, 256), (64, 256), (3, 32)):
            sh = fused_scan.lms_launch_shape(B, C, M, zel)
            F = M // 2 + 1
            assert sh["lanes"] == 2 and sh["threads"] == 128
            assert sh["blocks"] == -(-B * F * 2 // 128)
            assert sh["registers"] <= 128 and sh["local_bytes"] == 0, (zel, sh)
            assert 1 <= sh["frames"] <= 16 and sh["blocks_per_sm"] >= 1
            if B == 256:
                assert sh["blocks"] <= sms * sh["blocks_per_sm"], (zel, sh)
                assert sh["blocks_per_sm"] >= 4, (zel, sh)
                assert sh["frames"] >= 5, (zel, sh)


# the stored LMS cases: (tag, C, pf_type, pf_min_frames, max_wa_l2norm); all
# M = 256, B = 3, Tf = 37 (no multiple of a chunk), hash noise with a gate
# that closes and near-silent top bins
LMS_STORED = (("r", 4, 1, 2, 5e-7), ("a", 8, 2, 0, 100.0), ("n", 8, 1, NO_POSTFILTER, 5e-7))


@pytest.mark.parametrize("tag,C,pf_type,pf_min_frames,cap", LMS_STORED)
def test_lms_scan_equals_stored_outputs(dev, tag, C, pf_type, pf_min_frames, cap):
    """The LMS scan gives, bit for bit, the outputs stored from the lane-pair
    kernel by ``tests/probe_gsc_lms_phases.py --write-case``
    (``tests/data/gsc_lms_case.npz``): the real and modulus Zelinski modes
    and without the gain, C = 4 and 8."""
    z = np.load(Path(__file__).parent / "data" / "gsc_lms_case.npz")
    Tf, B, M = 37, 3, 256
    Yp = _hash_noise((Tf, B, C, M), ord(tag) + 1000)
    Yp[8:12, 1] *= np.float32(1e-6)
    Yp[:, -1, :, 3 * M // 8:M // 2 + 1] *= np.float32(1.8e-8)
    Yp[:, -1, :, 3 * M // 8 + M // 2:] *= np.float32(1.8e-8)
    w = [torch.from_numpy(z[f"{tag}_{k}"]).to(dev) for k in ("wqH", "BmH", "vs")]
    cfg = GSCLMSConfig(max_wa_l2norm=cap, min_frames=4, slowdown_after=9)
    got = gsc_lms_zelinski(torch.from_numpy(Yp).to(dev), *w, cfg, 0.6, pf_type, pf_min_frames)
    assert torch.equal(got.cpu().view(torch.int32),
                       torch.from_numpy(z[f"{tag}_out"]).view(torch.int32))


def _edge_floats():
    """Floats at the edges of `FastDivOps`' range and of float32's."""
    f = np.float32
    base = [0.0, 1.0, 1.5, 3.0, 2.0**-36, 2.0**64, 2.0**-68, 2.0**32, 2.0**-126, 2.0**-149,
            2.0**-130, 2.0**127, 3.4028235e38, 1e-30, 1e30, 2.0**-100, 2.0**100]
    vals = []
    for v in base:
        v = f(v)
        vals += [v, np.nextafter(v, f(np.inf)), np.nextafter(v, f(0)) if v > 0 else v]
    vals += [f(np.inf), f(np.nan)]
    vals = np.array(vals, dtype=np.float32)
    return np.unique(np.concatenate([vals, -vals]))


@pytest.mark.parametrize("scale_exp", [0, 32])
def test_fast_div_has_ieee_bits_where_it_vouches(dev, scale_exp):
    """`FastDivOps` (``csrc/dsr_device.h``) alone and on the dividend scaled
    by 2^32 as the LMS scan runs it, over every pair of edge operands
    (subnormal, zero, the edges of its range, near overflow, +-inf, NaN) and
    4M pairs of random bit patterns over all exponents: wherever it vouches
    for a quotient, the quotient has the bits of the card's IEEE a / b; and
    it vouches for operands of ordinary size."""
    from distant_speech_recognition_tpu_torch.kernels import _build, stream_handle

    with np.errstate(over="ignore"):  # nextafter past the largest float gives inf
        e = _edge_floats()
    a = np.repeat(e, e.size)
    b = np.tile(e, e.size)
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 2**32, size=(2, 1 << 22), dtype=np.uint64).astype(np.uint32)
    a = np.concatenate([a, bits[0].view(np.float32)])
    b = np.concatenate([b, bits[1].view(np.float32)])
    ordinary = rng.uniform(-15, 15, (2, 1 << 16)) * np.log(2)
    a = np.concatenate([a, np.exp(ordinary[0]).astype(np.float32)])
    b = np.concatenate([b, np.exp(ordinary[1]).astype(np.float32)])
    ad, bd = torch.from_numpy(a).to(dev), torch.from_numpy(b).to(dev)
    q = torch.empty_like(ad)
    ok = torch.empty(ad.shape, dtype=torch.int32, device=dev)
    _build.check(_build.library().dsr_fastdiv_check(
        ad.data_ptr(), bd.data_ptr(), q.data_ptr(), ok.data_ptr(), ad.numel(), scale_exp,
        stream_handle(dev)), "fastdiv_check")
    ref = ad / bd
    ok = ok.bool()
    same = q.view(torch.int32) == ref.view(torch.int32)
    bad = ok & ~same
    assert not bad.any(), (a[bad.cpu().numpy()][:5], b[bad.cpu().numpy()][:5])
    assert ok[-(1 << 16):].float().mean().item() > 0.99


def _coherent_packed(rng, Tf, B, C, vs, snr_db=0.0):
    """Packed frames ``[Tf, B, C, M]`` of a source steered by ``vs`` plus
    white sensor noise ``snr_db`` down, so that the coherence postfilters'
    gains fall between their floor and 1 (on white noise alone they sit at
    the floor)."""
    F = vs.shape[0]
    s = (rng.standard_normal((Tf, B, F, 1)) + 1j * rng.standard_normal((Tf, B, F, 1))) * 100.0
    n = (rng.standard_normal((Tf, B, F, C)) + 1j * rng.standard_normal((Tf, B, F, C))) * 100.0
    X = s * vs.numpy() * C + n * 10 ** (-snr_db / 20)
    return pack_half(torch.from_numpy(X.astype(np.complex64)).movedim(-1, -2))


def _coherence_case(C, kind, pf_type, Tf=43, B=3, M=256):
    """Frames with utterance 1 digitally silent, SD-MVDR weights, the
    alignment manifold, the constants of the diffuse field and the plain
    beamformer's packed output."""
    from distant_speech_recognition_tpu_torch.models.beamforming import diffuse_noise_coherence
    from distant_speech_recognition_tpu_torch.models.postfilter import coherence_constants

    rng = np.random.default_rng(100 * C + pf_type + len(kind))
    wqH, vs = _fixed_weights(C, M)
    Yr = _coherent_packed(rng, Tf, B, C, vs)
    Yr[:, 1] = 0.0
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    consts = coherence_constants(kind, diffuse_noise_coherence(mpos, M, FS), vs, pf_type)
    Yp = pack_half(apply_weights(wqH, unpack_half(Yr).movedim(-2, -1)))
    return Yr, Yp, wqH, vs, consts


def _close_nan(got, ref, budget):
    """`_close` where ``ref`` is finite, and NaN exactly where ``ref`` is:
    McCowan and Lefkimmiatis, like the JAX functions, give 0 / 0 on a
    silent bin."""
    got = got.cpu()
    assert torch.equal(torch.isnan(got), torch.isnan(ref))
    fin = ~torch.isnan(ref)
    _close(got[fin], ref[fin], budget)


@pytest.mark.parametrize("kind,pf_type", [("mccowan", 1), ("mccowan", 2), ("lefkimmiatis", 1),
                                          ("lefkimmiatis", 2), ("apab", 1)])
@pytest.mark.parametrize("C", [2, 4, 8])
def test_coherence_postfilter_kernel_matches_plain(dev, kind, pf_type, C):
    """The McCowan / Lefkimmiatis / APAB kernel given the beamformer's output
    against its plain version: 1e-4 x max|ref| (the pair sums divide by 1 -
    Rc, up to 100 at the low bins, which scales their rounding a hundredfold
    over Zelinski's; K7's budget is 3e-5).  Tf = 43 frames (groups of 4),
    pf_min_frames 2; the silent utterance gives NaN from frame 3 on for
    McCowan and Lefkimmiatis, 0 for APAB."""
    from distant_speech_recognition_tpu_torch.models.coherence_postfilter import (
        coherence_postfilter,
    )

    Yr, Yp, wqH, vs, consts = _coherence_case(C, kind, pf_type)
    args = (kind, consts, 0.6, pf_type, 2)
    ref = coherence_postfilter(Yr, Yp, wqH, vs, *args)
    before = coherence_postfilter.launches
    got = coherence_postfilter(Yr.to(dev), Yp.to(dev), wqH.to(dev), vs.to(dev),
                               kind, None if consts is None else consts.to(dev), *args[2:])
    assert coherence_postfilter.launches == before + 1
    _close_nan(got, ref, 1e-4)
    assert torch.isnan(ref[3:, 1]).all() == (kind != "apab")


@pytest.mark.parametrize("kind,pf_type", [("mccowan", 2), ("lefkimmiatis", 1), ("apab", 1)])
@pytest.mark.parametrize("C", [2, 4, 8])
def test_coherence_postfilter_forms_fixed_weight_output(dev, kind, pf_type, C):
    """Given no beamformer output, the kernel forms wqH X itself (as K7
    does): against the same kernel given the plain product, 1e-5 x max|ref|
    (the two products round apart), and against the plain version."""
    from distant_speech_recognition_tpu_torch.models.coherence_postfilter import (
        coherence_postfilter,
    )

    Yr, Yp, wqH, vs, consts = _coherence_case(C, kind, pf_type, Tf=38, B=5)
    d = (None if consts is None else consts.to(dev), 0.6, pf_type, 0)
    formed = coherence_postfilter(Yr.to(dev), None, wqH.to(dev), vs.to(dev), kind, *d)
    given = coherence_postfilter(Yr.to(dev), Yp.to(dev), wqH.to(dev), vs.to(dev), kind, *d)
    _close_nan(formed, given.cpu(), 1e-5)
    _close_nan(formed, coherence_postfilter(Yr, None, wqH, vs, kind, consts, *d[1:]), 1e-4)


# ---- the filterbank sizes M = 64, 128 and 512 ------------------------------

SIZES = (64, 128, 512, 1024, 2048)
SIZE_TONES = ("bin0", "bin1", "binM/4", "binM/2-1", "binM/2", "impulses")


def _tone_bin(case, M):
    return {"bin0": 0, "bin1": 1, "binM/4": M // 4, "binM/2-1": M // 2 - 1, "binM/2": M // 2}[case]


def _spectrum_at(M, case, T_in, B):
    """`_tone_spectrum` at M: packed frames [T_in, B, M] holding one bin
    whose phase turns from frame to frame, or the spectra of single
    impulses at a position that moves by 37 per frame."""
    t = np.arange(T_in)[:, None, None]
    amp = 100.0 / (1.0 + np.arange(B))[None, :, None]
    if case == "impulses":
        A = np.asarray(analysis_matrix_packed_np(M), np.float64)
        return torch.from_numpy((A[(37 * np.arange(T_in) + 5) % M][:, None, :] * amp)
                                .astype(np.float32))
    Yp = np.zeros((T_in, B, M), np.float64)
    f = _tone_bin(case, M)
    Yp[..., f:f + 1] = amp * np.cos(0.7 * t + 0.3)
    if 0 < f < M // 2:
        Yp[..., M // 2 + f:M // 2 + f + 1] = amp * np.sin(0.7 * t + 0.3)
    return torch.from_numpy(Yp.astype(np.float32))


def _signal_at(M, case, C, T, B=2):
    """`_tone_signal` at M: a cosine at the centre of one bin (each channel
    2 samples later), or one impulse per M-sample block."""
    n = np.arange(T)
    x = np.zeros((B, C, T), np.float64)
    for c in range(C):
        if case == "impulses":
            blocks = np.arange(0, T, M)
            pos = blocks + (37 * (blocks // M) + 11 * c) % M
            x[:, c, pos[pos < T]] = 1500.0
        else:
            x[:, c] = 1500.0 * np.cos(2 * np.pi * _tone_bin(case, M) * (n - 2 * c) / M + 0.4)
    x[1] *= 0.25
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("M", SIZES)
@pytest.mark.parametrize("case", SIZE_TONES)
def test_filterbank_kernels_other_sizes_tones_and_impulses(dev, M, case):
    """K1 and K3 at M = 64, 128, 512, 1024 and 2048 one bin at a time (and
    impulses): a wrong twiddle, cell, split, packing or segment-reversal
    index of their FFT plan fails on a named bin.  Above 512 the prototypes
    are the stored ones (designing them takes minutes)."""
    p = FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    h, g = load_pair(M, 4, 1, proto_dir=PROTO_DIR if M > 512 else None)
    x = _signal_at(M, case, 4, 20 * M)
    ref = analysis_half_real_tm(x, h, p, packed=True)
    _close(analysis_tm_fused(x.to(dev), torch.as_tensor(h).to(dev), p), ref, 2e-5)
    Yp = _spectrum_at(M, case, 150, 2)
    ref = synthesis_half_real_tm(Yp, g, p)
    _close(synthesis_tm_fused(Yp.to(dev), torch.as_tensor(g).to(dev), p), ref, 2e-5)


@pytest.mark.parametrize(
    "M,m,r,dct,T_in,lead",
    [
        (64, 4, 1, 2, 700, (3,)),  # BASELINE config 1; tiles of 256 rows
        (64, 4, 5, 2, 300, (2,)),  # m*R = 128 of 256 rows
        (64, 8, 5, 1, 400, (1,)),  # m*R = 256: the largest halo the tile takes
        (128, 4, 1, 2, 400, (2, 2)),
        (128, 3, 2, 0, 131, (2,)),
        (512, 4, 1, 2, 150, (3,)),  # tiles of 40 rows
        (512, 4, 0, 2, 77, (2,)),
        (512, 5, 3, 2, 120, (1,)),  # m*R = 40: the largest halo the tile takes
        (512, 2, 2, 1, 41, (2,)),
        (1024, 4, 1, 2, 150, (3,)),  # tiles of 48 rows
        (1024, 4, 3, 2, 120, (9,)),  # m*R = 32, JAX's M = 1024 case
        (1024, 6, 3, 0, 90, (1,)),  # m*R = 48: the largest halo the tile takes
        (2048, 4, 1, 2, 60, (3,)),  # tiles of 24 rows
        (2048, 4, 2, 1, 50, (9,)),  # m*R = 16
        (2048, 6, 2, 2, 61, (2,)),  # m*R = 24: the largest halo the tile takes
    ],
)
def test_synthesis_kernel_other_sizes(dev, M, m, r, dct, T_in, lead):
    p = FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dct)
    rng = np.random.default_rng(T_in + M)
    Yp = torch.from_numpy((rng.standard_normal((T_in,) + lead + (M,)) * 100).astype(np.float32))
    g = rng.standard_normal(p.N).astype(np.float32) / np.sqrt(p.N)
    ref = synthesis_half_real_tm(Yp, g, p)
    before = synthesis_tm_fused.launches
    got = synthesis_tm_fused(Yp.to(dev), torch.from_numpy(g).to(dev), p)
    assert synthesis_tm_fused.launches == before + 1
    _close(got, ref, 2e-5)


def test_synthesis_tile_rows_are_the_kernels(dev):
    """`synthesis_tile_rows` (what `check_card_shapes` reads) is the tile
    K3 is built with at each M: its C entry refuses m*R = rows + 1 (a halo
    of the whole tile) and every other M (m*R = rows runs in
    `test_synthesis_kernel_other_sizes`); the wrappers raise
    `NotImplementedError` past those limits before any launch."""
    from distant_speech_recognition_tpu_torch.kernels import _build
    from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import synthesis_tile_rows

    lib = _build.library()
    for M in (32, 4096, 96, 1536):
        assert lib.dsr_synthesis_tm_rows(M) == 0
    tw = torch.zeros(1, device=dev)
    for M in (64, 128, 256, 512, 1024, 2048):
        rows = synthesis_tile_rows(M)
        assert lib.dsr_synthesis_tm_rows(M) == rows
        out = torch.empty(M, device=dev)
        args = lambda m, R, T_in: (tw.data_ptr(), tw.data_ptr(), tw.data_ptr(), out.data_ptr(),
                                   T_in, 1, M, m, R, M // R, 0, T_in, None)
        assert lib.dsr_synthesis_tm(*args(rows + 1, 1, 1)) != 0  # halo rows: the whole tile
    kernels.reset_launch_counts()
    x = torch.zeros((1, 2, 4096), device=dev)
    with pytest.raises(NotImplementedError, match="M=4096"):
        analysis_tm_fused(x, torch.zeros(16384, device=dev), FilterbankParams(M=4096, m=4, r=1))
    with pytest.raises(NotImplementedError, match="m\\*R=64"):
        synthesis_tm_fused(torch.zeros((40, 1, 512), device=dev), torch.zeros(2048, device=dev),
                           FilterbankParams(M=512, m=4, r=4))
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("C,M,B,Tf", [(2, 512, 3, 40), (8, 512, 3, 40), (2, 1024, 9, 37),
                                      (4, 1024, 3, 40), (8, 2048, 3, 23), (4, 2048, 9, 30)])
def test_steered_scan_at_257_bins(dev, C, M, B, Tf):
    """K6 at M = 512, 1024 and 2048 (F = 257, 513, 1025: the last two take
    their energies from the pre-pass) against its plain version, and with
    one steering for all equal to K2 bit for bit."""
    Yp, wqH, BmH, vs = _scan_case(C, M, seed=60 + C + M + B, B=B, Tf=Tf)
    cfg = GSCRLSConfig(min_frames=8)
    d = np.stack([geometry.calc_la_delays(np.c_[np.arange(C) * 50.0][:, :1], azimuth=az)
                  for az in np.linspace(0.4, 2.5, B)]).astype(np.float32)
    per_utt = steering_weights(array_manifold(M, FS, torch.from_numpy(d)))
    ref = gsc_rls_zelinski_steered(Yp, *per_utt, cfg, 0.6, 1, 2)
    Yd = Yp.to(dev)
    _close(gsc_rls_zelinski_steered(Yd, *(w.to(dev) for w in per_utt), cfg, 0.6, 1, 2), ref, 2e-4)
    shared = [w.to(dev) for w in (wqH, BmH, vs)]
    rows = [w.expand((B,) + w.shape) for w in shared]
    assert torch.equal(gsc_rls_zelinski_steered(Yd, *rows, cfg, 0.6, 2, 0),
                       gsc_rls_zelinski(Yd, *shared, cfg, 0.6, 2, 0))


@pytest.mark.parametrize("C,B,Tf", [(2, 1, 45), (4, 9, 37), (8, 3, 30)])
@pytest.mark.parametrize("M", [1024, 2048])
def test_rls_scan_at_1024_and_2048(dev, C, B, Tf, M):
    """K2 at F = 513 and 1025 against its plain version (2e-4), at one and
    nine utterances and a frame count that is no multiple of a chunk: the
    pre-pass's energies, each block's staged bins of every channel."""
    Yp, wqH, BmH, vs = _scan_case(C, M, seed=80 + C + M + B, B=max(B, 3), Tf=Tf)
    _scan_vs_plain(dev, Yp[:, :B].contiguous(), wqH, BmH, vs, GSCRLSConfig(min_frames=8),
                   1 + C % 2, 2)


@pytest.mark.parametrize("M", [64, 512, 1024, 2048])
@pytest.mark.parametrize("C", [2, 8])
def test_fixed_weight_and_postfilter_kernels_at_other_sizes(dev, M, C):
    """K7 (3e-5) and the McCowan postfilter kernel, given the beamformer's
    output and forming wqH X (1e-4), at M = 64, 512, 1024 and 2048."""
    from distant_speech_recognition_tpu_torch.models.coherence_postfilter import (
        coherence_postfilter,
    )

    rng = np.random.default_rng(M + C)
    Yp = _packed(rng, 43, 3, C, M)
    Yp[:, 1] = 0.0
    wqH, vs = _fixed_weights(C, M)
    ref = zelinski_apply(Yp, wqH, vs, 0.6, 1, 2)
    _close(zelinski_apply(Yp.to(dev), wqH.to(dev), vs.to(dev), 0.6, 1, 2), ref, 3e-5)
    Yr, Yb, wqH, vs, consts = _coherence_case(C, "mccowan", 2, M=M)
    for given in (Yb, None):
        ref = coherence_postfilter(Yr, given, wqH, vs, "mccowan", consts, 0.6, 2, 2)
        got = coherence_postfilter(Yr.to(dev), None if given is None else given.to(dev),
                                   wqH.to(dev), vs.to(dev), "mccowan", consts.to(dev), 0.6, 2, 2)
        _close_nan(got, ref, 1e-4)


# the card pipelines at the other sizes: name -> (M, C, configuration
# fields, launches of one forward)
SIZE_PIPES = {
    "config1-m64": (64, 2, dict(beamformer="ds", postfilter="none"),
                    dict(analysis_tm=1, synthesis_tm=1)),
    "flagship-m128": (128, 4, dict(beamformer="gsc_rls", postfilter="zelinski"),
                      dict(analysis_tm=1, gsc_rls_zelinski=1, synthesis_tm=1)),
    "flagship-m512": (512, 4, dict(beamformer="gsc_rls", postfilter="zelinski"),
                      dict(analysis_tm=1, gsc_rls_zelinski=1, synthesis_tm=1)),
    "config3-m512": (512, 8, dict(beamformer="gsc_lms", postfilter="zelinski"),
                     dict(analysis_tm=1, lms_gates=1, gsc_lms_zelinski=1, synthesis_tm=1)),
    "ds-zelinski-m512": (512, 4, dict(beamformer="ds", postfilter="zelinski"),
                         dict(analysis_tm=1, zelinski_apply=1, synthesis_tm=1)),
    "mccowan-m64": (64, 4, dict(beamformer="gsc_rls", postfilter="mccowan"),
                    dict(analysis_tm=1, gsc_rls_zelinski=1, coherence_postfilter=1,
                         synthesis_tm=1)),
    "config4-m64": (64, 4, dict(beamformer="gsc_rls", postfilter="zelinski", aec="nlms",
                                wpe=True, wpe_iterations=2),
                    dict(analysis_tm=2, aec_scan=1, wpe_stats=2, gj_solve=2, wpe_resid=1,
                         gsc_rls_zelinski=1, synthesis_tm=1)),
    "config4-m512": (512, 4, dict(beamformer="gsc_rls", postfilter="zelinski", aec="nlms",
                                  wpe=True, wpe_iterations=2),
                     dict(analysis_tm=2, aec_scan=1, wpe_stats=2, gj_solve=2, wpe_resid=1,
                          gsc_rls_zelinski=1, synthesis_tm=1)),
    "flagship-m2048": (2048, 4, dict(beamformer="gsc_rls", postfilter="zelinski"),
                       dict(analysis_tm=1, gsc_rls_zelinski=1, synthesis_tm=1)),
    "config3-m2048": (2048, 8, dict(beamformer="gsc_lms", postfilter="zelinski"),
                      dict(analysis_tm=1, lms_gates=1, gsc_lms_zelinski=1, synthesis_tm=1)),
    "ds-zelinski-m1024": (1024, 2, dict(beamformer="ds", postfilter="zelinski"),
                          dict(analysis_tm=1, zelinski_apply=1, synthesis_tm=1)),
    "mccowan-m2048": (2048, 4, dict(beamformer="ds", postfilter="mccowan"),
                      dict(analysis_tm=1, coherence_postfilter=1, synthesis_tm=1)),
    "config4-m1024": (1024, 4, dict(beamformer="gsc_lms", postfilter="zelinski", aec="nlms",
                                    wpe=True, wpe_iterations=2),
                      dict(analysis_tm=2, aec_scan=1, wpe_stats=2, gj_solve=2, wpe_resid=1,
                           lms_gates=1, gsc_lms_zelinski=1, synthesis_tm=1)),
    "config4-m2048": (2048, 4, dict(beamformer="gsc_rls", postfilter="zelinski", aec="nlms",
                                    wpe=True, wpe_iterations=2),
                      dict(analysis_tm=2, aec_scan=1, wpe_stats=2, gj_solve=2, wpe_resid=1,
                           gsc_rls_zelinski=1, synthesis_tm=1)),
}


@pytest.mark.parametrize("name", list(SIZE_PIPES))
def test_pipelines_at_other_sizes_match_plain(dev, name):
    """`build_pipeline` with the default device at M = 64, 128, 512, 1024
    and 2048
    (the one-kernel chains K4/K8 take M = 256 only, so the split routes run)
    against the same module on the CPU (3e-4), with exactly the route's
    launches."""
    M, C, kw, launches = SIZE_PIPES[name]
    fb = FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, pf_min_frames=2, rls=GSCRLSConfig(min_frames=4),
                         lms=GSCLMSConfig(min_frames=4, slowdown_after=8), **kw)
    rng = np.random.default_rng(M + C)
    h = rng.standard_normal(fb.N).astype(np.float32) / 32
    g = rng.standard_normal(fb.N).astype(np.float32) / 32
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    x = torch.from_numpy((rng.standard_normal((2, C, 40 * M)) * 1500).astype(np.float32))
    args = (x,)
    if cfg.aec != "none":
        args += (torch.from_numpy((rng.standard_normal((2, 40 * M)) * 1500).astype(np.float32)),)
    cpu = build_pipeline(cfg, mpos, _delays(C), h, g, device="cpu")
    gpu = build_pipeline(cfg, mpos, _delays(C), h, g)
    with torch.no_grad():
        ref = cpu(*args)
        kernels.reset_launch_counts()
        got = gpu(*(a.to(dev) for a in args))
    assert kernels.launch_counts() == _only(**launches)
    _close(got, ref, 3e-4)


@pytest.mark.parametrize("M", [512, 1024, 2048])
def test_steered_pipeline_at_512_matches_plain(dev, M):
    """Config 5 at M = 512, 1024 and 2048: K1, K6, K3 once each, the DOA
    equal to the CPU module's and at the placed directions (designed
    prototypes; above 512 the stored ones)."""
    fb = FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2)
    cfg = PipelineConfig(fb=fb, samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                         pf_min_frames=2, rls=GSCRLSConfig(min_frames=4))
    rng = np.random.default_rng(M)
    h, g = load_pair(M, 4, 1, proto_dir=PROTO_DIR if M > 512 else None)
    ang = 2 * np.pi * np.arange(4) / 4
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(4)]
    phis = np.deg2rad(np.arange(0.0, 360.0, 30.0))
    placed = [2, 5, 9]
    T = 16000
    src = rng.standard_normal((3, T + 64)).astype(np.float32) * 1500
    x = rng.standard_normal((3, 4, T)).astype(np.float32) * 150
    for b, gi in enumerate(placed):
        d = geometry.calc_ca_delays(mpos, phis[gi], np.pi / 2)
        for c in range(4):
            off = 8 - int(round(float(d[c]) * FS))
            x[b, c] += src[b, off:off + T]
    x = torch.from_numpy(x)
    cpu = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis, device="cpu")
    gpu = build_steered_pipeline(cfg, mpos, h, g, [np.pi / 2], phis)
    with torch.no_grad():
        ref, doa_ref = cpu(x)
        kernels.reset_launch_counts()
        got, doa = gpu(x.to(dev))
    assert kernels.launch_counts() == _only(analysis_tm=1, gsc_rls_zelinski_steered=1,
                                            synthesis_tm=1)
    assert torch.equal(doa.cpu(), doa_ref)
    assert torch.equal(doa_ref[:, 1], torch.tensor(phis[placed], dtype=torch.float32))
    _close(got, ref, 3e-4)


FILTERBANK_STORED = ("k1_c4", "k1_c3_r2", "k3", "k3_r2", "k4_c2", "k4_c4", "k5_c4", "k8_c4")


@pytest.mark.parametrize("tag", FILTERBANK_STORED)
def test_filterbank_kernels_equal_stored_outputs(dev, tag):
    """K1, K3, K4/K5 and K8 at M = 256 give, bit for bit, the outputs their
    kernels gave before the FFT plan took M = 64, 128 and 512
    (``filterbank_case_m256.npz``, from ``tests/probe_filterbank_bits.py
    --root`` of that checkout with ``--write-case``; its cases and inputs are
    the probe's)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_filterbank_bits", Path(__file__).parent / "probe_filterbank_bits.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    z = np.load(Path(__file__).parent / "data" / "filterbank_case_m256.npz")
    _, kernel, B, n, kw = next(c for c in probe.CASES if c[0] == tag)
    fb = FilterbankParams(**{"M": 256, "m": 4, **kw})
    w = None
    if kernel in ("K4", "K5", "K8"):
        w = [torch.from_numpy(z[f"{tag}_{k}"]).to(dev) for k in ("wqH", "BmH", "vs")]
    h, g = (torch.from_numpy(z[k]).to(dev) for k in ("h", "g"))
    inp = torch.from_numpy(probe.case_input(tag, kernel, B, n)).to(dev)
    got = probe.run(probe._build.library(), kernel, inp, fb, h, g, w)
    assert torch.equal(got.cpu(), torch.from_numpy(z[f"{tag}_out"]))


# K7 at the edges of its launch: one (utterance, bin) lane, 32 a block, its
# frames staged ahead in a ring of `frames` slots, two frames a group; the
# shapes: (B, Tf, M), Tf given as an int or as an offset from the ring's
# depth at that launch ("ring-1", "ring+1")
K7_EDGES = ((1, 1, 64), (1, 1254, 512), (64, 2, 128), (64, "ring-1", 512), (64, "ring+1", 64),
            (64, 1254, 64), (257, 1, 128), (257, "ring+1", 512), (257, "ring-1", 128),
            (257, 2, 64), (1, "ring+1", 2048), (9, 37, 1024), (9, "ring-1", 2048))


@pytest.mark.parametrize("C", range(2, 9))
@pytest.mark.parametrize("per_utt", [False, True])
def test_zelinski_apply_kernel_edges(dev, C, per_utt):
    """K7 with one set of weights, or one steering per utterance, against
    its plain version (3e-5 x max|ref|) at B = 1, 64 and 257 (a partial last
    block), Tf = 1, 2, one frame fewer and one more than its ring, and 1254
    (config 5's), M = 64, 128 and 512, both Zelinski modes with the gain
    from frame 3 and never, an utterance digitally silent; given one
    steering for all, the per-utterance entry equals the shared one bit for
    bit."""
    rng = np.random.default_rng(700 + C + 10 * per_utt)
    fn = zelinski_apply_steered if per_utt else zelinski_apply
    for k, (B, Tf, M) in enumerate(K7_EDGES):
        ring = fixed_weight.zelinski_launch_shape(B, C, M)["frames"]
        Tf = ring + int(Tf[4:]) if isinstance(Tf, str) else Tf
        Yp = _packed(rng, Tf, B, C, M)
        silent = B // 2 if B > 1 else None
        if silent is not None:
            Yp[:, silent] = 0.0
        if per_utt:
            mpos = np.c_[100.0 * np.cos(2 * np.pi * np.arange(C) / C),
                         100.0 * np.sin(2 * np.pi * np.arange(C) / C), np.zeros(C)]
            d = np.stack([geometry.calc_ca_delays(mpos, az, np.pi / 2)
                          for az in np.linspace(0.3, 5.9, B)]).astype(np.float32)
            ta = array_manifold(M, FS, torch.from_numpy(d))
            wq = torch.conj(ta).resolve_conj()
        else:
            wq, ta = _fixed_weights(C, M)
        pf_type = 1 + k % 2
        Yd, w = Yp.to(dev), (wq.to(dev), ta.to(dev))
        for pf_min in (2, NO_POSTFILTER):
            ref = fn(Yp, wq, ta, 0.6, pf_type, pf_min)
            before = fn.launches
            got = fn(Yd, *w, 0.6, pf_type, pf_min)
            assert fn.launches == before + 1
            _close(got, ref, 3e-5)
            assert silent is None or not got[:, silent].any()
        if per_utt:
            wqs, tas = _fixed_weights(C, M)
            shared = [t.to(dev) for t in (wqs, tas)]
            rows = [t.expand((B,) + t.shape) for t in shared]
            assert torch.equal(zelinski_apply_steered(Yd, *rows, 0.6, pf_type, 2),
                               zelinski_apply(Yd, *shared, 0.6, pf_type, 2)), (B, Tf, M)


@pytest.mark.parametrize("C", range(2, 9))
def test_zelinski_apply_launch_shape(dev, C):
    """K7's launch against what the card reports: a block a warp of 32 bins
    of one utterance (M/64 + 1 blocks an utterance, the last the Nyquist
    bin alone), no spill, a ring of 8 to 32 frames that the blocks an SM
    must hold fit beside each other; at config 5's B = 64 the grid covers
    every SM with the deepest ring, and at B = 64 and 256 every block is
    resident at once; an M that is no multiple of 64 is refused."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for B, M in ((64, 256), (256, 256), (1, 256), (64, 64), (257, 512), (1536, 256)):
        sh = fixed_weight.zelinski_launch_shape(B, C, M)
        assert sh["threads"] == 32 and sh["blocks"] == B * (M // 64 + 1), sh
        assert sh["local_bytes"] == 0 and sh["registers"] <= 255, sh
        assert sh["frames"] in (8, 16, 32) and sh["smem_bytes"] == 256 * C * sh["frames"], sh
        assert sh["blocks_per_sm"] >= 1, sh
        if B in (64, 256) and M == 256:
            assert -(-sh["blocks"] // sms) <= sh["blocks_per_sm"], (B, sh)
        if B == 64 and M == 256:
            assert sh["blocks"] >= sms and sh["frames"] == 32, sh
    Yp = torch.zeros((3, 2, C, 96), device=dev)
    w = torch.zeros((49, C), dtype=torch.complex64, device=dev)
    with pytest.raises(RuntimeError, match="zelinski_apply"):
        zelinski_apply(Yp, w, w)


K7_STORED = [(form, C, M) for form in ("shared", "steered") for C in (2, 4, 8) for M in (64, 256)]


@pytest.mark.parametrize("form,C,M", K7_STORED)
def test_zelinski_apply_equals_stored_outputs(dev, form, C, M):
    """K7's two entries give, bit for bit, the outputs stored from the
    first design's kernel by ``tests/probe_zelinski_apply_phases.py --root
    <that checkout> --write-case`` (``tests/data/zelinski_apply_case.npz``):
    the SHA-256 of each output's bytes in the real and the modulus mode with
    the gain from frame 1, from frame 3 and never, and the whole output at M
    = 64 in the real mode from frame 3; the probe makes the inputs (hash
    noise, B = 3 with one utterance digitally silent, Tf = 37)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "probe_zelinski_apply_phases", Path(__file__).parent / "probe_zelinski_apply_phases.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    z = np.load(Path(__file__).parent / "data" / "zelinski_apply_case.npz")
    tag = probe.case_tag(form, C, M)
    w = [torch.from_numpy(z[f"{tag}_{k}"]).to(dev) for k in ("wq", "ta")]
    Yp = torch.from_numpy(probe.case_input(form, C, M)).to(dev)
    fn = zelinski_apply if form == "shared" else zelinski_apply_steered
    for pf_type, pf_min in probe.CASE_PF:
        key = f"{tag}_p{pf_type}_{min(pf_min, probe.CASE_TF)}"
        got = fn(Yp, *w, 0.6, pf_type, pf_min)
        if f"{key}_out" in z:
            ref = torch.from_numpy(z[f"{key}_out"])
            assert torch.equal(got.cpu().view(torch.int32), ref.view(torch.int32)), (
                key, (got.cpu() - ref).abs().max().item())
        assert probe.digest(got) == str(z[f"{key}_sha256"]), key
