"""The port's GSC-LMS (BASELINE config 3), its standalone GSC-RLS and the
``postfilter="none"`` pipelines against the JAX package, on the CPU.

- `adaptive_gsc.gsc_lms` against JAX `gsc_lms` on complex snapshots with the
  frame energies passed in, at C = 4 and 8 (M = 32, 200 frames), with the
  final state; the case halves the step size (``slowdown_after=16``), adapts
  from frame 10, opens with silent frames (the gate stays shut) and caps the
  weights' norm (``max_wa_l2norm`` small).  Budget 2e-4 x max|ref|, the JAX
  package's Pallas-vs-XLA scan budget; the float64 transliteration
  ``tests/reference_beamform.gsc_lms_ref`` is a third check at 1e-3 (float32
  against float64 over 200 adapted frames).
- `adaptive_gsc.gsc_rls` and `rls_init_state` against JAX, the same way.
- `gsc_postfilter_fused(kind="lms", real_packed=True, energy=None)` and its
  CUDA wrapper `fused_scan.gsc_lms_zelinski` on CPU tensors against JAX,
  both Zelinski modes.
- `adaptive_gsc.lms_silence_gates` and its CUDA wrapper `fused_scan.lms_gates`
  on CPU tensors against the gates of JAX's LMS step (the smoothed energy
  its state carries into each frame), exactly.
- The two forms the CUDA LMS scan takes of the Zelinski pair sum
  sum_{i<j} a_i conj(a_j), at C = 2..8: its real part as (|sum a|^2 - sum
  |a|^2) / 2, and the whole as the prefix sums of two halves of the channels
  joined by A_lo conj(A_hi); against the pairwise sum in float64 (1e-12 of
  sum |a|^2), the real part also in float32 (8 C eps32 of it).
- `build_pipeline` / `from_jax_params` against JAX `build_pipeline` for
  ``gsc_lms`` + ``zelinski`` at C = 8, ``gsc_lms`` / ``gsc_rls`` / ``ds`` +
  ``none`` at C = 4, and ``gsc_lms`` after the NLMS echo canceller and WPE
  (config 4's chain) at C = 4: B = 2 x 2000 samples, M = 256, m = 4, r = 1,
  ``min_frames=4`` so the adaptive branch runs.  Budget 3e-4 x max|ref|, the
  JAX package's one-kernel-vs-split budget
  (tests/test_pallas_fused.py::test_fused_mono_kernel_matches_split).

Each JAX reference is compiled once in the file.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from threadpoolctl import threadpool_limits
except ImportError:  # the limit only matters when test workers share the cores
    from contextlib import nullcontext as threadpool_limits

from distant_speech_recognition_tpu.models import adaptive_gsc as j_gsc
from distant_speech_recognition_tpu.models import beamforming as j_bf
from distant_speech_recognition_tpu.models import pipeline as j_pipe
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams
from distant_speech_recognition_tpu.utils import geometry
from distant_speech_recognition_tpu.utils.prototypes import load_pair
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.models import adaptive_gsc as t_gsc
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe
from distant_speech_recognition_tpu_torch.models.beamforming import frame_energy_half
from distant_speech_recognition_tpu_torch.models.fused_scan import gsc_lms_zelinski, lms_gates
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams

from reference_beamform import gsc_lms_ref

FS = 16000.0
SCAN_BUDGET = 2e-4
CHAIN_BUDGET = 3e-4
# the scan case: 200 frames of M = 32, the first 5 silent
SCAN_M, SCAN_TF, SILENT = 32, 200, 5
LMS_KW = dict(slowdown_after=16, min_frames=10, max_wa_l2norm=5e-7)


def _delays(C, azimuth=np.pi / 3):
    mpos = np.c_[np.arange(C) * 50.0, np.zeros((C, 2))]
    return mpos, geometry.calc_la_delays(mpos[:, :1], azimuth=azimuth)


def _close(got, want, budget):
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=budget * np.abs(want).max())


def _snapshots(C, batch=(), seed=0):
    """Complex snapshots [Tf, *batch, F, C] (int16-scale subband noise, the
    first frames 1e-6 down) and the reference channel's frame energies."""
    F = SCAN_M // 2 + 1
    rng = np.random.default_rng(seed)
    shape = (SCAN_TF,) + batch + (F, C)
    X = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * 100.0
    X[:SILENT] *= 1e-6
    X = X.astype(np.complex64)
    energy = frame_energy_half(torch.from_numpy(X[..., 0]), SCAN_M).numpy()
    wqH, BmH = (np.asarray(a) for a in j_gsc.gsc_weights(SCAN_M, FS, _delays(C)[1], 1))
    return X, energy, wqH, BmH


@pytest.fixture(scope="module")
def lms_cases():
    """Per C: the inputs and JAX `gsc_lms`'s output and final state."""
    cfg = j_gsc.GSCLMSConfig(**LMS_KW)
    out = {}
    for C in (4, 8):
        X, energy, wqH, BmH = _snapshots(C, seed=C)
        Y, st = j_gsc.gsc_lms(jnp.asarray(X), jnp.asarray(energy), jnp.asarray(wqH),
                              jnp.asarray(BmH), cfg)
        out[C] = (X, energy, wqH, BmH, np.asarray(Y), st)
    return out


def _port_lms(X, energy, wqH, BmH, **kw):
    return t_gsc.gsc_lms(torch.from_numpy(X), torch.from_numpy(energy), torch.from_numpy(wqH),
                         torch.from_numpy(BmH), t_gsc.GSCLMSConfig(**{**LMS_KW, **kw}))


@pytest.mark.parametrize("C", [4, 8])
def test_gsc_lms_matches_jax(lms_cases, C):
    X, energy, wqH, BmH, want, jst = lms_cases[C]
    Y, st = _port_lms(X, energy, wqH, BmH)
    _close(Y.numpy(), want, SCAN_BUDGET)
    _close(st.waH.numpy(), np.asarray(jst.waH), SCAN_BUDGET)
    np.testing.assert_allclose(st.subband_energy.numpy(), np.asarray(jst.subband_energy),
                               rtol=2e-5)
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy), rtol=1e-6)
    assert st.gamma.item() == float(jst.gamma) == np.float32(0.01) / 2 ** ((SCAN_TF - 1) // 16)
    assert st.isamp == int(jst.isamp) == SCAN_TF


@pytest.mark.parametrize("C", [4, 8])
def test_gsc_lms_exercises_gate_cap_and_slowdown(lms_cases, C):
    """What the case drives: the silent opening frames leave the state as it
    started (the gate shut; the output there is the quiescent branch's), the
    norm cap holds a fifth of the bins' weights at max_wa_l2norm after 20
    frames (before the halved step sizes let the weights shrink), and the
    float64 transliteration of pybeamformer.py agrees (1e-3 x max|ref|)."""
    X, energy, wqH, BmH, want, _ = lms_cases[C]
    _, st5 = _port_lms(X[:SILENT], energy[:SILENT], wqH, BmH)
    assert not st5.waH.abs().any()
    assert (st5.subband_energy == 1e6).all()
    _, st20 = _port_lms(X[:20], energy[:20], wqH, BmH)
    norm = (st20.waH.abs() ** 2).sum(-1).numpy()
    cap = LMS_KW["max_wa_l2norm"]
    assert (np.abs(norm - cap) < 1e-5 * cap).mean() >= 0.2
    _, st = _port_lms(X, energy, wqH, BmH)
    ref, waH = gsc_lms_ref(X.astype(np.complex128), energy.astype(np.float64),
                           wqH.astype(np.complex128), BmH.astype(np.complex128),
                           j_gsc.GSCLMSConfig(**LMS_KW))
    _close(want, ref, 1e-3)
    _close(st.waH.numpy(), waH, 1e-3)


def test_gsc_lms_batched_and_continued(lms_cases):
    """Batch axes between time and bins run each utterance as alone, and a
    run continued from a final state equals the run in one piece (1e-6 x
    max|ref|: torch's vectorised sums may round otherwise at another shape)."""
    X, energy, wqH, BmH, _, _ = lms_cases[4]
    Y1, _ = _port_lms(X, energy, wqH, BmH)
    Xb = np.stack([X, 0.5 * X], axis=1)
    Yb, _ = _port_lms(Xb, np.stack([energy, 0.25 * energy], axis=1), wqH, BmH)
    _close(Yb[:, 0].numpy(), Y1.numpy(), 1e-6)
    half = SCAN_TF // 2
    _, st = _port_lms(X[:half], energy[:half], wqH, BmH)
    Y2, _ = t_gsc.gsc_lms(torch.from_numpy(X[half:]), torch.from_numpy(energy[half:]),
                          torch.from_numpy(wqH), torch.from_numpy(BmH),
                          t_gsc.GSCLMSConfig(**LMS_KW), init_state=st)
    _close(Y2.numpy(), Y1[half:].numpy(), 1e-6)


def test_gsc_rls_and_init_state_match_jax():
    C = 4
    X, energy, wqH, BmH = _snapshots(C, seed=40)
    jcfg = j_gsc.GSCRLSConfig(min_frames=10)
    want, jst = j_gsc.gsc_rls(jnp.asarray(X), jnp.asarray(energy), jnp.asarray(wqH),
                              jnp.asarray(BmH), jcfg)
    F = SCAN_M // 2 + 1
    j0 = j_gsc.rls_init_state((2,), F, C - 1, 1e6)
    t0 = t_gsc.rls_init_state((2,), F, C - 1, 1e6)
    for a, b in zip(t0, j0):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    Y, st = t_gsc.gsc_rls(torch.from_numpy(X), torch.from_numpy(energy), torch.from_numpy(wqH),
                          torch.from_numpy(BmH), t_gsc.GSCRLSConfig(min_frames=10))
    _close(Y.numpy(), np.asarray(want), SCAN_BUDGET)
    for name in ("waH", "pz_diag", "pz_off"):
        _close(getattr(st, name).numpy(), np.asarray(getattr(jst, name)), SCAN_BUDGET)
    np.testing.assert_allclose(st.energy.numpy(), np.asarray(jst.energy), rtol=1e-6)
    assert st.isamp == int(jst.isamp) == SCAN_TF


@pytest.mark.parametrize("pf_type", [1, 2])
def test_lms_zelinski_scan_matches_jax(pf_type):
    """The packed scan with the Zelinski gain (the CUDA LMS scan's plain
    version), directly and through the wrapper on CPU tensors (no launch)."""
    C, M, Tf, B = 4, 64, 60, 3
    rng = np.random.default_rng(pf_type)
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    Yp[:4, 1] *= np.float32(1e-6)
    delays = _delays(C)[1]
    wqH, BmH = (np.asarray(a) for a in j_gsc.gsc_weights(M, FS, delays, 1))
    vs = np.asarray(j_bf.array_manifold(M, FS, delays))
    want = np.asarray(j_gsc.gsc_postfilter_fused(
        jnp.asarray(Yp), None, jnp.asarray(wqH), jnp.asarray(BmH), jnp.asarray(vs), "lms",
        j_gsc.GSCLMSConfig(**LMS_KW), 0.6, pf_type, 2, True))
    w = [torch.from_numpy(a) for a in (wqH, BmH, vs)]
    cfg = t_gsc.GSCLMSConfig(**LMS_KW)
    got = t_gsc.gsc_postfilter_fused(torch.from_numpy(Yp), None, *w, "lms", cfg, 0.6, pf_type,
                                     2, True)
    _close(got.numpy(), want, SCAN_BUDGET)
    kernels.reset_launch_counts()
    wrapped = gsc_lms_zelinski(torch.from_numpy(Yp), *w, cfg, 0.6, pf_type, 2)
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


def test_lms_silence_gates_match_jax():
    """The gates the LMS update commits on: the reference channel's frame
    energy against the smoothed energy that JAX's LMS step carries into the
    frame, over silent opening frames and a quiet stretch in one utterance;
    the CPU wrapper gives the same and launches nothing."""
    import jax

    C, M, Tf, B = 4, 64, 80, 3
    rng = np.random.default_rng(9)
    Yp = (rng.standard_normal((Tf, B, C, M)) * 100).astype(np.float32)
    Yp[:SILENT] *= np.float32(1e-6)
    Yp[40:46, 1] *= np.float32(1e-6)
    cfg = j_gsc.GSCLMSConfig(**LMS_KW)
    F = M // 2 + 1
    zero = np.zeros((Tf, B, C, 1), np.float32)
    X = jnp.asarray(np.moveaxis(Yp[..., :F] + 1j * np.concatenate([zero, Yp[..., F:], zero], -1),
                                -2, -1).astype(np.complex64))  # [Tf, B, F, C]
    energy = j_bf.frame_energy_half(X[..., 0], M)
    step = j_gsc._lms_step_factory(cfg, jnp.zeros((F, C), jnp.complex64),
                                   jnp.zeros((F, C - 1, C), jnp.complex64))
    init = j_gsc._LMSState(waH=jnp.zeros((B, F, C - 1), jnp.complex64),
                           subband_energy=jnp.full((B, F), cfg.init_diagonal_load, jnp.float32),
                           energy=jnp.full((B,), cfg.init_diagonal_load, jnp.float32),
                           gamma=jnp.asarray(cfg.gamma, jnp.float32),
                           isamp=jnp.asarray(0, jnp.int32))

    def carried(state, inputs):  # the smoothed energy each frame's gate reads
        return step(state, inputs)[0], state.energy

    _, smoothed = jax.lax.scan(carried, init, (X, energy))
    want = (np.asarray(energy) > np.asarray(smoothed) / np.float32(cfg.sil_thresh))
    got = t_gsc.lms_silence_gates(torch.from_numpy(Yp), t_gsc.GSCLMSConfig(**LMS_KW))
    assert got.dtype == torch.float32 and tuple(got.shape) == (Tf, B)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    assert want[SILENT:40].all() and not want[:SILENT].any() and not want[40:46, 1].any()
    kernels.reset_launch_counts()
    torch.testing.assert_close(lms_gates(torch.from_numpy(Yp), t_gsc.GSCLMSConfig(**LMS_KW)),
                               got, rtol=0, atol=0)
    assert set(kernels.launch_counts().values()) == {0}


@pytest.mark.parametrize("C", range(2, 9))
def test_zelinski_pair_sum_forms(C):
    """The pair sum sum_{i<j} a_i conj(a_j): its real part as (|sum a|^2 -
    sum |a|^2) / 2, and the whole as the lanes' prefix sums joined by
    A_lo conj(A_hi), against the pairwise sum in float64 (to 1e-12 of
    sum |a|^2) and, in float32, the real part within 8 C eps32 of it."""
    rng = np.random.default_rng(50 + C)
    a = rng.standard_normal((1000, C)) + 1j * rng.standard_normal((1000, C))
    pair = sum(a[:, i] * np.conj(a[:, k]) for i in range(C) for k in range(i + 1, C))
    power = (np.abs(a) ** 2).sum(-1)
    real = 0.5 * (np.abs(a.sum(-1)) ** 2 - power)
    R = (C + 1) // 2
    halves = [a[:, :R], a[:, R:]]
    prefix = 0
    for half in halves:
        s = 0
        for k in range(half.shape[1]):
            prefix = prefix + s * np.conj(half[:, k])
            s = s + half[:, k]
    prefix = prefix + halves[0].sum(-1) * np.conj(halves[1].sum(-1))
    assert np.abs(real - pair.real).max() <= 1e-12 * power.max()
    assert np.abs(prefix - pair).max() <= 1e-12 * power.max()
    a32 = a.astype(np.complex64)
    p32 = (np.abs(a32) ** 2).sum(-1, dtype=np.float32)
    real32 = np.float32(0.5) * (np.abs(a32.sum(-1)) ** 2 - p32)
    assert np.abs(real32 - pair.real).max() <= 8 * C * np.finfo(np.float32).eps * power.max()


# the pipeline configurations held to JAX: (name, C, port / JAX config fields)
PIPES = {
    "gsc_lms+zelinski C=8": (8, dict(beamformer="gsc_lms", postfilter="zelinski")),
    "gsc_lms+none": (4, dict(beamformer="gsc_lms", postfilter="none")),
    "gsc_rls+none": (4, dict(beamformer="gsc_rls", postfilter="none")),
    "ds+none": (4, dict(beamformer="ds", postfilter="none")),
    "config4 gsc_lms": (4, dict(beamformer="gsc_lms", postfilter="zelinski", aec="nlms",
                                wpe=True, wpe_iterations=1)),
}
PIPE_B, PIPE_T = 2, 2000


def _cfgs(kw):
    common = dict(samplerate=FS, pf_min_frames=2, **kw)
    jcfg = j_pipe.PipelineConfig(fb=JParams(M=256, m=4, r=1, delay_compensation_type=2),
                                 lms=j_gsc.GSCLMSConfig(min_frames=4, slowdown_after=8),
                                 rls=j_gsc.GSCRLSConfig(min_frames=4), **common)
    tcfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2),
                                 lms=t_gsc.GSCLMSConfig(min_frames=4, slowdown_after=8),
                                 rls=t_gsc.GSCRLSConfig(min_frames=4), **common)
    return jcfg, tcfg


def _pipe_refs():
    """Per configuration: the inputs, JAX `build_pipeline`'s output, the JAX
    configuration and the port's."""
    with threadpool_limits(1):
        h, g = load_pair(256, 4, 1)
    out = {}
    for name, (C, kw) in PIPES.items():
        mpos, delays = _delays(C)
        rng = np.random.default_rng(C)
        x = (rng.standard_normal((PIPE_B, C, PIPE_T)) * 1500.0).astype(np.float32)
        args = (x,)
        if kw.get("aec", "none") != "none":
            args += ((rng.standard_normal((PIPE_B, PIPE_T)) * 1500.0).astype(np.float32),)
        jcfg, tcfg = _cfgs(kw)
        ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, delays, h, g)(*args))
        out[name] = dict(h=h, g=g, mpos=mpos, delays=delays, args=args, ref=ref, jcfg=jcfg,
                         tcfg=tcfg)
    return out


@pytest.fixture(scope="module")
def pipes():
    return _pipe_refs()


def _port_pipe(p):
    enh = t_pipe.build_pipeline(p["tcfg"], p["mpos"], p["delays"], p["h"], p["g"], device="cpu")
    with torch.no_grad():
        return enh(*(torch.from_numpy(a) for a in p["args"])).numpy()


@pytest.mark.parametrize("name", list(PIPES))
def test_build_pipeline_matches_jax(pipes, name):
    kernels.reset_launch_counts()
    got = _port_pipe(pipes[name])
    assert set(kernels.launch_counts().values()) == {0}  # the CPU runs the plain versions
    _close(got, pipes[name]["ref"], CHAIN_BUDGET)


def test_from_jax_params_carries_the_lms_configuration(pipes):
    """The JAX build-time tables and its `GSCLMSConfig` reach the port: an
    `Enhancer` from them, with the port's default LMS configuration replaced
    by the JAX one, computes what JAX `build_pipeline` computes."""
    p = pipes["gsc_lms+zelinski C=8"]
    wqH, BmH = j_gsc.gsc_weights(256, FS, p["delays"], 1)
    params = dict(h=p["h"], g=p["g"], wqH=np.asarray(wqH), BmH=np.asarray(BmH),
                  wq_manifold=np.asarray(j_bf.array_manifold(256, FS, p["delays"])),
                  lms=dataclasses.asdict(p["jcfg"].lms))
    cfg = dataclasses.replace(p["tcfg"], lms=t_gsc.GSCLMSConfig())
    enh = t_pipe.from_jax_params(params, cfg, device="cpu")
    assert enh.cfg.lms == t_gsc.GSCLMSConfig(min_frames=4, slowdown_after=8)
    with torch.no_grad():
        got = enh(torch.from_numpy(p["args"][0])).numpy()
    _close(got, p["ref"], CHAIN_BUDGET)
    with pytest.raises(KeyError, match="BmH"):
        t_pipe.from_jax_params({k: v for k, v in params.items() if k != "BmH"}, cfg,
                               device="cpu")


if __name__ == "__main__":
    # the errors PERF.md records: PYTHONPATH=. python tests/test_torch_lms.py
    import jax

    jax.config.update("jax_platforms", "cpu")
    for name, p in _pipe_refs().items():
        err = np.abs(_port_pipe(p) - p["ref"]).max() / np.abs(p["ref"]).max()
        print(f"build_pipeline {name}: {err:.3g} x max|ref| (budget {CHAIN_BUDGET:g})")
