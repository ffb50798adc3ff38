"""The PyTorch port's full-band filterbanks and strided FIR against the JAX
package.

- `ops.filterbank.analysis`, `analysis_half`, `synthesis`, `synthesis_half`
  and `hermitian_mirror` against JAX's on `tests/test_filterbank.py`'s small
  configurations, at 5e-5 (analysis, the stream golden's budget there) and
  2e-4 x max|ref| (synthesis).
- `ops.filterbank.polyphase_fir_plain` (the plain version of the K13
  kernel) against JAX `polyphase_fir` in interpret mode, at M <= 16 and
  <= 64 rows (interpret mode is slow).
- `ops.filterbank_kernels.analysis_polyphase` / `synthesis_polyphase` on CPU
  tensors (the plain FIR, no launch) against JAX `analysis_pallas` /
  `synthesis_pallas` (interpret mode) at the JAX tests' shapes
  (tests/test_filterbank.py::test_pallas_analysis_matches_xla,
  test_pallas_analysis_batched, test_synthesis_pallas_matches_xla), atol
  2e-5 / 2e-4 as there.

The JAX references of each test run under one `jax.jit`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distant_speech_recognition_tpu.ops import filterbank as j_fb
from distant_speech_recognition_tpu.ops.pallas_kernels import polyphase_fir as j_polyphase_fir
from distant_speech_recognition_tpu_torch import kernels
from distant_speech_recognition_tpu_torch.ops import filterbank as t_fb
from distant_speech_recognition_tpu_torch.ops.filterbank_kernels import (
    analysis_polyphase,
    polyphase_fir,
    synthesis_polyphase,
)

# (M, m, r, delay_compensation_type), as tests/test_filterbank.py
CONFIGS = [(8, 4, 1, 2), (8, 2, 0, 2), (16, 4, 2, 2), (8, 4, 1, 1), (8, 4, 1, 0)]


def _params(M, m, r, dc):
    return (j_fb.FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc),
            t_fb.FilterbankParams(M=M, m=m, r=r, delay_compensation_type=dc))


def _close(got: torch.Tensor, want, rel: float) -> None:
    """Max abs error within ``rel`` x max|want| (complex: per part)."""
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if np.iscomplexobj(want):
        got, want = np.stack([got.real, got.imag], -1), np.stack([want.real, want.imag], -1)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * np.abs(want).max())


def _full_band_case(M, m, r, dc):
    rng = np.random.default_rng(M * 1000 + m * 100 + r * 10 + dc)
    jp, _ = _params(M, m, r, dc)
    h = (rng.standard_normal(M * m) * 0.1).astype(np.float32)
    x = rng.standard_normal(jp.D * 13 + 5).astype(np.float32)  # partial final block
    Y = (rng.standard_normal((23, M)) + 1j * rng.standard_normal((23, M))).astype(np.complex64)
    return h, x, Y


@pytest.fixture(scope="module")
def full_band_refs():
    """JAX's analysis, analysis_half, synthesis, synthesis_half and
    hermitian_mirror for every configuration, traced and compiled as one
    function."""
    cases = [_full_band_case(*c) for c in CONFIGS]

    @jax.jit
    def ref(cases):
        out = []
        for (M, m, r, dc), (h, x, Y) in zip(CONFIGS, cases):
            jp, _ = _params(M, m, r, dc)
            F = M // 2 + 1
            out.append((j_fb.analysis(x, h, jp), j_fb.analysis_half(x, h, jp),
                        j_fb.synthesis(Y, h, jp), j_fb.synthesis_half(Y[..., :F], h, jp),
                        j_fb.hermitian_mirror(Y[..., :F], M)))
        return out

    return dict(zip(CONFIGS, zip(cases, ref(cases))))


@pytest.mark.parametrize("M,m,r,dc", CONFIGS)
def test_full_band_banks_match_jax(full_band_refs, M, m, r, dc):
    _, tp = _params(M, m, r, dc)
    F = M // 2 + 1
    (h, x, Y), (a, ah, s, sh, mirror) = full_band_refs[(M, m, r, dc)]
    xt, Yt = torch.from_numpy(x), torch.from_numpy(Y)
    _close(t_fb.analysis(xt, h, tp), a, 5e-5)
    _close(t_fb.analysis_half(xt, h, tp), ah, 5e-5)
    _close(t_fb.synthesis(Yt, h, tp), s, 2e-4)
    _close(t_fb.synthesis_half(Yt[..., :F], h, tp), sh, 2e-4)
    np.testing.assert_array_equal(t_fb.hermitian_mirror(Yt[..., :F], M).numpy(), np.asarray(mirror))


@pytest.mark.parametrize("M,m,R,rows", [(16, 4, 2, 64), (16, 3, 4, 50)])
def test_polyphase_fir_plain_matches_jax_kernel(rng, M, m, R, rows):
    S = rng.standard_normal((rows, M)).astype(np.float32)
    h = rng.standard_normal((m, M)).astype(np.float32)
    want = j_polyphase_fir(jnp.asarray(S), jnp.asarray(h), m, R, interpret=True)
    kernels.reset_launch_counts()
    got = polyphase_fir(torch.from_numpy(S), torch.from_numpy(h), m, R)
    assert kernels.launch_counts()["polyphase_fir"] == 0
    torch.testing.assert_close(got, t_fb.polyphase_fir_plain(torch.from_numpy(S), h, m, R),
                               rtol=0, atol=0)
    _close(got, want, 2e-6)


ANALYSIS_PALLAS_CASES = [
    (8, 4, 1, 2, (), 4 * 23 + 7),
    (16, 2, 0, 1, (), 16 * 23 + 7),
    (8, 4, 2, 0, (), 2 * 23 + 7),
    (8, 4, 1, 2, (2, 3), 300),  # batched
]


@pytest.fixture(scope="module")
def analysis_pallas_refs():
    """JAX ``analysis_pallas`` (interpret mode) on every case, traced and
    compiled as one function."""
    rng = np.random.default_rng(7)
    cases = [((rng.standard_normal(M * m) * 0.1).astype(np.float32),
              rng.standard_normal(lead + (T,)).astype(np.float32))
             for M, m, r, dc, lead, T in ANALYSIS_PALLAS_CASES]

    @jax.jit
    def ref(cases):
        return [j_fb.analysis_pallas(x, h, _params(*c[:4])[0], interpret=True)
                for c, (h, x) in zip(ANALYSIS_PALLAS_CASES, cases)]

    return dict(zip(ANALYSIS_PALLAS_CASES, zip(cases, ref(cases))))


@pytest.mark.parametrize("case", ANALYSIS_PALLAS_CASES)
def test_analysis_polyphase_matches_jax_pallas(analysis_pallas_refs, case):
    _, tp = _params(*case[:4])
    (h, x), want = analysis_pallas_refs[case]
    got = analysis_polyphase(torch.from_numpy(x), h, tp)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_synthesis_polyphase_matches_jax_pallas():
    jp, tp = _params(128, 4, 1, 2)
    rng = np.random.default_rng(2)
    g = rng.standard_normal(jp.N).astype(np.float32) * 0.1
    Y = (rng.standard_normal((40, 128)) + 1j * rng.standard_normal((40, 128))).astype(np.complex64)
    want = jax.jit(lambda Y, g: j_fb.synthesis_pallas(Y, g, jp, interpret=True))(Y, g)
    got = synthesis_polyphase(torch.from_numpy(Y), g, tp)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
