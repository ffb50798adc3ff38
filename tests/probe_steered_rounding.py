"""How far rounding carries through the steered GSC-RLS chain (config 5).

Not a test (pytest does not collect it): a measurement, run on the CPU from
the repository root with

    PYTHONPATH=. JAX_PLATFORMS=cpu python tests/probe_steered_rounding.py

The JAX package's XLA steered chain and the port's plain chain take the
same batch, B=2 utterances on a 4-mic circular array (r = 100 mm), 3 s each
(371 subband frames, so the RLS adapts from frame 128 on), one white-noise
source per utterance placed at a grid direction by per-channel sample
delays, default `GSCRLSConfig`.  Two inputs: noise-free (every channel an
exact delayed copy of the source) and with independent sensor noise 20 dB
down.  For each it prints, relative to max|y| of the JAX output:

- JAX against JAX on the input moved by one float32 ulp (``nextafter``);
- the port against JAX;

and the first output frame (D=128 samples) from which the difference
exceeds 1e-3 x max|y|.  If rounding alone decides the noise-free output once the filter
adapts, the two gaps are of one order there and small with sensor noise.
"""

from __future__ import annotations

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from distant_speech_recognition_tpu.models import pipeline as j_pipe  # noqa: E402
from distant_speech_recognition_tpu.models import steered as j_steered  # noqa: E402
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams  # noqa: E402
from distant_speech_recognition_tpu.utils.geometry import calc_ca_delays  # noqa: E402
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair  # noqa: E402
from distant_speech_recognition_tpu_torch.models import steered as t_steered  # noqa: E402
from distant_speech_recognition_tpu_torch.models.pipeline import PipelineConfig  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402

B, C, T, FS = 2, 4, 3 * 16000, 16000.0
ANG = 2 * np.pi * np.arange(C) / C
MPOS = np.c_[100.0 * np.cos(ANG), 100.0 * np.sin(ANG), np.zeros(C)]
THETAS = [np.pi / 2]
PHIS = np.deg2rad(np.arange(0.0, 360.0, 30.0))
PLACED = [1, 6]
D = 128  # samples per subband frame (M=256, r=1)


def placed_sources(rng, noise: float) -> np.ndarray:
    x = rng.standard_normal((B, C, T)).astype(np.float32) * np.float32(noise)
    src = rng.standard_normal((B, T + 64)).astype(np.float32) * np.float32(1500.0)
    for b, gi in enumerate(PLACED):
        d = calc_ca_delays(MPOS, PHIS[gi], np.pi / 2)
        for c in range(C):
            off = 8 - int(round(float(d[c]) * FS))
            x[b, c] += src[b, off:off + T]
    return x


def gap(y, ref) -> tuple[float, int | None]:
    """max|y - ref| / max|ref|, and the first frame where the difference
    exceeds 1e-3 x max|ref| (None if it never does)."""
    scale = np.abs(ref).max()
    d = np.abs(y - ref).max(axis=0)
    over = np.flatnonzero(d > 1e-3 * scale)
    return float(d.max() / scale), (int(over[0]) // D if over.size else None)


def main() -> None:
    h, g = design_nyquist_pair(256, 4, 1)
    jcfg = j_pipe.PipelineConfig(fb=JParams(M=256, m=4, r=1, delay_compensation_type=2),
                                 samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                                 pf_min_frames=2)
    jax_chain = j_steered.build_steered_pipeline(jcfg, MPOS, h, g, THETAS, PHIS)
    tcfg = PipelineConfig(fb=FilterbankParams(M=256, m=4, r=1, delay_compensation_type=2),
                          samplerate=FS, beamformer="gsc_rls", postfilter="zelinski",
                          pf_min_frames=2)
    port = t_steered.build_steered_pipeline(tcfg, MPOS, h, g, THETAS, PHIS, device="cpu")
    for name, noise in (("noise-free", 0.0), ("sensor noise 20 dB down", 150.0)):
        x = placed_sources(np.random.default_rng(0), noise)
        y, doa = (np.asarray(a) for a in jax_chain(jnp.asarray(x)))
        y_ulp, doa_ulp = (np.asarray(a) for a in jax_chain(
            jnp.asarray(np.nextafter(x, np.float32(np.inf)))))
        with torch.no_grad():
            y_port, doa_port = (a.numpy() for a in port(torch.from_numpy(x)))
        if not (np.array_equal(doa, doa_ulp) and np.array_equal(doa, doa_port)):
            raise AssertionError(f"{name}: the DOAs differ")
        for what, other in (("JAX vs JAX on x moved by one ulp", y_ulp),
                            ("port vs JAX", y_port)):
            rel, frame = gap(other, y)
            print(f"{name}: {what}: {rel:.3g} x max|y|, over 1e-3 from frame {frame}")


if __name__ == "__main__":
    main()
