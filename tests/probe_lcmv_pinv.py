"""The LCMV pseudo-inverse's eigenvalue floor, measured on the CPU.

For the LCMV constraint Grams of two geometries (the bench array, linear
50 mm, target at pi/3 and one jammer at 2 pi/3; a circular array of radius
100 mm, target at pi/3 and jammer at 2.4 rad) at C = 2..8 channels, the
script prints:

- the smallest eigenvalue of each Gram relative to its largest, at the
  two bins where it is smallest, as the port gives it (its float32 Gram and
  ``eigh``), as a float64 ``eigh`` of that float32 Gram gives it, and as
  the JAX package gives it (its own float32 Gram and ``eigh``): the
  rounding level that ``models/beamforming.PINV_EPS_FACTOR`` must stay
  above, and the smallest eigenvalue that is signal, which it must stay
  below; also for a third geometry, the circular array with the jammer at
  2 pi/3, the mirror image of the target, where the manifolds coincide
  exactly at some bins;
- the port's `build_pipeline(beamformer="lcmv", device="cpu")` against JAX
  `build_pipeline` on the same batch (B=2 x 8000 samples of int16-scale
  noise, M=256, m=4, r=1, Zelinski, pf_min_frames=2), as max|err| /
  max|ref|, and SD-MVDR at C = 8, which shares the pseudo-inverse.

    python3 tests/probe_lcmv_pinv.py

Runs on the CPU in about a minute (one JAX pipeline compile per case).
"""

from __future__ import annotations

import sys
from pathlib import Path

import jax
import numpy as np
import torch

jax.config.update("jax_platforms", "cpu")

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax.numpy as jnp  # noqa: E402

from distant_speech_recognition_tpu.models import beamforming as j_bf  # noqa: E402
from distant_speech_recognition_tpu.models import pipeline as j_pipe  # noqa: E402
from distant_speech_recognition_tpu.ops.filterbank import FilterbankParams as JParams  # noqa: E402
from distant_speech_recognition_tpu.utils import geometry  # noqa: E402
from distant_speech_recognition_tpu_torch.design.nyquist import design_nyquist_pair  # noqa: E402
from distant_speech_recognition_tpu_torch.models import beamforming as t_bf  # noqa: E402
from distant_speech_recognition_tpu_torch.models import pipeline as t_pipe  # noqa: E402
from distant_speech_recognition_tpu_torch.ops.filterbank import FilterbankParams  # noqa: E402

M, FS = 256, 16000.0
EPS32 = float(np.finfo(np.float32).eps)


def geometry_of(kind: str, n_chan: int):
    """Mic positions (mm), target delays and jammer delays."""
    if kind == "linear":
        mpos = np.c_[np.arange(n_chan) * 50.0, np.zeros((n_chan, 2))]
        return (mpos, geometry.calc_la_delays(mpos[:, :1], azimuth=np.pi / 3),
                geometry.calc_la_delays(mpos[:, :1], azimuth=2 * np.pi / 3))
    ang = 2 * np.pi * np.arange(n_chan) / n_chan
    mpos = np.c_[100.0 * np.cos(ang), 100.0 * np.sin(ang), np.zeros(n_chan)]
    jam = 2 * np.pi / 3 if kind == "circular, mirror jammer" else 2.4
    return (mpos, geometry.calc_ca_delays(mpos, np.pi / 3, np.pi / 2),
            geometry.calc_ca_delays(mpos, jam, np.pi / 2))


def eigen_ratios(dt, dj) -> str:
    """The two smallest smallest-to-largest eigenvalue ratios over the bins
    >= 1 (port, float64 of the port's Gram, JAX)."""
    cons = torch.stack([t_bf.array_manifold(M, FS, d) for d in (dt, dj)], dim=1)
    gram = torch.conj(cons) @ cons.transpose(-1, -2)
    w32 = torch.linalg.eigvalsh(gram)
    w64 = torch.linalg.eigvalsh(gram.to(torch.complex128))
    jc = jnp.stack([j_bf.array_manifold(M, FS, d) for d in (dt, dj)], axis=1)
    wj = np.asarray(jnp.linalg.eigh(jnp.conj(jc) @ jnp.swapaxes(jc, -1, -2))[0])
    r32 = (w32[:, 0].abs() / w32[:, 1]).numpy()
    r64 = (w64[:, 0].abs() / w64[:, 1]).numpy()
    rj = np.abs(wj[:, 0]) / wj[:, 1]
    order = np.argsort(np.minimum(r32, rj)[1:])[:2] + 1
    return "; ".join(f"bin {f}: port {r32[f]:.3g}, float64 {r64[f]:.3g}, JAX {rj[f]:.3g}"
                     for f in order)


def pipeline_error(kind: str, beamformer: str, n_chan: int, h, g) -> float:
    mpos, dt, dj = geometry_of(kind, n_chan)
    x = (np.random.default_rng(0).standard_normal((2, n_chan, 8000)) * 1500.0).astype(np.float32)
    common = dict(samplerate=FS, beamformer=beamformer, postfilter="zelinski", pf_min_frames=2)
    jcfg = j_pipe.PipelineConfig(fb=JParams(M=M, m=4, r=1, delay_compensation_type=2), **common)
    ref = np.asarray(j_pipe.build_pipeline(jcfg, mpos, dt, h, g, noise_delays=[dj])(x))
    tcfg = t_pipe.PipelineConfig(fb=FilterbankParams(M=M, m=4, r=1, delay_compensation_type=2),
                                 **common)
    enh = t_pipe.build_pipeline(tcfg, mpos, dt, h, g, noise_delays=[dj], device="cpu")
    with torch.no_grad():
        got = enh(torch.from_numpy(x)).numpy()
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def main() -> None:
    h, g = design_nyquist_pair(M, 4, 1)
    print(f"PINV_EPS_FACTOR {t_bf.PINV_EPS_FACTOR} x eps32 = "
          f"{t_bf.PINV_EPS_FACTOR * EPS32:.3g} x lambda_max")
    for kind in ("linear", "circular"):
        for n_chan in range(2, 9):
            _, dt, dj = geometry_of(kind, n_chan)
            err = pipeline_error(kind, "lcmv", n_chan, h, g)
            print(f"{kind} C={n_chan}: LCMV pipeline port vs JAX {err:.3g} x max|ref|; "
                  f"smallest eigenvalue / largest: {eigen_ratios(dt, dj)}", flush=True)
    for n_chan in range(2, 9):
        _, dt, dj = geometry_of("circular, mirror jammer", n_chan)
        print(f"circular, mirror jammer C={n_chan}: smallest eigenvalue / largest: "
              f"{eigen_ratios(dt, dj)}", flush=True)
    print(f"linear C=8: SD-MVDR pipeline port vs JAX "
          f"{pipeline_error('linear', 'sd_mvdr', 8, h, g):.3g} x max|ref|")


if __name__ == "__main__":
    main()
