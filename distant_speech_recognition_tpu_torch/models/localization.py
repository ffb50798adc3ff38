"""Source localization, plain torch: GCC-PHAT TDOA estimation, SRP-PHAT and
DSBLA DOA search, linear-array SRP and MCC.

Counterpart of the JAX package's ``models/localization.py`` (the
reference's TDOA / localization stack: lib/pytdoa.py, tde/tde.cc,
localization/localization.cc, localization/mcc_localizer.cc and the
DOAEstimatorSRPDSBLA estimator, beamformer.cc:2879-3251).  No TPU kernel
computes any of these: the SRP searches are matrix products, which
`torch.matmul` runs, and the recursions over frames are loops.  Functions
run on the device of their tensor arguments; the tables and grids
(`srp_phat_steering_table`, `linear_srp_steering_table`,
`linear_array_delay_grid`, `mcc_reference_grid`) are built on the host, and
`mcc_localize_blocks`, numpy in the JAX package too, stays numpy.
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from ..utils.geometry import SSPEED_MM_S, calc_ca_delays, calc_la_delays
from .beamforming import array_manifold

__all__ = [
    "mic_pairs",
    "gcc_phat",
    "tdoa_peaks",
    "tdoa_feature_vectors",
    "pair_tdoa_model",
    "pair_tdoa_jacobian",
    "srp_phat_steering_table",
    "srp_phat",
    "snapshot_energy",
    "srp_dsbla",
    "linear_srp_steering_table",
    "linear_srp_doa",
    "noise_spectra",
    "gcc_weighted",
    "find_cc_peak",
    "linear_array_delay_grid",
    "mcc_reference_grid",
    "mcc_localize_blocks",
    "mcc_localize",
]

# bins per matrix product: each holds the snapshot outer products of its
# bins, [frames, bins, C, C] complex, 82 MB at a config-5 batch (64 x 10 s)
SRP_BIN_CHUNK = 16


def mic_pairs(num_mics: int) -> list[tuple[int, int]]:
    """All unordered microphone pairs in the reference's order
    (make_tdoa_front_end, pytdoa.py:593-632)."""
    return list(itertools.combinations(range(num_mics), 2))


def _phat(z: torch.Tensor) -> torch.Tensor:
    """``z / |z|``, a zero left zero."""
    mag = torch.abs(z)
    return z / torch.where(mag > 0, mag, torch.ones_like(mag))


def gcc_phat(X1: torch.Tensor, X2: torch.Tensor, fftlen: int,
             energy_threshold: float = 64.0) -> torch.Tensor:
    """PHAT-weighted generalized cross-correlation per frame
    (PHATFeature.next, pytdoa.py:32-55): half-band spectra ``[..., T, F]``
    (``F = fftlen // 2 + 1``) -> time-domain GCC ``[..., T, fftlen]``, zero
    where both channels' energy ``2 sum |X|^2`` is at or below the
    threshold."""
    cc = torch.fft.irfft(_phat(X1 * torch.conj(X2)), n=fftlen, dim=-1)
    e1 = 2.0 * torch.sum(torch.abs(X1) ** 2, dim=-1)
    e2 = 2.0 * torch.sum(torch.abs(X2) ** 2, dim=-1)
    active = (e1 > energy_threshold) | (e2 > energy_threshold)
    return torch.where(active[..., None], cc, torch.zeros_like(cc))


def _lags(fftlen: int, device) -> torch.Tensor:
    """Each GCC index's lag in samples: above fftlen / 2 they wrap negative."""
    idx = torch.arange(fftlen, device=device)
    return torch.where(idx < fftlen // 2, idx, idx - fftlen)


def tdoa_peaks(cc: torch.Tensor, samplerate: float) -> tuple[torch.Tensor, torch.Tensor]:
    """The highest |CC| peak per frame of ``cc [..., T, fftlen]`` -> (delay
    in seconds, peak height) (TDOAFeature.next, pytdoa.py:87-114); an
    all-zero frame gives (0, 0)."""
    mag = torch.abs(cc)
    idx = torch.argmax(mag, dim=-1)
    height = torch.gather(mag, -1, idx[..., None])[..., 0]
    delay = _lags(cc.shape[-1], cc.device)[idx].to(torch.float32) / samplerate
    return delay, height


def tdoa_feature_vectors(delays: torch.Tensor, heights: torch.Tensor, threshold: float = 0.12,
                         minimum_pairs: int = 2):
    """Pair TDOAs gated by CC peak height and the minimum-pair requirement
    (TDOAFeatureVector.next, pytdoa.py:267-288): ``delays``/``heights``
    ``[..., T, P]`` -> ``(delays, valid [..., T, P], frame_valid [..., T])``,
    a fixed-size masked form of the reference's variable-length lists."""
    valid = heights > threshold
    frame_valid = torch.sum(valid.to(torch.int32), dim=-1) >= minimum_pairs
    return delays, valid, frame_valid


def _pair_offsets(x, mpos, pairs):
    """``x - mpos[i]`` and ``x - mpos[j]`` of each pair (i, j), float32 on
    ``x``'s device."""
    dev = x.device if isinstance(x, torch.Tensor) else None
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    mpos = torch.as_tensor(np.asarray(mpos), dtype=torch.float32, device=x.device)
    i1 = torch.tensor([p[0] for p in pairs], device=x.device)
    i2 = torch.tensor([p[1] for p in pairs], device=x.device)
    return x - mpos[i1], x - mpos[i2]


def pair_tdoa_model(x, mpos, pairs, c: float = 343000.0) -> torch.Tensor:
    """Predicted TDOA ``[P]`` of each pair for a source at ``x`` (3-vector)
    (TDOAFeatureVector.tdoa, pytdoa.py:213-227)."""
    diff1, diff2 = _pair_offsets(x, mpos, pairs)
    return (torch.linalg.vector_norm(diff1, dim=-1) - torch.linalg.vector_norm(diff2, dim=-1)) / c


def pair_tdoa_jacobian(x, mpos, pairs, c: float = 343000.0) -> torch.Tensor:
    """d tdoa / d x ``[P, 3]`` of each pair (TDOAFeatureVector.linearize,
    pytdoa.py:248-264)."""
    diff1, diff2 = _pair_offsets(x, mpos, pairs)
    D1 = torch.linalg.vector_norm(diff1, dim=-1, keepdim=True)
    D2 = torch.linalg.vector_norm(diff2, dim=-1, keepdim=True)
    return (diff1 / D1 - diff2 / D2) / c


def srp_phat_steering_table(mpos, fftlen: int, samplerate: float, thetas, phis,
                            sspeed: float = SSPEED_MM_S):
    """D&S steering table over the (theta, phi) grid of a circular array
    ``mpos [C, 3]`` (mm): ``(steering [G, F, C] complex64, grid [G, 2]
    float32)``, CPU tensors, G = len(thetas) * len(phis), theta-major."""
    mpos = np.asarray(mpos, dtype=np.float64)
    grid = np.array([(t, p) for t in np.atleast_1d(thetas) for p in np.atleast_1d(phis)])
    table = [torch.conj(array_manifold(fftlen, samplerate, calc_ca_delays(mpos, p, t, sspeed)))
             for t, p in grid]
    return torch.stack(table).resolve_conj(), torch.tensor(grid, dtype=torch.float32)


def _steered_power(X: torch.Tensor, steering: torch.Tensor, lo: int, hi: int,
                   bin_weights: torch.Tensor | None = None) -> torch.Tensor:
    """``sum_{lo <= f < hi} w_f |sum_c s_gfc x_fc|^2`` for snapshots ``X [N, F,
    C]`` and ``steering [G, F, C]`` -> ``[N, G]`` (``w_f`` = 1 without
    ``bin_weights [F]``), as a quadratic form, one real matrix product per
    chunk of `SRP_BIN_CHUNK` bins that also sums over the chunk's bins::

        |sum_c s_c x_c|^2 = sum_{c,d} Re(s_c conj(s_d)) Re(x_c conj(x_d))
                                    - Im(s_c conj(s_d)) Im(x_c conj(x_d))

    so the complex response ``[N, G, F]`` never exists."""
    G = steering.shape[0]
    out = torch.zeros(X.shape[0], G, dtype=X.real.dtype, device=X.device)
    for f0 in range(lo, hi, SRP_BIN_CHUNK):
        f1 = min(f0 + SRP_BIN_CHUNK, hi)
        x, s = X[:, f0:f1], steering[:, f0:f1]
        xx = torch.view_as_real(x[..., :, None] * torch.conj(x)[..., None, :])
        ss = s[..., :, None] * torch.conj(s)[..., None, :]
        if bin_weights is not None:
            ss = ss * bin_weights[f0:f1, None, None]
        w = torch.stack([ss.real, -ss.imag], dim=-1)  # [G, fc, C, C, 2]
        out += xx.reshape(xx.shape[0], -1) @ w.reshape(G, -1).T
    return out


def srp_phat(X: torch.Tensor, steering: torch.Tensor, min_bin: int = 0,
             max_bin: int | None = None) -> torch.Tensor:
    """Steered response power with PHAT weighting at every grid point:
    snapshots ``X [..., T, F, C]``, ``steering [G, F, C]`` -> ``[..., T, G]``,
    summed over bins ``min_bin <= f < max_bin`` (all from ``min_bin`` when
    ``max_bin`` is None).  PHAT normalizes each bin's snapshot to unit
    magnitude per channel (a zero stays zero), so every bin votes equally.
    The power is `_steered_power`'s quadratic form, bin chunk by chunk."""
    lead = X.shape[:-2]
    F, C = X.shape[-2:]
    hi = F if max_bin is None else min(max_bin, F)
    out = _steered_power(_phat(X).reshape(-1, F, C), steering, min_bin, hi)
    return out.reshape(lead + (steering.shape[0],))


def _dsbla_bin_weights(F: int, fbin_min: int, fbin_max: int, fftlen2: int,
                       device) -> torch.Tensor:
    """calc_energy's and calc_response_power_'s bin weights ``[F]``: 2 below
    ``fftlen2``, 1 from it on, 0 outside ``fbin_min <= f <= fbin_max`` (the
    reference mirrors the interior bins)."""
    bins = torch.arange(F, device=device)
    w = torch.where(bins < fftlen2, 2.0, 1.0)
    return torch.where((bins >= fbin_min) & (bins <= fbin_max), w, 0.0)


def snapshot_energy(X: torch.Tensor, fbin_min: int, fbin_max: int, fftlen2: int) -> torch.Tensor:
    """Frame energy of the SRP energy gate (calc_energy,
    beamformer.cc:3221-3251): per bin the squared total channel power
    ``|X^H X|^2``, interior bins doubled, normalized by ``2 fftlen2 C``:
    snapshots ``[..., T, F, C]`` -> ``[..., T]``."""
    C, F = X.shape[-1], X.shape[-2]
    p = torch.sum(torch.abs(X) ** 2, dim=-1)  # [..., T, F]
    w = _dsbla_bin_weights(F, fbin_min, fbin_max, fftlen2, X.device)
    return torch.sum(w * p * p, dim=-1) / (2.0 * fftlen2 * C)


def _top_k(values: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of the ``k`` largest along the last axis, ties towards the
    lower index (as ``jax.lax.top_k``)."""
    if k == 1:
        return torch.argmax(values, dim=-1, keepdim=True)  # the first maximum
    return torch.sort(values, dim=-1, descending=True, stable=True).indices[..., :k]


def srp_dsbla(X: torch.Tensor, weights: torch.Tensor, fbin_min: int = 1,
              fbin_max: int | None = None, energy_threshold: float = 0.0, n_best: int = 1):
    """The reference DOAEstimatorSRPDSBLA protocol (beamformer.cc:3125-3197):
    per frame the delay-and-sum response power of each grid direction, the
    mean over bins ``fbin_min..fbin_max`` (inclusive, default the Nyquist
    bin ``F - 1``) with interior bins doubled (calc_response_power_,
    :3093-3123), accumulated over the utterance with the frames whose
    `snapshot_energy` is below ``energy_threshold`` skipped (:3148-3155); the
    N best directions are read from the accumulated powers
    (get_nbest_hypotheses_from_accrp_, :2944-2984).

    ``X``: half-band snapshots ``[..., T, F, C]``; ``weights``: the steering
    table ``[G, F, C]`` in the wq convention (applied as ``w^H X``).  Returns
    ``(nbest_idx [..., n_best], acc_rp [..., G], frame_ok [..., T])``.  The
    powers are `_steered_power`'s quadratic form with those bin weights: the
    complex response ``[..., T, G, F]`` never exists."""
    lead = X.shape[:-2]
    F, C = X.shape[-2:]
    hi = F - 1 if fbin_max is None else fbin_max
    G = weights.shape[0]
    w = _dsbla_bin_weights(F, fbin_min, hi, F - 1, X.device)
    rp = _steered_power(X.reshape(-1, F, C), torch.conj(weights), fbin_min, min(hi + 1, F), w)
    rp = rp.reshape(lead + (G,)) / (hi - fbin_min + 1.0)  # [..., T, G]
    ok = snapshot_energy(X, fbin_min, hi, F - 1) >= energy_threshold
    acc = torch.sum(torch.where(ok[..., None], rp, torch.zeros_like(rp)), dim=-2)
    return _top_k(acc, n_best), acc, ok


def linear_srp_steering_table(mpos_x, fftlen: int, samplerate: float, base_mic: int = -1,
                              sspeed: float = SSPEED_MM_S, min_doa: float = -np.pi / 2,
                              max_doa: float = np.pi / 2):
    """Steering table over a sin(theta) grid for a linear array along x
    (LinearArraySRPDOAEstimator, lib/pylocalizer.py:33-80), with the JAX
    package's two fixes of that legacy script: the phase is physical (d /
    c) and sin(theta) covers [sin(min_doa), sin(max_doa)] with the step
    ``deltaSin = 0.99 c / (maxDist fs)``; phases relative to ``base_mic``
    (default the middle element), weights 1 / C.  Returns ``(wqH [G, F, C]
    complex64, sin_thetas [G] float32)``, CPU tensors."""
    xpos = np.asarray(mpos_x, np.float64).reshape(-1)
    C = xpos.shape[0]
    max_dist = np.abs(xpos[0] - xpos).max()
    delta_sin = 0.99 * sspeed / (max_dist * samplerate)
    lo, hi = np.sin(min_doa), np.sin(max_doa)
    sin_thetas = np.arange(lo, hi + 1e-12, min(delta_sin, hi - lo))
    if base_mic < 0:
        base_mic = C // 2
    F = fftlen // 2 + 1
    d = (xpos - xpos[base_mic]) / sspeed  # extra path length per unit sin
    d[base_mic] = 0.0
    phase = (-2j * np.pi * (samplerate / float(fftlen)) * np.arange(F)[:, None, None]
             * d[None, None, :] * sin_thetas[None, :, None])
    table = np.exp(phase) / C  # [F, G, C]
    return (torch.from_numpy(np.moveaxis(table, 0, 1).astype(np.complex64)),
            torch.from_numpy(sin_thetas.astype(np.float32)))


def linear_srp_doa(X: torch.Tensor, steering: torch.Tensor, sin_thetas: torch.Tensor,
                   min_bin: int = 1, max_bin: int | None = None):
    """DOA of a linear array by steered-response-power maximization
    (LinearArraySRPDOAEstimator.calcSRP, lib/pylocalizer.py:82-120): ``Y2[g]
    = sum_f |w_g(f)^H X(f)|^2`` over ``min_bin <= f < max_bin`` on the raw
    snapshots ``X [..., F, C]`` (no PHAT).  Returns ``(doa_radians [...],
    srp [..., G])``."""
    Y = torch.einsum("gfc,...fc->...gf", torch.conj(steering), X)
    p = torch.abs(Y) ** 2
    F = X.shape[-2]
    hi = F if max_bin is None else max_bin
    bins = torch.arange(F, device=X.device)
    srp = torch.sum(torch.where((bins >= min_bin) & (bins < hi), p, torch.zeros_like(p)), dim=-1)
    doa = torch.arcsin(torch.clamp(sin_thetas[torch.argmax(srp, dim=-1)], -1.0, 1.0))
    return doa, srp


def noise_spectra(X1: torch.Tensor, X2: torch.Tensor, noise_mask, alpha: float = 0.95):
    """Recursive noise power and cross spectra over the frames flagged as
    noise (NoisePowerSpectrum / NoiseCrossSpectrum, localization.h:72-115):
    ``X1``/``X2 [T, F]``, ``noise_mask`` bool ``[T]`` -> the final ``(N1 [F],
    N2 [F], Gn1n2 [F])``."""
    mask = torch.as_tensor(noise_mask).tolist()
    F = X1.shape[-1]
    n1 = torch.zeros(F, dtype=X1.real.dtype, device=X1.device)
    n2 = torch.zeros_like(n1)
    g = torch.zeros(F, dtype=X1.dtype, device=X1.device)
    for x1, x2, is_noise in zip(X1, X2, mask):
        if is_noise:
            n1 = alpha * n1 + (1 - alpha) * torch.abs(x1) ** 2
            n2 = alpha * n2 + (1 - alpha) * torch.abs(x2) ** 2
            g = alpha * g + (1 - alpha) * x1 * torch.conj(x2)
    return n1, n2, g


def gcc_weighted(X1: torch.Tensor, X2: torch.Tensor, fftlen: int, mode: str = "phat",
                 Gn1n2=None, N1=None, N2=None, q: float = 0.3,
                 smooth_beta: float = 0.0) -> torch.Tensor:
    """Generalized cross-correlation with the reference's weighting family
    (GCC{Raw,GnnSub,Phat,GnnSubPhat,MLRRaw,MLRGnnSub}::calcCrossSpectrumValue,
    localization.cc:1322-1392), ``mode`` one of "raw", "gnn_sub", "phat",
    "gnn_sub_phat", "mlr_raw", "mlr_gnn_sub", and the optional recursive
    smoothing of the cross spectrum over frames (localization.cc:1262-1266).
    ``X1``/``X2 [T, F]`` half-band spectra -> time-domain GCC ``[T,
    fftlen]``."""
    def as_t(a):
        if a is None or isinstance(a, torch.Tensor):
            return a if a is None else a.to(X1.device)
        return torch.tensor(np.asarray(a), device=X1.device)

    Gn1n2, N1, N2 = as_t(Gn1n2), as_t(N1), as_t(N2)
    cross = X1 * torch.conj(X2)
    if mode == "raw":
        G = cross
    elif mode == "gnn_sub":
        if Gn1n2 is None:
            # the reference would dereference NULL here (GCCGnnSub,
            # localization.cc:1328-1332)
            raise ValueError("mode 'gnn_sub' requires the noise cross spectrum Gn1n2")
        G = cross - Gn1n2
    elif mode == "phat":
        G = _phat(cross)
    elif mode == "gnn_sub_phat":
        # without noise statistics plain PHAT, as the reference
        # (GCCGnnSubPhat, localization.cc:1346-1355)
        G = _phat(cross if Gn1n2 is None else cross - Gn1n2)
    elif mode in ("mlr_raw", "mlr_gnn_sub"):
        # q1 = 1 - q, q2 = 2 q (GCC::GCC, localization.cc:1220-1221)
        q1, q2 = 1.0 - q, 2.0 * q
        X12, X22 = torch.abs(X1) ** 2, torch.abs(X2) ** 2
        den = q2 * X12 * X22
        if N1 is not None and N2 is not None:
            den = den + q1 * (N2 * X12 + N1 * X22)
        w = torch.sqrt(X12 * X22) / torch.clamp(den, min=1e-20)
        G = (cross - Gn1n2 if mode == "mlr_gnn_sub" and Gn1n2 is not None else cross) * w
    else:
        raise ValueError(f"unknown GCC mode {mode!r}")
    if smooth_beta > 0:
        g = torch.zeros_like(G[0])
        smoothed = []
        for gt in G:
            g = smooth_beta * g + (1 - smooth_beta) * gt
            smoothed.append(g)
        G = torch.stack(smoothed)
    return torch.fft.irfft(G, n=fftlen, dim=-1)


def find_cc_peak(cc: torch.Tensor, samplerate: float, min_delay: float = -np.inf,
                 max_delay: float = np.inf, interpolate: bool = True):
    """Peak of the cross-correlation ``cc [..., fftlen]`` within a delay
    window, with parabolic interpolation (GCC::findMaximum,
    localization.cc:1277-1320): ``(delay_seconds, peak_value)``."""
    fftlen = cc.shape[-1]
    lag = _lags(fftlen, cc.device)
    delay_s = lag.to(torch.float32) / samplerate
    ok = (delay_s >= min_delay) & (delay_s <= max_delay)
    k = torch.argmax(torch.where(ok, cc, torch.full_like(cc, -torch.inf)), dim=-1)

    def at(i):
        return torch.gather(cc, -1, i[..., None])[..., 0]

    peak = at(k)
    base = lag[k].to(torch.float32)
    if interpolate:
        ym, yp = at((k - 1) % fftlen), at((k + 1) % fftlen)
        denom = ym - 2 * peak + yp
        frac = torch.where(torch.abs(denom) > 1e-12, 0.5 * (ym - yp) / denom,
                           torch.zeros_like(denom))
        base = base + torch.clamp(frac, -1.0, 1.0)
    return base / samplerate, peak


def linear_array_delay_grid(mpos_1d, num_points: int = 36, samplerate: float = 16000.0,
                            sspeed: float = SSPEED_MM_S):
    """Far-field azimuth search grid of a linear array as integer sample
    delays (SGB4LinearArray, mcc_localizer.h:66-80): ``(delays_samples [G,
    C] int64, azimuths [G])``, numpy."""
    az = np.linspace(0.0, np.pi, num_points)
    mpos = np.asarray(mpos_1d, np.float64).reshape(-1, 1)
    d = np.stack([calc_la_delays(mpos, a, sspeed) for a in az])
    return np.round(d * samplerate).astype(np.int64), az


def mcc_reference_grid(num_chan: int, distance_mm: float, samplerate: float = 16000.0):
    """SGB4LinearArray's far-field search grid, replicated exactly
    (mcc_localizer.cc:44-161), numpy: microphones at ``micX * distance`` on
    the y axis, sin-spaced azimuth hypotheses over [0, pi/2] then [3pi/2,
    2pi), per hypothesis the truncated integer sample delays ``tau_c =
    int(fs * (-dist_c sin(az) / c))``.  Returns ``(tau [G, C] int32,
    azimuths [G], max_sample_delay)``.  The grid walk is the reference's
    float32 ``sinf`` / ``asinf`` arithmetic, so hypothesis boundaries land
    on the same integers as the compiled reference."""
    SSPEED = 343740.0
    const_v = np.float32(0.99 * SSPEED / ((num_chan - 1) * distance_mm * samplerate))
    max_time_delay = (num_chan - 1) * distance_mm / SSPEED
    max_sample_delay = int(samplerate * max_time_delay)
    dist = np.arange(num_chan) * float(distance_mm)

    azs = []
    az = np.float32(0.0)
    while True:
        azs.append(float(az))
        s_ = np.float32(np.sin(az))
        if az < np.float32(np.pi / 2):
            ns = s_ + const_v
            az = np.float32(np.pi / 2) if ns >= 1 else np.float32(np.arcsin(ns))
        elif az < np.float32(3 * np.pi / 2):
            az = np.float32(3 * np.pi / 2)
        else:
            ns = s_ + const_v
            if ns + const_v / 2 >= 0:
                break
            az = np.float32(2 * np.pi + np.arcsin(ns))
    azs = np.asarray(azs)
    delays = -dist[None, :] * np.sin(azs.astype(np.float64))[:, None] / SSPEED
    tau = (samplerate * delays).astype(np.int32)  # C truncation toward zero
    return tau, azs, max_sample_delay


def mcc_localize_blocks(x, block_len: int, tau_grid, max_sample_delay: int, num_best: int = 1,
                        normalize_variance: bool = True):
    """The reference's block-online MCC protocol, exactly, numpy
    (MCCLocalizer::next -> calcCovarianceMatrix -> eigen cost,
    mcc_localizer.cc:306-460): per block an uncentered covariance over
    frames ``[0, L - maxD)``, negative lags reading the block's own tail (a
    circular wrap: calcCovarianceMatrix refills the SampleHolder with the
    current block), cost ``sum log eig(R) - sum log diag(R)``, the N best
    ascending.  ``x [C, T]``, ``tau_grid [G, C]`` ints -> per block
    ``(best_idx [nblocks, num_best], mccc [nblocks, G])``."""
    x = np.asarray(x, np.float64)
    C, T = x.shape
    tau = np.asarray(tau_grid)
    G = tau.shape[0]
    maxD = int(max_sample_delay)
    nblocks = T // block_len
    best_all, mccc_all = [], []
    for k in range(nblocks):
        base = x[:, k * block_len:(k + 1) * block_len]
        f = np.arange(0, block_len - maxD)
        # aligned[g, c, n] = base[c, (f_n + tau[g, c]) wrapped]
        idx = (f[None, None, :] + tau[:, :, None]) % block_len
        al = np.take_along_axis(np.broadcast_to(base[None], (G, C, base.shape[1])), idx, axis=2)
        R = np.einsum("gcn,gdn->gcd", al, al) / len(f)
        ev = np.linalg.eigvalsh(R)
        cost = np.sum(np.log(np.maximum(np.abs(ev), 1e-300)), axis=-1)
        if normalize_variance:
            cost = cost - np.sum(np.log(np.maximum(np.diagonal(R, axis1=1, axis2=2), 1e-300)),
                                 axis=-1)
        best_all.append(np.argsort(cost, kind="stable")[:num_best])
        mccc_all.append(1.0 - np.exp(cost))
    return np.stack(best_all), np.stack(mccc_all)


def mcc_localize(x, delay_grid, num_best: int = 1, normalize_variance: bool = True):
    """Multichannel cross-correlation localization over a delay grid
    (MCCLocalizer::search + calcObjectiveFunction, mcc_localizer.cc:360-440):
    per hypothesis the channels of the time block ``x [C, T]`` aligned by
    the grid's integer sample delays ``delay_grid [G, C]``, the cost
    ``logdet(R) - sum log diag(R)`` of their centred covariance (minimal
    when they are most correlated), MCCC = 1 - exp(cost).  Returns
    ``(best_indices [num_best], mccc [G])``."""
    x = torch.as_tensor(x, dtype=torch.float32)
    C, T = x.shape
    dg = np.asarray(delay_grid)
    G = dg.shape[0]
    max_d = int(np.abs(dg).max())
    xp = torch.nn.functional.pad(x, (max_d, max_d))
    # aligned[g, c, t] = x[c, t + delay[g, c]]
    idx = (torch.arange(T, device=x.device)[None, None, :]
           + torch.as_tensor(dg, device=x.device)[:, :, None] + max_d)
    aligned = torch.gather(xp[None].expand(G, C, xp.shape[-1]), -1, idx)
    centred = aligned - aligned.mean(dim=-1, keepdim=True)
    Rc = torch.einsum("gct,gdt->gcd", centred, centred) / T
    _, cost = torch.linalg.slogdet(Rc)
    if normalize_variance:
        diag = torch.diagonal(Rc, dim1=-2, dim2=-1)
        cost = cost - torch.sum(torch.log(torch.clamp(diag, min=1e-20)), dim=-1)
    mccc = 1.0 - torch.exp(cost)
    return _top_k(mccc, num_best), mccc
