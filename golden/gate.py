"""The project's golden gate: comparisons against the float64 oracle.

An output passes when its maximum error over the interior (the first and
last n_fft samples excluded: the overlap-add normalization divides by a
vanishing window energy there in every implementation) is below GATE
relative to the oracle's interior peak.

Phase propagation is causal: frames up to i depend only on samples up to
frame i, and output samples before frame nf_p's start only on frames below
nf_p. So the first part of a long recording's output equals the oracle's
output on a prefix of the recording, up to the last n_fft samples of that
prefix — which lets the f64 oracle check an hour-long run on one minute.
"""

from __future__ import annotations

import numpy as np

from . import pv_ref

GATE = 1e-4


def make_signal(seconds: float, sr: int = 16000, seed: int = 0) -> np.ndarray:
    """Chirp + tone + noise, float64 in [-1, 1]: the signal of the test suite,
    chip_smoke.py and bench.py. The chirp aliases every ~10 s, which makes
    long recordings branch-dense (see chip_smoke.compare_to_one_device)."""
    g = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    x = (
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.3 * np.sin(2 * np.pi * (200.0 * t + 400.0 * t * t))
        + 0.05 * g.standard_normal(len(t))
    )
    return (x / np.max(np.abs(x))).astype(np.float64)


def interior_rel_err(y, ref, edge: int) -> float:
    """Max |y - ref| over [edge, len(ref) - edge), over max |ref| there."""
    y = np.asarray(y, np.float64)
    ref = np.asarray(ref, np.float64)
    if len(y) < len(ref):
        raise ValueError(f"output has {len(y)} samples, oracle {len(ref)}")
    sl = slice(edge, len(ref) - edge)
    return float(np.max(np.abs(y[sl] - ref[sl])) / np.max(np.abs(ref[sl])))


def stretch_prefix_err(
    y, x, stretch: float, n_fft: int, hop: int, prefix: int | None = None
) -> float:
    """Gate error of time_stretch output `y` of input `x`, checked against
    the oracle on the first `prefix` input samples (all of x if None)."""
    xp = np.asarray(x, np.float64)[: len(x) if prefix is None else prefix]
    ref = pv_ref.phase_vocoder(xp, stretch, n_fft, hop)
    return interior_rel_err(y, ref, n_fft)


def pitch_err(
    y, x, semitones: float, n_fft: int, hop: int, prefix: int | None = None
) -> float:
    """Gate error of pitch_shift output `y` of input `x`, against the oracle
    on the first `prefix` input samples (all of x if None).

    With a prefix the comparison stops ceil(n_fft / factor) samples before
    the end of the oracle's output: the resampler reads the stretched
    signal at j * factor, so a downward shift maps the prefix's unsettled
    stretched tail onto that many output samples."""
    factor = 2.0 ** (semitones / 12.0)
    xp = np.asarray(x, np.float64)[: len(x) if prefix is None else prefix]
    ref = pv_ref.pitch_shift(xp, semitones, n_fft, hop)
    y = np.asarray(y)
    if prefix is None:
        m = min(len(ref), len(y))
        return interior_rel_err(y[:m], ref[:m], n_fft)
    edge = int(np.ceil(n_fft / min(factor, 1.0)))
    sl = slice(n_fft, len(ref) - edge)
    err = np.max(np.abs(np.asarray(y[: len(ref)], np.float64)[sl] - ref[sl]))
    return float(err / np.max(np.abs(ref[sl])))
