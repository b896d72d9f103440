"""Float64 NumPy golden model of the phase-vocoder algorithm.

This file is the executable behavioral specification of the reference
(davispolito/Phase-Vocoder, a single-GPU CUDA phase vocoder whose pipeline is
windowed STFT -> instantaneous-frequency via phase unwrap -> frequency-domain
time-scale modification -> overlap-add resynthesis; see SURVEY.md SS0/SS3.1 — the
reference mount was empty, so this f64 model IS the allclose oracle, pinned to
the classic Dolson/Laroche algorithm and validated numerically in SURVEY.md SS3.1:
identity-resynthesis rel err 1.4e-11, sinusoid IF recovery exact to 2e-7 Hz,
Hann^2 OLA at N/4 hop sums to 1.5).

Everything here is deliberately simple, serial where the reference is serial
(the psi recurrence is written as an explicit loop), and float64 throughout.
The framework under ``phase_vocoder/`` must match this model to
rel < 1e-4 at stretch in {0.5, 1.0, 2.0}, N=1024, Ra=256 (BASELINE.json:5-9).

Do NOT "optimize" this file. It is a frozen fixture.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "hann_window",
    "frame_signal",
    "princarg",
    "stft",
    "phase_vocoder",
    "time_stretch",
    "resample_linear",
    "pitch_shift",
    "num_frames",
    "output_length",
]


def hann_window(n: int) -> np.ndarray:
    """Periodic Hann window: w[i] = 0.5 - 0.5*cos(2*pi*i/n), i in [0, n)."""
    i = np.arange(n, dtype=np.float64)
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * i / n)


def num_frames(length: int, n_fft: int, hop: int) -> int:
    """Number of complete analysis frames for a signal of `length` samples."""
    if length < n_fft:
        return 0
    return 1 + (length - n_fft) // hop


def output_length(nf: int, n_fft: int, hop: int) -> int:
    """Length of the overlap-add output for `nf` frames at synthesis hop."""
    if nf <= 0:
        return 0
    return (nf - 1) * hop + n_fft


def frame_signal(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Slice x into overlapping frames: frames[i] = x[i*hop : i*hop + n_fft]."""
    x = np.asarray(x, dtype=np.float64)
    nf = num_frames(len(x), n_fft, hop)
    frames = np.empty((nf, n_fft), dtype=np.float64)
    for i in range(nf):
        frames[i] = x[i * hop : i * hop + n_fft]
    return frames


def princarg(phase: np.ndarray) -> np.ndarray:
    """Principal argument: wrap phase to (-pi, pi]."""
    return np.pi - np.mod(np.pi - phase, 2.0 * np.pi)


def stft(x: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """Windowed short-time Fourier transform, rfft over Hann-windowed frames."""
    w = hann_window(n_fft)
    frames = frame_signal(x, n_fft, hop) * w
    return np.fft.rfft(frames, axis=-1)


def overlap_add(frames: np.ndarray, hop: int) -> np.ndarray:
    """Scatter-add frames at the given hop."""
    nf, n_fft = frames.shape
    out = np.zeros(output_length(nf, n_fft, hop), dtype=np.float64)
    for i in range(nf):
        out[i * hop : i * hop + n_fft] += frames[i]
    return out


def phase_vocoder(
    x: np.ndarray,
    stretch: float,
    n_fft: int = 1024,
    hop: int = 256,
    eps: float = 1e-8,
) -> np.ndarray:
    """Classic phase-vocoder time-scale modification (the SS3.1 spec, verbatim).

    Analysis hop Ra = `hop`; synthesis hop Rs = round(Ra * stretch).
    Returns the stretched waveform (float64).
    """
    x = np.asarray(x, dtype=np.float64)
    n = n_fft
    ra = hop
    rs = int(round(ra * stretch))
    if rs <= 0:
        raise ValueError(f"stretch {stretch} gives non-positive synthesis hop")

    w = hann_window(n)
    frames = frame_signal(x, n, ra) * w
    nf = frames.shape[0]
    if nf == 0:
        return np.zeros(0, dtype=np.float64)

    X = np.fft.rfft(frames, axis=-1)  # (nf, n//2+1)
    mag = np.abs(X)
    phi = np.angle(X)

    k = np.arange(n // 2 + 1, dtype=np.float64)
    omega = 2.0 * np.pi * k / n  # bin center freq, rad/sample

    # Heterodyned phase increment -> instantaneous frequency per (frame, bin).
    dphi = princarg(phi[1:] - phi[:-1] - ra * omega)  # (nf-1, nbins)
    inst_freq = omega + dphi / ra  # (nf-1, nbins)

    # Synthesis phase: psi[0] = phi[0]; psi[i] = psi[i-1] + rs * IF[i-1].
    # Written as the explicit serial recurrence on purpose (this mirrors the
    # reference's serial per-bin loop; the framework replaces it with a scan).
    psi = np.empty_like(phi)
    psi[0] = phi[0]
    for i in range(1, nf):
        psi[i] = psi[i - 1] + rs * inst_freq[i - 1]

    # DC and Nyquist bins are forced-real (phase exactly 0 or pi), so their
    # heterodyned increment sits exactly on the princarg branch point every
    # frame — accumulating it is chaotic under any precision change (the
    # sign of roundoff noise picks the branch). Deterministic convention:
    # per-frame phase pass-through plus the exact linear rotation
    # i*Rs*omega_k (an integer multiple of pi at these bins). This keeps
    # identity resynthesis exact and makes cross-implementation allclose
    # well-posed; it is the only intentional deviation from the naive
    # textbook recurrence, mirrored by phase_vocoder/ops/phase.py.
    frame_idx = np.arange(nf, dtype=np.float64)[:, None]
    real_bins = [0] + ([n // 2] if n % 2 == 0 else [])
    for kb in real_bins:
        lin = 2.0 * np.pi * ((frame_idx[:, 0].astype(np.int64) * ((rs * kb) % n)) % n) / n
        psi[:, kb] = phi[:, kb] + lin

    Y = mag * np.exp(1j * psi)
    y_frames = np.fft.irfft(Y, n=n, axis=-1) * w

    out = overlap_add(y_frames, rs)
    norm = overlap_add(np.broadcast_to(w * w, (nf, n)).copy(), rs)
    return out / np.maximum(norm, eps)


def time_stretch(
    x: np.ndarray, stretch: float, n_fft: int = 1024, hop: int = 256
) -> np.ndarray:
    """Alias for phase_vocoder (kept for API symmetry with the framework)."""
    return phase_vocoder(x, stretch, n_fft=n_fft, hop=hop)


def resample_linear(x: np.ndarray, factor: float, out_len: int | None = None) -> np.ndarray:
    """Resample x by `factor` (>1 = more samples) with linear interpolation.

    out[j] = x[j / factor] with linear interpolation, clamped at the edges.
    """
    x = np.asarray(x, dtype=np.float64)
    if out_len is None:
        out_len = int(round(len(x) * factor))
    if out_len <= 0:
        return np.zeros(0, dtype=np.float64)
    pos = np.arange(out_len, dtype=np.float64) / factor
    pos = np.clip(pos, 0.0, len(x) - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, len(x) - 1)
    frac = pos - lo
    return x[lo] * (1.0 - frac) + x[hi] * frac


def pitch_shift(
    x: np.ndarray,
    semitones: float,
    n_fft: int = 1024,
    hop: int = 256,
) -> np.ndarray:
    """Pitch shift by `semitones`: time-stretch by 2^(s/12), then resample back.

    Matches the reference behavior described in BASELINE.json:9 (pitch-shift via
    stretch + resample, +-12 semitones).
    """
    factor = 2.0 ** (semitones / 12.0)
    stretched = phase_vocoder(x, factor, n_fft=n_fft, hop=hop)
    # Resample stretched audio back down/up so duration matches input duration.
    return resample_linear(stretched, 1.0 / factor)
