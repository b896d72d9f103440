"""Property tests for the frozen golden model (SURVEY.md SS4.2).

These pin the golden model itself to the published algorithm before anything
is tested against it: COLA constant, identity resynthesis, instantaneous-
frequency recovery, princarg range, stretch-ratio length, resample round trip.
"""

import numpy as np
import pytest

from golden import pv_ref
from tests.conftest import make_test_signal

N, RA, SR = 1024, 256, 16000


def test_hann_is_periodic():
    w = pv_ref.hann_window(N)
    assert w[0] == 0.0
    # Periodic Hann: w[i] == w[N - i] for i >= 1 (symmetric about N/2).
    assert np.allclose(w[1:], w[:0:-1])
    assert np.isclose(w[N // 2], 1.0)


def test_cola_hann_squared_quarter_hop():
    """Hann^2 overlap-added at hop N/4 sums to the constant 1.5."""
    w = pv_ref.hann_window(N)
    nf = 16
    norm = pv_ref.overlap_add(np.broadcast_to(w * w, (nf, N)).copy(), N // 4)
    interior = norm[N : -N]
    assert np.allclose(interior, 1.5, atol=1e-12)


def test_princarg_range_and_identity():
    x = np.linspace(-50, 50, 100001)
    p = pv_ref.princarg(x)
    assert np.all(p > -np.pi - 1e-12)
    assert np.all(p <= np.pi + 1e-12)
    assert np.allclose(np.exp(1j * p), np.exp(1j * x), atol=1e-10)


def test_identity_resynthesis():
    """stretch=1.0 must reproduce the input to ~f64 roundoff in the interior."""
    x = make_test_signal(1.0)
    y = pv_ref.phase_vocoder(x, 1.0, N, RA)
    n = min(len(x), len(y))
    # Skip the first/last window where OLA normalization has edge taper.
    sl = slice(N, n - N)
    err = np.max(np.abs(y[sl] - x[sl])) / np.max(np.abs(x))
    assert err < 1e-9, err


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_stretch_length_ratio(stretch):
    x = make_test_signal(2.0)
    y = pv_ref.phase_vocoder(x, stretch, N, RA)
    ratio = len(y) / len(x)
    assert abs(ratio - stretch) < 0.05, ratio


@pytest.mark.parametrize("f0", [440.0, 437.3])  # on-bin-ish and off-bin
def test_sinusoid_if_recovery(f0):
    """The unwrapped instantaneous frequency of a pure tone equals f0."""
    t = np.arange(SR) / SR
    x = np.sin(2 * np.pi * f0 * t)
    X = pv_ref.stft(x, N, RA)
    phi = np.angle(X)
    k = int(round(f0 * N / SR))
    omega = 2 * np.pi * k / N
    dphi = pv_ref.princarg(phi[1:, k] - phi[:-1, k] - RA * omega)
    inst = (omega + dphi / RA) * SR / (2 * np.pi)
    mid = inst[5:-5]
    assert np.max(np.abs(mid - f0)) < 0.05, (f0, mid.mean())


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_stretched_sinusoid_keeps_frequency(stretch):
    """Time-stretch must preserve pitch: a 440 Hz tone stays 440 Hz."""
    t = np.arange(2 * SR) / SR
    x = np.sin(2 * np.pi * 440.0 * t)
    y = pv_ref.phase_vocoder(x, stretch, N, RA)
    # Measure dominant frequency of the interior via FFT peak.
    mid = y[len(y) // 4 : 3 * len(y) // 4]
    spec = np.abs(np.fft.rfft(mid * np.hanning(len(mid))))
    peak = np.argmax(spec) * SR / len(mid)
    assert abs(peak - 440.0) < 2.0, peak


def test_resample_linear_round_trip():
    x = make_test_signal(1.0)
    up = pv_ref.resample_linear(x, 2.0)
    down = pv_ref.resample_linear(up, 0.5, out_len=len(x))
    err = np.max(np.abs(down[10:-10] - x[10:-10]))
    assert err < 5e-3, err  # linear interp of band-limited-ish signal


def test_pitch_shift_moves_tone():
    t = np.arange(SR) / SR
    x = np.sin(2 * np.pi * 440.0 * t)
    y = pv_ref.pitch_shift(x, 12.0, N, RA)  # +1 octave
    spec = np.abs(np.fft.rfft(y[len(y) // 4 : 3 * len(y) // 4]))
    peak = np.argmax(spec) / (len(y) // 2) * SR
    assert abs(peak - 880.0) < 10.0, peak
    # Duration preserved to within a frame.
    assert abs(len(y) - len(x)) < N


def test_psi_recurrence_equals_cumsum():
    """The psi recurrence is exactly phi[0] + cumsum(Rs*IF) — the structural
    insight that makes the associative-scan implementation valid."""
    x = make_test_signal(0.5)
    X = pv_ref.stft(x, N, RA)
    phi = np.angle(X)
    k = np.arange(N // 2 + 1)
    omega = 2 * np.pi * k / N
    dphi = pv_ref.princarg(phi[1:] - phi[:-1] - RA * omega)
    inst = omega + dphi / RA
    rs = 512
    # Loop version
    psi = np.empty_like(phi)
    psi[0] = phi[0]
    for i in range(1, len(phi)):
        psi[i] = psi[i - 1] + rs * inst[i - 1]
    # Cumsum version
    psi2 = phi[0] + np.concatenate(
        [np.zeros((1, phi.shape[1])), np.cumsum(rs * inst, axis=0)]
    )
    assert np.allclose(psi, psi2, atol=1e-8)
