"""Long-recording correctness gates (BASELINE config 5 scale).

The f32 risk at scale is NOT phase drift (the compensated (hi, lo)-pair
scan of ops/phase.py is drift-free by construction) but ANCHOR
CONDITIONING: bin k's synthesis phase inherits its frame-0 analysis phase,
so a bin that is at the noise floor at t=0 and loud later carries an
O(arith_noise / |X_k(0)|) phase offset forever. On broadband content (every
bin anchored above the floor — the canonical test signal has a 5% noise
floor) the route holds <1e-4 vs golden out to an hour; on pathological
content (pure chirp over a PCM16-quantization floor) every f32
implementation lands ~1e-2 from the f64 oracle, and the oracle itself moves
~7e-3 under 1e-7 input perturbations.

Streaming + chunked measured on the 8-device CPU mesh, 2.0x vs f64 golden
— flat in length: 60 s 4.7e-6, 600 s 4.73e-6, 3600 s 9.75e-6.

The 600 s cases run only when PVOC_SLOW_TESTS=1 (the f64 golden at 37.5k
frames takes minutes on CPU); the 3600 s hour gate only when
PVOC_HOUR_TESTS=1. The 60 s case always runs.
"""

import os

import numpy as np
import pytest

from golden import pv_ref
from phase_vocoder import PvocConfig, time_stretch
from tests.conftest import make_test_signal

N, RA = 1024, 256

SLOW = os.environ.get("PVOC_SLOW_TESTS") == "1"
HOUR = os.environ.get("PVOC_HOUR_TESTS") == "1"


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    sl = slice(edge, len(b) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


def test_fused_golden_one_minute():
    """<1e-4 vs f64 golden at 60 s (3750 frames), time_stretch, 2x."""
    x = make_test_signal(60.0).astype(np.float32)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), 2.0, N, RA)
    y = np.asarray(time_stretch(x, 2.0))
    e = rel_err(y, ref)
    assert e < 1e-4, e


@pytest.mark.skipif(not SLOW, reason="set PVOC_SLOW_TESTS=1 (minutes on CPU)")
def test_fused_golden_ten_minutes_2x():
    """<1e-4 vs f64 golden at 600 s (37.5k frames) — the >=10-min gate,
    through time_stretch (the streaming executor at this length)."""
    x = make_test_signal(600.0).astype(np.float32)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), 2.0, N, RA)
    y = np.asarray(time_stretch(x, 2.0))
    e = rel_err(y, ref)
    assert e < 1e-4, e


@pytest.mark.skipif(not SLOW, reason="set PVOC_SLOW_TESTS=1 (minutes on CPU)")
def test_fused_golden_ten_minutes_halfk():
    """k=1/2 at 600 s on the aliasing sweep, through time_stretch.

    At (0.5x, >=600 s) the f64 oracle itself moves rel 0.244 on this
    signal under a 1e-7 input perturbation: noise-floor bins random-walk
    across the principal branch point, and each crossing is a discrete
    choice any rounding change reshuffles. So the assertable properties are
    waveform correlation and rel error within the oracle's own
    perturbation envelope; the tight k=1/2 gate lives at 60 s and on
    benign content (below)."""
    x = make_test_signal(600.0).astype(np.float32)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), 0.5, N, RA)
    y = np.asarray(time_stretch(x, 0.5), np.float64)
    sl = slice(N, len(ref) - N)
    corr = np.corrcoef(y[sl], ref[sl])[0, 1]
    # Thresholds = the oracle's own 1e-7-perturbation envelope on this
    # signal (golden-vs-perturbed-golden: corr 0.99881, rel 0.244): an
    # implementation cannot be asserted closer to the oracle than the
    # oracle is to itself.
    assert corr > 0.998, corr
    e = rel_err(y, ref)
    assert e < 0.3, e


@pytest.mark.skipif(not SLOW, reason="set PVOC_SLOW_TESTS=1 (minutes on CPU)")
def test_streaming_and_chunked_golden_ten_minutes():
    """The streaming executor and the 8-device chunked program hold the
    same >=10-min gate. Both carry the synthesis-phase residual as a
    compensated (hi, lo) f32 pair (ops/phase.py), so the error is flat in
    length (round 2's plain-f32 scan drifted to 2.84e-4 at just 60 s).
    Measured 2026-08-21 (8-device CPU mesh, 600 s / 2.0x vs f64 golden):
    streaming 4.73e-6, chunked 4.73e-6."""
    from phase_vocoder.parallel.chunked import chunked_time_stretch
    from phase_vocoder.parallel.mesh import make_mesh
    from phase_vocoder.streaming import stream_time_stretch

    x = make_test_signal(600.0)
    ref = pv_ref.phase_vocoder(x, 2.0, N, RA)
    cfg = PvocConfig()
    y_s = np.asarray(stream_time_stretch(x, 2.0, cfg))
    assert rel_err(y_s, ref) < 1e-4
    y_c = np.asarray(
        chunked_time_stretch(x, 2.0, cfg, mesh=make_mesh(8, axis="seq"))
    )
    assert rel_err(y_c, ref) < 1e-4


@pytest.mark.skipif(not HOUR, reason="set PVOC_HOUR_TESTS=1 (tens of minutes)")
def test_streaming_and_chunked_golden_one_hour():
    """BASELINE config 5: hour-long recording (3600 s, ~225k frames).

    The compensated pair carry keeps streaming and the 8-device chunked
    program under the 1e-4 gate at a full hour — the drift-vs-length table
    (60/600/3600 s) is in this module's docstring. Measured: streaming
    9.75e-6, chunked 9.75e-6 (vs 4.7e-6 at 60/600 s — near-flat)."""
    from phase_vocoder.parallel.chunked import chunked_time_stretch
    from phase_vocoder.parallel.mesh import make_mesh
    from phase_vocoder.streaming import stream_time_stretch

    x = make_test_signal(3600.0)
    ref = pv_ref.phase_vocoder(x, 2.0, N, RA)
    cfg = PvocConfig()
    y_s = np.asarray(stream_time_stretch(x, 2.0, cfg))
    e_s = rel_err(y_s, ref)
    assert e_s < 1e-4, e_s
    y_c = np.asarray(
        chunked_time_stretch(x, 2.0, cfg, mesh=make_mesh(8, axis="seq"))
    )
    e_c = rel_err(y_c, ref)
    assert e_c < 1e-4, e_c


def _benign_tones_noise(seconds: float, sr: int = 16000) -> np.ndarray:
    """Tones + noise WITHOUT the aliasing chirp: the canonical signal's
    chirp wraps the Nyquist every ~10 s, making >=600 s slices maximally
    branch-dense (every bin crosses the princarg branch repeatedly). This
    is the benign long-form content the tight gates run on."""
    g = np.random.default_rng(7)
    t = np.arange(int(seconds * sr)) / sr
    x = (
        0.5 * np.sin(2 * np.pi * 440.0 * t)
        + 0.3 * np.sin(2 * np.pi * 1234.5 * t)
        + 0.05 * g.standard_normal(len(t))
    )
    return (x / np.max(np.abs(x))).astype(np.float64)


@pytest.mark.skipif(not SLOW, reason="set PVOC_SLOW_TESTS=1 (minutes)")
def test_fused_golden_ten_minutes_halfk_benign():
    """TIGHT <1e-4 gate for k=1/2 at 600 s on benign tones+noise content
    (the correlation gate on the aliasing sweep alone leaves long-form
    0.5x only weakly gated)."""
    x = _benign_tones_noise(600.0).astype(np.float32)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), 0.5, N, RA)
    y = np.asarray(time_stretch(x, 0.5))
    e = rel_err(y, ref)
    assert e < 1e-4, e


@pytest.mark.parametrize("op", ["stretch", "pitch"])
def test_long_inputs_route_to_streaming(op):
    """Past MAX_MONOLITHIC_FRAMES both entry points stretch through the
    streaming executor: bitwise equal to calling it directly."""
    from phase_vocoder import pipeline
    from phase_vocoder.streaming import stream_time_stretch

    x = make_test_signal(3.0).astype(np.float32)
    limit = 64  # frames; the 3 s input has 184
    if op == "stretch":
        y = np.asarray(pipeline.time_stretch(x, 1.5, max_monolithic_frames=limit))
        want = np.asarray(stream_time_stretch(x, 1.5))
    else:
        y = np.asarray(pipeline.pitch_shift(x, 7.0, max_monolithic_frames=limit))
        factor = 2.0 ** (7.0 / 12.0)
        z = stream_time_stretch(x, factor)
        want = np.asarray(pipeline._resample_jit(z, factor, len(y)))
    np.testing.assert_array_equal(y, want)
