"""Golden gates of the stretch routes at awkward geometries, plus the
blocked-scan unit test.

These gates once exercised a fused single-kernel path; the route they now
check is the plain XLA program every stretch and pitch shift takes
(analysis -> compensated-pair phase scan -> synthesis), at the same
stretches, hops and lengths, against the float64 golden model.
"""

import numpy as np
import pytest

from golden import pv_ref
from phase_vocoder import PvocConfig, time_stretch
from phase_vocoder.ops import phase
from tests.conftest import make_test_signal

N, RA = 1024, 256


def rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.fixture(scope="module")
def x32k():
    return make_test_signal(2.0).astype(np.float32)


@pytest.mark.parametrize("stretch", [0.5, 1.0, 2.0])
def test_fused_vs_golden(stretch, x32k):
    """The headline gate: waveform allclose (<1e-4 rel) to the f64 golden
    model at every canonical stretch (BASELINE.json:5)."""
    ref = pv_ref.phase_vocoder(np.asarray(x32k, np.float64), stretch, N, RA)
    y = np.asarray(time_stretch(x32k, stretch))
    assert rel_err(y, ref) < 1e-4


def test_fused_awkward_length():
    """Frame count far from any block multiple, including the OLA tail."""
    x = make_test_signal(2.3141).astype(np.float32)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), 2.0, N, RA)
    y = np.asarray(time_stretch(x, 2.0))
    assert len(y) == len(ref)
    # interior strict, full range loose (edge normalization divides by
    # near-zero window energy — ill-conditioned in f32 for ANY backend)
    assert rel_err(y, ref) < 1e-4
    assert np.max(np.abs(y - ref)) / np.max(np.abs(ref)) < 1e-2


def test_fused_integer_k4():
    """Integer hop ratios beyond 2 (k=4 at N=512, Ra=64)."""
    x = make_test_signal(1.0).astype(np.float32)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), 4.0, 512, 64)
    y = np.asarray(time_stretch(x, 4.0, PvocConfig(n_fft=512, hop=64)))
    assert rel_err(y, ref, edge=512) < 1e-4


def test_blocked_scan_matches_flat():
    """blocked_scan == associative_scan at awkward (non-power-of-two) sizes."""
    import jax
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    for n in (1, 7, 129, 1000, 3001):
        t = jnp.asarray(rng.uniform(-3, 3, (n, 17)), jnp.float32)
        a = phase.blocked_scan(phase.wrap_add, t, block=128)
        b = jax.lax.associative_scan(phase.wrap_add, t, axis=0)
        d = np.abs(np.asarray(phase.princarg(a - b)))
        assert d.max() < 1e-5, (n, d.max())


@pytest.mark.parametrize("stretch", [1.5, 0.75, 0.25])
def test_phasor_general_stretch_vs_golden(stretch):
    """Stretch ratios with rs not dividing N (or below N/4) vs the golden
    model, through time_stretch."""
    x = make_test_signal(4.0)
    cfg = PvocConfig()
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), stretch, N, RA)
    y = np.asarray(time_stretch(x.astype(np.float32), stretch, cfg))
    assert len(y) == len(ref)
    assert rel_err(y, ref) < 1e-4


@pytest.mark.parametrize("stretch", [1.5, 0.75])
def test_semifused_phasor_general_path_vs_golden(stretch):
    """The monolithic program called directly (analyze, polar stage,
    synthesize), on the DFT-matmul backend, at general synthesis hops."""
    import jax.numpy as jnp

    from phase_vocoder import pipeline

    x = make_test_signal(4.0)
    cfg = PvocConfig(fft_backend="matmul")
    rs = cfg.synthesis_hop(stretch)
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), stretch, N, RA)
    y = np.asarray(
        pipeline._time_stretch_jit(jnp.asarray(x, jnp.float32), cfg, rs)
    )
    assert len(y) == len(ref)
    assert rel_err(y, ref) < 1e-4


@pytest.mark.parametrize("semitones", [-7.0, -5.0, 7.0])
def test_pitch_general_hops_ride_fused_path(semitones):
    """-7/-5/+7 st quantize to Rs=171/192/384 (q=256, 4, 2): general
    synthesis hops plus the gather resampler, under the golden gate."""
    from phase_vocoder import pipeline

    x = make_test_signal(4.0)
    cfg = PvocConfig()
    ref = pv_ref.pitch_shift(np.asarray(x, np.float64), semitones, N, RA)
    y = np.asarray(pipeline.pitch_shift(x.astype(np.float32), semitones, cfg))
    m = min(len(ref), len(y))
    sl = slice(N, m - N)
    err = np.max(np.abs(np.asarray(y, np.float64)[sl] - ref[sl])) / np.max(
        np.abs(ref[sl])
    )
    assert err < 1e-4, err


@pytest.mark.parametrize("rs", [171, 342, 305])
def test_fused_general_hop_vs_golden(rs):
    """Irreducible synthesis hops (the non-octave pitch hops) through
    time_stretch: the general fold OLA at hops that divide nothing."""
    x = make_test_signal(4.0).astype(np.float32)
    stretch = rs / RA
    ref = pv_ref.phase_vocoder(np.asarray(x, np.float64), stretch, N, RA)
    y = np.asarray(time_stretch(x, stretch))
    assert len(y) == len(ref)
    assert rel_err(y, ref) < 1e-4
