"""The two DFT backends and the resampler against float64 references, and
the default backend end to end against the matmul backend and golden.

"xla" (the default: jnp.fft, cuFFT on the GPU) and "matmul" (the DFT as
float32 products at Precision.HIGHEST) are independent implementations;
each must match numpy's float64 FFT, and each other, at the geometries
the project runs (N = 512, 1024, 2048).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from golden import pv_ref
from phase_vocoder import PvocConfig, pitch_shift, time_stretch
from phase_vocoder.ops import fft as fft_ops
from phase_vocoder.ops import resample
from phase_vocoder.streaming import stream_time_stretch
from tests.conftest import make_test_signal

N, RA = 1024, 256
SIZES = [512, 1024, 2048]
BACKENDS = ["xla", "matmul"]


def interior_rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


def _frames(n, rows=33, seed=0):
    return np.random.default_rng(seed).standard_normal((rows, n))


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", SIZES)
def test_rfft_vs_numpy_f64(n, backend):
    f = _frames(n)
    ref = np.fft.rfft(f, axis=-1)
    re, im = fft_ops.rfft(jnp.asarray(f, jnp.float32), backend=backend)
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(np.asarray(re) - ref.real)) / scale < 1e-5
    assert np.max(np.abs(np.asarray(im) - ref.imag)) / scale < 1e-5


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", SIZES)
def test_irfft_vs_numpy_f64(n, backend):
    spec = np.fft.rfft(_frames(n, seed=1), axis=-1)
    ref = np.fft.irfft(spec, n=n, axis=-1)
    y = fft_ops.irfft(
        jnp.asarray(spec.real, jnp.float32), jnp.asarray(spec.imag, jnp.float32),
        n, backend=backend,
    )
    assert np.max(np.abs(np.asarray(y) - ref)) / np.max(np.abs(ref)) < 1e-5


@pytest.mark.parametrize("n", SIZES)
def test_windowed_transforms_agree_across_backends(n):
    """The fused-window matmul DFT equals the FFT op on windowed frames,
    forward and inverse (what analyze/synthesize compute per backend)."""
    f = jnp.asarray(_frames(n, seed=2), jnp.float32)
    w = jnp.asarray(pv_ref.hann_window(n), jnp.float32)
    re_x, im_x = fft_ops.rfft(f * w, backend="xla")
    re_m, im_m = fft_ops.rfft(f, backend="matmul", fused_window=True)
    scale = float(jnp.max(jnp.abs(re_x)))
    assert float(jnp.max(jnp.abs(re_x - re_m))) / scale < 1e-5
    assert float(jnp.max(jnp.abs(im_x - im_m))) / scale < 1e-5
    y_x = fft_ops.irfft(re_x, im_x, n, backend="xla") * w
    y_m = fft_ops.irfft(re_x, im_x, n, backend="matmul", fused_window=True)
    assert float(jnp.max(jnp.abs(y_x - y_m))) / float(jnp.max(jnp.abs(y_x))) < 1e-5


@pytest.mark.parametrize("semitones", [-12, -7, -5, 5, 7, 12])
def test_resample_vs_golden_f64(semitones):
    """resample_linear (gather for non-octave steps, exact rational product
    for octaves) against the f64 oracle, at the factors pitch_shift uses."""
    x = make_test_signal(2.0)
    factor = 1.0 / 2.0 ** (semitones / 12.0)
    out_len = int(round(len(x) * factor))
    ref = pv_ref.resample_linear(x, factor, out_len)
    ours = resample.resample_linear(jnp.asarray(x, jnp.float32), factor, out_len)
    assert np.max(np.abs(np.asarray(ours, np.float64) - ref)) < 2e-6
    rational = resample._as_rational_step(factor) is not None
    assert rational == (abs(semitones) == 12)


@pytest.mark.parametrize("stretch", [0.5, 1.0, 2.0])
def test_default_backend_end_to_end(stretch, signal_4s):
    """The default backend matches the matmul backend end to end."""
    assert PvocConfig().fft_backend == "xla"
    a = np.asarray(time_stretch(signal_4s, stretch))
    b = np.asarray(time_stretch(signal_4s, stretch, PvocConfig(fft_backend="matmul")))
    assert interior_rel_err(a, b) < 5e-5


def test_default_backend_vs_golden(signal_1s):
    ref = pv_ref.phase_vocoder(signal_1s, 2.0, N, RA)
    y = np.asarray(time_stretch(signal_1s, 2.0))
    assert interior_rel_err(y, ref) < 1e-4


def test_default_backend_fractional_ratio(signal_1s):
    """rs that does not divide n_fft, both backends against golden."""
    ref = pv_ref.phase_vocoder(signal_1s, 1.3, N, RA)
    a = np.asarray(time_stretch(signal_1s, 1.3))
    b = np.asarray(time_stretch(signal_1s, 1.3, PvocConfig(fft_backend="matmul")))
    assert interior_rel_err(a, ref) < 1e-4
    assert interior_rel_err(b, ref) < 1e-4


def test_default_backend_streaming(signal_4s):
    a = np.asarray(stream_time_stretch(signal_4s, 2.0, PvocConfig(), segment_frames=40))
    b = np.asarray(stream_time_stretch(
        signal_4s, 2.0, PvocConfig(fft_backend="matmul"), segment_frames=40))
    assert interior_rel_err(a, b) < 1e-5


def test_default_backend_pitch_shift(signal_1s):
    """Non-octave pitch (general synthesis hop + gather resampler) on both
    backends against the golden contract."""
    ref = pv_ref.pitch_shift(signal_1s, -5.0, N, RA)
    a = np.asarray(pitch_shift(signal_1s, -5.0))
    b = np.asarray(pitch_shift(signal_1s, -5.0, PvocConfig(fft_backend="matmul")))
    assert len(a) == len(b)
    m = min(len(a), len(ref))
    assert interior_rel_err(a[:m], ref[:m]) < 1e-4
    assert interior_rel_err(b[:m], ref[:m]) < 1e-4


def test_default_backend_inside_shard_map(signal_4s):
    """The default backend composes with the sequence-parallel program."""
    import jax
    from jax.sharding import Mesh

    from phase_vocoder.parallel.chunked import chunked_time_stretch

    mesh = Mesh(np.array(jax.devices()[:4]), ("seq",))
    a = np.asarray(chunked_time_stretch(signal_4s, 2.0, PvocConfig(), mesh=mesh))
    b = np.asarray(time_stretch(signal_4s, 2.0, PvocConfig(fft_backend="matmul")))
    assert interior_rel_err(a, b) < 1e-4


def test_unknown_backend_rejected():
    with pytest.raises(ValueError, match="fft_backend"):
        PvocConfig(fft_backend="pallas")
