"""Distributed-logic tests on the fake 8-device CPU mesh (SURVEY.md SS4.4).

The sharded programs must equal the single-device pipeline (same math,
different reduction grouping -> 1e-5 tolerance) and the f64 golden model
(<1e-4, the driver gate). Halo exchange, phase-state carry, and OLA tail
stitching are all exercised here with no accelerator.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from golden import pv_ref
from phase_vocoder import (
    PhaseVocoder,
    PvocConfig,
    batch_time_stretch,
    batch_time_stretch_varied,
    chunked_time_stretch,
    make_mesh,
    time_stretch,
)
from tests.conftest import make_test_signal

N, RA = 1024, 256


def interior_rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


def test_eight_fake_devices():
    assert jax.device_count() >= 8, jax.devices()


# ------------------------------------------------------------- data parallel


def test_batch_matches_single(signal_1s):
    xs = np.stack([signal_1s, signal_1s[::-1], -signal_1s, 0.5 * signal_1s])
    mesh = make_mesh(4, axis="data")
    ys = np.asarray(batch_time_stretch(xs, 2.0, PvocConfig(), mesh=mesh))
    for i in range(4):
        single = np.asarray(time_stretch(xs[i], 2.0))
        assert interior_rel_err(ys[i], single) < 1e-5


def test_batch_varied_ratios_and_lengths():
    xs = [make_test_signal(s, seed=i) for i, s in enumerate([1.0, 0.7, 1.3, 0.5])]
    ratios = [0.5, 1.0, 2.0, 2.0]
    ys = batch_time_stretch_varied(xs, ratios, PvocConfig())
    for x, r, y in zip(xs, ratios, ys):
        single = np.asarray(time_stretch(x, r))
        assert len(y) == len(single)
        # 5e-5: padding changes the associative-scan tree, and princarg
        # branch flips at near-zero-magnitude bins add bounded waveform
        # noise; the hard 1e-4 contract is vs golden (test below).
        assert interior_rel_err(y, single) < 5e-5


def test_batch_64_utterances_data_mesh():
    """BASELINE config 4 at its canonical size: a ragged 64-utterance batch
    sharded over 'data' (8 devices x 8 rows), vs single-device runs and vs
    golden."""
    rng = np.random.default_rng(7)
    xs = [
        make_test_signal(float(rng.uniform(0.4, 0.9)), seed=100 + i)
        for i in range(64)
    ]
    mesh = make_mesh(8, axis="data")
    ys = batch_time_stretch_varied(xs, [2.0] * 64, PvocConfig(), mesh=mesh)
    for i in (0, 13, 37, 63):
        single = np.asarray(time_stretch(xs[i], 2.0))
        assert len(ys[i]) == len(single)
        assert interior_rel_err(ys[i], single) < 5e-5
    ref = pv_ref.phase_vocoder(xs[5], 2.0, N, RA)
    assert interior_rel_err(ys[5], ref) < 1e-4


# --------------------------------------------------------- sequence parallel


@pytest.mark.parametrize("stretch", [0.5, 1.0, 2.0])
@pytest.mark.parametrize("devices", [2, 8])
def test_chunked_matches_single(stretch, devices, signal_4s):
    mesh = make_mesh(devices, axis="seq")
    y_chunked = np.asarray(chunked_time_stretch(signal_4s, stretch, mesh=mesh))
    y_single = np.asarray(time_stretch(signal_4s, stretch))
    assert len(y_chunked) == len(y_single)
    # 5e-5: chunking regroups the wrapped associative scan and princarg
    # branch flips at near-zero-magnitude bins add bounded noise that grows
    # mildly with device count; the hard 1e-4 contract is vs golden below.
    err = interior_rel_err(y_chunked, y_single)
    assert err < 5e-5, f"chunked vs single rel err {err:.3e}"


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_chunked_matches_golden(stretch, signal_4s):
    """The driver gate holds for the sharded path too."""
    mesh = make_mesh(8, axis="seq")
    y = np.asarray(chunked_time_stretch(signal_4s, stretch, mesh=mesh))
    ref = pv_ref.phase_vocoder(signal_4s, stretch, N, RA)
    assert len(y) == len(ref)
    err = interior_rel_err(y, ref)
    assert err < 1e-4, f"chunked vs golden rel err {err:.3e}"


def test_chunked_non_divisible_frames():
    """Frame count not divisible by device count (padding path)."""
    x = make_test_signal(1.9)  # odd number of frames
    mesh = make_mesh(8, axis="seq")
    y = np.asarray(chunked_time_stretch(x, 2.0, mesh=mesh))
    single = np.asarray(time_stretch(x, 2.0))
    assert len(y) == len(single)
    assert interior_rel_err(y, single) < 5e-5


def test_chunked_accepts_input_committed_to_one_device(signal_4s):
    """An input placed on one device is moved onto the mesh, not refused."""
    x = jax.device_put(jnp.asarray(signal_4s, jnp.float32), jax.devices()[0])
    mesh = make_mesh(4, axis="seq")
    y = np.asarray(chunked_time_stretch(x, 2.0, mesh=mesh))
    single = np.asarray(time_stretch(signal_4s, 2.0))
    assert interior_rel_err(y, single) < 5e-5


def test_chunked_short_input_falls_back():
    x = make_test_signal(0.2)  # too short to split over 8 devices
    mesh = make_mesh(8, axis="seq")
    y = np.asarray(chunked_time_stretch(x, 2.0, mesh=mesh))
    single = np.asarray(time_stretch(x, 2.0))
    assert np.array_equal(y, single)


def test_chunked_long_audio_phase_stability():
    """Minute-long audio: wrapped carry keeps psi exact across many chunks."""
    x = make_test_signal(60.0)
    mesh = make_mesh(8, axis="seq")
    y = np.asarray(chunked_time_stretch(x, 2.0, mesh=mesh))
    single = np.asarray(time_stretch(x, 2.0))
    assert interior_rel_err(y, single) < 5e-5


def test_model_facade(signal_1s):
    pv = PhaseVocoder()
    mesh = make_mesh(8, axis="seq")
    y = np.asarray(pv.chunked_time_stretch(make_test_signal(4.0), 2.0, mesh=mesh))
    assert len(y) > 0
    y2 = np.asarray(pv.time_stretch(signal_1s, 1.0))
    assert len(y2) == len(np.asarray(pv_ref.phase_vocoder(signal_1s, 1.0, N, RA)))
