"""Streaming segmented executor parity (compile-once any-length path)."""

import numpy as np
import pytest

from golden import pv_ref
from phase_vocoder import time_stretch
from phase_vocoder.streaming import stream_time_stretch
from tests.conftest import make_test_signal

N = 1024


def interior_rel_err(a, b, edge=N):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    assert len(a) == len(b), (len(a), len(b))
    sl = slice(edge, len(a) - edge)
    return np.max(np.abs(a[sl] - b[sl])) / np.max(np.abs(b[sl]))


@pytest.mark.parametrize("stretch", [0.5, 1.0, 2.0])
def test_stream_matches_single(stretch, signal_4s):
    y_stream = np.asarray(stream_time_stretch(signal_4s, stretch, segment_frames=40))
    y_single = np.asarray(time_stretch(signal_4s, stretch))
    assert len(y_stream) == len(y_single)
    err = interior_rel_err(y_stream, y_single)
    assert err < 5e-5, err  # scan regrouping + branch noise (see test_parallel)


@pytest.mark.parametrize("stretch", [0.5, 2.0])
def test_stream_matches_golden(stretch, signal_1s):
    y = np.asarray(stream_time_stretch(signal_1s, stretch, segment_frames=13))
    ref = pv_ref.phase_vocoder(signal_1s, stretch, N, 256)
    assert len(y) == len(ref)
    err = interior_rel_err(y, ref)
    assert err < 1e-4, err


def test_stream_single_segment_degenerate(signal_1s):
    """Segment larger than the recording: one masked segment."""
    y = np.asarray(stream_time_stretch(signal_1s, 2.0, segment_frames=4096))
    y_single = np.asarray(time_stretch(signal_1s, 2.0))
    assert len(y) == len(y_single)
    assert interior_rel_err(y, y_single) < 5e-5


def test_stream_exact_segment_boundary():
    """Frame count an exact multiple of the segment size."""
    # 10 segments of 16 frames: T = N + Ra*(160-1)
    t_len = 1024 + 256 * 159
    x = make_test_signal(t_len / 16000)
    assert len(x) == t_len
    y = np.asarray(stream_time_stretch(x, 2.0, segment_frames=16))
    y_single = np.asarray(time_stretch(x, 2.0))
    assert len(y) == len(y_single)
    assert interior_rel_err(y, y_single) < 5e-5


def test_stream_long_audio_stability():
    """2 minutes through many small segments: wrapped carry stays exact."""
    x = make_test_signal(120.0)
    y = np.asarray(stream_time_stretch(x, 2.0, segment_frames=256))
    y_single = np.asarray(time_stretch(x, 2.0))
    assert interior_rel_err(y, y_single) < 5e-5
