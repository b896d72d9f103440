"""WAV I/O round-trip tests: native C++ path and scipy fallback (SS4.2)."""

import numpy as np
import pytest

from phase_vocoder.io import native, wav
from tests.conftest import make_test_signal


def test_native_available():
    """The native lib builds in this environment (make -C native)."""
    assert native.available()


def test_pcm16_round_trip(tmp_path):
    x = make_test_signal(0.25)
    p = str(tmp_path / "t.wav")
    wav.write_wav(p, x, 16000)
    y, sr = wav.read_wav(p)
    assert sr == 16000
    assert len(y) == len(x)
    # PCM16 quantization bound.
    assert np.max(np.abs(y - x)) <= 2 ** -15 + 1e-9


def test_native_matches_scipy_read(tmp_path):
    from scipy.io import wavfile

    x = (make_test_signal(0.1) * 32767).astype(np.int16)
    p = str(tmp_path / "s.wav")
    wavfile.write(p, 16000, x)
    data, sr = native.read_wav(p)
    assert sr == 16000
    assert np.allclose(data, x / 32768.0, atol=1e-7)


def test_native_float32_payload(tmp_path):
    from scipy.io import wavfile

    x = make_test_signal(0.1).astype(np.float32)
    p = str(tmp_path / "f.wav")
    wavfile.write(p, 16000, x)
    data, sr = native.read_wav(p)
    assert np.allclose(data, x, atol=1e-7)


def test_stereo_downmix(tmp_path):
    from scipy.io import wavfile

    l = make_test_signal(0.1).astype(np.float32)
    r = -l
    p = str(tmp_path / "st.wav")
    wavfile.write(p, 16000, np.stack([l, r], axis=1))
    y, sr = wav.read_wav(p, mono=True)
    assert np.max(np.abs(y)) < 1e-6  # L+R cancels


def test_write_clips_out_of_range(tmp_path):
    p = str(tmp_path / "c.wav")
    wav.write_wav(p, np.array([2.0, -2.0, 0.5], np.float32), 16000)
    y, _ = wav.read_wav(p)
    assert abs(y[0] - 32767 / 32768) < 1e-6
    assert abs(y[1] + 1.0) < 1e-6
