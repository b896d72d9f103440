"""WAV read/write (reference component C2 — RIFF parse, PCM16<->float).

The reference hand-rolls RIFF parsing in C++ on the host. Here the host I/O
path prefers the native C extension (native/pvwav — C++ RIFF parser with
vectorized PCM16<->float conversion, see phase_vocoder/io/native.py) and
falls back to scipy.io.wavfile. Audio is normalized to float32 mono in
[-1, 1); multi-channel files are averaged to mono (matching the canonical
"mono 16 kHz WAV" operating point, BASELINE.json:7).
"""

from __future__ import annotations

import numpy as np

try:  # native C++ RIFF parser (built via `make -C native`)
    from . import native as _native
except Exception:  # pragma: no cover - native module optional
    _native = None

from scipy.io import wavfile as _scipy_wav


def read_wav(path: str, mono: bool = True) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 samples in [-1, 1), sample_rate).

    Supports PCM16/PCM32/float32/float64 payloads (PCM8 via scipy fallback).
    """
    if _native is not None and _native.available():
        data, sr = _native.read_wav(path)
    else:
        sr, data = _scipy_wav.read(path)
        data = _pcm_to_float(data)
    if mono and data.ndim == 2:
        data = data.mean(axis=1, dtype=np.float32)
    return np.ascontiguousarray(data, dtype=np.float32), int(sr)


def write_wav(path: str, data: np.ndarray, sample_rate: int, pcm16: bool = True) -> None:
    """Write float samples to a WAV file (PCM16 by default, else float32)."""
    data = np.asarray(data)
    if pcm16:
        clipped = np.clip(data, -1.0, 32767.0 / 32768.0)
        if _native is not None and _native.available():
            _native.write_wav(path, np.ascontiguousarray(clipped, np.float32), sample_rate)
            return
        pcm = np.round(clipped * 32768.0).astype(np.int16)
        _scipy_wav.write(path, sample_rate, pcm)
    else:
        _scipy_wav.write(path, sample_rate, data.astype(np.float32))


def _pcm_to_float(data: np.ndarray) -> np.ndarray:
    if data.dtype == np.int16:
        return (data / 32768.0).astype(np.float32)
    if data.dtype == np.int32:
        return (data / 2147483648.0).astype(np.float32)
    if data.dtype == np.uint8:
        return ((data.astype(np.float32) - 128.0) / 128.0).astype(np.float32)
    if data.dtype in (np.float32, np.float64):
        return data.astype(np.float32)
    raise ValueError(f"unsupported WAV sample format {data.dtype}")
