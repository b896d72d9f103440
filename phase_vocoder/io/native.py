"""ctypes binding for the native C++ WAV module (native/pvwav.cpp).

The shared library is built from the committed source at first use with
`make -C native` (plain g++, no pybind11), under a file lock so that
concurrent processes build it once. If it cannot be built (no compiler),
the scipy fallback in io/wav.py takes over.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess

import numpy as np

_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)
_LIB_PATH = os.path.join(_NATIVE_DIR, "libpvwav.so")
_lib = None
_build_failed = False


def _build() -> bool:
    """Run `make -C native` once per machine; True if the library exists."""
    global _build_failed
    if _build_failed or not os.path.exists(os.path.join(_NATIVE_DIR, "pvwav.cpp")):
        return os.path.exists(_LIB_PATH)
    with open(os.path.join(_NATIVE_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            subprocess.run(
                ["make", "-s", "-C", _NATIVE_DIR, "libpvwav.so"],
                check=True, capture_output=True, timeout=300,
            )
        except (OSError, subprocess.SubprocessError):
            _build_failed = True
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return os.path.exists(_LIB_PATH)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _build():
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.pvwav_read.restype = ctypes.c_int
    lib.pvwav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.pvwav_free.restype = None
    lib.pvwav_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
    lib.pvwav_write.restype = ctypes.c_int
    lib.pvwav_write.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
        ctypes.c_int,
        ctypes.c_int,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 array, sample_rate). 2-D if multichannel."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native pvwav library not built (run: make -C native)")
    out = ctypes.POINTER(ctypes.c_float)()
    n_frames = ctypes.c_int64()
    channels = ctypes.c_int()
    sr = ctypes.c_int()
    rc = lib.pvwav_read(
        path.encode(), ctypes.byref(out), ctypes.byref(n_frames),
        ctypes.byref(channels), ctypes.byref(sr),
    )
    if rc != 0:
        raise IOError(f"pvwav_read({path!r}) failed with code {rc}")
    try:
        total = n_frames.value * channels.value
        data = np.ctypeslib.as_array(out, shape=(total,)).copy()
    finally:
        lib.pvwav_free(out)
    if channels.value > 1:
        data = data.reshape(n_frames.value, channels.value)
    return data, sr.value


def write_wav(path: str, data: np.ndarray, sample_rate: int) -> None:
    """Write float32 samples (1-D mono or 2-D interleaved) as PCM16."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native pvwav library not built (run: make -C native)")
    data = np.ascontiguousarray(data, dtype=np.float32)
    if data.ndim == 1:
        n_frames, channels = data.shape[0], 1
    elif data.ndim == 2:
        n_frames, channels = data.shape
    else:
        raise ValueError("data must be 1-D or 2-D")
    rc = lib.pvwav_write(
        path.encode(),
        data.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n_frames,
        channels,
        sample_rate,
    )
    if rc != 0:
        raise IOError(f"pvwav_write({path!r}) failed with code {rc}")
