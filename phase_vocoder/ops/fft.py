"""FFT dispatch (reference components C6/C10: cuFFT -> XLA FFT / DFT matmul).

Two interchangeable backends, both returning/consuming (real, imag) pairs:

  * "xla" (default): jnp.fft.rfft / irfft. XLA lowers these to its FFT op,
    which on the GPU calls cuFFT — the library the reference used.
    O(N log N) work per frame.
  * "matmul": the DFT evaluated as two real matrix products against
    precomputed cos/sin matrices, with the Hann window folded into the
    matrices. O(N^2) work per frame, but a single dense product per
    transform; an independent implementation that tests compare against.

The inverse matmul reproduces numpy irfft semantics: imaginary parts of bins
0 and N/2 are dropped (their sin rows are identically zero).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# The DFT matmuls MUST run at full float32 precision. At default precision
# XLA may run an f32 product in TF32 on the GPU (about three decimal
# digits), which would break the 1e-4 waveform gate.
_PRECISION = jax.lax.Precision.HIGHEST


@functools.lru_cache(maxsize=16)
def _dft_matrices(n_fft: int, window: bool) -> tuple[np.ndarray, np.ndarray]:
    """Forward DFT matrices Fc, Fs of shape (n_fft, n_bins), float32.

    re = frames @ Fc ; im = frames @ Fs  (equals rfft(frames * w) when
    window=True, rfft(frames) otherwise).
    Built in float64, cast to float32.
    """
    k = np.arange(n_fft // 2 + 1, dtype=np.float64)
    t = np.arange(n_fft, dtype=np.float64)
    ang = 2.0 * np.pi * np.outer(t, k) / n_fft  # (n_fft, n_bins)
    fc = np.cos(ang)
    fs = -np.sin(ang)
    if window:
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / n_fft)  # periodic Hann
        fc *= w[:, None]
        fs *= w[:, None]
    return fc.astype(np.float32), fs.astype(np.float32)


@functools.lru_cache(maxsize=16)
def _idft_matrices(n_fft: int, window: bool) -> tuple[np.ndarray, np.ndarray]:
    """Inverse matrices Ic, Is of shape (n_bins, n_fft), float32.

    x = re @ Ic + im @ Is  (equals irfft(re + 1j*im) * w when window=True).
    Bin weights: w_0 = w_{N/2} = 1, else 2 (hermitian fold), all / N.
    """
    n_bins = n_fft // 2 + 1
    k = np.arange(n_bins, dtype=np.float64)
    t = np.arange(n_fft, dtype=np.float64)
    wk = np.full(n_bins, 2.0)
    wk[0] = 1.0
    if n_fft % 2 == 0:
        wk[-1] = 1.0
    ang = 2.0 * np.pi * np.outer(k, t) / n_fft  # (n_bins, n_fft)
    ic = (wk[:, None] / n_fft) * np.cos(ang)
    is_ = -(wk[:, None] / n_fft) * np.sin(ang)
    if window:
        w = 0.5 - 0.5 * np.cos(2.0 * np.pi * t / n_fft)
        ic *= w[None, :]
        is_ *= w[None, :]
    return ic.astype(np.float32), is_.astype(np.float32)


def rfft(
    frames: jnp.ndarray, backend: str = "matmul", fused_window: bool = False
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Batched real FFT over the last axis. Returns (re, im), each (..., n_bins).

    With fused_window=True (matmul backend only) the periodic Hann analysis
    window is folded into the DFT matrices and `frames` must be UNwindowed.
    """
    n_fft = frames.shape[-1]
    if backend == "xla":
        if fused_window:
            raise ValueError("fused_window requires the matmul backend")
        x = jnp.fft.rfft(frames, axis=-1)
        return x.real.astype(frames.dtype), x.imag.astype(frames.dtype)
    if backend == "matmul":
        fc, fs = _dft_matrices(n_fft, fused_window)
        fc = jnp.asarray(fc, dtype=frames.dtype)
        fs = jnp.asarray(fs, dtype=frames.dtype)
        re = jnp.matmul(frames, fc, preferred_element_type=jnp.float32, precision=_PRECISION)
        im = jnp.matmul(frames, fs, preferred_element_type=jnp.float32, precision=_PRECISION)
        return re.astype(frames.dtype), im.astype(frames.dtype)
    raise ValueError(f"unknown fft backend {backend!r}")


def irfft(
    re: jnp.ndarray,
    im: jnp.ndarray,
    n_fft: int,
    backend: str = "matmul",
    fused_window: bool = False,
) -> jnp.ndarray:
    """Batched inverse real FFT. Returns (..., n_fft) real frames.

    With fused_window=True (matmul backend only) the synthesis Hann window is
    folded in: output equals irfft(Y) * w.
    """
    if backend == "xla":
        if fused_window:
            raise ValueError("fused_window requires the matmul backend")
        return jnp.fft.irfft(re + 1j * im, n=n_fft, axis=-1).astype(re.dtype)
    if backend == "matmul":
        ic, is_ = _idft_matrices(n_fft, fused_window)
        ic = jnp.asarray(ic, dtype=re.dtype)
        is_ = jnp.asarray(is_, dtype=re.dtype)
        out = jnp.matmul(re, ic, preferred_element_type=jnp.float32, precision=_PRECISION)
        out = out + jnp.matmul(im, is_, preferred_element_type=jnp.float32, precision=_PRECISION)
        return out.astype(re.dtype)
    raise ValueError(f"unknown fft backend {backend!r}")
