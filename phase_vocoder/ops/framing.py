"""Framing and overlap-add (reference components C5 and C11 — SURVEY.md SS2.1).

The reference frames with a thread-per-sample CUDA kernel and resynthesizes
with atomicAdd overlap-add. Here:

  * framing: when hop | n_fft, overlapping frames are a pure reshape+roll
    composition ("fold trick") — zero gather, pure layout ops XLA fuses away;
    otherwise a vectorized gather.
  * overlap-add: deterministic segmented reduction for ANY hop. Frames are
    zero-padded on the lane axis to K = ceil(n_fft/hop) segments of `hop`
    samples; segment j of frame i lands exactly in output block i+j, so OLA
    is K shifted pads summed — no scatter, no atomics, bitwise reproducible
    run to run (unlike the reference's atomicAdd whose summation order is
    nondeterministic). The zero lane-padding contributes nothing, so the
    result is exact for hop ∤ n_fft too (e.g. the non-octave pitch hops
    rs=342/305); "scatter" remains as the reference oracle for tests.

All functions are shape-static and jit-friendly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def num_frames(length: int, n_fft: int, hop: int) -> int:
    if length < n_fft:
        return 0
    return 1 + (length - n_fft) // hop


def output_length(nf: int, n_fft: int, hop: int) -> int:
    if nf <= 0:
        return 0
    return (nf - 1) * hop + n_fft


def frame_signal(x: jnp.ndarray, n_fft: int, hop: int) -> jnp.ndarray:
    """Overlapping frames of a 1-D signal: frames[i] = x[i*hop : i*hop+n_fft].

    Returns (nf, n_fft). Gather-based; XLA lowers this to an efficient
    dynamic-gather and fuses the subsequent windowing multiply into it.
    """
    nf = num_frames(x.shape[-1], n_fft, hop)
    if nf <= 0:
        return jnp.zeros((0, n_fft), dtype=x.dtype)
    if n_fft % hop == 0:
        # Fold trick: x[: (nf-1+K)*hop] reshaped to (nf-1+K, hop) rows; frame i
        # is rows [i, i+K). Build via K shifted row-views stacked on a new
        # axis — pure slices, no gather.
        k = n_fft // hop
        rows = x[: (nf - 1 + k) * hop].reshape(nf - 1 + k, hop)
        parts = [rows[j : j + nf] for j in range(k)]  # each (nf, hop)
        return jnp.concatenate(parts, axis=-1).reshape(nf, n_fft)
    idx = jnp.arange(nf)[:, None] * hop + jnp.arange(n_fft)[None, :]
    return x[idx]


def overlap_add(frames: jnp.ndarray, hop: int, method: str = "auto") -> jnp.ndarray:
    """Deterministic overlap-add of (nf, n_fft) frames at `hop`.

    Replaces the reference's atomicAdd kernel with a segmented reduction.
    """
    nf, n_fft = frames.shape
    if nf == 0:
        return jnp.zeros((0,), dtype=frames.dtype)
    if method == "auto":
        method = "fold"
    if method == "fold":
        k = -(-n_fft // hop)
        # Lane-pad to k*hop (exact: padded lanes are zero) so segment j of
        # frame i occupies output block (i + j) of size hop for ANY hop.
        if k * hop != n_fft:
            frames = jnp.pad(frames, ((0, 0), (0, k * hop - n_fft)))
        seg = frames.reshape(nf, k, hop)
        blocks = nf + k - 1
        out = jnp.zeros((blocks, hop), dtype=frames.dtype)
        for j in range(k):  # K is small & static (overlap factor, e.g. 2..8)
            out = out.at[j : j + nf].add(seg[:, j, :])
        return out.reshape(blocks * hop)[: output_length(nf, n_fft, hop)]
    if method == "scatter":
        length = output_length(nf, n_fft, hop)
        idx = jnp.arange(nf)[:, None] * hop + jnp.arange(n_fft)[None, :]
        return jnp.zeros((length,), dtype=frames.dtype).at[idx].add(frames)
    raise ValueError(f"unknown OLA method {method!r}")


def ola_window_norm(
    window: jnp.ndarray,
    nf: int,
    hop: int,
    eps: float = 1e-8,
    method: str = "auto",
    frame_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Overlap-added window-squared normalization, clamped at >= eps.

    frame_mask: optional (nf,) 0/1 weights — masked (padding) frames
    contribute no window energy, so a padded batched run normalizes
    identically to the unpadded per-utterance run.
    """
    n_fft = window.shape[0]
    w2 = jnp.broadcast_to(window * window, (nf, n_fft))
    if frame_mask is not None:
        w2 = w2 * frame_mask[:, None].astype(window.dtype)
    norm = overlap_add(w2, hop, method=method)
    return jnp.maximum(norm, eps)
