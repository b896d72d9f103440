"""Single-device phase-vocoder pipeline (reference component C3, rebuilt).

The reference's host orchestrator launches a sequence of CUDA kernels with
two H2D/D2H crossings (SURVEY.md SS3.2). Here the whole
analysis->modify->synthesis chain is ONE jitted XLA program — a single
device computation, compiled once per (input length, config, stretch) and
cached.

Stage map (reference CUDA kernel -> this program):
  frame+window kernel      -> framing.frame_signal (+ window)
  cufftExecR2C             -> ops.fft.rfft        (XLA FFT op or DFT matmul)
  cart2polar kernel        -> jnp hypot/arctan2   (fused elementwise)
  unwrap+accumulate kernel -> ops.phase           (associative scan)
  polar2cart kernel        -> jnp cos/sin         (fused elementwise)
  cufftExecC2R             -> ops.fft.irfft
  atomicAdd OLA kernel     -> framing.overlap_add (segmented reduction)
  normalize kernel         -> elementwise divide by OLA'd window^2
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .config import PvocConfig
from .ops import fft as fft_ops
from .ops import framing, phase
from .ops.resample import resample_linear
from .ops.window import hann_window

__all__ = [
    "analyze",
    "synthesize",
    "synthesize_frames",
    "stretch_frames",
    "stretch_polar",
    "time_stretch",
    "pitch_shift",
    "stretch_output_length",
]

# Frame count above which time_stretch and pitch_shift hand a recording to
# the streaming executor (~65 s at 16 kHz / hop 256): its compile cost and
# live memory do not grow with the recording.
MAX_MONOLITHIC_FRAMES = 4096


def stretch_output_length(in_len: int, cfg: PvocConfig, stretch: float) -> int:
    nf = framing.num_frames(in_len, cfg.n_fft, cfg.hop)
    return framing.output_length(nf, cfg.n_fft, cfg.synthesis_hop(stretch))


def analyze(x: jnp.ndarray, cfg: PvocConfig) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Windowed STFT -> (mag, phi), each (nf, n_bins)."""
    with jax.named_scope("pvoc_analyze"):
        frames = framing.frame_signal(x, cfg.n_fft, cfg.hop)
        if cfg.fft_backend == "xla":
            w = hann_window(cfg.n_fft, dtype=x.dtype)
            re, im = fft_ops.rfft(frames * w, backend="xla")
        else:
            re, im = fft_ops.rfft(frames, backend="matmul", fused_window=True)
        mag = jnp.sqrt(re * re + im * im)
        phi = jnp.arctan2(im, re)
        return mag, phi


def stretch_polar(
    mag: jnp.ndarray, phi: jnp.ndarray, cfg: PvocConfig, rs: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Frequency-domain TSM in polar form: (mag, accumulated synthesis phase)."""
    with jax.named_scope("pvoc_tsm"):
        dphi = phase.heterodyne_increment(phi, cfg.hop, cfg.n_fft)
        psi = phase.accumulate_phase(
            phi, dphi, cfg.hop, rs, cfg.n_fft, method=cfg.phase_method
        )
        return mag, psi


def stretch_frames(
    mag: jnp.ndarray, phi: jnp.ndarray, cfg: PvocConfig, rs: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Frequency-domain TSM: rebuild (re, im) with accumulated synthesis phase."""
    mag, psi = stretch_polar(mag, phi, cfg, rs)
    return mag * jnp.cos(psi), mag * jnp.sin(psi)


def synthesize_frames(
    re: jnp.ndarray,
    im: jnp.ndarray,
    cfg: PvocConfig,
    frame_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Inverse FFT times the synthesis window: (nf, n_fft) time frames.

    frame_mask: optional (nf,) 0/1 weights; masked frames are zeroed.
    """
    if cfg.fft_backend == "xla":
        w = hann_window(cfg.n_fft, dtype=re.dtype)
        y_frames = fft_ops.irfft(re, im, cfg.n_fft, backend="xla") * w
    else:
        y_frames = fft_ops.irfft(
            re, im, cfg.n_fft, backend="matmul", fused_window=True
        )
    if frame_mask is not None:
        y_frames = y_frames * frame_mask[:, None].astype(y_frames.dtype)
    return y_frames


def synthesize(
    re: jnp.ndarray,
    im: jnp.ndarray,
    cfg: PvocConfig,
    rs: int,
    frame_mask: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Inverse FFT, synthesis window, overlap-add, COLA normalization.

    frame_mask: optional (nf,) 0/1 weights marking valid frames — padding
    frames (batched ragged utterances, sequence-parallel tail chunks) are
    zeroed in both the signal and the window-energy normalization so the
    result matches an unpadded run exactly.
    """
    with jax.named_scope("pvoc_synthesize"):
        y_frames = synthesize_frames(re, im, cfg, frame_mask=frame_mask)
        out = framing.overlap_add(y_frames, rs, method=cfg.ola_method)
        w = hann_window(cfg.n_fft, dtype=re.dtype)
        norm = framing.ola_window_norm(
            w, y_frames.shape[0], rs, method=cfg.ola_method, frame_mask=frame_mask
        )
        return out / norm


def _stretch(x: jnp.ndarray, cfg: PvocConfig, rs: int) -> jnp.ndarray:
    mag, phi = analyze(x, cfg)
    re, im = stretch_frames(mag, phi, cfg, rs)
    return synthesize(re, im, cfg, rs)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _time_stretch_jit(x: jnp.ndarray, cfg: PvocConfig, rs: int) -> jnp.ndarray:
    return _stretch(x, cfg, rs)


def time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    max_monolithic_frames: int = MAX_MONOLITHIC_FRAMES,
) -> jnp.ndarray:
    """Time-scale-modify a 1-D waveform by `stretch` (duration multiplier).

    Pitch is preserved; output length ~= stretch * input length. Short
    inputs run as one jitted program; recordings beyond
    `max_monolithic_frames` route through the streaming segmented executor
    (same per-frame math, segment-wise phase carry).
    """
    dtype = jnp.dtype(cfg.dtype)
    x = jnp.asarray(x, dtype=dtype)
    rs = cfg.synthesis_hop(stretch)
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    if nf <= 0:
        return jnp.zeros((0,), dtype=dtype)
    if nf > max_monolithic_frames:
        from . import streaming

        return streaming.stream_time_stretch(x, stretch, cfg)
    return _time_stretch_jit(x, cfg, rs)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4))
def _pitch_shift_jit(x, cfg: PvocConfig, rs: int, factor: float, out_len: int):
    return resample_linear(_stretch(x, cfg, rs), 1.0 / factor, out_len)


def pitch_shift(
    x,
    semitones: float,
    cfg: PvocConfig = PvocConfig(),
    max_monolithic_frames: int = MAX_MONOLITHIC_FRAMES,
) -> jnp.ndarray:
    """Pitch-shift by `semitones` via time-stretch + resample (C12 parity).

    Duration is preserved; pitch moves by 2^(semitones/12). Long inputs
    stretch through the streaming executor, as in time_stretch.
    """
    dtype = jnp.dtype(cfg.dtype)
    x = jnp.asarray(x, dtype=dtype)
    factor = 2.0 ** (semitones / 12.0)
    rs = cfg.synthesis_hop(factor)
    stretched_len = stretch_output_length(x.shape[-1], cfg, factor)
    if stretched_len <= 0:
        return jnp.zeros((0,), dtype=dtype)
    out_len = int(round(stretched_len / factor))
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    if nf > max_monolithic_frames:
        from . import streaming

        y = streaming.stream_time_stretch(x, factor, cfg)
        return _resample_jit(y, factor, out_len)
    return _pitch_shift_jit(x, cfg, rs, factor, out_len)


@functools.partial(jax.jit, static_argnums=(1, 2))
def _resample_jit(y, factor: float, out_len: int):
    return resample_linear(y, 1.0 / factor, out_len)
