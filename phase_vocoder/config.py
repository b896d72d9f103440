"""Frozen configuration for the phase vocoder.

One dataclass carries every static parameter (SURVEY.md SS5 "Config / flag
system"); it is hashable so it participates in jit cache keys naturally.
"""

from __future__ import annotations

import dataclasses
from typing import Literal

FFTBackend = Literal["xla", "matmul"]
PhaseMethod = Literal["wrapped_scan", "cumsum"]
OLAMethod = Literal["auto", "fold", "scatter"]


@dataclasses.dataclass(frozen=True)
class PvocConfig:
    """Static phase-vocoder parameters.

    Attributes:
      n_fft: FFT size N (frame length). Canonical: 1024.
      hop: analysis hop Ra in samples. Canonical: 256.
      sample_rate: audio sample rate in Hz (metadata only; the DSP is
        sample-rate agnostic). Canonical: 16000.
      fft_backend: "xla" uses jnp.fft.rfft/irfft, which XLA hands to the
        device's FFT library (cuFFT on the GPU) — the default, chosen by
        measurement on the card (CHANGES.md). "matmul" evaluates the DFT as
        two real float32 matrix products at Precision.HIGHEST with the Hann
        window folded into the matrices — O(N^2) work per frame instead of
        O(N log N); kept as a second, independent implementation.
      phase_method: "wrapped_scan" accumulates synthesis phase modulo 2*pi
        with an associative scan plus an exact integer-arithmetic linear
        term — numerically stable for arbitrarily long audio in float32.
        "cumsum" is the naive prefix sum (matches the golden model's
        recurrence directly; drifts in f32 beyond ~10^5 frames).
      ola_method: overlap-add strategy. "fold" uses a scatter-free
        reshape reduction for any hop; "scatter" uses XLA scatter-add;
        "auto" picks fold.
      dtype: compute dtype for waveform/spectral data. Phase math never runs
        below float32 (bf16 mantissa destroys phase — SURVEY.md SS7).
    """

    n_fft: int = 1024
    hop: int = 256
    sample_rate: int = 16000
    fft_backend: FFTBackend = "xla"
    phase_method: PhaseMethod = "wrapped_scan"
    ola_method: OLAMethod = "auto"
    dtype: str = "float32"

    def __post_init__(self):
        if self.n_fft <= 0 or self.n_fft % 2 != 0:
            raise ValueError(f"n_fft must be positive and even, got {self.n_fft}")
        if not (0 < self.hop <= self.n_fft):
            raise ValueError(f"hop must be in (0, n_fft], got {self.hop}")
        if self.fft_backend not in ("xla", "matmul"):
            raise ValueError(f"unknown fft_backend {self.fft_backend!r}")

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1

    def synthesis_hop(self, stretch: float) -> int:
        """Rs = round(Ra * stretch); quantizes the ratio like the reference."""
        rs = int(round(self.hop * stretch))
        if rs <= 0:
            raise ValueError(f"stretch {stretch} gives non-positive synthesis hop")
        return rs
