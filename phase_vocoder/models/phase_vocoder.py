"""PhaseVocoder — the flagship model of the framework.

A thin, stateless facade over the pipeline + parallel layers: one object
carrying a PvocConfig with methods for every capability of the reference
CLI tool (time-stretch, pitch-shift, identity resynthesis) and the
extensions (batched data-parallel TSM, sequence-parallel chunked TSM).

"Model" in the sense of a configured, deployable signal-processing program —
the reference has no learned weights (SURVEY.md SS1: no model zoo), so the
flagship model's "forward step" is the stretch pipeline itself; that is what
__graft_entry__.entry() exposes for compile checks.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from ..config import PvocConfig
from .. import pipeline


@dataclasses.dataclass(frozen=True)
class PhaseVocoder:
    """Configured phase-vocoder model.

    Example:
        pv = PhaseVocoder(PvocConfig(n_fft=1024, hop=256))
        y = pv.time_stretch(x, 2.0)
        y = pv.pitch_shift(x, semitones=-5)
    """

    config: PvocConfig = PvocConfig()

    def analyze(self, x) -> tuple[jnp.ndarray, jnp.ndarray]:
        """Windowed STFT -> (mag, phi)."""
        return pipeline.analyze(jnp.asarray(x, jnp.dtype(self.config.dtype)), self.config)

    def time_stretch(self, x, stretch: float) -> jnp.ndarray:
        return pipeline.time_stretch(x, stretch, self.config)

    def pitch_shift(self, x, semitones: float) -> jnp.ndarray:
        return pipeline.pitch_shift(x, semitones, self.config)

    def __call__(self, x, stretch: float = 1.0) -> jnp.ndarray:
        return self.time_stretch(x, stretch)

    def batch_time_stretch(self, xs, stretch: float, mesh=None) -> jnp.ndarray:
        """Data-parallel TSM over a batch of equal-length utterances."""
        from ..parallel.batch import batch_time_stretch

        return batch_time_stretch(xs, stretch, self.config, mesh=mesh)

    def chunked_time_stretch(self, x, stretch: float, mesh=None) -> jnp.ndarray:
        """Sequence-parallel TSM of one long recording over a device mesh."""
        from ..parallel.chunked import chunked_time_stretch

        return chunked_time_stretch(x, stretch, self.config, mesh=mesh)

    def stream_time_stretch(self, x, stretch: float, **kw) -> jnp.ndarray:
        """Compile-once segmented TSM for recordings of any length."""
        from ..streaming import stream_time_stretch

        return stream_time_stretch(x, stretch, self.config, **kw)

    def checkpointed_time_stretch(
        self, x, stretch: float, checkpoint_dir: str, **kw
    ) -> jnp.ndarray:
        """Segmented TSM with crash recovery at segment-batch granularity."""
        from ..utils.checkpoint import checkpointed_stream_time_stretch

        return checkpointed_stream_time_stretch(
            x, stretch, self.config, checkpoint_dir=checkpoint_dir, **kw
        )

    def output_length(self, in_len: int, stretch: float) -> int:
        return pipeline.stretch_output_length(in_len, self.config, stretch)
