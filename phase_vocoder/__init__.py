"""Phase-vocoder framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
davispolito/Phase-Vocoder (single-GPU CUDA time-scale modification):
windowed STFT analysis, instantaneous-frequency phase unwrapping,
frequency-domain time-stretch / pitch-shift, and overlap-add resynthesis —
plus capabilities the reference lacks: data-parallel utterance batches and
sequence-parallel chunking of long recordings over a device mesh with halo
exchange and collective phase-state carry.

Quick start:
    import phase_vocoder as pv
    y = pv.time_stretch(x, 2.0)                  # one device
    y = pv.pitch_shift(x, semitones=7)
    ys = pv.batch_time_stretch(xs, 2.0)          # data-parallel batch
    y = pv.chunked_time_stretch(x, 2.0, mesh)    # sequence-parallel
"""

from .config import PvocConfig
from .pipeline import (
    analyze,
    pitch_shift,
    stretch_output_length,
    synthesize,
    time_stretch,
)
from .models import PhaseVocoder
from .parallel import (
    batch_time_stretch,
    batch_time_stretch_ragged,
    batch_time_stretch_varied,
    chunked_time_stretch,
    make_mesh,
    make_mesh_2d,
)

__version__ = "0.1.0"

__all__ = [
    "PvocConfig",
    "PhaseVocoder",
    "analyze",
    "synthesize",
    "time_stretch",
    "pitch_shift",
    "stretch_output_length",
    "batch_time_stretch",
    "batch_time_stretch_ragged",
    "batch_time_stretch_varied",
    "chunked_time_stretch",
    "make_mesh",
    "make_mesh_2d",
    "__version__",
]
