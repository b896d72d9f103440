"""Metrics / observability (SURVEY.md SS5).

Emits the judge metric — audio-seconds processed per wall-clock second —
as JSON lines.
"""

from __future__ import annotations

import json
import sys


def audio_seconds_per_second(
    n_samples: int, sample_rate: int, wall_seconds: float
) -> float:
    return (n_samples / sample_rate) / max(wall_seconds, 1e-12)


def emit_metric(metric: str, value: float, unit: str, stream=None, **extra) -> dict:
    """Print one JSON metrics line and return it."""
    rec = {"metric": metric, "value": value, "unit": unit}
    rec.update(extra)
    print(json.dumps(rec), file=stream or sys.stdout, flush=True)
    return rec
