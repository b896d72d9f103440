"""Tracing/profiling hooks (SURVEY.md SS5 "Tracing / profiling").

The reference's instrumentation ceiling is cudaEvent wall-clock timing.
Here every pipeline stage runs under jax.named_scope (pvoc_analyze /
pvoc_tsm / pvoc_synthesize), so a jax.profiler trace attributes device
time per stage; this module adds the entry point.
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(trace_dir: str | None):
    """Capture a profiler trace (view with TensorBoard / Perfetto).

    No-op when trace_dir is None so call sites can pass the CLI flag
    straight through.
    """
    if not trace_dir:
        yield
        return
    with jax.profiler.trace(trace_dir):
        yield
