"""Streaming segmented execution — compile-once processing of any length.

Long recordings are processed as a lax.scan over FIXED-SHAPE segments: the
whole loop is ONE jitted program whose compile cost and live memory are
those of a single segment, independent of recording length.

Exactness: the cross-segment state is precisely the sequence-parallel carry
of parallel/chunked.py, applied serially —

  * phi_prev   — previous segment's last analysis-phase row, so the
    boundary heterodyne increment is exact;
  * psi_carry / psi_carry_lo — wrapped running sum of (Rs/Ra)*dphi terms,
    carried as a compensated (hi, lo) f32 pair (ops/phase.py TwoSum/Dekker
    arithmetic; addition mod 2*pi is associative, so segment-wise pair
    accumulation == the monolithic compensated scan). Plain f32 here drifts
    linearly with length on tonal audio — measured 2.84e-4 vs golden at
    just 60 s / 2.0x, over the 1e-4 gate — because period-locked rounding
    biases integrate; the pair carry holds ~2^-48 effective precision at
    any length (see ops/phase.py:174-189);
  * phi0       — first frame's phase (absolute phase anchor);
  * ola_tail / norm_tail — the last N-Rs overlap-add samples and their
    window-energy, added into the next segment's head before normalization.

This state (a few KB) is also the checkpoint/resume granularity for
hour-long jobs (utils/checkpoint.py).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp

from .config import PvocConfig
from .ops import framing, phase
from .ops.window import hann_window
from . import pipeline

_EPS = 1e-8

# Default segment size in frames: ~16 s of 16 kHz audio at hop 256.
DEFAULT_SEGMENT_FRAMES = 1024


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class StreamState:
    """Carried state between segments (see module docstring)."""

    phi_prev: jnp.ndarray  # (n_bins,)
    psi_carry: jnp.ndarray  # (n_bins,) hi word of the compensated pair
    psi_carry_lo: jnp.ndarray  # (n_bins,) lo word of the compensated pair
    phi0: jnp.ndarray  # (n_bins,)
    ola_tail: jnp.ndarray  # (n_fft - rs,)
    norm_tail: jnp.ndarray  # (n_fft - rs,)
    started: jnp.ndarray  # () bool — false only before the first segment
    frame_offset: jnp.ndarray  # () int32 — global index of next frame


def init_state(cfg: PvocConfig, rs: int, dtype=jnp.float32) -> StreamState:
    nb = cfg.n_bins
    tail = cfg.n_fft - rs
    if tail < 0:
        raise ValueError(f"synthesis hop {rs} exceeds n_fft {cfg.n_fft}")
    z = functools.partial(jnp.zeros, dtype=dtype)
    return StreamState(
        phi_prev=z((nb,)),
        psi_carry=z((nb,)),
        psi_carry_lo=z((nb,)),
        phi0=z((nb,)),
        ola_tail=z((tail,)),
        norm_tail=z((tail,)),
        started=jnp.zeros((), jnp.bool_),
        frame_offset=jnp.zeros((), jnp.int32),
    )


def segment_step(
    x_seg: jnp.ndarray,
    n_valid: jnp.ndarray,
    state: StreamState,
    cfg: PvocConfig,
    rs: int,
) -> tuple[jnp.ndarray, StreamState]:
    """Process one fixed-shape segment of F frames.

    x_seg: (F*Ra + N - Ra,) samples covering frames [offset, offset+F) plus
    the right halo. n_valid: () int32, number of real (non-padding) frames.
    Returns (main output (F*rs,), new state). The caller flushes the final
    ola_tail/norm_tail after the last segment.
    """
    n, ra = cfg.n_fft, cfg.hop
    F = (x_seg.shape[-1] - (n - ra)) // ra
    dtype = x_seg.dtype

    mag, phi = pipeline.analyze(x_seg, cfg)  # (F, n_bins)

    # Terms T[j] = s_{offset+j-1}: the step INTO frame offset+j. T[0] crosses
    # the segment boundary (uses phi_prev); it is zero for the first segment.
    # Terms, scan, and cross-segment carry all ride as compensated (hi, lo)
    # pairs — plain f32 wrap_add drifts linearly with length (2.84e-4 vs
    # golden at 60 s / 2.0x, over the gate; see ops/phase.py pair notes).
    with jax.named_scope("pvoc_tsm"):
        phi_ext = jnp.concatenate([state.phi_prev[None, :], phi])  # (F+1, nb)
        th, tl = phase.residual_terms_c(phi_ext, ra, rs, n)  # (F, nb) pairs
        j = jnp.arange(F)
        # Step s_{g+j-1} exists iff 0 <= g+j-1 <= nf-2, i.e. the target frame
        # g+j is real and has a predecessor. Padding frames and the very first
        # frame contribute zero (the pair identity).
        g = state.frame_offset
        valid_term = ((j < n_valid) & ((g + j) > 0))[:, None].astype(dtype)
        th, tl = th * valid_term, tl * valid_term

        incl = phase.blocked_scan(phase.wrap_add_c, (th, tl))
        res_h, res_l = phase.wrap_add_c(
            (state.psi_carry[None, :], state.psi_carry_lo[None, :]), incl
        )  # (F, nb) pair
        residual = res_h + res_l

        phi0 = jnp.where(state.started, state.phi0, phi[0])
        psi = phase.finalize_phase(phi0, residual, rs, n, frame_offset=g)
        psi = phase.pin_real_bins(psi, phi, rs, n, frame_offset=g)

    mask = (j < n_valid).astype(dtype)
    with jax.named_scope("pvoc_synthesize"):
        y_frames = pipeline.synthesize_frames(
            mag * jnp.cos(psi), mag * jnp.sin(psi), cfg, frame_mask=mask
        )
        ola = framing.overlap_add(y_frames, rs, method=cfg.ola_method)
    w = hann_window(n, dtype=dtype)
    norm = framing.ola_window_norm(w, F, rs, eps=0.0, method=cfg.ola_method,
                                   frame_mask=mask)

    tail_len = n - rs
    pad = (0, F * rs - tail_len)
    main = ola[: F * rs] + jnp.pad(state.ola_tail, pad)
    main_norm = norm[: F * rs] + jnp.pad(state.norm_tail, pad)
    main_out = main / jnp.maximum(main_norm, _EPS)

    new_state = StreamState(
        phi_prev=phi[jnp.minimum(n_valid, F) - 1],
        psi_carry=res_h[-1],
        psi_carry_lo=res_l[-1],
        phi0=phi0,
        ola_tail=ola[F * rs :],
        norm_tail=norm[F * rs :],
        started=jnp.ones((), jnp.bool_),
        frame_offset=g + jnp.minimum(n_valid, F).astype(jnp.int32),
    )
    return main_out, new_state


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _stream_scan_from(
    x_pad, state0: StreamState, nf: int, cfg: PvocConfig, rs: int, F: int,
    s_count: int,
):
    """lax.scan over `s_count` fixed-shape segments starting from `state0`.

    Segment indices come from state0.frame_offset // F, so ONE compiled
    program serves every batch of a checkpointed run (utils/checkpoint.py)
    as well as the whole-recording call.
    """
    n, ra = cfg.n_fft, cfg.hop
    s0 = state0.frame_offset // jnp.int32(F)

    def body(state, j):
        s = s0 + j
        start = s * (F * ra)
        x_seg = jax.lax.dynamic_slice(x_pad, (start,), (F * ra + n - ra,))
        n_valid = jnp.clip(nf - s * F, 0, F)
        out, state = segment_step(x_seg, n_valid, state, cfg, rs)
        return state, out

    state, outs = jax.lax.scan(body, state0, jnp.arange(s_count, dtype=jnp.int32))
    return outs.reshape(s_count * F * rs), state


def flush_tail(state: StreamState) -> jnp.ndarray:
    """Normalized final OLA tail — emit after the last segment."""
    return state.ola_tail / jnp.maximum(state.norm_tail, _EPS)


def plan_segments(nf: int, cfg: PvocConfig, rs: int, segment_frames: int):
    """(frames per segment F, number of segments S) for a recording of nf
    frames. F is the requested size clamped so the OLA/framing tails stay
    within one segment's span."""
    n, ra = cfg.n_fft, cfg.hop
    F = max(min(segment_frames, nf), -(-(n - rs) // rs), -(-(n - ra) // ra), 1)
    return F, -(-nf // F)


def pad_for_segments(x: jnp.ndarray, cfg: PvocConfig, F: int, S: int) -> jnp.ndarray:
    n, ra = cfg.n_fft, cfg.hop
    span = S * F * ra + (n - ra)
    return jnp.pad(x, (0, max(0, span - x.shape[-1])))[:span]


def stream_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    segment_frames: int = DEFAULT_SEGMENT_FRAMES,
) -> jnp.ndarray:
    """Time-stretch of arbitrary length with constant compile cost.

    Numerically equivalent to pipeline.time_stretch (same per-frame math,
    segment-wise wrapped-carry accumulation); preferred for recordings
    longer than ~segment_frames frames.
    """
    dtype = jnp.dtype(cfg.dtype)
    x = jnp.asarray(x, dtype=dtype)
    rs = cfg.synthesis_hop(stretch)
    n, ra = cfg.n_fft, cfg.hop
    nf = framing.num_frames(x.shape[-1], n, ra)
    if nf <= 0:
        return jnp.zeros((0,), dtype=dtype)
    F, S = plan_segments(nf, cfg, rs, segment_frames)
    # ONE jitted program (pad + scan + tail flush + trim): a single dispatch
    # end to end, with no host round trip between ops.
    return _stream_full(x, nf, cfg, rs, F, S)


@functools.partial(jax.jit, static_argnums=(1, 2, 3, 4, 5))
def _stream_full(x, nf: int, cfg: PvocConfig, rs: int, F: int, S: int):
    x_pad = pad_for_segments(x, cfg, F, S)
    main, state = _stream_scan_from(
        x_pad, init_state(cfg, rs, dtype=x.dtype), nf, cfg, rs, F, S
    )
    out = jnp.concatenate([main, flush_tail(state)])
    return out[: framing.output_length(nf, cfg.n_fft, rs)]
