"""Sequence-parallel chunked TSM — the flagship new capability.

The reference cannot split a recording at all: the whole file must fit one
GPU (SURVEY.md SS2.2). Here ONE long recording is sharded over the mesh's
"seq" axis by FRAMES (each device owns a contiguous span of F analysis
frames) and stitched exactly:

  * input halo   — each device ppermutes the first N-Ra samples of its
    sample span to its left neighbor, so every frame is computed exactly
    (no seam); the ring-attention/Ulysses communication pattern applied to
    STFT frames [BASELINE.json:5].
  * phase halo   — the first analysis-phase row ppermutes left so the
    heterodyned increment crossing the chunk boundary is exact.
  * phase carry  — the synthesis-phase prefix sum factorizes: each device
    scans its own (Rs/Ra)*dphi terms as a compensated (hi, lo)-pair
    associative scan (ops/phase.py), the per-chunk pair totals are
    all-gathered (D x 2 x n_bins floats — tiny) and a pair-wrapped
    exclusive prefix over the device axis yields each chunk's carry.
    Addition mod 2*pi is associative and the pairs hold ~2^-48 effective
    precision, so chunked psi == monolithic psi REGARDLESS of recording
    length.
  * OLA tails    — the last N-Rs output samples of each chunk ppermute to
    the right neighbor and add into its head BEFORE normalization, so the
    overlap-add seam is exact. Window-energy normalization is masked to
    valid frames, so padding frames contribute nothing.

Everything is one jitted shard_map program; XLA lowers the collectives to
the device interconnect (NCCL over NVLink between GPUs), and the same
program runs across hosts under jax.distributed (parallel/distributed.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PvocConfig
from ..ops import framing, phase
from ..ops.window import hann_window
from .. import pipeline
from .mesh import make_mesh

_EPS = 1e-8


def _chunked_body(x_sh, x_tail, nf, cfg: PvocConfig, rs: int, F: int, D: int):
    """Per-device chunk program (runs inside shard_map over axis 'seq').

    x_sh: (F*Ra,) this device's sample span; x_tail: (N-Ra,) replicated
    global tail beyond the sharded span (used by the last device as halo).
    Returns (main (F*rs,), tail (1, N-rs)) — tail rows materialize as a
    (D, N-rs) array of which only the last row is meaningful.
    """
    n, ra = cfg.n_fft, cfg.hop
    d = jax.lax.axis_index("seq")
    left = [(i, i - 1) for i in range(1, D)]
    right = [(i, i + 1) for i in range(D - 1)]

    # --- input halo: receive next chunk's head (zeros at d=D-1 -> x_tail).
    halo = jax.lax.ppermute(x_sh[: n - ra], "seq", left)
    halo = jnp.where(d == D - 1, x_tail, halo)
    mag, phi = pipeline.analyze(jnp.concatenate([x_sh, halo]), cfg)  # (F, nb)

    # --- phase halo: neighbor's first phi row for the boundary increment.
    phi_next = jax.lax.ppermute(phi[0:1], "seq", left)  # zeros at d=D-1
    phi_ext = jnp.concatenate([phi, phi_next])  # (F+1, n_bins)

    # --- phase carry: local compensated scan + cross-device exclusive
    # prefix, all in (hi, lo)-pair arithmetic (ops/phase.py) — plain f32
    # wrap_add drifts linearly with length (2.84e-4 vs golden at 60 s /
    # 2.0x, over the 1e-4 gate) because period-locked rounding biases
    # integrate; the pair scan holds ~2^-48 at any length. The per-device
    # totals all_gather carries BOTH halves (D x 2 x n_bins — still tiny).
    th, tl = phase.residual_terms_c(phi_ext, ra, rs, n)  # (F, nb) pairs
    # Zero increments that cross past the last valid frame (padding).
    g = d * F + jnp.arange(F)  # global frame indices owned here
    vm = (g < nf - 1)[:, None].astype(th.dtype)
    th, tl = th * vm, tl * vm
    incl_h, incl_l = phase.blocked_scan(phase.wrap_add_c, (th, tl))
    local_excl = tuple(
        jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]])
        for a in (incl_h, incl_l)
    )
    totals = jax.lax.all_gather(
        jnp.stack([incl_h[-1], incl_l[-1]]), "seq"
    )  # (D, 2, n_bins)
    pref_h, pref_l = phase.blocked_scan(
        phase.wrap_add_c, (totals[:, 0], totals[:, 1])
    )
    carry = tuple(
        jnp.take(jnp.concatenate([jnp.zeros_like(a[:1]), a[:-1]]), d, axis=0)[
            None, :
        ]
        for a in (pref_h, pref_l)
    )
    res_h, res_l = phase.wrap_add_c(carry, local_excl)  # (F, n_bins) pair
    residual = res_h + res_l

    # --- global phi[0] (device 0's first row) for the absolute phase.
    phi0 = jax.lax.all_gather(phi[0], "seq")[0]  # (n_bins,)
    psi = phase.finalize_phase(phi0, residual, rs, n, frame_offset=d * F)
    psi = phase.pin_real_bins(psi, phi, rs, n, frame_offset=d * F)

    mask = (g < nf).astype(mag.dtype)  # valid-frame mask
    with jax.named_scope("pvoc_synthesize"):
        y_frames = pipeline.synthesize_frames(
            mag * jnp.cos(psi), mag * jnp.sin(psi), cfg, frame_mask=mask
        )
        ola = framing.overlap_add(y_frames, rs, method=cfg.ola_method)
    w = hann_window(n, dtype=mag.dtype)
    norm = framing.ola_window_norm(
        w, F, rs, eps=0.0, method=cfg.ola_method, frame_mask=mask
    )

    # --- OLA tail exchange: my tail adds into my right neighbor's head.
    tail_len = n - rs
    recv_y = jax.lax.ppermute(ola[F * rs :], "seq", right)  # zeros at d=0
    recv_n = jax.lax.ppermute(norm[F * rs :], "seq", right)
    pad = (0, F * rs - tail_len)
    main = ola[: F * rs] + jnp.pad(recv_y, pad)
    main_norm = norm[: F * rs] + jnp.pad(recv_n, pad)
    main_out = main / jnp.maximum(main_norm, _EPS)

    # Last device's tail is the global output tail (no receiver exists).
    tail_out = ola[F * rs :] / jnp.maximum(norm[F * rs :], _EPS)
    return main_out, tail_out[None, :]


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _chunked_jit(x_main, x_tail, nf, cfg, rs, F, mesh):
    D = mesh.shape["seq"]
    body = functools.partial(_chunked_body, nf=nf, cfg=cfg, rs=rs, F=F, D=D)
    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("seq"), P()),
        out_specs=(P("seq"), P("seq", None)),
    )
    return fn(x_main, x_tail)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5, 6))
def _batched_chunked_jit(x_main, x_tail, nf, cfg, rs, F, mesh):
    """DP x SP: batch axis on mesh 'data', time-chunk axis on mesh 'seq'."""
    D = mesh.shape["seq"]

    def body(xm, xt):  # (B_local, F*Ra), (B_local, N-Ra)
        one = functools.partial(_chunked_body, nf=nf, cfg=cfg, rs=rs, F=F, D=D)
        return jax.vmap(one)(xm, xt)

    fn = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P("data", "seq"), P("data", None)),
        out_specs=(P("data", "seq"), P("data", "seq", None)),
    )
    return fn(x_main, x_tail)


def batched_chunked_time_stretch(
    xs,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
) -> jnp.ndarray:
    """Stretch a (B, T) batch, data-parallel over 'data' AND sequence-parallel
    over 'seq' — the full 2-D-mesh program (one shard_map, both axes)."""
    dtype = jnp.dtype(cfg.dtype)
    xs = jnp.asarray(xs, dtype=dtype)
    if xs.ndim != 2:
        raise ValueError(f"expected (B, T) batch, got shape {xs.shape}")
    rs = cfg.synthesis_hop(stretch)
    n, ra = cfg.n_fft, cfg.hop
    nf = framing.num_frames(xs.shape[-1], n, ra)
    if nf <= 0:
        return jnp.zeros((xs.shape[0], 0), dtype=dtype)
    if mesh is None or "seq" not in mesh.shape or "data" not in mesh.shape:
        raise ValueError("batched_chunked_time_stretch needs a ('data','seq') mesh")
    D = mesh.shape["seq"]
    F = -(-nf // D)
    if F < min_frames_per_device(cfg, rs):
        raise ValueError(
            f"recording too short to chunk over {D} devices "
            f"(need >= {min_frames_per_device(cfg, rs) * D} frames, have {nf})"
        )
    nf_pad = F * D
    span = nf_pad * ra
    full = jnp.pad(xs, ((0, 0), (0, max(0, span + (n - ra) - xs.shape[-1]))))
    x_main, x_tail = full[:, :span], full[:, span : span + (n - ra)]
    # Place the inputs on the mesh: an input committed to one device (as
    # jax.device_put(x, device) makes it) would otherwise be refused.
    x_main = jax.device_put(x_main, NamedSharding(mesh, P("data", "seq")))
    x_tail = jax.device_put(x_tail, NamedSharding(mesh, P("data", None)))
    main, tails = _batched_chunked_jit(x_main, x_tail, nf, cfg, rs, F, mesh)
    out = jnp.concatenate([main, tails[:, -1]], axis=-1)
    return out[:, : framing.output_length(nf, n, rs)]


def min_frames_per_device(cfg: PvocConfig, rs: int) -> int:
    """Smallest F for which halos only touch the immediate neighbor."""
    n, ra = cfg.n_fft, cfg.hop
    f_halo = -(-(n - ra) // ra)  # input halo fits in neighbor's span
    f_tail = -(-(n - rs) // rs)  # OLA tail fits in neighbor's main span
    return max(f_halo, f_tail, 1)


def chunked_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
    force: bool = False,
) -> jnp.ndarray:
    """Time-stretch ONE long recording sharded over the mesh's "seq" axis.

    Mathematically identical to pipeline.time_stretch (the phase prefix sum
    factorizes exactly across chunks); falls back to the single-device path
    when the recording is too short to split usefully. force=True runs the
    shard_map program even on a 1-device mesh — the per-device throughput
    of the chunked program itself, the denominator of a scaling
    measurement.
    """
    dtype = jnp.dtype(cfg.dtype)
    x = jnp.asarray(x, dtype=dtype)
    rs = cfg.synthesis_hop(stretch)
    n, ra = cfg.n_fft, cfg.hop
    nf = framing.num_frames(x.shape[-1], n, ra)
    if nf <= 0:
        return jnp.zeros((0,), dtype=dtype)
    if mesh is None:
        mesh = make_mesh(axis="seq")
    D = mesh.shape["seq"]

    F = -(-nf // D)
    if (D == 1 and not force) or F < min_frames_per_device(cfg, rs):
        return pipeline.time_stretch(x, stretch, cfg)

    nf_pad = F * D
    span = nf_pad * ra
    full = jnp.pad(x, (0, max(0, span + (n - ra) - x.shape[-1])))
    x_main, x_tail = full[:span], full[span : span + (n - ra)]
    # Place the inputs on the mesh (see batched_chunked_time_stretch).
    x_main = jax.device_put(x_main, NamedSharding(mesh, P("seq")))
    x_tail = jax.device_put(x_tail, NamedSharding(mesh, P()))
    main, tails = _chunked_jit(x_main, x_tail, nf, cfg, rs, F, mesh)
    out = jnp.concatenate([main, tails[-1]])
    return out[: framing.output_length(nf, n, rs)]
