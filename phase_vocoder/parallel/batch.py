"""Data-parallel batched TSM (BASELINE config 4: 64 utterances, varied ratios).

Utterance batches are embarrassingly parallel: vmap the single-utterance
pipeline over the batch axis and shard that axis over the mesh's "data"
axis — XLA partitions the program with zero collectives (SURVEY.md SS2.2).

Varied stretch ratios: the synthesis hop Rs is a static shape parameter, so
utterances are grouped by Rs and each group runs as one padded batch
(padded-length bucketing, SURVEY.md SS7 stage 5).
"""

from __future__ import annotations

import functools
from collections import defaultdict

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import PvocConfig
from .. import pipeline
from ..ops import framing


@functools.partial(jax.jit, static_argnums=(2, 3))
def _batch_stretch_jit(
    xs: jnp.ndarray, n_valid_frames: jnp.ndarray, cfg: PvocConfig, rs: int
) -> jnp.ndarray:
    nf_padded = framing.num_frames(xs.shape[-1], cfg.n_fft, cfg.hop)

    def one(x, nf_i):
        mag, phi = pipeline.analyze(x, cfg)
        re, im = pipeline.stretch_frames(mag, phi, cfg, rs)
        mask = (jnp.arange(nf_padded) < nf_i).astype(x.dtype)
        return pipeline.synthesize(re, im, cfg, rs, frame_mask=mask)

    return jax.vmap(one)(xs, n_valid_frames)


def batch_time_stretch(
    xs, stretch: float, cfg: PvocConfig = PvocConfig(), mesh: Mesh | None = None
) -> jnp.ndarray:
    """Stretch a (B, T) batch of equal-length utterances, one ratio.

    With a mesh, the batch axis is sharded over the "data" mesh axis so each
    device processes B/D utterances.
    """
    return batch_time_stretch_rs(xs, cfg.synthesis_hop(stretch), cfg, mesh=mesh)


def batch_time_stretch_ragged(
    xs: list, stretch: float, cfg: PvocConfig = PvocConfig(), mesh: Mesh | None = None
) -> list:
    """Stretch a list of variable-length utterances (one ratio).

    Pads to the bucket maximum, runs one batched program, slices each output
    to its true stretched length. Padding frames produce zero output (zero
    input -> zero magnitude), so slicing recovers the exact per-utterance
    waveform of the unpadded run up to OLA edge normalization.
    """
    return batch_time_stretch_varied(xs, [stretch] * len(xs), cfg, mesh=mesh)


def batch_time_stretch_varied(
    xs: list,
    stretches: list,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
) -> list:
    """Stretch utterances with per-utterance ratios (grouped by ratio)."""
    if len(xs) != len(stretches):
        raise ValueError("xs and stretches must have equal length")
    groups: dict[int, list[int]] = defaultdict(list)
    for i, s in enumerate(stretches):
        groups[cfg.synthesis_hop(s)].append(i)

    out: list = [None] * len(xs)
    for rs, idxs in groups.items():
        max_len = max(len(xs[i]) for i in idxs)
        batch = np.zeros((len(idxs), max_len), dtype=cfg.dtype)
        nfs = np.empty(len(idxs), dtype=np.int32)
        for row, i in enumerate(idxs):
            batch[row, : len(xs[i])] = xs[i]
            nfs[row] = framing.num_frames(len(xs[i]), cfg.n_fft, cfg.hop)
        ys = np.asarray(batch_time_stretch_rs(batch, rs, cfg, mesh=mesh, n_valid_frames=nfs))
        for row, i in enumerate(idxs):
            out[i] = ys[row, : framing.output_length(int(nfs[row]), cfg.n_fft, rs)]
    return out


def batch_time_stretch_rs(
    xs,
    rs: int,
    cfg: PvocConfig = PvocConfig(),
    mesh: Mesh | None = None,
    n_valid_frames=None,
) -> jnp.ndarray:
    """Batched stretch parameterized directly by synthesis hop Rs."""
    xs = jnp.asarray(xs, dtype=jnp.dtype(cfg.dtype))
    nf = framing.num_frames(xs.shape[-1], cfg.n_fft, cfg.hop)
    if n_valid_frames is None:
        n_valid_frames = jnp.full((xs.shape[0],), nf, dtype=jnp.int32)
    else:
        n_valid_frames = jnp.asarray(n_valid_frames, dtype=jnp.int32)
    pad_rows = 0
    if mesh is not None:
        # Sharding over "data" needs B % D == 0: pad with all-masked zero
        # rows (their output is zero and is dropped before returning).
        d = mesh.shape["data"]
        pad_rows = (-xs.shape[0]) % d
        if pad_rows:
            xs = jnp.pad(xs, ((0, pad_rows), (0, 0)))
            n_valid_frames = jnp.pad(n_valid_frames, (0, pad_rows))
        xs = jax.device_put(xs, NamedSharding(mesh, P("data")))
        n_valid_frames = jax.device_put(n_valid_frames, NamedSharding(mesh, P("data")))
    ys = _batch_stretch_jit(xs, n_valid_frames, cfg, rs)
    return ys[: ys.shape[0] - pad_rows] if pad_rows else ys
