"""Chunk-granular checkpoint/resume for long streaming runs (SURVEY.md SS5).

The reference has no recovery story — a killed CLI run restarts from zero.
Here the only cross-segment state is streaming.StreamState (a few KB:
wrapped phase carry, OLA tails, frame offset), so hour-long jobs checkpoint
at segment-batch granularity: each batch's output lands in a numbered .npy
part and the carry state in a numbered .npz, each written under a
temporary name and renamed into place. A killed job resumes at the last
completed batch; the resumed result is bit-identical to an uninterrupted
run (the scan program is the same, only the carry is round-tripped through
device memory and disk).
"""

from __future__ import annotations

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np

from ..config import PvocConfig
from ..ops import framing
from .. import streaming


def _encode_part_device(out: jnp.ndarray, part_dtype: str) -> jnp.ndarray:
    """Device-side output encoding BEFORE the host fetch. 'bfloat16' and
    'int16' halve the device->host and disk bytes; both are lossy (bf16:
    8-bit mantissa; int16: PCM quantization + clip at +-1), so 'float32'
    stays the default, which keeps resume bitwise-identical to the
    uninterrupted f32 run."""
    if part_dtype == "float32":
        return out
    if part_dtype == "bfloat16":
        return out.astype(jnp.bfloat16)
    if part_dtype == "int16":
        return jnp.clip(
            jnp.round(out * 32767.0), -32768.0, 32767.0
        ).astype(jnp.int16)
    raise ValueError(f"unknown part_dtype {part_dtype!r}")


def _decode_part(arr: np.ndarray) -> np.ndarray:
    if arr.dtype == np.int16:
        return arr.astype(np.float32) / 32767.0
    if arr.dtype == np.uint16:  # bfloat16 bits (np.save-safe storage)
        import ml_dtypes

        return arr.view(ml_dtypes.bfloat16).astype(np.float32)
    return np.asarray(arr, np.float32)


def _state_to_tree(state: streaming.StreamState) -> dict:
    return {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}


def _tree_to_state(tree: dict) -> streaming.StreamState:
    return streaming.StreamState(**{k: jnp.asarray(v) for k, v in tree.items()})


def _pipelined_batches(
    ck, run_batch, state, next_batch, n_batches, fail_after
):
    """Drive batches with the fetch/compute/save pipeline.

    Per batch: the device program for batch b+1 is dispatched (async)
    before batch b's host work; the fetch of b's encoded output overlaps
    the disk save of batch b-1, which runs on a single worker thread
    (saves stay strictly ordered — the state save remains the commit
    point, so resume semantics are unchanged).
    """
    import concurrent.futures

    done = 0
    prev = None
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        for batch in range(next_batch, n_batches):
            enc, state = run_batch(state, batch)
            arr = np.asarray(enc)  # device fetch (save thread runs below it)
            if prev is not None:
                prev.result()
                done += 1
                if fail_after is not None and done >= fail_after:
                    raise RuntimeError(f"injected failure after {done} batches")
            prev = ex.submit(ck.save_batch, batch, arr, state)
        if prev is not None:
            prev.result()
            done += 1
            if fail_after is not None and done >= fail_after:
                raise RuntimeError(f"injected failure after {done} batches")
    return state


class StreamCheckpointer:
    """Persists (batch index, StreamState, output parts) under a directory."""

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)

    def _state_path(self, batch: int) -> str:
        return os.path.join(self.directory, f"state_{batch:06d}.npz")

    # -- manifest ----------------------------------------------------------
    def _manifest_path(self) -> str:
        return os.path.join(self.directory, "manifest.json")

    def write_manifest(self, meta: dict) -> None:
        with open(self._manifest_path(), "w") as f:
            json.dump(meta, f)

    def read_manifest(self) -> dict | None:
        try:
            with open(self._manifest_path()) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    # -- parts + state -----------------------------------------------------
    def save_batch(self, batch: int, out: np.ndarray,
                   state: streaming.StreamState) -> None:
        part = os.path.join(self.directory, f"part_{batch:06d}.npy")
        tmp = part + ".tmp.npy"
        arr = np.asarray(out)
        if arr.dtype.name == "bfloat16":
            arr = arr.view(np.uint16)  # np.save-safe bf16 bit container
        np.save(tmp, arr)
        os.replace(tmp, part)
        # State save is the commit point: written whole under a temporary
        # name, then renamed. Stale older states are pruned after it.
        path = self._state_path(batch)
        tmp = path + ".tmp.npz"
        tree = {k: np.asarray(v) for k, v in _state_to_tree(state).items()}
        np.savez(tmp, **tree)
        os.replace(tmp, path)
        for old in self.completed_batches()[:-1]:
            try:
                os.remove(self._state_path(old))
            except FileNotFoundError:
                pass

    def completed_batches(self) -> list[int]:
        done = []
        for name in os.listdir(self.directory):
            stem, ext = os.path.splitext(name)
            if name.startswith("state_") and ext == ".npz" and "." not in stem:
                try:
                    done.append(int(stem.split("_")[1]))
                except (IndexError, ValueError):
                    continue
        return sorted(done)

    def latest_tree(self) -> tuple[int, dict] | None:
        """(batch, raw state tree) of the newest checkpoint, or None."""
        done = self.completed_batches()
        if not done:
            return None
        batch = done[-1]
        with np.load(self._state_path(batch)) as f:
            tree = {k: f[k] for k in f.files}
        return batch, tree

    def latest(self) -> tuple[int, streaming.StreamState] | None:
        found = self.latest_tree()
        if found is None:
            return None
        batch, tree = found
        return batch, _tree_to_state(tree)

    def load_parts(self, up_to_batch: int) -> list[np.ndarray]:
        parts = []
        for b in range(up_to_batch + 1):
            parts.append(
                _decode_part(
                    np.load(os.path.join(self.directory, f"part_{b:06d}.npy"))
                )
            )
        return parts


def checkpointed_stream_time_stretch(
    x,
    stretch: float,
    cfg: PvocConfig = PvocConfig(),
    checkpoint_dir: str = "pvoc_ckpt",
    segment_frames: int = streaming.DEFAULT_SEGMENT_FRAMES,
    batch_segments: int = 8,
    part_dtype: str = "float32",
    _fail_after_batches: int | None = None,
) -> jnp.ndarray:
    """stream_time_stretch with segment-batch checkpointing.

    Re-running after a crash resumes at the last completed batch and returns
    the identical waveform. `_fail_after_batches` is a fault-injection hook
    for tests (raises after N batches, mimicking preemption).

    part_dtype: on-disk/fetch dtype of the output parts — 'float32'
    (default, bitwise resume), 'bfloat16' or 'int16' (half the
    device->host fetch volume; lossy — see _encode_part_device). Batch
    b's fetch+save overlaps batch b+1's device compute (one-deep
    pipeline): the save of b is still the commit point for resume.
    """
    dtype = jnp.dtype(cfg.dtype)
    x = jnp.asarray(x, dtype=dtype)
    rs = cfg.synthesis_hop(stretch)
    nf = framing.num_frames(x.shape[-1], cfg.n_fft, cfg.hop)
    if nf <= 0:
        return jnp.zeros((0,), dtype=dtype)
    F, S = streaming.plan_segments(nf, cfg, rs, segment_frames)
    x_pad = streaming.pad_for_segments(x, cfg, F, S)

    ck = StreamCheckpointer(checkpoint_dir)
    meta = {"nf": nf, "F": F, "S": S, "rs": rs, "stretch": stretch,
            "n_fft": cfg.n_fft, "hop": cfg.hop,
            "batch_segments": batch_segments, "part_dtype": part_dtype}
    existing = ck.read_manifest()
    if existing is not None:
        if existing != meta:
            raise ValueError(
                f"checkpoint dir {checkpoint_dir!r} holds a different run: "
                f"{existing} != {meta}"
            )
    ck.write_manifest(meta)

    latest = ck.latest()
    if latest is None:
        next_batch = 0
        state = streaming.init_state(cfg, rs, dtype=dtype)
    else:
        last_done, state = latest
        next_batch = last_done + 1

    n_batches = -(-S // batch_segments)

    def run_batch(state, batch):
        s0 = batch * batch_segments
        count = min(batch_segments, S - s0)
        # One compiled program per distinct `count` (at most two: full + last).
        out, state = streaming._stream_scan_from(
            x_pad, state, nf, cfg, rs, F, count
        )
        return _encode_part_device(out, part_dtype), state

    state = _pipelined_batches(
        ck, run_batch, state, next_batch, n_batches, _fail_after_batches
    )

    parts = ck.load_parts(n_batches - 1)
    out = jnp.concatenate(
        [jnp.asarray(p) for p in parts] + [streaming.flush_tail(state)]
    )
    return out[: framing.output_length(nf, cfg.n_fft, rs)]
