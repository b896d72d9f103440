"""Checkpoint/resume at segment-batch granularity (fault injection)."""

import numpy as np
import pytest

from phase_vocoder import PvocConfig
from phase_vocoder.streaming import stream_time_stretch
from phase_vocoder.utils.checkpoint import (
    StreamCheckpointer,
    checkpointed_stream_time_stretch,
)
from tests.conftest import make_test_signal

CFG = PvocConfig()


@pytest.fixture(scope="module")
def x8s():
    return make_test_signal(8.0).astype(np.float32)


def test_uninterrupted_matches_stream(tmp_path, x8s):
    y_ck = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=str(tmp_path / "ck"),
        segment_frames=64, batch_segments=3,
    ))
    y = np.asarray(stream_time_stretch(x8s, 2.0, CFG, segment_frames=64))
    assert y_ck.shape == y.shape
    np.testing.assert_allclose(y_ck, y, atol=1e-6)


def test_resume_after_injected_failure(tmp_path, x8s):
    ckdir = str(tmp_path / "ck")
    with pytest.raises(RuntimeError, match="injected failure"):
        checkpointed_stream_time_stretch(
            x8s, 2.0, CFG, checkpoint_dir=ckdir,
            segment_frames=64, batch_segments=3, _fail_after_batches=2,
        )
    done = StreamCheckpointer(ckdir).completed_batches()
    assert done, "no batches persisted before the failure"
    # Resume: picks up after the last committed batch, finishes the run.
    y_ck = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=ckdir,
        segment_frames=64, batch_segments=3,
    ))
    y = np.asarray(stream_time_stretch(x8s, 2.0, CFG, segment_frames=64))
    np.testing.assert_allclose(y_ck, y, atol=1e-6)


def test_completed_run_is_idempotent(tmp_path, x8s):
    ckdir = str(tmp_path / "ck")
    y1 = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=ckdir, segment_frames=64,
        batch_segments=3,
    ))
    y2 = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=ckdir, segment_frames=64,
        batch_segments=3,
    ))
    np.testing.assert_array_equal(y1, y2)


def test_mismatched_run_rejected(tmp_path, x8s):
    ckdir = str(tmp_path / "ck")
    checkpointed_stream_time_stretch(
        x8s, 2.0, CFG, checkpoint_dir=ckdir, segment_frames=64,
        batch_segments=3,
    )
    with pytest.raises(ValueError, match="different run"):
        checkpointed_stream_time_stretch(
            x8s, 0.5, CFG, checkpoint_dir=ckdir, segment_frames=64,
            batch_segments=3,
        )


@pytest.mark.parametrize("part_dtype", ["bfloat16", "int16"])
def test_compact_part_dtypes_resume_consistent(tmp_path, x8s, part_dtype):
    """Half-size output parts (half the device->host and disk bytes):
    lossy vs f32 but resume-consistent — an interrupted+resumed run returns
    the same waveform as an uninterrupted run at the SAME part_dtype, and
    both stay within the encoding's own error of the f32 result."""
    cfg = CFG
    kw = dict(segment_frames=64, batch_segments=2, part_dtype=part_dtype)
    d1 = str(tmp_path / "a")
    y_full = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, cfg, checkpoint_dir=d1, **kw))
    d2 = str(tmp_path / "b")
    with pytest.raises(RuntimeError, match="injected"):
        checkpointed_stream_time_stretch(
            x8s, 2.0, cfg, checkpoint_dir=d2, _fail_after_batches=1, **kw)
    y_res = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, cfg, checkpoint_dir=d2, **kw))
    np.testing.assert_array_equal(y_full, y_res)
    y_f32 = np.asarray(checkpointed_stream_time_stretch(
        x8s, 2.0, cfg, checkpoint_dir=str(tmp_path / "c"),
        segment_frames=64, batch_segments=2))
    tol = 1e-2 if part_dtype == "bfloat16" else 1e-4
    # Interior only: the last few samples legitimately blow up (OLA edge
    # window-norm -> eps clamp). int16 additionally CLIPS legitimate
    # stretch overshoot past +-1.0 (documented PCM16 caveat), so its
    # quantization bound applies only where |y| < 1.
    sl = slice(1024, len(y_full) - 1024)
    a, b = y_full[sl], y_f32[sl]
    if part_dtype == "int16":
        keep = np.abs(b) < 1.0
        a, b = a[keep], b[keep]
    assert np.max(np.abs(a - b)) < tol


def _one_batch_state(x):
    """(output, StreamState) after two segments of a real run."""
    from phase_vocoder import streaming
    from phase_vocoder.ops import framing

    rs = CFG.synthesis_hop(2.0)
    nf = framing.num_frames(len(x), CFG.n_fft, CFG.hop)
    F, S = streaming.plan_segments(nf, CFG, rs, 64)
    x_pad = streaming.pad_for_segments(np.asarray(x, np.float32), CFG, F, S)
    return streaming._stream_scan_from(
        x_pad, streaming.init_state(CFG, rs), nf, CFG, rs, F, 2
    )


def test_state_npz_round_trip_bitwise(tmp_path, x8s):
    """The carry state survives np.savez / np.load bit for bit, dtypes and
    all, and the commit leaves no temporary file behind."""
    import dataclasses
    import os

    out, state = _one_batch_state(x8s)
    ck = StreamCheckpointer(str(tmp_path / "ck"))
    ck.save_batch(0, np.asarray(out), state)
    batch, restored = ck.latest()
    assert batch == 0
    for f in dataclasses.fields(state):
        a, b = np.asarray(getattr(state, f.name)), np.asarray(getattr(restored, f.name))
        assert a.dtype == b.dtype and a.shape == b.shape, f.name
        np.testing.assert_array_equal(a, b, err_msg=f.name)
    assert sorted(os.listdir(tmp_path / "ck")) == ["part_000000.npy", "state_000000.npz"]


def test_only_newest_state_is_kept(tmp_path, x8s):
    """Each commit prunes older states; every output part stays."""
    import os

    out, state = _one_batch_state(x8s)
    ck = StreamCheckpointer(str(tmp_path / "ck"))
    for b in range(3):
        ck.save_batch(b, np.asarray(out), state)
    assert ck.completed_batches() == [2]
    names = sorted(os.listdir(tmp_path / "ck"))
    assert names == [f"part_{b:06d}.npy" for b in range(3)] + ["state_000002.npz"]


def test_stray_temporary_state_is_ignored(tmp_path):
    """A state file cut off mid-write (still under its temporary name) is
    not taken for a committed batch."""
    ck = StreamCheckpointer(str(tmp_path / "ck"))
    (tmp_path / "ck" / "state_000005.npz.tmp.npz").write_bytes(b"partial")
    assert ck.completed_batches() == []
    assert ck.latest() is None
