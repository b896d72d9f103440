"""End-to-end CLI tests (SURVEY.md SS4.5): generated WAV through every
subcommand, plus the 2-D-mesh batched+chunked program."""

import json
import os

import numpy as np
import pytest

from phase_vocoder import cli
from phase_vocoder.io.wav import read_wav, write_wav
from phase_vocoder.parallel.chunked import batched_chunked_time_stretch
from phase_vocoder import PvocConfig, make_mesh_2d, time_stretch
from tests.conftest import make_test_signal


@pytest.fixture()
def wav_in(tmp_path):
    p = str(tmp_path / "in.wav")
    write_wav(p, make_test_signal(1.0), 16000)
    return p


def test_cli_stretch(wav_in, tmp_path, capsys):
    out = str(tmp_path / "out.wav")
    assert cli.main(["stretch", wav_in, out, "--ratio", "2.0"]) == 0
    y, sr = read_wav(out)
    x, _ = read_wav(wav_in)
    assert sr == 16000
    assert abs(len(y) / len(x) - 2.0) < 0.1
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == "audio_seconds_per_second"
    assert rec["value"] > 0


def test_cli_pitch(wav_in, tmp_path):
    out = str(tmp_path / "out.wav")
    assert cli.main(["pitch", wav_in, out, "--semitones", "12"]) == 0
    y, _ = read_wav(out)
    x, _ = read_wav(wav_in)
    assert abs(len(y) - len(x)) < 1100  # duration preserved within a frame


def test_cli_batch(tmp_path, capsys):
    paths = []
    for i, secs in enumerate([0.5, 0.8]):
        p = str(tmp_path / f"u{i}.wav")
        write_wav(p, make_test_signal(secs, seed=i), 16000)
        paths.append(p)
    out_dir = str(tmp_path / "out")
    assert cli.main(["batch", *paths, "--ratio", "1.5", "--out-dir", out_dir]) == 0
    for p in paths:
        assert os.path.exists(os.path.join(out_dir, os.path.basename(p)))


def test_cli_chunked(wav_in, tmp_path):
    out = str(tmp_path / "out.wav")
    assert cli.main(["chunked", wav_in, out, "--ratio", "2.0", "--devices", "4"]) == 0
    y, _ = read_wav(out)
    x, _ = read_wav(wav_in)
    ref = np.asarray(time_stretch(x, 2.0))
    n = min(len(y), len(ref))
    sl = slice(1024, n - 1024)
    # PCM16 quantization dominates the comparison budget here.
    assert np.max(np.abs(y[sl] - np.clip(ref[sl], -1, 32767 / 32768))) < 2e-3


def test_batched_chunked_2d_mesh():
    mesh = make_mesh_2d(2, 4)
    xs = np.stack([make_test_signal(4.0, seed=0), make_test_signal(4.0, seed=1)])
    ys = np.asarray(batched_chunked_time_stretch(xs, 2.0, PvocConfig(), mesh=mesh))
    for i in range(2):
        single = np.asarray(time_stretch(xs[i], 2.0))
        assert ys.shape[1] == len(single)
        sl = slice(1024, len(single) - 1024)
        err = np.max(np.abs(ys[i][sl] - single[sl])) / np.max(np.abs(single[sl]))
        assert err < 5e-5, err


def test_batched_chunked_2d_mesh_half_stretch():
    """DP x SP at 0.5x: the q=2 hop ratio through the 2-D mesh program."""
    mesh = make_mesh_2d(2, 4)
    xs = np.stack([make_test_signal(4.0, seed=0), make_test_signal(4.0, seed=1)])
    ys = np.asarray(batched_chunked_time_stretch(xs, 0.5, PvocConfig(), mesh=mesh))
    for i in range(2):
        single = np.asarray(time_stretch(xs[i], 0.5))
        assert ys.shape[1] == len(single)
        sl = slice(1024, len(single) - 1024)
        err = np.max(np.abs(ys[i][sl] - single[sl])) / np.max(np.abs(single[sl]))
        assert err < 5e-5, err


def test_cli_stretch_checkpointed(tmp_path):
    """--checkpoint-dir rides the checkpointed streaming executor and
    matches the plain streaming run bit for bit."""
    from phase_vocoder.streaming import stream_time_stretch

    wav = str(tmp_path / "in8.wav")
    write_wav(wav, make_test_signal(8.0), 16000)
    out = str(tmp_path / "out.wav")
    ck = str(tmp_path / "ck")
    assert cli.main([
        "stretch", wav, out, "--ratio", "2.0", "--checkpoint-dir", ck,
        "--segment-frames", "256", "--float32",
    ]) == 0
    y, _ = read_wav(out)
    x, _ = read_wav(wav)
    ref = np.asarray(stream_time_stretch(x, 2.0, PvocConfig(), segment_frames=256))
    np.testing.assert_array_equal(y, ref.astype(np.float32))


def test_console_script_entry_point():
    """C14 packaging sanity: the `pvoc` console script declared in
    pyproject.toml resolves to a real callable (the same `cli.main` the
    tests above exercise), so `pip install . && pvoc --help` works."""
    import importlib
    import tomllib

    with open(os.path.join(os.path.dirname(__file__), "..", "pyproject.toml"), "rb") as f:
        meta = tomllib.load(f)
    target = meta["project"]["scripts"]["pvoc"]
    mod_name, _, attr = target.partition(":")
    fn = getattr(importlib.import_module(mod_name), attr)
    assert callable(fn) and fn is cli.main
    with pytest.raises(SystemExit) as e:
        fn(["--help"])
    assert e.value.code == 0
