"""Multi-host (multi-process) bootstrap test — SURVEY.md SS2.2 / SS4.4.

Spawns TWO separate Python processes on localhost, each bootstrapping via
jax.distributed.initialize (coordinator on a free TCP port) with 4 virtual
CPU devices, forming one 8-device global mesh, and runs the sequence-
parallel chunked-TSM program across the process boundary. This exercises
the code path real N>=2-host jobs use (parallel/distributed.py): the
halo/carry collectives cross processes here the way they cross hosts — the
compiled program is identical.

Opt-out: set PVOC_SKIP_DISTRIBUTED=1 (the test costs ~1-2 min of compile).
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKER = os.path.join(_REPO, "scripts", "distributed_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.skipif(
    os.environ.get("PVOC_SKIP_DISTRIBUTED") == "1",
    reason="PVOC_SKIP_DISTRIBUTED=1",
)
def test_two_process_chunked_matches_golden(tmp_path):
    coord = f"127.0.0.1:{_free_port()}"
    out = tmp_path / "verdict.json"

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Fresh per-process device count; strip the parent's test flags so each
    # worker gets exactly 4 virtual devices.
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")

    procs = [
        subprocess.Popen(
            [sys.executable, _WORKER, coord, "2", str(pid), str(out)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker rc={p.returncode}\n{log}"

    rec = json.loads(out.read_text())
    assert rec["process_count"] == 2
    assert rec["global_devices"] == 8
    assert rec["local_devices"] == 4
    assert rec["pass"], rec


@pytest.mark.skipif(
    os.environ.get("PVOC_SKIP_DISTRIBUTED") == "1",
    reason="PVOC_SKIP_DISTRIBUTED=1",
)
def test_cli_chunked_multihost(tmp_path):
    """`pvoc chunked --coordinator ...` bootstraps 2 processes end to end."""
    import numpy as np

    sys.path.insert(0, _REPO)
    from phase_vocoder.io.wav import read_wav, write_wav

    sr, seconds = 16000, 6.0
    g = np.random.default_rng(1)
    t = np.arange(int(seconds * sr)) / sr
    x = (0.4 * np.sin(2 * np.pi * 330.0 * t)
         + 0.05 * g.standard_normal(len(t))).astype(np.float32)
    in_wav = tmp_path / "in.wav"
    write_wav(str(in_wav), x, sr)

    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = _REPO + os.pathsep + env.get("PYTHONPATH", "")

    out_wavs = [tmp_path / f"out{i}.wav" for i in range(2)]
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "phase_vocoder.cli", "chunked",
             str(in_wav), str(out_wavs[pid]), "--ratio", "2.0",
             "--coordinator", coord, "--num-processes", "2",
             "--process-id", str(pid)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("CLI multihost worker timed out")
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"cli rc={p.returncode}\n{log}"

    # Only process 0 writes its output WAV; it must match the
    # single-process pipeline.
    assert out_wavs[0].exists() and not out_wavs[1].exists()
    y, sr2 = read_wav(str(out_wavs[0]))
    assert sr2 == sr

    from phase_vocoder import PvocConfig, pipeline

    ref = np.asarray(pipeline.time_stretch(x, 2.0, PvocConfig()))
    m = min(len(ref), len(y))
    # Interior comparison: the first/last n_fft samples are edge transients
    # where the OLA window-energy norm vanishes (golden/pv_ref.py divides by
    # max(norm, eps) there — the values are unnormalizable junk by spec, and
    # PCM16 clips them on write).
    sl = slice(1024, m - 1024)
    err = float(np.max(np.abs(y[sl] - ref[sl])) / np.max(np.abs(ref[sl])))
    # WAV round trip is PCM16-quantized (2^-15 of full scale, and the edge
    # junk inflates full scale) on top of f32 path noise.
    assert err < 5e-3, err
