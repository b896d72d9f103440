"""chip_smoke.py: its refusal off the GPU, and every phase at tiny sizes.

The script itself runs only on a GPU (`python chip_smoke.py`, and
`--four` on four). Here its phase functions run on the CPU at small
lengths, so their control flow and checks are exercised without a card;
the test marked `gpu` runs only where JAX finds one
(`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/`).
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from golden import gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_cpu(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def _prints_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if "ok" in json.loads(line):
                return True
        except (json.JSONDecodeError, TypeError):
            continue
    return False


def test_refuses_cpu():
    proc = _run_cpu(os.path.join(REPO, "chip_smoke.py"), REPO)
    assert proc.returncode != 0
    assert not _prints_result(proc.stdout)
    assert "no GPU" in proc.stderr


def test_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_cpu("chip_smoke.py", str(tmp_path))
    assert proc.returncode != 0
    assert not _prints_result(proc.stdout)


def test_gate_rejects_a_wrong_waveform():
    x = gate.make_signal(1.0)
    with pytest.raises(RuntimeError, match="rel err"):
        cs.gated(gate.stretch_prefix_err(np.zeros(2 * len(x)), x, 2.0, 1024, 256), "zeros")
    with pytest.raises(RuntimeError, match="non-finite"):
        cs.check_waveform(np.full(8, np.nan), 8, "nan")
    with pytest.raises(RuntimeError, match="shape"):
        cs.check_waveform(np.zeros(7), 8, "short")


def test_phase_stretch_tiny():
    rows = cs.phase_stretch(gate.make_signal(3.0), prefix_s=1.5)
    assert [r["stretch"] for r in rows] == [0.5, 1.0, 1.5, 2.0]
    assert all(r["rel_err"] < gate.GATE for r in rows)


def test_phase_pitch_tiny():
    rows = cs.phase_pitch(gate.make_signal(1.5))
    assert len(rows) == 5 and all(r["rel_err"] < gate.GATE for r in rows)


def test_phase_batch_tiny():
    out = cs.phase_batch(n=8, lo_s=0.3, hi_s=0.9, check_rows=(0, 1, 2, 3))
    assert out["utterances"] == 8 and len(out["rel_err"]) == 4


def test_phase_cli_tiny():
    errs = cs.phase_cli(gate.make_signal(2.0), segment_frames=32)
    assert set(errs) == {"plain", "checkpointed"}


def test_phase_transforms_tiny():
    out = cs.phase_transforms(frames=4, seconds=0.5)
    assert {"xla_1024", "matmul_2048", "resample_-7", "resample_+12"} <= set(out)


def test_phase_four_chunked_tiny():
    rows = cs.phase_four_chunked(gate.make_signal(6.0), prefix_s=2.0)
    assert [r["stretch"] for r in rows] == [2.0, 0.5]


def test_phase_four_batched_chunked_tiny():
    out = cs.phase_four_batched_chunked(seconds=3.0, prefix_s=1.5)
    assert len(out["rows"]) == 2


def test_phase_four_batch_tiny():
    out = cs.phase_four_batch(n=8, lo_s=0.3, hi_s=0.9)
    assert out["vs_one_device"] < gate.GATE


@pytest.fixture
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")


@pytest.mark.gpu
def test_transforms_at_full_width_on_gpu(gpu):
    """The transforms and resampler compiled for the card, at real widths."""
    out = cs.phase_transforms()
    assert len(out) == 12
