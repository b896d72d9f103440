"""Packaging sanity (reference component C14 — the build system).

The reference ships a Makefile; the rebuild ships pyproject.toml with a
`pvoc` console script (plus native/Makefile for the C++ WAV parser). These
tests assert the wheel metadata is coherent and the declared entry point is
the real CLI — `pip install -e . && pvoc --help` is exercised directly when
the script is on PATH (it is in the dev environment).
"""

from __future__ import annotations

import pathlib
import shutil
import subprocess
import sys
import tomllib

REPO = pathlib.Path(__file__).resolve().parent.parent


def _load_pyproject():
    with open(REPO / "pyproject.toml", "rb") as f:
        return tomllib.load(f)


def test_pyproject_declares_package_and_script():
    meta = _load_pyproject()
    assert meta["project"]["name"] == "phase-vocoder"
    assert meta["project"]["scripts"]["pvoc"] == "phase_vocoder.cli:main"

    import phase_vocoder

    assert meta["project"]["version"] == phase_vocoder.__version__


def test_entry_point_target_is_callable():
    from phase_vocoder import cli

    assert callable(cli.main)
    # argparse --help exits 0 via SystemExit.
    proc = subprocess.run(
        [sys.executable, "-m", "phase_vocoder.cli", "--help"],
        capture_output=True,
        text=True,
        timeout=120,
        cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr
    assert "stretch" in proc.stdout and "pitch" in proc.stdout


def test_installed_console_script_runs():
    exe = shutil.which("pvoc")
    if exe is None:
        import pytest

        pytest.skip("pvoc not installed on PATH (run `pip install -e .`)")
    proc = subprocess.run(
        [exe, "--help"], capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr
    assert "stretch" in proc.stdout
