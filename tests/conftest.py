"""Test configuration.

Tests run on the CPU (JAX_PLATFORMS=cpu unless set otherwise) with 8
virtual XLA devices, so that multi-device sharding logic (mesh, shard_map,
halo exchange, phase-state carry) is exercised without accelerator
hardware — the standard JAX idiom for distributed-logic tests (SURVEY.md
SS4.4). This MUST run before the first `import jax` anywhere. Tests that
need the card are marked `gpu` and skip elsewhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np
import pytest

from golden.gate import make_signal as make_test_signal  # noqa: F401


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0)


@pytest.fixture(scope="session")
def signal_1s():
    return make_test_signal(1.0)


@pytest.fixture(scope="session")
def signal_4s():
    return make_test_signal(4.0)
