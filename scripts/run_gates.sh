#!/usr/bin/env bash
# One-command gate runner on the CPU: the full suite, then the long-form
# golden gates that the suite skips by default.
#
#   scripts/run_gates.sh            # suite + 600 s slow gates
#   RUN_HOUR=1 scripts/run_gates.sh # also the 3600 s hour gates
#
# Everything here runs on the CPU (JAX_PLATFORMS=cpu, 8 virtual devices);
# the GPU checks are `python chip_smoke.py`.
set -euo pipefail
cd "$(dirname "$0")/.."
export JAX_PLATFORMS=cpu

echo "== full test suite (8-device virtual CPU mesh) =="
python -m pytest tests/ -q

echo "== 600 s slow gates =="
PVOC_SLOW_TESTS=1 timeout 3000 python -m pytest tests/test_longform.py -q

if [[ "${RUN_HOUR:-0}" == "1" ]]; then
  echo "== 3600 s hour gates =="
  PVOC_HOUR_TESTS=1 timeout 7000 python -m pytest tests/test_longform.py -q -k hour
fi

echo "ALL GATES GREEN"
