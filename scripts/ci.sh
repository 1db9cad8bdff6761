#!/usr/bin/env bash
# Local/CI test entry point: build the C++ parity oracle, then run the full
# pytest suite on the 8-device virtual CPU platform (tests/conftest.py).
# Equivalent in spirit to the reference's CTest registration (GameEngine +
# environment tests + `python -m tests`).
set -euo pipefail
cd "$(dirname "$0")/.."

make -C oracle
# Several worker processes keep each process's XLA state small.
# --max-worker-restart=0: a worker crash fails the run instead of silently
# eating the test that crashed it.
JAX_PLATFORMS=cpu python -m pytest tests/ \
    -q -n 3 -p no:cacheprovider --max-worker-restart=0 "$@"
