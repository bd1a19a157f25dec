#!/usr/bin/env bash
# Full test suite in three isolated pytest processes.
#
# On some hosts jaxlib's XLA:CPU compiler segfaults (exit 139) when a LARGE
# multi-device program compiles late in a long-lived process (~37-40% into
# the one-process suite; 5 reproductions across cache-on/cache-off runs,
# crash sites in backend_compile_and_load, cache-write serialization, and
# deserialized execution — every implicated module passes alone).  Process
# chunking keeps each process under the threshold.  CI (fresh GitHub
# runners) still runs the one-process suite; use this locally when
# `pytest tests/ -q` dies with exit 139.
set -euo pipefail
cd "$(dirname "$0")/.."

# Every tests/test_*.py module, split into three chunks in name order.
mapfile -t mods < <(ls tests/test_*.py)
chunk=$(( (${#mods[@]} + 2) / 3 ))
for ((i = 0; i < ${#mods[@]}; i += chunk)); do
    python -m pytest "${mods[@]:i:chunk}" -q "$@"
done
echo "all chunks green"
