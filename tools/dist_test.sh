#!/usr/bin/env bash
# Reference-compatible launcher shim. A single process drives the
# whole mesh (jax.distributed for multi-host), so this simply forwards.
CONFIG=$1
GPUS=$2   # accepted for CLI parity; the mesh size comes from the runtime
shift 2 || true
python "$(dirname "$0")/test.py" "$CONFIG" "$@"
