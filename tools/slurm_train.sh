#!/usr/bin/env bash
# Reference-compatible SLURM launcher shim: on multi-host clusters, launch one python
# process per host; jax.distributed.initialize() picks up the SLURM env.
PARTITION=$1
JOB_NAME=$2
CONFIG=$3
shift 3 || true
srun -p "${PARTITION}" --job-name="${JOB_NAME}" \
    python "$(dirname "$0")/train.py" "$CONFIG" "$@"
