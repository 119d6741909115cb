#!/usr/bin/env bash
# Launch the PyTorch package's service across every host of a GPU pod:
# one supervisor a host, whose pod command starts one rank a card.
#
#   supervisor -- launch -- serving
#
# python -m learningorchestra_tpu_torch.supervisor restarts the host's
# ranks together under a new mesh epoch when one dies or process 0's
# /cluster reports the pod degraded (learningorchestra_tpu_torch/
# supervisor.py); python -m learningorchestra_tpu_torch.launch starts the
# host's ranks, N = the host's CUDA device count unless RANKS is set,
# with global ids HOST_ID*N + i of NUM_HOSTS*N, forwards SIGTERM, SIGINT
# and SIGHUP to them and exits with the first failing rank's code
# (learningorchestra_tpu_torch/launch.py); each rank runs python -m
# learningorchestra_tpu_torch.serving, which joins the process group.
# Process 0 (host 0's first card) serves HTTP and owns the catalog;
# every other rank runs the SPMD worker loop. All hosts must see the
# same LO_TPU_STORE_ROOT (a shared filesystem): it is the data plane the
# workers rebuild job inputs from, and it holds the mesh-epoch file host
# 0's supervisor owns (<LO_TPU_STORE_ROOT>/.mesh_epoch).
#
# Usage:
#   deploy/run_pod_torch.sh                  # one host, one rank a card
#   COORDINATOR=host0:8476 NUM_HOSTS=2 HOST_ID=1 deploy/run_pod_torch.sh
#
# Variables: COORDINATOR (host:port of process 0's rendezvous; the job
# channel is its port + 1, or LO_TPU_JOB_PORT), NUM_HOSTS, HOST_ID, PORT
# (HTTP, default 5000), RANKS (ranks a host, default its card count),
# DIST_BACKEND (nccl or gloo; default nccl on cards), DEVICE (cuda or
# cpu; default cuda) and LO_TPU_MESH_SHAPE ("D,M" or "D,M,S" over all
# ranks). A model-axis line is M consecutive ranks, so when M divides
# a host's ranks each line stays on one host.

set -euo pipefail
cd "$(dirname "$0")/.."

PORT="${PORT:-5000}"
NUM_HOSTS="${NUM_HOSTS:-1}"
HOST_ID="${HOST_ID:-0}"

if [[ -n "${COORDINATOR:-}" ]]; then
  export LO_TPU_COORDINATOR="$COORDINATOR"
elif [[ "$NUM_HOSTS" != "1" ]]; then
  echo "set COORDINATOR with NUM_HOSTS > 1" >&2
  exit 2
else
  # One host: process 0 of this host is the rendezvous.
  export LO_TPU_COORDINATOR="127.0.0.1:8476"
fi
# The supervisor owns the epoch file on host 0 only: it reads its own
# LO_TPU_PROCESS_ID, which the launcher replaces with each rank's id.
export LO_TPU_PROCESS_ID="$HOST_ID"

LAUNCH_ARGS=(--host-id "$HOST_ID" --num-hosts "$NUM_HOSTS")
if [[ -n "${RANKS:-}" ]]; then
  LAUNCH_ARGS+=(--ranks "$RANKS")
fi
SERVE_ARGS=(--host 0.0.0.0 --port "$PORT" --device "${DEVICE:-cuda}")
if [[ -n "${DIST_BACKEND:-}" ]]; then
  SERVE_ARGS+=(--dist-backend "$DIST_BACKEND")
fi

SUP_ARGS=()
if [[ "$HOST_ID" == "0" ]]; then
  # Host 0 polls its own /cluster for degradation (a remote rank's death
  # poisons the pod without killing any local process) and keeps the
  # port answering with the failure reason if the restart budget runs
  # out.
  SUP_ARGS=(--health-url "http://127.0.0.1:${PORT}/cluster"
            --fallback-port "$PORT")
fi

echo "pod host $HOST_ID of $NUM_HOSTS via $LO_TPU_COORDINATOR"
exec python -m learningorchestra_tpu_torch.supervisor "${SUP_ARGS[@]}" -- \
  python -m learningorchestra_tpu_torch.launch "${LAUNCH_ARGS[@]}" -- \
  python -m learningorchestra_tpu_torch.serving "${SERVE_ARGS[@]}"
