#!/usr/bin/env bash
# Multi-host launch of the PyTorch port's flow trainer — the role of the
# reference's SLURM + mpirun Horovod launcher
# (dlmodels/color-information/run.sh), on torchrun.
#
# Every host runs the SAME command with its own HOST_ID; torchrun starts
# GPUS_PER_HOST processes per host, one per card, and
# scripts/torch_train_flow.py joins them into one data-parallel
# torch.distributed world over NCCL (gloo with --device cpu). Each rank
# takes --batch / world tiles per step and the gradients are averaged over
# the ranks. COORDINATOR (host:port of host 0) is the rendezvous endpoint;
# without it the world is this host alone (torchrun --standalone).
#
#   Variable        torchrun flag       Default
#   COORDINATOR     --rdzv-endpoint     (none: --standalone)
#   NUM_HOSTS       --nnodes            1
#   HOST_ID         --node-rank         0
#   GPUS_PER_HOST   --nproc-per-node    1
#   STEPS           the trainer's --steps   1000
#   PYTHON          the interpreter     python3
#
# Usage (generic N-host setup, run per host with its rank):
#   COORDINATOR=host0:29500 NUM_HOSTS=2 HOST_ID=0 GPUS_PER_HOST=4 \
#     ./scripts/torch_launch_multihost.sh --batch 256 --save /ckpt
#   COORDINATOR=host0:29500 NUM_HOSTS=2 HOST_ID=1 GPUS_PER_HOST=4 \
#     ./scripts/torch_launch_multihost.sh --batch 256 --save /ckpt
#
# Usage (one host, four cards):
#   GPUS_PER_HOST=4 STEPS=100 ./scripts/torch_launch_multihost.sh
#
# Arguments after the variables go to scripts/torch_train_flow.py.
set -euo pipefail

: "${COORDINATOR:=}"
: "${NUM_HOSTS:=1}"
: "${HOST_ID:=0}"
: "${GPUS_PER_HOST:=1}"
: "${STEPS:=1000}"
: "${PYTHON:=python3}"

RUN=(--nnodes "$NUM_HOSTS" --node-rank "$HOST_ID"
     --nproc-per-node "$GPUS_PER_HOST")
if [[ -n "$COORDINATOR" ]]; then
  RUN+=(--rdzv-endpoint "$COORDINATOR")
elif [[ "$NUM_HOSTS" -gt 1 ]]; then
  echo "COORDINATOR (host:port of host 0) is needed for NUM_HOSTS > 1" >&2
  exit 2
else
  RUN+=(--standalone)
fi

exec "$PYTHON" -m torch.distributed.run "${RUN[@]}" \
  "$(dirname "$0")/torch_train_flow.py" --steps "$STEPS" "$@"
