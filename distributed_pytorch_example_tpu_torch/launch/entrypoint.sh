#!/bin/bash
# Per-host launcher for multi-host training on NVIDIA GPUs (the PyTorch
# port's counterpart of distributed_pytorch_example_tpu/launch/entrypoint.sh).
#
# The reference launcher's topology-from-hostname contract (reference
# entrypoint.sh:1-39), with ONE Python process per host, as the JAX
# launcher runs: the process joins the job through
# runtime/distributed.py (a tcp:// rendezvous on the coordinator, then
# a torch.distributed process group). A process per card under torchrun
# (NPROC_PER_NODE > 1) is not served yet (ROADMAP.md item 11) and is
# refused.
#
# Env contract (reference entrypoint.sh:5-8):
#   NF_DISCOVERY_SERVICE  headless-service DNS suffix        [required >1 host]
#   REPLICAS              number of hosts                    [required]
#   COORDINATOR_PORT      rendezvous port (or MASTER_PORT)   [default 29500]
#   TRAINING_SCRIPT       a script to run with python instead of the
#                         port's trainer                     [default: the
#                         module distributed_pytorch_example_tpu_torch.train]
#   SCRIPT_ARGS           extra args forwarded to it         [default ""]
#   NPROC_PER_NODE        processes per host: 1 only         [default 1]
#
# Restarts (the reference's torchrun is a static rendezvous with none; a
# crash kills the job, and recovery is a manual relaunch with --resume,
# reference train.py:256-257):
#   MAX_RESTARTS    restarts after nonzero exits; each retry appends
#                   `--resume <checkpoint dir>/latest_model.ckpt`, so
#                   training continues from the last checkpoint, of
#                   either format [default 0]. The checkpoint dir comes
#                   from --checkpoint-dir inside SCRIPT_ARGS (either
#                   spelling) when present, else $CHECKPOINT_DIR.
#                   Crash signals (OOM-kill 137, SIGSEGV 139, ...) are
#                   restarted; orchestrator teardown (HUP/INT/TERM, rc
#                   129/130/143) is not. A multi-host job recovers only if
#                   every host exits (peers blocked in a collective must be
#                   restarted by the orchestrator).
#   CHECKPOINT_DIR  fallback checkpoint dir                [default ./checkpoints]
#   DPX_ELASTIC     "1": a restarted host whose rendezvous retries run out
#                   because peers are gone for good probes every peer,
#                   renumbers the survivors densely and joins them as a
#                   smaller world (runtime/distributed.py
#                   shrink_to_survivors); the resume checkpoint reshards
#                   onto it through its mesh stamp    [default off; passed
#                   through to the trainer like every other variable]
#
# Derived (reference entrypoint.sh:24-28):
#   PROCESS_ID          <- numeric suffix of $HOSTNAME   (NODE_RANK=${HOSTNAME##*-})
#   COORDINATOR_ADDRESS <- ${BASE_NAME}-0.${NF_DISCOVERY_SERVICE}:${COORDINATOR_PORT}
# Either may be set instead; runtime/distributed.py resolve_config derives
# both the same way when unset, so this script only validates and runs.

set -euo pipefail

REPLICAS="${REPLICAS:-1}"
COORDINATOR_PORT="${COORDINATOR_PORT:-${MASTER_PORT:-29500}}"
SCRIPT_ARGS="${SCRIPT_ARGS:-}"

if [ "${NPROC_PER_NODE:-1}" != "1" ]; then
  echo "ERROR: NPROC_PER_NODE=${NPROC_PER_NODE}: this launcher runs one" \
       "process per host; a process per card is not served yet" \
       "(ROADMAP.md item 11)" >&2
  exit 1
fi

if [ -n "${TRAINING_SCRIPT:-}" ]; then
  cmd=(python "${TRAINING_SCRIPT}")
else
  cmd=(python -m distributed_pytorch_example_tpu_torch.train)
fi

if [ "${REPLICAS}" -gt 1 ]; then
  # fail fast on a missing discovery service, like reference entrypoint.sh:14-22
  if [ -z "${NF_DISCOVERY_SERVICE:-}" ]; then
    echo "ERROR: NF_DISCOVERY_SERVICE must be set for REPLICAS=${REPLICAS} > 1" >&2
    exit 1
  fi
  HOSTNAME="${HOSTNAME:-$(hostname)}"
  PROCESS_ID="${PROCESS_ID:-${HOSTNAME##*-}}"
  case "${PROCESS_ID}" in
    ''|*[!0-9]*)
      echo "ERROR: cannot derive numeric PROCESS_ID from hostname '${HOSTNAME}'" >&2
      exit 1
      ;;
  esac
  BASE_NAME="${HOSTNAME%-*}"
  COORDINATOR_ADDRESS="${COORDINATOR_ADDRESS:-${BASE_NAME}-0.${NF_DISCOVERY_SERVICE}:${COORDINATOR_PORT}}"
  export PROCESS_ID COORDINATOR_ADDRESS
  echo "Starting process ${PROCESS_ID}/${REPLICAS}, coordinator ${COORDINATOR_ADDRESS}"
else
  echo "Starting single-host run"
fi

export REPLICAS COORDINATOR_PORT

MAX_RESTARTS="${MAX_RESTARTS:-0}"
CHECKPOINT_DIR="${CHECKPOINT_DIR:-./checkpoints}"

if [ "${MAX_RESTARTS}" -le 0 ]; then
  # shellcheck disable=SC2086  # SCRIPT_ARGS is intentionally word-split
  exec "${cmd[@]}" ${SCRIPT_ARGS}
fi

# supervised mode: retry a crashed run, resuming from `latest`. The
# resume path must point where the trainer writes: a --checkpoint-dir
# inside SCRIPT_ARGS wins over the env fallback.
ckpt_dir="${CHECKPOINT_DIR}"
prev=""
for arg in ${SCRIPT_ARGS}; do
  if [ "${prev}" = "--checkpoint-dir" ]; then
    ckpt_dir="${arg}"
  fi
  case "${arg}" in
    --checkpoint-dir=*) ckpt_dir="${arg#--checkpoint-dir=}" ;;
  esac
  prev="${arg}"
done
resume_ckpt="${ckpt_dir}/latest_model.ckpt"

# run python in the background so this (possibly PID-1) shell can forward
# termination signals instead of absorbing them; a signal landing while no
# child is running (the backoff sleep) must still stop the loop
child=0
terminating=0
forward() {
  sig="$1"
  terminating=1
  if [ "${child}" -ne 0 ]; then
    kill -s "${sig}" "${child}" 2>/dev/null || true
  fi
}
trap 'forward TERM' TERM
trap 'forward INT' INT

# A later --resume wins in argparse, so appending ours overrides any
# caller-provided one on retries.
attempt=0
resume_args=""
while true; do
  set +e
  # shellcheck disable=SC2086
  "${cmd[@]}" ${SCRIPT_ARGS} ${resume_args} &
  child=$!
  wait "${child}"
  rc=$?
  # a second wait returns the real status if the first was interrupted by
  # a trapped signal arriving in this shell
  wait "${child}" 2>/dev/null
  rc2=$?
  [ "${rc2}" -ne 127 ] && rc="${rc2}"
  child=0
  set -e
  if [ "${rc}" -eq 0 ]; then
    exit 0
  fi
  # Only orchestrator teardown signals are exempt from restart: HUP (129),
  # INT (130), TERM (143) mean the platform wants us gone. Crash-by-signal
  # (OOM-kill 137, SIGSEGV 139, ...) is what MAX_RESTARTS exists to
  # recover, so it falls through to the restart path.
  if [ "${rc}" -eq 129 ] || [ "${rc}" -eq 130 ] || [ "${rc}" -eq 143 ] \
      || [ "${terminating}" -ne 0 ]; then
    echo "INFO: training terminated by orchestrator signal (rc=${rc});" \
         "not restarting" >&2
    exit "${rc}"
  fi
  attempt=$((attempt + 1))
  if [ "${attempt}" -gt "${MAX_RESTARTS}" ]; then
    echo "ERROR: training failed (rc=${rc}) after ${MAX_RESTARTS} restarts; giving up" >&2
    exit "${rc}"
  fi
  if [ -e "${resume_ckpt}" ]; then
    echo "WARN: training exited rc=${rc}; restart ${attempt}/${MAX_RESTARTS}," \
         "resuming from ${resume_ckpt}" >&2
  else
    echo "WARN: training exited rc=${rc}; restart ${attempt}/${MAX_RESTARTS};" \
         "no checkpoint at ${resume_ckpt} yet — restarting from scratch" >&2
  fi
  resume_args="--resume ${resume_ckpt}"
  sleep 2
  if [ "${terminating}" -ne 0 ]; then
    echo "INFO: teardown signal during backoff; not restarting" >&2
    exit 1
  fi
done
