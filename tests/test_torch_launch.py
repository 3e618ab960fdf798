"""The port's launcher (``distributed_pytorch_example_tpu_torch/launch/``)
against the JAX launcher's contract, on the CPU.

Every case of ``tests/test_launch.py`` runs the port's ``entrypoint.sh``
with a stub ``TRAINING_SCRIPT`` that prints the topology it was handed:
the hostname derivation, fail-fast on a missing discovery service or a
non-numeric hostname, a custom port, ``MAX_RESTARTS`` with ``--resume``
appended (``--checkpoint-dir`` in both spellings), the last exit code
after the restarts, no restart after a teardown signal, a restart after a
crash signal. Beyond them:

- the default command is ``python -m
  distributed_pytorch_example_tpu_torch.train`` (a stub ``python`` first
  on ``PATH`` shows what would run), ``DPX_ELASTIC`` reaches it, and
  ``NPROC_PER_NODE`` other than 1 is refused, naming ROADMAP.md item 11;
- the port's ``resolve_config`` derives what the shell derives;
- the port's trainer on the CPU through the launcher: two ranks under
  ZeRO-1 (gloo), both killed by a chaos ``kill`` at one step boundary
  (SIGKILL, rc 137), restart from the sharded ``latest`` and end in the
  uninterrupted pair's final state bit for bit; SIGTERM to a one-process
  launcher reaches the trainer, which saves and exits 143, and is not
  restarted;
- the Dockerfile: a CUDA PyTorch devel base, the port package copied and
  the JAX package not, the kernel build at image build time, and the
  port's entrypoint.
"""

import json
import os
import re
import signal
import socket
import subprocess
import sys

import numpy as np

from distributed_pytorch_example_tpu_torch.models import SimpleNet
from distributed_pytorch_example_tpu_torch.runtime.distributed import (
    derive_coordinator_address,
    derive_process_id,
    resolve_config,
)
from distributed_pytorch_example_tpu_torch.train import (
    TrainState,
    make_optimizer,
)
from distributed_pytorch_example_tpu_torch.train import checkpoint as ckpt
from distributed_pytorch_example_tpu_torch.train.state import (
    train_state_to_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH = os.path.join(REPO, "distributed_pytorch_example_tpu_torch", "launch")
ENTRYPOINT = os.path.join(LAUNCH, "entrypoint.sh")
# the launcher runs `python`: this interpreter's
PATH = os.pathsep.join([os.path.dirname(sys.executable), os.environ["PATH"]])


def _env(**extra):
    return {"PATH": PATH, **extra}


def _launch(env, timeout=60):
    return subprocess.run(["bash", ENTRYPOINT], env=env, capture_output=True,
                          text=True, timeout=timeout)


def run_entrypoint(env_extra, tmp_path):
    stub = tmp_path / "stub.py"
    stub.write_text(
        "import json, os\n"
        "print(json.dumps({k: os.environ.get(k) for k in "
        "('PROCESS_ID', 'COORDINATOR_ADDRESS', 'REPLICAS', "
        "'COORDINATOR_PORT', 'DPX_ELASTIC')}))\n"
    )
    proc = _launch(_env(TRAINING_SCRIPT=str(stub), **env_extra))
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _counting_stub(tmp_path, body):
    """A stub that counts its runs in a marker file and prints its args."""
    stub = tmp_path / "stub.py"
    marker = tmp_path / "attempts"
    stub.write_text(
        "import os, pathlib, signal, sys\n"
        f"m = pathlib.Path({str(marker)!r})\n"
        "n = int(m.read_text()) if m.exists() else 0\n"
        "m.write_text(str(n + 1))\n"
        "print('ARGS:' + ' '.join(sys.argv[1:]))\n" + body
    )
    return stub, marker


def _args_lines(proc):
    return [line for line in proc.stdout.splitlines()
            if line.startswith("ARGS:")]


def test_single_host_no_env_needed(tmp_path):
    out = run_entrypoint({}, tmp_path)
    assert out["REPLICAS"] == "1"
    assert out["PROCESS_ID"] is None  # resolve_config defaults to 0


def test_multi_host_derivation(tmp_path):
    out = run_entrypoint({"REPLICAS": "4", "HOSTNAME": "trainer-3",
                          "NF_DISCOVERY_SERVICE": "svc.ns.local"}, tmp_path)
    assert out["PROCESS_ID"] == "3"
    assert out["COORDINATOR_ADDRESS"] == "trainer-0.svc.ns.local:29500"
    assert out["COORDINATOR_PORT"] == "29500"


def test_explicit_topology_wins(tmp_path):
    """PROCESS_ID and COORDINATOR_ADDRESS set by hand (ranks sharing one
    machine) are handed on as they are."""
    out = run_entrypoint({"REPLICAS": "2", "HOSTNAME": "box",
                          "NF_DISCOVERY_SERVICE": "unused",
                          "PROCESS_ID": "1",
                          "COORDINATOR_ADDRESS": "127.0.0.1:4242"}, tmp_path)
    assert out["PROCESS_ID"] == "1"
    assert out["COORDINATOR_ADDRESS"] == "127.0.0.1:4242"


def test_multi_host_missing_discovery_fails_fast(tmp_path):
    stub = tmp_path / "stub.py"
    stub.write_text("print('should not run')\n")
    proc = _launch(_env(REPLICAS="2", TRAINING_SCRIPT=str(stub),
                        HOSTNAME="x-1"))
    assert proc.returncode == 1
    assert "NF_DISCOVERY_SERVICE" in proc.stderr
    assert "should not run" not in proc.stdout


def test_non_numeric_hostname_fails_fast(tmp_path):
    proc = _launch(_env(REPLICAS="2", NF_DISCOVERY_SERVICE="svc",
                        HOSTNAME="nosuffix", TRAINING_SCRIPT="unused.py"))
    assert proc.returncode == 1
    assert "PROCESS_ID" in proc.stderr


def test_python_side_derivation_matches_shell(tmp_path):
    """The port's resolve_config derives the topology entrypoint.sh does,
    from the same environment."""
    assert derive_process_id("worker-7") == 7
    assert derive_process_id("nosuffix") == 0
    assert (derive_coordinator_address("myjob-3", "svc", 29500)
            == "myjob-0.svc:29500")
    env = {"REPLICAS": "4", "HOSTNAME": "myjob-2",
           "NF_DISCOVERY_SERVICE": "svc", "COORDINATOR_PORT": "31337"}
    cfg = resolve_config(env)
    shell = run_entrypoint(env, tmp_path)
    assert cfg.num_processes == int(shell["REPLICAS"]) == 4
    assert cfg.process_id == int(shell["PROCESS_ID"]) == 2
    assert cfg.coordinator_address == shell["COORDINATOR_ADDRESS"] == (
        "myjob-0.svc:31337")
    # and from what the shell exports, the same config again
    assert resolve_config({k: v for k, v in shell.items() if v}) == cfg


def test_custom_port(tmp_path):
    out = run_entrypoint({"REPLICAS": "2", "HOSTNAME": "w-1",
                          "NF_DISCOVERY_SERVICE": "d",
                          "COORDINATOR_PORT": "12345"}, tmp_path)
    assert out["COORDINATOR_ADDRESS"] == "w-0.d:12345"
    out = run_entrypoint({"REPLICAS": "2", "HOSTNAME": "w-1",
                          "NF_DISCOVERY_SERVICE": "d",
                          "MASTER_PORT": "23456"}, tmp_path)
    assert out["COORDINATOR_ADDRESS"] == "w-0.d:23456"


def test_default_command_is_the_port_trainer(tmp_path):
    """No TRAINING_SCRIPT: the port's training module, with SCRIPT_ARGS;
    DPX_ELASTIC goes through to it."""
    fake = tmp_path / "python"
    fake.write_text('#!/bin/bash\necho "CMD:$*"\necho "ELASTIC:$DPX_ELASTIC"\n')
    fake.chmod(0o755)
    proc = _launch({"PATH": f"{tmp_path}{os.pathsep}{PATH}",
                    "SCRIPT_ARGS": "--epochs 2 --zero1",
                    "DPX_ELASTIC": "1"})
    assert proc.returncode == 0, proc.stderr
    assert ("CMD:-m distributed_pytorch_example_tpu_torch.train --epochs 2 "
            "--zero1") in proc.stdout
    assert "ELASTIC:1" in proc.stdout
    out = run_entrypoint({"DPX_ELASTIC": "1"}, tmp_path)
    assert out["DPX_ELASTIC"] == "1"


def test_nproc_per_node_other_than_one_is_refused(tmp_path):
    stub = tmp_path / "stub.py"
    stub.write_text("print('should not run')\n")
    proc = _launch(_env(NPROC_PER_NODE="2", TRAINING_SCRIPT=str(stub)))
    assert proc.returncode == 1
    assert "NPROC_PER_NODE" in proc.stderr and "item 11" in proc.stderr
    assert "should not run" not in proc.stdout
    assert run_entrypoint({"NPROC_PER_NODE": "1"}, tmp_path)["REPLICAS"] == "1"


def test_max_restarts_resumes_after_crash(tmp_path):
    stub, marker = _counting_stub(tmp_path, "sys.exit(1 if n < 2 else 0)\n")
    proc = _launch(_env(TRAINING_SCRIPT=str(stub), SCRIPT_ARGS="--epochs 5",
                        MAX_RESTARTS="3", CHECKPOINT_DIR="/ck"))
    assert proc.returncode == 0, proc.stderr
    lines = _args_lines(proc)
    assert lines[0] == "ARGS:--epochs 5"  # first run: no resume
    assert lines[1] == "ARGS:--epochs 5 --resume /ck/latest_model.ckpt"
    assert lines[2] == "ARGS:--epochs 5 --resume /ck/latest_model.ckpt"
    assert marker.read_text() == "3"
    assert proc.stderr.count("WARN: training exited") == 2


def test_max_restarts_exhausted_fails_with_last_rc(tmp_path):
    stub = tmp_path / "stub.py"
    stub.write_text("import sys; sys.exit(7)\n")
    proc = _launch(_env(TRAINING_SCRIPT=str(stub), MAX_RESTARTS="2"))
    assert proc.returncode == 7
    assert "giving up" in proc.stderr
    assert proc.stderr.count("WARN: training exited") == 2


def test_restart_resume_dir_follows_script_args(tmp_path):
    stub, _ = _counting_stub(tmp_path, "sys.exit(1 if n < 1 else 0)\n")
    proc = _launch(_env(TRAINING_SCRIPT=str(stub),
                        SCRIPT_ARGS="--checkpoint-dir /mnt/ckpt --epochs 9",
                        MAX_RESTARTS="2", CHECKPOINT_DIR="/wrong"))
    assert proc.returncode == 0, proc.stderr
    assert _args_lines(proc)[1].endswith(
        "--resume /mnt/ckpt/latest_model.ckpt")
    assert "/wrong" not in proc.stdout


def test_restart_loop_does_not_fight_signals(tmp_path):
    stub = tmp_path / "stub.py"
    stub.write_text("import os, signal\nos.kill(os.getpid(), signal.SIGTERM)\n")
    proc = _launch(_env(TRAINING_SCRIPT=str(stub), MAX_RESTARTS="3"))
    assert proc.returncode > 128
    assert "not restarting" in proc.stderr
    assert "WARN: training exited" not in proc.stderr


def test_restart_loop_recovers_crash_signals(tmp_path):
    stub, marker = _counting_stub(
        tmp_path,
        "if n == 0:\n    os.kill(os.getpid(), signal.SIGKILL)\nsys.exit(0)\n")
    proc = _launch(_env(TRAINING_SCRIPT=str(stub), MAX_RESTARTS="2",
                        CHECKPOINT_DIR="/ck"))
    assert proc.returncode == 0, proc.stderr
    assert marker.read_text() == "2"
    assert "restart 1/2" in proc.stderr


def test_restart_resume_dir_equals_form(tmp_path):
    stub, _ = _counting_stub(tmp_path, "sys.exit(1 if n < 1 else 0)\n")
    proc = _launch(_env(TRAINING_SCRIPT=str(stub),
                        SCRIPT_ARGS="--checkpoint-dir=/mnt/eq --epochs 9",
                        MAX_RESTARTS="2"))
    assert proc.returncode == 0, proc.stderr
    assert _args_lines(proc)[1].endswith("--resume /mnt/eq/latest_model.ckpt")


# ---------------------------------------------------------------------------
# the port's trainer through the launcher, on the CPU
# ---------------------------------------------------------------------------

# SimpleNet at its widths under ZeRO-1 at world 2, 4 rows a rank: 8 steps,
# `latest` (auto: the sharded format at world 2) every 2 steps
CLI = ("--device cpu --epochs 1 --num-samples 64 --batch-size 4 --seed 3 "
       "--zero1 --save-every-steps 2 --checkpoint-retain 2")
# SIGKILL after the 7th step: `latest` then holds step 2, 4 or 6, so the
# restarted run takes at most 6 steps and never reaches the 7th boundary
KILL = '{"faults":[{"kind":"kill","at":"step","nth":7}]}'


def _trainer_env(**extra):
    return {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "2",
            "PATH": PATH, **extra}


def _pair(ckdir, **extra):
    """Two ranks through the launcher (explicit PROCESS_ID and coordinator,
    a dummy discovery service), each in its own session; their logs."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        ["bash", ENTRYPOINT], cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True,
        env=_trainer_env(REPLICAS="2", PROCESS_ID=str(rank),
                         COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                         NF_DISCOVERY_SERVICE="unused",
                         SCRIPT_ARGS=f"{CLI} --checkpoint-dir {ckdir}",
                         **extra)) for rank in range(2)]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return logs


def _final_state(ckdir):
    """The run's final `latest` (either format), loaded at world 1."""
    model = SimpleNet(device="cpu", seed=11)
    state = TrainState(step=0, model=model,
                       optimizer=make_optimizer(model.parameters()))
    _, epoch, _ = ckpt.load_checkpoint(
        os.path.join(ckdir, ckpt.LATEST_NAME), state)
    return epoch, train_state_to_flax(state)


def _assert_same(a, b, what=""):
    if isinstance(b, dict):
        assert set(a) == set(b), what
        for k in b:
            _assert_same(a[k], b[k], f"{what}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), what)


def test_chaos_kill_restarts_both_ranks_and_resumes_bit_identically(
        tmp_path):
    """Both ranks SIGKILLed at the same step boundary (a chaos plan through
    DPX_CHAOS): each launcher restarts its rank with --resume, the pair
    meets again on the same port, resumes from the pointer's version and
    ends in the uninterrupted run's final state bit for bit."""
    victim, ctrl = str(tmp_path / "victim"), str(tmp_path / "ctrl")
    logs = _pair(victim, MAX_RESTARTS="1", DPX_CHAOS=KILL)
    for log in logs:
        assert "SIGKILL at crash point 'step' (visit 7)" in log
        assert "restart 1/1, resuming from" in log
        assert re.search(r"Resuming epoch 0 at batch [246]/8", log)
    with open(os.path.join(victim, ckpt.LATEST_NAME), "rb") as f:
        assert f.read().startswith(ckpt.SHARDED_MAGIC)
    _pair(ctrl)
    (e1, s1), (e2, s2) = _final_state(victim), _final_state(ctrl)
    assert e1 == e2 == 1 and int(s1["step"]) == 8
    _assert_same(s1, s2)


def test_sigterm_to_the_launcher_saves_and_is_not_restarted(tmp_path):
    ckdir = str(tmp_path / "ck")
    launcher = subprocess.Popen(
        ["bash", ENTRYPOINT], cwd=REPO, stderr=subprocess.PIPE,
        stdout=subprocess.DEVNULL, text=True, env=_trainer_env(
            MAX_RESTARTS="2",
            SCRIPT_ARGS="--device cpu --epochs 1 --num-samples 40000 "
                        f"--batch-size 2 --log-every 1 --checkpoint-dir "
                        f"{ckdir}"))
    seen = []
    try:
        for line in launcher.stderr:
            seen.append(line)
            if re.search(r"Epoch 0, Batch \d+/\d+, Loss", line):
                launcher.send_signal(signal.SIGTERM)
                break
        seen += launcher.stderr.readlines()
        rc = launcher.wait(timeout=120)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.wait()
    log = "".join(seen)
    assert rc == 143, log[-2000:]
    assert "Preemption checkpoint complete" in log
    assert "not restarting" in log and "WARN: training exited" not in log
    epoch, state = _final_state(ckdir)
    assert epoch == 0 and int(state["step"]) > 0


# ---------------------------------------------------------------------------
# the image
# ---------------------------------------------------------------------------


def test_dockerfile_builds_the_port_on_a_cuda_devel_base():
    with open(os.path.join(LAUNCH, "Dockerfile")) as f:
        text = f.read()
    lines = [line.strip() for line in text.splitlines()
             if line.strip() and not line.lstrip().startswith("#")]
    (base,) = [line for line in lines if line.startswith("FROM ")]
    assert re.fullmatch(r"FROM pytorch/pytorch:2\.11\.\d+-cuda12\.8-"
                        r"cudnn\d+-devel", base), base
    copies = [line for line in lines if line.startswith("COPY ")]
    assert any("distributed_pytorch_example_tpu_torch/ " in c
               for c in copies)
    assert not any(re.search(r"distributed_pytorch_example_tpu/|train\.py|"
                             r"requirements\.txt", c) for c in copies)
    assert "jax" not in " ".join(lines).lower()
    assert "build_all()" in text and "rm -rf" in text
    assert 'ENTRYPOINT ["/workspace/entrypoint.sh"]' in lines
    assert any(c.endswith("launch/entrypoint.sh /workspace/entrypoint.sh")
               for c in copies)
    env = " ".join(line for line in lines if "=" in line)
    assert "REPLICAS=2" in env and "COORDINATOR_PORT=29500" in env
