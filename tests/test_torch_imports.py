"""The port stands alone, and its entry points default to the card.

An AST scan shows that no module of the port, and not ``chip_smoke.py``,
imports JAX, flax, msgpack or the JAX package (nor do the port's
profiling script and the card's test file, which run where JAX is not
installed): the card's machine has none of them, so the checkpoint codec
is the port's own (``utils/msgpack.py``).
Without a visible CUDA device, an entry point given no device raises
instead of running on the CPU.
"""

import ast
import pathlib

import pytest
import torch

import distributed_pytorch_example_tpu_torch as port
from distributed_pytorch_example_tpu_torch.models import GPT2
from distributed_pytorch_example_tpu_torch.serve import main as serve_main
from distributed_pytorch_example_tpu_torch.serving import InferenceEngine
from distributed_pytorch_example_tpu_torch.train import main as train_main

torch.set_num_threads(2)

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "msgpack",
             "distributed_pytorch_example_tpu"}
KW = dict(vocab_size=97, max_len=64, model_dim=32, num_layers=1,
          num_heads=2, mlp_dim=64)
PAGED = dict(paged_num_blocks=8, paged_block_size=4, paged_max_blocks=4)


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
            node.func, "attr", getattr(node.func, "id", "")
        ) in ("import_module", "__import__") and node.args and isinstance(
            node.args[0], ast.Constant
        ):
            roots.add(str(node.args[0].value).split(".")[0])
    return roots


def test_port_and_chip_smoke_import_no_jax():
    files = sorted(pathlib.Path(port.__file__).parent.rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "scripts" / "profile_torch_serve.py",
              ROOT / "scripts" / "profile_torch_train.py",
              ROOT / "scripts" / "probe_peer_ipc.py",
              ROOT / "scripts" / "ring_nvlink.py",
              ROOT / "scripts" / "bench_flash.py",
              ROOT / "scripts" / "k3_device_time.py",
              ROOT / "tests" / "test_torch_cuda.py"]
    assert len(files) > 10
    for path in files:
        bad = _imported_roots(path) & FORBIDDEN
        assert not bad, f"{path.relative_to(ROOT)} imports {sorted(bad)}"


def test_scan_catches_a_jax_import(tmp_path):
    src = tmp_path / "m.py"
    src.write_text(
        "import os\nfrom distributed_pytorch_example_tpu.serving import x\n"
        "from distributed_pytorch_example_tpu_torch import y\n"
        "from distributed_pytorch_example_tpu_torch.utils import msgpack\n"
        "import msgpack\nfrom flax import serialization\n"
    )
    assert _imported_roots(src) & FORBIDDEN == {
        "distributed_pytorch_example_tpu", "msgpack", "flax"
    }


def test_entry_points_without_cuda_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPT2(**KW, decode=True, **PAGED)
    model = GPT2(**KW, decode=True, **PAGED, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--requests", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--epochs", "1", "--num-samples", "64"])
    # device="cpu" is the explicit way onto the CPU
    engine = InferenceEngine(model, device="cpu")
    assert engine.device == torch.device("cpu")


def test_engine_refuses_out_of_slice_options():
    model = GPT2(**KW, decode=True, **PAGED, device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(model, device="cpu", spec_tokens=4)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        InferenceEngine(model, device="cpu", partitioner=object())
    engine = InferenceEngine(model, device="cpu")
    for call in (lambda: engine.install_params({}, "v1"),
                 engine.serve_loop, engine.lowered_programs,
                 engine.traced_programs, lambda: engine.plan_programs(None)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            call()
    with pytest.raises(SystemExit):
        serve_main(["--family", "llama", "--device", "cpu"])


def test_train_cli_refuses_flags_outside_the_slice():
    for argv in (["--publish-dir", "/tmp/pub"], ["--mesh-tensor", "2"], ["--model", "llama"],
                 ["--checkpoint-format", "sharded"],
                 ["--optimizer", "adafactor"], ["--optimizer", "lamb", "--zero1"],
                 ["--model", "gpt2", "--dataset", "synthetic"]):
        with pytest.raises(SystemExit):
            train_main(argv + ["--device", "cpu"])
