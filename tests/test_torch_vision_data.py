"""The port's vision data path against the JAX package's, on the CPU:
synthetic images, the local-file loaders (on tiny files the tests write),
the augmentations (element for element for the same seed) and the
training CLI's model / dataset / class-count choices."""

import pickle

import numpy as np
import pytest
import torch

from distributed_pytorch_example_tpu.data import augment as jaug
from distributed_pytorch_example_tpu.data import synthetic as jsyn
from distributed_pytorch_example_tpu.data import vision as jvision
from distributed_pytorch_example_tpu_torch.data import (
    AugmentedDataset,
    SyntheticImageDataset,
    load_cifar10,
    load_digits,
    load_image_folder,
    pad_crop_flip,
    random_resized_crop_flip,
)
from distributed_pytorch_example_tpu_torch.data.augment import (
    _bilinear_resize,
)
from distributed_pytorch_example_tpu_torch.train import cli
from distributed_pytorch_example_tpu_torch.train.tasks import (
    ClassificationTask,
)


def _same_arrays(got: dict, want: dict) -> None:
    assert got.keys() == want.keys()
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_synthetic_images_equal_jax_s():
    kw = dict(num_samples=7, image_size=5, channels=3, num_classes=4, seed=3)
    got, want = SyntheticImageDataset(**kw), jsyn.SyntheticImageDataset(**kw)
    _same_arrays(got.arrays, want.arrays)
    assert got.num_classes == 4 and len(got) == 7
    _same_arrays(got.get_batch([4, 1]), want.get_batch(np.array([4, 1])))


def _batch(n=70, size=12, dtype=np.float32, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.random((n, size, size, 3)) * 255
    return {"x": x.astype(dtype), "y": np.arange(n, dtype=np.int32)}


@pytest.mark.parametrize("flip", [True, False])
def test_pad_crop_flip_equals_jax_s(flip):
    batch = _batch()
    got = pad_crop_flip(flip=flip, seed=5)
    want = jaug.pad_crop_flip(flip=flip, seed=5)
    for _ in range(2):  # the shared generator advances the same way
        _same_arrays(got(batch), want(batch))
    _same_arrays(got(batch, rng=np.random.default_rng(9)),
                 want(batch, rng=np.random.default_rng(9)))


def test_random_resized_crop_flip_equals_jax_s():
    batch = _batch(n=9, size=20)
    got = random_resized_crop_flip(size=8, seed=2)
    want = jaug.random_resized_crop_flip(size=8, seed=2)
    _same_arrays(got(batch), want(batch))
    _same_arrays(got(batch, rng=np.random.default_rng(4)),
                 want(batch, rng=np.random.default_rng(4)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape,size", [((7, 5, 3), 4), ((3, 9, 1), 11)])
def test_bilinear_resize_equals_jax_s(dtype, shape, size):
    crop = (np.random.default_rng(1).random(shape) * 255).astype(dtype)
    got, want = _bilinear_resize(crop, size), jaug._bilinear_resize(crop, size)
    assert got.dtype == want.dtype == dtype
    np.testing.assert_array_equal(got, want)


def test_augmented_dataset_follows_the_chunk_grid_for_any_worker_count():
    """70 rows = chunks of 32, 32 and 6, each with its own (seed, call,
    chunk) generator: three workers give what one gives, and what JAX's
    wrapper gives."""
    base = SyntheticImageDataset(num_samples=80, image_size=6, seed=0)
    jbase = jsyn.SyntheticImageDataset(num_samples=80, image_size=6, seed=0)
    idx = np.arange(3, 73)
    one = AugmentedDataset(base, pad_crop_flip(pad=2), workers=1, seed=7)
    three = AugmentedDataset(base, pad_crop_flip(pad=2), workers=3, seed=7)
    want = jaug.AugmentedDataset(jbase, jaug.pad_crop_flip(pad=2), workers=1,
                                 seed=7)
    try:
        for _ in range(2):
            w = want.get_batch(idx)
            _same_arrays(one.get_batch(idx), w)
            _same_arrays(three.get_batch(idx), w)
    finally:
        three.close()
    assert len(one) == 80 and one.num_classes == 10


def _write_cifar(root, n=3):
    """Tiny pickle batches in the canonical layout (3072 CHW bytes a row),
    each holding n rows."""
    d = root / "cifar-10-batches-py"
    d.mkdir()
    rng = np.random.default_rng(0)
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        rows = rng.integers(0, 256, (n, 3072), dtype=np.uint8)
        with open(d / name, "wb") as f:
            pickle.dump({b"data": rows,
                         b"labels": rng.integers(0, 10, n).tolist()}, f)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("normalize", [True, False])
def test_cifar10_loader_equals_jax_s(tmp_path, train, normalize):
    _write_cifar(tmp_path)
    got = load_cifar10(train=train, data_dir=str(tmp_path),
                       normalize=normalize)
    want = jvision.load_cifar10(train=train, data_dir=str(tmp_path),
                                normalize=normalize)
    _same_arrays(got.arrays, want.arrays)
    assert got.arrays["x"].shape == ((15 if train else 3), 32, 32, 3)
    assert got.num_classes == 10


def test_cifar10_missing_files_point_to_synthetic_images(tmp_path):
    with pytest.raises(FileNotFoundError, match="synthetic-image"):
        load_cifar10(data_dir=str(tmp_path))


def test_image_folder_loader_equals_jax_s(tmp_path):
    rng = np.random.default_rng(0)
    for cls, n in (("cat", 2), ("ant", 3)):
        (tmp_path / cls).mkdir()
        for i in range(n):
            np.save(tmp_path / cls / f"{i}.npy",
                    rng.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    (tmp_path / "ant" / "notes.txt").write_text("skipped")
    got = load_image_folder(str(tmp_path), image_size=4)
    want = jvision.load_image_folder(str(tmp_path), image_size=4)
    _same_arrays(got.arrays, want.arrays)
    assert got.arrays["y"].tolist() == [0, 0, 0, 1, 1]  # sorted: ant, cat
    with pytest.raises(ValueError, match="expected 8x8"):
        load_image_folder(str(tmp_path), image_size=8)
    with pytest.raises(FileNotFoundError, match="synthetic-image"):
        load_image_folder(str(tmp_path / "none"))


@pytest.mark.parametrize("train", [True, False])
def test_digits_loader_equals_jax_s(train):
    pytest.importorskip("sklearn")
    got, want = load_digits(train=train), jvision.load_digits(train=train)
    _same_arrays(got.arrays, want.arrays)
    assert got.num_classes == 10 and got.arrays["x"].shape[1:] == (32, 32, 3)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def _args(*argv):
    return cli.build_parser().parse_args(list(argv))


@pytest.fixture()
def built(monkeypatch):
    """What ``cli.build_model`` asks the registry for (nothing is built)."""
    seen = {}

    def record(name, **kw):
        seen.update(kw, name=name)
        return "model"

    monkeypatch.setattr(cli, "get_model", record)
    return seen


@pytest.mark.parametrize("name", ["resnet18", "resnet50"])
def test_cli_builds_resnets_on_synthetic_images(name, built):
    args = _args("--model", name, "--dataset", "synthetic-image",
                 "--image-size", "8", "--num-classes", "7", "--dtype",
                 "bfloat16")
    assert cli.build_model(args, torch.device("meta")) == "model"
    assert built == dict(name=name, num_classes=7, dtype=torch.bfloat16,
                         device=torch.device("meta"), seed=0)
    assert isinstance(cli.build_task(args, None), ClassificationTask)
    ds = cli.build_dataset(args, 5, seed=0)
    assert ds.arrays["x"].shape == (5, 8, 8, 3) and ds.num_classes == 7


def test_cli_builds_vit_at_the_images_size(built):
    args = _args("--model", "vit-b16", "--dataset", "cifar10-synthetic",
                 "--flash", "off")
    cli.build_model(args, torch.device("cpu"), image_size=24)
    assert built["name"] == "vit-b16" and built["image_size"] == 24
    assert built["use_flash"] is False and built["num_classes"] == 10
    assert "logits_mode" not in built


def test_cli_augments_image_datasets_only():
    args = _args("--model", "resnet18", "--dataset", "synthetic-image",
                 "--augment", "imagenet", "--image-size", "6",
                 "--augment-workers", "2")
    ds = cli.augment(args, cli.build_dataset(args, 4, seed=0), 64)
    assert isinstance(ds, AugmentedDataset) and ds.workers == 2
    assert ds.get_batch(np.arange(4))["x"].shape == (4, 6, 6, 3)
    assert cli.augment(_args(), "as is", 64) == "as is"
    with pytest.raises(SystemExit):
        cli.main(["--model", "gpt2", "--dataset", "synthetic-tokens",
                  "--augment", "cifar", "--device", "cpu"])
    with pytest.raises(SystemExit):  # a vision model on token data
        cli.main(["--model", "resnet18", "--dataset", "synthetic-tokens",
                  "--device", "cpu"])


class _Built(Exception):
    """Raised in place of building the model: the CLI got that far."""


def _classes_chosen(monkeypatch, argv, caplog):
    """``--num-classes`` as ``cli.main`` hands it to the model (main stops
    there), and the log."""
    def stop(args, device, image_size=None):
        raise _Built(args.num_classes)

    monkeypatch.setattr(cli, "build_model", stop)
    with caplog.at_level("INFO"), pytest.raises(_Built) as built:
        cli.main(argv + ["--device", "cpu", "--checkpoint-dir", ""])
    return built.value.args[0], caplog.text


def test_cli_num_classes_follows_the_dataset(tmp_path, monkeypatch, caplog):
    """The flag at its default takes the dataset's label space; a smaller
    explicit value is refused, a larger one is kept."""
    monkeypatch.setattr(cli, "build_dataset", lambda args, n, seed,
                        train=True: SyntheticImageDataset(
                            num_samples=n, image_size=4, num_classes=3))
    base = ["--model", "resnet18", "--dataset", "synthetic-image",
            "--batch-size", "4", "--num-samples", "8"]
    classes, log = _classes_chosen(monkeypatch, base, caplog)
    assert classes == 3 and "Using num_classes=3 from the dataset" in log
    assert _classes_chosen(monkeypatch, base + ["--num-classes", "12"],
                           caplog)[0] == 12
    with pytest.raises(SystemExit):
        cli.main(base + ["--num-classes", "2", "--device", "cpu"])


def test_cli_reads_cifar10_from_the_data_dir(tmp_path, monkeypatch, caplog):
    _write_cifar(tmp_path, n=2)
    classes, _ = _classes_chosen(monkeypatch, [
        "--model", "resnet18", "--dataset", "cifar10", "--data-dir",
        str(tmp_path), "--batch-size", "4"], caplog)
    assert classes == 10


def test_cli_runs_resnet18_on_synthetic_images(caplog):
    with caplog.at_level("INFO"):
        rc = cli.main(["--model", "resnet18", "--dataset", "synthetic-image",
                       "--image-size", "8", "--batch-size", "4",
                       "--num-samples", "8", "--augment", "cifar",
                       "--augment-workers", "1", "--device", "cpu",
                       "--epochs", "1", "--checkpoint-dir", "",
                       "--log-every", "100"])
    assert rc == 0 and "Training completed" in caplog.text
