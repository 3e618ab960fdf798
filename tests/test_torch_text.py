"""The port's token files and data sidecars against the JAX package's.

A corpus written as ``.npy`` or as a raw uint16 ``.bin`` gives the same
windows (single and batched, default and overlapping strides) through
both packages' ``load_token_file``. A ``DPX-CRC1`` sidecar sealed by
either package is byte for byte the other's and verifies there; one
flipped byte in the data, or in the sidecar, fails both packages'
checks, and ``load_token_file`` raises ``ShardCorruptError``.
"""

import numpy as np
import pytest

from distributed_pytorch_example_tpu.data import intake as jax_intake
from distributed_pytorch_example_tpu.data import text as jax_text
from distributed_pytorch_example_tpu_torch.data import intake, text

IDS = (np.random.default_rng(0).integers(0, 30522, 5000)).astype(np.uint16)
PACKAGES = {"port": (text, intake), "jax": (jax_text, jax_intake)}


@pytest.mark.parametrize("stride", [None, 100], ids=["windows", "overlap"])
@pytest.mark.parametrize("suffix", [".npy", ".bin"])
def test_windows_match_jax(tmp_path, suffix, stride):
    path = str(tmp_path / f"corpus{suffix}")
    text.write_token_file(path, IDS)
    got = text.load_token_file(path, seq_len=128, dtype="uint16",
                               stride=stride)
    want = jax_text.load_token_file(path, seq_len=128, dtype="uint16",
                                    stride=stride)
    assert len(got) == len(want) > 1
    idx = [0, len(want) - 1, 3, 3]
    for key, value in want.get_batch(idx).items():
        assert got.get_batch(idx)[key].dtype == value.dtype == np.int32
        np.testing.assert_array_equal(got.get_batch(idx)[key], value)
    np.testing.assert_array_equal(got[2]["tokens"], want[2]["tokens"])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_sidecar_sealed_by_one_package_verifies_in_the_other(
        tmp_path, writer, reader):
    path = str(tmp_path / "train.bin")
    PACKAGES[writer][0].write_token_file(path, IDS)
    side = open(path + ".dpxcrc", "rb").read()
    PACKAGES[reader][1].seal_file(path)
    assert open(path + ".dpxcrc", "rb").read() == side  # the same bytes
    PACKAGES[writer][1].seal_file(path)
    assert PACKAGES[reader][1].verify_file(path) is True
    assert PACKAGES[reader][0].load_token_file(path, seq_len=64).ids.size \
        == IDS.size


@pytest.mark.parametrize("target", ["data", "sidecar"])
def test_a_flipped_byte_fails_in_both_packages(tmp_path, target):
    path = str(tmp_path / "train.bin")
    text.write_token_file(path, IDS)
    victim = path if target == "data" else path + ".dpxcrc"
    blob = bytearray(open(victim, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    open(victim, "wb").write(bytes(blob))
    for name, (txt, itk) in PACKAGES.items():
        assert itk.verify_file(path) is False, name
        with pytest.raises(itk.ShardCorruptError):
            txt.load_token_file(path, seq_len=64)
        # the check can be waived for a corpus known to be intact
        assert len(txt.load_token_file(path, seq_len=64, verify=False)) > 0


def test_unsealed_and_missing_files(tmp_path):
    path = str(tmp_path / "legacy.npy")
    text.write_token_file(path, IDS, seal=False)
    assert intake.verify_file(path) is None  # legacy: loads unverified
    assert len(text.load_token_file(path, seq_len=64)) == IDS.size // 64
    with pytest.raises(FileNotFoundError, match="synthetic-tokens"):
        text.load_token_file(str(tmp_path / "absent.bin"), seq_len=64)
    with pytest.raises(ValueError, match="shorter than one window"):
        text.TokenWindowDataset(IDS[:10], seq_len=64)
