"""``--cache_dataset`` (the default) in the port on the CPU:

- ``UMPRDataset.save`` / ``load`` round trips: a directory of .npy files
  with its marker (loaded as read-only memmaps) and the legacy .npz;
- a cache written by the JAX package loads in the port, and the other way
  round, with the arrays equal;
- ``main``: the first run builds and caches each split, a second run on
  the same data_dir loads them (logged) and trains the same bits,
  uploading the memmaps of the resident corpus without a warning; a cache
  without its marker is built again; ``--cache_dataset False`` writes
  nothing."""

import dataclasses
import json
import warnings

import numpy as np
import pytest
import torch

from tests.test_device_dataset import packed_dataset
from tests.test_torch_train import _splits
from umpr_tpu.data.dataset import UMPRDataset as JaxDataset
from umpr_tpu_torch import main as port_main
from umpr_tpu_torch.data.dataset import UMPRDataset


@pytest.fixture(autouse=True)
def fixed_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _dataset():
    ds = packed_dataset(6, seed=2)
    paths = np.array([[[f"photos/p{i}.jpg"]] for i in range(6)], dtype=np.str_)
    paths[2, 0, 0] = ""
    return UMPRDataset(**{**{f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)},
                          "photo_paths": paths, "source_rows": np.arange(3, 9)})


def _assert_equal(a, b):
    for f in dataclasses.fields(UMPRDataset):
        x, y = getattr(a, f.name), getattr(b, f.name)
        assert x.dtype == y.dtype and x.shape == y.shape, f.name
        np.testing.assert_array_equal(x, y, err_msg=f.name)


@pytest.mark.parametrize("form", ["dataset.cache", "dataset.npz"])
def test_save_and_load_round_trip(form, tmp_path):
    ds = _dataset()
    ds.save(tmp_path / form)
    back = UMPRDataset.load(str(tmp_path / form))
    _assert_equal(back, ds)
    if form.endswith(".cache"):
        assert (tmp_path / form / "complete.marker").exists()
        assert isinstance(back.u_tokens, np.memmap) and not back.u_tokens.flags.writeable
        (tmp_path / form / "complete.marker").unlink()  # a save cut short
        with pytest.raises(FileNotFoundError, match="incomplete"):
            UMPRDataset.load(str(tmp_path / form))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_cache_of_either_package_loads_in_the_other(writer, tmp_path):
    ds = _dataset()
    jds = JaxDataset(**{f.name: getattr(ds, f.name) for f in dataclasses.fields(ds)})
    for form in ("dataset.cache", "dataset.npz"):
        path = str(tmp_path / form)
        (jds if writer == "jax" else ds).save(path)
        back = (UMPRDataset if writer == "jax" else JaxDataset).load(path)
        _assert_equal(back, ds)


def _main(tmp_path, glove, name, *flags):
    argv = ["--device", "cpu", "--review_net_only", "True", "--batch_size", "8",
            "--max_sent_count", "6", "--max_sent_length", "10", "--max_ui_sent_count", "2",
            "--min_sent_count", "3", "--gru_size", "16", "--self_atte_size", "8",
            "--train_epochs", "1", "--eval_every", "100", "--learning_rate", "1e-3",
            "--data_dir", str(tmp_path), "--word2vec_file", glove,
            "--model_path", str(tmp_path / name), "--log_path", str(tmp_path / f"{name}.log"),
            *flags]
    trainer = port_main.main(argv)
    return trainer, (tmp_path / f"{name}.log").read_text()


def test_main_caches_each_split_and_a_second_run_loads_it(tmp_path):
    glove = _splits(tmp_path)
    # a cache dir without its marker (a save cut short) is built again
    (tmp_path / "dataset_valid.cache").mkdir()
    first, log1 = _main(tmp_path, glove, "first")
    assert "Loaded" not in log1
    for split in ("train", "valid", "test"):
        assert (tmp_path / f"dataset_{split}.cache" / "complete.marker").exists(), split
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        second, log2 = _main(tmp_path, glove, "second")
    assert not [w for w in caught if "writable" in str(w.message)]
    for split in ("train", "valid", "test"):
        assert f"Loaded {split} dataset from {tmp_path / f'dataset_{split}.cache'}!" in log2
    assert second._resident and first.batch_counter == second.batch_counter > 0
    for k, v in first.model.state_dict().items():
        assert torch.equal(v, second.model.state_dict()[k]), k


def test_cache_dataset_false_writes_nothing(tmp_path):
    glove = _splits(tmp_path)
    before = sorted(p.name for p in tmp_path.iterdir())
    _, log = _main(tmp_path, glove, "run", "--cache_dataset", "False")
    after = sorted(p.name for p in tmp_path.iterdir() if p.name not in ("run", "run.log"))
    assert after == before and "Loaded" not in log
