"""The port's host layers against the JAX package: vocabulary, batch
loader (dead-row padding, photos) and masking helpers, on the same
inputs."""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_checkpoint_loader import small_dataset
from umpr_tpu.data.loader import BatchLoader as JaxBatchLoader
from umpr_tpu.ops import masking as jmasking
from umpr_tpu.text.vocab import Word2vec as JaxWord2vec
from umpr_tpu_torch.data.loader import BatchLoader
from umpr_tpu_torch.ops import masking
from umpr_tpu_torch.text.vocab import Word2vec

SENTENCES = ["great sound quality", "the album. has 12 tracks",
             "  unknownword  great. ", "", "a b c d e f g h", "12 34 great"]


def _write(path, lines):
    path.write_text("".join(line + "\n" for line in lines))
    return str(path)


@pytest.mark.parametrize("fmt", ["glove", "word2vec", "duplicate"])
def test_word2vec_matches_jax(tmp_path, fmt):
    rng = np.random.default_rng(0)
    words = ["great", "sound", "quality", "the", "album", "has", "tracks", "a"]
    if fmt == "duplicate":  # the reference's id-shift quirk
        words = words + ["sound", "b"]
    rows = [w + " " + " ".join(f"{x:.5f}" for x in rng.standard_normal(4))
            for w in words]
    if fmt == "word2vec":
        rows = [f"{len(rows)} 4"] + rows
    path = _write(tmp_path / "emb.txt", rows)
    w, jw = Word2vec(path), JaxWord2vec(path)
    np.testing.assert_array_equal(w.embedding, jw.embedding)
    assert w.word2index == jw.word2index and w.vocab == jw.vocab
    for s in SENTENCES:
        for align in (0, 3, 10):
            assert w.sent2indices(s, align) == jw.sent2indices(s, align), (s, align)


def test_gensim_model_file_raises(tmp_path):
    """A pickle on the glove path is read as a gensim model: a truncated
    one raises the unpickler's error, in both packages."""
    import pickle
    path = tmp_path / "model.bin"
    path.write_bytes(b"\x80\x04\x95")
    for cls in (Word2vec, JaxWord2vec):
        with pytest.raises(pickle.UnpicklingError, match="truncated"):
            cls(str(path))


@pytest.mark.parametrize("n", [8, 10])
def test_batch_loader_matches_jax_with_dead_rows(n):
    ds = small_dataset(n=n)
    ours = list(BatchLoader(ds, 4))
    theirs = list(JaxBatchLoader(ds, 4, ignore_photos=True))
    assert len(ours) == len(theirs) == -(-n // 4)
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert (ours[-1]["sample_mask"] == 0).sum() == (-n) % 4


def test_masking_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 6)).astype(np.float32)
    mask = rng.random((3, 5, 6)) < 0.6
    mask[0, 0] = False  # an all-masked row: 0/0 as in the JAX package
    for axis in (-1, 1):
        np.testing.assert_allclose(
            masking.masked_softmax(torch.from_numpy(x), torch.from_numpy(mask), dim=axis),
            jmasking.masked_softmax(jnp.asarray(x), jnp.asarray(mask), axis=axis),
            rtol=1e-6, atol=1e-7, equal_nan=True)
        np.testing.assert_array_equal(
            masking.masked_max(torch.from_numpy(x), torch.from_numpy(mask), dim=axis),
            jmasking.masked_max(jnp.asarray(x), jnp.asarray(mask), axis=axis))
    np.testing.assert_array_equal(
        masking.exists_mask(3, 4, 5, 6, "cpu").numpy(),
        np.asarray(jmasking.exists_mask(3, 4, 5, 6)))


def _jpegs(tmp_path, n=10, V=2, P=2):
    """A dataset whose photo slots name JPEGs written with cv2 (odd sizes,
    so the resize runs), an unreadable file and empty slots."""
    import cv2
    rng = np.random.default_rng(5)
    ds = small_dataset(n=n, V=V, P=P)
    paths = []
    for i in range(4):
        path = str(tmp_path / f"p{i}.jpg")
        img = rng.integers(0, 256, (30 + 7 * i, 41, 3)).astype(np.uint8)
        assert cv2.imwrite(path, img)
        paths.append(path)
    (tmp_path / "broken.jpg").write_bytes(b"not a jpeg")
    paths += [str(tmp_path / "broken.jpg"), str(tmp_path / "missing.jpg"), ""]
    ds.photo_paths = rng.choice(np.asarray(paths), size=(n, V, P))
    return ds


@pytest.mark.parametrize("workers,cache", [(0, False), (3, True)])
def test_loader_photos_equal_jax_loader(tmp_path, workers, cache):
    from umpr_tpu.data.images import PhotoCache as JaxPhotoCache
    from umpr_tpu_torch.data.images import PhotoCache
    ds = _jpegs(tmp_path)
    kw = dict(ignore_photos=False, resize=(24, 16), workers=workers)
    ours = list(BatchLoader(ds, 4, photo_cache=PhotoCache() if cache else None, **kw))
    theirs = list(JaxBatchLoader(ds, 4, photo_cache=JaxPhotoCache() if cache else None,
                                 **kw))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a.keys() == b.keys() and a["photos"].dtype == np.uint8
        assert a["photos"].shape == (4, 2, 2, 16, 24, 3)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert ours[0]["photos"].any()  # real pixels were decoded
    assert not ours[-1]["photos"][2:].any()  # the dead rows' slots are empty


def test_photo_cache_is_shared_and_decoding_without_cv2_raises(tmp_path, monkeypatch):
    from umpr_tpu_torch.data import images
    ds = _jpegs(tmp_path)
    cache = images.PhotoCache()
    for _ in range(2):
        list(BatchLoader(ds, 4, ignore_photos=False, resize=(8, 8), photo_cache=cache))
    assert cache.misses == len(set(ds.photo_paths.ravel()) | {""}) and cache.hits > 0
    monkeypatch.setitem(sys.modules, "cv2", None)  # `import cv2` raises
    assert not images.get_image("", (8, 8)).any()
    with pytest.raises(ImportError):
        images.get_image(str(tmp_path / "p0.jpg"), (8, 8))
