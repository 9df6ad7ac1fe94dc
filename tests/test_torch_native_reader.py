"""The port's C++ LMDB reader (``ccd_tpu_torch/native/``) against the
pure-Python ``LmdbReader`` on a synthetic LMDB written by the port's own
writer: every key's value byte for byte, a missing key None, and
``PretrainDataset`` items equal through both. The library is built by
``g++`` at first use into the git-ignored ``_build/`` directory; a build that
fails is reported on stderr with the compiler's message and the Python
reader is used instead.
"""

import os

import numpy as np
import pytest

from ccd_tpu_torch import native
from ccd_tpu_torch.data import dataset as dataset_mod
from ccd_tpu_torch.data.dataset import PretrainDataset, mask_env_path
from ccd_tpu_torch.data.lmdb import LmdbReader, LmdbWriter
from ccd_tpu_torch.data.synthetic import write_synthetic_lmdb
from ccd_tpu_torch.ops._build import BUILD_DIR

from _torch_port import one_torch_thread  # noqa: F401 (fixture)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_lmdb")
    root = str(tmp / "training" / "SYNTH")
    mask_root = str(tmp / "Mask")
    # 300 words: 601 keys (images, labels, count) and a mask LMDB of 301, so
    # the leaves split under a branch level
    write_synthetic_lmdb(root, 300, seed=4, with_mask_lmdb=True,
                         mask_path=mask_env_path(root, mask_root))
    # values around the largest one a leaf page holds (2040 bytes with its
    # key) and far past it (overflow pages), and an empty one
    sizes = str(tmp / "sizes")
    rng = np.random.default_rng(5)
    with LmdbWriter(sizes) as w:
        for n in (0, 1, 2000, 2020, 2040, 2041, 5000, 20000, 100000):
            w.put(f"value-{n:09d}".encode(), rng.bytes(n))
    return root, mask_root, sizes


def test_native_reader_is_byte_equal_to_the_python_reader(corpus):
    root, mask_root, sizes = corpus
    for path in (root, mask_env_path(root, mask_root), sizes):
        reader, python = native.open_reader(path), LmdbReader(path)
        assert isinstance(reader, native.NativeLmdbReader) and reader.kind == "native"
        items = list(python.items())
        assert len(items) == len(reader) == len(python) and len(items) in (9, 301, 601)
        for key, value in items:
            assert reader.get(key) == value, key
        assert reader.get(b"image-999999999") is None and python.get(b"image-999999999") is None
        assert reader.get(b"") is None
        reader.close()
    lib = native.library_path()
    assert os.path.dirname(lib) == BUILD_DIR and os.path.isfile(lib)
    assert os.path.basename(lib).startswith("libccd_lmdb_")


def test_pretrain_dataset_items_are_equal_through_both_readers(corpus, monkeypatch):
    root, mask_root, _ = corpus
    ds_native = PretrainDataset(root, is_training=False, mask=True, mask_path=mask_root)
    assert ds_native.reader == "native"
    monkeypatch.setattr(dataset_mod, "open_reader", LmdbReader)
    ds_python = PretrainDataset(root, is_training=False, mask=True, mask_path=mask_root)
    assert ds_python.reader == "python"
    assert len(ds_native) == len(ds_python) == 300
    for i in (0, 1, 150, 299):
        (img_a, mask_a), (img_b, mask_b) = ds_native[i], ds_python[i]
        np.testing.assert_array_equal(img_a, img_b)
        np.testing.assert_array_equal(mask_a, mask_b)


def test_a_failed_build_is_reported_and_the_python_reader_used(corpus, monkeypatch, tmp_path,
                                                               capfd):
    root, _, _ = corpus
    broken = tmp_path / "lmdb_reader.cc"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(broken))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    monkeypatch.setattr(native, "_reported", False)
    reader = native.open_reader(root)
    assert isinstance(reader, LmdbReader) and reader.kind == "python"
    err = capfd.readouterr().err
    assert "could not be built" in err and "g++" in err and "error" in err
    # reported once a process; the build is not retried
    native.open_reader(root)
    assert "could not be built" not in capfd.readouterr().err
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.load()


def test_threads_share_one_native_reader(corpus):
    """The loader's threads read through one reader at once (ctypes drops
    the interpreter lock around each call): 16 threads, a short switch
    interval, every value still equal to the Python reader's."""
    import sys
    import threading

    root, _, _ = corpus
    reader, python = native.open_reader(root), LmdbReader(root)
    items = list(python.items())
    mismatches, done = [], []

    def work(offset):
        for key, value in items[offset:] + items[:offset]:
            if reader.get(key) != value:
                mismatches.append(key)
        done.append(offset)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(37 * i,)) for i in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(done) == 16 and not mismatches
