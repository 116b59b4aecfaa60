"""The torch port's ``.npy`` loader (``nbody_torch.native``) against its
plain numpy reader and the JAX package's loader: both payload types, a
batch over threads, the channel dim, the error cases of
``tests/test_native.py``, and the loud g++ build (settled: the JAX
package falls back to numpy where the port raises)."""

import os

import numpy as np
import pytest

from nbody import native as jnative
from nbody_torch import native


def _save(tmp_path, arrays):
    paths = []
    for i, a in enumerate(arrays):
        p = str(tmp_path / f"v{i}.npy")
        np.save(p, a)
        paths.append(p)
    return paths


def test_builds_keyed_on_the_source():
    assert native.available()
    so = native.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.name.startswith("libnpyloader_")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_single_volume(tmp_path, dtype):
    a = np.random.default_rng(0).normal(size=(5, 6, 7)).astype(dtype)
    paths = _save(tmp_path, [a])
    out = native.read_volumes(paths, (5, 6, 7))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, native.read_volumes_plain(paths,
                                                                 (5, 6, 7)))
    np.testing.assert_array_equal(out[0], a.astype(np.float32))


def test_batch_matches_plain_and_jax(tmp_path):
    rng = np.random.default_rng(1)
    vols = [rng.normal(size=(8, 8, 8)).astype(np.float32) for _ in range(20)]
    paths = _save(tmp_path, vols)
    out = native.read_volumes(paths, (8, 8, 8), n_threads=4)
    np.testing.assert_array_equal(out, np.stack(vols))
    np.testing.assert_array_equal(out, native.read_volumes_plain(paths,
                                                                 (8, 8, 8)))
    np.testing.assert_array_equal(out, jnative.read_volumes(paths, (8, 8, 8)))
    assert native.read_volumes([], (8, 8, 8)).shape == (0, 8, 8, 8)


def test_channel_dim(tmp_path):
    paths = _save(tmp_path, [np.ones((4, 4, 4, 1), np.float32)])
    assert native.read_volumes(paths, (4, 4, 4, 1)).shape == (1, 4, 4, 4, 1)


@pytest.mark.parametrize("case", ["shape", "dtype", "missing", "fortran"])
def test_bad_input_raises(tmp_path, case):
    if case == "missing":
        paths, shape = [str(tmp_path / "absent.npy")], (4,)
    elif case == "shape":
        paths, shape = _save(tmp_path, [np.ones((3, 3), np.float32)]), (4, 4)
    elif case == "dtype":
        paths, shape = _save(tmp_path, [np.ones((4,), np.int32)]), (4,)
    else:
        paths = _save(tmp_path, [np.asfortranarray(np.ones((4, 3),
                                                           np.float32))])
        shape = (4, 3)
    with pytest.raises(ValueError, match="native npy read failed"):
        native.read_volumes(paths, shape)


def test_failed_build_raises_with_gxx_output(tmp_path, monkeypatch):
    """A source g++ refuses raises with its output; nothing falls back."""
    bad = tmp_path / "npy_loader.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(native, "_SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.get_lib()
    assert not native.available()
    assert not any(os.scandir(tmp_path / "build"))
