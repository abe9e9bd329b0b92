"""``repro_torch.checkpoint.io`` against ``repro.checkpoint.io``.

1. Each assertion of ``tests/test_checkpoint_io.py`` on the port: both
   layouts keep dtypes and shapes (bfloat16 through its uint16 disk
   view), ``rows=`` restores equal slices of the full restore, memmapped
   rows read back, alloc -> fill by ranges -> reopen gives the same
   bytes, a key mismatch raises, and save -> load -> save is stable
   (hypothesis, derandomised).
2. Across the packages: the same numpy tree (a bfloat16 leaf included)
   saved by both gives byte-identical ``leaf_*.npy`` files, the same
   ordered key list and equal ``.npz`` members; a directory the port
   allocated and filled range by range holds the files the reference's
   ``save_checkpoint_dir`` writes for the whole tree.  The sidecars
   differ by design (the port's is JSON under its own name), so neither
   package is asked to read the other's.

Everything here is exact: bytes are compared, no tolerance."""
import filecmp
import json
import os
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.checkpoint import io as jio
from repro_torch.checkpoint.io import (alloc_checkpoint_dir, from_disk_view,
                                       open_checkpoint_dir,
                                       restore_checkpoint, save_checkpoint,
                                       save_checkpoint_dir)
from repro_torch.weights import tree_leaves, tree_map


def _stacked_tree(c=7, seed=0):
    """The reference test's tree: nested dict/list, mixed dtypes, a
    leading client axis C on every leaf; the bfloat16 leaf as a numpy
    (ml_dtypes) array, as the reference hands it to numpy."""
    rng = np.random.default_rng(seed)
    return {
        "cp": {"w": rng.normal(size=(c, 4, 3)).astype(np.float32),
               "b": rng.normal(size=(c, 3)).astype(np.float32)},
        "co": {"step": rng.integers(0, 50, (c,)).astype(np.int32),
               "m": [rng.normal(size=(c, 4, 3)).astype(np.float32),
                     rng.normal(size=(c, 3)).astype(np.float32)]},
        "half": np.asarray(jnp.asarray(rng.normal(size=(c, 5)),
                                       jnp.bfloat16)),
    }


def _bits(a):
    """A leaf's bytes as a numpy array: bfloat16 (torch or ml_dtypes) as
    its uint16 pattern."""
    if torch.is_tensor(a):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _logical(a) -> str:
    if torch.is_tensor(a):
        return "bfloat16" if a.dtype == torch.bfloat16 else str(
            a.numpy().dtype)
    return np.asarray(a).dtype.name


def _assert_trees_equal(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert _logical(x) == _logical(y), (_logical(x), _logical(y))
        assert tuple(x.shape) == tuple(y.shape)
        np.testing.assert_array_equal(_bits(x), _bits(y))


# ---------------------------------------------------------------------------
# 1. the reference test's assertions on the port
# ---------------------------------------------------------------------------


def test_npz_roundtrip_preserves_dtypes_and_shapes(tmp_path):
    tree = _stacked_tree()
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree, {"round": 3})
    back, meta = restore_checkpoint(path, tree)
    assert meta == {"round": 3}
    assert back["half"].dtype == torch.bfloat16
    _assert_trees_equal(tree, back)


def test_npz_roundtrip_of_torch_leaves(tmp_path):
    """Torch leaves save as their numpy twins do (bfloat16 included)."""
    tree = tree_map(lambda a: torch.from_numpy(_bits(a).copy()).view(
        torch.bfloat16) if _logical(a) == "bfloat16" else torch.from_numpy(a),
        _stacked_tree())
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    back, _ = restore_checkpoint(path, tree)
    _assert_trees_equal(tree, back)
    _assert_trees_equal(_stacked_tree(), back)


def test_npz_partial_rows_matches_full_slice(tmp_path):
    """rows= restore of k client rows == slicing the full restore."""
    tree = _stacked_tree(c=9)
    path = str(tmp_path / "ck")
    save_checkpoint(path, tree)
    rows = np.asarray([1, 4, 8])
    part, _ = restore_checkpoint(path, tree, rows=rows)
    full, _ = restore_checkpoint(path, tree)
    _assert_trees_equal(part, tree_map(lambda l: l[rows], full))


def test_dir_roundtrip_and_memmap_rows(tmp_path):
    tree = _stacked_tree(c=9)
    path = str(tmp_path / "ckdir")
    save_checkpoint_dir(path, tree, {"n_clients": 9})
    mms, meta = open_checkpoint_dir(path, tree)
    assert meta["n_clients"] == 9
    assert meta["_dtypes"]["half"] == "bfloat16"
    rows = np.asarray([0, 5])
    for key, src, dst in (("f32", tree["cp"]["w"], mms["cp"]["w"]),
                          ("bf16", tree["half"], mms["half"])):
        got = dst[rows]
        if key == "bf16":
            assert got.dtype == np.uint16
            got = from_disk_view(got, "bfloat16")
            assert got.dtype == torch.bfloat16
        np.testing.assert_array_equal(_bits(got), _bits(src)[rows])


def test_dir_alloc_fill_reopen(tmp_path):
    """The DiskStore lifecycle: alloc uninitialised memmaps, fill row
    ranges, reopen read-only and see the same bytes."""
    tree = _stacked_tree(c=6)
    like = tree_map(lambda l: torch.empty(l.shape, device="meta", dtype=(
        torch.bfloat16 if _logical(l) == "bfloat16"
        else torch.from_numpy(l).dtype)), tree)
    path = str(tmp_path / "alloc")
    mms = alloc_checkpoint_dir(path, like, {"group": "cp"})
    for i0 in (0, 3):                     # chunked fill
        rows = np.arange(i0, i0 + 3)
        tree_map(lambda dst, src: dst.__setitem__(rows, _bits(src)[rows]),
                 mms, tree)
    tree_map(lambda l: l.flush(), mms)
    back, meta = open_checkpoint_dir(path, tree)
    assert meta["group"] == "cp"
    _assert_trees_equal(tree_map(_bits, tree), back)


def test_dir_key_mismatch_raises(tmp_path):
    tree = _stacked_tree(c=2)
    path = str(tmp_path / "ckdir")
    save_checkpoint_dir(path, tree)
    with pytest.raises(ValueError, match="keys"):
        open_checkpoint_dir(path, {"other": tree["cp"]})


_DTYPES = [np.float32, np.int32, np.float16, np.uint16]


def _roundtrip_twice(tree, layout, base):
    p1, p2 = str(base / "a"), str(base / "b")
    if layout == "npz":
        save_checkpoint(p1, tree)
        t1, _ = restore_checkpoint(p1, tree)
        save_checkpoint(p2, t1)
        t2, _ = restore_checkpoint(p2, tree)
    else:
        save_checkpoint_dir(p1, tree)
        t1, _ = open_checkpoint_dir(p1, tree)
        save_checkpoint_dir(p2, t1)
        t2, _ = open_checkpoint_dir(p2, tree)
    _assert_trees_equal(t1, t2)
    _assert_trees_equal(tree, t2)


def _random_tree(rng):
    c = int(rng.integers(1, 6))
    tree = {}
    for i in range(int(rng.integers(1, 5))):
        dt = _DTYPES[int(rng.integers(len(_DTYPES)))]
        shape = (c,) + tuple(int(rng.integers(1, 5))
                             for _ in range(int(rng.integers(0, 3))))
        tree[f"leaf{i}"] = rng.integers(-100, 100, shape).astype(dt)
    return tree


@given(seed=st.integers(0, 2**31), layout=st.sampled_from(["npz", "dir"]))
@settings(max_examples=25, deadline=None, derandomize=True, database=None)
def test_save_load_save_stable(tmp_path_factory, seed, layout):
    """Loading a checkpoint and saving it again writes identical leaves:
    no dtype drift, no shape churn, either layout."""
    base = tmp_path_factory.mktemp("hyp")
    _roundtrip_twice(_random_tree(np.random.default_rng(seed)), layout, base)
    shutil.rmtree(base)


# ---------------------------------------------------------------------------
# 2. across the packages: the same bytes on disk
# ---------------------------------------------------------------------------


def _leaf_files(path):
    return sorted(f for f in os.listdir(path) if f.startswith("leaf_"))


def test_dir_leaf_files_byte_identical_to_reference(tmp_path):
    tree = _stacked_tree(c=5, seed=3)
    ref, port = tmp_path / "ref", tmp_path / "port"
    jio.save_checkpoint_dir(str(ref), tree, {"group": "g"})
    save_checkpoint_dir(str(port), tree, {"group": "g"})
    files = _leaf_files(ref)
    assert files == _leaf_files(port) and len(files) == 6
    for f in files:
        assert filecmp.cmp(ref / f, port / f, shallow=False), f
    with open(ref / "checkpoint.meta", "rb") as fh:
        ref_meta = msgpack.unpackb(fh.read())
    port_meta = open_checkpoint_dir(str(port), tree)[1]
    with open(port / "checkpoint.json") as fh:
        keys = json.load(fh)["keys"]
    assert keys == ref_meta["keys"]
    assert port_meta["_dtypes"] == ref_meta["dtypes"]
    assert not (port / "checkpoint.meta").exists()


def test_npz_members_equal_to_reference(tmp_path):
    tree = _stacked_tree(c=4, seed=4)
    jio.save_checkpoint(str(tmp_path / "ref"), tree, {"round": 1})
    save_checkpoint(str(tmp_path / "port"), tree, {"round": 1})
    with np.load(tmp_path / "ref.npz") as r, \
            np.load(tmp_path / "port.npz") as p:
        assert list(r.keys()) == list(p.keys())
        for k in r.keys():
            assert r[k].dtype == p[k].dtype, k
            np.testing.assert_array_equal(r[k], p[k])
    # the reference's own restore reads the port's archive through its
    # own sidecar: the members are what it wrote
    back, meta = jio.restore_checkpoint(str(tmp_path / "ref"), tree)
    assert meta == {"round": 1}
    port_back, _ = restore_checkpoint(str(tmp_path / "port"), tree)
    for a, b in zip(jax.tree.leaves(back), tree_leaves(port_back)):
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(b))


def test_alloc_filled_by_ranges_equals_reference_whole_save(tmp_path):
    """The port's DiskStore path (alloc, fill in row ranges from torch
    tensors, flush) writes the reference's bytes for the whole tree."""
    tree = _stacked_tree(c=7, seed=5)
    jio.save_checkpoint_dir(str(tmp_path / "ref"), tree)
    torch_tree = tree_map(
        lambda a: torch.from_numpy(_bits(a).copy()).view(torch.bfloat16)
        if _logical(a) == "bfloat16" else torch.from_numpy(a.copy()), tree)
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), torch_tree)
    mms = alloc_checkpoint_dir(str(tmp_path / "port"), like)
    for i0, i1 in ((0, 3), (3, 6), (6, 7)):
        tree_map(lambda dst, src: dst.__setitem__(
            slice(i0, i1), _bits(src[i0:i1])), mms, torch_tree)
    tree_map(lambda l: l.flush(), mms)
    files = _leaf_files(tmp_path / "ref")
    assert files == _leaf_files(tmp_path / "port")
    for f in files:
        assert filecmp.cmp(tmp_path / "ref" / f, tmp_path / "port" / f,
                           shallow=False), f
