"""The port's reader of the JAX package's orbax checkpoints, its formats
(``utils/zstd.py``, ``utils/ocdbt.py``, ``utils/zarr.py``) against the
libraries orbax writes with (``zstandard``, ``tensorstore``) and against
the committed JAX run directory's files.
"""

import json
import os
import shutil
import struct
import warnings

import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from anomaly_detection_on_video_tpu_torch.utils import ocdbt, zstd
from anomaly_detection_on_video_tpu_torch.utils.zarr import read_array
from torch_orbax_fixtures import FIXTURE


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["float32", "zeros", "json"])
def test_zstd_matches_zstandard(level, kind):
    """Frames zstandard writes, with and without the content size (the
    streaming route), decode byte-equal."""
    rng = np.random.RandomState(level)
    data = {"float32": rng.randn(70000).astype(np.float32).tobytes(),
            "zeros": bytes(300001),
            "json": json.dumps({"k": rng.randint(0, 9, 3000).tolist()}).encode()}[kind]
    with_size = zstandard.ZstdCompressor(level=level).compress(data)
    stream = zstandard.ZstdCompressor(level=level, write_content_size=False).compress(data)
    assert zstd.decompress(with_size) == zstd.decompress(stream) == data


def test_zstd_decodes_a_large_streamed_frame():
    """A 6 MB frame written in 64 KiB pieces with no content size (as
    tensorstore writes a large chunk): the decoder takes input into its
    own buffer ahead of its output."""
    data = np.random.RandomState(4).randn(1_500_000).astype(np.float32).tobytes()
    writer = zstandard.ZstdCompressor(level=1).compressobj()
    frame = b"".join(writer.compress(data[i:i + 65536]) for i in range(0, len(data), 65536))
    frame += writer.flush()
    assert zstd.decompress(frame) == data
    with pytest.raises(ValueError, match="truncated"):
        zstd.decompress(frame[:-100])


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=5000), st.integers(1, 19), st.booleans())
def test_zstd_matches_zstandard_on_any_bytes(data, level, size):
    frame = zstandard.ZstdCompressor(level=level, write_content_size=size).compress(data)
    assert zstd.decompress(frame) == data


def test_zstd_refuses_what_is_not_a_frame():
    frame = zstandard.ZstdCompressor(level=3).compress(b"abc" * 1000)
    with pytest.raises(ValueError, match="not a zstd frame"):
        zstd.decompress(b"\x00" + frame)
    with pytest.raises(ValueError, match="zstd"):
        zstd.decompress(frame[: len(frame) // 2])


# ----------------------------------------------------------------- OCDBT

def _tensorstore_db(path, commits=20, keys_per_commit=8):
    """A database written through tensorstore's ocdbt driver with nodes of
    at most 256 bytes (interior b-tree nodes) and ``commits`` commits (more
    than 16: a version tree of more than one node), some values above the
    16-byte inline limit."""
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/",
                          "config": {"max_decoded_node_bytes": 256,
                                     "max_inline_value_bytes": 16}}).result()
    rng = np.random.RandomState(1)
    for c in range(commits):
        for _ in range(keys_per_commit):
            key = f"key{c:03d}/{rng.randint(0, 1000):04d}"
            kv.write(key, bytes(rng.randint(0, 256, rng.randint(0, 64)).astype(np.uint8))).result()
    return kv


def _assert_store_equal(path, kv=None):
    kv = kv or ts.KvStore.open({"driver": "ocdbt", "base": f"file://{path}/"}).result()
    store = ocdbt.OcdbtStore(str(path))
    want = kv.list().result()
    assert store.list() == sorted(want)
    for key in want:
        assert store.read(key) == kv.read(key).result().value, key
    return store


@pytest.mark.parametrize("db", ["fixture_root", "fixture_process", "tensorstore"])
def test_ocdbt_matches_tensorstore(db, tmp_path):
    """``list()`` and every ``read()`` equal tensorstore's on an orbax
    step's root database (its values in ``ocdbt.process_0/``), the process
    database (values above the 1 KiB inline limit, in data files), and a
    database of 20 commits with 256-byte nodes (interior nodes, and a
    version tree with nodes of its own)."""
    if db == "tensorstore":
        kv = _tensorstore_db(str(tmp_path))
        store = _assert_store_equal(str(tmp_path), kv)
        assert store.latest.root_height >= 2 and len(store.versions) == 161
        assert [v.generation for v in store.versions] == list(range(1, 162))
        return
    default = os.path.join(FIXTURE, "run", "4", "default")
    path = default if db == "fixture_root" else os.path.join(default, "ocdbt.process_0")
    store = _assert_store_equal(path)
    sizes = [len(store.read(k)) for k in store.list()]
    assert max(sizes) > store.config.max_inline_value_bytes == 1024


def test_ocdbt_checks_every_file(tmp_path):
    """One flipped byte in a manifest or a node fails its CRC32C; an
    absent key raises KeyError."""
    _tensorstore_db(str(tmp_path / "db"), commits=3)
    for victim in ("manifest.ocdbt", "node"):
        db = tmp_path / victim.replace(".", "_")
        shutil.copytree(tmp_path / "db", db)
        store = ocdbt.OcdbtStore(str(db))
        loc = store.latest.root
        path, offset = (db / "manifest.ocdbt", 20) if victim == "manifest.ocdbt" else (
            db / loc.path, loc.offset + 20)
        data = bytearray(path.read_bytes())
        data[offset] ^= 0x01
        path.write_bytes(bytes(data))
        with pytest.raises(ValueError, match="CRC32C"):
            ocdbt.OcdbtStore(str(db)).list()
    with pytest.raises(KeyError):
        ocdbt.OcdbtStore(str(tmp_path / "db")).read("no such key")
    assert ocdbt.crc32c(b"123456789") == 0xE3069283  # the CRC-32C check value


# ------------------------------------------------------------------ zarr

@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "<u4", "|b1", "|u1", "bfloat16"])
def test_zarr_arrays_match_tensorstore(dtype, tmp_path):
    """zarr v2 arrays tensorstore writes into an OCDBT store: a 5x7 array
    in 2x3 chunks (edge chunks padded), zstd and uncompressed, one chunk
    never written (read as fill_value, or zeros when it is null), and a
    0-d array."""
    rng = np.random.RandomState(2)
    base = {"driver": "ocdbt", "base": f"file://{tmp_path}/"}
    wants = {}
    for name, shape, chunks, compressor, fill in (
            ("a", [5, 7], [2, 3], {"id": "zstd", "level": 1}, None),
            ("b", [5, 7], [2, 3], None, True if dtype == "|b1" else 1),
            ("s", [], [], {"id": "zstd", "level": 3}, None)):
        spec = {"driver": "zarr", "kvstore": dict(base, path=f"{name}/"),
                "metadata": {"shape": shape, "chunks": chunks, "dtype": dtype,
                             "compressor": compressor, "fill_value": fill}}
        arr = ts.open(spec, create=True).result()
        values = np.asarray(rng.randn(*shape) * 5).astype(arr.dtype.numpy_dtype)
        if shape:
            arr[2:, :] = values[2:]
        else:
            arr[...] = values
        wants[name] = np.asarray(arr.read().result())
    kv = ts.KvStore.open(base).result()
    keys = {k.decode() for k in kv.list().result()}
    assert "a/0.0" not in keys and "a/2.2" in keys
    for name, want in wants.items():
        got = read_array(lambda k: kv.read(k).result().value, keys, name)
        if dtype == "bfloat16":
            assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
            got, want = got.view(torch.int16).numpy(), want.view(np.int16)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), name


def test_zarr_refuses_fortran_order():
    meta = {"zarr_format": 2, "shape": [2, 2], "chunks": [2, 2], "dtype": "<f4",
            "compressor": None, "fill_value": None, "filters": None, "order": "F"}
    with pytest.raises(ValueError, match="order 'F'"):
        read_array(lambda k: json.dumps(meta).encode(), set(), "x")


def test_ocdbt_header_layout():
    """The fixed header the reader checks: magic (big-endian), the file's
    length, a version and compression byte before the zstd body."""
    data = open(os.path.join(FIXTURE, "run", "4", "default", "manifest.ocdbt"), "rb").read()
    assert struct.unpack(">I", data[:4])[0] == ocdbt.MANIFEST_MAGIC
    assert struct.unpack("<Q", data[4:12])[0] == len(data) and data[12:14] == b"\x00\x01"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert ocdbt.decode_file(data, ocdbt.MANIFEST_MAGIC, "manifest")
    with pytest.raises(ValueError, match="magic"):
        ocdbt.decode_file(data, ocdbt.BTREE_MAGIC, "manifest")
