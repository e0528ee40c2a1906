"""The port's writer of orbax checkpoints, its codecs: ``utils/zstd.compress``
and ``utils/zarr.encode_array`` against what orbax reads with
(``zstandard``, tensorstore's zarr v2 driver).
"""

import json

import numpy as np
import pytest
import tensorstore as ts
import torch
import zstandard
from hypothesis import given, settings
from hypothesis import strategies as st

from anomaly_detection_on_video_tpu_torch.utils import ocdbt, zstd
from anomaly_detection_on_video_tpu_torch.utils.zarr import encode_array, read_array


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ------------------------------------------------------------------ zstd

@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("kind", ["float32", "zeros", "json", "empty"])
def test_zstd_compress_round_trips(level, kind):
    """A frame ``compress`` writes decodes in ``decompress`` and in
    ``zstandard``, and records its content size; a numpy array is read in
    place."""
    rng = np.random.RandomState(level)
    data = {"float32": rng.randn(70000).astype(np.float32),
            "zeros": bytes(300001),
            "json": json.dumps({"k": rng.randint(0, 9, 3000).tolist()}).encode(),
            "empty": b""}[kind]
    frame = zstd.compress(data, level)
    raw = data.tobytes() if isinstance(data, np.ndarray) else data
    assert zstd.decompress(frame) == raw
    assert zstandard.ZstdDecompressor().decompress(frame) == raw
    assert zstandard.get_frame_parameters(frame).content_size == len(raw)


@settings(max_examples=40, deadline=None)
@given(st.binary(max_size=5000), st.integers(1, 19))
def test_zstd_compress_round_trips_any_bytes(data, level):
    frame = zstd.compress(data, level)
    assert zstd.decompress(frame) == data
    assert zstandard.ZstdDecompressor().decompress(frame) == data


# ------------------------------------------------------------------ zarr

@pytest.mark.parametrize("dtype", ["<f4", "<f8", "<i4", "<i8", "<u4", "|b1", "|u1", "bfloat16"])
def test_written_arrays_read_in_tensorstore(dtype, tmp_path):
    """``encode_array`` output read by tensorstore's zarr v2 driver over the
    written store, bit-equal, and by ``read_array``: a 5x7 array, a
    (3, 1, 300) one past the inline limit, a 0-d one; the ``.zarray`` is
    orbax's (one chunk, zstd level 1, fill_value null)."""
    rng = np.random.RandomState(2)
    writer, arrays = ocdbt.OcdbtWriter(str(tmp_path)), {}
    for name, shape in (("a", (5, 7)), ("b", (3, 1, 300)), ("s", ())):
        values = rng.randn(*shape) * 5
        arrays[name] = (torch.from_numpy(np.asarray(values, np.float32)).to(torch.bfloat16)
                        if dtype == "bfloat16" else np.asarray(values).astype(dtype))
        for key, value in encode_array(name, arrays[name]):
            writer.put(key, value)
    writer.close()
    store = ocdbt.OcdbtStore(str(tmp_path))
    keys = {k.decode() for k in store.list()}
    assert keys == {"a/.zarray", "a/0.0", "b/.zarray", "b/0.0.0", "s/.zarray", "s/0"}
    meta = json.loads(store.read("a/.zarray"))
    assert meta == {"chunks": [5, 7], "compressor": {"id": "zstd", "level": 1},
                    "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                    "filters": None, "order": "C", "shape": [5, 7], "zarr_format": 2}
    for name, want in arrays.items():
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                                              "path": f"{name}/"}}
        got_ts = np.asarray(ts.open(spec).result().read().result())
        got = read_array(store.read, keys, name)
        if dtype == "bfloat16":
            want = want.view(torch.int16).numpy()
            got_ts, got = got_ts.view(np.int16), got.view(torch.int16).numpy()
        for g in (got_ts, got):
            assert g.dtype == want.dtype and g.shape == want.shape, name
            assert g.tobytes() == want.tobytes(), name
