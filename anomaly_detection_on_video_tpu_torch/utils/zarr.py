"""zarr v2 arrays read from and written to a key-value store (the array
layout of the JAX package's orbax checkpoints, one array per parameter in
an OCDBT store).

An array ``name`` is ``<name>/.zarray`` (JSON: shape, chunks, dtype,
compressor, fill_value, order, dimension_separator) and one value per
stored chunk, ``<name>/<i>.<j>...`` (``<name>/0`` for a 0-d array). A
chunk holds the chunk's full extent in C order, edge chunks padded; a
chunk that is not stored reads as ``fill_value`` (zeros where it is
null), as tensorstore reads it.

Read: compressors ``zstd`` (``utils/zstd.py``) and none; no filters;
order ``C`` (``F`` raises); any little-endian or byte-sized numpy dtype
(``<f4 <f8 <i4 <i8 <u4 |b1 |u1`` ...) and ``bfloat16``, which has no numpy
dtype and comes back as a ``torch.bfloat16`` tensor (every other dtype as
a numpy array).

Write (``encode_array``, the inverse of ``read_array``): the (key, value)
pairs that orbax writes for an array of one device, one chunk the
array's whole shape (key ``0``, ``0.0``, ... ; ``0`` for a 0-d array),
zstd at level 1, ``fill_value`` null, the ``.zarray`` keys sorted with no
spaces; the same dtypes, little-endian (a ``torch.bfloat16`` tensor as
``bfloat16``).
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Any, Callable, Dict, Iterable, List, Tuple, Union

import numpy as np
import torch

from . import zstd


def parse_metadata(raw: bytes) -> Dict[str, Any]:
    """A ``.zarray`` document, checked for what this reader supports."""
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: zarr_format {meta.get('zarr_format')!r}; only 2 is read")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr: order {meta['order']!r} is not supported; only C order is read")
    if meta.get("filters"):
        raise ValueError(f"zarr: filters {meta['filters']!r} are not supported")
    compressor = meta.get("compressor")
    if compressor is not None and compressor.get("id") != "zstd":
        raise ValueError(f"zarr: compressor {compressor.get('id')!r} is not supported "
                         "(zstd or none)")
    if meta.get("dimension_separator", ".") != ".":
        raise ValueError(f"zarr: dimension_separator {meta['dimension_separator']!r} is not "
                         "supported; only '.' is read")
    if len(meta["shape"]) != len(meta["chunks"]):
        raise ValueError(f"zarr: shape {meta['shape']} and chunks {meta['chunks']} differ in rank")
    return meta


def storage_dtype(dtype: str) -> np.dtype:
    """The numpy dtype a chunk's bytes are laid out in (``uint16`` for
    ``bfloat16``)."""
    if dtype == "bfloat16":
        return np.dtype("<u2")
    dt = np.dtype(dtype)
    if dt.kind not in "biuf" or dt.hasobject:
        raise ValueError(f"zarr: dtype {dtype!r} is not supported")
    return dt


def _fill(value: Any, dtype: np.dtype, bf16: bool):
    if value is None:
        return 0
    if isinstance(value, str):  # zarr spells non-finite floats as strings
        value = {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[value]
    if bf16:  # the bfloat16 bits of a float32 value, rounded to nearest even
        bits = np.array([value], np.float32).view(np.uint32)[0]
        return np.uint16((bits + 0x7FFF + ((bits >> 16) & 1)) >> 16)
    return np.array(value).astype(dtype)


def read_array(read: Callable[[str], bytes], keys: Iterable[str], name: str
               ) -> Union[np.ndarray, torch.Tensor]:
    """The array ``name`` of a store: ``read(key)`` returns a value's
    bytes, ``keys`` holds the stored keys (a chunk not among them is
    ``fill_value``)."""
    meta = parse_metadata(read(f"{name}/.zarray"))
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    bf16 = meta["dtype"] == "bfloat16"
    dtype = storage_dtype(meta["dtype"])
    out = np.empty(shape, dtype.newbyteorder("="))
    out[...] = _fill(meta.get("fill_value"), dtype, bf16)
    keys = set(keys)
    chunk_size = int(np.prod(chunks)) * dtype.itemsize
    grid = [range(-(-s // c)) if c else range(0) for s, c in zip(shape, chunks)]
    for index in itertools.product(*grid):
        key = f"{name}/{'.'.join(map(str, index)) if index else '0'}"
        if key not in keys:
            continue
        data = read(key)
        if meta.get("compressor") is not None:
            data = zstd.decompress(data)
        if len(data) != chunk_size:
            raise ValueError(f"zarr: chunk {key} holds {len(data)} bytes, expected {chunk_size}")
        chunk = np.frombuffer(data, dtype).reshape(chunks)
        region = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[region] = chunk[tuple(slice(0, r.stop - r.start) for r in region)]
    if bf16:
        return torch.from_numpy(out.view(np.int16)).view(torch.bfloat16)
    return out


ORBAX_COMPRESSOR = {"id": "zstd", "level": 1}


def _storage(array: Union[np.ndarray, torch.Tensor]):
    """(zarr dtype name, little-endian C-contiguous numpy array of the
    stored bytes) of an array or tensor."""
    if isinstance(array, torch.Tensor):
        array = array.detach().cpu()
        if array.dtype == torch.bfloat16:
            return "bfloat16", np.asarray(array.view(torch.int16).numpy(), order="C").view("<u2")
        array = array.numpy()
    array = np.asarray(array)
    dtype = array.dtype.newbyteorder("<") if array.dtype.byteorder == ">" else array.dtype
    storage_dtype(dtype.str)
    return dtype.str, np.asarray(array, dtype, order="C")  # 0-d stays 0-d


def encode_array(name: str, array: Union[np.ndarray, torch.Tensor]) -> List[Tuple[str, bytes]]:
    """The (key, value) pairs of the zarr v2 array ``name`` holding
    ``array`` (numpy, or a CPU or device tensor): its ``.zarray`` and its
    one compressed chunk."""
    dtype, data = _storage(array)
    shape = list(data.shape)
    meta = {"chunks": shape, "compressor": ORBAX_COMPRESSOR, "dimension_separator": ".",
            "dtype": dtype, "fill_value": None, "filters": None, "order": "C", "shape": shape,
            "zarr_format": 2}
    chunk = ".".join("0" for _ in shape) or "0"
    return [(f"{name}/.zarray", json.dumps(meta, sort_keys=True, separators=(",", ":")).encode()),
            (f"{name}/{chunk}", zstd.compress(data, ORBAX_COMPRESSOR["level"]))]

