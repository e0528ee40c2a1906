"""A read-only OCDBT key-value store (tensorstore's "optionally-cooperative
distributed b-tree", the store under the JAX package's orbax checkpoints).

It reads the on-disk format that tensorstore documents ("OCDBT on-disk
format"), with no tensorstore:

- ``manifest.ocdbt`` at the database's root holds the config and the
  version tree: the newest versions inline, older ones in version tree
  nodes. Each version names the root of a b-tree.
- b-tree nodes and version tree nodes live in data files (``d/<hex>``),
  at an offset and length. Interior nodes map key ranges to children;
  leaf nodes map keys to values, which are inline or a reference (data
  file, offset, length) to bytes stored raw in a data file.
- Keys are prefix-compressed within a node, and an interior entry's
  ``subtree_common_prefix_length`` bytes are left out of every key below
  it.
- Every manifest and node file is ``magic (u32 big-endian) | length (u64)
  | version | compression (0 none, 1 zstd) | body | crc32c (u32)``; the
  CRC is checked on every read.
- A data file table lists the paths of the files a node or manifest
  refers to, relative to the base path of the file that holds it; orbax's
  root database refers into ``ocdbt.process_<n>/`` that way.

``OcdbtStore(path).list()`` returns the sorted keys of the newest version
and ``read(key)`` a value's bytes. Only the single-file manifest kind
(tensorstore's default, the one orbax writes) is read.
"""

from __future__ import annotations

import os
import struct
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple, Union

from . import zstd

MANIFEST_MAGIC = 0x0CDB3A2A
BTREE_MAGIC = 0x0CDB20DE
VERSION_TREE_MAGIC = 0x0CDB1234
MANIFEST_FILE = "manifest.ocdbt"
_MISSING = 2**64 - 1  # the offset and length of an empty tree's root


def _crc32c_table() -> List[int]:
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        table.append(c)
    return table


_CRC_TABLE = _crc32c_table()


def crc32c(data: bytes) -> int:
    """CRC-32C (Castagnoli), the checksum of every OCDBT file."""
    c = 0xFFFFFFFF
    table = _CRC_TABLE
    for byte in data:
        c = table[(c ^ byte) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Cursor over a decoded body: varints, fixed-width fields, columns."""

    def __init__(self, data: bytes, what: str):
        self.data, self.pos, self.what = data, 0, what

    def _need(self, n: int) -> None:
        if self.pos + n > len(self.data):
            raise ValueError(f"ocdbt: {self.what} is truncated")

    def varint(self) -> int:
        value = shift = 0
        while True:
            self._need(1)
            byte = self.data[self.pos]
            self.pos += 1
            value |= (byte & 0x7F) << shift
            if byte < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: {self.what} holds a varint over 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def u8s(self, n: int) -> List[int]:
        self._need(n)
        out = list(self.data[self.pos:self.pos + n])
        self.pos += n
        return out

    def u64s(self, n: int) -> List[int]:
        self._need(8 * n)
        out = list(struct.unpack_from(f"<{n}Q", self.data, self.pos))
        self.pos += 8 * n
        return out

    def raw(self, n: int) -> bytes:
        self._need(n)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def done(self) -> None:
        if self.pos != len(self.data):
            raise ValueError(f"ocdbt: {self.what} has {len(self.data) - self.pos} "
                             "trailing bytes")


def decode_file(data: bytes, magic: int, what: str) -> bytes:
    """The body of one manifest or node file, its header and CRC32C
    checked, decompressed where the file says zstd."""
    if len(data) < 18:
        raise ValueError(f"ocdbt: {what} is truncated ({len(data)} bytes)")
    got_magic, length = struct.unpack_from(">I", data)[0], struct.unpack_from("<Q", data, 4)[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {what}: magic {got_magic:#010x}, expected {magic:#010x}")
    if length != len(data):
        raise ValueError(f"ocdbt: {what}: header length {length}, file {len(data)} bytes")
    crc = struct.unpack_from("<I", data, len(data) - 4)[0]
    if crc32c(data[:-4]) != crc:
        raise ValueError(f"ocdbt: {what}: CRC32C mismatch (the file is corrupt)")
    header = _Reader(data[12:-4], what)
    version, compression = header.varint(), header.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what}: format version {version} is not supported")
    body = data[12 + header.pos:-4]
    if compression == 0:
        return body
    if compression == 1:
        return zstd.decompress(body)
    raise ValueError(f"ocdbt: {what}: unknown compression format {compression}")


class Location(NamedTuple):
    path: str       # the data file, relative to the database root
    base: str       # the base path that the file's own tables are relative to
    offset: int
    length: int


class Version(NamedTuple):
    generation: int
    root_height: int
    root: Optional[Location]  # None: an empty tree
    num_keys: int
    commit_time: int


class Config(NamedTuple):
    uuid: bytes
    manifest_kind: int
    max_inline_value_bytes: int
    max_decoded_node_bytes: int
    version_tree_arity_log2: int
    compression: int


def _data_file_table(r: _Reader, base: str) -> List[Tuple[str, str]]:
    """(path, base path) of each file the table lists, ``base`` prefixed:
    paths share prefixes with the previous path; each path's first
    ``base_path_length`` bytes are the base its own tables resolve against."""
    n = r.varint()
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    base_len = r.varints(n)
    files, previous = [], b""
    for i in range(n):
        if i and prefix[i - 1] > len(previous):
            raise ValueError(f"ocdbt: {r.what}: a data file path prefix is out of range")
        path = (previous[:prefix[i - 1]] if i else b"") + r.raw(suffix[i])
        if base_len[i] > len(path):
            raise ValueError(f"ocdbt: {r.what}: a data file base path is out of range")
        files.append((base + path.decode(), base + path[:base_len[i]].decode()))
        previous = path
    return files


def _locations(r: _Reader, files: List[Tuple[str, str]], n: int) -> List[Optional[Location]]:
    ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
    out = []
    for i, o, n_bytes in zip(ids, offsets, lengths):
        if o == _MISSING and n_bytes == _MISSING:
            out.append(None)
            continue
        if i >= len(files):
            raise ValueError(f"ocdbt: {r.what}: data file {i} of a table of {len(files)}")
        out.append(Location(files[i][0], files[i][1], o, n_bytes))
    return out


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = r.varints(max(n - 1, 0))
    suffix = r.varints(n)
    common = r.varints(n) if interior else [0] * n
    keys, previous = [], b""
    for i in range(n):
        if i and prefix[i - 1] > len(previous):
            raise ValueError(f"ocdbt: {r.what}: a key prefix is out of range")
        key = (previous[:prefix[i - 1]] if i else b"") + r.raw(suffix[i])
        keys.append(key)
        previous = key
    return keys, common


class OcdbtStore:
    """The newest version of the OCDBT database at ``path`` (a directory
    holding ``manifest.ocdbt``), read only."""

    def __init__(self, path: str):
        self.path = os.path.abspath(path)
        self._index: Optional[Dict[bytes, Tuple[Optional[Location], Optional[bytes], int]]] = None
        self.config, versions, nodes = self._read_manifest()
        self.versions = versions + [v for ref in nodes for v in self._version_node(*ref)]
        self.versions.sort(key=lambda v: v.generation)
        self.latest = self.versions[-1] if self.versions else None

    # -- files

    def _read(self, path: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        full = os.path.join(self.path, path)
        with open(full, "rb") as f:
            if length is None:
                return f.read()
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"ocdbt: {path} holds {len(data)} bytes at offset {offset}, "
                             f"expected {length}")
        return data

    def _node(self, loc: Location, magic: int, what: str) -> bytes:
        return decode_file(self._read(loc.path, loc.offset, loc.length), magic,
                           f"{what} at {loc.path}:{loc.offset}")

    # -- manifest and version tree

    def _read_manifest(self):
        what = os.path.join(self.path, MANIFEST_FILE)
        if not os.path.exists(what):
            raise FileNotFoundError(f"ocdbt: no {MANIFEST_FILE} in {self.path}")
        r = _Reader(decode_file(self._read(MANIFEST_FILE), MANIFEST_MAGIC, what), what)
        uuid = r.raw(16)
        kind, max_inline, max_node = r.varint(), r.varint(), r.varint()
        arity, compression = r.u8s(1)[0], r.varint()
        if compression == 1:
            r.raw(4)  # the zstd level, an int32
        elif compression != 0:
            raise ValueError(f"ocdbt: {what}: unknown node compression {compression}")
        config = Config(uuid, kind, max_inline, max_node, arity, compression)
        if kind != 0:
            raise ValueError(f"ocdbt: {what}: manifest kind {kind} (numbered manifests) is not "
                             "supported; only the single-file manifest is read")
        files = _data_file_table(r, "")
        versions = self._version_entries(r, files)
        n = r.varint()
        generations = r.varints(n)
        locations = _locations(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)     # commit_time
        heights = r.u8s(n)
        r.done()
        return config, versions, list(zip(locations, heights, generations))

    def _version_entries(self, r: _Reader, files) -> List[Version]:
        n = r.varint()
        generations = r.varints(n)
        heights = r.u8s(n)
        roots = _locations(r, files, n)
        num_keys = r.varints(n)
        r.varints(n)  # num_tree_bytes
        r.varints(n)  # num_indirect_value_bytes
        times = r.u64s(n)
        return [Version(*v) for v in zip(generations, heights, roots, num_keys, times)]

    def _version_node(self, loc: Location, height: int, generation: int) -> List[Version]:
        what = f"version tree node at {loc.path}:{loc.offset}"
        r = _Reader(self._node(loc, VERSION_TREE_MAGIC, "version tree node"), what)
        arity, got_height = r.u8s(2)
        if got_height != height:
            raise ValueError(f"ocdbt: {what}: height {got_height}, expected {height}")
        files = _data_file_table(r, loc.base)
        if height == 0:
            versions = self._version_entries(r, files)
            r.done()
            return versions
        n = r.varint()
        generations = r.varints(n)
        children = _locations(r, files, n)
        r.varints(n)  # num_generations
        r.u64s(n)     # commit_time
        r.done()
        return [v for child, g in zip(children, generations)
                for v in self._version_node(child, height - 1, g)]

    # -- b-tree

    def _entries(self, loc: Location, height: int, prefix: bytes) -> Iterator[
            Tuple[bytes, Optional[Location], Optional[bytes], int]]:
        """(key, indirect location or None, inline value or None, length)
        of every entry below the node at ``loc``, in key order."""
        what = f"b-tree node at {loc.path}:{loc.offset}"
        r = _Reader(self._node(loc, BTREE_MAGIC, "b-tree node"), what)
        got_height = r.u8s(1)[0]
        if got_height != height:
            raise ValueError(f"ocdbt: {what}: height {got_height}, expected {height}")
        files = _data_file_table(r, loc.base)
        n = r.varint()
        keys, common = _keys(r, n, interior=height > 0)
        if height > 0:
            children = _locations(r, files, n)
            r.varints(3 * n)  # statistics: num_keys, num_tree_bytes, num_indirect_value_bytes
            r.done()
            for key, child, c in zip(keys, children, common):
                if c > len(key):
                    raise ValueError(f"ocdbt: {what}: a subtree prefix is out of range")
                yield from self._entries(child, height - 1, prefix + key[:c])
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        indirect = [i for i, k in enumerate(kinds) if k == 1]
        if any(k not in (0, 1) for k in kinds):
            raise ValueError(f"ocdbt: {what}: unknown value kind")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = {}
        for i, file_id, offset in zip(indirect, ids, offsets):
            if file_id >= len(files):
                raise ValueError(f"ocdbt: {what}: data file {file_id} of a table of {len(files)}")
            refs[i] = Location(files[file_id][0], files[file_id][1], offset, lengths[i])
        for i, key in enumerate(keys):
            if i in refs:
                yield prefix + key, refs[i], None, lengths[i]
            else:
                yield prefix + key, None, r.raw(lengths[i]), lengths[i]
        r.done()

    def _build_index(self):
        if self._index is None:
            index = {}
            v = self.latest
            if v is not None and v.root is not None:
                for key, loc, value, length in self._entries(v.root, v.root_height, b""):
                    index[key] = (loc, value, length)
            self._index = index
        return self._index

    def list(self) -> List[bytes]:
        """Every key of the newest version, sorted bytewise."""
        return sorted(self._build_index())

    def read(self, key: Union[str, bytes]) -> bytes:
        """The value stored under ``key``; KeyError where there is none."""
        if isinstance(key, str):
            key = key.encode()
        try:
            loc, value, length = self._build_index()[key]
        except KeyError:
            raise KeyError(f"ocdbt: no key {key!r} in {self.path}") from None
        if loc is None:
            return value
        return self._read(loc.path, loc.offset, loc.length)
