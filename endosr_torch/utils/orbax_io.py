"""orbax checkpoint directories in plain Python and numpy.

The JAX package's ``orbax`` backend (``endosr/utils/checkpoint.py``) saves
``serialization.to_state_dict`` of a tree with orbax's
``PyTreeCheckpointer``: a directory holding ``_METADATA`` (JSON: every
leaf's key path and type), ``_CHECKPOINT_METADATA`` and the leaves as zarr
v2 arrays in a key-value store. orbax's default store is tensorstore's
OCDBT (``manifest.ocdbt`` and the ``d/`` files beside it): a B+tree of
keys ``<name>/.zarray`` (the array's JSON) and ``<name>/<chunk>`` (a zstd
frame of the chunk's C-order bytes), ``<name>`` being the key path joined
by dots. Without ``use_ocdbt`` the same keys are plain files.

:func:`read_pytree` reads either layout without tensorstore, orbax or the
``zstandard`` package (``utils/zstd.py``) and rebuilds the nested dict of
numpy arrays that ``to_state_dict`` saved (a bfloat16 leaf as a
``torch.bfloat16`` tensor, as ``utils/msgpack_io.py`` reads one; an empty
dict as ``{}``). The OCDBT layout is read as tensorstore's "OCDBT" kvstore
page sets it out: a file (manifest or B+tree node) is a magic number, its
length, a format version and a compression (0 none, 1 zstd) before the
body, and a CRC-32C of all before it at the end; integers are LEB128
varints; the manifest holds the configuration, a table of data files and
the versions, whose last is read (its root node's file, offset and
length); a node holds its height, its own table of data files and its
entries, their keys prefix-compressed, a leaf's values inline or in a data
file (file, offset) and an interior node's children (file, offset, length)
with the length of the prefix common to each child's keys, which the
child's keys leave out.

:func:`write_pytree` writes the plain layout (``use_ocdbt: false``) with
uncompressed zarr chunks, which orbax's ``PyTreeCheckpointer.restore``
(and so JAX's ``load_pytree``) reads as it reads its own.
"""

from __future__ import annotations

import ast
import json
import os
import struct
import time
from collections.abc import Mapping

import numpy as np

from endosr_torch.utils import zstd

__all__ = ["read_pytree", "write_pytree", "read_ocdbt", "crc32c"]

_MANIFEST_MAGIC = 0x0CDB3A2A
_NODE_MAGIC = 0x0CDB20DE

# ------------------------------------------------------------------ crc32c


def _crc_table():
    t = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
        t.append(c)
    return t


_CRC = _crc_table()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of ``data``."""
    c = 0xFFFFFFFF
    t = _CRC
    for b in bytes(data):
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


# ------------------------------------------------------------------- OCDBT

class _Reader:
    def __init__(self, data):
        self.b, self.p = data, 0

    def varint(self):
        v, shift = 0, 0
        while True:
            c = self.b[self.p]
            self.p += 1
            v |= (c & 0x7F) << shift
            if c < 0x80:
                return v
            shift += 7

    def varints(self, n):
        return [self.varint() for _ in range(n)]

    def u8(self):
        self.p += 1
        return self.b[self.p - 1]

    def take(self, n):
        self.p += n
        return self.b[self.p - n:self.p]


def _unwrap(data, magic, what):
    """The body of an OCDBT manifest or node: magic, length and checksum
    checked, decompressed."""
    if len(data) < 18 or struct.unpack_from(">I", data, 0)[0] != magic:
        raise ValueError(f"OCDBT: not a {what}")
    length = struct.unpack_from("<Q", data, 4)[0]
    if length != len(data):
        raise ValueError(f"OCDBT: {what} of {len(data)} bytes says {length}")
    if crc32c(data[:-4]) != struct.unpack_from("<I", data, len(data) - 4)[0]:
        raise ValueError(f"OCDBT: {what} checksum mismatch")
    r = _Reader(data)
    r.p = 12
    version = r.varint()
    if version != 0:
        raise ValueError(f"OCDBT: {what} format version {version}")
    comp = r.varint()
    body = data[r.p:-4]
    if comp == 1:
        return zstd.decompress(body)
    if comp != 0:
        raise ValueError(f"OCDBT: {what} compression {comp}")
    return bytes(body)


def _file_table(r):
    """A data file table: the files' paths (relative to the store)."""
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                              # base path lengths
    paths, prev = [], b""
    for k in range(n):
        prev = prev[:prefix[k]] + bytes(r.take(suffix[k]))
        paths.append(prev.decode())
    return paths


def _config(r):
    r.take(16)                                # uuid
    kind = r.varint()
    r.varint()                                # max inline value bytes
    r.varint()                                # max decoded node bytes
    r.u8()                                    # version tree arity log2
    if r.varint() == 1:
        r.take(4)                             # zstd level
    return kind


class _Store:
    def __init__(self, root):
        self.root = root

    def read(self, path, offset, length):
        with open(os.path.join(self.root, path), "rb") as f:
            f.seek(offset)
            data = f.read(length)
        if len(data) != length:
            raise ValueError(f"OCDBT: {path} is shorter than its reference")
        return data

    def node(self, path, offset, length, prefix, out):
        r = _Reader(_unwrap(self.read(path, offset, length), _NODE_MAGIC,
                            "B+tree node"))
        height = r.u8()
        files = _file_table(r)
        n = r.varint()
        kp = [0] + r.varints(n - 1) if n else []
        ks = r.varints(n)
        common = r.varints(n) if height else None
        keys, prev = [], b""
        for k in range(n):
            prev = prev[:kp[k]] + bytes(r.take(ks[k]))
            keys.append(prev)
        if height:
            fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)                  # keys, tree and value bytes
            for k in range(n):
                self.node(files[fid[k]], off[k], ln[k],
                          prefix + keys[k][:common[k]], out)
            return
        lengths = r.varints(n)
        kinds = r.varints(n)
        ind = [k for k in range(n) if kinds[k] == 1]
        fid, off = r.varints(len(ind)), r.varints(len(ind))
        where = dict(zip(ind, zip(fid, off)))
        for k in range(n):
            if kinds[k] == 0:
                out[(prefix + keys[k]).decode()] = bytes(r.take(lengths[k]))
            elif kinds[k] == 1:
                f, o = where[k]
                out[(prefix + keys[k]).decode()] = (files[f], o, lengths[k])
            else:
                raise ValueError(f"OCDBT: value kind {kinds[k]}")


def read_ocdbt(root: str) -> dict:
    """Every key of the OCDBT store in ``root`` (its ``manifest.ocdbt``, the
    latest version): inline values as bytes, the others as (data file,
    offset, length) to read with :func:`_value`."""
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        r = _Reader(_unwrap(f.read(), _MANIFEST_MAGIC, "manifest"))
    if _config(r) != 0:
        raise ValueError("OCDBT: only a single-file manifest is read")
    files = _file_table(r)
    n = r.varint()
    gen = r.varints(n)
    heights = [r.u8() for _ in range(n)]
    fid, off, ln = r.varints(n), r.varints(n), r.varints(n)
    nkeys = r.varints(n)
    out = {}
    if not n or nkeys[-1] == 0:
        return out
    last = max(range(n), key=gen.__getitem__)
    del heights
    _Store(root).node(files[fid[last]], off[last], ln[last], b"", out)
    return out


def _value(root, v):
    if isinstance(v, bytes):
        return v
    path, offset, length = v
    return _Store(root).read(path, offset, length)


# -------------------------------------------------------------------- zarr

def _dtype(name: str):
    return np.dtype("<u2") if name == "bfloat16" else np.dtype(name)


def _array_chunks(get, name: str):
    """(meta, [(chunk index, stored bytes)]) of the zarr v2 array ``name``
    of a store; ``get(key)`` gives a key's bytes or None."""
    meta = json.loads(get(f"{name}/.zarray"))
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr compressor {comp.get('id')!r} is not read")
    if meta.get("filters"):
        raise ValueError("zarr filters are not read")
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    grid = [range(-(-s // c)) for s, c in zip(shape, chunks)]
    found = []
    for idx in np.ndindex(*[len(g) for g in grid]) if shape else [()]:
        raw = get(f"{name}/{sep.join(str(i) for i in idx) if shape else '0'}")
        if raw is not None:
            found.append((idx, raw))
    return meta, found


def _assemble(meta, found):
    """The array of ``meta`` from its chunks' (index, decoded bytes)."""
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dt = _dtype(meta["dtype"])
    fill = meta.get("fill_value")
    out = np.full(shape, 0 if fill is None else fill, dt)
    for idx, data in found:
        block = np.frombuffer(data, dt).reshape(chunks,
                                                order=meta.get("order", "C"))
        sl = tuple(slice(i * c, min((i + 1) * c, s))
                   for i, c, s in zip(idx, chunks, shape))
        out[sl] = block[tuple(slice(0, x.stop - x.start) for x in sl)]
    if meta["dtype"] == "bfloat16":
        import torch

        return torch.from_numpy(out).view(torch.bfloat16)
    return out


def read_pytree(path: str) -> dict:
    """The nested dict an orbax checkpoint directory holds (see the
    module's docstring)."""
    with open(os.path.join(path, "_METADATA")) as f:
        meta = json.load(f)
    if "tree_metadata" not in meta:
        raise ValueError(f"{path}: not an orbax PyTree checkpoint")
    if meta.get("use_zarr3"):
        raise ValueError(f"{path}: zarr v3 arrays are not read")
    if meta.get("use_ocdbt"):
        kv = read_ocdbt(path)

        def get(key):
            v = kv.get(key)
            return None if v is None else _value(path, v)
    else:
        def get(key):
            p = os.path.join(path, key)
            if not os.path.isfile(p):
                return None
            with open(p, "rb") as f:
                return f.read()
    leaves = []         # (keys, value kind, meta, chunks) or (keys, value)
    for skey, entry in meta["tree_metadata"].items():
        keys = [k["key"] for k in entry.get("key_metadata") or []] or \
            [str(k) for k in ast.literal_eval(skey)]
        vm = entry.get("value_metadata") or {}
        kind = vm.get("value_type")
        if vm.get("skip_deserialize") or kind in ("Dict", "None"):
            leaves.append((keys, {} if kind == "Dict" else None))
        else:
            leaves.append((keys, kind, *_array_chunks(get, ".".join(keys))))
    # every compressed chunk at once: their Huffman streams decode together
    packed = [raw for _, _, m, found in (x for x in leaves if len(x) == 4)
              if m.get("compressor") is not None for _, raw in found]
    unpacked = iter(zstd.decompress_many(packed))
    tree: dict = {}
    for leaf in leaves:
        keys, value = leaf[0], leaf[-1]
        if len(leaf) == 4:
            kind, m, found = leaf[1:]
            if m.get("compressor") is not None:
                found = [(idx, next(unpacked)) for idx, _ in found]
            value = _assemble(m, found)
            if kind == "scalar":
                value = value.item()
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
    return tree


# ----------------------------------------------------------------- writing

def _leaves(tree, prefix=()):
    if isinstance(tree, Mapping):
        if not tree and prefix:
            yield prefix, {}
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    else:
        yield prefix, tree


def _as_array(v):
    """(C-order numpy array, zarr dtype name) of a leaf."""
    try:
        import torch
    except ImportError:                                   # pragma: no cover
        torch = None
    if torch is not None and isinstance(v, torch.Tensor):
        v = v.detach().cpu().contiguous()
        if v.dtype == torch.bfloat16:
            return v.view(torch.int16).numpy().view("<u2"), "bfloat16"
        v = v.numpy()
    a = np.asarray(v)
    if not a.flags.c_contiguous:           # (ascontiguousarray makes 0-d 1-d)
        a = a.copy(order="C")
    if a.dtype == object:
        raise TypeError(f"an orbax leaf must be an array, got {type(v)}")
    if a.dtype.byteorder == ">":
        a = a.astype(a.dtype.newbyteorder("<"))
    return a, a.dtype.str


def write_pytree(tree, path: str) -> str:
    """Write ``tree`` (nested dicts of arrays, as ``to_state_dict`` gives)
    as an orbax checkpoint directory at ``path`` (which must not exist):
    every leaf an uncompressed single-chunk zarr v2 array, an empty dict
    recorded as one. Returns ``path``."""
    os.makedirs(path)
    entries = {}
    for keys, v in _leaves(tree):
        km = [{"key": k, "key_type": 2} for k in keys]
        skey = str(tuple(keys))
        if isinstance(v, dict):
            entries[skey] = {"key_metadata": km, "value_metadata": {
                "value_type": "Dict", "skip_deserialize": True}}
            continue
        a, dt = _as_array(v)
        if a.size == 0:
            raise ValueError(f"{'.'.join(keys)}: orbax cannot save arrays "
                             "with zero size")
        name = ".".join(keys)
        d = os.path.join(path, name)
        os.makedirs(d)
        zmeta = {"chunks": list(a.shape), "compressor": None,
                 "dimension_separator": ".", "dtype": dt,
                 "fill_value": None, "filters": None, "order": "C",
                 "shape": list(a.shape), "zarr_format": 2}
        with open(os.path.join(d, ".zarray"), "w") as f:
            json.dump(zmeta, f, separators=(",", ":"), sort_keys=True)
        chunk = ".".join("0" for _ in a.shape) if a.ndim else "0"
        with open(os.path.join(d, chunk), "wb") as f:
            f.write(a.tobytes())
        entries[skey] = {"key_metadata": km, "value_metadata": {
            "value_type": "np.ndarray", "skip_deserialize": False}}
    with open(os.path.join(path, "_METADATA"), "w") as f:
        json.dump({"tree_metadata": entries, "use_ocdbt": False,
                   "use_zarr3": False,
                   "store_array_data_equal_to_fill_value": True,
                   "custom_metadata": None}, f)
    now = time.time_ns()
    with open(os.path.join(path, "_CHECKPOINT_METADATA"), "w") as f:
        json.dump({"item_handlers": "orbax.checkpoint._src.handlers."
                   "pytree_checkpoint_handler.PyTreeCheckpointHandler",
                   "metrics": {}, "performance_metrics": {},
                   "init_timestamp_nsecs": now,
                   "commit_timestamp_nsecs": now, "custom_metadata": {}}, f)
    return path
