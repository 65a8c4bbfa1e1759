"""flax's msgpack checkpoint layout in plain Python and numpy.

The JAX package writes its ``.ckpt`` and ``.state`` files with
``flax.serialization.to_bytes`` (``endosr/utils/checkpoint.py``). This
module reads and writes the same bytes without JAX, flax or the
``msgpack`` package:

- a tree is nested maps of str keys in the tree's own key order, as
  ``to_bytes`` writes ``to_state_dict`` of it; a list or tuple is the map
  ``{"0": ..., "1": ...}``, as ``to_state_dict`` makes it;
- an array is ext type 1 holding the msgpack array ``(shape, dtype name,
  C-order bytes)``, a numpy scalar ext type 3 of the same form, a Python
  complex ext type 2 holding ``(real, imag)``;
- an array of more than :data:`MAX_CHUNK_SIZE` bytes is the map
  ``{"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}}``
  of flat pieces, which :func:`unpackb` joins again.

numpy has no bfloat16: a ``bfloat16`` array is read as a ``torch.bfloat16``
tensor through a ``uint16`` view, and a ``torch`` tensor of any type is
written as flax writes the array it holds (a bfloat16 one under the name
``bfloat16``). Other leaves are numpy arrays (read-only views of the
bytes), Python scalars, ``None``, str or bytes.
"""

from __future__ import annotations

import struct
from collections.abc import Mapping

import numpy as np

__all__ = ["packb", "unpackb", "MAX_CHUNK_SIZE"]

# flax.serialization.MAX_CHUNK_SIZE: msgpack's limit is 2**31 − 1 bytes an
# object; flax splits arrays above 2**30
MAX_CHUNK_SIZE = 2 ** 30

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


# ----------------------------------------------------------------- writing

def _int(out: bytearray, n: int) -> None:
    if 0 <= n < 0x80:
        out.append(n)
    elif -0x20 <= n < 0:
        out.append(n & 0xFF)
    elif 0x80 <= n <= 0xFF:
        out += b"\xcc" + struct.pack(">B", n)
    elif -0x80 <= n < 0:
        out += b"\xd0" + struct.pack(">b", n)
    elif 0xFF < n <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", n)
    elif -0x8000 <= n < -0x80:
        out += b"\xd1" + struct.pack(">h", n)
    elif 0xFFFF < n <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", n)
    elif -0x80000000 <= n < -0x8000:
        out += b"\xd2" + struct.pack(">i", n)
    elif 0xFFFFFFFF < n <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", n)
    elif -0x8000000000000000 <= n < -0x80000000:
        out += b"\xd3" + struct.pack(">q", n)
    else:
        raise OverflowError(f"integer {n} does not fit msgpack")


def _head(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    """A length header: the fix form below ``fix_max``, then 8/16/32-bit
    (``codes``: their type bytes, None where the form does not exist)."""
    if n < fix_max:
        out.append(fix | n)
    elif n <= 0xFF and codes[0] is not None:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _str(out: bytearray, s: str) -> None:
    b = s.encode("utf-8")
    _head(out, len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB))
    out += b


def _bin(out: bytearray, b: bytes) -> None:
    n = len(b)
    if n <= 0xFF:
        out += b"\xc4" + struct.pack(">B", n)
    elif n <= 0xFFFF:
        out += b"\xc5" + struct.pack(">H", n)
    else:
        out += b"\xc6" + struct.pack(">I", n)
    out += b


def _ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out += bytes([fixed[n], code])
    elif n <= 0xFF:
        out += b"\xc7" + struct.pack(">B", n) + bytes([code])
    elif n <= 0xFFFF:
        out += b"\xc8" + struct.pack(">H", n) + bytes([code])
    else:
        out += b"\xc9" + struct.pack(">I", n) + bytes([code])
    out += data


def _array_payload(shape, name: str, data: bytes) -> bytes:
    """flax's ``_ndarray_to_bytes``: msgpack of (shape, dtype name, bytes)."""
    out = bytearray()
    _head(out, 3, 0x90, 16, (None, 0xDC, 0xDD))
    _head(out, len(shape), 0x90, 16, (None, 0xDC, 0xDD))
    for d in shape:
        _int(out, int(d))
    _str(out, name)
    _bin(out, data)
    return bytes(out)


def _torch_array(t):
    """A torch tensor → (shape, dtype name, C-order bytes) as flax writes
    the array it holds."""
    import torch

    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        data = t.view(torch.int16).numpy().tobytes()
        return tuple(t.shape), "bfloat16", data
    a = t.numpy()
    return a.shape, a.dtype.name, a.tobytes("C")


def _is_torch(x) -> bool:
    return type(x).__module__.startswith("torch") and hasattr(x, "detach")


def _pack_chunked(out: bytearray, shape, name: str, data: bytes,
                  itemsize: int) -> None:
    """flax's ``_chunk``: an oversized array as the map ``{chunked: True,
    shape: {"0": d0, ...}, chunks: {"0": flat piece, ...}}``."""
    step = max(1, int(MAX_CHUNK_SIZE / itemsize)) * itemsize
    pieces = [data[i:i + step] for i in range(0, len(data), step)]
    _head(out, 3, 0x80, 16, (None, 0xDE, 0xDF))
    _str(out, _CHUNKED)
    out.append(0xC3)
    _str(out, "shape")
    _head(out, len(shape), 0x80, 16, (None, 0xDE, 0xDF))
    for i, d in enumerate(shape):
        _str(out, str(i))
        _int(out, int(d))
    _str(out, "chunks")
    _head(out, len(pieces), 0x80, 16, (None, 0xDE, 0xDF))
    for i, piece in enumerate(pieces):
        _str(out, str(i))
        _ext(out, _EXT_NDARRAY, _array_payload((len(piece) // itemsize,),
                                               name, piece))


def _pack(out: bytearray, x, chunkable: bool) -> None:
    """``x`` → ``out``. ``chunkable``: an oversized array here is chunked
    (flax chunks map values and the root, not list items)."""
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif type(x) is int:
        _int(out, x)
    elif type(x) is float:
        out += b"\xcb" + struct.pack(">d", x)
    elif type(x) is str:
        _str(out, x)
    elif type(x) in (bytes, bytearray):
        _bin(out, bytes(x))
    elif type(x) is complex:
        pay = bytearray()
        _head(pay, 2, 0x90, 16, (None, 0xDC, 0xDD))
        for part in (x.real, x.imag):
            pay += b"\xcb" + struct.pack(">d", part)
        _ext(out, _EXT_COMPLEX, bytes(pay))
    elif isinstance(x, Mapping):
        _head(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _str(out, str(k))
            _pack(out, v, True)
    elif isinstance(x, (list, tuple)):
        _pack(out, {str(i): v for i, v in enumerate(x)}, chunkable)
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _ext(out, _EXT_NPSCALAR, _array_payload(a.shape, a.dtype.name,
                                                a.tobytes("C")))
    elif isinstance(x, np.ndarray) or _is_torch(x):
        if isinstance(x, np.ndarray):
            if x.dtype.hasobject or x.dtype.isalignedstruct:
                raise ValueError("object and structured arrays are not "
                                 "serializable")
            shape, name, data = x.shape, x.dtype.name, x.tobytes("C")
            itemsize = x.dtype.itemsize
        else:
            shape, name, data = _torch_array(x)
            itemsize = x.element_size()
        if chunkable and len(data) > MAX_CHUNK_SIZE:
            _pack_chunked(out, shape, name, data, itemsize)
        else:
            _ext(out, _EXT_NDARRAY, _array_payload(shape, name, data))
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` writes for ``tree``."""
    out = bytearray()
    _pack(out, tree, True)
    return bytes(out)


# ----------------------------------------------------------------- reading

def _array(shape, name: str, buf: bytes):
    if name == "bfloat16":
        import torch

        a = np.frombuffer(buf, np.uint16).reshape(shape).copy()
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape)


class _Reader:
    def __init__(self, data: bytes):
        self.d = memoryview(data)
        self.i = 0

    def take(self, n: int) -> bytes:
        if self.i + n > len(self.d):
            raise ValueError("truncated msgpack data")
        b = self.d[self.i:self.i + n].tobytes()
        self.i += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        c = self.take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.map(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.obj() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self.take(c & 0x1F).decode("utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        ints = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b",
                0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
        if c in ints:
            return self.unpack(ints[c])
        lens = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if c in lens:
            return self.take(self.unpack(lens[c])).decode("utf-8")
        lens = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if c in lens:
            return self.take(self.unpack(lens[c]))
        if c in (0xDC, 0xDD):
            return [self.obj() for _ in range(self.unpack(
                ">H" if c == 0xDC else ">I"))]
        if c in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if c == 0xDE else ">I"))
        fixed = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if c in fixed:
            code = self.unpack(">b")
            return self.ext(code, self.take(fixed[c]))
        lens = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if c in lens:
            n = self.unpack(lens[c])
            code = self.unpack(">b")
            return self.ext(code, self.take(n))
        raise ValueError(f"not msgpack data: byte 0x{c:02x} at {self.i - 1}")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    @staticmethod
    def ext(code: int, data: bytes):
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, name, buf = _Reader(data).obj()
            name = name.decode() if isinstance(name, bytes) else name
            a = _array(tuple(shape), name, buf)
            return a[()] if code == _EXT_NPSCALAR else a
        if code == _EXT_COMPLEX:
            re_, im = _Reader(data).obj()
            return complex(re_, im)
        raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(x):
    if isinstance(x, dict):
        if x.get(_CHUNKED) is True:
            shape = tuple(x["shape"][str(i)] for i in range(len(x["shape"])))
            pieces = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
            if _is_torch(pieces[0]):
                import torch

                return torch.cat(pieces).reshape(shape)
            return np.concatenate(pieces).reshape(shape)
        return {k: _unchunk(v) for k, v in x.items()}
    return x


def unpackb(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` reads from ``data``
    (a ``bfloat16`` array as a ``torch.bfloat16`` tensor)."""
    r = _Reader(bytes(data))
    tree = r.obj()
    if r.i != len(r.d):
        raise ValueError(f"{len(r.d) - r.i} bytes after the msgpack object")
    return _unchunk(tree)
