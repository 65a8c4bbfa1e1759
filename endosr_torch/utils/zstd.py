"""Zstandard frames (RFC 8878) in Python and numpy, for reading orbax
checkpoints without the ``zstandard`` package or tensorstore.

:func:`decompress` decodes one or more frames (skippable frames are
skipped): raw, RLE and compressed blocks; literals raw, RLE, Huffman
compressed (one or four streams, the tree sent or repeated from the
previous block); sequences with predefined, RLE, FSE-compressed and
repeated tables and the three repeat offsets; and the XXH64 content
checksum when the frame carries one. Dictionaries are not supported (a
frame that names one raises ``ValueError``).

Huffman streams, where most of an array's bytes go, are decoded side by
side: :func:`decompress_many` parses every frame it is given first, then
reads one symbol of every stream per step in numpy (an orbax checkpoint
hands it all its chunks: a full-width ×8 ``.state``, 166 MB, in about
10 s on the CPU, ``python -m tests.time_orbax_read``); a handful of
streams are each decoded with
a table looked up at every bit position at once, then a walk over the
positions the code lengths visit.

The package writes no zstd: its orbax directories hold uncompressed zarr
chunks (``utils/orbax_io.py``).
"""

from __future__ import annotations

import struct

import numpy as np

__all__ = ["decompress", "decompress_many", "xxh64"]

MAGIC = 0xFD2FB528
_MAX_BLOCK = 128 * 1024

# ------------------------------------------------------------------ XXH64

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x, r):
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc, lane):
    acc = (acc + lane * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge(acc, v):
    acc ^= _round(0, v)
    return (acc * _P1 + _P4) & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """The XXH64 hash of ``data``."""
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        lanes = np.frombuffer(data, "<u8", (n // 32) * 4).tolist()
        for i in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        p = (n // 32) * 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = _merge(h, v)
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        k = _round(0, struct.unpack_from("<Q", data, p)[0])
        h = (_rotl(h ^ k, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (struct.unpack_from("<I", data, p)[0] * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    return h ^ (h >> 32)


# ------------------------------------------------------------ bit readers

class _Forward:
    """Little-endian bits read from the start of a buffer (FSE table
    descriptions)."""

    def __init__(self, data, pos):
        self.data, self.bit = data, pos * 8

    def read(self, n):
        b0 = self.bit >> 3
        v = int.from_bytes(self.data[b0:b0 + 8], "little") >> (self.bit & 7)
        self.bit += n
        return v & ((1 << n) - 1)

    def peek(self, n):
        b0 = self.bit >> 3
        v = int.from_bytes(self.data[b0:b0 + 8], "little") >> (self.bit & 7)
        return v & ((1 << n) - 1)

    def byte_end(self):
        return (self.bit + 7) >> 3


class _Backward:
    """The bitstream of FSE and Huffman coded data, read from its last
    byte towards its first (the highest set bit of the last byte marks
    the start). Reading past the first byte gives zeros; ``pos`` then goes
    negative."""

    def __init__(self, data: bytes):
        if not data or data[-1] == 0:
            raise ValueError("zstd: a bitstream must end in a nonzero byte")
        self.data = data
        self.pos = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n):
        if n == 0:
            return 0
        p = self.pos - n
        self.pos = p
        if p >= 0:
            b0 = p >> 3
            b1 = (p + n + 7) >> 3
            return (int.from_bytes(self.data[b0:b1], "little")
                    >> (p & 7)) & ((1 << n) - 1)
        # bits below the stream's start read as zeros
        top = p + n
        if top <= 0:
            return 0
        v = int.from_bytes(self.data[:(top + 7) >> 3], "little") \
            & ((1 << top) - 1)
        return v << (-p)


# -------------------------------------------------------------------- FSE

def _read_fse_counts(data, pos, max_symbol, max_log):
    """An FSE table description at ``data[pos:]``: (normalized counts,
    accuracy log, position after it)."""
    br = _Forward(data, pos)
    log = br.read(4) + 5
    if log > max_log:
        raise ValueError(f"zstd: FSE accuracy log {log} > {max_log}")
    remaining = (1 << log) + 1
    threshold = 1 << log
    nbits = log + 1
    counts = []
    prev0 = False
    while remaining > 1 and len(counts) <= max_symbol:
        if prev0:
            while True:
                rep = br.read(2)
                counts.extend([0] * rep)
                if rep != 3:
                    break
            if len(counts) > max_symbol:
                break
        mx = (2 * threshold - 1) - remaining
        low = br.peek(nbits - 1)
        if low < mx:
            count = low
            br.bit += nbits - 1
        else:
            count = br.peek(nbits)
            if count >= threshold:
                count -= mx
            br.bit += nbits
        count -= 1
        remaining -= abs(count)
        counts.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nbits -= 1
            threshold >>= 1
    if remaining != 1 or len(counts) > max_symbol + 1:
        raise ValueError("zstd: bad FSE table description")
    return counts, log, br.byte_end()


def _fse_table(counts, log):
    """The decoding table of normalized ``counts``: (symbol, bits,
    baseline) lists, one entry a state."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = list(counts)
    for s, c in enumerate(counts):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
    pos, step, mask = 0, (size >> 1) + (size >> 3) + 3, size - 1
    for s, c in enumerate(counts):
        for _ in range(max(c, 0)):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: bad FSE distribution")
    nb, base = [0] * size, [0] * size
    for u in range(size):
        s = sym[u]
        x = nxt[s]
        nxt[s] += 1
        nb[u] = log - (x.bit_length() - 1)
        base[u] = (x << nb[u]) - size
    return sym, nb, base, log


def _rle_table(symbol):
    return [symbol], [0], [0], 0


# -------------------------------------------------------------- Huffman

def _huffman_weights(data, pos):
    """A Huffman tree description at ``data[pos:]``: (weights of all but
    the last symbol, position after it)."""
    header = data[pos]
    pos += 1
    if header >= 128:
        n = header - 127
        raw = data[pos:pos + (n + 1) // 2]
        w = []
        for b in raw:
            w += [b >> 4, b & 15]
        return w[:n], pos + (n + 1) // 2
    counts, log, end = _read_fse_counts(data, pos, 255, 6)
    sym, nb, base, log = _fse_table(counts, log)
    br = _Backward(bytes(data[end:pos + header]))
    s1, s2 = br.read(log), br.read(log)
    out = []
    while True:
        out.append(sym[s1])
        s1 = base[s1] + br.read(nb[s1])
        if br.pos < 0:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + br.read(nb[s2])
        if br.pos < 0:
            out.append(sym[s1])
            break
        if len(out) > 255:
            raise ValueError("zstd: too many Huffman weights")
    return out, pos + header


def _huffman_table(weights):
    """(symbol, bits) numpy lookup tables of 2**max_bits entries from the
    weights of all but the last symbol."""
    total = sum(1 << (w - 1) for w in weights if w)
    if total == 0:
        raise ValueError("zstd: empty Huffman tree")
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1):
        raise ValueError("zstd: bad Huffman weights")
    weights = list(weights) + [rest.bit_length()]
    if max_bits > 11:
        raise ValueError(f"zstd: Huffman codes of {max_bits} bits")
    size = 1 << max_bits
    syms = np.zeros(size, np.uint8)
    bits = np.zeros(size, np.int64)
    start = [0] * (max_bits + 2)
    for w in range(1, max_bits + 1):
        start[w + 1] = start[w] + sum(
            (1 << (w - 1)) for x in weights if x == w)
    for s, w in enumerate(weights):
        if w:
            n = 1 << (w - 1)
            syms[start[w]:start[w] + n] = s
            bits[start[w]:start[w] + n] = max_bits + 1 - w
            start[w] += n
    return syms, bits, max_bits


def _huffman_stream(stream, table, n_out):
    """``n_out`` symbols of one Huffman-coded stream."""
    syms, bits, max_bits = table
    if n_out == 0:
        return np.zeros(0, np.uint8)
    if not stream or stream[-1] == 0:
        raise ValueError("zstd: a Huffman stream must end in a nonzero byte")
    start = 8 * (len(stream) - 1) + stream[-1].bit_length() - 1
    # bit i of the stream (little-endian), then max_bits zeros below bit 0
    bitv = np.unpackbits(np.frombuffer(stream, np.uint8), bitorder="little")
    bitv = np.concatenate([np.zeros(max_bits, np.uint8), bitv[:start]])
    # the code read at position p (p bits left) is bits p−1 … p−max_bits
    idx = np.zeros(start + 1, np.int64)
    for j in range(max_bits):
        idx <<= 1
        idx += bitv[max_bits - 1 - j:max_bits - 1 - j + start + 1]
    nxt = (np.arange(start + 1) - bits[idx]).tolist()
    pos = [0] * n_out
    p = start
    for k in range(n_out):
        pos[k] = p
        p = nxt[p]
    if p != 0:
        raise ValueError("zstd: a Huffman stream was not read to its end")
    return syms[idx[np.asarray(pos)]]


# ----------------------------------------------------------- sequences

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83, 99,
                                 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)


def _huffman_lockstep(jobs):
    """The symbols of many Huffman streams (``jobs``: (stream, table,
    n_out)), decoded side by side: each step reads one symbol of every
    stream that has one left, in numpy over the streams. A stream's code
    at bit position p (p bits left) is bits p−1 … p−max_bits, read from
    the 32-bit window at a byte of the streams laid end to end, each after
    two zero bytes (the zeros below a stream's first bit)."""
    order = sorted(range(len(jobs)), key=lambda i: -jobs[i][2])
    n_max = jobs[order[0]][2]
    bufs, base, toff, mbits, pos, entries = [], [], [], [], [], []
    at = {}             # a table's offset in `entries` (treeless blocks
    nbuf = ntab = 0     # repeat their frame's last one)
    for i in order:
        stream, table, _ = jobs[i]
        if not stream or stream[-1] == 0:
            raise ValueError("zstd: a Huffman stream must end in a nonzero "
                             "byte")
        bufs.append(b"\0\0" + stream)
        base.append(8 * nbuf + 16)
        nbuf += len(stream) + 2
        pos.append(8 * (len(stream) - 1) + stream[-1].bit_length() - 1)
        if id(table) not in at:
            syms, bits, _ = table
            at[id(table)] = ntab
            ntab += len(syms)
            # an entry: its symbol in the low byte, its code's length above
            entries.append(bits.astype(np.int64) << 8 | syms)
        toff.append(at[id(table)])
        mbits.append(table[2])
    buf = b"".join(bufs) + b"\0" * 4
    # the little-endian 32 bits from every byte on: a view, one byte apart
    win = np.ndarray((len(buf) - 3,), "<u4", buf, 0, (1,))
    entry = np.concatenate(entries)
    mbits = np.asarray(mbits, np.int64)
    lo = np.asarray(base, np.int64) - mbits     # + p: the code's first bit
    mask = (np.int64(1) << mbits) - 1
    toff = np.asarray(toff, np.int64)
    p = whole = np.asarray(pos, np.int64)
    sizes = np.asarray([jobs[i][2] for i in order])
    out = np.empty((n_max, len(order)), np.uint8)
    active = len(order)
    for k in range(n_max):
        while sizes[active - 1] <= k:
            active -= 1
            lo, mask, toff, p = lo[:active], mask[:active], toff[:active], \
                p[:active]
        q = lo + p
        e = entry[toff + ((win[q >> 3] >> (q & 7)) & mask)]
        out[k, :active] = e
        p -= e >> 8
    if whole.any():
        raise ValueError("zstd: a Huffman stream was not read to its end")
    got = [None] * len(jobs)
    for j, i in enumerate(order):
        got[i] = out[:sizes[j], j]
    return got


def _huffman_all(jobs):
    """The symbols of each Huffman stream of ``jobs``: side by side when
    there are many (:func:`_huffman_lockstep`, whose steps cost about as
    much for one stream as for a thousand), else one at a time."""
    live = [i for i, j in enumerate(jobs) if j[2]]
    got = [np.zeros(0, np.uint8)] * len(jobs)
    if len(live) >= _LOCKSTEP_STREAMS:
        for i, g in zip(live, _huffman_lockstep([jobs[i] for i in live])):
            got[i] = g
    else:
        for i in live:
            got[i] = _huffman_stream(*jobs[i])
    return got


_LOCKSTEP_STREAMS = 16


class _Frame:
    """One frame: its blocks parsed (literals as bytes or Huffman jobs,
    sequences with the tables they take), then run in order with the
    window and the repeat offsets."""

    def __init__(self):
        self.huffman = None
        self.tables = [None, None, None]          # LL, OF, ML
        self.blocks = []    # (literals, (sequences, n, tables) or None)
        self.size = self.checksum = None

    # ---- literals
    def literals(self, b, p):
        """(the literals: bytes, or a list of Huffman jobs whose symbols,
        in order, are they; the position after them)."""
        kind = b[p] & 3
        fmt = (b[p] >> 2) & 3
        if kind in (0, 1):
            if fmt in (0, 2):
                size, p = b[p] >> 3, p + 1
            elif fmt == 1:
                size, p = (b[p] >> 4) + (b[p + 1] << 4), p + 2
            else:
                size = (b[p] >> 4) + (b[p + 1] << 4) + (b[p + 2] << 12)
                p += 3
            if kind == 0:
                return bytes(b[p:p + size]), p + size
            return bytes([b[p]]) * size, p + 1
        if fmt == 0 or fmt == 1:
            v = int.from_bytes(b[p:p + 3], "little")
            regen, comp, p = (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, p + 3
        elif fmt == 2:
            v = int.from_bytes(b[p:p + 4], "little")
            regen, comp, p = (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, p + 4
        else:
            v = int.from_bytes(b[p:p + 5], "little")
            regen, comp, p = (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, p + 5
        end = p + comp
        if kind == 2:
            weights, p = _huffman_weights(b, p)
            self.huffman = _huffman_table(weights)
        elif self.huffman is None:
            raise ValueError("zstd: treeless literals with no earlier tree")
        data = bytes(b[p:end])
        if fmt == 0:
            return [(data, self.huffman, regen)], end
        s1, s2, s3 = struct.unpack_from("<HHH", data, 0)
        seg = (regen + 3) // 4
        o = 6
        jobs = []
        for k, sz in enumerate((s1, s2, s3, len(data) - 6 - s1 - s2 - s3)):
            n = seg if k < 3 else regen - 3 * seg
            jobs.append((data[o:o + sz], self.huffman, n))
            o += sz
        return jobs, end

    # ---- sequence tables
    def table(self, k, mode, b, p, default, max_symbol, max_log):
        if mode == 0:
            t = _fse_table(*default)
        elif mode == 1:
            t = _rle_table(b[p])
            p += 1
        elif mode == 2:
            counts, log, p = _read_fse_counts(b, p, max_symbol, max_log)
            t = _fse_table(counts, log)
        else:
            t = self.tables[k]
            if t is None:
                raise ValueError("zstd: a repeated table with no earlier one")
        self.tables[k] = t
        return p

    def block(self, b, p, end):
        """Parse a compressed block at ``b[p:end]``."""
        lits, p = self.literals(b, p)
        n = b[p]
        if n == 0:
            self.blocks.append((lits, None))
            return
        if n < 128:
            p += 1
        elif n < 255:
            n, p = ((n - 128) << 8) + b[p + 1], p + 2
        else:
            n, p = b[p + 1] + (b[p + 2] << 8) + 0x7F00, p + 3
        modes = b[p]
        p += 1
        p = self.table(0, modes >> 6, b, p, _LL_DEFAULT, 35, 9)
        p = self.table(1, (modes >> 4) & 3, b, p, _OF_DEFAULT, 31, 8)
        p = self.table(2, (modes >> 2) & 3, b, p, _ML_DEFAULT, 52, 9)
        self.blocks.append((lits, (bytes(b[p:end]), n, tuple(self.tables))))

    def jobs(self):
        return [j for lits, _ in self.blocks if isinstance(lits, list)
                for j in lits]

    def run(self, symbols) -> bytes:
        """The frame's content, its Huffman jobs' symbols given in the
        order of :meth:`jobs`; checks its size and checksum."""
        out, rep = bytearray(), [1, 4, 8]
        it = iter(symbols)
        for lits, seq in self.blocks:
            if isinstance(lits, list):
                lits = np.concatenate([next(it) for _ in lits]).tobytes()
            if seq is None:
                out += lits
            else:
                _sequences(out, rep, *seq, lits)
        out = bytes(out)
        if self.size is not None and len(out) != self.size:
            raise ValueError(f"zstd: frame gave {len(out)} bytes, its header "
                             f"says {self.size}")
        if self.checksum is not None and \
                xxh64(out) & 0xFFFFFFFF != self.checksum:
            raise ValueError("zstd: content checksum mismatch")
        return out


def _sequences(out, rep, data, n, tables, lits):
    """Execute a block's ``n`` sequences (``data``, FSE coded with
    ``tables``) on ``out``, the frame's content so far."""
    (lls, llb, llbase, lllog), (ofs, ofb, ofbase, oflog), \
        (mls, mlb, mlbase, mllog) = tables
    br = _Backward(data)
    read = br.read
    sl, so, sm = read(lllog), read(oflog), read(mllog)
    lp = 0
    for i in range(n):
        oc, mc, lc = ofs[so], mls[sm], lls[sl]
        ov = (1 << oc) + read(oc)
        ml = _ML_BASE[mc] + read(_ML_BITS[mc])
        ll = _LL_BASE[lc] + read(_LL_BITS[lc])
        if ov > 3:
            off = ov - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], off
        else:
            j = ov - 1 + (ll == 0)
            if j == 0:
                off = rep[0]
            elif j == 1:
                off = rep[1]
                rep[1], rep[0] = rep[0], off
            elif j == 2:
                off = rep[2]
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
            else:
                off = rep[0] - 1
                rep[2], rep[1], rep[0] = rep[1], rep[0], off
        if i != n - 1:
            sl = llbase[sl] + read(llb[sl])
            sm = mlbase[sm] + read(mlb[sm])
            so = ofbase[so] + read(ofb[so])
        out += lits[lp:lp + ll]
        lp += ll
        if off <= 0 or off > len(out):
            raise ValueError("zstd: a match reaches before the output")
        start = len(out) - off
        if off >= ml:
            out += out[start:start + ml]
        else:
            while ml > 0:
                chunk = out[start:start + min(off, ml)]
                out += chunk
                ml -= len(chunk)
                start += len(chunk)
    if br.pos != 0:
        raise ValueError("zstd: a sequence stream was not read to its end")
    out += lits[lp:]


def _frame(b, p):
    """Parse the frame at ``b[p:]``; returns (its :class:`_Frame`, the
    position after it)."""
    fhd = b[p + 4]
    p += 5
    fcs_flag, single, checksum, dict_flag = (fhd >> 6, (fhd >> 5) & 1,
                                             (fhd >> 2) & 1, fhd & 3)
    if fhd & 8:
        raise ValueError("zstd: reserved frame header bit set")
    if not single:
        p += 1                                       # window descriptor
    if dict_flag:
        did = int.from_bytes(b[p:p + (1, 2, 4)[dict_flag - 1]], "little")
        p += (1, 2, 4)[dict_flag - 1]
        if did:
            raise ValueError("zstd: frames with a dictionary are not "
                             "supported")
    fr = _Frame()
    n_fcs = (1 if single else 0, 2, 4, 8)[fcs_flag]
    if n_fcs:
        fr.size = int.from_bytes(b[p:p + n_fcs], "little")
        if n_fcs == 2:
            fr.size += 256
        p += n_fcs
    while True:
        h = int.from_bytes(b[p:p + 3], "little")
        p += 3
        last, kind, bsize = h & 1, (h >> 1) & 3, h >> 3
        if kind == 0:
            fr.blocks.append((bytes(b[p:p + bsize]), None))
            p += bsize
        elif kind == 1:
            fr.blocks.append((bytes([b[p]]) * bsize, None))
            p += 1
        elif kind == 2:
            if bsize > _MAX_BLOCK:
                raise ValueError("zstd: a block larger than 128 KiB")
            fr.block(b, p, p + bsize)
            p += bsize
        else:
            raise ValueError("zstd: reserved block type")
        if last:
            break
    if checksum:
        fr.checksum = struct.unpack_from("<I", b, p)[0]
        p += 4
    return fr, p


def decompress_many(datas) -> list[bytes]:
    """:func:`decompress` of each bytes-like of ``datas``, the Huffman
    streams of all their frames decoded together."""
    frames = []
    for data in datas:
        b = memoryview(data).cast("B")
        mine, p = [], 0
        while p < len(b):
            magic = struct.unpack_from("<I", b, p)[0]
            if magic == MAGIC:
                fr, p = _frame(b, p)
                mine.append(fr)
            elif magic & 0xFFFFFFF0 == 0x184D2A50:
                p += 8 + struct.unpack_from("<I", b, p + 4)[0]
            else:
                raise ValueError(f"zstd: bad magic {magic:#x} at byte {p}")
        frames.append(mine)
    jobs = [fr.jobs() for mine in frames for fr in mine]
    symbols = iter(_huffman_all([j for js in jobs for j in js]))
    return [b"".join(fr.run([next(symbols) for _ in fr.jobs()])
                     for fr in mine) for mine in frames]


def decompress(data) -> bytes:
    """The content of the zstd frames in ``data`` (bytes-like), one after
    another; skippable frames are skipped."""
    return decompress_many([data])[0]
