"""LMDB archive I/O in pure Python (counterpart of
``endosr/data/lmdb_io.py``, the same code): no ``lmdb`` package needed.

Training images may be stored as raw uint8 blobs in an LMDB archive with a
``meta_info.pkl`` beside it.

- :class:`Reader` — mmap-backed read-only parser of the LMDB B-tree
  (meta pages → main DB root → branch/leaf descent, inline and
  overflow/BIGDATA values), with the subset of the ``lmdb`` API the data
  layer uses: ``env.begin(write=False)`` → ``txn.get(key)``.
- :func:`write_lmdb` — bulk writer of a standard subdir archive
  (``data.mdb`` + ``lock.mdb``): sorted keys, leaf pages with overflow
  values, one branch level per fan-out step, two meta pages.

:func:`open_lmdb` takes the ``lmdb`` package when it is installed.
"""

from __future__ import annotations

import mmap
import os
import struct

PSIZE = 4096
MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
P_INVALID = 0xFFFFFFFFFFFFFFFF

_PAGEHDR = struct.Struct("<QHHHH")           # pgno, pad, flags, lower, upper
_META = struct.Struct("<IIQQ")               # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")             # pad, flags, depth, branch, leaf,
                                             # overflow, entries, root

__all__ = ["Reader", "write_lmdb", "open_lmdb"]


class _Txn:
    def __init__(self, reader):
        self._r = reader

    def get(self, key: bytes):
        return self._r.get(key)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


class Reader:
    """Read-only LMDB environment over ``<path>/data.mdb`` (subdir layout)."""

    def __init__(self, path: str):
        mdb = os.path.join(path, "data.mdb") if os.path.isdir(path) else path
        self._f = open(mdb, "rb")
        self._m = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._parse_meta(0, PSIZE)
        self.psize = meta0["psize"] or PSIZE
        meta1 = self._parse_meta(self.psize, self.psize)
        meta = max((m for m in (meta0, meta1) if m), key=lambda m: m["txnid"])
        self._root = meta["root"]
        self.entries = meta["entries"]

    # -- lmdb-compatible surface ---------------------------------------
    def begin(self, write: bool = False, **_):
        assert not write, "Reader is read-only"
        return _Txn(self)

    def close(self):
        self._m.close()
        self._f.close()

    # -- format parsing ------------------------------------------------
    def _parse_meta(self, off, psize):
        if len(self._m) < off + 16 + _META.size:
            return None
        magic, version, _addr, _mapsize = _META.unpack_from(self._m, off + 16)
        if magic != MAGIC:
            return None
        db0 = _DB.unpack_from(self._m, off + 16 + _META.size)
        db1 = _DB.unpack_from(self._m, off + 16 + _META.size + _DB.size)
        txnid = struct.unpack_from(
            "<Q", self._m, off + 16 + _META.size + 2 * _DB.size + 8)[0]
        return {"psize": db0[0], "root": db1[7], "entries": db1[6],
                "txnid": txnid}

    def _page(self, pgno):
        off = pgno * self.psize
        pg, _pad, flags, lower, upper = _PAGEHDR.unpack_from(self._m, off)
        return off, flags, lower, upper

    def _nodes(self, off, lower):
        n = (lower - 16) // 2
        return struct.unpack_from(f"<{n}H", self._m, off + 16) if n else ()

    def _node(self, off, ptr):
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._m, off + ptr)
        key = bytes(self._m[off + ptr + 8: off + ptr + 8 + ksize])
        return lo, hi, flags, ksize, key

    def get(self, key: bytes):
        pgno = self._root
        if pgno == P_INVALID:
            return None
        while True:
            off, flags, lower, upper = self._page(pgno)
            ptrs = self._nodes(off, lower)
            if flags & P_LEAF:
                for ptr in ptrs:
                    lo, hi, nflags, ksize, k = self._node(off, ptr)
                    if k == key:
                        dsize = lo | (hi << 16)
                        dstart = off + ptr + 8 + ksize
                        if nflags & F_BIGDATA:
                            opg = struct.unpack_from("<Q", self._m, dstart)[0]
                            return bytes(
                                self._m[opg * self.psize + 16:
                                        opg * self.psize + 16 + dsize]
                            )
                        return bytes(self._m[dstart:dstart + dsize])
                return None
            # branch: last child whose key <= target (node 0 key is empty)
            child = None
            for i, ptr in enumerate(ptrs):
                lo, hi, nflags, ksize, k = self._node(off, ptr)
                if i == 0 or k <= key:
                    child = lo | (hi << 16) | (nflags << 32)
                else:
                    break
            pgno = child

    def keys(self):
        """All keys in order (DFS over the tree)."""
        out = []

        def walk(pgno):
            if pgno == P_INVALID:
                return
            off, flags, lower, _ = self._page(pgno)
            for ptr in self._nodes(off, lower):
                lo, hi, nflags, ksize, k = self._node(off, ptr)
                if flags & P_LEAF:
                    out.append(k)
                else:
                    walk(lo | (hi << 16) | (nflags << 32))

        walk(self._root)
        return out


def _even(n):
    return n + (n & 1)


def write_lmdb(path: str, items) -> int:
    """Bulk-write ``items`` (iterable of (bytes key, bytes value)) into a
    fresh LMDB subdir archive at ``path``. Values go to overflow pages
    (the blobs here are images — always larger than a page)."""
    items = sorted(items, key=lambda kv: kv[0])
    os.makedirs(path, exist_ok=True)

    pages: list[bytes] = [b"", b""]  # meta placeholders (pgno 0, 1)
    counts = {"leaf": 0, "branch": 0, "overflow": 0}

    def add_page(buf: bytes) -> int:
        pages.append(buf)
        return len(pages) - 1

    def page_hdr(pgno, flags, lower, upper):
        return _PAGEHDR.pack(pgno, 0, flags, lower, upper)

    def build_page(flags, nodes):
        """nodes: list of packed node byte strings (even-sized)."""
        ptrs, body = [], b""
        upper = PSIZE
        for nd in reversed(nodes):
            upper -= len(nd)
            ptrs.append(upper)
            body = nd + body
        ptrs.reverse()
        lower = 16 + 2 * len(nodes)
        assert lower <= upper, "page overflow"
        pg = bytearray(PSIZE)
        pg[16:lower] = struct.pack(f"<{len(nodes)}H", *ptrs)
        pg[upper:] = body
        pgno = add_page(bytes(pg))
        pages[pgno] = page_hdr(pgno, flags, lower, upper) + pages[pgno][16:]
        return pgno

    # 1. overflow pages for every value, leaf nodes pointing at them
    def leaf_node(key, val):
        npages = -(-(16 + len(val)) // PSIZE)
        opg = len(pages)
        blob = val.ljust(npages * PSIZE - 16, b"\0")
        first = bytearray(PSIZE)
        first[:16] = _PAGEHDR.pack(opg, 0, P_OVERFLOW, npages & 0xFFFF,
                                   (npages >> 16) & 0xFFFF)
        first[16:] = blob[: PSIZE - 16]
        add_page(bytes(first))
        for i in range(1, npages):
            add_page(bytes(blob[PSIZE - 16 + (i - 1) * PSIZE:
                                PSIZE - 16 + i * PSIZE]))
        counts["overflow"] += npages
        dsize = len(val)
        nd = struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, F_BIGDATA,
                         len(key)) + key + struct.pack("<Q", opg)
        return nd.ljust(_even(len(nd)), b"\0")

    # 2. fill leaf pages
    leaves: list[tuple[bytes, int]] = []  # (first key, pgno)
    cur_nodes, cur_first, cur_used = [], None, 16
    for key, val in items:
        nd = leaf_node(key, val)
        if cur_nodes and cur_used + len(nd) + 2 > PSIZE:
            leaves.append((cur_first, build_page(P_LEAF, cur_nodes)))
            counts["leaf"] += 1
            cur_nodes, cur_first, cur_used = [], None, 16
        if not cur_nodes:
            cur_first = key
        cur_nodes.append(nd)
        cur_used += len(nd) + 2
    if cur_nodes:
        leaves.append((cur_first, build_page(P_LEAF, cur_nodes)))
        counts["leaf"] += 1

    # 3. branch levels until a single root
    def branch_node(key, pgno, first):
        k = b"" if first else key
        nd = struct.pack("<HHHH", pgno & 0xFFFF, (pgno >> 16) & 0xFFFF,
                         (pgno >> 32) & 0xFFFF, len(k)) + k
        return nd.ljust(_even(len(nd)), b"\0")

    depth = 1
    level = leaves
    while len(level) > 1:
        nxt, cur_nodes, cur_first, cur_used = [], [], None, 16
        for idx, (key, pgno) in enumerate(level):
            nd = branch_node(key, pgno, first=not cur_nodes)
            if cur_nodes and cur_used + len(nd) + 2 > PSIZE:
                nxt.append((cur_first, build_page(P_BRANCH, cur_nodes)))
                counts["branch"] += 1
                cur_nodes, cur_first, cur_used = [], None, 16
                nd = branch_node(key, pgno, first=True)
            if not cur_nodes:
                cur_first = key
            cur_nodes.append(nd)
            cur_used += len(nd) + 2
        nxt.append((cur_first, build_page(P_BRANCH, cur_nodes)))
        counts["branch"] += 1
        level = nxt
        depth += 1

    root = level[0][1] if items else P_INVALID
    if not items:
        depth = 0

    # 4. meta pages
    mapsize = len(pages) * PSIZE
    db_free = _DB.pack(PSIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
    db_main = _DB.pack(0, 0, depth, counts["branch"], counts["leaf"],
                       counts["overflow"], len(items), root)
    for mp in (0, 1):
        meta = (_META.pack(MAGIC, 1, 0, mapsize) + db_free + db_main
                + struct.pack("<QQ", len(pages) - 1, 1))
        pages[mp] = (page_hdr(mp, P_META, 0, 0) + meta).ljust(PSIZE, b"\0")

    with open(os.path.join(path, "data.mdb"), "wb") as f:
        for pg in pages:
            f.write(pg)
    open(os.path.join(path, "lock.mdb"), "wb").close()
    return len(items)


def open_lmdb(path: str):
    """Open an archive read-only — real ``lmdb`` package if available,
    pure-Python :class:`Reader` otherwise."""
    try:
        import lmdb

        if not hasattr(lmdb, "open"):  # a test stub, not the real package
            raise ImportError("lmdb module has no open()")
        return lmdb.open(path, readonly=True, lock=False, readahead=False,
                         meminit=False)
    except ImportError:
        return Reader(path)
