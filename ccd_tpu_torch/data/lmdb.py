"""Self-contained LMDB database access (no liblmdb dependency).

The reference's entire dataset layer reads LMDB environments
(``Dino/dataset/dataset.py:54-64``: keys ``image-%09d``/``label-%09d``/
``mask-%09d`` + ``num-samples``) and the offline mask tool writes them
(``mask_create/generate_mask.py``). This environment has no ``lmdb`` package,
so this module implements the on-disk format directly:

  * :class:`LmdbReader` — zero-copy mmap reader of the standard LMDB 0.9
    format (little-endian 64-bit): meta-page selection by txnid, branch/leaf
    B-tree walk, F_BIGDATA overflow-page values. Read path only — exactly
    what training/eval needs.
  * :class:`LmdbWriter` — bulk writer producing a valid single-commit LMDB
    environment (sorted keys packed bottom-up into leaf/branch pages,
    overflow pages for large values, twin meta pages). Output is readable by
    the real liblmdb as well as :class:`LmdbReader`.

Format constants follow lmdb's mdb.c (public domain OpenLDAP license).
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, List, Optional, Tuple

PAGE_SIZE = 4096
PAGEHDRSZ = 16
MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

# node flags
F_BIGDATA = 0x01

P_INVALID = 0xFFFFFFFFFFFFFFFF

# max size of a node that still fits in a leaf page (mdb.c me_nodemax):
# (psize - PAGEHDRSZ) / MDB_MINKEYS(2) rounded down to even
NODE_MAX = ((PAGE_SIZE - PAGEHDRSZ) // 2) & ~1  # 2040
NODE_HDR = 8


def _data_path(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only LMDB environment over mmap."""

    kind = "python"

    def __init__(self, path: str):
        self.path = path
        self._file = open(_data_path(path), "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._read_meta(0)
        meta1 = self._read_meta(1)
        self._meta = meta1 if meta1["txnid"] >= meta0["txnid"] else meta0
        self.entries = self._meta["main_entries"]
        self._root = self._meta["main_root"]

    # --------------------------------------------------------------- meta
    def _read_meta(self, pageno: int) -> dict:
        off = pageno * PAGE_SIZE
        mm = self._mm
        magic, version = struct.unpack_from("<II", mm, off + PAGEHDRSZ)
        if magic != MAGIC:
            raise ValueError(f"{self.path}: bad LMDB magic {magic:#x}")
        if version != DATA_VERSION:
            raise ValueError(f"{self.path}: unsupported LMDB version {version}")
        # MDB_db main (mm_dbs[1]) starts at PAGEHDRSZ + 4+4+8+8 + 48
        db_off = off + PAGEHDRSZ + 24 + 48
        (_pad, _flags, _depth, _branch, _leaf, _ovf, entries, root) = struct.unpack_from(
            "<IHHQQQQQ", mm, db_off)
        (last_pg, txnid) = struct.unpack_from("<QQ", mm, db_off + 48)
        return {"txnid": txnid, "main_root": root, "main_entries": entries,
                "last_pg": last_pg}

    # --------------------------------------------------------------- pages
    def _page(self, pgno: int) -> Tuple[int, int]:
        """Return (offset, flags) for a page."""
        off = pgno * PAGE_SIZE
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        return off, flags

    def _numkeys(self, off: int) -> int:
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        return (lower - PAGEHDRSZ) >> 1

    def _node(self, page_off: int, i: int) -> int:
        ptr = struct.unpack_from("<H", self._mm, page_off + PAGEHDRSZ + 2 * i)[0]
        return page_off + ptr

    def _node_key(self, node_off: int) -> bytes:
        ksize = struct.unpack_from("<H", self._mm, node_off + 6)[0]
        return bytes(self._mm[node_off + NODE_HDR: node_off + NODE_HDR + ksize])

    def _branch_child(self, node_off: int) -> int:
        lo, hi, flags = struct.unpack_from("<HHH", self._mm, node_off)
        return lo | (hi << 16) | (flags << 32)

    def _leaf_value(self, node_off: int) -> bytes:
        mm = self._mm
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", mm, node_off)
        dsize = lo | (hi << 16)
        data_off = node_off + NODE_HDR + ksize
        if flags & F_BIGDATA:
            ovf_pgno = struct.unpack_from("<Q", mm, data_off)[0]
            start = ovf_pgno * PAGE_SIZE + PAGEHDRSZ
            return bytes(mm[start: start + dsize])
        return bytes(mm[data_off: data_off + dsize])

    # --------------------------------------------------------------- search
    def _search_page(self, page_off: int, flags: int, key: bytes) -> int:
        """Binary search; returns index of the child/entry to follow.

        For branch pages: index of rightmost node with key <= target (node 0
        has an implicit -inf key). For leaves: index of exact match or -1.
        """
        n = self._numkeys(page_off)
        if flags & P_BRANCH:
            lo_i, hi_i = 1, n - 1
            ans = 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                if self._node_key(self._node(page_off, mid)) <= key:
                    ans = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            return ans
        lo_i, hi_i = 0, n - 1
        while lo_i <= hi_i:
            mid = (lo_i + hi_i) // 2
            k = self._node_key(self._node(page_off, mid))
            if k == key:
                return mid
            if k < key:
                lo_i = mid + 1
            else:
                hi_i = mid - 1
        return -1

    def get(self, key: bytes) -> Optional[bytes]:
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            off, flags = self._page(pgno)
            if flags & P_LEAF:
                i = self._search_page(off, flags, key)
                if i < 0:
                    return None
                return self._leaf_value(self._node(off, i))
            if not flags & P_BRANCH:
                raise ValueError(f"unexpected page flags {flags:#x} at page {pgno}")
            i = self._search_page(off, flags, key)
            pgno = self._branch_child(self._node(off, i))

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over all (key, value) pairs."""
        if self._root == P_INVALID:
            return
        stack = [(self._root, 0)]
        while stack:
            pgno, i = stack.pop()
            off, flags = self._page(pgno)
            n = self._numkeys(off)
            if flags & P_LEAF:
                for j in range(n):
                    node = self._node(off, j)
                    yield self._node_key(node), self._leaf_value(node)
            else:
                if i < n:
                    stack.append((pgno, i + 1))
                    stack.append((self._branch_child(self._node(off, i)), 0))

    def __len__(self) -> int:
        return self.entries

    def close(self) -> None:
        self._mm.close()
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class LmdbWriter:
    """Bulk single-commit LMDB writer (sorted bottom-up B-tree build)."""

    def __init__(self, path: str, subdir: bool = True):
        self.path = path
        self.subdir = subdir
        self._items: List[Tuple[bytes, bytes]] = []
        self._closed = False

    def put(self, key: bytes, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        self._items.append((bytes(key), bytes(value)))

    # ------------------------------------------------------------ building
    @staticmethod
    def _leaf_node(key: bytes, value: bytes, ovf_pgno: Optional[int]) -> bytes:
        if ovf_pgno is None:
            dsize = len(value)
            node = struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, 0, len(key))
            node += key + value
        else:
            dsize = len(value)
            node = struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, F_BIGDATA, len(key))
            node += key + struct.pack("<Q", ovf_pgno)
        if len(node) & 1:
            node += b"\x00"
        return node

    @staticmethod
    def _branch_node(key: bytes, child_pgno: int) -> bytes:
        node = struct.pack("<HHHH", child_pgno & 0xFFFF, (child_pgno >> 16) & 0xFFFF,
                           (child_pgno >> 32) & 0xFFFF, len(key))
        node += key
        if len(node) & 1:
            node += b"\x00"
        return node

    @staticmethod
    def _pack_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
        page = bytearray(PAGE_SIZE)
        struct.pack_into("<QHH", page, 0, pgno, 0, flags)
        upper = PAGE_SIZE
        ptrs = []
        for node in nodes:
            upper -= len(node)
            page[upper: upper + len(node)] = node
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        struct.pack_into("<HH", page, 12, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", page, PAGEHDRSZ + 2 * i, p)
        return bytes(page)

    @staticmethod
    def _overflow_pages(pgno: int, value: bytes) -> bytes:
        npages = (PAGEHDRSZ + len(value) + PAGE_SIZE - 1) // PAGE_SIZE
        buf = bytearray(npages * PAGE_SIZE)
        struct.pack_into("<QHH", buf, 0, pgno, 0, P_OVERFLOW)
        struct.pack_into("<I", buf, 12, npages)
        buf[PAGEHDRSZ: PAGEHDRSZ + len(value)] = value
        return bytes(buf)

    def _meta_page(self, pgno: int, txnid: int, root: int, depth: int,
                   branch_pages: int, leaf_pages: int, ovf_pages: int,
                   entries: int, last_pg: int, mapsize: int) -> bytes:
        page = bytearray(PAGE_SIZE)
        struct.pack_into("<QHH", page, 0, pgno, 0, P_META)
        off = PAGEHDRSZ
        struct.pack_into("<II", page, off, MAGIC, DATA_VERSION)
        struct.pack_into("<QQ", page, off + 8, 0, mapsize)  # mm_address, mm_mapsize
        # mm_dbs[0] — FREE_DBI (empty)
        struct.pack_into("<IHHQQQQQ", page, off + 24, 0, 0, 0, 0, 0, 0, 0, P_INVALID)
        # mm_dbs[1] — MAIN_DBI
        struct.pack_into("<IHHQQQQQ", page, off + 24 + 48, 0, 0, depth,
                         branch_pages, leaf_pages, ovf_pages, entries, root)
        struct.pack_into("<QQ", page, off + 24 + 96, last_pg, txnid)
        return bytes(page)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        items = sorted(self._items, key=lambda kv: kv[0])
        # reject duplicate keys (plain DB; last write would win in lmdb — we
        # keep the last put, matching overwrite semantics)
        dedup: List[Tuple[bytes, bytes]] = []
        for k, v in items:
            if dedup and dedup[-1][0] == k:
                dedup[-1] = (k, v)
            else:
                dedup.append((k, v))
        items = dedup

        pages: dict = {}
        next_pg = 2
        leaf_pages = 0
        ovf_pages = 0

        # ---- build leaves (allocating overflow pages inline)
        leaf_index: List[Tuple[bytes, int]] = []  # (first_key, pgno)
        cur_nodes: List[bytes] = []
        cur_first_key: Optional[bytes] = None
        cur_pgno: Optional[int] = None

        def flush_leaf():
            nonlocal cur_nodes, cur_first_key, cur_pgno, leaf_pages
            if cur_pgno is not None and cur_nodes:
                pages[cur_pgno] = self._pack_page(cur_pgno, P_LEAF, cur_nodes)
                leaf_index.append((cur_first_key, cur_pgno))
                leaf_pages += 1
            cur_nodes, cur_first_key, cur_pgno = [], None, None

        def page_free(nodes: List[bytes]) -> int:
            used = PAGEHDRSZ + sum(len(n) + 2 for n in nodes)
            return PAGE_SIZE - used

        for key, value in items:
            if NODE_HDR + len(key) + len(value) > NODE_MAX:
                node_size = None  # decide after allocating overflow
                big = True
            else:
                big = False
            if cur_pgno is None:
                cur_pgno = next_pg
                next_pg += 1
                cur_first_key = key
            if big:
                n_ovf = (PAGEHDRSZ + len(value) + PAGE_SIZE - 1) // PAGE_SIZE
                ovf_pgno = next_pg
                node = self._leaf_node(key, value, ovf_pgno)
            else:
                node = self._leaf_node(key, value, None)
            if page_free(cur_nodes) < len(node) + 2:
                flush_leaf()
                cur_pgno = next_pg
                next_pg += 1
                cur_first_key = key
                if big:
                    ovf_pgno = next_pg
                    node = self._leaf_node(key, value, ovf_pgno)
            if big:
                next_pg += n_ovf
                pages[ovf_pgno] = self._overflow_pages(ovf_pgno, value)
                ovf_pages += n_ovf
            cur_nodes.append(node)
        flush_leaf()

        # ---- build branch levels bottom-up
        depth = 1
        branch_pages = 0
        level = leaf_index
        if not level:
            root = P_INVALID
            depth = 0
        else:
            while len(level) > 1:
                depth += 1
                next_level: List[Tuple[bytes, int]] = []
                i = 0
                while i < len(level):
                    pgno = next_pg
                    next_pg += 1
                    branch_pages += 1
                    nodes: List[bytes] = []
                    first_key = level[i][0]
                    j = i
                    while j < len(level):
                        key = b"" if j == i else level[j][0]
                        node = self._branch_node(key, level[j][1])
                        used = PAGEHDRSZ + sum(len(n) + 2 for n in nodes)
                        if PAGE_SIZE - used < len(node) + 2:
                            break
                        nodes.append(node)
                        j += 1
                    pages[pgno] = self._pack_page(pgno, P_BRANCH, nodes)
                    next_level.append((first_key, pgno))
                    i = j
                level = next_level
            root = level[0][1]

        last_pg = next_pg - 1
        file_size = next_pg * PAGE_SIZE
        mapsize = max(file_size, 1 << 20)

        # ---- write the file
        if self.subdir:
            os.makedirs(self.path, exist_ok=True)
            data_path = os.path.join(self.path, "data.mdb")
            open(os.path.join(self.path, "lock.mdb"), "wb").close()
        else:
            data_path = self.path
        with open(data_path, "wb") as f:
            # meta 0: pristine env (txnid 0, empty main); meta 1: our commit
            f.write(self._meta_page(0, 0, P_INVALID, 0, 0, 0, 0, 0, 1, mapsize))
            f.write(self._meta_page(1, 1, root, depth, branch_pages, leaf_pages,
                                    ovf_pages, len(items), last_pg, mapsize))
            pgno = 2
            while pgno < next_pg:
                page = pages[pgno]
                f.write(page)
                pgno += len(page) // PAGE_SIZE

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
