"""A read-only HDF5 reader in numpy, ``struct`` and ``zlib``: the subset of
the format that h5py writes for groups of numeric arrays, behind the subset
of h5py's API that the simulation ingest uses (``data/simulation.py``)::

  with File(path) as f:
      top = "Photometry" if "Photometry" in f else "Spectroscopy"
      for t_type in f[top].keys():
          mag = f[top][t_type]["model0/mag_obs"][...]

It takes what h5py writes under ``libver="earliest"`` and ``"latest"``:

  * superblock versions 0 to 3; object headers of version 1 (with
    continuation blocks) and 2 (``OHDR``/``OCHK``);
  * groups as symbol tables (v1 B-tree, ``SNOD`` nodes, local heap), as
    compact link messages, or as dense link storage (the fractal heap's
    blocks are walked; the name index is not needed to list a group);
    ``keys()`` comes back in h5py's order, by name, byte-wise;
  * fixed-point numbers of 1, 2, 4 or 8 bytes, IEEE floats of 4 or 8 bytes,
    either byte order, and variable-length sequences of those (read through
    the global heap into an object array of 1-D arrays, as h5py returns
    them); scalar and simple dataspaces;
  * compact, contiguous and chunked storage: chunks indexed by a v1 B-tree,
    a single chunk, an implicit index or a fixed array, with the deflate
    and shuffle filters; storage never written reads the fill value.

Anything else raises ``UnsupportedHDF5`` naming what it found: soft and
external links, strings, compounds and the other datatype classes, the
extensible-array and v2 B-tree chunk indexes (datasets with an unlimited
dimension under ``libver="latest"``), other filters (fletcher32, szip,
nbit, scaleoffset, lzf, ...), shared messages and external storage. The
reader never returns zeros or a partial array in place of data it cannot
read. It is host code: it runs the same wherever the port runs.
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"

# message types
_DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL = 0x01, 0x02, 0x03, 0x04, 0x05
_LINK, _EXTERNAL, _LAYOUT, _GROUP_INFO, _FILTERS = 0x06, 0x07, 0x08, 0x0A, 0x0B
_CONTINUATION, _SYMBOL_TABLE = 0x10, 0x11
_UNDERSTOOD = {0x00, _DATASPACE, _LINK_INFO, _DATATYPE, _FILL_OLD, _FILL, _LINK, _LAYOUT,
               _GROUP_INFO, _FILTERS, _CONTINUATION, _SYMBOL_TABLE}

_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                7: "reference", 8: "enum", 10: "array", 11: "complex"}
_FILTER_NAMES = {3: "fletcher32", 4: "szip", 5: "nbit", 6: "scaleoffset", 307: "bzip2",
                 32000: "lzf", 32001: "blosc", 32004: "lz4", 32008: "bitshuffle",
                 32015: "zstd"}
_INDEX_NAMES = {4: "extensible array", 5: "v2 B-tree"}
_DEFLATE, _SHUFFLE = 1, 2


class UnsupportedHDF5(ValueError):
    """The file holds a layout, type or filter this reader does not read."""


def _uint(buf, pos: int, n: int) -> int:
    return int.from_bytes(buf[pos:pos + n], "little")


class _Cursor:
    """Little-endian fields read in turn from ``buf``."""

    def __init__(self, buf, pos: int, o: int, l: int):
        self.buf, self.pos, self.o, self.l = buf, pos, o, l

    def u(self, n: int) -> int:
        v = _uint(self.buf, self.pos, n)
        self.pos += n
        return v

    def addr(self) -> Optional[int]:
        v = self.u(self.o)
        return None if v == (1 << 8 * self.o) - 1 else v

    def length(self) -> int:
        return self.u(self.l)

    def take(self, n: int) -> bytes:
        out = bytes(self.buf[self.pos:self.pos + n])
        self.pos += n
        return out


def _datatype(buf, pos: int) -> Tuple[np.dtype, Optional[np.dtype]]:
    """(storage dtype, vlen base dtype or None) of the datatype message at
    ``pos``. A vlen element is stored as a record of its length (4 bytes),
    its global heap collection (an offset) and its object index (4 bytes)."""
    cls, size = buf[pos] & 0x0F, _uint(buf, pos + 4, 4)
    bits = _uint(buf, pos + 1, 3)
    if cls == 0:  # fixed-point
        offset, precision = struct.unpack_from("<HH", buf, pos + 8)
        if size not in (1, 2, 4, 8) or offset != 0 or precision != 8 * size:
            raise UnsupportedHDF5(f"a fixed-point datatype of {size} bytes, bit offset "
                                  f"{offset}, precision {precision}")
        kind = "i" if bits & 0x08 else "u"
        return np.dtype(f"{'>' if bits & 1 else '<'}{kind}{size}"), None
    if cls == 1:  # floating point
        if bits & 0x40 or size not in (4, 8):
            raise UnsupportedHDF5(f"a floating-point datatype of {size} bytes"
                                  + (" in VAX order" if bits & 0x40 else ""))
        _, precision, _, exp_size, _, mant_size = struct.unpack_from("<HHBBBB", buf, pos + 8)
        if (precision, exp_size, mant_size) != {4: (32, 8, 23), 8: (64, 11, 52)}[size]:
            raise UnsupportedHDF5(f"a non-IEEE float: precision {precision}, exponent "
                                  f"{exp_size} bits, mantissa {mant_size} bits")
        return np.dtype(f"{'>' if bits & 1 else '<'}f{size}"), None
    if cls == 9:  # variable length
        if bits & 0x0F == 1:
            raise UnsupportedHDF5("a variable-length string datatype")
        base, inner = _datatype(buf, pos + 8)
        if inner is not None:
            raise UnsupportedHDF5("a variable-length sequence of variable-length sequences")
        return np.dtype(f"V{size}"), base
    raise UnsupportedHDF5(f"datatype class {cls} ({_CLASS_NAMES.get(cls, 'unknown')})")


def _unshuffle(buf: bytes, size: int) -> bytes:
    n = len(buf) // size
    a = np.frombuffer(buf, np.uint8, n * size)
    return a.reshape(size, n).T.tobytes() + buf[n * size:]


class _Filters:
    """The filter pipeline of a chunked dataset: deflate and shuffle."""

    def __init__(self, body: bytes):
        version, n = body[0], body[1]
        pos = 8 if version == 1 else 2
        self.filters: List[Tuple[int, Tuple[int, ...]]] = []
        for _ in range(n):
            fid = _uint(body, pos, 2)
            name_len = _uint(body, pos + 2, 2) if version == 1 or fid >= 256 else 0
            pos += 4 if version == 1 or fid >= 256 else 2
            nvals = _uint(body, pos + 2, 2)
            pos += 4 + name_len
            vals = struct.unpack_from(f"<{nvals}I", body, pos)
            pos += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
            if fid not in (_DEFLATE, _SHUFFLE):
                raise UnsupportedHDF5(f"filter {fid} ({_FILTER_NAMES.get(fid, 'unknown')})")
            self.filters.append((fid, vals))

    def decode(self, buf: bytes, mask: int, itemsize: int) -> bytes:
        for i in reversed(range(len(self.filters))):
            if mask >> i & 1:
                continue
            fid, vals = self.filters[i]
            if fid == _DEFLATE:
                buf = zlib.decompress(buf)
            else:
                buf = _unshuffle(buf, vals[0] if vals else itemsize)
        return buf


class _Reader:
    """The file's bytes and its format-wide sizes (offsets, lengths)."""

    def __init__(self, path: str):
        self.path = path
        self.fh = open(path, "rb")
        self.size = os.fstat(self.fh.fileno()).st_size
        self._objects: Dict[int, object] = {}
        self._collections: Dict[int, Dict[int, bytes]] = {}
        try:
            self._superblock()
        except BaseException:
            self.fh.close()
            raise

    def close(self) -> None:
        self.fh.close()

    def read(self, addr: int, n: int) -> bytes:
        out = os.pread(self.fh.fileno(), n, self.base + addr)
        if len(out) != n:
            raise UnsupportedHDF5(f"{self.path}: truncated at {self.base + addr} "
                                  f"({len(out)} of {n} bytes)")
        return out

    def cursor(self, addr: int, n: int, at: int = 0) -> _Cursor:
        return _Cursor(self.read(addr, n), at, self.o, self.l)

    def _superblock(self) -> None:
        base = 0
        while os.pread(self.fh.fileno(), 8, base) != SIGNATURE:
            base = 512 if base == 0 else 2 * base
            if base >= self.size:
                raise UnsupportedHDF5(f"{self.path}: no HDF5 signature")
        head = os.pread(self.fh.fileno(), 128, base)
        version, self.base = head[8], 0
        if version in (0, 1):
            self.o, self.l = head[13], head[14]
            c = _Cursor(head, 24 if version == 0 else 28, self.o, self.l)
            self.base = c.u(self.o)
            c.pos += 3 * self.o + self.l  # three addresses (free space, EOF, VFD info); a name
            self.root = c.addr()
        elif version in (2, 3):
            self.o, self.l = head[9], head[10]
            c = _Cursor(head, 12, self.o, self.l)
            self.base = c.u(self.o)
            c.pos += 2 * self.o  # superblock extension, end of file
            self.root = c.addr()
        else:
            raise UnsupportedHDF5(f"superblock version {version}")

    # ---- object headers ---------------------------------------------------
    def messages(self, addr: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, body) of every message of the object header at
        ``addr``, its continuation blocks followed."""
        head = self.read(addr, min(64, self.size - self.base - addr))
        out: List[Tuple[int, int, bytes]] = []
        if head[:4] == b"OHDR":
            flags = head[5]
            pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            blocks = [(addr + pos + width, _uint(head, pos, width))]
            hsize = 6 if flags & 0x04 else 4
            while blocks:
                start, n = blocks.pop(0)
                buf, pos = self.read(start, n), 0
                while pos + hsize <= n:
                    mtype, msize, mflags = buf[pos], _uint(buf, pos + 1, 2), buf[pos + 3]
                    body = buf[pos + hsize:pos + hsize + msize]
                    pos += hsize + msize
                    self._take(out, blocks, mtype, mflags, body, v2=True)
        elif head[0] == 1:
            blocks = [(addr + 16, _uint(head, 8, 4))]
            while blocks:
                start, n = blocks.pop(0)
                buf, pos = self.read(start, n), 0
                while pos + 8 <= n:
                    mtype, msize, mflags = struct.unpack_from("<HHB", buf, pos)
                    body = buf[pos + 8:pos + 8 + msize]
                    pos += 8 + msize
                    self._take(out, blocks, mtype, mflags, body, v2=False)
        else:
            raise UnsupportedHDF5(f"object header at {addr}: version {head[0]}")
        return out

    def _take(self, out, blocks, mtype, mflags, body, v2):
        if mtype == _CONTINUATION:
            c = _Cursor(body, 0, self.o, self.l)
            at, n = c.u(self.o), c.length()
            if v2:
                if self.read(at, 4) != b"OCHK":
                    raise UnsupportedHDF5(f"continuation block at {at} without OCHK")
                at, n = at + 4, n - 8
            blocks.append((at, n))
        elif mtype == _EXTERNAL:
            raise UnsupportedHDF5("external storage (an external data files message)")
        elif mtype not in _UNDERSTOOD and mflags & 0x80:
            raise UnsupportedHDF5(f"header message type {mtype:#x} that must be understood")
        elif mtype:
            if mflags & 0x02 and mtype in (_DATASPACE, _DATATYPE, _FILL, _FILL_OLD, _FILTERS):
                raise UnsupportedHDF5(f"a shared header message (type {mtype:#x})")
            out.append((mtype, mflags, body))

    def object(self, addr: int, name: str):
        if addr not in self._objects:
            msgs = self.messages(addr)
            types = {t for t, _, _ in msgs}
            if _LAYOUT in types:
                self._objects[addr] = Dataset(self, name, msgs)
            elif types & {_SYMBOL_TABLE, _LINK_INFO, _LINK, _GROUP_INFO}:
                self._objects[addr] = Group(self, name, msgs)
            else:
                raise UnsupportedHDF5(f"{name}: an object that is neither a group nor a "
                                      f"dataset (messages {sorted(types)})")
        return self._objects[addr]

    # ---- groups -----------------------------------------------------------
    def links(self, msgs) -> Tuple[Dict[bytes, tuple], bool]:
        """({name: (kind, value, creation order)}, whether the group tracks
        creation order): kind "hard" (value: the object's address), "soft"
        (the target path) or "external" (the file and path)."""
        links: Dict[bytes, tuple] = {}
        tracked = False
        for mtype, _, body in msgs:
            if mtype == _SYMBOL_TABLE:
                c = _Cursor(body, 0, self.o, self.l)
                links.update(self._symbol_table(c.u(self.o), c.u(self.o)))
            elif mtype == _LINK:
                name, link, _ = self._link(body, 0)
                links[name] = link
            elif mtype == _LINK_INFO:
                tracked = bool(body[1] & 1)
                c = _Cursor(body, 2 + (8 if tracked else 0), self.o, self.l)
                heap = c.addr()
                if heap is not None:
                    links.update(self._dense_links(heap))
        return links, tracked

    def _symbol_table(self, btree: int, heap: int) -> Dict[bytes, tuple]:
        c = self.cursor(heap, 8 + 2 * self.l + self.o, 8)  # HEAP, version, reserved
        if c.buf[:4] != b"HEAP":
            raise UnsupportedHDF5(f"local heap at {heap} without HEAP")
        size, _, data_addr = c.length(), c.length(), c.u(self.o)
        names = self.read(data_addr, size)
        entry = self.l + self.o + 24
        out: Dict[bytes, tuple] = {}
        for _, snod in self._btree1(btree, 0, 0):
            head = self.read(snod, 8)
            if head[:4] != b"SNOD":
                raise UnsupportedHDF5(f"symbol table node at {snod} without SNOD")
            n = _uint(head, 6, 2)
            c = self.cursor(snod + 8, n * entry)
            for _ in range(n):
                start = c.pos
                name_off, header = c.u(self.l), c.addr()
                cache = c.u(4)
                name = names[name_off:names.index(b"\0", name_off)]
                if cache == 2:  # a soft link: its value's offset in the local heap
                    at = _uint(c.buf, c.pos + 4, 4)
                    out[name] = ("soft", names[at:names.index(b"\0", at)].decode(), 0)
                else:
                    out[name] = ("hard", header, 0)
                c.pos = start + entry
        return out

    def _btree1(self, addr: int, node_type: int, ndims: int) -> Iterator[Tuple[bytes, int]]:
        """(key, child address) of every leaf entry of the v1 B-tree at
        ``addr``: group nodes (type 0) or raw-data chunks (type 1, chunks
        of ``ndims`` dimensions with the element's)."""
        head = self.read(addr, 8 + 2 * self.o)
        if head[:4] != b"TREE" or head[4] != node_type:
            raise UnsupportedHDF5(f"v1 B-tree node at {addr}: {head[:5]!r}")
        level, n = head[5], _uint(head, 6, 2)
        key = self.l if node_type == 0 else 8 + 8 * ndims
        buf = self.read(addr + 8 + 2 * self.o, n * (key + self.o) + key)
        for i in range(n):
            at = i * (key + self.o)
            child = _uint(buf, at + key, self.o)
            if level:
                yield from self._btree1(child, node_type, ndims)
            else:
                yield buf[at:at + key], child

    def _link(self, buf, pos: int) -> Tuple[bytes, tuple, int]:
        """(name, link, end) of the link message at ``pos``."""
        version, flags = buf[pos], buf[pos + 1]
        if version != 1:
            raise UnsupportedHDF5(f"link message version {version}")
        c = _Cursor(buf, pos + 2, self.o, self.l)
        ltype = c.u(1) if flags & 0x08 else 0
        order = c.u(8) if flags & 0x04 else 0
        if flags & 0x10:
            c.pos += 1
        name = c.take(c.u(1 << (flags & 3)))
        if ltype == 0:
            return name, ("hard", c.u(self.o), order), c.pos
        if ltype in (1, 64):
            value = c.take(c.u(2))
            if ltype == 1:
                return name, ("soft", value.decode(), order), c.pos
            value = value[1:].replace(b"\0", b" ").decode().strip()
            return name, ("external", value, order), c.pos
        raise UnsupportedHDF5(f"link {name!r} of user-defined type {ltype}")

    def _dense_links(self, heap: int) -> Dict[bytes, tuple]:
        """The link messages stored as the managed objects of a fractal heap."""
        c = self.cursor(heap, 22 + 12 * self.l + 3 * self.o)
        if c.take(4) != b"FRHP":
            raise UnsupportedHDF5(f"fractal heap at {heap} without FRHP")
        c.pos += 1 + 2  # version, heap ID length
        filtered, flags = c.u(2), c.u(1)
        c.pos += 4  # maximum size of managed objects
        c.length(), c.addr(), c.length(), c.addr(), c.length(), c.length(), c.length()
        n_managed, _, n_huge, _, n_tiny = (c.length() for _ in range(5))
        width, start, max_direct = c.u(2), c.length(), c.length()
        max_heap_bits, _, root, rows = c.u(2), c.u(2), c.addr(), c.u(2)
        if filtered or n_huge or n_tiny:
            raise UnsupportedHDF5(f"a fractal heap with I/O filters, huge or tiny objects "
                                  f"({filtered}, {n_huge}, {n_tiny})")
        h = dict(width=width, start=start, boff=(max_heap_bits + 7) // 8,
                 checksum=bool(flags & 2),
                 direct_rows=max_direct.bit_length() - start.bit_length() + 2)
        out: Dict[bytes, tuple] = {}
        count = 0
        blocks = [] if root is None else [(root, start)] if rows == 0 else self._indirect(
            h, root, rows)
        for addr, size in blocks:
            pos = 4 + 1 + self.o + h["boff"] + (4 if h["checksum"] else 0)
            buf = self.read(addr, size)
            if buf[:4] != b"FHDB":
                raise UnsupportedHDF5(f"fractal heap direct block at {addr} without FHDB")
            while count < n_managed and pos < size and buf[pos] == 1:
                name, link, pos = self._link(buf, pos)
                out[name] = link
                count += 1
        if count != n_managed:
            raise UnsupportedHDF5(f"fractal heap at {heap}: {count} of {n_managed} links "
                                  f"found in its blocks")
        return out

    def _indirect(self, h: dict, addr: int, rows: int) -> Iterator[Tuple[int, int]]:
        """(address, size) of every direct block under an indirect block of
        the heap ``h`` (its doubling table's parameters)."""
        n = rows * h["width"]
        buf = self.read(addr, 4 + 1 + self.o + h["boff"] + n * self.o)
        if buf[:4] != b"FHIB":
            raise UnsupportedHDF5(f"fractal heap indirect block at {addr} without FHIB")
        c = _Cursor(buf, 4 + 1 + self.o + h["boff"], self.o, self.l)
        for i in range(n):
            child, row = c.addr(), i // h["width"]
            if child is None:
                continue
            if row < h["direct_rows"]:
                yield child, h["start"] << max(row - 1, 0)
            else:  # an indirect block of this row's size, in rows
                yield from self._indirect(h, child, row - (h["width"].bit_length() - 1))

    # ---- variable-length data ---------------------------------------------
    def heap_object(self, collection: int, index: int) -> bytes:
        if collection not in self._collections:
            head = self.read(collection, 8 + self.l)
            if head[:4] != b"GCOL":
                raise UnsupportedHDF5(f"global heap collection at {collection} without GCOL")
            size = _uint(head, 8, self.l)
            # the collection's header, each object's header and data are
            # padded to 8 bytes
            hsize = (8 + self.l + 7) // 8 * 8
            buf, pos, objs = self.read(collection, size), hsize, {}
            while pos + hsize <= size:
                idx = _uint(buf, pos, 2)
                n = _uint(buf, pos + 8, self.l)
                if idx == 0:  # free space
                    break
                objs[idx] = buf[pos + hsize:pos + hsize + n]
                pos += hsize + (n + 7) // 8 * 8
            self._collections[collection] = objs
        try:
            return self._collections[collection][index]
        except KeyError:
            raise UnsupportedHDF5(f"global heap object {index} missing in the collection at "
                                  f"{collection}") from None


class Group:
    """A group: ``keys()``, ``g[name]`` and ``g["a/b"]``, ``name in g``."""

    def __init__(self, reader: _Reader, name: str, msgs):
        self._reader, self.name, self._msgs = reader, name, msgs
        self._links: Optional[Dict[bytes, tuple]] = None

    def _table(self) -> Dict[bytes, tuple]:
        if self._links is None:
            self._links, self._tracked = self._reader.links(self._msgs)
        return self._links

    def keys(self) -> List[str]:
        """Member names in h5py's order: by name, byte-wise, or by creation
        order where the group tracks it."""
        table = self._table()
        if self._tracked:
            return [k.decode() for k in sorted(table, key=lambda k: table[k][2])]
        return [k.decode() for k in sorted(table)]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self._table())

    def _child(self, name: str):
        path = f"{self.name.rstrip('/')}/{name}"
        try:
            kind, value, _ = self._table()[name.encode()]
        except KeyError:
            raise KeyError(f"{path}: no such member") from None
        if kind != "hard":
            raise UnsupportedHDF5(f"{path}: {kind} link to {value}; the reader follows hard "
                                  f"links only")
        return self._reader.object(value, path)

    def __getitem__(self, path: str):
        node = self
        for part in (p for p in path.split("/") if p):
            if not isinstance(node, Group):
                raise KeyError(f"{node.name} is a dataset, not a group")
            node = node._child(part)
        return node

    def __contains__(self, path: str) -> bool:
        parts = [p for p in path.split("/") if p]
        if not parts:
            return True
        try:
            parent = self["/".join(parts[:-1])]
        except KeyError:
            return False
        return isinstance(parent, Group) and parts[-1].encode() in parent._table()

    def __repr__(self) -> str:
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class Dataset:
    """A dataset: ``shape``, ``dtype``, and ``d[...]`` (the whole array as
    h5py returns it, indexed by the key)."""

    def __init__(self, reader: _Reader, name: str, msgs):
        self._reader, self.name = reader, name
        self._fill = None
        self._filters = None
        try:
            for mtype, _, body in msgs:
                if mtype == _DATASPACE:
                    self.shape = self._dataspace(body)
                elif mtype == _DATATYPE:
                    self._storage, self._base = _datatype(body, 0)
                elif mtype == _FILL:
                    self._fill = self._fill_value(body)
                elif mtype == _FILL_OLD and self._fill is None:
                    self._fill = body[4:4 + _uint(body, 0, 4)] or None
                elif mtype == _FILTERS:
                    self._filters = _Filters(body)
                elif mtype == _LAYOUT:
                    self._layout = body
        except UnsupportedHDF5 as e:
            raise UnsupportedHDF5(f"{name}: {e}") from None
        self.dtype = np.dtype(object) if self._base is not None else self._storage

    @property
    def size(self) -> int:
        return int(np.prod(self.shape, dtype=np.int64))

    def __getitem__(self, key):
        return self.read()[key]

    def __repr__(self) -> str:
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"

    def _dataspace(self, body: bytes) -> Tuple[int, ...]:
        version, ndims = body[0], body[1]
        if version == 1:
            pos = 8
        elif version == 2:
            if body[3] == 2:
                raise UnsupportedHDF5("a null dataspace")
            pos = 4
        else:
            raise UnsupportedHDF5(f"dataspace version {version}")
        l = self._reader.l
        return tuple(_uint(body, pos + i * l, l) for i in range(ndims))

    @staticmethod
    def _fill_value(body: bytes) -> Optional[bytes]:
        version = body[0]
        if version in (1, 2):
            if version == 2 and body[3] != 1:
                return None
            return body[8:8 + _uint(body, 4, 4)] or None
        if body[1] & 0x20:  # version 3: a value is defined
            return body[6:6 + _uint(body, 2, 4)] or None
        return None

    def _filled(self) -> np.ndarray:
        out = np.zeros(self.shape, self._storage)
        if self._fill is not None and self._base is None:
            out[...] = np.frombuffer(self._fill, self._storage, 1)[0]
        return out

    def read(self) -> np.ndarray:
        """The whole dataset as h5py's ``d[...]`` gives it."""
        body, r = self._layout, self._reader
        version, cls = body[0], body[1]
        if version not in (3, 4):
            raise UnsupportedHDF5(f"{self.name}: data layout message version {version}")
        count = self.size
        if cls == 0:  # compact
            n = _uint(body, 2, 2)
            raw = np.frombuffer(body[4:4 + n], self._storage, count).reshape(self.shape).copy()
        elif cls == 1:  # contiguous
            c = _Cursor(body, 2, r.o, r.l)
            addr = c.addr()
            if addr is None:
                raw = self._filled()
            else:
                r.fh.seek(r.base + addr)
                raw = np.fromfile(r.fh, self._storage, count)
                if raw.size != count:
                    raise UnsupportedHDF5(f"{self.name}: {raw.size} of {count} elements in "
                                          f"the file")
                raw = raw.reshape(self.shape)
        elif cls == 2:
            raw = self._chunked(body, version)
        else:
            raise UnsupportedHDF5(f"{self.name}: layout class {cls} (virtual)")
        return raw if self._base is None else self._vlen(raw)

    def _vlen(self, raw: np.ndarray) -> np.ndarray:
        r, base = self._reader, self._base
        rec = np.frombuffer(raw.tobytes(), np.dtype([("n", "<u4"), ("at", f"<u{r.o}"),
                                                     ("idx", "<u4")]))
        out = np.empty(len(rec), object)
        for i, (n, at, idx) in enumerate(rec.tolist()):
            if n == 0:
                out[i] = np.zeros(0, base)
                continue
            data = r.heap_object(at, idx)
            if len(data) < n * base.itemsize:
                raise UnsupportedHDF5(f"{self.name}: a vlen element of {n} values in "
                                      f"{len(data)} bytes")
            out[i] = np.frombuffer(data, base, n).copy()
        return out.reshape(self.shape)

    def _chunked(self, body: bytes, version: int) -> np.ndarray:
        r = self._reader
        if version == 3:
            ndims = body[2]
            c = _Cursor(body, 3, r.o, r.l)
            index_addr = c.addr()
            dims = [c.u(4) for _ in range(ndims)]
            index, flags, single = 0, 0, None
        else:
            flags, ndims, enc = body[2], body[3], body[4]
            c = _Cursor(body, 5, r.o, r.l)
            dims = [c.u(enc) for _ in range(ndims)]
            index = c.u(1)
            single = None
            if index == 1 and flags & 0x02:  # a filtered single chunk
                single = (c.length(), c.u(4))
            elif index == 3:
                c.pos += 1  # page bits: read from the fixed array's header
            elif index in _INDEX_NAMES:
                raise UnsupportedHDF5(f"{self.name}: the {_INDEX_NAMES[index]} chunk index "
                                      f"(a dataset with an unlimited dimension)")
            elif index not in (1, 2):
                raise UnsupportedHDF5(f"{self.name}: chunk index type {index}")
            index_addr = c.addr()
        chunk = tuple(dims[:-1])
        if len(chunk) != len(self.shape):
            raise UnsupportedHDF5(f"{self.name}: chunks of rank {len(chunk)} for a dataset "
                                  f"of rank {len(self.shape)}")
        grid = tuple(-(-s // k) for s, k in zip(self.shape, chunk))
        nbytes = int(np.prod(chunk, dtype=np.int64)) * self._storage.itemsize
        out = self._filled()
        if index_addr is None:
            return out

        def at(i):  # the element offset of chunk i of the grid, in row-major order
            return tuple(int(k) * n for k, n in zip(np.unravel_index(i, grid), chunk))

        if version == 3:
            entries = ((_uint(key, 0, 4), _uint(key, 4, 4),
                        tuple(_uint(key, 8 + 8 * d, 8) for d in range(len(chunk))), addr)
                       for key, addr in r._btree1(index_addr, 1, ndims))
        elif index == 1:
            size, mask = single if single else (nbytes, 0)
            entries = [(size, mask, (0,) * len(chunk), index_addr)]
        elif index == 2:
            entries = ((nbytes, 0, at(i), index_addr + i * nbytes)
                       for i in range(int(np.prod(grid))))
        else:
            entries = self._fixed_array(index_addr, at, nbytes)
        for size, mask, offset, addr in entries:
            if addr is None:
                continue
            buf = r.read(addr, size)
            edge = any(o + k > s for o, k, s in zip(offset, chunk, self.shape))
            if self._filters is not None and not (edge and flags & 0x01):
                buf = self._filters.decode(buf, mask, self._storage.itemsize)
            if len(buf) != nbytes:
                raise UnsupportedHDF5(f"{self.name}: a chunk of {len(buf)} bytes, want "
                                      f"{nbytes}")
            block = np.frombuffer(buf, self._storage).reshape(chunk)
            dst = tuple(slice(o, min(o + k, s)) for o, k, s in zip(offset, chunk, self.shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _fixed_array(self, addr: int, at, nbytes: int):
        """(size, filter mask, offset, address) of each chunk of a fixed-array
        index (``FAHD``/``FADB``; paged when it holds over 2**page_bits)."""
        r = self._reader
        c = r.cursor(addr, 4 + 4 + r.l + r.o)
        if c.take(4) != b"FAHD":
            raise UnsupportedHDF5(f"{self.name}: fixed array header at {addr} without FAHD")
        c.pos += 1
        client, esize, page_bits = c.u(1), c.u(1), c.u(1)
        n, block = c.length(), c.addr()
        if block is None:
            return
        page = 1 << page_bits
        npages = -(-n // page) if n > page else 0
        prefix = 4 + 1 + 1 + r.o
        head = r.read(block, prefix + (npages + 7) // 8)
        if head[:4] != b"FADB":
            raise UnsupportedHDF5(f"{self.name}: fixed array data block at {block} without "
                                  f"FADB")
        if npages:
            bitmap = head[prefix:]
            spans, start = [], block + prefix + (npages + 7) // 8 + 4
            for p in range(npages):
                m = min(page, n - p * page)
                if bitmap[p // 8] >> (7 - p % 8) & 1:
                    spans.append((p * page, start, m))
                start += m * esize + 4
        else:
            spans = [(0, block + prefix, n)]
        for first, start, m in spans:
            c = r.cursor(start, m * esize)
            for i in range(first, first + m):
                chunk_addr = c.addr()
                if client == 1:  # filtered: address, size, filter mask
                    size, mask = c.u(esize - r.o - 4), c.u(4)
                else:
                    size, mask = nbytes, 0
                yield size, mask, at(i), chunk_addr


class File(Group):
    """An HDF5 file, read-only: the root group, and a context manager."""

    def __init__(self, path: str, mode: str = "r"):
        if mode != "r":
            raise ValueError(f"mode {mode!r}: the reader opens files read-only ('r')")
        reader = _Reader(os.fspath(path))
        try:
            super().__init__(reader, "/", reader.messages(reader.root))
        except BaseException:
            reader.close()
            raise
        self.filename = reader.path

    def close(self) -> None:
        self._reader.close()

    def __enter__(self) -> "File":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
