"""A NumPy + stdlib reader for the part of HDF5 that MATLAB v7.3 files use.

The counterpart of the h5py calls in the JAX package's data/matio.py. It
reads what the HDF5 1.8 library writes with its default (earliest) format
bounds, which is what MATLAB writes and h5py writes by default:

  * a user block of any power-of-two size (MATLAB's is 512 bytes) before
    a version 0 or 1 superblock; every address is relative to the
    superblock, its base address;
  * version 1 object headers, with continuation messages;
  * groups as symbol tables: a version 1 B-tree of group nodes, SNOD
    symbol table nodes and the local heap of link names;
  * datasets of little-endian fixed-point (1, 2, 4 or 8 bytes, signed or
    not) or IEEE float (4 or 8 bytes) elements, with the dataspace, fill
    value, layout (version 3) and filter pipeline messages; attributes
    are skipped;
  * contiguous, compact and chunked layouts, chunks indexed by the
    version 1 B-tree (type 1), edge chunks cut to the dataset's extent,
    chunks never written read as the fill value;
  * the deflate (zlib) and shuffle filters.

Anything else raises ValueError naming the feature (for example
"superblock version 2", "filter id 32001"), so a file this reader does
not understand is refused, never misread. Superblocks 2 and 3, version 2
object headers and the newer chunk indexes come with libver='latest'
files; MATLAB does not write them.

    with HDF5File(path) as f:
        f.keys()                  # the root group's names
        f["M"]                    # a dataset: an ndarray in its stored shape
        f.group("W_users")        # a group: {name: ndarray}
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEFINED = 0xFFFFFFFFFFFFFFFF

# object header message types
MSG_NIL = 0x0000
MSG_DATASPACE = 0x0001
MSG_LINK_INFO = 0x0002
MSG_DATATYPE = 0x0003
MSG_FILL_OLD = 0x0004
MSG_FILL = 0x0005
MSG_LINK = 0x0006
MSG_EXTERNAL = 0x0007
MSG_LAYOUT = 0x0008
MSG_GROUP_INFO = 0x000A
MSG_FILTERS = 0x000B
MSG_ATTRIBUTE = 0x000C
MSG_CONTINUATION = 0x0010
MSG_SYMBOL_TABLE = 0x0011
# messages that carry nothing a reader of these files needs
SKIPPED = {MSG_NIL, MSG_ATTRIBUTE, 0x000D, 0x000E, 0x0012, 0x0015, 0x0016}

FILTER_DEFLATE = 1
FILTER_SHUFFLE = 2


@dataclass
class _Layout:
    kind: str                          # "compact" | "contiguous" | "chunked"
    address: int = UNDEFINED           # contiguous data / chunk B-tree root
    data: bytes = b""                  # compact bytes
    chunk: Tuple[int, ...] = ()        # chunk dims (without the element size)


@dataclass
class _Object:
    """What the messages of one object header say."""
    shape: Optional[Tuple[int, ...]] = None
    dtype: Optional[np.dtype] = None
    fill: Optional[bytes] = None
    layout: Optional[_Layout] = None
    filters: Tuple[Tuple[int, int, Tuple[int, ...]], ...] = ()  # (id, flags, values)
    symbol_table: Optional[Tuple[int, int]] = None             # (B-tree, heap)


class HDF5File:
    """One HDF5 file opened for reading (a context manager)."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            self._read_superblock()
        except BaseException:
            self._f.close()
            raise

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- raw access --------------------------------------------------------

    def _read(self, address: int, n: int) -> bytes:
        """n bytes at a file address (relative to the base address)."""
        if address == UNDEFINED:
            raise ValueError(f"{self.path}: read at the undefined address")
        self._f.seek(self.base + address)
        data = self._f.read(n)
        if len(data) != n:
            raise ValueError(f"{self.path}: truncated at address {address:#x} "
                             f"({len(data)} of {n} bytes)")
        return data

    def _addr(self, buf: bytes, pos: int) -> int:
        return int.from_bytes(buf[pos:pos + self.so], "little")

    def _len(self, buf: bytes, pos: int) -> int:
        return int.from_bytes(buf[pos:pos + self.sl], "little")

    # -- superblock --------------------------------------------------------

    def _read_superblock(self) -> None:
        self._f.seek(0, 2)
        end = self._f.tell()
        at = 0
        while at + 8 <= end:
            self._f.seek(at)
            if self._f.read(8) == SIGNATURE:
                break
            at = 512 if at == 0 else 2 * at
        else:
            raise ValueError(f"{self.path}: no HDF5 signature (not an HDF5 file)")
        self._f.seek(at)
        head = self._f.read(24)
        version = head[8]
        if version not in (0, 1):
            raise ValueError(f"{self.path}: superblock version {version} "
                             f"(a newer format than MATLAB writes)")
        self.so, self.sl = head[13], head[14]
        if self.so != 8 or self.sl != 8:
            raise ValueError(f"{self.path}: {self.so}-byte offsets / {self.sl}-byte "
                             f"lengths (8-byte ones are read)")
        pos = 24 + (4 if version == 1 else 0)
        self._f.seek(at)
        sb = self._f.read(pos + 4 * 8 + 40)
        # the library takes the superblock's own position as the base address
        self.base = at
        root_entry = sb[pos + 4 * 8:]
        self.root = self._addr(root_entry, 8)   # the root group's object header

    # -- object headers ----------------------------------------------------

    def _messages(self, address: int) -> List[Tuple[int, int, bytes]]:
        """(type, flags, data) of every message of the version 1 object
        header at `address`, continuation blocks included."""
        prefix = self._read(address, 16)
        if prefix[:4] == b"OHDR":
            raise ValueError(f"{self.path}: version 2 object header at "
                             f"{address:#x} (a newer format than MATLAB writes)")
        if prefix[0] != 1:
            raise ValueError(f"{self.path}: object header version {prefix[0]} "
                             f"at {address:#x}")
        count = struct.unpack_from("<H", prefix, 2)[0]
        size = struct.unpack_from("<I", prefix, 8)[0]
        blocks = [(address + 16, size)]
        out = []
        while blocks and len(out) < count:
            start, n = blocks.pop(0)
            buf = self._read(start, n)
            pos = 0
            while pos + 8 <= n and len(out) < count:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                data = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == MSG_CONTINUATION:
                    blocks.append((self._addr(data, 0), self._len(data, self.so)))
                out.append((mtype, flags, data))
        return out

    def _object(self, address: int) -> _Object:
        obj = _Object()
        for mtype, flags, data in self._messages(address):
            if mtype in SKIPPED or mtype == MSG_CONTINUATION:
                continue
            if flags & 0x02:
                raise ValueError(f"{self.path}: shared message of type {mtype:#x} "
                                 f"at {address:#x}")
            if mtype == MSG_DATASPACE:
                obj.shape = self._dataspace(data)
            elif mtype == MSG_DATATYPE:
                obj.dtype = self._datatype(data)
            elif mtype == MSG_FILL:
                obj.fill = self._fill(data)
            elif mtype == MSG_FILL_OLD:
                n = struct.unpack_from("<I", data, 0)[0]
                obj.fill = data[4:4 + n] if n else None
            elif mtype == MSG_LAYOUT:
                obj.layout = self._layout(data)
            elif mtype == MSG_FILTERS:
                obj.filters = self._filters(data)
            elif mtype == MSG_SYMBOL_TABLE:
                obj.symbol_table = (self._addr(data, 0), self._addr(data, self.so))
            elif mtype in (MSG_LINK, MSG_LINK_INFO, MSG_GROUP_INFO):
                raise ValueError(f"{self.path}: link messages (a new-style group) "
                                 f"at {address:#x}")
            elif mtype == MSG_EXTERNAL:
                raise ValueError(f"{self.path}: external data files at {address:#x}")
            else:
                raise ValueError(f"{self.path}: object header message type "
                                 f"{mtype:#x} at {address:#x}")
        return obj

    def _dataspace(self, data: bytes) -> Tuple[int, ...]:
        version, rank, flags = data[0], data[1], data[2]
        if version == 1:
            pos = 8
        elif version == 2:
            if data[3] == 2:          # null dataspace
                return (0,)
            pos = 4
        else:
            raise ValueError(f"{self.path}: dataspace message version {version}")
        return tuple(self._len(data, pos + i * self.sl) for i in range(rank))

    def _datatype(self, data: bytes) -> np.dtype:
        cls, version = data[0] & 0x0F, data[0] >> 4
        bits = data[1] | (data[2] << 8) | (data[3] << 16)
        size = struct.unpack_from("<I", data, 4)[0]
        if cls == 0:                                  # fixed-point
            if bits & 0x01:
                raise ValueError(f"{self.path}: big-endian fixed-point datatype")
            if size not in (1, 2, 4, 8):
                raise ValueError(f"{self.path}: {size}-byte fixed-point datatype")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if cls == 1:                                  # floating-point
            if bits & 0x41:
                raise ValueError(f"{self.path}: big-endian or VAX float datatype")
            if size not in (4, 8):
                raise ValueError(f"{self.path}: {size}-byte float datatype")
            return np.dtype(f"<f{size}")
        names = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
                 7: "reference", 8: "enumerated", 9: "variable-length", 10: "array"}
        raise ValueError(f"{self.path}: {names.get(cls, f'class {cls}')} datatype "
                         f"(version {version})")

    def _fill(self, data: bytes) -> Optional[bytes]:
        version = data[0]
        if version in (1, 2):
            defined = data[3]
            if version == 2 and not defined:
                return None
            n = struct.unpack_from("<I", data, 4)[0]
            return data[8:8 + n] if n else None
        if version == 3:
            if not data[1] & 0x20:
                return None
            n = struct.unpack_from("<I", data, 2)[0]
            return data[6:6 + n] if n else None
        raise ValueError(f"{self.path}: fill value message version {version}")

    def _layout(self, data: bytes) -> _Layout:
        version = data[0]
        if version != 3:
            raise ValueError(f"{self.path}: data layout message version {version}")
        kind = data[1]
        if kind == 0:
            n = struct.unpack_from("<H", data, 2)[0]
            return _Layout("compact", data=data[4:4 + n])
        if kind == 1:
            return _Layout("contiguous", address=self._addr(data, 2))
        if kind == 2:
            ndims = data[2]
            address = self._addr(data, 3)
            dims = struct.unpack_from(f"<{ndims}I", data, 3 + self.so)
            return _Layout("chunked", address=address, chunk=tuple(dims[:-1]))
        raise ValueError(f"{self.path}: data layout class {kind}")

    def _filters(self, data: bytes):
        version, count = data[0], data[1]
        if version not in (1, 2):
            raise ValueError(f"{self.path}: filter pipeline message version {version}")
        pos = 8 if version == 1 else 2
        out = []
        for _ in range(count):
            fid = struct.unpack_from("<H", data, pos)[0]
            pos += 2
            name_len = 0
            if version == 1 or fid >= 256:
                name_len = struct.unpack_from("<H", data, pos)[0]
                pos += 2
            flags, nvalues = struct.unpack_from("<HH", data, pos)
            pos += 4
            if version == 1:
                name_len = (name_len + 7) // 8 * 8
            pos += name_len
            values = struct.unpack_from(f"<{nvalues}I", data, pos)
            pos += 4 * nvalues
            if version == 1 and nvalues % 2:
                pos += 4
            if fid not in (FILTER_DEFLATE, FILTER_SHUFFLE):
                raise ValueError(f"{self.path}: filter id {fid} (deflate and "
                                 f"shuffle are read)")
            out.append((fid, flags, values))
        return tuple(out)

    # -- groups ------------------------------------------------------------

    def _links(self, address: int) -> Dict[str, int]:
        """name -> object header address of a symbol-table group."""
        obj = self._object(address)
        if obj.symbol_table is None:
            raise ValueError(f"{self.path}: object at {address:#x} is not a group")
        btree, heap = obj.symbol_table
        hp = self._read(heap, 8 + 2 * self.sl + self.so)
        if hp[:4] != b"HEAP":
            raise ValueError(f"{self.path}: no local heap at {heap:#x}")
        heap_size = self._len(hp, 8)
        names = self._read(self._addr(hp, 8 + 2 * self.sl), heap_size)
        links = {}
        for snod in self._btree_children(btree, node_type=0):
            head = self._read(snod, 8)
            if head[:4] != b"SNOD":
                raise ValueError(f"{self.path}: no symbol table node at {snod:#x}")
            n = struct.unpack_from("<H", head, 6)[0]
            entries = self._read(snod + 8, n * 40)
            for i in range(n):
                e = entries[i * 40:(i + 1) * 40]
                off = self._len(e, 0)
                name = names[off:names.index(b"\0", off)].decode()
                links[name] = self._addr(e, self.sl)
        return links

    def _btree_nodes(self, address: int, node_type: int, key_size: int):
        """(key bytes, child address) of every leaf entry of the version 1
        B-tree at `address`, left to right; the key is the one before the
        child."""
        head = self._read(address, 8 + 2 * self.so)
        if head[:4] != b"TREE":
            raise ValueError(f"{self.path}: no B-tree node at {address:#x}")
        if head[4] != node_type:
            raise ValueError(f"{self.path}: B-tree node type {head[4]} at "
                             f"{address:#x}, expected {node_type}")
        level, used = head[5], struct.unpack_from("<H", head, 6)[0]
        step = key_size + self.so
        body = self._read(address + 8 + 2 * self.so, used * step + key_size)
        for i in range(used):
            key = body[i * step:i * step + key_size]
            child = self._addr(body, i * step + key_size)
            if level == 0:
                yield key, child
            else:
                yield from self._btree_nodes(child, node_type, key_size)

    def _btree_children(self, address: int, node_type: int):
        return [c for _, c in self._btree_nodes(address, node_type, self.sl)]

    # -- datasets ----------------------------------------------------------

    def _dataset(self, address: int) -> np.ndarray:
        obj = self._object(address)
        if obj.layout is None or obj.shape is None or obj.dtype is None:
            raise ValueError(f"{self.path}: object at {address:#x} is not a dataset")
        shape, dtype, lay = obj.shape, obj.dtype, obj.layout
        count = int(np.prod(shape, dtype=np.int64))
        if lay.kind == "compact":
            return np.frombuffer(lay.data, dtype, count).reshape(shape).copy()
        out = np.empty(shape, dtype)
        fill = (np.frombuffer(obj.fill, dtype, 1)[0] if obj.fill is not None
                and len(obj.fill) == dtype.itemsize else 0)
        if lay.kind == "contiguous":
            if lay.address == UNDEFINED:
                out.fill(fill)
                return out
            raw = self._read(lay.address, count * dtype.itemsize)
            return np.frombuffer(raw, dtype, count).reshape(shape).copy()
        out.fill(fill)
        if lay.address == UNDEFINED:
            return out
        rank = len(shape)
        if len(lay.chunk) != rank:
            raise ValueError(f"{self.path}: chunk rank {len(lay.chunk)} of a rank "
                             f"{rank} dataset")
        key_size = 8 + 8 * (rank + 1)
        for key, child in self._btree_nodes(lay.address, 1, key_size):
            nbytes, mask = struct.unpack_from("<II", key, 0)
            origin = struct.unpack_from(f"<{rank}Q", key, 8)
            raw = self._unfilter(self._read(child, nbytes), obj.filters, mask,
                                 dtype.itemsize)
            block = np.frombuffer(raw, dtype, int(np.prod(lay.chunk)))
            block = block.reshape(lay.chunk)
            dst = tuple(slice(o, min(o + c, s))
                        for o, c, s in zip(origin, lay.chunk, shape))
            out[dst] = block[tuple(slice(0, d.stop - d.start) for d in dst)]
        return out

    def _unfilter(self, raw: bytes, filters, mask: int, itemsize: int) -> bytes:
        """A chunk's bytes with the pipeline undone, last filter first;
        filter i is skipped where bit i of the chunk's mask is set."""
        for i in reversed(range(len(filters))):
            if mask >> i & 1:
                continue
            fid, _, values = filters[i]
            if fid == FILTER_DEFLATE:
                raw = zlib.decompress(raw)
            else:                                       # shuffle
                size = values[0] if values else itemsize
                n = len(raw) // size
                planes = np.frombuffer(raw, np.uint8, n * size).reshape(size, n)
                raw = planes.T.tobytes() + raw[n * size:]
        return raw

    # -- public ------------------------------------------------------------

    def keys(self) -> List[str]:
        """The root group's names, sorted."""
        return sorted(self._links(self.root))

    def _lookup(self, name: str) -> int:
        address = self.root
        for part in name.strip("/").split("/"):
            links = self._links(address)
            if part not in links:
                raise KeyError(f"{self.path}: no object {name!r}")
            address = links[part]
        return address

    def is_group(self, name: str) -> bool:
        return self._object(self._lookup(name)).symbol_table is not None

    def __getitem__(self, name: str) -> np.ndarray:
        """The dataset `name` (a path from the root) in its stored shape."""
        return self._dataset(self._lookup(name))

    def group(self, name: str) -> Dict[str, np.ndarray]:
        """The datasets of group `name`, by name."""
        address = self._lookup(name)
        return {k: self._dataset(a) for k, a in sorted(self._links(address).items())}
