"""``.ipk`` database serialization.

The port's own copy of ``ipk_tpu/serialize.py``: only its imports differ,
so numerics, ordering, formats and messages stay those of the reference.

Counterpart of the i2l v0.5.x streaming protocol whose *semantics* are pinned
by IPK call sites (``db_builder.cpp:297-332,392-458``; SURVEY.md §2.2): a
header {sequence type, tree index, newick tree, k, omega, #kmers, #entries}
followed by per-k-mer records {key, filter_value, entries} in filter order,
zlib-compressed by default with an uncompressed fallback on load
(CHANGELOG v0.3.0).

The exact i2l byte layout is unrecoverable from the reference snapshot (the
i2l submodule is absent — SURVEY.md gap G1), so this module defines a
self-consistent, versioned layout in the same style (boost-binary-archive-like
little-endian primitives, length-prefixed strings):

    magic:   u64 len=22 + b"serialization::archive" + u16 archive version (18)
    payload: u32 protocol_version
             str sequence_type            (u64 length + bytes)
             u64 tree_index count, then per node: u64 num_nodes + f64 length
             str tree                     (newick)
             u64 kmer_size
             f32 omega
             u8  positions flag           (aa-pos variant)
             u64 num_kmers, u64 num_entries
    records (columnar, rows in ascending (filter_value, key) order):
             u64  keys[num_kmers]
             f32  filter_values[num_kmers]
             u64  counts[num_kmers]       (entries per k-mer)
             u32  branches[num_entries]
             f32  scores[num_entries]
             u32  positions[num_entries]  (only when positions flag)

The record section is columnar rather than the reference's per-record stream:
whole-array numpy IO is ~2 orders of magnitude faster at production DB sizes
and compresses better; the logical content (per-k-mer entry lists in filter
order) is identical. Unlike the reference's ``ipkdiff`` (which always exits 0,
``tools/src/diff.cpp:115-116``), our diff tool fails properly — see
``ipk_tpu_torch.cli``.
"""

from __future__ import annotations

import io
import os
import struct
import zlib
from typing import BinaryIO, Iterator, List, Optional

import numpy as np

from .db import PhyloKmerDB, PROTOCOL_VERSION

__all__ = ["save", "load", "IpkWriter", "BatchLoader"]

_MAGIC = struct.pack("<Q", 22) + b"serialization::archive" + struct.pack("<H", 18)


def _pack_str(s: str) -> bytes:
    data = s.encode("utf-8")
    return struct.pack("<Q", len(data)) + data


class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.buf[self.pos:self.pos + n]
        if len(out) != n:
            raise RuntimeError("Truncated .ipk file")
        self.pos += n
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self.take(2))[0]

    def u8(self) -> int:
        return self.take(1)[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.take(8))[0]

    def string(self) -> str:
        n = self.u64()
        return bytes(self.take(n)).decode("utf-8")


class IpkWriter:
    """Streaming writer (compressed or raw), mirroring the reference's
    header-then-records archive streaming (``db_builder.cpp:145-147,297-332``)."""

    #: zlib level 2: within ~5% of level 6's size on float-heavy columns but
    #: ~3x faster to write (the compressor was 2.2 s of a 10.6 s k=8 build);
    #: loaders are level-agnostic (zlib streams self-describe)
    DEFAULT_ZLIB_LEVEL = 2

    def __init__(self, filename: str, compressed: bool = True):
        self._file: BinaryIO = open(filename, "wb")
        level = int(os.environ.get("IPK_TPU_ZLIB_LEVEL",
                                   self.DEFAULT_ZLIB_LEVEL))
        self._z = zlib.compressobj(level) if compressed else None
        self._positions = False
        self._keys, self._fvs, self._counts = [], [], []
        self._branches, self._scores, self._pos = [], [], []
        self._write(_MAGIC)

    def _write(self, data: bytes) -> None:
        if self._z is not None:
            self._file.write(self._z.compress(data))
        else:
            self._file.write(data)

    def write_header(self, db: PhyloKmerDB, num_kmers: int,
                     num_entries: int) -> None:
        out = io.BytesIO()
        out.write(struct.pack("<I", db.version))
        out.write(_pack_str(db.sequence_type))
        out.write(struct.pack("<Q", len(db.tree_index)))
        for num_nodes, sbl in db.tree_index:
            out.write(struct.pack("<Qd", int(num_nodes), float(sbl)))
        out.write(_pack_str(db.tree))
        out.write(struct.pack("<Q", db.kmer_size))
        out.write(struct.pack("<f", np.float32(db.omega)))
        out.write(struct.pack("<B", 1 if db.positions is not None else 0))
        out.write(struct.pack("<QQ", num_kmers, num_entries))
        self._write(out.getvalue())
        self._positions = db.positions is not None

    def write_kmer(self, key: int, filter_value: float,
                   branches: np.ndarray, scores: np.ndarray,
                   positions: Optional[np.ndarray] = None) -> None:
        """Queue one logical record (cf. ``i2l::save_phylo_kmer``,
        ``db_builder.cpp:327``); the columnar section is emitted on
        :meth:`close` / :meth:`flush_columns`."""
        self._keys.append(int(key))
        self._fvs.append(np.float32(filter_value))
        self._counts.append(len(branches))
        self._branches.append(np.asarray(branches, dtype=np.uint32))
        self._scores.append(np.asarray(scores, dtype=np.float32))
        if positions is not None:
            self._pos.append(np.asarray(positions, dtype=np.uint32))

    def write_columns(self, keys, filter_values, counts, branches, scores,
                      positions=None) -> None:
        """Vectorized whole-DB record section."""
        self._write(np.ascontiguousarray(keys, dtype="<u8").tobytes())
        self._write(np.ascontiguousarray(filter_values, dtype="<f4").tobytes())
        self._write(np.ascontiguousarray(counts, dtype="<u8").tobytes())
        self._write(np.ascontiguousarray(branches, dtype="<u4").tobytes())
        self._write(np.ascontiguousarray(scores, dtype="<f4").tobytes())
        if self._positions:
            self._write(np.ascontiguousarray(positions,
                                             dtype="<u4").tobytes())

    def write_raw(self, data: bytes) -> None:
        """Stream pre-encoded section bytes (the out-of-core merge spills
        column sections to disk and funnels them through the compressor)."""
        self._write(data)

    def flush_columns(self) -> None:
        if self._keys:
            self.write_columns(
                np.array(self._keys, dtype=np.uint64),
                np.array(self._fvs, dtype=np.float32),
                np.array(self._counts, dtype=np.uint64),
                np.concatenate(self._branches) if self._branches
                else np.zeros(0, np.uint32),
                np.concatenate(self._scores) if self._scores
                else np.zeros(0, np.float32),
                np.concatenate(self._pos) if self._pos else None)
        self._keys, self._fvs, self._counts = [], [], []
        self._branches, self._scores, self._pos = [], [], []

    def close(self) -> None:
        self.flush_columns()
        if self._z is not None:
            self._file.write(self._z.flush())
            self._z = None
        self._file.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _parallel_zlib(chunks: List[bytes], levels, nthreads: int
                   ) -> Iterator[bytes]:
    """pigz-style parallel deflate: each chunk is raw-deflated independently
    (Z_FULL_FLUSH terminators keep blocks byte-aligned and dictionary-free),
    concatenated under one zlib header with the adler32 of the whole
    uncompressed payload — a single standard zlib stream, so readers (ours
    and ``zlib.decompress``) see no difference from the serial writer.

    ``levels`` is per-chunk (an int applies to all): level 0 emits STORED
    blocks — used for the f32 score column, which measures ~0.85 compression
    ratio at ~25 MB/s/core (the build's last serial stage) while every other
    column compresses 2-50x; storing it trades ~15% file size for most of
    the serialize wall time."""
    from concurrent.futures import ThreadPoolExecutor

    if isinstance(levels, int):
        levels = [levels] * len(chunks)

    def deflate(args) -> bytes:
        chunk, lvl = args
        co = zlib.compressobj(lvl, zlib.DEFLATED, -15)
        return co.compress(chunk) + co.flush(zlib.Z_FULL_FLUSH)

    yield b"\x78\x01"                       # zlib header (CM=8, no dict)
    adler = zlib.adler32(b"")
    with ThreadPoolExecutor(max_workers=nthreads) as pool:
        for chunk, body in zip(chunks, pool.map(deflate,
                                                zip(chunks, levels))):
            adler = zlib.adler32(chunk, adler)
            yield body
    # final empty stored block carries BFINAL, then the stream checksum
    co = zlib.compressobj(1, zlib.DEFLATED, -15)
    yield co.flush(zlib.Z_FINISH)
    yield struct.pack(">I", adler & 0xFFFFFFFF)


def save(db: PhyloKmerDB, filename: str, compressed: bool = True) -> None:
    """Serialize a whole DB in its stored row order (vectorized).

    Compression runs pigz-style across column chunks on all host cores
    (the reference's boost::iostreams zlib is single-threaded; at DB sizes
    of hundreds of MB the compressor was the build's last serial stage).
    """
    if not compressed:
        with IpkWriter(filename, compressed=False) as w:
            w.write_header(db, db.size(), db.num_entries())
            w.write_columns(db.keys, db.filter_values, np.diff(db.offsets),
                            db.branches, db.scores, db.positions)
        return
    header = io.BytesIO()
    header.write(struct.pack("<I", db.version))
    header.write(_pack_str(db.sequence_type))
    header.write(struct.pack("<Q", len(db.tree_index)))
    for num_nodes, sbl in db.tree_index:
        header.write(struct.pack("<Qd", int(num_nodes), float(sbl)))
    header.write(_pack_str(db.tree))
    header.write(struct.pack("<Q", db.kmer_size))
    header.write(struct.pack("<f", np.float32(db.omega)))
    header.write(struct.pack("<B", 1 if db.positions is not None else 0))
    header.write(struct.pack("<QQ", db.size(), db.num_entries()))
    level = int(os.environ.get("IPK_TPU_ZLIB_LEVEL",
                               IpkWriter.DEFAULT_ZLIB_LEVEL))
    score_level = int(os.environ.get("IPK_TPU_SCORE_ZLIB_LEVEL", 0))

    def col(arr, dtype):
        # zero-copy byte view (tobytes() duplicated every column; at
        # production sizes that is >1 GB of fresh pages on the serialize
        # path — the deflate pool reads memoryview slices directly)
        return memoryview(np.ascontiguousarray(arr, dtype=dtype)).cast("B")

    cols = [(_MAGIC + header.getvalue(), level),
            (col(db.keys, "<u8"), level),
            (col(db.filter_values, "<f4"), level),
            (col(np.diff(db.offsets), "<u8"), level),
            (col(db.branches, "<u4"), level),
            (col(db.scores, "<f4"), score_level)]
    if db.positions is not None:
        cols.append((col(db.positions, "<u4"), level))
    # split big columns so both cores stay busy on skewed column sizes
    split = max(1 << 22, max(len(c) for c, _ in cols) // 8)
    chunks, levels = [], []
    for c, lvl in cols:
        for i in range(0, len(c), split):
            chunks.append(c[i:i + split])
            levels.append(lvl)
    from .utils.threads import host_threads
    with open(filename, "wb") as f:
        for part in _parallel_zlib(chunks, levels,
                                   host_threads("IPK_TPU_ZLIB_THREADS")):
            f.write(part)


def _decompress(raw: bytes) -> bytes:
    """Try zlib first, fall back to raw — the reference loader's behavior
    (CHANGELOG v0.3.0)."""
    try:
        return zlib.decompress(raw)
    except zlib.error:
        return raw


def load(filename: str, mmap: bool = False) -> PhyloKmerDB:
    """Load a database. With ``mmap=True`` the five column arrays are
    ``np.memmap`` views over the file — columns page in on demand, so DBs
    larger than RAM serve reads (dump, placement) without materializing
    (the ``batch_loader`` lazy-cursor idea, ``db_builder.cpp:392-458``,
    generalized to the whole container). Compressed files cannot be mapped:
    they fall back to a full in-RAM load (use ``--uncompressed`` builds for
    out-of-core serving).
    """
    if mmap:
        db = _load_mapped(filename)
        if db is not None:
            return db
    with open(filename, "rb") as f:
        data = _decompress(f.read())
    r = _Reader(data)
    if bytes(r.take(len(_MAGIC))) != _MAGIC:
        raise RuntimeError(f"Not an ipk_tpu database: {filename}")
    version = r.u32()
    sequence_type = r.string()
    n_index = r.u64()
    tree_index = [(r.u64(), r.f64()) for _ in range(n_index)]
    tree = r.string()
    kmer_size = r.u64()
    omega = r.f32()
    has_positions = bool(r.u8())
    num_kmers = r.u64()
    num_entries = r.u64()

    db = PhyloKmerDB(kmer_size, omega, sequence_type, tree, tree_index, version)

    def column(dtype, n):
        dt = np.dtype(dtype)
        return np.frombuffer(r.take(n * dt.itemsize), dtype=dt).copy()

    keys = column("<u8", num_kmers)
    fvs = column("<f4", num_kmers)
    counts = column("<u8", num_kmers)
    branches = column("<u4", num_entries)
    scores = column("<f4", num_entries)
    positions = column("<u4", num_entries) if has_positions else None
    offsets = np.zeros(num_kmers + 1, dtype=np.int64)
    np.cumsum(counts.astype(np.int64), out=offsets[1:])
    if offsets[-1] != num_entries:
        raise RuntimeError(f"Corrupt .ipk: {offsets[-1]} entries indexed, "
                           f"{num_entries} declared")
    db.set_data(keys, fvs, offsets, branches, scores, positions)
    return db


def _load_mapped(filename: str) -> Optional[PhyloKmerDB]:
    """memmap-backed load for uncompressed files; None when compressed."""
    with open(filename, "rb") as f:
        if f.read(len(_MAGIC)) != _MAGIC:
            return None                     # compressed (or foreign) file
        r = _StreamReader(f)
        version = r.u32()
        sequence_type = r.string()
        n_index = r.u64()
        tree_index = [(r.u64(), r.f64()) for _ in range(n_index)]
        tree = r.string()
        kmer_size = r.u64()
        omega = r.f32()
        has_positions = bool(r.u8())
        num_kmers = r.u64()
        num_entries = r.u64()
        base = f.tell()
    db = PhyloKmerDB(kmer_size, omega, sequence_type, tree, tree_index,
                     version)
    K, E = num_kmers, num_entries

    def col(dtype, n, off):
        return np.memmap(filename, dtype=np.dtype(dtype), mode="r",
                         offset=off, shape=(n,))

    keys = col("<u8", K, base)
    fvs = col("<f4", K, base + 8 * K)
    counts = col("<u8", K, base + 12 * K)
    branches = col("<u4", E, base + 20 * K)
    scores = col("<f4", E, base + 20 * K + 4 * E)
    positions = (col("<u4", E, base + 20 * K + 8 * E)
                 if has_positions else None)
    offsets = np.zeros(K + 1, dtype=np.int64)
    np.cumsum(counts.astype(np.int64), out=offsets[1:])
    if offsets[-1] != num_entries:
        raise RuntimeError(f"Corrupt .ipk: {offsets[-1]} entries indexed, "
                           f"{num_entries} declared")
    db.set_data_mapped(keys, fvs, offsets, branches, scores, positions)
    return db


class BatchLoader:
    """Streaming cursor over one *uncompressed* batch DB for the out-of-core
    merge (cf. ``i2l::batch_loader``, ``db_builder.cpp:392-458``).

    Rather than load the whole file eagerly, this reads
    the header, derives the absolute offsets of the five column sections,
    and serves rows in bounded blocks via seek+read — resident memory is one
    block per column regardless of the batch size. The reference holds one
    record at a time (``batch_loader::next``); blocks amortize Python/syscall
    overhead while keeping the same O(1)-per-batch memory guarantee.
    """

    def __init__(self, filename: str, block_rows: int = 1 << 16):
        self._f = open(filename, "rb")
        head = self._f.read(len(_MAGIC))
        if head != _MAGIC:
            # close before raising: dump_database probes compressed files
            # through this exception, which must not leak the fd
            self._f.close()
            raise RuntimeError(
                f"BatchLoader needs an uncompressed .ipk file: {filename}")
        r = _StreamReader(self._f)
        self.version = r.u32()
        self.sequence_type = r.string()
        n_index = r.u64()
        self.tree_index = [(r.u64(), r.f64()) for _ in range(n_index)]
        self.tree = r.string()
        self.kmer_size = r.u64()
        self.omega = r.f32()
        self.has_positions = bool(r.u8())
        self.num_kmers = r.u64()
        self.num_entries = r.u64()
        base = self._f.tell()
        K, E = self.num_kmers, self.num_entries
        self._col_off = {
            "keys": (base, "<u8", K),
            "fvs": (base + 8 * K, "<f4", K),
            "counts": (base + 12 * K, "<u8", K),
            "branches": (base + 20 * K, "<u4", E),
            "scores": (base + 20 * K + 4 * E, "<f4", E),
        }
        if self.has_positions:
            self._col_off["positions"] = (base + 20 * K + 8 * E, "<u4", E)
        self._block_rows = block_rows
        self._row = 0          # next unread k-mer row
        self._entry = 0        # next unread entry row

    def get_num_kmers(self) -> int:
        return self.num_kmers

    def rows_left(self) -> int:
        return self.num_kmers - self._row

    def _read_col(self, name: str, start: int, n: int) -> np.ndarray:
        off, dtype, total = self._col_off[name]
        dt = np.dtype(dtype)
        if start + n > total:
            raise RuntimeError("Truncated .ipk batch file")
        self._f.seek(off + start * dt.itemsize)
        buf = self._f.read(n * dt.itemsize)
        if len(buf) != n * dt.itemsize:
            raise RuntimeError("Truncated .ipk batch file")
        return np.frombuffer(buf, dtype=dt)

    def read_block(self, max_rows: Optional[int] = None):
        """Read the next ≤max_rows k-mers (and their entries). Returns
        (keys, fvs, counts, branches, scores, positions) or None at EOF."""
        n = min(max_rows or self._block_rows, self.rows_left())
        if n <= 0:
            return None
        keys = self._read_col("keys", self._row, n)
        fvs = self._read_col("fvs", self._row, n)
        counts = self._read_col("counts", self._row, n).astype(np.int64)
        ne = int(counts.sum())
        branches = self._read_col("branches", self._entry, ne)
        scores = self._read_col("scores", self._entry, ne)
        positions = (self._read_col("positions", self._entry, ne)
                     if self.has_positions else None)
        self._row += n
        self._entry += ne
        return keys, fvs, counts, branches, scores, positions

    def close(self) -> None:
        self._f.close()


class _StreamReader:
    """Header-field reader over an open file (no whole-file buffering)."""

    def __init__(self, f: BinaryIO):
        self.f = f

    def take(self, n: int) -> bytes:
        out = self.f.read(n)
        if len(out) != n:
            raise RuntimeError("Truncated .ipk file")
        return out

    def u64(self) -> int:
        return struct.unpack("<Q", self.take(8))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self.take(4))[0]

    def u8(self) -> int:
        return self.take(1)[0]

    def f32(self) -> float:
        return struct.unpack("<f", self.take(4))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self.take(8))[0]

    def string(self) -> str:
        return self.take(self.u64()).decode("utf-8")
