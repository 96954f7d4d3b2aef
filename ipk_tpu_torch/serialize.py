"""``.ipk`` database serialization.

The port's own module, held to ``ipk_tpu/serialize.py`` by tests rather than
by its text: ``case_ipk_bytes`` (``tests/test_torch_host.py``) requires
both packages' ``save`` to write the same bytes and each to read the
other's files, and every ``payload`` test of ``tests/test_torch_build.py``
holds a build's decompressed file to ``ipk_tpu``'s. It departs in one
place: a compressed file's sections are cut in 4 MiB chunks, where
``ipk_tpu``'s ``save`` cuts every column in eighths of the largest once
that one passes 32 MiB; there the compressed bytes differ and the payload
is equal. The in-RAM ``save`` and the out-of-core merge
(``host._merge_on_disk``) write through the one writer, :func:`write_ipk`,
so they write one file for one database.

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

import collections
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, NamedTuple, Optional, Tuple, Union

import numpy as np

from .db import PhyloKmerDB
from .utils.threads import host_threads

__all__ = ["save", "load", "write_ipk", "BatchLoader", "COLUMNS", "columns"]

_MAGIC = struct.pack("<Q", 22) + b"serialization::archive" + struct.pack("<H", 18)

#: the record columns in file order: name, little-endian dtype, and whether
#: the column has a row per k-mer (else one per entry)
COLUMNS = (("keys", "<u8", True), ("fvs", "<f4", True),
           ("counts", "<u8", True), ("branches", "<u4", False),
           ("scores", "<f4", False), ("positions", "<u4", False))

#: an in-RAM section (any C-contiguous buffer) or the path of a file
Section = Union[bytes, memoryview, str]


def columns(positions: bool):
    """The rows of :data:`COLUMNS` a file holds: positions only under its
    header's flag."""
    return COLUMNS if positions else COLUMNS[:-1]


def _pack_str(s: str) -> bytes:
    data = s.encode("utf-8")
    return struct.pack("<Q", len(data)) + data


def _header_bytes(db: PhyloKmerDB, num_kmers: int, num_entries: int) -> bytes:
    """The magic and the header fields of ``db``'s file of ``num_kmers``
    rows and ``num_entries`` entries."""
    fields = [struct.pack("<I", db.version), _pack_str(db.sequence_type),
              struct.pack("<Q", len(db.tree_index))]
    fields += [struct.pack("<Qd", int(num_nodes), float(sbl))
               for num_nodes, sbl in db.tree_index]
    fields += [_pack_str(db.tree), struct.pack("<Q", db.kmer_size),
               struct.pack("<f", np.float32(db.omega)),
               struct.pack("<B", 1 if db.positions is not None else 0),
               struct.pack("<QQ", num_kmers, num_entries)]
    return _MAGIC + b"".join(fields)


class _Reader:
    """Header fields in file order, from an open file or from a buffer
    (sliced, not copied)."""

    def __init__(self, src):
        self.src, self.pos = src, 0

    def take(self, n: int):
        if hasattr(self.src, "read"):
            out = self.src.read(n)
        else:
            out = self.src[self.pos:self.pos + n]
        if len(out) != n:
            raise RuntimeError("Truncated .ipk file")
        self.pos += n
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
        return bytes(self.take(self.u64())).decode("utf-8")


class _Header(NamedTuple):
    """A file's header fields, as :func:`_read_header` reads them."""

    version: int
    sequence_type: str
    tree_index: list
    tree: str
    kmer_size: int
    omega: float
    has_positions: bool
    num_kmers: int
    num_entries: int
    size: int               # bytes from the file's start to the first column

    def sections(self) -> Dict[str, Tuple[int, np.dtype, int]]:
        """Each column's (byte offset, dtype, length): the table's columns
        one after another from the header's end."""
        out, off = {}, self.size
        for name, dtype, per_kmer in columns(self.has_positions):
            n = self.num_kmers if per_kmer else self.num_entries
            out[name] = (off, np.dtype(dtype), n)
            off += n * out[name][1].itemsize
        return out


def _read_header(src) -> Optional[_Header]:
    """The header at the start of ``src`` (a buffer, or a file opened at its
    start), or None where the data do not start with the magic: compressed
    (or foreign)."""
    r = _Reader(src)
    if bytes(r.take(len(_MAGIC))) != _MAGIC:
        return None
    version, sequence_type = r.u32(), r.string()
    tree_index = [(r.u64(), r.f64()) for _ in range(r.u64())]
    # the remaining fields in file order (arguments evaluate left to right)
    return _Header(version, sequence_type, tree_index, r.string(), r.u64(),
                   r.f32(), bool(r.u8()), r.u64(), r.u64(), r.pos)


def _zlib_levels() -> Tuple[int, int]:
    """The zlib levels of every section but the scores, and of the scores.

    ``IPK_TPU_ZLIB_LEVEL``, default 2: within ~5% of level 6's size on
    float-heavy columns but ~3x faster to write (the compressor was 2.2 s of
    a 10.6 s k=8 build). ``IPK_TPU_SCORE_ZLIB_LEVEL``, default 0: STORED
    blocks for the f32 scores, which measure ~0.85 compression ratio at
    ~25 MB/s/core while every other column compresses 2-50x; storing them
    trades ~15% file size for most of the write's time. Loaders are
    level-agnostic (zlib streams self-describe)."""
    return (int(os.environ.get("IPK_TPU_ZLIB_LEVEL", 2)),
            int(os.environ.get("IPK_TPU_SCORE_ZLIB_LEVEL", 0)))


def _chunks(section: Section, chunk_bytes: int):
    """A section ``chunk_bytes`` at a time from its start: slices of a
    buffer, reads of a file."""
    if isinstance(section, str):
        with open(section, "rb") as f:
            while chunk := f.read(chunk_bytes):
                yield chunk
    else:
        view = memoryview(section).cast("B")
        for i in range(0, len(view), chunk_bytes):
            yield view[i:i + chunk_bytes]


def write_ipk(filename: str, header: bytes, sections: Dict[str, Section],
              compressed: bool = True, *,
              chunk_bytes: int = 1 << 22) -> Dict[str, int]:
    """Write an ``.ipk``: ``header`` (:func:`_header_bytes`), then the
    sections named in ``sections`` in the order of :data:`COLUMNS`.

    Uncompressed, the sections follow one another as they are. Compressed,
    they form one zlib stream built pigz-style: each section cut into
    ``chunk_bytes`` chunks from its own start, each chunk raw-deflated on its
    own at its section's level (:func:`_zlib_levels`) and ended by a full
    flush (byte-aligned, no shared dictionary), under one zlib header, the
    final empty block and the adler32 of the whole payload, so any zlib
    reader takes it. A pool of ``host_threads("IPK_TPU_ZLIB_THREADS")``
    workers deflates; at most two chunks a worker are read and not yet
    written, so memory is bounded by the chunk length and the thread count,
    whatever the sections' sizes.

    Returns the compressed write's counts: the bytes of the payload stored
    at level 0 (``stored_bytes``) and deflated above it
    (``deflated_bytes``), and the chunks (``chunks``); none uncompressed.
    """
    parts = [("header", header)] + [(name, sections[name])
                                    for name, _, _ in COLUMNS
                                    if name in sections]
    if not compressed:
        with open(filename, "wb") as out:
            for _, section in parts:
                for chunk in _chunks(section, chunk_bytes):
                    out.write(chunk)
        return {}

    def deflate(chunk, level: int) -> Tuple[bytes, bytes]:
        co = zlib.compressobj(level, zlib.DEFLATED, -15)
        return co.compress(chunk), co.flush(zlib.Z_FULL_FLUSH)

    level, score_level = _zlib_levels()
    nthreads = host_threads("IPK_TPU_ZLIB_THREADS")
    counts = {"stored_bytes": 0, "deflated_bytes": 0, "chunks": 0}
    adler = zlib.adler32(b"")
    pending: collections.deque = collections.deque()   # (chunk, future)
    with open(filename, "wb") as out, \
            ThreadPoolExecutor(max_workers=nthreads) as pool:

        def write_oldest() -> None:
            nonlocal adler
            chunk, future = pending.popleft()
            adler = zlib.adler32(chunk, adler)
            out.writelines(future.result())

        out.write(b"\x78\x01")              # zlib header (CM=8, no dict)
        for name, section in parts:
            lvl = score_level if name == "scores" else level
            for chunk in _chunks(section, chunk_bytes):
                pending.append((chunk, pool.submit(deflate, chunk, lvl)))
                counts["chunks"] += 1
                counts["deflated_bytes" if lvl else "stored_bytes"] += (
                    len(chunk))
                if len(pending) == 2 * nthreads:
                    write_oldest()
        while pending:
            write_oldest()
        # the final empty block carries BFINAL, then the stream's checksum
        out.write(zlib.compressobj(1, zlib.DEFLATED, -15).flush(zlib.Z_FINISH))
        out.write(struct.pack(">I", adler & 0xFFFFFFFF))
    return counts


def save(db: PhyloKmerDB, filename: str, compressed: bool = True) -> None:
    """Serialize a whole DB in its stored row order through
    :func:`write_ipk` (the reference's boost::iostreams zlib is
    single-threaded; at DB sizes of hundreds of MB the compressor was the
    build's last serial stage)."""
    arrays = {"keys": db.keys, "fvs": db.filter_values,
              "counts": np.diff(db.offsets), "branches": db.branches,
              "scores": db.scores, "positions": db.positions}
    # zero-copy byte views (tobytes() duplicated every column; at production
    # sizes that is >1 GB of fresh pages on the serialize path)
    sections = {name: memoryview(np.ascontiguousarray(arrays[name], dtype))
                for name, dtype, _ in columns(db.positions is not None)}
    write_ipk(filename, _header_bytes(db, db.size(), db.num_entries()),
              sections, compressed)


def _decompress(raw: bytes) -> bytes:
    """Try zlib first, fall back to raw — the reference loader's behavior
    (CHANGELOG v0.3.0)."""
    try:
        return zlib.decompress(raw)
    except zlib.error:
        return raw


def _database(h: _Header, cols: Dict[str, np.ndarray],
              mapped: bool) -> PhyloKmerDB:
    """The database of a header and its columns, whose counts must index
    exactly the entries the header declares."""
    offsets = np.zeros(h.num_kmers + 1, dtype=np.int64)
    np.cumsum(cols["counts"].astype(np.int64), out=offsets[1:])
    if offsets[-1] != h.num_entries:
        raise RuntimeError(f"Corrupt .ipk: {offsets[-1]} entries indexed, "
                           f"{h.num_entries} declared")
    db = PhyloKmerDB(h.kmer_size, h.omega, h.sequence_type, h.tree,
                     h.tree_index, h.version)
    (db.set_data_mapped if mapped else db.set_data)(
        cols["keys"], cols["fvs"], offsets, cols["branches"], cols["scores"],
        cols.get("positions"))
    return db


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
        data = memoryview(_decompress(f.read()))
    h = _read_header(data)
    if h is None:
        raise RuntimeError(f"Not an ipk_tpu database: {filename}")
    cols = {}
    for name, (off, dt, n) in h.sections().items():
        buf = data[off:off + n * dt.itemsize]
        if len(buf) != n * dt.itemsize:
            raise RuntimeError("Truncated .ipk file")
        cols[name] = np.frombuffer(buf, dtype=dt).copy()
    return _database(h, cols, mapped=False)


def _load_mapped(filename: str) -> Optional[PhyloKmerDB]:
    """memmap-backed load for uncompressed files; None when compressed."""
    with open(filename, "rb") as f:
        h = _read_header(f)
    if h is None:
        return None
    return _database(h, {name: np.memmap(filename, dtype=dt, mode="r",
                                         offset=off, shape=(n,))
                         for name, (off, dt, n) in h.sections().items()},
                     mapped=True)


class BatchLoader:
    """Streaming cursor over one *uncompressed* batch DB for the out-of-core
    merge (cf. ``i2l::batch_loader``, ``db_builder.cpp:392-458``).

    Rather than load the whole file eagerly, this reads the header
    (``header``), takes the offsets of the column sections from it, and
    serves rows in bounded blocks via seek+read — resident memory is one
    block per column regardless of the batch size. The reference holds one
    record at a time (``batch_loader::next``); blocks amortize Python/syscall
    overhead while keeping the same O(1)-per-batch memory guarantee. A
    compressed file raises ``RuntimeError``, with no file left open
    (``tools.dump_database`` probes through that).
    """

    def __init__(self, filename: str, block_rows: int = 1 << 16):
        with open(filename, "rb") as f:
            self.header = _read_header(f)
        if self.header is None:
            raise RuntimeError(
                f"BatchLoader needs an uncompressed .ipk file: {filename}")
        self._col_off = self.header.sections()
        self._f = open(filename, "rb")
        self._block_rows = block_rows
        self._row = 0          # next unread k-mer row
        self._entry = 0        # next unread entry row

    def get_num_kmers(self) -> int:
        return self.header.num_kmers

    def rows_left(self) -> int:
        return self.header.num_kmers - self._row

    def _read_col(self, name: str, start: int, n: int) -> np.ndarray:
        off, dt, total = self._col_off[name]
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
                     if self.header.has_positions else None)
        self._row += n
        self._entry += ne
        return keys, fvs, counts, branches, scores, positions

    def close(self) -> None:
        self._f.close()
