"""Compressed graph substrate: bit-packed delta CSRs + front-coded terms.

The uncompressed tier holds every triple three times as int32 -- once in
``TripleStore.spo`` (s, p, o order), once in the ``GraphIndex`` copy
(p, s, o order), plus a Python ``list``/``dict`` pair for the term
dictionary -- ~24 bytes of array per triple before the dictionary even
starts counting.  That is fine at the paper's 36k-triple bench scale and
hopeless at the 10M+ scale where Def. 4.8 savings become megabytes.
k2-triples and HDT (Alvarez-Garcia et al.) hold billion-edge
RDF graphs in RAM with exactly two moves, both reproduced here:

* **bit-packed, delta-encoded vertical partitions** -- inside one
  predicate's CSR extent the subject column is non-decreasing, so it is
  stored as block-anchored deltas; the object column is stored at the
  partition's own bit width.  The id columns of a 1M-triple graph need
  ~20 bits, deltas usually < 8 -- 4-7 bytes/triple instead of 24.
* **front-coded term storage** -- terms are sorted once and stored as
  (shared-prefix-length, suffix) runs in bucketed blocks; ``lookup`` is
  a binary search over bucket heads, ``term(id)`` decodes one bucket.
  No Python ``str`` objects are retained for the base vocabulary.

Everything decodes **on slice**: :class:`CompressedGraphIndex` answers
the exact accessor surface the sweep engine and the query engines
already consume (``entities_of_class`` / ``object_matrix`` /
``pred_objects_sorted`` / ``pred_slice`` / ...), materializing one
predicate partition at a time through a small LRU of resident decodes
(``max_resident``), so detection streams classes through the bucket
ladder with peak transient memory bounded by the largest class's
partitions + its object matrix -- never by the graph.

Mutation migrates tiers: ``filtered``/``merged``/``add_ids`` decode,
apply the plain-tier transform, and re-compress (or hand back a plain
structure where the caller immediately rebuilds).  The compressed tier
is the *read-mostly serving substrate*; writers recompress at snapshot
boundaries.

``DECODE_STATS`` counts partitions/values decoded and the peak resident
decoded bytes -- the evidence that streamed detection never holds the
whole graph uncompressed.  Host code, numpy: the object matrices it
decodes go to the device through the sweep workspaces, as on the plain
tier.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Sequence

import numpy as np

from .index import GraphIndex, PSO_PERM, SPO_PERM, in_sorted, sort_rows
from .triples import TripleStore

# -- decode accounting --------------------------------------------------------

DECODE_STATS = {
    "partitions": 0,          # partition decodes (LRU misses)
    "values": 0,              # total values decoded
    "resident_bytes": 0,      # currently resident decoded bytes (LRU)
    "peak_resident_bytes": 0,  # high-water mark of the above
}


def reset_decode_stats() -> None:
    DECODE_STATS["partitions"] = 0
    DECODE_STATS["values"] = 0
    DECODE_STATS["resident_bytes"] = 0
    DECODE_STATS["peak_resident_bytes"] = 0


def _note_decode(n_values: int) -> None:
    DECODE_STATS["partitions"] += 1
    DECODE_STATS["values"] += int(n_values)


def _note_resident(delta_bytes: int) -> None:
    DECODE_STATS["resident_bytes"] += int(delta_bytes)
    if DECODE_STATS["resident_bytes"] > DECODE_STATS["peak_resident_bytes"]:
        DECODE_STATS["peak_resident_bytes"] = DECODE_STATS["resident_bytes"]


# -- fixed-width bit packing --------------------------------------------------

def bit_width(max_value: int) -> int:
    """Bits needed for values in [0, max_value] (>= 1 so empty/zero
    columns stay addressable)."""
    return max(int(max_value).bit_length(), 1)


class PackedInts:
    """Fixed-width bit-packed non-negative integers.

    Value ``i`` occupies bits ``[i*bits, (i+1)*bits)`` of ``data``
    (MSB-first within each value) -- the flat layout every HDT-family
    engine uses.  ``slice_()`` decodes a contiguous range,
    ``take()`` gathers arbitrary indices; both touch only the bytes the
    requested values span.
    """

    __slots__ = ("data", "bits", "n")

    def __init__(self, data: np.ndarray, bits: int, n: int) -> None:
        self.data = data              # uint8 byte stream
        self.bits = int(bits)
        self.n = int(n)

    @classmethod
    def pack(cls, values: np.ndarray, bits: int | None = None
             ) -> "PackedInts":
        values = np.asarray(values, np.int64).reshape(-1)
        if values.size and values.min() < 0:
            raise ValueError("PackedInts stores non-negative values only")
        if bits is None:
            bits = bit_width(int(values.max()) if values.size else 0)
        shifts = np.arange(bits - 1, -1, -1, dtype=np.uint64)
        bitmat = ((values.astype(np.uint64)[:, None] >> shifts) & 1
                  ).astype(np.uint8)
        return cls(np.packbits(bitmat.ravel()), bits, values.size)

    @property
    def nbytes(self) -> int:
        return int(self.data.nbytes)

    def __len__(self) -> int:
        return self.n

    def slice_(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        """Decode values [start, stop) as int64."""
        stop = self.n if stop is None else min(int(stop), self.n)
        start = int(start)
        count = max(stop - start, 0)
        if count == 0:
            return np.empty((0,), np.int64)
        b = self.bits
        bit_lo, bit_hi = start * b, stop * b
        byte_lo, byte_hi = bit_lo // 8, (bit_hi + 7) // 8
        bits = np.unpackbits(self.data[byte_lo:byte_hi])
        off = bit_lo - 8 * byte_lo
        bits = bits[off:off + count * b].reshape(count, b)
        weights = (np.int64(1) << np.arange(b - 1, -1, -1)).astype(np.int64)
        return bits.astype(np.int64) @ weights

    def take(self, idx: np.ndarray) -> np.ndarray:
        """Gather arbitrary indices (int64 out) -- the compressed
        counterpart of ``rows[idx]`` fancy indexing / ``csr_take``
        gathers, touching only the spanned bytes of each value."""
        idx = np.asarray(idx, np.int64).reshape(-1)
        if idx.size == 0:
            return np.empty((0,), np.int64)
        b = self.bits
        # each value spans <= ceil(b/8) + 1 bytes; accumulate that many
        # bytes into one uint64 window, then shift the value out
        span = b // 8 + 2
        bit_lo = idx * b
        byte_lo = bit_lo // 8
        window = np.zeros(idx.shape, np.uint64)
        nbytes_total = self.data.shape[0]
        for j in range(span):
            bj = byte_lo + j
            valid = bj < nbytes_total
            byte = np.where(valid, self.data[np.minimum(bj,
                                                        nbytes_total - 1)], 0)
            window = (window << np.uint64(8)) | byte.astype(np.uint64)
        # value sits ``tail`` bits above the window's low end
        tail = (np.uint64(8) * np.uint64(span)
                - (bit_lo - byte_lo * 8).astype(np.uint64)
                - np.uint64(b))
        mask = np.uint64((1 << b) - 1) if b < 64 else ~np.uint64(0)
        return ((window >> tail) & mask).astype(np.int64)


class DeltaPacked:
    """Non-decreasing int column as block-anchored bit-packed deltas.

    Every ``block`` values an absolute anchor is stored (int64), between
    anchors only the successive differences at their maximal bit width.
    ``slice_`` decodes from the nearest anchor -- O(block + count) work
    regardless of position.
    """

    __slots__ = ("anchors", "deltas", "block", "n")

    def __init__(self, anchors, deltas, block, n) -> None:
        self.anchors = anchors
        self.deltas = deltas
        self.block = int(block)
        self.n = int(n)

    @classmethod
    def pack(cls, values: np.ndarray, block: int = 1024) -> "DeltaPacked":
        values = np.asarray(values, np.int64).reshape(-1)
        n = values.size
        if n == 0:
            return cls(np.empty((0,), np.int64),
                       PackedInts.pack(np.empty((0,), np.int64)), block, 0)
        diffs = np.diff(values)
        if diffs.size and diffs.min() < 0:
            raise ValueError("DeltaPacked requires a non-decreasing column")
        anchors = values[::block].copy()
        # anchor positions restart each block: zero the crossing diffs
        dd = diffs.copy()
        dd[block - 1::block] = 0
        return cls(anchors, PackedInts.pack(dd), block, n)

    @property
    def nbytes(self) -> int:
        return int(self.anchors.nbytes) + self.deltas.nbytes

    def __len__(self) -> int:
        return self.n

    def slice_(self, start: int = 0, stop: int | None = None) -> np.ndarray:
        stop = self.n if stop is None else min(int(stop), self.n)
        start = int(start)
        if stop <= start:
            return np.empty((0,), np.int64)
        b0, b1 = start // self.block, (stop - 1) // self.block
        lo = b0 * self.block
        # decode whole blocks [lo, stop): anchor + cumsum of in-block diffs
        out = np.empty((stop - lo,), np.int64)
        d = self.deltas.slice_(lo, stop - 1) if stop - 1 > lo \
            else np.empty((0,), np.int64)
        for bi in range(b0, b1 + 1):
            blo = bi * self.block
            bhi = min(blo + self.block, stop)
            seg = out[blo - lo:bhi - lo]
            seg[0] = self.anchors[bi]
            if bhi - blo > 1:
                seg[1:] = self.anchors[bi] + np.cumsum(
                    d[blo - lo:bhi - 1 - lo])
        return out[start - lo:]


# -- front-coded term storage -------------------------------------------------

class FrontCodedTerms:
    """Sorted, bucketed, front-coded immutable string pool.

    Bucket heads are stored whole; every other term as (lcp, suffix)
    against its predecessor.  ``find`` binary-searches bucket heads and
    walks at most one bucket; ``get`` decodes one bucket prefix chain.
    All storage is one ``bytes`` blob + int32/int64 offset arrays -- no
    per-term Python objects.
    """

    __slots__ = ("blob", "bucket_offsets", "bucket", "n", "_heads")

    def __init__(self, blob: bytes, bucket_offsets: np.ndarray,
                 bucket: int, n: int) -> None:
        self.blob = blob
        self.bucket_offsets = bucket_offsets
        self.bucket = int(bucket)
        self.n = int(n)
        self._heads: list[bytes] | None = None   # lazy head cache

    @staticmethod
    def _varint(x: int) -> bytes:
        out = bytearray()
        while True:
            b = x & 0x7F
            x >>= 7
            if x:
                out.append(b | 0x80)
            else:
                out.append(b)
                return bytes(out)

    @staticmethod
    def _read_varint(blob, pos: int) -> tuple[int, int]:
        shift = x = 0
        while True:
            b = blob[pos]
            pos += 1
            x |= (b & 0x7F) << shift
            if not b & 0x80:
                return x, pos
            shift += 7

    @classmethod
    def encode(cls, sorted_terms: Sequence[str], bucket: int = 16
               ) -> "FrontCodedTerms":
        blob = bytearray()
        offsets = []
        prev = b""
        for i, t in enumerate(sorted_terms):
            enc = t.encode("utf-8")
            if i % bucket == 0:
                offsets.append(len(blob))
                blob += cls._varint(len(enc))
                blob += enc
            else:
                lcp = 0
                m = min(len(prev), len(enc))
                while lcp < m and prev[lcp] == enc[lcp]:
                    lcp += 1
                blob += cls._varint(lcp)
                blob += cls._varint(len(enc) - lcp)
                blob += enc[lcp:]
            prev = enc
        return cls(bytes(blob), np.asarray(offsets, np.int64), bucket,
                   len(sorted_terms))

    @property
    def nbytes(self) -> int:
        return len(self.blob) + int(self.bucket_offsets.nbytes)

    def __len__(self) -> int:
        return self.n

    def _head(self, bi: int) -> bytes:
        if self._heads is None:
            self._heads = [None] * self.bucket_offsets.shape[0]
        h = self._heads[bi]
        if h is None:
            ln, pos = self._read_varint(self.blob, int(
                self.bucket_offsets[bi]))
            h = self.blob[pos:pos + ln]
            self._heads[bi] = h
        return h

    def _walk(self, bi: int):
        """Yield (rank, decoded bytes) over bucket ``bi``."""
        pos = int(self.bucket_offsets[bi])
        ln, pos = self._read_varint(self.blob, pos)
        cur = self.blob[pos:pos + ln]
        pos += ln
        base = bi * self.bucket
        yield base, cur
        hi = min(base + self.bucket, self.n)
        for r in range(base + 1, hi):
            lcp, pos = self._read_varint(self.blob, pos)
            sln, pos = self._read_varint(self.blob, pos)
            cur = cur[:lcp] + self.blob[pos:pos + sln]
            pos += sln
            yield r, cur

    def get(self, rank: int) -> str:
        """Decode the term at sorted position ``rank``."""
        if not 0 <= rank < self.n:
            raise IndexError(rank)
        bi = rank // self.bucket
        for r, cur in self._walk(bi):
            if r == rank:
                return cur.decode("utf-8")
        raise AssertionError("unreachable")

    def find(self, term: str) -> int | None:
        """Sorted position of ``term``, or None."""
        if self.n == 0:
            return None
        enc = term.encode("utf-8")
        lo, hi = 0, self.bucket_offsets.shape[0] - 1
        # rightmost bucket whose head <= enc
        while lo < hi:
            mid = (lo + hi + 1) // 2
            if self._head(mid) <= enc:
                lo = mid
            else:
                hi = mid - 1
        if self._head(lo) > enc:
            return None
        for r, cur in self._walk(lo):
            if cur == enc:
                return r
            if cur > enc:
                return None
        return None


class CompactTermDict:
    """Front-coded drop-in for :class:`~repro_torch.core.triples.TermDict`.

    Ids are preserved exactly from the dictionary it compacts (they are
    baked into every triple row), so the sorted front-coded pool carries
    two int32 permutations: ``id -> rank`` and ``rank -> id``.  New
    terms minted after compaction (surrogates, streamed inserts) go to a
    small mutable tail with ordinary list/dict storage -- the base
    vocabulary stays compressed forever.
    """

    __slots__ = ("_pool", "_id2rank", "_rank2id", "_tail_terms",
                 "_tail_index", "_base")

    def __init__(self, pool: FrontCodedTerms, id2rank: np.ndarray,
                 rank2id: np.ndarray) -> None:
        self._pool = pool
        self._id2rank = id2rank
        self._rank2id = rank2id
        self._base = int(id2rank.shape[0])
        self._tail_terms: list[str] = []
        self._tail_index: dict[str, int] = {}

    @classmethod
    def from_dict(cls, d, bucket: int = 16) -> "CompactTermDict":
        terms = [d.term(i) for i in range(len(d))]
        # sort by ENCODED bytes: ``find`` compares UTF-8, and python str
        # order diverges from byte order outside ASCII
        order = sorted(range(len(terms)),
                       key=lambda i: terms[i].encode("utf-8"))
        rank2id = np.asarray(order, np.int32)
        id2rank = np.empty((len(terms),), np.int32)
        id2rank[rank2id] = np.arange(len(terms), dtype=np.int32)
        pool = FrontCodedTerms.encode([terms[i] for i in order], bucket)
        return cls(pool, id2rank, rank2id)

    # -- TermDict surface --------------------------------------------------
    def lookup(self, term: str) -> int | None:
        r = self._pool.find(term)
        if r is not None:
            return int(self._rank2id[r])
        i = self._tail_index.get(term)
        return None if i is None else self._base + i

    def id(self, term: str) -> int:
        i = self.lookup(term)
        if i is None:
            i = self._base + len(self._tail_terms)
            self._tail_index[term] = len(self._tail_terms)
            self._tail_terms.append(term)
        return i

    def ids(self, terms: Sequence[str]) -> np.ndarray:
        return np.fromiter((self.id(t) for t in terms), np.int32,
                           count=len(terms))

    def term(self, i: int) -> str:
        i = int(i)
        if i < self._base:
            return self._pool.get(int(self._id2rank[i]))
        return self._tail_terms[i - self._base]

    def __len__(self) -> int:
        return self._base + len(self._tail_terms)

    def __contains__(self, term: str) -> bool:
        return self.lookup(term) is not None

    def nbytes(self) -> int:
        tail = sum(len(t) for t in self._tail_terms) \
            + 64 * len(self._tail_terms)
        return self._pool.nbytes + int(self._id2rank.nbytes) \
            + int(self._rank2id.nbytes) + tail


# -- compressed columns of a sorted triple array ------------------------------

class _CompressedRows:
    """(n, 3) sorted rows as three packed columns: the leading sort key
    delta-packed (non-decreasing), the others at fixed width."""

    __slots__ = ("lead", "mid", "trail", "perm", "n")

    def __init__(self, rows: np.ndarray, perm) -> None:
        rows = np.asarray(rows, np.int64).reshape(-1, 3)
        self.perm = tuple(perm)
        self.n = int(rows.shape[0])
        a, b, c = (rows[:, j] for j in self.perm)
        self.lead = DeltaPacked.pack(a)
        self.mid = PackedInts.pack(b)
        self.trail = PackedInts.pack(c)

    @property
    def nbytes(self) -> int:
        return self.lead.nbytes + self.mid.nbytes + self.trail.nbytes

    def decode(self) -> np.ndarray:
        out = np.empty((self.n, 3), np.int32)
        out[:, self.perm[0]] = self.lead.slice_()
        out[:, self.perm[1]] = self.mid.slice_()
        out[:, self.perm[2]] = self.trail.slice_()
        _note_decode(3 * self.n)
        return out


# -- the compressed index -----------------------------------------------------

class CompressedGraphIndex(GraphIndex):
    """Per-predicate CSR index with bit-packed delta-encoded columns.

    Same accessor surface and *identical results* as
    :class:`~repro_torch.core.index.GraphIndex` (tested), but the
    (p, s, o)-sorted row copy is never materialized: each predicate
    partition stores its subject column as block-anchored deltas and its
    object column at the partition's bit width, decoding on slice
    through an LRU of at most ``max_resident`` resident partitions.

    ``filtered``/``merged`` decode and hand back a *plain*
    ``GraphIndex`` -- mutation migrates to the uncompressed tier, and
    writers recompress at snapshot boundaries (``compress_store``).
    """

    __slots__ = ("_sub_parts", "_obj_parts", "max_resident", "_resident")

    def __init__(self, spo: np.ndarray, type_id: int, instance_of_id: int,
                 *, _presorted: bool = False,
                 max_resident: int | None = 8) -> None:
        rows = np.ascontiguousarray(spo, dtype=np.int32).reshape(-1, 3)
        if not _presorted:
            rows = sort_rows(rows, PSO_PERM)
        self.type_id = int(type_id)
        self.instance_of_id = int(instance_of_id)
        if rows.shape[0]:
            self.preds, first = np.unique(rows[:, 1], return_index=True)
            self.starts = np.append(first, rows.shape[0])
        else:
            self.preds = np.empty((0,), np.int32)
            self.starts = np.zeros((1,), np.int64)
        self._sub_parts: list[DeltaPacked] = []
        self._obj_parts: list[PackedInts] = []
        for i in range(self.preds.shape[0]):
            part = rows[self.starts[i]:self.starts[i + 1]]
            self._sub_parts.append(DeltaPacked.pack(part[:, 0]))
            self._obj_parts.append(PackedInts.pack(part[:, 2]))
        self.max_resident = max_resident
        self._resident: OrderedDict[int, tuple[np.ndarray, np.ndarray]] = \
            OrderedDict()
        self._ents_cache = {}
        self._props_cache = {}
        self._classes_cache = None
        self._objsort_cache = {}

    # -- storage accounting ------------------------------------------------
    def nbytes(self) -> int:
        total = int(self.preds.nbytes) + int(self.starts.nbytes)
        for sp, op in zip(self._sub_parts, self._obj_parts):
            total += sp.nbytes + op.nbytes
        return total

    @property
    def n_rows(self) -> int:
        return int(self.starts[-1])

    # -- decode-on-slice ---------------------------------------------------
    def _partition(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        """Decoded (subjects, objects) of partition ``i`` through the
        resident LRU."""
        hit = self._resident.get(i)
        if hit is not None:
            self._resident.move_to_end(i)
            return hit
        subs = self._sub_parts[i].slice_()
        objs = self._obj_parts[i].slice_()
        _note_decode(subs.size + objs.size)
        self._resident[i] = (subs, objs)
        _note_resident(subs.nbytes + objs.nbytes)
        if self.max_resident is not None:
            while len(self._resident) > self.max_resident:
                _, (es, eo) = self._resident.popitem(last=False)
                _note_resident(-(es.nbytes + eo.nbytes))
        return subs, objs

    def release_resident(self) -> None:
        """Drop every resident decoded partition (stream boundary)."""
        for subs, objs in self._resident.values():
            _note_resident(-(subs.nbytes + objs.nbytes))
        self._resident.clear()

    def release_transients(self) -> None:
        """Drop resident partitions AND the per-class / per-predicate
        decoded caches (entities, sorted objects).  The streamed
        detection path calls this between classes so accumulated caches
        never grow to O(graph) -- peak RSS stays bounded by the largest
        single class's working set."""
        self.release_resident()
        self._objsort_cache.clear()
        self._ents_cache.clear()

    @property
    def rows(self) -> np.ndarray:
        """Full decoded (p, s, o)-sorted row array -- the plain-tier
        fallback for mutation paths; NOT cached (O(n) per access)."""
        out = np.empty((self.n_rows, 3), np.int32)
        for i in range(self.preds.shape[0]):
            lo, hi = int(self.starts[i]), int(self.starts[i + 1])
            out[lo:hi, 0] = self._sub_parts[i].slice_()
            out[lo:hi, 1] = self.preds[i]
            out[lo:hi, 2] = self._obj_parts[i].slice_()
        _note_decode(3 * self.n_rows)
        return out

    def _pred_pos(self, p: int) -> int | None:
        i = int(np.searchsorted(self.preds, p))
        if i >= self.preds.shape[0] or self.preds[i] != p:
            return None
        return i

    # -- accessor surface (decode-on-slice) --------------------------------
    def pred_slice(self, p: int) -> np.ndarray:
        i = self._pred_pos(p)
        if i is None:
            return np.empty((0, 3), np.int32)
        subs, objs = self._partition(i)
        out = np.empty((subs.shape[0], 3), np.int32)
        out[:, 0] = subs
        out[:, 1] = p
        out[:, 2] = objs
        return out

    def pred_subjects(self, p: int) -> np.ndarray:
        i = self._pred_pos(p)
        if i is None:
            return np.empty((0,), np.int32)
        return self._partition(i)[0]

    def pred_count(self, p: int) -> int:
        i = self._pred_pos(p)
        return 0 if i is None else int(self.starts[i + 1] - self.starts[i])

    def pred_objects_sorted(self, p: int) -> np.ndarray:
        arr = self._objsort_cache.get(int(p))
        if arr is None:
            i = self._pred_pos(p)
            objs = self._partition(i)[1] if i is not None \
                else np.empty((0,), np.int64)
            arr = np.sort(objs.astype(np.int64))
            self._objsort_cache[int(p)] = arr
        return arr

    def entities_of_class(self, class_id: int) -> np.ndarray:
        ents = self._ents_cache.get(class_id)
        if ents is None:
            i = self._pred_pos(self.type_id)
            if i is None:
                ents = np.empty((0,), np.int32)
            else:
                subs, objs = self._partition(i)
                ents = subs[objs == class_id].astype(np.int32)
            self._ents_cache[class_id] = ents
        return ents

    def classes(self) -> np.ndarray:
        if self._classes_cache is None:
            i = self._pred_pos(self.type_id)
            self._classes_cache = np.unique(self._partition(i)[1]) \
                if i is not None else np.empty((0,), np.int64)
        return self._classes_cache

    def class_properties(self, class_id: int) -> np.ndarray:
        props = self._props_cache.get(class_id)
        if props is None:
            ents = self.entities_of_class(class_id)
            out = []
            for i, p in enumerate(self.preds.tolist()):
                if p == self.type_id or p == self.instance_of_id:
                    continue
                subs = self._partition(i)[0]
                if ents.shape[0] and in_sorted(subs, ents).any():
                    out.append(p)
            props = np.asarray(out, dtype=self.preds.dtype)
            self._props_cache[class_id] = props
        return props

    def _object_counts(self, class_id: int, props: np.ndarray
                       ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Same semantics as the plain index, but the join streams ONE
        predicate partition at a time into the (|C|, |SP|) output --
        transient decode is bounded by the largest single partition, not
        the sum over SP."""
        ents = self.entities_of_class(class_id)
        objmat = np.full((ents.size, props.size), -1, dtype=np.int32)
        counts = np.zeros((ents.size, props.size), np.int64)
        if ents.size == 0:
            return ents, objmat, counts
        for j, p in enumerate(props.tolist()):
            i = self._pred_pos(p)
            if i is None:
                continue
            subs, objs = self._partition(i)
            idx = np.searchsorted(ents, subs)
            idx_c = np.minimum(idx, ents.size - 1)
            hit = (idx < ents.size) & (ents[idx_c] == subs)
            ei = idx_c[hit]
            counts[:, j] += np.bincount(ei, minlength=ents.size)
            objmat[ei, j] = objs[hit]
        return ents, objmat, counts

    def labeled_edge_count(self, class_id: int, props=None) -> int:
        ents = self.entities_of_class(class_id)
        if ents.shape[0] == 0:
            return 0
        if props is not None:
            pids = [int(p) for p in props]
        else:
            pids = [int(p) for p in self.preds.tolist()
                    if p != self.type_id]
        total = 0
        for p in pids:
            i = self._pred_pos(p)
            if i is not None:
                total += int(in_sorted(self._partition(i)[0], ents).sum())
        return total

    # -- mutation migrates to the plain tier -------------------------------
    def filtered(self, keep: np.ndarray) -> GraphIndex:
        out = GraphIndex.__new__(GraphIndex)
        GraphIndex.__init__(out, self.rows[keep], self.type_id,
                            self.instance_of_id, _presorted=True)
        return out

    def merged(self, new_rows: np.ndarray) -> GraphIndex:
        plain = GraphIndex.__new__(GraphIndex)
        GraphIndex.__init__(plain, self.rows, self.type_id,
                            self.instance_of_id, _presorted=True)
        return plain.merged(new_rows)


# -- the compressed store -----------------------------------------------------

class CompressedTripleStore(TripleStore):
    """Triple store holding its rows ONLY in compressed form.

    ``_spo`` is virtualized: reads decode (cached until
    :meth:`release_decoded`), writes re-compress -- so every inherited
    ``TripleStore`` method works unchanged, paying a transient decode
    when it genuinely needs the flat array.  The hot read paths
    (class/schema/object-matrix/selectivity probes) ride the
    :class:`CompressedGraphIndex` and never materialize the graph.
    """

    def __init__(self, dictionary=None, spo=None, *,
                 presorted: bool = False,
                 max_resident: int | None = 8) -> None:
        self._max_resident = max_resident
        self._cspo: _CompressedRows | None = None
        self._dec_spo: np.ndarray | None = None
        super().__init__(dictionary, spo, presorted=presorted)

    @property
    def is_compressed(self) -> bool:
        return True

    # -- virtualized _spo --------------------------------------------------
    @property
    def _spo(self) -> np.ndarray:
        if self._dec_spo is None:
            self._dec_spo = self._cspo.decode() if self._cspo is not None \
                else np.empty((0, 3), np.int32)
        return self._dec_spo

    @_spo.setter
    def _spo(self, rows: np.ndarray) -> None:
        rows = np.ascontiguousarray(rows, np.int32).reshape(-1, 3)
        self._cspo = _CompressedRows(rows, SPO_PERM)
        # keep the freshly-given rows as the decode cache: setters are
        # always followed by reads in the inherited mutation paths
        self._dec_spo = rows

    def release_decoded(self) -> None:
        """Drop the decoded ``spo`` cache (and the index's resident
        partitions): back to compressed-only residency."""
        self._dec_spo = None
        if self._index is not None and \
                isinstance(self._index, CompressedGraphIndex):
            self._index.release_resident()

    def release_transients(self) -> None:
        """Stream boundary: drop the decoded ``spo`` cache, resident
        partitions, and per-class decode caches (see
        :meth:`CompressedGraphIndex.release_transients`)."""
        self._dec_spo = None
        if self._index is not None and \
                isinstance(self._index, CompressedGraphIndex):
            self._index.release_transients()

    # -- index tier --------------------------------------------------------
    @property
    def index(self) -> CompressedGraphIndex:
        if self._index is None:
            self._index = CompressedGraphIndex(
                self._spo, self.TYPE, self.INSTANCE_OF,
                max_resident=self._max_resident)
            self._dec_spo = None     # index build decoded nothing extra
        return self._index

    @property
    def n_triples(self) -> int:
        return self._cspo.n if self._cspo is not None else 0

    def copy(self) -> "CompressedTripleStore":
        new = CompressedTripleStore.__new__(CompressedTripleStore)
        new.dict = self.dict
        new.TYPE = self.TYPE
        new.INSTANCE_OF = self.INSTANCE_OF
        new._max_resident = self._max_resident
        new._cspo = self._cspo        # immutable once packed: shareable
        new._dec_spo = None
        new._index = self._index
        return new

    # -- storage accounting ------------------------------------------------
    def substrate_nbytes(self, include_dict: bool = True) -> int:
        total = self._cspo.nbytes if self._cspo is not None else 0
        total += self.index.nbytes()
        if include_dict and hasattr(self.dict, "nbytes"):
            total += self.dict.nbytes()
        return total


def compress_store(store: TripleStore, *, max_resident: int | None = 8,
                   compact_dict: bool = True) -> CompressedTripleStore:
    """Compress a plain store into the bit-packed tier.

    The dictionary is front-coded by default (term ids preserved, so the
    compressed store answers the exact same id-level queries); pass
    ``compact_dict=False`` to share the original mutable ``TermDict``
    (e.g. when other live stores keep minting into it).
    """
    d = store.dict
    if compact_dict and not isinstance(d, CompactTermDict):
        d = CompactTermDict.from_dict(d)
    out = CompressedTripleStore(d, store.spo, presorted=True,
                                max_resident=max_resident)
    return out


# one reset clears the decode counters together with the sweep counters
# (core.sweep.reset_trace_stats is the one reset hook)
from .sweep import register_stats_reset  # noqa: E402

register_stats_reset(reset_decode_stats)
