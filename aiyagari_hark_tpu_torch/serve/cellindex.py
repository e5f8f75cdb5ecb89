"""Sublinear nearest-neighbor index over stored solution cells (port of
``aiyagari_hark_tpu/serve/cellindex.py``, host code, copied).

``CellIndex`` (DESIGN §15) replaces the O(N) linear scan that
every donor nomination, degraded-answer selection, prefetch enumeration
and surrogate k-NN lookup paid per query (``store.nominate``/``nearest``
re-materialized the full cell matrix each call) with a grid-bucket
structure over NORMALIZED CellSpace coordinates: each stored cell lands
in the bucket ``floor(cell[i] / scale[i] / width)``, and a query
gathers candidates from expanding Chebyshev rings of buckets until the
ring lower bound proves no unexplored bucket can hold a closer (or
equally-close — ties matter) neighbor.

Bitwise contract — the index is an OPTIMIZATION, never a semantics
change, so ``nearest_k`` must return exactly what the linear scan
returns:

* distances are computed by the SAME ``parallel.sweep.neighbor_distance``
  expression (elementwise float64 ops, so a subset gather produces
  bit-identical values to the full-matrix scan);
* ties resolve by METADATA-DICT INSERTION ORDER, the order the linear
  scan's ``np.argsort(d, kind="stable")`` / first-``argmin`` resolves
  them in.  Every item carries a per-group monotone sequence number
  assigned on first insertion (a re-``put`` of a live key keeps its
  number, mirroring how a dict update keeps its position; a remove +
  re-add gets a fresh one, mirroring re-insertion at the dict tail),
  and candidates sort by ``np.lexsort((seq, d))``.

The ring search is exact: after exhausting every ring ``<= r``, any
unexplored bucket lies at Chebyshev ring ``>= r+1`` whose points are at
normalized-L1 distance ``>= r*width``; the search continues while that
bound could still admit a closer-or-tied candidate and stops only when
it cannot (with an ulp-scale slack so bucket-assignment rounding can
never cut off an exact-distance tie).

Query fast path: the 3x3x3 neighborhood BLOCK of the query's own bucket
(rings 0–1, the minimum any exact answer must examine — a ring-1 bucket
can hold a point at distance 0⁺) is concatenated ONCE and memoized per
bucket, invalidated by a per-group mutation generation, so a steady-
state query is one dict probe + one vectorized distance over the local
candidates.  Only when the k-th best cannot be proven inside the block
(sparse region, huge k) does the general ring loop run.

Bucket width self-tunes: ``bucket_width=None`` derives the width from
the occupied bounding box and item count at (re)build time targeting
``_TARGET_OCCUPANCY`` items per bucket, and a group that has grown 4x
since its last build is rebuilt on the next query — growth degrades
smoothly instead of silently going linear.  Rebuilds (restart index
load, scale change, re-width) invoke ``on_rebuild(group, n, reason)``
so the owning store can journal ``INDEX_REBUILD``.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np

_TARGET_OCCUPANCY = 8.0     # items per bucket the auto-width aims for
_MIN_WIDTH = 1e-3           # normalized-unit floor for the auto width
_REBUILD_GROWTH = 4         # re-width when a group grows this factor

# Chebyshev shell offsets, cached per (radius, dim): shell r is every
# offset with max(|c|) == r; the r<=1 shells union to the 3^dim block.
_SHELLS: dict = {}
_BLOCKS: dict = {}


def _shell(r: int, dim: int):
    got = _SHELLS.get((r, dim))
    if got is not None:
        return got
    rng = range(-r, r + 1)
    out = []

    def rec(prefix):
        if len(prefix) == dim:
            if max(abs(c) for c in prefix) == r:
                out.append(tuple(prefix))
            return
        for c in rng:
            rec(prefix + [c])

    rec([])
    _SHELLS[(r, dim)] = out
    return out


def _block_offsets(dim: int):
    got = _BLOCKS.get(dim)
    if got is None:
        got = _BLOCKS[dim] = _shell(0, dim) + _shell(1, dim)
    return got


class _Bucket:
    """One grid cell: parallel item columns plus a lazily-built numpy
    cache invalidated on every mutation — query paths touch arrays,
    never lists."""

    __slots__ = ("keys", "cells", "r_star", "cert", "seq", "cache")

    def __init__(self):
        self.keys = []
        self.cells = []
        self.r_star = []
        self.cert = []
        self.seq = []
        self.cache = None

    def arrays(self):
        if self.cache is None:
            self.cache = (
                np.asarray(self.cells, dtype=np.float64),
                np.asarray(self.seq, dtype=np.int64),
                np.asarray(self.r_star, dtype=np.float64),
                np.asarray(self.cert, dtype=np.int64),
                np.asarray(self.keys, dtype=np.int64),
            )
        return self.cache


class _GroupIndex:
    """Per-solver-group sub-index: insertion-ordered item table plus
    the lazily-built bucket grid (built on first query, when the
    querying scenario's ``scale`` becomes known)."""

    __slots__ = ("items", "next_seq", "scale", "width", "buckets",
                 "bbox_lo", "bbox_hi", "built_n", "gen", "blocks")

    def __init__(self):
        # key -> [cell_tuple, r_star, cert_level, seq, bucket_or_None]
        self.items: dict = {}
        self.next_seq = 0
        self.scale = None       # normalization the grid was built with
        self.width = None
        self.buckets: Optional[dict] = None
        self.bbox_lo = None     # occupied bucket-coordinate bounds
        self.bbox_hi = None
        self.built_n = 0
        self.gen = 0            # bumped on every mutation
        # bucket -> memoized 3x3x3 neighborhood candidate arrays:
        # (gen, cells, seqs, keys, finite_mask|None, cert_mask, n)
        self.blocks: dict = {}


class CellIndex:
    """Incrementally-maintained grid-bucket k-NN index (one per store).

    ``add``/``remove`` mirror every metadata mutation; ``nearest_k`` is
    the query.  Not thread-safe on its own — the owning store's lock
    serializes access (the same lock that already guards ``_meta``)."""

    def __init__(self, bucket_width: Optional[float] = None,
                 on_rebuild=None):
        self.bucket_width = bucket_width
        self.on_rebuild = on_rebuild
        self.rebuilds = 0
        self._groups: dict = {}
        # identity-keyed memo of the last scale conversion: callers pass
        # the same module-constant / CellSpace tuple every query
        self._scale_obj = None
        self._scale_t = None

    # -- maintenance --------------------------------------------------------

    def __len__(self) -> int:
        return sum(len(g.items) for g in self._groups.values())

    def group_size(self, group: int) -> int:
        g = self._groups.get(int(group))
        return 0 if g is None else len(g.items)

    def add(self, key: int, cell, group: int, r_star: float,
            cert_level: int) -> None:
        """Insert or refresh one item.  A live key keeps its insertion
        sequence number (dict-update semantics); a new key is appended
        at the tail of the group's order."""
        key = int(key)
        group = int(group)
        g = self._groups.get(group)
        if g is None:
            g = self._groups[group] = _GroupIndex()
        cell = tuple(float(c) for c in cell)
        r_star = float(r_star)
        cert_level = int(cert_level)
        g.gen += 1
        item = g.items.get(key)
        if item is not None:
            if item[0] == cell:
                # value refresh in place: same bucket, same seq
                item[1] = r_star
                item[2] = cert_level
                b = item[4]
                if b is not None:
                    i = b.keys.index(key)
                    b.r_star[i] = r_star
                    b.cert[i] = cert_level
                    b.cache = None
                return
            self._drop(g, key, item)
            item = None
        seq = g.next_seq
        g.next_seq += 1
        entry = [cell, r_star, cert_level, seq, None]
        g.items[key] = entry
        if g.buckets is not None:
            self._place(g, key, entry)

    def remove(self, key: int, group: int) -> None:
        key, group = int(key), int(group)
        g = self._groups.get(group)
        if g is None:
            return
        item = g.items.get(key)
        if item is not None:
            g.gen += 1
            self._drop(g, key, item)
            del g.items[key]

    def clear(self) -> None:
        self._groups = {}

    def _drop(self, g: _GroupIndex, key: int, item) -> None:
        b = item[4]
        if b is None:
            return
        i = b.keys.index(key)
        for col in (b.keys, b.cells, b.r_star, b.cert, b.seq):
            col.pop(i)
        b.cache = None
        item[4] = None

    def _coords(self, g: _GroupIndex, cell):
        w = g.width
        return tuple(math.floor(c / s / w)
                     for c, s in zip(cell, g.scale))

    def _place(self, g: _GroupIndex, key: int, item) -> None:
        bc = self._coords(g, item[0])
        b = g.buckets.get(bc)
        if b is None:
            b = g.buckets[bc] = _Bucket()
        b.keys.append(key)
        b.cells.append(item[0])
        b.r_star.append(item[1])
        b.cert.append(item[2])
        b.seq.append(item[3])
        b.cache = None
        item[4] = b
        g.bbox_lo = (bc if g.bbox_lo is None
                     else tuple(map(min, g.bbox_lo, bc)))
        g.bbox_hi = (bc if g.bbox_hi is None
                     else tuple(map(max, g.bbox_hi, bc)))

    # -- build --------------------------------------------------------------

    def _auto_width(self, g: _GroupIndex) -> float:
        n = max(1, len(g.items))
        cells = np.asarray([it[0] for it in g.items.values()],
                           dtype=np.float64)
        z = cells / np.asarray(g.scale, dtype=np.float64)
        span = z.max(axis=0) - z.min(axis=0)
        # width from the SPANNED axes only: a degenerate axis (a lattice
        # slice at one sd) contributes a constant bucket coordinate, so
        # folding its ~0 span into the volume would collapse the width
        # to the floor and scatter every item into its own bucket —
        # defeating the 3^dim block fast path for slice-shaped stores
        live = span > 1e-6
        if not live.any():
            return 1.0      # all items at one point: any width works
        vol = float(np.prod(span[live]))
        dim_eff = int(live.sum())
        return max(_MIN_WIDTH,
                   float((vol * _TARGET_OCCUPANCY / n)
                         ** (1.0 / dim_eff)))

    def _build(self, g: _GroupIndex, group: int, scale,
               reason: str) -> None:
        g.scale = tuple(float(s) for s in scale)
        g.buckets = {}
        g.blocks = {}
        g.bbox_lo = g.bbox_hi = None
        g.gen += 1
        g.width = (self.bucket_width if self.bucket_width is not None
                   else self._auto_width(g) if g.items else 1.0)
        for key, item in g.items.items():
            self._place(g, key, item)
        g.built_n = len(g.items)
        self.rebuilds += 1
        if self.on_rebuild is not None:
            self.on_rebuild(group, len(g.items), reason)

    def _build_block(self, g: _GroupIndex, b0):
        """Concatenate the 3^dim bucket neighborhood of ``b0`` into one
        candidate-array tuple, memoized until the group mutates."""
        parts = []
        for off in _block_offsets(len(b0)):
            b = g.buckets.get(tuple(c + o for c, o in zip(b0, off)))
            if b is not None and b.keys:
                parts.append(b.arrays())
        if not parts:
            blk = (g.gen, None, None, None, None, None, 0)
        else:
            cells = np.concatenate([p[0] for p in parts])
            seqs = np.concatenate([p[1] for p in parts])
            rst = np.concatenate([p[2] for p in parts])
            certs = np.concatenate([p[3] for p in parts])
            keys = np.concatenate([p[4] for p in parts])
            finite = np.isfinite(rst)
            blk = (g.gen, cells, seqs, keys,
                   None if bool(finite.all()) else finite,
                   certs >= 0, len(keys))
        g.blocks[b0] = blk
        return blk

    # -- query --------------------------------------------------------------

    def nearest_k(self, cell, group: int, k: Optional[int],
                  scale, require_certified: bool = False):
        """The k nearest stored items of ``group`` to ``cell`` in
        normalized-L1 distance — bitwise the linear scan's answer:
        ``[(key, distance), ...]`` ordered by ``(distance, insertion
        order)``, at most ``k`` long (``k=None`` ranks everything).
        Items with non-finite r* are skipped (the scan's NaN-row rule);
        ``require_certified`` keeps only ``cert_level >= 0`` donors."""
        from ..parallel.sweep import neighbor_distance

        group = int(group)
        g = self._groups.get(group)
        if g is None or not g.items:
            return []
        if scale is self._scale_obj:
            scale_t = self._scale_t
        else:
            scale_t = tuple(float(s) for s in scale)
            self._scale_obj, self._scale_t = scale, scale_t
        if g.buckets is None or g.scale != scale_t:
            self._build(g, group, scale_t, reason=(
                "first_query" if g.buckets is None else "scale_change"))
        elif len(g.items) > max(64, _REBUILD_GROWTH * max(1, g.built_n)):
            self._build(g, group, scale_t, reason="rewidth")
        n_total = len(g.items)
        if k is None:
            k = n_total
        cell = tuple(float(c) for c in cell)
        b0 = self._coords(g, cell)
        # the farthest occupied ring; beyond it there is nothing left
        lo, hi = g.bbox_lo, g.bbox_hi
        max_ring = 0
        for i in range(len(b0)):
            a = b0[i] - lo[i]
            if a > max_ring:
                max_ring = a
            a = hi[i] - b0[i]
            if a > max_ring:
                max_ring = a
        blk = g.blocks.get(b0)
        if blk is None or blk[0] != g.gen:
            blk = self._build_block(g, b0)
        _, cells, seqs, keys, finite, cert_ok, nblk = blk
        if nblk:
            mask = finite
            if require_certified:
                mask = cert_ok if mask is None else (mask & cert_ok)
            if mask is not None:
                cells_m = cells[mask]
                seqs_m = seqs[mask]
                keys_m = keys[mask]
            else:
                cells_m, seqs_m, keys_m = cells, seqs, keys
            cand_n = cells_m.shape[0]
            if cand_n:
                d = neighbor_distance(cell, cells_m, scale=g.scale)
                # unexplored rings >= 2 hold points at distance >=
                # 1*width; the epsilon slack keeps ulp-level rounding
                # in the bucket assignment from cutting off a tie
                exhaustive = max_ring <= 1 or nblk >= n_total
                if k == 1:
                    dmin = d.min()
                    if (exhaustive or g.width * (1.0 - 1e-9) - 1e-12
                            > float(dmin)):
                        ties = np.flatnonzero(d == dmin)
                        i = (int(ties[0]) if ties.shape[0] == 1 else
                             int(ties[int(np.argmin(seqs_m[ties]))]))
                        return [(int(keys_m[i]), float(d[i]))]
                else:
                    if exhaustive:
                        done = True
                    elif cand_n >= k:
                        kth = float(np.partition(d, k - 1)[k - 1]
                                    if cand_n > k else d.max())
                        done = g.width * (1.0 - 1e-9) - 1e-12 > kth
                    else:
                        done = False
                    if done:
                        order = np.lexsort((seqs_m, d))[:k]
                        return [(int(keys_m[i]), float(d[i]))
                                for i in order]
        elif max_ring <= 1:
            return []
        return self._ring_scan(g, cell, b0, k, require_certified,
                               neighbor_distance)

    def _ring_scan(self, g: _GroupIndex, cell, b0, k: int,
                   require_certified: bool, neighbor_distance):
        """The general expanding-ring search (the exactness backstop for
        sparse regions and large k; the block fast path answers the
        common case).  Walks ONLY the occupied buckets, in Chebyshev
        ring order — enumerating shell offsets is O(r^2) per ring and
        explodes when a degenerate item cluster forces a tiny width
        while the query sits far outside the occupied box (ring counts
        in the thousands); sorting the occupied buckets is O(B log B)
        regardless of how far away the query is."""
        ordered = sorted(
            ((max(abs(c - o) for c, o in zip(bc, b0)), bc)
             for bc, b in g.buckets.items() if b.keys),
            key=lambda t: t[0])
        parts = []          # per-bucket array tuples gathered so far
        gathered = 0
        i = 0
        nb = len(ordered)
        while i < nb:
            r = ordered[i][0]
            while i < nb and ordered[i][0] == r:
                b = g.buckets[ordered[i][1]]
                parts.append(b.arrays())
                gathered += len(b.keys)
                i += 1
            done = i >= nb        # every occupied bucket is in hand
            if not done and gathered < k:
                continue          # cannot finish yet: gather more first
            cells = np.concatenate([p[0] for p in parts])
            seqs = np.concatenate([p[1] for p in parts])
            rst = np.concatenate([p[2] for p in parts])
            certs = np.concatenate([p[3] for p in parts])
            keys = np.concatenate([p[4] for p in parts])
            mask = np.isfinite(rst)
            if require_certified:
                mask &= certs >= 0
            cand_n = int(mask.sum())
            d = (neighbor_distance(cell, cells[mask], scale=g.scale)
                 if cand_n else None)
            if not done and cand_n >= k:
                kth = float(np.partition(d, k - 1)[k - 1]
                            if cand_n > k else d.max())
                # an unexplored bucket lies at ring >= r_next, whose
                # points are at normalized-L1 distance >= (r_next-1) *
                # width (ulp slack as above)
                r_next = ordered[i][0]
                if (float(r_next - 1) * g.width * (1.0 - 1e-9)
                        - 1e-12 > kth):
                    done = True
            if done:
                if cand_n == 0:
                    return []
                order = np.lexsort((seqs[mask], d))[:k]
                keys_m = keys[mask]
                return [(int(keys_m[i]), float(d[i]))
                        for i in order]
        return []


def linear_nearest_k(cell, cells, seqs, k: Optional[int], scale):
    """The reference linear scan over a prebuilt (n, dim) cell matrix —
    the comparator the index is property-pinned (and speed-graded)
    against.  ``seqs`` carries insertion order for tie-breaking; returns
    ``[(row_index, distance), ...]``."""
    from ..parallel.sweep import neighbor_distance

    n = cells.shape[0]
    if n == 0:
        return []
    d = neighbor_distance(tuple(float(c) for c in cell), cells,
                          scale=scale)
    order = np.lexsort((np.asarray(seqs), d))[:(n if k is None else k)]
    return [(int(i), float(d[i])) for i in order]
