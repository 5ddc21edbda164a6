"""Taxonomy model as dense arrays.

Dense-array redesign of the reference's taxonomy layer (reference:
``/root/reference/src/taxon.rs``). Where the reference keeps a pointer tree
(``TaxonTree``, ``src/taxon.rs:214-302``) and walks it recursively, we build
dense, id-indexed ``numpy`` vectors once on the host — parent, rank, valid,
depth, snapping — and ship them to device memory so that every per-read tree
operation (LCA, snapping, MRTL walks) becomes a batch of gathers.

File format parity: the 5-column taxon TSV (``id\\tname\\trank\\tparent\\t
\\x01|\\x00``) parses exactly like ``Taxon::from_str``
(``src/taxon.rs:89-113``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

from . import ranks


class TaxonomyError(ValueError):
    """Raised for malformed taxon files or unknown taxa."""


@dataclass(frozen=True)
class Taxon:
    id: int
    name: str
    rank: int  # index into ranks.RANK_NAMES
    parent: int
    valid: bool


def parse_taxon_line(line: str) -> Taxon:
    """Parse one taxon TSV line (reference src/taxon.rs:89-113).

    Trailing whitespace is trimmed first; exactly five tab-separated fields
    are required; the valid byte must be \\x01 (true) or \\x00 (false).
    """
    fields = line.rstrip().split("\t")
    if len(fields) != 5:
        raise TaxonomyError("Taxon requires five fields")
    sid, name, rank_str, sparent, valid_byte = fields
    try:
        tid = int(sid)
        parent = int(sparent)
    except ValueError as e:
        raise TaxonomyError(f"Invalid taxon ID: {e}") from e
    if tid < 0 or parent < 0:
        raise TaxonomyError("Invalid taxon ID: negative")
    try:
        rank = ranks.rank_index(rank_str)
    except KeyError:
        raise TaxonomyError(f"Unknown rank: {rank_str}") from None
    if valid_byte == "\x01":
        valid = True
    elif valid_byte == "\x00":
        valid = False
    else:
        raise TaxonomyError("Couldn't parse the valid byte")
    return Taxon(tid, name, rank, parent, valid)


def read_taxa_file(path) -> list[Taxon]:
    """Read a taxon TSV file, one taxon per line (src/taxon.rs:119-128)."""
    taxa = []
    with open(path, "r", encoding="utf-8", newline="") as f:
        for line in f:
            line = line.rstrip("\n").rstrip("\r")
            taxa.append(parse_taxon_line(line))
    return taxa


# Sentinel for "no taxon" in int arrays (None in the reference).
NONE = -1


class Taxonomy:
    """Dense array view of a taxon list.

    Vectors are indexed by taxon id (length ``max_id + 1``). ``present[i]``
    marks ids that appeared in the input (``TaxonList``'s Some slots,
    reference src/taxon.rs:131-145).
    """

    def __init__(self, taxa: Sequence[Taxon], with_unknown: bool = False):
        if not taxa:
            raise TaxonomyError("empty taxonomy")
        max_id = max(t.id for t in taxa)
        n = max_id + 1
        self.size = n
        self.present = np.zeros(n, dtype=bool)
        self.parent = np.full(n, NONE, dtype=np.int64)
        self.rank = np.zeros(n, dtype=np.int8)
        self.valid = np.zeros(n, dtype=bool)
        self.names: list[str | None] = [None] * n
        # Children in insertion order, mirroring TaxonTree::new's push order
        # (src/taxon.rs:224-247); needed for a reference-shaped Euler tour.
        self._children: dict[int, list[int]] = {}

        roots = set(t.id for t in taxa)
        for t in taxa:
            i = t.id
            self.present[i] = True
            self.parent[i] = t.parent
            self.rank[i] = t.rank
            self.valid[i] = t.valid
            self.names[i] = t.name
            if t.id != t.parent:
                self._children.setdefault(t.parent, []).append(t.id)
                roots.discard(t.id)
        if with_unknown and not self.present[0]:
            # TaxonList::new_with_unknown (src/taxon.rs:149-155)
            self.present[0] = True
            self.parent[0] = 0
            self.rank[0] = ranks.NO_RANK
            self.valid[0] = False
            self.names[0] = "unknown"
        if len(roots) > 1:
            raise TaxonomyError("More than one root!")
        if not roots:
            raise TaxonomyError("There's no root!")
        self.root = next(iter(roots))

        # Depth of every node reachable from the root *through present
        # parents*; unreachable/absent nodes keep depth NONE. Computed with
        # level-by-level relaxation (max taxonomy depth passes).
        depth = np.full(n, NONE, dtype=np.int64)
        depth[self.root] = 0
        ids = np.nonzero(self.present)[0]
        parents = self.parent[ids]
        # guard: parent id out of range or absent -> never reachable
        parent_ok = (parents >= 0) & (parents < n)
        for _ in range(n):
            pd = np.where(parent_ok, depth[np.clip(parents, 0, n - 1)], NONE)
            newd = np.where(
                (depth[ids] == NONE) & (pd != NONE) & (ids != self.root),
                pd + 1,
                depth[ids],
            )
            if np.array_equal(newd, depth[ids]):
                break
            depth[ids] = newd
        self.depth = depth
        self.max_depth = int(depth.max(initial=0))

    # ------------------------------------------------------------------ #
    # Reference-equivalent queries
    # ------------------------------------------------------------------ #

    def get(self, tid: int) -> Taxon | None:
        """TaxonList::get (src/taxon.rs:166-172)."""
        if tid < 0 or tid >= self.size or not self.present[tid]:
            return None
        return Taxon(
            tid,
            self.names[tid] or "",
            int(self.rank[tid]),
            int(self.parent[tid]),
            bool(self.valid[tid]),
        )

    def get_or_unknown(self, tid: int) -> Taxon:
        """TaxonList::get_or_unknown (src/taxon.rs:176-179): raises for
        absent ids."""
        t = self.get(tid)
        if t is None:
            raise TaxonomyError(f"Unknown Taxon ID: {tid}")
        return t

    def score(self, tid: int, default: int | None = None) -> int | None:
        """Rank score after walking to the first ranked ancestor
        (TaxonList::score, src/taxon.rs:181-191). Returns ``default`` when the
        walk ends on an unknown taxon or yields None."""
        current = tid
        seen = 0
        while 0 <= current < self.size and self.present[current]:
            if self.parent[current] == current or self.rank[current] != ranks.NO_RANK:
                s = int(ranks.RANK_SCORES[self.rank[current]])
                return s if s != 0 else default
            current = int(self.parent[current])
            seen += 1
            if seen > self.size:
                break
        return default

    def ancestry(self) -> np.ndarray:
        """Parent id per node, NONE where absent (src/taxon.rs:158-163)."""
        return np.where(self.present, self.parent, NONE)

    def lineage(self, tid: int) -> list[int]:
        """Full 32-slot lineage (taxon id per rank, NONE elsewhere;
        src/taxon.rs:194-209). Raises TaxonomyError on unknown taxa."""
        arr = [NONE] * ranks.RANK_COUNT
        next_id, prev_id = tid, None
        seen = 0
        while next_id != prev_id:
            if not (0 <= next_id < self.size) or not self.present[next_id]:
                raise TaxonomyError(f"Unknown Taxon ID: {next_id}")
            r = int(self.rank[next_id])
            if r != ranks.NO_RANK:
                arr[r] = next_id
            prev_id = next_id
            next_id = int(self.parent[next_id])
            seen += 1
            if seen > self.size:  # parent cycle: never hang (cf. score)
                raise TaxonomyError(f"Taxon {tid} has a cyclic ancestry")
        return arr

    # ------------------------------------------------------------------ #
    # Snapping (filter_ancestors) — vectorized
    # ------------------------------------------------------------------ #

    def filter_ancestors(self, keep: np.ndarray) -> np.ndarray:
        """For every node reachable from the root, the nearest ancestor-or-
        self passing ``keep``; the root maps to itself even when it fails the
        filter (reference TaxonTree::filter_ancestors + with_filtered,
        src/taxon.rs:251-281). Unreachable slots are NONE.

        ``keep`` is a boolean vector of length ``size``.
        """
        snap = np.full(self.size, NONE, dtype=np.int64)
        snap[self.root] = self.root  # root maps to itself even if filtered
        depth = self.depth
        maxd = int(depth.max()) if self.size else 0
        for d in range(1, maxd + 1):  # level-by-level: parents resolved
            ids = np.flatnonzero(depth == d)
            if len(ids):
                snap[ids] = np.where(keep[ids], ids,
                                     snap[self.parent[ids]])
        return snap

    def snapping(self, ranked_only: bool) -> np.ndarray:
        """Nearest valid (and optionally ranked) ancestor per node
        (TaxonTree::snapping, src/taxon.rs:294-301)."""
        keep = self.present & self.valid
        if ranked_only:
            keep &= self.rank != ranks.NO_RANK
        return self.filter_ancestors(keep)

    def seed_scores(self) -> np.ndarray:
        """Vectorized TaxonList::score (src/taxon.rs:181-191): for every
        node, the rank score of its nearest ranked-or-self-parent
        ancestor; 0 encodes "no score" (None — absent nodes, and chains
        ending in an unranked root). Used by scored seedextend, where 0
        falls back to the gap penalty."""
        keep = self.present & (self.rank != ranks.NO_RANK)
        anc = self.filter_ancestors(keep)  # root is its own ancestor
        out = np.zeros(self.size, dtype=np.int32)
        ok = anc != NONE
        out[ok] = ranks.RANK_SCORES[self.rank[anc[ok]]]
        return out

    def rank_snapping(
        self,
        rank: int | None,
        taxa: Iterable[int] = (),
        require_valid: bool = False,
    ) -> np.ndarray:
        """Snapping to an exact rank and/or an explicit taxon set.

        snaptaxon (src/commands/snaptaxon.rs:82-90) passes
        ``require_valid=not invalid`` and matches listed taxa regardless of
        presence; taxa2freq (src/commands/taxa2freq.rs:96-97) passes
        ``require_valid=False`` and no taxa list (it does not check validity).
        """
        if rank is None:
            keep = np.zeros(self.size, dtype=bool)
        else:
            keep = self.present & (self.rank == rank)
            if require_valid:
                keep &= self.valid
        for t in taxa:
            if 0 <= t < self.size:
                keep[t] = True
        return self.filter_ancestors(keep)

    # ------------------------------------------------------------------ #
    # Euler tour (for reference-shaped RMQ-LCA)
    # ------------------------------------------------------------------ #

    def euler_tour(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Standard Euler tour from the root: the node is emitted before each
        child's subtree and once after the last (EulerIterator,
        src/taxon.rs:309-392). Returns (tour ids, tour depths,
        first_occurrence[size] with NONE for untoured ids)."""
        tour: list[int] = []
        depths: list[int] = []
        first = np.full(self.size, NONE, dtype=np.int64)

        # Iterative DFS; stack holds (node, next-child-index, depth).
        stack = [(self.root, 0, 0)]
        while stack:
            node, ci, d = stack.pop()
            if first[node] == NONE:
                first[node] = len(tour)
            tour.append(node)
            depths.append(d)
            kids = self._children.get(node, ())
            if ci < len(kids):
                stack.append((node, ci + 1, d))
                stack.append((kids[ci], 0, d + 1))
            # else: node is done; emitting it above was its post-visit.
        # The loop emits one extra trailing entry pattern identical to the
        # reference: each node appears child_count+1 times.
        return (
            np.asarray(tour, dtype=np.int64),
            np.asarray(depths, dtype=np.int64),
            first,
        )

    # ------------------------------------------------------------------ #
    # Ancestor-at-depth table (replaces pointer walks on device)
    # ------------------------------------------------------------------ #

    def ancestor_table(self) -> np.ndarray:
        """``anc[i, d]`` = ancestor of node i at depth d (NONE above the
        node's own depth or for unreachable nodes). Shape
        ``(size, max_depth + 1)``. This is the array form of every tree walk
        in the reference (Tree::new BFS, RTL ancestor loops)."""
        D = self.max_depth + 1
        # int32: ids < 2^31 and every consumer ships int32 to the
        # device — int64 doubled a ~GB-scale allocation at NCBI size
        anc = np.full((self.size, D), NONE, dtype=np.int32)
        anc[self.root, 0] = self.root
        depth = self.depth
        for d in range(1, D):  # level-by-level (root is the only depth-0)
            ids = np.flatnonzero(depth == d)
            if len(ids):
                anc[ids, :d] = anc[self.parent[ids], :d]
                anc[ids, d] = ids
        return anc

    @property
    def anc_table(self) -> np.ndarray:
        """Cached ``ancestor_table`` (built on first use)."""
        if not hasattr(self, "_anc_table"):
            self._anc_table = self.ancestor_table()
        return self._anc_table

    def lineage_rows(self, ids: np.ndarray) -> np.ndarray:
        """Rows of the ancestor-at-depth table for the given taxon ids:
        shape ``(len(ids), max_depth + 1)``, NONE above each node's depth."""
        return self.anc_table[np.asarray(ids, dtype=np.int64)]

    def pairwise_lca(self, a: int, b: int) -> int:
        """Host-side LCA of two reachable nodes."""
        da, db = int(self.depth[a]), int(self.depth[b])
        if da == NONE or db == NONE:
            raise TaxonomyError(f"Unknown Taxon ID: {a if da == NONE else b}")
        while da > db:
            a = int(self.parent[a]); da -= 1
        while db > da:
            b = int(self.parent[b]); db -= 1
        while a != b:
            a = int(self.parent[a])
            b = int(self.parent[b])
        return a


def fixture_taxa() -> list[Taxon]:
    """The 6-taxon test taxonomy shared with the reference's unit tests
    (reference src/fixtures.rs:4-21)."""
    S = ranks.rank_index("superkingdom")
    F = ranks.rank_index("family")
    N = ranks.NO_RANK
    return [
        Taxon(1, "root", N, 1, True),
        Taxon(2, "Bacteria", S, 1, True),
        Taxon(10239, "Viruses", S, 1, True),
        Taxon(12884, "Viroids", S, 1, True),
        Taxon(185751, "Pospiviroidae", F, 12884, True),
        Taxon(185752, "Avsunviroidae", F, 12884, True),
    ]
