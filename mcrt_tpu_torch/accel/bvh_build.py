"""BVH construction (host-side): binned SAH -> flat DFS skip-link layout.

Capability parity with the reference's three builders (reference source/bvh/
bvh.cpp: octree :131-163, binary SAH :165-288, quaternary SAH :290-426), re-designed
for a vector machine: instead of the reference's per-ray priority-queue best-first
traversal (bvh.cpp:80-129, pointer-ish LinearNode array), we emit a depth-first node
array with *skip links* so traversal is a branch-free lockstep walk — each ray holds
one node index; descend on AABB hit (child = node+1), otherwise jump to the skip
node. Leaf primitives are reordered contiguous and processed with a fixed-width
masked inner loop.

Builders: "binary_sah" (binned, default), "quaternary_sah" (binary collapsed two
levels — same SAH quality family, wider nodes), "octree" (median-split by centroid
octants, the reference's fast builder), "median" (spatial median, for tests).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlatBVH:
    """DFS-ordered nodes with skip links over reordered primitives."""
    bb_min: np.ndarray       # (N, 3) f32/f64
    bb_max: np.ndarray       # (N, 3)
    first: np.ndarray        # (N,) int32: leaf -> first primitive; internal -> unused
    count: np.ndarray        # (N,) int32: leaf primitive count; 0 -> internal
    skip: np.ndarray         # (N,) int32: next DFS node when skipping this subtree
    prim_order: np.ndarray   # (P,) int32: new->old primitive index mapping
    max_leaf: int


class _Node:
    __slots__ = ("bb_min", "bb_max", "prims", "children", "_child_idx")

    def __init__(self, bb_min, bb_max, prims=None, children=None):
        self.bb_min = bb_min
        self.bb_max = bb_max
        self.prims = prims          # leaf: array of primitive ids
        self.children = children    # internal: list of _Node


def _bounds(mins, maxs, ids):
    return mins[ids].min(axis=0), maxs[ids].max(axis=0)


def _sah_split_binary(ids, mins, maxs, centers, bins):
    """Best binned-SAH split. Returns (axis_ids_left, axis_ids_right) or None if the
    SAH prefers a leaf. Cost model matches bvh.cpp: leaf = N, split = 1 + sum(A_i/A * N_i)."""
    n = len(ids)
    cb_min = centers[ids].min(axis=0)
    cb_max = centers[ids].max(axis=0)
    extent = cb_max - cb_min
    axis = int(np.argmax(extent))
    if extent[axis] <= 0.0:
        return None
    b_min, b_max = _bounds(mins, maxs, ids)
    whole = b_max - b_min
    area_whole = 2.0 * (whole[0] * whole[1] + whole[1] * whole[2] + whole[0] * whole[2])
    if area_whole <= 0.0:
        return None

    rel = (centers[ids][:, axis] - cb_min[axis]) / extent[axis]
    bin_idx = np.minimum((rel * bins).astype(np.int64), bins - 1)

    best_cost = float(n)  # leaf cost
    best = None
    for b in range(1, bins):
        left = bin_idx < b
        nl = int(left.sum())
        nr = n - nl
        if nl == 0 or nr == 0:
            continue
        l_ids = ids[left]
        r_ids = ids[~left]
        lmin, lmax = _bounds(mins, maxs, l_ids)
        rmin, rmax = _bounds(mins, maxs, r_ids)
        le = lmax - lmin
        re = rmax - rmin
        la = 2.0 * (le[0] * le[1] + le[1] * le[2] + le[0] * le[2])
        ra = 2.0 * (re[0] * re[1] + re[1] * re[2] + re[0] * re[2])
        cost = 1.0 + (la * nl + ra * nr) / area_whole
        if cost < best_cost:
            best_cost = cost
            best = (l_ids, r_ids)
    return best


def _build_recursive(ids, mins, maxs, centers, max_leaf, bins, force_leaf_limit=255):
    bb_min, bb_max = _bounds(mins, maxs, ids)
    n = len(ids)
    if n <= max_leaf:
        return _Node(bb_min, bb_max, prims=ids)
    split = _sah_split_binary(ids, mins, maxs, centers, bins)
    if split is None:
        if n > force_leaf_limit:
            # SAH refused but the leaf is too big: arbitrary round-robin split
            # (reference arbitrarySplit, bvh.cpp:451-473)
            half = n // 2
            split = (ids[:half], ids[half:])
        else:
            return _Node(bb_min, bb_max, prims=ids)
    l, r = split
    return _Node(
        bb_min, bb_max,
        children=[
            _build_recursive(l, mins, maxs, centers, max_leaf, bins, force_leaf_limit),
            _build_recursive(r, mins, maxs, centers, max_leaf, bins, force_leaf_limit),
        ],
    )


def _build_octree_style(ids, mins, maxs, centers, max_leaf):
    """Centroid-octant recursive split (the reference's fast 'octree' builder)."""
    bb_min, bb_max = _bounds(mins, maxs, ids)
    if len(ids) <= max_leaf:
        return _Node(bb_min, bb_max, prims=ids)
    mid = (centers[ids].min(axis=0) + centers[ids].max(axis=0)) * 0.5
    children = []
    for octant in range(8):
        mask = np.ones(len(ids), bool)
        for a in range(3):
            side = (octant >> a) & 1
            mask &= (centers[ids][:, a] >= mid[a]) if side else (centers[ids][:, a] < mid[a])
        sub = ids[mask]
        if len(sub):
            children.append(sub)
    if len(children) <= 1:
        half = len(ids) // 2
        children = [ids[:half], ids[half:]] if half else [ids]
    if len(children) == 1:
        return _Node(bb_min, bb_max, prims=ids)
    return _Node(
        bb_min, bb_max,
        children=[_build_octree_style(c, mins, maxs, centers, max_leaf) for c in children],
    )


def _collapse_to_quaternary(node: _Node) -> _Node:
    """Collapse a binary tree two levels at a time -> up to 4 children per node."""
    if node.prims is not None:
        return node
    grand = []
    for c in node.children:
        if c.prims is not None:
            grand.append(c)
        else:
            grand.extend(c.children)
    node.children = [_collapse_to_quaternary(c) for c in grand]
    return node


def _flatten(root: _Node, dtype) -> FlatBVH:
    # Two-pass flatten: first assign DFS indices, then fill nodes + skip links
    # (child k's skip = child k+1's index; last child inherits the parent's skip).
    def dfs(nd):
        i = len(order)
        order.append(nd)
        if nd.prims is None:
            child_idx = [dfs(c) for c in nd.children]
            nd._child_idx = child_idx  # type: ignore[attr-defined]
        return i

    order = []
    dfs(root)
    total = len(order)
    bb_min = np.zeros((total, 3), dtype)
    bb_max = np.zeros((total, 3), dtype)
    first = np.zeros(total, np.int32)
    count = np.zeros(total, np.int32)
    skip = np.full(total, total, np.int32)
    prim_order = []

    def fill(nd, i, skip_to):
        bb_min[i] = nd.bb_min
        bb_max[i] = nd.bb_max
        skip[i] = skip_to
        if nd.prims is None:
            ci = nd._child_idx  # type: ignore[attr-defined]
            for k in range(len(ci)):
                nxt = ci[k + 1] if k + 1 < len(ci) else skip_to
                fill(nd.children[k], ci[k], nxt)
        else:
            first[i] = len(prim_order)
            count[i] = len(nd.prims)
            prim_order.extend(nd.prims.tolist())

    fill(root, 0, total)
    max_leaf = int(count.max()) if total else 0
    return FlatBVH(
        bb_min=bb_min, bb_max=bb_max, first=first, count=count, skip=skip,
        prim_order=np.asarray(prim_order, np.int32), max_leaf=max_leaf,
    )


def build_bvh(
    tri_min: np.ndarray,
    tri_max: np.ndarray,
    kind: str = "binary_sah",
    bins: int = 16,
    max_leaf: int = 8,
    dtype=np.float32,
    strict_leaf: bool = False,
) -> FlatBVH:
    """Build a flat BVH over primitive AABBs (tri_min/tri_max: (P,3)).

    strict_leaf=True forces splits until every leaf has <= max_leaf primitives
    (needed for fixed-size cluster leaves); otherwise SAH may stop early up to 255
    per leaf like the reference."""
    from ..native import build_bvh_native

    native = build_bvh_native(
        tri_min, tri_max, kind=kind, bins=bins, max_leaf=max_leaf,
        dtype=dtype, strict_leaf=strict_leaf,
    )
    if native is not None:
        return native

    P = len(tri_min)
    ids = np.arange(P, dtype=np.int64)
    centers = (tri_min + tri_max) * 0.5
    import sys

    limit = max_leaf if strict_leaf else 255
    old_limit = sys.getrecursionlimit()
    sys.setrecursionlimit(max(old_limit, 100000))
    try:
        if kind == "octree":
            root = _build_octree_style(ids, tri_min, tri_max, centers, max_leaf)
        else:
            root = _build_recursive(ids, tri_min, tri_max, centers, max_leaf, bins, limit)
            if kind == "quaternary_sah":
                root = _collapse_to_quaternary(root)
        flat = _flatten(root, dtype)
    finally:
        sys.setrecursionlimit(old_limit)
    return flat
