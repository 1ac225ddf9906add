"""Bulk-loaded spatial index (Sort-Tile-Recursive R-tree).

This package's copy of robosat_tpu/geo/index.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Replaces rtree/libspatialindex (robosat/spatial/core.py:80-100) for the
candidate queries in merge/dedupe. STR packing gives a balanced, read-only
R-tree in O(n log n) build time — a good fit since the pipeline bulk-loads
once and only queries afterwards.
"""

import math


class STRtree:
    """Static R-tree over (minx, miny, maxx, maxy) boxes, bulk-loaded STR-style."""

    def __init__(self, bounds_list, node_capacity=16):
        self._node_capacity = max(node_capacity, 2)
        items = [(box, i) for i, box in enumerate(bounds_list)]
        self._root = self._build(items) if items else None

    def _build(self, items):
        cap = self._node_capacity
        if len(items) <= cap:
            return ("leaf", self._enclosing([b for b, _ in items]), items)

        # STR: sort by center-x, slice into vertical strips, sort each strip
        # by center-y, pack runs of `cap` into leaves; recurse on the nodes.
        n = len(items)
        num_leaves = math.ceil(n / cap)
        num_slices = math.ceil(math.sqrt(num_leaves))
        per_slice = math.ceil(n / num_slices)

        items = sorted(items, key=lambda it: it[0][0] + it[0][2])
        nodes = []
        for s in range(0, n, per_slice):
            strip = sorted(items[s : s + per_slice], key=lambda it: it[0][1] + it[0][3])
            for k in range(0, len(strip), cap):
                chunk = strip[k : k + cap]
                nodes.append(("leaf", self._enclosing([b for b, _ in chunk]), chunk))

        while len(nodes) > 1:
            parents = []
            nodes = sorted(nodes, key=lambda nd: nd[1][0] + nd[1][2])
            m = len(nodes)
            num_parents = math.ceil(m / cap)
            num_slices = math.ceil(math.sqrt(num_parents))
            per_slice = math.ceil(m / num_slices)
            for s in range(0, m, per_slice):
                strip = sorted(nodes[s : s + per_slice], key=lambda nd: nd[1][1] + nd[1][3])
                for k in range(0, len(strip), cap):
                    chunk = strip[k : k + cap]
                    parents.append(("node", self._enclosing([nd[1] for nd in chunk]), chunk))
            nodes = parents
        return nodes[0]

    @staticmethod
    def _enclosing(boxes):
        return (
            min(b[0] for b in boxes),
            min(b[1] for b in boxes),
            max(b[2] for b in boxes),
            max(b[3] for b in boxes),
        )

    @staticmethod
    def _overlaps(a, b):
        return not (a[2] < b[0] or b[2] < a[0] or a[3] < b[1] or b[3] < a[1])

    def intersection(self, box):
        """Yield indices of items whose bounds intersect `box` (closed)."""
        if self._root is None:
            return
        stack = [self._root]
        while stack:
            kind, nb, children = stack.pop()
            if not self._overlaps(nb, box):
                continue
            if kind == "leaf":
                for b, i in children:
                    if self._overlaps(b, box):
                        yield i
            else:
                stack.extend(children)
