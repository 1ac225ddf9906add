"""Connected components over an undirected graph.

This package's copy of robosat_tpu/graph/core.py: the same code over the port's
own modules, held to the original by tests/test_torch_port_geo.py.

Same external contract as the reference's adjacency-set graph
(robosat/graph/core.py:16-104: add_edge/targets/vertices/components) but
implemented as a union-find (disjoint-set) forest with path compression and
union by size, which computes components in near-O(alpha) per edge instead of
a DFS sweep over adjacency sets — the merge tool's component pass over large
feature collections is the consumer (robosat/tools/merge.py:47-58).
"""

import collections


class UndirectedGraph:
    """Undirected graph tracking edges and connected components.

    Note: stores edges; cannot store vertices without edges (same caveat as
    the reference). Self-edges `add_edge(v, v)` register the vertex.
    """

    def __init__(self):
        self._parent = {}
        self._size = {}
        self._targets = collections.defaultdict(set)

    def _find(self, v):
        root = v
        while self._parent[root] != root:
            root = self._parent[root]
        while self._parent[v] != root:
            self._parent[v], v = root, self._parent[v]
        return root

    def _add_vertex(self, v):
        if v not in self._parent:
            self._parent[v] = v
            self._size[v] = 1

    def add_edge(self, s, t):
        """Add an undirected edge between s and t."""
        self._add_vertex(s)
        self._add_vertex(t)
        self._targets[s].add(t)
        self._targets[t].add(s)
        rs, rt = self._find(s), self._find(t)
        if rs == rt:
            return
        if self._size[rs] < self._size[rt]:
            rs, rt = rt, rs
        self._parent[rt] = rs
        self._size[rs] += self._size[rt]

    def targets(self, v):
        """All neighbors of vertex v."""
        return self._targets[v]

    def vertices(self):
        """All vertices in the graph."""
        return self._parent.keys()

    def empty(self):
        return not self._parent

    def components(self):
        """Yield connected components as sets of vertices (unordered)."""
        groups = collections.defaultdict(set)
        for v in self._parent:
            groups[self._find(v)].add(v)
        yield from groups.values()
