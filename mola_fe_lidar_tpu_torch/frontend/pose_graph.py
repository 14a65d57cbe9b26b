"""Local pose graph with Dijkstra pose estimation (E10).

Rebuild of the ``mrpt::graphs::CNetworkOfPoses3D`` surface the reference
uses for its keyframe mirror: ``insertEdgeAtEnd`` (reference
src/LidarOdometry.cpp:461-463), ``dijkstra_nodes_estimate`` with
topological distances (:528-551), adjacency queries for pruning (:555-569),
and root bookkeeping.

Host code — the graph holds O(keyframes) entries and is walked once per
scan; it is bookkeeping, not FLOPs (SURVEY.md §3.2 notes all hot loops live
in the device engine). Poses are stored as numpy (R, t) pairs so no device
traffic is involved. :func:`make_pose_graph` returns the C++ graph
(``native/``) where ``g++`` builds it, as the reference does, and this
pure-Python one (the same surface) elsewhere.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Dict, List, Optional, Set, Tuple

import numpy as np


def make_pose_graph(prefer_native: bool = True):
    """The C++-backed graph when the native runtime builds (at the first
    call), else the pure-Python one (identical surface)."""
    if prefer_native:
        from ..native import NATIVE_AVAILABLE, NativePoseGraph

        if NATIVE_AVAILABLE:
            return NativePoseGraph()
    return PoseGraph()


@dataclass
class _Edge:
    a: int
    b: int
    R: np.ndarray  # pose of b in frame a
    t: np.ndarray


def _compose(Ra, ta, Rb, tb):
    return Ra @ Rb, Ra @ tb + ta


def _invert(R, t):
    Rt = R.T
    return Rt, -Rt @ t


class PoseGraph:
    """Undirected graph of keyframes with SE(3) edge constraints."""

    def __init__(self):
        self.nodes: Set[int] = set()
        self.edges: List[_Edge] = []
        self._adj: Dict[int, List[int]] = {}  # node -> edge indices
        self.root: Optional[int] = None

    def __len__(self):
        return len(self.nodes)

    def insert_node(self, node: int) -> None:
        if node not in self.nodes:
            self.nodes.add(node)
            self._adj.setdefault(node, [])
            if self.root is None:
                self.root = node

    def insert_edge(self, a: int, b: int, R: np.ndarray, t: np.ndarray) -> None:
        """Add edge with pose of ``b`` expressed in frame ``a``
        (insertEdgeAtEnd analogue)."""
        self.insert_node(a)
        self.insert_node(b)
        e = _Edge(a, b, np.asarray(R, np.float64), np.asarray(t, np.float64))
        idx = len(self.edges)
        self.edges.append(e)
        self._adj[a].append(idx)
        self._adj[b].append(idx)

    def has_edge(self, a: int, b: int) -> bool:
        # scan only a's incident edges (the adjacency index exists; a full
        # O(E) scan ran per candidate per scan under the module state lock)
        return any(
            self.edges[i].a == b or self.edges[i].b == b
            for i in self._adj.get(a, ())
        )

    def neighbors(self, node: int) -> Set[int]:
        out = set()
        for idx in self._adj.get(node, []):
            e = self.edges[idx]
            out.add(e.b if e.a == node else e.a)
        return out

    def dijkstra_nodes_estimate(
        self, source: Optional[int] = None
    ) -> Tuple[Dict[int, Tuple[np.ndarray, np.ndarray]], Dict[int, int]]:
        """Estimate every reachable node's pose in the source frame by
        composing edges along the shortest (euclidean edge length) path.

        Returns (poses {node: (R, t)}, topological_distances {node: hops})
        — the reference's ``dijkstra_nodes_estimate(topological_dists&)``
        pair (src/LidarOdometry.cpp:528-551).
        """
        src = source if source is not None else self.root
        if src is None or src not in self.nodes:
            return {}, {}
        dist: Dict[int, float] = {src: 0.0}
        topo: Dict[int, int] = {src: 0}
        poses: Dict[int, Tuple[np.ndarray, np.ndarray]] = {
            src: (np.eye(3), np.zeros(3))
        }
        heap = [(0.0, src)]
        visited: Set[int] = set()
        while heap:
            d, u = heapq.heappop(heap)
            if u in visited:
                continue
            visited.add(u)
            Ru, tu = poses[u]
            for idx in self._adj.get(u, []):
                e = self.edges[idx]
                v = e.b if e.a == u else e.a
                if v in visited:
                    continue
                if e.a == u:
                    Rv, tv = _compose(Ru, tu, e.R, e.t)
                else:
                    Ri, ti = _invert(e.R, e.t)
                    Rv, tv = _compose(Ru, tu, Ri, ti)
                w = float(np.linalg.norm(e.t))
                nd = d + w
                if v not in dist or nd < dist[v]:
                    dist[v] = nd
                    topo[v] = topo[u] + 1
                    poses[v] = (Rv, tv)
                    heapq.heappush(heap, (nd, v))
        return poses, topo

    def remove_node(self, node: int) -> None:
        """Drop a node and its edges (graph pruning,
        reference src/LidarOdometry.cpp:557-569)."""
        if node not in self.nodes:
            return
        self.nodes.discard(node)
        keep = [e for e in self.edges if e.a != node and e.b != node]
        self.edges = keep
        self._adj = {}
        for i, e in enumerate(self.edges):
            self._adj.setdefault(e.a, []).append(i)
            self._adj.setdefault(e.b, []).append(i)
        for n in self.nodes:
            self._adj.setdefault(n, [])
        if self.root == node:
            self.root = min(self.nodes) if self.nodes else None
