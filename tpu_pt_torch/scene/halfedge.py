"""Halfedge mesh: editable connectivity, local edits and Loop subdivision
(numpy): the port's copy of ``tpu_pt/scene/halfedge.py``.

Host-side tooling, never in the render path: subdivide, flip / split /
collapse edges, then hand flat triangle arrays to the renderer.  The storage
is index-based SoA: halfedge h has twin[h], next_[h], vert[h] (origin) and
face[h].
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


class HalfedgeMesh:
    """Triangle-mesh halfedge structure.

    Arrays (H = 3*F halfedges):
      next_  (H,) next halfedge around its face
      twin   (H,) opposite halfedge, -1 on boundary
      vert   (H,) origin vertex index
      face   (H,) face index (= h // 3)
      verts  (V, 3) positions
    """

    def __init__(self, verts: np.ndarray, tris: np.ndarray):
        verts = np.asarray(verts, np.float32)
        tris = np.asarray(tris, np.int64).reshape(-1, 3)
        f = len(tris)
        self.verts = verts.copy()
        self.vert_he = np.full(len(verts), -1, np.int64)  # one outgoing he
        h = np.arange(3 * f)
        self.face = h // 3
        self.next_ = (h // 3) * 3 + (h % 3 + 1) % 3
        self.vert = tris.reshape(-1)
        # twin via edge map (origin, dest)
        dest = self.vert[self.next_]
        edge_map: Dict[Tuple[int, int], int] = {}
        self.twin = np.full(3 * f, -1, np.int64)
        for he in range(3 * f):
            key = (self.vert[he], dest[he])
            rkey = (dest[he], self.vert[he])
            if rkey in edge_map:
                other = edge_map.pop(rkey)
                self.twin[he] = other
                self.twin[other] = he
            else:
                if key in edge_map:
                    raise ValueError("non-manifold edge")
                edge_map[key] = he
        for he in range(3 * f):
            self.vert_he[self.vert[he]] = he

    # ---- queries -------------------------------------------------------
    @property
    def n_faces(self) -> int:
        return len(self.next_) // 3

    @property
    def n_verts(self) -> int:
        return len(self.verts)

    def to_arrays(self):
        """-> (verts (V,3) f32, tris (F,3) i32) for the renderer."""
        tris = self.vert.reshape(-1, 3).astype(np.int32)
        return self.verts.copy(), tris

    def is_boundary_vertex(self, v: int) -> bool:
        for he in self.vertex_halfedges(v):
            if self.twin[he] < 0:
                return True
        return False

    def vertex_halfedges(self, v: int):
        """Outgoing halfedges of v (works on closed fans; boundary fans are
        walked in both directions)."""
        out = []
        start = self.vert_he[v]
        he = start
        # walk clockwise: twin(prev(he))
        while True:
            out.append(he)
            prev = self.next_[self.next_[he]]
            t = self.twin[prev]
            if t < 0:
                break
            he = t
            if he == start:
                return out
        # boundary: also walk counterclockwise from start
        he = self.twin[start]
        while he >= 0:
            he = self.next_[he]
            out.append(he)
            he = self.twin[he]
        return out

    def vertex_neighbors(self, v: int):
        return [int(self.vert[self.next_[he]]) for he in self.vertex_halfedges(v)]

    def vertex_degree(self, v: int) -> int:
        return len(self.vertex_halfedges(v))

    # ---- local edits (reference MeshEdit operations) --------------------
    def flip_edge(self, he: int) -> bool:
        """Flip the edge of halfedge `he` (interior edges only).
        Implements the reference's edge-flip by rebuilding the two incident
        triangles — index-based structures make the rebuild form simpler and
        equally O(1)."""
        t = self.twin[he]
        if t < 0:
            return False
        # quad vertices: a-b edge, c and d opposite
        a = self.vert[he]
        b = self.vert[t]
        c = self.vert[self.next_[self.next_[he]]]
        d = self.vert[self.next_[self.next_[t]]]
        if c == d:
            return False
        f1, f2 = self.face[he], self.face[t]
        self._set_face(f1, (c, d, b))
        self._set_face(f2, (d, c, a))
        self._rebuild_twins_around([f1, f2])
        return True

    def split_edge(self, he: int) -> int:
        """Split the edge at its midpoint; returns the new vertex id.
        Interior edges produce 4 triangles from 2."""
        t = self.twin[he]
        a = self.vert[he]
        b = self.vert[self.next_[he]]
        m = len(self.verts)
        mid = (self.verts[a] + self.verts[b]) * 0.5
        self.verts = np.vstack([self.verts, mid[None]])
        self.vert_he = np.concatenate([self.vert_he, [-1]])
        c = self.vert[self.next_[self.next_[he]]]
        f1 = self.face[he]
        self._set_face(f1, (a, m, c))
        self._append_face((m, b, c))
        faces = [f1, self.n_faces - 1]
        if t >= 0:
            d = self.vert[self.next_[self.next_[t]]]
            f2 = self.face[t]
            self._set_face(f2, (b, m, d))
            self._append_face((m, a, d))
            faces += [f2, self.n_faces - 1]
        self._rebuild_twins_around(faces)
        return m

    def collapse_edge(self, he: int) -> int:
        """Collapse the edge of halfedge ``he`` to its midpoint (the
        reference MeshEdit's edge collapse).  The two incident faces are
        removed and the endpoints merge into the surviving vertex (the
        origin of ``he``), repositioned at the midpoint.

        Returns the surviving vertex id, or -1 (mesh untouched) when the
        collapse is illegal: the link condition requires the endpoints'
        one-rings to share ONLY the vertices opposite the edge, and the
        result must stay a manifold triangle mesh.
        """
        t = self.twin[he]
        a = int(self.vert[he])
        b = int(self.vert[self.next_[he]])
        # Link condition (Dey et al.): shared neighbours == opposite verts.
        na = set(self.vertex_neighbors(a))
        nb = set(self.vertex_neighbors(b))
        allowed = {int(self.vert[self.next_[self.next_[he]]])}
        if t >= 0:
            allowed.add(int(self.vert[self.next_[self.next_[t]]]))
        if (na & nb) != allowed:
            return -1
        dead = {int(self.face[he])} | ({int(self.face[t])} if t >= 0
                                       else set())
        keep = [f for f in range(self.n_faces) if f not in dead]
        tris = self.vert.reshape(-1, 3)[keep]
        tris = np.where(tris == b, a, tris)
        nondegen = ((tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2])
                    & (tris[:, 2] != tris[:, 0]))
        tris = tris[nondegen]
        srt = np.sort(tris, axis=1)
        if len(np.unique(srt, axis=0)) != len(srt):
            return -1  # duplicate faces (e.g. collapsing a tetrahedron edge)
        verts = self.verts.copy()
        verts[a] = (verts[a] + verts[b]) * 0.5
        try:
            rebuilt = HalfedgeMesh(verts, tris)
        except ValueError:
            return -1  # would go non-manifold — reject, leave mesh intact
        self.__dict__.update(rebuilt.__dict__)
        return a

    # ---- helpers ---------------------------------------------------------
    def _set_face(self, f: int, tri):
        self.vert[3 * f:3 * f + 3] = tri

    def _append_face(self, tri):
        f = self.n_faces
        self.vert = np.concatenate([self.vert, np.asarray(tri, np.int64)])
        self.face = np.concatenate([self.face, [f, f, f]])
        base = 3 * f
        self.next_ = np.concatenate(
            [self.next_, [base + 1, base + 2, base]]
        )
        self.twin = np.concatenate([self.twin, [-1, -1, -1]])

    def _rebuild_twins_around(self, faces):
        """Recompute twins globally (simple + correct; local edits are host
        tooling, not hot path)."""
        dest = self.vert[self.next_]
        edge_map: Dict[Tuple[int, int], int] = {}
        self.twin[:] = -1
        for he in range(len(self.vert)):
            rkey = (dest[he], self.vert[he])
            if rkey in edge_map:
                other = edge_map.pop(rkey)
                self.twin[he] = other
                self.twin[other] = he
            else:
                edge_map[(self.vert[he], dest[he])] = he
        for he in range(len(self.vert)):
            self.vert_he[self.vert[he]] = he


def loop_subdivide(verts: np.ndarray, tris: np.ndarray, rounds: int = 1):
    """Loop subdivision (the reference MeshEdit's upsampling), vectorized.

    Returns (verts', tris') with 4^rounds × triangle count.  Boundary edges
    use the 1/2-1/2 midpoint rule; interior edges the 3/8-3/8-1/8-1/8 rule;
    old vertices the Loop beta rule.
    """
    verts = np.asarray(verts, np.float64)
    tris = np.asarray(tris, np.int64).reshape(-1, 3)
    for _ in range(rounds):
        v = len(verts)
        edges = np.concatenate([tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [2, 0]]])
        ek = np.sort(edges, axis=1)
        uniq, inv, counts = np.unique(
            ek, axis=0, return_inverse=True, return_counts=True
        )
        interior = counts == 2
        # Opposite vertices per edge occurrence.
        opp = np.concatenate([tris[:, 2], tris[:, 0], tris[:, 1]])
        opp_sum = np.zeros(len(uniq))
        opp_sum3 = np.zeros((len(uniq), 3))
        np.add.at(opp_sum3, inv, verts[opp])
        # New edge points.
        mid = (verts[uniq[:, 0]] + verts[uniq[:, 1]]) / 2.0
        loop_pt = (3.0 / 8.0) * (verts[uniq[:, 0]] + verts[uniq[:, 1]]) \
            + (1.0 / 8.0) * opp_sum3
        edge_pts = np.where(interior[:, None], loop_pt, mid)
        # Old vertex update.
        deg = np.zeros(v)
        nb_sum = np.zeros((v, 3))
        np.add.at(deg, uniq[:, 0], 1)
        np.add.at(deg, uniq[:, 1], 1)
        np.add.at(nb_sum, uniq[:, 0], verts[uniq[:, 1]])
        np.add.at(nb_sum, uniq[:, 1], verts[uniq[:, 0]])
        n = np.maximum(deg, 3)
        beta = np.where(
            n == 3, 3.0 / 16.0, 3.0 / (8.0 * n)
        )
        has_boundary_edge = np.zeros(v, bool)
        be = uniq[~interior]
        has_boundary_edge[be.reshape(-1)] = True
        new_old = (1 - n * beta)[:, None] * verts + beta[:, None] * nb_sum
        # Boundary vertices: 3/4 self + 1/8 each boundary neighbor.
        bnd_sum = np.zeros((v, 3))
        bnd_deg = np.zeros(v)
        np.add.at(bnd_sum, be[:, 0], verts[be[:, 1]])
        np.add.at(bnd_sum, be[:, 1], verts[be[:, 0]])
        np.add.at(bnd_deg, be[:, 0], 1)
        np.add.at(bnd_deg, be[:, 1], 1)
        bnd_new = 0.75 * verts + 0.125 * bnd_sum
        new_old = np.where(
            (has_boundary_edge & (bnd_deg == 2))[:, None], bnd_new, new_old
        )
        verts = np.concatenate([new_old, edge_pts], axis=0)
        # New topology: each tri → 4.
        e01 = v + inv[0 * len(tris):1 * len(tris)]
        e12 = v + inv[1 * len(tris):2 * len(tris)]
        e20 = v + inv[2 * len(tris):3 * len(tris)]
        a, b, c = tris[:, 0], tris[:, 1], tris[:, 2]
        tris = np.concatenate([
            np.stack([a, e01, e20], 1),
            np.stack([e01, b, e12], 1),
            np.stack([e20, e12, c], 1),
            np.stack([e01, e12, e20], 1),
        ])
    return verts.astype(np.float32), tris.astype(np.int32)
