"""How far the walks' cull must widen for rays that meet skew faces where
they join: counted on the host through the plain walks, not timed.

    python -m tpu_pt_torch.tools.walk_edges                  # 4,096 rays
    python -m tpu_pt_torch.tools.walk_edges --rays 200000 --need

The scene (:func:`skew_scene`): 10,120 triangles, none in an axis plane (a
50 x 50 height field of jittered quads and an icosphere of subdivision 4,
each turned by its own rotation).  The rays (:func:`edge_rays`): seeded
origins in [-3.5, 3.5)^3 aimed at the faces' shared vertices, at their
shared edges' midpoints and at random points of edges, in thirds.

A ray aimed at an edge can hit a face that it misses by a rounding: the
float32 Möller–Trumbore test accepts the hit (a barycentric of -0), and the
ray passes just outside the leaf box that holds the face.  The box's entry
t then lies beyond the hit's t by about the rounding over the sine of the
angle between the ray and the box's face, which has no bound; the walks'
cull (``kernels/packed_walk.py::widen_up``) covers it up to its width.

Prints one JSON line: for each walk (the packed walk's window and thread
forms, the flat walk's row tables and arrays), the rays whose closest hit
(hit, t; prim, u and v where it hits) differs from the port's brute force
and the rays whose any hit with t_max at brute force's t, and one ulp below
it, differs from brute force's occluded bit; with ``--need``, for every ray
brute force hits, the widening its flat-BVH ancestors need (the largest
``t_near / t - 1`` or ``t_near / t_far - 1`` over the boxes from the root
to the leaf of brute force's nearest primitive): the largest values and
how many rays need more than each power of two from 2^-20 to 2^-8.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

N_TRIS = 10120


def _grid(p0, ex, ey, n):
    """An n x n grid of quads (two triangles each) from corner p0 along
    edges ex, ey: (vertices (V, 3) f64, triangles (T, 3))."""
    p0, ex, ey = (np.asarray(x, np.float64) for x in (p0, ex, ey))
    i, j = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="ij")
    v = p0 + i[..., None] / n * ex + j[..., None] / n * ey
    k = (i * (n + 1) + j)[:-1, :-1].reshape(-1)
    f = np.concatenate([np.stack([k, k + n + 1, k + n + 2], 1),
                        np.stack([k, k + n + 2, k + 1], 1)])
    return v.reshape(-1, 3), f


def _turn(x, seed):
    q, _ = np.linalg.qr(np.random.RandomState(seed).normal(size=(3, 3)))
    return x @ q


def skew_scene(seed: int = 11):
    """The host scene (see the module docstring), seeded."""
    from tpu_pt_torch.scene import meshes
    from tpu_pt_torch.scene.types import make_lights, make_materials, make_scene

    rs = np.random.RandomState(seed)
    v1, f1 = _grid((-2, 0, -2), (4, 0, 0), (0, 0, 4), 50)
    v1[:, 1] = 0.3 * np.sin(2.1 * v1[:, 0]) * np.cos(1.7 * v1[:, 2]) \
        + rs.uniform(-0.02, 0.02, len(v1))
    v1 = _turn(v1, 1) + (0.0, -1.5, 0.0)
    v2, f2 = meshes.icosphere(subdiv=4)
    v2 = _turn(np.asarray(v2, np.float64) * 0.9, 2)
    v = np.concatenate([v1, v2]).astype(np.float32)
    f = np.concatenate([f1, np.asarray(f2) + len(v1)]).astype(np.int32)
    return make_scene(v, f, np.zeros(len(f), np.int32),
                      make_materials([dict(albedo=(0.5,) * 3)]),
                      make_lights([]))


def edge_rays(scene, n: int, seed: int = 12):
    """n seeded rays (ro, rd: float32 (n, 3) numpy) aimed at the scene's
    shared vertices (rays 0, 3, 6, ...), edge midpoints (1, 4, ...) and
    random points of edges (2, 5, ...)."""
    rs = np.random.RandomState(seed)
    v = np.asarray(scene.vertices, np.float64)
    f = np.asarray(scene.tri_idx)
    k = rs.randint(0, len(f), n)
    e = rs.randint(0, 3, n)
    a = v[f[k, e]]
    b = v[f[k, (e + 1) % 3]]
    third = np.arange(n) % 3
    s = np.where(third == 1, 0.5, rs.uniform(0, 1, n))
    at = np.where((third == 0)[:, None], a, a + s[:, None] * (b - a))
    ro = rs.uniform(-3.5, 3.5, (n, 3))
    rd = at.astype(np.float32).astype(np.float64) - ro
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    return ro.astype(np.float32), rd.astype(np.float32)


def brute(scene, ro, rd, t_max=None, any_hit: bool = False, n: int = 500):
    """The port's brute force over chunks of ``n`` rays: the nearest
    ``Hit`` (t in [0, 1e30]) or, with ``any_hit``, the occluded bits under
    ``t_max`` ((R, 1))."""
    from tpu_pt_torch.render import brute as brute_mod

    R = ro.shape[0]
    if any_hit:
        return torch.cat([brute_mod.occluded(scene, ro[i:i + n], rd[i:i + n],
                                             t_max[i:i + n])
                          for i in range(0, R, n)])
    outs = [brute_mod.intersect(scene, ro[i:i + n], rd[i:i + n],
                                torch.zeros((min(n, R - i), 1)),
                                torch.full((min(n, R - i), 1), 1e30))
            for i in range(0, R, n)]
    return brute_mod.Hit(*(torch.cat(x) for x in zip(*outs)))


def walk_forms(scene_h, scene):
    """name -> (closest(ro, rd, t_min, t_max) -> Hit, any_hit(ro, rd, t_max)
    -> occluded) for both forms of each plain walk, on the CPU."""
    from tpu_pt_torch.bvh import flat, native, packed, sah

    pk = native.build_packed(scene_h).to("cpu")
    fb = sah.build_bvh(scene_h).to("cpu")
    rows = flat.row_tables(fb, scene)
    out = {}
    for d in ("window", "thread"):
        out["packed_" + d] = (
            lambda *a, d=d: packed.intersect(pk, scene, *a, design=d),
            lambda ro, rd, t, d=d: packed.occluded(pk, scene, ro, rd, t,
                                                   design=d))
    for name, form in (("rows", rows), ("arrays", None)):
        out["flat_" + name] = (
            lambda *a, form=form: flat.intersect(fb, scene, *a, rows=form),
            lambda ro, rd, t, form=form: flat.occluded(fb, scene, ro, rd, t,
                                                       rows=form))
    return out


def differ(scene_h, ro, rd, h_b=None, walks=("packed", "flat")) -> dict:
    """Per form of each walk in ``walks``: the ids of the rays whose
    closest hit differs from brute force, whose any hit at brute force's t
    differs, and at a ulp below it (three lists)."""
    scene = scene_h.to("cpu")
    ro, rd = torch.from_numpy(ro), torch.from_numpy(rd)
    R = ro.shape[0]
    if h_b is None:
        h_b = brute(scene, ro, rd)
    below = torch.nextafter(h_b.t, torch.zeros_like(h_b.t))
    occ_b = [brute(scene, ro, rd, t, any_hit=True) for t in (h_b.t, below)]
    m = h_b.hit[:, 0]
    out = {}
    for name, (closest, any_hit) in walk_forms(scene_h, scene).items():
        if name.split("_")[0] not in walks:
            continue
        h = closest(ro, rd, torch.zeros((R, 1)), torch.full((R, 1), 1e30))
        bad = (h.hit != h_b.hit)[:, 0] | (h.t != h_b.t)[:, 0] \
            | (m & ((h.prim != h_b.prim) | (h.u != h_b.u)[:, 0]
                    | (h.v != h_b.v)[:, 0]))
        out[name] = [torch.nonzero(bad).flatten().tolist()] + [
            torch.nonzero((any_hit(ro, rd, t) != o)[:, 0]).flatten().tolist()
            for t, o in zip((h_b.t, below), occ_b)]
    return out


def count(scene_h, ro, rd, h_b=None, walks=("packed", "flat")) -> dict:
    """Per form of each walk in ``walks``: [rays whose closest hit differs
    from brute force, rays whose any hit at brute force's t differs, at a
    ulp below it]."""
    return {name: [len(x) for x in ids]
            for name, ids in differ(scene_h, ro, rd, h_b, walks).items()}


def needed_widening(scene_h, ro, rd, h_b) -> np.ndarray:
    """(R,) for every ray brute force hits, the largest of t_near / t - 1
    and t_near / t_far - 1 over the flat BVH's boxes from the root to the
    leaf of its nearest primitive (slab t as the walks compute it): the
    least widening that enters them all; 0 for a miss."""
    from tpu_pt_torch.bvh import sah

    fb = sah.build_bvh(scene_h)
    lo, hi, skip, count_, start, ids = (np.asarray(x) for x in (
        fb.node_min, fb.node_max, fb.skip, fb.prim_count, fb.prim_start,
        fb.prim_ids))
    n_nodes = len(skip)
    leaf_of = np.zeros(scene_h.n_prims, np.int64)
    for nd in np.flatnonzero(count_ > 0):
        leaf_of[ids[start[nd]:start[nd] + count_[nd]]] = nd
    parent = np.full(n_nodes, -1, np.int64)
    open_ = []
    for i in range(n_nodes):                       # preorder: i's parent is
        while open_ and not i < skip[open_[-1]]:   # the last inner node open
            open_.pop()
        parent[i] = open_[-1] if open_ else -1
        if count_[i] == 0:
            open_.append(i)
    with np.errstate(divide="ignore", invalid="ignore"):
        inv = (np.float32(1) / rd).astype(np.float32)
        hit = h_b.hit.numpy()[:, 0]
        t = h_b.t.numpy()[:, 0]
        prim = h_b.prim.numpy()
        need = np.zeros(ro.shape[0])
        for r in np.flatnonzero(hit):
            nd, worst = leaf_of[prim[r]], 0.0
            while nd >= 0:
                a = (lo[nd] - ro[r]) * inv[r]
                b = (hi[nd] - ro[r]) * inv[r]
                t_near = max(float(np.nan_to_num(np.minimum(a, b),
                                                 nan=-np.inf).max()), 0.0)
                t_far = float(np.nan_to_num(np.maximum(a, b),
                                            nan=np.inf).min())
                worst = max(worst, t_near / t[r] - 1,
                            t_near / t_far - 1 if t_far > 0 else 0.0)
                nd = parent[nd]
            need[r] = worst
    return need


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--rays", type=int, default=4096)
    p.add_argument("--need", action="store_true",
                   help="also the widening each ray needs")
    args = p.parse_args(argv)
    scene_h = skew_scene()
    ro, rd = edge_rays(scene_h, args.rays)
    h_b = brute(scene_h.to("cpu"), torch.from_numpy(ro), torch.from_numpy(rd))
    line = {"tool": "walk_edges", "tris": scene_h.n_tris, "rays": args.rays,
            "hits": int(h_b.hit.sum()),
            "widen_up": f"2^{int(np.log2(_width()))}",
            "differ_closest_anyhit_at_t_below": count(scene_h, ro, rd, h_b)}
    if args.need:
        need = needed_widening(scene_h, ro, rd, h_b)
        line["need_largest"] = [float(x) for x in np.sort(need)[::-1][:10]]
        line["rays_needing_more_than"] = {
            f"2^-{e}": int((need > 2.0 ** -e).sum())
            for e in range(20, 7, -2)}
    print(json.dumps(line), flush=True)


def _width() -> float:
    from tpu_pt_torch.kernels import packed_walk

    return packed_walk._WIDEN_UP - 1.0


if __name__ == "__main__":
    main()
