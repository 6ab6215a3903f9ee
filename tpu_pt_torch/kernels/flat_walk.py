"""The flat BVH walk: every ray walks the skip-pointer node array of a flat
SAH BVH (``bvh/sah.py::FlatBVH``) alone, stackless, and tests the
primitives of the leaves whose box it enters, from the scene's own arrays.

Counterpart of ``tpu_pt/bvh/flat.py::intersect`` / ``::occluded``, which are
not Pallas kernels: XLA compiles their ``lax.while_loop`` over the batch, in
lockstep, into one program.  In eager PyTorch that loop costs about a
hundred launches and one host read per iteration, and a batch runs as long
as its longest ray.  ``flat_walk`` therefore launches a hand-written CUDA
kernel (``csrc/flat_walk.cu``): one thread per ray, the loop inside the
thread, no host in the loop.  ``flat_walk_ref`` is the plain version: the
lockstep loop written out column by column, in the kernel's order of
operations, so that the two agree bit for bit.  ``flat_walk`` runs it for
CPU tensors; for CUDA tensors it launches the kernel or raises.

The walk: a node whose box the ray enters within [t_min, best t] is
descended into (``cursor + 1``) unless it is a leaf; otherwise, and after a
leaf, the walk goes to ``skip``.  A leaf tests its first
``min(count, max_leaf)`` primitives.  A primitive takes over when it hits
nearer, or as near with a lower primitive id while best t is below 1e30;
the best id starts at 0.  The any-hit form stops at its first hit.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import _build
from tpu_pt_torch.kernels.packed_walk import _prim_row_test


def _prim_test(tri_idx, vertices, sph_center, sph_radius, prim, active, ro,
               rd, t_min, t_max):
    """Test each ray against its primitive ``prim`` (R,) of the scene
    arrays: triangle or sphere by id range.  active: (R, 1) bool; t bounds
    (R, 1).  Returns (hit (R, 1), t (INF where not hit), u, v (0 on
    spheres)).  The primitive is made into ``bvh/packed.py``'s 16-wide row
    (triangle [v0, v1 - v0, v2 - v0, 0 (type)], sphere [centre, r, ..., 1
    (type)]; the edges round once, as the kernel's and the host builders'
    do) and tested by the packed walk's row test, ``prim_hit``'s order."""
    n_tris = tri_idx.shape[0]
    n_sph = sph_center.shape[0]
    row = torch.zeros((prim.shape[0], 16), dtype=torch.float32,
                      device=prim.device)
    is_tri = prim < n_tris
    if n_tris > 0:
        tid = torch.clamp(torch.where(is_tri, prim, 0), 0, n_tris - 1).long()
        idx = tri_idx[tid].long()
        v0 = vertices[idx[:, 0]]
        t_row = torch.cat([v0, vertices[idx[:, 1]] - v0,
                           vertices[idx[:, 2]] - v0], dim=1)
        row[:, 0:9] = torch.where(is_tri[:, None], t_row, row[:, 0:9])
    if n_sph > 0:
        sid = torch.clamp(torch.where(is_tri, 0, prim - n_tris), 0,
                          n_sph - 1).long()
        s_row = torch.cat([sph_center[sid], sph_radius[sid][:, None]], dim=1)
        row[:, 0:4] = torch.where(is_tri[:, None], row[:, 0:4], s_row)
    row[:, 10] = (~is_tri).to(torch.float32)
    return _prim_row_test(row, active, ro, rd, t_min, t_max)


_ARRAYS = ("node_min", "node_max", "skip", "prim_start", "prim_count",
           "prim_ids", "tri_idx", "vertices", "sph_center", "sph_radius",
           "ro", "rd", "t_min", "t_max")
_DTYPES = dict(node_min=torch.float32, node_max=torch.float32,
               skip=torch.int32, prim_start=torch.int32,
               prim_count=torch.int32, prim_ids=torch.int32,
               tri_idx=torch.int32, vertices=torch.float32,
               sph_center=torch.float32, sph_radius=torch.float32,
               ro=torch.float32, rd=torch.float32, t_min=torch.float32,
               t_max=torch.float32)


def _check(max_leaf, **a):
    _build.refuse_grad("flat_walk", **a)
    N = a["skip"].shape[0]
    R = a["ro"].shape[0]
    T = a["tri_idx"].shape[0]
    S = a["sph_center"].shape[0]
    shapes = dict(node_min=(N, 3), node_max=(N, 3), skip=(N,),
                  prim_start=(N,), prim_count=(N,),
                  prim_ids=(a["prim_ids"].shape[0],), tri_idx=(T, 3),
                  vertices=(a["vertices"].shape[0], 3), sph_center=(S, 3),
                  sph_radius=(S,), ro=(R, 3), rd=(R, 3), t_min=(R,),
                  t_max=(R,))
    for name in _ARRAYS:
        x = a[name]
        if tuple(x.shape) != shapes[name]:
            raise ValueError(f"{name}: expected {shapes[name]}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != _DTYPES[name]:
            raise TypeError(f"{name}: expected {_DTYPES[name]}, got "
                            f"{x.dtype}")
        if x.device != a["ro"].device:
            raise ValueError("flat_walk: tensors on different devices")
    if N < 1 or a["prim_ids"].shape[0] < 1 or max_leaf < 1:
        raise ValueError(f"flat_walk: needs nodes and primitives, got "
                         f"{N} nodes, {a['prim_ids'].shape[0]} primitive "
                         f"ids, max_leaf {max_leaf}")


def flat_walk_ref(node_min, node_max, skip, prim_start, prim_count, prim_ids,
                  tri_idx, vertices, sph_center, sph_radius, ro, rd, t_min,
                  t_max, max_leaf: int, any_hit: bool = False,
                  stats: dict | None = None):
    """Plain PyTorch version of :func:`flat_walk`: the lockstep walk of
    ``tpu_pt/bvh/flat.py``, one iteration per node step of every ray still
    walking, until none is.

    stats: when a dict is passed, it receives ``iterations`` (lockstep
    iterations run), ``steps`` ((R,) nodes each ray fetched),
    ``prims_tri`` / ``prims_sph`` (triangles / spheres tested, counted as
    the kernel tests them: the any-hit form stops at its first hit) and
    ``node_seen`` / ``prim_seen`` ((N,) / (T + S,) bool: the nodes any ray
    fetched, the primitives any ray tested)."""
    _check(max_leaf, node_min=node_min, node_max=node_max, skip=skip,
           prim_start=prim_start, prim_count=prim_count, prim_ids=prim_ids,
           tri_idx=tri_idx, vertices=vertices, sph_center=sph_center,
           sph_radius=sph_radius, ro=ro, rd=rd, t_min=t_min, t_max=t_max)
    R = ro.shape[0]
    dev = ro.device
    n = skip.shape[0]
    n_prims = prim_ids.shape[0]
    n_tris = tri_idx.shape[0]
    t_min = t_min[:, None]
    rd_inv = 1.0 / rd
    ox, oy, oz = ro[:, 0:1], ro[:, 1:2], ro[:, 2:3]
    ix, iy, iz = rd_inv[:, 0:1], rd_inv[:, 1:2], rd_inv[:, 2:3]
    ninf = torch.full((), -float("inf"), device=dev)
    pinf = torch.full((), float("inf"), device=dev)

    cursor = torch.zeros((R,), dtype=torch.int64, device=dev)
    best_t = t_max[:, None].clone()
    best_g = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_u = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    occ = torch.zeros((R, 1), dtype=torch.bool, device=dev)
    steps = torch.zeros((R,), dtype=torch.int64, device=dev)
    prims_tri = prims_sph = 0
    if stats is not None:
        node_seen = torch.zeros((n,), dtype=torch.bool, device=dev)
        prim_seen = torch.zeros((n_tris + sph_center.shape[0],),
                                dtype=torch.bool, device=dev)
    iterations = 0
    while bool(torch.any(cursor < n)):
        iterations += 1
        active = (cursor < n) & ~occ[:, 0]
        steps += active
        node = torch.where(active, cursor, 0)
        if stats is not None:
            node_seen[cursor[active]] = True
        bmin = node_min[node]
        bmax = node_max[node]

        def axis(lo, hi):
            near = torch.minimum(lo, hi)
            far = torch.maximum(lo, hi)
            return (torch.where(torch.isnan(near), ninf, near),
                    torch.where(torch.isnan(far), pinf, far))

        nx, fx = axis((bmin[:, 0:1] - ox) * ix, (bmax[:, 0:1] - ox) * ix)
        ny, fy = axis((bmin[:, 1:2] - oy) * iy, (bmax[:, 1:2] - oy) * iy)
        nz, fz = axis((bmin[:, 2:3] - oz) * iz, (bmax[:, 2:3] - oz) * iz)
        t_near = torch.maximum(
            torch.maximum(torch.maximum(nx, ny), nz), t_min)
        t_far = torch.minimum(
            torch.minimum(torch.minimum(fx, fy), fz), best_t)
        hit_bb = (t_near <= t_far)[:, 0] & active

        count = prim_count[node]
        is_leaf = count > 0
        start = prim_start[node].long()
        test_leaf = hit_bb & is_leaf
        for k in range(max_leaf):
            in_rng = test_leaf & (k < count)
            slot = torch.clamp(start + k, 0, n_prims - 1)
            g = prim_ids[slot]
            if stats is not None:
                tested = in_rng & ~occ[:, 0] if any_hit else in_rng
                tri = g < n_tris
                prims_tri += int(torch.sum(tested & tri))
                prims_sph += int(torch.sum(tested & ~tri))
                prim_seen[g[tested].long()] = True
            h, t, u, v = _prim_test(tri_idx, vertices, sph_center,
                                    sph_radius, g, in_rng[:, None], ro, rd,
                                    t_min, best_t)
            if any_hit:
                occ = occ | h
                continue
            closer = h & ((t < best_t)
                          | ((t == best_t) & (t < INF)
                             & (g < best_g)[:, None]))
            best_g = torch.where(closer[:, 0], g, best_g)
            best_u = torch.where(closer, u, best_u)
            best_v = torch.where(closer, v, best_v)
            best_t = torch.where(closer, t, best_t)

        descend = hit_bb & ~is_leaf
        nxt = torch.where(descend, cursor + 1, skip[node].long())
        cursor = torch.where(active, nxt, torch.full_like(nxt, n))
    if stats is not None:
        stats.update(iterations=iterations, steps=steps, prims_tri=prims_tri,
                     prims_sph=prims_sph, node_seen=node_seen,
                     prim_seen=prim_seen)
    if any_hit:
        return occ[:, 0]
    return best_t[:, 0], best_g, best_u[:, 0], best_v[:, 0]


def flat_walk(node_min, node_max, skip, prim_start, prim_count, prim_ids,
              tri_idx, vertices, sph_center, sph_radius, ro, rd, t_min, t_max,
              max_leaf: int, any_hit: bool = False):
    """A flat BVH's arrays (``FlatBVH`` fields) and a scene's primitive
    arrays; ro, rd: (R, 3) f32; t_min, t_max: (R,) f32.  A ray whose
    ``t_max < t_min`` leaves at the root.

    Returns (t (R,) f32, prim (R,) i32, u, v): ``t`` is the nearest hit's
    distance, ``t_max`` where nothing hit nearer than that (the caller
    decides ``found = t < t_max``), with the winner's primitive id (0 where
    nothing hit) and barycentrics (0 on spheres).  With ``any_hit`` returns
    (R,) bool: a primitive hit within [t_min, t_max].

    CUDA tensors go to the kernel (or raise); CPU tensors to the plain
    version."""
    a = dict(node_min=node_min, node_max=node_max, skip=skip,
             prim_start=prim_start, prim_count=prim_count, prim_ids=prim_ids,
             tri_idx=tri_idx, vertices=vertices, sph_center=sph_center,
             sph_radius=sph_radius, ro=ro, rd=rd, t_min=t_min, t_max=t_max)
    if not ro.is_cuda:
        return flat_walk_ref(**a, max_leaf=max_leaf, any_hit=any_hit)
    _check(max_leaf, **a)
    for name in _ARRAYS:
        _build.check_cuda_input(name, a[name], _DTYPES[name])
    R = ro.shape[0]
    dev = ro.device
    if any_hit:
        occ = torch.empty((R,), dtype=torch.bool, device=dev)
        outs = (0, 0, 0, 0, occ.data_ptr())
    else:
        out_t = torch.empty((R,), dtype=torch.float32, device=dev)
        out_g = torch.empty((R,), dtype=torch.int32, device=dev)
        out_u = torch.empty_like(out_t)
        out_v = torch.empty_like(out_t)
        outs = (out_t.data_ptr(), out_g.data_ptr(), out_u.data_ptr(),
                out_v.data_ptr(), 0)
    if R > 0:
        err = _build.load().flat_walk_launch(
            *(a[name].data_ptr() for name in _ARRAYS), *outs, R,
            skip.shape[0], prim_ids.shape[0], tri_idx.shape[0],
            sph_center.shape[0], int(max_leaf), int(bool(any_hit)),
            torch.cuda.current_stream(dev).cuda_stream)
        flat_walk.launches += 1
        if err != 0:
            raise RuntimeError(f"flat_walk: CUDA launch error {err}")
    return occ if any_hit else (out_t, out_g, out_u, out_v)


flat_walk.launches = 0   # kernel launches made by this process
