"""The flat BVH walk: every ray walks the skip-pointer node array of a flat
SAH BVH (``bvh/sah.py::FlatBVH``) alone, stackless, and tests the
primitives of the leaves whose box it enters.

Counterpart of ``tpu_pt/bvh/flat.py::intersect`` / ``::occluded``, which are
not Pallas kernels: XLA compiles their ``lax.while_loop`` over the batch, in
lockstep, into one program.  In eager PyTorch that loop costs about a
hundred launches and one host read per iteration, and a batch runs as long
as its longest ray.  ``flat_walk`` therefore launches a hand-written CUDA
kernel (``csrc/flat_walk.cu``): one thread per ray, the loop inside the
thread, no host in the loop, in one of two designs that give the same bits:

- ``"rows"`` (the default): the walk reads row tables built once per
  (BVH, scene) by ``bvh/flat.py::row_tables`` (:class:`FlatRows`): a node
  is one 32-byte row, a leaf's primitives are adjacent 64-byte rows that
  the thread loads two at a time (so that the kernel fits 64 registers and
  a whole batch of rays is resident at once): a ray a lane, where a batch
  holds more rays than the SMs hold lanes each lane taking a new ray when
  its walk ends.
- ``"thread"`` (the first design, kept as its tested twin): the walk reads
  the BVH's and the scene's own arrays, a node nine scalar loads, a
  primitive three round trips in a row.

``flat_walk_ref`` is the plain version: the lockstep loop written out
column by column, in the kernel's order of operations, so that the kernels
agree with it bit for bit; it reads the row tables where it is given them
and the arrays otherwise.  ``flat_walk`` runs it for CPU tensors, whatever
the design; for CUDA tensors it launches the kernel of the design asked for
or raises.

The walk: a node whose box the ray enters within [t_min, best t] (held
conservatively, as the packed walk holds it: the slab entry against
``packed_walk.widen_up`` of min(slab exit, best t)) is
descended into (``cursor + 1``) unless it is a leaf; otherwise, and after a
leaf, the walk goes to ``skip`` (``cursor + 1`` after a leaf in these
tables).  A leaf tests its first ``min(count, max_leaf)`` primitives.  A
primitive takes over when it hits nearer, or as near with a lower
primitive id while best t is below 1e30; the best id starts at 0.  The
any-hit form stops at its first hit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from tpu_pt_torch.core.intersect import INF
from tpu_pt_torch.kernels import _build
from tpu_pt_torch.kernels.packed_walk import _prim_row_test, widen_up

DESIGNS = ("rows", "thread")


class FlatRows(NamedTuple):
    """The row walk's tables of one (FlatBVH, scene), from
    ``bvh/flat.py::row_tables``.

    node_rows: (N, 8) f32, node i as [min.xyz, max.xyz, link, count], link
      and count as int32 bit patterns; link is ``skip`` for an inner node
      and ``prim_start`` for a leaf (whose skip is i + 1).
    prim_rows: (P, 16) f32, ``bvh/packed.py``'s primitive row of the
      primitive in each slot of ``prim_ids``: triangle [v0, v1 - v0,
      v2 - v0, material bits, 0 (type), pad], sphere [centre, r, 0 0, 0 0
      0, material bits, 1 (type), pad].
    prim_gid: (P,) i32, the primitive id of each slot (``prim_ids``)."""

    node_rows: object
    prim_rows: object
    prim_gid: object

    def to(self, device) -> "FlatRows":
        return FlatRows(*(x.to(device).contiguous() for x in self))


def _check_design(design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: expected one of "
                         f"{', '.join(DESIGNS)}")


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


def _check(max_leaf, rows=None, **a):
    _build.refuse_grad("flat_walk", **a)
    N = a["skip"].shape[0]
    R = a["ro"].shape[0]
    T = a["tri_idx"].shape[0]
    S = a["sph_center"].shape[0]
    P = a["prim_ids"].shape[0]
    shapes = dict(node_min=(N, 3), node_max=(N, 3), skip=(N,),
                  prim_start=(N,), prim_count=(N,), prim_ids=(P,),
                  tri_idx=(T, 3), vertices=(a["vertices"].shape[0], 3),
                  sph_center=(S, 3), sph_radius=(S,), ro=(R, 3), rd=(R, 3),
                  t_min=(R,), t_max=(R,))
    dtypes = dict(_DTYPES)
    if rows is not None:
        _build.refuse_grad("flat_walk", **rows._asdict())
        a = dict(a, **rows._asdict())
        shapes.update(node_rows=(N, 8), prim_rows=(P, 16), prim_gid=(P,))
        dtypes.update(node_rows=torch.float32, prim_rows=torch.float32,
                      prim_gid=torch.int32)
    for name, shape in shapes.items():
        x = a[name]
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got "
                             f"{tuple(x.shape)}")
        if x.dtype != dtypes[name]:
            raise TypeError(f"{name}: expected {dtypes[name]}, got "
                            f"{x.dtype}")
        if x.device != a["ro"].device:
            raise ValueError("flat_walk: tensors on different devices")
    if N < 1 or P < 1 or max_leaf < 1:
        raise ValueError(f"flat_walk: needs nodes and primitives, got "
                         f"{N} nodes, {P} primitive ids, max_leaf "
                         f"{max_leaf}")


def flat_walk_ref(node_min, node_max, skip, prim_start, prim_count, prim_ids,
                  tri_idx, vertices, sph_center, sph_radius, ro, rd, t_min,
                  t_max, max_leaf: int, any_hit: bool = False,
                  stats: dict | None = None, rows: FlatRows | None = None):
    """Plain PyTorch version of :func:`flat_walk`: the lockstep walk of
    ``tpu_pt/bvh/flat.py``, one iteration per node step of every ray still
    walking, until none is.

    rows: the row tables of the same BVH and scene (:class:`FlatRows`).
    Where given, nodes and primitives are read from them, as the row walk
    reads them (a leaf goes on to ``cursor + 1``); otherwise they are
    gathered from the arrays, as the thread walk reads them.  The two give
    the same bits.

    stats: when a dict is passed, it receives ``iterations`` (lockstep
    iterations run), ``steps`` ((R,) nodes each ray fetched), ``leaves``
    ((R,) leaves each ray entered), ``prims`` ((R,) primitives each ray
    tested), ``prims_tri`` / ``prims_sph`` (triangles / spheres tested in
    all; primitives are counted as the kernel tests them: the any-hit form
    stops at its first hit) and ``node_seen`` / ``prim_seen`` ((N,) /
    (T + S,) bool: the nodes any ray fetched, the primitives any ray
    tested)."""
    _check(max_leaf, rows, node_min=node_min, node_max=node_max, skip=skip,
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
    leaves = torch.zeros_like(steps)
    prims = torch.zeros_like(steps)
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
        if rows is None:
            bmin, bmax = node_min[node], node_max[node]
            count, start = prim_count[node], prim_start[node].long()
        else:
            nr = rows.node_rows[node]
            bmin, bmax = nr[:, 0:3], nr[:, 3:6]
            link = nr[:, 6].contiguous().view(torch.int32).long()
            count = nr[:, 7].contiguous().view(torch.int32)
            start = link

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
        hit_bb = (t_near <= widen_up(t_far))[:, 0] & active

        is_leaf = count > 0
        test_leaf = hit_bb & is_leaf
        if stats is not None:
            leaves += test_leaf
        for k in range(max_leaf):
            in_rng = test_leaf & (k < count)
            slot = torch.clamp(start + k, 0, n_prims - 1)
            if rows is None:
                g = prim_ids[slot]
                h, t, u, v = _prim_test(tri_idx, vertices, sph_center,
                                        sph_radius, g, in_rng[:, None], ro,
                                        rd, t_min, best_t)
            else:
                g = rows.prim_gid[slot]
                h, t, u, v = _prim_row_test(rows.prim_rows[slot],
                                            in_rng[:, None], ro, rd, t_min,
                                            best_t)
            if stats is not None:
                tested = in_rng & ~occ[:, 0] if any_hit else in_rng
                prims += tested
                tri = g < n_tris
                prims_tri += int(torch.sum(tested & tri))
                prims_sph += int(torch.sum(tested & ~tri))
                prim_seen[g[tested].long()] = True
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

        if rows is None:
            nxt = torch.where(hit_bb & ~is_leaf, cursor + 1,
                              skip[node].long())
        else:
            nxt = torch.where(hit_bb | is_leaf, cursor + 1, link)
        cursor = torch.where(active, nxt, torch.full_like(nxt, n))
    if stats is not None:
        stats.update(iterations=iterations, steps=steps, leaves=leaves,
                     prims=prims, prims_tri=prims_tri, prims_sph=prims_sph,
                     node_seen=node_seen, prim_seen=prim_seen)
    if any_hit:
        return occ[:, 0]
    return best_t[:, 0], best_g, best_u[:, 0], best_v[:, 0]


def _outputs(R, any_hit, dev):
    """The kernels' outputs, and their pointers in the launch's order
    (t, prim, u, v, occluded; 0 for the form's unused ones)."""
    if any_hit:
        occ = torch.empty((R,), dtype=torch.bool, device=dev)
        return occ, (0, 0, 0, 0, occ.data_ptr())
    out = (torch.empty((R,), dtype=torch.float32, device=dev),
           torch.empty((R,), dtype=torch.int32, device=dev),
           torch.empty((R,), dtype=torch.float32, device=dev),
           torch.empty((R,), dtype=torch.float32, device=dev))
    return out, tuple(x.data_ptr() for x in out) + (0,)


def _rows_on_card(rows: FlatRows):
    for name, x in rows._asdict().items():
        _build.check_cuda_input(name, x, x.dtype)
        if x.data_ptr() % 16:
            raise ValueError(f"flat_walk: {name} must be 16-byte aligned")


def _launch_rows(rows: FlatRows, ro, rd, t_min, t_max, max_leaf: int,
                 any_hit: bool, counts: tuple = (0, 0, 0)):
    """One launch of the row walk on checked CUDA operands (``counts``: the
    STATS form's three buffers, or zeros).  Returns the outputs."""
    R = ro.shape[0]
    dev = ro.device
    out, ptrs = _outputs(R, any_hit, dev)
    if R > 0:
        err = _build.load().flat_walk_rows_launch(
            *(x.data_ptr() for x in rows), ro.data_ptr(), rd.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), *ptrs, *counts, R,
            rows.node_rows.shape[0], rows.prim_rows.shape[0], int(max_leaf),
            int(bool(any_hit)), _build.sm_count(dev),
            torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"flat_walk (rows): CUDA launch error {err}")
    return out


def rows_kernel_attrs(any_hit: bool, stats: bool = False) -> dict:
    """The row walk's kernel as compiled for the card (``cudaFuncGet
    Attributes``): registers and local (spill) bytes a thread, blocks an SM
    holds at once."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = _build.load().flat_walk_rows_attrs(
        int(bool(any_hit)), int(bool(stats)), *(ctypes.byref(v) for v in vals))
    if err != 0:
        raise RuntimeError(f"flat_walk_rows_attrs: CUDA error {err}")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def flat_walk(node_min, node_max, skip, prim_start, prim_count, prim_ids,
              tri_idx, vertices, sph_center, sph_radius, ro, rd, t_min, t_max,
              max_leaf: int, any_hit: bool = False, design: str = "rows",
              rows: FlatRows | None = None):
    """A flat BVH's arrays (``FlatBVH`` fields) and a scene's primitive
    arrays; ro, rd: (R, 3) f32; t_min, t_max: (R,) f32.  A ray whose
    ``t_max < t_min`` leaves at the root.

    Returns (t (R,) f32, prim (R,) i32, u, v): ``t`` is the nearest hit's
    distance, ``t_max`` where nothing hit nearer than that (the caller
    decides ``found = t < t_max``), with the winner's primitive id (0 where
    nothing hit) and barycentrics (0 on spheres).  With ``any_hit`` returns
    (R,) bool: a primitive hit within [t_min, t_max].

    design: ``"rows"`` (the row walk over ``rows``, the tables
    ``bvh/flat.py::row_tables`` builds for this BVH and scene; its launches
    are counted in ``flat_walk.launches``) or ``"thread"`` (the thread walk
    over the arrays; ``flat_walk.thread_launches``), the same bits.

    CUDA tensors go to the kernel of that design (or raise; the row walk
    raises without ``rows``); CPU tensors to the plain version, whatever the
    design, over ``rows`` where given."""
    _check_design(design)
    a = dict(node_min=node_min, node_max=node_max, skip=skip,
             prim_start=prim_start, prim_count=prim_count, prim_ids=prim_ids,
             tri_idx=tri_idx, vertices=vertices, sph_center=sph_center,
             sph_radius=sph_radius, ro=ro, rd=rd, t_min=t_min, t_max=t_max)
    if not ro.is_cuda:
        return flat_walk_ref(**a, max_leaf=max_leaf, any_hit=any_hit,
                             rows=rows)
    if design == "rows" and rows is None:
        raise ValueError("flat_walk: design 'rows' needs the row tables "
                         "(bvh/flat.py::row_tables)")
    _check(max_leaf, rows if design == "rows" else None, **a)
    for name in _ARRAYS:
        _build.check_cuda_input(name, a[name], _DTYPES[name])
    if design == "rows":
        _rows_on_card(rows)
        out = _launch_rows(rows, ro, rd, t_min, t_max, max_leaf, any_hit)
        if ro.shape[0] > 0:
            flat_walk.launches += 1
        return out
    R = ro.shape[0]
    out, ptrs = _outputs(R, any_hit, ro.device)
    if R > 0:
        err = _build.load().flat_walk_launch(
            *(a[name].data_ptr() for name in _ARRAYS), *ptrs, R,
            skip.shape[0], prim_ids.shape[0], tri_idx.shape[0],
            sph_center.shape[0], int(max_leaf), int(bool(any_hit)),
            torch.cuda.current_stream(ro.device).cuda_stream)
        flat_walk.thread_launches += 1
        if err != 0:
            raise RuntimeError(f"flat_walk (thread): CUDA launch error {err}")
    return out


flat_walk.launches = 0          # row-walk launches of this process
flat_walk.thread_launches = 0   # thread-walk launches of this process


def flat_walk_counts(node_min, node_max, skip, prim_start, prim_count,
                     prim_ids, tri_idx, vertices, sph_center, sph_radius, ro,
                     rd, t_min, t_max, max_leaf: int, any_hit: bool = False,
                     rows: FlatRows | None = None) -> dict:
    """What the walk of these rays does, counted: :func:`flat_walk_ref`'s
    ``stats`` (``iterations`` is the most steps of a ray), with ``out``, the
    walk's result.  CUDA tensors go to the STATS form of the row walk (one
    launch, counted in ``flat_walk_counts.launches``, not in
    ``flat_walk``'s: it is a measurement, not the walk), which needs
    ``rows``; CPU tensors to the plain version."""
    a = dict(node_min=node_min, node_max=node_max, skip=skip,
             prim_start=prim_start, prim_count=prim_count, prim_ids=prim_ids,
             tri_idx=tri_idx, vertices=vertices, sph_center=sph_center,
             sph_radius=sph_radius, ro=ro, rd=rd, t_min=t_min, t_max=t_max)
    stats = {}
    if not ro.is_cuda:
        out = flat_walk_ref(**a, max_leaf=max_leaf, any_hit=any_hit,
                            stats=stats, rows=rows)
        return dict(stats, out=out)
    if rows is None:
        raise ValueError("flat_walk_counts: needs the row tables "
                         "(bvh/flat.py::row_tables) on the card")
    _check(max_leaf, rows, **a)
    for name in _ARRAYS:
        _build.check_cuda_input(name, a[name], _DTYPES[name])
    _rows_on_card(rows)
    R, N, P = ro.shape[0], skip.shape[0], prim_ids.shape[0]
    dev = ro.device
    counts = torch.zeros((R, 4), dtype=torch.int32, device=dev)
    node_seen = torch.zeros((N,), dtype=torch.uint8, device=dev)
    slot_seen = torch.zeros((P,), dtype=torch.uint8, device=dev)
    out = _launch_rows(rows, ro, rd, t_min, t_max, max_leaf, any_hit,
                       counts=(counts.data_ptr(), node_seen.data_ptr(),
                               slot_seen.data_ptr()))
    if R > 0:
        flat_walk_counts.launches += 1
    c = counts.long()
    prim_seen = torch.zeros((tri_idx.shape[0] + sph_center.shape[0],),
                            dtype=torch.bool, device=dev)
    prim_seen[rows.prim_gid[slot_seen.bool()].long()] = True
    return dict(iterations=int(c[:, 0].max()) if R else 0, steps=c[:, 0],
                leaves=c[:, 1], prims=c[:, 2] + c[:, 3],
                prims_tri=int(c[:, 2].sum()), prims_sph=int(c[:, 3].sum()),
                node_seen=node_seen.bool(), prim_seen=prim_seen, out=out)


flat_walk_counts.launches = 0   # STATS-form launches of this process
