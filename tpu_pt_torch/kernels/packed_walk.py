"""The packed BVH walk: every ray walks its octant's skip-pointer node table
alone, stackless, and tests the primitive rows of the leaves whose box it
enters.

Counterpart of ``tpu_pt/bvh/packed.py::_traverse``, which is not a Pallas
kernel: XLA compiles its ``lax.while_loop`` over the batch, in lockstep,
into one program.  In eager PyTorch that lockstep loop costs some 270
launches and one host read per iteration, and a batch runs as long as its
longest ray (the suspect rays of the exact repair are those with the most
candidates).  ``packed_walk`` therefore launches a hand-written CUDA kernel
(``csrc/packed_walk.cu``): one thread per ray, the loop inside the thread,
no host in the loop.  ``packed_walk_ref`` is the plain version: the
lockstep loop written out column by column, in the kernel's order of
operations, so that the two agree bit for bit.  ``packed_walk`` runs it for
CPU tensors; for CUDA tensors it launches the kernel or raises.

The table (see ``bvh/packed.py::PackedBVH``): ``n_tables`` node tables of
``n_nodes`` rows each, then the primitive rows, all 16 floats wide.
  node row: [min.xyz, max.xyz, skip (i32 bits), meta (i32 bits), 0 x 8];
            meta is -1 for an inner node, else ``start | (count << 26)``.
  prim row: triangle [v0, e1, e2, material bits, 0 (type), pad];
            sphere   [centre, r, 0 0, 0 0 0, material bits, 1 (type), pad].
The walk: a node whose box the ray enters within [t_min, best t] is
descended into (``cursor + 1``); otherwise, and after a leaf, the walk goes
to ``skip``.  "Enters" is conservative: the slab entry is held against
:func:`widen_up` of min(slab exit, best t), so that a box holding a
primitive at best t is entered even where the slab t and the primitive's t
round apart (coplanar faces).  A leaf tests its first ``min(count,
max_leaf)`` rows; a row takes over when it hits nearer, or as near with a
lower primitive id.  The any-hit form stops at the first such row.
"""

from __future__ import annotations

import torch

from tpu_pt_torch.core.intersect import INF, sphere_hit
from tpu_pt_torch.kernels import _build

_GID_NONE = 2**31 - 1   # best gid before any hit
WINDOW = 32             # node rows a window of the window design
DESIGNS = ("window", "thread")
_WIDEN_UP = 1.0 + 2.0**-14     # exact in f32, as is _WIDEN_DOWN
_WIDEN_DOWN = 1.0 - 2.0**-14


def _check_design(design: str) -> None:
    if design not in DESIGNS:
        raise ValueError(f"unknown design {design!r}: expected one of "
                         f"{', '.join(DESIGNS)}")


def widen_up(x):
    """The walks' cull bound: ``x`` times 1 + 2^-14 where ``x >= 0`` and
    times 1 - 2^-14 where ``x < 0``: one rounding of x + |x| 2^-14, so
    upward for either sign, with inf, -inf, 0 and NaN kept.
    ``csrc/pair_isect_common.cuh::widen_up`` is the same multiply.

    A walk enters a node iff its slab entry is <= widen_up(min(slab exit,
    best t)).  2^-20 (16 u, u = 2^-24) would cover a slab t's three
    roundings (Ize 2013) and a face's Möller–Trumbore t's seven in an axis
    plane, so that no box holding brute force's nearest (t, lowest id) on
    a coplanar face is culled (the argument is written out above
    ``tests/test_torch_packed.py::
    test_walk_on_coplanar_faces_matches_brute_force``).  A ray that meets
    skew faces where they join may hit one that it misses by a rounding,
    just outside the box that holds it, whose entry t then lies beyond the
    hit's by the rounding over the sine of the ray's angle to the box's
    face: no width bounds that (``tools/walk_edges.py`` counts it).  2^-14
    covers every such ray of ``tests/test_torch_flat.py::
    test_walks_equal_brute_force_on_skew_faces`` and all but 3 of the
    tool's 200,000, and stays well inside the renderers' shadow-ray
    margin (t_max is the light's distance less 1e-3 of it): 2^-10 nearly
    closed that margin and made the oracle's shadow walks 29 % slower."""
    return x * torch.where(x < 0, _WIDEN_DOWN, _WIDEN_UP)


def _octant_of(rd):
    """(R,) int64 octant index from the direction's signs (-0 is not < 0)."""
    return ((rd[:, 0] < 0).long() + 2 * (rd[:, 1] < 0).long()
            + 4 * (rd[:, 2] < 0).long())


def _prim_row_test(row, active, ro, rd, t_min, t_max):
    """Möller–Trumbore / sphere test of each ray against its packed row.

    row: (R, 16); active: (R, 1) bool; ro, rd: (R, 3); t_min, t_max:
    (R, 1).  Returns (hit (R, 1), t (INF where not hit), u, v (0 on sphere
    rows)).  Every sum is written out left to right and every product of a
    cross product on its own, in ``csrc/pair_isect_common.cuh::prim_hit``'s
    order: one rounding per operation, as there."""
    def col(c):
        return row[:, c:c + 1]

    v0x, v0y, v0z = col(0), col(1), col(2)
    e1x, e1y, e1z = col(3), col(4), col(5)
    e2x, e2y, e2z = col(6), col(7), col(8)
    ox, oy, oz = ro[:, 0:1], ro[:, 1:2], ro[:, 2:3]
    dx, dy, dz = rd[:, 0:1], rd[:, 1:2], rd[:, 2:3]
    zero = torch.zeros((), dtype=row.dtype, device=row.device)
    one = torch.ones((), dtype=row.dtype, device=row.device)

    # pvec = rd x e2
    px = dy * e2z - dz * e2y
    py = dz * e2x - dx * e2z
    pz = dx * e2y - dy * e2x
    det = e1x * px + e1y * py + e1z * pz
    par = torch.abs(det) < 1e-12
    inv_det = torch.where(par, zero, 1.0 / torch.where(par, one, det))
    tvx, tvy, tvz = ox - v0x, oy - v0y, oz - v0z
    u = (tvx * px + tvy * py + tvz * pz) * inv_det
    # qvec = tvec x e1
    qx = tvy * e1z - tvz * e1y
    qy = tvz * e1x - tvx * e1z
    qz = tvx * e1y - tvy * e1x
    v = (dx * qx + dy * qy + dz * qz) * inv_det
    t_tri = (e2x * qx + e2y * qy + e2z * qz) * inv_det
    hit_tri = (~par) & (u >= 0) & (v >= 0) & (u + v <= 1) \
        & (t_tri >= t_min) & (t_tri <= t_max)

    # Sphere rows: v0 = centre, e1.x = radius.
    hit_sph, t_sph = sphere_hit(tvx, tvy, tvz, dx, dy, dz, e1x, t_min, t_max)

    is_sph = col(10) > 0.5
    hit = active & torch.where(is_sph, hit_sph, hit_tri)
    t = torch.where(is_sph, t_sph, t_tri)
    return (hit, torch.where(hit, t, torch.full_like(t, INF)),
            torch.where(is_sph, zero, u), torch.where(is_sph, zero, v))


def _check(table, prim_gid, ro, rd, t_min, t_max, n_nodes, n_tables,
           max_leaf):
    _build.refuse_grad("packed_walk", table=table, prim_gid=prim_gid, ro=ro,
                       rd=rd, t_min=t_min, t_max=t_max)
    if table.dim() != 2 or table.shape[1] != 16:
        raise ValueError(f"table: expected (K*N + P, 16), got "
                         f"{tuple(table.shape)}")
    if prim_gid.dim() != 1 or prim_gid.shape[0] < 1:
        raise ValueError(f"prim_gid: expected (P,) with P >= 1, got "
                         f"{tuple(prim_gid.shape)}")
    if n_nodes < 1 or n_tables < 1 or max_leaf < 1 \
            or table.shape[0] != n_tables * n_nodes + prim_gid.shape[0]:
        raise ValueError(
            f"table of {table.shape[0]} rows does not hold {n_tables} node "
            f"tables of {n_nodes} rows and {prim_gid.shape[0]} primitive rows "
            f"(max_leaf {max_leaf})")
    R = ro.shape[0]
    for name, x, shape in (("ro", ro, (R, 3)), ("rd", rd, (R, 3)),
                           ("t_min", t_min, (R,)), ("t_max", t_max, (R,))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name}: expected {shape}, got {tuple(x.shape)}")
    for name, x, dt in (("table", table, torch.float32),
                        ("prim_gid", prim_gid, torch.int32),
                        ("ro", ro, torch.float32), ("rd", rd, torch.float32),
                        ("t_min", t_min, torch.float32),
                        ("t_max", t_max, torch.float32)):
        if x.dtype != dt:
            raise TypeError(f"{name}: expected {dt}, got {x.dtype}")
        if x.device != table.device:
            raise ValueError("packed_walk: tensors on different devices")


def packed_walk_ref(table, prim_gid, ro, rd, t_min, t_max, n_nodes: int,
                    n_tables: int, max_leaf: int, any_hit: bool = False,
                    stats: dict | None = None, window: int = WINDOW):
    """Plain PyTorch version of :func:`packed_walk`: the lockstep walk of
    ``tpu_pt/bvh/packed.py::_traverse``, one iteration per node step of
    every ray still walking, until none is.

    stats: when a dict is passed, it receives ``iterations`` (lockstep
    iterations run), ``steps`` ((R,) node rows each ray fetched),
    ``windows`` ((R,) windows of ``window`` node rows, ``WINDOW`` in the
    kernel, that a window walk loads for each ray: one where the walk
    starts, and one each time the cursor leaves the last), ``leaves`` ((R,)
    leaves each ray entered),
    ``rows_tri`` / ``rows_sph`` (triangle / sphere rows tested, counted as
    the kernel tests them: the any-hit form stops at its first hit) and
    ``node_seen`` / ``row_seen`` ((n_tables * n_nodes,) / (P,) bool: the
    node and primitive rows any ray fetched)."""
    _check(table, prim_gid, ro, rd, t_min, t_max, n_nodes, n_tables,
           max_leaf)
    R = ro.shape[0]
    dev = table.device
    n = int(n_nodes)
    n_prims = prim_gid.shape[0]
    prim_base = n_tables * n
    t_min = t_min[:, None]
    rd_inv = 1.0 / rd
    base = (_octant_of(rd) % n_tables) * n
    ox, oy, oz = ro[:, 0:1], ro[:, 1:2], ro[:, 2:3]
    ix, iy, iz = rd_inv[:, 0:1], rd_inv[:, 1:2], rd_inv[:, 2:3]
    ninf = torch.full((), -float("inf"), device=dev)
    pinf = torch.full((), float("inf"), device=dev)

    cursor = torch.zeros((R,), dtype=torch.int64, device=dev)
    best_t = t_max[:, None].clone()
    best_gid = torch.full((R,), _GID_NONE, dtype=torch.int32, device=dev)
    best_slot = torch.zeros((R,), dtype=torch.int32, device=dev)
    best_u = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    best_v = torch.zeros((R, 1), dtype=torch.float32, device=dev)
    occ = torch.zeros((R, 1), dtype=torch.bool, device=dev)
    steps = torch.zeros((R,), dtype=torch.int64, device=dev)
    windows = torch.zeros_like(steps)
    leaves = torch.zeros_like(steps)
    window_base = torch.full_like(steps, -window)
    rows_tri = rows_sph = 0
    if stats is not None:
        node_seen = torch.zeros((prim_base,), dtype=torch.bool, device=dev)
        row_seen = torch.zeros((n_prims,), dtype=torch.bool, device=dev)
    iterations = 0
    while bool(torch.any(cursor < n)):
        iterations += 1
        active = (cursor < n) & ~occ[:, 0]
        steps += active
        opens = active & (cursor >= window_base + window)
        windows += opens
        window_base = torch.where(opens, cursor, window_base)
        node = table[base + torch.where(active, cursor, 0)]
        if stats is not None:
            node_seen[(base + cursor)[active]] = True
        skip = node[:, 6].contiguous().view(torch.int32).long()
        meta = node[:, 7].contiguous().view(torch.int32)

        def axis(lo, hi):
            near = torch.minimum(lo, hi)
            far = torch.maximum(lo, hi)
            return (torch.where(torch.isnan(near), ninf, near),
                    torch.where(torch.isnan(far), pinf, far))

        nx, fx = axis((node[:, 0:1] - ox) * ix, (node[:, 3:4] - ox) * ix)
        ny, fy = axis((node[:, 1:2] - oy) * iy, (node[:, 4:5] - oy) * iy)
        nz, fz = axis((node[:, 2:3] - oz) * iz, (node[:, 5:6] - oz) * iz)
        t_near = torch.maximum(
            torch.maximum(torch.maximum(nx, ny), nz), t_min)
        t_far = torch.minimum(
            torch.minimum(torch.minimum(fx, fy), fz), best_t)
        hit_bb = (t_near <= widen_up(t_far))[:, 0] & active

        is_leaf = meta >= 0
        start = (meta & ((1 << 26) - 1)).long()
        cnt = (meta >> 26) & 63                      # logical shift
        test_leaf = hit_bb & is_leaf
        leaves += test_leaf
        for k in range(max_leaf):
            in_rng = test_leaf & (k < cnt)
            slot = torch.clamp(start + k, 0, n_prims - 1)
            row = table[prim_base + slot]
            if stats is not None:
                tested = in_rng & ~occ[:, 0] if any_hit else in_rng
                sph = row[:, 10] > 0.5
                rows_sph += int(torch.sum(tested & sph))
                rows_tri += int(torch.sum(tested & ~sph))
                row_seen[slot[tested]] = True
            h, t, u, v = _prim_row_test(row, in_rng[:, None], ro, rd, t_min,
                                        best_t)
            gid = prim_gid[slot]
            closer = h & ((t < best_t)
                          | ((t == best_t) & (gid < best_gid)[:, None]))
            c = closer[:, 0]
            best_slot = torch.where(c, slot.to(torch.int32), best_slot)
            best_gid = torch.where(c, gid, best_gid)
            best_u = torch.where(closer, u, best_u)
            best_v = torch.where(closer, v, best_v)
            best_t = torch.where(closer, t, best_t)
            if any_hit:
                occ = occ | closer

        descend = hit_bb & ~is_leaf
        nxt = torch.where(descend, cursor + 1, skip)
        cursor = torch.where(active, nxt, torch.full_like(nxt, n))
    if stats is not None:
        stats.update(iterations=iterations, steps=steps, windows=windows,
                     leaves=leaves, rows_tri=rows_tri,
                     rows_sph=rows_sph, node_seen=node_seen,
                     row_seen=row_seen)
    if any_hit:
        return occ[:, 0]
    return best_t[:, 0], best_slot, best_u[:, 0], best_v[:, 0]


def packed_walk(table, prim_gid, ro, rd, t_min, t_max, n_nodes: int,
                n_tables: int, max_leaf: int, any_hit: bool = False,
                design: str = "window"):
    """table: (n_tables * n_nodes + P, 16) f32; prim_gid: (P,) i32; ro, rd:
    (R, 3) f32; t_min, t_max: (R,) f32.  A ray whose ``t_max < t_min``
    leaves at the root.

    Returns (t (R,) f32, slot (R,) i32, u, v): ``t`` is the nearest hit's
    distance, ``t_max`` where nothing hit nearer than that (the caller
    decides ``found = t < t_max``), with the winner's row slot (an index
    into ``prim_gid``, 0 where nothing hit) and barycentrics (0 on spheres);
    lowest primitive id at equal t.  With ``any_hit`` returns (R,) bool: a
    row hit within [t_min, t_max].

    design: ``"window"`` (a warp a ray, 32 node rows a round trip; its
    launches are counted in ``packed_walk.launches``) or ``"thread"`` (a
    thread a ray; ``packed_walk.thread_launches``), the same bits.

    CUDA tensors go to the kernel of that design (or raise); CPU tensors to
    the plain version, whatever the design."""
    _check_design(design)
    if not table.is_cuda:
        return packed_walk_ref(table, prim_gid, ro, rd, t_min, t_max, n_nodes,
                               n_tables, max_leaf, any_hit)
    _check(table, prim_gid, ro, rd, t_min, t_max, n_nodes, n_tables,
           max_leaf)
    for name, x in (("table", table), ("prim_gid", prim_gid), ("ro", ro),
                    ("rd", rd), ("t_min", t_min), ("t_max", t_max)):
        _build.check_cuda_input(name, x, x.dtype)
    if table.data_ptr() % 16:
        raise ValueError("packed_walk: table must be 16-byte aligned")
    R = ro.shape[0]
    dev = table.device
    if any_hit:
        occ = torch.empty((R,), dtype=torch.bool, device=dev)
        outs = (0, 0, 0, 0, occ.data_ptr())
    else:
        out_t = torch.empty((R,), dtype=torch.float32, device=dev)
        out_s = torch.empty((R,), dtype=torch.int32, device=dev)
        out_u = torch.empty_like(out_t)
        out_v = torch.empty_like(out_t)
        outs = (out_t.data_ptr(), out_s.data_ptr(), out_u.data_ptr(),
                out_v.data_ptr(), 0)
    if R > 0:
        lib = _build.load()
        launch = lib.packed_walk_window_launch if design == "window" \
            else lib.packed_walk_launch
        err = launch(
            table.data_ptr(), prim_gid.data_ptr(), ro.data_ptr(),
            rd.data_ptr(), t_min.data_ptr(), t_max.data_ptr(), *outs, R,
            int(n_nodes), int(n_tables), prim_gid.shape[0], int(max_leaf),
            int(bool(any_hit)), torch.cuda.current_stream(dev).cuda_stream)
        if design == "window":
            packed_walk.launches += 1
        else:
            packed_walk.thread_launches += 1
        if err != 0:
            raise RuntimeError(f"packed_walk ({design}): CUDA launch error "
                               f"{err}")
    return occ if any_hit else (out_t, out_s, out_u, out_v)


packed_walk.launches = 0          # window-design launches of this process
packed_walk.thread_launches = 0   # thread-design launches of this process
