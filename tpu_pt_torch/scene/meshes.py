"""Procedural meshes: icosphere subdivision, the large benchmark scene (a
displaced sphere of 20 * 4^subdiv triangles over a ground plane) and the
atrium (about 1M triangles of fluted columns in a hall)."""

from __future__ import annotations

import numpy as np


def icosphere(subdiv: int = 3):
    """Unit icosphere.  Returns (verts (V,3) f32, tris (T,3) i32).
    T = 20 * 4^subdiv (subdiv=3 → 1280 tris; 5 → 20480; 8 → 1.3M)."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        (-1, phi, 0), (1, phi, 0), (-1, -phi, 0), (1, -phi, 0),
        (0, -1, phi), (0, 1, phi), (0, -1, -phi), (0, 1, -phi),
        (phi, 0, -1), (phi, 0, 1), (-phi, 0, -1), (-phi, 0, 1),
    ], np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ], np.int64)
    for _ in range(subdiv):
        verts = list(map(tuple, v))
        cache = {}

        def midpoint(a, b):
            k = (min(a, b), max(a, b))
            if k in cache:
                return cache[k]
            m = (v[a] + v[b]) / 2.0
            m = m / np.linalg.norm(m)
            verts.append(tuple(m))
            cache[k] = len(verts) - 1
            return cache[k]

        nf = []
        for a, b, c in f:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            nf += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        v = np.asarray(verts, np.float64)
        f = np.asarray(nf, np.int64)
    return v.astype(np.float32), f.astype(np.int32)


def displaced_sphere(subdiv: int = 8, amp: float = 0.15, freq: float = 9.0,
                     seed: int = 0):
    """A 'dragon-class' irregular mesh: icosphere displaced by a few octaves
    of sinusoidal noise so the BVH sees non-uniform geometry."""
    v, f = icosphere(subdiv)
    rng = np.random.RandomState(seed)
    d = np.zeros(len(v), np.float32)
    for o in range(4):
        k = rng.normal(size=(3, 3)).astype(np.float32) * freq * (1.6 ** o)
        ph = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
        for j in range(3):
            d += (amp / (2.0 ** o)) * np.sin(v @ k[j] + ph[j]).astype(np.float32)
    v = v * (1.0 + d[:, None] * 0.35)
    return v.astype(np.float32), f


def big_scene(subdiv: int = 8, width_light: float = 4.0):
    """~1M-triangle benchmark scene (at subdiv=8): a displaced sphere over a
    ground plane under one big area light.  Returns a Scene."""
    from tpu_pt_torch.scene.types import (
        LIGHT_AREA, MAT_DIFFUSE, MAT_EMISSIVE, make_lights, make_materials,
        make_scene,
    )

    mv, mt = displaced_sphere(subdiv=subdiv)
    mv = mv * 1.0 + np.array([0.0, 1.4, 0.0], np.float32)
    verts = list(map(tuple, mv))
    tris = list(map(tuple, mt))
    mats = [0] * len(mt)
    # ground plane
    base = len(verts)
    g = 6.0
    verts += [(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)]
    tris += [(base, base + 1, base + 2), (base, base + 2, base + 3)]
    mats += [1, 1]
    w = width_light / 2
    lights = make_lights([
        dict(kind=LIGHT_AREA, position=(-w, 5.0, -w), edge_x=(width_light, 0, 0),
             edge_y=(0, 0, width_light), normal=(0, -1, 0),
             radiance=(10.0, 10.0, 10.0)),
    ])
    materials = make_materials([
        dict(kind=MAT_DIFFUSE, albedo=(0.55, 0.5, 0.45)),
        dict(kind=MAT_DIFFUSE, albedo=(0.4, 0.4, 0.42)),
    ])
    return make_scene(
        vertices=np.asarray(verts, np.float32),
        tri_idx=np.asarray(tris, np.int32),
        tri_mat=np.asarray(mats, np.int32),
        materials=materials, lights=lights,
    )


def big_camera(width: int, height: int):
    from tpu_pt_torch.core.camera import Camera

    return Camera.look_at(
        eye=(2.8, 2.4, 3.2), target=(0.0, 1.2, 0.0), hfov=55.0,
        aspect=width / height,
    )


# ---------------------------------------------------------------------------
# Architectural "Sponza-class" benchmark scene.  The displaced sphere is
# convex-ish and flatters traversal; an interior colonnaded atrium gives
# Sponza's actual hard properties: high depth complexity (every nave ray passes rows of columns
# before a far wall), heavy shadow-ray occlusion from interior lights, and
# very non-uniform triangle density (finely fluted columns vs bare walls).
# ---------------------------------------------------------------------------


def _grid_quad(p0, ex, ey, nx, ny):
    """Subdivided quad: corner p0, edges ex/ey.  Returns (verts, tris)."""
    p0 = np.asarray(p0, np.float32)
    ex = np.asarray(ex, np.float32)
    ey = np.asarray(ey, np.float32)
    us = np.linspace(0.0, 1.0, nx + 1, dtype=np.float32)
    vs = np.linspace(0.0, 1.0, ny + 1, dtype=np.float32)
    verts = (p0[None, None] + us[None, :, None] * ex[None, None]
             + vs[:, None, None] * ey[None, None]).reshape(-1, 3)
    i = np.arange(ny)[:, None] * (nx + 1) + np.arange(nx)[None, :]
    a, b, c, d = i, i + 1, i + nx + 2, i + nx + 1
    tris = np.concatenate([
        np.stack([a, b, c], -1).reshape(-1, 3),
        np.stack([a, c, d], -1).reshape(-1, 3),
    ], 0)
    return verts.astype(np.float32), tris.astype(np.int32)


def _column(cx, cz, r, y0, y1, n_rad, n_y, flutes=20, flute_amp=0.045):
    """Fluted column with entasis (classical radius taper).  Returns
    (verts, tris): a closed side surface of n_rad x n_y quads."""
    th = np.linspace(0, 2 * np.pi, n_rad, endpoint=False, dtype=np.float32)
    ys = np.linspace(y0, y1, n_y + 1, dtype=np.float32)
    s = (ys - y0) / max(y1 - y0, 1e-6)
    taper = 1.0 - 0.18 * s * s            # entasis: slimmer at the top
    rr = (r * taper[:, None]
          * (1.0 + flute_amp * np.cos(flutes * th)[None, :]))
    x = cx + rr * np.cos(th)[None, :]
    z = cz + rr * np.sin(th)[None, :]
    y = np.broadcast_to(ys[:, None], x.shape)
    verts = np.stack([x, y, z], -1).reshape(-1, 3)
    j = np.arange(n_rad)
    jn = (j + 1) % n_rad
    rows = np.arange(n_y)[:, None] * n_rad
    a = rows + j[None, :]
    b = rows + jn[None, :]
    c = rows + n_rad + jn[None, :]
    d = rows + n_rad + j[None, :]
    tris = np.concatenate([
        np.stack([a, b, c], -1).reshape(-1, 3),
        np.stack([a, c, d], -1).reshape(-1, 3),
    ], 0)
    return verts.astype(np.float32), tris.astype(np.int32)


def _box(lo, hi):
    """Axis-aligned box (12 tris, outward normals)."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    x0, y0, z0 = lo
    x1, y1, z1 = hi
    v = np.array([
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ], np.float32)
    f = np.array([
        (0, 2, 1), (0, 3, 2),          # z0
        (4, 5, 6), (4, 6, 7),          # z1
        (0, 1, 5), (0, 5, 4),          # y0
        (3, 7, 6), (3, 6, 2),          # y1
        (0, 4, 7), (0, 7, 3),          # x0
        (1, 2, 6), (1, 6, 5),          # x1
    ], np.int32)
    return v, f


def atrium_scene(col_rad: int = 128, col_ny: int = 184, light_scale=30.0):
    """~1M-triangle interior atrium: two colonnades of fluted columns on
    pedestals, a gallery of smaller columns above, coffered ceiling with two
    skylight area lights, glossy marble floor.  The bench camera looks down
    the nave so every primary ray crosses both colonnades (high depth
    complexity) and most NEE shadow rays are occluded (any-hit stress)."""
    from tpu_pt_torch.scene.types import (
        LIGHT_AREA, MAT_DIFFUSE, MAT_GGX, make_lights, make_materials,
        make_scene,
    )

    # Hall: x in [-12, 12] (nave axis), z in [-5, 5], y in [0, 9].
    L, W, H = 12.0, 5.0, 9.0
    verts_l, tris_l, mats_l = [], [], []

    def add(v, f, mat):
        base = sum(len(x) for x in verts_l)
        verts_l.append(v)
        tris_l.append(f + base)
        mats_l.append(np.full((len(f),), mat, np.int32))

    M_WALL, M_FLOOR, M_COL, M_CEIL = 0, 1, 2, 3

    # Floor (glossy marble) and walls (subdivided so clusters stay local).
    add(*_grid_quad((-L, 0, -W), (2 * L, 0, 0), (0, 0, 2 * W), 48, 20),
        M_FLOOR)
    add(*_grid_quad((-L, 0, -W), (2 * L, 0, 0), (0, H, 0), 48, 18), M_WALL)
    add(*_grid_quad((-L, 0, W), (0, H, 0), (2 * L, 0, 0), 18, 48), M_WALL)
    add(*_grid_quad((-L, 0, -W), (0, H, 0), (0, 0, 2 * W), 18, 20), M_WALL)
    add(*_grid_quad((L, 0, -W), (0, 0, 2 * W), (0, H, 0), 20, 18), M_WALL)

    # Main colonnades: 2 rows x 8 fluted columns on pedestals.
    n_cols = 8
    xs = np.linspace(-L + 2.2, L - 2.2, n_cols)
    for zrow in (-2.6, 2.6):
        for cx in xs:
            add(*_box((cx - 0.55, 0.0, zrow - 0.55),
                      (cx + 0.55, 0.5, zrow + 0.55)), M_COL)       # pedestal
            add(*_column(cx, zrow, 0.42, 0.5, 4.6, col_rad, col_ny), M_COL)
            add(*_box((cx - 0.52, 4.6, zrow - 0.52),
                      (cx + 0.52, 4.95, zrow + 0.52)), M_COL)      # abacus
    # Architrave beams along each colonnade.
    for zrow in (-2.6, 2.6):
        add(*_box((-L + 1.5, 4.95, zrow - 0.4), (L - 1.5, 5.45, zrow + 0.4)),
            M_COL)

    # Gallery: smaller columns above the architrave.
    xs2 = np.linspace(-L + 2.2, L - 2.2, 12)
    for zrow in (-2.6, 2.6):
        for cx in xs2:
            add(*_column(cx, zrow, 0.22, 5.45, 7.6, col_rad // 2,
                         col_ny // 2, flutes=14), M_COL)
    for zrow in (-2.6, 2.6):
        add(*_box((-L + 1.5, 7.6, zrow - 0.3), (L - 1.5, 8.0, zrow + 0.3)),
            M_COL)

    # Coffered ceiling: beams forming a 12x5 grid, recessed panels above,
    # with two skylight openings (no panel) where the area lights sit.
    nbx, nbz = 12, 5
    bx = np.linspace(-L, L, nbx + 1)
    bz = np.linspace(-W, W, nbz + 1)
    for x in bx:
        add(*_box((x - 0.08, H - 0.5, -W), (x + 0.08, H, W)), M_CEIL)
    for z in bz:
        add(*_box((-L, H - 0.5, z - 0.08), (L, H, z + 0.08)), M_CEIL)
    # Open coffers = skylights: two double-width openings, each covered by
    # ONE area light spanning both cells (2 lights total keeps the NEE
    # loop short; wider quads raise the solid angle -> less shadow noise).
    sky = {(3, 2), (4, 2), (8, 2), (9, 2)}
    sky_lights = [((3, 2), 2), ((8, 2), 2)]  # (origin cell, cells wide in x)
    for i in range(nbx):
        for j in range(nbz):
            if (i, j) in sky:
                continue
            v, f = _grid_quad((bx[i], H - 0.1, bz[j]),
                              (bx[i + 1] - bx[i], 0, 0),
                              (0, 0, bz[j + 1] - bz[j]), 3, 3)
            add(v, f, M_CEIL)

    verts = np.concatenate(verts_l, 0)
    tris = np.concatenate(tris_l, 0)
    mats = np.concatenate(mats_l, 0)

    lights = make_lights([
        dict(kind=LIGHT_AREA, position=(bx[i], H - 0.05, bz[j]),
             edge_x=(bx[i + nx] - bx[i], 0, 0),
             edge_y=(0, 0, bz[j + 1] - bz[j]), normal=(0, -1, 0),
             radiance=(light_scale, light_scale, light_scale * 0.92))
        for ((i, j), nx) in sky_lights
    ])
    materials = make_materials([
        dict(kind=MAT_DIFFUSE, albedo=(0.68, 0.64, 0.58)),            # wall
        dict(kind=MAT_GGX, albedo=(0.55, 0.55, 0.6), roughness=0.3),  # floor
        dict(kind=MAT_DIFFUSE, albedo=(0.72, 0.7, 0.66)),             # column
        dict(kind=MAT_DIFFUSE, albedo=(0.5, 0.46, 0.42)),             # ceiling
    ])
    return make_scene(vertices=verts, tri_idx=tris, tri_mat=mats,
                      materials=materials, lights=lights)


def atrium_camera(width: int, height: int):
    """Down-the-nave view: primary rays cross both colonnades."""
    from tpu_pt_torch.core.camera import Camera

    return Camera.look_at(
        eye=(-10.5, 2.1, 0.9), target=(11.0, 3.2, -0.6), hfov=62.0,
        aspect=width / height,
    )
