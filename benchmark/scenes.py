"""The benchmark's inputs: scene geometry, lights and camera, made here in
numpy and handed to both the program and the reference.

Each generator is named by a configuration file's ``"geometry"`` entry and
returns a dict of host arrays: ``vertices`` (V, 3) f32, ``tri_idx`` (T, 3)
i32, ``tri_mat`` (T,) i32 and ``lights`` (a list of rows: kind, position,
edge_x, edge_y, normal, radiance).  They make the port's built-in scenes
(``tpu_pt_torch/scene/meshes.py``: ``big_scene``, ``atrium_scene``) array
for array; the icosphere's subdivision is vectorised (the same vertex
order: a midpoint is numbered where its edge first appears), which takes
the Python loop over 1.3 M faces out of every run's set-up.
"""

from __future__ import annotations

import numpy as np

LIGHT_AREA = 0


def _icosphere(subdiv: int):
    """Unit icosphere (verts (V, 3) f32, tris (T, 3) i32), T = 20 * 4^subdiv."""
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
        n = len(v)
        a, b, c = f[:, 0], f[:, 1], f[:, 2]
        # Edges in the order the faces visit them: (a, b), (b, c), (c, a).
        e0 = np.stack([a, b, c], 1).reshape(-1)
        e1 = np.stack([b, c, a], 1).reshape(-1)
        lo, hi = np.minimum(e0, e1), np.maximum(e0, e1)
        keys = lo * n + hi
        uniq, first, inv = np.unique(keys, return_index=True,
                                     return_inverse=True)
        # A new vertex takes its number where its edge first appears.
        order = np.argsort(first, kind="stable")
        rank = np.empty_like(order)
        rank[order] = np.arange(len(order))
        mid_id = n + rank[inv].reshape(-1, 3)          # (F, 3): ab, bc, ca
        ea, eb = e0[first[order]], e1[first[order]]
        m = (v[ea] + v[eb]) / 2.0
        m = m / np.sqrt(np.einsum("ij,ij->i", m, m))[:, None]
        v = np.concatenate([v, m], 0)
        ab, bc, ca = mid_id[:, 0], mid_id[:, 1], mid_id[:, 2]
        f = np.stack([
            np.stack([a, ab, ca], 1), np.stack([b, bc, ab], 1),
            np.stack([c, ca, bc], 1), np.stack([ab, bc, ca], 1),
        ], 1).reshape(-1, 3)
    return v.astype(np.float32), f.astype(np.int32)


def _displaced_sphere(subdiv: int, amp: float, freq: float, seed: int):
    v, f = _icosphere(subdiv)
    rng = np.random.RandomState(seed)
    d = np.zeros(len(v), np.float32)
    for o in range(4):
        k = rng.normal(size=(3, 3)).astype(np.float32) * freq * (1.6 ** o)
        ph = rng.uniform(0, 2 * np.pi, size=3).astype(np.float32)
        for j in range(3):
            d += (amp / (2.0 ** o)) * np.sin(v @ k[j] + ph[j]).astype(np.float32)
    v = v * (1.0 + d[:, None] * 0.35)
    return v.astype(np.float32), f


def big(subdiv: int = 8, width_light: float = 4.0):
    """A displaced icosphere (20 * 4^subdiv triangles) over a ground plane of
    two triangles, under one area light."""
    mv, mt = _displaced_sphere(subdiv, amp=0.15, freq=9.0, seed=0)
    mv = mv * 1.0 + np.array([0.0, 1.4, 0.0], np.float32)
    base = len(mv)
    g = 6.0
    ground = np.array([(-g, 0, -g), (-g, 0, g), (g, 0, g), (g, 0, -g)],
                      np.float32)
    verts = np.concatenate([mv, ground], 0)
    tris = np.concatenate([mt, np.array([(base, base + 1, base + 2),
                                         (base, base + 2, base + 3)],
                                        np.int32)], 0)
    mats = np.concatenate([np.zeros(len(mt), np.int32),
                           np.ones(2, np.int32)])
    w = width_light / 2
    lights = [dict(kind=LIGHT_AREA, position=(-w, 5.0, -w),
                   edge_x=(width_light, 0, 0), edge_y=(0, 0, width_light),
                   normal=(0, -1, 0), radiance=(10.0, 10.0, 10.0))]
    return dict(vertices=verts.astype(np.float32),
                tri_idx=tris.astype(np.int32), tri_mat=mats, lights=lights)


def _grid_quad(p0, ex, ey, nx, ny):
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
    th = np.linspace(0, 2 * np.pi, n_rad, endpoint=False, dtype=np.float32)
    ys = np.linspace(y0, y1, n_y + 1, dtype=np.float32)
    s = (ys - y0) / max(y1 - y0, 1e-6)
    taper = 1.0 - 0.18 * s * s
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
    x0, y0, z0 = np.asarray(lo, np.float32)
    x1, y1, z1 = np.asarray(hi, np.float32)
    v = np.array([
        (x0, y0, z0), (x1, y0, z0), (x1, y1, z0), (x0, y1, z0),
        (x0, y0, z1), (x1, y0, z1), (x1, y1, z1), (x0, y1, z1),
    ], np.float32)
    f = np.array([
        (0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7), (0, 1, 5), (0, 5, 4),
        (3, 7, 6), (3, 6, 2), (0, 4, 7), (0, 7, 3), (1, 2, 6), (1, 6, 5),
    ], np.int32)
    return v, f


def atrium(col_rad: int = 128, col_ny: int = 184, light_scale: float = 30.0):
    """An interior hall of about 1 M triangles: two colonnades of fluted
    columns on pedestals, a gallery of smaller columns, a coffered ceiling
    with two skylight area lights.  Materials: 0 wall, 1 floor, 2 column,
    3 ceiling."""
    L, W, H = 12.0, 5.0, 9.0
    verts_l, tris_l, mats_l = [], [], []

    def add(v, f, mat):
        base = sum(len(x) for x in verts_l)
        verts_l.append(v)
        tris_l.append(f + base)
        mats_l.append(np.full((len(f),), mat, np.int32))

    M_WALL, M_FLOOR, M_COL, M_CEIL = 0, 1, 2, 3
    add(*_grid_quad((-L, 0, -W), (2 * L, 0, 0), (0, 0, 2 * W), 48, 20),
        M_FLOOR)
    add(*_grid_quad((-L, 0, -W), (2 * L, 0, 0), (0, H, 0), 48, 18), M_WALL)
    add(*_grid_quad((-L, 0, W), (0, H, 0), (2 * L, 0, 0), 18, 48), M_WALL)
    add(*_grid_quad((-L, 0, -W), (0, H, 0), (0, 0, 2 * W), 18, 20), M_WALL)
    add(*_grid_quad((L, 0, -W), (0, 0, 2 * W), (0, H, 0), 20, 18), M_WALL)
    xs = np.linspace(-L + 2.2, L - 2.2, 8)
    for zrow in (-2.6, 2.6):
        for cx in xs:
            add(*_box((cx - 0.55, 0.0, zrow - 0.55),
                      (cx + 0.55, 0.5, zrow + 0.55)), M_COL)
            add(*_column(cx, zrow, 0.42, 0.5, 4.6, col_rad, col_ny), M_COL)
            add(*_box((cx - 0.52, 4.6, zrow - 0.52),
                      (cx + 0.52, 4.95, zrow + 0.52)), M_COL)
    for zrow in (-2.6, 2.6):
        add(*_box((-L + 1.5, 4.95, zrow - 0.4), (L - 1.5, 5.45, zrow + 0.4)),
            M_COL)
    xs2 = np.linspace(-L + 2.2, L - 2.2, 12)
    for zrow in (-2.6, 2.6):
        for cx in xs2:
            add(*_column(cx, zrow, 0.22, 5.45, 7.6, col_rad // 2,
                         col_ny // 2, flutes=14), M_COL)
    for zrow in (-2.6, 2.6):
        add(*_box((-L + 1.5, 7.6, zrow - 0.3), (L - 1.5, 8.0, zrow + 0.3)),
            M_COL)
    nbx, nbz = 12, 5
    bx = np.linspace(-L, L, nbx + 1)
    bz = np.linspace(-W, W, nbz + 1)
    for x in bx:
        add(*_box((x - 0.08, H - 0.5, -W), (x + 0.08, H, W)), M_CEIL)
    for z in bz:
        add(*_box((-L, H - 0.5, z - 0.08), (L, H, z + 0.08)), M_CEIL)
    sky = {(3, 2), (4, 2), (8, 2), (9, 2)}
    sky_lights = [((3, 2), 2), ((8, 2), 2)]
    for i in range(nbx):
        for j in range(nbz):
            if (i, j) in sky:
                continue
            v, f = _grid_quad((bx[i], H - 0.1, bz[j]),
                              (bx[i + 1] - bx[i], 0, 0),
                              (0, 0, bz[j + 1] - bz[j]), 3, 3)
            add(v, f, M_CEIL)
    lights = [dict(kind=LIGHT_AREA, position=(bx[i], H - 0.05, bz[j]),
                   edge_x=(bx[i + nx] - bx[i], 0, 0),
                   edge_y=(0, 0, bz[j + 1] - bz[j]), normal=(0, -1, 0),
                   radiance=(light_scale, light_scale, light_scale * 0.92))
              for ((i, j), nx) in sky_lights]
    return dict(vertices=np.concatenate(verts_l, 0),
                tri_idx=np.concatenate(tris_l, 0),
                tri_mat=np.concatenate(mats_l, 0), lights=lights)


GENERATORS = {"big": big, "atrium": atrium}


def look_at(eye, target, hfov, aspect, up=(0.0, 1.0, 0.0)):
    """Pinhole camera looking down its -z axis: (c2w (3, 3) f32, origin (3,)
    f32, hfov, vfov) in degrees, vfov from hfov and the aspect w / h."""
    eye = np.asarray(eye, np.float32)
    target = np.asarray(target, np.float32)
    up = np.asarray(up, np.float32)
    z = eye - target
    z = z / np.linalg.norm(z)
    x = np.cross(up, z)
    x = x / np.linalg.norm(x)
    y = np.cross(z, x)
    c2w = np.stack([x, y, z], axis=1).astype(np.float32)
    vfov = float(2.0 * np.degrees(np.arctan(np.tan(np.radians(hfov) / 2.0)
                                            / aspect)))
    return c2w, eye, np.float32(hfov), np.float32(vfov)


def make(config: dict):
    """The configuration's geometry, lights and camera: (geometry dict,
    camera tuple)."""
    g = dict(config["geometry"])
    geo = GENERATORS[g.pop("generator")](**g)
    r = config["render"]
    cam = look_at(config["camera"]["eye"], config["camera"]["target"],
                  config["camera"]["hfov"], r["width"] / r["height"])
    return geo, cam
