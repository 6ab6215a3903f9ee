"""Minimal COLLADA (.dae) loader (stdlib ElementTree and numpy): the port's
copy of ``tpu_pt/scene/collada.py``.

Supports the subset the CMU462 scene family uses:

  - library_geometries: <triangles>/<polylist> with VERTEX (+NORMAL) inputs,
    polygon fan-triangulation; <sphere> primitives;
  - library_effects/materials: lambert/phong <diffuse> color, <emission>,
    <reflectivity> (mirror), <index_of_refraction> (glass);
  - library_cameras: <perspective> xfov/yfov;
  - library_lights: <point>, <directional>, <spot> (falloff angle and
    exponent), <ambient> (a dim hemisphere light), and <extra> area lights;
  - library_visual_scenes: node hierarchy with <matrix>, <translate>,
    <rotate>, <scale> transforms; instance_geometry material binding.

Emissive meshes register LIGHT_TRI area lights per triangle.  Returns a host
scene (numpy arrays) and a camera function giving the port's
``core.camera.Camera``.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from typing import Dict, List, Optional

import numpy as np

from tpu_pt_torch.core.camera import Camera
from tpu_pt_torch.scene.types import (
    LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE, LIGHT_POINT, LIGHT_TRI,
    MAT_DIFFUSE, MAT_EMISSIVE, MAT_GLASS, MAT_MIRROR,
    make_lights, make_materials, make_scene,
)

_NS = "{http://www.collada.org/2005/11/COLLADASchema}"


def _tag(e):
    return e.tag.split("}")[-1]


def _floats(text):
    return np.asarray((text or "").split(), dtype=np.float64)


def _find(e, name):
    return e.find(f"{_NS}{name}") if e is not None else None


def _findall(e, name):
    return e.findall(f"{_NS}{name}") if e is not None else []


def _parse_effects(root) -> Dict[str, dict]:
    """effect id -> material row dict."""
    out = {}
    lib = _find(root, "library_effects")
    for eff in _findall(lib, "effect"):
        eid = eff.get("id")
        row = dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7))
        for el in eff.iter():
            t = _tag(el)
            if t == "diffuse":
                col = _find(el, "color")
                if col is not None:
                    c = _floats(col.text)[:3]
                    row["albedo"] = tuple(float(x) for x in c)
            elif t == "emission":
                col = _find(el, "color")
                if col is not None:
                    c = _floats(col.text)[:3]
                    if float(np.max(c[:3])) > 0:
                        row["kind"] = MAT_EMISSIVE
                        row["emission"] = tuple(float(x) for x in c)
            elif t == "reflectivity":
                f = _find(el, "float")
                if f is not None and float(f.text) > 0.9:
                    row["kind"] = MAT_MIRROR
            elif t == "index_of_refraction":
                f = _find(el, "float")
                if f is not None and abs(float(f.text) - 1.0) > 1e-3:
                    row["kind"] = MAT_GLASS
                    row["ior"] = float(f.text)
        out[eid] = row
    return out


def _parse_materials(root, effects) -> Dict[str, dict]:
    """material id -> row dict (resolves instance_effect)."""
    out = {}
    lib = _find(root, "library_materials")
    for mat in _findall(lib, "material"):
        mid = mat.get("id")
        ie = _find(mat, "instance_effect")
        url = (ie.get("url") or "").lstrip("#") if ie is not None else ""
        out[mid] = effects.get(url, dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7)))
    return out


def _parse_sources(geom) -> Dict[str, np.ndarray]:
    out = {}
    for src in geom.iter(f"{_NS}source"):
        arr = _find(src, "float_array")
        if arr is not None:
            out[src.get("id")] = _floats(arr.text).reshape(-1, 3)
    return out


def _node_transform(node) -> np.ndarray:
    """Compose the node's transform elements into a 4x4 matrix."""
    m = np.eye(4)
    for el in node:
        t = _tag(el)
        if t == "matrix":
            m = m @ _floats(el.text).reshape(4, 4)
        elif t == "translate":
            tr = np.eye(4)
            tr[:3, 3] = _floats(el.text)[:3]
            m = m @ tr
        elif t == "scale":
            s = np.eye(4)
            np.fill_diagonal(s[:3, :3], _floats(el.text)[:3])
            m = m @ s
        elif t == "rotate":
            v = _floats(el.text)
            axis = v[:3]
            ang = np.radians(v[3])
            axis = axis / max(np.linalg.norm(axis), 1e-12)
            x, y, z = axis
            c, s_ = np.cos(ang), np.sin(ang)
            r = np.eye(4)
            r[:3, :3] = [
                [c + x * x * (1 - c), x * y * (1 - c) - z * s_, x * z * (1 - c) + y * s_],
                [y * x * (1 - c) + z * s_, c + y * y * (1 - c), y * z * (1 - c) - x * s_],
                [z * x * (1 - c) - y * s_, z * y * (1 - c) + x * s_, c + z * z * (1 - c)],
            ]
            m = m @ r
    return m


def load(path: str):
    """Load a .dae file -> (Scene, camera_fn)."""
    root = ET.parse(path).getroot()
    effects = _parse_effects(root)
    materials = _parse_materials(root, effects)

    # Geometry library: id -> list of (verts, tris, normals?, material symbol)
    geoms: Dict[str, list] = {}
    sphere_geoms: Dict[str, list] = {}
    lib_g = _find(root, "library_geometries")
    for geom in _findall(lib_g, "geometry"):
        gid = geom.get("id")
        mesh = _find(geom, "mesh")
        if mesh is None:
            continue
        sources = _parse_sources(geom)
        vert_el = _find(mesh, "vertices")
        vert_src = {}
        if vert_el is not None:
            for inp in _findall(vert_el, "input"):
                if inp.get("semantic") == "POSITION":
                    vert_src[vert_el.get("id")] = sources.get(
                        inp.get("source").lstrip("#")
                    )
        prims = []
        for prim in list(mesh):
            t = _tag(prim)
            if t not in ("triangles", "polylist"):
                continue
            inputs = _findall(prim, "input")
            offsets = {}
            max_off = 0
            pos = nrm = None
            for inp in inputs:
                off = int(inp.get("offset", 0))
                max_off = max(max_off, off)
                sem = inp.get("semantic")
                src = inp.get("source").lstrip("#")
                if sem == "VERTEX":
                    pos = vert_src.get(src)
                    offsets["v"] = off
                elif sem == "NORMAL":
                    nrm = sources.get(src)
                    offsets["n"] = off
            stride = max_off + 1
            p_el = _find(prim, "p")
            if p_el is None or pos is None:
                continue
            idx = np.asarray(p_el.text.split(), dtype=np.int64).reshape(-1, stride)
            v_idx = idx[:, offsets["v"]]
            n_idx = idx[:, offsets["n"]] if (nrm is not None
                                             and "n" in offsets) else None
            if t == "polylist":
                vcount = np.asarray(
                    _find(prim, "vcount").text.split(), dtype=np.int64
                )
                tri_v, tri_n = [], []
                c = 0
                for n in vcount:
                    for k in range(1, n - 1):
                        tri_v += [v_idx[c], v_idx[c + k], v_idx[c + k + 1]]
                        if n_idx is not None:
                            tri_n += [n_idx[c], n_idx[c + k], n_idx[c + k + 1]]
                    c += n
                v_idx = np.asarray(tri_v, np.int64)
                n_idx = np.asarray(tri_n, np.int64) if n_idx is not None else None
            prims.append((pos, v_idx.reshape(-1, 3),
                          None if n_idx is None else (nrm, n_idx.reshape(-1, 3)),
                          prim.get("material")))
        # <sphere> primitives (reference: collada/sphere_info — the CMU462
        # schema puts them directly under <geometry> or inside <extra>).
        spheres = []
        for sp in geom.iter(f"{_NS}sphere"):
            r_attr = sp.get("radius")
            if r_attr is None:
                rf = _find(sp, "radius") or _find(sp, "float")
                r_attr = rf.text if rf is not None else "1.0"
            spheres.append(float(r_attr))
        geoms[gid] = prims
        if spheres:
            sphere_geoms[gid] = spheres

    # Cameras.
    cam_params = {}
    for c in _findall(_find(root, "library_cameras"), "camera"):
        persp = None
        for el in c.iter():
            if _tag(el) == "perspective":
                persp = el
        if persp is None:
            continue
        xfov = _find(persp, "xfov")
        yfov = _find(persp, "yfov")
        cam_params[c.get("id")] = dict(
            xfov=float(xfov.text) if xfov is not None else None,
            yfov=float(yfov.text) if yfov is not None else None,
        )

    # Lights library.  Beyond the core schema (<point>/<directional>/
    # <ambient>/<spot>), an <extra> technique may author an AREA light
    # (the CMU462 scenes keep their quad area lights in <extra> data): any
    # <extra> descendant tagged <area> (or <area_light>) with size/size_x/
    # size_y children or attributes becomes a quad light spanning the
    # node's local XY plane, emitting down local -Z.
    light_defs = {}
    for l in _findall(_find(root, "library_lights"), "light"):
        for el in l.iter():
            t = _tag(el)
            if t in ("point", "directional", "ambient", "spot"):
                col = _find(el, "color")
                c = tuple(_floats(col.text)[:3]) if col is not None else (1, 1, 1)
                ang = _find(el, "falloff_angle")
                half = float(ang.text) / 2.0 if ang is not None else 22.5
                exp_el = _find(el, "falloff_exponent")
                expo = float(exp_el.text) if exp_el is not None else 0.0
                light_defs[l.get("id")] = (t, c, half, expo)
        for ex_el in l.iter():
            if _tag(ex_el) not in ("area", "area_light"):
                continue

            def _dim(name, default):
                ch = _find(ex_el, name)
                if ch is not None and ch.text:
                    return float(ch.text)
                at = ex_el.get(name)
                return float(at) if at is not None else default

            size = _dim("size", 1.0)
            sx = _dim("size_x", size)
            sy = _dim("size_y", size)
            col = None
            for cand in (ex_el, l):
                cc = _find(cand, "color")
                if cc is not None:
                    col = tuple(_floats(cc.text)[:3])
                    break
            light_defs[l.get("id")] = ("area", col or (1, 1, 1), (sx, sy),
                                       0.0)

    # Visual scene: walk nodes, instance geometry/cameras/lights.
    verts_out: List[np.ndarray] = []
    norms_out: List[Optional[np.ndarray]] = []  # authored normals or None
    tris_out: List[np.ndarray] = []
    mats_out: List[np.ndarray] = []
    sph_center_out: List[tuple] = []
    sph_radius_out: List[float] = []
    sph_mat_out: List[int] = []
    mat_rows: List[dict] = []
    mat_index: Dict[str, int] = {}
    light_rows: List[dict] = []
    cam_pose = None  # (c2w 4x4, cam id)

    def mat_id_for(symbol_target: Optional[str]) -> int:
        row = materials.get(symbol_target or "",
                            dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7)))
        key = repr(sorted(row.items()))
        if key not in mat_index:
            mat_index[key] = len(mat_rows)
            mat_rows.append(row)
        return mat_index[key]

    def walk(node, xf):
        nonlocal cam_pose
        m = xf @ _node_transform(node)
        for el in node:
            t = _tag(el)
            if t == "node":
                walk(el, m)
            elif t == "instance_geometry":
                gid = (el.get("url") or "").lstrip("#")
                binds = {}
                for im in el.iter(f"{_NS}instance_material"):
                    binds[im.get("symbol")] = (im.get("target") or "").lstrip("#")
                for pos, tri_v, nrm_pair, sym in geoms.get(gid, []):
                    mid = mat_id_for(binds.get(sym, sym))
                    if nrm_pair is not None:
                        # Authored normals are per-CORNER (separate index);
                        # split shared positions per unique (pos, nrm) pair
                        # so Scene's per-vertex normal channel is exact.
                        nrm, tri_n = nrm_pair
                        flat_v = tri_v.reshape(-1)
                        flat_n = tri_n.reshape(-1)
                        pairs = np.stack([flat_v, flat_n], axis=1)
                        uniq, inv = np.unique(pairs, axis=0,
                                              return_inverse=True)
                        pos_u = pos[uniq[:, 0]]
                        nrm_u = nrm[uniq[:, 1]]
                        tri_v_local = inv.reshape(-1, 3)
                    else:
                        pos_u = pos
                        nrm_u = None
                        tri_v_local = tri_v
                    v_h = np.concatenate(
                        [pos_u, np.ones((len(pos_u), 1))], axis=1
                    ) @ m.T
                    base = sum(len(v) for v in verts_out)
                    verts_out.append(v_h[:, :3].astype(np.float32))
                    if nrm_u is not None:
                        # Normals transform by the inverse-transpose.
                        nm = np.linalg.inv(m[:3, :3]).T
                        n_w = nrm_u @ nm.T
                        ln = np.linalg.norm(n_w, axis=1, keepdims=True)
                        norms_out.append(
                            (n_w / np.maximum(ln, 1e-20)).astype(np.float32))
                    else:
                        norms_out.append(None)
                    tris_out.append(tri_v_local.astype(np.int64) + base)
                    mats_out.append(np.full(len(tri_v_local), mid, np.int32))
                for radius in sphere_geoms.get(gid, []):
                    mid = mat_id_for(next(iter(binds.values()), None))
                    center = (m @ np.array([0.0, 0.0, 0.0, 1.0]))[:3]
                    # Isotropic scale assumed for spheres (reference
                    # SphereObject has a single radius): use the mean
                    # column scale of the linear part.
                    s = float(np.mean(np.linalg.norm(m[:3, :3], axis=0)))
                    sph_center_out.append(tuple(center))
                    sph_radius_out.append(radius * s)
                    sph_mat_out.append(mid)
            elif t == "instance_camera":
                cam_pose = (m, (el.get("url") or "").lstrip("#"))
            elif t == "instance_light":
                lid = (el.get("url") or "").lstrip("#")
                if lid in light_defs:
                    kind, c, half, expo = light_defs[lid]
                    if kind == "spot":
                        from tpu_pt_torch.scene.types import LIGHT_SPOT

                        d = -m[:3, 2]  # collada spot shines down -z
                        cos_half = float(np.cos(np.deg2rad(half)))
                        # edge_x packs (cos half-angle, falloff exponent):
                        # radiance is scaled by cos(axis angle)^exponent
                        # inside the cone (COLLADA <falloff_exponent>).
                        light_rows.append(dict(
                            kind=LIGHT_SPOT, position=tuple(m[:3, 3]),
                            normal=tuple(d), edge_x=(cos_half, expo, 0),
                            radiance=c,
                        ))
                    elif kind == "area":
                        from tpu_pt_torch.scene.types import LIGHT_AREA

                        sx, sy = half  # (size_x, size_y) for area defs
                        ex_v = m[:3, 0] * sx
                        ey_v = m[:3, 1] * sy
                        org = m[:3, 3] - 0.5 * ex_v - 0.5 * ey_v
                        light_rows.append(dict(
                            kind=LIGHT_AREA, position=tuple(org),
                            edge_x=tuple(ex_v), edge_y=tuple(ey_v),
                            normal=tuple(-m[:3, 2]), radiance=c,
                        ))
                    elif kind == "point":
                        light_rows.append(dict(
                            kind=LIGHT_POINT, position=tuple(m[:3, 3]),
                            radiance=c,
                        ))
                    elif kind == "directional":
                        d = -m[:3, 2]  # collada directional shines down -z
                        light_rows.append(dict(
                            kind=LIGHT_DIRECTIONAL, normal=tuple(d),
                            radiance=c,
                        ))
                    else:  # ambient → dim hemisphere
                        light_rows.append(dict(
                            kind=LIGHT_HEMISPHERE, radiance=tuple(
                                0.5 * np.asarray(c)
                            ),
                        ))

    vs = _find(root, "library_visual_scenes")
    for scene_el in _findall(vs, "visual_scene"):
        for node in _findall(scene_el, "node"):
            walk(node, np.eye(4))

    if not verts_out and not sph_center_out:
        raise ValueError(f"no geometry found in {path}")
    if verts_out:
        vertices = np.concatenate(verts_out, axis=0)
        tri_idx = np.concatenate(tris_out, axis=0).astype(np.int32)
        tri_mat = np.concatenate(mats_out, axis=0)
    else:
        vertices = np.zeros((0, 3), np.float32)
        tri_idx = np.zeros((0, 3), np.int32)
        tri_mat = np.zeros((0,), np.int32)

    # Per-vertex normals: authored where present, area-weighted per chunk
    # where the .dae ships none (reference PolymeshInfo behavior).
    normals = None
    if verts_out and any(n is not None for n in norms_out):
        from tpu_pt_torch.scene.types import _vertex_normals

        parts = []
        base = 0
        for v, n, t in zip(verts_out, norms_out, tris_out):
            if n is None:
                local_t = (np.asarray(t) - base).astype(np.int32)
                n = _vertex_normals(v, local_t)
            parts.append(n)
            base += len(v)
        normals = np.concatenate(parts, axis=0).astype(np.float32)

    # Emissive triangles → LIGHT_TRI rows for next-event estimation.
    for row_id, row in enumerate(mat_rows):
        if row.get("kind") == MAT_EMISSIVE:
            for t in np.where(tri_mat == row_id)[0]:
                a, b, c = tri_idx[t]
                v0, v1, v2 = vertices[a], vertices[b], vertices[c]
                n = np.cross(v1 - v0, v2 - v0)
                ln = np.linalg.norm(n)
                if ln < 1e-12:
                    continue
                light_rows.append(dict(
                    kind=LIGHT_TRI, position=tuple(v0),
                    edge_x=tuple(v1 - v0), edge_y=tuple(v2 - v0),
                    normal=tuple(n / ln), radiance=row["emission"],
                ))

    if not mat_rows:
        mat_rows.append(dict(kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7)))
    scene = make_scene(vertices, tri_idx, tri_mat,
                       make_materials(mat_rows), make_lights(light_rows),
                       normals=normals,
                       sph_center=sph_center_out or None,
                       sph_radius=sph_radius_out or None,
                       sph_mat=sph_mat_out or None)

    all_pts = vertices if len(vertices) else np.asarray(
        sph_center_out, np.float32)
    lo, hi = all_pts.min(axis=0), all_pts.max(axis=0)
    center = (lo + hi) / 2
    diag = float(np.linalg.norm(hi - lo))

    def camera_fn(width: int, height: int) -> Camera:
        if cam_pose is not None:
            m, cid = cam_pose
            p = cam_params.get(cid, {})
            xfov = p.get("xfov")
            yfov = p.get("yfov")
            if xfov is None and yfov is not None:
                xfov = float(np.degrees(2 * np.arctan(
                    np.tan(np.radians(yfov) / 2) * width / height
                )))
            eye = m[:3, 3]
            # COLLADA camera looks down its -z.
            target = eye - m[:3, 2]
            up = m[:3, 1]
            return Camera.look_at(eye=tuple(eye), target=tuple(target),
                                  up=tuple(up), hfov=xfov or 50.0,
                                  aspect=width / height)
        eye = center + np.array([0.0, 0.35, 1.1]) * max(diag, 1e-6)
        return Camera.look_at(eye=tuple(eye), target=tuple(center),
                              hfov=50.0, aspect=width / height)

    return scene, camera_fn
