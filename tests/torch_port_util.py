"""Helpers shared by the tests/test_torch_*.py parity tests: flatten the JAX
package's containers into plain dicts of numpy arrays (the input format of
``tpu_pt_torch.convert``) and make seeded numpy inputs for both packages.

Imported by every test_torch_*.py file: under pytest-xdist it gives each
worker process its share of the cores for torch's intra-op threads, so that
N workers do not each start one thread per core."""

import functools
import os

import numpy as np
import torch

if os.environ.get("PYTEST_XDIST_WORKER_COUNT"):
    torch.set_num_threads(max(
        1, (os.cpu_count() or 1) // int(os.environ["PYTEST_XDIST_WORKER_COUNT"])))


def T(x):
    """Array -> CPU tensor (dtype kept; a copy, so read-only buffers of the
    other framework are never aliased)."""
    return torch.from_numpy(np.array(x, order="C"))


def scene_dict(scene) -> dict:
    d = {f: np.asarray(getattr(scene, f)) for f in scene._fields
         if f not in ("materials", "lights")}
    d["materials"] = {f: np.asarray(getattr(scene.materials, f))
                      for f in scene.materials._fields}
    d["lights"] = {f: np.asarray(getattr(scene.lights, f))
                   for f in scene.lights._fields}
    return d


def bvh_dict(cb) -> dict:
    return dict(
        levels=[np.asarray(lv) for lv in cb.levels],
        tiles=np.asarray(cb.tiles), tile_gid=np.asarray(cb.tile_gid),
        frontiers=cb.frontiers, k_leaf=cb.k_leaf, pair_budget=cb.pair_budget,
        pair_mults=cb.pair_mults,
        levels16=[np.asarray(lv).view(np.uint16) for lv in cb.levels16])


def camera_dict(cam) -> dict:
    return {f: np.asarray(getattr(cam, f)) for f in cam._fields}


def rays(n: int, seed: int):
    """Random origins in [-3, 3)^3 and unit directions, float32 numpy."""
    rs = np.random.RandomState(seed)
    ro = rs.uniform(-3, 3, (n, 3)).astype(np.float32)
    rd = rs.normal(size=(n, 3))
    rd = (rd / np.linalg.norm(rd, axis=-1, keepdims=True)).astype(np.float32)
    return ro, rd


def assert_tree_equal(a, b):
    """Field-by-field array equality of two (nested) NamedTuples; ``b`` may
    hold numpy arrays or tensors."""
    assert a._fields == b._fields
    for f in a._fields:
        x, y = getattr(a, f), getattr(b, f)
        if hasattr(x, "_fields"):
            assert_tree_equal(x, y)
        else:
            y = y.numpy() if torch.is_tensor(y) else np.asarray(y)
            x = np.asarray(x)
            assert x.dtype == y.dtype, (f, x.dtype, y.dtype)
            np.testing.assert_array_equal(x, y, err_msg=f)


def chunks_seen(monkeypatch, inputs=None):
    """Spy on the differentiable loop's checkpoint
    (``tpu_pt_torch.render.wavefront.checkpoint``): the list of every chunk
    it is given, in order (each a ``_Chunk``: ``n`` steps run, ``replays``
    recomputations, ``records``), while ``monkeypatch`` holds; each call's
    inputs are appended to ``inputs`` where a list is given."""
    from tpu_pt_torch.render import wavefront

    seen = []
    real = wavefront.checkpoint

    def spy(fn, *a, **kw):
        seen.append(fn)
        if inputs is not None:
            inputs.append(a)
        return real(fn, *a, **kw)

    monkeypatch.setattr(wavefront, "checkpoint", spy)
    return seen


def brute_in_chunks(scene, ro, rd, t_min, t_max, n: int = 500):
    """``tpu_pt_torch.render.brute.intersect`` over chunks of ``n`` rays
    (it holds (R, T) arrays), concatenated into one ``Hit``."""
    from tpu_pt_torch.render import brute

    outs = [brute.intersect(scene, *(x[i:i + n] for x in (ro, rd, t_min,
                                                           t_max)))
            for i in range(0, ro.shape[0], n)]
    return brute.Hit(*(torch.cat(f) for f in zip(*outs)))


def witness_scene(scene, ro, rd, t_min, t_max):
    """(R,) float64 t of the nearest hit of numpy rays in [t_min, t_max] on
    a port scene of CPU tensors, inf where none: triangles through the
    port's brute-force Moller-Trumbore (the two packages agree there to an
    ulp), spheres through the float64 solve
    (``tpu_pt_torch/tools/sphere_edges.py::solve64``, the textbook
    quadratic, written independently of the port's).  The witness of rows
    where the packages' sphere solves part."""
    from tpu_pt_torch.core.intersect import ray_triangle
    from tpu_pt_torch.render.brute import _tri_soa
    from tpu_pt_torch.tools.sphere_edges import solve64

    t_min, t_max = (np.broadcast_to(np.reshape(x, (-1,)), (ro.shape[0],))
                    for x in (t_min, t_max))
    v0, e1, e2 = _tri_soa(scene)
    hit, t, _, _ = ray_triangle(T(ro)[:, None], T(rd)[:, None], v0[None],
                                e1[None], e2[None], T(t_min)[:, None, None],
                                T(t_max)[:, None, None])
    t_tri = np.where(hit[..., 0].numpy(), t[..., 0].numpy(), np.inf).min(1)
    t_sph = solve64(ro[:, None], rd[:, None], scene.sph_center.numpy()[None],
                    scene.sph_radius.numpy()[None], t_min[:, None],
                    t_max[:, None]).min(1)
    return np.minimum(t_tri, t_sph)


def witness_lanes(tiles, ro, rd, t_min, t_max):
    """(P, L) float64 t of rays (P,) on their tiles ((P, 12, L), numpy
    float32), inf on a miss: triangle lanes through the port's tile test
    (``kernels/cluster_isect.py::_mt_group``), sphere lanes through the
    float64 solve, as in :func:`witness_scene`."""
    from tpu_pt_torch.core.intersect import INF
    from tpu_pt_torch.kernels.cluster_isect import _mt_group
    from tpu_pt_torch.tools.sphere_edges import solve64

    P = tiles.shape[0]
    t_min, t_max = (np.broadcast_to(np.reshape(x, (-1,)), (P,))
                    for x in (t_min, t_max))
    rays = np.zeros((P, 16), np.float32)
    rays[:, 0:3], rays[:, 3:6], rays[:, 6], rays[:, 7] = ro, rd, t_min, t_max
    rays[:, 8] = 1.0
    t32 = _mt_group(T(tiles), T(rays))[0].numpy().astype(np.float64)
    t32[t32 >= INF] = np.inf
    t64 = solve64(ro[:, None], rd[:, None], np.moveaxis(tiles[:, 0:3], 1, 2),
                  tiles[:, 3], t_min[:, None], t_max[:, None])
    return np.where(tiles[:, 9] > 0.5, t64, t32)


def hold_apart_to_witness(apart, t, t_j, t_w, rtol=1e-6, atol=1e-6):
    """Rows where the port (t) and the JAX package (t_j) are apart, both
    numpy with INF (1e30) or inf for a miss: on each the port must be the
    float64 witness's (t_w, inf for a miss): the same hit bit, t within
    rtol / atol, and the JAX package the farther one from it (the other
    hit bit, or t farther off).  Returns (rows, largest |t - t_j| among
    rows where both hit)."""
    t, t_j, t_w = (np.asarray(x, np.float64).reshape(-1) for x in
                   (t, t_j, t_w))
    r = np.flatnonzero(np.asarray(apart).reshape(-1))
    hit, hit_j, hit_w = t[r] < 1e30, t_j[r] < 1e30, t_w[r] < np.inf
    np.testing.assert_array_equal(hit, hit_w, err_msg="hit bit vs float64")
    np.testing.assert_allclose(t[r][hit], t_w[r][hit], rtol=rtol, atol=atol,
                               err_msg="t vs float64")
    err, err_j = np.abs(t[r] - t_w[r]), np.abs(t_j[r] - t_w[r])
    jax_farther = (hit_j != hit_w) | (hit_w & (err_j > err))
    assert jax_farther.all(), ("the JAX package is not the farther one",
                               r[~jax_farther])
    both = hit & hit_j
    size = float(np.abs(t[r] - t_j[r])[both].max()) if both.any() else 0.0
    print(f"held to the float64 witness: {len(r)} rows (hit bits apart "
          f"{int((hit != hit_j).sum())}, largest |t - t_jax| {size:.3g})")
    return len(r), size


def hold_occluded_to_witness(occ, occ_j, scene, ro, rd, t_max):
    """:func:`hold_apart_to_witness` for any-hit bits ((R, 1) bool, t_min
    0): the rows where they differ must be the witness's.  Returns their
    count."""
    t_w = witness_scene(scene, ro, rd, 0.0, t_max)
    n, _ = hold_apart_to_witness(occ != occ_j, np.where(occ, 1.0, 1e30),
                                 np.where(occ_j, 1.0, 1e30),
                                 np.where(t_w < np.inf, 1.0, np.inf))
    return n


def assert_hits_equal(h, ref, label=""):
    """Two ``Hit``s equal bit for bit: hit and t on every ray; prim, u and
    v where ``ref`` hits (brute force names primitive 0, with its u and v,
    where nothing hits, and a walk slot 0's primitive and zeros)."""
    m = ref.hit[:, 0]
    for f in ("hit", "t"):
        assert torch.equal(getattr(h, f), getattr(ref, f)), (label, f)
    for f in ("prim", "u", "v"):
        assert torch.equal(getattr(h, f)[m], getattr(ref, f)[m]), (label, f)


@functools.lru_cache(maxsize=None)
def atrium_upward():
    """The coplanar-face case of the walk tests: the JAX package's reduced
    atrium (``atrium_scene(col_rad=16, col_ny=6)``, 12,708 triangles) and
    the port's scene of the same arrays, 20,000 seeded rays from the hall
    aimed upward at the crossing ceiling beams (t bounds (R, 1) tensors),
    and the port's brute-force nearest hit of each ray.  Made once a
    process (the brute force takes about 40 s on one core); callers must
    not write into what it returns."""
    from tpu_pt.scene import meshes as jm
    from tpu_pt_torch import convert

    sj = jm.atrium_scene(col_rad=16, col_ny=6)
    st = convert.scene_from_numpy(scene_dict(sj), "cpu")
    rs = np.random.RandomState(0)
    R = 20000
    ro = rs.uniform([-11, 0.5, -4.5], [11, 8.0, 4.5],
                    (R, 3)).astype(np.float32)
    rd = rs.normal(size=(R, 3))
    rd[:, 1] = np.abs(rd[:, 1]) * 2                     # up, to the beams
    rd = (rd / np.linalg.norm(rd, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.zeros((R, 1), np.float32)
    t_max = np.full((R, 1), 1e30, np.float32)
    args = tuple(T(x) for x in (ro, rd, t_min, t_max))
    return sj, st, args, brute_in_chunks(st, *args)


@functools.lru_cache(maxsize=None)
def atrium_upward_jax_brute():
    """The JAX package's brute-force nearest hit (``tpu_pt/render/brute.py``)
    of :func:`atrium_upward`'s rays, as numpy arrays (hit, t, prim), in
    jitted chunks of 1,000 rays."""
    import jax
    import jax.numpy as jnp
    from tpu_pt.render import brute as jbrute

    sj, _, args, _ = atrium_upward()
    f = jax.jit(lambda *a: jbrute.intersect(sj, *a))
    outs = [f(*(jnp.asarray(x[i:i + 1000].numpy()) for x in args))
            for i in range(0, args[0].shape[0], 1000)]
    return tuple(np.concatenate([np.asarray(getattr(h, k)) for h in outs])
                 for k in ("hit", "t", "prim"))
