"""The port's host-side mesh tooling (tpu_pt_torch.scene.{halfedge,graph})
against the JAX package's on the same seeded meshes and edits: the
half-edge arrays after flip / split / collapse, Loop subdivision, and the
scene graph's flattened scene and camera after an edit, all equal."""

import numpy as np
import pytest

from tpu_pt.scene import graph as jg
from tpu_pt.scene import halfedge as jh
from tpu_pt.scene import meshes as jm
from tpu_pt_torch.scene import graph as tg
from tpu_pt_torch.scene import halfedge as th
from tpu_pt_torch.scene import meshes as tm
from tpu_pt_torch.scene.types import LIGHT_AREA, LIGHT_POINT, MAT_DIFFUSE

from torch_port_util import assert_tree_equal, camera_dict

FIELDS = ("verts", "vert_he", "face", "next_", "vert", "twin")


def _same_mesh(mj, mt):
    for f in FIELDS:
        a, b = getattr(mj, f), getattr(mt, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for x, y in zip(mj.to_arrays(), mt.to_arrays()):
        np.testing.assert_array_equal(x, y)


def _strip():
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


@pytest.mark.parametrize("mesh", ["strip", "icosphere"])
def test_halfedge_edits_equal_jax(mesh):
    if mesh == "strip":
        v, f = _strip()
    else:
        v, f = tm.icosphere(subdiv=1)
        np.testing.assert_array_equal(v, jm.icosphere(subdiv=1)[0])
    # Copies: the mesh keeps the index array it is given and edits it.
    mj, mt = jh.HalfedgeMesh(v, f.copy()), th.HalfedgeMesh(v, f.copy())
    _same_mesh(mj, mt)
    rs = np.random.RandomState(3)
    for op in ("flip", "split", "collapse", "flip", "collapse", "split"):
        he = int(rs.randint(len(mj.vert)))
        if op == "flip":
            assert mj.flip_edge(he) == mt.flip_edge(he)
        elif op == "split":
            assert mj.split_edge(he) == mt.split_edge(he)
        else:
            assert mj.collapse_edge(he) == mt.collapse_edge(he)
        _same_mesh(mj, mt)
    for vtx in range(min(4, mj.n_verts)):
        assert mj.vertex_neighbors(vtx) == mt.vertex_neighbors(vtx)
        assert mj.is_boundary_vertex(vtx) == mt.is_boundary_vertex(vtx)


def test_collapse_refusal_and_non_manifold_equal_jax():
    tet_v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], np.float32)
    tet_f = np.array([[0, 2, 1], [0, 1, 3], [0, 3, 2], [1, 2, 3]], np.int64)
    mj, mt = (jh.HalfedgeMesh(tet_v, tet_f.copy()),
              th.HalfedgeMesh(tet_v, tet_f.copy()))
    assert mj.collapse_edge(0) == mt.collapse_edge(0) == -1
    _same_mesh(mj, mt)
    bad = np.array([[0, 1, 2], [0, 1, 3]], np.int64)
    for mod in (jh, th):
        with pytest.raises(ValueError, match="non-manifold"):
            mod.HalfedgeMesh(tet_v, bad)


@pytest.mark.parametrize("rounds,mesh", [(1, "tri"), (2, "icosphere"),
                                         (1, "strip")])
def test_loop_subdivide_equals_jax(rounds, mesh):
    if mesh == "tri":
        v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
        f = np.array([[0, 1, 2]])
    elif mesh == "strip":
        v, f = _strip()
    else:
        v, f = tm.icosphere(subdiv=1)
    for x, y in zip(jh.loop_subdivide(v, f, rounds),
                    th.loop_subdivide(v, f, rounds)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def _graph(g, mat):
    """The same graph in either package's module ``g``."""
    sg = g.SceneGraph()
    sg.set_material("white", kind=MAT_DIFFUSE, albedo=(0.7, 0.7, 0.7))
    sg.set_material("red", kind=MAT_DIFFUSE, albedo=(0.8, 0.1, 0.1))
    floor = np.array([[-2, 0, -2], [-2, 0, 2], [2, 0, 2], [2, 0, -2]],
                     np.float32)
    tri = dict(vertices=np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]],
                                 np.float32),
               tris=np.array([[0, 1, 2]], np.int32), material="red")
    sg.root.add(g.Node(name="floor", mesh=dict(
        vertices=floor, tris=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        material="white")))
    arm = sg.root.add(g.Node(name="arm", transform=g.translate((0, 1, 0))
                             @ g.rotate((0, 1, 1), 30)))
    arm.add(g.Node(name="a", mesh=tri))
    arm.add(g.Node(name="b", transform=g.scale((1, 2, 0.5)), mesh=tri))
    arm.add(g.Node(name="ball", transform=g.scale(1.5),
                   sphere=dict(center=(1, 0, 0), radius=0.25,
                               material=mat)))
    sg.root.add(g.Node(name="lamp", transform=g.translate((0, 2, 0)),
                       light=dict(kind=LIGHT_POINT, position=(0, 0, 0),
                                  radiance=(10, 10, 10))))
    sg.root.add(g.Node(name="quad", transform=g.rotate((1, 0, 0), 20),
                       light=dict(kind=LIGHT_AREA, position=(0, 3, 0),
                                  edge_x=(1, 0, 0), edge_y=(0, 0, 1),
                                  normal=(0, -1, 0), radiance=(4, 4, 4))))
    sg.root.add(g.Node(name="cam", transform=g.translate((0, 0, 1)),
                       camera=dict(eye=(0, 3, 2), target=(0, 0, 0),
                                   up=(0, 1, 0), hfov=60)))
    return sg


def test_scene_graph_edit_equals_jax():
    gj, gt = _graph(jg, "red"), _graph(tg, "red")
    for step in range(2):
        sj, st = gj.get_static_scene(), gt.get_static_scene()
        assert_tree_equal(sj, st)
        cj, ct = camera_dict(gj.get_camera(16, 8)), \
            camera_dict(gt.get_camera(16, 8))
        for k in cj:
            np.testing.assert_array_equal(cj[k], ct[k], err_msg=k)
        # The edit: move the lamp, turn the arm, recolour, add a sky.
        for g, sg in ((jg, gj), (tg, gt)):
            sg.node("lamp").transform = g.translate((0, 4, 0))
            sg.node("arm").transform = g.rotate((1, 0, 0), 45)
            sg.set_material("red", kind=MAT_DIFFUSE, albedo=(0.2, 0.9, 0.1))
            sg.env_map = np.full((2, 4, 3), 0.5, np.float32)
    assert tg.SceneGraph().get_camera(4, 4) is None
