"""The cluster BVH's pair-major walk (``traversal_mode="pairs"``) at the
headline's own BVH and budgets: big-1m (1,310,722 triangles, the JAX
package's host SAH cluster build), pair_mults (8, 8, 6), batches of 4,096
rays of the 1024² headline camera, against the JAX package's walk on the
same BVH and rays.  Live and dropped pair counts exact."""

import jax
import jax.numpy as jnp
import numpy as np

from tpu_pt.bvh import cluster as jcl
from tpu_pt.core.camera import generate_rays, pixel_xy
from tpu_pt.scene import meshes as jm
from tpu_pt_torch import convert
from tpu_pt_torch.bvh import cluster as tcl

from torch_port_util import T, bvh_dict


# Contiguous blocks of 4,096 pixels of the headline camera (the wavefront's
# respawn order): the first two are the JAX package's own coherent-block
# cases (tests/test_capacity.py), the third the block where the pair-major
# walk cuts most; None: 4,096 seeded random pixels.
HEADLINE_BLOCKS = [None, 0, 512 * 1024 + 512, 384 * 1024]


def test_pairs_cuts_coherent_headline_blocks_as_jax_does():
    """The pair-major walk at the headline BVH's own budgets (big-1m,
    pair_mults (8, 8, 6)): on random pixels it cuts nothing, but on
    coherent blocks of the camera it cuts pairs at the top and middle
    levels, and the JAX package's walk cuts exactly as many (live pairs and
    dropped pairs equal), so the headline render's cut is the reference's
    own.  The per-level cuts add up to the total."""
    sj = jm.big_scene(subdiv=8)
    cj = jcl.build_cluster_bvh(sj)
    assert tuple(cj.pair_mults[:3]) == (8, 8, 6)
    ct = convert.cluster_bvh_from_numpy(bvh_dict(cj), "cpu")
    cj = jax.tree.map(jnp.asarray, cj)
    cam = jm.big_camera(1024, 1024)
    Q = 4096
    stats = jax.jit(jcl.pairs_stats)
    t_min = np.zeros((Q, 1), np.float32)
    t_max = np.full((Q, 1), 1e30, np.float32)
    cut = {}
    for block in HEADLINE_BLOCKS:
        pix = jax.random.randint(jax.random.key(11), (Q,), 0, 1024 * 1024) \
            if block is None else block + jnp.arange(Q, dtype=jnp.int32)
        ro, rd = (np.asarray(x, np.float32) for x in generate_rays(
            cam, pixel_xy(1024, 1024, pix, jnp.full((Q, 2), 0.5))))
        n_j, d_j = stats(cj, *(jnp.asarray(x)
                               for x in (ro, rd, t_min, t_max)))
        col = []
        rayP, _, d_t = tcl._descend_pairs(ct, T(ro), 1.0 / T(rd),
                                          T(t_min[:, 0]), T(t_max[:, 0]),
                                          collect=col)
        assert (int((rayP < Q).sum()), int(d_t)) == (int(n_j), int(d_j))
        assert sum(int(d) for _, d in col) == int(d_t)
        cut[block] = [int(d) for _, d in col]
    assert sum(cut[None]) == 0 and sum(cut[0]) == 0
    assert cut[512 * 1024 + 512][:2] == [4861, 5305]
    assert cut[384 * 1024] == [0, 11655, 0]
