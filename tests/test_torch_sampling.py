"""Counter-based RNG of the PyTorch port vs tpu_pt.core.sampling: bitwise."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_pt.core import sampling as js
from tpu_pt_torch.core import sampling as ts

from torch_port_util import T

MAX_RAY = (1 << 20) * 64          # 1024^2 pixels x 64 spp
MAX_DRAW = 1 + 5 * 64 + 49        # depth 5, russian-roulette draw


def _ids(seed, n=4096):
    rs = np.random.RandomState(seed)
    rid = rs.randint(0, MAX_RAY, size=n).astype(np.int32)
    did = rs.randint(0, MAX_DRAW + 1, size=n).astype(np.int32)
    rid[:6] = [0, 1, MAX_RAY - 1, -1, 12345, MAX_RAY]   # -1 = idle lane
    did[:6] = [0, MAX_DRAW, 65, 7, 49, 1]
    return rid, did


@pytest.mark.parametrize("key_i", [0, 3, 12345, 2**31 - 1])
@pytest.mark.parametrize("n", [1, 2, 3])
def test_draws_lane_bitwise(key_i, n):
    rid, did = _ids(key_i % 97)
    a = np.asarray(js.draws_lane(jax.random.key(key_i), jnp.asarray(rid),
                                 jnp.asarray(did), n))
    b = ts.draws_lane((0, key_i), T(rid), T(did), n).numpy()
    assert a.dtype == b.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    # int64 ids (the port's queue carries them so) hash like int32 ids.
    c = ts.draws_lane((0, key_i), T(rid).long(), T(did).long(), n).numpy()
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("draw_id", [0, 1, 48, MAX_DRAW])
def test_draws_bitwise(draw_id):
    rid, _ = _ids(5)
    a = np.asarray(js.draws(jax.random.key(3), jnp.asarray(rid), draw_id, 2))
    b = ts.draws((0, 3), T(rid), draw_id, 2).numpy()
    np.testing.assert_array_equal(a, b)
    assert (b >= 0).all() and (b < 1).all()


def test_mix_matches_uint32_reference():
    """The int64-held murmur3 finalizer wraps like uint32 arithmetic."""
    rs = np.random.RandomState(1)
    x = rs.randint(0, 2**32, size=10000, dtype=np.uint64).astype(np.uint32)
    x[:3] = [0, 0xFFFFFFFF, 0x80000000]
    a = np.asarray(js._mix(jnp.asarray(x)))
    b = ts._mix(T(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(a.astype(np.int64), b)


@pytest.mark.parametrize("name", ["cosine_hemisphere", "uniform_hemisphere",
                                  "uniform_sphere"])
def test_direction_samplers(name):
    u = np.random.RandomState(2).rand(2048, 2).astype(np.float32)
    da, pa = getattr(js, name)(jnp.asarray(u))
    db, pb = getattr(ts, name)(T(u))
    np.testing.assert_allclose(np.asarray(da), db.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(pa), pb.numpy(), rtol=1e-5, atol=1e-6)
