"""Device LBVH builder: Morton codes -> stable sort -> Karras radix tree ->
skip-pointer node table, all torch ops on the device of the scene.

The counterpart of a host BVH build plus upload, built where the data
lives.  Everything is dense tensor code: the radix tree is the Karras-2012
parallel construction (each internal node finds its range and split with
vectorized searches), boxes propagate bottom-up in a fixed number of gather
rounds, and the skip-pointer DFS layout follows from a closed form: for a
binary tree over contiguous leaf ranges,

    preorder_index(node [f, l]) = 2*f + (#left turns on the path root->node)
    skip(node [f, l])           = preorder_index + 2*(l - f) + 1

so no sequential DFS is needed (the left turns are a short parent-chain
walk, vectorized over all nodes).

The result is a ``PackedBVH`` with ONE node table (children in Morton
order; the walk takes table ``octant % n_tables``) and one primitive a
leaf.  torch has no usable uint32, so every 32-bit unsigned quantity is an
int64 here, masked to 32 bits after any shift that could carry past bit 31.
"""

from __future__ import annotations

import math

import torch

from tpu_pt_torch.bvh import native
from tpu_pt_torch.bvh.packed import PackedBVH
from tpu_pt_torch.bvh.sah import prim_bounds
from tpu_pt_torch.config import resolve_device
from tpu_pt_torch.scene.types import Scene

_U32 = 0xFFFFFFFF


def _expand_bits(v):
    """Spread the low 10 bits of v (int64) so there are 2 zeros between
    each bit.  Each product is masked at once, so it equals the uint32
    product's low word."""
    v = (v * 0x00010001) & 0xFF0000FF
    v = (v * 0x00000101) & 0x0F00F00F
    v = (v * 0x00000011) & 0xC30C30C3
    v = (v * 0x00000005) & 0x49249249
    return v


def morton_codes(cent, lo, hi):
    """30-bit Morton codes (int64) of centroids normalized to the scene box.
    cent: (P, 3) f32; lo, hi: (3,) f32 scene bounds."""
    x = torch.clamp((cent - lo) / torch.clamp_min(hi - lo, 1e-12),
                    0.0, 1.0 - 1e-7)
    q = (x * 1024.0).to(torch.int64)
    return ((_expand_bits(q[:, 0]) << 2) | (_expand_bits(q[:, 1]) << 1)
            | _expand_bits(q[:, 2]))


def _clz32(x):
    """Leading zeros of x as a uint32 (x: int64 in [0, 2^32)), 0..32."""
    n = torch.zeros(x.shape, dtype=torch.int64, device=x.device)
    cur = x
    for shift in (16, 8, 4, 2, 1):
        empty = cur < (1 << (32 - shift))
        n = n + torch.where(empty, shift, 0)
        cur = torch.where(empty, (cur << shift) & _U32, cur)
    return torch.where(x == 0, 32, n)


def _prefix64(code_a, code_b, idx_a, idx_b):
    """Common-prefix length of the keys (code << 32 | idx): clz(code ^ code)
    where the Morton codes differ, else 32 + clz(idx ^ idx) (Karras's
    duplicate-code rule)."""
    cx = code_a ^ code_b
    ix = (idx_a ^ idx_b) & _U32
    return torch.where(cx != 0, _clz32(cx), 32 + _clz32(ix))


def _rounds(p: int) -> int:
    """Rounds that settle every lane of the three Karras searches: the
    range doubling runs at most ceil(log2 P) - 1 times and each halving
    search at most ceil(log2 P) + 1; a round after a lane settled leaves it
    as it is."""
    return math.ceil(math.log2(2 * p)) + 1


def build_lbvh_arrays(prim_lo, prim_hi, check_each_round: bool = False):
    """Core build.  prim_lo / prim_hi: (P, 3) f32 primitive bounds, P >= 2.

    Returns (nodes (1, 2P-1, 8) f32, perm (P,) int32) in the ``PackedBVH``
    node layout (leaves hold one primitive: the sorted slot ``i`` as
    ``meta = i | 1 << 26``).  The three searches run ``_rounds(P)`` rounds;
    ``check_each_round`` instead stops each when no lane moved, one read of
    the device a round (the same arrays)."""
    dev = prim_lo.device
    p = prim_lo.shape[0]
    if p < 2:
        raise ValueError(f"the LBVH needs at least 2 primitives, got {p}")
    cent = (prim_lo + prim_hi) * 0.5
    codes = morton_codes(cent, torch.amin(prim_lo, 0), torch.amax(prim_hi, 0))
    codes_s, order = torch.sort(codes, stable=True)
    perm = order.to(torch.int32)

    def delta(i, j):
        """Prefix length between sorted leaves i and j; -1 outside."""
        valid = (j >= 0) & (j < p)
        jj = torch.clamp(j, 0, p - 1)
        d = _prefix64(codes_s[i], codes_s[jj], i, jj)
        return torch.where(valid, d, -1)

    def search(body, state, moving):
        if check_each_round:
            while bool(moving(state)):
                state = body(state)
        else:
            for _ in range(_rounds(p)):
                state = body(state)
        return state

    # Karras ranges and splits of the internal nodes i in [0, p-2].
    i = torch.arange(p - 1, dtype=torch.int64, device=dev)
    d_dir = torch.sign(delta(i, i + 1) - delta(i, i - 1))
    delta_min = delta(i, i - d_dir)

    def grows(lmax):
        return delta(i, i + lmax * d_dir) > delta_min

    # Exponential search for an upper bound of the range length.
    lmax = search(lambda lm: torch.where(grows(lm), lm * 2, lm),
                  torch.full_like(i, 2),
                  lambda lm: torch.any(grows(lm) & (lm < 2 * p)))

    # Binary search for the exact range end.
    def shrink(state):
        l, t = state
        cond = (t >= 1) & (delta(i, i + (l + t) * d_dir) > delta_min)
        return torch.where(cond, l + t, l), t // 2

    l, _ = search(shrink, (torch.zeros_like(i), lmax // 2),
                  lambda s: torch.any(s[1] >= 1))
    j = i + l * d_dir
    first = torch.minimum(i, j)
    last = torch.maximum(i, j)

    # Binary search for the split position.
    delta_node = delta(i, j)

    def split_step(state):
        s, t = state
        cond = (t >= 1) & (delta(i, i + (s + t) * d_dir) > delta_node)
        return (torch.where(cond, s + t, s),
                torch.where(t > 1, -(-t // 2), 0))

    s, _ = search(split_step, (torch.zeros_like(i), -(-l // 2)),
                  lambda st: torch.any(st[1] >= 1))
    gamma = i + s * d_dir + torch.clamp_max(d_dir, 0)   # split leaf index

    left_is_leaf = first == gamma
    right_is_leaf = last == gamma + 1
    left_child, right_child = gamma, gamma + 1   # internal or leaf ids

    # Parent pointers: each node has one parent, so the scatters are
    # unique; a child of the other kind is masked out, never written.
    int_parent = torch.full((p - 1,), -1, dtype=torch.int64, device=dev)
    leaf_parent = torch.full((p,), -1, dtype=torch.int64, device=dev)
    int_parent[left_child[~left_is_leaf]] = i[~left_is_leaf]
    int_parent[right_child[~right_is_leaf]] = i[~right_is_leaf]
    leaf_parent[left_child[left_is_leaf]] = i[left_is_leaf]
    leaf_parent[right_child[right_is_leaf]] = i[right_is_leaf]

    # Bottom-up boxes: 64 rounds (the tree depth of 64-bit keys).  An
    # internal id past the last internal node only ever names a leaf, so
    # its gather is clamped and its value discarded.
    leaf_lo = prim_lo[order]
    leaf_hi = prim_hi[order]
    node_lo = torch.full((p - 1, 3), 1e30, dtype=torch.float32, device=dev)
    node_hi = torch.full((p - 1, 3), -1e30, dtype=torch.float32, device=dev)
    lc_int = torch.clamp_max(left_child, p - 2)
    rc_int = torch.clamp_max(right_child, p - 2)
    ll, rl = left_is_leaf[:, None], right_is_leaf[:, None]
    for _ in range(64):
        l_lo = torch.where(ll, leaf_lo[left_child], node_lo[lc_int])
        l_hi = torch.where(ll, leaf_hi[left_child], node_hi[lc_int])
        r_lo = torch.where(rl, leaf_lo[right_child], node_lo[rc_int])
        r_hi = torch.where(rl, leaf_hi[right_child], node_hi[rc_int])
        node_lo, node_hi = torch.minimum(l_lo, r_lo), torch.maximum(l_hi, r_hi)

    # Preorder index = 2*first + left turns on the path from the root: a
    # step parent -> child is a left turn iff the child's range starts where
    # the parent's does.  64 steps up every parent chain.
    def left_turns(parent0, my_first):
        cnt = torch.zeros_like(parent0)
        cur_parent, cur_first = parent0, my_first
        for _ in range(64):
            valid = cur_parent >= 0
            cc = torch.clamp(cur_parent, 0, p - 2)
            pf = first[cc]
            cnt = cnt + (valid & (pf == cur_first)).to(cnt.dtype)
            cur_first = torch.where(valid, pf, cur_first)
            cur_parent = torch.where(valid, int_parent[cc], -1)
        return cnt

    idx_int = 2 * first + left_turns(int_parent, first)
    skip_int = idx_int + 2 * (last - first) + 1
    leaf_ids = torch.arange(p, dtype=torch.int64, device=dev)
    idx_leaf = 2 * leaf_ids + left_turns(leaf_parent, leaf_ids)
    skip_leaf = idx_leaf + 1

    # The (2p-1, 8) table; skip and meta are int32 bits in f32 words.
    def bits(x):
        return x.to(torch.int32).view(torch.float32)

    table = torch.zeros((2 * p - 1, 8), dtype=torch.float32, device=dev)
    table[idx_leaf, 0:3] = leaf_lo
    table[idx_leaf, 3:6] = leaf_hi
    table[idx_leaf, 6] = bits(skip_leaf)
    table[idx_leaf, 7] = bits(leaf_ids | (1 << 26))
    table[idx_int, 0:3] = node_lo
    table[idx_int, 3:6] = node_hi
    table[idx_int, 6] = bits(skip_int)
    table[idx_int, 7] = bits(torch.full_like(idx_int, -1))
    return table[None], perm


@torch.no_grad()
def build_lbvh(scene: Scene, device="cuda") -> PackedBVH:
    """The LBVH of ``scene`` (host arrays or tensors) built on ``device``
    (the card by default; raises without one unless ``device="cpu"``) ->
    ``PackedBVH`` with one node table and ``max_leaf=1``, its tensors on
    ``device``; the primitive rows are gathered there too."""
    scene = scene.to(resolve_device(device))
    lo, hi = prim_bounds(scene)
    nodes, perm = build_lbvh_arrays(lo, hi)
    n = nodes.shape[1]
    table = torch.zeros((n + perm.shape[0], 16), dtype=torch.float32,
                        device=lo.device)
    table[:n, :8] = nodes[0]
    table[n:] = native.prim_rows(scene, perm)
    return PackedBVH(table=table, prim_gid=perm, max_leaf=1, n_tables=1,
                     n_nodes=n)
