// packed_walk: every ray walks its octant's skip-pointer node table of the
// packed BVH alone and tests the primitive rows of the leaves it enters.
// Two designs of the same walk, the same bits: the window walk (a warp a
// ray, the default) and the thread walk (a thread a ray, its twin).
//
// Replaces tpu_pt/bvh/packed.py::_traverse, which has no pl.pallas_call: it
// is a lax.while_loop that XLA compiles into one program, running the whole
// batch in lockstep until its longest ray is done.  In the thread walk one
// thread owns one ray and runs the same stackless walk with the loop inside
// the thread; ray state (best t, gid, slot, u, v) stays in registers and
// nothing is kept between launches.  A node row is two 16-byte loads (box, skip, meta), a
// primitive row three (v0, e1, e2, material bits, type).
//
// Bound: bytes, by count (32 bytes a node step, 48 a row, some thirty
// operations a node and sixty a row), but a walk is a chain of dependent
// loads: a ray cannot ask for its next node before the last one arrived.
// So a launch takes about as long as its longest ray's chain of memory
// round trips; the design keeps that chain short (one round a node, the
// leaf's rows issued together) and does nothing yet to reorder rays.
//
// Same bits as the plain version (kernels/packed_walk.py::packed_walk_ref):
// the library is compiled with -fmad=false and the row test is the shared
// prim_hit.  The slab test keeps NaN through min and max, as torch.minimum
// and torch.maximum do (an axis-parallel ray on a slab plane gives 0 * inf),
// and then maps a NaN near to -inf and a NaN far to +inf; fminf / fmaxf
// would drop it instead.  A node is entered iff t_near <= widen_up(fminf(
// t_far, best t)) (pair_isect_common.cuh): the bound is widened upward, so a
// box that holds a primitive at best t on a coplanar face is not culled where
// the slab t rounds above the primitive's t, and the walk keeps brute force's
// nearest (t, lowest id).  A row takes over when it hits (t <= best t) and is
// nearer, or as near with a lower primitive id.  The any-hit form leaves at
// its first such row: the occluded bit is the same.
//
// The window walk.  The thread walk spends one memory round trip a node
// step (0.6-0.8 us on an H100 for a 503 MB table that L2 does not hold),
// and a warp of 32 rays waits for its longest ray.  But each octant table
// is in preorder, with skip pointing just past the node's subtree (so
// cursor < skip <= n): the cursor only moves forward, and the next nodes
// the walk can visit lie just after it.  So a warp takes one ray, and lane
// j loads node row base + j of a window of 32 rows (base: the cursor where
// the window opens), computing that node's slab entry t_near (with t_min)
// and slab exit t_far_slab = min(fx, fy, fz), NaN handled as above.  The
// warp then resolves the walk inside the window in order, reading lane
// (cursor - base)'s values with shuffles: a node is entered iff t_near <=
// widen_up(fminf(t_far_slab, best t)) under the CURRENT best t.  That is the
// thread walk's test split in two (the same operations), so the nodes visited
// and the leaves tested, in their order, are the thread walk's.  A leaf's
// rows are tested one a lane, each with t_max = best t at the leaf, and
// reduced by (t, gid, row) with shuffles.  That picks the row the sequential
// loop picks: a row the loop rejects under a smaller best t is farther than,
// or as near with a higher id than, the row that made best t smaller, so it
// loses the minimum too; the winner's t does not depend on the t_max it was
// tested with (a sphere's far root is taken only where its near one is behind
// t_min).  The any-hit form takes a ballot and leaves.  A new window is
// loaded when the cursor leaves [base, base + 32): round trips fall from one
// a node to one a window, and a ray waits for no other ray.

#include <climits>

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kThreads = 64;  // rays a block of the thread walk

// Ray r with its reciprocal direction; its octant picks its node table.
struct WalkRay {
  Ray ray;
  float ix, iy, iz;
  int octant;
};

__device__ __forceinline__ WalkRay walk_ray(const float* __restrict__ ro,
                                            const float* __restrict__ rd,
                                            const float* __restrict__ t_min,
                                            int r) {
  WalkRay w;
  w.ray.ox = ro[3 * r]; w.ray.oy = ro[3 * r + 1]; w.ray.oz = ro[3 * r + 2];
  w.ray.dx = rd[3 * r]; w.ray.dy = rd[3 * r + 1]; w.ray.dz = rd[3 * r + 2];
  w.ray.t_min = t_min[r];
  w.ix = 1.0f / w.ray.dx; w.iy = 1.0f / w.ray.dy; w.iz = 1.0f / w.ray.dz;
  w.octant = (w.ray.dx < 0.0f) + 2 * (w.ray.dy < 0.0f) + 4 * (w.ray.dz < 0.0f);
  return w;
}

// Node row i: the slab entry (with t_min) and exit of its box along the
// ray, its skip and meta.  The walk enters it iff t_near <=
// widen_up(fminf(t_far, best t)).
struct Node {
  float t_near, t_far;
  int skip, meta;
};

__device__ __forceinline__ Node load_node(const float4* __restrict__ nodes,
                                          int i, const WalkRay& w) {
  // Row i is 16 floats; its first 8 are the node.
  const float4 a = __ldg(nodes + (size_t)i * 4);      // min.xyz, max.x
  const float4 b = __ldg(nodes + (size_t)i * 4 + 1);  // max.yz, skip, meta
  const Ray& ray = w.ray;
  const float lx = (a.x - ray.ox) * w.ix, hx = (a.w - ray.ox) * w.ix;
  const float ly = (a.y - ray.oy) * w.iy, hy = (b.x - ray.oy) * w.iy;
  const float lz = (a.z - ray.oz) * w.iz, hz = (b.y - ray.oz) * w.iz;
  const float nx = nan_to(min_nan(lx, hx), -INFINITY);
  const float fx = nan_to(max_nan(lx, hx), INFINITY);
  const float ny = nan_to(min_nan(ly, hy), -INFINITY);
  const float fy = nan_to(max_nan(ly, hy), INFINITY);
  const float nz = nan_to(min_nan(lz, hz), -INFINITY);
  const float fz = nan_to(max_nan(lz, hz), INFINITY);
  Node nd;
  nd.t_near = fmaxf(fmaxf(fmaxf(nx, ny), nz), ray.t_min);
  nd.t_far = fminf(fminf(fx, fy), fz);
  nd.skip = __float_as_int(b.z);
  nd.meta = __float_as_int(b.w);
  return nd;
}

template <bool ANY>
__global__ void packed_walk_kernel(
    const float4* __restrict__ table, const int* __restrict__ prim_gid,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_occ, int R, int n, int n_tables, int n_prims,
    int max_leaf) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  WalkRay w = walk_ray(ro, rd, t_min, r);
  Ray& ray = w.ray;
  const float4* nodes = table + (size_t)(w.octant % n_tables) * n * 4;
  const float4* prims = table + (size_t)n_tables * n * 4;

  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_g = INT_MAX, best_slot = 0;
  bool occ = false;
  int cursor = 0;
  while (cursor < n) {
    const Node nd = load_node(nodes, cursor, w);
    const int skip = nd.skip;
    const int meta = nd.meta;
    const bool hit_bb = nd.t_near <= widen_up(fminf(nd.t_far, best_t));
    if (hit_bb && meta >= 0) {
      const int start = meta & ((1 << 26) - 1);
      const int cnt = min((int)((unsigned)meta >> 26), max_leaf);
      for (int k = 0; k < cnt; k++) {
        const int slot = min(max(start + k, 0), n_prims - 1);
        const Prim p = load_prim(prims, slot);
        ray.t_max = best_t;
        float t, u, v;
        bool is_sph;
        if (prim_hit(p, ray, t, u, v, is_sph)) {
          const int g = __ldg(prim_gid + slot);
          if (t < best_t || (t == best_t && g < best_g)) {
            best_t = t; best_g = g; best_slot = slot;
            best_u = is_sph ? 0.0f : u;
            best_v = is_sph ? 0.0f : v;
            if (ANY) { occ = true; break; }
          }
        }
      }
      if (ANY && occ) break;
    }
    cursor = (hit_bb && meta < 0) ? cursor + 1 : skip;
  }
  if (ANY) {
    out_occ[r] = occ;
  } else {
    out_t[r] = best_t; out_slot[r] = best_slot;
    out_u[r] = best_u; out_v[r] = best_v;
  }
}

constexpr int kWindow = 32;        // node rows a window: one a lane
constexpr int kWindowWarps = 4;    // rays (warps) a block of the window walk

// (t, gid, key) minimum over the lanes whose key is not INT_MAX, within
// each group of `width` lanes (a power of two, at most 32); every lane of a
// group gets its group's minimum.  Keys are distinct, so the order is total
// and the butterfly's order of combining changes nothing.
__device__ __forceinline__ void leaf_min(float& t, int& g, int& key,
                                         int width) {
  for (int off = 1; off < width; off <<= 1) {
    const float ot = __shfl_xor_sync(kFull, t, off);
    const int og = __shfl_xor_sync(kFull, g, off);
    const int ok = __shfl_xor_sync(kFull, key, off);
    if (ok != INT_MAX &&
        (key == INT_MAX || ot < t ||
         (ot == t && (og < g || (og == g && ok < key))))) {
      t = ot; g = og; key = ok;
    }
  }
}

template <bool ANY>
__global__ void __launch_bounds__(kWindowWarps * 32) packed_walk_window_kernel(
    const float4* __restrict__ table, const int* __restrict__ prim_gid,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    float* __restrict__ out_t, int* __restrict__ out_slot,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_occ, int R, int n, int n_tables, int n_prims,
    int max_leaf) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWindowWarps + (threadIdx.x >> 5);
  if (r >= R) return;                  // the whole warp: r is the warp's
  const WalkRay w = walk_ray(ro, rd, t_min, r);
  const float4* nodes = table + (size_t)(w.octant % n_tables) * n * 4;
  const float4* prims = table + (size_t)n_tables * n * 4;

  // The ray's state is the same in every lane.
  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_g = INT_MAX, best_slot = 0;
  bool occ = false;
  int cursor = 0;
  while (cursor < n) {
    // Load the window: lane j takes node row base + j.
    const int base = cursor;
    const int i = base + lane;
    Node mine;
    mine.t_near = mine.t_far = 0.0f;
    mine.skip = n;
    mine.meta = -1;
    if (i < n) mine = load_node(nodes, i, w);
    // Resolve the walk inside the window, in order.
    while (cursor < n && cursor - base < kWindow) {
      const int j = cursor - base;
      const float tn = __shfl_sync(kFull, mine.t_near, j);
      const float tf = __shfl_sync(kFull, mine.t_far, j);
      const int sk = __shfl_sync(kFull, mine.skip, j);
      const int mt = __shfl_sync(kFull, mine.meta, j);
      const bool hit_bb = tn <= widen_up(fminf(tf, best_t));
      if (hit_bb && mt >= 0) {
        const int start = mt & ((1 << 26) - 1);
        const int cnt = min((int)((unsigned)mt >> 26), max_leaf);
        for (int k0 = 0; k0 < cnt; k0 += 32) {
          // Row k0 + lane, tested under the best t the leaf found.
          const int k = k0 + lane;
          float t = 0.0f, u = 0.0f, v = 0.0f;
          int g = INT_MAX, slot = 0, key = INT_MAX;
          if (k < cnt) {
            slot = min(max(start + k, 0), n_prims - 1);
            const Prim p = load_prim(prims, slot);
            g = __ldg(prim_gid + slot);
            Ray rl = w.ray;
            rl.t_max = best_t;
            bool is_sph;
            if (prim_hit(p, rl, t, u, v, is_sph) &&
                (t < best_t || (t == best_t && g < best_g))) {
              key = k;
              if (is_sph) { u = 0.0f; v = 0.0f; }
            }
          }
          if (ANY) {
            if (__any_sync(kFull, key != INT_MAX)) { occ = true; break; }
          } else {
            int width = 1;
            while (width < min(cnt - k0, 32)) width <<= 1;
            float bt = t;
            int bg = g, bk = key;
            leaf_min(bt, bg, bk, width);
            bt = __shfl_sync(kFull, bt, 0);
            bg = __shfl_sync(kFull, bg, 0);
            bk = __shfl_sync(kFull, bk, 0);
            if (bk != INT_MAX) {
              const int src = bk - k0;
              best_t = bt; best_g = bg;
              best_slot = __shfl_sync(kFull, slot, src);
              best_u = __shfl_sync(kFull, u, src);
              best_v = __shfl_sync(kFull, v, src);
            }
          }
        }
        if (ANY && occ) break;
      }
      cursor = (hit_bb && mt < 0) ? cursor + 1 : sk;
    }
    if (ANY && occ) break;
  }
  if (lane != 0) return;
  if (ANY) {
    out_occ[r] = occ;
  } else {
    out_t[r] = best_t; out_slot[r] = best_slot;
    out_u[r] = best_u; out_v[r] = best_v;
  }
}

}  // namespace

// table (n_tables * n_nodes + n_prims, 16) f32, 16-byte aligned; prim_gid
// (n_prims,) i32; ro, rd (R, 3) f32; t_min, t_max (R,) f32.  Closest hit
// (any_hit 0): out_t, out_u, out_v (R,) f32 and out_slot (R,) i32; any hit:
// out_occ (R,) bool.  Returns cudaGetLastError().
extern "C" int packed_walk_launch(const void* table, const void* prim_gid,
                                  const void* ro, const void* rd,
                                  const void* t_min, const void* t_max,
                                  void* out_t, void* out_slot, void* out_u,
                                  void* out_v, void* out_occ, int R,
                                  int n_nodes, int n_tables, int n_prims,
                                  int max_leaf, int any_hit, void* stream) {
  if (R <= 0 || n_nodes <= 0 || n_tables <= 0 || n_prims <= 0 || max_leaf <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    packed_walk_kernel<true><<<grid, kThreads, 0, s>>>(
        (const float4*)table, (const int*)prim_gid, (const float*)ro,
        (const float*)rd, (const float*)t_min, (const float*)t_max, nullptr,
        nullptr, nullptr, nullptr, (bool*)out_occ, R, n_nodes, n_tables,
        n_prims, max_leaf);
  } else {
    packed_walk_kernel<false><<<grid, kThreads, 0, s>>>(
        (const float4*)table, (const int*)prim_gid, (const float*)ro,
        (const float*)rd, (const float*)t_min, (const float*)t_max,
        (float*)out_t, (int*)out_slot, (float*)out_u, (float*)out_v, nullptr,
        R, n_nodes, n_tables, n_prims, max_leaf);
  }
  return (int)cudaGetLastError();
}

// The window walk: the same operands and outputs as packed_walk_launch.
extern "C" int packed_walk_window_launch(
    const void* table, const void* prim_gid, const void* ro, const void* rd,
    const void* t_min, const void* t_max, void* out_t, void* out_slot,
    void* out_u, void* out_v, void* out_occ, int R, int n_nodes,
    int n_tables, int n_prims, int max_leaf, int any_hit, void* stream) {
  if (R <= 0 || n_nodes <= 0 || n_tables <= 0 || n_prims <= 0 || max_leaf <= 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kWindowWarps - 1) / kWindowWarps);
  const dim3 block(kWindowWarps * 32);
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    packed_walk_window_kernel<true><<<grid, block, 0, s>>>(
        (const float4*)table, (const int*)prim_gid, (const float*)ro,
        (const float*)rd, (const float*)t_min, (const float*)t_max, nullptr,
        nullptr, nullptr, nullptr, (bool*)out_occ, R, n_nodes, n_tables,
        n_prims, max_leaf);
  } else {
    packed_walk_window_kernel<false><<<grid, block, 0, s>>>(
        (const float4*)table, (const int*)prim_gid, (const float*)ro,
        (const float*)rd, (const float*)t_min, (const float*)t_max,
        (float*)out_t, (int*)out_slot, (float*)out_u, (float*)out_v, nullptr,
        R, n_nodes, n_tables, n_prims, max_leaf);
  }
  return (int)cudaGetLastError();
}
