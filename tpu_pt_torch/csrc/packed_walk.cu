// packed_walk: every ray walks its octant's skip-pointer node table of the
// packed BVH alone and tests the primitive rows of the leaves it enters.
//
// Replaces tpu_pt/bvh/packed.py::_traverse, which has no pl.pallas_call: it
// is a lax.while_loop that XLA compiles into one program, running the whole
// batch in lockstep until its longest ray is done.  Here one thread owns one
// ray and runs the same stackless walk with the loop inside the thread; ray
// state (best t, gid, slot, u, v) stays in registers and nothing is kept
// between launches.  A node row is two 16-byte loads (box, skip, meta), a
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
// would drop it instead.  A row takes over when it hits (t <= best t) and is
// nearer, or as near with a lower primitive id.  The any-hit form leaves at
// its first such row: the occluded bit is the same.

#include <climits>

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kThreads = 64;  // rays per block

__device__ __forceinline__ float nan_to(float x, float to) {
  return x != x ? to : x;
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
  Ray ray;
  ray.ox = ro[3 * r]; ray.oy = ro[3 * r + 1]; ray.oz = ro[3 * r + 2];
  ray.dx = rd[3 * r]; ray.dy = rd[3 * r + 1]; ray.dz = rd[3 * r + 2];
  ray.t_min = t_min[r];
  const float ix = 1.0f / ray.dx, iy = 1.0f / ray.dy, iz = 1.0f / ray.dz;
  const int octant = (ray.dx < 0.0f) + 2 * (ray.dy < 0.0f) + 4 * (ray.dz < 0.0f);
  const float4* nodes = table + (size_t)(octant % n_tables) * n * 4;
  const float4* prims = table + (size_t)n_tables * n * 4;

  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_g = INT_MAX, best_slot = 0;
  bool occ = false;
  int cursor = 0;
  while (cursor < n) {
    // Row `cursor` is 16 floats; its first 8 are the node.
    const float4 a = __ldg(nodes + (size_t)cursor * 4);      // min.xyz, max.x
    const float4 b = __ldg(nodes + (size_t)cursor * 4 + 1);  // max.yz, skip, meta
    const float lx = (a.x - ray.ox) * ix, hx = (a.w - ray.ox) * ix;
    const float ly = (a.y - ray.oy) * iy, hy = (b.x - ray.oy) * iy;
    const float lz = (a.z - ray.oz) * iz, hz = (b.y - ray.oz) * iz;
    const float nx = nan_to(min_nan(lx, hx), -INFINITY);
    const float fx = nan_to(max_nan(lx, hx), INFINITY);
    const float ny = nan_to(min_nan(ly, hy), -INFINITY);
    const float fy = nan_to(max_nan(ly, hy), INFINITY);
    const float nz = nan_to(min_nan(lz, hz), -INFINITY);
    const float fz = nan_to(max_nan(lz, hz), INFINITY);
    const float t_near = fmaxf(fmaxf(fmaxf(nx, ny), nz), ray.t_min);
    const float t_far = fminf(fminf(fminf(fx, fy), fz), best_t);
    const int skip = __float_as_int(b.z);
    const int meta = __float_as_int(b.w);
    const bool hit_bb = t_near <= t_far;
    if (hit_bb && meta >= 0) {
      const int start = meta & ((1 << 26) - 1);
      const int cnt = min((int)((unsigned)meta >> 26), max_leaf);
      for (int k = 0; k < cnt; k++) {
        const int slot = min(max(start + k, 0), n_prims - 1);
        const float4* row = prims + (size_t)slot * 4;
        const float4 p0 = __ldg(row), p1 = __ldg(row + 1), p2 = __ldg(row + 2);
        Prim p;
        p.v0x = p0.x; p.v0y = p0.y; p.v0z = p0.z;
        p.e1x = p0.w; p.e1y = p1.x; p.e1z = p1.y;
        p.e2x = p1.z; p.e2y = p1.w; p.e2z = p2.x;
        p.typ = p2.z;  // p2.y: material bits, unused
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
