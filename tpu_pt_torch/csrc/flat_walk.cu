// flat_walk: every ray walks the flat skip-pointer SAH BVH (bvh/sah.py's
// layout) alone, stackless, and tests the primitives of the leaves whose box
// it enters, from the scene's own arrays.
//
// Replaces tpu_pt/bvh/flat.py::intersect / ::occluded, which have no
// pl.pallas_call: each is a lax.while_loop that XLA compiles into one
// program, running the whole batch in lockstep until its longest ray is done
// (eager PyTorch would pay a host read and some hundred launches for every
// iteration of that loop).  Here one thread owns one ray and runs the walk
// with the loop inside the thread, as csrc/packed_walk.cu does; ray state
// (best t, primitive, u, v) stays in registers, nothing is kept between
// launches.  A node step reads 36 bytes (box, skip, start, count); a
// triangle its id, three vertex indices and three vertices, a sphere its id,
// centre and radius.
//
// Bound: bytes, by count, but a walk is a chain of dependent loads (node,
// then for a leaf the id, then the indices, then the vertices), so a launch
// takes about as long as its longest ray's chain of memory round trips.  The
// design keeps that chain as short as the layout allows and does nothing yet
// to reorder rays.
//
// Primitives are tested with the shared prim_hit (pair_isect_common.cuh):
// the triangle's edges are formed here as v1 - v0 and v2 - v0, one rounding
// each, which is how the packed and tile rows are built on the host, and
// prim_hit's operation order is core/intersect.py's Möller–Trumbore and
// sphere test written out.  So the kernel is bitwise its plain version
// (kernels/flat_walk.py::flat_walk_ref) under the library's -fmad=false.
// The slab test keeps NaN through min and max, as torch.minimum /
// torch.maximum do, and then maps a NaN near to -inf and a NaN far to +inf
// (core/aabb.py::slab_test).  The closest form takes a primitive that hits
// (t <= best t) nearer, or as near with a lower id while best t is below
// 1e30; the best id starts at 0 (tpu_pt/bvh/flat.py's rule).  The any-hit
// form leaves at its first hit within [t_min, t_max].

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kThreads = 128;  // rays per block

__device__ __forceinline__ float nan_to(float x, float to) {
  return x != x ? to : x;
}

template <bool ANY>
__global__ void flat_walk_kernel(
    const float* __restrict__ node_min, const float* __restrict__ node_max,
    const int* __restrict__ skip, const int* __restrict__ prim_start,
    const int* __restrict__ prim_count, const int* __restrict__ prim_ids,
    const int* __restrict__ tri_idx, const float* __restrict__ vertices,
    const float* __restrict__ sph_center, const float* __restrict__ sph_radius,
    const float* __restrict__ ro, const float* __restrict__ rd,
    const float* __restrict__ t_min, const float* __restrict__ t_max,
    float* __restrict__ out_t, int* __restrict__ out_prim,
    float* __restrict__ out_u, float* __restrict__ out_v,
    bool* __restrict__ out_occ, int R, int n, int n_prims, int n_tris,
    int n_spheres, int max_leaf) {
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= R) return;
  Ray ray;
  ray.ox = ro[3 * r]; ray.oy = ro[3 * r + 1]; ray.oz = ro[3 * r + 2];
  ray.dx = rd[3 * r]; ray.dy = rd[3 * r + 1]; ray.dz = rd[3 * r + 2];
  ray.t_min = t_min[r];
  const float ix = 1.0f / ray.dx, iy = 1.0f / ray.dy, iz = 1.0f / ray.dz;

  float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
  int best_g = 0;
  bool occ = false;
  int cursor = 0;
  while (cursor < n) {
    const float* bmin = node_min + 3 * (size_t)cursor;
    const float* bmax = node_max + 3 * (size_t)cursor;
    const float lx = (__ldg(bmin) - ray.ox) * ix;
    const float hx = (__ldg(bmax) - ray.ox) * ix;
    const float ly = (__ldg(bmin + 1) - ray.oy) * iy;
    const float hy = (__ldg(bmax + 1) - ray.oy) * iy;
    const float lz = (__ldg(bmin + 2) - ray.oz) * iz;
    const float hz = (__ldg(bmax + 2) - ray.oz) * iz;
    const float nx = nan_to(min_nan(lx, hx), -INFINITY);
    const float fx = nan_to(max_nan(lx, hx), INFINITY);
    const float ny = nan_to(min_nan(ly, hy), -INFINITY);
    const float fy = nan_to(max_nan(ly, hy), INFINITY);
    const float nz = nan_to(min_nan(lz, hz), -INFINITY);
    const float fz = nan_to(max_nan(lz, hz), INFINITY);
    const float t_near = fmaxf(fmaxf(fmaxf(nx, ny), nz), ray.t_min);
    const float t_far = fminf(fminf(fminf(fx, fy), fz), best_t);
    const bool hit_bb = t_near <= t_far;
    const int count = __ldg(prim_count + cursor);
    if (hit_bb && count > 0) {
      const int start = __ldg(prim_start + cursor);
      const int cnt = min(count, max_leaf);
      for (int k = 0; k < cnt; k++) {
        const int slot = min(max(start + k, 0), n_prims - 1);
        const int g = __ldg(prim_ids + slot);
        Prim p;
        if (g < n_tris) {
          const int i0 = __ldg(tri_idx + 3 * (size_t)g);
          const int i1 = __ldg(tri_idx + 3 * (size_t)g + 1);
          const int i2 = __ldg(tri_idx + 3 * (size_t)g + 2);
          const float* a = vertices + 3 * (size_t)i0;
          const float* b = vertices + 3 * (size_t)i1;
          const float* c = vertices + 3 * (size_t)i2;
          p.v0x = __ldg(a); p.v0y = __ldg(a + 1); p.v0z = __ldg(a + 2);
          p.e1x = __ldg(b) - p.v0x;
          p.e1y = __ldg(b + 1) - p.v0y;
          p.e1z = __ldg(b + 2) - p.v0z;
          p.e2x = __ldg(c) - p.v0x;
          p.e2y = __ldg(c + 1) - p.v0y;
          p.e2z = __ldg(c + 2) - p.v0z;
          p.typ = 0.0f;
        } else {
          const int s = min(max(g - n_tris, 0), n_spheres - 1);
          const float* c = sph_center + 3 * (size_t)s;
          p.v0x = __ldg(c); p.v0y = __ldg(c + 1); p.v0z = __ldg(c + 2);
          p.e1x = __ldg(sph_radius + s);
          p.e1y = 0.0f; p.e1z = 0.0f;
          p.e2x = 0.0f; p.e2y = 0.0f; p.e2z = 0.0f;
          p.typ = 1.0f;
        }
        ray.t_max = best_t;
        float t, u, v;
        bool is_sph;
        if (prim_hit(p, ray, t, u, v, is_sph)) {
          if (ANY) { occ = true; break; }
          if (t < best_t || (t == best_t && t < kInf && g < best_g)) {
            best_t = t; best_g = g;
            best_u = is_sph ? 0.0f : u;
            best_v = is_sph ? 0.0f : v;
          }
        }
      }
      if (ANY && occ) break;
    }
    cursor = (hit_bb && count == 0) ? cursor + 1 : __ldg(skip + cursor);
  }
  if (ANY) {
    out_occ[r] = occ;
  } else {
    out_t[r] = best_t; out_prim[r] = best_g;
    out_u[r] = best_u; out_v[r] = best_v;
  }
}

}  // namespace

// node_min, node_max (n_nodes, 3) f32; skip, prim_start, prim_count
// (n_nodes,) i32; prim_ids (n_prims,) i32; tri_idx (n_tris, 3) i32;
// vertices (V, 3) f32; sph_center (n_spheres, 3) f32; sph_radius
// (n_spheres,) f32; ro, rd (R, 3) f32; t_min, t_max (R,) f32.  Closest hit
// (any_hit 0): out_t, out_u, out_v (R,) f32 and out_prim (R,) i32; any hit:
// out_occ (R,) bool.  Returns cudaGetLastError().
extern "C" int flat_walk_launch(
    const void* node_min, const void* node_max, const void* skip,
    const void* prim_start, const void* prim_count, const void* prim_ids,
    const void* tri_idx, const void* vertices, const void* sph_center,
    const void* sph_radius, const void* ro, const void* rd, const void* t_min,
    const void* t_max, void* out_t, void* out_prim, void* out_u, void* out_v,
    void* out_occ, int R, int n_nodes, int n_prims, int n_tris, int n_spheres,
    int max_leaf, int any_hit, void* stream) {
  if (R <= 0 || n_nodes <= 0 || n_prims <= 0 || max_leaf <= 0 ||
      n_tris < 0 || n_spheres < 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((R + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  const float* nmin = (const float*)node_min;
  const float* nmax = (const float*)node_max;
  const int* sk = (const int*)skip;
  const int* ps = (const int*)prim_start;
  const int* pc = (const int*)prim_count;
  const int* pid = (const int*)prim_ids;
  const int* ti = (const int*)tri_idx;
  const float* vt = (const float*)vertices;
  const float* sc = (const float*)sph_center;
  const float* sr = (const float*)sph_radius;
  if (any_hit) {
    flat_walk_kernel<true><<<grid, kThreads, 0, s>>>(
        nmin, nmax, sk, ps, pc, pid, ti, vt, sc, sr, (const float*)ro,
        (const float*)rd, (const float*)t_min, (const float*)t_max, nullptr,
        nullptr, nullptr, nullptr, (bool*)out_occ, R, n_nodes, n_prims, n_tris,
        n_spheres, max_leaf);
  } else {
    flat_walk_kernel<false><<<grid, kThreads, 0, s>>>(
        nmin, nmax, sk, ps, pc, pid, ti, vt, sc, sr, (const float*)ro,
        (const float*)rd, (const float*)t_min, (const float*)t_max,
        (float*)out_t, (int*)out_prim, (float*)out_u, (float*)out_v, nullptr,
        R, n_nodes, n_prims, n_tris, n_spheres, max_leaf);
  }
  return (int)cudaGetLastError();
}
