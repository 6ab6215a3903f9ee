// flat_walk: every ray walks the flat skip-pointer SAH BVH (bvh/sah.py's
// layout) alone, stackless, and tests the primitives of the leaves whose box
// it enters.  Two designs of the same walk, the same bits: the row walk
// (design "rows", the default) and the thread walk (design "thread", its
// twin, the first design).
//
// Replaces tpu_pt/bvh/flat.py::intersect / ::occluded, which have no
// pl.pallas_call: each is a lax.while_loop that XLA compiles into one
// program, running the whole batch in lockstep until its longest ray is done
// (eager PyTorch would pay a host read and some hundred launches for every
// iteration of that loop).  Here one thread owns one ray and runs the walk
// with the loop inside the thread; ray state (best t, primitive, u, v) stays
// in registers, nothing is kept between launches.
//
// Bound: operations and bytes, by count, but a walk is a chain of dependent
// loads, so a launch takes about as long as its longest ray's chain of
// memory round trips, and where the rays of a warp diverge its lanes wait
// for the warp's longest ray.
//
// The thread walk reads the scene's own arrays: a node step nine scalar
// loads from five arrays (box, skip, start, count), a primitive three
// round trips in a row (its id in prim_ids, its three vertex indices, its
// vertices; a sphere's centre and radius).  Its chain is steps + 3 per
// primitive tested.
//
// The row walk reads two tables built once per (BVH, scene) by
// bvh/flat.py::row_tables:
//   node row (8 f32, 32 bytes): [min.xyz, max.x], [max.yz, link, count],
//     link and count as int32 bits; link is skip for an inner node and
//     prim_start for a leaf;
//   primitive row (16 f32, bvh/packed.py's row format), in prim_ids slot
//     order, with the slot's primitive id beside it (prim_gid).
// A node step is two 16-byte loads from one 32-byte sector.  In these
// preorder tables a leaf's skip is its own index + 1 (row_tables checks it
// and raises otherwise), so the next node is cursor + 1 after a leaf or an
// entered inner node and link after a missed inner node: the thread walk's
// cursor.  A leaf's rows are adjacent; the thread loads them kLeafRows at a
// time and tests them in slot order, best t updated between tests, as the
// thread walk does; the winner's id is read from prim_gid on a tie and at
// the end, not with every row.  Rays: a ray a lane, in as many blocks as
// the batch needs, up to the blocks the SMs hold at once; beyond that (a
// batch of more rays than resident lanes) lane g walks rays g, g + G, ...
// (G threads), starting the next as soon as its walk ends.  A sweep on the
// card of 1, 2, 4 and 8 rays a lane found one fastest (PERF.md).  No
// atomics; nothing is kept between launches.
//
// What bounds it on the card (chip_smoke.py's kernels phase, PERF.md): a
// launch lasts about as long as its longest ray's chain of dependent loads
// and tests (that ray walked alone takes half to all of the batch's time)
// plus the divergent leaf tests of its warp, whose lanes are busy a quarter
// to a third of the steps on the bounce batches.  So what pays is every ray
// of the batch resident at once: the kernel is held to 64 registers (8
// blocks of 128 an SM hold 135,168 lanes, a 131,072-ray batch in one wave),
// which is why a leaf's rows come two at a time.  With all four in
// registers (the first design of this row walk) it took 96 and held 5
// blocks an SM, and a lane in three walked two rays in turn.
//
// The STATS form of the row walk also writes each ray's node steps, leaves
// entered and triangles and spheres tested, and marks the nodes fetched
// and the primitive slots tested: the counts
// kernels/flat_walk.py::flat_walk_counts returns.
//
// Primitives are tested with the shared prim_hit (pair_isect_common.cuh).
// The thread walk forms a triangle's edges as v1 - v0 and v2 - v0, one
// rounding each, which is how the row tables are built on the host, and
// prim_hit's operation order is core/intersect.py's Möller–Trumbore and
// sphere test written out.  So both designs are bitwise their plain version
// (kernels/flat_walk.py::flat_walk_ref) under the library's -fmad=false.
// The slab test keeps NaN through min and max, as torch.minimum /
// torch.maximum do, and then maps a NaN near to -inf and a NaN far to +inf
// (core/aabb.py::slab_test).  A node is entered iff t_near <= widen_up(
// t_far), t_far already min(slab exit, best t): the packed walk's
// conservative cull (pair_isect_common.cuh), so that no box holding brute
// force's nearest (t, lowest id) on a coplanar face is culled.  The closest
// form takes a primitive that hits (t <= best t) nearer, or as near with a
// lower id while best t is below 1e30; the best id starts at 0
// (tpu_pt/bvh/flat.py's rule).  The any-hit form leaves at its first hit
// within [t_min, t_max].

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kThreads = 128;     // rays a block of the thread walk
constexpr int kRowThreads = 128;  // lanes a block of the row walk
constexpr int kRowBlocks = 8;     // its blocks an SM holds: 64 registers
constexpr int kLeafRows = 2;      // a leaf's rows in registers at once

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
    const bool hit_bb = t_near <= widen_up(t_far);
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

// The slab test of node row (a, b) along the ray: the thread walk's
// operations in its order (bmin = a.xyz, bmax = (a.w, b.x, b.y)).
__device__ __forceinline__ bool row_hit(const float4& a, const float4& b,
                                        const Ray& ray, float ix, float iy,
                                        float iz, float best_t) {
  const float lx = (a.x - ray.ox) * ix;
  const float hx = (a.w - ray.ox) * ix;
  const float ly = (a.y - ray.oy) * iy;
  const float hy = (b.x - ray.oy) * iy;
  const float lz = (a.z - ray.oz) * iz;
  const float hz = (b.y - ray.oz) * iz;
  const float nx = nan_to(min_nan(lx, hx), -INFINITY);
  const float fx = nan_to(max_nan(lx, hx), INFINITY);
  const float ny = nan_to(min_nan(ly, hy), -INFINITY);
  const float fy = nan_to(max_nan(ly, hy), INFINITY);
  const float nz = nan_to(min_nan(lz, hz), -INFINITY);
  const float fz = nan_to(max_nan(lz, hz), INFINITY);
  const float t_near = fmaxf(fmaxf(fmaxf(nx, ny), nz), ray.t_min);
  const float t_far = fminf(fminf(fminf(fx, fy), fz), best_t);
  return t_near <= widen_up(t_far);
}

// Per-ray counts of the STATS form: node steps, leaves entered, triangles
// and spheres tested.
constexpr int kCounts = 4;

template <bool ANY, bool STATS>
__global__ void __launch_bounds__(kRowThreads, kRowBlocks)
flat_walk_rows_kernel(
    const float4* __restrict__ node_rows, const float4* __restrict__ prim_rows,
    const int* __restrict__ prim_gid, const float* __restrict__ ro,
    const float* __restrict__ rd, const float* __restrict__ t_min,
    const float* __restrict__ t_max, float* __restrict__ out_t,
    int* __restrict__ out_prim, float* __restrict__ out_u,
    float* __restrict__ out_v, bool* __restrict__ out_occ,
    int* __restrict__ counts, unsigned char* __restrict__ node_seen,
    unsigned char* __restrict__ slot_seen, int R, int n, int n_prims,
    int max_leaf) {
  const int lanes = gridDim.x * kRowThreads;
  for (int r = blockIdx.x * kRowThreads + threadIdx.x; r < R; r += lanes) {
    Ray ray;
    ray.ox = ro[3 * r]; ray.oy = ro[3 * r + 1]; ray.oz = ro[3 * r + 2];
    ray.dx = rd[3 * r]; ray.dy = rd[3 * r + 1]; ray.dz = rd[3 * r + 2];
    ray.t_min = t_min[r];
    const float ix = 1.0f / ray.dx, iy = 1.0f / ray.dy, iz = 1.0f / ray.dz;

    // The winner's slot, -1 before the first take-over: its primitive id
    // is read on a tie and at the end, not with every row.
    float best_t = t_max[r], best_u = 0.0f, best_v = 0.0f;
    int best_slot = -1;
    bool occ = false;
    int steps = 0, leaves = 0, tris = 0, sphs = 0;
    int cursor = 0;
    while (cursor < n) {
      const float4 a = __ldg(node_rows + 2 * (size_t)cursor);
      const float4 b = __ldg(node_rows + 2 * (size_t)cursor + 1);
      if (STATS) { steps++; node_seen[cursor] = 1; }
      const bool hit_bb = row_hit(a, b, ray, ix, iy, iz, best_t);
      const int link = __float_as_int(b.z);
      const int count = __float_as_int(b.w);
      if (hit_bb && count > 0) {
        if (STATS) leaves++;
        const int cnt = min(count, max_leaf);
        for (int k0 = 0; k0 < cnt; k0 += kLeafRows) {
          // The loads of these rows first, then the tests in slot order.
          Prim p[kLeafRows];
          int slot[kLeafRows];
#pragma unroll
          for (int j = 0; j < kLeafRows; j++) {
            if (k0 + j < cnt) {
              slot[j] = min(max(link + k0 + j, 0), n_prims - 1);
              p[j] = load_prim(prim_rows, slot[j]);
              if (STATS) slot_seen[slot[j]] = 1;
            }
          }
#pragma unroll
          for (int j = 0; j < kLeafRows; j++) {
            if (k0 + j < cnt && !(ANY && occ)) {
              if (STATS) {
                if (p[j].typ > 0.5f) sphs++; else tris++;
              }
              ray.t_max = best_t;
              float t, u, v;
              bool is_sph;
              if (prim_hit(p[j], ray, t, u, v, is_sph)) {
                // The thread walk's rule with best id = prim_gid[best
                // slot] (0 before the first take-over, which no id is
                // below): nearer, or as near with a lower id.
                if (ANY) {
                  occ = true;
                } else if (t < best_t ||
                           (t == best_t && t < kInf && best_slot >= 0 &&
                            __ldg(prim_gid + slot[j]) <
                                __ldg(prim_gid + best_slot))) {
                  best_t = t; best_slot = slot[j];
                  best_u = is_sph ? 0.0f : u;
                  best_v = is_sph ? 0.0f : v;
                }
              }
            }
          }
          if (ANY && occ) break;
        }
        if (ANY && occ) break;
      }
      cursor = (hit_bb || count > 0) ? cursor + 1 : link;
    }
    if (ANY) {
      out_occ[r] = occ;
    } else {
      out_t[r] = best_t;
      out_prim[r] = best_slot >= 0 ? __ldg(prim_gid + best_slot) : 0;
      out_u[r] = best_u; out_v[r] = best_v;
    }
    if (STATS) {
      int* c = counts + (size_t)kCounts * r;
      c[0] = steps; c[1] = leaves; c[2] = tris; c[3] = sphs;
    }
  }
}

template <bool ANY, bool STATS>
int rows_blocks_per_sm() {
  static int blocks = 0;  // asked once per form
  if (blocks == 0) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, flat_walk_rows_kernel<ANY, STATS>, kRowThreads, 0);
    if (err != cudaSuccess || blocks < 1) blocks = 1;
  }
  return blocks;
}

template <bool ANY, bool STATS>
int launch_rows(const void* node_rows, const void* prim_rows,
                const void* prim_gid, const void* ro, const void* rd,
                const void* t_min, const void* t_max, void* out_t,
                void* out_prim, void* out_u, void* out_v, void* out_occ,
                void* counts, void* node_seen, void* slot_seen, int R,
                int n_nodes, int n_prims, int max_leaf, int n_sm,
                cudaStream_t s) {
  // A ray a lane, in no more blocks than the SMs hold at once.
  const long long resident = (long long)rows_blocks_per_sm<ANY, STATS>() * n_sm;
  const long long wanted = ((long long)R + kRowThreads - 1) / kRowThreads;
  const int blocks = (int)(wanted < resident ? wanted : resident);
  flat_walk_rows_kernel<ANY, STATS><<<blocks, kRowThreads, 0, s>>>(
      (const float4*)node_rows, (const float4*)prim_rows,
      (const int*)prim_gid, (const float*)ro, (const float*)rd,
      (const float*)t_min, (const float*)t_max, (float*)out_t,
      (int*)out_prim, (float*)out_u, (float*)out_v, (bool*)out_occ,
      (int*)counts, (unsigned char*)node_seen, (unsigned char*)slot_seen, R,
      n_nodes, n_prims, max_leaf);
  return (int)cudaGetLastError();
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

// The row walk.  node_rows (n_nodes, 8) f32 and prim_rows (n_prims, 16) f32,
// both 16-byte aligned; prim_gid (n_prims,) i32; ro, rd (R, 3) f32; t_min,
// t_max (R,) f32; outputs as flat_walk_launch's.  counts (R, 4) i32,
// node_seen (n_nodes,) u8 and slot_seen (n_prims,) u8, zeroed by the
// caller: all three null (the walk), or all three set (the STATS form).
// The grid holds a ray a lane (more where the n_sm SMs cannot hold that
// many lanes at once).  Returns cudaGetLastError().
extern "C" int flat_walk_rows_launch(
    const void* node_rows, const void* prim_rows, const void* prim_gid,
    const void* ro, const void* rd, const void* t_min, const void* t_max,
    void* out_t, void* out_prim, void* out_u, void* out_v, void* out_occ,
    void* counts, void* node_seen, void* slot_seen, int R, int n_nodes,
    int n_prims, int max_leaf, int any_hit, int n_sm, void* stream) {
  const bool stats = counts != nullptr;
  if (R <= 0 || n_nodes <= 0 || n_prims <= 0 || max_leaf <= 0 || n_sm <= 0 ||
      stats != (node_seen != nullptr) || stats != (slot_seen != nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (any_hit) {
    return stats ? launch_rows<true, true>(
                       node_rows, prim_rows, prim_gid, ro, rd, t_min, t_max,
                       nullptr, nullptr, nullptr, nullptr, out_occ, counts,
                       node_seen, slot_seen, R, n_nodes, n_prims, max_leaf,
                       n_sm, s)
                 : launch_rows<true, false>(
                       node_rows, prim_rows, prim_gid, ro, rd, t_min, t_max,
                       nullptr, nullptr, nullptr, nullptr, out_occ, nullptr,
                       nullptr, nullptr, R, n_nodes, n_prims, max_leaf,
                       n_sm, s);
  }
  return stats ? launch_rows<false, true>(
                     node_rows, prim_rows, prim_gid, ro, rd, t_min, t_max,
                     out_t, out_prim, out_u, out_v, nullptr, counts,
                     node_seen, slot_seen, R, n_nodes, n_prims, max_leaf,
                     n_sm, s)
               : launch_rows<false, false>(
                     node_rows, prim_rows, prim_gid, ro, rd, t_min, t_max,
                     out_t, out_prim, out_u, out_v, nullptr, nullptr,
                     nullptr, nullptr, R, n_nodes, n_prims, max_leaf,
                     n_sm, s);
}

// The row walk's kernel as compiled: registers a thread, local (spill)
// bytes a thread and blocks an SM holds at once, of the closest (any_hit 0)
// or any-hit form, the walk (stats 0) or its STATS form.  Returns a CUDA
// error code.
extern "C" int flat_walk_rows_attrs(int any_hit, int stats, int* regs,
                                    int* local_bytes, int* blocks_per_sm) {
  cudaFuncAttributes fa;
  cudaError_t err;
  if (any_hit) {
    err = stats ? cudaFuncGetAttributes(&fa, flat_walk_rows_kernel<true, true>)
                : cudaFuncGetAttributes(&fa, flat_walk_rows_kernel<true, false>);
    *blocks_per_sm = stats ? rows_blocks_per_sm<true, true>()
                           : rows_blocks_per_sm<true, false>();
  } else {
    err = stats ? cudaFuncGetAttributes(&fa, flat_walk_rows_kernel<false, true>)
                : cudaFuncGetAttributes(&fa, flat_walk_rows_kernel<false, false>);
    *blocks_per_sm = stats ? rows_blocks_per_sm<false, true>()
                           : rows_blocks_per_sm<false, false>();
  }
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return (int)err;
}
