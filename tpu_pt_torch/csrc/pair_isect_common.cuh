// Device functions shared by the ray/primitive kernels of this library
// (pair_tile_isect.cu, pair_tile_isect_dedup.cu, pair_ray_reduce.cu,
// pair_segmin.cu, dense_isect.cu, packed_walk.cu, flat_walk.cu): the
// Möller–Trumbore / sphere test of one ray against one primitive, the
// walks' primitive-row load and NaN map, the block reduce of the
// pair-tile kernel, the (t, gid) combine of the per-ray reduces, and the
// warp-per-pair kernels' tile loads and warp reduce.
//
// The arithmetic follows the plain PyTorch versions
// (kernels/cluster_isect.py::_mt_group, kernels/intersect.py::_pair_test,
// kernels/packed_walk.py::_prim_row_test) operation by operation, and the
// library is compiled with -fmad=false, so that every operation rounds
// once, as it does there: kernel and plain version agree bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace pair_isect {

constexpr float kInf = 1e30f;
constexpr unsigned kFull = 0xffffffffu;

// max(x, lo) / min(x, hi) that keep a NaN in x, like the array libraries'
// maximum() / minimum().
__device__ __forceinline__ float max_nan(float x, float lo) {
  return (x > lo || x != x) ? x : lo;
}
__device__ __forceinline__ float min_nan(float x, float hi) {
  return (x < hi || x != x) ? x : hi;
}

// (t, lane) ordering: smaller t first, lower lane at equal t.
__device__ __forceinline__ bool better(float tb, int lb, float ta, int la) {
  return (tb < ta) || (tb == ta && lb < la);
}

// A ray's running nearest hit in the per-ray reduces (pair_segmin.cu,
// pair_ray_reduce.cu).
struct Best {
  float t;
  int g;
  float u, v;
};

// The reduces' combine: b replaces a iff it is nearer, or as near with the
// lower primitive id.  Selection only, so every evaluation order gives the
// same bits.
__device__ __forceinline__ bool take_b(const Best& a, const Best& b) {
  return (b.t < a.t) || (b.t == a.t && b.g < a.g);
}

// The warp's best into its lane 0 (any hit: only t is kept).
template <bool ANY>
__device__ __forceinline__ void warp_reduce(Best& a) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best b;
    b.t = __shfl_down_sync(kFull, a.t, off);
    if constexpr (ANY) {
      if (b.t < a.t) a.t = b.t;
    } else {
      b.g = __shfl_down_sync(kFull, a.g, off);
      b.u = __shfl_down_sync(kFull, a.u, off);
      b.v = __shfl_down_sync(kFull, a.v, off);
      if (take_b(a, b)) a = b;
    }
  }
}

// V consecutive lanes of one tile row (or gid row) as one 16-, 8- or 4-byte
// load: a warp reads 32 V neighbouring words.  p must be aligned to 4 V bytes.
template <int V>
__device__ __forceinline__ void load_lanes(const float* __restrict__ p,
                                           float (&x)[V]) {
  if constexpr (V == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (V == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(p));
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_lanes(const int* __restrict__ p,
                                           int (&x)[V]) {
  if constexpr (V == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(p));
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  } else if constexpr (V == 2) {
    const int2 q = __ldg(reinterpret_cast<const int2*>(p));
    x[0] = q.x; x[1] = q.y;
  } else {
    x[0] = __ldg(p);
  }
}

// One primitive: triangle (v0, e1, e2) or, where typ > 0.5, sphere
// (v0 = centre, e1x = radius).  All zeros is padding and never hits.
struct Prim {
  float v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, typ;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz, t_min, t_max;
};

// x, or `to` where x is NaN: the walks' slab test maps a NaN near to -inf
// and a NaN far to +inf (core/aabb.py::slab_test).
__device__ __forceinline__ float nan_to(float x, float to) {
  return x != x ? to : x;
}

// The walks' cull bound: x (1 + 2^-14) where x >= 0 (and NaN), x (1 -
// 2^-14) where x < 0, one multiply: x + |x| 2^-14 rounded once, upward for
// either sign, inf, -inf, 0 and NaN kept.  A walk enters a node iff its
// slab entry is <= widen_up(min(slab exit, best t)), so that the slab t and
// a primitive's t rounding apart (coplanar faces; a skew face hit at its
// edge by a rounding) cull no box that holds the nearest (t, lowest id);
// why this width: kernels/packed_walk.py::widen_up, the same multiply.
__device__ __forceinline__ float widen_up(float x) {
  return x * (x < 0.0f ? 0.99993896484375f : 1.00006103515625f);
}

// Primitive row `slot` of a (P, 16) f32 table in bvh/packed.py's row
// format: v0, e1, e2, then material bits (not loaded: unused) and type.
// Three 16-byte loads; the table must be 16-byte aligned.
__device__ __forceinline__ Prim load_prim(const float4* __restrict__ prims,
                                          int slot) {
  const float4* row = prims + (size_t)slot * 4;
  const float4 p0 = __ldg(row), p1 = __ldg(row + 1), p2 = __ldg(row + 2);
  Prim p;
  p.v0x = p0.x; p.v0y = p0.y; p.v0z = p0.z;
  p.e1x = p0.w; p.e1y = p1.x; p.e1z = p1.y;
  p.e2x = p1.z; p.e2y = p1.w; p.e2z = p2.x;
  p.typ = p2.z;
  return p;
}

// Lane `lane` of tile `cid` of a (C, 12, L) tile array: rows 0-9 (rows 10
// and 11 are padding and are not fetched).  Neighbouring lanes read
// neighbouring addresses of each row.
__device__ __forceinline__ Prim load_tile_lane(const float* __restrict__ tiles,
                                               int cid, int L, int lane) {
  const float* tile = tiles + (size_t)cid * 12 * L + lane;
  Prim p;
  p.v0x = tile[0 * L]; p.v0y = tile[1 * L]; p.v0z = tile[2 * L];
  p.e1x = tile[3 * L]; p.e1y = tile[4 * L]; p.e1z = tile[5 * L];
  p.e2x = tile[6 * L]; p.e2y = tile[7 * L]; p.e2z = tile[8 * L];
  p.typ = tile[9 * L];
  return p;
}

// The ray-sphere solve of every kernel: core/intersect.py::sphere_hit, in
// its operation order (oc = origin - centre, d the direction, r the radius).
// Haines et al.'s well-conditioned form (Ray Tracing Gems, ch. 7): the
// discriminant a (r^2 - |l|^2), l = oc - (b/a) d, and the roots q/a and c/q,
// q = -b - sign(b) sqrt(disc), none of which cancels near tangency or where
// the origin lies on the sphere.  t is the near root inside [t_min, t_max],
// else the far one; a miss where disc <= 0 (every ray on a radius-0 sphere),
// q = 0 or a = 0 (NaN).  Selects, not fminf/fmaxf, order the roots, so NaN
// takes the same path as in torch.  b/a and q/a multiply by one 1/a.  A
// ray with disc <= 0 (or NaN) returns at once and leaves t as it was: the
// miss that the Python form selects, and every caller reads t only on a
// hit.  So the radius-0 placeholder, the only sphere of a mesh scene, costs
// no square root and one division; with both, the kernels that include this
// use as many registers as with the old b^2 - 4ac solve (chip_smoke.py's
// build line prints them).
__device__ __forceinline__ bool sphere_hit(float ocx, float ocy, float ocz,
                                           float dx, float dy, float dz,
                                           float rad, float t_min,
                                           float t_max, float& t) {
  const float rr = rad * rad;
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = ocx * dx + ocy * dy + ocz * dz;  // half the quadratic's b
  const float inv_a = 1.0f / a;
  const float k = b * inv_a;
  const float lx = ocx - k * dx;
  const float ly = ocy - k * dy;
  const float lz = ocz - k * dz;
  const float disc = a * (rr - (lx * lx + ly * ly + lz * lz));
  if (!(disc > 0.0f)) return false;
  const float c = ocx * ocx + ocy * ocy + ocz * ocz - rr;
  const float sq = sqrtf(disc);  // max(disc, 0) in the Python form
  const float q = (b < 0.0f) ? sq - b : -b - sq;
  const float r0 = q * inv_a;
  const float r1 = c / q;
  const bool swap = r1 < r0;
  const float s0 = swap ? r1 : r0;
  const float s1 = swap ? r0 : r1;
  const bool has = q != 0.0f;
  const bool ok0 = has && (s0 >= t_min) && (s0 <= t_max);
  const bool ok1 = has && (s1 >= t_min) && (s1 <= t_max);
  t = ok0 ? s0 : s1;
  return ok0 || ok1;
}

// Whether the ray hits the primitive inside [t_min, t_max], and where (t).
// u, v are the triangle branch's barycentrics, for sphere primitives too
// (0 there: e2 = 0 gives det = 0 and inv_det = 0).  The sphere's quadratic
// is evaluated only for sphere primitives; its result is selected, never
// mixed, so skipping it changes no bit.
__device__ __forceinline__ bool prim_hit(const Prim& p, const Ray& r,
                                         float& t, float& u, float& v,
                                         bool& is_sph) {
  // pvec = rd x e2
  const float px = r.dy * p.e2z - r.dz * p.e2y;
  const float py = r.dz * p.e2x - r.dx * p.e2z;
  const float pz = r.dx * p.e2y - r.dy * p.e2x;
  const float det = p.e1x * px + p.e1y * py + p.e1z * pz;
  const bool par = fabsf(det) < 1e-12f;
  const float inv_det = par ? 0.0f : 1.0f / (par ? 1.0f : det);
  const float tvx = r.ox - p.v0x, tvy = r.oy - p.v0y, tvz = r.oz - p.v0z;
  u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = tvy * p.e1z - tvz * p.e1y;
  const float qy = tvz * p.e1x - tvx * p.e1z;
  const float qz = tvx * p.e1y - tvy * p.e1x;
  v = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float t_tri = (p.e2x * qx + p.e2y * qy + p.e2z * qz) * inv_det;
  is_sph = p.typ > 0.5f;
  if (!is_sph) {
    t = t_tri;
    return !par && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
           (t_tri >= r.t_min) && (t_tri <= r.t_max);
  }
  return sphere_hit(tvx, tvy, tvz, r.dx, r.dy, r.dz, p.e1x, r.t_min, r.t_max,
                    t);
}

// Hit distance of the ray on the primitive inside [t_min, t_max], kInf on a
// miss (prim_hit's t where it hits).
__device__ __forceinline__ float prim_test(const Prim& p, const Ray& r,
                                           float& u, float& v, bool& is_sph) {
  float t;
  return prim_hit(p, r, t, u, v, is_sph) ? t : kInf;
}

// Scratch of one block reduce (at most 4 warps).
struct ReduceScratch {
  float t[4];
  int lane[4];
  int win;
};

// Reduce the block's (t, lane) to the nearest hit, lowest lane at equal t,
// and let the winning lane write the pair's output row
// [t, lane, u, v, 0, 0, 0, 0] (u = v = 0 on a miss and on sphere lanes).
// Shuffles inside a warp, shared memory across the warps.  Every thread of
// the block must call it; `s` must not be in use by another reduce that a
// thread of the block may still be reading.
__device__ __forceinline__ void reduce_write_pair(float t, float u, float v,
                                                  bool is_sph, int lane,
                                                  ReduceScratch* s,
                                                  float* __restrict__ o) {
  float bt = t;
  int bl = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_down_sync(0xffffffffu, bt, off);
    const int ol = __shfl_down_sync(0xffffffffu, bl, off);
    if (better(ot, ol, bt, bl)) { bt = ot; bl = ol; }
  }
  const int warp = lane >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  if ((lane & 31) == 0) { s->t[warp] = bt; s->lane[warp] = bl; }
  __syncthreads();
  if (lane == 0) {
    for (int w = 1; w < n_warps; w++)
      if (better(s->t[w], s->lane[w], bt, bl)) { bt = s->t[w]; bl = s->lane[w]; }
    s->win = bl;
    s->t[0] = bt;
  }
  __syncthreads();
  if (lane == s->win) {
    const bool found = s->t[0] < kInf;
    o[0] = s->t[0];
    o[1] = (float)lane;
    o[2] = (found && !is_sph) ? u : 0.0f;
    o[3] = (found && !is_sph) ? v : 0.0f;
    o[4] = 0.0f; o[5] = 0.0f; o[6] = 0.0f; o[7] = 0.0f;
  }
}

// The output row of a dead pair (live <= 0): a miss, written by lanes 0-7.
__device__ __forceinline__ void write_miss_pair(int lane,
                                                float* __restrict__ o) {
  if (lane < 8) o[lane] = (lane == 0) ? kInf : 0.0f;
}

// Ray row of the pair kernels (16 floats):
// [ro.xyz, rd.xyz, t_min, t_max, live, pad...].
__device__ __forceinline__ Ray load_pair_ray(const float* __restrict__ ray) {
  Ray r;
  r.ox = ray[0]; r.oy = ray[1]; r.oz = ray[2];
  r.dx = ray[3]; r.dy = ray[4]; r.dz = ray[5];
  r.t_min = ray[6]; r.t_max = ray[7];
  return r;
}

}  // namespace pair_isect
