// dense_closest / dense_anyhit: every ray against every primitive row.
//
// Replace the Pallas kernels tpu_pt/kernels/intersect.py::_closest_kernel
// (reached through _closest_call) and ::_anyhit_kernel (through
// _anyhit_call).  Those hold 128 rays in on-chip memory and stream 128-row
// primitive tiles past them with (128, 128) vector operations.  Here one
// thread owns one ray and keeps its running best in registers; the block of
// 128 rays stages 128 rows (8 KB) at a time in shared memory with coalesced
// 16-byte loads, and every thread then walks the staged rows in slot order.
// All threads read the same shared address at the same time: a broadcast,
// no bank conflict.  The ragged last block is masked in the kernel, so the
// caller pads nothing.
//
// Bound: operations.  R x P pair tests of some sixty (triangle row) to a
// hundred (sphere row) FP32 operations each, against 64 bytes per row read
// once per block and 48 bytes per ray: the rows stay in L2.  The library is
// compiled with -fmad=false, so the ceiling is the card's non-fused FP32
// rate (SMs x 128 lanes x clock), half the data sheet's FMA figure.
//
// Ties: a sequential walk in slot order with a strict `<` keeps the lowest
// slot at equal t, as the reference's argmin inside a tile and strict
// `tile_t < best_t` across tiles do.  The range passed to the test is
// [t_min, min(t_max, best so far)] as there, so a later row at exactly the
// same t passes the range test and then loses.
//
// dense_anyhit leaves the sweep once every ray of its block is occluded or
// can never hit (t_max < t_min); the result is the same as a full sweep.
//
// Ray rows (8 floats): [ro.xyz, t_min, rd.xyz, t_max].  Primitive rows
// (16 floats): [v0, e1, e2, material bits, type, pad]; type > 0.5 is a
// sphere (v0 = centre, e1.x = radius); column 9 is a bit pattern that is
// loaded with its row and never computed on; all-zero rows never hit.
// The arithmetic is pair_isect_common.cuh's prim_test, which follows
// kernels/intersect.py::_pair_test operation by operation.

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kRays = 128;  // threads per block, one ray each
constexpr int kRows = 128;  // primitive rows staged per tile

// Copy tile `tile` (kRows rows of 16 floats) into shared memory: 512
// float4s, thread i takes i, i + 128, ... so that a warp reads 512
// contiguous bytes per load.
__device__ __forceinline__ void stage_tile(const float* __restrict__ prims,
                                           int tile, float4* s_rows) {
  const float4* src =
      reinterpret_cast<const float4*>(prims) + (size_t)tile * (kRows * 4);
  for (int i = threadIdx.x; i < kRows * 4; i += kRays) s_rows[i] = src[i];
}

__device__ __forceinline__ Prim staged_prim(const float4* s_rows, int j) {
  const float4 a = s_rows[j * 4], b = s_rows[j * 4 + 1], c = s_rows[j * 4 + 2];
  Prim p;
  p.v0x = a.x; p.v0y = a.y; p.v0z = a.z;
  p.e1x = a.w; p.e1y = b.x; p.e1z = b.y;
  p.e2x = b.z; p.e2y = b.w; p.e2z = c.x;
  p.typ = c.z;  // c.y: material bits, unused
  return p;
}

// Ray r of the (R, 8) ray rows; a ray past the end is one that never hits.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays, int r,
                                        int R) {
  Ray ray = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, -1.0f};
  if (r < R) {
    const float4* src = reinterpret_cast<const float4*>(rays) + (size_t)r * 2;
    const float4 a = src[0], b = src[1];
    ray.ox = a.x; ray.oy = a.y; ray.oz = a.z; ray.t_min = a.w;
    ray.dx = b.x; ray.dy = b.y; ray.dz = b.z; ray.t_max = b.w;
  }
  return ray;
}

__global__ void dense_closest_kernel(const float* __restrict__ rays,
                                     const float* __restrict__ prims,
                                     float* __restrict__ out_t,
                                     float* __restrict__ out_u,
                                     float* __restrict__ out_v,
                                     int* __restrict__ out_slot, int R,
                                     int n_tiles) {
  __shared__ float4 s_rows[kRows * 4];
  const int r = blockIdx.x * kRays + threadIdx.x;
  Ray ray = load_ray(rays, r, R);
  const float t_max = ray.t_max;
  float best_t = kInf, best_u = 0.0f, best_v = 0.0f;
  int best_slot = 0;
  for (int tile = 0; tile < n_tiles; tile++) {
    __syncthreads();  // the previous tile has been read by every thread
    stage_tile(prims, tile, s_rows);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < kRows; j++) {
      const Prim p = staged_prim(s_rows, j);
      ray.t_max = min_nan(t_max, best_t);
      float u, v;
      bool is_sph;
      const float t = prim_test(p, ray, u, v, is_sph);
      if (t < best_t) {
        best_t = t; best_u = u; best_v = v;
        best_slot = tile * kRows + j;
      }
    }
  }
  if (r < R) {
    out_t[r] = best_t; out_u[r] = best_u; out_v[r] = best_v;
    out_slot[r] = best_slot;
  }
}

__global__ void dense_anyhit_kernel(const float* __restrict__ rays,
                                    const float* __restrict__ prims,
                                    float* __restrict__ out_occ, int R,
                                    int n_tiles) {
  __shared__ float4 s_rows[kRows * 4];
  const int r = blockIdx.x * kRays + threadIdx.x;
  const Ray ray = load_ray(rays, r, R);
  bool occ = false;
  // done: nothing more to learn for this ray (occluded, or it can never hit).
  bool done = !(ray.t_max >= ray.t_min);
  for (int tile = 0; tile < n_tiles; tile++) {
    // Barrier (the previous tile has been read by every thread) and vote.
    if (__syncthreads_and(done)) break;
    stage_tile(prims, tile, s_rows);
    __syncthreads();
    if (!done) {
      for (int j = 0; j < kRows; j++) {
        const Prim p = staged_prim(s_rows, j);
        float u, v;
        bool is_sph;
        if (prim_test(p, ray, u, v, is_sph) < kInf) {
          occ = true;
          done = true;
          break;
        }
      }
    }
  }
  if (r < R) out_occ[r] = occ ? 1.0f : 0.0f;
}

}  // namespace

// rays (R, 8) f32, prims (P, 16) f32 with P % 128 == 0; out_t, out_u, out_v
// (R,) f32, out_slot (R,) i32.  Returns cudaGetLastError().
extern "C" int dense_closest_launch(const void* rays, const void* prims,
                                    void* out_t, void* out_u, void* out_v,
                                    void* out_slot, int R, int P,
                                    void* stream) {
  if (R > 0) {
    dense_closest_kernel<<<(R + kRays - 1) / kRays, kRays, 0,
                           (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)prims, (float*)out_t, (float*)out_u,
        (float*)out_v, (int*)out_slot, R, P / kRows);
  }
  return (int)cudaGetLastError();
}

// rays and prims as above; out_occ (R,) f32, 1.0 where any row hits inside
// [t_min, t_max].  Returns cudaGetLastError().
extern "C" int dense_anyhit_launch(const void* rays, const void* prims,
                                   void* out_occ, int R, int P, void* stream) {
  if (R > 0) {
    dense_anyhit_kernel<<<(R + kRays - 1) / kRays, kRays, 0,
                          (cudaStream_t)stream>>>(
        (const float*)rays, (const float*)prims, (float*)out_occ, R,
        P / kRows);
  }
  return (int)cudaGetLastError();
}
