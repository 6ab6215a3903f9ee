// pair_tile_isect: per (ray, cluster) pair, test the ray against the
// cluster's (12, L) primitive tile and reduce the L lanes to the nearest
// hit, lowest lane at equal t.
//
// Replaces the Pallas kernel tpu_pt/kernels/cluster_isect.py::pair_tile_isect
// (_kernel / _mt_group).  That kernel streams tiles into on-chip memory by
// DMA, eight pairs at a time; here one block handles one pair, thread =
// primitive lane, and the tile rows (L contiguous floats each) are read
// straight from device memory with coalesced loads: no staging buffer is
// needed because every tile value is used exactly once.
//
// Bound: bytes.  A live pair reads rows 0-9 of its tile (10*L*4 bytes,
// 5 KB at L = 128; rows 10 and 11 are padding and are not fetched) against
// ~100 FP32 operations per lane; dead pairs (live <= 0) return before
// touching the tile.  Pairs of neighbouring rays often name the same tile,
// so the bytes that must come from device memory are those of the distinct
// tiles; this kernel fetches per pair and leaves the sharing to the L2 cache.
//
// Arithmetic follows _mt_group operation by operation, and the library is
// compiled with -fmad=false, so that every operation rounds once, as it
// does in the plain PyTorch version.
//
// Tile rows: [v0.xyz, e1.xyz, e2.xyz, type, 0, 0]; type > 0.5 is a sphere
// lane (v0 = centre, e1.x = radius); all-zero lanes are padding.
// Ray rows (16 floats): [ro.xyz, rd.xyz, t_min, t_max, live, pad...].
// Output rows (8 floats): [t, lane, u, v, 0, 0, 0, 0], t = 1e30 on miss.

#include <cuda_runtime.h>

namespace {

constexpr float kInf = 1e30f;

// max(x, 0) that keeps a NaN, like the array libraries' maximum().
__device__ __forceinline__ float max_nan(float x, float lo) {
  return (x > lo || x != x) ? x : lo;
}

// (t, lane) ordering: smaller t first, lower lane at equal t.
__device__ __forceinline__ bool better(float tb, int lb, float ta, int la) {
  return (tb < ta) || (tb == ta && lb < la);
}

__global__ void pair_tile_isect_kernel(const float* __restrict__ tiles,
                                       const int* __restrict__ cid,
                                       const float* __restrict__ rays,
                                       float* __restrict__ out, int L) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ray = rays + (size_t)p * 16;
  float* o = out + (size_t)p * 8;

  const float live = ray[8];
  if (!(live > 0.0f)) {  // dead pair: miss, no tile fetch
    if (lane < 8) o[lane] = (lane == 0) ? kInf : 0.0f;
    return;
  }

  const float ox = ray[0], oy = ray[1], oz = ray[2];
  const float dx = ray[3], dy = ray[4], dz = ray[5];
  const float t_min = ray[6], t_max = ray[7];

  const float* tile = tiles + (size_t)cid[p] * 12 * L + lane;
  const float v0x = tile[0 * L], v0y = tile[1 * L], v0z = tile[2 * L];
  const float e1x = tile[3 * L], e1y = tile[4 * L], e1z = tile[5 * L];
  const float e2x = tile[6 * L], e2y = tile[7 * L], e2z = tile[8 * L];
  const float typ = tile[9 * L];

  // pvec = rd x e2
  const float px = dy * e2z - dz * e2y;
  const float py = dz * e2x - dx * e2z;
  const float pz = dx * e2y - dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool par = fabsf(det) < 1e-12f;
  const float inv_det = par ? 0.0f : 1.0f / (par ? 1.0f : det);
  const float tvx = ox - v0x, tvy = oy - v0y, tvz = oz - v0z;
  const float u = (tvx * px + tvy * py + tvz * pz) * inv_det;
  // qvec = tvec x e1
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float v = (dx * qx + dy * qy + dz * qz) * inv_det;
  const float t_tri = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok_tri = !par && (u >= 0.0f) && (v >= 0.0f) && (u + v <= 1.0f) &&
                      (t_tri >= t_min) && (t_tri <= t_max);

  // Sphere lanes: v0 = centre, e1.x = radius.
  const float a = dx * dx + dy * dy + dz * dz;
  const float b = 2.0f * (tvx * dx + tvy * dy + tvz * dz);
  const float c = tvx * tvx + tvy * tvy + tvz * tvz - e1x * e1x;
  const float disc = b * b - 4.0f * a * c;
  const bool has = disc >= 0.0f;
  const float sq = sqrtf(max_nan(disc, 0.0f));
  const float inv2a = 1.0f / max_nan(2.0f * a, 1e-20f);
  const float s0 = (-b - sq) * inv2a;
  const float s1 = (-b + sq) * inv2a;
  const bool ok0 = has && (s0 >= t_min) && (s0 <= t_max);
  const bool ok1 = has && (s1 >= t_min) && (s1 <= t_max);
  const float t_sph = ok0 ? s0 : s1;
  const bool ok_sph = ok0 || ok1;

  const bool is_sph = typ > 0.5f;
  const bool ok = is_sph ? ok_sph : ok_tri;
  const float t = ok ? (is_sph ? t_sph : t_tri) : kInf;

  // Block reduce of (t, lane): shuffles inside a warp, shared memory across
  // the (at most 4) warps.
  float bt = t;
  int bl = lane;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ot = __shfl_down_sync(0xffffffffu, bt, off);
    const int ol = __shfl_down_sync(0xffffffffu, bl, off);
    if (better(ot, ol, bt, bl)) { bt = ot; bl = ol; }
  }
  __shared__ float s_t[4];
  __shared__ int s_l[4];
  __shared__ int s_win;
  const int warp = lane >> 5;
  const int n_warps = (blockDim.x + 31) >> 5;
  if ((lane & 31) == 0) { s_t[warp] = bt; s_l[warp] = bl; }
  __syncthreads();
  if (lane == 0) {
    for (int w = 1; w < n_warps; w++)
      if (better(s_t[w], s_l[w], bt, bl)) { bt = s_t[w]; bl = s_l[w]; }
    s_win = bl;
    s_t[0] = bt;
  }
  __syncthreads();
  if (lane == s_win) {
    const bool found = s_t[0] < kInf;
    o[0] = s_t[0];
    o[1] = (float)lane;
    o[2] = (found && !is_sph) ? u : 0.0f;
    o[3] = (found && !is_sph) ? v : 0.0f;
    o[4] = 0.0f; o[5] = 0.0f; o[6] = 0.0f; o[7] = 0.0f;
  }
}

}  // namespace

// tiles (C, 12, L) f32, cid (P,) i32 in [0, C), rays (P, 16) f32,
// out (P, 8) f32; L in {32, 64, 128}.  Returns cudaGetLastError().
extern "C" int pair_tile_isect_launch(const void* tiles, const void* cid,
                                      const void* rays, void* out, int P,
                                      int L, void* stream) {
  if (P > 0) {
    pair_tile_isect_kernel<<<P, L, 0, (cudaStream_t)stream>>>(
        (const float*)tiles, (const int*)cid, (const float*)rays, (float*)out,
        L);
  }
  return (int)cudaGetLastError();
}
