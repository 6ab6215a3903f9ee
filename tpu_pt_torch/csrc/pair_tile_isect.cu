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
// does in the plain PyTorch version.  The test and the block reduce live in
// pair_isect_common.cuh, shared with the cluster-major variant of this
// kernel (pair_tile_isect_dedup.cu).
//
// Tile rows: [v0.xyz, e1.xyz, e2.xyz, type, 0, 0]; type > 0.5 is a sphere
// lane (v0 = centre, e1.x = radius); all-zero lanes are padding.
// Ray rows (16 floats): [ro.xyz, rd.xyz, t_min, t_max, live, pad...].
// Output rows (8 floats): [t, lane, u, v, 0, 0, 0, 0], t = 1e30 on miss.

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

__global__ void pair_tile_isect_kernel(const float* __restrict__ tiles,
                                       const int* __restrict__ cid,
                                       const float* __restrict__ rays,
                                       float* __restrict__ out, int L) {
  const int p = blockIdx.x;
  const int lane = threadIdx.x;
  const float* ray = rays + (size_t)p * 16;
  float* o = out + (size_t)p * 8;

  if (!(ray[8] > 0.0f)) {  // dead pair: miss, no tile fetch
    write_miss_pair(lane, o);
    return;
  }
  const Ray r = load_pair_ray(ray);
  const Prim prim = load_tile_lane(tiles, cid[p], L, lane);
  float u, v;
  bool is_sph;
  const float t = prim_test(prim, r, u, v, is_sph);
  __shared__ ReduceScratch scratch;
  reduce_write_pair(t, u, v, is_sph, lane, &scratch, o);
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
