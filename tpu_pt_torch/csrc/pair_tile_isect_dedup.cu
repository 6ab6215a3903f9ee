// pair_tile_isect_dedup: the function of pair_tile_isect (per (ray, cluster)
// pair, test the ray against the cluster's (12, L) tile and reduce the L
// lanes to the nearest hit, lowest lane at equal t) for a pair list that is
// SORTED BY CLUSTER ID, so that consecutive pairs mostly name the same tile.
//
// Replaces the Pallas kernel
// tpu_pt/kernels/cluster_isect.py::pair_tile_isect_dedup (_kernel_dedup).
// That kernel saves tile traffic by issuing one DMA instead of eight when a
// group of eight pairs names one cluster, and falls back to eight DMAs as
// soon as one pair of the group differs.  Here a block of L threads (thread
// = primitive lane) owns a RUN of kRun consecutive pairs and keeps its
// lane's ten tile values in registers; it reloads them only when cid[p]
// differs from the cluster it holds.  A run that straddles two clusters
// therefore costs two fetches, not eight, and any order of cids gives the
// right answer: sorting only decides how many fetches are saved.
//
// Bound: bytes, as for pair_tile_isect: rows 0-9 (10*L*4 bytes) of each
// distinct tile that a live pair names, plus the cid, ray and output rows.
// This kernel fetches once per (run, cluster) change among the live pairs
// of a run; dead pairs (live <= 0) write the miss row and fetch nothing.
//
// kRun = 8: the pair count is a multiple of 128, so 8 always divides it; it
// is the group size of the kernel this one replaces; and at the pair
// budgets the traversal uses (4096 and 6144 pairs a call) it still gives
// 512 and 768 blocks, several per SM on 132 SMs, where a longer run would
// save more fetches but leave SMs without a block.
//
// Tile, ray and output rows as in pair_tile_isect.cu; the test and the
// block reduce are the shared ones of pair_isect_common.cuh, so on the same
// (cid, ray) rows the two kernels agree bit for bit.

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kRun = 8;

__global__ void pair_tile_isect_dedup_kernel(const float* __restrict__ tiles,
                                             const int* __restrict__ cid,
                                             const float* __restrict__ rays,
                                             float* __restrict__ out, int L) {
  const int lane = threadIdx.x;
  const int p0 = blockIdx.x * kRun;
  // Two scratch sets, used in turn: a thread may still read the winner of
  // one pair while another warp already reduces the next.
  __shared__ ReduceScratch scratch[2];
  int buf = 0;
  int held = -1;  // cluster whose tile lane is in `prim`
  Prim prim = {};
  for (int k = 0; k < kRun; k++) {
    const int p = p0 + k;
    const float* ray = rays + (size_t)p * 16;
    float* o = out + (size_t)p * 8;
    if (!(ray[8] > 0.0f)) {  // dead pair (the whole block sees it): miss
      write_miss_pair(lane, o);
      continue;
    }
    const int c = cid[p];
    if (c != held) {
      prim = load_tile_lane(tiles, c, L, lane);
      held = c;
    }
    const Ray r = load_pair_ray(ray);
    float u, v;
    bool is_sph;
    const float t = prim_test(prim, r, u, v, is_sph);
    reduce_write_pair(t, u, v, is_sph, lane, &scratch[buf], o);
    buf ^= 1;
  }
}

}  // namespace

// tiles (C, 12, L) f32, cid (P,) i32 in [0, C), rays (P, 16) f32,
// out (P, 8) f32; L in {32, 64, 128}; P a multiple of 8.  Returns
// cudaGetLastError().
extern "C" int pair_tile_isect_dedup_launch(const void* tiles, const void* cid,
                                            const void* rays, void* out, int P,
                                            int L, void* stream) {
  if (P > 0) {
    pair_tile_isect_dedup_kernel<<<P / kRun, L, 0, (cudaStream_t)stream>>>(
        (const float*)tiles, (const int*)cid, (const float*)rays, (float*)out,
        L);
  }
  return (int)cudaGetLastError();
}
