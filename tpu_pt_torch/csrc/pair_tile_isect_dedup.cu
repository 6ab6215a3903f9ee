// pair_tile_isect_dedup: the function of pair_tile_isect (per (ray, cluster)
// pair, test the ray against the cluster's (12, L) tile and reduce the L
// lanes to the nearest hit, lowest lane at equal t) for a pair list that is
// SORTED BY CLUSTER ID, so that consecutive pairs mostly name the same tile.
//
// Replaces the Pallas kernel
// tpu_pt/kernels/cluster_isect.py::pair_tile_isect_dedup (_kernel_dedup).
// That kernel walks the list in groups of eight pairs on one core and saves
// DMAs by fetching a tile once when a group names one cluster.  On the H100
// the same saving comes from the caches: the kernel gives every pair SLOT a
// warp, and the warps of a block take consecutive slots of the sorted list,
// so the warps that name one tile meet it in L1 or L2 and device memory
// sends it once.  Any order of cids gives the right answer; the order only
// decides how often a tile is found in cache.
//
// Design (what bounds it, and what it does about that).  Bound: bytes, rows
// 0-9 of every distinct tile a live pair names plus the cid, ray and output
// rows; at the renderer's batches a third to a half of the slots are dead
// (live <= 0: budget padding, sorted last).  So:
// - a fixed grid of a few blocks of four warps per SM strides over the
//   slots (`blocks` comes from the wrapper, sized from the device);
// - two dependent rounds of loads lead to the arithmetic.  In the first,
//   lane j of a warp reads the cid and the ray row of the warp's j-th slot
//   (slots w, w + W, ..., W the grid's warps), so one round gives the warp
//   every slot it owns; a dead slot's miss row is written at once by the
//   lane that read it, with no tile load.  In the second, for each live
//   slot in turn, the warp reads the slot's tile, V = L / 32 lanes a thread
//   as one 16-, 8- or 4-byte load per row;
// - the test is the shared prim_test (so the bits are pair_tile_isect's),
//   the V lanes are folded in a thread and the warp reduces (t, lane) by
//   shuffles: no shared memory and no block barrier;
// - lane 0 writes the pair's 32-byte row [t, lane, u, v, 0, 0, 0, 0] as two
//   16-byte stores.

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kBlock = 128;
constexpr int kWarps = kBlock / 32;

__device__ __forceinline__ void write_row(float* __restrict__ o,
                                          const Best& b) {
  const bool found = b.t < kInf;
  float4* o4 = reinterpret_cast<float4*>(o);
  o4[0] = make_float4(b.t, (float)b.g, found ? b.u : 0.0f,
                      found ? b.v : 0.0f);
  o4[1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
}

// The pair's nearest hit over the V lanes this thread holds of tile `tile`
// (lanes lane0 .. lane0 + V - 1), lowest lane at equal t; u = v = 0 on
// sphere lanes.
template <int V>
__device__ __forceinline__ Best test_lanes(const float* __restrict__ tile,
                                           int lane0, const Ray& r) {
  constexpr int L = 32 * V;
  float rows[10][V];
#pragma unroll
  for (int row = 0; row < 10; row++)
    load_lanes<V>(tile + row * L + lane0, rows[row]);
  Best a{kInf, lane0, 0.0f, 0.0f};
#pragma unroll
  for (int x = 0; x < V; x++) {
    const Prim p{rows[0][x], rows[1][x], rows[2][x], rows[3][x], rows[4][x],
                 rows[5][x], rows[6][x], rows[7][x], rows[8][x], rows[9][x]};
    float u, v;
    bool is_sph;
    const float t = prim_test(p, r, u, v, is_sph);
    const Best b{t, lane0 + x, is_sph ? 0.0f : u, is_sph ? 0.0f : v};
    if (take_b(a, b)) a = b;
  }
  return a;
}

template <int V>
__global__ void __launch_bounds__(kBlock)
pair_tile_isect_dedup_kernel(const float* __restrict__ tiles,
                             const int* __restrict__ cid,
                             const float* __restrict__ rays,
                             float* __restrict__ out, int P, int C) {
  constexpr int L = 32 * V;
  const int lane = threadIdx.x & 31;
  const long long W = (long long)gridDim.x * kWarps;
  const long long w = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  for (long long base = w; base < P; base += 32 * W) {
    // Round 1: lane j reads slot base + j W.
    const long long s = base + lane * W;
    const bool in = s < P;
    float4 r0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), r1 = r0;
    float live = 0.0f;
    int c = 0;
    if (in) {
      const float* row = rays + s * 16;
      r0 = __ldg(reinterpret_cast<const float4*>(row));
      r1 = __ldg(reinterpret_cast<const float4*>(row + 4));
      live = __ldg(row + 8);
      c = __ldg(cid + s);
    }
    const bool is_live = in && live > 0.0f;
    if (in && !is_live) write_row(out + s * 8, Best{kInf, 0, 0.0f, 0.0f});
    // Round 2, for each live slot: its tile, the test, the reduce.
    for (unsigned m = __ballot_sync(kFull, is_live); m; m &= m - 1) {
      const int j = __ffs(m) - 1;
      Ray r;
      r.ox = __shfl_sync(kFull, r0.x, j);
      r.oy = __shfl_sync(kFull, r0.y, j);
      r.oz = __shfl_sync(kFull, r0.z, j);
      r.dx = __shfl_sync(kFull, r0.w, j);
      r.dy = __shfl_sync(kFull, r1.x, j);
      r.dz = __shfl_sync(kFull, r1.y, j);
      r.t_min = __shfl_sync(kFull, r1.z, j);
      r.t_max = __shfl_sync(kFull, r1.w, j);
      int cj = __shfl_sync(kFull, c, j);
      cj = cj < 0 ? 0 : (cj > C - 1 ? C - 1 : cj);
      Best b = test_lanes<V>(tiles + (size_t)cj * 12 * L, lane * V, r);
      warp_reduce<false>(b);
      if (lane == 0) write_row(out + (base + j * W) * 8, b);
    }
  }
}

}  // namespace

// tiles (C, 12, L) f32, cid (P,) i32 (clamped into [0, C) here), rays
// (P, 16) f32, out (P, 8) f32, all 16-byte aligned; L in {32, 64, 128};
// blocks >= 1 blocks of four warps (a few per SM is right).  Returns
// cudaGetLastError(), cudaErrorInvalidValue for operands it does not take.
extern "C" int pair_tile_isect_dedup_launch(const void* tiles, const void* cid,
                                            const void* rays, void* out, int P,
                                            int L, int C, int blocks,
                                            void* stream) {
  if ((L != 32 && L != 64 && L != 128) || C < 1 || P < 0 || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (P > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const float* t = (const float*)tiles;
    const int* c = (const int*)cid;
    const float* r = (const float*)rays;
    float* o = (float*)out;
    if (L == 128)
      pair_tile_isect_dedup_kernel<4><<<blocks, kBlock, 0, s>>>(t, c, r, o, P, C);
    else if (L == 64)
      pair_tile_isect_dedup_kernel<2><<<blocks, kBlock, 0, s>>>(t, c, r, o, P, C);
    else
      pair_tile_isect_dedup_kernel<1><<<blocks, kBlock, 0, s>>>(t, c, r, o, P, C);
  }
  return (int)cudaGetLastError();
}
