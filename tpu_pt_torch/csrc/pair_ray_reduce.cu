// pair_ray_reduce: per ray, test the ray against the primitive tile of every
// (ray, cluster) pair in its segment [right - cnt, right) of the ray-major
// pair list and reduce all lanes of all those tiles to the lexicographic
// (t, gid) minimum, in one launch.
//
// Replaces, as one stage, the two Pallas kernels
// tpu_pt/kernels/cluster_isect.py::pair_tile_isect (tile test, lane argmin per
// pair) and tpu_pt/kernels/pair_scan.py::pair_segmin_scan (segmented (t, gid)
// min over the pair list), and the array code between and around them.  The
// TPU needs the split: its pair kernel streams (P, 16) ray rows and tiles by
// DMA and writes a (P, 8) row per pair, which the scan kernel reads again.
// Here the kernel takes the traversal's own tensors (int64 cluster ids and
// segment bounds), finds or gathers its ray by index and writes one masked
// row per RAY.
//
// The result is the split stage's (pair_tile_isect.cu -> tile_gid gather ->
// pair_segmin.cu -> masks) bit for bit: the test is the shared prim_test, the
// combine is the shared take_b, and both only SELECT.  The split stage takes
// the lowest lane at equal t inside a tile and the lowest gid across tiles;
// the lanes of a tile are sorted by primitive id when the tree is built, so
// that is the (t, gid) minimum over all lanes of all pairs, which is what
// this kernel takes.  prim_test never returns NaN.
//
// The kernel is PAIR-MAJOR: one warp per pair SLOT, each thread L / 32 lanes
// of the tile, loaded as one word.  A ray's segment is short on average
// (2 pairs) but has a long tail (33 pairs and more for a grazing ray), and a
// walk over it by one group of threads is a chain of dependent fetches (a
// ray-major grid, a warp or a block per ray, took 2.3 to 4 times as long on
// an H100 at the renderer's batches); spread over warps, every live pair of
// the batch is in flight at once.  The grid is a fixed number of warps that
// stride over the LIVE slots (those below right[Q - 1]), so dead slots of
// the static budget cost nothing.  The warp finds its ray by a 32-way search
// of `right` (two rounds for 1,024 rays; `right` stays in cache) while its
// tile is in flight, so that slots and segments come from one source and
// always agree; the last round brings the ray itself along.  A ray with one
// pair is written at once.  Otherwise the warp stores its pair's winner in
// `scratch` and counts itself in on the ray's counter (a release and acquire
// at device scope); the warp that arrives last reduces the segment's winners
// and writes the ray's row (the pattern of a reduce finished by the last
// block).  It also sets the counter back to 0: the counters are zero before
// and after every launch, so the wrapper clears them once, when it makes
// them.  Rays without pairs get their miss row from the grid's threads, one
// ray each.
//
// Bound: bytes.  Rows 0-9 of every DISTINCT tile a live pair names (and, for
// the closest hit, its row of tile_gid), 8 B of cid per live pair, 48 B in
// and 16 B out (closest) or 1 B out (any hit) per ray; ~100 FP32 operations a
// lane.  The kernel fetches per pair and leaves tile sharing to the L2 cache.

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kBlock = 128;

// The kernel's operands.
struct Args {
  const float* __restrict__ tiles;      // (C, 12, L)
  const int* __restrict__ tile_gid;     // (C, L)
  const float* __restrict__ ro;         // (Q, 3)
  const float* __restrict__ rd;         // (Q, 3)
  const float* __restrict__ t_min;      // (Q,)
  const float* __restrict__ t_max;      // (Q,)
  const long long* __restrict__ cid;    // (P,)
  const long long* __restrict__ cnt;    // (Q,)
  const long long* __restrict__ right;  // (Q,), not decreasing
  float* __restrict__ out_t;            // closest hit: (Q,) each
  int* __restrict__ out_g;
  float* __restrict__ out_u;
  float* __restrict__ out_v;
  unsigned char* __restrict__ out_occ;  // any hit: (Q,)
  float4* scratch;                      // (P,) winners, one per pair
  int* count;                           // (Q,) arrivals, all 0
  int Q;
  long long P;
  int C, L;
};

// Ray q's segment [start, end) of the pair list, held inside [0, P] and
// behind the segment of the ray before it, whatever the operands say.
struct Seg {
  long long start, end;
};

__device__ __forceinline__ long long clamp_pos(long long x, long long P) {
  return x < 0 ? 0 : (x > P ? P : x);
}

__device__ __forceinline__ Seg segment(const Args& a, int q) {
  Seg s;
  s.end = clamp_pos(a.right[q], a.P);
  const long long prev = q > 0 ? clamp_pos(a.right[q - 1], a.P) : 0;
  const long long n = a.cnt[q];
  s.start = n > 0 ? s.end - n : s.end;
  if (s.start < prev) s.start = prev;
  return s;
}

__device__ __forceinline__ Ray load_ray(const Args& a, int q) {
  Ray r;
  r.ox = a.ro[3 * q]; r.oy = a.ro[3 * q + 1]; r.oz = a.ro[3 * q + 2];
  r.dx = a.rd[3 * q]; r.dy = a.rd[3 * q + 1]; r.dz = a.rd[3 * q + 2];
  r.t_min = a.t_min[q];
  r.t_max = a.t_max[q];
  return r;
}

// Neutral element of the combine: loses to every hit.
__device__ __forceinline__ Best no_hit() {
  return Best{kInf, 0x7fffffff, 0.0f, 0.0f};
}

// V lanes of one tile, as loaded.
template <int V>
struct TileLanes {
  float rows[10][V];
  int gid[V];
};

template <int V, bool ANY>
__device__ __forceinline__ void load_tile(const Args& a, long long c,
                                          int lane0, TileLanes<V>& t) {
  c = c < 0 ? 0 : (c > a.C - 1 ? a.C - 1 : c);
  const float* tile = a.tiles + (size_t)c * 12 * a.L + lane0;
#pragma unroll
  for (int row = 0; row < 10; row++)
    load_lanes<V>(tile + row * a.L, t.rows[row]);
  if constexpr (!ANY) load_lanes<V>(a.tile_gid + (size_t)c * a.L + lane0, t.gid);
}

// Fold the V lanes into the running best (any hit: only t is kept).
template <int V, bool ANY>
__device__ __forceinline__ void fold_tile(const TileLanes<V>& t, const Ray& r,
                                          Best& a) {
#pragma unroll
  for (int x = 0; x < V; x++) {
    const Prim p{t.rows[0][x], t.rows[1][x], t.rows[2][x], t.rows[3][x],
                 t.rows[4][x], t.rows[5][x], t.rows[6][x], t.rows[7][x],
                 t.rows[8][x], t.rows[9][x]};
    float u, v;
    bool is_sph;
    const float tt = prim_test(p, r, u, v, is_sph);
    if constexpr (ANY) {
      if (tt < a.t) a.t = tt;
    } else {
      const Best b{tt, t.gid[x], is_sph ? 0.0f : u, is_sph ? 0.0f : v};
      if (take_b(a, b)) a = b;
    }
  }
}

// Ray q's output row, masked as the split stage masks it.
template <bool ANY>
__device__ __forceinline__ void write_ray(const Args& a, int q,
                                          const Best& b) {
  const bool has = b.t < kInf;
  if constexpr (ANY) {
    a.out_occ[q] = has ? 1 : 0;
  } else {
    a.out_t[q] = has ? b.t : kInf;
    a.out_g[q] = has ? b.g : 0;
    a.out_u[q] = has ? b.u : 0.0f;
    a.out_v[q] = has ? b.v : 0.0f;
  }
}

// The warp's search for the ray of slot p: the first ray whose `right` lies
// beyond p, among the candidates [lo, hi).  All lanes call these with the
// same p.
//
// One coarse round: lane i reads the last `right` of chunk i (32 chunks of
// `step` rays) and the range becomes the first chunk that ends beyond p.
// False where no ray lies beyond p (a dead slot of the budget).
__device__ __forceinline__ bool narrow(const Args& a, long long p, int lane,
                                       int& lo, int& hi) {
  const int step = (hi - lo + 31) / 32;
  const int idx = lo + (lane + 1) * step - 1;
  const long long probe = idx < hi ? a.right[idx] : 0x7fffffffffffffffLL;
  const unsigned m = __ballot_sync(kFull, probe > p);
  if (m == 0) return false;
  lo += (__ffs(m) - 1) * step;
  if (lo + step < hi) hi = lo + step;
  return true;
}

// The last round, over at most 32 candidates: lane i reads ray lo + i's
// segment bounds AND its origin, direction and t range, all in one round of
// loads, and the lane of the slot's ray hands them to the warp by shuffle.
// False where the slot belongs to no ray.
__device__ __forceinline__ bool resolve(const Args& a, long long p, int lane,
                                        int lo, int hi, int& q, Seg& s,
                                        Ray& r) {
  const int i = lo + lane;
  const bool in = i < hi;
  const long long end_i = in ? a.right[i] : 0x7fffffffffffffffLL;
  const long long prev_i = in && i > 0 ? a.right[i - 1] : 0;
  const long long cnt_i = in ? a.cnt[i] : 0;
  Ray ri{};
  if (in) ri = load_ray(a, i);
  const unsigned m = __ballot_sync(kFull, end_i > p);
  if (m == 0) return false;
  const int w = __ffs(m) - 1;
  if (lo + w >= hi) return false;
  q = lo + w;
  s.end = clamp_pos(__shfl_sync(kFull, end_i, w), a.P);
  const long long prev = clamp_pos(__shfl_sync(kFull, prev_i, w), a.P);
  const long long n = __shfl_sync(kFull, cnt_i, w);
  s.start = n > 0 ? s.end - n : s.end;
  if (s.start < prev) s.start = prev;
  r.ox = __shfl_sync(kFull, ri.ox, w);
  r.oy = __shfl_sync(kFull, ri.oy, w);
  r.oz = __shfl_sync(kFull, ri.oz, w);
  r.dx = __shfl_sync(kFull, ri.dx, w);
  r.dy = __shfl_sync(kFull, ri.dy, w);
  r.dz = __shfl_sync(kFull, ri.dz, w);
  r.t_min = __shfl_sync(kFull, ri.t_min, w);
  r.t_max = __shfl_sync(kFull, ri.t_max, w);
  return p >= s.start && p < s.end;
}

// Count one arrival on a ray's counter: a release of the winner this thread
// stored before it and an acquire of those stored before earlier arrivals.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// One pair slot p < P, by one warp.  Two rounds of dependent loads lead to
// the arithmetic: the cluster id and the first search round; then the tile
// (it needs the id only) and the last search round, which brings the ray.
template <int V, bool ANY>
__device__ __forceinline__ void pair_slot(const Args& a, long long p,
                                          int lane) {
  const long long c = a.cid[p];
  int lo = 0, hi = a.Q;
  if (hi - lo > 32 && !narrow(a, p, lane, lo, hi)) return;
  TileLanes<V> tile;
  load_tile<V, ANY>(a, c, lane * V, tile);
  while (hi - lo > 32)
    if (!narrow(a, p, lane, lo, hi)) return;
  int q;
  Seg s;
  Ray r;
  if (!resolve(a, p, lane, lo, hi, q, s, r)) return;

  Best best = no_hit();
  fold_tile<V, ANY>(tile, r, best);
  warp_reduce<ANY>(best);

  const int n = (int)(s.end - s.start);
  if (n == 1) {
    if (lane == 0) write_ray<ANY>(a, q, best);
    return;
  }
  // Publish this pair's winner, then count in; the last to arrive sees all.
  int last = 0;
  if (lane == 0) {
    a.scratch[p] = make_float4(best.t, __int_as_float(best.g), best.u, best.v);
    last = arrive(&a.count[q]) == n - 1;
  }
  last = __shfl_sync(kFull, last, 0);
  if (!last) return;
  __syncwarp();                  // lane 0's acquire, for the whole warp
  best = no_hit();
  for (long long j = s.start + lane; j < s.end; j += 32) {
    const float4 w = __ldcg(&a.scratch[j]);
    const Best b{w.x, __float_as_int(w.y), w.z, w.w};
    if (take_b(best, b)) best = b;
  }
  warp_reduce<false>(best);
  if (lane == 0) {
    write_ray<ANY>(a, q, best);
    a.count[q] = 0;              // zero again for the next launch
  }
}

// The grid is a fixed number of warps (a few per SM); each takes the slots
// p, p + warps, ... below right[Q - 1]: the dead slots of the static budget
// cost nothing.  A warp's first slot is taken before that bound has arrived
// (the search finds a dead slot by itself).
template <int V, bool ANY>
__global__ void __launch_bounds__(kBlock)
pair_major_kernel(const Args a) {
  const int lane = threadIdx.x & 31;
  const long long live = a.right[a.Q - 1];
  // Rays without pairs get their miss row from the grid's threads, a ray
  // each: the segment is read now and the row written after the slots, so
  // that the read does not hold the slots back.
  const long long n_threads = (long long)gridDim.x * kBlock;
  const long long g0 = (long long)blockIdx.x * kBlock + threadIdx.x;
  Seg mine{0, 1};
  if (g0 < a.Q) mine = segment(a, (int)g0);

  const long long n_warps = (long long)gridDim.x * (kBlock / 32);
  long long p = (long long)blockIdx.x * (kBlock / 32) + (threadIdx.x >> 5);
  if (p < a.P) {
    do {
      pair_slot<V, ANY>(a, p, lane);
      p += n_warps;
    } while (p < live && p < a.P);
  }

  if (mine.end <= mine.start) write_ray<ANY>(a, (int)g0, no_hit());
  for (long long g = g0 + n_threads; g < a.Q; g += n_threads) {
    const Seg s = segment(a, (int)g);
    if (s.end <= s.start) write_ray<ANY>(a, (int)g, no_hit());
  }
}

template <int V, bool ANY>
void launch(const Args& a, int max_blocks, cudaStream_t stream) {
  // A warp per slot, up to the caller's cap on the grid.
  long long blocks = (a.P + kBlock / 32 - 1) / (kBlock / 32);
  if (blocks > max_blocks) blocks = max_blocks;
  if (blocks < 1) blocks = 1;
  pair_major_kernel<V, ANY><<<(unsigned)blocks, kBlock, 0, stream>>>(a);
}

}  // namespace

// tiles (C, 12, L) f32, 16-byte aligned; tile_gid (C, L) i32; ro, rd (Q, 3)
// f32; t_min, t_max (Q,) f32; cid (P,) i64 (clamped into [0, C) here); cnt,
// right (Q,) i64, right not decreasing.  Closest hit (any_hit == 0): out_t,
// out_u, out_v (Q,) f32 and out_g (Q,) i32 are written, out_occ is not
// touched; any hit: out_occ (Q,) bytes 0 / 1 is written and nothing else.
// scratch is (P,) float4, written before it is read; count is (Q,) i32, all
// zero (the kernel leaves it all zero); at most max_blocks blocks of four
// warps run (a few per SM is right).  L in {32, 64, 128}.  Returns
// cudaGetLastError(), cudaErrorInvalidValue for operands it does not take.
extern "C" int pair_ray_reduce_launch(
    const void* tiles, const void* tile_gid, const void* ro, const void* rd,
    const void* t_min, const void* t_max, const void* cid, const void* cnt,
    const void* right, void* out_t, void* out_g, void* out_u, void* out_v,
    void* out_occ, void* scratch, void* count, int Q, long long P, int C,
    int L, int any_hit, int max_blocks, void* stream) {
  if ((L != 32 && L != 64 && L != 128) || C < 1 || P < 0 || max_blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (Q > 0) {
    const Args a{(const float*)tiles, (const int*)tile_gid, (const float*)ro,
                 (const float*)rd, (const float*)t_min, (const float*)t_max,
                 (const long long*)cid, (const long long*)cnt,
                 (const long long*)right, (float*)out_t, (int*)out_g,
                 (float*)out_u, (float*)out_v, (unsigned char*)out_occ,
                 (float4*)scratch, (int*)count, Q, P, C, L};
    const cudaStream_t s = (cudaStream_t)stream;
    const int V = L / 32;                        // tile lanes a thread
    if (any_hit) {
      if (V == 4) launch<4, true>(a, max_blocks, s);
      else if (V == 2) launch<2, true>(a, max_blocks, s);
      else launch<1, true>(a, max_blocks, s);
    } else {
      if (V == 4) launch<4, false>(a, max_blocks, s);
      else if (V == 2) launch<2, false>(a, max_blocks, s);
      else launch<1, false>(a, max_blocks, s);
    }
  }
  return (int)cudaGetLastError();
}
