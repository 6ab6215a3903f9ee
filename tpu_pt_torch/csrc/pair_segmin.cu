// pair_segmin: per ray, the lexicographic (t, gid) minimum over the ray's
// contiguous segment [right - cnt, right) of a ray-major pair list.
//
// Replaces the Pallas kernel tpu_pt/kernels/pair_scan.py::pair_segmin_scan
// (_kernel).  That kernel writes the whole inclusive segmented scan (a
// lane-roll doubling scan with a carry across sequential 1024-pair blocks)
// and its callers read one column per ray, the segment end.  Blocks on this
// card run in no order and nothing carries between them, so the kernel
// computes those columns directly: one warp per ray folds its segment and
// reduces across lanes by shuffle.
//
// Selection only, no float arithmetic: the result is bit-identical to the
// scan's segment-end column.  The combine is the scan's: the later element
// wins iff t_b < t_a, or t_b == t_a and gid_b < gid_a.  gid is int32 (the
// scan carried it in f32, exact only below 2^24).  The combine (take_b)
// lives in pair_isect_common.cuh, shared with pair_ray_reduce.cu.
//
// Bound: bytes.  16 B per pair in, 8 B per ray in, 16 B per ray out.
//
// A ray with cnt == 0 gets (1e30, 0, 0, 0).

#include "pair_isect_common.cuh"

namespace {

using namespace pair_isect;

constexpr int kWarpsPerBlock = 4;

__global__ void pair_segmin_kernel(const float* __restrict__ t,
                                   const int* __restrict__ gid,
                                   const float* __restrict__ u,
                                   const float* __restrict__ v,
                                   const int* __restrict__ cnt,
                                   const int* __restrict__ right,
                                   float* __restrict__ out_t,
                                   int* __restrict__ out_g,
                                   float* __restrict__ out_u,
                                   float* __restrict__ out_v, int Q) {
  const int q = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (q >= Q) return;  // whole warp leaves together
  const int n = cnt[q];
  const int start = right[q] - n;

  // Neutral element: loses to every real pair, never beats one.
  Best a{kInf, 0x7fffffff, 0.0f, 0.0f};
  if (lane < n) {
    // The first element is ASSIGNED, not folded, so that the segment's head
    // survives whatever it holds (the scan keeps a NaN that heads a segment).
    int p = start + lane;
    a = Best{t[p], gid[p], u[p], v[p]};
    for (int j = lane + 32; j < n; j += 32) {
      p = start + j;
      const Best b{t[p], gid[p], u[p], v[p]};
      if (take_b(a, b)) a = b;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Best b;
    b.t = __shfl_down_sync(0xffffffffu, a.t, off);
    b.g = __shfl_down_sync(0xffffffffu, a.g, off);
    b.u = __shfl_down_sync(0xffffffffu, a.u, off);
    b.v = __shfl_down_sync(0xffffffffu, a.v, off);
    if (take_b(a, b)) a = b;
  }
  if (lane == 0) {
    const bool any = n > 0;
    out_t[q] = any ? a.t : kInf;
    out_g[q] = any ? a.g : 0;
    out_u[q] = any ? a.u : 0.0f;
    out_v[q] = any ? a.v : 0.0f;
  }
}

}  // namespace

// t, u, v (P,) f32; gid (P,) i32; cnt, right (Q,) i32 with
// 0 <= right - cnt and right <= P; outputs (Q,).  Returns cudaGetLastError().
extern "C" int pair_segmin_launch(const void* t, const void* gid,
                                  const void* u, const void* v,
                                  const void* cnt, const void* right,
                                  void* out_t, void* out_g, void* out_u,
                                  void* out_v, int Q, void* stream) {
  if (Q > 0) {
    const int blocks = (Q + kWarpsPerBlock - 1) / kWarpsPerBlock;
    pair_segmin_kernel<<<blocks, kWarpsPerBlock * 32, 0,
                         (cudaStream_t)stream>>>(
        (const float*)t, (const int*)gid, (const float*)u, (const float*)v,
        (const int*)cnt, (const int*)right, (float*)out_t, (int*)out_g,
        (float*)out_u, (float*)out_v, Q);
  }
  return (int)cudaGetLastError();
}
