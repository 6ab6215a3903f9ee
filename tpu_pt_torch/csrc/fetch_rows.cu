// fetch_rows / fetch_rows_t / fetch_fields: fetch rows of a bf16 table by
// index, as f32.
//
//   fetch_rows:   out[p, f] = float(table[row(idx[p]), f])   out (P, W)
//   fetch_rows_t: out[f, p] = float(table[row(idx[p]), f])   out (W, P)
//   fetch_fields: out[f, p, c] = float(table[clamp(idx[p]), 8 f + c])
//                 out (F, P, 8), W = 64, f < F <= 8
//
// Replaces the TPU probes of the fused descent's child-row fetch, which are
// all this one gather: tools/microbench_vmem_gather.py::vmem_gather (:74,
// row-indexed loads from a VMEM-resident (N, 64) table),
// tools/microbench_fetch_kernel.py::onehot_fetch (:65, the same gather as a
// one-hot bf16 matmul) and ::grouped_fetch (:130, the one-hot form on
// 512-wide rows of 8 siblings), and, field-major, ::lane_gather_fetch (:98).
// fetch_rows is also the child fetch of the port's cluster descent
// (bvh/cluster.py::_descend_compact), which the plain version, table[idx]
// then .float(), ran as three launches (clamp, gather, cast).
//
// Bound: bytes.  The work is a copy that widens 2 bytes to 4: each fetched
// row is read (2W bytes, from L2: the descent's tables are 30 KB and 238 KB)
// and written (4W bytes, to device memory), beside its index.  So the design
// moves whole 16-byte words: a row of 64 bf16 is eight 16-byte loads,
// one thread each, and each thread stores its 8 floats as two float4; a
// warp moves four rows an instruction, with coalesced loads and stores.  The
// one-hot forms do W x N multiply-adds per row to move the same bytes, and
// give NaN where a table holds an infinity (0 x inf): the descent's tables
// hold +inf / -inf in empty child slots, so the gather is the only form
// that is exact there.  Nothing is staged in shared memory: the L2 table
// does not fit in a block's 227 KB, and the L1 table sits in L2 as well.
//
// A bf16 widens to f32 by a 16-bit shift, which is what torch's .float()
// does, so the result is the plain version's bit for bit, NaN and +/-inf
// included.  The row of an index: under clamp, the index clamped into
// [0, N); otherwise a negative index counts from the end (torch indexing)
// and an index still outside [0, N) gives a row of NaN, where torch raises;
// no load ever leaves the table.  The index may be int32 or int64 and is
// read as a (rows, K) array whose rows lie idx_stride elements apart, so
// the descent's column slice of its compaction buffer is read where it is.
//
// fetch_fields is the descent's fetch since the row form's redesign: the
// layout the descent consumes.  A row of the descent's sibling table
// (bvh/cluster.py: child16, 64 bf16) is eight 16-byte words, word f holding
// field f (min.x, ..., max.z, then two words of padding) of the 8 children;
// the descent's slab test reads each field of all (ray, child) lanes as one
// (Q, K * 8) plane.  fetch_rows wrote (Q, K, 64) rows and the descent then
// copied each of the six field slices out (a stride-64 view), six copy
// kernels a level, and wrote the two padding words nobody reads.  Here one
// thread takes one candidate row: it loads its index once (neighbouring
// threads, neighbouring indices) and issues its F 16-byte word loads
// together before any store (F loads in flight, one dependent chain: index,
// then row).  Row p's word f goes to plane f at p * 8 floats, so a warp's
// 32 rows fill 1 KB of each plane.  Written by the thread that loaded it,
// that is two 16-byte stores a lane 32 bytes apart: every store instruction
// touches each of its 32 sectors by half.  So the lanes trade halves with
// shuffles instead, and each store instruction writes 512 contiguous bytes
// (lane l: half l & 1 of row l / 2, then of row 16 + l / 2), full
// sectors only (PERF.md has both designs' times on the headline's descent).
// Nothing else is written.  Bound: bytes (the index,
// F * 16 bytes of each named row, F * 32 bytes out a row).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileP = 64;   // fetch_rows_t: indices a block
constexpr int kTileF = 64;   // fetch_rows_t: fields a block
constexpr int kFieldThreads = 128;   // fetch_fields: rows a block
constexpr unsigned kFull = 0xffffffffu;

template <typename I>
__device__ __forceinline__ long long row_of(I i, int n, int clamp) {
  long long r = (long long)i;
  if (clamp) return r < 0 ? 0 : (r >= n ? n - 1 : r);
  if (r < 0) r += n;
  return (r < 0 || r >= n) ? -1 : r;
}

__device__ __forceinline__ float lo16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// One thread per 16-byte word of a fetched row (cpr = W / 8 words a row).
template <typename I>
__global__ void __launch_bounds__(kThreads) fetch_rows_kernel(
    const uint4* __restrict__ table, const I* __restrict__ idx,
    float4* __restrict__ out, int total, int cpr, int K, long long idx_stride,
    int n, int clamp) {
  const int g = blockIdx.x * kThreads + threadIdx.x;
  if (g >= total) return;
  const int p = g / cpr;
  const int c = g - p * cpr;
  const int q = p / K;
  const long long r =
      row_of(__ldg(idx + (long long)q * idx_stride + (p - q * K)), n, clamp);
  float4 a, b;
  if (r >= 0) {
    const uint4 w = __ldg(table + r * cpr + c);
    a = make_float4(lo16(w.x), hi16(w.x), lo16(w.y), hi16(w.y));
    b = make_float4(lo16(w.z), hi16(w.z), lo16(w.w), hi16(w.w));
  } else {
    const float nan = __uint_as_float(0x7fc00000u);
    a = b = make_float4(nan, nan, nan, nan);
  }
  out[2 * (long long)g] = a;
  out[2 * (long long)g + 1] = b;
}

// A block takes kTileP indices x kTileF fields: it reads the 64 rows'
// 128-byte segments as 16-byte words into shared memory, then writes each
// field's 64 values as one coalesced 256-byte run of the (W, P) output.
template <typename I>
__global__ void __launch_bounds__(kThreads) fetch_rows_t_kernel(
    const uint4* __restrict__ table, const I* __restrict__ idx,
    float* __restrict__ out, int P, int cpr, int n) {
  __shared__ float tile[kTileP][kTileF + 1];
  const int p0 = blockIdx.x * kTileP;
  const int f0 = blockIdx.y * kTileF;
  for (int k = threadIdx.x; k < kTileP * (kTileF / 8); k += kThreads) {
    const int j = k / (kTileF / 8);
    const int c = k - j * (kTileF / 8);
    float v[8];
    long long r = -1;
    if (p0 + j < P) r = row_of(__ldg(idx + p0 + j), n, 0);
    if (r >= 0) {
      const uint4 w = __ldg(table + r * cpr + f0 / 8 + c);
      v[0] = lo16(w.x); v[1] = hi16(w.x); v[2] = lo16(w.y); v[3] = hi16(w.y);
      v[4] = lo16(w.z); v[5] = hi16(w.z); v[6] = lo16(w.w); v[7] = hi16(w.w);
    } else {
      for (int e = 0; e < 8; ++e) v[e] = __uint_as_float(0x7fc00000u);
    }
    for (int e = 0; e < 8; ++e) tile[j][c * 8 + e] = v[e];
  }
  __syncthreads();
  const int j = threadIdx.x % kTileP;
  if (p0 + j >= P) return;
  for (int f = threadIdx.x / kTileP; f < kTileF; f += kThreads / kTileP)
    out[(long long)(f0 + f) * P + p0 + j] = tile[j][f];
}

// One thread per candidate row, its F field words loaded first; then, per
// plane, two stores a warp of 512 contiguous bytes each: lane l stores half
// (l & 1) of row (s * 16 + l / 2) of its warp's 32, taken from that row's
// lane with shuffles.
template <typename I>
__global__ void __launch_bounds__(kFieldThreads) fetch_fields_kernel(
    const uint4* __restrict__ table, const I* __restrict__ idx,
    float4* __restrict__ out, int P, int K, long long idx_stride, int n,
    int fields) {
  const int p = blockIdx.x * kFieldThreads + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int p_warp = p - lane;              // the warp's first row
  if (p_warp >= P) return;                  // the whole warp
  long long r = 0;
  if (p < P) {
    const int q = p / K;
    r = row_of(__ldg(idx + (long long)q * idx_stride + (p - q * K)), n, 1);
  }
  uint4 w[8];
#pragma unroll
  for (int f = 0; f < 8; ++f)
    if (f < fields)
      w[f] = p < P ? __ldg(table + r * 8 + f) : make_uint4(0, 0, 0, 0);
  const int half = lane & 1;
#pragma unroll
  for (int f = 0; f < 8; ++f) {
    if (f >= fields) break;
    float4* o = out + ((long long)f * P + p_warp) * 2;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int src = s * 16 + (lane >> 1);
      const uint32_t x = __shfl_sync(kFull, w[f].x, src);
      const uint32_t y = __shfl_sync(kFull, w[f].y, src);
      const uint32_t z = __shfl_sync(kFull, w[f].z, src);
      const uint32_t v = __shfl_sync(kFull, w[f].w, src);
      const uint32_t a = half ? z : x, b = half ? v : y;
      if (p_warp + src < P)
        o[s * 32 + lane] = make_float4(lo16(a), hi16(a), lo16(b), hi16(b));
    }
  }
}

}  // namespace

// table: (N, W) bf16 bits, 16-byte aligned, W a multiple of 64; idx: rows
// of K indices idx_stride elements apart, P = rows x K in all; idx64: the
// indices are int64 (else int32); out: (P, W) f32.  Returns
// cudaGetLastError().
extern "C" int fetch_rows_launch(const void* table, const void* idx,
                                 void* out, int P, int K, long long idx_stride,
                                 int N, int W, int idx64, int clamp,
                                 void* stream) {
  if (P <= 0 || K <= 0 || N <= 0 || W <= 0 || W % 64 != 0 ||
      (long long)P * (W / 8) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int cpr = W / 8;
  const int total = P * cpr;
  const dim3 grid((total + kThreads - 1) / kThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    fetch_rows_kernel<long long><<<grid, kThreads, 0, s>>>(
        (const uint4*)table, (const long long*)idx, (float4*)out, total, cpr,
        K, idx_stride, N, clamp);
  else
    fetch_rows_kernel<int><<<grid, kThreads, 0, s>>>(
        (const uint4*)table, (const int*)idx, (float4*)out, total, cpr, K,
        idx_stride, N, clamp);
  return (int)cudaGetLastError();
}

// table as above; idx: (P,) contiguous; out: (W, P) f32.  Returns
// cudaGetLastError().
extern "C" int fetch_rows_t_launch(const void* table, const void* idx,
                                   void* out, int P, int N, int W, int idx64,
                                   void* stream) {
  if (P <= 0 || N <= 0 || W <= 0 || W % 64 != 0)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kTileP - 1) / kTileP, W / kTileF);
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    fetch_rows_t_kernel<long long><<<grid, kThreads, 0, s>>>(
        (const uint4*)table, (const long long*)idx, (float*)out, P, W / 8, N);
  else
    fetch_rows_t_kernel<int><<<grid, kThreads, 0, s>>>(
        (const uint4*)table, (const int*)idx, (float*)out, P, W / 8, N);
  return (int)cudaGetLastError();
}

// table: (N, 64) bf16 bits, 16-byte aligned; idx: rows of K indices
// idx_stride elements apart, P = rows x K in all, clamped into [0, N);
// idx64: int64 indices (else int32); out: (fields, P, 8) f32, 16-byte
// aligned, 1 <= fields <= 8.  Returns cudaGetLastError().
extern "C" int fetch_fields_launch(const void* table, const void* idx,
                                   void* out, int P, int K,
                                   long long idx_stride, int N, int fields,
                                   int idx64, void* stream) {
  if (P <= 0 || K <= 0 || N <= 0 || fields < 1 || fields > 8 ||
      (long long)P * fields * 2 > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((P + kFieldThreads - 1) / kFieldThreads);
  cudaStream_t s = (cudaStream_t)stream;
  if (idx64)
    fetch_fields_kernel<long long><<<grid, kFieldThreads, 0, s>>>(
        (const uint4*)table, (const long long*)idx, (float4*)out, P, K,
        idx_stride, N, fields);
  else
    fetch_fields_kernel<int><<<grid, kFieldThreads, 0, s>>>(
        (const uint4*)table, (const int*)idx, (float4*)out, P, K, idx_stride,
        N, fields);
  return (int)cudaGetLastError();
}
