// take_along: reps chained same-shape gathers of an (M, N) array,
//
//   dim 0: x[s, l] <- x[idx[s, l], l]      dim 1: x[s, l] <- x[s, idx[s, l]]
//
// repeated reps times with the same idx (numpy's take_along_axis, torch's
// gather).  Replaces tools/microbench_dyngather.py's run_case kernel (:50),
// the TPU probe of Mosaic's same-shape dynamic gather: one pl.pallas_call
// that keeps x in VMEM for all reps.
//
// Bound: bytes.  The function reads x and idx once and writes the result
// once; every rep in between is a permutation-like copy that need not touch
// device memory.  The gathers never leave a line (a row for dim 1, a column
// for dim 0), so the lines are independent: where a line holds at most
// kMaxLine elements, a block takes whole lines (about 1,024 elements, at
// most 4,096), keeps them in shared memory and its elements' indices in
// registers, and runs every rep there: a rep is a read phase into
// registers, a barrier, a write phase, a barrier.  Many blocks run at once
// (32 for a (256, 128) array).  A first design kept the whole array in one
// block of 1,024 threads, so one SM did all the work: 149 us for the
// (256, 128) f32 16-rep case, slower than 16 torch.gather launches.  A
// longer line takes one launch a rep over device memory (ping-pong between
// the output and one scratch array, so that the last rep lands in the
// output): every rep then moves x twice and idx once.
//
// Elements are copied as bits (2 bytes for bf16, 4 for f32 and int32), so
// the result is torch.gather's bit for bit.  An index outside [0, M) (dim
// 0) or [0, N) (dim 1), where torch.gather raises, gives a zero element; no
// load leaves x.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLineThreads = 256;        // lines form
constexpr int kPerThread = 16;           // elements a thread, lines form
constexpr int kMaxLine = kLineThreads * kPerThread;   // 4,096
constexpr int kPassThreads = 256;        // one-pass form

template <typename T>
__device__ __forceinline__ T take(const T* x, int i, int s, int l, int M,
                                  int N, int dim) {
  if (dim == 0) return (i >= 0 && i < M) ? x[i * N + l] : T(0);
  return (i >= 0 && i < N) ? x[s * N + i] : T(0);
}

// Block b takes `lines` whole lines: rows [b * lines, ...) for dim 1,
// columns for dim 0.  Its elements are laid out in shared memory as a
// (a, w) array, w its row width (N for dim 1, its number of columns for
// dim 0), element (a, c) of global x[r0 + a, c] (dim 1) or x[a, c0 + c]
// (dim 0); a gather stays inside the block.
template <typename T>
__global__ void __launch_bounds__(kLineThreads) take_along_lines_kernel(
    const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ out,
    int M, int N, int dim, int reps, int lines) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* buf = reinterpret_cast<T*>(smem_raw);
  const int first = blockIdx.x * lines;
  const int n_lines = dim == 1 ? M : N;
  const int mine = min(lines, n_lines - first);
  const int w = dim == 1 ? N : mine;
  const int n = dim == 1 ? mine * N : M * mine;
  int gl[kPerThread], src[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kLineThreads;
    if (e < n) {
      const int a = e / w, c = e - a * w;
      gl[k] = dim == 1 ? first * N + e : a * N + first + c;
      const int i = __ldg(idx + gl[k]);
      const bool ok = i >= 0 && i < (dim == 1 ? N : M);
      src[k] = ok ? (dim == 1 ? a * w + i : i * w + c) : -1;
      buf[e] = x[gl[k]];
    }
  }
  __syncthreads();
  for (int r = 0; r < reps; ++r) {
    T v[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kLineThreads;
      if (e < n) v[k] = src[k] >= 0 ? buf[src[k]] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int e = threadIdx.x + k * kLineThreads;
      if (e < n) buf[e] = v[k];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int e = threadIdx.x + k * kLineThreads;
    if (e < n) out[gl[k]] = buf[e];
  }
}

template <typename T>
__global__ void __launch_bounds__(kPassThreads) take_along_pass_kernel(
    const T* __restrict__ x, const int* __restrict__ idx, T* __restrict__ out,
    int M, int N, int dim) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= M * N) return;
  const int s = e / N;
  out[e] = take(x, __ldg(idx + e), s, e - s * N, M, N, dim);
}

template <typename T>
int launch(const void* x, const int* idx, void* out, void* scratch, int M,
           int N, int dim, int reps, int lines, cudaStream_t s) {
  const int n = M * N;
  if (lines > 0) {
    const int line = dim == 1 ? N : M;
    const int n_lines = dim == 1 ? M : N;
    const dim3 grid((n_lines + lines - 1) / lines);
    const int bytes = lines * line * (int)sizeof(T);
    take_along_lines_kernel<T><<<grid, kLineThreads, bytes, s>>>(
        (const T*)x, idx, (T*)out, M, N, dim, reps, lines);
    return (int)cudaGetLastError();
  }
  const dim3 grid((n + kPassThreads - 1) / kPassThreads);
  const T* src = (const T*)x;
  for (int r = 0; r < reps; ++r) {
    T* dst = ((reps - 1 - r) % 2 == 0) ? (T*)out : (T*)scratch;
    take_along_pass_kernel<T><<<grid, kPassThreads, 0, s>>>(src, idx, dst, M,
                                                            N, dim);
    const int err = (int)cudaGetLastError();
    if (err != 0) return err;
    src = dst;
  }
  return 0;
}

}  // namespace

// x, out: (M, N) of elem_bytes-wide elements (2 or 4), contiguous; idx:
// (M, N) int32; lines: whole lines a block in the lines form (lines x line
// length <= 4,096), or 0 for the one-pass form; scratch: (M, N) like x, for
// the one-pass form when reps > 1 (else may be null).  Returns the first
// CUDA error, else 0.
extern "C" int take_along_launch(const void* x, const void* idx, void* out,
                                 void* scratch, int M, int N, int dim,
                                 int reps, int elem_bytes, int lines,
                                 void* stream) {
  if (M <= 0 || N <= 0 || reps <= 0 || (dim != 0 && dim != 1) ||
      (elem_bytes != 2 && elem_bytes != 4) ||
      (long long)M * N > 0x7fffffffLL || lines < 0 ||
      (long long)lines * (dim == 1 ? N : M) > kMaxLine ||
      (lines == 0 && reps > 1 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (elem_bytes == 2)
    return launch<uint16_t>(x, (const int*)idx, out, scratch, M, N, dim, reps,
                            lines, s);
  return launch<uint32_t>(x, (const int*)idx, out, scratch, M, N, dim, reps,
                          lines, s);
}
