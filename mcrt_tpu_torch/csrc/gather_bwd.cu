// The material gather's backward for Hopper (sm_90a), bound with ctypes: the
// rows of a cotangent grad (R, C), float32 or float64, summed by their
// material index m (R,) into an (M, C) table, in float64, in an order fixed
// by (R, M, C) alone, and rounded once to the cotangent's dtype.
//
// It replaces no Pallas kernel: the JAX package left this sum to XLA's
// scatter-add. It replaces index_put_(accumulate=True) in float64, whose
// sort-based backward gives each distinct index one warp that walks its
// run of rows one dependent step at a time: with 4 materials and 262,144
// rows, 4 warps on a 132-SM card, 86 ms a call. Its plain PyTorch twin,
// which sums in the same order, is gather_rows_backward_plain in
// mcrt_tpu_torch/materials/gather_bwd.py; the two agree bit for bit.
//
// Bound on an H100 SXM (3.35 TB/s): the bytes read, R * (C * 4 + 8) with
// float32 cotangents; 30.4 MB at R = 262,144, C = 27, so 9.1 us. The adds
// (R * C in float64) are far below the card's FP64 rate.
//
// Design. The wrapper's `layout` (gather_bwd.py) owns the order and passes
// it in: the rows are cut into chunks of `chunk` rows, one CTA a chunk, so
// the order does not depend on the card. A CTA runs `warps` warps, their
// accumulators (warps * M * C doubles) in shared memory; warp w walks its own
// chunk / warps consecutive rows in order, lane c owning column c (and
// c + 32, ...), and adds each row's value, converted to float64, into its
// (warp, material, column) slot. No two threads write one slot, so there are
// no atomics. The row loop is unrolled kUnroll rows deep, so that many rows'
// loads are in flight; each slot still takes its rows in order. The CTA then
// sums its warps' slots in warp order into its row of partial (global memory).
// Where the layout says the accumulators are not shared, a CTA is one warp
// that accumulates into its row of partial itself. A second launch, one thread a
// (material, column), sums the partials in chunk order and rounds once.
//
// mcrt_gather_bwd returns kErrArgs for arguments the card cannot run (more
// than kMaxThreads threads a CTA, shared accumulators over kSharedBytes, a
// chunk that the warps do not divide), else cudaGetLastError() after the
// launches; the wrapper raises if it is not 0. It neither synchronises nor
// allocates: the wrapper passes the partials (chunks, M, C) and the output
// (M, C).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 512;        // threads a CTA, at most
constexpr int kSharedBytes = 48 * 1024; // dynamic shared memory a CTA, at most (no opt-in)
constexpr int kUnroll = 8;              // rows a warp loads before it adds them
constexpr int kFinishThreads = 128;
constexpr int kFinishUnroll = 8;
constexpr int kErrArgs = -1;

// Adds rows [r, end) of g, by their material, into acc (M * C doubles, this
// warp's), each (material, column) slot in row order. Rows whose material
// lies outside [0, M) are not added.
template <typename T>
__device__ __forceinline__ void walk(double* acc, const long long* __restrict__ m,
                                     const T* __restrict__ g, long long r, long long end, int C,
                                     int M, long long sr, long long sc, int lane) {
  for (; r + kUnroll <= end; r += kUnroll) {
    long long mi[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) mi[u] = __ldg(m + r + u);
    for (int c = lane; c < C; c += 32) {
      T v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(g + (r + u) * sr + c * sc);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (mi[u] >= 0 && mi[u] < M) acc[mi[u] * C + c] += static_cast<double>(v[u]);
    }
  }
  for (; r < end; ++r) {
    const long long mi = __ldg(m + r);
    if (mi < 0 || mi >= M) continue;
    for (int c = lane; c < C; c += 32) acc[mi * C + c] += static_cast<double>(__ldg(g + r * sr + c * sc));
  }
}

// blockDim.x / 32 warps, their accumulators in dynamic shared memory.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
gather_bwd_rows(const long long* __restrict__ m, const T* __restrict__ g, long long R, int C,
                long long sr, long long sc, int M, int chunk, double* __restrict__ partial) {
  extern __shared__ double acc[];
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mc = M * C;
  double* mine = acc + warp * mc;
  for (int i = lane; i < mc; i += 32) mine[i] = 0.0;
  __syncwarp();
  const int rows = chunk / warps;
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk + static_cast<long long>(warp) * rows;
  walk(mine, m, g, r0, r0 + rows < R ? r0 + rows : R, C, M, sr, sc, lane);
  __syncthreads();
  for (int i = threadIdx.x; i < mc; i += blockDim.x) {
    double s = 0.0;
    for (int w = 0; w < warps; ++w) s += acc[w * mc + i];
    partial[static_cast<long long>(blockIdx.x) * mc + i] = s;
  }
}

// One warp a CTA, accumulating into its own partial row in global memory.
template <typename T>
__global__ void __launch_bounds__(32)
gather_bwd_rows_global(const long long* __restrict__ m, const T* __restrict__ g, long long R, int C,
                       long long sr, long long sc, int M, int chunk, double* __restrict__ partial) {
  const int mc = M * C;
  double* mine = partial + static_cast<long long>(blockIdx.x) * mc;
  for (int i = threadIdx.x; i < mc; i += 32) mine[i] = 0.0;
  __syncwarp();
  const long long r0 = static_cast<long long>(blockIdx.x) * chunk;
  walk(mine, m, g, r0, r0 + chunk < R ? r0 + chunk : R, C, M, sr, sc, threadIdx.x);
}

// out[i] = the partials' slot i summed in chunk order, rounded once to Out.
template <typename Out>
__global__ void __launch_bounds__(kFinishThreads)
gather_bwd_finish(const double* __restrict__ partial, int chunks, int mc, Out* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= mc) return;
  double s = 0.0;
  int b = 0;
  for (; b + kFinishUnroll <= chunks; b += kFinishUnroll) {
    double v[kFinishUnroll];
#pragma unroll
    for (int u = 0; u < kFinishUnroll; ++u) v[u] = partial[static_cast<long long>(b + u) * mc + i];
#pragma unroll
    for (int u = 0; u < kFinishUnroll; ++u) s += v[u];
  }
  for (; b < chunks; ++b) s += partial[static_cast<long long>(b) * mc + i];
  out[i] = static_cast<Out>(s);
}

template <typename T>
int launch(const long long* m, const T* g, long long R, int C, long long sr, long long sc, int M,
           int chunk, int warps, int shared, double* partial, T* out, cudaStream_t stream) {
  const long long chunks = (R + chunk - 1) / chunk;
  const int mc = M * C;
  if (chunks > 0) {
    if (shared) {
      gather_bwd_rows<T><<<static_cast<unsigned>(chunks), warps * 32,
                           static_cast<size_t>(warps) * mc * sizeof(double), stream>>>(
          m, g, R, C, sr, sc, M, chunk, partial);
    } else {
      gather_bwd_rows_global<T><<<static_cast<unsigned>(chunks), 32, 0, stream>>>(
          m, g, R, C, sr, sc, M, chunk, partial);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  gather_bwd_finish<T><<<(mc + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0, stream>>>(
      partial, static_cast<int>(chunks), mc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, C) = the rows of g (R, C; row and column strides sr, sc, in
// elements; float64 when g_double, else float32) summed by m (R,) int64,
// rounded to g's dtype, in the layout given: chunks of `chunk` rows, each
// `warps` warps with their accumulators in shared memory, or (shared 0) one
// warp accumulating in partial. partial holds ceil(R / chunk) * M * C doubles.
extern "C" int mcrt_gather_bwd(const void* m, const void* g, int g_double, long long R, int C,
                               long long sr, long long sc, int M, int chunk, int warps, int shared,
                               void* partial, void* out, void* stream) {
  if (R < 0 || C < 1 || M < 1 || static_cast<long long>(M) * C > (1 << 30)) return kErrArgs;
  if (warps < 1 || warps * 32 > kMaxThreads || chunk < 1 || chunk % warps != 0) return kErrArgs;
  if (!shared && warps != 1) return kErrArgs;
  if (shared && static_cast<long long>(warps) * M * C * sizeof(double) > kSharedBytes) return kErrArgs;
  if ((R + chunk - 1) / chunk > 0x7fffffffLL) return kErrArgs;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto mi = static_cast<const long long*>(m);
  auto* p = static_cast<double*>(partial);
  if (g_double)
    return launch(mi, static_cast<const double*>(g), R, C, sr, sc, M, chunk, warps, shared, p,
                  static_cast<double*>(out), s);
  return launch(mi, static_cast<const float*>(g), R, C, sr, sc, M, chunk, warps, shared, p,
                static_cast<float*>(out), s);
}
