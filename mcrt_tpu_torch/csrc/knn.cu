// One-ring photon k-NN kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel `_kernel` of mcrt_tpu/accel/knn_kernel.py
// (the exact one-ring k-NN of the photon mapper's radiance estimates). What it
// computes, and its plain PyTorch twin, are described in
// mcrt_tpu_torch/accel/knn_kernel.py.
//
// Design. One CUDA block of 128 threads per block of 128 cell-sorted queries,
// one thread per query.
//   1. Columns: block reductions (warp __reduce_min/max_sync, then one
//      barrier) walk the (x, y) columns of the valid queries' one-rings in
//      ascending order: each x within one cell of a query, the y range of the
//      queries near that x, and for each column the z range of the queries
//      whose one-ring touches it. A block with no valid query reads nothing.
//   2. Ranges: a touched column's cells from that z range are one contiguous
//      photon range [s, e) of the CSR table (z is its fastest axis). The range is
//      streamed through shared memory in tiles of kTile photons, loaded with
//      coalesced 4-byte reads of the (N, 3) float32 position table. The TPU
//      staged up to 16384 rows in VMEM at once (256 KB, more than the 227 KB
//      a block can have) and flagged blocks that overflowed; streaming reads
//      exactly [s, e) once, so no block is flagged for its size and no row is
//      read twice.
//   3. Selection: each thread keeps its query's k nearest (k <= 56) as a list
//      sorted by d2, in shared memory laid out [slot][thread] so that a warp's
//      accesses to one slot hit 32 different banks (128 x 56 x 8 bytes = 57 KB
//      at k = 56). A photon is inserted only if d2 <= cell^2 and d2 < the
//      current k-th; an equal d2 goes after the entries already there, and
//      photons arrive in ascending row order, so ties keep the lower row. The
//      list is then exactly the k nearest, where the TPU bisected the k-th
//      radius in 26 passes and emitted candidates in staging order.
//   4. Arithmetic: d2 = (dx*dx + dy*dy) + dz*dz with every product and sum
//      rounded on its own (__fmul_rn / __fadd_rn: no contraction into FMAs),
//      as the plain version computes it, so the two agree bit for bit.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): a block reads its
// photons once (12 bytes each) and every one of its 128 threads spends about
// 8 FP32 operations on each, about 85 operations per byte read, against the
// card's 20: the kernel is bound by arithmetic, and the shared-memory tile
// lets one global read serve 128 queries. Each thread's insertions are
// data-dependent and diverge within a warp; that is left for a later change.
//
// The C entry point returns -1 for a k outside 1..56, else cudaGetLastError()
// after the launch; the wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr int kBlock = 128;   // queries per block, one thread each
constexpr int kWarps = kBlock / 32;
constexpr int kTile = 1024;   // photons per shared-memory tile
constexpr int kMaxK = 56;     // the most neighbours a query can ask for
constexpr int kErrArgs = -1;  // mcrt_knn: k outside 1..kMaxK

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Block-wide (min lo, max hi) over the block's warps, with one barrier. `buf`
// holds two sets of per-warp slots; `parity` alternates between calls, so a
// call's writes never race the previous call's reads (a thread that writes
// in call n + 2 has passed call n + 1's barrier, after every read of call n).
__device__ __forceinline__ int2 block_min_max(int lo, int hi, int* buf, int& parity) {
  lo = __reduce_min_sync(0xffffffffu, lo);
  hi = __reduce_max_sync(0xffffffffu, hi);
  int* b = buf + parity * 2 * kWarps;
  const int w = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) { b[2 * w] = lo; b[2 * w + 1] = hi; }
  __syncthreads();
  int2 r = make_int2(INT_MAX, -1);
  for (int i = 0; i < kWarps; ++i) { r.x = min(r.x, b[2 * i]); r.y = max(r.y, b[2 * i + 1]); }
  parity ^= 1;
  return r;
}

__global__ void __launch_bounds__(kBlock) knn_kernel(
    const float4* __restrict__ qpos,     // (B * kBlock) x, y, z, valid (1 or 0)
    const int4* __restrict__ qcell,      // (B * kBlock) cx, cy, cz, query index (-1: padding)
    const float* __restrict__ pos,       // (N, 3) photon positions, sorted by cell
    const int* __restrict__ cell_start,  // (nx * ny * nz + 1) CSR starts
    int* __restrict__ out_idx,           // (Q, k)
    float* __restrict__ out_d2,          // (Q, k)
    int* __restrict__ out_cnt,           // (Q,)
    int* __restrict__ stats,             // (B, 2): columns read, photons read
    int k, int nx, int ny, int nz, float cell2) {
  extern __shared__ float smem[];
  float* s_px = smem;
  float* s_py = s_px + kTile;
  float* s_pz = s_py + kTile;
  float* s_ld2 = s_pz + kTile;                              // k x kBlock
  int* s_lid = reinterpret_cast<int*>(s_ld2 + k * kBlock);  // k x kBlock
  __shared__ int s_red[2 * 2 * kWarps];                     // block_min_max slots

  const int t = threadIdx.x;
  const int b = blockIdx.x;
  const float4 qp = qpos[static_cast<size_t>(b) * kBlock + t];
  const int4 qc = qcell[static_cast<size_t>(b) * kBlock + t];
  const bool valid = qp.w > 0.5f;
  int parity = 0;

  int cnt = 0, walked = 0, read = 0;
  float kth = inf_f();
  // Columns in ascending (x, y) order: each x of the valid queries' one-ring,
  // then the y range of the queries within one cell of that x, then the z
  // range of the queries whose one-ring touches the column. Every value of a
  // reduction is the same in all threads, so every branch below is uniform.
  const int2 xr = block_min_max(valid ? qc.x : INT_MAX, valid ? qc.x : -1, s_red, parity);
  for (int gx = max(xr.x - 1, 0); xr.y >= 0 && gx <= min(xr.y + 1, nx - 1); ++gx) {
    const bool near_x = valid && abs(qc.x - gx) <= 1;
    const int2 yr = block_min_max(near_x ? qc.y : INT_MAX, near_x ? qc.y : -1, s_red, parity);
    for (int gy = max(yr.x - 1, 0); yr.y >= 0 && gy <= min(yr.y + 1, ny - 1); ++gy) {
      const bool touch = near_x && abs(qc.y - gy) <= 1;
      const int2 zr = block_min_max(touch ? qc.z : INT_MAX, touch ? qc.z : -1, s_red, parity);
      if (zr.y < 0) continue;  // no query touches this column
      const int base = (gx * ny + gy) * nz;
      const int s = cell_start[base + max(zr.x - 1, 0)];
      const int e = cell_start[base + min(zr.y + 1, nz - 1) + 1];
      ++walked;
      read += e - s;
      for (int r0 = s; r0 < e; r0 += kTile) {
        const int n = min(kTile, e - r0);
        __syncthreads();  // the previous tile is consumed
        const float* src = pos + static_cast<size_t>(r0) * 3;
        for (int i = t; i < n * 3; i += kBlock) {
          const int r = i / 3, c = i - 3 * r;
          (c == 0 ? s_px : c == 1 ? s_py : s_pz)[r] = src[i];
        }
        __syncthreads();
        if (!valid) continue;
        for (int j = 0; j < n; ++j) {
          const float dx = __fsub_rn(qp.x, s_px[j]);
          const float dy = __fsub_rn(qp.y, s_py[j]);
          const float dz = __fsub_rn(qp.z, s_pz[j]);
          const float d2 =
              __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
          if (!(d2 <= cell2 && d2 < kth)) continue;
          int slot = cnt < k ? cnt : k - 1;
          while (slot > 0 && s_ld2[(slot - 1) * kBlock + t] > d2) {
            s_ld2[slot * kBlock + t] = s_ld2[(slot - 1) * kBlock + t];
            s_lid[slot * kBlock + t] = s_lid[(slot - 1) * kBlock + t];
            --slot;
          }
          s_ld2[slot * kBlock + t] = d2;
          s_lid[slot * kBlock + t] = r0 + j;
          if (cnt < k) ++cnt;
          if (cnt == k) kth = s_ld2[(k - 1) * kBlock + t];
        }
      }
    }
  }

  if (qc.w >= 0) {
    const size_t o = static_cast<size_t>(qc.w) * k;
    for (int j = 0; j < k; ++j) {
      const bool found = j < cnt;
      out_idx[o + j] = found ? s_lid[j * kBlock + t] : 0;
      out_d2[o + j] = found ? s_ld2[j * kBlock + t] : inf_f();
    }
    out_cnt[qc.w] = cnt;
  }
  if (t == 0) {
    stats[b * 2 + 0] = walked;
    stats[b * 2 + 1] = read;
  }
}

}  // namespace

extern "C" int mcrt_knn(const void* qpos, const void* qcell, const void* pos,
                        const void* cell_start, void* out_idx, void* out_d2, void* out_cnt,
                        void* stats, int B, int k, int nx, int ny, int nz, float cell2,
                        void* stream) {
  if (k < 1 || k > kMaxK) return kErrArgs;
  // Dynamic shared memory: one photon tile (3 x kTile floats) and the
  // per-thread lists (k x kBlock distances and as many ids).
  const size_t smem = sizeof(float) * (3 * static_cast<size_t>(kTile) +
                                       2 * static_cast<size_t>(k) * kBlock);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(knn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  knn_kernel<<<B, kBlock, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(qpos), static_cast<const int4*>(qcell),
      static_cast<const float*>(pos), static_cast<const int*>(cell_start),
      static_cast<int*>(out_idx), static_cast<float*>(out_d2), static_cast<int*>(out_cnt),
      static_cast<int*>(stats), k, nx, ny, nz, cell2);
  return static_cast<int>(cudaGetLastError());
}
