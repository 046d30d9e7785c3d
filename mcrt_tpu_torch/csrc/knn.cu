// Exact photon k-NN kernels for Hopper (sm_90a), bound with ctypes.
//
// Replace the Pallas TPU kernel `_kernel` of mcrt_tpu/accel/knn_kernel.py (the
// one-ring k-NN of the photon mapper's radiance estimates) and the brute-force
// fallback that answers the queries it flags: for float32 queries and k <= 56
// these kernels alone answer every valid query with the k nearest photons of
// the whole map. What they compute, and their plain PyTorch twin, are
// described in mcrt_tpu_torch/accel/knn_kernel.py.
//
// Design. One warp per query throughout, queries sorted by cell.
//   knn_ring1  (stage A) one warp per sorted query, 8 per block: reads the
//              photons of the 27 cells around the query's clamped cell, and
//              only those: each (x, y) column is one contiguous CSR range
//              (z is the fastest axis), one range per lane, and the warp
//              walks the ranges' rows 32 at a time (a prefix sum over the
//              lanes and a 5-step shuffle search find each lane's row).
//              A query it cannot certify goes to a device queue (atomic
//              counter), with the count of photons it has seen.
//   knn_rings  (stage B) a persistent grid, sized from the SM count and the
//              occupancy API, whose warps take queued queries and widen
//              their rings half as wide again each step, or sooner to the
//              first ring whose bound covers the k-th known (that ring
//              certifies, since the k-th only falls), never past a box of
//              `budget` cells. Each step reads
//              only the new cells, outer columns whole and inner columns the
//              z runs above and below the previous box, so no column is
//              looked up once per ring; the stage, the first ring that
//              certifies, follows from the final k-th. A query past the
//              budget goes to a second queue.
//   knn_scan   (stage B) a persistent grid over the second queue, 8 queries
//              a block: the block streams all N photons through two shared
//              tiles of 1024 (cp.async, 16-byte copies, double-buffered),
//              each warp testing its query against every photon of a tile.
//              A query starts from its ring's k-th key as a bound (the k
//              nearest of the map lie within it), and the tiles are visited
//              outward from the first query's cell, so that the k-th
//              tightens early and nearly every photon fails one compare.
// Both stage-B kernels read their queue's length on the device: the host
// neither reads a count nor sizes a launch from the data.
//
// Selection. A photon's key is (d2 bits) << 32 | row: keys order by (d2, row),
// ties to the lower row, whatever the visit order. A warp keeps its query's
// k <= 56 smallest keys sorted across its lanes, two slots a lane (slot lane
// and slot 32 + lane). Photons whose key is below the current k-th are found
// by ballot and inserted one at a time with three 64-bit shuffles.
// d2 = (dx*dx + dy*dy) + dz*dz with every product and sum rounded on its own
// (__fmul_rn / __fadd_rn: no contraction into FMAs), as the plain version
// computes it, so the two agree bit for bit.
//
// Certification (r2_bound): after ring r the answer is final when its k-th d2
// is at most R2c, a float32 lower bound on the d2 of every photon outside the
// ring's box (inf when the box covers the grid). The plain version computes
// R2c with the same operations in the same order.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): about 8 FP32 operations
// per (query, photon) and 12 bytes per distinct photon row. On the photon
// maps of a 5 M-path render (about 1e5 photons, 1.2 MB, held in L2) the least
// work is bound by those bytes, and the kernels by latency: a sparse query
// walks many cells, each lookup a dependent load. The scan shares each tile
// among the 8 warps of a block.
//
// The C entry points return -1 for a k outside 1..56, else cudaGetLastError()
// after the launch; the wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxK = 56;      // the most neighbours a query can ask for
constexpr int kWarps = 8;      // queries (warps) per block
constexpr int kThreads = 32 * kWarps;
constexpr int kColsPerLane = 2;  // columns a lane looks up per round of a shell
constexpr int kTile = 1024;    // photons per shared tile of the scan
constexpr int kUnroll = 4;     // photons a lane tests per step of the scan
constexpr int kStageScan = -1;
constexpr int kErrArgs = -1;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kInf = 0x7fffffffffffffffULL;  // an empty slot's key

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

struct Grid {
  const float* pos;  // (N, 3) photon positions, sorted by cell
  const int* cs;     // (nx * ny * nz + 1) CSR starts
  int n[3];          // nx, ny, nz
  int count;         // N
  float bb[3];       // the grid's low corner
  float cell;
  float hi[3];       // bb + n * cell
  float delta;       // coordinate slack of the certification
  long long budget;  // cells a stage-B ring box may hold
};

struct Out {
  int* idx;        // (Q, k)
  float* d2;       // (Q, k)
  int* cnt;        // (Q,)
  int* stage;      // (Q,)
  int* evaluated;  // (Q,) photons each query's kernels evaluated, or null
};

// A query's k smallest keys, sorted over the warp: slot lane in a, 32 + lane in b.
struct List {
  unsigned long long a, b;
};

__device__ __forceinline__ unsigned long long kth_key(const List& l, int k) {
  const int s = k - 1;
  return __shfl_sync(kFull, s < 32 ? l.a : l.b, s & 31);
}

// Insert key x (not in the list) at its place; the largest slot falls off.
__device__ __forceinline__ void insert(List& l, unsigned long long x, int lane) {
  const unsigned long long up_a = __shfl_up_sync(kFull, l.a, 1);
  const unsigned long long up_b = __shfl_up_sync(kFull, l.b, 1);
  const unsigned long long a31 = __shfl_sync(kFull, l.a, 31);
  const bool first = lane == 0;
  const unsigned long long pb = first ? a31 : up_b;
  const unsigned long long na = l.a < x ? l.a : ((first || up_a < x) ? x : up_a);
  const unsigned long long nb = l.b < x ? l.b : (pb < x ? x : pb);
  l.a = na;
  l.b = nb;
}

// Offer one candidate key per lane (kInf for none). `kth` is the bound a key
// must stay under: min(the list's k-th, thr).
__device__ __forceinline__ void offer(List& l, unsigned long long c, unsigned long long& kth,
                                      unsigned long long thr, int k, int lane) {
  unsigned m = __ballot_sync(kFull, c < kth);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const unsigned long long x = __shfl_sync(kFull, c, src);
    if (x < kth) {
      insert(l, x, lane);
      const unsigned long long t = kth_key(l, k);
      kth = t < thr ? t : thr;
    }
  }
}

__device__ __forceinline__ unsigned long long make_key(float d2, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(d2)) << 32) | static_cast<unsigned>(row);
}

__device__ __forceinline__ float dist2(float qx, float qy, float qz, float px, float py, float pz) {
  const float dx = __fsub_rn(qx, px), dy = __fsub_rn(qy, py), dz = __fsub_rn(qz, pz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// Offer every row of the lanes' ranges [s, e) (one per lane, possibly empty)
// 32 at a time; returns their total. Warp-uniform.
__device__ __forceinline__ int offer_ranges(const Grid& g, float qx, float qy, float qz, int s,
                                           int e, List& l, unsigned long long& kth, int k,
                                           int lane) {
  const int len = e - s;
  if (!__any_sync(kFull, len > 0)) return 0;
  int incl = len;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += v;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int excl = incl - len;
  for (int base = 0; base < total; base += 32) {
    const int gi = base + lane;
    int i = 0;  // the lane whose range holds row number gi: #lanes with incl <= gi
#pragma unroll
    for (int b = 16; b >= 1; b >>= 1) {
      if (__shfl_sync(kFull, incl, i + b - 1) <= gi) i += b;
    }
    const int rs = __shfl_sync(kFull, s, i);
    const int rx = __shfl_sync(kFull, excl, i);
    unsigned long long c = kInf;
    if (gi < total) {
      const int row = rs + (gi - rx);
      const float* p = g.pos + 3 * static_cast<size_t>(row);
      c = make_key(dist2(qx, qy, qz, __ldg(p), __ldg(p + 1), __ldg(p + 2)), row);
    }
    offer(l, c, kth, kInf, k, lane);
  }
  return total;
}

// The cells of box [lo, hi] outside box [plo, phi] (empty when plo > phi):
// per (x, y) column the whole z run, or the runs below and above the previous
// box. Adds the photons read to `seen`.
__device__ void read_shell(const Grid& g, float qx, float qy, float qz, int3 lo, int3 hi,
                           int3 plo, int3 phi, List& l, unsigned long long& kth, int k, int lane,
                           int& seen) {
  const int nys = hi.y - lo.y + 1;
  const int ncol = (hi.x - lo.x + 1) * nys;
  for (int c0 = 0; c0 < ncol; c0 += 32 * kColsPerLane) {
    int s[2 * kColsPerLane], e[2 * kColsPerLane];
#pragma unroll
    for (int j = 0; j < kColsPerLane; ++j) {
      const int col = c0 + 32 * j + lane;
      s[2 * j] = e[2 * j] = s[2 * j + 1] = e[2 * j + 1] = 0;
      if (col < ncol) {
        const int gx = lo.x + col / nys, gy = lo.y + col % nys;
        const bool inner = gx >= plo.x && gx <= phi.x && gy >= plo.y && gy <= phi.y;
        const int base = (gx * g.n[1] + gy) * g.n[2];
        const int ahi = inner ? plo.z - 1 : hi.z;
        const int blo = inner ? phi.z + 1 : hi.z + 1;
        if (lo.z <= ahi) {
          s[2 * j] = __ldg(g.cs + base + lo.z);
          e[2 * j] = __ldg(g.cs + base + ahi + 1);
        }
        if (blo <= hi.z) {
          s[2 * j + 1] = __ldg(g.cs + base + blo);
          e[2 * j + 1] = __ldg(g.cs + base + hi.z + 1);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 2 * kColsPerLane; ++j)
      seen += offer_ranges(g, qx, qy, qz, s[j], e[j], l, kth, k, lane);
  }
}

__device__ __forceinline__ int3 box_lo(int4 c, int r) {
  return make_int3(max(c.x - r, 0), max(c.y - r, 0), max(c.z - r, 0));
}
__device__ __forceinline__ int3 box_hi(const Grid& g, int4 c, int r) {
  return make_int3(min(c.x + r, g.n[0] - 1), min(c.y + r, g.n[1] - 1), min(c.z + r, g.n[2] - 1));
}

// R2c: below the d2 of every photon outside box [lo, hi] (see knn_kernel.py's
// _r2_bound, which does the same float32 operations in the same order).
__device__ float r2_bound(const Grid& g, float qx, float qy, float qz, int3 lo, int3 hi) {
  const float q[3] = {qx, qy, qz};
  const int l3[3] = {lo.x, lo.y, lo.z}, h3[3] = {hi.x, hi.y, hi.z};
  float o2[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float out = fmaxf(fmaxf(__fsub_rn(g.bb[a], q[a]), __fsub_rn(q[a], g.hi[a])), 0.0f);
    const float o = fmaxf(__fsub_rn(out, g.delta), 0.0f);
    o2[a] = __fmul_rn(o, o);
  }
  float r2 = inf_f();
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float rest = a == 0 ? __fadd_rn(o2[1], o2[2])
                              : (a == 1 ? __fadd_rn(o2[0], o2[2]) : __fadd_rn(o2[0], o2[1]));
    if (l3[a] > 0) {
      const float face = __fadd_rn(g.bb[a], __fmul_rn(static_cast<float>(l3[a]), g.cell));
      const float gap = fmaxf(__fsub_rn(__fsub_rn(q[a], face), g.delta), 0.0f);
      r2 = fminf(r2, __fadd_rn(__fmul_rn(gap, gap), rest));
    }
    if (h3[a] < g.n[a] - 1) {
      const float face = __fadd_rn(g.bb[a], __fmul_rn(static_cast<float>(h3[a] + 1), g.cell));
      const float gap = fmaxf(__fsub_rn(__fsub_rn(face, q[a]), g.delta), 0.0f);
      r2 = fminf(r2, __fadd_rn(__fmul_rn(gap, gap), rest));
    }
  }
  return __fmul_rn(r2, 0.999996185302734375f);  // 1 - 2^-18
}

// The k-th d2 of a list that holds `seen` photons (inf while fewer than k).
__device__ __forceinline__ float kth_d2(unsigned long long kth, int seen, int k) {
  return seen >= k ? __uint_as_float(static_cast<unsigned>(kth >> 32)) : inf_f();
}

// Ring r's answer is final when its k-th d2 is at most R2c of ring r.
__device__ __forceinline__ bool certifies(const Grid& g, float4 qp, int4 qc, int r, float kd2) {
  return kd2 <= r2_bound(g, qp.x, qp.y, qp.z, box_lo(qc, r), box_hi(g, qc, r));
}

__device__ __forceinline__ long long box_cells(const Grid& g, int4 qc, int r) {
  const int3 lo = box_lo(qc, r), hi = box_hi(g, qc, r);
  return static_cast<long long>(hi.x - lo.x + 1) * (hi.y - lo.y + 1) * (hi.z - lo.z + 1);
}

__device__ void write_list(const Out& o, int qi, const List& l, int cnt, int k, int lane) {
  int* idx = o.idx + static_cast<size_t>(qi) * k;
  float* d2 = o.d2 + static_cast<size_t>(qi) * k;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int slot = lane + 32 * h;
    if (slot < k) {
      const unsigned long long key = h ? l.b : l.a;
      const bool f = slot < cnt;
      idx[slot] = f ? static_cast<int>(key & 0xffffffffu) : 0;
      d2[slot] = f ? __uint_as_float(static_cast<unsigned>(key >> 32)) : inf_f();
    }
  }
  if (lane == 0) o.cnt[qi] = cnt;
}

__device__ List read_list(const Out& o, int qi, int cnt, int k, int lane) {
  const int* idx = o.idx + static_cast<size_t>(qi) * k;
  const float* d2 = o.d2 + static_cast<size_t>(qi) * k;
  List l{kInf, kInf};
  if (lane < cnt) l.a = make_key(d2[lane], idx[lane]);
  if (lane + 32 < cnt) l.b = make_key(d2[lane + 32], idx[lane + 32]);
  return l;
}

__global__ void __launch_bounds__(kThreads) knn_ring1(const float4* __restrict__ qpos,
                                                      const int4* __restrict__ qcell, Grid g,
                                                      int Q, Out o, int2* __restrict__ queue,
                                                      int* __restrict__ queued, int k) {
  const int lane = threadIdx.x & 31;
  const int w = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (w >= Q) return;
  const float4 qp = qpos[w];
  const int4 qc = qcell[w];
  List l{kInf, kInf};
  int seen = 0, stage = 0;
  if (qp.w > 0.5f) {
    unsigned long long kth = kInf;
    const int3 lo = box_lo(qc, 1), hi = box_hi(g, qc, 1);
    const int3 plo = make_int3(qc.x, qc.y, qc.z), phi = make_int3(qc.x - 1, qc.y - 1, qc.z - 1);
    read_shell(g, qp.x, qp.y, qp.z, lo, hi, plo, phi, l, kth, k, lane, seen);
    if (certifies(g, qp, qc, 1, kth_d2(kth, seen, k))) {
      stage = 1;
    } else if (lane == 0) {
      queue[atomicAdd(queued, 1)] = make_int2(w, seen);
    }
  }
  write_list(o, qc.w, l, min(seen, k), k, lane);
  if (lane == 0) {
    o.stage[qc.w] = stage;
    if (o.evaluated) o.evaluated[qc.w] = seen;
  }
}

__global__ void __launch_bounds__(kThreads) knn_rings(const float4* __restrict__ qpos,
                                                      const int4* __restrict__ qcell, Grid g, Out o,
                                                      const int2* __restrict__ queue,
                                                      int* __restrict__ queued,
                                                      int* __restrict__ queue2, int k) {
  const int lane = threadIdx.x & 31;
  const int n1 = queued[0];
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5); item < n1;
       item += gridDim.x * kWarps) {
    const int2 q = queue[item];
    const float4 qp = qpos[q.x];
    const int4 qc = qcell[q.x];
    int seen = q.y;
    List l = read_list(o, qc.w, min(seen, k), k, lane);
    unsigned long long kth = kth_key(l, k);
    int r = 1, stage = kStageScan;
    for (;;) {
      // The next ring: half as wide again (at least one more), or sooner the
      // first ring whose bound covers the k-th known now (the k-th only
      // falls, so that ring certifies), at most the last ring within the
      // budget. Its new cells are read as one thick shell.
      int next = r + max(1, r >> 1);
      const float kd2 = kth_d2(kth, seen, k);
      if (seen >= k) {
        int t = r + 1;
        while (t < next && !certifies(g, qp, qc, t, kd2)) ++t;
        next = t;
      }
      while (next > r && box_cells(g, qc, next) > g.budget) --next;
      if (next <= r) break;  // past the budget: the scan
      read_shell(g, qp.x, qp.y, qp.z, box_lo(qc, next), box_hi(g, qc, next), box_lo(qc, r),
                 box_hi(g, qc, r), l, kth, k, lane, seen);
      const float kd2n = kth_d2(kth, seen, k);
      if (certifies(g, qp, qc, next, kd2n)) {
        // The stage is the first ring that certifies, whatever the schedule:
        // for a ring s past r, kth(s) <= R2c(s) holds exactly when the final
        // k-th does.
        stage = r + 1;
        while (!certifies(g, qp, qc, stage, kd2n)) ++stage;
        break;
      }
      r = next;
    }
    write_list(o, qc.w, l, min(seen, k), k, lane);
    if (lane == 0) {
      o.stage[qc.w] = stage;
      if (o.evaluated) o.evaluated[qc.w] = seen;
      if (stage == kStageScan) queue2[atomicAdd(queued + 1, 1)] = q.x;
    }
  }
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy photons [t0, t0 + n) into a shared tile: 16-byte cp.async copies by
// every thread, the last 4-12 bytes in 4-byte copies by thread 0. The tile's
// source starts on a 16-byte boundary (t0 is a multiple of kTile).
__device__ __forceinline__ void issue_tile(float* dst, const float* pos, int t0, int n) {
  const float* src = pos + 3 * static_cast<size_t>(t0);
  const int words = 3 * n, chunks = words >> 2;
  for (int i = threadIdx.x; i < chunks; i += kThreads) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst + 4 * i)),
                 "l"(src + 4 * i)
                 : "memory");
  }
  if (threadIdx.x == 0) {
    for (int i = 4 * chunks; i < words; ++i) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst + i)),
                   "l"(src + i)
                   : "memory");
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// The i-th tile a scan visits: first the tile that holds `center`, then the
// tiles on either side of it, alternately, then the rest of the longer side.
// Photons are sorted by cell (x slowest), so the nearest photons come early
// and the k-th key tightens before most tiles: the order changes no result.
__device__ __forceinline__ int tile_at(int i, int center, int ntiles) {
  if (i == 0) return center;
  const int j = i - 1, left = center, right = ntiles - 1 - center;
  const int m = min(left, right);
  if (j < 2 * m) return (j & 1) ? center - (j >> 1) - 1 : center + (j >> 1) + 1;
  return right > left ? center + m + 1 + (j - 2 * m) : center - m - 1 - (j - 2 * m);
}

__global__ void __launch_bounds__(kThreads) knn_scan(const float4* __restrict__ qpos,
                                                     const int4* __restrict__ qcell, Grid g, Out o,
                                                     const int* __restrict__ queue2,
                                                     const int* __restrict__ queued, int k) {
  __shared__ __align__(16) float tile[2][3 * kTile];
  const int lane = threadIdx.x & 31;
  const int n2 = queued[1];
  const int ntiles = (g.count + kTile - 1) / kTile;
  for (int grp = blockIdx.x; grp * kWarps < n2; grp += gridDim.x) {
    const int item = grp * kWarps + (threadIdx.x >> 5);
    const bool active = item < n2;  // warp-uniform
    float4 qp = make_float4(0.f, 0.f, 0.f, 0.f);
    int qi = 0;
    unsigned long long thr = kInf;
    if (active) {
      const int w = queue2[item];
      qp = qpos[w];
      qi = qcell[w].w;
      if (o.cnt[qi] == k) {  // the ring's k-th key bounds the answer's
        const size_t last = static_cast<size_t>(qi) * k + k - 1;
        thr = make_key(o.d2[last], o.idx[last]) + 1;
      }
    }
    List l{kInf, kInf};
    unsigned long long kth = thr;
    // The block's tiles start at the first query's cell (every thread reads it).
    const int4 c0 = qcell[queue2[grp * kWarps]];
    const int center = __ldg(g.cs + (c0.x * g.n[1] + c0.y) * g.n[2] + c0.z) / kTile;
    const int first = min(center, ntiles - 1);
    issue_tile(tile[0], g.pos, first * kTile, min(kTile, g.count - first * kTile));
    for (int i = 0; i < ntiles; ++i) {
      if (i + 1 < ntiles) {
        const int t1 = tile_at(i + 1, first, ntiles) * kTile;
        issue_tile(tile[(i + 1) & 1], g.pos, t1, min(kTile, g.count - t1));
        asm volatile("cp.async.wait_group 1;" ::: "memory");
      } else {
        asm volatile("cp.async.wait_group 0;" ::: "memory");
      }
      __syncthreads();
      if (active) {
        const int t0 = tile_at(i, first, ntiles) * kTile, n = min(kTile, g.count - t0);
        const float* s = tile[i & 1];
        // kUnroll photons a lane per step: independent distance chains, then
        // one ballot each (a candidate below the k-th is rare in a scan).
        for (int j0 = 0; j0 < n; j0 += 32 * kUnroll) {
          unsigned long long c[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) {
            const int j = j0 + 32 * u + lane;
            c[u] = j < n ? make_key(dist2(qp.x, qp.y, qp.z, s[3 * j], s[3 * j + 1], s[3 * j + 2]),
                                    t0 + j)
                         : kInf;
          }
#pragma unroll
          for (int u = 0; u < kUnroll; ++u) offer(l, c[u], kth, thr, k, lane);
        }
      }
      __syncthreads();  // the tile is consumed before the next copy into it
    }
    if (active) {
      write_list(o, qi, l, min(g.count, k), k, lane);
      if (lane == 0 && o.evaluated) o.evaluated[qi] += g.count;
    }
  }
}

struct Launch {
  int sms = 0;
  int blocks[3] = {0, 0, 0};  // resident blocks per SM: ring1, rings, scan
};

const Launch& launch_shape() {
  static Launch s;
  if (s.sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks[0], knn_ring1, kThreads, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks[1], knn_rings, kThreads, 0);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&s.blocks[2], knn_scan, kThreads, 0);
  }
  return s;
}

Grid make_grid(const void* pos, const void* cs, int nx, int ny, int nz, int n, float bbx,
               float bby, float bbz, float cell, float hix, float hiy, float hiz, float delta,
               int budget) {
  Grid g;
  g.pos = static_cast<const float*>(pos);
  g.cs = static_cast<const int*>(cs);
  g.n[0] = nx, g.n[1] = ny, g.n[2] = nz;
  g.count = n;
  g.bb[0] = bbx, g.bb[1] = bby, g.bb[2] = bbz;
  g.cell = cell;
  g.hi[0] = hix, g.hi[1] = hiy, g.hi[2] = hiz;
  g.delta = delta;
  g.budget = budget;
  return g;
}

Out make_out(void* idx, void* d2, void* cnt, void* stage, void* evaluated) {
  return Out{static_cast<int*>(idx), static_cast<float*>(d2), static_cast<int*>(cnt),
             static_cast<int*>(stage), static_cast<int*>(evaluated)};
}

}  // namespace

#define MCRT_GRID_PARAMS                                                                       \
  const void *pos, const void *cs, int nx, int ny, int nz, int n, float bbx, float bby,       \
      float bbz, float cell, float hix, float hiy, float hiz, float delta, int budget
#define MCRT_GRID_ARGS pos, cs, nx, ny, nz, n, bbx, bby, bbz, cell, hix, hiy, hiz, delta, budget

extern "C" int mcrt_knn_ring1(const void* qpos, const void* qcell, MCRT_GRID_PARAMS, int Q,
                              void* idx, void* d2, void* cnt, void* stage, void* evaluated,
                              void* queue,
                              void* queued, int k, void* stream) {
  if (k < 1 || k > kMaxK) return kErrArgs;
  const int blocks = (Q + kWarps - 1) / kWarps;
  knn_ring1<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(qpos), static_cast<const int4*>(qcell),
      make_grid(MCRT_GRID_ARGS), Q, make_out(idx, d2, cnt, stage, evaluated), static_cast<int2*>(queue),
      static_cast<int*>(queued), k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcrt_knn_rings(const void* qpos, const void* qcell, MCRT_GRID_PARAMS, void* idx,
                              void* d2, void* cnt, void* stage, void* evaluated, void* queue,
                              void* queued,
                              void* queue2, int k, void* stream) {
  if (k < 1 || k > kMaxK) return kErrArgs;
  const Launch& s = launch_shape();
  knn_rings<<<s.sms * s.blocks[1], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(qpos), static_cast<const int4*>(qcell),
      make_grid(MCRT_GRID_ARGS), make_out(idx, d2, cnt, stage, evaluated),
      static_cast<const int2*>(queue), static_cast<int*>(queued), static_cast<int*>(queue2), k);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mcrt_knn_scan(const void* qpos, const void* qcell, MCRT_GRID_PARAMS, void* idx,
                             void* d2, void* cnt, void* stage, void* evaluated, void* queue2,
                             void* queued, int k, void* stream) {
  if (k < 1 || k > kMaxK) return kErrArgs;
  const Launch& s = launch_shape();
  knn_scan<<<s.sms * s.blocks[2], kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(qpos), static_cast<const int4*>(qcell),
      make_grid(MCRT_GRID_ARGS), make_out(idx, d2, cnt, stage, evaluated),
      static_cast<const int*>(queue2), static_cast<const int*>(queued), k);
  return static_cast<int>(cudaGetLastError());
}

// Warps of kernel i (0 ring1, 1 rings, 2 scan) resident on one SM.
extern "C" int mcrt_knn_resident_warps(int i) {
  if (i < 0 || i > 2) return -1;
  return launch_shape().blocks[i] * kWarps;
}
