// Cluster-BVH traversal kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel `_kernel` of mcrt_tpu/ops/traverse_kernel.py
// (fused cull + best-first cluster traversal). What it computes, and its plain
// PyTorch twin, are described in mcrt_tpu_torch/ops/traverse_kernel.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): a round fetches one
// record, n x 84 bytes for a cluster of n real triangles, and does K x n x 38
// FP32 operations; at K = 256 that is ~460 operations per fetched byte against
// the card's 20, so the traversal is bound by arithmetic: 0.256 ms for the
// mean 16384-ray launch of the path tracer's camera, surface and shadow rays
// (chip_smoke.py phase 3 counts it from the clusters each block visits).
//
// Launch shape: one block of kThreads = 544 threads per block of K <= 256 rays.
// Threads 0..2K-1 are consumers, two per ray; the last warp is the producer;
// threads of missing rays (K < 256) only help with the cull. What the design
// does about the four costs of a first version that rescanned, staged
// synchronously and had one thread per ray:
//
//   1. Cull (all threads). The clusters are in BVH order, so 16 consecutive
//      ones lie close together: a ray slab-tests a group's union box first
//      and tests the group's clusters only if it may hit it, which is exact
//      (see may_hit) and skips ~98% of the tests on the main path. Tiles of
//      256 AABBs are double-buffered in shared memory, the next tile's loads in
//      flight while this one is tested, and the warp that holds a group of the
//      next tile reduces it to its box; two barriers a tile. The two threads
//      of a ray share the group tests and take alternate clusters;
//      NaN-propagating min and max are one instruction each. Warp
//      OR-reductions and a shared OR give the clusters some ray hits, and only
//      those candidates' entry distances are written, compacted in cluster
//      order, to a global scratch laid out (B, C, K), so a warp reads a
//      candidate's column coalesced; they are recomputed for the few
//      candidates rather than held in a per-thread array. A pass over the
//      columns gives each candidate its first key, the column minimum.
//   2. Selection (producer warp) instead of a rescan: a lazy min-heap of
//      (key, candidate) lower bounds, 8 bytes each, in shared memory
//      (kHeapShared entries; a block with more candidates keeps it in its
//      slice of a global scratch, through the same pointer). A key is the
//      least entry distance among the rays whose entry lies below their best
//      t; best t only shrinks, so keys only grow and a stored key is a lower
//      bound. To choose, the warp recomputes the top's key from its column (8
//      loads a lane, a warp min) against the published best t and takes it if
//      it is still below both children; else it sinks with the new key, and a
//      BIG key drops it. Keys and candidate indices are packed into one
//      ordered 64-bit integer, so ties go to the lower cluster index, as in
//      the plain version. A rescan of every live candidate's column each round
//      cost O(candidates x K) per round; a check costs O(K + log candidates).
//   3. Staging (producer warp) instead of a synchronous copy: the chosen
//      cluster's ids are copied by the warp, which counts the real triangles
//      (padding sits at the tail), and its n x 80-byte record by one TMA bulk
//      copy (cp.async.bulk) completing on the buffer's mbarrier, into the
//      second of two shared buffers: the Hopper form of the TPU kernel's two
//      DMA slots.
//   4. Rounds (consumers), in the TPU kernel's order: the cluster of round r+1
//      is chosen from the best t published at the end of round r-1 while the
//      consumers evaluate round r, so selection and staging hide behind the
//      forms. Published best t is double-buffered; consumers keep their
//      running best in registers, publish it, and arrive on the buffer's
//      "done" mbarrier, which frees the buffer for round r+2; there is no
//      block-wide barrier after the cull. Two threads per ray give twice the
//      warps of one thread per ray to hide the forms' latency (four would need
//      1056 threads with the producer, over the 1024 a block may have): four
//      threads share two adjacent rays and take every fourth triangle, so each
//      record row read from shared memory serves two rays. The quarters'
//      nearest hits combine by (t, slot), ties to the lower slot: the serial
//      loop's first minimum, so the result does not depend on the split. The
//      loop carries only (t, slot); the winner's u and v are computed again.
//   5. Arithmetic: float32 on the CUDA cores, not TF32, and no fast math.
//      Only the nonzero coefficients of the dense 10-feature bilinear forms
//      are stored, and each form is a chain of FP32 fused multiply-adds (3 for
//      det, 6 for u*det and v*det, 3 plus one add for t*det); the reciprocal
//      is IEEE, and no other product is fused into a sum. The acceptance test
//      leaves out the plain version's compares that the others imply. The
//      plain PyTorch version computes the same fused multiply-adds exactly
//      (float64 products, sums rounded to odd), so the two agree bit for bit.
//      That matters: camera rays of a regular mesh land exactly on shared
//      edges, where the last bit decides which triangle wins.
//
// Launch width. A launch has B = rays / K ray blocks: 64 at the default 16384
// lanes, for 132 SMs, and it lasts as long as its block of most rounds. When
// every pair can be resident at once (B <= the two-CTA clusters of this kernel
// that fit on the card, cudaOccupancyMaxActiveClusters), each ray block runs as
// a two-CTA thread-block cluster, so 2B SMs share the work; otherwise one CTA
// per block, as above. Both CTAs of a pair hold the same K rays:
//
//   - Cull: each CTA culls K/2 of the rays, four threads a ray; every warp ORs
//     its tile mask into both CTAs' masks (distributed shared memory), so after
//     one cluster barrier a tile both hold the union and compact the same
//     candidates, each writing its rays' half of every candidate's column. The
//     first keys are split by candidate, the peer's written into the leader's
//     heap.
//   - Rounds: the leader's producer warp keeps the heap and the one-round-stale
//     choice. A key is read against the pair's published best t: per ray the
//     least of the leader's s_bt and the peer's, which the peer's consumers
//     store into the leader (s_bt2) before they arrive on the leader's done
//     barrier. The leader tells the peer n and the ids, and issues both TMA
//     copies: slots [0, ceil(n/2)) into its own record buffer, [ceil(n/2), n)
//     into the peer's, completing on the peer's full barrier.
//   - Each CTA keeps per ray the best over its half: (t, round, slot, u, v, id)
//     with a strict t < best across rounds and the first minimum within one, so
//     the pair's result is the least (t, round, slot) of the two: the serial
//     loop's. The peer hands its bests to the leader through one cluster
//     barrier; the leader writes the outputs and the stats.
//
// mcrt_traverse's `width` is 1, 2 (forced; for tests) or 0 (the rule above);
// mcrt_traverse_pairs gives the clusters that fit, queried once per device and
// shared-memory size.
//
// mcrt_traverse returns kErrSmem when the buffers do not fit in the shared
// memory a block may opt in to, kErrHeap when a block could need the global
// heap and none was given, kErrK for a K over kMaxK or not a multiple of 32,
// kErrWidth for a width other than 0, 1 or 2, else the launch's CUDA error; the
// wrapper raises if it is not 0. Given a `cycles` array it launches the variant
// that stamps clock64() per CTA (cull, selection, staging, waits, forms); the
// main path passes none.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kTile = 256;         // clusters per cull tile (one mask bit each)
constexpr int kMaskW = kTile / 32; // mask words per tile
constexpr int kGroup = 16;         // clusters per group box of the cull
constexpr int kGroups = kTile / kGroup;
constexpr int kRecW = 20;          // floats per triangle record row (19 used)
constexpr int kRowBytes = kRecW * 4;
constexpr int kHeapShared = 4096;  // heap entries kept in shared memory
// Shared heap slots of a block over C clusters: an even count, so that the
// float4 tiles after the 8-byte slots stay 16-byte aligned for any C.
__host__ __device__ constexpr int heap_slots(int C) {
  return ((C < kHeapShared ? C : kHeapShared) + 1) & ~1;
}
constexpr int kMaxK = 256;         // rays per block at most; the block has 2 kMaxK + 32 threads
constexpr int kThreads = 2 * kMaxK + 32;
constexpr int kErrSmem = -1;
constexpr int kErrHeap = -2;
constexpr int kErrK = -3;
constexpr int kErrWidth = -4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;

// Per-CTA cycle counters of the stamping variant.
enum { kCycTotal, kCycCull, kCycSelect, kCycLoad, kCycProdWait, kCycStageWait, kCycForms, kNCyc };

// NaN-propagating min and max, as torch.minimum and torch.maximum: one
// instruction each (sm_80+). A zero's sign may differ from torch's; entry
// distances are only compared, where -0 == +0.
__device__ __forceinline__ float nmin(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float nmax(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Waits for the phase of `parity`; kCluster: acquiring at cluster scope what the
// other CTA of the pair released when it arrived.
template <bool kCluster = false>
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    if (kCluster) {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    } else {
      asm volatile(
          "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done)
          : "r"(a), "r"(parity)
          : "memory");
    }
  }
}
// One TMA bulk copy global -> shared, completing `bytes` on `bar`; `dst` and
// `bar` are shared::cluster addresses, of this CTA or of the other of the pair.
__device__ __forceinline__ void bulk_copy(uint32_t dst, const void* src, unsigned bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];" ::"r"(
          dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- the pair: a two-CTA cluster ----
__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
// Every thread of both CTAs: release what each wrote, acquire the other's.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n barrier.cluster.wait;" ::: "memory");  // release, acquire
}
// The same shared variable in CTA `rank` of the cluster: a generic pointer
// (loads, stores and atomics reach it through distributed shared memory) or a
// shared::cluster address (mbarriers and TMA).
template <typename T>
__device__ __forceinline__ T* peer_ptr(T* p, unsigned rank) {
  uint64_t r;
  asm volatile("mapa.u64 %0, %1, %2;" : "=l"(r) : "l"(p), "r"(rank));
  return reinterpret_cast<T*>(r);
}
__device__ __forceinline__ uint32_t peer_addr(const void* p, unsigned rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(smem_addr(p)), "r"(rank));
  return r;
}
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_arrive_tx_remote(uint32_t bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cluster.shared::cluster.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// One ray: direction, origin, and direction x origin.
struct Ray {
  float dx, dy, dz, ox, oy, oz, cx, cy, cz;
};
__device__ __forceinline__ Ray load_ray(const float4* rays, size_t ray) {
  const float4 r0 = rays[ray * 3 + 0], r1 = rays[ray * 3 + 1], r2 = rays[ray * 3 + 2];
  return {r0.x, r0.y, r0.z, r1.x, r1.y, r1.z, r2.x, r2.y, r2.z};
}

// Slab test of one AABB (lo xyz, 0, hi xyz, 0): its entry and exit distances.
// A NaN box (the cull's tile padding) gives NaN, which no test below passes.
__device__ __forceinline__ void slab(const float4* bb, const Ray& y, float ix, float iy, float iz,
                                     float& tnear, float& tfar) {
  const float4 lo = bb[0], hi = bb[1];
  const float t1x = (lo.x - y.ox) * ix, t2x = (hi.x - y.ox) * ix;
  const float t1y = (lo.y - y.oy) * iy, t2y = (hi.y - y.oy) * iy;
  const float t1z = (lo.z - y.oz) * iz, t2z = (hi.z - y.oz) * iz;
  tnear = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
  tfar = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
}
// The entry distance, BIG on a miss (the plain version's entry matrix).
__device__ __forceinline__ float entry(const float4* bb, const Ray& y, float ix, float iy, float iz) {
  float tnear, tfar;
  slab(bb, y, ix, iy, iz, tnear, tfar);
  return (tnear <= tfar && tfar >= 0.0f) ? tnear : kBig;
}
// Whether the ray may make some box inside `bb` a candidate. Conservative: the
// slab times are monotone in the bounds, so a box that contains a candidate's
// box gives an interval that contains the candidate's, and a NaN passes.
__device__ __forceinline__ bool may_hit(const float4* bb, const Ray& y, float ix, float iy,
                                        float iz) {
  float tnear, tfar;
  slab(bb, y, ix, iy, iz, tnear, tfar);
  return !(tnear > tfar) & !(tfar < 0.0f);
}
// Whether the ray makes the box a candidate: entry(...) < BIG.
__device__ __forceinline__ bool candidate(const float4* bb, const Ray& y, float ix, float iy,
                                          float iz) {
  float tnear, tfar;
  slab(bb, y, ix, iy, iz, tnear, tfar);
  return (tnear <= tfar) & (tfar >= 0.0f) & (tnear < kBig);
}

// (key, candidate) as one integer whose order is the key's, then the index's.
__device__ __forceinline__ unsigned long long pack(float key, int j) {
  if (key == 0.0f) key = 0.0f;  // -0 and +0 tie, as in a float compare
  const uint32_t u = __float_as_uint(key);
  const uint32_t o = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(o) << 32) | static_cast<uint32_t>(j);
}

__device__ void sift_down(unsigned long long* h, int n, int i) {
  const unsigned long long x = h[i];
  for (;;) {
    int c = 2 * i + 1;
    if (c >= n) break;
    unsigned long long y = h[c];
    if (c + 1 < n) {
      const unsigned long long z = h[c + 1];
      if (z < y) { y = z; ++c; }
    }
    if (x <= y) break;
    h[i] = y;
    i = c;
  }
  h[i] = x;
}

// One triangle's record row: the nonzero coefficients of its forms.
struct Row {
  float4 a, p, q, w, e;
};
__device__ __forceinline__ Row load_row(const float4* r) { return {r[0], r[1], r[2], r[3], r[4]}; }

// One triangle's Moller-Trumbore forms for one ray: (t, u, v) and whether the
// hit is valid and nearer than `tb`. The plain version's terms in its order,
// each product fused into the sum.
__device__ __forceinline__ bool forms(const Row& row, const Ray& y, float tb, float& t, float& u,
                                      float& v) {
  const float4 a = row.a, p = row.p, q = row.q, w = row.w, e = row.e;
  const float det = fmaf(y.dz, a.z, fmaf(y.dy, a.y, y.dx * a.x));
  const float udet = fmaf(y.cz, q.x, fmaf(y.cy, p.w, fmaf(y.cx, p.z, fmaf(y.dz, p.y,
                     fmaf(y.dy, p.x, y.dx * a.w)))));
  const float vdet = fmaf(y.cz, w.z, fmaf(y.cy, w.y, fmaf(y.cx, w.x, fmaf(y.dz, q.w,
                     fmaf(y.dy, q.z, y.dx * q.y)))));
  const float tdet = fmaf(y.oz, e.y, fmaf(y.oy, e.x, y.ox * w.w)) + e.z;
  const float inv = __frcp_rn(det);  // IEEE 1/det
  u = udet * inv;
  v = vdet * inv;
  t = tdet * inv;
  // The plain version also asks det != 0, u <= 1 and v <= 1: with det = 0, u
  // and v are infinite or NaN and fail u >= 0 or u + v <= 1; and u, v >= 0
  // with fl(u + v) <= 1 imply u, v <= 1. __fadd_rn: u + v must not be
  // contracted into fmaf(udet, inv, v).
  return (u >= 0.0f) & (v >= 0.0f) & (__fadd_rn(u, v) <= 1.0f) & (t > 0.0f) & (t < tb);
}

// A candidate's key against the published best t: the least entry distance
// among the rays whose entry lies below their best t (warp-uniform result).
// In a pair (kPair), a ray's best t is the lesser of bt and the peer's bt2.
template <bool kPair>
__device__ __forceinline__ float column_key(const float* col, const float* bt, const float* bt2,
                                            int K, int lane) {
  float m = kBig;
  for (int q = lane; q < K; q += 32) {
    const float x = col[q];
    if (x < (kPair ? fminf(bt[q], bt2[q]) : bt[q])) m = fminf(m, x);
  }
  for (int off = 16; off; off >>= 1) m = fminf(m, __shfl_xor_sync(kFull, m, off));
  return m;
}

// The producer's choice: the candidate of least (key, index) against `bt` (and
// `bt2`), removed from the heap; -1 when none is left whose key is below BIG.
template <bool kPair>
__device__ int choose(unsigned long long* heap, int& hn, const float* tn_b, const float* bt,
                      const float* bt2, int K, int lane) {
  for (;;) {
    if (hn == 0) return -1;
    unsigned long long top = 0, child = kNone;
    if (lane == 0) {
      top = heap[0];
      if (hn > 1) child = heap[1];
      if (hn > 2 && heap[2] < child) child = heap[2];
    }
    top = __shfl_sync(kFull, top, 0);
    child = __shfl_sync(kFull, child, 0);
    const int j = static_cast<int>(top & 0xffffffffu);
    const float key = column_key<kPair>(tn_b + static_cast<size_t>(j) * K, bt, bt2, K, lane);
    const unsigned long long e = key < kBig ? pack(key, j) : kNone;
    if (e == kNone || e < child) {  // dropped, or still the least: pop it
      --hn;
      if (lane == 0 && hn > 0) {
        heap[0] = heap[hn];
        sift_down(heap, hn, 0);
      }
      __syncwarp();
      if (e != kNone) return j;
    } else {  // its key grew past a child's: it sinks with the new key
      if (lane == 0) {
        heap[0] = e;
        sift_down(heap, hn, 0);
      }
      __syncwarp();
    }
  }
}

// Dynamic shared memory of a CTA: two record buffers (of half a record in a
// pair), the shared heap, the cull's double-buffered AABB tile and group boxes,
// the double-buffered published best t (and, in a pair, the peer's), and two
// id buffers.
__host__ __device__ constexpr size_t smem_bytes(int K, int C, int Sp, bool pair) {
  return static_cast<size_t>(pair ? Sp / 2 : Sp) * 2 * kRowBytes + static_cast<size_t>(Sp) * 2 * 4 +
         static_cast<size_t>(heap_slots(C)) * 8 +
         sizeof(float) * (2 * kTile * 8 + 2 * kGroups * 8 + (pair ? 4 : 2) * K);
}

template <bool kStamp, bool kPair>
__global__ void __launch_bounds__(kThreads) traverse_kernel(
    const float4* __restrict__ rays,  // (B*K, 3) float4
    const float* __restrict__ cl_bb,  // (C, 8)
    const float4* __restrict__ rec,   // (C, Sp, 5) float4
    const int* __restrict__ tri,      // (C, Sp)
    float* __restrict__ tn_s,         // (B, C, K) scratch
    int* __restrict__ cand_s,         // (B, C) scratch
    unsigned long long* heap_g,       // (B, C) scratch, or null when C <= kHeapShared
    float* __restrict__ out_t, int* __restrict__ out_id, float* __restrict__ out_u,
    float* __restrict__ out_v, int* __restrict__ stats,  // (B, 2)
    long long* __restrict__ cycles,                      // (CTAs, kNCyc) when kStamp
    int K, int C, int Sp) {
  constexpr int kSub = kPair ? 4 : 2;  // threads that cull one ray
  const int Sh = kPair ? Sp / 2 : Sp;  // record rows a buffer holds
  extern __shared__ __align__(128) unsigned char smem[];
  float4* s_rec = reinterpret_cast<float4*>(smem);                        // 2 x Sh x 5
  unsigned long long* s_heap =
      reinterpret_cast<unsigned long long*>(s_rec + 2 * Sh * 5);          // heap_slots(C)
  float4* s_bb = reinterpret_cast<float4*>(s_heap + heap_slots(C));      // 2 x kTile x 2
  float4* s_grp = s_bb + 4 * kTile;                                       // 2 x kGroups x 2
  float* s_bt = reinterpret_cast<float*>(s_grp + 4 * kGroups);            // 2 x K published best t
  float* s_bt2 = s_bt + 2 * K;                                            // 2 x K the peer's (pair)
  int* s_tri = reinterpret_cast<int*>(s_bt + (kPair ? 4 : 2) * K);        // 2 x Sp
  __shared__ uint64_t full_bar[2], done_bar[2];
  __shared__ int s_n[2];
  __shared__ unsigned s_mask[2][kMaskW];

  const long long t_start = kStamp ? clock64() : 0;
  const int t = threadIdx.x;
  const unsigned rank = kPair ? cluster_rank() : 0;  // 0: the leader
  const int b = kPair ? blockIdx.x >> 1 : blockIdx.x;
  const int lane = t & 31;
  const int nthreads = blockDim.x;
  const int ncons = 2 * K;
  const bool consumer = t < ncons;          // threads 2K..2kMaxK-1 only help with the cull
  const bool producer = t >= 2 * kMaxK;
  const int k = (kPair ? rank * (K / 2) : 0) + t / kSub;  // the ray this thread culls for
  const int h = t % kSub;  // and which of a tile's clusters it tests
  float* tn_b = tn_s + static_cast<size_t>(b) * C * K;
  int* cand_b = cand_s + static_cast<size_t>(b) * C;

  Ray y = {};
  if (consumer) y = load_ray(rays, static_cast<size_t>(b) * K + k);
  const float ix = __fdiv_rn(1.0f, y.dx), iy = __fdiv_rn(1.0f, y.dy), iz = __fdiv_rn(1.0f, y.dz);

  if (t < 2 * kMaskW) s_mask[t / kMaskW][t % kMaskW] = 0u;
  if (t == 0) {
    mbar_init(&full_bar[0], 32);
    mbar_init(&full_bar[1], 32);
    mbar_init(&done_bar[0], kPair ? 2 * ncons : ncons);  // a pair's rounds end on the leader's
    mbar_init(&done_bar[1], kPair ? 2 * ncons : ncons);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  for (int e = t; e < (kPair ? 4 : 2) * K; e += nthreads) s_bt[e] = kBig;
  if (kPair) cluster_sync();  // both CTAs' masks and barriers are set before either touches them

  // ---- 1. cull, compacting the candidates in cluster order ----
  // Bit i of a tile's mask: some ray (of either CTA of a pair) hits cluster c0 + i.
  const float4* bb4 = reinterpret_cast<const float4*>(cl_bb);
  const int ntiles = (C + kTile - 1) / kTile;
  const float qnan = __int_as_float(0x7fffffff);
  const float4 nan4 = make_float4(qnan, qnan, qnan, qnan);
  // Thread t < 2 kTile holds float4 t of the next tile (NaN past the last
  // cluster): the lo (t even) or hi (t odd) corner of cluster t / 2, so warp g
  // holds group g and reduces it to the group's box.
  auto group_box = [&](float4 x, float4* grp) {
#pragma unroll
    for (int off = 2; off < 32; off <<= 1) {
      const float ax = __shfl_xor_sync(kFull, x.x, off), ay = __shfl_xor_sync(kFull, x.y, off);
      const float az = __shfl_xor_sync(kFull, x.z, off);
      x.x = (lane & 1) ? fmaxf(x.x, ax) : fminf(x.x, ax);
      x.y = (lane & 1) ? fmaxf(x.y, ay) : fminf(x.y, ay);
      x.z = (lane & 1) ? fmaxf(x.z, az) : fminf(x.z, az);
    }
    if (lane < 2) grp[2 * (t >> 5) + lane] = x;
  };
  float4 pre = t < 2 * kTile && t < 2 * C ? bb4[t] : nan4;
  if (t < 2 * kTile) group_box(pre, s_grp);
  int ncand = 0;
  for (int it = 0; it < ntiles; ++it) {
    const int c0 = it * kTile;
    float4* tile = s_bb + (it & 1) * 2 * kTile;
    const float4* grp = s_grp + (it & 1) * 2 * kGroups;
    if (t < 2 * kTile) tile[t] = pre;
    __syncthreads();  // the tile and its group boxes are staged; every thread has
                      // read the mask of tile it-1
    if (t < kMaskW) s_mask[(it + 1) & 1][t] = 0u;
    if (t < 2 * kTile) pre = 2 * (c0 + kTile) + t < 2 * C ? bb4[2 * (c0 + kTile) + t] : nan4;
    unsigned mine[kMaskW] = {};
    if (consumer) {
      // The ray's threads test alternate group boxes and share the results.
      unsigned gm = 0;
#pragma unroll
      for (int g = 0; g < kGroups; g += kSub) gm |= unsigned(may_hit(grp + 2 * (g + h), y, ix, iy, iz)) << (g + h);
#pragma unroll
      for (int off = 1; off < kSub; off <<= 1) gm |= __shfl_xor_sync(kFull, gm, off);
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        if (!((gm >> g) & 1u)) continue;
#pragma unroll
        for (int m = 0; m < kGroup; m += kSub) {
          const int i = kGroup * g + m + h;
          if (candidate(tile + 2 * i, y, ix, iy, iz)) mine[g * kGroup / 32] |= 1u << (i & 31);
        }
      }
    }
#pragma unroll
    for (int w = 0; w < kMaskW; ++w) {
      const unsigned any = __reduce_or_sync(kFull, mine[w]);
      if (lane == 0 && any) {
        atomicOr(&s_mask[it & 1][w], any);
        if (kPair) atomicOr(peer_ptr(&s_mask[it & 1][w], rank ^ 1u), any);
      }
    }
    if (t < 2 * kTile) group_box(pre, s_grp + ((it + 1) & 1) * 2 * kGroups);
    // The mask (both CTAs' ORs in a pair) and the next tile's group boxes are complete.
    if (kPair) cluster_sync(); else __syncthreads();
    int q = ncand;
#pragma unroll
    for (int w = 0; w < kMaskW; ++w) {
      for (unsigned m = s_mask[it & 1][w]; m; m &= m - 1, ++q) {
        const int i = 32 * w + __ffs(m) - 1;
        if (consumer && (q - ncand) % kSub == h)
          tn_b[static_cast<size_t>(q) * K + k] = entry(tile + 2 * i, y, ix, iy, iz);
        if (t == 0 && rank == 0) cand_b[q] = c0 + i;
      }
    }
    ncand = q;
  }
  if (kPair) cluster_sync(); else __syncthreads();  // every column is written
  unsigned long long* heap =
      ncand <= kHeapShared ? s_heap : heap_g + static_cast<size_t>(b) * C;
  {
    // First keys: every best t is BIG, so a candidate's key is its column
    // minimum; in a pair each CTA takes every other candidate, into the leader's heap.
    unsigned long long* dst = kPair && rank && heap == s_heap ? peer_ptr(s_heap, 0u) : heap;
    const int warps = (nthreads >> 5) * (kPair ? 2 : 1);
    for (int j = (t >> 5) * (kPair ? 2 : 1) + rank; j < ncand; j += warps) {
      const float key = column_key<false>(tn_b + static_cast<size_t>(j) * K, s_bt, nullptr, K, lane);
      if (lane == 0) dst[j] = pack(key, j);
    }
  }
  if (kPair) cluster_sync(); else __syncthreads();
  const long long t_cull = kStamp ? clock64() : 0;

  // The ray pair of a consumer in the rounds, and its best over the CTA's slots.
  const int p = t >> 2, qt = t & 3;
  float bt[2] = {kBig, kBig}, bu[2] = {0.0f, 0.0f}, bv[2] = {0.0f, 0.0f};
  int bid[2] = {-1, -1}, br[2] = {0, 0}, r = 0;
  long long c_wait = 0, c_forms = 0;
  if (producer) {
    if (rank == 0) {
      // ---- 2-3. producer warp: choose, then stage, one round ahead ----
      long long c_select = 0, c_load = 0, c_pwait = 0, t0 = kStamp ? clock64() : 0;
      int hn = ncand;
      if (lane == 0)
        for (int i = hn / 2 - 1; i >= 0; --i) sift_down(heap, hn, i);
      __syncwarp();
      for (int r = 0;; ++r) {
        const int buf = r & 1;
        if (r >= 2) {  // round r-2 is done: its buffers are free, its best t published
          if (kStamp) { const long long x = clock64(); c_select += x - t0; t0 = x; }
          mbar_wait<kPair>(&done_bar[buf], ((r - 2) >> 1) & 1);
          if (kStamp) { const long long x = clock64(); c_pwait += x - t0; t0 = x; }
        }
        const int j = choose<kPair>(heap, hn, tn_b, s_bt + buf * K, s_bt2 + buf * K, K, lane);
        if (kStamp) { const long long x = clock64(); c_select += x - t0; t0 = x; }
        if (j < 0) {  // no cluster left: tell the consumers to stop
          if (lane == 0) {
            s_n[buf] = -1;
            if (kPair) *peer_ptr(&s_n[buf], 1u) = -1;
          }
          mbar_arrive(&full_bar[buf]);
          if (kPair) mbar_arrive_remote(peer_addr(&full_bar[buf], 1u));
          break;
        }
        const int cl = cand_b[j];
        const int4* src = reinterpret_cast<const int4*>(tri + static_cast<size_t>(cl) * Sp);
        int4* dst = reinterpret_cast<int4*>(s_tri + buf * Sp);
        int4* pdst = kPair ? peer_ptr(dst, 1u) : nullptr;
        int n = 0;
        for (int e = lane; e < Sp / 4; e += 32) {
          const int4 v = src[e];
          dst[e] = v;
          if (kPair) pdst[e] = v;
          n += (v.x >= 0) + (v.y >= 0) + (v.z >= 0) + (v.w >= 0);
        }
        n = __reduce_add_sync(kFull, n);  // padding sits at the tail: n real triangles
        const int h0 = kPair ? (n + 1) >> 1 : n;  // the leader's slots [0, h0), the peer's [h0, n)
        const float4* rsrc = rec + static_cast<size_t>(cl) * Sp * 5;
        if (lane == 0) {
          s_n[buf] = n;
          if (h0 > 0) {
            mbar_arrive_tx(&full_bar[buf], static_cast<unsigned>(h0) * kRowBytes);
            bulk_copy(smem_addr(s_rec + buf * Sh * 5), rsrc, static_cast<unsigned>(h0) * kRowBytes,
                      smem_addr(&full_bar[buf]));
          } else {
            mbar_arrive(&full_bar[buf]);
          }
          if (kPair) {
            *peer_ptr(&s_n[buf], 1u) = n;
            const uint32_t pbar = peer_addr(&full_bar[buf], 1u);
            if (n > h0) {
              mbar_arrive_tx_remote(pbar, static_cast<unsigned>(n - h0) * kRowBytes);
              bulk_copy(peer_addr(s_rec + buf * Sh * 5, 1u), rsrc + h0 * 5,
                        static_cast<unsigned>(n - h0) * kRowBytes, pbar);
            } else {
              mbar_arrive_remote(pbar);
            }
          }
        } else {
          mbar_arrive(&full_bar[buf]);
          if (kPair) mbar_arrive_remote(peer_addr(&full_bar[buf], 1u));
        }
        if (kStamp) { const long long x = clock64(); c_load += x - t0; t0 = x; }
      }
      if (kStamp && lane == 0) {
        long long* cy = cycles + static_cast<size_t>(blockIdx.x) * kNCyc;
        cy[kCycSelect] = c_select;
        cy[kCycLoad] = c_load;
        cy[kCycProdWait] = c_pwait;
      }
    }
    if (!kPair) return;
  } else if (consumer) {
    // ---- 4. consumers: the rounds ----
    // Four threads share two adjacent rays and take every fourth slot of the
    // CTA's, so each record row they load from shared memory serves two rays.
    Ray ry[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) ry[j] = load_ray(rays, static_cast<size_t>(b) * K + 2 * p + j);
    long long t0 = kStamp ? clock64() : 0;
    for (;; ++r) {
      const int buf = r & 1;
      mbar_wait<kPair>(&full_bar[buf], (r >> 1) & 1);
      if (kStamp) { const long long x = clock64(); c_wait += x - t0; t0 = x; }
      const int n = s_n[buf];
      if (n < 0) break;
      const int h0 = kPair ? (n + 1) >> 1 : n;
      const int off = rank ? h0 : 0, nl = rank ? n - h0 : h0;  // this CTA's slots: [off, off + nl)
      const float4* sr = s_rec + buf * Sh * 5;
      float tb[2] = {bt[0], bt[1]};
      int sb[2] = {-1, -1};
#pragma unroll 2
      for (int s = qt; s < nl; s += 4) {
        const Row row = load_row(sr + s * 5);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          float tt, u, v;
          if (forms(row, ry[j], tb[j], tt, u, v)) { tb[j] = tt; sb[j] = s; }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // The ray's four quarters: the nearer hit, ties to the lower slot.
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          const float ot = __shfl_xor_sync(kFull, tb[j], o);
          const int os = __shfl_xor_sync(kFull, sb[j], o);
          if (os >= 0 && (sb[j] < 0 || ot < tb[j] || (ot == tb[j] && os < sb[j]))) {
            tb[j] = ot;
            sb[j] = os;
          }
        }
        if (sb[j] >= 0) {  // the winner's u and v, computed again as in the loop
          forms(load_row(sr + sb[j] * 5), ry[j], kBig, bt[j], bu[j], bv[j]);
          bid[j] = s_tri[buf * Sp + off + sb[j]];
          br[j] = r;
        }
      }
      // Published for the choice of round r+2: the peer's into the leader.
      if (qt < 2) {
        float* pub = kPair && rank ? peer_ptr(s_bt2, 0u) : s_bt;
        pub[buf * K + 2 * p + qt] = qt ? bt[1] : bt[0];
      }
      if (kPair && rank)
        mbar_arrive_remote(peer_addr(&done_bar[buf], 0u));
      else
        mbar_arrive(&done_bar[buf]);
      if (kStamp) { const long long x = clock64(); c_forms += x - t0; t0 = x; }
    }
  }

  // A writing consumer's ray, 2p + (qt & 1), and its best (selects, not an
  // index into the arrays, which would put them in local memory).
  const bool second = qt & 1;
  const int ray = 2 * p + second;
  float ot = second ? bt[1] : bt[0], ou = second ? bu[1] : bu[0], ov = second ? bv[1] : bv[0];
  int oid = second ? bid[1] : bid[0];
  float* s_cmb = reinterpret_cast<float*>(s_bb);  // the peer's bests, once the cull is over: 5 x K
  if (kPair) {
    if (rank && consumer && qt < 2) {
      float* c = peer_ptr(s_cmb, 0u);
      c[ray] = ot;
      c[K + ray] = __int_as_float(second ? br[1] : br[0]);
      c[2 * K + ray] = ou;
      c[3 * K + ray] = ov;
      c[4 * K + ray] = __int_as_float(oid);
    }
    cluster_sync();  // the peer's bests are in the leader; no CTA touches the other's after this
  }
  if (!consumer) return;
  if (qt < 2 && rank == 0) {
    if (kPair) {  // the least (t, round, slot): on a tie in t and round, the leader's lower slots
      const float pt = s_cmb[ray];
      const int pr = __float_as_int(s_cmb[K + ray]);
      if (pt < ot || (pt == ot && pr < (second ? br[1] : br[0]))) {
        ot = pt;
        ou = s_cmb[2 * K + ray];
        ov = s_cmb[3 * K + ray];
        oid = __float_as_int(s_cmb[4 * K + ray]);
      }
    }
    const size_t o = static_cast<size_t>(b) * K + ray;
    out_t[o] = ot;
    out_id[o] = oid;
    out_u[o] = ou;
    out_v[o] = ov;
  }
  if (t == 0) {
    if (rank == 0) {
      stats[b * 2 + 0] = ncand;
      stats[b * 2 + 1] = r;
    }
    if (kStamp) {
      long long* cy = cycles + static_cast<size_t>(blockIdx.x) * kNCyc;
      cy[kCycTotal] = clock64() - t_start;
      cy[kCycCull] = t_cull - t_start;
      cy[kCycStageWait] = c_wait;
      cy[kCycForms] = c_forms;
    }
  }
}

struct Args {
  const float4* rays;
  const float* cl_bb;
  const float4* rec;
  const int* tri;
  float* tn;
  int* cand;
  unsigned long long* heap;
  float *t, *u, *v;
  int *id, *stats;
  long long* cycles;
};

template <bool kStamp, bool kPair>
cudaError_t launch(const Args& a, int B, int K, int C, int Sp, size_t smem, cudaStream_t stream) {
  auto kern = traverse_kernel<kStamp, kPair>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kPair ? 2 * B : B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kPair ? 2 : 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = kPair ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a.rays, a.cl_bb, a.rec, a.tri, a.tn, a.cand,
                                           a.heap, a.t, a.id, a.u, a.v, a.stats, a.cycles, K, C, Sp);
  return e != cudaSuccess ? e : cudaGetLastError();
}

int optin_smem() {
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return optin;
}

// Two-CTA clusters of the paired kernel that can be resident at once at this
// shared memory (cudaOccupancyMaxActiveClusters), queried once per device and
// size; 0 where a pair's buffers do not fit.
int resident_pairs(int K, int C, int Sp) {
  struct Entry {
    int dev;
    size_t smem;
    int pairs;
  };
  static Entry cache[16];
  static int cached = 0;
  const size_t smem = smem_bytes(K, C, Sp, true);
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < cached; ++i)
    if (cache[i].dev == dev && cache[i].smem == smem) return cache[i].pairs;
  int pairs = 0;
  if (smem <= static_cast<size_t>(optin_smem())) {
    auto kern = traverse_kernel<false, true>;
    // As in launch, only above the default: a lower limit would refuse a later
    // launch of a shape whose shared memory lies between the two.
    if (smem > 48 * 1024) {
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(2);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 2;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    if (cudaOccupancyMaxActiveClusters(&pairs, reinterpret_cast<const void*>(kern), &cfg) !=
        cudaSuccess) {
      cudaGetLastError();  // a refused query leaves no error for the next launch to report
      pairs = 0;
    }
  }
  if (cached < 16) cache[cached++] = {dev, smem, pairs};
  return pairs;
}

}  // namespace

extern "C" int mcrt_traverse_heap_shared() { return kHeapShared; }

extern "C" int mcrt_traverse_ncycles() { return kNCyc; }

extern "C" int mcrt_traverse_pairs(int K, int C, int Sp) { return resident_pairs(K, C, Sp); }

extern "C" int mcrt_traverse(const void* rays, const void* cl_bb, const void* rec, const void* tri,
                             void* tn_scratch, void* cand_scratch, void* heap_scratch, void* out_t,
                             void* out_id, void* out_u, void* out_v, void* stats, void* cycles,
                             int B, int K, int C, int Sp, int width, void* stream) {
  if (K > kMaxK || K % 32) return kErrK;
  if (width < 0 || width > 2) return kErrWidth;
  if (width == 0) width = B <= resident_pairs(K, C, Sp) ? 2 : 1;
  const bool pair = width == 2;
  if (smem_bytes(K, C, Sp, pair) > static_cast<size_t>(optin_smem())) return kErrSmem;
  if (C > kHeapShared && heap_scratch == nullptr) return kErrHeap;
  const Args a = {static_cast<const float4*>(rays), static_cast<const float*>(cl_bb),
                  static_cast<const float4*>(rec), static_cast<const int*>(tri),
                  static_cast<float*>(tn_scratch), static_cast<int*>(cand_scratch),
                  static_cast<unsigned long long*>(heap_scratch), static_cast<float*>(out_t),
                  static_cast<float*>(out_u), static_cast<float*>(out_v), static_cast<int*>(out_id),
                  static_cast<int*>(stats), static_cast<long long*>(cycles)};
  const size_t smem = smem_bytes(K, C, Sp, pair);
  const auto st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (cycles == nullptr)
    e = pair ? launch<false, true>(a, B, K, C, Sp, smem, st) : launch<false, false>(a, B, K, C, Sp, smem, st);
  else
    e = pair ? launch<true, true>(a, B, K, C, Sp, smem, st) : launch<true, false>(a, B, K, C, Sp, smem, st);
  return static_cast<int>(e);
}
