// Cluster-BVH traversal kernel for Hopper (sm_90a), bound with ctypes.
//
// Replaces the Pallas TPU kernel `_kernel` of mcrt_tpu/ops/traverse_kernel.py
// (fused cull + best-first cluster traversal). What it computes, and its plain
// PyTorch twin, are described in mcrt_tpu_torch/ops/traverse_kernel.py.
//
// Design. One CUDA block per K-ray block (K = blockDim.x, 256 on the main
// path), one thread per ray.
//   1. Cull: the block walks the cluster AABBs in tiles of 32 (staged in shared
//      memory); each thread slab-tests its ray, a warp ballot plus a shared OR
//      marks the clusters some ray hits, and only those candidates' entry
//      distances are written, compacted, to a global scratch laid out
//      (B, C, K) so a warp's 32 rays read and write coalesced. The TPU kept the
//      whole (K, C) matrix in VMEM; that is megabytes, far over the 227 KB of
//      shared memory a block can have, so it lives in L2 / device memory here,
//      and compaction keeps the part the rounds touch small.
//   2. Rounds: each warp computes the keys of a share of the remaining
//      candidates (a coalesced read of one K-wide column per candidate, a
//      compare with the rays' best t kept in shared memory, a warp min); the
//      block takes the least (key, cluster id). A candidate whose key is BIG
//      can never come back (best t only shrinks) and is dropped; the visited
//      one is swap-removed from the compact list. The chosen cluster's record
//      (Sp x 20 floats of form coefficients) and its int32 triangle ids are
//      staged in shared memory, and every thread evaluates the forms of the
//      cluster's real triangles (padding sits at the tail) for its ray.
//   3. Arithmetic: float32 on the CUDA cores, not TF32, and no fast math.
//      Only the nonzero coefficients of the dense 10-feature bilinear forms
//      are stored, and each form is a chain of FP32 fused multiply-adds (3 for
//      det, 6 for u*det and v*det, 3 plus one add for t*det) instead of the
//      dense form's 40 multiply-adds; divisions are IEEE, and no other
//      product is fused into a sum. The plain PyTorch version computes the
//      same fused multiply-adds exactly (float64 products, sums rounded to
//      odd), so the two agree bit for bit. That matters: camera rays of a
//      regular mesh land exactly on shared edges, where the last bit decides
//      which triangle wins, and separately rounded forms pick the other one.
//
// Bounds on an H100 SXM (3.35 TB/s, 67 TFLOP/s FP32): each round fetches one
// record, n x 84 bytes for a cluster of n real triangles (the loop stops at
// the first padded slot), and does K x n x (34 + 4) FP32 operations (forms,
// one division, three products); at K = 256 that is about 456 operations per
// fetched byte, far above the card's 20 FP32 operations per byte, so a round is
// bound by arithmetic, and the record fetch of one block is shared by its 256
// rays through shared memory. The cull is K x C x ~22 operations per block,
// and the keys read n_active x K x 4 bytes of scratch per round, mostly from
// L2. Launch shape: B = rays / K blocks; at the default 16384 lanes that is 64
// blocks for 132 SMs, so half the card idles during a traversal (an open
// question for a later change: smaller K, or several blocks per ray block).
//
// The C entry point returns kErrSmem when a cluster's record does not fit in
// the shared memory a block may opt in to, else cudaGetLastError() after the
// launch; the wrapper raises if it is not 0.

#include <cuda_runtime.h>
#include <climits>

namespace {

constexpr float kBig = 3.4e38f;
constexpr int kTile = 32;    // clusters per cull tile (one ballot bit each)
constexpr int kRecW = 20;    // floats per triangle record row (19 used)
constexpr int kErrSmem = -1; // mcrt_traverse: the record does not fit in shared memory

__device__ __forceinline__ float nmin(float a, float b) {  // NaN-propagating, as torch.minimum
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float nmax(float a, float b) {  // NaN-propagating, as torch.maximum
  return (a > b || a != a) ? a : b;
}

__global__ void traverse_kernel(const float4* __restrict__ rays,   // (B*K, 3) float4
                                const float* __restrict__ cl_bb,   // (C, 8)
                                const float4* __restrict__ rec,    // (C, Sp, 5) float4
                                const int* __restrict__ tri,       // (C, Sp)
                                float* __restrict__ tn_s,          // (B, C, K) scratch
                                int* __restrict__ cand_s,          // (B, C) scratch
                                float* __restrict__ out_t, int* __restrict__ out_id,
                                float* __restrict__ out_u, float* __restrict__ out_v,
                                int* __restrict__ stats,           // (B, 2)
                                int C, int Sp) {
  extern __shared__ float4 smem[];
  const int K = blockDim.x;
  const int k = threadIdx.x;
  const int b = blockIdx.x;
  const int lane = k & 31;
  const int warp = k >> 5;
  const int nwarps = K >> 5;

  float4* s_rec = smem;                                      // Sp * 5 float4
  int* s_tri = reinterpret_cast<int*>(s_rec + Sp * 5);       // Sp
  float* s_bt = reinterpret_cast<float*>(s_tri + Sp);        // K
  float* s_bb = s_bt + K;                                    // kTile * 8
  float* s_wkey = s_bb + kTile * 8;                          // 32
  int* s_wcid = reinterpret_cast<int*>(s_wkey + 32);         // 32
  int* s_wj = s_wcid + 32;                                   // 32
  __shared__ unsigned s_mask;
  __shared__ int s_ncand, s_cl, s_j;
  __shared__ float s_kmin;

  const size_t ray = static_cast<size_t>(b) * K + k;
  const float4 r0 = rays[ray * 3 + 0], r1 = rays[ray * 3 + 1], r2 = rays[ray * 3 + 2];
  const float dx = r0.x, dy = r0.y, dz = r0.z;
  const float ox = r1.x, oy = r1.y, oz = r1.z;
  const float cx = r2.x, cy = r2.y, cz = r2.z;
  const float ix = __fdiv_rn(1.0f, dx), iy = __fdiv_rn(1.0f, dy), iz = __fdiv_rn(1.0f, dz);

  float* tn_b = tn_s + static_cast<size_t>(b) * C * K;
  int* cand_b = cand_s + static_cast<size_t>(b) * C;

  // ---- 1. cull, compacting the candidates ----
  if (k == 0) { s_mask = 0u; s_ncand = 0; }
  for (int c0 = 0; c0 < C; c0 += kTile) {
    const int nt = min(kTile, C - c0);
    for (int e = k; e < nt * 8; e += K) s_bb[e] = cl_bb[static_cast<size_t>(c0) * 8 + e];
    __syncthreads();
    float tv[kTile];
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      bool h = false;
      tv[i] = kBig;
      if (i < nt) {
        const float* bb = s_bb + i * 8;
        const float t1x = (bb[0] - ox) * ix, t2x = (bb[4] - ox) * ix;
        const float t1y = (bb[1] - oy) * iy, t2y = (bb[5] - oy) * iy;
        const float t1z = (bb[2] - oz) * iz, t2z = (bb[6] - oz) * iz;
        const float tnear = nmax(nmax(nmin(t1x, t2x), nmin(t1y, t2y)), nmin(t1z, t2z));
        const float tfar = nmin(nmin(nmax(t1x, t2x), nmax(t1y, t2y)), nmax(t1z, t2z));
        h = (tnear <= tfar) && (tfar >= 0.0f);
        if (h) tv[i] = tnear;
      }
      const unsigned any = __ballot_sync(0xffffffffu, h);
      if (lane == 0 && any) atomicOr(&s_mask, 1u << i);
    }
    __syncthreads();
    const unsigned mask = s_mask;
    const int base = s_ncand;
#pragma unroll
    for (int i = 0; i < kTile; ++i) {
      if (mask & (1u << i)) {
        const int pos = base + __popc(mask & ((1u << i) - 1u));
        tn_b[static_cast<size_t>(pos) * K + k] = tv[i];
        if (k == 0) cand_b[pos] = c0 + i;
      }
    }
    __syncthreads();
    if (k == 0) { s_ncand = base + __popc(mask); s_mask = 0u; }
  }
  __syncthreads();
  const int ncand = s_ncand;

  // ---- 2. best-first rounds ----
  float bt = kBig, bu = 0.0f, bv = 0.0f;
  int bid = -1;
  s_bt[k] = bt;
  int n_active = ncand, rounds = 0;
  for (;;) {
    __syncthreads();
    float wkey = kBig;
    int wcid = INT_MAX, wj = -1;
    for (int j = warp; j < n_active; j += nwarps) {
      const int cid = cand_b[j];
      if (cid < 0) continue;  // dropped: no ray of the block can still improve on it
      const float* col = tn_b + static_cast<size_t>(j) * K;
      float m = kBig;
      for (int q = lane; q < K; q += 32) {
        const float x = col[q];
        if (x < s_bt[q]) m = fminf(m, x);
      }
      for (int off = 16; off; off >>= 1) m = fminf(m, __shfl_xor_sync(0xffffffffu, m, off));
      if (!(m < kBig)) {
        if (lane == 0) cand_b[j] = -1;
        continue;
      }
      if (m < wkey || (m == wkey && cid < wcid)) { wkey = m; wcid = cid; wj = j; }
    }
    if (lane == 0) { s_wkey[warp] = wkey; s_wcid[warp] = wcid; s_wj[warp] = wj; }
    __syncthreads();
    if (k == 0) {
      float kmin = kBig;
      int cl = INT_MAX, jj = -1;
      for (int w = 0; w < nwarps; ++w) {
        if (s_wkey[w] < kmin || (s_wkey[w] == kmin && s_wcid[w] < cl)) {
          kmin = s_wkey[w]; cl = s_wcid[w]; jj = s_wj[w];
        }
      }
      s_kmin = kmin; s_cl = cl; s_j = jj;
    }
    __syncthreads();
    if (!(s_kmin < kBig)) break;
    const int cl = s_cl, j = s_j;
    ++rounds;

    // Stage the chosen cluster's record and ids.
    const float4* src = rec + static_cast<size_t>(cl) * Sp * 5;
    for (int e = k; e < Sp * 5; e += K) s_rec[e] = src[e];
    for (int e = k; e < Sp; e += K) s_tri[e] = tri[static_cast<size_t>(cl) * Sp + e];
    // Swap-remove candidate j (each thread moves its own ray's entry).
    const int last = n_active - 1;
    if (j != last) {
      tn_b[static_cast<size_t>(j) * K + k] = tn_b[static_cast<size_t>(last) * K + k];
      if (k == 0) cand_b[j] = cand_b[last];
    }
    n_active = last;
    __syncthreads();

    // Moller-Trumbore forms of every triangle of the cluster for this ray.
    float tb = bt, ub = 0.0f, vb = 0.0f;
    int sb = -1;
    for (int s = 0; s < Sp; ++s) {
      const int id = s_tri[s];
      if (id < 0) break;  // padding sits at the tail of a cluster
      const float4 a = s_rec[s * 5 + 0], p = s_rec[s * 5 + 1], q = s_rec[s * 5 + 2];
      const float4 w = s_rec[s * 5 + 3], e = s_rec[s * 5 + 4];
      // The plain version's terms in its order, each product fused into the sum.
      const float det = fmaf(dz, a.z, fmaf(dy, a.y, dx * a.x));
      const float udet =
          fmaf(cz, q.x, fmaf(cy, p.w, fmaf(cx, p.z, fmaf(dz, p.y, fmaf(dy, p.x, dx * a.w)))));
      const float vdet =
          fmaf(cz, w.z, fmaf(cy, w.y, fmaf(cx, w.x, fmaf(dz, q.w, fmaf(dy, q.z, dx * q.y)))));
      const float tdet = fmaf(oz, e.y, fmaf(oy, e.x, ox * w.w)) + e.z;
      const float inv = __fdiv_rn(1.0f, det == 0.0f ? 1.0f : det);
      const float u = udet * inv, v = vdet * inv, t = tdet * inv;
      // __fadd_rn: u + v must not be contracted into fmaf(udet, inv, v).
      const bool ok = det != 0.0f && u >= 0.0f && u <= 1.0f && v >= 0.0f && v <= 1.0f &&
                      __fadd_rn(u, v) <= 1.0f && t > 0.0f && t < tb;
      if (ok) { tb = t; sb = id; ub = u; vb = v; }
    }
    if (sb >= 0) { bt = tb; bid = sb; bu = ub; bv = vb; }
    s_bt[k] = bt;
  }

  out_t[ray] = bt;
  out_id[ray] = bid;
  out_u[ray] = bu;
  out_v[ray] = bv;
  if (k == 0) {
    stats[b * 2 + 0] = ncand;
    stats[b * 2 + 1] = rounds;
  }
}

}  // namespace

extern "C" int mcrt_traverse(const void* rays, const void* cl_bb, const void* rec, const void* tri,
                             void* tn_scratch, void* cand_scratch, void* out_t, void* out_id,
                             void* out_u, void* out_v, void* stats, int B, int K, int C, int Sp,
                             void* stream) {
  // Dynamic shared memory: the record (Sp x kRecW floats) and ids (Sp), the
  // rays' best t (K), an AABB tile and the per-warp reduction slots.
  const size_t smem = sizeof(float) * (static_cast<size_t>(Sp) * (kRecW + 1) + K + kTile * 8 + 3 * 32);
  int dev = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > static_cast<size_t>(optin)) return kErrSmem;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(traverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  traverse_kernel<<<B, K, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(rays), static_cast<const float*>(cl_bb),
      static_cast<const float4*>(rec), static_cast<const int*>(tri),
      static_cast<float*>(tn_scratch), static_cast<int*>(cand_scratch),
      static_cast<float*>(out_t), static_cast<int*>(out_id), static_cast<float*>(out_u),
      static_cast<float*>(out_v), static_cast<int*>(stats), C, Sp);
  return static_cast<int>(cudaGetLastError());
}
