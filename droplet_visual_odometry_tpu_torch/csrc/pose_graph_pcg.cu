// The pose graph's block-Jacobi preconditioned CG: every CG iteration of one
// Gauss-Newton step in one launch, in float32, summed in a fixed order.
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA ops inside
// its compiled GN step (droplet_visual_odometry_tpu/backend/pose_graph.py,
// _pcg and _hx_local). On the card the op-by-op loop (ops/cuda_pcg.py
// pcg_plain, the plain twin) issues about 36 kernels per CG iteration, so a
// GN step of 100 iterations is bound by the chain of launches, not by its
// data. Here the loop runs on one SM, or on the C <= 8 SMs of one thread
// block cluster, and every array stays in shared memory or registers from
// the first iteration to the last.
//
// What it computes, exactly as the plain twin (the reference's while loop):
//   H p = gm * sum_e (+-) B_e (pm_i - pm_j) + damping * pm,  pm = gm * p
// with gm the gauge mask (node 0 held), y_e = B_e (pm_i - pm_j) added to
// node i and subtracted from node j; M^-1 given as (M, 6, 6) blocks;
//   x = 0, r = b, z = M^-1 r, p = z, stop = tol * max(|b|^2, 1e-30)
//   while k < iters and |r|^2 > stop:
//     alpha = (r.z) / max(p.Hp, 1e-30); x += alpha p; r -= alpha Hp
//     z' = M^-1 r; beta = (r.z') / max(r.z, 1e-30); p = z' + beta p
// (the clamps keep a NaN, as torch.clamp does). `live` is the number of
// iterations run, the plain twin's count of live steps.
//
// Fixed order: each (node, component) entry of Hp sums its incident edges'
// +-y_e in ascending edge order, from incidence lists that each block
// builds once per launch for its own nodes with a stable counting sort in
// shared memory. A self-loop (i = j: refine's padding puts every filler
// edge on node 0) adds +y - y with y = B 0, which is 0 exactly or NaN where
// its B is not finite: it stays out of the lists and only its NaNs are
// kept, as a per-node mask. Every dot product is one fixed tree: shuffles
// within a warp; then each lane sums the partials of its warp number over
// the cluster's blocks in rank order, and the lanes' sums go through one
// more fixed tree, which every warp of every block evaluates alike. Two
// launches on the same inputs give the same bits.
//
// Bound on the H100: an iteration does about 90 FLOPs an edge and 160 a
// node, and a launch reads B (144 B an edge), M^-1 and b (168 B a node) and
// the edge ends once and writes x; at (M, E) = (512, 512) a step of 100
// iterations is 12.9 MFLOP and 0.18 MB, 0.19 us at the float32 rate and
// 0.05 us at HBM's. What bounds it is the chain within an iteration: four
// barriers (p shared, y shared, p.Hp, then r.z and r.r reduced) and the
// shared-memory loads and shuffles between them.
//
// Layout: C thread blocks (a cluster when C > 1) of 32 W threads, W <= 32
// warps. Lanes 0-29 of a warp hold five nodes, one (node, component) row a
// lane, so a node's six rows share a warp and z = M^-1 r is six shuffles,
// with no barrier; lanes 30 and 31 only join the shuffles and the sums.
// Nodes are dealt to the blocks in runs of S = 5 W: node n belongs to
// block (n / S) mod C, at local slot (n / SC) S + n mod S. A thread keeps
// x, r, z, p and Hp of its R node rows in registers (R = ceil(M / SC) <=
// 5); edges are dealt and walked the same way. Each block's shared memory
// holds its own edges' B (36 floats an edge) and ends, its own nodes'
// M^-1 (36 floats a node), masked p and incidence lists, its edges' y, and
// per-warp partial sums; a block reads p and y of the others through
// distributed shared memory. ops/cuda_pcg.plan chooses C and W, and its
// smem_bytes is this file's twin; C = 1 needs no cluster.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kNodesPerWarp = 5;  // five nodes of six rows: lanes 0-29
constexpr int kRowLanes = 30;
constexpr int kMaxWarps = 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxRows = 5;     // node rows a thread holds
constexpr int kMaxSmem = 232448;  // shared memory one block may take on the H100
constexpr unsigned kFull = 0xffffffffu;
constexpr float kTiny = 1e-30f;
// A node's place is (owner << 13) | local slot, an edge's (owner << 13) |
// (local slot << 1) | side: 16 bits, as a block holds fewer than 4096 edges
// and 8192 nodes within kMaxSmem.
constexpr int kOwnerShift = 13;
constexpr int kLocalMask = (1 << kOwnerShift) - 1;

__device__ __forceinline__ float clamp_tiny(float v) { return v < kTiny ? kTiny : v; }  // keeps NaN

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// A barrier over every thread that shares data: the block, or the cluster.
template <bool kCluster>
__device__ __forceinline__ void sync_all() {
  if constexpr (kCluster) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// The same shared-memory array in block `rank` of the cluster.
template <bool kCluster, typename T>
__device__ __forceinline__ T* on_rank(T* p, int rank) {
  if constexpr (kCluster) {
    return cg::this_cluster().map_shared_rank(p, static_cast<unsigned>(rank));
  } else {
    return p;
  }
}

// Sum v[i] over the cluster. Lane 0 of each warp writes its warp's sum to
// slot[i * 32 + warp]; after the barrier lane l of every warp adds up the
// slot l partials of the blocks in rank order, and every warp reduces the
// lanes by the same tree, so every thread holds the same bits.
template <int N, bool kCluster>
__device__ __forceinline__ void cluster_sum(float (&v)[N], float* slot, int warp, int lane, int nwarps, int nblocks) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_down_sync(kFull, v[i], off);
    if (lane == 0) slot[i * 32 + warp] = v[i];
  }
  sync_all<kCluster>();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = 0.0f;
    if (lane < nwarps)
      for (int k = 0; k < nblocks; ++k) s += on_rank<kCluster>(slot, k)[i * 32 + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(kFull, s, off);
    v[i] = s;
  }
}

// z = M^-1[ln] r over a node's six lanes (base .. base + 5).
__device__ __forceinline__ float apply_minv(const float* sminv, float r, int ln, int a, int base, bool valid) {
  float z = 0.0f;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    const float rc = __shfl_sync(kFull, r, base + c);
    if (valid) z += sminv[(ln * 6 + a) * 6 + c] * rc;
  }
  return z;
}

template <int R, bool kCluster>
__global__ void __launch_bounds__(kMaxWarps * 32)
pcg_kernel(const float* __restrict__ B, const int64_t* __restrict__ edge_i, const int64_t* __restrict__ edge_j,
           const float* __restrict__ b, const float* __restrict__ minv, float* __restrict__ x_out,
           int32_t* __restrict__ live_out, int m, int e_count, int mb, int eb, float damping, int iters, float tol) {
  extern __shared__ float smem[];
  float* sB = smem;                    // eb * 36
  float* sminv = sB + eb * 36;         // mb * 36
  float* sp = sminv + mb * 36;         // mb * 6: gm * p
  float* sy = sp + mb * 6;             // eb * 6
  float* sred = sy + eb * 6;           // 3 x 32: p.Hp, then (r.z, r.r)
  int* soff = reinterpret_cast<int*>(sred + 96);  // mb + 1: incidence offsets
  int* scur = soff + mb + 1;           // mb: degree, then fill cursor
  int* spoison = scur + mb;            // mb: bit a set when a self-loop's B row a is not finite
  int* sbad = spoison + mb;            // 1
  uint16_t* sei = reinterpret_cast<uint16_t*>(sbad + 1);  // eb: the place of each own edge's node i
  uint16_t* sej = sei + eb;            // eb: ... and of its node j
  uint16_t* sinc = sej + eb;           // 2 e_count at most: the places of the own nodes' edges

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthreads >> 5;
  const int nblocks = kCluster ? static_cast<int>(cg::this_cluster().num_blocks()) : 1;
  const int rank = kCluster ? static_cast<int>(cg::this_cluster().block_rank()) : 0;
  const int a = lane % 6;
  const int base = lane - a;
  const bool row_lane = lane < kRowLanes;
  const int S = kNodesPerWarp * nwarps;  // nodes (edges) a block takes per pass
  const int SC = S * nblocks;            // ... and the cluster
  const int slot = warp * kNodesPerWarp + lane / 6;
  const auto owner = [=](int n) { return (n / S) % nblocks; };
  const auto local = [=](int n) { return (n / SC) * S + n % S; };
  const auto global = [=](int l) { return (l / S) * SC + rank * S + l % S; };

  // ---- Stage the own edges' B and ends and the own nodes' M^-1; count the own nodes' degrees.
  if (tid == 0) *sbad = 0;
  for (int q = tid; q < mb; q += nthreads) scur[q] = spoison[q] = 0;
  for (int q = tid; q < eb * 36; q += nthreads) {
    const int e = global(q / 36);
    sB[q] = e < e_count ? B[static_cast<size_t>(e) * 36 + q % 36] : 0.0f;
  }
  for (int q = tid; q < mb * 36; q += nthreads) {
    const int n = global(q / 36);
    sminv[q] = n < m ? minv[static_cast<size_t>(n) * 36 + q % 36] : 0.0f;
  }
  for (int q = tid; q < eb; q += nthreads) {
    const int e = global(q);
    int pi = 0, pj = 0;
    if (e < e_count) {
      const int64_t i = edge_i[e], j = edge_j[e];
      if (i >= 0 && i < m && j >= 0 && j < m) {
        pi = (owner(static_cast<int>(i)) << kOwnerShift) | local(static_cast<int>(i));
        pj = (owner(static_cast<int>(j)) << kOwnerShift) | local(static_cast<int>(j));
      }
    }
    sei[q] = static_cast<uint16_t>(pi);
    sej[q] = static_cast<uint16_t>(pj);
  }
  __syncthreads();
  for (int q = tid; q < e_count; q += nthreads) {
    const int64_t i = edge_i[q], j = edge_j[q];
    if (i < 0 || i >= m || j < 0 || j >= m) {
      *sbad = 1;  // every block reads every edge, so all of them see it
      continue;
    }
    if (i != j) {
      if (owner(static_cast<int>(i)) == rank) atomicAdd(&scur[local(static_cast<int>(i))], 1);  // exact counts
      if (owner(static_cast<int>(j)) == rank) atomicAdd(&scur[local(static_cast<int>(j))], 1);
    } else if (owner(static_cast<int>(i)) == rank) {
      // A self-loop's y = B (pm_i - pm_i) = B 0 adds +y - y: 0 exactly, or NaN in a row of B that
      // is not finite. So it leaves the lists and leaves its NaNs here.
      int rows = 0;
      for (int c = 0; c < 36; ++c)
        if (!isfinite(B[static_cast<size_t>(q) * 36 + c])) rows |= 1 << (c / 6);
      if (rows) atomicOr(&spoison[local(static_cast<int>(i))], rows);
    }
  }
  __syncthreads();

  // ---- Incidence lists of the own nodes (warp 0): exclusive scan of the
  // degrees, then a stable fill in edge order, so each node's entries ascend by edge.
  if (warp == 0) {
    int carry = 0;
    for (int c0 = 0; c0 < mb; c0 += 32) {
      const int q = c0 + lane;
      const int d = q < mb ? scur[q] : 0;
      int incl = d;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int t = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += t;
      }
      if (q < mb) soff[q] = scur[q] = carry + incl - d;
      carry += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) soff[mb] = carry;
    __syncwarp();
    const unsigned lt = (1u << lane) - 1u;
    for (int c0 = 0; c0 < 2 * e_count; c0 += 32) {
      const int q = c0 + lane;
      int key = -1 - lane;
      int code = 0;
      if (q < 2 * e_count) {
        const int e = q >> 1;
        const int64_t i = edge_i[e], j = edge_j[e];
        if (i >= 0 && i < m && j >= 0 && j < m && i != j) {
          const int n = static_cast<int>((q & 1) ? j : i);
          if (owner(n) == rank) {
            key = local(n);
            code = (owner(e) << kOwnerShift) | (local(e) << 1) | (q & 1);
          }
        }
      }
      const bool on = key >= 0;
      const unsigned peers = __match_any_sync(kFull, key);
      const int pos = on ? scur[key] + __popc(peers & lt) : 0;
      __syncwarp();
      if (on) {
        sinc[pos] = static_cast<uint16_t>(code);
        if ((peers & lt) == 0) scur[key] += __popc(peers);
      }
      __syncwarp();
    }
  }

  // ---- x = 0, r = b, z = M^-1 r, p = z; |b|^2 and r.z.
  float x[R], r[R], z[R], p[R], hp[R];
  float sums[2] = {0.0f, 0.0f};
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int n = k * SC + rank * S + slot;
    const int ln = k * S + slot;
    const bool valid = row_lane && n < m;
    x[k] = 0.0f;
    r[k] = valid ? b[n * 6 + a] : 0.0f;
    z[k] = apply_minv(sminv, r[k], ln, a, base, valid);
    p[k] = z[k];
    if (valid) sp[ln * 6 + a] = p[k] * (n >= 1 ? 1.0f : 0.0f);
    sums[0] += r[k] * r[k];
    sums[1] += r[k] * z[k];
  }
  cluster_sum<2, kCluster>(sums, sred + 32, warp, lane, nwarps, nblocks);  // its barrier also publishes sp and the lists
  const float stop = tol * clamp_tiny(sums[0]);
  float rr = sums[0], rz = sums[1];

  int live = 0;
  if (*sbad == 0) {
    const int edge_passes = (e_count + SC - 1) / SC;
    for (int it = 0; it < iters && rr > stop; ++it) {
      ++live;
      // y_e = B_e (pm_i - pm_j), one (edge, component) row a lane.
      for (int ke = 0; ke < edge_passes; ++ke) {
        const int le = ke * S + slot;
        const bool valid = row_lane && ke * SC + rank * S + slot < e_count;
        float d = 0.0f;
        if (valid) {
          const int pi = sei[le], pj = sej[le];
          d = on_rank<kCluster>(sp, pi >> kOwnerShift)[(pi & kLocalMask) * 6 + a] -
              on_rank<kCluster>(sp, pj >> kOwnerShift)[(pj & kLocalMask) * 6 + a];
        }
        float y = 0.0f;
#pragma unroll
        for (int c = 0; c < 6; ++c) {
          const float dc = __shfl_sync(kFull, d, base + c);
          if (valid) y += sB[(le * 6 + a) * 6 + c] * dc;
        }
        if (valid) sy[le * 6 + a] = y;
      }
      sync_all<kCluster>();
      // Hp = gm * (incident +-y, ascending edges) + damping * pm; p.Hp.
      float php[1] = {0.0f};
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int n = k * SC + rank * S + slot;
        const int ln = k * S + slot;
        const bool valid = row_lane && n < m;
        float acc = 0.0f;
        if (valid) {
          for (int q = soff[ln]; q < soff[ln + 1]; ++q) {
            const int code = sinc[q];
            const float v = on_rank<kCluster>(sy, code >> kOwnerShift)[((code & kLocalMask) >> 1) * 6 + a];
            acc = (code & 1) ? acc - v : acc + v;
          }
          if ((spoison[ln] >> a) & 1) acc = __int_as_float(0x7fc00000);
        }
        const float gm = n >= 1 ? 1.0f : 0.0f;
        hp[k] = valid ? acc * gm + damping * (p[k] * gm) : 0.0f;
        php[0] += p[k] * hp[k];
      }
      cluster_sum<1, kCluster>(php, sred, warp, lane, nwarps, nblocks);
      const float alpha = rz / clamp_tiny(php[0]);
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int n = k * SC + rank * S + slot;
        const bool valid = row_lane && n < m;
        x[k] = x[k] + alpha * p[k];
        r[k] = r[k] - alpha * hp[k];
        z[k] = apply_minv(sminv, r[k], k * S + slot, a, base, valid);
        rs[0] += r[k] * z[k];
        rs[1] += r[k] * r[k];
      }
      cluster_sum<2, kCluster>(rs, sred + 32, warp, lane, nwarps, nblocks);
      const float beta = rs[0] / clamp_tiny(rz);
      rz = rs[0];
      rr = rs[1];
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int n = k * SC + rank * S + slot;
        p[k] = z[k] + beta * p[k];
        if (row_lane && n < m) sp[(k * S + slot) * 6 + a] = p[k] * (n >= 1 ? 1.0f : 0.0f);
      }
      sync_all<kCluster>();
    }
  }

  const bool bad = *sbad != 0;
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int n = k * SC + rank * S + slot;
    if (row_lane && n < m) x_out[n * 6 + a] = bad ? __int_as_float(0x7fc00000) : x[k];
  }
  if (tid == 0 && rank == 0) *live_out = live;
  if constexpr (kCluster) sync_all<true>();  // no block leaves while another may still read its shared memory
}

// Shared memory one block takes (bytes) for its mb node slots and eb edge
// slots of a graph of e edges; ops/cuda_pcg.smem_bytes is its twin.
size_t smem_bytes(int mb, int eb, int e_count) {
  return 4u * (42u * eb + 42u * mb + 96u) + 4u * (3u * mb + 2u) + 2u * (2u * eb + 2u * e_count);
}

template <int R, bool kCluster>
int launch(const float* B, const int64_t* ei, const int64_t* ej, const float* b, const float* minv, float* x,
           int32_t* live, int m, int e_count, int mb, int eb, float damping, int iters, float tol, int clusters,
           int warps, size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(pcg_kernel<R, kCluster>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters);
  cfg.blockDim = dim3(warps * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = kCluster ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, pcg_kernel<R, kCluster>, B, ei, ej, b, minv, x, live, m, e_count, mb, eb, damping,
                           iters, tol);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <bool kCluster>
int launch_rows(int r, const float* B, const int64_t* ei, const int64_t* ej, const float* b, const float* minv,
                float* x, int32_t* live, int m, int e_count, int mb, int eb, float damping, int iters, float tol,
                int clusters, int warps, size_t smem, cudaStream_t s) {
  switch (r) {
    case 1: return launch<1, kCluster>(B, ei, ej, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, clusters, warps, smem, s);
    case 2: return launch<2, kCluster>(B, ei, ej, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, clusters, warps, smem, s);
    case 3: return launch<3, kCluster>(B, ei, ej, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, clusters, warps, smem, s);
    case 4: return launch<4, kCluster>(B, ei, ej, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, clusters, warps, smem, s);
    case 5: return launch<5, kCluster>(B, ei, ej, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, clusters, warps, smem, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// B: (e, 6, 6) float32; edge_i, edge_j: (e,) int64 in [0, m); b: (m, 6);
// minv: (m, 6, 6); x: (m, 6) out; live: () int32 out. 1 <= m, e >= 0; on
// `clusters` blocks (one cluster) of `warps` warps, as ops/cuda_pcg.plan
// chooses them: each thread holds at most five node rows and each block's
// shared memory stays within the card's limit, else the call returns
// cudaErrorInvalidValue. An edge end outside [0, m) makes x NaN and live 0.
extern "C" int dvo_pose_graph_pcg(const float* B, const int64_t* edge_i, const int64_t* edge_j, const float* b,
                                  const float* minv, float* x, int32_t* live, int m, int e_count, float damping,
                                  int iters, float tol, int clusters, int warps, void* stream) {
  if (m <= 0) return 0;
  if (e_count < 0 || clusters < 1 || clusters > kMaxCluster || warps < 1 || warps > kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  const int S = kNodesPerWarp * warps;
  const int SC = S * clusters;
  const int r = (m + SC - 1) / SC;
  const int eb = e_count < (e_count + SC - 1) / SC * S ? e_count : (e_count + SC - 1) / SC * S;
  const int mb = m < r * S ? m : r * S;
  const size_t smem = smem_bytes(mb, eb, e_count);
  if (r > kMaxRows || smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (clusters == 1)
    return launch_rows<false>(r, B, edge_i, edge_j, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, 1,
                              warps, smem, s);
  return launch_rows<true>(r, B, edge_i, edge_j, b, minv, x, live, m, e_count, mb, eb, damping, iters, tol, clusters,
                           warps, smem, s);
}
