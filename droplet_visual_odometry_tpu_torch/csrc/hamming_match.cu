// Hamming-distance match reductions between packed 256-bit descriptor sets,
// batched over frame pairs, on the tensor cores, in one launch.
//
// Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_match.py
// (match_reductions, pallas_call at :105) and computes what it computes, for
// each of P pairs of (K, 8) uint32 descriptor sets with validity masks:
//   d1[r]       best distance of row r        (reported 1e9 if invalid)
//   i1[r]       its column, lowest on ties
//   d2[r]       best distance over the other columns (Lowe ratio test)
//   col_best[c] best row of column c, lowest on ties (mutual cross-check)
// An entry whose row or column is invalid counts as distance 512, above
// every real distance (<= 256), exactly as in the TPU kernel. K <= 4096.
//
// Bound on the H100: hamming(a, b) = popc(a) + popc(b) - 2 * popc(a & b), and
// popc(a & b) over 256 bits is one row of a bit product: P*K*K*256
// multiply-adds, 2*P*K*K*256 = 3.09 G operations at P = 23, K = 512. At the
// int8 tensor-core rate (1,979 TOP/s; the data sheet gives no binary rate)
// that is 0.0016 ms. The bytes (both sets, the masks, four (P, K) outputs,
// 0.97 MB) take 0.0003 ms. No K x K matrix reaches device memory.
//
// Design (chosen by measurement on the H100 over an int8 form of the same
// kernel, mma.sync.m16n8k32 s8 x u8 on bits expanded to +-1 and 0/1 bytes,
// which was slower at every shape timed and the more so as K grew; .xor.popc
// was slower than .and.popc):
// - mma.sync.m16n8k256 b1 .and.popc takes the packed words as they are: a
//   lane's A fragment is words t and 4 + t of its rows, its B fragment the
//   same words of its column. No expansion, 4 registers per 16 rows.
// - Grid (C, P): the C <= 8 CTAs of a pair form one thread block cluster;
//   CTA rank q takes the 64-row tiles q, q + C, ... of A. Eight warps a CTA;
//   warp w holds all 64 rows of the tile (four m16 tiles) and sweeps the
//   8-column n-tiles w, w + 8, ... of B.
// - B's packed words for the whole pair (32 B a column) are staged once per
//   CTA with cp.async (16 B chunks, the two halves of a column swapped for
//   column bit 2, so a warp's 32 word loads hit 32 banks); A's first tile is
//   loaded while that copy is in flight.
// - The row and column terms leave the per-entry work. Within a row, h'
//   orders as cterm - 2 * popc(a & b) with cterm = popc(b) + 257 * [column
//   invalid]; within a column, as rterm - 2 * popc(a & b) with rterm =
//   popc(a) + 257 * [row invalid]. So the row key of an entry is one IMAD,
//   (cterm + 256 - 2 * acc) * 4096 + col, from a per-column constant kept in
//   shared memory, and its 16-bit column key one IMAD, (rterm + 256 -
//   2 * acc) * 64 + local row, from a per-row constant in registers. The
//   other term is added back once per row or column at the end, giving h'
//   = hamming for a valid entry (<= 256) and h' >= 257 for an invalid one.
// - Epilogue in registers: a row keeps (best key, second key); column keys,
//   two columns to a word, are reduced with __vminu2 over the warp's 64 rows
//   (eight in the lane, then three shuffles).
// - One launch and no scratch: each CTA merges its row partials (8 warps)
//   in shared memory and writes d1, i1, d2; its column minima become
//   (key >> 6 << 12) | row and go by atomicMin into the distributed shared
//   memory of the cluster rank that owns the column slice; after one
//   cluster barrier each rank writes its slice of col_best.
//
// The merge is exact. Every reduction is a min over keys that hold the
// distance (up to a constant of the line) above the index, so it is
// commutative and associative: any order of lanes, warps, tiles and ranks
// gives the same key, and the index breaks ties to the lowest, as the TPU
// kernel's dist * 4096 + index does. Two row partials (b1, s1) and (b2, s2)
// over disjoint column sets merge to (min(b1, b2), min(s1, s2, max(b1, b2))):
// the new second best is the best of what each side had besides its winner
// and the losing winner. A final h' > 256 means the row (column) has no
// valid entry: the plain twin's argmin over an all-512 line is index 0, and
// its distances are reported as BIG. tests/test_torch_matcher.py holds this
// algebra against the plain twin.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTileRows = 64;   // rows of A per CTA tile, all held by every warp
constexpr int kWarps = 8;       // each sweeps every eighth n-tile
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kInvalidBias = 257;
constexpr int kOff = 256;       // keeps term - 2 * popc(a & b) non-negative
constexpr int kMaxReal = 256;
constexpr float kBig = 1e9f;

// d = popc(a & b) over the 16 x 8 tile of 256-bit rows and columns.
__device__ __forceinline__ void mma_and_popc(int (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%10,%10,%10,%10};\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "r"(0));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cluster_arrive() { asm volatile("barrier.cluster.arrive.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void cluster_wait() { asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory"); }

// (best, second) of a row over one column set, merged with another set's.
__device__ __forceinline__ void row_merge(uint32_t& best, uint32_t& second, uint32_t ob, uint32_t os) {
  second = min(min(second, os), max(best, ob));
  best = min(best, ob);
}

// A fragments of rows row0 + mt*16 + hf*8 + g (words t and 4 + t), and each
// row's 16-bit column-key constant (rterm + kOff) * 64 + local row.
__device__ __forceinline__ void load_rows(const uint32_t* __restrict__ a, const uint8_t* __restrict__ va,
                                          size_t base, int k, int row0, int g, int t,
                                          uint32_t (&afr)[4][4], uint32_t (&rk16)[4][2]) {
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int lr = mt * 16 + hf * 8 + g;
      const int r = row0 + lr;
      uint32_t w0 = 0u, w1 = 0u;
      bool valid = false;
      if (r < k) {
        w0 = a[(base + r) * 8 + t];
        w1 = a[(base + r) * 8 + 4 + t];
        valid = va[base + r] != 0;
      }
      afr[mt][hf] = w0;
      afr[mt][2 + hf] = w1;
      int pa = __popc(w0) + __popc(w1);  // summed over the four lanes of the group
      pa += __shfl_xor_sync(0xFFFFFFFFu, pa, 1);
      pa += __shfl_xor_sync(0xFFFFFFFFu, pa, 2);
      rk16[mt][hf] = static_cast<uint32_t>((pa + (valid ? 0 : kInvalidBias) + kOff) * 64 + lr);
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
match_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
             const uint8_t* __restrict__ va, const uint8_t* __restrict__ vb,
             float* __restrict__ d1, int32_t* __restrict__ i1, float* __restrict__ d2,
             int32_t* __restrict__ col_best, int k) {
  extern __shared__ uint4 smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int nclu = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int p = blockIdx.y;
  const int ntiles = (k + 7) >> 3;  // n-tiles of 8 columns
  const int kpad = ntiles * 8;
  const int half = kpad / 2;
  const int slice = (k + nclu - 1) / nclu;  // columns whose col_best this rank owns
  const size_t base = static_cast<size_t>(p) * k;

  uint4* sb = smem;                                              // kpad * 2: packed B, swizzled
  uint32_t* ckey = reinterpret_cast<uint32_t*>(sb + kpad * 2);   // kpad: (cterm + kOff) * 4096 + col
  uint32_t* ckey16 = ckey + kpad;                                // half: packed column keys
  uint2* rowpart = reinterpret_cast<uint2*>(ckey16 + half);      // 8 x 64: (best, second)
  uint32_t* rowterm = reinterpret_cast<uint32_t*>(rowpart + kWarps * kTileRows);  // 64: rterm
  uint32_t* colmin = rowterm + kTileRows;                        // slice

  for (int i = tid; i < slice; i += kThreads) colmin[i] = 0xFFFFFFFFu;
  cluster_arrive();  // released: every rank's colmin is set before anyone pushes

  const uint4* bsrc = reinterpret_cast<const uint4*>(b + base * 8);
  for (int i = tid; i < kpad * 2; i += kThreads) {
    const int c = i >> 1;
    const bool in = c < k;
    cp_async16(&sb[c * 2 + ((i & 1) ^ ((c >> 2) & 1))], in ? bsrc + i : bsrc, in ? 16 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  for (int c = tid; c < kpad; c += kThreads) ckey[c] = (c < k && vb[base + c]) ? 0u : kInvalidBias;

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int step = nclu * kTileRows;
  uint32_t afr[4][4], rk16[4][2];
  load_rows(a, va, base, k, rank * kTileRows, g, t, afr, rk16);  // in flight with B's copy

  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  for (int c = tid; c < kpad; c += kThreads) {
    const uint4 x = sb[c * 2], y = sb[c * 2 + 1];
    const int pb = __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w) +
                   __popc(y.x) + __popc(y.y) + __popc(y.z) + __popc(y.w);
    ckey[c] = static_cast<uint32_t>((pb + static_cast<int>(ckey[c]) + kOff) * 4096 + c);
  }
  __syncthreads();
  cluster_wait();

  const uint32_t* sbw = reinterpret_cast<const uint32_t*>(sb);
  for (int row0 = rank * kTileRows; row0 < k; row0 += step) {
    uint32_t best[4][2], second[4][2];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) best[mt][hf] = second[mt][hf] = 0xFFFFFFFFu;

    for (int j = warp; j < ntiles; j += kWarps) {
      const int c = j * 8 + g;  // this lane's B column; (c >> 2) & 1 == g >> 2
      const int sw = g >> 2;
      const uint32_t bw0 = sbw[(c * 2 + sw) * 4 + t], bw1 = sbw[(c * 2 + (sw ^ 1)) * 4 + t];
      const int cc = j * 8 + 2 * t;  // this lane's two accumulator columns
      const uint2 ck = *reinterpret_cast<const uint2*>(&ckey[cc]);
      uint32_t colk = 0xFFFFFFFFu;
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        int acc[4];
        mma_and_popc(acc, afr[mt], bw0, bw1);
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int e0 = acc[2 * hf], e1 = acc[2 * hf + 1];
          row_merge(best[mt][hf], second[mt][hf], ck.x - static_cast<uint32_t>(e0 * 8192), 0xFFFFFFFFu);
          row_merge(best[mt][hf], second[mt][hf], ck.y - static_cast<uint32_t>(e1 * 8192), 0xFFFFFFFFu);
          colk = __vminu2(colk, __byte_perm(rk16[mt][hf] - static_cast<uint32_t>(e0 * 128),
                                            rk16[mt][hf] - static_cast<uint32_t>(e1 * 128), 0x5410));
        }
      }
      colk = __vminu2(colk, __shfl_xor_sync(0xFFFFFFFFu, colk, 4));
      colk = __vminu2(colk, __shfl_xor_sync(0xFFFFFFFFu, colk, 8));
      colk = __vminu2(colk, __shfl_xor_sync(0xFFFFFFFFu, colk, 16));
      if (g == 0) ckey16[j * 4 + t] = colk;
    }

    // Rows: merge the four lanes of a group, then the eight warps.
#pragma unroll
    for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
#pragma unroll
        for (int m = 1; m <= 2; m <<= 1) {
          const uint32_t ob = __shfl_xor_sync(0xFFFFFFFFu, best[mt][hf], m);
          const uint32_t os = __shfl_xor_sync(0xFFFFFFFFu, second[mt][hf], m);
          row_merge(best[mt][hf], second[mt][hf], ob, os);
        }
        const int lr = mt * 16 + hf * 8 + g;
        if (t == 0) rowpart[warp * kTileRows + lr] = make_uint2(best[mt][hf], second[mt][hf]);
        if (t == 0 && warp == 0) rowterm[lr] = (rk16[mt][hf] >> 6) - kOff;
      }
    }
    __syncthreads();

    if (tid < kTileRows && row0 + tid < k) {
      uint2 r = rowpart[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const uint2 o = rowpart[w * kTileRows + tid];
        row_merge(r.x, r.y, o.x, o.y);
      }
      const size_t out = base + row0 + tid;
      const int h1 = static_cast<int>(r.x >> 12) - kOff + static_cast<int>(rowterm[tid]);
      const int h2 = static_cast<int>(r.y >> 12) - kOff + static_cast<int>(rowterm[tid]);
      d1[out] = h1 <= kMaxReal ? static_cast<float>(h1) : kBig;
      i1[out] = h1 <= kMaxReal ? static_cast<int32_t>(r.x & 0xFFFu) : 0;
      d2[out] = h2 <= kMaxReal ? static_cast<float>(h2) : kBig;
    }
    // Columns: widen to ((rterm + kOff - 2 * acc) << 12) | row, push to the owner rank.
    for (int q = tid; q < half; q += kThreads) {
      const uint32_t m = ckey16[q];
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {
        const int c = 2 * q + hc;
        if (c < k) {
          const uint32_t k16 = hc ? (m >> 16) : (m & 0xFFFFu);
          const uint32_t key = ((k16 >> 6) << 12) | static_cast<uint32_t>(row0 + (k16 & 63u));
          const int owner = c / slice;
          atomicMin(cluster.map_shared_rank(colmin, owner) + (c - owner * slice), key);
        }
      }
    }
    if (row0 + step < k) load_rows(a, va, base, k, row0 + step, g, t, afr, rk16);
    __syncthreads();  // ckey16, rowpart and rowterm are refilled by the next tile
  }

  cluster_arrive();  // every push has landed once all ranks pass the wait
  cluster_wait();
  const int c0 = rank * slice;
  for (int i = tid; i < slice && c0 + i < k; i += kThreads) {
    const uint32_t v = colmin[i];
    const int h = static_cast<int>(v >> 12) - kOff + static_cast<int>(ckey[c0 + i] >> 12) - kOff;
    col_best[base + c0 + i] = h <= kMaxReal ? static_cast<int32_t>(v & 0xFFFu) : 0;
  }
}

}  // namespace

// a, b: (p, k, 8) uint32, 16-byte aligned; va, vb: (p, k) bool (one byte
// each); d1, d2: (p, k) float32; i1, col_best: (p, k) int32. 1 <= k <= 4096.
extern "C" int dvo_match_reductions(const uint32_t* a, const uint32_t* b, const uint8_t* va,
                                    const uint8_t* vb, float* d1, int32_t* i1, float* d2,
                                    int32_t* col_best, int p, int k, void* stream) {
  if (p <= 0 || k <= 0) return 0;
  const int row_tiles = (k + kTileRows - 1) / kTileRows;
  const int nclu = row_tiles < kMaxCluster ? row_tiles : kMaxCluster;
  const int kpad = (k + 7) / 8 * 8;
  const int slice = (k + nclu - 1) / nclu;
  // B, ckey, ckey16, rowpart, rowterm, colmin (kpad is a multiple of 8, so each part stays 8-byte aligned)
  const size_t smem = 32u * kpad + 4u * kpad + 2u * kpad + 8u * kWarps * kTileRows + 4u * kTileRows + 4u * slice;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nclu;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nclu, p);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, match_kernel, a, b, va, vb, d1, i1, d2, col_best, k);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
