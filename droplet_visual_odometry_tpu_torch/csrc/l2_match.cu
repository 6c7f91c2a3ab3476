// Squared-L2 match reductions between float descriptor sets (SIFT's 128-d,
// SURF's 64-d), batched over frame pairs, on the CUDA cores in float32.
//
// Replaces no TPU kernel: the JAX package matches float sets outside any
// Pallas kernel (frontend/matcher.py: l2_matrix, then a sort or argmins over
// the whole (P, K, K) matrix). At K = 8192 that matrix and its sorted copy
// take 1.3-1.6 GB a pair, so the float match could not run at a deployment's
// feature budget. This kernel computes what the matrix form reduces to, for
// each of P pairs of (K, D) float32 sets with validity masks:
//   d1[r]       least distance of row r
//   i1[r]       its column, lowest on ties
//   d2[r]       least distance over the other columns (Lowe's ratio test)
//   col_best[c] best row of column c, lowest on ties (mutual cross-check)
// with the distance of an entry |a|^2 + |b|^2 - 2 a.b in float32, clamped at
// 0, and 1e9 where its row or column is invalid, as the matrix form has it.
// No K x K matrix reaches device memory: the outputs are O(P K).
//
// Bound on the H100: P*K*K*D multiply-adds, 2*P*K*K*D operations at the
// float32 rate outside the tensor cores (67 TFLOP/s; TF32 would round the
// operands to 10 bits, which the configurations do not allow). At P = 143,
// K = 8192, D = 128 that is 2.46 TFLOP, 36.7 ms; the bytes (both sets, the
// masks, the four outputs) take 0.36 ms. So the design is a float32 GEMM's:
// - Grid (row tiles, P): a CTA owns 128 rows of A and walks every
//   128-column tile of B. Both are held in shared memory transposed
//   ([depth][line]), so a thread reads its four lines of one depth as one
//   float4. The next column tile is copied by cp.async into a row-major
//   staging tile while the current one is multiplied, then transposed.
// - 256 threads as 16 x 16; thread (tx, ty) keeps the 8 x 8 products of rows
//   4 ty + {0..3}, 64 + 4 ty + {0..3} and the same columns of tx in
//   registers, one outer product a depth from four float4 loads (A's are
//   broadcasts within a half warp, B's fall on distinct banks). Each
//   product is a chain of FMAs in order of depth.
// - The row and column norms are summed once per tile, as the tile lands,
//   in a fixed order: four squares a 16-byte chunk, then a pairwise tree
//   over the line's chunks in index order.
// - Epilogue in registers: d = max(fma(-2, a.b, |a|^2 + |b|^2), 0), which is
//   the matrix form's (|a|^2 + |b|^2) - 2 a.b rounded once, since 2 a.b is
//   exact. A row keeps (best, its column, second) over the columns in the
//   order it meets them; a column the least (distance, row) over the
//   thread's rows, merged with its partner row group by a shuffle and over
//   the CTA's eight warps in shared memory, then by atomicMin into a packed
//   64-bit key, (distance bits << 32) | row, per column of the pair.
//   Distances are >= 0, so their bits order as their values, and the key's
//   low half breaks ties to the lowest row whatever order the CTAs run in.
// - The last CTA of a pair to finish (a counter per pair) writes col_best
//   from the keys. The keys and counters are the caller's scratch, set to
//   all ones by a memset on the stream before the launch.
// The layout was chosen by measurement on the H100 (700 W), 143 pairs of
// 8192: 71.6 ms at D = 128 (51% of the bound) and 38.8 ms at D = 64, against
// 80.4 and 45.7 ms, with the same bits, for tiles kept row-major and read as
// float4 along the depth (255 registers against 161); the depth loop
// unrolled 16 deep beat 2, 4 and 8.
//
// Entries outside the K x K matrix (the ragged last tile) count as +inf, so
// they never win; an invalid entry counts as 1e9, as in the matrix form,
// so a row or column with no valid entry gives d1 = d2 = 1e9 at index 0.
// The result depends on no order of scheduling: two launches give the same
// bits. Against the plain twin (l2_matrix through cuBLAS or the CPU's BLAS)
// distances differ by the order of the D-term sums only.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 128;      // rows of A and columns of B in a tile
constexpr int kThreads = 256;   // 16 x 16 threads, each 8 rows x 8 columns
constexpr int kWarps = kThreads / 32;
constexpr float kBig = 1e9f;    // an invalid entry's distance
constexpr float kValid = -1.f;  // a line's fill when it is valid (below every fill)

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

__device__ __forceinline__ unsigned long long col_key(float d, int row) {
  return (static_cast<unsigned long long>(__float_as_uint(d) & 0x7FFFFFFFu) << 32) | static_cast<unsigned>(row);
}

// Thread tid copies line tid % 128's 16-byte chunks h * C/2 + q (h = tid / 128,
// q = 0 .. C/2 - 1) of lines g0 .. g0 + 127 into the row-major staging tile;
// lines past k are zero-filled.
template <int D>
__device__ __forceinline__ void load_stage(float* stage, const float* __restrict__ src, int g0, int k, int tid) {
  constexpr int kHalf = D / 8, kStride = D + 4;
  const int r = tid & (kTile - 1), h = tid >> 7;
  const bool in = g0 + r < k;
  const float* row = src + static_cast<size_t>(in ? g0 + r : 0) * D;
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const int ch = h * kHalf + q;
    cp_async16(stage + r * kStride + ch * 4, row + ch * 4, in ? 16 : 0);
  }
}

// After the copy has landed: each line's squared norm (four squares a chunk,
// then a pairwise tree over the chunks in index order, the lower half's sum
// first), its fill (-1 valid, 1e9 invalid, +inf past k), and the tile
// transposed into dst[d * kTile + line]. `part` holds the upper half's
// partial sums between the two barriers.
template <int D>
__device__ __forceinline__ void land_tile(const float* stage, float* dst, const uint8_t* __restrict__ valid, int g0,
                                          int k, int tid, float* norm, float* fill, float* part) {
  constexpr int kHalf = D / 8, kStride = D + 4;
  const int r = tid & (kTile - 1), h = tid >> 7;
  float s[kHalf];
#pragma unroll
  for (int q = 0; q < kHalf; ++q) {
    const int ch = h * kHalf + q;
    const float4 v = *reinterpret_cast<const float4*>(stage + r * kStride + ch * 4);
    float t = v.x * v.x;
    t = fmaf(v.y, v.y, t);
    t = fmaf(v.z, v.z, t);
    s[q] = fmaf(v.w, v.w, t);
    dst[(ch * 4 + 0) * kTile + r] = v.x;
    dst[(ch * 4 + 1) * kTile + r] = v.y;
    dst[(ch * 4 + 2) * kTile + r] = v.z;
    dst[(ch * 4 + 3) * kTile + r] = v.w;
  }
#pragma unroll
  for (int m = 1; m < kHalf; m <<= 1)
#pragma unroll
    for (int q = 0; q < kHalf; q += 2 * m) s[q] = s[q] + s[q + m];
  if (h == 1) part[r] = s[0];
  __syncthreads();
  if (h == 0) {
    norm[r] = s[0] + part[r];
    fill[r] = g0 + r < k ? (valid[g0 + r] ? kValid : kBig) : CUDART_INF_F;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
l2_match_kernel(const float* __restrict__ a, const float* __restrict__ b, const uint8_t* __restrict__ va,
                const uint8_t* __restrict__ vb, float* __restrict__ d1, int32_t* __restrict__ i1,
                float* __restrict__ d2, int32_t* __restrict__ col_best, unsigned long long* __restrict__ colkey,
                unsigned int* __restrict__ done, int k) {
  extern __shared__ __align__(16) float smem[];
  float* At = smem;                              // the CTA's rows, transposed: [d][row]
  float* Bt = At + D * kTile;                    // the current column tile, transposed: [d][column]
  float* stage = Bt + D * kTile;                 // the next tile as copied: [line][d], rows D + 4 apart
  float* na = stage + kTile * (D + 4);           // the rows' norms and fills
  float* rf = na + kTile;
  float* nb = rf + kTile;                        // the current tile's column norms and fills
  float* cf = nb + kTile;
  float* part = cf + kTile;                      // upper-half norm partials
  unsigned long long* colpart = reinterpret_cast<unsigned long long*>(part + kTile);  // per warp, per column
  __shared__ int last;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kTile;
  const int ntiles = (k + kTile - 1) / kTile;
  const size_t base = static_cast<size_t>(p) * k;
  const float* pb = b + base * D;

  load_stage<D>(stage, a + base * D, row0, k, tid);
  cp_async_commit();
  cp_async_wait_all();
  land_tile<D>(stage, At, va + base, row0, k, tid, na, rf, part);
  __syncthreads();
  load_stage<D>(stage, pb, 0, k, tid);
  cp_async_commit();
  cp_async_wait_all();
  land_tile<D>(stage, Bt, vb + base, 0, k, tid, nb, cf, part);
  __syncthreads();
  if (ntiles > 1) {
    load_stage<D>(stage, pb, kTile, k, tid);
    cp_async_commit();
  }

  // Thread rows ty*4 + {0..3} and 64 + ty*4 + {0..3}, columns tx*4 + {0..3} and 64 + tx*4 + {0..3}.
  float nai[8], rfi[8], best[8], second[8];
  int bidx[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int lr = (i >> 2) * 64 + ty * 4 + (i & 3);
    nai[i] = na[lr];
    rfi[i] = rf[lr];
    best[i] = second[i] = CUDART_INF_F;
    bidx[i] = 0;
  }

  for (int t = 0; t < ntiles; ++t) {
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 16
    for (int d = 0; d < D; ++d) {
      const float4 a0 = *reinterpret_cast<const float4*>(At + d * kTile + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(At + d * kTile + 64 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(Bt + d * kTile + tx * 4);
      const float4 b1 = *reinterpret_cast<const float4*>(Bt + d * kTile + 64 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }

    // Distances, the rows' running (best, column, second), the columns' least (distance, row).
    const int col0 = t * kTile;
    unsigned long long ckey[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int lc = (j >> 2) * 64 + tx * 4 + (j & 3);
      const float nbj = nb[lc], cfj = cf[lc];
      const int c = col0 + lc;
      float cmin = CUDART_INF_F;
      int crow = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float v = fmaxf(fmaf(-2.f, acc[i][j], nai[i] + nbj), 0.f);
        const float f = fmaxf(rfi[i], cfj);
        const float dd = f < 0.f ? v : f;
        const bool pr = dd < best[i];  // columns come in increasing order: ties keep the lowest
        second[i] = pr ? best[i] : fminf(second[i], dd);
        bidx[i] = pr ? c : bidx[i];
        best[i] = pr ? dd : best[i];
        const bool pc = dd < cmin;     // rows in increasing order
        crow = pc ? row0 + (i >> 2) * 64 + ty * 4 + (i & 3) : crow;
        cmin = pc ? dd : cmin;
      }
      ckey[j] = col_key(cmin, crow);
      const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, ckey[j], 16);  // the warp's other row group
      ckey[j] = o < ckey[j] ? o : ckey[j];
    }
    if (lane < 16) {
#pragma unroll
      for (int j = 0; j < 8; ++j) colpart[warp * kTile + (j >> 2) * 64 + tx * 4 + (j & 3)] = ckey[j];
    }
    __syncthreads();  // colpart is complete; every thread is done with Bt, nb and cf
    if (tid < kTile && col0 + tid < k) {
      unsigned long long m = colpart[tid];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        const unsigned long long o = colpart[w * kTile + tid];
        m = o < m ? o : m;
      }
      atomicMin(colkey + base + col0 + tid, m);
    }
    if (t + 1 < ntiles) {
      cp_async_wait_all();
      land_tile<D>(stage, Bt, vb + base, (t + 1) * kTile, k, tid, nb, cf, part);
      __syncthreads();  // the next tile is in Bt; the staging tile and colpart are free
      if (t + 2 < ntiles) {
        load_stage<D>(stage, pb, (t + 2) * kTile, k, tid);
        cp_async_commit();
      }
    }
  }

  // Rows: merge the 16 threads that share them (one half warp), lowest column on ties.
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float bv = best[i], sv = second[i];
    int bi = bidx[i];
#pragma unroll
    for (int m = 1; m < 16; m <<= 1) {
      const float ob = __shfl_xor_sync(0xFFFFFFFFu, bv, m);
      const float os = __shfl_xor_sync(0xFFFFFFFFu, sv, m);
      const int oi = __shfl_xor_sync(0xFFFFFFFFu, bi, m);
      sv = fminf(fminf(sv, os), fmaxf(bv, ob));
      const bool take = ob < bv || (ob == bv && oi < bi);
      bi = take ? oi : bi;
      bv = take ? ob : bv;
    }
    const int r = row0 + (i >> 2) * 64 + ty * 4 + (i & 3);
    if (tx == 0 && r < k) {
      d1[base + r] = bv;
      i1[base + r] = bi;
      d2[base + r] = sv;
    }
  }

  // The pair's last CTA turns the column keys into col_best.
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(done + p, 1u) == static_cast<unsigned>(gridDim.x - 2);  // counters start at ~0
  __syncthreads();
  if (last) {
    __threadfence();
    for (int c = tid; c < k; c += kThreads)
      col_best[base + c] = static_cast<int32_t>(static_cast<uint32_t>(__ldcg(colkey + base + c) & 0xFFFFFFFFull));
  }
}

template <int D>
int launch(const float* a, const float* b, const uint8_t* va, const uint8_t* vb, float* d1, int32_t* i1, float* d2,
           int32_t* col_best, unsigned long long* colkey, unsigned int* done, int p, int k, cudaStream_t stream) {
  const size_t smem = (2u * D * kTile + kTile * (D + 4u) + 5u * kTile) * sizeof(float) +
                      kWarps * kTile * sizeof(unsigned long long);
  cudaError_t err = cudaFuncSetAttribute(l2_match_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + kTile - 1) / kTile, p);
  l2_match_kernel<D><<<grid, kThreads, smem, stream>>>(a, b, va, vb, d1, i1, d2, col_best, colkey, done, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// a, b: (p, k, d) float32, 16-byte aligned; va, vb: (p, k) bool (one byte
// each); d1, d2: (p, k) float32; i1, col_best: (p, k) int32; scratch: p * k
// 8-byte keys then p 4-byte counters (this call sets them). d is 64 or 128.
extern "C" int dvo_l2_match_reductions(const float* a, const float* b, const uint8_t* va, const uint8_t* vb,
                                       float* d1, int32_t* i1, float* d2, int32_t* col_best, void* scratch,
                                       int p, int k, int d, void* stream) {
  if (p <= 0 || k <= 0) return 0;
  if (d != 64 && d != 128) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t n_keys = static_cast<size_t>(p) * k;
  cudaError_t err = cudaMemsetAsync(scratch, 0xFF, n_keys * 8 + static_cast<size_t>(p) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* colkey = static_cast<unsigned long long*>(scratch);
  auto* done = reinterpret_cast<unsigned int*>(colkey + n_keys);
  return d == 128 ? launch<128>(a, b, va, vb, d1, i1, d2, col_best, colkey, done, p, k, s)
                  : launch<64>(a, b, va, vb, d1, i1, d2, col_best, colkey, done, p, k, s);
}
