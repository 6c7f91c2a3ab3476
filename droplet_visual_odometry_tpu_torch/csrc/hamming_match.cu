// Hamming-distance match reductions between packed 256-bit descriptor sets,
// batched over frame pairs.
//
// Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_match.py
// (match_reductions / _kernel) and computes what it computes, for each of P
// pairs of (K, 8) uint32 descriptor sets with validity masks:
//   d1[r]       best distance of row r        (reported 1e9 if invalid)
//   i1[r]       its column, lowest on ties
//   d2[r]       best distance over the other columns (Lowe ratio test)
//   col_best[c] best row of column c, lowest on ties (mutual cross-check)
// An entry whose row or column is invalid counts as distance 512, above
// every real distance (<= 256), exactly as in the TPU kernel.
//
// Shape: one thread per row, 64 rows per block, grid (K/64, P). Column tiles
// of B's descriptors and masks are staged in shared memory (every thread
// reads the same column at once: a broadcast), and each thread keeps its
// row's best and second best in registers, so no K x K matrix exists —
// which is what made the TPU kernel fail to compile at K = 2048.
// col_best comes from atomicMin on the packed key (dist << 12) | row: first
// per block in shared memory, then once per block and column in a (P, K)
// uint32 scratch. min() is order-independent, so the result is
// deterministic, and the packing breaks ties to the lowest row exactly as
// the TPU kernel's dist * 4096 + index encoding does (requires K <= 4096).
//
// Bound on this card: P*K*K*8 XOR+popcount pairs (48 M at P=23, K=512) and a
// few hundred KB of traffic — latency of the per-row column loop bounds it;
// the design keeps that loop in registers and shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;
constexpr int kTile = 64;
constexpr unsigned kInvalid = 512u;
constexpr unsigned kNone = 1024u;  // above kInvalid: "no column seen yet"
constexpr float kBig = 1e9f;

__global__ void match_rows_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b,
                                  const uint8_t* __restrict__ va, const uint8_t* __restrict__ vb,
                                  float* __restrict__ d1, int32_t* __restrict__ i1,
                                  float* __restrict__ d2, uint32_t* __restrict__ col_key, int k) {
  __shared__ uint32_t sdesc[kTile][8];
  __shared__ uint8_t svalid[kTile];
  __shared__ uint32_t scol[kTile];

  const int p = blockIdx.y;
  const int row = blockIdx.x * kRows + threadIdx.x;
  const bool has_row = row < k;
  const size_t base = static_cast<size_t>(p) * k;

  uint32_t ra[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) ra[q] = has_row ? a[(base + row) * 8 + q] : 0u;
  const bool row_valid = has_row && va[base + row] != 0;

  unsigned best = kNone;
  unsigned second = kNone;
  int best_col = 0;

  for (int j0 = 0; j0 < k; j0 += kTile) {
    const int ncols = min(kTile, k - j0);
    __syncthreads();  // the previous tile is fully consumed
    for (int t = threadIdx.x; t < kTile * 8; t += kRows) {
      const int jj = t >> 3;
      sdesc[jj][t & 7] = jj < ncols ? b[(base + j0 + jj) * 8 + (t & 7)] : 0u;
    }
    for (int t = threadIdx.x; t < kTile; t += kRows) {
      svalid[t] = t < ncols ? vb[base + j0 + t] : 0;
      scol[t] = 0xFFFFFFFFu;
    }
    __syncthreads();

    for (int jj = 0; jj < ncols; ++jj) {
      unsigned d = kInvalid;
      if (row_valid && svalid[jj]) {
        d = 0u;
#pragma unroll
        for (int q = 0; q < 8; ++q) d += __popc(ra[q] ^ sdesc[jj][q]);
      }
      if (d < best) {
        second = best;
        best = d;
        best_col = j0 + jj;
      } else if (d < second) {
        second = d;
      }
      if (has_row) atomicMin(&scol[jj], (d << 12) | static_cast<unsigned>(row));
    }
    __syncthreads();
    for (int t = threadIdx.x; t < ncols; t += kRows) atomicMin(&col_key[base + j0 + t], scol[t]);
  }

  if (has_row) {
    d1[base + row] = best >= kInvalid ? kBig : static_cast<float>(best);
    i1[base + row] = best_col;
    d2[base + row] = second >= kInvalid ? kBig : static_cast<float>(second);
  }
}

__global__ void unpack_col_best_kernel(const uint32_t* __restrict__ col_key,
                                       int32_t* __restrict__ col_best, int total) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < total) col_best[i] = static_cast<int32_t>(col_key[i] & 0xFFFu);
}

}  // namespace

// a, b: (p, k, 8) uint32; va, vb: (p, k) bool (one byte each);
// d1, d2: (p, k) float32; i1, col_best: (p, k) int32; scratch: (p, k) uint32.
extern "C" int dvo_match_reductions(const uint32_t* a, const uint32_t* b, const uint8_t* va,
                                    const uint8_t* vb, float* d1, int32_t* i1, float* d2,
                                    int32_t* col_best, uint32_t* scratch, int p, int k,
                                    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int total = p * k;
  cudaError_t err = cudaMemsetAsync(scratch, 0xFF, sizeof(uint32_t) * total, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((k + kRows - 1) / kRows, p);
  match_rows_kernel<<<grid, kRows, 0, s>>>(a, b, va, vb, d1, i1, d2, scratch, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  unpack_col_best_kernel<<<(total + 255) / 256, 256, 0, s>>>(scratch, col_best, total);
  return static_cast<int>(cudaGetLastError());
}
