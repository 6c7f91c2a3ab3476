// FAST-9/16 corner response over a batch of float32 images.
//
// Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_fast.py
// (_fast_score_impl / _kernel) and computes what it computes: for each
// pixel, the 16 Bresenham-circle neighbours (frontend/fast.py CIRCLE_OFFSETS)
// are tested against centre +- threshold, the polarity bits are packed into
// one 16-bit ring per polarity, a contiguous arc of >= arc_length is
// required, and the score is max(sum of brighter excess, sum of darker
// excess), accumulated in neighbour order j = 0..15. The score is 0 within
// BORDER = 3 pixels of an edge. The output equals ops/cuda_fast.py:
// fast_score_plain bit for bit (the same f32 operations in the same order).
//
// Bound on this card: the bytes. Each pixel is read and written once as
// float32, 8 bytes, so the 3.25 Mpx of a 1440x1080 frame's four pyramid
// levels take 0.187 ms for 24 frames at 3.35 TB/s. The design keeps the
// arithmetic and the shared-memory traffic below that:
//   - a block of 32x8 threads covers a 128x32 output tile, 16 pixels per
//     thread, and stages the 134x38 input tile (3-pixel halo, 1.24 loads
//     per output) with coalesced cp.async copies, all issued before any is
//     waited on, and no integer division. Out-of-image halo reads of the
//     edge tiles are clamped (they can only feed the masked border); the
//     interior tiles, 78% of level 0, take a path with no clamp and no edge
//     test;
//   - the compass pre-test: neighbours 0, 4, 8 and 12 first. Any cyclic run
//     of n >= 1 of the 16 covers at least floor(n / 4) of those four, and the
//     score is 0 unless an arc exists, so a pixel with fewer than
//     floor(arc / 4) compass hits of either polarity scores 0 and stops
//     there. That is 95-99% of the pixels of a real frame;
//   - each warp queues the pixels that pass in its own part of shared
//     memory (a ballot, no atomics) and then runs the full ring on its
//     queue, so a warp is not held by one passing lane among 31 rejected;
//   - the ring offsets are immediates (fully unrolled, from packed constexpr
//     tables), and arc_length is a template parameter for the main path's 9,
//     with one generic instantiation for any other arc.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kR = 3;  // circle radius == BORDER
constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kPX = 4;  // pixels per thread along x, kTX apart
constexpr int kPY = 4;  // pixels per thread along y, kTY apart
constexpr int kTileW = kTX * kPX;
constexpr int kTileH = kTY * kPY;
constexpr int kSW = kTileW + 2 * kR;
constexpr int kSH = kTileH + 2 * kR;
constexpr int kLX = (kSW + kTX - 1) / kTX;
constexpr int kLY = (kSH + kTY - 1) / kTY;
constexpr int kPerWarp = kPX * kPY * kTX;  // queue entries of one warp: all its pixels
constexpr int kGeneric = 0;  // template arc meaning "read the arc argument"

// (dy, dx) of the 16 circle neighbours, clockwise from 12 o'clock, each
// stored + 3 in 4 bits so that the tables are scalars usable in device code.
constexpr int kDyList[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
constexpr int kDxList[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

constexpr unsigned long long pack_offsets(const int (&d)[16]) {
  unsigned long long p = 0;
  for (int j = 0; j < 16; ++j) p |= static_cast<unsigned long long>(d[j] + kR) << (4 * j);
  return p;
}

constexpr unsigned long long kDyPacked = pack_offsets(kDyList);
constexpr unsigned long long kDxPacked = pack_offsets(kDxList);

// Offset of neighbour j in the shared tile; an immediate once j is a constant.
__device__ __forceinline__ constexpr int ring_offset(int j) {
  return (static_cast<int>((kDyPacked >> (4 * j)) & 15ull) - kR) * kSW +
         (static_cast<int>((kDxPacked >> (4 * j)) & 15ull) - kR);
}

// Compass hits a pixel needs, per polarity, before the full ring is worth
// testing: floor(arc / 4); above 16 no arc exists, so 5 rejects every pixel.
__host__ __device__ constexpr int compass_need(int arc) {
  return arc > 16 ? 5 : (arc < 4 ? 0 : arc / 4);
}

// True when the 16-bit ring m holds a cyclic run of >= arc set bits. The
// doubled 32-bit ring turns every cyclic run of length <= 16 into a linear
// one; ANDing arc shifted copies leaves a bit set where such a run starts.
template <int ARC>
__device__ __forceinline__ bool has_arc(unsigned m, int arc) {
  const unsigned d = m | (m << 16);
  unsigned r = d;
  if (ARC != kGeneric) {
#pragma unroll
    for (int k = 1; k < ARC; ++k) r &= d >> k;
    return r != 0u;
  }
  if (arc <= 0) return true;
  if (arc > 16) return false;
  for (int k = 1; k < arc; ++k) r &= d >> k;
  return r != 0u;
}

// Full FAST score of the pixel at p (a pointer into the shared tile).
template <int ARC>
__device__ __forceinline__ float ring_score(const float* p, float threshold, int arc) {
  const float c = p[0];
  const float hi = c + threshold;
  const float lo = c - threshold;
  float sb = 0.0f;
  float sd = 0.0f;
  unsigned pb = 0u;
  unsigned pd = 0u;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float v = p[ring_offset(j)];
    const float ex = fabsf(v - c) - threshold;
    const bool b = v > hi;
    const bool d = v < lo;
    sb += b ? ex : 0.0f;
    sd += d ? ex : 0.0f;
    pb |= static_cast<unsigned>(b) << j;
    pd |= static_cast<unsigned>(d) << j;
  }
  return (has_arc<ARC>(pb, arc) || has_arc<ARC>(pd, arc)) ? fmaxf(sb, sd) : 0.0f;
}

// One 128x32 output tile. INTERIOR: the tile and its halo lie inside the
// image, so no address is clamped and no pixel is tested against an edge
// (78% of the level-0 tiles); the blocks on the image's edges take the
// checked path.
template <int ARC, bool INTERIOR>
__device__ __forceinline__ void score_tile(const float* __restrict__ img, float* __restrict__ dst,
                                           float* tile, uint16_t* queue, int x0, int y0, int h, int w,
                                           float threshold, int arc) {
  const int need = compass_need(arc);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;

  // Stage the tile and its halo with cp.async: no register holds a value on
  // its way to shared memory, and every load is issued before any is waited on.
#pragma unroll
  for (int i = 0; i < kLY; ++i) {
    const int sy = ty + i * kTY;
    if (sy < kSH) {
      const int gy = INTERIOR ? y0 - kR + sy : min(max(y0 - kR + sy, 0), h - 1);
      const float* row = img + static_cast<size_t>(gy) * w;
#pragma unroll
      for (int j = 0; j < kLX; ++j) {
        const int sx = tx + j * kTX;
        if (sx < kSW) {
          const int gx = INTERIOR ? x0 - kR + sx : min(max(x0 - kR + sx, 0), w - 1);
          __pipeline_memcpy_async(tile + sy * kSW + sx, row + gx, sizeof(float));
        }
      }
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // Pass 1: the compass pre-test for every pixel. Rejected and border pixels
  // write their 0 now; the rest join the warp's queue (thread row ty is one
  // warp, tx its lane).
  uint16_t* wq = queue + ty * kPerWarp;
  int count = 0;
#pragma unroll 1
  for (int i = 0; i < kPY; ++i) {
    const int ly = ty + i * kTY;
    const int y = y0 + ly;
    float* drow = dst + static_cast<size_t>(y) * w + x0;
#pragma unroll
    for (int j = 0; j < kPX; ++j) {
      const int lx = tx + j * kTX;
      const int x = x0 + lx;
      bool pass = false;
      if (INTERIOR || (y < h && x < w)) {
        if (INTERIOR || (y >= kR && y < h - kR && x >= kR && x < w - kR)) {
          const float* p = tile + (ly + kR) * kSW + lx + kR;
          const float hi = p[0] + threshold;
          const float lo = p[0] - threshold;
          const float n0 = p[ring_offset(0)];
          const float n4 = p[ring_offset(4)];
          const float n8 = p[ring_offset(8)];
          const float n12 = p[ring_offset(12)];
          const int nb = (n0 > hi) + (n4 > hi) + (n8 > hi) + (n12 > hi);
          const int nd = (n0 < lo) + (n4 < lo) + (n8 < lo) + (n12 < lo);
          pass = nb >= need || nd >= need;
        }
        if (!pass) drow[lx] = 0.0f;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, pass);
      if (pass) wq[count + __popc(ballot & ((1u << tx) - 1u))] = static_cast<uint16_t>(ly * kTileW + lx);
      count += __popc(ballot);
    }
  }
  __syncwarp();

  // Pass 2: the full ring, the warp's 32 lanes on its queued pixels.
  for (int e = tx; e < count; e += kTX) {
    const int ly = wq[e] / kTileW;
    const int lx = wq[e] - ly * kTileW;
    dst[static_cast<size_t>(y0 + ly) * w + x0 + lx] =
        ring_score<ARC>(tile + (ly + kR) * kSW + lx + kR, threshold, arc);
  }
}

template <int ARC>
__global__ void __launch_bounds__(kTX * kTY)
    fast_score_kernel(const float* __restrict__ imgs, float* __restrict__ out, int h, int w,
                      float threshold, int arc_arg) {
  __shared__ float tile[kSH * kSW];
  __shared__ uint16_t queue[kTY * kPerWarp];
  const int arc = ARC != kGeneric ? ARC : arc_arg;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * kTileH;
  const size_t plane = static_cast<size_t>(h) * w;
  const float* img = imgs + blockIdx.z * plane;
  float* dst = out + blockIdx.z * plane;
  if (x0 >= kR && y0 >= kR && x0 + kTileW <= w - kR && y0 + kTileH <= h - kR) {
    score_tile<ARC, true>(img, dst, tile, queue, x0, y0, h, w, threshold, arc);
  } else {
    score_tile<ARC, false>(img, dst, tile, queue, x0, y0, h, w, threshold, arc);
  }
}

}  // namespace

// imgs, out: (n, h, w) float32, contiguous, on the current device.
extern "C" int dvo_fast_score(const float* imgs, float* out, int n, int h, int w, float threshold,
                              int arc_length, void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTileW - 1) / kTileW, (h + kTileH - 1) / kTileH, n);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (arc_length == 9) {
    fast_score_kernel<9><<<grid, block, 0, s>>>(imgs, out, h, w, threshold, arc_length);
  } else {
    fast_score_kernel<kGeneric><<<grid, block, 0, s>>>(imgs, out, h, w, threshold, arc_length);
  }
  return static_cast<int>(cudaGetLastError());
}
