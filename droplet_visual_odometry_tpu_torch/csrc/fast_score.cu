// FAST-9/16 corner response over a batch of float32 images.
//
// Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_fast.py
// (_fast_score_impl / _kernel) and computes what it computes: for each
// pixel, the 16 Bresenham-circle neighbours (frontend/fast.py CIRCLE_OFFSETS)
// are tested against centre +- threshold, the polarity bits are packed into
// one 16-bit ring per polarity, a contiguous arc of >= arc_length is
// required, and the score is max(sum of brighter excess, sum of darker
// excess), accumulated in neighbour order j = 0..15. The score is 0 within
// BORDER = 3 pixels of an edge.
//
// Shape: one thread per output pixel; a 32x8 block stages its 38x14 input
// tile (3-pixel halo) in shared memory, so each input pixel is read from
// device memory about once and each output written once. Out-of-image halo
// reads are clamped; they can only feed the masked 3-pixel border, as the
// Pallas kernel's lane-roll wrap can.
//
// Bound on this card: ~60 integer/float ops and 8 bytes of device traffic
// per pixel, ~3.25 Mpx per 1440x1080 frame over the four pyramid levels —
// light on both; the design point is one read and one write per pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;
constexpr int kTY = 8;
constexpr int kR = 3;  // circle radius == BORDER
constexpr int kTileW = kTX + 2 * kR;
constexpr int kTileH = kTY + 2 * kR;

// (dy, dx) of the 16 circle neighbours, clockwise from 12 o'clock.
__constant__ int kDy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
__constant__ int kDx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};

// True when the 16-bit ring m holds a cyclic run of >= arc set bits. The
// doubled 32-bit ring turns every cyclic run of length <= 16 into a linear
// one; ANDing arc shifted copies leaves a bit set where such a run starts.
__device__ __forceinline__ bool has_arc(unsigned m, int arc) {
  if (arc <= 0) return true;
  if (arc > 16) return false;
  const unsigned d = m | (m << 16);
  unsigned r = d;
  for (int k = 1; k < arc; ++k) r &= d >> k;
  return r != 0u;
}

__global__ void fast_score_kernel(const float* __restrict__ imgs, float* __restrict__ out, int h,
                                  int w, float threshold, int arc) {
  __shared__ float tile[kTileH][kTileW];
  const int x0 = blockIdx.x * kTX;
  const int y0 = blockIdx.y * kTY;
  const float* img = imgs + static_cast<size_t>(blockIdx.z) * h * w;

  for (int i = threadIdx.y * kTX + threadIdx.x; i < kTileH * kTileW; i += kTX * kTY) {
    const int ty = i / kTileW;
    const int tx = i - ty * kTileW;
    const int gy = min(max(y0 + ty - kR, 0), h - 1);
    const int gx = min(max(x0 + tx - kR, 0), w - 1);
    tile[ty][tx] = img[static_cast<size_t>(gy) * w + gx];
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= w || y >= h) return;

  float score = 0.0f;
  if (y >= kR && y < h - kR && x >= kR && x < w - kR) {
    const int cy = threadIdx.y + kR;
    const int cx = threadIdx.x + kR;
    const float c = tile[cy][cx];
    const float hi = c + threshold;
    const float lo = c - threshold;
    float sb = 0.0f;
    float sd = 0.0f;
    unsigned pb = 0u;
    unsigned pd = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float v = tile[cy + kDy[j]][cx + kDx[j]];
      const float ex = fabsf(v - c) - threshold;
      const bool b = v > hi;
      const bool d = v < lo;
      sb += b ? ex : 0.0f;
      sd += d ? ex : 0.0f;
      pb |= static_cast<unsigned>(b) << j;
      pd |= static_cast<unsigned>(d) << j;
    }
    if (has_arc(pb, arc) || has_arc(pd, arc)) score = fmaxf(sb, sd);
  }
  out[static_cast<size_t>(blockIdx.z) * h * w + static_cast<size_t>(y) * w + x] = score;
}

}  // namespace

// imgs, out: (n, h, w) float32, contiguous, on the current device.
extern "C" int dvo_fast_score(const float* imgs, float* out, int n, int h, int w, float threshold,
                              int arc_length, void* stream) {
  const dim3 block(kTX, kTY);
  const dim3 grid((w + kTX - 1) / kTX, (h + kTY - 1) / kTY, n);
  fast_score_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(imgs, out, h, w,
                                                                            threshold, arc_length);
  return static_cast<int>(cudaGetLastError());
}
