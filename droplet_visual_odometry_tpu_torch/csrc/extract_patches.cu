// Per-keypoint 37x37 patch gather from a batch of float32 images.
//
// Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_patches.py
// (extract_patches_pallas / _kernel), with its contract: (N, H, W) float32
// images and (M, 3) int32 origins [frame, y0, x0], already clamped by the
// caller to [0, H-37] x [0, W-37], give (M, 37, 37) float32 patches.
//
// Shape: one block per keypoint; a 32x8 block strides the 37 rows, with
// neighbouring threads on neighbouring columns so each row read and each
// row write is coalesced. The TPU kernel's aligned 48x256 DMA windows,
// rolls and split scalar-prefetch arrays answer Mosaic tiling limits that
// this card does not have, and are not reproduced.
//
// Bound on this card: a pure copy — about 67 MB written (and as much read)
// for the 12,288 keypoints of a 24-frame 1440x1080 run, so only the bytes
// matter; the design reads and writes each patch pixel exactly once.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 37;

__global__ void extract_patches_kernel(const float* __restrict__ imgs,
                                       const int32_t* __restrict__ origins,
                                       float* __restrict__ out, int h, int w) {
  const int m = blockIdx.x;
  const int f = origins[3 * m];
  const int y0 = origins[3 * m + 1];
  const int x0 = origins[3 * m + 2];
  const float* src = imgs + (static_cast<size_t>(f) * h + y0) * w + x0;
  float* dst = out + static_cast<size_t>(m) * kPatch * kPatch;
  for (int r = threadIdx.y; r < kPatch; r += blockDim.y) {
    for (int c = threadIdx.x; c < kPatch; c += blockDim.x) {
      dst[r * kPatch + c] = src[static_cast<size_t>(r) * w + c];
    }
  }
}

}  // namespace

// imgs: (n, h, w) float32; origins: (m, 3) int32; out: (m, 37, 37) float32.
extern "C" int dvo_extract_patches(const float* imgs, const int32_t* origins, float* out, int m,
                                   int h, int w, void* stream) {
  const dim3 block(32, 8);
  extract_patches_kernel<<<m, block, 0, static_cast<cudaStream_t>(stream)>>>(imgs, origins, out,
                                                                              h, w);
  return static_cast<int>(cudaGetLastError());
}
