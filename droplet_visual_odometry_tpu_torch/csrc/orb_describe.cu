// ORB describe: patch gather, intensity-centroid angle, angle bin and 256
// steered BRIEF tests packed into 8 words, in one pass per keypoint.
//
// Replaces the TPU kernel droplet_visual_odometry_tpu/ops/pallas_patches.py
// (extract_patches_pallas / _kernel) and the XLA steering matmul, bin and
// bit pack after it in droplet_visual_odometry_tpu/frontend/orb.py
// (describe_batch). Contract: (N, H, W) float32 blurred images and (M, 3)
// int32 origins [frame, y0, x0], already clamped by the caller to
// [0, H-37] x [0, W-37], give (M, 8) int32 descriptor words and (M,) float32
// angles, equal to ops/cuda_describe.py:describe_plain.
//
// The TPU computes the tests as one (M, 1369) x (1369, 7682) matmul,
// because a gather is slow there. Column 2 + b*256 + j of that matrix is +1
// at the bin-b second test point of pair j and -1 at the first, so the bit
// is q[p2] > q[p1] on the rounded patch q (false when p1 == p2), and the two
// moment columns are integer sums. Here that is a read from shared memory:
//   - one warp per keypoint, 8 per block, stages its 37x37 patch in shared
//     memory with cp.async (43 copies per lane, all in flight at once), then
//     rounds it there half to even (rintf, like torch.round and jnp.round);
//   - each lane sums yy*q and xx*q over the disc yy^2 + xx^2 <= 18^2 in
//     int32, then a butterfly of __shfl_xor_sync; the sums are exact, so they
//     equal the matmul's for any pixel with |q| <= 2^24 / (18 * 1017);
//   - ang = atan2f(m01, m10) and bin = rint(ang / 2pi * 30) mod 30 with the
//     same IEEE steps as the twin (__fdiv_rn, __fmul_rn: nothing contracted);
//   - for word w, lane l reads the bin's pair (p1, p2) of bit 32w + l from a
//     (30, 256) table of int16 pairs through the read-only cache (lanes read
//     consecutive entries, so each word is one 128-byte line), and
//     __ballot_sync of q[p2] > q[p1] is word w in the reference's layout.
//
// Bound on this card: the bytes. Each keypoint reads 1369 floats and writes
// 36 bytes; the 12,288 patches of a 24-frame 1440x1080 run are 67.3 MB, of
// which about 37 MB are distinct pixels (neighbouring patches overlap), so
// the least time is about 0.011 ms at 3.35 TB/s. The ~5k integer operations
// per keypoint are far below that. What the kernel pays instead is latency:
// each keypoint's chain (origin, patch, moments, atan2, pair table, ballots)
// is a few dependent device-memory round trips, and a level's keypoints
// fill the card only once over.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPatch = 37;
constexpr int kHalf = kPatch / 2;
constexpr int kArea = kPatch * kPatch;
constexpr int kPerLane = (kArea + 31) / 32;
constexpr int kBins = 30;
constexpr int kBits = 256;
constexpr int kWords = kBits / 32;
constexpr int kWarps = 8;  // keypoints per block (43.8 KB of shared memory)
constexpr float kTwoPi = 6.28318530717958647692f;

__global__ void __launch_bounds__(kWarps * 32)
    orb_describe_kernel(const float* __restrict__ imgs, const int32_t* __restrict__ origins,
                        const short2* __restrict__ pairs, int32_t* __restrict__ desc,
                        float* __restrict__ angles, int m, int h, int w) {
  __shared__ float patch[kWarps][kArea];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= m) return;  // the whole warp leaves; nothing below syncs the block

  const int f = __ldg(origins + 3 * k);
  const int y0 = __ldg(origins + 3 * k + 1);
  const int x0 = __ldg(origins + 3 * k + 2);
  const float* src = imgs + (static_cast<size_t>(f) * h + y0) * w + x0;
  float* q = patch[warp];

  // Stage the patch with cp.async: all 43 copies of a lane are in flight at
  // once and no register holds a pixel on its way to shared memory.
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int idx = i * 32 + lane;
    const int r = idx / kPatch;
    const int c = idx - r * kPatch;
    if (idx < kArea) __pipeline_memcpy_async(q + idx, src + static_cast<size_t>(r) * w + c, sizeof(float));
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);

  // Round in place (each lane its own pixels) and sum the disc moments.
  int m01 = 0;
  int m10 = 0;
#pragma unroll
  for (int i = 0; i < kPerLane; ++i) {
    const int idx = i * 32 + lane;
    if (idx < kArea) {
      const float qv = rintf(q[idx]);
      q[idx] = qv;
      const int yy = idx / kPatch - kHalf;
      const int xx = idx - (idx / kPatch) * kPatch - kHalf;
      if (yy * yy + xx * xx <= kHalf * kHalf) {
        const int qi = __float2int_rn(qv);
        m01 += yy * qi;
        m10 += xx * qi;
      }
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m01 += __shfl_xor_sync(0xffffffffu, m01, o);
    m10 += __shfl_xor_sync(0xffffffffu, m10, o);
  }
  __syncwarp();

  const float ang = atan2f(static_cast<float>(m01), static_cast<float>(m10));
  int bin = static_cast<int>(rintf(__fmul_rn(__fdiv_rn(ang, kTwoPi), static_cast<float>(kBins))));
  bin %= kBins;
  if (bin < 0) bin += kBins;

  const short2* tb = pairs + bin * kBits + lane;
#pragma unroll
  for (int wd = 0; wd < kWords; ++wd) {
    const short2 pr = __ldg(tb + wd * 32);
    const unsigned word = __ballot_sync(0xffffffffu, q[pr.y] > q[pr.x]);
    if (lane == wd) desc[k * kWords + wd] = static_cast<int32_t>(word);
  }
  if (lane == 0) angles[k] = ang;
}

}  // namespace

// imgs: (n, h, w) float32; origins: (m, 3) int32; pairs: (30, 256, 2) int16;
// desc: (m, 8) int32; angles: (m,) float32.
extern "C" int dvo_orb_describe(const float* imgs, const int32_t* origins, const void* pairs,
                                int32_t* desc, float* angles, int m, int h, int w, void* stream) {
  const int blocks = (m + kWarps - 1) / kWarps;
  orb_describe_kernel<<<blocks, kWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      imgs, origins, static_cast<const short2*>(pairs), desc, angles, m, h, w);
  return static_cast<int>(cudaGetLastError());
}
