// The windowed bundle adjustment's Levenberg-Marquardt loop: every LM step
// of one window, with its accept or reject, the initial and final costs and
// the final RMS, in one launch, in float64, summed in a fixed order.
//
// Replaces no TPU kernel: the JAX package compiles run_ba with XLA
// (droplet_visual_odometry_tpu/backend/ba.py). On the card the op-by-op
// loop (backend/ba.run_ba_eager, the plain twin, ops/cuda_ba.run_ba_plain)
// issues about 280 kernels an LM step, so a captured replay of a window's
// ten steps is bound by its ~2,800 graph nodes, not by its data. Here the
// loop runs on the C <= 8 SMs of one thread block cluster.
//
// What it computes, as run_ba_eager does: a window of W poses (cTw, 4x4)
// and L landmarks, observed at obs_uv where obs_mask is set. Each step
// linearises at (poses, points): residual r = proj(R X + t) - uv, Huber
// weight wgt = (|r| <= huber ? 1 : huber / |r|) where the observation is
// masked in and its depth exceeds min_depth (else 0), Jacobians J_pose =
// J_p [I | -hat(p)] and J_land = J_p R. The landmark blocks Hll (damped
// by lam times their clamped diagonal) are inverted by the unrolled 3x3
// Cholesky (eps 1e-9); the reduced camera system S = Hcc_d - sum_l Hcl
// Hll^-1 Hlc, rhs = bc - sum_l Hcl Hll^-1 bl, gauge-fixed on the first
// n_fixed poses (identity rows, zero rhs) plus 1e-9 I, is solved by LDL^T
// (run_ba_eager solves it by LU with partial pivoting: S is the Schur
// complement of a damped positive definite system, so it needs no
// pivoting); landmarks step by Hll^-1 (bl - Hlc dc), poses by
// exp(dc) from the left. The step is kept when the new mean robust cost is
// lower and finite; lam goes down or up and is clamped to [1e-9, 1e6]. All
// `iters` steps run. A pose held by the gauge is never rewritten.
//
// Layout: one cluster of C = min(8, L) blocks of 256 threads
// (ops/cuda_ba.plan). Block b owns the landmarks [b Lb, (b + 1) Lb), Lb =
// ceil(L / C), and walks them in chunks of 256 / W landmarks, one
// observation a thread: it linearises, sums Hll and bl over the W views of
// each landmark, inverts Hll, forms Hcl Hll^-1 and accumulates its share
// of the camera terms in registers. Then it steps its landmarks, one
// observation a thread again, and sums its part of the new cost. The camera
// terms are units: one 6x6 block of S_off for each pair w <= v, and for
// each pose w its Hcc (21 entries), bc and rhs_corr; each unit is held by
// G = 256 / U threads, which take every G-th landmark of a chunk. Per
// landmark a block keeps its new point, Hll^-1 and bl in global scratch.
//
// Fixed order: every sum has one order that depends only on (W, L, C):
// landmarks in ascending order within a unit's thread, the G threads of a
// unit in order, the blocks in rank order (each block reads the others'
// partial sums through distributed shared memory and adds them up itself,
// so every block holds the same system), costs by one shuffle tree and the
// warps in order. Every block then solves the same 6W x 6W system the same
// way and takes the same decision, with no broadcast. No atomics: two
// launches on the same inputs give the same bits.
//
// Bound on the H100: at (W, L) = (8, 1000) an LM step is about 4.5 M FMA
// (S_off's 3.9 M) and a launch reads 0.2 MB, so ten steps are about 3 us
// at the float64 rate and 0.06 us at HBM's. What bounds it is the chain of
// barriers and of the serial steps between them: per step about 24 block
// barriers in the landmark chunks, two per 6-column panel of the LDL^T with
// warp 0's panel factorisation between them, and two cluster barriers
// (partial sums, then the new cost).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kMaxSmem = 232448;  // shared memory one block may take on the H100
constexpr unsigned kFull = 0xffffffffu;

// One observation's record in shared memory (doubles).
constexpr int kJp = 0;     // J_pose, 2 x 6
constexpr int kWr = 12;    // wgt * r
constexpr int kWgt = 14;   // wgt
constexpr int kHcl = 15;   // Hcl = wgt J_pose^T J_land, 6 x 3
constexpr int kHinv = 33;  // Hcl Hll^-1, 6 x 3; before it, the view's terms of Hll (6) and bl (3)
constexpr int kObs = 51;
constexpr int kLmk = 12;      // a chunk landmark in shared memory: Hll^-1 (9), bl (3)
constexpr int kScratch = 15;  // a landmark in global scratch: new point (3), Hll^-1 (9), bl (3)
constexpr int kUnit = 36;     // accumulators of one unit
constexpr int kBc = 21;       // a pose unit: Hcc's upper triangle (21), then sum J_pose^T wgt r (6) ...
constexpr int kRc = 27;       // ... and rhs_corr (6)

__device__ __forceinline__ double clamp_min(double x, double lo) { return x < lo ? lo : x; }  // keeps NaN

// The same shared-memory array in block `rank` of the cluster.
template <typename T>
__device__ __forceinline__ T* on_rank(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, static_cast<unsigned>(rank));
}

// Index of (k, m), k <= m, in a row-major upper triangle of a 6x6 matrix.
__device__ __forceinline__ int upper6(int k, int m) { return k * 6 - k * (k - 1) / 2 + (m - k); }

// Index of the S_off unit of poses w <= v (w major).
__device__ __forceinline__ int pair_unit(int w, int v, int W) { return w * W - w * (w - 1) / 2 + (v - w); }

struct Linear {
  double r[2];
  double wgt;
  double jp[2][6];  // du/dtwist, dv/dtwist
  double jl[2][3];  // du/dX, dv/dX
};

// One observation linearised at pose P (row-major 4x4) and landmark X,
// with run_ba_eager's formulas (_project, _build_normal_blocks).
__device__ __forceinline__ void linearise(const double* P, const double* X, double ou, double ov, bool mask,
                                          double fx, double fy, double cx, double cy, double huber,
                                          double min_depth, Linear& o) {
  double p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = P[i * 4] * X[0] + P[i * 4 + 1] * X[1] + P[i * 4 + 2] * X[2] + P[i * 4 + 3];
  const double iz = 1.0 / clamp_min(p[2], 1e-6);
  o.r[0] = fx * p[0] * iz + cx - ou;
  o.r[1] = fy * p[1] * iz + cy - ov;
  const bool valid = mask && p[2] > min_depth;
  const double rn = sqrt(o.r[0] * o.r[0] + o.r[1] * o.r[1]);
  o.wgt = (rn <= huber ? 1.0 : huber / clamp_min(rn, 1e-12)) * (valid ? 1.0 : 0.0);
  const double iz2 = iz * iz;
  const double J[2][3] = {{fx * iz, 0.0, -fx * p[0] * iz2}, {0.0, fy * iz, -fy * p[1] * iz2}};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    o.jp[i][0] = J[i][0];
    o.jp[i][1] = J[i][1];
    o.jp[i][2] = J[i][2];
    // J_p (-hat(p)), -hat(p) = [[0, pz, -py], [-pz, 0, px], [py, -px, 0]]
    o.jp[i][3] = -J[i][1] * p[2] + J[i][2] * p[1];
    o.jp[i][4] = J[i][0] * p[2] - J[i][2] * p[0];
    o.jp[i][5] = -J[i][0] * p[1] + J[i][1] * p[0];
#pragma unroll
    for (int m = 0; m < 3; ++m) o.jl[i][m] = J[i][0] * P[m] + J[i][1] * P[4 + m] + J[i][2] * P[8 + m];
  }
}

// Hcl = wgt J_pose^T J_land of one observation.
__device__ __forceinline__ void hcl_of(const Linear& o, double (&h)[18]) {
#pragma unroll
  for (int k = 0; k < 6; ++k)
#pragma unroll
    for (int m = 0; m < 3; ++m) h[k * 3 + m] = o.jp[0][k] * o.wgt * o.jl[0][m] + o.jp[1][k] * o.wgt * o.jl[1][m];
}

// One observation's terms of the robust cost and the RMS (reprojection_cost):
// acc += (wgt r2, valid, wgt > 0 ? r2 : 0, wgt > 0).
__device__ __forceinline__ void cost_terms(const double* P, const double* X, double ou, double ov, bool mask,
                                           double fx, double fy, double cx, double cy, double huber,
                                           double min_depth, double (&acc)[4]) {
  double p[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) p[i] = P[i * 4] * X[0] + P[i * 4 + 1] * X[1] + P[i * 4 + 2] * X[2] + P[i * 4 + 3];
  const double iz = 1.0 / clamp_min(p[2], 1e-6);
  const double r0 = fx * p[0] * iz + cx - ou;
  const double r1 = fy * p[1] * iz + cy - ov;
  const double r2 = r0 * r0 + r1 * r1;
  const bool valid = mask && p[2] > min_depth;
  const double rn = sqrt(clamp_min(r2, 1e-12));
  const double wgt = (rn <= huber ? 1.0 : huber / rn) * (valid ? 1.0 : 0.0);
  acc[0] += wgt * r2;
  acc[1] += valid ? 1.0 : 0.0;
  acc[2] += wgt > 0.0 ? r2 : 0.0;
  acc[3] += wgt > 0.0 ? 1.0 : 0.0;
}

// Sum v over the block: one shuffle tree a warp, then the warps in order;
// every thread gets the same bits.
template <int N>
__device__ __forceinline__ void block_sum(double (&v)[N], double* sred, int warp, int lane) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[i] += __shfl_down_sync(kFull, v[i], off);
    if (lane == 0) sred[warp * N + i] = v[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < N; ++i) {
    double s = 0.0;
    for (int k = 0; k < kWarps; ++k) s += sred[k * N + i];
    v[i] = s;
  }
}

// exp(dc) P for a twist dc = [v, w] (core/se3.se3_exp, then the product).
__device__ void exp_times(const double* dc, const double* P, double* out) {
  const double wx = dc[3], wy = dc[4], wz = dc[5];
  const double theta = sqrt(clamp_min(wx * wx + wy * wy + wz * wz, 1e-24));
  const double a = fabs(theta) < 1e-3 ? 1.0 - theta * theta / 6.0 : sin(theta) / theta;
  const double h = 0.5 * theta;
  const double s = fabs(h) < 1e-3 ? 1.0 - h * h / 6.0 : sin(h) / h;
  const double b = 0.5 * s * s;
  const double t2 = theta * theta;
  const double c = theta < 1.0 ? 1.0 / 6.0 - t2 / 120.0 + t2 * t2 / 5040.0 : (1.0 - sin(theta) / theta) / t2;
  const double Wm[3][3] = {{0.0, -wz, wy}, {wz, 0.0, -wx}, {-wy, wx, 0.0}};
  double T[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double ww = Wm[i][0] * Wm[0][j] + Wm[i][1] * Wm[1][j] + Wm[i][2] * Wm[2][j];
      const double eye = i == j ? 1.0 : 0.0;
      T[i][j] = eye + a * Wm[i][j] + b * ww;
    }
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    double t = 0.0;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const double ww = Wm[i][0] * Wm[0][j] + Wm[i][1] * Wm[1][j] + Wm[i][2] * Wm[2][j];
      t += ((i == j ? 1.0 : 0.0) + b * Wm[i][j] + c * ww) * dc[j];
    }
    T[i][3] = t;
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      out[i * 4 + j] = T[i][0] * P[j] + T[i][1] * P[4 + j] + T[i][2] * P[8 + j] + T[i][3] * P[12 + j];
#pragma unroll
  for (int j = 0; j < 4; ++j) out[12 + j] = P[12 + j];
}

// Solve A x = b in place for a symmetric positive definite A given by its
// lower triangle (A is n x (n + 1), row stride n + 1, b in column n; n a
// multiple of 6 and at most 6 * 18 = 108 < 4 * 32) by LDL^T without
// pivoting, in panels of 6 columns: warp 0 factors a panel in registers
// (a lane holds rows K + lane + 32 h, h < 4, and their b; the pivot rows
// travel by shuffles) and carries the forward substitution of b through
// it, then every thread updates the trailing lower triangle. The factor is
// kept as L D (the eliminated columns unscaled). x to x; rd (n) takes D^-1.
__device__ void ldl_solve(double* A, int n, double* x, double* rd, int tid, int warp, int lane) {
  constexpr int kRowsPerLane = 4;
  const int ld = n + 1;
  for (int K = 0; K < n; K += 6) {
    if (warp == 0) {
      double a[kRowsPerLane][6], b[kRowsPerLane];
#pragma unroll
      for (int h = 0; h < kRowsPerLane; ++h) {
        const int r = K + lane + 32 * h;
#pragma unroll
        for (int c = 0; c < 6; ++c) a[h][c] = r < n ? A[r * ld + K + c] : 0.0;
        b[h] = r < n ? A[r * ld + n] : 0.0;
      }
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        const double rdc = 1.0 / __shfl_sync(kFull, a[0][c], c);
        const double yc = __shfl_sync(kFull, b[0], c);
        double u[6];
#pragma unroll
        for (int c2 = c + 1; c2 < 6; ++c2) u[c2] = __shfl_sync(kFull, a[0][c], c2);
#pragma unroll
        for (int h = 0; h < kRowsPerLane; ++h) {
          if (lane + 32 * h > c) {  // the rows below the pivot
            const double l = a[h][c] * rdc;
#pragma unroll
            for (int c2 = c + 1; c2 < 6; ++c2) a[h][c2] -= l * u[c2];
            b[h] -= l * yc;
          }
        }
        if (lane == 0) rd[K + c] = rdc;
      }
#pragma unroll
      for (int h = 0; h < kRowsPerLane; ++h) {
        const int r = K + lane + 32 * h;
        if (r < n) {
#pragma unroll
          for (int c = 0; c < 6; ++c) A[r * ld + K + c] = a[h][c];  // above the diagonal too: never read
          A[r * ld + n] = b[h];
        }
      }
    }
    __syncthreads();
    double pj[2][6];  // this lane's columns j of the panel
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = K + 6 + lane + 32 * q;
#pragma unroll
      for (int c = 0; c < 6; ++c) pj[q][c] = j < n ? A[j * ld + K + c] : 0.0;
    }
    for (int i = K + 6 + warp; i < n; i += kWarps) {  // rows by warp, columns j <= i by lane
      double li[6];
#pragma unroll
      for (int c = 0; c < 6; ++c) li[c] = A[i * ld + K + c] * rd[K + c];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = K + 6 + lane + 32 * q;
        if (j <= i) {
          double s = A[i * ld + j];
#pragma unroll
          for (int c = 0; c < 6; ++c) s -= li[c] * pj[q][c];
          A[i * ld + j] = s;
        }
      }
      for (int j = K + 6 + lane + 64; j <= i; j += 32) {  // n > 6 + 64 only
        double s = A[i * ld + j];
#pragma unroll
        for (int c = 0; c < 6; ++c) s -= li[c] * A[j * ld + K + c];
        A[i * ld + j] = s;
      }
    }
    __syncthreads();
  }
  // L^T x = D^-1 y, one column of L a step; z_r in the registers of the lane holding row r.
  if (warp == 0) {
    double z[kRowsPerLane], rdr[kRowsPerLane];
#pragma unroll
    for (int h = 0; h < kRowsPerLane; ++h) {
      const int r = lane + 32 * h;
      rdr[h] = r < n ? rd[r] : 0.0;
      z[h] = r < n ? A[r * ld + n] * rdr[h] : 0.0;
    }
    for (int k = n - 1; k >= 0; --k) {
      const int hk = k >> 5;
      double zk = z[0];
#pragma unroll
      for (int h = 1; h < kRowsPerLane; ++h) zk = hk == h ? z[h] : zk;
      const double xk = __shfl_sync(kFull, zk, k & 31);
#pragma unroll
      for (int h = 0; h < kRowsPerLane; ++h) {
        const int r = lane + 32 * h;
        if (r < k) z[h] -= A[k * ld + r] * rdr[h] * xk;
      }
      if (lane == 0) x[k] = xk;
    }
  }
  __syncthreads();
}

// Shared memory (doubles) of one block for a window of W poses; ops/cuda_ba.smem_bytes is its twin.
__host__ __device__ int smem_doubles(int W) {
  const int n = 6 * W, U = W * (W + 1) / 2 + W, chl = kThreads / W;
  int big = kThreads * kObs;
  if (kThreads * kUnit > big) big = kThreads * kUnit;
  if (n * (n + 1) + U * kUnit > big) big = n * (n + 1) + U * kUnit;
  return big + U * kUnit + chl * kLmk + 2 * W * 16 + 2 * n + 4 + kWarps * 4;
}

__global__ void __launch_bounds__(kThreads, 1)
windowed_ba_kernel(const double* __restrict__ poses_in, const double* __restrict__ points_in,
          const double* __restrict__ obs_uv, const uint8_t* __restrict__ obs_mask, const double* __restrict__ Kmat,
          double* __restrict__ out, double* __restrict__ scratch, int W, int L, int iters, double init_lambda,
          double lambda_up, double lambda_down, double huber, double min_depth, int nf) {
  extern __shared__ double smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const cg::cluster_group cluster = cg::this_cluster();
  const int nblocks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int n = 6 * W;
  const int n_pairs = W * (W + 1) / 2;  // S_off units; then one unit a pose
  const int U = n_pairs + W;
  const int G = kThreads / U;
  const int chl = kThreads / W;  // landmarks a chunk
  const int big = smem_doubles(W) - (U * kUnit + chl * kLmk + 2 * W * 16 + 2 * n + 4 + kWarps * 4);
  double* sbig = smem;               // observation records; the units' staging; then A and the totals
  double* sP = sbig + big;           // U * 36: this block's partial sums (read by every block)
  double* sLm = sP + U * kUnit;      // chl * 12: the chunk's Hll^-1 and bl
  double* sPose = sLm + chl * kLmk;  // W * 16: the poses
  double* sNew = sPose + W * 16;     // W * 16: the step's poses
  double* sDc = sNew + W * 16;       // n: the camera step
  double* sRd = sDc + n;             // n: D^-1 of the system's LDL^T
  double* sCost = sRd + n;           // 4: this block's cost terms (read by every block)
  double* sRed = sCost + 4;          // kWarps * 4
  double* sA = sbig;                 // n x (n + 1)
  double* sT = sbig + n * (n + 1);   // U * 36: the cluster's sums

  double* pts = out + W * 16;  // (L, 3): the landmarks, updated in place
  const int Lb = (L + nblocks - 1) / nblocks;
  const int l0 = min(L, rank * Lb), l1 = min(L, l0 + Lb);
  const int nown = l1 - l0;
  const double fx = Kmat[0], fy = Kmat[4], cx = Kmat[2], cy = Kmat[5];

  // This thread's unit (-1: none) and its replica g.
  const int unit = tid < G * U ? tid % U : -1;
  const int g = tid / U;
  int uw = 0, uv = 0;
  if (unit >= 0 && unit < n_pairs) {
    int u = unit;
    while (u >= W - uw) {
      u -= W - uw;
      ++uw;
    }
    uv = uw + u;
  } else if (unit >= 0) {
    uw = unit - n_pairs;
  }

  for (int q = tid; q < W * 16; q += kThreads) sPose[q] = poses_in[q];
  for (int q = tid; q < nown * 3; q += kThreads) pts[l0 * 3 + q] = points_in[l0 * 3 + q];
  __syncthreads();

  // Cost terms of the own landmarks at (poses, points with a stride), into sCost.
  const auto block_cost = [&](const double* poses, const double* X, int stride) {
    double acc[4] = {0.0, 0.0, 0.0, 0.0};
    for (int o = tid; o < nown * W; o += kThreads) {
      const int l = l0 + o / W, w = o % W;
      const size_t ob = static_cast<size_t>(w) * L + l;
      cost_terms(poses + w * 16, X + static_cast<size_t>(l) * stride, obs_uv[2 * ob], obs_uv[2 * ob + 1],
                 obs_mask[ob] != 0, fx, fy, cx, cy, huber, min_depth, acc);
    }
    block_sum<4>(acc, sRed, warp, lane);
    if (tid == 0)
      for (int i = 0; i < 4; ++i) sCost[i] = acc[i];
  };
  const auto cluster_cost = [&](double (&c)[4]) {
    for (int i = 0; i < 4; ++i) {
      double s = 0.0;
      for (int b = 0; b < nblocks; ++b) s += on_rank(sCost, b)[i];
      c[i] = s;
    }
  };

  double cur[4];
  block_cost(sPose, pts, 3);
  cluster.sync();
  cluster_cost(cur);
  const double cost0 = cur[0] / clamp_min(cur[1], 1.0);
  double cost = cost0, lam = init_lambda;

  for (int it = 0; it < iters; ++it) {
    double acc[kUnit];
#pragma unroll
    for (int j = 0; j < kUnit; ++j) acc[j] = 0.0;

    for (int c0 = 0; c0 < nown; c0 += chl) {
      const int nl = min(chl, nown - c0);
      const int lc = tid / W, w = tid % W;
      double* rec = sbig + tid * kObs;
      // Linearise one observation a thread.
      if (lc < nl) {
        const int l = l0 + c0 + lc;
        const size_t ob = static_cast<size_t>(w) * L + l;
        Linear o;
        linearise(sPose + w * 16, pts + static_cast<size_t>(l) * 3, obs_uv[2 * ob], obs_uv[2 * ob + 1],
                  obs_mask[ob] != 0, fx, fy, cx, cy, huber, min_depth, o);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int k = 0; k < 6; ++k) rec[kJp + i * 6 + k] = o.jp[i][k];
          rec[kWr + i] = o.wgt * o.r[i];
        }
        rec[kWgt] = o.wgt;
        double h[18];
        hcl_of(o, h);
#pragma unroll
        for (int q = 0; q < 18; ++q) rec[kHcl + q] = h[q];
        int q = 0;
#pragma unroll
        for (int k = 0; k < 3; ++k)
#pragma unroll
          for (int m = k; m < 3; ++m)
            rec[kHinv + q++] = o.jl[0][k] * o.wgt * o.jl[0][m] + o.jl[1][k] * o.wgt * o.jl[1][m];
#pragma unroll
        for (int k = 0; k < 3; ++k) rec[kHinv + 6 + k] = o.jl[0][k] * rec[kWr] + o.jl[1][k] * rec[kWr + 1];
      }
      __syncthreads();
      // One landmark a thread: Hll and bl over its views, damped, inverted by the unrolled Cholesky.
      if (tid < nl) {
        double H[6] = {0.0, 0.0, 0.0, 0.0, 0.0, 0.0}, bsum[3] = {0.0, 0.0, 0.0};
        for (int v = 0; v < W; ++v) {
          const double* rv = sbig + (tid * W + v) * kObs + kHinv;
#pragma unroll
          for (int q = 0; q < 6; ++q) H[q] += rv[q];
#pragma unroll
          for (int k = 0; k < 3; ++k) bsum[k] += rv[6 + k];
        }
        const double b[3] = {-bsum[0], -bsum[1], -bsum[2]};
        const double a00 = H[0] + lam * clamp_min(H[0], 1e-6), a11 = H[3] + lam * clamp_min(H[3], 1e-6),
                     a22 = H[5] + lam * clamp_min(H[5], 1e-6);
        const double a10 = H[1], a20 = H[2], a21 = H[4];
        const double eps = 1e-9;
        const double i0 = rsqrt(clamp_min(a00 + eps, 1e-30));
        const double l10 = a10 * i0, l20 = a20 * i0;
        const double i1 = rsqrt(clamp_min(a11 + eps - l10 * l10, 1e-30));
        const double l21 = (a21 - l20 * l10) * i1;
        const double i2 = rsqrt(clamp_min(a22 + eps - l20 * l20 - l21 * l21, 1e-30));
        double* lm = sLm + tid * kLmk;
        double* sc = scratch + static_cast<size_t>(l0 + c0 + tid) * kScratch;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const double e0 = c == 0 ? 1.0 : 0.0, e1 = c == 1 ? 1.0 : 0.0, e2 = c == 2 ? 1.0 : 0.0;
          const double y0 = e0 * i0;
          const double y1 = (e1 - l10 * y0) * i1;
          const double y2 = (e2 - l20 * y0 - l21 * y1) * i2;
          const double x2 = y2 * i2;
          const double x1 = (y1 - l21 * x2) * i1;
          const double x0 = (y0 - l10 * x1 - l20 * x2) * i0;
          lm[c] = x0;  // Hll^-1, row-major: [m][c] at m * 3 + c
          lm[3 + c] = x1;
          lm[6 + c] = x2;
        }
#pragma unroll
        for (int k = 0; k < 3; ++k) lm[9 + k] = b[k];
#pragma unroll
        for (int q = 0; q < kLmk; ++q) sc[3 + q] = lm[q];
      }
      __syncthreads();
      // Hcl Hll^-1, one observation a thread.
      if (lc < nl) {
        const double* lm = sLm + lc * kLmk;
        double hh[18];
#pragma unroll
        for (int k = 0; k < 6; ++k)
#pragma unroll
          for (int c = 0; c < 3; ++c)
            hh[k * 3 + c] = rec[kHcl + k * 3] * lm[c] + rec[kHcl + k * 3 + 1] * lm[3 + c] +
                            rec[kHcl + k * 3 + 2] * lm[6 + c];
#pragma unroll
        for (int q = 0; q < 18; ++q) rec[kHinv + q] = hh[q];
      }
      __syncthreads();
      // The units: every G-th landmark of the chunk, in ascending order.
      if (unit >= 0) {
        for (int m0 = g; m0 < nl; m0 += G) {
          if (unit < n_pairs) {
            const double* a = sbig + (m0 * W + uw) * kObs + kHinv;
            const double* b = sbig + (m0 * W + uv) * kObs + kHcl;
#pragma unroll
            for (int k = 0; k < 6; ++k)
#pragma unroll
              for (int m = 0; m < 6; ++m)
                acc[k * 6 + m] += a[k * 3] * b[m * 3] + a[k * 3 + 1] * b[m * 3 + 1] + a[k * 3 + 2] * b[m * 3 + 2];
          } else {
            const double* r = sbig + (m0 * W + uw) * kObs;
            const double* bl = sLm + m0 * kLmk + 9;
            const double wg = r[kWgt];
            int q = 0;
#pragma unroll
            for (int k = 0; k < 6; ++k)
#pragma unroll
              for (int m = k; m < 6; ++m)
                acc[q++] += r[kJp + k] * wg * r[kJp + m] + r[kJp + 6 + k] * wg * r[kJp + 6 + m];
#pragma unroll
            for (int k = 0; k < 6; ++k) {
              acc[kBc + k] += r[kJp + k] * r[kWr] + r[kJp + 6 + k] * r[kWr + 1];
              acc[kRc + k] += r[kHinv + k * 3] * bl[0] + r[kHinv + k * 3 + 1] * bl[1] + r[kHinv + k * 3 + 2] * bl[2];
            }
          }
        }
      }
      __syncthreads();
    }

    // The block's partial sums: each unit's G threads in order.
    if (unit >= 0) {
#pragma unroll
      for (int j = 0; j < kUnit; ++j) sbig[tid * kUnit + j] = acc[j];
    }
    __syncthreads();
    for (int e = tid; e < U * kUnit; e += kThreads) {
      double s = 0.0;
      for (int r = 0; r < G; ++r) s += sbig[r * U * kUnit + e];
      sP[e] = s;
    }
    cluster.sync();
    // The cluster's sums, blocks in rank order; then the reduced camera system.
    for (int e = tid; e < U * kUnit; e += kThreads) {
      double s = 0.0;
      for (int b = 0; b < nblocks; ++b) s += on_rank(sP, b)[e];
      sT[e] = s;
    }
    __syncthreads();
    for (int r = warp; r < n; r += kWarps) {
      const int w = r / 6, k = r % 6;
      const double* pu = sT + (n_pairs + w) * kUnit;
      for (int c = lane; c <= n; c += 32) {
        double val;
        if (c == n) {
          val = w < nf ? 0.0 : -pu[kBc + k] - pu[kRc + k];
        } else {
          const int v = c / 6, m = c % 6;
          if (w < nf || v < nf) {
            val = r == c ? 1.0 : 0.0;
          } else if (w == v) {
            double h = pu[upper6(min(k, m), max(k, m))];
            if (k == m) h += lam * clamp_min(h, 1e-6);
            val = -sT[pair_unit(w, w, W) * kUnit + k * 6 + m] + h;
          } else if (w < v) {
            val = -sT[pair_unit(w, v, W) * kUnit + k * 6 + m];
          } else {
            val = -sT[pair_unit(v, w, W) * kUnit + m * 6 + k];
          }
          if (r == c) val += 1e-9;
        }
        sA[r * (n + 1) + c] = val;
      }
    }
    __syncthreads();
    ldl_solve(sA, n, sDc, sRd, tid, warp, lane);

    // The step: poses by exp(dc) from the left, the own landmarks by Hll^-1 (bl - Hlc dc).
    if (tid < W) {
      if (tid < nf) {
        for (int j = 0; j < 16; ++j) sNew[tid * 16 + j] = sPose[tid * 16 + j];
      } else {
        exp_times(sDc + tid * 6, sPose + tid * 16, sNew + tid * 16);
      }
    }
    for (int c0 = 0; c0 < nown; c0 += chl) {
      const int nl = min(chl, nown - c0);
      const int lc = tid / W, w = tid % W;
      if (lc < nl) {  // Hlc dc of one observation
        const int l = l0 + c0 + lc;
        const size_t ob = static_cast<size_t>(w) * L + l;
        Linear o;
        linearise(sPose + w * 16, pts + static_cast<size_t>(l) * 3, obs_uv[2 * ob], obs_uv[2 * ob + 1],
                  obs_mask[ob] != 0, fx, fy, cx, cy, huber, min_depth, o);
        double h[18];
        hcl_of(o, h);
        const double* dcw = sDc + w * 6;
#pragma unroll
        for (int m = 0; m < 3; ++m)
          sbig[tid * 3 + m] = h[m] * dcw[0] + h[3 + m] * dcw[1] + h[6 + m] * dcw[2] + h[9 + m] * dcw[3] +
                              h[12 + m] * dcw[4] + h[15 + m] * dcw[5];
      }
      __syncthreads();
      if (tid < nl) {  // one landmark a thread: its views in order, then Hll^-1 (bl - Hlc dc)
        const int l = l0 + c0 + tid;
        const double* X = pts + static_cast<size_t>(l) * 3;
        double* sc = scratch + static_cast<size_t>(l) * kScratch;
        double hd[3] = {0.0, 0.0, 0.0};
        for (int v = 0; v < W; ++v)
#pragma unroll
          for (int m = 0; m < 3; ++m) hd[m] += sbig[(tid * W + v) * 3 + m];
        const double d[3] = {sc[12] - hd[0], sc[13] - hd[1], sc[14] - hd[2]};
#pragma unroll
        for (int m = 0; m < 3; ++m)
          sc[m] = X[m] + (sc[3 + m * 3] * d[0] + sc[3 + m * 3 + 1] * d[1] + sc[3 + m * 3 + 2] * d[2]);
      }
      __syncthreads();
    }

    // The step's cost over the cluster; keep it or not, the same in every block.
    double cand[4];
    block_cost(sNew, scratch, kScratch);
    cluster.sync();
    cluster_cost(cand);
    const double new_cost = cand[0] / clamp_min(cand[1], 1.0);
    const bool ok = new_cost < cost && isfinite(new_cost);
    if (ok) {
      for (int q = tid; q < W * 16; q += kThreads) sPose[q] = sNew[q];
      for (int l = l0 + tid; l < l1; l += kThreads)
        for (int m = 0; m < 3; ++m) pts[static_cast<size_t>(l) * 3 + m] = scratch[static_cast<size_t>(l) * kScratch + m];
      cost = new_cost;
      for (int i = 0; i < 4; ++i) cur[i] = cand[i];
    }
    lam = ok ? lam * lambda_down : lam * lambda_up;
    lam = lam < 1e-9 ? 1e-9 : (lam > 1e6 ? 1e6 : lam);
    __syncthreads();
  }

  if (rank == 0) {
    for (int q = tid; q < W * 16; q += kThreads) out[q] = sPose[q];
    if (tid == 0) {
      double* tail = out + W * 16 + static_cast<size_t>(L) * 3;
      tail[0] = cost0;
      tail[1] = cost;
      tail[2] = sqrt(cur[2] / clamp_min(cur[3], 1.0));
    }
  }
  cluster.sync();  // no block leaves while another may still read its shared memory
}

}  // namespace

// poses: (W, 4, 4), points: (L, 3), obs_uv: (W, L, 2), K: (3, 3), all
// float64; obs_mask: (W, L) bool. out: W * 16 + L * 3 + 3 doubles, the
// poses, the points, then initial cost, final cost and RMS; scratch: L * 15
// doubles. 1 <= W, W (W + 3) / 2 <= 256 and the block's shared memory within
// the card's limit (ops/cuda_ba.plan), 1 <= L, iters >= 0, 1 <= clusters <=
// 8; else the call returns cudaErrorInvalidValue. n_fixed <= 0 holds no
// pose; n_fixed >= W holds them all.
extern "C" int dvo_windowed_ba(const double* poses, const double* points, const double* obs_uv,
                               const uint8_t* obs_mask, const double* K, double* out, double* scratch, int W, int L,
                               int iters, double init_lambda, double lambda_up, double lambda_down, double huber,
                               double min_depth, int n_fixed, int clusters, void* stream) {
  if (W < 1 || L < 1 || iters < 0 || clusters < 1 || clusters > kMaxCluster || W * (W + 3) / 2 > kThreads ||
      sizeof(double) * static_cast<size_t>(smem_doubles(W)) > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const int nf = n_fixed <= 0 ? 0 : (n_fixed > W ? W : n_fixed);
  const size_t smem = sizeof(double) * static_cast<size_t>(smem_doubles(W));
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(windowed_ba_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = clusters;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, windowed_ba_kernel, poses, points, obs_uv, obs_mask, K, out, scratch, W, L, iters,
                           init_lambda, lambda_up, lambda_down, huber, min_depth, nf);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
