"""droplet_visual_odometry_tpu_torch — the PyTorch/CUDA port of droplet_visual_odometry_tpu.

The JAX package beside this one is the reference; every module here sits at
the same relative path as its JAX counterpart and keeps its public layouts,
so a reader finds each function where the reference has it:

  core/        SE(3)/SO(3) math, numpy camera model + torch undistortion
  data/        VOSequence .npz format (shared with the JAX package), renderer
  frontend/    FAST + rBRIEF features, Hamming matcher
  estimation/  batched LO-RANSAC, pose recovery, marker scale, sequence VO
  eval/        ATE/RPE, TUM writers
  ops/         hand-written CUDA kernels (csrc/*.cu), their plain twins, linalg
  backend/     keyframes, loop closure, the PCG pose graph, pose_graph_trajectory
  utils/       ExperimentConfig
  pipeline.py  run_experiment (backends "none" and "pose_graph")

Rules the port keeps:
  * it imports torch and numpy, never jax;
  * a CPU tensor goes to a kernel's plain PyTorch twin, a CUDA tensor to the
    kernel itself or the call raises — there is no fallback and no switch;
  * geometry is float32 at full precision (TF32 off, below); bf16 appears
    only where the reference computes in bf16.
"""

import torch as _torch

# Counterpart of the reference's jax_default_matmul_precision="highest":
# pose chains, essential matrices and the describe steering product (whose
# integer sums are exact only at full f32) must never run in TF32.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
