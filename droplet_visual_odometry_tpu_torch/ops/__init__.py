"""Hand-written CUDA kernels of the port, their plain PyTorch twins, and linalg.

  cuda_fast.fast_score_cuda          csrc/fast_score.cu     (replaces ops/pallas_fast.py)
  cuda_describe.describe_cuda        csrc/orb_describe.cu   (replaces ops/pallas_patches.py
                                                             and the steering, bin and pack
                                                             after it in frontend/orb.py)
  cuda_match.match_reductions_cuda   csrc/hamming_match.cu  (replaces ops/pallas_match.py)
  cuda_pcg.pcg_cuda                  csrc/pose_graph_pcg.cu (replaces no TPU kernel: the pose
                                                             graph's op-by-op CG loop,
                                                             cuda_pcg.pcg_plain)
  cuda_ba.run_ba_cuda                csrc/windowed_ba.cu    (replaces no TPU kernel: the windowed
                                                             BA's op-by-op LM loop,
                                                             cuda_ba.run_ba_plain)
  cuda_l2match.l2_match_reductions_cuda
                                     csrc/l2_match.cu       (replaces no TPU kernel: the float
                                                             match over the whole (P, K, K)
                                                             l2_matrix, which the JAX package
                                                             leaves to XLA)

Each wrapper runs its plain twin for CPU tensors and its kernel for CUDA
tensors, and raises otherwise; there is no fallback and no switch. Each keeps
a plain integer LAUNCHES counter. build.py compiles the kernels at first use.
"""
