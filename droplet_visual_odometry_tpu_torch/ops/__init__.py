"""Hand-written CUDA kernels of the port, their plain PyTorch twins, and linalg.

  cuda_fast.fast_score_cuda          csrc/fast_score.cu       (replaces ops/pallas_fast.py)
  cuda_patches.extract_patches_cuda  csrc/extract_patches.cu  (replaces ops/pallas_patches.py)
  cuda_match.match_reductions_cuda   csrc/hamming_match.cu    (replaces ops/pallas_match.py)

Each wrapper runs its plain twin for CPU tensors and its kernel for CUDA
tensors, and raises otherwise; there is no fallback and no switch. Each keeps
a plain integer LAUNCHES counter. build.py compiles the kernels at first use.
"""
