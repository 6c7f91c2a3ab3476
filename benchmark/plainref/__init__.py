"""The benchmark's plain reference: what decides `correct`.

A frozen copy of the port's op-by-op path as plain torch and numpy (the
ORB frontend, the match, LO-RANSAC with the reference's threefry draws, the
marker scale, the pose chain, the streamed chunk loop and the pose-graph
backend), with each CUDA kernel replaced by its plain twin and each
captured program run op by op. It imports nothing of the program under
test and nothing of the JAX package, and takes nothing the program made:
it undistorts, detects, describes, matches and solves again from the raw
frames that the benchmark hands to both sides.

Geometry is float32 with TF32 off, as the configurations state; the
lower-precision control turns TF32 on (vobench/compare.py).
"""

import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
