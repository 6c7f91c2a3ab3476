"""A kernel's share of its roofline at the cell's own shapes.

The inputs are those of one VO program of the cell (its frames, the
pyramid levels, each level's keypoint patches at K = 512, the pairs'
descriptor sets), made by the plain reference from the cell's raw frames.
roofline/<kernel>.py names the program's entry that runs the kernel and
counts each call's bytes and operations from the shapes; the time is the
kernel alone (kerneltime.device_ms). An entry the program no longer has
gives no reading.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from vobench import cells, kerneltime

K = 512  # keypoints per frame on the VO path


def frontend_inputs(frames_u8: np.ndarray, camera, device) -> dict:
    """Per pyramid level: the level, its bf16 blur and its keypoints' patch
    origins; and the descriptor sets of the consecutive pairs."""
    from plainref.frontend import fast, features, filters
    from plainref.frontend.orb import patch_origins
    from plainref.pipeline import make_preprocessor

    frames = make_preprocessor(camera, device)(frames_u8).contiguous()
    n, h0, w0 = frames.shape
    shapes = features.level_shapes(h0, w0, features.N_LEVELS, features.SCALE_FACTOR)
    budgets = features.level_budgets(K, features.N_LEVELS, features.SCALE_FACTOR)
    levels, blurs, origins = [], [], []
    level = frames
    for l, (lh, lw) in enumerate(shapes):
        if l > 0:
            level = filters.resize_bilinear(level, lh, lw).contiguous()
        score = torch.cat([fast.fast_score_plain(level[i:i + features.BLOCK], 20.0, 9)
                           for i in range(0, n, features.BLOCK)])
        kps = fast.select_topk_rows(fast.nms3x3(score), budgets[l])
        levels.append(level)
        blurs.append(filters.gaussian_blur(level, 2.0, 4, compute_dtype=torch.bfloat16).contiguous())
        origins.append(patch_origins(kps.xy, lh, lw))
    feats = features.detect_and_describe_batch(frames, k=K)
    pairs = tuple(t.contiguous() for t in (feats.desc[:-1], feats.desc[1:], feats.valid[:-1], feats.valid[1:]))
    return dict(levels=levels, blurs=blurs, origins=origins, pairs=pairs)


def roofline_pct(kernel: str, inputs: dict) -> float | None:
    """100 x (summed least time) / (summed kernel time) over the kernel's
    calls at these inputs; None off a CUDA card or when the program has no
    such entry."""
    if inputs["levels"][0].device.type != "cuda":
        return None
    roof = cells.module("roofline", kernel)
    mod_name, fn_name = roof.ENTRY
    try:
        fn = getattr(importlib.import_module(mod_name), fn_name)
    except (ImportError, AttributeError):
        return None
    least = taken = 0.0
    for args, n_bytes, n_ops, ops_per_s in roof.calls(inputs):
        least += kerneltime.bound_ms(n_bytes, n_ops, ops_per_s)[0]
        taken += kerneltime.device_ms(lambda: fn(*args))
    return 100.0 * least / taken
