"""backend_ms.seq: the pose_graph_trajectory span (keyframes, retrieval,
verification, the pose-graph optimisation), in ms; the median over the
window's sequences."""

import numpy as np


def read(run):
    spans = [(s.t1 - s.t0) * 1e3 for _, s in run.tracer.named("pose_graph_trajectory")]
    return float(np.median(spans)) if spans else None
