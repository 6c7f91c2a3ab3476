"""pipeline_host_ms.seq: per sequence, the run_experiment span minus its
VO and backend child spans (upload, undistortion remap, anchoring, ATE,
TUM files), in ms; the median over the window's sequences."""

import numpy as np

CHILDREN = ("run_sequence", "run_sequence_checkpointed", "pose_graph_trajectory")


def read(run):
    t = run.tracer
    own = [(s.t1 - s.t0 - sum(c.t1 - c.t0 for c in t.children(i) if c.name in CHILDREN)) * 1e3
           for i, s in t.named("run_experiment")]
    return float(np.median(own)) if own else None
