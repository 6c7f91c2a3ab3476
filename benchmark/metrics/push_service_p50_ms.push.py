"""push_service_p50_ms.push: the median over the window's pushes of the
push span, from call to return, in ms (the median beside the tail)."""

import numpy as np


def read(run):
    spans = [(s.t1 - s.t0) * 1e3 for _, s in run.tracer.named("push")]
    return float(np.median(spans)) if spans else None
