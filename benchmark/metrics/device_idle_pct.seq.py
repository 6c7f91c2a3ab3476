"""device_idle_pct.seq: 100 x (1 - device-busy time / window wall), the
busy time the union of the graph replays (CUDA events) and the kernels
launched outside graphs (torch.profiler)."""


def read(run):
    tl = run.timeline
    if tl is None or tl.window_s <= 0:
        return None
    return 100.0 * (1.0 - tl.busy_s / tl.window_s)
