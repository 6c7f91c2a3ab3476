"""push_host_pct.push: the share, in %, of the pushes' summed wall that
lies outside the device spans of their graph replays (CUDA events around
each replay)."""


def read(run):
    t = run.tracer
    pushes = {i: s for i, s in t.named("push")}
    if not pushes or not t.replays:
        return None
    wall = sum(s.t1 - s.t0 for s in pushes.values())
    device = sum(r.start.elapsed_time(r.end) / 1e3 for r in t.replays if r.span in pushes)
    return 100.0 * (wall - device) / wall
