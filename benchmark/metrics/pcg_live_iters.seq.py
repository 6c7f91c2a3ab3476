"""pcg_live_iters.seq: the CG iterations that did work in a Gauss-Newton
step of the pose graph (the count `live_iters` of each `pg.step` span: the
steps whose stop flag was set, out of PoseGraphConfig.cg_iters issued),
the mean over the window's GN steps."""

from vobench import programspans


def read(run):
    steps = [r.attrs["live_iters"] for r in programspans.records(run) or () if r.name == "pg.step"]
    return sum(steps) / len(steps) if steps else None
