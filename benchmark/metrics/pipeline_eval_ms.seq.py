"""pipeline_eval_ms.seq: per sequence, the host walls of the program's
evaluation spans (`pipeline.anchor`: ground truth and anchoring;
`pipeline.metrics`: inverses, ATE/RPE, relative poses; `pipeline.tum`: the
six TUM files), in ms; the median over the window's sequences."""

from vobench import programspans

NAMES = ("pipeline.anchor", "pipeline.metrics", "pipeline.tum")


def read(run):
    return programspans.median_per_sequence(run, lambda g: programspans.host_ms(g, NAMES))
