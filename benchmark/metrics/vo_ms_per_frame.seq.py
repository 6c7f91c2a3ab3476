"""vo_ms_per_frame.seq: the spans of run_sequence or
run_sequence_checkpointed (the VO program in memory or chunked) over the
frames they ran, in ms a frame, over the whole window."""


def read(run):
    t = run.tracer
    vo = [s for name in ("run_sequence", "run_sequence_checkpointed") for _, s in t.named(name)]
    frames = sum(s.info.get("frames", 0) for s in vo)
    return sum(s.t1 - s.t0 for s in vo) * 1e3 / frames if frames else None
