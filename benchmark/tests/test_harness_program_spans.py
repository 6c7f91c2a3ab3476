"""The readers of the program's own spans (vobench/programspans.py and the
eight metrics that read it) on the tiny harness's CPU runs, and on a
program without the recorder."""

import sys
import types

import pytest
from harness_tiny import REPO, drive

from vobench import cells

# The readers of the program's spans, and those a CPU run can feed: host
# walls and counts (device intervals and in-graph stages exist on the card only).
READERS = ("upload_ms.seq", "pipeline_eval_ms.seq", "vo_frontend_ms_per_frame.seq", "vo_solver_ms_per_frame.seq",
           "chunk_exposed_ms.seq", "backend_host_ms.seq", "pcg_live_iters.seq", "verify_yield_pct.seq")
ON_CPU = ("pipeline_eval_ms.seq", "backend_host_ms.seq", "pcg_live_iters.seq", "verify_yield_pct.seq")


def test_entries_read_program_spans():
    bench = cells.spec(REPO)
    entries = [m for m in bench["per_layer"] if m["name"] in READERS]
    assert len(entries) == len(READERS)
    for m in entries:
        assert m["source"] == "program_span" and m["moves"] == "seq_fps" and m["workloads"]
        assert callable(cells.module("metrics", m["name"]).read)


@pytest.mark.parametrize("cell", ["tiny_cam.offline_t", "tiny_cam.stream_t"])
def test_readers_on_a_cpu_run(tiny_root, cell):
    """A traced CPU run of a tiny cell with the eight metrics listed for it:
    the host walls and counts read finite and in range; the device ones
    find nothing on the CPU and are left out."""
    body = f"""
from vobench import cells
bench = cells.spec({tiny_root!r})
for name in {READERS!r}:
    bench["per_layer"].append(dict(name=name, unit="u", better="lower", source="program_span", layer="t",
                                   moves="seq_fps", workloads=[{cell!r}]))
res, lines = run.run_cell({cell!r}, 2**31 + 11, 0.5, True, device="cpu", workers=2, bench=bench)
print(json.dumps(res))
"""
    res = drive(tiny_root, body)
    assert res["correct"] is True
    got = {k: v["value"] for k, v in res["metrics"].items() if k in READERS}
    assert sorted(got) == sorted(ON_CPU)
    assert got["pipeline_eval_ms.seq"] > 0 and got["backend_host_ms.seq"] > 0
    assert 0 < got["pcg_live_iters.seq"] <= 100
    assert 0 < got["verify_yield_pct.seq"] <= 100


def test_readers_without_the_recorder(monkeypatch):
    """A program whose utils/profiling has no snapshot (the parent of the
    recorder): every reader returns None and raises nothing."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from droplet_visual_odometry_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    run = types.SimpleNamespace(window=types.SimpleNamespace(t0=0.0, t1=1.0), cache={})
    for name in READERS:
        assert cells.module("metrics", name).read(run) is None, name
