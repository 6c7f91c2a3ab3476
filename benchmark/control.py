"""The two readings that a cell's correctness limits are set from.

    python3 benchmark/control.py --workload <cell> --seeds <n> ... \\
        --control-seeds <n> ... --seconds <s> [--out FILE]

For each of `--seeds`: set-up as a run makes it, a window of `--seconds`
at the cell's load, and the numbers the run compares (the program against
the plain reference): their largest over the seeds is the lower reading.
For each of `--control-seeds`: the same set-up and window, then the
control (the reference in the program's place with TF32 on, the nearest
precision below the configurations' float32) held to the same numbers:
their smallest is the upper reading. One process reads them all. Prints
one JSON object; with --out also writes it there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]

# Only the standard library at the top: the renderer's workers import this module again.


def readings(cell: str, seeds: list[int], control_seeds: list[int], seconds: float, device="cuda",
             workers: int | None = None, bench: dict | None = None) -> dict:
    import numpy as np
    import torch

    from vobench import cells, scene

    bench = bench or cells.spec()
    wl = cells.workload(bench, cell)
    config = cells.config(bench, wl["config"])
    traffic = cells.traffic(wl["traffic"])
    driver = cells.module("drivers", traffic["driver"])
    rows = {"program": {}, "control": {}}
    # Every seed runs over the configuration's one clip: render it once.
    make, clips = scene.make_sequence, []

    def make_once(c, t, w=None):
        if not clips:
            clips.append(make(c, t, w))
        return clips[0]
    scene.make_sequence = make_once
    for kind, seed_list in (("program", seeds), ("control", control_seeds)):
        for seed in seed_list:
            t0 = time.perf_counter()
            state = driver.setup(config, traffic, seed, device, workers)
            try:
                win = driver.run_window(state, seconds)
                out = driver.outputs(state, win)
                ref = driver.reference_outputs(state, out)
                shown = out if kind == "program" else driver.control_outputs(state, out)
                nums = driver.numbers(state, shown, ref)
            finally:
                state.close()
            nums["calls"] = len(win.calls)
            nums["failed"] = sum(c.error is not None for c in win.calls)
            nums["seconds"] = time.perf_counter() - t0
            rows[kind][str(seed)] = nums
            print(kind, seed, json.dumps(nums), file=sys.stderr, flush=True)
    names = [k for k in next(iter(rows["program"].values())) if k not in ("calls", "failed", "seconds")]
    summary = {}
    for n in names:
        prog = [r[n] for r in rows["program"].values()]
        ctrl = [r[n] for r in rows["control"].values()]
        summary[n] = {"lower": float(np.max(prog)) if prog else None,
                      "upper": float(np.min(ctrl)) if ctrl else None}
    return {"cell": cell, "device": torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu",
            "summary": summary, "rows": rows}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    res = readings(args.workload, args.seeds, args.control_seeds, args.seconds)
    text = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(json.dumps(res["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
