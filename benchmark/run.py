"""One run of one cell of the port's benchmark.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. Set-up renders the cell's inputs from the
seed, loads the kernels from the package's build directory (building them
there on a checkout's first run) and makes one warm pass, which captures
every program the window replays. Then the window runs for `--seconds`,
the reference decides `correct`, and the last line of standard output is
one JSON object: `correct`, `attempted`, `failed`, `metrics` (the cell's
end-to-end metrics, or with `--trace 1` its per-layer metrics read from a
traced window), `device`, and with `--trace 1` `breakdown`, then `checks`,
each number compared with its limit. The same numbers are the last lines
of standard error.

The run needs the cell's count of CUDA cards and the package
droplet_visual_odometry_tpu_torch in the checkout; without either it
exits with a code other than 0 and prints no result, as it does when
jax, jaxlib, flax or the JAX package droplet_visual_odometry_tpu is
loaded in this process once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
for p in (HERE, REPO):
    if p not in sys.path:
        sys.path.insert(0 if p == HERE else 1, p)
# Nothing heavier than the standard library is imported at the top: the
# renderer's worker processes import this module again when they start.
# One host thread for numpy's and torch's CPU pools: the host work between
# device calls is small, and a run that contends with itself spreads.
for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
    os.environ.setdefault(var, "1")

PROGRAM = "droplet_visual_odometry_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "droplet_visual_odometry_tpu")


class RunRefused(Exception):
    """A run that must print no result (exit code 2)."""


@dataclasses.dataclass
class Run:
    """What a per-layer metric reader reads."""

    cell: str
    config: dict
    traffic: dict
    driver: object
    state: object
    window: object
    tracer: object  # vobench.spans.Tracer
    timeline: object  # vobench.trace.Timeline, or None without a device trace
    device: object  # torch.device
    cache: dict = dataclasses.field(default_factory=dict)

    def kernel_inputs(self) -> dict:
        from vobench import kernels

        if "kernel_inputs" not in self.cache:
            self.cache["kernel_inputs"] = kernels.frontend_inputs(
                self.driver.kernel_frames(self.state), self.state.seq.clip.camera, self.device)
        return self.cache["kernel_inputs"]


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is jax, jaxlib, flax or the JAX package."""
    return sorted({m for m in sys.modules if m.partition(".")[0] in FORBIDDEN})


def check_program() -> None:
    """The port must come from this checkout."""
    try:
        pkg = __import__(PROGRAM)
    except ImportError as e:
        raise RunRefused(f"{PROGRAM} cannot be imported: {e}") from e
    where = os.path.dirname(os.path.abspath(pkg.__file__))
    if os.path.dirname(where) != REPO:
        raise RunRefused(f"{PROGRAM} was imported from {where}, not from the checkout {REPO}")


def run_cell(cell: str, seed: int, seconds: float, traced: bool, device="cuda", workers: int | None = None,
             t_start: float | None = None, bench: dict | None = None) -> tuple[dict, list[str]]:
    """The result object of one run, and the lines for standard error: the
    driver's notes, then one line per number compared."""
    import torch

    from vobench import cells, spans, trace
    from vobench.compare import judge

    t_start = time.perf_counter() if t_start is None else t_start
    bench = bench or cells.spec()
    wl = cells.workload(bench, cell)
    device = torch.device(device)
    if device.type == "cuda":
        torch.set_num_threads(1)
        if not torch.cuda.is_available():
            raise RunRefused("torch.cuda.is_available() is false")
        if torch.cuda.device_count() < int(wl["chips"]):
            raise RunRefused(f"{torch.cuda.device_count()} CUDA devices; the cell needs {wl['chips']}")
    check_program()
    config = cells.config(bench, wl["config"])
    traffic = cells.traffic(wl["traffic"])
    driver = cells.module("drivers", traffic["driver"])
    limits = cells.limits(cell)

    state = driver.setup(config, traffic, seed, device, workers)
    try:
        tracer = timeline = None
        if traced:
            tracer = spans.Tracer(device)
            driver.trace_targets(tracer)
            dtrace = None
            if device.type == "cuda":
                dtrace = trace.DeviceTrace(device, traffic.get("profiler", True), traffic.get("profile_seconds"))
                tracer.after_call.append(dtrace.after_call)
                dtrace.start(time.perf_counter)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        setup_s = time.perf_counter() - t_start
        win = driver.run_window(state, seconds, tracer)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
        if hasattr(driver, "release"):  # the readers and the reference run without the program's state
            driver.release(state)
        if traced:
            tracer.uninstall()
            if dtrace:
                kernels = dtrace.stop()
                timeline = trace.timeline(kernels, tracer.replay_intervals_ms(dtrace.ref),
                                          (win.t0, dtrace.host_end or win.t1), tracer.spans, dtrace.host_ref)
        failed = [c for c in win.calls if c.error is not None]
        for c in failed[:3]:
            print(f"call {c.index} failed:\n{c.error}", file=sys.stderr)

        if traced:
            run = Run(cell, config, traffic, driver, state, win, tracer, timeline, device)
            metrics = {}
            for m in cells.per_layer(bench, cell):
                v = cells.module("metrics", m["name"]).read(run)
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        else:
            e2e = driver.end_to_end(state, win)
            metrics = {}
            for m in cells.end_to_end(bench, cell):
                v = {"setup_s": setup_s, "device_mem_gib": peak / 2**30}.get(m["name"], e2e.get(m["name"]))
                if v is not None and math.isfinite(v):
                    metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

        notes = driver.notes(state, win) if hasattr(driver, "notes") else []
        out = driver.outputs(state, win)
        ref = driver.reference_outputs(state, out)
        numbers = driver.numbers(state, out, ref)
    finally:
        state.close()
    correct, lines = judge(numbers, limits)
    correct = correct and not failed and bool(win.calls)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(wl["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(win.calls), "failed": len(failed), "metrics": metrics,
              "device": dev}
    if timeline is not None:
        dev["busy_s"] = timeline.busy_s
        dev["window_s"] = timeline.window_s
        result["breakdown"] = {"device_ops": timeline.device_ops, "idle_gaps": timeline.idle_gaps}
    finite = lambda v: v if v is not None and math.isfinite(v) else None
    result["checks"] = {name: {"value": finite(numbers.get(name)), "limit": lim["limit"]}
                        for name, lim in limits.items()}
    return result, notes + lines


def main(argv=None) -> int:
    from vobench import kerneltime

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        result, lines = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t_start=T_START)
    except RunRefused as e:
        print(f"run refused: {e}", file=sys.stderr)
        return 2
    card = kerneltime.card()
    print(f"card {card['name']}, power limit {card['power_limit']}", file=sys.stderr)
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
