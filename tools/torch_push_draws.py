"""OnlineVO push latency by where the push's RANSAC draws are made, on one
NVIDIA GPU.

    python tools/torch_push_draws.py [--root DIR] [--pushes N] [--engines E]

Imports the port from the checkout DIR (default: the one holding this file;
a checkout whose groundtruth lacks frame_detections, from before the port's
own bench harness was retired, is not supported), renders chip_smoke.py's
workload (SEQ_CONFIG: 24 frames of 1440x1080) and pushes it in ping-pong
with its marker detections, host uint8 frames as the live node gets them:
one pass to arm an engine and capture its graph, then N pushes timed one
by one (host clock; a push ends with its fetch). First the checkout's
default engine alone ("default": the first engine of the process, the
figure to compare across checkouts); then,
where the checkout has both forms, E engines of each with their timed
pushes interleaved push by push (the engines' order reversed every other
push), so both forms see the same host and card, and no one engine's
settled level decides the comparison. Forms:
  ring    (b) the engine's default (stream.ring_draws): the draws of
          fold_in(PRNGKey(0), step) made for DRAW_BLOCK future pushes at
          once (one batched threefry call), each push copying its row into
          the graph's static buffers; a push whose step starts a new block
          makes the block first ("refill");
  graph   (a) the same draws made inside the captured graph from a
          device-resident step counter that the graph increments
          (InGraphDrawsVO below: no host work for the draws);
  parent  for a checkout whose port has no batched threefry draws (before
          the reference's draws became the default): its default engine,
          drawing from a torch.Generator outside the graph.
The graph form's pushes are held bit for bit against the ring form's (the
same draws). Prints one JSON line: for each form its pooled median, p99,
p99.9, max and mean push ms, each engine's median, and the pushes at the
ring's refill steps in both forms; the draws' wall for one push and for a
block; the card's name and power limit. The default N (552, 12 passes)
puts two refills inside each ring engine's timed pushes. Compare
checkouts in one call, in turns (parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
from chip_smoke import SEQ_CONFIG  # noqa: E402  the workload, as chip_smoke renders it


def in_graph_draws_engine():
    """OnlineVO with the push's draws made inside its captured graph (form
    a): the graph increments a device-resident step counter and draws from
    fold_in(PRNGKey(seed), counter); the counter is set to the step before
    the capture push once the capture is done. Outside the capture (the
    eager step) it draws as the base class does. The static draw buffers
    the base class fills before each replay are left unread: pass draws=
    that hands out fixed tensors, so no ring is made."""
    import torch

    from droplet_visual_odometry_tpu_torch import stream
    from droplet_visual_odometry_tpu_torch.utils import threefry

    class InGraphDrawsVO(stream.OnlineVO):
        _capturing = False

        def _capture(self, frame):
            self._key = threefry.prng_key(self.seed, self.device)
            self._counter = torch.zeros((), dtype=torch.int64, device=self.device)
            self._capturing = True
            try:
                super()._capture(frame)
            finally:
                self._capturing = False
            self._counter.fill_(self._step - 1)

        def _step_body(self, frame, feats_prev, pc, cc, mv, u_hyp, u_lo):
            if self._capturing:  # the warm-up run and the capture
                self._counter.add_(1)
                u_hyp, u_lo = threefry.ransac_uniforms(threefry.fold_in(self._key, self._counter)[None],
                                                       self.cfg.ransac)
            return super()._step_body(frame, feats_prev, pc, cc, mv, u_hyp, u_lo)

    return InGraphDrawsVO


def summary(ms: list[float]) -> dict:
    ms = np.asarray(ms)
    return dict(median_ms=float(np.median(ms)), p99_ms=float(np.quantile(ms, 0.99)),
                p999_ms=float(np.quantile(ms, 0.999)), max_ms=float(ms.max()), mean_ms=float(ms.mean()),
                n_pushes=len(ms))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--pushes", type=int, default=552, help="timed pushes per engine")
    ap.add_argument("--engines", type=int, default=2, help="engines per form")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch

    import droplet_visual_odometry_tpu_torch as pkg
    from droplet_visual_odometry_tpu_torch import groundtruth, stream
    from droplet_visual_odometry_tpu_torch.data import synthetic
    from droplet_visual_odometry_tpu_torch.estimation.vo import VOConfig
    from droplet_visual_odometry_tpu_torch.utils import threefry

    if not torch.cuda.is_available():
        raise SystemExit("a CUDA device is required")
    if not os.path.abspath(pkg.__file__).startswith(os.path.abspath(args.root)):
        raise SystemExit(f"imported {pkg.__file__}, not the port under {args.root}")
    seq = synthetic.render_sequence(synthetic.SyntheticConfig(**SEQ_CONFIG))
    n = len(seq)
    order = list(range(n)) + list(range(n - 2, 0, -1))
    if not np.all(seq.marker_present):
        raise SystemExit("every frame of the workload must show its marker")
    det = [groundtruth.frame_detections(seq, i) for i in range(n)]
    cfg = VOConfig()

    def warm_engine(engine=stream.OnlineVO, **kw):
        vo = engine(np.asarray(seq.camera.K), seq.real_marker_length, cfg=cfg, seed=0,
                    gt_cfg=groundtruth.GroundTruthConfig(use_base_link=False), device="cuda", **kw)
        vo.push(0.0, seq.frames[0], det[0])
        for k, i in enumerate(order):
            vo.push(float(k + 1), seq.frames[i], det[i])
        return vo

    def run(engines: dict[str, list]) -> tuple[dict, dict]:
        """Timed pushes of every engine, interleaved push by push in
        alternating order; per form: the pooled summary, each engine's
        median, the pushes at the ring's refill steps; and the rels."""
        flat = [(form, e) for form, es in engines.items() for e in range(len(es))]
        lats = {key: [] for key in flat}
        refill = {key: [] for key in flat}
        rels = {key: [] for key in flat}
        for k in range(args.pushes):
            i = order[k % len(order)]
            for form, e in (flat if k % 2 == 0 else flat[::-1]):
                vo = engines[form][e]
                t0 = time.perf_counter()
                res = vo.push(float(1000 + k), seq.frames[i], det[i])
                dt = (time.perf_counter() - t0) * 1e3
                lats[form, e].append(dt)
                rels[form, e].append(res.rel)
                if hasattr(stream, "DRAW_BLOCK") and vo._step > 1 and (vo._step - 1) % stream.DRAW_BLOCK == 0:
                    refill[form, e].append(dt)
        stats = {}
        for form, es in engines.items():
            keys = [(form, e) for e in range(len(es))]
            stats[form] = summary([t for key in keys for t in lats[key]])
            stats[form]["engine_median_ms"] = [float(np.median(lats[key])) for key in keys]
            stats[form]["refill_step_ms"] = [t for key in keys for t in refill[key]]
        return stats, {key: np.stack(r) for key, r in rels.items()}

    def wall_ms(fn, reps=20):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    out = {"root": os.path.abspath(args.root)}
    change = hasattr(threefry, "ransac_uniforms")
    out["default_form"] = "ring" if change else "parent"
    out["default"] = run({"default": [warm_engine()]})[0]["default"]
    if change:
        key = threefry.prng_key(0, "cuda")
        steps = torch.arange(1, 1 + stream.DRAW_BLOCK, device="cuda")
        out["draws_ms_one_push"] = wall_ms(lambda: threefry.ransac_uniforms(threefry.fold_in(key, 7)[None], cfg.ransac))
        out["draws_ms_block"] = wall_ms(lambda: threefry.ransac_uniforms(threefry.fold_in(key, steps), cfg.ransac))
        fixed = threefry.ransac_uniforms(key[None], cfg.ransac)
        graph = in_graph_draws_engine()
        stats, rels = run({"ring": [warm_engine() for _ in range(args.engines)],
                           "graph": [warm_engine(graph, draws=lambda step: fixed) for _ in range(args.engines)]})
        out.update(stats, block=stream.DRAW_BLOCK)
        for e in range(args.engines):
            if not np.array_equal(rels["graph", e], rels["ring", e]):
                raise AssertionError(f"engine {e}: the graph form's pushes differ from the ring form's")
        out["graph_equals_ring"] = True
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    out["card"] = smi
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
