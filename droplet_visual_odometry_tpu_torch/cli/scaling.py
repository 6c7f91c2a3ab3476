"""Scaling-efficiency report CLI — port of droplet_visual_odometry_tpu/cli/scaling.py,
with the same flags.

    python -m droplet_visual_odometry_tpu_torch.cli.scaling [--devices 1,2,4,8]
        [--pairs-per-device 2] [--ba] [--coordinator host:port --nprocs N --pid I]
        [--platform cpu]

Measures weak-scaling throughput of the data-parallel pair-VO stage (and,
with --ba, distributed Schur-complement BA) over meshes of the world's first
1, 2, 4, 8 ranks, one rank per device. Run one copy per device with the
coordinator flags, or under `torchrun --nproc-per-node N` (its variables
stand in for the flags). The run goes to the card (NCCL) unless `--platform
cpu` (gloo) is given; a missing card raises.

`--spawn N` orchestrates a comparison on one machine: it launches a 1-rank
run and an N-rank run (gloo, a file store in a temporary directory: a real
OS-process boundary) over the SAME total workload, --total-devices x
--pairs-per-device pairs (x --ba-landmarks landmarks), and reports
cross-process efficiency = throughput_Nranks / throughput_1rank. On the card
rank r uses cuda:{r % device_count}, so on one card the N ranks share it and
the number measures the process boundary, not scaling across cards.

`--host-devices` (XLA's virtual CPU devices in the reference) has no
counterpart when one rank is one device: only 1 is accepted.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

# torchrun's variables, which a spawned child must not inherit: its rank and world come from its flags.
_LAUNCH_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


def run_spawn(n_procs: int, total_devices: int, pairs_per_device: int, ba: bool, height: int, width: int,
              ba_landmarks: int = 1024, platform: str | None = None, timeout: float = 600.0) -> int:
    """Launch the 1-rank and n_procs-rank runs as subprocesses over the same
    workload; print the comparison as one JSON line."""
    if total_devices % n_procs:
        raise ValueError(f"--total-devices {total_devices} does not divide over {n_procs} ranks")
    env = {k: v for k, v in os.environ.items() if k not in _LAUNCH_VARS}
    root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = os.pathsep.join([root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    results = {}
    for procs in (1, n_procs):
        share = total_devices // procs  # this run's workload per rank, in the reference's device units
        with tempfile.TemporaryDirectory() as tmp:
            cmd = [
                sys.executable, "-m", "droplet_visual_odometry_tpu_torch.cli.scaling",
                "--devices", str(procs), "--pairs-per-device", str(share * pairs_per_device),
                "--height", str(height), "--width", str(width),
                "--coordinator", f"file://{os.path.join(tmp, 'store')}", "--nprocs", str(procs),
                "--backend", "gloo", "--json",
            ] + (["--platform", platform] if platform else []) \
              + (["--ba", "--ba-landmarks", str(share * ba_landmarks)] if ba else [])
            children = [subprocess.Popen(cmd + ["--pid", str(pid)], env=env, stdout=subprocess.PIPE,
                                         stderr=subprocess.PIPE) for pid in range(procs)]
            outs = []
            try:
                for c in children:
                    out, err = c.communicate(timeout=timeout)
                    outs.append((c.returncode, out, err))
            finally:
                for c in children:
                    if c.poll() is None:
                        c.kill()
                        c.wait()
        for rc, out, err in outs:
            if rc != 0:
                print(err.decode()[-2000:], file=sys.stderr)
                raise RuntimeError(f"{procs}-rank child failed rc={rc}")
        # The coordinator (rank 0) prints the JSON report.
        results[procs] = json.loads(outs[0][1].decode().strip().splitlines()[-1])
        print(f"spawn: {procs}-rank run done", file=sys.stderr, flush=True)

    report = {
        "meta": {
            "mode": f"cross-process: 1 rank vs {n_procs} ranks over the same workload (gloo, a file store, "
                    f"real OS-process boundary, platform {platform or 'cuda'})",
            "workload": f"{total_devices * pairs_per_device} pairs ({height}x{width})"
                        + (f" + distributed Schur BA ({total_devices * ba_landmarks} landmarks)" if ba else ""),
        },
        "workloads": {},
    }
    for name in results[1]:
        one = [p for p in results[1][name] if p["n_devices"] == 1]
        many = [p for p in results[n_procs].get(name, []) if p["n_devices"] == n_procs]
        if not one or not many:
            continue
        report["workloads"][name] = {
            "1proc": one[0],
            f"{n_procs}proc": many[0],
            "cross_process_efficiency": round(many[0]["throughput"] / one[0]["throughput"], 4),
        }
    print(json.dumps(report))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=str, default=None, help="comma list, e.g. 1,2,4,8")
    ap.add_argument("--pairs-per-device", type=int, default=2)
    ap.add_argument("--height", type=int, default=96)
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--ba", action="store_true", help="also measure distributed BA")
    ap.add_argument("--ba-landmarks", type=int, default=256,
                    help="landmarks per device for the BA workload (larger = more compute per collective)")
    ap.add_argument("--coordinator", type=str, default=None, help="host:port, or an init URL (file://...)")
    ap.add_argument("--nprocs", type=int, default=None)
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--json", action="store_true", help="machine-readable output")
    ap.add_argument("--platform", default=None, choices=["cpu", "cuda"],
                    help="'cpu' runs on the CPU with gloo; the default is the card")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend (default: nccl on the card, gloo on the CPU; --spawn uses gloo)")
    ap.add_argument("--host-devices", type=int, default=None,
                    help="the reference's virtual host device count; one rank is one device here, so only 1")
    ap.add_argument("--spawn", type=int, default=None,
                    help="orchestrate: compare a 1-rank run vs an N-rank gloo run on the same workload")
    ap.add_argument("--total-devices", type=int, default=8)
    args = ap.parse_args(argv)

    if args.host_devices not in (None, 1):
        ap.error(f"--host-devices {args.host_devices}: one rank is one device in this port; "
                 "run N ranks with --spawn N, the coordinator flags or torchrun instead")
    if args.spawn:
        return run_spawn(args.spawn, args.total_devices, args.pairs_per_device, args.ba, args.height, args.width,
                         platform=args.platform)

    from droplet_visual_odometry_tpu_torch.parallel import launch

    device = args.platform or "cuda"
    launch.initialize(args.coordinator, args.nprocs, args.pid, device=device, backend=args.backend)
    try:
        counts = [int(x) for x in args.devices.split(",")] if args.devices else None
        reports = {"pair_vo": launch.measure_scaling_pair_vo(counts, pairs_per_device=args.pairs_per_device,
                                                             height=args.height, width=args.width, device=device)}
        if args.ba:
            reports["distributed_ba"] = launch.measure_scaling_ba(counts, landmarks_per_device=args.ba_landmarks,
                                                                  device=device)
        if launch.is_coordinator():
            if args.json:
                print(json.dumps({name: [vars(p) for p in pts] for name, pts in reports.items()}))
            else:
                for name, pts in reports.items():
                    print(launch.format_report(name, pts))
    finally:
        launch.shutdown()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
