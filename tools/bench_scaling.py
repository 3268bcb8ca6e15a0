#!/usr/bin/env python
"""Scenario-DP scaling sweep (BASELINE config 5 instrumentation).

Measures batched MPC solve throughput (solves/s) as the scenario count
grows over the available device mesh, and weak-scaling efficiency across
mesh sizes. Runs anywhere:

- one accelerator: amortization curve (B=1 .. 512 on one device);
- virtual CPU mesh (XLA_FLAGS=--xla_force_host_platform_device_count=8
  + --cpu): validates the sharded path and gives a CPU weak-scaling curve;
- several hosts: same script, `jax.distributed.initialize` first.

Usage: python tools/bench_scaling.py [--cpu] [--max-b 512] [--iters 50]
"""
import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache  # noqa: E402

ensure_compile_cache()


def process_sweep(counts, b_per_dev, iters, steps, devices_per_proc, out):
    """Weak-scaling efficiency across 1..N localhost PROCESSES (a
    multi-host proxy on one machine): each count spawns that many
    jax.distributed CPU processes, runs a fixed scenarios-per-device
    batched-MPC loop, and records solves/s/device + launch-sync overhead.
    Emits the curve to ``out`` (JSON). Every worker runs on the host CPU
    (tools/_scaling_worker.py forces it), so no worker opens the GPU."""
    import shutil
    import socket
    import subprocess
    import tempfile

    here = os.path.dirname(os.path.abspath(__file__))
    worker = os.path.join(here, "_scaling_worker.py")
    # Pin each worker to one core: an XLA CPU device otherwise spreads its
    # op over the host's thread pool, so unpinned workers contend and the
    # curve measures host oversubscription instead of framework overhead.
    taskset = shutil.which("taskset")
    ncores = os.cpu_count() or 1
    def run_workers(nproc, mode):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        res = os.path.join(tempfile.mkdtemp(), "r.json")
        t_spawn = time.time()
        procs = [
            subprocess.Popen(
                ([taskset, "-c", str(pid % ncores)] if taskset else [])
                + [sys.executable, worker, str(pid), str(nproc), str(port),
                   str(devices_per_proc), str(b_per_dev), str(iters),
                   str(steps), res, repr(t_spawn), mode],
                cwd=os.path.join(here, ".."),
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
            for pid in range(nproc)
        ]
        logs = [p.communicate(timeout=900)[0].decode() for p in procs]
        for p, lg in zip(procs, logs):
            if p.returncode != 0:
                print(lg[-2000:], file=sys.stderr)
                raise RuntimeError(f"worker failed (nproc={nproc}, {mode})")
        if mode == "solo":
            total = 0.0
            for pid in range(nproc):
                with open(f"{res}.{pid}") as f:
                    total += json.load(f)["solves_per_sec"]
            return {"solves_per_sec": round(total, 1)}
        with open(res) as f:
            return json.load(f)

    rows = []
    for nproc in counts:
        row = run_workers(nproc, "dist")
        # Solo baseline at the same process count: N independent programs,
        # same pinning — the denominator that isolates multi-process
        # dispatch overhead from plain host contention.
        solo = run_workers(nproc, "solo")
        row["solo_solves_per_sec"] = solo["solves_per_sec"]
        row["dispatch_overhead_vs_solo"] = round(
            1.0 - row["solves_per_sec"] / solo["solves_per_sec"], 3)
        rows.append(row)
        print(f"nproc={nproc}: dist {row['solves_per_sec']} vs solo "
              f"{row['solo_solves_per_sec']} solves/s "
              f"(dispatch overhead {row['dispatch_overhead_vs_solo']:.1%}), "
              f"launch+sync {row['launch_sync_s']}s", file=sys.stderr)

    base = rows[0]["solves_per_sec_per_device"]
    for r in rows:
        r["weak_scaling_efficiency"] = round(
            r["solves_per_sec_per_device"] / base, 3)
        r["weak_scaling_efficiency_vs_solo"] = round(
            r["solves_per_sec"] / r["solo_solves_per_sec"], 3)
    result = {
        "workload": ("iris_posctrl batched solves, "
                     f"{b_per_dev} scenarios/device, {iters} APG iters"),
        "transport": "jax.distributed over localhost (DCN proxy), CPU devices",
        "host_cores": os.cpu_count(),
        "note": ("weak-scaling proxy, one pinned core per process. "
                 "weak_scaling_efficiency_vs_solo (dist vs N INDEPENDENT "
                 "processes at the same count) is the framework-overhead "
                 "signal with host memory-bandwidth contention divided "
                 "out (>=0.8 target, BASELINE.md); the raw vs-1-process "
                 "efficiency folds in host contention that a real "
                 "multi-host slice would not share. Counts beyond "
                 "host_cores oversubscribe and are for completeness."),
        "sweep": rows,
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--virtual-devices", type=int, default=0,
                    help="force N virtual CPU devices (implies --cpu)")
    ap.add_argument("--max-b", type=int, default=256)
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--coordinator", default=None,
                    help="multi-host: coordinator host:port "
                         "(or env SDE4MBRL_COORDINATOR)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--process-sweep", default=None,
                    help="comma list of process counts (e.g. 1,2,4,8): "
                         "spawn that many localhost jax.distributed CPU "
                         "processes each and emit the weak-scaling curve "
                         "(workers always run on the host CPU, never on "
                         "the GPU: one JAX process per card)")
    ap.add_argument("--b-per-dev", type=int, default=32,
                    help="process-sweep: scenarios per device (weak scaling)")
    ap.add_argument("--steps", type=int, default=5,
                    help="process-sweep: timed warm steps")
    ap.add_argument("--devices-per-proc", type=int, default=1)
    ap.add_argument("--out", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "SCALING.json"))
    args = ap.parse_args()

    if args.process_sweep:
        counts = [int(c) for c in args.process_sweep.split(",")]
        process_sweep(counts, args.b_per_dev, args.iters, args.steps,
                      args.devices_per_proc, args.out)
        return

    if args.virtual_devices:
        os.environ["XLA_FLAGS"] = (
            os.environ.get("XLA_FLAGS", "")
            + f" --xla_force_host_platform_device_count={args.virtual_devices}"
        )
    import jax

    if args.cpu or args.virtual_devices:
        jax.config.update("jax_platforms", "cpu")
    # Multi-host: one mesh over all processes' devices (DCN between hosts);
    # must run before any JAX op.
    from sde4mbrl_px4_tpu.parallel.distributed import initialize_distributed

    initialize_distributed(args.coordinator, args.num_processes, args.process_id)
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc, make_batch_inputs
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    cfg = load_yaml_config(os.path.join(here, "configs", "iris_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = args.iters
    cfg["apg_mpc"]["max_no_improvement_iter"] = args.iters

    n_dev = len(jax.devices())
    mesh = make_mesh((n_dev, 1))
    print(f"devices={n_dev} mesh={mesh.shape}", file=sys.stderr)
    reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)

    results = []
    B = n_dev
    while B <= args.max_b:
        if jax.process_count() > 1:
            from sde4mbrl_px4_tpu.parallel.distributed import global_batch_inputs

            xs, rngs, ts = global_batch_inputs(mesh, B, spread=0.5)
        else:
            xs, rngs = make_batch_inputs(mesh, B, spread=0.5)
            ts = jax.device_put(jnp.zeros((B,)), NamedSharding(mesh, P("dp")))
        st = reset_b(xs, rngs, xs)
        # Rotating targets: every timed step re-plans toward a moved
        # setpoint, so warm-started solves do real work (a fixed target
        # converges and the early-exit measures ~1 iteration — the round-3
        # batched-throughput artifact, ADVICE r3).
        offs = [jnp.asarray(o, jnp.float32)
                for o in ([0.5] + [0.0] * 12, [0.0, 0.5] + [0.0] * 11,
                          [0.0, 0.0, -0.5] + [0.0] * 10)]
        tgts = [xs + o[None, :] for o in offs]
        sol = mpc_b(xs, rngs, st, ts, tgts[0])
        jax.block_until_ready(sol.u_opt)
        t0 = time.perf_counter()
        n = 6
        steps = []
        for k in range(n):
            sol = mpc_b(xs, sol.rng, sol.opt_state, ts, tgts[k % len(tgts)])
            steps.append(sol.opt_state.num_steps)
        jax.block_until_ready(sol.u_opt)
        dt = (time.perf_counter() - t0) / n
        thr = B / dt
        steps_mean = float(jnp.mean(jnp.stack(steps)))
        results.append({"B": B, "ms_per_step": round(dt * 1e3, 2),
                        "solves_per_sec": round(thr, 1),
                        "steps_per_solve": round(steps_mean, 1)})
        print(f"B={B:5d}  {dt*1e3:8.1f} ms/step  {thr:9.1f} solves/s  "
              f"({steps_mean:.1f} steps/solve)", file=sys.stderr)
        B *= 4

    base = results[0]["solves_per_sec"] / max(results[0]["B"], 1)
    for r in results:
        r["efficiency_vs_B1"] = round(r["solves_per_sec"] / (base * r["B"]), 3)
    print(json.dumps({"devices": n_dev, "iters": args.iters, "sweep": results}))


if __name__ == "__main__":
    main()
