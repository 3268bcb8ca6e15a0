#!/usr/bin/env python
"""Cost model of one XLA receding-horizon solve on the accelerator.

For one config (default: the flagship ``configs/iris_traj_mpc.yaml``)
it measures, in this one process:

- ``p50_ms``/``p99_ms``/``steps_mean``: blocking warm-started solves along
  the trajectory, each from the state the previous plan predicts (the loop
  ``chip_smoke.py`` phase 1 runs);
- ``fixed_ms`` + ``per_iter_ms``: a least-squares line through the median
  blocking time of solves FORCED to run exactly ``b`` APG iterations
  (convergence tests disabled, traced ``iter_budget`` = b) for each ``b``
  in ``--budgets``, all from one pinned warm state;
- ``launches_per_iter``: device events (kernel launches and copies) in a
  ``jax.profiler`` trace of forced solves at the smallest and largest
  budget, differenced and divided by the iteration difference. The raw
  traces go to a temporary directory; the events per trace line are
  written to ``--trace-dir``.

``--unroll`` sets ``ops.rollout.SCAN_UNROLL`` (the horizon scans' unroll)
before tracing; XLA flags come from ``XLA_FLAGS`` and are echoed in the
output. Prints one JSON object per unroll value.

    python tools/solve_profile.py --unroll 1,4 --trace-dir profile_out
"""
import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache  # noqa: E402

ensure_compile_cache()


def _device_events(trace_dir):
    """Events per line on the device planes of the newest trace under
    ``trace_dir``: {line name: (count, total duration ns)}."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True), key=os.path.getmtime)[-1]
    out = {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            key = f"{plane.name}|{line.name}"
            out[key] = (len(evs), sum(e.duration_ns for e in evs))
    return out


def measure(cfg_path, unroll, n_solves, budgets, reps, trace_dir, tag="",
            t0=3.0):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.ops import rollout

    rollout.SCAN_UNROLL = unroll
    cfg = load_yaml_config(cfg_path)
    max_iter = int(cfg["apg_mpc"]["max_iter"])
    cfg, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(cfg)
    dt = float(cfg["_time_steps"][0])
    x = jnp.asarray(enu2ned(sft(jnp.float32(t0))))
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    tc = time.perf_counter()
    mpc = jax.jit(mpc_fn).lower(x, rng, st, jnp.float32(t0), x,
                                jnp.int32(max_iter)).compile()
    compile_s = time.perf_counter() - tc

    sol = mpc(x, rng, st, jnp.float32(t0), x, jnp.int32(max_iter))
    jax.block_until_ready(sol.u_opt)
    lat, steps = [], []
    t = t0 + dt
    for _ in range(n_solves):
        t1 = time.perf_counter()
        sol = mpc(sol.x_evol[1], sol.rng, sol.opt_state, jnp.float32(t), x,
                  jnp.int32(max_iter))
        u = np.asarray(sol.u_opt)
        lat.append(time.perf_counter() - t1)
        steps.append(float(sol.opt_state.num_steps))
        assert np.isfinite(u).all()
        t += dt

    # Forced iteration counts from one pinned warm state.
    cfg_f = dict(cfg)
    cfg_f["apg_mpc"] = dict(cfg["apg_mpc"], atol=-1.0, rtol=0.0,
                            max_no_improvement_iter=10 ** 9)
    _, (_, mpc_f), _, _ = make_mpc_from_config(cfg_f)
    xw, rngw, stw, tw = sol.x_evol[1], sol.rng, sol.opt_state, jnp.float32(t)
    forced = jax.jit(mpc_f).lower(xw, rngw, stw, tw, x,
                                  jnp.int32(max_iter)).compile()
    med = []
    for b in budgets:
        times = []
        for _ in range(reps):
            t1 = time.perf_counter()
            s = forced(xw, rngw, stw, tw, x, jnp.int32(b))
            n = float(s.opt_state.num_steps)       # blocks
            times.append(time.perf_counter() - t1)
            assert n == b, (n, b)
        med.append(float(np.median(times)) * 1e3)
    per_iter, fixed = np.polyfit(np.asarray(budgets, float), med, 1)
    pred = fixed + per_iter * np.asarray(budgets, float)
    ss_res = float(np.sum((np.asarray(med) - pred) ** 2))
    ss_tot = float(np.sum((np.asarray(med) - np.mean(med)) ** 2)) or 1.0

    res = {"config": os.path.basename(cfg_path), "unroll": unroll,
           "xla_flags": os.environ.get("XLA_FLAGS", ""),
           "compile_s": compile_s, "solves": n_solves,
           "p50_ms": float(np.percentile(lat, 50)) * 1e3,
           "p99_ms": float(np.percentile(lat, 99)) * 1e3,
           "steps_mean": float(np.mean(steps)),
           "ms_per_iter_loop": 1e3 * float(np.sum(lat)) / float(np.sum(steps)),
           "budgets": list(budgets), "forced_median_ms": med,
           "fixed_ms": float(fixed), "per_iter_ms": float(per_iter),
           "fit_r2": 1.0 - ss_res / ss_tot}

    if trace_dir:
        counts = {}
        for b in (budgets[0], budgets[-1]):
            d = tempfile.mkdtemp(prefix="solve_profile_")
            s = forced(xw, rngw, stw, tw, x, jnp.int32(b))
            jax.block_until_ready(s.u_opt)
            with jax.profiler.trace(d):
                for _ in range(3):
                    s = forced(xw, rngw, stw, tw, x, jnp.int32(b))
                    jax.block_until_ready(s.u_opt)
            counts[b] = _device_events(d)
            shutil.rmtree(d, ignore_errors=True)
        os.makedirs(trace_dir, exist_ok=True)
        lo, hi = budgets[0], budgets[-1]
        lines = sorted(set(counts[lo]) | set(counts[hi]))
        per_line = {k: {"events_lo": counts[lo].get(k, (0, 0))[0],
                        "events_hi": counts[hi].get(k, (0, 0))[0],
                        "busy_ms_hi": counts[hi].get(k, (0, 0))[1] / 3e6}
                    for k in lines}
        with open(os.path.join(trace_dir, f"lines{tag}_unroll{unroll}.json"),
                  "w") as f:
            json.dump(per_line, f, indent=1)
        # Kernel and copy activity lives on the stream lines of a GPU plane.
        stream = [k for k in lines if "stream" in k.lower()]
        d_ev = sum(per_line[k]["events_hi"] - per_line[k]["events_lo"]
                   for k in stream)
        res["launches_per_iter"] = d_ev / 3.0 / (hi - lo)
        res["trace_lines"] = len(lines)
    return res


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--config", default=os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", "iris_traj_mpc.yaml"))
    ap.add_argument("--unroll", default="1",
                    help="comma list of horizon-scan unroll factors")
    ap.add_argument("--solves", type=int, default=60)
    ap.add_argument("--budgets", default="10,20,40,80,160")
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--tag", default="", help="label of this run's files "
                    "and output (e.g. the XLA flag set)")
    ap.add_argument("--out", default=None, help="append the JSON lines here")
    args = ap.parse_args()

    import jax

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True) if jax.devices()[0].platform == "gpu" \
        else None
    card = smi.stdout.strip() if smi is not None else "no GPU"
    budgets = [int(b) for b in args.budgets.split(",")]
    for u in (int(v) for v in args.unroll.split(",")):
        res = measure(args.config, u, args.solves, budgets, args.reps,
                      args.trace_dir, args.tag)
        res["tag"] = args.tag
        res["device"] = {"platform": jax.devices()[0].platform,
                         "kind": jax.devices()[0].device_kind, "card": card}
        line = json.dumps(res)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()
