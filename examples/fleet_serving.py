#!/usr/bin/env python
"""Fleet serving: one accelerator flying a swarm of simulated vehicles.

The reference runs ONE vehicle per controller process; the accelerator
scale-out serves a FLEET from one card — every vehicle's receding-horizon
solve is one row of a dp-sharded batched program (parallel/fleet.py), warm
starts device-resident, plans pipelined (tick k dispatched while tick
k-1's plans stream home). This demo closes the loop for B simulated iris
vehicles simultaneously: each gets its own hold target on a circle, each
is stepped by its own plant using its own plan.

The tick busy time it prints is the budget to hold against the 50 ms
control period (the demo's default solve budget is the shipped config's
100 iterations).

Usage: python examples/fleet_serving.py [--vehicles 64] [--seconds 8] [--cpu]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache

ensure_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vehicles", type=int, default=64)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--iters", type=int, default=100,
                    help="per-solve APG iteration budget (the shipped posctrl"
                         " config's max_iter; 50 under-converges the 2 m"
                         " engagement transient and limit-cycles)")
    ap.add_argument("--solver", default="apg", choices=("apg", "mppi", "policy"),
                    help="per-vehicle solver family (mppi = sampling twin; "
                         "policy = distilled one-shot network — train with "
                         "examples/policy_distill.py first)")
    ap.add_argument("--policy-dir", default=None,
                    help="dir with <vehicle>_{traj,posctrl}_policy.pkl; "
                         "default: the shipped checkpoints in configs/models")
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="with --solver policy: APG polish iterations per "
                         "vehicle per tick (policy.refine_iters)")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.io.config import load_yaml_config
    from sde4mbrl_px4_tpu.models.params_io import load_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu.models.vehicles import iris_config
    from sde4mbrl_px4_tpu.ops.rollout import em_step
    from sde4mbrl_px4_tpu.parallel.fleet import FleetEngine
    from sde4mbrl_px4_tpu.parallel.mesh import make_mesh

    here = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
    B = args.vehicles

    cfg = load_yaml_config(os.path.join(here, "configs/iris_posctrl_mpc.yaml"))
    cfg["apg_mpc"]["max_iter"] = args.iters
    if args.solver == "mppi":
        cfg["solver"] = "mppi"
        # --iters maps onto the sampling budget here (re-centered rounds);
        # apg_mpc.max_iter is not read by the MPPI solver.
        if args.iters != 100:
            cfg["mppi"] = {"iters": args.iters}
    elif args.solver == "policy":
        pol_dir = args.policy_dir or os.path.join(here, "configs", "models")
        ckpt = os.path.join(pol_dir, "iris_posctrl_policy.pkl")
        if not os.path.exists(ckpt):
            print(f"missing {ckpt} — run examples/policy_distill.py first",
                  file=sys.stderr)
            return 1
        cfg["solver"] = "policy"
        cfg["policy"] = {"params_path": ckpt,
                         "refine_iters": args.refine_iters}
    mesh = make_mesh((len(jax.devices()), 1))
    print(f"devices: {jax.devices()}  fleet size: {B}", flush=True)
    t0 = time.time()
    eng = FleetEngine(cfg, mesh, batch=B, seed=0)
    dt = eng.dt

    # Per-vehicle hold targets on a circle (NED), radius 2 m at 1 m alt.
    ang = 2 * np.pi * np.arange(B) / B
    targets = np.tile(np.asarray(hover_state()), (B, 1)).astype(np.float32)
    targets[:, 0] = 2.0 * np.cos(ang)
    targets[:, 1] = 2.0 * np.sin(ang)
    targets[:, 2] = 1.0                      # ENU z (converted by the engine)

    # Fleet plant: every vehicle integrated by the same batched EM step.
    params, _ = load_params(os.path.join(here, "configs/models/iris_sde.pkl"))
    model = NeuralSDE(vehicle=iris_config())
    states = np.tile(np.asarray(hover_state()), (B, 1)).astype(np.float32)

    # Fine-substep plant (like sim/plant.py SDEPlant): one 50 ms Euler step
    # is too coarse for closed-loop attitude dynamics and limit-cycles.
    n_sub = 10

    def _one(x, u):
        def body(x, _):
            return em_step(model, params, x, u, jnp.float32(dt / n_sub)), 0.0
        return jax.lax.scan(body, x, None, length=n_sub)[0]

    plant_step = jax.jit(jax.vmap(_one))

    eng.reset(states)
    print(f"fleet engine ready in {time.time()-t0:.0f}s "
          f"(B={B} solves/tick, horizon {eng.H})", flush=True)

    n_ticks = int(args.seconds / dt)
    busy = []
    for k in range(n_ticks):
        t1 = time.perf_counter()
        # pipelined: returns the previous tick's plans, time-index-picked
        u_now, _x_evol, _age = eng.step(states, targets,
                                        np.zeros(B, np.float32))
        busy.append(time.perf_counter() - t1)
        states = np.asarray(plant_step(jnp.asarray(states),
                                       jnp.asarray(u_now)))

    errs = np.linalg.norm(
        states[:, :3] - np.stack([targets[:, 1], targets[:, 0],
                                  -targets[:, 2]], axis=1), axis=1)
    busy = np.asarray(busy[2:])
    print(f"tick busy time: p50={1e3*np.percentile(busy,50):.1f}ms "
          f"p99={1e3*np.percentile(busy,99):.1f}ms (budget {1e3*dt:.0f}ms) "
          f"=> {B/np.percentile(busy,50):,.0f} vehicle-solves/s", flush=True)
    print(f"fleet tracking after {args.seconds:.0f}s: "
          f"mean={errs.mean():.3f}m max={errs.max():.3f}m", flush=True)
    ok = errs.mean() < 0.35
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
