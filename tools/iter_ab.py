#!/usr/bin/env python
"""A/B solver-hyperparameter variants on the PINNED headline workload.

The headline chained-solve rate (bench.py::_bench_chained) is
iteration-bound: a solve costs a fixed part plus a per-APG-iteration
part, so solves/s moves with the warm steps/solve count. Iteration counts
are PLATFORM-INDEPENDENT, so this tool A/Bs candidate linesearch/momentum
settings on CPU — no accelerator time — and reports:

- warm steps/solve on the exact pinned window bench.py times,
- mean avg_linesearch (candidate evals actually spent),
- plan quality guards: opt_cost and closed-plan tracking error over the
  window (a variant that converges in fewer steps to a WORSE plan loses).

Usage: python tools/iter_ab.py [--k 10] [--t0 0.0]
"""
import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core.frames import enu2ned
from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu.io.config import load_yaml_config

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_variant(name, overrides, K=10, t_start=0.0):
    cfg = load_yaml_config(os.path.join(HERE, "configs", "iris_traj_mpc.yaml"))
    for dotted, val in overrides.items():
        node = cfg
        keys = dotted.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = val
    cfg, (reset_fn, mpc_fn), sft, _ = make_mpc_from_config(copy.deepcopy(cfg))
    dt = float(cfg["_time_steps"][0])
    x0 = enu2ned(sft(t_start))
    rng = jax.random.PRNGKey(0)
    st0 = reset_fn(x0, rng, x0)

    def chain(x, rng, st, t0):
        def body(carry, k):
            x, rng, st = carry
            u, st1, rng1, x_evol = mpc_fn(x, rng, st, t0 + k * dt, x)
            t_next = t0 + (k + 1) * dt
            err = jnp.linalg.norm(x_evol[1][:3] - enu2ned(sft(t_next))[:3])
            return (x_evol[1], rng1, st1), (st1.num_steps, st1.avg_linesearch,
                                            st1.opt_cost, err)

        (xf, rngf, stf), outs = jax.lax.scan(
            body, (x, rng, st), jnp.arange(K, dtype=jnp.float32))
        return (xf, rngf, stf), outs

    jc = jax.jit(chain)
    # warm-up chain to the steady warm-started regime, then the pinned window
    (x1, rng1, st1), _ = jc(x0, rng, st0, jnp.float32(t_start))
    (_, _, _), (steps, nls, costs, errs) = jc(x1, rng1, st1,
                                              jnp.float32(t_start + K * dt))
    steps = np.asarray(steps)
    print(f"{name:34s} steps/solve {steps.mean():6.1f} (max {steps.max():5.0f}) "
          f"ls/iter {float(np.mean(nls)):4.2f}  "
          f"opt_cost {float(np.mean(costs)):8.3f}  "
          f"track_err {float(np.mean(errs))*100:6.2f} cm", flush=True)
    return steps.mean(), float(np.mean(costs)), float(np.mean(errs))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--t0", type=float, default=0.0)
    ap.add_argument("--only", type=str, default=None,
                    help="comma-separated variant-name substrings to run")
    args = ap.parse_args()

    variants = [
        ("base (flagship config)", {}),
        ("maxls 6", {"apg_mpc.linesearch.maxls": 6}),
        ("maxls 8", {"apg_mpc.linesearch.maxls": 8}),
        ("increase 1.6", {"apg_mpc.linesearch.increase_factor": 1.6}),
        ("increase 2.0", {"apg_mpc.linesearch.increase_factor": 2.0}),
        ("decrease 0.5", {"apg_mpc.linesearch.decrease_factor": 0.5}),
        ("decrease 0.5 + maxls 6", {"apg_mpc.linesearch.decrease_factor": 0.5,
                                    "apg_mpc.linesearch.maxls": 6}),
        ("beta_init 0.5", {"apg_mpc.beta_init": 0.5}),
        ("moment 0.7 const", {"apg_mpc.moment_scale": 0.7}),
        ("moment 0.85 const", {"apg_mpc.moment_scale": 0.85}),
        ("inc 1.6 + maxls 6", {"apg_mpc.linesearch.increase_factor": 1.6,
                               "apg_mpc.linesearch.maxls": 6}),
        ("bb", {"apg_mpc.linesearch.reset_option": "bb"}),
        ("bb + maxls 6", {"apg_mpc.linesearch.reset_option": "bb",
                          "apg_mpc.linesearch.maxls": 6}),
        ("bb + maxls 8", {"apg_mpc.linesearch.reset_option": "bb",
                          "apg_mpc.linesearch.maxls": 8}),
        ("bb + decrease 0.5", {"apg_mpc.linesearch.reset_option": "bb",
                               "apg_mpc.linesearch.decrease_factor": 0.5}),
        ("x bb + maxls 12", {"apg_mpc.linesearch.reset_option": "bb",
                             "apg_mpc.linesearch.maxls": 12}),
        ("x bb + maxls 8 + dec 0.6", {"apg_mpc.linesearch.reset_option": "bb",
                                      "apg_mpc.linesearch.maxls": 8,
                                      "apg_mpc.linesearch.decrease_factor": 0.6}),
        ("x bb + maxls 8 + dec 0.8", {"apg_mpc.linesearch.reset_option": "bb",
                                      "apg_mpc.linesearch.maxls": 8,
                                      "apg_mpc.linesearch.decrease_factor": 0.8}),
        ("p precond", {"apg_mpc.precond": "hover_diag"}),
        ("p precond + bb", {"apg_mpc.precond": "hover_diag",
                            "apg_mpc.linesearch.reset_option": "bb"}),
        ("p precond + maxls 8", {"apg_mpc.precond": "hover_diag",
                                 "apg_mpc.linesearch.maxls": 8}),
        ("p precond + bb + maxls 8", {"apg_mpc.precond": "hover_diag",
                                      "apg_mpc.linesearch.reset_option": "bb",
                                      "apg_mpc.linesearch.maxls": 8}),
    ]
    if args.only:
        keys = [s.strip() for s in args.only.split(",")]
        variants = [v for v in variants if any(k in v[0] for k in keys)]
    for name, ov in variants:
        run_variant(name, ov, K=args.k, t_start=args.t0)


if __name__ == "__main__":
    main()
