#!/usr/bin/env python
"""Preflight check: verify a deployment host end-to-end before flight.

The reference's operational discipline is a manual preflight (param pushes,
graduated engagement levels, safety box; ``basic_control.py``). This tool
automates the companion-computer side: one command that proves every
layer is flight-ready and says exactly what's missing if not.

    python tools/preflight.py [--config-dir configs] [--solve] [--ports]

Checks (each prints ok/FAIL, exit code = number of failures):
  deps        python dependencies importable
  native      csrc/libmpc_native.so built + required symbols exported
  configs     every MPC YAML parses and its model checkpoint loads
  trajs       trajectory CSVs load and sample
  device      JAX backend + device inventory
  solve       (--solve) compile + run one tiny MPC solve end-to-end
  ports       (--ports) default UDP ports free (14550/14997/14998)
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

FAILS = 0


def check(name, fn):
    global FAILS
    try:
        detail = fn() or ""
        print(f"  ok    {name:28s} {detail}")
    except Exception as e:  # noqa: BLE001 — report, don't die
        FAILS += 1
        print(f"  FAIL  {name:28s} {type(e).__name__}: {e}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--config-dir", default=None)
    ap.add_argument("--solve", action="store_true",
                    help="also compile + run one tiny solve (slow first time)")
    ap.add_argument("--ports", action="store_true",
                    help="check the default UDP ports are free")
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cfg_dir = args.config_dir or os.path.join(root, "configs")

    # -- deps ---------------------------------------------------------------
    def deps():
        import jax
        import numpy
        if args.cpu:
            jax.config.update("jax_platforms", "cpu")
        return f"jax {jax.__version__}, numpy {numpy.__version__}"

    check("python deps", deps)

    # -- native library -----------------------------------------------------
    def native():
        from sde4mbrl_px4_tpu.io.mavlink import load_native

        lib = load_native()
        if lib is None:
            raise FileNotFoundError(
                "csrc/libmpc_native.so missing — run `make -C csrc`")
        missing = [s for s in
                   ("mav_frame_decode", "geo_control_update", "mbx_open",
                    "router_new")
                   if not hasattr(lib, s)]
        if missing:
            raise RuntimeError(
                f"stale library, missing {missing} — rebuild with `make -C csrc`")
        return "codec + geometric + mailbox + router"

    check("native runtime", native)

    # -- configs + checkpoints ----------------------------------------------
    import glob

    yamls = sorted(glob.glob(os.path.join(cfg_dir, "*_mpc.yaml")))

    def configs():
        from sde4mbrl_px4_tpu.io.config import load_yaml_config
        from sde4mbrl_px4_tpu.models.params_io import load_params

        seen = set()
        for y in yamls:
            cfg = load_yaml_config(y)
            pkl = cfg.get("learned_model_params")
            if pkl and pkl not in seen:
                seen.add(pkl)
                load_params(pkl)
        if not yamls:
            raise FileNotFoundError(f"no *_mpc.yaml under {cfg_dir}")
        return f"{len(yamls)} configs, {len(seen)} checkpoints"

    check("MPC configs + checkpoints", configs)

    # -- trajectories ---------------------------------------------------------
    def trajs():
        from sde4mbrl_px4_tpu.models.trajectory import (
            load_trajectory_csv, make_state_from_traj,
        )

        csvs = sorted(glob.glob(os.path.join(cfg_dir, "trajs", "*.csv")))
        for c in csvs:
            sft = make_state_from_traj(load_trajectory_csv(c))
            x = sft(0.0)
            assert x.shape == (13,)
        return f"{len(csvs)} trajectories sample cleanly"

    check("trajectories", trajs)

    # -- device ---------------------------------------------------------------
    def device():
        import jax

        devs = jax.devices()
        return f"{len(devs)} x {devs[0].platform} ({devs[0]})"

    check("accelerator", device)

    # -- one tiny solve --------------------------------------------------------
    if args.solve:
        def solve():
            import time

            import jax
            import jax.numpy as jnp
            import numpy as np

            from sde4mbrl_px4_tpu.core.types import hover_state
            from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
            from sde4mbrl_px4_tpu.io.config import load_yaml_config

            cfg = load_yaml_config(yamls[0] if "posctrl" in yamls[0]
                                   else os.path.join(cfg_dir,
                                                     "iris_posctrl_mpc.yaml"))
            cfg.pop("trajectory_path", None)
            cfg["horizon"] = 5
            cfg["num_short_dt"] = 5
            cfg["apg_mpc"]["max_iter"] = 10
            _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg)
            x = hover_state()
            rng = jax.random.PRNGKey(0)
            st = reset_fn(x, rng, x)
            t0 = time.time()
            sol = jax.jit(mpc_fn)(x, rng, st, jnp.float32(0.0), x)
            jax.block_until_ready(sol.u_opt)
            assert np.isfinite(np.asarray(sol.u_opt)).all()
            return f"compiled + solved in {time.time()-t0:.1f}s"

        check("end-to-end solve", solve)

    # -- ports ------------------------------------------------------------------
    if args.ports:
        def ports():
            import socket

            busy = []
            for port in (14550, 14996, 14997, 14998, 14999):
                s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
                try:
                    s.bind(("127.0.0.1", port))
                except OSError:
                    busy.append(port)
                finally:
                    s.close()
            if busy:
                raise OSError(f"ports in use: {busy}")
            return "14550/14996/14997/14998/14999 free"

        check("UDP ports", ports)

    print(("PREFLIGHT PASS" if FAILS == 0 else f"PREFLIGHT: {FAILS} FAILURE(S)"))
    return FAILS


if __name__ == "__main__":
    sys.exit(main())
