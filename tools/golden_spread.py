#!/usr/bin/env python
"""Write ``tests/goldens/<vehicle>_spread.npz``: the per-tick conditioning
of the controller golden replays on the CPU reference.

Each replay (pos and traj flagship, engagement) is run again with its
plant states perturbed at the relative sizes ``goldens.SPREAD_EPS``; the
file holds, per replay and tick, the largest command change (``<name>_u``)
and relative cost change (``<name>_cost``) that caused. ``chip_smoke.py``'s
golden phase widens each tick's gates by it. Run it after regenerating the
goldens (``SDE4MBRL_REGEN_GOLDEN=1``):

    JAX_PLATFORMS=cpu python tools/golden_spread.py [--vehicles iris,hexa]
"""
import argparse
import json
import os
import sys

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache  # noqa: E402

ensure_compile_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--vehicles", default="iris,hexa")
    args = ap.parse_args(argv)

    import jax

    from sde4mbrl_px4_tpu.engine import goldens as G
    from sde4mbrl_px4_tpu.engine.controller import RecedingHorizonController

    if jax.default_backend() != "cpu":
        sys.exit("golden_spread: the goldens are CPU solves; run with "
                 "JAX_PLATFORMS=cpu")
    for v in args.vehicles.split(","):
        c = RecedingHorizonController(
            os.path.join(ROOT, "configs", f"{v}_traj_mpc.yaml"),
            os.path.join(ROOT, "configs", f"{v}_posctrl_mpc.yaml"),
            seed=0, now_fn=lambda: 0.0)
        try:
            spread = G.input_spread(c)
        finally:
            c.close()
        np.savez(os.path.join(G.golden_dir(ROOT), f"{v}_spread.npz"),
                 **spread)
        print(json.dumps({"vehicle": v, **{k: round(float(a.max()), 5)
                                            for k, a in spread.items()}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
