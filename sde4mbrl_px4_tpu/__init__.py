"""sde4mbrl_px4_tpu — accelerator-native neural-SDE MPC framework.

A from-scratch re-design of the capabilities of the reference
``wuwushrek/sde4mbrl_px4`` stack (learning-based receding-horizon MPC for
PX4 multirotors) as an idiomatic JAX/XLA/pjit framework:

- L0 ``core``:      quaternion / rotation / frame (ENU<->NED) math
- L1 ``models``:    neural-SDE vehicle models (iris quad, hexa), checkpoints
- L2 ``ops``:       Euler-Maruyama rollout (lax.scan + batched particles)
- L3 ``cost``:      tracking/slew/uncertainty cost assembly
- L4 ``solver``:    APG trajectory optimizer (Nesterov momentum + Armijo
                    linesearch + box projection) as a single XLA program
- L5 ``engine``:    receding-horizon controller (reset / warm-start shift /
                    control automata / time-indexed plan pickup / telemetry)
- L6 ``parallel``:  device-mesh scale-out over (host, scenario, particle)
- L7 ``io``:        config schema, MAVLink wire structs + C++ UDP bridge,
                    shared-memory mailbox runtime, mission CLI

Reference parity is documented per-module with ``file:line`` citations into
the reference tree (see SURVEY.md).
"""

__version__ = "0.1.0"

from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile  # noqa: F401
from sde4mbrl_px4_tpu.core.frames import enu2ned, ned2enu  # noqa: F401
