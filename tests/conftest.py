"""Test harness: force an 8-virtual-device CPU platform.

Mirrors how the build plan tests multi-chip behavior without hardware
(SURVEY.md §4): ``xla_force_host_platform_device_count=8`` gives a real
8-device mesh on CPU; ``jax_platforms='cpu'`` keeps every test off an
accelerator even on a machine that has one (run the GPU path with
``python chip_smoke.py``).
"""
import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
# Persistent compile cache (shared with bench/examples; placed by
# JAX_COMPILATION_CACHE_DIR when set): reruns deserialize instead of
# re-invoking the LLVM pipeline. Besides the speedup, this works around a
# jaxlib-0.9.0 XLA:CPU segfault observed when one process accumulates many
# large compilations (two training loops, then ANY further compile dies
# inside backend_compile_and_load — see tests/test_learning.py history).
from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache  # noqa: E402

ensure_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)

import subprocess

import numpy as np
import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _build_native_lib():
    """Build the native runtime library if absent (it is intentionally not
    tracked in git) so the C++ parity/runtime tests run instead of skipping.

    Serialized with an exclusive file lock: under pytest-xdist every worker
    imports this conftest concurrently, and parallel `make` invocations
    would race-link the same .so. A failed/killed build removes the
    possibly-truncated artifact so the next run rebuilds instead of
    dlopening garbage.
    """
    import fcntl

    so = os.path.join(_ROOT, "csrc", "libmpc_native.so")
    if os.path.exists(so):
        return
    lock_path = os.path.join(_ROOT, "csrc", ".build.lock")
    try:
        with open(lock_path, "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)   # other workers wait here
            if os.path.exists(so):             # a peer built it meanwhile
                return
            try:
                r = subprocess.run(["make", "-C", os.path.join(_ROOT, "csrc")],
                                   capture_output=True, timeout=120)
                ok = r.returncode == 0
            except Exception:
                ok = False
            if not ok and os.path.exists(so):
                os.unlink(so)                  # never keep a truncated .so
    except OSError:
        pass  # tests that need the library will skip with a clear reason


_build_native_lib()


@pytest.fixture(scope="session")
def repo_root():
    return _ROOT


@pytest.fixture(scope="session")
def rng():
    return jax.random.PRNGKey(42)


@pytest.fixture(scope="session")
def iris_model():
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE, init_params
    from sde4mbrl_px4_tpu.models.vehicles import iris_config

    model = NeuralSDE(vehicle=iris_config())
    params = init_params(jax.random.PRNGKey(0), model)
    return model, jax.tree.map(jax.numpy.asarray, params)


@pytest.fixture(scope="session")
def iris_pos_bundle(repo_root):
    """Loaded position-control MPC (shared across tests: compile once)."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile

    return load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml"))


@pytest.fixture(scope="session")
def iris_traj_bundle(repo_root):
    from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile

    return load_mpc_from_cfgfile(os.path.join(repo_root, "configs/iris_traj_mpc.yaml"))
