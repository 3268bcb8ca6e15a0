"""Schema sweep: all six reference config variants load and solve.

The reference ships six MPC YAMLs — iris_sitl x2, hexa (real) x2,
hexa_sitl x2 (``/root/reference/launch/*_mpc.yaml``) — differing in hover
thrust, weights and bounds per deployment. Every variant must parse through
``io/config.py`` and produce a working (reset, mpc) pair.
"""
import os

import jax
import numpy as np
import pytest

from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
from sde4mbrl_px4_tpu.io.config import load_yaml_config

VARIANTS = [
    ("iris_traj_mpc.yaml", 4, True),
    ("iris_posctrl_mpc.yaml", 4, False),
    ("hexa_traj_mpc.yaml", 6, True),
    ("hexa_posctrl_mpc.yaml", 6, False),
    ("hexa_sitl_traj_mpc.yaml", 6, True),
    ("hexa_sitl_posctrl_mpc.yaml", 6, False),
]


@pytest.mark.parametrize("name,n_u,has_traj", VARIANTS)
def test_variant_loads_and_solves(repo_root, name, n_u, has_traj):
    cfg = load_yaml_config(os.path.join(repo_root, "configs", name))
    # Tiny iteration budget: the sweep checks schema + closure wiring, not
    # convergence (convergence is covered per-vehicle elsewhere).
    cfg["apg_mpc"]["max_iter"] = 3
    cfg["apg_mpc"]["max_no_improvement_iter"] = 3
    cfg, (reset_fn, mpc_fn), sft, b = make_mpc_from_config(cfg)

    assert (sft is not None) == has_traj
    assert b.model.n_u == n_u
    H = len(cfg["_time_steps"])
    assert cfg["_time_steps"][0] == pytest.approx(cfg["short_step_dt"])

    rng = jax.random.PRNGKey(0)
    from sde4mbrl_px4_tpu.core.frames import enu2ned
    from sde4mbrl_px4_tpu.core.types import hover_state

    x = enu2ned(sft(0.0)) if has_traj else jax.numpy.asarray(hover_state())
    st = reset_fn(x, rng, x)
    assert st.yk.shape == (H, n_u)
    u, st2, rng2, x_evol = jax.jit(mpc_fn)(x, rng, st, 0.0, x)
    assert u.shape == (H, n_u)
    assert x_evol.shape == (H + 1, 13)
    u_np = np.asarray(u)
    assert np.isfinite(u_np).all()
    assert u_np.min() >= 1e-4 - 1e-6 and u_np.max() <= 1.0 + 1e-6


def test_sitl_pair_differs_from_real_hexa(repo_root):
    """The SITL deployment carries its own hover thrust (0.42 vs 0.33) —
    mirrors reference hexa_sitl_traj_mpc.yaml vs hexa_traj_mpc.yaml."""
    sitl = load_yaml_config(os.path.join(repo_root, "configs", "hexa_sitl_traj_mpc.yaml"))
    real = load_yaml_config(os.path.join(repo_root, "configs", "hexa_traj_mpc.yaml"))
    assert sitl["cost_params"]["uref"][0] == pytest.approx(0.42)
    assert real["cost_params"]["uref"][0] == pytest.approx(0.33)


def test_matmul_precision_validation():
    from sde4mbrl_px4_tpu.models.sde_model import resolve_precision
    import jax

    assert resolve_precision("tf32") == jax.lax.Precision.DEFAULT
    assert resolve_precision("float32") == jax.lax.Precision.HIGHEST
    # bf16 names a cast nothing performs: refused, not silently TF32
    for bad in ("fp8", "bf16"):
        with pytest.raises(ValueError, match="matmul_precision"):
            resolve_precision(bad)


@pytest.mark.parametrize("via", ["file", "mapping"])
def test_pallas_chunk_config_key(repo_root, tmp_path, via):
    """pallas_chunk selected the removed fused-kernel chunking: a config
    that still sets it is refused (file loader and in-memory factory alike)
    instead of flying a different code path than it asks for."""
    src = os.path.join(repo_root, "configs", "iris_posctrl_mpc.yaml")
    if via == "file":
        p = tmp_path / "chunked.yaml"
        p.write_text(open(src).read() + "pallas_chunk: 4\n")
        with pytest.raises(ValueError, match="pallas_chunk"):
            load_yaml_config(str(p))
    else:
        cfg = load_yaml_config(src)
        cfg["pallas_chunk"] = 4
        with pytest.raises(ValueError, match="pallas_chunk"):
            make_mpc_from_config(dict(cfg))


def test_unknown_key_warns(repo_root, tmp_path):
    """A typo'd config key warns instead of silently doing nothing."""
    import warnings

    import yaml

    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = yaml.safe_load(open(os.path.join(repo_root,
                                           "configs/iris_posctrl_mpc.yaml")))
    cfg["antithetik"] = True          # typo
    p = tmp_path / "typo.yaml"
    p.write_text(yaml.safe_dump(cfg))
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        load_yaml_config(str(p))
    assert any("antithetik" in str(x.message) for x in w)


def test_warm_shift_extrapolate_solves(repo_root):
    """warm_shift: extrapolate is live on the XLA path: the carried warm
    start's tail is the clipped linear continuation, not the repeat."""
    import jax
    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.core.types import hover_state
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    def tail_gap(shift):
        cfg = load_yaml_config(os.path.join(repo_root,
                                            "configs/iris_posctrl_mpc.yaml"))
        cfg["apg_mpc"]["max_iter"] = 8
        cfg["warm_shift"] = shift
        _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(cfg)
        x0 = hover_state()
        tgt = np.asarray(hover_state()).copy()
        tgt[0] = 1.0   # make the optimal sequence non-constant
        rng = jax.random.PRNGKey(0)
        st = reset_fn(x0, rng, x0)
        sol = jax.jit(mpc_fn)(x0, rng, st, jnp.float32(0.0), jnp.asarray(tgt))
        yk = np.asarray(sol.opt_state.yk)
        return float(np.abs(yk[-1] - yk[-2]).max())

    # repeat: last two rows identical; extrapolate: they differ (continuation)
    assert tail_gap("repeat") == 0.0
    assert tail_gap("extrapolate") > 0.0
