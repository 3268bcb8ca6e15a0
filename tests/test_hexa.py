"""Hexacopter path (BASELINE config 3): 6-motor allocation end-to-end."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sde4mbrl_px4_tpu.core.frames import enu2ned
from sde4mbrl_px4_tpu.core.types import hover_state


@pytest.fixture(scope="module")
def hexa_bundle(repo_root):
    from sde4mbrl_px4_tpu.engine.mpc_loader import load_mpc_from_cfgfile

    return load_mpc_from_cfgfile(os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"))


def test_hexa_model_dimensions(hexa_bundle):
    cfg, fns, sft, b = hexa_bundle
    assert b.model.n_u == 6
    assert b.model.vehicle.mixing.shape == (4, 6)
    assert b.cost_params.uref.shape == (6,)


def test_hexa_hover_balance(hexa_bundle):
    """6 x ct x 0.33 = m g by construction."""
    cfg, fns, sft, b = hexa_bundle
    veh = b.model.vehicle
    thrust = float(np.sum(veh.mixing[0]) * veh.hover_u)
    assert thrust == pytest.approx(veh.mass * 9.81, rel=1e-5)


def test_hexa_mixing_yaw_authority(hexa_bundle):
    """Alternating spin: yaw torque from differential same-direction motors."""
    cfg, fns, sft, b = hexa_bundle
    mix = b.model.vehicle.mixing
    u = np.full(6, 0.33)
    u[0::2] += 0.1  # boost CW set
    wrench = mix @ u
    assert abs(wrench[3]) > 1e-3          # yaw torque appears
    assert abs(wrench[1]) < 1e-6          # no net roll
    assert abs(wrench[2]) < 1e-6          # no net pitch


def test_hexa_solve_and_track(hexa_bundle):
    """Receding-horizon tracking of the circle with 6-motor plans."""
    cfg, (reset_fn, mpc_fn), sft, b = hexa_bundle
    assert sft is not None
    rng = jax.random.PRNGKey(0)
    x = enu2ned(sft(0.0))
    st = reset_fn(x, rng, x)
    assert st.yk.shape == (20, 6)
    jm = jax.jit(mpc_fn)
    t = 0.0
    for _ in range(6):
        u, st, rng, x_evol = jm(x, rng, st, t, x)
        assert u.shape == (20, 6)
        x = x_evol[1]
        t += cfg["_time_steps"][0]
    err = float(np.linalg.norm(np.asarray(x[:3] - enu2ned(sft(t))[:3])))
    assert err < 0.25, err
    u_np = np.asarray(u)
    assert u_np.min() >= 1e-4 - 1e-7 and u_np.max() <= 1.0 + 1e-7


def test_hexa_controller_pads_to_six(repo_root):
    """The plan pickup pads 4-motor iris plans but passes hexa 6-motor plans
    through unchanged (reference pads to 6 at sde_control.py:302-303)."""
    from sde4mbrl_px4_tpu.engine.controller import RecedingHorizonController

    c = RecedingHorizonController(
        os.path.join(repo_root, "configs/hexa_traj_mpc.yaml"),
        os.path.join(repo_root, "configs/hexa_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0,
    )
    x = np.asarray(hover_state())
    c.solve_once(x, 3, -1.0, x, sample_time_usec=1e6)
    u6, w4, idx = c.pick_command(1e6)
    assert u6.shape == (6,)
    assert not np.allclose(u6[4:], 0.0)   # real commands on motors 5-6
