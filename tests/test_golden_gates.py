"""Cross-backend golden gates (``engine/goldens.gate_trace``) and the
committed per-tick spread of the CPU reference that widens them."""
import os

import numpy as np
import pytest

from sde4mbrl_px4_tpu.engine import goldens as G

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_N = 6


def _ref():
    rs = np.random.RandomState(0)
    trace = rs.uniform(0.2, 0.9, (_N, 11)).astype(np.float32)
    trace[:, 10] = np.arange(_N)
    return {"trace": trace,
            "costs": rs.uniform(1.0, 5.0, _N).astype(np.float32)}


def _case(du=0.0, dc=0.0, tick=2, spread_u=0.0, capped=False, didx=0,
          gate_u=True):
    ref = _ref()
    tr, costs = ref["trace"].copy(), ref["costs"].copy()
    tr[tick, 3] += du
    costs[tick] *= 1 + dc
    tr[tick, 10] += didx
    su = np.zeros(_N, np.float32)
    su[tick] = spread_u
    cap = np.zeros(_N, bool)
    cap[tick] = capped
    return G.gate_trace(tr, costs, ref, su, np.zeros(_N, np.float32), cap,
                        gate_u=gate_u)


@pytest.mark.parametrize("kw,ok", [
    ({}, True),
    ({"du": 0.025}, True),
    ({"du": 0.035}, False),
    ({"du": 0.12, "spread_u": 0.1}, True),
    ({"du": 0.14, "spread_u": 0.1}, False),
    ({"dc": 0.015}, True),
    ({"dc": 0.05}, False),
    ({"dc": 0.05, "capped": True}, True),
    ({"du": 0.035, "capped": True}, False),
    ({"didx": 1}, False),
    ({"du": 0.2, "gate_u": False}, True),
    ({"dc": 0.05, "gate_u": False}, False),
    ({"didx": 1, "gate_u": False}, False),
], ids=["identical", "u_inside", "u_outside", "u_inside_spread",
        "u_outside_spread", "cost_inside", "cost_outside",
        "capped_cost_reported", "capped_u_gated", "index_mismatch",
        "u_reported_only", "u_reported_cost_gated",
        "u_reported_index_gated"])
def test_gate_trace(kw, ok):
    g = _case(**kw)
    assert g["pass"] is ok
    assert g["capped_ticks"] == int(kw.get("capped", False))


def test_gate_trace_reports_the_worst_tick_against_its_gate():
    g = _case(du=0.12, spread_u=0.1, tick=4)
    assert g["worst_tick"] == 4
    assert g["worst_gate_u"] == pytest.approx(G.U_TOL + 0.1)
    assert g["gate_u_max"] == pytest.approx(G.U_TOL + 0.1)


@pytest.mark.parametrize("vehicle", ["iris", "hexa"])
@pytest.mark.parametrize("name", list(G.CONTROLLER_REPLAYS))
def test_committed_spread_matches_its_golden(vehicle, name):
    spread = G.load_spread(_ROOT, vehicle)
    ref = np.load(os.path.join(G.golden_dir(_ROOT),
                               f"{vehicle}_{name}_trace.npz"))
    for key in (f"{name}_u", f"{name}_cost"):
        a = spread[key]
        assert a.shape == (len(ref["trace"]),)
        assert np.isfinite(a).all() and (a >= 0).all()


@pytest.mark.parametrize("name", list(G.CONTROLLER_REPLAYS))
def test_iris_spread_stays_below_the_chaos_gate(name):
    """The 4-motor iris is well-conditioned: its command gates widen by
    less than the base gate itself on every tick."""
    spread = G.load_spread(_ROOT, "iris")
    assert spread[f"{name}_u"].max() < G.U_TOL


@pytest.fixture(scope="module")
def iris_controller():
    from sde4mbrl_px4_tpu.engine.controller import RecedingHorizonController

    c = RecedingHorizonController(
        os.path.join(_ROOT, "configs", "iris_traj_mpc.yaml"),
        os.path.join(_ROOT, "configs", "iris_posctrl_mpc.yaml"),
        seed=0, now_fn=lambda: 0.0)
    yield c
    c.close()


def test_input_spread_is_zero_without_perturbation(iris_controller):
    s = G.input_spread(iris_controller, names=("pos_flagship",),
                       eps=(0.0,), seeds=2)
    assert s["pos_flagship_u"].shape == (6,)
    assert (s["pos_flagship_u"] == 0).all()
    assert (s["pos_flagship_cost"] == 0).all()


def test_input_spread_restores_the_controller(iris_controller):
    s = G.input_spread(iris_controller, names=("pos_flagship",),
                       eps=(1e-6,), seeds=1)
    assert 0 < s["pos_flagship_u"].max() < G.U_TOL
    assert "solve_once" not in vars(iris_controller)
