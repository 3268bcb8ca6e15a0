"""``chip_smoke.py``'s four-card phase and in-process closed loop,
rehearsed on the CPU: the four-card path on 4 of the test harness's
virtual CPU devices, the closed loop in slow motion."""
import chip_smoke as cs
from sde4mbrl_px4_tpu.engine import goldens as G


def test_phase_four_on_virtual_devices():
    res = cs.phase_four(n_dev=4, batch=8, particles=16, fleet_batch=8,
                        ticks=2, max_iter=10)
    assert res["dp"]["allreduce"] == 0
    assert res["dp"]["max_du"] <= G.U_TOL
    assert res["mc"]["max_du"] <= G.U_TOL
    assert res["mc"]["cost_rel"] <= G.C_TOL
    assert res["fleet"]["batch"] == 8


def test_phase_closed_loop_on_cpu():
    res = cs.phase_closed_loop(seconds=5.0, time_scale=3.0, port=26871)
    assert res["ok"] and res["engaged"]
    assert res["err_mean_m"] < 0.35
