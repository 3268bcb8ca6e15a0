"""Auxiliary subsystem tests: flight logs, launch-config resolution,
profiling helpers, trajgen CSV interop with the native follower."""
import os
import time

import numpy as np
import pytest


def test_flight_recorder_roundtrip(tmp_path):
    from sde4mbrl_px4_tpu.io.flight_log import FlightRecorder, load_flight_log

    rec = FlightRecorder()
    for k in range(5):
        rec.record(t=k * 0.02, state=np.arange(13, dtype=np.float32) + k,
                   cmd_motors=np.full(6, 0.7), mpc_on=5, weight_motors=100,
                   solve_time=0.01, num_steps=42, mpc_indx=k)
    assert len(rec) == 5
    p = str(tmp_path / "f.npz")
    rec.save(p)
    d = load_flight_log(p)
    assert d["t"].shape == (5,)
    assert d["state"].shape == (5, 13)
    np.testing.assert_allclose(d["state"][2], np.arange(13) + 2)
    assert d["num_steps"][0] == 42
    # nan-padded reference when absent
    assert np.isnan(d["ref"]).all()


def test_flight_recorder_analysis_plot(tmp_path):
    """tools/analyze.py renders a PNG from a recorded log."""
    import subprocess
    import sys

    from sde4mbrl_px4_tpu.io.flight_log import FlightRecorder

    rec = FlightRecorder()
    for k in range(20):
        x = np.zeros(13, np.float32)
        x[0] = 0.1 * k          # move north so the scene has extent
        x[6] = 1.0              # identity attitude
        rec.record(t=k * 0.02, state=x,
                   cmd_motors=np.full(6, 0.7),
                   cmd_thrust_rates=np.array([0.7, 0.1, 0, 0], np.float32),
                   ref=np.zeros(13, np.float32))
    p = str(tmp_path / "f.npz")
    rec.save(p)
    out = str(tmp_path / "f.png")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(repo, "tools/analyze.py"), p,
         "-o", out, "--scene"],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr[-500:]
    assert os.path.exists(out) and os.path.getsize(out) > 10_000
    # 3-D scene view (rviz_config.rviz analogue)
    scene = str(tmp_path / "f_scene.png")
    assert os.path.exists(scene) and os.path.getsize(scene) > 10_000


def test_launch_config_dir_resolution(repo_root):
    """Relative config_dir resolves from CWD or the launch file's
    grandparent (configs/launch/*.yaml -> <root>/configs)."""
    import yaml

    from sde4mbrl_px4_tpu.launch import _load

    cfg = _load(os.path.join(repo_root, "configs/launch/iris_sdectrl.yaml"))
    assert cfg["node"] == "sde_control"
    base = cfg.get("config_dir", "configs")
    cand = [os.path.abspath(base),
            os.path.join(os.path.dirname(os.path.dirname(cfg["_dir"])), base)]
    resolved = next((c for c in cand if os.path.isdir(c)), None)
    assert resolved is not None
    assert os.path.exists(os.path.join(resolved, cfg["traj_ctrl"]))


def test_solve_timer_stats():
    from sde4mbrl_px4_tpu.engine.profiling import SolveTimer

    t = SolveTimer(window=8)
    for _ in range(3):
        with t:
            time.sleep(0.005)
    st = t.stats()
    assert st["n"] == 3
    assert 3.0 < st["p50_ms"] < 50.0
    assert t.last > 0


def test_trace_context_noop_safe(tmp_path):
    """The trace context writes a device trace of its body, and a profiler
    that cannot start (here: one is already running) raises instead of
    silently timing nothing."""
    import glob

    import jax.numpy as jnp

    from sde4mbrl_px4_tpu.engine.profiling import trace

    with trace(str(tmp_path / "tr")):
        jnp.ones(8).block_until_ready()
        with pytest.raises(Exception):
            with trace(str(tmp_path / "nested")):
                pass
    assert glob.glob(str(tmp_path / "tr" / "**" / "*.xplane.pb"),
                     recursive=True)


def test_trajgen_csv_feeds_native_follower(tmp_path):
    """Generated CSVs parse identically in the jittable sampler and the C++
    stage-cached follower."""
    from sde4mbrl_px4_tpu.baselines.geometric import NativeGeometricController
    from sde4mbrl_px4_tpu.models.trajectory import (
        load_trajectory_csv, make_state_from_traj,
    )
    from sde4mbrl_px4_tpu.models.trajgen import lemniscate_trajectory, write_trajectory_csv

    so = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "csrc", "libmpc_native.so")
    if not os.path.exists(so):
        pytest.skip("native library not built")
    p = str(tmp_path / "lemn.csv")
    write_trajectory_csv(p, lemniscate_trajectory(dt=0.05))
    sft = make_state_from_traj(load_trajectory_csv(p, convert_to_ned=False))
    ctl = NativeGeometricController()
    assert ctl.load_trajectory(p)
    for t in (0.0, 0.33, 1.7, 5.0):
        pos_c, vel_c, _, _ = ctl.sample_trajectory(t)
        x_j = np.asarray(sft(t))
        np.testing.assert_allclose(pos_c, x_j[:3], atol=1e-5)
        np.testing.assert_allclose(vel_c, x_j[3:6], atol=1e-5)


def test_live_monitor_overlay(tmp_path):
    """tools/analyze.py --live core: rolling buffers + overlay render
    (PlotJuggler-layout analogue, reference new_analyze_mpc_v3.xml)."""
    import sys
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "tools"))
    from analyze import LiveMonitor

    mon = LiveMonitor(window_s=2.0)
    assert "waiting" in mon.summary()
    for k in range(100):
        t_us = k * 0.02 * 1e6
        x = np.zeros(13, np.float32)
        x[10] = 0.1 * np.sin(k * 0.1)
        mon.ingest_state(t_us, x, motors4=np.full(4, 0.7, np.float32))
        mon.ingest_cmd(t_us, np.full(6, 0.71, np.float32),
                       np.array([0.7, 0.1, 0.0, 0.0], np.float32))
    # window trims to 2 s (100 Hz-ish stream of 2 s total kept)
    assert mon.ach[-1][0] - mon.ach[0][0] <= 2.0 + 1e-6
    out = str(tmp_path / "live.png")
    assert mon.render(out)
    assert os.path.getsize(out) > 10000
    assert "rate err" in mon.summary()
    # live 3-D scene leg (rviz-analogue): path + pose axes + reference
    scene = str(tmp_path / "live_scene.png")
    ref = np.stack([np.linspace(0, 1, 20), np.zeros(20), -np.ones(20)],
                   axis=-1)
    assert mon.render_scene(scene, ref_xyz=ref)
    assert os.path.getsize(scene) > 10000


def test_mission_param_push(repo_root):
    """MissionControl pushes COM_RCL_EXCEPT=4 five times pre-flight
    (reference basic_control.py:147-149); SimVehicle lands them in the
    FCU param store."""
    import jax

    from sde4mbrl_px4_tpu.cli.mission import MissionControl, SimVehicle, VehicleBase
    from sde4mbrl_px4_tpu.models.params_io import load_params
    from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE
    from sde4mbrl_px4_tpu.models.vehicles import iris_config
    from sde4mbrl_px4_tpu.sim.plant import FCUSim, SDEPlant

    params, _ = load_params(os.path.join(repo_root, "configs/models/iris_sde.pkl"))
    plant = SDEPlant(NeuralSDE(vehicle=iris_config()), params, sim_dt=0.01)
    fcu = FCUSim(plant)
    veh = SimVehicle(fcu)
    calls = []
    orig = veh.set_param
    veh.set_param = lambda n, v: calls.append((n, v)) or orig(n, v)
    MissionControl(veh, log=lambda *a: None)
    assert calls == [("COM_RCL_EXCEPT", 4)] * 5
    assert fcu.params["COM_RCL_EXCEPT"] == 4
    # base interface reports unsupported gracefully
    assert VehicleBase().set_param("X", 1) is False


def test_repl_completion():
    """Verb completion for the mission REPL (reference input_command.py
    uses a prompt_toolkit WordCompleter; stdlib readline twin)."""
    readline = pytest.importorskip("readline")
    from sde4mbrl_px4_tpu.cli.mission import _setup_line_editing

    save = _setup_line_editing(history_file="/tmp/_test_hist")
    comp = readline.get_completer()
    got = []
    k = 0
    while True:
        m = comp("controller_", k)
        if m is None:
            break
        got.append(m)
        k += 1
    assert "controller_init" in got and "controller_on" in got
    assert comp("zz", 0) is None
    save()


@pytest.mark.slow
def test_preflight_passes(repo_root):
    """tools/preflight.py: the deployment-host check passes on this tree."""
    import subprocess
    import sys

    r = subprocess.run(
        [sys.executable, os.path.join(repo_root, "tools", "preflight.py"),
         "--cpu"],
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout + r.stderr
    assert "PREFLIGHT PASS" in r.stdout
