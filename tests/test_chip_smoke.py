"""``chip_smoke.py``: the GPU smoke run's contract, and its phase
functions rehearsed on the CPU at reduced counts (the GPU run itself is
``python chip_smoke.py`` on a card)."""
import json
import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke as cs

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _has_result(stdout):
    return any('"ok": true' in line for line in stdout.splitlines())


def test_cpu_run_fails_without_result_line():
    r = _run(_ROOT, os.path.join(_ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert not _has_result(r.stdout), r.stdout
    assert "no GPU" in r.stderr


def test_script_alone_fails_without_result_line(tmp_path):
    shutil.copy(os.path.join(_ROOT, "chip_smoke.py"), tmp_path)
    r = _run(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert not _has_result(r.stdout), r.stdout


def test_phase_device_refuses_cpu():
    with pytest.raises(cs.NoAccelerator):
        cs.phase_device("unused")


def test_result_line_format():
    line = cs.result_line("gpu", "NVIDIA H100 80GB HBM3", 1)
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}}
    assert "\n" not in line


def test_four_selects_only_the_multicard_phase():
    assert cs.select_phases(True) == ("device", "four")
    one = cs.select_phases(False)
    assert "four" not in one
    assert one == ("device", "flagship", "hexa", "goldens", "deadline",
                   "closed_loop", "fleet")


@pytest.mark.parametrize("cfg", ["iris_traj_mpc.yaml", "hexa_traj_mpc.yaml"])
def test_phase_tracking_on_cpu(cfg):
    from sde4mbrl_px4_tpu.compile_cache import ensure_compile_cache

    res = cs.phase_tracking(cs._cfg(cfg), 3, ensure_compile_cache())
    assert res["solves"] == 3 and res["steps_mean"] >= 1
    assert res["pos_err_mean_m"] < cs.TRACK_TOL_M
    assert res["precision"] == "HIGHEST"


def test_phase_goldens_on_cpu():
    """The committed traces are CPU float32 solves: on the CPU the replay
    must land far inside the card's gates."""
    res = cs.phase_goldens(vehicles=("iris",), families=("mppi", "policy"))
    assert res["traces"] == 5
    assert res["max_du"] < 1e-3 and res["max_cost_rel_converged"] < 1e-3


def test_phase_deadline_on_cpu():
    res = cs.phase_deadline(n_solves=3, particles=8)
    assert res["budget_first"] == 200           # uncalibrated: unlimited
    assert res["budget_last"] <= 200


def test_phase_fleet_on_cpu():
    res = cs.phase_fleet(batch=8, ticks=3)
    assert res["batch"] == 8 and res["devices"] == 1
    assert res["tick_p50_ms"] > 0
