"""Receding-horizon controller runtime (L5).

The pure-logic core of the reference's ``SDEControlROS`` node
(``sde4mbrl_px4/mpc_controller/sde_control.py``), decoupled from
ROS/MAVLink/multiprocessing so it is directly testable and reusable by the
async engine (``io/engine_runtime.py``):

- :class:`ControlAutomata` — the mode machine (none/reset/test/pos/idle/
  traj) resolved on every state tick (reference ``control_automata``,
  ``sde_control.py:180-220``) plus the service-level mode-switch semantics
  (``start_trajectory_callback``, ``sde_control.py:480-562``).
- :class:`RecedingHorizonController` — owns the two solvers (trajectory
  tracker + position/setpoint controller, reference ``load_mpc_models``,
  ``sde_control.py:156-177``), dispatches solves per mode (reference solver
  loop dispatch, ``sde_control.py:398-419``), and performs the
  time-indexed asynchronous plan pickup (``sde_control.py:292-308``) that
  decouples command latency from solve latency.

The controller itself is host-side Python orchestrating ahead-of-time
compiled XLA executables; the hot solve path never leaves the device.
"""
from __future__ import annotations

import logging
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core.types import (
    CONTROL_STATES,
    CONTROL_STATE_NAMES,
    CTRL_INACTIVE,
    CTRL_POSE_ACTIVE,
    CTRL_TEST,
    CTRL_TRAJ_ACTIVE,
    CTRL_TRAJ_IDLE,
    hover_state,
)
from sde4mbrl_px4_tpu.engine.mpc_loader import (
    load_mpc_from_cfgfile,
    make_mpc_from_config,
)
from sde4mbrl_px4_tpu.engine.telemetry import OptMPCStateRecord

__all__ = ["ControlAutomata", "RecedingHorizonController", "CompiledMPC",
           "OverrunMeter"]

_LOG = logging.getLogger("sde4mbrl_px4_tpu.engine")


class OverrunMeter:
    """Counts plan-horizon overruns and logs them rate-limited.

    An overrun means the pickup index ran past the planning horizon — the
    solver missed real time. The reference clamps AND ``logerr``s
    (``sde_control.py:294-298``); this meter gives both pickup paths one
    shared implementation.
    """

    def __init__(self, log_period_s: float = 1.0):
        self.count = 0
        self._last_log = 0.0
        self._period = log_period_s

    def record(self, idx: int, horizon: int, plan_age_ms: float) -> None:
        self.count += 1
        now = time.time()  # wall clock (engine clocks may be sim time)
        if now - self._last_log > self._period:
            self._last_log = now
            _LOG.error(
                "plan horizon overrun: pickup index %d > %d (plan age "
                "%.0f ms; solver missed real time; %d total)",
                idx, horizon - 1, plan_age_ms, self.count,
            )

    def clamp(self, idx: int, horizon: int, plan_age_ms: float) -> int:
        """Record an overrun if ``idx`` ran past the horizon, then clamp to
        the valid pickup range — the one shared implementation of the
        reference's clamp-AND-logerr (``sde_control.py:294-298``) for every
        pickup path."""
        if idx > horizon - 1:
            self.record(idx, horizon, plan_age_ms)
        return max(0, min(idx, horizon - 1))


class BudgetMeter:
    """Warns (rate-limited) when blocking solves exceed the control period.

    The blocking ``solve_once`` path holds the caller for the full solve
    round trip; if that exceeds the control indexing period (plan step 0
    dt — the reference's 50 ms budget, ``iris_sitl_traj_mpc.yaml:46``),
    every published plan is already ≥1 index stale at publication and the
    caller cannot sustain the control rate. Pipeline mode (or the async
    engine's dispatch/collect split) is the fix; this meter makes the
    blocking footgun loud instead of silent.
    """

    def __init__(self, log_period_s: float = 1.0):
        self.count = 0
        self._last_log = 0.0
        self._period = log_period_s

    def record(self, solve_time_s: float, budget_s: float) -> None:
        self.count += 1
        now = time.time()
        if now - self._last_log > self._period:
            self._last_log = now
            _LOG.warning(
                "blocking solve %.1f ms exceeds the %.0f ms control period "
                "(%d total): the caller cannot hold the control rate — use "
                "pipeline=True or the async engine (SDEControlNode)",
                solve_time_s * 1e3, budget_s * 1e3, self.count,
            )


@dataclass
class ControlAutomata:
    """Mode machine resolved on every incoming state (``sde_control.py:180-220``).

    ``now_fn`` is injectable for deterministic tests (wall clock by default,
    as the reference uses ``time.time()`` at ``sde_control.py:211``).
    """

    state_from_traj: Optional[Callable] = None
    now_fn: Callable[[], float] = time.time

    pos_control: bool = False
    test_mode: bool = False
    run_trajectory: bool = False
    trajec_time: float = -1.0
    reset_done: bool = False
    weight_motors: int = 0
    target_x: np.ndarray = field(default_factory=lambda: np.asarray(hover_state()))
    _last_traj_time: float = 0.0
    last_state: int = CONTROL_STATES["none"]

    def resolve(self) -> Tuple[int, float, np.ndarray]:
        """One automata tick -> (control_state, trajec_time, target_state).

        Mirrors the reference's precedence: pos-control > no-trajectory
        (none) > trajectory-loaded-but-not-running (idle, target = traj(0)) >
        running (traj, wall-clock window position).
        """
        if self.pos_control:
            self.last_state = CONTROL_STATES["pos"]
        elif self.trajec_time < 0.0:
            self.last_state = CONTROL_STATES["none"]
        elif not self.run_trajectory:
            self.trajec_time = 0.0
            if self.state_from_traj is not None:
                self.target_x = np.asarray(self.state_from_traj(0.0), np.float32)
            self.last_state = CONTROL_STATES["idle"]
        else:
            now = self.now_fn()
            if self.trajec_time == 0:
                self._last_traj_time = now
                self.trajec_time = 1e-7  # sentinel: started (reference :216)
            else:
                self.trajec_time = now - self._last_traj_time
            self.last_state = CONTROL_STATES["traj"]
        return self.last_state, self.trajec_time, self.target_x

    # -- service-level mode switching (``start_trajectory_callback``) --------

    def set_mode(self, mode: int, target_pose: Optional[np.ndarray] = None,
                 weight_motors: int = 110) -> Tuple[bool, str]:
        """FollowTraj-service semantics (``sde_control.py:480-562``).

        ``weight_motors`` in [0,100] is a pure blend update; out-of-range
        values (the reference CLI sends 110) fall through to mode dispatch.
        """
        if 0 <= weight_motors <= 100:
            self.weight_motors = int(weight_motors)
            return True, "weight_motors updated"
        if not self.reset_done and mode != CTRL_INACTIVE:
            return False, "controller not reset: run controller_init first"
        if target_pose is not None:
            target_pose = np.asarray(target_pose, np.float32)
            # The reference's FollowTraj target is a typed ROS pose; over
            # the untyped JSON/UDP channel the shape must be validated or a
            # short list silently broadcasts into all 13 state slots.
            if target_pose.shape != (13,):
                return False, (f"target_pose must be 13 floats "
                               f"[p v q w], got shape {target_pose.shape}")
            self.target_x = target_pose

        if mode == CTRL_TEST:
            self.test_mode = True
            self.pos_control = True
            self.run_trajectory = False
            self.trajec_time = -1.0
            return True, "test mode activated"
        if mode == CTRL_POSE_ACTIVE:
            self.test_mode = False
            self.pos_control = True
            self.run_trajectory = False
            self.trajec_time = -1.0
            return True, "position control activated"
        if mode == CTRL_INACTIVE:
            self.reset_done = False
            self.test_mode = False
            self.pos_control = False
            self.run_trajectory = False
            self.trajec_time = -1.0
            return True, "controller deactivated"
        if self.run_trajectory and mode == CTRL_TRAJ_ACTIVE:
            return False, "trajectory already running"

        # TRAJ_IDLE / TRAJ_ACTIVE: a trajectory only starts from idle
        # (reference ``sde_control.py:548-557``).
        was_idle = self.last_state == CONTROL_STATES["idle"]
        self.trajec_time = 0.0 if mode in (CTRL_TRAJ_IDLE, CTRL_TRAJ_ACTIVE) else -1.0
        if mode == CTRL_TRAJ_ACTIVE and was_idle:
            self.run_trajectory = True
            msg = "trajectory started"
        else:
            self.run_trajectory = False
            msg = "entering idle; re-issue CTRL_TRAJ_ACTIVE from idle to start"
        self.test_mode = False
        self.pos_control = False
        return True, msg


class CompiledMPC:
    """Ahead-of-time compiled solver closures for one config.

    Reproduces the reference's compile-at-startup pipeline
    (``load_single_mpc``: ``jit(f).lower(args).compile()`` + warm call,
    ``sde_control.py:681-721``) so steady-state solves never trace. The
    compiles go through JAX's persistent compilation cache
    (``compile_cache.py``), so a second process with the same code and
    config deserializes instead of compiling.

    ``cfg`` is a config file path or an already-parsed config mapping (as
    returned by ``io.config.load_yaml_config``).

    ``apg_mpc.deadline_ms`` (optional config key) arms DEADLINE-AWARE
    solving: the mpc executable is lowered with the solver's traced
    ``iter_budget`` argument, and :meth:`iter_budget` converts the
    configured per-solve deadline into an iteration cap using a measured
    ms/iteration EWMA (fed back via :meth:`observe_solve`). This bounds
    the solve-latency tail by the control period instead of only by the
    plan-staleness pickup — the reference's budget is the FCU-side 20 ms
    staleness watchdog (``basic_control.py:39``) with nothing bounding
    the solver itself.
    """

    def __init__(self, cfg, seed: int = 0, convert_to_enu: bool = True):
        if isinstance(cfg, str):
            loaded = load_mpc_from_cfgfile(cfg, convert_to_enu=convert_to_enu)
        else:
            loaded = make_mpc_from_config(dict(cfg),
                                          convert_to_enu=convert_to_enu)
        cfg, (reset_fn, mpc_fn), state_from_traj, bundle = loaded
        self.cfg = cfg
        self.bundle = bundle
        self.n_u = bundle.model.n_u
        self.horizon = int(bundle.time_steps.shape[0])
        self.dt_usec = float(cfg["_time_steps"][0]) * 1e6
        self.seed = seed

        apg_blk = cfg.get("apg_mpc") or {}
        self.deadline_ms = float(apg_blk.get("deadline_ms") or 0.0)
        self.deadline_min_iters = int(apg_blk.get("deadline_min_iters", 5))
        self.max_iter = int(apg_blk.get("max_iter", 200))
        # ms/iteration estimate, fed by observe_solve(). Until measured,
        # budgets stay at max_iter (first solves run unconstrained — they
        # are also the ones that calibrate the estimate).
        self._iter_ms = None

        x0 = hover_state()
        rng = jax.random.PRNGKey(seed)

        self.state_from_traj = None
        if state_from_traj is not None:
            self.state_from_traj = jax.jit(state_from_traj).lower(
                jnp.float32(0.01)).compile()

        self.reset = jax.jit(reset_fn).lower(x0, rng, x0).compile()
        self.default_opt_state = self.reset(x0, rng, x0)
        jax.block_until_ready(self.default_opt_state.yk)

        args = (x0, rng, self.default_opt_state, jnp.float32(0.01), x0)
        if self.deadline_ms:
            args += (jnp.int32(self.max_iter),)
        self.mpc = jax.jit(mpc_fn).lower(*args).compile()
        warm = self.mpc(*args)
        jax.block_until_ready(warm.u_opt)

    # ---------------------------------------------- deadline-aware budgeting

    def iter_budget(self) -> int:
        """Iteration cap for the NEXT solve: ``deadline_ms`` over the
        measured ms/iteration, floored at ``deadline_min_iters`` (progress
        is guaranteed — the warm-start shift carries partial convergence
        across doorbells) and capped at ``max_iter``. Unlimited until the
        first measurement arrives."""
        if not self.deadline_ms or self._iter_ms is None:
            return self.max_iter
        b = int(self.deadline_ms / max(self._iter_ms, 1e-3))
        return max(self.deadline_min_iters, min(b, self.max_iter))

    def observe_solve(self, solve_time_s: float, num_steps: float) -> None:
        """Feed a measured (wall solve time, executed iterations) pair into
        the ms/iteration EWMA. The wall time includes dispatch/transfer
        overhead, so the estimate is biased HIGH and the resulting budgets
        are conservative — the solver finishes inside the deadline with
        margin rather than exactly at it."""
        if not self.deadline_ms or num_steps < 1:
            return
        per = solve_time_s * 1e3 / float(num_steps)
        self._iter_ms = (per if self._iter_ms is None
                         else 0.7 * self._iter_ms + 0.3 * per)


class RecedingHorizonController:
    """Dual-solver receding-horizon controller with async plan pickup.

    Synchronous API (the async doorbell runtime wraps this in
    ``io/engine_runtime.py``):

    - :meth:`on_state` — the hot ingress: record state/mode, pick the
      command out of the latest finished plan by time index;
    - :meth:`solve_once` — one solver-loop body: mode dispatch + solve +
      plan publication (what the solver process runs per doorbell).
    """

    def __init__(self, traj_cfg_path: str, pos_cfg_path: str, seed: int = 0,
                 now_fn: Callable[[], float] = time.time,
                 pipeline: bool = False,
                 offset_adaptation: Optional[dict] = None):
        self.traj = CompiledMPC(traj_cfg_path, seed=seed)
        self.pos = CompiledMPC(pos_cfg_path, seed=seed)
        # Opt-in integral reference shaping for the pos/setpoint mode
        # (engine/offset.py): kills the steady hover bias a finite-horizon
        # MPC holds under constant model mismatch. OFF by default —
        # reference parity and the committed goldens are untouched. The
        # integration step is MEASURED from state timestamps (solve rate
        # follows the doorbell rate, not the control period), and the
        # estimator resets wherever the solvers' warm starts do.
        self.offset_est = None
        self._offset_last_usec = None
        if offset_adaptation:
            from sde4mbrl_px4_tpu.engine.offset import DisturbanceEstimator

            self.offset_est = DisturbanceEstimator(
                dt=float(self.pos.dt_usec) / 1e6, **offset_adaptation)
        assert self.traj.state_from_traj is not None, (
            "trajectory config must declare trajectory_path (reference asserts "
            "the same, sde_control.py:164)"
        )
        assert self.pos.state_from_traj is None, (
            "position config must NOT declare trajectory_path (sde_control.py:177)"
        )
        self.automata = ControlAutomata(
            state_from_traj=lambda t: self.traj.state_from_traj(jnp.float32(t)),
            now_fn=now_fn,
        )
        rng = jax.random.PRNGKey(seed)
        self.rng_traj, self.rng_pos = jax.random.split(rng)
        self.opt_state_traj = self.traj.default_opt_state
        self.opt_state_pos = self.pos.default_opt_state

        # Latest finished plan (the reference keeps these in shared memory,
        # ``sde_control.py:616-663``).
        max_h = max(self.traj.horizon, self.pos.horizon)
        max_u = max(self.traj.n_u, self.pos.n_u)
        self.u_plan = np.zeros((max_h, max_u), np.float32)
        self.w_plan = np.zeros((max_h, 4), np.float32)
        self.plan_sample_time_usec = -1.0
        self.plan_is_traj = False
        self.last_record = OptMPCStateRecord()
        self.overruns = OverrunMeter()
        self.budget_warn = BudgetMeter()

        self._curr_ctrl: Optional[str] = None
        self._idle_traj = False

        # Pipelined dispatch (device-resident loop): solve k is dispatched
        # asynchronously and solve k-1 — finished on device during the last
        # control period — is collected, so the per-call wall time is
        # dispatch + transfer instead of a blocking round trip through the
        # solve (the time-indexed pickup absorbs the one-period plan
        # staleness by construction).
        self.pipeline = pipeline
        # In pipeline mode a single-worker executor FETCHES each dispatched
        # solve eagerly (device_get blocks until the device finishes, so the
        # record's solve_time is stamped at true completion and the transfer
        # overlaps the caller's control period); PUBLICATION of the fetched
        # plan still happens on the next solve_once call, keeping the
        # documented publish-(k-1)-at-call-k semantics.
        self._pending = None  # Future over _fetch results
        self._fetcher = (
            ThreadPoolExecutor(max_workers=1, thread_name_prefix="mpc-fetch")
            if pipeline else None
        )

    def close(self) -> None:
        """Release the pipeline fetch worker (no-op in blocking mode).

        Without this, each pipeline=True controller leaks a non-daemon
        executor thread that concurrent.futures joins at interpreter exit —
        a fetch wedged in ``jax.device_get`` on a hung device would then
        block process shutdown."""
        if self._fetcher is not None:
            self._fetcher.shutdown(wait=False, cancel_futures=True)
            self._fetcher = None
            self._pending = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------------------ solve

    def solve_once(self, x: np.ndarray, control_state: int, trajec_time: float,
                   target_x: np.ndarray, sample_time_usec: float) -> OptMPCStateRecord:
        """One solver iteration (reference loop body ``sde_control.py:365-450``).

        In pipeline mode this dispatches the solve for the CURRENT state and
        publishes the plan of the PREVIOUS solve (collected without waiting
        on today's); the published plan carries its own ``sample_time_usec``
        so pickup indexing stays exact. (The async engine uses the finer
        :meth:`solve_async` + :meth:`collect_entry` split instead: a
        collector thread publishes each plan the moment its solve finishes.)
        """
        entry = self.solve_async(x, control_state, trajec_time, target_x,
                                 sample_time_usec)
        if self.pipeline:
            fut = self._fetcher.submit(self._fetch, *entry)
            prev, self._pending = self._pending, fut
            # Cold start (no dispatch in flight): publish the solve just
            # issued — it stays pending too, so the next call already
            # pipelines (the Future caches its fetch, so nothing is
            # transferred twice).
            return self._publish(*(prev if prev is not None else fut).result())
        record = self._collect(*entry)
        budget = (self.traj if self.plan_is_traj else self.pos).dt_usec / 1e6
        if record.solve_time > budget:
            self.budget_warn.record(record.solve_time, budget)
        return record

    def _mpc_call(self, cm: CompiledMPC, x, rng, st, t, xdes):
        """One solver dispatch, appending the deadline iteration budget
        when the config arms it (``apg_mpc.deadline_ms`` — the executable
        is then lowered with the traced budget argument)."""
        if cm.deadline_ms:
            return cm.mpc(x, rng, st, t, xdes, jnp.int32(cm.iter_budget()))
        return cm.mpc(x, rng, st, t, xdes)

    def solve_async(self, x: np.ndarray, control_state: int,
                    trajec_time: float, target_x: np.ndarray,
                    sample_time_usec: float) -> tuple:
        """Dispatch one solve (asynchronous — returns device handles in an
        opaque entry for :meth:`collect_entry`); never blocks on the device.
        Warm-start/rng state advances here, so chained dispatches form the
        same solve sequence as blocking calls."""
        mode = CONTROL_STATE_NAMES.get(int(control_state), "none")
        # Estimator ticks on the incoming HOST state (before the device
        # conversion — np.asarray on a committed jnp array would be a
        # blocking device fetch in the hot dispatch path), POS mode only
        # (idle is the pre-engagement hold: the FCU is typically not
        # executing commands yet and an open-loop integrator would wind
        # up — engine/offset.py), with dt measured from the state
        # timestamps so the integral gain is per-second regardless of the
        # doorbell rate.
        if self.offset_est is not None:
            if mode == "pos":
                dt_s = (None if self._offset_last_usec is None else
                        (sample_time_usec - self._offset_last_usec) / 1e6)
                target_x = self.offset_est.update(np.asarray(x), target_x,
                                                  dt_s)
                self._offset_last_usec = sample_time_usec
            else:
                self._offset_last_usec = None
        x = jnp.asarray(x, jnp.float32)
        t0 = time.perf_counter()

        if self._curr_ctrl is None or (self._curr_ctrl == "none" and mode != "none"):
            self.opt_state_traj = self.traj.reset(x, self.rng_traj, x)
            self.opt_state_pos = self.pos.reset(x, self.rng_pos, x)
            if self.offset_est is not None:
                self.offset_est.reset()   # fresh engagement, fresh integral
        if mode == "idle" and self._curr_ctrl in (None, "none", "pos"):
            self.opt_state_traj = self.traj.reset(x, self.rng_traj, x)
            self._idle_traj = True

        target = jnp.asarray(target_x, jnp.float32)
        tt = jnp.float32(max(trajec_time, 0.0))

        if mode == "none":
            self._curr_ctrl = "none"
            # Hold current state: xdes = state expressed in the xdes frame
            # (involution; reference ``sde_control.py:400``).
            from sde4mbrl_px4_tpu.core.frames import ned2enu
            sol = self._mpc_call(self.pos, x, self.rng_pos, self.opt_state_pos, jnp.float32(0.0), ned2enu(x))
            self.opt_state_pos, self.rng_pos = sol.opt_state, sol.rng
            used = self.opt_state_pos
        elif mode == "idle":
            self._curr_ctrl = "idle"
            sol = self._mpc_call(self.pos, x, self.rng_pos, self.opt_state_pos, jnp.float32(0.0), target)
            self.opt_state_pos, self.rng_pos = sol.opt_state, sol.rng
            self._idle_traj = not self._idle_traj
            if self._idle_traj:
                # Pre-warm the trajectory solver every 2nd tick (:402-408).
                pre = self._mpc_call(self.traj, x, self.rng_traj, self.opt_state_traj, tt, x)
                self.opt_state_traj, self.rng_traj = pre.opt_state, pre.rng
            used = self.opt_state_traj
        elif mode == "traj":
            self._curr_ctrl = "traj"
            sol = self._mpc_call(self.traj, x, self.rng_traj, self.opt_state_traj, tt, x)
            self.opt_state_traj, self.rng_traj = sol.opt_state, sol.rng
            used = self.opt_state_traj
        elif mode == "pos":
            self._curr_ctrl = "pos"
            sol = self._mpc_call(self.pos, x, self.rng_pos, self.opt_state_pos, jnp.float32(0.0), target)
            self.opt_state_pos, self.rng_pos = sol.opt_state, sol.rng
            used = self.opt_state_pos
        else:
            raise ValueError(f"unknown control state {control_state}")

        # Start device->host streaming of everything _collect will read, so
        # the eventual fetch is a local copy instead of a synchronous
        # round trip issued after completion.
        for arr in (sol.u_opt, sol.x_evol, used.avg_linesearch,
                    used.stepsize, used.num_steps, used.grad_sqr,
                    used.avg_stepsize, used.init_cost, used.opt_cost):
            arr.copy_to_host_async()

        return (sol, used, mode, int(control_state), float(sample_time_usec), t0)

    def collect_entry(self, entry: tuple) -> OptMPCStateRecord:
        """Block on a dispatched entry and publish its plan + stats."""
        return self._collect(*entry)

    def _collect(self, sol, used, mode: str, control_state: int,
                 sample_time_usec: float, t0: float) -> OptMPCStateRecord:
        """Block on one dispatched solve, publish its plan + stats."""
        return self._publish(*self._fetch(sol, used, mode, control_state,
                                          sample_time_usec, t0))

    def _fetch(self, sol, used, mode: str, control_state: int,
               sample_time_usec: float, t0: float) -> tuple:
        """Block until a dispatched solve completes and pull its outputs to
        host. No controller state is mutated — safe off-thread."""
        # One host transfer for everything the plan needs.
        u_opt, x_evol, stats_host = jax.device_get(
            (sol.u_opt, sol.x_evol,
             (used.avg_linesearch, used.stepsize, used.num_steps,
              used.grad_sqr, used.avg_stepsize, used.init_cost, used.opt_cost))
        )
        u_opt = np.asarray(u_opt)
        x_evol = np.asarray(x_evol)
        # device_get returns when the solve has finished AND its outputs
        # landed on host, so this stamp is dispatch -> completion+transfer
        # regardless of when the plan is later published.
        solve_time = time.perf_counter() - t0
        return (u_opt, x_evol, stats_host, mode, control_state,
                sample_time_usec, solve_time)

    def _publish(self, u_opt, x_evol, stats_host, mode: str,
                 control_state: int, sample_time_usec: float,
                 solve_time: float) -> OptMPCStateRecord:
        """Publish a fetched plan + stats (latest-wins)."""
        # thrust = motor mean; rates from predicted trajectory (:431-432).
        thrust = np.sum(u_opt, axis=1) / u_opt.shape[1]
        w_opt = np.stack(
            [thrust, x_evol[1:, 10], x_evol[1:, 11], x_evol[1:, 12]], axis=-1
        ).astype(np.float32)

        self.u_plan[: u_opt.shape[0], : u_opt.shape[1]] = u_opt
        self.w_plan[: w_opt.shape[0]] = w_opt
        self.plan_sample_time_usec = float(sample_time_usec)
        # Pickup metadata follows the solver that PRODUCED the plan: idle
        # publishes the pos solve (the traj solver only pre-warms), so only
        # 'traj' plans index with the traj solver's horizon/n_u/dt — the
        # reference sizes u_shape the same way (``sde_control.py:293``).
        self.plan_is_traj = mode == "traj"

        avg_ls, stepsize, num_steps, grad_sqr, avg_stepsize, c0, cT = stats_host
        # Deadline budgeting: calibrate the producing solver's ms/iteration
        # EWMA from this measured (wall time, iterations) pair. Idle mode
        # is excluded: it publishes the POS solve's plan but the TRAJ
        # pre-warm's stats (reference idle semantics), and its wall time
        # spans BOTH solves — pairing those would corrupt the estimate.
        if mode == "traj":
            self.traj.observe_solve(solve_time, float(num_steps))
        elif mode in ("pos", "none"):
            self.pos.observe_solve(solve_time, float(num_steps))
        self.last_record = OptMPCStateRecord(
            stamp=time.time(), avg_linesearch=float(avg_ls),
            avg_stepsize=float(avg_stepsize), stepsize=float(stepsize),
            grad_norm=float(grad_sqr), cost_init=float(c0), opt_cost=float(cT),
            num_steps=int(num_steps), solve_time=solve_time,
            callback_dt=0.0, state_dt=0.0,
            ctrl_state=CONTROL_STATE_NAMES.get(int(control_state), "none"),
            mpc_indx=0,
        )
        return self.last_record

    # ----------------------------------------------------------------- pickup

    def pick_command(self, sample_time_usec: float) -> Optional[Tuple[np.ndarray, np.ndarray, int]]:
        """Time-indexed plan pickup (reference ``sde_control.py:283-308``).

        Returns (motor_cmd[6], thrust_and_rates[4], index) or None when no
        plan has completed yet. A pickup past the planning horizon means
        the solver missed real time — it is clamped AND counted + logged
        (reference clamps and ``logerr``s, ``sde_control.py:294-298``).
        """
        if self.plan_sample_time_usec <= 0:
            return None
        active = self.traj if self.plan_is_traj else self.pos
        idx = self.overruns.clamp(
            int((sample_time_usec - self.plan_sample_time_usec) / active.dt_usec),
            active.horizon,
            (sample_time_usec - self.plan_sample_time_usec) / 1e3,
        )
        u = self.u_plan[idx, : active.n_u]
        if u.shape[0] < 6:
            u = np.concatenate([u, np.zeros(6 - u.shape[0], np.float32)])
        return u.copy(), self.w_plan[idx].copy(), idx

    # ------------------------------------------------------------------ state

    def on_state(self, x: np.ndarray, sample_time_usec: float):
        """Hot ingress tick: resolve automata, return picked command.

        (The solve itself is triggered separately — by the async runtime's
        doorbell — exactly like the reference callback never waits for a
        solve, ``sde_control.py:223-325``.)
        """
        control_state, trajec_time, target = self.automata.resolve()
        cmd = self.pick_command(sample_time_usec)
        return control_state, trajec_time, target, cmd
