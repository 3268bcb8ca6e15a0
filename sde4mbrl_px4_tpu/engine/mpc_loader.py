"""MPC factory: config file -> jittable (reset, mpc) closures (L5).

Re-implements the external-library entry point whose call-site contract the
reference pins down (SURVEY.md §2.9):

    cfg, (reset_fn, mpc_fn), state_from_traj, bundle = \
        load_mpc_from_cfgfile(path, convert_to_enu=True)      # sde_control.py:685

- ``cfg['_time_steps']``: per-step dt list; step 0 defines the control
  indexing period (``sde_control.py:167``).
- ``state_from_traj(t) -> x(13)`` or None when the config has no
  ``trajectory_path`` (asserted by the reference at ``sde_control.py:164,177``).
- ``reset_fn(x, rng, xdes) -> APGState`` warm-start initializer.
- ``mpc_fn(x, rng, opt_state, curr_t=, xdes=) ->
  (uopt[H,n_u], opt_state', rng', x_evol[H+1,13])`` (``sde_control.py:412``);
  ``x_evol`` rows 1.. carry the predicted body rates at cols 10..12
  (``sde_control.py:432``); ``opt_state'`` carries the one-step-shifted warm
  start for the next solve.

Frame convention (derived from the reference call sites, see
``core/frames.py``): the solver operates in NED/FRD (the FCU frame the
state arrives in, ``sde_control.py:228``). With ``convert_to_enu=True``,
``xdes`` inputs are interpreted as ENU/FLU (ROS-side setpoints,
``sde_control.py:186-192``) and converted internally, and trajectory CSVs
(ENU, ``geometric_controller.cpp:463``) are converted at load. This makes
every reference call site consistent, including the 'none'-mode call
``mpc_pos_solver(x, ..., xdes=enu2ned(curr_state))`` (``sde_control.py:400``)
since the world-frame swap is an involution.

Config keys beyond the reference schema (all optional, all default to
reference-parity behavior):

- ``antithetic: true`` — paired (z, -z) Monte-Carlo paths (variance
  reduction; tests/test_rollout.py);
- ``initial_state_std`` — scenario-robust MPC over state-estimate noise
  (scalar or 13-vector std; needs ``num_particles > 1``);
- ``warm_shift: repeat|extrapolate`` — receding-horizon tail guess
  (measured: extrapolate is worse, 172 vs 73 steps mean — keep repeat);
- ``matmul_precision: highest|tf32`` — precision of the dynamics-trunk
  matmuls (default: float32 ``highest`` for reference-parity P<=128, TF32
  for large P; see ``models/sde_model.resolve_precision``);
- ``cost_params.risk_lambda`` — risk-sensitive particle reduction
  mean + lambda*std (SURVEY.md §7 L3); 0/absent = risk-neutral parity;
- ``solver: mppi`` + ``mppi:`` block — sampling-based MPPI solver family
  (solver/mppi.py) instead of the reference's gradient APG;
- ``solver: policy`` + ``policy: {params_path, hidden}`` — amortized
  one-shot plan network distilled from converged APG solves
  (models/policy.py + learning/distill.py);
- ``policy: {refine_iters: N}`` — the hybrid: the network seeds COLD
  starts (straight after reset), the shifted previous plan seeds steady
  solves, and N APG iterations polish either (measured frontier on the
  lemniscate, chained mean-dynamics: shift+3 iters 0.027 m, shift+10
  0.014 m, full 200-budget 0.005 m; pure policy 0.058 m — so the network
  buys the engagement transient and fleet batch serving, the iteration
  budget buys steady-state tracking).

Every solver family is one plain JAX/``lax`` program: the cost, its
gradient and the batched linesearch candidates are XLA-compiled rollouts
(``ops/rollout.py``) inside the solver's ``lax.while_loop``.
"""
from __future__ import annotations

import hashlib
import json
import os
import warnings
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core.frames import enu2ned
from sde4mbrl_px4_tpu.core.types import MPCSolution
from sde4mbrl_px4_tpu.cost.cost import CostParams, make_cost_fn
from sde4mbrl_px4_tpu.io.config import (
    input_bounds_from_config,
    load_yaml_config,
    reject_removed_keys,
)
from sde4mbrl_px4_tpu.models.params_io import load_params
from sde4mbrl_px4_tpu.models.sde_model import NeuralSDE, init_params
from sde4mbrl_px4_tpu.models.trajectory import load_trajectory_csv, make_state_from_traj
from sde4mbrl_px4_tpu.models.vehicles import iris_config, hexa_config
from sde4mbrl_px4_tpu.ops.rollout import (
    make_time_steps, rollout_mean, rollout_sde,
)
from sde4mbrl_px4_tpu.solver.apg import APGConfig, APGState, apg_solve
from sde4mbrl_px4_tpu.solver.mppi import MPPIConfig, mppi_solve

__all__ = ["load_mpc_from_cfgfile", "MPCBundle", "make_mpc_from_config"]


class MPCBundle(NamedTuple):
    """Everything behind the closures — for tests, benchmarks and sharding."""

    model: NeuralSDE
    params: Dict[str, Any]
    cost_params: CostParams
    apg_config: APGConfig
    time_steps: jax.Array      # (H,)
    knot_times: jax.Array      # (H+1,) cumulative times incl. 0
    lb: jax.Array
    ub: jax.Array
    num_particles: int
    state_from_traj: Optional[Callable]
    convert_to_enu: bool
    precision: jax.lax.Precision   # dynamics-trunk matmul precision


def _resolve_model(cfg: Dict[str, Any]) -> Tuple[NeuralSDE, Dict[str, Any]]:
    n_u = len(cfg["input_constr"]["input_id"])
    vehicle = iris_config() if n_u == 4 else hexa_config()
    model = NeuralSDE(vehicle=vehicle)
    ckpt = cfg.get("learned_model_params")
    if ckpt and os.path.exists(os.path.expanduser(ckpt)):
        params, meta = load_params(ckpt)
        if meta.get("vehicle") not in (None, vehicle.name):
            warnings.warn(
                f"checkpoint vehicle {meta.get('vehicle')!r} != config vehicle {vehicle.name!r}"
            )
    else:
        if ckpt:
            warnings.warn(
                f"learned_model_params {ckpt!r} not found; initializing fresh physics-prior model"
            )
        params = init_params(jax.random.PRNGKey(0), model)
    params = jax.tree.map(jnp.asarray, params)
    return model, params


_PRECOND_VERSION = "hover_diag-v1"


def _precond_cache_paths(cfg: Dict[str, Any], key: str) -> list:
    """Candidate cache files for a precomputed preconditioner, most
    preferred first: next to the model checkpoint (ships as a committed
    artifact with the flagship configs), else a per-user cache dir."""
    cands = []
    env = os.environ.get("SDE4MBRL_PRECOND_CACHE")
    if env:
        cands.append(os.path.join(env, f"{key}.npy"))
    ckpt = cfg.get("learned_model_params")
    if ckpt:
        ckpt = os.path.expanduser(ckpt)
        if os.path.exists(ckpt):
            cands.append(os.path.join(os.path.dirname(ckpt), "precond",
                                      f"{key}.npy"))
    cands.append(os.path.join(os.path.expanduser("~"), ".cache",
                              "sde4mbrl_px4_tpu", "precond", f"{key}.npy"))
    return cands


def _precond_cache_key(cfg: Dict[str, Any], vehicle_name: str,
                       time_steps_np: np.ndarray, lb_np: np.ndarray,
                       ub_np: np.ndarray, nZ: int,
                       convert_to_enu: bool) -> str:
    """Content hash of every input the hover_diag probe depends on: the
    checkpoint bytes (or the fresh-init tag), the cost/constraint config,
    the horizon schedule, the input box, and the trajectory table bytes.
    Formula changes bump ``_PRECOND_VERSION``."""
    h = hashlib.sha256()
    h.update(_PRECOND_VERSION.encode())
    ckpt = os.path.expanduser(cfg.get("learned_model_params") or "")
    if ckpt and os.path.exists(ckpt):
        with open(ckpt, "rb") as f:
            h.update(f.read())
    else:
        h.update(f"fresh:{vehicle_name}".encode())
    # "discount" weights every stage of the probe's cost (cost/cost.py
    # reads the top-level key) — it must invalidate like the weight dicts.
    for k in ("cost_params", "state_constr", "input_constr", "discount"):
        h.update(json.dumps(cfg.get(k), sort_keys=True, default=str).encode())
    h.update(np.asarray(time_steps_np, np.float64).tobytes())
    h.update(np.asarray(lb_np).tobytes())
    h.update(np.asarray(ub_np).tobytes())
    h.update(f"nZ={nZ};enu={bool(convert_to_enu)}".encode())
    traj = os.path.expanduser(cfg.get("trajectory_path") or "")
    if traj and os.path.exists(traj):
        with open(traj, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:24]


def make_mpc_from_config(
    cfg: Dict[str, Any],
    convert_to_enu: bool = True,
    particle_sharding=None,
    mppi_params: Optional[MPPIConfig] = None,
    state_from_traj: Optional[Callable] = None,
    cost_params_override: Optional[CostParams] = None,
) -> Tuple[Dict[str, Any], Tuple[Callable, Callable], Optional[Callable], MPCBundle]:
    """Core factory; ``cfg`` is an already-parsed config mapping.

    ``particle_sharding``: optional ``NamedSharding`` for the (H, P, 13)
    Brownian-increment block — shards the Monte-Carlo particle axis of every
    rollout inside the solve over the mesh's ``mc`` axis (L6; see
    ``parallel/mesh.py``).
    """
    reject_removed_keys(cfg)
    model, params = _resolve_model(cfg)
    n_u = model.n_u

    time_steps_np = make_time_steps(
        cfg["horizon"], cfg["num_short_dt"], cfg["short_step_dt"], cfg["long_step_dt"]
    )
    cfg["_time_steps"] = [float(d) for d in time_steps_np]
    time_steps = jnp.asarray(time_steps_np)
    # numpy, then ONE upload: eager device arithmetic here would compile a
    # tiny program per primitive.
    knot_times = jnp.asarray(np.concatenate(
        [np.zeros(1, np.float32),
         np.cumsum(np.asarray(time_steps_np, np.float32))]))
    H = int(time_steps.shape[0])

    lb_np, ub_np = input_bounds_from_config(cfg)
    lb, ub = jnp.asarray(lb_np), jnp.asarray(ub_np)
    # ``cost_params_override``: the tuner's hook (tuning/tuner.py) — a
    # CostParams whose ARRAY fields may be jax tracers (shapes must match
    # what ``from_config`` builds; dict-level routing keys like
    # ``risk_lambda`` are still read from ``cfg``), so a grid of candidate
    # weight settings sweeps inside one vmapped program.
    cost_params = (CostParams.from_config(cfg, n_u)
                   if cost_params_override is None else cost_params_override)
    apg_cfg = APGConfig.from_config(cfg)
    num_particles = int(cfg.get("num_particles", 1))

    # Proximal-slack state constraints (``slack_proximal: True``) augment
    # the decision sequence with one slack-target column per constrained
    # state; the solver's box projection (its proximal step) keeps the
    # targets inside the state bounds (``cost/cost.py`` documents the
    # formulation; reference schema ``hexa_posctrl_mpc.yaml:27-40``).
    prox_m = (0 if cost_params.slack_sel is None
              else int(cost_params.slack_sel.shape[0]))
    if prox_m:
        lb_z = jnp.concatenate([lb, cost_params.slack_lo])
        ub_z = jnp.concatenate([ub, cost_params.slack_hi])
    else:
        lb_z, ub_z = lb, ub

    # Trajectory tables keep the CSV's own frame (ENU,
    # ``geometric_controller.cpp:463``): with convert_to_enu=True the public
    # API boundary is "xdes / state_from_traj in ENU, FCU state in NED" —
    # the reference's convention, where idle mode feeds state_from_traj(0)
    # straight into the position solver as a target
    # (``sde_control.py:206,405``). The NED conversion for the solver's
    # internal reference happens in ``_build_ref``.
    # ``state_from_traj`` may be passed in pre-built (same ENU convention):
    # CSV parsing is host-side numpy, so a caller constructing these
    # closures INSIDE a traced context (the tuner's vmapped candidate
    # sweep, ``tuning/tuner.py``) loads the table once outside and hands
    # the sampler in.
    state_from_traj_ned = None
    if state_from_traj is None:
        traj_path = cfg.get("trajectory_path")
        if traj_path:
            table = load_trajectory_csv(traj_path, convert_to_ned=False)
            state_from_traj = make_state_from_traj(table)
            if convert_to_enu:
                # Internal NED twin of the sampler: the solver's per-solve
                # reference build otherwise pays an enu2ned quaternion
                # chain over H+1 rows EVERY solve. The conversion is
                # linear and norm-preserving, so converting the KNOTS once
                # at load and lerping in NED is equivalent to lerping in
                # ENU and converting per solve (same normalize-after-lerp,
                # fp-rounding-level differences only).
                from sde4mbrl_px4_tpu.models.trajectory import (
                    TrajectoryTable, host_device)

                with jax.default_device(host_device()):
                    states_ned = np.asarray(
                        enu2ned(jnp.asarray(table.states)), np.float32)
                state_from_traj_ned = make_state_from_traj(
                    TrajectoryTable(times=table.times, states=states_ned))

    # Matmul precision of the dynamics trunk: float32 HIGHEST for the
    # reference-parity configs (P <= 128). Large Monte-Carlo batches
    # default to TF32 tensor-core inputs with float32 accumulation: the
    # sampling noise of a P > 128 cost estimate dominates TF32's 10-bit
    # mantissa rounding. Override with the ``matmul_precision`` config key.
    from sde4mbrl_px4_tpu.models.sde_model import resolve_precision

    mm_precision = resolve_precision(
        cfg.get("matmul_precision",
                "tf32" if num_particles > 128 else "highest")
    )
    bundle = MPCBundle(
        model=model,
        params=params,
        cost_params=cost_params,
        apg_config=apg_cfg,
        time_steps=time_steps,
        knot_times=knot_times,
        lb=lb,
        ub=ub,
        num_particles=num_particles,
        state_from_traj=state_from_traj,
        convert_to_enu=convert_to_enu,
        precision=mm_precision,
    )

    if cfg["cost_params"].get("risk_lambda") and num_particles <= 1:
        raise ValueError(
            "cost_params.risk_lambda needs num_particles > 1 — with one "
            "particle there is no outcome spread to price")
    # Solver family: the reference's gradient-based APG (default) or the
    # sampling-based MPPI twin (``solver: mppi``; solver/mppi.py), whose K
    # candidate evaluations are one batched (K, feat) rollout.
    solver_kind = str(cfg.get("solver", "apg"))
    if solver_kind not in ("apg", "mppi", "policy"):
        raise ValueError(f"unknown solver {solver_kind!r} (apg|mppi|policy)")
    # ``mppi_params`` overrides the config-file block; its CONTINUOUS knobs
    # (sigma/temperature/noise_beta) may be jax tracers — the hook the
    # hyper-parameter tuner (tuning/tuner.py) uses to sweep a grid of
    # candidate controllers inside one vmapped program. samples/iters stay
    # static (they size the compiled loops).
    mppi_cfg = (MPPIConfig.from_config(cfg) if mppi_params is None
                else mppi_params)
    # Amortized-policy solver family (``solver: policy`` + ``policy:``
    # block): the distilled one-shot plan network (models/policy.py,
    # trained by learning/distill.py). The whole "solve" is three matmuls
    # + one telemetry rollout.
    policy_net = None
    if solver_kind == "policy":
        if prox_m:
            raise ValueError(
                "solver: policy does not support slack_proximal state "
                "constraints — the policy head predicts motor plans only "
                "(distill an expert WITHOUT slack, or keep solver: apg)")
        from sde4mbrl_px4_tpu.models import policy as _policy_mod

        pol_block = cfg.get("policy") or {}
        ppath = pol_block.get("params_path")
        if ppath and os.path.exists(os.path.expanduser(ppath)):
            policy_net, pmeta = load_params(ppath)
            policy_net = jax.tree.map(jnp.asarray, policy_net)
            if pmeta.get("kind") not in (None, _policy_mod.POLICY_KIND):
                raise ValueError(
                    f"policy.params_path {ppath!r} is not an MPC policy "
                    f"checkpoint (meta {pmeta!r})")
            if (int(policy_net["meta_H"]) != H
                    or int(policy_net["meta_n_u"]) != n_u):
                raise ValueError(
                    f"policy checkpoint horizon/motors ({int(policy_net['meta_H'])},"
                    f" {int(policy_net['meta_n_u'])}) != config ({H}, {n_u})")
        else:
            if ppath:
                # An explicitly configured checkpoint that is missing must
                # be a hard error: in a serving path a typo'd params_path
                # degrading to an untrained hover policy is a controller
                # that silently ignores its reference. The untrained-init
                # fallback is reserved for configs that OMIT params_path
                # (training / bench use).
                raise ValueError(
                    f"policy.params_path {ppath!r} does not exist — refusing "
                    "to serve an untrained hover policy in its place. Train "
                    "one with learning/distill.py (save_policy), or drop "
                    "params_path to explicitly request an untrained init.")
            # lb_np/ub_np + a numpy uref: np.asarray on the device arrays
            # would be a load-path device->host fetch (see precond note).
            uref_np = np.broadcast_to(np.asarray(
                cfg["cost_params"]["uref"], np.float32), (n_u,))
            policy_net = jax.tree.map(jnp.asarray, _policy_mod.init_policy(
                jax.random.PRNGKey(int(cfg.get("seed", 0))), H, n_u,
                lb_np, ub_np, uref_np,
                hidden=tuple(pol_block.get("hidden", (256, 256)))))
        _policy_apply = _policy_mod.policy_apply
        _policy_featurize = _policy_mod.featurize
        # ``policy: {refine_iters: N}`` — the amortized-init solver family:
        # the plan network's output becomes the APG warm start and N (small)
        # APG iterations polish it. Buys back the distillation gap (policy
        # u[0] noise is a few % of the motor span) for a few iterations'
        # latency instead of the full 200-iteration budget; N=0 (default)
        # keeps the pure one-shot policy.
        policy_refine = int(pol_block.get("refine_iters", 0) or 0)
        if policy_refine < 0:
            raise ValueError(f"policy.refine_iters must be >= 0, got "
                             f"{policy_refine}")
        if policy_refine:
            apg_cfg = apg_cfg._replace(
                max_iter=policy_refine,
                max_no_improvement_iter=policy_refine)
    else:
        policy_refine = 0

    warm_shift = str(cfg.get("warm_shift", "repeat"))
    # Antithetic Monte-Carlo particles (opt-in ``antithetic: true``): paired
    # (z, -z) Brownian paths — unbiased, lower-variance uncertainty cost at
    # zero extra rollout work (ops/rollout.draw_brownian).
    antithetic = bool(cfg.get("antithetic", False))
    # Initial-state (state-estimate) uncertainty: each particle rolls out
    # from its own perturbed start — scenario-robust MPC over the particle
    # axis (ops/rollout x0_spread). Scalar or 13-vector std.
    init_std = cfg.get("initial_state_std")
    if init_std is not None:
        if num_particles <= 1:
            raise ValueError(
                "initial_state_std needs num_particles > 1 — the "
                "deterministic single-particle path rolls the mean "
                "dynamics and would silently ignore the scenario spread")
        init_std = jnp.broadcast_to(
            jnp.asarray(init_std, jnp.float32), (13,))
    cost_fn = make_cost_fn(cost_params, time_steps)
    # Host-side (numpy) hover plan from the CONFIG values, ONE upload —
    # eager device broadcast/clip/concat here would compile a tiny program
    # per primitive.
    uref_np_h = np.broadcast_to(np.broadcast_to(np.asarray(
        cfg["cost_params"]["uref"], np.float32), (n_u,)), (H, n_u))
    if prox_m:
        # Admissible slack targets at rest: 0 clipped into the state box
        # (same construction as cost.py's slack_lo/slack_hi).
        b_np = np.asarray(cfg["state_constr"]["state_bound"], np.float32)
        s_hover_np = np.broadcast_to(
            np.clip(np.zeros(prox_m, np.float32), b_np[:, 0], b_np[:, 1]),
            (H, prox_m))
        z_hover = jnp.asarray(
            np.concatenate([uref_np_h, s_hover_np], axis=1))
    else:
        z_hover = jnp.asarray(uref_np_h)

    # Diagonal curvature preconditioner (``apg_mpc.precond: hover_diag``,
    # opt-in). The MPC cost's diagonal curvature decays ~580x from horizon
    # row 0 to row H-1 (early controls steer the whole downstream
    # trajectory; measured, tools/curvature_probe.py) and that conditioning
    # sets the APG iteration count. The exact Hessian diagonal at a
    # representative operating point (trajectory start, hover controls) is
    # computed ONCE at load time via H*n_z vmapped HVPs and baked into the
    # solve as a constant diagonal metric: step proj(y - t*D*g), Armijo
    # quadratic <d, D^{-1}d>/(2t) (solver/apg.py::apg_solve(precond=...)).
    # Measured on the pinned headline window: ~2x fewer warm iterations at
    # identical plan cost/tracking (tools/iter_ab.py).
    precond_mode = str(cfg["apg_mpc"].get("precond") or "none")
    if precond_mode not in ("none", "hover_diag"):
        raise ValueError(
            f"apg_mpc.precond must be 'hover_diag' or omitted, got "
            f"{precond_mode!r}")
    precond_diag = None
    if precond_mode == "hover_diag" and solver_kind in ("apg", "policy"):
        nZ_p = n_u + prox_m
        # The probe is a pure function of the load inputs, and its H*nZ
        # vmapped HVPs are the single most expensive compile of node
        # bring-up. Disk-cache the RESULT keyed by a content hash of every
        # input — the flagship configs ship the precomputed artifact next
        # to their checkpoint (configs/models/precond/), so a cold process
        # loads 80 floats instead of compiling an HVP program. Also makes
        # the metric bit-identical across backends (CPU tests load the same
        # artifact the GPU engine uses).
        pkey = _precond_cache_key(cfg, model.vehicle.name, time_steps_np,
                                  lb_np, ub_np, nZ_p, convert_to_enu)
        pcands = _precond_cache_paths(cfg, pkey)
        precond_np = None
        for cand in pcands:
            if os.path.exists(cand):
                try:
                    precond_np = np.load(cand)
                except Exception:  # corrupt cache: recompute below
                    precond_np = None
                if (precond_np is not None
                        and precond_np.shape == (H, nZ_p)):
                    break
                precond_np = None
        if precond_np is None:
            if state_from_traj is not None:
                ref0 = state_from_traj(knot_times)
                x_ref_p = enu2ned(ref0) if convert_to_enu else ref0
            else:
                from sde4mbrl_px4_tpu.core.types import hover_state
                x_ref_p = jnp.broadcast_to(hover_state(), (H + 1, 13))
            x_p = x_ref_p[0]
            u_prev_p = z_hover[0, :n_u]
            rng_p = jax.random.PRNGKey(0)

            def _cost_probe(z_seq):
                u_seq = z_seq[:, :n_u] if prox_m else z_seq
                s_seq = z_seq[:, n_u:] if prox_m else None
                x_paths, sigmas = rollout_sde(
                    model, params, x_p, u_seq, time_steps, rng_p, 1,
                    deterministic=True)
                return cost_fn(x_paths, sigmas, u_seq, x_ref_p, u_prev_p,
                               s_seq=s_seq)

            _g_probe = jax.grad(_cost_probe)

            def _hess_diag(i):
                e = jnp.zeros((H * nZ_p,)).at[i].set(1.0).reshape(H, nZ_p)
                return jnp.sum(jax.jvp(_g_probe, (z_hover,), (e,))[1] * e)

            d = jax.jit(jax.vmap(_hess_diag))(jnp.arange(H * nZ_p))
            d = jnp.reshape(d, (H, nZ_p))
            # Strictly positive metric: floor at a fraction of the peak so
            # a (near-)flat or locally concave direction cannot blow the
            # step up.
            d = jnp.maximum(d, 1e-4 * jnp.max(d))
            # np.asarray here is a device->host fetch — acceptable ONLY on
            # the cache-miss path (one-time per config content; the
            # artifact ships for the flagship configs). max(D) == 1.
            precond_np = np.asarray(jnp.min(d) / d, np.float32)
            for cand in pcands:
                try:
                    os.makedirs(os.path.dirname(cand), exist_ok=True)
                    tmp = f"{cand}.tmp.{os.getpid()}"
                    with open(tmp, "wb") as f:
                        np.save(f, precond_np)
                    os.replace(tmp, cand)
                    break
                except OSError:
                    continue  # read-only install: try the next location
        precond_diag = jnp.asarray(precond_np, jnp.float32)

    def reset_fn(x: jax.Array, rng: jax.Array, xdes: jax.Array) -> APGState:
        """State-aware warm-start initializer (contract:
        ``sde_control.py:702,706-707``; the reference leaves reset
        internals to the external library, SURVEY.md §2.9).

        Rather than restarting at the bare hover sequence, the initial
        controls compensate the CURRENT state so the engagement transient
        shrinks (measured in ``tests/test_engine.py``):

        - attitude: at tilt, collective thrust scales by ``1/cos(tilt)``
          to keep the vertical force balance;
        - vertical rate: a proportional term on NED vz (down-positive)
          opposes descent/climb at hand-off.

        ``xdes`` is unused (a position error needs no thrust bias at reset;
        the solver closes it). Stats fields start at 0.
        """
        del rng, xdes
        x = jnp.asarray(x, jnp.float32)
        qx, qy = x[7], x[8]
        cos_tilt = 1.0 - 2.0 * (qx * qx + qy * qy)   # R[2,2] of q
        scale = 1.0 / jnp.maximum(cos_tilt, 0.5)
        scale = scale + 0.3 * x[5]                   # vz damping (NED)
        u0 = jnp.clip(cost_params.uref * jnp.clip(scale, 0.7, 1.5), lb, ub)
        yk0 = jnp.broadcast_to(u0, (H, n_u))
        if prox_m:
            yk0 = jnp.concatenate(
                [yk0, jnp.broadcast_to(z_hover[0, n_u:], (H, prox_m))], axis=1
            )
        z = jnp.float32(0.0)
        return APGState(
            yk=yk0, num_steps=z, stepsize=jnp.float32(apg_cfg.init_stepsize),
            avg_stepsize=z, avg_linesearch=z, grad_sqr=z, init_cost=z, opt_cost=z,
        )

    def _build_ref(curr_t: jax.Array, xdes: jax.Array) -> jax.Array:
        """Per-stage reference states (H+1, 13) in the solver frame (NED)."""
        if state_from_traj is not None:
            if convert_to_enu:
                if state_from_traj_ned is not None:
                    return state_from_traj_ned(curr_t + knot_times)
                # caller-supplied sampler (tuner path): no NED twin
                return enu2ned(state_from_traj(curr_t + knot_times))
            return state_from_traj(curr_t + knot_times)
        return jnp.broadcast_to(xdes, (H + 1, 13))

    def mpc_fn(
        x: jax.Array,
        rng: jax.Array,
        opt_state: APGState,
        curr_t: jax.Array = 0.0,
        xdes: Optional[jax.Array] = None,
        iter_budget: Optional[jax.Array] = None,
    ) -> MPCSolution:
        """(docstring: module header). ``iter_budget`` (optional traced
        scalar int) is the deadline-aware iteration cap for EVERY family
        whose solve is an APG loop — the plain APG solvers AND the
        policy+``refine_iters`` hybrid, whose polish runs
        ``apg_solve(iter_budget=...)`` and therefore executes
        ``min(refine_iters, budget)`` iterations (pinned by
        tests/test_deadline.py). Ignored only by mppi and the pure
        one-shot policy (their per-solve cost is fixed by
        samples/topology, not an iteration loop)."""
        x = jnp.asarray(x, jnp.float32)
        xdes = x if xdes is None else jnp.asarray(xdes, jnp.float32)
        if convert_to_enu and state_from_traj is None:
            xdes = enu2ned(xdes)
        curr_t = jnp.asarray(curr_t, jnp.float32)
        if solver_kind == "mppi":
            # Extra stream for exploration noise; the 2-way split is kept
            # for APG so its Brownian draws (and the stored golden traces)
            # are untouched.
            rng_noise, rng_mppi, rng_next = jax.random.split(rng, 3)
        elif num_particles <= 1:
            # Mean-dynamics configuration: no Brownian increments are ever
            # drawn, so the threefry split would be pure per-solve overhead
            # — the key passes through unchanged
            # (stream-equivalent: with zero draws the stream position is
            # unobservable; seed-independence is pinned by
            # tests/test_determinism.py).
            rng_noise, rng_next = rng, rng
        else:
            rng_noise, rng_next = jax.random.split(rng)

        x_ref = _build_ref(curr_t, xdes)
        u_prev = opt_state.yk[0]

        # Amortized init (u_prev must be the previously commanded control,
        # read above, before any substitute). With refine_iters the
        # network's plan seeds the short APG solve below — but ONLY on a
        # cold start
        # (num_steps == 0, i.e. straight after reset_fn): in the steady
        # receding-horizon regime the SHIFTED previous plan is the better
        # initializer (measured on the lemniscate: shift+3-iter APG tracks
        # 0.027 m where policy-seeded+3-iter tracks 0.055 m — the network
        # buys the engagement transient, the shift owns steady state).
        # lax.cond, not jnp.where: the MLP forward must not execute inside
        # every warm 20 Hz solve just to be discarded.
        u_plan = None
        if solver_kind == "policy" and not policy_refine:
            u_plan = _policy_apply(
                policy_net, _policy_featurize(x, x_ref, u_prev[:n_u]),
                lb, ub)
        elif solver_kind == "policy":
            opt_state = opt_state._replace(yk=jax.lax.cond(
                opt_state.num_steps == 0,
                lambda: _policy_apply(
                    policy_net, _policy_featurize(x, x_ref, u_prev[:n_u]),
                    lb, ub),
                lambda: opt_state.yk))

        # Receding-horizon warm-start shift (shared by BOTH solver paths —
        # "repeat" is the parity default, "extrapolate" the config option).
        def _shift(z_opt):
            if warm_shift == "extrapolate":
                tail = jnp.clip(2.0 * z_opt[-1:] - z_opt[-2:-1], lb_z, ub_z)
            else:
                tail = z_opt[-1:]
            return jnp.concatenate([z_opt[1:], tail], axis=0)

        # Stepsize carry across solves skips the init_stepsize->workable
        # ramp, but only reset_option "increase" can re-grow a shrunken
        # step; under "conservative" a carried-down stepsize would be
        # monotone non-increasing across the whole flight, so there each
        # solve restarts from init_stepsize (the original recovery path).
        t_carry = (opt_state.stepsize
                   if apg_cfg.reset_option in ("increase", "bb") else None)

        if num_particles <= 1:
            # Mean-dynamics flight configuration (``num_particles: 1``,
            # ``iris_sitl_traj_mpc.yaml:52``): deterministic rollout; the
            # uncertainty penalty still reads sigma along the mean path.
            def seq_cost(z_seq):
                u_seq = z_seq[:, :n_u] if prox_m else z_seq
                s_seq = z_seq[:, n_u:] if prox_m else None
                x_paths, sigmas = rollout_sde(
                    model, params, x, u_seq, time_steps, rng_noise, 1,
                    deterministic=True, precision=mm_precision,
                )
                return cost_fn(x_paths, sigmas, u_seq, x_ref, u_prev[:n_u],
                               s_seq=s_seq)
        else:
            def seq_cost(z_seq):
                u_seq = z_seq[:, :n_u] if prox_m else z_seq
                s_seq = z_seq[:, n_u:] if prox_m else None
                x_paths, sigmas = rollout_sde(
                    model, params, x, u_seq, time_steps, rng_noise, num_particles,
                    particle_sharding=particle_sharding, precision=mm_precision,
                    antithetic=antithetic, x0_spread=init_std,
                )
                return cost_fn(x_paths, sigmas, u_seq, x_ref, u_prev[:n_u],
                               s_seq=s_seq)

        if solver_kind == "policy" and not policy_refine:
            # One forward pass IS the solve (u_plan computed above). The
            # cost evaluation below is telemetry only (init_cost/opt_cost
            # observability fields, ``msg/OptMPCState.msg:15-22``
            # semantics) — with no iterations there is no before/after
            # pair, so both report the plan's cost.
            c_plan = seq_cost(u_plan)
            z = jnp.float32(0.0)
            st = APGState(
                yk=u_plan, num_steps=z, stepsize=opt_state.stepsize,
                avg_stepsize=z, avg_linesearch=z, grad_sqr=z,
                init_cost=c_plan, opt_cost=c_plan,
            )
        elif solver_kind == "mppi":
            st = mppi_solve(seq_cost, opt_state.yk, lb_z, ub_z, mppi_cfg,
                            rng_mppi)
        else:
            # Carry the previous solve's linesearch stepsize
            # (APGState.stepsize, ``sde_control.py:444-450``) so warm solves
            # skip the init_stepsize->workable ramp (~13 iterations at x1.3;
            # measured); gated on reset_option (see t_carry above).
            st = apg_solve(seq_cost, opt_state.yk, lb_z, ub_z, apg_cfg,
                           t_init=t_carry, precond=precond_diag,
                           iter_budget=iter_budget)
        z_opt = st.yk                               # (H, nZ)
        u_opt = z_opt[:, :n_u] if prox_m else z_opt

        # Predicted mean trajectory: body-rate columns feed the FCU fallback
        # thrust+rates channel (``sde_control.py:432``).
        x_evol = rollout_mean(model, params, x, u_opt, time_steps)

        st_out = st._replace(yk=_shift(z_opt))
        return MPCSolution(u_opt=u_opt, opt_state=st_out, rng=rng_next, x_evol=x_evol)

    return cfg, (reset_fn, mpc_fn), state_from_traj, bundle


def load_mpc_from_cfgfile(
    path: str, convert_to_enu: bool = True
) -> Tuple[Dict[str, Any], Tuple[Callable, Callable], Optional[Callable], MPCBundle]:
    """File-path entry point matching the reference import
    (``sde_control.py:12,685``)."""
    cfg = load_yaml_config(path)
    return make_mpc_from_config(cfg, convert_to_enu=convert_to_enu)
