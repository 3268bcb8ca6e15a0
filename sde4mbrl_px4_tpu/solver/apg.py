"""Accelerated proximal-gradient (APG) trajectory optimizer (L4).

The reference's solver is the external "MPC-based Accelerated Gradient
Descent Solver" (named at ``msg/OptMPCState.msg:1``) configured by the
``apg_mpc`` YAML block (``launch/iris_sitl_traj_mpc.yaml:55-85``):
Nesterov-style momentum (``beta_k = k/(k+3)`` when ``moment_scale`` is null,
per the comment at ``iris_sitl_traj_mpc.yaml:63-64``), Armijo backtracking
linesearch (``coef``/``decrease_factor``/``increase_factor``/``maxls``/
``reset_option``), box projection of the controls (``enforce_ubound``,
``input_constr.input_bound``), and ``atol``/``rtol``/
``max_no_improvement_iter`` stopping.

Accelerator-first design (SURVEY.md §7 "hard parts"):
- the ENTIRE solve — up to ``max_iter`` gradient steps, each with up to
  ``maxls`` linesearch cost evaluations — is one ``lax.while_loop`` inside
  one jitted XLA program: zero host round-trips in the hot loop;
- the branchy Armijo search is an inner ``lax.while_loop`` on device;
- early exit reproduces the reference's observable iteration-count
  semantics (``num_steps``, ``avg_linesearch``, ``avg_stepsize`` stats
  published in ``OptMPCState``, written at ``sde_control.py:444-450``);
- the whole function is pure and vmappable => batched scenarios shard over
  the device mesh with `pjit` unchanged.

The optimizer state pytree exposes exactly the fields the reference reads
off the external solver's state: ``yk, avg_linesearch, stepsize, num_steps,
grad_sqr, avg_stepsize, init_cost, opt_cost`` (``sde_control.py:444-450``
and ``:707``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

__all__ = ["APGConfig", "APGState", "apg_solve", "box_project", "CostOracle"]


class CostOracle(NamedTuple):
    """Pluggable cost evaluation backend for the solver.

    Lets a fused implementation (e.g. a hand-written kernel) supply the
    three evaluation shapes the APG loop needs without the solver knowing
    how they are computed:

    - ``value(u) -> scalar``
    - ``value_batch(U[K,H,n]) -> (K,)`` — the vectorized linesearch
    - ``value_and_grad(u) -> (scalar, grad)``
    """

    value: Callable
    value_batch: Callable
    value_and_grad: Callable

    @staticmethod
    def from_fn(cost_fn: Callable) -> "CostOracle":
        return CostOracle(
            value=cost_fn,
            value_batch=jax.vmap(cost_fn),
            value_and_grad=jax.value_and_grad(cost_fn),
        )


class APGConfig(NamedTuple):
    """Static solver configuration (hashable; safe as a jit static arg)."""

    max_iter: int = 200
    max_no_improvement_iter: int = 200
    stepsize: float = 1.0          # used only when linesearch is disabled
    moment_scale: Optional[float] = None
    beta_init: float = 0.25
    atol: float = 1e-8
    rtol: float = 1e-6
    # linesearch block
    use_linesearch: bool = True
    init_stepsize: float = 0.01
    max_stepsize: float = 1.0
    coef: float = 0.01
    decrease_factor: float = 0.7
    increase_factor: float = 1.3
    reset_option: str = "increase"  # or "conservative" | "bb"
    maxls: int = 4
    # Execution strategy: evaluate all maxls backtracking candidates in ONE
    # batched rollout instead of sequentially. Identical accept decision
    # (largest passing stepsize) — backtracking tries candidates largest
    # first, so "first accept" == "largest passing". At these widths a
    # batched rollout is launch-latency bound and costs about one rollout.
    vector_linesearch: bool = True
    # Adaptive restart scope (O'Donoghue & Candes 2015): on a restart
    # (linesearch failure or cost increase) also reset the momentum COUNTER
    # so beta re-grows from beta_init, instead of only dropping the
    # extrapolation for one step while beta_k = k/(k+3) keeps climbing
    # toward 1 (which locks warm solves into oscillation; measured: tail
    # solves pinned at max_iter without it). The reference pins the beta_k
    # SCHEDULE (schema comment, ``iris_sitl_traj_mpc.yaml:62-64``) but
    # leaves restart internals unspecified (external library, SURVEY §2.9).
    momentum_restart: bool = True

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "APGConfig":
        """Parse the ``apg_mpc`` YAML block (schema: SURVEY.md §2.10)."""
        a = cfg["apg_mpc"]
        ls = a.get("linesearch")
        kw = dict(
            max_iter=int(a.get("max_iter", 200)),
            max_no_improvement_iter=int(a.get("max_no_improvement_iter", a.get("max_iter", 200))),
            stepsize=float(a.get("stepsize", 1.0)),
            moment_scale=None if a.get("moment_scale") is None else float(a["moment_scale"]),
            beta_init=float(a.get("beta_init", 0.25)),
            atol=float(a.get("atol", 1e-8)),
            rtol=float(a.get("rtol", 1e-6)),
            use_linesearch=ls is not None,
            momentum_restart=bool(a.get("momentum_restart", True)),
        )
        if ls is not None:
            kw.update(
                init_stepsize=float(ls.get("init_stepsize", 0.01)),
                max_stepsize=float(ls.get("max_stepsize", 1.0)),
                coef=float(ls.get("coef", 0.01)),
                decrease_factor=float(ls.get("decrease_factor", 0.7)),
                increase_factor=float(ls.get("increase_factor", 1.3)),
                reset_option=str(ls.get("reset_option", "increase")),
                maxls=int(ls.get("maxls", 4)),
            )
        return APGConfig(**kw)


class APGState(NamedTuple):
    """Warm-start + observability state (field names are the reference's
    contract, ``sde_control.py:444-450,707``)."""

    yk: jax.Array             # (H, n_u) decision sequence (warm start)
    num_steps: jax.Array      # iterations executed
    stepsize: jax.Array       # last accepted stepsize
    avg_stepsize: jax.Array
    avg_linesearch: jax.Array # mean linesearch evals per iteration
    grad_sqr: jax.Array      # squared gradient norm at exit
    init_cost: jax.Array
    opt_cost: jax.Array


def box_project(u: jax.Array, lb: jax.Array, ub: jax.Array) -> jax.Array:
    """Project onto the per-input box (``enforce_ubound: True``,
    ``iris_sitl_traj_mpc.yaml:8-14``)."""
    return jnp.clip(u, lb, ub)


def _default_stats(y0: jax.Array) -> APGState:
    z = jnp.float32(0.0)
    return APGState(
        yk=y0, num_steps=z, stepsize=z, avg_stepsize=z, avg_linesearch=z,
        grad_sqr=z, init_cost=z, opt_cost=z,
    )


class _Carry(NamedTuple):
    k: jax.Array
    k_m: jax.Array           # momentum counter (resets on adaptive restart)
    u: jax.Array             # accepted iterate
    y: jax.Array             # extrapolated (momentum) point
    f_u: jax.Array           # cost at accepted iterate
    t: jax.Array             # current stepsize
    best_f: jax.Array
    best_u: jax.Array
    no_improve: jax.Array
    done: jax.Array
    sum_t: jax.Array         # stepsize accumulator (for avg)
    sum_ls: jax.Array        # linesearch-eval accumulator
    y_prev: jax.Array        # previous extrapolated point (BB secant pair)
    g_prev: jax.Array        # gradient at y_prev (BB secant pair)


def apg_solve(
    cost_fn: Callable[[jax.Array], jax.Array],
    u_init: jax.Array,
    lb: jax.Array,
    ub: jax.Array,
    cfg: APGConfig,
    t_init: Optional[jax.Array] = None,
    precond: Optional[jax.Array] = None,
    iter_budget: Optional[jax.Array] = None,
) -> APGState:
    """Minimize ``cost_fn`` over box-constrained control sequences.

    ``cost_fn`` maps (H, n_u) -> scalar and must be jit-traceable and
    differentiable (it closes over the SDE rollout), or a :class:`CostOracle`
    supplying fused value / batched-value / value-and-grad evaluations.
    Returns the final :class:`APGState` whose ``yk`` holds the best iterate
    found (NOT yet shifted; the engine performs the receding-horizon shift).

    ``t_init``: optional carried linesearch stepsize from the previous
    receding-horizon solve (``APGState.stepsize`` — the field exists in the
    reference's solver state precisely so warm solves resume from it,
    ``sde_control.py:444-450``). Without it every warm solve re-ramps from
    ``init_stepsize`` (0.01) at ×``increase_factor``/iteration — ~13 wasted
    iterations to reach a workable step on the flight configs. Non-positive values fall
    back to ``init_stepsize`` (so a fresh ``reset_fn`` state is unchanged).

    ``precond``: optional diagonal preconditioner, broadcastable to the
    iterate shape (H, n_u), strictly positive. The step becomes
    ``proj(y - t * D * g)`` — projected scaled gradient in the
    ``D^{-1}``-metric — and the Armijo majorization's quadratic term becomes
    ``<d, D^{-1} d> / (2t)`` so the accept rule tests the matching metric.
    Box projection stays EXACT under a diagonal metric (the prox is
    separable). Motivation: the MPC cost's diagonal curvature decays ~580×
    from horizon row 0 to row H-1 (early controls move the whole downstream
    trajectory; measured on the flagship config, ``tools/curvature_probe.py``)
    and conditioning sets the APG iteration count — equalizing the diagonal
    cuts warm iterations ~2× (``tools/iter_ab.py``).

    ``iter_budget``: optional TRACED iteration cap (scalar int) — the
    deadline-aware hook. The while loop stops at
    ``min(cfg.max_iter, iter_budget)``; the engine converts its remaining
    control-period budget to iterations via a measured ms/iteration
    estimate (``engine/controller.py``), and the receding-horizon
    warm-start shift carries the partial progress to the next doorbell —
    bounding the solve tail by the deadline instead of only by plan
    staleness (the reference's only guard is the FCU-side 20 ms staleness
    watchdog, ``basic_control.py:39``). ``None`` keeps the static bound
    (bit-identical solves). Values < 1 are clamped to 1 (a doorbell always
    buys at least one accepted-step attempt).
    """
    oracle = cost_fn if isinstance(cost_fn, CostOracle) else CostOracle.from_fn(cost_fn)
    cost_fn = oracle.value
    vg = oracle.value_and_grad
    proj = lambda u: box_project(u, lb, ub)

    u0 = proj(u_init)
    f0, g0 = vg(u0)

    # Diagonal preconditioner plumbing (identity when precond is None —
    # trace-time branch, so the unpreconditioned hot path carries no extra
    # ops). ``dscale(g)`` is the step direction, ``dquad(d)`` the Armijo
    # quadratic <d, D^{-1} d> replacing <d, d>.
    if precond is None:
        D = None
        dscale = lambda g: g
        dquad = lambda d, axis=None: jnp.sum(d * d, axis=axis)
    else:
        D = jnp.broadcast_to(
            jnp.asarray(precond, jnp.float32), u_init.shape)
        dscale = lambda g: D * g
        dquad = lambda d, axis=None: jnp.sum(d * d / D, axis=axis)

    def linesearch(y, f_y, g, t0):
        """Backtracking linesearch on the proximal quadratic upper bound.

        Accept ``u+ = proj(y - t g)`` when

            f(u+) <= f(y) + (1 - coef) * <g, u+ - y> + ||u+ - y||^2 / (2 t)

        — the FISTA/ISTA majorization test (guarantees ``t <= 1/L`` locally,
        so accepted steps are stable even under Nesterov extrapolation),
        tightened by ``coef``: smaller ``coef`` => weaker demand => larger
        accepted steps, matching the schema comment "the smaller the larger
        step size" (``iris_sitl_traj_mpc.yaml:78``). Up to ``maxls`` trials
        shrinking by ``decrease_factor``.
        """

        def cond(c):
            t, n_ls, accepted, _, _ = c
            return jnp.logical_and(n_ls < cfg.maxls, jnp.logical_not(accepted))

        def body(c):
            t, n_ls, _, _, _ = c
            u_t = proj(y - t * dscale(g))
            f_t = cost_fn(u_t)
            d = u_t - y
            bound = (
                f_y
                + (1.0 - cfg.coef) * jnp.sum(g * d)
                + dquad(d) / (2.0 * jnp.maximum(t, 1e-12))
            )
            ok = f_t <= bound
            t_next = jnp.where(ok, t, t * cfg.decrease_factor)
            return (t_next, n_ls + 1, ok, u_t, f_t)

        init = (t0, jnp.int32(0), jnp.bool_(False), y, f_y)
        t, n_ls, ok, u_t, f_t = jax.lax.while_loop(cond, body, init)
        return u_t, f_t, t, n_ls, ok

    def linesearch_vec(y, f_y, g, t0):
        """Vectorized backtracking: same accept rule as :func:`linesearch`,
        all ``maxls`` candidates in one batched cost evaluation.

        ``n_ls`` reports the eval count the sequential search *would* have
        performed (1 + index of the accepted candidate) so the published
        ``avg_linesearch`` telemetry keeps the reference's semantics.
        """
        K = cfg.maxls
        ts = t0 * (cfg.decrease_factor ** jnp.arange(K, dtype=jnp.float32))  # (K,)
        u_ts = proj(y[None] - ts[:, None, None] * dscale(g)[None])           # (K, H, n)
        f_ts = oracle.value_batch(u_ts)                                      # (K,)
        d = u_ts - y[None]
        lin = jnp.sum(g[None] * d, axis=(1, 2))
        quad = dquad(d, axis=(1, 2)) / (2.0 * jnp.maximum(ts, 1e-12))
        ok_k = f_ts <= f_y + (1.0 - cfg.coef) * lin + quad                   # (K,)
        any_ok = jnp.any(ok_k)
        idx = jnp.argmax(ok_k)  # first (largest-step) accepted candidate
        t = jnp.where(any_ok, ts[idx], t0 * cfg.decrease_factor**K)
        n_ls = jnp.where(any_ok, idx + 1, K).astype(jnp.int32)
        return u_ts[idx], f_ts[idx], t, n_ls, any_ok

    if iter_budget is None:
        kmax = jnp.int32(cfg.max_iter)
    else:
        kmax = jnp.minimum(
            jnp.int32(cfg.max_iter),
            jnp.maximum(jnp.asarray(iter_budget, jnp.int32), 1))

    def outer_cond(c: _Carry) -> jax.Array:
        return jnp.logical_and(c.k < kmax, jnp.logical_not(c.done))

    def outer_body(c: _Carry) -> _Carry:
        f_y, g = vg(c.y)

        if cfg.use_linesearch:
            if cfg.reset_option == "bb":
                # Barzilai–Borwein spectral trial stepsize (BB1) from the
                # secant pair at consecutive extrapolated points:
                #     t_bb = <s, s> / <s, r>,  s = y_k - y_{k-1},
                #                              r = g(y_k) - g(y_{k-1}).
                # It is only the INITIAL Armijo candidate — the FISTA-bound
                # accept rule below is unchanged, so stability is identical;
                # BB just lands the trial near the local 1/L instead of
                # ramping ×increase_factor per iteration (measured: ~25 %
                # fewer warm iterations on the flagship config, iter_ab.py).
                # Falls back to the "increase" rule on the first iteration
                # or a non-convex secant (<s, r> <= 0).
                s = c.y - c.y_prev
                r = g - c.g_prev
                sr = jnp.sum(s * r)
                rr = jnp.sum(r * dscale(r))   # <r, D r>: BB2 in the D-metric
                t_bb = sr / jnp.maximum(rr, 1e-12)
                t_inc = jnp.minimum(c.t * cfg.increase_factor, cfg.max_stepsize)
                valid = jnp.logical_and(c.k > 0, sr > 1e-12)
                t0 = jnp.where(valid,
                               jnp.clip(t_bb, 1e-6, cfg.max_stepsize), t_inc)
            elif cfg.reset_option == "increase":
                t0 = jnp.minimum(c.t * cfg.increase_factor, cfg.max_stepsize)
            else:
                t0 = c.t
            ls = linesearch_vec if cfg.vector_linesearch else linesearch
            u_trial, f_trial, t_acc, n_ls, ok = ls(c.y, f_y, g, t0)
        else:
            t_acc = jnp.float32(cfg.stepsize)
            u_trial = proj(c.y - t_acc * dscale(g))
            f_trial = cost_fn(u_trial)
            n_ls = jnp.int32(1)
            ok = f_trial <= f_y

        # On linesearch failure: stay put (the decreased stepsize carries to
        # the next iteration, where ``reset_option`` re-scales it — the
        # reference's maxls-bounded Armijo semantics,
        # ``iris_sitl_traj_mpc.yaml:79-85``).
        u_new = jnp.where(ok, u_trial, c.u)
        f_new = jnp.where(ok, f_trial, c.f_u)

        # Nesterov momentum: beta_k = k/(k+3) (moment_scale null), floored by
        # beta_init at k=0; constant moment_scale otherwise. Momentum drops
        # (adaptive restart) on linesearch failure or cost increase; with
        # ``momentum_restart`` the schedule counter k_m also resets so beta
        # re-grows from beta_init (see APGConfig).
        kf = (c.k_m if cfg.momentum_restart else c.k).astype(jnp.float32)
        beta = (
            jnp.float32(cfg.moment_scale)
            if cfg.moment_scale is not None
            else jnp.maximum(kf / (kf + 3.0), cfg.beta_init)
        )
        restart = jnp.logical_or(jnp.logical_not(ok), f_new > c.f_u)
        y_new = jnp.where(restart, u_new, u_new + beta * (u_new - c.u))
        k_m_new = jnp.where(restart, jnp.int32(0), c.k_m + 1)

        improved = f_new < c.best_f - 1e-12
        best_f = jnp.minimum(f_new, c.best_f)
        best_u = jnp.where(improved, u_new, c.best_u)
        no_improve = jnp.where(improved, 0, c.no_improve + 1)

        # Stopping: cost-decrease tolerance (atol/rtol) on ACCEPTED steps
        # (a failed linesearch keeps searching with a smaller stepsize), or
        # stagnation for ``max_no_improvement_iter`` iterations.
        df = jnp.abs(c.f_u - f_new)
        converged = jnp.logical_and(ok, df <= cfg.atol + cfg.rtol * jnp.abs(c.f_u))
        done = jnp.logical_or(converged, no_improve >= cfg.max_no_improvement_iter)

        return _Carry(
            k=c.k + 1,
            k_m=k_m_new,
            u=u_new,
            y=y_new,
            f_u=f_new,
            t=t_acc,
            best_f=best_f,
            best_u=best_u,
            no_improve=no_improve,
            done=done,
            sum_t=c.sum_t + t_acc,
            sum_ls=c.sum_ls + n_ls.astype(jnp.float32),
            y_prev=c.y,
            g_prev=g,
        )

    t0c = jnp.float32(cfg.init_stepsize if cfg.use_linesearch else cfg.stepsize)
    if t_init is not None and cfg.use_linesearch:
        t0v = jnp.asarray(t_init, jnp.float32)
        t0c = jnp.where(t0v > 0.0, jnp.clip(t0v, 1e-6, cfg.max_stepsize), t0c)

    init = _Carry(
        k=jnp.int32(0),
        k_m=jnp.int32(0),
        u=u0,
        y=u0,
        f_u=f0,
        t=t0c,
        best_f=f0,
        best_u=u0,
        no_improve=jnp.int32(0),
        done=jnp.bool_(False),
        sum_t=jnp.float32(0.0),
        sum_ls=jnp.float32(0.0),
        y_prev=u0,
        g_prev=g0,
    )
    c = jax.lax.while_loop(outer_cond, outer_body, init)

    # Exit gradient norm at the final iterate (one extra grad eval, outside
    # the loop so the loop body stays minimal).
    _, g_final = vg(c.best_u)
    n_steps = jnp.maximum(c.k.astype(jnp.float32), 1.0)
    return APGState(
        yk=c.best_u,
        num_steps=c.k.astype(jnp.float32),
        stepsize=c.t,
        avg_stepsize=c.sum_t / n_steps,
        avg_linesearch=c.sum_ls / n_steps,
        grad_sqr=jnp.sum(g_final * g_final),
        init_cost=f0,
        opt_cost=c.best_f,
    )
