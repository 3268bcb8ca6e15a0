"""MPPI (Model Predictive Path Integral) solver (L4) — the sampling twin.

A second solver family the reference lacks (its solver is gradient-based
APG; ``msg/OptMPCState.msg:1``). MPPI is the natural accelerator counterpoint:
instead of ~70 sequential gradient iterations it evaluates THOUSANDS of
perturbed control sequences in parallel — exactly the batched-rollout shape
the hardware and this framework's cost oracles are already built for
(``CostOracle.value_batch`` vmaps the rollout+cost closure over the
candidates).

Standard information-theoretic MPPI (Williams et al. 2017):

    u*  =  sum_k softmax(-(J_k - min J)/lambda)_k  ·  (u + eps_k)

iterated ``iters`` times with the mean re-centered, candidates clipped to
the input box (the reference's ``enforce_ubound`` semantics). The public
state is the same :class:`~sde4mbrl_px4_tpu.solver.apg.APGState` pytree, so
the engine/telemetry/warm-start contract (``OptMPCState`` fields,
receding-horizon shift) is unchanged — select with ``solver: mppi`` in the
MPC YAML:

    solver: mppi
    mppi:
      samples: 64         # K perturbed sequences per round (<=128 -> the
                          # fused kernel batch oracle evaluates all K on-chip)
      sigma: 0.02         # exploration std (fraction of the input range)
      temperature: 0.1    # lambda, relative to the round's cost spread
      iters: 8            # re-centered sampling rounds per solve
      noise_beta: 0.7     # AR(1) smoothing of exploration noise in time

Observability mapping (APGState): ``num_steps`` = iters, ``avg_linesearch``
= samples (evaluations per round), ``stepsize``/``avg_stepsize`` = sigma,
``grad_sqr`` = the last round's weight NOT on the incumbent (gradients
don't exist here; like grad_norm it -> 0 when the solver stops moving),
``init_cost``/``opt_cost`` = cost of the warm start / returned sequence
(the returned sequence is never worse than the warm start).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple

import jax
import jax.numpy as jnp

from sde4mbrl_px4_tpu.solver.apg import APGState, CostOracle, box_project

__all__ = ["MPPIConfig", "mppi_solve"]


class MPPIConfig(NamedTuple):
    """MPPI configuration. ``samples``/``iters`` are STATIC (they size the
    compiled program); the continuous knobs ``sigma``/``temperature``/
    ``noise_beta`` may be plain floats (hashable config — safe as a jit
    static arg) OR jax scalars/tracers, which is what lets
    ``tuning/tuner.py`` sweep a whole candidate grid of controllers inside
    one vmapped program.

    ``sigma`` is relative to the input-box width (scale-free);
    ``temperature`` is relative to the candidate-cost spread above the
    round's minimum (scale-free — an absolute lambda either collapses the
    softmax to argmin or flattens it depending on the cost magnitude);
    ``noise_beta`` > 0 time-correlates the exploration noise along the
    horizon (AR(1) with unit stationary variance — smoother candidate
    sequences, standard MPPI practice for physical systems).
    """

    samples: int = 64
    sigma: float = 0.02
    temperature: float = 0.1
    iters: int = 8
    noise_beta: float = 0.7   # measured best on the position-hold loop

    @staticmethod
    def from_config(cfg: Dict[str, Any]) -> "MPPIConfig":
        m = cfg.get("mppi") or {}
        unknown = sorted(set(m) - {"samples", "sigma", "temperature",
                                   "iters", "noise_beta"})
        if unknown:
            import warnings

            warnings.warn(f"mppi block: unknown key(s) {unknown} will be "
                          "ignored (typo?)", stacklevel=2)
        return MPPIConfig(
            samples=int(m.get("samples", 64)),
            sigma=float(m.get("sigma", 0.02)),
            temperature=float(m.get("temperature", 0.1)),
            iters=int(m.get("iters", 8)),
            noise_beta=float(m.get("noise_beta", 0.7)),
        )


def mppi_solve(
    cost_fn: Callable[[jax.Array], jax.Array],
    u_init: jax.Array,
    lb: jax.Array,
    ub: jax.Array,
    cfg: MPPIConfig,
    rng: jax.Array,
) -> APGState:
    """Minimize ``cost_fn`` over box-constrained control sequences by
    iterated importance-weighted sampling.

    ``cost_fn`` is a scalar cost over one (H, n) sequence or a
    :class:`CostOracle` (its ``value_batch`` evaluates all K candidates in
    one fused rollout). ``rng`` drives the exploration noise — pass a fresh
    stream per solve (the engine already threads one through ``mpc_fn``).
    """
    oracle = (cost_fn if isinstance(cost_fn, CostOracle)
              else CostOracle.from_fn(cost_fn))
    K = int(cfg.samples)
    lam = jnp.float32(cfg.temperature)
    sigma = jnp.float32(cfg.sigma) * (jnp.asarray(ub) - jnp.asarray(lb))
    beta = jnp.float32(cfg.noise_beta)

    u0 = box_project(u_init, lb, ub)
    f0 = oracle.value(u0)

    def _smooth(eps, c0):
        """AR(1) along the horizon; ``c0`` ~ N(0,1) seeds the chain so the
        process is at its unit STATIONARY variance from t=0 (a zero carry
        would under-explore the early horizon — exactly the steps that get
        applied — by a factor sqrt(1-beta^2))."""
        def step(c, e):
            c = beta * c + jnp.sqrt(1.0 - beta * beta) * e
            return c, c
        _, out = jax.lax.scan(step, c0, jnp.moveaxis(eps, 1, 0))
        return jnp.moveaxis(out, 0, 1)

    def body(carry, _):
        u_mean, rng = carry
        rng, sub, sub0 = jax.random.split(rng, 3)
        eps = jax.random.normal(sub, (K,) + u_mean.shape, dtype=u_mean.dtype)
        # Static beta == 0.0 skips the AR(1) scan entirely; a TRACED beta
        # always takes it (at beta=0 the chain reduces to the raw noise:
        # c_t = 0*c_{t-1} + 1*e_t), so sweeping beta dynamically is exact.
        if not isinstance(cfg.noise_beta, (int, float)) or cfg.noise_beta > 0.0:
            c0 = jax.random.normal(sub0, eps[:, 0].shape, dtype=eps.dtype)
            eps = _smooth(eps, c0)
        eps = sigma * eps
        # Candidate 0 is the INCUMBENT (zero perturbation): the round can
        # then hold position when no sample improves — without it every
        # round is forced to move and MPPI random-walks uphill on
        # noise-sensitive costs (motor-level inputs are exactly that).
        eps = eps.at[0].set(0.0)
        cands = box_project(u_mean[None] + eps, lb, ub)
        costs = oracle.value_batch(cands)                     # (K,)
        # Scale-free temperature: lambda rides the spread above the round
        # minimum, so the softmax neither collapses to argmin nor flattens
        # regardless of the cost magnitude.
        spread_j = jnp.maximum(jnp.mean(costs) - jnp.min(costs), 1e-9)
        w = jax.nn.softmax(-(costs - jnp.min(costs)) / (lam * spread_j))
        # HIGHEST: candidate mixing carries the solver's whole update —
        # bf16 inputs quantize motor commands at ~3e-3 relative (same
        # failure class as the mixer dot, models/sde_model.py)
        u_new = jnp.einsum("k,khn->hn", w, cands,
                           precision=jax.lax.Precision.HIGHEST)
        # Movement proxy: weight NOT on the incumbent. -> 0 when the round
        # keeps the current sequence (stationary/converged), matching the
        # APG convention that grad_norm -> 0 at convergence.
        moved = 1.0 - w[0]
        return (u_new, rng), (jnp.min(costs), moved)

    (u_mean, _), (_min_costs, moved) = jax.lax.scan(
        body, (u0, rng), None, length=int(cfg.iters))
    u_mean = box_project(u_mean, lb, ub)
    f_final = oracle.value(u_mean)
    # Never return a sequence worse than the warm start it was given: on a
    # noise-sensitive cost every candidate in a round can be worse than the
    # incumbent, and the softmax average would still mix them in (APG
    # tracks best_u the same way). Both costs are already evaluated.
    worse = f_final > f0
    u_mean = jnp.where(worse, u0, u_mean)
    f_final = jnp.where(worse, f0, f_final)

    return APGState(
        yk=u_mean,
        num_steps=jnp.float32(cfg.iters),
        stepsize=jnp.float32(cfg.sigma),
        avg_stepsize=jnp.float32(cfg.sigma),
        avg_linesearch=jnp.float32(K),
        grad_sqr=moved[-1],
        init_cost=f0,
        opt_cost=f_final,
    )
