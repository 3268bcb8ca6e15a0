"""Every dot the solve's gradient flows through carries explicit HIGHEST
precision (reference-parity configs), and each ``matmul_precision`` name
means what it says on the GPU.

Regression guard: ONE einsum without a precision argument (the
motor-mixer control->wrench dot) ran at the accelerator's default
reduced input precision and false-plateaued the batched solver at
0.3-0.5 m tracking. On an H100 the default for a float32 dot is TF32
(10-bit mantissa). CPU tests cannot catch that class — precision is a
no-op on CPU — so this test walks the traced jaxpr instead: statically
assert that NO dot_general in the compiled solve (or its gradient, scan,
while_loop sub-jaxprs) uses default precision. Large-P configs
intentionally choose TF32 (``matmul_precision``), so the guard covers the
parity configs only."""
import os

import jax
import jax.extend.core as jex_core
import jax.numpy as jnp
import pytest

from sde4mbrl_px4_tpu.core.types import hover_state


def _collect_dot_precisions(jaxpr, out):
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params.get("precision"))
        for v in eqn.params.values():
            if isinstance(v, jex_core.ClosedJaxpr):
                _collect_dot_precisions(v.jaxpr, out)
            elif isinstance(v, jex_core.Jaxpr):
                _collect_dot_precisions(v, out)
            elif isinstance(v, (tuple, list)):
                for w in v:
                    if isinstance(w, jex_core.ClosedJaxpr):
                        _collect_dot_precisions(w.jaxpr, out)
                    elif isinstance(w, jex_core.Jaxpr):
                        _collect_dot_precisions(w, out)
    return out


@pytest.mark.parametrize("solver,extra", [
    ("apg", {}),
    ("mppi", {}),
    ("policy", {"policy": {"hidden": [32], "refine_iters": 3}}),
])
def test_solve_dots_carry_explicit_precision(repo_root, solver, extra):
    import yaml

    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config

    cfg = yaml.safe_load(
        open(os.path.join(repo_root, "configs/iris_posctrl_mpc.yaml")))
    cfg["learned_model_params"] = os.path.join(
        repo_root, "configs/models/iris_sde.pkl")
    cfg["horizon"] = 4
    cfg["num_short_dt"] = 4
    cfg["apg_mpc"]["max_iter"] = 3
    cfg["apg_mpc"]["max_no_improvement_iter"] = 3
    cfg["solver"] = solver
    cfg.update(extra)
    # a prox-slack constraint exercises the selector einsum too
    cfg["state_constr"] = {
        "state_id": [2], "state_bound": [[-5.0, 0.0]],
        "state_penalty": [10.0], "slack_scaling": [1.0],
        "slack_proximal": solver == "apg",
    }
    _, (reset_fn, mpc_fn), _, _ = make_mpc_from_config(dict(cfg))
    x = jnp.asarray(hover_state())
    rng = jax.random.PRNGKey(0)
    st = reset_fn(x, rng, x)
    jaxpr = jax.make_jaxpr(
        lambda *a: mpc_fn(*a, xdes=x))(x, rng, st, jnp.float32(0.0))
    precisions = _collect_dot_precisions(jaxpr.jaxpr, [])
    assert precisions, "no dot_general found — tracing changed?"
    bad = [p for p in precisions if p is None
           or (isinstance(p, tuple)
               and any(q != jax.lax.Precision.HIGHEST for q in p))
           or (not isinstance(p, tuple) and p != jax.lax.Precision.HIGHEST)]
    assert not bad, (
        f"{len(bad)}/{len(precisions)} dot_general eqns use default/non-"
        f"HIGHEST precision in the {solver} solve path — on the GPU that "
        f"is TF32 inputs on a gradient-carrying dot: {set(map(str, bad))}")


@pytest.mark.parametrize("name,want", [
    (None, jax.lax.Precision.HIGHEST),
    ("highest", jax.lax.Precision.HIGHEST),
    ("HIGHEST", jax.lax.Precision.HIGHEST),
    ("float32", jax.lax.Precision.HIGHEST),
    ("tf32", jax.lax.Precision.DEFAULT),
    ("default", jax.lax.Precision.DEFAULT),
    (jax.lax.Precision.HIGH, jax.lax.Precision.HIGH),
    ("bf16", ValueError),
    ("bfloat16", ValueError),
    ("fp8", ValueError),
])
def test_resolve_precision_names(name, want):
    from sde4mbrl_px4_tpu.models.sde_model import resolve_precision

    if want is ValueError:
        with pytest.raises(ValueError, match="matmul_precision"):
            resolve_precision(name)
    else:
        assert resolve_precision(name) == want


@pytest.mark.parametrize("particles,want", [
    (1, jax.lax.Precision.HIGHEST),
    (128, jax.lax.Precision.HIGHEST),
    (512, jax.lax.Precision.DEFAULT),
])
def test_default_precision_by_particle_count(repo_root, particles, want):
    """The loader's default: float32 HIGHEST up to 128 particles, TF32
    beyond (sampling noise dominates); the bundle reports which."""
    from sde4mbrl_px4_tpu.engine.mpc_loader import make_mpc_from_config
    from sde4mbrl_px4_tpu.io.config import load_yaml_config

    cfg = load_yaml_config(os.path.join(repo_root,
                                        "configs/iris_posctrl_mpc.yaml"))
    cfg["num_particles"] = particles
    _, _, _, b = make_mpc_from_config(cfg)
    assert b.precision == want
