"""Worker process for the 2-process multi-host test (tests/test_distributed.py).

Runs as a SEPARATE OS process: argv = [process_id, num_processes, port,
out_npy, cfg_yaml]. Forces the CPU platform in code, before any op (the
test's processes never open an accelerator), joins the jax.distributed
cluster, solves a dp-sharded scenario batch on
the global mesh and (process 0) saves the gathered plans.
"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import yaml  # noqa: E402


def main():
    pid, nproc, port, out_npy, cfg_yaml = sys.argv[1:6]
    pid, nproc = int(pid), int(nproc)

    from sde4mbrl_px4_tpu.parallel.distributed import (
        gather_to_host,
        global_mesh,
        initialize_distributed,
        make_global_batch,
    )

    assert initialize_distributed(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc, jax.process_count()

    from jax.sharding import NamedSharding, PartitionSpec as P

    from sde4mbrl_px4_tpu.parallel.batched import make_batched_mpc

    with open(cfg_yaml) as f:
        cfg = yaml.safe_load(f)

    mesh = global_mesh((jax.device_count(), 1))
    reset_b, mpc_b, _ = make_batched_mpc(cfg, mesh)

    # Deterministic global batch, identical in every process; each process
    # feeds only its slice (process order = global order).
    B = 8
    Bl = B // nproc
    from sde4mbrl_px4_tpu.core.types import hover_state

    rs = np.random.RandomState(7)
    xs_full = np.tile(np.asarray(hover_state()), (B, 1)).astype(np.float32)
    xs_full[:, 0:3] += 0.5 * rs.randn(B, 3).astype(np.float32)
    rngs_full = np.asarray(jax.random.split(jax.random.PRNGKey(7), B))
    sl = slice(pid * Bl, (pid + 1) * Bl)
    xs, rngs = make_global_batch(mesh, xs_full[sl], rngs_full[sl])
    ts = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P("dp")), np.zeros((Bl,), np.float32)
    )

    st = reset_b(xs, rngs, xs)
    sol = mpc_b(xs, rngs, st, ts, xs)
    sol = mpc_b(xs, sol.rng, sol.opt_state, ts, xs)  # one warm-started step too
    # Fail LOUDLY here if any solve degenerated (observed once under heavy
    # host contention: gathered rows equal to the unsolved hover warm start
    # — far easier to diagnose as a worker assert than as a tolerance
    # mismatch in the parent's comparison).
    steps = np.asarray(gather_to_host(sol.opt_state.num_steps))
    assert (steps > 0).all(), f"degenerate solves: num_steps={steps}"
    u = gather_to_host(sol.u_opt)
    if pid == 0:
        np.save(out_npy, u)
    print(f"worker {pid}: ok devices={jax.device_count()} "
          f"steps={steps.tolist()}", flush=True)


if __name__ == "__main__":
    main()
