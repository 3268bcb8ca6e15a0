"""Reference-trajectory tables and the jittable ``state_from_traj`` sampler (L1).

The reference's trajectory CSVs have header columns
``t,x,y,z,vx,vy,vz,ax,ay,az,yaw`` in ENU (reference
``geometric_controller.cpp:463``, header parse at :449-476) and are sampled
by the external ``state_from_traj(t) -> x(13)`` closure, jitted with a
scalar time argument (``sde_control.py:694``), returning the full 13-state
target.

Here the CSV is preprocessed once on host into a dense knot table of
13-states (attitude from differential flatness: ``acc + g`` and yaw ->
quaternion, body rates from the yaw-rate finite difference), optionally
converted ENU->NED to match FCU-frame states, and sampled on device with a
branch-free ``searchsorted`` + linear interpolation (quaternion re-normalized
after lerp). Static shapes => one compile, O(log N) per sample.
"""
from __future__ import annotations

import io
import os
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core import quaternion as quat
from sde4mbrl_px4_tpu.core.frames import enu2ned

__all__ = ["TrajectoryTable", "load_trajectory_csv", "make_state_from_traj",
           "host_device"]

_G = 9.81
_REQUIRED = ("t", "x", "y", "z", "vx", "vy", "vz", "ax", "ay", "az", "yaw")


def host_device():
    """The CPU device, or the default device when JAX was started without
    its CPU backend."""
    try:
        return jax.local_devices(backend="cpu")[0]
    except RuntimeError:
        return jax.devices()[0]


class TrajectoryTable(NamedTuple):
    """Dense knot table: times (N,) and 13-states (N, 13).

    Host-resident (numpy) by design: the table is load-time CSV output and
    becomes on-device constants only when :func:`make_state_from_traj`
    builds the sampler, so the load path needs no device round trips."""

    times: np.ndarray
    states: np.ndarray

    @property
    def duration(self) -> float:
        return float(self.times[-1])


def load_trajectory_csv(path: str, convert_to_ned: bool = True) -> TrajectoryTable:
    """Parse a reference-format trajectory CSV into a knot table.

    Missing cells become NaN then 0 (the reference tolerates a trailing
    missing column, ``geometric_controller.cpp:489-503``).
    """
    path = os.path.expanduser(path)
    with open(path, "r") as f:
        text = f.read()
    return parse_trajectory_csv(text, convert_to_ned=convert_to_ned)


def parse_trajectory_csv(text: str, convert_to_ned: bool = True) -> TrajectoryTable:
    header, *rows = [ln for ln in text.strip().splitlines() if ln.strip()]
    cols = [c.strip() for c in header.split(",")]
    missing = [c for c in _REQUIRED if c not in cols]
    if missing:
        raise ValueError(f"trajectory CSV missing columns {missing}; has {cols}")
    idx = {c: cols.index(c) for c in _REQUIRED}

    data = np.genfromtxt(io.StringIO("\n".join(rows)), delimiter=",", dtype=np.float64)
    data = np.atleast_2d(data)
    data = np.nan_to_num(data, nan=0.0)

    t = data[:, idx["t"]]
    pos = data[:, [idx["x"], idx["y"], idx["z"]]]
    vel = data[:, [idx["vx"], idx["vy"], idx["vz"]]]
    acc = data[:, [idx["ax"], idx["ay"], idx["az"]]]
    yaw = data[:, idx["yaw"]]

    # Differential-flatness attitude in ENU: body z along (a + g_up).
    # Host-side preprocessing, pinned to the CPU so the knots are
    # bit-identical whatever accelerator serves the solve.
    g_up = np.array([0.0, 0.0, _G])
    with jax.default_device(host_device()):
        q = np.asarray(quat.acc_yaw_to_q(jnp.asarray(acc + g_up),
                                         jnp.asarray(yaw)))

    # Body-rate prior: yaw rate about body z only (the CSV carries no rates;
    # the reference baseline also only tracks yaw kinematics).
    if len(t) > 1:
        yaw_rate = np.gradient(np.unwrap(yaw), t, edge_order=1)
    else:
        yaw_rate = np.zeros_like(yaw)
    omega = np.stack([np.zeros_like(yaw_rate), np.zeros_like(yaw_rate), yaw_rate], axis=-1)

    states = np.concatenate([pos, vel, q, omega], axis=-1).astype(np.float32)
    if convert_to_ned:
        with jax.default_device(host_device()):
            states = np.asarray(enu2ned(jnp.asarray(states)))
    return TrajectoryTable(times=np.asarray(t, np.float32),
                           states=np.asarray(states, np.float32))


def make_state_from_traj(table: TrajectoryTable) -> Callable[[jax.Array], jax.Array]:
    """Build the jittable sampler ``state_from_traj(t) -> x(13)``.

    Clamps to the endpoints outside ``[t_0, t_N]`` (the reference holds the
    last setpoint past the end, ``geometric_controller.cpp:224-237``).
    Works for scalar or batched ``t``.

    Uniform knot grids (every shipped trajectory CSV) take an O(1)
    direct-index path; ``jnp.searchsorted`` lowers to a log-N scan of
    dynamic gathers, each a separate small device op inside every solve's
    reference build.
    """
    # The table arrives host-resident (numpy); upload once here — the
    # closure's constants then live on the solve device. (Accepts legacy
    # device-array tables too: jnp.asarray is then a no-op.)
    times = jnp.asarray(table.times, jnp.float32)
    states = jnp.asarray(table.states, jnp.float32)

    # Host-side uniformity check (trace-time constant). Knot times are
    # float32, so successive diffs of a truly uniform grid wobble by up to
    # ~eps(t_max); tolerate that plus 0.1% relative jitter (an index off by
    # one at a knot boundary only clamps alpha, the lerp stays continuous).
    tn = np.asarray(table.times, np.float64)
    dts = np.diff(tn)
    tol = 1e-3 * abs(dts[0]) + 8 * np.finfo(np.float32).eps * max(
        1.0, abs(tn[-1])) if dts.size else 0.0
    uniform = bool(dts.size > 0 and dts.min() > 0
                   and np.abs(dts - dts[0]).max() <= tol)
    # mean spacing (endpoints ratio) averages out per-knot rounding
    dt0 = float((tn[-1] - tn[0]) / (len(tn) - 1)) if uniform else 1.0

    def state_from_traj(t: jax.Array) -> jax.Array:
        t = jnp.asarray(t, times.dtype)
        if uniform:
            # clamp in float BEFORE the int cast: far-future query times
            # (e.g. hold-last-setpoint sampling at t=1e9) would overflow
            # int32 and alias into the table interior otherwise
            k = jnp.clip(jnp.floor((t - times[0]) / jnp.asarray(dt0, times.dtype)),
                         0.0, times.shape[0] - 1)
            hi = jnp.clip(k.astype(jnp.int32) + 1, 1, times.shape[0] - 1)
        else:
            hi = jnp.clip(jnp.searchsorted(times, t, side="right"), 1,
                          times.shape[0] - 1)
        lo = hi - 1
        t0, t1 = times[lo], times[hi]
        alpha = jnp.clip((t - t0) / jnp.maximum(t1 - t0, 1e-9), 0.0, 1.0)
        x = states[lo] + alpha[..., None] * (states[hi] - states[lo])
        q = quat.qnormalize(x[..., 6:10])
        return jnp.concatenate([x[..., 0:6], q, x[..., 10:13]], axis=-1)

    # table extent, host-readable (distillation samples t over it,
    # learning/distill.py; the sampler itself clamps past the end)
    state_from_traj.t_max = float(tn[-1])
    return state_from_traj
