"""Geometric SE(3)/quaternion baseline controller (L7).

Two interchangeable implementations of the reference's non-learned
comparison controller (reference
``sde4mbrl_px4/geometric_controller/geometric_controller.cpp``, SURVEY.md
§2.4):

- :func:`geometric_control` — pure JAX, jittable/vmappable (batched
  baseline rollouts on the accelerator, e.g. as the comparison controller inside the
  closed-loop simulator);
- :class:`NativeGeometricController` — ctypes binding onto the C++
  implementation (``csrc/geometric_controller.cpp``), the real-time host
  path, including the CSV trajectory follower with stage caching.

Cross-parity between the two is enforced by tests.

Controller pipeline (reference ``controlLoopBody``,
``geometric_controller.cpp:137-204``): position PD with norm-clipped
feedback acceleration + feedforward + rotor-drag compensation ->
``acc2quaternion`` -> attitude law (1 = quaternion-error/Brescianini,
2 = SE(3)/Lee) -> thrust ``clamp(c * a_des . z_b + offset, 0, 1)``.
Frames: world ENU / body FLU, matching what the reference node receives
from mavros.
"""
from __future__ import annotations

import ctypes
import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from sde4mbrl_px4_tpu.core import quaternion as quat

__all__ = ["GeoParams", "geometric_control", "NativeGeometricController"]

ERROR_QUATERNION = 1
ERROR_GEOMETRIC = 2


class GeoParams(NamedTuple):
    """Parameters; defaults mirror the reference node defaults
    (``geometric_controller.cpp:30-45``)."""

    attctrl_tau: float = 0.1
    norm_thrust_const: float = 0.05
    norm_thrust_offset: float = 0.1
    max_fb_acc: float = 9.0
    gravity: float = 9.8
    drag_d: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    kp: Tuple[float, float, float] = (8.0, 8.0, 10.0)
    kv: Tuple[float, float, float] = (1.5, 1.5, 3.3)
    ctrl_mode: int = ERROR_QUATERNION
    feedthrough: bool = False

    @staticmethod
    def from_yaml(path: str) -> "GeoParams":
        """Flat key:value config (reference ``launch/iris_geoctrl.yaml``)."""
        from sde4mbrl_px4_tpu.io.config import load_yaml

        d = load_yaml(path) or {}
        base = GeoParams()
        return GeoParams(
            attctrl_tau=float(d.get("attctrl_tau", base.attctrl_tau)),
            norm_thrust_const=float(d.get("norm_thrust_const", base.norm_thrust_const)),
            norm_thrust_offset=float(d.get("norm_thrust_offset", base.norm_thrust_offset)),
            max_fb_acc=float(d.get("max_acc", base.max_fb_acc)),
            gravity=float(d.get("gravity", base.gravity)),
            drag_d=(float(d.get("drag_dx", 0.0)), float(d.get("drag_dy", 0.0)),
                    float(d.get("drag_dz", 0.0))),
            kp=(float(d.get("Kp_x", 8.0)), float(d.get("Kp_y", 8.0)),
                float(d.get("Kp_z", 10.0))),
            kv=(float(d.get("Kv_x", 1.5)), float(d.get("Kv_y", 1.5)),
                float(d.get("Kv_z", 3.3))),
            ctrl_mode=int(d.get("ctrl_mode", ERROR_QUATERNION)),
            feedthrough=bool(d.get("feedthrough_enable", False)),
        )


def geometric_control(p: GeoParams, state13: jax.Array, target_pos: jax.Array,
                      target_vel: jax.Array, target_acc: jax.Array,
                      target_yaw: jax.Array):
    """One control update -> (cmd [wx,wy,wz,thrust], q_des). Batchable."""
    pos = state13[..., 0:3]
    vel = state13[..., 3:6]
    q_cur = state13[..., 6:10]

    g_vec = jnp.zeros_like(pos).at[..., 2].set(-p.gravity)
    kp = jnp.asarray(p.kp, state13.dtype)
    kv = jnp.asarray(p.kv, state13.dtype)
    drag = jnp.asarray(p.drag_d, state13.dtype)

    if p.feedthrough:
        a_des = target_acc
    else:
        a_fb = -(kp * (pos - target_pos) + kv * (vel - target_vel))
        n = jnp.linalg.norm(a_fb, axis=-1, keepdims=True)
        a_fb = jnp.where(n > p.max_fb_acc, a_fb * (p.max_fb_acc / jnp.maximum(n, 1e-9)), a_fb)
        q_ref = quat.acc_yaw_to_q(target_acc - g_vec, target_yaw)
        # rotor drag: R_ref diag(D) R_ref^T v_target
        vb = quat.qrotate_inv(q_ref, target_vel) * drag
        a_rd = quat.qrotate(q_ref, vb)
        a_des = a_fb + target_acc - a_rd - g_vec

    q_des = quat.acc_yaw_to_q(a_des, target_yaw)

    zb = quat.qrotate(q_cur, jnp.zeros_like(pos).at[..., 2].set(1.0))
    thrust = jnp.clip(
        p.norm_thrust_const * jnp.sum(a_des * zb, -1) + p.norm_thrust_offset, 0.0, 1.0
    )

    if p.ctrl_mode == ERROR_GEOMETRIC:
        # Reference's exact SE(3) error expression
        # (geometric_controller.cpp:416-417).
        R = quat.q_to_rotmat(q_cur)
        Rd = quat.q_to_rotmat(q_des)
        A = jnp.swapaxes(Rd, -1, -2) @ R - jnp.swapaxes(R, -1, -2) @ Rd
        e = 0.5 * quat.vee(A)
        rate = (2.0 / p.attctrl_tau) * e
    else:
        qe = quat.qmul(quat.qconj(q_cur), q_des)
        s = jnp.where(qe[..., 0:1] >= 0, 1.0, -1.0)
        rate = (2.0 / p.attctrl_tau) * s * qe[..., 1:4]

    return jnp.concatenate([rate, thrust[..., None]], axis=-1), q_des


# ---------------------------------------------------------------------------
# Native (C++) implementation via ctypes
# ---------------------------------------------------------------------------

class _CGeoParams(ctypes.Structure):
    _fields_ = [
        ("attctrl_tau", ctypes.c_double),
        ("norm_thrust_const", ctypes.c_double),
        ("norm_thrust_offset", ctypes.c_double),
        ("max_fb_acc", ctypes.c_double),
        ("gravity", ctypes.c_double),
        ("drag_d", ctypes.c_double * 3),
        ("Kp", ctypes.c_double * 3),
        ("Kv", ctypes.c_double * 3),
        ("ctrl_mode", ctypes.c_int),
        ("feedthrough", ctypes.c_int),
    ]


def _native_lib() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    so = os.path.join(here, "csrc", "libmpc_native.so")
    if not os.path.exists(so):
        return None
    return ctypes.CDLL(so)


class NativeGeometricController:
    """C++ geometric controller + trajectory follower (real-time host path)."""

    def __init__(self, params: GeoParams = GeoParams()):
        self.lib = _native_lib()
        if self.lib is None:
            raise RuntimeError("csrc/libmpc_native.so not built (run: make -C csrc)")
        self.lib.geo_traj_load.restype = ctypes.c_void_p
        self.lib.geo_traj_sample.restype = ctypes.c_int
        self._p = _CGeoParams()
        self.lib.geo_params_default(ctypes.byref(self._p))
        self.set_params(params)
        self._traj = None

    def set_params(self, p: GeoParams):
        self._p.attctrl_tau = p.attctrl_tau
        self._p.norm_thrust_const = p.norm_thrust_const
        self._p.norm_thrust_offset = p.norm_thrust_offset
        self._p.max_fb_acc = p.max_fb_acc
        self._p.gravity = p.gravity
        for i in range(3):
            self._p.drag_d[i] = p.drag_d[i]
            self._p.Kp[i] = p.kp[i]
            self._p.Kv[i] = p.kv[i]
        self._p.ctrl_mode = p.ctrl_mode
        self._p.feedthrough = int(p.feedthrough)

    def load_params_file(self, path: str) -> bool:
        """Per-key hot reload from a flat config file (reference
        ``loadParameters`` semantics)."""
        rc = self.lib.geo_params_load(ctypes.byref(self._p), path.encode())
        return rc == 0

    def load_trajectory(self, csv_path: str) -> bool:
        h = self.lib.geo_traj_load(os.path.expanduser(csv_path).encode())
        if not h:
            return False
        if self._traj:
            self.lib.geo_traj_free(ctypes.c_void_p(self._traj))
        self._traj = h
        return True

    def sample_trajectory(self, t: float):
        if self._traj is None:
            return None
        pos = (ctypes.c_double * 3)()
        vel = (ctypes.c_double * 3)()
        acc = (ctypes.c_double * 3)()
        yaw = ctypes.c_double()
        self.lib.geo_traj_sample(ctypes.c_void_p(self._traj), ctypes.c_double(t),
                                 pos, vel, acc, ctypes.byref(yaw))
        return (np.array(pos[:]), np.array(vel[:]), np.array(acc[:]), yaw.value)

    def update(self, state13, target_pos, target_vel, target_acc, target_yaw):
        """One control update -> (cmd[4] = [wx,wy,wz,thrust], q_des[4])."""
        st = (ctypes.c_double * 13)(*np.asarray(state13, np.float64))
        tp = (ctypes.c_double * 3)(*np.asarray(target_pos, np.float64))
        tv = (ctypes.c_double * 3)(*np.asarray(target_vel, np.float64))
        ta = (ctypes.c_double * 3)(*np.asarray(target_acc, np.float64))
        cmd = (ctypes.c_double * 4)()
        qd = (ctypes.c_double * 4)()
        self.lib.geo_control_update(ctypes.byref(self._p), st, tp, tv, ta,
                                    ctypes.c_double(float(target_yaw)), cmd, qd)
        return np.array(cmd[:]), np.array(qd[:])

    def __del__(self):
        if getattr(self, "_traj", None) and getattr(self, "lib", None):
            self.lib.geo_traj_free(ctypes.c_void_p(self._traj))
