"""Batched math (port of :mod:`gym_collision_avoidance_tpu.core.maths`).

All functions broadcast over leading axes; the last axis of a vector is
``(x, y)``.  XLA's and torch's ``atan2`` / ``sin`` / ``cos`` differ by ulps,
so floats agree with the JAX package to a tolerance, not bitwise, except on
the strict-parity route (``cfg.strict_parity``), which computes ``atan2`` and
the dynamics in host numpy as the JAX package's route does.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_TWO_PI = 2.0 * math.pi


def wrap(angle: torch.Tensor) -> torch.Tensor:
    """Wrap angle(s) to ``[-pi, pi)`` with the reference's unrolled
    subtract/add steps (``envs/util.py:141-146``)."""
    for _ in range(3):
        angle = torch.where(angle >= math.pi, angle - _TWO_PI, angle)
        angle = torch.where(angle < -math.pi, angle + _TWO_PI, angle)
    return angle


def on_host(fn, *tensors):
    """``fn`` on the tensors' host numpy copies; every array it returns comes
    back as a tensor of the first tensor's dtype and device (as
    ``jax.pure_callback`` casts to its declared dtype).  The strict-parity
    route's counterpart of that callback: a host round trip (and a
    synchronise on the card) for each call, for validation, not speed."""
    like = tensors[0]
    out = fn(*(t.detach().cpu().numpy() for t in tensors))
    np_dtype = np.float32 if like.dtype == torch.float32 else np.float64
    single = not isinstance(out, tuple)
    back = tuple(torch.from_numpy(np.asarray(o, np_dtype)).to(like.device)
                 for o in ((out,) if single else out))
    return back[0] if single else back


def arctan2(y: torch.Tensor, x: torch.Tensor, exact: bool = False) -> torch.Tensor:
    """``atan2``.  ``exact=True`` (strict-parity mode) computes it in host
    numpy, whose libm ``atan2`` is the reference simulator's, as the JAX
    package's ``pure_callback`` route does."""
    if exact:
        dtype = torch.promote_types(y.dtype, x.dtype)
        return on_host(np.arctan2, y.to(dtype), x.to(dtype))
    return torch.atan2(y, x)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Square root rounded to nearest, as IEEE 754 defines it, on every
    device: the package's one square root.  PyTorch's CUDA ``sqrt`` is
    (``tests/test_torch_policies_cuda.py`` holds it bitwise to numpy's); its
    CPU ``sqrt``, MKL's vector root, is an ulp off on some inputs
    (``scripts/compare_devices.py`` finds it), so on the CPU a float32 or
    float64 root is numpy's."""
    if x.device.type != "cpu" or x.dtype not in (torch.float32, torch.float64):
        return torch.sqrt(x)
    a = x.detach().numpy()
    return torch.from_numpy(np.sqrt(a, out=np.empty_like(a)))


def clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip(x, lo, hi)``: ``minimum(maximum(x, lo), hi)``, whose
    gradient at a bound is 0.5, as JAX splits a tie of ``maximum`` or
    ``minimum`` between its operands (``torch.clamp`` passes 1)."""
    return torch.minimum(torch.maximum(x, x.new_tensor(lo)), x.new_tensor(hi))


def l2norm(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """sqrt(dx^2 + dy^2), elementwise (envs/util.py:17-21)."""
    return sqrt_rn(dx * dx + dy * dy)


def norm2(vec: torch.Tensor) -> torch.Tensor:
    """Euclidean norm of ``[..., 2]`` vectors, summed as ``x*x + y*y``."""
    return l2norm(vec[..., 0], vec[..., 1])


def goal_frame_axes(pos: torch.Tensor, goal: torch.Tensor):
    """Goal-aligned ego frame axes (``Agent.get_ref``, envs/agent.py:329-349).

    Returns:
        (ref_prll [..., 2], ref_orth [..., 2], dist_to_goal [...])
    """
    goal_direction = goal - pos
    dist = norm2(goal_direction)
    safe = torch.clamp(dist, min=1e-30)
    ref_prll = torch.where(
        (dist > 1e-8)[..., None], goal_direction / safe[..., None], goal_direction
    )
    ref_orth = torch.stack([-ref_prll[..., 1], ref_prll[..., 0]], dim=-1)
    return ref_prll, ref_orth, dist


def filter_vel(dt: float, past_vel_xy: torch.Tensor) -> torch.Tensor:
    """dt-weighted average of past velocities -> ``[..., 2]`` (speed, angle)
    (``envs/util.py:124-131``), with every weight the constant ``dt``: the
    JAX package's one caller, SA-CADRL (``policies/cadrl.py:543-544``),
    closes over ``full((3, 2), cfg.dt)``.  As its compiled step computes it,
    the weighted samples of ``past_vel_xy`` ``[..., K, 2]`` are summed from 0
    in order, and the quotient by the constant ``K * dt`` is a product with
    its reciprocal, both rounded to the dtype."""
    np_dtype = np.float32 if past_vel_xy.dtype == torch.float32 else np.float64
    w = np_dtype(dt)
    denom = np_dtype(0.0)
    total = torch.zeros_like(past_vel_xy[..., 0, :])
    for k in range(past_vel_xy.shape[-2]):
        denom = denom + w
        total = total + float(w) * past_vel_xy[..., k, :]
    avg = total * float(np_dtype(1.0) / denom)
    return torch.stack([norm2(avg), torch.atan2(avg[..., 1], avg[..., 0])], dim=-1)


def compute_time_to_impact(host_pos, other_pos, host_vel, other_vel, combined_radius):
    """Analytic time-to-collision via collision-cone tangents
    (``envs/util.py:23-112``), branch-free.  0 when already overlapping,
    +inf when the relative velocity is outside the cone or (near) zero."""
    v_rel = host_vel - other_vel
    xp, yp = host_pos[..., 0], host_pos[..., 1]
    a, b = other_pos[..., 0], other_pos[..., 1]
    r = combined_radius

    dx, dy = xp - a, yp - b
    den = dx * dx + dy * dy
    sq_dist_to_perimeter = den - r * r
    already_colliding = sq_dist_to_perimeter < 0

    sqrt_term = sqrt_rn(torch.clamp(sq_dist_to_perimeter, min=0.0))
    safe_den = torch.clamp(den, min=1e-30)
    # Tangent points on the collision circle (envs/util.py:95-106).
    xnum1 = r * r * dx
    xnum2 = r * dy * sqrt_term
    ynum1 = r * r * dy
    ynum2 = r * dx * sqrt_term
    vec1_x = (xnum1 + xnum2) / safe_den + a - xp
    vec1_y = (ynum1 - ynum2) / safe_den + b - yp
    vec2_x = (xnum1 - xnum2) / safe_den + a - xp
    vec2_y = (ynum1 + ynum2) / safe_den + b - yp
    v0, v1 = v_rel[..., 0], v_rel[..., 1]

    def cross(ux, uy, vx, vy):
        return ux * vy - uy * vx

    # Is v_rel inside the cone spanned by vec1, vec2? (envs/util.py:39-40)
    inside = (cross(vec1_x, vec1_y, v0, v1) * cross(vec1_x, vec1_y, vec2_x, vec2_y) >= 0) & (
        cross(vec2_x, vec2_y, v0, v1) * cross(vec2_x, vec2_y, vec1_x, vec1_y) >= 0
    )
    moving = (torch.abs(v0) >= 1e-5) | (torch.abs(v1) >= 1e-5)

    # Distance from host to the circle along v_rel (envs/util.py:41-79):
    # the generic and the vertical quadratic, solved branch-free.
    vertical = torch.abs(v0) < 1e-5
    slope = v1 / torch.where(vertical, torch.ones_like(v0), v0)
    A_g = 1 + slope * slope
    B_g = -2 * a + 2 * slope * (yp - b - slope * xp)
    t = slope * xp - (yp - b)
    C_g = a * a - r * r + t * t
    det_g = torch.clamp(B_g * B_g - 4 * A_g * C_g, min=0.0)
    x1 = (-B_g + sqrt_rn(det_g)) / (2 * A_g)
    x2 = (-B_g - sqrt_rn(det_g)) / (2 * A_g)
    y1 = slope * (x1 - xp) + yp
    y2 = slope * (x2 - xp) + yp

    B_v = -2 * b
    u = xp - a
    C_v = b * b + u * u - r * r
    det_v = torch.clamp(B_v * B_v - 4 * C_v, min=0.0)
    yv1 = (-B_v + sqrt_rn(det_v)) / 2
    yv2 = (-B_v - sqrt_rn(det_v)) / 2

    x1 = torch.where(vertical, xp, x1)
    x2 = torch.where(vertical, xp, x2)
    y1 = torch.where(vertical, yv1, y1)
    y2 = torch.where(vertical, yv2, y2)

    d = torch.minimum(l2norm(x1 - xp, y1 - yp), l2norm(x2 - xp, y2 - yp))
    ttc = d / torch.clamp(norm2(v_rel), min=1e-30)

    inf = torch.full_like(ttc, math.inf)
    out = torch.where(inside & moving, ttc, inf)
    return torch.where(already_colliding, torch.zeros_like(out), out)


def _tensor(x) -> torch.Tensor:
    return x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x))


def find_nearest(array, value):
    """For each value, the nearest entry of a 1-D array and its index
    (envs/util.py:148-153); the first index on a tie, as ``argmin``."""
    array, value = _tensor(array), torch.atleast_1d(_tensor(value))
    idx = torch.argmin(torch.abs(array[None, :] - value[:, None]), dim=1)
    return array[idx], idx


def rad2deg(rad):
    """Radians to degrees, ``rad * 180 / pi`` in that order."""
    return _tensor(rad) * 180.0 / math.pi


def l2normsq(x, y):
    """(x0-y0)^2 + (x1-y1)^2 (envs/util.py:20-21)."""
    x, y = _tensor(x), _tensor(y)
    return (x[..., 0] - y[..., 0]) ** 2 + (x[..., 1] - y[..., 1]) ** 2


def yaw_to_quaternion(yaw):
    """Planar yaw -> (qx, qy, qz, qw) (envs/util.py:175-188)."""
    yaw = _tensor(yaw)
    return (torch.zeros_like(yaw), torch.zeros_like(yaw), torch.sin(yaw * 0.5),
            torch.cos(yaw * 0.5))
