"""SE(3) rigid transforms as (R: (3,3), t: (3,)) pairs, cv::Affine3f-style.

Replaces the OpenCV Affine3f usage of the reference (pose composition in
kinfu.cpp:194, incremental ICP updates in projective_icp.cpp:151-152, the
rvec/translation ctor `Affine3f(Vec3f rvec, Vec3f t)`).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# 3x3 geometry matmuls must be exact float32: the default matmul precision may
# round f32 operands (TF32 on a GPU).
_mm = functools.partial(jnp.matmul, precision=jax.lax.Precision.HIGHEST)


def identity(dtype=jnp.float32):
    return jnp.eye(3, dtype=dtype), jnp.zeros((3,), dtype=dtype)


def make(R, t):
    return jnp.asarray(R), jnp.asarray(t)


def compose(a, b):
    """a after b: (Ra, ta) * (Rb, tb) = (Ra Rb, Ra tb + ta)."""
    Ra, ta = a
    Rb, tb = b
    return _mm(Ra, Rb), _mm(Ra, tb) + ta


def inverse(a):
    R, t = a
    Rinv = R.T
    return Rinv, -_mm(Rinv, t)


def apply(a, p):
    """Transform points (..., 3)."""
    R, t = a
    return _mm(p, R.T) + t


def rotate(a, v):
    R, _ = a
    return _mm(v, R.T)


def from_rodrigues(rvec, t):
    """Rotation-vector (angle*axis) + translation, cv::Rodrigues semantics."""
    rvec = jnp.asarray(rvec, jnp.float32)
    theta = jnp.linalg.norm(rvec)
    safe = jnp.where(theta == 0, 1.0, theta)
    k = rvec / safe
    K = jnp.array(
        [[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]], [-k[1], k[0], 0.0]],
        dtype=rvec.dtype,
    )
    R = (
        jnp.eye(3, dtype=rvec.dtype)
        + jnp.sin(theta) * K
        + (1.0 - jnp.cos(theta)) * _mm(K, K)
    )
    return R, jnp.asarray(t, rvec.dtype)


def rvec(a):
    """Rotation vector of R (inverse Rodrigues)."""
    R, _ = a
    cos_theta = jnp.clip((jnp.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    theta = jnp.arccos(cos_theta)
    axis_raw = jnp.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], dtype=R.dtype
    )
    s = jnp.linalg.norm(axis_raw)
    axis = axis_raw / jnp.where(s == 0, 1.0, s)
    return theta * axis
