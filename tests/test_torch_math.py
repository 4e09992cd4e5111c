"""ex4dgs_tpu_torch math3d and interpolation against the JAX package.

Inputs come from numpy seeds and go through both packages. Tolerance: atol
1e-6 (float32 elementwise math in the same operation order; the residue is
libm differences in exp/sin/arccos and summation order of 3-4 terms).
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu.ops import interpolation as jint
from ex4dgs_tpu.ops import math3d as jm3
from ex4dgs_tpu_torch.ops import interpolation as tint
from ex4dgs_tpu_torch.ops import math3d as tm3

torch.set_num_threads(2)
ATOL = 1e-6


def _close(t_out, j_out, atol=ATOL, rtol=0.0):
    np.testing.assert_allclose(t_out.numpy() if torch.is_tensor(t_out) else t_out,
                               np.asarray(j_out), atol=atol, rtol=rtol)


def _rng_arrays(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("normalize", [True, False])
def test_quat_to_rotmat(normalize):
    (q,) = _rng_arrays(0, (64, 4))
    _close(tm3.quat_to_rotmat(torch.tensor(q), normalize),
           jm3.quat_to_rotmat(jnp.asarray(q), normalize))


def test_cov3d_from_scaling_rotation():
    q, s = _rng_arrays(1, (128, 4), (128, 3))
    s = np.abs(s) * 0.3
    _close(tm3.cov3d_from_scaling_rotation(torch.tensor(s), torch.tensor(q), 1.3),
           jm3.cov3d_from_scaling_rotation(jnp.asarray(s), jnp.asarray(q), 1.3))


def test_ewa_project_cov():
    mean, cov_f, w = _rng_arrays(2, (128, 3), (128, 3, 3), (3, 3))
    mean[:, 2] = np.abs(mean[:, 2]) * 3 + 1.0
    cov = cov_f @ np.transpose(cov_f, (0, 2, 1)) * 0.01
    iu = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
    packed = np.stack([cov[:, i, j] for i, j in iu], -1).astype(np.float32)
    args = (500.0, 480.0, np.float32(0.57), np.float32(0.43), 0.1)
    c_t, k_t = tm3.ewa_project_cov(torch.tensor(mean), torch.tensor(packed), torch.tensor(w),
                                   *(torch.tensor(a) if isinstance(a, np.floating) else a
                                     for a in args))
    c_j, k_j = jm3.ewa_project_cov(jnp.asarray(mean), jnp.asarray(packed), jnp.asarray(w),
                                   *args)
    # cov2d entries reach ~1e3 (focal^2 / z^2): compare relative to float32 ulp
    _close(c_t, c_j, atol=0.0, rtol=1e-6)
    _close(k_t, k_j)


@pytest.mark.parametrize("deg", [0, 1, 2, 3])
def test_eval_sh_and_sh_to_rgb(deg):
    sh, means, campos = _rng_arrays(3 + deg, (96, 16, 3), (96, 3), (3,))
    sh *= 0.5
    _close(tm3.eval_sh(deg, torch.tensor(sh), torch.tensor(means / np.linalg.norm(
        means, axis=-1, keepdims=True))),
        jm3.eval_sh(deg, jnp.asarray(sh), jnp.asarray(means / np.linalg.norm(
            means, axis=-1, keepdims=True))))
    _close(tm3.sh_to_rgb(deg, torch.tensor(sh), torch.tensor(means), torch.tensor(campos)),
           jm3.sh_to_rgb(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(campos)))


def test_small_conversions():
    (x,) = _rng_arrays(7, (256,))
    p = (1.0 / (1.0 + np.exp(-x))).astype(np.float32)
    _close(tm3.inverse_sigmoid(torch.tensor(p)), jm3.inverse_sigmoid(jnp.asarray(p)))
    _close(tm3.rgb_to_sh0(torch.tensor(p)), jm3.rgb_to_sh0(jnp.asarray(p)))
    _close(tm3.ndc2pix(torch.tensor(x), 1352), jm3.ndc2pix(jnp.asarray(x), 1352))
    assert tm3.fov2focal(1.1, 1352) == jm3.fov2focal(1.1, 1352)


@pytest.mark.parametrize("cxy", [(0.0, 0.0), (0.1, -0.05)])
def test_camera_matrices(cxy):
    (R,) = _rng_arrays(8, (3, 3))
    R, _ = np.linalg.qr(R.astype(np.float64))
    t = np.array([0.3, -0.2, 2.0])
    np.testing.assert_array_equal(tm3.world_to_view(R, t, translate=[0.1, 0, 0], scale=1.5),
                                  jm3.world_to_view(R, t, translate=[0.1, 0, 0], scale=1.5))
    np.testing.assert_array_equal(tm3.projection_matrix(0.2, 300.0, 1.1, 0.9, *cxy),
                                  jm3.projection_matrix(0.2, 300.0, 1.1, 0.9, *cxy))


def _y(seed, P=64, K=10, D=3):
    (y,) = _rng_arrays(seed, (P, K, D))
    return y


@pytest.mark.parametrize("kind", ["linear", "cube", "pchip", "cubic_diff"])
@pytest.mark.parametrize("t", [0.0, 2.5, 7.3, 13.9])
def test_interp_keyframes(kind, t):
    y = _y(10)
    yd = _y(11)
    shift = 8 if kind in ("cube", "pchip") else 3
    k_t, dt_t = tint.keyframe_coords(torch.tensor(t, dtype=torch.float32), shift, 5)
    k_j, dt_j = jint.keyframe_coords(jnp.asarray(t, jnp.float32), shift, 5)
    assert k_t == int(k_j)
    _close(dt_t, dt_j)
    _close(tint.interp_keyframes(kind, torch.tensor(y), k_t, dt_t, y_d=torch.tensor(yd)),
           jint.interp_keyframes(kind, jnp.asarray(y), k_j, dt_j, y_d=jnp.asarray(yd)))


@pytest.mark.parametrize("kind", ["lerp", "slerp"])
@pytest.mark.parametrize("t", [0.0, 3.7, 9.1])
def test_interp_quat_keyframes(kind, t):
    y = _y(12, D=4)
    y[5, 3] = y[5, 4]  # identical neighbours: the slerp guards take over
    y[6, 3] = -y[6, 4]  # antipodal neighbours
    k_t, dt_t = tint.keyframe_coords(torch.tensor(t, dtype=torch.float32), 3, 5)
    k_j, dt_j = jint.keyframe_coords(jnp.asarray(t, jnp.float32), 3, 5)
    _close(tint.interp_quat_keyframes(kind, torch.tensor(y), k_t, dt_t),
           jint.interp_quat_keyframes(kind, jnp.asarray(y), k_j, dt_j))


@pytest.mark.parametrize("k", [-12, -2, 0, 9, 10, 14])
def test_gather_keyframes_out_of_range(k):
    """Negative keyframes wrap as numpy does; past the axis they read NaN."""
    y = _y(13)
    for a, b in zip(tint.gather_keyframes(torch.tensor(y), k, (-1, 0, 1, 2)),
                    jint.gather_keyframes(jnp.asarray(y), k, (-1, 0, 1, 2))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_time_bigaussian():
    rng = np.random.default_rng(14)
    center = np.sort(rng.uniform(0, 6, (200, 2)), axis=1).astype(np.float32)
    var = rng.normal(size=(200, 2)).astype(np.float32)
    for tu in (0.0, 1.6, 3.3, 7.0):
        _close(tint.time_bigaussian(torch.tensor(center), torch.tensor(var),
                                    torch.tensor(tu), var_min=0.6),
               jint.time_bigaussian(jnp.asarray(center), jnp.asarray(var), jnp.asarray(tu),
                                    var_min=0.6))


def test_pointwise_interpolators():
    a, b, c, d, e = _rng_arrays(15, *[(50, 3)] * 5)
    tt = np.float32(0.37)
    _close(tint.linear_interp(torch.tensor(a), torch.tensor(b), torch.tensor(tt)),
           jint.linear_interp(jnp.asarray(a), jnp.asarray(b), tt))
    for tf, jf in ((tint.cube_interp, jint.cube_interp), (tint.pchip_interp, jint.pchip_interp)):
        _close(tf(*map(torch.tensor, (a, b, c, d)), torch.tensor(tt)),
               jf(*map(jnp.asarray, (a, b, c, d)), tt))
    _close(tint.cubic_diff_interp(*map(torch.tensor, (a, b, c, e)), torch.tensor(tt)),
           jint.cubic_diff_interp(*map(jnp.asarray, (a, b, c, e)), tt))
    q0, q1 = _rng_arrays(16, (50, 4), (50, 4))
    _close(tint.quat_slerp(torch.tensor(q0), torch.tensor(q1), torch.tensor(tt)),
           jint.quat_slerp(jnp.asarray(q0), jnp.asarray(q1), tt))
    assert math.isclose(float(tm3.SH_C0), float(jm3.SH_C0))
