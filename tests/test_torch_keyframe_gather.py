"""The temporal query's device path: a 0-d tensor timestamp picks and
gathers its keyframes on the tensor's device (ops/interpolation.py
`keyframe_coords` without `t_host`, `gather_keyframes` with a tensor index),
where a host timestamp slices them. The two paths must give the same bits,
the JAX package's values, and the device path must read nothing back.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu.ops import interpolation as jint
from ex4dgs_tpu_torch.models.temporal import point_data_at_t
from ex4dgs_tpu_torch.ops import interpolation as tint
from ex4dgs_tpu_torch.synthetic import make_scene

torch.set_num_threads(2)
K = 10
KINDS = ["linear", "cube", "pchip", "cubic_diff"]


def _y(seed, D=3, P=64):
    return np.random.default_rng(seed).normal(size=(P, K, D)).astype(np.float32)


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (NaN where the other has NaN, and the sign of 0)."""
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


def _boundaries(interval, shift):
    """Timestamps on keyframe boundaries, their float32 neighbours, and
    timestamps before the first keyframe and past the last. Subnormal
    neighbours of 0 are left out: XLA's CPU flushes them to zero, numpy and
    PyTorch do not."""
    base = np.arange(-2, K + 3, dtype=np.float32) * np.float32(interval) - np.float32(shift)
    ts = np.concatenate([base, np.nextafter(base, np.float32(np.inf)),
                         np.nextafter(base, np.float32(-np.inf))]).astype(np.float32)
    return ts[(ts == 0) | (np.abs(ts) >= np.finfo(np.float32).tiny)]


@pytest.mark.parametrize("offsets", [(0, 1), (-1, 0, 1, 2)])
@pytest.mark.parametrize("k", [-13, -11, -10, -3, -1, 0, 4, 8, 9, 10, 11, 15])
def test_device_gather_matches_slicing_and_jax(k, offsets):
    """Negative keyframes wrap as numpy's; keyframes outside the axis read
    NaN; the device gather equals the slices bit for bit and JAX's take."""
    y = _y(1)
    dev = tint.gather_keyframes(torch.tensor(y), torch.tensor(k), offsets)
    host = tint.gather_keyframes(torch.tensor(y), k, offsets)
    jax = jint.gather_keyframes(jnp.asarray(y), k, offsets)
    assert len(dev) == len(host) == len(jax) == len(offsets)
    for a, b, c in zip(dev, host, jax):
        assert _same_bits(a, b), (k, offsets)
        np.testing.assert_array_equal(a.numpy(), np.asarray(c))


def test_device_gather_takes_consecutive_offsets_only():
    with pytest.raises(ValueError, match="consecutive"):
        tint.gather_keyframes(torch.zeros(4, K, 3), torch.tensor(2), (0, 2))


@pytest.mark.parametrize("interval,shift", [(5, 8), (5, 3), (2, 1), (3.3, 2.5), (0.7, 0)])
def test_keyframe_index_on_the_device_matches_the_host(interval, shift):
    """The tensor path's index is the host's float32 floor, on every
    boundary and beside it."""
    for t in _boundaries(interval, shift):
        k, dt = tint.keyframe_coords(torch.tensor(t), shift, interval)
        k_host, dt_host = tint.keyframe_coords(torch.tensor(t), shift, interval,
                                               t_host=float(t))
        k_jax, _ = jint.keyframe_coords(jnp.asarray(t, jnp.float32), shift, interval)
        assert k.dtype == torch.int64 and k.dim() == 0
        assert int(k) == k_host == int(k_jax), t
        assert _same_bits(dt, dt_host)


@pytest.mark.parametrize("kind", KINDS)
def test_interpolation_through_a_device_index(kind):
    """Every positional kind, on and beside keyframe boundaries and out of
    range: the tensor index gives the host index's values bit for bit and
    JAX's within 1e-6; the gradients of y agree exactly too (NaN where the
    interpolation reads a keyframe past the axis, in both)."""
    shift = 8 if kind in ("cube", "pchip") else 3
    y, yd = _y(2), _y(3)
    for t in _boundaries(5, shift):
        tt = torch.tensor(t)
        k_d, dt = tint.keyframe_coords(tt, shift, 5)
        k_h, _ = tint.keyframe_coords(tt, shift, 5, t_host=float(t))
        outs, grads = [], []
        for k in (k_d, k_h):
            yt = torch.tensor(y, requires_grad=True)
            out = tint.interp_keyframes(kind, yt, k, dt, y_d=torch.tensor(yd))
            # (+ 0 y: past the axis neither path reads y)
            (g,) = torch.autograd.grad(torch.nan_to_num(out).sum() + 0.0 * yt.sum(), yt)
            outs.append(out.detach())
            grads.append(g)
        assert _same_bits(*outs), (kind, t)
        torch.testing.assert_close(*grads, rtol=0, atol=0, equal_nan=True)
        k_j, dt_j = jint.keyframe_coords(jnp.asarray(t, jnp.float32), shift, 5)
        want = jint.interp_keyframes(kind, jnp.asarray(y), k_j, dt_j, y_d=jnp.asarray(yd))
        np.testing.assert_allclose(outs[0].numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["lerp", "slerp"])
def test_rotation_interpolation_through_a_device_index(kind):
    y = _y(4, D=4)
    for t in _boundaries(5, 3):
        tt = torch.tensor(t)
        k_d, dt = tint.keyframe_coords(tt, 3, 5)
        k_h, _ = tint.keyframe_coords(tt, 3, 5, t_host=float(t))
        got = tint.interp_quat_keyframes(kind, torch.tensor(y), k_d, dt)
        assert _same_bits(got, tint.interp_quat_keyframes(kind, torch.tensor(y), k_h, dt)), t
        k_j, dt_j = jint.keyframe_coords(jnp.asarray(t, jnp.float32), 3, 5)
        want = jint.interp_quat_keyframes(kind, jnp.asarray(y), k_j, dt_j)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, rtol=0)


@pytest.mark.parametrize("t", [0.0, 2.0, 5.0, 7.5, 9.999, 12.5, -3.0])
def test_point_data_with_a_tensor_t_reads_nothing_back(t, monkeypatch):
    """point_data_at_t with a 0-d tensor t makes no .item() (nor any other
    read of a tensor's value on the host) and gives the host t's point
    data bit for bit, out to past the last keyframe."""
    model, cfg = make_scene(n_static=40, n_dynamic=12, duration=10.0, seed=4, device="cpu")
    want = point_data_at_t(model, cfg, t)

    def refuse(self, *a, **k):
        raise AssertionError("a tensor's value was read on the host")

    for name in ("item", "tolist", "__float__", "__int__", "__bool__", "__index__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    got = point_data_at_t(model, cfg, torch.tensor(t, dtype=torch.float32))
    monkeypatch.undo()
    for f in ("means3d", "rotations", "scales", "opacity", "features"):
        assert _same_bits(getattr(got, f), getattr(want, f)), f
    assert torch.equal(got.mask, want.mask) and got.static_num == want.static_num
