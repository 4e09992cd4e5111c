"""ex4dgs_tpu_torch RAdam, LR schedules and gradient masks against the JAX
package's, on the same seeded values.

RAdam runs 10 steps (the rectified branch turns on at step 6); params and
moments agree to 1e-7 absolute (float32 rounding of the same update), the
step count exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ex4dgs_tpu.models import optimizer as jopt
from ex4dgs_tpu.models.config import OptimizationConfig as JOpt
from ex4dgs_tpu_torch.models import optimizer as topt
from ex4dgs_tpu_torch.models.config import OptimizationConfig

torch.set_num_threads(2)


def test_optimization_config_matches_jax():
    assert vars(OptimizationConfig()) == vars(JOpt())


def test_radam_matches_jax_over_ten_steps():
    rng = np.random.default_rng(0)
    params = {"xyz": rng.normal(size=(40, 3)), "opacity": rng.normal(size=(40, 1)),
              "motion_xyz": rng.normal(size=(8, 5, 3))}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    lrs = {"xyz": 0.01, "opacity": 0.05, "motion_xyz": 0.003}
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = jopt.init_state(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = topt.init_state(tp, device="cpu")
    for i in range(10):
        g = {k: (rng.normal(size=v.shape) * (0.1 + i)).astype(np.float32)
             for k, v in params.items()}
        jp, js = jopt.radam_update(jp, {k: jnp.asarray(v) for k, v in g.items()}, js, lrs)
        tp, ts = topt.radam_update(tp, {k: torch.tensor(v) for k, v in g.items()}, ts, lrs)
        for k in params:
            for got, want in ((tp[k], jp[k]), (ts.mu[k], js.mu[k]), (ts.nu[k], js.nu[k])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-7, rtol=0,
                                           err_msg=f"step {i + 1} {k}")
        assert int(ts.step) == int(js.step) == i + 1
        assert ts.step.dtype == torch.int32


@pytest.mark.parametrize("step", [-1, 0, 1, 50, 999, 5000, 30_000, 40_000])
def test_lr_schedules_match_jax(step):
    for kw in (dict(), dict(lr_delay_steps=1000, lr_delay_mult=0.01),
               dict(lr_delay_mult=0.01, max_steps=30_000)):
        got = float(topt.expon_lr(step, 1.6e-4, 1.6e-6, **kw))
        want = float(jopt.expon_lr(step, 1.6e-4, 1.6e-6, **kw))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0, err_msg=str(kw))
    assert float(topt.expon_lr(step, 0.0, 0.0)) == 0.0
    got = topt.group_lrs(OptimizationConfig(), 3.0, step)
    want = jopt.group_lrs(JOpt(), 3.0, jnp.asarray(step, jnp.int32))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, atol=0,
                                   err_msg=k)


def test_mask_grads_kills_nan_on_padding_and_scrub_nan():
    from torch_parity import port_model

    from ex4dgs_tpu.models.config import ModelConfig
    from ex4dgs_tpu.models.state import empty_model

    jm = empty_model(ModelConfig(), 16, 8, 6, duration=5)
    jm = jm._replace(static_mask=jm.static_mask.at[:5].set(True),
                     dynamic_mask=jm.dynamic_mask.at[:3].set(True))
    tm = port_model(jm)
    rng = np.random.default_rng(1)
    grads = {}
    for k, v in tm.params.items():
        g = rng.normal(size=v.shape).astype(np.float32)
        g[-1] = np.nan  # a padding row
        g.reshape(g.shape[0], -1)[0, 0] = np.inf if k != "motion_opacity_var" else np.nan
        grads[k] = g
    want = jopt.scrub_nan(jopt.mask_grads({k: jnp.asarray(v) for k, v in grads.items()}, jm))
    got = topt.scrub_nan(topt.mask_grads({k: torch.tensor(v) for k, v in grads.items()}, tm))
    for k in grads:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        assert not np.isnan(got[k].numpy()).any(), k
