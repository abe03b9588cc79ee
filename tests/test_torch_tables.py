"""Host tables of the PyTorch port against the JAX reference: bit-equal.

The port keeps its own copies of the numpy (float64) schedule and
coefficient code, so the rows it feeds the device are exactly the
reference's: `np.testing.assert_array_equal`, no tolerance. The grids are
`timestep_grid`'s uniform log-SNR knots (no near-equal knots).
"""

import numpy as np
import pytest
import torch

from repro.core import coeffs as jcoeffs
from repro.diffusion import schedules as jsched
from repro.engine import EngineSpec as JSpec
from repro.engine import SamplerEngine as JEngine
from repro.engine.compiler import step_guidance_profile as j_profile
from repro_torch.core import coeffs as tcoeffs
from repro_torch.diffusion import schedules as tsched
from repro_torch.engine import EngineSpec as TSpec
from repro_torch.engine import SamplerEngine as TEngine
from repro_torch.engine.compiler import step_guidance_profile as t_profile

torch.set_num_threads(2)

ORDERS = (1, 2, 3)
VARIANTS = ("bh1", "bh2", "vary")
PREDICTIONS = ("data", "noise")
NFES = (5, 10, 20)


def _assert_rows_equal(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("spacing", ["logsnr", "time_uniform", "time_quadratic"])
@pytest.mark.parametrize("nfe", NFES)
def test_timestep_grid_bit_equal(spacing, nfe):
    for got, want in zip(tsched.timestep_grid(tsched.VPLinear(), nfe, spacing),
                         jsched.timestep_grid(jsched.VPLinear(), nfe, spacing)):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nfe", NFES)
@pytest.mark.parametrize("prediction", PREDICTIONS)
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("order", ORDERS)
def test_unipc_schedule_and_step_rows_bit_equal(order, variant, prediction, nfe):
    t, lam, a, s = jsched.timestep_grid(jsched.VPLinear(), nfe)
    kw = dict(lambdas=lam, alphas=a, sigmas=s, timesteps=t, order=order,
              prediction=prediction, variant=variant)
    got = tcoeffs.build_unipc_schedule(**kw)
    want = jcoeffs.build_unipc_schedule(**kw)
    for f in ("base_x", "base_m0", "w_pred", "w_corr_prev", "w_corr_new",
              "use_corrector", "out_scale", "timesteps", "lambdas"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f),
                                      err_msg=f)
    assert got.sign == want.sign and got.orders == want.orders
    _assert_rows_equal(tcoeffs.augment_step_rows(got),
                       jcoeffs.augment_step_rows(want))


@pytest.mark.parametrize("prediction", PREDICTIONS)
def test_stacked_step_rows_bit_equal(prediction):
    """Tiers of different order/NFE stacked into one bank: rows and spans."""
    def tables(mod, sched_mod):
        out = {}
        for name, (order, nfe) in {"fast": (2, 5), "balanced": (3, 8),
                                   "quality": (1, 20)}.items():
            t, lam, a, s = sched_mod.timestep_grid(sched_mod.VPLinear(), nfe)
            out[name] = mod.build_unipc_schedule(
                lambdas=lam, alphas=a, sigmas=s, timesteps=t, order=order,
                prediction=prediction)
        return out

    got_rows, got_tiers = tcoeffs.stack_step_rows(tables(tcoeffs, tsched))
    want_rows, want_tiers = jcoeffs.stack_step_rows(tables(jcoeffs, jsched))
    _assert_rows_equal(got_rows, want_rows)
    assert got_tiers == want_tiers


@pytest.mark.parametrize("schedule", ["constant", "linear", "cosine"])
def test_engine_tables_with_guidance_bit_equal(schedule):
    """SamplerEngine.compile attaches the same `g` column, and the per-slot
    step's guidance profile is the same."""
    spec_kw = dict(nfe=10, order=3, cfg_scale=2.5, cfg_schedule=schedule,
                   cfg_scale_end=0.5)
    tspec, jspec = TSpec(**spec_kw), JSpec(**spec_kw)
    got = TEngine(tsched.VPLinear(), eps=None, device="cpu").compile(tspec)
    want = JEngine(jsched.VPLinear(), eps=None).compile(jspec)
    _assert_rows_equal(tcoeffs.augment_step_rows(got),
                       jcoeffs.augment_step_rows(want))
    np.testing.assert_array_equal(t_profile(got, tspec), j_profile(want, jspec))
