"""The tiny train step of test_torch_port_train_step under each of the
non-windowed MSDA sampling switches, ``DSKD_WGATHER=0`` and
``DSKD_FUSED_ROWS=N``: every loss key and the gradient of every parameter
against JAX's ``compute_losses`` + ``jax.grad`` under the same environment,
its Pallas kernels in interpret mode and ``DSKD_FORCE_MXU=1``, and the
branches the port took.
"""
import pytest
import torch

from test_torch_port_sampling import branch_calls  # noqa: F401 (fixture)
from test_torch_port_train_step import assert_gradients_match, \
    assert_losses_match, jax_step_run

torch.set_num_threads(1)

# the tiny model's levels are 8x8, 4x4, 2x2 and 1x1 (packed 100, 36, 16 and
# 9 rows): level 0 stays on the default branch under each switch
TRAIN_SWITCHES = {
    "wgather0": {"DSKD_WGATHER": "0", "DSKD_MXU_GATHER_ROWS": "50"},
    "fused16": {"DSKD_FUSED_ROWS": "16", "DSKD_MXU_GATHER_ROWS": "50"},
}


@pytest.fixture(scope="module", params=sorted(TRAIN_SWITCHES))
def switch_run(request):
    """JAX's loss and gradients of the tiny step, and the environment that
    selects the switch in both packages while the port's side runs."""
    from jax.experimental import pallas as pl

    with pytest.MonkeyPatch.context() as m:
        orig = pl.pallas_call
        m.setattr(pl, "pallas_call",
                  lambda *a, **k: orig(*a, **{"interpret": True, **k}))
        m.setenv("DSKD_FORCE_MXU", "1")
        for k, v in TRAIN_SWITCHES[request.param].items():
            m.setenv(k, v)
        run = jax_step_run()
    return request.param, run


# per MSDA call of the port's step (teacher and student, one encoder and
# one decoder layer each: four calls): level 0 on the default branch,
# levels 1-3 on the switch's
TRAIN_CALLS = {"wgather0": {"gather_weighted": 4, "mxu_gather": 12},
               "fused16": {"gather_weighted": 4, "fused_msda_sample": 12}}


@pytest.fixture
def switch_env(switch_run, branch_calls, monkeypatch):
    name, run = switch_run
    for k, v in TRAIN_SWITCHES[name].items():
        monkeypatch.setenv(k, v)
    yield run
    assert branch_calls == TRAIN_CALLS[name]


def test_train_step_losses_match_jax_under_switch(switch_env):
    assert_losses_match(switch_env)


def test_train_step_gradients_match_jax_under_switch(switch_env):
    assert_gradients_match(switch_env)
