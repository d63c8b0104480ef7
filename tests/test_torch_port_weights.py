"""dskd_tpu_torch.utils.weights.state_dict_from_jax is the exact inverse of
dskd_tpu.utils.torch_weights.convert_mmdet_gfl_ddetr, and the port's
parameter names are the mmdet checkpoint keys."""
import pytest
import torch

from dskd_tpu.utils.torch_weights import convert_mmdet_gfl_ddetr
from dskd_tpu_torch.models.detector import GFLDeformableDETR, init_weights
from dskd_tpu_torch.utils.weights import state_dict_from_jax

from test_mmdet_convert import _synthetic_mmdet_state

torch.set_num_threads(1)


def _tiny(depth):
    return GFLDeformableDETR("cpu", num_classes=7, num_query=12, depth=depth,
                             num_encoder_layers=1, num_decoder_layers=2)


def _assert_same(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == torch.float32, k
        assert torch.equal(got[k], want[k].float()), k


def test_round_trip_of_synthetic_mmdet_state():
    state = _synthetic_mmdet_state(seed=5)
    params, stats = convert_mmdet_gfl_ddetr(state, depth=18)
    _assert_same(state_dict_from_jax({"params": params,
                                      "batch_stats": stats}), state)


def test_port_loads_the_mmdet_keys_strictly():
    state = _synthetic_mmdet_state(seed=6)
    model = _tiny(18)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == \
        {k: tuple(v.shape) for k, v in state.items()}
    model.load_state_dict(state, strict=True)


@pytest.mark.parametrize("depth", [18, 50])
def test_round_trip_of_port_weights(depth):
    """The port's own seeded weights through the JAX converter and back:
    covers the bottleneck blocks the synthetic resnet18 state lacks."""
    model = _tiny(depth)
    init_weights(model, seed=depth)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for i, k in enumerate(sorted(state)):     # no constant tensors
        state[k] += 1e-3 * (i + 1)
    params, stats = convert_mmdet_gfl_ddetr(state, depth=depth)
    back = state_dict_from_jax({"params": params, "batch_stats": stats})
    _assert_same(back, state)
    model.load_state_dict(back, strict=True)
