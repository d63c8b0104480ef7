"""The port's model in training mode: ``frozen_stages`` against the JAX
ResNet's stop-gradients, and dropout drawn from an explicit generator.
Tiny configuration of test_torch_port_tiny, f32 on the CPU."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dskd_tpu_torch.models.transformer import dropout
from dskd_tpu_torch.utils.weights import state_dict_from_jax

from test_torch_port_tiny import port_model, tiny_batch, tiny_variables

torch.set_num_threads(1)


def test_frozen_stages_match_jax_stop_gradient():
    from dskd_tpu.models.resnet import ResNet as JaxResNet

    variables = tiny_variables(seed=5)
    images = tiny_batch()[0]
    rng = np.random.RandomState(1)
    model = port_model(variables)
    x = torch.from_numpy(images).permute(0, 3, 1, 2)
    outs = model.backbone(x)
    cots = [rng.randn(*o.shape).astype(np.float32) for o in outs]
    sum(((o * torch.from_numpy(c)).sum() for o, c in zip(outs, cots))
        ).backward()

    bp, bs = variables["params"]["backbone"], \
        variables["batch_stats"]["backbone"]
    jnet = JaxResNet(depth=18, out_indices=(1, 2, 3), frozen_stages=1)

    def loss(p):
        jouts = jnet.apply({"params": p, "batch_stats": bs},
                           jnp.asarray(images))
        return sum((o * jnp.asarray(c.transpose(0, 2, 3, 1))).sum()
                   for o, c in zip(jouts, cots))

    grads = jax.jit(jax.grad(loss))(bp)
    tree = jax.tree.map(jnp.zeros_like, variables["params"])
    tree["backbone"] = grads
    want = state_dict_from_jax({"params": tree,
                                "batch_stats": variables["batch_stats"]})
    n_layer2 = 0
    for name, p in model.backbone.named_parameters(prefix="backbone"):
        if name.startswith(("backbone.conv1.", "backbone.bn1.",
                            "backbone.layer1.")):
            assert p.grad is None, name
            assert not want[name].numpy().any(), name
        elif name.startswith("backbone.layer2.") and "conv" in name:
            ref = want[name].numpy()
            # f32 convolution backward in another order: 1e-4 of the scale
            np.testing.assert_allclose(p.grad.numpy(), ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(),
                                       err_msg=name)
            n_layer2 += 1
    assert n_layer2 == 4


def _forward(model, gen=None):
    images, img_hw = (torch.from_numpy(a) for a in tiny_batch()[:2])
    with torch.no_grad():
        out = model(images, img_hw, generator=gen)
    return torch.cat([out.head.cls_scores.flatten(),
                      out.head.bbox_preds.flatten(), out.head.hs.flatten()])


def test_dropout_off_at_p0_and_in_eval():
    """At p=0 the training forward equals the eval forward bit for bit, and
    with p=0.1 eval is the same function again."""
    variables = tiny_variables(seed=6)
    model0 = port_model(variables, dropout=0.0)
    want = _forward(model0.eval())
    got = _forward(model0.train(), torch.Generator().manual_seed(3))
    assert torch.equal(got, want)
    assert torch.equal(_forward(port_model(variables, dropout=0.1).eval(),
                                torch.Generator().manual_seed(3)), want)


def test_dropout_masks_come_from_the_generator():
    """One seed gives the same output twice, another seed another output;
    the global RNG plays no part."""
    model = port_model(tiny_variables(seed=7), dropout=0.1).train()
    a = _forward(model, torch.Generator().manual_seed(4))
    torch.manual_seed(123)
    b = _forward(model, torch.Generator().manual_seed(4))
    c = _forward(model, torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
    assert not torch.equal(a, c)
    assert not torch.equal(a, _forward(model.eval()))


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_is_flax_dropout(p):
    """Kept values are scaled by 1/(1-p), dropped ones are 0, and about 1-p
    of them are kept; in training mode it needs a generator."""
    x = torch.rand(200, 100) + 0.5
    y = dropout(x, p, True, torch.Generator().manual_seed(0))
    kept = y != 0
    torch.testing.assert_close(y[kept], x[kept] / (1 - p), rtol=0, atol=0)
    assert abs(kept.float().mean().item() - (1 - p)) < 0.02
    assert dropout(x, p, False, None) is x
    with pytest.raises(ValueError, match="Generator"):
        dropout(x, p, True, None)
