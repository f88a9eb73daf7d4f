"""Port parity: the paper U-Net's forward pass against the reference, with
the reference's weights converted by ``params_from_jax``.

Tolerance rtol 1e-4 / atol 1e-5: both compute in f32, but the convolutions
sum in another order.  The narrow config keeps the paper's structure
(mults (1, 2, 4, 8), 2 res blocks, attention) so every stride-2 SAME pad and
the qkv split are exercised."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from _torch_parity import np_tree, set_torch_cpu, unet_params  # noqa: E402
from repro.configs.base import UNetConfig as JaxUNetConfig  # noqa: E402
from repro.models import unet as junet  # noqa: E402
from repro_torch.configs import UNetConfig  # noqa: E402
from repro_torch.models import unet as tunet  # noqa: E402

set_torch_cpu()

CONFIGS = {
    "reduced": {},
    "paper_narrow": dict(image_size=32, base_channels=16,
                         channel_mults=(1, 2, 4, 8), n_res_blocks=2,
                         attn_resolutions=(4,)),
}


def _configs(name, num_classes):
    port = UNetConfig()
    if name == "reduced":
        port = port.reduced()
    port = dataclasses.replace(port, num_classes=num_classes,
                               **CONFIGS[name])
    ref = JaxUNetConfig(**{f.name: getattr(port, f.name)
                           for f in dataclasses.fields(JaxUNetConfig)})
    return ref, port


def test_port_config_copies_reference_fields():
    assert [f.name for f in dataclasses.fields(UNetConfig)] == \
        [f.name for f in dataclasses.fields(JaxUNetConfig)]
    assert UNetConfig() == UNetConfig(**dataclasses.asdict(JaxUNetConfig()))
    assert dataclasses.asdict(UNetConfig().reduced()) == \
        dataclasses.asdict(JaxUNetConfig().reduced())


@pytest.mark.parametrize("num_classes", [0, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_unet_forward_matches_reference(name, num_classes):
    ref_cfg, port_cfg = _configs(name, num_classes)
    params = unet_params(ref_cfg, 7)
    model = tunet.UNet(port_cfg)
    model.load_state_dict(tunet.params_from_jax(params))
    model.eval()
    rng = np.random.default_rng(3)
    s = port_cfg.image_size
    x = rng.standard_normal((3, s, s, 1)).astype(np.float32)
    t = np.array([1, 37, 100], np.int32)
    ys = [None]
    if num_classes:
        ys.append(np.array([0, 3, 9], np.int32))     # 9 clips to the null row
    fwd = jax.jit(lambda p, x, t, y: junet.forward(p, x, t, ref_cfg, y))
    for y in ys:
        ref = np.asarray(fwd(params, jnp.asarray(x), jnp.asarray(t),
                             None if y is None else jnp.asarray(y)))
        with torch.no_grad():
            out = model(torch.from_numpy(x), torch.from_numpy(t),
                        None if y is None else torch.from_numpy(y))
        assert out.shape == (3, s, s, 1) and out.is_contiguous()
        np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{name} y={y}")


def test_params_from_jax_layouts():
    """HWIO → OIHW, (in, out) → (out, in), GroupNorm and label rows, and the
    stride-2 SAME pad (0 before, 1 after) on an even size."""
    ref_cfg, port_cfg = _configs("reduced", 4)
    params = np_tree(unet_params(ref_cfg, 1))
    sd = tunet.params_from_jax(params)
    w = params["downs"][0]["res"][0]["conv1"]["w"]             # HWIO
    np.testing.assert_array_equal(sd["downs.0.res.0.conv1.weight"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["time_mlp1.weight"].numpy(),
                                  params["time_mlp1"]["w"].T)
    np.testing.assert_array_equal(sd["norm_out.weight"].numpy(),
                                  params["norm_out"]["g_scale"])
    np.testing.assert_array_equal(sd["label_emb.weight"].numpy(),
                                  params["label_emb"])
    assert set(sd) == set(tunet.UNet(port_cfg).state_dict())
    conv = tunet.Conv(1, 1, 3, stride=2)
    with torch.no_grad():
        conv.weight.fill_(1.0)
        conv.bias.zero_()
        out = conv(torch.ones((1, 1, 4, 4)))
    # SAME on 4 → 2 with pads (0, 1): the top-left window sees 3x3 real taps,
    # the bottom-right one 2x2
    np.testing.assert_array_equal(out[0, 0].numpy(), [[9, 6], [6, 4]])
