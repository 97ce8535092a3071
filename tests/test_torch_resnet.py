"""Port parity: ops/resnet.py against the JAX package's ResNet-101 backbone.

The same seeded numpy inputs go through JAX ``ResNetV1`` and the port's,
the weights bridged through ``utils/convert.py`` (conv kernels HWIO ->
OIHW, BatchNorm statistics as buffers). The tiny backbone has stages
(1, 1, 1, 1), width 8, 64-pixel images and nonzero random BatchNorm
statistics, scales and biases. Tolerances:

- float32: 1e-4 of the largest |value| of the grid / pool5. Both sides
  sum the convolutions' f32 products in their own order (XLA on the CPU,
  oneDNN); measured 1.2e-6 at most.
- bfloat16: 2^-6 of the largest |grid|. Every layer rounds its output to
  bf16 (steps of 2^-8 of a value); where the two f32 sums differ in their
  last bits a value near a rounding boundary lands on the other neighbour,
  and the following convolutions carry such flips to the grid. Measured
  3.6e-3 with the 7x7 stem and 0 with the space-to-depth stem.
- ``preprocess_images``: 1/256 of one intensity step on the 0-255 scale.
  Both resize with an antialiased triangle filter in f32, JAX by a
  weight-matrix product, torch by a separable pass; measured 3.1e-5 (80 ->
  64), 6.1e-5 (100x70 -> 64), 1.8e-3 (640x480 -> 448), 0 when upsampling.
  Without antialiasing the difference is 57-88 steps.
- The stem rewrites and the weight conversion: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as tnn

from vqa_transfer_externaldata_tpu.ops import resnet as jr
from vqa_transfer_externaldata_torch.cli.common import load_resnet_backbone
from vqa_transfer_externaldata_torch.config import Config
from vqa_transfer_externaldata_torch.ops import resnet as tr
from vqa_transfer_externaldata_torch.utils.convert import (
    batch_stats_from_flax, batch_stats_to_flax, params_from_flax,
    params_to_flax)

torch.set_num_threads(2)  # xdist runs several workers on the same cores

TINY_STAGES, TINY_WIDTH, SIZE = (1, 1, 1, 1), 8, 64
TOL_F32 = 1e-4
TOL_BF16 = 2.0 ** -6
TOL_RESIZE = 1.0 / 256


def randomize_bn(tree, rng):
    """Nonzero BatchNorm statistics, scales and biases, in place."""
    draw = {"mean": lambda s: rng.normal(0, 0.5, s),
            "var": lambda s: rng.uniform(0.5, 1.5, s),
            "scale": lambda s: rng.uniform(0.5, 1.5, s),
            "bias": lambda s: rng.normal(0, 0.2, s)}
    for k, node in tree.items():
        if isinstance(node, dict):
            randomize_bn(node, rng)
        elif k in draw:
            tree[k] = draw[k](node.shape).astype(np.float32)
    return tree


def jax_backbone(stem, dtype, seed=0):
    """(JAX model, its variables with random BN, preprocessed images)."""
    model = jr.ResNetV1(stage_sizes=TINY_STAGES, width=TINY_WIDTH,
                        dtype=dtype, stem=stem)
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (2, SIZE, SIZE, 3)).astype(np.uint8)
    x = jr.preprocess_images(jnp.asarray(images), SIZE)
    v = jax.tree_util.tree_map(np.asarray, jax.device_get(
        model.init(jax.random.PRNGKey(seed), x, train=False)))
    v = {"params": randomize_bn(v["params"], rng),
         "batch_stats": randomize_bn(v["batch_stats"], rng)}
    return model, v, np.asarray(x)


def bridged(variables):
    return {**params_from_flax(variables["params"]),
            **batch_stats_from_flax(variables["batch_stats"])}


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("stem", tr.STEMS)
def test_resnet_matches_jax_f32(stem):
    model, v, x = jax_backbone(stem, jnp.float32)
    want = model.apply(v, jnp.asarray(x), train=False)
    ours = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.float32,
                       stem=stem)
    ours.load_state_dict(bridged(v))
    with torch.no_grad():
        got = ours(torch.from_numpy(x.copy()))
    assert got["grid"].shape == (2, 2, 2, 256)
    assert got["grid"].dtype == got["pool5"].dtype == torch.float32
    for key in ("grid", "pool5"):
        assert rel(got[key].numpy(), want[key]) <= TOL_F32, key


@pytest.mark.parametrize("stem", ["conv", "space_to_depth"])
def test_resnet_matches_jax_bf16(stem):
    model, v, x = jax_backbone(stem, jnp.bfloat16)
    want = model.apply(v, jnp.asarray(x), train=False)
    ours = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.bfloat16,
                       stem=stem)
    ours.load_state_dict(bridged(v))
    with torch.no_grad():
        got = ours(torch.from_numpy(x.copy()))
    assert got["grid"].dtype == torch.bfloat16
    assert got["pool5"].dtype == torch.float32
    assert rel(got["grid"].float().numpy(), want["grid"]) <= TOL_BF16
    assert rel(got["pool5"].numpy(), want["pool5"]) <= TOL_BF16


def test_grid_is_a_view_of_channels_last_activations():
    """The grid [B, h, w, C] is the last stage's channels_last memory, so
    the [B, h*w, C] rows the attention kernel reads need no copy."""
    ours = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.float32,
                       generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        grid = ours(torch.zeros(2, SIZE, SIZE, 3))["grid"]
    assert grid.is_contiguous()
    flat = grid.reshape(2, -1, grid.shape[-1])
    assert flat.data_ptr() == grid.data_ptr() and flat.is_contiguous()


def test_batchnorm_ignores_train_mode():
    """The statistics are inference ones whatever nn.Module.train says."""
    bn = tr.BatchNorm(4, dtype=torch.float32)
    with torch.no_grad():
        bn.mean.copy_(torch.tensor([1.0, 2.0, 3.0, 4.0]))
    x = torch.randn(3, 4, 2, 2, generator=torch.Generator().manual_seed(0))
    a = bn.eval()(x)
    b = bn.train()(x)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    torch.testing.assert_close(bn.mean, torch.tensor([1.0, 2.0, 3.0, 4.0]))


@pytest.mark.parametrize("stem", tr.STEMS)
def test_batch_statistics_match_jax(stem):
    """``train=True`` (reached by no entry point, as in JAX): every
    BatchNorm normalizes with its batch's statistics and moves its buffers
    by momentum 0.9; the grid and the updated statistics against JAX's
    ``apply(..., train=True, mutable=["batch_stats"])``, float32."""
    model, v, x = jax_backbone(stem, jnp.float32)
    want, mutated = model.apply(v, jnp.asarray(x), train=True,
                                mutable=["batch_stats"])
    ours = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.float32,
                       stem=stem)
    ours.load_state_dict(bridged(v))
    with torch.no_grad():
        got = ours(torch.from_numpy(x.copy()), train=True)
    for key in ("grid", "pool5"):
        assert rel(got[key].numpy(), want[key]) <= TOL_F32, key
    stats = batch_stats_from_flax(jax.device_get(mutated["batch_stats"]))
    buffers = dict(ours.named_buffers())
    assert set(stats) == set(buffers)
    for k, want_k in stats.items():
        assert rel(buffers[k].numpy(), want_k.numpy()) <= TOL_F32, k


def test_stem_rewrites_and_space_to_depth_equal_jax():
    rng = np.random.default_rng(3)
    w7 = rng.normal(size=(7, 7, 3, 8)).astype(np.float32)
    np.testing.assert_array_equal(tr.conv1_to_space_to_depth(w7),
                                  jr.conv1_to_space_to_depth(w7))
    np.testing.assert_array_equal(tr.conv1_to_space_to_depth4(w7),
                                  jr.conv1_to_space_to_depth4(w7))
    x = rng.normal(size=(2, 8, 12, 3)).astype(np.float32)
    for block in (2, 4):
        np.testing.assert_array_equal(
            tr.space_to_depth(torch.from_numpy(x), block).numpy(),
            np.asarray(jr.space_to_depth(jnp.asarray(x), block)))


@pytest.mark.parametrize("shape,size", [
    ((2, 80, 80, 3), 64), ((2, 100, 70, 3), 64), ((1, 640, 480, 3), 448),
    ((2, 32, 32, 3), 64), ((2, 64, 64, 3), 64)])
def test_preprocess_images_matches_jax(shape, size):
    images = np.random.default_rng(5).integers(0, 256, shape).astype(
        np.uint8)
    want = np.asarray(jr.preprocess_images(jnp.asarray(images), size))
    got = tr.preprocess_images(torch.from_numpy(images), size).numpy()
    assert got.shape == want.shape == (shape[0], size, size, 3)
    assert got.dtype == np.float32
    assert np.abs(got - want).max() <= TOL_RESIZE


def tiny_torchvision_state_dict():
    """A torchvision-named resnet with stages (1, 1, 1, 1) and width 8
    (JAX ``tests/test_serving.py``'s), seeded, with random BN
    statistics."""

    class B(tnn.Module):
        def __init__(self, cin, width, stride):
            super().__init__()
            self.conv1 = tnn.Conv2d(cin, width, 1, bias=False)
            self.bn1 = tnn.BatchNorm2d(width)
            self.conv2 = tnn.Conv2d(width, width, 3, stride, 1, bias=False)
            self.bn2 = tnn.BatchNorm2d(width)
            self.conv3 = tnn.Conv2d(width, 4 * width, 1, bias=False)
            self.bn3 = tnn.BatchNorm2d(4 * width)
            self.downsample = tnn.Sequential(
                tnn.Conv2d(cin, 4 * width, 1, stride, bias=False),
                tnn.BatchNorm2d(4 * width))

    class Net(tnn.Module):
        def __init__(self):
            super().__init__()
            self.conv1 = tnn.Conv2d(3, 8, 7, 2, 3, bias=False)
            self.bn1 = tnn.BatchNorm2d(8)
            self.layer1 = tnn.Sequential(B(8, 8, 1))
            self.layer2 = tnn.Sequential(B(32, 16, 2))
            self.layer3 = tnn.Sequential(B(64, 32, 2))
            self.layer4 = tnn.Sequential(B(128, 64, 2))

    torch.manual_seed(7)
    net = Net()
    with torch.no_grad():
        for m in net.modules():
            if isinstance(m, tnn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5)
                m.running_var.uniform_(0.5, 1.5)
                m.weight.uniform_(0.5, 1.5)
                m.bias.normal_(0, 0.2)
    return net.state_dict()


@pytest.mark.parametrize("stem", tr.STEMS)
def test_convert_torch_state_dict_equals_jax(stem):
    sd = tiny_torchvision_state_dict()
    params, stats = jr.convert_torch_state_dict(
        {k: v.numpy() for k, v in sd.items()}, stage_sizes=TINY_STAGES,
        stem=stem)
    want = bridged({"params": params, "batch_stats": stats})
    got = tr.convert_torch_state_dict(sd, stage_sizes=TINY_STAGES, stem=stem)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    model = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.float32,
                        stem=stem)
    model.load_state_dict(got)  # every key, every shape


def test_torchvision_state_dict_inverts_the_conversion():
    sd = tiny_torchvision_state_dict()
    model = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.float32)
    model.load_state_dict(tr.convert_torch_state_dict(
        sd, stage_sizes=TINY_STAGES))
    back = tr.torchvision_state_dict(model)
    assert set(back) == set(sd)
    for k, v in sd.items():
        torch.testing.assert_close(back[k], v, rtol=0, atol=0, msg=k)
    with pytest.raises(ValueError, match="'conv' stem"):
        tr.torchvision_state_dict(tr.ResNetV1(
            TINY_STAGES, TINY_WIDTH, stem="space_to_depth"))


def test_space_to_depth_stems_are_exact_rewrites():
    """One converted checkpoint gives the same grid through each stem."""
    sd = tiny_torchvision_state_dict()
    x = tr.preprocess_images(torch.from_numpy(np.random.default_rng(1)
                                              .integers(0, 256, (2, SIZE, SIZE, 3))
                                              .astype(np.uint8)), SIZE)
    grids = {}
    for stem in tr.STEMS:
        model = tr.ResNetV1(TINY_STAGES, TINY_WIDTH, dtype=torch.float32,
                            stem=stem)
        model.load_state_dict(tr.convert_torch_state_dict(
            sd, stage_sizes=TINY_STAGES, stem=stem))
        with torch.no_grad():
            grids[stem] = model(x)["grid"].numpy()
    for stem in ("space_to_depth", "space_to_depth_4"):
        assert rel(grids[stem], grids["conv"]) <= TOL_F32, stem


def test_load_resnet_backbone_equals_jax(tmp_path):
    from vqa_transfer_externaldata_tpu.cli.common import (
        load_resnet_backbone as jax_load)
    from vqa_transfer_externaldata_tpu.config import Config as JaxConfig

    path = str(tmp_path / "resnet_tiny.pth")
    torch.save(tiny_torchvision_state_dict(), path)
    over = {"model.model": "vqa_end2end", "model.resnet_checkpoint": path,
            "model.resnet_stages": "1,1,1,1", "model.resnet_width": 8}
    params, stats = jax_load(JaxConfig().replace_flat(over))
    want = bridged({"params": params, "batch_stats": stats})
    got = load_resnet_backbone(Config().replace_flat(over))
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    assert load_resnet_backbone(Config()) is None
    with pytest.raises(ValueError, match="only applies"):
        load_resnet_backbone(Config().replace_flat(
            {"model.resnet_checkpoint": path}))
    with pytest.raises(ValueError, match="does not match"):
        load_resnet_backbone(Config().replace_flat(
            dict(over, **{"model.resnet_stages": "2,1,1,1"})))


def test_weight_bridge_round_trips_conv_and_batch_stats():
    model, v, _ = jax_backbone("space_to_depth", jnp.float32)
    sd = bridged(v)
    assert sd["layer2_0.conv1.weight"].shape == (16, 32, 1, 1)  # OIHW
    assert sd["layer2_0.conv2.weight"].shape == (16, 16, 3, 3)
    assert sd["conv1.weight"].shape == (8, 12, 4, 4)
    back_p, back_s = params_to_flax(sd), batch_stats_to_flax(sd)
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(t))
    for back, tree in ((back_p, v["params"]), (back_s, v["batch_stats"])):
        a, b = flat(back), flat(tree)
        assert set(a) == set(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_conv_macs_of_resnet101_at_448():
    """31 GMAC an image at 448² (torchvision counts 7.8 GMAC at 224²);
    the space-to-depth stem's conv is a 4x4x12 one at 224²."""
    with torch.device("meta"):
        model = tr.ResNetV1(dtype=torch.bfloat16, stem="space_to_depth")
        conv = tr.ResNetV1(dtype=torch.bfloat16, stem="conv")
    macs = tr.conv_macs(model, 448)
    stem = 224 * 224 * 64 * 12 * 16
    assert tr.conv_macs(conv, 448) == macs - stem + 224 * 224 * 64 * 3 * 49
    assert 30.5e9 < macs < 31.5e9, macs
