"""pix2pose_torch ResNet-50 trunk, the ResNet-50 (BOP'20) generator and
the detector on the ResNet-50 trunk against flax on the same seeded
variables and inputs.

The seeded variables carry BatchNorm statistics measured on the test's
own input (:func:`calibrate_batch_stats`), as a trained network's do:
with arbitrary statistics the residual sums grow to ~50 by stage 3 and
fp32 rounding alone reaches 2e-4 there. Tolerances: the trunk's three
taps within rtol = atol = 1e-4 (fp32 convolutions summed in different
orders by XLA and PyTorch); the generator's tanh / sigmoid outputs
within 1e-4 absolute, the paper AE's bar (``tests/test_torch_ae.py``)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from pix2pose_tpu.models import detector as jdet
from pix2pose_tpu.models import resnet50 as jres
from pix2pose_tpu.models.ae import build_generator as build_flax
from pix2pose_torch.models import (CenterNetDetector, ResNet50Trunk,
                                   build_generator)
from pix2pose_torch.models.resnet50 import s2d_stem_kernel, space_to_depth
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          random_flax_variables)

torch.set_num_threads(1)


def seeded_flax_variables(model, x, seed: int = 0):
    """Variables in the flax tree's own structure (``eval_shape`` of its
    init) with seeded He-normal kernels and non-trivial biases and
    BatchNorm statistics (numpy leaves)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            a = rng.normal(0, np.sqrt(2.0 / fan_in), leaf.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:                                   # bias, scale, mean
            a = (name == "scale") + rng.normal(0, 0.1, leaf.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def calibrate_batch_stats(model, x, variables):
    """Replace every BatchNorm mean / var in the flax ``variables`` with
    the statistics of the port ``model``'s activations on ``x`` (NHWC
    numpy; one train-mode pass, each layer normalized by the statistics
    before it, so they hold in eval mode). Returns ``variables``."""
    model.load_state_dict(flax_to_state_dict(variables), strict=True)
    bns = {n: m for n, m in model.named_modules()
           if isinstance(m, torch.nn.BatchNorm2d)}
    for m in bns.values():
        m.reset_running_stats()
        m.momentum = None                      # cumulative: one batch
    model.train()
    with torch.no_grad():
        model(torch.from_numpy(x))
    model.eval()
    for name, m in bns.items():
        node = variables["batch_stats"]
        for k in name.split("."):
            node = node[k]
        node["mean"] = m.running_mean.numpy().copy()
        node["var"] = m.running_var.numpy().copy()
    return variables


class _NHWC(torch.nn.Module):
    """A trunk that takes NHWC, for :func:`calibrate_batch_stats`."""

    def __init__(self, trunk):
        super().__init__()
        self.trunk = trunk

    def forward(self, x):
        return self.trunk(x.permute(0, 3, 1, 2))


def assert_same_tree(a, b):
    """Same flax tree structure and leaf shapes."""
    assert jax.tree_util.tree_structure(a) == jax.tree_util.tree_structure(b)
    for x, y in zip(jax.tree_util.tree_leaves(a),
                    jax.tree_util.tree_leaves(b)):
        assert np.shape(x) == np.shape(y)


@pytest.mark.parametrize("stem_s2d", [False, True], ids=["classic", "s2d"])
def test_trunk_taps_match_flax(stem_s2d):
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32)
    fmodel = jres.ResNet50Trunk(stem_s2d=stem_s2d)
    model = ResNet50Trunk(stem_s2d=stem_s2d).eval()
    v = seeded_flax_variables(fmodel, x, seed=2)
    v = {"params": v["params"], "batch_stats": calibrate_batch_stats(
        _NHWC(model), x, {"batch_stats": {"trunk": v["batch_stats"]},
                          "params": {"trunk": v["params"]}})
        ["batch_stats"]["trunk"]}
    refs = fmodel.apply(v, jnp.asarray(x))
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    assert_same_tree(random_flax_variables(model, 0), v)
    with torch.no_grad():
        taps = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    for got, ref, shape in zip(taps, refs, ((32, 32, 64), (16, 16, 256),
                                            (8, 8, 512))):
        got = got.permute(0, 2, 3, 1).numpy()
        assert got.shape == (2, *shape)
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-4,
                                   atol=1e-4)


def test_s2d_stem_equals_classic_stem():
    """``space_to_depth`` and ``s2d_stem_kernel`` equal the JAX package's,
    and the s2d stem with a remapped 7x7 kernel equals the classic
    stem's tap f1 in the port."""
    rng = np.random.default_rng(3)
    x = rng.uniform(-1, 1, (1, 32, 48, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        space_to_depth(torch.from_numpy(x).permute(0, 3, 1, 2))
        .permute(0, 2, 3, 1).numpy(),
        np.asarray(jres.space_to_depth(jnp.asarray(x))))
    k7 = rng.normal(0, 0.1, (7, 7, 3, 64)).astype(np.float32)
    np.testing.assert_array_equal(s2d_stem_kernel(k7),
                                  np.asarray(jres.s2d_stem_kernel(k7)))
    classic, s2d = (ResNet50Trunk(stem_s2d=s).eval() for s in (False, True))
    with torch.no_grad():
        classic.stem_conv.weight.copy_(
            torch.from_numpy(k7.transpose(3, 2, 0, 1)))
        s2d.stem_conv.weight.copy_(
            torch.from_numpy(s2d_stem_kernel(k7).transpose(3, 2, 0, 1)))
        s2d.stem_conv.bias.copy_(classic.stem_conv.bias)
        xt = torch.from_numpy(x).permute(0, 3, 1, 2)
        f1_c = classic.stem_conv(xt)
        f1_s = s2d.stem_conv(torch.nn.functional.pad(space_to_depth(xt),
                                                     (2, 1, 2, 1)))
    assert f1_c.shape == f1_s.shape == (1, 64, 16, 24)
    np.testing.assert_allclose(f1_s.numpy(), f1_c.numpy(), atol=1e-5)


def test_resnet50_generator_matches_flax():
    rng = np.random.default_rng(4)
    x = rng.uniform(-1, 1, (2, 128, 128, 3)).astype(np.float32)
    fmodel = build_flax("resnet50")
    model = build_generator("resnet50")
    v = calibrate_batch_stats(model, x, seeded_flax_variables(fmodel, x,
                                                              seed=5))
    xyz_ref, prob_ref = fmodel.apply(v, jnp.asarray(x))
    res = model.load_state_dict(flax_to_state_dict(v), strict=True)
    assert not res.missing_keys and not res.unexpected_keys
    assert_same_tree(random_flax_variables(model, 0), v)
    with torch.no_grad():
        xyz, prob = model(torch.from_numpy(x))
    assert xyz.shape == (2, 128, 128, 3) and prob.shape == (2, 128, 128, 1)
    np.testing.assert_allclose(xyz.numpy(), np.asarray(xyz_ref), atol=1e-4)
    np.testing.assert_allclose(prob.numpy(), np.asarray(prob_ref), atol=1e-4)


def test_resnet50_detector_matches_flax():
    """The detector on the ResNet-50 trunk with its defaults (s2d stem,
    fused heads) at head_dim 16, all six outputs within 1e-4; and the
    serving CLI's detector (head_dim 128) has the flax tree's structure."""
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
    fmodel = jdet.CenterNetDetector(num_classes=2, head_dim=16)
    model = CenterNetDetector(num_classes=2, head_dim=16).eval()
    v = calibrate_batch_stats(model, x, seeded_flax_variables(fmodel, x, 7))
    ref = fmodel.apply(v, jnp.asarray(x))
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    with torch.no_grad():
        out = model(torch.from_numpy(x))
    for name in jdet.DetectorOut._fields:
        got, want = getattr(out, name).numpy(), np.asarray(getattr(ref, name))
        assert got.shape == want.shape == (1, 16, 16, want.shape[-1]), name
        np.testing.assert_allclose(got, want, atol=1e-4, err_msg=name)
    full = jax.eval_shape(jdet.CenterNetDetector(num_classes=4).init,
                          jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)))
    assert_same_tree(random_flax_variables(CenterNetDetector(4), 0), full)
