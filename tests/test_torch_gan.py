"""pix2pose_torch GAN training step against the flax one on the CPU, in
float32: the discriminator, the losses and the BatchNorm repair, one full
GAN iteration from the same variables, batch and label draws, and the
ResNet-50 optimizer.

Tolerances (fp32 convolutions summed in different orders by XLA and
PyTorch): discriminator logits, BatchNorm statistics and losses within
1e-5 relative; updated parameters within 1e-6 absolute on at least 99.9%
of each network's elements and within 2 * lr per Adam update everywhere
(Adam's first update is about lr * sign(g): where |g| is at rounding
noise the sign may differ); gradients and both Adam moments within 1e-2
of each tensor's norm.

Two float32 effects set those last bars, and the lr of the compared step.
(1) A LeakyReLU whose input lies within rounding of 0 takes the other
branch in one package, and the generator's gradients then differ at
single elements by percents of their max, not 1e-4 (torch float32
against torch float64 on this graph shows the same jumps). (2) A bias in
front of a train-mode BatchNorm (every conv and deconv bias but the
heads') has a zero gradient in exact arithmetic, so its float32 gradient
is noise, which Adam turns into a move of +-lr; those biases are held to
2 * lr only. In the generator step the discriminator runs on its running
statistics, where those biases count: at the trainer's lr of 1e-3 their
noise moves the adversarial loss by ~5e-4 relative, so the step is
compared at lr = 5e-6.
"""

import re

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from pix2pose_tpu.config import TrainConfig as JaxTrainConfig
from pix2pose_tpu.models import AutoEncoder as JaxAutoEncoder
from pix2pose_tpu.models import Discriminator as JaxDiscriminator
from pix2pose_tpu.models import losses as jlosses
from pix2pose_tpu.training import gan as jgan
from pix2pose_torch.config import TrainConfig
from pix2pose_torch.models import AutoEncoder, Discriminator
from pix2pose_torch.models import losses as tlosses
from pix2pose_torch.training import gan as tgan
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          state_dict_to_flax)

torch.set_num_threads(1)

LR = 1e-3
STEP_LR = 5e-6
# biases that a train-mode BatchNorm follows: zero gradient in exact math
BIAS_BEFORE_BN = re.compile(r"(^|/)(conv\d*|deconv)/bias$")
# rotations about z by 0, 90, 180 and 270 degrees, exact
Z4 = np.array([[[1, 0, 0], [0, 1, 0], [0, 0, 1]],
               [[0, -1, 0], [1, 0, 0], [0, 0, 1]],
               [[-1, 0, 0], [0, -1, 0], [0, 0, 1]],
               [[0, 1, 0], [-1, 0, 0], [0, 0, 1]]], np.float32)


def seeded_variables(model, x, seed):
    """Flax variables of ``model`` (``eval_shape`` of its init) filled
    from a seed: LeCun-normal kernels, small biases, BatchNorm scale near
    1, mean near 0, var in [0.5, 1.5] (numpy leaves)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            a = rng.normal(0, np.sqrt(1.0 / fan_in), leaf.shape)
        elif name == "var":
            a = rng.uniform(0.5, 1.5, leaf.shape)
        else:                                   # bias, scale, mean
            a = (name == "scale") + rng.normal(0, 0.05, leaf.shape)
        return np.asarray(a, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flat(tree):
    """{"/"-joined path: numpy leaf}."""
    return {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def torch_tree(values):
    """{param name: tensor} of a port module -> flat flax-layout leaves."""
    return flat(state_dict_to_flax(values)["params"])


def test_discriminator_losses_and_batchnorm_match_flax():
    check_batchnorm_subclass()
    rng = np.random.default_rng(0)
    # B=8: with 2 samples the 1x1 last block's batch norm divides their
    # difference by itself, and fp32 rounding reaches 1e-4 of the logits
    x = rng.uniform(-1, 1, (8, 128, 128, 3)).astype(np.float32)
    fd = JaxDiscriminator()
    v = seeded_variables(fd, x, 1)
    disc = Discriminator()
    disc.load_state_dict(flax_to_state_dict(v), strict=True)
    # eval mode: running statistics
    with torch.no_grad():
        got = disc.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(fd.apply(v, x)), rtol=1e-5,
                               atol=1e-5)
    # train mode: batch statistics, and the running update flax makes
    # (the biased batch variance; on the 1x1 last block torch's unbiased
    # one would differ by a factor B / (B - 1))
    ref, new = fd.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = disc.train()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5, atol=1e-5)
    stats = flat(state_dict_to_flax(disc.state_dict())["batch_stats"])
    for k, r in flat(new["batch_stats"]).items():
        np.testing.assert_allclose(stats[k], r, rtol=1e-5, atol=1e-7,
                                   err_msg=k)

    # transformer loss: an exact tie between pool members 0 and 2 whose
    # per-pixel errors differ (the first wins, as jnp.argmin), S=1, and a
    # random S=4 batch
    pred = np.zeros((1, 2, 2, 3), np.float32)
    gt = np.zeros((1, 2, 2, 3), np.float32)
    pred[0, 0, 0], gt[0, 0, 0] = (1, 0, 0), (1, 0, 0)
    pred[0, 0, 1], gt[0, 0, 1] = (-1, 0, 0), (1, 0, 0)
    prob = np.full((1, 2, 2, 1), 0.3, np.float32)
    vis = np.zeros((1, 2, 2, 1), np.float32)
    vis[0, 0, 0] = 1.0
    cases = [(pred, gt, prob, vis, Z4), (pred, gt, prob, vis, Z4[:1])]
    for pool in (Z4, Z4[:1]):
        cases.append((rng.uniform(-1, 1, (3, 16, 16, 3)),
                      rng.uniform(-1, 1, (3, 16, 16, 3)),
                      rng.uniform(0, 1, (3, 16, 16, 1)),
                      (rng.uniform(0, 1, (3, 16, 16, 1)) > 0.5), pool))
    for k, case in enumerate(cases):
        case = [np.asarray(a, np.float32) for a in case]
        ref = np.asarray(jlosses.transformer_loss(*case))
        got = tlosses.transformer_loss(
            *[torch.from_numpy(a) for a in case]).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                   err_msg=f"case {k}")
    # the tie's pick matters: with member 2 listed first, the loss differs
    tie = [torch.from_numpy(np.asarray(a, np.float32)) for a in cases[0][:4]]
    first = tlosses.transformer_loss(*tie, torch.from_numpy(Z4))
    swapped = tlosses.transformer_loss(*tie, torch.from_numpy(Z4[[2, 0]]))
    assert abs(float(first[0]) - float(swapped[0])) > 0.1

    logits = rng.normal(0, 3, (7, 1)).astype(np.float32)
    labels = rng.uniform(0, 1, 7).astype(np.float32)
    for lab in (labels, 1.0):
        np.testing.assert_allclose(
            tlosses.bce_logits(torch.from_numpy(logits),
                               torch.as_tensor(lab)).numpy(),
            np.asarray(jlosses.bce_logits(logits, lab)), rtol=1e-5)


def _jax_label_draws(key, bsz, p):
    """The label draws of the JAX step's key, by its own splits."""
    kf, kr, ks1, ks2 = jax.random.split(key, 4)
    return {"y_fake": jax.random.uniform(ks1, (bsz,), minval=0.0,
                                         maxval=0.1),
            "y_real": jax.random.uniform(ks2, (bsz,), minval=0.9,
                                         maxval=1.0),
            "flip_fake": jax.random.bernoulli(kf, p),
            "flip_real": jax.random.bernoulli(kr, p)}


@pytest.mark.parametrize("n_sym", [1, 4])
def test_gan_step_matches_flax(n_sym):
    """One GAN iteration of the paper generator at 128 px, B=2, from the
    same flax variables (carried across by flax_to_state_dict), batch,
    symmetry pool and label draws (with S=4 the fakes' labels flip)."""
    bsz = 2
    rng = np.random.default_rng(n_sym)
    src = rng.uniform(-1, 1, (bsz, 128, 128, 3)).astype(np.float32)
    tgt = np.tanh(src * 0.5 + 0.2).astype(np.float32)
    prob_gt = (rng.uniform(0, 1, (bsz, 128, 128, 1)) > 0.3).astype(
        np.float32)
    pool = Z4[:n_sym]
    batch = {"src": src, "tgt": tgt, "prob_gt": prob_gt}
    jcfg = JaxTrainConfig(batch_size=bsz)
    fgen, fdisc = JaxAutoEncoder(backbone="paper"), JaxDiscriminator()
    gv = seeded_variables(fgen, src, 10 + n_sym)
    dv = seeded_variables(fdisc, src, 20 + n_sym)
    gtx = jgan._make_tx(jcfg, gv["params"], False)
    dtx = jgan._make_tx(jcfg, dv["params"], False)
    state = jgan.GanTrainState(
        gen_params=gv["params"], gen_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_stats=dv["batch_stats"],
        gen_opt=gtx.init(gv["params"]), disc_opt=dtx.init(dv["params"]),
        step=jnp.zeros((), jnp.int32))
    # a key whose fake labels flip for S=4 and do not for S=1
    key = next(k for k in map(jax.random.PRNGKey, range(100))
               if bool(_jax_label_draws(k, bsz, jcfg.label_flipping)[
                   "flip_fake"]) == (n_sym == 4))
    new, jm = jax.jit(jgan.make_train_step(fgen, fdisc, jcfg))(
        state, batch, jnp.asarray(pool), STEP_LR, key)
    jm = {k: float(v) for k, v in jm.items()}
    new = jax.tree_util.tree_map(np.asarray, new)
    labels = {k: torch.from_numpy(np.array(v)) for k, v in
              _jax_label_draws(key, bsz, jcfg.label_flipping).items()}

    gen, disc = AutoEncoder(), Discriminator()
    gen.load_state_dict(flax_to_state_dict(gv), strict=True)
    disc.load_state_dict(flax_to_state_dict(dv), strict=True)
    cfg = TrainConfig(batch_size=bsz)
    ts = tgan.create_train_state(gen, disc, cfg)
    tm = tgan.make_train_step(cfg)(
        ts, {k: torch.from_numpy(v) for k, v in batch.items()},
        torch.from_numpy(pool), STEP_LR, labels)
    assert ts.step == 1
    for k, ref in jm.items():
        assert float(tm[k]) == pytest.approx(ref, rel=1e-5), k

    for net, opt, fparams, fstats, fopt in (
            (gen, ts.gen_opt, new.gen_params, new.gen_stats, new.gen_opt),
            (disc, ts.disc_opt, new.disc_params, new.disc_stats,
             new.disc_opt)):
        params = dict(net.named_parameters())
        got_p = torch_tree(params)
        noise = {k for k in got_p if BIAS_BEFORE_BN.search(k)}
        assert len(noise) == (14 if net is gen else 7)
        n_ok = n_all = 0
        for k, ref in flat(fparams).items():
            d = np.abs(got_p[k] - ref)
            # 2 * lr per Adam update (the discriminator takes two), and
            # the rounding of the parameters (an ulp is 1.2e-7 at 1.0)
            assert d.max() <= 2 * STEP_LR * (1 if net is gen else 2) + 4 * \
                np.spacing(np.abs(ref).max()), k
            if k not in noise:
                n_ok, n_all = n_ok + np.sum(d <= 1e-6), n_all + d.size
        assert n_ok >= 0.999 * n_all, n_ok / n_all
        stats = flat(state_dict_to_flax(net.state_dict())["batch_stats"])
        for k, ref in flat(fstats).items():
            np.testing.assert_allclose(stats[k], ref, rtol=1e-5, atol=1e-6,
                                       err_msg=k)
        adam = fopt[0]
        for slot, ref_tree in (("exp_avg", adam.mu), ("exp_avg_sq",
                                                      adam.nu)):
            got = torch_tree({n: opt.state[p][slot]
                              for n, p in params.items()})
            for k, ref in flat(ref_tree).items():
                if k not in noise:
                    assert_norm(got[k], ref, 1e-2, (slot, k))
    # the generator's gradients: after one step Adam's mu is (1 - b1) g
    grads = torch_tree({n: p.grad for n, p in gen.named_parameters()})
    for k, mu in flat(new.gen_opt[0].mu).items():
        if not BIAS_BEFORE_BN.search(k):
            assert_norm(grads[k], mu / (1 - jcfg.adam_b1), 1e-2, ("grad", k))


def assert_norm(got, ref, rtol, label):
    assert np.linalg.norm(got - ref) <= rtol * np.linalg.norm(ref), label


def test_resnet50_optimizer_matches_optax():
    """The decayed parameter group holds exactly the leaves that
    ``_resnet_decay_mask`` marks (every leaf under ``trunk``, BatchNorm
    scale and bias included), and one Adam step on random gradients
    equals the optax chain (coupled 2e-4 decay, then scale_by_adam)."""
    x = np.zeros((1, 128, 128, 3), np.float32)
    gv = seeded_variables(JaxAutoEncoder(backbone="resnet50"), x, 3)
    gen = AutoEncoder("resnet50")
    gen.load_state_dict(flax_to_state_dict(gv), strict=True)
    cfg = TrainConfig(backbone="resnet50")
    ts = tgan.create_train_state(gen, Discriminator(), cfg)
    names = {id(p): n for n, p in gen.named_parameters()}
    decayed = [g for g in ts.gen_opt.param_groups if g["weight_decay"]]
    assert len(decayed) == 1 and decayed[0]["weight_decay"] == 2e-4
    got = set(torch_tree({names[id(p)]: p
                               for p in decayed[0]["params"]}))
    mask = flat(jgan._resnet_decay_mask(gv["params"]))
    assert got == {k for k, m in mask.items() if m}
    assert 0 < len(got) < len(mask)

    rng = np.random.default_rng(4)
    grads_t = {n: torch.from_numpy(rng.normal(
        0, 1e-2, p.shape).astype(np.float32))
        for n, p in gen.named_parameters()}
    for n, p in gen.named_parameters():
        p.grad = grads_t[n].clone()
    for group in ts.gen_opt.param_groups:
        group["lr"] = LR
    ts.gen_opt.step()
    grads_f = state_dict_to_flax(grads_t)["params"]
    jcfg = JaxTrainConfig(backbone="resnet50")
    tx = jgan._make_tx(jcfg, gv["params"], True)
    upd, _ = tx.update(grads_f, tx.init(gv["params"]), gv["params"])
    ref = optax.apply_updates(gv["params"],
                              jax.tree_util.tree_map(lambda u: -LR * u, upd))
    got_p = torch_tree(dict(gen.named_parameters()))
    for k, r in flat(ref).items():
        np.testing.assert_allclose(got_p[k], r, rtol=0, atol=1e-6,
                                   err_msg=k)


def check_batchnorm_subclass():
    """The BatchNorm subclass normalizes as torch does in both modes and
    keeps its names (checkpoints load as before); only the running
    variance update differs: biased, not unbiased."""
    from pix2pose_torch.models.batchnorm import BatchNorm2d

    x = torch.from_numpy(np.random.default_rng(5).normal(
        1.0, 2.0, (3, 4, 2, 2)).astype(np.float32))
    ours, ref = BatchNorm2d(4, eps=1e-3, momentum=0.01), \
        torch.nn.BatchNorm2d(4, eps=1e-3, momentum=0.01)
    with torch.no_grad():
        ref.weight.uniform_(0.5, 1.5)
        ref.running_var.uniform_(0.5, 1.5)
    ours.load_state_dict(ref.state_dict(), strict=True)
    assert list(ours.state_dict()) == list(ref.state_dict())
    with torch.no_grad():
        assert torch.equal(ours.eval()(x), ref.eval()(x))
        y, y_ref = ours.train()(x), ref.train()(x)
    torch.testing.assert_close(y, y_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ours.running_mean, ref.running_mean)
    n = x.numel() // 4
    var = x.var((0, 2, 3), unbiased=False)
    # both fold 1% of the batch variance in: ours n-, torch's (n-1)-divided
    torch.testing.assert_close(
        ref.running_var, ours.running_var + 0.01 * var * (n / (n - 1) - 1))
