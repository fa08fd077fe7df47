"""pix2pose_torch ``parallel/mesh.py`` on the CPU: the helpers in one
process, then one spawn of two gloo processes (``tests/
torch_parallel_worker.py``, a file rendezvous under the test's temporary
directory) that runs the data-parallel GAN step, the object-parallel step
and sharded inference on inputs written here with numpy.

Tolerances: the two-rank dp step at B=4 against the port's one-process
step on the full batch. With the networks in float64: losses within
1e-10 relative, the averaged gradients within 1e-9 of each tensor's norm
(+1e-12), parameters and BatchNorm running statistics within 1e-10, so
the sharded statistics, the gradient average and the updates are the
one-process step's; the same float64 bars hold the synced BatchNorm
path over a one-rank group on the full batch (the path a one-GPU dp
step does not take) to the plain step. In float32 the two sum the batch
in different orders and ``tests/test_torch_gan.py``'s float32 floor
applies: losses within
1e-5 relative, gradients within 1e-2 of their norm (LeakyReLU inputs
within rounding of 0 take the other branch; 4.5e-3 measured), running
statistics within 1e-6, parameters within 2 lr per Adam update
everywhere and within 1e-6 on 99.8% of each network's elements (Adam's
first update is +-lr wherever the gradient stands above eps, so an
element whose gradient lies at rounding noise takes the other sign:
0.106% of the generator's here; the biases in front of a train-mode
BatchNorm, whose gradient is noise, are held to 2 lr only). Against the
JAX ``make_train_step`` on the same batch, ``tests/test_torch_gan.py``'s
bars.
Object-parallel and sharded inference run the same operations on the
same shapes as their one-process counterparts: equal bit for bit.
"""

import os
import re
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pix2pose_tpu.config import TrainConfig as JaxTrainConfig
from pix2pose_tpu.models import AutoEncoder as JaxAutoEncoder
from pix2pose_tpu.models import Discriminator as JaxDiscriminator
from pix2pose_tpu.parallel import mesh as jmesh
from pix2pose_tpu.training import gan as jgan
from pix2pose_torch.config import EstimatorConfig, TrainConfig
from pix2pose_torch.inference.engine import Pix2PoseEstimator
from pix2pose_torch.models import AutoEncoder, Discriminator
from pix2pose_torch.parallel import mesh as tmesh
from pix2pose_torch.training.gan import create_train_state, make_train_step
from pix2pose_torch.training.multi import ObjectRun, make_multi_step
from pix2pose_torch.utils import synthetic as tsyn
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          state_dict_to_flax)
from test_torch_gan import (BIAS_BEFORE_BN, STEP_LR, Z4, _jax_label_draws,
                            flat, seeded_variables, torch_tree)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# BIAS_BEFORE_BN in the port's state-dict names
TORCH_BIAS_BEFORE_BN = re.compile(r"(^|\.)(conv\d*|deconv)\.bias$")


def _batch(rng, bsz):
    src = rng.uniform(-1, 1, (bsz, 128, 128, 3)).astype(np.float32)
    return {"src": src, "tgt": np.tanh(src * 0.5 + 0.2).astype(np.float32),
            "prob_gt": (rng.uniform(0, 1, (bsz, 128, 128, 1)) > 0.3)
            .astype(np.float32)}


def _labels(seed, bsz):
    return {k: np.asarray(v) for k, v in _jax_label_draws(
        jax.random.PRNGKey(seed), bsz, JaxTrainConfig().label_flipping)
        .items()}


def _state(gv, dv, bsz, dtype=torch.float32):
    gen, disc = AutoEncoder(), Discriminator()
    gen.load_state_dict(flax_to_state_dict(gv), strict=True)
    disc.load_state_dict(flax_to_state_dict(dv), strict=True)
    return create_train_state(gen.to(dtype), disc.to(dtype),
                              TrainConfig(batch_size=bsz))


def _torch(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


def _estimator_inputs():
    rgbs, boxes = [], []
    for i in range(2):
        R, t = tsyn.pose_with_euler(yaw=0.3 + 0.4 * i, tx=10.0 * i)
        rgb, _, hit = tsyn.xyz_scene(R, t)
        vs, us = np.nonzero(hit)
        rgbs.append(rgb)
        boxes.append([[vs.min(), us.min(), vs.max() + 1, us.max() + 1]])
    return {"rgbs": np.stack(rgbs), "bboxes": np.asarray(boxes, np.int32),
            "det_valid": np.ones((2, 1), bool),
            "cam_ks": np.stack([tsyn.CAM_K] * 2).astype(np.float32),
            "obj_param": np.array([40, 40, 40, 0, 0, 0], np.float32)}


@pytest.fixture(scope="module")
def spawned(tmp_path_factory):
    """Inputs, the two workers' outputs and the inputs' trees."""
    work = tmp_path_factory.mktemp("parallel")
    rng = np.random.default_rng(7)
    batch = _batch(rng, 4)
    gv = seeded_variables(JaxAutoEncoder(backbone="paper"), batch["src"], 11)
    dv = seeded_variables(JaxDiscriminator(), batch["src"], 21)
    arrays = {**batch, **_labels(3, 4), "pool": Z4[:1], "lr": STEP_LR,
              **{f"gen/{k}": v for k, v in flat(gv).items()},
              **{f"disc/{k}": v for k, v in flat(dv).items()},
              **_estimator_inputs()}
    objs = []
    for o in range(2):
        b = _batch(rng, 2)
        og = seeded_variables(JaxAutoEncoder(backbone="paper"), b["src"],
                              30 + o)
        od = seeded_variables(JaxDiscriminator(), b["src"], 40 + o)
        objs.append((og, od, b, _labels(50 + o, 2)))
        arrays.update({f"obj{o}/gen/{k}": v for k, v in flat(og).items()})
        arrays.update({f"obj{o}/disc/{k}": v for k, v in flat(od).items()})
        arrays.update({f"obj{o}.{k}": v for k, v in {**b, **objs[-1][3]}
                       .items()})
    np.savez(work / "inputs.npz", **arrays)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS", "XLA_FLAGS")}
    worker = os.path.join(REPO, "tests", "torch_parallel_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), "2", str(work / "rendezvous"),
         str(work), REPO], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, env=env, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("parallel workers timed out:\n" + "\n".join(outs))
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"rank {r} done" in out, out
    out = {name: dict(np.load(work / f"out_{name}.npz"))
           for name in ("dp", "dp64", "dp64_one", "obj0", "obj1",
                        "obj_metrics", "est")}
    shutil.rmtree(work)     # ~1 GB of weights, loaded above
    return arrays, (gv, dv, batch), objs, out


def test_helpers_in_one_process():
    """Without a process group: one rank, the whole batch its slice (as
    the JAX ``process_slice`` on one host), a (1, 1) mesh without groups,
    ``shard_batch`` / gather / ``replicate`` the identity; a mesh that
    does not factor the world raises."""
    assert tmesh.init_distributed() == (0, 1)
    assert tmesh.process_slice(8) == jmesh.process_slice(8) == slice(0, 8)
    mesh = tmesh.make_mesh(device="cpu")
    assert mesh.shape == (1, 1) and mesh.groups == {"obj": None, "dp": None}
    assert mesh.index == {"obj": 0, "dp": 0}
    x = {"a": torch.arange(6.0).reshape(3, 2), "flag": torch.tensor(True)}
    got = tmesh.shard_batch(mesh, x)
    assert torch.equal(got["a"], x["a"]) and bool(got["flag"])
    assert tmesh.host_local_to_global(mesh, got) is got
    assert tmesh.replicate(mesh, x) is x
    with pytest.raises(ValueError, match="mesh"):
        tmesh.make_mesh((2, 1), device="cpu")


def test_dp_step_matches_one_process_and_jax(spawned):
    arrays, (gv, dv, batch), _, out = spawned
    labels = _labels(3, 4)
    # the port's one-process step on the full batch, float64 then float32
    for dtype, name in ((torch.float64, "dp64"), (torch.float64, "dp64_one"),
                        (torch.float32, "dp")):
        dp = out[name]
        state = _state(gv, dv, 4, dtype)
        ref = make_train_step(TrainConfig(batch_size=4))(
            state, {**_torch(batch), "src": torch.from_numpy(
                batch["src"]).to(dtype)}, torch.from_numpy(Z4[:1]),
            STEP_LR, _torch(labels))
        tight = dtype == torch.float64
        for k, v in ref.items():
            assert float(dp[f"metric.{k}"]) == pytest.approx(
                float(v), rel=1e-10 if tight else 1e-5), (name, k)
        for net, updates in (("gen", 1), ("disc", 2)):
            model = getattr(state, net)
            for k, p in model.named_parameters():
                g = p.grad.numpy()
                if tight or not TORCH_BIAS_BEFORE_BN.search(k):
                    assert np.linalg.norm(dp[f"grad.{net}.{k}"] - g) <= (
                        1e-9 if tight else 1e-2) * np.linalg.norm(g) \
                        + 1e-12, (name, net, k)
            n_ok = n_all = 0
            for k, v in model.state_dict().items():
                v = v.numpy()
                d = np.abs(dp[f"{net}.{k}"] - v)
                if tight or "running" in k:
                    assert d.max() <= (1e-10 if tight else 1e-6), (name, k)
                    continue
                assert d.max() <= 2 * STEP_LR * updates + 4 * float(
                    np.spacing(np.abs(v).max())), (net, k, d.max())
                if not TORCH_BIAS_BEFORE_BN.search(k):
                    n_ok, n_all = n_ok + np.sum(d <= 1e-6), n_all + d.size
            assert tight or n_ok >= 0.998 * n_all, (net, n_ok / n_all)
    dp = out["dp"]
    # the JAX step on the same batch (one program over the global batch)
    jcfg = JaxTrainConfig(batch_size=4)
    fgen, fdisc = JaxAutoEncoder(backbone="paper"), JaxDiscriminator()
    gtx = jgan._make_tx(jcfg, gv["params"], False)
    dtx = jgan._make_tx(jcfg, dv["params"], False)
    jstate = jgan.GanTrainState(
        gen_params=gv["params"], gen_stats=gv["batch_stats"],
        disc_params=dv["params"], disc_stats=dv["batch_stats"],
        gen_opt=gtx.init(gv["params"]), disc_opt=dtx.init(dv["params"]),
        step=jnp.zeros((), jnp.int32))
    new, jm = jax.jit(jgan.make_train_step(fgen, fdisc, jcfg))(
        jstate, batch, jnp.asarray(Z4[:1]), STEP_LR, jax.random.PRNGKey(3))
    for k, v in jm.items():
        assert float(dp[f"metric.{k}"]) == pytest.approx(float(v),
                                                         rel=1e-5), k
    for net, fparams, fstats in (("gen", new.gen_params, new.gen_stats),
                                 ("disc", new.disc_params, new.disc_stats)):
        model = AutoEncoder() if net == "gen" else Discriminator()
        model.load_state_dict({k[len(net) + 1:]: torch.from_numpy(v)
                               for k, v in dp.items()
                               if k.startswith(net + ".")})
        got = torch_tree(dict(model.named_parameters()))
        n_ok = n_all = 0
        for k, r in flat(fparams).items():
            d = np.abs(got[k] - np.asarray(r))
            assert d.max() <= 2 * STEP_LR * (1 if net == "gen" else 2) \
                + 4 * np.spacing(np.abs(np.asarray(r)).max()), k
            if not BIAS_BEFORE_BN.search(k):
                n_ok, n_all = n_ok + np.sum(d <= 1e-6), n_all + d.size
        assert n_ok >= 0.999 * n_all, (net, n_ok / n_all)
        stats = flat(state_dict_to_flax(model.state_dict())["batch_stats"])
        for k, r in flat(fstats).items():
            np.testing.assert_allclose(stats[k], np.asarray(r), rtol=1e-5,
                                       atol=1e-6, err_msg=k)


def test_object_parallel_matches_multi_step(spawned):
    """2 ranks x 1 object each against the port's ``make_multi_step``
    with K=2 in one process, the same batches and label draws injected:
    every weight and both objects' metrics equal."""
    _, _, objs, out = spawned
    runs = [ObjectRun(obj_id=o + 1, state=_state(og, od, 2), store=None,
                      sym_pool=torch.from_numpy(Z4[:1]), full_rotation=True,
                      rng=torch.Generator())
            for o, (og, od, _, _) in enumerate(objs)]
    ref = make_multi_step(TrainConfig(batch_size=2))(
        runs, 0, STEP_LR, [_torch(b) for _, _, b, _ in objs],
        [_torch(lab) for _, _, _, lab in objs])
    for k, v in ref.items():
        np.testing.assert_array_equal(out["obj_metrics"][k], v.numpy(), k)
    for o, run in enumerate(runs):
        for net in ("gen", "disc"):
            for k, v in getattr(run.state, net).state_dict().items():
                np.testing.assert_array_equal(out[f"obj{o}"][f"{net}.{k}"],
                                              v.numpy(), f"obj{o} {k}")


def test_sharded_estimate_batch_matches_unsharded(spawned):
    """The image axis over 2 ranks, one RANSAC generator per image: the
    gathered poses, counts and masks equal the one-process call."""
    arrays, _, _, out = spawned
    est = Pix2PoseEstimator(tsyn.OracleGenerator(),
                            EstimatorConfig(outlier_th=(0.1, 0.2, 0.3),
                                            inlier_th=0.1), device="cpu")
    ref = est.estimate_batch(
        None, *(torch.from_numpy(arrays[k]) for k in
                ("rgbs", "bboxes", "det_valid", "cam_ks")),
        arrays["obj_param"],
        [torch.Generator().manual_seed(10 + i) for i in range(2)])
    got = out["est"]
    assert got["valid"].all()
    for k, v in (("R", ref.R), ("t", ref.t), ("valid", ref.valid),
                 ("frac", ref.frac_inlier), ("n_inl", ref.n_inliers),
                 ("mask", ref.mask_pnp)):
        np.testing.assert_array_equal(got[k], v.numpy(), k)
