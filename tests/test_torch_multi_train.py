"""pix2pose_torch multi-object GAN training (``training/multi.py``,
``train-multi``) on the CPU: one K=2 iteration against the JAX package's
vmapped ``make_multi_step``, against the port's own single-object steps,
the trainer's checkpoints and resume, the symmetry pool of a custom
``data_root`` and the CLI.

Tolerances against JAX are ``tests/test_torch_gan.py``'s float32 bars
(its docstring says why): losses within 1e-4 relative (here the vmapped
step's, as the JAX package's own test holds its vmapped step against its
plain one); every parameter within 2 * lr per Adam update and rounding,
and within 1e-6 on at least 99.9% of each network's elements, the biases
in front of a train-mode BatchNorm aside. Against the port's own
single-object steps: bit for bit.
"""

import inspect
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pix2pose_tpu.config import TrainConfig as JaxTrainConfig
from pix2pose_tpu.models import AutoEncoder as JaxAutoEncoder
from pix2pose_tpu.models import Discriminator as JaxDiscriminator
from pix2pose_tpu.training import data as jdata
from pix2pose_tpu.training import gan as jgan
from pix2pose_tpu.training import multi as jmulti
from pix2pose_torch.__main__ import main as cli
from pix2pose_torch.config import TrainConfig
from pix2pose_torch.data.bop import BopDataset
from pix2pose_torch.models import AutoEncoder, Discriminator
from pix2pose_torch.training import gan as tgan
from pix2pose_torch.training import multi as tmulti
from pix2pose_torch.training import train as ttrain
from pix2pose_torch.training.data import PatchStore, make_batch
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.convert import flax_to_state_dict
from test_torch_gan import (BIAS_BEFORE_BN, STEP_LR, Z4, _jax_label_draws,
                            flat, seeded_variables, torch_tree)
from test_torch_train_cli import Z180, write_pairs

torch.set_num_threads(1)
B = 2


def synth_arrays(rng, n, m):
    """A store's arrays (``tests/test_multi_train.py:synth_store``)."""
    rgb = rng.randint(0, 255, (n, 128, 128, 3), dtype=np.uint8)
    xyz = rng.randint(0, 255, (n, 128, 128, 3), dtype=np.uint8)
    mask = np.zeros((n, 128, 128), bool)
    mask[:, 32:96, 40:100] = True
    xyz[~mask] = 0
    backs = rng.randint(0, 255, (m, 256, 256, 3), dtype=np.uint8)
    return {"rgb": rgb, "xyz": xyz, "mask": mask,
            "extent": np.full((n,), 70.0, np.float32), "backs": backs}


def test_multi_step_matches_jax_make_multi_step():
    """K=2 objects with stores of 3 and 5 patches (JAX tile-pads the
    first and samples it below ``n_valid``), pools of 1 and 2 members
    (JAX pads the first with entry 0) and the second object rotation
    locked: the port's iteration, given JAX's per-object batches and
    label draws, against the vmapped JAX step from the same variables."""
    rng = np.random.RandomState(3)
    arrays = [synth_arrays(rng, 3, 2), synth_arrays(rng, 5, 4)]
    pools = [Z4[:1], Z4[[0, 2]]]
    full_rot = [True, False]
    jcfg = JaxTrainConfig(batch_size=B)
    fgen, fdisc = JaxAutoEncoder(backbone="paper"), JaxDiscriminator()
    x = np.zeros((B, 128, 128, 3), np.float32)
    variables = [(seeded_variables(fgen, x, 30 + k),
                  seeded_variables(fdisc, x, 40 + k)) for k in range(2)]

    states = []
    for gv, dv in variables:
        gtx = jgan._make_tx(jcfg, gv["params"], False)
        dtx = jgan._make_tx(jcfg, dv["params"], False)
        states.append(jgan.GanTrainState(
            gen_params=gv["params"], gen_stats=gv["batch_stats"],
            disc_params=dv["params"], disc_stats=dv["batch_stats"],
            gen_opt=gtx.init(gv["params"]), disc_opt=dtx.init(dv["params"]),
            step=jnp.zeros((), jnp.int32)))
    store, n_valid = jmulti.stack_stores(
        [jdata.PatchStore(**{k: jnp.asarray(v) for k, v in a.items()})
         for a in arrays])
    keys = jax.random.split(jax.random.PRNGKey(5), 2)
    args = (store, n_valid, jnp.asarray(full_rot),
            jmulti.stack_sym_pools(pools))
    new, jm = jmulti.make_multi_step(fgen, fdisc, jcfg)(
        jmulti.stack_states(states), *args, 0, STEP_LR, keys)
    jm = {k: np.asarray(v) for k, v in jm.items()}

    # the batches and label draws of that step, by its own splits
    def one(st, nv, fr, key):
        kb, _ = jax.random.split(key)
        return jdata._make_batch(st, kb, 0, B, full_rotation=fr, n_valid=nv)

    jb = jax.jit(jax.vmap(one))(*args[:3], keys)
    batches = [{k: torch.from_numpy(np.array(v[i])) for k, v in jb.items()}
               for i in range(2)]
    labels = [{k: torch.from_numpy(np.array(v)) for k, v in _jax_label_draws(
        jax.random.split(keys[i])[1], B, jcfg.label_flipping).items()}
        for i in range(2)]

    cfg = TrainConfig(batch_size=B)
    runs = []
    for k, (gv, dv) in enumerate(variables):
        gen, disc = AutoEncoder(), Discriminator()
        gen.load_state_dict(flax_to_state_dict(gv), strict=True)
        disc.load_state_dict(flax_to_state_dict(dv), strict=True)
        store_k = PatchStore(**{n: torch.from_numpy(a)
                                for n, a in arrays[k].items()})
        runs.append(tmulti.ObjectRun(
            k + 1, tgan.create_train_state(gen, disc, cfg), store_k,
            torch.from_numpy(pools[k]), full_rot[k], torch.Generator()))
    tm = tmulti.make_multi_step(cfg)(runs, 0, STEP_LR, batches=batches,
                                     labels=labels)
    for name, ref in jm.items():
        assert tm[name].shape == (2,)
        np.testing.assert_allclose(tm[name].numpy(), ref, rtol=1e-4,
                                   err_msg=name)

    for k, run in enumerate(runs):
        st = jmulti.unstack_state(new, k)
        for net, updates, ref_params in ((run.state.gen, 1, st.gen_params),
                                         (run.state.disc, 2,
                                          st.disc_params)):
            got = torch_tree(dict(net.named_parameters()))
            n_ok = n_all = 0
            for name, ref in flat(ref_params).items():
                d = np.abs(got[name] - ref)
                assert d.max() <= 2 * STEP_LR * updates + 4 * np.spacing(
                    np.abs(ref).max()), (k, name)
                if not BIAS_BEFORE_BN.search(name):
                    n_ok, n_all = n_ok + np.sum(d <= 1e-6), n_all + d.size
            assert n_ok >= 0.999 * n_all, (k, n_ok / n_all)


def _runs(cfg, seed):
    rng = np.random.RandomState(seed)
    out = []
    for k, (n, pool, full_rot) in enumerate(((3, Z4[:1], True),
                                             (5, Z4[[0, 2]], False))):
        store = PatchStore(**{name: torch.from_numpy(a) for name, a in
                              synth_arrays(rng, n, 2).items()})
        out.append(tmulti.new_object_run(k + 1, store, pool, full_rot, cfg,
                                         100 + k, "cpu"))
    return out


def test_multi_step_equals_single_object_steps_bit_for_bit():
    """Two iterations (a stage-2 and a stage-1 batch) of the K=2 step
    against each object's ``train`` loop body on its own copy: the same
    metrics, parameters, statistics and Adam moments, bit for bit; and
    the two objects' generators differ."""
    cfg = TrainConfig(batch_size=B)
    fused, singles = _runs(cfg, 0), _runs(cfg, 0)
    step_fn = tmulti.make_multi_step(cfg)
    got = [step_fn(fused, it, 1e-3) for it in range(2)]
    raw = tgan.make_train_step(cfg)
    for k, run in enumerate(singles):
        for it in range(2):
            batch = make_batch(run.store, run.rng, it, B,
                               full_rotation=run.full_rotation)
            labels = tgan.draw_labels(run.rng, B, cfg.label_flipping)
            m = raw(run.state, batch, run.sym_pool, 1e-3, labels)
            for name, v in m.items():
                assert torch.equal(got[it][name][k], v), (k, it, name)
    for a, b in zip(fused, singles):
        assert a.state.step == b.state.step == 2
        for net_a, net_b, opt_a, opt_b in (
                (a.state.gen, b.state.gen, a.state.gen_opt, b.state.gen_opt),
                (a.state.disc, b.state.disc, a.state.disc_opt,
                 b.state.disc_opt)):
            sa, sb = net_a.state_dict(), net_b.state_dict()
            assert all(torch.equal(sa[n], sb[n]) for n in sa)
            for pa, pb in zip(net_a.parameters(), net_b.parameters()):
                for slot in ("exp_avg", "exp_avg_sq"):
                    assert torch.equal(opt_a.state[pa][slot],
                                       opt_b.state[pb][slot])
    w0, w1 = (next(r.state.gen.parameters()) for r in fused)
    assert not torch.equal(w0, w1)


@pytest.fixture
def two_objects(tmp_path):
    """A dataset with objects 1 (2-fold symmetric; its probe kept only
    the identity) and 2 (rotation locked), pairs for both, backgrounds
    and a config."""
    ds = tmp_path / "tiny"
    os.makedirs(ds / "models")
    with open(ds / "models" / "models_info.json", "w") as f:
        json.dump({"1": {"diameter": 100.0, "symmetries_discrete": [Z180]},
                   "2": {"diameter": 80.0}}, f)
    write_pairs(ds / "train_xyz" / "01", 6, 0,
                {"rotation_lock": False, "visual_sym_idx": [0]})
    write_pairs(ds / "train_xyz" / "02", 4, 1, {"rotation_lock": True})
    backs = tmp_path / "backs"
    os.makedirs(backs)
    rng = np.random.RandomState(1)
    Image.fromarray(rng.randint(0, 255, (100, 140, 3)).astype(
        np.uint8)).save(backs / "b0.png")
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"dataset_dir": str(tmp_path), "backbone": "paper"}, f)
    return tmp_path, str(backs), cfg


def test_train_objects_checkpoints_and_resume(two_objects, capsys):
    """Per-object train states, montages and exports in ``train``'s
    layout; ``train`` resumes object 1 from the fused run; the fused
    trainer then resumes both from the smaller epoch, with the warning."""
    root, backs, _ = two_objects
    ds = BopDataset(str(root), "tiny", train=True)
    wroot = root / "tiny" / "pix2pose_weights"

    def cfg(epochs):
        return TrainConfig(batch_size=B, max_epoch=epochs,
                           max_batches_per_epoch=1)

    runs = tmulti.train_objects(ds, [1, 2], backs, cfg(1), device="cpu")
    assert [r.state.step for r in runs] == [1, 1]
    assert [r.full_rotation for r in runs] == [True, False]
    for o in (1, 2):
        wdir = wroot / f"{o:02d}"
        assert ckpt.latest_epoch(str(wdir)) == 1
        assert (wdir / "val_img" / "epoch_01.png").exists()
        assert ckpt.load_inference_params(str(wdir)) is not None

    capsys.readouterr()
    state = ttrain.train_object(ds, 1, backs, cfg(2), device="cpu")
    assert "resumed from epoch 1" in capsys.readouterr().out
    assert state.step == 2 and ckpt.latest_epoch(str(wroot / "01")) == 2

    runs = tmulti.train_objects(ds, [1, 2], backs, cfg(3), device="cpu")
    out = capsys.readouterr().out
    assert "resume epochs differ per object ([2, 1])" in out
    assert "training all from min = 1" in out
    # both trained epochs 2 and 3 from their own checkpoints
    assert [r.state.step for r in runs] == [4, 3]
    assert [ckpt.latest_epoch(str(wroot / f"{o:02d}")) for o in (1, 2)] \
        == [3, 3]


def test_symmetry_pool_follows_a_custom_data_root(two_objects, monkeypatch):
    """The repair of ``pix2pose_tpu/training/multi.py:148``: with a custom
    ``data_root`` the JAX trainer still reads the pool's ``meta.json`` from
    the dataset's ``train_xyz`` (object 1: identity only, S=1); the port
    reads the custom data's (both members of the 2-fold pool, S=2)."""
    from pix2pose_tpu.data.bop import BopDataset as JaxBopDataset
    from pix2pose_tpu.utils import symmetry as jsym

    root, backs, _ = two_objects
    custom = root / "elsewhere"
    write_pairs(custom / "01", 4, 2, {"rotation_lock": False,
                                      "visual_sym_idx": [0, 1]})
    assert "training_sym_pool(dataset, obj_id)))" in inspect.getsource(
        jmulti.train_objects)

    class PoolSeen(Exception):
        """Stops a trainer once it has its first pool."""

    def recorder(real, pools):
        def record(*args, **kw):
            pools.append(np.asarray(real(*args, **kw)))
            raise PoolSeen
        return record

    jax_pools, port_pools = [], []
    monkeypatch.setattr(jsym, "training_sym_pool",
                        recorder(jsym.training_sym_pool, jax_pools))
    monkeypatch.setattr(tmulti, "training_sym_pool",
                        recorder(tmulti.training_sym_pool, port_pools))
    with pytest.raises(PoolSeen):
        jmulti.train_objects(JaxBopDataset(str(root), "tiny", train=True),
                             [1], backs, JaxTrainConfig(batch_size=B),
                             data_root=str(custom))
    with pytest.raises(PoolSeen):
        tmulti.train_objects(BopDataset(str(root), "tiny", train=True), [1],
                             backs, TrainConfig(batch_size=B),
                             data_root=str(custom), device="cpu")
    assert jax_pools[0].shape == (1, 3, 3)      # the JAX result
    assert port_pools[0].shape == (2, 3, 3)     # the custom data's pool
    np.testing.assert_array_equal(port_pools[0][0], np.eye(3))


def test_train_multi_cli_refuses_without_cuda_and_runs_on_cpu(
        two_objects, monkeypatch):
    root, backs, cfg = two_objects
    args = ["train-multi", cfg, "tiny", "1,2", backs, "--max-steps", "1",
            "--batch", "2", "--epochs", "1"]
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli(args)
    assert not (root / "tiny" / "pix2pose_weights").exists()
    runs = cli(args + ["--device", "cpu"])
    assert [r.obj_id for r in runs] == [1, 2]
    assert [r.state.step for r in runs] == [1, 1]
    for o in (1, 2):
        variables = ckpt.load_inference_params(
            str(root / "tiny" / "pix2pose_weights" / f"{o:02d}"))
        AutoEncoder().load_state_dict(flax_to_state_dict(variables),
                                      strict=True)
