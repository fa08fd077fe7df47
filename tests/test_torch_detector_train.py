"""pix2pose_torch detector training against the JAX package on the CPU:
the losses, the BatchNorm repair, one CenterNet step from the same flax
variables and batch, the scene pool's ring, and the trainer's CLI.

Tolerances (float32 convolutions summed in different orders by XLA and
PyTorch): losses within 1e-5 relative, BatchNorm running statistics
within 1e-6; after one Adam step at lr 5e-6 every parameter within 2 lr
and at least 99.9% of each tensor group's elements within 1e-6, without
the biases in front of a train-mode BatchNorm (``*_conv`` of the tiny
trunk and ``fuse``), whose gradient is zero in exact arithmetic and
float32 noise here (``tests/test_torch_gan.py`` says why). The three
pooled steps train the same weights on the same pool windows at that lr:
their losses hold within 1e-5 relative at the first step and 1e-4 at
the next two, whose weights carry the first update's float32 noise (a
move of 2 lr on the elements whose gradient is at rounding level; the
offset loss over a few center cells measured 3.1e-5 apart).
"""

import functools
import json
import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from pix2pose_tpu.models import detector as jdet
from pix2pose_tpu.training import detector_data as jdd
from pix2pose_tpu.training import detector_train as jdt
from pix2pose_torch.inference.torch_detector import TorchDetector
from pix2pose_torch.models import detector as tdet
from pix2pose_torch.models.batchnorm import BatchNorm2d
from pix2pose_torch.training import detector_data as tdd
from pix2pose_torch.training import detector_train as tdt
from pix2pose_torch.utils import checkpoint as ckpt
from pix2pose_torch.utils.convert import (flax_to_state_dict,
                                          state_dict_to_flax)
from test_torch_detector_data import _St, _blob_patches, jax_draws
from test_torch_gan import flat, seeded_variables, torch_tree
from test_torch_train_cli import write_pairs

torch.set_num_threads(2)

STEP_LR = 5e-6
BIAS_BEFORE_BN = re.compile(r"(^|/)(b\d+b?_conv|fuse)/bias$")
TINY = dict(num_classes=2, trunk="tiny", head_dim=16)


@pytest.fixture(scope="module")
def stores():
    """A 2-class pool in both packages' ``DetectorStore``."""
    rng = np.random.RandomState(1)
    objs = {1: _St(*_blob_patches(rng, 3, (250, 90, 60))),
            2: _St(*_blob_patches(rng, 3, (60, 230, 120)))}
    backs = rng.randint(0, 80, (2, 256, 256, 3)).astype(np.uint8)
    jst = jdd.DetectorStore.from_patch_stores(
        {o: _St(*(jnp.asarray(a) for a in (s.rgb, s.mask, s.extent)))
         for o, s in objs.items()}, jnp.asarray(backs))
    tst = tdd.DetectorStore.from_patch_stores(
        {o: _St(*(torch.from_numpy(a) for a in (s.rgb, s.mask, s.extent)))
         for o, s in objs.items()}, torch.from_numpy(backs))
    return jst, tst


def _jax_batch(store, key, bsz=2, im_size=128, k_obj=3):
    return {k: np.asarray(v) for k, v in jdd.make_detector_batch(
        store, key, bsz, im_size, k_obj, warp_dtype=None).items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def test_losses_match_jax(stores):
    """focal, instance-mask and total losses on seeded outputs against a
    real batch's targets (a shared center cell and an invalid slot
    included)."""
    js, _ = stores
    batch = _jax_batch(js, jax.random.PRNGKey(2), bsz=2, k_obj=4)
    assert batch["gt_valid"].any() and not batch["gt_valid"].all()
    rng = np.random.default_rng(0)
    hs = batch["heat"].shape[1]
    shapes = {"heat": 2, "wh": 2, "off": 2, "seg": 2, "ctrl": tdet.N_CTRL,
              "mfeat": tdet.MASK_DIM}
    out = {k: rng.normal(0, 1.5, (2, hs, hs, c)).astype(np.float32)
           for k, c in shapes.items()}
    out["heat"] -= 2.0
    jout = jdet.DetectorOut(**{k: jnp.asarray(v) for k, v in out.items()})
    tout = tdet.DetectorOut(**{k: torch.from_numpy(v)
                               for k, v in out.items()})
    tb = _torch_batch(batch)
    for name, got, want in (
            ("focal", tdet.focal_loss(tout.heat, tb["heat"]),
             jdet.focal_loss(jout.heat, batch["heat"])),
            ("mask", tdet.instance_mask_loss(
                tout, tb["gt_center"], tb["gt_mask"], tb["gt_valid"]),
             jdet.instance_mask_loss(jout, batch["gt_center"],
                                     batch["gt_mask"], batch["gt_valid"]))):
        assert float(got) == pytest.approx(float(want), rel=1e-5), name
    total, parts = tdet.detector_loss(tout, tb)
    jtotal, jparts = jdet.detector_loss(jout, batch)
    assert float(total) == pytest.approx(float(jtotal), rel=1e-5)
    assert parts.keys() == jparts.keys()
    for k in parts:
        assert float(parts[k]) == pytest.approx(float(jparts[k]),
                                                rel=1e-5), k
    # without instance targets the mask term is absent, as in JAX
    plain = {k: v for k, v in tb.items() if not k.startswith("gt_")}
    assert "mask" not in tdet.detector_loss(tout, plain)[1]


def test_batchnorm_repair_matches_flax():
    """TinyTrunk's BatchNorms and ``fuse_bn`` fold the biased batch
    variance into their running statistics in train mode, as flax does."""
    model = tdet.CenterNetDetector(**TINY)
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    assert len(bns) == 6 and all(isinstance(m, BatchNorm2d) for m in bns)
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(
        np.float32)
    fmodel = jdet.CenterNetDetector(**TINY)
    v = seeded_variables(fmodel, x, 3)
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    ref, new = fmodel.apply(v, x, train=True, mutable=["batch_stats"])
    with torch.no_grad():
        got = model.train()(torch.from_numpy(x))
    # the outputs (order 1) through batch statistics: float32 order
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=5e-5)
    stats = flat(state_dict_to_flax(model.state_dict())["batch_stats"])
    want = flat(new["batch_stats"])
    assert stats.keys() == want.keys()
    for k, r in want.items():
        np.testing.assert_allclose(stats[k], r, rtol=0, atol=1e-6,
                                   err_msg=k)
    # in eval mode the running statistics are read as before
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    ref = fmodel.apply({"params": v["params"],
                        "batch_stats": new["batch_stats"]}, x)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5)


def _flax_state(fmodel, x, seed):
    v = seeded_variables(fmodel, x, seed)
    tx = jdt.optax.scale_by_adam()
    return v, jdt.DetTrainState(params=v["params"], stats=v["batch_stats"],
                                opt=tx.init(v["params"]),
                                step=jnp.zeros((), jnp.int32))


def _torch_state(v):
    model = tdet.CenterNetDetector(**TINY)
    model.load_state_dict(flax_to_state_dict(v), strict=True)
    return tdt.DetTrainState(model=model, opt=torch.optim.Adam(
        model.parameters(), lr=0.0, betas=(0.9, 0.999), eps=1e-8))


def _check_params(model, fparams, lr):
    got = torch_tree(dict(model.named_parameters()))
    n_ok = n_all = n_noise = 0
    for k, ref in flat(fparams).items():
        d = np.abs(got[k] - ref)
        assert d.max() <= 2 * lr + 4 * np.spacing(np.abs(ref).max()), k
        if BIAS_BEFORE_BN.search(k):
            n_noise += 1
        else:
            n_ok, n_all = n_ok + np.sum(d <= 1e-6), n_all + d.size
    assert n_noise == 6
    assert n_ok >= 0.999 * n_all, n_ok / n_all


def test_step_matches_flax(stores):
    """One CenterNet step (tiny trunk, 128 px, B=2, instance-mask term
    on) from the same flax variables and batch: losses, the updated
    parameters, the running statistics and the step count."""
    js, _ = stores
    batch = _jax_batch(js, jax.random.PRNGKey(5))
    fmodel = jdet.CenterNetDetector(**TINY)
    v, fstate = _flax_state(fmodel, batch["image"], 7)
    new, jparts = jax.jit(jdt.make_detector_step(fmodel))(
        fstate, batch, STEP_LR)
    state = _torch_state(v)
    parts = tdt.make_detector_step(state.model)(state, _torch_batch(batch),
                                                STEP_LR)
    assert state.step == 1 and parts.keys() == jparts.keys()
    for k, ref in jparts.items():
        assert float(parts[k]) == pytest.approx(float(ref), rel=1e-5), k
    _check_params(state.model, jax.device_get(new.params), STEP_LR)
    stats = flat(state_dict_to_flax(state.model.state_dict())["batch_stats"])
    for k, ref in flat(jax.device_get(new.stats)).items():
        np.testing.assert_allclose(stats[k], ref, rtol=0, atol=1e-6,
                                   err_msg=k)


def test_pooled_step_ring_matches_jax(stores, monkeypatch):
    """The scene pool with the JAX draws injected (axis-aligned
    placements, JAX's warp in float32): the pool after init and after
    each step (the refresh offsets and cadence), its packed dtypes, the
    trained windows and the losses."""
    js, ts = stores
    uniform = jax.random.uniform

    def fixed(key, shape=(), dtype=jnp.float32, minval=0.0, maxval=1.0):
        if isinstance(minval, float) and minval == -np.pi:
            return jnp.zeros(shape, jnp.float32)
        return uniform(key, shape, dtype, minval, maxval)

    monkeypatch.setattr(jax.random, "uniform", fixed)
    monkeypatch.setattr(jdt, "make_detector_batch", functools.partial(
        jdd.make_detector_batch.__wrapped__, warp_dtype=None))
    kw = dict(pool_size=4, batch_size=2, im_size=64, fresh_per_step=1,
              k_obj=2, refresh_every=2)
    fmodel = jdet.CenterNetDetector(**TINY)
    init_pool, jstep = jdt.make_pooled_detector_step(fmodel, **kw)
    key = jax.random.PRNGKey(9)
    jpool = init_pool(js, key)
    x = np.zeros((1, 64, 64, 3), np.float32)
    v, fstate = _flax_state(fmodel, x, 11)
    state = _torch_state(v)
    _, tstep = tdt.make_pooled_detector_step(state.model, **kw)
    pool = tdd.pack_detector_batch(tdd.make_detector_batch(
        ts, None, 4, 64, 2, draws=_cat_draws(
            [jax_draws(k, js, 2, 64, 2, angle=0.0)
             for k in jax.random.split(key, 2)])))
    _check_pool(pool, jpool)
    for it in range(3):
        kstep = jax.random.PRNGKey(20 + it)
        fstate, jpool, jparts = jstep(fstate, js, jpool, jnp.int32(it),
                                      kstep, jnp.float32(STEP_LR))
        kf, kb = jax.random.split(kstep)
        start = int(jax.random.randint(kb, (), 0, 3))
        parts = tstep(state, ts, pool, it, None, STEP_LR,
                      draws=jax_draws(kf, js, 2, 64, 2, angle=0.0),
                      start=torch.tensor(start))
        _check_pool(pool, jpool)
        rel = 1e-5 if it == 0 else 1e-4
        for k, ref in jparts.items():
            assert float(parts[k]) == pytest.approx(float(ref), rel=rel), \
                (it, k)
    assert state.step == 3


def _cat_draws(ds):
    return {k: torch.cat([d[k] for d in ds]) for k in ds[0]}


def _check_pool(pool, jpool):
    assert pool.keys() == jpool.keys()
    assert pool["image"].dtype == torch.uint8
    assert pool["reg_mask"].dtype == torch.bool
    for k, v in pool.items():
        want = np.asarray(jpool[k]).astype(np.float32)
        got = v.float().numpy()
        if k == "image":   # rounding to uint8 at a .5 boundary
            assert np.abs(got - want).max() <= 1 and \
                np.mean(got != want) < 1e-3, k
        else:              # bfloat16: one unit in its last place
            np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6,
                                       err_msg=k)


@pytest.fixture
def dataset(tmp_path):
    """Two objects with train_xyz pairs, backgrounds and a config."""
    ds = tmp_path / "tiny"
    os.makedirs(ds / "models")
    with open(ds / "models" / "models_info.json", "w") as f:
        json.dump({"1": {"diameter": 100.0}, "2": {"diameter": 90.0}}, f)
    for obj in (1, 2):
        (ds / "models" / f"obj_{obj:06d}.ply").touch()   # a model id
        write_pairs(ds / "train_xyz" / f"{obj:02d}", 4, obj,
                    {"rotation_lock": False, "visual_sym_idx": [0]})
    backs = tmp_path / "backs"
    os.makedirs(backs)
    rng = np.random.RandomState(1)
    for i in range(2):
        Image.fromarray(rng.randint(0, 255, (100, 140, 3)).astype(
            np.uint8)).save(backs / f"b{i}.png")
    cfg = str(tmp_path / "cfg.json")
    with open(cfg, "w") as f:
        json.dump({"dataset_dir": str(tmp_path), "backbone": "paper"}, f)
    return tmp_path, str(backs), cfg


def test_trainer_cli_writes_exports_and_resumes(dataset, monkeypatch,
                                                capsys):
    """``main --device cpu --steps 2`` (512 px; the trainers' detector
    classes patched to the tiny trunk, as the JAX tests patch theirs)
    writes ``epoch_0001.pt`` and an ``inference.npz`` that
    ``TorchDetector`` loads strictly; a rerun resumes. Without
    ``--device`` the trainers refuse to start on a host without CUDA."""
    from pix2pose_torch.models import retinanet as tret
    from pix2pose_torch.training import retinanet_train as trt

    widths = {k: TINY[k] for k in ("trunk", "head_dim")}
    monkeypatch.setattr(tdt, "CenterNetDetector", functools.partial(
        tdet.CenterNetDetector, **widths))
    monkeypatch.setattr(trt, "RetinaNetDetector", functools.partial(
        tret.RetinaNetDetector, **widths))
    root, backs, cfg = dataset
    args = [cfg, "tiny", backs, "--steps", "2", "--batch", "2", "--device",
            "cpu"]
    state = tdt.main(args)
    wdir = root / "tiny" / "weight_detection" / "centernet"
    assert state.step == 2 and (wdir / "epoch_0001.pt").exists()
    variables = ckpt.load_inference_params(str(wdir))
    det = TorchDetector(tdet.CenterNetDetector(**TINY),
                        flax_to_state_dict(variables), [1, 2],
                        device="cpu")
    trained = state.model.state_dict()
    for k, val in det.model.state_dict().items():
        if val.is_floating_point():
            assert torch.equal(val, trained[k]), k
    rgb = np.random.default_rng(0).integers(0, 255, (96, 128, 3),
                                            dtype=np.uint8)
    assert isinstance(det.detect(0, 0, rgb), list)
    capsys.readouterr()
    state = tdt.main(args)
    assert "resumed detector from checkpoint 1" in capsys.readouterr().out
    assert state.step == 4 and ckpt.latest_epoch(str(wdir)) == 1

    rstate = trt.main([cfg, "tiny", backs, "--steps", "1", "--batch", "1",
                       "--device", "cpu"])
    assert rstate.step == 1
    assert (root / "tiny" / "weight_detection" / "retinanet" /
            "inference.npz").exists()
    if not torch.cuda.is_available():
        for main in (tdt.main, trt.main):
            with pytest.raises(SystemExit, match="no CUDA device"):
                main([cfg, "tiny", backs])
