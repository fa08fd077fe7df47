"""A GAN training job: one object's generator trained at the configuration's
batch, fed by the program's batch synthesis on the card.

Set-up renders the object's training patches and backgrounds from the
seed into the program's ``PatchStore``, makes both networks' weights, and
builds one train state. It then drives that state through its first three
steps with the window's own call and feed, keeping what the reference
needs (the draws, the batches, the losses, the first Adam moments, the
parameters before and after), and hands the same state to the window.
Every batch's random draws are the benchmark's (:func:`draw_batch`, the
distributions of ``training.data.draw_batch``), handed to ``make_batch``.
"""

from __future__ import annotations

import time

import torch

from benchmark import flops, scene, trace, weights
from benchmark.reference.train import TrainReference

PATCH, BACK, WORK = 128, 256, 192


def draw_batch(gen: torch.Generator, b: int, n_data: int, n_backs: int,
               full_rotation: bool = True) -> dict:
    """Every random number of one batch (the keys and distributions
    ``training.data.make_batch`` takes as ``draws``)."""
    dev = gen.device

    def u(lo, hi, *shape):
        return torch.rand(shape, generator=gen, device=dev) * (hi - lo) + lo

    def rect(lo, hi):
        return torch.cat([u(lo, hi, b, 2), u(-0.5, 0.5, b, 2)], 1)

    idx = torch.randint(0, n_data, (b,), generator=gen, device=dev)
    bidx = torch.randint(0, n_backs, (b,), generator=gen, device=dev)
    per_channel = u(0.0, 1.0, b, 1) < 0.5
    noise_on = u(0.0, 1.0, b, 1, 1, 1) < 0.1
    noise = torch.randn((b, PATCH, PATCH, 3), generator=gen, device=dev)
    return {
        "idx": idx, "bidx": bidx,
        "shift": u(-15 / 255, 15 / 255, b, 3),
        "contrast": u(0.8, 1.3, b),
        "gain": torch.where(per_channel, u(0.8, 1.2, b, 3),
                            u(0.8, 1.2, b, 1).expand(b, 3)),
        "alpha": u(0.0, 0.7, b),
        "noise": torch.where(noise_on, noise * (10 / 255),
                             torch.zeros_like(noise)),
        "off": torch.randint(0, BACK - WORK, (b, 2), generator=gen,
                             device=dev),
        "occ": rect(0.2, 0.7), "miss": rect(0.0, 0.5),
        "wrong": rect(0.0, 0.5),
        "scale": u(-0.3, 0.3, b), "jitter": u(-5.0, 5.0, b, 2),
        "angle": (u(-180.0, 180.0, b) if full_rotation
                  else u(-15.0, 15.0, b)),
    }


def draw_labels(gen: torch.Generator, b: int, flipping: float) -> dict:
    """Soft labels and the two whole-batch flips of one step (the keys
    ``training.gan.make_train_step`` takes)."""
    u = torch.rand((2, b), generator=gen, device=gen.device)
    flips = torch.rand((2,), generator=gen, device=gen.device) < flipping
    return {"y_fake": u[0] * 0.1, "y_real": u[1] * 0.1 + 0.9,
            "flip_fake": flips[0], "flip_real": flips[1]}


def _host(tensors: dict) -> dict:
    return {k: v.detach().to("cpu", copy=True) for k, v in tensors.items()}


def run(ctx) -> dict:
    from pix2pose_torch.config import TrainConfig
    from pix2pose_torch.models.ae import AutoEncoder
    from pix2pose_torch.models.discriminator import Discriminator
    from pix2pose_torch.training.data import PatchStore, make_batch
    from pix2pose_torch.training.gan import create_train_state, \
        make_train_step

    cfg, mix, dev = ctx.cfg, ctx.mix, ctx.device
    t = cfg["train"]
    bsz = t["batch_size"]
    tcfg = TrainConfig(batch_size=bsz, loss_weight_recon=t["loss_weight_recon"],
                       loss_weight_gan=t["loss_weight_gan"],
                       adam_b1=t["adam_b1"], adam_b2=t["adam_b2"],
                       adam_eps=t["adam_eps"],
                       label_flipping=t["label_flipping"],
                       backbone=cfg["backbone"])
    patches = scene.build_patches(cfg, mix, ctx.seed, dev)
    store = PatchStore(rgb=patches["rgb"], xyz=patches["xyz"],
                       mask=patches["mask"], extent=patches["extent"],
                       backs=patches["backs"])
    gen_net = AutoEncoder(backbone=cfg["backbone"])
    disc_net = Discriminator(cfg["im_size"])
    wg = torch.Generator(device=dev).manual_seed(ctx.seed + 1)
    g0 = weights.seeded_state(gen_net.state_dict(), 1, wg, dev, None)[0]
    d0 = weights.seeded_state(disc_net.state_dict(), 1, wg, dev, None)[0]
    gen_net.load_state_dict(g0)
    disc_net.load_state_dict(d0)
    state = create_train_state(gen_net.to(dev), disc_net.to(dev), tcfg)
    step_fn = make_train_step(tcfg)
    if ctx.program_hook is not None:
        step_fn = ctx.program_hook(step_fn)
    sym_pool = torch.eye(3, device=dev)[None]
    feed = torch.Generator(device=dev).manual_seed(ctx.seed + 2)
    lr = t["lr"]
    n_data, n_backs = store.n_data, store.backs.shape[0]
    record = {"g0": _host(g0), "d0": _host(d0), "draws": [], "labels": [],
              "batches": [], "losses": []}

    def one_step(i: int, keep: bool, ev=None):
        d = draw_batch(feed, bsz, n_data, n_backs)
        lab = draw_labels(feed, bsz, t["label_flipping"])
        if ev is not None:
            ev[0].record()
        batch = make_batch(store, None, i, bsz, draws=d)
        if ev is not None:
            ev[1].record()
        m = step_fn(state, batch, sym_pool, lr, lab)
        if ev is not None:
            ev[2].record()
        if keep:
            record["draws"].append(_host(d))
            record["labels"].append(_host(lab))
            record["batches"].append(_host(batch))
            record["losses"].append({k: float(v) for k, v in m.items()})
        return m

    with ctx.precision():
        # the first three steps, kept for the reference, are set-up
        for i in range(3):
            one_step(i, True)
            if i == 0:
                record["m1"] = {
                    "gen": _host(_moments(state.gen, state.gen_opt)),
                    "disc": _host(_moments(state.disc, state.disc_opt))}
        record["g3"] = _host(dict(state.gen.named_parameters()))
        record["d3"] = _host(dict(state.disc.named_parameters()))
        _sync(dev)

        spans = trace.Spans()
        events = []
        prof = None
        t0 = time.monotonic()
        setup_s = t0 - ctx.t_start
        n = 0
        lead = ctx.seconds - ctx.mix["profile_seconds"]
        while time.monotonic() - t0 < ctx.seconds:
            if ctx.trace and prof is None and time.monotonic() - t0 >= lead:
                prof = trace.Profile()
                prof.start()
            ev = None
            if ctx.trace:
                ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
                events.append(ev)
            ta = time.time_ns()
            one_step(3 + n, False, ev)
            if ctx.trace:
                spans.add("training.step (host)", ta, time.time_ns())
            n += 1
        _sync(dev)
        window = time.monotonic() - t0
        if prof is not None:
            prof.stop()
    memory_peak = torch.cuda.max_memory_allocated(dev) \
        if dev.type == "cuda" else 0
    tr = {"kind": "training", "window_s": window, "steps": n,
          "flops": flops.gan_step(cfg["backbone"], bsz) * n}
    if ctx.trace:
        tr["batch_ms"] = [a.elapsed_time(b) for a, b, _ in events]
        tr["step_ms"] = [b.elapsed_time(c) for _, b, c in events]
        tr["profile"] = trace.reduce_profile(prof, spans)
    del state, store, gen_net, disc_net, step_fn
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    t_ref = time.monotonic()
    ref = TrainReference(cfg, patches, dev)
    readings = ref.compare(record, lr)
    from benchmark import common
    common.log(f"reference: 3 steps in {time.monotonic() - t_ref:.1f} s")
    return {"e2e": {"train_samples_per_s": n * bsz / window,
                    "setup_s": setup_s},
            "trace": tr, "readings": readings, "attempted": n,
            "failed": 0, "memory_peak": memory_peak,
            "breakdown": (None if not ctx.trace else
                          {k: tr["profile"][k]
                           for k in ("device_ops", "idle_gaps")})}


def _moments(net, opt) -> dict:
    """Adam's first moment of each parameter, by name."""
    out = {}
    for name, p in net.named_parameters():
        st = opt.state.get(p, {})
        out[name] = st["exp_avg"] if "exp_avg" in st else torch.zeros_like(p)
    return out


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
