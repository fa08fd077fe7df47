"""The Pix2Pose GAN iteration (port of :mod:`pix2pose_tpu.training.gan`).

The reference alternates three Keras ``train_on_batch`` calls per
iteration: the discriminator on generated images, the discriminator on the
real XYZ targets (both with label smoothing and whole-batch label
flipping), then the combined DCGAN step with loss weights [recon=100,
adv=1] (``tools/3_train_pix2pose.py:44-69,180-186,209-222``). Here one
:func:`make_train_step` call does the same with autograd: two
discriminator Adam updates through one optimizer (its step count advances
twice) and one generator update.

Hazards kept from the JAX step:

- Adam is optax's ``scale_by_adam`` with eps outside the square root,
  i.e. ``torch.optim.Adam``; the learning rate is set per call.
- With the ResNet-50 backbone a coupled 2e-4 weight decay is added to the
  gradient of every parameter under ``trunk`` (BatchNorm scale and bias
  included) before Adam (``_resnet_decay_mask``, the Keras l2(1e-4) on
  the ResNet kernels); the rest of the generator and the discriminator
  have none.
- The fakes come from the generator in inference mode (running
  statistics, like the reference's ``generator.predict``), detached.
- In the generator step the discriminator runs in inference mode with
  its updated running statistics and its parameters take no gradient.
- ``compute_dtype="bfloat16"`` runs the forwards under
  ``torch.autocast``; parameters, optimizer state and losses stay float32.

Random label draws come from :func:`draw_labels`, and the step takes
them as tensors, so a caller can inject the JAX package's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
from torch import nn

from pix2pose_torch.config import TrainConfig
from pix2pose_torch.models.ae import deterministic_cudnn
from pix2pose_torch.models.losses import bce_logits, transformer_loss

_TRUNK_DECAY = 2e-4  # optax add_decayed_weights: 2x the Keras l2(1e-4)


@dataclasses.dataclass
class GanTrainState:
    """Both networks, their optimizers and the number of steps taken."""

    gen: nn.Module
    disc: nn.Module
    gen_opt: torch.optim.Adam
    disc_opt: torch.optim.Adam
    step: int = 0


def init_like_flax(model: nn.Module, gen: torch.Generator) -> nn.Module:
    """Re-initialize ``model`` in place with flax's defaults, drawing from
    ``gen`` (a CPU generator, so the weights do not depend on the
    device): kernels LeCun-normal (truncated at 2 sigma, std
    ``sqrt(1 / fan_in) / 0.8796``; fan_in over the input channels and the
    kernel window, for transposed convs too), biases 0, BatchNorm scale 1
    and statistics (0, 1)."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = m.weight
                # torch keeps conv kernels (out, in, ...) and transposed
                # ones (in, out, ...)
                cin = w.shape[0] if isinstance(m, nn.ConvTranspose2d) \
                    else w.shape[1]
                fan_in = cin * math.prod(w.shape[2:])
                std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
                cpu = torch.empty(w.shape, dtype=torch.float32)
                nn.init.trunc_normal_(cpu, 0.0, std, -2 * std, 2 * std,
                                      generator=gen)
                w.copy_(cpu)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
    return model


def _param_groups(gen: nn.Module, decay_trunk: bool):
    if not decay_trunk:
        return [{"params": list(gen.parameters()), "weight_decay": 0.0}]
    trunk, rest = [], []
    for name, p in gen.named_parameters():
        (trunk if "trunk" in name.split(".") else rest).append(p)
    return [{"params": trunk, "weight_decay": _TRUNK_DECAY},
            {"params": rest, "weight_decay": 0.0}]


def create_train_state(gen: nn.Module, disc: nn.Module,
                       cfg: TrainConfig = TrainConfig()) -> GanTrainState:
    """A train state around the (initialized, placed) networks: one Adam
    per network, the generator's trunk decayed for
    ``backbone="resnet50"``."""

    def adam(groups):
        return torch.optim.Adam(groups, lr=cfg.lr_schedule[0],
                                betas=(cfg.adam_b1, cfg.adam_b2),
                                eps=cfg.adam_eps)

    return GanTrainState(
        gen=gen, disc=disc,
        gen_opt=adam(_param_groups(gen, cfg.backbone == "resnet50")),
        disc_opt=adam(_param_groups(disc, False)))


def draw_labels(gen: torch.Generator, batch_size: int,
                label_flipping: float) -> dict:
    """The step's label draws on ``gen``'s device: soft labels ``y_fake``
    (B,) in [0, 0.1) and ``y_real`` (B,) in [0.9, 1.0), and two 0-d bools
    ``flip_fake`` / ``flip_real``, each true with probability
    ``label_flipping`` (the whole batch's labels flip,
    ``3_train:48-67``)."""
    u = torch.rand((2, batch_size), generator=gen, device=gen.device)
    flips = torch.rand((2,), generator=gen, device=gen.device) \
        < label_flipping
    return {"y_fake": u[0] * 0.1, "y_real": u[1] * 0.1 + 0.9,
            "flip_fake": flips[0], "flip_real": flips[1]}


def compute_autocast(cfg: TrainConfig, device_type: str):
    """The forwards' precision context: ``torch.autocast`` to bfloat16
    under ``compute_dtype="bfloat16"``, else none."""
    if cfg.compute_dtype != "bfloat16":
        return contextlib.nullcontext()
    return torch.autocast(device_type, dtype=torch.bfloat16)


def _disc_update(disc, opt, imgs, labels, autocast, reduce_grads):
    disc.train()
    opt.zero_grad(set_to_none=True)
    with autocast():
        logits = disc(imgs)
    loss = bce_logits(logits.float(), labels)
    loss.backward()
    reduce_grads(disc)
    opt.step()
    return loss.detach()


def _no_reduce(net: nn.Module):
    pass


def make_train_step(cfg: TrainConfig, deterministic: bool = True,
                    reduce_grads=_no_reduce):
    """``step(state, batch, sym_pool, lr, labels) -> metrics``: one GAN
    iteration that updates ``state`` in place, under cuDNN's
    deterministic algorithms unless ``deterministic`` is False
    (:func:`~pix2pose_torch.models.ae.deterministic_cudnn`).
    ``reduce_grads(net)`` runs on the updated network's gradients before
    each of the three Adam updates (the data-parallel step averages them
    there, :mod:`pix2pose_torch.parallel.mesh`). ``batch``: ``src``,
    ``tgt`` (B, S, S, 3) in [-1, 1] and ``prob_gt`` (B, S, S, 1);
    ``sym_pool`` (n_sym, 3, 3); ``labels`` from :func:`draw_labels`.
    Returns 0-d device tensors (no host sync): ``disc_loss`` (the mean of
    the two discriminator losses), ``recon_loss``, ``gen_adv_loss`` and
    ``gen_total``. Afterwards the parameters' ``.grad`` hold the
    generator step's gradients and the discriminator's update on the
    reals."""

    def step(state: GanTrainState, batch: dict, sym_pool, lr: float,
             labels: dict) -> dict:
        gen, disc = state.gen, state.disc
        src, tgt, prob_gt = batch["src"], batch["tgt"], batch["prob_gt"]

        def autocast():
            return compute_autocast(cfg, src.device.type)

        for opt in (state.gen_opt, state.disc_opt):
            for group in opt.param_groups:
                group["lr"] = lr

        # --- discriminator on fakes (generator in inference mode) ---------
        gen.eval()
        with torch.no_grad(), autocast():
            fake = gen(src)[0].float()
        y_fake = torch.where(labels["flip_fake"], 1.0, labels["y_fake"])
        dl1 = _disc_update(disc, state.disc_opt, fake, y_fake, autocast,
                           reduce_grads)

        # --- discriminator on reals ---------------------------------------
        y_real = torch.where(labels["flip_real"], 0.0, labels["y_real"])
        dl2 = _disc_update(disc, state.disc_opt, tgt, y_real, autocast,
                           reduce_grads)

        # --- generator (discriminator frozen; loss weights 100 / 1) -------
        gen.train()
        disc.eval()
        disc.requires_grad_(False)
        try:
            state.gen_opt.zero_grad(set_to_none=True)
            with autocast():
                gen_img, prob = gen(src)
            recon = transformer_loss(gen_img.float(), tgt, prob.float(),
                                     prob_gt, sym_pool).mean()
            with autocast():
                logits = disc(gen_img)
            adv = bce_logits(logits.float(),
                             torch.ones((), device=src.device))
            total = cfg.loss_weight_recon * recon + cfg.loss_weight_gan * adv
            total.backward()
            reduce_grads(gen)
            state.gen_opt.step()
        finally:
            disc.requires_grad_(True)
        state.step += 1
        return {"disc_loss": (dl1 + dl2) / 2.0, "recon_loss": recon.detach(),
                "gen_adv_loss": adv.detach(), "gen_total": total.detach()}

    def scoped_step(*args, **kw) -> dict:
        with deterministic_cudnn(deterministic):
            return step(*args, **kw)

    return scoped_step
