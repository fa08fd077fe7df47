"""Plain reference of the training cell, and the comparison that decides
its ``correct``.

From the benchmark's patches, backgrounds, batch draws, label draws and
initial weights it composes the first three batches again
(``pix2pose_util/data_io.py``: colour jitter, occlusion cut-outs, the
stage-2 simulation on even steps, the boundary blur, one affine warp to
128 px) and takes the three GAN iterations again
(``3_train_pix2pose.py:44-69,180-222``: the discriminator on the
generator's fakes and on the real targets, with soft and flipped labels,
then the generator under loss weights [100, 1]; Adam with eps outside the
square root) in plain float32.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference import nets

PATCH, BACK, WORK = 128, 256, 192
PAD = (WORK - PATCH) // 2


def _blur(img):
    """3x3 box blur, zero padding, per channel; (B, H, W, C) or (B, H, W)."""
    x = img if img.dim() == 4 else img[..., None]
    c = x.shape[-1]
    y = F.avg_pool2d(F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1)), 3, 1,
                     count_include_pad=True)
    y = y.permute(0, 2, 3, 1)
    return y if img.dim() == 4 else y[..., 0]


def _rect(r, extent):
    h, w = r[:, 0] * extent, r[:, 1] * extent
    cv = WORK / 2 + r[:, 2] * extent
    cu = WORK / 2 + r[:, 3] * extent
    g = torch.arange(WORK, dtype=torch.float32, device=r.device)
    iv = (g >= cv[:, None]) & (g < (cv + h)[:, None])
    iu = (g >= cu[:, None]) & (g < (cu + w)[:, None])
    return iv[:, :, None] & iu[:, None, :]


def compose(p: dict, d: dict, step: int) -> dict:
    """One batch from the patches ``p`` and the draws ``d``."""
    idx = d["idx"]
    rgb = p["rgb"][idx].float() / 255.0
    rgb = rgb + d["shift"][:, None, None, :]
    rgb = (rgb - 0.5) * d["contrast"][:, None, None, None] + 0.5
    rgb = rgb * d["gain"][:, None, None, :]
    a = d["alpha"][:, None, None, None]
    rgb = (rgb * (1 - a) + _blur(rgb) * a + d["noise"]).clamp(0.0, 1.0)
    xyz = p["xyz"][idx].float() / 255.0
    mask = p["mask"][idx]
    extent = p["extent"][idx]
    b = idx.shape[0]
    back = torch.stack([p["backs"][d["bidx"][i],
                                   d["off"][i, 0]:d["off"][i, 0] + WORK,
                                   d["off"][i, 1]:d["off"][i, 1] + WORK]
                        for i in range(b)]).float() / 255.0
    ws_mask = F.pad(mask.float(), (PAD, PAD, PAD, PAD))
    ws_rgb = F.pad(rgb, (0, 0, PAD, PAD, PAD, PAD))
    ws_xyz = F.pad(torch.where(mask[..., None], xyz, 0.5),
                   (0, 0, PAD, PAD, PAD, PAD), value=0.5)
    in_mask = ws_mask * (1.0 - _rect(d["occ"], extent).float())
    comp = torch.where(in_mask[..., None] > 0, ws_rgb, back)
    bm = _blur(in_mask)
    band = (bm > 0.01) & (bm < 0.99)
    comp = torch.where(band[..., None], _blur(comp), comp)
    if step % 2 == 0:
        diff = (ws_xyz - 0.5) * 2.0
        m = (bm > 0.05) & ((diff * diff).sum(-1).sqrt() > 0.3)
        gray = torch.full_like(comp, 0.5)
        out = torch.where(m[..., None], comp, gray)
        out = torch.where(_rect(d["miss"], extent)[..., None], gray, out)
        wrong = _rect(d["wrong"], extent) & ~(ws_mask > 0)
        comp = torch.where(wrong[..., None], comp, out)
    stacked = torch.cat([(comp - 0.5) * 2.0, (ws_xyz - 0.5) * 2.0,
                         ws_mask[..., None]], -1)
    warped = _warp(stacked, extent, d)
    return {"src": warped[..., :3], "tgt": warped[..., 3:6],
            "prob_gt": (warped[..., 6:7] > 0.5).float()}


def _warp(img, extent, d):
    """Bilinear sample at a rotation + scale about the workspace centre
    (jittered) for each 128 px output pixel; zero outside."""
    b, h, w, c = img.shape
    win = torch.clamp(extent * 1.5 * (1.0 + d["scale"]), min=16.0)
    s = win / PATCH
    ang = d["angle"] * math.pi / 180.0
    cos, sin = torch.cos(ang) * s, torch.sin(ang) * s
    cs = WORK / 2 + d["jitter"]
    co = (PATCH - 1) / 2.0
    i = torch.arange(PATCH, dtype=torch.float32, device=img.device)
    di = (i - co)[None, :, None]
    dj = (i - co)[None, None, :]
    sv = cos[:, None, None] * di - sin[:, None, None] * dj \
        + cs[:, 0, None, None]
    su = sin[:, None, None] * di + cos[:, None, None] * dj \
        + cs[:, 1, None, None]
    v0, u0 = torch.floor(sv), torch.floor(su)
    fv, fu = sv - v0, su - u0
    out = img.new_zeros((b, PATCH, PATCH, c))
    bi = torch.arange(b, device=img.device)[:, None, None]
    for dv, du, wgt in ((0, 0, (1 - fv) * (1 - fu)), (0, 1, (1 - fv) * fu),
                        (1, 0, fv * (1 - fu)), (1, 1, fv * fu)):
        vv, uu = (v0 + dv).long(), (u0 + du).long()
        ok = (vv >= 0) & (vv < h) & (uu >= 0) & (uu < w)
        val = img[bi, vv.clamp(0, h - 1), uu.clamp(0, w - 1)]
        out = out + torch.where(ok[..., None], val, 0.0) * wgt[..., None]
    return out


def transformer_loss(pred, gt, prob, prob_gt, pool):
    """(B,) Pix2Pose reconstruction loss (``ae_model.py:24-67``) under the
    object's symmetry pool, the first best pose winning ties."""
    vis = (prob_gt[..., 0] > 0.5).float()
    diffs = torch.stack([(torch.einsum("ij,bhwj->bhwi", r, gt) - pred)
                         .abs().mean(-1) for r in pool])
    best = diffs.sum((2, 3)).argmin(0)
    l1 = diffs[best, torch.arange(pred.shape[0])]
    loss = vis * l1 * 3.0 + (1.0 - vis) * l1 \
        + 0.5 * (prob[..., 0] - l1.clamp(max=1.0)) ** 2
    return loss.mean((1, 2))


def bce(logits, labels):
    return (logits.clamp(min=0) - logits * labels
            + torch.log1p(torch.exp(-logits.abs()))).mean()


class Adam:
    """Adam with bias correction and eps outside the square root."""

    def __init__(self, params: dict, b1: float, b2: float, eps: float):
        self.p = params
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0
        self.b1, self.b2, self.eps = b1, b2, eps

    def step(self, grads: dict, lr: float):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k] = self.b1 * self.m[k] + (1 - self.b1) * g
            self.v[k] = self.b2 * self.v[k] + (1 - self.b2) * g * g
            denom = (self.v[k] / c2).sqrt() + self.eps
            self.p[k] = (self.p[k] - lr * (self.m[k] / c1) / denom).detach()


class TrainReference:
    def __init__(self, cfg: dict, patches: dict, device):
        self.cfg, self.dev = cfg, device
        self.p = {k: patches[k] for k in ("rgb", "xyz", "mask", "extent",
                                          "backs")}
        self.t = cfg["train"]

    def _split(self, sd: dict):
        params = {k: v.to(self.dev).float() for k, v in sd.items()
                  if not _buffer(k)}
        bufs = {k: v.to(self.dev) for k, v in sd.items() if _buffer(k)}
        return params, bufs

    def steps(self, record: dict, lr: float):
        """The three iterations: per step its batch and losses, Adam's
        first moments after the first, the parameters after the third."""
        t = self.t
        pg, bg = self._split(record["g0"])
        pd, bd = self._split(record["d0"])
        opt_g = Adam(pg, t["adam_b1"], t["adam_b2"], t["adam_eps"])
        opt_d = Adam(pd, t["adam_b1"], t["adam_b2"], t["adam_eps"])
        pool = torch.eye(3, device=self.dev)[None]
        bb = self.cfg["backbone"]
        out = {"batches": [], "losses": []}
        for i in range(3):
            d = {k: v.to(self.dev) for k, v in record["draws"][i].items()}
            lab = {k: v.to(self.dev) for k, v in record["labels"][i].items()}
            batch = compose(self.p, d, i)
            out["batches"].append(batch)
            src, tgt = batch["src"], batch["tgt"]
            with torch.no_grad():
                fake = nets.generator({**opt_g.p, **bg}, src, bb)[0]
            d_losses = []
            for imgs, y in ((fake, torch.where(lab["flip_fake"], 1.0,
                                               lab["y_fake"])),
                            (tgt, torch.where(lab["flip_real"], 0.0,
                                              lab["y_real"]))):
                leaves = {k: v.clone().requires_grad_(True)
                          for k, v in opt_d.p.items()}
                logits, stats = nets.discriminator({**leaves, **bd}, imgs,
                                                   True)
                loss = bce(logits, y)
                grads = torch.autograd.grad(loss, list(leaves.values()))
                opt_d.step(dict(zip(leaves, grads)), lr)
                bd.update(stats)
                d_losses.append(float(loss.detach()))
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in opt_g.p.items()}
            gen_img, prob, gstats = nets.generator({**leaves, **bg}, src, bb,
                                                   train=True)
            recon = transformer_loss(gen_img, tgt, prob, batch["prob_gt"],
                                     pool).mean()
            logits, _ = nets.discriminator({**opt_d.p, **bd}, gen_img, False)
            adv = bce(logits, torch.ones((), device=self.dev))
            total = t["loss_weight_recon"] * recon + t["loss_weight_gan"] * adv
            grads = torch.autograd.grad(total, list(leaves.values()))
            opt_g.step(dict(zip(leaves, grads)), lr)
            bg.update(gstats)
            out["losses"].append({"disc_loss": sum(d_losses) / 2.0,
                                  "recon_loss": float(recon),
                                  "gen_adv_loss": float(adv)})
            if i == 0:
                out["m1"] = {"gen": dict(opt_g.m), "disc": dict(opt_d.m)}
        out["g3"], out["d3"] = opt_g.p, opt_d.p
        return out

    def compare(self, record: dict, lr: float) -> dict:
        """Readings against the program's kept steps:

        - ``batch_mismatch``: share of the three batches' values (``src``,
          ``tgt``, ``prob_gt``) that differ by more than 1e-4;
        - ``loss_gap``: the largest relative gap of the three losses over
          the three steps;
        - ``grad_gap``: the worst leaf's gap between the norms of Adam's
          first moment after step 1 (the first gradient, times 0.1, for the
          generator; both discriminator updates' for the discriminator),
          over the larger of that leaf's and the median leaf's reference
          norm;
        - ``update_gap``: the same for each parameter's change over the
          three steps.
        Leaves whose reference first moment is under a thousandth of the
        median leaf's (biases ahead of a BatchNorm, whose gradient is
        round-off) are left out of both."""
        ref = self.steps(record, lr)
        bad = tot = 0
        for bp, br in zip(record["batches"], ref["batches"]):
            for k in ("src", "tgt", "prob_gt"):
                diff = (bp[k].to(self.dev) - br[k]).abs() > 1e-4
                bad += int(diff.sum())
                tot += diff.numel()
        gaps = [[abs(lp[k] - lr_[k]) / max(abs(lr_[k]), 1e-12) for k in lr_]
                for lp, lr_ in zip(record["losses"], ref["losses"])]
        loss_gap = max(max(g) for g in gaps)
        grad_gap = update_gap = 0.0
        excluded = 0
        for net, p0, p3 in (("gen", "g0", "g3"), ("disc", "d0", "d3")):
            m_ref = {k: float(v.norm()) for k, v in ref["m1"][net].items()}
            med = _median(list(m_ref.values()))
            keep = [k for k, v in m_ref.items() if v >= 1e-3 * med]
            excluded += len(m_ref) - len(keep)
            m_prog = {k: float(record["m1"][net][k].norm()) for k in keep}
            grad_gap = max(grad_gap, _worst(m_prog, {k: m_ref[k]
                                                     for k in keep}))
            d_ref = {k: float((ref[p3][k] - record[p0][k].to(self.dev))
                              .norm()) for k in keep}
            d_prog = {k: float((record[p3][k] - record[p0][k]).norm())
                      for k in keep}
            update_gap = max(update_gap, _worst(d_prog, d_ref))
        return {"batch_mismatch": bad / max(tot, 1), "loss_gap": loss_gap,
                "loss_gap_step1": max(gaps[0]),
                "recon_gap_step1": gaps[0][1],
                "recon_gap": max(abs(lp["recon_loss"] - lr_["recon_loss"])
                                 / abs(lr_["recon_loss"]) for lp, lr_ in
                                 zip(record["losses"], ref["losses"])),
                "grad_gap": grad_gap, "update_gap": update_gap,
                "excluded_leaves": excluded, "compared": 3}


def _buffer(name: str) -> bool:
    return name.rsplit(".", 1)[-1] in ("running_mean", "running_var",
                                       "num_batches_tracked")


def _median(v: list) -> float:
    return sorted(v)[len(v) // 2] if v else 0.0


def _worst(prog: dict, ref: dict) -> float:
    med = _median(list(ref.values()))
    return max((abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
                for k in ref), default=0.0)
