"""Batched two-stage pose inference (port of
:mod:`pix2pose_tpu.inference.engine`).

  stage 1: detections -> crop-resize -> generator pass -> foreground,
           centroid and stage-2 window
  stage 2: detections x T outlier thresholds -> masked re-crop ->
           generator pass -> grid correspondences -> PnP-RANSAC ->
           candidate selection

Shapes are static: detections are padded to ``max_det`` slots with a
validity mask. Correspondences live on the strided 128-grid. Reference
semantics kept (with citations in the JAX package): square 1.5x windows
with clamp-and-shift, gray-norm foreground ``||decode|| > 0.3``,
per-threshold background zeroing, stage-2 window on the stage-1 centroid
capped at the stage-1 size, selection by centroid reprojection distance^2
/ inliers, bail-outs (< 10 fg px, < 6 PnP points -> invalid).

Where the JAX package ``vmap``ped over images and detections, the stages
here carry (B, N) axes; objects (different generator weights) are a
Python loop. The stages are separate methods so each can be held against
the JAX computation.

Optional per-detection INSTANCE masks (``det_masks``, an extension of the
JAX package beyond the reference's bbox-only ``est_pose``): when two
instances of one object overlap, the occluded instance's crop is
dominated by its neighbour's pixels. With masks, each detection's mask is
cropped into its own stage-1 and stage-2 windows on the device, and the
stage-1 foreground and the PnP correspondences are restricted to the
detection's own instance. None reproduces the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.func import functional_call

from pix2pose_torch.config import EstimatorConfig
from pix2pose_torch.models.ae import deterministic_cudnn
from pix2pose_torch.ops import boxes as boxes_ops
from pix2pose_torch.ops import crop as crop_ops
from pix2pose_torch.ops import pnp as pnp_ops
from pix2pose_torch.ops.boxes import CropBox
from pix2pose_torch.ops.color import color01_to_xyz, tanh_to_color01
from pix2pose_torch.ops.smallmat import first_argmax


class PoseEstimate(NamedTuple):
    """Per-detection results (leading axes = image, [object,] slot)."""

    R: torch.Tensor            # (..., 3, 3)
    t: torch.Tensor            # (..., 3) mm
    valid: torch.Tensor        # (...) bool
    frac_inlier: torch.Tensor  # (...) inliers / stage-1 fg px; -1 invalid
    n_inliers: torch.Tensor    # (...) int32 at the PnP grid resolution
    mask_pnp: torch.Tensor     # (..., S/st, S/st) bool PnP valid mask
    fg128: torch.Tensor        # (..., S, S) bool stage-2 foreground
    xyz128: torch.Tensor       # (..., S, S, 3) predicted coords in [0, 1]
    box1: CropBox              # stage-1 crop boxes
    box2: CropBox              # stage-2 crop boxes
    area_scale: torch.Tensor   # (...) full-res px per grid px


class Stage1(NamedTuple):
    box1: CropBox          # (B, N)
    prob1: torch.Tensor    # (B, N, S, S) stage-1 error map
    fg1: torch.Tensor      # (B, N, S, S) bool foreground
    n_init: torch.Tensor   # (B, N) foreground pixel count
    box2: CropBox          # (B, N) stage-2 window


class Correspondences(NamedTuple):
    obj: torch.Tensor      # (C, G, 3) model points (mm), C = B*N*T
    img: torch.Tensor      # (C, G, 2) image points (u, v)
    valid: torch.Tensor    # (C, G) bool
    quality: torch.Tensor | None  # (C, G) PROSAC ordering, or None
    fg2: torch.Tensor      # (B, N, T, S, S) bool stage-2 foreground
    xyz01: torch.Tensor    # (B, N, T, S, S, 3)
    pnp_valid: torch.Tensor  # (B, N, T, gs, gs) bool
    cand_ok: torch.Tensor  # (B, N, T) bool


def _axis_resample_weights(out_centers, lo_ori1, len1, size: int):
    """(..., S_out, size) two-tap bilinear weights of one axis of the
    stage-1 -> stage-2 grid map, taps outside [0, size) dropped; built by
    exact integer-valued-float comparison. out_centers (..., S_out),
    lo_ori1 and len1 (...)."""
    g = (out_centers - lo_ori1[..., None] + 0.5) * size / len1[..., None] \
        - 0.5
    i0 = torch.floor(g)[..., None]
    f = (g[..., None] - i0)
    idx = torch.arange(size, dtype=torch.float32, device=g.device)
    return (torch.where(i0 == idx, 1.0 - f, 0.0)
            + torch.where(i0 + 1.0 == idx, f, 0.0))


def _stage2_mask_on_grid(fg_prob, box1: CropBox, box2: CropBox,
                         size: int):
    """Resample stage-1 foreground masks fg_prob (..., T, S, S) onto the
    stage-2 grid and threshold at 0.9 (reference ``recognition.py:103``);
    grid points outside the image see 0. Boxes have the batch shape
    (...). Separable: two weight matmuls in fp32."""
    f32 = lambda x: x.to(torch.float32)
    i = torch.arange(size, dtype=torch.float32, device=fg_prob.device)
    cv = f32(box2.v1_ori)[..., None] + (i + 0.5) \
        * f32(box2.height)[..., None] / size - 0.5
    cu = f32(box2.u1_ori)[..., None] + (i + 0.5) \
        * f32(box2.width)[..., None] / size - 0.5
    w_v = _axis_resample_weights(cv, f32(box1.v1_ori), f32(box1.height),
                                 size)
    w_u = _axis_resample_weights(cu, f32(box1.u1_ori), f32(box1.width),
                                 size)
    samp = w_v[..., None, :, :] @ fg_prob @ w_u[..., None, :, :] \
        .transpose(-1, -2)
    in_v = (cv >= f32(box2.v1)[..., None]) & (cv < f32(box2.v2)[..., None])
    in_u = (cu >= f32(box2.u1)[..., None]) & (cu < f32(box2.u2)[..., None])
    return ((samp > 0.9) & in_v[..., None, :, None]
            & in_u[..., None, None, :])


def _crop_masks(det_masks, box: CropBox, size: int):
    """Instance masks (B, N, H, W) cropped into each detection's own
    window (B, N boxes) without antialiasing, thresholded at 0.5
    (``engine.py:316-322,389-394`` of the JAX package)."""
    b, n, h, w = det_masks.shape
    crops = crop_ops.crop_resize(
        det_masks.reshape(b * n, h, w, 1).to(torch.float32),
        box.map(lambda x: x.reshape(b * n, 1)), size, False)
    return crops.reshape(b, n, size, size) > 0.5


def stack_object_params(params_list):
    """Stack per-object generator state dicts on a leading object axis
    (all objects share one architecture)."""
    return {k: torch.stack([p[k] for p in params_list])
            for k in params_list[0]}


def estimators_for_objects(model, eval_cfg, model_ids,
                           pnp_stride: int | None = None, device="cuda"):
    """{obj_id: Pix2PoseEstimator}, one per object, deduped by resolved
    config: a list-of-lists ``outlier_th`` resolves per object like the
    reference's one graph per object
    (``5_evaluation_bop_basic.py:164-170,206-225``); objects whose
    resolved configs are equal share one estimator."""
    cache: dict = {}
    out = {}
    for idx, obj_id in enumerate(model_ids):
        ecfg = eval_cfg.estimator(idx)
        if ecfg not in cache:
            cache[ecfg] = Pix2PoseEstimator(model, ecfg, pnp_stride,
                                            device=device)
        out[obj_id] = cache[ecfg]
    return out


class Pix2PoseEstimator:
    """Per-object pose estimator over padded detection batches.

    ``model`` is the generator architecture (an ``nn.Module`` taking NHWC
    crops); the weights are a runtime argument (a state dict applied with
    ``torch.func.functional_call``), so one estimator serves every object.
    """

    def __init__(self, model, cfg: EstimatorConfig = EstimatorConfig(),
                 pnp_stride: int | None = None, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.pnp_stride = (pnp_stride if pnp_stride is not None
                           else cfg.pnp_stride)

    # ------------------------------------------------------------ inputs
    def _t(self, x, dtype=None):
        if not torch.is_tensor(x):
            x = np.asarray(x)
            if not x.flags.writeable:  # e.g. a decoded PNG
                x = x.copy()
        return torch.as_tensor(x, device=self.device, dtype=dtype)

    def _apply(self, params, x):
        with deterministic_cudnn():
            if params is None:
                return self.model(x)
            return functional_call(self.model, params, (x,))

    # ------------------------------------------------------------ public
    def _masks(self, det_masks):
        return None if det_masks is None else self._t(det_masks, torch.bool)

    @torch.no_grad()
    def __call__(self, params, rgb, bboxes, det_valid, cam_k, obj_param,
                 generator=None, det_masks=None) -> PoseEstimate:
        """One image: rgb (H, W, 3) raw, bboxes (N, 4) [v1, u1, v2, u2],
        det_valid (N,), cam_k (3, 3), obj_param (6,) [scale_xyz, ct_xyz]
        mm; ``det_masks`` optionally (N, H, W) instance masks. Fields
        carry a leading N axis."""
        return _map(self.estimate_batch(
            params, self._t(rgb)[None], self._t(bboxes)[None],
            self._t(det_valid)[None], self._t(cam_k, torch.float32)[None],
            obj_param, generator,
            None if det_masks is None else self._masks(det_masks)[None]),
            lambda x: x[0])

    @torch.no_grad()
    def estimate_batch(self, params, rgbs, bboxes, det_valid, cam_ks,
                       obj_param, generator=None, det_masks=None
                       ) -> PoseEstimate:
        """B images of one object: rgbs (B, H, W, 3), bboxes (B, N, 4),
        det_valid (B, N), cam_ks (B, 3, 3), ``det_masks`` optionally
        (B, N, H, W). ``generator`` is one ``torch.Generator`` or a
        sequence of B, one per image, each drawing that image's RANSAC
        sets as a call on the image alone would. Fields carry (B, N, ...)
        axes."""
        return self._estimate(params, self._t(rgbs), self._t(bboxes),
                              self._t(det_valid),
                              self._t(cam_ks, torch.float32),
                              self._t(obj_param, torch.float32), generator,
                              det_masks=self._masks(det_masks))

    @torch.no_grad()
    def estimate_objects(self, stacked_params, rgb, bboxes, det_valid,
                         cam_k, obj_params, generator=None, outlier_th=None,
                         det_masks=None) -> PoseEstimate:
        """Objects of one image: :meth:`estimate_objects_images` with one
        image. bboxes (O, N, 4), det_valid (O, N), obj_params (O, 6),
        ``det_masks`` optionally (O, N, H, W). Fields carry (O, N, ...)
        axes."""
        out = self.estimate_objects_images(
            stacked_params, self._t(rgb)[None], self._t(bboxes)[None],
            self._t(det_valid)[None], self._t(cam_k, torch.float32)[None],
            obj_params, generator, outlier_th,
            None if det_masks is None else self._masks(det_masks)[None])
        return _map(out, lambda x: x[0])

    @torch.no_grad()
    def estimate_objects_images(self, stacked_params, rgbs, bboxes,
                                det_valid, cam_ks, obj_params,
                                generator=None, outlier_th=None,
                                det_masks=None) -> PoseEstimate:
        """Images x objects: rgbs (B, H, W, 3), bboxes (B, O, N, 4),
        det_valid (B, O, N), cam_ks (B, 3, 3), obj_params (O, 6),
        stacked_params (:func:`stack_object_params`, leading O axis, or
        None for a weightless model); ``outlier_th`` optionally (O, T);
        ``det_masks`` optionally (B, O, N, H, W). Fields carry
        (B, O, N, ...) axes."""
        rgbs = self._t(rgbs)
        bboxes = self._t(bboxes)
        det_valid = self._t(det_valid)
        cam_ks = self._t(cam_ks, torch.float32)
        obj_params = self._t(obj_params, torch.float32)
        det_masks = self._masks(det_masks)
        n_obj = bboxes.shape[1]
        if outlier_th is None:
            outlier_th = [self.cfg.outlier_th] * n_obj
        outs = []
        for o in range(n_obj):
            params = (None if stacked_params is None else
                      {k: v[o] for k, v in stacked_params.items()})
            outs.append(self._estimate(
                params, rgbs, bboxes[:, o], det_valid[:, o], cam_ks,
                obj_params[o], generator, outlier_th[o],
                None if det_masks is None else det_masks[:, o]))
        return _stack(outs, dim=1)

    # ------------------------------------------------------------ stages
    def stage1(self, params, rgb_n, bboxes, det_masks=None) -> Stage1:
        """Crop, generator pass, foreground, centroid and stage-2 window.
        rgb_n (B, H, W, 3) normalized; bboxes (B, N, 4); ``det_masks``
        optionally (B, N, H, W) bool instance masks, which restrict the
        foreground to each detection's own instance."""
        cfg, size = self.cfg, self.cfg.im_size
        b, im_h, im_w = rgb_n.shape[:3]
        n = bboxes.shape[1]
        box1 = boxes_ops.get_boxes(bboxes, im_h, im_w, cfg.box_size)
        crops1 = crop_ops.crop_resize(rgb_n, box1, size, True)
        dec1, prob1 = self._apply(params, crops1.reshape(-1, size, size, 3))
        dec1 = dec1.reshape(b, n, size, size, 3)
        prob1 = prob1.reshape(b, n, size, size)
        fg1 = torch.linalg.vector_norm(dec1, dim=-1) > cfg.gray_norm_th
        if det_masks is not None:
            fg1 = fg1 & _crop_masks(det_masks, box1, size)
        n_init = fg1.sum((-2, -1))

        # foreground bbox & centroid are threshold-independent (reference
        # ``recognition.py:98-109`` uses non_gray for both)
        fg_bbox = boxes_ops.bbox_from_mask(fg1)
        h1 = box1.height.to(torch.float32)
        w1 = box1.width.to(torch.float32)
        scale_vec = torch.stack([h1, w1, h1, w1], dim=-1) / size
        fg_bbox_canvas = fg_bbox.to(torch.float32) * scale_vec
        gi = torch.arange(size, dtype=torch.float32, device=rgb_n.device)
        fg_f = fg1.to(torch.float32)
        fg_n = torch.clamp(fg_f.sum((-2, -1)), min=1.0)
        mean_v = (fg_f * gi[:, None]).sum((-2, -1)) / fg_n
        mean_u = (fg_f * gi[None, :]).sum((-2, -1)) / fg_n
        # grid centroid -> image (``recognition.py:108-109``)
        cx_o = (bboxes[..., 1] + bboxes[..., 3]).to(torch.float32) / 2.0
        cy_o = (bboxes[..., 0] + bboxes[..., 2]).to(torch.float32) / 2.0
        ct_u = torch.floor(mean_u - (size - 1) / 2.0 + cx_o)
        ct_v = torch.floor(mean_v - (size - 1) / 2.0 + cy_o)
        box2 = boxes_ops.get_boxes(
            fg_bbox_canvas, im_h, im_w, cfg.box_size,
            ct=torch.stack([ct_v, ct_u], dim=-1),
            max_w=(box1.v2_ori - box1.v1_ori).to(torch.float32))
        return Stage1(box1, prob1, fg1, n_init, box2)

    def stage2_inputs(self, rgb_n, s1: Stage1, th_o):
        """Masked stage-2 crops (B, N, T, S, S, 3) and the per-threshold
        candidate gate (B, N, T)."""
        size = self.cfg.im_size
        crops2 = crop_ops.crop_resize(rgb_n, s1.box2, size, True)
        fg_th = s1.fg1[:, :, None] & (s1.prob1[:, :, None]
                                      < th_o[:, None, None])
        cand_ok = fg_th.sum((-2, -1)) >= self.cfg.min_stage1_px
        mask2 = _stage2_mask_on_grid(fg_th.to(torch.float32), s1.box1,
                                     s1.box2, size)
        return crops2[:, :, None] * mask2[..., None].to(torch.float32), \
            cand_ok

    def correspondences(self, dec2, prob2, box2: CropBox, obj_param,
                        cand_ok, det_masks=None) -> Correspondences:
        """Grid 2D-3D correspondences from the stage-2 pass. dec2
        (B, N, T, S, S, 3), prob2 (B, N, T, S, S); ``det_masks``
        optionally (B, N, H, W) restricts them to each detection's own
        instance."""
        cfg, size = self.cfg, self.cfg.im_size
        b, n, n_th = dec2.shape[:3]
        fg2 = torch.linalg.vector_norm(dec2, dim=-1) > cfg.gray_norm_th
        # gray pixels decode to colour 0.5 (ref ``:139``)
        dec2 = torch.where(fg2[..., None], dec2, 0.0)
        xyz01 = tanh_to_color01(dec2)
        cand_ok = cand_ok & (fg2.sum((-2, -1)) >= cfg.min_stage1_px)

        vv, uu, in_img = crop_ops.crop_pixel_centers(box2, size)
        st = self.pnp_stride
        gs = size // st
        sub = lambda a: a[..., ::st, ::st]
        xyz_mm = color01_to_xyz(xyz01[..., ::st, ::st, :], obj_param[:3],
                                obj_param[3:])
        pnp_valid = (sub(fg2) & (sub(prob2) < cfg.inlier_th)
                     & sub(in_img)[:, :, None])
        if det_masks is not None:
            pnp_valid = pnp_valid & sub(_crop_masks(det_masks, box2,
                                                    size))[:, :, None]
        img_pts = torch.stack([sub(uu), sub(vv)], dim=-1)[:, :, None] \
            .expand(b, n, n_th, gs, gs, 2)
        c = b * n * n_th
        quality = -sub(prob2).reshape(c, gs * gs) if cfg.prosac else None
        return Correspondences(
            xyz_mm.reshape(c, gs * gs, 3), img_pts.reshape(c, gs * gs, 2),
            pnp_valid.reshape(c, gs * gs), quality, fg2, xyz01, pnp_valid,
            cand_ok)

    def solve(self, corr: Correspondences, cam_ks, generator,
              sample_idx=None) -> pnp_ops.PnPResult:
        """PnP-RANSAC over all B*N*T candidates; fields reshaped to
        (B, N, T, ...). cam_ks (B, 3, 3). ``generator``: one
        ``torch.Generator``, or a sequence of B, one per image (each
        image's sets are then those of a call on that image alone)."""
        cfg = self.cfg
        b, n, n_th = corr.cand_ok.shape
        k_c = cam_ks[:, None, None].expand(b, n, n_th, 3, 3) \
            .reshape(-1, 3, 3)
        pts = (corr.obj, corr.img, corr.valid, corr.quality)
        cap = cfg.max_pnp_points
        compact = bool(cap) and cap < corr.valid.shape[-1]
        if compact:
            # every PnP stage then runs at ``cap`` points instead of the
            # grid's (ops/pnp.py:compact_correspondences)
            *pts, n_valid, n_kept = pnp_ops.compact_correspondences(
                *pts[:3], cap, pts[3])
        res = pnp_ops.pnp_ransac_batch(
            *pts[:3], k_c, generator, pts[3],
            iters=cfg.ransac_iters, reproj_px=cfg.ransac_reproj_px,
            min_pts=cfg.min_pnp_px, refine_iters=cfg.gn_refine_iters,
            select_stride=cfg.select_stride,
            hyp_polish_iters=cfg.hyp_polish_iters, sample_idx=sample_idx)
        if compact:
            # subsampled inlier counts back in full-grid units, so the
            # selection's dist and the frac_inlier score rank as without
            scale = n_valid.to(torch.float32) / torch.clamp(
                n_kept.to(torch.float32), min=1.0)
            res = res._replace(n_inliers=torch.where(
                res.n_inliers >= 0,
                torch.round(res.n_inliers.to(torch.float32) * scale)
                .to(torch.int32), res.n_inliers))
        return pnp_ops.PnPResult(*(x.reshape((b, n, n_th) + x.shape[1:])
                                   for x in res))

    def select(self, s1: Stage1, corr: Correspondences,
               res: pnp_ops.PnPResult, cam_ks, det_valid) -> PoseEstimate:
        """Pick each detection's candidate by min centroid-reprojection
        distance^2 / inliers (``recognition.py:158-174``)."""
        size, st = self.cfg.im_size, self.pnp_stride
        gs = size // st
        sub = lambda a: a[..., ::st, ::st]
        vv, uu, _ = crop_ops.crop_pixel_centers(s1.box2, size)
        fg2s = sub(corr.fg2).to(torch.float32)
        fg2_n = torch.clamp(fg2s.sum((-2, -1)), min=1.0)
        ct_px_v = (fg2s * sub(vv)[:, :, None]).sum((-2, -1)) / fg2_n
        ct_px_u = (fg2s * sub(uu)[:, :, None]).sum((-2, -1)) / fg2_n
        k = cam_ks[:, None, None]                      # (B, 1, 1, 3, 3)
        tz = res.t[..., 2]
        tz_safe = torch.where(tz == 0, 1e9, tz)
        proj_u = k[..., 0, 0] * res.t[..., 0] / tz_safe + k[..., 0, 2]
        proj_v = k[..., 1, 1] * res.t[..., 1] / tz_safe + k[..., 1, 2]
        dist = ((proj_v - ct_px_v) ** 2 + (proj_u - ct_px_u) ** 2) \
            / (res.n_inliers.to(torch.float32) + 1e-6)
        dist = torch.where(tz == 0, 9.9e6, dist)   # ``recognition:163-168``
        usable = corr.cand_ok & res.ok
        dist = torch.where(usable, dist, torch.inf)
        best = first_argmax(-dist, dim=-1)              # (B, N)
        any_ok = usable.any(-1) & det_valid

        def sel(a):
            idx = best.reshape(best.shape + (1,) * (a.dim() - 2))
            return torch.take_along_dim(a, idx, dim=2)[:, :, 0]

        R, t, n_inl = sel(res.R), sel(res.t), sel(res.n_inliers)
        # inliers live on the st-strided grid: scale to window area so
        # score ranking matches the reference's crop-resolution counts
        win_area = (s1.box2.height * s1.box2.width).to(torch.float32)
        frac = (n_inl.to(torch.float32) * win_area / float(gs * gs)) \
            / torch.clamp(s1.n_init.to(torch.float32), min=1.0)
        eye = torch.eye(3, device=R.device)
        ok3 = any_ok[..., None, None]
        return PoseEstimate(
            R=torch.where(ok3, R, eye),
            t=torch.where(any_ok[..., None], t, 0.0),
            valid=any_ok,
            frac_inlier=torch.where(any_ok, frac, -1.0),
            n_inliers=torch.where(any_ok, n_inl, -1),
            mask_pnp=sel(corr.pnp_valid) & ok3,
            fg128=sel(corr.fg2) & ok3,
            xyz128=sel(corr.xyz01),
            box1=s1.box1, box2=s1.box2,
            area_scale=win_area / float(size * size))

    def _estimate(self, params, rgbs, bboxes, det_valid, cam_ks, obj_param,
                  generator, outlier_th=None, det_masks=None
                  ) -> PoseEstimate:
        """All stages for B images x N detection slots of one object."""
        size = self.cfg.im_size
        th_o = torch.as_tensor(
            self.cfg.outlier_th if outlier_th is None else outlier_th,
            dtype=torch.float32, device=self.device)
        b, n = bboxes.shape[:2]
        n_th = th_o.shape[0]
        # normalize once: (x - 128)/128 (``recognition.py:77``)
        rgb_n = (rgbs.to(torch.float32) - 128.0) / 128.0
        s1 = self.stage1(params, rgb_n, bboxes, det_masks)
        stage2_in, cand_ok = self.stage2_inputs(rgb_n, s1, th_o)
        dec2, prob2 = self._apply(params,
                                  stage2_in.reshape(-1, size, size, 3))
        dec2 = dec2.reshape(b, n, n_th, size, size, 3)
        prob2 = prob2.reshape(b, n, n_th, size, size)
        corr = self.correspondences(dec2, prob2, s1.box2, obj_param,
                                    cand_ok, det_masks)
        res = self.solve(corr, cam_ks, generator)
        return self.select(s1, corr, res, cam_ks, det_valid.to(torch.bool))


def _map(est: PoseEstimate, fn) -> PoseEstimate:
    return PoseEstimate(*(x.map(fn) if isinstance(x, CropBox) else fn(x)
                          for x in est))


def _stack(ests, dim: int) -> PoseEstimate:
    fields = []
    for parts in zip(*ests):
        if isinstance(parts[0], CropBox):
            fields.append(CropBox(*(torch.stack(f, dim=dim)
                                    for f in zip(*parts))))
        else:
            fields.append(torch.stack(parts, dim=dim))
    return PoseEstimate(*fields)
