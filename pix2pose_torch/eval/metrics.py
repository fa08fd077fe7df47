"""BOP pose-error metrics and Average Recall (port of
:mod:`pix2pose_tpu.eval.metrics`).

The reference computes no metrics itself: its CSVs are scored offline by
the external ``bop_toolkit``. Here the BOP'19 protocol runs in the repo:

- VSD (visible surface discrepancy): depth renders of both poses, one
  z-buffer call with P=2 (the estimate and the GT), which is the CUDA
  kernel for CUDA tensors; visibility against the sensor depth with
  delta = 15 mm, misfit tolerance tau; recall over tau in {5..50%} of the
  diameter x theta in {0.05..0.5};
- MSSD (maximum symmetry-aware surface distance): min over the symmetry
  pool of the max vertex distance, recall over theta in {5..50%} of the
  diameter;
- MSPD (maximum symmetry-aware projection distance): the same in pixels,
  recall over theta in {5r..50r}, r = im_w / 640;
- AR = mean of the three per-metric recalls (BOP'19), plus classic ADD /
  ADD-S recall for LineMOD-style reporting.

The distances run on the device, batched over the symmetry pool, with one
copy to the host per (estimate, GT) pair. Matching runs on the host and
follows bop_toolkit (``score.match_poses`` + ``calc_localization_
scores``): estimates sorted by score and capped at the instance count,
errors for every (estimate, GT) pair, and a greedy re-match PER
CORRECTNESS THRESHOLD (and per VSD tau): estimates in score order each
take the not-yet-matched GT with the smallest error strictly below the
threshold. The per-metric AR is the mean over thresholds of the mean over
objects (``mean_obj_recall``).
"""

from __future__ import annotations

import functools
import warnings

import numpy as np
import torch

from pix2pose_torch.ops import rasterizer


# ---------------------------------------------------------------------------
# distance functions (tensors on one device; numpy inputs are moved to
# the device of ``pts``)
# ---------------------------------------------------------------------------


def _f32(x, like):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                           dtype=torch.float32, device=like.device)


def _transform(pts, R, t):
    """pts (..., N, 3) under (R (..., 3, 3), t (..., 3))."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]


def add_metric(pts, R_est, t_est, R_gt, t_gt):
    """ADD: mean vertex distance (mm)."""
    a = _transform(pts, _f32(R_est, pts), _f32(t_est, pts))
    b = _transform(pts, _f32(R_gt, pts), _f32(t_gt, pts))
    return torch.linalg.vector_norm(a - b, dim=-1).mean()


def adi_metric(pts, R_est, t_est, R_gt, t_gt):
    """ADD-S / ADI: mean nearest-neighbour distance (mm), symmetric
    objects."""
    a = _transform(pts, _f32(R_est, pts), _f32(t_est, pts))
    b = _transform(pts, _f32(R_gt, pts), _f32(t_gt, pts))
    d2 = ((a ** 2).sum(1)[:, None] - 2 * a @ b.T + (b ** 2).sum(1)[None, :])
    return torch.sqrt(torch.clamp(d2.amin(1), min=0.0)).mean()


def _sym_pool_rt(sym_pool, like):
    """(S, 3, 3) rotations or an ((S, 3, 3), (S, 3)) pair of full rigid
    symmetry transforms (bop_toolkit uses the full (R_s, t_s))."""
    if isinstance(sym_pool, tuple):
        return _f32(sym_pool[0], like), _f32(sym_pool[1], like)
    sym_R = _f32(sym_pool, like)
    return sym_R, torch.zeros(sym_R.shape[0], 3, device=like.device)


def _pool_points(pts, sym_pool, R_gt, t_gt):
    """The GT pose composed with every symmetry: (S, N, 3)."""
    sym_R, sym_t = _sym_pool_rt(sym_pool, pts)
    return _transform(_transform(pts, sym_R, sym_t), _f32(R_gt, pts),
                      _f32(t_gt, pts))


def mssd_metric(pts, sym_pool, R_est, t_est, R_gt, t_gt):
    """min over symmetries of the max vertex distance (mm)."""
    a = _transform(pts, _f32(R_est, pts), _f32(t_est, pts))
    b = _pool_points(pts, sym_pool, R_gt, t_gt)
    return torch.linalg.vector_norm(a - b, dim=-1).amax(-1).amin()


def _project(p, K):
    z = torch.clamp(p[..., 2], min=1e-9)
    return torch.stack([K[0, 0] * p[..., 0] / z + K[0, 2],
                        K[1, 1] * p[..., 1] / z + K[1, 2]], -1)


def mspd_metric(pts, sym_pool, K, R_est, t_est, R_gt, t_gt):
    """min over symmetries of the max projected distance (px)."""
    K = _f32(K, pts)
    a = _project(_transform(pts, _f32(R_est, pts), _f32(t_est, pts)), K)
    b = _project(_pool_points(pts, sym_pool, R_gt, t_gt), K)
    return torch.linalg.vector_norm(a - b, dim=-1).amax(-1).amin()


def make_vsd(verts_mm, faces, im_h: int, im_w: int, delta_mm: float = 15.0,
             device="cuda"):
    """VSD(e | taus) evaluator for one mesh, on ``device``.

    Returns fn(R_est, t_est_mm, R_gt, t_gt_mm, K, scene_depth_mm, taus_mm)
    -> ((n_tau,) errors in [0, 1], () overflow of the two renders, 0 for
    the port's kernel). Both poses render in ONE z-buffer call (P=2)."""
    verts = torch.as_tensor(np.asarray(verts_mm, np.float32), device=device)
    faces = torch.as_tensor(np.asarray(faces, np.int64), device=device)
    verts2 = verts.expand(2, -1, -1)
    faces2 = faces.expand(2, -1, -1)
    zattr = torch.zeros(2, verts.shape[0], 1, device=device)

    @torch.no_grad()
    def vsd(R_est, t_est, R_gt, t_gt, K, depth_scene, taus):
        R = torch.stack([_f32(R_est, verts), _f32(R_gt, verts)])
        t = torch.stack([_f32(t_est, verts), _f32(t_gt, verts)])
        ro = rasterizer.render_mesh(verts2, faces2, zattr, R, t,
                                    _f32(K, verts), im_h, im_w)
        (d_est, d_gt), (m_est, m_gt) = ro.depth, ro.mask
        depth_scene = _f32(depth_scene, verts)
        has_scene = depth_scene > 0
        # visibility: rendered surface within delta in front of the scene
        # depth (or no scene measurement -> visible)
        vis_est = m_est & (~has_scene | (d_est < depth_scene + delta_mm))
        vis_gt = m_gt & (~has_scene | (d_gt < depth_scene + delta_mm))
        # BOP'19 extension (bop_toolkit visibility.py): estimate pixels
        # where the GT surface is visible count as visible even when
        # occluded, so an occlusion mismatch is not penalized twice
        vis_est = vis_est | (vis_gt & m_est)
        inter = vis_est & vis_gt
        n_union = torch.clamp((vis_est | vis_gt).sum(), min=1)
        dist = torch.abs(d_est - d_gt)
        taus = _f32(taus, verts)
        ok = inter[None] & (dist[None] <= taus[:, None, None])
        overflow = torch.as_tensor(ro.overflow, dtype=torch.float32,
                                   device=verts.device).sum()
        return 1.0 - ok.sum((-2, -1)) / n_union, overflow

    return vsd


# ---------------------------------------------------------------------------
# AR harness
# ---------------------------------------------------------------------------

_THETAS = np.arange(0.05, 0.51, 0.05)  # VSD theta / rel-diameter fractions
_TAU_FRACS = np.arange(0.05, 0.51, 0.05)  # VSD tau as diameter fraction
_MSPD_R = np.arange(5, 51, 5)  # px at 640-width


@functools.lru_cache(maxsize=None)
def _subsample_idx(n, target):
    if n <= target:
        return np.arange(n)
    return np.linspace(0, n - 1, target).astype(np.int64)


def _greedy_match_count(err: np.ndarray, th: float) -> int:
    """bop_toolkit ``score.match_poses`` for one threshold: walk
    estimates in score order (rows of ``err`` are pre-sorted by score),
    each taking the not-yet-matched GT with the smallest error strictly
    below ``th``. Returns the number of matches (= correct poses)."""
    taken = np.zeros(err.shape[1], bool)
    n = 0
    for ei in range(err.shape[0]):
        row = np.where(taken, np.inf, err[ei])
        gi = int(np.argmin(row))
        if row[gi] < th:
            taken[gi] = True
            n += 1
    return n


def evaluate_bop(results, dataset, target_list=None, metrics=("vsd",
                                                              "mssd",
                                                              "mspd"),
                 n_pts: int = 2000, verbose: bool = False,
                 device="cuda") -> dict:
    """Score BOP-format results against dataset GT.

    Args:
      results: list of result dicts (scene_id, im_id, obj_id, score, R, t).
      dataset: :class:`~pix2pose_torch.data.bop.BopDataset` (test split).
      target_list: optional target list; defaults to all GT instances of
        the images present in ``results``.
      device: where the distances and the VSD renders run.

    Returns:
      {"AR": float, "AR_vsd": ..., "AR_mssd": ..., "AR_mspd": ...,
       "per_object": {obj_id: {metric: recall}}}.
    """
    from collections import defaultdict

    from pix2pose_torch.data.ply import load_ply

    device = torch.device(device)
    by_image = defaultdict(list)
    for r in results:
        by_image[(r["scene_id"], r["im_id"])].append(r)

    meshes, sym_pools, diams, vsd_fns = {}, {}, {}, {}
    im_w, im_h = dataset.im_size
    r_px = im_w / 640.0

    def get_mesh(obj_id):
        if obj_id not in meshes:
            m = load_ply(dataset.model_ply_path(obj_id))
            idx = _subsample_idx(m["pts"].shape[0], n_pts)
            meshes[obj_id] = torch.as_tensor(
                np.asarray(m["pts"][idx], np.float32), device=device)
            # full (R_s, t_s) symmetry transforms incl. densified
            # continuous symmetries with their offsets
            sym_R, sym_t = dataset.symmetry_transforms(obj_id)
            sym_pools[obj_id] = (
                torch.as_tensor(sym_R, device=device),
                torch.as_tensor(sym_t, device=device))
            diams[obj_id] = float(
                dataset.model_info(obj_id).get("diameter", 0.0)) or float(
                np.linalg.norm(m["pts"].max(0) - m["pts"].min(0)))
            vsd_fns[obj_id] = make_vsd(m["pts"], m["faces"], im_h, im_w,
                                       device=device)
        return meshes[obj_id]

    # bop_toolkit-style accumulators: per (object, metric) the correct
    # count PER THRESHOLD COMBO and the target count. Combos: mssd/mspd
    # -> 10 thetas; vsd -> 100 (tau, theta) pairs.
    n_combo = {"mssd": len(_THETAS), "mspd": len(_MSPD_R),
               "vsd": len(_TAU_FRACS) * len(_THETAS)}
    correct = defaultdict(
        lambda: {m: np.zeros(n_combo[m], np.int64) for m in metrics})
    totals = defaultdict(int)

    if target_list is None:
        target_list = []
        for (s, i) in sorted(by_image.keys()):
            gts = dataset.scene_gt(s).get(i, [])
            objs = sorted({g["obj_id"] for g in gts})
            target_list.append(
                (s, i, objs,
                 [sum(1 for g in gts if g["obj_id"] == o) for o in objs]))

    cam_cache = {}
    n_vsd = len(_TAU_FRACS)
    for scene_id, im_id, obj_ids, inst_counts in target_list:
        if scene_id not in cam_cache:
            cam_cache[scene_id] = (dataset.scene_camera(scene_id),
                                   dataset.scene_gt(scene_id))
        cams, gts_all = cam_cache[scene_id]
        cam_k = torch.as_tensor(cams[im_id]["cam_K"], device=device)
        gts = gts_all.get(im_id, [])
        ests_img = sorted(by_image.get((scene_id, im_id), []),
                          key=lambda r: -r["score"])
        depth_scene = None
        if "vsd" in metrics:
            # the scene depth goes to the device once per image, in mm
            try:
                depth_np = dataset.load_depth(
                    scene_id, im_id, cams[im_id]["depth_scale"]) * 1000.0
            except FileNotFoundError:
                depth_np = np.zeros((im_h, im_w), np.float32)
            depth_scene = torch.as_tensor(depth_np, device=device)

        for obj_id, n_inst in zip(obj_ids, inst_counts):
            gt_list = [g for g in gts if g["obj_id"] == obj_id]
            est_list = [r for r in ests_img
                        if r["obj_id"] == obj_id][:n_inst]
            pts = get_mesh(obj_id)
            pool = sym_pools[obj_id]
            diam = diams[obj_id]
            n_gt, n_est = len(gt_list), len(est_list)
            totals[obj_id] += n_gt
            if n_gt == 0 or n_est == 0:
                continue

            # errors over ALL (estimate, GT) pairs: matching is
            # threshold-dependent, so no pair can be skipped up front.
            # Each pair's [mssd, mspd, vsd x n_tau, overflow] is one copy
            # to the host.
            errs = np.full((n_est, n_gt, 3 + n_vsd), np.inf)
            taus = torch.as_tensor(_TAU_FRACS * diam, dtype=torch.float32,
                                   device=device)
            for ei, est in enumerate(est_list):
                for gi, gt in enumerate(gt_list):
                    parts = [mssd_metric(pts, pool, est["R"], est["t"],
                                         gt["R"], gt["t"])[None],
                             mspd_metric(pts, pool, cam_k, est["R"],
                                         est["t"], gt["R"], gt["t"])[None]]
                    if "vsd" in metrics:
                        vsd_err, vsd_ovf = vsd_fns[obj_id](
                            est["R"], est["t"], gt["R"], gt["t"], cam_k,
                            depth_scene, taus)
                        parts += [vsd_err, vsd_ovf[None]]
                    row = torch.cat(parts).cpu().numpy()
                    errs[ei, gi, :len(row)] = row
            if "vsd" in metrics and errs[..., -1].any():
                warnings.warn(
                    f"VSD renders truncated ({int(errs[..., -1].sum())} "
                    f"dropped rasterizer work pairs)", RuntimeWarning)

            # per-threshold greedy matching (bop_toolkit
            # ``score.match_poses``)
            if "mssd" in metrics:
                for k, th in enumerate(_THETAS * diam):
                    correct[obj_id]["mssd"][k] += _greedy_match_count(
                        errs[:, :, 0], th)
            if "mspd" in metrics:
                for k, th in enumerate(_MSPD_R * r_px):
                    correct[obj_id]["mspd"][k] += _greedy_match_count(
                        errs[:, :, 1], th)
            if "vsd" in metrics:
                k = 0
                for ti in range(n_vsd):
                    ev = errs[:, :, 2 + ti]
                    for th in _THETAS:
                        correct[obj_id]["vsd"][k] += \
                            _greedy_match_count(ev, th)
                        k += 1

    # per-object recall per threshold combo -> mean over combos; the
    # per-metric AR is the mean over objects averaged over combos
    obj_ids_seen = [o for o in totals if totals[o] > 0]
    out = {}
    per_object = {}
    for o in obj_ids_seen:
        per_object[o] = {
            m: float(np.mean(correct[o][m] / totals[o])) for m in metrics}
    for m in metrics:
        if obj_ids_seen:
            combo_recall = np.mean(
                [correct[o][m] / totals[o] for o in obj_ids_seen], axis=0)
            out[f"AR_{m}"] = float(np.mean(combo_recall))
        else:
            out[f"AR_{m}"] = 0.0
    out["AR"] = float(np.mean([out[f"AR_{m}"] for m in metrics]))
    out["per_object"] = per_object
    return out


def add_recall(results, dataset, th_frac: float = 0.1, n_pts: int = 2000,
               use_adi_for_sym: bool = True, device="cuda") -> float:
    """Classic LineMOD ADD(-S) recall at ``th_frac`` x diameter."""
    from pix2pose_torch.data.ply import load_ply

    device = torch.device(device)
    ok, total = 0, 0
    mesh_cache = {}
    gt_cache = {}
    for r in results:
        obj_id = r["obj_id"]
        if obj_id not in mesh_cache:
            m = load_ply(dataset.model_ply_path(obj_id))
            idx = _subsample_idx(m["pts"].shape[0], n_pts)
            info = dataset.model_info(obj_id)
            sym = ("symmetries_discrete" in info
                   or "symmetries_continuous" in info)
            diam = float(info.get("diameter", 0.0)) or float(
                np.linalg.norm(m["pts"].max(0) - m["pts"].min(0)))
            mesh_cache[obj_id] = (torch.as_tensor(
                np.asarray(m["pts"][idx], np.float32), device=device), sym,
                diam)
        pts, sym, diam = mesh_cache[obj_id]
        if r["scene_id"] not in gt_cache:
            gt_cache[r["scene_id"]] = dataset.scene_gt(r["scene_id"])
        gts = [g for g in gt_cache[r["scene_id"]].get(r["im_id"], [])
               if g["obj_id"] == obj_id]
        if not gts:
            continue
        fn = adi_metric if (sym and use_adi_for_sym) else add_metric
        err = min(float(fn(pts, r["R"], r["t"], g["R"], g["t"]))
                  for g in gts)
        ok += err < th_frac * diam
        total += 1
    return ok / max(total, 1)
