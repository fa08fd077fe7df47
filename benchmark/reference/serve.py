"""Plain reference of the served pose path, and the comparison that decides
a serving cell's ``correct``.

For every detection of the requests sampled from the window it works out
again, from the frame as sent, the detection and the benchmark's weights:
the stage-1 window (the reference's ``get_boxes``,
``recognition.py:28-69``), its crop (the clamped patch pasted into a zero
canvas and resized to 128 px with an antialiasing triangle filter), the
generator's maps, the foreground, its centroid and the stage-2 window,
the per-threshold stage-2 crops masked by the resampled stage-1 foreground,
the stage-2 maps, the 2D-3D correspondences on the PnP grid, which
candidates may be posed, and a PnP-RANSAC of its own (``pnp.py``) over
each candidate's correspondences.

Nothing here imports the program.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import nets, pnp

BOX_FIELDS = ("v1_ori", "v2_ori", "u1_ori", "u2_ori", "v1", "v2", "u1",
              "u2", "vv1", "vv2", "uu1", "uu2")


def get_boxes(bbox, im_h: int, im_w: int, box_size: float, ct=None,
              max_w: float = 9999.0) -> dict:
    """The reference's square window of one detection, in float32 as the
    configuration states, returned as Python ints."""
    f = np.float32
    v1b, u1b, v2b, u2b = (f(x) for x in bbox)
    if ct is None:
        ct_v, ct_u = np.floor((v1b + v2b) / f(2)), np.floor((u1b + u2b) / f(2))
    else:
        ct_v, ct_u = f(ct[0]), f(ct[1])
    w = min(f(max_w), max((u2b - u1b) * f(box_size), (v2b - v1b) * f(box_size)))
    half = np.floor(w / f(2))
    v1o, v2o = int(ct_v - half), int(ct_v + half)
    u1o, u2o = int(ct_u - half), int(ct_u + half)
    return {"v1_ori": v1o, "v2_ori": v2o, "u1_ori": u1o, "u2_ori": u2o,
            "v1": max(v1o, 0), "v2": min(v2o, im_h),
            "u1": max(u1o, 0), "u2": min(u2o, im_w),
            "vv1": max(-v1o, 0), "vv2": -max(v2o - im_h, 0) + (v2o - v1o),
            "uu1": max(-u1o, 0), "uu2": -max(u2o - im_w, 0) + (u2o - u1o)}


def _resize_weights(length: int, out: int, antialias: bool, device):
    """(out, length) triangle-filter weights from a canvas axis to the
    output grid, each row normalized over the canvas."""
    scale = length / out
    s = max(scale, 1.0) if antialias else 1.0
    c = torch.arange(length, dtype=torch.float64, device=device)
    center = (torch.arange(out, dtype=torch.float64, device=device) + 0.5) \
        * scale - 0.5
    k = torch.clamp(1.0 - (c[None] - center[:, None]).abs() / s, min=0.0)
    return (k / k.sum(1, keepdim=True).clamp(min=1e-12)).to(torch.float32)


def crop(img, box: dict, out: int = 128, antialias: bool = True):
    """(H, W, C) image -> (out, out, C): the clamped patch pasted into a zero
    canvas of the window's size, resized."""
    lv = box["v2_ori"] - box["v1_ori"]
    lu = box["u2_ori"] - box["u1_ori"]
    patch = img[box["v1"]:box["v2"], box["u1"]:box["u2"]]
    canvas = img.new_zeros((lv, lu, img.shape[2]))
    canvas[box["vv1"]:box["vv1"] + patch.shape[0],
           box["uu1"]:box["uu1"] + patch.shape[1]] = patch
    wv = _resize_weights(lv, out, antialias, img.device)
    wu = _resize_weights(lu, out, antialias, img.device)
    return torch.einsum("iv,vuc,ju->ijc", wv, canvas, wu)


def pixel_centres(box: dict, size: int, device):
    """Image (v, u) of each stage-2 grid pixel centre and whether it lies
    in the clamped window."""
    i = torch.arange(size, dtype=torch.float32, device=device)
    cv = box["v1_ori"] + (i + 0.5) * (box["v2_ori"] - box["v1_ori"]) \
        / size - 0.5
    cu = box["u1_ori"] + (i + 0.5) * (box["u2_ori"] - box["u1_ori"]) \
        / size - 0.5
    in_v = (cv >= box["v1"]) & (cv < box["v2"])
    in_u = (cu >= box["u1"]) & (cu < box["u2"])
    return cv, cu, in_v, in_u


def _bilinear_axis(pos, size: int):
    """(n,) positions on a grid of ``size`` -> two taps (index, weight);
    taps outside the grid get weight 0."""
    i0 = torch.floor(pos)
    f = pos - i0
    taps = []
    for idx, wgt in ((i0, 1.0 - f), (i0 + 1.0, f)):
        ok = (idx >= 0) & (idx < size)
        taps.append((idx.clamp(0, size - 1).long(), torch.where(ok, wgt, 0.0)))
    return taps


def stage2_mask(fg_prob, box1: dict, box2: dict, size: int):
    """Stage-1 foreground (T, S, S) float resampled bilinearly at the
    stage-2 grid's pixel centres (in stage-1 grid coordinates), > 0.9, and
    only inside the stage-2 clamped window."""
    cv, cu, in_v, in_u = pixel_centres(box2, size, fg_prob.device)
    gv = (cv - box1["v1_ori"] + 0.5) * size \
        / (box1["v2_ori"] - box1["v1_ori"]) - 0.5
    gu = (cu - box1["u1_ori"] + 0.5) * size \
        / (box1["u2_ori"] - box1["u1_ori"]) - 0.5
    out = torch.zeros(fg_prob.shape[0], size, size, device=fg_prob.device)
    for iv, wv in _bilinear_axis(gv, size):
        for iu, wu in _bilinear_axis(gu, size):
            out = out + fg_prob[:, iv][:, :, iu] * (wv[:, None] * wu[None])
    return (out > 0.9) & in_v[:, None] & in_u[None, :]


# a detection whose served map lies farther than this from the reference's
# counts against ``xyz_gap_share`` (the passthrough maps of sound runs
# agree exactly; in TF32 they lie ~1e-4 apart)
XYZ_GAP = 5e-5
# hypotheses of the reference's PnP-RANSAC per candidate
HYPOTHESES = 1024
# a served pose whose consensus is below this share of the reference's
# counts against ``pnp_short_share``
PNP_SHORT = 0.9


class ServeReference:
    """The reference over one configuration: ``est`` settings and weights
    per object (name -> tensor dicts on ``device``), norm factors (6,)."""

    def __init__(self, cfg: dict, weights: dict, norms: dict, cam_k,
                 device, seed: int = 0):
        self.w, self.norms = weights, norms
        self.est = cfg["estimator"]
        self.backbone = cfg["backbone"]
        self.cam_k = cam_k.to(device)
        self.dev = device
        self.gen = torch.Generator(device=device).manual_seed(seed)

    def _net(self, obj_id, crops):
        out = [nets.generator(self.w[obj_id], crops[i:i + 64], self.backbone)
               for i in range(0, crops.shape[0], 64)]
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    def detection(self, rgb_n, obj_id: int, bbox) -> dict:
        """Everything the engine works out for one detection, per outlier
        threshold where it depends on one."""
        e, size = self.est, 128
        h, w = rgb_n.shape[:2]
        th = torch.tensor(e["outlier_th"], device=self.dev)
        box1 = get_boxes(bbox, h, w, e["box_size"])
        dec1, prob1 = self._net(obj_id, crop(rgb_n, box1)[None])
        dec1, prob1 = dec1[0], prob1[0, ..., 0]
        fg1 = dec1.norm(dim=-1) > e["gray_norm_th"]
        vv, uu = torch.nonzero(fg1, as_tuple=True)
        if vv.numel():
            fb = [vv.min(), uu.min(), vv.max(), uu.max()]
            mean_v = vv.to(torch.float32).mean()
            mean_u = uu.to(torch.float32).mean()
        else:
            fb = [torch.tensor(0)] * 4
            mean_v = mean_u = torch.tensor(0.0)
        f = np.float32
        hs = f(box1["v2_ori"] - box1["v1_ori"]) / f(size)
        ws = f(box1["u2_ori"] - box1["u1_ori"]) / f(size)
        fb_canvas = [f(int(fb[0])) * hs, f(int(fb[1])) * ws,
                     f(int(fb[2])) * hs, f(int(fb[3])) * ws]
        cx_o = (f(bbox[1]) + f(bbox[3])) / f(2)
        cy_o = (f(bbox[0]) + f(bbox[2])) / f(2)
        half_s = f((size - 1) / 2.0)
        ct_u = np.floor(f(float(mean_u)) - half_s + cx_o)
        ct_v = np.floor(f(float(mean_v)) - half_s + cy_o)
        box2 = get_boxes(fb_canvas, h, w, e["box_size"], ct=(ct_v, ct_u),
                         max_w=f(box1["v2_ori"] - box1["v1_ori"]))
        fg_th = fg1[None] & (prob1[None] < th[:, None, None])
        cand_ok = fg_th.sum((1, 2)) >= e["min_stage1_px"]
        m2 = stage2_mask(fg_th.to(torch.float32), box1, box2, size)
        crops2 = crop(rgb_n, box2)[None] * m2[..., None]
        dec2, prob2 = self._net(obj_id, crops2)
        fg2 = dec2.norm(dim=-1) > e["gray_norm_th"]
        xyz01 = ((torch.where(fg2[..., None], dec2, 0.0) + 1.0) * 0.5) \
            .clamp(0.0, 1.0)
        st = e["pnp_stride"]
        cv, cu, in_v, in_u = pixel_centres(box2, size, self.dev)
        in_img = (in_v[:, None] & in_u[None])[::st, ::st]
        nf = self.norms[obj_id].to(self.dev)
        obj_mm = (xyz01[:, ::st, ::st] * 2.0 - 1.0) * nf[:3] + nf[3:]
        pnp_valid = (fg2[:, ::st, ::st] & (prob2[:, ::st, ::st, 0]
                                           < e["inlier_th"]) & in_img)
        img_uv = torch.stack(torch.broadcast_tensors(
            cu[::st][None, :], cv[::st][:, None]), -1)
        return {"box1": box1, "box2": box2, "xyz01": xyz01, "fg2": fg2,
                "pnp_valid": pnp_valid, "obj_mm": obj_mm, "img_uv": img_uv,
                "cand_ok": cand_ok & (fg2.sum((1, 2)) >= e["min_stage1_px"])}

    def recount(self, R, t, obj_mm, img_uv, valid) -> int:
        """Inliers of pose (R, t) among correspondences on the grid: the
        reprojection within the RANSAC band and the point in front."""
        return int(pnp.inliers(obj_mm.reshape(-1, 3), img_uv.reshape(-1, 2),
                               valid.reshape(-1), R, t, self.cam_k,
                               self.est["ransac_reproj_px"]).sum())

    def consensus(self, dets: list) -> list:
        """The reference's own PnP-RANSAC over every candidate of
        ``dets``: per detection (T,) largest consensus, (T, 3, 3) rotations
        and (T, 3) translations (float64)."""
        if not dets:
            return []
        n_t = dets[0]["obj_mm"].shape[0]
        obj = torch.cat([d["obj_mm"].reshape(n_t, -1, 3) for d in dets])
        img = torch.cat([d["img_uv"].reshape(1, -1, 2).expand(n_t, -1, -1)
                         for d in dets])
        valid = torch.cat([d["pnp_valid"].reshape(n_t, -1) for d in dets])
        count, rot, t = pnp.ransac(obj, img, valid, self.cam_k, self.gen,
                                   HYPOTHESES,
                                   self.est["ransac_reproj_px"])
        return list(zip(count.reshape(len(dets), n_t),
                        rot.reshape(len(dets), n_t, 3, 3),
                        t.reshape(len(dets), n_t, 3)))


def rotation_deg(ra, rb) -> float:
    """Angle of the rotation between two rotation matrices, degrees."""
    c = (torch.trace(ra.T @ rb) - 1.0) / 2.0
    return float(torch.rad2deg(torch.arccos(c.clamp(-1.0, 1.0))))


def pose_gap(ra, ta, rb, tb) -> tuple[float, float]:
    """(rotation degrees, translation gap over |tb|) between two poses."""
    ra, ta, rb, tb = (x.detach().to("cpu", torch.float64)
                      if torch.is_tensor(x) else
                      torch.as_tensor(x, dtype=torch.float64)
                      for x in (ra, ta, rb, tb))
    return (rotation_deg(ra, rb),
            float((ta - tb).norm() / tb.norm().clamp(min=1e-9)))


def compare_batches(ref: ServeReference, batches: list, wire: dict,
                    frames: dict, dets: dict, truth: dict) -> dict:
    """Readings of the serving comparison over the sampled batches.

    ``batches``: [(request ids, estimate fields as CPU tensors with
    (B, O, N, ...) axes, object ids)]; ``wire``: request id -> the served
    poses; ``frames``: request id -> the frame as sent (H, W, 3) uint8;
    ``dets``: request id -> [(obj_id, bbox, score, mask)]; ``truth``:
    request id -> each detection's true (R, t).

    Readings (sound runs flip a float32 threshold in one detection now and
    then: a foreground pixel whose norm sits at 0.3, an error at a
    threshold, so each is a share or is pooled, never one detection's; the
    cell's workload file names those it compares):

    - ``valid_mismatch``: the share of detections whose served validity
      differs from the reference's: some candidate with enough stage-1 and
      stage-2 foreground (``min_stage1_px``), at least ``min_pnp_px`` valid
      PnP points and a consensus of one or more in the reference's RANSAC;
    - ``xyz_gap_share``: over the valid detections, the share whose largest
      gap between the served candidate's coordinate map (in [0, 1]) and the
      reference's, over pixels both call foreground, exceeds ``XYZ_GAP``, at
      the threshold whose masks (then map) it matches best;
    - ``fg_mismatch``: the share of their grid pixels whose foreground
      differs; ``pnp_mask_mismatch``: the share of their PnP grid points
      whose validity (foreground, error below ``inlier_th``, inside the
      window) differs;
    - ``inlier_mismatch``: the share of valid poses whose served inlier
      count differs from the recount of the served pose among the
      reference's correspondences by more than max(2, 10%);
    - ``inlier_shortfall``: 1 - (the served inlier counts, summed) / (the
      largest consensus the reference's RANSAC finds on the same
      candidates' correspondences, summed): a weaker solve finds less;
    - ``pnp_short_share``: the share of valid poses whose served inlier
      count is below ``PNP_SHORT`` of that consensus;
    - ``wire_mismatch``: served poses that differ from the engine's
      selected candidate (pose, score, box) or are missing or extra.

    Reported besides: ``box_mismatch`` (detections whose stage-1 or
    stage-2 window differs in any field; their maps are not compared),
    ``xyz_gap_median``, ``xyz_gap_max``, ``inlier_gap`` (the largest
    relative recount gap), and the medians of the served poses' gaps to
    the reference's and to the true poses.
    """
    dev = ref.dev
    r = {"box_mismatch": 0, "wire_mismatch": 0, "compared": 0,
         "valid_poses": 0, "inlier_gap": 0.0}
    rows, refs = [], []
    for req_ids, est, obj_ids in batches:
        for b, rid in enumerate(req_ids):
            rgb_n = (torch.as_tensor(frames[rid], device=dev)
                     .to(torch.float32) - 128.0) / 128.0
            expected = []
            slot_of = {}
            for (obj_id, bbox, score, _), gt in zip(dets[rid], truth[rid]):
                if obj_id not in obj_ids:
                    continue
                o = obj_ids.index(obj_id)
                s = slot_of.get(o, 0)
                if s >= est["valid"].shape[2]:
                    continue
                slot_of[o] = s + 1
                r["compared"] += 1
                valid = bool(est["valid"][b, o, s])
                if valid:
                    frac = max(float(est["frac_inlier"][b, o, s]), 0.0)
                    expected.append((obj_id, est["R"][b, o, s].numpy(),
                                     est["t"][b, o, s].numpy(),
                                     score * frac, np.asarray(bbox)))
                d = ref.detection(rgb_n, obj_id, bbox)
                same_box = all(int(est[name][f][b, o, s]) == d[name][f]
                               for name in ("box1", "box2")
                               for f in BOX_FIELDS)
                r["box_mismatch"] += not same_box
                rows.append((est, b, o, s, valid, same_box, gt))
                refs.append(d)
            r["wire_mismatch"] += _wire_diff(expected, wire.get(rid))
    counts = ref.consensus(refs)

    gaps, inl_bad, valid_bad = [], 0, 0
    srv_sum = ref_sum = 0
    fg_bad = fg_n = pm_bad = pm_n = 0
    to_ref, to_truth = [], []
    min_pnp = ref.est["min_pnp_px"]
    for (est, b, o, s, valid, same_box, gt), d, (n_ref, r_ref, t_ref) in \
            zip(rows, refs, counts):
        posable = (d["cand_ok"] & (d["pnp_valid"].sum((1, 2)) >= min_pnp)
                   & (n_ref >= 1))
        valid_bad += valid != bool(posable.any())
        if not valid:
            continue
        r["valid_poses"] += 1
        if not same_box:
            continue
        xyz_p = est["xyz128"][b, o, s].to(dev)
        fg_p = est["fg128"][b, o, s].to(dev)
        mp = est["mask_pnp"][b, o, s].to(dev)
        per_th = []
        for ti in range(d["xyz01"].shape[0]):
            both = fg_p & d["fg2"][ti]
            g = (xyz_p - d["xyz01"][ti]).abs().amax(-1)
            per_th.append((int((fg_p != d["fg2"][ti]).sum())
                           + int((mp != d["pnp_valid"][ti]).sum()),
                           float(torch.where(both, g, 0.0).max())))
        # the served maps are those of the chosen candidate: the one whose
        # masks they match best, then whose map
        ti = min(range(len(per_th)), key=per_th.__getitem__)
        gaps.append(per_th[ti][1])
        fg_bad += int((fg_p != d["fg2"][ti]).sum())
        fg_n += fg_p.numel()
        pm_bad += int((mp != d["pnp_valid"][ti]).sum())
        pm_n += mp.numel()
        n_rc = ref.recount(est["R"][b, o, s].to(dev),
                           est["t"][b, o, s].to(dev), d["obj_mm"][ti],
                           d["img_uv"], d["pnp_valid"][ti])
        n_srv = int(est["n_inliers"][b, o, s])
        r["inlier_gap"] = max(r["inlier_gap"],
                              abs(n_srv - n_rc) / max(n_rc, 1))
        inl_bad += abs(n_srv - n_rc) > max(2, 0.1 * n_rc)
        srv_sum += n_srv
        ref_sum += int(n_ref[ti])
        r_srv, t_srv = est["R"][b, o, s], est["t"][b, o, s]
        to_ref.append(pose_gap(r_srv, t_srv, r_ref[ti], t_ref[ti]))
        to_truth.append(pose_gap(r_srv, t_srv, *gt))
        r.setdefault("per_pose", []).append(
            (n_srv, int(n_ref[ti]), *to_ref[-1], *to_truth[-1]))
    r["valid_mismatch"] = valid_bad / max(len(rows), 1)
    r["xyz_gap_share"] = (sum(g > XYZ_GAP for g in gaps) / len(gaps)
                          if gaps else None)
    r["xyz_gap_median"] = float(np.median(gaps)) if gaps else None
    r["xyz_gap_max"] = max(gaps, default=None)
    r["fg_mismatch"] = fg_bad / max(fg_n, 1)
    r["pnp_mask_mismatch"] = pm_bad / max(pm_n, 1)
    r["inlier_mismatch"] = inl_bad / max(len(gaps), 1)
    r["inlier_shortfall"] = (1.0 - srv_sum / ref_sum) if ref_sum else None
    r["served_inliers"], r["reference_inliers"] = srv_sum, ref_sum
    short = [p for p in r.get("per_pose", []) if p[0] < PNP_SHORT * p[1]]
    r["pnp_short_share"] = (len(short) / len(r["per_pose"])
                            if r.get("per_pose") else None)
    for name, gs in (("ref", to_ref), ("truth", to_truth)):
        r[f"{name}_deg_median"] = (float(np.median([g[0] for g in gs]))
                                   if gs else None)
        r[f"{name}_t_median"] = (float(np.median([g[1] for g in gs]))
                                 if gs else None)
    return r


def _wire_diff(expected: list, served) -> int:
    """Served poses that are not the expected ones (exact pose and box,
    score to float32 rounding), plus missing and extra ones."""
    if served is None:
        return max(len(expected), 1)
    left = list(served)
    bad = 0
    for obj_id, R, t, score, bbox in expected:
        hit = next((i for i, p in enumerate(left) if (
            p["obj_id"] == obj_id
            and np.array_equal(np.float32(p["R"]), R.reshape(-1))
            and np.array_equal(np.float32(p["t"]), t.reshape(-1))
            and list(p["bbox"]) == [int(x) for x in bbox]
            and abs(p["score"] - score) <= 1e-6 * max(score, 1e-6))), None)
        if hit is None:
            bad += 1
        else:
            left.pop(hit)
    return bad + len(left)
