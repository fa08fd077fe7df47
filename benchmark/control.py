"""The comparisons' controls and planted faults, run on the card at a cell's
own size (the benchmark's own runs never run them):

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 \\
        --mode plain|tf32|<fault> [--seconds 30]

``plain``: the program as the cells run it, for the readings of sound
runs on many seeds in one process. ``tf32``: the program computes its
window in TF32, the precision below the configurations' float32 with TF32
off. A fault breaks the program underneath a whole run. Serving:
``altered_answer`` (every pose the engine produces turned 5 deg about the
camera's x axis, which moves its image by ~50 px at any depth),
``dropped_poses`` (every fourth valid detection of a batch marked
invalid, so never served), ``tf32_one_object`` (the first object of each
engine call, one in eight, computed in TF32), ``fewer_hypotheses``
(``ransac_iters`` 16), ``less_refinement`` (``gn_refine_iters`` 4,
``hyp_polish_iters`` 1), ``weak_pnp`` (``ransac_iters`` 4, no polish,
``gn_refine_iters`` 1). Training: ``half_batch`` (each step sees half of
its batch, its means taken over the rest), ``unchanged`` (each step
returns the losses and leaves the state as it was). Prints one JSON line
of readings per seed; the control or a fault has to come out
``correct: false``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

import torch


def altered_answer(service):
    est = service.est
    orig = est.estimate_objects_images

    c, s = math.cos(math.radians(5.0)), math.sin(math.radians(5.0))

    def moved(*a, **kw):
        out = orig(*a, **kw)
        turn = out.R.new_tensor([[1.0, 0.0, 0.0], [0.0, c, -s], [0.0, s, c]])
        return out._replace(R=turn @ out.R, t=out.t @ turn.T)

    est.estimate_objects_images = moved


def dropped_poses(service):
    est = service.est
    orig = est.estimate_objects_images

    def dropped(*a, **kw):
        out = orig(*a, **kw)
        v = out.valid.reshape(-1)
        keep = v.clone()
        keep[torch.nonzero(v).reshape(-1)[::4]] = False
        return out._replace(valid=keep.reshape(out.valid.shape))

    est.estimate_objects_images = dropped


def tf32_one_object(service):
    est = service.est
    orig = est._estimate
    calls = [0]

    def estimate(*a, **kw):
        first = calls[0] % len(service._obj_ids) == 0
        calls[0] += 1
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = first
        torch.backends.cudnn.allow_tf32 = first
        try:
            return orig(*a, **kw)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev

    est._estimate = estimate


def _solver(**settings):
    def fault(service):
        service.est.cfg = dataclasses.replace(service.est.cfg, **settings)

    return fault


def half_batch(step_fn):
    def step(state, batch, sym_pool, lr, labels):
        half = batch["src"].shape[0] // 2
        lab = dict(labels, y_fake=labels["y_fake"][:half],
                   y_real=labels["y_real"][:half])
        return step_fn(state, {k: v[:half] for k, v in batch.items()},
                       sym_pool, lr, lab)

    return step


def unchanged(step_fn):
    def step(state, batch, sym_pool, lr, labels):
        import copy

        keep = (copy.deepcopy(state.gen.state_dict()),
                copy.deepcopy(state.disc.state_dict()),
                copy.deepcopy(state.gen_opt.state_dict()),
                copy.deepcopy(state.disc_opt.state_dict()))
        out = step_fn(state, batch, sym_pool, lr, labels)
        state.gen.load_state_dict(keep[0])
        state.disc.load_state_dict(keep[1])
        state.gen_opt.load_state_dict(keep[2])
        state.disc_opt.load_state_dict(keep[3])
        return out

    return step


FAULTS = {"altered_answer": altered_answer, "dropped_poses": dropped_poses,
          "tf32_one_object": tf32_one_object,
          "fewer_hypotheses": _solver(ransac_iters=16),
          "less_refinement": _solver(gn_refine_iters=4, hyp_polish_iters=1),
          "weak_pnp": _solver(ransac_iters=4, hyp_polish_iters=0,
                              gn_refine_iters=1),
          "half_batch": half_batch, "unchanged": unchanged}


def run_modes(name: str, seeds, mode: str, seconds: float, device,
              root=None) -> list:
    from benchmark import common, run

    kw = ({"program_tf32": True} if mode == "tf32" else
          {} if mode == "plain" else {"program_hook": FAULTS[mode]})
    if root is not None:
        kw["root"] = root
    out = []
    for seed in seeds:
        res = run.execute(name, seed, seconds, False, device,
                          t_start=time.monotonic(), **kw)
        row = {"seed": seed, "mode": mode, "correct": res["correct"],
               "readings": res["readings"]}
        common.log(json.dumps(row))
        out.append(row)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--mode", required=True,
                    choices=["plain", "tf32", *FAULTS])
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args(argv)
    rows = run_modes(args.workload, [int(s) for s in args.seeds.split(",")],
                     args.mode, args.seconds, "cuda:0")
    for r in rows:
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
