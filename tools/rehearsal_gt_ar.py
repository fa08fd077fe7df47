"""AR of the ground-truth poses of the rehearsal dataset's test split, by
the JAX package's ``evaluate_bop`` on the CPU: the reference value that
``chip_smoke.py`` phase 7b holds the PyTorch port's ``evaluate_bop`` to on
the same dataset (built at its defaults, seed 0).

    JAX_PLATFORMS=cpu python tools/rehearsal_gt_ar.py

Prints the AR dict as one JSON line (~70 s on a CPU).
"""

import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from pix2pose_tpu.data.bop import BopDataset, get_target_list  # noqa: E402
from pix2pose_tpu.data.synthetic_bop import \
    build_rehearsal_dataset  # noqa: E402
from pix2pose_tpu.eval.metrics import evaluate_bop  # noqa: E402


def main():
    with tempfile.TemporaryDirectory() as root:
        build_rehearsal_dataset(root)
        ds = BopDataset(root, "rehearsal", train=False)
        targets = get_target_list(os.path.join(ds.dir,
                                               "test_targets_bop19.json"))
        rows = [{"scene_id": s, "im_id": i, "obj_id": g["obj_id"],
                 "score": 1.0, "R": g["R"], "t": g["t"]}
                for s, i, _, _ in targets for g in ds.scene_gt(s)[i]]
        out = evaluate_bop(rows, ds, target_list=targets)
    print(json.dumps({k: v for k, v in out.items() if k.startswith("AR")}))


if __name__ == "__main__":
    main()
