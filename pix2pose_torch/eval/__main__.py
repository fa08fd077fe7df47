"""``python -m pix2pose_torch.eval``: the BOP RGB evaluation CLI."""

from pix2pose_torch.eval.bop_eval import main

if __name__ == "__main__":
    main()
