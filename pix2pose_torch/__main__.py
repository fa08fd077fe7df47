"""Unified CLI: ``python -m pix2pose_torch <command> [args...]`` (port of
:mod:`pix2pose_tpu.__main__`, with every command it lists).

Each subcommand imports its module lazily, so ``--help`` is instant.
"""

from __future__ import annotations

import sys

# subcommand -> (module, reference equivalent)
_COMMANDS = {
    "colorize-models": ("pix2pose_torch.tools.colorize_models",
                        "tools/2_1_ply_file_to_3d_coord_model.py"),
    "render-pairs": ("pix2pose_torch.tools.render_training_pairs",
                     "tools/2_2_render_pix2pose_training.py"),
    "render-train-views": ("pix2pose_torch.tools.render_train_views",
                           "tools/render_training_img.py"),
    "scene-gen": ("pix2pose_torch.tools.scene_gen_detection",
                  "tools/1_1_scene_gen_for_detection_maskrcnn.py"),
    "eval": ("pix2pose_torch.eval.bop_eval",
             "tools/5_evaluation_bop_basic.py"),
    "eval-icp": ("pix2pose_torch.eval.bop_eval_icp",
                 "tools/5_evaluation_bop_icp3d.py"),
    "serve": ("pix2pose_torch.serving.__main__",
              "ros_kinetic/ros_pix2pose.py (TCP transport here; "
              "RosAdapter for ROS)"),
    "run-detector": ("pix2pose_torch.tools.run_detector",
                     "tools/mask_rcnn_util.py inference path"),
    "eval-detector": ("pix2pose_torch.tools.eval_detector",
                      "(no reference equivalent: in-repo mAP harness)"),
    "icp-robustness": ("pix2pose_torch.tools.icp_robustness",
                       "(no reference equivalent: ICP oracle harness)"),
    "parity-lmo": ("pix2pose_torch.tools.parity_lmo",
                   "README.md BOP'20 result tables"),
    "train": ("pix2pose_torch.training.train",
              "tools/3_train_pix2pose.py"),
    "train-multi": ("pix2pose_torch.training.multi",
                    "train.sh (sequential per-object jobs, fused here)"),
    "convert-weights": ("pix2pose_torch.tools.convert_weights",
                        "tools/4_convert_weights_inference.py"),
    "rehearsal": ("pix2pose_torch.tools.rehearsal",
                  "full reference flow README.md:96-115 on synthetic "
                  "BOP data"),
    "ab-e2e": ("pix2pose_torch.tools.ab_e2e",
               "(no reference equivalent: paired-seed accuracy gate)"),
}


def _usage() -> str:
    lines = ["usage: python -m pix2pose_torch <command> [args...]", "",
             "commands (reference equivalent in parentheses):"]
    for name, (_, ref) in _COMMANDS.items():
        lines.append(f"  {name:20s} ({ref})")
    lines.append("")
    lines.append("run a command with --help for its arguments")
    return "\n".join(lines)


def main(argv: list[str] | None = None):
    """Run one command; returns what the command's ``main`` returns."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0] in ("-h", "--help"):
        print(_usage())
        return
    cmd = argv[0]
    if cmd not in _COMMANDS:
        print(f"unknown command: {cmd}\n\n{_usage()}", file=sys.stderr)
        raise SystemExit(2)
    import importlib

    return importlib.import_module(_COMMANDS[cmd][0]).main(argv[1:])


if __name__ == "__main__":
    main()
