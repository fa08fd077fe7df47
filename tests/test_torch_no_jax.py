"""The port stands alone: pix2pose_torch and chip_smoke.py (with the two
stand-ins it takes from ``tests/``) import neither jax nor the JAX package (nor h5py, which the GPU machine lacks, until a
Keras file is read), and chip_smoke.py refuses to run (non-zero exit, no
result line) without a CUDA device."""

import os
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "JAX_PLATFORMS")}
    env.update(extra)
    return env


def test_port_imports_no_jax():
    import pix2pose_torch

    sources = sorted((REPO / "pix2pose_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py", REPO / "tests" / "torch_ros_loopback.py",
        REPO / "tests" / "torch_icp_clouds.py"]
    pat = re.compile(r"^\s*(import|from)\s+pix2pose_tpu\b", re.M)
    bad = [str(p) for p in sources if pat.search(p.read_text())]
    assert not bad, bad

    mods = sorted(m.name for m in pkgutil.walk_packages(
        pix2pose_torch.__path__, "pix2pose_torch."))
    for m in ("ops.rasterizer_cuda", "training.detector_train",
              "training.retinanet_train", "eval.detection_metrics",
              "tools.eval_detector", "tools.scene_gen_detection",
              "training.multi", "tools.rehearsal", "tools.ab_e2e",
              "parallel.mesh", "tools.convert_weights",
              "tools.icp_robustness", "tools.parity_lmo"):
        assert f"pix2pose_torch.{m}" in mods, m
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "bad = sorted(k for k in sys.modules\n"
            "             if k.split('.')[0] in ('jax', 'jaxlib', 'flax',\n"
            "                                    'pix2pose_tpu', 'h5py'))\n"
            "assert not bad, bad\n"
            "print('clean', len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout


def test_chip_smoke_fails_without_gpu():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO,
                         env=_env(CUDA_VISIBLE_DEVICES=""),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
