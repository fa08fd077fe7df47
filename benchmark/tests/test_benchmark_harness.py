"""The harness's plumbing: cells, configurations and metrics found by name
as files, BENCHMARK.json against those files, the analytic operation
counts against a counter, the result line, and what the processes import."""

from __future__ import annotations

import ast
import json
import shutil
import subprocess
import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import common, flops
from benchmark.reference import nets
from benchmark.tests.conftest import tiny_tree

REPO = common.ROOT.parent


def test_cell_config_metric_added_as_new_files(tmp_path):
    root = tiny_tree(tmp_path)
    cfg = common.load_json(root / "configs" / "pix2pose-paper-lmo.json")
    (root / "configs" / "new-config.json").write_text(json.dumps(cfg))
    mix = common.load_json(root / "traffic" / "lmo-rgb-4cam.json")
    mix["cameras"] = 1
    (root / "traffic" / "one-cam.json").write_text(json.dumps(mix))
    (root / "workloads" / "new.cell.json").write_text(json.dumps(
        {"config": "new-config", "traffic": "one-cam", "chips": 1,
         "units": {}, "limits": {}}))
    (root / "metrics" / "new.metric.py").write_text(
        'LAYER = "x"\nUNIT = "%"\nMOVES = "frames_per_s"\n\n'
        'def read(trace):\n    return trace.get("new")\n')
    cell, c, m = common.load_cell("new.cell", root)
    assert c == cfg and m["cameras"] == 1 and cell["traffic"] == "one-cam"
    assert common.traffic_kind(m).__name__ == "benchmark.traffic.cameras"
    readers = common.metric_readers(root)
    assert readers["new.metric"].read({"new": 7.0}) == 7.0
    assert readers["new.metric"].read({}) is None
    assert {"mfu.serve", "mfu.train"} <= set(readers)


def test_benchmark_json_agrees_with_the_files():
    bench = common.load_json(REPO / "BENCHMARK.json")
    readers = common.metric_readers()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        cell, cfg, mix = common.load_cell(w["name"])
        assert (cell["config"], cell["traffic"], cell["chips"]) == \
            (w["config"], w["traffic"], w["chips"])
        for name, unit in cell["units"].items():
            assert e2e[name]["unit"] == unit
            assert w["name"] in e2e[name].get("workloads", [w["name"]])
    for m in bench["per_layer"]:
        mod = readers[m["name"]]
        assert (mod.LAYER, mod.UNIT, mod.MOVES) == \
            (m["layer"], m["unit"], m["moves"])
        for w in m["workloads"]:
            cell = common.load_json(common.ROOT / "workloads" / f"{w}.json")
            assert m["moves"] in cell["units"]
    for c in bench["configs"]:
        assert (REPO / c["file"]).exists()


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture
def transposed_deconv(monkeypatch):
    """The reference's transposed convs as ``conv_transpose2d``, so that
    the counter sees a transposed conv (counted on its input positions)."""

    def deconv(x, w, b):
        h, wd = x.shape[2], x.shape[3]
        y = torch.nn.functional.conv_transpose2d(x, w, b, 2, 1)
        return y[:, :, :2 * h, :2 * wd]

    monkeypatch.setattr(nets, "deconv_same", deconv)


def _params(backbone):
    from benchmark import weights
    from pix2pose_torch.models.ae import build_generator

    g = torch.Generator().manual_seed(0)
    return weights.seeded_state(build_generator(backbone).state_dict(), 1,
                                g, "cpu")[0]


@pytest.mark.parametrize("backbone", ["paper", "resnet50"])
def test_generator_flops_match_a_counter(backbone, transposed_deconv):
    p = _params(backbone)
    x = torch.zeros(1, 128, 128, 3)
    got = _counted(lambda: nets.generator(p, x, backbone))
    want = flops.forward(flops.GENERATORS[backbone]())
    assert abs(got - want) / want < 1e-3


def test_gan_step_flops_match_a_counter(transposed_deconv):
    from pix2pose_torch.models.discriminator import Discriminator
    from benchmark import weights

    pg = _params("paper")
    pd = weights.seeded_state(Discriminator().state_dict(), 1,
                              torch.Generator().manual_seed(1), "cpu")[0]
    x = torch.zeros(2, 128, 128, 3)
    assert abs(_counted(lambda: nets.discriminator(pd, x)) / 2
               - flops.forward(flops.discriminator())) < 1e3

    def step():
        with torch.no_grad():
            fake = nets.generator(pg, x, "paper")[0]
        for imgs in (fake, x):
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in pd.items() if v.is_floating_point()
                      and "running" not in k}
            loss = nets.discriminator({**pd, **leaves}, imgs)[0].sum()
            torch.autograd.grad(loss, list(leaves.values()))
        leaves = {k: v.clone().requires_grad_(True)
                  for k, v in pg.items() if v.is_floating_point()
                  and "running" not in k}
        img, prob, _ = nets.generator({**pg, **leaves}, x, "paper",
                                      train=True)
        loss = nets.discriminator(pd, img, False)[0].sum() + prob.sum()
        torch.autograd.grad(loss, list(leaves.values()))

    got = _counted(step)
    want = flops.gan_step("paper", 2)
    assert abs(got - want) / want < 1e-3


def test_result_line_is_one_json_object_with_the_checks_last():
    checks = common.judge({"a": 0.5, "b": 2}, {"a": 1.0, "b": 1})
    line = common.result_line(
        True, 10, 0, {"setup_s": {"value": 1.5, "unit": "s"}},
        {"platform": "gpu", "kind": "x", "count": 1,
         "memory_peak_bytes": 3}, checks,
        {"device_ops": [["k", 0.1]], "idle_gaps": [["idle", 0.2]]})
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["checks"]["a"] == {"value": 0.5, "limit": 1.0, "ok": True}
    assert out["checks"]["b"]["ok"] is False
    assert "\n" not in line


def test_forbidden_modules_compare_whole_top_level_names():
    assert common.forbidden_modules(["pix2pose_torch.ops", "jaxtyping",
                                     "flaxen.x"]) == []
    assert common.forbidden_modules(["jax.numpy", "pix2pose_tpu.ops",
                                     "flax"]) == ["flax", "jax",
                                                  "pix2pose_tpu"]


def test_client_process_imports_no_torch():
    code = ("import sys, benchmark.client; print(sorted({m.split('.')[0] "
            "for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True).stdout
    tops = set(eval(out))
    assert not tops & {"torch", "numpy", "jax", "pix2pose_torch",
                       "pix2pose_tpu"}


def test_reference_imports_nothing_of_the_program():
    for path in (common.ROOT / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for n in names:
                assert n.split(".")[0] not in ("pix2pose_torch",
                                               "pix2pose_tpu", "jax",
                                               "flax"), (path, n)


def test_run_refuses_without_a_card_and_prints_nothing(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    res = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "paper.lmo-rgb-4cam", "--seed",
                          "2147483999", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_run_fails_without_the_program(tmp_path):
    shutil.copytree(common.ROOT, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    res = subprocess.run([sys.executable, "-m", "benchmark.run",
                          "--workload", "paper.lmo-rgb-4cam", "--seed", "1",
                          "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True)
    assert res.returncode != 0 and res.stdout.strip() == ""
