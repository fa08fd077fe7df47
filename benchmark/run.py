"""Run one cell of the benchmark once:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device`` and,
traced, ``breakdown``; the compared numbers and their limits come last,
under ``checks``, and again as the last lines of standard error. Exits
non-zero, with no result line, without enough CUDA devices, or when the
process (or the client process) has loaded JAX or the JAX package.
"""

from __future__ import annotations

from benchmark.common import process_start, split_cores

T_START = process_start()
# before torch starts its threads, which inherit the set
CLIENT_CORES = split_cores()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import common  # noqa: E402


@dataclasses.dataclass
class Context:
    """What a traffic kind's ``run`` gets."""

    cell: dict
    cfg: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    program_tf32: bool = False
    program_hook: object = None   # called with the program's entry object
    client_cores: object = None   # the load generator's cores, if its own

    @contextlib.contextmanager
    def precision(self):
        """The program's precision while the window runs: float32 with
        TF32 off, as the configurations state (TF32 only for the control)."""
        import torch

        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = self.program_tf32
        torch.backends.cudnn.allow_tf32 = self.program_tf32
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev


def card() -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1}


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def execute(name: str, seed: int, seconds: float, traced: bool, device,
            root=common.ROOT, **kw) -> dict:
    """One run of cell ``name``: the kind's result with the metrics read
    and the numbers judged."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell, cfg, mix = common.load_cell(name, root)
    ctx = Context(cell=cell, cfg=cfg, mix=mix, seed=seed, seconds=seconds,
                  trace=traced, device=torch.device(device),
                  t_start=kw.pop("t_start", T_START),
                  client_cores=CLIENT_CORES, **kw)
    out = common.traffic_kind(mix).run(ctx)
    checks = common.judge(out["readings"], cell["limits"])
    out["checks"] = checks
    out["correct"] = (all(c["ok"] for c in checks.values())
                      and out["failed"] == 0
                      and out["readings"].get("compared", 1) > 0)
    if traced:
        metrics = {}
        for mname, mod in common.metric_readers(root).items():
            value = mod.read(out["trace"])
            if value is not None:
                metrics[mname] = {"value": value, "unit": mod.UNIT}
    else:
        units = cell["units"]
        metrics = {k: {"value": _finite(v), "unit": units[k]}
                   for k, v in out["e2e"].items()}
    out["metrics"] = metrics
    return out


def _finite(v: float) -> float:
    return v if math.isfinite(v) else 1e12


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError:
        common.log("no torch: nothing to run on")
        return 2
    cell = common.load_json(common.ROOT / "workloads"
                            / f"{args.workload}.json")
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        common.log(f"needs {cell['chips']} CUDA device(s); "
                   f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available")
        return 2
    # cache directories of the program's builds stay inside the checkout
    os.environ.setdefault("TRITON_CACHE_DIR",
                          str(common.ROOT.parent / "_build" / "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          str(common.ROOT.parent / "_build" / "torch_ext"))
    common.log(f"card: {power_limit()}")
    out = execute(args.workload, args.seed, args.seconds, bool(args.trace),
                  "cuda:0")
    bad = common.forbidden_modules() + common.forbidden_modules(
        out.get("client_modules", []))
    if bad:
        common.log(f"forbidden modules loaded: {sorted(set(bad))}")
        return 3
    device = card()
    device["memory_peak_bytes"] = int(out["memory_peak"])
    breakdown = None
    if args.trace:
        prof = out["trace"].get("profile")
        if prof is None or prof["busy_s"] <= 0:
            common.log("the traced window shows no device operation")
            return 4
        device["busy_s"] = prof["busy_s"]
        device["window_s"] = prof["window_s"]
        breakdown = out["breakdown"]
    for k, v in out["readings"].items():
        common.log(f"reading {k} {v!r}")
    common.print_checks(out["checks"])
    print(common.result_line(out["correct"], out["attempted"], out["failed"],
                             out["metrics"], device, out["checks"],
                             breakdown), flush=True)
    common.print_checks(out["checks"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
