"""What every part of the harness shares: where cells, configurations,
traffic mixes and metric readers live, the process clock, the import
check and the result line."""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pix2pose_tpu")


def process_start() -> float:
    """``time.monotonic()`` at which this process started (Linux
    ``/proc``), so that set-up counts the interpreter's start too."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.monotonic()


def split_cores() -> set | None:
    """Keep this process (and the threads it starts later) off the last of
    its cores and return that core for the load generator, so that the
    two do not take each other's time; None with fewer than 4 cores."""
    cores = sorted(os.sched_getaffinity(0))
    if len(cores) < 4:
        return None
    os.sched_setaffinity(0, cores[:-1])
    return {cores[-1]}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, root: Path = ROOT) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of a cell, each found by name:
    ``workloads/<cell>.json`` names its ``config`` and ``traffic``, read
    from ``configs/<config>.json`` and ``traffic/<traffic>.json``."""
    cell = load_json(root / "workloads" / f"{name}.json")
    cfg = load_json(root / "configs" / f"{cell['config']}.json")
    mix = load_json(root / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


def traffic_kind(mix: dict):
    """The generator module of a mix's ``kind``: ``traffic/<kind>.py``."""
    return importlib.import_module(f"benchmark.traffic.{mix['kind']}")


def metric_readers(root: Path = ROOT) -> dict:
    """Every per-layer metric reader, ``metrics/<name>.py``, by name. Each
    module has ``LAYER``, ``UNIT``, ``MOVES`` and ``read(trace)``, which
    returns a number or None when the run has nothing for it."""
    out = {}
    for path in sorted((root / "metrics").glob("*.py")):
        if path.name.startswith("_"):
            continue
        name = path.name[:-3]
        spec = importlib.util.spec_from_file_location(
            f"benchmark_metric_{name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        out[name] = mod
    return out


def forbidden_modules(names=None) -> list[str]:
    """Top-level names (before the first dot, compared whole) of loaded
    modules that the benchmark's processes must not hold."""
    tops = {m.split(".", 1)[0] for m in (names if names is not None
                                         else list(sys.modules))}
    return sorted(t for t in tops if t in FORBIDDEN)


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def result_line(correct: bool, attempted: int, failed: int, metrics: dict,
                device: dict, checks: dict, breakdown: dict | None = None
                ) -> str:
    """The run's last line of standard output; the compared numbers with
    their limits come last, under ``checks``."""
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(out)


def print_checks(checks: dict):
    """The compared numbers beside their limits, as the last lines on
    standard error."""
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r} "
            f"{'ok' if c['ok'] else 'FAIL'}")


def judge(readings: dict, limits: dict) -> dict:
    """Each compared number with its limit: a reading passes when it is at
    most its limit."""
    out = {}
    for name, limit in limits.items():
        value = readings.get(name)
        ok = value is not None and value <= limit
        out[name] = {"value": value, "limit": limit, "ok": bool(ok)}
    return out
