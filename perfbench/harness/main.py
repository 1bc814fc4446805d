"""The run of one cell: arguments, device checks, the driver's set-up and
window, the comparison with the reference, the metrics and the result.

Exit codes: 0 with a result; 2 without a card, or with fewer cards than
the cell asks for; 3 where the run loaded JAX, flax or the JAX package; 1
on any other failure. Only a run that exits 0 prints a result.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import os
import sys
import time
import traceback

from perfbench.harness import cell as cells
from perfbench.harness.run import Run

FORBIDDEN = ("jax", "jaxlib", "flax", "promptttspp_tpu")


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the loaded
    modules), each compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names
                   if m.split(".")[0] in FORBIDDEN})


def process_start(fallback: float) -> float:
    """The perf_counter time at which this process started (from
    /proc/self/stat), or ``fallback``."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        if 0.0 <= age < 60.0:
            return time.perf_counter() - age
    except (OSError, ValueError, IndexError):
        pass
    return fallback


def parse(argv):
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def check_device(chips: int):
    """-> the device name; raises SystemExit(2) without enough cards."""
    import torch

    if not torch.cuda.is_available():
        print("perfbench: torch.cuda.is_available() is False; no result",
              file=sys.stderr)
        raise SystemExit(2)
    if torch.cuda.device_count() < chips:
        print(f"perfbench: the cell needs {chips} cards, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        raise SystemExit(2)
    return torch.cuda.get_device_name(0)


def metrics(run: Run, trace: bool):
    """The cell's end-to-end metrics (``--trace 0``) or per-layer metrics
    (``--trace 1``) as {name: {"value", "unit"}}."""
    out = {}
    if not trace:
        for m in run.spec["metrics"]["end_to_end"]:
            name = m["name"]
            value = run.setup_s if name == "setup_s" else run.e2e.get(name)
            if value is None:
                raise RuntimeError(f"the driver measured no {name}")
            out[name] = {"value": value, "unit": m["unit"]}
        return out
    for m in run.spec["metrics"]["per_layer"]:
        value = cells.reader(m["name"])(run, m["name"])
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def execute(run: Run, driver):
    """The driver's set-up and window, then the comparison with the
    reference (after the driver has read the memory peak and freed the
    program's state)."""
    driver.run(run)
    gc.collect()
    if run.device == "cuda":
        import torch

        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    driver.check(run)
    print(f"check against the reference: {time.perf_counter() - t0:.1f} s",
          file=sys.stderr)


def result(run: Run, kind: str, count: int):
    device = {"platform": "gpu" if run.device == "cuda" else "cpu",
              "kind": kind, "count": count,
              "memory_peak_bytes": int(run.memory_peak_bytes)}
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed,
           "metrics": metrics(run, run.trace_on), "device": device}
    if run.trace_on:
        tr = run.trace
        if tr is None:
            raise RuntimeError("the traced window was never closed")
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        print(f"trace: {tr.window_s:.3f} s window, {len(tr.starts)} device "
              f"operations, {tr.inside():.4f} of their time inside the "
              f"window, launches {tr.launches}", file=sys.stderr)
        out["breakdown"] = {"device_ops": tr.device_ops(),
                            "idle_gaps": tr.idle_gaps()}
    out["checks"] = run.checks
    return out


def main(argv, t_start: float) -> int:
    args = parse(argv)
    t_start = process_start(t_start)
    try:
        spec = cells.load(args.workload)
        driver = cells.driver(spec["cell"]["driver"])
        import torch  # noqa: F401  (after the cache directories are set)
        kind = check_device(spec["entry"]["chips"])
        run = Run(spec, args.seed, args.seconds, bool(args.trace), t_start)
        execute(run, driver)
        found = forbidden_modules()
        if found:
            print(f"perfbench: the run loaded {found}; no result",
                  file=sys.stderr)
            return 3
        out = result(run, kind, spec["entry"]["chips"])
    except SystemExit as e:
        return int(e.code or 1)
    except Exception:
        traceback.print_exc()
        return 1
    for name, c in run.checks.items():
        ok = c["value"] <= c["limit"] and not math.isnan(c["value"])
        print(f"check {name}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if ok else 'FAILED'}", file=sys.stderr)
    print(json.dumps(out))
    sys.stdout.flush()
    return 0
