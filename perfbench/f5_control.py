"""The readings the limits of the F5-TTS cell's comparison are set from,
on the chip, in one process (not run by the benchmark's own runs):

    python3 perfbench/f5_control.py --seeds 1,2,... --control-seeds 1,2,3 \
        --seconds 6 [--workload f5tts_offline_b16] [--out FILE]

- the program: for every seed of ``--seeds``, a window of ``--seconds``
  of the cell's timed path and its comparison with the reference, as
  ``run.py`` makes it (one set-up, the weights refilled for each seed);
- the control: for every seed of ``--control-seeds``, the reference with
  its DiT in bfloat16, the nearest precision below the configuration's
  float16, in the program's place, compared with the float32 reference on
  the requests that seed's run compared.

Prints one JSON line per reading and a summary: per number, the largest
program reading and the smallest control reading.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from perfbench.control import summary  # noqa: E402
from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness.run import Run  # noqa: E402


def readings(spec, seeds, control_seeds, seconds, device, emit):
    import torch

    from perfbench.harness import f5_serving
    from perfbench.reference import f5_serve, judge
    from perfbench.traffic import f5_batches

    server, kept = None, {}
    for seed in seeds:
        run = Run(spec, seed, seconds, False, time.perf_counter(), device)
        if server is None:
            server = f5_serving.Server(run)
        else:
            server.reseed(seed)
        f5_batches.window(run, server)
        f5_batches.check(run)
        if seed in control_seeds:
            kept[seed] = run.values["checked"]
        emit(dict(seed=seed, kind="program", gaps={
            k: c["value"] for k, c in run.checks.items()}))
        if device == "cuda":
            torch.cuda.empty_cache()
    server.close()
    for seed in control_seeds:
        batches, ref = kept[seed]
        ctl = f5_serve.outputs(spec["config"], seed, batches, device,
                               spec["config"]["precision"]["control_dit"])
        emit(dict(seed=seed, kind="control",
                  gaps=judge.serve_gaps(ctl, ref)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="f5tts_offline_b16")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=6.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    spec = cells.load(args.workload)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    control = [int(s) for s in args.control_seeds.split(",") if s]
    if any(s not in seeds for s in control):
        raise SystemExit("every control seed must be among --seeds")
    lines = []
    sink = open(args.out, "a") if args.out else None

    def emit(line):
        lines.append(line)
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()

    readings(spec, seeds, control, args.seconds, args.device, emit)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(lines)}), flush=True)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
