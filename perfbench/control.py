"""The readings the limits of a cell's comparison are set from, on the
chip, in one process (not run by the benchmark's own runs):

    python3 perfbench/control.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 --seconds 6 [--out FILE]

- the program: for every seed of ``--seeds``, a run of the cell's timed
  path (a window of ``--seconds``) and its comparison with the reference,
  as ``run.py`` makes it; a serving cell's set-up is made once and its
  weights refilled for each seed;
- the control: for every seed of ``--control-seeds``, the reference put
  in the program's place and computed in the nearest precision below the
  configuration's (TF32 for its float32, fp8 e4m3 for the vocoder's bf16
  channel mix), compared with the reference as the program is, on the
  requests or updates a run of that seed compares;
- for a training cell also the fault of half of each batch left out (the
  loss the mean over the first half of the rows), in the program's place.

Prints one JSON line per reading and a summary: per number, the largest
program reading (the lower reading) and the smallest control and fault
readings (the upper candidates).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness.run import Run  # noqa: E402


def serve_readings(spec, seeds, control_seeds, seconds, device, emit):
    from perfbench.harness import serving
    from perfbench.reference import judge, serve

    driver = cells.driver(spec["cell"]["driver"])
    server = None
    checked = {}
    for seed in seeds:
        run = Run(spec, seed, seconds, False, time.perf_counter(), device)
        if server is None:
            server = serving.Server(run)
        else:
            server.reseed(seed)
        driver.window(run, server)
        checked[seed] = driver.checked(run)[0]
        driver.check(run)
        emit(dict(seed=seed, kind="program", gaps={
            k: c["value"] for k, c in run.checks.items()}))
    server.close()
    server = None
    cfg = spec["config"]
    mix = cfg["precision"]["vocoder_mix"] if device == "cuda" else "float32"
    low = "float8_e4m3fn" if device == "cuda" else "float32"
    for seed in control_seeds:
        batches = checked[seed]
        ref = serve.outputs(cfg, seed, batches, device, "ieee", mix)
        ctl = serve.outputs(cfg, seed, batches, device, "tf32", low)
        emit(dict(seed=seed, kind="control",
                  gaps=judge.serve_gaps(ctl, ref)))


def train_readings(spec, seeds, control_seeds, seconds, device, emit):
    import shutil

    from perfbench.harness import training
    from perfbench.reference import judge
    from perfbench.reference import train as reference
    from perfbench.traffic import corpus

    driver = cells.driver(spec["cell"]["driver"])
    cfg = spec["config"]
    for seed in seeds:
        run = Run(spec, seed, seconds, False, time.perf_counter(), device)
        run.values["checked_updates_only"] = True
        driver.run(run)
        driver.check(run)
        emit(dict(seed=seed, kind="program", gaps={
            k: c["value"] for k, c in run.checks.items()}))
    p = spec["cell"]["params"]
    root = training.corpus_root()
    for seed in control_seeds:
        cands, spk = corpus.candidates()
        rows = corpus.training_rows(p["utterances"], cands, spk,
                                    p["phones"], p["frames_per_phone"],
                                    seed=seed)
        corpus.write_training_corpus(root, rows, cands, spk, seed=seed,
                                     mel_mean=cfg["mel_stats"]["mean"],
                                     mel_std=cfg["mel_stats"]["std"])
        ref = reference.readings(cfg, seed, root, device, "ieee")
        ctl = reference.readings(cfg, seed, root, device, "tf32")
        emit(dict(seed=seed, kind="control", gaps=judge.train_gaps(ctl, ref)))
        half = reference.readings(cfg, seed, root, device, "ieee",
                                  half_rows=True)
        emit(dict(seed=seed, kind="fault_half_batch",
                  gaps=judge.train_gaps(half, ref)))
    shutil.rmtree(root, ignore_errors=True)


def summary(lines):
    out = {}
    for line in lines:
        for k, v in line["gaps"].items():
            slot = out.setdefault(k, {})
            if line["kind"] == "program":
                slot["lower"] = max(slot.get("lower", 0.0), v)
            else:
                key = f"{line['kind']}_min"
                slot[key] = min(slot.get(key, float("inf")), v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
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
        text = json.dumps(line)
        print(text, flush=True)
        if sink:
            sink.write(text + "\n")
            sink.flush()

    kind = spec["config"]["kind"]
    fn = serve_readings if kind == "serve" else train_readings
    fn(spec, seeds, control, args.seconds, args.device, emit)
    print(json.dumps({"workload": args.workload,
                      "summary": summary(lines)}), flush=True)
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
