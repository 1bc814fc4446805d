"""The knee of an open-loop serving cell, found once on the chip: the
highest arrival rate the system sustains without a growing backlog.

    python3 perfbench/sweep.py --workload serve_online_b1 \
        --rates 2,2.5,3,3.5,4 --seconds 20 --seed 7

One set-up (the cell's ``Synthesizer``, warmed for every shape of the
traffic); then, for each rate in turn, the cell's open loop
(``traffic/open_loop.py``) for ``--seconds``. A rate is sustained where
no request failed, the backlog when arrivals stop (requests due and not
yet on the host) is at most ``BACKLOG``, and the median latency of the
last third of the requests is at most ``GROWTH`` times that of the first
third.
Prints one JSON line per rate and the knee; the cell's rate is about four
fifths of it (``workloads/<cell>.json``'s ``rate_per_s``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT

from perfbench.harness import cell as cells  # noqa: E402
from perfbench.harness import serving  # noqa: E402
from perfbench.harness.run import Run  # noqa: E402
from perfbench.traffic import open_loop, requests  # noqa: E402

GROWTH, BACKLOG = 2.0, 3


def sweep(spec, rates, seconds, seed, device="cuda", emit=print):
    run = Run(spec, seed, seconds, False, time.perf_counter(), device)
    server = serving.Server(run)
    n_max = max(1, int(round(max(rates) * seconds)))
    server.warm([[r] for r in requests.serving_requests(run.params, seed,
                                                        n_max)])
    rows = []
    for rate in rates:
        run = Run(spec, seed, seconds, False, time.perf_counter(), device)
        n = max(1, int(round(rate * seconds)))
        reqs = requests.serving_requests(run.params, seed, n)
        gaps = requests.poisson_gaps(run.params, rate, n, seed, seconds)
        recs, wall = open_loop.serve(run, server, reqs, gaps, seconds)
        lat = open_loop.latencies_ms(recs)
        third = max(1, len(lat) // 3)
        first, last = np.median(lat[:third]), np.median(lat[-third:])
        stop = recs[0]["due"] + seconds if recs else 0.0
        backlog = sum(1 for r in recs
                      if r["done"] is None or r["done"] > stop)
        row = dict(rate_per_s=rate, requests=len(recs), failed=run.failed,
                   p50_ms=float(np.percentile(lat, 50)),
                   p95_ms=float(np.percentile(lat, 95)),
                   first_third_p50_ms=float(first),
                   last_third_p50_ms=float(last), backlog=backlog,
                   window_s=float(wall),
                   queue_wait_p50_ms=float(np.median(
                       [(r["disp"] - r["due"]) * 1e3 for r in recs])),
                   sustained=bool(
                       run.failed == 0 and last <= GROWTH * first
                       and backlog <= BACKLOG))
        rows.append(row)
        emit(json.dumps(row))
    ok = [r["rate_per_s"] for r in rows if r["sustained"]]
    knee = max(ok) if ok else None
    emit(json.dumps({"knee_per_s": knee,
                     "four_fifths_per_s": None if knee is None
                     else 0.8 * knee}))
    return rows, knee


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="serve_online_b1")
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    spec = cells.load(args.workload)
    if spec["cell"]["driver"] != "open_loop":
        raise SystemExit(f"{args.workload} is not an open-loop cell")
    sweep(spec, [float(r) for r in args.rates.split(",")], args.seconds,
          args.seed, emit=lambda line: print(line, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
