"""K2-bf16's share of its roofline in the traced window: the least time
its launches could take (``costs/kernels.py::k2_bf16_bound``, each
AMPLayer's largest of bytes, bf16 mix and float32 work, at the shape the
vocoder ran: the batch and its frame bucket) over the device time of
``amp_layer_wgmma.cu``'s kernels (``aa_conv_wgmma_kernel``), both over the
same batches: those whose every launch lies in the trace.

Batches run on one stream in dispatch order and the trace closes after
the device has finished every batch dispatched before it closed, so the
trace's launches are the tail of the batch in flight when it opened (if
any) followed by whole batches of ``vocoder_k2_launches`` each. The
reader keeps the last whole batches' launches and the bounds of the last
batches dispatched before the trace closed, as many of each.
"""

import sys

from perfbench.costs.kernels import (vocoder_k2_bf16_bound_s,
                                     vocoder_k2_launches)
from perfbench.harness.serving import shape_key

KERNEL = "aa_conv_wgmma_kernel"


def read(run, name):
    tr = run.trace
    batches = run.values.get("batches")
    if tr is None or not batches:
        return None
    lo, hi = tr.window_ns
    launches = sorted((s, e) for n, s, e in
                      zip(tr.names, tr.starts, tr.ends)
                      if KERNEL in n and e > lo and s < hi)
    voc = run.config["vocoder"]
    per_batch = vocoder_k2_launches(voc)
    traced = sorted((b for b in batches if b["t_disp"] <= tr.t1),
                    key=lambda b: b["t_disp"])
    whole = min(len(launches) // per_batch, len(traced))
    print(f"{name}: {len(launches)} launches in the trace, {whole} whole "
          f"batches of {per_batch} of the {len(traced)} dispatched before "
          f"it closed", file=sys.stderr)
    if whole == 0:
        return None
    spent = sum(min(e, hi) - max(s, lo)
                for s, e in launches[-whole * per_batch:]) * 1e-9
    bound = 0.0
    for b in traced[-whole:]:
        B, _, frames, _ = shape_key(run.config, b["reqs"])
        bound += vocoder_k2_bf16_bound_s(voc, B, frames)
    return 100.0 * bound / spent
