"""The fused attention kernel's share of its roofline in the traced
window: the attention FLOPs of the decodes replayed in it (the program's
``f5.attn_flops`` counters, 4 B' H T^2 d over every block of every step at
the launched shapes) at the tensor cores' dense fp16 peak, over the device
time of the attention kernels of those decodes.

A replay's counters are recorded when it is launched, so the traced
window holds the whole of each replay launched in it (the trace closes
after the device has finished) and perhaps the tail of one launched
before. The reader keeps the last launches of the attention kernel, as
many as the counted replays run (``decode.blocks_run`` / 2: one call a
block of a guided pair's doubled batch), and their device time.
"""

import sys

from perfbench.costs import peaks
from perfbench.metrics import program_spans

# scaled_dot_product_attention's kernels: cuDNN's (``..._sdpa_sm90_flash_
# fprop_...``, which PyTorch picks for a masked float16 call on the H100),
# the memory-efficient CUTLASS ``fmha`` one, flash
KERNELS = ("_sdpa_", "flash_fprop", "fmha", "flash_fwd",
           "efficient_attention")


def read(run, name):
    tr = run.trace
    rec = program_spans.recorded() if tr is not None else None
    if rec is None:
        return None
    lo, hi = tr.window_ns
    flops = calls = 0
    for c in rec[1]:
        if lo <= c.t_ns < hi:
            if c.name == "f5.attn_flops":
                flops += c.n
            elif c.name == "decode.blocks_run":
                calls += c.n // 2
    launches = sorted((s, e) for n, s, e in
                      zip(tr.names, tr.starts, tr.ends)
                      if any(k in n for k in KERNELS))
    names = sorted({n for n in tr.names if any(k in n for k in KERNELS)})
    print(f"{name}: {len(launches)} attention launches in the trace "
          f"({names[:3]}), {calls} counted", file=sys.stderr)
    if flops == 0 or calls == 0 or len(launches) < calls:
        return None
    spent = sum(e - s for s, e in launches[-calls:]) * 1e-9
    return 100.0 * flops / peaks.BF16_TC_FLOP_PER_S / spent
