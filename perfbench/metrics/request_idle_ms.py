"""Device idle time per request under each layer of the program's
serving path: the idle time in the traced window (the complement of the
device's busy intervals) that lies in the union of the program's spans of
the layer (``promptttspp_tpu_torch/utils/trace.py``), over the
``synth.request`` spans that start in the window, in ms.

``request_idle_ms.inputs`` reads ``synth.inputs`` (padding, staging, the
host-to-device copies), ``.acoustic`` ``synth.acoustic`` (``infer_cond``),
``.decode`` ``synth.decode`` (the graph replay), ``.vocoder``
``synth.vocoder`` (F0 post-processing and the vocoder) and ``.readback``
``synth.readback`` (the readback and the split in ``result()``). With the
first, the sum over the five parts times the requests is printed on
stderr beside the breakdown's idle under the benchmark's ``dispatch`` and
``result`` spans.
"""

from perfbench.metrics import program_spans

PARTS = ("inputs", "acoustic", "decode", "vocoder", "readback")


def read(run, name):
    part = name.split(".", 1)[1]
    value = program_spans.idle_ms_per(run, f"synth.{part}", "synth.request")
    if value is not None and part == PARTS[0]:
        program_spans.report(run, "request_idle_ms",
                             [f"synth.{p}" for p in PARTS], "synth.request",
                             ("dispatch", "result"))
    return value
