"""Device idle time per update under each part of the training step: the
idle time in the traced window (the complement of the device's busy
intervals) that lies in the union of the program's spans of the part
(``promptttspp_tpu_torch/utils/trace.py``), over the ``train.step`` spans
that start in the window, in ms.

``train_idle_ms.forward`` reads ``train.forward`` (the generator,
``zero_grad``, the forward pass), ``.backward`` ``train.backward`` and
``.optimizer`` ``train.optimizer`` (norm, clip, AdamW). With the first,
the sum over the three parts times the updates is printed on stderr
beside the breakdown's idle under the benchmark's ``train_step`` span.
"""

from perfbench.metrics import program_spans

PARTS = ("forward", "backward", "optimizer")


def read(run, name):
    part = name.split(".", 1)[1]
    value = program_spans.idle_ms_per(run, f"train.{part}", "train.step")
    if value is not None and part == PARTS[0]:
        program_spans.report(run, "train_idle_ms",
                             [f"train.{p}" for p in PARTS], "train.step",
                             ("train_step",))
    return value
