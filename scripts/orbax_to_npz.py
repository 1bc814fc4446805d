"""Convert an orbax checkpoint of the JAX trainer into a flat ``.npz``
that the PyTorch port serves.

Usage:
    python scripts/orbax_to_npz.py <ckpt dir> <out.npz>

The JAX trainer writes ``{epoch, step, params, batch_stats, opt_state}``
as one orbax PyTree (``promptttspp_tpu/train/checkpoint.py``, e.g.
``ckpt/last``). This restores it without a template and writes every leaf
of ``params`` and ``batch_stats`` under its ``/``-joined path
(``params/encoder/.../kernel``); ``opt_state``, ``epoch`` and ``step`` are
dropped, so the file serves and warm-starts but does not resume an
optimizer. The port reads it with ``model_ckpt=<out.npz>``
(``promptttspp_tpu_torch/compat/torch_ckpt.py::torch_state_dict``).
It imports only orbax, flax and numpy.
"""

import sys
from pathlib import Path

import numpy as np
import orbax.checkpoint as ocp
from flax import traverse_util

KEPT = ("params", "batch_stats")


def convert(ckpt_dir, out_path) -> int:
    """Write ``out_path``; returns the number of arrays written."""
    tree = ocp.PyTreeCheckpointer().restore(Path(ckpt_dir).absolute())
    missing = [k for k in KEPT[:1] if k not in tree]
    if missing:
        raise ValueError(f"{ckpt_dir}: no {missing} in the checkpoint "
                         f"(keys {sorted(tree)})")
    flat = {}
    for key in KEPT:
        for path, leaf in traverse_util.flatten_dict(
                tree.get(key) or {}).items():
            flat["/".join((key,) + tuple(str(p) for p in path))] = \
                np.asarray(leaf)
    np.savez(out_path, **flat)
    return len(flat)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        raise SystemExit(__doc__)
    n = convert(*argv)
    print(f"wrote {n} arrays (params, batch_stats) to {argv[1]}")


if __name__ == "__main__":
    main()
