"""Time variants of kernel K2 (``csrc/amp_layer_tc.cu``), K2-bf16 or the
float32 K2 (3xTF32), at the 36 AMPLayer shapes of a 640-frame request, on
one GPU. From the repository root:

    python3 -m promptttspp_tpu_torch.tools.k2_variants [--mix tf32x3] \
        [--only a,b]

A variant is the committed source with literal text replacements, each of
which must match once: ``aa_only`` skips the channel mix and its epilogue,
``mix_only`` skips AA (phase 1); ``one_pass_c256`` gives a C=256 block all
256 output channels instead of 128; ``run8`` and ``run24`` change the AA
run length R from 16; ``stages4`` streams the weights four chunks deep
instead of three; ``bounds_1`` drops the launch bounds' minimum of blocks
per SM. The ``tf32_*`` variants change only the float32 K2's tiling:
``tf32_mt2_c128`` gives its warps two m16 tiles from C=128 on (instead of
256), ``tf32_kc64`` streams its weights in chunks of 64 input channels at
every C (instead of only at C=64), ``tf32_min1`` asks for one block per SM
in its launch bounds (no register cap); ``one_acc`` sums all of a layer's
TF32 products in one accumulator instead of one per weight chunk. Each edit
applies to both precisions' source; ``--mix`` picks the entry point that
is timed. Each is built with nvcc (all at once) into ``build/k2_variants/``
and run as the first launch of an AMPLayer (no residual) at every shape,
with weights of gain at most 1, timed with CUDA events (mean of 20
launches after one), and held against the launch's float32 plain version
(the largest abs error over the shapes is printed). A variant whose sums
keep their order must equal the committed kernel bit for bit. Prints the
times by shape, by stage and in total.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import subprocess
import sys
from pathlib import Path

import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.ops.kernels import _build
from promptttspp_tpu_torch.nn.layers import conv1d_same
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.ops.kernels.snake import antialias_snake_plain

OUT = _build.BUILD_DIR.parent / "k2_variants"
# name -> ([(old, new), ...], equal to the committed kernel bit for bit)
VARIANTS = {
    "committed": ([], True),
    "aa_only": ([("  for (int j = 0; j < k; ++j) {\n    for (int c = 0;",
                  "  for (int j = 0; j < 0; ++j) {\n    for (int c = 0;"),
                 ("    if (co >= C) continue;", "    if (co >= 0) continue;")],
                False),
    "mix_only": ([("item < C * n_runs;", "item < 0;")], False),
    "one_pass_c256": ([("constexpr int TWO_PASS_CP = 256;",
                        "constexpr int TWO_PASS_CP = 1 << 30;")], True),
    "run8": ([("constexpr int R = 16;", "constexpr int R = 8;")], True),
    "run24": ([("constexpr int R = 16;", "constexpr int R = 24;")], True),
    "stages4": ([("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 4;")],
                True),
    "bounds_1": ([("__launch_bounds__(THREADS, Mix::min_blocks(MT, NT))",
                   "__launch_bounds__(THREADS)")], True),
    "tf32_mt2_c128": ([("  static constexpr int MT2_CP = 256;",
                        "  static constexpr int MT2_CP = 128;")], True),
    "tf32_kc64": ([("  static constexpr int KC64_CP = 64;",
                    "  static constexpr int KC64_CP = 256;")], False),
    "tf32_min1": ([("return mt == 2 ? 1 : (nt <= 4 ? 3 : 2);", "return 1;")],
                  True),
    "one_acc": ([("auto& sum = Mix::TF32X3 ? part : acc;",
                  "auto& sum = acc;")], False),
}


# --mix -> (entry point, weight layout)
MIXES = {"bf16": ("amp_aa_conv_tc", k2.kernel_weight_bf16),
         "tf32x3": ("amp_aa_conv_tf32x3", k2.kernel_weight_tf32x3)}


def build(names, entry):
    src = (_build.CSRC / "amp_layer_tc.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} does not match "
                                 "once")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(OUT / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith(
                      "0 bytes stack frame")]
        print(f"{name}: built; spills {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        libs[name] = fn
    return libs


def cuda_ms(fn, iters=20):
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mix", choices=sorted(MIXES), default="bf16",
                    help="the precision timed (default: bf16)")
    ap.add_argument("--only", default="",
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    names = [n for n in args.only.split(",") if n] or list(VARIANTS)
    if "committed" not in names:
        names.insert(0, "committed")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[{gpu}] torch {torch.__version__}; mix {args.mix}", flush=True)
    torch.backends.cudnn.allow_tf32 = False  # a float32 plain version
    entry, layout = MIXES[args.mix]
    libs = build(names, entry)
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    randn = lambda *s: torch.randn(s, generator=g, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    total = {n: 0.0 for n in names}
    worst = {n: 0.0 for n in names}
    by_stage = {}
    T = 640
    cfg = flagship.VOCODER
    for i, u in enumerate(cfg["upsample_rates"]):
        T *= u
        C = cfg["upsample_initial_channel"] // 2 ** (i + 1)
        for k, dils in zip(cfg["resblock_kernel_sizes"],
                           cfg["resblock_dilations"]):
            for d in dils:
                x = 0.3 * randn(1, T, C)
                alpha, b = 0.2 * randn(C), 0.1 * randn(C)
                w = min(0.05, 1 / math.sqrt(k * C)) * randn(C, C, k)
                w_k = layout(w)
                plain = conv1d_same(antialias_snake_plain(x, alpha), w, b, d)
                ref, row = None, []
                for name in names:
                    y = torch.empty_like(x)
                    call = lambda: libs[name](
                        x.data_ptr(), alpha.data_ptr(), w_k.data_ptr(),
                        b.data_ptr(), None, y.data_ptr(), 1, T, C, k, d,
                        ctypes.c_void_p(stream))
                    err = call()
                    torch.cuda.synchronize()
                    if err:
                        raise SystemExit(f"{name}: CUDA error {err}")
                    note = ""
                    worst[name] = max(worst[name],
                                      (y - plain).abs().max().item())
                    if name == "committed":
                        ref = y.clone()
                    elif VARIANTS[name][1] and not torch.equal(y, ref):
                        note = " NOT EQUAL"
                    ms = cuda_ms(call)
                    total[name] += ms
                    by_stage[(name, C)] = by_stage.get((name, C), 0.0) + ms
                    row.append(f"{name} {ms * 1e3:.1f}{note}")
                print(f"C={C} T={T} k={k} d={d} (us): " + ", ".join(row),
                      flush=True)
    for name in names:
        stages = ", ".join(f"C={C} {v:.4f}" for (n, C), v in by_stage.items()
                           if n == name)
        print(f"[{gpu}] {name}: 36 first launches {total[name]:.4f} ms "
              f"({stages} ms per stage); max abs err against the float32 "
              f"plain version {worst[name]:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
