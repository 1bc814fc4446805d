"""Time variants of kernel K2-bf16 (``csrc/amp_layer_wgmma.cu``, the
serving path's, with ``--kernel wgmma``) or of the ``mma.sync`` K2
(``csrc/amp_layer_tc.cu``: its earlier K2-bf16 or, with ``--mix tf32x3``,
the float32 K2) at the 36 AMPLayer shapes of a 640-frame request, on one
GPU. From the repository root:

    python3 -m promptttspp_tpu_torch.tools.k2_variants \
        [--kernel tc|wgmma] [--mix bf16|tf32x3] [--only a,b]

A variant is the committed source with literal text replacements, each of
which must match once, and, for ``--kernel wgmma``, another plan
(``ops/kernels/amp.py::wgmma_plan``) for the same compiled source.

``--kernel wgmma``: ``aa_only`` skips the mix's ``wgmma``s and the
epilogue (the consumers still take and hand back each A buffer and weight
chunk), ``mix_only`` skips AA (the producers still hand over each A
buffer, unwritten); ``split_<NWG>_<MT>_<PW>`` runs the compiled
configuration of NWG consumer warpgroups of MT m64 tiles and PW producer
warps (``amp.WGMMA_CONFIGS``; every one of them is timed when ``--only``
is not given) at each C whose N has it, the plan's own elsewhere;
``one_pass_c256`` runs C = 256 as one pass of 256 output channels (AA
once per tile) instead of two of 128; ``run24`` and ``run32`` give the
plan's configurations AA runs of 24 or 32 samples instead of 16;
``mma_sync`` times the earlier K2-bf16 (``amp_layer_tc.cu``,
``amp_aa_conv_tc``) beside them.

``--kernel tc`` (the default): ``aa_only`` skips the channel mix and its
epilogue, ``mix_only`` skips AA (phase 1); ``one_pass_c256`` gives a C=256
block all 256 output channels instead of 128; ``run8`` and ``run24``
change the AA run length R from 16; ``stages4`` streams the weights four
chunks deep instead of three; ``bounds_1`` drops the launch bounds'
minimum of blocks per SM. The ``tf32_*`` variants change only the float32
K2's tiling: ``tf32_mt2_c128`` gives its warps two m16 tiles from C=128 on
(instead of 256), ``tf32_kc64`` streams its weights in chunks of 64 input
channels at every C (instead of only at C=64), ``tf32_min1`` asks for one
block per SM in its launch bounds (no register cap); ``one_acc`` sums all
of a layer's TF32 products in one accumulator instead of one per weight
chunk. Each edit applies to both precisions' source; ``--mix`` picks the
entry point that is timed.

Each variant is built with nvcc (all at once) into ``build/k2_variants/``
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


# --kernel wgmma: name -> ([(old, new), ...], wgmma_plan keywords at C,
# equal to the committed kernel bit for bit); split_<NWG>_<MT>_<PW> (see
# wgmma_variant) are made on demand
WGMMA_VARIANTS = {
    "committed": ([], lambda C: {}, True),
    "aa_only": ([("            wgmma_ss<N>(acc[m], desc(a_k + m * 64 * 16, "
                  "a_lbo, 128), bd);",
                  "            (void)bd;"),
                 ("      if (co >= p.C) continue;",
                  "      if (co >= 0) continue;")], lambda C: {}, False),
    "mix_only": ([("for (int run = first; run < n_runs; run += NPROD) {",
                   "for (int run = first; run < 0; run += NPROD) {")],
                 lambda C: {}, False),
    "one_pass_c256": ([], lambda C: {"n": 256} if C > 128 else {}, True),
    "run24": ([(f"X({cfg}, 16)", f"X({cfg}, 24)") for cfg in
               ("32, 2, 2, 2, 15", "64, 4, 2, 1, 15", "128, 4, 1, 1, 15")],
              lambda C: {}, True),
    "run32": ([(f"X({cfg}, 16)", f"X({cfg}, 32)") for cfg in
               ("32, 2, 2, 2, 15", "64, 4, 2, 1, 15", "128, 4, 1, 1, 15")],
              lambda C: {}, True),
    # the mma.sync K2-bf16 (amp_layer_tc.cu's amp_aa_conv_tc) as it is
    "mma_sync": (None, None, True),
}


def _split(name):
    """split_<NWG>_<MT>_<PW> -> its split as a plan override: at each C
    whose N has that compiled configuration, else the plan's own."""
    nwg, mt, pw = (int(v) for v in name.split("_")[1:])

    def plan_kw(C):
        n, _, _, ks = k2._wgmma_shape(C)
        return ({"split": (nwg, mt, pw)}
                if (n, ks, nwg, mt, pw) in k2.WGMMA_CONFIGS else {})
    return [], plan_kw, True


def wgmma_variant(name):
    return WGMMA_VARIANTS[name] if name in WGMMA_VARIANTS else _split(name)


# --mix -> (entry point, weight layout) of --kernel tc
MIXES = {"bf16": ("amp_aa_conv_tc", k2.kernel_weight_bf16),
         "tf32x3": ("amp_aa_conv_tf32x3", k2.kernel_weight_tf32x3)}
# --kernel -> (source, variants)
SOURCES = {"tc": ("amp_layer_tc", VARIANTS),
           "wgmma": ("amp_layer_wgmma", WGMMA_VARIANTS)}


def build(names, entry, kernel="tc"):
    """Build each variant of ``kernel``'s source (one nvcc each, all at
    once; a variant without text edits shares the committed build) ->
    name -> its entry point ``entry``."""
    source, variants = SOURCES[kernel]
    if kernel == "wgmma":
        variants = {name: wgmma_variant(name) for name in names}
    src = (_build.CSRC / f"{source}.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs, alias = {}, {}
    for name in names:
        if variants[name][0] is None:  # not a build of this source
            continue
        if not variants[name][0] and name != "committed":
            alias[name] = "committed"
            continue
        text = src
        for old, new in variants[name][0]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} does not match "
                                 "once")
            text = text.replace(old, new)
        cu = OUT / f"{source}-{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(OUT / f"{source}-{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if alias and "committed" not in procs:
        raise SystemExit("variants without text edits need 'committed'")
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = [line.strip() for line in log.splitlines()
                  if "spill" in line and not line.strip().startswith(
                      "0 bytes stack frame")]
        print(f"{name}: built; spills {spills or 'none'}", flush=True)
        lib = ctypes.CDLL(str(OUT / f"{source}-{name}.so"))
        fn = getattr(lib, entry)
        if kernel == "wgmma":
            k2.wgmma_argtypes(fn)
        else:
            fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = fn
    for name, target in alias.items():
        libs[name] = libs[target]
    return libs


def wgmma_call(fn, variant, x, alpha, w, b, d):
    """The first launch of an AMPLayer (no residual) by the K2-bf16 entry
    point ``fn`` under ``variant``'s plan -> (call, y): ``call()`` launches
    into ``y`` and returns the launch's error code."""
    C, k = x.shape[-1], w.shape[-1]
    plan = k2.wgmma_plan(C, k, d, **wgmma_variant(variant)[1](C))
    w_k = k2.wgmma_weight(w, plan["n"], plan["cp"])
    y = torch.empty_like(x)
    args = k2.wgmma_args(x, alpha, w_k, b, None, y, d, plan, k)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    return (lambda: fn(*args, stream)), y


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
    ap.add_argument("--kernel", choices=sorted(SOURCES), default="tc",
                    help="the source whose variants are timed (default: "
                    "tc, the mma.sync kernel)")
    ap.add_argument("--mix", choices=sorted(MIXES), default="bf16",
                    help="the precision timed with --kernel tc (default: "
                    "bf16)")
    ap.add_argument("--only", default="",
                    help="comma-separated variants (default: all)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k2_variants: needs a CUDA GPU", file=sys.stderr)
        return 1
    variants = SOURCES[args.kernel][1]
    names = [n for n in args.only.split(",") if n] or list(variants)
    if args.kernel == "wgmma":
        if not args.only:
            names += sorted({f"split_{nwg}_{mt}_{pw}"
                             for _, _, nwg, mt, pw in k2.WGMMA_CONFIGS})
        variants = {name: wgmma_variant(name) for name in names
                    if name in variants or name.startswith("split_")}
    unknown = sorted(set(names) - set(variants))
    if unknown:
        ap.error(f"unknown variants of --kernel {args.kernel}: {unknown}")
    if "committed" not in names:
        names.insert(0, "committed")
    gpu = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    wgmma = args.kernel == "wgmma"
    print(f"[{gpu}] torch {torch.__version__}; kernel {args.kernel}"
          + ("" if wgmma else f", mix {args.mix}"), flush=True)
    torch.backends.cudnn.allow_tf32 = False  # a float32 plain version
    entry, layout = (("amp_aa_conv_wgmma", None) if wgmma
                     else MIXES[args.mix])
    libs = build(names, entry, args.kernel)
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
                w_k = None if wgmma else layout(w)
                plain = conv1d_same(antialias_snake_plain(x, alpha), w, b, d)
                ref, row = None, []
                for name in names:
                    if name == "mma_sync":
                        y = torch.empty_like(x)
                        w_tc = k2.kernel_weight_bf16(w)
                        call = lambda: k2._tc_lib().amp_aa_conv_tc(
                            x.data_ptr(), alpha.data_ptr(), w_tc.data_ptr(),
                            b.data_ptr(), None, y.data_ptr(), 1, T, C, k, d,
                            ctypes.c_void_p(stream))
                    elif wgmma:
                        call, y = wgmma_call(libs[name], name, x, alpha, w,
                                             b, d)
                    else:
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
                    elif variants[name][-1] and not torch.equal(y, ref):
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
