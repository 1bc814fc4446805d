"""Time kernel K3 (``csrc/amp_block.cu``) under other plans and builds
than its own at the 12 AMPBlock shapes of a 640-frame request, on one GPU,
beside the chain of three K2 launches of the same precision. From the
repository root:

    python3 -m promptttspp_tpu_torch.tools.k3_variants \\
        [--variants committed,...] [--plans auto,g,g128,...] [--bf16-only]

A plan overrides the kernel's own choices (``make_plan``): ``auto`` (its
own), ``g`` (X and H in the global scratch, its tile), ``g<TT>`` (the
scratch, tiles of TT samples), ``s`` (shared memory, the largest tile) or
``s<TT>``, each optionally followed by ``r`` (a stage's weights resident)
or ``w`` (streamed), by ``x1`` or ``x2`` (one block per tile, or a
cluster of two sharing out its output passes), by ``k<G>`` (G weight
chunks per slot of the ring) and by ``a1`` or ``a2`` (A buffers: one, or
two, the bf16 mix beside the next chunk's AA): ``gr``, ``s128w``,
``autox1``, ``autok1``, ``autoa1``. A variant is the committed source with
literal text replacements, each of which must match once, built with nvcc
(all at once) into ``build/k3_variants/``: ``bounds_1`` and ``bounds_2``
ask the launch bounds for one or two blocks per SM instead of the path's,
``stages4`` streams the weights four chunks deep, ``tf32_mt1`` gives the
float32 path's warps one m16 tile instead of two; ``aa_only`` skips the
MMAs (the weights still stream), ``mix_only`` skips AA (neither is the
block's function: they time its parts, and fail the bit check).
Every run is held bit for bit against the chain of K2 launches and timed
with CUDA events (the mean of 5 launches after one). Prints the times by
shape and the sums over the 12 blocks.
"""

from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys

import torch

from promptttspp_tpu_torch import flagship
from promptttspp_tpu_torch.ops.kernels import _build
from promptttspp_tpu_torch.ops.kernels import amp as k2
from promptttspp_tpu_torch.tools.k2_variants import cuda_ms

OUT = _build.BUILD_DIR.parent / "k3_variants"
BOUNDS = "__launch_bounds__(THREADS, Path::MIN_BLOCKS)"
VARIANTS = {
    "committed": [],
    "bounds_1": [(BOUNDS, "__launch_bounds__(THREADS, 1)")],
    "bounds_2": [(BOUNDS, "__launch_bounds__(THREADS, 2)")],
    "stages4": [("constexpr int NSTAGE = 3;", "constexpr int NSTAGE = 4;")],
    "tf32_mt1": [("constexpr int TF32_MT = 2;", "constexpr int TF32_MT = 1;")],
    "aa_only": [("        if (!active) continue;\n        for (int q = 0;",
                 "        if (true) continue;\n        for (int q = 0;"),
                ("          ptts::wgmma_ss<N>(acc[m], ptts::desc(a_k + m * 64 "
                 "* 16, a_lbo, 128),\n                            bd);",
                 "          (void)bd;")],
    "mix_only": [("for (int item = threadIdx.x; item < C * n_runs; "
                  "item += THREADS)",
                  "for (int item = threadIdx.x; item < 0; item += THREADS)")],
}


def build(names):
    """Build each variant (one nvcc each, all at once; ``committed`` is the
    repository's build) -> name -> its library."""
    src = (_build.CSRC / "amp_block.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    procs, libs = {}, {}
    for name in names:
        if name == "committed":
            libs[name] = k2._block_lib()
            continue
        text = src
        for old, new in VARIANTS[name]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} does not match "
                                 "once")
            text = text.replace(old, new)
        cu = OUT / f"amp_block-{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build.nvcc_path(), *_build.NVCC_FLAGS, f"-I{_build.CSRC}", "-o",
             str(OUT / f"amp_block-{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed for {name}:\n{log}")
        spills = sorted({line.strip() for line in log.splitlines()
                         if "spill" in line and not line.strip().startswith(
                             "0 bytes stack frame")})
        print(f"{name}: built; spills {spills or 'none'}", flush=True)
        libs[name] = k2.block_argtypes(
            ctypes.CDLL(str(OUT / f"amp_block-{name}.so")))
    return libs


def plan_hints(plan):
    """A plan's name -> make_plan's hints (tt, mode, resident, split, gk,
    abufs)."""
    m = re.fullmatch(
        r"(auto|([gs])(\d*))([rw]?)(?:x(\d))?(?:k(\d+))?(?:a(\d))?", plan)
    if m is None:
        raise SystemExit(f"not a plan: {plan}")
    return (int(m[3] or 0), {"g": 1, "s": 0}.get(m[2], -1),
            {"r": 1, "w": 0}.get(m[4], -1), int(m[5] or 0), int(m[6] or 0),
            int(m[7] or 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default="committed",
                    help=f"comma-separated, of {sorted(VARIANTS)}")
    ap.add_argument("--plans", default="auto,g,g128,g64")
    ap.add_argument("--bf16-only", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_variants: needs a GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    names = args.variants.split(",")
    plans = args.plans.split(",")
    libs = build(names)
    voc = flagship.VOCODER
    shapes = [(C, T, k, tuple(dils))
              for C, T in _stage_shapes(voc, 640)
              for k, dils in zip(voc["resblock_kernel_sizes"],
                                 voc["resblock_dilations"])]
    g = torch.Generator(device=dev).manual_seed(0)
    total, failed = {}, []
    for C, T, k, dils in shapes:
        ws = min(0.05, 1.0 / math.sqrt(k * C))
        rn = lambda *s, sc: sc * torch.randn(s, generator=g, device=dev)
        x = rn(1, T, C, sc=0.3)
        params = tuple((rn(C, sc=0.2), rn(C, C, k, sc=ws), rn(C, sc=0.1),
                        rn(C, sc=0.2), rn(C, C, k, sc=ws), rn(C, sc=0.1))
                       for _ in dils)
        for bf16 in ((True,) if args.bf16_only else (False, True)):
            def chain():
                h = x
                for p, d in zip(params, dils):
                    h = k2.amp_layer(h, *p, d, bf16=bf16)
                return h
            want = chain()
            cols = {"K2 chain": cuda_ms(chain, iters=5)}
            for name in names:
                for plan in plans:
                    run = lambda: k2._block_launch(
                        libs[name], x, params, dils, bf16, plan_hints(plan))
                    try:
                        got = run()
                    except RuntimeError as e:  # a plan that does not fit
                        cols[f"{name}/{plan}"] = float("nan")
                        print(f"  {name}/{plan} C={C} k={k}: {e}")
                        continue
                    if not torch.equal(got, want):
                        failed.append(f"{name}/{plan} bf16={bf16} C={C} "
                                      f"k={k}")
                    cols[f"{name}/{plan}"] = cuda_ms(run, iters=5)
            for key, ms in cols.items():
                total[(bf16, key)] = total.get((bf16, key), 0.0) + ms
            print(f"bf16={bf16} C={C} T={T} k={k}: " + ", ".join(
                f"{key} {ms:.4f}" for key, ms in cols.items()), flush=True)
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    for (bf16, key), ms in total.items():
        print(f"[{gpu}] 12 blocks, bf16={bf16}: {key} {ms:.3f} ms")
    if failed:
        print(f"differ from the K2 chain: {failed}", file=sys.stderr)
        return 1
    return 0


def _stage_shapes(voc_cfg, frames):
    """(C, T) of each upsample stage's AMPLayers (chip_smoke.stage_shapes)."""
    shapes, T = [], frames
    for i, u in enumerate(voc_cfg["upsample_rates"]):
        T *= u
        shapes.append((voc_cfg["upsample_initial_channel"] // 2 ** (i + 1),
                       T))
    return shapes


if __name__ == "__main__":
    sys.exit(main())
