"""Kernels K2 and K3: one BigVGAN AMPLayer, and a whole AMPBlock.

K2, ``amp_layer``: ``y = x + conv2(AA2(conv1(AA1(x))))``. Replaces
``promptttspp_tpu/ops/pallas/amp.py::fused_amp_layer`` (one-layer
``fused_amp_block``, Pallas body ``_kernel``). AA is the anti-aliased Snake
of kernel K1; conv1 is a k-tap SAME conv with dilation d, conv2 a k-tap
SAME conv; both C x C with bias.

K2 comes in the two precisions of the JAX kernel's ``mxu_bf16`` flag,
which the JAX ``AMPLayer`` sets from ``conv_precision``. Both run the
channel mix on the tensor cores with float32 accumulation; AA, bias and
residual stay float32:

- ``bf16=True`` (``conv_precision="default"``, the flagship's): K2-bf16,
  ``csrc/amp_layer_wgmma.cu``. The two operands of each channel mix, AA's
  output and the conv weight, are rounded to bf16 (``wgmma`` m64nNk16). A
  persistent, warp-specialised block computes AA for its next time tile
  while it mixes the current one; the weights arrive by bulk copies in the
  shared-memory layout of ``kernel_weight_wgmma``; the tiling is
  ``wgmma_plan``'s. The TPU kernel also feeds AA's FIRs to the MXU in bf16
  at C < 128; the port rounds only the channel mix.
- ``bf16=False`` (``conv_precision="highest"``): the float32 K2, 3xTF32,
  ``csrc/amp_layer_tc.cu`` (``mma.sync``). Each operand is split into a
  TF32 big part (rounded to nearest) and the float32 remainder, and each
  product is small*big + big*small + big*big (m16n8k8), which keeps the
  mix at float32 accuracy. One-pass TF32 would not.

``amp_layer_tc.cu`` also keeps the earlier K2-bf16 (``mma.sync``,
``amp_aa_conv_tc``, weights from ``kernel_weight_bf16``) as a yardstick
for timing and output bits; no serving path calls it.

The kernel is launched twice per layer:

    h = conv1(AA1(x))          (residual: none)
    y = x + conv2(AA2(h))      (residual: x)

Each block computes AA over a time tile plus the conv's halo into shared
memory and accumulates the channel mix from there. The split meets the
edge rules without masks: AA clamps its input to [0, T) (edge replication,
which for the second launch is exactly "conv1's output replicated before
AA2"), and the conv reads zeros outside [0, T).

K3, ``amp_block``: the chained form of ``fused_amp_block`` (n_layers > 1),
a whole AMPBlock in one launch of ``csrc/amp_block.cu``, in float32 on the
CUDA cores. It equals the chain of float32 AMPLayers (``amp_block_plain``)
within float32 rounding: it sums in another order than the float32 K2's
3xTF32. A block keeps its time tile plus the summed halo of the chain, the
running layer output and conv1's output in shared memory (or an
L2-resident global scratch where they do not fit), narrows the valid region
stage by stage and writes only its tile. Like the JAX package, the vocoder
does not call it: ``vocoders/bigvgan.py::AMPBlock`` runs one K2 call per
layer.

What bounds them: the channel mix, 4*k*C^2 flops per time step and layer
(~2.6e11 flops per 640-frame request over the 36 layers) against ~1 GB of
x/y traffic. K3, in float32 on the CUDA cores, is bound by operations;
K2-bf16 by AA's float32 work and the bytes about as much as by its mix;
the float32 K2 by its three TF32 passes. All take the conv weights in a
kernel layout prepared once per weight tensor (``kernel_weight`` for K3,
``kernel_weight_wgmma`` and ``kernel_weight_tf32x3`` for K2; change
weights under ``torch.no_grad()``, not through ``w.data``).

``amp_layer`` and ``amp_block`` launch their kernels for a CUDA tensor and
run the plain float32 PyTorch versions only for a tensor on the CPU. Their
launch counts go up by one per kernel launch: two per layer for K2
(``amp_layer.launches`` for the float32 K2, ``amp_layer.launches_bf16``
for K2-bf16), one per block for K3.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from promptttspp_tpu_torch.nn.layers import conv1d_same
from promptttspp_tpu_torch.ops.kernels import _build
from promptttspp_tpu_torch.ops.kernels.snake import antialias_snake_plain

# the shapes K3 takes: every AMPBlock of the flagship vocoder and of
# tests/test_pallas_amp.py's block cases
AMP_BLOCK_CHANNELS = (32, 64, 128, 256)
AMP_BLOCK_KERNEL_SIZES = (3, 7, 11)
AMP_BLOCK_DILATIONS = ((1, 3, 5), (1, 3))

# K2-bf16 (csrc/amp_layer_wgmma.cu): the configurations compiled there, as
# (N output channels per pass, KS k16 steps per weight chunk, NWG consumer
# warpgroups, MT m64 tiles per consumer warpgroup, PW AA producer warps;
# the source also gives each its AA run length). The first of each N is
# wgmma_plan's, the fastest of those timed at the flagship's shapes on an
# H100 (tools/k2_variants.py --kernel wgmma; the others stay to be timed
# against it).
WGMMA_CONFIGS = ((16, 1, 1, 2, 8), (32, 2, 2, 2, 15), (32, 2, 1, 4, 11),
                 (32, 2, 1, 2, 19), (32, 2, 2, 2, 23), (64, 4, 2, 1, 15),
                 (64, 4, 2, 1, 19), (64, 4, 2, 1, 23), (128, 4, 1, 1, 15),
                 (128, 4, 1, 1, 11), (256, 4, 1, 1, 7))
# output channels per pass above C = 128: two passes of 128 at C = 256
WGMMA_WIDE_N = 128
# the plan's fields in the order the launcher reads them
WGMMA_PLAN_FIELDS = ("n", "passes", "cp", "ks", "nwg", "mt", "pw", "tt",
                     "na", "nap", "resident", "nstage", "abufs", "smem")
SMEM_PER_BLOCK = 232_448  # an H100 block's shared memory
WGMMA_MAX_STAGES = 4


def _round_bf16(t):
    return t.to(torch.bfloat16).to(t.dtype)


def amp_layer_plain(x, alpha1, w1, b1, alpha2, w2, b2, dilation: int,
                    bf16: bool = False):
    """Plain PyTorch version. w* are torch conv weights [C, C, k]. With
    ``bf16``, each conv's two operands (AA's output and the weight) are
    rounded to bf16 and the conv sums their exact products in float32:
    K2-bf16's arithmetic."""
    mix = _round_bf16 if bf16 else (lambda t: t)
    h = conv1d_same(mix(antialias_snake_plain(x, alpha1)), mix(w1), b1,
                    dilation)
    h = conv1d_same(mix(antialias_snake_plain(h, alpha2)), mix(w2), b2, 1)
    return x + h


def amp_block_plain(x, layer_params, dilations):
    """Plain PyTorch version: the chain of ``amp_layer_plain`` calls."""
    for params, d in zip(layer_params, dilations):
        x = amp_layer_plain(x, *params, d)
    return x


def _prepared(w: torch.Tensor, attr: str, make) -> torch.Tensor:
    """``make(w.detach())``, kept on ``w`` under ``attr`` until ``w``'s
    version counter or storage shows a change."""
    key = (None if w.is_inference() else w._version, w.data_ptr(), w.device)
    cached = getattr(w, attr, None)
    if cached is not None and cached[0] == key and key[0] is not None:
        return cached[1]
    w_k = make(w.detach())
    setattr(w, attr, (key, w_k))
    return w_k


def kernel_weight(w: torch.Tensor) -> torch.Tensor:
    """Torch conv weight [C_out, C_in, k] -> K3's [k, C_in, C_out] (one
    tap's weights for a run of output channels are contiguous). Computed
    once per weight tensor and kept on it. It is computed again after every
    change that ``w``'s version counter or storage shows: an in-place op
    on ``w`` (under ``torch.no_grad()`` too, as ``load_state_dict`` makes),
    a new ``w.data``, a move. An in-place write into ``w.data``
    (``w.data.copy_(...)``) bypasses the version counter and is not seen:
    change weights under ``torch.no_grad()`` instead."""
    return _prepared(w, "_kernel_layout",
                     lambda v: v.permute(2, 1, 0).contiguous())


def tc_weight(v: torch.Tensor, rows: int, cols: int,
              dtype: torch.dtype) -> torch.Tensor:
    """Torch conv weight [C_out, C_in, k] -> K2's [k, rows, cols] in
    ``dtype`` ([tap][out][in]: the tensor cores' column-major B operand,
    bf16 rounded to nearest even), zero beyond C."""
    C, _, k = v.shape
    w_k = v.new_zeros((k, rows, cols), dtype=dtype)
    w_k[:, :C, :C] = v.permute(2, 0, 1)
    return w_k


def _tc_layout(w: torch.Tensor, attr: str, dtype: torch.dtype):
    def make(v):
        lib = _tc_lib()
        C = v.shape[0]
        return tc_weight(v, lib.amp_tc_weight_rows(C),
                         lib.amp_tc_weight_cols(C), dtype)
    return _prepared(w, attr, make)


def kernel_weight_bf16(w: torch.Tensor) -> torch.Tensor:
    """Torch conv weight [C_out, C_in, k] on a GPU -> K2-bf16's bf16
    [k, NP, CP] (``tc_weight``), zero-padded to the kernel's tiling (CP = C
    rounded up to 16, NP = C rounded up to whole output passes, both from
    the built library). Kept on ``w`` under ``kernel_weight``'s rules."""
    return _tc_layout(w, "_kernel_layout_bf16", torch.bfloat16)


def kernel_weight_tf32x3(w: torch.Tensor) -> torch.Tensor:
    """Torch conv weight [C_out, C_in, k] on a GPU -> the float32 K2's
    float32 [k, NP, CP], the layout of ``kernel_weight_bf16`` with the
    weights unrounded (the kernel splits them for 3xTF32). Kept on ``w``
    under ``kernel_weight``'s rules."""
    return _tc_layout(w, "_kernel_layout_tf32x3", torch.float32)


def _wgmma_shape(C: int, n: int = None):
    """C -> (N output channels per pass, passes, CP input channels, KS k16
    steps per weight chunk) of K2-bf16: N the smallest of 16, 32, 64, 128
    that covers C, else ``n`` (default ``WGMMA_WIDE_N``) in passes; CP = C
    rounded up to 16 up to 32, else to whole chunks of 64."""
    if n is None:
        n = next((v for v in (16, 32, 64, 128) if C <= v), WGMMA_WIDE_N)
    cp = (C + 15) // 16 * 16 if C <= 32 else (C + 63) // 64 * 64
    return n, -(-C // n), cp, min(cp // 16, 4)


def wgmma_plan(C: int, k: int, d: int, n: int = None,
               split: tuple = None) -> dict:
    """K2-bf16's plan for one launch at C channels, kernel size k and
    dilation d: the configuration (``WGMMA_CONFIGS``; ``n`` and ``split`` =
    (NWG, MT, PW) pick another compiled one) and its shared memory. The
    weights of all k taps stay resident in a block where they fit beside
    two A buffers (one pass only); otherwise they stream through a ring of
    2 to ``WGMMA_MAX_STAGES`` chunks, beside one A buffer if two leave no
    room for two chunks. Raises ValueError for a shape whose tiles do not
    fit in a block's shared memory. Holds ``WGMMA_PLAN_FIELDS`` and the
    byte counts."""
    if C < 1 or k < 1 or k % 2 == 0 or d < 1:
        raise ValueError(f"K2-bf16 takes C >= 1, odd k, d >= 1; got C={C}, "
                         f"k={k}, d={d}")
    n, passes, cp, ks = _wgmma_shape(C, n)
    cfgs = [c for c in WGMMA_CONFIGS if c[:2] == (n, ks)
            and (split is None or c[2:] == tuple(split))]
    if not cfgs:
        raise ValueError(f"no compiled K2-bf16 configuration for N={n}, "
                         f"KS={ks}, split={split}")
    _, _, nwg, mt, pw = cfgs[0]
    tt = 64 * mt * nwg
    na = tt + 2 * ((k - 1) // 2 * d)
    nap = na | 1  # odd, so a warp's stores to 4 channel groups spread
    a_bytes = nap * cp * 2
    chunk = 16 * ks * n * 2
    nkc = cp // (16 * ks)
    bars = lambda nstage: 8 * (4 + 2 * nstage)
    resident = (passes == 1 and k * nkc * chunk + 2 * a_bytes + bars(1)
                <= SMEM_PER_BLOCK)
    if resident:
        abufs, nstage, w_bytes = 2, 1, k * nkc * chunk
    else:
        for abufs in (2, 1):
            nstage = min(WGMMA_MAX_STAGES,
                         (SMEM_PER_BLOCK - abufs * a_bytes - bars(0))
                         // (chunk + 16))
            if nstage >= 2:
                break
        else:
            raise ValueError(f"K2-bf16 tiles do not fit in shared memory at "
                             f"C={C}, k={k}, d={d}")
        w_bytes = nstage * chunk
    return dict(n=n, passes=passes, cp=cp, ks=ks, nwg=nwg, mt=mt, pw=pw,
                tt=tt, na=na, nap=nap, resident=int(resident), nstage=nstage,
                abufs=abufs, smem=w_bytes + abufs * a_bytes + bars(nstage),
                a_bytes=a_bytes, chunk_bytes=chunk, w_bytes=w_bytes,
                weight_bytes=passes * k * nkc * chunk)


def wgmma_grid(plan: dict, B: int, T: int, n_sm: int) -> int:
    """Blocks of a K2-bf16 launch: one per SM, at most one per item (batch
    row, time tile, pass)."""
    return min(B * -(-T // plan["tt"]) * plan["passes"], n_sm)


def wgmma_weight(v: torch.Tensor, n: int, cp: int) -> torch.Tensor:
    """Torch conv weight [C_out, C_in, k] -> K2-bf16's bf16 weights
    [P, k, CP/16, N/8, 2, 8, 8] (P = passes of N output channels), the
    shared-memory image that the kernel's B descriptors read, chunk after
    chunk in the order it consumes them: element (p, j, s, g, h, r, e) is
    W[j][p*N + 8g + r][16s + 8h + e], bf16 rounded to nearest even, zero
    beyond C. (g, h) is a core matrix of 8 output channels x 8 input
    channels (16 bytes a row); a weight chunk is KS consecutive s."""
    C, _, k = v.shape
    passes = -(-C // n)
    w = v.new_zeros((k, passes * n, cp), dtype=torch.bfloat16)
    w[:, :C, :C] = v.permute(2, 0, 1)
    w = w.view(k, passes, n // 8, 8, cp // 16, 2, 8)  # j p g r s h e
    return w.permute(1, 0, 4, 2, 5, 3, 6).contiguous()


def kernel_weight_wgmma(w: torch.Tensor) -> torch.Tensor:
    """Torch conv weight [C_out, C_in, k] -> K2-bf16's ``wgmma_weight`` for
    ``wgmma_plan``'s N and CP at this C. Kept on ``w`` under
    ``kernel_weight``'s rules."""
    n, _, cp, _ = _wgmma_shape(w.shape[0])
    return _prepared(w, "_kernel_layout_wgmma",
                     lambda v: wgmma_weight(v, n, cp))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def wgmma_args(x, alpha, w_k, b, residual, y, dilation, plan, k):
    """The arguments of a K2-bf16 entry point (``amp_aa_conv_wgmma``'s
    signature) for one launch of ``plan``, the stream aside."""
    B, T, C = x.shape
    ints = (ctypes.c_int * len(WGMMA_PLAN_FIELDS))(
        *(plan[f] for f in WGMMA_PLAN_FIELDS))
    return (x.data_ptr(), alpha.data_ptr(), w_k.data_ptr(), b.data_ptr(),
            0 if residual is None else residual.data_ptr(), y.data_ptr(),
            B, T, C, k, dilation, ints,
            wgmma_grid(plan, B, T, _sm_count(x.device)))


def wgmma_argtypes(fn):
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _wgmma_lib():
    lib = _build.load("amp_layer_wgmma")
    wgmma_argtypes(lib.amp_aa_conv_wgmma)
    return lib


@functools.lru_cache(maxsize=None)
def _tc_lib():
    lib = _build.load("amp_layer_tc")
    for fn in (lib.amp_tc_weight_rows, lib.amp_tc_weight_cols):
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_int
    for fn in (lib.amp_aa_conv_tc, lib.amp_aa_conv_tf32x3):
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _block_lib():
    lib = _build.load("amp_block")
    lib.amp_block_scratch_floats.argtypes = [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_int), ctypes.c_int]
    lib.amp_block_scratch_floats.restype = ctypes.c_longlong
    lib.amp_block.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.amp_block.restype = ctypes.c_int
    return lib


def _check_layer(C, k, alpha1, w1, b1, alpha2, w2, b2, device):
    for name, t, shape in (("alpha1", alpha1, (C,)), ("w1", w1, (C, C, k)),
                           ("b1", b1, (C,)), ("alpha2", alpha2, (C,)),
                           ("w2", w2, (C, C, k)), ("b2", b2, (C,))):
        _build.check(t, name, shape, device)


def _tc_launch(fn, x, alpha, w_k, b, residual, dilation, k):
    """One launch of an ``amp_layer_tc.cu`` entry point -> y."""
    B, T, C = x.shape
    y = torch.empty_like(x)
    _build.launch(fn, x.device, x.data_ptr(), alpha.data_ptr(),
                  w_k.data_ptr(), b.data_ptr(),
                  0 if residual is None else residual.data_ptr(),
                  y.data_ptr(), B, T, C, k, dilation)
    return y


def _aa_conv(x, alpha, w, b, residual, dilation, bf16):
    C, k = x.shape[-1], w.shape[-1]
    if bf16:
        y = torch.empty_like(x)
        _build.launch(_wgmma_lib().amp_aa_conv_wgmma, x.device,
                      *wgmma_args(x, alpha, kernel_weight_wgmma(w), b,
                                  residual, y, dilation,
                                  wgmma_plan(C, k, dilation), k))
        amp_layer.launches_bf16 += 1
        return y
    y = _tc_launch(_tc_lib().amp_aa_conv_tf32x3, x, alpha,
                   kernel_weight_tf32x3(w), b, residual, dilation, k)
    amp_layer.launches += 1
    return y


def amp_layer_mma_sync(x, alpha1, w1, b1, alpha2, w2, b2, dilation: int):
    """The AMPLayer by the earlier K2-bf16 (``amp_layer_tc.cu``'s
    ``amp_aa_conv_tc``, mma.sync, weights from ``kernel_weight_bf16``), on
    a CUDA tensor. No serving path calls it and it is not counted: it is
    the yardstick that the tests and ``chip_smoke.py`` hold K2-bf16's
    output bits and time against."""
    fn, k = _tc_lib().amp_aa_conv_tc, w1.shape[-1]
    h = _tc_launch(fn, x, alpha1, kernel_weight_bf16(w1), b1, None,
                   dilation, k)
    return _tc_launch(fn, h, alpha2, kernel_weight_bf16(w2), b2, x, 1, k)


def amp_layer(x, alpha1, w1, b1, alpha2, w2, b2, dilation: int,
              bf16: bool = False):
    """x [B, T, C] float32; alpha* [C]; w* torch conv weights [C, C, k]
    (odd k); b* [C] -> [B, T, C]. ``bf16`` is the JAX kernel's
    ``mxu_bf16``: on a CUDA tensor it selects K2-bf16 (the ``wgmma``
    kernel), else the float32 (3xTF32) K2.
    On a CPU tensor the float32 plain version runs whatever ``bf16`` says,
    as JAX on the CPU runs the unfused float32 layer. On CUDA it takes any
    C >= 1, as the JAX ``AMPLayer`` does, and an odd k."""
    if x.device.type == "cpu":
        return amp_layer_plain(x, alpha1, w1, b1, alpha2, w2, b2, dilation)
    B, T, C = x.shape
    _build.check(x, "x", (B, T, C), x.device)
    k = w1.shape[-1]
    if k % 2 == 0:
        raise ValueError(f"amp_layer kernel needs an odd k, got k={k}")
    _check_layer(C, k, alpha1, w1, b1, alpha2, w2, b2, x.device)
    h = _aa_conv(x, alpha1, w1, b1, None, dilation, bf16)
    return _aa_conv(h, alpha2, w2, b2, x, 1, bf16)


def amp_block(x, layer_params, dilations):
    """x [B, T, C] float32; ``layer_params`` one tuple (alpha1, w1, b1,
    alpha2, w2, b2) per layer as for ``amp_layer``, all of one kernel size
    k; ``dilations`` the layers' conv1 dilations -> [B, T, C]. On CUDA, C
    must be one of ``AMP_BLOCK_CHANNELS``, k one of
    ``AMP_BLOCK_KERNEL_SIZES`` and the dilations one of
    ``AMP_BLOCK_DILATIONS``."""
    dilations = tuple(int(d) for d in dilations)
    if len(layer_params) != len(dilations):
        raise ValueError(f"{len(layer_params)} layers but "
                         f"{len(dilations)} dilations")
    if x.device.type == "cpu":
        return amp_block_plain(x, layer_params, dilations)
    B, T, C = x.shape
    _build.check(x, "x", (B, T, C), x.device)
    k = layer_params[0][1].shape[-1]
    if (C not in AMP_BLOCK_CHANNELS or k not in AMP_BLOCK_KERNEL_SIZES
            or dilations not in AMP_BLOCK_DILATIONS):
        raise ValueError(
            f"amp_block kernel takes C in {AMP_BLOCK_CHANNELS}, k in "
            f"{AMP_BLOCK_KERNEL_SIZES} and dilations in "
            f"{AMP_BLOCK_DILATIONS}; got C={C}, k={k}, dilations={dilations}")
    ptrs = []
    for a1, w1, b1, a2, w2, b2 in layer_params:
        _check_layer(C, k, a1, w1, b1, a2, w2, b2, x.device)
        ptrs += [t.data_ptr() for t in (a1, kernel_weight(w1), b1, a2,
                                        kernel_weight(w2), b2)]
    lib = _block_lib()
    n = len(dilations)
    dils = (ctypes.c_int * n)(*dilations)
    with torch.cuda.device(x.device):
        floats = lib.amp_block_scratch_floats(B, T, C, k, dils, n)
    if floats < 0:
        raise RuntimeError(f"amp_block_scratch_floats failed: CUDA error "
                           f"{-floats}")
    scratch = torch.empty(max(floats, 1), dtype=torch.float32,
                          device=x.device)
    y = torch.empty_like(x)
    _build.launch(lib.amp_block, x.device, x.data_ptr(), y.data_ptr(),
                  scratch.data_ptr(), floats,
                  (ctypes.c_void_p * len(ptrs))(*ptrs), dils, n, B, T, C, k)
    amp_block.launches += 1
    return y


amp_layer.launches = 0
amp_layer.launches_bf16 = 0
amp_block.launches = 0
