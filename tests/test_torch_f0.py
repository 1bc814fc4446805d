"""The port's F0 path against the JAX package on the CPU: ``interp1d``,
batched YIN (``extract_f0`` / ``extract_pitch``) with per-row bounds and
silence, and the numpy copy of WORLD's DIO + StoneMask and the contour
fix."""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from promptttspp_tpu_torch.data import yaml_lite
from promptttspp_tpu_torch.ops import f0 as port_f0
from promptttspp_tpu_torch.ops.interp import interp1d
from promptttspp_tpu_torch.tools.synthetic_corpus import speech_like

REPO = Path(__file__).resolve().parent.parent
SR, HOP = 24000, 240
# float32 FFTs and cumulative sums in another order than XLA's: a CMND
# trough next to a threshold can flip a frame's voicing or its lag; F0 on
# frames both voice agrees to float32 rounding of the lag refinement
VUV_AGREEMENT = 0.995
F0_RTOL = 1e-3
INTERP_ATOL = 1e-6
WORLD_ATOL = 1e-9


def _contours():
    rng = np.random.RandomState(0)
    gaps = np.where(rng.rand(3, 80) > 0.4, 80 + 200 * rng.rand(3, 80), 0.0)
    gaps[0, :7] = gaps[1, -9:] = 0.0  # leading and trailing unvoiced runs
    return {"gaps": gaps, "all_voiced": 100 + 150 * rng.rand(2, 40),
            "all_unvoiced": np.zeros((2, 40)), "one_voiced": np.where(
                np.arange(30) == 11, 180.0, 0.0)[None]}


@pytest.mark.parametrize("case", sorted(_contours()))
def test_interp1d_matches_jax(case):
    from promptttspp_tpu.ops.interp import interp1d as jax_interp1d

    f0 = _contours()[case].astype(np.float32)
    ref = np.asarray(jax_interp1d(jnp.asarray(f0)))
    out = interp1d(torch.from_numpy(f0)).numpy()
    np.testing.assert_allclose(out, ref, atol=INTERP_ATOL, rtol=0)
    if case == "all_unvoiced":
        assert not out.any()


# (speaker, seconds, F0 in Hz): per-row bounds from the repo's F0 stats;
# the last two rows are silent at their start and all silent
ROWS = [("19", 2.0, 190.0), ("100", 1.6, 260.0), ("1001", 2.0, 105.0),
        ("121", 1.2, 150.0), ("260", 2.0, 0.0)]


@pytest.fixture(scope="module")
def batch():
    stats = yaml_lite.load(REPO / "metadata/libritts_r_f0_stats.yaml")
    n = int(SR * max(r[1] for r in ROWS))
    wav = np.zeros((len(ROWS), n), np.float32)
    for i, (_, sec, f0) in enumerate(ROWS):
        if f0:
            wav[i, :int(SR * sec)] = speech_like(sec, f0, seed=i)
    wav[3, :SR // 2] = 0.0
    lo = np.asarray([stats[s]["f0_floor"] for s, _, _ in ROWS], np.float32)
    hi = np.asarray([stats[s]["f0_ceil"] for s, _, _ in ROWS], np.float32)
    return wav, lo, hi


def _agree(f0_port, vuv_port, f0_jax, vuv_jax):
    assert f0_port.shape == f0_jax.shape
    assert (vuv_port == vuv_jax).mean() >= VUV_AGREEMENT
    both = (vuv_port > 0) & (vuv_jax > 0)
    assert both.sum() > 0
    np.testing.assert_allclose(f0_port[both], f0_jax[both], rtol=F0_RTOL)
    assert not f0_port[vuv_port == 0].any()


def test_extract_pitch_matches_jax_with_per_row_bounds(batch):
    from promptttspp_tpu.ops.f0 import extract_pitch as jax_extract_pitch

    wav, lo, hi = batch
    ref = jax.jit(lambda w, a, b: jax_extract_pitch(w, SR, HOP, a, b))(
        wav, lo, hi)
    f0, cf0, vuv = port_f0.extract_pitch(
        torch.from_numpy(wav), SR, HOP, torch.from_numpy(lo),
        torch.from_numpy(hi))
    jf0, jcf0, jvuv = map(np.asarray, ref)
    _agree(f0.numpy(), vuv.numpy(), jf0, jvuv)
    assert f0.shape == (len(ROWS), 1 + wav.shape[1] // HOP)
    assert not f0[4].any() and not f0[3, :45].any()
    assert (vuv.numpy()[:3].mean(-1) > 0.5).all()
    # cf0 = log of the interpolated contour: equal where the voicing is
    same = (vuv.numpy() == jvuv).all(-1)
    np.testing.assert_allclose(cf0.numpy()[same], jcf0[same],
                               atol=F0_RTOL, rtol=0)


def test_extract_f0_scalar_bounds_and_one_row(batch):
    """Scalar bounds, and a 1-D wav (one row) as the JAX function takes
    them."""
    from promptttspp_tpu.ops.f0 import extract_f0 as jax_extract_f0

    wav, _, _ = batch
    ref = jax.jit(lambda w: jax_extract_f0(w, SR, HOP, 70.0, 500.0))(wav[0])
    f0, vuv = port_f0.extract_f0(torch.from_numpy(wav[0]), SR, HOP, 70.0,
                                 500.0)
    assert f0.ndim == 1
    _agree(f0.numpy(), vuv.numpy(), *map(np.asarray, ref))


def test_world_f0_copy_equals_jax():
    from promptttspp_tpu.preprocess import world_f0 as jw
    from promptttspp_tpu_torch.preprocess import world_f0 as pw

    x = speech_like(1.0, 160.0, seed=3)
    for fn, args, kw in (
            ("dio", (x, SR), dict(f0_floor=70.0, f0_ceil=500.0,
                                  frame_period=10.0)),
            ("extract_pitch_world", (x.astype(np.float32), SR, HOP),
             dict(f0_floor=70.0, f0_ceil=500.0))):
        for a, b in zip(getattr(pw, fn)(*args, **kw),
                        getattr(jw, fn)(*args, **kw)):
            np.testing.assert_allclose(a, b, atol=WORLD_ATOL, rtol=0)
    times, f0 = jw.dio(x, SR, f0_floor=70.0, f0_ceil=500.0)
    np.testing.assert_allclose(pw.stonemask(x, SR, times, f0),
                               jw.stonemask(x, SR, times, f0),
                               atol=WORLD_ATOL, rtol=0)
    octave = np.where(np.arange(60) % 7 == 3, 320.0, 160.0)
    octave[40:44] = 0.0
    np.testing.assert_array_equal(pw.fix_f0_contour(octave, 70.0, 500.0),
                                  jw.fix_f0_contour(octave, 70.0, 500.0))
