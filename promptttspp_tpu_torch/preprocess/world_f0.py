"""WORLD-style DIO + StoneMask F0 estimation (numpy, host code).

A copy of ``promptttspp_tpu/preprocess/world_f0.py`` (the port imports
nothing of the JAX package): an independent numpy/scipy reimplementation of
pyworld's ``dio`` and ``stonemask`` from their published descriptions
(Morise et al., "DIO: a fast and accurate fundamental frequency estimator";
WORLD, IEICE 2016), not bit-compatible with pyworld, and
``fix_f0_contour``, the host-side octave fix that the YIN path of
``preprocess/pipeline.py`` applies to its contours. It runs on the host in
JAX too, so it stays numpy here; ``tests/test_torch_f0.py`` holds it equal
to the JAX package's.
"""

from __future__ import annotations

import warnings
from typing import Tuple

import numpy as np
from scipy import signal as sps


def _lowpass(x: np.ndarray, fs: float, cutoff: float) -> np.ndarray:
    """Zero-phase FIR low-pass (nuttall-windowed sinc), cutoff in Hz."""
    half = int(round(fs / cutoff)) * 2  # ~4 periods of the cutoff
    n = 2 * half + 1
    taps = sps.firwin(n, cutoff, fs=fs, window="nuttall")
    return sps.fftconvolve(x, taps, mode="same")


def _highpass(x: np.ndarray, fs: float, cutoff: float = 50.0) -> np.ndarray:
    b, a = sps.butter(2, cutoff / (fs / 2), btype="highpass")
    return sps.filtfilt(b, a, x)


def _event_track(times: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Event times [n] -> (interval-center times, interval f0s)."""
    if len(times) < 2:
        return np.zeros(0), np.zeros(0)
    intervals = np.diff(times)
    centers = 0.5 * (times[1:] + times[:-1])
    with np.errstate(divide="ignore"):
        f0 = np.where(intervals > 0, 1.0 / intervals, 0.0)
    return centers, f0


def _zero_crossings(y: np.ndarray, fs: float, negative: bool) -> np.ndarray:
    s = -y if negative else y
    idx = np.where((s[:-1] < 0) & (s[1:] >= 0))[0]
    if len(idx) == 0:
        return np.zeros(0)
    # linear interpolation of the crossing instant
    frac = -s[idx] / (s[idx + 1] - s[idx])
    return (idx + frac) / fs


def _four_interval_tracks(y: np.ndarray, fs: float, frame_times: np.ndarray):
    """Four per-frame f0 estimates [4, n_frames] (NaN where undefined)."""
    dy = np.diff(y)
    events = [
        _zero_crossings(y, fs, negative=False),
        _zero_crossings(y, fs, negative=True),
        _zero_crossings(dy, fs, negative=True),   # peaks
        _zero_crossings(dy, fs, negative=False),  # dips
    ]
    out = np.full((4, len(frame_times)), np.nan)
    for k, ev in enumerate(events):
        centers, f0 = _event_track(ev)
        if len(centers) < 2:
            continue
        est = np.interp(frame_times, centers, f0,
                        left=np.nan, right=np.nan)
        out[k] = est
    return out


def fix_f0_contour(f0: np.ndarray, f0_floor: float,
                   f0_ceil: float) -> np.ndarray:
    """Octave-jump fix (WORLD FixF0Contour analog), shared by DIO and —
    as an optional host-side post-pass — the YIN pipeline: snap voiced
    frames that sit ~an octave off their local voiced median to the
    nearest octave multiple of it; frames that cannot be snapped near
    the median are spurious locks (e.g. a formant resonance) and are
    unvoiced instead. Measured effect in tests/test_f0_parity.py /
    BENCHMARKS.md: octave-error fraction -> ~0 for both estimators."""
    f0 = np.asarray(f0).copy()
    vi = np.where(f0 > 0)[0]
    if len(vi) < 5:
        return f0
    f0v = f0[vi]
    k = min(11, len(f0v) - (1 - len(f0v) % 2))  # odd window
    local_med = sps.medfilt(f0v, k)
    for j, i in enumerate(vi):
        off = np.log2(f0[i] / max(local_med[j], 1e-9))
        if abs(off) > 0.75:
            cands = f0[i] * 2.0 ** np.arange(-2, 3)
            cands = cands[(cands >= f0_floor) & (cands <= f0_ceil)]
            snapped = False
            if len(cands):
                snap = cands[np.argmin(np.abs(np.log2(
                    cands / local_med[j])))]
                if abs(np.log2(snap / local_med[j])) < 0.3:
                    f0[i] = snap
                    snapped = True
            if not snapped:
                f0[i] = 0.0
    return f0


def dio(
    x: np.ndarray,
    fs: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
    frame_period: float = 10.0,
    channels_in_octave: float = 2.0,
    allowed_deviation: float = 0.1,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (temporal_positions [T] sec, f0 [T] Hz, 0 = unvoiced);
    T = len(x)/fs/frame_period + 1 (matching pyworld's frame count)."""
    x = np.asarray(x, np.float64)
    n_frames = int(len(x) / fs * 1000.0 / frame_period) + 1
    frame_times = np.arange(n_frames) * frame_period / 1000.0

    # decimate so per-channel filtering stays cheap; keep >= 8*f0_ceil
    dec = max(int(fs // max(8.0 * f0_ceil, 2000.0)), 1)
    if dec > 1:
        xd = sps.decimate(x, dec, zero_phase=True)
        fsd = fs / dec
    else:
        xd, fsd = x, float(fs)
    xd = _highpass(xd, fsd, 50.0)

    n_ch = int(np.ceil(np.log2(f0_ceil / f0_floor) * channels_in_octave)) + 1
    boundaries = f0_floor * 2.0 ** (np.arange(1, n_ch + 1)
                                    / channels_in_octave)

    best_f0 = np.zeros(n_frames)
    best_dev = np.full(n_frames, np.inf)
    for boundary in boundaries:
        y = _lowpass(xd, fsd, boundary)
        tracks = _four_interval_tracks(y, fsd, frame_times)
        with np.errstate(invalid="ignore"), np.errstate(all="ignore"):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)
                cand = np.nanmean(tracks, axis=0)
                dev = np.nanstd(tracks, axis=0)
            # a voiced frame has all four trackers agreeing; noise that
            # survives the low-pass gives partial/contradictory tracks
            n_ok = np.sum(np.isfinite(tracks), axis=0)
            ok = (
                (n_ok == 4)
                & np.isfinite(cand) & np.isfinite(dev)
                & (cand >= f0_floor) & (cand <= f0_ceil)
                # the fundamental must actually live in THIS channel
                # (within ~an octave below the cutoff): a too-high cutoff
                # lets harmonics through, a too-low one leaves only a
                # subharmonic-looking residue — both cause octave errors
                & (cand >= boundary / 2.4) & (cand <= boundary * 1.1)
            )
            rel_dev = np.where(ok, dev / np.maximum(cand, 1e-9), np.inf)
        better = rel_dev < best_dev
        best_f0 = np.where(better, cand, best_f0)
        best_dev = np.where(better, rel_dev, best_dev)

    f0 = np.where(best_dev <= allowed_deviation, best_f0, 0.0)

    # energy gate: periodicity found in near-silent (or fricative-noise)
    # frames is spurious — unvoice frames whose low-band RMS is far below
    # the utterance's voiced level
    y_low = _lowpass(xd, fsd, min(f0_ceil * 1.5, fsd / 2 * 0.9))
    half_w = int(0.5 * frame_period / 1000.0 * fsd)
    centers = np.clip((frame_times * fsd).astype(int), 0, len(y_low) - 1)
    sq = np.concatenate([[0.0], np.cumsum(y_low ** 2)])
    lo = np.maximum(centers - half_w, 0)
    hi = np.minimum(centers + half_w + 1, len(y_low))
    rms = np.sqrt((sq[hi] - sq[lo]) / np.maximum(hi - lo, 1))
    ref_rms = np.percentile(rms, 95)
    f0 = np.where(rms >= 0.1 * ref_rms, f0, 0.0)

    f0 = fix_f0_contour(f0, f0_floor, f0_ceil)

    # contour fixing: drop 1-2 frame voiced blips and bridge 1-frame gaps
    voiced = f0 > 0
    for i in range(1, n_frames - 1):
        if not voiced[i] and voiced[i - 1] and voiced[i + 1]:
            f0[i] = 0.5 * (f0[i - 1] + f0[i + 1])
            voiced[i] = True
    run_start = 0
    for i in range(1, n_frames + 1):
        if i == n_frames or voiced[i] != voiced[i - 1]:
            if i <= n_frames and voiced[run_start] and (i - run_start) <= 2:
                f0[run_start:i] = 0.0
            run_start = i
    return frame_times, f0


def stonemask(
    x: np.ndarray,
    fs: int,
    temporal_positions: np.ndarray,
    f0: np.ndarray,
    n_harmonics: int = 6,
) -> np.ndarray:
    """Refine DIO's f0 by harmonic-weighted mean instantaneous frequency
    (two passes, like pyworld.stonemask)."""
    x = np.asarray(x, np.float64)
    refined = f0.copy()
    for _ in range(2):
        out = refined.copy()
        for t in range(len(refined)):
            cur = refined[t]
            if cur <= 0:
                continue
            half = int(1.5 * fs / cur) + 1
            c = int(round(temporal_positions[t] * fs))
            lo, hi = c - half, c + half + 1
            if lo < 0 or hi + 1 > len(x):
                continue
            seg = x[lo:hi]
            w = np.blackman(len(seg))
            nfft = 1 << int(np.ceil(np.log2(len(seg) + 1)) + 1)
            s0 = np.fft.rfft(seg * w, nfft)
            s1 = np.fft.rfft(x[lo + 1:hi + 1] * w, nfft)
            # instantaneous frequency: phase advance over one sample
            inst = np.angle(s1 * np.conj(s0)) * fs / (2 * np.pi)
            freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
            num = 0.0
            den = 0.0
            kmax = min(n_harmonics, int((fs / 2) / cur))
            for k in range(1, kmax + 1):
                b = int(round(k * cur * nfft / fs))
                if b >= len(freqs):
                    break
                amp = np.abs(s0[b])
                num += amp * inst[b] / k
                den += amp
            if den > 0:
                cand = num / den
                if 0.5 * cur < cand < 2.0 * cur:
                    out[t] = cand
        refined = out
    return refined


def extract_pitch_world(
    wav: np.ndarray,
    sample_rate: int,
    hop_length: int,
    f0_floor: float = 71.0,
    f0_ceil: float = 800.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Reference-shaped API (`preprocess/pitch.py:20-35`): DIO+StoneMask
    -> (f0 [T], cf0 = log interpolated f0 [T], vuv [T]); T matches the
    mel frame count 1 + len(wav)//hop."""
    frame_period = hop_length / sample_rate * 1000.0
    times, f0 = dio(wav, sample_rate, f0_floor=f0_floor, f0_ceil=f0_ceil,
                    frame_period=frame_period)
    f0 = stonemask(wav, sample_rate, times, f0)
    n = 1 + len(wav) // hop_length
    if len(f0) < n:
        f0 = np.pad(f0, (0, n - len(f0)))
    f0 = f0[:n]
    vuv = (f0 > 0).astype(np.float32)
    # gap interpolation + log, like nnmnkwii interp1d -> to_log_scale
    cf0 = f0.copy()
    voiced_idx = np.where(f0 > 0)[0]
    if len(voiced_idx) > 0:
        cf0 = np.interp(np.arange(n), voiced_idx, f0[voiced_idx])
    out = np.zeros_like(cf0)
    np.log(cf0, out=out, where=cf0 > 0)
    return f0.astype(np.float32), out.astype(np.float32), vuv
