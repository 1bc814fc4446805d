"""Objective synthesis-quality metrics: MCD, mel L1, F0 RMSE, VUV error.

Counterpart of ``promptttspp_tpu/eval/metrics.py``, which scores a
synthesis run without listeners (the reference scores it by listening):

- **MCD** (mel-cepstral distortion, dB): DCT-II cepstra of the log-mel,
  c1..c12, DTW-aligned (synthesized durations differ from the ground
  truth), (10/ln 10) * sqrt(2 * ||Δc||²).
- **mel L1** over the DTW path.
- **F0 RMSE** (cents, over frames voiced in both on the DTW path) and the
  **VUV error rate**, F0 from the port's YIN (``ops/f0.py``).

The mel and YIN run on the card; the DTW and the metrics stay numpy on the
host, as in JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from promptttspp_tpu_torch.ops.f0 import extract_f0
from promptttspp_tpu_torch.ops.mel import MelSpectrogramTransform
from promptttspp_tpu_torch.platform import resolve_device


def mel_cepstra(log_mel: np.ndarray, n_coef: int = 13) -> np.ndarray:
    """[T, M] log-mel -> [T, n_coef] DCT-II (orthonormal) cepstra.
    c0 carries energy; MCD conventionally uses c1..c12."""
    T, M = log_mel.shape
    n = np.arange(M)
    k = np.arange(n_coef)
    basis = np.cos(np.pi * (2 * n[None, :] + 1) * k[:, None] / (2 * M))
    scale = np.full((n_coef, 1), np.sqrt(2.0 / M))
    scale[0, 0] = np.sqrt(1.0 / M)
    return log_mel @ (basis * scale).T


def dtw_path(x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """Euclidean DTW between [T1, D] and [T2, D]; returns the aligned
    index pairs [L, 2]. O(T1*T2) dp — fine for ≤ few-thousand frames."""
    T1, T2 = len(x), len(y)
    dist = np.sqrt(
        np.maximum(
            (x * x).sum(1)[:, None] + (y * y).sum(1)[None, :]
            - 2.0 * (x @ y.T), 0.0))
    acc = np.full((T1 + 1, T2 + 1), np.inf)
    acc[0, 0] = 0.0
    for i in range(1, T1 + 1):
        m = np.minimum(acc[i - 1, 1:], acc[i - 1, :-1])
        # acc[i, j] depends on acc[i, j-1): sequential in j
        row = acc[i]
        row_prev = dist[i - 1]
        run = np.empty(T2)
        left = np.inf
        for j in range(T2):
            best = min(m[j], left)
            left = row_prev[j] + best
            run[j] = left
        acc[i, 1:] = run
    # backtrack
    i, j = T1, T2
    path = []
    while i > 0 and j > 0:
        path.append((i - 1, j - 1))
        steps = ((acc[i - 1, j - 1], i - 1, j - 1),
                 (acc[i - 1, j], i - 1, j),
                 (acc[i, j - 1], i, j - 1))
        _, i, j = min(steps, key=lambda s: s[0])
    return np.asarray(path[::-1], dtype=np.int64)


_MCD_CONST = 10.0 / np.log(10.0) * np.sqrt(2.0)


def mcd(log_mel_a: np.ndarray, log_mel_b: np.ndarray,
        n_coef: int = 13, path: Optional[np.ndarray] = None) -> float:
    """Mel-cepstral distortion (dB) between two [T, M] log-mels,
    DTW-aligned on the cepstra (c1.. used for both alignment and the
    distortion, the standard recipe when no oracle alignment exists)."""
    ca = mel_cepstra(log_mel_a, n_coef)[:, 1:]
    cb = mel_cepstra(log_mel_b, n_coef)[:, 1:]
    if path is None:
        path = dtw_path(ca, cb)
    d = ca[path[:, 0]] - cb[path[:, 1]]
    return float(np.mean(_MCD_CONST * np.sqrt((d * d).sum(1))))


def mel_l1(log_mel_a: np.ndarray, log_mel_b: np.ndarray,
           path: Optional[np.ndarray] = None) -> float:
    if path is None:
        path = dtw_path(mel_cepstra(log_mel_a)[:, 1:],
                        mel_cepstra(log_mel_b)[:, 1:])
    return float(np.mean(np.abs(
        log_mel_a[path[:, 0]] - log_mel_b[path[:, 1]])))


def f0_metrics(f0_a: np.ndarray, vuv_a: np.ndarray,
               f0_b: np.ndarray, vuv_b: np.ndarray,
               path: np.ndarray) -> Dict[str, float]:
    """F0 RMSE in cents over both-voiced aligned frames + VUV error rate
    over the DTW path. f0_* in Hz ([T]), vuv_* boolean-ish [T]."""
    va = vuv_a[path[:, 0]] > 0.5
    vb = vuv_b[path[:, 1]] > 0.5
    both = va & vb
    out = {"vuv_error": float(np.mean(va != vb))}
    if both.any():
        fa = np.maximum(f0_a[path[:, 0]][both], 1e-6)
        fb = np.maximum(f0_b[path[:, 1]][both], 1e-6)
        cents = 1200.0 * np.log2(fa / fb)
        out["f0_rmse_cents"] = float(np.sqrt(np.mean(cents ** 2)))
    else:
        out["f0_rmse_cents"] = float("nan")
    return out


def evaluate_pair(wav_ref: np.ndarray, wav_syn: np.ndarray,
                  sample_rate: int = 24000, to_mel=None,
                  device="cuda") -> Dict[str, float]:
    """All metrics for one (ground-truth, synthesized) wav pair; the mels
    and one batched YIN call of both wavs on ``device`` (``cuda`` unless
    given ``"cpu"``). ``to_mel``: a ``MelSpectrogramTransform``; default
    the flagship's 80-mel frontend (``ops/mel.py``)."""
    dev = resolve_device(device)
    if to_mel is None:
        to_mel = MelSpectrogramTransform(sample_rate=sample_rate)

    def _t(x):
        return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

    # one batched YIN call (padded tails are unvoiced)
    n = max(len(wav_ref), len(wav_syn))
    pad = np.zeros((2, n), np.float32)
    pad[0, :len(wav_ref)] = wav_ref
    pad[1, :len(wav_syn)] = wav_syn
    with torch.inference_mode():
        ma = to_mel(_t(wav_ref)[None])[0].cpu().numpy()
        mb = to_mel(_t(wav_syn)[None])[0].cpu().numpy()
        f0, vuv = extract_f0(_t(pad), sample_rate=sample_rate,
                             hop_length=to_mel.hop_length)
    f0, vuv = f0.cpu().numpy(), vuv.cpu().numpy()
    ca = mel_cepstra(ma)[:, 1:]
    cb = mel_cepstra(mb)[:, 1:]
    path = dtw_path(ca, cb)
    # the mel (center=True) and f0 frame grids share the hop but can differ
    # by an edge frame; clamp the DTW path into the f0 grid
    fpath = np.stack([np.minimum(path[:, 0], f0.shape[1] - 1),
                      np.minimum(path[:, 1], f0.shape[1] - 1)], axis=1)

    out = {"mcd": mcd(ma, mb, path=path),
           "mel_l1": mel_l1(ma, mb, path=path)}
    out.update(f0_metrics(f0[0], vuv[0], f0[1], vuv[1], fpath))
    out["dur_ratio"] = float(len(wav_syn) / max(len(wav_ref), 1))
    return out


def summarize(per_utt: Sequence[Dict[str, float]]) -> Dict[str, float]:
    """Mean of each metric over utterances (nan-safe for f0 on fully
    unvoiced clips)."""
    keys = sorted({k for d in per_utt for k in d})
    return {k: float(np.nanmean([d[k] for d in per_utt if k in d]))
            for k in keys}
