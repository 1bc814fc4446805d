"""TextGrid -> (phoneme ids, integer frame durations).

Counterpart of ``promptttspp_tpu/preprocess/duration.py`` (the reference's
``promptttspp/preprocess/duration.py``): BOS/EOS segments injected (10 ms
taken from the first and last segment), boundaries rounded to the hop, and
the EOS duration absorbing the remainder, so that sum(durations) ==
n_frames == (len(wav) + n_fft//2) // hop.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from promptttspp_tpu_torch.preprocess.textgrid import Entry, read_textgrid
from promptttspp_tpu_torch.text.eng import text_to_sequence


def adjust_textgrid(labels: List[Entry]) -> List[Entry]:
    """Inject BOS/EOS segments (`duration.py:20-49`)."""
    labels = list(labels)
    if labels[0].name in ("sil", "sp", ""):
        lbl = labels[0]
        labels[0] = Entry(lbl.start, lbl.stop, "^", lbl.tier)
    else:
        if len(labels) < 2:
            raise ValueError(f"one segment without silence: {labels}")
        if labels[0].stop - labels[0].start > 0.01:
            bos = Entry(0.0, 0.01, "^", "phone")
            lbl = labels[0]
            labels[0] = Entry(bos.stop, lbl.stop, lbl.name, lbl.tier)
            labels = [bos] + labels

    if len(labels) < 2:
        raise ValueError(f"fewer than 2 segments: {labels}")
    lbl = labels[-1]
    eos = Entry(lbl.stop - 0.01, lbl.stop, "$", "phone")
    labels[-1] = Entry(lbl.start, eos.start, lbl.name, lbl.tier)
    return labels + [eos]


def _round_by_hop(sec: float, sr: int = 24000, hop: int = 240) -> float:
    return round(sec * sr / hop) * hop / sr


def textgrid_to_phone_durations(
    labels: List[Entry], sr: int = 24000, hop: int = 240,
    feats_len: Optional[int] = None,
) -> Tuple[List[str], np.ndarray]:
    """(`duration.py:57-82`)."""
    ph_seq, durations = [], []
    for lbl in labels:
        ph = lbl.name if lbl.name != "" else "sil"
        ph_seq.append(ph)
        d = (_round_by_hop(lbl.stop, sr, hop)
             - _round_by_hop(lbl.start, sr, hop))
        if d <= 0:
            raise RuntimeError(f"Too short segment is detected: {lbl}")
        durations.append(round(sr / hop * d))

    if feats_len is not None:
        if ph_seq[-1] != "$":
            raise ValueError(f"the last segment is {ph_seq[-1]!r}, not EOS")
        eos_dur = feats_len - sum(durations[:-1])
        if eos_dur < 0:
            raise ValueError(f"the segments overrun {feats_len} frames")
        durations[-1] = eos_dur
    return ph_seq, np.asarray(durations)


def process_textgrid(
    spk, utt_id, wav, textgrid_path, sample_rate: int = 24000,
    n_fft: int = 512, hop_length: int = 240,
):
    """(`duration.py:86-117`). Returns (phoneme ids, durations) or None."""
    labels = read_textgrid(str(textgrid_path))
    if len(labels) == 1:
        print(f"{utt_id} is ignored: only one phone is detected")
        return None
    feats_len = (wav.shape[-1] + n_fft // 2) // hop_length
    labels = adjust_textgrid(labels)
    try:
        ph_seq, durations = textgrid_to_phone_durations(
            labels, sr=sample_rate, hop=hop_length, feats_len=feats_len)
    except RuntimeError as e:
        print(f"{utt_id} is ignored: {e}")
        return None

    seq = text_to_sequence(" ".join(ph_seq), add_special_token=False)
    if len(durations) != len(seq) or durations.sum() != feats_len:
        raise ValueError(f"{utt_id}: {len(durations)} durations summing to "
                         f"{durations.sum()} for {len(seq)} phonemes and "
                         f"{feats_len} frames")
    return seq, durations
