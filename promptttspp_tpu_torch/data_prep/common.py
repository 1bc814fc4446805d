"""Helpers shared by the data-prep command lines: their logger, the
LibriTTS speaker table and a wav reader.

Counterpart of the root ``data_prep/common.py``.
"""

from __future__ import annotations

import logging
import os
from typing import Dict

import numpy as np

LOG_FORMAT = "%(asctime)s (%(module)s:%(lineno)d) %(levelname)s: %(message)s"
# the speakers of --debug
DEBUG_SPEAKERS = {1188, 1995, 260, 89, 90, 91, 100, 101, 102, 1001}


def get_logger(verbose: int = 0, filename=None,
               name: str = "promptttspp_tpu_torch") -> logging.Logger:
    """A logger to stderr and, given ``filename``, to that file (its
    directory made); DEBUG at ``verbose`` >= 100, INFO above 0, else
    WARN. The handlers of an earlier call are closed and replaced, so a
    command line run twice in one process logs each line once."""
    logger = logging.getLogger(name)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    if verbose >= 100:
        logger.setLevel(logging.DEBUG)
    elif verbose > 0:
        logger.setLevel(logging.INFO)
    else:
        logger.setLevel(logging.WARN)
    sh = logging.StreamHandler()
    sh.setFormatter(logging.Formatter(LOG_FORMAT))
    logger.addHandler(sh)
    if filename is not None:
        os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
        fh = logging.FileHandler(filename=filename)
        fh.setLevel(logging.INFO)
        fh.setFormatter(logging.Formatter(LOG_FORMAT))
        logger.addHandler(fh)
    return logger


def load_libritts_spk_metadata(path="external/speakers.tsv",
                               debug: bool = False) -> Dict[str, Dict]:
    """LibriTTS's ``speakers.tsv`` -> {speaker: {gender, subset, name}};
    rows of 3 fields get the name "Unknown", other rows are skipped.
    ``debug`` keeps ``DEBUG_SPEAKERS``."""
    spk2meta = {}
    with open(path) as f:
        for line in f.readlines()[1:]:
            vals = line.strip().split("\t")
            if len(vals) == 4:
                spk, gender, subset, name = vals
            elif len(vals) == 3:
                spk, gender, subset = vals
                name = "Unknown"
            else:
                continue
            spk2meta[spk] = {"gender": gender, "subset": subset, "name": name}
    if debug:
        spk2meta = {k: v for k, v in spk2meta.items()
                    if int(k) in DEBUG_SPEAKERS}
    return spk2meta


def read_wav_any(path):
    """A wav file -> (float64 mono in [-1, 1], sample rate)."""
    from scipy.io import wavfile

    sr, x = wavfile.read(path)
    if x.dtype == np.int16:
        x = x / 32768.0
    elif x.dtype == np.int32:
        x = x / 2147483648.0
    else:
        x = x.astype(np.float64)
    if x.ndim > 1:
        x = x.mean(axis=1)
    return x, sr
