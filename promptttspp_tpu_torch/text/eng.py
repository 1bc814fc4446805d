"""MFA English (ARPAbet) phoneme inventory and id conversion.

The symbol inventory is shared data with the reference
(the reference's `promptttspp/text/eng.py:11-102`): 84 stress-marked ARPA
phones plus ``spn``/``sil``/``sp`` and the three specials PAD ``_``, BOS
``^``, EOS ``$`` — 90 symbols total, PAD at id 0. Checkpoint compatibility
requires the exact same id assignment.
"""

from __future__ import annotations

from typing import List, Sequence

PAD = "_"
BOS = "^"
EOS = "$"

_VOWELS = ["AA", "AE", "AH", "AO", "AW", "AY", "EH", "ER", "EY",
           "IH", "IY", "OW", "OY", "UH", "UW"]
_CONSONANTS = ["B", "CH", "D", "DH", "F", "G", "HH", "JH", "K", "L", "M",
               "N", "NG", "P", "R", "S", "SH", "T", "TH", "V", "W", "Y",
               "Z", "ZH"]

# ARPA ordering: each vowel contributes the bare symbol plus stress marks
# 0/1/2; consonants are interleaved alphabetically with the vowels. The MFA
# ARPA dictionary enumerates them in plain lexicographic order, which is what
# the reference table is; we generate it rather than hand-list it.
phonemes: List[str] = sorted(
    [v + s for v in _VOWELS for s in ("", "0", "1", "2")] + _CONSONANTS
) + ["spn", "sil", "sp"]

symbols: List[str] = [PAD, BOS, EOS] + phonemes
_symbol2id = {s: i for i, s in enumerate(symbols)}
_id2symbol = {i: s for i, s in enumerate(symbols)}


def num_vocab() -> int:
    return len(symbols)


def symbol_to_id(symbol: str) -> int:
    return _symbol2id[symbol]


def id_to_symbol(idnum: int) -> str:
    return _id2symbol[int(idnum)]


def is_symbol(symbol: str) -> bool:
    return symbol in _symbol2id


def text_to_sequence(text: str, add_special_token: bool = True) -> List[int]:
    """Convert a whitespace-separated phoneme string to ids.

    Mirrors reference behavior (`text/eng.py:117-139`): optional BOS/EOS
    bracketing; unknown phonemes raise KeyError.
    """
    ids = [_symbol2id[ph] for ph in text.split()]
    if add_special_token:
        return [_symbol2id[BOS]] + ids + [_symbol2id[EOS]]
    return ids


def sequence_to_text(seq: Sequence[int], remove_special_token: bool = False) -> List[str]:
    seq = list(seq)
    if remove_special_token:
        seq = seq[1:-1]
    return [_id2symbol[int(s)] for s in seq]
