"""Style/speaker prompt construction (a copy of
``promptttspp_tpu/data/prompts.py``).

The sample-time prompt synthesis of the reference's dataset: a random
paraphrase per style key, optional "very X" adverb augmentation,
speaker-word prompts (shuffled 5..N words, 3 templates), and the 4
combination patterns (style+spk / spk+style / spk only / style only).
Host-side Python over an injected ``random.Random``, so the same seed gives
the JAX package's prompt strings.
"""

from __future__ import annotations

import random as _random
from typing import Dict, List, Sequence

ADVERBS = ["very", "extremely", "highly", "really", "particularly"]

# (word, also-rewrite-"word," variant) — comma variants exactly as the
# reference enumerates them (`all_with_spk_prompt_norm.py:101-139`)
_PITCH_WORDS = [("high pitch", False), ("high-pitched", True),
                ("low pitch", False), ("low-pitched", True)]
_SPEED_WORDS = [("fast", False), ("quick", False), ("quickly", True),
                ("slow", False), ("slowly", True), ("rapidly", True)]
_ENERGY_WORDS = [("loud", False), ("loudly", True),
                 ("quiet", False), ("quietly", True)]

SPEAKER_TEMPLATES = [
    "The speaker identity can be described as {words}.",
    "The voice characteristics can be described as {words}.",
    "The speaker's voice can be described as {words}.",
]


def _emphasize(prompt: str, words: Sequence, adverb: str) -> str:
    for w, comma in words:
        prompt = prompt.replace(f" {w} ", f" {adverb} {w} ")
        if comma:
            prompt = prompt.replace(f" {w},", f" {adverb} {w},")
    return prompt


def augment_style_prompt(prompt: str, pitch: str, speaking_speed: str,
                         energy: str, p_augment: float,
                         rng: _random.Random) -> str:
    """(`all_with_spk_prompt_norm.py:95-139`). Tags like 'very high' in the
    metadata trigger adverb insertion with probability p_augment."""
    if rng.random() > p_augment:
        return prompt
    if "very" in pitch:
        prompt = _emphasize(prompt, _PITCH_WORDS, rng.choice(ADVERBS))
    if "very" in speaking_speed:
        prompt = _emphasize(prompt, _SPEED_WORDS, rng.choice(ADVERBS))
    if "very" in energy:
        prompt = _emphasize(prompt, _ENERGY_WORDS, rng.choice(ADVERBS))
    return prompt


def words_to_prompt(words: List[str], rng: _random.Random,
                    min_words: int = 5) -> str:
    """(`:141-159`) shuffled subset of descriptor words into a template."""
    words = list(words)
    rng.shuffle(words)
    n_words = rng.randint(min_words, max(min_words, len(words)))
    chosen = words[:n_words]
    template = rng.choice(SPEAKER_TEMPLATES)
    return template.format(words=", ".join(chosen))


def combine_with_spk_prompt(style_prompt: str, spk_id,
                            spk_prompt_candidate: Dict[int, List[str]],
                            rng: _random.Random) -> str:
    """(`:161-173`) one of 4 combination patterns, if the speaker has
    descriptor words."""
    spk_id = int(spk_id)
    if spk_id not in spk_prompt_candidate:
        return style_prompt
    spk_prompt = words_to_prompt(spk_prompt_candidate[spk_id], rng)
    return rng.choice([
        f"{style_prompt} {spk_prompt}",
        f"{spk_prompt} {style_prompt}",
        f"{spk_prompt}",
        f"{style_prompt}",
    ])


def build_prompt(style_prompt_key: str, spk_id, pitch: str,
                 speaking_speed: str, energy: str,
                 prompt_candidate: Dict[str, List[str]],
                 spk_prompt_candidate: Dict[int, List[str]],
                 rng: _random.Random, use_spk_prompt: bool = True,
                 p_augment: float = 0.0) -> str:
    """Full sample-time prompt construction (`__getitem__`, `:196-212`)."""
    style_prompt = rng.choice(prompt_candidate[style_prompt_key])
    style_prompt = augment_style_prompt(
        style_prompt, pitch, speaking_speed, energy, p_augment, rng)
    style_prompt = f"{style_prompt}."
    if use_spk_prompt:
        style_prompt = combine_with_spk_prompt(
            style_prompt, spk_id, spk_prompt_candidate, rng)
    return style_prompt
