"""Frozen copy of the port's plain F5-TTS v1 with Vocos
(``promptttspp_tpu_torch/reference/f5tts_plain.py``), which imports only
torch, numpy and math."""
