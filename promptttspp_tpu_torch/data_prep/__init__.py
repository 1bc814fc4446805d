"""Per-utterance audio statistics of the port."""
