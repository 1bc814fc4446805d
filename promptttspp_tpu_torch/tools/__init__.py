"""Measurement scripts of the port, each run as ``python3 -m``."""
