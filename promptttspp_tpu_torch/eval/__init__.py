"""Objective synthesis-quality metrics of the port (``eval/metrics.py``)."""
