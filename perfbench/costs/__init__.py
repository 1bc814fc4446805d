"""The yardstick's arithmetic: the chip's peaks (``peaks.py``), the
kernels' operations, bytes and roofline bounds (``kernels.py``) and the
model's analytic FLOPs (``flops.py``)."""
