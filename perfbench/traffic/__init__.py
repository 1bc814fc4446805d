"""Traffic drivers, one per kind (``<driver>.py``: ``run(run)`` sets up,
drives the measured window and keeps what the check needs; ``check(run)``
compares it with the reference), and the generators they share: serving
requests and arrivals (``requests.py``), the training corpus
(``corpus.py``). A mix is the ``params`` of a cell's
``workloads/<cell>.json``.
"""
