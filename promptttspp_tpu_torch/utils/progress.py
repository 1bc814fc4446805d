"""A thread-pool map with an optional progress bar.

Counterpart of ``promptttspp_tpu/utils/progress.py``: the work it maps is
numpy or file IO, which releases the GIL, so threads stand in for the
reference's joblib processes; tqdm draws the bar where it is installed.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor, as_completed
from typing import Callable, Iterable, List, Optional


def progress_map(fn: Callable, items: Iterable, n_jobs: int = 8,
                 desc: Optional[str] = None) -> List:
    """[fn(item) for item in items], run on ``n_jobs`` threads, in the
    items' order."""
    items = list(items)
    try:
        from tqdm.auto import tqdm

        bar = tqdm(total=len(items), desc=desc, dynamic_ncols=True)
    except ImportError:
        bar = None
    results = [None] * len(items)
    with ThreadPoolExecutor(max_workers=n_jobs) as ex:
        futures = {ex.submit(fn, it): i for i, it in enumerate(items)}
        for fut in as_completed(futures):
            results[futures[fut]] = fut.result()
            if bar is not None:
                bar.update(1)
    if bar is not None:
        bar.close()
    return results
