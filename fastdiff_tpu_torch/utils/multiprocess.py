"""Order-preserving multiprocess map for preprocessing, a copy of
``fastdiff_tpu/utils/multiprocess.py``.

``chunked_multiprocess_run`` fans a list of argument tuples over worker
processes and yields the results in submission order; a worker that raises
yields ``None`` after printing its traceback, so one bad file skips its item
and the run goes on (the reference's behaviour). The workers are spawned,
not forked (the calling process may hold torch's threads), so ``fn`` must be
importable by its path.
"""

from __future__ import annotations

import multiprocessing
import os
import traceback
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Iterable, List


def _trampoline(fn: Callable, args):
    try:
        return fn(*args)
    except Exception:
        traceback.print_exc()
        return None


def chunked_multiprocess_run(fn: Callable, args_list: List,
                             num_workers: int = None) -> Iterable:
    """Yield ``fn(*args)`` for each args tuple, in order, using a process
    pool; ``num_workers <= 1`` runs inline (no pool)."""
    if num_workers is None:
        num_workers = int(os.getenv("N_PROC", os.cpu_count() or 1))
    if num_workers <= 1:
        for args in args_list:
            yield _trampoline(fn, args)
        return
    with ProcessPoolExecutor(
            max_workers=num_workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = [pool.submit(_trampoline, fn, args) for args in args_list]
        for fut in futures:
            yield fut.result()
