"""Host-side fan-out helper, API-compatible with the reference's
parallel_map (reference: scripts/utils/paralell_utils.py:6-69).

Counterpart of mq3d_tpu/utils/parallel_utils.py: the heavy fan-outs are
batch dimensions on the device, so this helper serves IO scripts, keeps the
per-item exception-swallowing semantics (`default_on_error`) and maps
multiprocessing to a thread pool (the work is IO-bound, and one process
owns the card).  tqdm is imported only when a progress bar is asked for.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Iterable, List, Optional


class ParallelWorker:
    def __init__(self, func: Callable, default=None):
        self.func = func
        self.default = default

    def __call__(self, args):
        try:
            if isinstance(args, tuple):
                return self.func(*args)
            return self.func(args)
        except Exception as e:
            print(f"[Error] {self.func.__name__} failed: {e}")
            return self.default


def parallel_map(
    func: Callable,
    args_list: List[Any],
    max_workers: Optional[int] = None,
    use_multiprocessing: bool = False,
    context: str = "spawn",  # accepted for API compat; threads are used
    default_on_error=None,
    show_progress: bool = False,
    desc: Optional[str] = None,
) -> List[Any]:
    del context
    worker = ParallelWorker(func, default_on_error)

    def progress(it):
        if not show_progress:
            return it
        from tqdm import tqdm

        return tqdm(it, total=len(args_list), desc=desc)

    if not use_multiprocessing or len(args_list) <= 1:
        it: Iterable = progress(args_list)
        return [worker(a) for a in it]

    with ThreadPoolExecutor(max_workers=max_workers) as ex:
        return list(progress(ex.map(worker, args_list)))
