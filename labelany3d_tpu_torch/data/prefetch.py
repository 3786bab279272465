"""Async host-side prefetching for pipeline stages.

The reference loads each image synchronously inside its per-image loop
(`src/batch_scripts/depth.py:120-127`), serializing disk IO with device
compute. This double-buffered prefetcher overlaps them: a worker pool
decodes the next batches while the device runs the current one.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, Iterator, TypeVar

T = TypeVar("T")


class Prefetcher:
    """Iterate `fn(item)` over `items` with a bounded lookahead.

    At most `depth` decoded-but-unconsumed results exist at any time: workers
    acquire a slot from a counting semaphore before claiming an index, and
    the consumer releases the slot only after popping the result, so host
    memory is bounded by `depth` decoded items regardless of split size.
    """

    def __init__(
        self,
        items: Iterable,
        fn: Callable[..., T],
        depth: int = 4,
        num_workers: int = 2,
    ):
        self.items = list(items)
        self.fn = fn
        self.depth = max(1, depth)
        self.num_workers = max(1, num_workers)

    def __iter__(self) -> Iterator[T]:
        slots = threading.Semaphore(self.depth)
        idx_lock = threading.Lock()
        state = {"next": 0}
        results: dict[int, object] = {}
        res_lock = threading.Lock()
        res_ready = threading.Condition(res_lock)
        n = len(self.items)

        def worker():
            while True:
                slots.acquire()
                with idx_lock:
                    i = state["next"]
                    if i >= n:
                        slots.release()  # hand the slot to a sibling's exit
                        return
                    state["next"] = i + 1
                try:
                    r = self.fn(self.items[i])
                except Exception as e:  # surfaced at consumption order
                    r = e
                with res_ready:
                    results[i] = r
                    res_ready.notify_all()

        threads = [threading.Thread(target=worker, daemon=True) for _ in range(self.num_workers)]
        for t in threads:
            t.start()

        for i in range(n):
            with res_ready:
                while i not in results:
                    res_ready.wait()
                r = results.pop(i)
            slots.release()
            if isinstance(r, Exception):
                raise r
            yield r

    def __len__(self) -> int:
        return len(self.items)
