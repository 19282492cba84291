"""Background-thread iterator prefetcher of the blocked inference loops
(infer/query.py, infer/classify.py; the port's copy of the JAX package's
``utils/prefetch.py``): host work for item z+1 (file parse) overlaps device
compute for item z.

Failure semantics, both directions:
- producer raises -> the exception is re-raised in the CONSUMER, so it is
  not lost in the dead daemon thread while the consumer waits on q.get()
  forever;
- consumer raises or abandons the generator -> a stop event releases the
  producer, so it does not block in q.put holding parsed items for the
  process lifetime.
"""

from __future__ import annotations

import threading
from queue import Full, Queue

_DONE = object()
_ERR = object()


def prefetch_iter(items_iter, depth: int = 2):
    """Yield from `items_iter`, computed `depth` items ahead in a daemon
    thread."""
    q: Queue = Queue(maxsize=depth)
    stop = threading.Event()

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except Full:
                continue
        return False

    def worker():
        try:
            for item in items_iter:
                if not _put(item):
                    return
        except BaseException as e:  # re-raise in the consumer, not the thread
            _put((_ERR, e))
            return
        _put(_DONE)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                return
            if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
                raise item[1]
            yield item
    finally:
        stop.set()
