"""Host-side prefetching for the streaming-inference loop. (The batch loader
of training is not ported yet.)"""

from __future__ import annotations

import queue
import threading


def prefetch_iter(iterable, depth: int = 2):
    """Run ``iterable`` in a background thread, keeping up to ``depth`` items
    ready ahead of the consumer: frame decoding hides behind the device's
    work. An exception in the producer is raised again at the consumer's next
    pull; leaving the consuming loop early is safe (the producer is a daemon
    thread and gives up on a bounded put once the consumer has gone)."""
    if depth < 1:
        # Queue(maxsize=0) is UNBOUNDED: the producer would decode the whole
        # stream into host memory instead of reading nothing ahead
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    end, err = object(), object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            for item in iterable:
                if not put((None, item)):
                    return
        except BaseException as exc:  # raised again on the consumer's side
            put((err, exc))
            return
        put((end, None))

    threading.Thread(target=produce, daemon=True).start()
    try:
        while True:
            tag, item = q.get()
            if tag is end:
                break
            if tag is err:
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():
            q.get_nowait()
