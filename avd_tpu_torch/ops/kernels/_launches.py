"""Launch counters and symbol caches of the kernel wrappers, safe across
host threads.

The dispatch thread of ``ops/video_features`` (``_dispatch_pool``) and
the window batcher launch kernels at the same time as the calling
thread.  A wrapper's counters stay plain module globals (``LAUNCHES``
and tables by dtype or kernel beside it), read and reset by attribute
access as before; ``+= 1`` on them is a read-modify-write, so every
raise goes through ``count`` under one lock.  A wrapper's ctypes
functions are bound once, under a second lock, and published only once
their argument types are set (``symbol``).
"""

from __future__ import annotations

import threading

_count_lock = threading.Lock()
_symbol_lock = threading.Lock()


def count(namespace: dict, *tables) -> None:
    """Raise ``namespace["LAUNCHES"]`` by one and, for each pair ``table,
    key`` in ``tables``, ``namespace[table][key]`` with it: the wrapper
    passes its module's ``globals()``."""
    with _count_lock:
        namespace["LAUNCHES"] += 1
        for table, key in zip(tables[::2], tables[1::2]):
            namespace[table][key] += 1


def symbol(cache: dict, key, bind):
    """``cache[key]``, made by ``bind()`` on first use under a lock."""
    fn = cache.get(key)
    if fn is None:
        with _symbol_lock:
            fn = cache.get(key)
            if fn is None:
                fn = cache[key] = bind()
    return fn
