"""Disk memoization for expensive dataset builds.

Responsibility-parity with the reference's `util.cache_result_on_disk`
(SURVEY.md §3): pickle the result of a slow, pure function keyed on its
arguments, so dataset construction runs once and loads instantly afterwards.
The port's own copy of the JAX package's `utils/cache.py`.
"""
from __future__ import annotations

import functools
import hashlib
import os
import pickle


def cache_result_on_disk(path, forced=False, min_time=None):
    """Decorator: cache the wrapped function's result at `path`.

    `path` may contain `{hash}`, replaced by a digest of the call arguments so
    different arguments get different cache files.
    """

    def decorator(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            digest = hashlib.sha1(
                repr((fn.__module__, fn.__qualname__, args, sorted(kwargs.items()))).encode()
            ).hexdigest()[:16]
            cache_path = path.format(hash=digest)
            if not forced and os.path.exists(cache_path):
                if min_time is None or os.path.getmtime(cache_path) >= min_time:
                    with open(cache_path, "rb") as f:
                        return pickle.load(f)
            result = fn(*args, **kwargs)
            os.makedirs(os.path.dirname(cache_path) or ".", exist_ok=True)
            tmp = cache_path + ".tmp"
            with open(tmp, "wb") as f:
                pickle.dump(result, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, cache_path)
            return result

        return wrapper

    return decorator
