"""Timer (counterpart of ``singa_tpu/utils/timer.py``)."""

import time

__all__ = ["Timer"]


class Timer:
    """``t = Timer(); ...; t.elapsed()`` -> seconds.  Also a context
    manager: ``seconds`` is None until a ``with`` block exits, then the
    block's duration (a re-entered timer overwrites it)."""

    def __init__(self):
        self.seconds = None
        self.reset()

    def reset(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0

    def __enter__(self):
        self.reset()
        return self

    def __exit__(self, *a):
        self.seconds = self.elapsed()
