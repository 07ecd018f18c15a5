"""A writer pool for the dataset driver's tests, put in place of
``driver.ThreadPoolExecutor``: it notes how far the writes fall behind.
Imports neither JAX nor ``dvd_tpu``, so the card's tests use it too."""

from concurrent.futures import ThreadPoolExecutor


class CountingPool(ThreadPoolExecutor):
    """Notes, at each write queued, how many writes queued before it were
    not yet done (``most``: the largest count, over every pool)."""

    most = 0

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.futures = []

    def submit(self, *args, **kwargs):
        busy = sum(not f.done() for f in self.futures)
        CountingPool.most = max(CountingPool.most, busy)
        fut = super().submit(*args, **kwargs)
        self.futures.append(fut)
        return fut
