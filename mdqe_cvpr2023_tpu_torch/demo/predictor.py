"""Ordered asynchronous predictor of the demos (counterpart of the
repository's ``demo/predictor.py``, the reference demo/predictor.py:123-211).

One background worker thread drives the card: the main thread reads frames
and renders overlays while the worker runs inference on the next input. The
put/get contract is the reference's ordered queue.
"""
from __future__ import annotations

import atexit
import bisect
import queue
import threading


class AsyncPredictor:
    """Ordered async wrapper around an arbitrary `predict_fn(data) -> result`.

    put(data) enqueues; get() returns results in submission order (reference
    predictor.py:180-196's rank-buffer semantics). __call__ = put + get
    (synchronous). Exceptions raised by predict_fn are re-raised from get().
    """

    class _StopToken:
        pass

    def __init__(self, predict_fn, buffer_size: int = 3):
        self._predict = predict_fn
        self._tasks: "queue.Queue" = queue.Queue(maxsize=max(buffer_size, 1))
        self._results: "queue.Queue" = queue.Queue()
        self.put_idx = 0
        self.get_idx = 0
        self._rank = []
        self._data = []
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        atexit.register(self.shutdown)

    def _run(self):
        while True:
            task = self._tasks.get()
            if isinstance(task, AsyncPredictor._StopToken):
                break
            idx, data = task
            try:
                result = (False, self._predict(data))
            except BaseException as e:  # surfaced from get()
                result = (True, e)
            self._results.put((idx, result))

    def put(self, data):
        self.put_idx += 1
        self._tasks.put((self.put_idx, data))

    def get(self):
        self.get_idx += 1
        if self._rank and self._rank[0] == self.get_idx:
            res = self._data.pop(0)
            self._rank.pop(0)
            return self._unwrap(res)
        while True:
            idx, res = self._results.get()
            if idx == self.get_idx:
                return self._unwrap(res)
            ins = bisect.bisect(self._rank, idx)
            self._rank.insert(ins, idx)
            self._data.insert(ins, res)

    @staticmethod
    def _unwrap(res):
        is_err, payload = res
        if is_err:
            raise payload
        return payload

    def __len__(self):
        return self.put_idx - self.get_idx

    def __call__(self, data):
        self.put(data)
        return self.get()

    def shutdown(self):
        if self._worker.is_alive():
            self._tasks.put(AsyncPredictor._StopToken())
