"""Bounded async write worker for the checkpoint pipeline.

The old ``save_checkpoint(background=True)`` fired a daemon thread that
was never joined and whose exceptions evaporated with the thread — a
failed write silently *lost the checkpoint*.  `AsyncWriter` is the real
version of that idea:

  * one worker thread drains a bounded queue of write closures;
  * ``submit`` blocks when the queue is full — this is the natural
    back-pressure barrier the trainer relies on when the writer falls
    behind the step loop;
  * transient failures (``retryable``, default: `OSError`) are retried
    in the worker with exponential backoff up to ``retries`` times
    before being captured — a flaky-filesystem blip costs latency, not
    the checkpoint;
  * the first exception a task exhausts its retries on is captured and
    re-raised (same exception object) at the next
    ``submit``/``wait``/``close`` call, so a failed checkpoint write
    surfaces in the training loop instead of vanishing;
  * ``wait(timeout=)`` joins every pending task (the pre-shutdown /
    pre-restore barrier), raising `TimeoutError` if the writer is stuck.

Thread-safety note: tasks run device-to-host copies and numpy I/O;
both are safe off the main thread, and the single worker serializes
writes so shard files of step N never interleave with step N+1.
"""
from __future__ import annotations

import queue
import threading
import time
import warnings
from typing import Any, Callable, Optional

_SENTINEL = object()


def _default_retryable(e: BaseException) -> bool:
    """Transient-by-default classification: I/O layer errors (OSError)
    retry; everything else — bugs, assertion failures, encode errors —
    fails fast."""
    return isinstance(e, OSError)


class AsyncWriter:
    """One worker thread + bounded task queue with retry and re-raise."""

    def __init__(self, max_pending: int = 2, name: str = "ckpt-writer",
                 retries: int = 0, backoff_s: float = 0.01,
                 retryable: Callable[[BaseException], bool]
                 = _default_retryable):
        assert max_pending >= 1, max_pending
        assert retries >= 0, retries
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=max_pending)
        self._err: Optional[BaseException] = None
        self._err_lock = threading.Lock()
        self._closed = False
        self.retries = int(retries)
        self.backoff_s = float(backoff_s)
        self.retryable = retryable
        self.n_retries = 0          # telemetry: total retry attempts made
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()

    # -- public API ---------------------------------------------------------

    def submit(self, fn: Callable[..., Any], *args, **kwargs) -> None:
        """Enqueue ``fn(*args, **kwargs)``; blocks while the queue is full
        (the writer-fell-behind barrier).  Raises any pending error from
        an earlier task before accepting new work."""
        self._raise_pending()
        if self._closed:
            raise RuntimeError("AsyncWriter is closed")
        self._q.put((fn, args, kwargs))

    def wait(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted task has finished, then re-raise
        the first captured task exception, if any.  With ``timeout`` (in
        seconds), raise `TimeoutError` if tasks are still pending when it
        expires — the stuck-writer escape hatch for shutdown paths."""
        if timeout is None:
            self._q.join()
        else:
            # Queue.join() has no timeout; wait on the same condition it
            # uses, bounded by a deadline.
            deadline = time.monotonic() + timeout
            with self._q.all_tasks_done:
                while self._q.unfinished_tasks:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        raise TimeoutError(
                            f"AsyncWriter.wait: {self._q.unfinished_tasks} "
                            f"task(s) still pending after {timeout}s")
                    self._q.all_tasks_done.wait(remaining)
        self._raise_pending()

    # legacy spelling: the old API returned a Thread with .join()
    join = wait

    def close(self) -> None:
        """Drain, stop the worker thread, and surface any pending error
        — including one captured *after* the final submit, which a caller
        that never reaches ``wait`` would otherwise lose."""
        if not self._closed:
            self._closed = True
            self._q.put(_SENTINEL)
            self._thread.join()
        self._raise_pending()

    @property
    def pending_error(self) -> Optional[BaseException]:
        """The captured-but-not-yet-re-raised task exception, if any."""
        return self._err

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        # don't mask an in-flight exception with a writer error — but
        # don't silently drop it either: it stays in `pending_error` and
        # is announced as a warning alongside the propagating exception
        if exc_type is None:
            self.close()
        else:
            self._closed = True
            self._q.put(_SENTINEL)
            self._thread.join()
            if self._err is not None:
                warnings.warn(
                    f"AsyncWriter: a write task also failed "
                    f"({self._err!r}); it is masked by the in-flight "
                    f"{exc_type.__name__} and kept in .pending_error",
                    RuntimeWarning, stacklevel=2)

    # -- internals ----------------------------------------------------------

    def _raise_pending(self) -> None:
        with self._err_lock:
            err, self._err = self._err, None
        if err is not None:
            raise err

    def _run_task(self, fn, args, kwargs) -> None:
        for attempt in range(self.retries + 1):
            try:
                fn(*args, **kwargs)
                return
            except BaseException as e:             # noqa: BLE001
                if attempt < self.retries and self.retryable(e):
                    self.n_retries += 1
                    time.sleep(self.backoff_s * (2 ** attempt))
                    continue
                with self._err_lock:
                    if self._err is None:          # keep the first failure
                        self._err = e
                return

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            try:
                if item is _SENTINEL:
                    return
                fn, args, kwargs = item
                self._run_task(fn, args, kwargs)
            finally:
                self._q.task_done()
