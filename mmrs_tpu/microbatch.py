"""Request micro-batching for the serving layer.

The reference serves nothing (batch scripts only); this is the batching
engine the production HTTP layer (serve.py) puts in front of the device.
Concurrent requests are coalesced into single device dispatches: a gallery
top-k scan is bound by device-memory bandwidth, so queries that arrive
together ride one fused kernel launch for ~the price of one.

One worker thread per batcher drains a queue, groups compatible work items
(same `key`, e.g. same top-k), and calls a user handler once per group.
All device interaction therefore happens on a single thread.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Hashable, List, Sequence


@dataclass
class _Item:
    key: Hashable
    payload: Any
    done: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None


class MicroBatcher:
    """Coalesces concurrent `submit()`s into grouped `handler` calls.

    handler(key, payloads: list) -> list of per-payload results (same
    order/length). A handler exception fails every item in its group (the
    callers re-raise it); the worker keeps serving.

    `batch_window` is the extra time (seconds) the worker waits after the
    first queued item for stragglers to join the batch — the knob trading
    a bounded latency bump for fewer device dispatches. `max_batch` caps
    items per handler call (across keys per drain, per group per call).
    """

    def __init__(self, handler: Callable[[Hashable, List[Any]], Sequence[Any]],
                 max_batch: int = 64, batch_window: float = 0.002,
                 name: str = "microbatch"):
        self._handler = handler
        self.max_batch = max_batch
        self.batch_window = batch_window
        self.name = name
        self._queue: "queue.SimpleQueue[_Item | None]" = queue.SimpleQueue()
        self._started = False
        self._start_lock = threading.Lock()
        self._stopped = False

    # -- public api ----------------------------------------------------------

    def submit(self, key: Hashable, payload: Any) -> Any:
        """Enqueue one work item and block until its result is ready."""
        return self.submit_many(key, [payload])[0]

    def submit_many(self, key: Hashable, payloads: Sequence[Any]) -> List[Any]:
        """Enqueue several items (they join the same drain, hence usually
        the same handler call) and block until all results are ready.

        Raises RuntimeError once the batcher is closed — including for
        items that raced close() into the queue (they are failed, never
        silently dropped, so no caller blocks forever)."""
        if self._stopped:
            raise RuntimeError(f"{self.name}: submit after close()")
        self._ensure_worker()
        items = [_Item(key, p) for p in payloads]
        for it in items:
            self._queue.put(it)
        if self._stopped:
            # close() raced the enqueue: the worker may already be past
            # its final cleanup, so fail whatever is still queued (our
            # items included) rather than leave done.wait() hanging
            self._fail_pending()
        out = []
        for it in items:
            it.done.wait()
            if it.error is not None:
                raise it.error
            out.append(it.result)
        return out

    def close(self) -> None:
        """Stop the worker (idempotent). In-flight items finish first;
        items that race close() into the queue fail with RuntimeError."""
        self._stopped = True
        self._queue.put(None)

    def _fail_pending(self) -> None:
        """Fail every queued item (post-close cleanup; worker exit and
        racing submitters may both run this — each item is consumed by
        exactly one drainer)."""
        saw_sentinel = False
        while True:
            try:
                it = self._queue.get_nowait()
            except queue.Empty:
                break
            if it is None:
                saw_sentinel = True
                continue
            it.error = RuntimeError(f"{self.name}: closed")
            it.done.set()
        if saw_sentinel:
            self._queue.put(None)  # keep the worker's wakeup visible

    # -- worker --------------------------------------------------------------

    def _ensure_worker(self) -> None:
        if self._started:
            return
        with self._start_lock:
            if not self._started:
                t = threading.Thread(target=self._loop, daemon=True,
                                     name=self.name)
                t.start()
                self._started = True

    def _drain(self) -> List[_Item]:
        """Block for the first item, then linger `batch_window` for more."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.batch_window
        while len(batch) < self.max_batch:
            timeout = deadline - time.monotonic()
            try:
                nxt = (self._queue.get_nowait() if timeout <= 0
                       else self._queue.get(timeout=timeout))
            except queue.Empty:
                break
            if nxt is None:
                self._queue.put(None)  # keep the stop sentinel visible
                break
            batch.append(nxt)
        return batch

    def _loop(self) -> None:
        try:
            self._serve()
        finally:
            self._fail_pending()

    def _serve(self) -> None:
        while not self._stopped:
            batch = self._drain()
            if not batch:
                break
            # group by key, preserving arrival order within each group
            groups: dict = {}
            for it in batch:
                groups.setdefault(it.key, []).append(it)
            for key, items in groups.items():
                try:
                    results = self._handler(key, [it.payload for it in items])
                    if len(results) != len(items):
                        raise RuntimeError(
                            f"{self.name}: handler returned {len(results)} "
                            f"results for {len(items)} items")
                    for it, r in zip(items, results):
                        it.result = r
                except BaseException as e:  # noqa: BLE001 — fail the group
                    for it in items:
                        it.error = e
                finally:
                    for it in items:
                        it.done.set()
