"""Shape-bucketed admission control for the MC serving plane.

The port of ``repro.serve.scheduler`` (pure host bookkeeping, kept here so
the port stands alone). Requests that share a shape — the
``SimRequest.bucket_key()`` tuple ``(model, q, dims, L, algorithm, rule,
dtype)`` — can ride the same replica stack of one sweep family, so the
scheduler keeps one FIFO queue per bucket
and services the buckets round-robin.  That pair of policies is the whole
starvation argument:

* FIFO within a bucket — a request is admitted after at most
  ``pending_ahead / replica_width`` admission rounds of its bucket;
* round-robin across buckets — every bucket with pending work is serviced
  within one full rotation, no matter how hot the other buckets run.

So any submitted request reaches a replica slot after finitely many
``step()`` calls regardless of the submit/cancel interleaving — the
property ``tests/test_torch_serve.py`` drives with seeded randomized
schedules.

The scheduler is pure host-side bookkeeping (deques of request ids); it
never touches device state and is deterministic given the call sequence.
"""
from __future__ import annotations

from collections import OrderedDict, deque
from typing import Optional


class BucketScheduler:
    """FIFO-per-bucket queues with a round-robin bucket rotation."""

    def __init__(self):
        self._queues: "OrderedDict[tuple, deque]" = OrderedDict()
        self._rotation: deque = deque()   # bucket service order

    # -- submission --------------------------------------------------------

    def submit(self, request_id: int, bucket_key: tuple) -> None:
        """Enqueue ``request_id`` at the tail of its bucket's FIFO."""
        if bucket_key not in self._queues:
            self._queues[bucket_key] = deque()
            self._rotation.append(bucket_key)
        self._queues[bucket_key].append(request_id)

    def cancel(self, request_id: int) -> bool:
        """Drop a still-queued request; False if it is not pending here
        (already admitted, finished, or unknown)."""
        for q in self._queues.values():
            try:
                q.remove(request_id)
                return True
            except ValueError:
                continue
        return False

    # -- service -----------------------------------------------------------

    def take(self, bucket_key: tuple, max_n: int) -> list:
        """Pop up to ``max_n`` request ids from the head of one bucket's
        FIFO (admission into freed replica slots)."""
        q = self._queues.get(bucket_key)
        if not q:
            return []
        out = []
        while q and len(out) < max_n:
            out.append(q.popleft())
        return out

    def next_bucket(self, exclude: tuple = ()) -> Optional[tuple]:
        """Round-robin: the next bucket with pending work, advancing the
        rotation so repeated calls cycle fairly. ``exclude`` skips buckets
        that already have an active run (they admit from their own queue
        at chunk boundaries instead)."""
        for _ in range(len(self._rotation)):
            key = self._rotation[0]
            self._rotation.rotate(-1)
            if key in exclude:
                continue
            if self._queues.get(key):
                return key
        return None

    def peek(self, bucket_key: tuple) -> Optional[int]:
        """Head-of-line request id of one bucket (None when empty)."""
        q = self._queues.get(bucket_key)
        return q[0] if q else None

    # -- introspection -----------------------------------------------------

    def pending(self, bucket_key: Optional[tuple] = None) -> int:
        if bucket_key is not None:
            return len(self._queues.get(bucket_key, ()))
        return sum(len(q) for q in self._queues.values())

    def buckets(self) -> list:
        """Bucket keys with at least one pending request, in service
        order."""
        return [k for k in self._rotation if self._queues.get(k)]
