"""Admission control: deadlines, queue limits, load shedding.

The port's own copy of ``deeplearning4j_tpu/serving/admission.py`` (pure
Python). A queue without bound and without deadlines makes every caller
wait longer under overload; production serving needs the opposite: reject
*early* with an explicit error the client can act on (retry elsewhere,
degrade, shed). Two error types:

- :class:`Overloaded` — raised synchronously at submit time when the queue
  is full (the request never entered the system).
- :class:`DeadlineExceeded` — the request was admitted but its deadline
  passed before the model ran it (the batcher fails it instead of wasting
  compute on an answer nobody is waiting for).
"""

from __future__ import annotations

import time
from typing import Optional


class ServingError(RuntimeError):
    """Base class for explicit serving rejections."""


class Overloaded(ServingError):
    """Queue full — request rejected at admission, never enqueued.

    ``retry_after_ms`` (when set) is the shedding worker's own estimate of
    when its queue will have drained — the hint the HTTP layer surfaces as
    a ``Retry-After`` header so a router fails over to a *different*
    worker instead of hammering the one that just shed."""

    def __init__(self, *args, retry_after_ms: Optional[float] = None):
        super().__init__(*args)
        self.retry_after_ms = retry_after_ms


class PagingInProgress(Overloaded):
    """The requested model is COLD and its page-in could not complete
    within the caller's deadline (HBM-budgeted paging).

    A cold-model request normally just WAITS in the page-in queue and
    succeeds; this is raised only when the deadline provably cannot cover
    the wait. ``retry_after_ms`` is the *honest* remaining estimate —
    the model's measured page-in cost minus the time the in-flight load
    has already spent (:func:`page_in_retry_after_ms`) — rather than the
    generic drain-rate hint an overload rejection carries."""


class HBMBudgetExceeded(ServingError):
    """No room under the HBM budget and no evictable victim: every other
    resident model is pinned by in-flight requests or is not
    archive-backed. A transient condition — pins are request-scoped —
    surfaced explicitly instead of silently overshooting the budget."""


class DeadlineExceeded(ServingError):
    """Request admitted but its deadline expired before execution."""


class ServingShutdown(ServingError):
    """The batcher was shut down while this request was still queued."""


def page_in_retry_after_ms(est_page_in_ms: float, elapsed_ms: float = 0.0,
                           floor_ms: float = 25.0) -> float:
    """Honest ``Retry-After`` for a request that cannot wait out a cold
    model's page-in: the measured page-in cost minus what the in-flight
    load has already spent, floored like the overload drain hint so an
    unmeasured first page-in never advertises an instant retry."""
    return max(float(floor_ms), float(est_page_in_ms) - float(elapsed_ms))


class AdmissionController:
    """Policy object consulted by the batcher at submit time.

    ``queue_limit`` bounds how many *requests* may wait (load shedding);
    ``default_timeout_ms`` gives every request a deadline even when the
    caller does not pass one (None = wait forever).
    """

    def __init__(self, queue_limit: int = 256,
                 default_timeout_ms: Optional[float] = None,
                 retry_after_floor_ms: float = 25.0):
        self.queue_limit = int(queue_limit)
        self.default_timeout_ms = default_timeout_ms
        self.retry_after_floor_ms = float(retry_after_floor_ms)

    def retry_after_ms(self, queue_depth: int,
                       drain_ms_per_request: Optional[float] = None) -> float:
        """How long a shed caller should wait before retrying THIS worker:
        the queued work divided by the measured drain rate (the batcher
        passes its recent per-request service estimate), floored so an
        empty measurement window never advertises an instant retry."""
        per = float(drain_ms_per_request or 0.0)
        return max(self.retry_after_floor_ms, queue_depth * per)

    def admit(self, queue_depth: int,
              drain_ms_per_request: Optional[float] = None) -> None:
        """Raise :class:`Overloaded` if the queue cannot take this request.
        The rejection carries a queue-depth-derived ``retry_after_ms``
        hint (see :meth:`retry_after_ms`)."""
        if queue_depth >= self.queue_limit:
            raise Overloaded(
                f"serving queue full ({queue_depth}/{self.queue_limit} "
                f"requests waiting); retry later or raise queue_limit",
                retry_after_ms=self.retry_after_ms(queue_depth,
                                                   drain_ms_per_request))

    def page_in_retry_after_ms(self, est_page_in_ms: float,
                               elapsed_ms: float = 0.0) -> float:
        """The page-in twin of :meth:`retry_after_ms` : the
        honest cold-model hint, floored by this controller's own
        ``retry_after_floor_ms``."""
        return page_in_retry_after_ms(est_page_in_ms, elapsed_ms,
                                      floor_ms=self.retry_after_floor_ms)

    def deadline_for(self, timeout_ms: Optional[float]) -> Optional[float]:
        """Absolute monotonic deadline for a request, or None."""
        if timeout_ms is None:
            timeout_ms = self.default_timeout_ms
        if timeout_ms is None:
            return None
        return time.monotonic() + float(timeout_ms) / 1000.0
