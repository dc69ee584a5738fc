"""Spans: named intervals of the host's own work, kept in memory.

    with span("tracking.chunk", n=blocks):
        ...

A span records while a torch profiler session is active in the process
(`torch.autograd.profiler._is_profiler_enabled`, the flag torch keeps for
such checks) and costs an attribute read and a call otherwise: `span`
then returns one shared no-op.  A recorded span is stamped with
`time.time_ns()`, the host's realtime clock in ns, on which kineto stamps
the profiler's own events, so spans and the device trace share a clock.

Nothing here adds an event to the profiler's trace (no `record_function`,
no NVTX range): such annotations come back among the device's events
(`gpu_user_annotation`), where a reader of kernels and idle gaps would
count them as device work.

`n` is the work a span covers (blocks, steps, samples, bytes or launches);
a span may set it on the object `span` returns once it knows it.  `parent`
is the id of the enclosing span on the same thread; spans of other
threads have their own stacks.  The last 65 536 spans are kept;
`recorded(t0_ns, t1_ns)` returns those that started inside a window.
"""

from __future__ import annotations

import collections
import itertools
import threading
import time
from typing import List, NamedTuple, Optional

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    id: int
    name: str
    start_ns: int
    end_ns: int
    parent: Optional[int]
    thread: int
    n: int


_SPANS: collections.deque = collections.deque(maxlen=1 << 16)
_IDS = itertools.count()
_LOCAL = threading.local()


class _Open:
    """A span being recorded."""

    __slots__ = ("name", "n", "id", "parent", "start_ns", "_stack")

    def __init__(self, name: str, n: int):
        self.name, self.n = name, n

    def __enter__(self) -> "_Open":
        stack = getattr(_LOCAL, "stack", None)
        if stack is None:
            stack = _LOCAL.stack = []
        self.id = next(_IDS)
        self.parent = stack[-1] if stack else None
        self._stack = stack
        stack.append(self.id)
        self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end_ns = time.time_ns()
        self._stack.pop()
        _SPANS.append(Span(self.id, self.name, self.start_ns, end_ns,
                           self.parent, threading.get_ident(), int(self.n)))


class _Off:
    """The shared span of a process with no profiler session: records
    nothing, and takes an `n` it forgets."""

    __slots__ = ()
    n = property(lambda self: 0, lambda self, value: None)

    def __enter__(self) -> "_Off":
        return self

    def __exit__(self, *exc) -> None:
        return None


OFF = _Off()


def span(name: str, n: int = 0):
    """A context manager timing the work inside it as span `name`."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _Open(name, n)


def recorded(t0_ns: int, t1_ns: int) -> List[Span]:
    """The kept spans that started in [t0_ns, t1_ns], in the order they
    ended."""
    return [s for s in list(_SPANS) if t0_ns <= s.start_ns <= t1_ns]
