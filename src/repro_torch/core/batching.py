"""Request coalescing (port of ``repro.core.batching``): so far only
``settle_quietly``, which the dispatcher needs. ``CoalescedBatch`` and the
``Coalescer`` come with the bucket programs of the ``ensure_bucket`` slice.

Invariant: a Future settled here is settled exactly once; a second
settlement (a hedge, a retry or an abandoned caller got there first) is
dropped.
"""
from __future__ import annotations

from concurrent.futures import Future, InvalidStateError
from typing import Optional


def settle_quietly(fut: Future, value=None,
                   error: Optional[BaseException] = None) -> None:
    """Complete ``fut`` unless a concurrent path already did (hedge / retry /
    abandoned caller). Shared by the dispatcher and the coalescer."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(value)
    except InvalidStateError:
        pass
