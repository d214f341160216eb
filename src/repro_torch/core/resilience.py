"""Per-request deadlines (port of the ``Deadline`` part of ``repro.core.resilience``).

:class:`Deadline` is an absolute per-request deadline on a pluggable clock
(:mod:`repro_torch.core.simclock`), checked cooperatively: by the decode tier
at each admit and step, and by the boot's streamed device put at each chunk.
The JAX module's retry budgets, circuit breakers and admission control come
with the control-plane slice that ports the gateway and dispatcher.
"""
from __future__ import annotations

from typing import Callable

from repro_torch.core import metrics


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before (or during) an attempt/boot."""


class Deadline:
    """An absolute deadline on a pluggable clock.

    Cheap enough to consult per boot stage and per streamed chunk: one float
    compare against ``now()``. ``None`` deadlines are represented by absent
    objects, not sentinel values — callers guard with ``if deadline:``.
    """

    __slots__ = ("t_deadline", "_now")

    def __init__(self, t_deadline: float, now_fn: Callable[[], float]) -> None:
        self.t_deadline = float(t_deadline)
        self._now = now_fn

    @classmethod
    def after(cls, budget_s: float, clock=None) -> "Deadline":
        clock = clock if clock is not None else metrics.get_clock()
        return cls(clock.now() + budget_s, clock.now)

    def remaining(self) -> float:
        return self.t_deadline - self._now()

    def expired(self) -> bool:
        return self.remaining() <= 0.0

    def check(self, where: str = "") -> None:
        """Raise :class:`DeadlineExceeded` if the deadline has passed."""
        rem = self.remaining()
        if rem <= 0.0:
            suffix = f" at {where}" if where else ""
            raise DeadlineExceeded(
                f"deadline exceeded{suffix} ({-rem * 1e3:.1f} ms past)")

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<Deadline remaining={self.remaining():.3f}s>"
