"""Step-granular continuous batching for decode (the vLLM-style serving loop).

Port of ``repro.core.decode``, hardened as the JAX module is: the in-flight
count is taken under the queue lock, ``max_new`` is range-checked, a failure
settles every future, and an executor started by a boot whose setup then fails
is exited. The loop's logic is the JAX module's; what differs is where the
arrays live. The page pools are torch tensors on the deployment's device,
created when the tier boots (under ``torch.inference_mode``, the mode
``Executor.run_decode`` runs the programs in) and written in place by the
admit and step programs. Each step moves the host's page table, positions and
tokens to the device, and brings the logits back to the host for the greedy
argmax, as the JAX loop does.

The executor that ``_ensure_booted`` starts through ``driver.start`` carries
the deployment's serve program, which the tier never runs; the unikernel
boot pays its deserialize all the same (the JAX design, kept as it is).

The request coalescer (``repro.core.batching``) batches at REQUEST
granularity: members of a bucket run one fused program for the full decode
budget, so a request that finishes early still pays for every remaining step,
and a request that arrives mid-batch waits for the next window. This module
batches at STEP granularity: a fixed-slot decode loop where a request joins
the moment a slot and pages are free, produces one token per step alongside
whoever else is resident, and leaves at EOS/budget/deadline — its slot is
backfilled before the next step, never held by a finished sequence for even
one step.

KV state lives in a shared paged pool (:mod:`repro_torch.core.paging` owns the
accounting, the device tensors ride along through the two deploy-time
programs):

* admit — prefill ONE request into its reserved pages, returning its first
  response token (the TTFR stamp happens here, mid-batch, without pausing
  the other residents' step cadence more than one prefill).
* step  — one token for EVERY resident slot at once, through the page table.

Cold-platform alignment (the paper's thesis): the loop boots its executor on
the first request of a burst and cools it TO ZERO after ``cool_after_s`` of
quiet — residency is accounted on exit exactly like every other driver path,
so the decode tier shows up honestly in the warm-vs-cold comparison.

Invariants: every submitted request settles exactly once (success, or the
submit-time error path); a finished request's pages are released before the
next admission decision, and admission is deterministic — if the pool cannot
cover a request's worst case (prompt + max_new), the request WAITS at the
queue head rather than corrupting a resident chain; the executor is never
exited while a request is resident.
"""
from __future__ import annotations

import dataclasses
import threading
from concurrent.futures import Future
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.metrics import Recorder, Series, Timeline
from repro_torch.core.metrics import now as _default_now
from repro_torch.core.paging import PageChain, PagePool


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """Geometry + policy of the continuous-batching loop."""

    slots: int = 4                 # resident requests per step
    page_size: int = 16            # tokens per KV page
    max_new: Optional[int] = None  # decode budget cap (None: the deploy spec's)
    cool_after_s: float = 0.25     # quiet period before cooling to zero
    eos_token: Optional[int] = None  # greedy token that ends a request early


@dataclasses.dataclass
class _Request:
    tokens: np.ndarray             # [1, prompt_len] int32
    max_new: int
    future: Future
    timeline: Timeline
    label: Optional[str]
    deadline: Optional[Any]


@dataclasses.dataclass
class _Active:
    req: _Request
    chain: PageChain
    pos: int                       # tokens currently in the chain's pages
    toks: List[int]                # generated so far (first token from admit)


class DecodeScheduler:
    """Owns one deployment's decode loop: queue, slots, pages, executor.

    ``submit`` hands back a Future of the generated token ids ([n] int32,
    n <= max_new). One background thread runs admission + steps; the device
    page pools and the :class:`PagePool` accounting advance in lock-step —
    the host-side ``pos``/chain state IS the source of truth the step
    program's page table and position vector are materialised from.
    """

    def __init__(self, dep, cluster, recorder: Recorder, cfg: DecodeConfig,
                 on_exit=None, clock=None) -> None:
        self.dep = dep
        self.cluster = cluster
        self.recorder = recorder
        self.cfg = cfg
        self.on_exit = on_exit
        self._now = clock.now if clock is not None else _default_now
        self.bundle = dep.ensure_decode(cfg.slots, cfg.page_size)
        # geometry comes from the COMPILED bundle, not cfg: ensure_decode
        # returns the deployment's one decode bundle, which may have been
        # built by an earlier scheduler with different cfg numbers
        self.slots = self.bundle.slots
        self.pool = PagePool(self.bundle.n_pages, self.bundle.page_size)
        self.default_max_new = cfg.max_new or dep.spec.decode_steps
        # slot state (loop thread only)
        self._slots: List[Optional[_Active]] = [None] * self.slots
        self._k_pages = None
        self._v_pages = None
        self._ex = None
        self._host = None
        # queue (lock + condition; FIFO, head blocks on page exhaustion)
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._queue: List[_Request] = []
        self._inflight = 0             # popped from _queue, not yet settled/slotted
        self._running = True
        self._idle_since = self._now()
        # counters
        self.requests = 0
        self.tokens_generated = 0
        self.steps = 0
        self.step_rows = 0             # live rows summed over steps (occupancy)
        self.admits = 0
        self.admit_waits = 0           # admission deferred on page exhaustion
        self.boots = 0
        self.cooldowns = 0
        self.queue_delay_s = Series()
        self.tokens_per_request = Series()
        self._thread = threading.Thread(target=self._loop,
                                        name=f"decode-{dep.name}", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------ public
    def submit(self, tokens: np.ndarray, max_new: Optional[int] = None,
               label: Optional[str] = None, deadline=None) -> Future:
        tokens = np.asarray(tokens, np.int32)
        fut: Future = Future()
        if tokens.shape != (1, self.dep.spec.prompt_len):
            fut.set_exception(ValueError(
                f"decode prompt must be [1, {self.dep.spec.prompt_len}], "
                f"got {tokens.shape}"))
            return fut
        if max_new is None:
            budget = self.default_max_new
        else:
            budget = int(max_new)
            if not 1 <= budget <= self.default_max_new:
                # admit always produces one token, so 0 cannot be honored;
                # silently clamping an over-budget ask would truncate output
                fut.set_exception(ValueError(
                    f"max_new must be in [1, {self.default_max_new}] "
                    f"(the deployment's decode budget), got {budget}"))
                return fut
        worst = self.pool.pages_for(tokens.shape[1] + budget)
        if worst > min(self.bundle.n_pages - 1, self.bundle.max_pages):
            fut.set_exception(ValueError(
                f"request needs {worst} pages; pool/table caps at "
                f"{min(self.bundle.n_pages - 1, self.bundle.max_pages)}"))
            return fut
        tl = Timeline()
        tl.t_enqueue = self._now()
        tl.deadline = deadline
        req = _Request(tokens, budget, fut, tl, label, deadline)
        with self._wake:
            if not self._running:
                fut.set_exception(RuntimeError("decode scheduler closed"))
                return fut
            self._queue.append(req)
            self.requests += 1
            self._wake.notify()
        return fut

    def drain(self, timeout_s: float = 600.0) -> None:
        """Block until every submitted request has settled."""
        deadline = self._now() + timeout_s
        with self._wake:
            while self._queue or self._inflight or any(self._slots):
                if not self._wake.wait(timeout=0.1):
                    pass
                if self._now() > deadline:
                    raise TimeoutError("decode drain timed out")

    def close(self) -> None:
        """Drain, stop the loop thread, and cool the executor."""
        self.drain()
        with self._wake:
            self._running = False
            self._wake.notify()
        self._thread.join(timeout=30)
        self._cool()

    def summary(self) -> Dict[str, float]:
        cap = max(self.steps * self.slots, 1)
        return {
            "requests": float(self.requests),
            "tokens_generated": float(self.tokens_generated),
            "steps": float(self.steps),
            "occupancy": self.step_rows / cap,
            "admits": float(self.admits),
            "admit_waits": float(self.admit_waits),
            "boots": float(self.boots),
            "cooldowns": float(self.cooldowns),
            "queue_delay_mean_s": self.queue_delay_s.mean,
            "pages_high_water": float(self.pool.high_water),
            "page_alloc_failures": float(self.pool.alloc_failures),
        }

    # -------------------------------------------------------------------- loop
    def _loop(self) -> None:
        while True:
            with self._wake:
                if not self._running:
                    return
                busy = bool(self._queue or any(self._slots))
                if not busy:
                    if self._ex is not None and \
                            self._now() - self._idle_since >= self.cfg.cool_after_s:
                        pass               # fall through to cool below
                    else:
                        self._wake.wait(timeout=self.cfg.cool_after_s / 2
                                        if self._ex is not None else 0.25)
                        continue
            if not busy:
                self._cool()
                continue
            try:
                self._admit_ready()
                self._step_once()
            except Exception as e:          # noqa: BLE001 — settle, never die
                try:
                    self._fail_all(e)
                except Exception:           # noqa: BLE001
                    pass                    # the loop thread must survive
            with self._wake:
                if not (self._queue or any(self._slots)):
                    self._idle_since = self._now()
                    self._wake.notify_all()

    def _fail_all(self, err: Exception) -> None:
        """A broken executor/program fails every resident + queued request —
        the loop itself survives for the next burst (fresh boot)."""
        with self._wake:
            pending = list(self._queue)
            self._queue.clear()
        for slot, a in enumerate(self._slots):
            if a is not None:
                self._slots[slot] = None
                try:
                    self.pool.release(a.chain)
                except Exception:           # noqa: BLE001
                    pass                    # settling the future comes first
                if not a.req.future.done():
                    a.req.future.set_exception(err)
        for req in pending:
            if not req.future.done():
                req.future.set_exception(err)
        if self._ex is not None:
            try:
                self._cool()
            except Exception:               # noqa: BLE001
                pass                        # _cool detached _ex before exit()

    # -------------------------------------------------------------- lifecycle
    def _ensure_booted(self, tl: Timeline) -> None:
        if self._ex is not None:
            return
        host = self.cluster.route(self.dep.image.key)
        driver = host.drivers["unikernel"]          # the one driver ported so far
        tl.t_start_begin = self._now()
        ex = driver.start(self.dep, tl)
        try:
            gates = getattr(ex, "gates", None)
            if gates is not None:
                gates.bind_timeline(tl)
            with torch.inference_mode():
                pools = self.dep.model.init_page_pool(
                    self.bundle.n_pages, self.bundle.page_size, self.dep.device)
        except Exception:
            # the started executor was never published to self._ex: exit it
            # here (with residency accounting) or it leaks forever
            ex.exit()
            if self.on_exit is not None:
                self.on_exit(ex)
            raise
        self._k_pages, self._v_pages = pools["k_pages"], pools["v_pages"]
        self._ex, self._host = ex, host
        self.boots += 1

    def _cool(self) -> None:
        """Cool the decode tier to ZERO — exit the executor, account residency,
        drop the device pools. The next burst pays a fresh boot (the paper's
        trade, applied to the serving loop)."""
        ex, self._ex, self._host = self._ex, None, None
        self._k_pages = self._v_pages = None
        if ex is None:
            return
        ex.exit()
        if self.on_exit is not None:
            self.on_exit(ex)
        self.cooldowns += 1

    # -------------------------------------------------------------- admission
    def _admit_ready(self) -> None:
        """Admit queue-head requests while slots AND pages allow.

        FIFO and all-or-nothing: the head request either gets its whole
        worst-case reservation (prompt + max_new tokens) or waits — later
        requests do not jump it (no starvation of long requests), and a
        failed reservation leaves the pool untouched.
        """
        while True:
            free = [i for i, a in enumerate(self._slots) if a is None]
            if not free:
                return
            with self._wake:
                req = self._queue[0] if self._queue else None
            if req is None:
                return
            chain = self.pool.alloc_chain(req.tokens.shape[1] + req.max_new)
            if chain is None:
                self.admit_waits += 1
                return
            # pop + in-flight mark is one atomic transition: the request is
            # always visible to drain() — in _queue, counted in _inflight, or
            # in a slot — so close() can never cool the executor mid-admit
            # and every future still settles exactly once
            with self._wake:
                self._queue.pop(0)
                self._inflight += 1
            try:
                self._admit(free[0], req, chain)
            finally:
                with self._wake:
                    self._inflight -= 1
                    self._wake.notify_all()

    def _admit(self, slot: int, req: _Request, chain: PageChain) -> None:
        tl = req.timeline
        tl.t_dispatch = self._now()
        self.queue_delay_s.add(tl.t_dispatch - tl.t_enqueue)
        try:
            if req.deadline is not None:
                req.deadline.check("decode-admit")
            self._ensure_booted(tl)
            if not tl.t_start_begin:
                tl.t_start_begin = tl.t_dispatch
            tl.t_exec_begin = self._now()
            page_ids = chain.table_row(self.bundle.max_pages)
            logits, self._k_pages, self._v_pages = self._ex.run_decode(
                self.bundle.admit, self._to_device(req.tokens), self._k_pages,
                self._v_pages, self._to_device(page_ids), timeline=tl)
            logits = _to_host(logits)
        except Exception as e:              # noqa: BLE001
            self.pool.release(chain)
            if not req.future.done():
                req.future.set_exception(e)
            return
        tok0 = int(np.argmax(logits))
        self.admits += 1
        active = _Active(req=req, chain=chain, pos=req.tokens.shape[1],
                         toks=[tok0])
        if self._finished(active, tok0):
            self._retire(active)            # EOS on the very first token
        else:
            self._slots[slot] = active

    # ------------------------------------------------------------------- step
    def _step_once(self) -> None:
        live = [(i, a) for i, a in enumerate(self._slots) if a is not None]
        if not live:
            return
        mp = self.bundle.max_pages
        table = np.zeros((self.slots, mp), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        tok = np.zeros((self.slots, 1), np.int32)
        for i, a in live:
            table[i] = a.chain.table_row(mp)
            pos[i] = a.pos
            tok[i, 0] = a.toks[-1]
        logits, self._k_pages, self._v_pages = self._ex.run_decode(
            self.bundle.step, self._k_pages, self._v_pages, self._to_device(table),
            self._to_device(pos), self._to_device(tok))
        logits = _to_host(logits)
        self.steps += 1
        self.step_rows += len(live)
        for i, a in live:
            nxt = int(np.argmax(logits[i]))
            a.pos += 1                      # the step wrote tok[i] at pos
            a.toks.append(nxt)
            expired = False
            if a.req.deadline is not None:
                try:
                    a.req.deadline.check("decode-step")
                except Exception:           # noqa: BLE001 — settle truncated
                    expired = True
            if expired or self._finished(a, nxt):
                self._slots[i] = None       # freed BEFORE the next admission
                self._retire(a)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.dep.device)

    def _finished(self, a: _Active, last_tok: int) -> bool:
        if len(a.toks) >= a.req.max_new:
            return True
        eos = self.cfg.eos_token
        return eos is not None and last_tok == eos

    def _retire(self, a: _Active) -> None:
        self.pool.release(a.chain)
        self.tokens_generated += len(a.toks)
        self.tokens_per_request.add(len(a.toks))
        tl = a.req.timeline
        tl.t_done = self._now()
        self.recorder.add(a.req.label or f"{self.dep.name}:decode", tl)
        if not a.req.future.done():
            a.req.future.set_result(np.asarray(a.toks, np.int32))


def _to_host(logits: torch.Tensor) -> np.ndarray:
    """Device logits -> f32 numpy for the host's argmax."""
    return logits.float().cpu().numpy()
