"""Continuous-batching inference engine (the serving plane's scheduler).

Port of ``bagua_tpu/serve/engine.py`` (Orca's iteration-level scheduling)
over the port's paged decode:

* **One tick shape.**  Every scheduler tick runs the paged decode twin of
  the model (``decode_model(model, page_size=, num_pages=)``) over
  ``max_slots`` batch slots: a feed token, a block table, a lengths vector
  and an active mask.  Requests **join mid-batch** (a free slot + a
  block-table row) and **evict on finish** (mask off, pages reclaimed).
* **Paged KV-cache.**  KV state lives in per-layer page pools
  (:mod:`.cache`), updated in place by the tick; pool exhaustion
  backpressures (queue, then preempt the youngest slot for recompute) — it
  never crashes.
* **Prefill that does not stall decode.**  Prompts stream through the same
  tick at one token per slot per tick (``generate()``'s teacher forcing);
  with ``prefill_chunk > 1`` one call a tick consumes a whole prompt chunk
  of one slot.
* **Serving observability.**  ``serve/admit|prefill|decode|detokenize``
  spans, ``serve/*`` counters, and the goodput ledger's serving classes
  (``prefill``/``decode`` are serving goodput; ``batch_formation_idle`` and
  ``weight_load`` are badput with a name).

Documented differences from the JAX package:

* **No compiled program.**  JAX jits the tick and the chunk call and keeps
  them in a bounded program cache (``clear_serve_program_cache``); eager
  torch compiles nothing, so each tick is the model's ``forward`` and there
  is no such cache.
* **Bitwise only at equal shapes.**  JAX's greedy output is bit-identical to
  ``generate()`` on XLA:CPU.  Here a tick over ``max_slots`` rows, a chunk
  call over ``prefill_chunk`` tokens and ``generate()`` over one row run
  products of different shapes, which a BLAS (cuBLAS on the card) may round
  differently.  The engine is bitwise equal to ``generate()`` over the same
  rows in lockstep (``tests/test_torch_serve.py``); elsewhere tokens agree
  wherever the top-2 margin exceeds the rounding and logits agree within
  the decode gate (``record_logits`` keeps them for that check).

Greedy decoding only.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import env as _env
from ..obs.spans import trace_span
from ..telemetry import counters
from .cache import PagePool, SlotTable

__all__ = ["ServeConfig", "Request", "ServeQueueFull", "ServeEngine"]


class ServeQueueFull(RuntimeError):
    """The admission queue is at ``queue_depth`` — the caller should shed
    or retry; admission backpressure is explicit, never an OOM."""


@dataclasses.dataclass
class Request:
    """One generation request and (after completion) its result."""

    rid: int
    prompt: np.ndarray          # int32 [prompt_len]
    max_new_tokens: int
    #: filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    t_submit: Optional[float] = None
    t_first_token: Optional[float] = None
    t_done: Optional[float] = None
    preemptions: int = 0
    #: the f32 logits each output token was sampled from, one row a token
    #: (only when the engine runs with ``record_logits``)
    logits: List[Any] = dataclasses.field(default_factory=list)

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_submit is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> Optional[float]:
        """Time per output token after the first (None for 1-token
        outputs)."""
        if self.t_first_token is None or self.t_done is None:
            return None
        n = len(self.output)
        if n <= 1:
            return None
        return (self.t_done - self.t_first_token) / (n - 1)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Engine knobs; defaults come from the ``BAGUA_SERVE_*`` registry
    rows (``bagua_tpu_torch.env``)."""

    max_slots: int
    page_size: int
    num_pages: int          # total pool pages incl. the 2 reserved
    queue_depth: int
    prefill_chunk: int      # 1 disables chunked prefill
    tick_idle_s: float      # idle poll granularity while awaiting arrivals

    @staticmethod
    def from_env(max_seq_len: int, **overrides) -> "ServeConfig":
        from ..models.transformer import RESERVED_PAGES

        kw = dict(
            max_slots=_env.get_serve_max_slots(),
            page_size=_env.get_serve_page_size(),
            num_pages=_env.get_serve_num_pages(),
            queue_depth=_env.get_serve_queue_depth(),
            prefill_chunk=_env.get_serve_prefill_chunk(),
            tick_idle_s=_env.get_serve_tick_idle_s(),
        )
        kw.update(overrides)
        if kw["num_pages"] <= 0:
            # auto: enough for every slot to reach max_seq_len — no
            # preemption pressure; size it down explicitly to oversubscribe
            kw["num_pages"] = (RESERVED_PAGES + kw["max_slots"]
                               * (max_seq_len // kw["page_size"]))
        return ServeConfig(**kw)




class ServeEngine:
    """Continuous-batching engine over a ``TransformerLM``.

    ``model`` may be a training-mode or decode-mode model; the engine
    serves its paged decode twin, which shares the model's modules.
    ``params`` (tensors by name, e.g. :func:`.loader.load_serving_params`'
    result) are copied into the model's parameters in place; None serves
    the model's own.  ``continuous=False`` switches to the static-batching
    baseline (admission only into an EMPTY batch, which then runs to full
    completion).  ``record_logits`` keeps each output token's f32 logits
    on its request (``Request.logits``).
    """

    def __init__(self, model, params: Optional[Mapping[str, torch.Tensor]] = None,
                 config: Optional[ServeConfig] = None, continuous: bool = True,
                 record_logits: bool = False):
        from ..models.generate import decode_model
        from ..models.transformer import RESERVED_PAGES

        cfg = model.cfg
        self.config = config or ServeConfig.from_env(cfg.max_seq_len)
        c = self.config
        if cfg.max_seq_len % c.page_size:
            raise ValueError(
                f"page_size {c.page_size} must divide max_seq_len "
                f"{cfg.max_seq_len}"
            )
        pages_per_slot = cfg.max_seq_len // c.page_size
        if c.num_pages - RESERVED_PAGES < pages_per_slot:
            raise ValueError(
                f"num_pages {c.num_pages} cannot hold one full-length "
                f"request ({pages_per_slot} pages + {RESERVED_PAGES} "
                "reserved) — the engine could never complete it"
            )
        if params is not None:
            own = dict(model.named_parameters())
            with torch.no_grad():
                for name, t in params.items():
                    own[name].copy_(t)
        self.model = decode_model(model, page_size=int(c.page_size),
                                  num_pages=int(c.num_pages))
        self.device = model.embed.weight.device
        self.continuous = bool(continuous)
        self.record_logits = bool(record_logits)
        self.max_seq_len = int(cfg.max_seq_len)
        self.pool = PagePool(c.num_pages)
        self.slots = SlotTable(c.max_slots, cfg.max_seq_len, c.page_size)
        self._slot_req: List[Optional[Request]] = [None] * c.max_slots
        self._slot_pos: List[int] = [0] * c.max_slots   # prompt cursor
        self._slot_order: List[int] = []                 # admission order
        self._queue: "deque[Request]" = deque()
        self.completed: List[Request] = []
        self._next_rid = 0
        self._ticks = 0
        self._tick_logits: Optional[torch.Tensor] = None

        # the serving ledger classes ride the span tracer exactly like the
        # training classes do — install the sink once per process
        from ..obs import ledger as obs_ledger
        from ..obs import spans as obs_spans

        if obs_spans.enabled():
            obs_ledger.install()
        #: this engine's page pools, zero, updated in place by every call
        self.cache = self.model.init_cache(c.max_slots)

    def _slots_on_device(self, block_table, lengths, active) -> dict:
        dev = self.device
        return {"block_table": torch.from_numpy(np.ascontiguousarray(block_table)).to(dev),
                "lengths": torch.from_numpy(np.ascontiguousarray(lengths)).to(dev),
                "active": torch.from_numpy(np.ascontiguousarray(active)).to(dev)}

    @torch.no_grad()
    def _forward(self, tokens: np.ndarray, slots: dict) -> torch.Tensor:
        feed = torch.from_numpy(np.ascontiguousarray(tokens, dtype=np.int64)).to(self.device)
        return self.model(feed, cache=self.cache, slots=slots)

    # -- admission ---------------------------------------------------------

    def submit(self, prompt, max_new_tokens: int,
               rid: Optional[int] = None) -> Request:
        """Queue one request; raises :class:`ServeQueueFull` at the depth
        cap (explicit backpressure, the caller sheds or retries)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size < 1:
            raise ValueError("prompt must hold at least one token")
        if int(max_new_tokens) < 1:
            # generate(prompt, 0) returns an empty continuation; the
            # engine's finish check would emit one unrequested token
            # instead — reject rather than silently diverge
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        if prompt.size + int(max_new_tokens) > self.max_seq_len:
            raise ValueError(
                f"prompt_len {prompt.size} + max_new_tokens "
                f"{max_new_tokens} exceeds max_seq_len {self.max_seq_len}"
            )
        if len(self._queue) >= self.config.queue_depth:
            counters.incr("serve/requests_rejected")
            raise ServeQueueFull(
                f"admission queue is at queue_depth="
                f"{self.config.queue_depth}"
            )
        if rid is None:
            rid = self._next_rid
        self._next_rid = max(self._next_rid, rid) + 1
        req = Request(rid=int(rid), prompt=prompt,
                      max_new_tokens=int(max_new_tokens),
                      t_submit=time.monotonic())
        self._queue.append(req)
        counters.set_gauge("serve/queue_depth", len(self._queue))
        return req

    @property
    def active_slots(self) -> int:
        return int(self.slots.active.sum())

    @property
    def idle(self) -> bool:
        return not self._queue and self.active_slots == 0

    def _admit(self) -> None:
        if not self.continuous and self.active_slots > 0:
            return  # static batching: the formed batch runs to completion
        for slot in range(self.config.max_slots):
            if not self._queue:
                break
            if self._slot_req[slot] is not None:
                continue
            if self.pool.free_pages < 1 and self.active_slots > 0:
                # no page for even the first prompt token: leave the
                # request queued rather than admit-then-thrash
                counters.incr("serve/pool_exhausted")
                break
            req = self._queue.popleft()
            self._slot_req[slot] = req
            self._slot_pos[slot] = 0
            self.slots.active[slot] = True
            self.slots.lengths[slot] = 0
            self._slot_order.append(slot)
            counters.incr("serve/requests_admitted")

    # -- paging ------------------------------------------------------------

    def _preempt_youngest(self, spare: Optional[int] = None) -> bool:
        """Free the youngest admitted slot's pages (recompute-on-resume,
        the PagedAttention recovery policy); its request rejoins the HEAD
        of the queue.  ``spare`` protects the slot currently asking for a
        page when older slots exist.  Returns False when nothing can be
        preempted."""
        order = [s for s in self._slot_order if self._slot_req[s] is not None]
        victims = [s for s in order if s != spare] or order
        if not victims:
            return False
        victim = victims[-1]
        req = self._slot_req[victim]
        self.pool.free(self.slots.release(victim))
        self._slot_req[victim] = None
        self._slot_order.remove(victim)
        req.output = []
        req.logits = []
        req.t_first_token = None
        req.preemptions += 1
        self._queue.appendleft(req)
        counters.incr("serve/requests_preempted")
        return True

    def _ensure_pages(self, slot: int, n_tokens: int) -> bool:
        """Allocate the pages ``slot`` needs for its next ``n_tokens``
        positions, preempting younger slots on exhaustion.  False when the
        slot itself was preempted to make room."""
        while self.slots.needs_page(slot, n_tokens):
            page = self.pool.alloc()
            if page is None:
                counters.incr("serve/pool_exhausted")
                self._preempt_youngest(spare=slot)
                if self._slot_req[slot] is None:
                    return False  # the slot itself was the youngest
                continue
            self.slots.map_page(slot, page)
        return True

    # -- the scheduler tick -------------------------------------------------

    def step(self) -> int:
        """One scheduler tick: admit → (chunked prefill) → decode tick →
        detokenize/evict.  Returns the number of requests completed by
        this tick."""
        with trace_span("serve/admit", queue=len(self._queue)):
            self._admit()
        done = self._maybe_chunk_prefill()
        if self.active_slots:
            sampled = self._decode_tick()
            done += self._detokenize(sampled)
        self._ticks += 1
        counters.incr("serve/ticks")
        counters.set_gauge("serve/queue_depth", len(self._queue))
        counters.set_gauge("serve/active_slots", self.active_slots)
        counters.set_gauge("serve/pages_in_use", self.pool.pages_in_use)
        return done

    def _maybe_chunk_prefill(self) -> int:
        """At most ONE chunked-prefill call per tick (a long prompt must
        not stall running decodes): pick the oldest slot with at least a
        full chunk of prompt left and consume it in one forward call.
        Returns requests completed on this path (a chunk that consumes
        the whole prompt of a 1-token-budget request finishes it)."""
        c = self.config.prefill_chunk
        if c <= 1:
            return 0
        for slot in list(self._slot_order):
            req = self._slot_req[slot]
            if req is None or req.prompt.size - self._slot_pos[slot] < c:
                continue
            if not self._ensure_pages(slot, c):
                continue  # preempted away; its request re-queued
            with trace_span("serve/prefill", slot=slot, chunk=c,
                            rid=req.rid):
                slots = self._slots_on_device(
                    self.slots.block_table[slot:slot + 1],
                    self.slots.lengths[slot:slot + 1], np.ones((1,), bool))
                tokens = req.prompt[None,
                                    self._slot_pos[slot]:
                                    self._slot_pos[slot] + c]
                logits = self._forward(tokens, slots)[:, -1]
                # read back INSIDE the span: the launches are async, so
                # without it the chunk's device wall would leak into
                # idle_other instead of the ledger's prefill class
                last = logits.argmax(dim=-1).cpu().numpy()
            self._slot_pos[slot] += c
            self.slots.lengths[slot] += c
            counters.incr("serve/prefill_tokens", c)
            counters.incr("serve/prefill_chunks")
            if self._slot_pos[slot] == req.prompt.size:
                # the chunk consumed the prompt's last token: its argmax
                # is the request's first output token
                req.output.append(int(last[0]))
                if self.record_logits:
                    req.logits.append(logits[0])
                counters.incr("serve/decode_tokens")
                req.t_first_token = time.monotonic()
                counters.set_gauge("serve/ttft_last_s", req.ttft_s)
                if len(req.output) >= req.max_new_tokens:
                    self._finish(slot)
                    return 1
            return 0
        return 0

    def _decode_tick(self):
        """The batched one-token tick: every active slot consumes one
        token (forced prompt token while prefilling — generate()'s teacher
        forcing — else its own last output)."""
        feed = np.zeros((self.config.max_slots,), np.int32)
        for slot in list(self._slot_order):
            req = self._slot_req[slot]
            if req is None:
                continue
            if not self._ensure_pages(slot, 1):
                continue
            if self._slot_pos[slot] < req.prompt.size:
                feed[slot] = req.prompt[self._slot_pos[slot]]
            else:
                feed[slot] = req.output[-1]
        with trace_span("serve/decode", active=self.active_slots,
                        tick=self._ticks):
            host = self.slots.device_slots()
            logits = self._forward(
                feed[:, None], self._slots_on_device(
                    host["block_table"], host["lengths"], host["active"]))[:, 0]
            # exactly generate()'s greedy rule; read back INSIDE the span
            # so that the tick's device wall lands in the ledger's decode
            # class, not in idle_other at the detokenize step
            self._tick_logits = logits if self.record_logits else None
            return logits.argmax(dim=-1).cpu().numpy()

    def _detokenize(self, toks: np.ndarray) -> int:
        """Advance host state from the tick's (already read back) samples:
        prompt cursors, outputs, TTFT stamps, finish/evict."""
        done = 0
        with trace_span("serve/detokenize", active=self.active_slots):
            for slot in list(self._slot_order):
                req = self._slot_req[slot]
                if req is None or not self.slots.active[slot]:
                    continue
                self.slots.lengths[slot] += 1
                if self._slot_pos[slot] < req.prompt.size:
                    self._slot_pos[slot] += 1
                    counters.incr("serve/prefill_tokens")
                    if self._slot_pos[slot] < req.prompt.size:
                        continue  # still teacher-forcing the prompt
                req.output.append(int(toks[slot]))
                if self._tick_logits is not None:
                    req.logits.append(self._tick_logits[slot])
                # every appended output token is a sampled token,
                # including a request's first (produced by the tick that
                # consumed its final prompt token)
                counters.incr("serve/decode_tokens")
                if req.t_first_token is None:
                    req.t_first_token = time.monotonic()
                    counters.set_gauge("serve/ttft_last_s", req.ttft_s)
                if len(req.output) >= req.max_new_tokens:
                    self._finish(slot)
                    done += 1
        return done

    def _finish(self, slot: int) -> None:
        req = self._slot_req[slot]
        req.t_done = time.monotonic()
        self.pool.free(self.slots.release(slot))
        self._slot_req[slot] = None
        self._slot_order.remove(slot)
        self.completed.append(req)
        counters.incr("serve/requests_completed")
        if req.tpot_s is not None:
            counters.set_gauge("serve/tpot_last_s", req.tpot_s)

    # -- driving -----------------------------------------------------------

    def run(self, timed_requests: Optional[Sequence[Tuple[float, Any, int]]]
            = None, max_ticks: Optional[int] = None) -> List[Request]:
        """Drive the engine until every queued/submitted request completes.

        ``timed_requests``: optional ``(arrival_s, prompt, max_new)``
        trace replayed in real time (e.g. Poisson arrivals).  Wall
        spent waiting for the next arrival with an empty engine is fed to
        the ledger as ``batch_formation_idle``.
        """
        from ..obs import ledger as obs_ledger

        pending = deque(sorted(timed_requests or [], key=lambda r: r[0]))
        t0 = time.monotonic()
        start_completed = len(self.completed)
        ticks = 0
        while pending or not self.idle:
            now = time.monotonic() - t0
            while pending and pending[0][0] <= now:
                if len(self._queue) >= self.config.queue_depth:
                    # queue at depth: DEFER the arrival (backpressure per
                    # the engine contract) — raising ServeQueueFull out of
                    # the replay loop would abandon the trace mid-flight
                    break
                _, prompt, max_new = pending.popleft()
                self.submit(prompt, max_new)
            if self.idle and pending:
                wait = min(pending[0][0] - now, self.config.tick_idle_s)
                if wait > 0:
                    time.sleep(wait)
                    obs_ledger.ledger.note_class_window(
                        "batch_formation_idle", wait)
                continue
            self.step()
            ticks += 1
            if max_ticks is not None and ticks >= max_ticks:
                break
        return self.completed[start_completed:]
