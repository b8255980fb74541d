"""Server-side task scheduler: the queue_tasks / update_slots analogue.

A single engine thread owns the Engine (JAX is driven from one thread);
HTTP handler threads enqueue GenerationRequests and consume per-request
event queues (SSE streaming). Stop-string matching holds back partial
matches exactly like the server's incomplete-stop handling
(examples/server/server.cpp find_partial_stop_string).
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Any

from ..runtime.engine import Engine, SlotState
from ..sampling import Sampler
from ..utils.perf import span


@dataclass
class GenerationRequest:
    prompt_tokens: list[int]
    sampler: Sampler
    n_predict: int = -1
    stop: list[str] = field(default_factory=list)
    n_probs: int = 0
    request_id: int = 0
    events: queue.Queue = field(default_factory=queue.Queue)
    # filled by the worker
    text: str = ""
    n_prompt: int = 0
    done_reason: str | None = None
    tokens_out: list = field(default_factory=list)
    logprobs_out: list = field(default_factory=list)  # per token [(id, lp)]


@dataclass
class StreamEvent:
    text: str
    done: bool
    reason: str | None = None
    token: int | None = None


class EngineWorker:
    """Owns the Engine; admits queued requests to idle slots; steps."""

    def __init__(self, engine: Engine, tokenizer, spec=None):
        self.engine = engine
        self.tokenizer = tokenizer
        # SpeculativeDecoder (server --model-draft): PER-SLOT speculation —
        # each admitted request gets its own (target, draft) slot pair and
        # generator; the loop advances every active generator one verify
        # round per tick, streaming one SSE delta per round (the
        # update_slots speculative branch, server.cpp:2493-2560)
        self.spec = spec
        self._spec_gens: dict[int, object] = {}  # request_id -> generator
        self.pending: queue.Queue[GenerationRequest] = queue.Queue()
        self._control: queue.Queue = queue.Queue()
        self.active: dict[int, GenerationRequest] = {}  # request_id -> req
        self._buffers: dict[int, bytes] = {}
        self._texts: dict[int, str] = {}
        self._ids = itertools.count(1)
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.metrics = {
            "prompt_tokens_total": 0,
            "tokens_predicted_total": 0,
            "n_requests": 0,
            "n_busy_slots": 0,
        }
        self.thread = threading.Thread(target=self._loop, daemon=True)

    def start(self):
        self.thread.start()

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self.thread.join(timeout=10)

    def submit(self, req: GenerationRequest) -> GenerationRequest:
        req.request_id = next(self._ids)
        self.metrics["n_requests"] += 1
        self.metrics["prompt_tokens_total"] += len(req.prompt_tokens)
        self.pending.put(req)
        self._wake.set()
        return req

    def run(self, fn, timeout: float = 60.0):
        """Run `fn()` on the worker thread between engine steps (safe point
        for mutating engine state, e.g. hot-swapping LoRA scales — the
        SERVER_TASK_TYPE_SET_LORA analogue) and return its result."""
        done = threading.Event()
        box: dict = {}

        def wrapper():
            try:
                box["r"] = fn()
            except Exception as e:  # noqa: BLE001 — re-raised on the caller
                box["e"] = e
            done.set()

        self._control.put(wrapper)
        self._wake.set()
        if not done.wait(timeout):
            raise TimeoutError("worker control task timed out")
        if "e" in box:
            raise box["e"]
        return box.get("r")

    def cancel(self, request_id: int) -> bool:
        with self._lock:
            req = self.active.get(request_id)
        if req is None:
            return False
        if self.spec is not None:
            req.cancelled = True  # honored between verify rounds
            return True
        # engine state is owned by the worker thread; route the mutation
        # there unless we ARE the worker (stop-string path inside _emit)
        if threading.current_thread() is self.thread:
            ok = self.engine.cancel(request_id)
        else:
            ok = self.run(lambda: self.engine.cancel(request_id))
        if ok:
            self._finish(req, "cancelled")
        return ok

    # -- worker loop ----------------------------------------------------------

    def _admit(self):
        while True:
            slot = self.engine.find_idle_slot()
            if slot is None:
                return
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            try:
                self.engine.submit(req.prompt_tokens, sampler=req.sampler,
                                   n_predict=req.n_predict,
                                   request_id=req.request_id,
                                   n_probs=req.n_probs)
            except Exception as e:  # e.g. over-long prompt: fail THIS
                req.done_reason = "error"  # request, not the worker thread
                req.error = str(e)
                req.events.put(StreamEvent("", True, "error"))
                continue
            with self._lock:
                self.active[req.request_id] = req
            self._buffers[req.request_id] = b""
            self._texts[req.request_id] = ""

    def _finish(self, req: GenerationRequest, reason: str):
        with self._lock:
            self.active.pop(req.request_id, None)
        self._buffers.pop(req.request_id, None)
        self._texts.pop(req.request_id, None)
        req.done_reason = reason
        req.events.put(StreamEvent("", True, reason))

    def _emit(self, req: GenerationRequest, token: int) -> None:
        rid = req.request_id
        self._buffers[rid] += self.tokenizer.decode_token_bytes(token)
        try:
            piece = self._buffers[rid].decode("utf-8")
            self._buffers[rid] = b""
        except UnicodeDecodeError:
            return
        text = self._texts[rid] + piece
        # full stop-string match: trim and finish
        for s in req.stop:
            idx = text.find(s, max(0, len(self._texts[rid]) - len(s)))
            if idx >= 0:
                final = text[:idx]
                delta = final[len(req.text):]
                if delta:
                    req.events.put(StreamEvent(delta, False, token=token))
                    req.text = final
                self._texts[rid] = final
                self.engine.cancel(rid)
                self._finish(req, "stop")
                return
        self._texts[rid] = text
        # hold back a suffix that could begin a stop string
        hold = 0
        for s in req.stop:
            for k in range(min(len(s) - 1, len(text)), 0, -1):
                if text.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        emit_to = len(text) - hold
        delta = text[len(req.text):emit_to]
        if delta:
            req.text += delta
            req.events.put(StreamEvent(delta, False, token=token))

    def _spec_admit(self) -> None:
        """Admit queued requests to (target, draft) slot pairs."""
        while (self.engine.find_idle_slot() is not None
               and self.spec.draft.find_idle_slot() is not None):
            try:
                req = self.pending.get_nowait()
            except queue.Empty:
                return
            with self._lock:
                self.active[req.request_id] = req
            self._buffers[req.request_id] = b""
            self._texts[req.request_id] = ""
            n = req.n_predict if req.n_predict > 0 else 128
            self._spec_gens[req.request_id] = self.spec.generate_stream(
                req.prompt_tokens, req.sampler, n)

    def _spec_tick(self) -> bool:
        """Advance every active speculative generator ONE verify round —
        the per-slot concurrent speculation loop."""
        self._spec_admit()
        self.metrics["n_busy_slots"] = len(self._spec_gens)
        if not self._spec_gens:
            return False
        for rid in list(self._spec_gens):
            with self._lock:
                req = self.active.get(rid)
            gen = self._spec_gens.get(rid)
            if gen is None:
                continue
            if req is None or getattr(req, "cancelled", False):
                gen.close()  # releases the slot pair (finally block)
                self._spec_gens.pop(rid, None)
                if req is not None:
                    self._finish(req, "cancelled")
                continue
            try:
                chunk = next(gen)
            except StopIteration:
                self._spec_gens.pop(rid, None)
                self._spec_finish(req)
                continue
            for tok in chunk:
                self.metrics["tokens_predicted_total"] += 1
                req.tokens_out.append(tok)
                self._emit(req, tok)
            with self._lock:
                alive = rid in self.active
            if not alive or getattr(req, "cancelled", False):
                gen.close()  # stop string hit or cancelled between rounds
                self._spec_gens.pop(rid, None)
                if getattr(req, "cancelled", False) and alive:
                    self._finish(req, "cancelled")
        return True

    def _spec_finish(self, req: GenerationRequest) -> None:
        with self._lock:
            alive = req.request_id in self.active
        if alive:
            tail = self._texts.get(req.request_id, "")[len(req.text):]
            if tail:
                req.text += tail
                req.events.put(StreamEvent(tail, False))
            n = req.n_predict if req.n_predict > 0 else 128
            reason = "cancelled" if getattr(req, "cancelled", False) else (
                "length" if len(req.tokens_out) >= n else "stop")
            self._finish(req, reason)

    def _loop(self):
        while not self._stop:
            while True:
                try:
                    self._control.get_nowait()()
                except queue.Empty:
                    break
            if self.spec is not None:
                if not self._spec_tick():
                    self._wake.wait(timeout=0.2)
                    self._wake.clear()
                continue
            with span("worker.admit"):
                self._admit()
            with self._lock:
                busy = len(self.active)
            self.metrics["n_busy_slots"] = busy
            if busy == 0:
                self._wake.wait(timeout=0.2)
                self._wake.clear()
                continue
            # chunked on-device sampling when every active slot qualifies
            # (falls back to the host chain transparently; see
            # runtime/generate.py). Chunk 8 keeps admission latency low.
            events = (self.engine.step_fused(max_chunk=8)
                      if hasattr(self.engine, "step_fused")
                      else self.engine.step())
            with span("worker.emit"):
                for ev in events:
                    with self._lock:
                        req = self.active.get(ev.request_id)
                    if req is None:
                        continue
                    if ev.token is not None:
                        self.metrics["tokens_predicted_total"] += 1
                        req.tokens_out.append(ev.token)
                        if ev.logprobs is not None:
                            req.logprobs_out.append(ev.logprobs)
                        self._emit(req, ev.token)
                    with self._lock:
                        still = ev.request_id in self.active
                    if ev.done and still:
                        # flush any held-back text
                        tail = self._texts.get(ev.request_id, "")[len(req.text):]
                        if tail:
                            req.text += tail
                            req.events.put(StreamEvent(tail, False))
                        self._finish(req, ev.reason or "done")

    # -- synchronous helper ------------------------------------------------------

    def generate(self, req: GenerationRequest, timeout: float = 600.0):
        """Submit and iterate stream events until done."""
        self.submit(req)
        t0 = time.time()
        while True:
            ev = req.events.get(timeout=max(0.1, timeout - (time.time() - t0)))
            yield ev
            if ev.done:
                return
