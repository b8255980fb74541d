"""TCP ring data plane: multi-process distributed inference.

Counterpart of prima_tpu/parallel/ring_tcp.py, the analogue of the
reference's decode-loop wire protocol (llama_send_meta/llama_recv_meta
src/llama.cpp:17870/17920, llama_send_tensors/llama_recv_tensors
@18031/18054, the worker service loop main.cpp:664-681): per ubatch the
master sends metadata, the activation hops rank to rank around the ring k
times (piped ring), and the last window's output returns straight to rank
0 for the output head.

  * Server slots ride the ring in groups (the piped microbatches): group
    g's activation train overlaps the master's compute for group g + 1.
  * The full sampler chain and continuous batching run on rank 0
    (TcpRingEngine has the Engine's surface, so the server drives it).
  * KV mutations replicate ring-wide as tagged messages (the
    llama_send_kv_cache_* protocol, src/llama.cpp:22610-22745):
    truncation is master metadata only (workers get cache_pos with each
    meta); remap ops (context shift, Self-Extend) and seq_cp carry their
    vectors to every rank, which applies them to its own layers' caches.
  * Activations cross the wire as bf16 by truncation of the f32 bits (the
    JAX package's bytes). In bf16 compute that is lossless, so a ring's
    logits equal one process's bit for bit.

Ranks are processes (or threads in tests); each rank's windows run on its
own torch device, several ranks may share one card. Each hop copies the
(B, S, E) activation to the host, where the socket needs it. A rank's
streamed layers (n[m] < w[m]) go up a window at a time (`_WindowStreamer`).
"""

from __future__ import annotations

import collections
import contextlib
import struct
import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from .. import resolve_device
from ..models.config import ModelConfig
from ..models.llama import ForwardOptions, forward, init_kv_caches, lm_head
from ..quant.qtensor import dequant_slices
from ..runtime.engine import SlotState, StepEvent, apply_self_extend, record_positions
from ..runtime.kv import KVCache
from ..runtime.streaming import STREAM_DEQUANT_WEIGHTS, Uploads
from ..sampling import Sampler, SamplerParams, softmax
from .bootstrap import RingNode, _recv_exact
from .engine import DSlot
from .ring_host import RingPlan

_THDR = struct.Struct("<III")  # ndim, dtype code, nbytes
_DTYPES = {0: np.float32, 1: np.int32, 2: np.uint8, 3: np.uint16}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.int32): 1,
                np.dtype(np.uint8): 2, np.dtype(np.uint16): 3}


def send_tensor(sock, a: np.ndarray) -> None:
    a = np.ascontiguousarray(a)
    code = _DTYPE_CODES[a.dtype]
    hdr = _THDR.pack(a.ndim, code, a.nbytes)
    dims = struct.pack(f"<{a.ndim}q", *a.shape)
    sock.sendall(hdr + dims + a.tobytes())


def recv_tensor(sock) -> np.ndarray:
    ndim, code, nbytes = _THDR.unpack(_recv_exact(sock, _THDR.size))
    shape = struct.unpack(f"<{ndim}q", _recv_exact(sock, 8 * ndim))
    data = _recv_exact(sock, nbytes)
    return np.frombuffer(data, dtype=_DTYPES[code]).reshape(shape).copy()


def send_act(sock, a: np.ndarray, wire_bf16: bool = True) -> None:
    """Activation hop: f32 goes as bf16 by truncation (the high 16 bits),
    not by rounding as `tensor.to(torch.bfloat16)` would."""
    if wire_bf16 and a.dtype == np.float32:
        send_tensor(sock, (a.view(np.uint32) >> 16).astype(np.uint16))
    else:
        send_tensor(sock, a)


def recv_act(sock) -> np.ndarray:
    a = recv_tensor(sock)
    if a.dtype == np.uint16:  # bf16 wire format
        return (a.astype(np.uint32) << 16).view(np.float32)
    return a


def to_host(x: torch.Tensor) -> np.ndarray:
    """An activation (B, S, E) as f32 on the host: the copy every hop makes."""
    return x.float().cpu().numpy()


@dataclass
class RingContext:
    node: RingNode | None  # None for the one-process ring
    plan: RingPlan
    rank: int
    world: int

    @property
    def is_master(self) -> bool:
        return self.rank == 0


def _group_rows(n_slots: int, n_groups: int) -> int:
    if n_slots % n_groups:
        raise ValueError(f"{n_slots} slots do not split into {n_groups} groups")
    return n_slots // n_groups


def default_groups(world: int, n_slots: int) -> int:
    """One in-flight ubatch per ring hop keeps every stage busy: min(world,
    n_slots) groups, lowered until they divide the slots."""
    g = max(1, min(world, n_slots))
    while n_slots % g:
        g -= 1
    return g


class _WindowStreamer:
    """The scheduler's resident/streamed split (n[m]) on one ring rank:
    streamed layers live packed in host memory (the mmap analogue). Before
    a window computes, its streamed layers are committed and the previous
    window's released, and the next window's upload is enqueued on the side
    stream (the piped-ring prefetch of manage_graph_tensors, reference
    src/llama.cpp:18152-18218). The device holds at most two windows'
    streamed layers at once. A rank with a single window (k = 1) releases
    it at the end of each pass (`release`), so it streams every step."""

    def __init__(self, params: dict, ranges, streamed_host: dict[int, dict], device):
        self.params = params
        self.host = streamed_host
        self.uploads = Uploads(device)
        self._pending: dict[int, tuple] = {}
        self.win_ids = [[i for i in range(lo, hi) if i in streamed_host]
                        for lo, hi in ranges]
        self._cur: int | None = None
        self._prefetch(0)

    def _prefetch(self, c: int) -> None:
        for i in self.win_ids[c]:
            if i not in self._pending and self.params["layers"][i] is None:
                self._pending[i] = self.uploads.start(self.host[i])

    def __del__(self):
        for pending in self._pending.values():  # uploads still in flight
            self.uploads.ready(pending)

    def release(self) -> None:
        """Drop the committed window's streamed layers: the compute stream
        reuses their memory after the compute that reads them."""
        if self._cur is not None:
            for i in self.win_ids[self._cur]:
                self.params["layers"][i] = None
        self._cur = None

    def ensure(self, c: int) -> None:
        """Commit window c's streamed layers (cycle-major ring order)."""
        if self._cur == c:
            return
        self.release()
        self._prefetch(c)
        for i in self.win_ids[c]:
            self.params["layers"][i] = self.uploads.ready(self._pending.pop(i))
        nxt = (c + 1) % len(self.win_ids)
        if nxt != c:
            self._prefetch(nxt)
        self._cur = c


class _Windows:
    """A rank's windows: its params, per-group KV caches and streamer."""

    def __init__(self, ctx: RingContext, cfg: ModelConfig, params: dict, max_seq: int,
                 opts: ForwardOptions, kv_dtype, n_slots: int, n_groups: int,
                 streamed_host: dict[int, dict] | None, device):
        self.ctx, self.cfg, self.params, self.opts = ctx, cfg, params, opts
        self.device = resolve_device(device)
        self.max_seq = max_seq
        self.ranges = ctx.plan.layer_ranges()[ctx.rank]
        self.streamer = (_WindowStreamer(params, self.ranges, streamed_host, self.device)
                         if streamed_host else None)
        owned = ctx.plan.owned(ctx.rank)
        kv_dtype = torch.bfloat16 if kv_dtype is None else kv_dtype
        self.Bg = _group_rows(n_slots, n_groups)
        self.n_groups = n_groups
        # per-group caches: the replicated KV ops run on every rank
        self.kvc = [KVCache(cfg, self.Bg, max_seq, kv_dtype, self.device,
                            caches=init_kv_caches(cfg, self.Bg, max_seq, kv_dtype,
                                                  self.device, owned.__contains__))
                    for _ in range(n_groups)]

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.device)

    @torch.no_grad()
    def window(self, g: int, c: int, x, tokens, positions: np.ndarray,
               cache_pos: np.ndarray, rope_delta: np.ndarray) -> torch.Tensor:
        """Run window c of group g: from `tokens` (the first window) or the
        incoming activation x (a host f32 array or a device tensor).
        RoPE takes positions + rope_delta (Self-Extend's compression); the
        causal mask follows the physical cell positions."""
        lo, hi = self.ranges[c]
        if self.streamer is not None:
            self.streamer.ensure(c)
        if x is not None:
            x = torch.as_tensor(x).to(self.device, self.opts.dtype)
        rpos = positions + rope_delta[:, None]
        # a streaming rank bounds its dequant temporaries (runtime/streaming.py)
        with (dequant_slices(STREAM_DEQUANT_WEIGHTS) if self.streamer is not None
              else contextlib.nullcontext()):
            out, _ = forward(self.params, self.cfg,
                             None if tokens is None else self._t(tokens, torch.int64),
                             self._t(rpos), self.kvc[g].caches, self._t(cache_pos),
                             self.opts, return_hidden=True,
                             mask_positions=self._t(positions), layer_range=(lo, hi),
                             hidden_in=x)
        return out

    def apply_kv_op(self, msg: dict) -> None:
        """llama_send_kv_cache_* analogue: apply a replicated mutation."""
        kvc = self.kvc[int(msg.get("group", 0))]
        op = msg["op"]
        if op == "remap":
            kvc.remap(int(msg["slot"]), np.asarray(msg["src"], np.int32),
                      np.asarray(msg["delta"], np.int32), int(msg["new_used"]))
        elif op == "seq_cp":
            kvc.seq_cp(int(msg["dst"]), int(msg["src"]))
        elif op == "rope_shift":
            kvc.rope_shift(int(msg["slot"]), np.asarray(msg["delta"], np.int32))
        elif op == "clear":
            kvc.clear()
        else:
            raise ValueError(f"unknown kv op {op}")


class TcpRingWorker:
    """Worker ranks: the llama_decode(empty batch) service loop, batched
    and grouped. Protocol tags: meta / act / kv / stop."""

    def __init__(self, ctx: RingContext, cfg: ModelConfig, params: dict,
                 max_seq: int = 2048, opts: ForwardOptions | None = None,
                 kv_dtype=None, n_slots: int = 1, n_groups: int = 1,
                 streamed_host: dict[int, dict] | None = None, device=None):
        self.ctx = ctx
        self.w = _Windows(ctx, cfg, params, max_seq, opts or ForwardOptions(), kv_dtype,
                          n_slots, n_groups, streamed_host, device)

    def serve(self, timeout: float | None = None) -> None:
        """Blocks until STOP (the reference's infinite llama_decode loop);
        `timeout` bounds each wait for the previous rank."""
        node, w = self.ctx.node, self.w
        metas: dict[int, tuple] = {}
        done: set[int] = set()  # groups computed since the window was loaded
        last = self.ctx.rank == self.ctx.world - 1
        while True:
            msg = node.recv_prev(timeout=timeout)
            tag = msg.get("tag")
            if tag == "stop":
                if (node.rank + 1) % node.world != msg.get("from", 0):
                    node.send_next(msg)
                return
            if tag == "kv":
                w.apply_kv_op(msg)
                if not last:
                    node.send_next(msg)  # relay until the last worker
                continue
            if tag == "meta":
                g = int(msg.get("group", 0))
                if g in done and w.streamer is not None and len(w.ranges) == 1:
                    w.streamer.release()  # a new pass: stream the window again
                    done.clear()
                pos = np.asarray(msg["positions"], np.int32)
                if pos.ndim == 1:
                    pos = pos[None]
                rd = np.asarray(msg.get("rope_delta", [0] * pos.shape[0]), np.int32)
                metas[g] = (pos, np.asarray(msg["cache_pos"], np.int32), rd)
                if not last:
                    node.send_next(msg)
                continue
            if tag != "act":
                raise ValueError(f"unexpected ring message {tag!r}")
            g, c = int(msg.get("group", 0)), int(msg["cycle"])
            x = recv_act(node.recv_sock)
            positions, cache_pos, rope_delta = metas[g]
            out = to_host(w.window(g, c, x, None, positions, cache_pos, rope_delta))
            done.add(g)
            # the ring hop; the master shortcut is the hop of the last window
            node.send_next({"tag": "act", "cycle": c, "group": g,
                            "final": last and c == self.ctx.plan.k - 1})
            send_act(node.send_sock, out)


def relay_loop(node: RingNode, timeout: float | None = None) -> None:
    """Forwarder role (common/common.cpp:1832-1873): a device the scheduler
    removed keeps relaying ring traffic so the ring is never re-wired."""
    next_is_master = (node.rank + 1) % node.world == 0
    while True:
        msg = node.recv_prev(timeout=timeout)
        if msg.get("tag") in ("meta", "kv") and next_is_master:
            # the master never consumes meta/kv (it originated them);
            # forwarding would desync the master's recv stream
            continue
        node.send_next(msg)
        if msg.get("tag") == "act":
            send_tensor(node.send_sock, recv_tensor(node.recv_sock))
        elif msg.get("tag") == "stop":
            return


class _MasterCore(_Windows):
    """Rank 0 compute: embedding, the master's windows and the output head,
    grouped."""

    def __init__(self, *a, recv_timeout: float | None = None, **kw):
        super().__init__(*a, **kw)
        self.recv_timeout = recv_timeout

    def _send_meta(self, g: int, positions, cache_pos, rope_delta) -> None:
        self.ctx.node.send_next({"tag": "meta", "group": g,
                                 "positions": positions.tolist(),
                                 "cache_pos": cache_pos.tolist(),
                                 "rope_delta": rope_delta.tolist()})

    def _send_act(self, g: int, c: int, x: torch.Tensor) -> None:
        node = self.ctx.node
        node.send_next({"tag": "act", "cycle": c, "group": g})
        send_act(node.send_sock, to_host(x))

    def ring_pass(self, groups: list[tuple]) -> dict:
        """Pipelined ubatch train: [(g, tokens (B, S), positions (B, S),
        cache_pos (B,)[, rope_delta (B,)])] -> {g: hidden (B, S, E)}, a
        device tensor on a one-process ring, else the f32 host array the
        last hop brought.

        The master's window for group g + 1 overlaps the workers' compute
        for group g (one ubatch per stage in flight; the ring links keep
        FIFO order)."""
        k = self.ctx.plan.k
        groups = [gr if len(gr) == 5 else gr + (np.zeros(gr[1].shape[0], np.int32),)
                  for gr in groups]
        hidden: dict = {}
        if self.ctx.world == 1:  # the degenerate ring: every window is the master's
            for g, tokens, positions, cache_pos, rope_delta in groups:
                x = None
                for c in range(k):
                    x = self.window(g, c, x, tokens if c == 0 else None, positions,
                                    cache_pos, rope_delta)
                hidden[g] = x
            if self.streamer is not None and k == 1:
                self.streamer.release()
            return hidden

        node = self.ctx.node
        meta = {g: (p, cp, rd) for g, _, p, cp, rd in groups}
        pending: collections.deque = collections.deque()
        for g, tokens, positions, cache_pos, rope_delta in groups:
            self._send_meta(g, positions, cache_pos, rope_delta)
            self._send_act(g, 0, self.window(g, 0, None, tokens, positions, cache_pos,
                                             rope_delta))
            pending.append((g, 0))
        while pending:
            g, c = pending.popleft()
            hdr = node.recv_prev(timeout=self.recv_timeout)
            if hdr.get("tag") != "act" or int(hdr.get("group", 0)) != g \
                    or int(hdr["cycle"]) != c:
                raise RuntimeError(f"ring out of order: got {hdr}, want group {g} "
                                   f"cycle {c}")
            x = recv_act(node.recv_sock)
            if c + 1 < k:
                positions, cache_pos, rope_delta = meta[g]
                self._send_act(g, c + 1, self.window(g, c + 1, x, None, positions,
                                                     cache_pos, rope_delta))
                pending.append((g, c + 1))
            else:
                hidden[g] = x
        if self.streamer is not None and k == 1:
            self.streamer.release()
        return hidden

    @torch.no_grad()
    def head(self, hidden) -> torch.Tensor:
        x = torch.as_tensor(hidden).to(self.device, self.opts.dtype)
        return lm_head(self.params, self.cfg, x, self.opts)

    # -- ring-replicated KV mutations ------------------------------------------

    def _bcast_kv(self, msg: dict) -> None:
        if self.ctx.world > 1:
            self.ctx.node.send_next({"tag": "kv", **msg})

    def kv_remap(self, g: int, slot: int, src: np.ndarray, delta: np.ndarray,
                 new_used: int) -> None:
        self._bcast_kv({"op": "remap", "group": g, "slot": slot, "src": src.tolist(),
                        "delta": delta.tolist(), "new_used": new_used})
        self.kvc[g].remap(slot, src, delta, new_used)

    def kv_seq_cp(self, g: int, dst: int, src: int) -> None:
        self._bcast_kv({"op": "seq_cp", "group": g, "dst": dst, "src": src})
        self.kvc[g].seq_cp(dst, src)

    def kv_rope_shift(self, g: int, slot: int, delta: np.ndarray) -> None:
        """Self-Extend compression: re-rotate the slot's cached K by the
        per-cell delta on every rank (the reference sends the seq_add /
        seq_div ops ring-wide, main.cpp:603-606)."""
        self._bcast_kv({"op": "rope_shift", "group": g, "slot": slot,
                        "delta": delta.tolist()})
        self.kvc[g].rope_shift(slot, delta)

    def kv_context_shift(self, g: int, slot: int, n_keep: int, n_discard: int,
                         used: int) -> None:
        move = used - n_keep - n_discard
        idx = np.arange(self.max_seq, dtype=np.int32)
        src = np.where(idx < n_keep, idx, idx + n_discard)
        delta = np.where((idx >= n_keep) & (idx < n_keep + move),
                         -n_discard, 0).astype(np.int32)
        self.kv_remap(g, slot, src, delta, n_keep + move)


class TcpRingEngine:
    """Continuous batching over the TCP ring (rank 0), with the Engine's
    surface: slots live on the (group, row) grid; every step() drives one
    pipelined ubatch train through the ring for all active slots and runs
    the full sampler chain per slot (the reference server's update_slots +
    llama_decode(ctx, batch_view, true), server.cpp:1996-2451). Prompts
    prefill in chunks of their exact length, as the port's Engine does."""

    def __init__(self, ctx: RingContext, cfg: ModelConfig, params: dict,
                 n_slots: int = 4, n_groups: int | None = None,
                 max_seq: int = 2048, n_batch: int = 64,
                 opts: ForwardOptions | None = None, kv_dtype=None,
                 eog_ids: set[int] | None = None, ctx_shift: bool = False,
                 n_keep: int = 0, grp_attn_n: int = 1, grp_attn_w: int = 512,
                 streamed_host: dict[int, dict] | None = None, device=None,
                 recv_timeout: float | None = None):
        if grp_attn_n < 1:
            raise ValueError("grp_attn_n must be >= 1")
        if grp_attn_n > 1 and grp_attn_w % grp_attn_n:
            raise ValueError("grp_attn_w must be a multiple of grp_attn_n (main.cpp:221)")
        if ctx_shift and grp_attn_n > 1:
            raise ValueError("context shift and Self-Extend are mutually exclusive")
        n_groups = n_groups or default_groups(ctx.world, n_slots)
        self.core = _MasterCore(ctx, cfg, params, max_seq, opts or ForwardOptions(), kv_dtype,
                                n_slots, n_groups, streamed_host, device,
                                recv_timeout=recv_timeout)
        self.ctx = ctx
        self.cfg = cfg
        self.max_seq = max_seq
        self.n_batch = n_batch
        self.G, self.Bg = n_groups, n_slots // n_groups
        self.eog_ids = eog_ids or set()
        self.ctx_shift = ctx_shift
        self.n_keep = n_keep
        self.grp_attn_n = grp_attn_n
        self.grp_attn_w = grp_attn_w
        # a parked row of a shared group writes its padding cells at its own
        # cache_pos (clamped at the end): wider groups reserve n_batch cells
        # so that write never lands on real cells
        self._row_limit = max_seq if self.Bg == 1 else max_seq - n_batch
        if self._row_limit <= 0:
            raise ValueError("n_batch must be < max_seq")
        self.slots = [DSlot(g, b, self.Bg) for g in range(self.G) for b in range(self.Bg)]
        self.n_decode_calls = 0
        self.perf = {"n_prompt": 0, "n_decode": 0, "t_prompt_s": 0.0, "t_decode_s": 0.0}

    @property
    def n_slots(self) -> int:
        return self.G * self.Bg

    @property
    def device(self) -> torch.device:
        return self.core.device

    class _CachePosView:
        """cache_pos by global slot id: the rollback handle of the
        speculative decoder (truncation is metadata only on the ring:
        workers read cache_pos with each meta)."""

        def __init__(self, eng: "TcpRingEngine"):
            self._e = eng

        def __getitem__(self, slot) -> int:
            g, b = divmod(int(slot), self._e.Bg)
            return int(self._e.core.kvc[g].cache_pos[b])

        def __setitem__(self, slot, value) -> None:
            g, b = divmod(int(slot), self._e.Bg)
            self._e.core.kvc[g].cache_pos[b] = int(value)

    class _KVView:
        """kv facade for the server's /slots endpoints and the speculative
        decoder."""

        def __init__(self, eng: "TcpRingEngine"):
            self._e = eng

        def used(self, slot) -> int:
            g, b = divmod(int(slot), self._e.Bg)
            return int(self._e.core.kvc[g].cache_pos[b])

        def seq_rm(self, slot, p0: int = 0, p1: int = -1) -> None:
            g, b = divmod(int(slot), self._e.Bg)
            self._e.core.kvc[g].seq_rm(b, p0, p1)

        @property
        def cache_pos(self) -> "TcpRingEngine._CachePosView":
            return TcpRingEngine._CachePosView(self._e)

        @property
        def max_seq(self) -> int:
            return self._e.max_seq

    @property
    def kv(self):
        return TcpRingEngine._KVView(self)

    def find_idle_slot(self):
        return next((s for s in self.slots if s.state == SlotState.IDLE), None)

    def submit(self, prompt_tokens: list[int], sampler: Sampler | None = None,
               n_predict: int = -1, request_id: Any = None, reuse_prefix: bool = True,
               n_probs: int = 0):
        if not prompt_tokens:
            raise ValueError("empty prompt")
        if len(prompt_tokens) >= self._row_limit:
            raise ValueError(f"prompt ({len(prompt_tokens)}) exceeds the per-slot "
                             f"context limit ({self._row_limit})")
        slot = self.find_idle_slot()
        if slot is None:
            raise RuntimeError("no idle slot")
        kvc = self.core.kvc[slot.m]
        common = 0
        if reuse_prefix and slot.prompt:
            limit = min(len(slot.prompt), len(prompt_tokens) - 1, int(kvc.cache_pos[slot.b]))
            while common < limit and slot.prompt[common] == prompt_tokens[common]:
                common += 1
        kvc.seq_rm(slot.b, p0=common)
        slot.state = SlotState.PREFILL
        slot.prompt = list(prompt_tokens)
        slot.n_prompt_done = common
        slot.generated = []
        slot.sampler = sampler or Sampler(SamplerParams(temp=0.0))
        slot.n_predict = n_predict
        slot.request_id = request_id
        slot.stop_reason = None
        slot.n_probs = n_probs
        slot.shifts = []
        slot.ga_i = 0
        slot.pos_delta = 0
        slot.pos_map = None
        for t in prompt_tokens:
            slot.sampler.accept(t, accept_grammar=False)
        if slot.n_prompt_done >= len(slot.prompt) - 1:
            slot.state = SlotState.DECODE
        return slot

    # -- Self-Extend grouped attention (main.cpp:618-640, ring-replicated) ----

    def _apply_self_extend(self, slot) -> None:
        kvc = self.core.kvc[slot.m]
        apply_self_extend(slot, int(kvc.cache_pos[slot.b]), self.max_seq, self.grp_attn_n,
                          self.grp_attn_w,
                          lambda d: self.core.kv_rope_shift(slot.m, slot.b, d))

    def _record_positions(self, slot, pos0: int, n: int) -> None:
        if self.grp_attn_n > 1:
            record_positions(slot, pos0, n, self.max_seq)

    def _rope_delta_row(self, g: int, pool) -> np.ndarray:
        d = np.zeros(self.Bg, np.int32)
        for s in pool:
            if s.m == g:
                d[s.b] = s.pos_delta
        return d

    def cancel(self, request_id: Any) -> bool:
        for s in self.slots:
            if s.request_id == request_id and s.state != SlotState.IDLE:
                s.state = SlotState.IDLE
                s.stop_reason = "cancelled"
                return True
        return False

    def _prefill_tick(self, only: list | None = None) -> bool:
        t0 = time.perf_counter()
        pool = only if only is not None else self.slots
        prefill = [s for s in pool if s.state == SlotState.PREFILL]
        if not prefill:
            return False
        if self.grp_attn_n > 1:
            for s in prefill:
                self._apply_self_extend(s)
        s_len = min(self.n_batch, max(len(s.prompt) - 1 - s.n_prompt_done for s in prefill))
        active_g = sorted({s.m for s in prefill})
        # every row of an active group writes s_len cells (parked rows at
        # their own cache_pos): cap the chunk at the cache tail
        cap = self.max_seq - max(int(self.core.kvc[g].cache_pos.max()) for g in active_g)
        s_len = max(min(s_len, cap), 1)
        took, groups = {}, []
        for g in active_g:
            kvc = self.core.kvc[g]
            tokens = np.zeros((self.Bg, s_len), np.int64)
            positions = (np.arange(s_len, dtype=np.int32)[None]
                         + kvc.cache_pos[:, None]).astype(np.int32)
            for s in prefill:
                if s.m == g:
                    chunk = s.prompt[s.n_prompt_done:
                                     min(s.n_prompt_done + s_len, len(s.prompt) - 1)]
                    tokens[s.b, :len(chunk)] = chunk
                    took[(s.m, s.b)] = len(chunk)
            groups.append((g, tokens, positions, kvc.cache_pos.copy(),
                           self._rope_delta_row(g, prefill)))
        self.core.ring_pass(groups)
        self.n_decode_calls += 1
        for s in prefill:
            n = took[(s.m, s.b)]
            self._record_positions(s, int(self.core.kvc[s.m].cache_pos[s.b]), n)
            self.core.kvc[s.m].cache_pos[s.b] += n
            s.n_prompt_done += n
            self.perf["n_prompt"] += n
            if s.n_prompt_done >= len(s.prompt) - 1:
                s.state = SlotState.DECODE
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.perf["t_prompt_s"] += time.perf_counter() - t0
        return True

    def step(self) -> list[StepEvent]:
        events: list[StepEvent] = []
        self._prefill_tick()
        active = [s for s in self.slots if s.state == SlotState.DECODE]
        if not active:
            return events
        if self.ctx_shift:
            for s in active:
                used = int(self.core.kvc[s.m].cache_pos[s.b])
                if used >= self._row_limit - 1:
                    n_discard = max((used - self.n_keep) // 2, 1)
                    self.core.kv_context_shift(s.m, s.b, self.n_keep, n_discard, used)
                    s.shifts.append((self.n_keep, n_discard))
        if self.grp_attn_n > 1:
            for s in active:
                self._apply_self_extend(s)
                self._record_positions(s, int(self.core.kvc[s.m].cache_pos[s.b]), 1)

        t0 = time.perf_counter()
        groups = []
        for g in sorted({s.m for s in active}):
            kvc = self.core.kvc[g]
            tokens = np.zeros((self.Bg, 1), np.int64)
            for s in active:
                if s.m == g:
                    tokens[s.b, 0] = s.generated[-1] if s.generated else s.prompt[-1]
            groups.append((g, tokens, kvc.cache_pos[:, None].copy(), kvc.cache_pos.copy(),
                           self._rope_delta_row(g, active)))
        hidden = self.core.ring_pass(groups)
        self.n_decode_calls += 1
        logits = {g: self.core.head(h).float().cpu().numpy() for g, h in hidden.items()}
        for s in active:
            self.core.kvc[s.m].cache_pos[s.b] += 1
        self.perf["t_decode_s"] += time.perf_counter() - t0
        self.perf["n_decode"] += len(active)

        for s in active:
            row = logits[s.m][s.b, -1]
            tok = s.sampler.sample_and_accept(row)
            s.generated.append(tok)
            lp = None
            if s.n_probs > 0:
                probs = np.log(np.maximum(softmax(row), 1e-30))
                top = np.argsort(-row)[: s.n_probs]
                ids = list(dict.fromkeys([int(t) for t in top] + [tok]))
                lp = [(int(t), float(probs[t])) for t in ids]
            done, reason = self._check_stop(s, tok)
            if done:
                s.state = SlotState.IDLE
                s.stop_reason = reason
            events.append(StepEvent(s.id, s.request_id, tok, done, reason, logprobs=lp))
        return events

    def _check_stop(self, slot, tok: int):
        if tok in self.eog_ids:
            return True, "eog"
        if slot.n_predict >= 0 and len(slot.generated) >= slot.n_predict:
            return True, "length"
        if not self.ctx_shift and int(self.core.kvc[slot.m].cache_pos[slot.b]) >= \
                self._row_limit:
            return True, "context_full"
        return False, None

    # -- the speculative-decoding protocol -------------------------------------

    def prefill_only(self, slot) -> None:
        while slot.state == SlotState.PREFILL:
            self._prefill_tick(only=[slot])

    def verify_chain(self, slot_id: int, chain: list[int]) -> np.ndarray:
        """Decode `chain` on one slot, logits at every position (s, V); the
        slot's write index moves by len(chain) (the caller rolls back)."""
        s_len = len(chain)
        g, b = divmod(int(slot_id), self.Bg)
        kvc = self.core.kvc[g]
        pos0 = int(kvc.cache_pos[b])
        # the other rows of the group write their padding at their own
        # cache_pos: every row's [pos, pos + s_len) must stay in the cache
        if pos0 + s_len > self.max_seq or (self.Bg > 1 and s_len > self.n_batch):
            raise ValueError(f"verify chain of {s_len} does not fit at {pos0}")
        tokens = np.zeros((self.Bg, s_len), np.int64)
        tokens[b] = chain
        positions = (np.arange(s_len, dtype=np.int32)[None]
                     + kvc.cache_pos[:, None]).astype(np.int32)
        hidden = self.core.ring_pass([(g, tokens, positions, kvc.cache_pos.copy())])[g]
        self.n_decode_calls += 1
        logits = self.core.head(hidden).float().cpu().numpy()
        kvc.cache_pos[b] = pos0 + s_len
        return logits[b]

    def perf_summary(self) -> str:
        p = self.perf
        pp = p["n_prompt"] / p["t_prompt_s"] if p["t_prompt_s"] > 0 else 0.0
        tg = p["n_decode"] / p["t_decode_s"] if p["t_decode_s"] > 0 else 0.0
        return (f"prompt eval: {p['n_prompt']} tokens in {p['t_prompt_s']:.2f}s "
                f"({pp:.1f} tok/s) | decode: {p['n_decode']} tokens in "
                f"{p['t_decode_s']:.2f}s ({tg:.1f} tok/s) | "
                f"{self.n_decode_calls} decode calls")

    def run_to_completion(self, prompt_tokens: list[int], **kw) -> list[int]:
        slot = self.submit(prompt_tokens, **kw)
        while slot.state != SlotState.IDLE:
            self.step()
        return list(slot.generated)

    def stop(self) -> None:
        if self.ctx.node is not None:
            self.ctx.node.send_stop()
