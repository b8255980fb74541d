"""The experts the program's router chose, for the comparison of a mixture
of experts.

With random weights at full depth a mixture of experts is chaotic under
rounding: where the k-th and (k+1)-th experts of a token nearly tie, a
bfloat16 program and a float32 reference pick different ones, and from
there on their hidden states part. So for such a configuration the
reference follows the program's routing (its choice of experts, not its
weights), and the router is checked by itself (check.py): the share of
rows and layers whose experts differ from the reference's own choice is
held, over all layers and over the first layers, where the two still see
nearly the same hidden states and a router wrong for some rows shows at
its full share.

`RouteLog` records, for every forward of the window, which request and
position each row holds and, for each MoE layer (a layer whose router
runs: a dense layer among them is neither recorded nor compared), the
expert ids that `moe_ffn` took from its router's `torch.topk`. Nothing is
added to the device's work: the ids are the program's own tensors, kept
as they are and read once the window has closed.
"""

from __future__ import annotations

import numpy as np
import torch


class RouteLog:
    def __init__(self, engine):
        from prima_tpu_torch.models import llama

        self.engine = engine
        # MoE layer j is the j-th layer with a router
        moe = [layer for layer in engine.params["layers"] if layer.get("ffn_gate_inp") is not None]
        self.n_moe = len(moe)
        self.layer_index = {id(layer): j for j, layer in enumerate(moe)}
        self.forwards: list[tuple] = []  # (request ids a row, positions a row, [ids a layer])
        self.current: list | None = None
        self._fused_start = None
        self._by_request: dict | None = None
        self.orig_moe = llama.moe_ffn
        e, fused = engine, engine._fused_gen
        gen = fused.generate

        def generate(*a, **kw):
            # (cache_pos, slot_params) of the chunk; step i of a live row is at cache_pos + i
            self._fused_start = [np.array(a[3]), [p is not None for p in a[5]], 0]
            return gen(*a, **kw)

        patched = [(llama, "moe_ffn", self._moe_ffn),
                   (e, "_prefill", self._wrap(e._prefill, self._prefill_rows)),
                   (e, "_decode_raw", self._wrap(e._decode_raw, self._step_rows)),
                   (fused, "fwd", self._wrap(fused.fwd, self._fused_rows)),
                   (fused, "generate", generate)]
        self.originals = [(o, n, getattr(o, n)) for o, n, _ in patched]
        for o, n, new in patched:
            setattr(o, n, new)

    def restore(self) -> None:
        for o, n, orig in reversed(self.originals):
            setattr(o, n, orig)

    def _wrap(self, fn, rows):
        def wrapped(*a, **kw):
            self.current = [*rows(a), [None] * self.n_moe]
            self.forwards.append(tuple(self.current))
            try:
                return fn(*a, **kw)
            finally:
                self.current = None
        return wrapped

    def _prefill_rows(self, a):
        tokens, pos0, slot = a[0], int(a[1]), a[3]
        rid = self.engine.slots[slot].request_id
        return [rid] * len(tokens), pos0 + np.arange(len(tokens))

    def _step_rows(self, a):
        from prima_tpu_torch.runtime.engine import SlotState

        e = self.engine
        rids = [s.request_id if s.state == SlotState.DECODE else None for s in e.slots]
        return rids, np.array(e.kv.cache_pos)

    def _fused_rows(self, a):
        pos, live, i = self._fused_start
        self._fused_start[2] += 1
        rids = [s.request_id if ok else None for s, ok in zip(self.engine.slots, live)]
        return rids, pos + i

    def _moe_ffn(self, layer, cfg, x, opts):
        got = []
        real = torch.topk

        def topk(*a, **kw):
            out = real(*a, **kw)
            got.append(out[1])
            return out

        torch.topk = topk
        try:
            out = self.orig_moe(layer, cfg, x, opts)
        finally:
            torch.topk = real
        if self.current is not None and got:
            self.current[2][self.layer_index[id(layer)]] = got[0]
        return out

    def routes(self, request_id, n_positions: int, k: int) -> torch.Tensor | None:
        """(n_positions, MoE layers, k) expert ids the program used at each
        position of one request, or None where a position or MoE layer was
        not seen."""
        if self._by_request is None:
            self._by_request = {}
            for f in self.forwards:
                for rid in set(f[0]) - {None}:
                    self._by_request.setdefault(rid, []).append(f)
        out = torch.full((n_positions, self.n_moe, k), -1, dtype=torch.long)
        for rids, pos, layers in self._by_request.get(request_id, []):
            rows = [r for r, rid in enumerate(rids) if rid == request_id and pos[r] < n_positions]
            if not rows:
                continue
            for li, ids in enumerate(layers):
                if ids is None:
                    return None
                flat = ids.reshape(len(rids), k).cpu()
                out[pos[rows], li] = flat[rows]
        return None if bool((out < 0).any()) else out
