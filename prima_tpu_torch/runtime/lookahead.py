"""Lookahead decoding — draft-model-free speculation via Jacobi iteration.

Counterpart of prima_tpu/runtime/lookahead.py, the analogue of the
reference's examples/lookahead/lookahead.cpp (the lmsys lookahead-decoding
algorithm): every step runs ONE batched forward over

  [ token0 | G verification n-grams x (N-1) | W-1 level-0 Jacobi tokens |
    (N-2) x W higher Jacobi levels ]

where the verification n-grams come from a pool of (N-1)-grams observed in
earlier Jacobi windows, keyed by their first token.

- The token tree is a static boolean visibility matrix over the S rows of
  a step, handed to the forward as an additive attn_mask (which takes the
  plain masked attention: the flash kernels cannot express a tree).
- A step writes its S scratch K/V rows in place at cache cells
  [pos0, pos0 + S) of the slot's row, whatever their RoPE positions
  (pos0 + offsets, not increasing); accepting n-gram g copies its N-1 rows
  onto the committed tail at pos0 + 1, codes and scales alike over a
  quantized cache (the reference's seq_keep + seq_cp,
  lookahead.cpp:437-446). Rejected rows need no cleanup: the next step
  overwrites the same scratch cells, and the mask hides them meanwhile.
- The n-gram pool (lookahead.cpp ngram_container) is three numpy arrays
  (cnt/head/tokens), updated on the host between steps.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models.llama import forward
from ..sampling import Sampler, SamplerParams
from .engine import SlotState
from .kv import _parts


@dataclass
class LookaheadStats:
    n_predict: int = 0
    n_accept: int = 0  # tokens accepted from verification n-grams
    n_steps: int = 0

    @property
    def tokens_per_step(self) -> float:
        return self.n_predict / self.n_steps if self.n_steps else 0.0


@dataclass
class _NgramPool:
    """ngram_container (lookahead.cpp:21-37): per first-token ring buffer of
    capacity G holding (N-1)-gram continuations."""

    n_vocab: int
    N: int
    G: int
    cnt: np.ndarray = field(init=False)
    head: np.ndarray = field(init=False)
    tokens: np.ndarray = field(init=False)

    def __post_init__(self):
        self.cnt = np.zeros(self.n_vocab, np.int32)
        self.head = np.zeros(self.n_vocab, np.int32)
        self.tokens = np.zeros((self.n_vocab, self.G, self.N - 1), np.int32)

    def add(self, first: int, body: np.ndarray) -> None:
        # filter-out repeating n-grams (lookahead.cpp:389-409)
        k = int(self.cnt[first])
        if k and (self.tokens[first, :k] == body[None]).all(axis=1).any():
            return
        h = int(self.head[first])
        self.tokens[first, h] = body
        self.cnt[first] = min(self.G, k + 1)
        self.head[first] = (h + 1) % self.G


def tree_layout(W: int, N: int, G: int) -> tuple[np.ndarray, np.ndarray]:
    """The static batch layout of a step (lookahead.cpp:203-253): row
    offsets (S,) relative to pos0 and the visibility matrix (S, S) among
    the rows. Row 0 is token0; [1, 1+G(N-1)) the verification n-grams;
    then W-1 level-0 tokens; then levels 1..N-2, W tokens each."""
    v0 = 1
    l0 = v0 + G * (N - 1)
    lj = l0 + (W - 1)
    S = lj + (N - 2) * W
    offs = np.zeros(S, np.int32)
    vis = np.zeros((S, S), bool)
    vis[:, 0] = True  # token0 is in every sequence (seq_id_all)
    np.fill_diagonal(vis, True)
    for g in range(G):
        for j in range(1, N):  # n-gram token j sits at relative pos j
            i = v0 + g * (N - 1) + (j - 1)
            offs[i] = j
            for jp in range(1, j):  # sees its own earlier tokens
                vis[i, v0 + g * (N - 1) + (jp - 1)] = True
    for c in range(1, W):  # level-0 column c (column 0 is token0)
        i = l0 + (c - 1)
        offs[i] = c
        for cp in range(1, c):  # seq c+1 holds level-0 columns <= c
            vis[i, l0 + (cp - 1)] = True
    for j in range(1, N - 1):  # level j column c: seq {c+1}
        for c in range(W):
            i = lj + (j - 1) * W + c
            offs[i] = j + c
            for cp in range(1, c + 1):  # earlier level-0 columns
                vis[i, l0 + (cp - 1)] = True
            for jp in range(1, j):  # same column, lower levels
                vis[i, lj + (jp - 1) * W + c] = True
    return offs, vis


class LookaheadDecoder:
    """Drives one Engine slot with lookahead decoding.

    W = lookahead window, N = n-gram size, G = max verification n-grams
    (defaults mirror lookahead.cpp:48-50). With the defaults a step runs
    S = 1 + 60 + 14 + 45 = 120 rows.
    """

    def __init__(self, engine, W: int = 15, N: int = 5, G: int = 15):
        if N < 3:
            raise ValueError("lookahead needs N >= 3")
        if W < 2 or G < 1:
            raise ValueError("lookahead needs W >= 2, G >= 1")
        cfg = engine.cfg
        if cfg.alibi_max_bias or cfg.swa_window:
            raise ValueError("lookahead supports rope-causal models only")
        self.engine = engine
        self.W, self.N, self.G = W, N, G
        self.pool = _NgramPool(cfg.n_vocab, N, G)
        # row 0 is token0, then the n-grams from v0, level 0 from l0, the
        # higher levels from lj (tree_layout)
        self.v0 = 1
        self.l0 = self.v0 + G * (N - 1)
        self.lj = self.l0 + (W - 1)
        offs, vis = tree_layout(W, N, G)
        self.S = len(offs)
        dev = engine.device
        self._offsets = torch.from_numpy(offs.astype(np.int64)).to(dev)
        self._tree_vis = torch.from_numpy(vis).to(dev)
        self._cols = torch.arange(engine.max_seq, device=dev)

    # ------------------------------------------------------------------

    @torch.no_grad()
    def _step(self, tokens: np.ndarray, pos0: int, slot: int) -> torch.Tensor:
        """One forward of the S tree rows on the slot's cache row, writing
        their K/V at cells [pos0, pos0 + S); logits (S, V)."""
        eng = self.engine
        rel = self._cols - pos0
        in_scratch = (rel >= 0) & (rel < self.S)
        tree = self._tree_vis[:, rel.clamp(0, self.S - 1)]  # (S, T)
        visible = (self._cols < pos0)[None, :] | (in_scratch[None, :] & tree)
        zero = torch.zeros((), dtype=torch.float32, device=eng.device)
        mask = torch.where(visible, zero, float("-inf"))[None, None]  # (1, 1, S, T)
        positions = (self._offsets + pos0)[None]
        logits, _ = forward(eng.params, eng.cfg, eng._tensor(tokens[None], torch.int64),
                            positions, eng.slot_row(slot), eng._tensor([pos0]), eng.opts,
                            attn_mask=mask)
        return logits[0]

    def _commit(self, slot: int, src0: int, dst0: int) -> None:
        """Copy the N-1 scratch rows of an accepted n-gram, [src0, src0 +
        N-1), onto the committed tail at dst0 in every layer's K and V
        (codes and scales of a quantized cache). Rows past the accepted
        count land in the next step's scratch cells and are overwritten."""
        if src0 == dst0:
            return
        n = self.N - 1
        for k, v in self.engine.kv.caches:
            for a in _parts(k) + _parts(v):
                a[slot, dst0:dst0 + n].copy_(a[slot, src0:src0 + n])

    def generate(self, prompt_tokens: list[int],
                 sampler: Sampler | None = None, n_predict: int = 64,
                 ) -> tuple[list[int], LookaheadStats]:
        out: list[int] = []
        stats = LookaheadStats()
        for chunk in self.generate_stream(prompt_tokens, sampler, n_predict,
                                          stats=stats):
            out.extend(chunk)
        return out[:n_predict], stats

    def generate_stream(self, prompt_tokens: list[int],
                        sampler: Sampler | None = None, n_predict: int = 64,
                        stats: LookaheadStats | None = None):
        """Yield lists of newly accepted tokens, one list per step."""
        eng = self.engine
        W, N, G, S = self.W, self.N, self.G, self.S
        sampler = sampler or Sampler(SamplerParams(temp=0.0))
        stats = stats if stats is not None else LookaheadStats()

        slot = eng.submit(prompt_tokens, sampler=sampler, n_predict=-1)
        sid = slot.id
        try:
            eng.prefill_only(slot)
            cur = prompt_tokens[-1]

            # Jacobi window init (lookahead.cpp:126-141): deterministic
            # token fill, clamped into the vocab
            tokens_j = [(100 + np.arange(W, dtype=np.int32))
                        % eng.cfg.n_vocab for _ in range(N - 1)]

            batch = np.zeros(S, np.int64)
            has_eos = False
            while stats.n_predict < n_predict and not has_eos:
                pos0 = int(eng.kv.used(sid))
                if pos0 + S > eng.max_seq:
                    break  # scratch no longer fits the cache

                g_cur = int(min(self.pool.cnt[cur], G))
                # snapshot the verification n-grams NOW (ngrams_cur,
                # lookahead.cpp:173-190): the observe step below mutates the
                # pool mid-iteration, and verification must match the tokens
                # actually in this batch
                ngrams = self.pool.tokens[cur, :g_cur].copy()
                batch[0] = cur
                batch[self.v0:self.l0] = 0
                for g in range(g_cur):
                    batch[self.v0 + g * (N - 1): self.v0 + (g + 1) * (N - 1)] = \
                        ngrams[g]
                batch[self.l0:self.lj] = tokens_j[0][1:]
                for j in range(1, N - 1):
                    batch[self.lj + (j - 1) * W: self.lj + j * W] = tokens_j[j]

                logits = self._step(batch, pos0, sid).float().cpu().numpy()
                eng.n_decode_calls += 1
                stats.n_steps += 1

                active = np.ones(g_cur, bool)
                g_best = -1
                accepted: list[int] = []
                for v in range(N):
                    if v == 0:
                        i_batch = 0
                    else:
                        live = np.flatnonzero(active)
                        if live.size == 0:
                            break  # sampled token failed verification
                        g_best = int(live[0])
                        i_batch = self.v0 + g_best * (N - 1) + (v - 1)
                        stats.n_accept += 1

                    tok = sampler.sample_and_accept(logits[i_batch])
                    accepted.append(tok)
                    stats.n_predict += 1
                    if eng.eog_ids and tok in eng.eog_ids:
                        has_eos = True
                    if stats.n_predict >= n_predict or has_eos:
                        break

                    # verify across active n-grams (lookahead.cpp:314-326)
                    if v == N - 1:
                        active[:] = False
                    elif g_cur:
                        active &= ngrams[:, v] == tok

                    # update Jacobi levels (lookahead.cpp:346-375)
                    tokens_j_prev = tokens_j[0]
                    tokens_j = tokens_j[1:] + [None]
                    if v == 0:
                        # sample the new last level from the old last
                        # (j = N-2) level's logits (lookahead.cpp:357-359)
                        idx = range(self.lj + (N - 3) * W,
                                    self.lj + (N - 2) * W)
                        tokens_j[N - 2] = np.fromiter(
                            (sampler.sample(logits[i]) for i in idx),
                            np.int32, W)
                    else:
                        # init from the previous level (lookahead.cpp:368)
                        tokens_j[N - 2] = tokens_j[0].copy()

                    # observe new n-grams (lookahead.cpp:378-416)
                    if v == 0:
                        for f in range(W):
                            body = np.fromiter(
                                (tokens_j[j][f] for j in range(N - 1)),
                                np.int32, N - 1)
                            self.pool.add(int(tokens_j_prev[f]), body)

                # KV bookkeeping: token0's row is already at cell pos0;
                # tokens matched through n-gram g_best have rows inside its
                # scratch region — copy them onto the committed tail
                n_kv = len(accepted) - 1  # the final sample has no KV yet
                if n_kv > 0:
                    self._commit(sid, pos0 + self.v0 + g_best * (N - 1), pos0 + 1)
                eng.kv.cache_pos[sid] = pos0 + 1 + n_kv

                if accepted:
                    cur = accepted[-1]
                    yield accepted
        finally:
            slot.state = SlotState.IDLE
