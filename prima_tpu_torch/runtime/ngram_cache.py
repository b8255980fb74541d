"""N-gram cache + lookup decoding (prompt-lookup speculative decoding).

Counterpart of prima_tpu/runtime/ngram_cache.py: the n-gram functions are
host-side and kept as a copy here; LookupDecoder verifies each draft chain
through Engine.verify_chain.

The analogue of the reference's common/ngram-cache.{h,cpp} and
examples/lookup/: maps n-grams (n in [1, 4]) to empirical distributions of
the following token, drafts continuation candidates by consulting a
context cache (current conversation), a dynamic cache (accumulated across
user sessions), and a static cache (built offline from a large corpus),
then verifies the draft chain with ONE batched target forward — lossless
speculative decoding with no draft model at all.

Behavior ported 1:1 (thresholds, validation weighting, backoff order) from
common/ngram-cache.cpp:11-292; the cache FILE FORMAT is byte-compatible
with llama-lookup-create/merge output (fixed 4-token ngram records padded
with -1, little-endian int32).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

NGRAM_MIN = 1
NGRAM_MAX = 4
NGRAM_STATIC = 2

# If sample size or percentage are below these thresholds the draft is
# aborted early (ngram-cache.cpp:59-62); index = ngram_size - 1.
_MIN_SAMPLE_LAX = (2, 2, 1, 1)
_MIN_PERCENT_LAX = (66, 50, 50, 50)
_MIN_SAMPLE_STRICT = (4, 3, 2, 2)
_MIN_PERCENT_STRICT = (75, 66, 66, 66)

# ngram -> {token: count}; keys are tuples padded to NGRAM_MAX with -1
NgramCache = dict


def _key(tokens, start: int, size: int) -> tuple:
    ng = tuple(int(tokens[start + j]) for j in range(size))
    return ng + (-1,) * (NGRAM_MAX - size)


def update(cache: NgramCache, ngram_min: int, ngram_max: int,
           tokens, n_new: int) -> None:
    """Add the n-grams ending in the last `n_new` tokens (append-only
    contract, ngram-cache.cpp:11).  tokens: full sequence so far."""
    n = len(tokens)
    for size in range(ngram_min, ngram_max + 1):
        i_start = max(size, n - n_new)
        for i in range(i_start, n):
            ng = _key(tokens, i - size, size)
            tok = int(tokens[i])
            part = cache.get(ng)
            if part is None:
                cache[ng] = {tok: 1}
            else:
                part[tok] = part.get(tok, 0) + 1


def _get(inp, draft, i: int) -> int:
    """Token i of the combined speculative sequence inp + draft[1:]."""
    return int(inp[i]) if i < len(inp) else int(draft[1 + i - len(inp)])


def _try_draft_static(nc_static: NgramCache, ng) -> int:
    part = nc_static.get(ng)
    if not part:
        return -1
    max_tok, max_cnt, sum_cnt = -1, 0, 0
    for tok, cnt in part.items():
        if cnt > max_cnt:
            max_tok, max_cnt = tok, cnt
        sum_cnt += cnt
    if sum_cnt < _MIN_SAMPLE_LAX[NGRAM_STATIC - 1]:
        return -1
    if 100 * max_cnt < _MIN_PERCENT_LAX[NGRAM_STATIC - 1] * sum_cnt:
        return -1
    return max_tok


def _try_draft(nc_primary: NgramCache, ngrams, part_static: dict,
               min_sample, min_percent, ngram_min: int) -> int:
    """Largest-n first; candidate tokens are weighted by 100x their static-
    cache count (ngram-cache.cpp:98-143). The threshold tables are indexed
    by ngram SIZE - 1 (ngram i has size ngram_min + i)."""
    drafted = -1
    for i in range(len(ngrams) - 1, -1, -1):
        if drafted != -1:
            break
        part = nc_primary.get(ngrams[i])
        if not part:
            continue
        size_idx = ngram_min + i - 1
        max_tok, max_cp, max_cs, sum_cp = -1, 0, 0, 0
        for tok, cp in part.items():
            cs = 100 * part_static.get(tok, 0) or 1
            if cp * cs > max_cp * max_cs:
                max_tok, max_cp, max_cs = tok, cp, cs
            sum_cp += cp
        if sum_cp < min_sample[size_idx]:
            continue
        if 100 * max_cp < min_percent[size_idx] * sum_cp:
            continue
        drafted = max_tok
    return drafted


def draft(inp, drafted: list[int], n_draft: int, ngram_min: int,
          ngram_max: int, nc_context: NgramCache, nc_dynamic: NgramCache,
          nc_static: NgramCache) -> None:
    """Extend `drafted` (which starts as [last_sampled]) with up to n_draft
    lookup candidates (ngram-cache.cpp:145-197)."""
    assert len(drafted) == 1
    inp_size = len(inp)
    if inp_size < NGRAM_STATIC:
        return
    while len(drafted) - 1 < n_draft:
        tok = -1
        start_s = inp_size - NGRAM_STATIC + len(drafted) - 1
        ng_static = tuple(
            _get(inp, drafted, j) for j in range(start_s, start_s + NGRAM_STATIC)
        ) + (-1,) * (NGRAM_MAX - NGRAM_STATIC)
        part_static = nc_static.get(ng_static, {})

        ngrams_cd = []
        for size in range(ngram_min, ngram_max + 1):
            start = inp_size - size + len(drafted) - 1
            ngrams_cd.append(
                tuple(_get(inp, drafted, j) for j in range(start, start + size))
                + (-1,) * (NGRAM_MAX - size)
            )
        if tok == -1:
            tok = _try_draft(nc_context, ngrams_cd, part_static,
                             _MIN_SAMPLE_LAX, _MIN_PERCENT_LAX, ngram_min)
        if tok == -1:
            tok = _try_draft(nc_dynamic, ngrams_cd, part_static,
                             _MIN_SAMPLE_STRICT, _MIN_PERCENT_STRICT,
                             ngram_min)
        if tok == -1:
            tok = _try_draft_static(nc_static, ng_static)
        if tok == -1:
            break
        drafted.append(tok)


def save(cache: NgramCache, path: str) -> None:
    """Reference-compatible binary format (ngram-cache.cpp:199-220)."""
    with open(path, "wb") as f:
        for ng, part in cache.items():
            assert part
            f.write(struct.pack("<4i", *ng))
            f.write(struct.pack("<i", len(part)))
            for tok, cnt in part.items():
                f.write(struct.pack("<2i", tok, cnt))


def load(path: str) -> NgramCache:
    cache: NgramCache = {}
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off < len(data):
        ng = struct.unpack_from("<4i", data, off)
        off += 16
        (ntokens,) = struct.unpack_from("<i", data, off)
        off += 4
        part = {}
        for _ in range(ntokens):
            tok, cnt = struct.unpack_from("<2i", data, off)
            off += 8
            part[tok] = cnt
        cache[ng] = part
    return cache


def merge(target: NgramCache, add: NgramCache) -> None:
    for ng, part in add.items():
        tp = target.get(ng)
        if tp is None:
            target[ng] = dict(part)
            continue
        for tok, cnt in part.items():
            tp[tok] = tp.get(tok, 0) + cnt


# ---------------------------------------------------------------------------
# Lookup decoding (examples/lookup/lookup.cpp)
# ---------------------------------------------------------------------------


@dataclass
class LookupStats:
    n_target_calls: int = 0
    n_drafted: int = 0
    n_accepted: int = 0

    @property
    def acceptance(self) -> float:
        return self.n_accepted / self.n_drafted if self.n_drafted else 0.0


class LookupDecoder:
    """Draft-model-free speculative decoding: candidates come from n-gram
    caches, verification is one batched target forward
    (Engine.verify_chain, logits at every position of the chain). Greedy
    output is token-identical to plain decoding.

    As the reference does (prima_tpu/runtime/ngram_cache.py:252,270,278),
    it verifies on slot 0 and moves slot 0's write index, whatever slot
    submit() picked: give it an engine whose slot 0 is idle (n_slots=1).
    The slot stays in DECODE after generate(), as the reference leaves it.
    """

    def __init__(self, target, n_draft: int = 8,
                 nc_static: NgramCache | None = None,
                 nc_dynamic: NgramCache | None = None,
                 ngram_min: int = NGRAM_MIN, ngram_max: int = NGRAM_MAX):
        self.target = target
        self.n_draft = n_draft
        self.ngram_min = ngram_min
        self.ngram_max = ngram_max
        self.nc_static = nc_static if nc_static is not None else {}
        self.nc_dynamic = nc_dynamic if nc_dynamic is not None else {}
        self.nc_context: NgramCache = {}

    def generate(self, prompt_tokens: list[int], sampler=None,
                 n_predict: int = 64) -> tuple[list[int], LookupStats]:
        from ..sampling import Sampler, SamplerParams

        sampler = sampler or Sampler(SamplerParams(temp=0.0))
        stats = LookupStats()
        t = self.target

        # submit() already accepts the prompt into the sampler penalty window
        t_slot = t.submit(prompt_tokens, sampler=sampler, n_predict=-1)
        t.prefill_only(t_slot)

        all_tokens = list(prompt_tokens)
        update(self.nc_context, self.ngram_min, self.ngram_max,
               all_tokens, len(all_tokens))

        out: list[int] = []
        cur = prompt_tokens[-1]
        while len(out) < n_predict:
            chain = [cur]
            draft(all_tokens, chain, self.n_draft, self.ngram_min,
                  self.ngram_max, self.nc_context, self.nc_dynamic,
                  self.nc_static)
            drafted = chain[1:]
            stats.n_drafted += len(drafted)

            pos0 = t.kv.used(0)
            logits = t.verify_chain(0, chain)  # (len(chain), V) f32 on the host
            stats.n_target_calls += 1

            accepted: list[int] = []
            for j in range(len(chain)):
                tok = sampler.sample_and_accept(logits[j])
                accepted.append(tok)
                if (j < len(drafted) and tok == drafted[j]
                        and len(out) + len(accepted) < n_predict):
                    stats.n_accepted += 1
                    continue
                break
            out.extend(accepted)
            cur = accepted[-1]
            t.kv.cache_pos[0] = pos0 + len(accepted)

            all_tokens.extend(accepted)
            update(self.nc_context, self.ngram_min, self.ngram_max,
                   all_tokens, len(accepted))

            if t.eog_ids and out and out[-1] in t.eog_ids:
                break
            if t.kv.used(0) >= t.max_seq - self.n_draft - 2:
                break
        # accumulate this session into the dynamic cache (lookup.cpp flow)
        update(self.nc_dynamic, NGRAM_STATIC, NGRAM_STATIC,
               all_tokens, len(all_tokens))
        return out[:n_predict], stats
