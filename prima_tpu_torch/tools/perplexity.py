"""prima-perplexity — perplexity + task-accuracy evaluation.

Counterpart of prima_tpu/tools/perplexity.py on one device (CUDA unless
--device cpu). One chunk's forward is the module function `chunk_logp`,
which callers can run on token ids without a tokenizer.

The analogue of examples/perplexity/perplexity.cpp, all five modes:

  (default)          chunked wikitext perplexity over the second half of
                     each n_ctx window (perplexity.cpp:443)
  --hellaswag        acc_norm over 6-line-per-task HellaSwag extracts
                     (perplexity.cpp:766)
  --winogrande       Winogrande accuracy over the llama.cpp CSV format
                     (perplexity.cpp:1105)
  --multiple-choice  ARC/MMLU/TruthfulQA-style binary task files
                     (perplexity.cpp:1406)
  --kl-divergence    KL(base||this) against a --logits-file written by a
                     previous run (perplexity.cpp:1686); the file format
                     ("_logits_" magic, u32 n_ctx, i32 n_vocab, i32
                     n_chunk, tokens, uint16-coded log-prob rows) is
                     byte-compatible with the reference's.

Scoring rules match the reference exactly (mean token logprob per ending,
common-prefix handling, winogrande choice-skip heuristic); task SELECTION
under --*-tasks uses a different RNG than the C++ mt19937, so subsample
runs are statistically, not bitwise, comparable.
"""

from __future__ import annotations

import argparse
import math
import struct
import sys

import numpy as np


# ---------------------------------------------------------------------------
# shared scoring engine
# ---------------------------------------------------------------------------


def chunk_logp(params, cfg, toks, opts):
    """Log-softmax rows (n, V) f32 of one chunk of token ids toks (n,),
    run from position 0 over a fresh bf16 cache of n cells, on toks'
    device (the JAX tool's chunk_logp closure, perplexity.py:149-155)."""
    import torch

    from ..models.llama import forward, init_kv_caches

    n = toks.shape[0]
    kv = init_kv_caches(cfg, 1, n, torch.bfloat16, toks.device)
    positions = torch.arange(n, dtype=torch.int32, device=toks.device)[None]
    with torch.no_grad():
        logits, _ = forward(params, cfg, toks[None], positions, kv,
                            torch.zeros(1, dtype=torch.int32, device=toks.device), opts)
    return torch.log_softmax(logits[0].float(), dim=-1)


class _Scorer:
    """Batched full-sequence forward returning next-token log-probs,
    bucketed by padded length (16 * 2^k rows, as the JAX tool's buckets);
    the padding rows follow the real ones and change none of them."""

    def __init__(self, model, matmul: str = "kernel", device="cuda"):
        from .. import resolve_device
        from ..models.llama import ForwardOptions

        self.model = model
        self.cfg = model.cfg
        self.opts = ForwardOptions(matmul_impl=matmul)
        self.device = resolve_device(device)

    def _run(self, toks: np.ndarray) -> np.ndarray:
        """toks (b, lb) -> (b, lb-1): logp of toks[j+1] at position j."""
        import torch

        from ..models.llama import forward, init_kv_caches

        b, lb = toks.shape
        dev = self.device
        t = torch.as_tensor(toks, dtype=torch.int64, device=dev)
        kv = init_kv_caches(self.cfg, b, lb, torch.bfloat16, dev)
        positions = torch.arange(lb, dtype=torch.int32, device=dev)[None].expand(b, lb)
        with torch.no_grad():
            logits, _ = forward(self.model.params, self.cfg, t, positions, kv,
                                torch.zeros(b, dtype=torch.int32, device=dev), self.opts)
            logp = torch.log_softmax(logits.float(), dim=-1)
            nxt = torch.gather(logp[:, :-1], 2, t[:, 1:, None])[..., 0]
        return nxt.cpu().numpy()

    @staticmethod
    def _bucket(n: int) -> int:
        b = 16
        while b < n:
            b *= 2
        return b

    def next_logprobs(self, seqs: list[list[int]]) -> list[np.ndarray]:
        """Per sequence: (len-1,) array of logp(seq[j+1] | seq[..j])."""
        out: list[np.ndarray] = [None] * len(seqs)  # type: ignore
        by_bucket: dict[int, list[int]] = {}
        for i, s in enumerate(seqs):
            by_bucket.setdefault(self._bucket(len(s)), []).append(i)
        for lb, idxs in by_bucket.items():
            toks = np.zeros((len(idxs), lb), np.int32)
            for r, i in enumerate(idxs):
                toks[r, : len(seqs[i])] = seqs[i]
            nxt = self._run(toks)
            for r, i in enumerate(idxs):
                out[i] = nxt[r, : len(seqs[i]) - 1]
        return out


def _mean_ending_logprob(nxt: np.ndarray, common_prefix: int,
                         seq_len: int) -> float:
    """Reference hellaswag/mc rule: logp of the first ending token (at
    position cp-1) plus the remaining ending transitions, averaged over
    (len - cp) tokens (perplexity.cpp:980-991)."""
    lp = float(nxt[common_prefix - 1 : seq_len - 1].sum())
    return lp / (seq_len - common_prefix)


def _acc_sigma(n_correct: int, n_done: int) -> tuple[float, float]:
    p = n_correct / n_done
    sigma = 100.0 * math.sqrt(p * (1 - p) / max(n_done - 1, 1))
    return 100.0 * p, sigma


# ---------------------------------------------------------------------------
# wikitext perplexity (+ optional logits-file capture for --kl-divergence)
# ---------------------------------------------------------------------------


def compute_perplexity(model, text: str, n_ctx: int = 512, matmul: str = "kernel",
                       max_chunks: int = 0, logfile=sys.stderr,
                       logits_file: str | None = None, device="cuda"):
    import torch

    from .. import resolve_device
    from ..models.llama import ForwardOptions

    cfg = model.cfg
    dev = resolve_device(device)
    opts = ForwardOptions(matmul_impl=matmul)
    tokens = model.tokenizer.encode(text, add_special=True)
    n_chunks = len(tokens) // n_ctx
    if max_chunks:
        n_chunks = min(n_chunks, max_chunks)
    if n_chunks < 1:
        raise ValueError(f"need at least {n_ctx} tokens, got {len(tokens)}")

    writer = None
    if logits_file:
        writer = open(logits_file, "wb")
        writer.write(b"_logits_")
        writer.write(struct.pack("<I", n_ctx))
        writer.write(struct.pack("<ii", cfg.n_vocab, n_chunks))
        writer.write(np.asarray(tokens[: n_chunks * n_ctx],
                                np.int32).tobytes())

    start = n_ctx // 2
    total_nll, total_cnt = 0.0, 0
    for c in range(n_chunks):
        chunk = torch.as_tensor(tokens[c * n_ctx : (c + 1) * n_ctx], dtype=torch.int64,
                                device=dev)
        logp = chunk_logp(model.params, cfg, chunk, opts)
        nxt = logp[torch.arange(n_ctx - 1, device=dev), chunk[1:]].cpu().numpy()
        total_nll += float(-nxt[start:].sum())
        total_cnt += n_ctx - 1 - start
        if writer is not None:
            _write_logprob_rows(writer, logp[start : n_ctx - 1].cpu().numpy(),
                                cfg.n_vocab)
        ppl = math.exp(total_nll / total_cnt)
        print(f"[{c + 1}/{n_chunks}] ppl = {ppl:.4f}", file=logfile, flush=True)
    if writer is not None:
        writer.close()
        print(f"saved base log-probs to {logits_file}", file=logfile)
    return math.exp(total_nll / total_cnt), total_cnt


def _write_logprob_rows(out, logp_rows: np.ndarray, n_vocab: int) -> None:
    """Reference uint16 log-prob codec (perplexity.cpp:125-153): per row,
    two f32 (scale, min_log_prob) then V uint16 codes, padded to nv."""
    nv = 2 * ((n_vocab + 1) // 2) + 4
    for row in logp_rows:
        # row is log_softmax: logits - logsumexp. Recover relative logits.
        max_lp = float(row.max())
        rel = row - max_lp  # == logits - max_logit
        min_rel = max(float(rel.min()), -16.0)
        scale = (0.0 - min_rel) / 65535.0
        min_log_prob = min_rel + max_lp  # == min_logit-max_logit-logsumexp
        buf = np.zeros(nv, np.uint16)
        buf[:4] = np.frombuffer(
            struct.pack("<ff", scale, min_log_prob), np.uint16)
        if scale > 0:
            codes = np.rint((rel - min_rel) / scale)
            codes[rel <= min_rel] = 0
            buf[4 : 4 + n_vocab] = np.clip(codes, 0, 65535).astype(np.uint16)
        out.write(buf.tobytes())


# ---------------------------------------------------------------------------
# hellaswag (perplexity.cpp:766)
# ---------------------------------------------------------------------------


def hellaswag_score(model, text: str, n_tasks: int = 400, matmul: str = "kernel",
                    logfile=sys.stderr, device="cuda") -> tuple[float, int]:
    lines = [ln for ln in text.split("\n") if True]
    while lines and lines[-1] == "":
        lines.pop()
    if len(lines) % 6 != 0:
        raise ValueError("hellaswag prompt must be 6 lines per task "
                         "(context, gold index, 4 endings)")
    all_tasks = [lines[i : i + 6] for i in range(0, len(lines), 6)]
    rng = np.random.default_rng(1)
    if n_tasks and n_tasks < len(all_tasks):
        sel = rng.choice(len(all_tasks), size=n_tasks, replace=False)
        all_tasks = [all_tasks[i] for i in sel]

    scorer = _Scorer(model, matmul, device)
    tok = model.tokenizer
    n_correct = 0
    print("task\tacc_norm", file=logfile)
    for i, t in enumerate(all_tasks):
        context, gold = t[0], int(t[1])
        seqs = [tok.encode(context + " " + t[2 + j], add_special=True)
                for j in range(4)]
        cp = 0
        m = min(len(s) for s in seqs)
        while cp < m and all(s[cp] == seqs[0][cp] for s in seqs[1:]):
            cp += 1
        nxts = scorer.next_logprobs(seqs)
        scores = [_mean_ending_logprob(nxts[j], cp, len(seqs[j]))
                  for j in range(4)]
        if int(np.argmax(scores)) == gold:
            n_correct += 1
        print(f"{i + 1}\t{100.0 * n_correct / (i + 1):.8f}",
              file=logfile, flush=True)
    acc, sigma = _acc_sigma(n_correct, len(all_tasks))
    print(f"Final HellaSwag score({len(all_tasks)} tasks): "
          f"{acc:.4f} +/- {sigma:.4f}", file=logfile)
    return acc, len(all_tasks)


# ---------------------------------------------------------------------------
# winogrande (perplexity.cpp:1105)
# ---------------------------------------------------------------------------


def _parse_winogrande_csv(text: str) -> list[dict]:
    """The reference's purpose-built parser (load_winogrande_from_csv):
    4 comma separators outside double quotes; sentence contains `_`."""
    tasks = []
    for line in text.splitlines():
        if not line.strip():
            continue
        comma_pos = []
        quote = False
        for i, ch in enumerate(line):
            if not quote:
                if ch == ",":
                    comma_pos.append(i)
                    if len(comma_pos) == 4:
                        break
                elif ch == '"':
                    quote = True
            elif ch == '"':
                quote = False
        if len(comma_pos) != 4:
            continue
        c = comma_pos
        if line[c[0] + 1] == '"':
            sentence = line[c[0] + 2 : c[1] - 1]
        else:
            sentence = line[c[0] + 1 : c[1]]
        choice1 = line[c[1] + 1 : c[2]]
        choice2 = line[c[2] + 1 : c[3]]
        try:
            answer = int(line[c[3] + 1 :])
        except ValueError:
            continue
        if "_" not in sentence or answer not in (1, 2):
            continue
        w = sentence.index("_")
        tasks.append({"first": sentence[:w], "second": sentence[w + 1 :],
                      "choices": [choice1, choice2], "answer": answer})
    return tasks


def winogrande_score(model, text: str, n_tasks: int = 0, matmul: str = "kernel",
                     logfile=sys.stderr, device="cuda") -> tuple[float, int]:
    K_MIN_TRAILING = 3  # k_min_trailing_ctx, perplexity.cpp:1107
    tasks = _parse_winogrande_csv(text)
    if not tasks:
        raise ValueError("no winogrande tasks parsed")
    rng = np.random.default_rng(1)
    if n_tasks and n_tasks < len(tasks):
        sel = rng.choice(len(tasks), size=n_tasks, replace=False)
        tasks = [tasks[i] for i in sel]

    scorer = _Scorer(model, matmul, device)
    tok = model.tokenizer
    n_correct = 0
    for i, t in enumerate(tasks):
        seqs = [tok.encode(t["first"] + t["choices"][s] + t["second"],
                           add_special=True) for s in range(2)]
        n_base = [len(tok.encode(t["first"] + t["choices"][s],
                                 add_special=True)) for s in range(2)]
        cp = 0
        m = min(len(s) for s in seqs)
        while cp < m and seqs[0][cp] == seqs[1][cp]:
            cp += 1
        skip_choice = (len(seqs[0]) - cp > K_MIN_TRAILING
                       and len(seqs[1]) - cp > K_MIN_TRAILING)
        nxts = scorer.next_logprobs(seqs)
        scores = []
        for s in range(2):
            base = n_base[s] if skip_choice else cp
            last = 1 if len(seqs[s]) - base > 1 else 0
            js = range(base - 1, len(seqs[s]) - 1 - last)
            tot = float(sum(nxts[s][j] for j in js))
            scores.append(tot / max(len(seqs[s]) - base - last, 1))
        result = 1 if scores[0] > scores[1] else 2
        if result == t["answer"]:
            n_correct += 1
        print(f"{i + 1}\t{100.0 * n_correct / (i + 1):.4f}\t"
              f"{scores[0]:10.6f}  {scores[1]:10.6f}  {result}  "
              f"{t['answer']}", file=logfile, flush=True)
    acc, sigma = _acc_sigma(n_correct, len(tasks))
    print(f"Final Winogrande score({len(tasks)} tasks): "
          f"{acc:.4f} +/- {sigma:.4f}", file=logfile)
    return acc, len(tasks)


# ---------------------------------------------------------------------------
# multiple-choice (ARC/MMLU/TruthfulQA; perplexity.cpp:1406)
# ---------------------------------------------------------------------------


def _read_mc_tasks(data: bytes) -> list[dict]:
    """Binary format: u32 n_task; u32 task_pos[n]; per task: question
    (u32 len + bytes), answers (u32 n, strings), labels (i32[n]), then an
    unused second answer set with the same layout."""
    off = 0

    def u32():
        nonlocal off
        v = struct.unpack_from("<I", data, off)[0]
        off += 4
        return v

    def string():
        nonlocal off
        n = u32()
        s = data[off : off + n].decode("utf-8", errors="replace")
        off += n
        return s

    def answers():
        n = u32()
        if n > 100:
            raise ValueError("bad multiple-choice file")
        ans = [string() for _ in range(n)]
        nonlocal off
        labels = list(struct.unpack_from(f"<{n}i", data, off))
        off += 4 * n
        return ans, labels

    n_task = u32()
    off += 4 * n_task  # task_pos table (only needed for random seeks)
    tasks = []
    for _ in range(n_task):
        q = string()
        a1, l1 = answers()
        answers()  # mc2: unused by the scorer (perplexity.cpp:1333)
        tasks.append({"question": q, "answers": a1, "labels": l1})
    return tasks


def multiple_choice_score(model, data: bytes, n_tasks: int = 0,
                          matmul: str = "kernel",
                          logfile=sys.stderr, device="cuda") -> tuple[float, int]:
    tasks = _read_mc_tasks(data)
    rng = np.random.default_rng(1)
    if n_tasks and n_tasks < len(tasks):
        sel = rng.choice(len(tasks), size=n_tasks, replace=False)
        tasks = [tasks[i] for i in sel]

    scorer = _Scorer(model, matmul, device)
    tok = model.tokenizer
    n_correct = n_done = 0
    for t in tasks:
        if not t["question"] or not t["answers"] or \
                any(not a for a in t["answers"]):
            continue
        seqs = [tok.encode(t["question"] + " " + a, add_special=True)
                for a in t["answers"]]
        cp = 0
        m = min(len(s) for s in seqs)
        while cp < m and all(s[cp] == seqs[0][cp] for s in seqs[1:]):
            cp += 1
        nxts = scorer.next_logprobs(seqs)
        scores = [_mean_ending_logprob(nxts[j], cp, len(seqs[j]))
                  for j in range(len(seqs))]
        n_done += 1
        if t["labels"][int(np.argmax(scores))] == 1:
            n_correct += 1
        print(f"{n_done}\t{100.0 * n_correct / n_done:.8f}",
              file=logfile, flush=True)
    if not n_done:
        raise ValueError("no valid multiple-choice tasks")
    acc, sigma = _acc_sigma(n_correct, n_done)
    print(f"Final result: {acc:.4f} +/- {sigma:.4f}", file=logfile)
    return acc, n_done


# ---------------------------------------------------------------------------
# KL divergence vs a base-model logits file (perplexity.cpp:1686)
# ---------------------------------------------------------------------------


def kl_divergence(model, logits_path: str, matmul: str = "kernel",
                  logfile=sys.stderr, device="cuda") -> dict:
    import torch

    from .. import resolve_device
    from ..models.llama import ForwardOptions

    with open(logits_path, "rb") as f:
        if f.read(8) != b"_logits_":
            raise ValueError(f"{logits_path}: not a logits file")
        n_ctx = struct.unpack("<I", f.read(4))[0]
        n_vocab, n_chunk = struct.unpack("<ii", f.read(8))
        if n_vocab != model.cfg.n_vocab:
            raise ValueError(f"vocab mismatch ({n_vocab} vs "
                             f"{model.cfg.n_vocab})")
        tokens = np.frombuffer(f.read(4 * n_ctx * n_chunk), np.int32)
        nv = 2 * ((n_vocab + 1) // 2) + 4
        n_rows = n_ctx - 1 - n_ctx // 2
        base_rows = f.read()
    base = np.frombuffer(base_rows, np.uint16).reshape(n_chunk, n_rows, nv)

    cfg = model.cfg
    dev = resolve_device(device)
    opts = ForwardOptions(matmul_impl=matmul)

    start = n_ctx // 2
    klds, p_diffs, nlls, nlls_base = [], [], [], []
    n_same_top = 0
    for c in range(n_chunk):
        chunk = tokens[c * n_ctx : (c + 1) * n_ctx]
        logp = chunk_logp(model.params, cfg,
                          torch.as_tensor(chunk.astype(np.int64), device=dev),
                          opts).cpu().numpy()
        for r in range(n_rows):
            j = start + r  # position whose next token is chunk[j+1]
            row = base[c, r]
            scale, min_log_prob = struct.unpack("<ff", row[:4].tobytes())
            base_lp = row[4 : 4 + n_vocab].astype(np.float32) * scale \
                + min_log_prob
            ours = logp[j]
            tokn = int(chunk[j + 1])
            nll = -float(ours[tokn])
            nll_base = -float(base_lp[tokn])
            mask = base_lp > -16.0
            kld = float(np.sum(np.exp(base_lp[mask])
                               * (base_lp[mask] - ours[mask])))
            klds.append(kld)
            nlls.append(nll)
            nlls_base.append(nll_base)
            p_diffs.append(math.exp(-nll) - math.exp(-nll_base))
            if int(np.argmax(ours)) == int(np.argmax(base_lp)):
                n_same_top += 1
        print(f"[{c + 1}/{n_chunk}] mean KLD = "
              f"{np.mean(klds):.6f}", file=logfile, flush=True)

    klds_a = np.asarray(klds)
    p_a = np.abs(np.asarray(p_diffs))
    out = {
        "mean_nll": float(np.mean(nlls)),
        "mean_nll_base": float(np.mean(nlls_base)),
        "ppl_ratio": math.exp(float(np.mean(nlls) - np.mean(nlls_base))),
        "mean_kld": float(klds_a.mean()),
        "median_kld": float(np.median(klds_a)),
        "kld_p99": float(np.percentile(klds_a, 99)),
        "max_kld": float(klds_a.max()),
        "mean_abs_p_diff": float(p_a.mean()),
        "p_diff_p99": float(np.percentile(p_a, 99)),
        "max_p_diff": float(p_a.max()),
        "same_top_p": 100.0 * n_same_top / len(klds),
        "count": len(klds),
    }
    for k, v in out.items():
        print(f"{k:>16}: {v:.6f}" if isinstance(v, float) else
              f"{k:>16}: {v}", file=logfile)
    return out


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="prima-perplexity", description=__doc__)
    ap.add_argument("-m", "--model", required=True)
    ap.add_argument("-f", "--file", required=True,
                    help="corpus / task file (binary for --multiple-choice)")
    ap.add_argument("-c", "--ctx-size", type=int, default=512)
    ap.add_argument("--chunks", type=int, default=0, help="limit #chunks (0=all)")
    ap.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    ap.add_argument("--matmul", default="kernel", choices=["kernel", "plain"])
    ap.add_argument("--hellaswag", action="store_true")
    ap.add_argument("--hellaswag-tasks", type=int, default=400)
    ap.add_argument("--winogrande", action="store_true")
    ap.add_argument("--winogrande-tasks", type=int, default=0)
    ap.add_argument("--multiple-choice", action="store_true")
    ap.add_argument("--multiple-choice-tasks", type=int, default=0)
    ap.add_argument("--kl-divergence", action="store_true",
                    help="compare against --logits-file (read mode)")
    ap.add_argument("--logits-file", default=None,
                    help="write base log-probs during a ppl run; read "
                         "them with --kl-divergence")
    args = ap.parse_args(argv)

    from ..models.loader import load_model

    model = load_model(args.model, device=args.device)
    if args.multiple_choice:
        data = open(args.file, "rb").read()
        acc, n = multiple_choice_score(model, data,
                                       args.multiple_choice_tasks,
                                       args.matmul, device=args.device)
        print(f"final result: {acc:.4f} over {n} tasks")
        return 0
    if args.kl_divergence:
        if not args.logits_file:
            print("--kl-divergence needs --logits-file", file=sys.stderr)
            return 1
        out = kl_divergence(model, args.logits_file, args.matmul, device=args.device)
        print(f"final mean KLD = {out['mean_kld']:.6f} over "
              f"{out['count']} positions")
        return 0
    text = open(args.file, encoding="utf-8").read()
    if args.hellaswag:
        acc, n = hellaswag_score(model, text, args.hellaswag_tasks,
                                 args.matmul, device=args.device)
        print(f"final acc_norm = {acc:.4f} over {n} tasks")
        return 0
    if args.winogrande:
        acc, n = winogrande_score(model, text, args.winogrande_tasks,
                                  args.matmul, device=args.device)
        print(f"final accuracy = {acc:.4f} over {n} tasks")
        return 0
    ppl, n = compute_perplexity(model, text, args.ctx_size, args.matmul,
                                args.chunks, logits_file=args.logits_file,
                                device=args.device)
    print(f"final ppl = {ppl:.4f} over {n} tokens")
    return 0


if __name__ == "__main__":
    sys.exit(main())
