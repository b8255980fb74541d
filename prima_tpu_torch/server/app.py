"""OpenAI-compatible HTTP server.

Counterpart of prima_tpu/server/app.py for the single-device path, with
LoRA adapters (/lora-adapters), grammar / JSON-schema sampling and
speculative decoding with a draft model (`spec`); `serve_embeddings`
serves a BERT-arch encoder (/v1/embeddings, /v1/rerank).

The llama-server analogue (reference examples/server/server.cpp): slot-based
continuous batching over the Engine, SSE streaming, /v1/chat/completions,
/v1/completions, /v1/embeddings, /v1/cancel, /health, /metrics (Prometheus),
/props, /slots with save/restore/erase, /tokenize, /detokenize.

Pure stdlib HTTP (ThreadingHTTPServer) — handler threads enqueue work to the
single engine-owning worker thread and stream results back.
"""

from __future__ import annotations

import json
import re
import time
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

from ..models.loader import LoadedModel
from ..ops import attention, kv_write
from ..quant import qmatmul
from ..runtime.engine import Engine
from ..sampling import Sampler, SamplerParams
from .chat import apply_chat_template
from .scheduler import EngineWorker, GenerationRequest


class ServerContext:
    def __init__(self, model: LoadedModel, engine: Engine, alias: str = "prima-tpu",
                 loras: list | None = None, spec=None, slot_save_dir: str | None = None,
                 api_keys: list[str] | None = None):
        self.model = model
        self.engine = engine
        self.alias = alias
        # --api-key auth (server.cpp middleware_validate_api_key @2743)
        self.api_keys = set(api_keys or [])
        self.worker = EngineWorker(engine, model.tokenizer, spec=spec)
        self.chat_template = model.gguf.get("tokenizer.chat_template")
        self.t_start = time.time()
        self._token_bytes = None
        # /lora-adapters registry: [{"id", "path", "scale", "data"}], "data"
        # being load_lora_gguf(path, scale=1.0) and "scale" the current user
        # multiplier; base_params are the params without any adapter
        self.loras = loras or []
        self.base_params = model.params if self.loras else None
        # like the reference's --slot-save-path: when set, slot files are
        # confined to this directory (plain filenames only)
        self.slot_save_dir = slot_save_dir

    def set_lora_scales(self, entries: list[dict]) -> None:
        """POST /lora-adapters (server.cpp:3443): every adapter's scale to
        0, then the listed ones set, an error on a bad id; the rebuilt
        params swap in at a safe point of the engine loop."""
        from ..models.adapters import apply_lora

        if not self.loras:
            if entries:
                raise ValueError("invalid adapter id")
            return
        parsed = [(int(e["id"]), float(e["scale"])) for e in entries]
        if any(not 0 <= i < len(self.loras) for i, _ in parsed):
            raise ValueError("invalid adapter id")  # validate before mutating
        for rec in self.loras:
            rec["scale"] = 0.0
        for i, sc in parsed:
            self.loras[i]["scale"] = sc
        params = self.base_params
        for rec in self.loras:
            if rec["scale"] != 0.0:
                params = apply_lora(params, rec["data"], scale=rec["scale"])

        def swap():
            self.engine.params = params

        self.worker.run(swap)

    def start(self):
        self.worker.start()

    def token_bytes(self):
        if self._token_bytes is None:
            n = self.model.tokenizer.vocab.n_tokens
            self._token_bytes = [self.model.tokenizer.decode_token_bytes(i) for i in range(n)]
        return self._token_bytes

    def make_sampler(self, body: dict) -> Sampler:
        grammar = None
        gtext = body.get("grammar", "")
        rf = body.get("response_format") or {}
        schema = body.get("json_schema")
        if rf.get("type") == "json_schema":
            schema = (rf.get("json_schema") or {}).get("schema")
        elif rf.get("type") == "json_object":
            schema = {"type": "object"}
        if schema:
            from ..grammar.json_schema import json_schema_to_gbnf

            gtext = json_schema_to_gbnf(schema)
        if gtext:
            from ..grammar.engine import GrammarSampler

            grammar = GrammarSampler(gtext, self.token_bytes(), eog_ids=self.model.eog_ids)

        bias = {}
        for k, v in (body.get("logit_bias") or {}).items():
            bias[int(k)] = float(v)
        p = SamplerParams(
            seed=int(body.get("seed", -1)) if int(body.get("seed", -1)) >= 0 else 0xFFFFFFFF,
            temp=float(body.get("temperature", 0.8)),
            top_k=int(body.get("top_k", 40)),
            top_p=float(body.get("top_p", 0.95)),
            min_p=float(body.get("min_p", 0.05)),
            tfs_z=float(body.get("tfs_z", 1.0)),
            typ_p=float(body.get("typical_p", 1.0)),
            penalty_last_n=int(body.get("repeat_last_n", 64)),
            penalty_repeat=float(body.get("repeat_penalty", 1.0)),
            penalty_freq=float(body.get("frequency_penalty", 0.0)),
            penalty_present=float(body.get("presence_penalty", 0.0)),
            mirostat=int(body.get("mirostat", 0)),
            mirostat_tau=float(body.get("mirostat_tau", 5.0)),
            mirostat_eta=float(body.get("mirostat_eta", 0.1)),
            logit_bias=bias,
        )
        return Sampler(p, n_vocab=self.model.cfg.n_vocab, grammar=grammar)


def make_handler(ctx: ServerContext):
    tok = ctx.model.tokenizer

    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # quiet
            pass

        # -- helpers ---------------------------------------------------------

        def _json(self, code: int, obj) -> None:
            data = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(data)))
            self.end_headers()
            self.wfile.write(data)

        def _error(self, code: int, msg: str, etype: str = "invalid_request_error"):
            self._json(code, {"error": {"message": msg, "type": etype, "code": code}})

        # endpoints requiring a valid Bearer key when --api-key is set —
        # the reference list (server.cpp middleware_validate_api_key) plus
        # the state-mutating/inference endpoints it forgot (rerank, slots,
        # lora, cancel); /health, /v1/models and /metrics stay public
        PROTECTED = {
            "/props", "/completion", "/completions", "/v1/completions",
            "/chat/completions", "/v1/chat/completions", "/infill",
            "/tokenize", "/detokenize", "/embedding", "/embeddings",
            "/v1/embeddings", "/rerank", "/reranking", "/v1/rerank",
            "/v1/reranking", "/lora-adapters", "/v1/cancel", "/slots",
        }

        def _check_auth(self, path: str) -> bool:
            protected = path in self.PROTECTED or path.startswith("/slots/")
            if not ctx.api_keys or not protected:
                return True
            auth = self.headers.get("Authorization", "")
            if auth.startswith("Bearer ") and auth[7:] in ctx.api_keys:
                return True
            # drain the body so the 401 does not desync HTTP/1.1 keep-alive
            n = int(self.headers.get("Content-Length", 0) or 0)
            while n > 0:
                chunk = self.rfile.read(min(n, 65536))
                if not chunk:  # client hung up mid-body
                    self.close_connection = True
                    break
                n -= len(chunk)
            self._error(401, "Invalid API Key", "authentication_error")
            return False

        def _body(self) -> dict:
            n = int(self.headers.get("Content-Length", 0))
            if n == 0:
                return {}
            return json.loads(self.rfile.read(n) or b"{}")

        def _sse_start(self):
            self.send_response(200)
            self.send_header("Content-Type", "text/event-stream")
            self.send_header("Cache-Control", "no-cache")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

        def _sse_send(self, obj) -> None:
            payload = b"data: " + json.dumps(obj).encode() + b"\n\n"
            self.wfile.write(f"{len(payload):x}\r\n".encode() + payload + b"\r\n")
            self.wfile.flush()

        def _sse_end(self):
            done = b"data: [DONE]\n\n"
            self.wfile.write(f"{len(done):x}\r\n".encode() + done + b"\r\n")
            self.wfile.write(b"0\r\n\r\n")

        # -- GET ---------------------------------------------------------------

        def do_GET(self):
            path = self.path.split("?")[0]
            if not self._check_auth(path):
                return
            if path == "/health":
                self._json(200, {"status": "ok"})
            elif path in ("/", "/index.html"):
                from .webui import INDEX_HTML

                data = INDEX_HTML.encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/html; charset=utf-8")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/props":
                launches, by_rank = self._launches()
                self._json(200, {
                    "model": ctx.alias,
                    "n_ctx": ctx.engine.max_seq,
                    "total_slots": ctx.engine.n_slots,
                    "chat_template": ctx.chat_template or "",
                    "arch": ctx.model.cfg.arch,
                    "n_params_layers": ctx.model.cfg.n_layers,
                    "kernel_launches": launches,
                    **({"kernel_launches_by_rank": by_rank} if by_rank else {}),
                })
            elif path == "/metrics":
                m = ctx.worker.metrics
                lines = [
                    "# TYPE llamacpp:prompt_tokens_total counter",
                    f"llamacpp:prompt_tokens_total {m['prompt_tokens_total']}",
                    "# TYPE llamacpp:tokens_predicted_total counter",
                    f"llamacpp:tokens_predicted_total {m['tokens_predicted_total']}",
                    "# TYPE llamacpp:n_decode_total counter",
                    f"llamacpp:n_decode_total {ctx.engine.n_decode_calls}",
                    "# TYPE llamacpp:n_busy_slots_per_decode gauge",
                    f"llamacpp:n_busy_slots_per_decode {m['n_busy_slots']}",
                    "# TYPE llamacpp:requests_total counter",
                    f"llamacpp:requests_total {m['n_requests']}",
                    "# TYPE llamacpp:prompt_seconds_total counter",
                    f"llamacpp:prompt_seconds_total {ctx.engine.perf['t_prompt_s']}",
                    "# TYPE llamacpp:tokens_predicted_seconds_total counter",
                    f"llamacpp:tokens_predicted_seconds_total {ctx.engine.perf['t_decode_s']}",
                    "# TYPE llamacpp:requests_processing gauge",
                    f"llamacpp:requests_processing {len(ctx.worker.active)}",
                    "# TYPE llamacpp:requests_deferred gauge",
                    f"llamacpp:requests_deferred {ctx.worker.pending.qsize()}",
                    "# TYPE prima:kernel_launches_total counter",
                ] + [f'prima:kernel_launches_total{{kernel="{k}"}} {n}'
                     for k, n in self._launches()[0].items()]
                data = ("\n".join(lines) + "\n").encode()
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; version=0.0.4")
                self.send_header("Content-Length", str(len(data)))
                self.end_headers()
                self.wfile.write(data)
            elif path == "/v1/models":
                self._json(200, {"object": "list", "data": [{
                    "id": ctx.alias, "object": "model", "created": int(ctx.t_start),
                    "owned_by": "prima-tpu"}]})
            elif path == "/lora-adapters":
                self._json(200, [{"id": rec["id"], "path": rec["path"],
                                  "scale": rec["scale"]} for rec in ctx.loras])
            elif path == "/slots":
                slots = [{
                    "id": s.id, "state": s.state.name,
                    "n_past": ctx.engine.kv.used(s.id),
                    "n_predict": s.n_predict,
                    "stop_reason": s.stop_reason,
                } for s in ctx.engine.slots]
                self._json(200, slots)
            else:
                self._error(404, f"unknown endpoint {path}")

        def _launches(self):
            """(launch counts, per rank or None): a mesh engine gathers every
            rank's counts on its worker thread, between steps."""
            if hasattr(ctx.engine, "kernel_launches"):
                r = ctx.worker.run(ctx.engine.kernel_launches)
                return r["total"], r["by_rank"]
            return kernel_launches(), None

        # -- POST ----------------------------------------------------------------

        def do_POST(self):
            path = self.path.split("?")[0]
            if not self._check_auth(path):
                return
            try:
                body = self._body()
            except json.JSONDecodeError:
                return self._error(400, "invalid JSON body")
            try:
                if path in ("/v1/chat/completions", "/chat/completions"):
                    self._chat(body)
                elif path in ("/v1/completions", "/completion", "/completions"):
                    self._completion(body)
                elif path in ("/v1/embeddings", "/embedding", "/embeddings"):
                    self._embeddings(body)
                elif path in ("/v1/rerank", "/rerank", "/v1/reranking"):
                    self._rerank(body)
                elif path == "/infill":
                    self._infill(body)
                elif path == "/v1/cancel":
                    rid = body.get("task_id")
                    ok = ctx.worker.cancel(int(rid)) if rid is not None else False
                    self._json(200 if ok else 404, {"cancelled": bool(ok), "task_id": rid})
                elif path == "/tokenize":
                    ids = tok.encode(body.get("content", ""), add_special=bool(body.get("add_special", False)),
                                     parse_special=bool(body.get("parse_special", True)))
                    self._json(200, {"tokens": ids})
                elif path == "/detokenize":
                    self._json(200, {"content": tok.decode(body.get("tokens", []))})
                elif path == "/lora-adapters":
                    ctx.set_lora_scales(body if isinstance(body, list) else [])
                    self._json(200, {"success": True})
                elif re.fullmatch(r"/slots/\d+", path):
                    self._slot_action(int(path.rsplit("/", 1)[1]), body)
                else:
                    self._error(404, f"unknown endpoint {path}")
            except BrokenPipeError:
                pass
            except ValueError as e:
                self._error(400, str(e))

        # -- endpoint bodies ----------------------------------------------------

        def _prep(self, body: dict, prompt_text: str | None, prompt_tokens=None):
            n_predict = int(body.get("max_tokens") or body.get("n_predict") or 128)
            stop = body.get("stop") or []
            if isinstance(stop, str):
                stop = [stop]
            if prompt_tokens is None:
                prompt_tokens = tok.encode(prompt_text, add_special=True, parse_special=True)
            if not prompt_tokens:
                prompt_tokens = [tok.vocab.bos_id if tok.vocab.bos_id >= 0 else 0]
            if len(prompt_tokens) >= ctx.engine.max_seq:
                raise ValueError(
                    f"prompt ({len(prompt_tokens)} tokens) exceeds the "
                    f"context size ({ctx.engine.max_seq})")
            return GenerationRequest(
                prompt_tokens=prompt_tokens,
                sampler=ctx.make_sampler(body),
                n_predict=n_predict,
                stop=list(stop),
                n_probs=int(body.get("logprobs") or body.get("n_probs") or 0),
            )

        def _completion(self, body: dict):
            prompt = body.get("prompt", "")
            if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
                req = self._prep(body, None, prompt_tokens=prompt)
            else:
                req = self._prep(body, prompt if isinstance(prompt, str) else "".join(prompt))
            rid = f"cmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            if body.get("stream"):
                self._sse_start()
                for ev in ctx.worker.generate(req):
                    if ev.text:
                        self._sse_send({
                            "id": rid, "object": "text_completion", "created": created,
                            "model": ctx.alias, "task_id": req.request_id,
                            "choices": [{"index": 0, "text": ev.text,
                                         "finish_reason": None}]})
                    if ev.done:
                        self._sse_send({
                            "id": rid, "object": "text_completion", "created": created,
                            "model": ctx.alias,
                            "choices": [{"index": 0, "text": "",
                                         "finish_reason": _finish(ev.reason)}]})
                self._sse_end()
            else:
                for ev in ctx.worker.generate(req):
                    last = ev
                choice = {"index": 0, "text": req.text,
                          "finish_reason": _finish(last.reason)}
                if req.n_probs and req.logprobs_out:
                    choice["logprobs"] = _logprobs_obj(req, tok)
                self._json(200, {
                    "id": rid, "object": "text_completion", "created": created,
                    "model": ctx.alias, "task_id": req.request_id,
                    "choices": [choice],
                    "usage": _usage(req)})

        def _chat(self, body: dict):
            messages = body.get("messages") or []
            text = apply_chat_template(messages, ctx.chat_template, tok.vocab)
            req = self._prep(body, None,
                             prompt_tokens=tok.encode(text, add_special=True, parse_special=True))
            rid = f"chatcmpl-{uuid.uuid4().hex[:24]}"
            created = int(time.time())
            if body.get("stream"):
                self._sse_start()
                self._sse_send({
                    "id": rid, "object": "chat.completion.chunk", "created": created,
                    "model": ctx.alias, "task_id": req.request_id,
                    "choices": [{"index": 0, "delta": {"role": "assistant"},
                                 "finish_reason": None}]})
                for ev in ctx.worker.generate(req):
                    if ev.text:
                        self._sse_send({
                            "id": rid, "object": "chat.completion.chunk", "created": created,
                            "model": ctx.alias,
                            "choices": [{"index": 0, "delta": {"content": ev.text},
                                         "finish_reason": None}]})
                    if ev.done:
                        self._sse_send({
                            "id": rid, "object": "chat.completion.chunk", "created": created,
                            "model": ctx.alias,
                            "choices": [{"index": 0, "delta": {},
                                         "finish_reason": _finish(ev.reason)}]})
                self._sse_end()
            else:
                for ev in ctx.worker.generate(req):
                    last = ev
                self._json(200, {
                    "id": rid, "object": "chat.completion", "created": created,
                    "model": ctx.alias, "task_id": req.request_id,
                    "choices": [{"index": 0,
                                 "message": {"role": "assistant", "content": req.text},
                                 "finish_reason": _finish(last.reason)}],
                    "usage": _usage(req)})

        def _embeddings(self, body: dict):
            inputs = body.get("input") or body.get("content") or ""
            single = isinstance(inputs, str)
            if single:
                inputs = [inputs]
            data = []
            for i, text in enumerate(inputs):
                ids = tok.encode(text, add_special=True)
                vec = ctx.engine.embed(ids)
                data.append({"object": "embedding", "index": i,
                             "embedding": [float(x) for x in vec]})
            self._json(200, {"object": "list", "data": data, "model": ctx.alias,
                             "usage": {"prompt_tokens": sum(len(tok.encode(t)) for t in inputs),
                                       "total_tokens": 0}})

        def _rerank(self, body: dict):
            """Query-document relevance (the /v1/rerank endpoint,
            server.cpp). Without a rank-head model, scores are cosine
            similarities of pooled embeddings."""
            query = body.get("query", "")
            docs = body.get("documents") or []
            qv = ctx.engine.embed(tok.encode(query, add_special=True))
            qv = qv / (np.linalg.norm(qv) + 1e-8)
            results = []
            for i, d in enumerate(docs):
                dv = ctx.engine.embed(tok.encode(d, add_special=True))
                dv = dv / (np.linalg.norm(dv) + 1e-8)
                results.append({"index": i, "relevance_score": float(qv @ dv)})
            results.sort(key=lambda r: -r["relevance_score"])
            self._json(200, {"model": ctx.alias, "object": "list", "results": results})

        def _infill(self, body: dict):
            """Fill-in-the-middle completion (server.cpp /infill): requires
            FIM special tokens in the vocab."""
            from ..tokenizer.fim import build_infill_prompt

            try:
                toks = build_infill_prompt(
                    tok, body.get("input_prefix", ""),
                    body.get("input_suffix", ""),
                    spm_infill=bool(body.get("spm_infill", False)))
            except ValueError:
                return self._error(501, "model has no FIM tokens")
            req = self._prep(body, None, prompt_tokens=toks)
            for ev in ctx.worker.generate(req):
                last = ev
            self._json(200, {"content": req.text,
                             "stop_type": _finish(last.reason),
                             "tokens_predicted": len(req.text.split())})

        def _slot_action(self, slot_id: int, body: dict):
            from urllib.parse import parse_qs, urlparse

            q = parse_qs(urlparse(self.path).query)
            action = (q.get("action") or [""])[0]
            if slot_id < 0 or slot_id >= ctx.engine.n_slots:
                return self._error(404, f"no slot {slot_id}")
            # engine state is worker-thread-owned: run every mutation at a
            # safe point between steps (ctx.worker.run)
            if action == "erase":
                def _erase():
                    ctx.engine.kv.seq_rm(slot_id, 0)
                    ctx.engine.slots[slot_id].prompt = []

                ctx.worker.run(_erase)
                self._json(200, {"id_slot": slot_id, "erased": True})
            elif action in ("save", "restore"):
                import os

                from ..runtime.state import slot_restore, slot_save

                fname = body.get("filename") or f"slot{slot_id}.bin"
                if ctx.slot_save_dir is not None:
                    # confined mode (--slot-save-path): plain filenames only
                    if os.path.basename(fname) != fname or fname.startswith("."):
                        return self._error(400, "invalid filename")
                    fname = os.path.join(ctx.slot_save_dir, fname)
                if action == "save":
                    n = ctx.worker.run(lambda: slot_save(ctx.engine, slot_id, fname))
                    self._json(200, {"id_slot": slot_id, "filename": fname, "n_saved": n})
                else:
                    n = ctx.worker.run(lambda: slot_restore(ctx.engine, slot_id, fname))
                    self._json(200, {"id_slot": slot_id, "filename": fname,
                                     "n_restored": n})
            else:
                self._error(400, f"unknown slot action {action!r}")

    return Handler


def _logprobs_obj(req, tok) -> dict:
    """OpenAI legacy completions logprobs block."""
    toks, tlp, top = [], [], []
    for t, lps in zip(req.tokens_out, req.logprobs_out):
        d = {repr(tok.decode_token_bytes(i))[2:-1]: lp for i, lp in lps}
        toks.append(repr(tok.decode_token_bytes(t))[2:-1])
        tlp.append(next((lp for i, lp in lps if i == t), None))
        top.append(d)
    return {"tokens": toks, "token_logprobs": tlp, "top_logprobs": top}


def _finish(reason: str | None) -> str:
    return {"eog": "stop", "stop": "stop", "length": "length",
            "context_full": "length", "cancelled": "cancelled"}.get(reason or "", "stop")


def _usage(req: GenerationRequest) -> dict:
    return {"prompt_tokens": len(req.prompt_tokens),
            "completion_tokens": len(req.tokens_out),
            "total_tokens": len(req.prompt_tokens) + len(req.tokens_out)}


def kernel_launches() -> dict[str, int]:
    """Launch counts of the port's CUDA kernels (0 on the CPU)."""
    from ..parallel.engine import launch_counts

    return launch_counts()


def serve(model: LoadedModel, engine: Engine, host: str = "127.0.0.1", port: int = 8080,
          alias: str = "prima-tpu", loras: list | None = None, spec=None,
          slot_save_dir: str | None = None, api_keys: list[str] | None = None,
          ) -> tuple[ThreadingHTTPServer, ServerContext]:
    ctx = ServerContext(model, engine, alias, loras=loras, spec=spec,
                        slot_save_dir=slot_save_dir, api_keys=api_keys)
    ctx.start()
    httpd = ThreadingHTTPServer((host, port), make_handler(ctx))
    return httpd, ctx



def serve_embeddings(rt, host: str = "127.0.0.1", port: int = 8080,
                     alias: str = "prima-tpu",
                     matmul_impl: str = "kernel") -> ThreadingHTTPServer:
    """Embedding-model server (BERT arch, models/bert.py): /v1/embeddings,
    /v1/rerank, /v1/models and /health, the reference's llama-server
    --embeddings / --reranking mode, and /props with the kernels' launch
    counts, as the decoder server gives them. Handler threads call the
    runtime directly; on the card their work shares one CUDA stream."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def _json(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                return self._json(200, {"status": "ok"})
            if self.path == "/v1/models":
                return self._json(200, {"object": "list", "data": [
                    {"id": alias, "object": "model"}]})
            if self.path == "/props":
                return self._json(200, {"kernel_launches": kernel_launches()})
            return self._json(404, {"error": "not found"})

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            body = json.loads(self.rfile.read(n) or b"{}")
            if self.path in ("/v1/rerank", "/rerank", "/v1/reranking"):
                # rank-head scoring when the model carries a classifier
                # (RANK pooling); cosine of the embeddings otherwise
                query = body.get("query", "")
                docs = list(body.get("documents") or [])
                scores = rt.rerank(query, docs, matmul_impl=matmul_impl)
                order = sorted(range(len(docs)), key=lambda i: -scores[i])
                top_n = int(body.get("top_n", len(docs)) or len(docs))
                return self._json(200, {
                    "model": alias, "object": "list",
                    "results": [{"index": i, "relevance_score": float(scores[i])}
                                for i in order[:top_n]],
                    "usage": {"prompt_tokens": 0, "total_tokens": 0},
                })
            if self.path not in ("/v1/embeddings", "/embeddings", "/embedding"):
                return self._json(404, {"error": "not found"})
            inputs = body.get("input") or body.get("content") or ""
            if isinstance(inputs, str):
                inputs = [inputs]
            vecs = rt.embed(list(inputs), matmul_impl=matmul_impl)
            data = [{"object": "embedding", "index": i,
                     "embedding": [float(x) for x in v]} for i, v in enumerate(vecs)]
            self._json(200, {"object": "list", "data": data, "model": alias,
                             "usage": {"prompt_tokens": 0, "total_tokens": 0}})

    return ThreadingHTTPServer((host, port), Handler)
