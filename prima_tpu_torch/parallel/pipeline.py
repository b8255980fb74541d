"""The piped-ring pipeline over the mesh, one rank's part of it.

Counterpart of prima_tpu/parallel/pipeline.py. There the whole schedule is
one lax.scan inside a shard_map; here every rank runs the body that
shard_map runs on one device (`_pipe_body`), with its own layers and its
own KV rows:

  reference / JAX package           this module
  -----------------------           -----------
  ring of devices, ppermute         `pp` lane, one point-to-point hop a step
  per-window layer stacks           the rank's windows: layers of
                                    windows c*n + d for c in [0, k)
  Megatron tp inside a window       row / column shards, all-reduce over tp
  dp shards of the batch            each dp replica takes B / dp rows
  final psum of the last stage      the last stage's output, moved to rank 0
                                    (or broadcast for the vocab-row head)

Schedule: at step t, rank d of the pp lane runs j = t - d, m = j mod n,
c = j div n, valid while c < k and m < M; stage 0 injects microbatch t
(its embedding); window (c*n + d) of microbatch m runs on stage d. A step
ends with one hop to (d + 1) mod n, posted only where the receiver uses it
at the next step (the JAX scan sends a value every step and masks it).
Steps n*k + M - 1.

The output head is vocab-row-sharded over every rank when the output
weight's rows divide into world * 8 (prima_tpu/parallel/pipeline.py:176):
every rank takes the hidden states, computes its slice of the logits, and
rank 0 gathers them. Otherwise rank 0 computes the head. The embedding
lives on the pp-0 ranks, the output norm everywhere.

Weights: `build_pipe_model` takes get_layer(i) -> layer i as host
UQTensors (models/llama.synth_host_layer, the JAX package's synthetic
layers), split on the host byte for byte as the JAX package splits them,
or as QTensors / tensors (a GGUF layer from models/llama.gguf_host_layer,
the seeded full-width layers of `synth_layer_seeded` on the card), split
where they are. A rank only ever builds its own windows.
"""

from __future__ import annotations

import contextlib
import dataclasses
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch

from ..gguf.constants import GGMLType
from ..models.config import ModelConfig
from ..models.llama import (ForwardOptions, forward, init_kv_caches, linear, model_norm,
                            synth_head_device, synth_layer_device)
from ..quant.device_format import UQTensor
from ..quant.qtensor import QTensor, dequant_slices
from ..runtime.streaming import STREAM_DEQUANT_WEIGHTS, map_layer
from .mesh import Mesh
from .sharding import put_shard, shard_qtensor_rows, shard_uq_rows
from .tp import shard_layer, shard_layer_uq, tp_local_config


@dataclass(frozen=True)
class PipeSpec:
    """Static layout of the piped-ring pipeline."""

    n_pp: int  # pipeline stages (ring length)
    n_tp: int  # tensor-parallel ranks per stage
    n_dp: int  # data-parallel replicas
    k_cycles: int  # ring cycles per token (the reference's k, common.cpp:1133)
    window: int  # layers per window (w)
    microbatches: int  # in-flight microbatches M (<= n_pp)
    n_sp: int = 1  # sequence-parallel shards of the KV context axis

    @property
    def n_layers(self) -> int:
        return self.n_pp * self.k_cycles * self.window

    @property
    def n_steps(self) -> int:
        return self.n_pp * self.k_cycles + self.microbatches - 1

    def window_layers(self, stage: int, cycle: int) -> range:
        v = cycle * self.n_pp + stage
        return range(v * self.window, (v + 1) * self.window)

    def owned(self, stage: int) -> list[int]:
        """Every layer of stage `stage`, cycle by cycle."""
        return [i for c in range(self.k_cycles) for i in self.window_layers(stage, c)]

    def slot(self, t: int, stage: int) -> tuple[int, int, bool]:
        """(m, c, valid) of `stage` at step t."""
        j = t - stage
        m = j % self.n_pp
        c = (j - m) // self.n_pp
        return m, c, 0 <= c < self.k_cycles and m < self.microbatches

    @staticmethod
    def for_model(cfg: ModelConfig, n_pp: int, n_tp: int = 1, n_dp: int = 1,
                  k_cycles: int | None = None, microbatches: int | None = None,
                  n_sp: int = 1) -> "PipeSpec":
        L = cfg.n_layers
        if k_cycles is None:
            k_cycles = 1
        if L % (n_pp * k_cycles):
            raise ValueError(f"L={L} not divisible by n_pp*k={n_pp * k_cycles}")
        m = microbatches if microbatches is not None else n_pp
        if m > n_pp:
            raise ValueError(f"microbatches {m} > n_pp {n_pp}")
        return PipeSpec(n_pp, n_tp, n_dp, k_cycles, L // (n_pp * k_cycles), m, n_sp)


def check_mesh(spec: PipeSpec, mesh: Mesh) -> None:
    want = {"dp": spec.n_dp, "pp": spec.n_pp, "sp": spec.n_sp, "tp": spec.n_tp}
    if mesh.shape != want:
        raise ValueError(f"mesh {mesh.shape} does not match the spec's {want}")


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _hosted(layer: dict) -> bool:
    return any(isinstance(t, UQTensor) for t in layer.values())


def shard_for_rank(layer: dict, n_tp: int, tp_i: int, device) -> dict:
    """This rank's tp shard of one layer, on its device."""
    if _hosted(layer):
        return {k: put_shard(v, device) for k, v in shard_layer_uq(layer, n_tp)[tp_i].items()}
    return map_layer(shard_layer(layer, n_tp, tp_i), lambda t: t.to(device))


def head_is_sharded(out, world: int, shard_head: bool = True) -> bool:
    """The vocab-row head rule of prima_tpu/parallel/pipeline.py:174-176."""
    return (shard_head and out is not None and isinstance(out, (UQTensor, QTensor))
            and world > 1 and out.shape[0] % (world * 8) == 0)


def build_pipe_model(get_layer: Callable[[int], dict], head: dict, cfg: ModelConfig,
                     spec: PipeSpec, mesh: Mesh, shard_head: bool = True,
                     streamed: set | None = None) -> dict:
    """This rank's params: `layers` (its windows' layers, its tp shard of
    each, None elsewhere), the embedding tables on pp-0 ranks, the output
    norm, and the head: `output_sharded` (this rank's vocab rows) or
    `output` (rank 0 only). `head` holds tok_embd / output_norm / output
    (UQTensor, array, QTensor or tensor) and any optional head tensors of
    the port's loader. Layers in `streamed` stay in host memory, packed:
    they are returned under `streamed_host` (streamed_pipe.py)."""
    check_mesh(spec, mesh)
    c, dev = mesh.coords, mesh.device
    params: dict[str, Any] = {"layers": [None] * cfg.n_layers}
    streamed_host: dict[int, dict] = {}
    for li in spec.owned(c["pp"]):
        if streamed and li in streamed:
            streamed_host[li] = shard_for_rank(get_layer(li), spec.n_tp, c["tp"], "cpu")
        else:
            params["layers"][li] = shard_for_rank(get_layer(li), spec.n_tp, c["tp"], dev)
    put = lambda t: put_shard(t, dev)
    out = head.get("output")
    if head_is_sharded(out, mesh.world, shard_head):
        params["output_sharded"] = put(
            shard_uq_rows(out, mesh.world)[mesh.rank] if isinstance(out, UQTensor)
            else shard_qtensor_rows(out, mesh.world, mesh.rank))
        params["output"] = None
    else:
        params["output"] = put(out) if mesh.rank == 0 else None
    for k, v in head.items():
        if k == "output":
            continue
        if k.startswith("output") or c["pp"] == 0:
            params[k] = None if v is None else put(v)
    if streamed_host:
        params["streamed_host"] = streamed_host
    return params


def _seeded(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


def synth_layer_seeded(cfg: ModelConfig, i: int, ggml_type: GGMLType = GGMLType.Q4_K,
                       seed: int = 0, device=None) -> dict:
    """Layer i drawn on `device` from a generator seeded by (seed, i): any
    rank makes the same layer as a one-process reference does, without the
    others (models/llama.synth_layer_device)."""
    return synth_layer_device(cfg, _seeded(seed * 1000003 + i + 1, device), ggml_type, device)


def synth_head_seeded(cfg: ModelConfig, ggml_type: GGMLType = GGMLType.Q4_K,
                      seed: int = 0, device=None) -> dict:
    """The head tensors drawn on `device` from a generator seeded by seed."""
    return synth_head_device(cfg, _seeded(seed * 1000003, device), ggml_type, device)


def synth_params_seeded(cfg: ModelConfig, ggml_type: GGMLType = GGMLType.Q4_K,
                        seed: int = 0, device=None) -> dict:
    """The whole model of `synth_layer_seeded` / `synth_head_seeded` on
    one device: the one-process reference of a seeded mesh."""
    params = synth_head_seeded(cfg, ggml_type, seed, device)
    params["layers"] = [synth_layer_seeded(cfg, i, ggml_type, seed, device)
                        for i in range(cfg.n_layers)]
    return params


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------


def init_pipe_kv(cfg: ModelConfig, spec: PipeSpec, mesh: Mesh, batch_per_micro: int,
                 max_seq: int, dtype=torch.bfloat16) -> list:
    """This rank's caches: for each layer of its windows (k, v) of
    (M * B / dp, max_seq / sp, n_kv_heads / tp, head_dim), dense or KVQ8 /
    KVQ4 ("q8_0" / "q4_0"); None for the other layers. Row m * B_loc + b
    is row b of microbatch m (the JAX layout's dp-sharded batch axis)."""
    if max_seq % spec.n_sp:
        raise ValueError(f"max_seq={max_seq} not divisible by seq shards n_sp={spec.n_sp}")
    if batch_per_micro % spec.n_dp:
        raise ValueError(f"batch_per_micro={batch_per_micro} not divisible by dp={spec.n_dp}")
    owned = set(spec.owned(mesh.coords["pp"]))
    return init_kv_caches(tp_local_config(cfg, spec.n_tp),
                          spec.microbatches * batch_per_micro // spec.n_dp,
                          max_seq // spec.n_sp, dtype, mesh.device, owned.__contains__)


# ---------------------------------------------------------------------------
# The SPMD schedule
# ---------------------------------------------------------------------------


class PipeForward:
    """The distributed forward of one rank (make_pipe_forward).

    __call__(params, tokens, positions, cache_pos, kv, mask_positions=None,
    head=True) with the SAME host arrays on every rank: tokens / positions
    / mask_positions (M, B, S) int, cache_pos (M, B) int, kv this rank's
    caches (init_pipe_kv). Returns (out, kv): on rank 0 the logits
    (M, B, S, V) in opts.logits_dtype (the hidden states (M, B, S, E) for
    return_hidden; None when head is False), None elsewhere. The caches
    are written in place. `streamer` (a ring_tcp._WindowStreamer) commits
    a window's streamed layers before the window runs."""

    def __init__(self, cfg: ModelConfig, spec: PipeSpec, mesh: Mesh,
                 opts: ForwardOptions | None = None, return_hidden: bool = False,
                 streamer=None):
        check_mesh(spec, mesh)
        opts = opts or ForwardOptions()
        self.cfg, self.spec, self.mesh = cfg, spec, mesh
        self.cfg_local = tp_local_config(cfg, spec.n_tp)
        # every option field carries over; only the parallel groups change
        self.opts = opts
        self.opts_local = dataclasses.replace(
            opts, tp_group=mesh.axis("tp") if spec.n_tp > 1 else None,
            sp_group=mesh.axis("sp") if spec.n_sp > 1 else None)
        self.return_hidden = return_hidden
        self.streamer = streamer
        self.hop_bytes = 0  # bytes this rank sent over the ring
        self.hops = 0

    def _t(self, a, dtype=torch.int32) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=self.mesh.device)

    def _needs_hop(self, stage: int, t: int) -> bool:
        """Whether `stage` takes its input from the ring at step t."""
        m, c, valid = self.spec.slot(t, stage)
        return valid and not (stage == 0 and c == 0)

    @torch.no_grad()
    def __call__(self, params: dict, tokens, positions, cache_pos, kv: list,
                 mask_positions=None, head: bool = True):
        spec, mesh = self.spec, self.mesh
        n, M = spec.n_pp, spec.microbatches
        co = mesh.coords
        d = co["pp"]
        tokens = np.asarray(tokens)
        if mask_positions is None:
            mask_positions = positions
        _, B, S = tokens.shape
        bl = B // spec.n_dp
        rows = slice(co["dp"] * bl, (co["dp"] + 1) * bl)  # this dp replica's rows
        tok = self._t(tokens[:, rows], torch.int64)
        pos = self._t(np.asarray(positions)[:, rows])
        mpos = self._t(np.asarray(mask_positions)[:, rows])
        cp = self._t(np.asarray(cache_pos)[:, rows])
        e = self.cfg.n_embd
        like = ((bl, S, e), self.opts.dtype)
        nxt, prv = mesh.rank_of(pp=(d + 1) % n), mesh.rank_of(pp=(d - 1) % n)
        out_buf: list = [None] * M
        x_in = None
        slices = (dequant_slices(STREAM_DEQUANT_WEIGHTS) if self.streamer is not None
                  else contextlib.nullcontext())
        with slices:
            for t in range(spec.n_steps):
                m, c, valid = spec.slot(t, d)
                x = None
                if valid:
                    lo = spec.window_layers(d, c)[0]
                    if self.streamer is not None:
                        self.streamer.ensure(c)
                    r0 = m * bl
                    view = [None if a is None else (a[0][r0:r0 + bl], a[1][r0:r0 + bl])
                            for a in kv]
                    inject = d == 0 and c == 0
                    x, _ = forward(params, self.cfg_local, tok[m] if inject else None, pos[m],
                                   view, cp[m], self.opts_local, return_hidden=True,
                                   mask_positions=mpos[m],
                                   layer_range=(lo, lo + spec.window),
                                   hidden_in=None if inject else x_in)
                    if d == n - 1 and c == spec.k_cycles - 1:
                        out_buf[m] = x  # the finished microbatch
                # the hop: only where the next step reads it
                send = self._needs_hop((d + 1) % n, t + 1)
                recv = self._needs_hop(d, t + 1)
                if n == 1:
                    x_in = x if recv else None
                else:
                    if send:
                        self.hop_bytes += x.numel() * x.element_size()
                        self.hops += 1
                    x_in = mesh.hop(x if send else None, nxt if send else None,
                                    prv if recv else None, like if recv else None)
        if self.streamer is not None and spec.k_cycles == 1:
            self.streamer.release()  # one window: it streams again next pass
        if not head and not self.return_hidden:
            return None, kv
        hidden = torch.stack(out_buf) if d == n - 1 else None  # (M, bl, S, E)
        if self.return_hidden:
            return self._to_rank0(hidden, (M, bl, S, e)), kv
        if params.get("output_sharded") is not None:
            return self._sharded_head(params, hidden, (M, bl, S, e)), kv
        h = self._to_rank0(hidden, (M, bl, S, e))
        if mesh.rank != 0:
            return None, kv
        from ..models.llama import lm_head

        return lm_head(params, self.cfg, h, self.opts), kv

    def _last_stage(self, dp_i: int) -> int:
        return self.mesh.rank_of(dp=dp_i, pp=self.spec.n_pp - 1, sp=0, tp=0)

    def _to_rank0(self, hidden, shape) -> torch.Tensor | None:
        """The last stage's (M, bl, S, E) of every dp replica, joined along
        the batch on rank 0."""
        mesh, parts = self.mesh, []
        for i in range(self.spec.n_dp):
            src = self._last_stage(i)
            if src == 0:
                if mesh.rank == 0:
                    parts.append(hidden)
            elif mesh.rank == src:
                mesh.hop(hidden, 0, None, None)
            elif mesh.rank == 0:
                parts.append(mesh.hop(None, None, src, (shape, self.opts.dtype)))
        return torch.cat(parts, dim=1) if mesh.rank == 0 else None

    def _sharded_head(self, params: dict, hidden, shape) -> torch.Tensor | None:
        """Every rank computes its vocab rows over all hidden states; rank 0
        gathers the slices in rank order."""
        mesh, cfg, opts = self.mesh, self.cfg, self.opts
        h = torch.cat([mesh.broadcast(hidden if mesh.rank == self._last_stage(i) else None,
                                      self._last_stage(i), shape, opts.dtype)
                       for i in range(self.spec.n_dp)], dim=1)
        x = model_norm(h, params.get("output_norm"), params.get("output_norm_b"), cfg)
        if cfg.logit_scale != 1.0:
            x = x * float(np.float32(cfg.logit_scale))
        part = linear(x, params["output_sharded"], opts.matmul_impl).to(opts.logits_dtype)
        parts = mesh.gather0(part)
        if mesh.rank != 0:
            return None
        logits = torch.cat(parts, dim=-1)
        if params.get("output_b") is not None:
            logits = logits + params["output_b"].to(logits.dtype)
        if cfg.final_logit_softcap:
            cap = float(np.float32(cfg.final_logit_softcap))
            logits = cap * torch.tanh(logits / cap)
        return logits


def make_pipe_forward(cfg: ModelConfig, spec: PipeSpec, mesh: Mesh,
                      opts: ForwardOptions | None = None, return_hidden: bool = False,
                      streamer=None) -> PipeForward:
    """The rank's distributed forward (see PipeForward)."""
    return PipeForward(cfg, spec, mesh, opts, return_hidden, streamer)
