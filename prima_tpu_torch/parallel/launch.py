"""Starting the mesh: local ranks as processes, hosts through a coordinator.

Counterpart of prima_tpu/parallel/launch.py. In the JAX package every host
runs the same program and jax.distributed.initialize joins them; here each
mesh position is a process (parallel/mesh.py). A launcher (the server run
once with --pp/--tp/--dp, or a test) spawns its host's ranks itself, so a
user's command line is the JAX one. Hosts join through the environment:

  PRIMA_COORDINATOR  host:port of the rendezvous (launcher 0's host)
  PRIMA_NUM_PROCS    number of launchers (hosts)
  PRIMA_PROC_ID      this launcher's id

Launcher p runs ranks p * L .. p * L + L - 1 of a world of N * L (L ranks a
host); launcher 0's first rank is rank 0, which owns the engine. Without
the variables there is one launcher and the rendezvous is a free port on
127.0.0.1. A rank's device is cuda:(local rank mod the card count), or the
CPU when the launcher asks for it.

`RankPlan` is everything a rank needs to build itself (`build_rank`): the
mesh, where its weights come from (a GGUF, or seeded synthetic layers on
its device, or the JAX package's host draws) and the timeouts; an
engine's cache sizes reach the workers with its "init" command.
`worker_main` is a worker rank's whole life.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import socket
from dataclasses import dataclass, field

import torch

from ..models.llama import ForwardOptions


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_multihost(coordinator: str | None = None, num_processes: int | None = None,
                   process_id: int | None = None) -> tuple[str, int, int]:
    """(rendezvous address, launchers, this launcher's id) from the
    arguments or PRIMA_COORDINATOR / PRIMA_NUM_PROCS / PRIMA_PROC_ID: the
    address every rank of every host gives make_mesh (the port's
    jax.distributed.initialize)."""
    coordinator = coordinator or os.environ.get("PRIMA_COORDINATOR")
    num_processes = num_processes or int(os.environ.get("PRIMA_NUM_PROCS", "1"))
    process_id = (process_id if process_id is not None
                  else int(os.environ.get("PRIMA_PROC_ID", "0")))
    if num_processes > 1 and not coordinator:
        raise ValueError("PRIMA_NUM_PROCS > 1 needs PRIMA_COORDINATOR (host:port)")
    if not coordinator:
        coordinator = f"127.0.0.1:{free_port()}"
    return f"tcp://{coordinator}", num_processes, process_id


def is_multihost() -> bool:
    """True when more than one launcher (host) joins the mesh."""
    return int(os.environ.get("PRIMA_NUM_PROCS", "1")) > 1


@dataclass
class RankPlan:
    """What every rank of one mesh needs to build itself (picklable)."""

    shape: dict  # dp, pp, sp, tp
    init_method: str
    source: tuple  # ("gguf", path) | ("synth_seeded", cfg, ggml_type, seed)
    #                | ("synth_host", cfg, ggml_type, seed)
    k_cycles: int = 1
    microbatches: int | None = None
    opts: ForwardOptions = field(default_factory=ForwardOptions)
    device: str = "cuda"
    local_world: int | None = None  # ranks on one host (default: the world)
    n_resident: int | None = None  # layers of each window kept on the device
    timeout: float = 600.0
    ctrl_timeout: float | None = None
    rope: dict = field(default_factory=dict)  # apply_rope_overrides' arguments

    @property
    def world(self) -> int:
        s = self.shape
        return s["dp"] * s["pp"] * s["sp"] * s["tp"]


def rank_device(plan: RankPlan, rank: int) -> torch.device:
    if plan.device == "cpu":
        return torch.device("cpu")
    local = rank % (plan.local_world or plan.world)
    return torch.device("cuda", local % max(torch.cuda.device_count(), 1))


def plan_config(plan: RankPlan):
    """The model config of the plan's source (the GGUF's, with the rope
    overrides)."""
    kind = plan.source[0]
    if kind != "gguf":
        return plan.source[1]
    from ..gguf.reader import GGUFModel
    from ..models.config import ModelConfig, apply_rope_overrides

    m = GGUFModel.open(plan.source[1])
    cfg = ModelConfig.from_gguf(m)
    m.close()
    if plan.rope:
        apply_rope_overrides(cfg, **plan.rope)
    return cfg


def build_rank(plan: RankPlan, rank: int):
    """(mesh, cfg, spec, params, streamer) of one rank: joins the mesh and
    builds its windows' layers and its part of the head."""
    from .mesh import make_mesh
    from .pipeline import (PipeSpec, build_pipe_model, synth_head_seeded,
                           synth_layer_seeded)

    dev = rank_device(plan, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    s = plan.shape
    mesh = make_mesh(dp=s["dp"], pp=s["pp"], tp=s["tp"], sp=s["sp"], rank=rank, device=dev,
                     init_method=plan.init_method, local_world=plan.local_world,
                     timeout=plan.timeout, ctrl_timeout=plan.ctrl_timeout)
    cfg = plan_config(plan)
    spec = PipeSpec.for_model(cfg, n_pp=s["pp"], n_tp=s["tp"], n_dp=s["dp"],
                              k_cycles=plan.k_cycles, microbatches=plan.microbatches,
                              n_sp=s["sp"])
    kind = plan.source[0]
    if kind == "gguf":
        from ..gguf.reader import GGUFModel
        from ..models.llama import gguf_host_layer, load_params

        m = GGUFModel.open(plan.source[1])
        dtype = torch.bfloat16  # a GGUF's dense tensors as load_model loads them
        get_layer = lambda i: gguf_host_layer(m, cfg, i, dtype)
        head = load_params(m, cfg, "cpu", dtype, layer_filter=lambda i: False)
        head.pop("layers")
    elif kind == "synth_seeded":
        _, _, gt, seed = plan.source
        get_layer = lambda i: synth_layer_seeded(cfg, i, gt, seed, dev)
        head = synth_head_seeded(cfg, gt, seed, dev)
    elif kind == "synth_host":
        from ..models.llama import synth_host_head, synth_host_layer

        _, _, gt, seed = plan.source
        get_layer = lambda i: synth_host_layer(cfg, i, gt, seed)
        head = synth_host_head(cfg, gt, seed)
    else:
        raise ValueError(f"unknown weight source {kind!r}")
    streamer = None
    if plan.n_resident is None or plan.n_resident >= spec.window:
        params = build_pipe_model(get_layer, head, cfg, spec, mesh)
    else:
        from .streamed_pipe import build_streamed_pipe_model

        model = build_streamed_pipe_model(get_layer, head, cfg, spec, mesh, plan.n_resident)
        params, streamer = model.params, model.streamer
    return mesh, cfg, spec, params, streamer


def worker_main(plan: RankPlan, rank: int) -> None:
    """A worker rank: build, serve rank 0's commands until "stop", leave."""
    from .engine import PipeWorker

    torch.set_num_threads(max(1, (os.cpu_count() or 1) // (plan.local_world or plan.world)))
    mesh, cfg, spec, params, streamer = build_rank(plan, rank)
    try:
        PipeWorker(cfg, params, spec, mesh, streamer).serve()
    finally:
        mesh.close()


def spawn_ranks(target, plan: RankPlan, ranks, *args) -> list:
    """Start target(plan, rank, *args) in a fresh process for each rank
    (the spawn start method: no state of this process is inherited)."""
    ctx = mp.get_context("spawn")
    procs = []
    for r in ranks:
        p = ctx.Process(target=target, args=(plan, r, *args), daemon=True)
        p.start()
        procs.append(p)
    return procs


def stop_ranks(procs: list, timeout: float = 30.0) -> None:
    """Wait for spawned ranks, then end any that did not leave."""
    for p in procs:
        p.join(timeout)
        if p.is_alive():
            p.terminate()
            p.join(5)
