"""Multi-host bootstrap control plane: the ZMQ-ring analogue.

A copy of prima_tpu/parallel/bootstrap.py (host-side only): the port keeps its own.

On TPU the DATA plane is XLA collectives over ICI/DCN (parallel/pipeline.py)
— but the reference's startup choreography (llama_init_sockets
src/llama.cpp:20492, llama_gather_device_info @20529,
llama_bcast_layer_setup @20649, llama_rebuild_topo @20684,
llama_free_sockets STOP propagation @20887) is host-side control traffic.
This module rebuilds it over stdlib TCP with length-prefixed JSON messages:

  RingNode        — per-rank sockets: a listening (PULL) side bound at
                    data_port + rank and a connecting (PUSH) side to the
                    next rank; the master shortcut is implicit (any rank can
                    dial rank 0 directly; TPU fabric is all-to-all, so
                    forwarder proxies are unnecessary — @1857's forwarders
                    exist only because home NATs break direct dial)
  bootstrap()     — the llama_init_from_gpt_params flow: bcast startup args
                    (ACK-barriered), all-gather device profiles, rank 0
                    solves the MILP, broadcasts the layer setup; devices
                    with no layers exit cleanly ("No layer is assigned to
                    me", common.cpp:1808)
  rebuild_topo    — drop unreachable/removed ranks and renumber rank/world
                    (@20684-20830 without the forwarder relays)
  signal STOP     — coordinated shutdown around the ring (@20887)
"""

from __future__ import annotations

import json
import socket
import struct
import time
from dataclasses import dataclass

from ..profiler.device import DeviceProfile

_LEN = struct.Struct("<I")


def _send_msg(sock: socket.socket, obj: dict) -> None:
    data = json.dumps(obj).encode()
    sock.sendall(_LEN.pack(len(data)) + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket, timeout: float | None = None) -> dict:
    sock.settimeout(timeout)
    try:
        n = _LEN.unpack(_recv_exact(sock, 4))[0]
        return json.loads(_recv_exact(sock, n))
    finally:
        sock.settimeout(None)


def is_port_open(ip: str, port: int, timeout: float = 0.5) -> bool:
    """Reachability probe (src/network-utils.cpp:8)."""
    try:
        with socket.create_connection((ip, port), timeout=timeout):
            return True
    except OSError:
        return False


def _connect_retry(ip: str, port: int, timeout: float = 20.0) -> socket.socket:
    deadline = time.time() + timeout
    while True:
        try:
            return socket.create_connection((ip, port), timeout=2.0)
        except OSError:
            if time.time() > deadline:
                raise
            time.sleep(0.1)


@dataclass
class RingConfig:
    rank: int
    world: int
    master_ip: str = "127.0.0.1"
    next_ip: str = "127.0.0.1"
    data_port: int = 9000
    # no separate signal plane: STOP rides the data connection (unlike the
    # reference's second ZMQ port, src/llama.cpp:20492)


class RingNode:
    """Per-rank control sockets (llama_init_sockets analogue)."""

    def __init__(self, cfg: RingConfig):
        self.cfg = cfg
        self.rank, self.world = cfg.rank, cfg.world
        # bind the receive side at data_port + rank (map_rank_to_port @20467)
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind(("0.0.0.0", cfg.data_port + cfg.rank))
        self.listener.listen(4)
        self.recv_sock: socket.socket | None = None
        self.send_sock: socket.socket | None = None
        self.master_sock: socket.socket | None = None

    def connect_ring(self) -> None:
        if self.world == 1:
            return
        nxt = (self.rank + 1) % self.world
        nxt_ip = self.cfg.master_ip if nxt == 0 else self.cfg.next_ip
        self.send_sock = _connect_retry(nxt_ip, self.cfg.data_port + nxt)
        self.recv_sock, _ = self.listener.accept()

    def connect_ring_robust(self, grace: float = 8.0) -> None:
        """Topology-rebuild connect (llama_rebuild_topo analogue,
        src/llama.cpp:20684-20830): the master is the rendezvous — every
        rank registers with rank 0 within a grace window; the ring is then
        built over the ranks that actually showed up, routing around dead
        hosts, and rank/world renumber densely. On a TPU-era network the
        fabric is all-to-all, so forwarder proxies (@1857, a NAT
        workaround) are unnecessary — a dead hop is simply skipped.

        After this call self.rank/self.world are the RENUMBERED values;
        the original rank is kept in self.orig_rank."""
        self.orig_rank = self.rank
        if self.world == 1:
            return
        if self.rank == 0:
            regs: dict[int, socket.socket] = {}
            deadline = time.time() + grace
            self.listener.settimeout(0.5)
            try:
                while time.time() < deadline and len(regs) < self.world - 1:
                    try:
                        conn, _ = self.listener.accept()
                    except socket.timeout:
                        continue
                    msg = _recv_msg(conn, timeout=5.0)
                    assert msg.get("tag") == "register", msg
                    regs[int(msg["rank"])] = conn
            finally:
                self.listener.settimeout(None)
            alive = sorted([0] + list(regs))
            dead = [r for r in range(self.world) if r not in alive]
            if dead:
                import sys

                print(f"rebuild_topo: routing around dead ranks {dead}",
                      file=sys.stderr)
            topo = {"tag": "topo", "alive": alive}
            for r, conn in regs.items():
                _send_msg(conn, topo)
                conn.close()
            self._apply_topo(alive)
        else:
            reg = _connect_retry(self.cfg.master_ip, self.cfg.data_port,
                                 timeout=grace + 10.0)
            _send_msg(reg, {"tag": "register", "rank": self.rank})
            topo = _recv_msg(reg, timeout=grace + 30.0)
            reg.close()
            assert topo.get("tag") == "topo", topo
            self._apply_topo(topo["alive"])

    def _apply_topo(self, alive: list[int]) -> None:
        """Renumber over the alive set and wire the data ring."""
        orig = self.orig_rank
        assert orig in alive
        idx = alive.index(orig)
        self.rank = idx
        self.world = len(alive)
        if self.world == 1:
            return
        nxt_orig = alive[(idx + 1) % len(alive)]
        nxt_ip = self.cfg.master_ip if nxt_orig == 0 else self.cfg.next_ip
        self.send_sock = _connect_retry(nxt_ip, self.cfg.data_port + nxt_orig)
        self.recv_sock, _ = self.listener.accept()

    def send_next(self, obj: dict) -> None:
        _send_msg(self.send_sock, obj)

    def recv_prev(self, timeout: float | None = None) -> dict:
        return _recv_msg(self.recv_sock, timeout)

    def close(self) -> None:
        for s in (self.send_sock, self.recv_sock, self.master_sock, self.listener):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass

    # -- collectives over the ring ------------------------------------------

    def bcast_from_master(self, obj: dict | None) -> dict:
        """Master sends, every rank forwards to the next, master receives its
        own message back as the ACK barrier (llama_bcast_startup_args)."""
        if self.world == 1:
            return obj or {}
        if self.rank == 0:
            self.send_next({"tag": "bcast", "body": obj})
            back = self.recv_prev(timeout=600)
            assert back["tag"] == "bcast"
            return obj
        msg = self.recv_prev(timeout=600)
        assert msg["tag"] == "bcast"
        self.send_next(msg)
        return msg["body"]

    def gather_to_master(self, item: dict) -> list[dict] | None:
        """Each rank appends its item as the message circulates
        (llama_gather_device_info @20529). Returns the list on rank 0."""
        if self.world == 1:
            return [item]
        if self.rank == 0:
            self.send_next({"tag": "gather", "items": [item]})
            msg = self.recv_prev(timeout=600)
            return msg["items"]
        msg = self.recv_prev(timeout=600)
        msg["items"].append(item)
        self.send_next(msg)
        return None

    def send_stop(self) -> None:
        """Propagate STOP around the ring (llama_free_sockets @20887)."""
        if self.world > 1 and self.send_sock is not None:
            try:
                self.send_next({"tag": "stop", "from": self.rank})
            except OSError:
                pass

    def forward_stop_once(self) -> bool:
        """Workers: wait for a STOP and relay it (main.cpp:557 signal thread)."""
        try:
            msg = self.recv_prev(timeout=None)
        except (ConnectionError, OSError):
            return False
        if msg.get("tag") == "stop":
            if (self.rank + 1) % self.world != msg.get("from", 0):
                try:
                    self.send_next(msg)
                except OSError:
                    pass
            return True
        return False


@dataclass
class BootstrapResult:
    rank: int
    world: int
    w: list[int]
    n: list[int]
    k: int
    removed: list[int]
    is_active: bool

    @property
    def my_window(self) -> int:
        return self.w[self.rank]


def bootstrap(node: RingNode, profile: DeviceProfile, cost,
              n_ctx: int = 4096, master_priority: float = 1.01,
              force_k: int | None = None,
              manual_w: list[int] | None = None) -> BootstrapResult:
    """The distributed init flow (common/common.cpp:1663-2003).

    Manual mode (-lw, README FAQ #1): pass manual_w to skip profiling+solver.
    After the solve, ranks with w == 0 are 'removed': they get is_active
    False and should exit; remaining ranks renumber rank/world densely
    (@1816-1855).
    """
    # 1. startup-args broadcast + barrier
    args = node.bcast_from_master(
        {"n_ctx": n_ctx, "master_priority": master_priority, "force_k": force_k,
         "manual_w": manual_w} if node.rank == 0 else None
    )

    # 2. device-info all-gather
    gathered = node.gather_to_master(profile.to_dict())

    # 3. master solves, broadcasts the layer setup
    if node.rank == 0:
        if args.get("manual_w"):
            w = list(args["manual_w"])
            n = list(w)
            k = args.get("force_k") or 1
        else:
            from ..sched import assign_layers_and_select_devices

            profiles = [DeviceProfile.from_dict(d) for d in gathered]
            res = assign_layers_and_select_devices(
                profiles, cost, n_ctx=args["n_ctx"],
                master_priority=args["master_priority"], force_k=args.get("force_k"),
            )
            w, n, k = res.w, res.n, res.k
        setup = {"w": w, "n": n, "k": k}
        node.bcast_from_master(setup)
    else:
        setup = node.bcast_from_master(None)
        w, n, k = setup["w"], setup["n"], setup["k"]

    removed = [i for i, wi in enumerate(w) if wi == 0]
    # dense renumbering of surviving ranks (@1816-1855)
    active = [i for i in range(node.world) if w[i] > 0]
    is_active = node.rank in active
    new_rank = active.index(node.rank) if is_active else -1
    return BootstrapResult(
        rank=new_rank if is_active else node.rank,
        world=len(active),
        w=[w[i] for i in active],
        n=[n[i] for i in active],
        k=k,
        removed=removed,
        is_active=is_active,
    )
