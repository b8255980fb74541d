"""Device profiler: micro-benchmarks of one device and its host.

Counterpart of prima_tpu/profiler/device.py (the reference's device
profiler, common/profiler.cpp):

  reference metric                 here
  ----------------                 ----
  per-dtype matmul FLOPS           torch.matmul chains in bf16 and f32
  quantized vec_dot                the Q4_K GEMV kernel (`qgemv`)
  VRAM bandwidth                   the device-memory read probe (`hbm_probe`)
  mem copy delay                   host -> device copies, pinned and pageable
  RAM bandwidth, disk, memory      numpy copy, direct reads, /proc + cgroup
  device-to-device copy delay      the loopback TCP hop of the ring

Device times are CUDA-event windows after a warm-up run (the host time
with a synchronize on the CPU). The f32 matmul is measured with TF32 off
(`torch.backends.cuda.matmul.allow_tf32 = False` for the bench, restored
after), so it is the card's f32 rate. `h2d_bw` keeps the pinned rate,
the one the streamed layers get (runtime/streaming.py pins them);
`_bench_h2d(device, pin=False)` gives the pageable rate beside it.
Serialization (to_dict / from_dict) uses the JAX package's fields and
format, so a profile crosses the ring between the two packages.
"""

from __future__ import annotations

import os
import time
from dataclasses import asdict, dataclass

import numpy as np
import torch

from .. import resolve_device


@dataclass
class DeviceProfile:
    hostname: str = ""
    platform: str = ""  # cuda | cpu (the JAX package: tpu | cpu | ...)
    os: str = ""  # Linux | Darwin | ... (device_os, reference profiler.h)
    device_kind: str = ""
    n_devices: int = 1
    # compute (TFLOPS per matmul dtype-path)
    flops_bf16: float = 0.0
    flops_f32: float = 0.0
    flops_q4k_dequant: float = 0.0  # the fused dequant-GEMV path
    # bandwidths (GB/s)
    hbm_bw: float = 0.0
    h2d_bw: float = 0.0
    host_ram_bw: float = 0.0
    disk_seq_bw: float = 0.0
    disk_rand_bw: float = 0.0
    ici_bw: float = 0.0  # inter-chip (0 on one device)
    # interconnect hop characteristics feeding the scheduler's comm term
    # (common/profiler.cpp:1216)
    ici_hop_gbs: float = 0.0  # device-to-device neighbour exchange
    ici_hop_lat_s: float = 0.0
    tcp_hop_gbs: float = 0.0  # wire-plane (ring_tcp) hop bandwidth
    tcp_hop_lat_s: float = 0.0  # wire-plane per-hop latency
    # memory (bytes)
    hbm_total: int = 0
    hbm_free: int = 0
    host_ram_total: int = 0
    host_ram_avail: int = 0
    host_swap_total: int = 0
    # latency
    dispatch_latency_s: float = 0.0

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: dict) -> "DeviceProfile":
        return cls(**{k: v for k, v in d.items() if k in cls.__dataclass_fields__})


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _time(fn, device: torch.device, reps: int = 3) -> float:
    """Best seconds of fn() over `reps` runs after a warm-up: CUDA events
    on the card, the host clock on the CPU."""
    fn()
    _sync(device)
    best = float("inf")
    for _ in range(reps):
        if device.type == "cuda":
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            dt = a.elapsed_time(b) / 1e3
        else:
            t0 = time.perf_counter()
            fn()
            dt = time.perf_counter() - t0
        best = min(best, dt)
    return best


def _bench_matmul_flops(dtype, device: torch.device, n: int = 4096, inner: int = 8) -> float:
    """TFLOPS of a chain of `inner` n x n matmuls (the device_flops
    analogue, profiler.cpp:165)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(0)
    a = torch.randn((n, n), generator=gen, device=device).to(dtype)
    b = torch.randn((n, n), generator=gen, device=device).to(dtype)

    def chain():
        x = a
        for _ in range(inner):
            x = torch.matmul(x, b) * 1e-3
        return x

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dt = _time(chain, device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    return 2.0 * n * n * n * inner / dt / 1e12


def _bench_qmm_flops(device: torch.device, n: int = 4096, k: int = 4096,
                     inner: int = 8) -> float:
    """The fused dequant-GEMV path on a Q4_K tensor (the Q4_K vec_dot
    analogue): `qgemv` on the card, its plain version on the CPU."""
    from ..gguf.constants import GGMLType
    from ..models.llama import synth_qtensor_device
    from ..quant.qmatmul import qgemv

    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    qt = synth_qtensor_device(gen, n, k, GGMLType.Q4_K, device)
    x0 = torch.ones((1, k), dtype=torch.float32, device=device)

    def chain():
        x = x0
        for _ in range(inner):
            x = qgemv(x, qt)[:, :k] * 1e-3
        return x

    return 2.0 * n * k * inner / _time(chain, device) / 1e12


def _bench_hbm_bw(device: torch.device, mb: int = 256) -> float:
    """Device-memory read rate (GB/s): the `hbm_probe` kernel on the card
    (the figure the kernels' byte bounds use), its plain version on the
    CPU."""
    from ..utils import hbm_probe

    if device.type == "cuda":
        return hbm_probe.measure(device, nbytes=mb << 20, reps=5)["median_gbs"]
    x = torch.ones(mb << 18, dtype=torch.int32)
    return mb / 1024 / _time(lambda: hbm_probe.read_sum(x), device)


def _bench_h2d(device: torch.device, mb: int = 64, pin: bool = True) -> float:
    """Host -> device copy rate (GB/s) from pinned or pageable memory — the
    mem-copy-delay analogue."""
    if device.type != "cuda":
        return _bench_host_ram_bw(mb) / 2  # a copy within host memory
    x = torch.ones(mb << 20, dtype=torch.uint8)
    if pin:
        x = x.pin_memory()
    return mb / 1024 / _time(lambda: x.to(device, non_blocking=pin), device)


def _bench_host_ram_bw(mb: int = 512) -> float:
    a = np.ones(mb * 1024 * 1024 // 8, dtype=np.float64)
    t0 = time.perf_counter()
    b = a.copy()
    dt = time.perf_counter() - t0
    del b
    return 2 * mb / 1024 / dt  # read + write


def _bench_disk(path: str = None, mb: int = 64) -> tuple[float, float]:
    """Sequential and random read bandwidth (GB/s) — replaces the external
    fio dependency (profiler.cpp:927) with direct reads."""
    import tempfile

    path = path or tempfile.gettempdir()
    fname = os.path.join(path, f".prima_disk_bench_{os.getpid()}")
    data = np.random.default_rng(0).integers(0, 255, mb * 1024 * 1024, dtype=np.uint8)
    try:
        with open(fname, "wb") as f:
            f.write(data.tobytes())
            f.flush()
            os.fsync(f.fileno())
        t0 = time.perf_counter()
        with open(fname, "rb") as f:
            while f.read(1 << 20):
                pass
        seq = mb / 1024 / (time.perf_counter() - t0)
        n_reads = 512  # random 4K reads
        rng = np.random.default_rng(1)
        offsets = rng.integers(0, mb * 1024 * 1024 - 4096, n_reads)
        t0 = time.perf_counter()
        with open(fname, "rb") as f:
            for off in offsets:
                f.seek(int(off))
                f.read(4096)
        rand = n_reads * 4096 / 1024**3 / (time.perf_counter() - t0)
        return seq, rand
    finally:
        try:
            os.unlink(fname)
        except OSError:
            pass


def _bench_tcp_hop(payload_mb: int = 8) -> tuple[float, float]:
    """Loopback TCP hop bench for the wire plane (ring_tcp): (GB/s, lat_s).
    Loopback is the upper bound of the local NIC path."""
    import socket
    import threading

    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    got = {}

    def serve():
        conn, _ = srv.accept()
        conn.settimeout(10)
        total = 0
        while True:
            b = conn.recv(1 << 20)
            if not b:
                break
            total += len(b)
            if b[-1:] == b"\x01":  # echo marker for latency pings
                conn.sendall(b"\x01")
        got["total"] = total
        conn.close()

    th = threading.Thread(target=serve, daemon=True)
    th.start()
    cli = socket.create_connection(("127.0.0.1", port), timeout=10)
    cli.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    lats = []  # latency: 16 x 1-byte ping-pong
    for _ in range(16):
        t0 = time.perf_counter()
        cli.sendall(b"\x01")
        if cli.recv(1) != b"\x01":
            raise ConnectionError("tcp hop bench: bad echo")
        lats.append(time.perf_counter() - t0)
    lat = sorted(lats)[len(lats) // 2] / 2  # one-way
    payload = b"\x00" * (payload_mb * 2**20)  # bandwidth: one streamed payload
    t0 = time.perf_counter()
    cli.sendall(payload)
    cli.shutdown(socket.SHUT_WR)
    th.join(timeout=10)
    dt = time.perf_counter() - t0
    cli.close()
    srv.close()
    return len(payload) / dt / 1e9, lat


def _mem_info() -> dict:
    """Host memory and swap, cgroup-aware like the reference's Docker
    handling (profiler.cpp:459-683)."""
    info = {"host_ram_total": 0, "host_ram_avail": 0, "host_swap_total": 0}
    try:
        with open("/proc/meminfo") as f:
            mem = {}
            for line in f:
                parts = line.split()
                mem[parts[0].rstrip(":")] = int(parts[1]) * 1024
        info["host_ram_total"] = mem.get("MemTotal", 0)
        info["host_ram_avail"] = mem.get("MemAvailable", 0)
        info["host_swap_total"] = mem.get("SwapTotal", 0)
    except OSError:
        pass
    for limf in ("/sys/fs/cgroup/memory.max", "/sys/fs/cgroup/memory/memory.limit_in_bytes"):
        try:
            with open(limf) as f:
                v = f.read().strip()
            if v.isdigit() and int(v) < info["host_ram_total"]:
                info["host_ram_total"] = int(v)
        except OSError:
            continue
    return info


def profile_device(device=None, full: bool = True, bench_disk: bool = True) -> DeviceProfile:
    """Run the micro-benchmarks on `device` (CUDA unless told otherwise;
    the llama_profile_device analogue, src/llama.cpp:3621). On the CPU the
    benches run at the JAX package's small sizes."""
    import platform as _platform
    import socket

    device = resolve_device(device)
    cuda = device.type == "cuda"
    p = DeviceProfile(
        hostname=socket.gethostname(),
        platform=device.type,
        os=_platform.system(),
        device_kind=torch.cuda.get_device_name(device) if cuda else _platform.processor(),
        n_devices=torch.cuda.device_count() if cuda else 1,
    )
    mi = _mem_info()
    p.host_ram_total = mi["host_ram_total"]
    p.host_ram_avail = mi["host_ram_avail"]
    p.host_swap_total = mi["host_swap_total"]
    if cuda:
        p.hbm_free, p.hbm_total = torch.cuda.mem_get_info(device)
    else:  # the host's memory is the device's
        p.hbm_total = max(int(p.host_ram_avail / 2**30), 1) * 2**30
        p.hbm_free = int(p.hbm_total * 0.95)

    n = 4096 if cuda else 1024
    p.flops_bf16 = _bench_matmul_flops(torch.bfloat16, device, n)
    p.flops_f32 = _bench_matmul_flops(torch.float32, device, n)
    if full:
        p.flops_q4k_dequant = _bench_qmm_flops(device, *((4096, 4096) if cuda
                                                         else (2048, 2048)))
        p.hbm_bw = _bench_hbm_bw(device, 256 if cuda else 64)
        p.h2d_bw = _bench_h2d(device, 64 if cuda else 16, pin=True)
        p.host_ram_bw = _bench_host_ram_bw()
        if bench_disk:
            p.disk_seq_bw, p.disk_rand_bw = _bench_disk()
        one = torch.zeros((), device=device)  # dispatch latency: a tiny op's round trip
        float(one + 1)
        t0 = time.perf_counter()
        for _ in range(5):
            float(one + 1)
        p.dispatch_latency_s = (time.perf_counter() - t0) / 5
        # one device: no neighbour to exchange with (prima_tpu/profiler/device.py:220-221)
        p.ici_hop_gbs = p.ici_hop_lat_s = 0.0
        p.tcp_hop_gbs, p.tcp_hop_lat_s = _bench_tcp_hop()
    return p


def print_device_props(p: DeviceProfile) -> str:
    """The device_print_props capability table (profiler.cpp:1712)."""
    rows = [
        ("host", p.hostname),
        ("platform", f"{p.platform} ({p.device_kind}) x{p.n_devices}"),
        ("matmul bf16", f"{p.flops_bf16:8.2f} TFLOPS"),
        ("matmul f32", f"{p.flops_f32:8.2f} TFLOPS"),
        ("dequant q4_k", f"{p.flops_q4k_dequant:8.2f} TFLOPS"),
        ("device mem bandwidth", f"{p.hbm_bw:8.1f} GB/s"),
        ("host->device", f"{p.h2d_bw:8.2f} GB/s"),
        ("host RAM bw", f"{p.host_ram_bw:8.1f} GB/s"),
        ("disk seq / rand", f"{p.disk_seq_bw:6.2f} / {p.disk_rand_bw:.3f} GB/s"),
        ("device mem total/free", f"{p.hbm_total / 2**30:6.1f} / {p.hbm_free / 2**30:.1f} GiB"),
        ("host RAM total/avail", f"{p.host_ram_total / 2**30:6.1f} / "
                                 f"{p.host_ram_avail / 2**30:.1f} GiB"),
        ("swap", f"{p.host_swap_total / 2**30:6.1f} GiB"),
        ("dispatch latency", f"{p.dispatch_latency_s * 1e3:8.2f} ms"),
        ("ICI hop bw/lat", f"{p.ici_hop_gbs:6.2f} GB/s / {p.ici_hop_lat_s * 1e6:.0f} us"),
        ("TCP hop bw/lat", f"{p.tcp_hop_gbs:6.2f} GB/s / {p.tcp_hop_lat_s * 1e6:.0f} us"),
    ]
    w = max(len(k) for k, _ in rows)
    return "\n".join(f"| {k:<{w}} | {v} |" for k, v in rows)
