"""Device-memory read probe: what rate does this card stream at right now?

    python -m prima_tpu_torch.utils.hbm_probe          # 1 GiB, prints GB/s

Counterpart of the JAX package's HBM probes (tools/probe_hbm.py and
bench.py's raw probe). It is on no serving path: a bench or a smoke run
sets a kernel's rate beside it.

Kernel note. `read_sum` launches utils/cuda/hbm_probe.cu, which replaces
the TPU probes' _stream_kernel. It is bound by device-memory bytes by
construction (one integer add per 4 bytes). Its design: 8 blocks per SM,
16-byte grid-stride loads four deep, int64 sums, one integer atomic per
block, so the sum is exact and the same on every run; the plain version is
`x.view(torch.int32).sum()`.
"""

from __future__ import annotations

import ctypes
import json
import sys

import torch

from . import nvcc

SOURCE = "utils/cuda/hbm_probe.cu"
launches = nvcc.LaunchCounter("hbm_probe")
NOMINAL_GBS = 3350.0  # H100 SXM data sheet


def read_sum_plain(x: torch.Tensor) -> torch.Tensor:
    """The sum of x's bytes taken as int32 words, an int64 scalar."""
    return x.view(torch.int32).sum()


def _lib():
    fn = nvcc.load(SOURCE).prima_hbm_read_sum
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def read_sum(x: torch.Tensor) -> torch.Tensor:
    """Stream x once and return the int64 sum of its int32 words. A CUDA
    tensor launches the kernel (or raises); a CPU tensor takes
    `read_sum_plain`."""
    if x.device.type == "cpu":
        return read_sum_plain(x)
    nbytes = x.numel() * x.element_size()
    if not x.is_contiguous() or nbytes % 16 or x.data_ptr() % 16:
        raise ValueError("hbm_probe: x must be contiguous, 16-byte aligned and a "
                         "multiple of 16 bytes long")
    out = torch.zeros((), dtype=torch.int64, device=x.device)
    blocks = 8 * torch.cuda.get_device_properties(x.device).multi_processor_count
    rc = _lib()(x.data_ptr(), nbytes // 16, out.data_ptr(), blocks,
                torch.cuda.current_stream(x.device).cuda_stream)
    nvcc.check(rc, "hbm_probe launch")
    launches.count += 1
    return out


def measure(device="cuda", nbytes: int = 1 << 30, reps: int = 10, per_rep: int = 4,
            seed: int = 0) -> dict:
    """Read `nbytes` of seeded int32 words with the probe kernel, after one
    warm-up read, in `reps` CUDA-event windows of `per_rep` reads each (so
    that the host's launch latency is paid once a window, not once a read);
    check the sum against the plain version. Returns the median and best
    rate in GB/s."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError("hbm_probe.measure times the card: it needs a CUDA device")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x = torch.randint(-2 ** 31, 2 ** 31 - 1, (nbytes // 4,), dtype=torch.int32,
                      device=device, generator=gen)
    got = read_sum(x)
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per_rep):
            got = read_sum(x)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_rep)
    want = read_sum_plain(x)
    times.sort()
    gbs = lambda ms: x.numel() * 4 / ms / 1e6
    return {"bytes": x.numel() * 4, "reps": reps, "reads_per_rep": per_rep,
            "exact": bool(got == want), "median_ms": times[len(times) // 2],
            "median_gbs": gbs(times[len(times) // 2]), "best_gbs": gbs(times[0]),
            "nominal_gbs": NOMINAL_GBS, "device": torch.cuda.get_device_name(device)}


def main() -> int:
    if not torch.cuda.is_available():
        print("hbm_probe: no CUDA device", file=sys.stderr)
        return 1
    r = measure()
    print(json.dumps(r))
    return 0 if r["exact"] else 1


if __name__ == "__main__":
    sys.exit(main())
