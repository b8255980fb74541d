"""Heterogeneity-aware layer-window assignment via mixed-integer LP.

A copy of prima_tpu/sched/milp.py (host-side only): the port keeps its own.

The faithful translation of the reference scheduler's MODEL
(assign_layers_to_device, common/common.cpp:860-1593) to TPU terms, solved
with scipy.optimize.milp — which drives HiGHS, the same solver the
reference links (USE_HIGHS=1).

Decision variables per device m:
  w[m] — layer-window size (layers this device computes per ring cycle)
  n[m] — HBM-RESIDENT layers of that window (the TPU translation of the
         reference's "GPU layers": resident layers read at HBM bandwidth,
         the remaining w[m]-n[m] layers stream host RAM -> HBM per visit —
         the analogue of mmap'd CPU layers vs VRAM layers)

With k ring cycles, L = k * W where W = sum(w). Objective (per token):

  minimize  k * sum_m( a[m]*w[m] + b[m]*n[m] + xi[m] ) + kappa

  a[m]  = per-layer latency when streamed  (slow path)
  b[m]  = resident-minus-streamed delta    (negative: resident is faster)
  xi[m] = per-hop activation latency       (ICI/DCN; reference sets ~0)
  kappa = head cost on the master (embedding + output) — master cost is
          scaled by 1/master_priority (common.cpp:1280)

Constraints: sum(w) = L/k; 0 <= n[m] <= w[m]; HBM capacity rows
(n[m]*layer_bytes + kv + compute-buf <= hbm_free); host-RAM capacity rows
(w[m]*layer_bytes <= usable host memory, device-class dependent).

Device classes (the M1-M4 analogue, @1056-1103) re-derive per iteration:
  FIT   — whole window fits in HBM             (reference M4 "enough mem")
  STREAM— window fits in host RAM, streams     (M3/M1: RAM-tight)
  DISK  — window exceeds host RAM: streamed from disk at disk_seq_bw (M1/M3
          disk-latency term, @1191-1205)

The outer fixed-point loop re-derives classes from the solution and
re-solves until stable (@1129-1510); assign_layers_and_select_devices drops
"weak" devices (w==1, n==0) and re-solves with survivors (@1595-1657).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..profiler.device import DeviceProfile
from ..profiler.model_cost import ModelCost


@dataclass
class ScheduleResult:
    w: list[int]  # per-device window size (0 = removed)
    n: list[int]  # per-device HBM-resident layers
    k: int  # ring cycles
    objective: float  # estimated seconds/token
    device_class: list[str] = field(default_factory=list)
    iterations: int = 0

    @property
    def active_devices(self) -> list[int]:
        return [i for i, wi in enumerate(self.w) if wi > 0]


class InfeasibleError(RuntimeError):
    pass


def _divisors(n: int) -> list[int]:
    return [d for d in range(1, n + 1) if n % d == 0]


def _disk_bw(profile: DeviceProfile) -> float:
    """Linux page cache reads the mmap sequentially; macOS reads randomly
    (reference common.cpp:1030-1040 seq-vs-rand distinction)."""
    if profile.os and profile.os != "Linux" and profile.disk_rand_bw > 0:
        return profile.disk_rand_bw
    return profile.disk_seq_bw


def _device_class(profile: DeviceProfile, cost: ModelCost, w: int,
                  n_ctx: int, forced_fit: bool = False) -> str:
    if forced_fit:
        # the M4-force re-iteration (@1476-1496): treat as memory-adequate
        # regardless of the condition checks (streaming over-commits)
        return "FIT"
    need = w * cost.layer_bytes + w * cost.kv_bytes_per_layer(n_ctx)
    hbm_budget = profile.hbm_free * 0.9 - cost.compute_buf_bytes(n_ctx)
    if need <= hbm_budget:
        return "FIT"
    if w * cost.layer_bytes <= profile.host_ram_avail * 0.8:
        return "STREAM"
    return "DISK"


def _coeffs(profile: DeviceProfile, cost: ModelCost, klass: str, n_ctx: int):
    """(a, b) per-layer latency coefficients for one device."""
    t_resident = cost.layer_seconds(profile)
    t_stream = max(cost.layer_stream_seconds(profile), t_resident)
    dbw = _disk_bw(profile)
    if klass == "DISK" and dbw > 0:
        t_slow = max(cost.layer_bytes / (dbw * 1e9), t_stream)
    else:
        t_slow = t_stream
    t_slow = min(t_slow, 1e6)  # keep the MILP finite on broken devices
    # kv access adds an HBM-bound term per layer
    if profile.hbm_bw > 0:
        t_kv = cost.kv_bytes_per_layer(n_ctx) / (profile.hbm_bw * 1e9)
        t_resident += t_kv
        t_slow += t_kv
    return t_slow, t_resident - t_slow  # a >= 0, b <= 0


def _solve_fixed_k(
    profiles: list[DeviceProfile],
    cost: ModelCost,
    k: int,
    n_ctx: int,
    classes: list[str],
    master_priority: float,
    xi: list[float],
    forced_fit: set[int] = frozenset(),
    head_parallel: int = 1,
) -> tuple[np.ndarray, np.ndarray, float]:
    """One MILP solve for a fixed cycle count k. Returns (w, n, objective)."""
    from scipy.optimize import Bounds, LinearConstraint, milp

    M = len(profiles)
    L = cost.n_layers
    if L % k:
        raise InfeasibleError(f"L={L} not divisible by k={k}")
    W = L // k

    a = np.zeros(M)
    b = np.zeros(M)
    for m, p in enumerate(profiles):
        a[m], b[m] = _coeffs(p, cost, classes[m], n_ctx)
    # master priority: scale rank-0's cost down so work prefers the master
    a[0] /= master_priority
    b[0] /= master_priority

    # x = [w_0..w_{M-1}, n_0..n_{M-1}]
    c = np.concatenate([k * a, k * b])

    constraints = []
    # sum(w) == W
    row = np.concatenate([np.ones(M), np.zeros(M)])
    constraints.append(LinearConstraint(row, W, W))
    for m, p in enumerate(profiles):
        # n[m] <= w[m]
        row = np.zeros(2 * M)
        row[m], row[M + m] = -1.0, 1.0
        constraints.append(LinearConstraint(row, -np.inf, 0.0))
        # HBM capacity: all k windows are resident simultaneously
        # (k*n resident layers + KV of all k*w local layers), matching the
        # reference's per-window GPU split (src/llama.cpp:7597)
        row = np.zeros(2 * M)
        row[M + m] = cost.layer_bytes * k
        row[m] = cost.kv_bytes_per_layer(n_ctx) * k
        hbm_budget = max(p.hbm_free * 0.9 - cost.compute_buf_bytes(n_ctx), 0.0)
        constraints.append(LinearConstraint(row, -np.inf, hbm_budget))
        # host-memory capacity: w*layer_bytes*k <= host budget (whole share
        # of the model must live somewhere reachable); forced-FIT devices
        # over-commit via streaming (the M4-force analogue)
        if classes[m] != "DISK" and m not in forced_fit:
            row = np.zeros(2 * M)
            row[m] = cost.layer_bytes * k
            budget = p.host_ram_avail * 0.8 + max(p.hbm_free * 0.9, 0.0)
            constraints.append(LinearConstraint(row, -np.inf, budget))

    # w >= 1 for every participating device (reference col_lower_, @1284;
    # device *removal* is the weak-device loop's job, not the solver's)
    bounds = Bounds(np.concatenate([np.ones(M), np.zeros(M)]),
                    np.concatenate([np.full(M, W), np.full(M, W)]))
    res = milp(
        c=c,
        constraints=constraints,
        bounds=bounds,
        integrality=np.ones(2 * M),
    )
    if res.status != 0 or res.x is None:
        raise InfeasibleError(f"k={k}: {res.message}")
    x = np.round(res.x).astype(int)
    w, n = x[:M], x[M:]
    obj = float(res.fun) + k * float(sum(xi)) + _head_cost(
        profiles[0], cost, master_priority, head_parallel)
    return w, n, obj


def _head_cost(master: DeviceProfile, cost: ModelCost, master_priority: float,
               head_parallel: int = 1) -> float:
    """kappa: embedding + output-head latency. The TCP ring keeps the head
    on rank 0 (reference behavior); the mesh pipeline vocab-shards it
    across head_parallel devices (parallel/pipeline.py shard_head), so the
    per-token cost divides."""
    return cost.head_seconds(master) / master_priority / max(head_parallel, 1)


def assign_layers(
    profiles: list[DeviceProfile],
    cost: ModelCost,
    n_ctx: int = 4096,
    master_priority: float = 1.01,
    force_k: int | None = None,
    max_k: int | None = None,
    head_parallel: int = 1,
) -> ScheduleResult:
    """assign_layers_to_device analogue: per-k MILP + class fixed point +
    the forced-FIT overload re-iteration (@1476-1496). head_parallel > 1
    models the mesh pipeline's vocab-sharded output head."""
    M = len(profiles)
    L = cost.n_layers
    # per-hop comm term xi[m]: the measured activation-transfer cost of the
    # hop LEAVING device m (the reference's device-to-device copy delay,
    # common/profiler.cpp:1216). act_bytes = one f32 hidden row; the wire
    # plane (TCP ring) dominates the mesh plane whenever it is present.
    act_bytes = max(cost.n_embd, 1) * 4

    def _hop_cost(p) -> float:
        if p.tcp_hop_gbs > 0:
            return act_bytes / (p.tcp_hop_gbs * 1e9) + p.tcp_hop_lat_s
        if p.ici_hop_gbs > 0:
            return act_bytes / (p.ici_hop_gbs * 1e9) + p.ici_hop_lat_s
        return p.dispatch_latency_s  # unmeasured: dispatch-latency proxy

    xi = [_hop_cost(p) for p in profiles]

    if force_k:
        ks = [force_k]
    else:
        # all divisors of L up to L/2 (reference find_factors, @1043-1050),
        # optionally capped for tests
        cap = max_k if max_k is not None else max(L // 2, 1)
        ks = [d for d in _divisors(L) if d <= cap]
    best: ScheduleResult | None = None
    for k in ks:
        W = L // k
        if W < M:
            continue  # w >= 1 per device is unsatisfiable
        # initial classes from an even split
        w_guess = [W // M + (1 if i < W % M else 0) for i in range(M)]
        # classes condition on the TOTAL layers a device owns across the k
        # cycles (k*w), matching the capacity rows in _solve_fixed_k
        forced_fit: set[int] = set()
        classes = [_device_class(p, cost, k * max(w_guess[i], 1), n_ctx)
                   for i, p in enumerate(profiles)]
        it = 0
        last = None
        while True:
            it += 1
            try:
                w, n, obj = _solve_fixed_k(profiles, cost, k, n_ctx, classes,
                                           master_priority, xi, forced_fit,
                                           head_parallel)
            except InfeasibleError:
                if last is None:
                    w = None
                else:  # rollback to the last feasible iterate (@1428-1443)
                    w, n, obj = last
                break
            last = (w, n, obj)
            new_classes = [
                _device_class(p, cost, k * max(int(w[i]), 1), n_ctx,
                              forced_fit=i in forced_fit)
                for i, p in enumerate(profiles)]
            if new_classes == classes or it >= 8:
                # overload re-iteration (@1476-1496): if some device still
                # has free HBM while another is stuck streaming from disk,
                # force the slowest-disk device into FIT and re-solve
                if it < 8:
                    # reference precondition (@1476): only force when no
                    # weak device exists (weak removal takes precedence)
                    has_weak = any(int(w[i]) <= 1 and int(n[i]) == 0
                                   for i in range(1, M))
                    overload = [] if has_weak else [
                        i for i, c in enumerate(new_classes)
                        if c == "DISK" and i not in forced_fit]
                    free_hbm = any(
                        profiles[i].hbm_free * 0.9
                        - k * int(n[i]) * cost.layer_bytes
                        > cost.layer_bytes
                        for i in range(M))
                    if overload and free_hbm:
                        worst = min(overload,
                                    key=lambda i: _disk_bw(profiles[i]))
                        forced_fit.add(worst)
                        classes = [
                            _device_class(p, cost, k * max(int(w[i]), 1),
                                          n_ctx, forced_fit=i in forced_fit)
                            for i, p in enumerate(profiles)]
                        continue
                break
            classes = new_classes
        if w is None:
            continue
        if best is None or obj < best.objective:
            best = ScheduleResult(list(map(int, w)), list(map(int, n)), k, obj,
                                  classes, it)
    if best is None:
        raise InfeasibleError("no feasible (k, w, n) assignment")
    return best


def assign_layers_and_select_devices(
    profiles: list[DeviceProfile],
    cost: ModelCost,
    n_ctx: int = 4096,
    master_priority: float = 1.01,
    force_k: int | None = None,
) -> ScheduleResult:
    """Drop weak devices (w<=1 and n==0, @1451-1455) and re-solve with the
    survivors until stable; scatter windows back with zeros for removed
    devices (@1621-1631). The master (index 0) is never removed."""
    idx = list(range(len(profiles)))
    while True:
        sub = [profiles[i] for i in idx]
        res = assign_layers(sub, cost, n_ctx, master_priority, force_k)
        weak = [idx[j] for j in range(len(idx))
                if res.w[j] <= 1 and res.n[j] == 0 and idx[j] != 0 and len(idx) > 1]
        if not weak:
            w = [0] * len(profiles)
            n = [0] * len(profiles)
            classes = ["REMOVED"] * len(profiles)
            for j, i in enumerate(idx):
                w[i], n[i] = res.w[j], res.n[j]
                classes[i] = res.device_class[j]
            return ScheduleResult(w, n, res.k, res.objective, classes, res.iterations)
        idx = [i for i in idx if i not in weak]
