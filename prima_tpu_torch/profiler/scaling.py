"""Multi-chip scaling-efficiency projection (BASELINE >=80% target).

A copy of prima_tpu/profiler/scaling.py (host-side only): the port keeps its own.

Only one physical chip is reachable in this environment, so the honest
substitute for the reference's measured 4-device cluster table
(the reference's README.md:37-61) is an analytical model with every input
measured where possible:

  * t1_s         — measured single-chip per-token decode time (bench.py)
  * hop profiles — measured ppermute / TCP hop cost (profiler/device.py
                   _bench_ici_hop / _bench_tcp_hop) or the chip's nominal
                   ICI spec when only one chip exists
  * act_bytes    — activation bytes crossing each pipeline hop
                   (n_embd * bytes/elt * batch, §2.5 of SURVEY)

The formulas are deliberately simple and stated inline; the CPU-mesh
per-stage wall-time breakdown (experiments/multichip_r5.py) validates the
schedule SHAPE of the actual compiled pipeline program, while this module
turns measured rates into projected multi-chip throughput.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass


@dataclass
class HopProfile:
    """One interconnect hop: fixed latency + bandwidth."""

    gbs: float
    lat_s: float
    name: str = ""

    def seconds(self, nbytes: float) -> float:
        return self.lat_s + nbytes / (self.gbs * 1e9)


# v5e nominal ICI: 4 links/chip x 400 Gbps/link -> ~45 GB/s usable per
# neighbor link after protocol overhead; ~1 us per-hop latency. Used when
# no second chip exists to measure against.
ICI_V5E_NOMINAL = HopProfile(gbs=45.0, lat_s=1e-6, name="ici-v5e-nominal")


def pipeline_projection(t1_s: float, n_stages: int, hop: HopProfile,
                        act_bytes: float, hbm_fit: bool = True) -> dict:
    """Layer-window pipeline over `n_stages` chips (SURVEY §2.4 piped-ring
    analogue; activations hop stage->stage once per window).

    stage_s = t1/n                      (equal layer split)
    hop_s   = lat + act_bytes/bw
    single-stream decode: hops serialize with compute (batch-1 decode has
      nothing to overlap) -> per-token = t1 + n*hop_s
    pipelined (>= n concurrent streams, async sends double-buffered):
      steady-state cycle = max(stage_s, hop_s); one token completes per
      cycle -> aggregate tok/s = 1/cycle; efficiency vs n independent
      single chips = (t1/n) / cycle
    """
    stage_s = t1_s / n_stages
    hop_s = hop.seconds(act_bytes)
    single_latency = t1_s + n_stages * hop_s
    cycle_overlap = max(stage_s, hop_s)
    cycle_seq = stage_s + hop_s
    return {
        "n_stages": n_stages,
        "hop": hop.name,
        "stage_ms": round(stage_s * 1e3, 4),
        "hop_us": round(hop_s * 1e6, 2),
        "single_stream_ms_tok": round(single_latency * 1e3, 3),
        "single_stream_tok_s": round(1.0 / single_latency, 2),
        "pipelined_tok_s": round(1.0 / cycle_overlap, 2),
        "pipelined_tok_s_no_overlap": round(1.0 / cycle_seq, 2),
        "efficiency": round(stage_s / cycle_overlap, 4),
        "efficiency_no_overlap": round(stage_s / cycle_seq, 4),
        "hbm_fit": hbm_fit,
    }


def ring_allreduce_seconds(nbytes: float, n: int, hop: HopProfile) -> float:
    """Ring all-reduce: 2(n-1) steps, each moving nbytes/n per link."""
    if n <= 1:
        return 0.0
    steps = 2 * (n - 1)
    return steps * hop.lat_s + steps * (nbytes / n) / (hop.gbs * 1e9)


def tp_projection(t1_s: float, n_chips: int, hop: HopProfile,
                  act_bytes: float, n_layers: int) -> dict:
    """Megatron tensor parallel: 2 all-reduces per layer (attn out + ffn
    out) of one activation row. Decode latency = t1/n + comm; unlike the
    pipeline, TP cuts single-stream latency but pays latency-bound
    collectives every layer."""
    comm = n_layers * 2 * ring_allreduce_seconds(act_bytes, n_chips, hop)
    tok_s = 1.0 / (t1_s / n_chips + comm)
    return {
        "n_chips": n_chips,
        "hop": hop.name,
        "comm_ms_tok": round(comm * 1e3, 4),
        "tok_s": round(tok_s, 2),
        "efficiency": round((t1_s / n_chips)
                            / (t1_s / n_chips + comm), 4),
    }


def capacity_projection(weight_bytes: float, n_chips: int,
                        hbm_usable_bytes: float, hbm_gbs: float,
                        host_stream_gbs: float) -> dict:
    """Weight-stream-bound decode when the model exceeds aggregate HBM:
    the resident part streams from HBM at n*hbm_gbs (pipeline stages read
    in parallel), the excess double-buffers from host RAM at the measured
    host->HBM rate (runtime/streaming.py). The reference's analogue is
    mmap + prefetch against disk (SURVEY §5.9)."""
    resident = min(weight_bytes, n_chips * hbm_usable_bytes)
    streamed = weight_bytes - resident
    t_tok = resident / (n_chips * hbm_gbs * 1e9) \
        + (streamed / (host_stream_gbs * 1e9) if streamed > 0 else 0.0)
    return {
        "n_chips": n_chips,
        "resident_gb": round(resident / 1e9, 2),
        "host_streamed_gb": round(streamed / 1e9, 2),
        "ms_tok": round(t_tok * 1e3, 3),
        "tok_s": round(1.0 / t_tok, 2),
    }


def project_all(t1_ms: float, n_embd: int, n_layers: int,
                weight_gb: float, batch: int = 1,
                ici: HopProfile | None = None,
                dcn: HopProfile | None = None,
                hbm_usable_gb: float = 13.0, hbm_gbs: float = 819.0,
                host_stream_gbs: float = 10.0,
                baseline_ms_tok: float | None = None) -> dict:
    """The full projection table for one model shape. act_bytes = one bf16
    activation row per sequence position (decode: S=1) times batch."""
    ici = ici or ICI_V5E_NOMINAL
    act_bytes = n_embd * 2 * batch
    t1_s = t1_ms / 1e3
    out = {
        "inputs": {
            "t1_ms_tok": t1_ms, "n_embd": n_embd, "n_layers": n_layers,
            "weight_gb": weight_gb, "act_bytes_per_hop": act_bytes,
            "ici": asdict(ici), **({"dcn": asdict(dcn)} if dcn else {}),
            "hbm_usable_gb": hbm_usable_gb, "hbm_gbs": hbm_gbs,
            "host_stream_gbs": host_stream_gbs,
        },
        "pipeline_ici": [], "pipeline_dcn": [], "tp_ici": [],
        "capacity": [],
    }
    for n in (2, 4, 8):
        fit = weight_gb <= n * hbm_usable_gb
        out["pipeline_ici"].append(
            pipeline_projection(t1_s, n, ici, act_bytes, hbm_fit=fit))
        if dcn:
            out["pipeline_dcn"].append(
                pipeline_projection(t1_s, n, dcn, act_bytes, hbm_fit=fit))
        out["tp_ici"].append(
            tp_projection(t1_s, n, ici, act_bytes, n_layers))
        out["capacity"].append(capacity_projection(
            weight_gb * 1e9, n, hbm_usable_gb * 1e9, hbm_gbs,
            host_stream_gbs))
    if baseline_ms_tok:
        best = max(r["pipelined_tok_s"] for r in out["pipeline_ici"]
                   if r["hbm_fit"]) if any(
            r["hbm_fit"] for r in out["pipeline_ici"]) else None
        out["baseline_ms_tok"] = baseline_ms_tok
        if best:
            out["vs_baseline_best_pipeline"] = round(
                best / (1000.0 / baseline_ms_tok), 2)
    return out
