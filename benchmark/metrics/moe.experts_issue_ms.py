"""models/llama.py moe_ffn: the host's ms a decode step spends inside the
program's moe.experts spans (the routed experts' work of every MoE layer),
the spans within the window's decode.issue spans over those steps. None
where the program records no such span."""

from benchmark import program_trace


def read(run):
    rec = program_trace._recording(run)
    if rec is None:
        return None
    lo, hi = run.w0 * 1e9, run.w1 * 1e9
    steps = {id(s) for s in rec.spans if s.name == "decode.issue" and lo <= s.t0 < hi}
    inside, ns = 0, 0
    for s in rec.spans:
        if s.name != "moe.experts":
            continue
        p = s.parent
        while p is not None and id(p) not in steps:
            p = p.parent
        if p is not None:
            inside += 1
            ns += s.t1 - s.t0
    return 1e-6 * ns / len(steps) if inside else None
