"""models/llama.py moe_ffn: the MoE layer calls that took the all-expert
loop (prefill chunks too wide for the expert-indexed GEMV), over all MoE
layer calls, in percent: the program's counters moe.dense_loops and
moe.calls over the traced run. None where the program keeps no such
counters."""

from benchmark import program_trace


def read(run):
    rec = getattr(run, "program", None)
    calls = 0 if rec is None else rec.counts.get("moe.calls", 0)
    if not calls:
        return None
    return 100.0 * rec.counts.get("moe.dense_loops", 0) / calls


assert program_trace  # imported for the hooks that keep the program's recording
