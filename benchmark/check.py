"""The comparison that decides `correct`.

Once the window has closed and the program's state is freed, a sample of
the greedy requests the program finished, drawn from the seed and always
holding the one with most served tokens, goes through the reference: one
forward over each prompt with its served tokens. At every served position
the gap by which the served token's reference logit lies below the
reference's best logit is read. The configuration names the number
compared (configs/<name>.json "correct") and its limit. Greedy tokens only: the traffic mixes
greedy requests among the sampled ones for this.

For a mixture of experts the reference follows the program's choice of
experts (routes.py), and two more numbers check the router by itself: the
share of rows and MoE layers at which the program chose other experts
than the reference's own router would have, over every layer whose router
runs and over the configuration's first `route_lead_layers` of those (a
dense layer among them is not counted). Rounding makes the hidden
states of a bfloat16 program and a float32 reference part a little more
with every layer, so near-ties flip more often the deeper the layer; in
the first layers the two see nearly the same input, and there a router
that is wrong for some rows shows at its full share. The largest margin
in the reference's probabilities among the rows that differ is read
beside them, each layer's shares and margins too.

The control puts the reference in the program's place at float8: at each
of the same positions, the gap of the token that the fp8 reference puts
first (control.py).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import Reference
from .serve import Run, finished, token_stamps


def pick(run: Run, seed: int) -> list:
    """The greedy requests to compare: the finished one with most served
    tokens, then others in an order drawn from the seed until the mix's
    check_tokens are served."""
    done = [s for s in run.served if s.req.greedy and finished(s)]
    if run.routes is not None:
        # a request whose first cells the engine reused from its slot's last
        # prompt has no routing of its own there (rare: the prompts share
        # their first tokens)
        k = run.cfg["model"]["n_expert_used"]
        done = [s for s in done
                if run.routes.routes(s.gen.request_id, len(sequences([s])[0][0]), k) is not None]
    if not done:
        return []
    longest = max(done, key=lambda s: (s.req.n_out, -s.req.index))
    rest = [s for s in done if s is not longest]
    out, n = [longest], longest.req.n_out
    for i in np.random.default_rng([seed, 7]).permutation(len(rest)):
        if n >= run.mix["check_tokens"]:
            break
        out.append(rest[i])
        n += rest[i].req.n_out
    return out


def sequences(picked: list) -> tuple[list, list]:
    """Each request's prompt and served tokens but the last, and the
    position of its first served token's logits."""
    return ([s.req.prompt + list(s.gen.tokens_out[:-1]) for s in picked],
            [len(s.req.prompt) - 1 for s in picked])


def program_routes(run: Run, picked: list) -> list | None:
    """The program's experts at every position of each request (a mixture
    of experts), or None for a dense model. Raises where a position was
    not seen."""
    if run.routes is None:
        return None
    k = run.cfg["model"]["n_expert_used"]
    out = []
    for s, seq in zip(picked, sequences(picked)[0]):
        r = run.routes.routes(s.gen.request_id, len(seq), k)
        if r is None:
            raise RuntimeError(f"request {s.gen.request_id}: the program's routing was not seen")
        out.append(r)
    return out


def reference(cfg: dict, seed: int, picked: list, device, precision: str = "f32",
              routes: list | None = None) -> tuple[list, Reference]:
    """The reference's logits at every served position of each request,
    (n_out, V) a request, row j predicting served token j; and the
    reference, which holds what its routers did."""
    ref = Reference(cfg, seed, device, precision)
    return ref.logits(*sequences(picked), routes), ref


def readings(logits: list, chosen: list) -> dict:
    """The numbers a comparison can hold: over every compared position, the
    widest and the mean gap between the best reference logit and the
    chosen token's, and the share of positions where the chosen token is
    not the reference's first."""
    gaps = torch.cat([lg.max(-1).values - lg.gather(1, c[:, None])[:, 0]
                      for lg, c in zip(logits, chosen)])
    miss = torch.cat([lg.argmax(-1) != c for lg, c in zip(logits, chosen)])
    return {"max_logit_gap": float(gaps.max()), "mean_logit_gap": float(gaps.mean()),
            "mismatch_share": float(miss.float().mean())}


def router_readings(ref: Reference, lead_layers: int) -> dict:
    """The router's readings of a reference that followed given experts,
    each over MoE layers: all, the first `lead_layers`, and one by one."""
    return {"route_mismatch_share": ref.route_mismatch_share(),
            "route_mismatch_lead": ref.route_mismatch_share(lead_layers),
            "route_margin": max(ref.route_margins),
            "route_margin_lead": max(ref.route_margins[:lead_layers]),
            "route_share_by_layer": [d / max(n, 1) for d, n in zip(ref.route_differ,
                                                                  ref.route_rows)],
            "route_margin_by_layer": list(ref.route_margins)}


def served(picked: list, device) -> list:
    return [torch.tensor(s.gen.tokens_out, device=device) for s in picked]


def streamed(run: Run) -> bool:
    """Every finished request streamed one event for each of its tokens."""
    return all(len(token_stamps(s)) == s.req.n_out for s in run.served if finished(s))


def check(run: Run, seed: int, device) -> dict:
    """The number the configuration compares, with its limit, beside the
    other readings, and the verdict."""
    picked = pick(run, seed)
    tokens = sum(s.req.n_out for s in picked)
    c = run.cfg["correct"]
    got: dict = {}
    if picked:
        routes = program_routes(run, picked)
        logits, ref = reference(run.cfg, seed, picked, device, routes=routes)
        got = readings(logits, served(picked, device))
        if routes is not None:
            got.update(router_readings(ref, c["route_lead_layers"]))
    ok_stream = streamed(run)
    checks = {c["number"]: {"value": got.get(c["number"]), "limit": c["limit"]}}
    ok = bool(picked) and got[c["number"]] <= c["limit"]
    for name, limit in c.get("route_limits", {}).items():
        value = got.get(name)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value is not None and value <= limit
    checks["tokens_compared"] = {"value": tokens, "limit": 1}
    checks["unstreamed_requests"] = {"value": 0 if ok_stream else 1, "limit": 0}
    return {"correct": ok and ok_stream, "checks": checks, "readings": got}
