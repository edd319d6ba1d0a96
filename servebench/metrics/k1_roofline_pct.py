"""K1's bound (cost/arith.py, each call's shapes: one call a DiT layer and
step) over K1's device time in the trace. Nothing when the trace holds
another number of K1 calls than the launches made."""
from servebench.cost import arith


def read(run):
    trace = run.trace
    dit = run.cfg["dit"]
    heads, dh = dit["num_heads"], dit["d_model"] // dit["num_heads"]
    calls, bound = 0, 0.0
    for la in run.launches:
        n = dit["num_layers"] * la.steps
        l = la.latent_tokens + la.cond_tokens
        calls += n
        bound += n * arith.bound_s(*arith.k1_cost(len(la.members), l, l, heads, dh))
    if not trace or trace["k1_calls"] != calls or trace["k1_s"] <= 0:
        return None
    return 100.0 * bound / trace["k1_s"]
