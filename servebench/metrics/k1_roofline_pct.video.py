"""K1's bound over K1's device time in the trace, counting every K1 call a
launch of a dual/single-stream DiT makes, each at its own shapes (cost
arithmetic as cost/arith.py's): per DDIM step one non-causal call a DiT
block over the joint sequence and one a token-refiner block over the
prompt, and per launch one causal call an encoder layer (grouped KV heads
expanded). Nothing when the trace holds another number of K1 calls."""
from servebench.cost import arith


def causal_cost(batch: int, l: int, heads: int, head_dim: int) -> tuple:
    """(operations, bytes) of one causal K1 call on bf16 tensors: the
    query-key pairs at or below the diagonal."""
    flops = 4.0 * (l * (l + 1) // 2) * batch * heads * head_dim
    return flops, arith.BF16_BYTES * 4 * batch * l * heads * head_dim


def read(run):
    trace = run.trace
    enc, dit = run.cfg["encoder"], run.cfg["dit"]
    heads, dh = dit["num_heads"], dit["d_model"] // dit["num_heads"]
    enc_heads = enc["num_heads"]
    enc_dh = enc["head_dim"] or enc["d_model"] // enc_heads
    calls, bound = 0, 0.0
    for la in run.launches:
        b, lc = len(la.members), la.cond_tokens
        l = la.latent_tokens + lc
        joint = arith.bound_s(*arith.k1_cost(b, l, l, heads, dh))
        refine = arith.bound_s(*arith.k1_cost(b, lc, lc, heads, dh))
        encode = arith.bound_s(*causal_cost(b, lc, enc_heads, enc_dh))
        calls += la.steps * (dit["num_layers"] + dit["refiner_layers"]) + enc["num_layers"]
        bound += la.steps * (dit["num_layers"] * joint + dit["refiner_layers"] * refine)
        bound += enc["num_layers"] * encode
    if not trace or trace["k1_calls"] != calls or trace["k1_s"] <= 0:
        return None
    return 100.0 * bound / trace["k1_s"]
