"""0/1 ILP solver for the dispatch problem (in-repo replacement for PuLP).

Problem shape (paper §6.2 OBJ, C0–C4 after feasibility filtering):
  * each request has a set of *options* (i, k) with reward c = W_r - Q_{r,i}
    and resource usage k on budget dimension i;
  * pick at most one option per request;
  * per-dimension usage must not exceed the budget B_i;
  * maximize total reward.

Solved exactly by depth-first branch-and-bound with an admissible bound
(sum of per-request best remaining rewards) and a greedy incumbent.  A node
cap keeps per-tick latency bounded (the incumbent is returned if hit, making
the solver anytime) — matching the paper's sub-100 ms per-tick budget
(Table 4).

The anytime cap is **deterministic**: ``time_cap`` is translated into a
node budget at a fixed calibration rate (``NODES_PER_SECOND``) instead of
reading the wall clock, so two runs of the same trace dispatch alike.

Refinements (all exactness-preserving):
  * options whose usage exceeds their dimension's budget are dropped up
    front, which also tightens the additive suffix bound;
  * cross-dimension dominance: an option on a *slack* dimension (one whose
    budget covers every request's largest option there, so it can never be
    binding) prunes any option of the same request with no more reward —
    swapping into a slack dimension can never break feasibility;
  * ``warm`` re-seeds the incumbent from the previous tick's surviving
    (dim, usage) choices, so the branch-and-bound starts near last tick's
    optimum and prunes far more aggressively under steady load.

Counterpart of ``repro/core/ilp.py`` for its single-pipeline path: one budget
dimension per option, no grouped solve and no dense-DP fast path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

# deterministic time->node translation for the anytime cap (~1.3M nodes/s on
# the reference's calibration box): a 50 ms dispatch budget is a 65k-node
# budget everywhere
NODES_PER_SECOND = 1_300_000


@dataclasses.dataclass(frozen=True)
class Option:
    """One (type i, degree k) choice for a request."""
    dim: int          # budget dimension (Virtual-Replica index)
    usage: int        # units consumed
    reward: float


@dataclasses.dataclass
class Solution:
    choices: Dict[int, Option]     # request index -> chosen option
    reward: float
    nodes: int
    optimal: bool


def _greedy(options: Sequence[Sequence[Option]], budgets: List[int],
            seed: Optional[Dict[int, Option]] = None
            ) -> Tuple[Dict[int, Option], float]:
    """Incumbent: honor ``seed`` choices first (feasibility-checked), then
    fill the rest by best reward desc, best feasible option."""
    rem = list(budgets)
    chosen: Dict[int, Option] = {}
    total = 0.0
    if seed:
        for r, o in seed.items():  # detlint: ignore[DET001] warm-start dict is solver-insertion-ordered; admission order is the algorithm
            if o.usage <= rem[o.dim]:
                chosen[r] = o
                rem[o.dim] -= o.usage
                total += o.reward
    order = sorted((r for r in range(len(options)) if r not in chosen),
                   key=lambda r: -max((o.reward for o in options[r]), default=0.0))
    for r in order:
        best = None
        for o in sorted(options[r], key=lambda o: (-o.reward, o.usage)):
            if o.reward > 0 and o.usage <= rem[o.dim]:
                best = o
                break
        if best is not None:
            chosen[r] = best
            rem[best.dim] -= best.usage
            total += best.reward
    return chosen, total


def solve(options: Sequence[Sequence[Option]], budgets: Sequence[int],
          node_cap: int = 200_000, time_cap: float = 0.2,
          warm: Optional[Dict[int, Tuple[int, int]]] = None) -> Solution:
    """Maximize total reward.  ``options[r]`` lists request r's choices.

    ``warm`` maps request index -> (dim, usage) chosen on a previous solve
    of a similar instance; it only seeds the incumbent (rewards are re-read
    from the current options), so optimality claims are unaffected.

    ``time_cap`` is a *latency budget*, enforced deterministically: it is
    converted to a node budget at ``NODES_PER_SECOND``, so a capped solve
    stops at the same node on every machine and every run.
    """
    n = len(options)
    budgets = list(budgets)
    if time_cap is not None:
        node_cap = min(node_cap, max(1, int(time_cap * NODES_PER_SECOND)))

    # feasibility filter: an option can never fit if its usage alone
    # exceeds its dimension's budget
    feasible = [[o for o in opts if o.reward > 0 and o.usage <= budgets[o.dim]]
                for opts in options]

    # slack dimensions: budget covers every request's largest option there,
    # so the dimension can never be binding in any solution
    max_use = [0] * len(budgets)
    for opts in feasible:
        per_dim: Dict[int, int] = {}
        for o in opts:
            if o.usage > per_dim.get(o.dim, 0):
                per_dim[o.dim] = o.usage
        for d, u in per_dim.items():
            max_use[d] += u
    slack = [max_use[d] <= budgets[d] for d in range(len(budgets))]

    # dominance prune per request:
    #   * same dim: dominated in (reward, usage) — classic Pareto;
    #   * cross dim: any option on a slack dimension dominates options with
    #     no more reward (swapping to it can never break feasibility).
    pruned: List[List[Option]] = []
    for opts in feasible:
        slack_best = None
        for o in opts:
            if slack[o.dim] and (slack_best is None or o.reward > slack_best):
                slack_best = o.reward
        keep: List[Option] = []
        for o in sorted(opts, key=lambda o: (o.usage, -o.reward)):
            if slack_best is not None and o.reward < slack_best and not slack[o.dim]:
                continue
            if not any(p.reward >= o.reward and p.dim == o.dim and p.usage <= o.usage
                       for p in keep):
                keep.append(o)
        pruned.append(keep)

    # order: largest best-reward first (tightens the additive bound quickly);
    # requests with *identical* option lists sort adjacently so the DFS can
    # break their symmetry (steady traffic yields many same-class requests
    # with bit-identical rewards)
    best_reward = [max((o.reward for o in opts), default=0.0) for opts in pruned]
    sig = [tuple(sorted((o.dim, o.usage, o.reward) for o in opts)) for opts in pruned]
    order = sorted(range(n), key=lambda r: (-best_reward[r], sig[r]))
    # suffix bound: best achievable from request position j onward
    suffix = [0.0] * (n + 1)
    for j in range(n - 1, -1, -1):
        suffix[j] = suffix[j + 1] + best_reward[order[j]]
    # symmetry: skipping request j entirely makes every identical following
    # request interchangeable with it, so the skip branch may jump the group
    skip_to = list(range(1, n + 1))
    for j in range(n - 2, -1, -1):
        if sig[order[j]] == sig[order[j + 1]]:
            skip_to[j] = skip_to[j + 1]

    seed: Dict[int, Option] = {}
    if warm:
        for r, (dim, usage) in warm.items():
            if 0 <= r < n:
                for o in pruned[r]:
                    if o.dim == dim and o.usage == usage:
                        seed[r] = o
                        break
    incumbent, inc_reward = _greedy(pruned, budgets)
    if seed:
        warm_inc, warm_reward = _greedy(pruned, budgets, seed=seed)
        if warm_reward > inc_reward:
            incumbent, inc_reward = warm_inc, warm_reward
    best_reward_found = inc_reward
    best_choices = dict(incumbent)
    nodes = 0
    capped = False

    # each request's options best-reward-first, sorted once
    by_reward = [sorted(opts, key=lambda o: -o.reward) for opts in pruned]

    def dfs(j: int, rem: List[int], cap_rem: int, cur: float,
            chosen: Dict[int, Option]):
        nonlocal best_reward_found, best_choices, nodes, capped
        if capped:
            return
        nodes += 1
        if nodes >= node_cap:
            capped = True
            return
        if cur > best_reward_found:
            best_reward_found = cur
            best_choices = dict(chosen)
        if j >= n:
            return
        # capacity-aware admissible bound: every option consumes >= 1 unit,
        # so at most cap_rem more requests can be served; ``order`` is
        # reward-descending, so their best case is the next cap_rem entries
        # of the suffix array
        stop = j + cap_rem
        bound = suffix[j] - suffix[stop if stop < n else n]
        if cur + bound <= best_reward_found + 1e-12:
            return
        r = order[j]
        # try options best-first, then the skip branch
        for o in by_reward[r]:
            if o.usage <= rem[o.dim]:
                rem[o.dim] -= o.usage
                chosen[r] = o
                dfs(j + 1, rem, cap_rem - o.usage, cur + o.reward, chosen)
                del chosen[r]
                rem[o.dim] += o.usage
        dfs(skip_to[j], rem, cap_rem, cur, chosen)

    dfs(0, list(budgets), sum(budgets), 0.0, {})
    return Solution(choices=best_choices, reward=best_reward_found,
                    nodes=nodes, optimal=not capped)
