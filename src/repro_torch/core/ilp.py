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

Multi-dimensional options (cross-lane batching): ``Option.dim``/``usage``
may also be *parallel tuples*, one (dim, usage) pair per budget dimension
the option consumes — the column shape the fleet's cross-lane batcher
needs, where joining a fused launch consumes both the launch's shared
batch-size budget and the member lane's own batch-curve cap.  The two
kinds may mix in one instance; an all-scalar instance takes a leaner walk
over the same nodes.  ``solve_grouped`` enters identical requests once with
a count.

``dp=True`` (the dispatcher's ``incremental`` mode) allows exact shortcuts
that may pick another of several equal-reward optima, or the optimum where a
node-capped search would stop at an incumbent: a fully slack instance takes
each request's best option, a per-dimension decomposable one is solved by a
dense multiple-choice knapsack DP (``_solve_dp_single_dim``), and the search
walks identical requests in canonical (non-decreasing option) order.

Counterpart of ``repro/core/ilp.py``.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

# deterministic time->node translation for the anytime cap (~1.3M nodes/s on
# the reference's calibration box): a 50 ms dispatch budget is a 65k-node
# budget everywhere
NODES_PER_SECOND = 1_300_000


@dataclasses.dataclass(frozen=True)
class Option:
    """One (type i, degree k) choice for a request.

    ``dim``/``usage`` are plain ints for the dispatch column; a
    multi-dimensional option (cross-lane batching) carries parallel tuples
    instead — ``dim[j]``'s budget is charged ``usage[j]`` units."""
    dim: object       # budget dimension (int) | parallel dims (Tuple[int, ...])
    usage: object     # units consumed (int) | per-dim usages (Tuple[int, ...])
    reward: float


def _spans(o: Option) -> Tuple[Tuple[int, int], ...]:
    """Normalized ((dim, usage), ...) consumption pairs of one option."""
    if isinstance(o.dim, tuple):
        return tuple(zip(o.dim, o.usage))
    return ((o.dim, o.usage),)


def _usage_total(o: Option) -> int:
    """Total units consumed across all of an option's budget dimensions."""
    if isinstance(o.usage, tuple):
        return sum(o.usage)
    return o.usage


@dataclasses.dataclass
class Solution:
    choices: Dict[int, Option]     # request index -> chosen option
    reward: float
    nodes: int
    optimal: bool


@dataclasses.dataclass
class GroupedSolution:
    """Result of ``solve_grouped``: per-group granted options."""
    alloc: Dict[int, List[Option]]   # group index -> one Option per copy
    reward: float
    nodes: int
    optimal: bool
    n_slots: int                     # expanded instance size actually solved


def solve_grouped(options: Sequence[Sequence[Option]],
                  budgets: Sequence[int], counts: Sequence[int],
                  node_cap: int = 200_000, time_cap: float = 0.2,
                  warm: Optional[Dict[int, Sequence[Tuple[int, int]]]] = None,
                  dp: bool = False) -> GroupedSolution:
    """Multiplicity-aware dispatch ILP: group g enters once with a count.

    ``options[g]`` is the option list shared by ``counts[g]`` identical
    requests; up to ``counts[g]`` copies of group g may be granted (each
    copy independently picks one option and consumes its usage).  Each
    group is expanded only up to its *capacity bound*: every option
    consumes at least one unit, so no solution grants more copies than
    ``sum(budgets) // min_usage``.  The truncated members are
    interchangeable with the kept ones, so the optimum is unchanged; the
    expanded instance then reuses ``solve`` (whose identical-row symmetry
    breaking collapses the remaining copies).  A cross-lane group is just
    a group whose option spans more than one budget dimension; the
    capacity bound uses the option's *total* usage.

    ``warm`` maps group index -> (dim, usage) pairs granted to the group on
    a previous solve; they seed the incumbent exactly like ``solve``'s.
    ``dp`` is passed on to ``solve``.
    """
    total_budget = int(sum(budgets))
    slot_group: List[int] = []           # expanded slot -> group index
    slot_opts: List[Sequence[Option]] = []
    warm_slots: Dict[int, Tuple[int, int]] = {}
    for g, (opts, m) in enumerate(zip(options, counts)):
        if not opts or m <= 0:
            continue
        min_use = max(1, min(_usage_total(o) for o in opts))
        cap = min(int(m), total_budget // min_use)
        seeds = list((warm or {}).get(g, ()))
        for i in range(cap):
            if i < len(seeds):
                warm_slots[len(slot_group)] = tuple(seeds[i])
            slot_group.append(g)
            slot_opts.append(opts)
    sol = solve(slot_opts, budgets, node_cap=node_cap, time_cap=time_cap,
                warm=warm_slots or None, dp=dp)
    alloc: Dict[int, List[Option]] = {}
    for si, o in sol.choices.items():
        alloc.setdefault(slot_group[si], []).append(o)
    for granted in alloc.values():
        granted.sort(key=lambda o: (-o.reward, _usage_total(o)))
    return GroupedSolution(alloc=alloc, reward=sol.reward, nodes=sol.nodes,
                           optimal=sol.optimal, n_slots=len(slot_group))


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
            if all(u <= rem[d] for d, u in _spans(o)):
                chosen[r] = o
                for d, u in _spans(o):
                    rem[d] -= u
                total += o.reward
    order = sorted((r for r in range(len(options)) if r not in chosen),
                   key=lambda r: -max((o.reward for o in options[r]), default=0.0))
    for r in order:
        best = None
        for o in sorted(options[r], key=lambda o: (-o.reward, _usage_total(o))):
            if o.reward > 0 and all(u <= rem[d] for d, u in _spans(o)):
                best = o
                break
        if best is not None:
            chosen[r] = best
            for d, u in _spans(best):
                rem[d] -= u
            total += best.reward
    return chosen, total


def _solve_dp_single_dim(pruned: Sequence[Sequence[Option]], dim: int,
                         cap: int) -> Tuple[Dict[int, Option], float]:
    """Exact multiple-choice knapsack DP for an *effectively one-
    dimensional* instance (every surviving option charges budget ``dim``):
    the case where the search's additive suffix bound degrades, so a
    saturated lane whose backlog competes for one placement type can burn
    the whole node cap on a textbook knapsack.  O(requests * cap * options)
    cells, exact and cap-free.

    Deterministic: requests in index order, options in list order, a cell is
    replaced only on a *strictly* better reward, and the reconstruction
    walks a parent-choice table.
    """
    n = len(pruned)
    # capacities beyond what every request's largest option could jointly
    # consume are unreachable: clamping shrinks the table (val is
    # monotone, so val[cap] is still the optimum)
    cap = min(cap, sum(max((o.usage for o in opts), default=0)
                       for opts in pruned))
    val = np.zeros(cap + 1, dtype=np.float64)      # best reward at capacity <= c
    take = np.full((n, cap + 1), -1, dtype=np.int32)
    for r, opts in enumerate(pruned):
        if not opts:
            continue
        best = val.copy()                          # skip branch
        choice = take[r]
        for oi, o in enumerate(opts):
            u = o.usage
            if u > cap:
                continue
            cand = val[:cap + 1 - u] + o.reward
            seg = best[u:]
            upd = cand > seg
            seg[upd] = cand[upd]
            choice[u:][upd] = oi
        val = best
    c = cap
    picks: List[Tuple[int, Option]] = []
    for r in range(n - 1, -1, -1):
        oi = int(take[r, c])
        if oi >= 0:
            o = pruned[r][oi]
            picks.append((r, o))
            c -= o.usage
    picks.reverse()
    return dict(picks), float(val[cap])


def _solution_of(best: Sequence[Optional[Option]]) -> Solution:
    """The optimum of an instance no budget binds, from each request's
    first-listed max-reward option (None: the request has none)."""
    choices: Dict[int, Option] = {}
    reward = 0.0
    for r, o in enumerate(best):
        if o is not None:
            choices[r] = o
            reward += o.reward
    return Solution(choices=choices, reward=reward, nodes=0, optimal=True)


def solve(options: Sequence[Sequence[Option]], budgets: Sequence[int],
          node_cap: int = 200_000, time_cap: float = 0.2,
          warm: Optional[Dict[int, Tuple[int, int]]] = None,
          dp: bool = False) -> Solution:
    """Maximize total reward.  ``options[r]`` lists request r's choices.

    ``warm`` maps request index -> (dim, usage) chosen on a previous solve
    of a similar instance; it only seeds the incumbent (rewards are re-read
    from the current options), so optimality claims are unaffected.

    ``time_cap`` is a *latency budget*, enforced deterministically: it is
    converted to a node budget at ``NODES_PER_SECOND``, so a capped solve
    stops at the same node on every machine and every run.

    ``dp`` allows the exact shortcuts of the module docstring; without it
    the search runs as it always has.
    """
    n = len(options)
    budgets = list(budgets)
    if time_cap is not None:
        node_cap = min(node_cap, max(1, int(time_cap * NODES_PER_SECOND)))

    # all-scalar, fully slack instance (dp): the slack return below, with
    # the feasibility filter and the slack analysis folded into one pass
    # that builds no spans.  Most fleet dispatch instances are this; it
    # falls through on the first tuple-dim option or a binding dimension.
    if dp:
        nb = len(budgets)
        max_use_f = [0] * nb
        fast_best: List[Optional[Option]] = []
        scalar = True
        for opts in options:
            best = None
            per_dim: Dict[int, int] = {}
            for o in opts:
                if o.reward <= 0:
                    continue
                d = o.dim
                if isinstance(d, tuple):
                    scalar = False
                    break
                u = o.usage
                if u > budgets[d]:
                    continue
                if u > per_dim.get(d, 0):
                    per_dim[d] = u
                if best is None or o.reward > best.reward:
                    best = o
            if not scalar:
                break
            for d, u in per_dim.items():
                max_use_f[d] += u
            fast_best.append(best)
        if scalar and all(max_use_f[d] <= budgets[d] for d in range(nb)):
            return _solution_of(fast_best)

    # feasibility filter: an option can never fit if its usage alone
    # exceeds its dimension's budget (checked per consumed dimension).
    # Spans are derived once per option here and threaded through the
    # slack analysis, the prune, and the DFS prep.
    feasible: List[List[Option]] = []
    fspans: List[List[Tuple[Tuple[int, int], ...]]] = []
    for opts in options:
        keep_o: List[Option] = []
        keep_s: List[Tuple[Tuple[int, int], ...]] = []
        for o in opts:
            if o.reward <= 0:
                continue
            sp = _spans(o)
            for d, u in sp:
                if u > budgets[d]:
                    break
            else:
                keep_o.append(o)
                keep_s.append(sp)
        feasible.append(keep_o)
        fspans.append(keep_s)

    # slack dimensions: budget covers every request's largest option there,
    # so the dimension can never be binding in any solution
    max_use = [0] * len(budgets)
    for sps in fspans:
        per_dim: Dict[int, int] = {}
        for sp in sps:
            for d, u in sp:
                if u > per_dim.get(d, 0):
                    per_dim[d] = u
        for d, u in per_dim.items():
            max_use[d] += u
    slack = [max_use[d] <= budgets[d] for d in range(len(budgets))]

    # fully slack instance (dp): even if every request takes its largest
    # option in every dimension it touches, no budget binds
    if dp and all(slack):
        return _solution_of([max(opts, key=lambda o: o.reward) if opts else None
                             for opts in feasible])

    # dominance prune per request:
    #   * same dims: dominated in (reward, per-dim usage) — classic Pareto;
    #   * cross dim: any option entirely on slack dimensions dominates
    #     options with no more reward (swapping to it can never break
    #     feasibility).
    pruned: List[List[Option]] = []
    pspans: List[List[Tuple[Tuple[int, int], ...]]] = []
    for opts, sps in zip(feasible, fspans):
        slack_best = None
        for o, sp in zip(opts, sps):
            for d, _ in sp:
                if not slack[d]:
                    break
            else:
                if slack_best is None or o.reward > slack_best:
                    slack_best = o.reward
        keep: List[Tuple[Option, Tuple[Tuple[int, int], ...],
                         Dict[int, int]]] = []
        for o, sp in sorted(zip(opts, sps),
                            key=lambda t: (_usage_total(t[0]), -t[0].reward)):
            o_use = dict(sp)
            if slack_best is not None and o.reward < slack_best:
                if not all(slack[d] for d in o_use):
                    continue
            dominated = False
            for p, psp, p_use in keep:
                if p.reward >= o.reward and p_use.keys() == o_use.keys():
                    for d, u in psp:
                        if u > o_use[d]:
                            break
                    else:
                        dominated = True
                        break
            if not dominated:
                keep.append((o, sp, o_use))
        pruned.append([t[0] for t in keep])
        pspans.append([t[1] for t in keep])

    # per-dimension decomposable instance (dp): when every request's
    # surviving options charge one scalar dimension, requests partition by
    # dimension into independent multiple-choice knapsacks (budgets are per
    # dimension, rewards add across requests), each solved by the DP
    if dp:
        decomposable = True
        req_dim: Dict[int, object] = {}
        for r, opts in enumerate(pruned):
            dims_r = {o.dim for o in opts}
            if len(dims_r) > 1 or any(isinstance(d, tuple) for d in dims_r):
                decomposable = False
                break
            if dims_r:
                req_dim[r] = next(iter(dims_r))
        if decomposable and req_dim:
            choices = {}
            reward = 0.0
            for d in sorted(set(req_dim.values())):
                rs = [r for r in range(n) if req_dim.get(r) == d]
                sub_choices, sub_reward = _solve_dp_single_dim(
                    [pruned[r] for r in rs], d, int(budgets[d]))
                for i, o in sub_choices.items():
                    choices[rs[i]] = o
                reward += sub_reward
            return Solution(choices=choices, reward=reward, nodes=0,
                            optimal=True)

    # order: largest best-reward first (tightens the additive bound quickly);
    # requests with *identical* option lists sort adjacently so the DFS can
    # break their symmetry (steady traffic yields many same-class requests
    # with bit-identical rewards)
    best_reward = [max((o.reward for o in opts), default=0.0) for opts in pruned]
    sig = [tuple(sorted((sp, o.reward) for o, sp in zip(opts, sps)))
           for opts, sps in zip(pruned, pspans)]
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
    # canonical form (dp): within a run of identical requests, option
    # indices are non-decreasing along the run.  Every assignment permutes
    # into one with the same reward, so the optimum's value is untouched,
    # but m identical requests with c options cost C(m+c, c) states instead
    # of (c+1)^m.  The canonical optimum may map options onto members
    # differently than the first-found one, hence opt-in.
    same_as_next = [j + 1 < n and sig[order[j]] == sig[order[j + 1]]
                    for j in range(n)] if dp else [False] * n

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

    # each request's options best-reward-first with their spans, sorted once
    by = [sorted(zip(opts, sps), key=lambda t: -t[0].reward)
          for opts, sps in zip(pruned, pspans)]
    by_reward = [[o for o, _ in lst] for lst in by]
    by_spans = [[(sp, _usage_total(o)) for o, sp in lst] for lst in by]

    def dfs(j: int, rem: List[int], cap_rem: int, cur: float,
            chosen: Dict[int, Option]):
        """The walk of an all-scalar instance (every dispatch ILP but the
        cross-lane batcher's): ``dfs_spans``' nodes in the same order, with
        a smaller frame and no span loops.  Kept apart because one walk
        holding both loops ran several times slower a node on CPython
        3.12.3 (``chip_smoke.py`` phase 5c's 128-chip flux dispatch round
        on an H100 host: 455-627 ms, against 24-41 ms for this walk)."""
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

    def dfs_canon(j: int, rem: List[int], cap_rem: int, cur: float,
                  chosen: Dict[int, Option], min_opt: int):
        """``dfs`` in canonical form (``dp``): ``min_opt`` is the option
        floor within a run of identical requests.  Kept apart from ``dfs``:
        one walk carrying the floor made the plain search slower a node on
        the card's host (phase 10's predictive run)."""
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
        stop = j + cap_rem
        bound = suffix[j] - suffix[stop if stop < n else n]
        if cur + bound <= best_reward_found + 1e-12:
            return
        r = order[j]
        opts_r = by_reward[r]
        chain = same_as_next[j]
        for i in range(min_opt, len(opts_r)):
            o = opts_r[i]
            if o.usage <= rem[o.dim]:
                rem[o.dim] -= o.usage
                chosen[r] = o
                dfs_canon(j + 1, rem, cap_rem - o.usage, cur + o.reward,
                          chosen, i if chain else 0)
                del chosen[r]
                rem[o.dim] += o.usage
        dfs_canon(skip_to[j], rem, cap_rem, cur, chosen, 0)

    def dfs_spans(j: int, rem: List[int], cap_rem: int, cur: float,
                  chosen: Dict[int, Option], min_opt: int = 0):
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
        stop = j + cap_rem
        bound = suffix[j] - suffix[stop if stop < n else n]
        if cur + bound <= best_reward_found + 1e-12:
            return
        r = order[j]
        opts_r = by_reward[r]
        spans_r = by_spans[r]
        chain = same_as_next[j]
        for i in range(min_opt, len(opts_r)):
            sp, use = spans_r[i]
            for d, u in sp:
                if u > rem[d]:
                    break
            else:
                o = opts_r[i]
                for d, u in sp:
                    rem[d] -= u
                chosen[r] = o
                dfs_spans(j + 1, rem, cap_rem - use, cur + o.reward, chosen,
                          i if chain else 0)
                del chosen[r]
                for d, u in sp:
                    rem[d] += u
        dfs_spans(skip_to[j], rem, cap_rem, cur, chosen)

    scalar = all(len(sp) == 1 for sps in pspans for sp in sps)
    if not scalar:
        dfs_spans(0, list(budgets), sum(budgets), 0.0, {})
    elif dp:
        dfs_canon(0, list(budgets), sum(budgets), 0.0, {}, 0)
    else:
        dfs(0, list(budgets), sum(budgets), 0.0, {})
    return Solution(choices=best_choices, reward=best_reward_found,
                    nodes=nodes, optimal=not capped)


def brute_force(options: Sequence[Sequence[Option]], budgets: Sequence[int]) -> float:
    """Exhaustive reference for tests (tiny instances only)."""
    best = 0.0
    for combo in itertools.product(*(list(opts) + [None] for opts in options)):
        rem = list(budgets)
        total = 0.0
        ok = True
        for o in combo:
            if o is None or o.reward <= 0:
                continue
            for d, u in _spans(o):
                rem[d] -= u
            if any(rem[d] < 0 for d, _ in _spans(o)):
                ok = False
                break
            total += o.reward
        if ok:
            best = max(best, total)
    return best
