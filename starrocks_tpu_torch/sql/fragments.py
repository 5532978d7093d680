"""Fragment IR: the distributed plan split at exchange boundaries.

Reference behavior: the FE cuts the physical plan into PlanFragments at
exchange boundaries and wires them with ExchangeNodes (fe
sql/plan/PlanFragmentBuilder, qe scheduler/dag/ExecutionDAG); each fragment
runs as N instances and edges move rows via transmit_chunk. Here the same
IR is recovered FROM the lowering rather than built before it: the
distributed compiler `note`s every collective it emits (with the plan edge
it implements) while the program runs once over shard 0 alone (parallel/
mesh.Dry: the exchange set depends on placements, dtypes and estimates,
never on values), so the recorded exchange set cannot drift from what the
program actually does. A port of the JAX package's sql/fragments.py. The
events then serve three consumers:

- annotate(): rebuild the logical plan with explicit LExchange nodes on the
  recorded edges — the declared-distribution surface that
  analysis/plan_check.py verifies with managed_exchanges=False (golden
  plans, EXPLAIN, bench exchange totals);
- split(): cut the plan into Fragments at the recorded edges. Each fragment
  runs as its own program over the SAME plan (same pre-order
  ordinals -> same capacity/check keys); boundary nodes resolve to upstream
  fragment outputs passed positionally. The consumer fragment keeps ALL of
  its operator's lowering, including the boundary collective itself, so
  single-process fragment execution is byte-identical to the monolithic
  program (runtime filters still apply before probe shuffles, op order is
  unchanged — the exchange edge marks where data crosses fragments, the
  collective still runs where the monolithic compiler put it);
- stats(): per-query exchange totals (count / rows / bytes upper bounds
  from the chunk capacities) for the profile.
"""

from __future__ import annotations

import dataclasses

from .logical import LExchange, LJoin, LScan, LUnion
from .distributed import REPLICATED


@dataclasses.dataclass(frozen=True)
class ExchangeEvent:
    """One collective the distributed lowering emitted, tied to the plan
    edge (parent, side) -> child it implements. parent None marks the final
    coordinator gather above the plan root."""

    parent: object  # consumer plan node (None for the root result gather)
    side: int  # index into parent.children
    child: object  # producer plan node (the subtree below the exchange)
    kind: str  # "hash" | "broadcast" | "gather" | "range"
    keys: tuple  # partition key exprs (hash/range kinds)
    out_mode: object  # declared post-exchange placement
    payload: str  # "rows" | "partial" | "topn" | "limit"
    child_mode: object  # mode emit(child) returned (fragment boundary mode)
    rows: int  # capacity upper bound of the chunk crossing the edge
    nbytes: int  # per-shard byte upper bound of that chunk


class ExchangeRecorder:
    """Collects ExchangeEvents during a compile_distributed run. The
    compiler calls note() immediately before each collective; the chunk
    argument is one shard's value about to cross, measured by capacity — a
    per-shard upper bound (live row counts are data-dependent)."""

    def __init__(self):
        self.events: list = []

    def note(self, parent, side, child, kind, keys, out_mode, payload,
             child_mode, chunk):
        nbytes = 0
        for arr in (*chunk.data, *chunk.valid, chunk.sel):
            if arr is not None:
                nbytes += int(arr.numel() * arr.element_size())
        self.events.append(ExchangeEvent(
            parent=parent, side=side, child=child, kind=kind,
            keys=tuple(keys), out_mode=out_mode, payload=payload,
            child_mode=child_mode, rows=int(chunk.capacity), nbytes=nbytes,
        ))


def _with_children(p, kids):
    if isinstance(p, LJoin):
        return dataclasses.replace(p, left=kids[0], right=kids[1])
    if isinstance(p, LUnion):
        return dataclasses.replace(p, inputs=tuple(kids))
    if isinstance(p, LScan) or not kids:
        return p
    return dataclasses.replace(p, child=kids[0])


def _edge_map(events):
    emap, root_ev = {}, None
    for ev in events:
        if ev.parent is None:
            root_ev = ev
        else:
            # nodes are frozen dataclasses: equal subtrees share one
            # emission (emit_memo) and therefore one event per edge
            emap.setdefault((ev.parent, ev.side), ev)
    return emap, root_ev


def annotate(plan, events):
    """Rebuild `plan` with an LExchange node on every recorded edge — the
    declared-distribution plan for plan_check/golden tests/EXPLAIN. Never
    fed back to the compiler (optimizer walkers like col_origin don't know
    LExchange); the execution path works on the original plan + Fragments."""
    emap, root_ev = _edge_map(events)

    memo: dict = {}

    def rec(p):
        if p in memo:
            return memo[p]
        kids = []
        for i, c in enumerate(p.children):
            nc = rec(c)
            ev = emap.get((p, i))
            if ev is not None:
                nc = LExchange(nc, ev.kind, tuple(ev.keys), ev.out_mode,
                               ev.payload)
            kids.append(nc)
        out = _with_children(p, kids)
        memo[p] = out
        return out

    out = rec(plan)
    if root_ev is not None:
        out = LExchange(out, root_ev.kind, (), root_ev.out_mode,
                        root_ev.payload)
    return out


@dataclasses.dataclass
class Fragment:
    """One independently run unit of the plan. `boundary` maps plan
    nodes whose subtrees ran upstream to (slot, mode): slot indexes the
    `bnd` tuple fed to step(), mode is what emit(node) returned in the
    monolithic program (so the consumer re-applies degrade/colocate rules
    identically). `deps` aligns fragment ids with boundary slots. The sink
    fragment owns the final coordinator gather and returns REPLICATED."""

    fid: int
    root: object
    boundary: dict
    deps: tuple
    sink: bool
    out_mode: object
    exchange: ExchangeEvent | None  # event on this fragment's OUTPUT edge


@dataclasses.dataclass
class FragmentIR:
    plan: object  # original logical plan (what fragments compile against)
    annotated: object  # plan with explicit LExchange nodes (declared IR)
    fragments: list  # topological order; fragments[-1] is the sink
    events: list  # raw ExchangeEvents in lowering order

    def stats(self) -> dict:
        return {
            "fragments": len(self.fragments),
            "exchanges": len(self.events),
            "exchange_rows": sum(ev.rows for ev in self.events),
            "exchange_bytes": sum(ev.nbytes for ev in self.events),
            # per-fragment breakdown keyed by fid: the profile's
            # fragment_{fid}_compile/execute timers join against this to
            # tell WHICH fragment a hot timer belongs to
            "per_fragment": [
                {"fid": f.fid, "sink": f.sink, "deps": list(f.deps),
                 "exchange": (f.exchange.kind
                              if f.exchange is not None else None)}
                for f in self.fragments],
        }


def split(plan, events) -> FragmentIR:
    """Cut `plan` at the recorded edges into Fragments (topo order, sink
    last). Equal subtrees consumed across several edges produce ONE
    producer fragment (mirrors emit_memo CSE in the monolithic program)."""
    emap, root_ev = _edge_map(events)
    fragments: list = []
    prod: dict = {}  # producer memo: child node -> fid

    def build(root_node, sink, out_mode, exchange) -> int:
        boundary: dict = {}
        deps: list = []

        def cut(c, ev):
            if c in boundary:
                return
            fid = prod.get(c)
            if fid is None:
                fid = build(c, False, ev.child_mode, ev)
                prod[c] = fid
            boundary[c] = (len(deps), ev.child_mode)
            deps.append(fid)

        def walk(p):
            for i, c in enumerate(p.children):
                ev = emap.get((p, i))
                if ev is not None:
                    cut(c, ev)
                else:
                    walk(c)

        walk(root_node)
        f = Fragment(len(fragments), root_node, boundary, tuple(deps),
                     sink, out_mode, exchange)
        fragments.append(f)
        return f.fid

    if root_ev is not None:
        # interior fragment computes the (sharded) root; the sink fragment
        # is the coordinator gather itself — its root IS the plan, resolved
        # through the boundary (checked before emission), then gathered
        interior = build(plan, False, root_ev.child_mode, root_ev)
        fragments.append(Fragment(
            len(fragments), plan, {plan: (0, root_ev.child_mode)},
            (interior,), True, REPLICATED, None,
        ))
    else:
        build(plan, True, REPLICATED, None)
    return FragmentIR(plan, annotate(plan, events), fragments, list(events))
