"""TPC-H parity of the PyTorch port against the JAX package, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_parity.py [--sf 0.1] [--queries 1,9,S1]

Runs each query (the 22 TPC-H queries and the statistical queries S1/S2
by default) through the JAX `Session` and the port's
`Session(device="cpu")` on the same generated data (both packages'
generators, same seed), under the `auto` strategies and the kernel ones
(`segment_strategy = 'pallas'`, `join_probe_strategy = 'pallas_sorted'`,
`topn_strategy = 'pallas'`), and prints per query whether the rows agree —
in order, exactly, except floats to 6 significant digits — with the
port's kernel routes (wrapper call counts). Under the kernel strategies
S1/S2 sum their float moments in f32 blocks (the reference's contract), so
there the reference is the JAX package under the same strategies, to a
relative STAT_KERNEL_REL: each package adds inside a block in its own
order, and the variance's cancellation magnifies that (PERF.md). Exits 1
on any disagreement. The tests run the same
comparison at SF 0.01 (tests/test_torch_tpch*.py); this script takes it
to larger scale factors.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

STAT_KERNEL_REL = 1e-5


def rows_agree(got, want, rel: float = 1e-6) -> bool:
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if len(g) != len(w):
            return False
        for a, b in zip(g, w):
            if isinstance(a, float) and isinstance(b, float):
                if not (a == b or math.isclose(a, b, rel_tol=rel)):
                    return False
            elif a != b:
                return False
    return True


def _set(cfg, knobs: dict):
    for k, v in knobs.items():
        cfg.set(k, v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sf", type=float, default=0.1)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--queries", default="all",
                    help="comma list of TPC-H numbers and S1/S2, or 'all'")
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from starrocks_tpu.runtime.config import config as jcfg
    from starrocks_tpu.runtime.session import Session as JSession
    from starrocks_tpu.storage.catalog import tpch_catalog as jax_catalog
    from starrocks_tpu_torch.ops import kernels
    from starrocks_tpu_torch.runtime.config import (
        AUTO_STRATEGIES, KERNEL_STRATEGIES, config as tcfg,
    )
    from starrocks_tpu_torch.runtime.session import Session
    from starrocks_tpu_torch.storage.catalog import tpch_catalog
    from starrocks_tpu_torch.storage.tpch_queries import QUERIES, STAT_QUERIES

    texts = {**{str(q): t for q, t in QUERIES.items()}, **STAT_QUERIES}
    qids = (list(texts) if args.queries == "all"
            else [q.strip() for q in args.queries.split(",")])
    jcat = jax_catalog(sf=args.sf, seed=args.seed)
    tcat = tpch_catalog(sf=args.sf, seed=args.seed)
    # the reference under auto; TPC-H's rows are the same under its kernel
    # strategies (integer and decimal sums only), the f32-summed S1/S2's
    # are not, so those run there under both
    runs = (("auto", AUTO_STRATEGIES), ("kernels", KERNEL_STRATEGIES))
    want = {}
    js = JSession(jcat)
    for strategy, knobs in runs:
        _set(jcfg, knobs)
        for q in qids:
            if strategy == "kernels" and not q.startswith("S"):
                want[(strategy, q)] = want[("auto", q)]
                continue
            t = time.perf_counter()
            want[(strategy, q)] = js.sql(texts[q]).rows()
            print(f"jax {strategy} {q}: {len(want[(strategy, q)])} rows, "
                  f"{time.perf_counter() - t:.2f} s", flush=True)
    bad = []
    s = Session(tcat, device="cpu")
    for strategy, knobs in runs:
        _set(tcfg, knobs)
        for q in qids:
            kernels.reset_counts()
            t = time.perf_counter()
            got = s.sql(texts[q]).rows()
            dt = time.perf_counter() - t
            rel = (STAT_KERNEL_REL if strategy == "kernels"
                   and q.startswith("S") else 1e-6)
            ok = rows_agree(got, want[(strategy, q)], rel)
            routes = {n: c["calls"] for n, c in kernels.counts().items()}
            print(json.dumps({"sf": args.sf, "strategy": strategy, "q": q,
                              "rows": len(got), "agree": ok,
                              "routes": routes, "port_s": round(dt, 3)}),
                  flush=True)
            if not ok:
                bad.append((strategy, q))
    _set(tcfg, AUTO_STRATEGIES)
    _set(jcfg, AUTO_STRATEGIES)
    if bad:
        print(f"DISAGREE: {bad}")
        return 1
    print("all agree")
    return 0


if __name__ == "__main__":
    sys.exit(main())
