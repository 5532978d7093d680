"""The port's process mesh over several hosts: runtime.cluster.host_layout
(each rank's local rank and cards, one backend for the group, from every
rank's host and visible cards), init_multihost's rendezvous in a
torch.distributed TCPStore, and the mesh's `hosts`, as jax.distributed
spans one mesh over a pod's hosts. On the CPU:

- the layout rule over a table of cases: on one host it gives
  `process_backend`'s backend and the cards of one card per rank
  (`cuda:(r % cards)`) wherever a rank gets one card, for cards 0-4 x
  ranks 1-8; two hosts of four cards with four ranks or one rank each; a
  host whose three ranks share two cards; a host with no card; ranks
  interleaved over two hosts;
- `process_devices` over ranks that hold several cards;
- chip_smoke's dist_procs layouts, whose expectations are written out,
  against the rule;
- the rendezvous: four CPU processes as two emulated hosts (host "a" for
  ranks 0 and 2, "b" for 1 and 3; 2 shards each) over gloo, every
  collective equal to `InProcess`, `Mesh.hosts` and `Mesh.devices` as the
  rule says, and the rows of Q3, a shuffle aggregate and N1 over the 8
  shards equal to the JAX package's 8-device mesh (integers exact, floats
  within 1e-6 relative);
- a rank that never arrives: the others raise RanksMissing naming it
  within the rendezvous' timeout.

The ranks are tests/test_torch_process_mesh.py's worker; its `jax_rows`
fixture gives the JAX rows.
"""

import threading
import time

import pytest
import torch

from starrocks_tpu_torch.parallel.mesh import process_devices
from starrocks_tpu_torch.runtime.cluster import (
    RanksMissing, RankPlace, host_layout, init_multihost, process_backend,
)

from test_torch_process_mesh import (  # noqa: F401  (jax_rows: a fixture)
    CLASSES, DTYPES, LOCAL_SHARDS, OPS, _free_port, jax_rows, run_ranks,
)

HOSTS = ["a", "b", "a", "b"]  # the rendezvous' emulated hosts, by rank
MISSING_TIMEOUT_S = 4.0


# --- the layout rule ---------------------------------------------------------


@pytest.mark.parametrize("procs", range(1, 9))
@pytest.mark.parametrize("cards", range(5))
def test_one_host_layout_is_process_backend(cards, procs):
    backend, places = host_layout([("h", cards)] * procs)
    # the single-host rule as it stood before hosts: NCCL with a card each
    pr19 = "nccl" if 0 < cards and procs <= cards else "gloo"
    assert backend == process_backend(cards, procs) == pr19
    per = cards // procs if cards else 0
    for r, p in enumerate(places):
        assert (p.host, p.local_rank) == ("h", r)
        if not cards:
            assert p.cards == ()
        elif per <= 1:  # one card a rank: cuda:(r % cards)
            assert p.cards == (r % cards,)
        else:  # a block of cards a rank
            assert p.cards == tuple(range(r * per, (r + 1) * per))


@pytest.mark.parametrize("table, backend, want", [
    # 2 hosts x 4 cards x 4 ranks: one card each
    ([("a", 4)] * 4 + [("b", 4)] * 4, "nccl",
     [("a", i, (i,)) for i in range(4)] + [("b", i, (i,)) for i in range(4)]),
    # 2 hosts x 4 cards x 1 rank: the JAX pod layout, a host's cards a rank
    ([("a", 4), ("b", 4)], "nccl",
     [("a", 0, (0, 1, 2, 3)), ("b", 0, (0, 1, 2, 3))]),
    # 3 ranks share 2 cards on host a: gloo for every rank
    ([("a", 2)] * 3 + [("b", 2)] * 2, "gloo",
     [("a", 0, (0,)), ("a", 1, (1,)), ("a", 2, (0,)), ("b", 0, (0,)),
      ("b", 1, (1,))]),
    # a host with no card: gloo for every rank
    ([("a", 2), ("b", 0), ("a", 2)], "gloo",
     [("a", 0, (0,)), ("b", 0, ()), ("a", 1, (1,))]),
    # interleaved ranks: 0 and 2 on a, 1 and 3 on b
    ([("a", 2), ("b", 2), ("a", 2), ("b", 2)], "nccl",
     [("a", 0, (0,)), ("b", 0, (0,)), ("a", 1, (1,)), ("b", 1, (1,))]),
    # 2 hosts x 2 cards, 1 rank each; and 2 ranks of 3 cards: one card each
    ([("a", 2), ("b", 3), ("b", 3)], "nccl",
     [("a", 0, (0, 1)), ("b", 0, (0,)), ("b", 1, (1,))]),
], ids=["2x4x4", "2x4x1", "3-on-2", "no-card", "interleaved", "uneven"])
def test_host_layout_cases(table, backend, want):
    got_backend, places = host_layout(table)
    assert got_backend == backend
    assert places == [RankPlace(*w) for w in want]


def test_host_layout_refuses_two_card_counts_on_one_host():
    with pytest.raises(ValueError, match="one host, one card count"):
        host_layout([("a", 2), ("a", 4)])


@pytest.mark.parametrize("ranks, n, want", [
    ([("cuda:0", "cuda:1")] * 2, 8, [0, 0, 1, 1] * 2),
    ([("cuda:0", "cuda:1", "cuda:2", "cuda:3")], 4, [0, 1, 2, 3]),
    ([("cuda:2", "cuda:3"), "cuda:0"], 4, [2, 3, 0, 0]),
    ([("cuda:0", "cuda:1")] * 2, 6, [0, 0, 0] * 2),  # 3 shards: one card
])
def test_process_devices_spread_over_a_ranks_cards(ranks, n, want):
    assert process_devices(ranks, n) == tuple(
        torch.device("cuda", i) for i in want)


def _smoke_layouts():
    from chip_smoke import procs_layouts

    return [(c, lay) for c in (1, 2, 4) for lay in procs_layouts(c)]


@pytest.mark.parametrize("cards, lay", _smoke_layouts(),
                         ids=lambda x: x["name"] if isinstance(x, dict)
                         else f"{x}card")
def test_rule_gives_chip_smokes_written_out_layouts(cards, lay):
    """chip_smoke's dist_procs layouts write out what their ranks must
    report (the card holds the ranks to it); the rule and the device map
    give the same: the backend, each rank's cards, Mesh.devices and
    Mesh.hosts over the 8 shards."""
    from chip_smoke import DIST_SHARDS, layout_ranks

    ranks = layout_ranks(lay["hosts"])
    backend, places = host_layout(
        [(h or "this", len(vis.split(","))) for h, vis in ranks])
    want = lay["want"]
    assert backend == want["backend"]
    assert [list(p.cards) for p in places] == want["cards"]
    devices = process_devices(
        [tuple(f"cuda:{c}" for c in p.cards) for p in places], DIST_SHARDS)
    assert [str(d) for d in devices] == want["devices"]
    per = DIST_SHARDS // len(ranks)
    assert [places[s // per].host for s in range(DIST_SHARDS)] == [
        h or "this" for h in want["hosts"]]


# --- the rendezvous of two emulated hosts ------------------------------------


@pytest.fixture(scope="module")
def host_ranks():
    recs, outs, rcs = run_ranks(
        "cpu", 0.01, ("Q3", "SA", "N1"), procs=4, hosts=HOSTS,
        env={"CUDA_VISIBLE_DEVICES": ""})
    assert rcs == [0] * 4, "\n".join(o[-3000:] for o in outs)
    return recs


def test_emulated_hosts_form_one_mesh_as_the_rule_says(host_ranks):
    backend, places = host_layout([(h, 0) for h in HOSTS])
    assert backend == "gloo"
    for r, rec in enumerate(host_ranks):
        assert rec["backend"] == "gloo" and rec["coll"] == "Gloo"
        assert rec["cards"] == places[r].cards == ()
        assert rec["hosts"] == [h for h in HOSTS for _ in range(2)]
        assert rec["devices"] == ["cpu"] * 8
        assert rec["local"] == [2 * r, 2 * r + 1]
        assert "hosts=('a', 'b')" in rec["mesh"]


@pytest.mark.parametrize("local", LOCAL_SHARDS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("cls", CLASSES)
def test_collective_across_hosts_equals_in_process(host_ranks, cls, op,
                                                   dtype, local):
    for rec in host_ranks:
        assert rec["collectives"][(cls, op, dtype, local)] == {
            "equal": True, "devices": ["cpu"]}


@pytest.mark.parametrize("q", ["Q3", "SA", "N1"])
def test_rows_across_hosts_match_jax_mesh(host_ranks, jax_rows, q):
    from torch_tpch_parity import rows_match

    want = jax_rows[q]
    assert want
    for rec in host_ranks:
        got = rec["rows"][q]
        if q == "Q3":  # ORDER BY revenue, o_orderdate leaves ties unordered
            got, want = sorted(got, key=str), sorted(want, key=str)
        assert rows_match(got, want), f"{q}: {got[:3]} vs {want[:3]}"


# --- a rank that never arrives -----------------------------------------------


@pytest.mark.parametrize("absent", [2, 0], ids=["a-peer", "the-coordinator"])
def test_a_rank_that_never_arrives_is_named(absent):
    """Three ranks, one of which never starts: each of the others raises
    RanksMissing naming it, within the timeout (rank 0 absent: its
    store is never reached)."""
    coord = f"127.0.0.1:{_free_port()}"
    got = {}

    def rank(r):
        t = time.monotonic()
        try:
            init_multihost(coord, num_processes=3, process_id=r,
                           timeout_s=MISSING_TIMEOUT_S, host=f"h{r}")
            got[r] = ("joined", time.monotonic() - t)
        except RanksMissing as e:
            got[r] = (e.missing, time.monotonic() - t, str(e))

    present = [r for r in range(3) if r != absent]
    threads = [threading.Thread(target=rank, args=(r,)) for r in present]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=4 * MISSING_TIMEOUT_S)
    assert sorted(got) == present, got
    for r in present:
        missing, elapsed, msg = got[r]
        assert missing == [absent], got
        assert f"ranks [{absent}] not heard from" in msg
        assert elapsed < MISSING_TIMEOUT_S + 1.0, got
