"""Port counterpart of tests/test_workgroups.py, run against
starrocks_tpu_torch on the CPU (`device="cpu"`). Resource groups + admission control (runtime/workgroup.py).

Reference behavior modeled: be/src/compute_env/workgroup/work_group.h:145
(group limits, big-query caps) + fe qe/scheduler/slot/SlotManager.java
(slot queueing and timeouts). pandas-free: the assertions are about
admission behavior, not results.
"""

import threading
import time

import pytest

from starrocks_tpu_torch.runtime.config import config
from starrocks_tpu_torch.runtime.session import Session as _Session
from starrocks_tpu_torch.runtime.workgroup import AdmissionError


@pytest.fixture(scope="module", autouse=True)
def _lock_witness_acyclic():
    """Teardown gate of the port's runtime lock-witness: the order graph
    of every lock this module's tests took has no cycle."""
    yield
    from starrocks_tpu_torch import lockdep as _lockdep

    cycles = _lockdep.WITNESS.order_cycles()
    assert not cycles, _lockdep.WITNESS.render(cycles)


def Session(*args, **kwargs):
    """The port's Session on the CPU (its entry points default to the
    card)."""
    kwargs.setdefault("device", "cpu")
    return _Session(*args, **kwargs)



def _mk():
    s = Session()
    s.sql("create table wt (a int, b int)")
    s.sql("insert into wt values (1, 10), (2, 20), (3, 30), (4, 40)")
    return s


def test_create_show_drop_and_set():
    s = _mk()
    s.sql("create resource group rg1 with (concurrency_limit = 2, "
          "max_scan_rows = 1000, cpu_weight = 5)")
    rows = s.sql("show resource groups")
    assert rows == [("rg1", 2, 1000, 0, 5, 0, 0, 0)]
    # information_schema surface
    r = s.sql("select name, concurrency_limit, max_scan_rows from "
              "information_schema.resource_groups").rows()
    assert r == [("rg1", 2, 1000)]
    with pytest.raises(ValueError, match="already exists"):
        s.sql("create resource group rg1")
    s.sql("create or replace resource group rg1 with (concurrency_limit = 3)")
    assert s.sql("show resource groups")[0][1] == 3
    with pytest.raises(ValueError, match="unknown resource group"):
        s.sql("set resource_group = 'nope'")
    s.sql("set resource_group = 'rg1'")
    assert s.resource_group == "rg1"
    s.sql("drop resource group rg1")
    assert s.sql("show resource groups") == []
    with pytest.raises(ValueError, match="unknown"):
        s.sql("drop resource group rg1")
    s.sql("drop resource group if exists rg1")
    with pytest.raises(ValueError, match="unknown resource group propert"):
        s.sql("create resource group rg2 with (bogus_prop = 1)")


def test_big_query_limits_reject():
    s = _mk()
    s.sql("create resource group tiny with (max_scan_rows = 2)")
    s.sql("set resource_group = 'tiny'")
    with pytest.raises(AdmissionError, match="big-query limit"):
        s.sql("select sum(a) from wt")
    # DDL/small statements unaffected; clearing the group unthrottles
    s.sql("set resource_group = ''")
    assert s.sql("select count(*) from wt").rows() == [(4,)]
    s.sql("create resource group thin with (mem_limit_bytes = 8)")
    s.sql("set resource_group = 'thin'")
    with pytest.raises(AdmissionError, match="memory limit"):
        s.sql("select sum(b) from wt")


def test_concurrency_slots_throttle_and_release():
    """One slot in rg_slow: a running query (held at the dispatch
    failpoint with its slot) blocks a same-group query into the admission
    queue until timeout, while a session in ANOTHER group proceeds — the
    quota-limited group throttles, the other does not."""
    from starrocks_tpu_torch.runtime import failpoint

    s = _mk()
    reached, release = threading.Event(), threading.Event()

    def hold():
        reached.set()
        release.wait(30)

    failpoint.arm("executor::before_dispatch", action=hold, times=1)
    s.sql("create resource group rg_slow with (concurrency_limit = 1)")
    s.sql("create resource group rg_free with (concurrency_limit = 4)")

    holder = Session(s.catalog)
    holder.sql("set resource_group = 'rg_slow'")
    blocked = Session(s.catalog)
    blocked.sql("set resource_group = 'rg_slow'")
    free = Session(s.catalog)
    free.sql("set resource_group = 'rg_free'")

    config.set("query_queue_timeout_s", 0.15)
    errors, done = [], []

    def run_holder():
        done.append(holder.sql("select max(a) from wt").rows())

    t = threading.Thread(target=run_holder)
    t.start()
    assert reached.wait(10)  # holder is held at dispatch, slot taken
    try:
        with pytest.raises(AdmissionError, match="queue timeout"):
            blocked.sql("select count(*) from wt")
        # a different group is not throttled by rg_slow's slot
        assert free.sql("select count(*) from wt").rows() == [(4,)]
    finally:
        release.set()
        failpoint.disarm("executor::before_dispatch")
        t.join()
    assert done and len(done[0]) == 1
    # slot released: the blocked session now passes admission
    config.set("query_queue_timeout_s", 5.0)
    assert blocked.sql("select count(*) from wt").rows() == [(4,)]
    wm = s.workgroups()
    assert wm.timeout_total >= 1
    assert wm.running.get("rg_slow", 0) == 0
    config.set("query_queue_timeout_s", 10.0)


def test_resource_groups_survive_restart(tmp_path):
    d = str(tmp_path / "db")
    s = Session(data_dir=d)
    s.sql("create resource group keepme with (concurrency_limit = 7, "
          "max_scan_rows = 123)")
    s.sql("create resource group dropme")
    s.sql("drop resource group dropme")
    s.checkpoint_metadata()
    s.sql("create resource group tailrg with (cpu_weight = 9)")
    s2 = Session(data_dir=d)
    got = {r[0]: r for r in s2.sql("show resource groups")}
    assert got["keepme"][1] == 7 and got["keepme"][2] == 123
    assert got["tailrg"][4] == 9
    assert "dropme" not in got


def test_non_admin_cannot_manage_groups():
    s = _mk()
    s.sql("create user peasant identified by 'x'")
    s.sql("grant select on wt to peasant")
    s.current_user = "peasant"
    with pytest.raises(PermissionError):
        s.sql("create resource group sneaky")
    s.current_user = "root"
