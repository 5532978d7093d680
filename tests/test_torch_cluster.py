"""The port's multi-host control plane (starrocks_tpu_torch/runtime/
cluster.py): heartbeat failure detection, restart hooks, the reconnect
backoff, and a REAL two-process gloo mesh running a cross-process shuffle
step — the port's counterpart of tests/test_cluster.py, held to the same
contract. Every wait is bounded."""

import time

from starrocks_tpu_torch.runtime.cluster import (
    ALIVE, DEAD, ClusterMonitor, Heartbeater,
)


def _wait_for(pred, timeout=5.0, step=0.05):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(step)
    return pred()


def test_heartbeat_failure_detection_and_restart():
    failures = []
    mon = ClusterMonitor(interval_s=0.1, miss_limit=3,
                         on_failure=failures.append)
    try:
        w1 = Heartbeater("127.0.0.1", mon.port, "w1", interval_s=0.05)
        w2 = Heartbeater("127.0.0.1", mon.port, "w2", interval_s=0.05)
        assert _wait_for(lambda: set(mon.members()) == {"w1", "w2"})
        assert all(m["state"] == ALIVE for m in mon.members().values())

        # kill w2: the watchdog must detect it and fire the restart hook
        w2.stop()
        assert _wait_for(lambda: mon.members()["w2"]["state"] == DEAD)
        assert failures == ["w2"]
        assert mon.members()["w1"]["state"] == ALIVE  # isolated failure

        # the restart hook's respawn: a new beat flips it back to ALIVE,
        # and a SECOND down transition fires the hook again
        w2b = Heartbeater("127.0.0.1", mon.port, "w2", interval_s=0.05)
        assert _wait_for(lambda: mon.members()["w2"]["state"] == ALIVE)
        w2b.stop()
        assert _wait_for(lambda: mon.members()["w2"]["state"] == DEAD)
        assert failures == ["w2", "w2"]
        w1.stop()
    finally:
        mon.close()


def test_two_process_mesh_shuffle():
    """Spawns two REAL processes that join one gloo process group (a mesh
    of 2 x 4 shards) and run a shuffle-aggregate across it; both also
    heartbeat into this process's monitor, so liveness crosses process
    boundaries too."""
    from torch_dist_worker import run_two_processes

    mon = ClusterMonitor(interval_s=0.2, miss_limit=5)
    try:
        outs, rcs = run_two_processes(extra=(mon.port,))
        joined = "\n".join(outs)
        for out, rc in zip(outs, rcs):
            assert rc == 0, out[-2000:]
        assert "proc 0: shuffle-agg ok=True" in joined, joined[-2000:]
        assert "proc 1: shuffle-agg ok=True" in joined, joined[-2000:]
        # both workers were seen alive by the cross-process heartbeat
        assert set(mon.members()) == {"worker-0", "worker-1"}
    finally:
        mon.close()


def test_monitor_bind_host_configurable():
    """The heartbeat server binds all interfaces by default (cross-host
    workers must reach /heartbeat); a loopback-only bind stays available
    for tests."""
    mon = ClusterMonitor(interval_s=0.2, miss_limit=5)
    try:
        assert mon._srv.server_address[0] == "0.0.0.0"
        w = Heartbeater("127.0.0.1", mon.port, "w1", interval_s=0.05)
        assert _wait_for(lambda: "w1" in mon.members())
        w.stop()
    finally:
        mon.close()
    lo = ClusterMonitor(interval_s=0.2, miss_limit=5,
                        bind_host="127.0.0.1")
    try:
        assert lo._srv.server_address[0] == "127.0.0.1"
    finally:
        lo.close()


def test_heartbeat_backoff_policy_fake_clock():
    """Reconnect backoff: capped exponential with jitter, reset on
    success. Pure-policy unit test — no threads, no sockets, a seeded rng
    as the fake entropy and recorded waits as the fake clock."""
    import random

    from starrocks_tpu_torch.runtime.cluster import Heartbeater

    hb = Heartbeater("127.0.0.1", 1, "w", interval_s=0.2, max_backoff_s=5.0,
                     rng=random.Random(0), autostart=False)
    # healthy: exactly the base interval, no jitter
    hb._failures = 0
    assert hb._next_delay() == 0.2
    # failures: delay in [0.5, 1.0) * min(0.2 * 2^k, 5.0), monotone cap
    prev_hi = 0.2
    for k in range(1, 12):
        hb._failures = k
        raw = min(0.2 * (2 ** k), 5.0)
        d = hb._next_delay()
        assert raw * 0.5 <= d < raw, (k, d, raw)
        assert d <= 5.0
        prev_hi = raw
    assert prev_hi == 5.0  # the ladder saturates at max_backoff_s
    # one success resets the ladder to the base interval
    hb._failures = 0
    assert hb._next_delay() == 0.2


def test_heartbeat_backoff_drives_wait_with_injected_clock():
    """End-to-end through _run with an injected wait (the fake clock):
    an unreachable coordinator produces exponentially growing, capped
    delays; a live one resets them."""
    import random

    from starrocks_tpu_torch.runtime.cluster import Heartbeater

    delays = []

    def fake_wait(d):
        delays.append(d)
        return len(delays) >= 6  # stop signal after 6 sleeps

    # port 1 refuses connections -> every beat fails
    hb = Heartbeater("127.0.0.1", 1, "w", interval_s=0.1, max_backoff_s=2.0,
                     rng=random.Random(7), autostart=False, _wait=fake_wait)
    hb._stop.is_set = lambda: len(delays) >= 6  # fake-clock stop condition
    hb._run()
    assert len(delays) == 6
    # strictly escalating failure count k=1..6: raw backoff doubles until
    # the 2.0s cap; jitter keeps each delay within [raw/2, raw)
    for k, d in enumerate(delays, start=1):
        raw = min(0.1 * (2 ** k), 2.0)
        assert raw * 0.5 <= d < raw, (k, d, raw)
    assert delays[-1] >= 0.5  # well past the base interval: it backed off

    # now a live monitor: beats succeed and the delay resets to base
    mon = ClusterMonitor(interval_s=0.2, miss_limit=5, bind_host="127.0.0.1")
    try:
        delays2 = []

        def wait2(d):
            delays2.append(d)
            return len(delays2) >= 2

        ok = Heartbeater("127.0.0.1", mon.port, "w2", interval_s=0.1,
                         autostart=False, _wait=wait2)
        ok._failures = 9  # pretend a long outage just ended
        ok._stop.is_set = lambda: len(delays2) >= 2
        ok._run()
        assert delays2 == [0.1, 0.1]  # success resets the ladder
        assert "w2" in mon.members()
    finally:
        mon.close()
