"""The port's event engine, transfer services and infrastructure
(``repro_torch.sim.{engine,transfer,infrastructure,cloud}``): the cases of
``tests/test_sim_engine.py`` on the port, and one scripted scenario run
through both packages with equal completion times, tick traffic and
bucket books."""

import numpy as np
import pytest

from repro.sim import cloud as jx_cloud
from repro.sim import engine as jx_engine
from repro.sim import infrastructure as jx_infra
from repro.sim import transfer as jx_transfer
from repro_torch.sim import cloud, engine, infrastructure, transfer
from repro_torch.sim.engine import HOUR, BaseSimulation, Schedulable
from repro_torch.sim.infrastructure import (
    GB,
    MB,
    File,
    NetworkLink,
    Site,
    StorageElement,
)
from repro_torch.sim.transfer import (
    BandwidthTransferManager,
    DurationTransferManager,
    EventDrivenTransferService,
    LinkTickTable,
)


class Ticker(Schedulable):
    def __init__(self, interval):
        super().__init__(interval=interval)
        self.fired = []

    def on_update(self, sim, now):
        self.fired.append(now)


def test_event_loop_ordering_and_intervals():
    sim = BaseSimulation()
    t = Ticker(10)
    sim.schedule(t, 0)
    order = []
    sim.call_at(25, lambda s, n: order.append(("a", n)))
    sim.call_at(5, lambda s, n: order.append(("b", n)))
    sim.run(30)
    assert t.fired == [0, 10, 20, 30]
    assert order == [("b", 5), ("a", 25)]
    assert sim.events_executed == 6 and sim.now == 30


def test_priority_then_schedule_order_and_cancel():
    sim = BaseSimulation()
    order = []
    sim.call_at(5, lambda s, n: order.append("late"), priority=1)
    sim.call_at(5, lambda s, n: order.append("first"), priority=-1)
    sim.call_at(5, lambda s, n: order.append("second"))
    gone = sim.call_at(5, lambda s, n: order.append("cancelled"))
    gone.cancel()
    assert sim.pending_events() == 3
    sim.run(5)
    assert order == ["first", "second", "late"]


def test_cannot_schedule_in_past():
    sim = BaseSimulation()
    sim.call_at(10, lambda s, n: None)
    sim.run(10)
    with pytest.raises(ValueError):
        sim.call_at(5, lambda s, n: None)


def test_engine_events_counter():
    from repro_torch.obs.metrics import get_registry

    reg = get_registry()
    before = reg.value("engine.events")
    sim = BaseSimulation()
    sim.schedule(Ticker(10), 0)
    sim.run(100)
    assert reg.value("engine.events") - before == sim.events_executed == 11


def _make_link(throughput=None, bandwidth=None, max_active=None,
               latency=0.0):
    site = Site("s1")
    src = StorageElement("SRC", site, access_latency=latency)
    dst = StorageElement("DST", site)
    return NetworkLink(src, dst, throughput=throughput, bandwidth=bandwidth,
                       max_active=max_active), src, dst


def test_event_driven_transfer_completion_time():
    sim = BaseSimulation()
    svc = EventDrivenTransferService(sim, np.random.default_rng(0))
    link, src, dst = _make_link(throughput=10 * MB, latency=60.0)
    f = File(1, 100 * MB)
    src.add_complete_replica(f)
    done_at = []
    svc.submit(f, link, on_complete=lambda s, n, t: done_at.append(n))
    sim.run(HOUR)
    assert done_at == [70]  # 60 s latency + 10 s transfer
    assert dst.has_complete(1)
    assert link.traffic == f.size
    with pytest.raises(ValueError, match="throughput"):
        svc.submit(File(2, MB), _make_link(bandwidth=10 * MB)[0])


def test_max_active_queue_fifo():
    sim = BaseSimulation()
    svc = EventDrivenTransferService(sim, np.random.default_rng(0))
    link, src, dst = _make_link(throughput=10 * MB, max_active=2)
    order = []
    for i in range(5):
        f = File(i, 100 * MB)
        src.add_complete_replica(f)
        svc.submit(f, link, on_complete=lambda s, n, t: order.append(t.file.fid))
    assert link.active == 2 and link.queued == 3
    sim.run(HOUR)
    assert order == [0, 1, 2, 3, 4]
    assert link.active == 0 and link.queued == 0


def test_queue_keying_not_shared_across_same_named_links():
    """Two sites' TAPE->DISK links must not share a queue."""
    sim = BaseSimulation()
    svc = EventDrivenTransferService(sim, np.random.default_rng(0))
    l1, s1, _ = _make_link(throughput=10 * MB, max_active=1)
    l2, s2, _ = _make_link(throughput=10 * MB, max_active=1)
    assert l1.name == l2.name  # same names by construction
    for i, (link, src) in enumerate([(l1, s1), (l2, s2)] * 2):
        f = File(i, 50 * MB)
        src.add_complete_replica(f)
        svc.submit(f, link)
    sim.run(HOUR)
    assert l1.active == 0 and l2.active == 0
    assert max(l1.queued, l2.queued) == 0


def test_tick_manager_matches_event_driven_for_throughput_links():
    """The analytic path reproduces the tick manager's completion times."""
    rng = np.random.default_rng(3)
    sizes = rng.exponential(200 * MB, 40).clip(10 * MB, 2 * GB)

    def run(tick: bool):
        sim = BaseSimulation()
        link, src, dst = _make_link(throughput=25 * MB, max_active=5)
        times = {}
        if tick:
            mgr = BandwidthTransferManager(interval=1, rng=rng)
            sim.schedule(mgr, 0)
        else:
            mgr = EventDrivenTransferService(sim, rng)
        for i, sz in enumerate(sizes):
            f = File(i, float(sz))
            src.add_complete_replica(f)
            cb = lambda s, n, t: times.__setitem__(t.file.fid, n)  # noqa: E731
            if tick:
                mgr.submit(sim, f, link, on_complete=cb)
            else:
                mgr.submit(f, link, on_complete=cb)
        sim.run(6 * HOUR)
        return times

    t_tick, t_event = run(True), run(False)
    assert set(t_tick) == set(t_event)
    # the tick manager grants queued successors their slot only at tick
    # boundaries, up to 1 s late per hop; 40 transfers over 5 slots chain
    # 8 deep
    for fid in t_tick:
        assert abs(t_tick[fid] - t_event[fid]) <= 12


def test_bandwidth_sharing_divides_rate():
    sim = BaseSimulation()
    mgr = BandwidthTransferManager(interval=1)
    link, src, dst = _make_link(bandwidth=100 * MB)
    done = {}
    for i in range(4):
        f = File(i, 100 * MB)
        src.add_complete_replica(f)
        mgr.submit(sim, f, link,
                   on_complete=lambda s, n, t: done.__setitem__(t.file.fid, n))
    sim.schedule(mgr, 0)
    sim.run(HOUR)
    # 4 transfers share 100 MB/s -> each runs at 25 MB/s -> ~4 s
    assert all(3 <= v <= 5 for v in done.values())
    assert link.rate_per_transfer(0) == 100 * MB
    assert link.rate_per_transfer(4) == 25 * MB


def test_duration_manager_completes_on_schedule():
    sim = BaseSimulation()
    mgr = DurationTransferManager(duration=30, interval=1)
    link, src, dst = _make_link(throughput=1 * MB)
    f = File(1, 500 * MB)
    src.add_complete_replica(f)
    done = []
    mgr.submit(sim, f, link, on_complete=lambda s, n, t: done.append(n))
    sim.schedule(mgr, 0)
    sim.run(100)
    assert done and abs(done[0] - 30) <= 1


def test_storage_element_limit_enforced():
    site = Site("s")
    se = StorageElement("DISK", site, limit=100 * MB)
    se.add_complete_replica(File(1, 80 * MB))
    assert not se.can_allocate(30 * MB)
    with pytest.raises(RuntimeError):
        se.allocate(File(2, 30 * MB))
    with pytest.raises(ValueError, match="already"):
        se.allocate(File(1, 1 * MB))
    se.delete(1)
    assert se.used == 0
    with pytest.raises(ValueError, match="exactly one"):
        NetworkLink(se, se)


def test_link_tick_table_from_links():
    site = Site("s")
    tape = StorageElement("TAPE", site, access_latency=1800.0)
    disk = StorageElement("DISK", site)
    links = [NetworkLink(tape, disk, throughput=22.62e6, max_active=100),
             NetworkLink(disk, tape, bandwidth=5e8)]
    table = LinkTickTable.from_links(links)
    assert len(table) == 2
    assert table.mode.tolist() == [1, 0]
    assert table.slots[0] == 100 and np.isinf(table.slots[1])
    assert table.latency.tolist() == [1800.0, 0.0]
    assert infrastructure.link_table(links)[("TAPE", "DISK")] is links[0]


# -- one scripted scenario through both packages ------------------------------

def _scripted(pkg, seed: int = 11):
    """Two sites feed one bucket and read it back: a latency-sampled tape
    on shared and per-transfer links, all under a tick manager, through a
    month boundary. Returns what each package's run records."""
    eng, infra, tr, cl = pkg
    rng = np.random.default_rng(seed)
    sim = eng.BaseSimulation(seed=seed)
    mgr = tr.BandwidthTransferManager(interval=30, rng=rng)
    bucket_site = infra.Site("GCS")
    bucket = cl.GCSBucket("BUCKET", bucket_site)
    out = {"done": [], "traffic": [], "bills": None}
    links = []
    for k in range(2):
        site = infra.Site(f"Site-{k + 1}")
        tape = infra.StorageElement(
            "TAPE", site, access_latency=600.0,
            latency_sampler=lambda r: float(np.clip(r.normal(600.0, 200.0),
                                                    0, 5400)))
        disk = infra.StorageElement("DISK", site, limit=5e13)
        links.append(infra.NetworkLink(tape, disk, bandwidth=4e8,
                                       max_active=7))
        links.append(infra.NetworkLink(disk, bucket, throughput=5e7,
                                       max_active=5))
        links.append(infra.NetworkLink(bucket, disk, throughput=3e7))
    sizes = rng.exponential(2e10, 90).clip(1e7, 1.3e11)

    def record(s, n, t):
        out["done"].append((n, t.file.fid, t.link.name, t.duration))

    fid = 0
    for i, size in enumerate(sizes):
        link = links[i % len(links)]
        f = infra.File(fid, float(size))
        link.src.add_complete_replica(f)
        when = int(i * 3600)
        sim.call_at(when, lambda s, n, f=f, link=link:
                    mgr.submit(s, f, link, on_complete=record))
        fid += 1

    class Probe(eng.Schedulable):
        def on_update(self, s, n):
            out["traffic"].append((n, mgr.tick_traffic))

    sim.schedule(mgr, 0)
    sim.schedule(Probe(interval=30, priority=1), 0)
    sim.run(35 * 86400)
    out["bills"] = [(b.storage_usd, b.network_usd, b.ops_usd)
                    for b in bucket.finalize(35 * 86400)]
    out["raw"] = list(bucket.monthly_raw)
    out["deltas"] = list(bucket.volume_deltas)
    out["events"] = sim.events_executed
    out["links"] = [(ln.traffic, ln.active, ln.queued) for ln in links]
    return out


def test_scripted_scenario_bitwise_to_reference():
    want = _scripted((jx_engine, jx_infra, jx_transfer, jx_cloud))
    got = _scripted((engine, infrastructure, transfer, cloud))
    assert len(got["done"]) == 90
    assert got["done"] == want["done"]
    assert got["traffic"] == want["traffic"]
    assert got["bills"] == want["bills"] and len(got["bills"]) == 2
    assert got["raw"] == want["raw"]
    assert got["deltas"] == want["deltas"]
    assert got["events"] == want["events"]
    assert got["links"] == want["links"]


def test_gcs_bucket_books():
    site = Site("GCS")
    b = cloud.GCSBucket("B", site)
    b.add_complete_replica(File(1, 2e12))
    b.record_ingress(0, 2e12)
    b.record_egress(cloud.MONTH_SECONDS + 10, 1e12)
    b.record_delete(cloud.MONTH_SECONDS + 20, 2e12)
    b.delete(1)
    bills = b.finalize(2 * cloud.MONTH_SECONDS + 5)
    assert b.full_months_closed == 2 and len(bills) == 2
    assert b.monthly_raw[0] == (2e12 / 1e9 * cloud.MONTH_SECONDS, 0.0, 1, 0)
    assert b.monthly_raw[1][1:] == (1e12, 1, 1)
    assert bills[1].total == pytest.approx(
        bills[1].storage_usd + bills[1].network_usd + bills[1].ops_usd)
    assert b.volume_deltas == [(0, 2e12), (cloud.MONTH_SECONDS + 20, -2e12)]
