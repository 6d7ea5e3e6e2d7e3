"""The port's QoS layer (qos/: admission, the AIMD congestion window,
tenant-fair slotting, the circuit breaker; the batcher's, pipeline's,
service's, server's and gateway's hooks) against the JAX package's, on
the CPU.

Mirrors tests/test_qos.py.  The state machines run on fake monotonic
clocks, and each scenario drives a port controller and a JAX controller
with the same inputs: windows, counters, shed reasons and breaker states
must be equal at every step.  The service scenarios feed a port Instance
and a JAX Instance (each with its native router over two shards, the JAX
one on two CPU devices, clocks pinned) the same requests and compare
every response, shed reasons included: the bounded queue under overload,
NO_BATCHING past a saturated queue, health checks, the drain, gRPC and
HTTP deadlines, the adaptive window, the config knobs and the metric
names.  Fair slotting is held on the exact order the batcher's classic
window and the pipeline's drain stage.  The JAX tests of the peer lane
(PeerClient retries, timeouts and the breaker fallback) wait for the peer
ring (ROADMAP Queue 1 item 6c); the breaker's own state machine, its
backoff schedule and the per-peer registry are held here.
"""

import asyncio
import random
import time

import numpy as np
import pytest

import gubernator_tpu  # noqa: F401  (enables x64)
import jax

from gubernator_tpu import compat
from gubernator_tpu import config as jconfig
from gubernator_tpu import qos as jqos
from gubernator_tpu import server as jserver
from gubernator_tpu.api import http_gateway as jgateway
from gubernator_tpu.api.types import RateLimitReq as JReq
from gubernator_tpu.config import Config as JConfig
from gubernator_tpu.config import QoSConfig as JQoSConfig
from gubernator_tpu.core import engine as jengine
from gubernator_tpu.core.service import Instance as JInstance
from gubernator_tpu.observability import Metrics as JMetrics
from gubernator_tpu.parallel.mesh import make_mesh
from gubernator_tpu.qos import breaker as jbreaker
from gubernator_tpu_torch import config as pconfig
from gubernator_tpu_torch import qos
from gubernator_tpu_torch import server as pserver
from gubernator_tpu_torch.api import http_gateway as pgateway
from gubernator_tpu_torch.api import pb
from gubernator_tpu_torch.api.types import (
    Behavior,
    RateLimitReq,
    Second,
    Status,
)
from gubernator_tpu_torch.config import EngineConfig, QoSConfig
from gubernator_tpu_torch.core import engine as pengine
from gubernator_tpu_torch.core.service import Instance
from gubernator_tpu_torch.observability.metrics import Metrics
from gubernator_tpu_torch.qos import breaker
from gubernator_tpu_torch.qos.admission import (
    SHED_DEADLINE,
    SHED_DRAINING,
    SHED_QUEUE_FULL,
)

pytestmark = pytest.mark.torch_port

T0 = 1_700_000_000_000
GEOMETRY = dict(capacity_per_shard=2048, batch_per_shard=128,
                global_capacity=64, global_batch_per_shard=16,
                max_global_updates=16)


class FakeClock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _qkw(**kw):
    base = dict(max_pending=8, min_window=4, max_window=64,
                target_drain_latency=0.1, aimd_increase=8.0,
                aimd_decrease=0.5, latency_ewma_alpha=1.0)
    base.update(kw)
    return base


def _congestion(**kw):
    """(port controller, JAX controller) on one fake clock."""
    clk = FakeClock()
    return (qos.CongestionController(QoSConfig(**_qkw(**kw)), now_fn=clk),
            jqos.CongestionController(JQoSConfig(**_qkw(**kw)), now_fn=clk),
            clk)


def _cstate(c):
    return (c.effective_window(), c._cwnd, c.latency_ewma, c.depth_ewma,
            c.increases, c.decreases, c.congested, c.effective_stride(),
            c.stride_increases, c.stride_decreases,
            [c.effective_depth(d) for d in (1, 3, 4)],
            c.drain_cycle_estimate())


def _same(a, b):
    assert _cstate(a) == _cstate(b)


# ---------------------------------------------------------------- congestion


def test_aimd_additive_increase_to_max():
    p, j, _ = _congestion(min_window=4, max_window=32, aimd_increase=8.0)
    for c in (p, j):
        c._cwnd = 4.0
    for _ in range(10):
        for c in (p, j):
            c.observe_drain(0.01)
        _same(p, j)
    assert p.effective_window() == 32
    assert p.increases > 0 and p.decreases == 0


def test_aimd_multiplicative_decrease_with_cooldown():
    p, j, clk = _congestion(max_window=64)
    steps = [(0.0, 0.5), (0.0, 0.5), (0.0, 0.5), (1.0, 0.5)]
    steps += [(10.0, 5.0)] * 50
    windows = []
    for dt, wall in steps:
        clk.advance(dt)
        for c in (p, j):
            c.observe_drain(wall)
        _same(p, j)
        windows.append(p.effective_window())
    assert windows[:4] == [32, 32, 32, 16]
    assert p.decreases >= 2 and windows[-1] == p.min_window


def test_aimd_recovers_after_congestion_clears():
    p, j, clk = _congestion(max_window=64, aimd_increase=8.0)
    clk.advance(1.0)
    for wall in (1.0, 0.01):
        for c in (p, j):
            c.observe_drain(wall, depth=3)
        _same(p, j)
    assert not p.congested and p.effective_window() == 40


def test_effective_depth_scales_with_cwnd():
    p, j, _ = _congestion(min_window=4, max_window=64)
    for cwnd in (64.0, 16.0, 32.0, 4.0):
        for c in (p, j):
            c._cwnd = cwnd
        _same(p, j)
    p._cwnd = 16.0
    assert p.effective_depth(4) == 1


def test_stage_estimate_and_stride_bound_follow_the_jax_controller():
    """observe_stages switches the admission's cycle estimate to the
    bottleneck stage, and stride_bound caps the chain by the deadline."""
    p, j, _ = _congestion()
    for c in (p, j):
        assert c.stride_bound(0.1) == 1 << 30
        c.observe_drain(0.02)
        c.observe_stages(0.001, 0.01, 0.02, pipelined=True)
    _same(p, j)
    assert [p.stride_bound(b) for b in (0.1, 0.015, 0.0)] == \
        [j.stride_bound(b) for b in (0.1, 0.015, 0.0)] == [8, 1, 1 << 30]


# ----------------------------------------------------------------- admission


def _admission(**kw):
    clk = FakeClock()
    out = []
    for mod, conf in ((qos, QoSConfig), (jqos, JQoSConfig)):
        cong = mod.CongestionController(conf(**_qkw(**kw)), now_fn=clk)
        out.append(mod.AdmissionController(conf(**_qkw(**kw)), cong,
                                           now_fn=clk))
    return out[0], out[1], clk


def _astate(a):
    return (a.pending, a.pending_peak, dict(a.shed_counts), a.saturated,
            a.draining, a.inflight_windows, a.estimate_wait())


def test_admission_bounded_queue():
    p, j, _ = _admission(max_pending=4)
    ops = [("admit",)] * 5 + [("release", 2), ("admit",), ("admit", 3),
                              ("release", 9), ("admit",)]
    for op in ops:
        outs = [a.try_admit(*op[1:]) if op[0] == "admit"
                else a.release(*op[1:]) for a in (p, j)]
        assert outs[0] == outs[1]
        assert _astate(p) == _astate(j)
    # sheds count decisions: 1 + 3
    assert p.shed_counts[SHED_QUEUE_FULL] == 4 and p.pending_peak == 4


def test_admission_deadline_shedding():
    p, j, clk = _admission(max_pending=100, target_drain_latency=0.1)
    for dl in (0.001, -1.0, 10.0):
        assert p.try_admit(deadline=clk() + dl) == \
            j.try_admit(deadline=clk() + dl)
    for a in (p, j):
        a.congestion.observe_drain(0.001)
        a.note_inflight(2)
    assert p.try_admit(deadline=clk() + 0.05) == \
        j.try_admit(deadline=clk() + 0.05) is None
    assert _astate(p) == _astate(j)
    assert p.shed_counts[SHED_DEADLINE] == 2


def test_admission_draining_and_record_shed():
    p, j, _ = _admission()
    for a in (p, j):
        a.close_intake()
    assert p.try_admit() == j.try_admit() == SHED_DRAINING
    for a in (p, j):
        a.open_intake()
        a.record_shed("breaker_open", 2)
    assert p.try_admit() == j.try_admit() is None
    assert _astate(p) == _astate(j)


def test_shed_response_shape():
    r = RateLimitReq(name="t", unique_key="k", hits=1, limit=7,
                     duration=Second)
    jr = JReq(name="t", unique_key="k", hits=1, limit=7, duration=Second)
    got, want = qos.shed_response(r, SHED_QUEUE_FULL), \
        jqos.shed_response(jr, SHED_QUEUE_FULL)
    assert (int(got.status), got.limit, got.remaining, got.reset_time,
            got.error, got.metadata) == \
        (int(want.status), want.limit, want.remaining, want.reset_time,
         want.error, want.metadata)
    assert got.status == Status.OVER_LIMIT
    assert got.metadata == {"shed": "true", "shed_reason": "queue_full"}


# ------------------------------------------------------------------ fairness


def test_interleave_round_robin_stable_within_tenant():
    rng = np.random.default_rng(3)
    for _ in range(20):
        items = [(str(rng.choice(list("abcd"))), i)
                 for i in range(int(rng.integers(0, 30)))]
        got = qos.interleave_by_tenant(items, lambda it: it[0])
        assert got == jqos.interleave_by_tenant(items, lambda it: it[0])
        for t in "abcd":
            sub = [i for tt, i in got if tt == t]
            assert sub == sorted(sub)
    items = [("a", 1), ("a", 2), ("a", 3), ("b", 1), ("b", 2), ("c", 1)]
    assert qos.interleave_by_tenant(items, lambda it: it[0]) == \
        [("a", 1), ("b", 1), ("c", 1), ("a", 2), ("b", 2), ("a", 3)]


def test_interleave_single_tenant_passthrough_and_weights():
    items = [("a", i) for i in range(5)]
    assert qos.interleave_by_tenant(items, lambda it: it[0]) == items
    mixed = [("a", i) for i in range(4)] + [("b", i) for i in range(2)]
    w = lambda t: 2 if t == "a" else 1  # noqa: E731
    got = qos.interleave_by_tenant(mixed, lambda it: it[0], weight_of=w)
    assert got == jqos.interleave_by_tenant(mixed, lambda it: it[0],
                                            weight_of=w)
    assert got == [("a", 0), ("a", 1), ("b", 0), ("a", 2), ("a", 3),
                   ("b", 1)]


# ------------------------------------------------------------------- breaker


def _breakers(**kw):
    clk = FakeClock()
    states = ([], [])
    return (breaker.CircuitBreaker(now_fn=clk, on_state_change=states[0].append,
                                   **kw),
            jbreaker.CircuitBreaker(now_fn=clk,
                                    on_state_change=states[1].append, **kw),
            clk, states)


def _drive_breakers(p, j, clk, script):
    for op, arg in script:
        if op == "advance":
            clk.advance(arg)
            continue
        outs = [getattr(b, op)() for b in (p, j)]
        assert outs[0] == outs[1], op
        assert (p.state, p._failures, p._probes_in_flight) == \
            (j.state, j._failures, j._probes_in_flight)


def test_breaker_trips_and_recovers_through_half_open():
    p, j, clk, states = _breakers(fail_threshold=3, open_duration=2.0,
                                  half_open_probes=1)
    f, s, a = ("record_failure", 0), ("record_success", 0), ("allow", 0)
    _drive_breakers(p, j, clk, [f, f, s, f, f, f, a, ("advance", 2.0), a, a,
                                s, a])
    assert states[0] == states[1] == [breaker.OPEN, breaker.HALF_OPEN,
                                      breaker.CLOSED]


def test_breaker_half_open_failure_reopens_and_external_authority():
    p, j, clk, states = _breakers(fail_threshold=1, open_duration=1.0)
    f, a = ("record_failure", 0), ("allow", 0)
    _drive_breakers(p, j, clk, [f, ("advance", 1.0), a, f, a,
                                ("advance", 1.0), a, ("trip", 0), a,
                                ("reset", 0), a])
    assert states[0] == states[1]
    assert p.state == breaker.CLOSED


def test_backoff_delays_jittered_and_capped():
    got = list(breaker.backoff_delays(5, 0.025, 0.1, rng=random.Random(7)))
    want = list(jbreaker.backoff_delays(5, 0.025, 0.1, rng=random.Random(7)))
    assert got == want and len(got) == 5
    assert all(0 < d <= 0.1 for d in got)


def test_qos_manager_breakers_and_deadlines():
    """QoSManager: per-peer breakers minted from the config (the
    latest mint wins in the registry), deadlines from a client timeout
    with the configured default, and fail_open."""
    clk = FakeClock()
    kw = _qkw(breaker_fail_threshold=2, breaker_open_duration=5.0,
              default_deadline=0.25, fail_open=False)
    p = qos.QoSManager(QoSConfig(**kw), now_fn=clk)
    j = jqos.QoSManager(JQoSConfig(**kw), now_fn=clk)
    for m in (p, j):
        b = m.make_breaker("10.0.0.9:81")
        b.record_failure()
        b.record_failure()
    assert p.breakers["10.0.0.9:81"].state == \
        j.breakers["10.0.0.9:81"].state == breaker.OPEN
    for t in (None, 0, -1.0, float("inf"), 0.5):
        assert p.deadline_from_timeout(t) == j.deadline_from_timeout(t)
    assert p.deadline_from_timeout(None) == clk() + 0.25
    assert p.fail_open is j.fail_open is False
    with pytest.raises(ValueError):
        qos.QoSManager(QoSConfig(aimd_decrease=1.5))


# ------------------------------------------------------- service integration


@pytest.fixture
def pair(monkeypatch):
    """make(qos_conf kwargs, native=True) -> (port Instance, JAX
    Instance), the JAX one on two CPU devices, shard_map's replication
    check off and the engines' and batchers' clocks pinned at T0."""
    monkeypatch.setattr(
        jengine, "_compat_shard_map",
        lambda f, **kw: compat.shard_map(f, **{**kw, "check_vma": False}))
    for mod in (jengine, pengine):
        monkeypatch.setattr(mod, "millisecond_now", lambda: T0)
    _clear()
    made = []

    def make(native=True, metrics=False, **qkw):
        use = "on" if native else False
        port = Instance(engine_config=EngineConfig(**GEOMETRY, num_shards=2,
                                                   use_native=use),
                        device="cpu", qos=QoSConfig(**qkw),
                        metrics=Metrics() if metrics else None)
        mesh = make_mesh(jax.devices("cpu")[2:4])
        eng = jengine.RateLimitEngine(mesh=mesh, use_native=use, **GEOMETRY)
        ref = JInstance(JConfig(qos=JQoSConfig(**qkw)), engine=eng,
                        metrics=JMetrics())
        for inst in (port, ref):
            inst.batcher.now_fn = lambda: T0
            if inst.batcher.pipeline is not None:
                inst.batcher.pipeline.now_fn = lambda: T0
        made.extend((port, ref))
        return port, ref
    yield make
    for inst in made:
        inst.close()
    _clear()


def _clear():
    for v in vars(jengine).values():
        if callable(getattr(v, "cache_clear", None)):
            v.cache_clear()


def _req(key, name="tenant", hits=1, limit=1000, behavior=Behavior.BATCHING):
    return RateLimitReq(name=name, unique_key=key, hits=hits, limit=limit,
                        duration=60 * Second, behavior=behavior)


def _jreqs(reqs):
    return [JReq(name=r.name, unique_key=r.unique_key, hits=r.hits,
                 limit=r.limit, duration=r.duration, algorithm=r.algorithm,
                 behavior=r.behavior) for r in reqs]


def _tuples(resps):
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error,
             dict(r.metadata or {})) for r in resps]


async def _ask(port, ref, reqs, deadline=None):
    got = await port.get_rate_limits(reqs, deadline=deadline)
    want = await ref.get_rate_limits(_jreqs(reqs), deadline=deadline)
    assert _tuples(got) == _tuples(want)
    return got


def test_overload_bounded_queue_goodput_and_inband_sheds(pair):
    """Sustained 5x overload on the classic lane: the bounded queue never
    passes its cap, every shed is in-band with its reason, every admitted
    request completes, goodput holds, and both Instances shed the same
    items and answer the rest alike."""
    cap = 64
    port, ref = pair(native=False, max_pending=cap, min_window=16,
                     max_window=4096, target_drain_latency=0.25)

    async def body():
        served = {1: 0, 5: 0}
        wall = {1: 0.0, 5: 0.0}
        for mult in (1, 5):
            for i in range(3):
                reqs = [_req(f"k{mult}-{i}-{n}") for n in range(mult * cap)]
                t0 = time.monotonic()
                got = await _ask(port, ref, reqs)
                wall[mult] += time.monotonic() - t0
                shed = [r for r in got if r.metadata.get("shed_reason")]
                served[mult] += len(got) - len(shed)
                if mult == 1:
                    assert not shed
                for r in shed:
                    assert r.status == Status.OVER_LIMIT and r.error == ""
                    assert r.metadata == {"shed": "true",
                                          "shed_reason": SHED_QUEUE_FULL}
        for inst in (port, ref):
            adm = inst.qos.admission
            assert adm.pending_peak <= cap and adm.pending == 0
        assert served[1] == 3 * cap and served[5] >= 3 * cap
        assert served[5] / wall[5] >= 0.5 * served[1] / wall[1]
        assert port.qos.admission.shed_counts == \
            ref.qos.admission.shed_counts
    asyncio.run(body())


def test_no_batching_jumps_window_while_admission_saturated(pair):
    port, ref = pair(max_pending=4)

    async def body():
        for inst in (port, ref):
            inst.qos.admission.pending = 4  # pin the batched lane shut
        shed = (await _ask(port, ref, [_req("batched")]))[0]
        assert shed.metadata["shed_reason"] == SHED_QUEUE_FULL
        jumped = (await _ask(port, ref, [_req(
            "urgent", behavior=Behavior.NO_BATCHING)]))[0]
        assert not jumped.metadata and jumped.remaining == 999
        for inst in (port, ref):
            inst.qos.admission.pending = 0
    asyncio.run(body())


def test_health_check_reflects_saturation_and_draining(pair):
    port, ref = pair(max_pending=4)

    async def body():
        async def both():
            h = [await port.health_check(), await ref.health_check()]
            assert (h[0].status, h[0].message, h[0].peer_count) == \
                (h[1].status, h[1].message, h[1].peer_count)
            return h[0]
        assert (await both()).status == "healthy"
        for inst in (port, ref):
            inst.qos.admission.pending = 4
        h = await both()
        assert h.status == "unhealthy" and "saturated" in h.message
        for inst in (port, ref):
            inst.qos.admission.pending = 0
            inst.qos.admission.close_intake()
        h = await both()
        assert h.status == "unhealthy" and "draining" in h.message
    asyncio.run(body())


def test_drain_closes_intake_and_waits_for_pending(pair):
    """drain(): intake closes first (later requests shed with reason
    draining), then it waits for admitted decisions, bounded by its
    timeout, on an injectable clock."""
    port, ref = pair()

    async def body():
        clk = FakeClock()

        async def tick(_):
            clk.advance(0.5)
        for inst in (port, ref):
            inst.qos.admission.pending = 3  # admitted, not resolved
        outs = [await inst.drain(timeout=1.0, now_fn=clk, sleep=tick)
                for inst in (port, ref)]
        assert outs == [False, False]
        for inst in (port, ref):
            inst.qos.admission.pending = 0
        outs = [await inst.drain(timeout=1.0) for inst in (port, ref)]
        assert outs == [True, True]
        r = (await _ask(port, ref, [_req("late")]))[0]
        assert r.metadata["shed_reason"] == SHED_DRAINING
        assert port.qos.admission.shed_counts == \
            ref.qos.admission.shed_counts == {SHED_DRAINING: 1}
    asyncio.run(body())


class _Ctx:
    def __init__(self, remaining):
        self.remaining = remaining

    def time_remaining(self):
        return self.remaining

    async def abort(self, *a):  # pragma: no cover
        raise AssertionError(f"abort not expected: {a}")


@pytest.mark.parametrize("remaining,reason", [(0.001, SHED_DEADLINE),
                                              (30.0, None)])
def test_grpc_deadline_sheds_with_metadata_on_wire(pair, remaining, reason):
    """The gRPC deadline reaches admission: a context with about no time
    left sheds with reason deadline, and the reason survives the proto
    encoding; both servers answer the same bytes."""
    port, ref = pair(target_drain_latency=0.2)
    data = pb.GetRateLimitsReq(requests=[pb.req_to_pb(
        _req("deadline-key"))]).SerializeToString()

    async def body():
        outs = [await pserver.serve_get_rate_limits(port, data,
                                                    _Ctx(remaining)),
                await jserver.serve_get_rate_limits(ref, data,
                                                    _Ctx(remaining))]
        assert outs[0] == outs[1]
        resp = pb.GetRateLimitsResp.FromString(outs[0]).responses[0]
        assert resp.metadata.get("shed_reason") == reason
        if reason:
            assert resp.status == int(Status.OVER_LIMIT)
    asyncio.run(body())


def test_adaptive_window_replaces_static_batch_limit(pair):
    port, ref = pair(min_window=16, max_window=4096)
    for cwnd, want in ((8192.0, 1000), (32.0, 32), (1.0, 16)):
        for inst in (port, ref):
            inst.qos.congestion._cwnd = cwnd
        assert port.batcher._window_limit() == \
            ref.batcher._window_limit() == want


def test_qos_config_from_env(monkeypatch):
    for k in [k for k in list(__import__("os").environ)
              if k.startswith("GUBER_")]:
        monkeypatch.delenv(k)
    for k, v in (("GUBER_QOS_MAX_PENDING", "123"),
                 ("GUBER_QOS_TARGET_DRAIN_MS", "50"),
                 ("GUBER_QOS_BREAKER_FAILURES", "7"),
                 ("GUBER_QOS_FAIL_OPEN", "false"),
                 ("GUBER_QOS_DEFAULT_DEADLINE_MS", "1500"),
                 ("GUBER_QOS_MIN_WINDOW", "32"),
                 ("GUBER_QOS_PEER_RETRIES", "0")):
        monkeypatch.setenv(k, v)
    import dataclasses
    got = pconfig.config_from_env().qos
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(jconfig.config_from_env().qos)
    assert got.max_pending == 123 and got.fail_open is False
    assert got.target_drain_latency == pytest.approx(0.05)
    assert got.default_deadline == pytest.approx(1.5)
    monkeypatch.setenv("GUBER_QOS_AIMD_DECREASE", "1.5")
    for mod in (pconfig, jconfig):
        with pytest.raises(ValueError, match="aimd_decrease"):
            mod.config_from_env()


def test_qos_metrics_exposed(pair):
    port, ref = pair(metrics=True, max_pending=16)
    for inst in (port, ref):
        inst.qos.admission.record_shed(SHED_QUEUE_FULL)
    texts = [inst.metrics.expose().decode() for inst in (port, ref)]
    for line in ("guber_qos_queue_depth 0.0",
                 'guber_qos_shed_total{reason="queue_full"} 1.0',
                 "guber_qos_effective_window 8192.0",
                 "guber_qos_drain_latency_ewma_seconds 0.0",
                 "guber_qos_drain_depth_ewma 0.0",
                 "guber_tpu_lease_held_slots 0.0"):
        assert all(line in t for t in texts), line


def test_sheds_reach_the_slo_engine_with_or_without_a_registry():
    """A shed is SLO evidence: the admission controller feeds the SLO
    engine once, with or without a registry; a registry only counts it."""
    from gubernator_tpu_torch.config import SLOConfig
    for metrics in (None, Metrics()):
        inst = Instance(engine_config=EngineConfig(**GEOMETRY), device="cpu",
                        slo=SLOConfig(enabled=True), metrics=metrics,
                        qos=QoSConfig(max_pending=1))
        try:
            inst.qos.admission.pending = 1
            out = asyncio.run(inst.get_rate_limits([_req("a"), _req("b")]))
            assert [r.metadata["shed_reason"] for r in out] == \
                [SHED_QUEUE_FULL] * 2
            buckets = inst.slo._buckets["shed_rate"]
            assert sum(b for _, _, b in buckets) == 2
            if metrics is not None:
                assert metrics.qos_shed.labels(
                    reason=SHED_QUEUE_FULL)._value.get() == 2
        finally:
            inst.close()


# -------------------------------------------------------------- fair slots


def test_classic_window_is_tenant_fair_and_capped(pair, monkeypatch):
    """The classic lane's flush interleaves its window across tenants and
    cuts it to the congestion window, as the JAX batcher does: the same
    windows, in the same order."""
    port, ref = pair(native=False, min_window=4, max_window=64)
    seen = {"port": [], "jax": []}
    for name, inst in (("port", port), ("jax", ref)):

        async def record(window, *a, _n=name):
            seen[_n].append([(w[0].name, w[0].unique_key) for w in window])
            for w in window:
                w[2].set_result(None)
        monkeypatch.setattr(inst.batcher, "_run_window", record)
    reqs = ([_req(f"a{i}", name="A") for i in range(4)]
            + [_req(f"b{i}", name="B") for i in range(3)]
            + [_req("c0", name="C")])

    async def body():
        for name, inst, rs in (("port", port, reqs), ("jax", ref,
                                                       _jreqs(reqs))):
            tasks = [asyncio.ensure_future(inst.batcher.submit(r))
                     for r in rs]
            await asyncio.sleep(0)
            # the window shrinks after the requests queued
            inst.qos.congestion._cwnd = 5.0
            inst.batcher._flush()
            await asyncio.sleep(0.05)
            for t in tasks:
                t.cancel()
    asyncio.run(body())
    assert seen["port"] == seen["jax"]
    assert seen["port"] == [[("A", "a0"), ("B", "b0"), ("C", "c0"),
                             ("A", "a1"), ("B", "b1")],
                            [("A", "a2"), ("B", "b2"), ("A", "a3")]]


def test_pipeline_drain_is_tenant_fair_and_budgeted(pair):
    """The pipeline's drain takes its singles tenant-interleaved and cut
    to the congestion window's budget; the tail waits for the next drain
    in the new columns.  The jobs equal the JAX pipeline's."""
    port, ref = pair(min_window=4, max_window=64)
    reqs = ([_req(f"a{i}", name="A", limit=100 + i) for i in range(5)]
            + [_req(f"b{i}", name="B", limit=200 + i) for i in range(2)])

    async def body():
        loop = asyncio.get_running_loop()
        out = []
        for inst, rs, jax_side in ((port, reqs, False),
                                   (ref, _jreqs(reqs), True)):
            p = inst.batcher.pipeline
            inst.qos.congestion._cwnd = 4.0
            for k, r in enumerate(rs):
                fut = loop.create_future()
                i = p._cols.append(r)
                p._singles.append((r, fut, 0.0, None, i) if jax_side
                                  else (r, fut, k, 0.0, None, i))
            jobs, cols = p._take_jobs()
            job_keys = [[q.unique_key for q in j.reqs] for j in jobs]
            job_cols = [np.asarray(j._cols[2]).tolist() for j in jobs]
            tail = [t[0].unique_key for t in p._singles]
            # the tail's columns, where the next drain will read them
            tail_cols = [(p._cols.keys[t[-1]], int(p._cols.limit[t[-1]]),
                          int(p._cols.hits[t[-1]])) for t in p._singles]
            assert tail_cols == [(q.hash_key().encode(), q.limit, q.hits)
                                 for q in (t[0] for t in p._singles)]
            out.append((job_keys, job_cols, tail, tail_cols))
            for t in p._singles:
                t[1].cancel()
            for j in jobs:
                for f in j.futs:
                    f.cancel()
            p._singles = []
        assert out[0] == out[1]
        assert out[0][0] == [["a0", "b0", "a1", "b1"]]
        assert out[0][2] == ["a2", "a3", "a4"]
    asyncio.run(body())


# -------------------------------------------------------------- HTTP gateway


def test_http_gateway_shed_metadata_end_to_end(pair):
    """Shed responses carry shed_reason through the gateway's proto3-JSON
    mapping, for queue_full and for a deadline from X-Guber-Timeout-Ms,
    and a malformed header is a 400; both gateways answer alike."""
    from aiohttp.test_utils import TestClient, TestServer
    port, ref = pair(max_pending=4, target_drain_latency=0.2)
    payload = {"requests": [{"name": "http_qos", "uniqueKey": "acct:1",
                             "hits": "1", "limit": "5",
                             "duration": "60000"}]}

    async def body():
        clients = [TestClient(TestServer(pgateway.build_app(port))),
                   TestClient(TestServer(jgateway.build_app(ref)))]
        for c in clients:
            await c.start_server()
        try:
            async def post(headers=None, pending=0):
                outs = []
                for c, inst in zip(clients, (port, ref)):
                    inst.qos.admission.pending = pending
                    r = await c.post("/v1/GetRateLimits", json=payload,
                                     headers=headers or {})
                    inst.qos.admission.pending = 0
                    outs.append((r.status, await r.json()))
                assert outs[0] == outs[1]
                return outs[0]
            status, data = await post()
            assert "shed_reason" not in str(data)
            status, data = await post(pending=4)
            md = data["responses"][0]["metadata"]
            assert md == {"shed": "true", "shed_reason": "queue_full"}
            assert data["responses"][0]["status"] == "OVER_LIMIT"
            status, data = await post({"X-Guber-Timeout-Ms": "1"})
            assert data["responses"][0]["metadata"]["shed_reason"] == \
                "deadline"
            status, data = await post({"X-Guber-Timeout-Ms": "nan ms"})
            assert status == 400
        finally:
            for c in clients:
                await c.close()
    asyncio.run(body())


def test_cut_window_rest_flushes_where_the_jax_batcher_strands_it(pair):
    """A fault of the reference the port does not copy (ROADMAP Queue 3):
    when the interval's tick flushes a classic window longer than the
    congestion window, the flush cuts it and re-arms the interval from
    inside the waiting task, which then returns, so the JAX batcher leaves
    the rest queued until more requests fill a window.  The port's waiter
    flushes the rest at the next tick.  Three requests queue, the window
    shrinks to 2 before the tick: the port answers all three, the JAX
    batcher two."""
    port, ref = pair(native=False, min_window=2, max_window=64)
    reqs = [_req(f"cut{i}") for i in range(3)]

    async def body():
        outs = []
        for inst, rs in ((port, reqs), (ref, _jreqs(reqs))):
            tasks = [asyncio.ensure_future(inst.batcher.submit(r))
                     for r in rs]
            await asyncio.sleep(0)
            inst.qos.congestion._cwnd = 2.0
            # the first window (a first JAX window compiles for seconds)
            await asyncio.wait(tasks[:2], timeout=60.0)
            # then one more tick and more
            await asyncio.wait(tasks[2:], timeout=1.0)
            outs.append([t.done() for t in tasks])
            for t in tasks:
                if t.done():
                    assert t.result().remaining == 999
                else:
                    t.cancel()
        assert outs == [[True] * 3, [True, True, False]]
    asyncio.run(body())
