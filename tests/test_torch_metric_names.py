"""The port's metric surface against the JAX package's
(tests/test_metric_names.py): every family of the JAX `Metrics`, with its
type, label set and buckets, exists in the port's `Metrics`; the port
registers nothing twice and nothing outside its own registry; every
collector is fed somewhere in the port; and the stage histogram keys on
the canonical stage names."""

import os
import re
import time

import pytest
from prometheus_client.metrics import MetricWrapperBase

from gubernator_tpu.observability.metrics import Metrics as JMetrics
from gubernator_tpu_torch.observability.metrics import STAGES, Metrics

pytestmark = pytest.mark.torch_port


def _families(m) -> dict:
    """family name -> (type, label names, histogram upper bounds)."""
    out = {}
    for v in vars(m).values():
        if isinstance(v, MetricWrapperBase):
            out[v._name] = (v._type, tuple(v._labelnames),
                            tuple(getattr(v, "_upper_bounds", ())))
    return out


_JAX_FAMILIES = sorted(_families(JMetrics()))


@pytest.mark.parametrize("name", _JAX_FAMILIES)
def test_jax_family_exists_with_the_same_labels(name):
    want = _families(JMetrics())[name]
    got = _families(Metrics()).get(name)
    assert got == want, f"{name}: port {got}, JAX {want}"


def test_port_has_no_family_the_jax_package_lacks():
    extra = set(_families(Metrics())) - set(_JAX_FAMILIES)
    assert not extra, f"families only the port has: {sorted(extra)}"


def test_exposition_names_match_the_jax_package():
    def names(m):
        return sorted(re.findall(r"^# TYPE (\S+) ", m.expose().decode(),
                                 re.M))
    assert names(Metrics()) == names(JMetrics())


def test_reference_series_shapes():
    """Label sets and units of the reference's series, as JAX
    test_metric_names.py:test_reference_series_shapes."""
    m = Metrics()
    m.cache_size.set(3)
    m.cache_access_count.labels(type="hit").inc()
    m.cache_access_count.labels(type="miss").inc(2)
    m.async_durations.observe(0.01)
    m.broadcast_durations.observe(0.02)
    m.observe_rpc("/pb.gubernator.V1/GetRateLimits",
                  start=time.monotonic(), ok=True)
    m.observe_rpc("/pb.gubernator.V1/GetRateLimits",
                  start=time.monotonic(), ok=False)
    g = m.registry.get_sample_value
    assert g("cache_size") == 3.0
    assert g("cache_access_count_total", {"type": "hit"}) == 1.0
    assert g("cache_access_count_total", {"type": "miss"}) == 2.0
    assert g("async_durations_count") == 1.0
    assert g("broadcast_durations_count") == 1.0
    method = {"method": "/pb.gubernator.V1/GetRateLimits"}
    assert g("grpc_request_counts_total",
             {"status": "success", **method}) == 1.0
    assert g("grpc_request_counts_total",
             {"status": "failed", **method}) == 1.0
    assert g("grpc_request_duration_milliseconds_count", method) == 2.0


def test_every_metric_attribute_registered_exactly_once():
    """Every collector of a Metrics lives on its own registry, and no two
    collectors claim one family name."""
    m = Metrics()
    registered = m.registry._collector_to_names
    collectors = {attr: v for attr, v in vars(m).items()
                  if isinstance(v, MetricWrapperBase)}
    assert collectors
    for attr, coll in collectors.items():
        assert coll in registered, (
            f"Metrics.{attr} is not registered on the instance registry")
    all_names = [n for names in registered.values() for n in names]
    assert len(all_names) == len(set(all_names))


def test_no_orphaned_collectors():
    """Every collector attribute is fed somewhere in the port: referenced
    at least once beyond its own definition."""
    m = Metrics()
    attrs = [a for a, v in vars(m).items()
             if isinstance(v, MetricWrapperBase)]
    pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "gubernator_tpu_torch")
    blob = []
    for root, _dirs, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(root, f), encoding="utf-8") as fh:
                    blob.append(fh.read())
    blob = "\n".join(blob)
    orphans = [a for a in attrs
               if len(re.findall(rf"\.{a}\b", blob)) < 2]
    assert not orphans, f"collectors defined but never fed: {orphans}"


def test_stage_labels_are_canonical():
    m = Metrics()
    for stage in STAGES:
        m.observe_stage(stage, 0.001)
    for stage in STAGES:
        assert m.registry.get_sample_value(
            "guber_tpu_stage_duration_ms_count", {"stage": stage}) == 1.0
    assert set(STAGES) == {
        "enqueue", "admission_wait", "window_fill", "device_dispatch",
        "drain_commit", "peer_forward", "global_broadcast"}
