"""Deterministic fault injection: seams at the I/O edges of the node.

A copy of `gubernator_tpu/net/faults.py` (JAX-free).  The port crosses
the JAX package's three seams at the same places; one departure: a rule on
a seam neither package knows raises ValueError (the JAX injector installs
it, and nothing ever crosses it), so no rule is silently ignored.

The chaos suite (tests/test_chaos.py) needs to make peers unreachable,
disks fail, and dispatches die — *deterministically*, in-process, with no
iptables or real crashes.  This module is the one switchboard: call sites
at the three seams guard on `FAULTS.enabled` (a single attribute check
when off, the same discipline as the tracing-off path) and, when a rule
matches, delay and/or fail the operation through a seeded RNG so the same
seed replays the same failure schedule.

Seams (the `seam` argument at each call site):

  peer_rpc        net/peers.py — every cross-host RPC attempt (forwards,
                  global sends, migrations, health probes).  An injected
                  failure raises FaultError, which the peer lane
                  normalizes to a retryable UNAVAILABLE-class PeerError —
                  it counts against the breaker exactly like a dead peer.
  snapshot_io     state/snapshot.py — snapshot file write/read.
                  FaultError subclasses OSError so the existing
                  degrade-to-cold-start handling applies unchanged.
  engine_dispatch core/batcher.py and core/pipeline.py — the device
                  window dispatch on the engine thread: the classic
                  lane's engine.process and each pipeline drain's launch
                  (that window's or drain's waiters see the failure, the
                  serving loop survives).

Configuration, either programmatically::

    from gubernator_tpu_torch.net.faults import FAULTS
    FAULTS.configure("peer_rpc", drop=1.0, match="127.0.0.1:9001")
    ...
    FAULTS.clear()

or via the environment (read once by the daemon at boot)::

    GUBER_FAULTS="peer_rpc:drop=0.1,delay_ms=50;snapshot_io:error"
    GUBER_FAULTS_SEED=7

Rule grammar: `seam:kv,kv;seam:kv` with kv one of `drop=P` (fail with
probability P), `delay_ms=N` (sleep N ms first), `error` (drop=1.0),
`match=SUBSTR` (only targets containing SUBSTR), `times=N` (fire the
fault at most N times, then pass).  Multiple rules per seam are allowed;
the first matching rule wins.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random
import time
from typing import Dict, List, Optional

log = logging.getLogger("gubernator.faults")

SEAM_PEER_RPC = "peer_rpc"
SEAM_SNAPSHOT_IO = "snapshot_io"
SEAM_ENGINE_DISPATCH = "engine_dispatch"
# the seams the port's call sites cross: the JAX package's three
WIRED_SEAMS = (SEAM_PEER_RPC, SEAM_SNAPSHOT_IO, SEAM_ENGINE_DISPATCH)


def _check_seam(seam: str) -> None:
    """Raise ValueError unless the port crosses `seam`."""
    if seam not in WIRED_SEAMS:
        raise ValueError(f"unknown fault seam '{seam}'")


class FaultError(OSError):
    """An injected failure.  OSError so the snapshot-IO handlers degrade
    exactly like a real disk error; the peer lane normalizes it to a
    retryable PeerError (net/peers.py)."""

    def __init__(self, seam: str, target: str = ""):
        self.seam = seam
        self.target = target
        super().__init__(f"injected fault at {seam}"
                         + (f" -> '{target}'" if target else ""))


class _Rule:
    __slots__ = ("drop", "delay", "match", "remaining", "fired")

    def __init__(self, drop: float = 0.0, delay: float = 0.0,
                 match: str = "", times: Optional[int] = None):
        self.drop = min(1.0, max(0.0, drop))
        self.delay = max(0.0, delay)
        self.match = match
        self.remaining = times  # None = unlimited
        self.fired = 0

    def matches(self, target: str) -> bool:
        return not self.match or self.match in target

    def describe(self) -> dict:
        d = {"drop": self.drop, "delay_ms": self.delay * 1000.0,
             "fired": self.fired}
        if self.match:
            d["match"] = self.match
        if self.remaining is not None:
            d["remaining"] = self.remaining
        return d


class FaultInjector:
    """Rules keyed by seam, decided through one seeded RNG.  `enabled` is
    the hot-path gate: False whenever no rule is installed, so a
    production node pays exactly one attribute check per seam crossing."""

    def __init__(self, seed: int = 0):
        self.enabled = False
        self._rules: Dict[str, List[_Rule]] = {}
        self._rng = random.Random(seed)
        self._seed = seed

    # ------------------------------------------------------------- config

    def seed(self, seed: int) -> None:
        """Re-seed the decision RNG: the same seed + the same call
        sequence replays the same drop schedule."""
        self._seed = seed
        self._rng = random.Random(seed)

    def configure(self, seam: str, drop: float = 0.0, delay_ms: float = 0.0,
                  match: str = "", times: Optional[int] = None) -> None:
        """Install one rule on `seam` (programmatic API).  Raises
        ValueError for a seam the port does not cross."""
        _check_seam(seam)
        self._rules.setdefault(seam, []).append(
            _Rule(drop=drop, delay=delay_ms / 1000.0, match=match,
                  times=times))
        self.enabled = True

    def load_spec(self, spec: str, seed: Optional[int] = None) -> None:
        """Parse the GUBER_FAULTS grammar (see module docstring).  The
        whole spec is parsed before any rule is installed, so a spec that
        raises installs nothing."""
        rules = []
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            seam, _, kvs = part.partition(":")
            seam = seam.strip()
            if not seam:
                raise ValueError(f"malformed fault rule '{part}'")
            kw: dict = {}
            for kv in kvs.split(","):
                kv = kv.strip()
                if not kv:
                    continue
                k, _, v = kv.partition("=")
                k = k.strip()
                if k == "drop":
                    kw["drop"] = float(v)
                elif k == "delay_ms":
                    kw["delay_ms"] = float(v)
                elif k == "error":
                    kw["drop"] = 1.0
                elif k == "match":
                    kw["match"] = v.strip()
                elif k == "times":
                    kw["times"] = int(v)
                else:
                    raise ValueError(
                        f"unknown fault key '{k}' in rule '{part}'")
            _check_seam(seam)
            rules.append((seam, kw))
        if seed is not None:
            self.seed(seed)
        for seam, kw in rules:
            self.configure(seam, **kw)

    def load_from_env(self) -> bool:
        """Daemon boot: install GUBER_FAULTS / GUBER_FAULTS_SEED if set.
        Returns True when a spec was installed."""
        spec = os.environ.get("GUBER_FAULTS", "")
        if not spec:
            return False
        seed = int(os.environ.get("GUBER_FAULTS_SEED", "0"))
        self.load_spec(spec, seed=seed)
        log.warning("fault injection ACTIVE: %s (seed %d)", spec, seed)
        return True

    def clear(self) -> None:
        self._rules.clear()
        self.enabled = False

    def describe(self) -> dict:
        return {seam: [r.describe() for r in rules]
                for seam, rules in self._rules.items()}

    # -------------------------------------------------------------- seams

    def _decide(self, seam: str, target: str):
        """(delay_seconds, rule_to_fire | None) for this crossing."""
        delay = 0.0
        for rule in self._rules.get(seam, ()):
            if not rule.matches(target):
                continue
            if rule.remaining is not None and rule.remaining <= 0:
                continue
            delay += rule.delay
            if rule.drop > 0.0 and self._rng.random() < rule.drop:
                rule.fired += 1
                if rule.remaining is not None:
                    rule.remaining -= 1
                return delay, rule
            return delay, None
        return delay, None

    async def on_async(self, seam: str, target: str = "") -> None:
        """Async seam crossing: sleep the injected delay, then raise
        FaultError if a rule fires.  Call ONLY behind `if FAULTS.enabled`."""
        delay, fired = self._decide(seam, target)
        if delay > 0.0:
            await asyncio.sleep(delay)
        if fired is not None:
            raise FaultError(seam, target)

    def on_sync(self, seam: str, target: str = "") -> None:
        """Sync seam crossing (engine thread, snapshot IO)."""
        delay, fired = self._decide(seam, target)
        if delay > 0.0:
            time.sleep(delay)
        if fired is not None:
            raise FaultError(seam, target)


# the process-wide injector every seam guards on; tests that configure it
# MUST clear() it again (the chaos fixtures do)
FAULTS = FaultInjector()
