"""Operator CLI: load generation and the admin commands.

The port of `gubernator_tpu/cmd/cli.py`.  Load generation is the
reference's cmd/gubernator-cli (main.go:42-85): generate 2000 random
rate-limit configs, hit them forever with concurrency 10, print any
OVER_LIMIT responses.

The other commands drive a daemon's HTTP admin plane
(api/http_gateway.py) with `urllib` only:

  python -m gubernator_tpu_torch.cmd.cli load [address]            # default
  python -m gubernator_tpu_torch.cmd.cli snapshot <http-addr> -o arena.snap
  python -m gubernator_tpu_torch.cmd.cli restore  <http-addr> arena.snap
                                                  [--rebase-to-now]
  python -m gubernator_tpu_torch.cmd.cli debug    <http-addr>  # introspection
  python -m gubernator_tpu_torch.cmd.cli top      <http-addr> [--watch N]
  python -m gubernator_tpu_torch.cmd.cli slo      <http-addr> [--watch N]
  python -m gubernator_tpu_torch.cmd.cli kernels  <http-addr> [--measure]
                                                  [--no-census] [--watch N]

`snapshot` and `restore` move the versioned, checksummed snapshot blob
(state/snapshot.py) as it is.  `debug` prints the /v1/admin/debug snapshot
(arena occupancy, admission queue, breaker states, congestion window,
per-stage latency quantiles, recent traces, the capture's state).
`load --http-address` prints the same per-stage table every 10 rounds.
`top` is the hot-key view of /v1/admin/topk, `slo` the SLO engine's
burn rates, `kernels` the census x measured table of /v1/admin/kernels
(observability/devprof.py); each takes `--watch SECONDS` to refresh.
The CLI loads neither torch nor jax, so it runs on a box with no card;
`load` needs grpcio.  A bare address (no subcommand) runs load
generation.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import urllib.error
import urllib.request

from gubernator_tpu_torch.api.types import (
    Algorithm,
    RateLimitReq,
    Second,
    Status,
    millisecond_now,
)


def _fetch_debug(http_address: str, timeout: float = 5.0) -> dict:
    url = f"{_http_base(http_address)}/v1/admin/debug"
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode("utf-8"))


def _print_stage_table(stages: dict) -> None:
    if not stages:
        print("stages: (no samples yet)")
        return
    print(f"{'stage':<18}{'count':>8}{'p50 ms':>10}{'p95 ms':>10}"
          f"{'p99 ms':>10}")
    for name, s in stages.items():
        print(f"{name:<18}{s['count']:>8}{s['p50_ms']:>10.3f}"
              f"{s['p95_ms']:>10.3f}{s['p99_ms']:>10.3f}")


async def _load(address: str, count: int, concurrency: int,
                http_address: str = "") -> None:
    from gubernator_tpu_torch.client import AsyncClient, random_string
    client = AsyncClient(address)
    reqs = [
        RateLimitReq(
            name=random_string("ID-", 6),
            unique_key=random_string("ID-", 10),
            hits=1,
            limit=random.randint(1, 10),
            duration=random.randint(1, 10) * Second,
            algorithm=Algorithm.TOKEN_BUCKET,
        )
        for _ in range(count)
    ]
    sem = asyncio.Semaphore(concurrency)
    # distinguish real OVER_LIMITs from QoS load shedding (the daemon
    # answers sheds in-band with metadata.shed_reason, qos/admission.py)
    stats = {"served": 0, "over_limit": 0}

    async def hit(req: RateLimitReq) -> None:
        async with sem:
            resps = await client.get_rate_limits([req], timeout=0.5)
            r = resps[0]
            reason = (r.metadata or {}).get("shed_reason")
            if reason is not None:
                stats[f"shed:{reason}"] = stats.get(f"shed:{reason}", 0) + 1
            elif r.status == Status.OVER_LIMIT:
                stats["over_limit"] += 1
                print(r)
            else:
                stats["served"] += 1

    rounds = 0
    while True:
        await asyncio.gather(*(hit(r) for r in reqs))
        rounds += 1
        if rounds % 10 == 0:
            print("totals:", " ".join(
                f"{k}={v}" for k, v in sorted(stats.items())))
            if http_address:
                # per-stage serving latency from the daemon's debug
                # snapshot — where the round's time actually went
                try:
                    snap = await asyncio.to_thread(_fetch_debug,
                                                   http_address)
                    _print_stage_table(snap.get("stages", {}))
                except Exception as e:
                    print(f"(stage snapshot unavailable: {e})",
                          file=sys.stderr)


def _http_base(address: str) -> str:
    return address if "://" in address else f"http://{address}"


def cmd_snapshot(args) -> int:
    url = f"{_http_base(args.address)}/v1/admin/snapshot?layout={args.layout}"
    with urllib.request.urlopen(url, timeout=args.timeout) as resp:
        data = resp.read()
    with open(args.output, "wb") as f:
        f.write(data)
    print(f"wrote {len(data)} bytes to {args.output}")
    return 0


def cmd_restore(args) -> int:
    with open(args.file, "rb") as f:
        data = f.read()
    url = f"{_http_base(args.address)}/v1/admin/restore"
    if args.rebase_to_now:
        url += f"?rebase_to={millisecond_now()}"
    req = urllib.request.Request(
        url, data=data, method="POST",
        headers={"Content-Type": "application/octet-stream"})
    try:
        with urllib.request.urlopen(req, timeout=args.timeout) as resp:
            body = json.loads(resp.read().decode("utf-8"))
    except urllib.error.HTTPError as e:
        print(f"restore rejected: {e.read().decode('utf-8', 'replace')}",
              file=sys.stderr)
        return 1
    print(f"restored {body.get('restoredKeys', 0)} keys")
    return 0


def cmd_debug(args) -> int:
    try:
        snap = _fetch_debug(args.address, timeout=args.timeout)
    except Exception as e:
        print(f"debug fetch failed: {e}", file=sys.stderr)
        return 1
    eng = snap.get("engine", {})
    print(f"node {snap.get('address')} mesh_mode={snap.get('mesh_mode')} "
          f"standalone={snap.get('standalone')}")
    if eng:
        print("engine:", " ".join(f"{k}={v}" for k, v in sorted(eng.items())))
        # arena pressure in one line: the live/expired/free slot breakdown
        # next to capacity, so "is the arena full of dead weight?" needs
        # no mental arithmetic
        cap = eng.get("capacity") or 1
        print(f"arena: {eng.get('live', 0)} live / "
              f"{eng.get('expired', 0)} expired / {eng.get('free', 0)} free "
              f"of {cap} slots ({100.0 * eng.get('live', 0) / cap:.1f}% live)")
    adm = snap.get("admission")
    if adm:
        print(f"admission: pending={adm['pending']} "
              f"peak={adm['pending_peak']}/{adm['max_pending']} "
              f"saturated={adm['saturated']} sheds={adm['shed_counts']}")
    cong = snap.get("congestion")
    if cong:
        print(f"congestion: window={cong['effective_window']} "
              f"latency_ewma_ms={cong['latency_ewma_ms']:.2f} "
              f"congested={cong['congested']} "
              f"+{cong['increases']}/-{cong['decreases']}")
    for peer in snap.get("peers", []):
        print(f"peer {peer['host']}: breaker={peer['breaker']}"
              f"{' (self)' if peer['is_owner'] else ''}")
    health = snap.get("health")
    if health:
        for host, st in sorted(health.get("peers", {}).items()):
            print(f"health {host}: {st['state']} "
                  f"fail_streak={st['fail_streak']} "
                  f"probes={st['probes']} failures={st['failures']}")
    gs = snap.get("global_sync")
    if gs:
        hints = gs.get("hints", {})
        print(f"global_sync: send_errors={gs['send_errors']} "
              f"broadcast_errors={gs['broadcast_errors']}")
        print(f"hints: pending={hints.get('pending', {})} "
              f"queued={hints.get('queued_total', {})} "
              f"replayed={hints.get('replayed_total', {})} "
              f"expired={hints.get('expired_total', {})}")
    fd = snap.get("frontdoor")
    if fd:
        print(f"frontdoor: workers={fd['workers']} "
              f"mode={fd.get('port_mode')} address={fd.get('address')} "
              f"restarts={fd.get('restarts', 0)} "
              f"records_served={fd.get('records_served', 0)}")
        for i, row in enumerate(fd.get("per_worker", [])):
            print(f"  worker {i}: pid={row.get('pid')} "
                  f"port={row.get('port')} epoch={row.get('epoch')} "
                  f"restarts={row.get('restarts')} rpcs={row.get('rpcs')} "
                  f"sheds={row.get('sheds')} stalls={row.get('stalls')} "
                  f"ring_depth={row.get('ring_depth')} "
                  f"inflight={row.get('inflight')}")
    faults = snap.get("faults")
    if faults:
        print(f"faults ACTIVE: {faults}")
    pipe = snap.get("pipeline")
    if pipe:
        print("pipeline:", " ".join(
            f"{k}={v}" for k, v in sorted(pipe.items())))
    an = snap.get("analytics")
    if an:
        tot = an.get("totals", {})
        occ = an.get("occupancy", {})
        print(f"analytics: decisions={tot.get('decisions', 0)} "
              f"over_limit={tot.get('over_limit', 0)} "
              f"inits={tot.get('inits', 0)} "
              f"device_occupancy={occ.get('live', 0)} live/"
              f"{occ.get('expired', 0)} expired")
    tiers = snap.get("tiers")
    if tiers:
        print(f"tiers: warm={tiers.get('warm_rows', 0)}/"
              f"{tiers.get('warm_capacity', 0)} rows "
              f"({tiers.get('warm_layout')}, {tiers.get('warm_bytes', 0)}B) "
              f"promote={tiers.get('promotions', 0)} "
              f"demote={tiers.get('demotions', 0)} "
              f"warm_hit={tiers.get('warm_hits', 0)} "
              f"cold_miss={tiers.get('cold_misses', 0)} "
              f"warm_evict={tiers.get('warm_evictions', 0)}")
    slo = snap.get("slo")
    if slo:
        for name, obj in sorted(slo.get("burn_rates", {}).items()):
            state = "FIRING" if obj.get("firing") else "ok"
            wins = " ".join(f"{w}={b}" for w, b in
                            sorted(obj.get("windows", {}).items()))
            print(f"slo {name}: {state} budget={obj.get('budget')} {wins}")
    _print_stage_table(snap.get("stages", {}))
    tracing = snap.get("tracing")
    if tracing:
        print(f"tracing: sample={tracing['sample']}")
        for t in tracing.get("recent_traces", []):
            print(f"  trace {t['trace_id'][:16]} root={t['root']} "
                  f"spans={t['spans']} {t['duration_ms']:.2f}ms "
                  f"slowest={t['slowest_span']} ({t['slowest_ms']:.2f}ms) "
                  f"nodes={','.join(t['nodes'])}")
    prof = snap.get("profile")
    if prof:
        print(f"profile: active={prof['active']} "
              f"remaining={prof['remaining']} dir={prof['dir'] or '-'}")
    if args.json:
        print(json.dumps(snap, indent=2))
    return 0


def _watch_loop(once, interval: float) -> int:
    """Run `once` every `interval` seconds until ^C (interval 0 = single
    shot).  The live-view plumbing shared by `top` and `slo`."""
    import time as _time
    if not interval:
        return once()
    try:
        while True:
            rc = once()
            if rc:
                return rc
            _time.sleep(interval)
            print()
    except KeyboardInterrupt:
        return 0


def cmd_top(args) -> int:
    """Hot-key live view from /v1/admin/topk (traffic analytics)."""
    def once() -> int:
        url = f"{_http_base(args.address)}/v1/admin/topk?n={args.n}"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                snap = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            print(f"topk fetch failed: "
                  f"{e.read().decode('utf-8', 'replace')}", file=sys.stderr)
            return 1
        except Exception as e:
            print(f"topk fetch failed: {e}", file=sys.stderr)
            return 1
        tot = snap.get("totals", {})
        occ = snap.get("occupancy", {})
        print(f"decisions={tot.get('decisions', 0)} "
              f"hits={tot.get('hits', 0)} "
              f"over_limit={tot.get('over_limit', 0)} "
              f"inits={tot.get('inits', 0)} drains={tot.get('drains', 0)} "
              f"arena={occ.get('live', 0)} live/"
              f"{occ.get('expired', 0)} expired")
        rows = snap.get("topk", [])
        if not rows:
            print("(no hot keys yet)")
        else:
            print(f"{'score':>10}{'hits':>10}{'over':>8}  key")
            for r in rows:
                print(f"{r['score']:>10}{r['hits']:>10}{r['over']:>8}  "
                      f"{r['key']}")
        tenants = snap.get("tenants", {})
        if tenants:
            print("tenants:")
            for name, t in sorted(tenants.items(),
                                  key=lambda kv: -kv[1]["decisions"]):
                print(f"  {name}: decisions={t['decisions']} "
                      f"hits={t['hits']} over_limit={t['over_limit']}")
        return 0

    return _watch_loop(once, args.watch)


def cmd_slo(args) -> int:
    """SLO burn-rate live view from the debug snapshot's slo section."""
    def once() -> int:
        try:
            snap = _fetch_debug(args.address, timeout=args.timeout)
        except Exception as e:
            print(f"debug fetch failed: {e}", file=sys.stderr)
            return 1
        slo = snap.get("slo")
        if not slo:
            print("slo engine disabled (set GUBER_SLO=1)", file=sys.stderr)
            return 1
        obj = slo.get("objectives", {})
        print(f"objectives: drain_p99_ms={obj.get('drain_p99_ms')} "
              f"drain_budget={obj.get('drain_budget')} "
              f"shed_budget={obj.get('shed_budget')} "
              f"availability={obj.get('availability')}")
        wins = slo.get("burn_windows", [])
        print("windows: " + ", ".join(
            f"{w['window_s']:.0f}s>{w['threshold']}" for w in wins))
        for name, o in sorted(slo.get("burn_rates", {}).items()):
            state = "FIRING" if o.get("firing") else "ok"
            parts = " ".join(f"{w}={b}" for w, b in
                             sorted(o.get("windows", {}).items(),
                                    key=lambda kv: int(kv[0][:-1])))
            print(f"{name:<14}{state:<8}budget={o.get('budget'):<8} {parts}")
        return 0

    return _watch_loop(once, args.watch)


def cmd_kernels(args) -> int:
    """Census count × measured ms/window reconciliation table from
    /v1/admin/kernels (observability/devprof.py)."""
    def once() -> int:
        url = (f"{_http_base(args.address)}/v1/admin/kernels"
               f"?census={0 if args.no_census else 1}")
        if args.measure:
            url += f"&measure=1&iters={args.iters}"
        try:
            with urllib.request.urlopen(url, timeout=args.timeout) as resp:
                snap = json.loads(resp.read().decode("utf-8"))
        except urllib.error.HTTPError as e:
            print(f"kernels fetch failed: "
                  f"{e.read().decode('utf-8', 'replace')}", file=sys.stderr)
            return 1
        except Exception as e:
            print(f"kernels fetch failed: {e}", file=sys.stderr)
            return 1
        arms = snap.get("arms", {})
        print(f"{'arm':<22}{'census k/win':>14}{'measured ms/win':>18}")
        for arm, row in sorted(arms.items()):
            cen = row.get("census_kernels_per_window")
            ms = row.get("measured_ms_per_window")
            print(f"{arm:<22}"
                  f"{cen if cen is not None else '-':>14}"
                  f"{f'{ms:.4f}' if ms is not None else '-':>18}")
        clock = snap.get("clock")
        if clock:
            print("window clock:")
            for arm, c in sorted(clock.get("arms", {}).items()):
                print(f"  {arm}: ewma={c['ewma_ms']:.3f}ms "
                      f"count={c['count']}")
            for s in clock.get("slow_windows", []):
                ids = ",".join(s.get("trace_ids", [])) or "-"
                print(f"  slow {s['arm']}: {s['ms']}ms traces={ids}")
        rows = snap.get("table", [])
        if rows:
            print(f"{'kernel':<44}{'arm':<22}{'count':>8}{'ms/win':>10}")
            for r in rows[:args.n]:
                print(f"{r['kernel'][:43]:<44}{r['arm']:<22}"
                      f"{r['count']:>8}{r['ms_per_window']:>10.4f}")
        else:
            print("(kernel table empty — arm a capture, run `cli kernels "
                  "--measure`, or set GUBER_DEVPROF=periodic)")
        ctrl = snap.get("controller")
        if ctrl:
            print(f"continuous: interval={ctrl['interval_s']}s "
                  f"drains={ctrl['drains']} cycles={ctrl['cycles']} "
                  f"sheds={ctrl['sheds']} rows={ctrl['kernel_rows']}")
        return 0

    return _watch_loop(once, args.watch)


def main(argv=None) -> None:
    argv = list(sys.argv[1:] if argv is None else argv)
    # compatibility: a bare address (or nothing) runs load generation
    if not argv or argv[0] not in ("load", "snapshot", "restore", "debug",
                                   "top", "slo", "kernels"):
        argv.insert(0, "load")

    p = argparse.ArgumentParser("gubernator-tpu-torch-cli")
    sub = p.add_subparsers(dest="cmd", required=True)

    pl = sub.add_parser("load", help="hammer random rate limits (default)")
    pl.add_argument("address", nargs="?", default="127.0.0.1:9090")
    pl.add_argument("--count", type=int, default=2000)
    pl.add_argument("--concurrency", type=int, default=10)
    pl.add_argument("--http-address", default="",
                    help="daemon HTTP address; when set, print per-stage "
                    "p50/p95/p99 from /v1/admin/debug every 10 rounds")

    ps = sub.add_parser("snapshot", help="pull a snapshot over HTTP admin")
    ps.add_argument("address", help="daemon HTTP address (host:port)")
    ps.add_argument("-o", "--output", default="arena.snap")
    ps.add_argument("--layout", choices=("auto", "int64", "compact32"),
                    default="auto")
    ps.add_argument("--timeout", type=float, default=30.0)

    pr = sub.add_parser("restore", help="push a snapshot over HTTP admin")
    pr.add_argument("address", help="daemon HTTP address (host:port)")
    pr.add_argument("file")
    pr.add_argument("--rebase-to-now", action="store_true",
                    help="shift all timestamps so buckets keep their "
                    "REMAINING lifetime instead of absolute expiry")
    pr.add_argument("--timeout", type=float, default=30.0)

    pd = sub.add_parser("debug", help="print the daemon's runtime "
                        "introspection snapshot")
    pd.add_argument("address", help="daemon HTTP address (host:port)")
    pd.add_argument("--json", action="store_true",
                    help="also dump the raw snapshot JSON")
    pd.add_argument("--timeout", type=float, default=5.0)

    pt = sub.add_parser("top", help="hot-key top-K live view "
                        "(traffic analytics)")
    pt.add_argument("address", help="daemon HTTP address (host:port)")
    pt.add_argument("-n", type=int, default=20,
                    help="number of hot keys to show")
    pt.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="refresh every SECONDS until ^C (0 = one shot)")
    pt.add_argument("--timeout", type=float, default=5.0)

    po = sub.add_parser("slo", help="SLO burn-rate live view")
    po.add_argument("address", help="daemon HTTP address (host:port)")
    po.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="refresh every SECONDS until ^C (0 = one shot)")
    po.add_argument("--timeout", type=float, default=5.0)

    pk = sub.add_parser("kernels", help="census × measured device-time "
                        "kernel table (devprof)")
    pk.add_argument("address", help="daemon HTTP address (host:port)")
    pk.add_argument("-n", type=int, default=20,
                    help="kernel-table rows to show")
    pk.add_argument("--measure", action="store_true",
                    help="run the arm-scoped measured probe inline "
                    "(seconds of compile on a cold daemon)")
    pk.add_argument("--iters", type=int, default=2,
                    help="measured-probe iterations per arm")
    pk.add_argument("--no-census", action="store_true",
                    help="skip the census column (faster on a cold daemon)")
    pk.add_argument("--watch", type=float, default=0.0, metavar="SECONDS",
                    help="refresh every SECONDS until ^C (0 = one shot)")
    pk.add_argument("--timeout", type=float, default=300.0)

    args = p.parse_args(argv)
    if args.cmd == "snapshot":
        sys.exit(cmd_snapshot(args))
    if args.cmd == "restore":
        sys.exit(cmd_restore(args))
    if args.cmd == "debug":
        sys.exit(cmd_debug(args))
    if args.cmd == "top":
        sys.exit(cmd_top(args))
    if args.cmd == "slo":
        sys.exit(cmd_slo(args))
    if args.cmd == "kernels":
        sys.exit(cmd_kernels(args))
    try:
        asyncio.run(_load(args.address, args.count, args.concurrency,
                          http_address=args.http_address))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
