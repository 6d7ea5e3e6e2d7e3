"""Live key migration on a peer-ring change.

A copy of `gubernator_tpu/state/migrate.py` (JAX-free).  When the cluster
membership changes, the consistent-hash ring re-homes a fraction of the
key space (about 1/N of the keys on an N-node grow: the ring's
minimal-movement property).  The reference lets re-homed counters restart
from zero on their new owner; here the old owner ships each moved key's
live bucket row to the new owner over the TransferBuckets peer lane, so
`remaining` and `reset_time` survive the ring change.

Split of responsibilities:

  ownership_diff       pure: which keys move where, given old/new host sets
  encode/decode_rows   the TransferBuckets wire payload (versioned JSON:
                       control-plane volume, not the serving path)
  Instance.migrate_keys     source side: diff, export, ship, drop local
  Instance.transfer_buckets dest side: import that never clobbers a
                            fresher local entry (engine.import_rows /
                            import_global_rows)

GLOBAL keys re-register on the new owner (config and replicated state row
move) but are not dropped at the source: every node keeps a serving
replica of GLOBAL keys; only ownership (who aggregates async hits) moves.

The payloads are byte for byte the JAX package's, so a JAX node and a port
node can exchange them: every integer is written as a Python int (a numpy
integer from a gathered plane is cast first).  Migration needs the Python
slot tables (EngineConfig use_native=False): the native router keeps
64-bit fingerprints, not key strings, and a fingerprint cannot be
re-hashed onto the ring.
"""

from __future__ import annotations

import json
import logging
from numbers import Integral
from typing import Dict, Iterable, List, Sequence, Tuple

from gubernator_tpu_torch.parallel.router import ConsistentHashRing

log = logging.getLogger("gubernator.migrate")

WIRE_VERSION = 1

_ROW_FIELDS = ("key", "limit", "duration", "remaining", "tstamp", "expire",
               "algo")
_GROW_FIELDS = _ROW_FIELDS + ("cfg_limit", "cfg_duration", "cfg_algo")


class MigrationError(Exception):
    """Malformed transfer payload or ack."""


def _ring_of(hosts: Iterable[str]) -> ConsistentHashRing:
    ring: ConsistentHashRing[str] = ConsistentHashRing()
    for h in hosts:
        ring.add(h, h)
    return ring


def ownership_diff(keys: Sequence[str], old_hosts: Iterable[str],
                   new_hosts: Iterable[str]) -> Dict[str, List[str]]:
    """Which of `keys` change owner between the two memberships?
    Returns {new_owner_host: [keys]}: only re-homed keys appear, so on an
    N -> N+1 grow this is about 1/(N+1) of the key space."""
    old = _ring_of(old_hosts)
    new = _ring_of(new_hosts)
    moved: Dict[str, List[str]] = {}
    for k in keys:
        o = old.get(k)
        n = new.get(k)
        if o != n:
            moved.setdefault(n, []).append(k)
    return moved


# -------------------------------------------------------------- wire codec


def _plain(v):
    """A JSON value as the JAX codec writes it: integers as Python ints."""
    return int(v) if isinstance(v, Integral) and not isinstance(v, bool) \
        else v


def encode_rows(regular: Sequence[dict], global_: Sequence[dict],
                leases: Sequence[Sequence] = ()) -> bytes:
    """`leases`: concurrency-lease book rows riding along with their keys,
    [key, client, count, expire, name, unique_key, limit, duration] (the
    last four empty or zero when the source lost the request template).
    The key is optional on the wire (old importers ignore it), so the wire
    version stays 1."""
    msg = {
        "v": WIRE_VERSION,
        "regular": [[_plain(r[f]) for f in _ROW_FIELDS] for r in regular],
        "global": [[_plain(r[f]) for f in _GROW_FIELDS] for r in global_],
    }
    if leases:
        msg["leases"] = [[_plain(v) for v in row] for row in leases]
    return json.dumps(msg).encode("utf-8")


def decode_rows(data: bytes) -> Tuple[List[dict], List[dict], List[list]]:
    try:
        msg = json.loads(data.decode("utf-8"))
        if msg["v"] != WIRE_VERSION:
            raise MigrationError(
                f"unsupported transfer wire version {msg['v']}")
        regular = [dict(zip(_ROW_FIELDS, r)) for r in msg["regular"]]
        global_ = [dict(zip(_GROW_FIELDS, r)) for r in msg["global"]]
        leases = [list(r) for r in msg.get("leases", ())]
    except MigrationError:
        raise
    except Exception as e:
        raise MigrationError(f"malformed transfer payload: {e}") from None
    for rows, fields in ((regular, _ROW_FIELDS), (global_, _GROW_FIELDS)):
        for r in rows:
            if not isinstance(r["key"], str) or any(
                    not isinstance(r[f], int) for f in fields[1:]):
                raise MigrationError("malformed transfer row")
    for row in leases:
        if (len(row) < 4 or not isinstance(row[0], str)
                or not isinstance(row[1], str)
                or not isinstance(row[2], int)
                or not isinstance(row[3], int)):
            raise MigrationError("malformed transfer lease row")
    return regular, global_, leases


def encode_ack(imported: int, skipped: int, gimported: int,
               gskipped: int) -> bytes:
    return json.dumps({
        "v": WIRE_VERSION, "imported": int(imported),
        "skipped_stale": int(skipped), "gimported": int(gimported),
        "gskipped_stale": int(gskipped),
    }).encode("utf-8")


def decode_ack(data: bytes) -> dict:
    try:
        msg = json.loads(data.decode("utf-8"))
        return {k: int(msg[k]) for k in
                ("imported", "skipped_stale", "gimported", "gskipped_stale")}
    except Exception as e:
        raise MigrationError(f"malformed transfer ack: {e}") from None
