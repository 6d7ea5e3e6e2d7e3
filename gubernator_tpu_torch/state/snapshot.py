"""Versioned, checksummed snapshots of the arenas and key maps.

The port of `gubernator_tpu/state/snapshot.py`, the rate limiter's
counterpart of the reference's Loader/PersistentStore
(persistent_store.go): a daemon restart must not zero every counter.  A
snapshot captures

  * the arena planes (regular [S, C], GLOBAL [G] and its config) as one
    device-to-host export,
  * the key-to-slot maps (the Python SlotTables' keys, or the native
    router's fingerprint table: entry index == device slot, so the
    fingerprints alone keep the restored map coherent with the restored
    planes),
  * metadata: geometry, creation time, layout, compact soundness.

Two on-disk time layouts, chosen per snapshot:

  "int64"     tstamp/expire as absolute ms-epoch int64: always valid.
  "compact32" tstamp/expire as int32 deltas rebased against the snapshot's
              `now`, and limit/duration/remaining as int32: half the plane
              bytes.  The rebase is the JAX fused kernel's _pair_rebase /
              _pair_reabs (gubernator_tpu/ops/pallas_kernel.py:379, :396),
              written here in numpy on int64: clip(wrapped t - now,
              -REBASE_LIM, REBASE_LIM), and its exact inverse.  The
              layout is written only when every live value round-trips
              exactly (compact_encodable), so a restore is bit-identical
              to the int64 layout either way.

A restore keeps times absolute by default (downtime counts against TTLs,
as for an uninterrupted process).  `rebase_to` shifts every timestamp by
(rebase_to - snapshot now) instead, to restore into another clock domain
with each bucket's remaining lifetime kept.

File format (version 1), byte for byte the JAX package's:

  8 bytes   magic b"GUBSNAP\\x01"
  4 bytes   format version (u32 LE)
  4 bytes   crc32 of the payload (u32 LE)
  payload   npz archive (numpy savez) holding the meta JSON and every array

A truncated or bit-flipped file fails the crc (or the parse) and raises
SnapshotError; restore_engine turns that into a logged cold start.  A
mesh rank restores through restore_mesh_engine: only when every rank's
file holds the same agreed tick and GLOBAL part, else every rank starts
cold together.

Lease rows travel in the same optional npz arrays as the JAX package's;
the port has no lease registry yet, so an engine that restores them logs
their count and drops them (core/service.py).
"""

from __future__ import annotations

import hashlib
import io
import json
import logging
import os
import struct
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np

from gubernator_tpu_torch.api.types import millisecond_now
from gubernator_tpu_torch.net.faults import FAULTS, SEAM_SNAPSHOT_IO

log = logging.getLogger("gubernator.snapshot")

MAGIC = b"GUBSNAP\x01"
VERSION = 1

# int32 sentinel of a never-initialized slot's times in the compact32
# layout (expire == 0 on the device).  Outside the +/-REBASE_LIM clip
# range, so it never collides with a real rebased delta.
DEAD_REL = -(2 ** 31)

# the compact32 clip range around the rebase epoch (the JAX fused
# kernel's _REBASE_LIM, gubernator_tpu/ops/pallas_kernel.py:372)
REBASE_LIM = (2 ** 31) - 16
_I32 = 2 ** 31

_REG_PLANES = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
_CFG_PLANES = ("limit", "duration", "algo")

# Top of the known algorithm alphabet (Algorithm.CONCURRENCY).  Restored
# rows above it were written by a newer build whose packed-column
# semantics this one cannot interpret (_drop_unknown_algorithm_rows).
_MAX_ALGO = 4


class SnapshotError(Exception):
    """Unusable snapshot: bad magic/version/checksum, truncated payload, or
    a geometry mismatch with the restoring engine."""


@dataclass
class ArenaSnapshot:
    """Host image of one engine's state.

    planes/gplanes/gcfg hold int64 (algo int32) numpy arrays in the int64
    layout: the compact32 encoding exists only in the file (dumps/loads),
    so every in-memory consumer sees one canonical form.
    """

    now: int                      # ms epoch at export
    layout: str                   # requested file layout: int64 | compact32
    num_shards: int
    capacity_per_shard: int
    global_capacity: int
    num_local_shards: int
    local_shard_offset: int
    compact_sound: bool
    backend: str                  # "python" | "native"
    planes: Dict[str, np.ndarray]     # regular arena [S, C]
    gplanes: Dict[str, np.ndarray]    # GLOBAL arena [G]
    gcfg: Dict[str, np.ndarray]       # GLOBAL config [G]
    # python backend: per shard, (keys, slot i32[n], expire i64[n])
    tables: List[tuple] = field(default_factory=list)
    # native backend: per shard, (fp u64[n], slot i32[n], expire i64[n])
    native_tables: List[tuple] = field(default_factory=list)
    gtable: tuple = ()            # (keys, slot, expire) of the GLOBAL table
    # GLOBAL keys registered (phase 1) but not yet activated mesh-wide;
    # they restore still pending
    gpending: List[str] = field(default_factory=list)
    # warm tier (state/tiers.py), when enabled at export: (keys,
    # {plane: int64[n]}) in canonical absolute form.  Optional npz arrays:
    # their absence restores as an empty warm store.
    warm: Optional[tuple] = None
    # concurrency-lease rows [(key, client, count, expire)], optional npz
    # arrays like `warm`
    leases: List[tuple] = field(default_factory=list)

    def total_keys(self) -> int:
        reg = (sum(len(t[1]) for t in self.native_tables)
               if self.backend == "native"
               else sum(len(t[1]) for t in self.tables))
        return reg + (len(self.gtable[1]) if self.gtable else 0)


# ---------------------------------------------------------------- time codec


def rebase_encode(times: np.ndarray, dead: np.ndarray, now: int) -> np.ndarray:
    """int64 ms-epoch -> int32 delta against `now`: the int64 difference
    (wrapping, as the JAX pair subtract's halves do) clipped to
    +/-REBASE_LIM; dead slots (expire == 0 on the device) carry DEAD_REL
    instead."""
    t = np.ascontiguousarray(times, np.int64)
    d = t - np.int64(now)  # numpy array arithmetic wraps silently
    rel = np.clip(d, -REBASE_LIM, REBASE_LIM).astype(np.int32)
    rel[np.asarray(dead, bool)] = DEAD_REL
    return rel


def rebase_decode(rel: np.ndarray, now: int) -> np.ndarray:
    """Inverse of rebase_encode: int32 delta -> absolute int64 (now + the
    sign-extended delta, wrapping); sentinel slots decode back to 0."""
    r = np.ascontiguousarray(rel, np.int32)
    out = r.astype(np.int64) + np.int64(now)
    out[r == DEAD_REL] = 0
    return out


def compact_encodable(snap: ArenaSnapshot) -> bool:
    """May this snapshot travel in the compact32 layout losslessly?  Times
    of live slots must sit within the rebase clip range of snap.now, and
    every value plane must fit int32 (the engine's compact latch implies it
    for live rows, but an arena from before the latch tripped may hold
    wider values, so the data is checked)."""

    def _planes_ok(planes):
        dead = planes["expire"] == 0
        for name in ("limit", "duration", "remaining"):
            a = planes[name]
            if a.size and (a.min() < -_I32 or a.max() >= _I32):
                return False
        for name in ("tstamp", "expire"):
            d = planes[name][~dead] - snap.now
            if d.size and (d.min() < -REBASE_LIM or d.max() > REBASE_LIM):
                return False
        return True

    return _planes_ok(snap.planes) and _planes_ok(snap.gplanes) and all(
        not (a.size and (a.min() < -_I32 or a.max() >= _I32))
        for n, a in snap.gcfg.items() if n != "algo")


# -------------------------------------------------------------- wire format


def _pack_keys(keys: List[str]):
    blob = b"".join(k.encode("utf-8") for k in keys)
    ends = np.cumsum([len(k.encode("utf-8")) for k in keys]).astype(np.int64) \
        if keys else np.empty(0, np.int64)
    return np.frombuffer(blob, np.uint8).copy(), ends


def _unpack_keys(blob: np.ndarray, ends: np.ndarray) -> List[str]:
    raw = blob.tobytes()
    keys, start = [], 0
    for end in ends.tolist():
        keys.append(raw[start:end].decode("utf-8"))
        start = end
    return keys


def dumps(snap: ArenaSnapshot) -> bytes:
    """Serialize in the layout the snapshot asks for, widening to int64
    (with a warning) when compact32 cannot hold the data exactly."""
    layout = snap.layout
    if layout == "compact32" and not compact_encodable(snap):
        log.warning("snapshot data exceeds the compact32 range; "
                    "writing the int64 layout instead")
        layout = "int64"

    arrays: Dict[str, np.ndarray] = {}

    def put_planes(prefix: str, planes: Dict[str, np.ndarray]):
        dead = planes["expire"] == 0
        for name, a in planes.items():
            if layout == "compact32" and name in ("tstamp", "expire"):
                arrays[f"{prefix}{name}"] = rebase_encode(a, dead, snap.now)
            elif layout == "compact32" and name in ("limit", "duration",
                                                    "remaining"):
                arrays[f"{prefix}{name}"] = a.astype(np.int32)
            else:
                arrays[f"{prefix}{name}"] = a

    put_planes("reg_", snap.planes)
    put_planes("g_", snap.gplanes)
    for name, a in snap.gcfg.items():
        arrays[f"gcfg_{name}"] = a

    for i, (keys, slots, expires) in enumerate(snap.tables):
        blob, ends = _pack_keys(keys)
        arrays[f"t{i}_keys"] = blob
        arrays[f"t{i}_ends"] = ends
        arrays[f"t{i}_slot"] = np.asarray(slots, np.int32)
        arrays[f"t{i}_expire"] = np.asarray(expires, np.int64)
    for i, (fp, slots, expires) in enumerate(snap.native_tables):
        arrays[f"n{i}_fp"] = np.asarray(fp, np.uint64)
        arrays[f"n{i}_slot"] = np.asarray(slots, np.int32)
        arrays[f"n{i}_expire"] = np.asarray(expires, np.int64)
    if snap.gtable:
        keys, slots, expires = snap.gtable
        blob, ends = _pack_keys(keys)
        arrays["gt_keys"] = blob
        arrays["gt_ends"] = ends
        arrays["gt_slot"] = np.asarray(slots, np.int32)
        arrays["gt_expire"] = np.asarray(expires, np.int64)
    if snap.warm is not None:
        # warm rows travel int64 whatever the planes' layout: the store
        # re-encodes against its own epoch on restore
        wkeys, wcols = snap.warm
        blob, ends = _pack_keys(wkeys)
        arrays["warm_keys"] = blob
        arrays["warm_ends"] = ends
        for name in _REG_PLANES:
            arrays[f"warm_{name}"] = np.asarray(wcols[name], np.int64)
    if snap.leases:
        lkeys, lclients, lcount, lexpire = zip(*snap.leases)
        blob, ends = _pack_keys(list(lkeys))
        arrays["lease_keys"] = blob
        arrays["lease_ends"] = ends
        cblob, cends = _pack_keys(list(lclients))
        arrays["lease_clients"] = cblob
        arrays["lease_cends"] = cends
        arrays["lease_count"] = np.asarray(lcount, np.int64)
        arrays["lease_expire"] = np.asarray(lexpire, np.int64)

    meta = {
        "now": int(snap.now),
        "layout": layout,
        "num_shards": snap.num_shards,
        "capacity_per_shard": snap.capacity_per_shard,
        "global_capacity": snap.global_capacity,
        "num_local_shards": snap.num_local_shards,
        "local_shard_offset": snap.local_shard_offset,
        "compact_sound": snap.compact_sound,
        "backend": snap.backend,
        "gpending": list(snap.gpending),
    }
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta).encode("utf-8"), np.uint8).copy()

    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    head = MAGIC + struct.pack("<II", VERSION, zlib.crc32(payload))
    return head + payload


def loads(data: bytes) -> ArenaSnapshot:
    """Parse and verify a snapshot blob; raises SnapshotError on anything
    short of a bit-exact, version-compatible payload."""
    if len(data) < len(MAGIC) + 8 or data[:len(MAGIC)] != MAGIC:
        raise SnapshotError("not a gubernator snapshot (bad magic)")
    version, crc = struct.unpack_from("<II", data, len(MAGIC))
    if version != VERSION:
        raise SnapshotError(f"unsupported snapshot version {version}")
    payload = data[len(MAGIC) + 8:]
    if zlib.crc32(payload) != crc:
        raise SnapshotError("snapshot checksum mismatch (truncated or "
                            "corrupted file)")
    try:
        with np.load(io.BytesIO(payload)) as z:
            arrays = {k: z[k] for k in z.files}
        meta = json.loads(arrays.pop("__meta__").tobytes().decode("utf-8"))
    except Exception as e:
        raise SnapshotError(f"malformed snapshot payload: {e}") from None

    layout = meta["layout"]
    now = int(meta["now"])

    def get_planes(prefix: str) -> Dict[str, np.ndarray]:
        planes = {}
        for name in _REG_PLANES:
            a = arrays[f"{prefix}{name}"]
            if layout == "compact32" and name in ("tstamp", "expire"):
                a = rebase_decode(a, now)
            elif name != "algo":
                a = a.astype(np.int64)
            planes[name] = a
        return planes

    try:
        planes = get_planes("reg_")
        gplanes = get_planes("g_")
        gcfg = {name: arrays[f"gcfg_{name}"] for name in _CFG_PLANES}
        tables, native_tables = [], []
        for i in range(int(meta["num_local_shards"])):
            if f"t{i}_slot" in arrays:
                tables.append((
                    _unpack_keys(arrays[f"t{i}_keys"], arrays[f"t{i}_ends"]),
                    arrays[f"t{i}_slot"], arrays[f"t{i}_expire"]))
            elif f"n{i}_slot" in arrays:
                native_tables.append((
                    arrays[f"n{i}_fp"], arrays[f"n{i}_slot"],
                    arrays[f"n{i}_expire"]))
        gtable = ()
        if "gt_slot" in arrays:
            gtable = (_unpack_keys(arrays["gt_keys"], arrays["gt_ends"]),
                      arrays["gt_slot"], arrays["gt_expire"])
        warm = None
        if "warm_ends" in arrays:
            warm = (_unpack_keys(arrays["warm_keys"], arrays["warm_ends"]),
                    {name: arrays[f"warm_{name}"].astype(np.int64)
                     for name in _REG_PLANES})
        leases = []
        if "lease_ends" in arrays:
            leases = list(zip(
                _unpack_keys(arrays["lease_keys"], arrays["lease_ends"]),
                _unpack_keys(arrays["lease_clients"],
                             arrays["lease_cends"]),
                arrays["lease_count"].tolist(),
                arrays["lease_expire"].tolist()))
    except KeyError as e:
        raise SnapshotError(f"snapshot payload missing array {e}") from None

    snap = ArenaSnapshot(
        now=now, layout=layout,
        num_shards=int(meta["num_shards"]),
        capacity_per_shard=int(meta["capacity_per_shard"]),
        global_capacity=int(meta["global_capacity"]),
        num_local_shards=int(meta["num_local_shards"]),
        local_shard_offset=int(meta["local_shard_offset"]),
        compact_sound=bool(meta["compact_sound"]),
        backend=meta["backend"],
        planes=planes, gplanes=gplanes, gcfg=gcfg,
        tables=tables, native_tables=native_tables, gtable=gtable,
        gpending=list(meta.get("gpending", ())),
        warm=warm, leases=leases,
    )
    _drop_unknown_algorithm_rows(snap)
    return snap


def _drop_unknown_algorithm_rows(snap: ArenaSnapshot) -> int:
    """Rows whose algorithm value is outside the alphabet this build knows
    (> _MAX_ALGO) were written by a newer version whose packed-column
    semantics this one cannot interpret.  They drop to a cold start: their
    expiry is forced to the dead sentinel and their key-table entries are
    removed, so the keys start again on first touch.  Returns the number
    of rows dropped."""

    def _bad_slots(planes):
        a = np.asarray(planes["algo"])
        return ((a < 0) | (a > _MAX_ALGO)) & (np.asarray(
            planes["expire"]) != 0)

    def _prune_table(table, drop):
        keys, slots, expires = table
        slots = np.asarray(slots)
        keep = [j for j, sl in enumerate(slots.tolist()) if sl not in drop]
        if isinstance(keys, list):
            kept_keys = [keys[j] for j in keep]
        else:
            kept_keys = np.asarray(keys)[keep]
        return (kept_keys, slots[keep], np.asarray(expires)[keep])

    dropped = 0
    bad = _bad_slots(snap.planes)
    if bad.any():
        dropped += int(bad.sum())
        snap.planes["expire"] = np.where(bad, 0, snap.planes["expire"])
        for s in range(bad.shape[0]):
            drop = set(np.nonzero(bad[s])[0].tolist())
            if not drop:
                continue
            if s < len(snap.tables):
                snap.tables[s] = _prune_table(snap.tables[s], drop)
            if s < len(snap.native_tables):
                snap.native_tables[s] = _prune_table(
                    snap.native_tables[s], drop)
    gbad = _bad_slots(snap.gplanes)
    ga = np.asarray(snap.gcfg["algo"])
    gbad = gbad | ((ga < 0) | (ga > _MAX_ALGO)) & (
        np.asarray(snap.gplanes["expire"]) != 0)
    if gbad.any():
        dropped += int(gbad.sum())
        snap.gplanes["expire"] = np.where(gbad, 0, snap.gplanes["expire"])
        if snap.gtable:
            snap.gtable = _prune_table(
                snap.gtable, set(np.nonzero(gbad)[0].tolist()))
    if dropped:
        log.warning(
            "snapshot carries %d rows with unknown algorithm values "
            "(newer writer?); dropping them to a cold start", dropped)
    return dropped


# ---------------------------------------------------------------- file I/O


def write_bytes(data: bytes, path: str) -> int:
    """Atomic write (a temporary file, fsync, rename): a crash mid-write
    leaves the previous snapshot intact.  Returns the bytes written."""
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return len(data)


def save(snap: ArenaSnapshot, path: str) -> int:
    """dumps, then write_bytes.  Returns the bytes written.  The
    `snapshot_io` fault seam (net/faults.py) fires before anything is
    written, so an injected failure leaves the previous file as it was."""
    if FAULTS.enabled:
        FAULTS.on_sync(SEAM_SNAPSHOT_IO, path)
    return write_bytes(dumps(snap), path)


def load(path: str) -> ArenaSnapshot:
    """The file's ArenaSnapshot.  An injected `snapshot_io` failure is a
    FaultError, an OSError, so restore_engine starts cold on it as on a
    disk error."""
    if FAULTS.enabled:
        FAULTS.on_sync(SEAM_SNAPSHOT_IO, path)
    with open(path, "rb") as f:
        return loads(f.read())


def snapshot_path(directory: str, local_shard_offset: int = 0,
                  multiprocess: bool = False) -> str:
    """The daemon's file in GUBER_SNAPSHOT_DIR (JAX snapshot.py:485): one
    a process, since mesh ranks share the directory: arena.snap for a
    single process, arena-r<shard offset>.snap for a mesh rank, holding
    its own shards."""
    name = (f"arena-r{local_shard_offset}.snap" if multiprocess
            else "arena.snap")
    return os.path.join(directory, name)


def _load_usable(engine, path: str) -> Optional[ArenaSnapshot]:
    """The file's snapshot if `engine` can import it, else None, logged: a
    missing, corrupt or unreadable file, or one of another geometry."""
    try:
        snap = load(path)
    except FileNotFoundError:
        log.info("no snapshot at %s; starting cold", path)
        return None
    except (SnapshotError, OSError) as e:
        log.warning("snapshot %s unusable (%s); starting cold", path, e)
        return None
    try:
        engine.check_snapshot(snap)
    except SnapshotError as e:
        log.warning("snapshot %s does not fit this engine (%s); starting "
                    "cold", path, e)
        return None
    return snap


def _restored(snap: ArenaSnapshot, path: str, metrics) -> ArenaSnapshot:
    age_ms = max(0, millisecond_now() - snap.now)
    if metrics is not None:
        metrics.restore_age.set(age_ms / 1000.0)
    log.info("restored %d keys from %s (age %.1fs)", snap.total_keys(), path,
             age_ms / 1000.0)
    return snap


def restore_engine(engine, path: str, rebase_to: Optional[int] = None,
                   metrics=None) -> Optional[ArenaSnapshot]:
    """Boot-time restore: load and import, degrading to a cold arena (with
    a warning) on any failure: a corrupt snapshot never blocks a boot.
    Returns the snapshot on success, None on a cold start."""
    snap = _load_usable(engine, path)
    if snap is None:
        return None
    try:
        engine.import_state(snap, rebase_to=rebase_to)
    except Exception as e:
        log.warning("snapshot %s failed to import (%s); starting cold",
                    path, e)
        return None
    return _restored(snap, path, metrics)


def global_digest(snap: ArenaSnapshot) -> str:
    """A mesh rank's snapshot stamp and GLOBAL part, hashed: equal on two
    ranks exactly when their files hold the same agreed tick with the same
    GLOBAL replica, configs, registrations and pending keys.  The GLOBAL
    table's expiries, which each rank's own lookups move, and its entries'
    order are left out."""
    h = hashlib.sha256(struct.pack("<q", int(snap.now)))
    for planes in (snap.gplanes, snap.gcfg):
        for name in sorted(planes):
            h.update(name.encode())
            h.update(np.ascontiguousarray(planes[name]).tobytes())
    keys, slots = (snap.gtable[0], snap.gtable[1]) if snap.gtable else ((), ())
    h.update(json.dumps(sorted(zip(keys, np.asarray(slots).tolist())))
             .encode())
    h.update(json.dumps(sorted(snap.gpending)).encode())
    return h.hexdigest()


def restore_mesh_engine(engine, path: str,
                        metrics=None) -> Optional[ArenaSnapshot]:
    """Boot-time restore of a mesh rank (engine.mesh).  The ranks' GLOBAL
    replicas must stay equal, and the all-reduce only adds deltas to them,
    so each rank restores its own file only when every rank holds a usable
    file of the same stamp and GLOBAL part (global_digest), compared
    through the group's store (Mesh.exchange); otherwise every rank starts
    cold, with a warning.  Returns the snapshot, or None on a cold start.
    A file the ranks agree on that then fails to import raises: the others
    restored theirs, and this rank cannot serve beside them."""
    snap = _load_usable(engine, path)
    mark = "" if snap is None else global_digest(snap)
    marks = engine.mesh.exchange("restore", mark)
    if not mark or len(set(marks)) != 1:
        if mark:
            log.warning("snapshot %s not restored: the ranks' files are of "
                        "different ticks or GLOBAL replicas, or one is "
                        "missing; every rank starts cold", path)
        return None
    engine.import_state(snap)
    return _restored(snap, path, metrics)
