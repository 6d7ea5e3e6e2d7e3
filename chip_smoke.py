"""Build the PyTorch/CUDA port's kernels and drive its serving path on one GPU.

    python3 chip_smoke.py

Phases (one line each; any mismatch raises and exits non-zero):

  1. device: the card (nvidia-smi name and power limit) and the nvcc builds
     of gubernator_tpu_torch/ops/csrc/window_drain.cu, global_window.cu,
     stats_finish.cu, window_math.cu and global_apply.cu, one nvcc each,
     started together;
  2. kernel vs plain: drain_compact on seeded windows (hot duplicates, AGG
     lanes, recycle inits, zero reads, cap edges, all five algorithms,
     negative CONCURRENCY hits; K in {1, 4}), on uniform runs that fold
     over an arena whose clock is often ahead, and window_full on int64
     values outside the compact caps, each bit for bit against the plain
     torch version (ops/kernel.py) on copies of the same arena, on the card,
     at the chosen partitions P and at P = 1 (the C entry point called
     directly, uncounted); one more drain holds the grid's edges (many
     virtual segments on one slot, a 64-lane folded run, row C - 1 beside
     slots past the arena, a clock that steps back); a line before it
     gives the chosen P, the CTAs and the shared memory per CTA;
  3. full size, one shard: a RateLimitEngine with a 2^24-slot arena (a
     random arena brought in with import_arena) and K=8 windows of B=1024
     lanes (half to 64 hot slots).  3a calls the kernel's wrappers
     directly: one window per launch, the same drain shape with no hot
     slots and with every lane on one key (the hot-key cost), the drain at
     P = 1 beside the chosen P, and window_full.  3b drives the engine's pipeline_dispatch: one
     drain compared with the plain version including the whole arena, then
     50 drains timed with CUDA events and 50 with the profiler (device time);
  4. the serving path end to end, one shard: RateLimitEngine() on its
     default device (warmup, a 1000-request window, scripted token / leaky /
     duplicate-burst / out-of-cap sequences against closed-form answers),
     Instance.get_rate_limits under asyncio and a 4-window
     pipeline_dispatch; the kernels' launch counters must move by what
     each entry point launches and the plain versions must not run;
  5. GLOBAL over 8 shards.  5a: global_window (one cluster launch per
     GLOBAL window) bit for bit against its plain version at G = 4096, 8 x
     256 lanes and 256 config lanes on edge windows (all five algorithms
     and out-of-range values, int64 wrapped at both ends, expired rows,
     algorithm switches, is_init, sums that cancel, rows read and reset in
     one window, config writes by negative index, pads below 0 and at G
     and past it in every lane kind), through the wrapper (the cluster
     size the kernel picks) and in clusters of 8 and 16 CTAs: the
     read block, every gstate and gcfg plane, and the scratch back at 0;
     then three such windows carrying 256 upsert lanes too (an owner's
     broadcast on a replica: rows also written or reset by config lanes,
     rows the lanes read, negative indices, pads), through global_window
     at each cluster size and through global_stage, the torch reads and
     global_apply, each against its plain version.  5b: drain_compact over 8 shards against its plain version, at the
     chosen P and at P = 1.  5c: a [8, 2^21] arena and a 4096-slot GLOBAL
     arena; K = 8 windows x 8 shards x 1024 lanes plus one GLOBAL window
     of 8 x 256 lanes (half on 16 hot keys, at most 256 keys, 70% token /
     30% leaky) through pipeline_dispatch_global with nows and the GLOBAL
     control as host arrays, compared with the plain versions including
     every plane of both arenas, the config and the scratch; one call
     under torch.cuda.set_sync_debug_mode("error") (any host sync before
     the fetch fails the run); then timed (CUDA events, profiler device
     time of each kernel in the call, the card's busy time); before that,
     and before the GLOBAL path's counts start, global_window is called
     directly on the same window, checked and timed alone at 8 and 16
     CTAs.  5d: serving on RateLimitEngine(num_shards=8): warmup, a
     1000-request window mixing regular and GLOBAL keys against the CPU
     plain engine (responses and every plane), scripted GLOBAL sequences
     (stale then consistent, a limit raise, leaky) against closed-form
     answers, Instance RPCs carrying GLOBAL items and the GLOBAL+GCRA
     refusal, the host wall per window.  5e, after the counts are read:
     the GLOBAL window alone at G = 4096 and G = 2^20 with the same 2048
     lanes over 256 keys, checked against its plain version and timed,
     and its phases read from the kernel's debug stamps; the time at 2^20
     must stay within twice the time at 4096 (nothing in the window reads
     or writes all G rows); beside 5c's window alone, the same window
     with 256 upsert lanes added, checked and timed through global_window
     and global_stage;
  6. traffic analytics over 8 shards.  6a: the stats drain
     (drain_compact_stats, window_drain.cu) and the finisher (stats_finish,
     stats_finish.cu) bit for bit against their plain versions on edge
     drains chained over one accumulator and sketch: CONCURRENCY releases,
     AGG lanes, slots past the arena, slot fields the drain pads and the
     oracle clips, tenant ids past both ends, ties in a narrow sketch,
     decay, an empty drain, K in {1, 4}, S in {1, 8}; the stats drain at
     the chosen P and at P = 1, accumulators compared whatever the order
     of their entries; the finisher at its chosen expiry slices a shard
     (its sketch and rank keys in shared memory) and at another count
     (the sketch in place, the keys rebuilt every pass).  6b: the phase-5c
     shape on a fresh engine with analytics enabled at the JAX package's
     defaults (D = 4, W = 2048, T = 64, topk = 32): 8 drains of K = 8 x 8 x
     1024 lanes plus the GLOBAL window through pipeline_dispatch_global
     (..., analytics_args), tenants from 64 ids with a few out of range,
     decay on every fourth drain, each drain's stats ingested into
     TrafficAnalytics; then the same call timed with and without analytics
     (CUDA events, card busy share, profiler device time of the stats
     drain, the plain drain and the finisher).  After the counts are read,
     the first drain is held against the plain versions on the card
     (arena, responses, sketch, stats, and its GLOBAL window's read block,
     gstate and gcfg) and against oracle_stats on the host.  Then the finisher's split at the same shape: its device time
     after a stats drain with topk 32 and 1 and over an empty
     accumulator, and its phases from globaltimer stamps;
  7. the per-op lowering (GUBER_PALLAS=1).  7a: window_math (window_math.cu)
     against its plain version on the preps of chained edge windows (all
     five algorithms and values past 4, releases, AGG runs, inits, pads, a
     mixed-config hot run longer than the replay cap, a folding hot run,
     lanes on row C - 1 and past the arena, int64 windows, a clock that
     steps back) at the default tile width and at 7 and 1024 lanes a
     CTA, and window_step_per_op against kernel.window_step; global_stage,
     the torch replica reads and global_apply (global_apply.cu) against
     their plain versions on phase 5a's edge windows at G = 4096 and
     G = 3000 (read block, gstate, gcfg, scratch back at 0).  7b: per-op
     twins of phase 3's one-shard engine and of phase 5c's 8-shard engine
     (with analytics at phase 6b's geometry), holding the same arenas as
     default engines: two pipeline_dispatch drains and a 1000-request
     process on one shard; pipeline_dispatch_global with the GLOBAL
     window, twice more with analytics (decay on the second) and a
     1000-request process with 20% GLOBAL on eight; then the two dispatch
     calls timed (CUDA events)
     and the new kernels' device time read (profiler).  7c, after the
     counts are read: the default engines take the same calls, and every
     output, response, arena plane and sketch must equal the per-op
     engines', both engines' GLOBAL scratch back at 0; their calls timed
     the same way.  Then window_math alone on
     three 1024-lane windows built as phase 3a builds its drains (half on
     64 hot slots, no hot slots, every lane on one key), each against its
     plain version, its device time beside its longest residual segment
     and its bound, at the default tile width and at 64 and 1024;
  8. the pipelined serving lane: Instance(engine_config=EngineConfig(
     capacity_per_shard=2^21, num_shards=8, batch_per_shard=1024,
     use_native="on")), the native router (g++, built at first use) and the
     DispatchPipeline, with Zipf (a = 1.1) keys over 2^20 keys in RPCs of
     100 items.  One drain's engine-thread path (router packing, the
     pinned copy in, the launch, the copies out, the event) under
     torch.cuda.set_sync_debug_mode("error"); 64 clients at saturation
     (decisions/s; again under the profiler for the card's idle share);
     open-loop offered rates of 25, 50 and 100% of that rate (p50/p99 call
     latency); phase 4's 1000-request window through engine.process on the
     router; two ~50k-decision bursts on a pinned clock at pipeline depth 1
     and 3 (70% token and leaky in the compact range, the rest GCRA,
     sliding window, concurrency and NO_BATCHING), then five configs past
     the compact caps; 8d, an Instance with analytics at phase 6b's
     geometry serving a compact burst (and one drain under sync debug
     mode).  After the counts are read: every burst response against a
     Python-table engine on the card running process() over the same
     stream, the analytics' hits total against the burst's and its top-K
     against the burst's hottest keys, and a small Instance (256 slots a
     shard) on the card against the same Instance on the CPU, responses
     and arena, and a K = 8 stack of the serving shape dispatched from a
     pinned tensor (the pipeline's route) and from a numpy array (the
     engine's staging buffers), timed; then one line of the end-to-end
     figures beside the card's name and power limit;
  9. the raw-bytes RPC lane: an Instance of phase 8's geometry served
     through gubernator_tpu_torch.server.serve_get_rate_limits with
     serialized 100-item GetRateLimitsReq of about 3.2 KB (Zipf keys over
     2^20, compact token and leaky), encoded and decoded by this script's
     small proto3 codec (the machine has no protobuf): C parse into the
     K-window stack, one drain_compact launch a drain, a CUDA event, C
     encode.  Two ~50k-decision bursts from 64 concurrent callers on a
     pinned clock, at depth 1 and at depth 3 with the occupancy gate off;
     saturation (gate on and off, each also profiled for the card's idle
     share), open-loop rates at 25/50/100%, and a run with the parse and
     the encode timed.  After the counts are read: every RPC staged once
     and none refused, every response decoded and held field for field
     against a Python-table engine on the card replaying the RPCs in the
     router's staging order, the first burst's arena shard by shard
     against that engine's; then one line of figures beside phase 8's;
 10. the state lifecycle (state/snapshot.py, state/tiers.py).  10a: an
     Instance at phase 8's geometry (8 x 2^21 slots, G = 4096, B = 1024,
     the router, depth 3, K up to 8) serves load A, ~100k decisions on the
     raw-bytes lane from 64 callers and ~2k GLOBAL items through
     get_rate_limits; it saves in each layout (int64, compact32) into a
     temporary directory, each step timed (the export on the engine
     thread, dumps, the write with fsync); each file is loaded and
     imported into a fresh Instance, timed, and the restored planes,
     GLOBAL planes and config, router tables and GLOBAL table are held
     against the export, shard by shard, on the card; then load B, ~50k
     decisions with GLOBAL items, one RPC at a time at the same pinned
     clocks on the uninterrupted Instance and on both restored ones: every
     response and both arenas must be equal; a file with one payload byte
     flipped gives restore_engine None and a cold Instance that serves.
     10b: the warm tier on the card: a Python-table engine with 8 x 2^9
     hot slots and a 2^20-row warm store, in each layout, against an
     8 x 2^18 twin without tiers (it never evicts) over 200 windows of up
     to 1000 requests (Zipf s = 1.2 over 2^20 keys, tests/test_tiers.py's
     law), every response bit for bit; the tier counters, the fences with
     work and their median wall time, the tiered engines' drain launches;
 11. leases and QoS at the JAX package's defaults, on Instances of phase
     8's geometry (QoS on, GUBER_FETCH_STRIDE_MAX=4; a twin with QoS off;
     a small Instance with analytics and the SLO engine).  11a: 64 clients
     acquire CONCURRENCY slots (limit 8, hits 1-3) over 2^16 keys through
     get_rate_limits(client_id=), release some explicitly, and half vanish
     through the server's stream-close hook (a fake context whose RPC was
     cancelled); GUBER_LEASE_MAX_PER_CLIENT = 2 then answers an acquire on
     the host, launching nothing.  11b: 64 callers of 100-item RPCs at an
     admission bound of 2048, 8 of them with deadlines shorter than a
     drain: sheds in-band with queue_full and deadline; the congestion
     window, the effective depth and the fetch stride at every drain; the
     health check sampled (saturated while the queue is full, healthy
     after); saturation with QoS on and off; one drain of the analytics
     Instance past its bound (its sheds reach the SLO engine); drain()
     closes intake and a later request is shed with draining.  After the
     counts are read: the serial oracles (algorithms/oracles.py) over the
     logged lease stream give every lease answer; every lease key's row on
     the card holds what the lease book says; a Python-table engine on the
     card replaying everything the Instance's engine thread decided, in
     its order, gives every admitted answer, and its arena holds the same
     rows (no shed touched the arena); a snapshot restored into the twin
     brings the lease book back equal.  Phases 8 and 8d submit their
     ~50k-decision bursts in groups of at most the admission bound's
     items (more at once would be shed; 11b drives the sheds), and phase
     9 checks that the bytes lane never fills the queue (a saturated
     queue sends RPCs to the protobuf path, which the card's machine
     lacks);
 12. the peer ring: three Instances at phase 8's geometry on the one card
     (8 x 2^21 slots, G = 4096, B = 1024, QoS at the JAX defaults), each
     advertising node<i>:81, joined by Instance.set_peers over an
     in-process transport defined here (RingLoopback: GetPeerRateLimits
     bytes into the owner's serve_peer_rate_limits, or, where protobuf
     cannot be imported for a body the C parser refuses, this script's
     codec and Instance.get_peer_rate_limits; UpdatePeerGlobals into
     Instance.update_peer_globals); everything above the transport runs
     as deployed: the ring, the C classification and splicing, the peer
     clients' batching windows and breakers, the GLOBAL managers.
     Traffic is phase 8's: Zipf (a = 1.1) keys over 2^20 in 100-item RPCs
     of compact token and leaky, round-robin to the nodes.  12a, the
     per-item path (Instance.get_rate_limits): 60 RPCs one at a time on a
     pinned clock, a 20k-decision burst from 64 callers, saturation on
     the wall clock (again under the profiler).  12b, the raw-bytes lane
     (serve_get_rate_limits on serialized RPCs; mixed RPCs forward their
     remote items as bytes): the same.  12c: 2k token and leaky GLOBAL
     items over 256 keys from every node; the GLOBAL managers quiesced,
     then every node flushes twice (the hits, then the broadcasts of what
     they changed); a hits = 0 probe of every key on every node.  After
     the counts are read: the sequential parts against a serial
     standalone engine on the card replaying the same requests at the
     same clock; every forwarded answer's owner against the ring; for
     every key of the bursts, limit - remaining on its owner equals the
     hits answered under the limit; no key has a row in a non-owner's
     router (export_keys); the probes equal on every node, every
     replica's GLOBAL row equal to its owner's (a key no item hit stays
     unwritten on its owner: a zero sum writes no row) and the owner's to
     the serial engine's; drain_compact launched on every node and
     global_window ran owner windows, replica reads and upsert windows;
     then one line of figures (decisions/s of 12a and 12b at saturation,
     the share of items forwarded, the forward round trip's p50 and p99,
     broadcasts and upserts, the card's idle share, the phase's wall).
 13. failure handling and live migration: four Instances at phase 12's
     geometry on the Python slot tables (live migration needs key
     strings, which the native router does not keep), QoS at the JAX
     defaults, over RingLoopback (TransferBuckets bytes into
     server.serve_transfer_buckets, HealthCheck into
     Instance.health_check; a node listed dead raises UNAVAILABLE), the
     clock pinned.  2^18 regular keys (token and leaky, compact, 1-3
     hits) and 2048 GLOBAL keys are seeded through their owners' engines
     in 1000-request windows, and 512 CONCURRENCY leases through the
     first founder.  13a: a fourth node joins (its ring point takes 0.228
     of the key space) and the founders run migrate_keys: 0.2-0.3 of the
     keys move, all to it, each then on one node; kept keys keep their
     slots; each moved row equals its source row before the move, bit
     for bit, GLOBAL rows too (registered on the new owner), lease rows
     with them; then every moved key and a 16384-key sample of kept keys
     take one more hit through Instance.get_rate_limits (100-item RPCs,
     round-robin).  13b: the fourth node leaves through the daemon's
     handoff step (Daemon._handoff_keys), the survivors re-join and its
     keys take one more hit.  13c: the third founder's loopback fails;
     the first founder's GLOBAL hits for 64 keys it owns are hinted;
     HeartbeatMonitors on the other two (suspect_after = recover_after =
     2), stepped by probe_once, confirm it DOWN in 2 rounds and both rings
     converge; 8192 of its keys and 8192 others take a hit (no error, its
     keys cold); healed, it is UP in 2 rounds, the rings include it
     again, the hints replay.  After the counts are read, a serial
     Python-table engine on the card replays every decided request in
     order and every answer must equal it (13c's hits on the killed
     node's keys: a cold engine's); the owner's rows of the hinted keys
     equal an uninterrupted run's.  13d: phase 8's Instance (router,
     pipelined lane at depth 3); one engine_dispatch fault rule (drop 1,
     times 1) under 256 serialized 100-item RPCs of distinct keys from
     64 callers fails exactly one drain's RPCs; every RPC again, and 64
     new ones, then equal a serial router engine that never saw the
     failed drain.  Figures: rows moved a migrate_keys (regular, GLOBAL,
     lease), payload bytes, the wall split (quiesced export, encode,
     transfer with the destination's import, remove), rows a second, the
     longest engine-thread pause on a source and a destination, detector
     rounds, kill to converged rings.
 14. the front door (frontdoor.py): phase 9's Instance (8 x 2^21 slots,
     B = 1024, router, pipeline and QoS at the JAX defaults, analytics
     off) under a FrontdoorHub of 2 workers, 64 ring slots each (fewer,
     with the cut printed, when /dev/shm is too small: its size is
     printed first) and batch reads 8.  14a, always: the workers are
     frontdoor_replay.py processes (no torch, no gRPC: the worker's own
     path, _WorkerV1.GetRateLimits, fed serialized RPCs), 32 callers
     each; the engine needs protobuf, whose path the RAW records take
     (14a fails at once, saying so, where it does not import).  A
     pinned-clock burst of about 50k decisions: phase 9's
     100-item RPCs, 3000 single-item RPCs on keys of their own (coalesced
     into batch records, or RAW) and 600 single GLOBAL items (RAW records
     into the GLOBAL window), shuffled, with the engine's order logged
     (FrontDoorLog); then on the wall clock saturation (again under the
     profiler), open-loop rates at 25/50/100% of it, and a saturating run
     with the engine's host steps timed.  After the counts are read:
     every burst RPC's response bytes equal a serial router engine on the
     card replaying the logged order (RPCs of equal bytes compare as a
     multiset), each RPC applied once, no shed, no call of a timed run
     failed, and one process holds a CUDA context, the engine:
     nvidia-smi lists one compute app, not a worker's pid, and only the
     engine maps CUDA.  14b,
     where grpc imports: the real gRPC workers, 64 gRPC callers,
     three bursts held against the serial engine the same way, a worker
     SIGKILLed a fifth into the second (every staged RPC is the bytes of
     one sent, and a failed one applied once or never; the respawn takes
     the same port); where grpc does not import, one line says so.
     Figures: decisions/s answered at saturation beside phase 9's, each
     saturating run's RPCs and sheds, at the offered rates the decisions
     answered, the RPCs answered with no shed item and their p50 and p99
     latency, and the sheds, the card's idle share, the engine's
     host microseconds an RPC by step (ring pop, pack_stack_fast, other
     staging, dispatch, fetch wait and decode, completion write) beside
     phase 9's, the workers' parse and encode, records by kind, encode
     paths, sheds and ring stalls, and the drain's wall split into
     window_fill, device_dispatch and drain_commit from the Instance's
     stage histograms (14a's Instance has a Metrics registry).
 15. device profiling (observability/devprof.py, introspect.py): phase
     9's Instance with a Metrics registry, a tracer and the periodic
     capture controller (GUBER_DEVPROF=periodic, an interval that never
     fires by itself).  15a: an 8-drain capture armed through
     batcher.profile while 64 callers send phase 9's serialized RPCs
     through serve_get_rate_limits; the capture's drain_compact_kernel
     events equal the wrapper's launches over the armed drains, each
     joined to composed_drain, none to the remainder bucket; the kernel
     table's drain time a window (the trace folded into the Instance's
     table) beside the CUDA-event time of the same stacks replayed on a
     copy of the arena (launch_compact, uncounted), within 2x.  15b:
     measure_census_arms on the card, the arms at the serving geometry
     (8 x 2^21 slots, K = 8, B = 1024): every arm a measured ms/window
     above 0 and hand-kernel events a window equal to its census (the
     wrappers' launches a window, the same runs and census_table's), each
     hand kernel's profiler time a launch beside the CUDA-event time of
     its arm's call.  15c: tracing at sample 1.0, RPCs under `rpc`
     roots, 200 one at a time from one caller, then the 64 callers at
     saturation: over the sequential RPCs (the regime of the JAX test
     that sets the bound: each RPC alone in its drain) the
     admission_wait, window_fill, device_dispatch and drain_commit
     histogram totals within [0.02x, 2x + 50 ms] of the end-to-end RPC
     total; over both, every traced RPC with its four drain-stage spans,
     the window clock and each stage histogram one sample a drain;
     decisions/s at saturation beside phase 9's, and the histograms'
     share of the end-to-end total there (about one over the RPCs a
     drain carries).  15d: one periodic
     controller cycle while the callers serve: it folds rows and leaves
     no trace directory.  Then a fresh process serves a small Instance
     and arms its first capture: the profiler's start there is the cold
     initialisation an engine thread pays once.

Thirteen main paths are counted, each from 0: the one-shard path (phases
3b and 4), the GLOBAL path over 8 shards (phases 5c and 5d), the analytics
path (phase 6b), the per-op path (phase 7b), the pipelined serving path
(phase 8, from requests), the raw-RPC lane (phase 9, from wire bytes),
the state lifecycle (phase 10), the lease and QoS path (phase 11,
which must launch drain_compact), the peer ring (phase 12, which must
launch drain_compact and global_window and nothing else), migration
(phases 13a-13c, drain_compact and global_window, window_full allowed,
nothing else), the dispatch fault (phase 13d, drain_compact only) and
the front door (phase 14, drain_compact and global_window, nothing else)
and device profiling (phase 15, drain_compact on the serving path and
every arm's kernels in the measured pass);
each must launch its kernels and never
run a plain version, the per-op path must launch no kernel but
window_math, global_stage and global_apply, the raw-RPC lane none but
drain_compact, once a drain, and the lifecycle none but drain_compact and
global_window.  The kernel table's launch counts are drain_compact's (the
first path's and the fifth's to the thirteenth's) and window_full's on
the first, the eighth, the tenth and the thirteenth, global_window's on
the second, the seventh to the tenth and the twelfth, drain_compact_stats'
and stats_finish's on the third, the fifth, the eighth and the
thirteenth, and
window_math's, global_stage's and global_apply's on the fourth; calls of
a wrapper made only to check or time it against its plain version come
before the counts start or after they are read.  The third-to-last line is the kernel
table as JSON, the next the card's nvidia-smi name and power limit; the
last line is {"ok": true, "device": {...}}.  Tolerance everywhere is exact
equality: every quantity is an integer.
"""

import asyncio
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: no CUDA device; this script only runs on a GPU")

from gubernator_tpu_torch.api.types import (  # noqa: E402
    Algorithm,
    Behavior,
    RateLimitReq,
    millisecond_now,
)
from gubernator_tpu_torch.config import (  # noqa: E402
    AnalyticsConfig,
    BehaviorConfig,
    EngineConfig,
    SLOConfig,
    TierConfig,
)
from gubernator_tpu_torch.core.engine import RateLimitEngine  # noqa: E402
from gubernator_tpu_torch.core.service import Instance  # noqa: E402
from gubernator_tpu_torch.ops import build  # noqa: E402
from gubernator_tpu_torch.ops import drain_kernel as dk  # noqa: E402
from gubernator_tpu_torch.ops import global_kernel as gk  # noqa: E402
from gubernator_tpu_torch.ops import analytics as ta  # noqa: E402
from gubernator_tpu_torch.ops import kernel as tk  # noqa: E402
from gubernator_tpu_torch.ops import stats_kernel as sk  # noqa: E402
from gubernator_tpu_torch.ops import window_math_kernel as wm  # noqa: E402
from gubernator_tpu_torch.observability.analytics import (  # noqa: E402
    TrafficAnalytics,
)
from gubernator_tpu_torch.server import (  # noqa: E402
    FASTPATH_MIN_BYTES,
    serve_get_rate_limits,
)
from gubernator_tpu_torch.state import snapshot as snapmod  # noqa: E402

DEV = torch.device("cuda")
T0 = 1_754_000_000_000
# NVIDIA's H100 SXM data sheet: device memory rate, at the full 700 W
# power limit
HBM_BYTES_PER_S = 3.35e12
# scalar integer work issues at the INT32 rate: 64 lanes an SM a clock
# (the SM's INT32 units, NVIDIA H100 Tensor Core GPU Architecture white
# paper) x 132 SMs x the 1.98 GHz boost clock (the SXM data sheet)
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# 32-bit instructions an int64 floor division (ladder.cuh fdiv) issues at
# least, counted in the SASS of window_math.cu's sm_90a build (cuobjdump
# -sass build/libwindow_math.so): a test of the operands' high words, a
# 32-bit reciprocal division of 23 instructions and the floor's
# correction; operands past 32 bits call an 83-instruction routine
# instead, which the bounds do not count
FDIV_OPS = 30
# the int64 divisions a transition (ladder.cuh: the leak rate and the
# leaked balance) and a Fold (fold.cuh: Rt_q, rate0, Kf, the GCRA raw
# capacity and its quotient, the sliding roll's window count, position
# and estimate, s_q) issue whatever the algorithm
TRANSITION_DIVS, FOLD_DIVS = 2, 9
SECTOR = 32                 # bytes per scattered arena access
PLANES = 6
SOURCE = "gubernator_tpu_torch/ops/csrc/window_drain.cu"
GLOBAL_SOURCE = "gubernator_tpu_torch/ops/csrc/global_window.cu"
STATS_SOURCE = "gubernator_tpu_torch/ops/csrc/stats_finish.cu"
MATH_SOURCE = "gubernator_tpu_torch/ops/csrc/window_math.cu"
APPLY_SOURCE = "gubernator_tpu_torch/ops/csrc/global_apply.cu"
# phase 3: the survey's 100M keys over 8 chips (12.5M a chip), rounded up to
# a power of two; the top of the JAX engine's stacked-drain depths
# (PIPELINE_K_BUCKETS, gubernator_tpu/core/engine.py:68-84); the engine's
# default window width
FULL_CAPACITY = 1 << 24
FULL_K = 8
FULL_LANES = 1024
TIMED_DRAINS = 50
# phase 5: the JAX package's 8-device mesh as 8 shards on the card, the same
# 2^24 slots as [8, 2^21]; the JAX engine's GLOBAL defaults
# (gubernator_tpu/core/engine.py:152-160): 4096 slots, 256 lanes per shard
# per window, 256 distinct keys per window
SHARDS = 8
G_FULL = 4096
BG_FULL = 256
KG_FULL = 256
I64_MAX, I64_MIN = 2**63 - 1, -2**63
# phase 6: the JAX package's analytics defaults
# (gubernator_tpu/config.py:246-269)
ANALYTICS = dict(topk=32, sketch_width=2048, sketch_depth=4, decay_ms=10_000,
                 tenant_slots=64, over_weight=4)
ANALYTICS_DRAINS = 8


def log(msg):
    print(msg, flush=True)


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


# ---------------------------------------------------------------- inputs

def random_windows(rng, K, B, C, hot=6, cap_edges=False):
    """K compact windows (numpy i64[K, B, 2]): pads, duplicate-heavy hot
    slots, AGG runs, recycle inits, zero reads, all five algorithms,
    negative CONCURRENCY hits, optionally cap-edge configs."""
    out = np.zeros((K, B, 2), np.int64)
    for k in range(K):
        slot = rng.integers(0, C, B).astype(np.int32)
        dup = rng.random(B) < 0.5
        slot[dup] = rng.integers(0, C, hot)[rng.integers(0, hot, int(dup.sum()))]
        slot[rng.random(B) < 0.15] = tk.PAD_SLOT
        algo = rng.integers(0, 5, B).astype(np.int32)
        hits = rng.choice([0, 0, 1, 1, 2, 7], B).astype(np.int64)
        conc = algo == tk.CONCURRENCY
        rel = conc & (rng.random(B) < 0.4)
        hits[rel] = -rng.integers(1, 9, int(rel.sum()))
        limit = rng.integers(1, 1000, B).astype(np.int64)
        duration = rng.integers(1, 600_000, B).astype(np.int64)
        if cap_edges:
            edge = rng.random(B) < 0.2
            big = (rng.random(B) < 0.1) & ~conc
            hits[big] = tk.COMPACT_MAX_HITS - 1
            limit[edge] = tk.COMPACT_MAX_LIMIT - 1
            duration[edge & (algo != tk.SLIDING_WINDOW)] = \
                tk.COMPACT_MAX_DURATION - 1
        is_init = rng.random(B) < 0.1
        agg = (rng.random(B) < 0.1) & (slot >= 0) & (hits > 0) & (algo <= 1)
        eslot = np.where(agg, slot | tk.AGG_SLOT_BIT, slot).astype(np.int32)
        out[k] = tk.encode_batch_host(eslot, hits, limit, duration, algo,
                                      is_init)
    return out


def random_arena(gen, C, now, device, S=1):
    """[S, C] arena rows as serving would leave them: configs inside the
    compact caps, times within a few minutes of `now` (about half
    expired)."""
    def ri(lo, hi):
        return torch.randint(lo, hi, (S, C), generator=gen, device=device,
                             dtype=torch.int64)
    limit = ri(1, 1000)
    return tk.BucketState(
        limit=limit, duration=ri(1_000, 600_000),
        remaining=torch.remainder(ri(0, 1 << 20), limit + 1),
        tstamp=now + ri(-300_000, 300_000), expire=now + ri(-300_000, 300_000),
        algo=ri(0, 5).to(torch.int32))


def clone(arena):
    return type(arena)(*[t.clone() for t in arena])


def assert_same(a, b, what):
    for name, x, y in zip(a._fields if hasattr(a, "_fields") else range(len(a)),
                          a, b):
        if not torch.equal(x, y):
            bad = (x != y).nonzero()[:5].flatten().tolist()
            raise AssertionError(f"{what}.{name} differs at {bad}")


def max_abs_err(pairs):
    err = 0
    for x, y in pairs:
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max()))
    return err


def touched_slots(packed):
    """Distinct valid slots over the whole drain: a K-window drain need
    read and write each arena row only once."""
    bt = tk.decode_batch(packed)
    s = bt.slot[bt.slot >= 0] & ~tk.AGG_SLOT_BIT
    return int(torch.unique(s).numel())


def bound_ms(lanes, in_bytes, out_bytes, slots,
             ops_per_lane=400 + TRANSITION_DIVS * FDIV_OPS):
    """The least time for one launch: bytes each input read once, each
    output written once, each touched arena row read and written on six
    planes at sector granularity; or the scalar integer work at the INT32
    rate, whichever is larger.  `ops_per_lane` counts that work in 32-bit
    operations: about 2 x 55 of the sort's compare-exchanges at 1024
    lanes, the decode and encode, ~100 int64 operations (~200 in 32-bit
    units) of the ladder, and its transition's divisions."""
    nbytes = lanes * (in_bytes + out_bytes) + slots * PLANES * SECTOR * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = lanes * ops_per_lane / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def lane_bytes(*planes):
    """Bytes a lane (or row) of these [N] planes holds: the sum of their
    element sizes."""
    return sum(t.element_size() for t in planes)


def cuda_ms(fn, n):
    """Mean device ms per call over n calls (the caller warms up)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / n


def device_busy_ms(fn, n):
    """Mean device time per call (ms) of every kernel, copy and fill the
    card ran over n calls, from a torch.profiler trace; None when the trace
    shows no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / n / 1e3 if busy_us else None


def device_ms(fn, n, kernel_name):
    """Mean device time (ms) of the kernel named `kernel_name` per launch
    over n calls, from a torch.profiler CUDA trace; None when the trace
    shows no device time for it (CUDA events then stand in)."""
    return device_ms_each(fn, n, (kernel_name,))[kernel_name]


def device_ms_each(fn, n, kernel_names):
    """device_ms of each of several kernels from one trace of n calls."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for name in kernel_names:
        total_us = count = 0
        for e in prof.key_averages():
            if name in e.key:
                total_us += (getattr(e, "device_time_total", None)
                             or getattr(e, "cuda_time_total", 0) or 0)
                count += e.count
        out[name] = total_us / count / 1e3 if count and total_us else None
    return out


# ---------------------------------------------------------------- phases

def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    # every source at once, one nvcc each
    sources = (dk.SOURCE, gk.SOURCE, sk.SOURCE, wm.SOURCE, gk.APPLY_SOURCE)
    t0 = time.perf_counter()
    build.build(sources)
    dk.load_library()
    gk.load_library()
    sk.load_library()
    wm.load_library()
    gk.load_apply_library()
    load_s = time.perf_counter() - t0
    builds = []
    for name in sources:
        secs, out = build.build_info.get(name, (0.0, ""))
        regs = [ln.strip() for ln in out.splitlines() if "registers" in ln]
        builds.append(f"{name}.cu {secs:.1f} s, ptxas: {' | '.join(regs)}")
    log(f"phase 1 device: {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; nvcc builds in parallel, {load_s:.1f} s in "
        f"all: {'; '.join(builds)}")
    return smi


def phase_kernel_vs_plain():
    rng = np.random.default_rng(2024)
    gen = torch.Generator(device=DEV).manual_seed(2024)
    C = 4096
    n_windows = 0
    errs = []
    # (K, lanes, hot slots, traffic): K in {1, 4}; powers of two and not
    # (the kernel pads its sort to one); up to the 16384-lane shared-memory
    # cap.  "mixed" draws each lane's config apart, so hot runs replay lane
    # by lane; "uniform" gives a key one config, so its runs fold, over an
    # arena whose clock is often ahead of the window's (negative leaks).
    shapes = [(4, 256, 6, "mixed"), (4, 256, 6, "mixed"),
              (1, 256, 6, "mixed"), (1, 200, 6, "mixed"),
              (4, 100, 6, "mixed"), (1, 37, 6, "mixed"),
              (4, 3000, 64, "mixed"), (1, dk.MAX_LANES, 2048, "mixed"),
              (4, 256, 8, "uniform"), (1, 1024, 64, "uniform"),
              (4, 1024, 4, "uniform"), (4, 1024, 0, "grid edges")]
    for i, (K, lanes, hot, traffic) in enumerate(shapes):
        arena = random_arena(gen, C, T0, DEV)
        if traffic == "uniform":
            # rows hold the config their key's traffic sends
            algo, limit, duration = (torch.from_numpy(a).to(DEV)[None]
                                     for a in slot_config(np.arange(C)))
            arena = arena._replace(
                algo=algo, limit=limit, duration=duration,
                remaining=torch.remainder(arena.remaining, limit + 1))
        nows = torch.tensor([T0 + 997 * (k + 1) * (i + 1) for k in range(K)],
                            dtype=torch.int64, device=DEV)
        if traffic == "mixed":
            packed = random_windows(rng, K, lanes, C, hot=hot,
                                    cap_edges=(i % 2 == 1))
        elif traffic == "uniform":
            packed = full_size_traffic(rng, K, lanes, C, 0.5, hot)
        else:
            packed = grid_edge_windows(rng, K, lanes, C)
            nows[1] = nows[0] - 300      # the clock steps back
        plain_arena, one_arena = clone(arena), clone(arena)
        packed = torch.from_numpy(packed[:, None]).to(DEV)
        got = dk.drain_compact(arena, packed, nows)
        one = dk.launch_compact(one_arena, packed, nows, P=1)
        want = dk.drain_compact_plain(plain_arena, packed, nows)
        torch.cuda.synchronize()
        for what, g, a in (("chosen P", got, arena), ("P = 1", one, one_arena)):
            assert_same(g, want, f"drain {i} (K={K}, {what}) outputs")
            assert_same(a, plain_arena, f"drain {i} (K={K}, {what}) arena")
            errs += list(zip(g, want)) + list(zip(a, plain_arena))
        n_windows += K
    drain_err = max_abs_err(errs)

    errs = []
    full_lanes = [256, 1000, 256, 77]
    for i, B in enumerate(full_lanes):
        arena = random_arena(gen, C, T0, DEV)
        plain_arena = clone(arena)
        bt = tk.decode_batch(torch.from_numpy(
            random_windows(rng, 1, B, C)[0]))
        big = torch.from_numpy(rng.random(B) < 0.5)
        bt = tk.WindowBatch(
            slot=bt.slot, is_init=bt.is_init,
            hits=torch.where(torch.from_numpy(rng.random(B) < 0.2),
                             torch.from_numpy(rng.integers(-5, 2**33, B)),
                             bt.hits),
            limit=torch.where(big, torch.from_numpy(
                rng.integers(2**31, 2**45, B)), bt.limit),
            duration=torch.where(big, torch.from_numpy(
                rng.integers(2**31, 2**40, B)), bt.duration),
            algo=torch.where(torch.from_numpy(rng.random(B) < 0.1),
                             torch.tensor(9, dtype=torch.int32), bt.algo))
        bt = tk.WindowBatch(*[t.contiguous().to(DEV)[None] for t in bt])
        now = T0 + 10**9 * (i + 1)
        one_arena = clone(arena)
        got = dk.window_full(arena, bt, now)
        one = dk.launch_full(one_arena, bt, now, P=1)
        want = dk.window_full_plain(plain_arena, bt, now)
        torch.cuda.synchronize()
        for what, g, a in (("chosen P", got, arena), ("P = 1", one, one_arena)):
            assert_same(g, want, f"full window {i} ({what}) outputs")
            assert_same(a, plain_arena, f"full window {i} ({what}) arena")
            errs += list(zip(g, want)) + list(zip(a, plain_arena))
    full_err = max_abs_err(errs)
    log(f"phase 2 kernel vs plain: drain_compact {n_windows} windows "
        f"(K in 1,4; B in {sorted({sh[1] for sh in shapes})}; C={C}; mixed "
        f"and uniform runs, and grid edges: many virtual segments on one "
        f"slot, a 64-lane folded run, row C - 1 beside slots past the "
        f"arena, a clock that steps back) and "
        f"window_full 4 int64 windows (B in {sorted(set(full_lanes))}), "
        f"each at the chosen P and at P = 1, "
        f"bit-exact (max_abs_err {drain_err}, {full_err})")
    return drain_err, full_err


def grid_plans():
    """Log how the drain's entry points lay out on this card: P, CTAs,
    threads, shared memory per CTA and workspace, at the main paths'
    shapes and at the phase-2 widths that take a workspace."""
    rows = []
    for kind, B, S, T in (
            ("drain_compact", FULL_LANES, 1, 0),
            ("window_full", FULL_LANES, 1, 0),
            ("drain_compact", FULL_LANES, SHARDS, 0),
            ("drain_compact_stats", FULL_LANES, SHARDS,
             ANALYTICS["tenant_slots"]),
            ("drain_compact", 3000, 1, 0),
            ("drain_compact", dk.MAX_LANES, 1, 0)):
        pl = dk.plan(kind, B, S, T)
        rows.append(f"{kind} B={B} S={S}: P={pl['P']}, {pl['P'] * S} CTAs of "
                    f"{pl['threads']} threads, {pl['smem']} B shared memory "
                    f"each, workspace {pl['workspace']} B")
    log(f"phase 2 grid: {'; '.join(rows)}")


def grid_edge_windows(rng, K, B, C):
    """K compact windows (numpy i64[K, B, 2]) shaped like the host build's
    grid tests (tests/test_torch_drain_host.py): 200 lanes on one hot slot
    cut into many virtual segments by is_init lanes, uniform segments
    (they fold) between mixed ones (they replay), algorithm values 0..7; a
    64-lane run on a second slot with the row's own config (token) and
    three leading zero-hit lanes; 16 lanes on slot C - 1 and 24 on slots
    past the arena; the rest random, pads among them."""
    out = np.zeros((K, B, 2), np.int64)
    for k in range(K):
        slot = rng.integers(0, C - 1, B).astype(np.int32)
        algo = rng.integers(0, 5, B).astype(np.int32)
        hits = rng.integers(0, 4, B).astype(np.int64)
        limit = rng.integers(1, 1000, B).astype(np.int64)
        duration = rng.integers(10, 600_000, B).astype(np.int64)
        is_init = rng.random(B) < 0.05
        agg = np.zeros(B, bool)
        pos = rng.permutation(B)
        seg, fold, edge = np.sort(pos[:200]), np.sort(pos[200:264]), pos[264:304]
        hot = int(rng.integers(0, C - 1))
        slot[seg] = hot
        i = 0
        while i < len(seg):
            m = min(len(seg) - i, int(rng.integers(1, 12)))
            at = seg[i:i + m]
            is_init[at] = False
            is_init[at[0]] = rng.random() < 0.9
            if rng.random() < 0.5:
                a = int(rng.integers(0, 8))
                h = int(rng.integers(1, 4))
                if a == tk.CONCURRENCY and rng.random() < 0.5:
                    h = -h
                algo[at], limit[at] = a, int(rng.integers(1, 1000))
                duration[at] = int(rng.integers(10, 600_000))
                hits[at] = np.where(rng.random(m) < 0.3, 0, h)
            else:
                algo[at] = rng.integers(0, 8, m)
                conc = algo[at] == tk.CONCURRENCY
                hits[at] = np.where(conc & (rng.random(m) < 0.4),
                                    -rng.integers(1, 6, m),
                                    rng.integers(0, 6, m))
                agg[at] = (algo[at] <= 1) & (hits[at] > 0) & (
                    rng.random(m) < 0.3)
            i += m
        two = (hot + 1) % (C - 1)
        slot[fold], algo[fold], is_init[fold] = two, 0, False
        limit[fold], duration[fold] = 1000, 60_000
        hits[fold] = np.where(rng.random(64) < 0.2, 0, 1)
        hits[fold[:3]] = 0
        slot[edge[:16]] = C - 1
        slot[edge[16:]] = C + rng.integers(0, 50, 24)
        slot[rng.random(B) < 0.05] = tk.PAD_SLOT
        eslot = np.where(agg & (slot >= 0), slot | tk.AGG_SLOT_BIT,
                         slot).astype(np.int32)
        out[k] = tk.encode_batch_host(eslot, hits, limit, duration, algo,
                                      is_init)
    return out


def slot_config(slot):
    """A key's (algo, limit, duration) in full_size_traffic: it follows the
    slot.  60% token, 30% leaky, 10% over GCRA / sliding / concurrency."""
    mix = slot % 100
    algo = np.select([mix < 60, mix < 90, mix < 94, mix < 97],
                     [0, 1, 2, 3], 4).astype(np.int32)
    limit = 10 + (slot * 2654435761) % 990
    duration = np.asarray([1_000, 60_000, 3_600_000])[slot % 3]
    return algo, limit, duration


def full_size_traffic(rng, K, B, C, hot_share=0.5, n_hot=64):
    """Phase 3 traffic: `hot_share` of the lanes on `n_hot` hot slots, the
    rest uniform over the arena; 10% AGG runs, 5% inits; 60% token, 30%
    leaky, 10% over GCRA / sliding / concurrency; a key's config follows
    its slot."""
    out = np.zeros((K, B, 2), np.int64)
    hot = rng.integers(0, C, n_hot)
    for k in range(K):
        slot = rng.integers(0, C, B).astype(np.int64)
        h = rng.random(B) < hot_share
        slot[h] = hot[rng.integers(0, n_hot, int(h.sum()))]
        algo, limit, duration = slot_config(slot)
        hits = np.where(rng.random(B) < 0.1, 0, 1).astype(np.int64)
        conc = algo == tk.CONCURRENCY
        hits[conc & (rng.random(B) < 0.3)] = -1
        agg = (rng.random(B) < 0.1) & (algo <= 1)
        hits[agg] = rng.integers(2, 17, int(agg.sum()))
        is_init = rng.random(B) < 0.05
        eslot = np.where(agg, slot | tk.AGG_SLOT_BIT, slot).astype(np.int32)
        out[k] = tk.encode_batch_host(eslot, hits, limit.astype(np.int64),
                                      duration.astype(np.int64), algo,
                                      is_init)
    return out


def longest_segments(packed):
    """Per window of compact words (numpy i64[K, B, 2]), the most lanes of
    one virtual segment (a slot's run, cut at is_init lanes): the longest
    chain a replayed segment walks on one thread."""
    out = []
    for w0 in packed[..., 0]:
        raw = ((w0 & 0xFFFFFFFF) - 1).astype(np.int64)
        keep = (raw >= 0) & (raw < 1 << 31)
        slot = raw[keep] & ~tk.AGG_SLOT_BIT
        init = ((w0[keep] >> 32) & 1).astype(bool)
        order = np.argsort(slot, kind="stable")
        slot, init = slot[order], init[order]
        start = np.r_[True, slot[1:] != slot[:-1]] | init
        edges = np.r_[np.flatnonzero(start), slot.size]
        out.append(int(np.diff(edges).max()) if slot.size else 0)
    return out


def full_size_engine(gen):
    """The phase-3 engine: a 2^24-slot arena on the card holding a random
    arena, imported the way a state transfer would bring it in."""
    eng = RateLimitEngine(capacity_per_shard=FULL_CAPACITY,
                          batch_per_shard=FULL_LANES)
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    arena = random_arena(gen, FULL_CAPACITY, T0, DEV)
    eng.import_arena({name: t.cpu().numpy()
                      for name, t in zip(tk.BucketState._fields, arena)})
    return eng


def phase_kernel_full_size(eng, packed, nows):
    """Phase 3a: the kernel's wrappers called directly on the full-size
    arena: one window per launch (the engine's single-window compact step),
    the hot-key cost, the phase-3b drain at P = 1 and at the chosen P, and
    window_full at the engine's width."""
    arena = eng.state
    plain_arena = clone(arena)
    B = packed.shape[2]

    one, now1 = packed[:1].contiguous(), nows[:1].contiguous()
    dk.drain_compact(arena, one, now1)  # warm-up
    k1_ms = device_ms(lambda: dk.drain_compact(arena, one, now1), 20,
                      "drain_compact_kernel")
    if k1_ms is None:
        k1_ms = cuda_ms(lambda: dk.drain_compact(arena, one, now1), 20)
    dk.drain_compact_plain(plain_arena, one, now1)  # warm-up
    k1_plain = cuda_ms(lambda: dk.drain_compact_plain(plain_arena, one, now1),
                       3)
    k1_bound, _ = bound_ms(B, 16, 16, touched_slots(one))
    log(f"phase 3a K=1 drain: B={B} on the 2^24-slot arena: kernel "
        f"{k1_ms:.4f} ms device, plain {k1_plain:.2f} ms, byte bound "
        f"{k1_bound * 1e3:.3f} us")

    # the serial walk's hot-key cost: the phase-3b drain shape with no hot
    # slots, and with every lane on one key
    costs = []
    for label, share, n_hot in (("uniform", 0.0, 1), ("one key", 1.0, 1)):
        pk = torch.from_numpy(full_size_traffic(
            np.random.default_rng(8), FULL_K, B, FULL_CAPACITY, share,
            n_hot)[:, None]).to(DEV)
        dk.drain_compact(arena, pk, nows)  # warm-up
        t = device_ms(lambda: dk.drain_compact(arena, pk, nows), 10,
                      "drain_compact_kernel")
        if t is None:
            t = cuda_ms(lambda: dk.drain_compact(arena, pk, nows), 10)
        costs.append(f"{label} {t:.4f} ms (longest virtual segment a "
                     f"window {longest_segments(pk[:, 0].cpu().numpy())})")
    log(f"phase 3a hot-key cost, device ms per {FULL_K} x {B} drain: "
        f"{costs[0]}, {costs[1]} (half on 64 hot slots: phase 3b)")

    # the grid: the phase-3b drain at P = 1 (S CTAs, as before the
    # partitions) beside the chosen P
    parts = {}
    for P in (1, dk.plan("drain_compact", B, 1)["P"]):
        def run(P=P):
            return dk.launch_compact(arena, packed, nows, P)
        run()  # warm-up
        t = device_ms(run, 10, "drain_compact_kernel")
        parts[P] = cuda_ms(run, 10) if t is None else t
    log(f"phase 3a partitions, device ms per {FULL_K} x {B} drain (half on "
        f"64 hot slots): "
        f"{', '.join(f'P={P} {t:.4f} ms' for P, t in parts.items())}")

    # window_full at the engine's full-format width on the same arena
    bt = tk.decode_batch(packed[0])
    bt = bt._replace(limit=bt.limit + (1 << 31))
    dk.window_full(arena, bt, T0 + 100)  # warm-up
    fcall = cuda_ms(lambda: dk.window_full(arena, bt, T0 + 100), 20)
    fms = device_ms(lambda: dk.window_full(arena, bt, T0 + 100), 20,
                    "window_full_kernel")
    ftimer = "profiler"
    if fms is None:
        fms, ftimer = fcall, "events"
    dk.window_full_plain(plain_arena, bt, T0 + 100)  # warm-up
    fplain = cuda_ms(lambda: dk.window_full_plain(plain_arena, bt, T0 + 100),
                     3)
    fbms, fby = bound_ms(B, 4 + 8 * 3 + 4 + 1, 4 + 8 * 3,
                         touched_slots(packed[:1]))
    log(f"phase 3a window_full: B={B} on the same arena: kernel {fms:.4f} ms "
        f"device ({ftimer}), {fcall:.4f} ms/call (CUDA events), plain "
        f"{fplain:.2f} ms, byte bound {fbms * 1e3:.3f} us")
    return dict(ms=fms, plain_ms=fplain, bound_ms=fbms, bound_by=fby)


def phase_engine_full_size(eng, packed, nows):
    """Phase 3b: the engine's stacked drain at full size.  One
    pipeline_dispatch compared with the plain version including the whole
    arena, then 50 timed with CUDA events and 50 with the profiler."""
    K, B = packed.shape[0], packed.shape[2]
    C = eng.capacity_per_shard
    arena = eng.state
    plain_arena = clone(arena)
    arena_mb = sum(t.numel() * t.element_size() for t in eng.state) / 1e6

    def drain():
        return eng.pipeline_dispatch(packed, nows)

    before = dk.launches["drain_compact"]
    words, limits, mism = drain()
    want = dk.drain_compact_plain(plain_arena, packed, nows)
    torch.cuda.synchronize()
    check(dk.launches["drain_compact"] - before == 1,
          "pipeline_dispatch did not launch the kernel exactly once")
    got = (words, limits, mism)
    assert_same(got, want, "full-size pipeline_dispatch outputs")
    assert_same(arena, plain_arena, "full-size pipeline_dispatch arena")
    err = max_abs_err(list(zip(got, want)) + list(zip(arena, plain_arena)))
    valid = int(((packed[..., 0] & 0xFFFFFFFF) != 0).sum())

    drain()  # warm-up
    before = dk.launches["drain_compact"]
    call_ms = cuda_ms(drain, TIMED_DRAINS)
    moved = dk.launches["drain_compact"] - before
    check(moved == TIMED_DRAINS,
          f"launch counter moved {moved}, want {TIMED_DRAINS}")
    ms = device_ms(drain, TIMED_DRAINS, "drain_compact_kernel")
    timer = "profiler"
    if ms is None:
        ms, timer = call_ms, "events"
    dk.drain_compact_plain(plain_arena, packed, nows)  # warm-up
    plain_ms = cuda_ms(lambda: dk.drain_compact_plain(plain_arena, packed,
                                                      nows), 3)
    slots = touched_slots(packed)
    bms, by = bound_ms(K * B, 16, 16, slots)
    log(f"phase 3b full-size pipeline_dispatch: C={C} ({arena_mb:.0f} MB "
        f"arena), K={K} x B={B}, {valid} valid lanes, {slots} distinct "
        f"slots; bit-exact vs plain incl. the whole arena; kernel {ms:.4f} "
        f"ms/drain device ({timer}) = {valid / ms * 1e3:.3e} decisions/s, "
        f"{call_ms:.4f} ms/call over {TIMED_DRAINS} back-to-back calls (CUDA "
        f"events); plain {plain_ms:.2f} ms/drain; byte bound "
        f"{bms * 1e3:.3f} us")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
                max_abs_err=err)


def expect(resps, want, what):
    got = [(int(r.status), int(r.limit), int(r.remaining), int(r.reset_time))
           for r in resps]
    check(got == want, f"{what}: got {got}, want {want}")


def moved(before, after):
    return {k: after[k] - before[k] for k in after}


def launch_counts():
    return {**dk.launches, **gk.launches, **sk.launches, **wm.launches}


def plain_counts():
    return {**dk.plain_calls, **gk.plain_calls, **sk.plain_calls,
            **wm.plain_calls}


def reset_counts():
    dk.reset_counts()
    gk.reset_counts()
    sk.reset_counts()
    wm.reset_counts()


def only(**moved_by):
    """A launch-count delta: the named kernels moved as given, every other
    kernel 0."""
    return {k: moved_by.get(k, 0) for k in launch_counts()}


def phase_serving():
    launch0, plain0 = launch_counts(), plain_counts()
    eng = RateLimitEngine()
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    t0 = millisecond_now()

    # warmup launches the full format once, each compact lane bucket once,
    # a one-window stacked drain and one GLOBAL window
    before = launch_counts()
    eng.warmup(now=t0)
    want_warm = only(drain_compact=len(eng._lane_bucket_list) + 1,
                     window_full=1, global_window=1)
    check(moved(before, launch_counts()) == want_warm,
          f"warmup launches {moved(before, launch_counts())}, "
          f"want {want_warm}")

    # a 1000-request window: 400 keys, hot duplicates, all algorithms
    rng = np.random.default_rng(11)
    window = [RateLimitReq(name="smoke", unique_key=f"k{int(rng.zipf(1.3)) % 400}",
                           hits=int(rng.integers(0, 3)), limit=20,
                           duration=60_000, algorithm=int(rng.integers(0, 5)))
              for _ in range(1000)]
    big = eng.process(window, now=t0)
    check(len(big) == 1000 and all(r.status in (0, 1) for r in big),
          "1000-request window")
    # host wall time of the same window through the whole engine (slot
    # lookups, staging, copy in, kernel, copy out, response objects)
    walls = []
    for i in range(10):
        w0 = time.perf_counter()
        eng.process(window, now=t0 + 1 + i)
        walls.append((time.perf_counter() - w0) * 1e3)
    wall_ms = float(np.median(walls))

    # token: limit 5, 7 hits -> 5 UNDER then 2 OVER, reset at init + 60 s
    tok = [eng.process([RateLimitReq(name="s", unique_key="tok", hits=1,
                                     limit=5, duration=60_000)],
                       now=t0 + i)[0] for i in range(7)]
    expect(tok, [(0, 5, 4 - i, t0 + 60_000) for i in range(5)]
           + [(1, 5, 0, t0 + 60_000)] * 2, "token sequence")

    # leaky: limit 4 over 4 s leaks one per 1000 ms
    def leaky(hits, dt):
        return eng.process([RateLimitReq(
            name="s", unique_key="leaky", hits=hits, limit=4, duration=4_000,
            algorithm=Algorithm.LEAKY_BUCKET)], now=t0 + dt)[0]
    lk = [leaky(4, 0), leaky(1, 100), leaky(1, 2_100), leaky(1, 2_100),
          leaky(1, 2_200)]
    expect(lk, [(0, 4, 0, 0), (1, 4, 0, t0 + 1_100), (0, 4, 1, 0),
                (0, 4, 0, 0), (1, 4, 0, t0 + 3_200)], "leaky sequence")

    # duplicate-key burst in one call: sequential semantics inside a window
    burst = eng.process([RateLimitReq(name="s", unique_key="dup", hits=1,
                                      limit=3, duration=60_000)] * 5,
                        now=t0 + 10)
    expect(burst, [(0, 3, 2, t0 + 60_010), (0, 3, 1, t0 + 60_010),
                   (0, 3, 0, t0 + 60_010), (1, 3, 0, t0 + 60_010),
                   (1, 3, 0, t0 + 60_010)], "duplicate burst")

    # Instance.get_rate_limits: 3 RPCs of 100 items (50 keys x 2 hits each,
    # limit 3) -> all UNDER; then 50 UNDER + 50 OVER; then all OVER
    inst = Instance(engine=eng)

    async def rpcs():
        out = []
        for _ in range(3):
            reqs = [RateLimitReq(name="rpc", unique_key=f"r{j % 50}", hits=1,
                                 limit=3, duration=60_000)
                    for j in range(100)]
            out.append([r.status for r in await inst.get_rate_limits(reqs)])
        return out

    try:
        statuses = asyncio.run(rpcs())
    finally:
        inst.close()
    check(statuses == [[0] * 100, [0] * 50 + [1] * 50, [1] * 100],
          f"Instance RPC statuses {statuses}")

    # four pre-packed windows through pipeline_dispatch: one launch; held
    # against the plain version below, once the serving counts are read
    rng4 = np.random.default_rng(12)
    packed = torch.from_numpy(full_size_traffic(
        rng4, 4, eng.batch_per_shard, eng.capacity_per_shard)[:, None]).to(DEV)
    nows = torch.tensor([t0 + 30 + k for k in range(4)], dtype=torch.int64,
                        device=DEV)
    pre = clone(eng.state)
    before = launch_counts()
    stacked = eng.pipeline_dispatch(packed, nows)
    check(moved(before, launch_counts()) == only(drain_compact=1),
          f"pipeline_dispatch launches {moved(before, launch_counts())}")
    post = clone(eng.state)

    # a config past the compact caps takes the full-format kernel
    huge = eng.process([RateLimitReq(name="s", unique_key="huge", hits=2**30,
                                     limit=2**40, duration=2**35)],
                       now=t0 + 20)
    expect(huge, [(0, 2**40, 2**40 - 2**30, t0 + 20 + 2**35)], "int64 config")
    check(not eng._compact_sound, "full-format window kept compact on")

    launches = moved(launch0, launch_counts())
    plain = moved(plain0, plain_counts())
    check(launches["drain_compact"] > 0 and launches["window_full"] > 0,
          f"a kernel of the serving path never launched: {launches}")
    check(not any(plain.values()),
          f"the plain versions ran on the serving path: {plain}")

    want = dk.drain_compact_plain(pre, packed, nows)
    assert_same(stacked, want, "pipeline_dispatch outputs")
    assert_same(post, pre, "pipeline_dispatch arena")

    # the same 1000-request window on a CPU engine (plain version) agrees
    ref = RateLimitEngine(device="cpu")
    want = ref.process(window, now=t0)
    check([(r.status, r.limit, r.remaining, r.reset_time) for r in big]
          == [(r.status, r.limit, r.remaining, r.reset_time) for r in want],
          "1000-request window differs from the CPU plain engine")
    log(f"phase 4 serving: warmup, engine.process (1000-request window = "
        f"CPU plain engine; {wall_ms:.3f} ms median host wall per such window "
        f"over 10, {1000 / wall_ms * 1e3:.3e} decisions/s), token/leaky/"
        f"burst/int64 sequences, 3 Instance RPCs x 100, a 4-window "
        f"pipeline_dispatch = plain; launches {launches}, plain calls {plain}")
    return wall_ms


# ---------------------------------------------------------------- GLOBAL

def global_edge_inputs(rng, G, n, algos, wrap):
    """A numpy GLOBAL window (state, cfg, batch, summed) with the edge
    cases: about a tenth of the rows never initialized and half expired,
    configs that mostly agree with the rows and sometimes switch algorithm,
    read lanes with pads, out-of-range slots, hot slots and is_init, summed
    hits 0 on ~40% of the rows; with `wrap`, a quarter of every int64 field
    at or near both ends of the range (tests/test_torch_global.py draws the
    same kinds of input)."""
    algos = np.asarray(algos, np.int32)
    pick = lambda size: rng.choice(algos, size).astype(np.int32)  # noqa: E731
    limit = rng.integers(0, 200, G)
    s_algo = pick(G)
    state = dict(
        limit=limit, duration=rng.integers(0, 120_000, G),
        remaining=rng.integers(-3, 1 << 20, G),
        tstamp=T0 + rng.integers(-120_000, 120_000, G),
        expire=np.where(rng.random(G) < 0.1, 0,
                        T0 + rng.integers(-120_000, 120_000, G)),
        algo=s_algo)
    keep = rng.random(G) < 0.7
    cfg = dict(limit=np.where(keep, limit, rng.integers(0, 200, G)),
               duration=np.where(keep, state["duration"],
                                 rng.integers(0, 120_000, G)),
               algo=np.where(rng.random(G) < 0.7, s_algo,
                             pick(G)).astype(np.int32))
    slot = rng.integers(-2, G + 3, n)
    hot = rng.random(n) < 0.4
    slot[hot] = rng.integers(0, 16, int(hot.sum()))
    slot[:2] = (-1, G)
    batch = dict(
        slot=slot.astype(np.int32),
        hits=rng.choice([0, 0, 1, 2, 5, -1, -3], n).astype(np.int64),
        limit=rng.integers(0, 200, n), duration=rng.integers(0, 120_000, n),
        algo=np.where(rng.random(n) < 0.7, s_algo[np.clip(slot, 0, G - 1)],
                      pick(n)).astype(np.int32),
        is_init=rng.random(n) < 0.15)
    summed = np.where(rng.random(G) < 0.4, 0, rng.integers(-5, 20, G))
    if wrap:
        ends = np.asarray([I64_MAX, I64_MAX - 1, I64_MIN, I64_MIN + 1,
                           2**62, -2**62, 2**32 + 7], np.int64)
        for d, names in ((state, ("limit", "duration", "remaining", "tstamp",
                                  "expire")),
                         (cfg, ("limit", "duration")),
                         (batch, ("hits", "limit", "duration"))):
            for k in names:
                m = rng.random(d[k].shape[0]) < 0.25
                d[k] = np.where(m, rng.choice(ends, d[k].shape[0]), d[k])
        summed = np.where(rng.random(G) < 0.25, rng.choice(ends, G), summed)

    def dev(kind, d):
        return kind(**{k: torch.from_numpy(np.ascontiguousarray(
            v if v.dtype in (np.int32, np.bool_) else v.astype(np.int64)))
            .to(DEV) for k, v in d.items()})
    return (dev(tk.BucketState, state), dev(tk.GlobalConfig, cfg),
            dev(tk.WindowBatch, batch),
            torch.from_numpy(summed.astype(np.int64)).to(DEV))


def edge_control(rng, G, bt, Kg, wrap):
    """A GLOBAL window's host control (gbatch [S, Bg], gacc [S, Bg], upd
    [Kg] x 5) over edge lanes `bt` (global_edge_inputs' batch, n = S x Bg
    lanes): 80% of the lanes contribute their hits (with `wrap`, a fifth
    of those int64 extremes); config writes on distinct rows, a third of
    them named by their negative index, half of them on rows the lanes
    read, switching algorithm on a third; resets on rows the lanes read,
    some negative, so a window reads rows it resets; write and reset pads
    below -G, at G and past it."""
    slot = bt.slot.cpu().numpy()
    n = slot.size
    gacc = np.where(rng.random(n) < 0.8, bt.hits.cpu().numpy(), 0)
    if wrap:
        ends = np.asarray([I64_MAX, I64_MIN, 2**62, -2**62], np.int64)
        m = rng.random(n) < 0.2
        gacc[m] = rng.choice(ends, int(m.sum()))
    read = np.unique(slot[(slot >= 0) & (slot < G)])
    others = np.setdiff1d(np.arange(G), read)
    k = min(Kg - 6, 2 * read.size, G)
    rows = np.concatenate([rng.permutation(read)[:k // 2],
                           rng.choice(others, k - min(k // 2, read.size),
                                      replace=False)])[:k]
    upd = (np.full(Kg, G, np.int32), np.zeros(Kg, np.int64),
           np.zeros(Kg, np.int64), np.zeros(Kg, np.int32),
           np.full(Kg, G, np.int32))
    k = rows.size
    upd[0][:k] = np.where(rng.random(k) < 0.3, rows - G, rows)
    upd[1][:k] = rng.integers(0, 200, k)
    upd[2][:k] = rng.integers(0, 120_000, k)
    upd[3][:k] = rng.integers(0, 5, k)
    reset = rng.permutation(read)[:k // 3]
    upd[4][:reset.size] = np.where(rng.random(reset.size) < 0.3, reset - G,
                                   reset)
    upd[0][k:k + 3] = (-G - 1, G, G + 2)
    upd[4][reset.size:reset.size + 3] = (-G - 2, G, G + 9)
    S = SHARDS
    gbatch = tk.WindowBatch(*[t.cpu().numpy().reshape(S, n // S) for t in bt])
    return gbatch, gacc.astype(np.int64).reshape(S, n // S), upd


def global_window_vs_plain(st, cfg, ctl, now, what, ctas=None):
    """global_window (or, with ctas, the uncounted launch at that cluster
    size) against global_window_plain on copies of one arena and config:
    the read block, every gstate and gcfg plane, and the scratch back at
    zero.  Returns the (got, want) pairs compared and the plain version's
    (read block, gstate, gcfg)."""
    G = st.limit.shape[0]
    k_st, k_cfg, p_st, p_cfg = clone(st), clone(cfg), clone(st), clone(cfg)
    scratch = torch.zeros(G, dtype=torch.int64, device=DEV)
    if ctas is None:
        got = gk.global_window(k_st, k_cfg, ctl, scratch, now)
    else:
        got = gk.launch_window(k_st, k_cfg, ctl, scratch, now, ctas=ctas)
    want = gk.global_window_plain(p_st, p_cfg, ctl,
                                  torch.zeros_like(scratch), now)
    torch.cuda.synchronize()
    assert_same((got,), (want,), f"{what} read block")
    assert_same(k_st, p_st, f"{what} gstate")
    assert_same(k_cfg, p_cfg, f"{what} gcfg")
    check(not scratch.any(), f"{what}: the scratch is not back at zero")
    pairs = [(got, want)] + list(zip(k_st, p_st)) + list(zip(k_cfg, p_cfg))
    return pairs, (want, p_st, p_cfg)


def phase_global_vs_plain():
    """Phase 5a: global_window against its plain version on seeded edge
    windows at the JAX engine's GLOBAL shape (G = 4096, 8 x 256 lanes,
    256 config lanes), through the wrapper (the cluster size the kernel
    chooses) and in clusters of 8 and 16 CTAs."""
    rng = np.random.default_rng(5150)
    n = SHARDS * BG_FULL
    errs = []
    cases = [(range(7), False), ((0, 1), False), (range(7), True),
             ((0, 1), True), ((2, 3, 4), False)]
    for i, (algos, wrap) in enumerate(cases):
        st, cfg, bt, _ = global_edge_inputs(rng, G_FULL, n, algos, wrap)
        ctl = gk.make_control(*edge_control(rng, G_FULL, bt, KG_FULL, wrap),
                              DEV)
        for ctas in (None, 8, 16):
            errs += global_window_vs_plain(st, cfg, ctl, T0 + i,
                                           f"global case {i} ctas {ctas}",
                                           ctas)[0]
    err = max_abs_err(errs)
    log(f"phase 5a global_window vs plain: {len(cases)} windows of "
        f"{n} lanes and {KG_FULL} config lanes over G={G_FULL} (all five "
        f"algorithms and out-of-range values, int64 wrapped at both ends, "
        f"expired rows, switches, is_init, sums that cancel, rows read and "
        f"reset in one window, config writes by negative index, pad and "
        f"out-of-range slots in every lane kind), through the wrapper "
        f"({gk.cluster_ctas(n)} CTAs) and in clusters of 8 and 16 CTAs; "
        f"read block, gstate, gcfg "
        f"bit-exact, scratch back at 0 (max_abs_err {err})")
    return err


def edge_upserts(rng, G, gbatch, upd, ku):
    """Upsert lanes of [ku] (an owner's broadcast on this replica) on
    distinct rows: a third on rows the config lanes write or reset (the
    config lane's fields and the reset's expire = 0 must win there, as in
    the JAX engine's _apply_control), a third on rows the lanes read (the
    reads see the upserted rows), the rest elsewhere, some by their
    negative index; pads below -G and at G and past it; token and leaky
    values of a broadcast, int64 extremes among them."""
    def rows_of(idx):
        idx = np.asarray(idx).astype(np.int64)
        idx = np.where(idx < 0, idx + G, idx)
        return np.unique(idx[(idx >= 0) & (idx < G)])
    named = np.union1d(rows_of(upd[0]), rows_of(upd[4]))
    read = np.setdiff1d(rows_of(np.asarray(gbatch.slot).reshape(-1)), named)
    rest = np.setdiff1d(np.arange(G), np.union1d(named, read))
    k = ku - 3
    rows = np.concatenate([rng.permutation(named)[:k // 3],
                           rng.permutation(read)[:k // 3]])
    rows = np.concatenate([rows, rng.choice(rest, k - rows.size,
                                            replace=False)])
    pslot = np.full(ku, G, np.int32)
    pslot[:k] = np.where(rng.random(k) < 0.3, rows - G, rows)
    pslot[k:] = (-G - 1, G, G + 5)
    ends = np.asarray([I64_MAX, I64_MIN, 2**62, -1], np.int64)

    def vals(lo, hi):
        v = rng.integers(lo, hi, ku).astype(np.int64)
        m = rng.random(ku) < 0.05
        v[m] = rng.choice(ends, int(m.sum()))
        return v
    return (pslot, vals(0, 300), vals(1, 120_000), vals(-3, 300),
            T0 + vals(-60_000, 60_000), T0 + vals(-60_000, 120_000),
            rng.choice(np.asarray([0, 1, 0, 1, 4], np.int32), ku))


def phase_upserts_vs_plain():
    """Phase 5a, the upsert lanes: global_window (through the wrapper and
    in clusters of 8 and 16 CTAs) and global_stage, the torch reads and
    global_apply, each against its plain version, on edge windows at
    G = 4096, 8 x 256 lanes and 256 config lanes that carry 256 upsert
    lanes (rows also written or reset by config lanes, rows the lanes
    read, negative indices, pads): read block, gstate, gcfg, scratch."""
    rng = np.random.default_rng(5151)
    n = SHARDS * BG_FULL
    errs = []
    cases = [((0, 1), False), (range(7), False), (range(7), True)]
    for i, (algos, wrap) in enumerate(cases):
        st, cfg, bt, _ = global_edge_inputs(rng, G_FULL, n, algos, wrap)
        gbatch, gacc, upd = edge_control(rng, G_FULL, bt, KG_FULL, wrap)
        ups = edge_upserts(rng, G_FULL, gbatch, upd, KG_FULL)
        ctl = gk.make_control(gbatch, gacc, upd, DEV, ups)
        for ctas in (None, 8, 16):
            errs += global_window_vs_plain(
                st, cfg, ctl, T0 + i, f"upsert case {i} ctas {ctas}",
                ctas)[0]
        errs += per_op_global_vs_plain(st, cfg, ctl, T0 + i,
                                       f"per-op upsert case {i}")
    err = max_abs_err(errs)
    log(f"phase 5a upsert lanes: {len(cases)} windows of {n} lanes, "
        f"{KG_FULL} config lanes and {KG_FULL} upsert lanes over "
        f"G={G_FULL} (upserts on rows config lanes write or reset, on rows "
        f"the lanes read, by negative index, pads), global_window through "
        f"the wrapper and in clusters of 8 and 16 CTAs, and global_stage + "
        f"reads + global_apply: read block, gstate, gcfg bit-exact, scratch "
        f"back at 0 (max_abs_err {err})")
    return err


def phase_upsert_window_timing(w):
    """The full-size GLOBAL window of phase 5c with KG_FULL upsert lanes
    added (the control's new width), outside the counted paths: checked
    once against the plain version, then global_window and global_stage
    timed (CUDA events, 100 launches; profiler device time)."""
    rng = np.random.default_rng(5152)
    gbatch, gacc, upd = w["gbatch"], w["gacc"], w["upd"]
    ups = edge_upserts(rng, G_FULL, gbatch, upd, KG_FULL)
    ctl = gk.make_control(gbatch, gacc, upd, DEV, ups)
    now = int(w["nows"][0])
    errs, _ = global_window_vs_plain(w["gstate0"], w["gcfg0"], ctl, now,
                                     "full-size window with upserts")
    st, cfg = clone(w["gstate0"]), clone(w["gcfg0"])
    scratch = torch.zeros(G_FULL, dtype=torch.int64, device=DEV)

    def gone():
        return gk.global_window(st, cfg, ctl, scratch, now)

    def stage():
        gk.global_stage(st, cfg, ctl, scratch)
        scratch.zero_()

    gone()
    events = cuda_ms(gone, 100)
    device = device_ms(gone, 100, "global_window_kernel")
    stage()
    stage_events = cuda_ms(stage, 100)
    # global_stage with upserts is two launches: the upserts', the stage's
    each = device_ms_each(stage, 100, ("global_upsert_kernel",
                                       "global_stage_kernel"))
    stage_device = (None if None in each.values()
                    else sum(each.values()))
    bound, by, _ = global_window_bound_ms(gbatch, gacc, upd, G_FULL,
                                          ku=KG_FULL)
    stage_bound = per_op_global_bounds(gbatch, gacc, upd, G_FULL,
                                       ku=KG_FULL)[0][0]
    fmt = lambda x: "not measured" if x is None else f"{x:.5f} ms"  # noqa: E731
    log(f"phase 5c upsert window (outside the counted paths): the "
        f"full-size window with {KG_FULL} upsert lanes bit-exact vs plain; "
        f"global_window {fmt(device)} device, {events:.5f} ms/call; "
        f"global_stage {fmt(stage_device)} device (its upsert launch and "
        f"its stage launch: {each}), {stage_events:.5f} ms/call (with a "
        f"scratch zero); bounds: global_window {bound:.6f} ms ({by}), "
        f"global_stage {stage_bound:.6f} ms (bytes)")
    return dict(err=max_abs_err(errs), ms=device, events_ms=events,
                stage_ms=stage_device, stage_events_ms=stage_events,
                bound_ms=bound, bound_by=by, stage_bound_ms=stage_bound)


def phase_sharded_drain_vs_plain():
    """Phase 5b: drain_compact over S = 8 shards against its plain version:
    eight shards' arenas and windows in one launch, shard 5 all padding."""
    rng = np.random.default_rng(2025)
    gen = torch.Generator(device=DEV).manual_seed(2025)
    C, K, B = 4096, 4, 256
    arena = random_arena(gen, C, T0, DEV, S=SHARDS)
    plain_arena = clone(arena)
    packed = np.stack([random_windows(rng, K, B, C, cap_edges=(s % 2 == 1))
                       for s in range(SHARDS)], axis=1)
    packed[:, 5] = 0
    packed = torch.from_numpy(packed).to(DEV)
    nows = torch.tensor([T0 + 1009 * (k + 1) for k in range(K)],
                        dtype=torch.int64, device=DEV)
    one_arena = clone(arena)
    got = dk.drain_compact(arena, packed, nows)
    one = dk.launch_compact(one_arena, packed, nows, P=1)
    want = dk.drain_compact_plain(plain_arena, packed, nows)
    torch.cuda.synchronize()
    errs = []
    for what, g, a in (("chosen P", got, arena), ("P = 1", one, one_arena)):
        assert_same(g, want, f"S=8 drain ({what}) outputs")
        assert_same(a, plain_arena, f"S=8 drain ({what}) arena")
        errs += list(zip(g, want)) + list(zip(a, plain_arena))
    err = max_abs_err(errs)
    P = dk.plan("drain_compact", B, SHARDS)["P"]
    log(f"phase 5b drain_compact with {SHARDS} shards vs plain: K={K} x "
        f"S={SHARDS} x B={B} over [{SHARDS}, {C}] (shard 5 idle), at the "
        f"chosen P = {P} ({P * SHARDS} CTAs) and at P = 1 ({SHARDS} CTAs), "
        f"bit-exact (max_abs_err {err})")
    return err


def global_traffic(rng, eng, n_hot=16):
    """One GLOBAL window as the engine stages it, at the engine's full
    GLOBAL width: S x Bg lanes spread round-robin over the shards, half on
    `n_hot` hot keys and the rest over other slots of the arena, at most
    max_global_updates distinct keys; a key's config follows its slot
    (the arena's config, 70% token, 30% leaky); 10% reads; 5% of the keys
    reallocated (config write + reset, is_init on their first lane).
    Returns numpy (gbatch [S, Bg], gacc [S, Bg], upd)."""
    S, Bg = eng.num_shards, eng.global_batch_per_shard
    G, Kg = eng.global_capacity, eng.max_global_updates
    keys = rng.choice(G, Kg, replace=False)
    n = S * Bg
    lane_key = np.where(rng.random(n) < 0.5, rng.integers(0, n_hot, n),
                        rng.integers(n_hot, Kg, n))
    slot = keys[lane_key]
    cfg = [t.cpu().numpy() for t in eng.gcfg]
    hits = np.where(rng.random(n) < 0.1, 0, 1).astype(np.int64)
    used = np.unique(lane_key)
    reset = used[rng.random(used.size) < 0.05]
    first = np.zeros(n, bool)
    first[np.unique(lane_key, return_index=True)[1]] = True
    is_init = first & np.isin(lane_key, reset)
    # request i goes to shard i % S, lane i // S
    rr = lambda a: np.ascontiguousarray(a.reshape(Bg, S).T)  # noqa: E731
    gbatch = tk.WindowBatch(
        slot=rr(slot.astype(np.int32)), hits=rr(hits),
        limit=rr(cfg[0][slot]), duration=rr(cfg[1][slot]),
        algo=rr(cfg[2][slot]), is_init=rr(is_init))
    upd = (np.full(Kg, G, np.int32), np.zeros(Kg, np.int64),
           np.zeros(Kg, np.int64), np.zeros(Kg, np.int32),
           np.full(Kg, G, np.int32))
    u = keys[used]
    upd[0][:u.size] = u
    upd[1][:u.size], upd[2][:u.size], upd[3][:u.size] = (c[u] for c in cfg)
    upd[4][:reset.size] = keys[reset]
    return gbatch, rr(hits), upd


def window_counts(gbatch, gacc, upd, G):
    """What a GLOBAL window's host control asks of the card: (lanes, config
    lanes, config writes that land, resets that land, contributing lanes,
    touched rows), by the kernels' index rules."""
    slot = np.asarray(gbatch.slot).reshape(-1)
    acc = np.asarray(gacc).reshape(-1)

    def lands(idx):
        idx = np.asarray(idx).astype(np.int64)
        return int(((idx >= -G) & (idx < G)).sum())
    contrib = (slot >= 0) & (slot < G) & (acc != 0)
    return (slot.size, np.size(upd[0]), lands(upd[0]), lands(upd[4]),
            int(contrib.sum()), np.unique(slot[contrib]).size)


def global_window_bound_ms(gbatch, gacc, upd, G, ku=0):
    """The least time of one GLOBAL window, from what this window needs:
    its control read once (56 B a lane, 40 B a config lane); each config
    write (20 B) and reset (8 B) that lands written once; each lane's row
    gathered (44 B) and its answer written (32 B); each contributing
    lane's atomic on its slot's sum (8 B); each touched row's state and
    config read (64 B) and state written (44 B), its sum exchanged (8 B);
    each of ku upsert lanes read once (56 B) and its row's state (44 B)
    and config (20 B) written once; or the ladder's ~200 32-bit
    operations and two int64 divisions per lane and per touched row at
    the scalar rate; whichever is larger.  Returns (ms, bound_by, the old
    G-row formula's ms)."""
    n, kg, writes, resets, contrib, touched = window_counts(gbatch, gacc,
                                                            upd, G)
    nbytes = (n * 56 + kg * 40 + writes * 20 + resets * 8 + n * (44 + 32)
              + contrib * 8 + touched * (64 + 44 + 8) + ku * (56 + 44 + 20))
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ((n + touched) * (200 + TRANSITION_DIVS * FDIV_OPS)
             / INT32_OPS_PER_S * 1e3)
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            old_global_bound_ms(G, n))


def old_global_bound_ms(G, n):
    """The bound of the earlier G-row design (PR 2's formula): every arena
    row read (44 + 20 + 8 B) and written (44 B) and every lane's 65 B, or
    ~260 32-bit operations per lane and row; whichever is larger."""
    nbytes = G * (44 + 20 + 8 + 44) + n * (33 + 32)
    t_ops = ((G + n) * (200 + TRANSITION_DIVS * FDIV_OPS) / INT32_OPS_PER_S
             * 1e3)
    return max(nbytes / HBM_BYTES_PER_S * 1e3, t_ops)


def sharded_engine(gen):
    """The phase-5c engine: 8 shards of 2^21 slots with a random regular
    arena, and a random GLOBAL arena whose rows hold their configs (70%
    token, 30% leaky), brought in with import_arena."""
    eng = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                          batch_per_shard=FULL_LANES, num_shards=SHARDS)
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    planes = {name: t.cpu().numpy() for name, t in zip(
        tk.BucketState._fields,
        random_arena(gen, FULL_CAPACITY // SHARDS, T0, DEV, S=SHARDS))}
    g = random_arena(gen, G_FULL, T0, DEV)
    galgo = (torch.rand(G_FULL, generator=gen, device=DEV) < 0.3).to(
        torch.int32)
    for name, t in zip(tk.BucketState._fields, g):
        planes[f"gstate.{name}"] = (galgo if name == "algo" else t[0]).cpu() \
            .numpy()
    for name in tk.GlobalConfig._fields:
        planes[f"gcfg.{name}"] = planes[f"gstate.{name}"]
    eng.import_arena(planes)
    return eng


def global_full_size_inputs(gen, rng):
    """The phase-5c engine and its window: K = 8 windows x 8 shards x 1024
    lanes over a [8, 2^21] arena plus one GLOBAL window of 8 x 256 lanes
    over G = 4096; the host arrays the serving path passes (nows, the
    GLOBAL control), and the plain versions' inputs, taken before the
    engine runs: copies of the regular arena, the GLOBAL arena and config,
    and the window's packed control on the card."""
    eng = sharded_engine(gen)
    S, B = SHARDS, FULL_LANES
    packed = torch.from_numpy(np.stack(
        [full_size_traffic(rng, FULL_K, B, eng.capacity_per_shard)
         for _ in range(S)], axis=1)).to(DEV)
    nows = np.asarray([T0 + 7 * k for k in range(FULL_K)], np.int64)
    gbatch, gacc, upd = global_traffic(rng, eng)
    return dict(eng=eng, packed=packed, nows=nows, gbatch=gbatch, gacc=gacc,
                upd=upd, arena0=clone(eng.state), gstate0=clone(eng.gstate),
                gcfg0=clone(eng.gcfg),
                ctl=gk.make_control(gbatch, gacc, upd, DEV))


def phase_global_alone(w):
    """Phase 5c, first part, before the GLOBAL path's counts start: the
    wrapper called directly on the full-size GLOBAL window, against its
    plain version (read block, gstate, gcfg, scratch); then 100 launches
    timed with CUDA events and 100 with the profiler on a working copy
    (in place: each call applies the window again), the same in clusters
    of 8 and 16 CTAs, and the plain version timed.  Leaves the plain version's
    outputs in `w` for the engine's check."""
    now = int(w["nows"][0])
    ctl = w["ctl"]
    errs, (w["gread"], w["gwant"], w["gcfg_want"]) = global_window_vs_plain(
        w["gstate0"], w["gcfg0"], ctl, now, "full-size GLOBAL window")
    err = max_abs_err(errs)
    st, cfg = clone(w["gstate0"]), clone(w["gcfg0"])
    scratch = torch.zeros(G_FULL, dtype=torch.int64, device=DEV)

    def gone():
        return gk.global_window(st, cfg, ctl, scratch, now)

    def sized(ctas):
        return lambda: gk.launch_window(st, cfg, ctl, scratch, now, ctas=ctas)

    gone()  # warm-up
    events = cuda_ms(gone, 100)
    device = device_ms(gone, 100, "global_window_kernel")
    by_size = {}
    for ctas in (8, 16):
        sized(ctas)()
        by_size[ctas] = (device_ms(sized(ctas), 100, "global_window_kernel"),
                         cuda_ms(sized(ctas), 100))
    check(not scratch.any(), "timed GLOBAL windows left the scratch nonzero")
    plain = cuda_ms(lambda: gk.global_window_plain(
        clone(w["gstate0"]), clone(w["gcfg0"]), ctl, scratch, now), 5)
    fmt = lambda x: "not measured" if x is None else f"{x:.5f} ms"  # noqa: E731
    sizes = "; ".join(f"cluster of {c}: {fmt(d)} device, {e:.5f} ms/call"
                      for c, (d, e) in by_size.items())
    log(f"phase 5c global_window alone (direct calls, outside the counted "
        f"path): bit-exact vs plain on the full-size window (read block, "
        f"gstate, gcfg, scratch 0); the wrapper ({gk.cluster_ctas(ctl.n)} "
        f"CTAs): {fmt(device)} device (profiler, 100 launches), {events:.5f} "
        f"ms/call (CUDA events, 100 back to back); {sizes}; plain "
        f"{plain:.2f} ms")
    return dict(err=err, ms=device, events_ms=events, plain_ms=plain)


def phase_global_full_size(w, alone, s1_drain_ms):
    """Phase 5c, on the counted GLOBAL path: the GLOBAL-composed drain at
    full size through pipeline_dispatch_global, nows and the GLOBAL
    control as host arrays.  One call compared with the plain versions
    including every arena plane and the scratch; one call under
    torch.cuda.set_sync_debug_mode("error") (its fetch outside); then 20
    calls timed with CUDA events and 20 with the profiler (device time of
    each kernel in the call, and the card's busy time)."""
    eng, packed, nows = w["eng"], w["packed"], w["nows"]
    gbatch, gacc, upd = w["gbatch"], w["gacc"], w["upd"]
    S, B = SHARDS, FULL_LANES
    n = S * eng.global_batch_per_shard
    arena0 = w["arena0"]
    before = launch_counts()
    words, limits, mism, gfused = eng.pipeline_dispatch_global(
        packed, nows, gbatch, gacc, upd)
    torch.cuda.synchronize()
    check(moved(before, launch_counts()) == only(drain_compact=1,
                                                 global_window=1),
          f"pipeline_dispatch_global launches "
          f"{moved(before, launch_counts())}")
    # the plain drain on the copy; the GLOBAL window's plain outputs came
    # from phase_global_alone on the same inputs
    nows_dev = torch.from_numpy(nows).to(DEV)
    t0 = time.perf_counter()
    want = dk.drain_compact_plain(arena0, packed, nows_dev)
    torch.cuda.synchronize()
    drain_plain_ms = (time.perf_counter() - t0) * 1e3
    gwant, gread = w["gwant"], w["gread"]
    assert_same((words, limits, mism), want, "S=8 composed drain outputs")
    assert_same((gfused.reshape(n, 4),), (gread,), "GLOBAL response block")
    assert_same(eng.state, arena0, "S=8 composed drain arena")
    assert_same(eng.gstate, gwant, "GLOBAL arena")
    assert_same(eng.gcfg, w["gcfg_want"], "GLOBAL config")
    check(not eng._gsums.any(), "the engine's GLOBAL scratch is not 0")
    drain_err = max_abs_err(list(zip((words, limits, mism), want))
                            + list(zip(eng.state, arena0)))
    global_err = max_abs_err([(gfused.reshape(n, 4), gread)]
                             + list(zip(eng.gstate, gwant))
                             + list(zip(eng.gcfg, w["gcfg_want"])))
    valid = int(((packed[..., 0] & 0xFFFFFFFF) != 0).sum())
    gvalid = int((gbatch.slot >= 0).sum())

    def call():
        return eng.pipeline_dispatch_global(packed, nows, gbatch, gacc, upd)

    # no host sync between the call and its fetch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = call()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    out[3].cpu()
    call()  # warm-up
    call_ms = cuda_ms(call, 20)
    drain_ms = device_ms(call, 20, "drain_compact_kernel")
    gcall_ms = device_ms(call, 20, "global_window_kernel")
    busy_ms = device_busy_ms(call, 20)
    check(not eng._gsums.any(), "the engine's GLOBAL scratch is not 0")
    idle = ("not measured" if busy_ms is None else
            f"{busy_ms:.4f} ms busy, idle share {1 - busy_ms / call_ms:.3f}")
    timer = "profiler"
    if drain_ms is None or gcall_ms is None:
        timer = "events (the profiler showed no device time)"
    # the kernel's time in the table: its device time in the call, or, where
    # the profiler saw none, the direct calls' time per call (CUDA events)
    g_ms, g_timer = gcall_ms, "device in the call (profiler, 20 launches)"
    if g_ms is None:
        g_ms, g_timer = alone["events_ms"], "alone per call (CUDA events)"
    gbms, gby, gold = global_window_bound_ms(gbatch, gacc, upd, G_FULL)
    slots = sum(touched_slots(packed[:, s]) for s in range(S))
    dbms, dby = bound_ms(FULL_K * S * B, 16, 16, slots)
    drain_ms = drain_ms if drain_ms is not None else call_ms
    log(f"phase 5c full-size pipeline_dispatch_global: [{S}, "
        f"{eng.capacity_per_shard}] arena, K={FULL_K} x S={S} x B={B} "
        f"({valid} valid lanes, {slots} distinct slots) + GLOBAL {S} x "
        f"{eng.global_batch_per_shard} lanes ({gvalid} valid, "
        f"{int((upd[0] < G_FULL).sum())} keys) over G={G_FULL}; bit-exact "
        f"vs plain incl. every arena plane, gstate, gcfg and the scratch; "
        f"no host sync under set_sync_debug_mode('error'); "
        f"{call_ms:.4f} ms/call over 20 calls (CUDA events), device "
        f"{idle} per call; device "
        f"({timer}): drain_compact S=8 {drain_ms:.4f} ms per "
        f"{FULL_K} x {S} x {B} drain = {valid / drain_ms * 1e3:.3e} "
        f"decisions/s, beside S=1 {s1_drain_ms:.4f} ms per {FULL_K} x {B} "
        f"(phase 3b); global_window {g_ms:.5g} ms ({g_timer}); plain "
        f"S=8 drain {drain_plain_ms:.2f} ms; byte bound {dbms * 1e3:.3f} us;"
        f" GLOBAL bound {gbms * 1e3:.3f} us ({gby}; the G-row design's "
        f"{gold * 1e3:.3f} us)")
    return dict(drain_err=drain_err, global_err=global_err, ms=g_ms,
                bound_ms=gbms, bound_by=gby, drain_s8_ms=drain_ms)


def phase_global_scaling(seed=1717):
    """The GLOBAL window alone at G = 4096 and at G = 2^20: a random arena
    holding its configs (70% token, 30% leaky) and one window of 2048
    lanes over 256 keys with their config writes and resets (global_traffic
    on an engine of that G), checked once against the plain version, then
    its device time (profiler, 100 launches), CUDA-event time per call,
    and its phases from the kernel's debug stamps (the mean of 10 stamped
    launches, through the uncounted launch_window).  Its own generators,
    so the later phases' traffic does not depend on it."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEV).manual_seed(seed)
    out = {}
    for G in (G_FULL, 1 << 20):
        eng = RateLimitEngine(capacity_per_shard=64, batch_per_shard=64,
                              num_shards=SHARDS, global_capacity=G)
        g = random_arena(gen, G, T0, DEV)
        galgo = (torch.rand(G, generator=gen, device=DEV) < 0.3).to(
            torch.int32)
        st = tk.BucketState(*[t[0] for t in g[:5]], galgo)
        cfg = tk.GlobalConfig(st.limit.clone(), st.duration.clone(),
                              galgo.clone())
        for dst, src in zip((*eng.gstate, *eng.gcfg), (*st, *cfg)):
            dst.copy_(src)
        gbatch, gacc, upd = global_traffic(rng, eng)
        del eng
        ctl = gk.make_control(gbatch, gacc, upd, DEV)
        global_window_vs_plain(st, cfg, ctl, T0, f"G={G} window")
        scratch = torch.zeros(G, dtype=torch.int64, device=DEV)

        def fn():
            return gk.global_window(st, cfg, ctl, scratch, T0)
        fn()
        events = cuda_ms(fn, 100)
        device = device_ms(fn, 100, "global_window_kernel")
        out[G] = dict(ms=device, events_ms=events,
                      bound=global_window_bound_ms(gbatch, gacc, upd, G),
                      stamps=window_stamps(st, cfg, ctl, scratch, T0))
        check(not scratch.any(), f"G={G}: the GLOBAL scratch is not 0")
        del st, cfg
        torch.cuda.empty_cache()
    a, b = out[G_FULL], out[1 << 20]
    fmt = lambda x: "not measured" if x is None else f"{x:.5f} ms"  # noqa: E731
    split = lambda d: ", ".join(f"{k} {v:.5g}"  # noqa: E731
                                for k, v in d["stamps"].items())
    log(f"phase 5e GLOBAL window alone vs G: 2048 lanes over 256 "
        f"keys; G={G_FULL}: {fmt(a['ms'])} device (profiler, 100 launches), "
        f"{a['events_ms']:.5f} ms/call (CUDA events); G=2^20: "
        f"{fmt(b['ms'])} device, {b['events_ms']:.5f} ms/call; bounds "
        f"{a['bound'][0] * 1e3:.3f} / {b['bound'][0] * 1e3:.3f} us (the "
        f"G-row design's {a['bound'][2] * 1e3:.3f} / "
        f"{b['bound'][2] * 1e3:.3f} us); debug stamps ({gk.cluster_ctas(2048)}"
        f" CTAs, mean of 10 launches; us since the first CTA's start, the "
        f"latest CTA; cycles since each CTA's start, the mean CTA): "
        f"G={G_FULL}: {split(a)}; G=2^20: {split(b)}")
    ta_, tb_ = (a["ms"] or a["events_ms"]), (b["ms"] or b["events_ms"])
    check(tb_ <= 2 * ta_, f"global_window at G=2^20 takes {tb_:.5f} ms, "
          f"more than twice its {ta_:.5f} ms at G={G_FULL}")
    return out


def window_stamps(st, cfg, ctl, scratch, now, n=10):
    """The mean over n stamped launches of global_window's phases
    (gk.stamp_split), each launch checked to leave the scratch at 0."""
    ctas = gk.cluster_ctas(ctl.n)
    splits = []
    for _ in range(n):
        buf = gk.debug_stamps(ctas, DEV)
        gk.launch_window(st, cfg, ctl, scratch, now, stamps=buf)
        torch.cuda.synchronize()
        splits.append(gk.stamp_split(buf))
    return {k: float(np.mean([x[k] for x in splits])) for k in splits[0]}


def phase_global_serving():
    """Phase 5d: the serving path with GLOBAL on RateLimitEngine(num_shards=
    8): warmup, a 1000-request window mixing regular and GLOBAL keys
    (= the CPU plain engine), scripted GLOBAL sequences against closed-form
    answers, and Instance.get_rate_limits serving GLOBAL standalone."""
    launch0, plain0 = launch_counts(), plain_counts()
    eng = RateLimitEngine(num_shards=SHARDS)
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    t0 = millisecond_now()
    before = launch_counts()
    eng.warmup(now=t0)
    check(moved(before, launch_counts())["global_window"] == 1,
          "warmup did not launch the GLOBAL kernel once")

    rng = np.random.default_rng(13)
    window = []
    for _ in range(1000):
        if rng.random() < 0.2:
            window.append(RateLimitReq(
                name="sg", unique_key=f"g{int(rng.zipf(1.3)) % 50}",
                hits=int(rng.integers(0, 3)), limit=30, duration=60_000,
                algorithm=int(rng.integers(0, 2)), behavior=Behavior.GLOBAL))
        else:
            window.append(RateLimitReq(
                name="sr", unique_key=f"k{int(rng.zipf(1.3)) % 400}",
                hits=int(rng.integers(0, 3)), limit=20, duration=60_000,
                algorithm=int(rng.integers(0, 5))))
    big = eng.process(window, now=t0)
    big_planes = eng.export_arena()
    check(not eng._gsums.any(), "the engine's GLOBAL scratch is not 0")
    walls = []
    for i in range(10):
        w0 = time.perf_counter()
        eng.process(window, now=t0 + 1 + i)
        walls.append((time.perf_counter() - w0) * 1e3)
    wall_ms = float(np.median(walls))

    def g(key, hits, limit=5, duration=3_000, algo=0):
        return RateLimitReq(name="s", unique_key=key, hits=hits, limit=limit,
                            duration=duration, algorithm=algo,
                            behavior=Behavior.GLOBAL)

    # stale, then consistent (tests/test_engine.py:75-120): a window's reads
    # see the arena from before it; its summed hits land at its end
    t = t0 + 100
    seq = [eng.step([g("st", 1), g("st", 1)], now=t),
           eng.step([g("st", 0)], now=t + 10),
           eng.step([g("st", 1)], now=t + 20),
           eng.step([g("st", 0)], now=t + 30)]
    expect([r for w in seq for r in w],
           [(0, 5, 4, t + 3_000)] * 2 + [(0, 5, 3, t + 3_000)] * 2
           + [(0, 5, 2, t + 3_000)], "GLOBAL stale-then-consistent")
    # a limit raise on a live key: the config takes it at once, the stored
    # limit after expiry
    raise_seq = [eng.step([g("up", 2, 5, 60_000)], now=t),
                 eng.step([g("up", 1, 50, 60_000)], now=t + 1),
                 eng.step([g("up", 0, 50, 60_000)], now=t + 2),
                 eng.step([g("up", 0, 50, 60_000)], now=t + 61_000),
                 eng.step([g("up", 1, 50, 60_000)], now=t + 61_010)]
    expect([r for w in raise_seq for r in w],
           [(0, 5, 3, t + 60_000), (0, 5, 3, t + 60_000),
            (0, 5, 2, t + 60_000), (0, 50, 50, t + 121_000),
            (0, 50, 49, t + 121_010)], "GLOBAL limit raise")
    # leaky: limit 4 over 4 s; a read 10 ms on leaks nothing
    lk = [eng.step([g("lk", 1, 4, 4_000, Algorithm.LEAKY_BUCKET)], now=t),
          eng.step([g("lk", 0, 4, 4_000, Algorithm.LEAKY_BUCKET)],
                   now=t + 10)]
    expect([r for w in lk for r in w], [(0, 4, 3, 0), (0, 4, 3, 0)],
           "GLOBAL leaky")

    # Instance: 3 RPCs of 100 regular items (50 keys x 2, limit 3) and one
    # GLOBAL item (limit 3) each, then GLOBAL on GCRA
    inst = Instance(engine=eng)

    async def rpcs():
        out = []
        for _ in range(3):
            reqs = [RateLimitReq(name="rpc", unique_key=f"r{j % 50}", hits=1,
                                 limit=3, duration=60_000)
                    for j in range(100)]
            reqs.append(g("inst", 1, 3, 60_000))
            out.append(await inst.get_rate_limits(reqs))
        bad = await inst.get_rate_limits([g("bad", 1, algo=Algorithm.GCRA)])
        return out, bad[0].error

    try:
        rpc, bad = asyncio.run(rpcs())
    finally:
        inst.close()
    check([[r.status for r in o[:100]] for o in rpc]
          == [[0] * 100, [0] * 50 + [1] * 50, [1] * 100],
          "Instance regular statuses")
    check([(o[100].status, o[100].remaining) for o in rpc]
          == [(0, 2), (0, 2), (0, 1)], "Instance GLOBAL answers")
    check(bad == "while applying rate limit for 's_bad' - 'GLOBAL behavior "
          "does not support algorithm '2''", f"GLOBAL+GCRA error {bad!r}")

    launches = moved(launch0, launch_counts())
    plain = moved(plain0, plain_counts())
    check(launches["drain_compact"] > 0 and launches["global_window"] > 0,
          f"a kernel of the GLOBAL serving path never launched: {launches}")
    check(not eng._gsums.any(), "the engine's GLOBAL scratch is not 0")
    check(not any(plain.values()),
          f"the plain versions ran on the serving path: {plain}")
    # the same mixed window on a CPU engine (the plain versions) agrees
    ref = RateLimitEngine(num_shards=SHARDS, device="cpu")
    want = ref.process(window, now=t0)
    check([(r.status, r.limit, r.remaining, r.reset_time) for r in big]
          == [(r.status, r.limit, r.remaining, r.reset_time) for r in want],
          "mixed 1000-request window differs from the CPU plain engine")
    for name, plane in ref.export_arena().items():
        check(np.array_equal(big_planes[name], plane),
              f"plane {name} after the mixed window differs from the CPU "
              f"plain engine's")
    log(f"phase 5d GLOBAL serving on {SHARDS} shards: warmup, a mixed "
        f"1000-request window (20% GLOBAL) = CPU plain engine "
        f"(responses and every plane of both arenas; {wall_ms:.3f} ms "
        f"median host wall over 10, "
        f"{1000 / wall_ms * 1e3:.3e} decisions/s), stale-then-consistent, "
        f"limit raise, leaky, 3 Instance RPCs with GLOBAL, GLOBAL+GCRA "
        f"refused; launches {launches}, plain calls {plain}")


# ---------------------------------------------------------------- analytics

def stats_edge_inputs(rng, K, S, B, C, T, kind):
    """A drain for the stats kernels: random_windows traffic on each shard
    (all five algorithms, CONCURRENCY releases, AGG runs, inits, pads,
    duplicates), with 1% of the lanes on row C - 1, 2% on slots past the
    arena (they read row C - 1 as the window found it) and 1% with slot
    bit 31 set (the drain pads them, the oracle clips them to row C - 1),
    and tenant ids past both ends.  kind "empty": every lane a pad; "few":
    three valid lanes in all.  Returns device tensors (packed
    i64[K, S, B, 2], tenants i32[K, S, B])."""
    packed = np.stack([random_windows(rng, K, B, C) for _ in range(S)],
                      axis=1)
    w0 = packed[..., 0]
    low = w0 & 0xFFFFFFFF
    last = (rng.random(w0.shape) < 0.01) & (low != 0)
    w0[last] = (w0[last] & ~0xFFFFFFFF) | C
    past = (rng.random(w0.shape) < 0.02) & (low != 0)
    w0[past] = (w0[past] & ~0xFFFFFFFF) | (C + 1 + rng.integers(0, 5, int(
        past.sum())))
    bit31 = (rng.random(w0.shape) < 0.01) & (low != 0)
    w0[bit31] = (w0[bit31] & ~0xFFFFFFFF) | (1 << 31) | 3
    if kind == "empty":
        packed[:] = 0
    elif kind == "few":
        keep = np.zeros(w0.shape, bool)
        keep.reshape(-1)[rng.choice(w0.size, 3, replace=False)] = True
        packed[~keep] = 0
        w0 = packed[..., 0]
        w0[keep & (w0 == 0)] = (1 << 34) | 6     # slot 5, one hit
    tenants = rng.integers(-3, T + 3, (K, S, B)).astype(np.int32)
    return (torch.from_numpy(packed).to(DEV),
            torch.from_numpy(tenants).to(DEV))


def acc_state(acc):
    """What an accumulator holds, whatever the order of its entries."""
    return (*acc.dense(), acc.count.clone(), acc.ecount.clone(),
            acc.edone.clone())


def phase_stats_vs_plain():
    """Phase 6a: drain_compact_stats and stats_finish against their plain
    versions on the card, two drains chained over one accumulator and
    sketch per case; after each finish the kernel's accumulator must be
    empty again."""
    rng = np.random.default_rng(6060)
    gen = torch.Generator(device=DEV).manual_seed(6060)
    # (label, K, S, B, C, T, D, W, topk, first decay, sketch start, kind)
    cases = [
        ("releases", 4, 1, 256, 4096, 64, 4, 2048, 32, 0, "zero", "edge"),
        ("8 shards", 4, 8, 256, 4096, 64, 4, 2048, 32, 1, "random", "edge"),
        ("ties", 1, 8, 1024, 4096, 8, 2, 16, 32, 0, "flat", "edge"),
        ("wide", 2, 2, 3000, 1 << 16, 64, 4, 2048, 32, 1, "random", "edge"),
        ("few", 1, 8, 64, 4096, 64, 4, 2048, 32, 0, "random", "few"),
        ("empty", 1, 8, 37, 4096, 64, 4, 2048, 32, 1, "random", "empty"),
    ]
    errs, drains = [], 0
    for label, K, S, B, C, T, D, W, topk, decay0, start, kind in cases:
        arena = random_arena(gen, C, T0, DEV, S=S)
        plain_arena, one_arena = clone(arena), clone(arena)
        acc = sk.StatsAccumulator(S, C, T, DEV)
        plain_acc = sk.StatsAccumulator(S, C, T, DEV)
        one_acc = sk.StatsAccumulator(S, C, T, DEV)
        sketch = {"zero": torch.zeros((S, D, W), dtype=torch.int64),
                  "flat": torch.full((S, D, W), 6, dtype=torch.int64),
                  "random": torch.from_numpy(rng.integers(
                      0, 1 << 40, (S, D, W)))}[start].to(DEV)
        plain_sketch, one_sketch = sketch.clone(), sketch.clone()
        # the finisher at the kernel's expiry slices and at another count
        X = sk.expiry_ctas(C, S)
        X_other = 3 if X != 3 else 1
        for d in range(2):
            packed, tenants = stats_edge_inputs(rng, K, S, B, C, T, kind)
            nows = torch.tensor([T0 + 1000 * d + 3 * k for k in range(K)],
                                dtype=torch.int64, device=DEV)
            decay = decay0 ^ d
            got = dk.drain_compact_stats(arena, packed, nows, tenants, acc)
            one = dk.launch_compact_stats(one_arena, packed, nows, tenants,
                                          one_acc, P=1)
            want = dk.drain_compact_stats_plain(plain_arena, packed, nows,
                                                tenants, plain_acc)
            torch.cuda.synchronize()
            what = f"stats drain {label} d{d}"
            want_acc = acc_state(plain_acc)
            for how, g, a, ac in (("chosen P", got, arena, acc),
                                  ("P = 1", one, one_arena, one_acc)):
                assert_same(g, want, f"{what} ({how}) outputs")
                assert_same(a, plain_arena, f"{what} ({how}) arena")
                assert_same(acc_state(ac), want_acc,
                            f"{what} ({how}) accumulator")
                errs += list(zip(acc_state(ac), want_acc))
            errs += list(zip(one, want)) + list(zip(one_arena, plain_arena))
            got_acc = acc_state(acc)
            got_st = sk.stats_finish(sketch, acc, arena.expire, int(nows[0]),
                                     decay, topk=topk, over_weight=4)
            # the P = 1 accumulator through the finisher at X_other slices,
            # its sketch worked on in place and its rank keys rebuilt from
            # the entries on every pass
            one_st = sk.launch_finish(one_sketch, one_acc, one_arena.expire,
                                      int(nows[0]), decay, topk=topk,
                                      over_weight=4, X=X_other, key_cap=0,
                                      sketch_smem=0)
            want_st = sk.stats_finish_plain(plain_sketch, plain_acc,
                                            plain_arena.expire, int(nows[0]),
                                            decay, topk=topk, over_weight=4)
            torch.cuda.synchronize()
            for how, st, skt, ac in (
                    (f"X = {X}", got_st, sketch, acc),
                    (f"X = {X_other}, in place", one_st, one_sketch,
                     one_acc)):
                assert_same((st, skt), (want_st, plain_sketch),
                            f"finisher {label} d{d} ({how}) stats, sketch")
                for name in ("index", "count", "tenant", "header", "ecount",
                             "edone"):
                    check(not getattr(ac, name).any(),
                          f"finisher {label} d{d} ({how}) left acc.{name} "
                          f"set")
            errs += (list(zip(got, want)) + list(zip(arena, plain_arena))
                     + list(zip(got_acc, want_acc))
                     + [(got_st, want_st), (sketch, plain_sketch),
                        (one_st, want_st), (one_sketch, plain_sketch)])
            drains += 1
    err = max_abs_err(errs)
    log(f"phase 6a stats drain + finisher vs plain: {drains} drains over "
        f"{len(cases)} cases ({', '.join(c[0] for c in cases)}; K in 1,2,4, "
        f"S in 1,2,8, B in 37..3000, T in 8,64, sketch 2x16 and 4x2048, "
        f"decay both ways, chained over one accumulator; the stats drain "
        f"at the chosen P and at P = 1, the finisher at the chosen expiry "
        f"slices a shard with its sketch and rank keys in shared memory "
        f"and at another count with the sketch in place and the keys "
        f"rebuilt), bit-exact "
        f"(max_abs_err {err}); the accumulator empty after every finish")
    return err


def analytics_tenants(rng, K, S, B, T):
    """Each lane's tenant: one of T ids, weighted toward a few (a tenant's
    share follows a Zipf law), 0.5% out of range either way."""
    t = (rng.zipf(1.5, (K, S, B)) - 1) % T
    bad = rng.random((K, S, B)) < 0.005
    t[bad] = rng.choice([-1, T, T + 7], int(bad.sum()))
    return t.astype(np.int32)


def stats_drain_bound_ms(lanes, slots):
    """The stats drain's least time: the drain's (bound_ms) plus 4 B of
    tenant id per lane and, per touched row, the accumulator's index read
    and written and its entry written (a sector each)."""
    t_drain, _ = bound_ms(lanes, 16, 16, slots)
    extra = (lanes * 4 + slots * 3 * SECTOR) / HBM_BYTES_PER_S * 1e3
    t_bytes = t_drain + extra
    t_ops = lanes * (420 + TRANSITION_DIVS * FDIV_OPS) / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def finisher_bound_ms(S, C, D, W, T, topk, rows):
    """The finisher's least time, all bytes: the expiry plane read once
    (8 B a row), the touched rows' entries read (32 B) and index entries
    cleared (a sector each), the sketch read and written, the tenant rows
    read, the stats written."""
    nbytes = (S * C * 8 + rows * (32 + SECTOR) + S * D * W * 8 * 2
              + S * T * 24 + S * ta.stats_len(T, topk) * 8)
    return nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def phase_analytics_full_size(gen, rng):
    """Phase 6b: the analytics path at the phase-5c shape.  The counted
    part: ANALYTICS_DRAINS composed drains with analytics, each ingested
    into TrafficAnalytics, then the call timed with and without analytics.
    The caller reads the counts when it returns; the checks of the first
    drain against the plain versions and the host oracle come after."""
    eng = sharded_engine(gen)
    conf = AnalyticsConfig(enabled=True, **ANALYTICS)
    eng.enable_analytics(conf)
    S, B, C, T = SHARDS, FULL_LANES, eng.capacity_per_shard, conf.tenant_slots
    drains = []
    for i in range(ANALYTICS_DRAINS):
        packed = torch.from_numpy(np.stack(
            [full_size_traffic(rng, FULL_K, B, C) for _ in range(S)],
            axis=1)).to(DEV)
        nows = np.asarray([T0 + 50 * i + k for k in range(FULL_K)],
                          np.int64)
        tenants = torch.from_numpy(analytics_tenants(rng, FULL_K, S, B,
                                                     T)).to(DEV)
        drains.append((packed, nows, tenants, int(i % 4 == 3)))
    gbatch, gacc, upd = global_traffic(rng, eng)
    first = dict(arena0=clone(eng.state), gstate0=clone(eng.gstate),
                 gcfg0=clone(eng.gcfg),
                 sketch0=torch.from_numpy(eng.export_analytics()).to(DEV))
    an = TrafficAnalytics(conf)

    reset_counts()
    for i, (packed, nows, tenants, decay) in enumerate(drains):
        out = eng.pipeline_dispatch_global(packed, nows, gbatch, gacc, upd,
                                           analytics_args=(tenants, decay))
        if i == 0:
            first.update(out=[t.clone() for t in out], arena=clone(eng.state),
                         gstate=clone(eng.gstate), gcfg=clone(eng.gcfg),
                         sketch=torch.from_numpy(eng.export_analytics()).to(
                             DEV))
        an.ingest(out[4].cpu().numpy(), decay)

    packed, nows, tenants, _ = drains[-1]

    def with_an():
        return eng.pipeline_dispatch_global(packed, nows, gbatch, gacc, upd,
                                            analytics_args=(tenants, 0))

    def without():
        return eng.pipeline_dispatch_global(packed, nows, gbatch, gacc, upd)

    with_an()
    without()
    # in turns: with, without, without, with
    a1 = cuda_ms(with_an, 20)
    w1 = cuda_ms(without, 20)
    w2 = cuda_ms(without, 20)
    a2 = cuda_ms(with_an, 20)
    busy_an = device_busy_ms(with_an, 20)
    busy_wo = device_busy_ms(without, 20)
    stats_drain_ms = device_ms(with_an, 20, "drain_compact_stats_kernel")
    finish_ms = device_ms(with_an, 20, "stats_finish_kernel")
    drain_ms = device_ms(without, 20, "drain_compact_kernel")
    torch.cuda.synchronize()
    check(not eng._gsums.any(), "the engine's GLOBAL scratch is not 0")
    return dict(eng=eng, conf=conf, drains=drains, first=first, an=an,
                call_ms=((a1 + a2) / 2, (w1 + w2) / 2), busy=(busy_an, busy_wo),
                stats_drain_ms=stats_drain_ms, finish_ms=finish_ms,
                drain_ms=drain_ms, gbatch=gbatch, gacc=gacc, upd=upd)


def check_analytics_full_size(r):
    """Phase 6b, after the counts are read: the first drain against the
    plain versions on the card (responses, arena, sketch, stats) and
    against oracle_stats on the host; the ingested totals."""
    eng, conf, first = r["eng"], r["conf"], r["first"]
    packed, nows, tenants, decay = r["drains"][0]
    S, C, T, topk = (SHARDS, eng.capacity_per_shard, conf.tenant_slots,
                     conf.topk)
    arena, sketch = first["arena0"], first["sketch0"]
    sketch0 = sketch.cpu().numpy().copy()
    acc = sk.StatsAccumulator(S, C, T, DEV)
    nows = torch.from_numpy(nows).to(DEV)
    # the first drain's GLOBAL window against global_window_plain
    gstate, gcfg = first["gstate0"], first["gcfg0"]
    gread = gk.global_window_plain(
        gstate, gcfg, gk.make_control(r["gbatch"], r["gacc"], r["upd"], DEV),
        torch.zeros_like(gstate.limit), int(nows[0]))
    gfused = first["out"][3]
    assert_same((gfused.reshape(gread.shape),), (gread,),
                "analytics drain GLOBAL response block")
    assert_same(first["gstate"], gstate, "analytics drain gstate")
    assert_same(first["gcfg"], gcfg, "analytics drain gcfg")
    gerr = max_abs_err([(gfused.reshape(gread.shape), gread)]
                       + list(zip(first["gstate"], gstate))
                       + list(zip(first["gcfg"], gcfg)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = dk.drain_compact_stats_plain(arena, packed, nows, tenants, acc)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    want_st = sk.stats_finish_plain(sketch, acc, arena.expire, int(nows[0]),
                                    decay, topk=topk,
                                    over_weight=conf.over_weight)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    words, limits, mism, _, stats = first["out"]
    assert_same((words, limits, mism), want, "analytics drain outputs")
    assert_same(first["arena"], arena, "analytics drain arena")
    assert_same((stats, first["sketch"]), (want_st, sketch),
                "analytics stats, sketch")
    err = max_abs_err(list(zip((words, limits, mism), want))
                      + list(zip(first["arena"], arena))
                      + [(stats, want_st), (first["sketch"], sketch)])
    # the host oracle on every shard
    h0 = time.perf_counter()
    for s in range(S):
        o_sk, o_st = ta.oracle_stats(
            sketch0[s], packed[:, s].cpu().numpy(), words[:, s].cpu().numpy(),
            tenants[:, s].cpu().numpy(), first["arena"].expire[s].cpu().numpy(),
            int(nows[0]), decay, tenant_slots=T, topk=topk,
            over_weight=conf.over_weight)
        check(np.array_equal(o_st, stats[s].cpu().numpy()),
              f"shard {s} stats differ from oracle_stats")
        check(np.array_equal(o_sk, first["sketch"][s].cpu().numpy()),
              f"shard {s} sketch differs from oracle_stats")
    oracle_s = time.perf_counter() - h0
    an = r["an"]
    lanes = sum(int(((p[..., 0] & 0xFFFFFFFF) != 0).sum())
                for p, *_ in r["drains"])
    totals = an.snapshot()["totals"]
    check(totals["drains"] == ANALYTICS_DRAINS
          and totals["decisions"] == lanes,
          f"TrafficAnalytics totals {totals}, want {lanes} decisions")
    top = an.topk_snapshot(3)
    check(len(top) == 3 and top[0]["score"] >= top[1]["score"] > 0,
          f"TrafficAnalytics top-K {top}")
    return dict(err=err, global_err=gerr, stats_plain_ms=(t1 - t0) * 1e3,
                finish_plain_ms=(t2 - t1) * 1e3, oracle_s=oracle_s,
                totals=totals, top=top)


def report_analytics(r, chk, counts):
    S, B, C = SHARDS, FULL_LANES, r["eng"].capacity_per_shard
    conf = r["conf"]
    packed = r["drains"][0][0]
    lanes = FULL_K * S * B
    slots = sum(touched_slots(packed[:, s]) for s in range(S))
    sbms, sby = stats_drain_bound_ms(lanes, slots)
    fbms, fby = finisher_bound_ms(S, C, conf.sketch_depth, conf.sketch_width,
                                  conf.tenant_slots, conf.topk, slots)
    (a_ms, w_ms), (busy_an, busy_wo) = r["call_ms"], r["busy"]

    def busy(b, call):
        return ("not measured" if b is None else
                f"{b:.4f} ms busy, idle share {1 - b / call:.3f}")

    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
    log(f"phase 6b analytics at full size: [{S}, {C}] arena, K={FULL_K} x "
        f"S={S} x B={B} + GLOBAL {S} x {r['eng'].global_batch_per_shard}, "
        f"sketch {conf.sketch_depth} x {conf.sketch_width}, T="
        f"{conf.tenant_slots}, topk={conf.topk}; {ANALYTICS_DRAINS} drains "
        f"(decay on every 4th) ingested: totals {chk['totals']}, top key "
        f"{chk['top'][0]['key']} score {chk['top'][0]['score']}; first drain "
        f"bit-exact vs plain (arena, responses, sketch, stats, and the "
        f"GLOBAL window's read block, gstate and gcfg) and vs "
        f"oracle_stats on all {S} shards ({chk['oracle_s']:.1f} s host); "
        f"pipeline_dispatch_global with analytics {a_ms:.4f} ms/call, "
        f"without {w_ms:.4f} ms/call (CUDA events, 2 x 20 calls each, in "
        f"turns); card {busy(busy_an, a_ms)} with, {busy(busy_wo, w_ms)} "
        f"without; device (profiler, 20 calls): drain_compact_stats "
        f"{fmt(r['stats_drain_ms'])}, drain_compact {fmt(r['drain_ms'])}, "
        f"stats_finish {fmt(r['finish_ms'])}; plain stats drain "
        f"{chk['stats_plain_ms']:.2f} ms, plain finisher "
        f"{chk['finish_plain_ms']:.2f} ms; bounds: stats drain "
        f"{sbms * 1e3:.3f} us ({sby}), finisher {fbms * 1e3:.3f} us ({fby}) "
        f"over {slots} touched rows; launches {counts}")
    return dict(stats_bound=(sbms, sby), finish_bound=(fbms, fby))


# ---------------------------------------------------------------- per-op

REPLAY_CAP = 128            # the engine's default replay_cap
# window_math's other tile widths in phase 7a: one no segment lines up
# with, and the whole 1024-lane window on one CTA
MATH_TILES = (7, FULL_LANES)


def per_op_edge_window(rng, B, C, wide):
    """One window of decoded lanes (numpy) for the per-op kernel: phase 2's
    random_windows traffic (all five algorithms, CONCURRENCY releases, AGG
    runs, inits, pads, duplicates), plus a hot run longer than the replay
    cap with configs that change inside it (it replays), a uniform hot run
    (it folds), 3% of the lanes on row C - 1 and 3% past the arena; `wide`
    puts limits, durations and hits far outside the compact caps and
    algorithm values past 4 on some lanes."""
    bt = [np.asarray(a).copy() for a in tk.decode_batch(torch.from_numpy(
        random_windows(rng, 1, B, C, cap_edges=not wide)[0]))]
    slot, hits, limit, duration, algo, is_init = bt
    valid = slot >= 0
    run = valid & (rng.random(B) < 0.3)
    slot[run] = 11                       # > REPLAY_CAP lanes at B >= 1024
    limit[run] = rng.choice([50, 60], int(run.sum()))
    uni = valid & ~run & (rng.random(B) < 0.15)
    slot[uni] = 12
    hits[uni] = np.where(rng.random(int(uni.sum())) < 0.3, 0, 2)
    limit[uni], duration[uni], algo[uni], is_init[uni] = 40, 60_000, 1, False
    last = valid & ~run & ~uni & (rng.random(B) < 0.03)
    slot[last] = C - 1
    past = valid & ~run & ~uni & ~last & (rng.random(B) < 0.03)
    slot[past] = C + rng.integers(0, 7, int(past.sum()))
    if wide:
        big = rng.random(B) < 0.5
        limit[big] = rng.integers(2**31, 2**45, int(big.sum()))
        duration[big] = rng.integers(2**31, 2**40, int(big.sum()))
        h = rng.random(B) < 0.2
        hits[h] = rng.integers(-5, 2**33, int(h.sum()))
        algo[rng.random(B) < 0.1] = 9
    return tk.WindowBatch(slot, hits, limit, duration, algo, is_init), \
        int(run.sum())


def prep_args(prep):
    """window_math's arguments after now and max_pos, from a prep."""
    return (prep.s_valid, prep.s_hits, prep.s_limit, prep.s_duration,
            prep.s_algo, prep.s_init, prep.s_agg, prep.pos, prep.seg_len,
            prep.seg_start_idx, prep.seg_fold, prep.h0, prep.l0, prep.d0,
            prep.a0, prep.fresh_seg, prep.nz, prep.n_lead, prep.hstar,
            prep.cur)


def phase_per_op_vs_plain():
    """Phase 7a: window_math against window_math_plain on the preps of edge
    windows (kernel.window_prep on the card, chained windows whose clock
    steps back once); window_step_per_op's committed window against
    kernel.window_step on the same arena; global_apply against global_apply_plain on phase
    5a's edge inputs at G = 4096 and G = 3000 (no multiple of the TPU
    kernel's 1024-row block)."""
    rng = np.random.default_rng(7070)
    gen = torch.Generator(device=DEV).manual_seed(7070)
    C, B = 4096, 1024
    errs, windows, longest = [], 0, 0
    arena = random_arena(gen, C, T0, DEV)
    st = tk.BucketState(*[t[0] for t in arena])
    oracle = clone(st)
    nows = T0 + np.cumsum([0, 900, 1700, -5000, 300, 100_000, 20, 7])
    for i, now in enumerate(nows):
        now = int(now)
        bt, run = per_op_edge_window(rng, B, C, wide=i in (5, 6))
        longest = max(longest, run)
        bt = tk.WindowBatch(*[torch.from_numpy(np.ascontiguousarray(a)).to(DEV)
                              for a in bt])
        prep = tk.window_prep(st, bt, torch.tensor(now, device=DEV))
        got = wm.window_math(now, prep.max_pos, *prep_args(prep))
        want = wm.window_math_plain(now, prep.max_pos, *prep_args(prep))
        # the same window in CTAs of other widths: a width no segment
        # lines up with, and the whole window on one CTA
        others = [(t, wm.launch_math(now, prep.max_pos, *prep_args(prep),
                                     tile=t)) for t in MATH_TILES]
        torch.cuda.synchronize()
        for t, g in [("default", got)] + others:
            assert_same(g[0], want[0], f"window_math {i} tile {t} responses")
            assert_same(g[1], want[1], f"window_math {i} tile {t} fin")
            errs += list(zip(g[0], want[0])) + list(zip(g[1], want[1]))
        st, out = wm.window_step_per_op(st, bt, now)
        oracle, out_o = tk.window_step(oracle, bt, now)
        valid = bt.slot >= 0
        for name, a, b in zip(tk.WindowOutput._fields, out, out_o):
            check(torch.equal(a[valid], b[valid]) and not a[~valid].any(),
                  f"window_step_per_op {i} {name} differs from window_step")
        assert_same(st, oracle, f"window_step_per_op {i} arena")
        windows += 1
    math_err = max_abs_err(errs)

    errs = []
    n = SHARDS * BG_FULL
    cases = [(range(7), False), ((0, 1), False), (range(7), True),
             ((2, 3, 4), True)]
    for G in (G_FULL, 3000):
        for i, (algos, wrap) in enumerate(cases):
            gst, cfg, bt, _ = global_edge_inputs(rng, G, n, algos, wrap)
            ctl = gk.make_control(*edge_control(rng, G, bt, KG_FULL, wrap),
                                  DEV)
            errs += per_op_global_vs_plain(gst, cfg, ctl, T0 + i,
                                           f"per-op GLOBAL G={G} case {i}")
    apply_err = max_abs_err(errs)
    log(f"phase 7a per-op kernels vs plain: window_math on {windows} chained "
        f"edge windows of B={B} over C={C} (all five algorithms and values "
        f"past 4, releases, AGG runs, inits, pads, a mixed-config hot run of "
        f"up to {longest} lanes > replay cap {REPLAY_CAP}, a folding hot run, "
        f"lanes on row C - 1 and past the arena, two int64 windows outside "
        f"the compact caps, a clock that steps back 5 s) in CTAs of the "
        f"default {wm.default_tile()} lanes and of {MATH_TILES} lanes, "
        f"bit-exact (max_abs_err {math_err}); "
        f"window_step_per_op = kernel.window_step window after window; "
        f"global_stage, the torch reads and global_apply on "
        f"{2 * len(cases)} edge windows of {n} lanes and {KG_FULL} config "
        f"lanes at G = {G_FULL} and 3000: read block, gstate, gcfg "
        f"bit-exact, scratch back at 0 (max_abs_err {apply_err})")
    return math_err, apply_err


def per_op_global_vs_plain(st, cfg, ctl, now, what):
    """global_stage, the per-op torch reads and global_apply against
    global_stage_plain, the same reads and global_apply_plain on copies of
    one arena and config: the read block, every gstate and gcfg plane, and
    the scratch back at zero.  Returns the (got, want) pairs compared."""
    G = st.limit.shape[0]
    k_st, k_cfg, p_st, p_cfg = clone(st), clone(cfg), clone(st), clone(cfg)
    k_sc = torch.zeros(G, dtype=torch.int64, device=DEV)
    p_sc = torch.zeros_like(k_sc)
    gk.global_stage(k_st, k_cfg, ctl, k_sc)
    got = gk.global_read_block(k_st, ctl, now)
    gk.global_apply(k_st, k_cfg, ctl, k_sc, now)
    gk.global_stage_plain(p_st, p_cfg, ctl, p_sc)
    want = gk.global_read_block(p_st, ctl, now)
    gk.global_apply_plain(p_st, p_cfg, ctl, p_sc, now)
    torch.cuda.synchronize()
    assert_same((got,), (want,), f"{what} read block")
    assert_same(k_st, p_st, f"{what} gstate")
    assert_same(k_cfg, p_cfg, f"{what} gcfg")
    check(not k_sc.any(), f"{what}: the scratch is not back at zero")
    return [(got, want)] + list(zip(k_st, p_st)) + list(zip(k_cfg, p_cfg))


def per_op_engine(like):
    """An engine of `like`'s geometry built under GUBER_PALLAS=1 (the
    per-op lowering), holding `like`'s arenas."""
    old = os.environ.get("GUBER_PALLAS")
    os.environ["GUBER_PALLAS"] = "1"
    try:
        eng = RateLimitEngine(
            capacity_per_shard=like.capacity_per_shard,
            batch_per_shard=like.batch_per_shard, num_shards=like.num_shards,
            global_capacity=like.global_capacity,
            global_batch_per_shard=like.global_batch_per_shard,
            max_global_updates=like.max_global_updates)
    finally:
        if old is None:
            del os.environ["GUBER_PALLAS"]
        else:
            os.environ["GUBER_PALLAS"] = old
    check(eng.per_op and not like.per_op, "GUBER_PALLAS did not take")
    eng.import_arena(like.export_arena())
    return eng


def snapshot(eng, out):
    """A call's outputs and every plane of the engine after it."""
    return ([t.clone() for t in out] if isinstance(out, tuple) else out,
            [t.clone() for t in eng._planes().values()],
            None if eng._an_sketch is None else eng._an_sketch.clone())


def mixed_window(rng, n, glob_share):
    """n requests: regular keys of all five algorithms over 400 keys with
    Zipf skew, and a share of GLOBAL token/leaky keys over 50."""
    reqs = []
    for _ in range(n):
        if rng.random() < glob_share:
            reqs.append(RateLimitReq(
                name="pg", unique_key=f"g{int(rng.zipf(1.3)) % 50}",
                hits=int(rng.integers(0, 3)), limit=30, duration=60_000,
                algorithm=int(rng.integers(0, 2)), behavior=Behavior.GLOBAL))
        else:
            reqs.append(RateLimitReq(
                name="pr", unique_key=f"k{int(rng.zipf(1.3)) % 400}",
                hits=int(rng.integers(0, 3)), limit=20, duration=60_000,
                algorithm=int(rng.integers(0, 5))))
    return reqs


def per_op_script(gen, rng):
    """Phase 7b's calls and 7c's engines: the one-shard engine of phase 3
    and the 8-shard engine of phase 5c with analytics at phase 6b's
    geometry, each as a default engine and a per-op twin on the same
    arenas, and the calls both take, in order: (label, engine index, fn)
    with fn(eng) making one call."""
    one = full_size_engine(gen)
    eight = sharded_engine(gen)
    conf = AnalyticsConfig(enabled=True, **ANALYTICS)
    eight.enable_analytics(conf)
    pairs = [(one, per_op_engine(one)), (eight, per_op_engine(eight))]
    pairs[1][1].enable_analytics(conf)
    packed1 = [torch.from_numpy(full_size_traffic(
        rng, FULL_K, FULL_LANES, FULL_CAPACITY)[:, None]).to(DEV)
        for _ in range(2)]
    nows1 = [torch.tensor([T0 + 1000 * d + 5 * k for k in range(FULL_K)],
                          dtype=torch.int64, device=DEV) for d in range(2)]
    C8 = eight.capacity_per_shard
    packed8 = [torch.from_numpy(np.stack(
        [full_size_traffic(rng, FULL_K, FULL_LANES, C8)
         for _ in range(SHARDS)], axis=1)).to(DEV) for _ in range(3)]
    nows8 = [np.asarray([T0 + 2000 * d + 7 * k for k in range(FULL_K)],
                        np.int64) for d in range(3)]
    gctl = [global_traffic(rng, eight) for _ in range(3)]
    tenants = [torch.from_numpy(analytics_tenants(
        rng, FULL_K, SHARDS, FULL_LANES, conf.tenant_slots)).to(DEV)
        for _ in range(2)]
    win1 = mixed_window(rng, 1000, 0.0)
    win8 = mixed_window(rng, 1000, 0.2)
    calls = [
        ("1-shard pipeline_dispatch 1", 0,
         lambda e: e.pipeline_dispatch(packed1[0], nows1[0])),
        ("1-shard pipeline_dispatch 2", 0,
         lambda e: e.pipeline_dispatch(packed1[1], nows1[1])),
        ("1-shard process", 0,
         lambda e: e.process(win1, now=T0 + 5000)),
        ("8-shard pipeline_dispatch_global", 1,
         lambda e: e.pipeline_dispatch_global(packed8[0], nows8[0],
                                              *gctl[0])),
        ("8-shard pipeline_dispatch_global + analytics", 1,
         lambda e: e.pipeline_dispatch_global(
             packed8[1], nows8[1], *gctl[1],
             analytics_args=(tenants[0], 0))),
        ("8-shard pipeline_dispatch_global + analytics, decay", 1,
         lambda e: e.pipeline_dispatch_global(
             packed8[2], nows8[2], *gctl[2],
             analytics_args=(tenants[1], 1))),
        ("8-shard process, 20% GLOBAL", 1,
         lambda e: e.process(win8, now=T0 + 9000)),
    ]
    timed = {
        "pipeline_dispatch, 1 shard": (0, lambda e: e.pipeline_dispatch(
            packed1[0], nows1[0])),
        "pipeline_dispatch_global, 8 shards": (
            1, lambda e: e.pipeline_dispatch_global(packed8[0], nows8[0],
                                                    *gctl[0])),
    }
    return dict(pairs=pairs, calls=calls, timed=timed, packed1=packed1,
                nows1=nows1, gctl=gctl, nows8=nows8)


def phase_per_op_path(script):
    """Phase 7b, the counted per-op path: each call of the script on the
    per-op engines (snapshots of outputs and every plane kept for 7c),
    then the calls timed (CUDA events) and each new kernel's device time
    in them (profiler).  The caller reads the counts when it returns."""
    pairs, calls = script["pairs"], script["calls"]
    snaps = []
    for label, i, fn in calls:
        eng = pairs[i][1]
        snaps.append(snapshot(eng, fn(eng)))
    torch.cuda.synchronize()
    times = {}
    for label, (i, fn) in script["timed"].items():
        eng = pairs[i][1]
        fn(eng)
        times[label] = cuda_ms(lambda: fn(eng), 3)
    e1, e8 = pairs[0][1], pairs[1][1]
    fn1 = script["timed"]["pipeline_dispatch, 1 shard"][1]
    fn8 = script["timed"]["pipeline_dispatch_global, 8 shards"][1]
    math_ms = device_ms(lambda: fn1(e1), 2, "window_math_kernel")
    g_ms = device_ms_each(lambda: fn8(e8), 3, ("global_stage_kernel",
                                               "global_apply_kernel"))
    stage_ms = g_ms["global_stage_kernel"]
    apply_ms = g_ms["global_apply_kernel"]
    check(not e8._gsums.any(), "the per-op engine's GLOBAL scratch is not 0")
    return dict(snaps=snaps, times=times, math_ms=math_ms, apply_ms=apply_ms,
                stage_ms=stage_ms)


def check_per_op_against_default(script, r):
    """Phase 7c, after the counts are read: the default engines take the
    same calls; every output and every plane (and the sketch) after each
    call must equal the per-op engine's; then the default calls timed."""
    pairs, calls = script["pairs"], script["calls"]
    errs = []
    for (label, i, fn), (out_p, planes_p, sk_p) in zip(calls, r["snaps"]):
        eng = pairs[i][0]
        out_d, planes_d, sk_d = snapshot(eng, fn(eng))
        torch.cuda.synchronize()
        if isinstance(out_d, list) and out_d and isinstance(out_d[0],
                                                            torch.Tensor):
            assert_same(out_p, out_d, f"{label} outputs")
            errs += list(zip(out_p, out_d))
        else:
            check([(x.status, x.limit, x.remaining, x.reset_time, x.error)
                   for x in out_p]
                  == [(x.status, x.limit, x.remaining, x.reset_time, x.error)
                      for x in out_d], f"{label} responses differ")
        assert_same(planes_p, planes_d, f"{label} arena planes")
        check(not eng._gsums.any() and not pairs[i][1]._gsums.any(),
              f"{label}: a GLOBAL scratch is not back at 0")
        errs += list(zip(planes_p, planes_d))
        if sk_p is not None or sk_d is not None:
            assert_same((sk_p,), (sk_d,), f"{label} sketch")
            errs.append((sk_p, sk_d))
    err = max_abs_err(errs)
    times = {}
    for label, (i, fn) in script["timed"].items():
        eng = pairs[i][0]
        fn(eng)
        times[label] = cuda_ms(lambda: fn(eng), 3)
    return dict(err=err, times=times)


def math_divisions(prep):
    """The int64 divisions window_math.cu issues on a prep: a covered lane
    takes its transition, and its segment's last lane's too where that is
    another lane, with a Fold where either sits past position 0; each lane
    of a residual segment up to max_pos is one transition of its walk."""
    v = prep.s_valid
    B = v.shape[0]
    covered = v & (prep.seg_fold | (prep.seg_len == 1))
    last = torch.clamp(prep.seg_start_idx + prep.seg_len - 1, 0, B - 1)
    other = covered & (last != torch.arange(B, device=v.device))
    folds = covered & ((prep.pos > 0) | other)
    walked = v & ~covered & (prep.pos <= prep.max_pos)
    transitions = int(covered.sum()) + int(other.sum()) + int(walked.sum())
    return int(folds.sum()) * FOLD_DIVS + transitions * TRANSITION_DIVS


def per_op_bounds_and_plain(script):
    """The new kernels at the per-op path's shapes: window_math's plain
    time and bound on the first window of the 1-shard drain (B = 1024
    lanes, one shard), global_stage's and global_apply's on the 8-shard
    GLOBAL window (G = 4096), from the default engines' arenas after 7c."""
    one, eight = script["pairs"][0][0], script["pairs"][1][0]
    now = int(script["nows1"][0][0])
    bt = tk.decode_batch(script["packed1"][0][0, 0])
    prep = tk.window_prep(tk.BucketState(*[t[0] for t in one.state]), bt,
                          torch.tensor(now, device=DEV))
    wm.window_math_plain(now, prep.max_pos, *prep_args(prep))  # warm-up
    math_plain = cuda_ms(lambda: wm.window_math_plain(
        now, prep.max_pos, *prep_args(prep)), 3)
    B = bt.slot.shape[0]
    # each of the 19 lane inputs and the gathered register read, the
    # responses and the final register written, at their element sizes in
    # this run; ~400 32-bit operations a lane besides the divisions this
    # window's lanes take (math_divisions)
    out_sorted, fin = wm.window_math(now, prep.max_pos, *prep_args(prep))
    math_in = lane_bytes(*prep_args(prep)[:-1], *prep.cur)
    math_out = lane_bytes(*out_sorted, *fin)
    divs = math_divisions(prep)
    math_bound = bound_ms(B, math_in, math_out, 0,
                          ops_per_lane=400 + divs * FDIV_OPS / B)
    G = eight.global_capacity
    gb, gacc, upd = script["gctl"][0]
    ctl = gk.make_control(gb, gacc, upd, DEV)
    g_now = int(script["nows8"][0][0])
    st, cfg = clone(eight.gstate), clone(eight.gcfg)
    scratch = torch.zeros(G, dtype=torch.int64, device=DEV)

    def plain_pair():
        gk.global_stage_plain(st, cfg, ctl, scratch)
        gk.global_apply_plain(st, cfg, ctl, scratch, g_now)

    plain_pair()  # warm-up
    # each plain version timed alone (CUDA events, mean of 3): the apply
    # after an untimed stage has filled the sums
    stage_plain, apply_plain = [], []
    for _ in range(3):
        stage_plain.append(cuda_ms(
            lambda: gk.global_stage_plain(st, cfg, ctl, scratch), 1))
        apply_plain.append(cuda_ms(
            lambda: gk.global_apply_plain(st, cfg, ctl, scratch, g_now), 1))
    stage_plain = float(np.mean(stage_plain))
    apply_plain = float(np.mean(apply_plain))
    # the kernels alone, per launch back to back (CUDA events): where the
    # profiler shows no device time, these stand in
    math_events = cuda_ms(lambda: wm.window_math(
        now, prep.max_pos, *prep_args(prep)), 20)

    def pair():
        gk.global_stage(st, cfg, ctl, scratch)
        gk.global_apply(st, cfg, ctl, scratch, g_now)

    pair_events = cuda_ms(pair, 20)
    check(not scratch.any(), "the per-op GLOBAL pair left its scratch nonzero")
    stage_bound, apply_bound = per_op_global_bounds(gb, gacc, upd, G)
    return dict(math_plain=math_plain, math_bound=math_bound,
                math_bytes=(math_in, math_out), stage_plain=stage_plain,
                apply_plain=apply_plain, apply_bound=apply_bound,
                stage_bound=stage_bound,
                math_events=math_events, pair_events=pair_events)


def per_op_global_bounds(gbatch, gacc, upd, G, ku=0):
    """The least times of global_stage and global_apply on one window
    (global_window_bound_ms's accounting, split): global_stage reads each
    lane's slot and gacc (16 B), each config lane (40 B) and each of ku
    upsert lanes (56 B), writes each config write (20 B) and reset (8 B)
    that lands, each upserted row's state and config (64 B) and each
    contributing lane's atomic (8 B); the lanes' other 40 B are the torch
    reads' to read.  global_apply reads each lane's slot and gacc (16 B) and each
    touched row's state, config and sum (72 B) and writes its state and
    sum (52 B), with the ladder's operations per touched row.  Each
    (ms, bound_by)."""
    n, kg, writes, resets, contrib, touched = window_counts(gbatch, gacc,
                                                            upd, G)
    stage = (n * 16 + kg * 40 + writes * 20 + resets * 8 + contrib * 8
             + ku * (56 + 64)) / HBM_BYTES_PER_S * 1e3
    a_bytes = (n * 16 + touched * (72 + 52)) / HBM_BYTES_PER_S * 1e3
    a_ops = (touched * (200 + TRANSITION_DIVS * FDIV_OPS) / INT32_OPS_PER_S
             * 1e3)
    return ((stage, "bytes"),
            (max(a_bytes, a_ops), "bytes" if a_bytes >= a_ops else
             "operations"))


# window_math alone on 1024-lane windows built as phase 3a builds its
# drains: (label, share of lanes on hot slots, hot slots)
MATH_WINDOWS = (("half on 64 hot slots", 0.5, 64), ("no hot slots", 0.0, 1),
                ("one key", 1.0, 1))


def longest_residual(prep):
    """The most lanes of one residual segment of a prep (a segment that
    neither folds nor is a single lane): the longest walk a window takes."""
    resid = prep.s_valid & ~prep.seg_fold & (prep.seg_len > 1)
    return int(prep.seg_len[resid].max()) if bool(resid.any()) else 0


def math_windows(st, now):
    """window_math on MATH_WINDOWS over a one-shard arena `st` ([C]
    planes): each window checked against the plain version, then its
    device time (profiler, 20 launches) beside its longest residual
    segment, and, where the wrapper has launch_math, at two other tile
    widths.  Launches through the counted wrapper: call it where no
    path's counts run."""
    rows = []
    for label, share, n_hot in MATH_WINDOWS:
        packed = full_size_traffic(np.random.default_rng(8), 1, FULL_LANES,
                                   st.limit.shape[0], share, n_hot)
        bt = tk.decode_batch(torch.from_numpy(packed[0]).to(DEV))
        prep = tk.window_prep(st, bt, torch.tensor(now, device=DEV))
        args = (now, prep.max_pos, *prep_args(prep))
        got = wm.window_math(*args)
        want = wm.window_math_plain(*args)
        torch.cuda.synchronize()
        assert_same(got[0], want[0], f"window_math {label} responses")
        assert_same(got[1], want[1], f"window_math {label} fin")
        in_b = lane_bytes(*prep_args(prep)[:-1], *prep.cur)
        out_b = lane_bytes(*got[0], *got[1])
        bound = bound_ms(FULL_LANES, in_b, out_b, 0, ops_per_lane=(
            400 + math_divisions(prep) * FDIV_OPS / FULL_LANES))
        row = dict(label=label, longest=longest_residual(prep),
                   ms=device_ms(lambda: wm.window_math(*args), 20,
                                "window_math_kernel"), tiles={},
                   bound=bound)
        if hasattr(wm, "launch_math"):
            for t in (64, FULL_LANES):
                row["tiles"][t] = device_ms(
                    lambda: wm.launch_math(*args, tile=t), 20,
                    "window_math_kernel")
        rows.append(row)
    fmt = lambda x: "not measured" if x is None else f"{x:.5f} ms"  # noqa: E731
    log(f"window_math alone, device (profiler, 20 launches) per "
        f"{FULL_LANES}-lane window, bit-exact vs plain: " + "; ".join(
            f"{r['label']} {fmt(r['ms'])} (longest residual segment "
            f"{r['longest']} lanes; bound {r['bound'][0] * 1e3:.4f} us, "
            f"{r['bound'][1]}"
            + "".join(f"; tile {t} {fmt(v)}" for t, v in r["tiles"].items())
            + ")" for r in rows))
    return rows


def finisher_split(seed=61):
    """stats_finish at phase 6b's shape (8 shards of 2^21 rows, sketch
    4 x 2048, T = 64) after one stats drain of phase 6b's traffic, device
    time (profiler, 10 finishes, each after its drain) with topk = 32 (the
    path's), with topk = 1 (one rank entry), and over an empty accumulator
    (n = 0: the decay, the header and the expiry count): how the
    finisher's time splits between the rank and the rest.  Its inputs
    come from its own seed, so that it draws nothing from the main
    script's generators.  Launches through the counted wrappers: call it
    where no path's counts run."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    rng = np.random.default_rng(seed)
    S, C, B, T = SHARDS, FULL_CAPACITY // SHARDS, FULL_LANES, 64
    arena = random_arena(gen, C, T0, DEV, S=S)
    acc = sk.StatsAccumulator(S, C, T, DEV)
    sketch = torch.zeros((S, ANALYTICS["sketch_depth"],
                          ANALYTICS["sketch_width"]), dtype=torch.int64,
                         device=DEV)
    packed = torch.from_numpy(np.stack(
        [full_size_traffic(rng, FULL_K, B, C) for _ in range(S)],
        axis=1)).to(DEV)
    nows = torch.tensor([T0 + k for k in range(FULL_K)], dtype=torch.int64,
                        device=DEV)
    tenants = torch.from_numpy(analytics_tenants(rng, FULL_K, S, B, T)).to(
        DEV)
    ow = ANALYTICS["over_weight"]

    def drain_and_finish(topk):
        dk.drain_compact_stats(arena, packed, nows, tenants, acc)
        return sk.stats_finish(sketch, acc, arena.expire, T0, 0, topk=topk,
                               over_weight=ow)

    drain_and_finish(32)
    entries = int(acc.entries.shape[1])
    dk.drain_compact_stats(arena, packed, nows, tenants, acc)
    touched = [int(c) for c in acc.count.cpu()]
    sk.stats_finish(sketch, acc, arena.expire, T0, 0, topk=32,
                    over_weight=ow)
    out = {}
    for label, fn in (
            ("topk 32", lambda: drain_and_finish(32)),
            ("topk 1", lambda: drain_and_finish(1)),
            ("n 0", lambda: sk.stats_finish(sketch, acc, arena.expire, T0, 0,
                                            topk=32, over_weight=ow))):
        fn()
        out[label] = device_ms(fn, 10, "stats_finish_kernel")
    torch.cuda.synchronize()
    fmt = lambda x: "not measured" if x is None else f"{x:.5f} ms"  # noqa: E731
    stamps = ""
    if hasattr(sk, "debug_stamps"):
        # the phases from globaltimer stamps, the mean of 10 finishes
        splits = []
        for _ in range(10):
            dk.drain_compact_stats(arena, packed, nows, tenants, acc)
            buf = sk.debug_stamps(S, DEV)
            sk.launch_finish(sketch, acc, arena.expire, T0, 0, topk=32,
                             over_weight=ow, stamps=buf)
            torch.cuda.synchronize()
            splits.append(sk.stamp_split(buf, S))
        out["stamps_us"] = {k: float(np.mean([x[k] for x in splits]))
                            for k in splits[0]}
        stamps = "; globaltimer stamps, us (mean of 10 finishes, topk 32): " \
            + ", ".join(f"{k} {v:.2f}" for k, v in out["stamps_us"].items())
    log(f"stats_finish split at phase 6b's shape ([{S}, {C}] arena, "
        f"{touched} touched rows a shard of {entries} entries), device "
        f"(profiler, 10 finishes): "
        + ", ".join(f"{k} {fmt(v)}" for k, v in out.items()
                    if k != "stamps_us") + stamps)
    return out


def report_per_op(script, po, cmp, pb):
    fmt = lambda x: "not measured" if x is None else f"{x:.4f} ms"  # noqa: E731
    times = "; ".join(
        f"{label}: per-op {po['times'][label]:.4f} ms/call, default "
        f"{cmp['times'][label]:.4f} ms/call"
        for label in script["timed"])
    log(f"phase 7b/7c per-op lowering at full size: {len(script['calls'])} "
        f"calls ({', '.join(c[0] for c in script['calls'])}) on the per-op "
        f"engines and then on the default engines from the same arenas: "
        f"every output, response, arena plane and sketch identical "
        f"(max_abs_err {cmp['err']}); {times} (CUDA events, 3 calls each); "
        f"device (profiler): window_math {fmt(po['math_ms'])} per 1024-lane "
        f"launch, global_stage {fmt(po['stage_ms'])} and global_apply "
        f"{fmt(po['apply_ms'])} per 2048-lane window at G=4096; alone back "
        f"to back (CUDA events): window_math {pb['math_events']:.4f} ms, "
        f"global_stage + global_apply {pb['pair_events']:.5f} ms a pair; "
        f"plain window_math "
        f"{pb['math_plain']:.2f} ms, plain global_stage "
        f"{pb['stage_plain']:.2f} ms and global_apply "
        f"{pb['apply_plain']:.2f} ms alone; bounds: window_math "
        f"{pb['math_bound'][0] * 1e3:.3f} us ({pb['math_bound'][1]}; "
        f"{pb['math_bytes'][0]} B in, {pb['math_bytes'][1]} B out a lane), "
        f"global_stage {pb['stage_bound'][0] * 1e3:.3f} us "
        f"({pb['stage_bound'][1]}), global_apply "
        f"{pb['apply_bound'][0] * 1e3:.3f} us ({pb['apply_bound'][1]})")


# ---------------------------------------------------------------- serving

# phase 8: the pipelined serving lane at the JAX package's 8-device mesh as
# 8 shards on the card (2^24 slots), a million keys, RPCs of 100 items,
# 64 clients at saturation
SERVE_KEYS = 1 << 20
SERVE_DECISIONS = 50_000
SERVE_RPC = 100
SERVE_CLIENTS = 64
SERVE_SECONDS = 3.0
RATE_SECONDS = 2.0
RATE_SHARES = (0.25, 0.5, 1.0)
# one job's items at most (a scratch block: the RPC item cap)
SERVE_ITEMS_MAX = 1000
# the CPU twin's geometry: the port tests' sizes, 8 shards
SMALL_TWIN = dict(capacity_per_shard=256, batch_per_shard=64,
                  num_shards=SHARDS, global_capacity=64,
                  global_batch_per_shard=16, max_global_updates=16)


def serving_engine_config(**kw):
    return EngineConfig(capacity_per_shard=FULL_CAPACITY // SHARDS,
                        num_shards=SHARDS, batch_per_shard=FULL_LANES,
                        use_native="on", **kw)


def serving_request(idx, prefix, hits, compact_only=False):
    """Key idx's request: 70 of every 100 keys token or leaky in the
    compact range (the pipelined lane), 8 GCRA, 8 sliding window, 8
    concurrency (hits +1 or -1) and 6 NO_BATCHING token.  A key keeps its
    algorithm and behavior, so its requests stay on one lane, in order.
    compact_only maps every key to a token or leaky one."""
    c = idx % 100
    if compact_only:
        c %= 70
    algo, behavior = int(idx & 1), Behavior.BATCHING
    if 70 <= c < 78:
        algo = Algorithm.GCRA
    elif 78 <= c < 86:
        algo = Algorithm.SLIDING_WINDOW
    elif 86 <= c < 94:
        algo, hits = Algorithm.CONCURRENCY, 1 if hits else -1
    elif c >= 94:
        algo, behavior = Algorithm.TOKEN_BUCKET, Behavior.NO_BATCHING
    return RateLimitReq(name=f"t{idx % 80}", unique_key=f"{prefix}{idx}",
                        hits=hits, limit=20 + idx % 50, duration=60_000,
                        algorithm=algo, behavior=behavior)


def serving_rpcs(rng, n, prefix, keys=SERVE_KEYS, compact_only=False,
                 request=serving_request):
    """n decisions as RPCs of SERVE_RPC items: Zipf (a = 1.1) keys over
    `keys`, hits 1 mostly (runs fold), 0 or 2 now and then; `request`
    builds key idx's request."""
    idx = (rng.zipf(1.1, n) - 1) % keys
    hits = rng.choice([0, 1, 1, 1, 1, 1, 1, 2], n)
    reqs = [request(int(i), prefix, int(h), compact_only)
            for i, h in zip(idx, hits)]
    return [reqs[i:i + SERVE_RPC] for i in range(0, n, SERVE_RPC)]


def pin_clock(inst, now):
    """Serve on a pinned clock (now ms), or on the wall clock (None)."""
    pipe = inst.batcher.pipeline
    inst.batcher.now_fn = None if now is None else (lambda: now)
    pipe.now_fn = millisecond_now if now is None else (lambda: now)


async def serve_all(inst, rpcs):
    """A burst of RPCs, as many at once as QoS admission holds (its
    max_pending, 8192 at the JAX defaults; all at once without QoS): the
    RPCs go in groups of at most that many items, each group submitted
    together and answered before the next, so the order of submission is
    the list's and no item is shed (phase 11b drives the sheds).  The
    responses per RPC."""
    cap = inst.qos.admission.max_pending if inst.qos is not None else 0
    groups, n = [[]], 0
    for rpc in rpcs:
        if cap and groups[-1] and n + len(rpc) > cap:
            groups.append([])
            n = 0
        groups[-1].append(rpc)
        n += len(rpc)
    out = []
    for group in groups:
        out += await asyncio.gather(*(inst.get_rate_limits(r)
                                      for r in group))
    return out


def sync_checked_drain(inst, reqs, now):
    """One drain of `reqs` through the pipeline's engine-thread path under
    torch.cuda.set_sync_debug_mode("error"): packing, the copy in, the
    launches, the copies out and the event must not wait for the device.
    The drain joins no fetch (a chain member); its fetch and decode run
    after the mode is reset.  Runs on the engine thread."""
    from gubernator_tpu_torch.core.pipeline import ListJob
    pipe = inst.batcher.pipeline
    job = ListJob(reqs)
    stride = pipe._stride_target
    pipe._stride_target = 2
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pipe._drain_sync([job], now)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        pipe._stride_target = stride
    check(res.error is None and res.deferred and res.staged == [job],
          f"sync-checked drain: error {res.error}, staged {len(res.staged)}")
    _, outs = pipe._complete_sync_one(res)
    pipe._arena_ring.release(res.arena)
    return outs[0]


async def saturate(serve, rpcs, seconds):
    """SERVE_CLIENTS clients, each sending its next RPC (SERVE_RPC items)
    through `serve` when the last one answered, for `seconds`; returns
    (decisions, wall seconds)."""
    done = [0]
    stop = time.perf_counter() + seconds

    async def client(c):
        i = c
        while time.perf_counter() < stop:
            await serve(rpcs[i % len(rpcs)])
            done[0] += SERVE_RPC
            i += SERVE_CLIENTS

    t0 = time.perf_counter()
    await asyncio.gather(*(client(c) for c in range(SERVE_CLIENTS)))
    return done[0], time.perf_counter() - t0


async def offered_rate(serve, rpcs, rate, seconds):
    """Open loop: RPCs of SERVE_RPC items sent through `serve` at `rate`
    decisions/s for `seconds`, each on its own schedule; returns the call
    latencies (ms, answer time minus scheduled send time) and the achieved
    rate."""
    loop = asyncio.get_running_loop()
    period = SERVE_RPC / rate
    n = max(1, int(seconds / period))
    lat = []

    async def one(i, at):
        await serve(rpcs[i % len(rpcs)])
        lat.append((loop.time() - at) * 1e3)

    t0 = loop.time()
    tasks = []
    for i in range(n):
        at = t0 + i * period
        delay = at - loop.time()
        if delay > 0:
            await asyncio.sleep(delay)
        tasks.append(asyncio.ensure_future(one(i, at)))
    await asyncio.gather(*tasks)
    return lat, n * SERVE_RPC / (loop.time() - t0)


def busy_share(prof, wall_s):
    """The card's busy share of a profiled wall time: every kernel, copy
    and fill it ran (torch.profiler), over the wall; None when the trace
    shows no device time."""
    from torch.autograd import DeviceType
    busy_us = sum(e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA)
    return busy_us / (wall_s * 1e6) if busy_us else None


def pipeline_counters(pipe):
    snap = pipe.overlap_snapshot()
    wall = snap["active_wall_seconds"]
    return dict(drains=pipe.drains, windows=pipe.windows_staged,
                decisions=pipe.decisions_staged, lanes=pipe.lanes_staged,
                gate_holds=snap["gate_holds"],
                chain_flushes=snap["chain_flushes"],
                fetch_elided=snap["fetch_elided"], active_s=wall,
                depth_s=snap["mean_inflight"] * wall,
                busy=dict(snap["stage_busy_seconds"]))


COUNTERS = ("drains", "windows", "decisions", "lanes", "gate_holds",
            "chain_flushes", "fetch_elided", "active_s", "depth_s")


def counter_delta(a, b):
    """The counters' change from a to b, with the mean number of drains in
    flight while any was (mean_inflight) over that span."""
    out = {k: b[k] - a[k] for k in COUNTERS}
    out["busy"] = {k: b["busy"][k] - a["busy"][k] for k in a["busy"]}
    out["mean_inflight"] = (out["depth_s"] / out["active_s"]
                            if out["active_s"] > 0 else 0.0)
    return out


def phase_serving_pipeline(window_rng_seed=11):
    """Phase 8, the counted part: the pipelined serving lane on an
    Instance at full width.  A drain's engine-thread path under sync debug
    mode; 64 clients at saturation (unprofiled, then profiled for the
    card's idle share); open-loop offered rates at 25, 50 and 100% of the
    saturating rate; phase 4's 1000-request window through engine.process
    on the router; the saturating load again with the occupancy gate off,
    and with the gate off and two drains a fetch (the deferred-fetch
    chain); then three ~50k-decision bursts on a pinned clock, at depth 1,
    at depth 3, and at depth 3 with the gate off and the chain on (all
    five algorithms, NO_BATCHING), and a few configs past the compact caps
    last (they latch the full path).  Then the analytics Instance (phase
    6b's geometry) serves a compact burst.  Both Instances are built and
    warmed before the counts start.  The caller reads the counts when it
    returns and compares afterwards."""
    rng = np.random.default_rng(83)
    inst = Instance(engine_config=serving_engine_config())
    eng, pipe = inst.engine, inst.batcher.pipeline
    check(eng.native is not None and pipe is not None and pipe.enabled,
          "the router or the pipelined lane is missing")
    check(eng.device.type == DEV.type, f"engine on {eng.device}")
    eng.warmup()
    an_inst = Instance(engine_config=serving_engine_config(),
                       analytics=AnalyticsConfig(enabled=True, **ANALYTICS))
    an_pipe = an_inst.batcher.pipeline
    check(an_pipe is not None and an_pipe.analytics is an_inst.analytics,
          "the analytics Instance has no pipelined lane with analytics")
    an_inst.engine.warmup()
    torch.cuda.synchronize()
    sat_rpcs = serving_rpcs(rng, 512 * SERVE_RPC, "s", compact_only=True)
    serve = inst.get_rate_limits
    bursts = [serving_rpcs(rng, SERVE_DECISIONS, "b") for _ in range(3)]
    an_rpcs = serving_rpcs(rng, SERVE_DECISIONS, "a", compact_only=True)
    tail = [RateLimitReq(name="t0", unique_key=f"oor{i}", hits=1 + i,
                         limit=2**40 + i, duration=2**35)
            for i in range(5)]
    p4_rng = np.random.default_rng(window_rng_seed)
    window = [RateLimitReq(name="smoke",
                           unique_key=f"k{int(p4_rng.zipf(1.3)) % 400}",
                           hits=int(p4_rng.integers(0, 3)), limit=20,
                           duration=60_000,
                           algorithm=int(p4_rng.integers(0, 5)))
              for _ in range(1000)]
    tb = millisecond_now()
    out = dict(bursts=bursts, tail=tail, tb=tb)
    reset_counts()

    def window_walls():
        walls = []
        for i in range(10):
            w0 = time.perf_counter()
            eng.process(window, now=tb + i)
            walls.append((time.perf_counter() - w0) * 1e3)
        return float(np.median(walls))

    async def script():
        loop = asyncio.get_running_loop()
        ex = inst.batcher._executor
        pin_clock(inst, None)
        # warm the lane (its arenas and pinned buffers exist afterwards)
        await saturate(serve, sat_rpcs, 0.5)
        sync_reqs = [serving_request(i, "y", 1, compact_only=True)
                     for i in range(SERVE_ITEMS_MAX)]
        out["sync"] = await loop.run_in_executor(ex, sync_checked_drain,
                                                 inst, sync_reqs, tb)
        c0 = pipeline_counters(pipe)
        n, wall = await saturate(serve, sat_rpcs, SERVE_SECONDS)
        out["sat"] = (n, wall, counter_delta(c0, pipeline_counters(pipe)))
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            n2, wall2 = await saturate(serve, sat_rpcs,
                                        SERVE_SECONDS)
            torch.cuda.synchronize()
        out["sat_prof"] = (n2, wall2, busy_share(prof, wall2))
        rate = n / wall
        out["rates"] = []
        for share in RATE_SHARES:
            lat, achieved = await offered_rate(serve, sat_rpcs, share * rate,
                                               RATE_SECONDS)
            out["rates"].append((share, share * rate, achieved,
                                 float(np.percentile(lat, 50)),
                                 float(np.percentile(lat, 99))))
        out["window_ms"] = await loop.run_in_executor(ex, window_walls)
        out["variants"] = {}
        for name, stride in (("gate_off", 1), ("gate_off_stride2", 2)):
            pipe.gate_enabled, pipe.fetch_stride = False, stride
            c = pipeline_counters(pipe)
            nv, wallv = await saturate(serve, sat_rpcs, SERVE_SECONDS)
            out["variants"][name] = (nv, wallv, counter_delta(
                c, pipeline_counters(pipe)))
        pipe.gate_enabled, pipe.fetch_stride = True, 1
        pin_clock(inst, tb)
        pipe.depth = 1
        c1 = pipeline_counters(pipe)
        out["burst1"] = await serve_all(inst, bursts[0])
        pipe.depth = 3
        out["burst3"] = await serve_all(inst, bursts[1])
        pipe.gate_enabled, pipe.fetch_stride = False, 2
        c2 = pipeline_counters(pipe)
        out["burst3c"] = await serve_all(inst, bursts[2])
        out["chain_counts"] = counter_delta(c2, pipeline_counters(pipe))
        pipe.gate_enabled, pipe.fetch_stride = True, 1
        out["burst_counts"] = counter_delta(c1, pipeline_counters(pipe))
        out["tail_resp"] = await inst.get_rate_limits(tail)

    try:
        asyncio.run(script())
    finally:
        inst.close()
    check(not eng._compact_enabled, "the configs past the caps did not "
          "latch the full path")
    out["eng"] = eng
    out["pipe_drains"] = pipe.drains
    out["sheds"] = dict(inst.qos.admission.shed_counts)
    out["an"] = phase_serving_analytics(an_inst, an_rpcs, tb)
    return out


def staging_paths(eng, seed=89, n=20):
    """Phase 8, after the counts are read: a K = 8 drain stack of the
    serving engine's shape crossing to the card the two ways the engine
    takes host arrays, timed: a pinned tensor (the pipeline's arena: one
    non-blocking copy_ into the engine's device buffer) and a numpy array
    (copied into one of the engine's two pinned staging buffers first).
    Returns {path: (host ms a call, card ms a call)}: the host wall of
    issuing pipeline_dispatch, and the CUDA-event time of n calls."""
    rng = np.random.default_rng(seed)
    C = eng.capacity_per_shard
    stack = np.stack([full_size_traffic(rng, FULL_K, FULL_LANES, C)
                      for _ in range(SHARDS)], axis=1)
    pinned = torch.from_numpy(stack).pin_memory()
    nows = torch.full((FULL_K,), T0, dtype=torch.int64).pin_memory()
    out = {}
    for name, packed, nw in (("pinned", pinned, nows),
                             ("numpy", stack, nows.numpy())):
        call = lambda: eng.pipeline_dispatch(packed, nw)  # noqa: E731
        call()
        torch.cuda.synchronize()
        walls = []
        for _ in range(n):
            w0 = time.perf_counter()
            call()
            walls.append((time.perf_counter() - w0) * 1e3)
        torch.cuda.synchronize()
        out[name] = (float(np.median(walls)), cuda_ms(call, n))
    return out


def phase_serving_analytics(inst, rpcs, tb):
    """Phase 8d: the Instance with analytics at the JAX defaults (phase
    6b's geometry, built and warmed before the counts start) serves a
    compact ~50k-decision burst on a pinned clock at depth 3, and one drain
    under sync debug mode: every drain runs the stats drain and the
    finisher, and TrafficAnalytics ingests it.  Returns the pipeline's
    drain and decision counts beside the answers."""
    pipe = inst.batcher.pipeline
    pin_clock(inst, tb)

    async def script():
        loop = asyncio.get_running_loop()
        got = await serve_all(inst, rpcs)
        sync_reqs = [serving_request(i, "z", 1, compact_only=True)
                     for i in range(SERVE_ITEMS_MAX)]
        await loop.run_in_executor(inst.batcher._executor,
                                   sync_checked_drain, inst, sync_reqs, tb)
        return got

    try:
        got = asyncio.run(script())
    finally:
        inst.close()
    return dict(inst=inst, rpcs=rpcs, got=got,
                snapshot=inst.analytics.snapshot(), drains=pipe.drains,
                decisions=pipe.decisions_staged)


def keyed_state(eng):
    """An engine's arena keyed by key instead of by slot: per shard, the
    router's key fingerprints (sorted), each key's expiry, every [S, C]
    plane's rows at the keys' slots in that order and at the slots no key
    holds (in slot order); then the [G] planes as they are."""
    arena = eng.export_arena()
    per_slot = sorted(n for n, p in arena.items() if p.ndim == 2)
    out = []
    for s in range(eng.num_shards):
        fp, slot, expire = eng.native.export_keys(s)
        order = np.argsort(fp)
        held = np.zeros(arena[per_slot[0]].shape[1], bool)
        held[slot] = True
        out.append([fp[order], expire[order]]
                   + [arena[n][s, slot[order]] for n in per_slot]
                   + [arena[n][s, ~held] for n in per_slot])
    out.append([arena[n] for n in sorted(arena) if arena[n].ndim == 1])
    return out


def small_twins(rpcs, tb):
    """The small Instance on the card and on the CPU (router both, depth
    3, the pinned clock tb), the RPCs one after another: (responses,
    arenas, keyed states), card first."""
    outs, arenas, keyed = [], [], []
    for dev in (DEV, torch.device("cpu")):
        inst = Instance(engine_config=EngineConfig(**SMALL_TWIN,
                                                   use_native="on"),
                        device=dev)
        pin_clock(inst, tb)
        inst.batcher.pipeline.depth = 3

        async def serial():
            return [await inst.get_rate_limits(rpc) for rpc in rpcs]

        try:
            outs.append([q for rpc in asyncio.run(serial()) for q in rpc])
        finally:
            inst.close()
        arenas.append(inst.engine.export_arena())
        keyed.append(keyed_state(inst.engine))
    return outs, arenas, keyed


def check_serving(r):
    """Phase 8, after the counts are read: every burst response against a
    Python-table engine on the card running process() over the same
    stream in submission order; the sync-checked drain's answers; the
    analytics totals and top-K; then a small Instance on the card against
    the same Instance on the CPU (router both), responses and state.

    Which slot a new key takes follows the order in which keys are first
    seen on the engine thread, and with serving's mix that order depends
    on timing twice: a NO_BATCHING request jumps the window, and a drain
    job holding a request the stack refuses (GCRA, sliding window,
    concurrency) takes the full path when it opens the stack and waits
    for the next drain otherwise, so which items share a drain (the QoS
    window's cut, read from the drain's wall) decides the order.  With
    that mix the twins are held to equal responses and equal state key by
    key (keyed_state: every plane's row of every key, its expiry, the
    slots no key holds, the [G] planes); with token and leaky requests
    only, BATCHING, every key takes its slot in submission order on one
    path, and the arenas are held equal plane for plane."""
    tb = r["tb"]
    twin = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                           num_shards=SHARDS, batch_per_shard=FULL_LANES)
    check(twin.native is None, "the twin engine has the router")
    flat = lambda rpcs: [q for rpc in rpcs for q in rpc]  # noqa: E731
    tup = lambda rs: [(r.status, r.limit, r.remaining, r.reset_time,  # noqa: E731
                       r.error) for r in rs]
    for name, rpcs in (("burst1", r["bursts"][0]),
                       ("burst3", r["bursts"][1]),
                       ("burst3c", r["bursts"][2]),
                       ("tail_resp", [r["tail"]])):
        got = flat(r[name]) if name != "tail_resp" else r[name]
        want = twin.process(flat(rpcs), now=tb)
        check(tup(got) == tup(want),
              f"{name}: the pipelined Instance differs from the Python-table "
              f"engine")
    check(all(x.status in (0, 1) and x.limit >= 20 for x in r["sync"]),
          "the sync-checked drain's answers")
    del twin
    an = r["an"]
    snap = an["snapshot"]
    items = flat(an["rpcs"])
    check(snap["totals"]["hits"] == sum(q.hits for q in items),
          f"analytics hits {snap['totals']['hits']} != the burst's "
          f"{sum(q.hits for q in items)}")
    per_key = {}
    for q in items:
        per_key[q.hash_key()] = per_key.get(q.hash_key(), 0) + q.hits
    hot = sorted(per_key, key=per_key.get, reverse=True)[:3]
    top = [row["key"] for row in snap["topk"][:10]]
    check(all(k in top for k in hot),
          f"the burst's hottest keys {hot} are not in the top-K {top}")
    # the CPU twin at the port tests' geometry: ~640 keys over 2048 slots
    # (no eviction), RPCs one after another, depth 3: serving's mix, then
    # the same keys as token and leaky requests only
    outs, arenas, keyed = small_twins(
        serving_rpcs(np.random.default_rng(97), 3_000, "c", keys=640), tb)
    check(tup(outs[0]) == tup(outs[1]), "the card's small Instance differs "
          "from the CPU twin")
    for s, (a, b) in enumerate(zip(*keyed)):
        check(len(a) == len(b) and all(np.array_equal(x, y)
                                       for x, y in zip(a, b)),
              f"shard {s} of the small Instance's state differs from the "
              f"CPU twin's, key by key")
    same_slots = all(np.array_equal(arenas[0][n], p)
                     for n, p in arenas[1].items())
    c_outs, c_arenas, _ = small_twins(
        serving_rpcs(np.random.default_rng(97), 3_000, "p", keys=640,
                     compact_only=True), tb)
    check(tup(c_outs[0]) == tup(c_outs[1]), "the card's small Instance "
          "differs from the CPU twin on token and leaky requests")
    for name, plane in c_arenas[1].items():
        check(np.array_equal(c_arenas[0][name], plane),
              f"plane {name} of the small Instance differs from the CPU "
              f"twin's on token and leaky requests")
    return dict(hot=hot, top=top[:5], small=len(outs[0]),
                small_same_slots=same_slots,
                staging=staging_paths(r["eng"]))


def report_serving(r, chk, counts, p4_ms, smi):
    n, wall, d = r["sat"]
    n2, wall2, share = r["sat_prof"]
    b = r["burst_counts"]
    rates = "; ".join(
        f"{int(s * 100)}% ({off:.0f}/s offered, {ach:.0f}/s achieved): "
        f"p50 {p50:.3f} ms p99 {p99:.3f} ms"
        for s, off, ach, p50, p99 in r["rates"])
    busy = ", ".join(f"{k} {v:.4f} s" for k, v in d["busy"].items())
    variants = {}
    for name, (nv, wallv, dv) in r["variants"].items():
        variants[name] = dict(
            decisions_per_s=nv / wallv, drains=dv["drains"],
            mean_k_used=dv["windows"] / max(1, dv["drains"]),
            mean_inflight=dv["mean_inflight"], gate_holds=dv["gate_holds"],
            chain_flushes=dv["chain_flushes"],
            fetch_elided=dv["fetch_elided"], stage_busy_s=dv["busy"])
    cc = r["chain_counts"]
    fig = dict(
        decisions_per_s=n / wall,
        decisions_per_s_profiled=n2 / wall2,
        idle_share=None if share is None else 1 - share,
        latency_ms={f"{int(s * 100)}%": dict(offered=off, achieved=ach,
                                             p50=p50, p99=p99)
                    for s, off, ach, p50, p99 in r["rates"]},
        drains=d["drains"], mean_k_used=d["windows"] / max(1, d["drains"]),
        fold=d["decisions"] / max(1, d["lanes"]),
        mean_inflight=d["mean_inflight"], gate_holds=d["gate_holds"],
        stage_busy_s=d["busy"], window_ms_router=r["window_ms"],
        window_ms_tables=p4_ms, saturated=variants,
        chained_burst=dict(drains=cc["drains"],
                           chain_flushes=cc["chain_flushes"],
                           fetch_elided=cc["fetch_elided"],
                           mean_inflight=cc["mean_inflight"]),
        qos_sheds=r["sheds"])
    var = "; ".join(
        f"{k}: {v['decisions_per_s']:.1f} decisions/s, {v['drains']} drains, "
        f"mean k_used {v['mean_k_used']:.3f}, mean in flight "
        f"{v['mean_inflight']:.3f}, {v['fetch_elided']} fetches elided"
        for k, v in variants.items())
    log(f"phase 8 pipelined serving ({SHARDS} x {FULL_CAPACITY // SHARDS} "
        f"slots, router + pipeline, {SERVE_CLIENTS} clients x "
        f"{SERVE_RPC}-item RPCs, compact token/leaky over {SERVE_KEYS} Zipf "
        f"keys): {n} decisions in {wall:.3f} s = {n / wall:.1f} decisions/s "
        f"({n2 / wall2:.1f}/s under the profiler, card idle share "
        f"{fig['idle_share']}); {d['drains']} drains, mean k_used "
        f"{fig['mean_k_used']:.3f}, fold {fig['fold']:.3f}, mean in flight "
        f"{fig['mean_inflight']:.3f}, gate holds {fig['gate_holds']}; stage "
        f"busy {busy}; saturated again {var}; offered rates: {rates}; "
        f"1000-request window through "
        f"engine.process {r['window_ms']:.3f} ms on the router, "
        f"{p4_ms:.3f} ms on the Python tables (phase 4); bursts at depth 1, "
        f"3, and 3 with the gate off and two drains a fetch: {b['drains']} "
        f"drains ({cc['drains']} in the last, {cc['chain_flushes']} chain "
        f"fetches), {b['decisions']} decisions on {b['lanes']} lanes, every "
        f"response = the Python-table engine; "
        f"sync debug mode: no host sync on the drain's dispatch path; "
        f"analytics from requests ({r['an']['drains']} drains, "
        f"{r['an']['decisions']} decisions): hottest keys {chk['hot']} in "
        f"the top-K "
        f"{chk['top']}; small Instance ({chk['small']} decisions) = the CPU "
        f"twin, its state key by key (same slots: "
        f"{chk['small_same_slots']}), and on token and leaky requests "
        f"plane for plane; launches {counts}; {smi}")
    fig["staging_ms"] = {k: dict(host=h, card=c)
                         for k, (h, c) in chk["staging"].items()}
    log("serving figures: " + json.dumps(dict(card=smi, **fig)))


# ---------------------------------------------------------------- the wire

# phase 9: the raw-bytes RPC lane (server.py serve_get_rate_limits: C
# parse -> the pipeline's K-window stack -> one drain_compact launch -> a
# CUDA event -> C encode) on phase 8's geometry.  This machine has no
# protobuf, so the script encodes requests and decodes responses itself:
# varint and length-delimited fields only, zero fields omitted, field
# numbers from gubernator_tpu_torch/api/proto/gubernator.proto
# (tests/test_torch_server.py holds this codec against gubernator_pb2).
REQ_FIELDS = (("name", 1, "s"), ("unique_key", 2, "s"), ("hits", 3, "i"),
              ("limit", 4, "i"), ("duration", 5, "i"),
              ("algorithm", 6, "i"), ("behavior", 7, "i"))
RESP_FIELDS = (("status", 1, "i"), ("limit", 2, "i"), ("remaining", 3, "i"),
               ("reset_time", 4, "i"), ("error", 5, "s"),
               ("metadata", 6, "m"))
U64 = (1 << 64) - 1


def _varint(v):
    v &= U64  # negatives as 64-bit two's complement (ten bytes)
    out = bytearray()
    while v > 0x7F:
        out.append(v & 0x7F | 0x80)
        v >>= 7
    out.append(v)
    return bytes(out)


def _delimited(num, b):
    return _varint(num << 3 | 2) + _varint(len(b)) + b


def encode_msg(values, fields):
    """One message from a dict of field values (proto3: zero values and
    empty strings omitted; a map's entries in key order, each with its key
    and value fields written even when empty, as protobuf writes them)."""
    out = bytearray()
    for name, num, kind in fields:
        v = values.get(name)
        if not v:
            continue
        if kind == "i":
            out += _varint(num << 3) + _varint(int(v))
        elif kind == "s":
            out += _delimited(num, v.encode("utf-8"))
        else:
            for k in sorted(v):
                entry = (_delimited(1, k.encode("utf-8"))
                         + _delimited(2, v[k].encode("utf-8")))
                out += _delimited(num, entry)
    return bytes(out)


def encode_list(items, fields):
    """A GetRateLimitsReq / GetRateLimitsResp: repeated field 1."""
    return b"".join(_delimited(1, encode_msg(v, fields)) for v in items)


def _read_varint(buf, i):
    v = shift = 0
    while True:
        b = buf[i]
        i += 1
        v |= (b & 0x7F) << shift
        if b < 0x80:
            return v, i
        shift += 7


def _wire_fields(buf):
    i = 0
    while i < len(buf):
        key, i = _read_varint(buf, i)
        if key & 7 == 0:
            v, i = _read_varint(buf, i)
        elif key & 7 == 2:
            n, i = _read_varint(buf, i)
            v, i = bytes(buf[i:i + n]), i + n
        else:
            raise ValueError(f"wire type {key & 7}")
        yield key >> 3, v


def decode_msg(buf, fields):
    """One message's fields as a dict, every field present (proto3
    defaults); unknown fields skipped."""
    by_num = {num: (name, kind) for name, num, kind in fields}
    out = {name: ({} if kind == "m" else "" if kind == "s" else 0)
           for name, _, kind in fields}
    for num, v in _wire_fields(buf):
        if num not in by_num:
            continue
        name, kind = by_num[num]
        if kind == "i":
            out[name] = v - (1 << 64) if v >> 63 else v
        elif kind == "s":
            out[name] = v.decode("utf-8")
        else:
            e = decode_msg(v, (("key", 1, "s"), ("value", 2, "s")))
            out[name][e["key"]] = e["value"]
    return out


def decode_list(buf, fields):
    return [decode_msg(v, fields) for num, v in _wire_fields(buf)
            if num == 1]


class WireContext:
    """The least a serve_* body needs of its transport: a deadline (none)
    and an abort that raises."""

    def time_remaining(self):
        return None

    async def abort(self, code, details):
        raise AssertionError(f"serve_get_rate_limits aborted: {details}")


def wire_request(idx, prefix, hits, compact_only=True):
    """Key idx's request: always token or leaky by parity, in the compact
    range, its key zero-padded so a 100-item RPC is about 3.2 KB."""
    return RateLimitReq(name=f"t{idx % 80}", unique_key=f"{prefix}{idx:07d}",
                        hits=hits, limit=20 + idx % 50, duration=60_000,
                        algorithm=int(idx & 1))


def wire_rpcs(rng, n):
    """serving_rpcs of wire_request keys: (requests per RPC, serialized
    GetRateLimitsReq per RPC)."""
    rpcs = serving_rpcs(rng, n, "wire", request=wire_request)
    return rpcs, [encode_list([vars(r) for r in rpc], REQ_FIELDS)
                  for rpc in rpcs]


async def wire_burst(serve, datas):
    """SERVE_CLIENTS concurrent callers, caller c sending datas[c],
    datas[c + SERVE_CLIENTS], ... back to back; the response bytes by
    index."""
    outs = [None] * len(datas)

    async def caller(c):
        for i in range(c, len(datas), SERVE_CLIENTS):
            outs[i] = await serve(datas[i])

    await asyncio.gather(*(caller(c) for c in range(SERVE_CLIENTS)))
    return outs


class StagingLog:
    """Wraps the router's RPC parse on one Instance: the RPCs it staged,
    in staging order (the order the drains apply them), and the host time
    the parse and the response encode took.  Engine and fetch threads
    call it; remove() puts the router's own methods back."""

    def __init__(self, nat):
        import threading
        self.nat, self.lock = nat, threading.Lock()
        self.order, self.parse_s, self.encode_s = [], 0.0, 0.0
        parse, encode = nat.parse_stack_fast, nat.fastpath_encode_w

        def logged_parse(data, *a, **kw):
            t0 = time.perf_counter()
            n = parse(data, *a, **kw)
            dt = time.perf_counter() - t0
            with self.lock:
                self.parse_s += dt
                if n >= 0:
                    self.order.append(data)
            return n

        def timed_encode(*a, **kw):
            t0 = time.perf_counter()
            m = encode(*a, **kw)
            dt = time.perf_counter() - t0
            with self.lock:
                self.encode_s += dt
            return m

        nat.parse_stack_fast = logged_parse
        nat.fastpath_encode_w = timed_encode

    def remove(self):
        del self.nat.parse_stack_fast
        del self.nat.fastpath_encode_w


def rpc_counters(pipe):
    return dict(staged=pipe.rpc_staged, leftover=pipe.rpc_leftover,
                refused=pipe.rpc_refused, **pipeline_counters(pipe))


def rpc_delta(a, b):
    out = counter_delta(a, b)
    out.update({k: b[k] - a[k] for k in ("staged", "leftover", "refused")})
    return out


def phase_wire():
    """Phase 9, the counted part: the raw-bytes RPC lane on an Instance
    at phase 8's width (8 x 2^21 slots, B = 1024, the router and the
    pipeline at the JAX defaults), every RPC a serialized 100-item
    GetRateLimitsReq of about 3.2 KB through server.serve_get_rate_limits.
    Two ~50k-decision bursts from 64 concurrent callers on a pinned clock,
    at depth 1 and at depth 3 with the occupancy gate off, with the
    router's parse logged (the staging order the checks replay) and the
    arena exported after the first; then on the wall clock: 64 callers at
    saturation with the gate on, unprofiled and profiled (the card's idle
    share), open-loop rates at 25/50/100% of that, the same saturating
    load with the gate off (unprofiled and profiled), and a saturating run
    with the parse and the encode timed (the host's time per RPC).  The
    Instance is built and warmed before the counts start; the caller reads
    them when this returns and checks afterwards."""
    rng = np.random.default_rng(91)
    inst = Instance(engine_config=serving_engine_config())
    eng, pipe = inst.engine, inst.batcher.pipeline
    check(eng.native is not None and pipe is not None,
          "the router or the raw-RPC lane is missing")
    eng.warmup()
    torch.cuda.synchronize()
    bursts = [wire_rpcs(rng, SERVE_DECISIONS) for _ in range(2)]
    sat_rpcs, sat = wire_rpcs(rng, 512 * SERVE_RPC)
    sizes = [len(d) for b in bursts for d in b[1]] + [len(d) for d in sat]
    check(min(sizes) >= FASTPATH_MIN_BYTES,
          f"an RPC of {min(sizes)} bytes would miss the lane "
          f"({FASTPATH_MIN_BYTES})")
    ctx = WireContext()
    calls = [0]

    async def serve(data):
        calls[0] += 1
        return await serve_get_rate_limits(inst, data, ctx)

    tb = millisecond_now()
    out = dict(bursts=bursts, tb=tb, bytes=(min(sizes), max(sizes),
                                            float(np.mean(sizes))))
    reset_counts()

    async def script():
        from torch.profiler import ProfilerActivity, profile
        loop = asyncio.get_running_loop()
        pin_clock(inst, tb)
        c0 = rpc_counters(pipe)
        slog = StagingLog(eng.native)
        try:
            pipe.depth = 1
            out["burst1"] = await wire_burst(serve, bursts[0][1])
            out["order1"] = list(slog.order)
            out["arena1"] = await loop.run_in_executor(
                inst.batcher._executor, eng.export_arena)
            del slog.order[:]
            pipe.depth, pipe.gate_enabled = 3, False
            out["burst3"] = await wire_burst(serve, bursts[1][1])
            out["order3"] = list(slog.order)
        finally:
            slog.remove()
            pipe.depth, pipe.gate_enabled = 3, True
        out["burst_counts"] = rpc_delta(c0, rpc_counters(pipe))
        pin_clock(inst, None)
        await saturate(serve, sat, 0.5)  # the lane warm on the wall clock
        out["runs"] = {}
        for gate in (True, False):
            pipe.gate_enabled = gate
            c = rpc_counters(pipe)
            n, wall = await saturate(serve, sat, SERVE_SECONDS)
            d = rpc_delta(c, rpc_counters(pipe))
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                n2, wall2 = await saturate(serve, sat, SERVE_SECONDS)
                torch.cuda.synchronize()
            out["runs"][gate] = (n, wall, d, n2 / wall2,
                                 busy_share(prof, wall2))
            if gate:
                rate = n / wall
                out["rates"] = []
                for share in RATE_SHARES:
                    lat, achieved = await offered_rate(
                        serve, sat, share * rate, RATE_SECONDS)
                    out["rates"].append((
                        share, share * rate, achieved,
                        float(np.percentile(lat, 50)),
                        float(np.percentile(lat, 99))))
        pipe.gate_enabled = True
        c = rpc_counters(pipe)
        slog = StagingLog(eng.native)
        try:
            n, wall = await saturate(serve, sat, RATE_SECONDS)
        finally:
            slog.remove()
        out["split"] = (n, wall, rpc_delta(c, rpc_counters(pipe)),
                        slog.parse_s, slog.encode_s)

    try:
        asyncio.run(script())
    finally:
        inst.close()
    out["eng"], out["calls"] = eng, calls[0]
    out["pipe"] = rpc_counters(pipe)
    # the bytes lane admits nothing item by item: the queue never fills,
    # so no RPC is sent to the protobuf path (which this machine lacks)
    out["adm"] = (inst.qos.admission.pending_peak,
                  inst.qos.admission.max_pending)
    return out


def arena_rows(arena):
    """Each shard's touched rows of the regular arena as a sorted
    i64[n, 6] (limit, duration, remaining, tstamp, expire, algo): the
    per-key state whatever slot the key got."""
    names = ("limit", "duration", "remaining", "tstamp", "expire", "algo")
    planes = [np.asarray(arena[n], np.int64) for n in names]
    rows = []
    for s in range(planes[0].shape[0]):
        touched = (planes[3][s] != 0) | (planes[4][s] != 0)
        m = np.stack([p[s][touched] for p in planes], axis=1)
        rows.append(m[np.lexsort(m.T[::-1])])
    return rows


def check_wire(r):
    """Phase 9, after the counts are read: every burst RPC's response,
    decoded, field for field against a Python-table engine on the card
    running process() over the RPCs in the order the router staged them;
    the first burst's arena, shard by shard (each key's row, whatever its
    slot), against that engine's; every RPC staged once."""
    tb = r["tb"]
    twin = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                           num_shards=SHARDS, batch_per_shard=FULL_LANES)
    check(twin.native is None, "the twin engine has the router")
    keys = ("status", "limit", "remaining", "reset_time", "error")
    for b, (name, oname) in enumerate((("burst1", "order1"),
                                       ("burst3", "order3"))):
        rpcs, datas = r["bursts"][b]
        index = {id(d): i for i, d in enumerate(datas)}
        order = [index.get(id(d)) for d in r[oname]]
        check(sorted(i for i in order if i is not None)
              == list(range(len(datas))) and None not in order,
              f"{name}: the router staged {len(order)} RPCs, not each of "
              f"the {len(datas)} once")
        want = twin.process([q for i in order for q in rpcs[i]], now=tb)
        at = 0
        for i in order:
            got = [tuple(x[k] for k in keys) + (x["metadata"],)
                   for x in decode_list(r[name][i], RESP_FIELDS)]
            exp = [(int(w.status), w.limit, w.remaining, w.reset_time,
                    w.error, {}) for w in want[at:at + len(rpcs[i])]]
            check(got == exp, f"{name}: RPC {i}'s response differs from the "
                  f"Python-table engine")
            at += len(rpcs[i])
        if b == 0:
            for s, (a, t) in enumerate(zip(arena_rows(r["arena1"]),
                                           arena_rows(twin.export_arena()))):
                check(np.array_equal(a, t), f"burst1: shard {s}'s rows "
                      f"differ from the Python-table engine's")
    del twin


def report_wire(r, counts, serve, smi):
    """Phase 9's line and its figures line, beside phase 8's per-item
    path from the same run."""
    b = r["burst_counts"]
    runs = {}
    for gate, (n, wall, d, prof_rate, share) in r["runs"].items():
        runs["gate_on" if gate else "gate_off"] = dict(
            decisions_per_s=n / wall, decisions_per_s_profiled=prof_rate,
            idle_share=None if share is None else 1 - share,
            drains=d["drains"],
            mean_k_used=d["windows"] / max(1, d["drains"]),
            mean_inflight=d["mean_inflight"], gate_holds=d["gate_holds"],
            rpcs_staged=d["staged"], rpcs_left_over=d["leftover"])
    n, wall, d, parse_s, encode_s = r["split"]
    rpcs = max(1, d["staged"])
    busy = d["busy"]
    host_us = dict(
        c_parse=parse_s / rpcs * 1e6,
        pack_besides_parse=(busy["host_encode"] - parse_s) / rpcs * 1e6,
        dispatch=busy["device_dispatch"] / rpcs * 1e6,
        fetch_wait=(busy["fetch_decode"] - encode_s) / rpcs * 1e6,
        c_encode=encode_s / rpcs * 1e6)
    pn, pwall, pd = serve["sat"]
    p8 = dict(decisions_per_s=pn / pwall,
              idle_share=(None if serve["sat_prof"][2] is None
                          else 1 - serve["sat_prof"][2]),
              mean_inflight=pd["mean_inflight"],
              gate_off_decisions_per_s=(
                  serve["variants"]["gate_off"][0]
                  / serve["variants"]["gate_off"][1]))
    fig = dict(
        rpc_bytes=dict(zip(("min", "max", "mean"), r["bytes"])),
        saturated=runs,
        latency_ms={f"{int(s * 100)}%": dict(offered=off, achieved=ach,
                                             p50=p50, p99=p99)
                    for s, off, ach, p50, p99 in r["rates"]},
        host_us_per_rpc=host_us, host_split_decisions_per_s=n / wall,
        per_item_path_phase8=p8,
        rpcs=dict(calls=r["calls"], staged=r["pipe"]["staged"],
                  left_over=r["pipe"]["leftover"],
                  refused=r["pipe"]["refused"]))
    on, off = runs["gate_on"], runs["gate_off"]
    rates = "; ".join(
        f"{int(s * 100)}% ({ach:.0f}/s achieved): p50 {p50:.3f} ms p99 "
        f"{p99:.3f} ms" for s, off_, ach, p50, p99 in r["rates"])
    log(f"phase 9 raw-RPC lane ({SHARDS} x {FULL_CAPACITY // SHARDS} slots, "
        f"{SERVE_CLIENTS} callers x {SERVE_RPC}-item GetRateLimitsReq of "
        f"{r['bytes'][0]}-{r['bytes'][1]} bytes through "
        f"serve_get_rate_limits): gate on {on['decisions_per_s']:.1f} "
        f"decisions/s (idle share {on['idle_share']}, mean in flight "
        f"{on['mean_inflight']:.3f}), gate off "
        f"{off['decisions_per_s']:.1f} (idle share {off['idle_share']}, "
        f"mean in flight {off['mean_inflight']:.3f}); phase 8's per-item "
        f"path {p8['decisions_per_s']:.1f}; offered rates: {rates}; host "
        f"us per RPC: " + ", ".join(f"{k} {v:.1f}" for k, v in
                                    host_us.items())
        + f"; bursts at depth 1 and at depth 3 with the gate off: "
        f"{b['drains']} drains, {b['staged']} RPCs staged, {b['leftover']} "
        f"left over, every response = the Python-table engine, the first "
        f"burst's arena too; {r['calls']} RPCs served, {r['pipe']['staged']} "
        f"staged, {r['pipe']['refused']} refused; launches {counts}; {smi}")
    log("wire figures: " + json.dumps(dict(card=smi, **fig)))
    return dict(decisions_per_s=on["decisions_per_s"],
                host_us_per_rpc=host_us)


# ------------------------------------------------ phase 10: the lifecycle

LIFE_DECISIONS_A = 100_000
LIFE_DECISIONS_B = 50_000
LIFE_GLOBAL_A = 2_000
LIFE_GLOBAL_B = 1_000
LIFE_GLOBAL_RPC = 50        # GLOBAL items a get_rate_limits call
LIFE_GLOBAL_KEYS = 256
LAYOUTS = ("int64", "compact32")
# 10b: the warm tier on Python tables.  A hot arena of 8 x 2^9 slots: the
# traffic below touches ~26k keys in 200 windows, far below 8 x 2^15, so
# only an arena smaller than its live set makes the tier demote
TIER_CAPACITY = 1 << 9
TIER_TWIN_CAPACITY = 1 << 18
TIER_WARM_ROWS = 1 << 20
TIER_KEYS = 1 << 20
TIER_WINDOWS = 200
TIER_WINDOW_MAX = 1000


def global_calls(rng, n, prefix="glob"):
    """n GLOBAL decisions as get_rate_limits calls of LIFE_GLOBAL_RPC
    items: Zipf (a = 1.3) keys over LIFE_GLOBAL_KEYS, token or leaky by
    parity, in the compact ranges."""
    idx = (rng.zipf(1.3, n) - 1) % LIFE_GLOBAL_KEYS
    hits = rng.choice([0, 1, 1, 2], n)
    reqs = [RateLimitReq(name="g", unique_key=f"{prefix}{int(i)}",
                         hits=int(h), limit=40 + int(i) % 30,
                         duration=60_000, algorithm=int(i) & 1,
                         behavior=Behavior.GLOBAL)
            for i, h in zip(idx, hits)]
    return [reqs[i:i + LIFE_GLOBAL_RPC] for i in range(0, n, LIFE_GLOBAL_RPC)]


def lifecycle_load(rng, decisions, global_decisions):
    """A load as (kind, payload) steps: serialized 100-item RPCs (phase
    9's keys, the raw-bytes lane) with a GLOBAL call after every
    len(wire) / len(glob) of them."""
    _, wire = wire_rpcs(rng, decisions)
    glob = global_calls(rng, global_decisions)
    every = max(1, len(wire) // len(glob))
    steps = []
    for i, data in enumerate(wire):
        steps.append(("wire", data))
        if i % every == every - 1 and glob:
            steps.append(("glob", glob.pop(0)))
    steps += [("glob", g) for g in glob]
    return steps


async def serve_step(inst, ctx, kind, payload):
    """One step's responses as tuples: a wire RPC decoded, a GLOBAL call's
    responses."""
    if kind == "wire":
        out = await serve_get_rate_limits(inst, payload, ctx)
        return [(x["status"], x["limit"], x["remaining"], x["reset_time"],
                 x["error"]) for x in decode_list(out, RESP_FIELDS)]
    return [(int(r.status), r.limit, r.remaining, r.reset_time, r.error)
            for r in await inst.get_rate_limits(payload)]


async def serve_in_order(inst, ctx, steps, t0):
    """Every step to its end before the next, step i at the pinned clock
    t0 + i: one order, whatever the instance."""
    out = []
    for i, (kind, payload) in enumerate(steps):
        pin_clock(inst, t0 + i)
        out.append(await serve_step(inst, ctx, kind, payload))
    return out


async def on_engine_thread(inst, fn):
    """fn on the Instance's engine thread (its quiesce point): (result,
    seconds it held the thread, seconds the caller waited)."""
    held = [0.0]

    def run():
        t = time.perf_counter()
        try:
            return fn()
        finally:
            held[0] = time.perf_counter() - t

    t0 = time.perf_counter()
    out = await inst._quiesced(run)
    return out, held[0], time.perf_counter() - t0


def lifecycle_instance():
    inst = Instance(engine_config=serving_engine_config())
    check(inst.engine.native is not None and inst.batcher.pipeline,
          "the router or the pipeline is missing")
    inst.engine.warmup()
    return inst


def same_state(a, b, what):
    """Two engines' arenas plane for plane and shard by shard on the card,
    and their key tables (the router's per shard, the GLOBAL table)."""
    for name, pa, pb in zip(tk.BucketState._fields, a.state, b.state):
        for s in range(SHARDS):
            check(torch.equal(pa[s], pb[s]), f"{what}: {name} shard {s}")
    for name, pa, pb in zip(tk.BucketState._fields + tk.GlobalConfig._fields,
                            (*a.gstate, *a.gcfg), (*b.gstate, *b.gcfg)):
        check(torch.equal(pa, pb), f"{what}: GLOBAL {name}")
    for s in range(SHARDS):
        for x, y in zip(a.native.export_keys(s), b.native.export_keys(s)):
            check(np.array_equal(x, y), f"{what}: router shard {s}")
    check(a.gtable.export_entries() == b.gtable.export_entries(),
          f"{what}: GLOBAL table")


def restored_as_exported(eng, snap, what):
    """A restored engine holds the snapshot: each plane shard by shard on
    the card against the snapshot's host planes, the router's tables per
    shard and the GLOBAL table."""
    for name, plane in zip(tk.BucketState._fields, eng.state):
        for s in range(SHARDS):
            want = torch.from_numpy(snap.planes[name][s]).to(DEV)
            check(torch.equal(plane[s], want), f"{what}: {name} shard {s}")
    for name, plane in zip(tk.BucketState._fields, eng.gstate):
        check(torch.equal(plane, torch.from_numpy(snap.gplanes[name]).to(DEV)),
              f"{what}: gstate {name}")
    for name, plane in zip(tk.GlobalConfig._fields, eng.gcfg):
        check(torch.equal(plane, torch.from_numpy(snap.gcfg[name]).to(DEV)),
              f"{what}: gcfg {name}")
    for s in range(SHARDS):
        for x, y in zip(eng.native.export_keys(s), snap.native_tables[s]):
            check(np.array_equal(x, y), f"{what}: router shard {s}")
    keys, slots, exps = snap.gtable
    check(eng.gtable.export_entries() == list(zip(keys, slots.tolist(),
                                                   exps.tolist())),
          f"{what}: GLOBAL table")


def phase_lifecycle_snapshots(tmp):
    """Phase 10a, counted: load A (~100k decisions on the raw-bytes lane
    from 64 callers, ~2k GLOBAL through get_rate_limits) on an Instance at
    phase 8's geometry; save in each layout into `tmp` (the export on the
    engine thread, dumps, the atomic write with fsync), each timed; load
    and import each file into a fresh Instance (built and warmed before
    the counts start, like the cold one), each timed, and the restored
    state held against the export on the card; then load B (~50k
    decisions, GLOBAL items in it) on the original and on both restored
    Instances, one step at a time at the same pinned clocks; last, a file
    with one payload byte flipped gives a cold Instance that serves."""
    rng = np.random.default_rng(101)
    orig, r64, r32, cold = (lifecycle_instance() for _ in range(4))
    load_a = lifecycle_load(rng, LIFE_DECISIONS_A, LIFE_GLOBAL_A)
    load_b = lifecycle_load(rng, LIFE_DECISIONS_B, LIFE_GLOBAL_B)
    cold_rpc = encode_list([vars(wire_request(i, "cold", 1))
                            for i in range(SERVE_RPC)], REQ_FIELDS)
    ctx = WireContext()
    tb = millisecond_now()
    out = dict(layouts={}, decisions_a=LIFE_DECISIONS_A + LIFE_GLOBAL_A,
               decisions_b=LIFE_DECISIONS_B + LIFE_GLOBAL_B)
    reset_counts()

    async def script():
        pin_clock(orig, tb)
        wire = [p for k, p in load_a if k == "wire"]
        glob = [p for k, p in load_a if k == "glob"]
        await wire_burst(lambda d: serve_get_rate_limits(orig, d, ctx), wire)
        for g in glob:
            await orig.get_rate_limits(g)
        snaps = {}
        for layout in LAYOUTS:
            row = out["layouts"][layout] = {}
            snap, held, wait = await on_engine_thread(
                orig, lambda: orig.engine.export_state(layout=layout))
            row.update(export_ms=wait * 1e3, engine_thread_ms=held * 1e3)
            t = time.perf_counter()
            blob = snapmod.dumps(snap)
            row["dumps_ms"] = (time.perf_counter() - t) * 1e3
            path = os.path.join(tmp, f"arena-{layout}.snap")
            t = time.perf_counter()
            row["bytes"] = snapmod.write_bytes(blob, path)
            row["write_fsync_ms"] = (time.perf_counter() - t) * 1e3
            snaps[layout] = (snap, path)
            del blob
        for layout, inst in zip(LAYOUTS, (r64, r32)):
            row = out["layouts"][layout]
            snap, path = snaps[layout]
            t = time.perf_counter()
            loaded = snapmod.load(path)
            row["load_ms"] = (time.perf_counter() - t) * 1e3
            check(loaded.layout == layout, f"{layout}: the file holds "
                  f"{loaded.layout}")
            if layout == "int64":
                os.remove(path)  # the compact32 file serves the flip
            _, held, wait = await on_engine_thread(
                inst, lambda: inst.restore_snapshot(loaded))
            row.update(import_ms=wait * 1e3, import_thread_ms=held * 1e3,
                       keys=loaded.total_keys())
            restored_as_exported(inst.engine, snap, f"restored {layout}")
        out["global_keys"] = len(snaps["int64"][0].gtable[0])
        del snaps
        for name, inst in (("orig", orig), ("int64", r64),
                           ("compact32", r32)):
            t = time.perf_counter()
            out[f"b_{name}"] = await serve_in_order(inst, ctx, load_b,
                                                    tb + 1_000)
            out[f"b_{name}_s"] = time.perf_counter() - t
        # one flipped payload byte: a cold start that serves
        good = open(os.path.join(tmp, "arena-compact32.snap"), "rb").read()
        bad = bytearray(good)
        bad[len(snapmod.MAGIC) + 8 + len(good) // 2] ^= 0x01
        bad_path = os.path.join(tmp, "arena-bad.snap")
        snapmod.write_bytes(bytes(bad), bad_path)
        del good, bad
        got, _, _ = await on_engine_thread(
            cold, lambda: snapmod.restore_engine(cold.engine, bad_path))
        out["corrupt_restored"] = got
        out["cold_size"] = cold.engine.cache_size
        out["cold_live"] = int(torch.count_nonzero(cold.engine.state.expire))
        pin_clock(cold, tb + 5_000)
        out["cold_resp"] = decode_list(await serve_get_rate_limits(
            cold, cold_rpc, ctx), RESP_FIELDS)

    try:
        asyncio.run(script())
        same_state(orig.engine, r64.engine, "after load B: int64 restore")
        same_state(orig.engine, r32.engine, "after load B: compact32 restore")
    finally:
        for inst in (orig, r64, r32, cold):
            inst.close()
    out["pipe_drains"] = sum(i.batcher.pipeline.drains
                             for i in (orig, r64, r32, cold))
    del orig, r64, r32, cold
    torch.cuda.empty_cache()
    return out


def tier_stream(seed):
    """tests/test_tiers.py's law at phase size: Zipf (s = 1.2) keys over
    2^20, token or leaky and a duration by key, hits 1 or 2, windows of up
    to 1000 requests 1-60 ms apart."""
    rng = np.random.default_rng(seed)
    durations = (500, 2_000, 10_000)
    now = T0
    for _ in range(TIER_WINDOWS):
        now += int(rng.integers(1, 60))
        ks = (rng.zipf(1.2, int(rng.integers(1, TIER_WINDOW_MAX + 1)))
              % TIER_KEYS).tolist()
        yield now, [RateLimitReq(
            name="r", unique_key=f"big:{k}", hits=1 + k % 2, limit=5 + k % 7,
            duration=durations[k % 3],
            algorithm=Algorithm.TOKEN_BUCKET if k % 3 else
            Algorithm.LEAKY_BUCKET) for k in ks]


def phase_tiers():
    """Phase 10b: the warm tier on the card.  A Python-table engine of
    [8, 2^9] hot slots with a warm store of 2^20 rows, in each layout,
    against a [8, 2^18] twin without tiers (it never evicts) over the same
    200 windows through process(), every response bit for bit; each
    fence's wall time, and the drain launches of the tiered engines."""
    stream = list(tier_stream(211))
    twin = RateLimitEngine(capacity_per_shard=TIER_TWIN_CAPACITY,
                           num_shards=SHARDS, batch_per_shard=FULL_LANES)
    want = [[(int(r.status), r.limit, r.remaining, r.reset_time)
             for r in twin.process(reqs, now=now)] for now, reqs in stream]
    out = dict(requests=sum(len(r) for _, r in stream),
               twin_max_keys=max(len(t) for t in twin.tables), runs={})
    del twin
    for layout in LAYOUTS:
        eng = RateLimitEngine(capacity_per_shard=TIER_CAPACITY,
                              num_shards=SHARDS, batch_per_shard=FULL_LANES)
        check(eng.native is None, "the tiered engine has the router")
        eng.enable_tiers(TierConfig(warm_rows=TIER_WARM_ROWS, layout=layout),
                         epoch=T0)
        fences = []
        fence = eng._tier_fence

        def timed_fence(now, t=eng._tiers, fence=fence, fences=fences):
            work = bool(t.pending_spills or t.pending_promos)
            t0 = time.perf_counter()
            fence(now)
            fences.append((work, time.perf_counter() - t0))

        eng._tier_fence = timed_fence
        d0 = dk.launches["drain_compact"]
        t0 = time.perf_counter()
        got = []
        for i, (now, reqs) in enumerate(stream):
            got.append([(int(r.status), r.limit, r.remaining, r.reset_time)
                        for r in eng.process(reqs, now=now)])
            if i % 37 == 36:
                eng.tier_maintain(now)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        busy = [s for w, s in fences if w]
        out["runs"][layout] = dict(
            equal=got == want, stats=eng.tier_stats(), wall_s=wall,
            fences=len(fences), fences_with_work=len(busy),
            fence_ms_median=(float(np.median(busy)) * 1e3 if busy else None),
            fence_ms_max=(max(busy) * 1e3 if busy else None),
            drain_launches=dk.launches["drain_compact"] - d0)
        del eng
    return out


def check_lifecycle(life, tiers):
    for layout in LAYOUTS:
        check(life[f"b_{layout}"] == life["b_orig"],
              f"load B on the {layout} restore differs from the "
              f"uninterrupted Instance")
        check(life["layouts"][layout]["keys"] > 0, f"{layout}: no keys")
    flat = [r for step in life["b_orig"] for r in step]
    check(len(flat) == life["decisions_b"] and not any(r[4] for r in flat),
          f"load B answered {len(flat)} decisions, some with errors")
    check(life["global_keys"] > 0, "no GLOBAL key in the snapshot")
    check(life["corrupt_restored"] is None, "the corrupt file restored")
    check(life["cold_size"] == 0 and life["cold_live"] == 0,
          "the corrupt restore left state behind")
    check([(r["status"], r["remaining"]) for r in life["cold_resp"]]
          == [(0, r.limit - 1) for r in (wire_request(i, "cold", 1)
                                         for i in range(SERVE_RPC))],
          "the cold Instance did not serve fresh buckets")
    check(tiers["twin_max_keys"] < TIER_TWIN_CAPACITY,
          f"the twin filled a shard ({tiers['twin_max_keys']} keys)")
    for layout, run in tiers["runs"].items():
        st = run["stats"]
        check(run["equal"], f"tiers {layout}: a response differs from the "
              f"twin that never evicts")
        check(st["demotions"] > 0 and st["promotions"] > 0,
              f"tiers {layout}: demotions {st['demotions']}, promotions "
              f"{st['promotions']}")
        check(st["pending_spills"] == 0 and st["pending_promotions"] == 0,
              f"tiers {layout}: work left pending")
        check(run["drain_launches"] > 0, f"tiers {layout}: no drain launch")


def report_lifecycle(life, tiers, counts, smi):
    rows = {}
    for layout, row in life["layouts"].items():
        rows[layout] = {k: (round(v, 3) if isinstance(v, float) else v)
                        for k, v in row.items()}
    runs = {}
    for layout, run in tiers["runs"].items():
        st = run["stats"]
        runs[layout] = dict(
            {k: st[k] for k in ("promotions", "promotions_from_spill",
                                "demotions", "demote_dropped_expired",
                                "demote_dropped_stale", "warm_hits",
                                "cold_misses", "warm_rows", "warm_bytes",
                                "warm_evictions")},
            fences=run["fences"], fences_with_work=run["fences_with_work"],
            fence_ms_median=run["fence_ms_median"],
            fence_ms_max=run["fence_ms_max"], wall_s=run["wall_s"],
            drain_launches=run["drain_launches"])
    fig = dict(card=smi, snapshot=rows, global_keys=life["global_keys"],
               load_b_seconds={k: life[f"b_{k}_s"]
                               for k in ("orig",) + LAYOUTS},
               tiers=runs, tier_requests=tiers["requests"],
               tier_twin_max_keys=tiers["twin_max_keys"])
    log(f"phase 10 state lifecycle ({SHARDS} x {FULL_CAPACITY // SHARDS} "
        f"slots, G = {G_FULL}): load A {life['decisions_a']} decisions, "
        f"saved in both layouts (" + "; ".join(
            f"{k} {v['bytes']} bytes, {v['keys']} keys, export "
            f"{v['export_ms']:.1f} ms (engine thread {v['engine_thread_ms']:.1f}),"
            f" dumps {v['dumps_ms']:.1f}, write+fsync "
            f"{v['write_fsync_ms']:.1f}, load {v['load_ms']:.1f}, import "
            f"{v['import_ms']:.1f}" for k, v in life["layouts"].items())
        + f"); each restore = the export on the card, then load B "
        f"({life['decisions_b']} decisions) = the uninterrupted Instance, "
        f"every response and both arenas; a flipped payload byte starts "
        f"cold and serves.  10b warm tier ({SHARDS} x {TIER_CAPACITY} hot "
        f"slots, {TIER_WARM_ROWS} warm rows, {tiers['requests']} requests "
        f"in {TIER_WINDOWS} windows) = the {SHARDS} x {TIER_TWIN_CAPACITY} "
        f"twin in both layouts (" + "; ".join(
            f"{k}: {v['demotions']} demotions, {v['promotions']} promotions, "
            f"{v['fences_with_work']} fences with work, median "
            f"{v['fence_ms_median']:.3f} ms" for k, v in runs.items())
        + f"); launches {counts}; {smi}")
    log("lifecycle figures: " + json.dumps(fig))


# ----------------------------------------------- phase 11: leases and QoS

LEASE_CLIENTS = 64
LEASE_KEYS = 1 << 16
LEASE_LIMIT = 8
LEASE_CALLS = 8             # get_rate_limits calls a client makes
LEASE_ITEMS = 40            # CONCURRENCY items a call
QOS_MAX_PENDING = 2048
QOS_RPCS = 6                # 100-item RPCs an overload caller sends
QOS_DEADLINE_CALLERS = 8    # callers whose deadline is shorter than a drain
QOS_DEADLINE_S = 50e-6
QOS_STRIDE_MAX = 4          # GUBER_FETCH_STRIDE_MAX for the QoS Instance
QOS_SMALL_PENDING = 64      # the analytics Instance's admission bound


class ServeLog:
    """Every request one Instance's engine thread decided, in its order:
    each engine.process call (the classic lane: CONCURRENCY and lease
    releases) and each drain's staged jobs (the pipelined lane), as
    (requests, now).  The engine thread runs both, one at a time, so the
    list is the order the arena saw.  A drain that sent a job through the
    full path is flagged (its place in the order is not logged)."""

    def __init__(self, inst):
        self.entries, self.fallbacks = [], 0
        eng, pipe = inst.engine, inst.batcher.pipeline
        process, drain = eng.process, pipe._drain_sync

        def logged_process(reqs, now=None, accumulate=None, **kw):
            self.entries.append((list(reqs), now))
            return process(reqs, now, accumulate, **kw)

        def logged_drain(jobs, now=None, cols=None):
            res = drain(jobs, now, cols)
            self.fallbacks += len(res.fallback)
            if res.staged and res.error is None:
                self.entries.append(([q for j in res.staged for q in j.reqs],
                                     res.now))
            return res

        eng.process, pipe._drain_sync = logged_process, logged_drain


class LeaseContext:
    """A gRPC context whose RPC was torn down before its response was
    delivered: cancelled() is true, and its done callbacks are kept for
    the caller to fire."""

    def __init__(self):
        self.callbacks = []

    def cancelled(self):
        return True

    def add_done_callback(self, cb):
        self.callbacks.append(cb)


def lease_request(key, hits):
    return RateLimitReq(name="lease", unique_key=f"l{key}", hits=hits,
                        limit=LEASE_LIMIT, duration=60_000,
                        algorithm=Algorithm.CONCURRENCY)


def lease_calls(rng):
    """Each client's calls: LEASE_ITEMS acquires (hits 1-3) over
    LEASE_KEYS keys, uniform; releases are added while it runs, from what
    it holds."""
    keys = rng.integers(0, LEASE_KEYS, (LEASE_CLIENTS, LEASE_CALLS,
                                        LEASE_ITEMS))
    hits = rng.integers(1, 4, (LEASE_CLIENTS, LEASE_CALLS, LEASE_ITEMS))
    return keys, hits


def qos_instances():
    """Phase 11's Instances, built and warmed before the counts start: A
    at phase 8's geometry with QoS at the JAX defaults and
    GUBER_FETCH_STRIDE_MAX=QOS_STRIDE_MAX, B the same with QoS off, and a
    small Instance (the port tests' geometry on the card) with analytics,
    the SLO engine and an admission bound of QOS_SMALL_PENDING.  (QoSConfig
    is imported here: compare_serving.py loads this file against packages
    from before it.)"""
    from gubernator_tpu_torch.config import QoSConfig
    os.environ["GUBER_FETCH_STRIDE_MAX"] = str(QOS_STRIDE_MAX)
    try:
        a = Instance(engine_config=serving_engine_config())
    finally:
        del os.environ["GUBER_FETCH_STRIDE_MAX"]
    b = Instance(engine_config=serving_engine_config(),
                 qos=QoSConfig(enabled=False))
    small = Instance(engine_config=EngineConfig(**SMALL_TWIN,
                                                use_native="on"),
                     analytics=AnalyticsConfig(enabled=True, **ANALYTICS),
                     slo=SLOConfig(enabled=True),
                     qos=QoSConfig(max_pending=QOS_SMALL_PENDING))
    check(a.qos is not None and b.qos is None and small.qos is not None,
          "QoS is not on at the defaults, or not off when asked")
    check(a.qos.conf.max_pending == 8192 and a.qos.fair_slotting
          and a.lease_conf.release_on_stream_close
          and a.batcher.pipeline.fetch_stride_max == QOS_STRIDE_MAX,
          "the QoS Instance is not at the JAX defaults")
    for inst in (a, b, small):
        check(inst.engine.native is not None and inst.batcher.pipeline,
              "the router or the pipeline is missing")
        inst.engine.warmup()
    torch.cuda.synchronize()
    return a, b, small


def phase_qos_leases(a, b, small):
    """Phase 11, the counted part (the Instances are built and warmed
    before the counts start).  11a on A: LEASE_CLIENTS clients acquire
    CONCURRENCY slots through get_rate_limits(client_id=) and release some
    of theirs explicitly; half of them vanish through the server's
    stream-close hook; then GUBER_LEASE_MAX_PER_CLIENT = 2 answers an
    acquire on the host.  11b: first (before 11a, on fresh controllers)
    saturation at the default bound on A and with QoS off on B; then, after
    11a, on A 64 callers of 100-item RPCs at an
    admission bound of QOS_MAX_PENDING, QOS_DEADLINE_CALLERS of them with
    a deadline shorter than a drain, the fetch stride's floor at 2 (its
    cap QOS_STRIDE_MAX), the controllers recorded at every drain (from the
    first lease window on) and the health check sampled; one drain on the
    analytics Instance past its bound; A's drain() and a request after
    it.  The caller reads the counts when
    this returns and checks afterwards."""
    from gubernator_tpu_torch.server import _arm_lease_stream_close
    rng = np.random.default_rng(113)
    keys, hits = lease_calls(rng)
    q_rpcs = serving_rpcs(rng, SERVE_CLIENTS * QOS_RPCS * SERVE_RPC, "q",
                          compact_only=True)
    sat_rpcs = serving_rpcs(rng, 512 * SERVE_RPC, "w", compact_only=True)
    small_reqs = [serving_request(i, "m", 1, compact_only=True)
                  for i in range(SERVE_RPC)]
    pipe, cong, adm = a.batcher.pipeline, a.qos.congestion, a.qos.admission
    log_a = ServeLog(a)
    resp = {}           # id(request) -> A's response
    tl = millisecond_now()
    out = dict(log=log_a, resp=resp, tl=tl)
    released = []
    orig_release = a.release_client_leases

    async def tracked_release(*args, **kw):
        n = await orig_release(*args, **kw)
        released.append(n)
        return n
    a.release_client_leases = tracked_release
    path = []
    orig_observe = cong.observe_drain

    def observe(wall, depth=1):
        orig_observe(wall, depth)
        path.append((cong.effective_window(),
                     cong.effective_depth(pipe.depth), pipe._stride_target))
    cong.observe_drain = observe
    reset_counts()

    async def leases():
        pin_clock(a, tl)
        first = len(log_a.entries)

        async def client(c):
            cid = f"client-{c}"
            held = {}
            for j in range(LEASE_CALLS):
                reqs = [lease_request(int(k), int(h))
                        for k, h in zip(keys[c, j], hits[c, j])
                        if int(k) not in held]
                # release a quarter of what this client holds, in full
                for k in list(held)[: len(held) // 4]:
                    reqs.append(lease_request(k, -held.pop(k)))
                got = await a.get_rate_limits(reqs, client_id=cid)
                for q, r in zip(reqs, got):
                    resp[id(q)] = r
                    if q.hits > 0 and r.status == 0 and not r.error:
                        k = int(q.unique_key[1:])
                        held[k] = held.get(k, 0) + q.hits

        await asyncio.gather(*(client(c) for c in range(LEASE_CLIENTS)))
        out["held_before_close"] = a.leases.stats()
        vanish = [f"client-{c}" for c in range(0, LEASE_CLIENTS, 2)]
        ctxs = []
        for cid in vanish:
            ctx = LeaseContext()
            _arm_lease_stream_close(a, ctx, cid)
            ctxs.append(ctx)
        for ctx in ctxs:
            check(len(ctx.callbacks) == 1, "the stream-close hook was not "
                  "armed")
            ctx.callbacks[0](ctx)
        while len(released) < len(vanish):
            await asyncio.sleep(0.001)
        check(not any(a.leases.holds(cid) for cid in vanish),
              "a vanished client still holds leases")
        out["released"] = sum(released)
        # GUBER_LEASE_MAX_PER_CLIENT = 2: a holder's acquire of 2 more is
        # answered on the host, nothing launched for it
        cid = "client-1"
        rows = [k for k, c, n, _ in a.leases.export_rows() if c == cid]
        check(rows, f"{cid} holds nothing")
        q = RateLimitReq(name="lease", unique_key=rows[0].split("_", 1)[1],
                         hits=2, limit=LEASE_LIMIT, duration=60_000,
                         algorithm=Algorithm.CONCURRENCY)
        a.lease_conf.max_per_client = 2
        before, wins = launch_counts(), a.engine.windows_processed
        try:
            capped = (await a.get_rate_limits([q], client_id=cid))[0]
        finally:
            a.lease_conf.max_per_client = 0
        check((capped.status, capped.remaining, capped.reset_time)
              == (1, 0, 0) and launch_counts() == before
              and a.engine.windows_processed == wins,
              f"the per-client cap: {capped}, launches "
              f"{moved(before, launch_counts())}")
        out["lease_span"] = (first, len(log_a.entries))

    async def overload():
        tq = tl + 1
        pin_clock(a, tq)
        adm.max_pending = QOS_MAX_PENDING
        adm.pending_peak = adm.pending
        pipe.fetch_stride = 2
        health = []
        done = [False]
        items = []      # (latency ms, admitted items of the RPC)

        async def monitor():
            while not done[0]:
                h = await a.health_check()
                health.append(h.message if h.status != "healthy" else "")
                await asyncio.sleep(0.001)

        async def caller(c):
            for j in range(QOS_RPCS):
                rpc = q_rpcs[c * QOS_RPCS + j]
                dl = (time.monotonic() + QOS_DEADLINE_S
                      if c < QOS_DEADLINE_CALLERS else None)
                t = time.perf_counter()
                got = await a.get_rate_limits(rpc, deadline=dl)
                ms = (time.perf_counter() - t) * 1e3
                n = 0
                for q, r in zip(rpc, got):
                    resp[id(q)] = r
                    n += "shed_reason" not in r.metadata
                items.append((ms, n))

        sheds0 = dict(adm.shed_counts)
        mon = asyncio.ensure_future(monitor())
        t0 = time.perf_counter()
        await asyncio.gather(*(caller(c) for c in range(SERVE_CLIENTS)))
        wall = time.perf_counter() - t0
        done[0] = True
        await mon
        pipe.fetch_stride = 1
        adm.max_pending = 8192
        while a.batcher.busy():
            await asyncio.sleep(0.001)
        lat = np.repeat([m for m, _ in items], [n for _, n in items])
        sheds = {k: v - sheds0.get(k, 0) for k, v in adm.shed_counts.items()
                 if v != sheds0.get(k, 0)}
        out["overload"] = dict(
            wall=wall, tq=tq, sheds=sheds,
            admitted=int(lat.size),
            p50=float(np.percentile(lat, 50)) if lat.size else None,
            p99=float(np.percentile(lat, 99)) if lat.size else None,
            saturated_samples=sum("saturated" in m for m in health),
            samples=len(health), peak=adm.pending_peak,
            healthy_after=(await a.health_check()).status)

    async def saturation():
        pin_clock(a, None)
        pin_clock(b, None)
        sheds0 = sum(a.qos.admission.shed_counts.values())
        figs = {}
        for name, inst in (("qos_on", a), ("qos_off", b)):
            await saturate(inst.get_rate_limits, sat_rpcs, 0.5)
            n, wall = await saturate(inst.get_rate_limits, sat_rpcs,
                                     SERVE_SECONDS)
            figs[name] = n / wall
        figs["qos_on_sheds"] = sum(a.qos.admission.shed_counts.values()) \
            - sheds0
        out["saturation"] = figs

    async def drain_a():
        ok = await a.drain(5.0)
        late = (await a.get_rate_limits([serving_request(
            7, "d", 1, compact_only=True)]))[0]
        out["drain"] = (ok, late.metadata.get("shed_reason"),
                        (await a.health_check()).message)

    async def script():
        await saturation()
        await leases()
        await overload()
        await drain_a()

    try:
        asyncio.run(script())
    finally:
        cong.observe_drain = orig_observe
        a.release_client_leases = orig_release
    out["path"] = path

    # the analytics Instance: one RPC past its bound, one drain
    an_pipe = small.batcher.pipeline
    pin_clock(small, tl)
    d0 = an_pipe.drains

    async def one_rpc():
        return await small.get_rate_limits(small_reqs)
    got = asyncio.run(one_rpc())
    out["small"] = dict(
        got=got, drains=an_pipe.drains - d0,
        shed=sum("shed_reason" in r.metadata for r in got),
        slo_shed=sum(b_ for _, _, b_ in small.slo._buckets["shed_rate"]),
        hits=small.analytics.snapshot()["totals"]["hits"])
    small.close()
    return out


def lease_rows_on_card(inst, keys):
    """Each lease key's row of the regular arena, found through the
    router's tables (shard by crc32, slot by fingerprint): key -> held
    slots (the limit less the row's free count)."""
    from gubernator_tpu_torch.core.engine import _fnv1a64, shard_of
    eng = inst.engine
    slots = []
    for s in range(eng.num_shards):
        fp, slot, _ = eng.native.export_keys(s)
        slots.append(dict(zip(fp.tolist(), slot.tolist())))
    arena = eng.export_arena()
    out = {}
    for k in keys:
        s = shard_of(k, eng.num_shards)
        slot = slots[s].get(_fnv1a64(k.encode("utf-8")))
        check(slot is not None, f"lease key {k} has no slot")
        check(int(arena["algo"][s, slot]) == Algorithm.CONCURRENCY,
              f"lease key {k}'s row is not a concurrency row")
        out[k] = LEASE_LIMIT - int(arena["remaining"][s, slot])
    return out, arena


def check_qos_leases(r, a, b):
    """Phase 11, after the counts are read.  11a: the serial oracles
    (algorithms/oracles.py) over the logged lease stream give every
    response A gave; every lease key's row on the card holds what the
    lease book says; a snapshot of A restored into B brings the book's
    rows back equal.  11b: a Python-table engine on the card replaying
    everything A's engine thread decided, in its order, gives every
    admitted answer A gave, and the two arenas hold the same rows (a shed
    touched nothing); the sheds, the health samples, the drain."""
    from gubernator_tpu_torch.algorithms import oracles
    log_a, resp = r["log"], r["resp"]
    check(log_a.fallbacks == 0, f"{log_a.fallbacks} jobs took the full path "
          "(their place in the replay order is not logged)")
    # 11a: the oracles
    rows, n_checked = {}, 0
    for reqs, now in log_a.entries[slice(*r["lease_span"])]:
        for q in reqs:
            check(q.algorithm == Algorithm.CONCURRENCY,
                  f"a non-lease request in the lease stream: {q}")
            key = q.hash_key()
            rows[key], want = oracles.apply(rows.get(key), q.hits, q.limit,
                                            q.duration, q.algorithm, now)
            got = resp.get(id(q))
            if got is not None:
                check((got.status, got.limit, got.remaining, got.reset_time)
                      == tuple(want), f"lease {key}: {got} != the oracle's "
                      f"{want}")
                n_checked += 1
    held, arena_a = lease_rows_on_card(a, list(rows))
    book = {k: a.leases.held(k) for k in rows}
    diff = [k for k in rows if held[k] != book[k]]
    check(not diff, f"{len(diff)} lease keys' rows differ from the book, "
          f"e.g. {diff[:3]}: card {[held[k] for k in diff[:3]]}, book "
          f"{[book[k] for k in diff[:3]]}")
    oracle_held = {k: LEASE_LIMIT - rw.remaining for k, rw in rows.items()}
    check(oracle_held == held, "the oracles' rows differ from the card's")
    # 11b: the Python-table replay of everything A decided
    twin = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                           num_shards=SHARDS, batch_per_shard=FULL_LANES)
    check(twin.native is None, "the twin engine has the router")
    decided, n_replayed = set(), 0
    for reqs, now in log_a.entries:
        want = twin.process(reqs, now=now)
        for q, w in zip(reqs, want):
            decided.add(id(q))
            got = resp.get(id(q))
            if got is None:
                continue
            check((got.status, got.limit, got.remaining, got.reset_time,
                   got.error) == (w.status, w.limit, w.remaining,
                                  w.reset_time, w.error),
                  f"{q.hash_key()}: {got} != the Python-table engine's {w}")
            n_replayed += 1
    shed = [i for i, x in resp.items() if "shed_reason" in x.metadata]
    check(not any(i in decided for i in shed),
          "a shed request reached the engine")
    admitted = [i for i, x in resp.items() if "shed_reason" not in x.metadata]
    check(all(i in decided for i in admitted),
          "an admitted request never reached the engine")
    for s, (x, t) in enumerate(zip(arena_rows(arena_a),
                                   arena_rows(twin.export_arena()))):
        check(np.array_equal(x, t), f"shard {s}'s rows differ from the "
              f"Python-table engine's")
    del twin, arena_a
    o = r["overload"]
    check(o["sheds"].get("queue_full", 0) > 0
          and o["sheds"].get("deadline", 0) > 0
          and set(o["sheds"]) <= {"queue_full", "deadline"},
          f"the overload's sheds: {o['sheds']}")
    check(o["peak"] <= QOS_MAX_PENDING, f"admission held {o['peak']} > "
          f"{QOS_MAX_PENDING}")
    check(o["saturated_samples"] > 0 and o["healthy_after"] == "healthy",
          f"health: {o['saturated_samples']} of {o['samples']} samples "
          f"saturated, {o['healthy_after']} after")
    ok, late, msg = r["drain"]
    check(ok and late == "draining" and "draining" in msg,
          f"drain(): {r['drain']}")
    sm = r["small"]
    check(sm["shed"] == SERVE_RPC - QOS_SMALL_PENDING
          and sm["slo_shed"] == sm["shed"] and sm["drains"] >= 1
          and sm["hits"] == QOS_SMALL_PENDING,
          f"the analytics Instance: {sm['shed']} shed, {sm['slo_shed']} "
          f"in the SLO engine, {sm['drains']} drains, {sm['hits']} hits")
    # the lease book through a snapshot of A, restored into B

    async def roundtrip():
        blob = await a.export_snapshot_bytes()
        await b.restore_snapshot_bytes(blob)
        return len(blob)
    t0 = time.perf_counter()
    size = asyncio.run(roundtrip())
    snap_s = time.perf_counter() - t0
    check(sorted(b.leases.export_rows()) == sorted(a.leases.export_rows())
          and b.leases.stats() == a.leases.stats(),
          "the lease book did not come back equal from the snapshot")
    return dict(oracle_checked=n_checked, replayed=n_replayed,
                lease_keys=len(rows), book=a.leases.stats(),
                snapshot=(size, snap_s), sheds=len(shed),
                admitted=len(admitted))


def report_qos_leases(r, chk, counts, smi):
    o, sat = r["overload"], r["saturation"]
    path = r["path"]
    runs = []   # the controllers' path, run-length encoded
    for p in path:
        if runs and runs[-1][0] == p:
            runs[-1][1] += 1
        else:
            runs.append([p, 1])
    fig = dict(
        card=smi,
        leases=dict(clients=LEASE_CLIENTS, keys=chk["lease_keys"],
                    book_keys_clients_held=chk["book"],
                    held_before_close=r["held_before_close"],
                    released_on_close=r["released"],
                    oracle_checked=chk["oracle_checked"],
                    snapshot_bytes=chk["snapshot"][0],
                    snapshot_roundtrip_s=chk["snapshot"][1]),
        overload=dict(max_pending=QOS_MAX_PENDING, wall_s=o["wall"],
                      admitted=o["admitted"], sheds=o["sheds"],
                      admitted_p50_ms=o["p50"], admitted_p99_ms=o["p99"],
                      pending_peak=o["peak"],
                      health_saturated_samples=o["saturated_samples"],
                      health_samples=o["samples"]),
        controllers=dict(drains=len(path), runs=len(runs), path=[
            dict(cwnd=p[0], depth=p[1], stride=p[2], drains=n)
            for p, n in (runs if len(runs) <= 40
                         else runs[:20] + runs[-20:])],
            cwnd_min=min((p[0] for p in path), default=None),
            depth_min=min((p[1] for p in path), default=None),
            stride_max=max((p[2] for p in path), default=None)),
        saturation_decisions_per_s=dict(qos_on=sat["qos_on"],
                                        qos_off=sat["qos_off"],
                                        qos_on_sheds=sat["qos_on_sheds"]),
        replayed=chk["replayed"], phase_wall_s=r["wall_s"])
    log(f"phase 11 leases and QoS ({SHARDS} x {FULL_CAPACITY // SHARDS} "
        f"slots, QoS at the JAX defaults): 11a {LEASE_CLIENTS} clients over "
        f"{chk['lease_keys']} lease keys, book (keys, clients, held) "
        f"{chk['book']} = every row on the card, {chk['oracle_checked']} "
        f"answers = the serial oracles, {r['released']} slots released by "
        f"the stream-close hook, the per-client cap answered on the host, "
        f"the book back equal through a {chk['snapshot'][0]}-byte snapshot; "
        f"11b overload at max_pending {QOS_MAX_PENDING}: {o['admitted']} "
        f"admitted (p50 {o['p50']:.3f} ms, p99 {o['p99']:.3f} ms), sheds "
        f"{o['sheds']}, {chk['replayed']} answers = the Python-table "
        f"replay, arenas equal; saturation {sat['qos_on']:.1f} decisions/s "
        f"QoS on, {sat['qos_off']:.1f} off; controllers over {len(path)} "
        f"drains: {len(runs)} distinct (cwnd, depth, stride); drain() "
        f"then shed with draining; {r['wall_s']:.1f} s; launches {counts}; "
        f"{smi}")
    log("qos figures: " + json.dumps(fig))

# ------------------------------------------------ phase 12: the peer ring

RING_NODES = 3
RING_SEQ_RPCS = 60          # RPCs of the sequential parts (one at a time)
RING_BURST_A = 20_000       # decisions of 12a's concurrent part
RING_BURST_B = 50_000       # decisions of 12b's concurrent part
RING_GLOBAL = 2_000         # GLOBAL items of 12c
RING_GLOBAL_KEYS = 256
RING_GLOBAL_RPC = 50        # GLOBAL items a get_rate_limits call
RING_GLOBAL_LIMIT = 100_000  # no GLOBAL key runs out: aggregation is exact


class LoopbackDown(Exception):
    """What a dead peer's transport raises: UNAVAILABLE, which the peer
    lane retries and counts against the peer's breaker, as a refused
    gRPC connection."""

    def code(self):
        return "UNAVAILABLE"

    def details(self):
        return str(self)


class RingLoopback:
    """The in-process transport of one PeerClient (net/peers.py's seam),
    from node `caller` to the Instance `owner`: GetPeerRateLimits bytes go
    to the owner's server.serve_peer_rate_limits (its bytes lane, or its
    protobuf path for what the C parser refuses, such as a GLOBAL item);
    on a machine where protobuf cannot be imported, the loopback does
    what that path does: this script's proto3 codec decodes the request
    and Instance.get_peer_rate_limits(reqs, client_id=caller) answers.
    UpdatePeerGlobals goes to Instance.update_peer_globals,
    TransferBuckets bytes to server.serve_transfer_buckets (no protobuf:
    the payload is state/migrate.py's JSON) and HealthCheck to
    Instance.health_check.  `stats` (shared by the ring) counts the calls,
    the items, each call's round trip and each transfer's bytes and wall
    time; while the owner's address is in stats["dead"] every call raises
    LoopbackDown, as a dead peer's would."""

    errors = (LoopbackDown,)

    def __init__(self, owner, caller, stats):
        self.owner, self.caller, self.stats = owner, caller, stats

    def _alive(self):
        host = self.owner.advertise_address
        if host in self.stats.get("dead", ()):
            raise LoopbackDown(f"peer {host} is down")

    async def _peer_bytes(self, data):
        self._alive()
        from gubernator_tpu_torch.server import serve_peer_rate_limits
        t0 = time.perf_counter()
        try:
            out = await serve_peer_rate_limits(self.owner, data,
                                               WireContext())
        except ImportError:
            reqs = [RateLimitReq(**d) for d in decode_list(data, REQ_FIELDS)]
            resps = await self.owner.get_peer_rate_limits(
                reqs, client_id=self.caller)
            out = encode_list([vars(r) for r in resps], RESP_FIELDS)
            self.stats["codec_calls"] += 1
        self.stats["rtt_ms"].append((time.perf_counter() - t0) * 1e3)
        return out

    async def get_peer_rate_limits(self, reqs, timeout, metadata=None):
        from gubernator_tpu_torch.api.types import RateLimitResp
        self.stats["item_calls"] += 1
        self.stats["items"] += len(reqs)
        out = await self._peer_bytes(encode_list([vars(r) for r in reqs],
                                                 REQ_FIELDS))
        return [RateLimitResp(**d) for d in decode_list(out, RESP_FIELDS)]

    async def get_peer_rate_limits_raw(self, data, timeout):
        self.stats["raw_calls"] += 1
        return await self._peer_bytes(data)

    async def update_peer_globals(self, globals_, timeout):
        self._alive()
        self.stats["broadcasts"] += 1
        self.stats["upserts"] += len(globals_)
        await self.owner.update_peer_globals(globals_)

    async def transfer_buckets(self, payload, timeout):
        from gubernator_tpu_torch.server import serve_transfer_buckets
        self._alive()
        t0 = time.perf_counter()
        ack = await serve_transfer_buckets(self.owner, payload, WireContext())
        self.stats["transfers"].append((self.caller,
                                        self.owner.advertise_address,
                                        len(payload),
                                        time.perf_counter() - t0))
        return ack

    async def health_check(self, timeout):
        self._alive()
        return await self.owner.health_check()

    async def close(self):
        pass


class RingCounts:
    """Per-node launch counts of phase 12, on top of the wrappers' own:
    drain_compact launches by arena, and each node's GLOBAL windows by
    what their host control carries: owner lanes (hits summed), replica
    reads (hits kept out, accumulate=False), upsert lanes.  remove() puts
    the wrapper and the engines' methods back."""

    def __init__(self, nodes):
        self.nodes = nodes
        self.by_ptr = {n.engine.state.limit.data_ptr(): i
                       for i, n in enumerate(nodes)}
        self.drains = [0] * len(nodes)
        self.glob = [dict(owner=0, replica=0, upsert=0) for _ in nodes]
        self.orig = dk.drain_compact

        def drain(state, *a, **kw):
            i = self.by_ptr.get(state.limit.data_ptr())
            if i is not None:
                self.drains[i] += 1
            return self.orig(state, *a, **kw)
        dk.drain_compact = drain
        for i, n in enumerate(nodes):
            n.engine._global_window = self._wrap(i, n.engine._global_window)

    def _wrap(self, i, fn):
        def window(gbatch, gacc, upd, now, ups=None):
            slot = np.asarray(gbatch.slot).reshape(-1)
            hits = np.asarray(gbatch.hits).reshape(-1)
            acc = np.asarray(gacc).reshape(-1)
            live = slot >= 0
            g = self.glob[i]
            g["owner"] += int(bool((live & (acc != 0)).any()))
            g["replica"] += int(bool((live & (acc == 0) & (hits != 0)).any()))
            g["upsert"] += int(ups is not None)
            return fn(gbatch, gacc, upd, now, ups)
        return window

    def remove(self):
        dk.drain_compact = self.orig
        for n in self.nodes:
            del n.engine._global_window


def ring_nodes():
    """Phase 12's three Instances at phase 8's geometry (8 x 2^21 slots,
    G = 4096, B = 1024, the router, QoS at the JAX defaults), each
    advertising node<i>:81 and reaching the others through RingLoopback,
    warmed before the counts start.  Returns (nodes, addresses, stats)."""
    addrs = [f"node{i}:81" for i in range(RING_NODES)]
    stats = dict(item_calls=0, raw_calls=0, items=0, codec_calls=0,
                 broadcasts=0, upserts=0, rtt_ms=[], transfers=[])
    nodes = []
    for addr in addrs:
        nodes.append(Instance(
            engine_config=serving_engine_config(), advertise_address=addr,
            peer_transport=(lambda host, me=addr: RingLoopback(
                nodes[addrs.index(host)], me, stats))))
    for n in nodes:
        check(n.engine.native is not None and n.batcher.pipeline is not None
              and n.qos is not None, "a ring node lacks the router, the "
              "pipeline or QoS")
        n.engine.warmup()
    torch.cuda.synchronize()
    return nodes, addrs, stats


async def ring_join(nodes, addrs):
    from gubernator_tpu_torch.config import PeerInfo
    for n, me in zip(nodes, addrs):
        await n.set_peers([PeerInfo(address=a, is_owner=(a == me))
                           for a in addrs])
        check(n.batcher.pipeline.rpc_enabled and len(n.peer_list()) == 3,
              "set_peers left the raw-RPC lane closed or the ring short")


async def ring_quiesce(nodes):
    """Wait until no GLOBAL manager holds a queued hit or update or runs a
    sender, so nothing stale is in flight; then every node flushes (its
    hits to the owners, its queued broadcasts) and every node flushes
    again (the broadcasts of what the hits changed)."""
    for _ in range(200):
        busy = []
        for n in nodes:
            gm = n.global_mgr
            tasks = list(gm._tasks) + [
                t for t in (getattr(gm, "_hits_waiter_task", None),
                            getattr(gm, "_bcast_waiter_task", None))
                if t is not None and not t.done()]
            busy += [t for t in tasks if not t.done()]
        if not busy and not any(n.global_mgr._hits or n.global_mgr._updates
                                for n in nodes):
            break
        if busy:
            await asyncio.gather(*busy, return_exceptions=True)
        else:
            await asyncio.sleep(0.002)
    for _ in range(2):
        for n in nodes:
            await n.global_mgr.flush()


def ring_owner(nodes, key):
    return nodes[0].get_peer(key).host


def answer_fields(r):
    if isinstance(r, dict):
        return (int(r["status"]), r["limit"], r["remaining"],
                r["reset_time"], r["error"])
    return (int(r.status), r.limit, r.remaining, r.reset_time, r.error)


def check_owner_metadata(nodes, addrs, node_of, rpcs, answers, what):
    """Every answer forwarded to another node names that node, the key's
    ring owner, in metadata['owner']; an answer decided where it arrived
    names none.  Returns the items forwarded."""
    fwd = 0
    for i, (rpc, outs) in enumerate(zip(rpcs, answers)):
        me = addrs[node_of(i)]
        for r, a in zip(rpc, outs):
            meta = a["metadata"] if isinstance(a, dict) else a.metadata
            owner = ring_owner(nodes, r.hash_key())
            if owner == me:
                check("owner" not in (meta or {}),
                      f"{what}: a local answer names an owner: {meta}")
            else:
                fwd += 1
                check((meta or {}).get("owner") == owner,
                      f"{what}: {r.hash_key()} answered with owner "
                      f"{(meta or {}).get('owner')}, ring owner {owner}")
    return fwd


async def ring_probe_owners(nodes, reqs_by_key):
    """Each key's state on its owner: a hits=0 request through the
    owner's peer plane (its authoritative relay), in chunks of 1000."""
    by_owner = {}
    for key, r in reqs_by_key.items():
        by_owner.setdefault(ring_owner(nodes, key), []).append(r)
    out = {}
    hosts = [n.advertise_address for n in nodes]
    for host, reqs in by_owner.items():
        inst = nodes[hosts.index(host)]
        for base in range(0, len(reqs), 1000):
            chunk = [RateLimitReq(name=r.name, unique_key=r.unique_key,
                                  hits=0, limit=r.limit, duration=r.duration,
                                  algorithm=r.algorithm)
                     for r in reqs[base:base + 1000]]
            for r, a in zip(chunk, await inst.get_peer_rate_limits(chunk)):
                out[r.hash_key()] = a
    return out


def check_admitted(rpcs, answers, probes, what):
    """For every key, limit - remaining on its owner = the hits of its
    requests answered under the limit (a pinned clock: nothing leaks or
    expires).  Returns the keys checked."""
    admitted, req_of = {}, {}
    for rpc, outs in zip(rpcs, answers):
        for r, a in zip(rpc, outs):
            status = a["status"] if isinstance(a, dict) else int(a.status)
            k = r.hash_key()
            req_of[k] = r
            admitted[k] = admitted.get(k, 0) + (r.hits if status == 0 else 0)
    for k, h in admitted.items():
        p = probes[k]
        check(p.error == "" and p.limit - p.remaining == h,
              f"{what}: {k} on its owner: limit {p.limit} - remaining "
              f"{p.remaining} != the {h} admitted hits")
    return len(admitted)


def ring_global_calls(rng):
    """RING_GLOBAL token and leaky GLOBAL items over RING_GLOBAL_KEYS keys
    (Zipf), RING_GLOBAL_RPC a call."""
    idx = (rng.zipf(1.1, RING_GLOBAL) - 1) % RING_GLOBAL_KEYS
    hits = rng.choice([0, 1, 1, 2], RING_GLOBAL)
    reqs = [RateLimitReq(name="gring", unique_key=f"g{int(i)}", hits=int(h),
                         limit=RING_GLOBAL_LIMIT, duration=600_000,
                         algorithm=int(i) % 2, behavior=Behavior.GLOBAL)
            for i, h in zip(idx, hits)]
    return [reqs[i:i + RING_GLOBAL_RPC]
            for i in range(0, len(reqs), RING_GLOBAL_RPC)]


def phase_ring():
    """Phase 12, the counted part: three Instances at phase 8's geometry on
    the one card, joined by set_peers over RingLoopback.  12a: the
    per-item path (Instance.get_rate_limits) with 100-item RPCs of
    compact token and leaky, Zipf keys over 2^20, round-robin to the
    nodes: RING_SEQ_RPCS one at a time on a pinned clock, then a
    RING_BURST_A-decision burst from 64 callers, then saturation on the
    wall clock (unprofiled and profiled).  12b: the same through
    serve_get_rate_limits on serialized RPCs (the raw-bytes lane, mixed
    RPCs forwarding their remote items as bytes).  12c: RING_GLOBAL
    GLOBAL items over RING_GLOBAL_KEYS keys from every node, the GLOBAL
    managers quiesced and flushed, then a hits=0 probe of every key on
    every node.  Counts start after the nodes are built and warmed."""
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1212)
    nodes, addrs, stats = ring_nodes()
    seq_a = serving_rpcs(rng, RING_SEQ_RPCS * SERVE_RPC, "ra",
                         compact_only=True)
    burst_a = serving_rpcs(rng, RING_BURST_A, "rA", compact_only=True)
    sat_a = serving_rpcs(rng, 512 * SERVE_RPC, "rS", compact_only=True)

    def ring_wire(prefix, n):
        def request(idx, _prefix, hits, compact_only=True):
            return wire_request(idx, prefix, hits)
        rpcs = serving_rpcs(rng, n, prefix, request=request)
        return rpcs, [encode_list([vars(r) for r in rpc], REQ_FIELDS)
                      for rpc in rpcs]
    seq_b = ring_wire("rb", RING_SEQ_RPCS * SERVE_RPC)
    burst_b = ring_wire("rB", RING_BURST_B)
    sat_b = ring_wire("rT", 512 * SERVE_RPC)
    glob = ring_global_calls(rng)
    ctx = WireContext()
    t_pin = millisecond_now()
    out = dict(addrs=addrs, seq_a=seq_a, seq_b=seq_b[0], glob=glob,
               t_pin=t_pin, burst_a=burst_a, burst_b=burst_b[0],
               rpc_bytes=[len(d) for d in seq_b[1] + burst_b[1]])
    rr = {"a": 0, "b": 0}

    async def serve_a(rpc):
        i = rr["a"]
        rr["a"] += 1
        return await nodes[i % RING_NODES].get_rate_limits(rpc)

    async def serve_b(data):
        i = rr["b"]
        rr["b"] += 1
        return await serve_get_rate_limits(nodes[i % RING_NODES], data, ctx)

    def pin(now):
        for n in nodes:
            pin_clock(n, now)

    async def script():
        from torch.profiler import ProfilerActivity, profile
        await ring_join(nodes, addrs)
        counts = RingCounts(nodes)
        out["counts"] = counts
        reset_counts()
        try:
            pin(t_pin)
            # 12a: sequential, then 64 callers
            out["seq_a_out"] = [
                await nodes[i % RING_NODES].get_rate_limits(rpc)
                for i, rpc in enumerate(seq_a)]
            done = [None] * len(burst_a)

            async def caller_a(c):
                for i in range(c, len(burst_a), SERVE_CLIENTS):
                    done[i] = await nodes[i % RING_NODES].get_rate_limits(
                        burst_a[i])
            await asyncio.gather(*(caller_a(c) for c in range(SERVE_CLIENTS)))
            out["burst_a_out"] = done
            # 12b: sequential, then 64 callers
            out["seq_b_out"] = [decode_list(
                await serve_get_rate_limits(nodes[i % RING_NODES], d, ctx),
                RESP_FIELDS) for i, d in enumerate(seq_b[1])]
            datas, outs_b = burst_b[1], [None] * len(burst_b[1])

            async def caller_b(c):
                for i in range(c, len(datas), SERVE_CLIENTS):
                    outs_b[i] = await serve_get_rate_limits(
                        nodes[i % RING_NODES], datas[i], ctx)
            await asyncio.gather(*(caller_b(c) for c in range(SERVE_CLIENTS)))
            out["burst_b_out"] = [decode_list(o, RESP_FIELDS) for o in outs_b]
            # 12c: GLOBAL from every node, then quiesce, flush and probe
            g0 = dict(stats)
            await asyncio.gather(*(
                nodes[i % RING_NODES].get_rate_limits(rpc)
                for i, rpc in enumerate(glob)))
            await ring_quiesce(nodes)
            keys = {}
            for rpc in glob:
                for r in rpc:
                    keys.setdefault(r.hash_key(), r)
            out["gkeys"] = keys
            out["gprobe"] = []
            for n in nodes:
                probe = [RateLimitReq(
                    name=r.name, unique_key=r.unique_key, hits=0,
                    limit=r.limit, duration=r.duration,
                    algorithm=r.algorithm, behavior=Behavior.GLOBAL)
                    for r in keys.values()]
                out["gprobe"].append([answer_fields(a) for a in
                                      await n.get_rate_limits(probe)])
            await ring_quiesce(nodes)
            out["g_broadcasts"] = stats["broadcasts"] - g0["broadcasts"]
            out["g_upserts"] = stats["upserts"] - g0["upserts"]
            # owners' states for the concurrent parts' checks
            ka = {r.hash_key(): r for rpc in burst_a for r in rpc}
            kb = {r.hash_key(): r for rpc in burst_b[0] for r in rpc}
            out["probe_a"] = await ring_probe_owners(nodes, ka)
            out["probe_b"] = await ring_probe_owners(nodes, kb)
            out["fwd_counts"] = dict(stats, rtt_ms=list(stats["rtt_ms"]))
            # saturation on the wall clock: the per-item path and the
            # bytes lane, each unprofiled then profiled (idle share)
            pin(None)
            await saturate(serve_a, sat_a, 0.5)
            out["sat"] = {}
            for lane, serve, rpcs in (("a", serve_a, sat_a),
                                      ("b", serve_b, sat_b[1])):
                n1, w1 = await saturate(serve, rpcs, SERVE_SECONDS)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    n2, w2 = await saturate(serve, rpcs, SERVE_SECONDS)
                    torch.cuda.synchronize()
                out["sat"][lane] = (n1 / w1, n2 / w2, busy_share(prof, w2))
            out["cwnd"] = [n.qos.congestion.effective_window() for n in nodes]
        finally:
            counts.remove()
            for n in nodes:
                await n.aclose()

    asyncio.run(script())
    out["nodes"] = nodes
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def check_ring(r):
    """Phase 12's checks, after its counts are read.  The sequential parts
    against a serial standalone engine on the card replaying the same
    requests at the same pinned clock (12a's RPCs, then 12b's, then 12c's
    GLOBAL items); every forwarded answer's owner against the ring; the
    concurrent parts' admitted hits against each key's state on its
    owner; no key in a non-owner's router; 12c's probes equal on every
    node, every replica's GLOBAL row equal to its owner's and the owner's
    to the serial engine's; the per-node launch counts."""
    from gubernator_tpu_torch.core.engine import _fnv1a64
    nodes, addrs, t = r["nodes"], r["addrs"], r["t_pin"]
    oracle = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                             num_shards=SHARDS, batch_per_shard=FULL_LANES,
                             use_native="on")
    for what, rpcs, outs in (("12a", r["seq_a"], r["seq_a_out"]),
                             ("12b", r["seq_b"], r["seq_b_out"])):
        n = 0
        for i, (rpc, got) in enumerate(zip(rpcs, outs)):
            want = oracle.process(rpc, now=t)
            check([answer_fields(a) for a in got]
                  == [answer_fields(a) for a in want],
                  f"{what} sequential RPC {i} (node {i % RING_NODES}) "
                  f"differs from the serial engine")
            n += len(rpc)
        log(f"phase 12 {what} sequential: {n} answers = the serial engine")
    node_of = lambda i: i % RING_NODES  # noqa: E731
    fwd = {}
    for what, rpcs, outs in (("12a seq", r["seq_a"], r["seq_a_out"]),
                             ("12a burst", r["burst_a"], r["burst_a_out"]),
                             ("12b seq", r["seq_b"], r["seq_b_out"]),
                             ("12b burst", r["burst_b"], r["burst_b_out"])):
        fwd[what] = (check_owner_metadata(nodes, addrs, node_of, rpcs, outs,
                                          what),
                     sum(len(rpc) for rpc in rpcs))
    keys_a = check_admitted(r["burst_a"], r["burst_a_out"], r["probe_a"],
                            "12a burst")
    keys_b = check_admitted(r["burst_b"], r["burst_b_out"], r["probe_b"],
                            "12b burst")
    # no regular key resident in a router but its owner's
    keys = {q.hash_key() for part in ("seq_a", "burst_a", "seq_b",
                                      "burst_b") for rpc in r[part]
            for q in rpc}
    owner = {k: ring_owner(nodes, k) for k in keys}
    resident = 0
    for i, n in enumerate(nodes):
        fps = set()
        for shard in range(SHARDS):
            fps |= set(int(x) for x in n.engine.native.export_keys(shard)[0])
        stray = [k for k in keys if owner[k] != addrs[i]
                 and _fnv1a64(k.encode("utf-8")) in fps]
        check(not stray, f"node {i} holds rows of keys it does not own: "
              f"{stray[:5]}")
        resident += len(fps)
    # 12c: the probes agree; replica rows = owner rows = the serial replay
    probes = r["gprobe"]
    check(probes[0] == probes[1] == probes[2],
          "12c: the nodes' GLOBAL probes differ")
    hits = {}
    for rpc in r["glob"]:
        oracle.process(rpc, now=t)
        for q in rpc:
            hits[q.hash_key()] = hits.get(q.hash_key(), 0) + q.hits
    gplanes = [[p.cpu().numpy() for p in n.engine.gstate] for n in nodes]
    oplanes = [p.cpu().numpy() for p in oracle.gstate]
    unwritten = 0
    for k in r["gkeys"]:
        host = ring_owner(nodes, k)
        o = addrs.index(host)
        row = lambda i, slot: [int(p[slot]) for p in gplanes[i]]  # noqa: E731
        own = row(o, nodes[o].engine.gtable.peek(k))
        want = [int(p[oracle.gtable.peek(k)]) for p in oplanes]
        check(own == want, f"12c: the owner's row of {k} {own} != the "
              f"serial replay's {want}")
        if not hits[k]:
            # no item of the key carried a hit: a zero sum writes no row
            # (the JAX kernel's rule), so the owner's row stays as the
            # reset left it and the replicas hold the broadcast's fresh
            # status; the probes above agree on it
            unwritten += 1
            continue
        for i, n in enumerate(nodes):
            if i != o:
                check(row(i, n.engine.gtable.peek(k)) == own,
                      f"12c: node {i}'s replica row of {k} != its owner's")
    c = r["counts"]
    check(all(d > 0 for d in c.drains),
          f"drain_compact did not launch on every node: {c.drains}")
    check(sum(g["owner"] for g in c.glob) > 0
          and sum(g["replica"] for g in c.glob) > 0
          and sum(g["upsert"] for g in c.glob) > 0
          and all(sum(g.values()) > 0 for g in c.glob),
          f"global_window did not run owner windows, replica reads and "
          f"upserts on every node: {c.glob}")
    return dict(fwd=fwd, keys_a=keys_a, keys_b=keys_b, resident=resident,
                gkeys=len(r["gkeys"]), unwritten=unwritten)


def report_ring(r, chk, counts, smi):
    """Phase 12's line and its figures line."""
    st = r["fwd_counts"]
    rtt = np.asarray(st["rtt_ms"]) if st["rtt_ms"] else np.zeros(1)
    import importlib.util
    sat = r["sat"]
    share = {k: f / n for k, (f, n) in chk["fwd"].items()}

    def importable(m):
        try:
            return importlib.util.find_spec(m) is not None
        except ImportError:  # a missing parent package
            return False
    installed = {m: importable(m) for m in ("google.protobuf", "grpc")}
    fig = dict(
        decisions_per_s=dict(per_item=sat["a"][0], bytes_lane=sat["b"][0]),
        decisions_per_s_profiled=dict(per_item=sat["a"][1],
                                      bytes_lane=sat["b"][1]),
        idle_share=dict(per_item=None if sat["a"][2] is None
                        else 1 - sat["a"][2],
                        bytes_lane=None if sat["b"][2] is None
                        else 1 - sat["b"][2]),
        forwarded_share=share,
        forward_rtt_ms=dict(p50=float(np.percentile(rtt, 50)),
                            p99=float(np.percentile(rtt, 99)),
                            calls=len(st["rtt_ms"])),
        peer_calls=dict(items=st["item_calls"], raw=st["raw_calls"],
                        codec=st["codec_calls"], installed=installed),
        global_=dict(broadcasts=r["g_broadcasts"], upserts=r["g_upserts"],
                     keys=chk["gkeys"]),
        per_node=dict(drains=r["counts"].drains, global_windows=r[
            "counts"].glob, qos_window=r["cwnd"]),
        rpc_bytes=[min(r["rpc_bytes"]), max(r["rpc_bytes"])],
        phase_wall_s=r["wall_s"])
    log(f"phase 12 the peer ring ({RING_NODES} Instances of {SHARDS} x "
        f"{FULL_CAPACITY // SHARDS} slots on one card, QoS at the JAX "
        f"defaults): 12a per-item {sat['a'][0]:.1f} decisions/s at "
        f"saturation, 12b bytes lane {sat['b'][0]:.1f}; forwarded "
        + ", ".join(f"{k} {v:.3f}" for k, v in share.items())
        + f"; forward round trip p50 {fig['forward_rtt_ms']['p50']:.3f} ms "
        f"p99 {fig['forward_rtt_ms']['p99']:.3f} ms over "
        f"{len(st['rtt_ms'])} calls; sequential parts = the serial engine, "
        f"owners = the ring, {chk['keys_a']} + {chk['keys_b']} burst keys' "
        f"admitted hits = their owners' rows, no stray row in "
        f"{chk['resident']} resident; 12c {RING_GLOBAL} GLOBAL items over "
        f"{chk['gkeys']} keys: {r['g_broadcasts']} broadcasts, "
        f"{r['g_upserts']} upserts, probes equal on every node, replica "
        f"rows = owner rows = the serial replay ({chk['unwritten']} keys "
        f"with no hit unwritten on their owners); {r['wall_s']:.1f} s; "
        f"launches {counts}; {smi}")
    log("ring figures: " + json.dumps(dict(card=smi, **fig)))


# ------------------------------- phase 13: failure handling and migration

# Founders and joiner of 13a's ring: with one ring point a host (crc32 of
# the address), the joiner's point takes 0.228 of the key space, all of
# it from the third founder.
MIG_FOUNDERS = ("10.0.1.4:81", "10.0.4.22:81", "10.0.6.31:81")
MIG_JOINER = "10.0.0.14:81"
MIG_KEYS = 1 << 18          # regular keys seeded on their owners
MIG_GLOBAL = 2048           # GLOBAL keys seeded on their owners
MIG_LEASES = 512            # CONCURRENCY acquires whose lease rows travel
MIG_SEED_WINDOW = 1000      # requests a seeding window of an owner's engine
MIG_SAMPLE = 16384          # kept keys asked after the grow; 13c's sample
MIG_HINTED = 64             # the killed node's GLOBAL keys hinted in 13c
MIG_GROUP = 8192            # items a concurrent group (one admission bound)
MIG_DURATION = 600_000      # nothing expires during the phase
MIG_GLOBAL_LIMIT = 1_000_000
FAULT_RPCS = 256            # 13d's RPCs a round, 100 items each


def mig_engine_config():
    """Phase 12's geometry on the Python slot tables, which migration
    needs (the native router keeps fingerprints, not key strings)."""
    return EngineConfig(capacity_per_shard=FULL_CAPACITY // SHARDS,
                        num_shards=SHARDS, batch_per_shard=FULL_LANES,
                        use_native=False)


def mig_request(idx, hits):
    """Regular key idx: token or leaky by parity, in the compact ranges."""
    return RateLimitReq(name=f"m{idx % 80}", unique_key=f"mk{idx:07d}",
                        hits=hits, limit=20 + idx % 50, duration=MIG_DURATION,
                        algorithm=int(idx & 1))


def mig_global_request(idx, hits):
    return RateLimitReq(name="mg", unique_key=f"g{idx:05d}", hits=hits,
                        limit=MIG_GLOBAL_LIMIT, duration=MIG_DURATION,
                        algorithm=int(idx & 1), behavior=Behavior.GLOBAL)


def mig_lease_request(idx):
    return RateLimitReq(name="ml", unique_key=f"l{idx:04d}", hits=1, limit=8,
                        duration=MIG_DURATION,
                        algorithm=Algorithm.CONCURRENCY)


def mig_nodes():
    """Phase 13's four Instances (the founders and the joiner), each on
    the Python tables at phase 12's geometry, QoS at the JAX defaults,
    reaching the others through RingLoopback; built and warmed before the
    counts start.  Returns ({address: Instance}, stats)."""
    stats = dict(item_calls=0, raw_calls=0, items=0, codec_calls=0,
                 broadcasts=0, upserts=0, rtt_ms=[], transfers=[],
                 dead=set())
    nodes = {}
    for addr in MIG_FOUNDERS + (MIG_JOINER,):
        # the GLOBAL managers send when the script says (13c's hints)
        nodes[addr] = Instance(
            engine_config=mig_engine_config(), advertise_address=addr,
            behaviors=BehaviorConfig(global_sync_wait=3600.0),
            peer_transport=(lambda host, me=addr: RingLoopback(
                nodes[host], me, stats)))
    for n in nodes.values():
        check(n.engine.native is None and n.batcher.pipeline is None
              and n.qos is not None,
              "a migration node is not on the Python tables with QoS")
        n.engine.warmup()
    torch.cuda.synchronize()
    return nodes, stats


async def mig_join(nodes, hosts):
    from gubernator_tpu_torch.config import PeerInfo
    for h in hosts:
        await nodes[h].set_peers([PeerInfo(address=a, is_owner=(a == h))
                                  for a in hosts])


def mig_pin(nodes, now):
    for n in nodes.values():
        n.batcher.now_fn = lambda: now


def mig_rpcs(reqs):
    return [reqs[i:i + SERVE_RPC] for i in range(0, len(reqs), SERVE_RPC)]


async def mig_ask(insts, rpcs, client_id=None):
    """RPCs round-robin over `insts` through Instance.get_rate_limits, in
    concurrent groups of at most MIG_GROUP items (no node's admission
    queue can fill, so nothing is shed); the answers per RPC."""
    out, i, turn = [], 0, 0
    while i < len(rpcs):
        j, n = i, 0
        while j < len(rpcs) and n + len(rpcs[j]) <= MIG_GROUP:
            n += len(rpcs[j])
            j += 1
        out += await asyncio.gather(*(
            insts[(turn + k) % len(insts)].get_rate_limits(
                rpcs[i + k], client_id=client_id)
            for k in range(j - i)))
        turn += j - i
        i = j
    return out


class MigTimer:
    """The engine-thread work of the migrations, per node and kind: on a
    source the quiesced export (local_keys, global_keys, export_rows,
    export_global_rows) and remove_keys, on a destination import_rows and
    import_global_rows; and the payload encode (state/migrate.py
    encode_rows, on the loop).  remove() puts them back."""

    KINDS = (("local_keys", "export"), ("global_keys", "export"),
             ("export_rows", "export"), ("export_global_rows", "export"),
             ("remove_keys", "remove"), ("import_rows", "import"),
             ("import_global_rows", "import"))

    def __init__(self, nodes):
        from gubernator_tpu_torch.state import migrate
        self.nodes, self.migrate = nodes, migrate
        self.secs, self.longest = {}, {}
        for addr, n in nodes.items():
            for name, kind in self.KINDS:
                setattr(n.engine, name,
                        self._timed(addr, kind, getattr(n.engine, name)))
        self.encode = migrate.encode_rows
        migrate.encode_rows = self._timed("loop", "encode", self.encode)

    def _timed(self, addr, kind, fn):
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                dt = time.perf_counter() - t0
                k = (addr, kind)
                self.secs[k] = self.secs.get(k, 0.0) + dt
                self.longest[k] = max(self.longest.get(k, 0.0), dt)
        return timed

    def take(self):
        """The seconds by kind since the last take, the longest single
        engine-thread call of a source and of a destination."""
        by_kind, pause = {}, {"source": 0.0, "destination": 0.0}
        for (addr, kind), t in self.secs.items():
            by_kind[kind] = by_kind.get(kind, 0.0) + t
            side = "destination" if kind == "import" else "source"
            if kind != "encode":
                pause[side] = max(pause[side], self.longest[(addr, kind)])
        self.secs, self.longest = {}, {}
        return by_kind, pause

    def remove(self):
        for n in self.nodes.values():
            for name, _ in self.KINDS:
                delattr(n.engine, name)
        self.migrate.encode_rows = self.encode


def mig_where(nodes, keys):
    """key -> the addresses whose regular tables hold it."""
    from gubernator_tpu_torch.core.engine import shard_of
    out = {}
    for addr, n in nodes.items():
        tables = n.engine.tables
        for k in keys:
            if k in tables[shard_of(k, SHARDS)]:
                out.setdefault(k, []).append(addr)
    return out


async def mig_move(nodes, timer, stats, movers, old, new):
    """Run migrate_keys(old, new) on each of `movers` in turn; its totals,
    the wall time, the transfers' bytes and seconds, and the time split."""
    t0 = time.perf_counter()
    n0 = len(stats["transfers"])
    totals = [await nodes[a].migrate_keys(list(old), list(new))
              for a in movers]
    wall = time.perf_counter() - t0
    tr = stats["transfers"][n0:]
    by_kind, pause = timer.take()
    moved = sum(t["moved"] for t in totals)
    gmoved = sum(t["gmoved"] for t in totals)
    return dict(totals=totals, moved=moved, gmoved=gmoved, wall_s=wall,
                payload_bytes=sum(b for _, _, b, _ in tr),
                transfer_s=sum(s for _, _, _, s in tr), transfers=len(tr),
                export_s=by_kind.get("export", 0.0),
                encode_s=by_kind.get("encode", 0.0),
                import_s=by_kind.get("import", 0.0),
                remove_s=by_kind.get("remove", 0.0),
                rows_per_s=(moved + gmoved) / wall if wall > 0 else None,
                pause_s=pause)


def phase_migration():
    """Phase 13a-13c, the counted part: four Instances on the Python
    tables (phase 12's geometry) over RingLoopback, the founders joined.
    Seeds MIG_KEYS regular keys (1-3 hits each) and MIG_GLOBAL GLOBAL
    keys through each owner's engine in MIG_SEED_WINDOW-request windows,
    and MIG_LEASES CONCURRENCY acquires through the first founder.  13a:
    the joiner joins and the founders run migrate_keys; every moved key,
    and a MIG_SAMPLE sample of kept keys, takes one more hit through
    Instance.get_rate_limits.  13b: the joiner leaves through the daemon's
    handoff step (Daemon._handoff_keys: migrate_keys(all, survivors)), the
    survivors re-join without it, and every key it held takes one more
    hit.  13c: the third founder's loopback fails; the first founder's
    GLOBAL hits for MIG_HINTED keys it owns are hinted; HeartbeatMonitors
    on the other two, stepped by probe_once, confirm it down and re-home;
    a sample of its keys and of the others' takes a hit; then it heals,
    is confirmed up, re-homed back, and the hints replay.  The clock is
    pinned; the serial engines replay it all after the counts are read
    (check_migration)."""
    from gubernator_tpu_torch.config import DaemonConfig, HealthConfig
    from gubernator_tpu_torch.daemon import Daemon
    from gubernator_tpu_torch.net.health import DOWN, UP, HeartbeatMonitor
    from gubernator_tpu_torch.parallel.router import ConsistentHashRing
    from gubernator_tpu_torch.state import migrate
    t_phase = time.perf_counter()
    rng = np.random.default_rng(1313)
    nodes, stats = mig_nodes()
    founders, joiner = list(MIG_FOUNDERS), MIG_JOINER
    grown = founders + [joiner]
    ring = ConsistentHashRing()
    for a in founders:
        ring.add(a, a)
    seed = [mig_request(i, int(h)) for i, h in
            enumerate(rng.integers(1, 4, MIG_KEYS))]
    gseed = [mig_global_request(i, 1 + i % 3) for i in range(MIG_GLOBAL)]
    leases = [mig_lease_request(i) for i in range(MIG_LEASES)]
    t_pin = millisecond_now()
    out = dict(nodes=nodes, t_pin=t_pin, seed=seed, gseed=gseed,
               leases=leases)

    async def script():
        await mig_join(nodes, founders)
        mig_pin(nodes, t_pin)
        timer = MigTimer(nodes)
        reset_counts()
        try:
            # seeding on the owners, in windows through their engines
            t0 = time.perf_counter()
            for reqs in (seed, gseed):
                by_owner = {}
                for r in reqs:
                    by_owner.setdefault(ring.get(r.hash_key()), []).append(r)
                for a, rs in by_owner.items():
                    eng = nodes[a].engine
                    for b in range(0, len(rs), MIG_SEED_WINDOW):
                        await nodes[a]._quiesced(
                            lambda c=rs[b:b + MIG_SEED_WINDOW], e=eng:
                            e.process(c, now=t_pin))
            out["lease_out"] = await mig_ask(
                [nodes[founders[0]]], mig_rpcs(leases), client_id="mig")
            out["seed_s"] = time.perf_counter() - t0
            timer.take()

            # 13a: grow 3 -> 4
            keys = [r.hash_key() for r in seed]
            lkeys = [r.hash_key() for r in leases]
            gkeys = [r.hash_key() for r in gseed]
            moved = migrate.ownership_diff(keys, founders, grown)
            gmoved = migrate.ownership_diff(gkeys, founders, grown)
            lmoved = migrate.ownership_diff(lkeys, founders, grown)
            out["dests"] = sorted(set(moved) | set(gmoved) | set(lmoved))
            moved = moved.get(joiner, [])
            gmoved = gmoved.get(joiner, [])
            lmoved = lmoved.get(joiner, [])
            mset = set(moved + lmoved)
            kept = [k for k in keys if k not in mset]
            sample = sorted(rng.choice(len(kept), MIG_SAMPLE, replace=False))
            kept_sample = [kept[int(i)] for i in sample]
            owner0 = {k: ring.get(k) for k in moved + lmoved + kept_sample}
            out["src_rows"] = {}
            out["src_grows"] = {}
            for a in founders:
                mine = [k for k in moved + lmoved if owner0[k] == a]
                out["src_rows"].update(
                    (r["key"], r) for r in nodes[a].engine.export_rows(mine))
                out["src_grows"].update(
                    (r["key"], r) for r in
                    nodes[a].engine.export_global_rows(gmoved))
            # an owner's book holds its keys' lease rows (an entry node's
            # book also holds rows of the keys it forwarded: they stay)
            out["src_leases"] = sorted(
                row for k in lmoved
                for row in nodes[owner0[k]].leases.export_rows([k]))
            from gubernator_tpu_torch.core.engine import shard_of
            slot0 = {k: nodes[owner0[k]].engine.tables[
                shard_of(k, SHARDS)].peek(k) for k in kept_sample}
            timer.take()
            await mig_join(nodes, grown)
            out["grow"] = await mig_move(nodes, timer, stats, founders,
                                         founders, grown)
            jn = nodes[joiner]
            out["moved"], out["gmoved"], out["lmoved"] = moved, gmoved, lmoved
            out["where_a"] = mig_where(nodes, moved + lmoved + kept_sample)
            out["slot_a"] = {k: nodes[owner0[k]].engine.tables[
                shard_of(k, SHARDS)].peek(k) for k in kept_sample}
            out["slot0"] = slot0
            out["owner0"] = owner0
            out["dst_rows"] = {r["key"]: r for r in
                               jn.engine.export_rows(moved + lmoved)}
            out["dst_gkeys"] = set(jn.engine.global_keys())
            out["dst_grows"] = {r["key"]: r for r in
                                jn.engine.export_global_rows(gmoved)}
            out["dst_leases"] = sorted(jn.leases.export_rows(lmoved))
            out["src_left_leases"] = sorted(
                row for k in lmoved
                for row in nodes[owner0[k]].leases.export_rows([k]))
            by_key = {r.hash_key(): r for r in seed + leases}
            again_a = [RateLimitReq(**{**vars(by_key[k]), "hits": 1})
                       for k in moved + lmoved + kept_sample]
            t0 = time.perf_counter()
            out["again_a"] = mig_rpcs(again_a)
            out["again_a_out"] = await mig_ask(
                [nodes[a] for a in grown], out["again_a"], client_id="mig")
            out["ask_a_s"] = time.perf_counter() - t0

            # 13b: shrink 4 -> 3 through the daemon's handoff step
            held = [k for k in jn.engine.local_keys()]
            d = Daemon(DaemonConfig())
            d.conf.drain_timeout = 600.0
            d.instance = jn
            t0 = time.perf_counter()
            n0 = len(stats["transfers"])
            await d._handoff_keys()
            out["handoff_phases"] = list(d.shutdown_phases)
            tr = stats["transfers"][n0:]
            by_kind, pause = timer.take()
            wall = time.perf_counter() - t0
            out["shrink"] = dict(
                moved=len(held), wall_s=wall, transfers=len(tr),
                payload_bytes=sum(b for _, _, b, _ in tr),
                transfer_s=sum(s for _, _, _, s in tr),
                export_s=by_kind.get("export", 0.0),
                encode_s=by_kind.get("encode", 0.0),
                import_s=by_kind.get("import", 0.0),
                remove_s=by_kind.get("remove", 0.0),
                rows_per_s=len(held) / wall if wall > 0 else None,
                pause_s=pause)
            await mig_join(nodes, founders)
            out["held"] = held
            out["joiner_left"] = jn.engine.local_keys()
            out["where_b"] = mig_where(
                {a: nodes[a] for a in founders}, held)
            again_b = [RateLimitReq(**{**vars(by_key[k]), "hits": 1})
                       for k in held]
            t0 = time.perf_counter()
            out["again_b"] = mig_rpcs(again_b)
            out["again_b_out"] = await mig_ask(
                [nodes[a] for a in founders], out["again_b"],
                client_id="mig")
            out["ask_b_s"] = time.perf_counter() - t0

            # 13c: kill and heal the third founder
            victim, survivors = founders[2], founders[:2]
            vkeys = [k for k in keys if ring.get(k) == victim]
            okeys = [k for k in keys if ring.get(k) != victim]
            hinted = [k for k in gkeys if ring.get(k) == victim][:MIG_HINTED]
            gby = {r.hash_key(): r for r in gseed}
            conf = HealthConfig(suspect_after=2, recover_after=2)
            mons = []
            for a in survivors:
                nodes[a].monitor = HeartbeatMonitor(nodes[a], founders,
                                                    conf=conf)
                mons.append(nodes[a].monitor)
            await asyncio.gather(*(m.probe_once() for m in mons))
            t_kill = time.perf_counter()
            stats["dead"].add(victim)
            gm = nodes[survivors[0]].global_mgr
            for k in hinted:
                gm.queue_hit(RateLimitReq(**{**vars(gby[k]), "hits": 2}))
            await gm._send_hits()
            out["hints_pending"] = gm.hints.pending(victim)
            rounds = 0
            while rounds < 10 and not all(
                    m.snapshot()["peers"][victim]["state"] == DOWN
                    for m in mons):
                for m in mons:
                    await m.probe_once()
                rounds += 1
            out["rounds_down"] = rounds
            out["rings_down"] = [sorted(p.host for p in
                                        nodes[a].peer_list())
                                 for a in survivors]
            out["kill_to_converged_s"] = time.perf_counter() - t_kill
            pick = lambda ks: [ks[int(i)] for i in sorted(  # noqa: E731
                rng.choice(len(ks), MIG_SAMPLE // 2, replace=False))]
            vsample, osample = pick(vkeys), pick(okeys)
            out["vsample"], out["osample"] = vsample, osample
            cold = [RateLimitReq(**{**vars(by_key[k]), "hits": 1})
                    for k in vsample + osample]
            out["cold"] = mig_rpcs(cold)
            out["cold_out"] = await mig_ask(
                [nodes[a] for a in survivors], out["cold"], client_id="mig")
            stats["dead"].discard(victim)
            t_heal = time.perf_counter()
            rounds = 0
            while rounds < 10 and not all(
                    m.snapshot()["peers"][victim]["state"] == UP
                    for m in mons):
                for m in mons:
                    await m.probe_once()
                rounds += 1
            out["rounds_up"] = rounds
            out["rings_up"] = [sorted(p.host for p in nodes[a].peer_list())
                               for a in survivors]
            out["heal_to_converged_s"] = time.perf_counter() - t_heal
            out["hints_after"] = (gm.hints.pending(victim),
                                  gm.hints.replayed.get(victim, 0))
            await gm._send_hits()
            for m in mons:
                await m.stop()
            out["where_c"] = mig_where(nodes, vsample)
            out["hinted"] = hinted
            out["victim"] = victim
            vn = nodes[victim]
            out["hinted_rows"] = {k: [int(p[vn.engine.gtable.peek(k)])
                                      for p in vn.engine.gstate]
                                  for k in hinted}
            back = [RateLimitReq(**{**vars(by_key[k]), "hits": 1})
                    for k in vsample]
            out["back"] = mig_rpcs(back)
            out["back_out"] = await mig_ask(
                [nodes[a] for a in founders], out["back"], client_id="mig")
            torch.cuda.synchronize()
        finally:
            timer.remove()
            for n in nodes.values():
                n.close()

    asyncio.run(script())
    out["stats"] = stats
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def _answers(outs):
    return [answer_fields(a) for rpc in outs for a in rpc]


def check_migration(r):
    """Phase 13a-13c's checks, after its counts are read.  A serial
    Python-table engine on the card replays, at the same pinned clock and
    in the same order, every request the phase decided (the seed, the
    lease acquires, 13a's and 13b's hits, 13c's hits on keys the survivors
    owned, the hits after the heal, the hinted GLOBAL hits); a cold engine
    answers 13c's hits on the killed node's keys, which restart there."""
    t = r["t_pin"]
    serial = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                             num_shards=SHARDS, batch_per_shard=FULL_LANES)
    cold = RateLimitEngine(capacity_per_shard=1 << 16, num_shards=SHARDS,
                           batch_per_shard=FULL_LANES)

    def replay(eng, reqs):
        outs = []
        for b in range(0, len(reqs), MIG_SEED_WINDOW):
            outs += eng.process(reqs[b:b + MIG_SEED_WINDOW], now=t)
        return [answer_fields(a) for a in outs]

    replay(serial, r["seed"])
    replay(serial, r["gseed"])
    lease_want = replay(serial, r["leases"])
    check(_answers(r["lease_out"]) == lease_want,
          "13: the lease acquires differ from the serial engine")
    # 13a: who moved where, rows bit for bit, answers
    n_moved = len(r["moved"]) + len(r["lmoved"])
    share = n_moved / (MIG_KEYS + MIG_LEASES)
    check(0.2 <= share <= 0.3, f"13a: {share:.3f} of the keys moved")
    check(r["dests"] == [MIG_JOINER],
          f"13a: keys moved to {r['dests']}, not only to the joiner")
    g = r["grow"]
    check(g["moved"] == n_moved and g["gmoved"] == len(r["gmoved"]),
          f"13a: migrate_keys moved {g['moved']} + {g['gmoved']}, the "
          f"ring diff says {n_moved} + {len(r['gmoved'])}")
    where = r["where_a"]
    check(all(where.get(k) == [MIG_JOINER]
              for k in r["moved"] + r["lmoved"]),
          "13a: a moved key does not live on the joiner alone")
    check(all(where.get(k) == [r["owner0"][k]] and
              r["slot_a"][k] == r["slot0"][k] for k in r["slot0"]),
          "13a: a kept key moved or changed its slot")
    check(r["dst_rows"] == r["src_rows"]
          and len(r["dst_rows"]) == n_moved,
          "13a: a moved key's row on the joiner differs from its source "
          "row before the move")
    check(set(r["gmoved"]) <= r["dst_gkeys"]
          and r["dst_grows"] == r["src_grows"] and r["gmoved"],
          "13a: a moved GLOBAL key is not registered on the joiner with "
          "its source row")
    check(r["dst_leases"] == r["src_leases"] and r["src_leases"]
          and not r["src_left_leases"],
          "13a: the moved keys' lease rows did not move with them")
    want = replay(serial, [q for rpc in r["again_a"] for q in rpc])
    check(_answers(r["again_a_out"]) == want,
          "13a: answers after the grow differ from the serial engine")
    # 13b
    check(r["handoff_phases"] == ["handoff"] and not r["joiner_left"]
          and sorted(r["held"]) == sorted(r["moved"] + r["lmoved"]),
          f"13b: the handoff left {len(r['joiner_left'])} keys on the "
          f"joiner (phases {r['handoff_phases']})")
    check(all(len(r["where_b"].get(k, ())) == 1 for k in r["held"]),
          "13b: a handed-off key is not on exactly one survivor")
    want = replay(serial, [q for rpc in r["again_b"] for q in rpc])
    check(_answers(r["again_b_out"]) == want,
          "13b: answers after the shrink differ from the serial engine")
    # 13c
    check(r["hints_pending"] == len(r["hinted"]) > 0,
          f"13c: {r['hints_pending']} hints for {len(r['hinted'])} keys")
    survivors = sorted(MIG_FOUNDERS[:2])
    check(r["rounds_down"] == 2 and r["rings_down"] == [survivors] * 2,
          f"13c: DOWN after {r['rounds_down']} rounds, rings "
          f"{r['rings_down']}")
    got = _answers(r["cold_out"])
    check(all(a[4] == "" for a in got), "13c: an answer carries an error")
    nv = len(r["vsample"])
    vreqs = [q for rpc in r["cold"] for q in rpc][:nv]
    oreqs = [q for rpc in r["cold"] for q in rpc][nv:]
    check(got[:nv] == replay(cold, vreqs),
          "13c: the killed node's keys did not restart cold")
    check(got[nv:] == replay(serial, oreqs),
          "13c: the survivors' keys differ from the serial engine")
    check(r["rounds_up"] == 2
          and r["rings_up"] == [sorted(MIG_FOUNDERS)] * 2
          and r["hints_after"] == (0, len(r["hinted"])),
          f"13c: UP after {r['rounds_up']} rounds, rings {r['rings_up']}, "
          f"hints (pending, replayed) {r['hints_after']}")
    check(all(r["where_c"].get(k) == [r["victim"]] for k in r["vsample"]),
          "13c: a key of the healed node lives elsewhere too")
    # the outage rows tie on expire (a pinned clock): the healed node
    # keeps its own, so its keys answer as if the outage never happened
    check(_answers(r["back_out"])
          == replay(serial, [q for rpc in r["back"] for q in rpc]),
          "13c: the healed node's keys differ from the serial engine")
    gby = {q.hash_key(): q for q in r["gseed"]}
    replay(serial, [RateLimitReq(**{**vars(gby[k]), "hits": 2})
                    for k in r["hinted"]])
    planes = [p.cpu().numpy() for p in serial.gstate]
    for k in r["hinted"]:
        want = [int(p[serial.gtable.peek(k)]) for p in planes]
        check(r["hinted_rows"][k] == want,
              f"13c: the owner's row of {k} {r['hinted_rows'][k]} != an "
              f"uninterrupted run's {want}")
    return dict(share=share, n_moved=n_moved, answers_a=len(r["again_a_out"])
                * SERVE_RPC, answers_b=len(r["again_b_out"]) * SERVE_RPC,
                cold=len(got))


def report_migration(r, chk, counts, smi):
    """Phase 13a-13c's line and its figures line."""
    def fig(m):
        return {k: (v if not isinstance(v, float) else float(f"{v:.6g}"))
                for k, v in m.items() if k != "totals"}
    leases = len(r["dst_leases"])
    figures = dict(
        grow=dict(fig(r["grow"]), lease_rows=leases),
        shrink=fig(r["shrink"]),
        detector=dict(rounds_down=r["rounds_down"], rounds_up=r["rounds_up"],
                      kill_to_converged_s=r["kill_to_converged_s"],
                      heal_to_converged_s=r["heal_to_converged_s"]),
        seed_s=r["seed_s"], ask_grow_s=r["ask_a_s"],
        ask_shrink_s=r["ask_b_s"], launches=counts,
        phase_wall_s=r["wall_s"])
    g, s = r["grow"], r["shrink"]
    log(f"phase 13 failure handling and migration (4 Instances of "
        f"{SHARDS} x {FULL_CAPACITY // SHARDS} slots on the Python tables, "
        f"one card): 13a grow 3 -> 4 moved {g['moved']} regular keys "
        f"({chk['share']:.3f} of {MIG_KEYS + MIG_LEASES}), {g['gmoved']} "
        f"GLOBAL, {leases} lease rows in {g['payload_bytes']} payload bytes, "
        f"{g['wall_s']:.3f} s (export {g['export_s']:.3f}, encode "
        f"{g['encode_s']:.3f}, transfer with import {g['transfer_s']:.3f}, "
        f"remove {g['remove_s']:.3f}), rows bit for bit, "
        f"{chk['answers_a']} answers = the serial engine; 13b shrink moved "
        f"{s['moved']} keys in {s['wall_s']:.3f} s, {chk['answers_b']} "
        f"answers = the serial engine; 13c DOWN in {r['rounds_down']} "
        f"rounds, converged {r['kill_to_converged_s']:.3f} s after the "
        f"kill, {chk['cold']} answers with no error (the killed node's "
        f"keys cold), UP in {r['rounds_up']} rounds, {len(r['hinted'])} "
        f"hinted GLOBAL keys = an uninterrupted run; {r['wall_s']:.1f} s; "
        f"launches {counts}; {smi}")
    log("migration figures: " + json.dumps(dict(card=smi, **figures)))


def phase_dispatch_fault():
    """Phase 13d, the counted part: phase 8's Instance (the router, the
    pipelined lane at depth 3, QoS at the JAX defaults, the occupancy gate
    off) on a pinned clock; one engine_dispatch rule (drop=1.0, times=1),
    then FAULT_RPCS serialized 100-item RPCs of distinct compact keys from
    64 callers through serve_get_rate_limits: exactly one drain's RPCs
    fail.  Then every RPC once more, and FAULT_RPCS // 4 new ones."""
    from gubernator_tpu_torch.net.faults import FAULTS, SEAM_ENGINE_DISPATCH
    inst = Instance(engine_config=serving_engine_config())
    check(inst.engine.native is not None and inst.batcher.pipeline is not None
          and inst.batcher.pipeline.depth == 3,
          "13d: the Instance lacks the router or the depth-3 pipeline")
    inst.engine.warmup()
    torch.cuda.synchronize()
    t_pin = millisecond_now()
    pin_clock(inst, t_pin)
    inst.batcher.pipeline.gate_enabled = False
    reqs = [wire_request(i, "fault", 1 + i % 3)
            for i in range(FAULT_RPCS * 5 // 4 * SERVE_RPC)]
    rpcs = mig_rpcs(reqs)
    first = rpcs[:FAULT_RPCS]
    again = first + rpcs[FAULT_RPCS:]
    data = {id(rpc): encode_list([vars(q) for q in rpc], REQ_FIELDS)
            for rpc in rpcs}
    ctx = WireContext()
    out = dict(t_pin=t_pin, first=first, again=again)

    async def serve(rpc):
        try:
            return decode_list(await serve_get_rate_limits(
                inst, data[id(rpc)], ctx), RESP_FIELDS)
        except Exception as e:
            return e

    async def script():
        reset_counts()
        FAULTS.seed(13)
        FAULTS.configure(SEAM_ENGINE_DISPATCH, drop=1.0, times=1)
        try:
            outs = [None] * len(first)

            async def caller(c):
                for i in range(c, len(first), SERVE_CLIENTS):
                    outs[i] = await serve(first[i])
            await asyncio.gather(*(caller(c) for c in range(SERVE_CLIENTS)))
            out["first_out"] = outs
            out["fired"] = FAULTS.describe()[SEAM_ENGINE_DISPATCH][0]["fired"]
            out["again_out"] = [await serve(rpc) for rpc in again]
            out["drains"] = inst.batcher.pipeline.drains
            torch.cuda.synchronize()
        finally:
            FAULTS.clear()
            await inst.aclose()

    asyncio.run(script())
    return out


def check_dispatch_fault(r):
    """13d against a serial router engine on the card that never saw the
    failed drain: it replays the first round's answered RPCs, then every
    RPC of the second round (each RPC's keys are its own, so the order
    across RPCs changes no answer)."""
    failed = [i for i, o in enumerate(r["first_out"])
              if isinstance(o, Exception)]
    check(r["fired"] == 1 and failed and len(failed) < len(r["first"]),
          f"13d: the rule fired {r['fired']} times and failed "
          f"{len(failed)} of {len(r['first'])} RPCs")
    check(all("engine_dispatch" in str(r["first_out"][i]) for i in failed),
          "13d: an RPC failed for another reason than the injected fault")
    check(not any(isinstance(o, Exception) for o in r["again_out"]),
          "13d: an RPC after the failed drain failed")
    serial = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                             num_shards=SHARDS, batch_per_shard=FULL_LANES,
                             use_native="on")
    t = r["t_pin"]
    for i, (rpc, got) in enumerate(zip(r["first"], r["first_out"])):
        if i not in failed:
            check([answer_fields(a) for a in got]
                  == [answer_fields(a) for a in serial.process(rpc, now=t)],
                  f"13d: RPC {i} of the first round differs from the "
                  f"serial engine")
    for i, (rpc, got) in enumerate(zip(r["again"], r["again_out"])):
        check([answer_fields(a) for a in got]
              == [answer_fields(a) for a in serial.process(rpc, now=t)],
              f"13d: RPC {i} after the failed drain differs from the "
              f"serial engine")
    return len(failed)


def report_dispatch_fault(r, n_failed, counts, smi):
    log(f"phase 13d a dispatch fault on the pipelined lane (depth 3): one "
        f"engine_dispatch rule failed {n_failed} of {len(r['first'])} "
        f"RPCs, one drain's, each once; {len(r['again'])} RPCs after it = "
        f"a serial engine that never saw the failed drain; "
        f"{r['drains']} drains; launches {counts}; {smi}")


# ------------------------------------------- phase 14: the front door

# phase 14 drives frontdoor.py's hub on phase 9's Instance.  Its workers
# are stand-ins without gRPC (14a: frontdoor_replay.py processes, which
# import no torch and run the worker's own path, _WorkerV1.GetRateLimits:
# batched wire reads, frontdoor_parse_req into the slab, RAW records for
# what the parser refuses, frontdoor_encode_resp on the completions), or
# the real gRPC workers where grpc imports (14b).
FD_WORKERS = 2
FD_SLOTS = 64
FD_SLAB = (1 << 20) + (1 << 16)
FD_BATCH_READS = 8
FD_COLS_DECISIONS = 45_000    # 100-item RPCs of phase 9's law
FD_RAW_RPCS = 3000            # single-item RPCs on keys of their own
FD_RAW_KEYS = 4096
FD_GLOBAL_RPCS = 600          # single GLOBAL items
FD_GLOBAL_KEYS = 256
FD_SAT_RPCS = 512
FD_KILL_AFTER = 0.2           # 14b: the share of a burst before the kill
REPLAY_ENTRY = "gubernator_tpu_torch.frontdoor_replay:replay_main"


def fd_slots():
    """Ring slots a worker: FD_SLOTS, or what half of /dev/shm's free
    space holds for both workers' segments when that is fewer (a segment
    larger than /dev/shm maps, then faults at first touch).  Returns the
    slots and the line that says so."""
    from gubernator_tpu_torch.core.shm_ring import WorkerChannel
    st = os.statvfs("/dev/shm")
    free, size = st.f_bavail * st.f_frsize, st.f_blocks * st.f_frsize
    need = FD_WORKERS * WorkerChannel.segment_size(FD_SLOTS, FD_SLAB)
    slots = FD_SLOTS
    if need > free // 2:
        slots = max(2, FD_SLOTS * (free // 2) // need)
    line = (f"phase 14 /dev/shm: {size} bytes, {free} free; {FD_WORKERS} "
            f"workers x {FD_SLOTS} slots x {FD_SLAB}-byte slabs need {need}"
            + ("" if slots == FD_SLOTS else
               f"; CUT to {slots} slots a worker to fit half the free space"))
    return slots, line


def fd_raw_request(idx, prefix, glob=False):
    """A single-item RPC's request: its key's own, every time (hits 1), so
    two RPCs of one key are interchangeable."""
    return RateLimitReq(
        name="fdg" if glob else "fdr", unique_key=f"{prefix}{idx:06d}",
        hits=1, limit=(1000 if glob else 20) + idx % 50, duration=60_000,
        algorithm=int(idx & 1),
        behavior=Behavior.GLOBAL if glob else Behavior.BATCHING)


def fd_burst(rng, prefix):
    """The pinned burst: phase 9's 100-item RPCs (wire_rpcs), FD_RAW_RPCS
    single-item RPCs on keys of their own (the workers coalesce them into
    batch records, a lone one ships RAW) and FD_GLOBAL_RPCS single GLOBAL
    items (the C parser refuses them: RAW records, the GLOBAL window),
    shuffled.  (requests per RPC, serialized RPCs)."""
    rpcs, _ = wire_rpcs(rng, FD_COLS_DECISIONS)
    rpcs = [[RateLimitReq(**{**vars(q), "unique_key": prefix + q.unique_key})
             for q in rpc] for rpc in rpcs]
    raw = (rng.zipf(1.1, FD_RAW_RPCS) - 1) % FD_RAW_KEYS
    rpcs += [[fd_raw_request(int(i), prefix + "r")] for i in raw]
    glob = (rng.zipf(1.1, FD_GLOBAL_RPCS) - 1) % FD_GLOBAL_KEYS
    rpcs += [[fd_raw_request(int(i), prefix + "g", glob=True)] for i in glob]
    rpcs = [rpcs[i] for i in rng.permutation(len(rpcs))]
    return rpcs, [encode_list([vars(q) for q in rpc], REQ_FIELDS)
                  for rpc in rpcs]


class FrontDoorLog:
    """The order in which one Instance applied a front door's records
    (engine thread): each drain's staged jobs as RPCs (a ColsJob's
    requests read from its slab while it is live and split by its
    record's counts; a ListJob's singles one RPC each), and each
    engine.process call (the legacy lane's GLOBAL windows) as its own
    window, in turn; optionally the time pack_stack_fast took.  remove()
    puts the methods back."""

    def __init__(self, inst, hub, order=True):
        import threading
        self.inst, self.hub, self.lock = inst, hub, threading.Lock()
        self.entries, self.counts, self.bad, self.pack_s = [], {}, 0, 0.0
        pipe, eng, nat = inst.batcher.pipeline, inst.engine, inst.engine.native
        drain, process, dispatch = pipe._drain_sync, eng.process, hub._dispatch
        pack = nat.pack_stack_fast

        def timed_pack(*a, **kw):
            t0 = time.perf_counter()
            rc = pack(*a, **kw)
            self.pack_s += time.perf_counter() - t0
            return rc

        nat.pack_stack_fast = timed_pack
        if not order:
            return

        def logged_dispatch(rec):
            if rec.cols is not None:
                self.counts[id(rec.cols)] = rec.counts or [rec.n]
            return dispatch(rec)

        def logged_drain(jobs, now=None, cols=None):
            from gubernator_tpu_torch.core.pipeline import (
                ColsJob, ListJob, requests_from_cols)
            res = drain(jobs, now, cols)
            for job in res.staged:
                if isinstance(job, ColsJob):
                    reqs = requests_from_cols(job.cols, job.name_lens, job.n)
                    split, at = [], 0
                    for n in self.counts.get(id(job.cols), [job.n]):
                        split.append(reqs[at:at + n])
                        at += n
                    self.entries.append(("drain", split, None))
                elif isinstance(job, ListJob) and job.futs is not None:
                    self.entries.append(("drain", [[q] for q in job.reqs],
                                         None))
                else:
                    self.bad += 1
            return res

        def logged_process(reqs, now=None, accumulate=None):
            out = process(reqs, now, accumulate)
            self.entries.append(("process", [[q] for q in reqs],
                                 accumulate))
            return out

        pipe._drain_sync = logged_drain
        eng.process = logged_process
        hub._dispatch = logged_dispatch

    def remove(self):
        for obj, name in ((self.inst.batcher.pipeline, "_drain_sync"),
                          (self.inst.engine, "process"),
                          (self.hub, "_dispatch"),
                          (self.inst.engine.native, "pack_stack_fast")):
            obj.__dict__.pop(name, None)


def compute_apps():
    """The pids nvidia-smi lists as holding a CUDA context."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True).stdout
    return sorted(int(x) for x in out.split() if x.strip().isdigit())


def maps_cuda(pid):
    """Does process pid map CUDA or torch (its /proc maps)?"""
    try:
        with open(f"/proc/{pid}/maps") as f:
            text = f.read()
    except OSError:
        return None
    return any(s in text for s in ("libcuda", "libtorch", "libcudart"))


async def fd_command(ctl, seq, per_worker):
    from gubernator_tpu_torch import frontdoor_replay as fr
    fr.write_command(ctl, seq, per_worker)
    return await fr.await_results(ctl, seq, len(per_worker))


def fd_split(datas):
    """Each worker's share of a list of RPCs (round robin)."""
    return [datas[w::FD_WORKERS] for w in range(FD_WORKERS)]


def hub_counters(hub, pipe, log_):
    s = hub.stats()
    return dict(pop=hub.pop_s, complete=hub.complete_s,
                pack=log_.pack_s if log_ is not None else 0.0,
                busy=dict(pipe.stage_busy), drains=pipe.drains,
                served=hub.records_served, kinds=dict(hub.records_by_kind),
                encodes=s["encodes"], enc_fallbacks=s["enc_fallbacks"],
                engine_encode_fallbacks=s["engine_encode_fallbacks"],
                stalls=s["stalls"], sheds=s["sheds"],
                batch_rpcs=s["batch_rpcs"], batch_flushes=s["batch_flushes"])


def phase_front_door():
    """Phase 14a, the counted part: phase 9's Instance (8 x 2^21 slots,
    B = 1024, the router, the pipeline and QoS at the JAX defaults) under
    a FrontdoorHub of FD_WORKERS replay workers (FD_SLOTS ring slots each,
    batch reads 8).  A pinned-clock burst of about 50k decisions from 64
    callers (32 a worker) with the engine's order logged; then on the wall
    clock saturation (unprofiled, profiled), open-loop rates at 25/50/100%
    of it, and a saturating run with the host steps timed.  The Instance
    is built and warmed, and the RPCs encoded, before the counts start."""
    import importlib.util
    from gubernator_tpu_torch.core import shm_ring
    from gubernator_tpu_torch.frontdoor import FrontdoorHub
    check(importlib.util.find_spec("google") is not None
          and importlib.util.find_spec("google.protobuf") is not None,
          "14a needs protobuf in the engine process: its RAW records (the "
          "small and GLOBAL RPCs) take the server's protobuf path")
    from gubernator_tpu_torch.observability.metrics import Metrics
    rng = np.random.default_rng(141)
    inst = Instance(engine_config=serving_engine_config(), metrics=Metrics())
    eng, pipe = inst.engine, inst.batcher.pipeline
    check(eng.native is not None and pipe is not None,
          "14a: the router or the pipeline is missing")
    eng.warmup()
    torch.cuda.synchronize()
    burst_rpcs, burst = fd_burst(rng, "fda")
    sat_rpcs, sat = wire_rpcs(rng, FD_SAT_RPCS * SERVE_RPC)
    sat_items = [len(r) for r in sat_rpcs]
    slots, shm_line = fd_slots()
    log(shm_line)
    ctl = tempfile.mkdtemp(prefix="guber-fd-")
    hub = FrontdoorHub(inst, workers=FD_WORKERS, ring_slots=slots,
                       slab_bytes=FD_SLAB, listen_address="127.0.0.1:0",
                       batch_reads=FD_BATCH_READS, worker_entry=REPLAY_ENTRY,
                       worker_args=(ctl,))
    tb = millisecond_now()
    out = dict(burst_rpcs=burst_rpcs, burst=burst, tb=tb, slots=slots,
               engine_pid=os.getpid(), shm=shm_line)
    callers = SERVE_CLIENTS // FD_WORKERS
    reset_counts()

    async def script():
        from torch.profiler import ProfilerActivity, profile
        await hub.start()
        seq = 0
        try:
            out["worker_pids"] = [hub.status.get_w(i, shm_ring.W_PID)
                                  for i in range(FD_WORKERS)]
            pin_clock(inst, tb)
            flog = FrontDoorLog(inst, hub)
            try:
                res = await fd_command(ctl, seq, [
                    dict(mode="burst", rpcs=part, callers=callers)
                    for part in fd_split(burst)])
                seq += 1
                # while the workers live: who holds a CUDA context
                out["apps"] = compute_apps()
                out["worker_maps_cuda"] = [maps_cuda(p)
                                           for p in out["worker_pids"]]
                out["engine_maps_cuda"] = maps_cuda(os.getpid())
            finally:
                flog.remove()
            out["log"], out["log_bad"] = flog.entries, flog.bad
            resps = [None] * len(burst)
            for w in range(FD_WORKERS):
                resps[w::FD_WORKERS] = res[w]["resps"]
            out["burst_out"] = resps
            out["burst_errors"] = sum(r["errors"] for r in res)
            out["burst_sheds"] = [r["sheds"] for r in res]
            out["burst_counters"] = hub_counters(hub, pipe, None)
            pin_clock(inst, None)

            async def command(per_worker):
                nonlocal seq
                res = await fd_command(ctl, seq, per_worker)
                seq += 1
                return res

            async def run(mode, seconds, **kw):
                """Both workers' answers to one timed command: decisions
                answered (no shed item, no failed call), RPCs made,
                failed calls, RPCs with a shed item by reason, and the
                latencies of the RPCs answered whole."""
                res = await command([
                    dict(mode=mode, rpcs=part, items=items,
                         seconds=seconds, **kw)
                    for part, items in zip(fd_split(sat),
                                           fd_split(sat_items))])
                sheds = {}
                for r in res:
                    for k, v in r["sheds"].items():
                        sheds[k] = sheds.get(k, 0) + v
                return dict(n=sum(r["n"] for r in res),
                            wall=max(r["wall"] for r in res),
                            rpcs=sum(r["rpcs"] for r in res),
                            errors=sum(r["errors"] for r in res),
                            sheds=sheds,
                            lat=[x for r in res for x in r.get("lat_ms", ())],
                            res=res)

            await run("saturate", 0.5, callers=callers)  # warm, wall clock
            s1 = await run("saturate", SERVE_SECONDS, callers=callers)
            rate = s1["n"] / s1["wall"]
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                s2 = await run("saturate", SERVE_SECONDS, callers=callers)
                torch.cuda.synchronize()
            out["sat"] = (s1["n"], s1["wall"], s2["n"] / s2["wall"],
                          busy_share(prof, s2["wall"]))
            out["sat_runs"] = [s1, s2]
            out["rates"] = []
            for share in RATE_SHARES:
                stalls0 = hub.stats()["stalls"]
                # an open loop past what the engine answers fills the
                # rings: the RPCs over the slots in flight a worker shed
                # ring_full, and count neither in the rate nor in the
                # latencies
                sr = await run("rate", RATE_SECONDS,
                               rate=share * rate / FD_WORKERS)
                lat = sr["lat"]
                out["rates"].append(dict(
                    share=share, offered=share * rate,
                    achieved=sr["n"] / sr["wall"],
                    p50=float(np.percentile(lat, 50)) if lat else None,
                    p99=float(np.percentile(lat, 99)) if lat else None,
                    rpcs=sr["rpcs"], answered=len(lat), errors=sr["errors"],
                    sheds=sr["sheds"],
                    stalls=hub.stats()["stalls"] - stalls0))
            # the host split: the same saturating load, every step timed
            w0 = sr["res"]  # each worker's parse and encode seconds so far
            tlog = FrontDoorLog(inst, hub, order=False)
            try:
                c0 = hub_counters(hub, pipe, tlog)
                st0 = stage_totals(inst.metrics)
                s3 = await run("saturate", RATE_SECONDS, callers=callers)
                c1 = hub_counters(hub, pipe, tlog)
                out["stage_split"] = stage_split(st0,
                                                 stage_totals(inst.metrics))
            finally:
                tlog.remove()
            out["sat_runs"].append(s3)
            out["split"] = (s3["n"], s3["wall"], c0, c1,
                            sum(r["parse_s"] - w["parse_s"]
                                for r, w in zip(s3["res"], w0)),
                            sum(r["encode_s"] - w["encode_s"]
                                for r, w in zip(s3["res"], w0)))
            for sr in out["sat_runs"]:
                del sr["res"], sr["lat"]
            out["counters"] = hub_counters(hub, pipe, None)
            out["debug"] = hub.debug_snapshot()
        finally:
            from gubernator_tpu_torch import frontdoor_replay as fr
            fr.write_command(ctl, seq, [dict(mode="stop")] * FD_WORKERS)
            await asyncio.sleep(0.1)
            await hub.stop()
            await inst.aclose()

    try:
        asyncio.run(script())
    finally:
        shutil.rmtree(ctl, ignore_errors=True)
    out["adm"] = (inst.qos.admission.pending_peak,
                  inst.qos.admission.max_pending)
    out["pipe"] = rpc_counters(pipe)
    out["eng_cfg"] = (eng.capacity_per_shard, eng.num_shards,
                      eng.batch_per_shard)
    return out


def fd_expected(entries, tb):
    """Replay a FrontDoorLog's entries, in order, through a serial router
    engine on the card at the same geometry and clock (each entry one
    process call, so the GLOBAL windows are cut as the Instance cut
    them): {serialized request: [expected response bytes]}."""
    from collections import defaultdict
    twin = RateLimitEngine(capacity_per_shard=FULL_CAPACITY // SHARDS,
                           num_shards=SHARDS, batch_per_shard=FULL_LANES,
                           use_native="on")
    want = defaultdict(list)
    for _, rpcs, accumulate in entries:
        resps = twin.process([q for rpc in rpcs for q in rpc], tb,
                             accumulate)
        at = 0
        for rpc in rpcs:
            key = encode_list([vars(q) for q in rpc], REQ_FIELDS)
            want[key].append(encode_list(
                [vars(r) for r in resps[at:at + len(rpc)]], RESP_FIELDS))
            at += len(rpc)
    del twin
    return want


def check_front_door(r):
    """Phase 14a, after the counts are read: every burst RPC answered,
    none shed, no job the log could not place; each RPC's response bytes
    equal to what the serial engine answered it in the engine's order
    (RPCs of equal bytes are interchangeable, so they compare as a
    multiset); each RPC staged once; only the engine's process holds a
    CUDA context."""
    from collections import Counter, defaultdict
    check(r["burst_errors"] == 0 and None not in r["burst_out"],
          f"14a: {r['burst_errors']} burst RPCs failed")
    check(not any(r["burst_sheds"]), f"14a: burst sheds {r['burst_sheds']}")
    check(r["log_bad"] == 0, f"14a: {r['log_bad']} staged jobs were neither "
          f"a column record nor singles")
    want = fd_expected(r["log"], r["tb"])
    got = defaultdict(list)
    for data, resp in zip(r["burst"], r["burst_out"]):
        got[data].append(resp)
    check(sum(len(v) for v in want.values()) == len(r["burst"]),
          f"14a: the engine applied {sum(len(v) for v in want.values())} "
          f"RPCs, not each of the {len(r['burst'])} once")
    bad = [k for k in got if Counter(got[k]) != Counter(want.get(k, []))]
    check(not bad, f"14a: {len(bad)} of {len(got)} distinct RPCs answered "
          f"other bytes than the serial engine")
    apps, pids = r["apps"], r["worker_pids"]
    check(not set(pids) & set(apps),
          f"14a: a worker holds a CUDA context (nvidia-smi {apps}, "
          f"workers {pids})")
    check(r["worker_maps_cuda"] == [False] * FD_WORKERS,
          f"14a: a worker maps CUDA or torch: {r['worker_maps_cuda']}")
    # one process holds a context: the engine (a sandbox's nvidia-smi
    # may name it by another pid namespace's number)
    check(len(apps) == 1 and r["engine_maps_cuda"],
          f"14a: nvidia-smi lists {apps} as holding a CUDA context, not "
          f"one process (the engine, pid {r['engine_pid']} here, maps "
          f"CUDA: {r['engine_maps_cuda']})")
    kinds = r["burst_counters"]["kinds"]
    check(kinds.get(0, 0) > 0 and kinds.get(7, 0) > 0,
          f"14a: the burst's records by kind {kinds} lack RAW or batch "
          f"records")
    check(r["adm"][0] < r["adm"][1], f"14a: admission reached {r['adm']}")
    errs = [sr["errors"] for sr in r["sat_runs"]]
    check(not any(errs) and all(sr["n"] > 0 for sr in r["sat_runs"]),
          f"14a: the saturating runs failed {errs} RPCs, answered "
          f"{[sr['n'] for sr in r['sat_runs']]} decisions")
    check(not any(x["errors"] for x in r["rates"]),
          f"14a: the open-loop runs failed "
          f"{[x['errors'] for x in r['rates']]} RPCs")
    return len(got)


def phase_front_door_grpc():
    """Phase 14b, where grpc imports: the hub with its real gRPC workers
    (FD_WORKERS on an ephemeral port) on phase 9's Instance, 64 callers
    (the port's gRPC client) sending a pinned burst of 14a's law, held
    against the serial engine in the engine's order as 14a is; then a
    SIGKILL of one worker
    a share FD_KILL_AFTER into a second burst: each of its RPCs either
    fails or is applied whole, the hub respawns the worker on the same
    port, and a third burst is answered.  Returns None, and the reason,
    where grpc does not import."""
    import importlib.util
    import signal as _signal
    try:
        if importlib.util.find_spec("grpc") is None:
            return None, "grpc is not installed"
        from gubernator_tpu_torch.client import AsyncClient
    except ImportError as e:
        return None, f"the gRPC client does not import ({e})"

    from gubernator_tpu_torch.core import shm_ring
    from gubernator_tpu_torch.frontdoor import FrontdoorHub
    rng = np.random.default_rng(142)
    inst = Instance(engine_config=serving_engine_config())
    # 14a's counts are running: this Instance's warm-up is not the path's
    before = [dict(m.launches) for m in (dk, gk, sk, wm)]
    inst.engine.warmup()
    torch.cuda.synchronize()
    for m, b in zip((dk, gk, sk, wm), before):
        m.launches.update(b)
    bursts = [fd_burst(rng, f"fdb{k}") for k in range(3)]
    slots, _ = fd_slots()
    hub = FrontdoorHub(inst, workers=FD_WORKERS, ring_slots=slots,
                       slab_bytes=FD_SLAB, listen_address="127.0.0.1:0",
                       batch_reads=FD_BATCH_READS)
    tb = millisecond_now()
    out = dict(tb=tb, bursts=bursts)

    async def send_all(rpcs, kill_at=None):
        """Each RPC through the port's gRPC client, its answer in this
        script's encoding (None where the call failed); the kill takes
        the worker that served the most of this burst's RPCs so far (gRPC
        may put every caller on one connection, so on one worker)."""
        clients = [AsyncClient(hub.address) for _ in range(SERVE_CLIENTS)]
        outs, done = [None] * len(rpcs), [0]
        rpcs0 = [hub.status.get_w(w, shm_ring.W_RPCS)
                 for w in range(FD_WORKERS)]

        async def caller(c):
            for i in range(c, len(rpcs), SERVE_CLIENTS):
                try:
                    resps = await clients[c].get_rate_limits(rpcs[i],
                                                             timeout=60)
                    outs[i] = encode_list([vars(r) for r in resps],
                                          RESP_FIELDS)
                except Exception:
                    outs[i] = None
                done[0] += 1
                if kill_at is not None and done[0] == kill_at:
                    busiest = max(range(FD_WORKERS), key=lambda w:
                                  hub.status.get_w(w, shm_ring.W_RPCS)
                                  - rpcs0[w])
                    out["killed"] = busiest
                    os.kill(hub.status.get_w(busiest, shm_ring.W_PID),
                            _signal.SIGKILL)

        try:
            await asyncio.gather(*(caller(c) for c in range(SERVE_CLIENTS)))
        finally:
            for c in clients:
                await c.close()
        return outs

    async def script():
        await hub.start()
        try:
            pin_clock(inst, tb)
            flog = FrontDoorLog(inst, hub)
            try:
                out["out0"] = await send_all(bursts[0][0])
                port0, restarts0 = hub.port, hub.restarts
                out["out1"] = await send_all(
                    bursts[1][0], kill_at=int(FD_KILL_AFTER
                                              * len(bursts[1][0])))
                deadline = time.monotonic() + 60
                while hub.restarts == restarts0:
                    check(time.monotonic() < deadline,
                          "14b: the killed worker never respawned")
                    await asyncio.sleep(0.1)
                await asyncio.sleep(1.0)
                out["same_port"] = hub.port == port0
                out["out2"] = await send_all(bursts[2][0])
            finally:
                flog.remove()
            out["log"], out["log_bad"] = flog.entries, flog.bad
            out["restarts"] = hub.restarts
        finally:
            await hub.stop()
            await inst.aclose()

    asyncio.run(script())
    return out, None


def fd_whole_rpcs(datas, outs, want):
    """The accounting of RPCs sent with a SIGKILL among them: datas the
    RPCs sent, outs each one's response (None where the call failed),
    want the serial engine's {RPC bytes: [responses]} of what the drains
    staged.  Every staged RPC is the bytes of an RPC sent (a partly staged
    one rebuilds other bytes); of the copies of one RPC, each answered one
    was applied and answered as the serial engine answered it, and each
    failed one was applied once or never.  (failed, applied, faults)."""
    from collections import Counter, defaultdict
    sent, got = Counter(datas), defaultdict(list)
    for data, resp in zip(datas, outs):
        if resp is not None:
            got[data].append(resp)
    faults = [f"{len(v)} staged RPCs were never sent"
              for k, v in want.items() if k not in sent]
    for k, n in sent.items():
        applied, answered = len(want.get(k, ())), len(got.get(k, ()))
        if not answered <= applied <= n:
            faults.append(f"an RPC sent {n} times, answered {answered}, "
                          f"was applied {applied} times")
        if not Counter(got.get(k, ())) <= Counter(want.get(k, ())):
            faults.append("an RPC answered other bytes than the serial "
                          "engine")
    return (sum(o is None for o in outs),
            sum(len(v) for v in want.values()), faults)


def check_front_door_grpc(r):
    """14b against the serial engine in the engine's order: bursts 0 and
    2 answered whole; over the three, every answered RPC answered as the
    serial engine did and every failed one applied whole or not at all
    (fd_whole_rpcs)."""
    want = fd_expected(r["log"], r["tb"])
    check(r["log_bad"] == 0, f"14b: {r['log_bad']} unplaced staged jobs")
    for b in (0, 2):
        check(None not in r[f"out{b}"], f"14b: burst {b} lost an RPC")
    datas = [d for b in range(3) for d in r["bursts"][b][1]]
    outs = [o for b in range(3) for o in r[f"out{b}"]]
    failed, applied, faults = fd_whole_rpcs(datas, outs, want)
    check(not faults, f"14b: {len(faults)} faults in what was applied, "
          f"{faults[:3]}")
    check(r["same_port"] and r["restarts"] >= 1,
          f"14b: respawn on the same port {r['same_port']}, restarts "
          f"{r['restarts']}")
    return failed, applied, len(datas)


def report_front_door(r, n_rpcs, grpc_res, counts, wire_fig, smi):
    n, wall, prof_rate, share = r["sat"]
    n3, wall3, c0, c1, parse_s, encode_s = r["split"]
    rpcs = max(1, n3 // SERVE_RPC)
    busy0, busy1 = c0["busy"], c1["busy"]
    d = {k: busy1[k] - busy0[k] for k in busy1}
    engine_us = dict(
        ring_pop=(c1["pop"] - c0["pop"]) / rpcs * 1e6,
        pack_stack_fast=(c1["pack"] - c0["pack"]) / rpcs * 1e6,
        staging_besides_pack=(d["host_encode"] - (c1["pack"] - c0["pack"]))
        / rpcs * 1e6,
        dispatch=d["device_dispatch"] / rpcs * 1e6,
        fetch_wait_and_decode=d["fetch_decode"] / rpcs * 1e6,
        completion_write=(c1["complete"] - c0["complete"]) / rpcs * 1e6)
    worker_us = dict(c_parse=parse_s / rpcs * 1e6,
                     encode=encode_s / rpcs * 1e6)
    cnt = r["counters"]
    kinds = {KIND_NAMES.get(k, str(k)): v for k, v in cnt["kinds"].items()}
    burst_sheds = {}
    for s in r["burst_sheds"]:
        for k, v in s.items():
            burst_sheds[k] = burst_sheds.get(k, 0) + v
    sat_runs = [dict(decisions_per_s=sr["n"] / sr["wall"], **sr)
                for sr in r["sat_runs"]]
    fig = dict(
        card=smi, decisions_per_s=n / wall,
        decisions_per_s_profiled=prof_rate,
        idle_share=None if share is None else 1 - share,
        phase9_in_process_decisions_per_s=wire_fig["decisions_per_s"],
        saturating_runs=dict(zip(("timed", "profiled", "host_split"),
                                 sat_runs)),
        latency_ms={f"{int(x['share'] * 100)}%": x for x in r["rates"]},
        engine_host_us_per_rpc=engine_us,
        drain_stage_ms_per_drain=r["stage_split"],
        phase9_host_us_per_rpc=wire_fig["host_us_per_rpc"],
        worker_us_per_rpc=worker_us, host_split_decisions_per_s=n3 / wall3,
        records_by_kind=kinds,
        encode_paths=dict(worker=cnt["encodes"],
                          engine_bytes=cnt["enc_fallbacks"],
                          engine_fallbacks=cnt["engine_encode_fallbacks"]),
        burst_sheds=burst_sheds, ring_stalls=cnt["stalls"],
        batched_rpcs=cnt["batch_rpcs"], batch_flushes=cnt["batch_flushes"],
        slots=r["slots"], nvidia_smi_compute_pids=r["apps"],
        engine_pid=r["engine_pid"], worker_pids=r["worker_pids"])

    def ms(v):
        return "none answered" if v is None else f"{v:.3f} ms"
    rates = "; ".join(
        f"{int(x['share'] * 100)}% ({x['achieved']:.0f}/s answered, "
        f"{x['answered']} of {x['rpcs']} RPCs answered with no shed, sheds "
        f"{x['sheds']}): p50 {ms(x['p50'])} p99 {ms(x['p99'])} over the "
        f"RPCs answered" for x in r["rates"])
    sats = ", ".join(f"{sr['rpcs']} RPCs, sheds {sr['sheds']}"
                     for sr in r["sat_runs"])
    log(f"phase 14a front door ({FD_WORKERS} replay workers x {r['slots']} "
        f"slots, batch reads {FD_BATCH_READS}, {SERVE_CLIENTS} callers on "
        f"phase 9's Instance): {len(r['burst'])} burst RPCs ({n_rpcs} "
        f"distinct) = the serial engine in the engine's order; saturated "
        f"{n / wall:.1f} decisions/s answered (phase 9 in-process "
        f"{wire_fig['decisions_per_s']:.1f}; timed, profiled and host-split "
        f"runs: {sats}; no RPC failed), idle share "
        f"{fig['idle_share']}; offered rates: {rates}; engine host us per "
        f"RPC: " + ", ".join(f"{k} {v:.1f}" for k, v in engine_us.items())
        + "; worker us per RPC: " + ", ".join(
            f"{k} {v:.1f}" for k, v in worker_us.items())
        + "; drain stages ms a drain (histograms): " + ", ".join(
            f"{k} {v:.4f}" for k, v in r["stage_split"].items())
        + f"; records {kinds}; only the engine's pid {r['engine_pid']} "
        f"holds a CUDA context (nvidia-smi {r['apps']}); launches {counts}; "
        f"{smi}")
    log("front door figures: " + json.dumps(fig))
    if grpc_res[0] is None:
        log(f"phase 14b (the gRPC workers) did not run: {grpc_res[1]}; "
            f"14a carries the phase's checks")
    else:
        failed, applied, sent = grpc_res[0]
        log(f"phase 14b gRPC workers: 3 bursts of {sent // 3} RPCs = the "
            f"serial engine; a worker SIGKILLed {FD_KILL_AFTER:.0%} into the "
            f"second: {failed} RPCs failed, each applied whole or not at "
            f"all ({applied} applied of {sent}); respawned on the same "
            f"port; {smi}")


KIND_NAMES = {0: "raw", 1: "cols", 2: "peer_rl", 3: "transfer",
              4: "register", 5: "apply_greg", 6: "update_globals",
              7: "batch_cols"}


# ------------------------------------------- phase 15: device profiling

DEVPROF_DRAINS = 8
# 15c's first part: RPCs one at a time from one caller, the regime of the
# JAX test whose bound it checks (each RPC alone in its drain)
SEQ_RPCS = 200
DRAIN_STAGES = ("admission_wait", "window_fill", "device_dispatch",
                "drain_commit")
GET_RATE_LIMITS = "/pb.gubernator.V1/GetRateLimits"
# the first capture of a fresh serving process: its profiler start is the
# cold CUPTI initialisation (argv[1]: the checkout's root)
COLD_CAPTURE = r"""
import asyncio, json, shutil, sys, time
sys.path.insert(0, sys.argv[1])
from gubernator_tpu_torch.api.types import RateLimitReq
from gubernator_tpu_torch.config import EngineConfig
from gubernator_tpu_torch.core.service import Instance
inst = Instance(engine_config=EngineConfig(
    capacity_per_shard=1 << 16, num_shards=8, batch_per_shard=1024,
    use_native="on"))
inst.engine.warmup()
reqs = [RateLimitReq(name="c", unique_key=f"k{i}", hits=1, limit=100,
                     duration=60000) for i in range(100)]
prof = inst.batcher.profile


async def main():
    await inst.get_rate_limits(reqs)
    t0 = time.perf_counter()
    await inst.get_rate_limits(reqs)
    warm = time.perf_counter() - t0
    prof.arm(1, sys.argv[2])
    t0 = time.perf_counter()
    await inst.get_rate_limits(reqs)
    armed = time.perf_counter() - t0
    # the capture counts a drain a roll after its start, and stops a roll
    # after it
    while prof.armed and time.perf_counter() - t0 < 60:
        await inst.get_rate_limits(reqs)
        await asyncio.sleep(0.01)
    return warm, armed


warm, armed = asyncio.run(main())
print(json.dumps(dict(last=prof.last, rpc_ms=warm * 1e3,
                      armed_rpc_ms=armed * 1e3)))
inst.close()
"""


def stage_totals(m):
    """{stage: (histogram sum ms, count)} of the drain stages, and the
    GetRateLimits RPCs' end-to-end (sum ms, count)."""
    g = m.registry.get_sample_value
    out = {st: (g("guber_tpu_stage_duration_ms_sum", {"stage": st}) or 0.0,
                g("guber_tpu_stage_duration_ms_count", {"stage": st}) or 0.0)
           for st in DRAIN_STAGES}
    out["rpc"] = (
        g("grpc_request_duration_milliseconds_sum",
          {"method": GET_RATE_LIMITS}) or 0.0,
        g("grpc_request_duration_milliseconds_count",
          {"method": GET_RATE_LIMITS}) or 0.0)
    return out


def stage_split(t0, t1):
    """Mean ms a drain of each drain stage between two stage_totals."""
    return {st: (t1[st][0] - t0[st][0]) / max(1.0, t1[st][1] - t0[st][1])
            for st in DRAIN_STAGES}


def cuda_event_ms(fn, reps):
    """Mean device-stream ms of fn() over reps runs (CUDA events)."""
    fn()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
        enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def phase_devprof():
    """Phase 15, the counted part: the capture of serving drains (15a),
    the measured census pass at the serving geometry (15b), the drain
    stages under full tracing (15c) and one periodic controller cycle
    (15d), on one Instance built and warmed, with its RPCs encoded,
    before the counts start; then the cold first capture of a fresh
    process.  The caller reads the counts when this returns."""
    from gubernator_tpu_torch.observability import devprof
    from gubernator_tpu_torch.observability.metrics import Metrics
    from gubernator_tpu_torch.observability.tracing import Tracer
    t_phase = time.perf_counter()
    rng = np.random.default_rng(151)
    metrics = Metrics()
    tracer = Tracer(sample=0.0, export="", node="phase15", max_spans=1 << 21)
    inst = Instance(engine_config=serving_engine_config(), metrics=metrics,
                    tracer=tracer, devprof_mode="periodic",
                    devprof_interval_s=3600.0, devprof_drains=DEVPROF_DRAINS)
    eng, pipe = inst.engine, inst.batcher.pipeline
    prof = inst.batcher.profile
    check(eng.native is not None and pipe is not None,
          "15: the router or the pipeline is missing")
    eng.warmup()
    torch.cuda.synchronize()
    sat_rpcs, sat = wire_rpcs(rng, 512 * SERVE_RPC)
    ctx = WireContext()

    async def serve(data):
        return await serve_get_rate_limits(inst, data, ctx)

    async def serve_traced(data):
        with tracer.start_trace("rpc"):
            return await serve_get_rate_limits(inst, data, ctx)

    # 15a's marks, taken on the engine thread: the wrapper's launches and
    # the engine's windows when the capture's counted span opens and
    # closes, and every stack the counted drains launched
    marks = {"stacks": []}
    before, after = prof.before_drain, prof.after_drain
    dispatch = eng.pipeline_dispatch

    def marked_before():
        before()
        if prof._span is not None and "l0" not in marks:
            marks["l0"] = dk.launches["drain_compact"]
            marks["w0"] = eng.windows_processed

    def marked_after():
        after()
        if "l0" in marks and "l1" not in marks and prof._span is None:
            marks["l1"] = dk.launches["drain_compact"]
            marks["w1"] = eng.windows_processed

    def logged_dispatch(packed, nows, n_windows=None):
        if prof._span is not None and "l1" not in marks:
            marks["stacks"].append((packed.clone(), nows.clone(), n_windows))
        return dispatch(packed, nows, n_windows)

    prof.before_drain, prof.after_drain = marked_before, marked_after
    eng.pipeline_dispatch = logged_dispatch
    out = {}
    cap_dir = tempfile.mkdtemp(prefix="guber-profile-")
    tmp_root = tempfile.gettempdir()
    reset_counts()

    async def until_disarmed(serve_fn, limit_s):
        n, t0 = 0, time.perf_counter()
        while prof.armed and time.perf_counter() - t0 < limit_s:
            n += (await saturate(serve_fn, sat, 0.2))[0]
        return n, time.perf_counter() - t0

    async def script():
        await saturate(serve, sat, 0.5)  # the lane warm on the wall clock
        # 15a: an operator's 8-drain capture of serving drains
        check(prof.arm(DEVPROF_DRAINS, cap_dir)["armed"], "15a: arm refused")
        out["15a_wall"] = await until_disarmed(serve, 60.0)
        check(not prof.armed, "15a: the capture never completed")
        out["15a_last"] = dict(prof.last)
        out["roll_s"] = {"15a": devprof.ROLL.seconds}
        # 15b: the measured census pass, the arms at the serving geometry,
        # on a thread of its own as the kernels route runs it, while the
        # callers serve; each arm's call is timed with CUDA events after
        # the counts are read (check_devprof)
        loop = asyncio.get_running_loop()
        arms = devprof.build_census_arms(
            device=DEV, capacity_per_shard=FULL_CAPACITY // SHARDS,
            batch_per_shard=FULL_LANES, num_shards=SHARDS)

        def measure():
            check(prof.hold(), "15b: the profiler is busy")
            try:
                table = devprof.KernelTable()
                t0 = time.perf_counter()
                res = devprof.measure_census_arms(arms=arms, iters=3,
                                                  table=table)
                res["wall_s"] = time.perf_counter() - t0
            finally:
                prof.release()
            res["table"] = table.snapshot(top=100)
            res["census"] = devprof.census_table(device=DEV)
            return res

        fut = loop.run_in_executor(None, measure)
        n, t0 = 0, time.perf_counter()
        while not fut.done():
            n += (await saturate(serve, sat, 0.2))[0]
        out["15b"] = dict(await fut, specs=arms, served=n,
                          served_s=time.perf_counter() - t0)
        out["roll_s"]["15b"] = devprof.ROLL.seconds
        # 15c: every RPC traced, one at a time from one caller, then at
        # saturation
        c0, k0, t0 = pipeline_counters(pipe), inst.devprof.clock.total(), \
            stage_totals(metrics)
        tracer.sample = 1.0
        try:
            for data in sat[:SEQ_RPCS]:
                await serve_traced(data)
            tseq = stage_totals(metrics)
            n, wall = await saturate(serve_traced, sat, SERVE_SECONDS)
        finally:
            tracer.sample = 0.0
        out["15c"] = dict(n=n, wall=wall, t0=t0, tseq=tseq,
                          t1=stage_totals(metrics),
                          d=counter_delta(c0, pipeline_counters(pipe)),
                          clock=inst.devprof.clock.total() - k0,
                          spans=tracer.spans())
        # 15d: periodic cycles while the callers serve, in turns with as
        # long with no cycle (cycle, none, none, cycle): the cycle's cost
        ctl = inst.devprof.controller
        check(ctl is not None, "15d: no periodic controller")
        before_dirs = {d for d in os.listdir(tmp_root)
                       if d.startswith("guber-devprof-")}
        import threading

        async def one_cycle():
            res = {}

            def cycle():
                t = time.perf_counter()
                res["ok"] = ctl.run_once(capture_timeout=30.0)
                res["wall_s"] = time.perf_counter() - t
                res["roll_s"] = devprof.ROLL.seconds
                res["last"] = dict(prof.last)

            th = threading.Thread(target=cycle)
            th.start()
            n, t0 = 0, time.perf_counter()
            while th.is_alive():
                n += (await saturate(serve, sat, 0.2))[0]
            th.join()
            return dict(res, n=n, wall=time.perf_counter() - t0)

        c1 = await one_cycle()
        quiet = [await saturate(serve, sat, c1["wall"]) for _ in range(2)]
        c2 = await one_cycle()
        left = {d for d in os.listdir(tmp_root)
                if d.startswith("guber-devprof-")} - before_dirs
        out["15d"] = dict(cycles=[c1, c2], quiet=quiet, status=ctl.status(),
                          left=sorted(left))
        out["roll_s"]["15d"] = devprof.ROLL.seconds

    try:
        asyncio.run(script())
    finally:
        prof.before_drain, prof.after_drain = before, after
        del eng.pipeline_dispatch
        inst.close()
    out["events"] = devprof.parse_run_dir(cap_dir)
    shutil.rmtree(cap_dir, ignore_errors=True)
    out["marks"], out["pipe"] = marks, rpc_counters(pipe)
    out["table"] = inst.devprof.table
    out["eng"], out["inst_clock"] = eng, inst.devprof.clock.snapshot()
    out["wall_s"] = time.perf_counter() - t_phase
    return out


def check_devprof(r):
    """Phase 15, after the counts are read: 15a's capture against the
    launches and the replayed stacks' CUDA-event time, 15b's census join,
    15c's stage accounting and spans, 15d's cycle; then the cold first
    capture of a fresh process.  Returns the figures."""
    from gubernator_tpu_torch.observability import devprof
    fig = {}
    # 15a
    m, events = r["marks"], r["events"]
    check("l1" in m, f"15a: the capture's stop was not seen: {m.keys()}")
    launched = m["l1"] - m["l0"]
    windows = m["w1"] - m["w0"]
    rows = devprof.self_times(events)
    drain_rows = [x for x in rows
                  if devprof.kernel_base(x[0]) == "drain_compact_kernel"]
    if len(drain_rows) != launched:
        from collections import Counter
        cats = Counter(e.get("cat") for e in events)
        kern = Counter(devprof.kernel_base(e["name"]) for e in events
                       if e.get("cat") == "kernel")
        log(f"15a capture: {len(events)} events by category {dict(cats)}; "
            f"kernels {dict(kern)}; profiler {r['15a_last']}")
    check(launched >= DEVPROF_DRAINS and len(drain_rows) == launched,
          f"15a: {len(drain_rows)} drain_compact_kernel events, "
          f"{launched} launches over the armed drains")
    arms = {a for _n, _ms, a in drain_rows}
    check(arms == {devprof.ARM_DRAIN},
          f"15a: drain_compact_kernel attributed to {arms}")
    check(not any(a == devprof.ARM_OTHER and devprof.is_hand_kernel(n)
                  for n, _ms, a in rows),
          "15a: a hand kernel fell in the remainder bucket")
    folded = r["table"].fold(events, windows=windows)
    check(folded == len(rows), f"15a: folded {folded} of {len(rows)} rows")
    table_ms = sum(ms for _n, ms, _a in drain_rows) / windows
    # the same stacks replayed on a copy of the arena, CUDA events
    eng = r["eng"]
    arena = tk.BucketState(*[p.clone() for p in eng.state])
    stacks = r["marks"]["stacks"]
    check(len(stacks) == launched, f"15a: {len(stacks)} stacks logged")
    ev_ms = 0.0
    for packed, nows, _nw in stacks:
        pd, nd = packed.to(DEV), nows.to(DEV)
        ev_ms += cuda_event_ms(lambda: dk.launch_compact(arena, pd, nd), 10)
    del arena
    event_ms = ev_ms / windows
    ratio = table_ms / event_ms
    check(0.5 <= ratio <= 2.0,
          f"15a: the table's {table_ms:.5f} ms a window vs CUDA events' "
          f"{event_ms:.5f}")
    per_arm = {}
    for n, ms, a in rows:
        per_arm[a] = per_arm.get(a, 0.0) + ms
    # the trace's device start of each counted drain kernel less its
    # launch's host start: the profiler's clock alignment at this age
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    lag = sorted(e["ts"] - launch_ts[e["args"]["correlation"]]
                 for e in events if e.get("cat") == "kernel"
                 and devprof.kernel_base(e["name"]) == "drain_compact_kernel"
                 and e.get("args", {}).get("correlation") in launch_ts)
    fig["15a"] = dict(
        drains=launched, windows=windows,
        drain_kernel_ms_per_window_profiler=table_ms,
        drain_kernel_ms_per_window_cuda_events=event_ms,
        ratio=ratio,
        device_ms_per_window_by_arm={a: v / windows
                                     for a, v in per_arm.items()},
        rows=len(rows), wall_s=r["15a_wall"][1],
        kernel_minus_launch_ms=(lag[len(lag) // 2] / 1000.0 if lag
                                else None),
        profiler_start_ms=r["15a_last"].get("start_ms"),
        profiler_stop_and_write_ms=r["15a_last"].get("stop_ms"))
    # 15b: each arm's call timed with CUDA events, now that the counts
    # are read
    b = r["15b"]
    b["event_ms"] = {a["name"]: cuda_event_ms(a["fn"], 20) / a["windows"]
                     for a in b.pop("specs")}
    check(b["complete"], "15b: the measured capture lost counted kernels "
          f"twice (roll {b['roll_s']} s)")
    for name, row in b["arms"].items():
        check(row["measured_ms_per_window"] > 0,
              f"15b: {name} measured no time")
        check(row["hand_kernel_events_per_window"]
              == row["census_kernels_per_window"] == b["census"][name],
              f"15b: {name}: {row['hand_kernel_events_per_window']} hand "
              f"kernel events a window, census "
              f"{row['census_kernels_per_window']} / {b['census'][name]}")
    per_kernel = {}
    for x in b["table"]["rows"]:
        if devprof.is_hand_kernel(x["kernel"]):
            per_kernel[f"{x['arm']}:{devprof.kernel_base(x['kernel'])}"] = \
                x["total_ms"] / x["count"]
    fig["15b"] = dict(
        arms={n: dict(row, cuda_event_ms_per_window=b["event_ms"][n])
              for n, row in b["arms"].items()},
        hand_kernel_profiler_ms_per_launch=per_kernel,
        census=b["census"], wall_s=b["wall_s"],
        decisions_per_s_while_measuring=b["served"] / b["served_s"])
    # 15c: the bound of JAX test_stage_sums_match_e2e_duration on the
    # sequential RPCs; at saturation one drain carries tens of RPCs, so
    # the histograms (one sample a drain) read about 1 / RPCs a drain of
    # the end-to-end total (one a RPC): reported, not held to it
    c = r["15c"]
    t0, tseq, t1 = c["t0"], c["tseq"], c["t1"]

    def stage_ms(a, b):
        return sum(b[st][0] - a[st][0] for st in DRAIN_STAGES)

    ds, de = stage_ms(t0, tseq), tseq["rpc"][0] - t0["rpc"][0]
    check(tseq["rpc"][1] - t0["rpc"][1] == SEQ_RPCS,
          f"15c: {tseq['rpc'][1] - t0['rpc'][1]} sequential RPCs observed")
    check(de > 0 and ds >= 0.02 * de and ds <= 2.0 * de + 50.0,
          f"15c: drain stages {ds:.1f} ms against {de:.1f} ms end to end "
          f"over {SEQ_RPCS} sequential RPCs")
    ds_sat, de_sat = stage_ms(tseq, t1), t1["rpc"][0] - tseq["rpc"][0]
    drains = c["d"]["drains"]
    counts = {st: t1[st][1] - t0[st][1] for st in DRAIN_STAGES}
    check(drains > 0 and c["clock"] == drains
          and all(v == drains for v in counts.values()),
          f"15c: {drains} drains, window clock {c['clock']}, stage "
          f"samples {counts}")
    by_trace = {}
    for sp in c["spans"]:
        by_trace.setdefault(sp.trace_id, set()).add(sp.name)
    roots = [t for t, names in by_trace.items() if "rpc" in names]
    missing = [t for t in roots
               if not set(DRAIN_STAGES) <= by_trace[t]]
    check(roots and (len(roots) - SEQ_RPCS) * SERVE_RPC >= c["n"]
          and not missing,
          f"15c: {len(missing)} of {len(roots)} traced RPCs lack a drain "
          f"stage ({c['n']} decisions at saturation)")
    fig["15c"] = dict(
        decisions_per_s=c["n"] / c["wall"], traced_rpcs=len(roots),
        drains=drains, sequential_stage_ms=ds, sequential_rpc_ms=de,
        sequential_share=ds / de,
        sequential_stage_ms_per_drain=stage_split(t0, tseq),
        saturated_stage_ms=ds_sat, saturated_rpc_ms=de_sat,
        saturated_share=ds_sat / de_sat,
        saturated_stage_ms_per_drain=stage_split(tseq, t1),
        saturated_rpcs_per_drain=(t1["rpc"][1] - tseq["rpc"][1])
        / max(1.0, t1["window_fill"][1] - tseq["window_fill"][1]),
        mean_inflight=c["d"]["mean_inflight"])
    # 15d: the first cycle folds; a later one may lose kernels once the
    # roll has shrunk (then it folds nothing and the roll grows back)
    d = r["15d"]
    c1, c2 = d["cycles"]
    check(c1.get("ok") is True and d["status"]["kernel_rows"] > 0,
          f"15d: the periodic cycle folded nothing: {c1}")
    check(c2.get("ok") is True or d["status"]["incomplete"] > 0,
          f"15d: the second cycle neither folded nor was judged "
          f"incomplete: {c2}")
    check(not d["left"], f"15d: trace directories left: {d['left']}")
    on = sum(c["n"] for c in d["cycles"]) / sum(c["wall"]
                                                for c in d["cycles"])
    off = sum(n for n, _w in d["quiet"]) / sum(w for _n, w in d["quiet"])
    fig["15d"] = dict(
        cycle_wall_s=[c["wall_s"] for c in d["cycles"]],
        decisions_per_s=on, decisions_per_s_no_cycle=off,
        cycle_share=on / off,
        decisions_per_s_turns=[c1["n"] / c1["wall"]]
        + [n / w for n, w in d["quiet"]] + [c2["n"] / c2["wall"]],
        folded=[c["ok"] for c in d["cycles"]],
        roll_s_after=[c["roll_s"] for c in d["cycles"]],
        kernel_rows=d["status"]["kernel_rows"],
        incomplete=d["status"]["incomplete"],
        profiler_start_ms=c1["last"].get("start_ms"),
        profiler_stop_and_write_ms=[c["last"].get("stop_ms")
                                    for c in d["cycles"]])
    # the cold first capture, a fresh process
    cold_dir = tempfile.mkdtemp(prefix="guber-cold-")
    try:
        root = os.path.dirname(os.path.abspath(__file__))
        t = time.perf_counter()
        p = subprocess.run([sys.executable, "-c", COLD_CAPTURE, root,
                            cold_dir], capture_output=True, text=True,
                           timeout=300, cwd=root)
        cold_wall = time.perf_counter() - t
        check(p.returncode == 0, f"15: the cold capture failed: "
              f"{p.stderr[-2000:]}")
        cold = json.loads(p.stdout.strip().splitlines()[-1])
        cold_rows = devprof.self_times(devprof.parse_run_dir(cold_dir))
    finally:
        shutil.rmtree(cold_dir, ignore_errors=True)
    check(any(devprof.kernel_base(n) == "drain_compact_kernel"
              for n, _ms, _a in cold_rows),
          "15: the cold capture holds no drain_compact_kernel event")
    fig["cold"] = dict(
        profiler_start_ms=cold["last"].get("start_ms"),
        profiler_stop_and_write_ms=cold["last"].get("stop_ms"),
        rpc_ms=cold["rpc_ms"], armed_rpc_ms=cold["armed_rpc_ms"],
        process_wall_s=cold_wall)
    fig["roll_s"] = dict(r["roll_s"], cold=cold["last"].get("roll_s"))
    fig["phase_wall_s"] = r["wall_s"] + cold_wall
    return fig


def report_devprof(r, fig, counts, wire_fig, smi):
    a, b, c, d, cold = (fig["15a"], fig["15b"], fig["15c"], fig["15d"],
                        fig["cold"])

    def ms(v):
        return "not measured" if v is None else f"{v:.1f}"
    log(f"phase 15 device profiling (phase 9's Instance, {SERVE_CLIENTS} "
        f"callers): 15a an {a['drains']}-drain capture of serving drains "
        f"({a['windows']} windows): {a['drains']} drain_compact_kernel "
        f"events = the launches, all composed_drain; the drain kernel "
        f"{a['drain_kernel_ms_per_window_profiler']:.5f} ms a window by "
        f"the table beside {a['drain_kernel_ms_per_window_cuda_events']:.5f}"
        f" by CUDA events (x{a['ratio']:.3f}); 15b census x measured "
        + ", ".join(f"{n} {row['census_kernels_per_window']} / "
                    f"{row['measured_ms_per_window']:.5f} ms "
                    f"(events {row['cuda_event_ms_per_window']:.5f})"
                    for n, row in b["arms"].items())
        + f"; 15c traced at 1.0: {c['traced_rpcs']} RPCs each with its "
        f"four drain stages; {SEQ_RPCS} one at a time: stages "
        f"{c['sequential_stage_ms']:.1f} ms of "
        f"{c['sequential_rpc_ms']:.1f} ms end to end "
        f"(x{c['sequential_share']:.3f}); at saturation "
        f"{c['decisions_per_s']:.1f} decisions/s (phase 9 "
        f"{wire_fig['decisions_per_s']:.1f}), "
        f"{c['saturated_rpcs_per_drain']:.1f} RPCs a drain, stages "
        f"x{c['saturated_share']:.4f} of end to end, ms a drain "
        + ", ".join(f"{k} {v:.4f}" for k, v in
                    c["saturated_stage_ms_per_drain"].items())
        + f"; 15b served {b['decisions_per_s_while_measuring']:.1f} "
        f"decisions/s meanwhile"
        + f"; 15d periodic cycles of {d['cycle_wall_s']} s (folded "
        f"{d['folded']}), {d['decisions_per_s']:.1f} decisions/s during "
        f"them beside {d['decisions_per_s_no_cycle']:.1f} with none, in "
        f"turns (x{d['cycle_share']:.3f}; cycle, none, none, cycle: "
        + ", ".join(f"{v:.1f}" for v in d["decisions_per_s_turns"])
        + f"), {d['kernel_rows']} rows, no trace left; roll s "
        f"{fig['roll_s']}, after each cycle {d['roll_s_after']}; "
        f"profiler start / stop "
        f"ms: warm {ms(d['profiler_start_ms'])} / "
        f"{d['profiler_stop_and_write_ms']}, cold first capture "
        f"{ms(cold['profiler_start_ms'])} / "
        f"{ms(cold['profiler_stop_and_write_ms'])}; phase "
        f"{fig['phase_wall_s']:.1f} s; launches {counts}; {smi}")
    log("devprof figures: " + json.dumps(dict(card=smi, **fig)))


def main():
    smi = phase_device()
    grid_plans()
    drain_err, full_err = phase_kernel_vs_plain()
    rng = np.random.default_rng(7)
    gen = torch.Generator(device=DEV).manual_seed(7)
    eng = full_size_engine(gen)
    packed = torch.from_numpy(full_size_traffic(
        rng, FULL_K, FULL_LANES, FULL_CAPACITY)[:, None]).to(DEV)
    nows = torch.tensor([T0 + 5 * k for k in range(FULL_K)],
                        dtype=torch.int64, device=DEV)
    full = phase_kernel_full_size(eng, packed, nows)
    # the one-shard main path: every count from 0, read when the serving
    # phase ends
    reset_counts()
    drain = phase_engine_full_size(eng, packed, nows)
    del eng
    p4_ms = phase_serving()
    path1 = launch_counts()
    log(f"main path, one shard (phases 3b + 4): launches {path1}")
    global_err = phase_global_vs_plain()
    upsert_err = phase_upserts_vs_plain()
    s8_err = phase_sharded_drain_vs_plain()
    w = global_full_size_inputs(gen, rng)
    alone = phase_global_alone(w)
    upw = phase_upsert_window_timing(w)
    # the GLOBAL main path over 8 shards: counts from 0 again
    reset_counts()
    glob = phase_global_full_size(w, alone, drain["ms"])
    del w
    phase_global_serving()
    path2 = launch_counts()
    log(f"main path, {SHARDS} shards with GLOBAL (phases 5c + 5d): "
        f"launches {path2}")
    phase_global_scaling()
    stats_err = phase_stats_vs_plain()
    # the analytics path over 8 shards: counts from 0 again (inside, just
    # before its first drain)
    an = phase_analytics_full_size(gen, rng)
    path3, plain3 = launch_counts(), plain_counts()
    check(path3["drain_compact_stats"] > 0 and path3["stats_finish"] > 0,
          f"a kernel of the analytics path never launched: {path3}")
    check(not any(plain3.values()),
          f"the plain versions ran on the analytics path: {plain3}")
    log(f"main path, analytics over {SHARDS} shards (phase 6b): launches "
        f"{path3}, plain calls {plain3}")
    chk = check_analytics_full_size(an)
    bounds = report_analytics(an, chk, path3)
    finisher_split()
    math_err, apply_err = phase_per_op_vs_plain()
    # the per-op path (GUBER_PALLAS=1): counts from 0 again, after the
    # engines and inputs are built
    script = per_op_script(gen, rng)
    reset_counts()
    po = phase_per_op_path(script)
    path4, plain4 = launch_counts(), plain_counts()
    per_op_kernels = ("window_math", "global_stage", "global_apply")
    check(all(path4[k] > 0 for k in per_op_kernels),
          f"a kernel of the per-op path never launched: {path4}")
    others = {k: v for k, v in path4.items() if k not in per_op_kernels}
    check(not any(others.values()),
          f"the per-op path launched another kernel: {others}")
    check(not any(plain4.values()),
          f"the plain versions ran on the per-op path: {plain4}")
    log(f"main path, per-op lowering (phase 7b): launches {path4}, plain "
        f"calls {plain4}")
    cmp = check_per_op_against_default(script, po)
    pb = per_op_bounds_and_plain(script)
    report_per_op(script, po, cmp, pb)
    one = script["pairs"][0][0]
    math_windows(tk.BucketState(*[t[0] for t in one.state]),
                 int(script["nows1"][0][0]))
    del script, one
    # the pipelined serving path: counts from 0 again, after its inputs
    # are built (inside, before the Instance serves)
    serve = phase_serving_pipeline()
    path5, plain5 = launch_counts(), plain_counts()
    check(all(path5[k] > 0 for k in ("drain_compact", "drain_compact_stats",
                                     "stats_finish")),
          f"a kernel of the pipelined serving path never launched: {path5}")
    check(not any(plain5.values()),
          f"the plain versions ran on the pipelined serving path: {plain5}")
    # every drain of each pipeline is one launch; the first Instance's
    # engine.process windows add drain_compact launches of their own
    an8 = serve["an"]
    check(an8["drains"] > 0 and an8["decisions"] >= SERVE_DECISIONS,
          f"the analytics pipeline served {an8['decisions']} decisions in "
          f"{an8['drains']} drains")
    check(path5["drain_compact_stats"] == an8["drains"]
          and path5["stats_finish"] == an8["drains"],
          f"stats launches {path5} != the analytics pipeline's "
          f"{an8['drains']} drains")
    check(path5["drain_compact"] >= serve["pipe_drains"] > 0,
          f"drain_compact launches {path5['drain_compact']} < the "
          f"pipeline's {serve['pipe_drains']} drains")
    check(serve["chain_counts"]["chain_flushes"] > 0,
          f"the chained burst flushed no chain: {serve['chain_counts']}")
    chk8 = check_serving(serve)
    report_serving(serve, chk8, path5, p4_ms, smi)
    # the raw-RPC lane: counts from 0 again (inside, after its Instance is
    # warmed and its RPCs are encoded)
    wire = phase_wire()
    path6, plain6 = launch_counts(), plain_counts()
    others6 = {k: v for k, v in path6.items() if k != "drain_compact"}
    check(path6["drain_compact"] == wire["pipe"]["drains"] > 0,
          f"drain_compact launches {path6['drain_compact']} != the raw-RPC "
          f"lane's {wire['pipe']['drains']} drains")
    check(not any(others6.values()),
          f"the raw-RPC lane launched another kernel: {others6}")
    check(not any(plain6.values()),
          f"the plain versions ran on the raw-RPC lane: {plain6}")
    check(wire["pipe"]["refused"] == 0
          and wire["pipe"]["staged"] == wire["calls"],
          f"of {wire['calls']} RPCs {wire['pipe']['staged']} were staged and "
          f"{wire['pipe']['refused']} refused")
    check(wire["adm"][0] < wire["adm"][1],
          f"admission reached {wire['adm'][0]} of its {wire['adm'][1]} on "
          f"the raw-bytes lane (a saturated queue sends RPCs to protobuf)")
    check_wire(wire)
    wire_fig = report_wire(wire, path6, serve, smi)
    del wire
    # the state lifecycle: counts from 0 again (inside 10a, after its
    # Instances are built and warmed); 10b adds the tiered engines'
    tmp = tempfile.mkdtemp(prefix="guber-snapshots-")
    try:
        life = phase_lifecycle_snapshots(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    tiers = phase_tiers()
    path7, plain7 = launch_counts(), plain_counts()
    check(path7["drain_compact"] > 0 and path7["global_window"] > 0,
          f"a kernel of the lifecycle path never launched: {path7}")
    others7 = {k: v for k, v in path7.items()
               if k not in ("drain_compact", "global_window")}
    check(not any(others7.values()),
          f"the lifecycle path launched another kernel: {others7}")
    check(not any(plain7.values()),
          f"the plain versions ran on the lifecycle path: {plain7}")
    check_lifecycle(life, tiers)
    report_lifecycle(life, tiers, path7, smi)
    del life, tiers
    # leases and QoS: counts from 0 again (inside, after the Instances are
    # built and warmed)
    t11 = time.perf_counter()
    qa, qb, qsmall = qos_instances()
    qos = phase_qos_leases(qa, qb, qsmall)
    path8, plain8 = launch_counts(), plain_counts()
    check(path8["drain_compact"] > 0,
          f"drain_compact never launched on the lease and QoS path: {path8}")
    check(not any(plain8.values()),
          f"the plain versions ran on the lease and QoS path: {plain8}")
    try:
        chk11 = check_qos_leases(qos, qa, qb)
    finally:
        qa.close()
        qb.close()
    qos["wall_s"] = time.perf_counter() - t11
    report_qos_leases(qos, chk11, path8, smi)
    del qos, qa, qb, qsmall
    # the peer ring: counts from 0 again (inside, after its three
    # Instances are built, warmed and joined)
    ring = phase_ring()
    path9, plain9 = launch_counts(), plain_counts()
    check(path9["drain_compact"] > 0 and path9["global_window"] > 0,
          f"a kernel of the peer ring's path never launched: {path9}")
    others9 = {k: v for k, v in path9.items()
               if k not in ("drain_compact", "global_window")}
    check(not any(others9.values()),
          f"the peer ring's path launched another kernel: {others9}")
    check(not any(plain9.values()),
          f"the plain versions ran on the peer ring's path: {plain9}")
    chk12 = check_ring(ring)
    report_ring(ring, chk12, path9, smi)
    del ring
    # failure handling and live migration: counts from 0 again (inside,
    # after the four Instances are built, warmed and the founders joined)
    mig = phase_migration()
    path10, plain10 = launch_counts(), plain_counts()
    check(path10["drain_compact"] > 0 and path10["global_window"] > 0,
          f"a kernel of the migration path never launched: {path10}")
    others10 = {k: v for k, v in path10.items()
                if k not in ("drain_compact", "window_full", "global_window")}
    check(not any(others10.values()),
          f"the migration path launched another kernel: {others10}")
    check(not any(plain10.values()),
          f"the plain versions ran on the migration path: {plain10}")
    chk13 = check_migration(mig)
    report_migration(mig, chk13, path10, smi)
    del mig
    # a dispatch fault on the pipelined lane: counts from 0 again (inside,
    # after its Instance is built and warmed)
    fault = phase_dispatch_fault()
    path11, plain11 = launch_counts(), plain_counts()
    others11 = {k: v for k, v in path11.items() if k != "drain_compact"}
    check(path11["drain_compact"] > 0 and not any(others11.values()),
          f"the dispatch-fault path launched {path11}")
    check(not any(plain11.values()),
          f"the plain versions ran on the dispatch-fault path: {plain11}")
    n_failed = check_dispatch_fault(fault)
    report_dispatch_fault(fault, n_failed, path11, smi)
    del fault
    # the front door: counts from 0 again (inside 14a, after its Instance
    # is warmed and its RPCs encoded); 14b, where grpc imports, adds its
    # launches
    fd = phase_front_door()
    grpc_res = phase_front_door_grpc()
    path12, plain12 = launch_counts(), plain_counts()
    check(path12["drain_compact"] >= fd["pipe"]["drains"] > 0
          and path12["global_window"] > 0,
          f"a kernel of the front door's path never launched: {path12}, "
          f"{fd['pipe']['drains']} pipeline drains")
    others12 = {k: v for k, v in path12.items()
                if k not in ("drain_compact", "global_window")}
    check(not any(others12.values()),
          f"the front door's path launched another kernel: {others12}")
    check(not any(plain12.values()),
          f"the plain versions ran on the front door's path: {plain12}")
    n_rpcs = check_front_door(fd)
    if grpc_res[0] is not None:
        grpc_res = (check_front_door_grpc(grpc_res[0]), None)
    report_front_door(fd, n_rpcs, grpc_res, path12, wire_fig, smi)
    del fd, grpc_res
    # device profiling: counts from 0 again (inside, after its Instance is
    # warmed and its RPCs encoded); the replay of 15a's stacks and the
    # cold capture's process come after they are read
    dp = phase_devprof()
    path13, plain13 = launch_counts(), plain_counts()
    dp_kernels = ("drain_compact", "drain_compact_stats", "stats_finish",
                  "window_full")
    check(all(path13[k] > 0 for k in dp_kernels),
          f"a kernel of the device-profiling path never launched: {path13}")
    others13 = {k: v for k, v in path13.items() if k not in dp_kernels}
    check(not any(others13.values()),
          f"the device-profiling path launched another kernel: {others13}")
    check(not any(plain13.values()),
          f"the plain versions ran on the device-profiling path: {plain13}")
    dp_fig = check_devprof(dp)
    report_devprof(dp, dp_fig, path13, wire_fig, smi)
    del dp
    sig4 = lambda x: None if x is None else float(f"{x:.4g}")  # noqa: E731
    kernels = [
        dict(name="drain_compact", route="cuda", source=SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:974",
             launches=(path1["drain_compact"] + path5["drain_compact"]
                       + path6["drain_compact"] + path7["drain_compact"]
                       + path8["drain_compact"] + path9["drain_compact"]
                       + path10["drain_compact"] + path11["drain_compact"]
                       + path12["drain_compact"] + path13["drain_compact"]),
             max_abs_err=max(drain_err, drain["max_abs_err"], s8_err,
                             glob["drain_err"]),
             ms=sig4(drain["ms"]), plain_ms=sig4(drain["plain_ms"]),
             bound_ms=drain["bound_ms"], bound_by=drain["bound_by"],
             library_ms=None),
        dict(name="window_full", route="cuda", source=SOURCE,
             replaces="gubernator_tpu/ops/kernel.py:1084",
             launches=(path1["window_full"] + path8["window_full"]
                       + path10["window_full"] + path13["window_full"]),
             max_abs_err=full_err,
             ms=sig4(full["ms"]), plain_ms=sig4(full["plain_ms"]),
             bound_ms=full["bound_ms"], bound_by=full["bound_by"],
             library_ms=None),
        dict(name="global_window", route="cuda", source=GLOBAL_SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:1381",
             launches=(path2["global_window"] + path7["global_window"]
                       + path8["global_window"] + path9["global_window"]
                       + path10["global_window"] + path12["global_window"]),
             max_abs_err=max(global_err, alone["err"], glob["global_err"],
                             chk["global_err"], cmp["err"], upsert_err,
                             upw["err"]),
             ms=sig4(glob["ms"]), plain_ms=sig4(alone["plain_ms"]),
             bound_ms=glob["bound_ms"], bound_by=glob["bound_by"],
             library_ms=None),
        dict(name="drain_compact_stats", route="cuda", source=SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:852",
             launches=(path3["drain_compact_stats"]
                       + path5["drain_compact_stats"]
                       + path8["drain_compact_stats"]
                       + path13["drain_compact_stats"]),
             max_abs_err=max(stats_err, chk["err"]),
             ms=sig4(an["stats_drain_ms"] if an["stats_drain_ms"] is not None
                     else an["call_ms"][0]),
             plain_ms=sig4(chk["stats_plain_ms"]),
             bound_ms=bounds["stats_bound"][0],
             bound_by=bounds["stats_bound"][1], library_ms=None),
        dict(name="stats_finish", route="cuda", source=STATS_SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:1168",
             launches=(path3["stats_finish"] + path5["stats_finish"]
                       + path8["stats_finish"] + path13["stats_finish"]),
             max_abs_err=max(stats_err, chk["err"]),
             ms=sig4(an["finish_ms"] if an["finish_ms"] is not None
                     else an["call_ms"][0]),
             plain_ms=sig4(chk["finish_plain_ms"]),
             bound_ms=bounds["finish_bound"][0],
             bound_by=bounds["finish_bound"][1], library_ms=None),
        dict(name="window_math", route="cuda", source=MATH_SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:239",
             launches=path4["window_math"],
             max_abs_err=max(math_err, cmp["err"]),
             ms=sig4(po["math_ms"] if po["math_ms"] is not None
                     else pb["math_events"]),
             plain_ms=sig4(pb["math_plain"]), bound_ms=pb["math_bound"][0],
             bound_by=pb["math_bound"][1], library_ms=None),
        dict(name="global_stage", route="cuda", source=APPLY_SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:165",
             launches=path4["global_stage"],
             max_abs_err=max(apply_err, cmp["err"], upsert_err),
             ms=sig4(po["stage_ms"] if po["stage_ms"] is not None
                     else pb["pair_events"]),
             plain_ms=sig4(pb["stage_plain"]), bound_ms=pb["stage_bound"][0],
             bound_by=pb["stage_bound"][1], library_ms=None),
        dict(name="global_apply", route="cuda", source=APPLY_SOURCE,
             replaces="gubernator_tpu/ops/pallas_kernel.py:165",
             launches=path4["global_apply"],
             max_abs_err=max(apply_err, cmp["err"]),
             ms=sig4(po["apply_ms"] if po["apply_ms"] is not None
                     else pb["pair_events"]),
             plain_ms=sig4(pb["apply_plain"]), bound_ms=pb["apply_bound"][0],
             bound_by=pb["apply_bound"][1], library_ms=None),
    ]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
