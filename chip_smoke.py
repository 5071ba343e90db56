#!/usr/bin/env python3
"""Drive poseidon_tpu_torch on one NVIDIA GPU and check it end to end.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, the CUDA toolkit (``nvcc``) and ``g++``, and no network. It
exits non-zero, printing no result line, when any phase fails, when no
card is visible, or when the package is not importable.

Phases (each prints its own lines):

1. device: the card's name, and ``nvidia-smi``'s name and power limit;
2. build: compiles the fourteen CUDA kernels from ``poseidon_tpu_torch/
   kernels/csrc`` (one ``nvcc`` per source, in parallel) and the C++
   oracle, and prints the build seconds;
3. kernels: at the flagship's shapes (BASELINE config 2: 1,000 machines,
   10,000 pods -> Tp = 10240, Mp = 1024, bid window 2560) each kernel's
   output must equal its plain PyTorch twin's on the same card inputs
   bit for bit (tolerance 0: every output is an integer); prints the
   median CUDA-event time of the kernel and of the twin over repeats,
   each with the L2 cache flushed first, and the kernel's least possible
   time on an H100 (its bytes over 3.35 TB/s vs its operations over
   the card's 32-bit integer scalar peak: 64 lanes an SM at the maximum
   SM clock ``nvidia-smi`` reports, ~16.7e12 ops/s); K1's write floor,
   one ``fill_``
   of a table of c's size timed the same way (a yardstick, not a call
   the port makes); the host time of one wrapper call of K1, K2 and K3
   with its launch plan (``host_us``: N calls timed without a
   synchronise, over N; ``wall_us`` adds the one synchronise at the
   end; medians of 7 batches); and an edge battery that holds the
   kernels against their twins (tolerance 0) at their designs' edges:
   for K1 Mp of 16, 64, 1028 and 41984, Tp of 1, 3, 5 and past a whole
   tile, Pw of 0, 1, 3, 5 and 48 (no stage fits) with n_prefs 0, 1 and
   Pw, no preference at all, preferences on padded columns and racks
   of -1, every slot 0, every task cost INF and sums that wrap int32;
   for K2 and K3 Mp of 16, 64, 1028 and past the shared-memory p
   budget, fewer rows than resident warps, one slot and fewer slots
   than SMs, repeated window tasks, all-tied rows, all-INF rows, and
   costs and prices that wrap int32. The express lane's K4
   (``express_rows``, the window's head: kmax 16 arrival rows, pk 3, the
   [Tp] vectors and the saved rows) and K5 (``express_patch``: one full
   1024-entry chunk, out of place, as a stream window calls it) are
   held and timed the same way at the flagship,
   with their own battery: for K4 kmax 1, 16 and 64, pk 0, 1, 3 and 5,
   every lane -1, lanes of -1 and rows past Tp, rows 0 and Tp-1,
   preferences on padded columns and racks of -1, columns without seats,
   sums that wrap int32, Mp 16 and 1028, each with and without the
   saved rows, and a two-shard table whose second shard owns every
   arrival (equal to the whole table's); for K5, each out of place
   (the sources checked unchanged), in place and in the synced lane's
   mixed form, an empty chunk, rows and columns of -1 and past the axis,
   1024 entries on one column, duplicate columns driven below 0, 1 to 11
   chunks in one call, two chunks whose order matters, a chunk of 2,500
   entries, Tp 16 to 10240, Mp 16, 1028, 12288 (the staged seats' limit),
   12292 and 65536. K7 (``stream_commit``, the window's tail: a live
   stream window at the flagship, Tp 10240, Mp 1024, kmax 16, cap 256,
   16 reported rows; the synced lane's call without the commit printed
   beside it)
   and the what-if
   batch's K6 (``perturb``: BASELINE config 5, 64 variants, Tp 4096,
   Mp 1024, its bound the larger of 1 GiB of writes over 3.35 TB/s and
   its int32 operations over the int32 peak; its write floor, one
   ``fill_`` of an int32 [64, 4096, 1024] table, beside it) are held and
   timed the same way,
   with their batteries: for K7, with and without the commit, a live
   window, the first dead window (by certificate, domain and change
   cap), an already-dead stream, a window at the cap, reports on a
   column driven below 0 and rows 0 and Tp-1, at three shapes, then
   n_changes of 0, cap - 1, cap, cap + 1 and Tp, reports on the first
   and last row of every cluster rank's tile and 1,024-row chunk, cap
   0, Tp 16, 1028 and 10240, Mp 16 and 1028, an objective past 2^40;
   for K6 B 1 and 2, magnitude 0, 10 and 50 %,
   scale 1 and above 1, INF rows, a whole INF table, zero-slot columns,
   Mp 16 and 1028, seeds 0 and 2^31-1, and its tile plan's edges (B 1,
   2, 33, 34, 63, 64, 65 and 130 over Tp not a multiple of the row tile,
   Mp 16
   and 1028, magnitude 0 and 50 % and one whose span passes 2^16, where
   the residues' products pass 32 bits, an all-INF table). The scale lane's K8
   (``gap_rows``, the sharded certificate's table pass) is held and
   timed the same way at config 8's aggregated table [524288, 256], at
   the flagship's [10240, 1024] and at its width-2 and width-4 shards
   [5120, 1024] and [2560, 1024], its bound the table's bytes over 3.35
   TB/s and ``c.amin()`` over the same table as a read yardstick, with
   its battery at its plan's edges: Mp 16, 128, 256, 1024, 1040, 8192
   (the staged prices' limit) and 8196, 1, 7, 31, 10,241 and 32,769
   rows, every asg class, task_valid all false, every price INF;
   beside it K3 over a shard's rows at a task offset and K7 over a
   two-shard table (the per-row cost, the commit into the first shard,
   the restore of the second), live and dead, with and without the
   commit, one of them with every arrival in the second shard. The general
   lane's K9 (``cs_sweep``, at the first sweep of the flagship
   cost-scaling solve's busiest refine burst), K10 (``bf_relax``: its
   ``out`` round at the same state is the record, its ``in`` round at
   SSP's first round is printed) and K11 (``ssp_augment``, SSP's path
   step at its first path: the walk, the augment, the potentials and
   the next round's mirror costs and dist0/pred0; each timed call
   restores the flow, routed and pred first, and the restore's own time
   is taken off; beside it the launch floor, ``torch.cuda._sleep(0)``
   cold and back to back, and the step's host time a call) are held and
   timed the same way at the flagship's residual CSR (NN 12,290, 2F
   145,410; K9's and K10's launch plan printed), their bounds the bytes
   a sweep, round or step must move over 3.35 TB/s, with their battery: a node of degree 0, segments of
   1,100 and 1,500 arcs, segments at the plan's edges (degree 0, 1,
   31-33, the chunk size 2,048 +- 1, a cluster's reach 16,384 +- 1 and
   12,289 among 3,000 nodes of degree 6; a graph of heavy nodes only),
   a hub whose admissible arcs and choice arc lie in different chunks
   and cluster ranks (the choice arc pushing its share and a remainder),
   and ``in`` ties whose lowest arc id lies at the segment's end; eps 1,
   3 and 64 over costs of both signs, distances all INF, all 0 and from
   the deficits or one source, and path steps whose walks go along a
   path, over a mirror arc, into the sentinel, from an unreachable T,
   round a cycle, with delta cut by wanted - routed or 0, and along
   paths of the walk's shared record length - 1, + 0 and + 1 arcs, and
   the prologue, each also checked for the dist-buffer hazard (the
   distances read stay as they were, the next dist0 lands in the other
   buffer); K9 also with eps read on the device and K10 ``in`` and K11
   with their parity words on the device (as the graphs run them); then
   one refine burst (a global update and 16 sweeps, as the host loop
   runs it), the flagship's cost-scaling solve and SSP's first 100
   paths, each one graph, under ``torch.profiler``. The auction loop's K12 (``top_will``, the
   deflate step's clearing level) and K13 (``seat_sort``: the 4-key sort
   of ``auction_round`` is the record, the 3-key sort of ``to_sorted``
   and the bid window's compaction are printed) are held and timed the
   same way on the inputs of their first calls in a flagship cold solve
   (Tp 10240, Mp 1024, smax 16), their bounds the bytes they must move,
   and beside each the library call it replaced, timed alone on the same
   inputs (``torch.topk`` of the transposed will table; ``torch.sort``
   of the packed keys and of the compaction's key): the JSON record's
   ``library_ms``; each by phase from ``clock64()`` stamps of one SM by
   the kernels' stamps build (K12: the fold, the block's tree, the
   cluster's read, its tree and write, and the clusters the card holds
   at once; K13: the split's pack, each level, levels 0 and 1 by step,
   and the rank step);
3b. edges: K12 and K13 against their twins (tolerance 0) at their
   designs' edges: for K12 smax 1, 2, 16, 33, 1,024 and Tp (the list
   method, the radix method and the switch), Tp 1, 3 and 10,240, Mp 16,
   1,028 and 12,292, all -INF columns, no valid task, s 0 and past smax,
   every value tied, alt - c past +-INF and wrapping, and 2- and 4-shard
   merges equal to the whole table; the one-launch list method at a
   cluster of one slab, of 3 and 5 (trees over lists not a power of
   two), a ragged last slab, K 32, Mp 16 and 12,292, 2 and 4 shards;
   for K13 1, 3 and 4 keys over n 1, 2,
   3, 1,023-1,025, 10,240, the former LSD cluster's limit and one past
   it (tiles),
   20,000 and 524,288, the segment at 0 and Mp + 2, levels 0 and INF,
   one segment, is_bid all 0 and all 1, keys past 64 bits (Mp 65,539 at
   n 40,000; four whole-int32 keys on both sides of that limit); the
   split's edges:
   buckets of 0, 1, 31-33 and 63-65 keys (the task id alone or the level
   too varying in them), all n keys in one bucket (a cold round's WAIT
   and DUMP), n at SMALL and past it, the split's limit and one past it
   for one- and two-word keys, a first key of 32 bits, keys of 64 bits,
   equal keys (one all-equal bucket; buckets of equal keys past SMALL);
   and the compaction
   with 0, B - 1, B, B + 1 and n waiting at n 1 to 524,288;
4. parity: a small flagship-shaped cluster (64 machines x 600 pods), one
   cold and two churned warm rounds on the card and on the CPU (the
   twins): every field of every round must be equal; then three express
   windows over the same cell on both: placements, cost, repair rounds
   and the warm asg/lvl/floor of every batch must be equal; then a
   3-window stream flush on both: placements, cost, rounds and carry;
   then the scale lane on the same cell (aggregation, a width-2 mesh
   with both shards on one device): a round, two express windows and a
   3-window stream flush, every field and both row blocks equal (each
   card flush one graph launch, the width-2 one too);
5. main path: ``config2_quincy_flagship(seed=0)`` through
   ``ResidentSolver(device="cuda", small_to_oracle=False).run_round``,
   one cold round and three warm rounds over a seeded 1% churn of pods
   (100 retired, 100 new). Launch counts are zeroed just before and
   read just after. Every round must be ``dense_auction``, certified,
   equal in cost to the C++ oracle on the same priced graph, with one
   result fetch and no loop read (the auction loop is one CUDA graph a
   solve: the kernels it runs count their launches when it runs them);
   every kernel must have launched in every round (K1-K3, K12 and K13);
   each round prints its loop graph captures and their ms. One
   more warm round under ``torch.profiler`` prints the device busy and
   idle share, the top device items, and each hand kernel's device time
   by its CUDA symbol: total, launches, and time per launch as the
   auction loop calls it (K12 and K13 a wrapper call; the round makes
   no ``torch.sort``, ``torch.argsort`` or ``torch.topk`` call), and the
   time of K2's first launch after K1 (it reads the table K1 has just
   written).
5b. loop: the auction loop's graph held against the host loop (the
   plain version, ``_solve(..., host_loop=True)``) on the same card
   tensors, every output bit for bit (tolerance 0): every solve of the
   flagship's cold round and three churned warm rounds, the last warm
   solve with ``collect_hist``, the flagship as a RowBlocks table of
   width 2 on the card, a fuse-limited solve (trivial pricing with
   preference arcs on 64 x 600, ``LOOP_FUSE`` = 2,000 rounds, not
   converged) and config 8's burst round at [scale]'s shape; for each
   the capture's ms, the graph's solve ms against the host loop's and
   both loop read counts; then a profiled warm round's device busy and
   idle share. K14 ``loop_ctl`` is held against its twin in [kernels]
   over every mode, flag, done and fuse case (and its LOOP mode, the
   general lane's, over every term shape) and timed there;
6. models: each of the six cost models prices the flagship's cost
   inputs (knowledge aggregates from a seeded generator) on the card
   exactly as on the CPU, timed beside its byte bound; then one cold
   flagship round under octopus (the reference's shipped selector) and
   one BASELINE config 3 round under coco, each equal in cost to the
   C++ oracle, with its backend (certified or degraded), rounds and
   wall time printed;
7. express: the express lane at full width on a bridge on the card
   over the flagship: one certified round, then 8 windows of 16 seeded
   arrivals (one machine or rack preference each) and 2 completions,
   each window confirming the last one's placements (K5 retires them).
   Per batch: certified, one result fetch, K4, K5, K7, K2 and K3
   launched, prep/upload/solve and event-to-bind ms, repair rounds, loop
   reads and the host time of ``_express_step`` outside ``_solve``
   printed (the eighth batch under ``torch.profiler``, with its CUDA
   kernels in all and outside ``_solve``); a correction
   round whose ``express_corrected`` equals the express placements it
   moved; and one last window, left unconfirmed, whose placements equal
   the next full round's choice per uid.

8. daemon: the port's scheduling daemon (``cli.run_loop``, in
   process, ``--device=cuda``, pipelined rounds, incremental scheduler
   and build, ``--max_rounds=3``) against the port's fake apiserver
   filled from ``config2_quincy_flagship(seed=0)``, with a seeded 1 %
   churn (100 pods deleted, 100 added) after the first round; once
   polling, once watching. Per dense round: every pending
   pod placed or left unscheduled by the optimum, every placement's
   POST landed, ``dense_auction``, cost equal to the C++ oracle on the
   bridge's own view of that round, one result fetch per auction solve
   (a warm round whose stale start does not certify re-runs cold, as
   the reference does: two solves, two fetches), K1-K3 each
   launched (counts zeroed just before each run); per-round timers
   (observe, build, dispatch, solve, fetch wait, POST) printed. At the
   end the server's bound pods are exactly the daemon's placements, and
   the watch lane's bindings equal the poll lane's. A third lane runs
   the express lane (``--watch=true --express_lane=true
   --express_shed_queue=0``, serial correction rounds, 12 s ticks, 2
   rounds: a flagship round's binding POSTs come back as thousands of
   pod events, past the default shed threshold) with 3 bursts of 16 pods
   added after the first round: every express binding's POST landed and
   the server binds each pod where express placed it, each placement is
   traced as EXPRESS_PLACE, and every express degrade is printed with
   its reason. A fourth lane runs the stream lane the same way
   (``--stream_windows=8``). A fifth polls with the scale flags
   (``--aggregate_classes=true --topk_prefs=2 --mesh_width=1``, 3
   rounds): every round dense, certified, K1-K3 and K8 launched, and
   equal in cost to the oracle on the graph with each task's
   preference arcs cut to its two heaviest.
9. stream: the stream lane at full width over the flagship: an 8-window
   flush of the express phase's schedule (16 arrivals and 2 completions
   a window) on a bridge on the card, one result fetch, K4, K5 and K7
   launched (counts zeroed just before), equal window by window and in
   its carry to the same flush on a bridge on the CPU; the synced
   express lane's agreement over the same windows is printed (ties go
   another way in the two lanes, in the reference too); a short flush
   (3 windows padded to 8, under ``torch.profiler``: CUDA kernels a
   window in all and outside ``_solve``); the full flush again, its
   graph cached (the steady state); each flush's host time a
   window outside ``_solve``; and a flush whose window 3 fails its
   certificate: windows 0-2 bind, the table and carry equal a clean
   3-window flush's, window 3's pods bind in the next round. Every
   flush on the card is one CUDA graph (the reference's ``lax.scan``:
   ``kernels/loop_graph.STREAM``): one launch, K windows from its
   tally, 0 loop reads, one fetch, captures and capture ms, the
   graph's device ms and the placements' e2b p50/p99 printed;
   and each is replayed by ``host_loop=True`` from copies of its card
   inputs (``TwinChain``): every window's log row and rounds and the
   carry equal bit for bit;
10. whatif: ``solve_what_if`` over BASELINE config 5 (1,000 machines x
   4,000 pods, quincy) with 64 variants on the card: every variant
   certified, variant 0 equal to the C++ oracle, variants 1 and 63
   equal to the CPU twins' solves of the same perturbed tables, one
   result fetch; total and per-variant ms and the loop reads printed;
11. service: a ``SchedulingService`` on the card over four tenants at
   real size (the flagship and config 5 under quincy, 200 x 2,000
   trivial and 64 x 600 random without preference arcs: four shape
   buckets), 2 warm-up and 3 measured waves with a seeded 1 % churn and
   every binding confirmed: each tenant equal to a solo bridge on the
   card and to the C++ oracle, K1-K3 launched per wave, one result
   fetch per dispatch chunk (one more per cold retry), no kernel build
   and no new launch plan in the measured waves; then
   ``cli.main(["--serve=true", "--serve_tenants=3", "--max_rounds=4",
   "--device=cuda"])``;
12. scale: ``check_table_budget`` refuses config 8's all-pairs table
   (524,288 x 65,536 int32); then BASELINE config 8
   (``synth.config8_scale(seed=0)``: 65,536 machines, 524,288 pods, 512
   machines a rack, 2 SKUs) through ``SchedulerBridge(aggregate_classes=
   True, topk_prefs=2, mesh_width=1)`` on the card with the oracle
   fallback off: the cold burst round, then 3 churn rounds of 16,384
   ``config8_arrivals`` and 16,384 deletions, bindings confirmed. Launch
   counts are zeroed just before and read just after; each round must
   be ``dense_auction``, certified, with one result fetch per solve (a
   stale warm start that re-runs cold is printed), and prints wall,
   prep, upload and solve ms, auction rounds, loop reads, Tp, Mp, the
   class count, the table's MiB and the peak allocated memory. One more
   churn round runs under ``torch.profiler`` (device busy time, idle
   share). Then exactness and widths: ``config8_scale(256, 2048,
   seed=1, machines_per_rack=32)`` aggregated with top-2 preferences at
   mesh widths 1, 2 and 4 (every shard on this card) bit-identical and
   equal to the oracle; the flagship plain and at widths 1, 2 and 4
   over a cold and a warm round, every integer output bit-identical
   (with each width's wall time); K8 as those rounds call it at widths
   1, 2 and 4 (a cold and a warm round each under ``torch.profiler``:
   its device time a launch, one launch a shard); the aggregated
   flagship's cost equal to the plain one's; ``sharded_certificate_gap``
   at width 4 equal to the solve's own gap;
13. general: the general-graph lane on the card, each solve one CUDA
   graph (cost-scaling's three nested loops, SSP's two; K14 ``loop_ctl``
   sets every WHILE and IF node on the device) with no loop read and one
   result fetch, held against the host loop (``_host_loop=True``, the
   plain version) on the same inputs, every output bit for bit and every
   kernel's launch count (the graph's from K14's tally) equal:
   cost-scaling over ``make_synthetic_cluster(200, 2000, seed=0)`` under
   quincy (also == the CPU twins, the reference's 1,744 sweeps and 12
   phases), with a blown fuse and with no supply; SSP there, at
   max_paths and with no supply; the quincy-priced flagship by
   cost-scaling (cost 771,192 = the C++ oracle's, the reference's 2,592
   sweeps and 13 phases, K9 2,592 and K10 1,928 launches) and by SSP (=
   oracle; K10 83,642 and K11 10,001 launches, one K11 call a path after
   its prologue); written to DIMACS, read back and solved through
   ``solve_scheduling`` with an empty-cluster meta (backend
   ``cost_scaling``, = oracle, one graph, no loop read), and through
   ``solve_scheduling``'s dense path cold and warm (= oracle). Each
   graph's capture ms and solve ms beside the host loop's wall ms, loop
   reads and fetches printed, K9-K11 and K1-K3 each launched;
14. ha: crash safety over the flagship daemon, each daemon in a child
   process against the fake apiserver's process, serial rounds, bursts
   of 16 pods between rounds. Daemon A checkpoints every round and
   SIGKILLs itself in round 3's actuation after half its binding POSTs
   landed (round 2's checkpoint on disk); daemon B (``--restore=true
   --standby=true``) restores it, replays the journal, runs round 3 and
   SIGKILLs itself in round 4's actuation; a standby
   (``--standby_lease_s=2``) follows B's checkpoints, takes over,
   restores round 3's checkpoint, replays B's journal and runs rounds 4
   and 5. The apiserver's op log binds every pod at most once, the
   standby's placements are the server's, each replay settles every
   intent of the round its leader died in, both first rounds restore
   warm (RESTORE, ``restored_warm`` on ``/readyz``, the restored seed
   used), and every dense round is certified, equals the C++ oracle
   with one fetch a solve and launches K1-K3, but for the standby's
   round 5, which runs out the auction's fuse in both packages and is
   held to the oracle's cost (``HA_FUSE_ROUNDS``); checkpoint write
   ms, restore ms, replay outcomes and the takeover seconds printed;
15. observe: the flagship daemon for 3 rounds with the flight recorder,
   the shadow audit every round, ``--slo=regret == 0`` on a metrics
   port, checkpoints and ``--explain`` of a pod that arrived for round
   3: round 1's fetches and loop reads equal the [daemon] poll lane's;
   an on-demand dump replayed on the card bit for bit; the explanation
   printed; ``validate`` of an unscheduled pod's diagnosis; the
   audit's regret 0; ``/slo`` served; capture us a round beside the
   warm rounds' wall, dump, replay and audit ms printed;
16. chaos: in a child process, the reference's four scenarios at their
   own sizes and seeds through the port's daemon on the card, then the
   scaled ``scenario_composite(nodes=80, pods=320)``, whose rounds run
   K1-K3 through its outage, node storm and post-fault burst: every
   invariant holds, every dense round equals the oracle with one fetch
   a solve, a dense round follows every fault, ``rounds_to_recover``
   printed;
17. analysis: the contract checker (``poseidon_tpu_torch.analysis``) on
   the card: (a) the whole tree with the suppression audit, 0
   violations, the files scanned and the seconds printed; (b) the op
   census of the six audited entries (``optrace_check.record_entries(
   "cuda")``, the same tiny instance) equal to the pinned CPU census
   (``analysis/op_fingerprints.json``), no float64, no host read outside
   ``SyncCounter.read``, no device move inside an entry, no library
   top-k in any entry and no library sort but a cold solve's clearing's;
   (c) the runtime
   sync map: a flagship cold round, a churned warm round, an express
   batch of 16 arrivals and an 8-window stream flush on one solver under
   ``torch.cuda.set_sync_debug_mode("warn")`` (warnings from every
   thread, the round's fetch worker included, each attributed to the
   innermost port frame): each window's synchronising calls inside
   ``SyncCounter.read`` equal the solver's own counters, every other one
   is a ``Contracts.sync_sites`` upload, and static PTA001 names every
   site the card reported; then a cost-scaling and an SSP flagship solve,
   each its tables' declared uploads and one read (its fetch), none in
   the loops;
18. adversarial: all 240 trials of the adversarial fuse sweep
   (``poseidon_tpu_torch.adversarial``: six cost models over 2-40
   machines x 2-150 tasks) on the card over 4 processes, the trials the
   reference ran out of their fuse started first (the longest): every
   converged dense solve equal to the C++ oracle, every exhausted one
   exact through ``solve_scheduling``, the exhausted list equal to the
   reference's (``ADVERSARIAL_EXHAUSTED``), K1-K3 launched; the
   exhausted count and a trial's p50 and max wall printed.

Each phase prints its seconds. ``--phases=a,b`` runs only the named
phases after the build, prints no record and no contract line (a quick
bring-up check). ``--keep_dir=DIR`` keeps, for a host with jax, the
flight-recorder dumps of [ha]'s standby in ``DIR/ha-standby`` (``python3
-m tests.replay_cold ref DUMP`` replays one through the reference) and
the snapshots [observe]'s shadow audit audited, with the port's
results, in ``DIR/audits`` (``python3 -m tests.audit_against_reference
DIR/audits``).
``--phases=ha_control`` (never in the whole run) drives [ha]'s daemon and
bursts for 6 rounds with no crash, to show which rounds run out the
auction's fuse without any crash-safety path.

The kernels' record counts K1-K3's, K12's and K13's launches in the
main path (a K12 or K13 launch is one wrapper call), K4-K5's
in the express phase, K7's in the stream phase's 8-window flush, K6's
in the what-if phase, K8's in the scale phase's config 8 rounds and
K9-K11's in the general phase's flagship run.

The last lines are the kernels' JSON record, the ``nvidia-smi`` line,
and the contract line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
# 32-bit integer scalar peak, set by ``int32_ops_per_s`` on the card: a
# Hopper SM has 64 INT32 lanes (NVIDIA H100 Tensor Core GPU Architecture
# white paper), one operation a lane a clock, at the card's maximum SM
# clock as ``nvidia-smi --query-gpu=clocks.max.sm`` reports it (about
# 16.7e12 for 132 SMs at 1,980 MHz). The data sheet's 67 TFLOP/s of
# float32 counts an FMA as two operations on 128 lanes: no int32 roof.
INT32_LANES_PER_SM = 64
INT32_OPS_PER_S = None
REPEATS = 30
SLEEP_CYCLES = 1_000_000         # ~0.5 ms of card time ahead of each timed call
# the hand kernels' CUDA symbols, as the profiler names them
KERNEL_SYMBOLS = ("densify_kernel", "row_options_kernel", "bid_pass_kernel",
                  "top_will_", "seat_")
EXPRESS_SYMBOLS = ("express_rows_kernel", "express_patch_kernel",
                   "stream_commit_kernel",
                   "row_options_kernel", "bid_pass_kernel")
# the kernels a resident round launches (K4 and K5 are the express lane's);
# a certified solve ends in a tighten step, so K12 runs in every one
ROUND_KERNELS = ("densify", "row_options", "bid_pass", "top_will", "seat_sort")
# the device of the stream, what-if and service phases (a rehearsal on a
# host without a card sets "cpu"; the script itself always runs "cuda")
DEVICE = "cuda"


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cost_kwargs(cluster):
    import numpy as np

    pending = cluster.pending()
    return dict(
        task_cpu_milli=np.array(
            [int(t.cpu_request * 1000) for t in pending], np.int64),
        task_mem_kb=np.array(
            [t.memory_request_kb for t in pending], np.int64),
    )


def churn(cluster, round_no: int, fraction: float = 0.01):
    """Retire ``fraction`` of the pods and add as many new ones, seeded
    by the round number (new pods are shaped like the synth's)."""
    import numpy as np

    from poseidon_tpu_torch.cluster import ClusterState, Task

    rng = np.random.default_rng(1000 + round_no)
    tasks = list(cluster.tasks)
    k = max(int(len(tasks) * fraction), 1)
    drop = set(rng.choice(len(tasks), size=k, replace=False).tolist())
    kept = [t for i, t in enumerate(tasks) if i not in drop]
    machines = cluster.machines
    names = [m.name for m in machines]
    racks = sorted({m.rack for m in machines})
    for j in range(k):
        home = racks[int(rng.integers(0, len(racks)))]
        in_home = [n for n, m in zip(names, machines) if m.rack == home]
        prefs = {
            str(n): int(rng.integers(20, 200))
            for n in rng.choice(in_home, size=min(2, len(in_home)),
                                replace=False)
        }
        if rng.random() < 0.3:
            prefs[home] = int(rng.integers(10, 100))
        kept.append(Task(
            uid=f"pod-r{round_no}-{j:05d}", job=f"job-r{round_no}-{j // 8}",
            cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
            memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
            data_prefs=prefs, wait_rounds=int(rng.integers(0, 4)),
        ))
    return ClusterState(machines=machines, tasks=kept)


class Timer:
    """Median CUDA-event time of a call, the L2 cache flushed first by
    reading 128 MiB (a read leaves no dirty line in L2 for the call's
    own reads to write back on eviction, as a flush by writing would).

    The card spins for ~0.5 ms (``torch.cuda._sleep``) between the flush
    and the start event, so the host has enqueued the call before the
    card reaches the start event: the time is the card's alone, not the
    wrapper's host time (which a slow host can make longer than the
    flush)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.zeros(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, repeats: int = REPEATS) -> float:
        torch = self.torch
        fn()                                   # warm up
        times = []
        for _ in range(repeats):
            self.flush.max()
            torch.cuda._sleep(SLEEP_CYCLES)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        times.sort()
        return times[len(times) // 2]

    def in_graph(self, fn, calls: int = 32, repeats: int = REPEATS) -> float:
        """Median device ms of one call of ``fn`` as a CUDA graph runs it:
        ``calls`` calls captured back to back in one graph, the graph's
        span between CUDA events over ``calls`` (L2 warm: the calls
        follow one another, as a flush's kernels follow the window's
        other work)."""
        torch = self.torch
        fn()                                   # warm up
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                fn()
        times = []
        for _ in range(repeats):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            graph.replay()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        graph.reset()
        times.sort()
        return times[len(times) // 2]


def max_abs_err(got, want) -> int:
    import torch

    err = 0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"shape/dtype {g.shape}/{g.dtype} vs "
                                 f"{w.shape}/{w.dtype}")
        d = g.to(torch.int64) - w.to(torch.int64)
        err = max(err, int(d.abs().max()) if d.numel() else 0)
    return err


def int32_ops_per_s(torch) -> float:
    """The card's 32-bit integer scalar peak (see INT32_LANES_PER_SM)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        raise RuntimeError(f"nvidia-smi failed: {out.stderr.strip()}")
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * INT32_LANES_PER_SM * mhz * 1e6


def bound_ms(n_bytes: int, n_ops: int) -> tuple[float, str]:
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def flagship_inputs(torch, device):
    """The flagship round's densify inputs, priced on the card."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.network import pad_bucket
    from poseidon_tpu_torch.models.costs import (
        build_cost_inputs_host, quincy_cost,
    )
    from poseidon_tpu_torch.ops.resident import _redensify, pad_topology
    from poseidon_tpu_torch.ops.transport import extract_topology
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    cluster = config2_quincy_flagship(seed=0)
    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    topo = extract_topology(meta, arrays["src"], arrays["dst"], arrays["cap"])
    dt = pad_topology(topo).to_device(device)
    inputs = build_cost_inputs_host(
        pad_bucket(meta.n_arcs), meta, **cost_kwargs(cluster)
    ).to_device(device)
    smax = min(pad_bucket(int(topo.slots.max()), minimum=1),
               dt.arc_unsched.shape[0])
    return dt, quincy_cost(inputs), smax


def kernel_phase(torch, timer):
    """Hold K1-K3 against their twins at the flagship's shapes and time
    them. Returns the kernels' records (launches filled in later)."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import densify as k1
    from poseidon_tpu_torch.kernels import row_options as k2
    from poseidon_tpu_torch.ops.dense_auction import INF, _theta_clearing
    from poseidon_tpu_torch.ops.resident import _redensify

    dev = torch.device("cuda")
    dt, cost, smax = flagship_inputs(torch, dev)
    P = dt.pref_machine.shape[1]
    inst, _, pc_s, ra_s = _redensify(dt, cost, n_prefs=P, smax=smax)
    # the channel arrays exactly as _redensify hands them to densify
    a1 = (inst.w, inst.dgen, ra_s, dt.rack_of, dt.slots, pc_s,
          dt.pref_machine, dt.pref_rack)
    Tp, Mp = inst.c.shape
    records = []

    # K1 densify
    got = k1.densify(*a1, n_prefs=P)
    want = k1.densify_plain(*a1, n_prefs=P)
    err = max_abs_err([got], [want])
    b = Tp * Mp * 4 + Tp * 4 + 4 * Mp * 4 + 3 * Tp * a1[5].shape[1] * 4
    ops = Tp * Mp * (3 + 6 * P)
    records.append((k1.KERNEL, err, timer(lambda: k1.densify(*a1, n_prefs=P)),
                    timer(lambda: k1.densify_plain(*a1, n_prefs=P)),
                    *bound_ms(b, ops), (Tp, Mp, P)))
    # yardstick, not a call the port makes: one fill_ of a table of c's
    # size, what the card reaches writing the same bytes
    table = torch.empty((Tp, Mp), dtype=torch.int32, device=dev)
    log(f"[kernels] densify write_floor_ms={timer(lambda: table.fill_(0)):.6f} "
        f"(one fill_ of an int32 [{Tp}, {Mp}] table, L2 flushed)")
    del table

    # K2 row_options, at the stage-one clearing prices of the cold round
    lam = _theta_clearing(inst)[2]
    p = torch.where(inst.s > 0, lam, INF).contiguous()
    got = k2.row_options(inst.c, p)
    want = k2.row_options_plain(inst.c, p)
    err = max_abs_err(got, want)
    b = Tp * Mp * 4 + Mp * 4 + 3 * Tp * 4
    ops = Tp * Mp * 6
    records.append((k2.KERNEL, err, timer(lambda: k2.row_options(inst.c, p)),
                    timer(lambda: k2.row_options_plain(inst.c, p)),
                    *bound_ms(b, ops), (Tp, Mp)))

    # K3 bid_pass: a full window (B = 2560) of distinct tasks with a
    # fifth of the slots invalid, at the same prices, eps = 1
    B = min(Tp, max(1024, Tp // 4))
    rng = np.random.default_rng(7)
    btask = torch.from_numpy(
        rng.choice(Tp, size=B, replace=False).astype(np.int32)).to(dev)
    bvalid = torch.from_numpy(rng.random(B) < 0.8).to(dev)
    # K3 reads eps from the card
    eps1 = torch.ones((), dtype=torch.int32, device=dev)
    args3 = (inst.c, p, inst.u, btask, bvalid, eps1)
    got = k3.bid_pass(*args3)
    want = k3.bid_pass_plain(*args3)
    err = max_abs_err(got, want)
    rows = int(torch.unique(btask).numel())
    b = rows * Mp * 4 + Mp * 4 + rows * 4 + B * 4 + B + 4 * B * 4 + B
    ops = rows * Mp * 8
    records.append((k3.KERNEL, err, timer(lambda: k3.bid_pass(*args3)),
                    timer(lambda: k3.bid_pass_plain(*args3)),
                    *bound_ms(b, ops), (B, Mp)))
    records += express_kernel_records(torch, timer, inst, dt, ra_s)
    records.append(stream_commit_record(torch, timer))
    records.append(perturb_record(torch, timer))
    records.append(gap_rows_record(torch, timer))
    records += general_kernel_records(torch, timer)
    calls = loop_calls(torch, inst, smax)
    records.append(top_will_record(torch, timer, calls))
    records.append(seat_sort_records(torch, timer, calls))
    records.append(loop_ctl_record(torch, timer))
    del calls
    torch.cuda.synchronize()
    for mod, fn, args, key in (
        (k1, lambda *a: k1.densify(*a, n_prefs=P), a1, (Tp, Mp, P, P)),
        (k2, k2.row_options, (inst.c, p), (Tp, Mp)),
        (k3, k3.bid_pass, args3, (B, Mp)),
    ):
        host, wall = host_us(torch, lambda: fn(*args))
        plan = mod.PLANS[(inst.c.device, *key)]
        log(f"[kernels] {mod.KERNEL.name} wrapper host_us={host:.3f} "
            f"wall_us={wall:.3f} per call (median of {HOST_BATCHES} x "
            f"{HOST_CALLS} calls) plan={plan}")
    edge_battery(torch)
    shard_edges(torch)
    general_edges(torch)
    for k, err, ms, plain, bms, by, shape in records:
        # K4, K5 and K7 move tens to hundreds of KiB: their bound is a
        # small fraction of one launch's fixed cost
        launch = " launch-bound" if ms > 100 * bms else ""
        log(f"[kernels] {k.name} shape={shape} max_abs_err={err} "
            f"ms={ms:.6f} plain_ms={plain:.6f} bound_ms={bms:.6f} ({by})"
            f"{launch}")
        if err != 0:
            raise AssertionError(f"{k.name}: kernel != plain twin "
                                 f"(max_abs_err {err}, tolerance 0)")
    return records


HOST_CALLS = 100
HOST_BATCHES = 7


def host_us(torch, fn) -> tuple[float, float]:
    """Host microseconds per call of ``fn`` over HOST_CALLS calls: the
    calls alone (no synchronise), and with the one synchronise at the
    end; each the median of HOST_BATCHES batches."""
    fn()
    host, wall = [], []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) / HOST_CALLS * 1e6)
        wall.append((t2 - t0) / HOST_CALLS * 1e6)
    return sorted(host)[HOST_BATCHES // 2], sorted(wall)[HOST_BATCHES // 2]


def edge_tables(torch, rng, Tp, Mp, kind):
    """A table c[Tp, Mp] and prices p[Mp] on the card (int32) of one
    edge kind."""
    import numpy as np

    inf = 2**29
    if kind == "rand":           # costs with INF holes, a few INF prices
        c = rng.integers(0, 5000, (Tp, Mp))
        c[rng.random((Tp, Mp)) < 0.1] = inf
        p = rng.integers(0, 3000, Mp)
        p[rng.random(Mp) < 0.05] = inf
    elif kind == "tied":         # c + p is one value per row: all tie
        p = rng.integers(0, 3000, Mp)
        c = rng.integers(3000, 9000, (Tp, 1)) - p[None, :]
    elif kind == "inf":          # every entry INF-saturates
        c = np.full((Tp, Mp), inf)
        p = rng.integers(0, 3000, Mp)
    elif kind == "wrap":         # sums leave int32 and wrap negative
        c = rng.integers(2**31 - 2**20, 2**31, (Tp, Mp))
        p = rng.integers(0, 2**30, Mp)
        p[rng.random(Mp) < 0.1] = inf
    elif kind == "saturate":     # INF + INF and INF + small everywhere
        c = np.where(rng.random((Tp, Mp)) < 0.5, inf,
                     rng.integers(0, 100, (Tp, Mp)))
        p = np.where(rng.random(Mp) < 0.5, inf, rng.integers(0, 100, Mp))
    else:
        raise ValueError(kind)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)).to(DEVICE)
    return to(c), to(p)


def densify_inputs(torch, rng, Tp, Mp, Pw, kind):
    """K1's channel arrays on the card (int32) of one edge kind: w[Tp],
    d/ra/rack_of/slots[Mp], pc/pm/pr[Tp, Pw]. The last eighth of the
    columns is padding (slots 0, rack -1), as the padded instance has."""
    import numpy as np

    inf = 2**29
    racks = max(Mp // 8, 1)
    real = Mp - Mp // 8
    rack_of = np.where(np.arange(Mp) < real, rng.integers(0, racks, Mp), -1)
    slots = np.where(np.arange(Mp) < real, rng.integers(0, 4, Mp), 0)
    w = np.where(rng.random(Tp) < 0.1, inf, rng.integers(0, 5000, Tp))
    d = np.where(rng.random(Mp) < 0.1, inf, rng.integers(0, 5000, Mp))
    ra = np.where(rng.random(Mp) < 0.1, inf, rng.integers(0, 5000, Mp))
    pc = np.where(rng.random((Tp, Pw)) < 0.1, inf,
                  rng.integers(0, 3000, (Tp, Pw)))
    pm = np.where(rng.random((Tp, Pw)) < 0.3, -1,
                  rng.integers(0, real, (Tp, Pw)))
    pr = np.where(rng.random((Tp, Pw)) < 0.5, -1,
                  rng.integers(0, racks, (Tp, Pw)))
    if kind == "none":           # no task has a preference
        pm[:], pr[:] = -1, -1
    elif kind == "padhit":       # preferences on padded columns, racks -1
        pm = rng.integers(real - 1, Mp, (Tp, Pw))
        pr = rng.integers(-1, 1, (Tp, Pw))
    elif kind == "noslots":      # every slot 0: the whole table is INF
        slots[:] = 0
    elif kind == "winf":         # w all INF: only preferences are finite
        w[:] = inf
    elif kind == "wrap":         # w + d and pc + ra leave int32 and wrap
        w = rng.integers(2**31 - 2**20, 2**31, Tp)
        d = rng.integers(2**30, 2**31, Mp)
        pc = rng.integers(2**31 - 2**20, 2**31, (Tp, Pw))
        ra = rng.integers(2**30, 2**31, Mp)
    elif kind != "rand":
        raise ValueError(kind)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)).to("cuda")
    return tuple(map(to, (w, d, ra, rack_of, slots, pc, pm, pr)))


def densify_edges(torch, rng, big):
    """K1 equals its twin (tolerance 0) at the tile writer's edges."""
    from poseidon_tpu_torch.kernels import densify as k1

    cases = [  # (Tp, Mp, Pw, n_prefs, kind)
        (1, 16, 1, 1, "rand"), (3, 64, 3, 3, "rand"),
        (5, 1028, 5, 5, "rand"), (1003, 1024, 3, 3, "rand"),
        (700, 16, 5, 5, "rand"), (700, 64, 3, 1, "rand"),
        (150, 1028, 5, 0, "rand"), (64, big, 3, 3, "rand"),
        (517, 1024, 5, 5, "none"), (800, 64, 3, 3, "padhit"),
        (41, 1028, 1, 1, "padhit"), (200, 1024, 3, 3, "noslots"),
        (333, 1028, 1, 1, "winf"), (1000, 1024, 5, 5, "wrap"),
        (77, big, 5, 5, "wrap"), (2000, 16, 3, 3, "wrap"),
        (129, 1024, 0, 0, "rand"), (300, 16, 48, 48, "rand"),
    ]
    for Tp, Mp, Pw, n, kind in cases:
        a = densify_inputs(torch, rng, Tp, Mp, Pw, kind)
        err = max_abs_err([k1.densify(*a, n_prefs=n)],
                          [k1.densify_plain(*a, n_prefs=n)])
        plan = k1.PLANS[a[0].device, Tp, Mp, Pw, n]
        log(f"[edges] densify Tp={Tp} Mp={Mp} Pw={Pw} n_prefs={n} {kind}: "
            f"max_abs_err={err} grid={plan.grid} cols={plan.cols} "
            f"tile_rows={plan.tile_rows} stages={plan.stages}")
        if err != 0:
            raise AssertionError(f"densify edge Tp={Tp} Mp={Mp} Pw={Pw} "
                                 f"n_prefs={n} {kind}: kernel != twin "
                                 f"(max_abs_err {err})")


def edge_battery(torch):
    """K1, K2 and K3 equal their twins (tolerance 0) at the designs' edges."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import row_options as k2
    from poseidon_tpu_torch.kernels import row_stream

    # the first Mp on the pad_bucket ladder (multiples of 1024) whose p
    # does not fit in shared memory beside K3's ring, nor K2's
    big = 1024
    while (row_stream.layout(big).p_resident
           or row_stream.layout(big, k3.META_INTS).p_resident):
        big += 1024
    rng = np.random.default_rng(2024)
    densify_edges(torch, rng, big)
    cases2 = [  # (Tp, Mp, kind)
        (37, 16, "rand"), (1000, 64, "rand"), (700, 1028, "rand"),
        (150, big, "rand"), (5, 1024, "rand"), (3, 16, "rand"),
        (600, 1024, "tied"), (300, 1028, "inf"), (500, 1024, "wrap"),
        (64, big, "wrap"), (400, 64, "saturate"), (90, big, "tied"),
    ]
    for Tp, Mp, kind in cases2:
        c, p = edge_tables(torch, rng, Tp, Mp, kind)
        err = max_abs_err(k2.row_options(c, p), k2.row_options_plain(c, p))
        plan = k2.PLANS[c.device, Tp, Mp]
        log(f"[edges] row_options Tp={Tp} Mp={Mp} {kind}: max_abs_err={err} "
            f"grid={plan.grid} stages={plan.layout.stages} "
            f"chunk={plan.layout.chunk} p_resident={plan.layout.p_resident}")
        if err != 0:
            raise AssertionError(f"row_options edge Tp={Tp} Mp={Mp} {kind}: "
                                 f"kernel != twin (max_abs_err {err})")
    cases3 = [  # (Tp, Mp, B, kind, btask mode, eps)
        (100, 1024, 1, "rand", "distinct", 1),
        (1000, 1024, 100, "rand", "distinct", 3),
        (5, 64, 5, "rand", "distinct", 1),
        (2000, 1024, 1024, "rand", "padded", 1),
        (64, 16, 64, "rand", "repeat", 7),
        (700, 1028, 300, "rand", "padded", 1),
        (200, big, 150, "rand", "padded", 2),
        (600, 1024, 512, "tied", "distinct", 1),
        (300, 1024, 256, "inf", "padded", 1),
        (500, 1024, 500, "wrap", "repeat", 2**28),
        (400, 64, 333, "saturate", "padded", 1),
        (64, big, 40, "wrap", "repeat", 5),
    ]
    for Tp, Mp, B, kind, mode, eps in cases3:
        c, p = edge_tables(torch, rng, Tp, Mp, kind)
        u = torch.from_numpy(np.where(
            rng.random(Tp) < 0.2, 2**29, rng.integers(0, 6000, Tp)
        ).astype(np.int32)).to("cuda")
        if mode == "distinct":
            bt = rng.choice(Tp, size=B, replace=False)
            ok = rng.random(B) < 0.8
        elif mode == "padded":   # the window's padding slots: row Tp-1
            n = B // 2
            bt = np.concatenate([rng.choice(Tp - 1, size=n, replace=False),
                                 np.full(B - n, Tp - 1)])
            ok = np.arange(B) < n
        else:                    # any task, any number of times
            bt = rng.integers(0, Tp, B)
            ok = rng.random(B) < 0.5
        btask = torch.from_numpy(bt.astype(np.int32)).to("cuda")
        bvalid = torch.from_numpy(ok).to("cuda")
        args = (c, p, u, btask, bvalid,
                torch.full((), eps, dtype=torch.int32, device="cuda"))
        err = max_abs_err(k3.bid_pass(*args), k3.bid_pass_plain(*args))
        plan = k3.PLANS[c.device, B, Mp]
        log(f"[edges] bid_pass Tp={Tp} Mp={Mp} B={B} {kind} {mode} eps={eps}: "
            f"max_abs_err={err} grid={plan.grid} stages={plan.layout.stages} "
            f"chunk={plan.layout.chunk} p_resident={plan.layout.p_resident}")
        if err != 0:
            raise AssertionError(f"bid_pass edge Tp={Tp} Mp={Mp} B={B} {kind}: "
                                 f"kernel != twin (max_abs_err {err})")


# ---- K12 top_will and K13 seat_sort: the auction loop's selection and sorts


# the library call each of K12's and K13's forms replaced, timed alone on
# the same inputs (its own input made outside the timing): K12's
# ``torch.topk`` over the transposed will table, K13's ``torch.sort`` of
# the packed keys (one stable int64 sort) and of the compaction's key
LIBRARY_MS = {}


def _clone(x):
    import torch

    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clone(v) for v in x)
    return x


def loop_calls(torch, inst, smax: int) -> dict:
    """The inputs of the first call of each K12 and K13 form in a
    flagship cold solve on the card (``_solve`` with the analytic init,
    as the resident round runs it): ``top_will``, the 3- and 4-key sorts
    and the compaction."""
    from poseidon_tpu_torch.ops import dense_auction as da

    got = {}
    saved = {n: getattr(da, n) for n in ("seat_sort", "seat_compact",
                                         "top_will")}

    def keep(name, form):
        fn = saved[name]

        def call(*a):
            got.setdefault(form(*a), _clone(a))
            return fn(*a)
        return call

    da.seat_sort = keep("seat_sort", lambda keys, spans: f"sort{len(keys)}")
    da.seat_compact = keep("seat_compact", lambda w, B: "compact")
    da.top_will = keep("top_will", lambda parts, s, smax: "top_will")
    try:
        # the host loop on the card: the graph's kernels are not called
        # from Python, the host loop's are
        out = da._solve(inst, *da.cold_start(inst), alpha=1024,
                        max_rounds=FUSE_ROUNDS, smax=smax, analytic_init=True,
                        host_loop=True)
    finally:
        for n, fn in saved.items():
            setattr(da, n, fn)
    log(f"[kernels] loop inputs from a flagship cold solve: rounds={out[5]} "
        f"phases={out[6]} forms={sorted(got)}")
    missing = {"top_will", "sort3", "sort4", "compact"} - set(got)
    if missing:
        raise AssertionError(f"flagship cold solve never called {missing}")
    return got


def will_table_t(torch, part):
    """will.T of one table part, as the twin (and the port before K12)
    builds it."""
    c, a1, a2, m1, tv = part
    inf = 2**29
    mids = torch.arange(c.shape[1], dtype=torch.int32, device=c.device)
    alt = torch.where(mids[None, :] == m1[:, None], a2[:, None], a1[:, None])
    will = torch.where(tv[:, None], torch.clamp(alt - c, -inf, inf), -inf)
    return will.T.contiguous()


def top_will_record(torch, timer, calls):
    """K12 at the flagship's first deflate: kernel vs twin, cold times,
    the bound (the table's bytes once) and ``torch.topk`` alone."""
    from poseidon_tpu_torch.kernels import top_will as k12

    parts, s, smax = calls["top_will"]
    c = parts[0][0]
    Tp, Mp = c.shape
    err = max_abs_err([k12.top_will(parts, s, smax)],
                      [k12.top_will_plain(parts, s, smax)])
    ms = timer(lambda: k12.top_will(parts, s, smax))
    plain = timer(lambda: k12.top_will_plain(parts, s, smax))
    will_t = will_table_t(torch, parts[0])
    LIBRARY_MS["top_will"] = timer(lambda: torch.topk(will_t, smax, dim=1))
    del will_t
    p = k12.PLANS[c.device, Tp, Mp, smax]
    log(f"[kernels] top_will plan={p} smax={smax} "
        f"library_ms(torch.topk of will.T)={LIBRARY_MS['top_will']:.6f}")
    if p.method == "list" and len(parts) == 1:
        log(f"[kernels] top_will list launch: {p.col_blocks} clusters of "
            f"{p.slabs} blocks; clusters the card holds at once by blocks "
            f"a cluster: {k12.list_clusters(c.device, Mp, smax, Tp)}")
        runs = [k12.phase_stamps(parts[0], s, smax) for _ in range(10)][1:]
        st = [sorted(r[i] for r in runs)[len(runs) // 2] for i in range(5)]
        names = ("fold", "block tree", "cluster read", "cluster tree+write")
        log("[kernels] top_will by phase (us at the max SM clock, block "
            f"(0, 0)): total {clock_us(st[4] - st[0]):.3f} = " + ", ".join(
                f"{nm} {clock_us(b - a):.3f}"
                for nm, a, b in zip(names, st, st[1:])))
    b = Tp * Mp * 4 + Tp * 13 + Mp * 8
    ops = Tp * Mp * 8
    return (k12.KERNEL, err, ms, plain, *bound_ms(b, ops), (Tp, Mp, smax))


def packed_keys(torch, keys, spans):
    """The keys as one int64 each (the fields K13 packs), when they fit
    in 63 bits; None otherwise."""
    from poseidon_tpu_torch.kernels.seat_sort import field_bits

    bits = [field_bits(sp) for sp in spans]
    if sum(bits) > 63:
        return None
    out = torch.zeros(keys[0].shape[0], dtype=torch.int64,
                      device=keys[0].device)
    for k, (lo, _hi), b in zip(keys, spans, bits):
        out = (out << b) | (k.to(torch.int64) - lo)
    return out


def seat_sort_bytes_ops(n: int, nkeys: int, width: int) -> tuple[int, int]:
    """Keys read and written once; per key a pass: a digit, a rank and an
    address (3 int32 operations), beside packing and unpacking."""
    return 2 * nkeys * n * 4, n * (4 * nkeys + 3 * -(-width // 8))


def seat_sort_records(torch, timer, calls):
    """K13 at the flagship's first call of each form: the 4-key sort of
    ``auction_round`` (the record), the 3-key sort of ``to_sorted`` and
    the bid window's compaction (printed)."""
    from poseidon_tpu_torch.kernels import seat_sort as k13

    record = None
    for form in ("sort4", "sort3", "compact"):
        if form == "compact":
            waiting, B = calls[form]
            n = waiting.shape[0]
            run = lambda: k13.seat_compact(waiting, B)  # noqa: E731
            twin = lambda: k13.seat_compact_plain(waiting, B)  # noqa: E731
            key = torch.where(
                waiting, torch.arange(n, dtype=torch.int32,
                                      device=waiting.device), n)
            lib = lambda: torch.sort(key)  # noqa: E731
            b, ops = n + B * 4, n * 3
            shape = (n, B, int(waiting.sum()))
            plan_key = ("compact", waiting.device, n)
        else:
            keys, spans = calls[form]
            n = keys[0].shape[0]
            run = lambda: k13.seat_sort(keys, spans)  # noqa: E731
            twin = lambda: k13.seat_sort_plain(*keys)  # noqa: E731
            packed = packed_keys(torch, keys, spans)
            lib = (None if packed is None else
                   lambda: torch.sort(packed, stable=True))  # noqa: E731
            bits = tuple(k13.field_bits(sp) for sp in spans)
            b, ops = seat_sort_bytes_ops(n, len(keys), sum(bits))
            shape = (n, len(keys), sum(bits))
            plan_key = ("sort", keys[0].device, n, bits)
        err = max_abs_err(list(_as_tuple(run())), list(_as_tuple(twin())))
        plan = k13.PLANS[plan_key]
        ms = timer(run)
        plain = timer(twin)
        lib_ms = timer(lib) if lib is not None else None
        bms, by = bound_ms(b, ops)
        log(f"[kernels] seat_sort {form} shape={shape} max_abs_err={err} "
            f"ms={ms:.6f} plain_ms={plain:.6f} library_ms={lib_ms} "
            f"bound_ms={bms:.6f} ({by}) plan={plan}")
        if err != 0:
            raise AssertionError(f"seat_sort {form}: kernel != plain twin "
                                 f"(max_abs_err {err}, tolerance 0)")
        if form == "sort4":
            LIBRARY_MS["seat_sort"] = lib_ms
            record = (k13.KERNEL, err, ms, plain, bms, by, shape)
        if form != "compact":
            seat_sort_phases(torch, form, keys, spans)
    return record


def clock_us(cycles: int) -> float:
    """SM cycles as us at the card's maximum SM clock (the clock the
    int32 bound assumes; the card may run slower under load)."""
    return cycles / (INT32_OPS_PER_S / INT32_LANES_PER_SM
                     / torch_sm_count()) * 1e6


def torch_sm_count() -> int:
    import torch

    return torch.cuda.get_device_properties(0).multi_processor_count


def seat_sort_phases(torch, form, keys, spans) -> None:
    """K13's split by phase (clock64() stamps of thread 0 of block 0 by
    the stamps build, medians of 9 launches after a warm-up): the pack,
    each level (with the keys it split) and the rank step, and levels 0
    and 1 by step."""
    from poseidon_tpu_torch.kernels import seat_sort as k13

    runs = [k13.phase_stamps(keys, spans) for _ in range(10)][1:]
    st = [sorted(r[i] for r in runs)[len(runs) // 2]
          for i in range(k13.STAMPS)]
    levels = min(runs[-1][k13.STAMP_LEVELS], k13.STAMP_LEVEL_MAX)
    ends = [st[k13.STAMP_PACKED]] + [st[k13.STAMP_LEVEL + lv]
                                     for lv in range(levels)]
    us = lambda a, b: f"{clock_us(b - a):.3f}"  # noqa: E731
    parts = [f"pack {us(st[k13.STAMP_START], st[k13.STAMP_PACKED])}"]
    for lv in range(levels):
        listed = (runs[-1][k13.STAMP_LISTED + lv]
                  if lv < k13.STAMP_LISTED_MAX else "?")
        parts.append(f"level{lv} ({listed} keys) {us(ends[lv], ends[lv + 1])}")
    parts.append(f"rank+write {us(ends[-1], st[k13.STAMP_END])}")
    for lv, at in enumerate(k13.STAMP_STEPS[:levels]):
        marks = [ends[lv], *st[at:at + len(k13.STEPS)], ends[lv + 1]]
        names = (*k13.STEPS, "next list")
        parts.append(f"level{lv} = " + ", ".join(
            f"{nm} {us(a, b)}" for nm, a, b in zip(names, marks, marks[1:])))
    log(f"[kernels] seat_sort {form} split by phase (us at the max SM "
        f"clock, block 0): total {us(st[k13.STAMP_START], st[k13.STAMP_END])}"
        " = " + ", ".join(parts))


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def top_will_inputs(torch, rng, Tp, Mp, smax, kind):
    """K12's arguments on the card: one table part (c, alt1, alt2, m1,
    task_valid) and s, of one edge kind."""
    import numpy as np

    inf = 2**29
    c = rng.integers(0, 5000, (Tp, Mp))
    c[rng.random((Tp, Mp)) < 0.1] = inf
    alt1 = rng.integers(0, 6000, Tp)
    alt2 = np.minimum(alt1 + rng.integers(0, 500, Tp), inf)
    alt1[rng.random(Tp) < 0.05] = inf
    m1 = rng.integers(0, Mp, Tp)
    tv = rng.random(Tp) < 0.9
    if kind == "tied":           # every will the same value
        c[:] = 7
        alt1[:] = 100
        alt2[:] = 100
        tv[:] = True
    elif kind == "inf":          # alt - c past +-INF, and wrapping int32
        c = rng.integers(-2**31, 2**31, (Tp, Mp))
        alt1 = rng.integers(-2**31, 2**31, Tp)
        alt2 = rng.integers(-2**31, 2**31, Tp)
    elif kind == "ninfcol":      # every third column -INF in every row
        c[:, ::3] = 2**31 - 1
    elif kind == "invalid":      # no valid task: every column all -INF
        tv[:] = False
    elif kind != "rand":
        raise ValueError(kind)
    s = rng.integers(0, smax + 3, Mp)
    s[0] = 0
    s[-1] = smax + 5
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)).to("cuda")
    part = (to(c), to(alt1), to(alt2), to(m1),
            torch.from_numpy(tv).to("cuda"))
    return part, to(s)


def shard_parts(part, shards: int):
    """One table part cut into ``shards`` row blocks (each cloned, so
    every block is aligned as the mesh's are)."""
    Tp = part[0].shape[0]
    h = Tp // shards
    return [tuple(x[k * h:(k + 1) * h].clone() for x in part)
            for k in range(shards)]


TOP_WILL_CASES = [  # (Tp, Mp, smax, kind, shards)
    (1, 16, 1, "rand", 1), (3, 16, 2, "rand", 1), (3, 1028, 3, "rand", 1),
    (700, 16, 16, "rand", 1), (700, 1028, 33, "rand", 1),
    (2000, 16, 1024, "rand", 1), (1025, 64, 1025, "rand", 1),
    (1000, 1028, 1, "rand", 1), (10240, 1024, 16, "rand", 1),
    (10240, 1024, 1024, "rand", 1), (10240, 1024, 10240, "rand", 1),
    (300, 12292, 16, "rand", 1), (200, 12292, 40, "rand", 1),
    (500, 1024, 16, "tied", 1), (500, 1024, 64, "tied", 1),
    (400, 1028, 8, "inf", 1), (400, 1028, 100, "inf", 1),
    (300, 64, 4, "invalid", 1), (300, 64, 50, "invalid", 1),
    (600, 1024, 32, "ninfcol", 1), (600, 1024, 2, "ninfcol", 1),
    (1024, 1024, 16, "rand", 2), (1024, 1024, 16, "rand", 4),
    (2048, 256, 100, "rand", 2), (2048, 256, 100, "rand", 4),
    (10240, 1024, 16, "rand", 4), (65536, 256, 2048, "rand", 1),
    # the one-launch list method: one slab (a cluster of one), clusters of
    # 3 and 5 (trees over lists that are not a power of two), a ragged
    # last slab, K 32 (one block an SM), Mp 16 and 12,292, shards
    (100, 1024, 16, "rand", 1), (12, 16, 1, "rand", 1),
    (40, 1028, 2, "rand", 1), (10239, 1024, 16, "rand", 1),
    (700, 1024, 16, "tied", 1), (1000, 12292, 32, "rand", 1),
    (5000, 12292, 8, "ninfcol", 1), (4097, 16, 32, "inf", 1),
    (10240, 1024, 16, "rand", 2), (2050, 1028, 32, "rand", 2),
    (4100, 16, 4, "rand", 4),
]


def top_will_edges(torch) -> None:
    """K12 equals its twin (tolerance 0) at its plan's edges: smax 1, 2,
    16, 33, 1,024 and Tp (both methods and the switch between them); Tp 1,
    3, past one slab and 10,240; Mp 16, 1,028 and 12,292; all -INF
    columns; invalid tasks; s 0 and s > smax; every value tied; alt - c
    past +-INF; a 2- and 4-shard merge equal to the whole table."""
    import numpy as np

    from poseidon_tpu_torch.kernels import top_will as k12

    rng = np.random.default_rng(1215)
    for Tp, Mp, smax, kind, shards in TOP_WILL_CASES:
        part, s = top_will_inputs(torch, rng, Tp, Mp, smax, kind)
        parts = [part] if shards == 1 else shard_parts(part, shards)
        got = k12.top_will(parts, s, smax)
        err = max_abs_err([got], [k12.top_will_plain([part], s, smax)])
        if shards > 1:   # the twin's own mesh form too
            err = max(err, max_abs_err(
                [got], [k12.top_will_plain(parts, s, smax)]))
        p = k12.PLANS[part[0].device, Tp // shards, Mp, smax]
        log(f"[edges] top_will Tp={Tp} Mp={Mp} smax={smax} {kind} "
            f"shards={shards}: max_abs_err={err} method={p.method} k={p.k} "
            f"slabs={p.slabs} rows_per_slab={p.rows_per_slab} "
            f"col_blocks={p.col_blocks}")
        if err != 0:
            raise AssertionError(f"top_will edge Tp={Tp} Mp={Mp} smax={smax} "
                                 f"{kind} shards={shards}: kernel != twin "
                                 f"(max_abs_err {err})")


def seat_keys(torch, rng, n, Mp, nkeys, kind):
    """K13's keys and spans on the card, as the auction loop makes them:
    the segment in [0, Mp + 3), the negated level, is_bid, the task id
    (a permutation); ``wide``: four keys of the whole int32 range."""
    import numpy as np

    from poseidon_tpu_torch.kernels.seat_sort import INT32

    inf = 2**29
    nseg = Mp + 3
    km = rng.integers(0, nseg, n)
    km[0], km[-1] = 0, nseg - 1
    kl = np.where(rng.random(n) < 0.3, 0, rng.integers(0, inf + 1, n))
    kl[-1] = inf
    isb = rng.integers(0, 2, n)
    st = rng.permutation(n)
    seg, task = (0, nseg - 1), (0, n - 1)
    if kind == "oneseg":
        km[:] = nseg // 2
    elif kind == "bid0":
        isb[:] = 0
    elif kind == "bid1":
        isb[:] = 1
    elif kind == "kl0":
        kl[:] = 0
    elif kind == "klinf":
        kl[:] = inf
    elif kind in ("sized", "sizedlvl"):
        km = bucket_segments(rng, n, nseg)
        if kind == "sized":      # only the task id varies in a segment
            kl[:] = 0
            isb[:] = 0
    elif kind == "cold":         # a cold round: WAIT, the padding in DUMP
        km[:] = nseg - 2
        km[n - n // 40:] = nseg - 1
        kl[:] = 0
        isb[:] = 0
    elif kind not in ("rand", "wide", "same", "dup"):
        raise ValueError(kind)
    to = lambda a: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(np.int32)).to("cuda")
    if kind == "wide":
        keys = [rng.integers(-2**31, 2**31, n) for _ in range(nkeys)]
        return [to(k) for k in keys], [INT32] * nkeys
    if kind in ("same", "dup"):  # equal keys: none is a permutation
        hi = 0 if kind == "same" else 2
        keys = [rng.integers(0, hi + 1, n) for _ in range(nkeys)]
        return [to(k) for k in keys], [(0, 2)] * nkeys
    if nkeys == 4:
        return [to(km), to(-kl), to(isb), to(st)], [seg, INT32, (0, 1), task]
    if nkeys == 3:
        return [to(km), to(-kl), to(st)], [seg, INT32, task]
    waiting = rng.random(n) < 0.5
    return [to(np.where(waiting, np.arange(n), n))], [(0, n)]


# bucket sizes the split method's edges lie at (SMALL = 32 keys a bucket
# the rank step takes as it is, 2 x SMALL)
EDGE_BUCKETS = (0, 1, 31, 32, 33, 63, 64, 65)


def bucket_segments(rng, n: int, nseg: int):
    """Segments in a random order whose sizes run through EDGE_BUCKETS,
    the keys left over in the last segment."""
    import numpy as np

    km = np.full(n, nseg - 1)
    at = 0
    for seg in range(nseg - 1):
        size = EDGE_BUCKETS[seg % len(EDGE_BUCKETS)]
        if at + size > n:
            break
        km[at:at + size] = seg
        at += size
    return km[rng.permutation(n)]


def seat_sort_edges(torch) -> None:
    """K13 equals its twin (tolerance 0): 1, 3 and 4 keys; n 1, 2, 3,
    7-9 (blocks of the cluster without keys), 1,023-1,025, 10,240 and
    10,241, the former LSD cluster's limit and one past it (tiles), the
    split's edges (the module note's list),
    20,000 and 524,288; the segment at 0 and Mp + 2, levels 0 and INF, one
    segment, is_bid all 0 and all 1; keys past 64 bits (Mp 65,539 with n
    past 2^15, and four whole-int32 keys, each on the split and on
    tiles); the compaction with 0, B - 1, B, B + 1 and n waiting, one
    block and several."""
    import numpy as np

    from poseidon_tpu_torch.kernels import seat_sort as k13

    rng = np.random.default_rng(1315)
    optin = k13.PLANS._smem_optin(torch.device("cuda", 0))
    # the largest n the LSD cluster the split replaced held (8 blocks,
    # 18,624 bytes of counters a block beside its share of two key
    # buffers), one-word and two-word keys: tiles now, kept as edges
    cap1 = 8 * ((optin - 18624) // 16)
    cap2 = 8 * ((optin - 18624) // 32)
    # the largest n the split block holds, one-word and two-word keys
    split1, split2 = (max(n for n in range(1, k13.SPLIT_MAX_N + 1)
                          if k13.split_smem(n, w, k13.SPLIT_CLUSTER) <= optin)
                      for w in (1, 2))
    cases = [  # (n, Mp, nkeys, kind)
        (1, 16, 4, "rand"), (2, 16, 3, "rand"), (3, 16, 4, "rand"),
        (1, 16, 1, "rand"), (3, 16, 1, "rand"), (7, 16, 4, "rand"),
        (8, 16, 4, "rand"), (9, 16, 3, "rand"),
        (1023, 1024, 4, "rand"), (1024, 1024, 3, "rand"),
        (1025, 1024, 4, "rand"), (1025, 1024, 1, "rand"),
        (10240, 1024, 4, "rand"), (10240, 1024, 3, "rand"),
        (10240, 1024, 1, "rand"), (10240, 1024, 4, "oneseg"),
        (10240, 1024, 4, "bid0"), (10240, 1024, 4, "bid1"),
        (10240, 1024, 3, "kl0"), (10240, 1024, 4, "klinf"),
        (10241, 1024, 4, "rand"), (20000, 1024, 3, "oneseg"),
        (cap1, 1024, 4, "rand"), (cap1 + 1, 1024, 4, "rand"),
        (524288, 256, 4, "rand"), (524288, 256, 3, "rand"),
        (524288, 256, 1, "rand"), (40000, 65539, 4, "rand"),
        (cap2 + 1, 65539, 4, "rand"), (5000, 65539, 4, "rand"),
        (cap2, 16, 4, "wide"), (cap2 + 1, 16, 4, "wide"),
        (5000, 16, 3, "wide"),
        # the split method: buckets of 0, 1, 31-33 and 63-65 keys (only
        # the task id varying in them, or the level too), all n keys in
        # one bucket (a cold round's WAIT), n at the split block's limit
        # and one past it (tiles), a first key of 32 bits, equal
        # keys (one all-equal bucket, buckets of equal keys past SMALL)
        (10240, 1024, 4, "sized"), (10240, 1024, 3, "sized"),
        (10240, 1024, 4, "sizedlvl"), (2000, 64, 4, "sized"),
        (10240, 1024, 4, "cold"), (10240, 1024, 3, "cold"),
        (600, 16, 3, "cold"), (33, 16, 4, "oneseg"), (32, 16, 4, "oneseg"),
        (65, 16, 3, "cold"), (split1, 1024, 4, "rand"),
        (split1 + 1, 1024, 4, "rand"), (split1, 1024, 3, "cold"),
        (split2, 16, 4, "wide"), (split2 + 1, 16, 4, "wide"),
        (10240, 16, 1, "wide"), (10240, 16, 2, "wide"),
        (10240, 16, 4, "same"), (10240, 16, 1, "dup"), (3000, 16, 3, "dup"),
        (12288, 65539, 4, "sizedlvl"),
    ]
    for n, Mp, nkeys, kind in cases:
        keys, spans = seat_keys(torch, rng, n, Mp, nkeys, kind)
        err = max_abs_err(list(k13.seat_sort(keys, spans)),
                          list(k13.seat_sort_plain(*keys)))
        bits = tuple(k13.field_bits(sp) for sp in spans)
        p = k13.PLANS["sort", keys[0].device, n, bits]
        log(f"[edges] seat_sort n={n} Mp={Mp} keys={nkeys} {kind}: "
            f"max_abs_err={err} bits={sum(bits)} words={p.words} "
            f"method={p.method} passes={p.passes} tiles={p.tiles}")
        if err != 0:
            raise AssertionError(f"seat_sort edge n={n} Mp={Mp} "
                                 f"keys={nkeys} {kind}: kernel != twin "
                                 f"(max_abs_err {err})")
    for n in (1, 3, 10240, 65536, 65537, 524288):
        B = min(n, max(1024, n // 4))
        for waiting_n in sorted({0, B - 1, B, min(B + 1, n), n}):
            waiting = np.zeros(n, dtype=bool)
            waiting[rng.choice(n, size=waiting_n, replace=False)] = True
            w = torch.from_numpy(waiting).to("cuda")
            err = max_abs_err([k13.seat_compact(w, B)],
                              [k13.seat_compact_plain(w, B)])
            p = k13.PLANS["compact", w.device, n]
            log(f"[edges] seat_compact n={n} B={B} waiting={waiting_n}: "
                f"max_abs_err={err} blocks={p.blocks} "
                f"per_block={p.per_block}")
            if err != 0:
                raise AssertionError(f"seat_compact edge n={n} "
                                     f"waiting={waiting_n}: kernel != twin "
                                     f"(max_abs_err {err})")


def edges_phase(torch) -> None:
    """K12 and K13 against their twins at their designs' edges (the
    older kernels' batteries run inside [kernels])."""
    top_will_edges(torch)
    seat_sort_edges(torch)



# ---- K4 express_rows and K5 express_patch ---------------------------


def express_rows_inputs(torch, rng, Tp, Mp, kmax, pk, kind):
    """K4's arguments on the card (int32) of one edge kind: the table
    c[Tp, Mp], w_s/add_row[kmax], pc_s/add_pm/add_pr[kmax, pk] and
    dgen/ra_s/rack_of/s[Mp], then its [Tp] vectors (u_s[kmax]; u, w,
    valid, asg, lvl). The last eighth of the columns is padding (s 0,
    rack -1), as the padded instance has."""
    import numpy as np

    inf = 2**29
    racks = max(Mp // 8, 1)
    real = Mp - Mp // 8
    rack_of = np.where(np.arange(Mp) < real, rng.integers(0, racks, Mp), -1)
    s = np.where(np.arange(Mp) < real, rng.integers(0, 4, Mp), 0)
    c = rng.integers(0, 50_000, (Tp, Mp))
    dgen = np.where(rng.random(Mp) < 0.1, inf, rng.integers(0, 5000, Mp))
    ra = np.where(rng.random(Mp) < 0.1, inf, rng.integers(0, 5000, Mp))
    w = np.where(rng.random(kmax) < 0.1, inf, rng.integers(0, 5000, kmax))
    pc = np.where(rng.random((kmax, pk)) < 0.1, inf,
                  rng.integers(0, 3000, (kmax, pk)))
    pm = np.where(rng.random((kmax, pk)) < 0.4, -1,
                  rng.integers(0, real, (kmax, pk)))
    pr = np.where(rng.random((kmax, pk)) < 0.5, -1,
                  rng.integers(0, racks, (kmax, pk)))
    rows = rng.choice(Tp, size=min(kmax, Tp), replace=False)
    add_row = np.full(kmax, -1)
    add_row[: len(rows)] = rows
    add_row[rng.random(kmax) < 0.2] = -1
    if kind == "allneg":         # every lane -1: nothing is written
        add_row[:] = -1
    elif kind == "ends":         # the first and the last row
        add_row[:2] = [0, Tp - 1][:kmax]
    elif kind == "past":         # lanes of -1 and rows past Tp
        add_row[: min(kmax, 3)] = [-1, Tp, Tp + 7][: min(kmax, 3)]
    elif kind == "padhit":       # preferences on padded columns, racks -1
        pm = rng.integers(real - 1, Mp, (kmax, pk))
        pr = rng.integers(-1, 1, (kmax, pk))
    elif kind == "noseat":       # half the real columns have no seat
        s[rng.random(Mp) < 0.5] = 0
    elif kind == "wrap":         # w + dgen and pc + ra leave int32
        w = rng.integers(2**31 - 2**20, 2**31, kmax)
        dgen = rng.integers(2**30, 2**31, Mp)
        pc = rng.integers(2**31 - 2**20, 2**31, (kmax, pk))
        ra = rng.integers(2**30, 2**31, Mp)
    elif kind != "rand":
        raise ValueError(kind)
    to = lambda a, dt=np.int32: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a, dtype=np.int64).astype(dt)).to(DEVICE)
    head = tuple(map(to, (c, w, pc, add_row, pm, pr, dgen, ra, rack_of, s)))
    vectors = (to(rng.integers(0, 5000, kmax)), to(rng.integers(0, 500, Tp)),
               to(rng.integers(0, 500, Tp)), to(rng.random(Tp) < 0.5, bool),
               to(rng.integers(-1, Mp + 1, Tp)), to(rng.integers(0, 500, Tp)))
    return head, vectors


def express_rows_run(k4fn, head, vectors, save: bool, split=None):
    """One call of K4 (or its twin) on fresh copies: the whole table, or
    (``split`` = r0) two row shards [0, r0) and [r0, Tp), each its own
    launch, the first with the [Tp] vectors. Returns every output: the
    table, the saved rows, u, w, valid, asg0, lvl0, and asg/lvl (which
    must come back untouched)."""
    c, *rest = (t.clone() for t in head)
    vec = tuple(t.clone() for t in vectors)
    kmax, Mp = head[3].shape[0], c.shape[1]
    saved = [saved_rows_buffer(c, kmax) if save else None
             for _ in range(1 if split is None else 2)]
    if split is None:
        out = k4fn(c, *rest, vec, saved[0])
        table = c
    else:
        b0, b1 = c[:split].clone(), c[split:].clone()
        out = k4fn(b0, *rest, vec, saved[0], 0)
        k4fn(b1, *rest, None, saved[1], split)
        table = [b0, b1]
    return [table, [x for x in saved if x is not None], vec[1:], list(out)]


def saved_rows_buffer(c, kmax):
    """A [kmax, Mp] buffer of -7 on c's device: the rows K4 saves land
    in it, the lanes without a row must leave theirs at -7."""
    return c.new_full((kmax, c.shape[1]), -7)


def express_rows_check(torch, head, vectors, save=True, split=None) -> int:
    """K4 on copies of the inputs, its twin on others: max |diff| over
    every output (table, saved rows, u, w, valid, asg0, lvl0, asg, lvl)."""
    from poseidon_tpu_torch.kernels import express_rows as k4

    got = express_rows_run(k4.express_rows, head, vectors, save, split)
    want = express_rows_run(k4.express_rows_plain, head, vectors, save,
                            split)
    sync(torch)
    return max_abs_err(flatten(got), flatten(want))


def flatten(x) -> list:
    """The tensors of a nest of lists and tuples, in order."""
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in flatten(y)]
    return [x]


def express_patch_inputs(torch, rng, Tp, Mp, n, kind, chunks: int = 1):
    """K5's state u/w/valid/s/asg/lvl ([Tp], s [Mp]) and a backlog
    int32[chunks, 3, n] on the card, of one edge kind."""
    import numpy as np

    state = (
        rng.integers(0, 5000, Tp), rng.integers(0, 5000, Tp),
        rng.random(Tp) < 0.8, rng.integers(-1, 4, Mp),
        rng.integers(-1, Mp + 1, Tp), rng.integers(0, 3000, Tp),
    )
    shape = (chunks, n)
    rows = np.stack([rng.choice(Tp, size=n, replace=n > Tp)
                     for _ in range(chunks)])
    cols = rng.integers(0, Mp, shape)
    deltas = rng.integers(-1, 2, shape)
    if kind == "empty":          # an all-unused chunk
        rows[:], cols[:], deltas[:] = -1, -1, 0
    elif kind == "neg":          # rows and columns of -1 and past the axis
        rows[rng.random(shape) < 0.5] = -1
        rows[rng.random(shape) < 0.1] = Tp
        cols[rng.random(shape) < 0.3] = -1
        cols[rng.random(shape) < 0.1] = Mp
    elif kind == "onecol":       # every entry on one column
        cols[:] = Mp // 2
        deltas[:] = 1
    elif kind == "dupneg":       # duplicate columns driven below zero
        cols = rng.integers(0, min(Mp, 8), shape)
        deltas[:] = -1
    elif kind != "rand":
        raise ValueError(kind)
    to = lambda a, dt: torch.from_numpy(  # noqa: E731
        np.ascontiguousarray(a).astype(dt)).to("cuda")
    u, w, valid, s, asg, lvl = state
    backlog = np.stack([rows, cols, deltas], axis=1)
    return ((to(u, np.int32), to(w, np.int32), to(valid, bool),
             to(s, np.int32), to(asg, np.int32), to(lvl, np.int32)),
            to(backlog, np.int32))


PATCH_MODES = ("out", "in", "mixed")


def patch_destinations(state, mode: str):
    """K5's destinations in one of its three forms: ``out`` six new
    tensors (the stream window's), ``in`` each its own source,
    ``mixed`` the synced lane's (u/w/valid/s in place, asg/lvl new)."""
    return {"out": None, "in": state,
            "mixed": (*state[:4], None, None)}[mode]


def express_patch_check(torch, state, backlog, mode: str = "out") -> int:
    """K5 over the backlog in one call from one copy of the state, the
    twin from another, in one form: max |diff| over the six outputs and
    over the sources patched out of place (which must stay as they
    were)."""
    from poseidon_tpu_torch.kernels import express_patch as k5

    a = [t.clone() for t in state]
    b = [t.clone() for t in state]
    got = k5.express_patch(a, patch_destinations(a, mode), backlog)
    want = k5.express_patch_plain(b, patch_destinations(b, mode), backlog)
    kept = {"out": 0, "in": 6, "mixed": 4}[mode]
    return max(max_abs_err(got, want), max_abs_err(a[kept:], state[kept:]))


def express_edges(torch, rng):
    """K4 and K5 equal their twins (tolerance 0) at their edges."""
    from poseidon_tpu_torch.kernels import express_rows as k4

    cases4 = [  # (Tp, Mp, kmax, pk, kind)
        (64, 16, 1, 1, "rand"), (300, 16, 16, 3, "rand"),
        (2000, 1028, 64, 5, "rand"), (100, 1028, 16, 3, "allneg"),
        (512, 64, 16, 3, "ends"), (256, 1024, 16, 5, "padhit"),
        (41, 1028, 64, 1, "padhit"), (128, 1024, 16, 3, "noseat"),
        (256, 1024, 16, 3, "wrap"), (70, 16, 64, 5, "wrap"),
        (10240, 1024, 16, 3, "ends"), (10240, 1024, 16, 3, "past"),
        (10240, 1024, 1, 3, "ends"), (2049, 1028, 16, 0, "rand"),
        (4097, 16, 16, 1, "past"), (10240, 1024, 16, 3, "rand"),
    ]
    bad, n = [], 0
    for Tp, Mp, kmax, pk, kind in cases4:
        head, vectors = express_rows_inputs(torch, rng, Tp, Mp, kmax, pk,
                                            kind)
        for save in (True, False):
            err = express_rows_check(torch, head, vectors, save)
            n += 1
            if err:
                bad.append((Tp, Mp, kmax, pk, kind, save, err))
    # a two-shard table whose second shard owns every arrival
    for Tp, Mp, kmax in ((10240, 1024, 16), (64, 16, 16)):
        head, vectors = express_rows_inputs(torch, rng, Tp, Mp, kmax, 3,
                                            "rand")
        head[3].copy_(torch.arange(Tp - kmax, Tp, dtype=torch.int32,
                                   device=head[3].device))
        err = express_rows_check(torch, head, vectors, True, Tp // 2)
        # the shards' tables, put together, equal the whole table's
        whole = express_rows_run(k4.express_rows, head, vectors, True)
        split = express_rows_run(k4.express_rows, head, vectors, True,
                                 Tp // 2)
        err = max(err, max_abs_err([whole[0]], [torch.cat(split[0])]))
        n += 1
        if err:
            bad.append((Tp, Mp, kmax, "shard 1 owns every row", err))
    log(f"[edges] express_rows: {n} cases (with and without saved rows; "
        f"two shards), {len(bad)} differ")
    if bad:
        raise AssertionError(f"[edges] express_rows != twin: {bad[:4]}")
    cases5 = [  # (Tp, Mp, n, chunks, kind)
        (16, 16, 1024, 1, "empty"), (64, 16, 1024, 1, "neg"),
        (300, 1028, 1024, 1, "onecol"), (300, 1028, 1024, 3, "dupneg"),
        (2000, 65536, 1024, 2, "rand"), (10240, 1024, 1024, 1, "neg"),
        (50, 16, 7, 1, "dupneg"), (10240, 1024, 2500, 1, "rand"),
        (16, 1028, 1024, 4, "rand"), (10240, 1024, 1024, 11, "rand"),
        (4097, 16, 64, 2, "neg"), (100, 12288, 512, 2, "dupneg"),
        (100, 12292, 512, 2, "dupneg"), (10240, 16, 16, 1, "onecol"),
    ]
    n5 = 0
    for Tp, Mp, n, chunks, kind in cases5:
        state, backlog = express_patch_inputs(torch, rng, Tp, Mp, n, kind,
                                              chunks)
        for mode in PATCH_MODES:
            err = express_patch_check(torch, state, backlog, mode)
            n5 += 1
            if err != 0:
                raise AssertionError(
                    f"express_patch edge Tp={Tp} Mp={Mp} n={n} "
                    f"chunks={chunks} {kind} {mode}: kernel != twin "
                    f"(max_abs_err {err})")
    log(f"[edges] express_patch: {n5} cases ({len(cases5)} shapes x "
        f"{'/'.join(PATCH_MODES)}; Tp 16-10240, Mp 16-65536, 1-11 chunks, "
        f"chunks of 7-2500 entries), all equal to the twin")
    # two chunks in one call where the order matters: -3 then +1 on one
    # column leaves 1 (the clamp sits between them); +1 then -3 leaves 0
    from poseidon_tpu_torch.kernels import express_patch as k5

    state, backlog = express_patch_inputs(torch, rng, 64, 16, 1024, "empty",
                                          2)
    state[3].fill_(1)
    backlog[:, 1, 0] = 3
    for first, second, want in ((-3, 1, 1), (1, -3, 0)):
        backlog[0, 2, 0], backlog[1, 2, 0] = first, second
        for mode in PATCH_MODES:
            err = express_patch_check(torch, state, backlog, mode)
            a = [t.clone() for t in state]
            got = int(k5.express_patch(a, patch_destinations(a, mode),
                                       backlog)[3][3])
            log(f"[edges] express_patch two chunks {first:+d} then "
                f"{second:+d} ({mode}): max_abs_err={err} s={got} "
                f"(want {want})")
            if err != 0 or got != want:
                raise AssertionError("express_patch chunk order: kernel != "
                                     f"twin or s={got} != {want}")


def express_kernel_records(torch, timer, inst, dt, ra_s):
    """K4 and K5 at the flagship's shapes (Tp 10240, Mp 1024, kmax 16,
    pk 3, as the stream lane calls K4: the [Tp] vectors and the saved
    rows; one full 1024-entry K5 chunk), each held against its twin
    (tolerance 0) and timed cold; then their edge battery."""
    import numpy as np

    from poseidon_tpu_torch.kernels import express_patch as k5
    from poseidon_tpu_torch.kernels import express_rows as k4

    rng = np.random.default_rng(11)
    dev = inst.c.device
    Tp, Mp = inst.c.shape
    T, kmax, pk = dt.n_tasks, 16, 3
    scale = T + 1
    inf = 2**29
    racks = int(dt.rack_of.max()) + 1
    real = int((inst.s > 0).sum())

    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a).astype(np.int32)).to(dev)

    add_row = to(np.arange(T, T + kmax))
    w_s = to(rng.integers(0, 300, kmax) * scale)
    pc_s = to(np.where(rng.random((kmax, pk)) < 0.2, inf,
                       rng.integers(0, 200, (kmax, pk)) * scale))
    add_pm = to(np.where(rng.random((kmax, pk)) < 0.5, -1,
                         rng.integers(0, real, (kmax, pk))))
    add_pr = to(np.where(rng.random((kmax, pk)) < 0.5, -1,
                         rng.integers(0, racks, (kmax, pk))))
    u_s = to(rng.integers(0, 300, kmax) * scale)
    head = (inst.c, w_s, pc_s, add_row, add_pm, add_pr, inst.dgen, ra_s,
            dt.rack_of, inst.s)
    # the stream lane's call: the [Tp] vectors and the saved rows
    vectors = (u_s, inst.u, inst.w, inst.task_valid,
               to(rng.integers(0, Mp + 1, Tp)), to(np.zeros(Tp)))
    err4 = express_rows_check(torch, head, vectors)
    c4, *rest = (t.clone() for t in head)
    vec = tuple(t.clone() for t in vectors)
    saved = saved_rows_buffer(c4, kmax)
    ms4 = timer(lambda: k4.express_rows(c4, *rest, vec, saved))
    plain4 = timer(lambda: k4.express_rows_plain(c4, *rest, vec, saved))
    g4 = timer.in_graph(lambda: k4.express_rows(c4, *rest, vec, saved))
    log(f"[kernels] express_rows in a CUDA graph (32 calls back to "
        f"back at the stream window's shapes) us={g4 * 1e3:.3f}")
    del c4
    # read: the lanes' scalars and preferences, 4 [Mp] columns, asg and
    # lvl, the old rows; written: the rows, the saved rows, asg0/lvl0,
    # u/w/valid at the rows
    b4 = (kmax * 4 * 3 + kmax * pk * 4 * 3 + 4 * Mp * 4 + 2 * Tp * 4
          + 3 * kmax * Mp * 4 + 2 * Tp * 4 + kmax * 9)
    ops4 = kmax * Mp * (3 + 6 * pk) + 2 * Tp

    # the stream window's call at its widest: one full 1024-entry chunk,
    # out of place from the carry into the window's six vectors
    n = 1024
    backlog = to(np.stack([rng.choice(T, size=n, replace=False),
                           rng.integers(0, real, n), np.full(n, -1)])[None])
    state = (inst.u.clone(), inst.w.clone(), inst.task_valid.clone(),
             inst.s.clone(), to(rng.integers(0, Mp + 1, Tp)),
             to(np.zeros(Tp)))
    err5 = express_patch_check(torch, state, backlog, "out")
    dst = tuple(torch.empty_like(x) for x in state)
    ms5 = timer(lambda: k5.express_patch(state, dst, backlog))
    plain5 = timer(lambda: k5.express_patch_plain(state, dst, backlog))
    g5 = timer.in_graph(lambda: k5.express_patch(state, dst, backlog))
    log(f"[kernels] express_patch in a CUDA graph (32 calls back to "
        f"back at the stream window's shapes) us={g5 * 1e3:.3f}")
    # yardstick, not a call the port makes: index_add_ of the chunk's
    # seat deltas alone (one part of K5's function); no single PyTorch
    # call computes K5's
    s_copy = inst.s.clone()
    cols64 = backlog[0, 1].long()
    add_ms = timer(lambda: s_copy.index_add_(0, cols64, backlog[0, 2]))
    log(f"[kernels] express_patch yardstick: index_add_ of the chunk's "
        f"{n} seat deltas alone ms={add_ms:.6f} (L2 flushed)")
    # read: the chunk, the five [Tp] vectors and s; written: the same
    # six out of place
    b5 = n * 4 * 3 + 2 * (Tp * 17 + Mp * 4)
    ops5 = n * 8 + Mp * 2
    express_edges(torch, rng)
    return [
        (k4.KERNEL, err4, ms4, plain4, *bound_ms(b4, ops4),
         (Tp, Mp, kmax, pk)),
        (k5.KERNEL, err5, ms5, plain5, *bound_ms(b5, ops5), (Tp, Mp, n)),
    ]


def perturb_instance(torch, device, seed: int = 0):
    """BASELINE config 5 (1,000 machines x 4,000 pods, quincy), priced on
    the card, as a host TransportInstance, with its priced graph."""
    import numpy as np

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.network import FlowNetwork, pad_bucket
    from poseidon_tpu_torch.models.costs import (
        build_cost_inputs_host, quincy_cost,
    )
    from poseidon_tpu_torch.ops.transport import (
        extract_topology, instance_from_topology,
    )
    from poseidon_tpu_torch.synth import config5_whatif

    cluster = config5_whatif(seed=seed)
    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    inputs = build_cost_inputs_host(
        pad_bucket(meta.n_arcs), meta, **cost_kwargs(cluster)
    ).to_device(device)
    cost = quincy_cost(inputs).cpu().numpy().astype(np.int32)[: meta.n_arcs]
    topo = extract_topology(meta, arrays["src"], arrays["dst"],
                            arrays["cap"])
    net = FlowNetwork.from_arrays(arrays["src"], arrays["dst"],
                                  arrays["cap"], cost, arrays["supply"])
    return instance_from_topology(topo, cost), net


# ops of one threefry2x32 evaluation: 20 rounds of add, rotate and xor,
# 5 two-word key injections and the input injection (int32 scalar ops)
THREEFRY_OPS = 20 * 3 + 5 * 3 + 2


def perturb_counts(torch, c0, u0, w0, dgen0, s, B: int) -> tuple[int, int]:
    """Bytes K6 must move (each input read once, each output written
    once) and the int32 operations this input needs: two threefry
    evaluations and ~10 ops of randint and jitter for every finite value
    K6 hashes (w, dgen, u and the table's preference part on seated
    columns, variants 1..B-1), and ~6 ops for every table entry of every
    variant."""
    inf = 2**29
    Tp, Mp = c0.shape
    generic = torch.clamp(w0[:, None].long() + dgen0[None, :].long(), max=inf)
    pref = ((c0.long() < generic) & (s[None, :] > 0)).sum().item()
    vec = sum(int((x < inf).sum()) for x in (w0, u0, dgen0))
    hashed = (B - 1) * (pref + vec)
    n_bytes = (B * Tp * Mp * 4 + B * (2 * Tp + Mp) * 4 + B * 4
               + Tp * Mp * 4 + (2 * Tp + 2 * Mp) * 4)
    n_ops = hashed * (2 * THREEFRY_OPS + 10) + B * Tp * Mp * 6
    return n_bytes, n_ops


def perturb_check(torch, args, B, scale, seed, pct) -> int:
    from poseidon_tpu_torch.kernels import perturb as k6

    got = k6.perturb(*args, B, scale, seed, pct)
    want = k6.perturb_plain(*args, B, scale, seed, pct)
    sync(torch)
    return max_abs_err(got, want)


def perturb_record(torch, timer):
    """K6 at BASELINE config 5 with B = 64, held against its twin
    (tolerance 0) and timed; then its edge battery."""
    from poseidon_tpu_torch.kernels import perturb as k6
    from poseidon_tpu_torch.ops.dense_auction import build_dense_instance

    dev = torch.device(DEVICE)
    inst, _net = perturb_instance(torch, dev)
    d = build_dense_instance(inst, dev)
    args = (d.c, d.u, d.w, d.dgen, d.s)
    B, seed, pct = 64, 7, 10
    err = perturb_check(torch, args, B, d.scale, seed, pct)
    ms = timer(lambda: k6.perturb(*args, B, d.scale, seed, pct))
    plain = timer(lambda: k6.perturb_plain(*args, B, d.scale, seed, pct),
                  repeats=3)
    n_bytes, n_ops = perturb_counts(torch, *args, B)
    tb = n_bytes / HBM_BYTES_PER_S * 1e3
    to = n_ops / INT32_OPS_PER_S * 1e3
    Tp, Mp = d.c.shape
    log(f"[kernels] perturb bounds: bytes {n_bytes} -> {tb:.6f} ms, int32 "
        f"ops {n_ops} -> {to:.6f} ms (B={B}, Tp={Tp}, Mp={Mp}, "
        f"scale={d.scale}); plan {k6.table_plan(B, Tp, Mp)}")
    # yardstick, not a call the port makes: one fill_ of the table K6
    # writes, what the card reaches writing the same bytes
    table = torch.empty((B, Tp, Mp), dtype=torch.int32, device=dev)
    log(f"[kernels] perturb write_floor_ms={timer(lambda: table.fill_(0)):.6f} "
        f"(one fill_ of an int32 [{B}, {Tp}, {Mp}] table, L2 flushed)")
    del table
    perturb_edges(torch)
    return (k6.KERNEL, err, ms, plain, *bound_ms(n_bytes, n_ops),
            (B, Tp, Mp))


def perturb_edge_table(torch, rng, Tp, Mp, scale, kind):
    import numpy as np

    inf = 2**29
    w0 = rng.integers(0, 60, Tp) * scale
    d0 = rng.integers(0, 60, Mp) * scale
    s = rng.integers(0, 3, Mp)
    if kind == "inf-rows":
        w0[::3] = inf
    if kind == "zero-slots":
        s[::2] = 0
    if kind == "all-inf":
        w0[:] = inf
    c0 = np.minimum(w0[:, None] + d0[None, :], inf)
    pref = rng.random((Tp, Mp)) < 0.2
    c0 = np.where(pref, np.minimum(c0, rng.integers(0, 50, (Tp, Mp)) * scale),
                  c0)
    c0 = np.where(s[None, :] > 0, c0, inf)
    u0 = rng.integers(0, 90, Tp) * scale

    def to(a):
        return torch.from_numpy(
            np.ascontiguousarray(a).astype(np.int32)).to(DEVICE)

    return tuple(to(x) for x in (c0, u0, w0, d0, s))


def perturb_edges(torch) -> None:
    """K6 against its twin (tolerance 0): B 1 and 2, magnitude 0, 10 and
    50 %, scale 1 and above 1, INF rows, a whole INF table, zero-slot
    columns, Mp 16 and 1028, seeds 0 and 2^31-1; and the tile plan's
    edges (``kernels/perturb.py`` ``table_plan``): B 1, 2, 33, 34, 63,
    64, 65 and 130 (variant chunks of 32 after variant 0) over Tp not a
    multiple of the row tile,
    Mp 16 and 1028, magnitude 0 and 50 % and 40,000 % (a span past 2^16:
    the residues' products pass 32 bits), an all-INF table, seeds 0 and
    2^31-1."""
    import numpy as np

    rng = np.random.default_rng(21)
    cases = []
    for B in (1, 2):
        for pct in (0, 10, 50):
            for scale in (1, 7):
                cases.append((B, pct, scale, 64, 16, "plain",
                              (0, 2**31 - 1)[(B + pct) % 2]))
    for kind in ("inf-rows", "zero-slots", "all-inf"):
        cases.append((2, 10, 5, 48, 16, kind, 0))
    for Mp in (16, 1028):
        for seed in (0, 2**31 - 1):
            cases.append((2, 50, 3, 40, Mp, "plain", seed))
    # the tile plan: row tiles of 32 rows at Mp 1024 and 1028, of 256 at
    # Mp 16; chunks of 32 variants after variant 0
    for B in (1, 2, 33, 34, 63, 64, 65, 130):
        for Tp, Mp in ((33, 1024), (70, 1028), (300, 16)):
            cases.append((B, 10, 3, Tp, Mp, "plain", B % 2 * (2**31 - 1)))
    for pct in (0, 50, 40000):
        cases.append((65, pct, 7, 45, 1024, "plain", 0))
    cases.append((65, 10, 7, 45, 1024, "all-inf", 2**31 - 1))
    bad = []
    for B, pct, scale, Tp, Mp, kind, seed in cases:
        args = perturb_edge_table(torch, rng, Tp, Mp, scale, kind)
        err = perturb_check(torch, args, B, scale, seed, pct)
        if err:
            bad.append((B, pct, scale, Tp, Mp, kind, seed, err))
    log(f"[edges] perturb: {len(cases)} shapes, {len(bad)} differ")
    if bad:
        raise AssertionError(f"[edges] perturb != twin: {bad[:4]}")


def stream_commit_inputs(torch, rng, Tp, Mp, kmax, cap, *, live=True,
                         conv=True, dom=True, nrep=16, rows=None,
                         below_zero=False, big=False):
    """One window's K7 inputs at (Tp, Mp), as a dict: the window after
    its repair (valid_n, asg0, asg_f, u_n, w_n, lvl_f, floor_f, s_n; the
    cost table c), its certificate, its arrival rows (0 and Tp-1 among
    them) and saved rows, and the carry. Exactly ``nrep`` rows report (at
    ``rows`` when given, else at random, 0 and Tp-1 first); the other
    rows are inactive, off every machine or unchanged. With
    ``below_zero`` the reports land on a column with one seat left, so
    the decrements drive it below 0 before the clamp; with ``big`` the
    costs sit near 2^29 and the objective near 2^40 and past it."""
    import numpy as np

    inf = 2**29
    if rows is None:
        rest = rng.permutation(np.arange(1, Tp - 1))
        rows = np.concatenate([[0, Tp - 1], rest])[:nrep]
    rows = np.unique(np.asarray(rows, dtype=np.int64))
    rep = np.zeros(Tp, bool)
    rep[rows] = True
    valid_n = rng.random(Tp) < 0.8
    asg_f = rng.integers(-1, Mp + 2, Tp)
    asg0 = rng.integers(-1, Mp + 1, Tp)
    # a row that does not report: inactive, off every machine, or where
    # the repair started
    kind = rng.integers(0, 3, Tp)
    valid_n[(kind == 0) & ~rep] = False
    off = (kind == 1) & ~rep
    asg_f[off] = rng.choice([-1, Mp, Mp + 1], size=int(off.sum()))
    same = (kind == 2) & ~rep
    asg_f[same] = rng.integers(0, Mp, int(same.sum()))
    asg0[same] = asg_f[same]
    valid_n[rep] = True
    asg_f[rep] = rng.integers(0, Mp, len(rows))
    asg0[rep] = np.where(asg_f[rep] == 0, Mp, asg_f[rep] - 1)
    s_n = rng.integers(0, 10, Mp)
    if below_zero:
        asg_f[rep] = 3
        asg0[rep] = -1
        s_n[3] = 1
    lo = inf - 2**20 if big else 0
    c = rng.integers(lo, inf, (Tp, Mp))
    u_n = rng.integers(lo, inf if big else 500, Tp)
    add_row = np.full(kmax, -1)
    add_row[: min(kmax, 2)] = [0, Tp - 1][: min(kmax, 2)]
    if kmax > 2:
        add_row[2:] = rng.choice(np.arange(1, Tp - 1), size=kmax - 2,
                                 replace=False)
    add_row[-1] = -1 if kmax > 3 else add_row[-1]

    def to(a, dt=np.int32):
        # np.array keeps a 0-d flag 0-d (ascontiguousarray would not)
        return torch.from_numpy(np.array(a, dtype=dt)).to(DEVICE)

    return dict(
        live=to([int(live)]), conv=to(np.array(conv), bool),
        domain_ok=to(np.array(dom), bool), cap=cap, change_cap=cap,
        valid_n=to(valid_n, bool), asg0=to(asg0), asg_f=to(asg_f),
        u_n=to(u_n), w_n=to(rng.integers(0, 500, Tp)),
        lvl_f=to(rng.integers(0, 500, Tp)),
        floor_f=to(rng.integers(0, 500, Mp)), s_n=to(s_n),
        add_row=to(add_row), c_saved=to(rng.integers(0, inf, (kmax, Mp))),
        c=to(c), u=to(rng.integers(0, 500, Tp)),
        w=to(rng.integers(0, 500, Tp)), valid=to(rng.random(Tp) < 0.9, bool),
        asg=to(rng.integers(-1, Mp + 1, Tp)),
        lvl=to(rng.integers(0, 500, Tp)), s=to(rng.integers(0, 10, Mp)),
        floor=to(rng.integers(0, 500, Mp)),
    )


def stream_commit_args(torch, x, change_cap, commit=True, split=None):
    """A fresh copy of one window's K7 arguments, in call order, and the
    tensors it writes. ``split`` = r0 cuts the table into two row shards
    (the tail reads the per-row cost; the commit restores into shard 0;
    the second shard comes last in the written list)."""
    from poseidon_tpu_torch.kernels import stream_commit as k7

    y = {k: (v.clone() if hasattr(v, "clone") else v) for k, v in x.items()}
    Tp, Mp = y["c"].shape
    log_row = torch.full((k7.log_width(y["cap"]),), -9, dtype=torch.int64,
                         device=DEVICE)
    report = torch.zeros(Tp, dtype=torch.bool, device=DEVICE)
    cost, table, extra = y["c"], y["c"], []
    if split is not None:
        col = torch.clamp(y["asg_f"], 0, Mp - 1).long()
        cost = y["c"].gather(1, col[:, None])[:, 0].contiguous()
        table = y["c"][:split].clone()
        extra = [y["c"][split:].clone()]
    com = None
    if commit:
        com = k7.Commit(y["live"], y["lvl_f"], y["floor_f"], y["w_n"],
                        y["s_n"], y["add_row"], y["c_saved"], table, y["u"],
                        y["w"], y["valid"], y["asg"], y["lvl"], y["s"],
                        y["floor"])
    args = (log_row, report, y["valid_n"], y["asg0"], y["asg_f"], y["u_n"],
            cost, Mp, y["conv"], y["domain_ok"], change_cap, com)
    written = [log_row, report, *(com or ()), *extra]
    return args, written


def stream_commit_check(torch, x, change_cap, commit=True, split=None) -> int:
    """K7 and its twin on copies of the same inputs: every output (the
    log row, the report, and with the commit the carry, the table, the
    latch and the consumed seats) compared. With ``split`` the second
    shard is undone by K7's restore (its twin's for the twin)."""
    from poseidon_tpu_torch.kernels import stream_commit as k7

    outs = []
    for fn, restore in ((k7.stream_commit, k7.stream_restore),
                        (k7.stream_commit_plain, None)):
        args, written = stream_commit_args(torch, x, change_cap, commit,
                                           split)
        fn(*args)
        if split is not None and commit:
            com, b1 = args[-1], written[-1]
            Tp = x["c"].shape[0]
            if restore is not None:
                restore(com.live, com.add_row, com.c_saved, b1, Tp, split)
            else:
                k7._restore_rows_plain(com.live[0] != 0, com.add_row,
                                       com.c_saved, b1, Tp, split)
        sync(torch)
        outs.append(written)
    return max_abs_err(*outs)


def stream_commit_bytes(x, commit=True) -> tuple[int, int]:
    """The tail's bytes and int32 operations on these inputs: the report
    inputs and one cost entry an active row on a machine (or u_n off
    one) read, report and the log written; with the commit of a live
    window the carry's inputs read and the carry written (a dead one
    copies back its saved rows instead), the seat decrements counted as
    a read and a write of each."""
    import numpy as np

    valid = x["valid_n"].cpu().numpy()
    f = x["asg_f"].cpu().numpy()
    Tp, Mp = x["c"].shape
    cap = x["cap"]
    n_rep = int((valid & (f >= 0) & (f < Mp)
                 & (f != x["asg0"].cpu().numpy())).sum())
    n_bytes = Tp * (1 + 4 + 4) + int(valid.sum()) * 4 + 2 + Tp \
        + (2 * cap + 6) * 8
    n_ops = Tp * 10 + cap * 4
    if commit:
        rows = x["add_row"].cpu().numpy()
        n_rows = int(((rows >= 0) & (rows < Tp)).sum())
        win_ok = (bool(x["conv"]) and bool(x["domain_ok"])
                  and n_rep <= x["change_cap"])
        if bool(x["live"][0]) and win_ok:
            n_bytes += (Tp * 4 * 3 + Mp * 4 * 2 + 4 * 2 + Tp * (4 * 4 + 1)
                        + Mp * 4 * 2 + n_rep * 8)
            n_ops += Tp * 8 + Mp * 2
        else:
            n_bytes += 4 * 2 + n_rows * Mp * 4 * 2
    return int(n_bytes), int(n_ops)


def stream_commit_record(torch, timer):
    """K7 at the flagship's shapes (Tp 10240, Mp 1024, kmax 16, cap 256):
    the stream lane's call, a live window whose 16 arrivals place (16
    reported rows), held against its twin (tolerance 0) and timed; the
    synced lane's call (no commit) held the same way; then its edge
    battery."""
    import numpy as np

    from poseidon_tpu_torch.kernels import stream_commit as k7

    rng = np.random.default_rng(31)
    Tp, Mp, kmax, cap = 10240, 1024, 16, 256
    x = stream_commit_inputs(torch, rng, Tp, Mp, kmax, cap)
    err = max(stream_commit_check(torch, x, cap),
              stream_commit_check(torch, x, cap, commit=False))
    ka, _ = stream_commit_args(torch, x, cap)
    pa, _ = stream_commit_args(torch, x, cap)
    # every timed call sees a live latch (the live path moves the most)
    ms = timer(lambda: (ka[-1].live.fill_(1), k7.stream_commit(*ka)))
    plain = timer(lambda: (pa[-1].live.fill_(1),
                           k7.stream_commit_plain(*pa)))
    # in a graph: the latch's fill captured too, its own time taken off
    pair = timer.in_graph(lambda: (ka[-1].live.fill_(1),
                                   k7.stream_commit(*ka)))
    fill = timer.in_graph(lambda: ka[-1].live.fill_(1))
    log(f"[kernels] stream_commit in a CUDA graph (32 calls back to "
        f"back at the stream window's shapes) us={(pair - fill) * 1e3:.3f} (with the latch's "
        f"fill {pair * 1e3:.3f}, the fill alone {fill * 1e3:.3f})")
    sa, _ = stream_commit_args(torch, x, cap, commit=False)
    log(f"[kernels] stream_commit without the commit (the synced lane's "
        f"tail) ms={timer(lambda: k7.stream_commit(*sa)):.6f}; bound "
        f"{bound_ms(*stream_commit_bytes(x, commit=False))}")
    stream_commit_edges(torch)
    return (k7.KERNEL, err, ms, plain, *bound_ms(*stream_commit_bytes(x)),
            (Tp, Mp, kmax, cap))


def stream_commit_edges(torch) -> None:
    """K7 against its twin (tolerance 0), with and without the commit: the
    commit's battery (a live window, the first dead window by
    certificate, domain and change cap, an already-dead stream, a window
    at the cap, reports on a column driven below 0, rows 0 and Tp-1; at
    Tp 10240 / Mp 1024, Tp 16 / Mp 16 with cap 0 and Tp 64 / Mp 1028),
    then the tail's own edges: n_changes of 0, cap - 1, cap, cap + 1 and
    Tp (every row reported); reports on the first and last row of every
    cluster rank's tile and of every 1,024-row chunk in it; cap 0; Tp
    16, 1028 and 10240; Mp 16 and 1028; an objective near 2^40."""
    import numpy as np

    rng = np.random.default_rng(41)
    cases = []
    for Tp, Mp, kmax, cap in ((10240, 1024, 16, 256), (16, 16, 1, 0),
                              (64, 1028, 16, 8)):
        for kw in (dict(), dict(conv=False), dict(dom=False),
                   dict(nrep=cap + 1), dict(live=False),
                   dict(nrep=cap), dict(below_zero=True),
                   dict(below_zero=True, live=False)):
            cases.append((Tp, Mp, kmax, cap, kw))
    for Tp, Mp, cap in ((10240, 1024, 256), (1028, 1028, 64), (16, 16, 4)):
        for nrep in sorted({0, cap - 1, cap, cap + 1, Tp} - {-1}):
            cases.append((Tp, Mp, 16, cap, dict(nrep=min(nrep, Tp))))
        per = (Tp + 7) // 8
        edges = [t for r in range(8) for t in (
            r * per, r * per + per - 1, r * per + 1023, r * per + 1024)
            if 0 <= t < min((r + 1) * per, Tp)]
        cases.append((Tp, Mp, 16, cap, dict(rows=edges)))
        cases.append((Tp, Mp, 16, len(edges), dict(rows=edges)))
        cases.append((Tp, Mp, 16, 0, dict(rows=edges)))
        cases.append((Tp, Mp, 16, cap, dict(big=True, nrep=Tp // 3)))
    bad = []
    for Tp, Mp, kmax, cap, kw in cases:
        x = stream_commit_inputs(torch, rng, Tp, Mp, kmax, cap, **kw)
        for commit in (True, False):
            err = stream_commit_check(torch, x, cap, commit)
            if err:
                bad.append((Tp, Mp, kmax, cap, kw if "rows" not in kw
                            else "edges", commit, err))
    log(f"[edges] stream_commit: {len(cases)} shapes x 2 modes (with and "
        f"without the commit), {len(bad)} differ")
    if bad:
        raise AssertionError(f"[edges] stream_commit != twin: {bad[:4]}")


def run_rounds(device, clusters, model="quincy"):
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.resident import ResidentSolver

    solver = ResidentSolver(device=device, small_to_oracle=False)
    outs = []
    for cluster in clusters:
        arrays, meta = FlowGraphBuilder().build_arrays(cluster)
        outs.append(solver.run_round(arrays, meta, cost_model=model,
                                     cost_input_kwargs=cost_kwargs(cluster)))
    return outs


def parity_phase():
    """Small rounds on the card equal the same rounds on the CPU."""
    import numpy as np

    from poseidon_tpu_torch.synth import make_synthetic_cluster

    clusters = [make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8)]
    for r in (1, 2):
        clusters.append(churn(clusters[-1], r, fraction=0.05))
    card = run_rounds("cuda", clusters)
    host = run_rounds("cpu", clusters)
    for r, (a, b) in enumerate(zip(card, host)):
        for f in ("assignment", "channel", "task_cost", "task_margin"):
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"parity round {r}: {f} differs")
        for f in ("cost", "backend", "converged", "rounds", "phases"):
            if getattr(a, f) != getattr(b, f):
                raise AssertionError(
                    f"parity round {r}: {f} {getattr(a, f)} != {getattr(b, f)}")
        log(f"[parity] round {r}: card == cpu (cost={a.cost} "
            f"backend={a.backend} rounds={a.rounds})")
    express_parity()
    stream_parity()
    scale_parity()


def oracle_cost(cluster, device, model: str = "quincy",
                kw: dict | None = None) -> tuple[int, float]:
    """The C++ oracle's optimum of the round's priced graph."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import (
        build_cost_inputs, get_cost_model,
    )
    from poseidon_tpu_torch.oracle import solve_oracle

    net, meta = FlowGraphBuilder().build(cluster)
    inputs = build_cost_inputs(net, meta, device=device,
                               **(kw if kw is not None else cost_kwargs(cluster)))
    t0 = time.perf_counter()
    o = solve_oracle(net.with_costs(get_cost_model(model)(inputs)),
                     algorithm="cost_scaling")
    return o.cost, (time.perf_counter() - t0) * 1e3


def device_rows(prof) -> list:
    """(key, device us, count) of every device event of a profile:
    kernels, copies and sets. A CPU op's row is left out (where the op
    ran on the profiled thread it carries its kernels' device time
    too), and so are user annotations (``kernel_ab.SolveMarks``'s span
    around each ``_solve`` also lies on the device's timeline)."""
    from torch.autograd import DeviceType

    from kernel_ab import SOLVE_SPAN

    return [(e.key, e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0 and e.key != SOLVE_SPAN
            and not getattr(e, "is_user_annotation", False)]


def profile_round(torch, solver, cluster):
    """One more warm round under torch.profiler: device busy share and
    the device time by kernel name (after the main path's counts were
    read, so these launches are not counted)."""
    from torch.profiler import ProfilerActivity, profile

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder

    from poseidon_tpu_torch.kernels import seat_sort, top_will

    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    kw = cost_kwargs(cluster)
    # count the round's library sort and top-k calls (the profiler does
    # not see the CPU ops of the solver's worker thread): since K12 and
    # K13 a warm round makes none (only a cold solve's clearing sorts)
    calls = {"sort": 0, "topk": 0}
    wrapper_calls = {k.name: k.launches for k in (top_will.KERNEL,
                                                  seat_sort.KERNEL)}
    saved = {name: getattr(torch, name) for name in ("argsort", "sort", "topk")}

    def counted(name, fn):
        def call(*a, **k):
            calls["topk" if name == "topk" else "sort"] += 1
            return fn(*a, **k)
        return call

    for name, fn in saved.items():
        setattr(torch, name, counted(name, fn))
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            out = solver.run_round(arrays, meta, cost_model="quincy",
                                   cost_input_kwargs=kw)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    finally:
        for name, fn in saved.items():
            setattr(torch, name, fn)
    for k in (top_will.KERNEL, seat_sort.KERNEL):
        wrapper_calls[k.name] = k.launches - wrapper_calls[k.name]
    rows = device_rows(prof)
    kernels_us = sum(t for k, t, _ in rows if not k.startswith("Memcpy")
                     and not k.startswith("Memset"))
    busy = sum(t for _, t, _ in rows)
    log(f"[profile] warm round: wall_us={wall_us:.1f} rounds={out.rounds} "
        f"device_busy_us={busy:.1f} (kernels {kernels_us:.1f}) "
        f"idle_share={1 - min(busy / wall_us, 1):.3f}")
    rows.sort(key=lambda r: -r[1])
    for key, t, n in rows[:24]:
        log(f"[profile]   {t:10.1f} us  x{n:<5d} {key[:90]}")
    # the auction loop's selection and sorts: K12 and K13 as the round
    # calls them (device time of their kernels over the wrapper's calls)
    log(f"[profile] library calls in the round: torch.sort/argsort "
        f"{calls['sort']}, torch.topk {calls['topk']}")
    if (calls["sort"] or calls["topk"]) and solver.last_round_solves == 1:
        raise AssertionError(f"warm round made library calls: {calls}")
    for name, sym in (("top_will", "top_will_"), ("seat_sort", "seat_")):
        hits = [(key, t, n) for key, t, n in rows if sym in key]
        total = sum(t for _, t, _ in hits)
        n_calls = wrapper_calls[name]
        log(f"[profile] {name} as called: total_us={total:.1f} "
            f"kernel_launches={sum(n for _, _, n in hits)} calls={n_calls} "
            f"us_per_call={total / max(n_calls, 1):.3f}")
        for key, t, n in hits:
            log(f"[profile]   {name}: {t:.1f} us x{n} {key[:80]}")
    for k in KERNEL_SYMBOLS:
        hits = [(t, n) for key, t, n in rows if k in key]
        total = sum(t for t, _ in hits)
        count = sum(n for _, n in hits)
        log(f"[profile] kernel {k}: total_us={total:.1f} launches={count} "
            f"us_per_launch={total / max(count, 1):.3f}")
    # K2's first launch after K1 reads the table K1 has just written: a
    # change in where K1's stores leave c (L2 or memory) shows up here
    from torch.autograd import DeviceType

    order = sorted((e for e in prof.events()
                    if e.device_type == DeviceType.CUDA),
                   key=lambda e: e.time_range.start)
    k1_at = [i for i, e in enumerate(order) if KERNEL_SYMBOLS[0] in e.name]
    after = [e for e in order[k1_at[0] + 1:] if KERNEL_SYMBOLS[1] in e.name] \
        if k1_at else []
    log(f"[profile] first {KERNEL_SYMBOLS[1]} after {KERNEL_SYMBOLS[0]}: "
        + (f"us={after[0].time_range.elapsed_us():.3f}" if after
           else "not found"))


def main_path_phase(torch):
    """The flagship resident round on the card: cold + 3 churned warm."""
    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.ops import dense_auction as da
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.resident import ResidentSolver
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    clusters = [config2_quincy_flagship(seed=0)]
    for r in (1, 2, 3):
        clusters.append(churn(clusters[-1], r))
    built = [FlowGraphBuilder().build_arrays(c) for c in clusters]
    solver = ResidentSolver(device="cuda", small_to_oracle=False)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    per_round = []
    for cluster, (arrays, meta) in zip(clusters, built):
        before = {k.name: k.launches for k in kernels.KERNELS}
        n_cap = da.CAPTURES.total
        t0 = time.perf_counter()
        out = solver.run_round(arrays, meta, cost_model="quincy",
                               cost_input_kwargs=cost_kwargs(cluster))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        launched = {k.name: k.launches - before[k.name]
                    for k in kernels.KERNELS}
        per_round.append((cluster, out, wall, launched,
                          solver.last_round_fetches,
                          solver.last_round_loop_syncs,
                          [c[-1] for c in da.CAPTURES.since(n_cap)]))
    launches = {k.name: k.launches for k in kernels.KERNELS}
    profile_round(torch, solver, churn(clusters[-1], 4))
    for r, (cluster, out, wall, launched, fetches, syncs,
            caps) in enumerate(per_round):
        want, oracle_ms = oracle_cost(cluster, torch.device("cuda"))
        log(f"[main] round {r} ({'cold' if r == 0 else 'warm'}): "
            f"tasks={len(out.assignment)} wall_ms={wall:.3f} "
            f"prep_ms={out.timings['prep_ms']:.3f} "
            f"upload_ms={out.timings['upload_ms']:.3f} "
            f"solve_ms={out.timings['solve_ms']:.3f} "
            f"backend={out.backend} converged={out.converged} "
            f"rounds={out.rounds} phases={out.phases} loop_syncs={syncs} "
            f"loop_graph_captures={len(caps)} capture_ms="
            f"{sum(caps):.3f} "
            f"fetches={fetches} cost={out.cost} oracle_cost={want} "
            f"oracle_ms={oracle_ms:.1f} launches={launched}")
        if out.backend != "dense_auction" or not out.converged:
            raise AssertionError(f"round {r}: backend {out.backend}")
        if out.cost != want:
            raise AssertionError(f"round {r}: cost {out.cost} != oracle {want}")
        if fetches != 1:
            raise AssertionError(f"round {r}: {fetches} result fetches")
        if syncs != 0:
            raise AssertionError(f"round {r}: {syncs} loop reads (the loop "
                                 f"is one graph a solve)")
        idle = [n for n in ROUND_KERNELS if launched[n] == 0]
        if idle:
            raise AssertionError(f"round {r}: kernels not launched: {idle}")
    return launches


# ---- [loop]: the auction loop's graph against the host loop ----------

LOOP_FUSE = 2_000                # the fuse-limited case's fuse
# trivial pricing with preference arcs on a 64 x 600 synthetic cluster:
# neither package certifies it within the fuse (ROADMAP Queue 3)
LOOP_FUSE_CLUSTER = (64, 600, 1)
LOOP_OUTPUTS = ("asg", "lvl", "floor", "gap", "converged", "rounds",
                "phases", "hist")


def loop_twin(torch, label: str, args, kw, rows: list):
    """Run ``dense_auction._solve(*args, **kw)`` as the graph (a first
    call, which captures when the key is new, then a cached launch) and
    as the host loop on the same card tensors; every output must be
    equal bit for bit (tolerance 0). Prints the capture's ms, both
    solves' ms and the loop reads; returns the graph's outputs."""
    from poseidon_tpu_torch.guards import SyncCounter
    from poseidon_tpu_torch.ops import dense_auction as da

    kw = {k: v for k, v in kw.items() if k not in ("syncs", "host_loop")}
    n_cap = da.CAPTURES.total
    graph_reads = SyncCounter()
    sync(torch)
    t0 = time.perf_counter()
    first = da._solve(*args, syncs=graph_reads, **kw)
    sync(torch)
    first_ms = (time.perf_counter() - t0) * 1e3
    caps = da.CAPTURES.since(n_cap)
    t0 = time.perf_counter()
    graph = da._solve(*args, syncs=graph_reads, **kw)
    sync(torch)
    graph_ms = (time.perf_counter() - t0) * 1e3
    host_reads = SyncCounter()
    t0 = time.perf_counter()
    host = da._solve(*args, syncs=host_reads, host_loop=True, **kw)
    sync(torch)
    host_ms = (time.perf_counter() - t0) * 1e3
    bad = [n for n, a, b, f in zip(LOOP_OUTPUTS, graph, host, first)
           if not (torch.equal(a, b) and torch.equal(a, f))]
    Tp, Mp = args[0].c.shape
    row = dict(label=label, Tp=Tp, Mp=Mp, rounds=int(graph[5]),
               phases=int(graph[6]), converged=bool(graph[4]),
               capture_ms=sum(c[-1] for c in caps), captures=len(caps),
               first_ms=first_ms, graph_ms=graph_ms, host_ms=host_ms,
               graph_reads=graph_reads.count, host_reads=host_reads.count)
    rows.append(row)
    log(f"[loop] {label}: Tp={Tp} Mp={Mp} rounds={row['rounds']} "
        f"phases={row['phases']} converged={row['converged']} "
        f"captures={len(caps)} capture_ms={row['capture_ms']:.3f} "
        f"first_solve_ms={first_ms:.3f} graph_solve_ms={graph_ms:.3f} "
        f"host_loop_solve_ms={host_ms:.3f} loop_reads graph="
        f"{graph_reads.count} host={host_reads.count} "
        f"equal={'all' if not bad else bad}")
    if bad:
        raise AssertionError(f"[loop] {label}: graph != host loop in {bad}")
    if graph_reads.count:
        raise AssertionError(f"[loop] {label}: the graph made "
                             f"{graph_reads.count} loop reads")
    return graph


def loop_ctl_record(torch, timer):
    """K14 against its twin (tolerance 0) in every mode over every flag,
    done and fuse combination, then timed as one BRANCH step (the
    graph's per-iteration control). Returns its kernels record."""
    from poseidon_tpu_torch.kernels import loop_graph as k14

    dev = torch.device("cuda")
    i32 = torch.int32
    err = 0
    n = 0
    for mode in (k14.ENTER, k14.BRANCH, k14.PHASE, k14.NEXT):
        for flag in (False, True):
            for done in (False, True):
                for rounds, fuse in ((0, 1), (1, 1), (7, 2000), (2000, 2000)):
                    ins = [torch.tensor(flag, device=dev),
                           torch.tensor(rounds, dtype=i32, device=dev),
                           torch.tensor(fuse, dtype=i32, device=dev),
                           torch.tensor(done, device=dev),
                           torch.tensor([1, 1, 1, 1], dtype=i32, device=dev),
                           torch.arange(k14.TALLY, dtype=i32, device=dev)]
                    host = [x.cpu() for x in ins]
                    k14.loop_ctl(mode, *ins)
                    k14.loop_ctl_plain(mode, *host)
                    err = max(err, max_abs_err(ins[4:], [x.to(dev)
                                                         for x in host[4:]]))
                    n += 1
    # LOOP (the general lane's graphs): flags, !done and count < limit
    # terms, alone and together, at every value that decides them; go
    # lands in the tally's slot 5, the run in slot 6
    def word(x):
        return None if x is None else torch.tensor([x], dtype=i32, device=dev)

    n_loop = 0
    for terms in (((None, 0),), ((None, 1),), ((0, None),), ((1, None),),
                  ((7, 8),), ((8, 8),), ((None, 1), (8, 8)),
                  ((None, 1), (7, 8)), ((3, 9), (None, 0), (2, 5)),
                  ((3, 9), (None, 1), (2, 5)), ((9, 9), (None, 1), (2, 5)),
                  ()):
        ins = [tuple(word(x) for x in t) for t in terms]
        host = [tuple(None if x is None else x.cpu() for x in t) for t in ins]
        tally = torch.arange(k14.TALLY, dtype=i32, device=dev)
        tally_h = tally.cpu()
        k14.loop_step(ins, tally, 5, 6)
        k14.loop_step_plain(host, tally_h, 5, 6)
        err = max(err, max_abs_err([tally], [tally_h.to(dev)]))
        n_loop += 1
    ins = [torch.tensor(True, device=dev),
           torch.tensor(3, dtype=i32, device=dev),
           torch.tensor(LOOP_FUSE, dtype=i32, device=dev),
           torch.tensor(False, device=dev),
           torch.zeros(4, dtype=i32, device=dev),
           torch.zeros(k14.TALLY, dtype=i32, device=dev)]
    ms = timer(lambda: k14.loop_ctl(k14.BRANCH, *ins))
    plain = timer(lambda: k14.loop_ctl_plain(k14.BRANCH, *ins))
    # reads flag, rounds, the fuse, done and the tally once; writes the
    # codes and the tally once
    b = 1 + 4 + 4 + 1 + 4 * 4 + 2 * k14.TALLY * 4
    log(f"[kernels] loop_ctl: {n} mode/flag/done/fuse cases and {n_loop} "
        f"LOOP term cases, max_abs_err={err}")
    return (k14.KERNEL, err, ms, plain, *bound_ms(b, 8), (1,))


def loop_phase(torch, card: str) -> None:
    """The loop's graph held against the host loop (the plain version)
    on the same card tensors, bit for bit in every output: the flagship's
    cold round and three churned warm rounds (every ``_solve`` the
    resident chain makes), a warm round with ``collect_hist``, a
    fuse-limited solve (LOOP_FUSE rounds, not converged), the flagship
    as a RowBlocks table of width 2 on the card, and config 8's burst
    round at [scale]'s shape; then a profiled warm round."""
    from poseidon_tpu_torch import parallel
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops import dense_auction as da
    from poseidon_tpu_torch.ops import resident
    from poseidon_tpu_torch.ops.transport import extract_instance
    from poseidon_tpu_torch.synth import (
        config2_quincy_flagship, make_synthetic_cluster, price,
    )

    log(f"[loop] card: {card}")
    rows = []
    calls = []
    original = resident._solve

    def twin(*args, **kw):
        calls.append((args, kw))
        label = f"flagship round {len(calls) - 1} " + (
            "cold" if kw.get("analytic_init") else "warm")
        return loop_twin(torch, label, args, kw, rows)

    clusters = [config2_quincy_flagship(seed=0)]
    for r in (1, 2, 3):
        clusters.append(churn(clusters[-1], r))
    solver = resident.ResidentSolver(device="cuda", small_to_oracle=False)
    resident._solve = twin
    try:
        for r, cluster in enumerate(clusters):
            arrays, meta = FlowGraphBuilder().build_arrays(cluster)
            out = solver.run_round(arrays, meta, cost_model="quincy",
                                   cost_input_kwargs=cost_kwargs(cluster))
            if out.backend != "dense_auction" or not out.converged:
                raise AssertionError(f"[loop] flagship round {r}: "
                                     f"{out.backend}")
            if solver.last_round_loop_syncs or solver.last_round_fetches != 1:
                raise AssertionError(
                    f"[loop] flagship round {r}: loop reads "
                    f"{solver.last_round_loop_syncs}, fetches "
                    f"{solver.last_round_fetches}")
    finally:
        resident._solve = original
    log(f"[loop] flagship auction rounds {[x['rounds'] for x in rows]}, "
        f"phases {[x['phases'] for x in rows]}")

    # the last warm round's solve again, with the histogram
    args, kw = calls[-1]
    loop_twin(torch, "flagship warm, collect_hist", args,
              {**kw, "collect_hist": True}, rows)

    # the flagship as row blocks of width 2, both on this card
    dev0 = args[0]
    sharded = parallel.shard_instance(
        dev0, parallel.make_mesh(devices=[torch.device("cuda", 0)] * 2))
    if not isinstance(sharded.c, da.RowBlocks) or not da.uses_graph(sharded.c):
        raise AssertionError("[loop] the width-2 table takes no graph")
    loop_twin(torch, "flagship RowBlocks width 2", (sharded, *args[1:]), kw,
              rows)

    # a fuse-limited solve
    M, T, seed = LOOP_FUSE_CLUSTER
    cl = make_synthetic_cluster(M, T, seed=seed)
    net, meta = FlowGraphBuilder().build(cl)
    net = price(net, meta, "trivial", cl, device="cuda")
    inst = da.build_dense_instance(extract_instance(net, meta),
                                   torch.device("cuda"))
    out = loop_twin(torch, f"{M} x {T} trivial with preferences, fuse "
                    f"{LOOP_FUSE}", (inst, *da.cold_start(inst)),
                    dict(alpha=1024, max_rounds=LOOP_FUSE, smax=inst.smax,
                         analytic_init=True), rows)
    if int(out[5]) != LOOP_FUSE or bool(out[4]):
        raise AssertionError(f"[loop] fuse case: rounds {int(out[5])}, "
                             f"converged {bool(out[4])}")

    loop_config8(torch, rows)

    # a profiled warm round (the graph, no twin)
    profile_round(torch, solver, churn(clusters[-1], 4))
    graph_s = sum(x["graph_ms"] for x in rows) / 1e3
    host_s = sum(x["host_ms"] for x in rows) / 1e3
    log(f"[loop] {len(rows)} solves: graph {graph_s:.3f} s, host loop "
        f"{host_s:.3f} s, captures {sum(x['captures'] for x in rows)} in "
        f"{sum(x['capture_ms'] for x in rows):.3f} ms | {card}")


def loop_config8(torch, rows: list) -> None:
    """Config 8's burst round through the bridge as [scale] runs it
    (aggregation, top-2 preferences, width 1), its solve held graph
    against host loop."""
    import logging

    from poseidon_tpu_torch.bridge import SchedulerBridge
    from poseidon_tpu_torch.ops import resident
    from poseidon_tpu_torch.synth import config8_scale

    n_machines, n_tasks = CONFIG8
    cluster = config8_scale(n_machines, n_tasks, seed=0,
                            machines_per_rack=CONFIG8_RACK, n_skus=2)
    bridge = SchedulerBridge(
        cost_model="quincy", small_to_oracle=False, aggregate_classes=True,
        topk_prefs=2, mesh_width=1, device="cuda")
    bridge.solver.oracle_fallback = False
    bridge.observe_nodes(cluster.machines)
    bridge.observe_pods(cluster.tasks)
    original = resident._solve
    bridge_log = logging.getLogger("poseidon_tpu_torch.bridge.bridge")
    level = bridge_log.level
    bridge_log.setLevel(logging.WARNING)
    resident._solve = lambda *a, **k: loop_twin(
        torch, f"config 8 burst ({n_machines} x {n_tasks})", a, k, rows)
    try:
        res = bridge.run_scheduler()
    finally:
        resident._solve = original
        bridge_log.setLevel(level)
    if res.stats.backend != "dense_auction":
        raise AssertionError(f"[loop] config 8: {res.stats.backend}")


# ---- the six cost models --------------------------------------------

# the CostInputs fields each model reads (``_finish``'s included), for
# the pricing pass's byte bound
_FINISH_FIELDS = ("kind", "task", "discount", "valid", "task_running")
MODEL_FIELDS = {
    "trivial": _FINISH_FIELDS,
    "random": _FINISH_FIELDS + ("machine",),
    "quincy": _FINISH_FIELDS + ("weight", "task_input", "task_wait"),
    "octopus": _FINISH_FIELDS + ("machine", "machine_load",
                                 "machine_used_slots"),
    "wharemap": _FINISH_FIELDS + ("machine", "task_usage", "task_cpu",
                                  "machine_load"),
    "coco": _FINISH_FIELDS + ("machine", "task_cpu", "task_mem_kb",
                              "machine_load", "machine_mem_free",
                              "task_wait"),
}


def knowledge_kwargs(cluster, seed: int) -> dict:
    """The round's cost inputs with seeded knowledge-base aggregates:
    per-task usage, per-machine load, free memory and used slots."""
    import numpy as np

    rng = np.random.default_rng(seed)
    T, M = len(cluster.pending()), len(cluster.machines)
    return dict(
        cost_kwargs(cluster),
        task_usage=(rng.random(T) * 2).astype(np.float32),
        machine_load=rng.random(M).astype(np.float32),
        machine_mem_free=rng.random(M).astype(np.float32),
        machine_used_slots=rng.integers(0, 10, M).astype(np.int32),
    )


def model_round(torch, cluster, model: str, kw: dict, label: str):
    """One cold round of ``cluster`` under ``model`` on the card, its
    cost held against the C++ oracle on the same priced graph."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops.resident import ResidentSolver

    arrays, meta = FlowGraphBuilder().build_arrays(cluster)
    solver = ResidentSolver(device="cuda", small_to_oracle=False)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = solver.run_round(arrays, meta, cost_model=model,
                           cost_input_kwargs=kw)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    want, oracle_ms = oracle_cost(cluster, torch.device("cuda"), model, kw)
    log(f"[models] {label} under {model}: tasks={len(out.assignment)} "
        f"backend={out.backend} converged={out.converged} "
        f"rounds={out.rounds} phases={out.phases} wall_ms={wall:.3f} "
        f"solve_ms={out.timings.get('solve_ms', 0.0):.3f} "
        f"loop_syncs={solver.last_round_loop_syncs} cost={out.cost} "
        f"oracle_cost={want} oracle_ms={oracle_ms:.1f}")
    if out.cost != want:
        raise AssertionError(f"[models] {label} under {model}: cost "
                             f"{out.cost} != oracle {want}")


def models_phase(torch, timer):
    """Each of the six models prices the flagship's cost inputs on the
    card exactly as on the CPU (tolerance 0; knowledge aggregates from a
    seeded generator), timed cold beside its byte bound; then one cold
    flagship round under octopus (the shipped selector) and one BASELINE
    config 3 round under coco, each equal to the C++ oracle."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.network import pad_bucket
    from poseidon_tpu_torch.models.costs import (
        COST_MODELS, build_cost_inputs_host,
    )
    from poseidon_tpu_torch.synth import config2_quincy_flagship, config3_coco

    cluster = config2_quincy_flagship(seed=0)
    kw = knowledge_kwargs(cluster, seed=5)
    _, meta = FlowGraphBuilder().build_arrays(cluster)
    host = build_cost_inputs_host(pad_bucket(meta.n_arcs), meta, **kw)
    card = host.to_device(torch.device("cuda"))
    cpu = host.to_device(torch.device("cpu"))
    E = host.kind.shape[0]
    for name in sorted(COST_MODELS):
        fn = COST_MODELS[name]
        got = fn(card).cpu()
        want = fn(cpu)
        err = max_abs_err([got], [want])
        ms = timer(lambda: fn(card))
        n_bytes = sum(getattr(host, f).nbytes for f in MODEL_FIELDS[name])
        bms, by = bound_ms(n_bytes + E * 4, E * 12)
        log(f"[models] {name}: arcs={meta.n_arcs} (E={E}) card == cpu "
            f"max_abs_err={err} ms={ms:.6f} bound_ms={bms:.6f} ({by}, "
            f"{n_bytes + E * 4} B)")
        if err != 0:
            raise AssertionError(f"[models] {name}: card != cpu "
                                 f"(max_abs_err {err})")
    model_round(torch, cluster, "octopus", kw, "config 2 flagship")
    coco = config3_coco(seed=0)
    model_round(torch, coco, "coco", knowledge_kwargs(coco, seed=6),
                "config 3")


# ---- the express lane ------------------------------------------------


def express_events(bridge, rng, window: int, *, n: int = 16,
                   completions: int = 2, racks: bool = True):
    """One window's watch events: ``n`` seeded synth-shaped arrivals,
    each with one machine or rack preference (machines with a free
    seat), and ``completions`` running pods that finish."""
    from poseidon_tpu_torch.cluster import Task, TaskPhase

    used = {}
    for t in bridge.tasks.values():
        if t.phase == TaskPhase.RUNNING:
            used[t.machine] = used.get(t.machine, 0) + 1
    free = sorted(m.name for m in bridge.machines.values()
                  if used.get(m.name, 0) + 2 < m.max_tasks)
    rack_names = sorted({m.rack for m in bridge.machines.values()})
    events = []
    for k in range(n):
        if racks and rng.random() < 0.3:
            prefs = {rack_names[int(rng.integers(len(rack_names)))]:
                     int(rng.integers(10, 100))}
        else:
            prefs = {free[int(rng.integers(len(free)))]:
                     int(rng.integers(20, 200))}
        events.append(("ADDED", Task(
            uid=f"xp-{window}-{k:03d}", job=f"job-xp-{window}",
            cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
            memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
            data_prefs=prefs,
        )))
    running = sorted(u for u, t in bridge.tasks.items()
                     if t.phase == TaskPhase.RUNNING)
    for i in rng.choice(len(running), size=completions, replace=False):
        events.append(("DELETED", bridge.tasks[running[int(i)]]))
    return events


def express_bridge(device, cluster, stream_windows: int = 0, **scale):
    """A bridge with the express lane on (and the stream lane with
    ``stream_windows`` K > 1) over ``cluster``, one certified round
    behind it and its bindings confirmed. ``scale`` takes the scale
    lane's options (aggregation, the mesh)."""
    from poseidon_tpu_torch.bridge import SchedulerBridge

    bridge = SchedulerBridge(cost_model="quincy", small_to_oracle=False,
                             express_lane=True, device=device,
                             stream_windows=stream_windows, **scale)
    bridge.observe_nodes(list(cluster.machines))
    bridge.observe_pods(list(cluster.tasks))
    res = bridge.run_scheduler()
    if res.stats.backend != "dense_auction":
        raise AssertionError(f"express: first round {res.stats.backend}")
    for uid, m in res.bindings.items():
        bridge.confirm_binding(uid, m)
    return bridge, res


def express_parity():
    """Three express windows on the 64 x 600 parity cell, on the card
    and on the CPU: every field of every batch equal."""
    import numpy as np

    from poseidon_tpu_torch.synth import make_synthetic_cluster

    cluster = make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8)
    runs = {}
    for device in ("cuda", "cpu"):
        bridge, _ = express_bridge(device, cluster)
        rng = np.random.default_rng(77)
        out = []
        last = {}
        for window in range(3):
            for uid, m in last.items():
                bridge.confirm_binding(uid, m)
            r = bridge.express_batch(express_events(bridge, rng, window, n=8))
            if r is None:
                raise AssertionError(f"[parity] express window {window} "
                                     f"degraded on {device}")
            last = dict(r.bindings)
            warm = bridge.solver.warm
            out.append((dict(r.bindings), r.cost, r.rounds, len(r.bindings),
                        *(np.asarray(t.cpu()).tolist()
                          for t in (warm.asg, warm.lvl, warm.floor))))
        runs[device] = out
    for w, (a, b) in enumerate(zip(runs["cuda"], runs["cpu"])):
        if a != b:
            raise AssertionError(f"[parity] express window {w}: card != cpu")
        log(f"[parity] express window {w}: card == cpu (placements={a[3]} "
            f"cost={a[1]} rounds={a[2]})")


EXPRESS_WINDOWS = 8


def profile_express(prof, wall_us: float) -> None:
    """Device busy and idle share of one profiled express batch, its
    top device items, and the express path's hand kernels as called."""
    rows = device_rows(prof)
    busy = sum(t for _, t, _ in rows)
    log(f"[profile] express batch: wall_us={wall_us:.1f} "
        f"device_busy_us={busy:.1f} "
        f"idle_share={1 - min(busy / wall_us, 1):.3f}")
    rows.sort(key=lambda r: -r[1])
    for key, t, n in rows[:12]:
        log(f"[profile]   {t:10.1f} us  x{n:<5d} {key[:90]}")
    for k in EXPRESS_SYMBOLS:
        hits = [(t, n) for key, t, n in rows if k in key]
        total = sum(t for t, _ in hits)
        count = sum(n for _, n in hits)
        log(f"[profile] express kernel {k}: total_us={total:.1f} "
            f"launches={count} us_per_launch={total / max(count, 1):.3f}")


def express_phase(torch):
    """The express lane at full width: a bridge on the card over the
    flagship, one certified round, then EXPRESS_WINDOWS windows of 16
    arrivals and 2 completions (each confirming the last window's
    placements, which reach K5 as retires), a correction round, and one
    last window left unconfirmed whose placements must equal the next
    full round's choice per uid. Returns the launch counts of the run."""
    import numpy as np

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    cluster = config2_quincy_flagship(seed=0)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    bridge, first = express_bridge("cuda", cluster)
    solver = bridge.solver
    log(f"[express] first round: placed={first.stats.pods_placed} "
        f"cost={first.stats.cost} solve_ms={first.stats.solve_ms:.3f}")
    rng = np.random.default_rng(404)
    need = ("express_rows", "express_patch", "stream_commit", "row_options",
            "bid_pass")

    def run_window(window: int, events, arrivals: int,
                   profiled: bool = False) -> dict:
        from torch.profiler import ProfilerActivity, profile

        before = {k.name: k.launches for k in kernels.KERNELS}
        torch.cuda.synchronize()
        marks.reset()
        if profiled:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                r = bridge.express_batch(events, t_event=t0)
                torch.cuda.synchronize()
                wall_us = (time.perf_counter() - t0) * 1e6
            profile_express(prof, wall_us)
            w = window_profile(prof, wall_us)
            log(f"[express] window {window}: CUDA kernels {w['kernels']}, "
                f"{w['kernels_outside_solve']} of them outside _solve "
                f"({w['unlinked']} placed by device time), copies "
                f"{w['copies']}")
        else:
            r = bridge.express_batch(events, t_event=time.perf_counter())
        torch.cuda.synchronize()
        log(f"[express] window {window}: _express_step host_us outside "
            f"_solve={(marks.step_s - marks.solve_s) * 1e6:.1f}")
        launched = {k.name: k.launches - before[k.name]
                    for k in kernels.KERNELS}
        if r is None:
            raise AssertionError(f"[express] window {window} degraded")
        t = r.timings
        log(f"[express] window {window}: arrivals={arrivals} "
            f"placed={len(r.bindings)} cost={r.cost} "
            f"repair_rounds={r.rounds} "
            f"loop_syncs={solver.last_round_loop_syncs} "
            f"fetches={solver.last_round_fetches} "
            f"prep_ms={t.get('prep_ms', 0.0):.3f} "
            f"upload_ms={t.get('upload_ms', 0.0):.3f} "
            f"solve_ms={t.get('solve_ms', 0.0):.3f} "
            f"e2b_ms={r.latency_ms:.3f} launches={launched}")
        if solver.last_round_fetches != 1 or not solver.express_ready \
                or solver.last_round_loop_syncs != 0:
            raise AssertionError(f"[express] window {window}: "
                                 f"{solver.last_round_fetches} fetches, "
                                 f"{solver.last_round_loop_syncs} loop "
                                 f"reads, context {solver.express_ready}")
        idle = [n for n in need if launched[n] == 0]
        if idle:
            raise AssertionError(f"[express] window {window}: kernels not "
                                 f"launched: {idle}")
        if not r.bindings:
            raise AssertionError(f"[express] window {window}: no placement")
        return dict(r.bindings)

    from kernel_ab import SolveMarks, window_profile
    from poseidon_tpu_torch.ops import resident

    placed_since = {}
    last = {}
    with SolveMarks(torch, resident) as marks:
        for window in range(EXPRESS_WINDOWS):
            for uid, m in last.items():
                bridge.confirm_binding(uid, m)
            last = run_window(window, express_events(bridge, rng, window),
                              16, profiled=window == EXPRESS_WINDOWS - 1)
            placed_since.update(last)
    for uid, m in last.items():
        bridge.confirm_binding(uid, m)
    res = bridge.run_scheduler()
    s = res.stats
    moved = sum(u in res.migrations or u in res.preemptions
                for u in placed_since)
    log(f"[express] correction round: backend={s.backend} "
        f"placed={s.pods_placed} express_batches={s.express_batches} "
        f"express_places={s.express_places} "
        f"express_corrected={s.express_corrected} (moved {moved}) "
        f"express_degrades={s.express_degrades} "
        f"e2b_p50_ms={s.express_e2b_p50_ms:.3f} "
        f"e2b_p99_ms={s.express_e2b_p99_ms:.3f} solve_ms={s.solve_ms:.3f}")
    if (s.backend != "dense_auction" or s.express_corrected != moved
            or s.express_degrades != 0
            or s.express_batches != EXPRESS_WINDOWS):
        raise AssertionError(f"[express] correction round: {s}")
    for uid, m in res.bindings.items():
        bridge.confirm_binding(uid, m)
    # one last window, machine preferences only, left unconfirmed
    with SolveMarks(torch, resident) as marks:
        last = run_window(EXPRESS_WINDOWS, express_events(
            bridge, rng, EXPRESS_WINDOWS, racks=False, completions=0), 16)
    # the differential contract: unconfirmed express placements equal
    # what the next full round chooses for the same pods
    res = bridge.run_scheduler()
    differ = {u: (m, res.bindings.get(u)) for u, m in last.items()
              if res.bindings.get(u) != m}
    log(f"[express] next round over the unconfirmed window: "
        f"backend={res.stats.backend} {len(last) - len(differ)} of "
        f"{len(last)} express placements equal the round's choice")
    if differ:
        raise AssertionError(f"[express] express != next round: "
                             f"{list(differ.items())[:4]}")
    return {k.name: k.launches for k in kernels.KERNELS}


STREAM_WINDOWS = 8
STREAM_SYMBOLS = ("stream_commit_kernel", "express_rows_kernel",
                  "express_patch_kernel", "row_options_kernel",
                  "bid_pass_kernel")


class TwinChain:
    """While active, every ``_stream_chain`` over a table on the card
    (the flush's graph route) first copies its card inputs (the table,
    the round's vectors, the warm start; the windows are only read);
    ``check(label)`` then replays each recorded flush from those copies
    by ``host_loop=True`` (the plain version: the windows and every
    repair on the host) and holds every window's log row and rounds and
    the whole carry to the graph's, bit for bit. Call it right after
    the flush's finish, before the next flush patches the table."""

    def __init__(self, torch):
        from poseidon_tpu_torch.ops import resident

        self.torch, self.mod = torch, resident
        # the replays call the module's own function (made before any
        # timing wrapper is put in its place)
        self.real = self.inner = resident._stream_chain
        self.flushes = []

    def __enter__(self):
        self.inner = self.mod._stream_chain
        self.mod._stream_chain = self
        return self

    def __exit__(self, *exc):
        self.mod._stream_chain = self.inner

    @staticmethod
    def _copy_table(c):
        from poseidon_tpu_torch.ops.dense_auction import RowBlocks

        if isinstance(c, RowBlocks):
            return RowBlocks([b.clone() for b in c.blocks], c.mesh)
        return c.clone()

    def __call__(self, dev, dt, cost_dev, windows, asg, lvl, floor, **kw):
        import dataclasses

        if not self.mod.uses_graph(dev.c) or kw.get("host_loop"):
            return self.inner(dev, dt, cost_dev, windows, asg, lvl, floor,
                              **kw)
        copy = (dataclasses.replace(
            dev, c=self._copy_table(dev.c), u=dev.u.clone(),
            w=dev.w.clone(), s=dev.s.clone(),
            task_valid=dev.task_valid.clone()),
            asg.clone(), lvl.clone(), floor.clone())
        out = self.inner(dev, dt, cost_dev, windows, asg, lvl, floor, **kw)
        self.flushes.append((copy, dt, cost_dev, windows, kw, out))
        return out

    def check(self, label: str) -> int:
        """Replay the flushes recorded since the last check; returns how
        many were held."""
        from poseidon_tpu_torch.guards import SyncCounter
        from poseidon_tpu_torch.ops.dense_auction import RowBlocks

        torch = self.torch
        n = len(self.flushes)
        for (dev, asg, lvl, floor), dt, cost_dev, windows, kw, out in \
                self.flushes:
            kw = {k: v for k, v in kw.items()
                  if k not in ("graph_stats", "syncs")}
            syncs = SyncCounter()
            t0 = time.perf_counter()
            host = self.real(dev, dt, cost_dev, windows, asg, lvl, floor,
                             host_loop=True, syncs=syncs, **kw)
            sync(torch)
            host_ms = (time.perf_counter() - t0) * 1e3

            def flat(x):
                return (torch.cat([b.reshape(-1) for b in x.blocks])
                        if isinstance(x, RowBlocks) else x.reshape(-1))

            names = ("c", "u", "w", "s", "valid", "asg", "lvl", "floor",
                     "live")
            differ = [nm for nm, a, b in zip(names, out[0], host[0])
                      if not torch.equal(flat(a), flat(b))]
            if not torch.equal(out[1], host[1]):
                differ.append("log")
            if not torch.equal(torch.stack(out[2]), torch.stack(host[2])):
                differ.append("rounds")
            if differ:
                raise AssertionError(f"[stream] {label}: the graph != "
                                     f"host_loop=True on {differ}")
            log(f"[stream] {label}: graph == host_loop=True on the same "
                f"card inputs, bit for bit (every window's log row and "
                f"rounds {torch.stack(out[2]).tolist()}, the carry); the "
                f"host loop {host_ms:.3f} ms, {syncs.count} loop reads")
        self.flushes = []
        return n


class GraphTimer:
    """While active, every loop graph launch records CUDA events just
    before and after itself on its stream; ``ms(label)`` sums the device
    ms between them over the launches of graphs so labelled (read after
    a synchronise): a flush graph's device time from its first node to
    its last."""

    def __init__(self, torch):
        from poseidon_tpu_torch.kernels import loop_graph

        self.torch, self.cls = torch, loop_graph.ControlGraph
        self.pairs = []

    def __enter__(self):
        torch, timer = self.torch, self
        self.real = real = self.cls.launch

        def launch(graph):
            stream = torch.cuda.current_stream(graph.device)
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record(stream)
            real(graph)
            b.record(stream)
            timer.pairs.append((graph.label, a, b))

        self.cls.launch = launch
        return self

    def __exit__(self, *exc):
        self.cls.launch = self.real

    def ms(self, label: str) -> float:
        return sum(a.elapsed_time(b) for lb, a, b in self.pairs
                   if lb == label)


def stream_graph_line(solver, captures0: int) -> dict:
    """The last flush's graph numbers (``last_stream_graph``): launches
    and windows from the graph's tally, capture ms, and the flush
    graphs captured since ``captures0``."""
    from poseidon_tpu_torch.ops import resident

    g = dict(solver.last_stream_graph)
    g["captures"] = resident.STREAM_CAPTURES.total - captures0
    return g


def profile_symbols(prof, wall_us: float, label: str, symbols) -> None:
    """Device busy and idle share of one profiled call and each named
    kernel's device time as called (by its CUDA symbol)."""
    rows = device_rows(prof)
    busy = sum(t for _, t, _ in rows)
    log(f"[profile] {label}: wall_us={wall_us:.1f} "
        f"device_busy_us={busy:.1f} "
        f"idle_share={1 - min(busy / max(wall_us, 1e-9), 1):.3f}")
    for k in symbols:
        hits = [(t, n) for key, t, n in rows if k in key]
        total = sum(t for t, _ in hits)
        count = sum(n for _, n in hits)
        log(f"[profile] {label} kernel {k}: total_us={total:.1f} "
            f"launches={count} us_per_launch={total / max(count, 1):.3f}")


def stream_schedule(bridge, rng, tag: str, sizes, *, completions: int = 2):
    """The windows of one stream batch, drawn from ONE snapshot of the
    bridge (the synced and the stream lane agree on running pods only at
    flush boundaries): per window ``sizes[w]`` seeded arrivals with one
    machine or rack preference each (the ``[express]`` schedule's shape)
    and ``completions`` running pods that finish, none twice. Events
    name pods by uid, so each bridge resolves them against its own
    state."""
    from poseidon_tpu_torch.cluster import TaskPhase

    used = {}
    for t in bridge.tasks.values():
        if t.phase == TaskPhase.RUNNING:
            used[t.machine] = used.get(t.machine, 0) + 1
    free = sorted(m.name for m in bridge.machines.values()
                  if used.get(m.name, 0) + 2 < m.max_tasks)
    rack_names = sorted({m.rack for m in bridge.machines.values()})
    running = sorted(u for u, t in bridge.tasks.items()
                     if t.phase == TaskPhase.RUNNING)
    victims = [running[int(i)] for i in rng.choice(
        len(running), size=completions * len(sizes), replace=False)]
    windows = []
    for w, n in enumerate(sizes):
        arrivals = []
        for k in range(n):
            if rng.random() < 0.3:
                prefs = {rack_names[int(rng.integers(len(rack_names)))]:
                         int(rng.integers(10, 100))}
            else:
                prefs = {free[int(rng.integers(len(free)))]:
                         int(rng.integers(20, 200))}
            arrivals.append(dict(
                uid=f"st-{tag}-{w}-{k:03d}", job=f"job-st-{tag}-{w}",
                cpu_request=float(rng.choice([0.1, 0.25, 0.5, 1.0])),
                memory_request_kb=int(rng.choice([1, 2, 8])) << 18,
                data_prefs=prefs,
            ))
        windows.append((arrivals,
                        victims[w * completions: (w + 1) * completions]))
    return windows


def stream_events(bridge, window):
    from poseidon_tpu_torch.cluster import Task

    arrivals, victims = window
    return ([("ADDED", Task(**a)) for a in arrivals]
            + [("DELETED", bridge.tasks[u]) for u in victims])


def synced_windows(bridge, windows, label: str) -> list[dict]:
    """The synced express lane over ``windows``: one batch and its
    confirmations per window; returns each window's placements."""
    out = []
    for w, window in enumerate(windows):
        r = bridge.express_batch(stream_events(bridge, window),
                                 t_event=time.perf_counter())
        if r is None or not bridge.solver.express_ready:
            raise AssertionError(f"[stream] {label}: synced window {w} "
                                 f"degraded")
        out.append(dict(r.bindings))
        for uid, m in r.bindings.items():
            bridge.confirm_binding(uid, m)
    return out


def stream_flush_windows(bridge, windows, label: str):
    """The stream lane over ``windows``: accumulate, ONE flush, finish.
    Returns each window's placements (from the decision log), the
    result and the flush's inflight record (ctx, carry)."""
    for w, window in enumerate(windows):
        if not bridge.stream_window(stream_events(bridge, window),
                                    t_event=time.perf_counter()):
            raise AssertionError(f"[stream] {label}: window {w} did not "
                                 f"accumulate")
    n_log = len(bridge.decision_log)
    bridge.stream_flush()
    inflight = bridge.solver._stream_inflight
    r = bridge.stream_finish()
    per = [dict() for _ in windows]
    for _round, kind, uid, detail in list(bridge.decision_log)[n_log:]:
        if kind == "PLACE" and isinstance(detail, dict):
            per[detail["stream_window"]][uid] = detail["machine"]
    if r is not None:
        for uid, m in r.bindings.items():
            bridge.confirm_binding(uid, m)
    return per, r, inflight


def stream_phase(torch, card: str):
    """The stream lane at full width over the flagship: a K = 8 flush of
    the ``[express]`` schedule (16 arrivals and 2 completions a window)
    on a bridge on the card, with ONE result fetch and K4, K5 and K7
    launched, equal window by window (placements, window costs and
    rounds, then the warm carry) to the same flush on a bridge on the
    CPU (the twins); beside it, the synced express lane on a third
    bridge over the same windows, its agreement printed (both packages
    place ties differently in the two lanes: see ``stream_failure``'s
    note); a short flush (3 windows, padded) and the full flush again
    (its graph cached: the steady state), again card == CPU; and a
    flush whose window 3 fails its certificate (``stream_failure``).
    Each card flush is one graph launch, replayed by ``host_loop=True``
    (``TwinChain``); its graph's device ms (``GraphTimer``) and its
    placements' e2b p50/p99 are printed. Returns the launch counts of
    the K = 8 flush."""
    import numpy as np

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    log(f"[stream] card: {card}")
    cluster = config2_quincy_flagship(seed=0)
    card_b = express_bridge(DEVICE, cluster, STREAM_WINDOWS)[0]
    host_b = express_bridge("cpu", cluster, STREAM_WINDOWS)[0]
    synced = express_bridge(DEVICE, cluster, 0)[0]
    rng = np.random.default_rng(505)
    solver = card_b.solver

    def run(label, sizes, launches=False, profiled=False):
        from kernel_ab import InlineFetch, SolveMarks, window_profile
        from poseidon_tpu_torch.ops import resident

        windows = stream_schedule(card_b, rng, label, sizes)
        fetched0 = solver.stream_fetches
        captures0 = resident.STREAM_CAPTURES.total
        n_e2b = len(card_b._express_e2b)
        twin = TwinChain(torch)
        timer = GraphTimer(torch) if DEVICE == "cuda" else None
        sync(torch)
        if launches:
            kernels.reset_launch_counts()
        with SolveMarks(torch, resident) as marks, twin, \
                timer or contextlib.nullcontext():
            if profiled and DEVICE == "cuda":
                from torch.profiler import ProfilerActivity, profile

                # the flush on this thread: the profiler records its spans
                async_fetch, resident._AsyncFetch = (resident._AsyncFetch,
                                                     InlineFetch)
                try:
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        t0 = time.perf_counter()
                        per, r, _inf = stream_flush_windows(card_b, windows,
                                                            label)
                        sync(torch)
                        wall_ms = (time.perf_counter() - t0) * 1e3
                finally:
                    resident._AsyncFetch = async_fetch
                profile_symbols(prof, wall_ms * 1e3, f"stream {label} flush",
                                STREAM_SYMBOLS)
                w = window_profile(prof, wall_ms * 1e3)
                log(f"[stream] {label}: CUDA kernels a window "
                    f"{w['kernels'] / STREAM_WINDOWS:.1f}, outside _solve "
                    f"{w['kernels_outside_solve'] / STREAM_WINDOWS:.1f} "
                    f"({w['unlinked']} placed by device time; "
                    f"{STREAM_WINDOWS} windows, the padding's included)")
            else:
                t0 = time.perf_counter()
                per, r, _inf = stream_flush_windows(card_b, windows, label)
                sync(torch)
                wall_ms = (time.perf_counter() - t0) * 1e3
        log(f"[stream] {label}: host_us a window outside _solve="
            f"{(marks.chain_s - marks.solve_s) / STREAM_WINDOWS * 1e6:.1f}")
        counts = {k.name: k.launches for k in kernels.KERNELS}
        g = stream_graph_line(solver, captures0)
        graph_ms = timer.ms("the stream flush") if timer else 0.0
        e2b = np.asarray(card_b._express_e2b[n_e2b:] or [0.0])
        log(f"[stream] {label}: graph launches={g.get('launches', 0)} "
            f"windows run (tally)={g.get('windows_run', 0)} loop_reads="
            f"{solver.last_round_loop_syncs} fetches="
            f"{solver.last_stream_fetches} captures={g['captures']} "
            f"capture_ms={g.get('capture_ms', 0.0):.3f} graph_device_ms="
            f"{graph_ms:.3f} ({graph_ms / STREAM_WINDOWS:.3f} a window; "
            f"the flush's wall outside the graph's span "
            f"{1 - graph_ms / wall_ms:.3f}) "
            f"e2b_p50_ms={np.percentile(e2b, 50):.3f} e2b_p99_ms="
            f"{np.percentile(e2b, 99):.3f} | {card}")
        if DEVICE == "cuda" and (g.get("launches") != 1 or g.get(
                "windows_run") != STREAM_WINDOWS):
            raise AssertionError(f"[stream] {label}: not one graph launch "
                                 f"of {STREAM_WINDOWS} windows: {g}")
        if DEVICE == "cuda" and twin.check(label) != 1:
            raise AssertionError(f"[stream] {label}: the flush did not "
                                 "take the graph route")
        t = r.timings if r is not None else {}
        log(f"[stream] {label}: windows={len(windows)} of K="
            f"{STREAM_WINDOWS} placed={[len(a) for a in per]} "
            f"fetches={solver.stream_fetches - fetched0} "
            f"last_stream_fetches={solver.last_stream_fetches} "
            f"loop_syncs={solver.last_round_loop_syncs} "
            f"prep_ms={t.get('prep_ms', 0.0):.3f} "
            f"upload_ms={t.get('upload_ms', 0.0):.3f} "
            f"stack_ms={t.get('stack_ms', 0.0):.3f} "
            f"solve_ms={t.get('solve_ms', 0.0):.3f} wall_ms={wall_ms:.3f} "
            f"per_window_ms={wall_ms / len(windows):.3f} "
            f"e2b_ms={r.latency_ms if r else 0.0:.3f}"
            + (f" launches={counts}" if launches else ""))
        if (solver.stream_fetches - fetched0 != 1
                or solver.last_stream_fetches != 1
                or (solver.last_round_loop_syncs != 0 and DEVICE == "cuda")
                or not solver.express_ready or not all(per)):
            raise AssertionError(f"[stream] {label}: fetches "
                                 f"{solver.last_stream_fetches}, loop reads "
                                 f"{solver.last_round_loop_syncs}, context "
                                 f"{solver.express_ready}")
        per_h, r_h, _ = stream_flush_windows(host_b, windows, label)
        a, b = card_b.solver.warm, host_b.solver.warm
        carry_equal = all(torch.equal(x.cpu(), y)
                          for x, y in ((a.asg, b.asg), (a.lvl, b.lvl),
                                       (a.floor, b.floor)))
        if (per != per_h or r.cost != r_h.cost or r.rounds != r_h.rounds
                or not carry_equal):
            raise AssertionError(f"[stream] {label}: card != cpu")
        log(f"[stream] {label}: card == cpu for every window's placements, "
            f"the cost ({r.cost}), the rounds ({r.rounds}) and the carry")
        return windows, per, counts

    windows, per, counts = run("full", [16] * STREAM_WINDOWS, launches=True)
    # the counted flush is the bridge's first (it captures): a window
    # launches K4, K5 and K7 once each, and nothing else launches them
    off = [n for n in ("express_rows", "express_patch", "stream_commit")
           if counts[n] != STREAM_WINDOWS and DEVICE == "cuda"]
    if off:
        raise AssertionError(f"[stream] K4/K5/K7 not {STREAM_WINDOWS} "
                             f"launches each in the counted flush: "
                             f"{ {n: counts[n] for n in off} }")
    want = synced_windows(synced, windows, "full")
    same = [sum(a.get(u) == m for u, m in b.items())
            for a, b in zip(per, want)]
    log(f"[stream] synced express lane over the same windows: placed "
        f"{[len(b) for b in want]}, the same pod on the same machine as "
        f"the stream in {same} (ties go another way in the two lanes, as "
        f"in the reference)")
    run("short", [16] * 3, profiled=True)
    # the full flush again, its graph cached: the steady state
    run("steady", [16] * STREAM_WINDOWS)
    stream_failure(torch, cluster)
    return counts


def stream_failure(torch, cluster) -> None:
    """A flush whose window 3 fails its certificate: windows 0-2 of 4
    arrivals, window 3 of 16, and a change cap the first three meet and
    window 3 overflows (taken from a clean 3-window flush of the same
    windows on a second bridge). Windows 0-2 bind as the clean flush's,
    the table (window 3's K4 rows put back by K7) and the carry equal
    the clean flush's, the degrade names window 3 and the cap, and the
    next round binds window 3's pods.

    Why a clean flush and not the synced lane: the synced lane frees a
    placed pod's table row at the next window's retire, where the next
    arrivals take it; the stream lane frees it at the finish. Arrivals
    thus sit in other rows, and the auction's task-id tie-breaks can
    seat them on other machines of equal cost. The reference does the
    same (ROADMAP Queue 3)."""
    import numpy as np

    failing = express_bridge(DEVICE, cluster, STREAM_WINDOWS)[0]
    clean = express_bridge(DEVICE, cluster, STREAM_WINDOWS)[0]
    rng = np.random.default_rng(606)
    windows = stream_schedule(clean, rng, "fail", [4, 4, 4, 16])
    twin = TwinChain(torch)
    with twin:
        want, _r3, inf3 = stream_flush_windows(clean, windows[:3], "clean")
    twin.check("clean 3-window flush")
    cap = max(len(b) for b in want)
    failing.solver.express_change_cap = cap
    trace = failing.trace
    # the trace is a ring (the first round's events fill it): count
    # the events this flush adds by the ring's running total
    n0 = trace.dropped_total + len(trace.events)
    with twin:
        per, r, inf = stream_flush_windows(failing, windows, "fail")
    sync(torch)
    g = failing.solver.last_stream_graph
    log(f"[stream] failing flush: graph launches={g.get('launches', 0)} "
        f"windows run (tally)={g.get('windows_run', 0)} loop_reads="
        f"{failing.solver.last_round_loop_syncs}")
    if DEVICE == "cuda" and (twin.check("failing flush") != 1
                             or g.get("launches") != 1):
        raise AssertionError("[stream] failing flush: not one graph launch")
    new = trace.dropped_total + len(trace.events) - n0
    tail = list(trace.events)[-new:] if new else []
    whys = [e.detail["why"] for e in tail if e.event == "EXPRESS_DEGRADE"]
    flush = [e.detail for e in tail if e.event == "STREAM_FLUSH"]
    log(f"[stream] failing flush: cap={cap} failed_window="
        f"{flush[0]['failed_window'] if flush else None} placed="
        f"{[len(a) for a in per]} degrade={whys}")
    if per[:3] != want or per[3] or not flush \
            or flush[0]["failed_window"] != 3:
        raise AssertionError("[stream] failing flush: windows 0-2 != the "
                             "clean flush's, or window 3 bound")
    if not whys or "window 3" not in whys[0] or "change_cap" not in whys[0]:
        raise AssertionError(f"[stream] failing flush: degrade {whys}")
    if failing.solver.express_ready:
        raise AssertionError("[stream] failing flush: context still live")
    a, b = inf.ctx.dev, inf3.ctx.dev
    wa, wb = failing.solver._warm, clean.solver._warm
    for name, x, y in (("c", a.c, b.c), ("u", a.u, b.u), ("w", a.w, b.w),
                       ("s", a.s, b.s), ("valid", a.task_valid,
                                         b.task_valid),
                       ("asg", wa.asg, wb.asg), ("lvl", wa.lvl, wb.lvl),
                       ("floor", wa.floor, wb.floor)):
        if not torch.equal(x, y):
            raise AssertionError(f"[stream] failing flush: {name} != the "
                                 f"clean 3-window flush's")
    res = failing.run_scheduler()
    late = {x["uid"] for x in windows[3][0]}
    if not late <= set(res.bindings) or res.stats.express_degrades != 1:
        raise AssertionError("[stream] failing flush: window 3's pods did "
                             "not bind in the next round")
    log(f"[stream] failing flush: windows 0-2 bound as the clean flush's, "
        f"table and carry == the clean flush's, window 3's {len(late)} "
        f"pods bound by the next round (backend={res.stats.backend})")


def stream_parity() -> None:
    """A 3-window stream flush on the 64 x 600 parity cell, on the card
    and on the CPU: placements, window costs and rounds, and the carry,
    equal."""
    import numpy as np

    from poseidon_tpu_torch.synth import make_synthetic_cluster

    cluster = make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8)
    runs = {}
    for device in (DEVICE, "cpu"):
        bridge = express_bridge(device, cluster, 3)[0]
        rng = np.random.default_rng(78)
        windows = stream_schedule(bridge, rng, "par", [8, 8, 8])
        per, r, inf = stream_flush_windows(bridge, windows, "parity")
        if device == "cuda" and bridge.solver.last_stream_graph.get(
                "launches") != 1:
            raise AssertionError("[parity] stream flush: not one graph "
                                 "launch on the card")
        warm = bridge.solver.warm
        runs[device] = (per, r.cost, r.rounds,
                        [np.asarray(t.cpu()).tolist()
                         for t in (warm.asg, warm.lvl, warm.floor,
                                   inf.ctx.dev.s, inf.ctx.dev.u)])
    if runs[DEVICE] != runs["cpu"]:
        raise AssertionError("[parity] stream flush: card != cpu")
    log(f"[parity] stream flush of 3 windows: card == cpu (placed="
        f"{[len(a) for a in runs['cpu'][0]]} cost={runs['cpu'][1]} "
        f"rounds={runs['cpu'][2]})")


WHATIF_VARIANTS = 64


def whatif_phase(torch, card: str):
    """BASELINE config 5 (1,000 machines x 4,000 pods, quincy) as
    ``solve_what_if(n_variants=64, seed=7)`` on the card: every variant
    certified, variant 0 equal to the C++ oracle on the unperturbed
    instance, variants 1 and 63 equal to the CPU twins' solves of the
    same perturbed tables, one result fetch. Returns the launch counts
    of the call."""
    import numpy as np

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.guards import SyncCounter
    from poseidon_tpu_torch.ops import batch
    from poseidon_tpu_torch.ops.dense_auction import build_dense_instance
    from poseidon_tpu_torch.oracle import solve_oracle

    dev = torch.device(DEVICE)
    inst, net = perturb_instance(torch, dev)
    fetches, loops = SyncCounter(), SyncCounter()
    sync(torch)
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = batch.solve_what_if(inst, n_variants=WHATIF_VARIANTS, seed=7,
                              device=DEVICE, fetches=fetches,
                              loop_syncs=loops)
    sync(torch)
    total_ms = (time.perf_counter() - t0) * 1e3
    counts = {k.name: k.launches for k in kernels.KERNELS}
    want0 = solve_oracle(net, algorithm="cost_scaling").cost
    log(f"[whatif] card: {card}")
    log(f"[whatif] config 5: T={inst.n_tasks} M={inst.n_machines} "
        f"variants={WHATIF_VARIANTS} total_ms={total_ms:.3f} "
        f"per_variant_ms={total_ms / WHATIF_VARIANTS:.3f} "
        f"fetches={fetches.count} loop_syncs={loops.count} "
        f"rounds min/median/max={int(res.rounds.min())}/"
        f"{int(sorted(res.rounds)[WHATIF_VARIANTS // 2])}/"
        f"{int(res.rounds.max())} converged={int(res.converged.sum())} "
        f"cost0={int(res.costs[0])} oracle0={want0} launches={counts}")
    if not res.converged.all() or fetches.count != 1 or (
            loops.count != 0 and DEVICE == "cuda"):
        raise AssertionError(f"[whatif] {int(res.converged.sum())} of "
                             f"{WHATIF_VARIANTS} certified, "
                             f"{fetches.count} fetches, {loops.count} loop "
                             f"reads")
    if int(res.costs[0]) != want0:
        raise AssertionError(f"[whatif] variant 0 cost {res.costs[0]} != "
                             f"oracle {want0}")
    idle = [n for n in ("perturb", "densify", "row_options", "bid_pass")
            if counts[n] == 0 and DEVICE == "cuda"]
    if idle:
        raise AssertionError(f"[whatif] kernels not launched: {idle}")
    # the same perturbed tables, variants 1 and 63 solved by the twins
    d = build_dense_instance(inst, dev)
    if DEVICE == "cuda":
        # K6 as the what-if calls it (once, after the densify), timed by
        # CUDA events: a profiler session late in the run can record no
        # device activity. The card spins until the host has enqueued
        # the call, so the events hold the two launches' device time and
        # not the wrapper's host work (its output allocations and plan)
        a_ev = torch.cuda.Event(enable_timing=True)
        b_ev = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(4 * SLEEP_CYCLES)
        a_ev.record()
        c, u, w, dg, cm = batch.perturb_costs(d, WHATIF_VARIANTS, 7)
        b_ev.record()
        b_ev.synchronize()
        log(f"[whatif] perturb as called: {a_ev.elapsed_time(b_ev):.6f} ms "
            f"(device time, CUDA events around perturb_costs with the "
            f"card held busy until enqueued; L2 as the densify left it)")
    else:
        c, u, w, dg, cm = batch.perturb_costs(d, WHATIF_VARIANTS, 7)
    cpu = torch.device("cpu")
    s, tv = d.s.to(cpu), d.task_valid.to(cpu)
    for b in (1, WHATIF_VARIANTS - 1):
        t1 = time.perf_counter()
        cost, conv, asg, rounds = batch._solve_variant(
            c.to(cpu), u.to(cpu), w.to(cpu), dg.to(cpu), cm.to(cpu), b,
            s, tv, d.scale, smax=d.smax, alpha=1024, max_rounds=20_000,
        )
        T = inst.n_tasks
        a = asg.numpy()[:T]
        a = np.where((a >= 0) & (a < inst.n_machines), a, -1)
        same = (int(cost) // (T + 1) == int(res.costs[b]) and bool(conv)
                and rounds == int(res.rounds[b])
                and np.array_equal(a, res.assignments[b]))
        log(f"[whatif] variant {b}: card cost={int(res.costs[b])} "
            f"rounds={int(res.rounds[b])}; cpu twins cost="
            f"{int(cost) // (T + 1)} rounds={rounds} "
            f"({(time.perf_counter() - t1):.1f} s) equal={same}")
        if not same:
            raise AssertionError(f"[whatif] variant {b}: card != cpu")
    return counts


SERVICE_WARMUP_WAVES = 2
SERVICE_WAVES = 3


def service_tenants():
    """The ``[service]`` tenants at real size: (id, model, cluster,
    churned pods keep preferences)."""
    from poseidon_tpu_torch.synth import (
        config2_quincy_flagship, config5_whatif, make_synthetic_cluster,
    )

    # the trivial and random tenants carry no preference arcs: with them
    # neither package certifies within the 20,000-round fuse at these
    # sizes (ROADMAP Queue 3) and both degrade to the oracle
    return [
        ("flagship", "quincy", config2_quincy_flagship(seed=0), True),
        ("config5", "quincy", config5_whatif(seed=0), True),
        ("trivial", "trivial",
         make_synthetic_cluster(200, 2000, seed=5, prefs_per_task=0), False),
        ("random", "random",
         make_synthetic_cluster(64, 600, seed=6, prefs_per_task=0), False),
    ]


def service_churn(cluster, round_no: int, keep_prefs: bool):
    import dataclasses

    out = churn(cluster, round_no)
    if keep_prefs:
        return out
    return dataclasses.replace(out, tasks=[
        dataclasses.replace(t, data_prefs={}) for t in out.tasks])


def bound_cluster(cluster, bindings):
    """The cluster as the apiserver shows it once ``bindings`` landed:
    those pods running on their machines."""
    import dataclasses

    from poseidon_tpu_torch.cluster import TaskPhase

    return dataclasses.replace(cluster, tasks=[
        dataclasses.replace(t, phase=TaskPhase.RUNNING,
                            machine=bindings[t.uid])
        if t.uid in bindings else t
        for t in cluster.tasks
    ])


def service_phase(torch, card: str):
    """A ``SchedulingService`` on the card over four heterogeneous
    tenants at real size (the flagship, the config-5 cluster, a 200 x
    2,000 trivial tenant and a 64 x 600 random one: four shape buckets),
    2 warm-up waves and 3 measured waves with a seeded 1 % churn, each
    wave's bindings confirmed (the pods then run where they were
    placed). Per wave and tenant: placements equal a solo bridge's on
    the card fed the same observations, ``dense_service`` with its cost equal to the
    C++ oracle's on the tenant's priced graph; per wave: K1-K3 launched,
    one result fetch per dispatch chunk (plus one per cold retry); no
    kernel build and no new launch plan in the measured waves. Then the
    ``--serve`` front door through ``cli.main``. Returns the launch
    counts of the last measured wave."""
    import contextlib

    from poseidon_tpu_torch import cli, kernels
    from poseidon_tpu_torch.bridge import SchedulerBridge
    from poseidon_tpu_torch.graph.network import FlowNetwork
    from poseidon_tpu_torch.guards import CompileCounter
    from poseidon_tpu_torch.ops import dense_auction as da
    from poseidon_tpu_torch.oracle import solve_oracle
    from poseidon_tpu_torch.service import SchedulingService

    log(f"[service] card: {card}")
    service = SchedulingService(device=DEVICE)
    d = service.dispatcher
    tenants = service_tenants()
    clusters, solos = {}, {}
    for tid, model, cluster, _prefs in tenants:
        service.add_tenant(tid, cost_model=model)
        solos[tid] = SchedulerBridge(cost_model=model, small_to_oracle=False,
                                     device=DEVICE)
        clusters[tid] = cluster
    counter = CompileCounter()
    counts = {}
    for wave in range(SERVICE_WARMUP_WAVES + SERVICE_WAVES):
        measured = wave >= SERVICE_WARMUP_WAVES
        if wave:
            for tid, _model, _c, prefs in tenants:
                clusters[tid] = service_churn(clusters[tid], 50 + wave, prefs)
        for tid in clusters:
            for bridge in (service.sessions[tid].bridge, solos[tid]):
                bridge.observe_nodes(list(clusters[tid].machines))
                bridge.observe_pods(list(clusters[tid].tasks))
        before = (d.dispatches, d.fetches.count, d.cold_retries,
                  d.loop_syncs.count, da.CAPTURES.total)
        sync(torch)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with counter if measured else contextlib.nullcontext():
            futs = {tid: service.submit(tid) for tid in clusters}
            service.pump()
            service.flush()
            results = {tid: f.result(timeout=600) for tid, f in futs.items()}
            sync(torch)
        wave_ms = (time.perf_counter() - t0) * 1e3
        counts = {k.name: k.launches for k in kernels.KERNELS}
        chunks = d.dispatches - before[0]
        fetches = d.fetches.count - before[1]
        retries = d.cold_retries - before[2]
        log(f"[service] wave {wave}{' (warm-up)' if not measured else ''}: "
            f"wave_ms={wave_ms:.3f} chunks={chunks} fetches={fetches} "
            f"cold_retries={retries} loop_syncs="
            f"{d.loop_syncs.count - before[3]} builds="
            f"{counter.count if measured else '-'} loop_graph_captures="
            f"{da.CAPTURES.total - before[4]} launches={counts}")
        idle = [n for n in ROUND_KERNELS
                if counts[n] == 0 and DEVICE == "cuda"]
        loop_reads = d.loop_syncs.count - before[3]
        if idle or fetches != chunks + retries or chunks < 2 or (
                loop_reads != 0 and DEVICE == "cuda"):
            raise AssertionError(f"[service] wave {wave}: idle {idle}, "
                                 f"{fetches} fetches for {chunks} chunks "
                                 f"+ {retries} retries, {loop_reads} loop "
                                 f"reads")
        for tid, r in results.items():
            s = r.stats
            solver = service.sessions[tid].solver
            arrays = solver.last_arrays
            net = FlowNetwork.from_arrays(
                arrays["src"], arrays["dst"], arrays["cap"],
                solver.last_cost_host, arrays["supply"])
            want = solve_oracle(net, algorithm="cost_scaling").cost
            solo = solos[tid].run_scheduler()
            same = dict(solo.bindings) == dict(r.bindings)
            log(f"[service] wave {wave} {tid}: backend={s.backend} "
                f"placed={s.pods_placed} cost={s.cost} oracle={want} "
                f"solve_ms={s.solve_ms:.3f} total_ms={s.total_ms:.3f} "
                f"solo_backend={solo.stats.backend} solo_equal={same}")
            if s.backend != "dense_service" or s.cost != want or not same:
                raise AssertionError(f"[service] wave {wave} {tid}: "
                                     f"{s.backend}, cost {s.cost} vs oracle "
                                     f"{want}, solo equal {same}")
            # the driver's actuation: every binding lands, on both
            for uid, m in r.bindings.items():
                service.sessions[tid].bridge.confirm_binding(uid, m)
                solos[tid].confirm_binding(uid, m)
            clusters[tid] = bound_cluster(clusters[tid], r.bindings)
    if counter.count != 0:
        raise AssertionError(f"[service] {counter.count} kernel builds or "
                             f"new launch plans after warm-up")
    log(f"[service] measured waves: 0 kernel builds and 0 new launch plans")
    t0 = time.perf_counter()
    rc = cli.main(["--serve=true", "--serve_tenants=3", "--max_rounds=4",
                   f"--device={DEVICE}"])
    log(f"[service] cli --serve=true --serve_tenants=3 --max_rounds=4 "
        f"--device={DEVICE}: rc={rc} in {time.perf_counter() - t0:.3f} s")
    if rc != 0:
        raise AssertionError(f"[service] --serve exited {rc}")
    return counts


# rounds a daemon lane runs (4 and 3 until the [ha], [observe] and
# [chaos] phases took ~193 s more of the script's time: every check
# still runs on every round; the express lanes' bursts all land in the
# window after round 1)
DAEMON_ROUNDS = 3
EXPRESS_ROUNDS = 2


def fill_apiserver(server, cluster) -> None:
    """Load a synth cluster into the fake apiserver as k8s objects: cpu
    in millicores, memory in KiB, racks as node labels, slots as the
    node's pod capacity, data preferences (machines and racks) as the
    pod annotation. Pods' aging is bridge-internal and starts at 0."""
    for m in cluster.machines:
        server.add_node(
            m.name, cpu=f"{round(m.cpu_capacity * 1000)}m",
            memory=f"{m.memory_capacity_kb}Ki", pods=m.max_tasks,
            rack=m.rack, alloc_cpu=f"{round(m.cpu_allocatable * 1000)}m",
            alloc_memory=f"{m.memory_allocatable_kb}Ki",
        )
    for t in cluster.tasks:
        server.add_pod(
            t.uid, cpu=f"{round(t.cpu_request * 1000)}m",
            memory=f"{t.memory_request_kb}Ki", job=t.job,
            data_prefs=t.data_prefs or None,
        )


def check_apiserver_carries(client, cluster) -> None:
    """The bridge's view of the server equals the synth cluster, up to
    the namespaced names and the aging."""
    nodes = {m.name: m for m in client.all_nodes()}
    for m in cluster.machines:
        got = nodes[m.name]
        if (got.rack, got.max_tasks, got.cpu_capacity, got.cpu_allocatable,
                got.memory_capacity_kb, got.memory_allocatable_kb) != (
                m.rack, m.max_tasks, m.cpu_capacity, m.cpu_allocatable,
                m.memory_capacity_kb, m.memory_allocatable_kb):
            raise AssertionError(f"apiserver node {m.name}: {got} != {m}")
    pods = {p.uid: p for p in client.all_pods()}
    for t in cluster.tasks:
        got = pods[f"default/{t.uid}"]
        if (got.cpu_request, got.memory_request_kb, got.data_prefs,
                got.job) != (t.cpu_request, t.memory_request_kb,
                             t.data_prefs, f"default/{t.job}"):
            raise AssertionError(f"apiserver pod {t.uid}: {got} != {t}")


def daemon_churn(server, machines, round_no: int, keep,
                 fraction: float = 0.01):
    """Delete ``fraction`` of the server's pods and add as many new
    ones (shaped like the synth's), seeded by the round number. Pods in
    ``keep`` (placed by the round just finished, their POSTs not yet
    sent) are not deleted."""
    import numpy as np

    rng = np.random.default_rng(2000 + round_no)
    names = sorted(set(server.pods) - set(keep))
    k = max(int(len(names) * fraction), 1)
    for i in sorted(rng.choice(len(names), size=k, replace=False).tolist()):
        server.delete_pod(names[i])
    racks = sorted({m.rack for m in machines})
    for j in range(k):
        home = racks[int(rng.integers(0, len(racks)))]
        in_home = [m.name for m in machines if m.rack == home]
        prefs = {
            str(n): int(rng.integers(20, 200))
            for n in rng.choice(in_home, size=min(2, len(in_home)),
                                replace=False)
        }
        if rng.random() < 0.3:
            prefs[home] = int(rng.integers(10, 100))
        server.add_pod(
            f"pod-d{round_no}-{j:05d}", job=f"job-d{round_no}-{j // 8}",
            cpu=f"{int(rng.choice([100, 250, 500, 1000]))}m",
            memory=f"{int(rng.choice([1, 2, 8])) << 18}Ki",
            data_prefs=prefs,
        )


def daemon_burst(server, machines, burst_no: int, n: int = 16) -> list:
    """Add ``n`` seeded synth-shaped pods, each preferring one machine
    (a pod of one preference prices its preferred machine at 0, so
    quincy places it); returns their names."""
    import numpy as np

    rng = np.random.default_rng(3000 + burst_no)
    names = []
    for j in range(n):
        m = machines[int(rng.integers(0, len(machines)))]
        name = f"pod-x{burst_no}-{j:03d}"
        server.add_pod(
            name, job=f"job-x{burst_no}",
            cpu=f"{int(rng.choice([100, 250, 500, 1000]))}m",
            memory=f"{int(rng.choice([1, 2, 8])) << 18}Ki",
            data_prefs={m.name: int(rng.integers(20, 200))},
        )
        names.append(f"default/{name}")
    return names


# The daemon phase's apiserver runs in a process of its own, as a real
# apiserver would: in the daemon's process its handler threads would
# hold the interpreter lock the auction's host loop needs. It serves the
# flagship from the seed and answers one JSON command per stdin line.
APISERVER_CHILD = r"""
import json, sys
import chip_smoke
from poseidon_tpu_torch.apiclient import FakeApiServer
from poseidon_tpu_torch.synth import config2_quincy_flagship

cluster = (config2_quincy_flagship(seed=int(sys.argv[1]))
           if len(sys.argv) < 3 else chip_smoke.rehearsal_cluster())
with FakeApiServer() as server:
    chip_smoke.fill_apiserver(server, cluster)
    print(json.dumps(server.port), flush=True)
    for line in sys.stdin:
        cmd, arg = json.loads(line)
        if cmd == "rv":
            server.apply_pending()
            out = server.current_rv()
        elif cmd == "churn":
            chip_smoke.daemon_churn(server, cluster.machines, *arg)
            out = None
        elif cmd == "burst":
            out = chip_smoke.daemon_burst(server, cluster.machines, *arg)
        elif cmd == "op_log":
            server.apply_pending()
            out = [list(op) for op in server.op_log]
        elif cmd == "bound":
            server.apply_pending()
            out = {k: d.get("spec", {}).get("nodeName", "")
                   for k, d in server.pods.items()}
        else:
            break
        print(json.dumps(out), flush=True)
"""


class ApiServerProcess:
    """The fake apiserver in a child process (see APISERVER_CHILD)."""

    def __init__(self, seed: int, rehearsal: bool = False):
        import os
        import threading

        # the loop's watcher and the express lane's feeder both call
        self.lock = threading.Lock()
        root = os.path.dirname(os.path.abspath(__file__))
        self.proc = subprocess.Popen(
            [sys.executable, "-c", APISERVER_CHILD, str(seed),
             *(["rehearsal"] if rehearsal else [])], cwd=root,
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
        )
        line = self.proc.stdout.readline()
        if not line:
            self.close()
            raise RuntimeError("the apiserver process did not start")
        self.port = json.loads(line)

    def call(self, cmd: str, arg=None):
        with self.lock:
            self.proc.stdin.write(json.dumps([cmd, arg]) + "\n")
            self.proc.stdin.flush()
            line = self.proc.stdout.readline()
        if not line:
            raise RuntimeError(f"the apiserver process died ({cmd})")
        return json.loads(line)

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.write(json.dumps(["stop", None]) + "\n")
                self.proc.stdin.flush()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


EXPRESS_BURSTS = 3
# the [daemon] poll lane's first round (loop reads, cost), for [observe]
DAEMON_ROUND1: dict = {}
# the daemon's scale lane: poll over the flagship with the scale flags
SCALE_DAEMON_FLAGS = ("--aggregate_classes=true", "--topk_prefs=2",
                      "--mesh_width=1")
SCALE_DAEMON_ROUNDS = 3
EXPRESS_POLL_US = 12_000_000


def daemon_lane(torch, cluster, watch: bool, express: bool = False,
                stream_windows: int = 0, extra_args=(), n_rounds=None):
    """One daemon run over the fake apiserver: ``cli.run_loop`` on the
    card, pipelined rounds, incremental scheduler and build, 1 % churn
    between rounds. With ``express`` the loop watches with the express
    lane on (serial correction rounds, ``EXPRESS_POLL_US`` ticks, no
    shed), and after the first round the server adds ``EXPRESS_BURSTS``
    bursts of 16 pods, one every second, for the express windows; with
    ``stream_windows`` K > 1 those windows run as stream flushes.
    ``extra_args`` are more daemon flags, ``n_rounds`` overrides the
    lane's round count. Returns the
    per-dense-round records, the final bindings, the launch counts of
    the run and the express batches' records."""
    import logging
    import threading

    from poseidon_tpu_torch import cli, kernels
    from poseidon_tpu_torch.apiclient import K8sApiClient
    from poseidon_tpu_torch.apiclient import watch as watch_mod

    snaps = {}       # round_num -> (cluster view, knowledge vectors)
    posts = []       # (bindings POSTed, ms, landed, express) per batch
    records = []
    errors = []
    express_log = []  # (bindings, EXPRESS_PLACE events, degrade whys)

    class RecordingBridge(cli.SchedulerBridge):
        """Keeps each dense round's input view for the oracle check."""

        def begin_round(self):
            view = self.cluster_state()
            uids = [t.uid for t in view.pending()]
            names = [m.name for m in view.machines]
            know = (self.knowledge.task_cpu_usage(uids),
                    self.knowledge.machine_load(names),
                    self.knowledge.machine_mem_free(names))
            ir = super().begin_round()
            if ir.result is None:
                snaps[ir.stats.round_num] = (view, know)
            bridges.append(self)
            return ir

        def express_batch(self, pod_events, **kw):
            n0 = self.trace.dropped_total + len(self.trace.events)
            out = super().express_batch(pod_events, **kw)
            new = self.trace.dropped_total + len(self.trace.events) - n0
            tail = list(self.trace.events)[-new:] if new else []
            self.last_express = set(out.bindings) if out else set()
            express_log.append((
                dict(out.bindings) if out else {},
                sum(e.event == "EXPRESS_PLACE" for e in tail),
                [e.detail.get("why") for e in tail
                 if e.event == "EXPRESS_DEGRADE"],
            ))
            return out

        def stream_window(self, pod_events, **kw):
            n0 = self.trace.dropped_total + len(self.trace.events)
            ok = super().stream_window(pod_events, **kw)
            new = self.trace.dropped_total + len(self.trace.events) - n0
            tail = list(self.trace.events)[-new:] if new else []
            whys = [e.detail.get("why") for e in tail
                    if e.event == "EXPRESS_DEGRADE"]
            if whys:
                express_log.append(({}, 0, whys))
            return ok

        def stream_finish(self):
            n0 = self.trace.dropped_total + len(self.trace.events)
            out = super().stream_finish()
            new = self.trace.dropped_total + len(self.trace.events) - n0
            tail = list(self.trace.events)[-new:] if new else []
            self.last_express = set(out.bindings) if out else set()
            if new:
                express_log.append((
                    dict(out.bindings) if out else {},
                    sum(e.event == "EXPRESS_PLACE" for e in tail),
                    [e.detail.get("why") for e in tail
                     if e.event == "EXPRESS_DEGRADE"],
                ))
            return out

    bridges = []

    class ErrorLog(logging.Handler):
        def emit(self, record):
            errors.append(record.getMessage())

    post_bindings = cli._post_bindings

    def timed_post(client, bridge, bindings, **kw):
        t0 = time.perf_counter()
        out = post_bindings(client, bridge, bindings, **kw)
        xp = bool(bindings) and set(bindings) <= getattr(
            bridge, "last_express", set())
        posts.append((len(bindings), (time.perf_counter() - t0) * 1e3,
                      sum(o == "ok" for _, _, o in out), xp))
        return out

    server = ApiServerProcess(seed=0)
    try:
        check_apiserver_carries(K8sApiClient("127.0.0.1", server.port),
                                cluster)

        class CaughtUpWatcher(watch_mod.ClusterWatcher):
            """Each tick sees every event the server has made (the
            poll lane's view), as bench.py's watch cell does."""

            def tick(self):
                rv = server.call("rv")
                if self._seeded and not self.wait_caught_up(rv, 30.0):
                    raise AssertionError("watch events never arrived")
                return super().tick()

        launches_before = {}
        go = threading.Event()

        def feeder():
            # the express lane's arrivals: bursts between round ticks
            if not go.wait(300.0):
                return
            for b in range(EXPRESS_BURSTS):
                server.call("burst", [b])
                time.sleep(1.0)

        def hook(rounds, result):
            bridge = bridges[-1]
            now = {k.name: k.launches for k in kernels.KERNELS}
            launched = {n: now[n] - launches_before.get(n, 0) for n in now}
            launches_before.update(now)
            records.append(dict(
                round=result.stats.round_num, stats=result.stats,
                fetches=bridge.solver.last_round_fetches,
                solves=bridge.solver.last_round_solves,
                loop_syncs=bridge.solver.last_round_loop_syncs,
                auction_rounds=bridge.solver.last_round_auction_rounds,
                launched=launched, n_bindings=len(result.bindings),
            ))
            if express:
                go.set()
            elif rounds <= n_rounds - 2:
                server.call("churn", [rounds, list(result.bindings)])

        if n_rounds is None:
            n_rounds = EXPRESS_ROUNDS if express else DAEMON_ROUNDS
        args = cli.parse_args([
            "--k8s_apiserver_host=127.0.0.1",
            f"--k8s_apiserver_port={server.port}",
            "--device=cuda", "--flow_scheduling_cost_model=quincy",
            "--run_incremental_scheduler=true", "--incremental_build=true",
            "--round_pipeline=true",
            f"--watch={'true' if watch or express else 'false'}",
            f"--express_lane={'true' if express else 'false'}",
            # each round's binding POSTs come back as thousands of pod
            # watch events, past the default shed threshold (512): the
            # window would shed every burst to the tick
            f"--express_shed_queue={0 if express else 512}",
            f"--stream_windows={stream_windows}",
            f"--max_rounds={n_rounds}",
            f"--polling_frequency={EXPRESS_POLL_US if express else 1000}",
            *extra_args,
        ])
        feed = threading.Thread(target=feeder, daemon=True)
        stop = threading.Event()
        guard = threading.Timer(300.0, stop.set)
        handler = ErrorLog(level=logging.ERROR)
        cli_log = logging.getLogger("poseidon_tpu_torch.cli")
        bridge_log = logging.getLogger("poseidon_tpu_torch.bridge.bridge")
        bridge_level = bridge_log.level
        # one INFO line per placement would flood the log: 10,000 a round
        bridge_log.setLevel(logging.WARNING)
        cli_log.addHandler(handler)
        saved = (cli.SchedulerBridge, cli._post_bindings,
                 watch_mod.ClusterWatcher)
        cli.SchedulerBridge = RecordingBridge
        cli._post_bindings = timed_post
        watch_mod.ClusterWatcher = CaughtUpWatcher
        guard.start()
        if express:
            feed.start()
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        try:
            rc = cli.run_loop(args, stop_event=stop, round_hook=hook)
        finally:
            guard.cancel()
            go.set()
            if express:
                feed.join(timeout=60.0)
            (cli.SchedulerBridge, cli._post_bindings,
             watch_mod.ClusterWatcher) = saved
            cli_log.removeHandler(handler)
            bridge_log.setLevel(bridge_level)
        wall_s = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels.KERNELS}
        if rc != 0 or stop.is_set() or len(records) != n_rounds:
            raise AssertionError(
                f"daemon ({'watch' if watch else 'poll'}): rc={rc}, "
                f"{len(records)} of {n_rounds} rounds, "
                f"timed out={stop.is_set()}")
        if errors:
            raise AssertionError(f"daemon logged errors: {errors[:3]}")
        # every placement the daemon made is bound on the server, and
        # nothing else is
        pods = K8sApiClient("127.0.0.1", server.port).all_pods()
        bound = {p.uid: p.machine for p in pods if p.machine}
        placed = {u: t.machine for u, t in bridges[-1].tasks.items()
                  if t.machine}
        if bound != placed:
            raise AssertionError(
                f"server bindings ({len(bound)}) != the daemon's "
                f"placements ({len(placed)})")
    finally:
        server.close()
    return records, snaps, posts, bound, launches, wall_s, express_log


def daemon_phase(torch, card: str):
    """The scheduling daemon end to end on the card: the port's CLI loop
    against the fake apiserver, poll lane then watch lane. ``card`` is
    the nvidia-smi name and power limit, printed beside the timers."""
    import numpy as np

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import build_cost_inputs, quincy_cost
    from poseidon_tpu_torch.oracle import solve_oracle
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    cluster = config2_quincy_flagship(seed=0)
    log(f"[daemon] card: {card}")
    lanes = {}
    for lane in ("poll", "watch", "express", "stream", "scale"):
        (records, snaps, posts, bound, launches, wall_s,
         express_log) = daemon_lane(
            torch, cluster, watch=lane == "watch",
            express=lane in ("express", "stream"),
            stream_windows=STREAM_WINDOWS if lane == "stream" else 0,
            extra_args=SCALE_DAEMON_FLAGS if lane == "scale" else (),
            n_rounds=SCALE_DAEMON_ROUNDS if lane == "scale" else None)
        dense = [r for r in records if r["round"] in snaps]
        if len(dense) < 2:
            raise AssertionError(f"[daemon] {lane}: {len(dense)} dense rounds")
        nonempty_posts = [p[:3] for p in posts if p[0] and not p[3]]
        for i, r in enumerate(dense):
            s = r["stats"]
            view, (usage, load, mem_free) = snaps[r["round"]]
            pending = view.pending()
            net, meta = FlowGraphBuilder().build(view)
            inputs = build_cost_inputs(
                net, meta, device=torch.device("cuda"),
                task_cpu_milli=np.array(
                    [int(t.cpu_request * 1000) for t in pending]),
                task_mem_kb=np.array([t.memory_request_kb for t in pending]),
                task_usage=usage, machine_load=load, machine_mem_free=mem_free,
            )
            if lane == "scale":
                # --topk_prefs=2: the optimum of the graph with each
                # task's preference arcs cut to its two heaviest
                want = pruned_oracle_cost(view, dict(
                    task_cpu_milli=np.array(
                        [int(t.cpu_request * 1000) for t in pending]),
                    task_mem_kb=np.array(
                        [t.memory_request_kb for t in pending]),
                    task_usage=usage, machine_load=load,
                    machine_mem_free=mem_free,
                ), 2, torch.device("cuda"))
            else:
                want = solve_oracle(net.with_costs(quincy_cost(inputs)),
                                    algorithm="cost_scaling").cost
            post_n, post_ms, post_ok = (nonempty_posts[i] if i < len(
                nonempty_posts) else (0, 0.0, 0))
            log(f"[daemon] {lane} round {s.round_num}: "
                f"pending={s.pods_pending} placed={s.pods_placed} "
                f"unsched={s.pods_unscheduled} build={s.build_mode} "
                f"observe_ms={s.observe_ms:.3f} build_ms={s.build_ms:.3f} "
                f"dispatch_ms={s.dispatch_ms:.3f} solve_ms={s.solve_ms:.3f} "
                f"fetch_wait_ms={s.fetch_wait_ms:.3f} "
                f"overlap_ms={s.overlap_ms:.3f} total_ms={s.total_ms:.3f} "
                f"wall_ms={s.wall_ms:.3f} post_ms={post_ms:.3f} "
                f"posts={post_ok}/{post_n} bind_failures={s.bind_failures} "
                f"backend={s.backend} cost={s.cost} oracle_cost={want} "
                f"solves={r['solves']} fetches={r['fetches']} "
                f"loop_syncs={r['loop_syncs']} "
                f"auction_rounds={r['auction_rounds']} "
                f"launches={r['launched']}")
            if s.backend != "dense_auction":
                raise AssertionError(f"[daemon] {lane} round {s.round_num}: "
                                     f"backend {s.backend}")
            if s.cost != want:
                raise AssertionError(f"[daemon] {lane} round {s.round_num}: "
                                     f"cost {s.cost} != oracle {want}")
            # one result fetch per auction solve; a warm round whose
            # stale start did not certify re-runs cold (a second solve),
            # as the reference does
            if r["fetches"] != r["solves"] or (i == 0 and r["solves"] != 1):
                raise AssertionError(f"[daemon] {lane} round {s.round_num}: "
                                     f"{r['fetches']} result fetches for "
                                     f"{r['solves']} solves")
            # pods deleted while the round was in flight are neither
            # placed nor aged (the bridge drops stale decisions)
            if (s.pods_placed + s.pods_unscheduled > s.pods_pending
                    or post_ok != post_n or post_n != s.pods_placed):
                raise AssertionError(
                    f"[daemon] {lane} round {s.round_num}: pending "
                    f"{s.pods_pending} < placed {s.pods_placed} + unsched "
                    f"{s.pods_unscheduled}, or {post_ok} of {post_n} POSTs "
                    f"landed")
            idle = [n for n in (SCALE_KERNELS if lane == "scale"
                                else ROUND_KERNELS)
                    if r["launched"][n] == 0]
            if idle:
                raise AssertionError(f"[daemon] {lane} round {s.round_num}: "
                                     f"kernels not launched: {idle}")
        if lane == "poll":
            # [observe] holds its first round (the same cold flagship
            # round, with the observability tools on) against this one
            DAEMON_ROUND1["poll"] = (dense[0]["auction_rounds"],
                                     dense[0]["stats"].cost)
        log(f"[daemon] {lane}: {len(records)} rounds ({len(dense)} dense) "
            f"in {wall_s:.3f} s, {len(bound)} pods bound, "
            f"launches={launches}")
        if lane in ("express", "stream"):
            express_daemon_checks(records, posts, bound, express_log, lane)
        lanes[lane] = bound
    if lanes["poll"] != lanes["watch"]:
        diff = sum(lanes["poll"].get(u) != m for u, m in lanes["watch"].items())
        raise AssertionError(f"[daemon] watch lane bindings differ from the "
                             f"poll lane's ({diff} pods)")
    log(f"[daemon] watch lane bindings == poll lane bindings "
        f"({len(lanes['poll'])} pods)")


def express_daemon_checks(records, posts, bound, express_log,
                          lane: str = "express") -> None:
    """The daemon's express lane: every express binding's POST landed
    and the server binds the pod where express placed it, each
    placement traced as EXPRESS_PLACE, and every degrade printed with
    its reason (none expected)."""
    placed = {}
    for bindings, _places, _whys in express_log:
        placed.update(bindings)
    xposts = [p for p in posts if p[3]]
    n_post = sum(p[0] for p in xposts)
    n_ok = sum(p[2] for p in xposts)
    n_events = sum(e[1] for e in express_log)
    whys = [w for e in express_log for w in e[2]]
    degrades = sum(r["stats"].express_degrades for r in records)
    wrong = {u: (m, bound.get(u)) for u, m in placed.items()
             if bound.get(u) != m}
    log(f"[daemon] {lane}: batches={sum(1 for e in express_log if e[0])} "
        f"of {len(express_log)} calls, placements={len(placed)}, "
        f"EXPRESS_PLACE events={n_events}, POSTs landed={n_ok}/{n_post} "
        f"(batches of {[p[0] for p in xposts]}, "
        f"ms={[round(p[1], 3) for p in xposts]}), "
        f"express_degrades={degrades}, e2b_p50_ms="
        f"{[r['stats'].express_e2b_p50_ms for r in records]}")
    for why in whys:
        log(f"[daemon] {lane} degrade: {why}")
    if not placed or n_events != len(placed):
        raise AssertionError(f"[daemon] express: {len(placed)} placements, "
                             f"{n_events} EXPRESS_PLACE events")
    if n_ok != n_post or n_post != len(placed):
        raise AssertionError(f"[daemon] express: {n_ok} of {n_post} POSTs "
                             f"landed for {len(placed)} placements")
    if wrong:
        raise AssertionError(f"[daemon] express placements not bound as "
                             f"placed: {list(wrong.items())[:4]}")
    if degrades != len(whys):
        raise AssertionError(f"[daemon] express: {degrades} degrades, "
                             f"{len(whys)} with a reason")


# ---- K8 gap_rows, and the shard offsets of K3 and K7 ----------------

# config 8's aggregated table as its rounds solve it (BASELINE config 8
# through the scale lane: 524,288 pods over 256 machine classes, one per
# rack and SKU)
CONFIG8_TABLE = (524288, 256)


def gap_rows_inputs(torch, seed: int, rows: int, Mp: int, kind: str = "rand"):
    """One row block's K8 inputs, made on the device from a seed
    (``kernel_ab.gap_args``: a table with ~5 % INF entries, holders'
    prices ``lam`` and seats, and an ``asg`` that reaches every class:
    a machine, the unscheduled route Mp, -1 and out of range). ``kind``
    "invalid" clears task_valid, "lam_inf" sets every price to INF,
    "full_inf" the whole table and every price."""
    from kernel_ab import gap_args

    inf = 2**29
    c, u, valid, s, lam, asg = gap_args(torch, torch.device(DEVICE), rows,
                                        Mp, seed)
    if kind == "invalid":
        valid.zero_()
    if kind in ("lam_inf", "full_inf"):
        lam.fill_(inf)
    if kind == "full_inf":
        c.fill_(inf)
    return c, u, valid, s, lam, asg


def gap_rows_bytes_ops(rows: int, Mp: int) -> tuple[int, int]:
    """K8's bytes (table, u/asg/task_valid per row, s/lam per column,
    the two int64 sums) and int32 operations (add, two mins per entry;
    a few per row)."""
    return (rows * Mp * 4 + rows * 9 + Mp * 8 + 16,
            rows * Mp * 3 + rows * 8)


def gap_rows_record(torch, timer):
    """K8 at config 8's aggregated table [524288, 256] (the scale lane's
    shape), at the flagship's [10240, 1024] and at its width-2 and
    width-4 shards [5120, 1024] and [2560, 1024], held against its twin
    (tolerance 0) and timed cold, each with its plan and the yardstick
    ``c.amin()`` (one PyTorch read of the same table; no single PyTorch
    call computes K8's function); the record is config 8's."""
    from poseidon_tpu_torch.kernels import gap_rows as k8

    out = None
    for rows, Mp in ((10240, 1024), (5120, 1024), (2560, 1024),
                     CONFIG8_TABLE):
        args = gap_rows_inputs(torch, rows + Mp, rows, Mp)
        err = max_abs_err([k8.gap_rows(*args)], [k8.gap_rows_plain(*args)])
        ms = timer(lambda: k8.gap_rows(*args))
        plain = timer(lambda: k8.gap_rows_plain(*args))
        floor = timer(lambda: args[0].amin())
        bms, by = bound_ms(*gap_rows_bytes_ops(rows, Mp))
        plan = k8.PLANS[(args[0].device, rows, Mp)]
        log(f"[kernels] gap_rows shape=({rows}, {Mp}) max_abs_err={err} "
            f"ms={ms:.6f} plain_ms={plain:.6f} bound_ms={bms:.6f} ({by}) "
            f"share={bms / ms:.3f} read_floor_ms={floor:.6f} (c.amin(), a "
            f"yardstick) plan={plan}")
        if err:
            raise AssertionError(f"[kernels] gap_rows ({rows}, {Mp}) != twin")
        if (rows, Mp) == CONFIG8_TABLE:
            out = (k8.KERNEL, err, ms, plain, bms, by, (rows, Mp))
        del args
    return out


def shard_edges(torch) -> None:
    """K8 against its twin at its edges (Mp 16, 128, 1024 and 1040; 1,
    31 and 32,769 rows; every asg class; task_valid all false; every
    price INF), K3 over a shard's rows at a task offset (equal to its
    twin and to the whole table's pass), and K7's commit into shard 0
    and restore into shard 1 of a two-shard table, live and dead."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bid_pass as k3
    from poseidon_tpu_torch.kernels import gap_rows as k8
    from poseidon_tpu_torch.kernels import stream_commit as k7

    bad = []
    n = 0
    # the plan's edges: 1 row; rows not a multiple of the warps a block
    # (7, 31, 32,769), of a wave's warps (10,241) or of the rows a lane
    # loads at once (4 at Mp 16 and 128, 2 at 256); Mp above the staged
    # prices (8,196) and at their limit (8,192)
    for Mp in (16, 128, 256, 1024, 1040, 8192, 8196):
        for rows in (1, 7, 31, 10241, 32769):
            for kind in ("rand", "invalid", "lam_inf", "full_inf"):
                if kind != "rand" and rows != 31:
                    continue
                if Mp > 1040 and rows > 31:
                    continue
                args = gap_rows_inputs(torch, rows * 7 + Mp, rows, Mp, kind)
                err = max_abs_err([k8.gap_rows(*args)],
                                  [k8.gap_rows_plain(*args)])
                n += 1
                if err:
                    bad.append(("gap_rows", rows, Mp, kind, err))
    rng = np.random.default_rng(53)
    for Tp, Mp, r0, r1 in ((10240, 1024, 5120, 10240), (64, 16, 16, 48),
                           (2048, 128, 1024, 1536)):
        c, p = edge_tables(torch, rng, Tp, Mp, "tied")
        u = torch.from_numpy(rng.integers(0, 6000, Tp).astype(np.int32)).to(
            DEVICE)
        bt = torch.from_numpy(rng.integers(r0, r1, 256).astype(np.int32)).to(
            DEVICE)
        ok = torch.from_numpy(rng.random(256) < 0.8).to(DEVICE)
        eps2 = torch.full((), 2, dtype=torch.int32, device=DEVICE)
        part = (c[r0:r1].contiguous(), p, u[r0:r1].contiguous(), bt - r0, ok,
                eps2)
        got = k3.bid_pass(*part, task0=r0)
        err = max(max_abs_err(got, k3.bid_pass_plain(*part, task0=r0)),
                  max_abs_err(got, k3.bid_pass(c, p, u, bt, ok, eps2)))
        n += 1
        if err:
            bad.append(("bid_pass task0", Tp, Mp, r0, err))
    # K7 over two shards (the per-row cost, the commit into shard 0,
    # the restore of shard 1), live and dead; at 64 x 1028 and at the
    # flagship with shard 1 owning every arrival row
    for Tp, Mp, r0, live, owned in ((64, 1028, 32, True, False),
                                    (64, 1028, 32, False, False),
                                    (10240, 1024, 5120, True, True),
                                    (10240, 1024, 5120, False, True)):
        x = stream_commit_inputs(torch, rng, Tp, Mp, 16, 8, live=live,
                                 nrep=6)
        if owned:
            x["add_row"].copy_(torch.arange(Tp - 16, Tp, dtype=torch.int32,
                                            device=DEVICE))
        for commit in (True, False):
            n += 1
            err = stream_commit_check(torch, x, 8, commit, split=r0)
            if err:
                bad.append(("stream_commit shards", Tp, live, commit, err))
    log(f"[edges] gap_rows, bid_pass at a task offset, stream_commit over "
        f"two shards: {n} cases, {len(bad)} differ")
    if bad:
        raise AssertionError(f"[edges] shard kernels != twins: {bad[:4]}")


# ---- the scale lane -------------------------------------------------

CONFIG8 = (65_536, 524_288)      # BASELINE config 8: machines, pods
CONFIG8_RACK = 512               # machines a rack (synth.config8_scale)
CONFIG8_CHURN = 16_384           # arrivals and deletions a churn round
CONFIG8_ROUNDS = 3               # churn rounds after the cold burst
SCALE_WIDTHS = (1, 2, 4)         # mesh widths, every shard on one card
SCALE_REPEATS = 5                # flagship cold + warm pairs per width
SCALE_KERNELS = ROUND_KERNELS + ("gap_rows",)


def mesh_devices(torch, width: int) -> list:
    """``width`` shards, all on the card the script runs on."""
    return [torch.device(DEVICE, 0) if DEVICE == "cuda"
            else torch.device(DEVICE)] * width


def scale_config8(torch) -> dict:
    """Config 8 through the port's bridge on the card: aggregation,
    top-2 preferences, a width-1 mesh, no oracle fallback; the cold
    burst round, then churn rounds of 16,384 arrivals and as many
    deletions, bindings confirmed. Launch counts are zeroed just before
    the first round and read after the last churn round; one more churn
    round runs under torch.profiler. Returns the launch counts."""
    import logging

    # one INFO line per placement (the daemon phase turns INFO on)
    # would be half a million lines a burst round
    bridge_log = logging.getLogger("poseidon_tpu_torch.bridge.bridge")
    level = bridge_log.level
    bridge_log.setLevel(logging.WARNING)
    try:
        return _scale_config8(torch)
    finally:
        bridge_log.setLevel(level)


def _scale_config8(torch) -> dict:
    import collections

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.bridge import SchedulerBridge
    from poseidon_tpu_torch.ops import dense_auction as da
    from poseidon_tpu_torch.synth import config8_arrivals, config8_scale

    n_machines, n_tasks = CONFIG8
    t0 = time.perf_counter()
    cluster = config8_scale(n_machines, n_tasks, seed=0,
                            machines_per_rack=CONFIG8_RACK, n_skus=2)
    n_racks = len(cluster.racks())
    log(f"[scale] config 8: {n_machines} machines x {n_tasks} pods, "
        f"{n_racks} racks, built in {time.perf_counter() - t0:.3f} s")
    bridge = SchedulerBridge(
        cost_model="quincy", small_to_oracle=False, aggregate_classes=True,
        topk_prefs=2, mesh_width=1, device=DEVICE,
    )
    # a degrade at this scale must fail the phase, not sit in a CPU solve
    bridge.solver.oracle_fallback = False
    solver = bridge.solver
    outcomes = []
    finish = solver.finish_round

    def recording_finish(inflight):
        out = finish(inflight)
        outcomes.append(out)
        return out

    solver.finish_round = recording_finish
    t0 = time.perf_counter()
    bridge.observe_nodes(cluster.machines)
    bridge.observe_pods(cluster.tasks)
    log(f"[scale] observe {time.perf_counter() - t0:.3f} s; "
        f"round flags {bridge.round_flags}")
    alive = collections.deque()

    def one_round(r, label):
        n_cap = da.CAPTURES.total
        if r > 0:
            t0 = time.perf_counter()
            for t in config8_arrivals(n_racks, CONFIG8_CHURN, r - 1, seed=0):
                bridge.observe_pod_event("ADDED", t)
            for _ in range(min(CONFIG8_CHURN, len(alive))):
                bridge.observe_pod_event("DELETED",
                                         bridge.tasks[alive.popleft()])
            events_ms = (time.perf_counter() - t0) * 1e3
        else:
            events_ms = 0.0
        sync(torch)
        t0 = time.perf_counter()
        res = bridge.run_scheduler()
        sync(torch)
        wall = (time.perf_counter() - t0) * 1e3
        t1 = time.perf_counter()
        for uid, m in res.bindings.items():
            bridge.confirm_binding(uid, m)
        confirm_ms = (time.perf_counter() - t1) * 1e3
        alive.extend(res.bindings)
        out = outcomes[-1]
        s = res.stats
        Tp, Mp = solver.pad_floors["t"], solver.pad_floors["m"]
        peak = (torch.cuda.max_memory_allocated() / 2**20
                if DEVICE == "cuda" else 0.0)
        log(f"[scale] config 8 {label}: pending={s.pods_pending} "
            f"placed={s.pods_placed} unsched={s.pods_unscheduled} "
            f"wall_ms={wall:.3f} prep_ms={out.timings['prep_ms']:.3f} "
            f"upload_ms={out.timings['upload_ms']:.3f} "
            f"solve_ms={out.timings['solve_ms']:.3f} "
            f"build_ms={s.build_ms:.3f} events_ms={events_ms:.3f} "
            f"confirm_ms={confirm_ms:.3f} backend={s.backend} "
            f"converged={out.converged} rounds={out.rounds} "
            f"phases={out.phases} solves={solver.last_round_solves} "
            f"fetches={solver.last_round_fetches} "
            f"loop_syncs={solver.last_round_loop_syncs} Tp={Tp} Mp={Mp} "
            f"loop_graph_captures={da.CAPTURES.total - n_cap} capture_ms="
            f"{sum(c[-1] for c in da.CAPTURES.since(n_cap)):.3f} "
            f"classes={solver.last_round_classes} "
            f"table_mib={Tp * Mp * 4 / 2**20:.1f} "
            f"max_memory_allocated_mib={peak:.1f} cost={s.cost}")
        if solver.last_round_solves > 1:
            log(f"[scale] config 8 {label}: the stale warm start did not "
                f"certify; the round re-ran cold (both packages do)")
        if s.backend != "dense_auction" or not out.converged:
            raise AssertionError(f"[scale] config 8 {label}: {s.backend}")
        if solver.last_round_fetches != solver.last_round_solves:
            raise AssertionError(
                f"[scale] config 8 {label}: {solver.last_round_fetches} "
                f"fetches for {solver.last_round_solves} solves")
        if s.degrades_total:
            raise AssertionError(f"[scale] config 8 {label}: degraded")

    sync(torch)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    one_round(0, "burst round")
    for r in range(1, CONFIG8_ROUNDS + 1):
        one_round(r, f"churn round {r}")
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"[scale] config 8 launches={launches}")
    idle = [n for n in SCALE_KERNELS if launches[n] == 0]
    if idle and DEVICE == "cuda":
        raise AssertionError(f"[scale] config 8: not launched: {idle}")
    if DEVICE == "cuda":
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            one_round(CONFIG8_ROUNDS + 1, "profiled churn round")
            wall_us = (time.perf_counter() - t0) * 1e6
        rows = device_rows(prof)
        busy = sum(t for _, t, _ in rows)
        log(f"[scale] config 8 profiled churn round: wall_us={wall_us:.1f} "
            f"device_busy_us={busy:.1f} "
            f"idle_share={1 - min(busy / wall_us, 1):.3f}")
        rows.sort(key=lambda r: -r[1])
        for key, t, n in rows[:12]:
            log(f"[scale]   {t:10.1f} us  x{n:<5d} {key[:90]}")
        # the hand kernels as the round calls them
        for k in KERNEL_SYMBOLS + ("gap_rows_kernel",):
            hits = [(t, n) for key, t, n in rows if k in key]
            total = sum(t for t, _ in hits)
            count = sum(n for _, n in hits)
            log(f"[scale] kernel {k}: total_us={total:.1f} launches={count} "
                f"us_per_launch={total / max(count, 1):.3f}")
    return launches


def _recording_fetch(fetch, fetched: list):
    """``ops.resident._fetch_result`` that also appends each round's
    fetched host result (asg, channels, chosen/alt, lvl, floor, primal)
    to ``fetched``, for the width comparisons."""
    def call(*args, **kw):
        out = fetch(*args, **kw)
        fetched.append(out)
        return out
    return call


def flagship_round_record(solver, out, fetched: list) -> tuple:
    """Every integer output of a round: the fetched asg, channels,
    chosen/alt, lvl, floor and primal (the last ``_fetch_result``), the
    outcome's assignment, cost, rounds and phases, and the certificate's
    gap."""
    f = fetched[-1]
    return (out.backend, out.cost, out.rounds, out.phases,
            out.assignment.tolist(), f.asg.tolist(), f.ch.tolist(),
            f.chosen.tolist(), f.alt.tolist(), f.lvl.tolist(),
            f.floor.tolist(), f.primal, int(solver.warm.gap))


def scale_widths(torch) -> None:
    """Exactness and widths: the downsampled config 8 instance at widths
    1, 2 and 4 (every shard on the card) equal to each other and to the
    C++ oracle; the flagship plain vs widths 1, 2 and 4 over a cold and
    a warm round, every integer output equal, with each width's wall
    time; K8 as those rounds call it at each width; the aggregated
    flagship's cost equal to the plain one's; and
    ``sharded_certificate_gap`` at width 4 equal to the solve's gap."""
    from poseidon_tpu_torch.ops import resident

    fetch = resident._fetch_result
    fetched = []
    resident._fetch_result = _recording_fetch(fetch, fetched)
    try:
        _scale_widths(torch, fetched)
    finally:
        resident._fetch_result = fetch


def _scale_widths(torch, fetched: list) -> None:
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import (
        build_cost_inputs, get_cost_model,
    )
    from poseidon_tpu_torch.ops.dense_auction import build_dense_instance
    from poseidon_tpu_torch.ops.resident import ResidentSolver
    from poseidon_tpu_torch.ops.transport import extract_instance
    from poseidon_tpu_torch.parallel import (
        make_mesh, shard_instance, sharded_certificate_gap,
        solve_dense_sharded,
    )
    from poseidon_tpu_torch.synth import config2_quincy_flagship, config8_scale

    dev = torch.device(DEVICE)
    small = config8_scale(256, 2048, seed=1, machines_per_rack=32, n_skus=2)
    arrays, meta = FlowGraphBuilder().build_arrays(small)
    want, _ = oracle_cost(small, dev)
    seen = None
    for w in SCALE_WIDTHS:
        solver = ResidentSolver(
            device=DEVICE, small_to_oracle=False, aggregate_classes=True,
            topk_prefs=2, mesh_width=w, mesh_devices=mesh_devices(torch, w))
        out = solver.run_round(arrays, meta, cost_model="quincy",
                               cost_input_kwargs=cost_kwargs(small))
        rec = flagship_round_record(solver, out, fetched)
        log(f"[scale] downsampled config 8 (256 x 2048) width {w}: "
            f"backend={out.backend} cost={out.cost} oracle_cost={want} "
            f"rounds={out.rounds} classes={solver.last_round_classes}")
        if out.backend != "dense_auction" or out.cost != want:
            raise AssertionError(f"[scale] downsampled width {w}: "
                                 f"{out.backend} cost {out.cost} != {want}")
        if seen is not None and rec != seen:
            raise AssertionError(f"[scale] downsampled width {w} != width 1")
        seen = rec

    clusters = [config2_quincy_flagship(seed=0)]
    clusters.append(churn(clusters[0], 1))
    built = [FlowGraphBuilder().build_arrays(c) for c in clusters]
    base = None
    # each width runs the cold + warm pair SCALE_REPEATS times in turns
    # (0, 1, 2, 4, 0, 1, ...), each time on a fresh solver; the medians
    # of the walls compare the widths within this run
    walls = {w: ([], []) for w in (0,) + SCALE_WIDTHS}
    for _rep in range(SCALE_REPEATS):
        for w in (0,) + SCALE_WIDTHS:
            solver = ResidentSolver(
                device=DEVICE, small_to_oracle=False, mesh_width=w,
                mesh_devices=mesh_devices(torch, w) if w else None)
            recs = []
            for k, (cluster, (arrays, meta)) in enumerate(zip(clusters,
                                                              built)):
                sync(torch)
                t0 = time.perf_counter()
                out = solver.run_round(
                    arrays, meta, cost_model="quincy",
                    cost_input_kwargs=cost_kwargs(cluster))
                sync(torch)
                walls[w][k].append((time.perf_counter() - t0) * 1e3)
                recs.append(flagship_round_record(solver, out, fetched))
            if base is None:
                base = recs
            elif recs != base:
                raise AssertionError(f"[scale] flagship width {w} != plain")
    for w, (cold, warm) in walls.items():
        med = [sorted(x)[len(x) // 2] for x in (cold, warm)]
        log(f"[scale] flagship width {w}: cold wall_ms median {med[0]:.3f} "
            f"{[round(x, 3) for x in cold]} warm wall_ms median "
            f"{med[1]:.3f} {[round(x, 3) for x in warm]} "
            f"cost={base[0][1]}/{base[1][1]} "
            f"rounds={base[0][2]}/{base[1][2]} gap={base[0][-1]}/"
            f"{base[1][-1]} (every integer output equal to plain)")
    if DEVICE == "cuda":
        scale_gap_as_called(torch, clusters, built)
    agg = ResidentSolver(device=DEVICE, small_to_oracle=False,
                         aggregate_classes=True)
    out = agg.run_round(*built[0], cost_model="quincy",
                        cost_input_kwargs=cost_kwargs(clusters[0]))
    log(f"[scale] aggregated flagship: cost={out.cost} plain={base[0][1]} "
        f"classes={agg.last_round_classes}")
    if out.cost != base[0][1]:
        raise AssertionError("[scale] aggregated flagship cost != plain")

    net, meta = FlowGraphBuilder().build(clusters[0])
    inputs = build_cost_inputs(net, meta, device=dev,
                               **cost_kwargs(clusters[0]))
    inst = extract_instance(
        net.with_costs(get_cost_model("quincy")(inputs)), meta)
    mesh = make_mesh(devices=mesh_devices(torch, 4))
    sdev = shard_instance(build_dense_instance(inst, dev), mesh)
    state = solve_dense_sharded(sdev)
    gap = sharded_certificate_gap(sdev, state, mesh)
    log(f"[scale] sharded_certificate_gap width 4: {gap} (solve's gap "
        f"{int(state.gap)}, converged={bool(state.converged)})")
    if gap != int(state.gap) or not bool(state.converged):
        raise AssertionError("[scale] sharded certificate != solve's gap")


def scale_gap_as_called(torch, clusters, built) -> None:
    """K8 as the flagship's rounds call it at mesh widths 1, 2 and 4 (one
    launch a shard at each certificate): a cold round, then a warm one
    under torch.profiler, its K8 device time a launch. The table was
    just read by the round's K2/K3 and may sit in the 50 MB L2, so the
    time is an as-called one, not a cold one."""
    from torch.profiler import ProfilerActivity, profile

    from poseidon_tpu_torch.kernels import gap_rows
    from poseidon_tpu_torch.ops.resident import ResidentSolver

    for w in SCALE_WIDTHS:
        solver = ResidentSolver(
            device=DEVICE, small_to_oracle=False, mesh_width=w,
            mesh_devices=mesh_devices(torch, w))
        for k, (cluster, (arrays, meta)) in enumerate(zip(clusters, built)):
            # the launch counter says whether the round launched K8 (one
            # launch a shard); the profiler gives its device time, and a
            # round whose launches it did not capture is profiled again
            # (the next round is warm too), at most twice more
            for attempt in range(3):
                sync(torch)
                before = gap_rows.KERNEL.launches
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    solver.run_round(arrays, meta, cost_model="quincy",
                                     cost_input_kwargs=cost_kwargs(cluster))
                    sync(torch)
                launched = gap_rows.KERNEL.launches - before
                hits = [(t, n) for key, t, n in device_rows(prof)
                        if "gap_rows_kernel" in key]
                total = sum(t for t, _ in hits)
                count = sum(n for _, n in hits)
                Tp = solver.pad_floors["t"]
                log(f"[scale] flagship width {w} {('cold', 'warm')[k]} "
                    f"round: gap_rows as called: launches={launched} "
                    f"captured={count} "
                    f"us_per_launch={total / max(count, 1):.3f} "
                    f"shard=({Tp // w}, {solver.pad_floors['m']})")
                if launched < w:
                    raise AssertionError(f"[scale] width {w}: {launched} "
                                         f"gap_rows launches for {w} shards")
                if count:
                    break
            if not count:
                raise AssertionError(f"[scale] width {w}: the profiler "
                                     f"captured no gap_rows launch")


def scale_phase(torch, card: str) -> dict:
    """The scale lane on the card: the unaggregated config 8 table is
    refused by the budget guard; config 8 end to end; exactness and
    mesh widths. Returns config 8's launch counts."""
    from poseidon_tpu_torch.ops.dense_auction import (
        DenseMemoryTooLarge, check_table_budget,
    )

    log(f"[scale] card: {card}")
    try:
        check_table_budget(CONFIG8[1], CONFIG8[0])
    except DenseMemoryTooLarge as e:
        log(f"[scale] unaggregated config 8 refused: {str(e)[:160]}")
    else:
        raise AssertionError("[scale] the unaggregated table was accepted")
    launches = scale_config8(torch)
    scale_widths(torch)
    return launches


def scale_parity() -> None:
    """An aggregated width-2 round on the 64 x 600 parity cell (both
    shards on one device), two express windows and a 3-window stream
    flush over it, on the card and on the CPU: every field equal."""
    import numpy as np
    import torch

    from poseidon_tpu_torch.synth import make_synthetic_cluster

    cluster = make_synthetic_cluster(64, 600, seed=1, machines_per_rack=8)
    runs = {}
    for device in (DEVICE, "cpu"):
        scale = dict(aggregate_classes=True, mesh_width=2,
                     mesh_devices=[torch.device(device, 0) if device == "cuda"
                                   else torch.device(device)] * 2)
        bridge, res = express_bridge(device, cluster, 3, **scale)
        rng = np.random.default_rng(79)
        out = [(dict(res.bindings), res.stats.cost)]
        last = {}
        for window in range(2):
            for uid, m in last.items():
                bridge.confirm_binding(uid, m)
            r = bridge.express_batch(express_events(bridge, rng, window, n=8))
            if r is None:
                raise AssertionError(f"[parity] scale express window "
                                     f"{window} degraded on {device}")
            last = dict(r.bindings)
            out.append((dict(r.bindings), r.cost, r.rounds))
        for uid, m in last.items():
            bridge.confirm_binding(uid, m)
        windows = stream_schedule(bridge, rng, "sc", [8, 8, 8])
        per, r, inf = stream_flush_windows(bridge, windows, "scale parity")
        if device == "cuda" and bridge.solver.last_stream_graph.get(
                "launches") != 1:
            raise AssertionError("[parity] width-2 stream flush: not one "
                                 "graph launch on the card")
        warm = bridge.solver.warm
        out.append((per, r.cost, r.rounds,
                    [np.asarray(t.cpu()).tolist()
                     for t in (warm.asg, warm.lvl, warm.floor,
                               inf.ctx.dev.s, inf.ctx.dev.u)],
                    [np.asarray(b.cpu()).tolist()
                     for b in inf.ctx.dev.c.blocks]))
        runs[device] = out
    if runs[DEVICE] != runs["cpu"]:
        raise AssertionError("[parity] aggregated width-2 lane: card != cpu")
    log(f"[parity] aggregated width-2 round, 2 express windows and a "
        f"3-window stream flush (one graph launch on the card): card == "
        f"cpu (round cost="
        f"{runs['cpu'][0][1]}, windows placed "
        f"{[len(w[0]) for w in runs['cpu'][1:3]]}, flush placed "
        f"{[len(a) for a in runs['cpu'][3][0]]})")


def pruned_oracle_cost(view, kw: dict, k: int, device) -> int:
    """The C++ oracle's optimum of a round's quincy graph with each
    task's preference arcs cut to its ``k`` heaviest (the scale lane's
    ``--topk_prefs``): the dropped arcs get capacity 0."""
    import dataclasses

    import numpy as np

    from poseidon_tpu_torch.graph.aggregate import prune_topology_prefs
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import build_cost_inputs, quincy_cost
    from poseidon_tpu_torch.oracle import solve_oracle
    from poseidon_tpu_torch.ops.transport import extract_topology

    net, meta = FlowGraphBuilder().build(view)
    host = net.to_host()
    topo = extract_topology(meta, host["src"], host["dst"], host["cap"])
    pruned = prune_topology_prefs(topo, meta.arc_weight, meta.arc_discount, k)
    drop = np.setdiff1d(topo.arc_pref[topo.arc_pref >= 0],
                        pruned.arc_pref[pruned.arc_pref >= 0])
    cap = net.cap.copy()
    cap[drop] = 0
    inputs = build_cost_inputs(net, meta, device=device, **kw)
    priced = net.with_costs(quincy_cost(inputs))
    return solve_oracle(dataclasses.replace(priced, cap=cap),
                        algorithm="cost_scaling").cost


# ---- the general-graph lane: cost-scaling, SSP, the front door ------

# make_synthetic_cluster(200, 2000, seed=0) under quincy, and the
# reference's counts there and at the flagship (JAX on a CPU host,
# priced by tests/helpers.py's ``price``): sweeps, phases, and cost
GENERAL_SMALL = (200, 2000)
GENERAL_SMALL_COUNTS = (1744, 12)
FLAGSHIP_CS = (771192, 2592, 13)
# the flagship's launches of K9 and K10 (out) in a cost-scaling solve and
# of K10 (in) and K11 in an SSP solve, as the host loop has run them
FLAGSHIP_CS_LAUNCHES = (2592, 1928)
FLAGSHIP_SSP_LAUNCHES = (83642, 10001)
GENERAL_FUSE = 100               # a blown cost-scaling fuse at 200 x 2,000
PROFILE_PATHS = 100              # SSP's paths under torch.profiler
GENERAL_MAX_PATHS = 50           # SSP's path cap at 200 x 2,000
GENERAL_KERNELS = ("cs_sweep", "bf_relax", "ssp_augment")
GENERAL_SYMBOLS = ("cs_sweep_kernel", "bf_out_kernel", "bf_in_kernel",
                   "ssp_walk_kernel", "ssp_wide_kernel")


def priced_net(torch, cluster, device):
    """A cluster's built FlowNetwork priced by quincy on ``device``, and
    its meta."""
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models.costs import build_cost_inputs, quincy_cost

    net, meta = FlowGraphBuilder().build(cluster)
    inputs = build_cost_inputs(net, meta, device=device,
                               **cost_kwargs(cluster))
    return net.with_costs(quincy_cost(inputs)), meta


def cs_fields(res) -> tuple:
    return (res.flows.tobytes(), res.routed, res.wanted, res.sweeps,
            res.phases, res.converged)


def cs_line(res) -> str:
    return (f"sweeps={res.sweeps} phases={res.phases} routed={res.routed}/"
            f"{res.wanted} converged={res.converged} "
            f"loop_syncs={res.loop_syncs} fetches={res.fetches}")


def busiest_burst(torch, net):
    """Run ``net``'s cost-scaling solve under the host loop of ``_Solve``
    itself, with reads of the state at the start of every refine burst,
    and keep the state at the start of the burst whose active nodes have
    the most out-arcs. Returns a function that makes a fresh solve object
    in that state (its eps on the device), the burst's eps, its active
    nodes and their arcs."""
    from poseidon_tpu_torch.ops.cost_scaling import _Solve

    dev = torch.device(DEVICE)
    fuse = 200 * (net.num_node_slots.bit_length() + 8) * 8

    class Sampled(_Solve):
        best = (-1, None)

        def bf_init(self) -> None:
            act = self.excess > 0
            deg = (self.g.seg[1:] - self.g.seg[:-1]).long()
            load = int(deg[act].sum())
            if load > self.best[0]:
                self.best = (load, (self.flow.clone(), self.excess.clone(),
                                    self.price.clone(), int(self.eps),
                                    int(act.sum())))
            super().bf_init()

    s = Sampled(net, dev, 8, fuse, 16)
    s.run(host_loop=True)
    load, (flow, excess, price, eps, n_act) = s.best

    def at_burst():
        t = _Solve(net, dev, 8, fuse, 16)
        t.flow.copy_(flow)
        t.excess.copy_(excess)
        t.price.copy_(price)
        t.eps.fill_(eps)
        return t

    return at_burst, eps, n_act, load


def global_update(s) -> int:
    """Solve object ``s``'s global price update as its host loop runs it
    (the arc lengths, Bellman-Ford bursts until converged or NN rounds,
    the price shift). Returns the host reads it made."""
    s.bf_init()
    it, reads = 0, 0
    while True:
        s.bf_burst()
        it += 8
        reads += 1
        if not (int(s.changed[0]) and it < s.NN):
            break
    s.update()
    return reads


def ssp_first_path(torch, net):
    """SSP's first path on the card: the residual CSR, the converged
    Bellman-Ford distances and predecessors, and K10 ``in``'s first-round
    inputs."""
    import numpy as np

    from poseidon_tpu_torch.kernels.bf_relax import INF, bf_relax_in
    from poseidon_tpu_torch.kernels.ssp_augment import mirror_costs_plain
    from poseidon_tpu_torch.kernels.ssp_loop import D, GO_BF, SspLoop
    from poseidon_tpu_torch.ops.cost_scaling import residual_csr
    from poseidon_tpu_torch.ops.ssp import _residual_tables

    dev = torch.device(DEVICE)
    fsrc, fdst, fcap, fcost, S, T = _residual_tables(net)
    F, NN = fsrc.shape[0], net.num_node_slots + 2
    g = residual_csr(fsrc, fdst, fcap, np.concatenate([fcost, -fcost]), NN,
                     dev)
    flow = torch.zeros(F, dtype=torch.int32, device=dev)
    pot = torch.zeros(NN, dtype=torch.int32, device=dev)
    mrc = mirror_costs_plain(g.arc, g.head, g.tail, g.cost, g.fcap, pot, flow)
    dist0 = torch.full((NN,), INF, dtype=torch.int32, device=dev)
    dist0[S] = 0
    pred0 = torch.full((NN,), 2 * F, dtype=torch.int32, device=dev)
    dist, pred = dist0.clone(), pred0.clone()
    d2 = torch.empty_like(dist)
    loop = SspLoop(dev, 1, 2, NN)
    rounds = 0
    while True:
        # the round reads dist and writes d2 at an even parity, then
        # advances it: swap so that dist holds the round's distances
        bf_relax_in(g.seg, g.arc, g.head, mrc, dist, d2, pred, g.plan, loop)
        dist, d2 = d2, dist
        loop.words[D] = 0
        rounds += 1
        if not int(loop.words[GO_BF]):
            break
    tabs = (torch.as_tensor(fsrc, device=dev), torch.as_tensor(fdst, device=dev))
    return dict(g=g, mrc=mrc, dist0=dist0, pred0=pred0, dist=dist, pred=pred,
                flow=flow, tabs=tabs, S=S, T=T, F=F, NN=NN, rounds=rounds,
                wanted=int(np.maximum(net.supply, 0).sum()))


def path_step(g, fsrc, fdst, NN: int, wanted: int, S: int, T: int, flow,
              pred, dist, pot, routed: int = 0, words=(0, 0), paths: int = 0,
              max_paths: int = 2**31 - 1):
    """A K11 ``PathStep`` over residual CSR ``g`` holding one path's flow,
    predecessors, distances (in the buffer the step reads), potentials
    and routed count (copies of the tensors given). ``words``: the parity
    words (d, p) of the step's loop words; ``paths`` its path count,
    ``max_paths`` its cap."""
    from poseidon_tpu_torch.kernels.ssp_augment import PathStep

    loop = ssp_words(flow.device, NN, wanted, max_paths, D=words[0],
                     P=words[1], PATHS=paths)
    st = PathStep(g.arc, g.head, g.plan.tail, g.cost, g.fcap, fsrc, fdst, NN,
                  wanted, S, T, loop)
    d, p = st.parities()
    st.flow.copy_(flow)
    st.pred.copy_(pred)
    st.dist[d].copy_(dist)
    st.dist[d ^ 1].fill_(-3)
    st.pot[p].copy_(pot)
    st.state[0] = routed
    return st



def ssp_words(dev, NN: int, wanted: int = 1, max_paths: int = 2, **words):
    """Fresh SSP loop words (``kernels/ssp_loop.py``) with the named words
    set (``D=3``, ``IT=5``, ...)."""
    from poseidon_tpu_torch.kernels import ssp_loop

    loop = ssp_loop.SspLoop(dev, wanted, max_paths, NN)
    for k, v in words.items():
        loop.words[getattr(ssp_loop, k)] = v
    return loop


def fold_graphs():
    """K10 ``in``'s fold cases (name, fsrc, fdst, NN): a graph of one
    light block; a CSR of no node (no heavy and no light item: the launch
    runs one cluster of idle blocks); one node of 3,000 positions (a
    heavy cluster only); one heavy node of 2,300 positions beside 3,000
    light nodes of degree 6 (light blocks beside the cluster, the last
    block to finish most likely a light one)."""
    import numpy as np

    rng = np.random.default_rng(23)
    small = rng.integers(0, 6, (2, 8))
    hub = np.zeros(1500, np.int64)
    light = rng.integers(1, 3001, (2, 9000))
    wide = np.concatenate([np.stack([np.zeros(2300, np.int64),
                                     rng.integers(1, 3001, 2300)]), light], 1)
    return [("one block", small[0], small[1], 6),
            ("no segment", np.zeros(0, np.int64), np.zeros(0, np.int64), 0),
            ("heavy only", hub, hub, 1),
            ("heavy and light", wide[0], wide[1], 3001)]


def fold_edges(torch) -> tuple[int, list]:
    """The folded round and step ends on the card, launched eagerly (no
    handle), each against its twin, tolerance 0: K10 ``in`` on
    ``fold_graphs`` at round counts that keep and end the round loop,
    and K11 steps whose end caps the path loop by max_paths, stops it by
    delta 0, and goes on. Returns (cases, differing cases)."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bf_relax as k10
    from poseidon_tpu_torch.kernels import ssp_augment as k11
    from poseidon_tpu_torch.ops.cost_scaling import residual_csr

    dev = torch.device(DEVICE)
    n, bad = 0, []
    for name, fsrc, fdst, NN in fold_graphs():
        rng = np.random.default_rng(NN)
        F = len(fsrc)
        fcap = rng.integers(1, 6, F).astype(np.int32)
        fcost = rng.integers(-30, 30, F).astype(np.int32)
        g = residual_csr(fsrc.astype(np.int32), fdst.astype(np.int32), fcap,
                         np.concatenate([fcost, -fcost]), NN, dev)
        flow = torch.as_tensor(rng.integers(0, 2, F).astype(np.int32),
                               device=dev)
        pot = torch.as_tensor(rng.integers(-9, 9, NN).astype(np.int32),
                              device=dev)
        mrc = k11.mirror_costs_plain(g.arc, g.head, g.tail, g.cost, g.fcap,
                                     pot, flow).to(torch.int32)
        dist = torch.as_tensor(np.where(rng.random(NN) < 0.5, rng.integers(
            0, 50, NN), k10.INF).astype(np.int32), device=dev)
        pred0 = torch.as_tensor(rng.integers(0, 2 * F + 1, NN).astype(
            np.int32), device=dev)
        for word, it in ((1, 0), (4, max(NN - 1, 0))):
            outs = []
            for fn in (lambda *a, g=g: k10.bf_relax_in(*a[:7], g.plan, a[7]),
                       k10.bf_relax_in_plain):
                da, db, p_o = dist.clone(), torch.full_like(dist, -5), \
                    pred0.clone()
                if word % 2:
                    da, db = db, da
                loop = ssp_words(dev, NN, D=word, IT=it)
                fn(g.seg, g.arc, g.head, mrc, da, db, p_o, loop)
                outs.append([da, db, p_o, loop.words, loop.tally])
            n += 1
            if max_abs_err(outs[0], outs[1]):
                bad.append(("bf_relax_in fold", name, word, it))
    # K11's end: the path cap reached, delta 0 (an unreachable T), and a
    # path that goes on; at parities 0 and odd
    cases = {c[0]: c for c in ssp_step_cases()}
    for label, case_name, paths, max_paths in (
            ("cap", "path", 4, 5), ("delta 0", "unreachable", 0, 9),
            ("goes on", "path", 2, 9), ("record+1", "record+1", 7, 9)):
        _, case, first = cases[case_name]
        for words in ((0, 0), (1, 3)):
            outs = []
            for fn in (k11.ssp_augment, k11.ssp_step_plain):
                g = residual_csr(case["fsrc"], case["fdst"], case["fcap"],
                                 np.concatenate([case["fcost"],
                                                 -case["fcost"]]),
                                 len(case["dist"]), dev)
                t = {k: torch.as_tensor(case[k], device=dev) for k in (
                    "fsrc", "fdst", "flow", "pred", "dist", "pot")}
                st = path_step(g, t["fsrc"], t["fdst"], len(case["dist"]),
                               case["wanted"], case["S"], case["T"],
                               t["flow"], t["pred"], t["dist"], t["pot"],
                               case["routed"], words, paths, max_paths)
                fn(st, first)
                outs.append(step_outputs(st))
            n += 1
            if max_abs_err(outs[0], outs[1]):
                bad.append(("ssp_augment fold", label, words))
    return n, bad


def step_outputs(st) -> list:
    """Everything a K11 step writes or must leave as it was: the flow,
    state, mirror costs, predecessors, both buffers of each pair, and the
    loop's words and tally (the step's end)."""
    return [st.flow, st.state, st.mrc, st.pred, *st.dist, *st.pot,
            st.loop.words, st.loop.tally]


def ssp_step_bytes_ops(NN: int, F: int, h: int) -> tuple[int, int]:
    """Bytes a K11 step must move (each input read once, each output
    written once) and its int32 operations: the walk of an h-arc path
    (pred, the arc's tail, capacity and flow in, the flow out: 20 bytes
    an arc, and dist[T] and the state), the wide pass over 2F positions
    (arc, head, tail, cost in, mirror cost out: 20 bytes; ~12 ops) and NN
    nodes (pot, dist in; pot', dist0, pred out: 20 bytes; ~4 ops), and
    the flow and capacities it gathers (8 bytes a forward arc)."""
    R = 2 * F
    return (20 * h + 12 + 20 * R + 20 * NN + 8 * F,
            6 * h + 12 * R + 4 * NN)


WARM_CALLS = 20


def warm_ms(torch, fn) -> float:
    """CUDA-event ms a call over WARM_CALLS back-to-back calls, the card
    held busy until all are enqueued (so the time is the card's)."""
    fn()
    torch.cuda._sleep(SLEEP_CYCLES * WARM_CALLS)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(WARM_CALLS):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / WARM_CALLS


def path_length(pred, fsrc, fdst, S: int, T: int) -> int:
    p, fs, fd = pred.tolist(), fsrc.tolist(), fdst.tolist()
    F = len(fs)
    v, h = T, 0
    while v != S and h < len(p):
        a = p[v]
        if a >= 2 * F:
            break
        v = fs[a] if a < F else fd[a - F]
        h += 1
    return h


def general_kernel_records(torch, timer):
    """K9-K11 held against their twins (tolerance 0) and timed cold at the
    flagship's shapes (NN 12,290, 2F 145,410 for cost-scaling; 145,408
    for SSP); then one refine burst as the host loop runs it and the
    general lane's graphs under torch.profiler."""
    from poseidon_tpu_torch.kernels import bf_relax as k10
    from poseidon_tpu_torch.kernels import cs_sweep as k9
    from poseidon_tpu_torch.kernels import ssp_augment as k11
    from poseidon_tpu_torch.kernels.ssp_loop import SspLoop
    from poseidon_tpu_torch.ops.cost_scaling import arc_lengths
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    records = []
    # K9 at the first sweep of the flagship solve's busiest refine burst
    # (its state after the burst's global update)
    flag, _ = priced_net(torch, config2_quincy_flagship(seed=0),
                         torch.device(DEVICE))
    at_burst, eps, n_act, load = busiest_burst(torch, flag)
    s = at_burst()
    global_update(s)
    g, NN, F = s.g, s.NN, s.F
    act = s.excess > 0
    deg = (g.seg[1:] - g.seg[:-1]).long()
    act_arcs = int(deg[act].sum())
    n_act = int(act.sum())
    ex2, pr2 = torch.empty_like(s.excess), torch.empty_like(s.price)
    plan = g.plan
    heavy = [int(x) for x in deg[plan.items[:plan.n_heavy, 0].long()]]
    log(f"[kernels] K9/K10 launch plan (flagship, cost-scaling CSR): "
        f"{plan.n_heavy} heavy segments of {heavy} positions over clusters "
        f"of 8 blocks, {plan.n_light} light blocks, {plan.blocks} blocks")

    def k9_kernel(*a):
        k9.cs_sweep(*a, plan)

    # eps on the device, as the solve's graph passes it
    outs = []
    for fn in (k9_kernel, k9.cs_sweep_plain):
        flow = s.flow.clone()
        e_o, p_o = torch.empty_like(s.excess), torch.empty_like(s.price)
        fn(g.seg, g.arc, g.head, g.cost, g.fcap, flow, s.excess, s.price,
           s.eps, e_o, p_o)
        outs.append([flow, e_o, p_o])
    err = max_abs_err(outs[0], outs[1])
    flow = s.flow.clone()

    def k9_call(fn):
        return lambda: fn(g.seg, g.arc, g.head, g.cost, g.fcap, flow,
                          s.excess, s.price, s.eps, ex2, pr2)

    # bytes: seg, each active segment's arc/head/cost and residual (24 an
    # arc), excess and price in and out (24 a node)
    b = 4 * (NN + 1) + 24 * act_arcs + 24 * NN
    ops = 12 * act_arcs
    ms, plain = timer(k9_call(k9_kernel)), timer(k9_call(k9.cs_sweep_plain))
    log(f"[kernels] cs_sweep state: the busiest refine burst's first sweep "
        f"(eps={eps}), {n_act} active nodes, {act_arcs} arcs in their "
        f"segments (of {2 * F})")
    records.append((k9.KERNEL, err, ms, plain, *bound_ms(b, ops),
                    (NN, 2 * F)))

    # K10 out: the first round of the same state's next global update
    ln = arc_lengths(g, s.flow, s.price, eps)
    d = torch.where(s.excess < 0, 0, k10.INF_K).to(torch.int64)
    ch = torch.zeros(1, dtype=torch.int32, device=DEVICE)

    def k10_out(*a):
        k10.bf_relax_out(*a, plan)

    outs = []
    for fn in (k10_out, k10.bf_relax_out_plain):
        d_o, c_o = torch.empty_like(d), torch.zeros_like(ch)
        fn(g.seg, g.head, ln, d, d_o, c_o)
        outs.append([d_o, c_o])
    err = max_abs_err(outs[0], outs[1])
    d_o = torch.empty_like(d)
    b = 4 * (NN + 1) + 12 * 2 * F + 16 * NN + 4
    ops = 4 * 2 * F
    ms = timer(lambda: k10_out(g.seg, g.head, ln, d, d_o, ch))
    plain = timer(lambda: k10.bf_relax_out_plain(g.seg, g.head, ln, d, d_o, ch))
    records.append((k10.KERNEL, err, ms, plain, *bound_ms(b, ops),
                    (NN, 2 * F)))
    del s, ln, d

    # K10 in at SSP's first round of its first path (the flagship net)
    q = ssp_first_path(torch, flag)
    g2, NN2, F2 = q["g"], q["NN"], q["F"]

    def k10_in(*a):
        k10.bf_relax_in(*a[:7], g2.plan, a[7])

    # the round and its end on fresh loop words (parity 0); the timed
    # calls alternate the pair by the parity each round advances
    outs = []
    for fn in (k10_in, k10.bf_relax_in_plain):
        d_a, d_o, p_o = q["dist0"].clone(), torch.empty_like(q["dist0"]), \
            q["pred0"].clone()
        lp = SspLoop(torch.device(DEVICE), 1, 2, NN2)
        fn(g2.seg, g2.arc, g2.head, q["mrc"], d_a, d_o, p_o, lp)
        outs.append([d_a, d_o, p_o, lp.words, lp.tally])
    in_err = max_abs_err(outs[0], outs[1])
    in_args = (g2.seg, g2.arc, g2.head, q["mrc"], q["dist0"].clone(),
               torch.empty_like(q["dist0"]), q["pred0"].clone(),
               SspLoop(torch.device(DEVICE), 1, 2, NN2))
    in_ms = timer(lambda: k10_in(*in_args))
    in_plain = timer(lambda: k10.bf_relax_in_plain(*in_args))
    # the round's bytes and its end's: the loop words it reads (parity,
    # changed, the round count, NN, the tally slot) and writes (those and
    # the go word and the ticket)
    b_in = 4 * (NN2 + 1) + 12 * 2 * F2 + 12 * NN2 + 44
    in_bms, in_by = bound_ms(b_in, 4 * 2 * F2)
    log(f"[kernels] bf_relax (in) shape=({NN2}, {2 * F2}) "
        f"max_abs_err={in_err} ms={in_ms:.6f} plain_ms={in_plain:.6f} "
        f"bound_ms={in_bms:.6f} ({in_by}); the record is the out round's")
    if in_err:
        raise AssertionError(f"bf_relax (in) != twin: {in_err}")

    # K11: the first path's step (walk, augment, potentials, the next
    # round's mirror costs and dist0/pred0, the step's end); each timed
    # call restores the flow, the routed count, pred and the loop words
    # first (four launches, timed alone and taken off): the parity words
    # are (0, 0) at every call
    fsrc, fdst = q["tabs"]
    zero = torch.zeros(NN2, dtype=torch.int32, device=DEVICE)

    def first_step():
        return path_step(g2, fsrc, fdst, NN2, q["wanted"], q["S"], q["T"],
                         q["flow"], q["pred"], q["dist"], zero)

    outs = []
    for fn in (k11.ssp_augment, k11.ssp_step_plain):
        st = first_step()
        fn(st)
        outs.append(step_outputs(st))
    err = max_abs_err(outs[0], outs[1])
    h = path_length(q["pred"], fsrc, fdst, q["S"], q["T"])
    st = first_step()
    st0 = st.state.clone()

    def restore():
        st.flow.copy_(q["flow"])
        st.state.copy_(st0)
        st.pred.copy_(q["pred"])
        st.loop.words.zero_()

    def k11_call(fn):
        def call():
            restore()
            fn(st)
        return call

    base = timer(restore)
    ms = max(timer(k11_call(k11.ssp_augment)) - base, 0.0)
    plain = max(timer(k11_call(k11.ssp_step_plain)) - base, 0.0)
    delta = int(outs[0][1][1])
    log(f"[kernels] ssp_augment: first path's step, a path of {h} arcs "
        f"after {q['rounds']} Bellman-Ford rounds, delta={delta}; restore "
        f"copies {base:.6f} ms taken off both times")
    b, ops = ssp_step_bytes_ops(NN2, F2, h)
    records.append((k11.KERNEL, err, ms, plain, *bound_ms(b, ops),
                    (NN2, 2 * F2, h)))
    # yardsticks, not calls the port makes: the launch floor (an empty
    # kernel, torch.cuda._sleep(0)), cold and back to back; and the host
    # time of one step call beside it
    floor_cold = timer(lambda: torch.cuda._sleep(0))
    floor_warm = warm_ms(torch, lambda: torch.cuda._sleep(0))
    step_warm = warm_ms(torch, k11_call(k11.ssp_augment)) - warm_ms(
        torch, restore)
    log(f"[kernels] ssp_augment launch floor: torch.cuda._sleep(0) cold "
        f"{floor_cold:.6f} ms, back to back {floor_warm:.6f} ms a launch; "
        f"the step back to back {step_warm:.6f} ms a call (restore taken "
        f"off)")
    host, wall = host_us(torch, lambda: k11.ssp_augment(st))
    f_host, f_wall = host_us(torch, lambda: torch.cuda._sleep(0))
    log(f"[kernels] ssp_augment wrapper host_us={host:.3f} wall_us="
        f"{wall:.3f} per call; torch.cuda._sleep(0) host_us={f_host:.3f} "
        f"wall_us={f_wall:.3f} (median of {HOST_BATCHES} x {HOST_CALLS} "
        f"calls)")
    profile_refine_burst(torch, at_burst())
    profile_general_graphs(torch, flag)
    return records


def profile_refine_burst(torch, s) -> None:
    """One refine burst (a global update, then 16 K9 sweeps) of solve
    object ``s`` under torch.profiler, as the host loop runs it: wall,
    device busy time and idle share, and K9's and K10's device time per
    launch."""
    from torch.profiler import ProfilerActivity, profile

    sync(torch)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        reads = global_update(s)
        s.sweep_burst()
        sync(torch)
        wall_us = (time.perf_counter() - t0) * 1e6
    rows = device_rows(prof)
    busy = sum(t for _, t, _ in rows)
    log(f"[profile] refine burst (the flagship's busiest, host loop): "
        f"wall_us={wall_us:.1f} loop_reads={reads + 1} "
        f"device_busy_us={busy:.1f} idle_share={1 - min(busy / wall_us, 1):.3f}")
    rows.sort(key=lambda r: -r[1])
    for key, t, n in rows[:12]:
        log(f"[profile]   {t:10.1f} us  x{n:<5d} {key[:90]}")
    for k in GENERAL_SYMBOLS[:2]:
        hits = [(t, n) for key, t, n in rows if k in key]
        total, count = sum(t for t, _ in hits), sum(n for _, n in hits)
        log(f"[profile] refine burst kernel {k}: total_us={total:.1f} "
            f"launches={count} us_per_launch={total / max(count, 1):.3f}")


def profile_general_graphs(torch, net) -> None:
    """The flagship's cost-scaling solve and SSP's first
    ``PROFILE_PATHS`` paths, each one graph, under torch.profiler (the
    residual CSR's build and the capture included): device busy and idle
    share, each graph's solve ms (launch to fetch),
    and K9's, K10's, K11's and K14's device time per launch as the graphs
    run them. (The whole SSP graph, 83,642 relaxation rounds, under the
    profiler once faulted with an illegal address on an H100, where the
    same solve unprofiled equals its host loop.)"""
    from torch.profiler import ProfilerActivity, profile

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.ops import cost_scaling, ssp

    for label, module, solve, symbols in (
            ("cost-scaling flagship (graph)", cost_scaling,
             cost_scaling.solve_cost_scaling, GENERAL_SYMBOLS[:2]),
            (f"SSP's first {PROFILE_PATHS} paths (graph)", ssp,
             lambda n, **k: ssp.solve_ssp(n, max_paths=PROFILE_PATHS, **k),
             GENERAL_SYMBOLS[2:])):
        n0 = module.CAPTURES.total
        sync(torch)
        kernels.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = solve(net, device=DEVICE)
            sync(torch)
            wall_us = (time.perf_counter() - t0) * 1e6
        (cap,) = module.CAPTURES.since(n0)
        log(f"[profile] {label}: loop_reads={res.loop_syncs} "
            f"fetches={res.fetches} capture_ms={cap[2]:.3f} "
            f"solve_ms={cap[3]:.3f} (profiled) launches: " + " ".join(
                f"{k.name}={k.launches}" for k in kernels.KERNELS
                if k.name in GENERAL_KERNELS + ("loop_ctl",)))
        profile_symbols(prof, wall_us, label, (*symbols, "loop_ctl_kernel"))


def edge_residual_graph(seed: int, NN: int, F: int, hub: int):
    """A random residual graph for K9/K10's battery on the card: node
    NN - 1 has no arc (degree 0), node 1 is the tail of ``hub`` forward
    arcs (a segment past 1,024 when hub is large), with random
    capacities, flows, excesses, prices and costs of both signs."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fsrc = rng.integers(0, NN - 1, F).astype(np.int32)
    fdst = rng.integers(0, NN - 1, F).astype(np.int32)
    fsrc[:hub] = 1
    fcap = rng.integers(0, 10, F).astype(np.int32)
    fcost = rng.integers(-400, 400, F).astype(np.int64)
    flow = (rng.random(F) * (fcap + 1)).astype(np.int32).clip(0, fcap)
    excess = rng.integers(-6, 9, NN).astype(np.int32)
    price = rng.integers(-900, 900, NN).astype(np.int64)
    return fsrc, fdst, fcap, fcost, flow, excess, price


def degree_graph(seed: int, degrees):
    """Residual tables whose nodes have exactly ``degrees`` residual arcs:
    the degree stubs paired at random (a self loop gives its node both
    its forward arc and the mirror; an odd total gets one more stub on
    the last node). Random capacities, flows, prices and costs of both
    signs; excesses small, the nodes past a light block's reach holding
    up to 10^6."""
    import numpy as np

    from poseidon_tpu_torch.kernels.csr_plan import CHUNK

    rng = np.random.default_rng(seed)
    deg = np.asarray(degrees, np.int64)
    deg[-1] += int(deg.sum()) % 2
    stubs = rng.permutation(np.repeat(np.arange(len(deg)), deg))
    fsrc, fdst = stubs[0::2].astype(np.int32), stubs[1::2].astype(np.int32)
    F = len(fsrc)
    fcap = rng.integers(0, 10, F).astype(np.int32)
    fcost = rng.integers(-400, 400, F).astype(np.int64)
    flow = (rng.random(F) * (fcap + 1)).astype(np.int32).clip(0, fcap)
    excess = rng.integers(-6, 9, len(deg)).astype(np.int32)
    big = deg > CHUNK
    excess[big] = rng.integers(1, 10**6, int(big.sum()))
    price = rng.integers(-900, 900, len(deg)).astype(np.int64)
    return fsrc, fdst, fcap, fcost, flow, excess, price


def hub_graph(D: int, admissible, NN: int = 40, extra: int = 200):
    """tests/test_torch_cost_scaling.py's ``hub_graph``: node 1 the tail
    of forward arcs 0..D-1, prices 0, every residual arc 2 units, node
    1's arcs cost -1 at ``admissible`` and +1 elsewhere, node 1's excess
    5: the choice arc pushes its share and a remainder."""
    import numpy as np

    rng = np.random.default_rng(0)
    F = D + extra
    fsrc = np.concatenate([np.full(D, 1), rng.integers(2, NN - 1, extra)])
    fdst = np.concatenate([rng.integers(2, NN - 1, D),
                           rng.integers(2, NN - 1, extra)])
    fcost = np.concatenate([np.ones(D), rng.integers(-400, 400, extra)])
    fcost[list(admissible)] = -1
    excess = rng.integers(-6, 9, NN).astype(np.int32)
    excess[1] = 5
    return (fsrc.astype(np.int32), fdst.astype(np.int32),
            np.full(F, 4, np.int32), fcost.astype(np.int64),
            np.full(F, 2, np.int32), excess, np.zeros(NN, np.int64))


def tie_graph(D1: int, D2: int = 20, NN: int = 30):
    """tests/test_torch_ssp.py's ``tie_graph``: node 1's in-arcs all offer
    -5 (distances 0, node 1's INF); the lowest arc id among them, D1,
    sits at the end of node 1's segment. Returns the tables with the
    distances in place of the excesses and potentials 0."""
    import numpy as np

    rng = np.random.default_rng(D1)
    F = D1 + D2
    fsrc = np.concatenate([np.full(D1, 1), np.full(D2, 3)]).astype(np.int32)
    fdst = np.concatenate([rng.integers(2, NN, D1),
                           np.full(D2, 1)]).astype(np.int32)
    fcost = np.concatenate([np.full(D1, 5), np.full(D2, -5)]).astype(np.int64)
    flow = np.concatenate([np.ones(D1), np.zeros(D2)]).astype(np.int32)
    dist = np.zeros(NN, np.int32)
    dist[1] = 2**30
    return (fsrc, fdst, np.full(F, 4, np.int32), fcost, flow, dist,
            np.zeros(NN, np.int64))


def general_edge_graphs():
    """(name, tables, SSP potentials or None, distances or None) of K9's
    and K10's battery: random graphs (a degree-0 node, hubs of
    1,100 and 1,500 arcs), segments of degree 0, 1, 31-33, the chunk
    size +- 1, a cluster's reach +- 1 and 12,289 (S and T at the
    flagship) among 3,000 nodes of degree 6, a graph of heavy nodes only,
    the hub cases of the CPU tests (the choice arc and the other
    admissible arcs in different chunks and blocks, a remainder push on
    the choice arc, a segment past one cluster's reach) and the two
    ``in`` ties whose lowest arc id lies at the segment's end."""
    from poseidon_tpu_torch.kernels.csr_plan import CHUNK, CLUSTER

    out = [(f"random{seed}", edge_residual_graph(seed, NN, F, hub),
            None)
           for seed, NN, F, hub in ((1, 40, 300, 0), (2, 300, 4000, 1500),
                                    (3, 2, 1, 0), (4, 1100, 3000, 1100))]
    reach = CLUSTER * CHUNK
    out.append(("degrees", degree_graph(5, [
        0, 1, 31, 32, 33, CHUNK - 1, CHUNK, CHUNK + 1, reach - 1, reach,
        reach + 1, 12289, 12289] + [6] * 3000 + [0, 1]), None))
    out.append(("all_heavy", degree_graph(6, [CHUNK + 1, 3000, 5000,
                                              reach + 2]), None))
    for name, (D, adm) in {
        "hub_light_at_threshold": (CHUNK, [31, 32, 1000, CHUNK - 1]),
        "hub_choice_chunk0_rest_later": (3 * CHUNK + 100,
                                         [CHUNK - 1, CHUNK + 5,
                                          2 * CHUNK + 7, 3 * CHUNK + 50]),
        "hub_choice_on_rank3": (5 * CHUNK, [3 * CHUNK + 1, 3 * CHUNK + 9,
                                            4 * CHUNK + 3, 4 * CHUNK + 4]),
        "hub_past_one_cluster": (reach + 300, [5, 7 * CHUNK + 1,
                                               reach + 10, reach + 299]),
    }.items():
        out.append((name, hub_graph(D, adm), None))
    for name, D1 in (("tie_light", CHUNK - 30),
                     ("tie_heavy_rank2", 2 * CHUNK + 10)):
        out.append((name, tie_graph(D1), "tie"))
    return out


def general_edges(torch) -> None:
    """K9, K10 (both entry points) and K11 against their twins on the
    card, tolerance 0, at edge shapes (``general_edge_graphs``): K9 at
    eps 1, 3 and 64 over costs of both signs; K10 ``out`` with all-INF,
    all-zero and deficit distances; K10 ``in`` from one source, all INF
    and mixed (the tie graphs with their own distances); and K11's
    walks: a path, one over a mirror arc, a walk that meets the
    sentinel, an unreachable T, a cycle to the step cap, and a delta
    cut by wanted - routed; then the folded round and step ends
    (``fold_edges``)."""
    import numpy as np

    from poseidon_tpu_torch.kernels import bf_relax as k10
    from poseidon_tpu_torch.kernels import cs_sweep as k9
    from poseidon_tpu_torch.kernels import ssp_augment as k11
    from poseidon_tpu_torch.ops.cost_scaling import arc_lengths, residual_csr

    INF_K, INF = k10.INF_K, k10.INF
    dev = torch.device(DEVICE)
    bad, n = [], 0

    def check(label, kernel, plain, make_args):
        """One case: the kernel (with the plan) and its twin on fresh
        copies of the same arguments; every output equal."""
        nonlocal n
        outs = []
        for fn in (kernel, plain):
            args, keep = make_args()
            fn(*args)
            outs.append(keep)
        err = max_abs_err(outs[0], outs[1])
        n += 1
        if err:
            ndiff = [int((x != y).sum()) for x, y in zip(*outs)]
            bad.append((*label, err, ndiff))

    for name, tabs, kind in general_edge_graphs():
        fsrc, fdst, fcap, fcost, flow_h, excess_h, price_h = tabs
        NN = len(excess_h)
        g = residual_csr(fsrc, fdst, fcap, np.concatenate([fcost, -fcost]),
                         NN, dev)
        flow0 = torch.as_tensor(flow_h, device=dev)
        excess = torch.as_tensor(excess_h, device=dev)
        price = torch.as_tensor(price_h, device=dev)
        rng = np.random.default_rng(NN)
        F = len(fsrc)
        if kind is None:
            for eps in (1, 3, 64):
                # eps read on the device, as the solve's graph passes it
                eps_t = torch.tensor(eps, dtype=torch.int64, device=dev)

                def sweep_args(eps_t=eps_t):
                    fl = flow0.clone()
                    e_o, p_o = torch.empty_like(excess), torch.empty_like(price)
                    return ((g.seg, g.arc, g.head, g.cost, g.fcap, fl, excess,
                             price, eps_t, e_o, p_o), [fl, e_o, p_o])
                check(("cs_sweep", name, eps),
                      lambda *a: k9.cs_sweep(*a, g.plan), k9.cs_sweep_plain,
                      sweep_args)
                ln = arc_lengths(g, flow0, price, eps)
                for dk in ("excess", "all_inf", "zeros"):
                    d = {"excess": torch.where(excess < 0, 0, INF_K),
                         "all_inf": torch.full((NN,), INF_K, device=dev),
                         "zeros": torch.zeros(NN, device=dev)}[dk].to(torch.int64)

                    def out_args(d=d, ln=ln):
                        d_o = torch.empty_like(d)
                        c_o = torch.full((1,), 7, dtype=torch.int32, device=dev)
                        return (g.seg, g.head, ln, d, d_o, c_o), [d_o, c_o]
                    check(("bf_relax_out", name, eps, dk),
                          lambda *a: k10.bf_relax_out(*a, g.plan),
                          k10.bf_relax_out_plain, out_args)
        pot = (price % 50).to(torch.int32)
        mrc = k11.mirror_costs_plain(g.arc, g.head, g.tail, g.cost, g.fcap,
                                     pot, flow0).to(torch.int32)
        for dk in (("tie",) if kind == "tie" else ("source", "all_inf", "mixed")):
            dist = {"tie": excess,
                    "source": torch.where(torch.arange(NN, device=dev) == 0,
                                          0, INF),
                    "all_inf": torch.full((NN,), INF, device=dev),
                    "mixed": torch.where(excess > 0, excess * 3, INF)}[dk]
            dist = dist.to(torch.int32)
            pred0 = torch.as_tensor(rng.integers(0, 2 * F + 1, NN)
                                    .astype(np.int32), device=dev)

            # the pair's roles from the loop's parity word: even reads
            # the first buffer, odd the second; the round's end at round
            # counts before NN - 1 (go = changed), at NN - 1 (go = 0)
            for word, it in ((0, 0), (2, NN - 2), (5, NN - 1)):
                def in_args(dist=dist, pred0=pred0, word=word, it=it, g=g,
                            mrc=mrc, NN=NN):
                    other = torch.full_like(dist, -5)
                    da, db = (other, dist.clone()) if word % 2 else (
                        dist.clone(), other)
                    p_o = pred0.clone()
                    loop = ssp_words(dev, NN, D=word, IT=it)
                    return ((g.seg, g.arc, g.head, mrc, da, db, p_o, loop),
                            [da, db, p_o, loop.words, loop.tally])
                check(("bf_relax_in", name, dk, f"parity {word} it {it}"),
                      lambda *a, g=g: k10.bf_relax_in(*a[:7], g.plan, a[7]),
                      k10.bf_relax_in_plain, in_args)
    hazards = []
    # each step with parity words on the device naming (d, p) = (0, 0),
    # (1, 0) and (0, 1) (as counters: 3, 6 and 4, 1)
    for (name, case, first), words in (
            (c, w) for c in ssp_step_cases() for w in ((0, 0), (3, 6), (4, 1))):
        def step_args(case=case, words=words):
            g = residual_csr(case["fsrc"], case["fdst"], case["fcap"],
                             np.concatenate([case["fcost"], -case["fcost"]]),
                             len(case["dist"]), dev)
            t = {k: torch.as_tensor(case[k], device=dev) for k in (
                "fsrc", "fdst", "flow", "pred", "dist", "pot")}
            st = path_step(g, t["fsrc"], t["fdst"], len(case["dist"]),
                           case["wanted"], case["S"], case["T"], t["flow"],
                           t["pred"], t["dist"], t["pot"], case["routed"],
                           words)
            return (st,), step_outputs(st)

        def k11_kernel(st, first=first, words=words, name=name):
            d0, _ = st.parities()
            k11.ssp_augment(st, first)
            # the hazard: the next dist0 went into the other buffer, and
            # the distances read are left as they were; the step's end
            # advanced both parity words by one
            want = torch.as_tensor(case["dist"], device=dev)
            kept = st.loop.words[:2].tolist() == [words[0] + 1, words[1] + 1]
            if not torch.equal(st.dist[d0], want) or not kept:
                hazards.append((name, words))

        check(("ssp_augment", name, words), k11_kernel,
              lambda st, first=first: k11.ssp_step_plain(st, first),
              step_args)
    n_fold, bad_fold = fold_edges(torch)
    log(f"[edges] cs_sweep, bf_relax (out, in), ssp_augment (eps and the "
        f"parities on the device): {n} cases, {len(bad)} "
        f"differ; ssp_augment dist-buffer hazards: {hazards}; the folded "
        f"round and step ends (eager, no handle): {n_fold} cases, "
        f"{len(bad_fold)} differ {bad_fold}")
    bad += bad_fold
    if bad or hazards:
        raise AssertionError(f"[edges] general kernels != twins: {bad[:8]}")


def ssp_step_cases():
    """K11's hand-made path steps, (name, case, first) triples: walks on
    a chain S -> 0 -> 1 -> ... -> 5 -> T of forward arcs 0..6
    (capacities 4..10, some flow), with arc 7 from 3 to 2 carrying flow
    (its mirror, arc 7 + F, reaches 3 from 2): a path, one over a mirror
    arc, into the sentinel, from an unreachable T, round a cycle, delta
    cut by wanted - routed and 0; chains of the walk's shared record
    length - 1, + 0 and + 1 arcs; and the prologue (no walk)."""
    import numpy as np

    from poseidon_tpu_torch.kernels.ssp_augment import INF, WALK_RECORD

    S, T = 6, 7
    fsrc = np.array([S, 0, 1, 2, 3, 4, 5, 3], np.int32)
    fdst = np.array([0, 1, 2, 3, 4, 5, T, 2], np.int32)
    F = len(fsrc)
    pred = np.array([0, 1, 2, 3, 4, 5, 2 * F, 6], np.int32)
    dist = np.array([1, 2, 3, 4, 5, 6, 0, 7], np.int32)
    rng = np.random.default_rng(17)

    def case(pred_, dist_=dist, routed=0, tabs=None):
        fs, fd, fc, fl = tabs or (fsrc, fdst,
                                  np.array([4, 9, 8, 7, 6, 5, 10, 3], np.int32),
                                  np.array([1, 0, 2, 0, 0, 1, 0, 2], np.int32))
        NN = len(dist_)
        return dict(fsrc=fs, fdst=fd, fcap=fc, flow=fl, pred=pred_,
                    dist=dist_, routed=routed, wanted=10, S=NN - 2, T=NN - 1,
                    fcost=rng.integers(-50, 50, len(fs)).astype(np.int32),
                    pot=rng.integers(-40, 40, NN).astype(np.int32))

    def swap(seq, **at):
        out = seq.copy()
        for k, v in at.items():
            out[int(k[1:])] = v
        return out

    def chain(n_arcs):
        # S -> 0 -> ... -> n-1 -> T, a spare arc 0 -> T with flow; the
        # bottleneck of 3 in the middle
        n = n_arcs - 1
        fs = np.array([n] + list(range(n)) + [0], np.int32)
        fd = np.array(list(range(n)) + [n + 1, n + 1], np.int32)
        Fc = len(fs)
        fc = np.full(Fc, 5, np.int32)
        fc[n_arcs // 2] = 3
        fl = np.zeros(Fc, np.int32)
        fl[-1] = 2
        pr = np.concatenate([np.arange(n), [2 * Fc], [n]]).astype(np.int32)
        di = np.concatenate([np.arange(1, n + 1), [0], [n + 1]]).astype(np.int32)
        return case(pr, di, tabs=(fs, fd, fc, fl))

    out = [
        ("path", case(pred), False),
        ("mirror", case(swap(pred, v3=7 + F)), False),
        ("sentinel", case(swap(pred, v4=2 * F)), False),
        ("unreachable", case(pred, swap(dist, v7=INF)), False),
        # 2 <- 2 over arc 3's tail: a cycle that never reaches S
        ("cycle", case(swap(pred, v2=3, v3=7 + F)), False),
        ("capped", case(pred, routed=9), False),
        ("done", case(pred, routed=10), False),
        ("prologue", case(pred), True),
    ]
    for k in (-1, 0, 1):
        out.append((f"record{k:+d}", chain(WALK_RECORD + k), False))
    return out


def general_phase(torch, card: str) -> dict:
    """The general-graph lane on the card. Each solve runs its loops as
    one graph (``ops/cost_scaling.py``, ``ops/ssp.py`` ``GRAPH``): it must
    make no loop read and one fetch, and equal the host loop
    (``_host_loop=True``, the plain version) on the same inputs in every
    output and in its kernels' launch counts (the graph's from K14's
    tally): cost-scaling at 200 x 2,000 (also == the CPU twins), with a
    blown fuse, and with no supply; the quincy-priced flagship by
    cost-scaling (cost = oracle, the reference's sweeps and phases) and by
    SSP (= oracle, K11 once a path and once for the prologue); SSP at 200
    x 2,000, at max_paths and with no supply. Then the flagship as a
    DIMACS text through ``solve_scheduling`` (backend cost_scaling, one
    graph) and through its dense path cold and warm (= oracle). SSP's
    flagship graph runs K14 at most once (K10 ``in`` and K11 set its
    WHILE nodes); its us a round are printed. Launch
    counts are zeroed just before each solve and read just after it.
    Prints each graph's capture ms and solve ms beside the host loop's.
    Returns each kernel's launches in the solve its record times: K9 and
    K10 (its ``out`` round) in the cost-scaling solve, K11 in SSP's."""
    import dataclasses

    import numpy as np

    from poseidon_tpu_torch import kernels
    from poseidon_tpu_torch.cluster import ClusterState
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.graph.dimacs import read_dimacs, write_dimacs
    from poseidon_tpu_torch.ops import cost_scaling, ssp
    from poseidon_tpu_torch.oracle import solve_oracle
    from poseidon_tpu_torch.solver import solve_scheduling
    from poseidon_tpu_torch.synth import (
        config2_quincy_flagship, make_synthetic_cluster,
    )

    dev = torch.device(DEVICE)
    log(f"[general] card: {card}")

    def timed(fn):
        sync(torch)
        t0 = time.perf_counter()
        out = fn()
        sync(torch)
        return out, (time.perf_counter() - t0) * 1e3

    def counted(label, fn, launched):
        """``fn`` timed, with the launch counts zeroed just before it and
        read just after; fails unless each kernel of ``launched`` ran."""
        sync(torch)
        kernels.reset_launch_counts()
        out, ms = timed(fn)
        counts = {k.name: k.launches for k in kernels.KERNELS}
        log(f"[general] {label} launches: " + " ".join(
            f"{k}={counts[k]}" for k in (*launched, "loop_ctl")))
        idle = [k for k in launched if counts[k] == 0]
        if idle:
            raise AssertionError(f"[general] {label}: not launched {idle}")
        return out, ms, counts

    def graph_vs_host(label, module, solve, net, fields, launched, **kw):
        """One solve as the graph and as the host loop on the card, the
        same inputs: every output and launch count equal, the graph with
        no loop read and one fetch. Returns (graph result, counts)."""
        n0 = module.CAPTURES.total
        res, ms, counts = counted(f"{label} (graph)", lambda: solve(
            net, device=DEVICE, **kw), launched)
        (cap,) = module.CAPTURES.since(n0)
        host, host_ms, host_counts = counted(
            f"{label} (host loop)", lambda: solve(
                net, device=DEVICE, _host_loop=True, **kw), launched)
        same = fields(res) == fields(host)
        same_counts = all(counts[k] == host_counts[k]
                          for k in GENERAL_KERNELS)
        log(f"[general] {label}: graph capture_ms={cap[2]:.3f} solve_ms="
            f"{cap[3]:.3f} wall_ms={ms:.3f} loop_syncs={res.loop_syncs} "
            f"fetches={res.fetches} | host loop wall_ms={host_ms:.3f} "
            f"loop_syncs={host.loop_syncs} | bit-identical={same} "
            f"launches equal={same_counts}")
        if not same or not same_counts or res.loop_syncs != 0 or \
                res.fetches != 1 or host.fetches != 1:
            raise AssertionError(f"[general] {label}: graph != host loop "
                                 f"or loop reads/fetches off")
        return res, counts

    def ssp_fields(r) -> tuple:
        return (r.flows.tobytes(), r.routed, r.wanted, r.iterations)

    def no_supply(net):
        return dataclasses.replace(net, supply=np.zeros_like(net.supply))

    small, _ = priced_net(torch, make_synthetic_cluster(*GENERAL_SMALL,
                                                        seed=0), dev)
    card_res, _ = graph_vs_host(
        f"cost-scaling {GENERAL_SMALL[0]} x {GENERAL_SMALL[1]}",
        cost_scaling, cost_scaling.solve_cost_scaling, small, cs_fields,
        ("cs_sweep", "bf_relax"))
    cpu_res, cpu_ms = timed(
        lambda: cost_scaling.solve_cost_scaling(small, device="cpu"))
    same = cs_fields(card_res) == cs_fields(cpu_res)
    log(f"[general] cost-scaling {GENERAL_SMALL[0]} x {GENERAL_SMALL[1]}: "
        f"{cs_line(card_res)} | CPU twins wall_ms={cpu_ms:.3f} "
        f"loop_syncs={cpu_res.loop_syncs} | card == CPU: {same}")
    if not same or not card_res.converged or (
            card_res.sweeps, card_res.phases) != GENERAL_SMALL_COUNTS:
        raise AssertionError(f"[general] 200 x 2000: card != CPU or "
                             f"counts != {GENERAL_SMALL_COUNTS}")
    fused, _ = graph_vs_host(
        f"cost-scaling {GENERAL_SMALL[0]} x {GENERAL_SMALL[1]} max_sweeps="
        f"{GENERAL_FUSE}", cost_scaling, cost_scaling.solve_cost_scaling,
        small, cs_fields, ("cs_sweep", "bf_relax"), max_sweeps=GENERAL_FUSE)
    if fused.converged or fused.sweeps < GENERAL_FUSE:
        raise AssertionError(f"[general] fuse: {cs_line(fused)}")
    empty_res, _ = graph_vs_host(
        "cost-scaling, no supply", cost_scaling,
        cost_scaling.solve_cost_scaling, no_supply(small), cs_fields, ())
    log(f"[general] cost-scaling, no supply: {cs_line(empty_res)}")
    sres, _ = graph_vs_host(
        f"SSP {GENERAL_SMALL[0]} x {GENERAL_SMALL[1]}", ssp, ssp.solve_ssp,
        small, ssp_fields, ("bf_relax", "ssp_augment"))
    capped, _ = graph_vs_host(
        f"SSP max_paths={GENERAL_MAX_PATHS}", ssp, ssp.solve_ssp, small,
        ssp_fields, ("bf_relax", "ssp_augment"), max_paths=GENERAL_MAX_PATHS)
    empty, empty_counts = graph_vs_host(
        "SSP, no supply", ssp, ssp.solve_ssp, no_supply(small), ssp_fields,
        ())
    if capped.iterations != GENERAL_MAX_PATHS or empty.iterations != 0 \
            or empty_counts["ssp_augment"] != 0 or not sres.feasible:
        raise AssertionError(f"[general] SSP cases: {capped.iterations} "
                             f"paths at the cap, {empty.iterations} without "
                             f"supply, {sres.routed}/{sres.wanted} routed")

    flag, meta = priced_net(torch, config2_quincy_flagship(seed=0), dev)
    t0 = time.perf_counter()
    want = solve_oracle(flag, algorithm="cost_scaling").cost
    oracle_ms = (time.perf_counter() - t0) * 1e3
    res, cs_counts = graph_vs_host(
        "cost-scaling flagship", cost_scaling,
        cost_scaling.solve_cost_scaling, flag, cs_fields,
        ("cs_sweep", "bf_relax"))
    cost = cost_scaling.solution_cost(flag, res)
    log(f"[general] cost-scaling flagship (N {flag.num_node_slots}, E "
        f"{flag.num_arc_slots}): cost={cost} oracle={want} "
        f"oracle_ms={oracle_ms:.1f} {cs_line(res)}")
    if (cost, res.sweeps, res.phases) != FLAGSHIP_CS or cost != want:
        raise AssertionError(f"[general] flagship: cost/sweeps/phases "
                             f"{(cost, res.sweeps, res.phases)}, want "
                             f"{FLAGSHIP_CS}, oracle {want}")
    if not (res.converged and res.feasible):
        raise AssertionError(f"[general] flagship: {cs_line(res)}")
    if (cs_counts["cs_sweep"], cs_counts["bf_relax"]) != FLAGSHIP_CS_LAUNCHES:
        raise AssertionError(f"[general] flagship launches {cs_counts}, "
                             f"want K9, K10 {FLAGSHIP_CS_LAUNCHES}")

    sres, ssp_counts = graph_vs_host(
        "SSP flagship", ssp, ssp.solve_ssp, flag, ssp_fields,
        ("bf_relax", "ssp_augment"))
    scost = ssp.solution_cost(flag, sres)
    log(f"[general] SSP flagship: paths={sres.iterations} "
        f"routed={sres.routed}/{sres.wanted} cost={scost} oracle={want}")
    if scost != want or not sres.feasible:
        raise AssertionError(f"[general] SSP cost {scost} != oracle {want}")
    # one K11 call a path, after the prologue
    if ssp_counts["ssp_augment"] != sres.iterations + 1:
        raise AssertionError(f"[general] SSP: {ssp_counts['ssp_augment']} "
                             f"K11 calls for {sres.iterations} paths")
    if (ssp_counts["bf_relax"], ssp_counts["ssp_augment"]) != \
            FLAGSHIP_SSP_LAUNCHES:
        raise AssertionError(f"[general] SSP launches {ssp_counts}, want "
                             f"K10, K11 {FLAGSHIP_SSP_LAUNCHES}")
    # the loops' conditions are set by K10 in and K11 themselves: K14 runs
    # only the graph's entry, once a solve
    (_nn, _r, _cap_ms, solve_ms), = ssp.CAPTURES.since(
        ssp.CAPTURES.total - 1)
    rounds = ssp_counts["bf_relax"]
    log(f"[general] SSP flagship graph: {rounds} relaxation rounds, "
        f"{sres.iterations} paths, solve_ms={solve_ms:.3f}: "
        f"{solve_ms * 1e3 / rounds:.3f} us a round (the steps included), "
        f"{solve_ms * 1e3 / (rounds + sres.iterations):.3f} us a loop "
        f"iteration (a round or a step); loop_ctl launches "
        f"{ssp_counts['loop_ctl']} ({ssp_counts['loop_ctl'] / max(sres.iterations, 1):.6f} a path) | {card}")
    if ssp_counts["loop_ctl"] > 1:
        raise AssertionError(f"[general] SSP: K14 ran {ssp_counts['loop_ctl']} "
                             f"times, want at most 1")

    # the front door: its cost-scaling solve's own result, kept
    seen = []
    solve = cost_scaling.solve_cost_scaling

    def keep(*a, **k):
        seen.append(solve(*a, **k))
        return seen[-1]

    dnet = read_dimacs(write_dimacs(flag))
    _, empty_meta = FlowGraphBuilder().build(ClusterState(machines=[], tasks=[]))
    cost_scaling.solve_cost_scaling = keep
    try:
        out, ms, _ = counted(
            "DIMACS flagship",
            lambda: solve_scheduling(dnet, empty_meta, device=DEVICE),
            ("cs_sweep", "bf_relax"))
    finally:
        cost_scaling.solve_cost_scaling = solve
    (inner,) = seen
    log(f"[general] DIMACS flagship through solve_scheduling: backend="
        f"{out.backend} cost={out.cost} oracle={want} wall_ms={ms:.3f} "
        f"loop_syncs={inner.loop_syncs} fetches={inner.fetches}")
    if out.backend != "cost_scaling" or out.cost != want or \
            inner.loop_syncs != 0 or inner.fetches != 1:
        raise AssertionError(f"[general] DIMACS: {out.backend} {out.cost} "
                             f"{inner.loop_syncs} loop reads")

    cold, cold_ms, _ = counted("dense cold", lambda: solve_scheduling(
        flag, meta, small_to_oracle=False, device=DEVICE), ROUND_KERNELS)
    warm, warm_ms, _ = counted("dense warm", lambda: solve_scheduling(
        flag, meta, small_to_oracle=False, warm=cold.state, device=DEVICE),
        ("densify",))
    log(f"[general] front door dense path: cold backend={cold.backend} "
        f"cost={cold.cost} wall_ms={cold_ms:.3f}; warm backend="
        f"{warm.backend} cost={warm.cost} wall_ms={warm_ms:.3f}; "
        f"oracle={want}")
    if {cold.backend, warm.backend} != {"dense_auction"} or \
            cold.cost != want or warm.cost != want:
        raise AssertionError("[general] front door dense path != oracle")
    return {"cs_sweep": cs_counts["cs_sweep"],
            "bf_relax": cs_counts["bf_relax"],
            "ssp_augment": ssp_counts["ssp_augment"]}


# ---------------------------------------------------------------------------
# [ha], [observe], [chaos]: crash safety, the observability tools and chaos
# ---------------------------------------------------------------------------
#
# Each daemon of these phases runs in a child process of its own
# (``daemon_child``) against the flagship served by ``ApiServerProcess``:
# a daemon can then be SIGKILLed while it holds a CUDA context, and a
# restarted one starts in a fresh process as a real restart would. The
# child speaks one JSON message a line on stdout (prefixed ``@@ ``) and
# waits after every round for the parent's reply on stdin, so bursts of
# pods land between rounds deterministically.

HA_PREFIX = "@@ "
HA_LEASE_S = 2.0
# the standby's rounds after its takeover: round 4 (its first, after
# replaying the journal of the leader it replaced) and round 5
HA_STANDBY_ROUNDS = 2
# the auction's round fuse (``ops.dense_auction.default_fuse``)
FUSE_ROUNDS = 20_000
# Rounds of these phases whose warm and cold solves both run out the
# fuse, in both packages: the flagship daemon's fifth round (about 930
# pending pods, the backlog quincy left unscheduled) runs it out with
# or without a crash before it, and the reference's replay of the
# standby's round-5 flight-recorder dump (cold) runs it out too
# (PERF.md section 5; ROADMAP Queue 3, "Fuse exhaustion"). Only these
# rounds may degrade to the oracle.
HA_FUSE_ROUNDS = {("[ha] S", 5)}
HA_BURST = 16
# the flagship in these phases, or a small cluster when the phases are
# rehearsed on a host without a card (``DEVICE = "cpu"``)
REHEARSAL_SHAPE = (100, 1000)


def rehearsal_cluster():
    from poseidon_tpu_torch.synth import make_synthetic_cluster

    return make_synthetic_cluster(*REHEARSAL_SHAPE, seed=0)


def oracle_round_cost(device, view, know, model: str = "quincy") -> int:
    """The C++ oracle's optimum of the round the daemon solved: the
    bridge's view at the round's begin priced as the round priced it."""
    import numpy as np

    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.models import get_cost_model
    from poseidon_tpu_torch.models.costs import build_cost_inputs
    from poseidon_tpu_torch.oracle import solve_oracle

    usage, load, mem_free = know
    pending = view.pending()
    net, meta = FlowGraphBuilder().build(view)
    inputs = build_cost_inputs(
        net, meta, device=device,
        task_cpu_milli=np.array([int(t.cpu_request * 1000) for t in pending]),
        task_mem_kb=np.array([t.memory_request_kb for t in pending]),
        task_usage=usage, machine_load=load, machine_mem_free=mem_free,
    )
    cost = get_cost_model(model)(inputs)
    return solve_oracle(net.with_costs(cost), algorithm="cost_scaling").cost


def oracle_bridge(base, st: dict):
    """``base`` (the CLI's bridge class) keeping, in ``st``, each dense
    round's input view (``snaps``) for the oracle check, whether the
    round started from the warm state (``warm``) and the live bridge
    (``bridge``)."""

    class OracleBridge(base):
        def cluster_state(self):
            # the view the round builds from: begin_round takes it
            # after admitting the round's staged-requeue wave
            view = super().cluster_state()
            st["view"] = view
            return view

        def begin_round(self):
            st["bridge"] = self
            st["view"] = None
            ir = super().begin_round()
            view = st["view"]
            if ir.result is None:
                uids = [t.uid for t in view.pending()]
                names = [m.name for m in view.machines]
                know = (self.knowledge.task_cpu_usage(uids),
                        self.knowledge.machine_load(names),
                        self.knowledge.machine_mem_free(names))
                st["snaps"][ir.stats.round_num] = (view, know)
                st["warm"][ir.stats.round_num] = bool(
                    getattr(ir.solve, "warm_used", False))
            return ir

    return OracleBridge


def _http_get(port: int, route: str) -> str:
    import urllib.request

    with urllib.request.urlopen(
        f"http://127.0.0.1:{port}{route}", timeout=10
    ) as resp:
        return resp.read().decode()


def daemon_child() -> int:
    """One daemon of the [ha] and [observe] phases (``sys.argv[1]`` is
    its JSON spec): ``cli.main`` with the spec's flags, every dense
    round held against the C++ oracle and its kernel launches counted,
    the crash-safety and observability tools timed where they run.
    Spec keys: ``argv``; ``kill_round`` (SIGKILL itself in that round's
    actuation, after half its binding POSTs landed); ``sync_ckpt``
    (rounds whose checkpoint write it waits for); ``pause_round`` (after
    that round's checkpoint is on disk, keep the lease and wait for the
    parent's next line); ``dump_round`` (an on-demand flight dump after that
    round's hook); ``audit_dir`` (pickle each audited snapshot
    there)."""
    import inspect
    import logging
    import os
    import pickle
    import signal
    import threading

    import torch

    from poseidon_tpu_torch import cli, kernels
    from poseidon_tpu_torch import ha as ha_pkg
    from poseidon_tpu_torch.ha import checkpoint as ckpt_mod
    from poseidon_tpu_torch.ha import standby as standby_mod
    from poseidon_tpu_torch.obs import audit as audit_mod
    from poseidon_tpu_torch.obs import flightrec as fr_mod

    spec = json.loads(sys.argv[1])
    args = cli.parse_args(spec["argv"])
    device = torch.device(args.device)
    lock = threading.Lock()
    st = {"snaps": {}, "warm": {}, "capture_us": {}, "ckpt_write_ms": [],
          "audits": [], "captures": 0, "lease": None, "bridge": None}

    def emit(**kw):
        print(HA_PREFIX + json.dumps(kw, default=str), flush=True)

    def wrap(owner, name, around):
        """Replace ``owner.name`` by a wrapper that takes any arguments
        and calls ``around(call, bound)``: ``call()`` runs the original,
        ``bound`` maps its parameter names to this call's arguments (a
        parameter the port renames fails here, at the wrapper, by
        name)."""
        orig = getattr(owner, name)
        sig = inspect.signature(orig)

        def wrapper(*a, **kw):
            bound = sig.bind(*a, **kw)
            bound.apply_defaults()
            return around(lambda: orig(*a, **kw), bound.arguments)

        setattr(owner, name, wrapper)
        return orig

    def timed(owner, name, sink):
        """``owner.name`` timed: ``sink(ms, result, arguments)``."""

        def around(call, bound):
            t0 = time.perf_counter()
            out = call()
            sink((time.perf_counter() - t0) * 1e3, out, bound)
            return out

        wrap(owner, name, around)

    # what the port does not publish: the background checkpoint
    # writer's, the restore's, the journal replay's and the flight
    # recorder's capture times, the standby's first followed checkpoint
    # and the shadow audit's results as they complete (the restored
    # checkpoint and the replay outcomes come from the trace: RESTORE
    # and JOURNAL_REPLAY)
    def write_ms(ms, _out, _a):
        with lock:
            st["ckpt_write_ms"].append(ms)

    timed(ckpt_mod.CheckpointManager, "write_sync", write_ms)
    timed(ha_pkg, "restore_bridge",
          lambda ms, _out, _a: st.update(restore_ms=ms))
    timed(ha_pkg, "replay_journal",
          lambda ms, _out, _a: st.update(replay_ms=ms))

    def capture_us(ms, _out, _a):
        rn = st["bridge"].round_num if st["bridge"] is not None else 0
        st["capture_us"][rn] = st["capture_us"].get(rn, 0.0) + ms * 1e3

    timed(fr_mod.FlightRecorder, "capture_begin", capture_us)
    timed(fr_mod.FlightRecorder, "capture_finish", capture_us)

    def captured(_ms, out, _a):
        if out:
            with lock:
                st["captures"] += 1

    timed(audit_mod.ShadowAuditor, "capture", captured)

    def following(_ms, out, _a):
        if out[0] is not None and not st.get("following"):
            st["following"] = True
            emit(following=out[0].round_num)

    timed(standby_mod, "follow_checkpoints", following)

    def audited(_ms, out, bound):
        if spec.get("audit_dir"):
            # the captured snapshot, for a comparison with the
            # reference's audit of the same snapshot off the card
            with open(f"{spec['audit_dir']}/audit-{out.round_num}.pkl",
                      "wb") as fh:
                pickle.dump(bound["snap"], fh)
        st["audits"].append(out)

    timed(audit_mod.ShadowAuditor, "_process", audited)

    cli.SchedulerBridge = oracle_bridge(cli.SchedulerBridge, st)

    def post(call, bound):
        bridge, bindings = bound["bridge"], bound["bindings"]
        if spec.get("kill_round") == bridge.round_num and bindings:
            items = list(bindings.items())
            half = dict(items[: len(items) // 2])
            out = orig_post(**{**bound, "bindings": half})
            with lock:
                writes = list(st["ckpt_write_ms"])
            emit(killed=bridge.round_num, posted=len(half),
                 of=len(items), ok=sum(o == "ok" for _, _, o in out),
                 ckpt_write_ms=writes)
            os.kill(os.getpid(), signal.SIGKILL)
        return call()

    orig_post = wrap(cli, "_post_bindings", post)

    def take(call, bound):
        ckpt_mgr, bridge = bound["ckpt_mgr"], bound["bridge"]
        n0 = ckpt_mgr.writes_total
        call()
        rn = bridge.round_num
        if bound["final"] or rn not in spec.get("sync_ckpt", ()):
            return
        deadline = time.monotonic() + 120
        while ckpt_mgr.writes_total <= n0:
            if time.monotonic() > deadline:
                raise AssertionError(f"checkpoint of round {rn} not written")
            time.sleep(0.01)
        with lock:
            writes = list(st["ckpt_write_ms"])
        emit(checkpointed=rn, path=ckpt_mgr.last_path, ckpt_write_ms=writes)
        if spec.get("pause_round") == rn:
            # alive and leading until the parent's next line: the lease
            # is renewed as the loop's ticks would renew it
            resumed = threading.Event()

            def renew():
                while not resumed.wait(HA_LEASE_S / 4):
                    if st["lease"] is not None:
                        st["lease"].renew()

            threading.Thread(target=renew, daemon=True).start()
            line = sys.stdin.readline()
            resumed.set()
            if not line:
                raise SystemExit(3)

    wrap(cli, "_take_checkpoint", take)
    t_begin = {}

    def hook(rounds, result):
        s = result.stats
        bridge = st["bridge"]
        solver = bridge.solver
        launched = {k.name: k.launches - t_begin.get(k.name, 0)
                    for k in kernels.KERNELS}
        t_begin.update({k.name: k.launches for k in kernels.KERNELS})
        rec = dict(
            round=s.round_num, pending=s.pods_pending, placed=s.pods_placed,
            unsched=s.pods_unscheduled, backend=s.backend, cost=s.cost,
            wall_ms=s.wall_ms, solve_ms=s.solve_ms, build=s.build_mode,
            fetches=solver.last_round_fetches,
            solves=solver.last_round_solves,
            loop_syncs=solver.last_round_loop_syncs, launched=launched,
            auction_rounds=solver.last_round_auction_rounds,
            warm=st["warm"].get(s.round_num), n_bindings=len(result.bindings),
            capture_us=st["capture_us"].get(s.round_num),
        )
        snap = st["snaps"].get(s.round_num)
        if snap is not None and s.backend in ("dense_auction",
                                              "oracle:uncertified"):
            t0 = time.perf_counter()
            rec["oracle"] = oracle_round_cost(
                device, *snap, model=args.flow_scheduling_cost_model)
            rec["oracle_ms"] = (time.perf_counter() - t0) * 1e3
        if bridge.auditor is not None:
            deadline = time.monotonic() + 300
            while len(st["audits"]) < st["captures"]:
                if time.monotonic() > deadline:
                    raise AssertionError("the shadow audit never finished")
                time.sleep(0.02)
            rec["audits"] = [dict(round=a.round_num, regret=a.regret,
                                  sq=a.status_quo_cost, opt=a.optimal_cost,
                                  drift=a.drift_pods, ms=a.audit_ms,
                                  error=a.error) for a in st["audits"]]
        if args.metrics_port:
            rec["readyz"] = _http_get(args.metrics_port, "/readyz")
            if args.slo:
                rec["slo"] = json.loads(_http_get(args.metrics_port, "/slo"))
        if rounds == 1 and "restore_ms" in st:
            rec["restore"] = dict(restore_ms=st["restore_ms"],
                                  replay_ms=st.get("replay_ms"))
        with lock:
            rec["ckpt_write_ms"] = list(st["ckpt_write_ms"])
        if spec.get("dump_round") == s.round_num:
            t0 = time.perf_counter()
            rec["dump"] = bridge.flight_dump("manual", label="chip_smoke")
            rec["dump_ms"] = (time.perf_counter() - t0) * 1e3
        emit(round=rec)
        if not sys.stdin.readline():
            raise SystemExit(3)

    def run(call, bound):
        st["lease"] = bound["lease"]
        emit(started=time.time(), lease=bound["lease"] is not None,
             preloaded=None if bound["preloaded"] is None
             else bound["preloaded"].round_num)
        return orig_run(**{**bound, "round_hook": hook})

    orig_run = wrap(cli, "run_loop", run)
    # one INFO line per placement would flood the log
    logging.getLogger("poseidon_tpu_torch.bridge.bridge").setLevel(
        logging.WARNING)
    kernels.reset_launch_counts()
    rc = cli.main(spec["argv"])
    bridge = st["bridge"]
    placed = ({u: t.machine for u, t in bridge.tasks.items() if t.machine}
              if bridge is not None else {})
    sys.stdout.flush()
    with lock:
        writes = list(st["ckpt_write_ms"])
    emit(exit=rc, placed=placed, ckpt_write_ms=writes)
    return 0


class DaemonChild:
    """A ``daemon_child`` process: its protocol messages, the other
    lines it printed, and a watchdog that kills it at ``timeout_s``."""

    def __init__(self, spec: dict, name: str, timeout_s: float = 600.0):
        import os
        import tempfile
        import threading

        root = os.path.dirname(os.path.abspath(__file__))
        self.name = name
        self.err = tempfile.NamedTemporaryFile(
            "w+", prefix=f"chip-smoke-{name}-", suffix=".log", delete=False)
        self.proc = subprocess.Popen(
            [sys.executable, "-c",
             "import sys, chip_smoke; sys.exit(chip_smoke.daemon_child())",
             json.dumps(spec)],
            cwd=root, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=self.err, text=True,
        )
        self.lines: list[str] = []
        self.watchdog = threading.Timer(timeout_s, self.kill)
        self.watchdog.daemon = True
        self.watchdog.start()

    def next(self) -> dict | None:
        """The next protocol message, or None once the child exited."""
        while True:
            line = self.proc.stdout.readline()
            if not line:
                return None
            if line.startswith(HA_PREFIX):
                return json.loads(line[len(HA_PREFIX):])
            self.lines.append(line.rstrip("\n"))

    def expect(self, key: str) -> dict:
        msg = self.next()
        while msg is not None and "checkpointed" in msg and \
                key != "checkpointed":
            msg = self.next()  # a synced checkpoint it was not asked for
        if msg is None or key not in msg:
            raise AssertionError(
                f"{self.name}: expected {key!r}, got {msg!r}; stderr "
                f"tail:\n{self.tail()}")
        return msg

    def go(self) -> None:
        self.proc.stdin.write("go\n")
        self.proc.stdin.flush()

    def kill(self) -> None:
        import signal

        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGKILL)

    def wait(self) -> int:
        rc = self.proc.wait(timeout=120)
        self.watchdog.cancel()
        return rc

    def tail(self, n: int = 4000) -> str:
        self.err.flush()
        with open(self.err.name) as fh:
            return fh.read()[-n:]

    def close(self) -> None:
        import os

        self.kill()
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            pass
        self.watchdog.cancel()
        self.err.close()
        os.unlink(self.err.name)


def check_dense_round(tag: str, rec: dict, known_fuse: bool = False) -> None:
    """A dense round of a child daemon: certified on the dense path, its
    cost equal to the C++ oracle's, one result fetch per auction solve,
    K1-K3 launched. ``known_fuse`` names a round whose warm and cold
    solves both run out the 20,000-round fuse in both packages (the
    reference's replay of the round's flight-recorder dump runs it out
    too; ROADMAP Queue 3, "Fuse exhaustion"): only such a round may
    degrade to the oracle, and then it is held to the independent
    oracle's cost, to a fuse's worth of loop reads a solve, and to one
    fetch a solve plus the fallback's read of the priced arcs; each of
    its solves ran FUSE_ROUNDS auction rounds (read with its fetch: on
    the card the loop is one graph and makes no loop read)."""
    if rec["backend"] == "oracle:uncertified" and known_fuse:
        if (rec.get("oracle") != rec["cost"]
                or rec["fetches"] != rec["solves"] + 1
                or rec["auction_rounds"] != [FUSE_ROUNDS] * rec["solves"]):
            raise AssertionError(f"{tag} round {rec['round']}: degraded "
                                 f"round {rec}")
        log(f"{tag} round {rec['round']}: DEGRADED to the oracle after "
            f"{rec['solves']} solves ran out the fuse (auction rounds "
            f"{rec['auction_rounds']}, {rec['loop_syncs']} loop reads, "
            f"solve_ms={rec['solve_ms']:.3f}); cost == the independent "
            f"oracle's (ROADMAP Queue 3, fuse exhaustion)")
        return
    if rec["backend"] != "dense_auction":
        raise AssertionError(f"{tag} round {rec['round']}: backend "
                             f"{rec['backend']}")
    if rec.get("oracle") != rec["cost"]:
        raise AssertionError(f"{tag} round {rec['round']}: cost "
                             f"{rec['cost']} != oracle {rec.get('oracle')}")
    if rec["fetches"] != rec["solves"]:
        raise AssertionError(f"{tag} round {rec['round']}: "
                             f"{rec['fetches']} fetches for "
                             f"{rec['solves']} solves")
    idle = [n for n in ROUND_KERNELS if rec["launched"][n] == 0]
    if idle and DEVICE == "cuda":  # a CPU rehearsal runs the twins
        raise AssertionError(f"{tag} round {rec['round']}: kernels not "
                             f"launched: {idle}")


def round_line(tag: str, rec: dict) -> str:
    return (f"{tag} round {rec['round']}: pending={rec['pending']} "
            f"placed={rec['placed']} unsched={rec['unsched']} "
            f"build={rec['build']} warm_start={rec['warm']} "
            f"wall_ms={rec['wall_ms']:.3f} solve_ms={rec['solve_ms']:.3f} "
            f"backend={rec['backend']} cost={rec['cost']} "
            f"oracle_cost={rec.get('oracle')} solves={rec['solves']} "
            f"fetches={rec['fetches']} loop_syncs={rec['loop_syncs']} "
            f"launches={ {k: v for k, v in rec['launched'].items() if v} }")


def exactly_once(op_log) -> list[str]:
    """Pods bound twice in the apiserver's ordered op log without an
    eviction or a node-death orphaning in between."""
    bound, doubles = {}, []
    for op, pod, node in op_log:
        if op == "bind":
            if pod in bound:
                doubles.append(f"{pod}: {bound[pod]} then {node}")
            bound[pod] = node
        elif op in ("evict", "orphan"):
            bound.pop(pod, None)
    return doubles


def percentile(xs, q: float) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(xs, float), q)) if xs else 0.0


def _ha_argv(server, device: str, ckpt_dir: str, *extra) -> list[str]:
    return [
        "--k8s_apiserver_host=127.0.0.1",
        f"--k8s_apiserver_port={server.port}", f"--device={device}",
        "--flow_scheduling_cost_model=quincy",
        "--run_incremental_scheduler=true", "--incremental_build=true",
        "--round_pipeline=false", "--polling_frequency=1000",
        f"--checkpoint_dir={ckpt_dir}", "--checkpoint_every=1", *extra,
    ]


def _free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _trace_events(path: str) -> list[dict]:
    with open(path) as fh:
        return [json.loads(line) for line in fh if line.strip()]


def ha_phase(torch, card: str, keep_dir: str | None = None) -> None:
    """Crash safety on the card over the flagship daemon. Daemon A
    checkpoints every round and is SIGKILLed in round 3's actuation
    (half its binding POSTs landed); daemon B restores round 2's
    checkpoint, replays the journal, runs round 3 and is SIGKILLed in
    round 4's actuation; a standby that follows B's checkpoints takes
    over, restores round 3's checkpoint, replays B's journal and runs
    rounds 4 and 5. Every pod is bound at most once in the apiserver's
    op log, none is lost, each replay settles every intent of the round
    its leader died in, the restored first rounds start warm, and every
    dense round is certified and equals the C++ oracle with one fetch a
    solve, but for the named fuse round (``HA_FUSE_ROUNDS``), which the
    standby's flight recorder dumps as a degrade (into ``keep_dir``
    when given, for ``tests/replay_cold.py``)."""
    import collections
    import os
    import shutil
    import tempfile

    log(f"[ha] card: {card}")
    rehearsal = DEVICE != "cuda"
    work = tempfile.mkdtemp(prefix="chip-smoke-ha-")
    ckpt = f"{work}/ckpt"
    server = ApiServerProcess(seed=0, rehearsal=rehearsal)
    children = []
    try:
        def start(spec, name):
            child = DaemonChild(spec, name)
            children.append(child)
            return child

        burst_no = iter(range(100))

        def burst():
            server.call("burst", [next(burst_no), HA_BURST])

        def rounds_of(child, tag, n, bursts=True):
            """n rounds of ``child``, each checked; a burst of pods
            lands after each (before the next round observes)."""
            out = []
            for _ in range(n):
                rec = child.expect("round")["round"]
                log(round_line(tag, rec))
                if rec["backend"]:  # an empty round has no backend
                    check_dense_round(
                        tag, rec, (tag, rec["round"]) in HA_FUSE_ROUNDS)
                out.append(rec)
                if bursts:
                    burst()
                child.go()
            return out

        # ---- daemon A: three rounds, killed in round 3's actuation ----
        trace_a = f"{work}/trace-a.jsonl"
        a = start(dict(argv=_ha_argv(server, DEVICE, ckpt,
                                     f"--trace_log={trace_a}"),
                       kill_round=3, sync_ckpt=[2]), "A")
        a.expect("started")
        recs_a = rounds_of(a, "[ha] A", 2)
        killed = a.expect("killed")
        if a.next() is not None or a.wait() != -9:
            raise AssertionError("[ha] A was not killed in round 3")
        log(f"[ha] A SIGKILLed in round {killed['killed']}'s actuation "
            f"after {killed['ok']} of {killed['of']} binding POSTs landed")
        if not 0 < killed["ok"] < killed["of"]:
            raise AssertionError("[ha] A's kill did not land mid-actuation")
        burst()

        # ---- daemon B: --restore=true, round 3, killed in round 4 -------
        port_b = _free_port()
        trace_b = f"{work}/trace-b.jsonl"
        b = start(dict(argv=_ha_argv(
            server, DEVICE, ckpt, "--restore=true", "--standby=true",
            f"--standby_lease_s={HA_LEASE_S}", f"--trace_log={trace_b}",
            f"--metrics_port={port_b}", "--metrics_host=127.0.0.1"),
            kill_round=4, sync_ckpt=[3], pause_round=3), "B")
        started_b = b.expect("started")
        recs_b = rounds_of(b, "[ha] B", 1)
        held = b.expect("checkpointed")

        # ---- the standby follows B; B is killed; it takes over ----------
        trace_s = f"{work}/trace-s.jsonl"
        port_s = _free_port()
        flight_s = (f"{os.path.abspath(keep_dir)}/ha-standby" if keep_dir
                    else f"{work}/flight-s")
        s = start(dict(argv=_ha_argv(
            server, DEVICE, ckpt, "--standby=true",
            f"--standby_lease_s={HA_LEASE_S}", f"--trace_log={trace_s}",
            f"--metrics_port={port_s}", "--metrics_host=127.0.0.1",
            f"--max_rounds={HA_STANDBY_ROUNDS}", "--flight_recorder=true",
            f"--flight_dir={flight_s}")), "S")
        followed = s.expect("following")["following"]
        if followed != held["checkpointed"]:
            raise AssertionError(f"[ha] the standby follows round "
                                 f"{followed}, not B's last checkpoint")
        b.go()  # B runs round 4 and is killed in its actuation
        killed_b = b.expect("killed")
        if b.next() is not None or b.wait() != -9:
            raise AssertionError("[ha] B was not killed in round 4")
        t_kill = time.time()
        log(f"[ha] B SIGKILLed in round {killed_b['killed']}'s actuation "
            f"after {killed_b['ok']} of {killed_b['of']} binding POSTs "
            f"landed")
        if not 0 < killed_b["ok"] < killed_b["of"]:
            raise AssertionError("[ha] B's kill did not land mid-actuation")
        burst()
        started_s = s.expect("started")
        takeover_s = started_s["started"] - t_kill
        recs_s = rounds_of(s, "[ha] S", HA_STANDBY_ROUNDS)
        done = s.expect("exit")
        if done["exit"] != 0 or s.wait() != 0:
            raise AssertionError(f"[ha] the standby exited {done['exit']}")
        takeover_round_s = time.time() - t_kill

        # ---- checks --------------------------------------------------------
        op_log = server.call("op_log")
        doubles = exactly_once(op_log)
        if doubles:
            raise AssertionError(f"[ha] exactly-once violated: {doubles[:5]}")
        bound = {k: v for k, v in server.call("bound").items() if v}
        placed = {u: m for u, m in done["placed"].items()}
        if bound != placed:
            lost = sorted(set(placed) - set(bound))[:5]
            raise AssertionError(
                f"[ha] server bindings ({len(bound)}) != the standby's "
                f"placements ({len(placed)}); e.g. {lost}")
        replays = {}
        for tag, started, recs, trace, from_round in (
                ("B", started_b, recs_b, trace_b, 2),
                ("S", started_s, recs_s, trace_s, held["checkpointed"])):
            first = recs[0]
            events = _trace_events(trace)
            restore = [e for e in events if e["event"] == "RESTORE"]
            if (len(restore) != 1 or not restore[0]["detail"]["warm"]
                    or restore[0]["detail"]["round"] != from_round
                    or not started["lease"]):
                raise AssertionError(f"[ha] {tag}: RESTORE {restore}, "
                                     f"expected round {from_round}")
            if not first["warm"]:
                raise AssertionError(f"[ha] {tag}: the first round after "
                                     f"the restore started cold")
            if "restored_warm=true" not in first["readyz"]:
                raise AssertionError(f"[ha] {tag}: /readyz "
                                     f"{first['readyz']!r}")
            replays[tag] = collections.Counter(
                e["detail"]["outcome"] for e in events
                if e["event"] == "JOURNAL_REPLAY")
            r = first["restore"]
            log(f"[ha] {tag}: restored checkpoint round "
                f"{restore[0]['detail']['round']} (warm), "
                f"restore_ms={r['restore_ms']:.3f} journal "
                f"replay_ms={r['replay_ms']:.3f} outcomes="
                f"{dict(replays[tag])} "
                f"readyz={first['readyz'].strip()!r}; first round "
                f"solves={first['solves']} (a warm start that does not "
                f"certify re-runs cold: ROADMAP Queue 3)")
        # the recorder dumps each degraded round of the standby's
        dumped = {e["round_num"]: e["detail"]["path"]
                  for e in _trace_events(trace_s)
                  if e["event"] == "FLIGHTREC_DUMP"
                  and e["detail"]["reason"] == "degrade"}
        degraded = {r["round"] for r in recs_s
                    if r["backend"] == "oracle:uncertified"}
        if set(dumped) != degraded:
            raise AssertionError(f"[ha] degrade dumps of rounds "
                                 f"{sorted(dumped)}, degraded rounds "
                                 f"{sorted(degraded)}")
        for rn, path in sorted(dumped.items()):
            log(f"[ha] S round {rn}: the flight recorder dumped it as a "
                f"degrade: {path}")
        for tag, intents in (("B", killed), ("S", killed_b)):
            settled = replays[tag]["replayed"] + \
                replays[tag]["already-applied"]
            if settled != intents["of"] or not replays[tag]["replayed"]:
                raise AssertionError(
                    f"[ha] {tag}'s journal replay {dict(replays[tag])} "
                    f"does not settle the {intents['of']} intents of the "
                    f"round its leader was killed in")
        writes = (killed["ckpt_write_ms"] + killed_b["ckpt_write_ms"]
                  + done["ckpt_write_ms"])
        log(f"[ha] checkpoint write ms (background writer, n={len(writes)}):"
            f" p50={percentile(writes, 50):.3f} max={max(writes):.3f}; "
            f"takeover: standby leading {takeover_s:.3f} s after B's "
            f"SIGKILL (lease {HA_LEASE_S} s), its first round done "
            f"{takeover_round_s:.3f} s after; {len(op_log)} apiserver ops, "
            f"{len(bound)} pods bound exactly once, none lost")
    finally:
        for child in children:
            child.close()
        server.close()
        shutil.rmtree(work, ignore_errors=True)


def ha_control_phase(torch, card: str, rounds: int = 6) -> None:
    """[ha]'s flagship daemon and bursts without a crash, a restore or a
    standby: ``rounds`` rounds of one daemon, each held to the C++
    oracle as in [ha]. A round that runs out the fuse may degrade here
    (it is printed, held to the oracle's cost and to a fuse's worth of
    loop reads a solve): this phase shows which rounds of the sequence
    do so with no crash-safety path involved. It runs only when named
    (``--phases=ha_control``)."""
    import shutil
    import tempfile

    log(f"[ha_control] card: {card}")
    work = tempfile.mkdtemp(prefix="chip-smoke-ha-control-")
    server = ApiServerProcess(seed=0, rehearsal=DEVICE != "cuda")
    child = None
    try:
        child = DaemonChild(dict(argv=_ha_argv(
            server, DEVICE, f"{work}/ckpt", f"--max_rounds={rounds}")), "C")
        child.expect("started")
        for i in range(rounds):
            rec = child.expect("round")["round"]
            log(round_line("[ha_control]", rec))
            if rec["backend"]:
                check_dense_round("[ha_control]", rec, known_fuse=True)
            server.call("burst", [i, HA_BURST])
            child.go()
        done = child.expect("exit")
        if done["exit"] != 0 or child.wait() != 0:
            raise AssertionError(f"[ha_control] the daemon exited "
                                 f"{done['exit']}")
    finally:
        if child is not None:
            child.close()
        server.close()
        shutil.rmtree(work, ignore_errors=True)


def observe_phase(torch, card: str, daemon_round1=None,
                  audit_dir: str | None = None) -> list[dict]:
    """The observability tools on the card over the flagship daemon, 3
    rounds: the flight recorder, the shadow audit every round, one SLO
    objective on the metrics port, checkpoints, and ``--explain`` of a
    pod that arrived for round 3 (``--explain`` answers from the last
    captured round; a pod placed in round 2 is Running by then, outside
    round 3's place-only graph); then an on-demand dump replayed on the
    card bit for bit, the explanation, ``validate`` of an unscheduled
    pod's diagnosis, the audit's regret 0, and ``/slo`` served.
    ``audit_dir`` keeps each audited snapshot and the port's results
    there (``tests/audit_against_reference.py`` audits the same
    snapshots with the reference). Returns the audits."""
    import os
    import shutil
    import tempfile

    from poseidon_tpu_torch.obs.explain import RoundExplainer
    from poseidon_tpu_torch.obs.flightrec import load_dump
    from poseidon_tpu_torch.obs.replay import render_report, replay_dump

    log(f"[observe] card: {card}")
    if audit_dir is not None:
        audit_dir = os.path.abspath(audit_dir)
        os.makedirs(audit_dir, exist_ok=True)
    rehearsal = DEVICE != "cuda"
    work = tempfile.mkdtemp(prefix="chip-smoke-observe-")
    server = ApiServerProcess(seed=0, rehearsal=rehearsal)
    target = "default/pod-x1-000"  # burst 1 arrives for round 3
    port = _free_port()
    child = None
    try:
        child = DaemonChild(dict(argv=_ha_argv(
            server, DEVICE, f"{work}/ckpt", "--max_rounds=3",
            "--flight_recorder=true", f"--flight_dir={work}/fr",
            "--audit_every=1", "--slo=regret == 0",
            f"--metrics_port={port}", "--metrics_host=127.0.0.1",
            f"--explain={target}"), dump_round=3, audit_dir=audit_dir),
            "observe")
        child.expect("started")
        recs = []
        for i in range(3):
            rec = child.expect("round")["round"]
            log(round_line("[observe]", rec) +
                f" capture_us={rec['capture_us']}")
            if rec["backend"]:
                check_dense_round("[observe]", rec)
            recs.append(rec)
            if i < 2:
                # the next round's arrivals, beside the backlog quincy
                # left unscheduled
                server.call("burst", [i, HA_BURST])
            child.go()
        done = child.expect("exit")
        if done["exit"] != 0 or child.wait() != 0:
            raise AssertionError(f"[observe] the daemon exited "
                                 f"{done['exit']}:\n{child.tail()}")

        # the sync budget: capture, checkpoint and audit add no read
        r1 = recs[0]
        if r1["fetches"] != 1:
            raise AssertionError(f"[observe] round 1: {r1['fetches']} "
                                 f"fetches")
        if r1["loop_syncs"] != 0 and DEVICE == "cuda":
            raise AssertionError(f"[observe] round 1: {r1['loop_syncs']} "
                                 f"loop reads (the loop is one graph)")
        if daemon_round1 is not None and (
                r1["auction_rounds"], r1["cost"]) != daemon_round1:
            raise AssertionError(
                f"[observe] round 1 (auction rounds, cost) "
                f"{(r1['auction_rounds'], r1['cost'])} != the [daemon] "
                f"poll lane's {daemon_round1} with the tools off")
        # the audit: regret 0 on the placement of one certified round
        # (round 1's, audited at round 2); later audits measure the
        # union of several place-only rounds, which no round promised
        # to be jointly optimal: their regret is reported
        audits = recs[-1]["audits"]
        if (not audits or any(a["error"] for a in audits)
                or audits[0]["round"] != 2 or audits[0]["regret"] != 0
                or any(a["regret"] != a["sq"] - a["opt"] or a["regret"] < 0
                       for a in audits)):
            raise AssertionError(f"[observe] audits {audits}")
        if audit_dir is not None:
            with open(f"{audit_dir}/audits.json", "w") as fh:
                json.dump(audits, fh)
        # /slo served, one objective, one evaluation a round
        slo = recs[-1]["slo"]
        if len(slo["objectives"]) != 1 or slo["evaluations"] != 3:
            raise AssertionError(f"[observe] /slo {slo}")
        # the on-demand dump, replayed on the card bit for bit
        dump_path = recs[-1]["dump"]
        dump = load_dump(dump_path)
        t0 = time.perf_counter()
        report = replay_dump(dump, device=DEVICE)
        replay_ms = (time.perf_counter() - t0) * 1e3
        if report["identical"] is not True or not all(
                r["ok"] for r in report["records"]):
            raise AssertionError(render_report(report))
        # the explanation the daemon printed at exit
        text = "\n".join(child.lines)
        if f"== explain {target} ==" not in text or \
                "sums exactly" not in text:
            raise AssertionError(f"[observe] --explain printed:\n{text}")
        for line in text.splitlines():
            log(f"[observe] explain: {line}")
        # validate: an unscheduled pod's minimal relaxation places it
        rec = [r for r in dump["records"] if r.kind == "round"][-1]
        ex = RoundExplainer.from_record(rec, device=DEVICE)
        unsched = rec.result["unscheduled"]
        if not unsched:
            raise AssertionError("[observe] no unscheduled pod to validate")
        expl = ex.explain(unsched[0])
        t0 = time.perf_counter()
        verdict = ex.validate(expl)
        validate_ms = (time.perf_counter() - t0) * 1e3
        if not verdict["ok"]:
            raise AssertionError(f"[observe] validate {expl} -> {verdict}")
        warm = [(r["round"], r["capture_us"], r["wall_ms"],
                 r["capture_us"] / 1e3 / r["wall_ms"])
                for r in recs if r["backend"] and r["round"] > 1]
        log(f"[observe] capture_us a round "
            f"{[r['capture_us'] for r in recs]}; warm rounds (round, "
            f"capture_us, wall_ms, capture share) {warm} (the reference "
            f"bounded the share at 0.02 of a churned-warm round; not a "
            f"gate); dump_ms={recs[-1]['dump_ms']:.3f} "
            f"({len(dump['records'])} records) replay_ms={replay_ms:.3f} "
            f"({report['compared']} records bit-identical on {DEVICE}); "
            f"audits (round, regret, status quo, optimum, drift pods, "
            f"audit_ms) {[(a['round'], a['regret'], a['sq'], a['opt'], a['drift'], round(a['ms'], 3)) for a in audits]}"
            f"; validate({unsched[0]}: "
            f"{expl.diagnosis}) -> {verdict} in {validate_ms:.3f} ms; "
            f"/slo {slo['objectives'][0]['spec']!r} healthy="
            f"{slo['objectives'][0]['healthy']}")
        return audits
    finally:
        if child is not None:
            child.close()
        server.close()
        shutil.rmtree(work, ignore_errors=True)


# the scaled scenario: the composite at 80 nodes (above the oracle's
# 64-machine threshold, 67 after its storm) x 320 pods, so its rounds run
# K1-K3 on the card: the burst whose POSTs ride into the outage, the
# storm's staged drain and the post-fault burst; held in both packages
# on the CPU by tests/test_torch_chaos.py
CHAOS_SCALED = dict(nodes=80, pods=320)


def chaos_child() -> int:
    """The [chaos] phase's daemons, in a process of their own: the
    reference's four scenarios at their own sizes and seeds, then the
    scaled composite; one JSON line per scenario."""
    import logging
    import tempfile

    import torch

    from poseidon_tpu_torch import cli, kernels
    from poseidon_tpu_torch.chaos import (
        check_invariants,
        rounds_to_recover,
        run_daemon_scenario,
        scenario_composite,
    )
    from poseidon_tpu_torch.chaos.scenarios import SCENARIOS

    device = sys.argv[1]
    st = {"snaps": {}, "warm": {}, "checked": [], "bridge": None}
    cli.SchedulerBridge = oracle_bridge(cli.SchedulerBridge, st)
    orig_run = cli.run_loop

    def run(args, stop_event=None, lease=None, preloaded=None,
            round_hook=None):
        def hook(rounds, result):
            s = result.stats
            if s.backend == "dense_auction":
                bridge = st["bridge"]
                want = oracle_round_cost(
                    torch.device(device), *st["snaps"][s.round_num],
                    model=args.flow_scheduling_cost_model)
                st["checked"].append(dict(
                    round=s.round_num, cost=s.cost, oracle=want,
                    fetches=bridge.solver.last_round_fetches,
                    solves=bridge.solver.last_round_solves))
            if round_hook is not None:
                round_hook(rounds, result)

        return orig_run(args, stop_event=stop_event, lease=lease,
                        preloaded=preloaded, round_hook=hook)

    cli.run_loop = run
    logging.getLogger("poseidon_tpu_torch.bridge.bridge").setLevel(
        logging.WARNING)
    runs = [(name, SCENARIOS[name]()) for name in sorted(SCENARIOS)]
    runs.append(("composite_scaled", scenario_composite(**CHAOS_SCALED)))
    with tempfile.TemporaryDirectory() as work:
        for name, sc in runs:
            st["snaps"].clear()
            st["checked"] = []
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            run_ = run_daemon_scenario(
                sc, work, polling_ms=25.0, extra_flags=(f"--device={device}",))
            seconds = time.perf_counter() - t0
            storm = name == "node_storm"
            rep = check_invariants(
                run_, expect_guard=storm,
                guard_release_rounds=5 if storm else None)
            backends = sorted({r["backend"] for r in run_.stats
                               if r["pods_pending"]})
            print(HA_PREFIX + json.dumps(dict(
                name=name, nodes=sc.nodes, pods=sc.pods, seed=sc.seed,
                rounds=len(run_.stats), ok=rep.ok, failures=rep.failures,
                fault_clear_round=sc.fault_clear_round,
                applied=run_.applied, backends=backends,
                rounds_to_recover=rounds_to_recover(
                    run_.stats, sc.fault_clear_round),
                recover_within=sc.recover_within,
                double_binds=len(rep.details["double_binds"]),
                lost=len(rep.details["lost_pods"]),
                degrades=rep.details["degrades_total"],
                dense=st["checked"], seconds=seconds,
                launches={k.name: k.launches for k in kernels.KERNELS
                          if k.launches},
            ), default=str), flush=True)
    return 0


def chaos_phase(torch, card: str) -> None:
    """The chaos harness on the card: the reference's four scenarios at
    their own sizes and seeds through the port's daemon with
    ``--device=cuda`` (clusters of at most 64 machines: the
    small-instance oracle solves their rounds), then the scaled
    composite (``CHAOS_SCALED``), whose rounds run K1-K3 through every
    fault and its recovery; the invariants hold in every one, every
    dense round equals the C++ oracle with one fetch a solve, and a
    dense round follows every fault of the scaled one, one of them
    after its ``fault_clear_round``."""
    import os

    log(f"[chaos] card: {card}")
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, chip_smoke; sys.exit(chip_smoke.chaos_child())",
         DEVICE], cwd=root, capture_output=True, text=True, timeout=600,
    )
    results = [json.loads(line[len(HA_PREFIX):])
               for line in out.stdout.splitlines()
               if line.startswith(HA_PREFIX)]
    if out.returncode != 0 or len(results) != 5:
        raise AssertionError(f"[chaos] rc={out.returncode}, "
                             f"{len(results)} of 5 scenarios:\n"
                             f"{out.stderr[-4000:]}")
    for r in results:
        log(f"[chaos] {r['name']} ({r['nodes']} nodes x {r['pods']} pods, "
            f"seed {r['seed']}): {r['rounds']} rounds in "
            f"{r['seconds']:.3f} s, invariants ok={r['ok']}, "
            f"rounds_to_recover={r['rounds_to_recover']} (bound "
            f"{r['recover_within']}), double binds={r['double_binds']}, "
            f"lost={r['lost']}, degrades={r['degrades']}, backends="
            f"{r['backends']}, applied={r['applied']}, "
            f"launches={r['launches']}")
        if not r["ok"]:
            raise AssertionError(f"[chaos] {r['name']}: {r['failures']}")
        for d in r["dense"]:
            if d["cost"] != d["oracle"] or d["fetches"] != d["solves"]:
                raise AssertionError(f"[chaos] {r['name']} round "
                                     f"{d['round']}: {d}")
    scaled = results[-1]
    if scaled["backends"] != ["dense_auction"] or not scaled["dense"]:
        raise AssertionError(f"[chaos] the scaled scenario did not run the "
                             f"dense path: {scaled['backends']}")
    dense = [d["round"] for d in scaled["dense"]]
    late = [(at, kind) for at, kind, _ in scaled["applied"]
            if not any(r > at for r in dense)]
    if late or max(dense) < scaled["fault_clear_round"]:
        raise AssertionError(
            f"[chaos] scaled scenario: no dense round after the faults "
            f"{late} (dense rounds {dense}, fault clear round "
            f"{scaled['fault_clear_round']})")
    idle = [n for n in ROUND_KERNELS if not scaled["launches"].get(n)]
    if idle and DEVICE == "cuda":
        raise AssertionError(f"[chaos] scaled scenario: kernels not "
                             f"launched: {idle}")
    log(f"[chaos] scaled scenario: {len(dense)} dense rounds {dense}, "
        f"each == the C++ oracle with one fetch a solve; one after every "
        f"fault, {sum(r >= scaled['fault_clear_round'] for r in dense)} "
        f"at or after the fault clear round "
        f"{scaled['fault_clear_round']}")


# ---- the contract checker on the card --------------------------------

# the audited entries that run a cold solve, and the library sorts of its
# clearing (``_theta_clearing``: two stable argsorts, two sorts), which
# stay torch (ROADMAP Queue 2)
COLD_ENTRIES = ("resident_chain", "solve_member")
CLEARING_SORTS = {"aten.sort.stable": 2, "aten.sort.default": 2}
SYNC_WARNING = "synchronizing CUDA operation"
SYNC_ARRIVALS = 16               # the express phase's batch width
SYNC_WINDOWS = 8                 # the stream phase's flush


def _port_frame():
    """(path, line) of the innermost ``poseidon_tpu_torch`` frame of the
    calling thread, and whether that frame is ``SyncCounter.read`` (then
    the path and line are its caller's)."""
    import pathlib

    pkg = str(pathlib.Path(__file__).resolve().parent / "poseidon_tpu_torch")
    root = pathlib.Path(__file__).resolve().parent
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if fn.startswith(pkg) and "/analysis/" not in fn:
            if fn.endswith("guards.py") and f.f_code.co_name == "read":
                caller = f.f_back
                rel = pathlib.Path(caller.f_code.co_filename).resolve()
                return rel.relative_to(root).as_posix(), caller.f_lineno, True
            return (pathlib.Path(fn).resolve().relative_to(root).as_posix(),
                    f.f_lineno, False)
        f = f.f_back
    return None, 0, False


def sync_map(torch, fn):
    """Run ``fn()`` with the card's sync debug mode at "warn" and return
    (result, [(path, line, via_read), ...]): one entry per synchronising
    call, from every thread (the round's fetch worker included),
    attributed to the innermost port frame."""
    import threading
    import warnings

    sites = []
    lock = threading.Lock()

    def show(message, category, filename, lineno, file=None, line=None):
        if SYNC_WARNING in str(message):
            site = _port_frame()
            with lock:
                sites.append(site)

    with warnings.catch_warnings():
        # "always": the default filter drops repeats from one location
        warnings.simplefilter("always")
        warnings.showwarning = show
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sites


def _enclosing_function(path: str, line: int) -> str | None:
    """The qualname of the innermost def around ``path:line``."""
    import ast
    import pathlib

    from poseidon_tpu_torch.analysis.rules import iter_functions

    tree = ast.parse(pathlib.Path(path).read_text())
    best = None
    for fn, qual, _d in iter_functions(tree):
        if fn.lineno <= line <= (fn.end_lineno or fn.lineno):
            if best is None or fn.lineno >= best[0]:
                best = (fn.lineno, qual)
    return best[1] if best else None


def check_sync_window(label: str, sites, expected_reads: int,
                      inventory, sanctioned) -> dict:
    """Hold one window's runtime sync map to the solver's own counters,
    the contracts' sanctioned sites and the static PTA001 inventory."""
    import collections

    reads = [s for s in sites if s[2]]
    other = collections.Counter((p, ln) for p, ln, via in sites if not via)
    if len(reads) != expected_reads:
        raise AssertionError(
            f"[analysis] {label}: {len(reads)} synchronising reads through "
            f"SyncCounter.read, the solver counted {expected_reads}")
    unattributed = [s for s in sites if s[0] is None]
    if unattributed:
        raise AssertionError(f"[analysis] {label}: {len(unattributed)} "
                             "synchronising calls outside the port")
    by_path = collections.defaultdict(list)
    for d in inventory:
        by_path[d["path"]].append(d)
    for (path, line), n in sorted(other.items()):
        qual = _enclosing_function(path, line)
        if (path, qual) not in sanctioned:
            raise AssertionError(
                f"[analysis] {label}: {n} synchronising call(s) at "
                f"{path}:{line} ({qual}), not a SyncCounter.read nor a "
                "Contracts.sync_sites entry")
        if not any(d["start"] <= line <= d["end"] for d in by_path[path]):
            raise AssertionError(
                f"[analysis] {label}: {path}:{line} ({qual}) synchronised "
                "on the card, and static PTA001 does not name it")
    for path, line, _via in reads:
        if not any(d["kind"] == "read" and d["start"] <= line <= d["end"]
                   for d in by_path[path]):
            raise AssertionError(
                f"[analysis] {label}: the read at {path}:{line} is not in "
                "static PTA001's inventory")
    sites_n = {f"{p}:{ln}": n for (p, ln), n in sorted(other.items())}
    log(f"[analysis] sync map {label}: {len(sites)} synchronising calls = "
        f"{len(reads)} SyncCounter.read (solver counters "
        f"{expected_reads}) + {sum(other.values())} declared uploads "
        f"{sites_n}")
    return {"reads": len(reads), "uploads": sum(other.values())}


def sync_arrivals(res, window: int, n: int, n_machines: int):
    """``n`` seeded express arrivals, each preferring one machine."""
    return res.ExpressBatch(arrivals=[
        res.ExpressArrival(
            uid=f"sync-{window}-{k}", wait_rounds=0, cpu_milli=250,
            mem_kb=1 << 18,
            prefs=(((window * 131 + k * 37) % n_machines, -1, 5),),
        )
        for k in range(n)
    ])


def analysis_phase(torch, card: str) -> None:
    """The contract checker on the card: the static run, the op census
    of the audited entries on the card against the pinned CPU census,
    and the runtime sync map of a flagship cold round, a warm round, an
    express batch and a stream flush."""
    import pathlib

    from poseidon_tpu_torch.analysis import DEFAULT_CONTRACTS
    from poseidon_tpu_torch.analysis.core import analyze_and_audit
    from poseidon_tpu_torch.analysis.optrace_check import (
        record_entries, run_optrace_audit,
    )
    from poseidon_tpu_torch.analysis.rules import sync_inventory
    from poseidon_tpu_torch.graph.builder import FlowGraphBuilder
    from poseidon_tpu_torch.ops import resident as res
    from poseidon_tpu_torch.synth import config2_quincy_flagship

    root = pathlib.Path(__file__).resolve().parent
    # (a) the whole tree, with the suppression audit
    t0 = time.perf_counter()
    vs, n_files = analyze_and_audit(root)
    static_s = time.perf_counter() - t0
    for v in vs:
        log(f"[analysis] {v.path}:{v.line}: {v.code} {v.message}")
    log(f"[analysis] static: {len(vs)} violations in {n_files} files, "
        f"{static_s:.2f} s | {card}")
    if vs:
        raise AssertionError(f"[analysis] {len(vs)} static violations")

    # (b) the op census of the audited entries, recorded on the card
    t0 = time.perf_counter()
    recs = record_entries("cuda")
    found, n_entries = run_optrace_audit(root, recordings=recs)
    for v in found:
        log(f"[analysis] {v.path}:{v.line}: {v.code} {v.message}")
    for name, r in recs.items():
        kern = {k[len('kernel.'):]: v for k, v in r.census.items()
                if k.startswith("kernel.")}
        log(f"[analysis] census {name} (cuda): "
            f"{sum(r.census.values())} ops, "
            f"{r.census.get('SyncCounter.read', 0)} reads, kernels {kern}, "
            f"device moves {sum(r.transfers.values())}")
    log(f"[analysis] census: {n_entries} entries on the card, "
        f"{len(found)} problems, {time.perf_counter() - t0:.2f} s")
    if found:
        raise AssertionError(f"[analysis] op census: {len(found)} problems")
    # the auction loop makes no library top-k or sort on the card (K12,
    # K13); a cold entry keeps only its clearing's sorts
    for name, r in recs.items():
        lib = {k: v for k, v in r.census.items()
               if k.startswith(("aten.sort", "aten.argsort", "aten.topk"))}
        want = CLEARING_SORTS if name in COLD_ENTRIES else {}
        log(f"[analysis] census {name} (cuda): library sorts and top-k "
            f"{lib}, K12 {r.census.get('kernel.top_will', 0)}, K13 "
            f"{r.census.get('kernel.seat_sort', 0)} sorts + "
            f"{r.census.get('kernel.seat_compact', 0)} compactions")
        if lib != want:
            raise AssertionError(f"[analysis] {name}: library sorts/top-k "
                                 f"{lib}, expected {want}")

    # (c) the runtime sync map at the main path's, the express phase's
    # and the stream phase's shapes
    inventory = sync_inventory(root)
    sanctioned = {(p, q) for p, q, _why in DEFAULT_CONTRACTS.sync_sites}
    cluster = config2_quincy_flagship(seed=0)
    warm_cluster = churn(cluster, 1)
    built = [FlowGraphBuilder().build_arrays(c)
             for c in (cluster, warm_cluster)]
    solver = res.ResidentSolver(
        device="cuda", small_to_oracle=False, express_lane=True,
        express_max_batch=SYNC_ARRIVALS, stream_windows=SYNC_WINDOWS)
    n_machines = len(cluster.machines)
    for label, c, (arrays, meta) in (("cold round", cluster, built[0]),
                                     ("warm round", warm_cluster, built[1])):
        out, sites = sync_map(torch, lambda: solver.run_round(
            arrays, meta, cost_model="quincy",
            cost_input_kwargs=cost_kwargs(c)))
        if out.backend != "dense_auction" or not out.converged:
            raise AssertionError(f"[analysis] {label}: {out.backend}")
        check_sync_window(label, sites, solver.last_round_fetches
                          + solver.last_round_loop_syncs, inventory,
                          sanctioned)
    batch = sync_arrivals(res, 0, SYNC_ARRIVALS, n_machines)
    out, sites = sync_map(torch, lambda: solver.express_round(batch))
    if not out.ok:
        raise AssertionError(f"[analysis] express batch: {out.reason}")
    check_sync_window("express batch", sites, solver.last_round_fetches
                      + solver.last_round_loop_syncs, inventory, sanctioned)

    def flush():
        for w in range(1, SYNC_WINDOWS + 1):
            got = solver.stream_window(
                sync_arrivals(res, w, SYNC_ARRIVALS, n_machines))
            if not got.ok:
                raise AssertionError(f"[analysis] window {w}: {got.reason}")
        solver.stream_flush()
        return solver.stream_finish()

    out, sites = sync_map(torch, flush)
    if out is None:
        raise AssertionError("[analysis] stream flush: no outcome")
    check_sync_window("stream flush", sites, solver.last_stream_fetches
                      + solver.last_round_loop_syncs, inventory, sanctioned)

    # the general lane: a cost-scaling and an SSP flagship solve, each its
    # tables' uploads, one graph and one fetch (no read in the loops)
    from poseidon_tpu_torch.ops import cost_scaling, ssp

    flag, _ = priced_net(torch, cluster, torch.device("cuda"))
    for label, solve in (("cost-scaling flagship",
                          cost_scaling.solve_cost_scaling),
                         ("SSP flagship", ssp.solve_ssp)):
        out, sites = sync_map(torch, lambda: solve(flag, device="cuda"))
        got = check_sync_window(label, sites, out.fetches + out.loop_syncs,
                                inventory, sanctioned)
        if out.loop_syncs or out.fetches != 1 or got["reads"] != 1:
            raise AssertionError(f"[analysis] {label}: {got['reads']} "
                                 f"reads, loop_syncs={out.loop_syncs}")


# the reference's exhausted trials of the adversarial sweep (its
# script's (trial, model, M, T) list, from tests/test_torch_adversarial.py
# ::test_full_sweep_exhausted_list_matches_reference, which runs all 240
# trials through both packages on the CPU)
ADVERSARIAL_EXHAUSTED = (
    (11, "random", 37, 134), (29, "random", 19, 72),
    (76, "octopus", 15, 74), (83, "random", 30, 124),
    (92, "coco", 10, 75), (158, "coco", 14, 115),
    (161, "random", 37, 46), (203, "random", 36, 135),
)
ADVERSARIAL_WORKERS = 4          # processes, each its own CUDA context
# trial 119 (random, 16 x 26: 823 rounds over a 32-row table, its seat
# sorts 32 keys each) and the trials of its table shape and smax: K13's
# split of n <= 32 keys runs no level, and once took no cluster barrier
# before its blocks read each other's keys; four processes sharing the
# card made that race show (an illegal address, or trial 119 out of its
# fuse). Repeated for RACE_SECONDS in each of the four.
RACE_TRIALS = (119, 5, 13, 136)
RACE_SECONDS = 30.0
# then K13's split alone in a CUDA graph of RACE_SORTS sorts, each held
# against its twin inside the graph, replayed for RACE_SORT_SECONDS: 32
# keys (no level) and 64 keys whose last level moves only some keys (the
# copy back, which no barrier once ordered before the rank either)
RACE_SORTS = 256
RACE_SORT_SECONDS = 20.0


def race_sort_cases(torch, device):
    """(keys, spans) of the sort part: n = 32 seat keys (segment, negated
    level, task id) over 35 segments, and n = 64 with 40 keys in one
    segment, split again at level 1 (so level 1 moves 40 of 64 keys)."""
    import numpy as np

    from poseidon_tpu_torch.kernels.seat_sort import INT32

    rng = np.random.default_rng(19)
    cases = []
    for n, crowd in ((32, 0), (64, 40)):
        seg = rng.integers(0, 35, n)
        seg[:crowd] = 33
        cols = (seg, -rng.integers(0, 1000, n), rng.permutation(n))
        keys = tuple(torch.as_tensor(c.astype(np.int32), device=device)
                     for c in cols)
        cases.append((keys, ((0, 34), INT32, (0, n - 1))))
    return cases


def race_sorts(torch, seconds: float, device) -> tuple[int, int]:
    """K13 on ``race_sort_cases`` for ``seconds``: on the card a captured
    graph of RACE_SORTS sorts, each compared with its twin's result into
    a device count, replayed; on the CPU the twin itself. Returns (sorts
    that differed, sorts run)."""
    from poseidon_tpu_torch.kernels import seat_sort

    dev = torch.device(device)
    cases = race_sort_cases(torch, dev)
    want = [tuple(w.to(dev) for w in seat_sort.seat_sort_plain(
        *(k.cpu() for k in keys))) for keys, _spans in cases]
    bad = torch.zeros((), dtype=torch.int32, device=dev)

    def body():
        for i in range(RACE_SORTS):
            keys, spans = cases[i % 2]
            outs = seat_sort.seat_sort(keys, spans)
            differs = torch.stack([(o != w).any() for o, w in
                                   zip(outs, want[i % 2])]).any()
            bad.add_(differs.to(torch.int32))

    t0, runs = time.perf_counter(), 0
    if dev.type == "cuda":
        body()                       # plans and kernels loaded, then captured
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        bad.zero_()
        while time.perf_counter() - t0 < seconds:
            graph.replay()
            runs += RACE_SORTS
        torch.cuda.synchronize()
    else:
        while time.perf_counter() - t0 < seconds:
            body()
            runs += RACE_SORTS
    return int(bad), runs


def race_worker(job) -> tuple[list, tuple[int, int]]:
    """One process of the race check: ``RACE_TRIALS`` in turns until
    ``seconds`` have passed, each through the sweep's own trial (dense
    solve, oracle), then ``race_sorts``; returns (trial, converged,
    rounds, cost, oracle cost) of every run and the sorts' (differed,
    run). A CUDA fault raises, and fails the phase."""
    from poseidon_tpu_torch import adversarial

    import torch

    seconds, sort_seconds, device = job
    torch.set_num_threads(1)
    inputs = {t[0]: t for t in adversarial.trial_inputs(max(RACE_TRIALS) + 1)}
    out, t0 = [], time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for trial in RACE_TRIALS:
            r = adversarial.run_trial(*inputs[trial], device)
            out.append((r.trial, r.converged, r.rounds, r.cost,
                        r.oracle_cost))
    return out, race_sorts(torch, sort_seconds, device)


def race_check(card: str, seconds: float = RACE_SECONDS,
               sort_seconds: float = RACE_SORT_SECONDS) -> None:
    """The sweep's small-table trials, then K13's split alone, repeated in
    ADVERSARIAL_WORKERS processes at once: every run converged at the
    oracle's cost, every run of a trial took the same rounds, and every
    sort equals its twin (ROADMAP Queue 3's closed fault)."""
    import multiprocessing

    t0 = time.perf_counter()
    with multiprocessing.get_context("spawn").Pool(ADVERSARIAL_WORKERS) as pool:
        parts = pool.map(race_worker, [(seconds, sort_seconds, DEVICE)] *
                         ADVERSARIAL_WORKERS)
    runs = [r for part, _sorts in parts for r in part]
    sort_bad = sum(b for _part, (b, _n) in parts)
    sorts = sum(n for _part, (_b, n) in parts)
    bad = [r for r in runs if not r[1] or r[3] != r[4]]
    rounds = {}
    for r in runs:
        rounds.setdefault(r[0], set()).add(r[2])
    log(f"[adversarial] race check: trials {RACE_TRIALS} repeated in "
        f"{ADVERSARIAL_WORKERS} processes for {seconds:.0f} s: {len(runs)} "
        f"runs ({ {t: sum(r[0] == t for r in runs) for t in RACE_TRIALS} }), "
        f"rounds {sorted((t, sorted(v)) for t, v in rounds.items())}, "
        f"{len(bad)} unconverged or off the oracle; K13's split of 32 and "
        f"64 keys in a graph for {sort_seconds:.0f} s: {sorts} sorts, "
        f"{sort_bad} differ from the twin; {time.perf_counter() - t0:.1f} s "
        f"| {card}")
    if bad or sort_bad or any(len(v) != 1 for v in rounds.values()):
        raise AssertionError(f"[adversarial] race check: {bad[:8]}, rounds "
                             f"{rounds}, sorts differing {sort_bad}")


def adversarial_phase(torch, card: str) -> None:
    """The race check (``race_check``), then all 240 trials of the
    adversarial fuse sweep on the card. The trials the reference ran out
    of their fuse (the 20,000-round runs, 66-99 s each) start first, so
    the pool's last trials are short ones; the order changes no trial's
    result."""
    from poseidon_tpu_torch import adversarial

    race_check(card)
    t0 = time.perf_counter()
    records, launches = adversarial.sweep(
        adversarial.TRIALS, "cuda", workers=ADVERSARIAL_WORKERS,
        first=[e[0] for e in ADVERSARIAL_EXHAUSTED])
    wall = time.perf_counter() - t0
    wrong = [r for r in records if r.wrong]
    ex = adversarial.exhausted(records)
    walls = sorted(r.wall_s for r in records)
    log(f"[adversarial] {len(records)} trials in {wall:.1f} s over "
        f"{ADVERSARIAL_WORKERS} processes: exhausted {len(ex)} {ex}, "
        f"wrong {len(wrong)}, wall a trial p50 {percentile(walls, 50):.3f} s "
        f"max {walls[-1]:.3f} s | launches "
        f"{ {k: launches.get(k, 0) for k in ROUND_KERNELS} } | {card}")
    for r in records:
        if not r.converged or r.wall_s >= 1.0:
            log(f"[adversarial] trial {r.trial} {r.model} M={r.M} T={r.T}: "
                f"converged={r.converged} rounds={r.rounds} cost={r.cost} "
                f"oracle={r.oracle_cost} front={r.front_cost} "
                f"wall_s={r.wall_s:.3f}")
    if wrong:
        raise AssertionError(f"[adversarial] wrong trials: {wrong}")
    if tuple(ex) != ADVERSARIAL_EXHAUSTED:
        raise AssertionError(f"[adversarial] exhausted {ex} != the "
                             f"reference's {ADVERSARIAL_EXHAUSTED}")
    idle = [k for k in ROUND_KERNELS if not launches.get(k)]
    if idle:
        raise AssertionError(f"[adversarial] kernels not launched: {idle}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        import poseidon_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    from poseidon_tpu_torch.kernels import loader
    from poseidon_tpu_torch.oracle import oracle

    t_start = time.perf_counter()
    name = torch.cuda.get_device_name(0)
    smi = nvidia_smi_line()
    global INT32_OPS_PER_S
    INT32_OPS_PER_S = int32_ops_per_s(torch)
    log(f"[device] {name} | nvidia-smi: {smi} | torch {torch.__version__} "
        f"cuda {torch.version.cuda} | int32 roof {INT32_OPS_PER_S:.6e} ops/s "
        f"(SMs x {INT32_LANES_PER_SM} lanes x clocks.max.sm)")

    t0 = time.perf_counter()
    report = loader.build_all()
    oracle.ensure_built()
    log(f"[build] kernels {report.seconds:.2f} s (parallel nvcc), "
        f"kernels + oracle {time.perf_counter() - t0:.2f} s")
    for src, text in report.ptxas.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {src}: {line.strip()}")

    timer = Timer(torch)
    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"[{name}] phase took {phase_s[name]:.1f} s")
        return out

    # ``--phases=a,b`` runs only those phases after the build (a quick
    # check of one path while it is being brought up): it prints no
    # kernels record and no contract line, and exits 0 when they pass
    def option(prefix):
        return next((a[len(prefix):] for a in sys.argv[1:]
                     if a.startswith(prefix)), None)

    only = option("--phases=")
    only = only.split(",") if only is not None else None

    def want(name):
        return only is None or name in only

    records = []
    launches = {}
    if want("kernels"):
        records = phase("kernels", kernel_phase, torch, timer)
    if want("edges"):
        phase("edges", edges_phase, torch)
    if want("parity"):
        phase("parity", parity_phase)
    if want("main"):
        launches = phase("main", main_path_phase, torch)
    if want("loop"):
        phase("loop", loop_phase, torch, smi)
    if want("models"):
        phase("models", models_phase, torch, timer)
    if want("express"):
        express_launches = phase("express", express_phase, torch)
        for k in ("express_rows", "express_patch"):
            launches[k] = express_launches[k]
    if want("daemon"):
        phase("daemon", daemon_phase, torch, smi)
    if want("stream"):
        launches["stream_commit"] = phase(
            "stream", stream_phase, torch, smi)["stream_commit"]
    if want("whatif"):
        launches["perturb"] = phase(
            "whatif", whatif_phase, torch, smi)["perturb"]
    if want("service"):
        phase("service", service_phase, torch, smi)
    if want("scale"):
        launches["gap_rows"] = phase(
            "scale", scale_phase, torch, smi)["gap_rows"]
    if want("general"):
        general_launches = phase("general", general_phase, torch, smi)
        for k in GENERAL_KERNELS:
            launches[k] = general_launches[k]
    keep_dir = option("--keep_dir=")
    if want("ha"):
        phase("ha", ha_phase, torch, smi, keep_dir)
    if want("observe"):
        phase("observe", observe_phase, torch, smi,
              DAEMON_ROUND1.get("poll"),
              None if keep_dir is None else f"{keep_dir}/audits")
    if want("chaos"):
        phase("chaos", chaos_phase, torch, smi)
    if want("analysis"):
        phase("analysis", analysis_phase, torch, smi)
    if want("adversarial"):
        phase("adversarial", adversarial_phase, torch, smi)
    if only is not None and "ha_control" in only:
        phase("ha_control", ha_control_phase, torch, smi)
    log("[done] phase seconds: " + ", ".join(
        f"{k} {v:.1f}" for k, v in phase_s.items()))
    if only is not None:
        log(f"[done] phases {only} passed (a partial run: no record)")
        return 0

    out = {"kernels": [
        {
            "name": k.name, "route": "cuda", "source": k.source,
            "replaces": k.replaces, "launches": launches[k.name],
            "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by,
            "library_ms": LIBRARY_MS.get(k.name),
        }
        for k, err, ms, plain, bms, by, _shape in records
    ]}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(out), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
