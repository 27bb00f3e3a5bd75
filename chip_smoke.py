"""Smoke run of pypardis_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the script (non-zero exit) when it fails:

1. the card's name and power limit (``nvidia-smi``), then the build of
   the CUDA kernels from ``pypardis_tpu_torch/csrc`` (``nvcc``, into
   ``build/pypardis_tpu_torch/``), with its seconds and the compiler's
   register report (every kernel instance, B3's certified rescore
   ``sketch_pair_kernel<0, 2>``, B1's tensor-core kernel
   ``b1_tc_kernel<0, 1, 4>`` and B5's tables, pass and prefilter
   kernels among them: the phase fails without them);
2. each kernel (B1 ``count_pairs``, B2 ``minlab_pairs``) against its
   plain PyTorch version on the card, at d=16 and d=64 on guard-banded
   and on natural blobs, at d=3 and d=96 on natural blobs, at d=3 and 16
   with block 64 (a 64-row tile), and at d=3,
   16 and 64 on the adversarial geometry (near-eps pairs, duplicates, a
   1e3 offset) — the exact verdicts share their d^2 arithmetic, so the
   bar is exact equality; at d <= 64 (B1 on the tensor cores) also B1's
   ``rescored_pairs`` against ``certified_count_walk``'s, off by no
   more than its fragile pairs nor 0.1 % (:func:`b1_rescored_hold`);
3. a small fit on the card against the same fit through the plain
   versions on the CPU (byte-identical labels and core mask);
4. the main path, ``DBSCAN(eps=2.4, min_samples=10, block=2048).fit(X)``
   on 16-D blobs (32 centres, std 0.4; the repo's benchmark geometry) at
   200,000 and 1,000,000 points, twice from host input and twice from a
   CUDA tensor.  Every fit prints its wall seconds (synchronised), the
   B1/B2 launches (counted from 0 for that fit; they must sum to the
   fit's kernel passes), live tile pairs, clusters and ARI against the
   generating truth (>= 0.99); repeated fits must be byte-identical;
5. the kernels alone at the 1M fit's own inputs (the first B1 pass and
   the first B2 pass): equality with the plain versions, B1's
   ``rescored_pairs`` against the walk's on the first 64 row tiles,
   CUDA-event times (median) beside the plain versions' times, B1's
   bound (:func:`b1_bounds`), the all-FP32 work's bound, its floor
   (:func:`b1_floor`), the pairs its fallback decided and the staging of
   its frames (the row tiles' centres); then
   B2 at each round's labels of the fit (:func:`b2_rounds`, the fit's
   round loop replayed with the live rows it passes): per round its
   time, its evaluated share of (block, 32-column chunk) pairs (the
   label-bound skip), its bound (the label-exact floor) beside the work
   without the skip, and on
   the first 64 row tiles the kernel bitwise its plain version and
   ``minlab_pairs_walk`` with its evaluated count equal to the walk's;
6. serving at full size on phase 4's first 1M host-input model (no
   refit): the main path, counted from 0, is ``model.query_engine()``
   with its defaults (the core-point index and B5's tables, built once),
   65,536 queries (half jittered training points, a quarter exact core
   points, a quarter uniform over the data's box) as 16 ``submit``
   calls of 4,096 and one ``drain``, then one sync ``predict`` of
   4,096.  Checks: (a) B5 equals its plain version on the card, bitwise
   on the whole packed output (pad rows and pad tiles included), on the
   first two batches and the timed batch, each with its fill
   (:func:`b5_fill`: real tiles of nqt, real rows of the real tiles,
   real slots of leaf_cap) and the (row, slot) pairs B5's pass
   computed, read from the kernel's pass counter and held equal to
   ``query_pass_pairs``'s count, so the real share of them is
   measured (the first form's every row against every slot is
   computed); B5's tables bitwise their
   plain versions; an index whose one leaf has no pad slot, whose pad
   rows and pad tiles answer (+inf, the leaf's least label); (b) 512
   queries equal :func:`card_oracle` over all cores (the numpy
   brute-force oracle's op sequence on the card, which equals the numpy
   oracle on 8 rows over all cores); (c) every
   exact core point predicts its own training label; (d) a
   ``save``/``load`` round trip (no training data) predicts
   byte-identically; (e) B5 launched once per dispatched batch, its
   tables once.  Prints the index geometry, queries/s, p50/p99 request
   ms, batch fill, the host's waits on the card, warm drains against as
   many sync predicts (ms per batch), one batch's stage times, B5's
   CUDA-event time per 4,096-query batch beside its plain version, its
   bound and its unfused SIMT ceiling (:func:`b5_bounds`), and the
   tables' build time;
7. high-dimensional fits through the sketch kernels (B3
   ``count_pairs_sketch``, B4 ``minlab_pairs_sketch``) on
   ``make_embedding_data(n, 512)`` with eps 2.0, min_samples 10, block
   2048: (1) both kernels against their plain versions, exactly (counts,
   ``band_pairs``, ``rescored_tiles``, min labels), at 20,000 points for
   d=256 and d=512, on the noise-dominated geometry, with a pinned k
   whose k+1 is not a multiple of 8, and (B3 under ``"high"`` and
   ``"mixed"``) on the adversarial geometry at d=512; B3's
   ``rescored_pairs`` (the pairs its certified rescore decided exactly)
   off ``certified_rescore_walk``'s by no more than its fragile pairs
   nor than 0.1 % (:func:`rescored_tolerance`), its share of
   ``band_pairs`` printed; before them, the probe of the tensor cores'
   FP32 accumulation (:func:`mma_probe`, at K = 16, 64 and 512: B1's
   depths at 16-D and 64-D and B3's) against the band's term (3); (2) at 100,000 x 512 the sketched
   and the unsketched fit byte-identical, with their live pairs, walls
   and launches (B3 once and B4 per round and never B1/B2, and the
   reverse); (3) the slice's path at 1,000,000 x 512, one fit from host
   input and two from a CUDA tensor (byte-identical; (5) the second
   under a global ``torch.set_float32_matmul_precision("high")``), each
   with its wall, launches (summing to its passes), ``sketch_k`` 128,
   ``band_pairs`` (past 2^31), ``rescored_tiles``, live pairs, clusters
   and ARI >= 0.99; (4)
   B3 and B4 alone at the 1M inputs: B4 at the labels of each round of
   the fit's loop (replayed with ``ops/labels._pointer_jump``), each
   launch's CUDA-event median, its evaluated share of (block, chunk)
   pairs and its bound (the gate over the pairs a label-exact method
   must rule out); B3 timed with its ``rescored_pairs``, their share of
   ``band_pairs``, two bounds (:func:`b3_bounds`: the exact rescore's
   and the certified rescore's work) and the function's floor
   (:func:`b3_floor`); over the first 8 row tiles (32 until phase 17
   and 16 until phase 20 took their time) both
   against their plain versions (B3's ``rescored_pairs`` against the
   emulation's), B4 bitwise at the round-1, converged and
   descending labels with its evaluated count equal to
   ``minlab_skip_walk``'s (also in (1), where the share is printed);
8. the precision modes (the bf16 tensor-core kernels): (1) B1/B2 under
   ``"mixed"`` and ``"default"`` against their plain versions at
   d = 3, 16, 64, 96 (20,000 points, the adversarial geometry with
   near-eps pairs, duplicates and a 1e3 offset, and natural blobs):
   ``"mixed"`` counts and min labels bitwise the plain version's and the
   FP32 kernel's, band stats within 1e-3 relative of the plain
   version's, B1's ``rescored_pairs`` against the walk's at d <= 64;
   ``"default"`` between the plain version at eps^2 (1 -+
   2^-12), its differing points counted; B3/B4 under both modes at
   20,000 x 512 likewise; (2) ``DBSCAN(..., precision="mixed")`` at
   1M x 16-D, once from host input and twice from a CUDA tensor,
   byte-identical to phase 4's ``"high"`` fit, the mixed B1 once and
   the mixed B2 per round and nothing else; (3) one ``"default"`` fit
   (ARI >= 0.99, labels differing from ``"high"`` counted); (4) the four
   B1/B2 kernels at phase 5's inputs: against their plain versions (and
   the mixed ones against the FP32 kernels) over the first 64 row tiles,
   as in (1), then timed beside the FP32 times, the plain versions' and
   the bound, and B2 under both modes per round as in phase 5 (the
   mixed kernel also bitwise the FP32 kernel); (5) a ``"mixed"`` engine
   on phase 6's
   index over phase 6's batches: answers bitwise the exact engine's and
   the oracle's, one mixed B5 per batch, its time beside exact B5, the
   kept share of units and the pairs its pass computed; its bound is
   the least of the exact bound and the prefilter over every real pair
   plus the exact pass over the pairs the walk keeps; (6) 100,000 x 512 fits under both modes
   through B3/B4 (``"mixed"`` byte-identical to ``"high"``,
   ``"default"`` ARI >= 0.99 at tile 1024), then those kernels at the
   fits' inputs against their plain versions over the first 64 row
   tiles, as in (1), and timed, B4 with its evaluated share.  In (5)
   the mixed B5's kept and visited units (tile, 32-row group, column
   block) are held against ``query_keep_walk``'s: visited equal, kept
   within the walk's fragile units.  The
   kernels line's ``max_abs_err`` of each bf16 B1-B4 kernel is its
   largest difference in (4) or (6);
9. the metrics and the sweep (:func:`metrics_phase`), each fit from host
   input with its launches counted from 0: (1) cosine on the first
   500,000 rows of phase 7's 1,000,000 x 512 data (all of them until PR
   20; eps :data:`COS_EPS`, sketch "auto"): B3 once
   and B4 per round, ARI against the truth, labels and core mask
   byte-identical to the Euclidean fit of ``_unit_rows(X)`` at
   ``kernel_eps``; B3/B4 bitwise their plain versions on unit rows
   (20,000 x 512, k = 128), timed; 4,096 queries through the engine of
   a cosine model fitted on the first 100,000 rows (200,000 until phase
   20 took their time; the 512-D index build is host work, ~36 s at 1M;
   one B5 launch), answers bitwise
   :func:`card_oracle` over all
   cores (which equals the numpy oracle on 8 rows over 65,536 cores), B5
   bitwise its plain version on the batch's first tiles, timed; (2)
   haversine on :func:`geolife_like` stay points (1,000,000, eps 50 m):
   byte-identical to the Euclidean fit of ``latlon_to_unit_sphere(X)``
   at the chord eps, B1/B2 at d = 3 bitwise their plain versions on the
   fit's inputs with B1's exact-fallback share (its ``rescored_pairs``
   against the walk's on 64 row tiles), ``predict`` as in (1) at d = 3;
   (3) cityblock on the first 200,000 of phase 4's blobs (16-D, eps
   :data:`L1_EPS`; the 1M fit took ~22 s): its torch L1 passes
   (``L1_PASSES``) equal to its passes and no kernel launched, ARI >=
   0.99, a 20,000-point fit (block 128) on the card byte-identical to the
   CPU's, one L1 counts pass timed at 200,000 points; (4)
   a sweep of 8 eps up to :data:`SWEEP_EPS_MAX` x min_samples {5, 10}
   from a CUDA tensor: one distance pass, :data:`SWEEP_EDGES` edges,
   every config byte-identical to a fit at it (their walls summed
   against the sweep's), the emission and each config's relabel on CUDA
   events, and a second sweep past the 2^26-edge cap degrading to
   per-config fits with the same labels;
10. the density hierarchy (:func:`hier_phase`): (1) ``DBSCAN(eps=None,
   min_samples=10)`` on phase 4's 1,000,000 x 16-D blobs from a CUDA
   tensor with ``PPTORCH_HIER_EPS_MAX`` at :data:`SWEEP_EPS_MAX` (the
   graph must hold :data:`SWEEP_EDGES` edges), its stage seconds (graph,
   prepare, core pass, MST with its rounds, condense, cut, relabel),
   ``eps_``, clusters and ARI (not gated); labels and core mask
   byte-identical to ``fit(eps_)`` from the same tensor (B1/B2 counted
   from 0, launched, summing to its passes); the card's core distances
   bitwise the host's core pass over a host copy of the prepared slab,
   and so is the one-shot twin on the card over the same slab;
   (2) ``sweep(eps_list="auto", min_samples_list=[5, 10])`` on the first
   200,000 rows at that ceiling, every rung byte-identical to a fit at
   it (B1/B2 launched in each); (3) the default ceiling twice at 20,000
   points (the largest of 20,000 / 50,000 / 100,000 whose graph stays
   under the 2^26-edge cap; 50,000 would take about 78M edges):
   byte-identical, equal to the same fit at ``precision="default"``
   (the graph's d^2 is exact in every mode; ``tests/test_torch_card.py``
   holds it equal to the same fit with ``device="cpu"``); then a
   haversine eps=None fit on :func:`geolife_like`
   points of that size (ceiling 800 m) byte-identical to its
   ``fit(eps_)`` and served once (4,096 queries, B5 counted from 0;
   exact core points keep their labels); (4) an interior cut at scale:
   ``DBSCAN(eps=None, min_samples=10, min_cluster_size=1000)`` on
   1,000,000 x 3-D :func:`twin_blobs` at a ceiling of 0.22, which must
   select ``eps_`` below the ceiling, byte-identical to ``fit(eps_)``;
   ``fit(eps_, precision="default")``'s labels that differ are counted,
   not gated.  Phases (1)-(3) cut at their ceiling.  The phase adds no
   kernel: the hierarchy runs torch ops on the card and numpy on the
   host.

11. live updates and ingest (:func:`live_phase`) on phase 6's model
   (1,000,000 x 16-D, eps 2.4, min_samples 10): ``model.live()``, then
   a seeded write stream (64 single inserts, 128 until PR 20, and 4
   ``insert_batch``es
   of 1,024 rows from the blob law, 4,096 rows from one blob, a clump
   of 12 points 20 eps past every centre, 64 noise points, a pour into
   the index leaf with the fewest free slots past its pads, a
   ``delete_batch`` of the noise and of 64 cores of the largest
   cluster, an ``IngestQueue`` of 4,096 single submits flushed in
   batches of 1,024, a ``Compactor`` cycle with 64 inserts and 16
   deletes injected during its refit, a save/load).  Gates: after every
   commit the index's device tensors equal its host mirrors and B5's
   tables a fresh ``query_tables``, bitwise (after each group also their
   plain versions on the card and on the CPU: :func:`host_tables`);
   after each group ``predict`` of 4,096
   queries bitwise ``card_oracle`` over the mutated cores (and once B5
   bitwise its plain version); the float64 verdicts card = CPU on one
   update's pool; ARI 1.0 against a fresh fit of the final points, each
   differing core flag traced to a pair within ``exact_slack`` of eps^2;
   one re-cluster dispatch, one index delta and one fit (B1/B2 launches
   = its passes) per ``insert_batch`` and queue batch; tickets before
   the compaction's swap answer against the old generation, after it
   against the new one, the replayed writes in it.  It prints per
   update kind the p50 ms of its walls (synced at each update's start
   and end), the p99 where it has 100 updates or more and the largest
   elsewhere, its seconds in verdicts, re-cluster, attach, commit and
   B5 tables (CUDA-event spans, which add no sync), the launches and
   the compaction's phases.
12. the multi-tenant gateway and the load harnesses
   (:func:`gateway_phase`): (1) ``sustained_load`` on phase 11's live
   model (4 Poisson readers at 200 Hz of 16 rows, 2 Poisson writers at
   30 Hz of 8 blob-law rows through an ``IngestQueue``, a fifth of them
   deleting their own inserts, a ``Compactor`` started at 5 s; 15 s):
   no dropped ticket, failed write or missed deadline, >= 1 compaction
   and epoch swap, then the index's device tensors and B5's tables held
   as in phase 11, ``predict`` of 4,096 blob-law rows bitwise
   ``card_oracle``, ARI 1.0 against a fresh fit; it prints qps, p50,
   p99, update-visible p50/p99, write rows/s and batch, read p99 during
   the compaction against outside it and the compaction's phases;
   (2) a fleet of seven models fitted on the card (``big`` 1M, five of
   250,000, ``live`` 250,000 registered live; the blob law, seeds
   101-107) behind one ``ModelGateway`` at 60 % of their summed
   ``index_bytes``: the least recently served are the victims, the
   card's allocated memory falls by at least their device bytes and
   every released tensor is freed, each readmitted index's slabs and
   tables are bitwise what they were and its answers (labels, d^2)
   bitwise before the eviction and ``card_oracle``; a tenant at 0.001
   qps, burst 3 sheds 7 of 10, a quiet one none; a refit raises
   ``StaleModelHandle`` until ``refresh``; an insert on the live handle
   is served at once and its ``refresh`` refused; ``gateway_load`` (4
   tenants x 2 clients at 120 Hz of 64 rows, Zipf 1.2, 2 % live writes,
   10 s (15 s until phase 20 took their time), ``m2`` refreshed to a
   refit on new data at 6 s) drops nothing,
   evicts, readmits and swaps once, ``m2`` then gives the refreshed
   model's labels and answers bitwise the oracle over its new
   generation, B5 launches = the engines' batches and
   ``query_tables`` launches = readmissions + refreshes + live commits.
   It prints per tenant admitted, shed, p50 and p99, qps, the mean
   eviction and readmission windows by model size (without traffic and
   under it), the swap window, read p99 inside the eviction and swap
   windows against outside them, update-visible p50.
13. the KD route's chained form (:func:`chained_phase`,
   ``pypardis_tpu_torch.parallel.sharded_dbscan``): (1) 20,000
   separated 16-D blobs over 8 KD partitions (block 256), the card's
   labels and core flags byte-identical to the CPU's chained route under
   both merges and with ``overlap`` True and False (accepted for the
   JAX signature, it changes nothing), B1 once per partition and B2
   once per other pass; 4,096 x 512 embeddings over 4 partitions with
   the sketch on (B3/B4 likewise), byte-identical to the CPU's (the CPU
   runs go on in a child process beside (2) and (3) and are held at the
   phase's end); (2) phase 4's 1M x 16-D data over
   ``KDPartitioner(max_partitions=16)`` with the defaults (device
   merge): B1/B2 launches equal to the partitions' passes, the core
   mask byte-identical to phase 4's single-device fit, the noise and the
   core clustering identical, and each border point in another cluster
   within eps of a core of both (the exact float32 verdict on the card);
   then B1 and one B2 round bitwise their plain versions on the first 64
   row tiles of the route's largest slab (owned rows, the gap up to the
   owned capacity, the halo), on the same device tensors; (3) the first
   200,000 of the same points (the whole 1M until PR 20) at eps 1.4
   under the host merge, held the same way against a single-device fit
   at that eps; it must hold border points.  (2) and
   (3) print the fit's wall from host input split into the KD build, the
   halo sets, the host slab build, the per-partition device time
   (CUDA-event spans), the loop and the merge, with the halo and
   duplicated-work factors, pad waste, merge rounds, the overlap
   efficiency and the border and noise counts;
14. run reports and tracing (:func:`report_phase`), on fits the script
   already ran: (1) one B1 launch on phase 5's 1M inputs inside a span
   with ``sync_on`` must last at least its CUDA events' time (the same
   span without ``sync_on`` is printed beside it); (2) ``report()`` of
   phase 4's first 1M fit and 13.2's chained fit's report (built from
   its stats and recorder, :func:`chained_report`) must be JSON with
   the schema and every number finite, the ``table:h100`` peak row, a
   positive model rate, ``compute`` counts equal to the fit's
   ``metrics_``, phases within the run's wall and the device watermark
   in (0, ``max_memory_allocated``]; their summaries and model mfu are
   printed; (3) the 1M fit's ``export_trace`` must hold its pipeline
   and phase spans inside the fit's wall; (4) phase 4's 200k data fitted
   with ``flight=`` must ``replay`` to the live spans and phases.  It
   prints phase 4's 1M walls from host input beside
   :data:`FIT_1M_HOST_S_BEFORE`.

15. faults, retry, jobstate and resume (:func:`faults_phase`), on data
   and models the script already has: (1) phase 4's 1M x 16-D data
   through the host-stepped route (``PPTORCH_STEP_THRESHOLD=1``) twice:
   labels and core byte-identical to phase 4's fused fit, B1 once, B2 =
   passes - 1, a stepped batch in the report; both walls beside phase
   4's; (2) ``PPTORCH_ROUND_BATCH=1`` with the plan
   ``stepped.batch:2=error`` under ``train(resume=path)``: the fault
   raises ``FaultInjected``, and a fresh ``train(resume=path)`` restores
   at least one batch (``events.jobstate_restore`` >= 1) to (1)'s labels;
   (3) a child process (``chip_smoke.py --faults-child PATH``) runs (2)'s
   fit with ``PPTORCH_CKPT`` and ``stepped.batch:*=hang(1.0)``, and is
   SIGKILLed once its snapshot exists (up to 3 attempts); the resume here
   gives (1)'s labels; (4) 13.1's 20,000 x 16-D case over 8 partitions:
   ``chained.partition:5=error`` with a jobstate raises and the resume
   restores exactly 4 partitions, ``chained.partition:2=transfer_error``
   is retried, ``chained.partition:3=oom`` raises, and
   ``sharded.execute:1=oom`` (the device merge) degrades to
   ``merge_host`` without a second dispatch, each equal to the clean
   run, and no slab-builder thread outlives a failed attempt; (5) an allocation past the card's
   free memory raises ``torch.OutOfMemoryError``, classified OOM and not
   transient, and B1 right after it is bitwise its plain version on
   phase 5's first 64 row tiles; (6) on phase 11's live model (phase 6's
   1M model, written to in phases 11 and 12) ``serve.drain:1=hang(0.3)``
   fails a 0.05 s ticket with ``DeadlineExceeded`` (``deadline_failures``
   + 1), the next request is bitwise the card oracle, and
   ``ingest.batch:1=error`` leaves the index's slab and B5's tables
   bitwise as before.  Every report outside this phase (14.2's) must
   count no injected fault, retry, giveup or degradation.
16. the global-Morton route's chained form (:func:`gm_phase`,
   ``pypardis_tpu_torch.parallel.global_morton_dbscan(..., mesh=1,
   chain=R)``): (1) 13.1's 20,000 x 16-D blobs over 4 ranges under
   ``"high"``, ``"mixed"`` and ``"default"``, and its 4,096 x 512
   embeddings over 2 ranges with the sketch on: the card's labels, core
   flags and non-timing stats equal to the CPU's route (the CPU runs go
   on in 13.1's child process after 13.1's; ``"mixed"``'s band stats
   within 1e-3, phase 8's bar), the counts kernel once per range and
   the min-label kernel once per propagation pass; (2) phase 4's 1M x
   16-D blobs written once to a float32 ``np.memmap`` under
   ``build/chip_smoke_gm/`` over 4 ranges: ``duplicated_work_factor``
   1.0, boundary tiles, the input streamed, B1/B2 launches equal to the
   ranges' passes, held against phase 4's single-device fit as 13.2 is
   (:func:`hold_chained`), then B1 and one B2 pass bitwise their plain
   versions over the owner-computes lists of the largest range slab
   (:func:`gm_slab_hold`: the counts list's first 64 owned row tiles,
   the propagation list's first 64 owned and 64 boundary row tiles);
   the same on the first 200,000 points (the whole 1M until PR 20) at
   eps 1.4, which must hold border points; each prints its
   wall beside 13.2's KD chained wall, the route's stage seconds, peak
   host RSS and ``max_memory_allocated``; (3) phase 7's 100,000 x 512
   embeddings over 2 ranges, sketch on: B3/B4 launched likewise and
   held bitwise on the largest slab, labels held against the
   single-device 100k fit; (4) on (1)'s 20k case,
   ``gm.chained_range:1=transfer_error`` retried once to the clean
   labels, and a run killed at its third propagation range under a
   jobstate resumed byte-identically, its two restored ranges launching
   no B1 and no B2.
17. the KD route's fused multi-device step (:func:`mesh_phase`,
   ``DBSCAN(mesh=Mesh(["cuda:0"] * 4))`` and ``sharded_dbscan(...,
   mesh=...)``: four shards on the one card, whose per-shard code,
   reductions and merge run at full width; the phase prints the mesh
   and the card count): (1) 13.1's 20,000 x 16-D blobs over 8
   partitions (2 per shard) under ``"high"``, ``"mixed"`` and
   ``"default"``, each under both merges, owner-computes on and (for
   ``"high"`` and ``"default"``) off, and its 4,096 x 512 embeddings
   over 2 partitions (2 empty slots) with the sketch on: the card's
   labels, core flags and non-timing stats equal to the port's CPU
   mesh route (the CPU runs go on in the child process of 13.1 and
   16.1, started after phase 4; ``"mixed"``'s band stats within 1e-3),
   the counts kernel once per partition slot and the min-label kernel
   once per other pass; (2) phase 4's 1M x 16-D blobs,
   ``max_partitions`` by default (4, one per shard), under the device
   merge, then the host merge, then at eps 1.4 (which must hold border
   points): ``owner_computes`` on, ``duplicated_work_factor`` = P x cap
   / N, B1 launched once per partition and B2 once per propagation
   pass, each fit held against the single-device fit
   (:func:`hold_chained`), with its wall, stage seconds, merge rounds,
   ``halo_factor``, peak host RSS and ``max_memory_allocated`` beside
   phase 4's and 13.2's walls; B1 and one B2 pass bitwise their plain
   versions over the owner-computes lists of the largest partition slab
   built by the route's own ``build_shards`` (:func:`mesh_largest_slab`,
   :func:`gm_slab_hold`); (3) phase 7's 100,000 x 512 embeddings, sketch
   on: B3/B4 likewise, labels held against the single-device 100k fit;
   (4) on (1)'s 20k case a ``pair_budget`` of 1 reruns once at the exact
   total, ``merge_rounds=1`` on a line of points threading all 8
   partitions retries once at 4x, and ``sharded.execute:1=oom``
   finishes the merge on the host, each with (1)'s labels.
18. the KD route's ring exchange, its streaming build and the
   device-input route (:func:`ring_phase`, ``sharded_dbscan(...,
   halo="ring")`` and ``DBSCAN(mesh=...).fit`` of a memmap and of a
   CUDA tensor, on phase 17's four shards of the one card: each ring
   hop hands a buffer to the next shard on the same device): (1)
   13.1's 20,000 x 16-D blobs over 8 partitions and its 4,096 x 512
   embeddings over 2, each under both merges: the card's labels, core
   flags and non-timing stats equal to the port's CPU ring (the CPU
   runs in the child process of 13.1), launches as in phase 17; (2)
   phase 4's 1M x 16-D blobs over 4 partitions, three ways: the ring
   from host input (labels and core byte-identical to 17.2's host-halo
   fit), a float32 memmap of them through the stream (byte-identical to
   the in-RAM ring; its host memory, traced while it builds alone, below
   the in-RAM layout's: :func:`layout_host_peaks`) and a CUDA tensor
   through the device-input route (held against phase 4's fit of the
   same tensor as phase 17 holds its fits, with no floating tensor of
   N rows brought to the host, :class:`HostFetchSpy`), each with its
   wall beside 17.2's, the stage seconds (``exchange`` by CUDA events),
   ``halo_cap``, ``halo_bytes`` and the ``ring.hcap`` retries; B1 and
   one B2 pass bitwise their plain versions over the owner-computes
   lists of the ring's largest slab, laid out by the route's own code
   (:func:`ring_largest_slab`); (3) phase 7's 100,000 x 512 embeddings
   through the ring, where the ``hcap`` ladder climbs (at least one
   retry, one ``halo_overflow`` event each), labels byte-identical to
   17.3's host-halo fit, B3/B4 held likewise; (4) an explicit ``hcap``
   of one block on (1)'s first case raises "ring halo buffer overflow
   at hcap=...; pass a larger hcap" with one giveup.  The kernels'
   line gains ``launches_ring`` and ``max_abs_err_ring`` (0) for
   B1-B4.

Phase 19 holds the staging cache (:mod:`pypardis_tpu_torch.parallel.
staging`); every phase before it starts with the cache cleared, so its
cold fits stay cold (phase 4 clears before each fit).  (1) Phase 4's 1M
x 16-D host input: the fingerprint's host milliseconds, a cold fit and
a warm one (labels and core byte-identical; the warm fit stages 0
bytes, reuses the cold fit's staged bytes and launches what it
launched), a warm fit at min_samples 20 and a miss at eps 1.4, each
equal to a fit with the cache off, and an input mutated in place that
misses.  (2) Phase 7.3's 1M x 512 host fits run under a raised
``PPTORCH_LAYOUT_CACHE_MAX``; their third fit is the warm refit (under
TF32, byte-identical to the first, the same launches, the layout
reused), reported here.  (3) A 200,000-point sweep at eps [1.0, 1.15],
then a sweep at 0.9 from the cached graph (equal pairs, no bytes
shipped, labels equal to a fit at 0.9).  (4) The KD routes' warm refits, gated
in their phases: 13.1's four chained refits of its 20,000 points
(staged 0, reused the first fit's bytes), 17.2's host-merge refit
(warm) and its eps 1.4 fit (the owned slabs reused, only the halos
shipped), 18.2's ring fit refitted warm; then ``staging.device_put:1=
oom`` injected into a 20,000-point 4-shard fit recovers (one retry,
labels equal).  (5) A second index build over the same model reuses
the first's tensors, 4,096 predicts launch B5, a live insert's delta
bytes equal its delta route's, and a gateway eviction empties the
model's route.  The kernels' line gains ``launches_warm``.

Phase 20 runs the global-Morton mesh engine (:func:`gmmesh_phase`,
``DBSCAN(mode="global_morton", mesh=Mesh(["cuda:0"] * 4))`` and
``global_morton_dbscan(..., mesh=...)``, the shards one after another on
the one card, each ring hop a buffer handed to the next shard on the
same device): (1) 13.1's 20,000 x 16-D blobs over 4 and 8 shards under
both merges, with the overlapped counts on and off: labels, core flags
and non-timing stats equal to the port's CPU mesh engine (its runs in
the child process of 13.1), the counts kernel once per owned-slab pass
and once per shard's cluster pass, the min-label kernel once per
propagation pass; (2) phase 4's 1M x 16-D blobs over 4 shards under the
device merge, then the host merge (a warm refit: it stages nothing and
reuses ``gm_owned`` and ``gm_boundary``), each held against the
single-device fit (:func:`hold_chained`), the two byte-identical, with
the engine's ``gm_*_s`` split, ``exchange_overlap_efficiency``,
``fixpoint_rounds``, ``halo_factor`` and ``sent_tiles`` beside 17.2's
and 18.2's walls; B1's owned-slab and boundary-delta launches and one
B2 pass bitwise their plain versions over the first 64 owned and 64
boundary row tiles of the largest combined slab
(:func:`gmmesh_slab_hold`); (3) phase 7's 100,000 x 512 embeddings with
the sketch: ``sent_tiles`` against ``sent_tiles_box``, B3/B4 likewise on
16 row tiles; (4) the 1M on a one-card mesh with ``chain=0``,
byte-identical to (2) and to 16.2's chained fit; (5) the first 200,000
points from a float32 memmap: ``build_morton_shards_streaming`` bitwise
``build_morton_shards``, the fits byte-identical; (6) on (1)'s data over
4 shards an explicit ``btcap=1`` raises naming the need, injected
``gm.ring_round`` and ``gm.fixpoint_round`` transfer errors retry once
to the clean labels, a warm refit reuses both routes and an eps change
the owned slabs only.  The kernels' line gains ``launches_gmmesh`` and
``max_abs_err_gmmesh`` (0) for B1-B4.

The script prints its total seconds.  The line before the last is the
kernels' JSON record; the last line is ``{"ok": true, "device":
{...}}``.  Without a CUDA device the script exits non-zero and prints
no result.

``python3 chip_smoke.py --metrics`` builds the kernels and runs phase 9
alone; ``--hier`` builds them and runs phase 10 alone; ``--live`` builds
them, fits the 1M model and runs phase 11 alone; ``--gateway`` builds
them, fits the 1M model, builds its live model and runs phase 12 alone;
``--chained`` builds them and runs phase 13 alone (fitting the 1M
single-device model it compares with); ``--report`` builds them and
runs phase 14 alone on its own fits (phase 4's 1M fit twice, phase 5's
B1 inputs, 13.2's chained fit).
``--hold-reps N`` (with any of the above, or alone for the whole
script) runs every gate-1 hold of the index (:func:`hold_index`: after
each live commit, each served check, the compaction and the ingest
harness) N times over, each failing the run on a difference: a search
for a difference that does not show on every computation.
``--faults`` builds them and runs phase 15 alone on its own fits
(phase 4's 1M fit twice from host input, phase 5's B1 inputs, that
model's live model and 13.1's 20,000-point case).  ``--gm`` builds
them and runs phase 16 alone (fitting the 1M single-device model it
compares with; 16.1's CPU runs in a child process of their own).
``--gmmesh`` builds them and runs phase 20 alone (fitting the 1M and
the 100k x 512 single-device models it compares with; 20.1's CPU runs in
a child process of their own).
``--mesh`` builds them and runs phase 17 alone (fitting the 1M, the
1M at eps 1.4 and the 100k x 512 single-device models it compares
with; 17.1's CPU runs in a child process of their own).  ``--ring``
builds them and runs phase 18 alone (fitting the 1M single-device
model from a CUDA tensor and the 1M and 100k x 512 host-halo mesh fits
it compares with; 18.1's CPU runs in a child process of their own).
``--staging`` builds them and runs phase 19 alone (fitting its own
data; 19.2 and the KD routes' records come only with the whole run).
``python3 chip_smoke.py --b1`` builds the kernels and times B1 alone
in its three modes at the 1M x 16-D inputs, with its bounds, floor,
rescored share and frames' staging, then prints the 1M fits' sha256 in
every mode from host input and from a tensor (:func:`b1_timings`);
copied into a parent tree's root it times that tree's B1 in the same
call, for an A/B.
``python3 chip_smoke.py --b5`` builds the kernels and times exact and
mixed B5 on phase 6's 16 batches from the 1M x 16-D model fitted from
a CUDA tensor, with each batch's fill and bounds, then the warm drain
against the sync ``predict`` per batch (:func:`b5_timings`); copied
into a parent tree's root it times that tree's B5 in the same call.
``python3 chip_smoke.py --profile`` instead builds the kernels and
profiles a 1M x 16-D fit, one serving drain (``torch.profiler``, then
``cProfile`` for the drain's host side) and a 1M x 512 sketched fit;
see :func:`profile_fit`.  ``python3 chip_smoke.py --b4`` builds the
kernels and runs only the timings of phase 7 (4), without the plain
versions' checks: the quick way to time B3 (with its rescored pairs
and both bounds) and B4 per round.  ``--b2`` does the same for B2
(:func:`b2_timings`: each round of the 1M x 16-D fit in all three
modes, B1 beside it, and B1/B2 without the sketch
at 100,000 x 512); copied into a parent tree's root it times that
tree's kernels too, for an A/B in one call.  ``--b2-walk`` measures
the label-bound skip's evaluated share per round from the plain walk
alone (:func:`b2_walk_shares`).
"""

from __future__ import annotations

import atexit
import contextlib
import gc
import hashlib
import json
import os
import subprocess
import sys
import time
import tracemalloc

import numpy as np

# H100 SXM peaks (NVIDIA data sheet): FP32 outside the tensor cores and
# HBM3 bandwidth.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12


def log(*a):
    print(*a, flush=True)


def fail(msg):
    print(f"FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def ari(a, b) -> float:
    """Adjusted Rand index (noise counts as its own class)."""
    a = np.unique(np.asarray(a), return_inverse=True)[1].ravel()
    b = np.unique(np.asarray(b), return_inverse=True)[1].ravel()
    n = len(a)
    cont = np.zeros((a.max() + 1, b.max() + 1), np.int64)
    np.add.at(cont, (a, b), 1)

    def c2(x):
        x = np.asarray(x, np.float64)
        return float((x * (x - 1) / 2).sum())

    s = c2(cont)
    sa, sb = c2(cont.sum(1)), c2(cont.sum(0))
    expected = sa * sb / c2([n])
    top = 0.5 * (sa + sb)
    return 1.0 if top == expected else (s - expected) / (top - expected)


def guard_banded_blobs(d, n=8192, eps=2.0, band=1e-3, seed=7):
    """Blobs with no pair within ``band * eps^2`` of eps^2 (float64
    check), so any exact d^2 formulation gives the same adjacency."""
    rng = np.random.default_rng(seed)
    m = n + n // 2
    centers = rng.uniform(-10, 10, size=(8, d))
    X = (
        centers[rng.integers(0, 8, size=m)]
        + rng.normal(scale=0.3 * np.sqrt(8 / d), size=(m, d))
    ).astype(np.float32)
    x64 = X.astype(np.float64)
    sq = (x64 * x64).sum(1)
    keep = np.ones(m, bool)
    for s in range(0, m, 1024):
        rows = slice(s, s + 1024)
        d2 = sq[rows, None] + sq[None, :] - 2.0 * x64[rows] @ x64.T
        keep[rows] = ~(
            np.abs(d2 - eps * eps) < band * eps * eps
        ).any(axis=1)
    X = X[keep][:n]
    if len(X) < n:
        fail("guard-banded data generation left too few points")
    return X


def cold(fn):
    """``fn`` for ``median_ms(cold(fn), 1)``: one timed call, the warm-up
    call skipped (for plain versions and kernels whose calls take
    seconds and compile nothing; the call just before on the same inputs
    warmed the allocator)."""
    calls = iter((False, True))
    return lambda: fn() if next(calls) else None


def _dev_us(e):
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0))


def _on_device(e):
    """Kernels and copies themselves, not the aten ops that launched
    them (those carry the same device time again) nor the profiler's own
    buffer requests."""
    from torch.autograd import DeviceType

    return (getattr(e, "device_type", None) == DeviceType.CUDA
            and not e.key.startswith("Activity Buffer"))


def _profiled(torch, what, run):
    """Run ``run()`` under ``torch.profiler`` and print the wall, the
    device's busy and idle share, device time by kernel and host time by
    op.  The profiler's own overhead inflates the wall it measures."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    events = [e for e in prof.key_averages() if _on_device(e)]
    busy = sum(_dev_us(e) for e in events)
    log(f"profile {what}: wall {wall_us / 1e3:.2f} ms, device busy "
        f"{busy / 1e3:.2f} ms, idle share {1 - busy / wall_us:.4f}")
    for e in sorted(events, key=_dev_us, reverse=True)[:12]:
        if _dev_us(e) <= 0:
            break
        log(f"  device {_dev_us(e) / 1e3:10.3f} ms x{e.count:<6d} "
            f"{e.key[:100]}")
    host = [e for e in prof.key_averages() if not _on_device(e)]
    for e in sorted(host, key=lambda e: e.self_cpu_time_total,
                    reverse=True)[:8]:
        log(f"  host   {e.self_cpu_time_total / 1e3:10.3f} ms "
            f"x{e.count:<6d} {e.key[:100]}")


def profile_fit(torch, DBSCAN, make_blob_data):
    """``--profile``: where one 1M x 16-D main-path fit spends its time
    (after a warm fit), from host input and from a CUDA tensor; where
    one serving drain of 16 batches of 4,096 queries spends its time on
    the host-input model's index; and where one sketched 1M x 512 fit
    (phase 7's geometry) spends its time, from a CUDA tensor."""
    X, _ = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
    for source in ("host", "cuda"):
        Xin = X if source == "host" else torch.from_numpy(X).cuda()
        model = DBSCAN(eps=2.4, min_samples=10, block=2048)
        model.fit(Xin)
        _profiled(torch, f"n=1000000 fit from {source}",
                  lambda: model.fit(Xin))
        if source == "host":
            served = model
    eng = served.query_engine()
    rng = np.random.default_rng(12)
    batches = [
        X[rng.integers(0, len(X), 4096)]
        + rng.normal(scale=0.3, size=(4096, X.shape[1])).astype(X.dtype)
        for _ in range(16)
    ]

    def drain():
        for b in batches:
            eng.submit(b)
        eng.drain()

    drain()
    _profiled(torch, "serving drain of 16 x 4096 queries", drain)
    # The host side of a drain by Python function (torch.profiler sees
    # only the torch ops; the routing, assembly and fold are numpy).
    import cProfile
    import pstats

    prof = cProfile.Profile()
    prof.runcall(drain)
    torch.cuda.synchronize()
    stats = pstats.Stats(prof)
    total = sum(v[2] for v in stats.stats.values())
    log(f"cProfile serving drain: {total * 1e3:.2f} ms of host time "
        f"(profiler overhead included); by own time:")
    for (file, line, fn), v in sorted(stats.stats.items(),
                                      key=lambda kv: kv[1][2],
                                      reverse=True)[:14]:
        log(f"  {v[2] * 1e3:9.3f} ms own {v[3] * 1e3:9.3f} ms with callees "
            f"x{v[1]:<6d} {os.path.basename(file)}:{line} {fn}")
    # The sketched 1M x 512 fit from a CUDA tensor, after a warm fit.
    from benchdata import make_embedding_data

    del served, eng, X
    X, _ = make_embedding_data(1_000_000, 512)
    Xd = torch.from_numpy(X).cuda()
    del X
    model = DBSCAN(eps=2.0, min_samples=10, block=2048)
    model.fit(Xd)
    _profiled(torch, "n=1000000 d=512 sketched fit from cuda",
              lambda: model.fit(Xd))


def serve_traffic(model, X):
    """Phase 6's traffic, made with numpy from a fixed seed and shuffled:
    65,536 + 4,096 queries, half jittered training points, a quarter
    exact core points, a quarter uniform over the data's box.  Returns
    (queries, kind, source rows, the 16 batches of 4,096, the sync
    predict's 4,096)."""
    rng = np.random.default_rng(12)
    n_q, per = 65_536 + 4096, 4096
    core_rows = np.flatnonzero(model.core_sample_mask_)
    src = np.concatenate([
        rng.integers(0, len(X), n_q // 2),
        core_rows[rng.integers(0, len(core_rows), n_q // 4)],
    ])
    Q = np.concatenate([
        X[src[:n_q // 2]] + rng.normal(scale=0.3, size=(n_q // 2, X.shape[1])),
        X[src[n_q // 2:]],
        rng.uniform(X.min(axis=0), X.max(axis=0),
                    size=(n_q - len(src), X.shape[1])),
    ]).astype(X.dtype)
    kind = np.repeat([0, 1, 2], [n_q // 2, n_q // 4, n_q - len(src)])
    perm = rng.permutation(n_q)
    Q, kind = Q[perm], kind[perm]
    src = np.concatenate([src, np.full(n_q - len(src), -1)])[perm]
    batches = [Q[s:s + per] for s in range(0, 65_536, per)]
    return Q, kind, src, batches, Q[65_536:]


# PAD_COORD's bits: pad slots and pad query rows hold them in every axis.
PAD_BITS = int(np.float32(2e19).view(np.int32))
INT32_MAX = np.iinfo(np.int32).max


def b5_fill(idx, tile_leaf, rowmap, qb):
    """The fill of one assembled batch, from the index's host arrays
    alone (so it reads a parent tree's index too): real tiles / nqt,
    real rows / rows of the real tiles, real slots / leaf_cap over the
    real tiles' leaves, the real (row, core slot) pairs, and the pairs
    of every row of every tile against the whole slab (what the first
    form launched; computed here, not measured)."""
    C, L = idx.leaf_cap, idx.n_leaves
    nqt = len(tile_leaf)
    lab = idx.labels.reshape(L, C)
    per_leaf = (lab != INT32_MAX).sum(1)
    pad = (lab == INT32_MAX) & (
        idx.coords.view(np.int32) == PAD_BITS).all(0).reshape(L, C)
    ends = np.where((~pad).any(1), C - np.argmax(~pad[:, ::-1], axis=1), 0)
    rows = np.array([len(a) for a in rowmap], np.int64)
    tl = np.asarray(tile_leaf)[:len(rowmap)]
    real = int((rows * per_leaf[tl]).sum())
    return dict(
        nqt=nqt, real_tiles=len(rowmap), tile_fill=len(rowmap) / nqt,
        row_fill=float(rows.sum() / max(len(rowmap) * qb, 1)),
        slot_fill=float(per_leaf[tl].mean() / C) if len(tl) else 0.0,
        pad_waste=idx.stats.get("pad_waste"), leaf_cap=C,
        real_rows=int(rows.sum()), real_pairs=real,
        all_pairs=nqt * qb * C, ends=ends, per_leaf=per_leaf,
        leaves=np.unique(tl),
    )


def fill_line(f, pass_pairs=None):
    """One batch's fill; with ``pass_pairs``, the pairs B5's pass
    computed as its counter read them on the card."""
    real = f["real_pairs"]
    ran = ("" if pass_pairs is None else
           f"{real / max(pass_pairs, 1):.4f} of the {pass_pairs} the pass "
           f"computed (measured), ")
    return (f"tiles {f['real_tiles']}/{f['nqt']} ({f['tile_fill']:.4f}), "
            f"rows of real tiles {f['row_fill']:.4f}, slots of leaf_cap "
            f"{f['slot_fill']:.4f} (leaf_cap {f['leaf_cap']}, pad_waste "
            f"{f['pad_waste']}); real (row, slot) pairs {real}: {ran}"
            f"{real / max(f['all_pairs'], 1):.4f} of the {f['all_pairs']} "
            f"of every row against every slot (computed)")


def b5_bounds(f, d, kept_pairs=None):
    """B5's bound at one batch's real work (``f`` from :func:`b5_fill`):
    each real row against its leaf's core slots, 3d FP32 operations
    (sub, mul, add per axis) and the compare per pair; the bytes of the
    real query rows, the core slots of each referenced leaf and the leaf
    ids once, and a (label, d^2) per real row.  With ``kept_pairs`` (the
    real pairs ``query_keep_walk`` keeps, counted pair by pair) the
    "mixed" bound: the least of the exact bound and the prefilter's
    2·16·ceil(d/16) tensor-core operations and ~17 FP32 (d2f, the
    per-element band, the test) per real pair plus the exact pass over
    the kept pairs, since either answers "mixed".  Returns (bound_ms,
    bound_by, simt_ceiling_ms, nbytes): the sealed arithmetic issues one
    instruction per FP32 operation, so its SIMT ceiling is twice its
    share of the bound."""
    pairs, rows = f["real_pairs"], f["real_rows"]
    nbytes = (rows * d * 4 + int(f["per_leaf"][f["leaves"]].sum()) * (d + 1)
              * 4 + f["real_tiles"] * 4 + 2 * rows * 4)
    t_bytes = nbytes / PEAK_BYTES_PER_S
    forms = [(0.0, pairs * (3 * d + 1))]  # (tensor-core s, SIMT ops)
    if kept_pairs is not None:
        K = -(-d // 16) * 16
        forms.append((2 * K * pairs / PEAK_BF16_FLOPS,
                      pairs * 17 + kept_pairs * (3 * d + 1)))
    t_tc, simt = min(forms, key=lambda x: x[0] + x[1] / PEAK_FP32_FLOPS)
    t_ops = t_tc + simt / PEAK_FP32_FLOPS
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes",
            (t_tc + 2 * simt / PEAK_FP32_FLOPS) * 1e3, nbytes)


def b5_call(ck, idx, q, tl, **kw):
    """One B5 launch on ``idx``'s slab with its tables (a parent tree's
    index has none and its wrapper takes none)."""
    coords, labels, _blo, _bhi = idx.device_tensors()
    if hasattr(idx, "kernel_tables"):
        kw["tables"] = idx.kernel_tables()
    return ck.query_leaf(q, tl, coords, labels, block=idx.block, nb=idx.nb,
                         **kw)


def hold_tables(torch, idx, what):
    """B5's per-index tables on the card against their plain versions,
    bitwise; returns the number of differing words."""
    from pypardis_tpu_torch.ops.query import (
        query_block_frames, query_leaf_ends, query_pad_keys,
    )

    coords, labels, _blo, _bhi = idx.device_tensors()
    got = idx.kernel_tables()
    C = idx.leaf_cap
    want = (query_pad_keys(coords, labels, C),
            query_leaf_ends(coords, labels, C),
            *query_block_frames(coords, labels, idx.block))
    bad = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
              for g, w in zip(got, want))
    full = int(((got[0] >> 32) == 0x7F800000).sum())
    log(f"  B5 tables ({what}): {idx.n_leaves} leaves, {full} without a "
        f"pad slot; pad keys, leaf ends and block frames against their "
        f"plain versions: {bad} differing words")
    if bad:
        fail(f"B5's tables differ from their plain versions ({what})")
    return bad


def serve_phase(torch, model, X, median_ms):
    """Phase 6 (see the module docstring); returns B5's JSON records and
    what phase 8 reuses: the engine, the batches, the drain's answers,
    the oracle's answers on the first 512 queries and batch 2's
    tiles."""
    import tempfile

    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.query import (
        brute_force_query, query_block_frames, query_leaf_ends,
        query_min_core_plain, query_pad_keys, query_pass_pairs,
    )
    from pypardis_tpu_torch.serve import CorePointIndex

    dev = model.device
    Q, kind, src, batches, sync_q = serve_traffic(model, X)
    per = len(batches[0])

    # The main path, counts from 0: the engine (its index and B5's
    # tables), 16 submits, one drain, one predict.
    ck.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng = model.query_engine()
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t
    idx = eng.index
    t = time.perf_counter()
    tickets = [eng.submit(b) for b in batches]
    done = eng.drain()
    drain_wait_s = eng.device_wait_s
    sync_lab, sync_dist = eng.predict(sync_q, return_distance=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = ck.LAUNCHES["query_leaf"]
    t_launches = ck.LAUNCHES["query_tables"]
    st = eng.serving_stats()
    log(f"  index build {build_s:.3f} s: {idx.n_core} cores, "
        f"{idx.n_leaves} leaves, leaf_cap {idx.leaf_cap}, block "
        f"{idx.block}, qblock {idx.qblock}, "
        f"{idx.stats['index_bytes'] / 1e6:.1f} MB "
        f"({idx.index_device_bytes} bytes on the card with B5's tables), "
        f"pad waste {idx.stats['pad_waste']}; {t_launches} table builds")
    log(f"  served {done} + {len(sync_q)} queries in {wall:.4f} s: "
        f"{st['batches']} batches, {launches} B5 launches; queries/s "
        f"{st['qps']}, p50 {st['p50_ms']} ms, p99 {st['p99_ms']} ms, "
        f"batch fill {st['batch_fill']}; the host waited on the card "
        f"{drain_wait_s * 1e3:.3f} ms in the drain of {len(batches)} "
        f"batches, {(eng.device_wait_s - drain_wait_s) * 1e3:.3f} ms in "
        f"the sync predict")
    if launches < 1 or launches != st["batches"]:
        fail(f"B5 launches {launches} != batches {st['batches']}")
    if t_launches != 1:
        fail(f"B5's tables were built {t_launches} times, not once")
    lab = np.concatenate([tk.result() for tk in tickets] + [sync_lab])
    d2 = np.concatenate([tk.d2 for tk in tickets])

    coords, labels, _blo, _bhi = idx.device_tensors()
    err = 0
    tables_err = hold_tables(torch, idx, "the served index")

    def tiles(qs, index=idx):
        qbuf, tile_leaf, rowmap = index.assemble(index.prepare_queries(qs))
        return (torch.from_numpy(qbuf).to(dev),
                torch.from_numpy(tile_leaf).to(dev), rowmap)

    def hold(b, index=idx, what=None, qs=None):
        nonlocal err
        what = what or f"batch {b}"
        q, tl, rowmap = tiles(batches[b] if qs is None else qs, index)
        c, l, _lo, _hi = index.device_tensors()
        args = (q, tl, c, l)
        ran = torch.zeros(1, dtype=torch.int64, device=dev)
        kern = b5_call(ck, index, q, tl, pass_stats=ran)
        plain = query_min_core_plain(*args, block=index.block, nb=index.nb)
        diff = (kern.long() - plain.long()).abs()
        err = max(err, int(diff.max()))
        bad = int((diff != 0).sum())
        f = b5_fill(index, tl.cpu().numpy(), rowmap, q.shape[2])
        # The pass's own count of the pairs it computed, against the
        # plain count of the rule (groups without a real row run
        # nothing, the others stop at the leaf's end).
        f["pass_pairs"] = int(ran)
        want = query_pass_pairs(q, tl, index.kernel_tables()[1],
                                block=index.block, nb=index.nb)
        log(f"  B5 {what}: {f['real_rows']} routed rows in {len(rowmap)} "
            f"tiles (nqt {q.shape[0]}); max|kernel-plain| = "
            f"{int(diff.max())}, mismatches = {bad}; pass pairs "
            f"{f['pass_pairs']} (query_pass_pairs {want}); "
            f"{fill_line(f, f['pass_pairs'])}")
        if bad:
            fail(f"query_leaf disagrees with its plain version on {what}")
        if f["pass_pairs"] != want:
            fail(f"B5's pass computed {f['pass_pairs']} pairs on {what}, "
                 f"not the {want} of query_pass_pairs")
        return args, rowmap, kern, f

    hold(0)
    hold(1)
    # An index whose one leaf has no pad slot (4,096 cores, block 256)
    # and 3,000 queries (24 tiles, 8 pad tiles): its pad rows and pad
    # tiles answer (+inf, the leaf's least label).
    sel = idx.labels != INT32_MAX
    full = CorePointIndex.build(
        np.ascontiguousarray(idx.coords[:, sel][:, :4096].T),
        idx.labels[sel][:4096], idx.eps, leaves=1, block=256,
        qblock=idx.qblock, device=dev)
    tables_err = hold_tables(torch, full, "one full leaf")
    (q, tl, _c, _l), rowmap, kern, _f = hold(
        0, full, "one full leaf", idx.coords[:, sel][:, :3000].T
        + full.center.astype(np.float32))
    pad_rows = (q.view(torch.int32) == PAD_BITS).all(dim=1)
    least = int(full.labels.min())
    fd2 = kern[1].view(torch.float32)
    ok = (bool(torch.isinf(fd2[pad_rows]).all())
          and bool((kern[0][pad_rows] == least).all()))
    log(f"  one full leaf: {int(pad_rows.sum())} pad rows answer (+inf, "
        f"{least}): {ok}")
    if not ok or not int(pad_rows.sum()):
        fail("the pad rows of a full leaf did not answer (+inf, least label)")
    del full

    # (b) the card oracle (numpy's op sequence in torch) over all cores
    # on 512 queries, tied to the numpy oracle on its first rows.
    qf = idx.prepare_queries(Q[:512])
    sel_t = torch.from_numpy(sel).to(dev)
    t = time.perf_counter()
    olab, od2 = card_oracle(torch, qf, coords[:, sel_t], labels[sel_t],
                            idx.eps2)
    k = 8
    nlab, nd2 = brute_force_query(
        qf[:k], np.ascontiguousarray(idx.coords[:, sel].T), idx.labels[sel],
        idx.eps)
    tie = (np.array_equal(nlab, olab[:k])
           and np.array_equal(nd2.view(np.int32), od2[:k].view(np.int32)))
    same = (np.array_equal(olab, lab[:512])
            and np.array_equal(od2.view(np.int32), d2[:512].view(np.int32)))
    log(f"  (b) 512 queries vs the card oracle over {int(sel.sum())} cores "
        f"({time.perf_counter() - t:.1f} s): labels and d2 bits equal: "
        f"{same}; noise {int((olab < 0).sum())}; the card oracle equals "
        f"the numpy one on {k} rows: {tie}")
    if not (same and tie):
        fail("predict differs from the brute-force oracle")
    # (c) exact core points keep their training label.
    c = kind == 1
    own = np.array_equal(lab[c], model.labels_[src[c]])
    log(f"  (c) {int(c.sum())} exact core points predict their own label: "
        f"{own}")
    if not own:
        fail("a core point predicted another label than its own")
    # (d) checkpoint round trip, served without the training data.
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "model.npz")
        model.save(path)
        loaded = DBSCAN.load(path)
    got_lab, got_dist = loaded.query_engine().predict(
        sync_q, return_distance=True
    )
    same = (loaded.data is None and np.array_equal(got_lab, sync_lab)
            and np.array_equal(got_dist, sync_dist))
    log(f"  (d) save -> load (no training data) -> predict byte-identical: "
        f"{same}")
    if not same:
        fail("the loaded model predicts differently")

    warm = warm_drain_sync(eng, batches, per)
    # The drain's one serving.* gauge publish (serve/engine._publish),
    # timed alone beside the drain it rides on.
    t = time.perf_counter()
    for _ in range(200):
        eng._publish()
    pub_ms = (time.perf_counter() - t) / 200 * 1e3
    log(f"  the drain's serving.* gauge publish: {pub_ms * 1e3:.1f} us, "
        f"{pub_ms / (warm['drain'] * len(batches)):.6f} of a warm drain "
        f"of {len(batches)} batches")

    # Where one batch's time goes: the stages of batch 3, each on its
    # own and synchronised (host clock).
    from pypardis_tpu_torch.ops.query import unpack_query_result
    from pypardis_tpu_torch.serve.engine import fold_leaves

    stages = {}

    def stage(name, fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        stages[name] = (time.perf_counter() - t) * 1e3
        return out

    qf = stage("prepare", lambda: idx.prepare_queries(batches[3]))
    stage("route", lambda: idx.route(qf))
    qbuf, tl_np, rowmap = stage("assemble (with route)",
                                lambda: idx.assemble(qf))
    q, tl = stage("H2D", lambda: (torch.from_numpy(qbuf).to(dev),
                                  torch.from_numpy(tl_np).to(dev)))
    packed = stage("B5", lambda: b5_call(ck, idx, q, tl))
    labs, d2r = stage("D2H", lambda: unpack_query_result(packed))
    stage("fold", lambda: fold_leaves(len(qf), rowmap, labs, d2r))
    log("  batch 3 stages (ms): " + ", ".join(
        f"{k} {v:.3f}" for k, v in stages.items()))

    # B5 alone on batch 2's tiles (also held against its plain version).
    args, rowmap, _kern, f = hold(2)
    kw = dict(block=idx.block, nb=idx.nb)
    ms = median_ms(lambda: b5_call(ck, idx, args[0], args[1]), 10)
    plain_ms = median_ms(lambda: query_min_core_plain(*args, **kw), 3)
    d = args[0].shape[1]
    bound_ms, bound_by, ceiling_ms, nbytes = b5_bounds(f, d)
    pairs = f["real_pairs"]
    log(f"  query_leaf: {ms:.4f} ms per 4096-query batch (plain "
        f"{plain_ms:.2f} ms), bound {bound_ms:.4f} ms by {bound_by}, "
        f"unfused SIMT ceiling {ceiling_ms:.4f} ms; {f['real_rows']} real "
        f"rows in {len(rowmap)} tiles, {pairs} row x core pairs, {nbytes} "
        f"bytes; {pairs * (3 * d + 1) / (ms * 1e-3) / 1e12:.2f} TFLOP/s "
        f"of needed work")
    record = {
        "name": "query_leaf", "route": "cuda",
        "source": "pypardis_tpu_torch/csrc/query_kernels.cu",
        "replaces": "pypardis_tpu/ops/pallas_kernels.py:1107",
        "launches": launches // st["batches"], "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "simt_ceiling_ms": ceiling_ms,
        # No single PyTorch call computes (min d^2, min label among
        # ties) over a leaf slab.
        "library_ms": None,
        # Measured: the real pairs over those the pass's counter read.
        "real_share": f["real_pairs"] / max(f["pass_pairs"], 1),
    }
    # The tables alone: built once per index (two kernels, one launch
    # counted), bound by the bytes of the slab read once and the tables
    # written once.
    L, C = idx.n_leaves, idx.leaf_cap
    t_ms = median_ms(lambda: ck.query_tables(coords, labels, **kw), 5)
    t_plain = median_ms(lambda: (
        query_pad_keys(coords, labels, C), query_leaf_ends(coords, labels, C),
        query_block_frames(coords, labels, idx.block)), 3)
    t_bytes = (L * C * (d + 1) * 4 + L * 12 + L * idx.nb * d * 4
               + L * C * 16)
    # Per slot: the pad row's d2 (3d) and the frames' box (2d), |y-c|^2
    # (3d) and |y|^2 (2d), two square roots and the compares.
    t_ops = L * C * (10 * d + 4)
    t_b = max(t_bytes / PEAK_BYTES_PER_S, t_ops / PEAK_FP32_FLOPS) * 1e3
    log(f"  query_tables: {t_ms:.4f} ms per index (plain {t_plain:.2f} ms),"
        f" bound {t_b:.4f} ms by bytes ({t_bytes} bytes)")
    tables_record = {
        "name": "query_tables", "route": "cuda",
        "source": "pypardis_tpu_torch/csrc/query_kernels.cu",
        "replaces": "pypardis_tpu/ops/pallas_kernels.py:1107",
        "launches": t_launches, "max_abs_err": tables_err, "ms": t_ms,
        "plain_ms": t_plain, "bound_ms": t_b,
        "bound_by": ("bytes" if t_bytes / PEAK_BYTES_PER_S
                     >= t_ops / PEAK_FP32_FLOPS else "operations"),
        "library_ms": None,
    }
    ctx = dict(engine=eng, batches=batches, lab=lab[:len(d2)], d2=d2,
               olab=olab, od2=od2, Q512=Q[:512], tiles=args, rowmap=rowmap,
               fill=f)
    return [record, tables_record], ctx


def warm_drain_sync(eng, batches, per, rounds=5):
    """Steady state on the warm engine (the first drain also allocates
    pinned buffers): the batches as one drain, where B5 of a batch runs
    while the host folds the one before and assembles the next, against
    as many sync predicts, where each batch's B5 sits between its
    assembly and its fold; interleaved, ``rounds`` each.  Returns the
    median ms per batch of each."""
    modes = {"drain": [], "sync": []}
    waits = {"drain": [], "sync": []}
    for _ in range(rounds):
        for mode in modes:
            w0 = eng.device_wait_s
            t = time.perf_counter()
            if mode == "drain":
                for b in batches:
                    eng.submit(b)
                eng.drain()
            else:
                for b in batches:
                    eng.predict(b)
            modes[mode].append((time.perf_counter() - t) * 1e3
                               / len(batches))
            waits[mode].append((eng.device_wait_s - w0) * 1e3)
    for mode, ms_b in modes.items():
        log(f"  warm {mode} of {len(batches)} x {per}: ms per batch "
            f"{[round(x, 4) for x in ms_b]} (median {np.median(ms_b):.4f},"
            f" {per / np.median(ms_b) * 1e3:.1f} queries/s); host waits "
            f"on the card, ms per {len(batches)} batches "
            f"{[round(x, 3) for x in waits[mode]]}")
    return {m: float(np.median(v)) for m, v in modes.items()}


def noise_dominated(n, dim, n_centers=8, seed=0, sigma=0.5):
    """The sketch's noise-dominated geometry (the JAX package's
    tests/test_sketch.py): equidistant centres on a scaled orthonormal
    basis plus full-rank noise that dominates every axis."""
    rng = np.random.default_rng(seed)
    eps = round(1.06 * sigma * np.sqrt(2.0 * dim), 2)
    basis = np.linalg.qr(rng.normal(size=(dim, n_centers)))[0]
    centers = (3.5 * eps / np.sqrt(2.0)) * basis.T
    truth = rng.integers(0, n_centers, size=n)
    X = centers[truth] + rng.normal(scale=sigma, size=(n, dim))
    return X.astype(np.float32), eps


def b4_chunks(rp, tile, rows_per_block=256):
    """Every (block, 32-column chunk) pair B4 could evaluate on a pair
    list: its entries x blocks per row tile x chunks per column tile."""
    return int(rp[-1]) * -(-tile // rows_per_block) * -(-tile // 32)


def b4_floor_pairs(torch, labels, rp, cols, best, tile, live=None):
    """The pairs a label-exact B4 (or B2) must rule out on these inputs:
    per row r with answer a_r (``best``), the source columns of its live
    column tiles with a label below a_r, plus one (the witness) where
    a_r < INT32_MAX; rows outside ``live`` (the rows the caller no longer
    needs) count nothing.  Counted on the card from each column tile's
    sorted labels with ``torch.searchsorted``; non-sources carry
    INT32_MAX and never count."""
    nt = labels.shape[0] // tile
    srt = labels.view(nt, tile).sort(dim=1).values.contiguous()
    per = (rp[1:] - rp[:-1]).long()
    rows_t = torch.repeat_interleave(torch.arange(nt, device=labels.device),
                                     per)
    cols_t = cols[:int(rp[-1])].long()
    if live is not None:
        best = torch.where(live, best, -2**31)
    a = best.view(nt, tile)
    total = int(((best != 2**31 - 1) & (best != -2**31)).sum())
    for s in range(0, rows_t.numel(), 4096):
        r, c = rows_t[s:s + 4096], cols_t[s:s + 4096]
        total += int(torch.searchsorted(srt[c], a[r].contiguous()).sum())
    return total


# H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet).
PEAK_BF16_FLOPS = 989e12


# Sizes of the B2 hold; tests rehearse it at small ones on the CPU.
B2_SIZES = {"sub_tiles": 64, "reps": 5}
# FP32 operations per pair of the bf16 B1/B2 epilogue: d2f (add, mul,
# sub) and the compare, plus the band test (sub, abs-compare) in "mixed".
EPILOGUE_OPS = {"mixed": 6, "default": 4}


def _takes(fn, name):
    """Whether the wrapper ``fn`` takes the keyword ``name`` (a parent
    tree's B2 wrappers, timed by this script for an A/B, take no skip
    keywords)."""
    import inspect

    params = inspect.signature(fn).parameters
    return name in params or any(p.kind == p.VAR_KEYWORD
                                 for p in params.values())


def b2_rounds(torch, dev, median_ms, sync, xs, mask, modes, fit_launches,
              sizes=B2_SIZES, check=True):
    """B2 alone at each round's labels of the 1M x 16-D fit (``xs``,
    ``mask`` staged as a host-input fit stages them) in each of
    ``modes``: the fit's round loop replayed (``ops/labels.
    _pointer_jump``) with the live rows the fit passes; per round the
    kernel's CUDA-event median, its evaluated share of (block, chunk)
    pairs and its bound, the label-exact floor (:func:`b4_floor_pairs`'
    rule over B2's pairs and live rows, x 3d + 1 FP32 operations, or 2K
    tensor-core operations plus the epilogue under bf16, against the
    bytes; as B4's), with the work without the skip beside it (every
    source column of the live tiles).  With ``check``,
    over the first ``sub_tiles`` row tiles at each round's labels: the
    kernel bitwise its plain version and ``minlab_pairs_walk``, and its
    evaluated count equal to the walk's (``"mixed"`` also bitwise the
    FP32 kernel).  Returns one JSON record per mode."""
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import INT_INF, eps2_f32, row_offsets
    from pypardis_tpu_torch.ops.labels import _pointer_jump

    if check:
        from pypardis_tpu_torch.ops.distances import minlab_pairs_walk
    d, N = xs.shape
    e2 = eps2_f32(2.4)
    K = -(-d // 16) * 16
    idx = torch.arange(N, device=dev, dtype=torch.int32)
    records = []
    for mode in modes:
        name = "minlab_pairs" if mode == "high" else f"minlab_pairs_{mode}"
        kern = getattr(ck, name)
        plain = ck.PLAIN[name]
        skip = _takes(kern, "evaluated")
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, 2.4, mask, 2048, mode)
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                xs, 2.4, mask, 2048, mode, budget=total)
        tile = ck._pallas_block(2048, N, d, mode)
        nt = N // tile
        rp = row_offsets(rows, nt)
        mi = mask.to(torch.int32)
        centers, rnorm = ck.tile_frames(xs, mask, tile)
        frames = {"high": (), "mixed": (centers, rnorm),
                  "default": (centers,)}[mode]
        counts = (ck.count_pairs_default(xs, mi, rp, cols, e2, tile, centers)
                  if mode == "default"
                  else ck.count_pairs(xs, mi, rp, cols, e2, tile))
        core = (torch.clamp_min(torch.where(mask, counts, 0), 1)
                >= 10) & mask
        sub = min(sizes["sub_tiles"], nt)
        rp_sub = torch.cat([rp[:sub + 1], rp[sub].repeat(nt - sub)])
        cols_t = cols[:int(rp[-1])].long()
        rpb = 256 if mode == "high" else 128
        chunks = int(rp[-1]) * -(-tile // rpb) * -(-tile // 32)
        # The work without the skip: every row of a live tile pair
        # against the source columns; bytes: points, labels, list,
        # frames.
        pairs = int(core.view(nt, tile).sum(1)[cols_t].sum()) * tile
        in_bytes = (d * N * 4 + N * 4 + rp.numel() * 4 + cols.numel() * 4
                    + sum(t.numel() * 4 for t in frames) + N)
        t_bytes = (in_bytes + N * 4) / PEAK_BYTES_PER_S

        def ops_s(p):
            if mode == "high":
                return p * (3 * d + 1) / PEAK_FP32_FLOPS
            return (2 * K * p / PEAK_BF16_FLOPS
                    + p * EPILOGUE_OPS[mode] / PEAK_FP32_FLOPS)

        # "mixed" also rescores its in-band pairs exactly: the stats of
        # B1's band over the source columns, which count core rows only
        # (B2 rescores every row's pairs: a lower count, so the bound
        # stays a lower bound).
        in_band = 0
        if mode == "mixed":
            in_band = int(ck.count_pairs_mixed(
                xs, core.to(torch.int32), rp, cols, e2, tile, centers,
                rnorm)[1][0])
        t_ops = ops_s(pairs) + in_band * (3 * d + 1) / PEAK_FP32_FLOPS
        unskipped_ms = max(t_ops, t_bytes) * 1e3
        f = torch.where(core, idx, INT_INF)
        live = mask
        rounds = []
        err = 0
        while True:
            a = (xs, f.contiguous(), rp, cols, e2, tile) + frames
            kw = {"live_rows": live} if skip else {}
            ev = torch.zeros(1, dtype=torch.int64, device=dev)
            g = kern(*a, **kw, **({"evaluated": ev} if skip else {}))
            sync()
            r_ms = median_ms(lambda: kern(*a, **kw), sizes["reps"])
            floor = b4_floor_pairs(torch, a[1], rp, cols, g, tile, live)
            floor_ms = max(ops_s(floor), t_bytes) * 1e3
            share = int(ev[0]) / max(chunks, 1) if skip else None
            if check:
                sa = a[:2] + (rp_sub,) + a[3:]
                ev_s = torch.zeros(1, dtype=torch.int64, device=dev)
                ks = kern(*sa, live_rows=live, evaluated=ev_s)
                ps = plain(*sa, live_rows=live)
                wb, wev = minlab_pairs_walk(
                    *sa[:6], mode, *(frames + (None, None))[:2],
                    live_rows=live)
                sync()
                bad = int((ks != ps).sum()) + int((wb != ps).sum())
                if mode == "mixed":
                    fs = ck.minlab_pairs(*sa[:6], live_rows=live)
                    bad += int((fs != ks)[mask].sum())
                err = max(err, int((ks.long() - ps.long()).abs().max()))
                log(f"    {name} round {len(rounds) + 1}, first {sub} of "
                    f"{nt} row tiles: {bad} mismatches against the plain "
                    f"version and the walk; evaluated {int(ev_s[0])}, walk "
                    f"{wev}")
                if bad:
                    fail(f"{name} disagrees with its plain version at round "
                         f"{len(rounds) + 1}")
                if int(ev_s[0]) != wev:
                    fail(f"{name}'s evaluated count differs from the walk's "
                         f"at round {len(rounds) + 1}")
            rounds.append(dict(ms=r_ms, share=share, floor=floor,
                               floor_ms=floor_ms,
                               by_ops=ops_s(floor) >= t_bytes))
            log(f"  {name} round {len(rounds)}: {r_ms:.4f} ms, evaluated "
                f"{int(ev[0]) if skip else 'n/a'} of {chunks} (block, chunk) "
                f"pairs ({share}); bound (label-exact floor) {floor} pairs, "
                f"{floor_ms:.4f} ms; without the skip {unskipped_ms:.4f} ms")
            live = mask & (g != INT_INF)
            f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f),
                                  core)
            if torch.equal(f_new, f):
                break
            f = f_new
        ms = [r["ms"] for r in rounds]
        sa = (xs, torch.where(core, idx, INT_INF).contiguous(), rp_sub, cols,
              e2, tile) + frames
        plain_ms = median_ms(lambda: plain(*sa), 1)
        log(f"  {name}: {np.mean(ms):.4f} ms per launch over "
            f"{len(rounds)} rounds ({sum(ms):.4f} ms in all; plain "
            f"{plain_ms:.2f} ms on the first {sub} of {nt} row tiles at the "
            f"round-1 labels); {pairs} point pairs without the skip")
        records.append({
            "name": name, "route": "cuda",
            "source": "pypardis_tpu_torch/csrc/pair_kernels.cu",
            "replaces": "pypardis_tpu/ops/pallas_kernels.py:264",
            "launches": int((fit_launches or {}).get(name, len(rounds))),
            "max_abs_err": err, "ms": float(np.mean(ms)),
            "plain_ms": plain_ms,
            "plain_scope": f"first {sub} of {nt} row tiles, round-1 labels",
            # The bound is the label-exact work (B4's rule); the work
            # without the skip stands beside it.
            "bound_ms": float(np.mean([r["floor_ms"] for r in rounds])),
            "bound_by": ("operations" if all(r["by_ops"] for r in rounds)
                         else "bytes"),
            "bound_ms_unskipped": unskipped_ms,
            # No single PyTorch call computes a thresholded min label
            # over a tile-pair list.
            "library_ms": None,
            "ms_per_round": ms,
            "evaluated_share_per_round": [r["share"] for r in rounds],
            "floor_ms": float(np.mean([r["floor_ms"] for r in rounds])),
            "floor_ms_per_round": [r["floor_ms"] for r in rounds],
        })
    return records


def b2_timings(torch, dev, median_ms, sync, sizes=B2_SIZES):
    """``--b2``: B2 alone at each round's labels of the 1M x 16-D fit in
    its three modes (:func:`b2_rounds`, without the plain versions'
    checks), B1 at the same inputs, and B1/B2 without the sketch at
    100,000 x 512 (round-1 labels), then the sha256 of the 1M x 16-D
    fits' labels and core mask in each mode from host input and from a
    CUDA tensor: the quick way to time a B2 change, and to A/B two trees
    in one call (run this script from each tree's root; a copy of the
    tree with ``PP_GROUP`` or ``FP_GROUP`` of ``csrc/pair_kernels.cu``
    edited times another staged width)."""
    from benchdata import make_blob_data, make_embedding_data
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, eps2_f32, row_offsets,
    )
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout
    from pypardis_tpu_torch.parallel import staging

    X, _truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
    pts, n, block = _stage(X, 2048, dev)
    xs, mask, _o = _pipeline_layout(pts, 2.4, n, block, sort=True)
    records = b2_rounds(torch, dev, median_ms, sync, xs, mask,
                        ("high", "mixed", "default"), None, sizes,
                        check=False)
    for what, emb, eps in (("1M x 16", False, 2.4),
                           ("100k x 512, sketch off", True, 2.0)):
        if emb:
            Xe, _t = make_embedding_data(100_000, 512)
            pts, n, block = _stage(Xe, 2048, dev)
            xs, mask, _o = _pipeline_layout(pts, eps, n, block, sort=True)
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, 2048, "high")
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                xs, eps, mask, 2048, "high", budget=total)
        d, N = xs.shape
        tile = ck._pallas_block(2048, N, d, "high")
        rp = row_offsets(rows, N // tile)
        e2 = eps2_f32(eps)
        a = (xs, mask.to(torch.int32), rp, cols, e2, tile)
        c = ck.count_pairs(*a)
        b1 = median_ms(lambda: ck.count_pairs(*a), sizes["reps"])
        line = f"  B1 high at {what}: {b1:.4f} ms"
        if emb:
            core = (torch.clamp_min(torch.where(mask, c, 0), 1) >= 10) & mask
            lab = torch.where(core, torch.arange(N, device=dev,
                                                 dtype=torch.int32),
                              INT_INF).contiguous()
            b = a[:1] + (lab,) + a[2:]
            kw = ({"live_rows": mask} if _takes(ck.minlab_pairs, "live_rows")
                  else {})
            b2 = median_ms(lambda: ck.minlab_pairs(*b, **kw), sizes["reps"])
            line += f", B2 high (round-1 labels) {b2:.4f} ms"
        log(line)
        records.append({"name": f"count_pairs at {what}", "ms": b1})
    # The fits' own bytes, to hold two trees' fits equal across calls.
    from pypardis_tpu_torch import DBSCAN

    Xd = torch.from_numpy(X).to(dev)
    for mode in ("high", "mixed", "default"):
        for src, data in (("host", X), ("cuda", Xd)):
            m = DBSCAN(eps=2.4, min_samples=10, block=2048, precision=mode,
                       device=dev).fit(data)
            digest = hashlib.sha256(
                m.labels_.tobytes() + m.core_sample_mask_.tobytes()
            ).hexdigest()
            log(f"  1M x 16 {mode} fit from {src}: labels and core sha256 "
                f"{digest}")
    return records


def b1_timings(torch, dev, median_ms, sync, reps=10):
    """``--b1``: B1 alone at the 1M x 16-D fit's inputs (staged as a
    host-input fit stages them) in its three modes: each launch's
    CUDA-event median, the pairs its exact fallback decided and their
    share, its bound (:func:`b1_bounds`), the all-FP32 work's bound
    (``bound_ms_fp32``) and the function's floor (:func:`b1_floor`), and
    the staging of the frames each mode's fit takes; then the sha256 of
    the 1M x 16-D fits' labels and core mask in each mode from host
    input and from a CUDA tensor.  Run from each tree's root to A/B two
    trees in one call (a tree whose wrappers take no centres or counter
    is timed as it is)."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import eps2_f32, row_offsets
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

    X, _truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
    pts, n, block = _stage(X, 2048, dev)
    xs, mask, _o = _pipeline_layout(pts, 2.4, n, block, sort=True)
    (rows, cols), (total, budget) = ck.kernel_pair_list(
        xs, 2.4, mask, 2048, "high")
    if total > budget:
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, 2.4, mask, 2048, "high", budget=total)
    d, N = xs.shape
    tile = ck._pallas_block(2048, N, d, "high")
    nt = N // tile
    rp = row_offsets(rows, nt)
    a = (xs, mask.to(torch.int32), rp, cols, eps2_f32(2.4), tile)
    centers, rnorm = ck.tile_frames(xs, mask, tile)
    cols_t = cols[:int(rp[-1])].long()
    pairs = int(mask.view(nt, tile).sum(1)[cols_t].sum()) * tile
    t_bytes = ((d * N + N + rp.numel() + cols.numel() + centers.numel()
                + N) * 4) / PEAK_BYTES_PER_S
    fp32_ms = max(pairs * (3 * d + 1) / PEAK_FP32_FLOPS, t_bytes) * 1e3
    tc = _takes(ck.count_pairs, "centers")
    calls = {
        "high": lambda **kw: ck.count_pairs(*a, *((centers,) if tc else ()),
                                            **kw),
        "mixed": lambda **kw: ck.count_pairs_mixed(*a, centers, rnorm, **kw),
        "default": lambda **kw: ck.count_pairs_default(*a, centers, **kw),
    }
    records = []
    for mode, call in calls.items():
        name = "count_pairs" if mode == "high" else f"count_pairs_{mode}"
        rescored = None
        if mode != "default" and _takes(getattr(ck, name), "rescored_pairs"):
            rc = torch.zeros(1, dtype=torch.int64, device=dev)
            call(rescored_pairs=rc)
            sync()
            rescored = int(rc[0])
        ms = median_ms(call, reps)
        frames_ms = median_ms(lambda: ck.pass_frames(xs, mask, tile, mode),
                              reps)
        t_ops = b1_bounds(pairs, rescored or 0, d, mode)
        bound_ms = max(t_ops, t_bytes) * 1e3
        floor_ms = max(b1_floor(pairs, rescored or 0, d), t_bytes) * 1e3
        share = None if rescored is None else rescored / max(pairs, 1)
        log(f"  B1 {mode} at 1M x 16: {ms:.4f} ms; {pairs} point pairs, "
            f"decided exactly {rescored} ({share}); bound {bound_ms:.4f} ms, "
            f"all-FP32 work {fp32_ms:.4f} ms, floor {floor_ms:.4f} ms; the "
            f"frames' staging {frames_ms:.4f} ms")
        records.append({
            "name": name, "ms": ms, "rescored_pairs": rescored,
            "rescored_share": share, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "bound_ms_fp32": fp32_ms, "floor_ms": floor_ms,
            "frames_ms": frames_ms,
        })
    # The fits' own bytes, to hold two trees' fits equal across calls.
    Xd = torch.from_numpy(X).to(dev)
    for mode in ("high", "mixed", "default"):
        for src, data in (("host", X), ("cuda", Xd)):
            m = DBSCAN(eps=2.4, min_samples=10, block=2048, precision=mode,
                       device=dev).fit(data)
            digest = hashlib.sha256(
                m.labels_.tobytes() + m.core_sample_mask_.tobytes()
            ).hexdigest()
            log(f"  1M x 16 {mode} fit from {src}: labels and core sha256 "
                f"{digest}")
    return records


def b3_bounds(gated, band_pairs, rescored, k, d):
    """B3's operation bounds in seconds: ``(old, new)``.  ``old``, the
    exact rescore's work: the gate's 3 (k + 1) + 3 FP32 operations per
    gated pair plus 3d + 1 per in-band pair.  ``new``, the certified
    rescore's: the same gate, 2d tensor-core operations per in-band pair
    at the bf16 peak, and 3d + 1 FP32 ones per rescored pair."""
    gate = gated * (3 * (k + 1) + 3)
    old = (gate + band_pairs * (3 * d + 1)) / PEAK_FP32_FLOPS
    new = ((gate + rescored * (3 * d + 1)) / PEAK_FP32_FLOPS
           + band_pairs * 2 * d / PEAK_BF16_FLOPS)
    return old, new


def b3_floor(gated, rescored, k, d):
    """A floor in seconds for B3's function, below any design of it:
    the slab distance t2 and the full-d cross term of every gated pair
    on the tensor cores, 2 (k + 1) + 2 d operations at the bf16 peak,
    and the exact d^2 of the pairs this run rescored, 3 d + 1 FP32
    operations each."""
    return (gated * (2 * (k + 1) + 2 * d) / PEAK_BF16_FLOPS
            + rescored * (3 * d + 1) / PEAK_FP32_FLOPS)


def mma_probe_cases(K=512, batch=32, seed=0):
    """Inputs for the probe of the tensor cores' FP32 accumulation
    (``ops/cuda_kernels.mma_dot_probe``), each ``(name, a, b)`` with
    ``a`` (batch, 16, K) and ``b`` (batch, 8, K) float32 holding bf16
    values: normal values; pairs that cancel exactly (column j the
    row's values with alternating signs over repeated axis pairs);
    magnitudes spread over 2^-30..2^30; one product of 1 before or after
    K - 1 products near 2^-26 of one sign (each below the partial sum's
    last bit); and +2^10, small products, then -2^10 (a late
    cancellation that leaves only what the large partial sums kept)."""
    import torch

    rng = np.random.default_rng(seed)

    def bf(x):
        return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
            torch.bfloat16).float().numpy()

    cases = []
    cases.append(("normal", bf(rng.normal(size=(batch, 16, K))),
                  bf(rng.normal(size=(batch, 8, K)))))
    half = bf(rng.normal(size=(batch, 16, K // 2)))
    a = np.repeat(half, 2, axis=2)
    sign = np.tile([1.0, -1.0], K // 2).astype(np.float32)
    b = bf(rng.normal(size=(batch, 8, K)))
    b[:, :8] = a[:, :8] * sign
    cases.append(("cancelling", a, b))
    cases.append(("magnitudes",
                  bf(rng.normal(size=(batch, 16, K))
                     * 2.0 ** rng.integers(-30, 31, size=(batch, 16, K))),
                  bf(rng.normal(size=(batch, 8, K))
                     * 2.0 ** rng.integers(-30, 31, size=(batch, 8, K)))))
    small = bf(2.0**-26 * (1.0 + rng.random(size=(batch, 16, K))))
    ones = np.ones((batch, 8, K), np.float32)
    first = small.copy()
    first[:, :, 0] = 1.0
    last = small.copy()
    last[:, :, -1] = 1.0
    cases += [("one large first", first, ones), ("one large last", last,
                                                   ones)]
    late = bf(2.0**-14 * rng.random(size=(batch, 16, K)))
    late[:, :, 0] = 2.0**10
    late[:, :, -1] = -(2.0**10)
    cases.append(("late cancellation", late, ones))
    return cases


# Depths of the accumulation probe: B1's K at 16-D and 64-D, B3's at 512.
MMA_PROBE_KS = (16, 64, 512)


def mma_probe(torch, dev, ck):
    """The probe of the certified band's term (3): over
    :func:`mma_probe_cases` at each K of :data:`MMA_PROBE_KS`, the tensor
    cores' chained FP32 sum against
    the float64 sum of the same bf16 products.  Returns the largest
    ``|dot - P'| / (2^-21 K sum |p|)`` (the header's bound is 1) and the
    largest ``|dot - P'| / (2^-24 sum |p|)``; fails past the bound."""
    worst = worst_u = 0.0
    cases = [c for K in MMA_PROBE_KS for c in mma_probe_cases(K)]
    for name, a, b in cases:
        K = a.shape[2]
        got = ck.mma_dot_probe(
            torch.from_numpy(a).to(dev).to(torch.bfloat16),
            torch.from_numpy(b).to(dev).to(torch.bfloat16)).cpu().double()
        a64, b64 = torch.from_numpy(a).double(), torch.from_numpy(b).double()
        exact = torch.bmm(a64, b64.transpose(1, 2))
        mag = torch.bmm(a64.abs(), b64.abs().transpose(1, 2))
        err = (got - exact).abs()
        if not bool(torch.isfinite(got).all()) or bool(
                (err[mag == 0] > 0).any()):
            fail(f"the accumulation probe is not finite or exact on "
                 f"{name}")
        pos = mag > 0
        r = float((err[pos] / (2.0**-21 * K * mag[pos])).max())
        ru = float((err[pos] / (2.0**-24 * mag[pos])).max())
        log(f"  mma.sync FP32 accumulation probe, {name} (K={K}): max "
            f"|dot - P'| = {ru:.6f} x 2^-24 sum|p|, {r:.6f} of the "
            f"band's term (3)")
        worst, worst_u = max(worst, r), max(worst_u, ru)
        if r > 1.0:
            fail(f"the tensor cores' accumulation breaks the band's term "
                 f"(3) on {name}: {r}")
    return worst, worst_u


def rescored_tolerance(n):
    """How far B3's ``rescored_pairs`` may lie from the emulation's
    ``n``: 0.1 % of it, at least 16.  The two differ only where another
    summation order moves ``d2f +- band_p`` across eps2; on the card
    that was at most 0.023 % at 20,000 x 512 and 0.012 % on the 1M
    sub-list (H100), while a band 1 % wider than the emulation's would
    move the count by about 1 %."""
    return max(16, n // 1000)


# FP32 operations per pair of the tensor-core B1's epilogue (csrc/
# pair_kernels.cu, b1_tc_kernel): t = fl(|Y|^2 - 2 dot), one fused
# multiply-add (two operations), and its tests: two under "high", two more
# for "mixed"'s stats, one under "default".
B1_EPILOGUE_OPS = {"high": 4, "mixed": 6, "default": 3}


def b1_bounds(pairs, rescored, d, mode):
    """The tensor-core B1's operation bound in seconds, in the convention
    of :func:`b3_bounds`: 2K tensor-core operations per pair at the bf16
    peak (K = d padded to 16), the epilogue's FP32 operations per pair,
    and 3d + 1 FP32 operations per pair the exact fallback decided."""
    K = -(-d // 16) * 16
    return (2 * K * pairs / PEAK_BF16_FLOPS
            + (pairs * B1_EPILOGUE_OPS[mode] + rescored * (3 * d + 1))
            / PEAK_FP32_FLOPS)


def b1_floor(pairs, rescored, d):
    """A floor in seconds for B1's function, below any design of it: the
    cross term of every pair on the tensor cores (2K operations at the
    bf16 peak) and the exact d^2 of the pairs this run decided exactly
    (3d + 1 FP32 operations each)."""
    K = -(-d // 16) * 16
    return (2 * K * pairs / PEAK_BF16_FLOPS
            + rescored * (3 * d + 1) / PEAK_FP32_FLOPS)


def b1_rescored_hold(a, centers, rescored, what):
    """The tensor-core B1's ``rescored_pairs`` against
    ``certified_count_walk``'s on the same inputs ``a`` (pts, mask,
    row_ptr, cols, eps2, tile) and row tile ``centers``: off by no more
    than the walk's fragile pairs nor than :func:`rescored_tolerance`.
    Returns the walk's count."""
    from pypardis_tpu_torch.ops.distances import certified_count_walk

    _counts, want, fragile = certified_count_walk(*a, centers)
    tol = min(fragile, rescored_tolerance(want))
    log(f"    B1 rescored_pairs on {what}: kernel {rescored}, walk {want} "
        f"(fragile {fragile}, tolerance {tol})")
    if abs(rescored - want) > tol:
        fail(f"B1's rescored_pairs is off the walk's on {what}: {rescored} "
             f"against {want} (tolerance {tol})")
    return want


# Sizes of phase 7; tests rehearse the phase at small ones on the CPU.
SKETCH_SIZES = {"check_n": 20_000, "onoff_n": 100_000,
                "main_n": 1_000_000, "sub_tiles": 8, "reps": 2,
                "layout_cache_max": 8 << 30}


def sketch_phase(torch, dev, median_ms, sync, sizes=SKETCH_SIZES):
    """Phase 7 (high-dimensional fits, the sketch kernels B3/B4); see the
    module docstring.  Returns the kernels' JSON records and the 100k
    sketched fit (its data, truth and model) for phase 8."""
    from benchdata import make_embedding_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, certified_rescore_walk, eps2_f32, minlab_skip_walk,
        row_offsets,
    )
    from pypardis_tpu_torch.ops.labels import _pointer_jump
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout
    from pypardis_tpu_torch.parallel import staging

    names = ("count_pairs_sketch", "minlab_pairs_sketch")
    max_err = dict.fromkeys(names, 0)
    eps, ms, block = 2.0, 10, 2048

    def staged(X, eps, block):
        pts, n, block = _stage(X, block, dev)
        xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
        return xs, mask, block

    def sketch_inputs(xs, mask, eps, block, k, min_samples, mode="high"):
        """B3's inputs and the first B4 inputs a sketched fit of
        ``mode`` builds, with the row tiles' centres its B3 recentres
        on."""
        slab = ck.sketch_stage(xs, mask, k, mode)
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, block, mode, sketch=k, slab=slab)
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                xs, eps, mask, block, mode, budget=total, sketch=k,
                slab=slab)
        d, N = xs.shape
        tile = ck._pallas_block(block, N, d, mode)
        rp = row_offsets(rows, N // tile)
        mi = mask.to(torch.int32)
        e2 = eps2_f32(eps)
        centers = ck.pass_frames(xs, mask, tile, mode, k)[0]
        a = (xs, mi, rp, cols, slab[0], k, e2, slab[1], tile)
        counts, _stats = ck.count_pairs_sketch(*a, mode, centers)
        core = (torch.clamp_min(torch.where(mask, counts, 0), 1)
                >= min_samples) & mask
        lab = torch.where(core, torch.arange(N, device=dev,
                                             dtype=torch.int32),
                          INT_INF).contiguous()
        return dict(a=a, b=(xs, lab, rp, cols, slab[0], k, e2, slab[1], tile),
                    total=total, core=core, mask=mask, tile=tile, k=k,
                    mode=mode, centers=centers)

    def hold_b4(b, what):
        """B4 == its plain version, exactly, and its count of evaluated
        (block, chunk) pairs == minlab_skip_walk's (the same verdicts in
        these exact modes, so the same running minima)."""
        ev = torch.zeros(1, dtype=torch.int64, device=dev)
        km = ck.minlab_pairs_sketch(*b, evaluated=ev)
        pm = ck.PLAIN["minlab_pairs_sketch"](*b)
        wbest, wev = minlab_skip_walk(*b)
        sync()
        err = int((km.long() - pm.long()).abs().max())
        bad = int((km != pm).sum()) + int((wbest != pm).sum())
        total = b4_chunks(b[2], b[8])
        share = int(ev[0]) / max(total, 1)
        max_err["minlab_pairs_sketch"] = max(
            max_err["minlab_pairs_sketch"], err)
        log(f"    B4 at {what}: max|kernel-plain| {err}, mismatches {bad}; "
            f"evaluated {int(ev[0])} of {total} (block, chunk) pairs "
            f"({share:.6f}), minlab_skip_walk {wev}")
        if bad:
            fail(f"B4 disagrees with its plain version at {what}")
        if int(ev[0]) != wev:
            fail(f"B4's evaluated count differs from minlab_skip_walk's at "
                 f"{what}")

    def hold(inp, what):
        """Kernel == plain version, exactly: counts, both stats, labels;
        B3's rescored pairs off the emulation's by no more than its
        fragile pairs (those another summation order could move across
        a band edge) nor than :func:`rescored_tolerance`."""
        rc = torch.zeros(1, dtype=torch.int64, device=dev)
        kc, kst = ck.count_pairs_sketch(*inp["a"], inp["mode"],
                                        inp["centers"], rescored_pairs=rc)
        pc, pst = ck.PLAIN["count_pairs_sketch"](*inp["a"])
        ec, erc, frag = certified_rescore_walk(*inp["a"], inp["centers"])
        tol = min(frag, rescored_tolerance(erc))
        sync()
        err = max(int((kc.long() - pc.long()).abs().max()),
                  int((kst - pst).abs().max()))
        bad = (int((kc != pc).sum()) + int((kst != pst).sum())
               + int((ec != pc).sum()))
        max_err["count_pairs_sketch"] = max(max_err["count_pairs_sketch"],
                                            err)
        krc = int(rc[0])
        log(f"  {what}: {inp['mode']}, k={inp['k']} tile {inp['tile']}, "
            f"{inp['total']} live tile pairs; B3 stats kernel "
            f"{kst.tolist()} plain {pst.tolist()}; max|kernel-plain| B3 "
            f"{err}; mismatches {bad}; rescored_pairs kernel {krc} "
            f"emulation {erc} (tolerance {tol}: {frag} fragile pairs, "
            f"{rescored_tolerance(erc)} by share), "
            f"{krc / max(int(kst[0]), 1):.6f} of band_pairs")
        if bad:
            fail(f"a sketch kernel disagrees with its plain version on {what}")
        if abs(krc - erc) > tol:
            fail(f"B3's rescored_pairs {krc} is off the emulation's {erc} "
                 f"on {what}")
        hold_b4(inp["b"], "round-1 labels")
        return kst

    def at_main(X, main_launches, check):
        """7.4: B3 and B4 alone at the fit's own inputs (staged as a
        host-input fit stages them), B4 at each round's labels of the
        fit's loop; with ``check``, both against their plain versions on
        the first row tiles.  Returns the kernels' JSON records."""
        n = len(X)
        xs, mask, blk = staged(X, eps, block)
        inp = sketch_inputs(xs, mask, eps, blk, 128, ms)
        d, N = xs.shape
        tile, k = inp["tile"], inp["k"]
        nt = N // tile
        rp, cols, core = inp["a"][2], inp["a"][3], inp["core"]
        cols_t = cols[:int(rp[-1])].long()
        nbytes = ((d + k + 1 + 2) * N * 4 + rp.numel() * 4
                  + cols.numel() * 4)
        t_bytes = (nbytes + N * 4) / PEAK_BYTES_PER_S
        gate_ops = 3 * (k + 1) + 3
        # The fit's rounds (ops/labels.dbscan_fixed_size): B4 at each
        # round's labels, its evaluated share, and the pairs a
        # label-exact method must rule out there; the last round (no
        # change) is the border pass.
        b = inp["b"]
        total = b4_chunks(rp, tile)
        idx = torch.arange(N, device=dev, dtype=torch.int32)
        f = torch.where(core, idx, INT_INF)
        rounds = []
        while True:
            args = b[:1] + (f.contiguous(),) + b[2:]
            ev = torch.zeros(1, dtype=torch.int64, device=dev)
            g = ck.minlab_pairs_sketch(*args, evaluated=ev)
            sync()
            r_ms = median_ms(lambda: ck.minlab_pairs_sketch(*args),
                             sizes["reps"])
            floor = b4_floor_pairs(torch, args[1], rp, cols, g, tile)
            t_ops = floor * gate_ops / PEAK_FP32_FLOPS
            rounds.append(dict(
                labels=args[1], ms=r_ms, share=int(ev[0]) / max(total, 1),
                floor=floor, t_ops=t_ops,
                bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes"))
            log(f"  B4 round {len(rounds)}: {r_ms:.3f} ms, evaluated "
                f"{int(ev[0])} of {total} (block, chunk) pairs "
                f"({rounds[-1]['share']:.6f}); label-exact floor {floor} "
                f"pairs, bound {rounds[-1]['bound_ms']:.3f} ms by "
                f"{rounds[-1]['bound_by']}")
            f_new = _pointer_jump(torch.where(core, torch.minimum(f, g), f),
                                  core)
            if torch.equal(f_new, f):
                break
            f = f_new
        b4_ms = [r["ms"] for r in rounds]
        fit_b4 = (main_launches or {}).get("minlab_pairs_sketch")
        log(f"  B4 over the {len(rounds)} rounds (the fit launched "
            f"{fit_b4}): {sum(b4_ms):.3f} ms in all")
        sub = min(sizes["sub_tiles"], nt)
        rp_sub = torch.cat([rp[:sub + 1], rp[sub].repeat(nt - sub)])
        if check:
            # The 64-row-tile sub-list: the plain versions over the whole
            # list would take minutes.
            sub_inp = dict(inp, a=inp["a"][:2] + (rp_sub,) + inp["a"][3:],
                           b=inp["b"][:2] + (rp_sub,) + inp["b"][3:])
            hold(sub_inp, f"the {n} x 512 fit's inputs, first {sub} of "
                 f"{nt} row tiles")
            for what, lab in (
                    ("converged labels", rounds[-1]["labels"]),
                    ("labels descending in slot order",
                     torch.where(core, N - 1 - idx, INT_INF))):
                hold_b4(b[:1] + (lab.contiguous(), rp_sub) + b[3:],
                        f"{what}, first {sub} row tiles")
        # B3: every row of a live tile pair against its valid columns
        # through the gate, 3 (k + 1) + 3 operations each (the slab
        # distance over the k + 1 rows, the residual product and the two
        # gate tests; the zero pad rows up to a multiple of 8 are the
        # kernel's own choice); every in-band pair through the bf16 d^2,
        # 2d tensor-core operations, and the pairs it queues through the
        # exact d^2, 3d + 1 more (b3_bounds, beside the exact rescore's
        # old bound).
        a, cen = inp["a"], inp["centers"]
        rc = torch.zeros(1, dtype=torch.int64, device=dev)
        on_card = torch.device(dev).type == "cuda"
        if on_card:
            sync()
            torch.cuda.reset_peak_memory_stats(dev)
            held = torch.cuda.memory_allocated(dev)
        band_b3 = ck.count_pairs_sketch(*a, "high", cen, rescored_pairs=rc)[1]
        sync()
        # The launch's own peak beyond what was held before it: the
        # certified rescore's row-major copy and bf16 row fragments.
        extra = (torch.cuda.max_memory_allocated(dev) - held
                 if on_card else None)
        log(f"  count_pairs_sketch's launch holds {extra} bytes more at its "
            f"peak (the points: {xs.numel() * 4} bytes)")
        resc = int(rc[0])
        gated_b3 = int(mask.view(nt, tile).sum(1)[cols_t].sum()) * tile
        sub_a = a[:2] + (rp_sub,) + a[3:]
        kern_ms = median_ms(lambda: ck.count_pairs_sketch(*a, "high", cen),
                            sizes["reps"])
        plain_ms = median_ms(
            cold(lambda: ck.PLAIN["count_pairs_sketch"](*sub_a)), 1)
        t_old, t_ops = b3_bounds(gated_b3, int(band_b3[0]), resc, k, d)
        t_b3 = (nbytes + N * 4 + cols.numel() * 4 + 8) / PEAK_BYTES_PER_S
        bound_ms = max(t_ops, t_b3) * 1e3
        floor_ms = max(b3_floor(gated_b3, resc, k, d), t_b3) * 1e3
        log(f"  count_pairs_sketch: {kern_ms:.3f} ms (plain {plain_ms:.2f} "
            f"ms on the first {sub} of {nt} row tiles), bound "
            f"{bound_ms:.3f} ms by "
            f"{'operations' if t_ops >= t_b3 else 'bytes'} (this design's "
            f"work; the exact rescore's {max(t_old, t_b3) * 1e3:.3f} ms; "
            f"the function's floor, t2 and d^2 of every gated pair on the "
            f"tensor cores, {floor_ms:.3f} ms); {gated_b3} "
            f"gated pairs over {len(cols_t)} live tile pairs, "
            f"{int(band_b3[0])} in band, rescored_pairs {resc} "
            f"({resc / max(int(band_b3[0]), 1):.6f} of band_pairs)")
        kernels = [{
            "name": "count_pairs_sketch", "route": "cuda",
            "source": "pypardis_tpu_torch/csrc/sketch_kernels.cu",
            "replaces": "pypardis_tpu/ops/pallas_kernels.py:341",
            "launches": int((main_launches or {}).get(
                "count_pairs_sketch", 1)),
            "max_abs_err": max_err["count_pairs_sketch"],
            "ms": kern_ms, "plain_ms": plain_ms,
            "plain_scope": f"first {sub} of {nt} row tiles",
            "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_b3 else "bytes",
            # No single PyTorch call computes a gated thresholded count
            # or min-label over a tile-pair list.
            "library_ms": None,
            # bound_ms is this design's work (b3_bounds); floor_ms the
            # function's, below any design (b3_floor).
            "bound_ms_exact_rescore": max(t_old, t_b3) * 1e3,
            "floor_ms": floor_ms,
            "peak_extra_bytes": extra,
            "band_pairs": int(band_b3[0]),
            "rescored_pairs": resc,
        }]
        # B4: the mean launch over the fit's rounds beside the mean of
        # their bounds.  Each round's bound counts only the gate (no
        # rescore) over the pairs a label-exact method must rule out, a
        # floor; the pairs the unskipped kernel gated are printed beside.
        sub_b = b[:1] + (rounds[0]["labels"], rp_sub) + b[3:]
        plain_ms = median_ms(
            cold(lambda: ck.PLAIN["minlab_pairs_sketch"](*sub_b)), 1)
        gated_b4 = int(core.view(nt, tile).sum(1)[cols_t].sum()) * tile
        bounds = [r["bound_ms"] for r in rounds]
        log(f"  minlab_pairs_sketch: {np.mean(b4_ms):.3f} ms per launch "
            f"(plain {plain_ms:.2f} ms on the first {sub} row tiles at the "
            f"round-1 labels), bound {np.mean(bounds):.3f} ms; "
            f"label-exact floor per round "
            f"{[r['floor'] for r in rounds]} pairs against {gated_b4} "
            f"gated pairs without the skip")
        kernels.append({
            "name": "minlab_pairs_sketch", "route": "cuda",
            "source": "pypardis_tpu_torch/csrc/sketch_kernels.cu",
            "replaces": "pypardis_tpu/ops/pallas_kernels.py:393",
            "launches": int(fit_b4 or len(rounds)),
            "max_abs_err": max_err["minlab_pairs_sketch"],
            "ms": float(np.mean(b4_ms)), "plain_ms": plain_ms,
            "plain_scope": f"first {sub} of {nt} row tiles, round-1 labels",
            "bound_ms": float(np.mean(bounds)),
            "bound_by": ("operations" if np.mean(
                [r["t_ops"] for r in rounds]) >= t_bytes else "bytes"),
            "library_ms": None,
            "ms_per_round": b4_ms,
            "bound_ms_per_round": bounds,
            "evaluated_share_per_round": [r["share"] for r in rounds],
        })
        return kernels

    if sizes.get("timing_only"):
        X, _truth = make_embedding_data(sizes["main_n"], 512)
        return at_main(X, None, False), None

    # 7.1: the tensor cores' accumulation against the band's term (3),
    # then the kernels against their plain versions.
    probe = mma_probe(torch, dev, ck)
    n = sizes["check_n"]
    for d, k in ((256, 64), (512, 128), (256, 33)):
        X, _t = make_embedding_data(n, d)
        xs, mask, blk = staged(X, eps, block)
        hold(sketch_inputs(xs, mask, eps, blk, k, ms),
             f"embedding n={n} d={d}"
             + (" (pinned k, k+1 not a multiple of 8)" if k == 33 else ""))
    X, eps_n = noise_dominated(n, 256, seed=1)
    xs, mask, blk = staged(X, eps_n, block)
    hold(sketch_inputs(xs, mask, eps_n, blk, 64, 5),
         f"noise-dominated n={n} d=256 eps={eps_n}")
    # Near-eps pairs, duplicates and a 1e3 offset: where B3's exact
    # fallback works hardest (eps at the blobs' typical distance).
    eps_a = float(0.25 * np.sqrt(2.0 * 512))
    xs, mask, blk = staged(adversarial(n, 512, eps_a), eps_a, block)
    for mode in ("high", "mixed"):
        hold(sketch_inputs(xs, mask, eps_a, blk, 128, ms, mode),
             f"adversarial n={n} d=512 eps={eps_a}")

    def fit(X, sketch, what, tf32=False):
        model = DBSCAN(eps=eps, min_samples=ms, block=block, sketch=sketch,
                       device=dev)
        prev = torch.get_float32_matmul_precision()
        if tf32:
            torch.set_float32_matmul_precision("high")
        try:
            ck.reset_launch_counts()
            sync()
            t = time.perf_counter()
            model.fit(X)
            sync()
            wall = time.perf_counter() - t
            launches = dict(ck.LAUNCHES)
        finally:
            torch.set_float32_matmul_precision(prev)
        m = model.metrics_
        log(f"  {what}: {wall:.4f} s, launches B1={launches['count_pairs']} "
            f"B2={launches['minlab_pairs']} "
            f"B3={launches['count_pairs_sketch']} "
            f"B4={launches['minlab_pairs_sketch']}, passes "
            f"{m['kernel_passes']}, sketch_k {m['sketch_k']}, live pairs "
            f"{m['live_pairs']} (budget {m['pair_budget']}), band_pairs "
            f"{m['band_pairs']}, rescored_tiles {m['rescored_tiles']}, "
            f"clusters {int(model.labels_.max()) + 1}")
        if sum(launches.values()) != m["kernel_passes"]:
            fail(f"kernel launches do not sum to the passes ({what})")
        sk = m["sketch_k"] > 0
        on = launches["count_pairs_sketch"] + launches["minlab_pairs_sketch"]
        off = launches["count_pairs"] + launches["minlab_pairs"]
        if (launches["count_pairs_sketch" if sk else "count_pairs"] != 1
                or launches["minlab_pairs_sketch" if sk else "minlab_pairs"]
                < 1 or (off if sk else on) != 0):
            fail(f"the fit did not run the kernels of its path ({what})")
        return model, wall, launches

    # 7.2: sketch on against off.
    n = sizes["onoff_n"]
    X, truth = make_embedding_data(n, 512)
    on, w_on, _l = fit(X, "auto", f"n={n} d=512 sketch auto")
    off, w_off, _l = fit(X, 0, f"n={n} d=512 sketch off")
    same = (np.array_equal(on.labels_, off.labels_)
            and np.array_equal(on.core_sample_mask_, off.core_sample_mask_))
    log(f"  n={n}: sketch on/off labels and core byte-identical: {same}; "
        f"live pairs {on.metrics_['live_pairs']} / "
        f"{off.metrics_['live_pairs']}, wall {w_on:.4f} / {w_off:.4f} s; "
        f"ARI vs truth {ari(on.labels_, truth):.6f}")
    if not same:
        fail("the sketched fit differs from the unsketched fit")
    onoff = dict(X=X, truth=truth, model=on)

    # 7.3: the slice's path at full size.  The host fits run with the
    # staging cache's layout cap raised past the 1M x 512 layout, so the
    # repeat from host input is warm (phase 19.2): it reuses the first
    # fit's sorted layout and ships nothing.
    n = sizes["main_n"]
    X, truth = make_embedding_data(n, 512)
    Xd = torch.from_numpy(X).to(dev)
    with env_set(PPTORCH_LAYOUT_CACHE_MAX=sizes.get("layout_cache_max",
                                                    8 << 30)):
        staging.clear()
        runs = [fit(X, None, f"n={n} d=512 from host"),
                fit(Xd, None, f"n={n} d=512 from cuda")]
        # 7.5: the repeat, warm from host input, runs under a global TF32
        # setting, which must not reach the slab's product:
        # byte-identical.
        runs.append(fit(X, None, f"n={n} d=512 from host, warm, under "
                        f"set_float32_matmul_precision('high')", tf32=True))
        staging.clear()
    for model, _w, _l in runs:
        m = model.metrics_
        a = ari(model.labels_, truth)
        log(f"    ARI vs truth {a:.6f}; band_pairs past 2^31: "
            f"{m['band_pairs'] > 2**31}")
        if a < 0.99:
            fail(f"ARI {a} < 0.99 at n={n} x 512")
        if m["sketch_k"] != 128:
            fail(f"sketch_k {m['sketch_k']} != 128 at d=512")
    (m0, w0, l0), (m1, _w, _l), (m2, w2, l2) = runs
    if not (np.array_equal(m0.labels_, m2.labels_)
            and np.array_equal(m0.core_sample_mask_, m2.core_sample_mask_)):
        fail("repeated host fits differ at 512-D (the warm repeat under a "
             "global TF32 setting)")
    c_m, w_m = m0.metrics_, m2.metrics_
    # (A cold fit whose pair budget overflowed reran on its own cached
    # layout: its reuse is not 0 then, and is not gated.)
    if (not c_m["staged_bytes"] or w_m["staged_bytes"]
            or w_m["staged_bytes_reused"] != c_m["staged_bytes"]
            or l2 != l0):
        fail(f"the warm 512-D refit was not a staging hit launching what "
             f"the cold fit launched (cold staged {c_m['staged_bytes']}, "
             f"warm staged {w_m['staged_bytes']} reused "
             f"{w_m['staged_bytes_reused']}; launches {l0} / {l2})")
    log(f"  n={n}: repeated host fits byte-identical (the warm repeat "
        f"under TF32: {w2:.4f} s against {w0:.4f} s cold, "
        f"{w_m['staged_bytes_reused']} layout bytes reused); host vs "
        f"cuda-tensor labels identical: "
        f"{np.array_equal(m0.labels_, m1.labels_)}")
    main_launches = runs[0][2]
    del Xd

    # 7.4: B3 and B4 alone at the 1M fit's own inputs.
    kernels = at_main(X, main_launches, True)
    # The probe's readings: the largest share of the band's term (3) and
    # the largest error in units of 2^-24 sum |p|.
    kernels[0]["mma_probe_term3_share"], kernels[0]["mma_probe_err_u"] = probe
    onoff["main"] = (X, truth)
    onoff["warm512"] = {"n": n, "cold_s": w0, "warm_s": w2,
                        "staged_bytes": c_m["staged_bytes"],
                        "launches_cold": l0, "launches_warm": l2}
    return kernels, onoff


PRECISION_SIZES = {"check_n": 20_000, "sketch_n": 20_000, "sub_tiles": 64,
                   "reps": 5, "dims": (3, 16, 64, 96)}


def adversarial(n, d, eps, seed=3, offset=1e3):
    """tests/test_mixed_precision.py's adversarial geometry in numpy:
    12 blobs (std 0.25), duplicate points, and pairs planted at
    eps * (1 -+ 1e-4) from ten anchors, all shifted by ``offset`` (the
    fit centres it away; the kernels' recentring then works at the
    blobs' own scale)."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, size=(12, d))
    X = centers[rng.integers(0, 12, n)] + rng.normal(scale=0.25, size=(n, d))
    X[10] = X[11]
    X[12] = X[13] = X[14]
    for i, anchor in enumerate(range(0, 50, 5)):
        v = rng.normal(size=d)
        v /= np.linalg.norm(v)
        X[100 + 2 * i] = X[anchor] + (eps * (1 - 1e-4)) * v
        X[101 + 2 * i] = X[anchor] + (eps * (1 + 1e-4)) * v
    return (X + offset).astype(np.float32)


def eps2_bracket(e2, rel=2.0 ** -12):
    """float32 eps^2 values ``rel`` below and above ``e2``: a bf16
    kernel differs from its plain version only in the order of the d2f
    sum, far less than ``rel * eps^2``, and every verdict is monotone in
    eps^2, so the kernel's counts (labels) lie between the plain
    version's at the two."""
    return (float(np.float32(e2 * (1 - rel))),
            float(np.float32(e2 * (1 + rel))))


def precision_phase(torch, dev, median_ms, sync, main, served, onoff,
                    fp32_ms, sizes=PRECISION_SIZES):
    """Phase 8 (the precision modes); see the module docstring.

    ``main``: phase 4's 1M x 16-D data, truth and first host-input
    "high" model, and phase 5's staged inputs; ``served``: phase 6's
    context; ``onoff``: phase 7's 100k x 512 sketched fit; ``fp32_ms``:
    phase 5's B1/B2 times.  Returns the new kernels' JSON records."""
    from benchdata import make_blob_data, make_embedding_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, eps2_f32, row_offsets,
    )
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout
    from pypardis_tpu_torch.ops.query import (
        QUERY_GROUP, query_keep_walk, query_min_core_plain,
    )
    from pypardis_tpu_torch.serve import QueryEngine

    err = {}
    stat_rel = [0.0]
    diffs = {}
    # max_abs_err of each kernel on its main path's inputs.
    main_err = {}

    def note(name, e):
        err[name] = max(err.get(name, 0), int(e))

    def hold_main(name, mode, out, plain_at, e2, m, what, stat_tol=0.0,
                  exact=None):
        """A kernel's ``out`` on the main path's (sub-list) inputs against
        its plain version there, ``plain_at(eps2)``: ``"mixed"`` bitwise
        (and bitwise ``exact``, the FP32 kernel's output, if given),
        ``"default"`` between the plain version at the two ends of
        :func:`eps2_bracket`; band stats within ``stat_tol`` relative.
        Compares the rows of ``m``, records their largest difference as
        the kernel's ``max_abs_err`` and fails on any mismatch."""
        def split(r):
            return r if isinstance(r, tuple) else (r, None)

        out, kst = split(out)
        po, pst = split(plain_at(e2))
        k_m, p_m = out[m], po[m]
        nd = int((k_m != p_m).sum())
        main_err[name] = int((k_m.long() - p_m.long()).abs().max())
        if mode == "mixed":
            ok = nd == 0 and (exact is None or torch.equal(k_m, exact[m]))
        else:
            below, above = (split(plain_at(x))[0][m]
                            for x in eps2_bracket(e2))
            if name.startswith("minlab"):
                # More sources within a wider eps: smaller minima.
                below, above = above, below
            ok = bool((below <= k_m).all()) and bool((k_m <= above).all())
        rel = 0.0
        if kst is not None:
            rel = float((kst - pst).abs().max()) / max(float(pst.max()), 1.0)
            ok = ok and rel <= stat_tol
        log(f"    {name} on {what}: {nd} of {int(m.sum())} points differ "
            f"from the plain version"
            + ("" if kst is None else f", stats kernel {kst.tolist()} plain "
               f"{pst.tolist()} (rel {rel:.2e})")
            + f"; {'bitwise' if mode == 'mixed' else 'bracketed'}: {ok}")
        if not ok:
            fail(f"{name} disagrees with its plain version on {what}")

    def fast_inputs(xs, mask, eps, block, min_samples):
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, block, "mixed")
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                xs, eps, mask, block, "mixed", budget=total)
        d, N = xs.shape
        tile = ck._pallas_block(block, N, d, "mixed")
        rp = row_offsets(rows, N // tile)
        mi = mask.to(torch.int32)
        e2 = eps2_f32(eps)
        counts = ck.count_pairs(xs, mi, rp, cols, e2, tile)
        core = (torch.clamp_min(torch.where(mask, counts, 0), 1)
                >= min_samples) & mask
        lab = torch.where(core, torch.arange(N, device=xs.device,
                                             dtype=torch.int32),
                          INT_INF).contiguous()
        centers, rnorm = ck.tile_frames(xs, mask, tile)
        return dict(xs=xs, mask=mask, mi=mi, lab=lab, core=core, rp=rp,
                    cols=cols, e2=e2, tile=tile, centers=centers,
                    rnorm=rnorm, total=total)

    def hold(inp, what):
        """Mixed: bitwise the plain version and the FP32 kernel on valid
        rows, stats within the stated tolerance; default: bracketed by
        the plain version, differing points counted."""
        m = inp["mask"]
        a = (inp["xs"], inp["mi"], inp["rp"], inp["cols"])
        b = (inp["xs"], inp["lab"], inp["rp"], inp["cols"])
        e2, tile = inp["e2"], inp["tile"]
        fr = (inp["centers"], inp["rnorm"])
        d = inp["xs"].shape[0]
        kw = ({"rescored_pairs": torch.zeros(1, dtype=torch.int64,
                                             device=dev)}
              if d <= 64 else {})
        kc, kst = ck.count_pairs_mixed(*a, e2, tile, *fr, **kw)
        pc, pst = ck.PLAIN["count_pairs_mixed"](*a, e2, tile, *fr)
        fc = ck.count_pairs(*a, e2, tile)
        if kw:  # the tensor-core B1 decided the rest exactly
            b1_rescored_hold(a + (e2, tile), inp["centers"],
                             int(kw["rescored_pairs"][0]), f"{what}, mixed")
        kb = ck.minlab_pairs_mixed(*b, e2, tile, *fr)
        pb = ck.PLAIN["minlab_pairs_mixed"](*b, e2, tile, *fr)
        fb = ck.minlab_pairs(*b, e2, tile)
        sync()
        bad = (int((kc[m] != pc[m]).sum()) + int((kc[m] != fc[m]).sum())
               + int((kb[m] != pb[m]).sum()) + int((kb[m] != fb[m]).sum()))
        note("count_pairs_mixed", (kc[m].long() - pc[m].long()).abs().max())
        note("minlab_pairs_mixed", (kb[m].long() - pb[m].long()).abs().max())
        rel = float((kst - pst).abs().max()) / max(float(pst.max()), 1.0)
        stat_rel[0] = max(stat_rel[0], rel)
        lo, hi = eps2_bracket(e2)
        cen = inp["centers"]
        kd = ck.count_pairs_default(*a, e2, tile, cen)
        pd = ck.PLAIN["count_pairs_default"](*a, e2, tile, cen)
        kdb = ck.minlab_pairs_default(*b, e2, tile, cen)
        pdb = ck.PLAIN["minlab_pairs_default"](*b, e2, tile, cen)
        pl = ck.PLAIN["count_pairs_default"]
        pm = ck.PLAIN["minlab_pairs_default"]
        bracket = (bool((pl(*a, lo, tile, cen) <= kd).all())
                   and bool((kd <= pl(*a, hi, tile, cen)).all())
                   and bool((pm(*b, hi, tile, cen) <= kdb).all())
                   and bool((kdb <= pm(*b, lo, tile, cen)).all()))
        nd = int((kd[m] != pd[m]).sum()) + int((kdb[m] != pdb[m]).sum())
        note("count_pairs_default", (kd[m].long() - pd[m].long()).abs().max())
        note("minlab_pairs_default",
             (kdb[m].long() - pdb[m].long()).abs().max())
        diffs[what] = nd
        exact_d = int((kd[m] != fc[m]).sum())
        log(f"  {what}: tile {tile}, {inp['total']} live tile pairs; mixed "
            f"B1 stats kernel {kst.tolist()} plain {pst.tolist()} (rel "
            f"{rel:.2e}); mixed mismatches vs plain and FP32: {bad}; "
            f"default: {nd} points differ from the plain version "
            f"(bracketed: {bracket}), {exact_d} counts differ from FP32")
        if bad:
            fail(f"a mixed kernel disagrees on {what}")
        if not bracket:
            fail(f"a default kernel leaves its bracket on {what}")
        if int(kst[0]) <= 0:
            fail(f"no pair fell in the mixed band on {what}")

    # 8.1: B1/B2 against their plain versions.
    n = sizes["check_n"]
    for d in sizes["dims"]:
        eps_a = round(0.9 * np.sqrt(d / 8.0), 3)
        pts, nn, block = _stage(adversarial(n, d, eps_a), 1024, dev)
        xs, mask, _o = _pipeline_layout(pts, eps_a, nn, block, sort=True)
        hold(fast_inputs(xs, mask, eps_a, block, 6),
             f"adversarial d={d} eps={eps_a} offset 1e3")
        eps_b = {3: 1.2, 16: 2.4, 64: 4.8, 96: 6.0}.get(d, 0.6 * np.sqrt(d))
        Xb, _ = make_blob_data(n, d, n_centers=8, std=0.4, seed=d)
        pts, nn, block = _stage(Xb, 1024, dev)
        xs, mask, _o = _pipeline_layout(pts, eps_b, nn, block, sort=True)
        hold(fast_inputs(xs, mask, eps_b, block, 10),
             f"natural blobs d={d} eps={eps_b}")
    if stat_rel[0] > 1e-3:
        fail(f"mixed band stats differ from the plain version by "
             f"{stat_rel[0]:.2e} > 1e-3")
    log(f"  mixed band stats: kernel vs plain within {stat_rel[0]:.2e} "
        f"(tolerance 1e-3 relative)")

    # B3/B4 at 20k x 512 against their plain versions.
    eps_s, k = 2.0, 128
    Xs, _ = make_embedding_data(sizes["sketch_n"], 512)
    pts, nn, block = _stage(Xs, 2048, dev)
    xs, mask, _o = _pipeline_layout(pts, eps_s, nn, block, sort=True)
    e2 = eps2_f32(eps_s)
    lo, hi = eps2_bracket(e2)
    for mode in ("mixed", "default"):
        slab, band = ck.sketch_stage(xs, mask, k, mode)
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps_s, mask, block, mode, budget=1 << 22, sketch=k,
            slab=(slab, band))
        tile = ck._pallas_block(block, xs.shape[1], 512, mode)
        rp = row_offsets(rows, xs.shape[1] // tile)
        mi = mask.to(torch.int32)
        # B3 recentres on the row tiles' centres in every mode; B4 and
        # the plain versions take them under "default" only.
        b3_cen = ck.tile_frames(xs, mask, tile)[0]
        cen = b3_cen if mode == "default" else None
        a = (xs, mi, rp, cols, slab, k)
        kc, kst = ck.count_pairs_sketch(*a, e2, band, tile, mode, b3_cen)
        pc, pst = ck.PLAIN["count_pairs_sketch"](*a, e2, band, tile, cen)
        core = (torch.clamp_min(torch.where(mask, kc, 0), 1) >= 10) & mask
        lab = torch.where(core, torch.arange(len(kc), device=dev,
                                             dtype=torch.int32),
                          INT_INF).contiguous()
        b = (xs, lab, rp, cols, slab, k)
        kb = ck.minlab_pairs_sketch(*b, e2, band, tile, mode, cen)
        pb = ck.PLAIN["minlab_pairs_sketch"](*b, e2, band, tile, cen)
        sync()
        nb3 = f"count_pairs_sketch_{mode}"
        nb4 = f"minlab_pairs_sketch_{mode}"
        note(nb3, max(int((kc.long() - pc.long()).abs().max()),
                      int((kst - pst).abs().max())))
        note(nb4, (kb.long() - pb.long()).abs().max())
        nd = int((kc != pc).sum()) + int((kb != pb).sum())
        if mode == "mixed":
            ok = nd == 0 and torch.equal(kst, pst) and torch.equal(
                kc, ck.count_pairs(xs, mi, rp, cols, e2, tile))
        else:
            pl, pm = ck.PLAIN["count_pairs_sketch"], ck.PLAIN[
                "minlab_pairs_sketch"]
            ok = (torch.equal(kst, pst)
                  and bool((pl(*a, lo, band, tile, cen)[0] <= kc).all())
                  and bool((kc <= pl(*a, hi, band, tile, cen)[0]).all())
                  and bool((pm(*b, hi, band, tile, cen) <= kb).all())
                  and bool((kb <= pm(*b, lo, band, tile, cen)).all()))
        log(f"  B3/B4 {mode} at {sizes['sketch_n']} x 512 (k={k}, tile "
            f"{tile}, {total} live tile pairs): stats kernel {kst.tolist()} "
            f"plain {pst.tolist()}; {nd} points differ from the plain "
            f"version; {'bitwise' if mode == 'mixed' else 'bracketed'}: "
            f"{ok}")
        if not ok:
            fail(f"the sketch kernels disagree under {mode}")

    # 8.2 / 8.3: the 1M x 16-D fits.
    X, truth, ref = main["X"], main["truth"], main["model"]
    Xd = torch.from_numpy(X).to(dev)

    def fit(src, mode, what):
        model = DBSCAN(eps=2.4, min_samples=10, block=2048, precision=mode)
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model.fit(src)
        sync()
        wall = time.perf_counter() - t
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        m = model.metrics_
        log(f"  {what}: {wall:.4f} s, launches {launches}, passes "
            f"{m['kernel_passes']}, live pairs {m['live_pairs']}, band_pairs "
            f"{m['band_pairs']}, rescored_tiles {m['rescored_tiles']}, "
            f"clusters {int(model.labels_.max()) + 1}")
        if sum(launches.values()) != m["kernel_passes"]:
            fail(f"kernel launches do not sum to the passes ({what})")
        if (launches.get(f"count_pairs_{mode}") != 1
                or launches.get(f"minlab_pairs_{mode}", 0) < 1
                or len(launches) != 2):
            fail(f"the fit did not run its mode's kernels alone ({what})")
        return model, wall, launches

    runs = [fit(X, "mixed", f"n={len(X)} mixed from host")]
    runs += [fit(Xd, "mixed", f"n={len(X)} mixed from cuda ({i})")
             for i in (1, 2)]
    for model, _w, _l in runs:
        if not (np.array_equal(model.labels_, ref.labels_)
                and np.array_equal(model.core_sample_mask_,
                                   ref.core_sample_mask_)):
            fail("a mixed 1M fit differs from phase 4's high fit")
    log("    the three mixed fits are byte-identical to phase 4's high fit")
    mixed_launches = runs[0][2]
    dm, _w, default_launches = fit(Xd, "default",
                                   f"n={len(X)} default from cuda")
    a_t, a_h = ari(dm.labels_, truth), ari(dm.labels_, ref.labels_)
    n_diff = int((dm.labels_ != ref.labels_).sum())
    n_core = int((dm.core_sample_mask_ != ref.core_sample_mask_).sum())
    log(f"    default: ARI vs truth {a_t:.6f}, vs high {a_h:.6f}; {n_diff} "
        f"labels and {n_core} core flags differ from high")
    if a_t < 0.99:
        fail(f"default fit ARI {a_t} < 0.99")
    del Xd

    # 8.4: B1/B2 mixed and default alone at phase 5's 1M inputs.
    xs, mask = main["xs"], main["mask"]
    inp = fast_inputs(xs, mask, 2.4, 2048, 10)
    d, N = xs.shape
    tile = inp["tile"]
    nt = N // tile
    rp, cols = inp["rp"], inp["cols"]
    cols_t = cols[:int(rp[-1])].long()
    need = {"count_pairs": int(mask.view(nt, tile).sum(1)[cols_t].sum())
            * tile}
    fr = (inp["centers"], inp["rnorm"])
    a = (xs, inp["mi"], rp, cols, inp["e2"], tile)
    # In-band pairs of the pass: B1's band stats over valid rows and
    # columns.
    in_band = {"count_pairs": int(ck.count_pairs_mixed(*a, *fr)[1][0])}
    sub = min(sizes["sub_tiles"], nt)
    rp_sub = torch.cat([rp[:sub + 1], rp[sub].repeat(nt - sub)])
    # The rows the sub-list covers.
    m_sub = mask & (torch.arange(N, device=dev) < sub * tile)
    in_bytes = (d * N * 4 + N * 4 + rp.numel() * 4 + cols.numel() * 4
                + inp["centers"].numel() * 4 + inp["rnorm"].numel() * 4)
    K = -(-d // 16) * 16
    kernels = []
    for base, args, replaces in (
        ("count_pairs", a, "pypardis_tpu/ops/pallas_kernels.py:202"),
    ):
        sub_args = args[:2] + (rp_sub,) + args[3:]
        fp32_sub = getattr(ck, base)(*sub_args)
        for mode in ("mixed", "default"):
            name = f"{base}_{mode}"
            extra = fr if mode == "mixed" else fr[:1]
            kern = getattr(ck, name)
            plain = ck.PLAIN[name]
            hold_main(
                name, mode, kern(*sub_args, *extra),
                lambda e: plain(*sub_args[:4], e, tile, *extra), inp["e2"],
                m_sub, f"the 1M main-path inputs, first {sub} of {nt} row "
                f"tiles", stat_tol=1e-3,
                exact=fp32_sub if mode == "mixed" else None)
            kern_ms = median_ms(lambda: kern(*args, *extra), sizes["reps"])
            sub_ms = median_ms(lambda: kern(*sub_args, *extra), 3)
            plain_ms = median_ms(lambda: plain(*sub_args, *extra), 1)
            pairs = need[base]
            # The tensor-core B1's work (b1_bounds): under "mixed" with
            # the pairs its fallback decided exactly on the whole list.
            rescored = 0
            if mode == "mixed":
                rc = torch.zeros(1, dtype=torch.int64, device=dev)
                kern(*args, *extra, rescored_pairs=rc)
                rescored = int(rc[0])
            frames_ms = median_ms(
                lambda: ck.pass_frames(xs, mask, tile, mode), 3)
            t_tc = 2 * K * pairs / PEAK_BF16_FLOPS
            t_ops = b1_bounds(pairs, rescored, d, mode)
            simt = (t_ops - t_tc) * PEAK_FP32_FLOPS
            t_bytes = (in_bytes + N * 4) / PEAK_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            bound_by = "operations" if t_ops >= t_bytes else "bytes"
            floor_ms = max(b1_floor(pairs, rescored, d), t_bytes) * 1e3
            fp32_ms_all = max(pairs * (3 * d + 1) / PEAK_FP32_FLOPS,
                              t_bytes) * 1e3
            launches = (mixed_launches if mode == "mixed"
                        else default_launches).get(name, 0)
            log(f"  {name}: {kern_ms:.4f} ms (FP32 {base} "
                f"{fp32_ms[base]:.4f} ms; on the {sub}-tile sub-list "
                f"{sub_ms:.4f} ms, plain {plain_ms:.2f} ms), bound "
                f"{bound_ms:.4f} ms by {bound_by} ({t_tc * 1e3:.4f} ms "
                f"tensor cores + {simt / PEAK_FP32_FLOPS * 1e3:.4f} ms FP32; "
                f"floor {floor_ms:.4f} ms, all-FP32 work {fp32_ms_all:.4f} "
                f"ms); {pairs} point pairs, {in_band[base]} in the mixed "
                f"band ({in_band[base] / max(pairs, 1):.4%}), {rescored} "
                f"decided exactly ({rescored / max(pairs, 1):.6f}); the "
                f"frames' staging {frames_ms:.4f} ms")
            kernels.append({
                "name": name, "route": "cuda",
                "source": "pypardis_tpu_torch/csrc/pair_kernels.cu",
                "replaces": replaces, "launches": int(launches),
                "max_abs_err": main_err[name], "ms": kern_ms,
                "plain_ms": plain_ms,
                "plain_scope": f"first {sub} of {nt} row tiles",
                "bound_ms": bound_ms, "bound_by": bound_by,
                # No single PyTorch call computes a thresholded count or
                # min-label over a tile-pair list.
                "library_ms": None,
                "rescored_pairs": rescored,
                "bound_ms_fp32": fp32_ms_all, "floor_ms": floor_ms,
                "frames_ms": frames_ms,
            })
    # B2 at each round's labels of the fit, with the fit's live rows: the
    # kernels bitwise their plain versions and the walk (and "mixed" the
    # FP32 kernel) on the sub-list, their counts equal to the walk's.
    for rec in b2_rounds(torch, dev, median_ms, sync, xs, mask,
                         ("mixed", "default"),
                         dict(mixed_launches, **default_launches),
                         dict(B2_SIZES, sub_tiles=sizes["sub_tiles"],
                              reps=sizes["reps"])):
        main_err[rec["name"]] = rec["max_abs_err"]
        kernels.append(rec)

    # 8.5: serving through the mixed prefilter on phase 6's index.
    exact_eng = served["engine"]
    idx = exact_eng.index
    eng = QueryEngine(idx, precision="mixed")
    ck.reset_launch_counts()
    sync()
    t = time.perf_counter()
    tickets = [eng.submit(q) for q in served["batches"]]
    done = eng.drain()
    sync()
    wall = time.perf_counter() - t
    q_launches = ck.LAUNCHES["query_leaf_mixed"]
    lab = np.concatenate([tk.result() for tk in tickets])
    d2 = np.concatenate([tk.d2 for tk in tickets])
    same = (np.array_equal(lab, served["lab"])
            and np.array_equal(d2.view(np.int32), served["d2"].view(np.int32)))
    o_same = (np.array_equal(lab[:512], served["olab"])
              and np.array_equal(d2[:512].view(np.int32),
                                 served["od2"].view(np.int32)))
    st = eng.serving_stats()
    log(f"  mixed engine: {done} queries in {wall:.4f} s, {st['batches']} "
        f"batches, {q_launches} mixed B5 launches, queries/s {st['qps']}; "
        f"answers bitwise the exact engine's: {same}; first 512 bitwise "
        f"the oracle's: {o_same}; precision {st['precision']}")
    if not (same and o_same):
        fail("mixed serving differs from the exact engine or the oracle")
    if q_launches != st["batches"] or ck.LAUNCHES["query_leaf"]:
        fail("the mixed engine did not run the mixed B5 alone")
    q, tl, coords, labels = served["tiles"]
    kw = dict(block=idx.block, nb=idx.nb)
    tables = idx.kernel_tables()
    keep = torch.zeros(2, dtype=torch.int64, device=dev)
    ran = torch.zeros(1, dtype=torch.int64, device=dev)
    km = ck.query_leaf(q, tl, coords, labels, **kw, precision="mixed",
                       eps2=idx.eps2, keep_stats=keep, pass_stats=ran,
                       tables=tables)
    pm = query_min_core_plain(q, tl, coords, labels, **kw, precision="mixed",
                              eps2=idx.eps2)
    ex = ck.query_leaf(q, tl, coords, labels, **kw, tables=tables)
    _units, walk = query_keep_walk(q, tl, coords, labels, tables[2:],
                                   tables[1], idx.eps2, **kw)
    sync()

    def verdict(p):
        dd = p[1].view(torch.float32)
        ok = dd <= idx.eps2
        return torch.where(ok, p[0], -1), torch.where(ok, dd, float("inf"))

    # Rows a tile answers for (pad rows are dropped by the engine).
    real = torch.zeros(q.shape[0], q.shape[2], dtype=torch.bool, device=dev)
    for t, rows in enumerate(served["rowmap"]):
        real[t, :len(rows)] = True
    vk, vp, ve = verdict(km), verdict(pm), verdict(ex)
    q_bad = sum(int((x[0] != vk[0])[real].sum()) + int(
        (x[1].view(torch.int32) != vk[1].view(torch.int32))[real].sum())
        for x in (vp, ve))
    kept = int(keep[0]) / max(int(keep[1]), 1)
    w_kept, w_vis, w_frag, w_pairs = (int(x) for x in walk)
    pairs = served["fill"]["real_pairs"]
    note("query_leaf_mixed", q_bad)
    log(f"  mixed B5's units (tile, {QUERY_GROUP}-row group, column block "
        f"of {idx.block}): kept {int(keep[0])} of {int(keep[1])} visited "
        f"({kept:.4f}); query_keep_walk: kept {w_kept} of {w_vis} "
        f"({w_kept / max(w_vis, 1):.4f}), {w_frag} fragile units "
        f"(tolerance: the card's kept count within the walk's fragile "
        f"units, visited equal); the pass computed {int(ran)} pairs "
        f"(measured; exact B5's pass {served['fill']['pass_pairs']}); the "
        f"walk keeps {w_pairs} of the {pairs} real pairs "
        f"({w_pairs / max(pairs, 1):.4f}) pair by pair")
    if int(keep[1]) != w_vis or abs(int(keep[0]) - w_kept) > w_frag:
        fail("mixed B5's kept units disagree with query_keep_walk")
    ms_m = median_ms(lambda: ck.query_leaf(
        q, tl, coords, labels, **kw, precision="mixed", eps2=idx.eps2,
        tables=tables), 10)
    ms_e = median_ms(lambda: ck.query_leaf(q, tl, coords, labels, **kw,
                                           tables=tables), 10)
    plain_ms = median_ms(lambda: query_min_core_plain(
        q, tl, coords, labels, **kw, precision="mixed", eps2=idx.eps2), 3)
    bound_ms, bound_by, ceiling_ms, _nb = b5_bounds(
        served["fill"], q.shape[1], w_pairs)
    log(f"  query_leaf_mixed on batch 2: {ms_m:.4f} ms per batch (exact B5 "
        f"{ms_e:.4f} ms, plain {plain_ms:.2f} ms), bound {bound_ms:.4f} ms, "
        f"unfused SIMT ceiling {ceiling_ms:.4f} ms; after the verdict "
        f"{q_bad} mismatches on the {int(real.sum())} real rows against the "
        f"plain version and the exact kernel")
    if q_bad:
        fail("the mixed B5 disagrees after the verdict")
    kernels.append({
        "name": "query_leaf_mixed", "route": "cuda",
        "source": "pypardis_tpu_torch/csrc/query_kernels.cu",
        "replaces": "pypardis_tpu/ops/pallas_kernels.py:1107",
        "launches": q_launches // st["batches"], "max_abs_err": q_bad,
        "ms": ms_m, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "simt_ceiling_ms": ceiling_ms,
        "library_ms": None, "kept_share": kept,
        "kept_share_walk": w_kept / max(w_vis, 1),
        "kept_pairs_share_walk": w_pairs / max(pairs, 1),
    })

    # 8.6: 100k x 512 through B3/B4 under both modes.
    X5, truth5, high5 = onoff["X"], onoff["truth"], onoff["model"]
    s_launch = {}
    for mode in ("mixed", "default"):
        model = DBSCAN(eps=2.0, min_samples=10, block=2048, precision=mode)
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model.fit(X5)
        sync()
        wall = time.perf_counter() - t
        launches = {k: v for k, v in ck.LAUNCHES.items() if v}
        s_launch.update(launches)
        m = model.metrics_
        a5 = ari(model.labels_, truth5)
        same = (np.array_equal(model.labels_, high5.labels_)
                and np.array_equal(model.core_sample_mask_,
                                   high5.core_sample_mask_))
        log(f"  n={len(X5)} d=512 {mode}: {wall:.4f} s, tile "
            f"{m['kernel_block']}, launches {launches}, passes "
            f"{m['kernel_passes']}, band_pairs {m['band_pairs']}, ARI vs "
            f"truth {a5:.6f}, byte-identical to high: {same}")
        if (launches.get(f"count_pairs_sketch_{mode}") != 1
                or len(launches) != 2
                or sum(launches.values()) != m["kernel_passes"]):
            fail(f"the {mode} 512-D fit did not run its sketch kernels")
        if mode == "mixed" and not same:
            fail("the mixed 512-D fit differs from the high fit")
        if mode == "default" and (a5 < 0.99 or m["kernel_block"] != 1024):
            fail(f"default 512-D fit: ARI {a5}, tile {m['kernel_block']}")

    # B3/B4 mixed and default alone at the 100k inputs.
    pts, nn, block = _stage(X5, 2048, dev)
    xs, mask, _o = _pipeline_layout(pts, 2.0, nn, block, sort=True)
    for mode in ("mixed", "default"):
        slab, band = ck.sketch_stage(xs, mask, k, mode)
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, 2.0, mask, block, mode, budget=1 << 22, sketch=k,
            slab=(slab, band))
        tile = ck._pallas_block(block, xs.shape[1], 512, mode)
        nt = xs.shape[1] // tile
        rp = row_offsets(rows, nt)
        # B3 recentres on the row tiles' centres in both modes; B4 only
        # under "default" (its exact rescore takes none).
        cen = ck.tile_frames(xs, mask, tile)[0]
        mi = mask.to(torch.int32)
        a = (xs, mi, rp, cols, slab, k, e2, band, tile, mode, cen)
        rc = torch.zeros(1, dtype=torch.int64, device=dev)
        if mode == "default":
            counts, st3 = ck.count_pairs_sketch(*a)
        else:
            counts, st3 = ck.count_pairs_sketch(*a, rescored_pairs=rc)
        core = (torch.clamp_min(torch.where(mask, counts, 0), 1) >= 10) & mask
        lab = torch.where(core, torch.arange(len(counts), device=dev,
                                             dtype=torch.int32),
                          INT_INF).contiguous()
        b = (xs, lab) + a[2:10] + (cen if mode == "default" else None,)
        st4 = ck.count_pairs_sketch(xs, core.to(torch.int32), *a[2:])[1]
        cols_t = cols[:int(rp[-1])].long()
        sub = min(sizes["sub_tiles"], nt)
        rp_sub = torch.cat([rp[:sub + 1], rp[sub].repeat(nt - sub)])
        m_sub = mask & (torch.arange(len(mask), device=dev) < sub * tile)
        nbytes = ((512 + slab.shape[0] + 2) * xs.shape[1] * 4
                  + rp.numel() * 4 + cols.numel() * 4)
        for base, args, st, per_tile, replaces in (
            ("count_pairs_sketch", a, st3, mask,
             "pypardis_tpu/ops/pallas_kernels.py:341"),
            ("minlab_pairs_sketch", b, st4, core,
             "pypardis_tpu/ops/pallas_kernels.py:393"),
        ):
            name = f"{base}_{mode}"
            kern = getattr(ck, base)
            plain = ck.PLAIN[base]
            sub_args = args[:2] + (rp_sub,) + args[3:]
            # The plain versions take no mode: (..., eps2, band, tile,
            # centers), the centres only for the bf16 rescore.
            pcen = sub_args[10] if mode == "default" else None
            hold_main(
                name, mode, kern(*sub_args),
                lambda e: plain(*sub_args[:6], e, *sub_args[7:9], pcen),
                e2, m_sub, f"the {len(X5)} x 512 fit's inputs, first {sub} "
                f"of {nt} row tiles")
            kern_ms = median_ms(lambda: kern(*args), 3)
            plain_ms = median_ms(cold(lambda: plain(*sub_args[:9], pcen)),
                                 1)
            gated = int(per_tile.view(nt, tile).sum(1)[cols_t].sum()) * tile
            inb = int(st[0])
            extra = {}
            if base == "minlab_pairs_sketch":
                # B4 skips the chunks whose labels cannot lower a row: its
                # bound is the gate alone over the pairs a label-exact
                # method must rule out (b4_floor_pairs), a floor.
                ev = torch.zeros(1, dtype=torch.int64, device=dev)
                best = kern(*args, evaluated=ev)
                floor = b4_floor_pairs(torch, lab, rp, cols, best, tile)
                simt, t_tc = floor * (3 * (k + 1) + 3), 0.0
                extra = {"evaluated_share":
                         int(ev[0]) / max(b4_chunks(rp, tile), 1)}
                log(f"  {name}: evaluated {int(ev[0])} of "
                    f"{b4_chunks(rp, tile)} (block, chunk) pairs "
                    f"({extra['evaluated_share']:.6f}); label-exact floor "
                    f"{floor} pairs")
            elif mode == "mixed":
                # The certified rescore (b3_bounds' new bound).
                simt = gated * (3 * (k + 1) + 3) + int(rc[0]) * (3 * 512 + 1)
                t_tc = 2 * 512 * inb / PEAK_BF16_FLOPS
                extra = {"rescored_pairs": int(rc[0])}
                log(f"  {name}: rescored_pairs {int(rc[0])} "
                    f"({int(rc[0]) / max(inb, 1):.6f} of {inb} in band)")
            else:
                simt = gated * (3 * (k + 1) + 3) + inb * EPILOGUE_OPS[mode]
                t_tc = 2 * 512 * inb / PEAK_BF16_FLOPS
            t_ops = t_tc + simt / PEAK_FP32_FLOPS
            t_bytes = (nbytes + xs.shape[1] * 4) / PEAK_BYTES_PER_S
            bound_ms = max(t_ops, t_bytes) * 1e3
            log(f"  {name} at {len(X5)} x 512 (tile {tile}): {kern_ms:.3f} ms "
                f"(plain {plain_ms:.2f} ms on the first {sub} of {nt} row "
                f"tiles), bound {bound_ms:.3f} ms; {gated} gated pairs, {inb} "
                f"in band")
            kernels.append(dict(extra, **{
                "name": name, "route": "cuda",
                "source": "pypardis_tpu_torch/csrc/sketch_kernels.cu",
                "replaces": replaces,
                "launches": int(s_launch.get(name, 0)),
                "max_abs_err": main_err[name], "ms": kern_ms,
                "plain_ms": plain_ms,
                "plain_scope": f"first {sub} of {nt} row tiles at {len(X5)} x 512",
                "bound_ms": bound_ms,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None,
            }))
    log(f"  default kernels, points differing from their plain versions: "
        f"{diffs}")
    return kernels


def b2_walk_shares(torch, dev, n=1_000_000, sub_tiles=None):
    """``--b2-walk``: the evaluated share of B2's label-bound skip per
    round of the 1M x 16-D fit in each mode, from
    ``ops/distances.minlab_pairs_walk`` over the whole pair list (no
    kernel of B2 runs): with every row in the bound and with only the
    fit's live rows (valid, and after round 1 those whose previous pass
    found a source), at one chunk per barrier and at the kernel's
    group.  ``sub_tiles`` restricts the list to its first row tiles."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, eps2_f32, minlab_group, minlab_pairs_walk, row_offsets,
    )
    from pypardis_tpu_torch.ops.labels import _pointer_jump
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

    X, _truth = make_blob_data(n, 16, n_centers=32, std=0.4)
    pts, nn, block = _stage(X, 2048, dev)
    xs, mask, _o = _pipeline_layout(pts, 2.4, nn, block, sort=True)
    d, N = xs.shape
    e2 = eps2_f32(2.4)
    idx = torch.arange(N, device=dev, dtype=torch.int32)
    out = {}
    for mode in ("high", "mixed", "default"):
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, 2.4, mask, block, mode)
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                xs, 2.4, mask, block, mode, budget=total)
        tile = ck._pallas_block(block, N, d, mode)
        nt = N // tile
        rp = row_offsets(rows, nt)
        if sub_tiles:
            rp = torch.cat([rp[:sub_tiles + 1],
                            rp[sub_tiles].repeat(nt - sub_tiles)])
        centers, rnorm = ck.tile_frames(xs, mask, tile)
        mi = mask.to(torch.int32)
        counts = (ck.count_pairs_default(xs, mi, rp, cols, e2, tile, centers)
                  if mode == "default" else
                  ck.count_pairs(xs, mi, rp, cols, e2, tile))
        core = (torch.clamp_min(torch.where(mask, counts, 0), 1) >= 10) & mask
        rpb = 256 if mode == "high" else 128
        chunks = int(rp[-1]) * -(-tile // rpb) * -(-tile // 32)
        groups = sorted({1, minlab_group(d, mode)})
        f = torch.where(core, idx, INT_INF)
        live = mask
        shares = []
        while True:
            lab = f.contiguous()
            row = {}
            for name, lr in (("all rows", None), ("live rows", live)):
                for g in groups:
                    best, ev = minlab_pairs_walk(
                        xs, lab, rp, cols, e2, tile, mode, centers, rnorm,
                        live_rows=lr, group=g)
                    row[f"{name}, group {g}"] = ev / max(chunks, 1)
            g_best = best
            log(f"  B2 walk {mode} round {len(shares) + 1}: "
                + ", ".join(f"{k} {v:.6f}" for k, v in row.items())
                + f" of {chunks} (block, chunk) pairs; rows without a "
                f"source {int((mask & (g_best == INT_INF)).sum())}, pad "
                f"rows {int((~mask).sum())}")
            shares.append(row)
            live = mask & (g_best != INT_INF)
            f_new = _pointer_jump(
                torch.where(core, torch.minimum(f, g_best), f), core)
            if torch.equal(f_new, f):
                break
            f = f_new
        out[mode] = shares
    return out


def b5_timings(torch, dev, median_ms, reps=10):
    """``--b5``: B5 alone on phase 6's 16 batches from the 1M x 16-D
    model fitted from a CUDA tensor: per batch its fill, exact and mixed
    B5 (CUDA-event medians of ``reps``) with their bounds, the mixed
    kept share and the pairs each pass computed; then the warm drain
    against the sync ``predict`` per batch, for an exact and a mixed
    engine.  Copied into a parent tree's root it times that tree's B5
    (whose index has no tables, whose wrapper counts no pass pairs and
    whose package has no ``query_keep_walk``: no mixed bound there) the
    same way, for an A/B in one call.  Returns the two B5 records
    (medians over the batches)."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.serve import QueryEngine

    X, _truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
    model = DBSCAN(eps=2.4, min_samples=10, block=2048).fit(
        torch.from_numpy(X).to(dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng = model.query_engine()
    torch.cuda.synchronize()
    idx = eng.index
    log(f"  1M x 16-D from a CUDA tensor; index build "
        f"{time.perf_counter() - t:.3f} s: {idx.n_leaves} leaves, leaf_cap "
        f"{idx.leaf_cap}, block {idx.block}, pad_waste "
        f"{idx.stats['pad_waste']}, {idx.index_device_bytes} bytes on the "
        f"card")
    _Q, _kind, _src, batches, _sync_q = serve_traffic(model, X)
    per = len(batches[0])
    try:
        from pypardis_tpu_torch.ops.query import query_keep_walk
    except ImportError:
        query_keep_walk = None
    counted = _takes(ck.query_leaf, "pass_stats")
    rows = {"exact": [], "mixed": []}
    tiles = []
    for b, qs in enumerate(batches):
        qbuf, tl_np, rowmap = idx.assemble(idx.prepare_queries(qs))
        q = torch.from_numpy(qbuf).to(dev)
        tl = torch.from_numpy(tl_np).to(dev)
        tiles.append((q, tl))
        f = b5_fill(idx, tl_np, rowmap, qbuf.shape[2])
        keep = torch.zeros(2, dtype=torch.int64, device=dev)
        ran = torch.zeros(2, dtype=torch.int64, device=dev)
        cnt = ((lambda i: dict(pass_stats=ran[i:i + 1])) if counted
               else (lambda i: {}))
        b5_call(ck, idx, q, tl, **cnt(0))
        b5_call(ck, idx, q, tl, precision="mixed", eps2=idx.eps2,
                keep_stats=keep, **cnt(1))
        w_pairs = None
        if query_keep_walk is not None:
            coords, labels, _lo, _hi = idx.device_tensors()
            tables = idx.kernel_tables()
            w_pairs = int(query_keep_walk(
                q, tl, coords, labels, tables[2:], tables[1], idx.eps2,
                block=idx.block, nb=idx.nb)[1][3])
        torch.cuda.synchronize()
        kept = int(keep[0]) / max(int(keep[1]), 1)
        ms_e = median_ms(lambda: b5_call(ck, idx, q, tl), reps)
        ms_m = median_ms(lambda: b5_call(
            ck, idx, q, tl, precision="mixed", eps2=idx.eps2), reps)
        be = b5_bounds(f, qbuf.shape[1])
        bm = (b5_bounds(f, qbuf.shape[1], w_pairs) if w_pairs is not None
              else (None, None, None, None))
        rows["exact"].append((ms_e, be))
        rows["mixed"].append((ms_m, bm))
        bm_s = ("no walk in this tree" if w_pairs is None else
                f"bound {bm[0]:.4f}, ceiling {bm[2]:.4f}, the walk keeps "
                f"{w_pairs} real pairs")
        log(f"  batch {b}: exact {ms_e:.4f} ms (bound {be[0]:.4f}, SIMT "
            f"ceiling {be[2]:.4f}); mixed {ms_m:.4f} ms ({bm_s}, kept "
            f"{int(keep[0])} of {int(keep[1])} units, {kept:.4f}, its pass "
            f"computed {int(ran[1]) if counted else 'n/a'} pairs); "
            f"{fill_line(f, int(ran[0]) if counted else None)}")
    # Device time by kernel (torch.profiler), the 16 batches through
    # each mode: what the CUDA-event times above hold beyond the kernels
    # is the wrapper's host time before its first launch.
    for mode, kw in (("exact", {}),
                     ("mixed", dict(precision="mixed", eps2=idx.eps2))):
        _profiled(torch, f"B5 {mode} on the {len(tiles)} batches", lambda: [
            b5_call(ck, idx, q, tl, **kw) for q, tl in tiles])
    for mode, r in rows.items():
        ms = [x[0] for x in r]
        bounds = ("" if r[0][1][0] is None else
                  f", bound sum {sum(x[1][0] for x in r):.4f}, SIMT ceiling "
                  f"sum {sum(x[1][2] for x in r):.4f}")
        log(f"  B5 {mode}: ms per batch median {np.median(ms):.4f}, sum "
            f"over {len(ms)} batches {sum(ms):.4f}{bounds}")
    for name, e in (("exact", eng), ("mixed", QueryEngine(idx,
                                                          precision="mixed"))):
        for qs in batches:
            e.submit(qs)
        e.drain()
        log(f"  {name} engine:")
        warm_drain_sync(e, batches, per)
    records = []
    for mode, name in (("exact", "query_leaf"), ("mixed", "query_leaf_mixed")):
        r = rows[mode]
        i = int(np.argsort([x[0] for x in r])[len(r) // 2])
        records.append({
            "name": name, "route": "cuda",
            "source": "pypardis_tpu_torch/csrc/query_kernels.cu",
            "replaces": "pypardis_tpu/ops/pallas_kernels.py:1107",
            "launches": 1, "max_abs_err": None, "ms": r[i][0],
            "plain_ms": None, "bound_ms": r[i][1][0],
            "bound_by": r[i][1][1], "simt_ceiling_ms": r[i][1][2],
            "library_ms": None,
        })
    return records


# Cosine eps on make_embedding_data(n, 512) (1 - cos; the kernels run at
# sqrt(2 eps) on the unit rows): at the Euclidean fit's eps 2.0 over the
# typical centre norm.
COS_EPS = 0.008
# Haversine: 50 m over the Earth's mean radius, in radians.
HAV_EPS = 50.0 / 6_371_000.0
# Cityblock eps on the phase 4 blobs (16-D, std 0.4): ARI 0.9999 on a
# 60,000-point subsample on the CPU.
L1_EPS = 6.0
# The sweep's eps_max on the phase 4 blobs at 1M and its graph's exact
# edge_total, self-pairs included (measured on an H100 80GB HBM3),
# under the 2^26-edge cap; 2.4 is far past it.
SWEEP_EPS_MAX = 1.15
SWEEP_EDGES = 43_341_250
SWEEP_PAST_CAP = 2.4


# Phase 9: the metrics and the sweep.  Sizes of the phase; a test
# rehearses it at small ones on the CPU.
METRIC_SIZES = {"cos_n": 500_000, "cos_serve_n": 100_000,
                "check_n": 20_000, "hav_n": 1_000_000,
                "l1_n": 1_000_000, "l1_fit_n": 200_000, "l1_sub_n": 20_000,
                "queries": 4096,
                "oracle_rows": 8, "sub_tiles": 64, "plain_tiles": 4,
                "reps": 3, "block": 2048, "sweep_edges": SWEEP_EDGES}


def geolife_like(n, seed=0):
    """GeoLife-shaped stay points (BASELINE config 3's shape): (n, 2)
    [lat, lon] radians in float64, 64 stay-point clusters of 100 m
    spread inside a 40 km box at Beijing's latitude, at least 1 km
    apart, plus 10 % uniform noise.  Returns (X, truth), truth -1 for
    the noise."""
    rng = np.random.default_rng(seed)
    R = 6_371_000.0
    lat0, lon0 = np.radians(39.9), np.radians(116.4)
    half_lat = 20_000.0 / R
    half_lon = half_lat / np.cos(lat0)
    centers = []
    while len(centers) < 64:
        c = np.array([rng.uniform(-half_lat, half_lat),
                      rng.uniform(-half_lon, half_lon)])
        if all(np.hypot((c[0] - o[0]) * R,
                        (c[1] - o[1]) * R * np.cos(lat0)) >= 1000.0
               for o in centers):
            centers.append(c)
    centers = np.asarray(centers)
    n_noise = n // 10
    assign = rng.integers(0, 64, n - n_noise)
    sig = np.array([100.0 / R, 100.0 / (R * np.cos(lat0))])
    pts = centers[assign] + rng.normal(size=(len(assign), 2)) * sig
    noise = np.column_stack([rng.uniform(-half_lat, half_lat, n_noise),
                             rng.uniform(-half_lon, half_lon, n_noise)])
    X = np.concatenate([pts, noise]) + np.array([lat0, lon0])
    truth = np.concatenate([assign, np.full(n_noise, -1)])
    perm = rng.permutation(n)
    return X[perm], truth[perm]


def card_oracle(torch, qf32, coords, labels, eps2):
    """``ops/query.brute_force_query``'s arithmetic on the tensors'
    device: per query, over all cores, the axis-ordered sum of
    separately rounded squares (each torch op its own kernel, so no
    fused multiply-add), the least d^2 and the least label among its
    ties; (-1, +inf) past eps^2.  ``coords`` (d, m) float32, ``labels``
    (m,) int32; returns numpy (labels, d2)."""
    dev = coords.device
    q = torch.from_numpy(np.ascontiguousarray(qf32)).to(dev)
    m = coords.shape[1]
    out_lab = np.full(len(qf32), -1, np.int32)
    out_d2 = np.full(len(qf32), np.inf, np.float32)
    chunk = max(1, (1 << 28) // max(m, 1))
    lab = labels[None, :]
    for s in range(0, len(qf32), chunk):
        qq = q[s:s + chunk]
        diff = qq[:, 0, None] - coords[0][None, :]
        acc = diff * diff
        for a in range(1, coords.shape[0]):
            diff = qq[:, a, None] - coords[a][None, :]
            acc = acc + diff * diff
        dmin = acc.min(dim=1).values
        tied = torch.where(acc == dmin[:, None], lab, INT32_MAX)
        labmin = tied.min(dim=1).values
        sel = dmin <= eps2
        e = s + len(qq)
        out_lab[s:e] = torch.where(sel, labmin, -1).cpu().numpy()
        out_d2[s:e] = torch.where(sel, dmin, float("inf")).cpu().numpy()
    return out_lab, out_d2


def metrics_phase(torch, dev, median_ms, sync, sizes=METRIC_SIZES,
                  embedding=None):
    """Phase 9 (the metrics and the sweep); see the module docstring.
    ``embedding``: phase 7's ``make_embedding_data(1M, 512)`` as ``(X,
    truth)``, made here when None.  Returns the kernels' records at the
    slice's new shapes and the phase's own record (walls, the L1 pass,
    the sweep)."""
    from benchdata import make_blob_data, make_embedding_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.dbscan import _stage, _unit_rows
    from pypardis_tpu_torch.geometry import latlon_to_unit_sphere
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        counts_over_pairs, eps_threshold, minlab_over_pairs, row_offsets,
    )
    from pypardis_tpu_torch.ops.pipeline import (
        _pipeline_layout, sweep_config_pack, sweep_graph_pipeline,
    )
    from pypardis_tpu_torch.ops.query import (
        brute_force_query, query_min_core_plain, query_pass_pairs,
    )

    block, reps = sizes["block"], sizes["reps"]
    kernels, rec = [], {}
    t_phase = time.perf_counter()

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def timed_fit(model, X):
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model.fit(X)
        sync()
        return (time.perf_counter() - t, dict(ck.LAUNCHES),
                dict(ck.L1_PASSES))

    def same_fit(a, b, what):
        ok = (np.array_equal(a.labels_, b.labels_)
              and np.array_equal(a.core_sample_mask_, b.core_sample_mask_))
        log(f"  {what}: labels and core mask byte-identical: {ok}")
        if not ok:
            fail(f"{what}: the fits differ")

    def held(name, kern, plain, what):
        diff = (kern.long() - plain.long()).abs()
        err = int(diff.max()) if diff.numel() else 0
        bad = int((diff != 0).sum())
        log(f"    {name} {what}: max|kernel-plain| = {err}, mismatches "
            f"{bad}")
        if bad:
            fail(f"{name} disagrees with its plain version on {what}")
        return err

    def inputs(X, eps, k=0, metric="euclidean"):
        """The first B1 (or B3) and B2 (or B4) inputs a fit of the
        kernel-frame rows ``X`` at ``eps`` builds, staged from host."""
        pts, n, blk = _stage(X, block, dev)
        xs, mask, _o = _pipeline_layout(pts, eps, n, blk, sort=n > 2 * blk)
        slab = ck.sketch_stage(xs, mask, k, "high") if k else None
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, blk, "high", sketch=k, slab=slab, metric=metric)
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                xs, eps, mask, blk, "high", budget=total, sketch=k,
                slab=slab, metric=metric)
        d, N = xs.shape
        tile = ck._pallas_block(blk, N, d, "high")
        rp = row_offsets(rows, N // tile)
        centers = ck.pass_frames(xs, mask, tile, "high", k)[0]
        return dict(xs=xs, mask=mask, mi=mask.to(torch.int32), rp=rp,
                    cols=cols, tile=tile, e2=eps_threshold(eps, metric),
                    k=k, slab=slab, centers=centers, nt=N // tile)

    def core_labels(inp, counts, ms):
        core = (torch.clamp_min(torch.where(inp["mask"], counts, 0), 1)
                >= ms) & inp["mask"]
        idx = torch.arange(inp["xs"].shape[1], device=dev, dtype=torch.int32)
        return core, torch.where(core, idx, INT32_MAX).contiguous()

    def sub_list(inp):
        sub = min(sizes["sub_tiles"], inp["nt"])
        rp = inp["rp"]
        return sub, torch.cat([rp[:sub + 1], rp[sub].repeat(inp["nt"] - sub)])

    def pair_work(inp, colmask):
        """(row, column) pairs of every live tile pair against the
        columns of ``colmask``."""
        nt, tile = inp["nt"], inp["tile"]
        cols_t = inp["cols"][: int(inp["rp"][-1])].long()
        return int(colmask.view(nt, tile).sum(1)[cols_t].sum()) * tile

    def record(name, source, replaces, launches, err, ms, plain_ms,
               bound_s, bound_by, shape, **extra):
        r = {"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": int(launches),
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": bound_s * 1e3, "bound_by": bound_by,
             # No single PyTorch call computes these thresholded pair
             # reductions over a tile-pair list.
             "library_ms": None, "shape": shape}
        r.update(extra)
        log(f"  {name} at {shape}: {ms:.4f} ms (plain {plain_ms:.3f} ms), "
            f"bound {r['bound_ms']:.4f} ms by {bound_by}")
        kernels.append(r)

    def bound(t_ops, t_bytes):
        return (max(t_ops, t_bytes),
                "operations" if t_ops >= t_bytes else "bytes")

    def served(model, X, what, seed):
        """4,096 queries (half jittered data rows, half exact core rows)
        through the model's engine: B5 launched once per batch, answers
        bitwise the card oracle's over all cores, which equals the numpy
        oracle on the first rows; then B5 against its plain version on
        the batch's tiles, timed."""
        rng = np.random.default_rng(seed)
        nq = sizes["queries"]
        core_rows = np.flatnonzero(model.core_sample_mask_)
        src = rng.integers(0, len(X), nq // 2)
        scale = (np.abs(X[src]).max() * 1e-3 if what == "cosine"
                 else HAV_EPS / 2)
        Q = np.concatenate([
            X[src] + rng.normal(scale=scale, size=(nq // 2, X.shape[1])),
            X[core_rows[rng.integers(0, len(core_rows), nq - nq // 2)]],
        ])
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        eng = model.query_engine()
        sync()
        build_s = time.perf_counter() - t
        idx = eng.index
        t = time.perf_counter()
        ticket = eng.submit(Q)
        eng.drain()
        lab, d2 = ticket.result(), ticket.d2
        sync()
        wall = time.perf_counter() - t
        launches = ck.LAUNCHES["query_leaf"]
        st = eng.serving_stats()
        log(f"  {what} serving: index {idx.n_core} cores, {idx.n_leaves} "
            f"leaves, build {build_s:.3f} s; {nq} queries in {wall:.4f} s, "
            f"{launches} B5 launches for {st['batches']} batches; "
            f"projection {idx.projection!r}; within eps "
            f"{int((lab >= 0).sum())}")
        if launches < 1 or launches != st["batches"]:
            fail(f"B5 launches {launches} != batches {st['batches']} "
                 f"({what})")
        coords, labels, _blo, _bhi = idx.device_tensors()
        sel = torch.from_numpy(idx.labels != INT32_MAX).to(dev)
        qf = idx.prepare_queries(Q)
        t = time.perf_counter()
        olab, od2 = card_oracle(torch, qf, coords[:, sel], labels[sel],
                                idx.eps2)
        o_s = time.perf_counter() - t
        # The card oracle against the numpy one on a few rows over the
        # first 65,536 cores (over all 1M at 512-D numpy takes minutes).
        k = sizes["oracle_rows"]
        hsel = np.flatnonzero(idx.labels != INT32_MAX)[:1 << 16]
        nlab, nd2 = brute_force_query(qf[:k], idx.coords[:, hsel].T,
                                      idx.labels[hsel], idx.eps)
        hsel_t = torch.from_numpy(hsel).to(dev)
        clab, cd2 = card_oracle(torch, qf[:k], coords[:, hsel_t],
                                labels[hsel_t], idx.eps2)
        tie = (np.array_equal(nlab, clab)
               and np.array_equal(nd2.view(np.int32), cd2.view(np.int32)))
        same = (np.array_equal(lab, olab)
                and np.array_equal(d2.view(np.int32), od2.view(np.int32)))
        log(f"    {nq} queries vs the oracle over {int(sel.sum())} cores "
            f"on the card ({o_s:.1f} s): labels and d2 bits equal: {same}; "
            f"the card oracle equals the numpy one on {k} rows over "
            f"{len(hsel)} cores: {tie}")
        if not (same and tie):
            fail(f"{what} predict differs from the brute-force oracle")
        qbuf, tile_leaf, rowmap = idx.assemble(qf)
        q = torch.from_numpy(qbuf).to(dev)
        tl = torch.from_numpy(tile_leaf).to(dev)
        kern = b5_call(ck, idx, q, tl)
        # The plain version over the batch's first tiles: at 512-D over
        # the whole batch it takes tens of seconds.
        nsub = min(q.shape[0], sizes["plain_tiles"])
        sub = (q[:nsub], tl[:nsub], coords, labels)
        plain = query_min_core_plain(*sub, block=idx.block, nb=idx.nb)
        err = held("query_leaf", kern[:, :nsub], plain,
                   f"the {what} batch, first {nsub} of {q.shape[0]} tiles")
        f = b5_fill(idx, tile_leaf, rowmap, q.shape[2])

        def kern_call():
            return b5_call(ck, idx, q, tl)

        ms = (median_ms(kern_call, reps) if idx.d <= 64
              else median_ms(cold(kern_call), 1))
        plain_ms = median_ms(
            lambda: query_min_core_plain(*sub, block=idx.block,
                                         nb=idx.nb), 1)
        bound_ms, bound_by, _simt, _nb = b5_bounds(f, idx.d)
        pp = query_pass_pairs(q, tl, idx.kernel_tables()[1],
                              block=idx.block, nb=idx.nb)
        record("query_leaf", "pypardis_tpu_torch/csrc/query_kernels.cu",
               "pypardis_tpu/ops/pallas_kernels.py:1107", launches, err, ms,
               plain_ms, bound_ms * 1e-3, bound_by, f"{what} d={idx.d}",
               plain_scope=f"first {nsub} of {q.shape[0]} tiles",
               real_pairs=f["real_pairs"], pass_pairs=int(pp))
        return wall

    # 9.1: cosine on the first cos_n rows of phase 7's 1M x 512 data
    # (BASELINE config 4's; the whole 1M until phase 17 took its time),
    # sketch "auto".
    n = sizes["cos_n"]
    X, truth = embedding or make_embedding_data(n, 512)
    X, truth = X[:n], truth[:n]
    del embedding
    stamp("9.1: data made")
    cos = DBSCAN(eps=COS_EPS, min_samples=10, metric="cosine", block=block,
                 device=dev)
    wall, lc, _l1 = timed_fit(cos, X)
    m = cos.metrics_
    a = ari(cos.labels_, truth)
    log(f"  9.1 cosine n={n} d=512 eps={COS_EPS} (kernel eps "
        f"{cos.kernel_eps}) from host: {wall:.4f} s, launches "
        f"B3={lc['count_pairs_sketch']} B4={lc['minlab_pairs_sketch']}, "
        f"passes {m['kernel_passes']}, sketch_k {m['sketch_k']}, clusters "
        f"{int(cos.labels_.max()) + 1}, ARI vs truth {a:.6f}")
    if (lc["count_pairs_sketch"] != 1 or lc["minlab_pairs_sketch"] < 1
            or sum(lc.values()) != m["kernel_passes"]):
        fail("the cosine fit did not run B3 once and B4 per round")
    U = cos.data
    if not np.array_equal(U[:4096], _unit_rows(X[:4096])):
        fail("the cosine model's data is not _unit_rows(X)")
    euc = DBSCAN(eps=cos.kernel_eps, min_samples=10, block=block,
                 device=dev)
    e_wall, _lc, _l1 = timed_fit(euc, U)
    log(f"  Euclidean fit of _unit_rows(X) at kernel eps: {e_wall:.4f} s")
    same_fit(cos, euc, "cosine fit vs the Euclidean fit of its frame")
    rec["cosine"] = {"n": n, "eps": COS_EPS, "wall_s": wall,
                     "euclidean_wall_s": e_wall, "ari": a,
                     "clusters": int(cos.labels_.max()) + 1}
    # B3/B4 bitwise on unit-norm rows at 20,000 x 512 (k = 128).
    Xc, _t = make_embedding_data(sizes["check_n"], 512)
    inp = inputs(_unit_rows(Xc), cos.kernel_eps, k=128)
    a3 = (inp["xs"], inp["mi"], inp["rp"], inp["cols"], inp["slab"][0], 128,
          inp["e2"], inp["slab"][1], inp["tile"])
    counts, st = ck.count_pairs_sketch(*a3, "high", inp["centers"])
    pc, pst = ck.PLAIN["count_pairs_sketch"](*a3)
    err3 = max(held("count_pairs_sketch", counts, pc, "unit rows"),
               held("count_pairs_sketch stats", st, pst, "unit rows"))
    core, lab = core_labels(inp, counts, 10)
    b4 = (inp["xs"], lab) + a3[2:]
    err4 = held("minlab_pairs_sketch", ck.minlab_pairs_sketch(*b4),
                ck.PLAIN["minlab_pairs_sketch"](*b4), "unit rows")
    d, N = inp["xs"].shape
    gated = pair_work(inp, inp["mask"])
    src_pairs = pair_work(inp, core)
    nbytes = (d + inp["slab"][0].shape[0]) * N * 4 + N * 8
    ms3 = median_ms(lambda: ck.count_pairs_sketch(*a3, "high",
                                                  inp["centers"]), reps)
    p3 = median_ms(lambda: ck.PLAIN["count_pairs_sketch"](*a3), 1)
    # B3 at this run's work (b3_bounds' certified form, with the rescored
    # pairs the kernel counted); B4 at the gate over its source pairs.
    rc = torch.zeros(1, dtype=torch.int64, device=dev)
    ck.count_pairs_sketch(*a3, "high", inp["centers"], rescored_pairs=rc)
    _old, t3 = b3_bounds(gated, int(st[0]), int(rc[0]), 128, d)
    record("count_pairs_sketch", "pypardis_tpu_torch/csrc/sketch_kernels.cu",
           "pypardis_tpu/ops/pallas_kernels.py:341", lc["count_pairs_sketch"],
           err3, ms3, p3, *bound(t3, nbytes / PEAK_BYTES_PER_S),
           f"cosine unit rows n={sizes['check_n']} d=512 k=128",
           band_pairs=int(st[0]), rescored_pairs=int(rc[0]))
    ms4 = median_ms(lambda: ck.minlab_pairs_sketch(*b4), reps)
    p4 = median_ms(lambda: ck.PLAIN["minlab_pairs_sketch"](*b4), 1)
    record("minlab_pairs_sketch", "pypardis_tpu_torch/csrc/sketch_kernels.cu",
           "pypardis_tpu/ops/pallas_kernels.py:393",
           lc["minlab_pairs_sketch"], err4, ms4, p4,
           *bound(src_pairs * (3 * 129 + 3) / PEAK_FP32_FLOPS,
                  nbytes / PEAK_BYTES_PER_S),
           f"cosine unit rows n={sizes['check_n']} d=512 k=128")
    stamp("9.1: fits and B3/B4 held")
    # Served from a cosine model of the first cos_serve_n rows: the 512-D
    # index build is host work (≈ 36 s at 1M).
    ns = min(sizes["cos_serve_n"], n)
    if ns < n:
        cos = DBSCAN(eps=COS_EPS, min_samples=10, metric="cosine",
                     block=block, device=dev).fit(X[:ns])
    rec["cosine"]["serve_n"] = ns
    rec["cosine"]["serve_s"] = served(cos, X[:ns], "cosine", 21)
    stamp("9.1: served")
    del X, U, euc, cos, inp

    # 9.2: haversine on GeoLife-shaped stay points (BASELINE config 3,
    # cut from ~25M to 1M points).
    n = sizes["hav_n"]
    X, truth = geolife_like(n)
    hav = DBSCAN(eps=HAV_EPS, min_samples=10, metric="haversine",
                 block=block, device=dev)
    wall, lh, _l1 = timed_fit(hav, X)
    m = hav.metrics_
    a = ari(hav.labels_, truth)
    log(f"  9.2 haversine n={n} eps={HAV_EPS} rad (chord "
        f"{hav.kernel_eps}) from host: {wall:.4f} s, launches "
        f"B1={lh['count_pairs']} B2={lh['minlab_pairs']}, passes "
        f"{m['kernel_passes']}, live pairs {m['live_pairs']}, clusters "
        f"{int(hav.labels_.max()) + 1}, noise "
        f"{int((hav.labels_ < 0).sum())}, ARI vs truth {a:.6f}")
    if (lh["count_pairs"] != 1 or lh["minlab_pairs"] < 1
            or sum(lh.values()) != m["kernel_passes"]):
        fail("the haversine fit did not run B1 once and B2 per round")
    S = latlon_to_unit_sphere(X)
    euc = DBSCAN(eps=hav.kernel_eps, min_samples=10, block=block,
                 device=dev)
    e_wall, _lc, _l1 = timed_fit(euc, S)
    same_fit(hav, euc, "haversine fit vs the Euclidean fit of its frame")
    rec["haversine"] = {"n": n, "eps": HAV_EPS, "wall_s": wall,
                        "euclidean_wall_s": e_wall, "ari": a,
                        "clusters": int(hav.labels_.max()) + 1}
    # B1/B2 at d = 3 on the fit's own inputs.
    inp = inputs(S, hav.kernel_eps)
    a1 = (inp["xs"], inp["mi"], inp["rp"], inp["cols"], inp["e2"],
          inp["tile"])
    rc = torch.zeros(1, dtype=torch.int64, device=dev)
    counts = ck.count_pairs(*a1, inp["centers"], rescored_pairs=rc)
    err1 = held("count_pairs", counts, counts_over_pairs(*a1), "d=3")
    rescored = int(rc[0])
    pairs = pair_work(inp, inp["mask"])
    sub, rp_sub = sub_list(inp)
    a_sub = a1[:2] + (rp_sub,) + a1[3:]
    rc.zero_()
    ck.count_pairs(*a_sub, inp["centers"], rescored_pairs=rc)
    b1_rescored_hold(a_sub, inp["centers"], int(rc[0]),
                     f"the haversine inputs, first {sub} row tiles")
    core, lab = core_labels(inp, counts, 10)
    b2 = (inp["xs"], lab, inp["rp"], inp["cols"], inp["e2"], inp["tile"])
    err2 = held("minlab_pairs", ck.minlab_pairs(*b2), minlab_over_pairs(*b2),
                "d=3 round 1")
    d, N = inp["xs"].shape
    nbytes = d * N * 4 + N * 4 + inp["rp"].numel() * 4 + inp[
        "cols"].numel() * 4
    ms1 = median_ms(lambda: ck.count_pairs(*a1, inp["centers"]), reps)
    p1 = median_ms(lambda: counts_over_pairs(*a1), 1)
    record("count_pairs", "pypardis_tpu_torch/csrc/pair_kernels.cu",
           "pypardis_tpu/ops/pallas_kernels.py:202", lh["count_pairs"], err1,
           ms1, p1, *bound(b1_bounds(pairs, rescored, d, "high"),
                           (nbytes + N * 4) / PEAK_BYTES_PER_S),
           f"haversine n={n} d=3", rescored_pairs=rescored,
           rescored_share=rescored / max(pairs, 1))
    log(f"    B1 at d=3: {pairs} point pairs, {rescored} decided exactly "
        f"({rescored / max(pairs, 1):.6f})")
    ms2 = median_ms(lambda: ck.minlab_pairs(*b2), reps)
    p2 = median_ms(lambda: minlab_over_pairs(*b2), 1)
    record("minlab_pairs", "pypardis_tpu_torch/csrc/pair_kernels.cu",
           "pypardis_tpu/ops/pallas_kernels.py:264", lh["minlab_pairs"], err2,
           ms2, p2, *bound(pair_work(inp, core) * (3 * d + 1)
                           / PEAK_FP32_FLOPS,
                           (nbytes + N * 4) / PEAK_BYTES_PER_S),
           f"haversine n={n} d=3")
    rec["haversine"]["b1_rescored_share"] = rescored / max(pairs, 1)
    rec["haversine"]["serve_s"] = served(hav, X, "haversine", 22)
    stamp("9.2: done")
    del X, S, euc, hav, inp

    # 9.3: cityblock on the first l1_fit_n of the phase 4 blobs (9.4
    # sweeps all l1_n): the torch L1 pass on the card.
    X, truth = make_blob_data(sizes["l1_n"], 16, n_centers=32, std=0.4)
    n = sizes["l1_fit_n"]
    l1 = DBSCAN(eps=L1_EPS, min_samples=10, metric="cityblock", block=block,
                device=dev)
    wall, ll, lp = timed_fit(l1, X[:n])
    m = l1.metrics_
    a = ari(l1.labels_, truth[:n])
    log(f"  9.3 cityblock n={n} d=16 eps={L1_EPS} from host: {wall:.4f} s, "
        f"L1 passes {lp}, kernel launches {sum(ll.values())}, passes "
        f"{m['kernel_passes']}, live pairs {m['live_pairs']}, clusters "
        f"{int(l1.labels_.max()) + 1}, ARI vs truth {a:.6f}")
    if sum(lp.values()) != m["kernel_passes"] or sum(ll.values()):
        fail("the cityblock fit's L1 passes do not match its passes")
    if a < 0.99:
        fail(f"cityblock ARI {a} < 0.99")
    stamp("9.3: fitted")
    # Card against CPU on a subsample, at the least block (128): the
    # CPU's plain pass over 1024-wide tiles would take ~15 s at 20k.
    k = sizes["l1_sub_n"]
    same_fit(DBSCAN(eps=L1_EPS, min_samples=10, metric="cityblock",
                    block=128, device=dev).fit(X[:k]),
             DBSCAN(eps=L1_EPS, min_samples=10, metric="cityblock",
                    block=128, device="cpu").fit(X[:k]),
             f"cityblock n={k} block 128: card vs CPU")
    inp = inputs(X[:n], L1_EPS, metric="cityblock")
    a1 = (inp["xs"], inp["mi"], inp["rp"], inp["cols"], inp["e2"],
          inp["tile"])
    l1_ms = median_ms(cold(lambda: ck.count_pairs_l1(*a1)), 1)
    rec["cityblock"] = {"n": n, "eps": L1_EPS, "wall_s": wall, "ari": a,
                        "passes": m["kernel_passes"],
                        "l1_counts_pass_ms": l1_ms,
                        "live_pairs": m["live_pairs"]}
    log(f"    one L1 counts pass on the card: {l1_ms:.3f} ms over "
        f"{int(inp['rp'][-1])} live tile pairs")

    stamp("9.3: done")
    # 9.4: the sweep on the same blobs, from a CUDA tensor.
    Xd = torch.from_numpy(X).to(dev)
    eps_list = [round(SWEEP_EPS_MAX * (i + 1) / 8, 6) for i in range(8)]
    ms_list = [5, 10]
    ck.reset_launch_counts()
    sync()
    t = time.perf_counter()
    sw = DBSCAN(eps=SWEEP_EPS_MAX, min_samples=10, block=block, device=dev)
    res = sw.sweep(Xd, eps_list, ms_list)
    sync()
    s_wall = time.perf_counter() - t
    st = res.stats
    log(f"  9.4 sweep n={n}: {len(res)} configs in {s_wall:.4f} s, "
        f"distance_passes {st['distance_passes']}, graph_pairs "
        f"{st['graph_pairs']}, graph_bytes {st['graph_bytes']}, build "
        f"{st['graph_build_s']} s, relabel {st['relabel_s']}, "
        f"amortization {st['sweep_amortization_est']}")
    if st["distance_passes"] != 1 or st["degraded"] is not None:
        fail("the sweep did not run one distance pass")
    want = sizes.get("sweep_edges")
    if want is not None and st["graph_pairs"] != want:
        fail(f"the sweep graph holds {st['graph_pairs']} edges, not the "
             f"{want} measured for eps_max {SWEEP_EPS_MAX}")
    fit_s = 0.0
    fits = {}
    for cfg in res.configs:
        fit = DBSCAN(eps=cfg[0], min_samples=cfg[1], block=block,
                     device=dev)
        f_wall, _lc, _l1 = timed_fit(fit, Xd)
        fit_s += f_wall
        fits[cfg] = (fit.labels_, fit.core_sample_mask_)
        if not (np.array_equal(res.labels(*cfg), fit.labels_)
                and np.array_equal(res.core(*cfg), fit.core_sample_mask_)):
            fail(f"sweep config {cfg} differs from its fit")
    stamp("9.4: sweep and its fits")
    log(f"    every config byte-identical to its fit from the tensor; the "
        f"{len(res)} fits took {fit_s:.4f} s against the sweep's "
        f"{s_wall:.4f} s")
    # Emission and per-config relabel on CUDA events.
    pts, nn, blk = _stage(Xd, block, dev)
    built = []
    emit_ms = median_ms(cold(lambda: built.append(sweep_graph_pipeline(
        pts, SWEEP_EPS_MAX, nn, block=blk, sort=nn > 2 * blk))), 1)
    graph, mask_k, owner, cap, gst = built[0]
    ev = gst[0]
    gi, gj, dv = graph[0][:ev].long(), graph[1][:ev].long(), graph[2][:ev]
    relabel_ms = [median_ms(lambda c=cfg: sweep_config_pack(
        gi, gj, dv, mask_k, owner, c[0], c[1], gst, cap=cap), 1)
        for cfg in res.configs]
    log(f"    emission (layout + graph) {emit_ms:.3f} ms on CUDA events, "
        f"relabel per config {[round(v, 3) for v in relabel_ms]} ms")
    del gi, gj, dv, graph, pts
    # Past the cap: per-config fits, the same labels.
    cfgs2 = [(SWEEP_EPS_MAX, 10), (SWEEP_PAST_CAP, 10)]
    res2 = DBSCAN(eps=SWEEP_PAST_CAP, min_samples=10, block=block,
                  device=dev).sweep(
        Xd, [c[0] for c in cfgs2], [10])
    ok = res2.stats["degraded"] == "per_config_refit"
    ref = DBSCAN(eps=SWEEP_PAST_CAP, min_samples=10, block=block,
                 device=dev).fit(Xd)
    ok = ok and np.array_equal(res2.labels(SWEEP_PAST_CAP, 10), ref.labels_)
    ok = ok and np.array_equal(res2.labels(SWEEP_EPS_MAX, 10),
                               fits[(SWEEP_EPS_MAX, 10)][0])
    log(f"  sweep past the cap (eps_max {SWEEP_PAST_CAP}): degraded "
        f"{res2.stats['degraded']!r}, distance_passes "
        f"{res2.stats['distance_passes']}, labels equal to the fits: {ok}")
    if not ok:
        fail("the degraded sweep differs from its fits")
    stamp("9.4: done")
    rec["sweep"] = {"n": n, "configs": len(res), "wall_s": s_wall,
                    "fits_s": fit_s, "graph_pairs": st["graph_pairs"],
                    "graph_bytes": st["graph_bytes"],
                    "emission_ms": emit_ms, "relabel_ms": relabel_ms,
                    "eps_max": SWEEP_EPS_MAX}
    return kernels, rec


# Phase 10: the density hierarchy.  Sizes of the phase; a test rehearses
# it at small ones on the CPU.  ``small_n``: the default ceiling's size
# (the largest of 20,000 / 50,000 / 100,000 whose graph stays under the
# cap; past it the fit raises and the phase fails); ``hav_eps_max_m``:
# the haversine fit's ceiling in metres (the default's sample-kNN
# heuristic reads ~12 km on GeoLife-shaped points, a graph past the cap
# at 20,000 points); ``twin_*``: the interior cut's data, ceiling and
# min_cluster_size (32,217,390 edges at 1M points; twins merge between
# about 0.2009 and the ceiling, so each blob is selected).
HIER_SIZES = {"n": 1_000_000, "auto_n": 200_000, "small_n": 20_000,
              "block": 2048, "small_block": 256, "eps_max": SWEEP_EPS_MAX,
              "edges": SWEEP_EDGES, "queries": 4096, "hav_eps_max_m": 800.0,
              "twin_n": 1_000_000, "twin_std": 1.0, "twin_eps_max": 0.22,
              "twin_mcs": 1000}


def twin_blobs(n, std=1.0, pairs=16, offset=5.0, spread=40.0, seed=0):
    """(n, 3) float32 points: ``pairs`` pairs of Gaussian blobs of
    ``std``, the two of a pair ``offset`` stds apart, pair centres
    uniform in a ``spread`` box at least 12 stds apart.  Twins merge
    through their saddle well below the distance between pairs, so the
    hierarchy has splits under a ceiling just above that merge.
    Returns (X, truth), truth the blob of each point."""
    rng = np.random.default_rng(seed)
    cs = []
    while len(cs) < pairs:
        c = rng.uniform(-spread, spread, 3)
        if all(np.linalg.norm(c - o) >= 12 * std for o in cs):
            cs.append(c)
    cs = np.asarray(cs)
    u = rng.normal(size=(pairs, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    centres = np.concatenate([cs - 0.5 * offset * std * u,
                              cs + 0.5 * offset * std * u])
    truth = rng.integers(0, 2 * pairs, n)
    X = (centres[truth] + rng.normal(size=(n, 3)) * std).astype(np.float32)
    return X, truth


def hier_phase(torch, dev, sync, card="", sizes=HIER_SIZES):
    """Phase 10 (the density hierarchy, ``DBSCAN(eps=None)``): (1) one
    eps=None fit of phase 4's 1M x 16-D blobs from a CUDA tensor at the
    sweep's ceiling (``PPTORCH_HIER_EPS_MAX`` = :data:`SWEEP_EPS_MAX`,
    phase 9.4's :data:`SWEEP_EDGES` edges) with its stage seconds,
    byte-identical to ``fit(eps_)`` from the same tensor (B1/B2
    launched), the card's core distances bitwise the host's core pass
    over a host copy of the prepared slab; (2) ``sweep(eps_list="auto",
    min_samples_list=[5, 10])`` on the first 200,000 rows at that
    ceiling, every rung byte-identical to a fit at it; (3) the default
    ceiling twice at ``small_n`` points (byte-identical), the card
    against ``precision="default"`` (byte-identical), then a haversine eps=None fit on
    :func:`geolife_like` points of that size, served once (B5); (4) an
    interior cut on :func:`twin_blobs`: ``eps_`` below the ceiling,
    byte-identical to ``fit(eps_)``, and ``fit(eps_)`` at
    ``precision="default"`` held against it (differences counted).
    Returns the phase's record."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops import hierarchy as H

    block, rec = sizes["block"], {}
    t_phase = time.perf_counter()

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def same_fit(a, b, what):
        ok = (np.array_equal(a.labels_, b.labels_)
              and np.array_equal(a.core_sample_mask_, b.core_sample_mask_))
        log(f"  {what}: labels and core mask byte-identical: {ok}")
        if not ok:
            fail(f"{what}: the fits differ")

    def kernel_fit(model, X, what):
        """A fit with B1/B2 counted from 0 (in the model's precision
        mode): both launched, summing to its passes."""
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model.fit(X)
        sync()
        wall = time.perf_counter() - t
        la = dict(ck.LAUNCHES)
        if not (sum(v for k, v in la.items() if k.startswith("count_"))
                and sum(v for k, v in la.items() if k.startswith("minlab_"))):
            fail(f"{what}: B1/B2 were not launched")
        if sum(la.values()) != model.metrics_["kernel_passes"]:
            fail(f"{what}: kernel launches do not sum to the passes")
        return wall, la

    def stages(h):
        return (f"graph {h['graph_build_s']} s ({h['graph_pairs']} edges), "
                f"prepare {h['prepare_s']} s, core pass {h['core_pass_s']} "
                f"s, MST {h['mst_s']} s ({h['boruvka_rounds']} rounds, cap "
                f"{h['round_cap']}; {h['mst_edges']} edges), condense "
                f"{h['condense_s']} s ({h['condensed_clusters']} condensed, "
                f"{h['selected_clusters']} selected), cut {h['cut_s']} s, "
                f"relabel {h['relabel_s']} s")

    # 10.1: the 1M eps=None fit at the sweep's ceiling.  The hierarchy's
    # inputs are captured as the fit builds it.
    n = sizes["n"]
    X, truth = make_blob_data(n, 16, n_centers=32, std=0.4)
    Xd = torch.from_numpy(X).to(dev)
    seen = []
    build = H.build_hierarchy

    def capture(state, mask, n_ids, ms, **kw):
        h = build(state, mask, n_ids, ms, **kw)
        seen.append((state, mask, ms, h.cd2))
        return h

    os.environ["PPTORCH_HIER_EPS_MAX"] = repr(sizes["eps_max"])
    H.build_hierarchy = capture
    try:
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model = DBSCAN(eps=None, min_samples=10, block=block, device=dev)
        model.fit(Xd)
        sync()
        wall = time.perf_counter() - t
        la = dict(ck.LAUNCHES)
    finally:
        H.build_hierarchy = build
        del os.environ["PPTORCH_HIER_EPS_MAX"]
    h = model._hier_stats
    a = ari(model.labels_, truth)
    clusters = int(model.labels_.max()) + 1
    log(f"  10.1 eps=None n={n} d=16 from a CUDA tensor, eps_max "
        f"{h['eps_max']}: {wall:.4f} s on {card}; eps_ {model.eps_!r}, "
        f"{clusters} clusters, ARI vs truth {a:.6f}; kernel launches "
        f"{sum(la.values())}")
    log(f"    stages: {stages(h)}")
    want = sizes.get("edges")
    if want is not None and h["graph_pairs"] != want:
        fail(f"the hierarchy's graph holds {h['graph_pairs']} edges, not "
             f"the {want} of phase 9.4's graph at {sizes['eps_max']}")
    ref = DBSCAN(eps=model.eps_, min_samples=10, block=block, device=dev)
    f_wall, fla = kernel_fit(ref, Xd, "fit(eps_)")
    same_fit(model, ref, f"eps=None against fit(eps_) ({f_wall:.4f} s, "
             f"B1 {fla['count_pairs']}, B2 {fla['minlab_pairs']})")
    state, mask, ms, cd2 = seen[0]
    t = time.perf_counter()
    host = H.core_distances(tuple(x.cpu() for x in state), mask.cpu(), ms)
    ok = bool(torch.equal(cd2.cpu().view(torch.int32),
                          host.view(torch.int32)))
    log(f"    the card's core distances bitwise the host core pass over a "
        f"host copy of the prepared slab ({time.perf_counter() - t:.1f} "
        f"s): {ok}")
    if not ok:
        fail("the card's core distances differ from the host's")
    sync()
    t = time.perf_counter()
    twin = H.core_distances_device(state[0], state[1], state[2], mask, ms)
    sync()
    twin_s = time.perf_counter() - t
    ok = bool(torch.equal(twin.cpu().view(torch.int32),
                          host.view(torch.int32)))
    log(f"    the one-shot twin on the card ({twin_s:.4f} s) bitwise the "
        f"host core pass: {ok}")
    if not ok:
        fail("the card's one-shot core twin differs from the host's")
    rec["fit"] = dict(
        {k: h[k] for k in ("graph_pairs", "graph_build_s", "prepare_s",
                           "core_pass_s", "mst_s", "boruvka_rounds",
                           "round_cap", "mst_edges", "condense_s",
                           "condensed_clusters", "selected_clusters",
                           "cut_s", "relabel_s", "eps_max")},
        n=n, wall_s=wall, eps_=model.eps_, n_clusters=clusters, ari=a,
        fit_eps_s=f_wall)
    del seen, state, mask, cd2, host, twin, model, ref
    stamp("10.1: done")

    # 10.2: the auto ladder at 200,000 rows of the same data and ceiling.
    n2 = sizes["auto_n"]
    X2d = Xd[:n2].contiguous()
    os.environ["PPTORCH_HIER_EPS_MAX"] = repr(sizes["eps_max"])
    try:
        sync()
        t = time.perf_counter()
        res = DBSCAN(eps=None, min_samples=10, block=block,
                     device=dev).sweep(X2d, "auto", [5, 10])
        sync()
        s_wall = time.perf_counter() - t
    finally:
        del os.environ["PPTORCH_HIER_EPS_MAX"]
    st = res.stats
    log(f"  10.2 sweep(eps_list='auto', min_samples_list=[5, 10]) n={n2}: "
        f"{len(res)} rungs in {s_wall:.4f} s on {card}; ladder "
        f"{st['ladder']}; graph {st['graph_pairs']} edges, build "
        f"{st['graph_build_s']} s; relabel per rung {st['relabel_s']}")
    log(f"    first hierarchy's stages: {stages(st['hierarchy'])}")
    fit_s = 0.0
    for eps, ms in res.configs:
        f = DBSCAN(eps=eps, min_samples=ms, block=block, device=dev)
        f_wall, _la = kernel_fit(f, X2d, f"rung ({eps}, {ms})")
        fit_s += f_wall
        if not (np.array_equal(res.labels(eps, ms), f.labels_)
                and np.array_equal(res.core(eps, ms), f.core_sample_mask_)):
            fail(f"auto rung ({eps}, {ms}) differs from its fit")
    log(f"    every rung byte-identical to its fit from the tensor; the "
        f"{len(res)} fits took {fit_s:.4f} s")
    rec["auto"] = {"n": n2, "rungs": len(res), "wall_s": s_wall,
                   "fits_s": fit_s, "ladder": st["ladder"],
                   "graph_pairs": st["graph_pairs"]}
    del X2d, res, Xd
    stamp("10.2: done")

    # 10.3: the default ceiling at the largest size whose graph fits.
    n3 = sizes["small_n"]
    Xs = X[:n3]
    sb = sizes["small_block"]
    runs = []
    for _ in range(2):
        sync()
        t = time.perf_counter()
        m = DBSCAN(eps=None, min_samples=10, block=sb, device=dev).fit(Xs)
        sync()
        runs.append((m, time.perf_counter() - t))
    same_fit(runs[0][0], runs[1][0], f"default ceiling n={n3}, two fits")
    # (The same fit with device="cpu" is tests/test_torch_card.py::
    # test_eps_none_fit_on_card_equals_the_cpu_and_its_fit, at this n.)
    lossy = DBSCAN(eps=None, min_samples=10, block=sb, precision="default",
                   device=dev).fit(Xs)
    same_fit(runs[0][0], lossy, f"default ceiling n={n3}, \"high\" vs "
             f"\"default\"")
    card_fit = runs[0][0]
    if not card_fit.eps_ == runs[1][0].eps_ == lossy.eps_:
        fail("the default-ceiling fits selected different eps_")
    hs = card_fit._hier_stats
    log(f"    eps_ {card_fit.eps_!r}, {int(card_fit.labels_.max()) + 1} "
        f"clusters; card {runs[0][1]:.4f} / {runs[1][1]:.4f} s; card "
        f"stages: {stages(hs)}")
    rec["default"] = {"n": n3, "eps_": card_fit.eps_, "card_s": runs[0][1],
                      "graph_pairs": hs["graph_pairs"],
                      "eps_max": hs["eps_max"]}
    del runs, card_fit, lossy
    G, gtruth = geolife_like(n3)
    hav_max = sizes["hav_eps_max_m"] / 6_371_000.0
    os.environ["PPTORCH_HIER_EPS_MAX"] = repr(hav_max)
    try:
        hav = DBSCAN(eps=None, min_samples=10, metric="haversine", block=sb,
                     device=dev).fit(G)
    finally:
        del os.environ["PPTORCH_HIER_EPS_MAX"]
    ref = DBSCAN(eps=hav.eps_, min_samples=10, metric="haversine",
                 block=sb, device=dev)
    kernel_fit(ref, G, "haversine fit(eps_)")
    same_fit(hav, ref, f"haversine eps=None n={n3} against fit(eps_)")
    rng = np.random.default_rng(5)
    nq = sizes["queries"]
    picks = np.flatnonzero(hav.core_sample_mask_)
    picks = picks[rng.integers(0, len(picks), nq - nq // 2)]
    Q = np.concatenate([
        G[rng.integers(0, len(G), nq // 2)]
        + rng.normal(scale=HAV_EPS / 2, size=(nq // 2, 2)),
        G[picks]])
    ck.reset_launch_counts()
    sync()
    t = time.perf_counter()
    lab = hav.predict(Q)
    sync()
    serve_s = time.perf_counter() - t
    b5 = ck.LAUNCHES["query_leaf"]
    kept = np.array_equal(lab[nq // 2:], hav.labels_[picks])
    log(f"    haversine eps=None (ceiling {sizes['hav_eps_max_m']} m): "
        f"eps_ {hav.eps_ * 6_371_000.0:.3f} m, "
        f"{int(hav.labels_.max()) + 1} clusters, ARI vs truth "
        f"{ari(hav.labels_, gtruth):.6f}; served {nq} queries in "
        f"{serve_s:.4f} s with {b5} B5 launches; exact core points predict "
        f"their own label: {kept}")
    if b5 < 1:
        fail("serving the eps=None model launched no B5")
    if not kept:
        fail("a core point of the eps=None model predicted another label")
    rec["haversine"] = {"n": n3, "eps_m": hav.eps_ * 6_371_000.0,
                        "serve_s": serve_s, "b5_launches": b5}
    del hav, ref, G
    stamp("10.3: done")

    # 10.4: an interior cut at scale.
    n4, top = sizes["twin_n"], sizes["twin_eps_max"]
    T, ttruth = twin_blobs(n4, sizes["twin_std"])
    Td = torch.from_numpy(T).to(dev)
    os.environ["PPTORCH_HIER_EPS_MAX"] = repr(top)
    try:
        sync()
        t = time.perf_counter()
        tw = DBSCAN(eps=None, min_samples=10,
                    min_cluster_size=sizes["twin_mcs"], block=block,
                    device=dev).fit(Td)
        sync()
        wall = time.perf_counter() - t
    finally:
        del os.environ["PPTORCH_HIER_EPS_MAX"]
    h = tw._hier_stats
    clusters = int(tw.labels_.max()) + 1
    log(f"  10.4 eps=None n={n4} d=3 twin blobs, min_cluster_size "
        f"{sizes['twin_mcs']}, eps_max {h['eps_max']}: {wall:.4f} s on "
        f"{card}; eps_ {tw.eps_!r}, {clusters} clusters, noise share "
        f"{float(np.mean(tw.labels_ < 0)):.6f}, ARI vs the blobs "
        f"{ari(tw.labels_, ttruth):.6f}")
    log(f"    stages: {stages(h)}")
    if not tw.eps_ < h["eps_max"]:
        fail(f"the twin blobs' cut fell back to the ceiling ({tw.eps_!r} "
             f"against {h['eps_max']!r})")
    ref = DBSCAN(eps=tw.eps_, min_samples=10, block=block, device=dev)
    f_wall, fla = kernel_fit(ref, Td, "twin fit(eps_)")
    same_fit(tw, ref, f"twin eps=None against fit(eps_) ({f_wall:.4f} s, "
             f"B1 {fla['count_pairs']}, B2 {fla['minlab_pairs']})")
    lossy = DBSCAN(eps=tw.eps_, min_samples=10, block=block,
                   precision="default", device=dev)
    kernel_fit(lossy, Td, "twin fit(eps_) at \"default\"")
    diff_lab = int(np.sum(lossy.labels_ != tw.labels_))
    diff_core = int(np.sum(lossy.core_sample_mask_ != tw.core_sample_mask_))
    ari_lossy = ari(lossy.labels_, tw.labels_)
    log(f"    fit(eps_) at precision=\"default\" (bf16 verdicts) against "
        f"the eps=None fit: {diff_lab} labels and {diff_core} core flags "
        f"differ, ARI {ari_lossy:.6f} (not gated)")
    rec["interior"] = dict(
        {k: h[k] for k in ("graph_pairs", "graph_build_s", "prepare_s",
                           "core_pass_s", "mst_s", "boruvka_rounds",
                           "condense_s", "selected_clusters", "cut_s",
                           "relabel_s", "eps_max")},
        n=n4, wall_s=wall, eps_=tw.eps_, n_clusters=clusters,
        default_labels_differ=diff_lab, default_core_differ=diff_core,
        default_ari=ari_lossy)
    del tw, ref, lossy, Td, T
    stamp("10.4: done")
    rec["card"] = card
    return rec


def host_tables(idx):
    """B5's tables from the index's host mirrors: their plain versions
    on the CPU."""
    import torch

    from pypardis_tpu_torch.ops.query import (
        query_block_frames, query_leaf_ends, query_pad_keys,
    )

    C = idx.leaf_cap
    hc, hl = torch.from_numpy(idx.coords), torch.from_numpy(idx.labels)
    return (query_pad_keys(hc, hl, C), query_leaf_ends(hc, hl, C),
            *query_block_frames(hc, hl, idx.block))


def words_off(torch, got, want):
    """Differing 32-bit words between two sequences of tensors, counted
    on ``got``'s device."""
    return sum(int((g.view(torch.int32)
                    != w.to(g.device).view(torch.int32)).sum())
               for g, w in zip(got, want))


def words_where(torch, got, want, names, cap=4):
    """Per tensor of ``got`` that differs from ``want``: its name, its
    differing 32-bit words and the first ``cap`` of them as ``(flat
    word, got, want)`` -- a failure's report."""
    out = []
    for name, g, w in zip(names, got, want):
        gi = g.reshape(-1).view(torch.int32)
        wi = w.to(g.device).reshape(-1).view(torch.int32)
        at = torch.nonzero(gi != wi).reshape(-1)
        if len(at):
            first = at[:cap].tolist()
            out.append(f"{name}: {len(at)} words, first "
                       + ", ".join(f"[{j}] {int(gi[j])} != {int(wi[j])}"
                                   for j in first))
    return "; ".join(out)


TABLE_NAMES = ("pad_keys", "leaf_end", "ctr", "slots")
# Times each hold runs (``--hold-reps``).
HOLD_REPS = 1


def hold_index(torch, ck, idx, dev, what, full=False):
    """The index's device tensors against its host mirrors and B5's
    tables against a fresh ``query_tables``, bitwise; with ``full`` also
    the tables against their plain versions on ``dev`` and, on the card,
    the host's (:func:`host_tables`).  Fails the run on a difference,
    naming each comparison, table and first differing words.  Runs
    :data:`HOLD_REPS` times."""
    for _ in range(HOLD_REPS):
        _hold_once(torch, ck, idx, dev, what, full)


def _hold_once(torch, ck, idx, dev, what, full):
    from pypardis_tpu_torch.ops.query import (
        query_block_frames, query_leaf_ends, query_pad_keys,
    )

    dev_t = idx.device_tensors()
    bad = words_where(torch, dev_t, [torch.from_numpy(a) for a in (
        idx.coords, idx.labels, idx.blo, idx.bhi)],
        ("coords", "labels", "blo", "bhi"))
    if bad:
        fail(f"after {what} the index's device tensors differ from "
             f"its host mirrors ({bad})")
    got, C = idx.kernel_tables(), idx.leaf_cap
    wants = [("a fresh query_tables", lambda: ck.query_tables(
        dev_t[0], dev_t[1], block=idx.block, nb=idx.nb))]
    if full:
        wants.append((f"the plain versions on {dev.type}", lambda: (
            query_pad_keys(dev_t[0], dev_t[1], C),
            query_leaf_ends(dev_t[0], dev_t[1], C),
            *query_block_frames(dev_t[0], dev_t[1], idx.block))))
    if full and dev.type == "cuda":
        wants.append(("the plain versions on the host",
                      lambda: host_tables(idx)))
    bad = []
    for name, want in wants:
        off = words_where(torch, got, want(), TABLE_NAMES)
        if off:
            # Computed once more, to tell a lasting difference from a
            # passing one in the report; either fails the run.
            again = words_where(torch, got, want(), TABLE_NAMES)
            bad.append(f"against {name}: {off} (computed again: "
                       f"{again or 'equal'})")
    if bad:
        fail(f"after {what} B5's tables differ ({' | '.join(bad)})")


def index_oracle(torch, idx, Q):
    """:func:`card_oracle` over the index's live cores (its device
    slab's non-pad columns) for raw-frame queries ``Q``."""
    coords, labels, _lo, _hi = idx.device_tensors()
    sel = torch.from_numpy(idx.labels != INT32_MAX).to(coords.device)
    return card_oracle(torch, idx.prepare_queries(Q), coords[:, sel],
                       labels[sel], idx.eps2)


def refit_trace(torch, dev, live, block, trace_cap):
    """A fresh fit of the live points against the live clustering:
    ``(points, ARI, core flags that differ, of them traced to a pair
    whose float32 d^2 lies within exact_slack of eps^2)``."""
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.ops.distances import eps2_f32

    P = live.points()
    fresh = DBSCAN(eps=live.eps, min_samples=live.min_samples, block=block,
                   device=dev).fit(P)
    a = ari(fresh.labels_, live.labels())
    diff = np.flatnonzero(fresh.core_sample_mask_ != live.core_mask())
    e2 = float(eps2_f32(live.eps))
    Pc = torch.from_numpy((P - P.mean(axis=0)).astype(np.float32)).to(dev)
    norms = torch.sqrt((Pc * Pc).sum(dim=1))
    traced = 0
    for p in diff[:trace_cap]:
        acc = torch.zeros(len(Pc), dtype=torch.float32, device=dev)
        for ax in range(Pc.shape[1]):
            dd = Pc[:, ax] - Pc[p, ax]
            acc = acc + dd * dd
        slack = (2.0 ** -16) * (norms + norms[p]) ** 2
        traced += int(bool(((acc - e2).abs() <= slack).any()))
    return len(P), a, len(diff), traced


# Phase 11: live updates and ingest.  Sizes of the phase; a test
# rehearses it at small ones on the CPU.
LIVE_SIZES = {"n": 1_000_000, "d": 16, "centers": 32, "std": 0.4,
              "eps": 2.4, "min_samples": 10, "block": 2048,
              "singles": 64, "batches": 4, "batch_rows": 1024,
              "blob_rows": 4096, "clump": 12, "deletes": 64,
              "queue_rows": 4096, "queue_batch": 1024, "replay_rows": 64,
              "replay_deletes": 16, "queries": 4096, "inserted_q": 1024,
              "trace_cap": 64, "seed": 11}


@contextlib.contextmanager
def _live_instruments(torch, dev):
    """Phase 11's clocks on the live path: the spans of its verdicts
    (float64 counts), re-clusters, border attaches and B5 table builds,
    and every fit's passes and B1/B2 launches; restored on exit.  A span
    is a pair of CUDA events on the current stream on the card (host
    clocks on the CPU), so the clocks add no sync to the path they
    time; :func:`settle` reads them after the update's closing sync.
    Yields ``(split, fits, spans)``."""
    import pypardis_tpu_torch.dbscan as dbscan_mod
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.serve import live as live_mod

    split = dict.fromkeys(("verdicts", "recluster", "attach", "commit",
                           "tables"), 0.0)
    fits, spans = [], []
    patched = [(live_mod, "count_within_eps", "verdicts"),
               (live_mod, "count_reaches", "verdicts"),
               (live_mod, "core_components", "recluster"),
               (live_mod, "attach_to_cores", "attach"),
               (ck, "query_tables", "tables"),
               (dbscan_mod, "_pad_and_run", None)]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _k in patched]

    def timed(key, fn):
        def run(*a, **kw):
            t = _live_mark(torch, dev)
            out = fn(*a, **kw)
            spans.append((key, t, _live_mark(torch, dev)))
            return out
        return run

    def counted_fit(*a, _f=dbscan_mod._pad_and_run, **kw):
        before = dict(ck.LAUNCHES)
        out = _f(*a, **kw)
        fits.append((out[2]["kernel_passes"],
                     {k: ck.LAUNCHES[k] - before[k] for k in ck.LAUNCHES}))
        return out

    for (mod, name, key), (_m, _n, fn) in zip(patched, saved):
        setattr(mod, name, counted_fit if key is None else timed(key, fn))
    try:
        yield split, fits, spans
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _live_mark(torch, dev):
    """A point on the live path's clock: a CUDA event recorded on the
    current stream on the card, the host clock elsewhere."""
    if dev.type != "cuda":
        return time.perf_counter()
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def settle(spans, split):
    """Add each span's seconds to ``split`` under its stage and empty
    ``spans``; on the card after a sync, so every event has completed."""
    for key, a, b in spans:
        split[key] += (b - a if isinstance(a, float)
                       else a.elapsed_time(b) / 1e3)
    spans.clear()


def live_phase(torch, dev, sync, card="", sizes=LIVE_SIZES, model=None,
               X=None, truth=None):
    """Phase 11 (live updates and ingest) on ``model``, a host-input fit
    of ``make_blob_data(n, d, n_centers, std)`` (fitted here when None),
    with a seeded write stream: single inserts and ``insert_batch``es
    from the blob law, a batch from one blob, a clump 20 eps past every
    centre, a noise batch, a pour into the index leaf with the fewest
    free slots until it overflows (an appended slab), ``delete_batch``es
    of the noise ids and of core ids of the largest cluster, an
    ``IngestQueue`` of single submits, a ``Compactor`` cycle with writes
    injected during its refit, and a save/load on ``dev``.

    Gates: (1) after every commit the index's device tensors equal its
    host mirrors, and B5's tables a fresh ``query_tables``, bitwise
    (after each group also their plain versions on ``dev`` and the
    host's, :func:`host_tables`); (2) after each group ``predict`` of ``queries`` rows (the
    group's last inserted points, then blob-law points) is bitwise
    ``card_oracle`` over the mutated cores, and once B5 is bitwise its
    plain version on the slab; (3) the float64 counts and the border
    attach of one update's pool: ``dev`` = CPU; (4) against a fresh fit
    of the final points: ARI 1.0, every differing core flag traced to a
    pair whose float32 d^2 lies within ``exact_slack`` of eps^2; (5)
    each ``insert_batch`` and each queue batch costs one re-cluster
    dispatch, one index delta and one fit whose B1/B2 launches are its
    passes; (6) tickets submitted before the compaction's swap answer
    against the old generation, after it against the new one, none
    dropped, and the replayed writes are in the new generation.  Prints
    per update kind its p50 ms, its p99 (its largest where fewer than
    100 updates) and its seconds by stage, the launches, the
    compaction's phases.  Returns the phase's record."""
    import tempfile

    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops import incremental as inc
    from pypardis_tpu_torch.ops.query import query_min_core_plain
    from pypardis_tpu_torch.partition import route_tree
    from pypardis_tpu_torch.serve import Compactor, IngestQueue, LiveModel

    eps, ms, d = sizes["eps"], sizes["min_samples"], sizes["d"]
    nq = sizes["queries"]
    t_phase = time.perf_counter()

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    if model is None:
        X, truth = make_blob_data(sizes["n"], d, n_centers=sizes["centers"],
                                  std=sizes["std"])
        model = DBSCAN(eps=eps, min_samples=ms, block=sizes["block"],
                       device=dev).fit(X)
    centres = np.stack([X[truth == c].mean(axis=0)
                        for c in range(int(truth.max()) + 1)])
    rng = np.random.default_rng(sizes["seed"])

    def blob_law(m, c=None):
        cc = rng.integers(0, len(centres), m) if c is None else np.full(m, c)
        return centres[cc] + rng.normal(scale=sizes["std"], size=(m, d))

    rec = {"card": card}
    t = time.perf_counter()
    live = model.live()
    sync()
    idx = live.index
    stamp(f"11: LiveModel over {live.stats['points']} points "
          f"({live.stats['cores']} cores, {live.n_leaves} routing leaves; "
          f"index {idx.n_leaves} leaves of {idx.leaf_cap} slots) in "
          f"{time.perf_counter() - t:.2f} s, its warm-up "
          f"{live.stats['warm_compile_ms']:.1f} ms")
    rec["build_s"] = time.perf_counter() - t
    gate = {"s": 0.0, "launches": dict.fromkeys(ck.LAUNCHES, 0)}
    per_kind, deltas = {}, []
    commit = idx.commit_update

    with _live_instruments(torch, dev) as (split, fits, spans):
        ck.reset_launch_counts()

        def gated(fn):
            """Run gate code with its seconds and launches (and the
            stages it calls) kept out of the main path's."""
            before, n_spans = dict(ck.LAUNCHES), len(spans)
            t0 = time.perf_counter()
            out = fn()
            sync()
            gate["s"] += time.perf_counter() - t0
            del spans[n_spans:]
            for k in ck.LAUNCHES:
                gate["launches"][k] += ck.LAUNCHES[k] - before[k]
            return out

        def held(what, full=False):
            """Gate 1 (:func:`hold_index`)."""
            hold_index(torch, ck, idx, dev, what, full)

        def checked_commit():
            t0 = _live_mark(torch, dev)
            before = ck.LAUNCHES["query_tables"]
            out = commit()
            spans.append(("commit", t0, _live_mark(torch, dev)))
            deltas.append(out)
            if dev.type == "cuda" and ck.LAUNCHES["query_tables"] != \
                    before + 1:
                fail("a commit did not rebuild B5's tables once")
            gated(lambda: held("a commit"))
            return out

        idx.commit_update = checked_commit

        def update(kind, fn):
            """One update: its wall (host clock, synced at its start and
            end, without the gates), its stages' seconds (their event
            spans, read after the closing sync) and delta bytes."""
            s0, g0, n_d = dict(split), gate["s"], len(deltas)
            sync()
            spans.clear()
            t0 = time.perf_counter()
            out = fn()
            sync()
            wall = time.perf_counter() - t0 - (gate["s"] - g0)
            settle(spans, split)
            per_kind.setdefault(kind, []).append(
                (wall, {k: split[k] - s0[k] for k in split},
                 sum(deltas[n_d:])))
            return out

        def one_dispatch(kind, fn, n=1):
            """Gate 5: ``n`` batches, each one re-cluster dispatch, one
            index delta and one fit whose B1/B2 launches are its
            passes."""
            d0, e0, f0 = (live.stats["recluster_dispatches"], idx.epoch,
                          len(fits))
            b0 = dict(ck.LAUNCHES)
            out = update(kind, fn)
            got = (live.stats["recluster_dispatches"] - d0, idx.epoch - e0,
                   len(fits) - f0)
            mine = fits[f0:]
            b1 = sum(f["count_pairs"] for _p, f in mine)
            b2 = sum(f["minlab_pairs"] for _p, f in mine)
            ok = (got == (n, n, n)
                  and all(f["count_pairs"] >= 1 and f["minlab_pairs"] >= 1
                          and f["count_pairs"] + f["minlab_pairs"] == p
                          for p, f in mine)
                  and ck.LAUNCHES["count_pairs"] - b0["count_pairs"] == b1
                  and ck.LAUNCHES["minlab_pairs"] - b0["minlab_pairs"]
                  == b2)
            log(f"    {kind}: re-cluster dispatches, index deltas, fits "
                f"{got}; their B1 {b1} + B2 {b2} launches against "
                f"{sum(p for p, _f in mine)} passes")
            if not ok:
                fail(f"{kind} did not cost one re-cluster dispatch, one "
                     f"index delta and one fit's launches per batch")
            return out

        def oracle_of(Q):
            return index_oracle(torch, idx, Q)

        def bitwise(t_, o):
            return (t_.done and not t_.failed
                    and np.array_equal(t_.labels, o[0])
                    and np.array_equal(t_.d2.view(np.int32),
                                       o[1].view(np.int32)))

        def served(what, inserted, plain=False):
            """Gate 2, then gate 1 with the CPU's tables."""
            ins = live._coords[inserted[-sizes["inserted_q"]:]]
            Q = np.concatenate([ins, blob_law(nq - len(ins))])
            t0 = time.perf_counter()
            tk = live.engine.submit(Q)
            live.engine.drain()
            serve_s = time.perf_counter() - t0

            def check():
                o = oracle_of(Q)
                same_plain = None
                if plain:
                    coords, labels, _lo, _hi = idx.device_tensors()
                    qbuf, tl, _rowmap = idx.assemble(idx.prepare_queries(Q))
                    q_t = torch.from_numpy(qbuf).to(dev)
                    tl_t = torch.from_numpy(tl).to(dev)
                    got = ck.query_leaf(q_t, tl_t, coords, labels,
                                        block=idx.block, nb=idx.nb,
                                        tables=idx.kernel_tables())
                    same_plain = bool(torch.equal(got, query_min_core_plain(
                        q_t, tl_t, coords, labels, block=idx.block,
                        nb=idx.nb)))
                return bitwise(tk, o), same_plain, int((o[0] >= 0).sum())
            ok, same_plain, hits = gated(check)
            log(f"    predict {nq} ({len(ins)} just inserted) after {what}:"
                f" {serve_s * 1e3:.1f} ms; bitwise the card oracle over "
                f"{idx.n_core} cores: {ok} ({hits} within eps)"
                + ("" if same_plain is None else
                   f"; B5 bitwise its plain version on the slab: "
                   f"{same_plain}"))
            if not ok or same_plain is False:
                fail(f"predict after {what} differs from its oracle")
            gated(lambda: held(what, full=True))

        def new_ids(start):
            return np.arange(start, live._n, dtype=np.int64)

        # 11.1: single inserts, then batches spread over every cluster.
        n0 = live._n
        for row in blob_law(sizes["singles"]):
            update("insert", lambda r=row: live.insert(r[None]))
        served(f"{sizes['singles']} single inserts", new_ids(n0))
        stamp("11.1: single inserts done")
        n0 = live._n
        for _ in range(sizes["batches"]):
            one_dispatch("insert_batch", lambda: live.insert_batch(
                blob_law(sizes["batch_rows"])))
        served(f"{sizes['batches']} insert_batches", new_ids(n0))

        def pool_check():
            """Gate 3: one update's pool (16 rows of one blob), the
            card against the CPU."""
            Xb = blob_law(16, c=3)
            pool = live._pool(Xb)
            cores = pool[live._core[pool]]
            xt = torch.from_numpy(Xb).to(dev)
            got = (inc.count_within_eps(live._rows(pool), xt, eps),
                   inc.count_within_eps(xt, live._rows(pool), eps),
                   *inc.attach_to_cores(xt, live._rows(cores),
                                        live._labels[cores], eps))
            cp = live._coords[pool]
            want = (inc.count_within_eps(cp, Xb, eps),
                    inc.count_within_eps(Xb, cp, eps),
                    *inc.attach_to_cores(Xb, live._coords[cores],
                                         live._labels[cores], eps))
            same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
            return len(pool), int(want[0].sum()), same
        npool, pairs, same = gated(pool_check)
        log(f"    one update's pool ({npool} points against 16 rows, {pairs}"
            f" pairs within eps): counts, attach labels and d2 bits on the "
            f"device equal the CPU's: {same}")
        if not same:
            fail("the float64 verdicts on the device differ from the CPU's")
        stamp("11.1: batches done")

        # 11.2: one blob, a clump, a noise batch.
        n0 = live._n
        one_dispatch("blob_batch", lambda: live.insert_batch(
            blob_law(sizes["blob_rows"], c=0)))
        far = centres.max(axis=0) + 20 * eps
        n1 = live._n
        update("clump", lambda: live.insert(
            far + rng.normal(scale=0.05 * eps, size=(sizes["clump"], d))))
        clump_ids = new_ids(n1)
        n1 = live._n
        lo, hi = X.min(axis=0), X.max(axis=0)
        update("noise", lambda: live.insert_batch(
            rng.uniform(lo, hi, size=(sizes["deletes"], d))))
        noise_ids = new_ids(n1)
        clump_labels = np.unique(live._labels[clump_ids])
        noise = int((live._labels[noise_ids] < 0).sum())
        log(f"    clump of {sizes['clump']}: labels "
            f"{clump_labels.tolist()}, {int(live._core[clump_ids].sum())} "
            f"core; noise batch: {noise} of {len(noise_ids)} noise")
        if len(clump_labels) != 1 or clump_labels[0] < 0:
            fail("the clump did not become one new cluster")
        served("a blob batch, a clump and noise", new_ids(n0))
        stamp("11.2: blob batch, clump, noise done")

        # 11.3: a pour into the index leaf with the fewest free slots.
        C = idx.leaf_cap
        free = {leaf: sum(int((idx.labels[s * C:(s + 1) * C]
                               == INT32_MAX).sum()) for s in slabs)
                for leaf, slabs in idx.leaf_slabs.items()}
        leaf = min(free, key=free.get)
        base = live._coords[int(idx.gids[idx.leaf_slabs[leaf][0] * C])]
        for jitter in (1e-3, 1e-5, 0.0):
            pour = base + rng.normal(scale=jitter * eps,
                                     size=(free[leaf] + 64, d))
            if not idx.tree or (route_tree(idx.tree, (
                    pour - idx.center).astype(np.float32)) == leaf).all():
                break
        cols0, n0 = idx.coords.shape[1], live._n
        one_dispatch("pour", lambda: live.insert_batch(pour))
        grown = len(idx.leaf_slabs[leaf])
        log(f"    pour of {len(pour)} points into index leaf {leaf} "
            f"({free[leaf]} free slots): slab width {cols0} -> "
            f"{idx.coords.shape[1]}, the leaf owns {grown} slabs, appended "
            f"slab bytes {idx.appended_slab_bytes}")
        if idx.coords.shape[1] <= cols0 or grown < 2:
            fail("the pour did not append a slab")
        served("the pour", new_ids(n0), plain=True)
        stamp("11.3: pour done")

        # 11.4: delete the noise batch, then core ids of one cluster.
        d0, e0 = live.stats["recluster_dispatches"], idx.epoch
        update("delete_noise", lambda: live.delete_batch(noise_ids))
        log(f"    delete_batch of {len(noise_ids)} noise ids: "
            f"{live.stats['recluster_dispatches'] - d0} re-cluster "
            f"dispatches, {idx.epoch - e0} index deltas")
        lab = live._labels[:live._n]
        big = int(np.bincount(lab[lab >= 0]).argmax())
        members = np.flatnonzero((lab == big) & live._core[:live._n])
        doomed = rng.choice(members, size=sizes["deletes"], replace=False)
        p0 = live.stats["recluster_points"]
        one_dispatch("delete_cores", lambda: live.delete_batch(doomed))
        log(f"    delete_batch of {len(doomed)} core ids of cluster {big} "
            f"({len(members)} cores): re-clustered "
            f"{live.stats['recluster_points'] - p0} points")
        served("the deletes", new_ids(n0))
        stamp("11.4: deletes done")

        # 11.5: an IngestQueue of single submits, one flush.
        q = IngestQueue(live, max_batch_rows=sizes["queue_batch"])
        n0 = live._n
        t0 = time.perf_counter()
        tickets = [q.submit_insert(r[None])
                   for r in blob_law(sizes["queue_rows"])]
        submit_s = time.perf_counter() - t0
        batches = -(-sizes["queue_rows"] // sizes["queue_batch"])
        one_dispatch("queue_flush", q.flush, n=batches)
        qs = q.stats()
        if not all(t_.done and not t_.failed for t_ in tickets) or \
                qs["batches"] != batches:
            fail("the ingest queue did not resolve its tickets in its "
                 "batches")
        log(f"    IngestQueue: {len(tickets)} submits in {submit_s:.3f} s, "
            f"{qs['batches']} batches of {qs['mean_batch_rows']} rows; "
            f"write latency (submit to flush) p50 {qs['write_p50_ms']} ms, "
            f"p99 {qs['write_p99_ms']} ms")
        served("the queue", new_ids(n0))
        stamp("11.5: ingest queue done")

        n_p, a, n_diff, traced = gated(lambda: refit_trace(
            torch, dev, live, sizes["block"], sizes["trace_cap"]))
        log(f"    against a fresh fit of the {n_p} live points: ARI {a:.6f};"
            f" {n_diff} core flags differ, {traced} traced to a pair whose "
            f"float32 d2 lies within exact_slack of eps^2")
        if a != 1.0 or n_diff > sizes["trace_cap"] or traced != n_diff:
            fail("the live clustering differs from a fresh fit beyond the "
                 "near-eps pairs")
        rec.update(refit_ari=a, core_flags_differ=n_diff)
        stamp("11.5: the fresh fit's check done")

        # 11.6: a compaction, writes injected during its refit.
        Q = np.concatenate([live.points()[-nq // 4:], blob_law(nq - nq // 4)])
        inj = {}

        def hook(phase):
            if phase == "refit":
                n1 = live._n
                live.insert_batch(blob_law(sizes["replay_rows"]))
                inj["ins"] = new_ids(n1)
                alive = live._alive[members] & live._core[members]
                inj["del"] = rng.choice(members[alive],
                                        sizes["replay_deletes"],
                                        replace=False)
                live.delete_batch(inj["del"])
            elif phase == "swap":
                inj["before"] = live.engine.submit(Q)
                inj["oracle"] = gated(lambda: oracle_of(Q))

        hook_s = {}

        def timed_hook(phase):
            t0 = time.perf_counter()
            hook(phase)
            sync()
            hook_s[phase] = time.perf_counter() - t0

        comp = Compactor(live, phase_hook=timed_hook)
        gen0 = idx.generation
        sync()
        t0 = time.perf_counter()
        cst = comp.compact()
        sync()
        # The phases without the hook's own work (the injected writes in
        # the refit's, the ticket and its oracle in the swap's).
        comp_s = time.perf_counter() - t0 - sum(hook_s.values())
        ok_before = bitwise(inj["before"], inj["oracle"])
        after = live.engine.submit(Q)
        live.engine.drain()
        ok_after = bitwise(after, gated(lambda: oracle_of(Q)))
        gids = set(idx.gids[idx.gids >= 0].tolist())
        ins_core = inj["ins"][live._core[inj["ins"]]]
        replayed = (cst["replayed_inserts"] == sizes["replay_rows"]
                    and cst["replayed_deletes"] == sizes["replay_deletes"]
                    and live._alive[inj["ins"]].all()
                    and (live._labels[inj["ins"]] >= 0).all()
                    and all(int(g) in gids for g in ins_core)
                    and not live._alive[inj["del"]].any()
                    and not any(int(g) in gids for g in inj["del"]))
        phases = {k: round(v - hook_s.get(k, 0.0), 4)
                  for k, v in comp.phase_s.items()}
        log(f"    compaction {comp_s:.3f} s, by phase {phases} (the "
            f"injected writes took {hook_s.get('refit', 0.0):.3f} s); "
            f"generation "
            f"{gen0} -> {idx.generation}, appended slab bytes "
            f"{idx.appended_slab_bytes}; replayed "
            f"{cst['replayed_inserts']} inserts and "
            f"{cst['replayed_deletes']} deletes, in the new generation: "
            f"{replayed}; {nq} tickets submitted before the swap equal the"
            f" old generation's oracle: {ok_before}, after it the new "
            f"one's: {ok_after}; {card}")
        if not (ok_before and ok_after and replayed
                and idx.generation == gen0 + 1):
            fail("the compaction's swap dropped, misanswered or lost a "
                 "write")
        gated(lambda: held("the compaction", full=True))
        rec.update(compaction_s=comp_s, compaction_phases=phases)
        stamp("11.6: compaction done")

        # 11.7: save and load on the device.
        Qs = np.concatenate([live.points()[-nq // 8:],
                             blob_law(nq - nq // 8)])
        lab0, dist0 = live.predict(Qs, return_distance=True)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "live.npz")
            t0 = time.perf_counter()
            live.save(path)
            save_s = time.perf_counter() - t0
            t0 = time.perf_counter()
            back = LiveModel.load(path, device=dev)
            sync()
            load_s = time.perf_counter() - t0
        lab1, dist1 = back.predict(Qs, return_distance=True)
        same = (np.array_equal(lab0, lab1) and np.array_equal(dist0, dist1)
                and back.index.epoch == idx.epoch
                and np.array_equal(back.labels(), live.labels())
                and np.array_equal(back.ids(), np.arange(len(live.ids()))))
        log(f"    save {save_s:.2f} s, load {load_s:.2f} s: the restored "
            f"model serves byte-identically at epoch {back.index.epoch}: "
            f"{same}")
        if not same:
            fail("the live checkpoint does not round-trip")
        rec.update(save_s=save_s, load_s=load_s)
        del back
        stamp("11.7: save/load done")

        main = {k: ck.LAUNCHES[k] - gate["launches"][k] for k in ck.LAUNCHES}
        # The index serves on (phase 12) without the per-commit gate.
        del idx.commit_update
    rec["kinds"] = {}
    for kind, runs in per_kind.items():
        walls = np.array([w for w, _s, _b in runs]) * 1e3
        parts = {k: round(float(sum(s[k] for _w, s, _b in runs)), 4)
                 for k in split}
        # A p99 over fewer than 100 updates is little more than their
        # largest, so those kinds report the largest.
        tail = ("p99_ms", float(np.percentile(walls, 99))) \
            if len(runs) >= 100 else ("max_ms", float(walls.max()))
        rec["kinds"][kind] = {
            "n": len(runs),
            "p50_ms": round(float(np.percentile(walls, 50)), 3),
            tail[0]: round(tail[1], 3),
            "sum_s": round(float(walls.sum() / 1e3), 4),
            "split_s": parts,
            "delta_bytes": int(sum(b for _w, _s, b in runs)),
        }
        log(f"    {kind}: {len(runs)} updates, p50 "
            f"{rec['kinds'][kind]['p50_ms']} ms, {tail[0][:-3]} "
            f"{round(tail[1], 3)} ms; stage seconds {parts};"
            f" delta bytes {rec['kinds'][kind]['delta_bytes']}; {card}")
    rec["launches"] = {k: main[k] for k in ("count_pairs", "minlab_pairs",
                                            "query_leaf", "query_tables")}
    rec.update(recluster_dispatches=live.stats["recluster_dispatches"],
               commits=len(deltas), delta_bytes=int(sum(deltas)),
               gate_s=round(gate["s"], 3))
    log(f"    main path: {live.stats['recluster_dispatches']} re-cluster "
        f"dispatches; launches B1 {main['count_pairs']}, B2 "
        f"{main['minlab_pairs']}, B5 {main['query_leaf']}, query_tables "
        f"{main['query_tables']}; {len(deltas)} commits shipping "
        f"{sum(deltas)} delta bytes; gates took {gate['s']:.1f} s; {card}")
    if main["count_pairs"] < 1 or main["minlab_pairs"] < 1 or main[
            "query_leaf"] < 1 or (dev.type == "cuda"
                                  and main["query_tables"] < 1):
        fail("a kernel of the live path was never launched")
    return rec


# Phase 12: the gateway and the load harnesses.  Sizes of the phase; a
# test rehearses it at small ones on the CPU.
GATEWAY_SIZES = {"n": 1_000_000, "d": 16, "centers": 32, "std": 0.4,
                 "eps": 2.4, "min_samples": 10, "block": 2048,
                 "queries": 4096, "trace_cap": 64,
                 # 12.1: sustained_load on the live model.
                 "clients": 4, "rate_hz": 200.0, "batch_rows": 16,
                 "writers": 2, "write_rate_hz": 30.0, "write_batch_rows": 8,
                 "delete_fraction": 0.2, "compact_at_s": 5.0,
                 "duration_s": 15.0,
                 # 12.2: the fleet and gateway_load.
                 "big_n": 1_000_000, "fleet_n": 250_000, "fleet": 5,
                 "seed0": 101, "budget_share": 0.6, "hot_rows": 64,
                 "tenants": 4, "clients_per_tenant": 2,
                 "fleet_rate_hz": 120.0, "fleet_batch_rows": 64,
                 "zipf_s": 1.2, "write_fraction": 0.02,
                 "fleet_duration_s": 10.0, "refresh_at_s": 6.0}


def gateway_phase(torch, dev, sync, card="", sizes=GATEWAY_SIZES, live=None,
                  X=None, truth=None):
    """Phase 12 (the multi-tenant gateway and the load harnesses).

    12.1: ``sustained_load`` on ``live`` (phase 11's 1M x 16-D
    ``LiveModel``; fitted from ``make_blob_data`` here when None):
    Poisson readers, two Poisson writers through an ``IngestQueue``
    (blob-law inserts, a share deleting their own acknowledged ones) and
    a ``Compactor`` started at ``compact_at_s``.  Gates: no dropped
    ticket, failed write or missed deadline; >= 1 compaction and epoch
    swap; the index's device tensors = its host mirrors and B5's tables
    = a fresh ``query_tables``, bitwise; ``predict`` of ``queries``
    blob-law rows bitwise ``card_oracle``; a fresh fit of the final
    points ARI 1.0, each differing core flag traced to a near-eps pair;
    B1, B2, B5 (and on the card ``query_tables``) launched.

    12.2: a fleet of seven models fitted on ``dev`` from
    ``make_blob_data`` (``big``: ``big_n`` points, ``m1`` ...: ``fleet_n``
    each, ``live``: ``fleet_n``, registered live) behind one
    ``ModelGateway`` whose budget is ``budget_share`` of their summed
    ``index_bytes``.  Gates: the victims of the budget are the least
    recently served; the first eviction gives back (``memory_allocated``
    on the card, and every released tensor is freed) at least the
    victims' device bytes; each readmitted index's device tensors and
    B5 tables are bitwise what they were, and its answers (labels and
    d^2) bitwise its answers before the eviction and ``card_oracle``;
    a tenant over its quota sheds 7 of 10, a quiet one none; a refit
    model raises ``StaleModelHandle`` until ``refresh``; an insert on the
    live handle is served at once and its ``refresh`` refused; then
    ``gateway_load`` (Zipf tenants, live writes, a ``refresh`` of ``m2``
    at ``refresh_at_s``) drops no ticket, misses no deadline, evicts and
    readmits, swaps once, ``m2`` then gives the refreshed model's labels
    and answers bitwise the oracle over its new generation (built in the
    old frame, its d^2 may differ from the model's own engine's), B5
    launches = the engines' batches and on the card ``query_tables``
    launches = readmissions + refreshes + live commits.  Returns the
    phase's record."""
    import gc
    import tempfile
    import weakref

    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.checkpoint import load_index
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.serve import (
        Compactor, GatewayError, ModelGateway, StaleModelHandle,
        TenantQuotaExceeded, gateway_load, sustained_load,
    )

    eps, ms, d = sizes["eps"], sizes["min_samples"], sizes["d"]
    nq, block = sizes["queries"], sizes["block"]
    t_phase = time.perf_counter()

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def blob_law(rng, centres, m):
        cc = rng.integers(0, len(centres), m)
        return centres[cc] + rng.normal(scale=sizes["std"], size=(m, d))

    def centres_of(Xs, ts):
        return np.stack([Xs[ts == c].mean(axis=0)
                         for c in range(int(ts.max()) + 1)])

    def kernel_launches():
        """Launches since the last reset, by kernel (both modes)."""
        L = ck.LAUNCHES
        return {"count_pairs": L["count_pairs"],
                "minlab_pairs": L["minlab_pairs"],
                "query_leaf": L["query_leaf"] + L["query_leaf_mixed"],
                "query_tables": L["query_tables"]}

    def answers(eng, Q):
        """(labels, d^2) of one request through ``eng``'s queue."""
        t = eng.submit(Q)
        eng.drain()
        return t.labels, t.d2

    def bitwise(got, want):
        return (np.array_equal(got[0], want[0])
                and np.array_equal(np.asarray(got[1], np.float32)
                                   .view(np.int32),
                                   np.asarray(want[1], np.float32)
                                   .view(np.int32)))

    rec = {"card": card}
    rng = np.random.default_rng(0)

    # 12.1: the ingest harness on the live model.
    if live is None:
        X, truth = make_blob_data(sizes["n"], d, n_centers=sizes["centers"],
                                  std=sizes["std"])
        live = DBSCAN(eps=eps, min_samples=ms, block=block,
                      device=dev).fit(X).live()
        sync()
        stamp(f"12.1: LiveModel over {live.stats['points']} points built")
    centres = centres_of(X, truth)
    comp = Compactor(live)
    swaps0 = live.stats["epoch_swaps"]
    sync()
    ck.reset_launch_counts()
    res = sustained_load(
        live.engine, clients=sizes["clients"], rate_hz=sizes["rate_hz"],
        batch_rows=sizes["batch_rows"], writers=sizes["writers"],
        write_rate_hz=sizes["write_rate_hz"],
        write_batch_rows=sizes["write_batch_rows"],
        delete_fraction=sizes["delete_fraction"],
        write_sampler=lambda r, k: blob_law(r, centres, k), live=live,
        compactor=comp, compact_at_s=sizes["compact_at_s"],
        duration_s=sizes["duration_s"], seed=0,
    )
    sync()
    main = kernel_launches()
    swaps = live.stats["epoch_swaps"] - swaps0
    keys = ("qps", "p50_ms", "p99_ms", "update_visible_p50_ms",
            "update_visible_p99_ms", "write_qps", "mean_write_batch",
            "read_p99_during_compaction_ms", "read_p99_outside_ms",
            "compaction_s")
    rec["ingest"] = {k: res[k] for k in keys}
    rec["ingest"].update(
        queries=res["queries"], write_rows=res["write_rows"],
        compactions=res["compactions"], epoch_swaps=swaps,
        compaction_phases={k: round(v, 4) for k, v in comp.phase_s.items()},
        launches=main)
    log(f"    sustained_load {res['duration_s']} s: {res['queries']} "
        f"queries, qps {res['qps']}, p50 {res['p50_ms']} ms, p99 "
        f"{res['p99_ms']} ms; update-visible p50 "
        f"{res['update_visible_p50_ms']} ms, p99 "
        f"{res['update_visible_p99_ms']} ms; {res['write_rows']} rows "
        f"written at {res['write_qps']} rows/s in batches of "
        f"{res['mean_write_batch']} mean; read p99 during compaction "
        f"{res['read_p99_during_compaction_ms']} ms against "
        f"{res['read_p99_outside_ms']} ms outside; {res['compactions']} "
        f"compaction(s) {res['compaction_s']} s by phase "
        f"{rec['ingest']['compaction_phases']}; dropped "
        f"{res['dropped_tickets']}, failed writes {res['write_failures']}, "
        f"missed deadlines {res['deadline_failures']}, shed {res['shed']}; "
        f"launches {main}; {card}")
    if (res["dropped_tickets"] or res["write_failures"]
            or res["deadline_failures"]):
        fail("sustained_load dropped a ticket, failed a write or missed a "
             "deadline")
    if res["compactions"] < 1 or swaps < 1:
        fail("sustained_load ran no compaction and epoch swap")
    idx = live.index
    hold_index(torch, ck, idx, dev, "sustained_load", full=True)
    Q = blob_law(rng, centres, nq)
    want = index_oracle(torch, idx, Q)
    ok = bitwise(answers(live.engine, Q), want)
    n_p, a, n_diff, traced = refit_trace(torch, dev, live, block,
                                         sizes["trace_cap"])
    log(f"    after the run: predict of {nq} bitwise the card oracle over "
        f"{idx.n_core} cores: {ok} ({int((want[0] >= 0).sum())} within "
        f"eps); a fresh fit of the {n_p} live points: ARI {a:.6f}, "
        f"{n_diff} core flags differ, {traced} traced to a near-eps pair")
    if not ok:
        fail("predict after sustained_load differs from its oracle")
    if a != 1.0 or n_diff > sizes["trace_cap"] or traced != n_diff:
        fail("the live clustering after sustained_load differs from a "
             "fresh fit beyond the near-eps pairs")
    if min(main["count_pairs"], main["minlab_pairs"],
           main["query_leaf"]) < 1 or (dev.type == "cuda"
                                       and main["query_tables"] < 1):
        fail("a kernel of the ingest harness's path was never launched")
    rec["ingest"].update(refit_ari=a, core_flags_differ=n_diff)
    stamp("12.1: the ingest harness done")

    # 12.2: the fleet.
    specs = ([("big", sizes["big_n"])]
             + [(f"m{i}", sizes["fleet_n"])
                for i in range(1, sizes["fleet"] + 1)]
             + [("live", sizes["fleet_n"])])
    fits, queries = {}, {}
    t0 = time.perf_counter()
    for i, (name, n) in enumerate(specs):
        Xs, ts = make_blob_data(n, d, n_centers=sizes["centers"],
                                std=sizes["std"], seed=sizes["seed0"] + i)
        fits[name] = (DBSCAN(eps=eps, min_samples=ms, block=block,
                             device=dev).fit(Xs), Xs)
        queries[name] = blob_law(rng, centres_of(Xs, ts), nq)
    sync()
    fit_s = time.perf_counter() - t0
    spill = tempfile.TemporaryDirectory()
    gw = ModelGateway(spill_dir=spill.name)

    def served(name, Q, tenant="warm"):
        """(labels, d^2) of one request through the gateway."""
        t = gw.submit(name, Q, tenant=tenant)
        gw.drain(name)
        return t.labels, t.d2

    build_s = {}
    for name, (m, _Xs) in fits.items():
        t0 = time.perf_counter()
        gw.register(name, m, live=name == "live")
        sync()
        build_s[name] = round(time.perf_counter() - t0, 3)
    rep = gw.gateway_report()
    sizes_b = {k: v["index_bytes"] for k, v in rep["models"].items()}
    total = sum(sizes_b.values())
    log(f"    fleet of {len(fits)} fitted in {fit_s:.2f} s; registered "
        f"(index builds, the live model's LiveModel) in s {build_s}; "
        f"index_bytes {sizes_b}, {total} in all")
    stamp("12.2: the fleet registered")

    # Serve each once (the LRU order), hold against the oracle.
    pre = {}
    for name in fits:
        pre[name] = served(name, queries[name])
        want = index_oracle(torch, gw._handles[name].index, queries[name])
        if not bitwise(pre[name], want):
            fail(f"model {name} does not answer as its oracle")
    # Timers on eviction and readmission (a readmission's own evictions
    # are taken out of its window).
    timing = {"evict": [], "readmit": [], "victims": []}
    evict, readmit = gw._evict, gw._readmit

    def timed_evict(h):
        t, mid = time.perf_counter(), h.model_id
        timing["victims"].append(mid)
        evict(h)
        sync()
        timing["evict"].append((mid, time.perf_counter() - t))

    def timed_readmit(h):
        t, n_ev = time.perf_counter(), len(timing["evict"])
        readmit(h)
        sync()
        inner = sum(sec for _m, sec in timing["evict"][n_ev:])
        timing["readmit"].append((h.model_id,
                                  time.perf_counter() - t - inner))

    def mean_ms(kind):
        """Mean ms of the timed evictions or readmissions, by model
        size."""
        out = {}
        for n, pick in ((sizes["big_n"], lambda m: m == "big"),
                        (sizes["fleet_n"], lambda m: m != "big")):
            v = [sec for m, sec in timing[kind] if pick(m)]
            out[str(n)] = round(1e3 * float(np.mean(v)), 3) if v else None
        return out

    gw._evict, gw._readmit = timed_evict, timed_readmit
    # The budget: the victims are the least recently served unpinned
    # residents other than the last served.
    order = list(fits)
    budget = int(sizes["budget_share"] * total)
    expect, left = [], total
    for name in order[:-1]:
        if left <= budget:
            break
        if not rep["models"][name]["pinned"]:
            expect.append(name)
            left -= sizes_b[name]
    snaps, refs, dev_bytes = {}, [], 0
    for name in expect:
        idx = gw._handles[name].index
        tensors = tuple(idx._dev) + tuple(idx._tables or ())
        snaps[name] = [t.cpu().clone() for t in tensors]
        refs += [weakref.ref(t) for t in tensors]
        dev_bytes += idx.index_device_bytes
    del tensors, idx
    gc.collect()
    sync()
    mem0 = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    gw.budget_bytes = budget
    gw._ensure_budget(keep=order[-1])
    gc.collect()
    sync()
    fell = (mem0 - torch.cuda.memory_allocated(dev)
            if dev.type == "cuda" else None)
    alive = sum(r() is not None for r in refs)
    log(f"    budget {budget} bytes ({sizes['budget_share']} of the fleet): "
        f"evicted {timing['victims']} (expected {expect}); device bytes "
        f"given back {fell} against the victims' {dev_bytes}; released "
        f"tensors still alive {alive}")
    if timing["victims"] != expect:
        fail("the budget did not evict the least recently served models")
    if alive or (fell is not None and fell < dev_bytes):
        fail("an eviction did not give the card its memory back")
    # Readmit each victim on demand.
    for name in expect:
        got = served(name, queries[name])
        idx = gw._handles[name].index
        now = tuple(idx._dev) + tuple(idx._tables or ())
        bad = words_off(torch, now, snaps[name])
        if idx.device != dev or len(now) != len(snaps[name]) or bad:
            fail(f"the readmitted {name} index differs from its tensors "
                 f"before the eviction ({bad} words) or left {dev}")
        want = index_oracle(torch, idx, queries[name])
        same = bitwise(got, pre[name]) and bitwise(got, want)
        log(f"    readmitted {name}: device tensors and B5 tables bitwise "
            f"as before: True; {nq} answers bitwise before the eviction "
            f"and the card oracle: {same}")
        if not same:
            fail(f"the readmitted {name} does not answer as before")
        del idx, now
    rep = gw.gateway_report()
    # Where a readmission's time goes, on a spill of each size (a
    # readmitted model's stays on disk): reading it (host) against the
    # upload with B5's tables.
    split = {}
    for n, pick in ((sizes["big_n"], lambda m: m == "big"),
                    (sizes["fleet_n"], lambda m: m != "big")):
        spilled = [hh for m, hh in gw._handles.items()
                   if pick(m) and hh.spill_path
                   and os.path.exists(hh.spill_path)]
        if not spilled:
            continue
        t0 = time.perf_counter()
        probe = load_index(spilled[0].spill_path, device=dev)
        t1 = time.perf_counter()
        probe.device_tensors()
        sync()
        split[str(n)] = {"read_ms": round(1e3 * (t1 - t0), 3),
                         "upload_tables_ms": round(
                             1e3 * (time.perf_counter() - t1), 3)}
        probe.release()
        del probe
    rec["quiet"] = {"evict_ms_mean": mean_ms("evict"),
                    "readmit_ms_mean": mean_ms("readmit"),
                    "readmit_split": split}
    stamp(f"12.2: evictions {rep['evictions']}, readmissions "
          f"{rep['reloads']} done, without traffic: mean ms by model size, "
          f"eviction {rec['quiet']['evict_ms_mean']}, readmission "
          f"{rec['quiet']['readmit_ms_mean']} (a spill's read and its "
          f"upload with B5's tables: {split})")

    # Admission.
    hq = queries["live"][:sizes["hot_rows"]]
    gw.set_quota("hot", qps=0.001, burst=3)
    shed = {"hot": 0, "quiet": 0}
    for tenant in ("hot", "quiet"):
        for _ in range(10):
            try:
                gw.predict("live", hq, tenant=tenant)
            except TenantQuotaExceeded:
                shed[tenant] += 1
    log(f"    admission: hot sheds {shed['hot']} of 10, quiet "
        f"{shed['quiet']}")
    if shed != {"hot": 7, "quiet": 0}:
        fail("the admission gate did not shed 7 of the hot tenant's 10 "
             "and none of the quiet tenant's")

    # Staleness, then refresh.
    m3, X3 = fits["m3"]
    m3.fit(X3)
    try:
        gw.predict("m3", queries["m3"][:8])
        fail("a refit model was served through its stale handle")
    except StaleModelHandle:
        pass
    gw.refresh("m3")
    got = served("m3", queries["m3"])
    own = answers(m3.query_engine(), queries["m3"])
    log(f"    m3 refit: StaleModelHandle raised; after refresh bitwise its "
        f"own predict: {bitwise(got, own)}")
    if not bitwise(got, own):
        fail("the refreshed m3 does not answer as its own predict")

    # The live handle.
    h = gw.handle("live")
    q1 = fits["live"][1][:1] + 0.05
    h.live.insert(q1)
    lab = gw.predict("live", q1)
    try:
        gw.refresh("live")
        refused = False
    except GatewayError:
        refused = True
    log(f"    live handle: an insert served at once: "
        f"{lab[0] == h.live.labels()[-1]} (label {lab[0]}); refresh "
        f"refused: {refused}")
    if lab[0] != h.live.labels()[-1] or not refused:
        fail("the live handle did not serve its insert or took a refresh")
    stamp("12.2: admission, staleness and the live handle done")

    # gateway_load with a mid-run refresh of m2 on new data.
    Xn, tn = make_blob_data(sizes["fleet_n"], d, n_centers=sizes["centers"],
                            std=sizes["std"], seed=sizes["seed0"] + len(specs))
    m2_new = DBSCAN(eps=eps, min_samples=ms, block=block, device=dev).fit(Xn)
    Q2 = blob_law(rng, centres_of(Xn, tn), nq)
    rep0 = gw.gateway_report()
    live_epoch0 = h.index.epoch
    # Each engine's batches during the run: an engine alive at the start
    # counts from its batches then, one built in the run from 0.
    start = {hh.model_id: (hh.engine, hh.engine.batches)
             for hh in gw._handles.values() if hh.resident}
    batches = [0]
    evict_t = gw._evict

    def ran(mid, eng):
        first, b0 = start.get(mid, (None, 0))
        return eng.batches - (b0 if first is eng else 0)

    def counted_evict(hh):
        # The eviction drains the victim's engine first: count after it.
        mid, eng = hh.model_id, hh.engine
        evict_t(hh)
        batches[0] += ran(mid, eng)

    gw._evict = counted_evict
    timing["evict"].clear()
    timing["readmit"].clear()
    del h
    sync()
    ck.reset_launch_counts()
    res = gateway_load(
        gw, list(fits), tenants=sizes["tenants"],
        clients_per_tenant=sizes["clients_per_tenant"],
        rate_hz=sizes["fleet_rate_hz"], batch_rows=sizes["fleet_batch_rows"],
        zipf_s=sizes["zipf_s"], write_fraction=sizes["write_fraction"],
        duration_s=sizes["fleet_duration_s"],
        refresh_at_s=sizes["refresh_at_s"],
        refresher=lambda: gw.refresh("m2", m2_new), seed=0,
    )
    sync()
    main = kernel_launches()
    batches[0] += sum(ran(mid, hh.engine) for mid, hh in gw._handles.items()
                      if hh.resident)
    gw._evict = evict_t
    start.clear()
    g = res["gateway"]
    ev = g["evictions"] - rep0["evictions"]
    rl = g["reloads"] - rep0["reloads"]
    sw = g["epoch_swaps"] - rep0["epoch_swaps"]
    commits = gw._handles["live"].index.epoch - live_epoch0
    tables_want = rl + sw + commits
    swap_ms = [round(1e3 * (b - a), 3) for a, b in gw.swap_windows[-sw:]] \
        if sw else []
    tenants = {t: {k: st[k] for k in ("admitted", "shed", "p50_ms",
                                      "p99_ms")}
               for t, st in g["tenants"].items() if t.startswith("t")}
    rec["fleet"] = {
        "index_bytes": sizes_b, "budget_bytes": budget,
        "build_s": build_s, "qps": res["qps"], "p50_ms": res["p50_ms"],
        "p99_ms": res["p99_ms"], "queries": res["queries"],
        "writes": res["writes"], "evictions": ev, "reloads": rl,
        "evict_ms_mean": mean_ms("evict"),
        "readmit_ms_mean": mean_ms("readmit"), "swap_ms": swap_ms,
        "read_p99_in_window_ms": res["read_p99_in_window_ms"],
        "read_p99_outside_ms": res["read_p99_outside_ms"],
        "update_visible_p50_ms": res["update_visible_p50_ms"],
        "tenants": tenants, "launches": main, "batches": batches[0],
    }
    for t, st in tenants.items():
        log(f"    tenant {t}: admitted {st['admitted']}, shed {st['shed']}, "
            f"p50 {st['p50_ms']} ms, p99 {st['p99_ms']} ms")
    log(f"    gateway_load {res['duration_s']} s: {res['queries']} queries, "
        f"qps {res['qps']}, p50 {res['p50_ms']} ms, p99 {res['p99_ms']} ms; "
        f"{ev} evictions (mean {rec['fleet']['evict_ms_mean']} ms), {rl} "
        f"readmissions (mean {rec['fleet']['readmit_ms_mean']} ms), swap "
        f"window {swap_ms} ms; read p99 in a window "
        f"{res['read_p99_in_window_ms']} ms against "
        f"{res['read_p99_outside_ms']} ms outside; {res['writes']} live "
        f"writes, update-visible p50 {res['update_visible_p50_ms']} ms; "
        f"dropped {res['dropped_tickets']}, missed deadlines "
        f"{res['deadline_failures']}; launches {main} for {batches[0]} "
        f"batches, query_tables expected {tables_want} ({rl} readmissions "
        f"+ {sw} refreshes + {commits} live commits); {card}")
    if res["dropped_tickets"] or res["deadline_failures"]:
        fail("gateway_load dropped a ticket or missed a deadline")
    if ev < 1 or rl < 1 or sw != 1:
        fail(f"gateway_load ran {ev} evictions, {rl} readmissions and {sw} "
             f"swaps (wanted >= 1, >= 1 and 1)")
    if main["query_leaf"] < 1 or main["query_leaf"] != batches[0]:
        fail("B5's launches in gateway_load differ from the engines' "
             "batches")
    if dev.type == "cuda" and main["query_tables"] != tables_want:
        fail("query_tables launches in gateway_load differ from the "
             "readmissions, refreshes and live commits")
    # The swap builds the new generation in the old one's frame (its
    # centre), the refreshed model's own index in its own: labels equal,
    # d^2 rounded in another frame; the swapped generation answers
    # bitwise its oracle.
    got = served("m2", Q2)
    own = answers(m2_new.query_engine(), Q2)
    want = index_oracle(torch, gw._handles["m2"].index, Q2)
    same = np.array_equal(got[0], own[0]) and bitwise(got, want)
    d2_off = int((got[1].view(np.int32) != own[1].view(np.int32)).sum())
    rec["fleet"]["swap_d2_words_off_own_frame"] = d2_off
    log(f"    m2 after the swap: labels bitwise the refreshed model's own "
        f"predict and (labels, d2) bitwise the card oracle over the new "
        f"generation: {same}; d2 words off the model's own engine (its "
        f"index centred on its own cores, not the old frame): {d2_off}")
    if not same:
        fail("m2 after the swap does not answer as the refreshed model")
    for name in list(gw.model_ids):
        gw.unregister(name)
    spill.cleanup()
    stamp("12.2: gateway_load done")
    return rec


# Phase 13: the KD route's chained form.  Sizes of the phase; a test
# rehearses it at small ones on the CPU.  13.1: separated 16-D blobs
# (centres 12 apart, std 0.4; no border within eps of two clusters) and
# make_embedding_data(emb_n, 512) through B3/B4 (block 128 keeps the
# CPU's plain sketch passes to ~15 s); 13.2: phase 4's data and fit, and
# B1/B2 held on the first hold_tiles row tiles of its largest slab;
# 13.3: the first border_n points of the same data at border_eps (1.4:
# border points and noise) under the host merge (the whole 1M until
# phase 17 took its time).  13.2 and 13.3 run over 16 KD partitions (64
# until phase 19 took their time: the host's per-partition sorts made
# 13.2 16.7-36.9 s a fit).
CHAINED_SIZES = {"small_n": 20_000, "small_eps": 2.0, "small_parts": 8,
                 "small_block": 256, "emb_n": 4096, "emb_eps": 2.0,
                 "emb_parts": 2, "emb_block": 128, "n": 1_000_000,
                 "eps": 2.4, "parts": 16, "block": 2048, "hold_tiles": 64,
                 "border_eps": 1.4, "border_n": 200_000}


def chained_cpu_cases(sizes):
    """13.1's two cases, made from their seeds: ``{name: (X,
    partitioner, kwargs)}``."""
    from benchdata import make_embedding_data, make_separated_blob_data
    from pypardis_tpu_torch import KDPartitioner

    Xs, _truth, _c = make_separated_blob_data(
        sizes["small_n"], 16, n_centers=8, min_sep=12.0, spread=12.0,
        seed=13)
    Xe, _te = make_embedding_data(sizes["emb_n"], 512)
    return {
        "small": (Xs, KDPartitioner(Xs, max_partitions=sizes["small_parts"]),
                  dict(eps=sizes["small_eps"], min_samples=10,
                       block=sizes["small_block"])),
        "emb": (Xe, KDPartitioner(Xe, max_partitions=sizes["emb_parts"]),
                dict(eps=sizes["emb_eps"], min_samples=10,
                     block=sizes["emb_block"])),
    }


def cases_digest(cases) -> str:
    """sha256 over the cases' points: both processes hold the same."""
    h = hashlib.sha256()
    for name in sorted(cases):
        h.update(np.ascontiguousarray(cases[name][0]).tobytes())
    return h.hexdigest()


def chained_cpu_runs(cases):
    """Each case through the port's chained route on the CPU (the
    kernels' plain versions, which count no launch): ``{name: ((labels,
    core), seconds)}``."""
    from pypardis_tpu_torch.parallel import sharded_dbscan

    out = {}
    for name, (x, part, kw) in cases.items():
        t = time.perf_counter()
        lab, core, _st = sharded_dbscan(x, part, device="cpu", **kw)
        out[name] = ((lab, core), time.perf_counter() - t)
    return out


class ChainedCpuRefs:
    """The CPU runs of 13.1 (``"kd"``), 16.1 (``"gm"``), 17.1
    (``"mesh"``) and 18.1 (``"ring"``) in a child process
    (``chip_smoke.py --chained-cpu-refs PATH SIZES JOBS``: no card, 4
    threads, niced), started after phase 4 so that they run beside the
    card's work without sharing this process's interpreter lock;
    :meth:`result` waits for one job's runs.  The child writes one
    ``.npz`` per job, in order, under the checkout's ``build/`` and is
    killed if this process exits first."""

    def __init__(self, sizes=CHAINED_SIZES, jobs=("kd",)):
        root = os.path.dirname(os.path.abspath(__file__))
        self.dir = os.path.join(root, "build", "chip_smoke_refs")
        os.makedirs(self.dir, exist_ok=True)
        base = os.path.join(self.dir, f"refs_{os.getpid()}")
        self.paths = {job: f"{base}_{job}.npz" for job in jobs}
        self.log_path = base + ".log"
        self.log = open(self.log_path, "w")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="4")
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--chained-cpu-refs",
             base, json.dumps(sizes), ",".join(jobs)],
            env=env, stdout=self.log, stderr=subprocess.STDOUT, cwd=root)
        atexit.register(self.stop)

    def stop(self):
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.log.close()

    def _tail(self):
        with open(self.log_path) as f:
            return f.read()[-2000:]

    def result(self, cases, job="kd"):
        """The child's ``{name: ((labels, core), seconds)}`` of ``job``
        (``"gm"``, ``"mesh"``, ``"ring"``: ``{name: ((labels, core, stats),
        seconds)}``, the stats without their timings), its points
        checked to be
        ``cases``'.  Reading the last job ends the child and removes its
        files."""
        path = self.paths.pop(job)
        while not os.path.exists(path) and self.proc.poll() is None:
            time.sleep(0.2)
        if not os.path.exists(path):
            fail(f"the CPU runs' process exited {self.proc.poll()} before "
                 f"its {job} runs: {self._tail()}")
        try:
            with np.load(path) as z:
                if str(z["digest"]) != cases_digest(cases):
                    fail(f"{job}: the CPU runs' process made other points")
                out = {}
                for name in cases:
                    res = (z[f"{name}_labels"], z[f"{name}_core"])
                    if f"{name}_stats" in z.files:
                        res += (json.loads(str(z[f"{name}_stats"])),)
                    out[name] = (res, float(z[f"{name}_s"]))
                return out
        finally:
            os.remove(path)
            if not self.paths:
                rc = self.proc.wait()
                self.log.close()
                if rc:
                    fail(f"the CPU runs' process exited {rc}: {self._tail()}")
                os.remove(self.log_path)
                with contextlib.suppress(OSError):
                    os.rmdir(self.dir)


def chained_cpu_refs_child(base, sizes, jobs):
    """The child of :class:`ChainedCpuRefs`: each job's CPU runs, written
    to ``{base}_{job}.npz`` (atomically, so a reader never sees half)."""
    import torch

    os.nice(10)
    torch.set_num_threads(4)
    for job in jobs.split(","):
        cases_of, runs_of = {
            "kd": (chained_cpu_cases, chained_cpu_runs),
            "gm": (gm_cpu_cases, gm_cpu_runs),
            "mesh": (mesh_cpu_cases, mesh_cpu_runs),
            "ring": (ring_cpu_cases, ring_cpu_runs),
            "gmmesh": (gmmesh_cpu_cases, gmmesh_cpu_runs)}[job]
        cases = cases_of(sizes)
        runs = runs_of(cases)
        arrays = {"digest": np.array(cases_digest(cases))}
        for name, (res, sec) in runs.items():
            arrays.update({f"{name}_labels": res[0], f"{name}_core": res[1],
                           f"{name}_s": np.array(sec)})
            if len(res) > 2:
                arrays[f"{name}_stats"] = np.array(json.dumps(res[2]))
        tmp = f"{base}_{job}.tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, f"{base}_{job}.npz")


def chained_launches(ck, stats, what, counts="count_pairs",
                     minlab="minlab_pairs"):
    """The chained route's launches against its partitions' passes: one
    counts pass per partition dispatched, a min-label pass for each of
    its other passes (``stats["partition_passes"]``, 0 where a pair list
    overflowed and no pass ran)."""
    la = dict(ck.LAUNCHES)
    ran = [p for p in stats["partition_passes"] if p]
    want = {counts: len(ran), minlab: sum(p - 1 for p in ran)}
    others = {k: v for k, v in la.items() if k not in want and v}
    log(f"    {what}: launches {counts}={la[counts]} {minlab}={la[minlab]}"
        f" for {len(ran)} partitions dispatched, passes {sum(ran)} "
        f"(want {want}); other kernels {others}")
    if la[counts] < 1 or la[minlab] < 1:
        fail(f"{what}: a kernel of the chained route was never launched")
    if {k: la[k] for k in want} != want or others:
        fail(f"{what}: launches do not match the partitions' passes")
    return la


def f32_within(torch, x, rows, cand, e2, chunk=1 << 22):
    """Per row of ``rows`` (indices into the recentred float32 rows
    ``x``, on the card), whether it lies within eps of any row in
    ``cand``: d^2 summed axis by axis with each operation rounded on its
    own, the kernels' exact verdict (``ops/distances._pair_d2``), against
    the float32 eps^2 ``e2``; ``chunk`` bounds the pairs held at once."""
    out = torch.zeros(len(rows), dtype=torch.bool, device=x.device)
    step = max(1, chunk // max(len(cand), 1))
    for s in range(0, len(rows), step):
        df = x[cand][None, :, :] - x[rows[s:s + step]][:, None, :]
        acc = torch.zeros(df.shape[:2], dtype=torch.float32,
                          device=x.device)
        for a in range(x.shape[1]):
            acc = acc + df[:, :, a] * df[:, :, a]
        out[s:s + step] = (acc <= e2).any(1)
    return out


def hold_chained(torch, dev, X, eps, lab, core, s_lab, s_core, what):
    """A chained fit's ``(lab, core)`` against the single-device fit's
    ``(s_lab, s_core)`` on the same data: the core mask and the noise
    byte-identical, the core points clustered alike (a bijection of
    labels), and every border point whose cluster differs within eps of
    a core of both clusters (an eps tie: either attach is right), by the
    exact float32 verdict on the card; any other difference fails.
    Returns ``(clusters, borders, noise, differ)``."""
    from pypardis_tpu_torch.ops.distances import eps2_f32

    s_lab, s_core = np.asarray(s_lab), np.asarray(s_core)
    if not np.array_equal(core, s_core):
        fail(f"{what}: core flags differ from the single-device fit in "
             f"{int((core != s_core).sum())} points")
    if not np.array_equal(lab < 0, s_lab < 0):
        fail(f"{what}: noise differs from the single-device fit")
    pairs = np.unique(np.stack([lab[core], s_lab[core]]), axis=1)
    if not (pairs.shape[1] == len(np.unique(lab[core]))
            == len(np.unique(s_lab[core]))):
        fail(f"{what}: the core points' clustering differs from the "
             f"single-device fit's")
    to_chained = dict(zip(pairs[1].tolist(), pairs[0].tolist()))
    border = np.flatnonzero((lab >= 0) & ~core)
    mapped = np.array([to_chained.get(v, -2) for v in s_lab[border]],
                      dtype=np.int64)
    differ = border[mapped != lab[border]]
    if len(differ):
        center = X.mean(axis=0, dtype=np.float64)
        xr = torch.from_numpy((X - center).astype(np.float32)).to(dev)
        e2 = eps2_f32(eps)
        for c_of in (lab[differ], mapped[mapped != lab[border]]):
            for c in np.unique(c_of).tolist():
                rows = torch.from_numpy(differ[c_of == c]).to(dev)
                cand = torch.from_numpy(
                    np.flatnonzero(core & (lab == c))).to(dev)
                ok = (f32_within(torch, xr, rows, cand, e2)
                      if len(cand) else torch.zeros_like(rows, dtype=bool))
                if not bool(ok.all()):
                    b = int(rows[~ok][0])
                    fail(f"{what}: border point {b} differs from the "
                         f"single-device fit but is not within eps of a "
                         f"core of cluster {c}")
        del xr
    noise = int((lab < 0).sum())
    log(f"    {what} vs the single-device fit: core byte-identical, core "
        f"clustering identical ({pairs.shape[1]} clusters), {len(border)} "
        f"border and {noise} noise points, {len(differ)} border points in "
        f"another cluster, each within eps of a core of both")
    return pairs.shape[1], len(border), noise, len(differ)


def chained_slab_hold(torch, dev, X, part, eps, block, tiles, what):
    """B1 and one B2 round on the chained route's largest slab (most
    owned + halo points of ``part``'s partitions), laid out as the route
    lays it out (``parallel/sharded._chained_layout`` and
    ``_partition_slab``: the owned rows, the empty rows up to ``cap``,
    then the halo) and put on the card: on the first ``tiles`` row tiles
    of its live tile-pair list the kernels against their plain versions
    on the same device tensors (B1's counts; B2 at the round-1 labels
    with every valid row live), both exact.  Returns the record."""
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, eps2_f32, row_offsets,
    )
    from pypardis_tpu_torch.parallel import sharded

    layout, _st = sharded._chained_layout(X, part, eps, block, "high")
    sizes = [len(o) + len(h) for o, h in zip(layout["part_idx"],
                                              layout["halo_idx"])]
    p = int(np.argmax(sizes))
    rows = layout["cap"] + layout["hcap"]
    pts = np.empty((X.shape[1], rows), np.float32)
    msk = np.empty(rows, bool)
    gid = np.empty(rows, np.int32)
    sharded._partition_slab(pts, msk, gid, X, layout, p)
    xs = torch.from_numpy(pts).to(dev)
    mask = torch.from_numpy(msk).to(dev)
    blk = layout["block"]
    (prs, cols), (total, budget) = ck.kernel_pair_list(xs, eps, mask, blk,
                                                       "high")
    if total > budget:
        (prs, cols), (total, budget) = ck.kernel_pair_list(
            xs, eps, mask, blk, "high", budget=total)
    d, N = xs.shape
    tile = ck._pallas_block(blk, N, d, "high")
    nt = N // tile
    rp = row_offsets(prs, nt)
    mi = mask.to(torch.int32)
    e2 = eps2_f32(eps)
    centers = ck.pass_frames(xs, mask, tile, "high")[0]
    sub = min(tiles, nt)
    rp_sub = torch.cat([rp[:sub + 1], rp[sub].repeat(nt - sub)])
    m_sub = mask & (torch.arange(N, device=dev) < sub * tile)
    a_sub = (xs, mi, rp_sub, cols, e2, tile)
    kc = ck.count_pairs(*a_sub, centers)
    pc = ck.PLAIN["count_pairs"](*a_sub)
    core = (torch.clamp_min(ck.count_pairs(xs, mi, rp, cols, e2, tile,
                                           centers), 1) >= 10) & mask
    f = torch.where(core, torch.arange(N, device=dev, dtype=torch.int32),
                    INT_INF).contiguous()
    b_sub = (xs, f, rp_sub, cols, e2, tile)
    kb = ck.minlab_pairs(*b_sub, live_rows=mask)
    pb = ck.PLAIN["minlab_pairs"](*b_sub, live_rows=mask)
    bad_c = int((kc[m_sub] != pc[m_sub]).sum())
    bad_b = int((kb[m_sub] != pb[m_sub]).sum())
    err = {"count_pairs": int((kc[m_sub].long() - pc[m_sub].long()).abs()
                              .max()),
           "minlab_pairs": int((kb[m_sub].long() - pb[m_sub].long()).abs()
                               .max())}
    owned_rows = int(msk[:layout["cap"]].sum())
    log(f"    {what}: partition {p}'s slab ({owned_rows} owned of cap "
        f"{layout['cap']}, {sizes[p] - owned_rows} halo of hcap "
        f"{layout['hcap']}; tile {tile}, {total} live tile pairs), first "
        f"{sub} of {nt} row tiles ({int(m_sub.sum())} points): count_pairs "
        f"{bad_c} and minlab_pairs (round 1) {bad_b} points differ from "
        f"the plain versions")
    if bad_c or bad_b:
        fail(f"{what}: B1/B2 disagree with their plain versions on the "
             f"chained route's largest slab")
    if not int(m_sub.sum()) or not bool((pb[m_sub] != INT_INF).any()):
        fail(f"{what}: the held rows of the largest slab hold no label")
    return {"partition": p, "rows": N, "owned": owned_rows,
            "halo": sizes[p] - owned_rows, "tile": tile, "tiles_held": sub,
            "points_held": int(m_sub.sum()), "max_abs_err": err}


def chained_fit_recorded(torch, dev, sync, X, sizes=CHAINED_SIZES):
    """13.2's fit: the KD build and ``sharded_dbscan`` (B1/B2 counted
    from 0) under a fresh telemetry recorder with a resource sampler on
    ``dev``, the KD build as its ``partition`` phase and the route as
    its ``cluster`` phase, as a partitioned fit's report takes them.
    Returns ``((labels, core, stats), wall, kd_s, partitioner,
    recorded)``, ``recorded`` the inputs of the fit's report
    (:func:`chained_report`)."""
    from pypardis_tpu_torch import KDPartitioner, obs
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import sharded_dbscan
    from pypardis_tpu_torch.utils.profiling import PhaseTimer

    rec = obs.RunRecorder(device=dev)
    timer = PhaseTimer()
    sampler = obs.ResourceSampler(rec, device=dev).start()
    t_all = time.perf_counter()
    try:
        with obs.use_recorder(rec):
            with timer.phase("partition"):
                t = time.perf_counter()
                part = KDPartitioner(X, max_partitions=sizes["parts"])
                kd_s = time.perf_counter() - t
            ck.reset_launch_counts()
            with timer.phase("cluster"):
                sync()
                t = time.perf_counter()
                out = sharded_dbscan(X, part, eps=sizes["eps"],
                                     min_samples=10, block=sizes["block"],
                                     device=dev)
                sync()
                wall = time.perf_counter() - t
        total = time.perf_counter() - t_all
    finally:
        sampler.stop()
    recorded = dict(recorder=rec, stats=out[2], phases=timer.as_dict(),
                    total_s=total, n=len(X), d=X.shape[1],
                    eps=sizes["eps"], block=sizes["block"])
    return out, wall, kd_s, part, recorded


def chained_phase(torch, dev, sync, card="", sizes=CHAINED_SIZES,
                  main=None, cpu_refs=None, reports=None):
    """Phase 13 (the KD route's chained form on one card,
    ``pypardis_tpu_torch.parallel.sharded_dbscan``): (1) ``small_n``
    separated 16-D blobs over ``small_parts`` KD partitions, block
    ``small_block``: the card's labels and core flags byte-identical to
    the port's chained route on the CPU, under both merges and with
    ``overlap`` True and False; B1 launched once per partition and B2 once per
    other pass; ``emb_n`` x 512 embeddings over ``emb_parts`` partitions
    with the sketch on: B3/B4 launched likewise, byte-identical to the
    CPU's chained run; (2) the main path: phase 4's ``n`` x 16-D blobs,
    eps 2.4, min_samples 10, block 2048, ``KDPartitioner(max_partitions=
    parts)``, ``merge="auto"`` (the default), with
    B1/B2 counted from 0, held against the single-device fit (phase
    4's, or one fitted here) by :func:`hold_chained`; then B1/B2 against
    their plain versions on the largest slab of that path
    (:func:`chained_slab_hold`).  ``cpu_refs``: a
    :class:`ChainedCpuRefs` whose CPU runs of (1) are held once (3) is
    done (None: they run first, here).  Prints the fit's wall from host input
    split into the KD build, the halo sets, the host slab build, the
    per-partition device time (CUDA-event spans), the loop and the
    merge, with the geometry, merge and overlap stats.  (3) The first
    ``border_n`` points of the same data (over their own
    ``KDPartitioner``) at ``border_eps`` under ``merge="host"``, held
    against a single-device fit at that eps: it must hold border points,
    and each that another cluster takes must be an eps tie.  ``main``:
    ``dict(X=, labels=, core=)`` of phase 4's fit.  ``reports``: a dict
    that gains ``"chained"``, 13.2's report inputs
    (:func:`chained_fit_recorded`, for phase 14).  Returns the phase's
    record."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN, KDPartitioner
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import sharded_dbscan, staging

    rec = {"card": card}
    t_phase = time.perf_counter()

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def run(X, part, **kw):
        sync()
        t = time.perf_counter()
        out = sharded_dbscan(X, part, **kw)
        sync()
        return out, time.perf_counter() - t

    def same(a, b, what):
        ok = np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
        log(f"    {what}: labels and core byte-identical: {ok}")
        if not ok:
            fail(f"{what}: the chained fits differ")

    def split(what, st, wall, kd_s):
        ss = st["stage_s"]
        log(f"  {what}, {st['n_shard_partitions']} KD partitions: "
            f"{wall:.4f} s from host input on {card}; KD build {kd_s:.4f} s,"
            f" halo sets {ss['halo_sets']:.4f} s, host slab build "
            f"{ss['slab_build']:.4f} s, per-partition device "
            f"{ss['device']:.4f} s (CUDA-event spans), loop {ss['loop']:.4f}"
            f" s, merge {st['merge']} {ss['merge']:.4f} s "
            f"({st.get('merge_rounds')} rounds, "
            f"{st.get('merge_host_syncs')} host syncs)")
        log(f"    halo_factor {st['halo_factor']:.6f}, "
            f"duplicated_work_factor {st['duplicated_work_factor']:.6f}, "
            f"pad_waste {st['pad_waste']:.6f}, owned_cap {st['owned_cap']},"
            f" halo_cap {st['halo_cap']}, overlap_efficiency "
            f"{st.get('overlap_efficiency')}, live pairs "
            f"{st['live_pairs']}, kernel passes (max) "
            f"{st['kernel_passes']}, tile {st['kernel_block']}")
        return {
            "partitions": st["n_shard_partitions"], "wall_s": wall,
            "kd_build_s": kd_s, **{f"{k}_s": v for k, v in ss.items()},
            **{k: st.get(k) for k in (
                "halo_factor", "duplicated_work_factor", "pad_waste",
                "owned_cap", "halo_cap", "merge", "merge_rounds",
                "merge_host_syncs", "overlap_efficiency", "live_pairs",
                "kernel_passes")},
        }

    # 13.1: card against the CPU's chained route.  With ``cpu_refs``
    # (:class:`ChainedCpuRefs`) the CPU runs went on in a child process
    # beside the card's work and their gates close the phase; without,
    # they run here first.
    cases = chained_cpu_cases(sizes)
    (Xs, part_s, kw_s), (Xe, part_e, kw_e) = cases["small"], cases["emb"]
    cpu_now = None if cpu_refs else chained_cpu_runs(cases)
    staging.clear()  # a cold first fit
    ck.reset_launch_counts()
    ref, ref_s = run(Xs, part_s, device=dev, **kw_s)
    chained_launches(ck, ref[2], f"13.1 n={len(Xs)} d=16")
    log(f"  13.1 n={len(Xs)} d=16, {ref[2]['n_shard_partitions']} "
        f"partitions: card {ref_s:.4f} s; clusters "
        f"{len(np.unique(ref[0][ref[0] >= 0]))}, halo_factor "
        f"{ref[2]['halo_factor']:.4f}, merge {ref[2]['merge']} "
        f"({ref[2].get('merge_rounds')} rounds)")
    variants = {}
    for merge in ("device", "host"):
        for overlap in (True, False):
            variants[merge, overlap] = run(
                Xs, part_s, device=dev, merge=merge, overlap=overlap, **kw_s)
    # The variants refit ``ref``'s data: warm (the staging cache's
    # chained routes hold its slabs), building and shipping nothing.
    cold_b = ref[2]["staged_bytes"]
    warm = {f"{m}/{o}": (out[2]["staged_bytes"],
                         out[2]["staged_bytes_reused"], s_)
            for (m, o), (out, s_) in variants.items()}
    log(f"  13.1 staging: the first fit staged {cold_b} bytes "
        f"({ref_s:.4f} s); the refits (staged, reused, s): {warm}")
    if not cold_b or any(
            st_ or re_ != cold_b for st_, re_, _s in warm.values()):
        fail("13.1: the chained refits were not warm staging hits")
    rec["staging"] = {"cold_staged_bytes": cold_b, "cold_s": ref_s,
                      "warm": warm}
    ck.reset_launch_counts()
    emb, emb_s = run(Xe, part_e, device=dev, **kw_e)
    chained_launches(ck, emb[2], f"13.1 n={len(Xe)} d=512",
                     "count_pairs_sketch", "minlab_pairs_sketch")
    log(f"  13.1 n={len(Xe)} d=512, {emb[2]['n_shard_partitions']} "
        f"partitions, sketch_k {emb[2]['sketch_k']}: card {emb_s:.4f} s; "
        f"clusters {len(np.unique(emb[0][emb[0] >= 0]))}")
    rec["small"] = {"n": len(Xs), "card_s": ref_s,
                    "halo_factor": ref[2]["halo_factor"],
                    "emb_n": len(Xe), "emb_card_s": emb_s}
    stamp("13.1: card runs done")

    def close_13_1():
        cpu = cpu_now or cpu_refs.result(cases)
        (c_small, c_s), (c_emb, c_emb_s) = cpu["small"], cpu["emb"]
        log(f"  13.1 on the CPU: n={len(Xs)} d=16 {c_s:.4f} s, "
            f"n={len(Xe)} d=512 {c_emb_s:.4f} s"
            f"{' (in a child process)' if cpu_refs else ''}")
        same(ref, c_small, "13.1 card vs CPU")
        for (merge, overlap), (out, s) in variants.items():
            same(out, c_small, f"13.1 card merge={merge} overlap={overlap} "
                 f"({s:.4f} s) vs CPU")
        same(emb, c_emb, "13.1 sketched card vs CPU")
        rec["small"].update(cpu_s=c_s, emb_cpu_s=c_emb_s)
        stamp("13.1: done")

    # 13.2: the main path at phase 4's size.
    n, eps = sizes["n"], sizes["eps"]
    if main is None:
        X, _truth = make_blob_data(n, 16, n_centers=32, std=0.4)
        single = DBSCAN(eps=eps, min_samples=10, block=sizes["block"],
                        device=dev).fit(X)
        main = dict(X=X, labels=single.labels_,
                    core=single.core_sample_mask_)
    X = main["X"]
    (lab, core, st), wall, kd_s, part, recorded = chained_fit_recorded(
        torch, dev, sync, X, sizes)
    if reports is not None:
        reports["chained"] = recorded
    la = chained_launches(ck, st, f"13.2 n={n} d=16")
    rec["main"] = {"n": n, **split(f"13.2 n={n} d=16", st, wall, kd_s)}
    clusters, borders, noise, differ = hold_chained(
        torch, dev, X, eps, lab, core, main["labels"], main["core"], "13.2")
    rec["main"].update(
        launches={"count_pairs": la["count_pairs"],
                  "minlab_pairs": la["minlab_pairs"]},
        clusters=clusters, borders=borders, noise=noise,
        borders_differ=differ)
    del lab, core, main
    stamp("13.2: the fit held")
    rec["main"]["slab_hold"] = chained_slab_hold(
        torch, dev, X, part, eps, sizes["block"], sizes["hold_tiles"],
        "13.2 largest slab")
    stamp("13.2: done")

    # 13.3: border points, through the host merge.
    b_eps, nb = sizes["border_eps"], sizes.get("border_n", n)
    Xb = X[:nb]
    t = time.perf_counter()
    part_b = part if nb == n else KDPartitioner(
        Xb, max_partitions=sizes["parts"])
    kd_b = kd_s if nb == n else time.perf_counter() - t
    single = DBSCAN(eps=b_eps, min_samples=10, block=sizes["block"],
                    device=dev).fit(Xb)
    ck.reset_launch_counts()
    (lab, core, st), wall = run(Xb, part_b, eps=b_eps, min_samples=10,
                                block=sizes["block"], merge="host",
                                device=dev)
    chained_launches(ck, st, f"13.3 n={nb} d=16 eps={b_eps}")
    rec["border"] = {"n": nb, "eps": b_eps, **split(
        f"13.3 n={nb} d=16 eps={b_eps}", st, wall, kd_b)}
    clusters, borders, noise, differ = hold_chained(
        torch, dev, Xb, b_eps, lab, core, single.labels_,
        single.core_sample_mask_, "13.3")
    if not borders:
        fail("13.3: the data holds no border point, so the border check "
             "proves nothing")
    rec["border"].update(clusters=clusters, borders=borders, noise=noise,
                         borders_differ=differ)
    stamp("13.3: done")
    close_13_1()
    return rec


# Phase 14: run reports and tracing.  Phase 4's 1M x 16-D fit from host
# input as PERF.md last recorded it before the spans (PRs 10-16, my chip
# runs; NVIDIA H100 80GB HBM3, 700 W), and from a CUDA tensor as PRs
# 15-16's full runs read it: printed beside this run's walls.
FIT_1M_HOST_S_BEFORE = (0.3145, 0.3594)
FIT_1M_TENSOR_S_BEFORE = (0.1001, 0.1141)
# The 200k fit of 14.4 writes its flight file here, the 1M fit's trace
# too; both are removed once read.
OBS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_obs")


def fit_record(model, wall):
    """What phase 14 reads of a fit: its ``report()``, its wall (timed
    around ``fit``), its ``metrics_`` and its ``export_trace`` file
    (under :data:`OBS_DIR`)."""
    os.makedirs(OBS_DIR, exist_ok=True)
    return dict(report=model.report(), wall=wall,
                metrics=dict(model.metrics_),
                trace=model.export_trace(os.path.join(
                    OBS_DIR, f"trace_{os.getpid()}.json")))


def nonfinite(obj, path="report"):
    """Paths of the non-finite numbers in a JSON-like object."""
    if isinstance(obj, dict):
        return [p for k, v in obj.items() for p in nonfinite(v, f"{path}.{k}")]
    if isinstance(obj, (list, tuple)):
        return [p for i, v in enumerate(obj)
                for p in nonfinite(v, f"{path}[{i}]")]
    if isinstance(obj, float) and not np.isfinite(obj):
        return [path]
    return []


def chained_report(recorded):
    """13.2's report, built from the route's stats as ``report()``
    builds a fit's: the stats and the fit's phases as its metrics, the
    recorder's spans, events and watermarks."""
    from pypardis_tpu_torch import obs

    r = recorded
    metrics = dict(r["stats"], **r["phases"], total_s=r["total_s"],
                   points_per_sec=r["n"] / max(r["total_s"], 1e-9))
    return obs.build_run_report(
        r["recorder"],
        params={"eps": r["eps"], "min_samples": 10, "block": r["block"],
                "precision": "high", "merge": r["stats"]["merge"]},
        n_points=r["n"], n_dims=r["d"], n_devices=1, backend="cuda",
        metrics=metrics)


def report_gates(torch, dev, rep, metrics, what):
    """14.2's gates on one report: JSON, the schema, finite numbers, the
    H100 peak row, a positive achieved rate, the compute counts equal to
    the fit's metrics, phases within the run's wall and the device
    watermark within ``max_memory_allocated``."""
    from pypardis_tpu_torch import obs

    text = json.dumps(rep)
    if rep.get("schema") != obs.REPORT_SCHEMA:
        fail(f"14.2 {what}: schema {rep.get('schema')!r}")
    bad = nonfinite(json.loads(text))
    if bad:
        fail(f"14.2 {what}: non-finite numbers at {bad[:5]}")
    comp, res = rep["compute"], rep["resources"]
    if comp["peak_source"] != "table:h100":
        fail(f"14.2 {what}: peak_source {comp['peak_source']!r}, not the "
             f"H100 row")
    if not comp["achieved_flops_per_sec"] > 0:
        fail(f"14.2 {what}: achieved_flops_per_sec "
             f"{comp['achieved_flops_per_sec']}")
    for k in ("live_pairs", "kernel_passes"):
        if comp[k] != int(metrics[k]):
            fail(f"14.2 {what}: compute.{k} {comp[k]} != {metrics[k]}")
    phases = sum(rep["phases"].values())
    if phases > rep["run"]["total_s"] * 1.01:
        fail(f"14.2 {what}: the phases sum to {phases:.6f} s, past the "
             f"run's {rep['run']['total_s']:.6f} s")
    fb = rep["faults"]
    if (fb["injected"], fb["retried"], fb["giveups"], fb["degraded"]) != (
            0, 0, 0, 0):
        fail(f"14.2 {what}: a clean run's faults block is {fb}")
    peak = res["peak_device_bytes"]
    high = torch.cuda.max_memory_allocated(dev)
    if not 0 < peak <= high:
        fail(f"14.2 {what}: peak_device_bytes {peak} outside (0, "
             f"max_memory_allocated {high}]")
    log(f"  14.2 {what}: {len(text)} bytes of JSON, phases "
        f"{json.dumps(rep['phases'])} of {rep['run']['total_s']:.6f} s, "
        f"model mfu {comp['mfu']:.8f} ({comp['achieved_flops_per_sec']:.1f}"
        f" model FLOP/s of {comp['peak_flops']:.3g} {comp['peak_source']}), "
        f"peak device {peak} of max_memory_allocated {high}, "
        f"{res['samples']} samples, events {json.dumps(rep['events'])}")
    for line in obs.format_summary(rep).splitlines():
        log(f"    {line}")
    return {"phases": rep["phases"], "total_s": rep["run"]["total_s"],
            "mfu": comp["mfu"], "peak_device_bytes": peak,
            "samples": res["samples"]}


def sync_hold(torch, dev, ck, a, centers):
    """14.1: one B1 launch on phase 4's 1M layout inside a span with
    ``sync_on(out)``, CUDA events recorded around the launch; the span
    must cover the events' elapsed time.  The same span without
    ``sync_on`` is printed beside it (it closes when the launch is
    queued)."""
    from pypardis_tpu_torch import obs

    tr = obs.Tracer(device=dev)
    out = {}
    for name, wait in (("b1.sync_on", True), ("b1.queued", False)):
        torch.cuda.synchronize(dev)
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with tr.span(name) as sp:
            s.record()
            got = ck.count_pairs(*a, centers)
            e.record()
            if wait:
                sp.sync_on(got)
        span_ms = tr.spans[-1].dur_s * 1e3
        e.synchronize()
        out[name] = (span_ms, s.elapsed_time(e))
    span_ms, ev_ms = out["b1.sync_on"]
    log(f"  14.1 B1 on phase 4's 1M layout: span with sync_on {span_ms:.4f} "
        f"ms >= CUDA events {ev_ms:.4f} ms; the same span without sync_on "
        f"{out['b1.queued'][0]:.4f} ms (events {out['b1.queued'][1]:.4f} ms)")
    if span_ms < ev_ms:
        fail(f"14.1: the span with sync_on ({span_ms:.4f} ms) is shorter "
             f"than the launch's events ({ev_ms:.4f} ms)")
    return {"sync_on_ms": span_ms, "events_ms": ev_ms,
            "queued_ms": out["b1.queued"][0]}


def trace_hold(fit1m):
    """14.3: the fit's ``export_trace`` file (``fit1m["trace"]``, removed
    once read) loads as JSON and holds the ``pipeline.layout``,
    ``pipeline.cluster``, ``cluster`` and ``densify`` spans, every span
    inside the fit's wall (``fit1m["wall"]``, measured around ``fit``)."""
    with open(fit1m["trace"]) as f:
        doc = json.load(f)
    os.remove(fit1m["trace"])
    xs = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    names = [e["name"] for e in xs]
    wall_us = fit1m["wall"] * 1e6
    outside = [e["name"] for e in xs
               if e["ts"] < 0 or e["ts"] + e["dur"] > wall_us]
    log(f"  14.3 the fit's trace: {len(xs)} spans {names}, all inside its "
        f"{fit1m['wall']:.6f} s wall: {not outside}")
    for need in ("pipeline.layout", "pipeline.cluster", "cluster",
                 "densify"):
        if need not in names:
            fail(f"14.3: the fit's trace has no {need} span")
    if outside:
        fail(f"14.3: spans {outside} lie outside the fit's wall")
    return {"spans": names}


def flight_hold(X, dev, eps=2.4, block=2048):
    """14.4: ``X`` fitted with ``flight=`` (a file under
    :data:`OBS_DIR`, removed once read); its ``replay`` must be complete
    and give the live tracer's span names in order and ``report()``'s
    phase names."""
    from pypardis_tpu_torch import DBSCAN, obs

    os.makedirs(OBS_DIR, exist_ok=True)
    path = os.path.join(OBS_DIR, f"flight_{os.getpid()}.jsonl")
    if os.path.exists(path):
        os.remove(path)
    model = DBSCAN(eps=eps, min_samples=10, block=block, device=dev,
                   flight=path).fit(X)
    rp = obs.replay(path)
    os.remove(path)
    live = [sp.name for sp in model._recorder.tracer.spans]
    got = [e["name"] for e in rp.to_chrome_trace()["traceEvents"]
           if e.get("ph") == "X"]
    phases_live = sorted(model.report()["phases"])
    phases_rp = sorted(rp.report()["phases"])
    log(f"  14.4 n={len(X)} fit with flight=: {rp.records} records, "
        f"complete {rp.complete}, replayed spans {got} (live {live}), "
        f"phases {phases_rp} (report() {phases_live})")
    if not rp.complete or rp.status != "ok" or got != live:
        fail("14.4: the flight file's replay differs from the live tracer")
    if phases_rp != phases_live:
        fail("14.4: the replayed report's phases differ from report()'s")
    return {"records": rp.records, "spans": got}


def report_phase(torch, dev, card, ck, sync_args, fit1m, chained, X200,
                 fit_walls):
    """Phase 14 (run reports and tracing): 14.1 :func:`sync_hold`; 14.2
    :func:`report_gates` on phase 4's first 1M fit's ``report()`` and on
    13.2's chained fit's (:func:`chained_report`); 14.3 that fit's
    ``export_trace`` loads and holds the pipeline and phase spans inside
    the fit's wall; 14.4 phase 4's 200k data fitted with ``flight=`` and
    ``replay``: the same span names in the same order as the live
    tracer, the same phase names as ``report()``.  ``fit1m``:
    ``dict(report=, trace=, wall=, metrics=)`` of phase 4's fit;
    ``fit_walls``: phase 4's 1M walls (two from host input, then any
    from a CUDA tensor), printed beside :data:`FIT_1M_HOST_S_BEFORE`
    and :data:`FIT_1M_TENSOR_S_BEFORE`.  Returns the phase's record."""
    rec = {"card": card}
    rec["sync"] = sync_hold(torch, dev, ck, *sync_args)
    rec["fit_1m"] = report_gates(torch, dev, fit1m["report"],
                                 fit1m["metrics"], "phase 4's 1M fit")
    rec["chained"] = report_gates(torch, dev, chained_report(chained),
                                  chained["stats"], "13.2's chained fit")
    rec["trace"] = trace_hold(fit1m)
    rec["flight"] = flight_hold(X200, dev)
    for what, walls, (lo, hi) in (
            ("host input", fit_walls[:2], FIT_1M_HOST_S_BEFORE),
            ("a CUDA tensor", fit_walls[2:], FIT_1M_TENSOR_S_BEFORE)):
        if walls:
            log(f"  phase 4's 1M fit from {what} with the spans on: "
                f"{', '.join(f'{w:.4f}' for w in walls)} s, against "
                f"{lo}-{hi} s before them (PERF.md); {card}")
    rec["fit_1m_host_s"] = list(fit_walls[:2])
    rec["fit_1m_tensor_s"] = list(fit_walls[2:])
    return rec


# Phase 15: faults, retry, jobstate and resume.  The 1M fit's stepped
# route at a threshold below its capacity, the SIGKILL child's hang per
# round batch, and where the snapshots go.
FAULT_SIZES = {"step_threshold": 1, "kill_hang_s": 1.0, "kill_attempts": 3,
               "drain_hang_s": 0.3, "drain_timeout_s": 0.05, "nq": 4096}
FAULT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "build", "chip_smoke_faults")


@contextlib.contextmanager
def env_set(**kw):
    """Set environment knobs for a block (None unsets), then restore."""
    prev = {k: os.environ.get(k) for k in kw}
    try:
        for k, v in kw.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = str(v)
        yield
    finally:
        for k, v in prev.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def builder_threads():
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith("pptorch-slab-builder")]


def faults_child(path):
    """The SIGKILL child of 15.3 (``chip_smoke.py --faults-child PATH``):
    phase 4's 1M x 16-D fit from host input with the knobs its parent
    set (``PPTORCH_CKPT=PATH``, a hang before each round batch); it is
    killed once its snapshot exists."""
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.csrc import _build

    _build.load()
    X, _truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
    log(f"child: fitting with PPTORCH_CKPT={os.environ.get('PPTORCH_CKPT')}")
    DBSCAN(eps=2.4, min_samples=10, block=2048).fit(X)
    log("child: the fit finished")


def faults_phase(torch, dev, sync, card, main, b1_args, live, chained_case,
                 sizes=FAULT_SIZES):
    """Phase 15 (faults, retry, jobstate and resume), on data and models
    the script already has.  ``main``: ``dict(X=, labels=, core=,
    walls=)`` of phase 4's 1M x 16-D fused fits from host input;
    ``b1_args``: phase 5's B1 inputs ``(a, centers)``; ``live``: phase
    11's live model (its engine serves 15.6); ``chained_case``: 13.1's
    20,000 x 16-D case ``(X, partitioner, kwargs)``.

    (1) the stepped route (``PPTORCH_STEP_THRESHOLD`` 1) on the 1M data,
    twice: labels and core bytes equal to phase 4's fused fit, B1 once, B2 = passes - 1, ``report()["stepped"]
    ["batches"]`` >= 1; (2) ``PPTORCH_ROUND_BATCH=1`` and
    ``stepped.batch:2=error`` under ``train(resume=)`` raise
    ``FaultInjected``; a fresh ``train(resume=)`` restores >= 1 batch
    (``events.jobstate_restore`` >= 1) to 15.1's labels; (3) a child
    process runs that fit with ``PPTORCH_CKPT`` and a hang before each
    batch and is SIGKILLed once its snapshot exists (up to 3 attempts);
    the resume in process gives 15.1's labels; (4) the chained route on
    13.1's case: partition 5's terminal error with a jobstate, then a
    resume that restores exactly 4 partitions; a transfer error at
    partition 2 retried (``faults.injected`` 1, ``retried`` >= 1); an
    OOM at partition 3 raised; an OOM of the device merge
    (``sharded.execute``) degrading to ``merge_host`` with no partition
    dispatched again; each equal to the clean run, and no slab-builder
    thread alive after a failed attempt; (5) an allocation past the
    card's free memory raises ``torch.OutOfMemoryError``, classified OOM
    and not transient, and B1 right after it is bitwise its plain
    version on phase 5's first 64 row tiles; (6) on the live model's
    engine ``serve.drain:1=hang`` fails a ticket with a deadline by
    ``DeadlineExceeded`` (``deadline_failures`` + 1), the next request
    is bitwise the card oracle, and ``ingest.batch:1=error`` leaves the
    index's slab and B5's tables bitwise as before.  Returns the phase's
    record."""
    import signal

    from pypardis_tpu_torch import DBSCAN, obs
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import counts_over_pairs
    from pypardis_tpu_torch.parallel import sharded_dbscan
    from pypardis_tpu_torch.serve.engine import DeadlineExceeded
    from pypardis_tpu_torch.utils import faults
    from pypardis_tpu_torch.utils.jobstate import JobState, fit_meta
    from pypardis_tpu_torch.utils.retry import (
        is_oom_error, is_transient_error,
    )

    rec = {"card": card}
    t_phase = time.perf_counter()
    os.makedirs(FAULT_DIR, exist_ok=True)
    X = main["X"]
    kw = dict(eps=2.4, min_samples=10, block=2048)

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def same(lab, core, want_lab, want_core, what):
        ok = (lab.tobytes() == want_lab.tobytes()
              and core.tobytes() == want_core.tobytes())
        log(f"    {what}: labels and core byte-identical: {ok}")
        if not ok:
            fail(f"15: {what} differs")

    def fit(resume=None):
        model = DBSCAN(**kw)
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model.train(X, resume=resume)
        sync()
        return model, time.perf_counter() - t, dict(ck.LAUNCHES)

    def launches_gate(model, la, what):
        passes = int(model.metrics_["kernel_passes"])
        b1, b2 = la["count_pairs"], la["minlab_pairs"]
        others = {k: v for k, v in la.items()
                  if k not in ("count_pairs", "minlab_pairs") and v}
        log(f"    {what}: launches B1={b1} B2={b2}, passes {passes}, "
            f"other kernels {others}")
        if b1 != 1 or b2 != passes - 1 or others:
            fail(f"15: {what}: launches B1={b1} B2={b2} against passes "
                 f"{passes} (want B1=1, B2=passes-1, nothing else)")

    # 15.1: the stepped route, two fits for two walls.
    walls = {}
    step_env = dict(PPTORCH_STEP_THRESHOLD=sizes["step_threshold"],
                    PPTORCH_ROUND_BATCH=None)
    for name in ("first", "second"):
        with env_set(**step_env):
            model, wall, la = fit()
        st = model.report()["stepped"]
        log(f"  15.1 {name}: {wall:.4f} s from host input on {card} "
            f"(phase 4 fused: {main['walls']}); stepped {json.dumps(st)}")
        same(model.labels_, model.core_sample_mask_, main["labels"],
             main["core"], f"15.1 {name} stepped fit vs phase 4's fused fit")
        launches_gate(model, la, f"15.1 {name}")
        if st["batches"] < 1:
            fail("15.1: the stepped route ran no batch")
        walls[name] = wall
        rec[f"stepped_{name}"] = dict(
            wall_s=wall, stepped=st, passes=model.metrics_["kernel_passes"],
            launches={k: v for k, v in la.items() if v})
    stamp("15.1: the stepped route done")

    # 15.2: resume in process, after the snapshots' cost: the same
    # one-round-batch fit without and with a checkpoint (a (capk,)
    # int32 copy to the host and an atomic .npz rewrite per batch), and
    # one snapshot timed alone.
    path = os.path.join(FAULT_DIR, f"resume_{os.getpid()}.npz")
    with env_set(PPTORCH_STEP_THRESHOLD=sizes["step_threshold"],
                 PPTORCH_ROUND_BATCH=1):
        _m, wall_plain, _la = fit()
        model, wall_ckpt, _la = fit(resume=path)
        batches = model.report()["stepped"]["batches"]
        os.remove(path)
        capk = len(model._jobstate._stepped[0])
        f = torch.arange(capk, dtype=torch.int32, device=dev)
        js = JobState.open(path, model._jobstate.meta)
        sync()
        t = time.perf_counter()
        js.stepped_note(f.cpu().numpy(), 1, 0)
        note_s = time.perf_counter() - t
        os.remove(path)
        log(f"  15.2: a one-round-batch stepped fit {wall_plain:.4f} s "
            f"without a checkpoint, {wall_ckpt:.4f} s with one ({batches}"
            f" snapshots); one snapshot of {capk} slots {note_s * 1e3:.3f}"
            f" ms (copy to the host and .npz write) on {card}")
        rec["snapshot"] = dict(wall_plain_s=wall_plain,
                               wall_ckpt_s=wall_ckpt, batches=batches,
                               note_ms=note_s * 1e3, slots=capk)
        with faults.plan("stepped.batch:2=error"):
            try:
                fit(resume=path)
                fail("15.2: stepped.batch:2=error did not raise")
            except faults.FaultInjected as e:
                log(f"  15.2: the fault raised FaultInjected: {e}")
        model, wall, la = fit(resume=path)
    js = model._jobstate
    r = model.report()
    restores = r["metrics"]["counters"].get("events.jobstate_restore", 0)
    log(f"  15.2: resumed in {wall:.4f} s, restored {js.restored_rounds} "
        f"batches, events.jobstate_restore {restores}, stepped "
        f"{json.dumps(r['stepped'])}")
    same(model.labels_, model.core_sample_mask_, main["labels"],
         main["core"], "15.2 the resumed fit vs 15.1")
    launches_gate(model, la, "15.2 resumed")
    if js.restored_rounds < 1 or restores < 1:
        fail("15.2: the resume restored no batch")
    rec["resume"] = dict(wall_s=wall, restored=js.restored_rounds,
                         passes=model.metrics_["kernel_passes"],
                         launches={k: v for k, v in la.items() if v})
    os.remove(path)
    stamp("15.2: resume in process done")

    # 15.3: SIGKILL a child mid-fit, resume here.
    path = os.path.join(FAULT_DIR, f"kill_{os.getpid()}.npz")
    killed, attempts = False, 0
    torch.cuda.empty_cache()
    child_env = dict(os.environ, PPTORCH_CKPT=path,
                     PPTORCH_STEP_THRESHOLD=str(sizes["step_threshold"]),
                     PPTORCH_ROUND_BATCH="1",
                     PPTORCH_FAULTS=f"stepped.batch:*=hang("
                                    f"{sizes['kill_hang_s']})")
    logf = path + ".log"
    while not killed and attempts < sizes["kill_attempts"]:
        attempts += 1
        if os.path.exists(path):
            os.remove(path)
        with open(logf, "w") as lf:
            child = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--faults-child",
                 path], env=child_env, stdout=lf, stderr=subprocess.STDOUT,
                cwd=os.path.dirname(os.path.abspath(__file__)))
            t0 = time.perf_counter()
            try:
                while (not os.path.exists(path) and child.poll() is None
                       and time.perf_counter() - t0 < 300):
                    time.sleep(0.02)
                if child.poll() is None and os.path.exists(path):
                    child.send_signal(signal.SIGKILL)
                    killed = child.wait(timeout=60) == -signal.SIGKILL
            finally:
                if child.poll() is None:
                    child.kill()
                    child.wait()
        log(f"  15.3 attempt {attempts}: the snapshot appeared after "
            f"{time.perf_counter() - t0:.2f} s; child killed mid-fit: "
            f"{killed} (exit {child.returncode})")
    if not killed:
        with open(logf) as lf:
            fail(f"15.3: no child was killed mid-fit in {attempts} "
                 f"attempts: {lf.read()[-2000:]}")
    with env_set(PPTORCH_STEP_THRESHOLD=sizes["step_threshold"],
                 PPTORCH_ROUND_BATCH=1):
        model, wall, la = fit(resume=path)
    log(f"  15.3: resumed in {wall:.4f} s from the killed child's snapshot,"
        f" restored {model._jobstate.restored_rounds} batches")
    same(model.labels_, model.core_sample_mask_, main["labels"],
         main["core"], "15.3 resume after SIGKILL vs 15.1")
    if model._jobstate.restored_rounds < 1:
        fail("15.3: the resume restored no batch")
    rec["sigkill"] = dict(attempts=attempts, wall_s=wall,
                          restored=model._jobstate.restored_rounds)
    for f in (path, logf):
        if os.path.exists(f):
            os.remove(f)
    stamp("15.3: SIGKILL and resume done")

    # 15.4: the chained route.
    Xc, part, ckw = chained_case

    def chained(plan, merge="device", jobstate=None):
        r_ = obs.RunRecorder(device=dev)
        ck.reset_launch_counts()
        err = None
        with obs.use_recorder(r_), faults.plan(plan):
            try:
                out = sharded_dbscan(Xc, part, merge=merge,
                                     jobstate=jobstate, **ckw)
            except faults.FaultInjected as e:
                out, err = None, e
        threads = builder_threads()
        if threads:
            fail(f"15.4 {plan}: builder threads alive after the attempt: "
                 f"{threads}")
        c = r_.metrics.as_dict()["counters"]
        block = dict(
            injected=int(c.get("faults.injected", 0)),
            retried=int(sum(v for k, v in c.items() if k.startswith(
                "retry.") and k.endswith(".attempts"))),
            degraded_to=str(r_.metrics.gauge("faults.degraded_to", "")))
        return out, err, block, dict(ck.LAUNCHES)

    clean, _err, _block, clean_la = chained("")
    path = os.path.join(FAULT_DIR, f"chained_{os.getpid()}.npz")
    meta = fit_meta(Xc, eps=ckw["eps"], min_samples=ckw["min_samples"],
                    metric="euclidean", block=ckw["block"], mode="kd")
    out, err, block, _la = chained("chained.partition:5=error",
                                   jobstate=JobState.open(path, meta))
    if err is None:
        fail("15.4: chained.partition:5=error did not raise")
    js = JobState.open(path, meta, resume=True)
    out, err, block, la = chained("", jobstate=js)
    log(f"  15.4 resume: restored {js.restored_partitions} partitions, "
        f"launches B1={la['count_pairs']} B2={la['minlab_pairs']} "
        f"(passes {out[2]['partition_passes']})")
    same(out[0], out[1], clean[0], clean[1], "15.4 resumed chained fit")
    if js.restored_partitions != 4 or la["count_pairs"] != 4:
        fail(f"15.4: the resume restored {js.restored_partitions} "
             f"partitions and dispatched {la['count_pairs']} (want 4, 4)")
    os.remove(path)
    out, err, block, _la = chained("chained.partition:2=transfer_error")
    log(f"  15.4 transfer_error: faults {block}")
    same(out[0], out[1], clean[0], clean[1], "15.4 retried chained fit")
    if block["injected"] != 1 or block["retried"] < 1:
        fail(f"15.4: the transfer error was not retried: {block}")
    # An OOM in a partition's dispatch raises (the host merge would not
    # cure it); an OOM of the device merge finishes it on the host from
    # the run's tables, every partition dispatched once.
    out, err, block, _la = chained("chained.partition:3=oom")
    log(f"  15.4 dispatch oom: raised {type(err).__name__}, faults {block}")
    if err is None or block["injected"] != 1 or block["degraded_to"]:
        fail(f"15.4: an OOM in a dispatch did not raise: {block}")
    out, err, block, la = chained("sharded.execute:1=oom")
    log(f"  15.4 merge oom: faults {block}, merge {out[2]['merge']}, "
        f"launches B1={la['count_pairs']} (clean {clean_la['count_pairs']})")
    same(out[0], out[1], clean[0], clean[1], "15.4 spilled chained fit")
    if block["degraded_to"] != "merge_host" or out[2]["merge"] != "host":
        fail(f"15.4: the merge's OOM did not spill to the host: {block}")
    if la["count_pairs"] != clean_la["count_pairs"]:
        fail("15.4: the spill dispatched the partitions again")
    rec["chained"] = dict(restored=4, spill=block)
    stamp("15.4: the chained route's resume, retry and spill done")

    # 15.5: a real OOM is an OOM and not sticky.
    free, total = torch.cuda.mem_get_info(dev)
    try:
        torch.empty(free + (4 << 30), dtype=torch.uint8, device=dev)
        fail("15.5: an allocation past the free memory did not raise")
    except torch.OutOfMemoryError as e:
        oom, trans = is_oom_error(e), is_transient_error(e)
        log(f"  15.5: torch.OutOfMemoryError for {free + (4 << 30)} bytes "
            f"({free} free of {total}); is_oom_error {oom}, "
            f"is_transient_error {trans}")
        if not oom or trans:
            fail("15.5: the real OOM is misclassified")
    a, centers = b1_args
    nt = a[0].shape[1] // a[5]
    sub = min(64, nt)
    rp = a[2]
    rp_sub = torch.cat([rp[:sub + 1], rp[sub].repeat(nt - sub)])
    a_sub = a[:2] + (rp_sub,) + a[3:]
    got = ck.count_pairs(*a_sub, centers)
    ok = torch.equal(got, counts_over_pairs(*a_sub))
    log(f"  15.5: B1 after the OOM bitwise its plain version on the first "
        f"{sub} row tiles: {ok}")
    if not ok:
        fail("15.5: B1 after the OOM differs from its plain version")
    stamp("15.5: the real OOM done")

    # 15.6: serving: a drain deadline and an ingest fault.
    eng = live.engine
    rng = np.random.default_rng(15)
    Q = live.points()[rng.integers(0, len(live.points()), sizes["nq"])]
    Q = Q + rng.normal(scale=0.05, size=Q.shape)
    before = eng.serving_stats()["deadline_failures"]
    with faults.plan(f"serve.drain:1=hang({sizes['drain_hang_s']})"):
        t = eng.submit(Q, timeout_s=sizes["drain_timeout_s"])
        eng.drain()
    try:
        t.result()
        fail("15.6: the stalled ticket did not fail")
    except DeadlineExceeded as e:
        log(f"  15.6: the stalled ticket failed: {e}")
    moved = eng.serving_stats()["deadline_failures"] - before
    t = eng.submit(Q)
    eng.drain()
    want = index_oracle(torch, live.index, Q)
    ok = (np.array_equal(t.labels, want[0]) and np.array_equal(
        np.asarray(t.d2, np.float32).view(np.int32),
        np.asarray(want[1], np.float32).view(np.int32)))
    log(f"  15.6: deadline_failures +{moved}; the next request of "
        f"{len(Q)} bitwise the card oracle: {ok}")
    if moved != 1 or not ok:
        fail("15.6: the drain deadline or the next request failed")
    idx = live.index
    snap = [x.clone() for x in idx.device_tensors()] + [
        x.clone() for x in idx.kernel_tables()]
    pts0 = live.points().copy()
    with faults.plan("ingest.batch:1=error"):
        try:
            live.insert_batch(Q[:64])
            fail("15.6: ingest.batch:1=error did not raise")
        except faults.FaultInjected:
            pass
    now = list(idx.device_tensors()) + list(idx.kernel_tables())
    same_t = all(torch.equal(x, y) for x, y in zip(snap, now))
    hold_index(torch, ck, idx, dev, "15.6's failed ingest batch")
    log(f"  15.6: after the failed ingest batch the slab and B5's tables "
        f"are bitwise as before: {same_t}; points unchanged: "
        f"{np.array_equal(live.points(), pts0)}")
    if not same_t or not np.array_equal(live.points(), pts0):
        fail("15.6: the failed ingest batch changed the live model")
    rec["serving"] = dict(deadline_failures=moved)
    rec["walls"] = walls
    stamp("15.6: serving done")
    return rec


# Phase 16: the global-Morton route's chained form.  16.1 reuses 13.1's
# data (the 20,000 x 16-D separated blobs over small_ranges ranges in
# each mode, the 4,096 x 512 embeddings over emb_ranges with the sketch
# on); 16.2 phase 4's 1M x 16-D blobs from a float32 memmap under
# build/, over `ranges` ranges at eps and (its first border_n points, the
# whole 1M until phase 17 took its time) at border_eps; 16.3 phase 7's
# 100k x 512 embeddings over sk_ranges; 16.4 16.1's 20k case.
GM_SIZES = {"small_ranges": 4, "gm_modes": ["high", "mixed", "default"],
            "emb_ranges": 2, "n": 1_000_000, "eps": 2.4, "ranges": 4,
            "block": 2048, "hold_tiles": 64, "border_eps": 1.4,
            "border_n": 200_000,
            "sk_n": 100_000, "sk_eps": 2.0, "sk_ranges": 2,
            "sk_block": 2048}
GM_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "chip_smoke_gm")
# The B1/B2 (B3/B4) names of each precision mode's passes.
GM_KERNELS = {"high": ("count_pairs", "minlab_pairs"),
              "mixed": ("count_pairs_mixed", "minlab_pairs_mixed"),
              "default": ("count_pairs_default", "minlab_pairs_default"),
              "sketch": ("count_pairs_sketch", "minlab_pairs_sketch")}


def gm_cpu_cases(sizes):
    """16.1's cases from 13.1's data: ``{name: (X, chain, kwargs)}``,
    the 20k case once per mode of ``gm_modes``."""
    kd = chained_cpu_cases(sizes)
    (Xs, _p, kw_s), (Xe, _pe, kw_e) = kd["small"], kd["emb"]
    out = {f"small_{m}": (Xs, sizes["small_ranges"], dict(kw_s, precision=m))
           for m in sizes["gm_modes"]}
    out["emb"] = (Xe, sizes["emb_ranges"], dict(kw_e, precision="high"))
    return out


# The staging cache's counters: what the cache held before a fit, not
# what the fit computed (a warm run reuses what a cold one ships).
STAGING_COUNTERS = ("staged_bytes", "staged_bytes_reused")


def gm_stats(stats):
    """A chained GM fit's stats without its timings and the staging
    cache's counters: what the card's run and the CPU's must share."""
    return {k: v for k, v in stats.items()
            if not k.endswith("_s") and k not in STAGING_COUNTERS}


def gm_cpu_runs(cases):
    """Each case through the port's global-Morton chained route on the
    CPU (the kernels' plain versions): ``{name: ((labels, core, stats),
    seconds)}``."""
    from pypardis_tpu_torch.parallel import global_morton_dbscan

    out = {}
    for name, (x, chain, kw) in cases.items():
        t = time.perf_counter()
        lab, core, st = global_morton_dbscan(x, mesh=1, chain=chain,
                                             device="cpu", **kw)
        out[name] = ((lab, core, gm_stats(st)), time.perf_counter() - t)
    return out


def gm_memmap(X, name):
    """``X`` (float32) written once to a float32 ``np.memmap`` under
    :data:`GM_DIR`, opened read-only: the route's disk-backed input."""
    os.makedirs(GM_DIR, exist_ok=True)
    path = os.path.join(GM_DIR, f"{name}_{os.getpid()}.f32")
    mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
    mm[:] = X
    mm.flush()
    del mm
    atexit.register(lambda: os.path.exists(path) and os.remove(path))
    return np.memmap(path, dtype=np.float32, mode="r", shape=X.shape), path


def gm_launches(ck, stats, what, kernels, ranges):
    """:func:`chained_launches` for the global-Morton route: each range
    dispatched launches its counts kernel once and its min-label kernel
    once per propagation pass (``stats["partition_passes"]``: 1 + the
    range's min-label passes); every range ran."""
    la = chained_launches(ck, stats, what, *kernels)
    if la[kernels[0]] != ranges:
        fail(f"{what}: {la[kernels[0]]} counts launches for {ranges} ranges")
    return la


def gm_largest_slab(torch, dev, points, eps, block, ranges, core_g):
    """The chained route's largest range slab (most owned + boundary
    rows), laid out by the route's own code (the streaming split,
    ``_stream_range_plan``, ``_chain_boundary_tiles``, ``_range_slab``)
    and put on the card, with each slot's owner core flag from
    ``core_g`` (the fit's (N,) core mask)."""
    from pypardis_tpu_torch.parallel import global_morton as gm
    from pypardis_tpu_torch.partition import morton_range_split_streaming
    from pypardis_tpu_torch.utils.shaping import clamp_block, round_up

    n, _k = points.shape
    block = clamp_block(block, -(-n // ranges))
    with morton_range_split_streaming(points, ranges, eps=eps,
                                      block=block) as sp:
        plans = [gm._stream_range_plan(sp, s, block, eps)
                 for s in range(ranges)]
        cap = round_up(max([p[1] for p in plans] + [1]), block)
        tiles, brows = gm._chain_boundary_tiles(sp, sp.starts, block, eps, n,
                                                ranges)
        bcap = round_up(max(max(len(t) for t in tiles), 1) * block, block)
        rows = [int(sp.starts[s + 1] - sp.starts[s]) + brows[s]
                for s in range(ranges)]
        s = int(np.argmax(rows))
        pts, msk, og, bg = gm._range_slab(sp, s, plans[s][0], tiles[s], cap,
                                          bcap, block, n)
    gid = np.concatenate([og, bg])
    core_all = core_g[np.clip(gid, 0, n - 1)] & (gid < n)
    return dict(range=s, block=block, cap=cap, bcap=bcap,
                owned=int((og < n).sum()), boundary=int((bg < n).sum()),
                pts=torch.from_numpy(pts).to(dev),
                mask=torch.from_numpy(msk).to(dev),
                core_all=torch.from_numpy(core_all).to(dev))


def gm_slab_hold(torch, dev, slab, eps, tiles, what):
    """The counts kernel (B1, or B3 with the sketch) and one min-label
    pass (B2, or B4) against their plain versions on the route's largest
    slab (:func:`gm_largest_slab`), on the same device tensors, over the
    owner-computes lists: the counts list (owned row tiles) on its first
    ``tiles`` row tiles, the propagation list (no boundary x boundary
    tile pair) on its first ``tiles`` owned and first ``tiles`` boundary
    row tiles at the round-1 labels (each owner core its own slot) with
    every valid row live.  All exact.  Returns the record."""
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, eps2_f32, row_offsets,
    )
    from pypardis_tpu_torch.ops.labels import oc_extract

    xs, mask, cap = slab["pts"], slab["mask"], slab["cap"]
    ex = oc_extract(xs, eps, mask, owned=cap, block=slab["block"])
    if ex["total"] > ex["budget"]:
        ex = oc_extract(xs, eps, mask, owned=cap, block=slab["block"],
                        pair_budget=ex["total"])
    rows, cols = ex["pairs"]
    tile, ont, k = ex["tile"], ex["ont"], ex["k"]
    unit, edge = slab.get("unit", "range"), slab.get("edge", "boundary")
    N = xs.shape[1]
    nt = N // tile
    sub = min(tiles, ont)
    sel_c = rows < sub
    sel_b = ~((rows >= ont) & (cols >= ont)) & (
        (rows < sub) | ((rows >= ont) & (rows < ont + tiles)))
    rp_c, cols_c = row_offsets(rows[sel_c], nt), cols[sel_c].contiguous()
    rp_b, cols_b = row_offsets(rows[sel_b], nt), cols[sel_b].contiguous()
    tix = torch.arange(N, device=dev) // tile
    held_c = mask & (tix < sub)
    held_b = mask & ((tix < sub) | ((tix >= ont) & (tix < ont + tiles)))
    mi = mask.to(torch.int32)
    e2 = eps2_f32(eps)
    centers = ex["frames"][0]
    f = torch.where(slab["core_all"], torch.arange(N, device=dev,
                                                   dtype=torch.int32),
                    INT_INF).contiguous()
    if k:
        names = GM_KERNELS["sketch"]
        sk = (ex["slab"][0], k, e2, ex["slab"][1], tile)
        a = (xs, mi, rp_c, cols_c) + sk
        (kc, kst), (pc, pst) = (ck.count_pairs_sketch(*a, "high", centers),
                                ck.PLAIN["count_pairs_sketch"](*a))
        b = (xs, f, rp_b, cols_b) + sk
        kb, pb = ck.minlab_pairs_sketch(*b), ck.PLAIN["minlab_pairs_sketch"](*b)
        stats_off = int((kst != pst).sum())
    else:
        names = GM_KERNELS["high"]
        a = (xs, mi, rp_c, cols_c, e2, tile)
        kc, pc = ck.count_pairs(*a, centers), ck.PLAIN["count_pairs"](*a)
        b = (xs, f, rp_b, cols_b, e2, tile)
        kb = ck.minlab_pairs(*b, live_rows=mask)
        pb = ck.PLAIN["minlab_pairs"](*b, live_rows=mask)
        stats_off = 0
    bad_c = int((kc[held_c] != pc[held_c]).sum())
    bad_b = int((kb[held_b] != pb[held_b]).sum())
    err = {names[0]: int((kc[held_c].long() - pc[held_c].long()).abs().max()),
           names[1]: int((kb[held_b].long() - pb[held_b].long()).abs().max())}
    relayed = int(((pb != INT_INF) & held_b & (tix >= ont)).sum())
    log(f"    {what}: {unit} {slab['range']}'s slab ({slab['owned']} owned of "
        f"cap {cap}, {slab['boundary']} {edge} of {slab['bcap']}; "
        f"tile {tile}, k {k}, {ex['total']} live tile pairs, "
        f"{ex['hh_pairs']} boundary x boundary): {names[0]} on the first "
        f"{sub} owned row tiles ({int(held_c.sum())} points) {bad_c} "
        f"differ{', stats differ' if stats_off else ''}; {names[1]} "
        f"(round 1) on {sub} owned + {min(tiles, nt - ont)} {edge} row "
        f"tiles ({int(held_b.sum())} points, {relayed} {edge} rows "
        f"reaching an owned source) {bad_b} differ")
    if bad_c or bad_b or stats_off:
        fail(f"{what}: the kernels disagree with their plain versions over "
             f"the owner-computes lists")
    if not int(held_b.sum()) or not relayed:
        fail(f"{what}: the held rows reach no source across the boundary")
    return {unit: slab["range"], "rows": N, "owned": slab["owned"],
            edge: slab["boundary"], "tile": tile,
            "tiles_held": sub, "points_held": int(held_b.sum()),
            "max_abs_err": err}


def gm_phase(torch, dev, sync, card="", sizes=GM_SIZES, main=None,
             cpu_refs=None, kd_wall=None, keep=None):
    """Phase 16 (the global-Morton route's chained form on one card,
    ``pypardis_tpu_torch.parallel.global_morton_dbscan(..., mesh=1,
    chain=R)``); see the module docstring.  ``main``: ``dict(X=,
    labels=, core=)`` of phase 4's 1M fit (None: fitted here);
    ``cpu_refs``: a :class:`ChainedCpuRefs` with a ``"gm"`` job (None:
    16.1's CPU runs go here first); ``kd_wall``: 13.2's KD chained wall
    on the same data, printed beside 16.2's; ``keep``: a dict that gains
    the single-device fits phase 17 holds its fits against (``"border"``:
    16.2's at border_eps; ``"sketch"``: 16.3's data and fit).  Returns
    the phase's record."""
    from benchdata import make_blob_data, make_embedding_data
    from pypardis_tpu_torch import DBSCAN, obs
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import global_morton_dbscan
    from pypardis_tpu_torch.utils import faults
    from pypardis_tpu_torch.utils.jobstate import JobState, fit_meta

    rec = {"card": card}
    t_phase = time.perf_counter()
    all_sizes = dict(CHAINED_SIZES, **sizes)

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def run(X, chain, **kw):
        sync()
        t = time.perf_counter()
        out = global_morton_dbscan(X, mesh=1, chain=chain, device=dev, **kw)
        sync()
        return out, time.perf_counter() - t

    # 16.1: the card against the port's CPU route.
    cases = gm_cpu_cases(all_sizes)
    cpu_now = None if cpu_refs else gm_cpu_runs(cases)
    on_card = {}
    for name, (x, chain, kw) in cases.items():
        mode = kw["precision"]
        ck.reset_launch_counts()
        on_card[name] = run(x, chain, **kw)
        (lab, _core, st), wall = on_card[name]
        names = GM_KERNELS["sketch" if st["sketch_k"] else mode]
        gm_launches(ck, st, f"16.1 {name}", names, chain)
        log(f"  16.1 {name}: n={len(x)} d={x.shape[1]} over {chain} ranges,"
            f" {mode}, sketch_k {st['sketch_k']}: card {wall:.4f} s; "
            f"clusters {len(np.unique(lab[lab >= 0]))},"
            f" boundary tiles {st['boundary_tiles']}, halo_factor "
            f"{st['halo_factor']:.4f}, kernel passes {st['kernel_passes']}")
    stamp("16.1: card runs done")

    def close_16_1():
        cpu = cpu_now or cpu_refs.result(cases, "gm")
        for name, ((lab, core, st), _s) in on_card.items():
            (c_lab, c_core, c_st), c_s = cpu[name]
            st = json.loads(json.dumps(gm_stats(st)))
            diff = sorted(k for k in set(c_st) | set(st)
                          if c_st.get(k) != st.get(k))
            # The bf16 B1's band stats on the card are within 1e-3 of its
            # plain version's (phase 8's bar); everything else is exact.
            band = [k for k in ("band_pairs", "rescored_tiles") if k in diff]
            if cases[name][2]["precision"] == "mixed" and all(
                    abs(st[k] - c_st[k]) <= 1e-3 * max(c_st[k], 1)
                    for k in band):
                diff = [k for k in diff if k not in band]
            same = np.array_equal(lab, c_lab) and np.array_equal(core, c_core)
            log(f"    16.1 {name}: card vs CPU ({c_s:.4f} s"
                f"{' in a child process' if cpu_refs else ''}): labels and "
                f"core byte-identical: {same}; stats that differ: {diff}; "
                f"band_pairs card {st['band_pairs']} CPU {c_st['band_pairs']}")
            if not same or diff:
                fail(f"16.1 {name}: the card's chained GM fit differs from "
                     f"the CPU's")
        rec["small"] = {name: {"card_s": c[1], "cpu_s": cpu[name][1]}
                        for name, c in on_card.items()}
        stamp("16.1: done")

    # 16.2: the main path at full width from a memmap.
    n, eps, block = sizes["n"], sizes["eps"], sizes["block"]
    if main is None:
        X, _truth = make_blob_data(n, 16, n_centers=32, std=0.4)
        single = DBSCAN(eps=eps, min_samples=10, block=block,
                        device=dev).fit(X)
        main = dict(X=X, labels=single.labels_,
                    core=single.core_sample_mask_)
    X = main["X"]
    mm, mm_path = gm_memmap(X, "blobs1m")
    if not np.array_equal(np.asarray(mm), X):
        fail("16.2: the memmap does not hold phase 4's points")
    rows = {}
    nb = sizes.get("border_n", n)
    for tag, e in (("main", eps), ("border", sizes["border_eps"])):
        if tag == "main":
            s_lab, s_core = main["labels"], main["core"]
            Xt = X
        else:
            # The first border_n points, from a memmap of their own.
            del mm
            os.remove(mm_path)
            Xt = X[:nb]
            mm, mm_path = gm_memmap(Xt, "blobs_border")
            single = DBSCAN(eps=e, min_samples=10, block=block,
                            device=dev).fit(Xt)
            s_lab, s_core = single.labels_, single.core_sample_mask_
            if keep is not None and nb == n:
                keep["border"] = dict(eps=e, labels=s_lab, core=s_core)
        from pypardis_tpu_torch.obs.resources import host_rss_bytes

        # Earlier phases' garbage is freed first, so that the peaks below
        # are this fit's: the host's as the process's RSS (which reuses
        # pages the process already holds) and, at border_eps only (the
        # main fit's wall stays untraced), as the Python and numpy
        # allocations traced during the fit; the card's as allocated
        # bytes over those held before.
        gc.collect()
        recorder = obs.RunRecorder(device=dev)
        sampler = obs.ResourceSampler(recorder, interval_s=0.05,
                                      device=dev).start()
        rss0 = host_rss_bytes()
        on_cuda = dev.type == "cuda"
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        dev0 = torch.cuda.memory_allocated(dev) if on_cuda else 0
        ck.reset_launch_counts()
        if tag == "border":
            tracemalloc.start()
        try:
            with obs.use_recorder(recorder):
                (lab, core, st), wall = run(mm, sizes["ranges"], eps=e,
                                            min_samples=10, block=block)
            traced = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
            sampler.stop()
        peak_rss = recorder.metrics.as_dict()["gauges"].get(
            "resources.peak_host_rss_bytes", 0)
        peak_dev = (torch.cuda.max_memory_allocated(dev) - dev0 if on_cuda
                    else 0)
        what = f"16.2 n={len(Xt)} d=16 eps={e}"
        la = gm_launches(ck, st, what, GM_KERNELS["high"], sizes["ranges"])
        if tag == "main" and keep is not None:
            # Phase 20.4 holds the mesh engine's one-card form against it.
            keep["gm_chained"] = (lab, core)
        if st["duplicated_work_factor"] != 1.0 or st["input"] != "stream" \
                or st["boundary_tiles"] <= 0:
            fail(f"{what}: duplicated_work_factor "
                 f"{st['duplicated_work_factor']}, input {st['input']}, "
                 f"boundary tiles {st['boundary_tiles']}")
        ss = st["stage_s"]
        log(f"  {what}, {sizes['ranges']} ranges from a float32 memmap: "
            f"{wall:.4f} s on {card} (13.2's KD chained fit from host input"
            f": {'%.4f s' % kd_wall if kd_wall else 'not run'}); gm_build_s "
            f"{st['gm_build_s']} (split {ss['split']:.4f} s), gm_exchange_s "
            f"{st['gm_exchange_s']}, gm_execute_s {st['gm_execute_s']} (host "
            f"slab builds {ss['slab_build']:.4f} s, passes on the card "
            f"{ss['device']:.4f} s by CUDA events), gm_merge_s "
            f"{st['gm_merge_s']}; peak host RSS {peak_rss / 2**20:.1f} MiB "
            f"({(peak_rss - rss0) / 2**20:.1f} MiB over the {rss0 / 2**20:.1f}"
            f" MiB before), peak traced host allocations "
            f"{traced / 2**20:.1f} MiB{' (not traced)' if not traced else ''}"
            f", max_memory_allocated "
            f"{peak_dev / 2**20:.1f} MiB over the {dev0 / 2**20:.1f} MiB "
            f"before")
        log(f"    owned_cap {st['owned_cap']}, halo_cap {st['halo_cap']}, "
            f"boundary tiles {st['boundary_tiles']} ({st['boundary_rows']} "
            f"rows, halo_factor {st['halo_factor']:.6f}), pad_waste "
            f"{st['pad_waste']:.6f}, spill {st['spill_bytes']} bytes in "
            f"{st['stream_buckets']} buckets, live pairs {st['live_pairs']},"
            f" kernel passes (max) {st['kernel_passes']}, per range "
            f"{st['partition_passes']}, tile {st['kernel_block']}")
        clusters, borders, noise, differ = hold_chained(
            torch, dev, Xt, e, lab, core, s_lab, s_core, what)
        if tag == "border" and not borders:
            fail(f"{what}: the data holds no border point, so the border "
                 f"check proves nothing")
        rows[tag] = {
            "n": len(Xt), "eps": e, "wall_s": wall,
            "kd_chained_wall_s": kd_wall,
            **{k: st[k] for k in ("gm_build_s", "gm_exchange_s",
                                  "gm_execute_s", "gm_merge_s",
                                  "boundary_tiles", "halo_factor",
                                  "owned_cap", "halo_cap", "live_pairs",
                                  "kernel_passes", "partition_passes")},
            "stage_s": ss, "peak_host_rss_bytes": int(peak_rss),
            "host_rss_before_bytes": int(rss0),
            "peak_traced_host_bytes": int(traced),
            "max_memory_allocated_bytes": int(peak_dev),
            "launches": {k: la[k] for k in GM_KERNELS["high"]},
            "clusters": clusters, "borders": borders, "noise": noise,
            "borders_differ": differ}
        if tag == "main":
            rows[tag]["slab_hold"] = gm_slab_hold(
                torch, dev, gm_largest_slab(torch, dev, mm, e, block,
                                            sizes["ranges"], core),
                e, sizes["hold_tiles"], f"{what} largest slab")
        del lab, core
        stamp(f"16.2: eps {e} done")
    rec.update(rows)
    del mm
    os.remove(mm_path)

    # 16.3: the sketch at width.
    Xe, _te = make_embedding_data(sizes["sk_n"], 512)
    kw = dict(eps=sizes["sk_eps"], min_samples=10, block=sizes["sk_block"])
    single = DBSCAN(device=dev, **kw).fit(Xe)
    if keep is not None:
        keep["sketch"] = dict(X=Xe, labels=single.labels_,
                              core=single.core_sample_mask_)
    ck.reset_launch_counts()
    (lab, core, st), wall = run(Xe, sizes["sk_ranges"], **kw)
    what = f"16.3 n={len(Xe)} d=512"
    la = gm_launches(ck, st, what, GM_KERNELS["sketch"], sizes["sk_ranges"])
    log(f"  {what} over {sizes['sk_ranges']} ranges, sketch_k "
        f"{st['sketch_k']}: {wall:.4f} s on {card}; boundary tiles "
        f"{st['boundary_tiles']}, band_pairs {st['band_pairs']}, kernel "
        f"passes {st['partition_passes']}")
    if st["sketch_k"] <= 0:
        fail(f"{what}: the sketch is off")
    clusters, borders, noise, differ = hold_chained(
        torch, dev, Xe, kw["eps"], lab, core, single.labels_,
        single.core_sample_mask_, what)
    rec["sketch"] = {"n": len(Xe), "wall_s": wall, "sketch_k": st["sketch_k"],
                     "launches": {k: la[k] for k in GM_KERNELS["sketch"]},
                     "clusters": clusters, "borders": borders,
                     "borders_differ": differ,
                     "slab_hold": gm_slab_hold(
                         torch, dev, gm_largest_slab(
                             torch, dev, Xe, kw["eps"], kw["block"],
                             sizes["sk_ranges"], core),
                         kw["eps"], sizes["hold_tiles"],
                         f"{what} largest slab")}
    del Xe, single, lab, core
    stamp("16.3: done")

    # 16.4: faults and resume on 16.1's 20k case.
    x, chain, kw = cases["small_high"]
    (clean, _s) = on_card["small_high"]
    recorder = obs.RunRecorder(device=dev)
    with obs.use_recorder(recorder), faults.plan(
            "gm.chained_range:1=transfer_error"):
        (lab, core, _st), _w = run(x, chain, **kw)
    ev = recorder.event_counts()
    retried = ev.get("retry.gm.chained_range", 0)
    same = np.array_equal(lab, clean[0]) and np.array_equal(core, clean[1])
    log(f"  16.4: gm.chained_range:1=transfer_error retried {retried} time, "
        f"labels and core equal to the clean run: {same}")
    if retried != 1 or ev.get("fault_injected") != 1 or not same:
        fail("16.4: the transient fault was not retried once to the clean "
             "labels")
    os.makedirs(GM_DIR, exist_ok=True)
    path = os.path.join(GM_DIR, f"resume_{os.getpid()}.npz")
    meta = fit_meta(x, eps=kw["eps"], min_samples=kw["min_samples"],
                    metric="euclidean", block=kw["block"],
                    mode="global_morton")
    js = JobState.open(path, meta, every_s=0)
    try:
        with faults.plan(f"gm.chained_range:{chain + 3}=error"):
            run(x, chain, jobstate=js, **kw)
        fail("16.4: the run that was to fail at its third range finished")
    except faults.FaultInjected:
        pass
    js2 = JobState.open(path, meta, resume=True)
    ck.reset_launch_counts()
    (lab, core, st), wall = run(x, chain, jobstate=js2, **kw)
    la = dict(ck.LAUNCHES)
    os.remove(path)
    ran = chain - js2.restored_partitions
    want = {"count_pairs": ran,
            "minlab_pairs": sum(p - 1 for p in st["partition_passes"])}
    same = np.array_equal(lab, clean[0]) and np.array_equal(core, clean[1])
    log(f"  16.4: resumed past {js2.restored_partitions} ranges in "
        f"{wall:.4f} s: launches count_pairs={la['count_pairs']} "
        f"minlab_pairs={la['minlab_pairs']} for the {ran} ranges run (want "
        f"{want}); labels and core byte-identical to the clean run: {same}")
    if js2.restored_partitions != 2 or len(st["partition_passes"]) != ran \
            or {k: la[k] for k in want} != want or not same:
        fail("16.4: the resumed run did not skip its restored ranges or "
             "differs from the clean run")
    rec["faults"] = {"retried": retried, "restored": js2.restored_partitions,
                     "resume_launches": want}
    stamp("16.4: done")
    close_16_1()
    return rec


# Phase 17: the KD route's fused multi-device step on a mesh that repeats
# the one card `mesh` times.  17.1 reuses 13.1's data (the 20,000 x 16-D
# blobs over small_parts partitions, each `small_cases` entry a (mode,
# merge, owner_computes) run; the 4,096 x 512 embeddings over emb_parts
# partitions, fewer than the shards, so two slots are empty); 17.2 phase
# 4's 1M x 16-D blobs at eps and border_eps; 17.3 phase 7's 100k x 512
# embeddings; 17.4 17.1's first case and a line of chain_n points.
MESH_SIZES = {"mesh": 4, "small_parts": 8,
              "small_cases": [["high", "device", True],
                              ["high", "host", False],
                              ["mixed", "device", True],
                              ["mixed", "host", True],
                              ["default", "device", True],
                              ["default", "host", False]],
              "emb_parts": 2, "n": 1_000_000, "eps": 2.4, "block": 2048,
              "hold_tiles": 64, "border_eps": 1.4, "sk_n": 100_000,
              "sk_eps": 2.0, "sk_block": 2048, "chain_n": 4096}


def mesh_cpu_cases(sizes):
    """17.1's cases from 13.1's data: ``{name: (X, partitions,
    kwargs)}``, the 20k case once per ``small_cases`` entry."""
    kd = chained_cpu_cases(sizes)
    (Xs, _p, kw_s), (Xe, _pe, kw_e) = kd["small"], kd["emb"]
    out = {}
    for mode, merge, oc in sizes["small_cases"]:
        name = f"small_{mode}_{merge}_{'oc' if oc else 'dup'}"
        out[name] = (Xs, sizes["small_parts"],
                     dict(kw_s, precision=mode, merge=merge,
                          owner_computes=bool(oc)))
    out["emb"] = (Xe, sizes["emb_parts"], dict(kw_e, precision="high",
                                               merge="device"))
    return out


def mesh_cpu_runs(cases, shards=MESH_SIZES["mesh"]):
    """Each case through the port's fused step on a CPU mesh of
    ``shards`` (the kernels' plain versions): ``{name: ((labels, core,
    stats), seconds)}``."""
    from pypardis_tpu_torch import KDPartitioner
    from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan

    out = {}
    for name, (x, parts, kw) in cases.items():
        t = time.perf_counter()
        lab, core, st = sharded_dbscan(
            x, KDPartitioner(x, max_partitions=parts),
            mesh=Mesh(["cpu"] * shards), device="cpu", **kw)
        out[name] = ((lab, core, gm_stats(st)), time.perf_counter() - t)
    return out


def mesh_launches(ck, stats, what, kernels):
    """:func:`chained_launches` for the fused step: each partition slot
    (empty ones too) launches its counts kernel once and its min-label
    kernel once per other pass; every slot ran."""
    la = chained_launches(ck, stats, what, *kernels)
    if la[kernels[0]] != stats["n_shard_partitions"]:
        fail(f"{what}: {la[kernels[0]]} counts launches for "
             f"{stats['n_shard_partitions']} partition slots")
    return la


def mesh_largest_slab(torch, dev, X, part, eps, block, shards, core_g):
    """The fused step's largest partition slab (most owned + halo
    points), laid out by the route's own code (``build_shards``'s
    geometry and halo sets, and the one partition's owned rows, empty
    rows up to ``cap``, then its halo, as ``_partition_slab`` fills
    them: the same bits as ``build_shards``'s two slabs of it) and put
    on the card, with each slot's owner core flag from ``core_g`` (the
    fit's (N,) core mask): the slab :func:`gm_slab_hold` holds the
    kernels on.  Only that partition is sorted and filled."""
    from pypardis_tpu_torch.parallel import sharded
    from pypardis_tpu_torch.utils.shaping import clamp_block

    n, k = X.shape
    block = clamp_block(block, max(len(p) for p in
                                   part.partitions.values()))
    center, _lo, _hi, labels = sharded._expanded_frame_meta(X, part, eps)
    _pr, _pt, part_idx, cap = sharded._layout_geometry(part, labels, shards,
                                                       block)
    halo_idx = sharded._halo_sets(X, part, eps, labels)
    hcap = sharded._halo_cap(halo_idx, block)
    p = int(np.argmax([len(o) + len(h) for o, h in zip(part_idx,
                                                        halo_idx)]))
    pts = np.empty((k, cap + hcap), np.float32)
    msk = np.empty(cap + hcap, bool)
    gid = np.empty(cap + hcap, np.int32)
    sharded._partition_slab(pts, msk, gid, X, dict(
        center=center, part_idx=part_idx, halo_idx=halo_idx, cap=cap), p)
    core_all = core_g[np.clip(gid, 0, n - 1)] & (gid < n)
    return dict(range=p, unit="partition", edge="halo", block=block,
                cap=int(cap), bcap=int(hcap), owned=int(msk[:cap].sum()),
                boundary=int(msk[cap:].sum()),
                pts=torch.from_numpy(pts).to(dev),
                mask=torch.from_numpy(msk).to(dev),
                core_all=torch.from_numpy(core_all).to(dev))


def mesh_phase(torch, dev, sync, card="", sizes=MESH_SIZES, main=None,
               cpu_refs=None, walls=None, keep=None):
    """Phase 17 (the KD route's fused multi-device step on a mesh of
    ``sizes["mesh"]`` shards on the one card); see the module docstring.
    ``main``: ``dict(X=, labels=, core=)`` of phase 4's 1M fit (None:
    fitted here); ``cpu_refs``: a :class:`ChainedCpuRefs` with a
    ``"mesh"`` job (None: 17.1's CPU runs go here first); ``walls``:
    ``{"single": phase 4's 1M host-input wall, "chained": 13.2's}``,
    printed beside 17.2's; ``keep``: phase 16's single-device fits
    (``"border"``, ``"sketch"``; missing ones are fitted here), which
    gains 17.2's device-merge fit (``"mesh_main"``) and 17.3's
    (``"mesh_sketch"``, with its points) for phase 18.  Returns the
    phase's record."""
    from benchdata import make_embedding_data
    from pypardis_tpu_torch import DBSCAN, KDPartitioner, obs
    from pypardis_tpu_torch.obs.resources import host_rss_bytes
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan
    from pypardis_tpu_torch.utils import faults

    rec = {"card": card}
    walls = walls or {}
    keep = {} if keep is None else keep
    t_phase = time.perf_counter()
    all_sizes = dict(CHAINED_SIZES, **sizes)
    mesh = Mesh([dev] * sizes["mesh"])
    log(f"  mesh {mesh!r} on {torch.cuda.device_count()} card(s): "
        f"{sizes['mesh']} shards, their devices {sorted(set(map(str, mesh.devices)))}")
    rec["mesh"] = [str(d) for d in mesh.devices]
    rec["cards"] = torch.cuda.device_count()

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def run(X, parts, **kw):
        sync()
        t = time.perf_counter()
        out = sharded_dbscan(X, KDPartitioner(X, max_partitions=parts),
                             mesh=mesh, device=dev, **kw)
        sync()
        return out, time.perf_counter() - t

    # 17.1: the card against the port's CPU mesh route.
    cases = mesh_cpu_cases(all_sizes)
    cpu_now = None if cpu_refs else mesh_cpu_runs(cases, sizes["mesh"])
    on_card = {}
    for name, (x, parts, kw) in cases.items():
        ck.reset_launch_counts()
        on_card[name] = run(x, parts, **kw)
        (lab, _core, st), wall = on_card[name]
        names = GM_KERNELS["sketch" if st["sketch_k"] else kw["precision"]]
        mesh_launches(ck, st, f"17.1 {name}", names)
        log(f"  17.1 {name}: n={len(x)} d={x.shape[1]} over {parts} "
            f"partitions ({st['n_shard_partitions']} slots), owner_computes"
            f" {st['owner_computes']}, merge {st['merge']}, sketch_k "
            f"{st['sketch_k']}: card {wall:.4f} s; clusters "
            f"{len(np.unique(lab[lab >= 0]))}, halo_factor "
            f"{st['halo_factor']:.4f}, merge_rounds {st.get('merge_rounds')}"
            f", kernel passes {st['partition_passes']}")
    stamp("17.1: card runs done")

    def close_17_1():
        cpu = cpu_now or cpu_refs.result(cases, "mesh")
        for name, ((lab, core, st), _s) in on_card.items():
            (c_lab, c_core, c_st), c_s = cpu[name]
            st = json.loads(json.dumps(gm_stats(st)))
            diff = sorted(k for k in set(c_st) | set(st)
                          if c_st.get(k) != st.get(k))
            band = [k for k in ("band_pairs", "rescored_tiles") if k in diff]
            if cases[name][2]["precision"] == "mixed" and all(
                    abs(st[k] - c_st[k]) <= 1e-3 * max(c_st[k], 1)
                    for k in band):
                diff = [k for k in diff if k not in band]
            same = np.array_equal(lab, c_lab) and np.array_equal(core, c_core)
            log(f"    17.1 {name}: card vs CPU ({c_s:.4f} s"
                f"{' in a child process' if cpu_refs else ''}): labels and "
                f"core byte-identical: {same}; stats that differ: {diff}; "
                f"band_pairs card {st['band_pairs']} CPU {c_st['band_pairs']}")
            if not same or diff:
                fail(f"17.1 {name}: the card's mesh fit differs from the "
                     f"CPU's")
        rec["small"] = {name: {"card_s": c[1], "cpu_s": cpu[name][1]}
                        for name, c in on_card.items()}
        stamp("17.1: done")

    # 17.2: the main path at full width through DBSCAN(mesh=...).
    n, eps, block = sizes["n"], sizes["eps"], sizes["block"]
    if main is None:
        from benchdata import make_blob_data

        X, _truth = make_blob_data(n, 16, n_centers=32, std=0.4)
        single = DBSCAN(eps=eps, min_samples=10, block=block,
                        device=dev).fit(X)
        main = dict(X=X, labels=single.labels_,
                    core=single.core_sample_mask_)
    X = main["X"]
    if "border" not in keep:
        single = DBSCAN(eps=sizes["border_eps"], min_samples=10,
                        block=block, device=dev).fit(X)
        keep["border"] = dict(labels=single.labels_,
                              core=single.core_sample_mask_)
    rows = {}
    for tag, e, merge in (("main", eps, "device"), ("host", eps, "host"),
                          ("border", sizes["border_eps"], "host")):
        ref = main if tag != "border" else keep["border"]
        gc.collect()
        recorder = obs.RunRecorder(device=dev)
        sampler = obs.ResourceSampler(recorder, interval_s=0.05,
                                      device=dev).start()
        rss0 = host_rss_bytes()
        on_cuda = dev.type == "cuda"
        if on_cuda:
            torch.cuda.reset_peak_memory_stats(dev)
        dev0 = torch.cuda.memory_allocated(dev) if on_cuda else 0
        model = DBSCAN(eps=e, min_samples=10, block=block, mesh=mesh,
                       merge=merge, device=dev)
        ck.reset_launch_counts()
        try:
            with obs.use_recorder(recorder):
                sync()
                t = time.perf_counter()
                model.fit(X)
                sync()
                wall = time.perf_counter() - t
        finally:
            sampler.stop()
        peak_rss = recorder.metrics.as_dict()["gauges"].get(
            "resources.peak_host_rss_bytes", 0)
        peak_dev = (torch.cuda.max_memory_allocated(dev) - dev0 if on_cuda
                    else 0)
        st = model.metrics_
        what = f"17.2 n={n} d=16 eps={e} merge={merge}"
        la = mesh_launches(ck, st, what, GM_KERNELS["high"])
        p_total = st["n_shard_partitions"]
        if model.report()["run"]["n_devices"] != sizes["mesh"]:
            fail(f"{what}: the fit did not take the mesh route")
        want_dwf = float(p_total * st["owned_cap"]) / n
        if (st["owner_computes"] is not True or p_total != sizes["mesh"]
                or st["duplicated_work_factor"] != want_dwf
                or st["merge"] != merge):
            fail(f"{what}: owner_computes {st['owner_computes']}, "
                 f"{p_total} partitions, duplicated_work_factor "
                 f"{st['duplicated_work_factor']} (want {want_dwf}), merge "
                 f"{st['merge']}")
        ss = st["stage_s"]
        log(f"  {what}, {p_total} partitions on {sizes['mesh']} shards: "
            f"{wall:.4f} s from host input on {card} (phase 4's single-card"
            f" fit {walls.get('single', 'not run')} s, 13.2's KD chained "
            f"fit {walls.get('chained', 'not run')} s); phases "
            f"{ {k: round(v, 4) for k, v in model.report()['phases'].items()} }"
            f"; halo sets {ss['halo_sets']:.4f} s, slab build "
            f"{ss['slab_build']:.4f} s, ship {ss['ship']:.4f} s, passes on "
            f"the card {ss['device']:.4f} s (CUDA-event spans), loop "
            f"{ss['loop']:.4f} s, merge {ss['merge']:.4f} s "
            f"({st.get('merge_rounds')} rounds, "
            f"{st.get('merge_host_syncs')} host syncs); peak host RSS "
            f"{peak_rss / 2**20:.1f} MiB ({(peak_rss - rss0) / 2**20:.1f} MiB"
            f" over the {rss0 / 2**20:.1f} MiB before), max_memory_allocated "
            f"{peak_dev / 2**20:.1f} MiB over the {dev0 / 2**20:.1f} MiB "
            f"before")
        log(f"    owned_cap {st['owned_cap']}, halo_cap {st['halo_cap']}, "
            f"halo_factor {st['halo_factor']:.6f}, duplicated_work_factor "
            f"{st['duplicated_work_factor']:.6f}, pad_waste "
            f"{st['pad_waste']:.6f}, live pairs {st['live_pairs']}, kernel "
            f"passes {st['partition_passes']}, tile {st['kernel_block']}")
        clusters, borders, noise, differ = hold_chained(
            torch, dev, X, e, model.labels_, model.core_sample_mask_,
            ref["labels"], ref["core"], what)
        if tag == "border" and not borders:
            fail(f"{what}: the data holds no border point, so the border "
                 f"check proves nothing")
        rows[tag] = {
            "eps": e, "merge": merge, "wall_s": wall,
            "single_wall_s": walls.get("single"),
            "kd_chained_wall_s": walls.get("chained"),
            **{k: st.get(k) for k in (
                "n_shard_partitions", "owned_cap", "halo_cap", "halo_factor",
                "duplicated_work_factor", "pad_waste", "merge_rounds",
                "merge_host_syncs", "live_pairs", "kernel_passes",
                "partition_passes")},
            "stage_s": ss, "peak_host_rss_bytes": int(peak_rss),
            "host_rss_before_bytes": int(rss0),
            "max_memory_allocated_bytes": int(peak_dev),
            "staged_bytes": st["staged_bytes"],
            "staged_bytes_reused": st["staged_bytes_reused"],
            "launches": {k: la[k] for k in GM_KERNELS["high"]},
            "clusters": clusters, "borders": borders, "noise": noise,
            "borders_differ": differ}
        if tag == "main":
            # Phase 18 holds its ring fits against this one.
            keep["mesh_main"] = dict(labels=model.labels_,
                                     core=model.core_sample_mask_,
                                     wall_s=wall, stage_s=ss)
            rows[tag]["slab_hold"] = gm_slab_hold(
                torch, dev, mesh_largest_slab(
                    torch, dev, X, model.partitioner_, e, block,
                    sizes["mesh"], model.core_sample_mask_),
                e, sizes["hold_tiles"], f"{what} largest slab")
        del model
        stamp(f"17.2: eps {e} merge {merge} done")
    rec.update(rows)
    # The staging cache: the host-merge fit refits the device-merge fit's
    # data warm (its owned and halo slabs cached), the border fit at
    # another eps re-ships only the halo slabs.
    sb = {t: (rows[t]["staged_bytes"], rows[t]["staged_bytes_reused"],
              rows[t]["wall_s"]) for t in rows}
    log(f"  17.2 staging (staged, reused, s): {sb}")
    cold_b = sb["main"][0]
    if (not cold_b or sb["host"][:2] != (0, cold_b)
            or not 0 < sb["border"][1] < cold_b or not sb["border"][0]):
        fail(f"17.2: the refits were not the staging cache's hits: {sb}")
    rec["staging"] = sb

    # 17.3: the sketch at width.
    kw = dict(eps=sizes["sk_eps"], min_samples=10, block=sizes["sk_block"])
    if "sketch" not in keep:
        Xe, _te = make_embedding_data(sizes["sk_n"], 512)
        single = DBSCAN(device=dev, **kw).fit(Xe)
        keep["sketch"] = dict(X=Xe, labels=single.labels_,
                              core=single.core_sample_mask_)
    Xe = keep["sketch"]["X"]
    model = DBSCAN(mesh=mesh, device=dev, **kw)
    ck.reset_launch_counts()
    sync()
    t = time.perf_counter()
    model.fit(Xe)
    sync()
    wall = time.perf_counter() - t
    st = model.metrics_
    what = f"17.3 n={len(Xe)} d=512"
    la = mesh_launches(ck, st, what, GM_KERNELS["sketch"])
    ss = st["stage_s"]
    log(f"  {what} over {st['n_shard_partitions']} partitions, sketch_k "
        f"{st['sketch_k']}: {wall:.4f} s on {card}; halo_factor "
        f"{st['halo_factor']:.6f}, halo sets {ss['halo_sets']:.4f} s, slab "
        f"build {ss['slab_build']:.4f} s, passes on the card "
        f"{ss['device']:.4f} s, band_pairs {st['band_pairs']}, kernel "
        f"passes {st['partition_passes']}")
    if st["sketch_k"] <= 0 or st["owner_computes"] is not True:
        fail(f"{what}: sketch_k {st['sketch_k']}, owner_computes "
             f"{st['owner_computes']}")
    clusters, borders, noise, differ = hold_chained(
        torch, dev, Xe, kw["eps"], model.labels_, model.core_sample_mask_,
        keep["sketch"]["labels"], keep["sketch"]["core"], what)
    rec["sketch"] = {
        "n": len(Xe), "wall_s": wall, "sketch_k": st["sketch_k"],
        "halo_factor": st["halo_factor"], "stage_s": ss,
        "launches": {k: la[k] for k in GM_KERNELS["sketch"]},
        "clusters": clusters, "borders": borders, "borders_differ": differ,
        "slab_hold": gm_slab_hold(
            torch, dev, mesh_largest_slab(
                torch, dev, Xe, model.partitioner_, kw["eps"], kw["block"],
                sizes["mesh"], model.core_sample_mask_),
            kw["eps"], sizes["hold_tiles"], f"{what} largest slab")}
    keep["mesh_sketch"] = dict(X=Xe, labels=model.labels_,
                               core=model.core_sample_mask_, wall_s=wall,
                               stage_s=ss)
    del Xe, model, keep["sketch"]
    stamp("17.3: done")

    # 17.4: the ladders and the spill on 17.1's first case.
    first = next(iter(cases))
    x, parts, kw = cases[first]
    clean = on_card[first][0]

    recorder = obs.RunRecorder(device=dev)
    with obs.use_recorder(recorder):
        (lab, core, st), wall = run(x, parts, **dict(kw, pair_budget=1))
    tries = recorder.metrics.as_dict()["counters"].get(
        "retry.pair_budget.attempts", 0)
    same = np.array_equal(lab, clean[0]) and np.array_equal(core, clean[1])
    p = st["n_shard_partitions"]
    log(f"  17.4 {first} at pair_budget=1: {wall:.4f} s, reruns "
        f"{tries}, passes {st['partition_passes']}, labels and core equal "
        f"to 17.1's: {same}")
    if tries != 1 or not same or st["partition_passes"][:p] != [0] * p:
        fail("17.4: a too-small pair budget did not rerun once at the exact "
             "total to the same labels")
    rec["ladders"] = {"pair_budget_reruns": tries}
    line = np.zeros((sizes["chain_n"], 2))
    line[:, 0] = np.arange(sizes["chain_n"], dtype=np.float64) * 0.09
    chain_kw = dict(eps=0.2, min_samples=2, block=256, merge="device")
    (c_lab, c_core, c_st), _w = run(line, 8, **chain_kw)
    recorder = obs.RunRecorder(device=dev)
    with obs.use_recorder(recorder):
        (lab, core, st), wall = run(line, 8, merge_rounds=1, **chain_kw)
    tries = recorder.metrics.as_dict()["counters"].get(
        "retry.merge_rounds.attempts", 0)
    same = np.array_equal(lab, c_lab) and np.array_equal(core, c_core)
    log(f"  17.4 a line of {len(line)} points over 8 partitions at "
        f"merge_rounds=1: {wall:.4f} s, retries {tries}, merge_rounds "
        f"{st['merge_rounds']} (the default run's {c_st['merge_rounds']}), "
        f"one cluster: {bool(lab.max() == lab.min() >= 0)}, labels equal: "
        f"{same}")
    if tries != 1 or not same or st["merge_rounds"] <= 1 \
            or not lab.max() == lab.min() >= 0:
        fail("17.4: merge_rounds=1 did not retry once at 4x to the same "
             "labels")
    rec["ladders"]["merge_rounds_retries"] = tries
    rec["ladders"]["merge_rounds"] = st["merge_rounds"]
    recorder = obs.RunRecorder(device=dev)
    with obs.use_recorder(recorder), faults.plan("sharded.execute:1=oom"):
        (lab, core, st), wall = run(x, parts, **dict(kw, merge="device"))
    degraded = recorder.event_counts().get("degraded", 0)
    same = np.array_equal(lab, clean[0]) and np.array_equal(core, clean[1])
    log(f"  17.4 {first} with sharded.execute:1=oom: {wall:.4f} s, merge "
        f"{st['merge']}, degraded {degraded}, labels and core equal to "
        f"17.1's: {same}")
    if st["merge"] != "host" or degraded < 1 or not same:
        fail("17.4: the injected OOM did not finish the merge on the host "
             "to the same labels")
    rec["ladders"]["oom_merge"] = st["merge"]
    stamp("17.4: done")
    close_17_1()
    return rec


# Phase 18: the KD route's ring exchange, its streaming build and the
# device-input route, on a mesh that repeats the one card `mesh` times.
# 18.1 reuses 13.1's data (the 20,000 x 16-D blobs over small_parts
# partitions, the 4,096 x 512 embeddings over emb_parts), each under
# every merge of ring_merges; 18.2 phase 4's 1M x 16-D blobs over `mesh`
# partitions: the ring from host input, a float32 memmap of them through
# the streaming build and a CUDA tensor of them through the device-input
# route; 18.3 phase 7's 100k x 512 embeddings, where the hcap ladder
# climbs (halo_factor 3.0 at 17.3); 18.4 18.1's first case at an explicit
# hcap of one block.
RING_SIZES = {"mesh": 4, "small_parts": 8,
              "ring_merges": ["device", "host"], "emb_parts": 2,
              "n": 1_000_000, "eps": 2.4, "block": 2048, "hold_tiles": 64,
              "sk_n": 100_000, "sk_eps": 2.0, "sk_block": 2048}


def ring_cpu_cases(sizes):
    """18.1's cases from 13.1's data: ``{name: (X, partitions,
    kwargs)}``, each case once per merge of ``ring_merges``."""
    kd = chained_cpu_cases(sizes)
    out = {}
    for merge in sizes["ring_merges"]:
        for case, parts in (("small", sizes["small_parts"]),
                            ("emb", sizes["emb_parts"])):
            x, _p, kw = kd[case]
            out[f"{case}_{merge}"] = (x, parts, dict(kw, merge=merge))
    return out


def ring_cpu_runs(cases, shards=RING_SIZES["mesh"]):
    """Each case through the port's ring route on a CPU mesh of
    ``shards`` (the kernels' plain versions): ``{name: ((labels, core,
    stats), seconds)}``."""
    from pypardis_tpu_torch import KDPartitioner
    from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan

    out = {}
    for name, (x, parts, kw) in cases.items():
        t = time.perf_counter()
        lab, core, st = sharded_dbscan(
            x, KDPartitioner(x, max_partitions=parts),
            mesh=Mesh(["cpu"] * shards), device="cpu", halo="ring", **kw)
        out[name] = ((lab, core, gm_stats(st)), time.perf_counter() - t)
    return out


def ring_largest_slab(torch, dev, X, part, eps, block, mesh, hcap, core_g):
    """The ring route's largest partition slab (most owned + halo
    points), laid out by the route's own code: ``build_owned_shards``,
    the shards shipped to the mesh and ``ring_exchange_step`` at the
    ``hcap`` the fit held with; the owned rows, then the ring halo, as
    the route concatenates them.  Each slot's owner core flag comes from
    ``core_g`` (the fit's (N,) core mask).  The slab
    :func:`gm_slab_hold` holds the kernels on."""
    from pypardis_tpu_torch.parallel import sharded
    from pypardis_tpu_torch.utils.shaping import clamp_block

    n = len(X)
    block = clamp_block(block, max(len(p) for p in
                                   part.partitions.values()))
    arrays, lo, hi, _labels, stats = sharded.build_owned_shards(
        X, part, eps, mesh.size, block)
    shards = sharded._with_boxes(sharded._ship_owned(arrays, mesh), lo, hi,
                                 mesh)
    del arrays
    halos = sharded.ring_exchange_step(shards, mesh=mesh, hcap=hcap)
    slabs = [s for shard in sharded._ring_slabs(shards, halos)
             for s in shard]
    del shards, halos
    cap = int(stats["owned_cap"])
    p = int(np.argmax([int(m.sum()) for _x, m, _g in slabs]))
    pts, msk, gid = slabs[p]
    del slabs
    g = gid.long()
    core_all = (torch.from_numpy(core_g).to(dev)[g.clamp_max(n - 1)]
                & (g < n))
    return dict(range=p, unit="partition", edge="halo", block=block,
                cap=cap, bcap=int(hcap), owned=int(msk[:cap].sum()),
                boundary=int(msk[cap:].sum()), pts=pts, mask=msk,
                core_all=core_all)


class HostFetchSpy:
    """Records every floating tensor of at least ``n`` rows that reaches
    the host while it is on: ``.cpu()``, ``.to("cpu")`` of a CUDA
    tensor, and ``.numpy()``, ``__array__`` or ``.tolist()`` of any.  The
    device-input route's gate: no ``(N, k)`` copy of the coordinates."""

    NAMES = ("cpu", "to", "numpy", "__array__", "tolist")

    def __init__(self, torch, n):
        self.torch, self.n, self.seen, self.orig = torch, n, [], {}

    def _wrap(self, name, f):
        spy = self

        def g(t, *a, **k):
            if t.is_floating_point() and t.dim() and t.shape[0] >= spy.n:
                target = a[0] if a else k.get("device", "")
                host = (name in ("numpy", "__array__", "tolist")
                        or (t.is_cuda and (name == "cpu" or str(
                            target).startswith("cpu"))))
                if host:
                    spy.seen.append((name, tuple(t.shape)))
            return f(t, *a, **k)
        return g

    def __enter__(self):
        T = self.torch.Tensor
        for name in self.NAMES:
            self.orig[name] = getattr(T, name)
            setattr(T, name, self._wrap(name, self.orig[name]))
        return self

    def __exit__(self, *exc):
        for name, f in self.orig.items():
            setattr(self.torch.Tensor, name, f)
        return False


def layout_host_peaks(torch, X, mm, part, eps, block, mesh, cap):
    """The host memory each owned layout holds at its peak, as Python
    and numpy allocations traced (``tracemalloc``) while it runs alone,
    outside the timed fits: the in-RAM ``build_owned_shards`` against
    the stream's ``build_owned_shards_streaming`` from ``mm``, beside
    one partition's ``(k, cap)`` slab, mask and gids.  The stream must
    hold less (its claim: one partition of host RAM at a time, plus the
    index lists the partitioner already holds).  Returns the record."""
    from pypardis_tpu_torch.parallel import sharded
    from pypardis_tpu_torch.utils.shaping import clamp_block

    block = clamp_block(block, max(len(p) for p in
                                   part.partitions.values()))
    peaks = {}
    for tag in ("in_ram", "stream"):
        gc.collect()
        tracemalloc.start()
        try:
            out = (sharded.build_owned_shards(X, part, eps, mesh.size, block)
                   if tag == "in_ram" else
                   sharded.build_owned_shards_streaming(mm, part, eps, block,
                                                        mesh))
            peaks[tag] = tracemalloc.get_traced_memory()[1]
        finally:
            tracemalloc.stop()
        del out
    one = cap * (X.shape[1] * 4 + 1 + 4)
    log(f"    18.2 host memory of the owned layout at its peak (traced): "
        f"in RAM {peaks['in_ram'] / 2**20:.1f} MiB, streamed "
        f"{peaks['stream'] / 2**20:.1f} MiB; one partition's slab "
        f"{one / 2**20:.1f} MiB")
    if peaks["stream"] >= peaks["in_ram"]:
        fail("18.2: the streaming build held as much host memory as the "
             "in-RAM layout")
    return dict(peaks, one_partition=one)


def ring_phase(torch, dev, sync, card="", sizes=RING_SIZES, main=None,
               cpu_refs=None, keep=None):
    """Phase 18 (the KD route's ring exchange, its streaming build and
    the device-input route on a mesh of ``sizes["mesh"]`` shards on the
    one card); see the module docstring.  ``main``: ``dict(X=,
    tensor_labels=, tensor_core=)``, phase 4's 1M data and its fit from
    a CUDA tensor (None: fitted here); ``cpu_refs``: a
    :class:`ChainedCpuRefs` with a ``"ring"`` job (None: 18.1's CPU runs
    go here first); ``keep``: phase 17's host-halo mesh fits
    (``"mesh_main"``, ``"mesh_sketch"``; missing ones are fitted here).
    Returns the phase's record."""
    from benchdata import make_embedding_data
    from pypardis_tpu_torch import DBSCAN, KDPartitioner, obs
    from pypardis_tpu_torch.obs.resources import host_rss_bytes
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.labels import densify_labels
    from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan

    rec = {"card": card}
    keep = {} if keep is None else keep
    t_phase = time.perf_counter()
    all_sizes = dict(CHAINED_SIZES, **sizes)
    mesh = Mesh([dev] * sizes["mesh"])
    log(f"  mesh {mesh!r} on {torch.cuda.device_count()} card(s): each "
        f"ring hop hands a buffer to the next shard on the same device")
    rec["mesh"] = [str(d) for d in mesh.devices]

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def ring(X, parts, **kw):
        sync()
        t = time.perf_counter()
        out = sharded_dbscan(X, KDPartitioner(X, max_partitions=parts),
                             mesh=mesh, device=dev, halo="ring", **kw)
        sync()
        return out, time.perf_counter() - t

    def retries(recorder):
        """The ``ring.hcap`` retries and giveups a recorder counted."""
        c = recorder.metrics.as_dict()["counters"]
        return (int(c.get("retry.ring.hcap.attempts", 0)),
                int(c.get("retry.ring.hcap.giveups", 0)))

    def stages(st):
        return {k: round(v, 4) for k, v in st["stage_s"].items()}

    # 18.1: the card against the port's CPU ring.
    cases = ring_cpu_cases(all_sizes)
    cpu_now = None if cpu_refs else ring_cpu_runs(cases, sizes["mesh"])
    on_card = {}
    for name, (x, parts, kw) in cases.items():
        ck.reset_launch_counts()
        on_card[name] = ring(x, parts, **kw)
        (lab, _core, st), wall = on_card[name]
        names = GM_KERNELS["sketch" if st["sketch_k"] else "high"]
        mesh_launches(ck, st, f"18.1 {name}", names)
        log(f"  18.1 {name}: n={len(x)} d={x.shape[1]} over {parts} "
            f"partitions ({st['n_shard_partitions']} slots), merge "
            f"{st.get('merge', 'device')}, owner_computes "
            f"{st['owner_computes']}, sketch_k {st['sketch_k']}: card "
            f"{wall:.4f} s; clusters {len(np.unique(lab[lab >= 0]))}, "
            f"halo_cap {st['halo_cap']}, halo_bytes {st['halo_bytes']}, "
            f"merge_rounds {st.get('merge_rounds')}, stages {stages(st)}")
    cpu = cpu_now or cpu_refs.result(cases, "ring")
    for name, ((lab, core, st), _s) in on_card.items():
        (c_lab, c_core, c_st), c_s = cpu[name]
        st = json.loads(json.dumps(gm_stats(st)))
        diff = sorted(k for k in set(c_st) | set(st)
                      if c_st.get(k) != st.get(k))
        same = np.array_equal(lab, c_lab) and np.array_equal(core, c_core)
        log(f"    18.1 {name}: card vs CPU ({c_s:.4f} s"
            f"{' in a child process' if cpu_refs else ''}): labels and "
            f"core byte-identical: {same}; stats that differ: {diff}")
        if not same or diff:
            fail(f"18.1 {name}: the card's ring fit differs from the CPU's")
    rec["small"] = {name: {"card_s": c[1], "cpu_s": cpu[name][1]}
                    for name, c in on_card.items()}
    stamp("18.1: done")

    # 18.2: the three inputs at full width.
    n, eps, block = sizes["n"], sizes["eps"], sizes["block"]
    if main is None:
        from benchdata import make_blob_data

        X, _truth = make_blob_data(n, 16, n_centers=32, std=0.4)
        single = DBSCAN(eps=eps, min_samples=10, block=block,
                        device=dev).fit(torch.from_numpy(X).to(dev))
        main = dict(X=X, tensor_labels=single.labels_,
                    tensor_core=single.core_sample_mask_)
        del single
    X = main["X"]
    if "mesh_main" not in keep:
        sync()
        t = time.perf_counter()
        host = DBSCAN(eps=eps, min_samples=10, block=block, mesh=mesh,
                      merge="device", device=dev).fit(X)
        sync()
        keep["mesh_main"] = dict(labels=host.labels_,
                                 core=host.core_sample_mask_,
                                 wall_s=time.perf_counter() - t,
                                 stage_s=host.metrics_["stage_s"])
        del host
    ref = keep["mesh_main"]
    mm, mm_path = gm_memmap(X, "ring")
    rows, ring_fit = {}, None
    for tag in ("ring", "stream", "device"):
        gc.collect()
        recorder = obs.RunRecorder(device=dev)
        sampler = obs.ResourceSampler(recorder, interval_s=0.05,
                                      device=dev).start()
        rss0 = host_rss_bytes()
        dev0 = 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
            dev0 = torch.cuda.memory_allocated(dev)
        Xd = torch.from_numpy(X).to(dev) if tag == "device" else None
        sync()
        ck.reset_launch_counts()
        spy, counted = HostFetchSpy(torch, n), recorder
        try:
            with obs.use_recorder(recorder):
                t = time.perf_counter()
                if tag == "ring":
                    lab, core, st = sharded_dbscan(
                        X, KDPartitioner(X, max_partitions=sizes["mesh"]),
                        eps=eps, min_samples=10, block=block, mesh=mesh,
                        device=dev, halo="ring", merge="device")
                    lab = densify_labels(lab)
                else:
                    model = DBSCAN(eps=eps, min_samples=10, block=block,
                                   mesh=mesh, merge="device", device=dev)
                    if tag == "device":
                        with spy:
                            model.fit(Xd)
                    else:
                        model.fit(mm)
                    lab, core = model.labels_, model.core_sample_mask_
                    st = model.metrics_
                    # A fit records its retries on its own recorder.
                    counted = model._recorder
                    del model
                sync()
                wall = time.perf_counter() - t
        finally:
            sampler.stop()
        peak_rss = recorder.metrics.as_dict()["gauges"].get(
            "resources.peak_host_rss_bytes", 0)
        peak_dev = (torch.cuda.max_memory_allocated(dev) - dev0
                    if dev.type == "cuda" else 0)
        what = f"18.2 {tag} n={n} d=16 eps={eps}"
        la = mesh_launches(ck, st, what, GM_KERNELS["high"])
        hc = retries(counted)
        ss = st["stage_s"]
        log(f"  {what}: {wall:.4f} s on {card} (17.2's host-halo fit "
            f"{ref['wall_s']:.4f} s); stages {stages(st)} (17.2's "
            f"{ {k: round(v, 4) for k, v in ref['stage_s'].items()} }); "
            f"owned_cap {st['owned_cap']}, halo_cap {st['halo_cap']}, "
            f"halo_bytes {st['halo_bytes']}, ring.hcap retries {hc[0]}, "
            f"merge_rounds {st.get('merge_rounds')}, input "
            f"{st.get('input', 'host')}; peak host RSS "
            f"{peak_rss / 2**20:.1f} MiB ({(peak_rss - rss0) / 2**20:.1f} "
            f"MiB over the {rss0 / 2**20:.1f} MiB before), "
            f"max_memory_allocated {peak_dev / 2**20:.1f} MiB")
        if st.get("halo_exchange") != "ring" or st["n_shard_partitions"] \
                != sizes["mesh"] or st["owner_computes"] is not True:
            fail(f"{what}: halo_exchange {st.get('halo_exchange')}, "
                 f"{st['n_shard_partitions']} partitions, owner_computes "
                 f"{st['owner_computes']}")
        if tag == "ring":
            same = (np.array_equal(lab, ref["labels"])
                    and np.array_equal(core, ref["core"]))
            log(f"    {what}: labels and core byte-identical to 17.2's "
                f"host-halo fit: {same}")
            if not same:
                fail(f"{what}: the ring differs from the host halo")
            ring_fit = (lab, core, st)
        elif tag == "stream":
            same = (np.array_equal(lab, ring_fit[0])
                    and np.array_equal(core, ring_fit[1]))
            log(f"    {what}: labels and core byte-identical to the in-RAM "
                f"ring: {same}")
            if not same or st.get("input") != "stream":
                fail(f"{what}: the stream differs from the in-RAM ring")
        else:
            log(f"    {what}: floating tensors of >= {n} rows brought to "
                f"the host: {spy.seen}")
            if spy.seen or st.get("input") != "device":
                fail(f"{what}: the device-input route copied the "
                     f"coordinates to the host ({spy.seen}) or did not run "
                     f"(input {st.get('input')})")
            # Against the single-device fit of the same tensor: both
            # recentre on the tensor's float32 mean taken on the card.
            hold_chained(torch, dev, X, eps, lab, core,
                         main["tensor_labels"], main["tensor_core"], what)
            del Xd
        rows[tag] = {
            "wall_s": wall, "host_halo_wall_s": ref["wall_s"],
            "stage_s": ss, "host_halo_stage_s": ref["stage_s"],
            **{k: st.get(k) for k in (
                "owned_cap", "halo_cap", "halo_bytes", "merge_rounds",
                "live_pairs", "partition_passes", "input")},
            "hcap_retries": hc[0],
            "peak_host_rss_bytes": int(peak_rss),
            "host_rss_rise_bytes": int(peak_rss - rss0),
            "max_memory_allocated_bytes": int(peak_dev),
            "launches": {k: la[k] for k in GM_KERNELS["high"]}}
        stamp(f"18.2: {tag} done")
    part = KDPartitioner(X, max_partitions=sizes["mesh"])
    # The ring fit again, warm: its owned slabs come from the staging
    # cache's ring_owned route (the stream and the tensor cache nothing).
    ck.reset_launch_counts()
    sync()
    t = time.perf_counter()
    w_lab, w_core, w_st = sharded_dbscan(
        X, part, eps=eps, min_samples=10, block=block, mesh=mesh,
        device=dev, halo="ring", merge="device")
    sync()
    w_wall = time.perf_counter() - t
    w_la = mesh_launches(ck, w_st, "18.2 ring warm", GM_KERNELS["high"])
    cold_b = ring_fit[2]["staged_bytes"]
    log(f"  18.2 ring warm: {w_wall:.4f} s on {card} (cold "
        f"{rows['ring']['wall_s']:.4f} s), staged {w_st['staged_bytes']}, "
        f"reused {w_st['staged_bytes_reused']} of the cold fit's {cold_b} "
        f"bytes, stages {stages(w_st)}")
    if (not np.array_equal(densify_labels(w_lab), ring_fit[0])
            or not np.array_equal(w_core, ring_fit[1])
            or w_st["staged_bytes"] or not cold_b
            or w_st["staged_bytes_reused"] != cold_b
            or {k: w_la[k] for k in GM_KERNELS["high"]}
            != rows["ring"]["launches"]):
        fail("18.2: the warm ring refit was not a staging hit equal to the "
             "cold fit")
    rec["staging"] = {"cold_staged_bytes": cold_b,
                      "cold_s": rows["ring"]["wall_s"], "warm_s": w_wall}
    rows["ring"]["slab_hold"] = gm_slab_hold(
        torch, dev, ring_largest_slab(
            torch, dev, X, part, eps, block, mesh, ring_fit[2]["halo_cap"],
            ring_fit[1]),
        eps, sizes["hold_tiles"], "18.2 ring largest slab")
    rows["stream"]["traced_host_bytes"] = layout_host_peaks(
        torch, X, mm, part, eps, block, mesh, ring_fit[2]["owned_cap"])
    rec.update(main=rows["ring"], stream=rows["stream"],
               device=rows["device"])
    del mm
    os.remove(mm_path)
    stamp("18.2: done")

    # 18.3: the hcap ladder at 512-D.
    kw = dict(eps=sizes["sk_eps"], min_samples=10, block=sizes["sk_block"])
    if "mesh_sketch" not in keep:
        Xe, _te = make_embedding_data(sizes["sk_n"], 512)
        host = DBSCAN(mesh=mesh, device=dev, **kw).fit(Xe)
        keep["mesh_sketch"] = dict(X=Xe, labels=host.labels_,
                                   core=host.core_sample_mask_,
                                   wall_s=None, stage_s={})
        del host
    sk = keep["mesh_sketch"]
    Xe = sk["X"]
    recorder = obs.RunRecorder(device=dev)
    ck.reset_launch_counts()
    with obs.use_recorder(recorder):
        (lab, core, st), wall = ring(Xe, sizes["mesh"], merge="device", **kw)
    hc = retries(recorder)
    overflows = recorder.event_counts().get("halo_overflow", 0)
    what = f"18.3 n={len(Xe)} d=512"
    la = mesh_launches(ck, st, what, GM_KERNELS["sketch"])
    lab = densify_labels(lab)
    same = np.array_equal(lab, sk["labels"]) and np.array_equal(core,
                                                                sk["core"])
    start = st["halo_cap"] >> hc[0]
    log(f"  {what} over {st['n_shard_partitions']} partitions, sketch_k "
        f"{st['sketch_k']}: {wall:.4f} s on {card} (17.3's host-halo fit "
        f"{sk['wall_s']} s); the hcap ladder: {start} -> {st['halo_cap']} "
        f"in {hc[0]} ring.hcap retries ({overflows} halo_overflow events), "
        f"owned_cap {st['owned_cap']}, halo_bytes {st['halo_bytes']}; "
        f"stages {stages(st)}; labels and core byte-identical to 17.3's: "
        f"{same}")
    if not same or st["sketch_k"] <= 0 or hc[0] < 1 or overflows != hc[0]:
        fail(f"{what}: the ring differs from the host halo or its ladder "
             f"did not climb (retries {hc[0]}, overflows {overflows})")
    rec["sketch"] = {
        "n": len(Xe), "wall_s": wall, "host_halo_wall_s": sk["wall_s"],
        "sketch_k": st["sketch_k"], "hcap_start": start,
        "halo_cap": st["halo_cap"], "hcap_retries": hc[0],
        "halo_bytes": st["halo_bytes"], "stage_s": st["stage_s"],
        "launches": {k: la[k] for k in GM_KERNELS["sketch"]},
        "slab_hold": gm_slab_hold(
            torch, dev, ring_largest_slab(
                torch, dev, Xe, KDPartitioner(Xe,
                                              max_partitions=sizes["mesh"]),
                kw["eps"], kw["block"], mesh, st["halo_cap"], core),
            kw["eps"], sizes["hold_tiles"], f"{what} largest slab")}
    del Xe  # phase 20.3 fits keep["mesh_sketch"] again
    stamp("18.3: done")

    # 18.4: an explicit hcap too small to hold.
    first = next(iter(cases))
    x, parts, kw = cases[first]
    recorder = obs.RunRecorder(device=dev)
    err = None
    try:
        with obs.use_recorder(recorder):
            ring(x, parts, hcap=kw["block"], **kw)
    except RuntimeError as e:
        err = str(e)
    hc = retries(recorder)
    want = (f"ring halo buffer overflow at hcap={kw['block']}; pass a "
            f"larger hcap")
    log(f"  18.4 {first} at hcap={kw['block']}: raised {err!r}, "
        f"ring.hcap retries {hc[0]}, giveups {hc[1]}")
    if err != want or hc != (0, 1):
        fail("18.4: a too-small explicit hcap did not raise its named "
             "error once")
    rec["hcap_error"] = err
    stamp("18.4: done")
    return rec


STAGING_SIZES = {"n": 1_000_000, "eps": 2.4, "block": 2048, "other_ms": 20,
                 "miss_eps": 1.4, "fp_reps": 3, "sweep_n": 200_000,
                 "sweep_eps": [1.0, 1.15], "warm_eps": 0.9, "small_n": 20_000,
                 "mesh": 4, "live_rows": 8}


def staging_phase(torch, dev, sync, card="", sizes=STAGING_SIZES, main=None,
                  warm512=None, warm_routes=None):
    """Phase 19 (the staging cache); see the module docstring.  ``main``:
    phase 4's 1M x 16-D host input (None: made here); ``warm512``: phase
    7.3's cold and warm 1M x 512 host fits (19.2, reported here);
    ``warm_routes``: the KD routes' warm refits of phases 13.1, 17.2 and
    18.2 (19.4, reported here).  Returns the phase's record, whose
    ``launches_warm`` the kernels' line reads."""
    from benchdata import make_blob_data, make_separated_blob_data
    import tempfile

    from pypardis_tpu_torch import DBSCAN, KDPartitioner, obs
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import Mesh, sharded_dbscan, staging
    from pypardis_tpu_torch.serve import ModelGateway, build_index
    from pypardis_tpu_torch.utils import faults

    rec = {"card": card}
    t_phase = time.perf_counter()
    n, eps, block = sizes["n"], sizes["eps"], sizes["block"]

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def fit(X, what, **kw):
        model = DBSCAN(**{**dict(eps=eps, min_samples=10, block=block,
                                 device=dev), **kw})
        ck.reset_launch_counts()
        sync()
        t = time.perf_counter()
        model.fit(X)
        sync()
        wall = time.perf_counter() - t
        m = model.metrics_
        out = dict(labels=model.labels_, core=model.core_sample_mask_,
                   wall_s=wall, launches=dict(ck.LAUNCHES),
                   staged=int(m["staged_bytes"]),
                   reused=int(m["staged_bytes_reused"]), model=model)
        log(f"    {what}: {wall:.4f} s, staged_bytes {out['staged']}, "
            f"staged_bytes_reused {out['reused']}, launches "
            f"B1={out['launches']['count_pairs']} "
            f"B2={out['launches']['minlab_pairs']}")
        return out

    def same(a, b, what):
        if not (np.array_equal(a["labels"], b["labels"])
                and np.array_equal(a["core"], b["core"])):
            fail(f"{what}: labels or core differ")

    def uncached(X, what, **kw):
        """A fit with the cache off: the reference a warm fit must equal."""
        with env_set(PPTORCH_LAYOUT_CACHE="0"):
            return fit(X, what + " (cache off)", **kw)

    # 19.1: the single-card layout cache on phase 4's data.
    X = main if main is not None else make_blob_data(n, 16, n_centers=32,
                                                     std=0.4)[0]
    fp_ms = {}
    for arr in (X, X.astype(np.float64)):
        times = []
        for _ in range(sizes["fp_reps"]):
            t = time.perf_counter()
            staging.points_fingerprint(arr)
            times.append(time.perf_counter() - t)
        fp_ms[str(arr.dtype)] = float(np.median(times)) * 1e3
        log(f"  19.1 n={len(X)} d=16: the fingerprint (crc32 over "
            f"{arr.nbytes} bytes of {arr.dtype}) "
            f"{fp_ms[str(arr.dtype)]:.3f} ms (median of {len(times)}, "
            f"host)")
        del arr
    staging.clear()
    c = fit(X, "19.1 cold")
    w = fit(X, "19.1 warm")
    same(w, c, "19.1 warm vs cold")
    if not c["staged"]:
        fail("19.1: the cold fit staged nothing")
    if w["staged"] or w["reused"] != c["staged"]:
        fail(f"19.1: the warm fit staged {w['staged']} and reused "
             f"{w['reused']} bytes (the cold fit staged {c['staged']})")
    if w["launches"] != c["launches"]:
        fail(f"19.1: the warm fit launched {w['launches']}, the cold "
             f"{c['launches']}")
    if w["launches"]["count_pairs"] < 1 or w["launches"]["minlab_pairs"] < 1:
        fail("19.1: a kernel of the warm path was never launched")
    ms = sizes["other_ms"]
    wm = fit(X, f"19.1 warm at min_samples={ms}", min_samples=ms)
    if wm["staged"] or wm["reused"] != c["staged"]:
        fail(f"19.1: min_samples={ms} did not reuse the layout")
    same(wm, uncached(X, f"19.1 min_samples={ms}", min_samples=ms),
         f"19.1 min_samples={ms}")
    me = fit(X, f"19.1 eps={sizes['miss_eps']}", eps=sizes["miss_eps"])
    if me["reused"] or not me["staged"]:
        fail(f"19.1: eps={sizes['miss_eps']} did not miss the layout")
    same(me, uncached(X, f"19.1 eps={sizes['miss_eps']}",
                  eps=sizes["miss_eps"]), f"19.1 eps={sizes['miss_eps']}")
    fit(X, "19.1 eps=2.4 again (a miss: eps 1.4's layout replaced it)")
    Xm = X.copy()
    fit(Xm, "19.1 a copy (same content: a hit)")
    Xm[:1000] += 50.0  # in place: the same array object
    mm = fit(Xm, "19.1 mutated in place")
    if mm["reused"]:
        fail("19.1: an input mutated in place was served from the cache")
    same(mm, uncached(Xm, "19.1 mutated"), "19.1 mutated in place")
    del Xm
    rec["layout"] = {
        "n": len(X), "fingerprint_ms": fp_ms, "cold_s": c["wall_s"],
        "warm_s": w["wall_s"], "other_ms_warm_s": wm["wall_s"],
        "miss_eps_s": me["wall_s"], "staged_bytes": c["staged"],
        "launches_cold": c["launches"], "launches_warm": w["launches"]}
    log(f"  19.1: cold {c['wall_s']:.4f} s, warm {w['wall_s']:.4f} s on "
        f"{card} (the layout's {c['staged']} bytes reused)")
    staging.clear()
    stamp("19.1: done")

    # 19.2: phase 7.3's 1M x 512 refit (the layout cached under a raised
    # PPTORCH_LAYOUT_CACHE_MAX).
    if warm512 is not None:
        rec["layout_512"] = warm512
        log(f"  19.2 (phase 7.3) n={warm512['n']} d=512: cold "
            f"{warm512['cold_s']:.4f} s, warm {warm512['warm_s']:.4f} s on "
            f"{card}; {warm512['staged_bytes']} bytes reused; launches "
            f"{warm512['launches_warm']}")

    # 19.3: a second sweep under the first sweep's eps ceiling.
    Xs, _t = make_blob_data(sizes["sweep_n"], 16, n_centers=32, std=0.4,
                            seed=5)
    staging.clear()
    sync()
    t = time.perf_counter()
    first = DBSCAN(eps=eps, min_samples=10, block=block,
                   device=dev).sweep(Xs, sizes["sweep_eps"])
    sync()
    s1 = time.perf_counter() - t
    ms_list = [10]
    sweeper = DBSCAN(eps=eps, min_samples=10, block=block, device=dev)
    t = time.perf_counter()
    second = sweeper.sweep(Xs, [sizes["warm_eps"]], ms_list)
    sync()
    s2 = time.perf_counter() - t
    reused = int(sweeper.metrics_["staged_bytes_reused"])
    if first.stats["degraded"] or not first.stats["graph_pairs"]:
        fail(f"19.3: the first sweep built no graph "
             f"({first.stats['degraded']})")
    if sweeper.metrics_["staged_bytes"]:
        fail("19.3: the covered sweep shipped its graph again")
    ref = fit(Xs, f"19.3 the fit at eps={sizes['warm_eps']}",
              eps=sizes["warm_eps"])
    got = dict(labels=second.labels(sizes["warm_eps"], 10),
               core=second.core(sizes["warm_eps"], 10))
    same(got, ref, f"19.3 warm sweep eps={sizes['warm_eps']}")
    if (reused <= 0 or second.stats["graph_pairs"]
            != first.stats["graph_pairs"]):
        fail(f"19.3: the second sweep did not reuse the first's graph "
             f"(reused {reused}, graph pairs "
             f"{second.stats['graph_pairs']} against "
             f"{first.stats['graph_pairs']})")
    rec["sweep"] = {"n": len(Xs), "first_s": s1, "second_s": s2,
                    "graph_pairs": first.stats["graph_pairs"],
                    "reused_bytes": reused}
    log(f"  19.3 n={len(Xs)}: sweep {sizes['sweep_eps']} {s1:.4f} s, then "
        f"[{sizes['warm_eps']}] {s2:.4f} s from the cached graph "
        f"({first.stats['graph_pairs']} pairs, {reused} bytes reused)")
    staging.clear()
    stamp("19.3: done")

    # 19.4: the KD routes' warm refits (phases 13.1, 17.2, 18.2) and the
    # staging.device_put OOM rung on a 20k mesh fit.
    rec["kd"] = warm_routes or {}
    for where, r in rec["kd"].items():
        log(f"  19.4 {where}: {r}")
    Xk, _tk, _ck = make_separated_blob_data(
        sizes["small_n"], 16, n_centers=8, min_sep=12.0, spread=12.0,
        seed=13)
    mesh = Mesh([dev] * sizes["mesh"])
    kw = dict(eps=2.0, min_samples=10, block=256, mesh=mesh, device=dev)
    staging.clear()
    clean = sharded_dbscan(Xk, KDPartitioner(Xk, max_partitions=8), **kw)
    staging.clear()
    recorder = obs.RunRecorder()
    with obs.use_recorder(recorder), \
            faults.plan("staging.device_put:1=oom"):
        hurt = sharded_dbscan(Xk, KDPartitioner(Xk, max_partitions=8), **kw)
    c_ = recorder.metrics.as_dict()["counters"]
    injected = int(c_.get("faults.injected", 0))
    retried = int(c_.get("retry.staging.device_put.attempts", 0))
    same(dict(labels=hurt[0], core=hurt[1]),
         dict(labels=clean[0], core=clean[1]), "19.4 staging.device_put oom")
    if injected != 1 or retried < 1:
        fail(f"19.4: the injected OOM did not recover through the staging "
             f"rung (injected {injected}, retried {retried})")
    rec["oom"] = {"injected": injected, "retried": retried}
    log(f"  19.4 staging.device_put:1=oom on a {len(Xk)}-point mesh fit: "
        f"injected {injected}, retried {retried}, labels equal the clean "
        f"fit's")
    staging.clear()
    stamp("19.4: done")

    # 19.5: the serving route.
    model = ref["model"]
    staging.clear()
    ck.reset_launch_counts()
    idx1 = build_index(model)
    idx2 = build_index(model)
    tables = ck.LAUNCHES["query_tables"]
    if (not idx1.stats["staged_bytes"] or idx2.stats["staged_bytes"]
            or idx2.stats["staged_bytes_reused"]
            != idx1.stats["staged_bytes"]):
        fail(f"19.5: the second index build did not reuse the first's "
             f"tensors ({idx1.stats}, {idx2.stats})")
    eng = model.query_engine()
    ck.reset_launch_counts()
    eng.predict(Xs[:4096])
    b5 = ck.LAUNCHES["query_leaf"]
    if b5 < 1:
        fail("19.5: predict on the warm index never launched B5")
    live = model.live()
    # Next to core points: the inserted rows are cores, so the commit
    # ships index columns.
    live.insert(Xs[model.core_sample_mask_][:sizes["live_rows"]] + 0.01)
    delta = live.index.delta_bytes
    route_delta = staging.route_delta_nbytes(live.index.delta_route)
    if not delta or route_delta != delta:
        fail(f"19.5: the live commit's delta bytes {delta} are not the "
             f"delta route's {route_delta}")
    spill = tempfile.TemporaryDirectory()
    gw = ModelGateway(budget_bytes=1 << 40, spill_dir=spill.name)
    h = gw.register("staged", model)
    route = h.index.staging_route
    before = staging.route_nbytes(route)
    gw._evict(h)
    after = staging.route_nbytes(route)
    spill.cleanup()
    if not before or after:
        fail(f"19.5: the gateway's eviction left {after} of {before} bytes "
             f"on its route")
    rec["serve"] = {"index_staged_bytes": idx1.stats["staged_bytes"],
                    "warm_build_reused": idx2.stats["staged_bytes_reused"],
                    "query_tables": tables, "query_leaf": b5,
                    "delta_bytes": delta, "route_bytes_before_evict": before}
    log(f"  19.5: a warm second index build reused "
        f"{idx2.stats['staged_bytes_reused']} bytes (query_tables "
        f"launches {tables}), 4096 predicts launched B5 {b5} times; a live "
        f"commit shipped {delta} delta bytes, its route counted "
        f"{route_delta}; the gateway's eviction emptied {route} "
        f"({before} -> {after} bytes)")
    del idx1, idx2, eng, live, gw, h
    staging.clear()
    rec["launches_warm"] = dict(rec["layout"]["launches_warm"],
                                query_leaf=b5)
    rec["seconds"] = time.perf_counter() - t_phase
    stamp("19.5: done")
    return rec


# Phase 20: the global-Morton mesh engine on a mesh that repeats the one
# card `mesh` times.  20.1 reuses 13.1's 20,000 x 16-D blobs (eps 2.0,
# block 256) over 4 and 8 shards, each (shards, merge, overlap) case of
# gm_cases; 20.2 phase 4's 1M x 16-D blobs over `mesh` shards under both
# merges; 20.3 phase 7's 100k x 512 embeddings with the sketch; 20.4 the
# 1M on a one-card mesh with chain 0; 20.5 the first stream_n points of
# phase 4's data from a float32 memmap; 20.6 20.1's data over 4 shards.
GMMESH_SIZES = {"gm_cases": [[4, "device", 1], [4, "host", 0],
                             [8, "device", 0], [8, "host", 1]],
                "mesh": 4, "n": 1_000_000, "eps": 2.4, "block": 2048,
                "hold_tiles": 64, "stream_n": 200_000, "sk_n": 100_000,
                "sk_eps": 2.0, "sk_block": 2048, "sk_hold_tiles": 16}


@contextlib.contextmanager
def gm_overlap(on):
    """``PPTORCH_GM_OVERLAP`` set to ``on`` for the block."""
    prev = os.environ.get("PPTORCH_GM_OVERLAP")
    os.environ["PPTORCH_GM_OVERLAP"] = "1" if on else "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("PPTORCH_GM_OVERLAP", None)
        else:
            os.environ["PPTORCH_GM_OVERLAP"] = prev


def gmmesh_cpu_cases(sizes):
    """20.1's cases from 13.1's 20k data: ``{name: (X, shards,
    kwargs)}``, ``kwargs["overlap"]`` the overlap switch."""
    Xs, _p, kw_s = chained_cpu_cases(sizes)["small"]
    return {f"p{p}_{merge}_{'overlap' if ov else 'serial'}":
            (Xs, p, dict(kw_s, merge=merge, overlap=ov))
            for p, merge, ov in sizes["gm_cases"]}


def gmmesh_stats(stats):
    """A mesh-engine fit's stats without timings, the staging counters,
    the overlap's timed efficiency and the parity extras."""
    return {k: v for k, v in gm_stats(stats).items()
            if k not in ("parity", "exchange_overlap_efficiency")}


def gmmesh_fit(x, mesh, device, **kw):
    """``global_morton_dbscan`` with ``kw["overlap"]`` as the overlap."""
    from pypardis_tpu_torch.parallel import global_morton_dbscan

    kw = dict(kw)
    with gm_overlap(kw.pop("overlap", 1)):
        return global_morton_dbscan(x, mesh=mesh, device=device, **kw)


def gmmesh_cpu_runs(cases):
    """Each case through the port's mesh engine on a CPU mesh (the
    kernels' plain versions): ``{name: ((labels, core, stats),
    seconds)}``."""
    from pypardis_tpu_torch.parallel import Mesh

    out = {}
    for name, (x, shards, kw) in cases.items():
        t = time.perf_counter()
        lab, core, st = gmmesh_fit(x, Mesh(["cpu"] * shards), "cpu", **kw)
        out[name] = ((lab, core, gmmesh_stats(st)), time.perf_counter() - t)
    return out


def gmmesh_launches(ck, stats, what, kernels):
    """The mesh engine's launches against its passes: the counts kernel
    once per overlapped owned-slab pass (``stage_s["owned_passes"]``)
    and once per shard's cluster pass (the fused counts or the boundary
    delta), the min-label kernel once per propagation pass
    (``stats["partition_passes"]``: 1 + the shard's min-label passes);
    no other kernel."""
    la = dict(ck.LAUNCHES)
    ran = [p for p in stats["partition_passes"] if p]
    owned = int(stats["stage_s"].get("owned_passes", 0))
    want = {kernels[0]: owned + len(ran), kernels[1]: sum(p - 1 for p in ran)}
    others = {k: v for k, v in la.items() if k not in want and v}
    log(f"    {what}: launches {kernels[0]}={la[kernels[0]]} "
        f"{kernels[1]}={la[kernels[1]]} for {owned} owned-slab passes and "
        f"{len(ran)} shard passes, passes {stats['partition_passes']} (want "
        f"{want}); other kernels {others}")
    if la[kernels[0]] < 1 or la[kernels[1]] < 1:
        fail(f"{what}: a kernel of the mesh engine was never launched")
    if {k: la[k] for k in want} != want or others:
        fail(f"{what}: launches do not match the shards' passes")
    return la


def gmmesh_slab_hold(torch, dev, X, eps, block, mesh, core_g, tiles, what):
    """The mesh engine's three launches on its largest combined slab (the
    shard with the most owned + boundary rows, from the route's own
    cached build and exchange) against their plain versions, exactly:
    the counts kernel (B1, or B3 with the sketch) over the owned slab's
    own list (the overlapped owned pass) on its first ``tiles`` row
    tiles, over the combined slab's (owned row, boundary column) list
    (the boundary delta) on the same rows, and one min-label pass (B2,
    or B4) over the propagation list on the first ``tiles`` owned and
    ``tiles`` boundary row tiles at the round-1 labels.  Returns the
    record with each kernel's largest error."""
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, eps2_f32, row_offsets,
    )
    from pypardis_tpu_torch.ops.labels import oc_extract
    from pypardis_tpu_torch.ops.sketch import sketch_dims
    from pypardis_tpu_torch.parallel import global_morton as gm
    from pypardis_tpu_torch.utils.shaping import clamp_block

    n, k = X.shape
    block = clamp_block(block, -(-n // mesh.size))
    arrays, _aux, _b, base = gm.build_morton_shards(X, mesh.size, block,
                                                    mesh, eps=eps)
    (bnd, bmsk, bgid), _x = gm._gm_boundary_tiles(
        arrays, eps, mesh=mesh, block=block, btcap=None, base=base,
        sketch=int(sketch_dims(k)))
    owned, omsk, ogid = arrays
    s = int(np.argmax([int(omsk[i].sum()) + int(bmsk[i].sum())
                       for i in range(mesh.size)]))
    cap = owned[s].shape[1]
    xs = torch.cat([owned[s], bnd[s]], dim=1)
    mask = torch.cat([omsk[s], bmsk[s]])
    gid = torch.cat([ogid[s], bgid[s]])

    def extract(pts, msk):
        ex = oc_extract(pts, eps, msk, owned=cap, block=block)
        if ex["total"] > ex["budget"]:
            ex = oc_extract(pts, eps, msk, owned=cap, block=block,
                            pair_budget=ex["total"])
        return ex

    ex, own = extract(xs, mask), extract(owned[s], omsk[s])
    rows, cols = ex["pairs"]
    tile, ont, kk = ex["tile"], ex["ont"], ex["k"]
    N = xs.shape[1]
    nt = N // tile
    sub = min(tiles, ont)
    e2 = eps2_f32(eps)
    names = GM_KERNELS["sketch" if kk else "high"]
    tix = torch.arange(N, device=dev) // tile
    held_c = mask & (tix < sub)
    held_b = mask & ((tix < sub) | ((tix >= ont) & (tix < ont + tiles)))
    core_all = torch.from_numpy(
        core_g[np.clip(gid.cpu().numpy(), 0, n - 1)]).to(dev) & (gid < n)
    f = torch.where(core_all, torch.arange(N, device=dev, dtype=torch.int32),
                    INT_INF).contiguous()

    def counts(ex_, pts, msk, sel):
        r, c = ex_["pairs"]
        nt_ = pts.shape[1] // tile
        a = (pts, msk.to(torch.int32), row_offsets(r[sel], nt_),
             c[sel].contiguous())
        centers = ex_["frames"][0]
        if kk:
            a = a + (ex_["slab"][0], kk, e2, ex_["slab"][1], tile)
            (kc, kst), (pc, pst) = (ck.count_pairs_sketch(*a, "high", centers),
                                    ck.PLAIN["count_pairs_sketch"](*a))
            return kc, pc, int((kst != pst).sum())
        a = a + (e2, tile)
        return ck.count_pairs(*a, centers), ck.PLAIN["count_pairs"](*a), 0

    o_rows, _o_cols = own["pairs"]
    k_own, p_own, st_own = counts(own, owned[s], omsk[s], o_rows < sub)
    k_del, p_del, st_del = counts(ex, xs, mask,
                                  (rows < sub) & (cols >= ont))
    sel_b = ~((rows >= ont) & (cols >= ont)) & (
        (rows < sub) | ((rows >= ont) & (rows < ont + tiles)))
    b = (xs, f, row_offsets(rows[sel_b], nt), cols[sel_b].contiguous())
    if kk:
        b = b + (ex["slab"][0], kk, e2, ex["slab"][1], tile)
        kb, pb = ck.minlab_pairs_sketch(*b), ck.PLAIN["minlab_pairs_sketch"](*b)
    else:
        b = b + (e2, tile)
        kb = ck.minlab_pairs(*b, live_rows=mask)
        pb = ck.PLAIN["minlab_pairs"](*b, live_rows=mask)
    held_o = held_c[:cap]
    err_c = max(int((k_own[held_o].long() - p_own[held_o].long()).abs().max()),
                int((k_del[held_c].long() - p_del[held_c].long()).abs().max()))
    err_b = int((kb[held_b].long() - pb[held_b].long()).abs().max())
    bad = (int((k_own[held_o] != p_own[held_o]).sum()),
           int((k_del[held_c] != p_del[held_c]).sum()),
           int((kb[held_b] != pb[held_b]).sum()))
    delta_hits = int(p_del[held_c].sum())
    relayed = int(((pb != INT_INF) & held_b & (tix >= ont)).sum())
    log(f"    {what}: shard {s}'s combined slab ({int(omsk[s].sum())} owned "
        f"of cap {cap}, {int(bmsk[s].sum())} boundary rows in "
        f"{bnd[s].shape[1] // block} tiles; tile {tile}, k {kk}, "
        f"{ex['total']} live tile pairs, {ex['hh_pairs']} boundary x "
        f"boundary): {names[0]} on the first {sub} owned row tiles "
        f"({int(held_c.sum())} points) over the owned slab's list "
        f"{bad[0]} differ, over the boundary-delta list {bad[1]} differ "
        f"({delta_hits} boundary neighbours counted){', stats differ' if st_own or st_del else ''}"
        f"; {names[1]} (round 1) on {sub} owned + {min(tiles, nt - ont)} "
        f"boundary row tiles ({int(held_b.sum())} points, {relayed} "
        f"boundary rows reaching an owned source) {bad[2]} differ")
    if any(bad) or st_own or st_del:
        fail(f"{what}: the kernels disagree with their plain versions over "
             f"the mesh engine's lists")
    if not delta_hits or not relayed:
        fail(f"{what}: the held rows count or reach nothing across the "
             f"boundary")
    return {"shard": s, "rows": N, "owned": int(omsk[s].sum()),
            "boundary": int(bmsk[s].sum()), "tile": tile, "tiles_held": sub,
            "points_held": int(held_b.sum()), "delta_neighbours": delta_hits,
            "max_abs_err": {names[0]: err_c, names[1]: err_b}}


def gmmesh_phase(torch, dev, sync, card="", sizes=GMMESH_SIZES, main=None,
                 cpu_refs=None, walls=None, keep=None):
    """Phase 20 (the global-Morton mesh engine,
    ``global_morton_dbscan(..., mesh=Mesh(["cuda:0"] * P))`` and
    ``DBSCAN(mode="global_morton", mesh=...)``); see the module
    docstring.  ``main``: ``dict(X=, labels=, core=)`` of phase 4's 1M
    fit (None: fitted here); ``cpu_refs``: a :class:`ChainedCpuRefs`
    with a ``"gmmesh"`` job (None: 20.1's CPU runs go here first);
    ``walls``: the 1M walls printed beside 20.2's (17.2's fused step,
    18.2's ring); ``keep``: phase 16-18's fits (``"gm_chained"``: 16.2's
    labels, ``"mesh_sketch"``: 17.3's 100k x 512 data and fit; missing
    ones are fitted here).  Returns the phase's record."""
    from benchdata import make_embedding_data
    from pypardis_tpu_torch import DBSCAN, obs
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.parallel import (
        Mesh, global_morton_dbscan, staging,
    )
    from pypardis_tpu_torch.parallel import global_morton as gm
    from pypardis_tpu_torch.ops.labels import densify_labels
    from pypardis_tpu_torch.utils import faults
    from pypardis_tpu_torch.utils.shaping import clamp_block

    rec = {"card": card}
    walls = walls or {}
    keep = {} if keep is None else keep
    t_phase = time.perf_counter()
    all_sizes = dict(CHAINED_SIZES, **sizes)
    mesh = Mesh([dev] * sizes["mesh"])
    log(f"  mesh {mesh!r} on {torch.cuda.device_count()} card(s): "
        f"copies between distinct cards and shards running at once are "
        f"not measured here")

    def stamp(what):
        log(f"  [{time.perf_counter() - t_phase:.1f} s] {what}")

    def timed(fn):
        sync()
        t = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t

    # 20.1: the card against the port's CPU mesh engine.
    cases = gmmesh_cpu_cases(all_sizes)
    cpu_now = None if cpu_refs else gmmesh_cpu_runs(cases)
    on_card = {}
    for name, (x, shards, kw) in cases.items():
        ck.reset_launch_counts()
        on_card[name] = timed(lambda: gmmesh_fit(
            x, Mesh([dev] * shards), dev, **kw))
        (lab, _core, st), wall = on_card[name]
        gmmesh_launches(ck, st, f"20.1 {name}", GM_KERNELS["high"])
        log(f"  20.1 {name}: n={len(x)} d={x.shape[1]} over {shards} "
            f"shards: card {wall:.4f} s; clusters "
            f"{len(np.unique(lab[lab >= 0]))}, boundary tiles "
            f"{st['boundary_tiles']} ({st['boundary_rows']} rows), sent "
            f"{st['sent_tiles']}, fixpoint_rounds {st['fixpoint_rounds']}, "
            f"exchange_overlap_efficiency "
            f"{st['exchange_overlap_efficiency']}")
    stamp("20.1: card runs done")

    def close_20_1():
        cpu = cpu_now or cpu_refs.result(cases, "gmmesh")
        for name, ((lab, core, st), _s) in on_card.items():
            (c_lab, c_core, c_st), c_s = cpu[name]
            st = json.loads(json.dumps(gmmesh_stats(st)))
            diff = sorted(k for k in set(c_st) | set(st)
                          if c_st.get(k) != st.get(k))
            same = np.array_equal(lab, c_lab) and np.array_equal(core, c_core)
            log(f"    20.1 {name}: card vs CPU ({c_s:.4f} s"
                f"{' in a child process' if cpu_refs else ''}): labels and "
                f"core byte-identical: {same}; stats that differ: {diff}")
            if not same or diff:
                fail(f"20.1 {name}: the card's mesh engine differs from the "
                     f"CPU's")
        rec["small"] = {name: {"card_s": c[1], "cpu_s": cpu[name][1]}
                        for name, c in on_card.items()}
        stamp("20.1: done")

    # 20.2: the main path at full width through DBSCAN(mode=..., mesh=...).
    n, eps, block = sizes["n"], sizes["eps"], sizes["block"]
    if main is None:
        from benchdata import make_blob_data

        X, _truth = make_blob_data(n, 16, n_centers=32, std=0.4)
        single = DBSCAN(eps=eps, min_samples=10, block=block,
                        device=dev).fit(X)
        main = dict(X=X, labels=single.labels_,
                    core=single.core_sample_mask_)
    X = main["X"]
    rows, fits = {}, {}
    for merge in ("device", "host"):
        model = DBSCAN(eps=eps, min_samples=10, block=block, mesh=mesh,
                       merge=merge, mode="global_morton", device=dev)
        ck.reset_launch_counts()
        _m, wall = timed(lambda: model.fit(X))
        st = model.metrics_
        what = f"20.2 n={n} d=16 eps={eps} merge={merge}"
        la = gmmesh_launches(ck, st, what, GM_KERNELS["high"])
        if (st.get("mode") != "global_morton" or st["merge"] != merge
                or st["duplicated_work_factor"] != 1.0
                or st["ring_rounds"] != sizes["mesh"] - 1
                or model.report()["run"]["n_devices"] != sizes["mesh"]):
            fail(f"{what}: mode {st.get('mode')}, merge {st['merge']}, "
                 f"duplicated_work_factor {st['duplicated_work_factor']}, "
                 f"ring_rounds {st['ring_rounds']}")
        ss = st["stage_s"]
        log(f"  {what} over {sizes['mesh']} shards: {wall:.4f} s from host "
            f"input on {card} (17.2's fused KD step "
            f"{walls.get('17.2', 'not run')} s, 18.2's KD ring "
            f"{walls.get('18.2', 'not run')} s; one card, so the shards run "
            f"one after another); gm_build_s {st['gm_build_s']}, "
            f"gm_exchange_s {st['gm_exchange_s']}, gm_execute_s "
            f"{st['gm_execute_s']}, gm_merge_s {st['gm_merge_s']}, "
            f"exchange_overlap_efficiency "
            f"{st['exchange_overlap_efficiency']} (one stream: the ring "
            f"queues behind the owned counts), passes on the card "
            f"{ss['device']:.4f} s (CUDA-event spans)")
        log(f"    owned_cap {st['owned_cap']}, halo_cap {st['halo_cap']}, "
            f"boundary tiles {st['boundary_tiles']} ({st['boundary_rows']} "
            f"rows, halo_factor {st['halo_factor']:.6f}), sent_tiles "
            f"{st['sent_tiles']}, boundary_tile_caps "
            f"{st['boundary_tile_caps']}, fixpoint_rounds "
            f"{st['fixpoint_rounds']}, pad_waste {st['pad_waste']:.6f}, "
            f"live pairs {st['live_pairs']}, kernel passes "
            f"{st['partition_passes']}, staged {st['staged_bytes']} bytes, "
            f"reused {st['staged_bytes_reused']}")
        clusters, borders, noise, differ = hold_chained(
            torch, dev, X, eps, model.labels_, model.core_sample_mask_,
            main["labels"], main["core"], what)
        fits[merge] = (model.labels_, model.core_sample_mask_)
        rows[merge] = {
            "wall_s": wall, "fused_kd_wall_s": walls.get("17.2"),
            "ring_kd_wall_s": walls.get("18.2"),
            **{k: st.get(k) for k in (
                "gm_build_s", "gm_exchange_s", "gm_execute_s", "gm_merge_s",
                "exchange_overlap_efficiency", "fixpoint_rounds",
                "boundary_tiles", "boundary_rows", "halo_factor",
                "sent_tiles", "halo_cap", "owned_cap", "live_pairs",
                "partition_passes", "staged_bytes", "staged_bytes_reused")},
            "stage_s": ss,
            "launches": {k: la[k] for k in GM_KERNELS["high"]},
            "clusters": clusters, "borders": borders, "noise": noise,
            "borders_differ": differ}
        if merge == "device":
            rows[merge]["slab_hold"] = gmmesh_slab_hold(
                torch, dev, X, eps, block, mesh, model.core_sample_mask_,
                sizes["hold_tiles"], f"{what} largest combined slab")
        del model
        stamp(f"20.2: merge {merge} done")
    same = all(np.array_equal(a, b) for a, b in zip(fits["device"],
                                                    fits["host"]))
    warm = (rows["host"]["staged_bytes"], rows["host"]["staged_bytes_reused"])
    log(f"  20.2: the device and host merges byte-identical: {same}; the "
        f"host-merge fit refits warm (staged, reused) {warm} after the "
        f"device fit's {rows['device']['staged_bytes']} staged bytes")
    if not same:
        fail("20.2: the two merges' labels differ")
    if warm != (0, rows["device"]["staged_bytes"]):
        fail("20.2: the warm refit did not reuse gm_owned and gm_boundary")
    rec["main"], rec["host"] = rows["device"], rows["host"]
    rec["main"]["merges_identical"] = same

    # 20.4: the unchained one-card form of the same fit.
    one, wall = timed(lambda: global_morton_dbscan(
        X, eps=eps, min_samples=10, block=block, mesh=Mesh([dev]), chain=0,
        device=dev))
    lab1, core1, st1 = one
    ref = fits["device"]
    same_mesh = (np.array_equal(densify_labels(lab1), ref[0])
                 and np.array_equal(core1, ref[1]))
    chained = keep.get("gm_chained")
    same_chain = (chained is not None and np.array_equal(lab1, chained[0])
                  and np.array_equal(core1, chained[1]))
    log(f"  20.4 n={n} on a one-card mesh, chain 0: {wall:.4f} s, "
        f"gm_build_s {st1['gm_build_s']}, gm_execute_s {st1['gm_execute_s']}"
        f", boundary tiles {st1['boundary_tiles']}, ring_rounds "
        f"{st1['ring_rounds']}; byte-identical to 20.2's mesh fit: "
        f"{same_mesh}, to 16.2's chained fit: "
        f"{same_chain if chained is not None else 'not run'}")
    hold_chained(torch, dev, X, eps, densify_labels(lab1), core1,
                 main["labels"], main["core"], "20.4")
    if not same_mesh or (chained is not None and not same_chain) \
            or st1["ring_rounds"] != 0:
        fail("20.4: the one-card form differs from the mesh or chained fit")
    rec["one_card"] = {"wall_s": wall, "gm_build_s": st1["gm_build_s"],
                       "gm_execute_s": st1["gm_execute_s"],
                       "same_as_mesh": same_mesh, "same_as_chained": same_chain}
    del one, lab1, core1
    stamp("20.4: done")

    # 20.5: the streaming build against the in-RAM build.
    ns = sizes["stream_n"]
    Xs = np.ascontiguousarray(X[:ns])
    mm, mm_path = gm_memmap(Xs, "gmmesh_stream")
    bs = clamp_block(block, -(-ns // sizes["mesh"]))
    staging.clear()
    (t_in, _a, _b, _k), s_in = timed(lambda: gm.build_morton_shards(
        Xs, sizes["mesh"], bs, mesh, eps=eps))
    staging.clear()
    (t_st, a_st, _b, _k), s_st = timed(
        lambda: gm.build_morton_shards_streaming(mm, sizes["mesh"], bs, mesh,
                                                 eps=eps))
    same_b = all(torch.equal(p, q) for tin, tst in zip(t_in, t_st)
                 for p, q in zip(tin, tst))
    staging.clear()
    in_fit = global_morton_dbscan(Xs, eps=eps, min_samples=10, block=block,
                                  mesh=mesh, device=dev)
    staging.clear()
    st_fit, wall = timed(lambda: global_morton_dbscan(
        mm, eps=eps, min_samples=10, block=block, mesh=mesh, device=dev))
    same_f = (np.array_equal(in_fit[0], st_fit[0])
              and np.array_equal(in_fit[1], st_fit[1]))
    log(f"  20.5 n={ns} from a float32 memmap over {sizes['mesh']} shards: "
        f"the streamed build ({s_st:.4f} s, {a_st['stream_buckets']} "
        f"buckets, spill {a_st['spill_bytes']} bytes) bitwise the in-RAM "
        f"build ({s_in:.4f} s): {same_b}; the streamed fit ({wall:.4f} s, "
        f"input {st_fit[2]['input']}) byte-identical to the in-RAM fit: "
        f"{same_f}")
    if not same_b or not same_f or st_fit[2]["input"] != "stream":
        fail("20.5: the streaming build differs from the in-RAM build")
    rec["stream"] = {"n": ns, "stream_build_s": s_st, "inram_build_s": s_in,
                     "fit_s": wall}
    del mm, t_in, t_st, in_fit, st_fit, Xs
    os.remove(mm_path)
    stamp("20.5: done")

    # 20.3: the sketch at width.
    kw = dict(eps=sizes["sk_eps"], min_samples=10, block=sizes["sk_block"])
    if "mesh_sketch" not in keep:
        Xe, _te = make_embedding_data(sizes["sk_n"], 512)
        single = DBSCAN(device=dev, **kw).fit(Xe)
        keep["mesh_sketch"] = dict(X=Xe, labels=single.labels_,
                                   core=single.core_sample_mask_)
        del single
    sk = keep["mesh_sketch"]
    Xe = sk["X"]
    model = DBSCAN(mesh=mesh, mode="global_morton", device=dev, **kw)
    ck.reset_launch_counts()
    _m, wall = timed(lambda: model.fit(Xe))
    st = model.metrics_
    what = f"20.3 n={len(Xe)} d=512"
    la = gmmesh_launches(ck, st, what, GM_KERNELS["sketch"])
    log(f"  {what} over {sizes['mesh']} shards, sketch_k {st['sketch_k']}: "
        f"{wall:.4f} s on {card}; sent_tiles {st['sent_tiles']} against "
        f"{st['sent_tiles_box']} by the full-d boxes alone "
        f"(boundary_bytes {st['boundary_tile_bytes']} against "
        f"{st['boundary_bytes_box']}), boundary tiles kept "
        f"{st['boundary_tiles']} ({st['boundary_rows']} rows, halo_factor "
        f"{st['halo_factor']:.6f}), gm_build_s {st['gm_build_s']}, "
        f"gm_exchange_s {st['gm_exchange_s']}, gm_execute_s "
        f"{st['gm_execute_s']}, band_pairs {st['band_pairs']}")
    if st["sketch_k"] <= 0 or st["sent_tiles"] > st["sent_tiles_box"]:
        fail(f"{what}: sketch_k {st['sketch_k']}, sent_tiles "
             f"{st['sent_tiles']} > sent_tiles_box {st['sent_tiles_box']}")
    clusters, borders, noise, differ = hold_chained(
        torch, dev, Xe, kw["eps"], model.labels_, model.core_sample_mask_,
        sk["labels"], sk["core"], what)
    rec["sketch"] = {
        "n": len(Xe), "wall_s": wall, "sketch_k": st["sketch_k"],
        **{k: st[k] for k in ("sent_tiles", "sent_tiles_box",
                              "boundary_tiles", "halo_factor", "gm_build_s",
                              "gm_exchange_s", "gm_execute_s", "gm_merge_s")},
        "launches": {k: la[k] for k in GM_KERNELS["sketch"]},
        "clusters": clusters, "borders_differ": differ,
        "slab_hold": gmmesh_slab_hold(
            torch, dev, Xe, kw["eps"], kw["block"], mesh,
            model.core_sample_mask_, sizes["sk_hold_tiles"],
            f"{what} largest combined slab")}
    del Xe, model, keep["mesh_sketch"]
    stamp("20.3: done")

    # 20.6: the capacity contract, the retried sites and the cache on
    # 20.1's data over 4 shards.
    x, _shards, kw = cases[next(iter(cases))]
    kw = {k: v for k, v in kw.items() if k != "overlap"}
    m4 = Mesh([dev] * 4)
    staging.clear()
    try:
        global_morton_dbscan(x, mesh=m4, device=dev, btcap=1, **kw)
        fail("20.6: btcap=1 did not raise")
    except RuntimeError as e:
        msg = str(e)
    log(f"  20.6 btcap=1 raises: {msg[:160]}")
    if "needs" not in msg or "PPTORCH_GM_BTCAP" not in msg:
        fail("20.6: the too-small btcap's error does not name the need")
    staging.clear()
    clean = global_morton_dbscan(x, mesh=m4, device=dev,
                                 **dict(kw, merge="device"))
    retried = {}
    for site in ("gm.ring_round", "gm.fixpoint_round"):
        staging.clear()
        recorder = obs.RunRecorder(device=dev)
        with obs.use_recorder(recorder), faults.plan(
                f"{site}:1=transfer_error"):
            lab, core, _st = global_morton_dbscan(
                x, mesh=m4, device=dev, **dict(kw, merge="device"))
        ev = recorder.event_counts()
        retried[site] = ev.get(f"retry.{site}", 0)
        same = np.array_equal(lab, clean[0]) and np.array_equal(core,
                                                                clean[1])
        log(f"  20.6 {site}:1=transfer_error retried {retried[site]} time, "
            f"labels and core equal to the clean run: {same}")
        if retried[site] != 1 or ev.get("fault_injected") != 1 or not same:
            fail(f"20.6: {site}'s transient fault was not retried once to "
                 f"the clean labels")
    staging.clear()
    sb = []
    for e in (kw["eps"], kw["eps"], 0.95 * kw["eps"]):
        st = global_morton_dbscan(x, mesh=m4, device=dev,
                                  **dict(kw, eps=e))[2]
        sb.append((st["staged_bytes"], st["staged_bytes_reused"]))
    log(f"  20.6 staging (staged, reused): cold {sb[0]}, warm refit {sb[1]}"
        f", eps x 0.95 {sb[2]}")
    if sb[1] != (0, sb[0][0]) or not 0 < sb[2][1] < sb[0][0] \
            or not sb[2][0]:
        fail("20.6: the warm refit did not reuse gm_owned and gm_boundary, "
             "or the eps change did not reuse the owned slabs only")
    rec["checks"] = {"retried": retried, "staging": sb}
    stamp("20.6: done")
    close_20_1()
    return rec


def main() -> None:
    import torch

    if sys.argv[1:2] == ["--chained-cpu-refs"]:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        chained_cpu_refs_child(sys.argv[2], json.loads(sys.argv[3]),
                               sys.argv[4] if len(sys.argv) > 4 else "kd")
        return
    if not torch.cuda.is_available():
        print("FAILED: torch.cuda.is_available() is False; this smoke run "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    if sys.argv[1:2] == ["--faults-child"]:
        faults_child(sys.argv[2])
        return
    from benchdata import make_blob_data
    from pypardis_tpu_torch import DBSCAN
    from pypardis_tpu_torch.csrc import _build
    from pypardis_tpu_torch.ops import cuda_kernels as ck
    from pypardis_tpu_torch.ops.distances import (
        INT_INF, counts_over_pairs, eps2_f32, minlab_over_pairs,
        row_offsets,
    )
    from pypardis_tpu_torch.dbscan import _stage
    from pypardis_tpu_torch.ops.pipeline import _pipeline_layout

    dev = torch.device("cuda")
    t_start = time.perf_counter()
    if "--hold-reps" in sys.argv[1:]:
        global HOLD_REPS
        HOLD_REPS = int(sys.argv[sys.argv.index("--hold-reps") + 1])

    from pypardis_tpu_torch.parallel import staging

    def phase(title):
        # Every phase starts with an empty staging cache: its cold fits
        # stay cold, and no phase holds the last one's tensors.
        staging.clear()
        log(f"[{time.perf_counter() - t_start:.1f} s] {title}")

    # Phase 1: the card and the build.
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else (
        f"nvidia-smi unavailable ({smi.returncode})"
    )
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    _build.load()
    log(f"build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.BUILD_INFO.get('seconds', 0.0):.2f} s, one process "
        f"per source of {len(_build.SOURCES)}, in parallel)")
    # ptxas names each kernel ("Compiling entry function '<mangled>'")
    # before its registers, shared memory and spills.
    kernel = "?"
    for line in _build.BUILD_INFO.get("log", "").splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1] if "'" in line else line.strip()
        elif "registers" in line or "spill" in line:
            log(f"  ptxas {kernel}: {line.strip()}")
    if (_build.BUILD_INFO.get("log")
            and "sketch_pair_kernelILi0ELi2E" not in _build.BUILD_INFO["log"]):
        fail("the build has no certified B3 instance "
             "(sketch_pair_kernel<0, SK_CERTIFIED>)")
    # (The timing switches run from a parent tree's root too, whose build
    # may predate the kernel: they skip this check.)
    ab = {"--b1", "--b2", "--b2-walk", "--b4", "--b5", "--hier"} & set(
        sys.argv[1:])
    if (not ab and _build.BUILD_INFO.get("log")
            and "b1_tc_kernelILi0ELi1ELi4E" not in _build.BUILD_INFO["log"]):
        fail("the build has no tensor-core B1 instance "
             "(b1_tc_kernel<B1_EXACT, 1, 4>)")
    # B5's instances: its tables, the pass and the prefilter at 16-D.
    for inst in ("query_tables_kernel", "query_frames_kernel",
                 "query_rows_kernel", "query_pass_kernelILi16ELb1E",
                 "query_keep_staged_kernelILi16E", "query_pass_kernelILi0E",
                 "query_keep_global_kernel"):
        if (not ab and _build.BUILD_INFO.get("log")
                and inst not in _build.BUILD_INFO["log"]):
            fail(f"the build has no B5 instance {inst}")
    if "--profile" in sys.argv[1:]:
        profile_fit(torch, DBSCAN, make_blob_data)
        return

    def median_ms(fn, reps):
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return float(np.median(times))

    if "--b1" in sys.argv[1:]:
        records = b1_timings(torch, dev, median_ms, torch.cuda.synchronize)
        log(f"card: {card}")
        print(json.dumps({"kernels": records}))
        return

    if "--b2" in sys.argv[1:]:
        records = b2_timings(torch, dev, median_ms, torch.cuda.synchronize)
        log(f"card: {card}")
        print(json.dumps({"kernels": records}))
        return

    if "--b2-walk" in sys.argv[1:]:
        b2_walk_shares(torch, dev)
        log(f"card: {card}")
        return

    if "--b5" in sys.argv[1:]:
        records = b5_timings(torch, dev, median_ms)
        log(f"card: {card}")
        print(json.dumps({"kernels": records}))
        return

    if "--metrics" in sys.argv[1:]:
        records, rec9 = metrics_phase(torch, dev, median_ms,
                                      torch.cuda.synchronize)
        log(f"phase 9 record: {json.dumps(rec9)}")
        log(f"card: {card}")
        print(json.dumps({"kernels": records}))
        return

    if "--hier" in sys.argv[1:]:
        rec10 = hier_phase(torch, dev, torch.cuda.synchronize, card)
        log(f"phase 10 record: {json.dumps(rec10)}")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--live" in sys.argv[1:]:
        t11 = time.perf_counter()
        rec11 = live_phase(torch, dev, torch.cuda.synchronize, card)
        log(f"phase 11 record: {json.dumps(rec11)}; phase 11 took "
            f"{time.perf_counter() - t11:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--gateway" in sys.argv[1:]:
        t12 = time.perf_counter()
        rec12 = gateway_phase(torch, dev, torch.cuda.synchronize, card)
        log(f"phase 12 record: {json.dumps(rec12)}; phase 12 took "
            f"{time.perf_counter() - t12:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--chained" in sys.argv[1:]:
        t13 = time.perf_counter()
        rec13 = chained_phase(torch, dev, torch.cuda.synchronize, card,
                              cpu_refs=ChainedCpuRefs())
        log(f"phase 13 record: {json.dumps(rec13)}; phase 13 took "
            f"{time.perf_counter() - t13:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--gm" in sys.argv[1:]:
        t16 = time.perf_counter()
        rec16 = gm_phase(torch, dev, torch.cuda.synchronize, card,
                         cpu_refs=ChainedCpuRefs(
                             dict(CHAINED_SIZES, **GM_SIZES), jobs=("gm",)))
        log(f"phase 16 record: {json.dumps(rec16)}; phase 16 took "
            f"{time.perf_counter() - t16:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--mesh" in sys.argv[1:]:
        t17 = time.perf_counter()
        rec17 = mesh_phase(torch, dev, torch.cuda.synchronize, card,
                           cpu_refs=ChainedCpuRefs(
                               dict(CHAINED_SIZES, **MESH_SIZES),
                               jobs=("mesh",)))
        log(f"phase 17 record: {json.dumps(rec17)}; phase 17 took "
            f"{time.perf_counter() - t17:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--ring" in sys.argv[1:]:
        t18 = time.perf_counter()
        rec18 = ring_phase(torch, dev, torch.cuda.synchronize, card,
                           cpu_refs=ChainedCpuRefs(
                               dict(CHAINED_SIZES, **RING_SIZES),
                               jobs=("ring",)))
        log(f"phase 18 record: {json.dumps(rec18)}; phase 18 took "
            f"{time.perf_counter() - t18:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--gmmesh" in sys.argv[1:]:
        t20 = time.perf_counter()
        rec20 = gmmesh_phase(torch, dev, torch.cuda.synchronize, card,
                             cpu_refs=ChainedCpuRefs(
                                 dict(CHAINED_SIZES, **GMMESH_SIZES),
                                 jobs=("gmmesh",)))
        log(f"phase 20 record: {json.dumps(rec20)}; phase 20 took "
            f"{time.perf_counter() - t20:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--staging" in sys.argv[1:]:
        t19 = time.perf_counter()
        rec19 = staging_phase(torch, dev, torch.cuda.synchronize, card)
        log(f"phase 19 record: {json.dumps(rec19)}; phase 19 took "
            f"{time.perf_counter() - t19:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--b4" in sys.argv[1:]:
        records, _ = sketch_phase(torch, dev, median_ms,
                                  torch.cuda.synchronize,
                                  dict(SKETCH_SIZES, timing_only=True))
        log(f"card: {card}")
        print(json.dumps({"kernels": records}))
        return

    max_err = {"count_pairs": 0, "minlab_pairs": 0}

    def hold(name, kern, plain, what):
        diff = (kern.long() - plain.long()).abs()
        err = int(diff.max()) if diff.numel() else 0
        bad = int((diff != 0).sum())
        max_err[name] = max(max_err[name], err)
        log(f"  {name} {what}: max|kernel-plain| = {err}, "
            f"mismatches = {bad}")
        if bad:
            fail(f"{name} disagrees with its plain version on {what}")

    def kernel_inputs(pts, mask, eps, block, min_samples):
        """The B1 inputs and the first B2 inputs the fit would build."""
        (rows, cols), (total, budget) = ck.kernel_pair_list(
            pts, eps, mask, block, "high"
        )
        if total > budget:
            (rows, cols), (total, budget) = ck.kernel_pair_list(
                pts, eps, mask, block, "high", budget=total
            )
        tile = ck._pallas_block(block, pts.shape[1], pts.shape[0], "high")
        rp = row_offsets(rows, pts.shape[1] // tile)
        mi = mask.to(torch.int32)
        e2 = eps2_f32(eps)
        counts = ck.count_pairs(pts, mi, rp, cols, e2, tile)
        core = (torch.clamp_min(torch.where(mask, counts, 0), 1)
                >= min_samples) & mask
        idx = torch.arange(pts.shape[1], device=pts.device,
                           dtype=torch.int32)
        lab = torch.where(core, idx, INT_INF).contiguous()
        return dict(pts=pts, mi=mi, lab=lab, rp=rp, cols=cols, e2=e2,
                    tile=tile, total=total, core=core, mask=mask,
                    centers=ck.tile_frames(pts, mask, tile)[0])

    def compare(inp, what, walk=True):
        """B1 and B2 bitwise their plain versions; at d <= 64 (the
        tensor-core B1) with ``walk`` also B1's rescored_pairs against
        the walk's."""
        a = (inp["pts"], inp["mi"], inp["rp"], inp["cols"], inp["e2"],
             inp["tile"])
        if inp["pts"].shape[0] <= 64:
            rc = torch.zeros(1, dtype=torch.int64, device=dev)
            got = ck.count_pairs(*a, inp["centers"], rescored_pairs=rc)
            hold("count_pairs", got, counts_over_pairs(*a), what)
            if walk:
                b1_rescored_hold(a, inp["centers"], int(rc[0]), what)
        else:
            hold("count_pairs", ck.count_pairs(*a), counts_over_pairs(*a),
                 what)
        b = (inp["pts"], inp["lab"], inp["rp"], inp["cols"], inp["e2"],
             inp["tile"])
        hold("minlab_pairs", ck.minlab_pairs(*b), minlab_over_pairs(*b),
             what)

    if "--faults" in sys.argv[1:]:
        # Phase 15 alone, on its own fits: phase 4's 1M fused fit from
        # host input (twice), phase 5's B1 inputs, the 1M model's live
        # model and 13.1's 20k case.
        t15 = time.perf_counter()
        X, _truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
        walls = []
        for _ in range(2):
            model = DBSCAN(eps=2.4, min_samples=10, block=2048)
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.fit(X)
            torch.cuda.synchronize()
            walls.append(round(time.perf_counter() - t, 6))
        main15 = dict(X=X, labels=model.labels_.copy(),
                      core=model.core_sample_mask_.copy(), walls=walls)
        pts, n, block = _stage(X, 2048, dev)
        xs, mask, _owner = _pipeline_layout(pts, 2.4, n, block, sort=True)
        inp = kernel_inputs(xs, mask, 2.4, block, 10)
        b1_args = ((xs, inp["mi"], inp["rp"], inp["cols"], inp["e2"],
                    inp["tile"]), inp["centers"])
        rec15 = faults_phase(torch, dev, torch.cuda.synchronize, card,
                             main15, b1_args, model.live(),
                             chained_cpu_cases(CHAINED_SIZES)["small"])
        log(f"phase 15 record: {json.dumps(rec15)}; phase 15 took "
            f"{time.perf_counter() - t15:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    if "--report" in sys.argv[1:]:
        # Phase 14 alone, on its own fits: phase 4's 1M fit (twice from
        # host input; the first one's report and trace), its 200k data,
        # phase 5's B1 inputs and 13.2's chained fit.
        t14 = time.perf_counter()
        walls = []
        X, _truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
        for _ in range(2):
            model = DBSCAN(eps=2.4, min_samples=10, block=2048)
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.fit(X)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
            if len(walls) == 1:
                fit1m = fit_record(model, walls[0])
        X200, _truth = make_blob_data(200_000, 16, n_centers=32, std=0.4)
        pts, n, block = _stage(X, 2048, dev)
        xs, mask, _owner = _pipeline_layout(pts, 2.4, n, block, sort=True)
        inp = kernel_inputs(xs, mask, 2.4, block, 10)
        a = (xs, inp["mi"], inp["rp"], inp["cols"], inp["e2"], inp["tile"])
        _out, _wall, _kd, _part, chained = chained_fit_recorded(
            torch, dev, torch.cuda.synchronize, X)
        rec14 = report_phase(torch, dev, card, ck, (a, inp["centers"]),
                             fit1m, chained, X200, fit_walls=walls)
        log(f"phase 14 record: {json.dumps(rec14)}; phase 14 took "
            f"{time.perf_counter() - t14:.1f} s")
        log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
        return

    # Phase 2: kernels against their plain versions on the card.
    phase("phase 2: kernels vs plain versions on the card (tolerance: "
        "exact equality; the two share their d^2 arithmetic)")
    for d in (16, 64):
        pts, n, block = _stage(guard_banded_blobs(d), 1024, dev)
        mask = torch.arange(pts.shape[1], device=dev) < n - 77
        compare(kernel_inputs(pts, mask, 2.0, block, 8),
                f"guard-banded blobs d={d}")
        Xn, _ = make_blob_data(60_000, d, n_centers=16, std=0.4, seed=d)
        eps = 2.4 if d == 16 else 4.8
        pts, n, block = _stage(Xn, 2048, dev)
        xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
        compare(kernel_inputs(xs, mask, eps, block, 10),
                f"natural blobs d={d} n=60000")
    # The other register capacities: d <= 4, and d > 64 (row re-read
    # from global memory); and tiles below 128 rows (block 64: B1's
    # tensor-core slab of 64 columns).
    for d, eps, blk in ((3, 1.2, 1024), (96, 6.0, 1024), (3, 1.2, 64),
                        (16, 2.4, 64)):
        Xn, _ = make_blob_data(20_000, d, n_centers=8, std=0.4, seed=d)
        pts, n, block = _stage(Xn, blk, dev)
        xs, mask, _owner = _pipeline_layout(pts, eps, n, block, sort=True)
        compare(kernel_inputs(xs, mask, eps, block, 10),
                f"natural blobs d={d} n=20000 block={blk}")
    # The tensor-core B1 where its band is widest: near-eps pairs,
    # duplicates and a 1e3 offset.
    for d in (3, 16, 64):
        eps_a = round(0.9 * np.sqrt(d / 8.0), 3)
        pts, n, block = _stage(adversarial(20_000, d, eps_a), 1024, dev)
        xs, mask, _owner = _pipeline_layout(pts, eps_a, n, block, sort=True)
        compare(kernel_inputs(xs, mask, eps_a, block, 6),
                f"adversarial d={d} n=20000")
    torch.cuda.synchronize()

    # Phase 3: a small fit on the card against the plain path on the CPU.
    phase("phase 3: small fit, card vs plain versions on the CPU")
    Xs, truth_s = make_blob_data(8000, 16, n_centers=8, std=0.4, seed=3)
    gpu = DBSCAN(eps=2.4, min_samples=10, block=256).fit(Xs)
    cpu = DBSCAN(eps=2.4, min_samples=10, block=256, device="cpu").fit(Xs)
    same = (np.array_equal(gpu.labels_, cpu.labels_)
            and np.array_equal(gpu.core_sample_mask_, cpu.core_sample_mask_))
    log(f"  n=8000 labels/core byte-identical card vs CPU: {same}; "
        f"ARI vs truth {ari(gpu.labels_, truth_s):.6f}")
    if not same:
        fail("the card's fit differs from the plain-version fit")

    # Phase 4: the main path at real size.
    phase("phase 4: main path DBSCAN(eps=2.4, min_samples=10, block=2048)")
    fits = {}
    main_launches = None
    serve_model = serve_X = None
    for n in (200_000, 1_000_000):
        X, truth = make_blob_data(n, 16, n_centers=32, std=0.4)
        Xd = torch.from_numpy(X).to(dev)
        torch.cuda.synchronize()
        runs = []
        for source in ("host", "host", "cuda", "cuda"):
            model = DBSCAN(eps=2.4, min_samples=10, block=2048,
                           precision="high")
            # Cold fits: phase 19 times the warm ones.
            staging.clear()
            ck.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            model.fit(X if source == "host" else Xd)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            launches = dict(ck.LAUNCHES)
            m = model.metrics_
            clusters = int(model.labels_.max()) + 1
            a = ari(model.labels_, truth)
            log(f"  n={n} from {source}: {wall:.4f} s, launches "
                f"B1={launches['count_pairs']} "
                f"B2={launches['minlab_pairs']}, passes "
                f"{m['kernel_passes']}, live pairs {m['live_pairs']} "
                f"(budget {m['pair_budget']}, tile {m['kernel_block']}), "
                f"clusters {clusters}, ARI vs truth {a:.6f}")
            if launches["count_pairs"] < 1 or launches["minlab_pairs"] < 1:
                fail("a kernel of the main path was never launched")
            if sum(launches.values()) != m["kernel_passes"]:
                fail("kernel launches do not sum to the fit's passes")
            if a < 0.99:
                fail(f"ARI {a} < 0.99 at n={n}")
            if n == 1_000_000 and main_launches is None:
                main_launches = launches
                serve_model, serve_X = model, X
                fit1m = fit_record(model, wall)  # phase 14 reads it
                x1m = X  # phase 19 refits it
                # Phase 13 holds the chained route against this fit.
                chained_main = dict(X=X, labels=model.labels_.copy(),
                                    core=model.core_sample_mask_.copy())
            runs.append((source, wall, model.labels_.copy(),
                         model.core_sample_mask_.copy()))
        for i in (1, 3):
            if not (np.array_equal(runs[i][2], runs[i - 1][2])
                    and np.array_equal(runs[i][3], runs[i - 1][3])):
                fail(f"repeated {runs[i][0]} fits differ at n={n}")
        log(f"  n={n}: repeated fits byte-identical; host vs cuda-tensor "
            f"labels identical: {np.array_equal(runs[0][2], runs[2][2])}, "
            f"ARI {ari(runs[0][2], runs[2][2]):.6f}")
        fits[n] = [round(r[1], 6) for r in runs]
        if n == 1_000_000:
            # Phase 18 holds the device-input route against the fit from
            # the same tensor (its frame: the tensor's own mean).
            chained_main.update(tensor_labels=runs[2][2],
                                tensor_core=runs[2][3])
        if n == 200_000:
            X200 = X  # phase 14.4 fits it with a flight file
        del Xd

    # One child process runs 13.1's, 16.1's and 17.1's CPU runs in turn,
    # from here on beside the card's work (it makes its own data).
    cpu_refs = ChainedCpuRefs(dict(CHAINED_SIZES, **GM_SIZES, **{
        k: v for k, v in {**MESH_SIZES, **RING_SIZES}.items()
        if k not in GM_SIZES}, gm_cases=GMMESH_SIZES["gm_cases"]),
        jobs=("kd", "gm", "mesh", "ring", "gmmesh"))

    # Phase 5: the kernels alone at the 1M fit's own inputs (staged as
    # a host-input fit stages them).
    phase("phase 5: kernels at the 1M main-path inputs")
    X, truth = make_blob_data(1_000_000, 16, n_centers=32, std=0.4)
    pts, n, block = _stage(X, 2048, dev)
    xs, mask, _owner = _pipeline_layout(pts, 2.4, n, block, sort=True)
    inp = kernel_inputs(xs, mask, 2.4, block, 10)
    compare(inp, "1M main-path inputs", walk=False)

    d, N = xs.shape
    tile = inp["tile"]
    nt = N // tile
    rows_t = torch.repeat_interleave(
        torch.arange(nt, device=dev),
        (inp["rp"][1:] - inp["rp"][:-1]).long(),
    )
    cols_t = inp["cols"][: int(inp["rp"][-1])].long()
    valid_per_tile = inp["mask"].view(nt, tile).sum(1)
    src_per_tile = inp["core"].view(nt, tile).sum(1)
    # Point pairs each kernel must evaluate on this data: every row of a
    # live tile pair against the columns it cannot skip (valid columns
    # for B1, source columns for B2); 3d FP32 operations each (d
    # subtractions, multiplies and adds) plus the compare.
    need = {
        "count_pairs": int(valid_per_tile[cols_t].sum()) * tile,
        "minlab_pairs": int(src_per_tile[cols_t].sum()) * tile,
    }
    in_bytes = (d * N * 4 + N * 4 + inp["rp"].numel() * 4
                + inp["cols"].numel() * 4)
    out_bytes = N * 4
    kernels = []
    # B1 (the tensor-core kernel at 16-D): on the first 64 row tiles its
    # rescored_pairs against the walk's, then timed on the whole list
    # with the staging of its frames (the row tiles' centres, which the
    # fit now stages under "high" too).
    a = (xs, inp["mi"], inp["rp"], inp["cols"], inp["e2"], tile)
    sub = min(64, nt)
    rp_sub = torch.cat([inp["rp"][:sub + 1], inp["rp"][sub].repeat(nt - sub)])
    a_sub = a[:2] + (rp_sub,) + a[3:]
    rc = torch.zeros(1, dtype=torch.int64, device=dev)
    got = ck.count_pairs(*a_sub, inp["centers"], rescored_pairs=rc)
    hold("count_pairs", got, counts_over_pairs(*a_sub),
         f"1M main-path inputs, first {sub} of {nt} row tiles")
    b1_rescored_hold(a_sub, inp["centers"], int(rc[0]),
                     f"the 1M main-path inputs, first {sub} of {nt} row tiles")
    rc.zero_()
    ck.count_pairs(*a, inp["centers"], rescored_pairs=rc)
    rescored = int(rc[0])
    sync_args = (a, inp["centers"])  # phase 14.1's B1 inputs
    ms = median_ms(lambda: ck.count_pairs(*a, inp["centers"]), 10)
    frames_ms = median_ms(lambda: ck.pass_frames(xs, mask, tile, "high"), 10)
    # One timed call of the plain pass on the first row tiles (the whole
    # list, ≈ 5.4 s, until phase 17 took its time): the hold above warmed
    # it there.
    plain_ms = median_ms(cold(lambda: counts_over_pairs(*a_sub)), 1)
    pairs = need["count_pairs"]
    t_bytes = (in_bytes + out_bytes
               + inp["centers"].numel() * 4) / PEAK_BYTES_PER_S
    t_ops = b1_bounds(pairs, rescored, d, "high")
    bound_s = max(t_bytes, t_ops)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    fp32_s = max(t_bytes, pairs * (3 * d + 1) / PEAK_FP32_FLOPS)
    floor_s = max(t_bytes, b1_floor(pairs, rescored, d))
    log(f"  count_pairs: {ms:.4f} ms (plain {plain_ms:.2f} ms on the first "
        f"{sub} of {nt} row tiles), bound "
        f"{bound_s * 1e3:.4f} ms by {bound_by} (all-FP32 work "
        f"{fp32_s * 1e3:.4f} ms, floor {floor_s * 1e3:.4f} ms); {pairs} point "
        f"pairs over {len(cols_t)} live tile pairs, {rescored} decided "
        f"exactly ({rescored / max(pairs, 1):.6f}); the frames' staging "
        f"{frames_ms:.4f} ms")
    kernels.append({
        "name": "count_pairs", "route": "cuda",
        "source": "pypardis_tpu_torch/csrc/pair_kernels.cu",
        "replaces": "pypardis_tpu/ops/pallas_kernels.py:202",
        "launches": int(main_launches["count_pairs"]),
        "max_abs_err": max_err["count_pairs"],
        "ms": ms, "plain_ms": plain_ms,
        "plain_scope": f"first {sub} of {nt} row tiles",
        "bound_ms": bound_s * 1e3, "bound_by": bound_by,
        # No single PyTorch call computes a thresholded count or a
        # min-label over a tile-pair list.
        "library_ms": None,
        "rescored_pairs": rescored,
        "rescored_share": rescored / max(pairs, 1),
        "bound_ms_fp32": fp32_s * 1e3, "floor_ms": floor_s * 1e3,
        "frames_ms": frames_ms,
    })
    # B2 at each round's labels of the fit, with the fit's live rows.
    kernels += b2_rounds(torch, dev, median_ms, torch.cuda.synchronize, xs,
                         mask, ("high",), main_launches)

    phase("phase 6: serving on the 1M host-input model")
    records, served = serve_phase(torch, serve_model, serve_X, median_ms)
    kernels += records
    phase("phase 7: high-dimensional fits, the sketch kernels B3/B4")
    records, onoff = sketch_phase(torch, dev, median_ms,
                                  torch.cuda.synchronize)
    kernels += records
    phase("phase 8: precision modes, the bf16 tensor-core kernels")
    embedding = onoff.pop("main")
    warm512 = onoff.pop("warm512")
    main_fit = dict(X=X, truth=truth, model=serve_model, xs=xs, mask=mask)
    fp32_ms = {k["name"]: k["ms"] for k in kernels[:2]}
    kernels += precision_phase(torch, dev, median_ms,
                               torch.cuda.synchronize, main_fit, served,
                               onoff, fp32_ms)
    # Phase 11 runs the live path on phase 6's model.
    live_fit = dict(model=serve_model, X=X, truth=truth)
    # Phase 15 reuses phase 4's 1M fit, phase 5's B1 inputs and phase
    # 11's live model.
    main15 = dict(chained_main, walls=fits[1_000_000][:2])
    del serve_model, serve_X, served, onoff, main_fit, xs, inp
    phase("phase 9: metrics (cosine, haversine, cityblock) and the sweep")
    t9 = time.perf_counter()
    records, rec9 = metrics_phase(torch, dev, median_ms,
                                  torch.cuda.synchronize,
                                  embedding=embedding)
    del embedding
    kernels += records
    log(f"phase 9 record: {json.dumps(rec9)}; phase 9 took "
        f"{time.perf_counter() - t9:.1f} s")
    phase("phase 10: the density hierarchy, DBSCAN(eps=None)")
    t10 = time.perf_counter()
    rec10 = hier_phase(torch, dev, torch.cuda.synchronize, card)
    log(f"phase 10 record: {json.dumps(rec10)}; phase 10 took "
        f"{time.perf_counter() - t10:.1f} s")
    phase("phase 11: live updates and ingest")
    t11 = time.perf_counter()
    rec11 = live_phase(torch, dev, torch.cuda.synchronize, card, **live_fit)
    log(f"phase 11 record: {json.dumps(rec11)}; phase 11 took "
        f"{time.perf_counter() - t11:.1f} s")
    # Phase 12 drives the ingest harness on phase 11's live model.
    phase("phase 12: the gateway and the load harnesses")
    t12 = time.perf_counter()
    rec12 = gateway_phase(torch, dev, torch.cuda.synchronize, card,
                          live=live_fit["model"].live(), X=live_fit["X"],
                          truth=live_fit["truth"])
    live15 = live_fit["model"].live()
    del live_fit
    log(f"phase 12 record: {json.dumps(rec12)}; phase 12 took "
        f"{time.perf_counter() - t12:.1f} s")
    phase("phase 13: the KD route's chained form (sharded_dbscan)")
    t13 = time.perf_counter()
    reports = {}
    rec13 = chained_phase(torch, dev, torch.cuda.synchronize, card,
                          main=chained_main, cpu_refs=cpu_refs,
                          reports=reports)
    # Phases 16 and 17 hold their routes against phase 4's fit too.
    gm_main = chained_main
    del chained_main
    # The chained route's B1/B2 launches per fit at 13.2's size, and
    # their largest error against the plain versions on its largest slab.
    for rec, key in zip(kernels[:2], ("count_pairs", "minlab_pairs")):
        rec["launches_chained"] = rec13["main"]["launches"][key]
        rec["max_abs_err_chained"] = (
            rec13["main"]["slab_hold"]["max_abs_err"][key])
    log(f"phase 13 record: {json.dumps(rec13)}; phase 13 took "
        f"{time.perf_counter() - t13:.1f} s")
    log(f"fit seconds (host, host, cuda, cuda): {json.dumps(fits)}")
    phase("phase 14: run reports and tracing")
    t14 = time.perf_counter()
    rec14 = report_phase(torch, dev, card, ck, sync_args, fit1m,
                         reports["chained"], X200,
                         fit_walls=fits[1_000_000])
    log(f"phase 14 record: {json.dumps(rec14)}; phase 14 took "
        f"{time.perf_counter() - t14:.1f} s")
    phase("phase 15: faults, retry, jobstate and resume")
    t15 = time.perf_counter()
    rec15 = faults_phase(torch, dev, torch.cuda.synchronize, card, main15,
                         sync_args, live15,
                         chained_cpu_cases(CHAINED_SIZES)["small"])
    del sync_args, main15, live15
    log(f"phase 15 record: {json.dumps(rec15)}; phase 15 took "
        f"{time.perf_counter() - t15:.1f} s")
    phase("phase 16: the global-Morton route's chained form "
          "(global_morton_dbscan)")
    t16 = time.perf_counter()
    singles = {}
    rec16 = gm_phase(torch, dev, torch.cuda.synchronize, card, main=gm_main,
                     cpu_refs=cpu_refs, kd_wall=rec13["main"]["wall_s"],
                     keep=singles)
    # The global-Morton route's launches per fit (16.2's at 1M x 16-D,
    # 16.3's at 100k x 512) and each kernel's largest error against its
    # plain version over the owner-computes lists of its largest slab.
    done = set()
    for rec in kernels:
        for part in ("main", "sketch"):
            if (rec["name"] in rec16[part]["launches"]
                    and rec["name"] not in done):
                done.add(rec["name"])
                rec["launches_gm"] = rec16[part]["launches"][rec["name"]]
                rec["max_abs_err_gm"] = (
                    rec16[part]["slab_hold"]["max_abs_err"][rec["name"]])
    log(f"phase 16 record: {json.dumps(rec16)}; phase 16 took "
        f"{time.perf_counter() - t16:.1f} s")
    phase("phase 17: the KD route's fused multi-device step "
          "(DBSCAN(mesh=...), sharded_dbscan on a mesh)")
    t17 = time.perf_counter()
    rec17 = mesh_phase(torch, dev, torch.cuda.synchronize, card,
                       main=gm_main, cpu_refs=cpu_refs,
                       walls={"single": fits[1_000_000][0],
                              "chained": rec13["main"]["wall_s"]},
                       keep=singles)
    # The fused step's launches per fit (17.2's at 1M x 16-D on the
    # 4-shard mesh, 17.3's at 100k x 512) and each kernel's largest error
    # against its plain version over the owner-computes lists of its
    # largest partition slab.
    done = set()
    for rec in kernels:
        for part in ("main", "sketch"):
            if (rec["name"] in rec17[part]["launches"]
                    and rec["name"] not in done):
                done.add(rec["name"])
                rec["launches_mesh"] = rec17[part]["launches"][rec["name"]]
                rec["max_abs_err_mesh"] = (
                    rec17[part]["slab_hold"]["max_abs_err"][rec["name"]])
    log(f"phase 17 record: {json.dumps(rec17)}; phase 17 took "
        f"{time.perf_counter() - t17:.1f} s")
    phase("phase 18: the KD route's ring exchange, its streaming build and "
          "the device-input route (sharded_dbscan(halo='ring'), "
          "DBSCAN(mesh=...).fit(memmap | tensor))")
    t18 = time.perf_counter()
    rec18 = ring_phase(torch, dev, torch.cuda.synchronize, card,
                       main=gm_main, cpu_refs=cpu_refs, keep=singles)
    # The ring route's launches per fit (18.2's at 1M x 16-D from host
    # input, 18.3's at 100k x 512) and each kernel's largest error
    # against its plain version over the owner-computes lists of its
    # largest ring slab.
    done = set()
    for rec in kernels:
        for part in ("main", "sketch"):
            if (rec["name"] in rec18[part]["launches"]
                    and rec["name"] not in done):
                done.add(rec["name"])
                rec["launches_ring"] = rec18[part]["launches"][rec["name"]]
                rec["max_abs_err_ring"] = (
                    rec18[part]["slab_hold"]["max_abs_err"][rec["name"]])
    log(f"phase 18 record: {json.dumps(rec18)}; phase 18 took "
        f"{time.perf_counter() - t18:.1f} s")
    phase("phase 19: the staging cache (warm refits of the single-card, "
          "sweep, KD and serving routes)")
    t19 = time.perf_counter()
    rec19 = staging_phase(
        torch, dev, torch.cuda.synchronize, card, main=x1m, warm512=warm512,
        warm_routes={"13.1": rec13["staging"], "17.2": rec17["staging"],
                     "18.2": rec18["staging"]})
    del x1m
    # Each kernel's launches in a warm fit (19.1's 1M x 16-D refit, 7.3's
    # 1M x 512 refit, 19.5's predicts on a warm index): a warm fit
    # launches what a cold one does.
    warm = {k: v for launches in (rec19["launches_warm"],
                                  warm512["launches_warm"])
            for k, v in launches.items() if v}
    done = set()
    for rec in kernels:
        if rec["name"] in warm and rec["name"] not in done:
            done.add(rec["name"])
            rec["launches_warm"] = warm[rec["name"]]
    log(f"phase 19 record: {json.dumps(rec19)}; phase 19 took "
        f"{time.perf_counter() - t19:.1f} s")
    phase("phase 20: the global-Morton mesh engine (DBSCAN(mode="
          "'global_morton', mesh=...), global_morton_dbscan on a mesh)")
    t20 = time.perf_counter()
    rec20 = gmmesh_phase(
        torch, dev, torch.cuda.synchronize, card, main=gm_main,
        cpu_refs=cpu_refs, keep=singles,
        walls={"17.2": rec17["main"]["wall_s"],
               "18.2": rec18["main"].get("wall_s")})
    del gm_main, singles
    # The mesh engine's launches per fit (20.2's at 1M x 16-D on the
    # 4-shard mesh, 20.3's at 100k x 512) and each kernel's largest error
    # against its plain version over the owned-slab, boundary-delta and
    # propagation lists of its largest combined slab.
    done = set()
    for rec in kernels:
        for part in ("main", "sketch"):
            if (rec["name"] in rec20[part]["launches"]
                    and rec["name"] not in done):
                done.add(rec["name"])
                rec["launches_gmmesh"] = rec20[part]["launches"][rec["name"]]
                rec["max_abs_err_gmmesh"] = (
                    rec20[part]["slab_hold"]["max_abs_err"][rec["name"]])
    log(f"phase 20 record: {json.dumps(rec20)}; phase 20 took "
        f"{time.perf_counter() - t20:.1f} s")
    phase("phases 2-20 done")
    log(f"card: {card}; total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
