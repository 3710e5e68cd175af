"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--only 23|24|25|26|27] [--record PATH]

Run from the repository root. It needs a CUDA card, `nvcc` and `g++` (it
builds every kernel under `sml_tpu_torch/csrc/` and the host binning at
first use) and exits non-zero without printing a result when any is
missing or any phase fails.

Phases:
1. device: the card's name and power limit (from nvidia-smi);
2. build: every kernel source (nvcc) and the host binning (g++), with one
   compiler process each, in parallel;
3. kernels: `forest_traverse` against its plain PyTorch version on the
   card, bit for bit, on seeded random ensembles with early leaves and
   feature ids past the row, at the widths of the tree models the
   repository fits (ML 11 XGBoost, ML 07 random forest, ML 06 decision
   tree, a uint16 and an int32 bin matrix) at 1, 37, 64, 4,096 and
   100,000 rows, and at shapes that take the kernel's other paths: rows
   too wide to stage their bins (400 features), trees built in chunks
   (300 trees, in many tree groups and in one; depth 13) and trees past
   shared memory (depth 16);
4. main path, serving: an ML 11-shaped model (40 trees, depth 6, 10
   features, 64 bins) built through the port's loader, scored through
   `DeviceScorer.score_block` (100,000 rows), evaluated through the fused
   `forest_eval_fn` (exp link, 20,000 labelled rows) and served through
   `MicroBatcher` (96 concurrent requests of 1-64 rows), with the
   kernel's launch count read around it and split by row count;
5. times: the kernel (CUDA-event median of one call, and device time
   by `torch.profiler`), its plain version and its bound at the ML 11
   shape at 64, 4,096 and 100,000 rows, beside the card's name and
   power limit;
6. breakdown: where one `score_block` call spends its time (binning,
   staging, kernel, copy back), at 4,096 and 100,000 rows; the host
   binning's C++ kernel against its NumPy version on the same rows
   (`bin_with`'s search at 4,096 and 100,000 rows, `make_bins` at
   80,000), equal and timed;
7. fit kernels: `hist_accumulate` against its plain version at the ML 11
   shape (80,000 rows, 64 bins, uint8) for 1-32 slots, at ML 06 (40
   bins), with uint16 (300 bins) and int32 (70,000 bins) matrices, an
   odd row count, a few rows and rows too wide to stage their bins, with
   ~20% zero weights, and at the ML 07 grid's fused shape (640,008 rows,
   40 bins, 96 slots), each launched twice and required bit-identical;
   its float64 output at phase 22's level-5 shapes (40,000 and 20,000
   rows, 16 slots): rounded, bit-equal to its f32 output and to the
   plain version's, unrounded within n * 2^-53 of the summed
   |contributions| of the plain version's, and timed beside the f32
   output; `split_scan` against its plain version, exactly, on histograms of
   dyadic values with ties, masked, all-masked and NaN nodes, and at the
   fused shape (W = 12 x 16) with a per-node least child weight of mixed
   1/2/5; the draw kernels against theirs (`DRAW_CASES`), each a whole
   fit's draws in one launch under the fit's own keys: ML 07's forest
   (20 rounds of 80,000 Poisson(1) rows and 20 x 63 nodes of masks, F=10,
   k=3; seeds 42, 0 and 17), ML 11's subsample (40 rounds of 80,000
   Bernoulli(0.8) rows), the ML 07 grid fused (20 rounds x 12 elements x
   53,334 rows and 20 x 12 x 31 nodes), ML 07's last 4 rounds and last
   round and the fused grid's last round (with the fits above, every
   rows-a-thread build of `row_weights`: 8, 2, 1 and 4 on an H100), 12
   elements of mixed mode, rate, row count and k from a warm start at
   round 1, odd row counts (1, 37,
   100,001) with masks past a warp (F=400, 33), of one warp (F=32) and
   of one feature; Bernoulli weights, ones and masks bit-equal, a
   Poisson count differing only where its log-sum lies within 2 ulps of
   -rate;
8. main path, fit: 100,000 seeded ML 11-shaped rows split 80,000 /
   20,000; `XgboostRegressor` (ML 11: 40 trees, depth 6, 64 bins, step
   0.15), `DecisionTreeRegressor` (ML 06: depth 5, 40 bins),
   `RandomForestRegressor` (ML 07: 20 trees, depth 6, 40 bins, seed 42,
   a third of the features a node) and ML 11's XGBoost with
   `subsample=0.8` fit on the card, with every kernel launch counted,
   then scored through `DeviceScorer.score_block`; the course's rmse
   orderings (xgb < dt, rf < dt); the same four fits at 16,000 rows on
   the card and on the CPU agree;
9. fit times: each fit kernel (CUDA-event median, and device time of
   the kernel's own launches by `torch.profiler`, "not measured" when
   the profiler lost more than one launch), its plain version, its bound and (for
   `hist_accumulate`) one `index_add_` at every shape the ML 11 fit
   launches it at, and their sum over one fit (40 trees x 6 levels);
   beside the float64-summing `hist_accumulate` at 16 and 32 slots, its
   f32-accumulating build (timed only, never used by the port) and the
   cells where each differs from the plain version on the CPU; the
   wrappers' host time per call; and where one ML 11 fit spends its time
   (host binning, staging, kernel device time, the rest), with the
   card's busy share and the fit kernels' device time from
   `torch.profiler`; the draw kernels' times (a whole fit's draws at ML
   07's, ML 11's subsample's and the fused grid's shapes, and one round
   of each: the two sides of `draw_plan`'s rows a thread) beside
   their plain versions and bounds (integer and f64 work at the card's
   rates, `card_rates`), and the same split of one ML 07 random-forest
   fit;
10. main path, tuning: the ML 07 CrossValidator grid (random forest,
   maxBins 40, seed 42, maxDepth {2, 5} x numTrees {10, 20}) over 3
   seeded folds of phase 8's 80,000 training rows, fitted as one fused
   fit (`fit_cv_grid`, 12 elements) with every kernel launch counted
   (100 `hist_accumulate` and `split_scan`, one `feature_mask` and one
   `row_weights`), each element scored on its validation fold
   (`fused_reg_stats_from_matrix`, 12 `forest_traverse` launches); the
   same 12 fits one by one through `RandomForestRegressor` (630 / 630 /
   12 / 12 launches); every fused element's split tables equal to its
   sequential fit's, leaves within rtol 1e-6, rmse within
   max(1e-3, 1e-5·|rmse|); the same grid at `sml.cv.maxFusedTrials` 5
   (3 fused fits) and 1 (4 fold-fused fits) gives the same models; the
   rmse matrix, its fold means and the best grid point; the walls,
   `binning.fit` and fit loops of the fused grid and the sequential fits
   (each run three times, in turns, from empty caches); the fused fit's
   card busy share and kernel device time by `torch.profiler`. (The
   fused shapes' kernel times beside their bounds are in phases 7 and
   9.) A JSON line before the card's gives the tuning numbers;
11. main path, DataFrame: the course's pipelines as users run them, on
   the session's device (`sml.device`, the card): the port's
   `make_airbnb_dataset(n=100_000, seed=42)` -> createDataFrame ->
   randomSplit([0.8, 0.2], seed=42) -> cache -> Pipeline(Imputer(median),
   StringIndexer(skip), VectorAssembler(idx + imp), estimator).fit(train)
   -> transform(test) -> RegressionEvaluator(labelCol="price"), for ML 06
   (`DecisionTreeRegressor(maxDepth=5, maxBins=40)`), ML 07
   (`RandomForestRegressor(maxDepth=6, numTrees=20, maxBins=40,
   seed=42)`) and ML 11 (`XgboostRegressor(n_estimators=40,
   learning_rate=0.15, max_depth=6, max_bins=64, random_state=42)` on
   log price, evaluated through `F.exp`), with every kernel's launches
   counted around each fit and each evaluate (5 / 5, 120 / 120 / 1 / 1
   and 240 / 240; one `forest_traverse` an evaluate, through the
   pushdown, with no prediction column materialized); each DataFrame
   fit equal to the port's matrix fit (`fit(X, y, categorical)`) on the
   matrix and slots the fitted prep stages assemble, bit for bit and in
   its launches; each pushdown rmse against `score_block` +
   `host_reg_stats` on the same rows; rf < dt and xgb < rf; the same
   pipelines at 16,000 rows on the card and on the CPU agreeing; the
   100,000-row rmse beside GOLDEN.json's pins (information only); and
   the host-clock split of one ML 07 pipeline. A JSON line before the
   card's gives these numbers.

12. main path, model selection (tuning's host half):
   the port's `make_airbnb_dataset(n=100_000, seed=42)` with ML 01's
   median imputation, split 80/20, on the session's device: (a)
   `CrossValidator` over ML 07's `RandomForestRegressor(labelCol="price",
   seed=42)` with the course's grid (maxDepth {2, 5} x numTrees {5, 10},
   3 folds, parallelism 4, seed 42) on the indexed, assembled frame, fused
   (one fit of 12 elements: 50 / 50 / 1 / 1 launches, 12 traversals)
   and as placed trials (`sml.cv.batchFolds=false`: 315 / 315 / 12 /
   12), the best point's refit on top, `avgMetrics` and the best point
   equal; (b) the pipeline (StringIndexer, VectorAssembler, RF) inside the
   CV at parallelism 1 and 4, `avgMetrics` equal; (c) the CV inside the
   pipeline (ML 07L); (d) `TrainValidationSplit`, fused and placed equal;
   (e) `fmin` over ML 08's space (12 trials, TPE past its 10 startup
   trials) with a pipeline objective: `SparkTrials(parallelism=2)` and a
   `score_batch` over `fused_param_scores` at 2 candidates a dispatch give
   one trial history, `Trials()` one by one agrees with it through trial
   11 (the first TPE proposal; whether trial 12 agrees too is printed),
   every trial ok; each launch count exact and no plain version run on
   the card; (a) at 16,000 rows on the card and on the CPU agreeing; and
   the walls (fused and placed; `fmin`'s `score_batch` with its prep fit
   inside the wall) and the host/device split of one pipeline fit, in
   the tuning JSON line's "selection".

13. main path, chunked plane and warm start, on phase 8's rows: (a) ML
   11's XGBoost from an `ArrayChunkSource` of 8,192-row chunks through
   `fit_ensemble_chunked` (bin caches emptied first): every tree bit-equal
   to phase 8's matrix fit, 240 / 240 / 0 / 0 launches, no bins staged by
   the fit (it reads the assembled matrix), `predict_chunked` of the
   20,000 held-out rows bit-equal to `predict_margin`; (b) 20 rounds,
   then `warm_start_ensemble_chunked` of 20 more at `rounds_per_dispatch`
   5: bit-equal to (a), the margin replay exactly one `forest_traverse`
   launch, 4 `tree.fit_dispatch`; the replay on the card bit-equal to
   `forest_margin_plain` with the same `init`, and timed beside its
   bound; `init` (a tensor and a number) bit-equal to the plain version
   on the kernel's trees-in-parallel, one-group, tree-chunk and global
   paths; (c) `checkpointed_fit` (40 rounds, `rounds_per_dispatch` 10)
   stopped right after its second checkpoint and run again: it resumes
   (`ct.resumes` +1) and equals the uninterrupted fit and (a); (d) ML 07's
   `RandomForestRegressor(numTrees=20, maxDepth=6, maxBins=40,
   seed=42).fit_chunked` on price equal to its `fit(categorical={})` in
   trees and launches, and `cross_validate_chunked` (k=3) fold RMSEs; (e)
   a `GeneratorChunkSource` of 4,194,304 x 10 f32 rows (32 chunks of
   131,072, made from the seed chunk by chunk; the sketch compresses):
   the ingest's sketch / prep / dispatch seconds and rows/s at
   `sml.data.prefetchChunks` 2 and 1, the dispatch / drain order, the
   device memory pass 2 adds (held under the compact bytes plus two
   chunk blocks plus 16 MB); XGBoost (depth 6, 64 bins, 10 rounds) from
   it; the rows made whole for the checks only: the assembled matrix
   equal to `bin_with` byte for byte, the trees to a fit through
   `_fit_ensemble(prebinned=...)` that stages its own copy, each edge
   within one bin width of `np.quantile`. A `{"chunked": ...}` JSON line
   gives these numbers.

14. main path, the non-tree programs, on the session's device at the
   golden suite's widths (`tests/test_golden_metrics.py:44-134`): (a)
   phase 11's 100,000 rows split 80/20 through ML 03's prep (Imputer,
   StringIndexer, OneHotEncoder), `LinearRegression(labelCol="price")`
   on the imputed bedrooms (ML 02) and on the 49 one-hot and numeric
   features (ML 03), and ridge (regParam 0.1) and elastic net (0.1,
   0.5) on ML 03's: each below the mean-price baseline and its
   predictions within 2e-5 of the largest |prediction| of the same fit
   on the CPU; (b) MLE 03's `LogisticRegression` on priceClass (the
   training median): the card's IRLS iterations the CPU's and its
   held-out AUROC within 1e-6; (c) MLE 02's `KMeans` (k 3 and 8, 20
   iterations, seed 221) over the 7 imputed numerics: no assignment
   differing from the CPU's, centers and cost within rtol 1e-6; (d) MLE
   01's `ALS` (rank 8, 10 iterations, regParam 0.1, cold start drop) on
   `make_movielens_dataset(1000, 400, 100_000, seed=42)`: below the
   mean-rating baseline, rmse the CPU's within rtol 1e-6; its
   CrossValidator over rank {4, 12} (3 folds, placed trials); ALS rank
   12 at the MovieLens 1M shape (6,040 x 3,700, 1,000,000 drawn
   ratings) below its baseline, with its peak device memory; (e)
   `DeviceScorer` on the ML 03 PipelineModel, `score_block` at 4,096 and
   100,000 rows equal to `transform` (rtol 1e-12) and timed, and
   `bench.py`'s serving leg through the batcher (8 clients, 8-row
   requests, 2,000 requests, max batch 256, flush 1,000 µs) with zero
   sheds. TF32 must be off and no kernel of the port may launch (these
   programs are torch matmuls, cumsums and batched solves); each fit's
   wall and the card's busy share (`torch.profiler`) are printed beside
   the card's name and power limit, and a `{"nontree": ...}` JSON line
   gives these numbers.

15. main path, MLE 04's time series and the frame's remainder, on the
   session's device: (a) MLE 04 at the course's shape (the 160-point
   series of `tests/test_lessons.py:624-628`): `adfuller`,
   `ARIMA(1,2,1).fit`, `forecast(10)`, `Prophet()` with
   `make_future_dataframe(10)` and `predict`, and `Holt` plain, damped and
   exponential and `SimpleExpSmoothing`; (b) Prophet (yearly, weekly and
   holiday blocks) and ARIMA(1,1,1) at the length of Prophet's quick-start
   series (2,905 days from 2007-12-10), made from the seed; (c) on
   `make_airbnb_dataset(n=100_000, seed=42)`: ML 00b's `groupBy("room_type")
   .count().orderBy(...)` and its `spark.sql` over a temp view, ML 01L's
   neighbourhood counts, a join, a crossJoin, `selectExpr` and
   `stat.corr`, each against numpy; (d) ML 00L: `make_dedup_dataset()`
   written as a colon-separated CSV, read back with header, inferSchema
   and sep=":", normalized and deduplicated, the count hashing to the
   course's 972882115. Each of (a)-(d) runs again with the device set to
   the CPU and must agree (ARIMA params within 1e-9 of the largest, Prophet
   within 1e-9 of std(y), Holt, frames and the dedup exactly); each wall
   is printed as first call / warm median of 3, with ARIMA's L-BFGS
   evaluations, its milliseconds an evaluation (through the triangular
   solve, and the step-by-step loss an overflowed evaluation takes) and
   the card's busy share of the quick-start fits. TF32 must be off and
   no kernel of the port may launch; a `{"timeseries": ...}` JSON line
   gives these numbers.

16. main path, the fused featurizer, the compact linear fits and ML 12's
   batch scoring, on the session's device: (a) phase 11's 100,000 rows
   split 80/20: ML 03's one-hot `LinearRegression` pipeline (Imputer,
   StringIndexer(skip), OneHotEncoder, VectorAssembler) and ML 07's
   random-forest pipeline, each fused (`Pipeline.fit`'s whole-chain fit,
   `PipelineModel.transform`'s one pass and its evaluator pushdown) and
   stage by stage (`featurizer.stage_by_stage`), in turns: the first
   fit from empty caches, the median of 3 warm fits and of 3 transform +
   `RegressionEvaluator` rmse; the fits bit-equal, the rmse equal and
   every kernel's launches equal; (b) `tests/test_compact_linear.py:
   20-36`'s chain on `make_airbnb_dataset(n=4_194_304, seed=7)`: the
   fused fit's prep at the default `sml.linear.compactBytes` (the compact
   block: numeric slots and int32 codes, one-hots expanded on the card)
   and at 1 << 40 (the materialized (n, 49) block), then
   `LinearRegression` on price and `LogisticRegression(maxIter=12)` on
   the binarized price from each: walls, host -> device bytes (the
   compact route's at most a quarter) and peak device memory, the
   coefficients within the CPU tests' tolerances; the compact Gram and
   whole-fit IRLS at 65,536 rows on the card against the CPU, moments
   and coefficients within 1e-9 of the largest, steps equal; (c) ML 12:
   `DeviceScorer.score_batches` over the 100,000 raw rows in 10 batches
   of 10,000 at depth 4, on the LR pipeline's factorized route, its block
   route on the card and the RF pipeline (one `forest_traverse` a batch),
   each concatenation against `score_block` of the whole (bit-equal, the
   factorized within rtol 1e-5 / atol 1e-7), with rows/s and the
   dispatch / drain order (batch i+1 dispatched before batch i drains).
   No plain version may run on the card; every kernel on these paths
   must launch. A `{"featurizer": ...}` JSON line gives these numbers.

17. main path, the registry, the endpoint and AutoML, on the session's
   device, in a temporary tracking directory: (a) ML 11's XGBoost
   pipeline (40 trees, depth 6) and ML 07's random-forest pipeline fitted
   on phase 11's 80% split (240 + 120 / 240 + 120 / 1 / 1 launches),
   logged and registered with `mlflow.spark.log_model(...,
   registered_model_name=...)` as versions 1 and 2; v1 promoted to
   Production and served by `ServingEndpoint(name, "Production")`: phase
   4's traffic (96 concurrent requests of 1-64 held-out assembled rows),
   every response bit-equal to `DeviceScorer(v1).score_block` of its
   rows; v2 promoted with `archive_existing_versions=True` while 3
   clients score: every response one version's bits, none torn, one
   `serve.hot_swap`, version 2 current and one cache entry; then v1 in
   Staging and the canary at fractions 1.0 and 0.25: mirrored exactly
   the requests and a quarter of them, no errors, a mean |diff| above 0;
   the mirrors score on the Staging version's host route
   (`score_block_host`, the C++ host traversal: each counted
   `serve.canary_mirrored` and as a host traversal, none a launch), so
   the traversal's launches are the primary's batches alone; the
   latency percentiles of the burst, of waves of 8 with the canary off
   and at each fraction; no shed; the endpoint's traversal plan from
   `health_report`. (b) `automl.regress` on `make_airbnb_dataset(n=
   10_000, seed=42)`'s bedrooms, accommodates, room_type and price with 3
   trials, on the card and on the CPU: the same families and
   parameters, each val_rmse within max(1e-3, 1e-5·|rmse|) (1e-3·rmse
   for a boosted family); the best trial's model loaded through
   `runs:/` and scored on the card; then the card alone at 100,000
   rows, timed. Every kernel of these paths must launch on each and no
   plain version may run on the card; a `{"registry": ...}` JSON line
   gives these numbers, and the kernels line's `launches_by_path` gains
   "endpoint" and "automl".

18. main path, the dispatcher, the host routes and prewarm, on phase 4's
   random ML 11 model (golden widths) and 100,000 of its rows: (a) the
   dispatcher's calibration of the card (the least of 3 round trips of
   a warmed 8x8 program, 16 MB pageable copies each way, best of 2;
   taken twice), `preroute` "device" for reason
   "local-chip", and every audited scoring and evaluation decision on
   the card; (b) `sml.dispatch.mode=host`: `score_block` at 64, 4,096
   and 100,000 rows through the C++ host traversal, bit-equal to the
   card's, host ms beside card ms, one host traversal and no launch a
   call; `RegressionEvaluator` on the host route within 1e-12 of the
   card's; (c) phase 4's burst (96 requests of 1-64 rows from 8 clients)
   against `sml.serve.queueRows` 256 with the host fallback asked for:
   no shed, `serve.host_routed` > 0, every response bit-equal to
   `score_block` of its rows, a launch a flushed batch; with it off (the
   default), sheds; (d) phase 17's waves
   of 8 with `sml.serve.flushAutoTune` off and on (the recorder on for
   both): p50, p99 and the final `flush_micros`; (e) in fresh processes,
   the first 64-row request's wall and the first ML 11 fit's wall (80,000
   rows) with `sml.prewarm.enabled` off and on (that process replays
   first the manifest that phases 1-17 and the first process recorded,
   its rows bucketed); (f) phase 4's burst with the
   recorder off and on: percentiles, events, each flush span naming its
   requests' traces, no watchdog stall, and `obs.audit_report()`. A
   `{"dispatch": ...}` line gives these numbers, and a `{"host_routes":
   ...}` line the host traversal's calls and times.

19. main path, the course's data plane on the session's device, with no
   pyarrow or pandas, in a temporary directory: (a)
   `ClassroomSetup.install_datasets()` (the raw Airbnb CSV, the clean
   table as parquet and as Delta, MovieLens's ratings as parquet, the
   dedup lab's 103,000-row text), its wall and each table's rows and
   bytes; (b) the clean table read through `read.format("delta")` and
   `read.parquet`, each equal to the seeded frame value for value and
   partition for partition, with the read walls; (c) ML 11's pipeline
   (phase 11's prep, XGBoost on log price) fitted and evaluated from the
   Delta read and from the seeded frame: rmse and predictions bit-equal,
   240 / 240 launches a fit and one traversal an evaluate; (d) ML 05L:
   an overwrite with `mergeSchema`, LinearRegression on `versionAsOf 0`
   (bit-equal to the fit before the overwrite) and on the latest
   version, `DESCRIBE HISTORY`; (e) ML 00L: the installed text read and
   deduplicated, 8 parquet part files written and read, both answers
   validated against the lab's hashes (1276280174, 972882115); (f) ML
   10: a feature table from the Delta read, a training set, ML 07's
   forest pipeline logged with it, and `score_batch` on the card equal to
   `transform` bit for bit; (g) `read_parquet_chunks` of the clean
   parquet (1,024-row chunks) into `RandomForestRegressor.fit_chunked`,
   bit-equal to `fit` on the read matrix. Every kernel must launch and no
   plain version may run on the card; a `{"dataplane": ...}` line gives
   these numbers, and the kernels line's `launches_by_path` gains
   "dataplane".

20. main path with its monitoring on (the recorder on only inside this
   phase, reset after it), on phase 8's rows: (a) ML 11's XGBoost and
   ML 07's forest (80,000 rows) fitted with the recorder off and on,
   each inside a tracking run and from empty caches: the same launches
   (240 / 240 and 120 / 120 / 1 / 1), bit-equal trees, the baseline's
   capture time (host numpy, no launch), the run's `engine.*` deltas with
   the ledger's `engine.hbm_peak_bytes` at most
   `torch.cuda.max_memory_allocated()`, every decision "local-chip"; (b)
   the ML 11 model logged with its `baseline.json`, registered, promoted
   and served through `ServingEndpoint`: 12 waves of 8 requests of 64
   training rows (p50 / p99 with the drift monitor fed and detached,
   the observer's µs a batch) flag nothing; a fresh window of 12 shifted
   waves (feature 9 moved 3 standard deviations) flags feature 9 alone,
   and its exemplar's trace id is in the exported Chrome trace; every
   response bit-equal to `score_block`, a traversal a batch; (c)
   `health_report()`'s blocks, the drift key and the traversal plan; (d)
   the training rows in 8 chunks, chunk 5 shifted, into ML 11's chunked
   fit against the ML 11 baseline: chunk 5 flags feature 9 alone, no
   other chunk flags, the ingest block names a slowest chunk, 240 / 240
   launches; (e) `dump_blackbox`: its files and sizes, its events
   rendered by the port's `_tracefmt.py` loaded by file path; (f)
   `sml.dispatch.mode=host`: ML 11 (16,000 rows) and KMeans asked for
   the card launch nothing and equal the CPU run. A `{"observed": ...}`
   line gives these numbers, and the kernels line's `launches_by_path`
   gains "observed".

21. fleet, stream and continuous training (the recorder on inside the
   phase, reset after it): ML 11's XGBoost on phase 8's 80,000 rows,
   registered as version 1 in Production; (a) a `ReplicaPool` of 3
   replicas on the card (prewarm on: `prewarm.replica_skip` 2), every
   replica's answer to the same 64 rows bit-equal to `score_block`; (b)
   a `closed_loop_probe`'s sustained rate R, then an open-loop
   `TraceSpec` through the `Router` (steady at 0.5 R, a burst averaging
   2 R with burst factor 4, steady again; widths 1-64 rows, fat-tailed;
   classes high / normal / low at 20 / 60 / 20): p50 / p99 / p99.9 by
   phase and class, sheds by class, `load.timeout` (0) and
   `load.overrun` (when it is not 0 the phase says that the harness was
   at fault), the closed loop's p99 beside the open loop's, the recorder
   off through (a)-(c); (c) the
   replica holding most of a burst killed mid-replay: every future
   resolves, `fleet.reroutes` > 0, its bundle written, and
   `Autoscaler.step()` backfills to 3; (d) a `ContinuousTrainer(fleet=
   pool)` over a `DeltaChunkSource` of held-out rows: under
   `minRefitRows` -> accumulate, iid -> clean, feature 9 shifted 3
   standard deviations -> a warm refit (hist / scan launches and one
   `init` traversal) whose staged rollout promotes (every replica then
   serves v2, bit-equal to its `score_block`), a window built to fail
   the quality gate (its gate rows keep their labels, the rest are
   permuted) -> rollback, v3 Archived, the failing replica evicted with
   its bundle; (e) MLE 00: the installed clean airbnb table (9,169 rows)
   as parquet parts of 1,000 rows through `readStream` (one file a
   trigger), a VectorAssembler and the LR model into a memory sink:
   `spark.sql` counts every row and the predictions equal the batch
   transform bit for bit; a `StreamChunkSource` over the query into one
   trainer `step()` (clean). A `{"fleet": ...}` line gives these numbers,
   and the kernels line's `launches_by_path` gains "fleet".
22. multi-rank fit, a mesh of ranks (`sml_tpu_torch/parallel/`): phase
   8's ML 11 XGBoost and ML 07 random forest on its 80,000 rows, each
   rank a process of this script on cuda:0 (the libraries built above)
   that stages and histograms its own block of the rows, the ranks'
   float64 histograms, leaf statistics and base all-reduced before their
   one rounding: (a) NCCL with one rank, every collective through it,
   the trees bit-equal to phase 8's and 281 / 141 psums a fit; (b) gloo
   with 2 and 4 ranks sharing the card, every rank's trees and held-out
   scores bit-equal to phase 8's,
   each rank's launches phase 8's (240 / 240; 120 / 120 / 1 / 1) and one
   traversal of its held-out rows; (c) the 4 ranks as 2 host groups, the
   same trees, the "dcn" hop's bytes half the "ici" hop's (gloo's
   reduce-scatter and all-gather of a CUDA payload go through host
   memory); each fit's wall beside the one-rank wall and the card (the
   ranks share its time: information only). (d) is in phase 7: the
   histogram's float64 output at the ranks' level-5 shapes against its
   plain version. A `{"multirank": ...}` line gives these numbers, and
   the kernels line's `launches_by_path` gains "multirank".
23. multi-rank tuning and warm start (`phase_multirank_tuning`): 1
   (NCCL), 2 and 4 (gloo) ranks on cuda:0 at once: (a) the fused ML 07
   grid with each element's rows split over the ranks and (b) in lanes
   of 2 ranks and at the auto width (4 lanes of 1), every rank's 12
   elements bit-equal to the tuning phase's fused fit; (c) the placed
   CrossValidator (2 submeshes of 2 ranks) equal to model selection's
   avgMetrics; (d) ML 11's chunked XGBoost, 20 rounds and 20
   warm-started, each rank ingesting its host view, and (e) an elastic
   fit that loses a host group, both bit-equal to the fit phase's
   model. (f) is in phase 7: the float64 histogram at the grid's last
   level on one of 4 ranks. A `{"multirank_tuning": ...}` line gives
   these numbers, and `launches_by_path` gains "multirank_tuning".
24. multi-rank non-tree programs and evaluation
   (`phase_multirank_nontree`): 1 (NCCL), 2 and 4 (gloo) ranks on
   cuda:0 at once, 4 also as 2 host groups, each rank staging its block
   of the rows and all-reducing its float64 partial sums: (a) ML 02, ML
   03, ridge and elastic net on phase 14's 80,000 training rows, and the
   compact Gram and IRLS at 4,194,304 rows; (b) MLE 03's logistic
   regression; (c) MLE 02's KMeans at k 3 and 8; (d) MLE 01's ALS at the
   golden shape (and the MovieLens 1M shape on 1 and 4 ranks), every
   fit bit-equal to phase 14's card result (ALS within 2e-5 and its rmse
   within 1e-6), with no launch and each all-reduce its payload; (e) the
   ML 07 CrossValidator with each validation fold evaluated over the
   ranks (the ordered block reduction), avgMetrics bit-equal to phase
   12's, each rank's traversals over its blocks; (f) on 2 ranks an ML 03
   fit under `sml.dispatch.mode=host`, the CPU's fit with no collective.
   A `{"multirank_nontree": ...}` line gives the psum calls and bytes
   and the walls (information only), and `launches_by_path` gains
   "multirank_nontree".

25. lint (`sml_tpu_torch/lint/`): `python3 scripts/torch_lint.py --json`
   in a fresh interpreter under `-X importtime`, on this machine's
   Python. It must exit 0, and none of torch, jax, sml_tpu or
   sml_tpu_torch may be imported. A `{"lint": ...}` line gives the rule
   count, the findings suppressed by pragma and by baseline, and the
   wall, beside the card. A failed lint fails the script.
26. pandas (`phase_pandas`): the pandas function API and the Koalas
   layer on this machine's Python. (a) In a fresh interpreter,
   `install_shims()`, `import databricks.koalas`, `pyspark.sql.functions.
   pandas_udf` and `sml_tpu_torch.pandas_api`, and a `mapInPandas`, a
   `groupBy().applyInPandas`, a `pandas_udf` column and a Koalas frame
   built (not run) over the course's Airbnb frame load none of pandas,
   pyarrow, jax or sml_tpu; (b) the four conf keys read their defaults
   and the course's alias moves `sml.arrow.maxRecordsPerBatch`; then the
   course's Delta table (`ClassroomSetup`'s install) is read on the card
   and ML 12's pipeline fitted on its 80% split. (c) Where this Python
   has no pandas, each action that hands a pandas
   object out (`mapInPandas(...).count()`, `applyInPandas(...).count()`,
   a `pandas_udf` in `select(...).collect()`, `toPandas()`,
   `kdf["room_type"].value_counts()`) must raise the bridge's
   ImportError naming it; with pandas, ML 12's `mapInPandas` and
   scalar-iterator `pandas_udf` with a `DeviceScorer` inside run on the
   card, each bit-equal to `score_block` with one traversal a batch, and
   ML 13's `applyInPandas` (a least squares fit a room type) and ML 14's
   `value_counts` run and are checked. (d) ML 14's Koalas operations that return port
   frames (`ks.read_delta` -> `filter(items=)`, `ks.sql("select
   distinct(room_type) from {kdf}")`, `len(kdf)`, `kdf.shape`) equal the
   frame's own results. (e) The way back: a batch with pandas' column
   interface through `DeviceScorer` and the pyfunc model's `predict`,
   bit-equal to `score_block`. A `{"pandas": ...}` line gives these
   results, the versions of pandas, pyarrow, scikit-learn and
   matplotlib found, the wall and the card; `launches_by_path` gains
   "pandas".

27. regress (`phase_regress`): the regression gate
   (`sml_tpu_torch/obs/regress.py`) on this run's own record, assembled
   from the JSON blocks above, the card, the host CPU, the versions, the
   commit, the seed, each phase's wall (phases 2-26, timed in `main`) and
   the proofs phases 22-24 and 26 assert (`regress.record_from_blocks`).
   The record against itself gives no finding; copies of it, each with
   one injection (`rg_injections`: a deterministic path's launches +1, a
   psum byte count +2%, a bit-equal proof flipped, a block removed, a
   phase wall +25%, lint rules at 10), each give exactly their finding; a
   racy path's launches +10% give none; the same wall +25% on another
   card is listed as not comparable; the findings land in the flight
   recorder through `obs.annotate_regressions`; and
   `scripts/torch_bench_diff.py`, in a fresh interpreter under `-X
   importtime`, exits 0 on the written record and 1 on an injected one,
   importing none of torch, jax, sml_tpu or sml_tpu_torch. A
   `{"regress": ...}` line gives the checks and walls.

`--record PATH` writes the run record (JSON) to PATH, for example
`chiprun_out/run.json` (git-ignored); without it phase 27 writes it to a
temporary directory and removes it. `python3 scripts/torch_bench_diff.py
BASE CAND` diffs two records.

`--only 23` runs phase 7's float64 histogram check, the phases that
phase 23 compares with (fit, tuning and model selection) and phase 23;
`--only 24` runs model selection, the non-tree phase and phase 24;
`--only 25` runs phase 25; `--only 26` runs phase 26; `--only 27` runs
phases 25 and 26 and phase 27 on their smaller record (the injections
it lacks the blocks for are skipped and named). Each prints its phases'
lines but no kernels line and no result.

The second-to-last line is a JSON object listing each kernel, with the
launches the profiler saw in each window behind its device times
("device_windows"); the last is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time
import types
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

# torchlint: disable-file=no-wallclock-in-engine -- the chip check's walls are its output: it times whole calls from outside the port, so the profiler's own cost never lands inside a timed window
# torchlint: disable-file=kernel-launch-outside-native -- the chip check calls each kernel's wrapper directly, to hold it against its plain version at the main path's shapes, and loads one library to time its raw entry point

#: H100 SXM published peaks (NVIDIA data sheet, at a 700 W limit): HBM
#: bytes a second, and f32 floating-point operations a second outside the
#: tensor cores (an FMA counts two)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
#: lanes a Hopper SM issues a clock for 32-bit integer and for float64
#: instructions (64 each, against 128 for f32); `card_rates` scales them
#: by the card's SM count and maximum SM clock. An integer or f64 op is
#: one lane's instruction (an f64 FMA counts one)
INT32_LANES_PER_SM = 64
F64_LANES_PER_SM = 64

#: the tolerance of the card's scores against the CPU's (`score_block`
#: on both): the leaf choice is exact and the two sums over trees are
#: f32 in one order; the kernel itself is held to its plain version bit
#: for bit
RTOL = 1e-5
#: histogram cells: |kernel - plain| <= HIST_RTOL * (the cell summed over
#: |contributions|) + 1e-30; both sum in float64 in another order and
#: round to f32 once
HIST_RTOL = 1e-5
#: held-out rmse of a fit on the card and the same fit on the CPU: the
#: golden tolerance, max(1e-3, 1e-5 * |rmse|)
RMSE_ATOL, RMSE_RTOL = 1e-3, 1e-5


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


_RATES = {}


def card_rates() -> dict:
    """The card's INT32 and f64 instruction rates (ops a second): 64
    lanes an SM a clock, times the SM count torch reports and the
    maximum SM clock nvidia-smi reports; with the clock and SM count."""
    if not _RATES:
        mhz = float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True, timeout=60).stdout.split()[0])
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        _RATES.update(int32=INT32_LANES_PER_SM * sms * mhz * 1e6,
                      f64=F64_LANES_PER_SM * sms * mhz * 1e6,
                      sm_mhz=mhz, sms=sms)
    return _RATES


def bound_of(nbytes: int, int_ops: int = 0, f32_flops: int = 0,
             f64_ops: int = 0):
    """(ms, "bytes" or "operations"): the least time of a call, the
    larger of its bytes over HBM bandwidth and, for each kind of work,
    its operations over the card's rate for that kind (integer and f64 at
    `card_rates`, f32 at `F32_FLOPS_PER_S`)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    rates = card_rates() if int_ops or f64_ops else {}
    t_ops = max(int_ops / rates["int32"] if int_ops else 0.0,
                f32_flops / F32_FLOPS_PER_S,
                f64_ops / rates["f64"] if f64_ops else 0.0) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------ ensembles
def random_tables(rng, n_trees: int, depth: int, n_bins: int, n_feat: int,
                  early_leaf: float = 0.15):
    """Heap-layout tables of a random ensemble: every node above `depth`
    splits on a random feature and bin, except a random `early_leaf`
    share of internal nodes below the root, which are leaves."""
    n_nodes = 2 ** (depth + 1) - 1
    level = np.floor(np.log2(np.arange(n_nodes) + 1)).astype(np.int64)
    sf = rng.integers(0, n_feat, size=(n_trees, n_nodes)).astype(np.int32)
    sf[:, level == depth] = -1
    early = (rng.random((n_trees, n_nodes)) < early_leaf) & (level > 0)
    sf[early] = -1
    sb = rng.integers(0, max(n_bins - 1, 1),
                      size=(n_trees, n_nodes)).astype(np.int32)
    lv = rng.normal(0.0, 0.3, size=(n_trees, n_nodes)).astype(np.float32)
    return sf, sb, lv


SHAPES = [
    # name, trees, depth, bins, bin dtype, weights
    ("ML 11 XGBoost", 40, 6, 64, np.uint8, "step"),
    ("ML 07 RF", 20, 6, 40, np.uint8, "mean"),
    ("ML 06 DT", 1, 5, 40, np.uint8, "mean"),
    ("uint16 bins", 40, 6, 300, np.uint16, "step"),
    ("int32 bins", 40, 6, 70_000, np.int32, "step"),
]
N_FEAT = 10
#: row counts of the kernel checks: requests of one row to a full
#: request, a serving batch, the ML 12 batch size
CHECK_ROWS = (1, 37, 64, 4096, 100_000)
#: shapes of the kernel's other paths, each with its row counts, its
#: features and what its plan must hold
PATH_SHAPES = [
    # (shape, rows, features, plan fields)
    (("wide rows", 8, 6, 16, np.int32, "step"), (37, 4096), 400,
     {"path": "shared", "stage_x": 0}),
    (("many trees", 300, 6, 64, np.uint8, "step"), (37, 4096), N_FEAT,
     {"path": "shared", "n_chunks": 2}),
    # one tree group, its running sum carried across chunks in `out`
    (("many trees", 300, 6, 64, np.uint8, "step"), (100_000,), N_FEAT,
     {"path": "shared", "n_chunks": 2, "groups": 1}),
    (("deep, tree chunks", 4, 13, 300, np.uint16, "step"), (37, 4096),
     N_FEAT, {"path": "shared", "n_chunks": 2}),
    (("deep, global memory", 2, 16, 300, np.uint16, "step"), (37, 4096),
     N_FEAT, {"path": "global"}),
]


def shape_operands(rng, shape, n_rows: int, device, n_feat: int = N_FEAT):
    """Seeded operands of one kernel check: a random ensemble of `shape`
    (with ~1% of its split features past the row) and uniform bins."""
    _, T, depth, n_bins, dtype, wkind = shape
    sf, sb, lv = random_tables(rng, T, depth, n_bins, n_feat)
    sf[(sf >= 0) & (rng.random(sf.shape) < 0.01)] = n_feat + 3
    w = np.full(T, 0.15 if wkind == "step" else 1.0 / T, np.float32)
    binned = rng.integers(0, n_bins, size=(n_rows, n_feat)).astype(dtype)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return to(binned), to(sf), to(sb), to(lv), to(w), depth


def levels_descended(binned, sf, sb, depth: int) -> int:
    """Node visits the traversal makes on these inputs (rows x trees x
    internal levels reached): the data-dependent work of the bound."""
    x = binned.to(torch.int64)
    total = 0
    for t in range(sf.shape[0]):
        node = torch.zeros(x.shape[0], dtype=torch.int64, device=x.device)
        for _ in range(depth):
            f = sf[t].to(torch.int64)[node]
            internal = f >= 0
            total += int(internal.sum())
            xb = x.gather(1, f.clamp(0, x.shape[1] - 1)[:, None])[:, 0]
            xb = torch.where(f < x.shape[1], xb, 0)
            child = 2 * node + 1 + (xb > sb[t].to(torch.int64)[node]).long()
            node = torch.where(internal, child, node)
    return total


def table_bytes(sf, depth: int) -> int:
    """Bytes of the node tables a traversal must read: sf and sb of each
    internal node a row can reach (sf and lv at an early leaf), lv of
    each reachable last-level node. A node below an early leaf is never
    reached."""
    f = sf[:, :2 ** (depth + 1) - 1].cpu().numpy()
    reach = np.ones(f.shape, bool)
    for lvl in range(1, depth + 1):
        j = np.arange(2 ** lvl - 1, 2 ** (lvl + 1) - 1)
        par = (j - 1) // 2
        reach[:, j] = reach[:, par] & (f[:, par] >= 0)
    nrec = 2 ** depth - 1
    return 8 * int(reach[:, :nrec].sum()) + 4 * int(reach[:, nrec:].sum())


def bound_ms(binned, sf, sb, depth: int):
    """(ms, "bytes" or "operations"): the larger of the bytes the call
    must move over HBM bandwidth (bins read once, the reachable part of
    the tables (`table_bytes`) and the weights read once, margins written
    once) and its operations (`bound_of`): per node visit a compare and
    the child index, 3 integer ops; per row and tree the weighted add, an
    f32 FMA (2 flops)."""
    n, n_feat = binned.shape
    T = sf.shape[0]
    nbytes = n * n_feat * binned.element_size() + table_bytes(sf, depth) \
        + 4 * T + 4 * n
    return bound_of(nbytes,
                    int_ops=3 * levels_descended(binned, sf, sb, depth),
                    f32_flops=2 * n * T)


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events around each."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


#: what each `device_ms` call measured -> the launches a window should
#: hold ("want") and the launches the profiler saw in each window taken
#: ("seen"; a window up to 5% short is accepted), for the kernels line
DEVICE_WINDOWS = {}


def device_ms(fn, reps: int, names, per_call: int = 1, what: str = ""):
    """Device time of one call by `torch.profiler`: over `reps` calls,
    each kernel whose name contains one of `names` at its mean device
    time over the launches the profiler saw, times its launches a call
    (the CUDA-event median of `time_ms` also holds the host's gap before
    the launch). The profiler may lose a few kernel records of a window
    (on the H100 one to three a window, by machine); a window that lost
    more than 5% of its reps x `per_call` launches (at least one is
    allowed) is retaken, up to three times; then None ("not measured").
    The counts each window saw go to `DEVICE_WINDOWS[what]`, and the
    kernels line gives each device time's beside it (`seen_of`)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    want = reps * per_call
    seen_by_window = []
    DEVICE_WINDOWS[what or "/".join(names)] = {"want": want,
                                               "seen": seen_by_window}
    for _ in range(3):   # a window where the profiler lost events is retaken
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        seen = {}        # kernel name -> (device us, launches)
        for ev in prof.key_averages():
            t = float(getattr(ev, "self_device_time_total", 0.0))
            if t > 0 and any(nm in ev.key for nm in names):
                tot, cnt = seen.get(ev.key, (0.0, 0))
                seen[ev.key] = (tot + t, cnt + int(ev.count))
        count = sum(cnt for _, cnt in seen.values())
        seen_by_window.append(count)
        if want - max(1, want // 20) <= count <= want:
            return sum(tot / cnt * round(cnt / reps)
                       for tot, cnt in seen.values()) / 1e3
        print(f"device time of {names}: the profiler saw {count} launches, "
              f"not {want}")
    print(f"device time of {names}: not measured")
    return None


def seen_of(what: str):
    """The launches the profiler saw against those wanted in the window
    a device time of `what` was taken from ("98/100"; one a window, for a
    median over windows), or None where none was taken."""
    hits = [w for k, w in DEVICE_WINDOWS.items()
            if k == what or k.startswith(what + " window ")]
    return ", ".join(f"{w['seen'][-1]}/{w['want']}" for w in hits) or None


def fmt_ms(x) -> str:
    return "not measured" if x is None else repr(x)


def host_us(fn, calls: int = 400) -> float:
    """Median host time of one call in microseconds: perf_counter around
    the call, no synchronise inside (the launch is asynchronous); the
    queue is drained every 50 calls, outside the timed calls."""
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    times = []
    for i in range(calls):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
        if i % 50 == 49:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median(times)) * 1e6


def assert_close(got: np.ndarray, want: np.ndarray, what: str) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape or not np.isfinite(got).all():
        raise AssertionError(f"{what}: shape {got.shape} vs {want.shape} "
                             f"or non-finite values")
    atol = RTOL * max(float(np.abs(want).max(initial=0.0)), 1e-30)
    err = np.abs(got - want)
    if not (err <= atol + RTOL * np.abs(want)).all():
        raise AssertionError(f"{what}: max abs err {err.max()} over "
                             f"atol {atol} + rtol {RTOL}")
    return float(err.max(initial=0.0))


# ------------------------------------------------------------ phases
def phase_kernels(seed: int, device) -> float:
    """Kernel against plain, bit for bit, at every shape and row count,
    each launch's plan printed and the other paths' plans checked;
    returns the largest absolute difference seen (0.0)."""
    from sml_tpu_torch.native import traverse_kernel as tk
    cases = [(s, CHECK_ROWS, N_FEAT, {"path": "shared", "stage_x": 1,
                                      "n_chunks": 1}) for s in SHAPES]
    worst = 0.0
    for i, (shape, rows, n_feat, expect) in enumerate(cases + PATH_SHAPES):
        for n_rows in rows:
            rng = np.random.default_rng([seed, i, n_rows])
            binned, sf, sb, lv, w, depth = shape_operands(
                rng, shape, n_rows, device, n_feat)
            plan = tk.traverse_plan(n_rows, n_feat, binned.element_size(),
                                    *sf.shape, depth)
            if any(getattr(plan, k) != v for k, v in expect.items()):
                raise AssertionError(f"forest_traverse {shape[0]} x {n_rows}"
                                     f": {plan} does not hold {expect}")
            got = tk.forest_traverse(binned, sf, sb, lv, w, depth=depth)
            torch.cuda.synchronize()
            want = tk.forest_margin_plain(binned, sf, sb, lv, w, depth)
            got, want = got.cpu().numpy(), want.cpu().numpy()
            np.testing.assert_array_equal(
                got, want, err_msg=f"forest_traverse {shape[0]} x {n_rows}")
            err = float(np.abs(got - want).max(initial=0.0))
            print(f"kernel-vs-plain  forest_traverse  {shape[0]:<19} "
                  f"rows={n_rows:<7} T={sf.shape[0]} depth={depth} "
                  f"F={n_feat} dtype={binned.dtype}: {plan} "
                  f"max_abs_err={err!r} bit-equal  ok")
            worst = max(worst, err)
    return worst


def ml11_model(seed: int):
    """An ML 11-shaped boosted model: seeded raw rows (3 indexed
    categoricals, 7 numerics with gaps), bin edges from the port's
    `make_bins` at maxBins 64, random trees over those bins, carried
    through `spec_from_arrays` as a saved model would be."""
    from sml_tpu_torch.ml._tree_models import spec_from_arrays
    from sml_tpu_torch.ml.tree_impl import make_bins
    from sml_tpu_torch.xgboost import XgboostRegressorModel
    rng = np.random.default_rng([seed, 11])
    cats = {0: 36, 1: 3, 2: 20}
    X, y = ml11_rows(rng, 50_000, cats)
    _, binning = make_bins(X, y, 64, categorical=cats)
    T, depth = 40, 6
    sf, sb, lv = random_tables(rng, T, depth, 64, N_FEAT)
    lv *= 0.1
    zeros = np.zeros_like(lv)
    keys = sorted(binning.cat_remap)
    arrays = dict(split_feature=sf, split_bin=sb, leaf_value=lv, gain=zeros,
                  cover=zeros, edges=binning.edges,
                  tree_weights=np.full(T, 0.15, np.float32),
                  scalars=np.asarray([depth, 5.0, N_FEAT, 0.0, len(keys)]),
                  remap_slots=np.asarray(keys, np.int64),
                  **{f"remap_{k}": binning.cat_remap[k] for k in keys})
    return XgboostRegressorModel(spec_from_arrays(arrays)), cats


def ml11_rows(rng, n: int, cats):
    """Raw ML 11-shaped rows and log-price labels."""
    X = rng.normal(size=(n, N_FEAT))
    for f, card in cats.items():
        X[:, f] = rng.integers(0, card, size=n)
    X[rng.random(n) < 0.05, 5] = np.nan  # imputed-column gaps
    y = 5.0 + 0.3 * X[:, 3] - 0.2 * np.nan_to_num(X[:, 4]) \
        + rng.normal(0, 0.4, n)
    return X, y


def fit_labels(rng, X):
    """Log-price labels for the fit phases, on ML 11-shaped rows: a
    linear part, per-category offsets of the 36-value categorical, a
    smooth interaction and noise, so that the boosted ensemble has
    structure to find that one depth-5 tree cannot hold."""
    offsets = (np.arange(36) % 7 - 3) * 0.12
    return (4.8 + 0.3 * X[:, 3] - 0.2 * np.nan_to_num(X[:, 4])
            + offsets[X[:, 0].astype(np.int64)]
            + 0.25 * np.tanh(X[:, 6]) * X[:, 7] + 0.2 * (X[:, 1] == 1)
            + rng.normal(0.0, 0.25, X.shape[0]))


def phase_main_path(seed: int, device) -> dict:
    """Score, evaluate and serve through the port's entry points; return
    the launch count of the run and its split by row count."""
    from sml_tpu_torch.ml import inference
    from sml_tpu_torch.ml.evaluation import _reg_metric, host_reg_stats
    from sml_tpu_torch.ml.inference import DeviceScorer, forest_eval_fn
    from sml_tpu_torch.ml.tree_impl import bin_with
    from sml_tpu_torch.ml._staging import stage_bins_cached
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.serving import MicroBatcher
    from sml_tpu_torch.utils.profiler import PROFILER

    model, cats = ml11_model(seed)
    rng = np.random.default_rng([seed, 12])
    X, logy = ml11_rows(rng, 100_000, cats)
    price = np.exp(logy[:20_000])

    plain_on_cuda = [0]
    plain = tk.forest_margin_plain

    def watched_plain(binned, *args):
        if binned.device.type == "cuda":
            plain_on_cuda[0] += 1
        return plain(binned, *args)

    # the row count of every traversal the scoring path asks for
    launch_rows = []
    traverse = inference.forest_traverse

    def counted_traverse(binned, *args, **kw):
        launch_rows.append(binned.shape[0])
        return traverse(binned, *args, **kw)

    tk.forest_margin_plain = watched_plain
    inference.forest_traverse = counted_traverse
    PROFILER.reset()
    tk.LAUNCHES = 0
    try:
        t0 = time.perf_counter()
        scorer = DeviceScorer(model)
        pred = scorer.score_block(X)
        t_score = time.perf_counter() - t0
        if pred.shape != (100_000,) or not np.isfinite(pred).all():
            raise AssertionError(f"score_block gave {pred.shape} "
                                 f"with non-finite values")

        # fused predict+eval, exp link, against host stats of the
        # materialised predictions
        Xe = X[:20_000]
        spec = model._spec
        Bd = stage_bins_cached(bin_with(Xe, spec.binning), scorer.device)
        lab = torch.from_numpy(price.astype(np.float32)).to(scorer.device)
        lmask = torch.ones_like(lab)
        stats = forest_eval_fn(spec.depth, "exp")(
            Bd, lab, lmask, *scorer._params, float(spec.base))
        stats = [float(s) for s in stats]
        host = host_reg_stats(np.exp(pred[:20_000]), price)
        # the device applies base and the link in f32, the host in f64
        np.testing.assert_allclose(stats, host, rtol=1e-4)
        rmse = _reg_metric("rmse", *stats)
        print(f"main-path  forest_eval exp-link 20000 rows: rmse={rmse!r} "
              f"host_rmse={_reg_metric('rmse', *host)!r}")

        # serve: 96 concurrent requests of 1-64 rows
        sizes = rng.integers(1, 65, size=96)
        offs = np.concatenate([[0], np.cumsum(sizes)])
        reqs = [X[offs[i]:offs[i + 1]] for i in range(len(sizes))]
        futs = [None] * len(reqs)
        barrier = threading.Barrier(8)
        with MicroBatcher(scorer.score_block, max_batch_rows=4096,
                          flush_micros=2000) as server:
            def client(lo):
                barrier.wait()
                for i in range(lo, len(reqs), 8):
                    futs[i] = server.submit(reqs[i])
            threads = [threading.Thread(target=client, args=(lo,))
                       for lo in range(8)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            got = [f.result(60) for f in futs]
        for i, (g, r) in enumerate(zip(got, reqs)):
            np.testing.assert_array_equal(g, scorer.score_block(r))
            np.testing.assert_array_equal(g, pred[offs[i]:offs[i + 1]])

        # a worker thread on its own stream: the launch goes to that
        # stream and the copy back waits for it
        side = {}

        def on_stream():
            s = torch.cuda.Stream(device=scorer.device)
            with torch.cuda.stream(s):
                side["out"] = scorer.score_block(X[:4096])
                side["done"] = s.query()
        th = threading.Thread(target=on_stream)
        th.start()
        th.join(timeout=60)
        if not side.get("done"):
            raise AssertionError("score_block returned before its stream "
                                 "finished")
        np.testing.assert_array_equal(side["out"], pred[:4096])
        torch.cuda.synchronize()
    finally:
        launches = tk.LAUNCHES
        tk.forest_margin_plain = plain
        inference.forest_traverse = traverse
    counters = PROFILER.counters()
    if launches <= 0:
        raise AssertionError("the main path launched forest_traverse 0 times")
    if plain_on_cuda[0]:
        raise AssertionError(f"the plain traversal ran {plain_on_cuda[0]} "
                             f"times on CUDA tensors")
    if counters.get("serve.shed", 0.0):
        raise AssertionError(f"{counters['serve.shed']} requests shed")
    print(f"main-path  score_block 100000 rows {t_score * 1e3:.1f} ms "
          f"(first call, host clock, binning and staging included); "
          f"served {len(reqs)} requests in "
          f"{int(counters.get('serve.batches', 0))} batches; "
          f"forest_traverse launches={launches}")
    split = {"<=64": sum(r <= 64 for r in launch_rows),
             "65-4096": sum(64 < r <= 4096 for r in launch_rows),
             ">4096": sum(r > 4096 for r in launch_rows)}
    if len(launch_rows) != launches:
        raise AssertionError(f"{len(launch_rows)} traversals asked for, "
                             f"{launches} launches")
    print(f"main-path  forest_traverse launches by rows: {split} "
          f"(rows of the larger ones: "
          f"{sorted(r for r in launch_rows if r > 64)})")

    # agreement with the plain version on the host, on a small input
    cpu = DeviceScorer(model, device="cpu").score_block(X[:2000])
    assert_close(pred[:2000], cpu, "score_block cuda vs cpu")
    return {"launches": launches, "launches_by_rows": split}


#: row counts `forest_traverse` is timed at: a full request, a serving
#: batch, the ML 12 batch size
TIME_ROWS = (64, 4096, 100_000)


def ml11_operands(seed: int, n_rows: int, device):
    """The seeded ML 11-shaped operands (`SHAPES[0]`) the kernel is timed
    on at `n_rows` rows."""
    rng = np.random.default_rng([seed, 0, n_rows])
    return shape_operands(rng, SHAPES[0], n_rows, device)


def traverse_ms(ops, reps: int, what: str = "forest_traverse"):
    """(CUDA-event median, profiler device time) of one `forest_traverse`
    call on `ops`; the launches made here are not counted."""
    from sml_tpu_torch.native import traverse_kernel as tk
    binned, sf, sb, lv, w, depth = ops
    launches = tk.LAUNCHES

    def call():
        return tk.forest_traverse(binned, sf, sb, lv, w, depth=depth)
    k_ms = time_ms(call, reps)
    d_ms = device_ms(call, reps, ("forest_traverse",), what=what)
    tk.LAUNCHES = launches
    return k_ms, d_ms


def phase_times(seed: int, device, card: str) -> dict:
    """Kernel (CUDA-event median and profiler device time), plain and
    bound at the ML 11 shape at each of `TIME_ROWS`, for the kernels
    line."""
    from sml_tpu_torch.native import traverse_kernel as tk
    out = {}
    for n_rows in TIME_ROWS:
        ops = ml11_operands(seed, n_rows, device)
        binned, sf, sb, lv, w, depth = ops
        k_ms, d_ms = traverse_ms(ops, 100, f"forest_traverse rows={n_rows}")
        p_ms = time_ms(lambda: tk.forest_margin_plain(binned, sf, sb, lv,
                                                      w, depth), 5)
        b_ms, b_by = bound_ms(binned, sf, sb, depth)
        plan = tk.traverse_plan(n_rows, N_FEAT, 1, *sf.shape, depth)
        print(f"time  forest_traverse  ML 11 T=40 depth=6 F=10 uint8 "
              f"rows={n_rows} {plan}: kernel {k_ms!r} ms (device "
              f"{fmt_ms(d_ms)} ms), plain {p_ms!r} ms, bound {b_ms!r} ms "
              f"({b_by}); card {card}")
        out[n_rows] = (k_ms, d_ms, p_ms, b_ms, b_by)
    return out


def phase_breakdown(seed: int, device, card: str) -> None:
    """Host-clock split of one `score_block` call on fresh rows (a full
    serving batch and the ML 12 batch size): host binning, staging to
    the card, the launch until the card is done, the copy back, and the
    whole call on other fresh rows."""
    from sml_tpu_torch.ml._staging import stage_bins_cached
    from sml_tpu_torch.ml.inference import DeviceScorer
    from sml_tpu_torch.ml.tree_impl import bin_with
    from sml_tpu_torch.native import traverse_kernel as tk
    model, cats = ml11_model(seed)
    spec = model._spec
    scorer = DeviceScorer(model, device=device)
    launches = tk.LAUNCHES
    for n_rows in (4096, 100_000):
        rng = np.random.default_rng([seed, 13, n_rows])
        X, _ = ml11_rows(rng, n_rows, cats)
        X2, _ = ml11_rows(rng, n_rows, cats)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        binned = bin_with(X, spec.binning)
        t1 = time.perf_counter()
        Bd = stage_bins_cached(binned, device)
        t2 = time.perf_counter()
        out = tk.forest_traverse(Bd, *scorer._params, depth=spec.depth)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        out.cpu().numpy()
        t4 = time.perf_counter()
        scorer.score_block(X2)
        t5 = time.perf_counter()
        print(f"breakdown  score_block ML 11 rows={n_rows}: "
              f"bin_with {(t1 - t0) * 1e3!r} ms, stage {(t2 - t1) * 1e3!r} "
              f"ms, launch+kernel {(t3 - t2) * 1e3!r} ms, copy back "
              f"{(t4 - t3) * 1e3!r} ms; whole call on fresh rows "
              f"{(t5 - t4) * 1e3!r} ms (host clock); card {card}")
    tk.LAUNCHES = launches  # not the main path's launches


def _median_ms(fn, calls: int = 5):
    """(median host ms of `calls` calls of fn, the last result)."""
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), out


def phase_binning(seed: int, card: str) -> dict:
    """The host binning's C++ kernel (`tree_impl._bin_columns`) against
    its NumPy version (`_bin_columns_plain`) on the same fresh ML
    11-shaped rows: bins equal, and each one's median host time over 5
    calls, for `bin_with`'s search (the ML 11 model's edges and category
    ranks) at 4,096 and 100,000 rows, and for `make_bins` (a fit's
    `binning.fit`: quantiles, then the search) at 80,000 rows."""
    from sml_tpu_torch.ml import tree_impl
    model, cats = ml11_model(seed)
    binning = model._spec.binning
    edge_list, dtype = tree_impl.binning_edges_and_dtype(binning)
    out = {}
    for n_rows in (4096, 100_000):
        X, _ = ml11_rows(np.random.default_rng([seed, 14, n_rows]), n_rows,
                         cats)
        cpp, got = _median_ms(lambda: tree_impl._bin_columns(
            X, edge_list, binning.cat_remap, dtype))
        plain, want = _median_ms(lambda: tree_impl._bin_columns_plain(
            X, edge_list, binning.cat_remap, dtype))
        np.testing.assert_array_equal(got, want)
        out[f"bin_with {n_rows}"] = (cpp, plain)
        print(f"binning  bin_with search ML 11 rows={n_rows}: C++ {cpp!r} "
              f"ms, NumPy {plain!r} ms, bins equal (host clock, median of "
              f"5); card {card}")
    rng = np.random.default_rng([seed, 15])
    X, _ = ml11_rows(rng, 80_000, cats)
    y = fit_labels(rng, X)
    cpp, (got, _) = _median_ms(lambda: tree_impl.make_bins(X, y, 64, cats))
    kernel = tree_impl._bin_columns
    tree_impl._bin_columns = tree_impl._bin_columns_plain
    try:
        plain, (want, _) = _median_ms(
            lambda: tree_impl.make_bins(X, y, 64, cats))
    finally:
        tree_impl._bin_columns = kernel
    np.testing.assert_array_equal(got, want)
    out["make_bins 80000"] = (cpp, plain)
    print(f"binning  make_bins ML 11 80000 rows 64 bins: C++ {cpp!r} ms, "
          f"NumPy {plain!r} ms, bins equal (host clock, median of 5); "
          f"card {card}")
    return out


# ------------------------------------------------------------ fit kernels
HIST_SHAPES = [
    # name, rows, features, bins, bin dtype, slot counts
    ("ML 11", 80_000, N_FEAT, 64, np.uint8, (1, 2, 4, 8, 16, 32)),
    ("ML 06", 80_000, N_FEAT, 40, np.uint8, (1, 2, 4, 8, 16)),
    ("uint16 bins", 80_000, N_FEAT, 300, np.uint16, (8, 32)),
    ("int32 bins", 80_000, N_FEAT, 70_000, np.int32, (2,)),
    # the last rows past a multiple of 16 (plain loads), a chunk of a
    # few rows, and rows too wide to stage their bins
    ("odd rows", 80_001, N_FEAT, 64, np.uint8, (8,)),
    ("few rows", 37, N_FEAT, 64, np.uint8, (4,)),
    ("wide rows", 20_000, 400, 16, np.int32, (4,)),
    # the last level of the ML 07 grid fused: 12 elements of 53,334 rows
    # end to end, 12 x 8 left-child slots
    ("ML 07 grid", 640_008, N_FEAT, 40, np.uint8, (96,)),
]
SCAN_SHAPES = [
    # name, bins, node counts
    ("ML 11", 64, (1, 2, 4, 8, 16, 32)),
    ("ML 06", 40, (16,)),
    ("uint16 bins", 300, (32,)),
    ("histogram past 48 KB a node", 5000, (4,)),
]


def hist_operands(rng, n: int, n_bins: int, dtype, n_slots: int, device,
                  n_feat: int = N_FEAT):
    """Seeded rows for one histogram launch: uniform bins and slots,
    normal gradients, Hessians in [0.1, 1], whole weights with ~20%
    zeros."""
    def to(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)
    binned = rng.integers(0, n_bins, size=(n, n_feat)).astype(dtype)
    lid = rng.integers(0, n_slots, size=n).astype(np.int32)
    grad = rng.normal(0.0, 1.0, n).astype(np.float32)
    hess = rng.uniform(0.1, 1.0, n).astype(np.float32)
    weight = rng.integers(1, 3, n).astype(np.float32)
    weight[rng.random(n) < 0.2] = 0.0
    return to(binned), to(lid), to(grad), to(hess), to(weight)


def dyadic_hist(rng, n_bins: int, width: int, device):
    """An (F, B, W, 3) histogram of multiples of 1/8, 1/4 and whole
    counts (every prefix sum exact in f32) with a repeated feature
    (exact ties), an all-in-one-bin node, a zero-Hessian node and a node
    whose squared sums overflow to NaN scores; and a feature mask with
    some features and one whole node masked."""
    h = np.zeros((N_FEAT, n_bins, width, 3), np.float32)
    h[..., 0] = rng.integers(-64, 64, size=h.shape[:3]) / 8.0
    h[..., 2] = rng.integers(0, 6, size=h.shape[:3])
    h[..., 1] = h[..., 2] * rng.integers(1, 5, size=h.shape[:3]) / 4.0
    h[1] = h[0]
    fmask = (rng.random((width, N_FEAT)) > 0.2).astype(np.float32)
    fmask[:, 0] = 1.0
    for w, kind in enumerate(("one bin", "no hessian", "overflow",
                              "masked")[:max(width - 1, 0)], start=1):
        if kind == "one bin":
            h[:, :, w] = 0.0
            h[:, 2, w] = [1.0, 2.0, 4.0]
        elif kind == "no hessian":
            h[:, :, w, 1] = 0.0
        elif kind == "overflow":
            h[:, :, w, 0] = np.where(np.arange(n_bins) % 2 == 0, 2.0 ** 70,
                                     0.0)
            h[:, :, w, 1] = 0.0
        else:
            fmask[w] = 0.0
    return torch.from_numpy(h).to(device), torch.from_numpy(fmask).to(device)


def phase_fit_kernels(seed: int, device) -> dict:
    """Each fit kernel against its plain version at every shape; returns
    the largest absolute differences seen."""
    from sml_tpu_torch.native import hist_kernel as hk
    worst = {"hist_accumulate": 0.0, "split_scan": 0.0}
    for i, (name, n, n_feat, n_bins, dtype, slots) in enumerate(HIST_SHAPES):
        for n_slots in slots:
            rng = np.random.default_rng([seed, 21, i, n_slots])
            b, lid, g, h, w = hist_operands(rng, n, n_bins, dtype, n_slots,
                                            device, n_feat)
            got = hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                     n_slots=n_slots)
            again = hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                       n_slots=n_slots)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"hist_accumulate {name} S={n_slots}: "
                                     f"two launches differ")
            want = hk.hist_accumulate_plain(b, lid, g, h, w, n_bins, n_slots)
            scale = hk.hist_accumulate_plain(b, lid, g.abs(), h.abs(), w,
                                             n_bins, n_slots)
            err = (got - want).abs()
            if not bool((err <= HIST_RTOL * scale + 1e-30).all()):
                raise AssertionError(f"hist_accumulate {name} S={n_slots}: "
                                     f"max abs err {float(err.max())}")
            if not torch.equal(got[:, 2::3], want[:, 2::3]):
                raise AssertionError(f"hist_accumulate {name} S={n_slots}: "
                                     f"weight sums differ")
            differ = int((got != want).sum())
            plan = hk.hist_plan(n, n_feat, n_bins, n_slots,
                                bin_bytes=b.element_size())
            print(f"kernel-vs-plain  hist_accumulate  {name:<12} "
                  f"rows={n} F={n_feat} bins={n_bins} S={n_slots:<2} "
                  f"dtype={b.dtype} {plan} "
                  f"max_abs_err={float(err.max()):.3e} cells_differing="
                  f"{differ}/{got.numel()}  deterministic  ok")
            worst["hist_accumulate"] = max(worst["hist_accumulate"],
                                           float(err.max()))
    worst["hist_f64"] = phase_hist_f64(seed, device)
    for i, (name, n_bins, widths) in enumerate(SCAN_SHAPES):
        for width in widths:
            err = 0.0
            for lam, gamma, mi in ((1.0, 0.0, 1.0), (0.0, 0.25, 3.0)):
                rng = np.random.default_rng([seed, 22, i, width, int(mi)])
                hist, fmask = dyadic_hist(rng, n_bins, width, device)
                mi_t = torch.full((width,), mi, device=device)
                got = hk.split_scan(hist, fmask, mi_t, reg_lambda=lam,
                                    gamma=gamma)
                torch.cuda.synchronize()
                want = hk.split_scan_plain(hist, fmask, mi_t, lam, gamma)
                np.testing.assert_array_equal(
                    got.cpu().numpy(), want.cpu().numpy(),
                    err_msg=f"split_scan {name} W={width} lam={lam}")
                err = max(err, pack_err(got, want))
            worst["split_scan"] = max(worst["split_scan"], err)
            print(f"kernel-vs-plain  split_scan  {name:<28} bins={n_bins} "
                  f"W={width:<2} max_abs_err={err:.3e} exact (ties, masked, "
                  f"NaN nodes)  ok")
    # the fused grid's last level: 12 elements of 16 nodes, each element's
    # nodes held to its own least child weight
    rng = np.random.default_rng([seed, 23])
    hist, fmask = dyadic_hist(rng, 40, FUSED_NODES, device)
    mi_t = torch.from_numpy(np.repeat(FUSED_MIN_INST, FUSED_NODES
                                      // len(FUSED_MIN_INST))).to(device)
    got = hk.split_scan(hist, fmask, mi_t, reg_lambda=0.0, gamma=0.0)
    torch.cuda.synchronize()
    want = hk.split_scan_plain(hist, fmask, mi_t, 0.0, 0.0)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy(),
                                  err_msg="split_scan per-node min_inst")
    err = pack_err(got, want)
    worst["split_scan"] = max(worst["split_scan"], err)
    print(f"kernel-vs-plain  split_scan  ML 07 grid, per-node min_inst "
          f"bins=40 W={FUSED_NODES} (12 x 16, min_inst 1/2/5) "
          f"max_abs_err={err:.3e} exact  ok")
    return worst


#: (rows, slots, bins) of the float64 histograms the fits over ranks
#: all-reduce, uint8 bins: the level-5 histograms of phase 22's ML 11 fit
#: over 2 and 4 ranks (each rank's block of the 80,000 rows, 16 left-child
#: slots, 64 bins), and the last level of phase 23's fused ML 07 grid
#: over 4 ranks (each rank's block of each of the 12 elements' 53,334
#: rows, 12 x 13,334 rows, 12 x 8 left-child slots, 40 bins)
F64_SHAPES = ((40_000, 16, 64), (20_000, 16, 64), (160_008, 96, 40))


def f64_bound(n: int, scale: torch.Tensor) -> torch.Tensor:
    """The most two float64 sums of the same n-row cells may differ by
    when they add in other orders: n float64 roundings of 2^-53 of the
    summed |contributions| each (`scale`, a float64 histogram of |g*w|,
    |h*w| and w)."""
    return n * 2.0 ** -53 * scale


def phase_hist_f64(seed: int, device) -> dict:
    """(d) of phase 22 and (f) of phase 23: `hist_accumulate`'s float64
    output at each rank's shapes (`F64_SHAPES`) against the f32 output of
    the same launch
    (its rounding bit-equal: the same plan sums in the same order), and
    against the plain version's float64 sums (within `f64_bound`, and
    rounded to f32 bit-equal); both outputs timed by CUDA events."""
    from sml_tpu_torch.native import hist_kernel as hk
    out = {"max_abs_err": 0.0}
    for n, n_slots, n_bins in F64_SHAPES:
        rng = np.random.default_rng([seed, 24, n, n_slots])
        b, lid, g, h, w = hist_operands(rng, n, n_bins, np.uint8, n_slots,
                                        device)
        got = hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                 n_slots=n_slots, out_dtype=torch.float64)
        f32 = hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                 n_slots=n_slots)
        torch.cuda.synchronize()
        if got.dtype != torch.float64 or not torch.equal(
                got.to(torch.float32), f32):
            raise AssertionError(f"hist_accumulate f64 output n={n} "
                                 f"S={n_slots}: its rounding is not the f32 "
                                 f"output")
        want = hk.hist_accumulate_plain(b, lid, g, h, w, n_bins, n_slots,
                                        torch.float64)
        scale = hk.hist_accumulate_plain(b, lid, g.abs(), h.abs(), w,
                                         n_bins, n_slots, torch.float64)
        err = (got - want).abs()
        if not bool((err <= f64_bound(n, scale)).all()):
            raise AssertionError(f"hist_accumulate f64 output n={n} "
                                 f"S={n_slots}: max abs err "
                                 f"{float(err.max())} past the bound")
        if not torch.equal(got.to(torch.float32), want.to(torch.float32)):
            raise AssertionError(f"hist_accumulate f64 output n={n} "
                                 f"S={n_slots}: rounded to f32, it differs "
                                 f"from the plain version's")
        ops = (b, lid, g, h, w)
        t64 = time_hist(ops, n_bins, n_slots, f"hist_accumulate f64 out "
                        f"n={n} S={n_slots}", out_dtype=torch.float64)
        t32 = time_hist(ops, n_bins, n_slots, f"hist_accumulate f32 out "
                        f"n={n} S={n_slots}")
        plan = hk.hist_plan(n, N_FEAT, n_bins, n_slots)
        keys = ("ms", "device_ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")
        out[f"{n}x{n_slots}"] = dict(
            zip(keys, t64), max_abs_err=float(err.max()),
            cells_differing_unrounded=int((err > 0).sum()),
            f32_out=dict(zip(keys, t32)))
        out["max_abs_err"] = max(out["max_abs_err"], float(err.max()))
        print(f"kernel-vs-plain  hist_accumulate  f64 output rows={n} "
              f"F={N_FEAT} bins={n_bins} S={n_slots} {plan} max_abs_err="
              f"{float(err.max()):.3e} (bound n*2^-53*sum|x|), "
              f"cells_differing_unrounded={int((err > 0).sum())}/"
              f"{got.numel()}, rounded bit-equal to its f32 output and to "
              f"the plain version's  ok")
        print(f"times  hist_accumulate f64 output rows={n} S={n_slots}: "
              f"kernel {fmt_ms(t64[0])} ms, device {fmt_ms(t64[1])}, plain "
              f"{fmt_ms(t64[2])}, bound {fmt_ms(t64[3])} ({t64[4]}), "
              f"index_add_ (float64) {fmt_ms(t64[5])}; f32 output: kernel "
              f"{fmt_ms(t32[0])}, device {fmt_ms(t32[1])}, bound "
              f"{fmt_ms(t32[3])}, index_add_ {fmt_ms(t32[5])}")
    return out


#: the ML 07 grid's fused last level: 12 elements x 16 nodes, and a least
#: child weight of 1, 2 or 5 per element
FUSED_NODES = 12 * 16
FUSED_MIN_INST = np.asarray([1.0, 2.0, 5.0] * 4, np.float32)


def pack_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| over a pack: 0 where the two are equal or
    both NaN (the overflow nodes' gains), inf where only one is NaN."""
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    d = torch.where(same, torch.zeros_like(got), (got - want).abs())
    return float(torch.nan_to_num(d, nan=float("inf")).max())


# ------------------------------------------------------------ draw kernels
#: a Poisson count of the kernel may differ from its plain version only
#: at rows whose log-sum came this close to -rate (in f32 ulps)
BOUNDARY_ULPS = 2


class DrawCase(NamedTuple):
    """A fit's whole draws: per element a seed, (mode, rate), row count
    and k; rounds t0 .. trees-1 of rows padded to n_pad, levels of
    n_feat features (depth 0: no masks)."""
    what: str
    seeds: tuple
    modes: tuple
    counts: tuple
    ks: tuple
    n_pad: int
    trees: int
    t0: int
    depth: int
    n_feat: int


#: the main paths' draws, each one launch of each kernel a fit: ML 07's
#: forest (seed 42: 20 rounds of Poisson(1) over 80,000 rows, 6 levels of
#: masks, 3 of 10 features a node), ML 11's XGBoost at subsample 0.8 (40
#: rounds of Bernoulli(0.8), no masks) and the ML 07 grid fused (12
#: elements of the fold counts 53,333 / 53,333 / 53,334, 20 rounds, 5
#: levels)
RF_DRAWS = DrawCase("ML 07 RF", (42,), (("poisson", 1.0),), (80_000,),
                    (3,), 80_000, 20, 0, 6, 10)
SUB_DRAWS = DrawCase("ML 11 subsample 0.8", (42,), (("bernoulli", 0.8),),
                     (80_000,), (10,), 80_000, 40, 0, 0, 10)
FUSED_DRAWS = DrawCase("ML 07 grid fused", (42,) * 12,
                       (("poisson", 1.0),) * 12,
                       (53_333, 53_333, 53_334) * 4, (3,) * 12, 53_334, 20,
                       0, 5, 10)
#: and shapes that reach the kernels' other paths: the same under seeds 0
#: and 17; ML 07's last 4 rounds and last round, and the fused grid's last
#: round (a warm start's few rounds: 2, 1 and 4 rows a thread on an H100,
#: where the fits above take 8); 12 elements of mixed mode, rate, row
#: count and k from a warm start at round 1; odd row counts (1, 37,
#: 100,001) with masks past a warp (F = 400, 33) and of one warp (F = 32)
#: and one feature
DRAW_CASES = (
    RF_DRAWS, RF_DRAWS._replace(what="ML 07 RF seed 0", seeds=(0,)),
    RF_DRAWS._replace(what="ML 07 RF seed 17", seeds=(17,)),
    RF_DRAWS._replace(what="ML 07 RF from round 16", t0=16),
    RF_DRAWS._replace(what="ML 07 RF from round 19", t0=19),
    FUSED_DRAWS._replace(what="ML 07 grid fused from round 19", t0=19),
    SUB_DRAWS, SUB_DRAWS._replace(what="ML 11 subsample seed 17",
                                  seeds=(17,)),
    FUSED_DRAWS,
    DrawCase("12 elements of mixed mode and rate, from round 1",
             tuple(range(12)),
             (("poisson", 1.0), ("bernoulli", 0.7), ("ones", 1.0),
              ("poisson", 0.5), ("bernoulli", 0.3), ("poisson", 0.9)) * 2,
             (53_334, 53_333, 53_334, 53_000, 53_334, 53_333) * 2,
             (3, 10, 1, 5) * 3, 53_334, 4, 1, 5, 10),
    DrawCase("odd rows, F=400, from round 1", (0, 17, 42),
             (("poisson", 1.0), ("bernoulli", 0.7), ("poisson", 0.5)),
             (100_001, 37, 1), (20, 400, 1), 100_001, 3, 1, 6, 400),
    DrawCase("F=33", (5,), (("poisson", 3.5),), (37,), (7,), 37, 3, 0, 4,
             33),
    DrawCase("F=32", (5, 6), (("poisson", 9.5), ("bernoulli", 0.5)),
             (37, 30), (31, 1), 37, 3, 0, 4, 32),
    DrawCase("F=1", (5,), (("bernoulli", 0.5),), (37,), (1,), 37, 2, 0, 3,
             1),
)


def case_draws(case: DrawCase, device, rows: Optional[int] = None):
    """(draws, ks, n_pad) of a case on `device` through the fit's own
    `fit_draws`; `rows` caps the row counts (a rehearsal on the CPU)."""
    from sml_tpu_torch.ml import tree_impl
    from sml_tpu_torch.utils import prng
    n_pad = case.n_pad if rows is None else min(case.n_pad, rows)
    rngs = np.asarray([prng.prng_key(s) for s in case.seeds], np.uint32)
    draws = tree_impl.fit_draws(rngs, case.trees, max(case.depth, 1),
                                [m for m, _ in case.modes],
                                [r for _, r in case.modes],
                                [min(c, n_pad) for c in case.counts], n_pad,
                                device)
    ks = torch.tensor(case.ks, dtype=torch.int32, device=device)
    return draws, ks, n_pad


def near_boundary(key, lam: float, n: int, device) -> torch.Tensor:
    """Rows whose f32 log-sum (the plain version's float64-rounded log)
    came within `BOUNDARY_ULPS` of -lam at some step of Knuth's loop."""
    from sml_tpu_torch.utils import prng
    neg = torch.tensor(-lam, dtype=torch.float32)
    neg_bits = int(neg.view(torch.int32))
    log_prod = torch.zeros(n, dtype=torch.float32, device=device)
    near = torch.zeros(n, dtype=torch.bool, device=device)
    rng = key
    while bool((log_prod > neg.to(device)).any()):
        rng, sub = prng.split(rng)
        log_prod = log_prod + prng.log_f32(prng.uniform(sub, n, device))
        gap = (log_prod.view(torch.int32).to(torch.int64) - neg_bits).abs()
        near |= (log_prod < 0) & (gap <= BOUNDARY_ULPS)
    return near


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def phase_draw_kernels(device, rows: Optional[int] = None) -> dict:
    """Each case of `DRAW_CASES` drawn whole, one `fit_row_weights` and
    one `fit_feature_masks` launch, against the plain versions round by
    round and level by level: Bernoulli weights, ones and masks bit-equal,
    a Poisson count differing only within `BOUNDARY_ULPS` of -rate, every
    node holding k candidates. `rows` caps the row counts (on the CPU the
    wrappers run the plain versions: a rehearsal). Returns the largest
    absolute differences seen."""
    from sml_tpu_torch.native import prng_kernel as pk
    saved = dict(pk.LAUNCHES)
    worst = {"row_weights": 0.0, "feature_mask": 0.0}
    # the card's SMs (an H100's 132 where the CPU rehearses)
    sms = pk._sm_count(device) if device.type == "cuda" else 132
    rows_a_thread = set()
    for case in DRAW_CASES:
        draws, ks, n_pad = case_draws(case, device, rows)
        E, R = len(case.seeds), case.trees - case.t0
        keys = draws.keys[case.t0:, 0]
        plan = pk.draw_plan(n_pad, R * E, sms)
        rows_a_thread.add(plan.rows)
        got = pk.fit_row_weights(keys, draws.modes, draws.rates,
                                 draws.counts, n_pad)
        _sync(device)
        want = pk.fit_row_weights_plain(keys, draws.modes, draws.rates,
                                        draws.counts, n_pad)
        off = (got != want).view(R, E, n_pad)
        for r in range(R):
            for e, (mode, rate) in enumerate(case.modes):
                if mode == "poisson" and bool(off[r, e].any()):
                    off[r, e] &= ~near_boundary(tuple(keys[r, e].tolist()),
                                                rate, n_pad, device)
                if bool(off[r, e].any()):
                    raise AssertionError(
                        f"row_weights {case.what} round {case.t0 + r} "
                        f"element {e} ({mode}): {int(off[r, e].sum())} rows "
                        f"differ away from the log boundary")
        worst["row_weights"] = max(worst["row_weights"],
                                   float((got - want).abs().max()))
        line = (f"kernel-vs-plain  {case.what}: row_weights {R} rounds x "
                f"{E} x {n_pad} rows in one launch {plan}: "
                f"rows differing {int((got != want).sum())} (within "
                f"{BOUNDARY_ULPS} ulps of -rate)")
        if case.depth:
            mkeys = draws.keys[case.t0:, 1:1 + case.depth]
            got = pk.fit_feature_masks(mkeys, ks, case.n_feat)
            _sync(device)
            want = pk.fit_feature_masks_plain(mkeys, ks, case.n_feat)
            if not torch.equal(got, want):
                raise AssertionError(f"feature_mask {case.what}: "
                                     f"{int((got != want).sum())} cells "
                                     f"differ")
            per_node = torch.cat([ks.repeat_interleave(2 ** level)
                                  for level in range(case.depth)])
            if not bool((got.sum(2) == per_node.clamp(
                    max=case.n_feat)).all()):
                raise AssertionError(f"feature_mask {case.what}: not k a "
                                     f"node")
            nodes = R * E * (2 ** case.depth - 1)
            line += (f"; feature_mask {R} x {E} x {2 ** case.depth - 1} "
                     f"nodes x F={case.n_feat} in one launch "
                     f"{pk.mask_plan(nodes, case.n_feat)}: bit-equal")
        print(line + "  ok")
    if rows is None and rows_a_thread != set(pk._DRAW_ROWS):
        raise AssertionError(f"the draw cases reach rows a thread "
                             f"{sorted(rows_a_thread)}, not each of the "
                             f"kernel's {sorted(pk._DRAW_ROWS)}")
    pk.LAUNCHES.update(saved)  # checks are not the main path's launches
    return worst


def _rmse(pred, label) -> float:
    d = np.asarray(pred, np.float64) - np.asarray(label, np.float64)
    return float(np.sqrt(np.mean(d * d)))


#: the fit's kernel wrappers (each with its `_plain` version) and the
#: kernel each launches, by module
FIT_WRAPPERS = {"hist_kernel": (("hist_accumulate", "hist_accumulate"),
                                ("split_scan", "split_scan")),
                "prng_kernel": (("fit_row_weights", "row_weights"),
                                ("fit_feature_masks", "feature_mask"))}


def _on_cuda(args) -> bool:
    """Whether a call's arguments name the card: a CUDA tensor, or (for
    the draw kernels, whose operands are shapes) a CUDA device."""
    return any((isinstance(a, torch.Tensor) and a.is_cuda)
               or (isinstance(a, torch.device) and a.type == "cuda")
               for a in args)


class KernelWatch:
    """Counts the plain versions' calls on the card (the fit kernels' and
    the traversal's) while it is installed, and optionally times every
    fit wrapper call with CUDA events."""

    def __init__(self, timed: bool = False):
        from sml_tpu_torch.native import hist_kernel, prng_kernel
        self.modules = {"hist_kernel": hist_kernel,
                        "prng_kernel": prng_kernel}
        self.timed = timed
        self.plain_on_cuda = 0
        self.lock = threading.Lock()
        self.events = {kernel: [] for pairs in FIT_WRAPPERS.values()
                       for _, kernel in pairs}
        self.saved = []

    def _patch(self, mod, name, fn):
        self.saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, fn)

    def __enter__(self):
        def watch(mod, name):
            def watched(*args, _fn=getattr(mod, name), **kw):
                if _on_cuda(list(args) + list(kw.values())):
                    with self.lock:  # trials call it from threads
                        self.plain_on_cuda += 1
                return _fn(*args, **kw)
            self._patch(mod, name, watched)

        from sml_tpu_torch.native import traverse_kernel
        watch(traverse_kernel, "forest_margin_plain")
        for modname, pairs in FIT_WRAPPERS.items():
            mod = self.modules[modname]
            for name, kernel in pairs:
                watch(mod, f"{name}_plain")
                if not self.timed:
                    continue

                def timed_call(*args, _fn=getattr(mod, name), _name=kernel,
                               **kw):
                    a = torch.cuda.Event(enable_timing=True)
                    b = torch.cuda.Event(enable_timing=True)
                    a.record()
                    out = _fn(*args, **kw)
                    b.record()
                    with self.lock:
                        self.events[_name].append((a, b))
                    return out
                self._patch(mod, name, timed_call)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in reversed(self.saved):
            setattr(mod, name, fn)

    def kernel_ms(self) -> dict:
        torch.cuda.synchronize()
        return {k: sum(a.elapsed_time(b) for a, b in v)
                for k, v in self.events.items()}


def _fit_xgb(X, logy, cats, device):
    """The ML 11 fit of the course: XGBoost on log price."""
    from sml_tpu_torch.xgboost import XgboostRegressor
    return XgboostRegressor(n_estimators=40, learning_rate=0.15, max_depth=6,
                            max_bins=64, random_state=42).fit(
        X, logy, categorical=cats, device=device)


def _fit_dt(X, logy, cats, device):
    """The ML 06 fit of the course: a decision tree on price."""
    from sml_tpu_torch.ml._tree_models import DecisionTreeRegressor
    return DecisionTreeRegressor(maxDepth=5, maxBins=40).fit(
        X, np.exp(logy), categorical=cats, device=device)


def _fit_rf(X, logy, cats, device):
    """The ML 07 fit of the course: a random forest on price (20 trees,
    depth 6, 40 bins, seed 42; `auto` features: a third a node)."""
    from sml_tpu_torch.ml._tree_models import RandomForestRegressor
    return RandomForestRegressor(numTrees=20, maxDepth=6, maxBins=40,
                                 seed=42).fit(
        X, np.exp(logy), categorical=cats, device=device)


def _fit_xgb_sub(X, logy, cats, device):
    """ML 11's XGBoost with a row subsample of 0.8 a round."""
    from sml_tpu_torch.xgboost import XgboostRegressor
    return XgboostRegressor(n_estimators=40, learning_rate=0.15, max_depth=6,
                            max_bins=64, random_state=42, subsample=0.8).fit(
        X, logy, categorical=cats, device=device)


#: the fits of the main path: estimator, whether it fits log price, and
#: the launches of each kernel it must make (hist_accumulate and
#: split_scan a level; row_weights once a sampled fit; feature_mask once
#: a forest fit)
FITS = {
    "xgb": (_fit_xgb, True, {"hist_accumulate": 240, "split_scan": 240,
                             "row_weights": 0, "feature_mask": 0}),
    "dt": (_fit_dt, False, {"hist_accumulate": 5, "split_scan": 5,
                            "row_weights": 0, "feature_mask": 0}),
    "rf": (_fit_rf, False, {"hist_accumulate": 120, "split_scan": 120,
                            "row_weights": 1, "feature_mask": 1}),
    "xgb_sub": (_fit_xgb_sub, True, {"hist_accumulate": 240,
                                     "split_scan": 240, "row_weights": 1,
                                     "feature_mask": 0}),
}


def _held_out(models: dict, X, logy, device) -> dict:
    """Held-out rmse of each model on price, through the scorer."""
    from sml_tpu_torch.ml.inference import DeviceScorer
    price = np.exp(logy)
    out = {}
    for name, model in models.items():
        pred = DeviceScorer(model, device=device).score_block(X)
        out[name] = _rmse(np.exp(pred) if FITS[name][1] else pred, price)
    return out


def _launch_counts() -> tuple:
    """The launch counts of the fit's wrappers and of the draw wrappers
    (each a dict by kernel)."""
    from sml_tpu_torch.native import hist_kernel as hk
    from sml_tpu_torch.native import prng_kernel as pk
    return hk.LAUNCHES, pk.LAUNCHES


def _fit_launches() -> dict:
    """Every fit kernel's launch count, in one dict."""
    hist, draw = _launch_counts()
    return dict(hist, **draw)


def fit_rows(seed: int):
    """The fit phases' 100,000 seeded ML 11-shaped rows, their log-price
    labels and the categorical map."""
    cats = {0: 36, 1: 3, 2: 20}
    rng = np.random.default_rng([seed, 31])
    X, _ = ml11_rows(rng, 100_000, cats)
    return X, fit_labels(rng, X), cats


def phase_fit(seed: int, device) -> dict:
    """The fit slice's main path through the estimators (`FITS`), with
    every kernel's launches counted; the course orderings; and agreement
    of the card with the CPU at 16,000 rows."""
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.utils.profiler import PROFILER
    X, logy, cats = fit_rows(seed)
    Xtr, ytr, Xte, yte = X[:80_000], logy[:80_000], X[80_000:], logy[80_000:]

    launches, walls, models = {}, {}, {}
    with KernelWatch() as watch:
        tk.LAUNCHES = 0
        PROFILER.reset()
        for name, (fit, _, _) in FITS.items():
            for counts in _launch_counts():
                for k in counts:
                    counts[k] = 0
            t0 = time.perf_counter()
            models[name] = fit(Xtr, ytr, cats, None)
            walls[name] = time.perf_counter() - t0
            launches[name] = _fit_launches()
        rmse = _held_out(models, Xte, yte, None)
        traverse = tk.LAUNCHES
    dispatches = PROFILER.counters().get("tree.fit_dispatch", 0.0)
    base = _rmse(np.full(len(yte), np.exp(ytr).mean()), np.exp(yte))
    for name, (_, _, want) in FITS.items():
        print(f"main-path fit  {type(models[name]).__name__} ({name}) "
              f"80000 rows: {walls[name] * 1e3!r} ms, launches "
              f"{launches[name]} (host clock, first fits: binning, staging "
              f"and copies included)")
        if launches[name] != want:
            raise AssertionError(f"{name} fit launched {launches[name]}, "
                                 f"not {want}")
    print(f"main-path fit  tree.fit_dispatch={dispatches!r}; "
          f"forest_traverse launches={traverse}")
    print(f"main-path fit  held-out rmse (price, 20000 rows): "
          + ", ".join(f"{k}={v!r}" for k, v in rmse.items())
          + f", mean-label baseline={base!r}")
    if watch.plain_on_cuda:
        raise AssertionError(f"the plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    if dispatches != len(FITS) or traverse <= 0:
        raise AssertionError(f"{dispatches} fit dispatches, {traverse} "
                             f"traversal launches")
    trees = {k: m.getNumTrees() for k, m in models.items()}
    if trees != {"xgb": 40, "dt": 1, "rf": 20, "xgb_sub": 40}:
        raise AssertionError(f"wrong tree counts {trees}")
    # ML 11: boosting beats the tree; ML 07: the forest beats the tree
    if not (rmse["xgb"] < rmse["dt"] < base and rmse["rf"] < rmse["dt"]
            and rmse["xgb_sub"] < rmse["dt"]):
        raise AssertionError(f"course ordering broken: {rmse}, baseline "
                             f"{base}")

    # the same fits on 16,000 rows, on the card and with the plain
    # versions on the CPU
    small = slice(0, 16_000)
    card = {k: f(Xtr[small], ytr[small], cats, None)
            for k, (f, _, _) in FITS.items()}
    host = {k: f(Xtr[small], ytr[small], cats, "cpu")
            for k, (f, _, _) in FITS.items()}
    r_card = _held_out(card, Xte, yte, None)
    r_host = _held_out(host, Xte, yte, "cpu")
    for k in FITS:
        same = sum(np.array_equal(a.split_feature, b.split_feature)
                   and np.array_equal(a.split_bin, b.split_bin)
                   for a, b in zip(card[k]._spec.trees, host[k]._spec.trees))
        print(f"fit card-vs-cpu 16000 rows {k}: rmse {r_card[k]!r} vs "
              f"{r_host[k]!r}; {same} of {card[k].getNumTrees()} trees with "
              f"identical split tables")
        if abs(r_card[k] - r_host[k]) > max(RMSE_ATOL,
                                            RMSE_RTOL * abs(r_host[k])):
            raise AssertionError(f"{k}: card rmse {r_card[k]} vs cpu rmse "
                                 f"{r_host[k]}")
    return {"launches": {k: sum(launches[m][k] for m in FITS)
                         for k in launches["xgb"]}, "xgb": models["xgb"],
            "rf": models["rf"], "walls": walls}


def hist_bound_ms(binned, weight, n_bins: int, n_slots: int,
                  out_bytes: int = 4):
    """(ms, by): the bytes `hist_accumulate` must move (bins, slot ids
    and three f32 per row read once; the (F*B, S*3) histogram of
    `out_bytes` a cell written once) over HBM bandwidth, against its
    operations (per row with w > 0: two products and 3 adds for each of
    its F cells) over the f64 rate (`bound_of`): the sums run in
    float64."""
    n, n_feat = binned.shape
    nbytes = n * (n_feat * binned.element_size() + 16) \
        + n_feat * n_bins * n_slots * 3 * out_bytes
    return bound_of(nbytes,
                    f64_ops=int((weight > 0).sum()) * (2 + 3 * n_feat))


def scan_bound_ms(hist):
    """(ms, by): the (F, B, W, 3) histogram, the (W, F) mask and the
    scalar read once and the (6, W) pack written once, against ~16 f32
    operations per (node, feature, bin) candidate (3 prefix adds, 2
    squares, 2 divisions, 7 adds and subtractions, 2 compares)."""
    n_feat, n_bins, width = hist.shape[:3]
    nbytes = hist.numel() * 4 + width * n_feat * 4 + 4 + 6 * width * 4
    return bound_of(nbytes, f32_flops=16 * n_feat * n_bins * width)


#: ML 11's tree levels: slots histogrammed (with subtraction) and nodes
#: scanned at each of its 6 levels, and its 40 trees
FIT_LEVEL_SLOTS = (1, 1, 2, 4, 8, 16)
FIT_LEVEL_NODES = (1, 2, 4, 8, 16, 32)
FIT_TREES = 40
#: the kernels each wrapper launches, by name in the profiler
HIST_KERNELS = ("hist_cluster_kernel", "hist_reduce_kernel")
SCAN_KERNELS = ("split_scan_kernel",)


def hist_launches(n: int, n_bins: int, n_slots: int, **kw) -> int:
    """Kernels one `hist_accumulate` call launches: the cluster pass, and
    the pass over the clusters' partials when there is more than one."""
    from sml_tpu_torch.native import hist_kernel as hk
    p = hk.hist_plan(n, N_FEAT, n_bins, n_slots, **kw)
    return 1 + int(p.n_chunks // p.cluster > 1)


def hist_f32acc_launcher():
    """A call of the f32-accumulating build of the `hist_accumulate`
    kernel (entry point `sml_hist_accumulate_f32acc` of the same source),
    launched as the port's wrapper launches the float64 one, with its own
    plan: 12-byte cells, so a tile holds up to twice the features. The
    port never calls it; it is timed beside the float64 kernel to price
    the float64 sums."""
    import ctypes
    from sml_tpu_torch.native import build
    from sml_tpu_torch.native import hist_kernel as hk
    fn = build.load("hist_accumulate").sml_hist_accumulate_f32acc
    fn.argtypes = hk.HIST_ARGTYPES
    fn.restype = ctypes.c_int

    def launch(binned, lid, grad, hess, weight, n_bins, n_slots):
        n, n_feat = binned.shape
        plan = hk.hist_plan(n, n_feat, n_bins, n_slots,
                            bin_bytes=binned.element_size(), acc_bytes=4)
        return hk.launch_hist(fn, plan, binned, lid, grad, hess, weight,
                              n_bins, n_slots, torch.float32)
    return launch


def wrapper_host_us(device) -> dict:
    """Median host time of one call of each fit wrapper, in microseconds
    (`host_us`): `hist_accumulate` at ML 11, S=16, and `split_scan` at
    ML 11, W=32. The launch counts are restored after."""
    from sml_tpu_torch.native import hist_kernel as hk
    saved = dict(hk.LAUNCHES)
    rng = np.random.default_rng([0, 43])
    b, lid, g, h, w = hist_operands(rng, 80_000, 64, np.uint8, 16, device)
    hist = torch.rand((N_FEAT, 64, 32, 3), device=device)
    fmask = torch.ones((32, N_FEAT), device=device)
    mi = torch.ones(32, device=device)
    out = {"hist_accumulate": host_us(lambda: hk.hist_accumulate(
               b, lid, g, h, w, n_bins=64, n_slots=16)),
           "split_scan": host_us(lambda: hk.split_scan(
               hist, fmask, mi, reg_lambda=1.0, gamma=0.0))}
    hk.LAUNCHES.update(saved)
    return out


def time_hist(ops, n_bins: int, n_slots: int, what: str, reps: int = 50,
              out_dtype=torch.float32):
    """(kernel ms, device ms, plain ms, bound ms, bound by, index_add_ ms)
    of one `hist_accumulate` call on `ops` (binned, lid, grad, hess,
    weight) with an `out_dtype` output; the library yardstick is one
    `index_add_` of the (row, feature) contributions on precomputed flat
    cell indices into an `out_dtype` histogram."""
    from sml_tpu_torch.native import hist_kernel as hk
    b, lid, g, h, w = ops
    n = b.shape[0]

    def call():
        return hk.hist_accumulate(b, lid, g, h, w, n_bins=n_bins,
                                  n_slots=n_slots, out_dtype=out_dtype)
    k_ms = time_ms(call, reps)
    d_ms = device_ms(call, reps, HIST_KERNELS,
                     hist_launches(n, n_bins, n_slots), what)
    p_ms = time_ms(lambda: hk.hist_accumulate_plain(
        b, lid, g, h, w, n_bins, n_slots, out_dtype), 5)
    ok = (w > 0)[:, None].expand(-1, N_FEAT)
    cell = ((torch.arange(N_FEAT, device=b.device)[None, :] * n_bins
             + b.to(torch.int64)) * n_slots + lid.to(torch.int64)[:, None])
    src = torch.stack([g * w, h * w, w], 1)[:, None, :] \
        .expand(-1, N_FEAT, 3)[ok].to(out_dtype).contiguous()
    idx = cell[ok].contiguous()
    acc = torch.zeros((N_FEAT * n_bins * n_slots, 3), dtype=out_dtype,
                      device=b.device)
    l_ms = time_ms(lambda: acc.index_add_(0, idx, src), reps)
    return (k_ms, d_ms, p_ms,
            *hist_bound_ms(b, w, n_bins, n_slots,
                           torch.finfo(out_dtype).bits // 8), l_ms)


def time_scan(hist, mi, what: str):
    """(kernel ms, device ms, plain ms, bound ms, bound by, None) of one
    `split_scan` call on `hist` with every feature a candidate and the
    per-node least child weights `mi`."""
    from sml_tpu_torch.native import hist_kernel as hk
    fmask = torch.ones((hist.shape[2], N_FEAT), device=hist.device)

    def scan():
        return hk.split_scan(hist, fmask, mi, reg_lambda=1.0, gamma=0.0)
    k_ms = time_ms(scan, 50)
    d_ms = device_ms(scan, 50, SCAN_KERNELS, what=what)
    p_ms = time_ms(lambda: hk.split_scan_plain(hist, fmask, mi, 1.0, 0.0),
                   5)
    return (k_ms, d_ms, p_ms, *scan_bound_ms(hist), None)


def phase_fit_times(seed: int, device, card: str) -> dict:
    """Kernel, plain, bound and library times of the fit kernels at every
    shape the ML 11 fit launches them at (`hist_accumulate` at 1-16
    slots, and 32; `split_scan` at 1-32 nodes) and at the last level of
    the ML 07 grid fused (640,008 rows, 96 slots; 192 nodes); the
    per-fit kernel device time these give; the wrappers' host time per
    call. Beside the float64
    `hist_accumulate` at S=16 and 32, times its f32-accumulating build and
    counts the cells where each differs from the plain version on the CPU
    (what a CPU fit computes). Returns the numbers of the kernels line."""
    from sml_tpu_torch.native import hist_kernel as hk
    saved = dict(hk.LAUNCHES)
    f32acc = hist_f32acc_launcher()
    out = {}
    for n_slots in (1, 2, 4, 8, 16, 32):
        rng = np.random.default_rng([seed, 41, n_slots])
        b, lid, g, h, w = hist_operands(rng, 80_000, 64, np.uint8, n_slots,
                                        device)
        k_ms, d_ms, p_ms, b_ms, b_by, l_ms = out[
            ("hist_accumulate", n_slots)] = time_hist(
                (b, lid, g, h, w), 64, n_slots, f"hist_accumulate S={n_slots}")
        print(f"time  hist_accumulate  ML 11 80000 rows F=10 B=64 uint8 "
              f"S={n_slots} {hk.hist_plan(80_000, N_FEAT, 64, n_slots)}: "
              f"kernel {k_ms!r} ms (device {fmt_ms(d_ms)} ms), plain "
              f"{p_ms!r} ms, index_add_ {l_ms!r} ms, bound {b_ms!r} ms "
              f"({b_by}); card {card}")

        def call():
            return hk.hist_accumulate(b, lid, g, h, w, n_bins=64,
                                      n_slots=n_slots)
        if n_slots < 16:
            continue
        f_ms = time_ms(lambda: f32acc(b, lid, g, h, w, 64, n_slots), 50)
        fd_ms = device_ms(lambda: f32acc(b, lid, g, h, w, 64, n_slots), 50,
                          HIST_KERNELS, hist_launches(80_000, 64, n_slots,
                                                      acc_bytes=4),
                          f"hist_accumulate f32-accumulating S={n_slots}")
        cpu = hk.hist_accumulate_plain(b.cpu(), lid.cpu(), g.cpu(), h.cpu(),
                                       w.cpu(), 64, n_slots)
        got64 = call().cpu()
        got32 = f32acc(b, lid, g, h, w, 64, n_slots).cpu()
        scale = hk.hist_accumulate_plain(b.cpu(), lid.cpu(), g.cpu().abs(),
                                         h.cpu().abs(), w.cpu(), 64, n_slots)
        if not bool(((got32 - cpu).abs() <= HIST_RTOL * scale + 1e-30)
                    .all()):
            raise AssertionError(f"f32-accumulating hist_accumulate S="
                                 f"{n_slots} disagrees with the plain "
                                 f"version")
        d64, d32 = int((got64 != cpu).sum()), int((got32 != cpu).sum())
        print(f"time  hist_accumulate f32-accumulating build  ML 11 80000 "
              f"rows S={n_slots} "
              f"{hk.hist_plan(80_000, N_FEAT, 64, n_slots, acc_bytes=4)}: "
              f"kernel {f_ms!r} ms (device {fmt_ms(fd_ms)} ms) against "
              f"float64 {k_ms!r} ms (device {fmt_ms(d_ms)} ms); cells "
              f"differing from the CPU plain version: float64 {d64}, f32 "
              f"{d32} of {cpu.numel()}; card {card}")
        out[("hist_f32acc", n_slots)] = (f_ms, fd_ms, d64, d32)
    for width in FIT_LEVEL_NODES:
        rng = np.random.default_rng([seed, 42, width])
        hist = torch.from_numpy(rng.normal(
            size=(N_FEAT, 64, width, 3)).astype(np.float32)).to(device)
        hist[..., 1:] = hist[..., 1:].abs()
        k_ms, d_ms, p_ms, b_ms, b_by, _ = out[("split_scan", width)] = \
            time_scan(hist, torch.ones(width, device=device),
                      f"split_scan W={width}")
        print(f"time  split_scan  ML 11 F=10 B=64 W={width} "
              f"{hk.scan_plan(N_FEAT, 64)}: kernel {k_ms!r} ms (device "
              f"{fmt_ms(d_ms)} ms), plain {p_ms!r} ms, bound {b_ms!r} ms "
              f"({b_by}); card {card}")
    # the ML 07 grid's fused shapes: a last level's histogram of 12
    # elements end to end, and its scan over 12 x 16 nodes
    rng = np.random.default_rng([seed, 44])
    ops = hist_operands(rng, 640_008, 40, np.uint8, 96, device)
    k_ms, d_ms, p_ms, b_ms, b_by, l_ms = out[("hist_accumulate", "fused")] \
        = time_hist(ops, 40, 96, "hist_accumulate fused S=96", reps=20)
    print(f"time  hist_accumulate  ML 07 grid fused 640008 rows F=10 B=40 "
          f"uint8 S=96 {hk.hist_plan(640_008, N_FEAT, 40, 96)}: kernel "
          f"{k_ms!r} ms (device {fmt_ms(d_ms)} ms), plain {p_ms!r} ms, "
          f"index_add_ {l_ms!r} ms, bound {b_ms!r} ms ({b_by}); card {card}")
    hist = torch.from_numpy(rng.normal(
        size=(N_FEAT, 40, FUSED_NODES, 3)).astype(np.float32)).to(device)
    hist[..., 1:] = hist[..., 1:].abs()
    mi = torch.from_numpy(np.repeat(FUSED_MIN_INST, 16)).to(device)
    k_ms, d_ms, p_ms, b_ms, b_by, _ = out[("split_scan", "fused")] = \
        time_scan(hist, mi, f"split_scan fused W={FUSED_NODES}")
    print(f"time  split_scan  ML 07 grid fused F=10 B=40 W={FUSED_NODES} "
          f"{hk.scan_plan(N_FEAT, 40)}: kernel {k_ms!r} ms (device "
          f"{fmt_ms(d_ms)} ms), plain {p_ms!r} ms, bound {b_ms!r} ms "
          f"({b_by}); card {card}")
    per_fit = {}
    for name, levels in (("hist_accumulate", FIT_LEVEL_SLOTS),
                         ("split_scan", FIT_LEVEL_NODES)):
        ds = [out[(name, k)][1] for k in levels]
        per_fit[name] = None if None in ds else FIT_TREES * sum(ds)
    out["per_fit"] = per_fit
    print(f"time  per-fit kernel device time, ML 11 (40 trees x levels at "
          f"S={FIT_LEVEL_SLOTS} and W={FIT_LEVEL_NODES}, named-kernel "
          f"profiler time at each shape): hist_accumulate "
          f"{fmt_ms(per_fit['hist_accumulate'])} ms, split_scan "
          f"{fmt_ms(per_fit['split_scan'])} ms; card {card}")
    hk.LAUNCHES.update(saved)  # timing launches are not the main path's
    host = wrapper_host_us(device)
    out["host_us"] = host
    print(f"time  wrapper host time per call (perf_counter median, no "
          f"synchronise): hist_accumulate ML 11 S=16 "
          f"{host['hist_accumulate']!r} us, split_scan ML 11 W=32 "
          f"{host['split_scan']!r} us; card {card}")
    return out


#: integer instructions of one Threefry-2x32 hash (the key schedule's two
#: XORs; 2 + 15 adds of key injections; 20 rounds of an add, a rotate and
#: an XOR) and of an f32 uniform from it (an XOR of the two words, a
#: shift, an OR; then one f32 subtraction)
HASH_INT_OPS = 79
UNIFORM_INT_OPS = HASH_INT_OPS + 3
#: f64 instructions of a Poisson step's log: the conversion in, `log` in
#: float64 (libdevice: a reduction of the exponent, a reciprocal and a
#: polynomial in fused multiply-adds, about 20 on the path every row
#: takes) and the rounding out
LOG_F64_OPS = 22


def draw_bound_ms(weights: torch.Tensor, counts, mode: str):
    """(ms, by) of `fit_row_weights` on these draws ((R, E * n_pad)
    weights, each element's row count): 4 bytes a row written and a key
    pair a (round, element) read; a Bernoulli row a uniform and a
    compare; a Poisson row count + 1 steps, each a uniform, an f64 log
    and an f32 add and compare, and each (round, element)'s key chain,
    two hashes a step up to its longest row, once. Integer and f64 work at
    the card's rates (`bound_of`)."""
    R, n = weights.shape
    E = len(counts)
    w = weights.view(R, E, n // E)
    valid = torch.arange(n // E, device=w.device)[None, None, :] \
        < torch.as_tensor(counts, device=w.device)[None, :, None]
    nbytes = 4 * R * n + 8 * R * E + 12 * E
    if mode == "bernoulli":
        rows = int(valid.sum()) * R
        return bound_of(nbytes, int_ops=rows * UNIFORM_INT_OPS,
                        f32_flops=2 * rows)
    steps = torch.where(valid, w.to(torch.int64) + 1, 0)
    total = int(steps.sum())
    chain = int(steps.amax(dim=2).sum())
    return bound_of(nbytes,
                    int_ops=total * UNIFORM_INT_OPS + 2 * HASH_INT_OPS * chain,
                    f32_flops=3 * total, f64_ops=total * LOG_F64_OPS)


def poisson_hashes(weights: torch.Tensor, counts, plan) -> tuple:
    """(lane hashes the kernel's warps issue, hashes the rows need) of a
    Poisson draw ((R, E * n_pad) weights) under a launch plan: a row
    needs count + 1 uniforms and its (round, element) two chain hashes a
    step up to its longest row, once; a warp (32 threads, each over
    `plan.rows` rows strided by the block's width) issues for 32 lanes at
    every step the two chain hashes and each row slot's uniform while any
    lane's row in that slot still counts."""
    R, n = weights.shape
    E = len(counts)
    n_pad = n // E
    valid = torch.arange(n_pad, device=weights.device)[None, None, :] \
        < torch.as_tensor(counts, device=weights.device)[None, :, None]
    steps = torch.where(valid, weights.view(R, E, n_pad).to(torch.int64)
                        + 1, 0).view(R * E, n_pad)
    padded = plan.blocks * plan.threads * plan.rows
    steps = torch.nn.functional.pad(steps, (0, padded - n_pad))
    slot = steps.view(R * E, plan.blocks, plan.rows, plan.threads // 32,
                      32).amax(dim=4)
    issued = 32 * (int(slot.sum()) + 2 * int(slot.amax(dim=2).sum()))
    return issued, int(steps.sum()) + 2 * int(steps.amax(dim=1).sum())


def mask_bound_ms(nodes: int, n_feat: int, n_keys: int):
    """(ms, by) of `fit_feature_masks` over `nodes` nodes of F features:
    the f32 mask written and the level keys read, against a uniform a
    cell and what selecting a node's k smallest of F values needs at the
    least: a linear-time selection, about one compare a cell, and a
    cell's compare with the k-th value (f32 compares). The kernel ranks
    by counting, F compares a cell; that is its own choice."""
    cells = nodes * n_feat
    return bound_of(4 * cells + 8 * n_keys, int_ops=cells * UNIFORM_INT_OPS,
                    f32_flops=3 * cells)


def device_median_ms(fn, names, what: str, reps: int = 100,
                     windows: int = 3):
    """The median over `windows` profiler windows of `reps` calls of the
    kernel's device time a call (`device_ms`, the mean over the launches
    a window saw), or None where no window was measured."""
    got = [device_ms(fn, reps, names, what=f"{what} window {i}")
           for i in range(windows)]
    got = [g for g in got if g is not None]
    return float(np.median(got)) if got else None


def once_ms(fn) -> float:
    """One call's device time by CUDA events, after one call to warm up
    (the plain versions: seconds a call at the fits' shapes)."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b)


def phase_draw_times(device, card: str) -> dict:
    """Kernel (CUDA-event median of a launch, and the median over
    profiler windows of its device time), plain and bound of the whole-fit
    draws at the main paths' shapes (`RF_DRAWS`, `SUB_DRAWS`,
    `FUSED_DRAWS`), and of one round of each: `fit_row_weights` at the
    rows a thread `draw_plan` picks there (8 over these fits, 1 or 4 over
    one round: the two sides of its choice) and `fit_feature_masks`; the
    wrappers' host time per call. Returns the numbers of the kernels
    line."""
    from sml_tpu_torch.native import prng_kernel as pk
    saved = dict(pk.LAUNCHES)
    rates = card_rates()
    print(f"time  card rates: {rates['sms']} SMs at {rates['sm_mhz']!r} MHz "
          f"(max SM clock): INT32 {rates['int32']!r} ops/s, f64 "
          f"{rates['f64']!r} ops/s, f32 {F32_FLOPS_PER_S!r} flops/s; card "
          f"{card}")
    out = {}
    for case in (RF_DRAWS, SUB_DRAWS, FUSED_DRAWS):
        draws, ks, n_pad = case_draws(case, device)
        mode, rate = case.modes[0]
        E = len(case.seeds)
        for start in (case.t0, case.trees - 1):   # every round, and one
            R = case.trees - start
            keys = draws.keys[start:, 0]
            label = f"{case.what}: {R} x {E} x {n_pad} rows"
            plan = pk.draw_plan(n_pad, R * E, rates["sms"])

            def weights(keys=keys):
                return pk.fit_row_weights(keys, draws.modes, draws.rates,
                                          draws.counts, n_pad)

            def plain(keys=keys):
                return pk.fit_row_weights_plain(keys, draws.modes,
                                                draws.rates, draws.counts,
                                                n_pad)
            bound = draw_bound_ms(weights(), case.counts, mode)
            p_ms = once_ms(plain)
            k_ms = time_ms(weights, 100)
            d_ms = device_median_ms(weights, ("row_weights_kernel",),
                                    f"row_weights {label}")
            out[("row_weights", case.what, R)] = (k_ms, d_ms, p_ms, *bound,
                                                  plan.rows)
            issue = ""
            if mode == "poisson":
                issued, needed = poisson_hashes(weights(), case.counts, plan)
                issue = (f"; the warps issue {issued} lane hashes where the "
                         f"rows need {needed} ({issued / needed!r}x)")
            print(f"time  row_weights  {label}, {mode} {rate}, {plan}: "
                  f"kernel {k_ms!r} ms (device {fmt_ms(d_ms)} ms), plain "
                  f"{p_ms!r} ms, bound {bound[0]!r} ms ({bound[1]}){issue}; "
                  f"card {card}")
            if case is RF_DRAWS and R > 1:
                out["host_us"] = {"row_weights": host_us(weights)}
            if not case.depth:
                continue
            mkeys = draws.keys[start:, 1:1 + case.depth]
            nodes = R * E * (2 ** case.depth - 1)

            def masks(mkeys=mkeys):
                return pk.fit_feature_masks(mkeys, ks, case.n_feat)
            k_ms = time_ms(masks, 100)
            d_ms = device_median_ms(masks, ("feature_mask_kernel",),
                                    f"feature_mask {label}")
            p_ms = once_ms(lambda: pk.fit_feature_masks_plain(
                mkeys, ks, case.n_feat))
            b_ms, b_by = mask_bound_ms(nodes, case.n_feat,
                                       R * case.depth * E)
            out[("feature_mask", case.what, R)] = (k_ms, d_ms, p_ms, b_ms,
                                                   b_by)
            print(f"time  feature_mask  {case.what}: {R} rounds, {nodes} "
                  f"nodes x F={case.n_feat} "
                  f"{pk.mask_plan(nodes, case.n_feat)}: kernel {k_ms!r} ms "
                  f"(device {fmt_ms(d_ms)} ms), plain {p_ms!r} ms, bound "
                  f"{b_ms!r} ms ({b_by}); card {card}")
            if case is RF_DRAWS and R > 1:
                out["host_us"]["feature_mask"] = host_us(masks)
    # the one-level shapes the earlier builds' mask kernel drew a launch
    for what, nodes, n_keys in (("ML 07 last level, W=32", 32, 1),
                                ("ML 07 grid fused last level, 12 x W=16",
                                 192, 12)):
        b_ms, b_by = mask_bound_ms(nodes, N_FEAT, n_keys)
        print(f"time  feature_mask  bound of one level ({what}, F="
              f"{N_FEAT}): {b_ms!r} ms ({b_by}); card {card}")
    print(f"time  wrapper host time per call (perf_counter median, no "
          f"synchronise): fit_row_weights {RF_DRAWS.what} "
          f"{out['host_us']['row_weights']!r} us, fit_feature_masks "
          f"{out['host_us']['feature_mask']!r} us; card {card}")
    pk.LAUNCHES.update(saved)  # timing launches are not the main path's
    return out


def profile_busy(run, span: str):
    """(device ms by kernel name, wall ms of the port's `span` spans) of
    one `run()` under `torch.profiler`, with the port's spans on. Only
    the device's own rows count."""
    from torch.profiler import ProfilerActivity, profile
    from sml_tpu_torch.utils.profiler import PROFILER
    PROFILER.reset()
    PROFILER.enabled = True
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        prog = sum(sp.wall_s for sp in PROFILER.spans()
                   if sp.name == span) * 1e3
    finally:
        PROFILER.enabled = False
    from torch.autograd import DeviceType
    busy = {}
    for ev in prof.key_averages():
        # device rows only (kernels, copies, fills): an operator's row
        # repeats its kernels' time, and "Activity Buffer Request" is
        # the profiler's own
        if ev.device_type != DeviceType.CUDA or \
                ev.key.startswith("Activity Buffer"):
            continue
        t = float(getattr(ev, "self_device_time_total",
                          getattr(ev, "self_cuda_time_total", 0.0))) / 1e3
        if t > 0:
            busy[ev.key] = busy.get(ev.key, 0.0) + t
    return busy, prog


def print_busy(label: str, busy: dict, prog: float, card: str,
               per_fit=None) -> dict:
    """The card's busy share over a fit loop's wall time, its top
    kernels, and each fit kernel's device time (beside the ML 11
    per-shape sums `per_fit`, given them); returns those numbers."""
    total = sum(busy.values())
    if total <= 0:
        print("breakdown  torch.profiler saw no device time: busy share "
              "not measured")
        return {}
    top = sorted(busy.items(), key=lambda kv: -kv[1])[:6]
    print(f"breakdown  torch.profiler over one {label} fit: device busy "
          f"{total!r} ms over a fit loop of {prog!r} ms (busy share "
          f"{total / prog!r}, profiler on); top kernels "
          + "; ".join(f"{k[:60]} {v!r} ms" for k, v in top))
    kernels = (("hist_accumulate", HIST_KERNELS),
               ("split_scan", SCAN_KERNELS),
               ("row_weights", ("row_weights_kernel",)),
               ("feature_mask", ("feature_mask_kernel",)))
    out = {"busy_ms": total, "loop_ms": prog}
    for name, names in kernels:
        whole = sum(v for k, v in busy.items()
                    if any(nm in k for nm in names))
        if not whole:
            continue
        out[name] = whole
        beside = "" if per_fit is None or name not in per_fit else (
            f", against {fmt_ms(per_fit[name])} ms summed from the "
            f"per-shape times (40 trees x levels)")
        print(f"breakdown  {name} device time over one {label} fit: "
              f"{whole!r} ms by the profiler{beside}; card {card}")
    return out


def phase_fit_breakdown(seed: int, card: str, label: str, fit,
                        per_fit=None) -> None:
    """Where one fit (`fit(X, logy, cats, device)`, of `FITS`) on 80,000
    fresh rows spends its time: host binning, staging, the fit loop (its
    kernels' device time by CUDA events around each launch, and the rest:
    Python glue and small torch ops), host clock. Then the same fit under
    `torch.profiler`: the card's busy time over the fit loop's wall time,
    and (given the ML 11 per-shape sums `per_fit`) each fit kernel's
    device time beside them."""
    from sml_tpu_torch.utils.profiler import PROFILER
    saved = [dict(counts) for counts in _launch_counts()]
    cats = {0: 36, 1: 3, 2: 20}
    rng = np.random.default_rng([seed, 51])
    X, _ = ml11_rows(rng, 80_000, cats)
    logy = fit_labels(rng, X)

    def run():
        return fit(X, logy, cats, None)

    PROFILER.reset()
    PROFILER.enabled = True
    try:
        with KernelWatch(timed=True) as watch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            wall = time.perf_counter() - t0
            kms = watch.kernel_ms()
        spans = {}
        for sp in PROFILER.spans():
            spans[sp.name] = spans.get(sp.name, 0.0) + sp.wall_s * 1e3
    finally:
        PROFILER.enabled = False
    prog = spans.get("program.tree_ensemble", 0.0)
    kern = sum(kms.values())
    print(f"breakdown  {label} 80000 rows, fresh rows: whole fit "
          f"{wall * 1e3!r} ms; binning.fit {spans.get('binning.fit', 0.0)!r} "
          f"ms; staging.fit {spans.get('staging.fit', 0.0)!r} ms; fit loop "
          f"{prog!r} ms, of which kernel time by events {kern!r} ms ("
          + ", ".join(f"{k} {v!r}" for k, v in kms.items() if v)
          + f") and the rest {prog - kern!r} ms (host clock); card {card}")

    print_busy(label, *profile_busy(run, "program.tree_ensemble"), card,
               per_fit)
    for counts, before in zip(_launch_counts(), saved):
        counts.update(before)  # not the main path's launches


# ------------------------------------------------------------ tuning
#: the ML 07 CrossValidator grid (the course's random forest: maxBins 40,
#: seed 42, `auto` features, a third of 10): maxDepth x numTrees, over
#: 3 folds
TUNE_DEPTHS = (2, 5)
TUNE_TREES = (10, 20)
TUNE_FOLDS = 3
#: fused and one-by-one runs of the grid, in turns
TUNE_REPS = 3
#: the fit kernels, as `_fit_launches` names them
FIT_KERNELS = ("hist_accumulate", "split_scan", "feature_mask",
               "row_weights")


def tune_grid() -> list:
    """The grid's points as `fit_cv_grid` takes them, numTrees fastest."""
    from sml_tpu_torch.ml._tree_models import _feature_k
    return [dict(max_depth=d, max_bins=40, min_instances=1,
                 min_info_gain=0.0, n_trees=t, bootstrap=True,
                 feature_k=_feature_k("auto", N_FEAT, False),
                 subsample=1.0, seed=42)
            for d in TUNE_DEPTHS for t in TUNE_TREES]


def tune_folds(seed: int):
    """Phase 8's 80,000 training rows (price labels, as ML 07 fits) in 3
    seeded folds: each fold's training rows (the other two) and its
    validation rows."""
    X, logy, cats = fit_rows(seed)
    X, price = X[:80_000], np.exp(logy[:80_000])
    parts = np.array_split(
        np.random.default_rng([seed, 61]).permutation(len(price)),
        TUNE_FOLDS)
    train = [np.sort(np.concatenate([parts[j] for j in range(TUNE_FOLDS)
                                     if j != i])) for i in range(TUNE_FOLDS)]
    return ([X[i] for i in train], [price[i] for i in train],
            [(X[p], price[p]) for p in parts], cats)


#: the draw kernels: one launch each a sampled forest fit
DRAW_KERNELS = ("feature_mask", "row_weights")


def expected_launches(trials, chunks) -> dict:
    """The fit kernels' launches of forest fits whose elements are
    `chunks` (lists of grid indices, one fit each): T_max x D_max of each
    level kernel and one of each draw kernel a fit (every element a
    bootstrap of several trees over a feature subspace)."""
    out = dict.fromkeys(FIT_KERNELS, 0)
    for chunk in chunks:
        T = max(trials[g]["n_trees"] for g in chunk)
        D = max(trials[g]["max_depth"] for g in chunk)
        for k in FIT_KERNELS:
            out[k] += 1 if k in DRAW_KERNELS else T * D
    return out


def clear_fit_caches() -> None:
    """Empty the host bins caches and the device staging cache, so that a
    timed run bins and stages its rows itself, as a fresh CV does."""
    from sml_tpu_torch.ml import _staging, tree_impl
    from sml_tpu_torch.ml import _tree_models as ptm
    with ptm._bins_lock:
        ptm._bins_cache.clear()
        ptm._bins_cache_order.clear()
        ptm._bins_cache_bytes[0] = 0
    with tree_impl._predict_bin_lock:
        tree_impl._predict_bin_cache.clear()
    _staging.clear_bin_cache()


def phase_tuning(seed: int, device, card: str) -> dict:
    """The ML 07 grid over 3 folds: fused (`fit_cv_grid` at
    `sml.cv.maxFusedTrials` 16: one fit of 12 elements), then one by one
    (`RandomForestRegressor.fit`), then fused at 5 (3 fits) and 1 (4
    fold-fused fits), each from empty caches, with every launch counted
    and each model scored on its validation fold
    (`fused_reg_stats_from_matrix`). Checks the launch counts, every
    element's split tables and leaves against its sequential fit's, the
    rmse, and the models of the other chunkings; prints the rmse matrix,
    its fold means, the best point, the walls and the fused fit's busy
    share. Returns the launches and the walls."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.ml import _tree_models as ptm
    from sml_tpu_torch.ml.evaluation import _reg_metric
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.utils.profiler import PROFILER
    Xs, ys, val, cats = tune_folds(seed)
    trials = tune_grid()
    G = len(trials)
    keys = [(g, f) for g in range(G) for f in range(TUNE_FOLDS)]

    def fused(max_fused: int):
        def fit():
            prev = GLOBAL_CONF.get("sml.cv.maxFusedTrials")
            GLOBAL_CONF.set("sml.cv.maxFusedTrials", max_fused)
            try:
                return ptm.fit_cv_grid(Xs, ys, cats, trials)
            finally:
                GLOBAL_CONF.set("sml.cv.maxFusedTrials", prev)
        return fit

    def sequential():
        return {(g, f): ptm.RandomForestRegressor(
            numTrees=trials[g]["n_trees"], maxDepth=trials[g]["max_depth"],
            maxBins=40, seed=42).fit(Xs[f], ys[f], categorical=cats)._spec
            for g, f in keys}

    def run(fit, what: str):
        clear_fit_caches()
        for counts in _launch_counts():
            for k in counts:
                counts[k] = 0
        tk.LAUNCHES = 0
        PROFILER.reset()
        PROFILER.enabled = True
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            models = fit()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rmse = {key: _reg_metric("rmse", *ptm.fused_reg_stats_from_matrix(
                models[key], *val[key[1]])) for key in keys}
            t2 = time.perf_counter()
            spans = PROFILER.spans()
            dispatches = PROFILER.counters().get("tree.fit_dispatch", 0.0)
        finally:
            PROFILER.enabled = False
        launches = dict(_fit_launches(), forest_traverse=tk.LAUNCHES)

        def span_ms(pred):
            return sum(sp.wall_s for sp in spans if pred(sp.name)) * 1e3
        out = {"models": models, "rmse": rmse, "launches": launches,
               "fit_ms": (t1 - t0) * 1e3, "eval_ms": (t2 - t1) * 1e3,
               "binning_ms": span_ms(lambda n: n == "binning.fit"),
               "loop_ms": span_ms(
                   lambda n: n.startswith("program.tree_ensemble")),
               "dispatches": dispatches}
        print(f"tuning  {what}: fit {out['fit_ms']!r} ms (binning.fit "
              f"{out['binning_ms']!r} ms, fit loops {out['loop_ms']!r} ms),"
              f" validation scoring {out['eval_ms']!r} ms, {dispatches!r} "
              f"fit dispatches, launches {launches} (host clock, from empty "
              f"caches); card {card}")
        return out

    want = dict(expected_launches(trials, [list(range(G))]),
                forest_traverse=G * TUNE_FOLDS)
    want_seq = dict(expected_launches(trials, [[g] for g, _ in keys]),
                    forest_traverse=G * TUNE_FOLDS)
    reps = {"fused": [], "sequential": []}
    with KernelWatch() as watch:
        # fused and one by one in turns: host walls vary from call to call
        for rep in range(TUNE_REPS):
            reps["fused"].append(run(
                fused(16), f"fused, sml.cv.maxFusedTrials=16 (1 fit of 12 "
                f"elements), rep {rep}"))
            reps["sequential"].append(run(
                sequential, f"one by one (12 RandomForestRegressor fits), "
                f"rep {rep}"))
        five = run(fused(5), "fused, sml.cv.maxFusedTrials=5 (3 fits)")
        one = run(fused(1), "fold-fused, sml.cv.maxFusedTrials=1 (4 fits)")
    if watch.plain_on_cuda:
        raise AssertionError(f"the plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    for fz, sq in zip(reps["fused"], reps["sequential"]):
        if fz["launches"] != want or fz["dispatches"] != 1:
            raise AssertionError(f"fused grid: {fz['launches']}, "
                                 f"{fz['dispatches']} fits; want {want}, 1")
        if sq["launches"] != want_seq or sq["dispatches"] != len(keys):
            raise AssertionError(f"one by one: {sq['launches']}, want "
                                 f"{want_seq}")
    fz, sq = reps["fused"][0], reps["sequential"][0]
    for what, rs in reps.items():
        print(f"tuning  {what}: median of {TUNE_REPS} in turns: "
              + ", ".join(f"{k} {float(np.median([r[k] for r in rs]))!r} ms"
                          for k in ("fit_ms", "binning_ms", "loop_ms",
                                    "eval_ms"))
              + f" (each run: {[round(r['fit_ms'], 1) for r in rs]}); card "
              f"{card}")
    chunks5 = [[g for g, _ in keys[lo:lo + 5]] for lo in range(0, 12, 5)]
    for got, chunks, fits in ((five, chunks5, 3),
                              (one, [[g] for g in range(G)], G)):
        want_k = dict(expected_launches(trials, chunks),
                      forest_traverse=G * TUNE_FOLDS)
        if got["launches"] != want_k or got["dispatches"] != fits:
            raise AssertionError(f"chunked grid: {got['launches']}, "
                                 f"{got['dispatches']} fits; want {want_k}, "
                                 f"{fits}")

    def compare(a: dict, b: dict, what: str):
        trees = exact = leaves = leaves_equal = 0
        for key in keys:
            for ta, tb in zip(a["models"][key].trees, b["models"][key].trees):
                if not (np.array_equal(ta.split_feature, tb.split_feature)
                        and np.array_equal(ta.split_bin, tb.split_bin)):
                    raise AssertionError(f"{what} {key}: split tables "
                                         f"differ")
                np.testing.assert_allclose(ta.leaf_value, tb.leaf_value,
                                           rtol=1e-6, err_msg=f"{what} {key}")
                trees += 1
                exact += all(np.array_equal(getattr(ta, f), getattr(tb, f))
                             for f in ta._fields)
                leaves += ta.leaf_value.size
                leaves_equal += int((ta.leaf_value == tb.leaf_value).sum())
            ra, rb = a["rmse"][key], b["rmse"][key]
            if abs(ra - rb) > max(RMSE_ATOL, RMSE_RTOL * abs(rb)):
                raise AssertionError(f"{what} {key}: rmse {ra} vs {rb}")
        print(f"tuning  {what}: split tables identical in {trees} of {trees} "
              f"trees, leaves within rtol 1e-6; {exact} trees bit-equal in "
              f"every field, {leaves_equal} of {leaves} leaf values "
              f"bit-equal; rmse within max(1e-3, 1e-5*|rmse|)")

    compare(fz, sq, "fused vs one by one")
    for rep in range(1, TUNE_REPS):
        compare(reps["fused"][rep], fz, f"fused rep {rep} vs rep 0")
    compare(five, fz, "maxFusedTrials=5 vs 16")
    compare(one, fz, "maxFusedTrials=1 vs 16")
    m = np.asarray([[fz["rmse"][(g, f)] for f in range(TUNE_FOLDS)]
                    for g in range(G)])
    if not np.isfinite(m).all() or m.shape != (G, TUNE_FOLDS):
        raise AssertionError(f"rmse matrix {m}")
    means = m.mean(axis=1)
    best = int(np.argmin(means))
    print(f"tuning  rmse (price) by grid point (maxDepth, numTrees) and "
          f"fold:\n" + "\n".join(
              f"  maxDepth={trials[g]['max_depth']} numTrees="
              f"{trials[g]['n_trees']}: {m[g].tolist()} mean "
              f"{float(means[g])!r}"
              for g in range(G))
          + f"\ntuning  avgMetrics {means.tolist()}; best maxDepth="
          f"{trials[best]['max_depth']} numTrees={trials[best]['n_trees']}")
    if not trials[best]["max_depth"] == max(TUNE_DEPTHS):
        raise AssertionError(f"the deeper forest should win: {means}")
    busy = print_busy("fused ML 07 grid (12 elements)", *profile_busy(
        fused(16), "program.tree_ensemble_trials"), card)
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0
    tk.LAUNCHES = 0
    return {"fused": fz["launches"], "sequential": sq["launches"],
            "models": fz["models"],
            "walls": {k: [{m: r[m] for m in ("fit_ms", "binning_ms",
                                              "loop_ms", "eval_ms")}
                          for r in rs]
                      for k, rs in (("fused", reps["fused"]),
                                    ("sequential", reps["sequential"]),
                                    ("max_fused_5", [five]),
                                    ("max_fused_1", [one]))},
            "busy": busy}


# ------------------------------------------------- phase 11: DataFrames
#: the course's prep columns (ML 06 / ML 07 / ML 11)
DF_CAT = ["neighbourhood_cleansed", "room_type", "property_type"]
DF_NUM = ["accommodates", "bathrooms", "bedrooms", "beds", "minimum_nights",
          "number_of_reviews", "review_scores_rating"]
DF_IDX = [c + "_idx" for c in DF_CAT]
DF_IMP = [c + "_imp" for c in DF_NUM]


def df_estimator(name: str):
    """The course's estimator of a pipeline: ML 06's tree, ML 07's
    forest (on price) or ML 11's XGBoost (on log price)."""
    from sml_tpu_torch.ml.regression import (DecisionTreeRegressor,
                                             RandomForestRegressor)
    from sml_tpu_torch.xgboost import XgboostRegressor
    if name == "dt":
        return DecisionTreeRegressor(labelCol="price", maxDepth=5,
                                     maxBins=40)
    if name == "rf":
        return RandomForestRegressor(labelCol="price", maxDepth=6,
                                     numTrees=20, maxBins=40, seed=42)
    return XgboostRegressor(n_estimators=40, learning_rate=0.15,
                            max_depth=6, max_bins=64, random_state=42)


def df_prep():
    """Imputer(median), StringIndexer(skip) and VectorAssembler(idx +
    imp): the course's prep stages."""
    from sml_tpu_torch.ml.feature import (Imputer, StringIndexer,
                                          VectorAssembler)
    return [Imputer(strategy="median", inputCols=DF_NUM, outputCols=DF_IMP),
            StringIndexer(inputCols=DF_CAT, outputCols=DF_IDX,
                          handleInvalid="skip"),
            VectorAssembler(inputCols=DF_IDX + DF_IMP, outputCol="features")]


def df_splits(n: int):
    """createDataFrame(make_airbnb_dataset(n, seed=42)) ->
    randomSplit([0.8, 0.2], seed=42), both halves cached."""
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.session import get_session
    df = get_session().createDataFrame(make_airbnb_dataset(n=n, seed=42))
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    return train.cache(), test.cache()


def _zero_launches() -> None:
    from sml_tpu_torch.native import traverse_kernel as tk
    for counts in _launch_counts():
        for k in counts:
            counts[k] = 0
    tk.LAUNCHES = 0


def _all_launches() -> dict:
    from sml_tpu_torch.native import traverse_kernel as tk
    return dict(_fit_launches(), forest_traverse=tk.LAUNCHES)


def df_course_run(train, test) -> dict:
    """The three pipelines fitted on `train` and evaluated on `test` on
    the session's device: {name: (PipelineModel, rmse, fit launches,
    evaluate launches, whether the prediction frame stayed lazy)}."""
    from sml_tpu_torch import functions as F
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    ev = RegressionEvaluator(labelCol="price")
    out = {}
    for name in ("dt", "rf", "xgb"):
        tr, te = train, test
        if name == "xgb":
            tr = train.withColumn("label", F.log(F.col("price")))
            te = test.withColumn("label", F.log(F.col("price")))
        _zero_launches()
        model = Pipeline(stages=df_prep() + [df_estimator(name)]).fit(tr)
        fit_l = _all_launches()
        _zero_launches()
        pred = model.transform(te)
        if name == "xgb":
            pred = pred.withColumn("prediction", F.exp(F.col("prediction")))
        rmse = ev.evaluate(pred)
        out[name] = (model, rmse, fit_l, _all_launches(),
                     pred._parts is None, tr, te)
    return out


def _prepped(model, frame):
    """`frame` through a pipeline model's prep stages."""
    for s in model.stages[:-1]:
        frame = s.transform(frame)
    return frame


def phase_dataframe(device, card: str) -> dict:
    """The course's DataFrame pipelines on `device` (the session's
    `sml.device`), at full width (10 features) on 100,000 rows; each
    DataFrame fit against the port's matrix fit; the evaluator's
    pushdown; the card against the CPU at 16,000 rows; and the
    host-clock split of one ML 07 pipeline."""
    import os
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.ml._staging import extract_xy
    from sml_tpu_torch.ml._tree_models import _categorical_slots
    from sml_tpu_torch.ml.evaluation import _reg_metric, host_reg_stats
    from sml_tpu_torch.ml.inference import DeviceScorer
    GLOBAL_CONF.set("sml.device", device.type)
    t0 = time.perf_counter()
    train, test = df_splits(100_000)
    print(f"dataframe: 100000 rows made, split and cached in "
          f"{(time.perf_counter() - t0) * 1e3!r} ms; train "
          f"{train.count()} test {test.count()} rows, "
          f"{train.getNumPartitions()} partitions")
    with KernelWatch() as watch:
        runs = df_course_run(train, test)
        for name, (model, rmse, fit_l, eval_l, lazy, tr, te) in \
                runs.items():
            want_fit = dict(FITS[name][2], forest_traverse=0)
            want_eval = dict.fromkeys(want_fit, 0)
            want_eval["forest_traverse"] = 1
            print(f"dataframe {name}: fit launches {fit_l}, evaluate "
                  f"launches {eval_l}, rmse {rmse!r}, prediction column "
                  f"materialized: {not lazy}")
            if fit_l != want_fit or eval_l != want_eval or not lazy:
                raise AssertionError(f"{name}: fit {fit_l} (want "
                                     f"{want_fit}), evaluate {eval_l}, "
                                     f"lazy {lazy}")
            # the same fit through the matrix entry point, on the matrix
            # and slots the fitted prep stages assemble
            label = "label" if name == "xgb" else "price"
            prep = _prepped(model, tr)
            X, y, _ = extract_xy(prep, "features", label)
            cats = _categorical_slots(prep, "features")
            _zero_launches()
            matrix = df_estimator(name).fit(X, y, categorical=cats,
                                            device=device)
            if _all_launches() != fit_l:
                raise AssertionError(f"{name}: matrix fit launched "
                                     f"{_all_launches()}, the DataFrame "
                                     f"fit {fit_l}")
            df_model = model.stages[-1]
            same = all(
                np.array_equal(getattr(a, f), getattr(b, f))
                for a, b in zip(df_model._spec.trees, matrix._spec.trees)
                for f in ("split_feature", "split_bin", "leaf_value",
                          "gain", "cover"))
            if not same or df_model.getNumTrees() != matrix.getNumTrees():
                raise AssertionError(f"{name}: the DataFrame fit differs "
                                     f"from the matrix fit")
            # the pushdown's rmse against score_block + host statistics
            tprep = _prepped(model, te)
            Xt, _, _ = extract_xy(tprep, "features", "price")
            pred = DeviceScorer(df_model, device=device).score_block(Xt)
            if name == "xgb":
                pred = np.exp(pred)
            host = _reg_metric("rmse", *host_reg_stats(
                np.asarray(pred, np.float64),
                np.asarray(tprep._whole()["price"], np.float64)))
            print(f"dataframe {name}: {df_model.getNumTrees()} trees equal "
                  f"to the matrix fit's bit for bit; pushdown rmse "
                  f"{rmse!r} vs score_block + host_reg_stats {host!r}")
            if abs(rmse - host) > max(RMSE_ATOL, RMSE_RTOL * abs(host)):
                raise AssertionError(f"{name}: pushdown rmse {rmse} vs "
                                     f"{host}")
    if watch.plain_on_cuda:
        raise AssertionError(f"the plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    rmse = {k: v[1] for k, v in runs.items()}
    if not (rmse["rf"] < rmse["dt"] and rmse["xgb"] < rmse["rf"]):
        raise AssertionError(f"course ordering broken: {rmse}")
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "GOLDEN.json")
    with open(golden) as f:
        pins = json.load(f)["metrics"]
    print("dataframe 100000-row rmse beside GOLDEN.json's pins (the JAX "
          "package's 8-device CPU mesh; information only): "
          + ", ".join(f"{k}={rmse[k]!r} (pin {pins['rmse_' + k]})"
                      for k in ("dt", "rf", "xgb")))

    # the same pipelines at 16,000 rows, on the card and on the CPU
    small = df_splits(16_000)
    on_card = df_course_run(*small)
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        on_cpu = df_course_run(*small)
    finally:
        GLOBAL_CONF.set("sml.device", device.type)
    for k in on_card:
        a, b = on_card[k][1], on_cpu[k][1]
        print(f"dataframe card-vs-cpu 16000 rows {k}: rmse {a!r} vs {b!r}")
        if abs(a - b) > max(RMSE_ATOL, RMSE_RTOL * abs(b)):
            raise AssertionError(f"{k}: card rmse {a} vs cpu rmse {b}")

    split = df_ml07_split()
    print(f"dataframe ML 07 pipeline split, 100000 rows (host clock, ms, "
          f"caches emptied first): {json.dumps(split)} on {card}")
    return {"fit": {k: sum(runs[n][2][k] for n in runs)
                    for k in runs["dt"][2]},
            "evaluate": {k: sum(runs[n][3][k] for n in runs)
                         for k in runs["dt"][3]},
            "rmse": rmse, "split_ms": split}


def df_ml07_split() -> dict:
    """Host-clock ms of the parts of one ML 07 pipeline, each part ending
    in materialized frames (or a fitted model, or a metric) so that it
    holds its own work: createDataFrame, randomSplit and its sort, the
    prep stages' fits, assembly, the estimator's fit, transform +
    evaluate."""
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.dataframe import DataFrame
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import PipelineModel
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    clear_fit_caches()
    cols = make_airbnb_dataset(n=100_000, seed=42)
    imputer, indexer, assembler = df_prep()
    out = {}
    t = time.perf_counter()

    def lap(what):
        nonlocal t
        now = time.perf_counter()
        out[what] = (now - t) * 1e3
        t = now
    df = get_session().createDataFrame(cols).cache()
    lap("createDataFrame")
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    train.cache()
    test.cache()
    lap("randomSplit")
    one = DataFrame.from_partitions([train._whole()])
    imp_model = imputer.fit(one)
    imputed = imp_model.transform(one).cache()
    idx_model = indexer.fit(imputed)
    lap("prep fits")
    feats = assembler.transform(idx_model.transform(imputed)).cache()
    lap("assembly")
    rf = df_estimator("rf").fit(feats)
    lap("estimator fit")
    model = PipelineModel([imp_model, idx_model, assembler, rf])
    RegressionEvaluator(labelCol="price").evaluate(model.transform(test))
    lap("transform + evaluate")
    out["total"] = sum(out.values())
    return out


# ------------------------------------------- phase 12: model selection
#: ML 01's cleansing: these columns' NULLs imputed by their medians, in
#: place, before the ML 07 / ML 08 lessons split the frame
SEL_IMPUTED = ["bedrooms", "bathrooms", "review_scores_rating"]
#: ML 07's features (`tests/test_lessons.py:324-356`)
SEL_FEATURES = ["room_typeIndex", "bedrooms", "accommodates",
                "number_of_reviews"]
SEL_DEPTHS = (2, 5)
SEL_TREES = (5, 10)
SEL_FOLDS = 3
#: fmin's trials: past TPE's 10 startup trials
SEL_EVALS = 12
#: the kernels counted on this phase's paths
SEL_KERNELS = FIT_KERNELS + ("forest_traverse",)


def sel_frames(n: int):
    """make_airbnb_dataset(n, seed=42) -> createDataFrame -> ML 01's
    median imputation -> randomSplit([0.8, 0.2], seed=42), both halves
    cached."""
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.feature import Imputer
    df = get_session().createDataFrame(make_airbnb_dataset(n=n, seed=42))
    df = Imputer(strategy="median", inputCols=SEL_IMPUTED,
                 outputCols=SEL_IMPUTED).fit(df).transform(df)
    train, test = df.randomSplit([0.8, 0.2], seed=42)
    return train.cache(), test.cache()


def sel_prep():
    """ML 07's prep stages: StringIndexer(room_type, skip) and
    VectorAssembler."""
    from sml_tpu_torch.ml.feature import StringIndexer, VectorAssembler
    return [StringIndexer(inputCols=["room_type"],
                          outputCols=["room_typeIndex"],
                          handleInvalid="skip"),
            VectorAssembler(inputCols=SEL_FEATURES, outputCol="features")]


def sel_rf():
    from sml_tpu_torch.ml.regression import RandomForestRegressor
    return RandomForestRegressor(labelCol="price", seed=42)


def sel_grid(rf):
    """The course's grid: maxDepth {2, 5} x numTrees {5, 10}."""
    from sml_tpu_torch.ml import ParamGridBuilder
    return (ParamGridBuilder()
            .addGrid(rf.getParam("maxDepth"), list(SEL_DEPTHS))
            .addGrid(rf.getParam("numTrees"), list(SEL_TREES)).build())


def sel_cv(est, grid, parallelism: int):
    from sml_tpu_torch.ml import CrossValidator
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    return CrossValidator(estimator=est, estimatorParamMaps=grid,
                          evaluator=RegressionEvaluator(labelCol="price"),
                          numFolds=SEL_FOLDS, parallelism=parallelism,
                          seed=42)


def sel_point(rf, pmap) -> tuple:
    """(maxDepth, numTrees) of a grid point."""
    ec = rf.copy(pmap)
    return int(ec.getOrDefault("maxDepth")), int(ec.getOrDefault("numTrees"))


def add_launches(*counts) -> dict:
    return {k: sum(c.get(k, 0) for c in counts) for k in SEL_KERNELS}


def fits_launches(points, fused: bool) -> dict:
    """The fit kernels' launches of RF fits at (depth, trees) points: one
    fused fit of them all, or one fit each (`expected_launches`)."""
    trials = [{"max_depth": d, "n_trees": t} for d, t in points]
    idx = list(range(len(points)))
    return add_launches(expected_launches(
        trials, [idx] if fused else [[i] for i in idx]))


def sel_measured(fn):
    """(fn(), launches, host-clock ms) from zeroed counts."""
    _zero_launches()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return out, _all_launches(), (time.perf_counter() - t0) * 1e3


#: every launch phase 12 checks, summed by kernel
SEL_LAUNCHES: dict = {}


def sel_expect(what: str, got: dict, want: dict) -> None:
    print(f"selection {what}: launches {got}")
    if got != want:
        raise AssertionError(f"{what}: launches {got}, want {want}")
    for k, v in got.items():
        SEL_LAUNCHES[k] = SEL_LAUNCHES.get(k, 0) + v


def sel_objective(pipe, rf, fit_df, val_df, ev, score_batch=None):
    """ML 08's objective: the pipeline at a trial's (max_depth,
    num_trees), fitted on `fit_df`, its rmse on `val_df`; with
    `score_batch`, a generation's losses from the fused fits."""
    from sml_tpu_torch.tune import STATUS_OK

    def objective(params):
        m = pipe.copy({rf.getParam("maxDepth"): int(params["max_depth"]),
                       rf.getParam("numTrees"): int(params["num_trees"])}
                      ).fit(fit_df)
        return {"loss": ev.evaluate(m.transform(val_df)),
                "status": STATUS_OK}

    if score_batch is not None:
        objective.score_batch = score_batch
    return objective


def sel_fmin(objective, trials):
    """ML 08's search (`tests/test_lessons.py:377-378`) over SEL_EVALS
    trials from `RandomState(42)`: the history as (params, loss,
    status)."""
    from sml_tpu_torch.tune import fmin, hp, tpe
    space = {"max_depth": hp.quniform("max_depth", 2, 5, 1),
             "num_trees": hp.quniform("num_trees", 5, 10, 5)}
    fmin(objective, space, algo=tpe, max_evals=SEL_EVALS, trials=trials,
         rstate=np.random.RandomState(42))
    return [({k: v[0] for k, v in t["misc"]["vals"].items()},
             t["result"]["loss"], t["result"]["status"])
            for t in trials.trials]


def phase_selection(device, card: str, n: int = 100_000,
                    cpu_rows: int = 16_000) -> dict:
    """Tuning's host half on `device` (the session's `sml.device`), from
    `make_airbnb_dataset(n, seed=42)`: (a) CrossValidator over ML 07's
    random forest on an indexed, assembled frame, fused and as placed
    trials (`sml.cv.batchFolds=false`); (b) the pipeline inside the CV at
    parallelism 1 and 4; (c) the CV inside the pipeline (ML 07L); (d)
    TrainValidationSplit; (e) fmin over ML 08's space three ways; and (a)
    at `cpu_rows` rows
    on the card and on the CPU. Every launch counted and checked; returns
    the numbers of the JSON line."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.ml import Pipeline, TrainValidationSplit
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.ml.tuning import fused_param_scores
    from sml_tpu_torch.tune import STATUS_OK, SparkTrials, Trials
    from sml_tpu_torch.utils.profiler import PROFILER
    GLOBAL_CONF.set("sml.device", device.type)
    out = {"card": card}
    ev = RegressionEvaluator(labelCol="price")
    t0 = time.perf_counter()
    train, test = sel_frames(n)
    feat_train = Pipeline(stages=sel_prep()).fit(train).transform(train)
    feat_train.cache()
    print(f"selection: {n} rows made, imputed, split and featurized in "
          f"{(time.perf_counter() - t0) * 1e3!r} ms; train "
          f"{train.count()} rows; card {card}")
    rf = sel_rf()
    grid = sel_grid(rf)
    points = [sel_point(rf, pm) for pm in grid]
    elements = [p for p in points for _ in range(SEL_FOLDS)]
    walls = {}
    with KernelWatch() as watch:
        # (a) CV over the RF on the featurized frame: fused, then placed
        runs = {}
        for mode, fused in (("fused", True), ("placed", False)):
            GLOBAL_CONF.set("sml.cv.batchFolds", fused)
            try:
                clear_fit_caches()
                cvm, got, ms = sel_measured(
                    lambda: sel_cv(rf, grid, 4).fit(feat_train))
            finally:
                GLOBAL_CONF.unset("sml.cv.batchFolds")
            best = int(np.argmin(cvm.avgMetrics))
            want = add_launches(
                fits_launches(elements, fused), fits_launches(
                    [points[best]], False),
                {"forest_traverse": len(elements)})
            sel_expect(f"(a) CV {mode}", got, want)
            runs[mode] = (list(cvm.avgMetrics), best)
            walls[f"cv_{mode}_ms"] = ms
        if runs["fused"] != runs["placed"]:
            raise AssertionError(f"(a) fused {runs['fused']} vs placed "
                                 f"{runs['placed']}")
        avg, best = runs["fused"]
        print(f"selection (a) avgMetrics {avg} (fused and placed equal bit "
              f"for bit), best maxDepth={points[best][0]} "
              f"numTrees={points[best][1]}; walls fused "
              f"{walls['cv_fused_ms']!r} ms, placed {walls['cv_placed_ms']!r}"
              f" ms (host clock, parallelism 4); card {card}")
        out["a"] = {"avgMetrics": avg, "best": list(points[best])}

        # (b) the pipeline inside the CV, at parallelism 1 and 4
        pipe = Pipeline(stages=sel_prep() + [rf])
        by_par = {}
        for par in (1, 4):
            clear_fit_caches()
            cvm, got, ms = sel_measured(
                lambda: sel_cv(pipe, grid, par).fit(train))
            best_b = int(np.argmin(cvm.avgMetrics))
            want = add_launches(fits_launches(elements, False),
                                fits_launches([points[best_b]], False),
                                {"forest_traverse": len(elements)})
            sel_expect(f"(b) pipeline in CV, parallelism {par}", got, want)
            by_par[par] = list(cvm.avgMetrics)
            walls[f"pipeline_in_cv_par{par}_ms"] = ms
        if by_par[1] != by_par[4]:
            raise AssertionError(f"(b) parallelism 1 {by_par[1]} vs 4 "
                                 f"{by_par[4]}")
        print(f"selection (b) avgMetrics {by_par[1]} at parallelism 1 and 4,"
              f" bit for bit; walls {walls['pipeline_in_cv_par1_ms']!r} / "
              f"{walls['pipeline_in_cv_par4_ms']!r} ms; card {card}")
        out["b"] = {"avgMetrics": by_par[1]}

        # the host/device split of one pipeline-inside-CV fit: fold 0's
        # training rows, the grid's largest point
        folds = train.randomSplit([1.0 / SEL_FOLDS] * SEL_FOLDS, seed=42)
        fold_train = folds[1].union(folds[2]).cache()
        one = Pipeline(stages=sel_prep() + [rf.copy(grid[-1])])
        clear_fit_caches()
        PROFILER.reset()
        PROFILER.enabled = True
        on_card = device.type == "cuda"
        try:
            with KernelWatch(timed=on_card) as timed:
                _, got, ms = sel_measured(lambda: one.fit(fold_train))
                kernel_ms = sum(timed.kernel_ms().values()) if on_card \
                    else float("nan")
            spans = PROFILER.spans()
        finally:
            PROFILER.enabled = False

        def span_ms(name):
            return sum(sp.wall_s for sp in spans
                       if sp.name.startswith(name)) * 1e3
        split = {"fit_ms": ms, "binning_ms": span_ms("binning.fit"),
                 "staging_ms": span_ms("staging.fit"),
                 "fit_loop_ms": span_ms("program.tree_ensemble"),
                 "kernels_event_ms": kernel_ms}
        # the prep stages' fits, their frames and the extraction
        split["prep_and_frames_ms"] = ms - (
            split["binning_ms"] + split["staging_ms"] + split["fit_loop_ms"])
        split["host_ms"] = ms - kernel_ms
        print(f"selection one pipeline-in-CV fit (maxDepth "
              f"{points[-1][0]}, numTrees {points[-1][1]}, "
              f"{fold_train.count()} rows): {split} (host clock; kernels by "
              f"CUDA events around the wrapper calls); card {card}")
        out["pipeline_fit_split_ms"] = split

        # (c) the CV inside the pipeline (ML 07L)
        clear_fit_caches()
        inner = Pipeline(stages=sel_prep() + [sel_cv(rf, grid, 4)])
        pm, got, ms = sel_measured(lambda: inner.fit(train))
        cvm = pm.stages[-1]
        best_c = int(np.argmin(cvm.avgMetrics))
        sel_expect("(c) CV in pipeline, fit", got, add_launches(
            fits_launches(elements, True),
            fits_launches([points[best_c]], False),
            {"forest_traverse": len(elements)}))
        rmse_c, got, _ = sel_measured(lambda: ev.evaluate(pm.transform(test)))
        sel_expect("(c) CV in pipeline, evaluate", got,
                   add_launches({"forest_traverse": 1}))
        if not np.isfinite(rmse_c) or rmse_c <= 0:
            raise AssertionError(f"(c) rmse {rmse_c}")
        walls["cv_in_pipeline_ms"] = ms
        print(f"selection (c) avgMetrics {list(cvm.avgMetrics)}, held-out "
              f"rmse {rmse_c!r}; card {card}")
        out["c"] = {"avgMetrics": list(cvm.avgMetrics), "rmse": rmse_c}

        # (d) TrainValidationSplit on the featurized frame
        tvs_runs = {}
        for mode, fused in (("fused", True), ("placed", False)):
            GLOBAL_CONF.set("sml.cv.batchFolds", fused)
            try:
                clear_fit_caches()
                tvm, got, ms = sel_measured(lambda: TrainValidationSplit(
                    estimator=rf, estimatorParamMaps=grid, evaluator=ev,
                    parallelism=4, seed=42).fit(feat_train))
            finally:
                GLOBAL_CONF.unset("sml.cv.batchFolds")
            best_d = int(np.argmin(tvm.validationMetrics))
            sel_expect(f"(d) TVS {mode}", got, add_launches(
                fits_launches(points, fused),
                fits_launches([points[best_d]], False),
                {"forest_traverse": len(points)}))
            tvs_runs[mode] = list(tvm.validationMetrics)
            walls[f"tvs_{mode}_ms"] = ms
        if tvs_runs["fused"] != tvs_runs["placed"]:
            raise AssertionError(f"(d) {tvs_runs}")
        print(f"selection (d) validationMetrics {tvs_runs['fused']} (fused "
              f"and placed equal bit for bit); card {card}")
        out["d"] = {"validationMetrics": tvs_runs["fused"]}

        # (e) fmin over ML 08's space, three ways
        fit_df, val_df = train.randomSplit([0.8, 0.2], seed=42)
        fit_df.cache()
        val_df.cache()

        def per_trial():
            return sel_objective(pipe, rf, fit_df, val_df, ev)

        def batched():
            # the prep fitted and applied once a search, inside its wall
            # (the per-trial objective refits it on every trial)
            prep = Pipeline(stages=sel_prep()).fit(fit_df)
            f_fit = prep.transform(fit_df).cache()
            f_val = prep.transform(val_df).cache()

            def score_batch(values):
                return fused_param_scores(rf, [
                    {rf.getParam("maxDepth"): int(v["max_depth"]),
                     rf.getParam("numTrees"): int(v["num_trees"])}
                    for v in values], f_fit, f_val, ev)
            return sel_objective(pipe, rf, fit_df, val_df, ev, score_batch)

        histories = {}
        for mode, trials, objective in (
                ("Trials", Trials(), per_trial),
                ("SparkTrials(2)", SparkTrials(parallelism=2), per_trial),
                ("score_batch", Trials(), batched)):
            GLOBAL_CONF.set("sml.tune.candidatesPerDispatch", 2)
            try:
                clear_fit_caches()
                hist, got, ms = sel_measured(
                    lambda: sel_fmin(objective(), trials))
            finally:
                GLOBAL_CONF.unset("sml.tune.candidatesPerDispatch")
            pts = [(int(p["max_depth"]), int(p["num_trees"]))
                   for p, _, _ in hist]
            fits = [pts[i:i + 2] for i in range(0, len(pts), 2)] \
                if objective is batched else [[p] for p in pts]
            sel_expect(f"(e) fmin {mode}", got, add_launches(
                *[fits_launches(g, True) for g in fits],
                {"forest_traverse": len(pts)}))
            if len(hist) != SEL_EVALS or any(s != STATUS_OK
                                             for _, _, s in hist):
                raise AssertionError(f"(e) {mode}: {hist}")
            histories[mode] = hist
            walls[f"fmin_{mode}_ms"] = ms
        seq, par, fused = (histories["Trials"], histories["SparkTrials(2)"],
                           histories["score_batch"])
        # a generation's proposals share one posterior (the JAX package's
        # fmin): generations of 2 (SparkTrials(2), score_batch at 2
        # candidates a dispatch) propose alike; one by one (Trials) agrees
        # with them through trial 11, the first TPE proposal
        if par != fused or seq[:SEL_EVALS - 1] != par[:SEL_EVALS - 1]:
            raise AssertionError(f"(e) histories differ:\n{seq}\n{par}\n"
                                 f"{fused}")
        loss_of = {}
        for hist in histories.values():
            for p, loss, _ in hist:
                key = tuple(sorted(p.items()))
                if loss_of.setdefault(key, loss) != loss:
                    raise AssertionError(f"(e) {key}: losses {loss} and "
                                         f"{loss_of[key]}")
        # trial 12 is proposed from 11 trials one by one and from 10 in a
        # generation of 2, so it may differ; it is recorded, not gated
        last_equal = seq[-1] == par[-1]
        print(f"selection (e) fmin trial history (max_depth, num_trees, "
              f"loss): {[(p['max_depth'], p['num_trees'], l) for p, l, _ in par]}"
              f" in generations of 2 (SparkTrials(2) and score_batch, bit "
              f"for bit); Trials one by one {[(p['max_depth'], p['num_trees'], l) for p, l, _ in seq]}"
              f" (equal through trial {SEL_EVALS - 1}; trial {SEL_EVALS} "
              f"{'equal' if last_equal else 'differs'}); every trial ok, "
              f"each point's loss the same in every run; card {card}")
        out["e"] = {"generations_of_2": [[p["max_depth"], p["num_trees"], l]
                                         for p, l, _ in par],
                    "one_by_one": [[p["max_depth"], p["num_trees"], l]
                                   for p, l, _ in seq],
                    f"trial_{SEL_EVALS}_one_by_one_equal": last_equal}
    if watch.plain_on_cuda:
        raise AssertionError(f"the plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    out["walls_ms"] = walls

    # (a) at cpu_rows rows, on the card and on the CPU
    small = sel_frames(cpu_rows)
    metrics = {}
    for dev in (device.type, "cpu"):
        GLOBAL_CONF.set("sml.device", dev)
        try:
            clear_fit_caches()
            ft = Pipeline(stages=sel_prep()).fit(small[0]).transform(
                small[0]).cache()
            metrics[dev] = list(sel_cv(rf, grid, 4).fit(ft).avgMetrics)
        finally:
            GLOBAL_CONF.set("sml.device", device.type)
    for a, b in zip(metrics[device.type], metrics["cpu"]):
        if abs(a - b) > max(RMSE_ATOL, RMSE_RTOL * abs(b)):
            raise AssertionError(f"card {metrics[device.type]} vs cpu "
                                 f"{metrics['cpu']}")
    print(f"selection card-vs-cpu {cpu_rows} rows (a): avgMetrics "
          f"{metrics[device.type]} vs {metrics['cpu']}")
    out["card_vs_cpu"] = metrics
    _zero_launches()
    return out


# ------------------------------- phase 13: chunked plane and warm start
#: ML 11's XGBoost fit (`_fit_xgb`) as `fit_ensemble_chunked` arguments
CHUNK_XGB = dict(n_trees=40, max_depth=6, max_bins=64, min_instances=1,
                 min_info_gain=0.0, feature_k=None, bootstrap=False,
                 subsample=1.0, seed=42, loss="squared", step_size=0.15,
                 reg_lambda=1.0, gamma=0.0, boosting=True)
CHUNK_ROWS = 8192
#: phase 13(e): rows and features of the generator source, its chunks
GEN_ROWS, GEN_FEAT, GEN_CHUNK = 4_194_304, 10, 131_072
#: the kernels of the chunked paths
CHUNK_KERNELS = FIT_KERNELS + ("forest_traverse",)
#: shapes that take each of `forest_traverse`'s paths with `init`: (shape,
#: rows, plan fields)
INIT_PATHS = [
    (SHAPES[0], 37, {"path": "shared", "n_chunks": 1}),     # trees in
    (SHAPES[0], 100_000, {"path": "shared", "groups": 1}),  # parallel; one
    (("many trees", 300, 6, 64, np.uint8, "step"), 4096,    # group; chunks
     {"path": "shared", "n_chunks": 2}),
    (("many trees", 300, 6, 64, np.uint8, "step"), 100_000,
     {"path": "shared", "n_chunks": 2, "groups": 1}),
    (("deep, global memory", 2, 16, 300, np.uint16, "step"), 4096,
     {"path": "global"}),
]


def same_spec(a, b, what: str) -> None:
    """Every table of every tree and the base equal, bit for bit."""
    if len(a.trees) != len(b.trees) or a.base != b.base:
        raise AssertionError(f"{what}: {len(a.trees)} vs {len(b.trees)} "
                             f"trees, base {a.base!r} vs {b.base!r}")
    for i, (ta, tb) in enumerate(zip(a.trees, b.trees)):
        for fld in ta._fields:
            if not np.array_equal(getattr(ta, fld), getattr(tb, fld)):
                raise AssertionError(f"{what}: tree {i} {fld} differs")


def _launch_delta(before: dict) -> dict:
    now_ = _all_launches()
    return {k: now_[k] - before[k] for k in now_}


def _clear_chunk_caches() -> None:
    from sml_tpu_torch.ml import _chunked
    clear_fit_caches()
    _chunked._ingest_memo.clear()


def gen_maker(seed: int):
    """(13e) the generator: chunk [start, stop) of f32 rows made from
    (seed, start), labels a noisy linear function of two features."""
    def make(start, stop):
        r = np.random.default_rng([seed, start])
        Xc = r.normal(size=(stop - start, GEN_FEAT)).astype(np.float32)
        yc = (Xc[:, 0] - 0.5 * Xc[:, 1]
              + r.normal(0, 0.3, stop - start)).astype(np.float32)
        return Xc, yc
    return make


def phase_chunked(seed: int, device, card: str, xgb=None,
                  n_rows: int = 80_000, gen_rows: int = GEN_ROWS,
                  gen_chunk: int = GEN_CHUNK) -> dict:
    """Phase 13: the chunked data plane and warm start on the card, at
    the ML 11 and ML 07 widths (depth not cut). `xgb` is phase 8's ML 11
    matrix fit (fitted here when None); smaller `n_rows` / `gen_rows`
    rehearse the phase on the CPU."""
    import tempfile
    from sml_tpu_torch.ct import checkpointed_fit
    from sml_tpu_torch.frame._chunks import (ArrayChunkSource,
                                             GeneratorChunkSource)
    from sml_tpu_torch.ml import _chunked as pch
    from sml_tpu_torch.ml._staging import stage_bins_cached
    from sml_tpu_torch.ml._tree_models import (RandomForestRegressor,
                                               _fit_ensemble)
    from sml_tpu_torch.ml.tree_impl import bin_with
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.utils.profiler import PROFILER
    from sml_tpu_torch.conf import GLOBAL_CONF
    dev = None if device.type == "cuda" else "cpu"
    X, logy, cats = fit_rows(seed)
    Xtr, ytr = X[:n_rows], logy[:n_rows]
    Xte = X[80_000:] if n_rows == 80_000 else X[n_rows:n_rows + 4_000]
    if xgb is None:
        xgb = _fit_xgb(Xtr, ytr, cats, dev)
    src = lambda: ArrayChunkSource(Xtr, ytr, chunk_rows=CHUNK_ROWS)  # noqa: E731
    xgb_kw = dict(CHUNK_XGB, categorical=cats)
    out, chunked = {}, {k: 0 for k in CHUNK_KERNELS}

    def counts():
        return PROFILER.counters()

    def add(delta):
        for k in chunked:
            chunked[k] += delta[k]

    with KernelWatch() as watch:
        # (a) ML 11 XGBoost from 8,192-row chunks, against phase 8's fit
        _clear_chunk_caches()
        c0, l0 = counts(), _all_launches()
        t0 = time.perf_counter()
        spec_a = pch.fit_ensemble_chunked(src(), device=dev, **xgb_kw)
        wall_a = time.perf_counter() - t0
        got = _launch_delta(l0)
        c1 = counts()
        add(got)
        want = {"hist_accumulate": 240, "split_scan": 240,
                "feature_mask": 0, "row_weights": 0, "forest_traverse": 0}
        if got != want:
            raise AssertionError(f"(a) launches {got}, not {want}")
        if c1.get("staging.bin_cache_miss", 0) \
                != c0.get("staging.bin_cache_miss", 0):
            raise AssertionError("(a) the fit staged its own bins instead of "
                                 "the assembled matrix")
        same_spec(spec_a, xgb._spec, "(a) chunked vs matrix ML 11 fit")
        l0 = _all_launches()
        pred = pch.predict_chunked(spec_a, ArrayChunkSource(
            Xte, chunk_rows=CHUNK_ROWS), device=dev)
        add(_launch_delta(l0))
        if not np.array_equal(pred, xgb._spec.predict_margin(Xte, dev)):
            raise AssertionError("(a) predict_chunked differs from "
                                 "predict_margin")
        print(f"chunked (a) ML 11 XgboostRegressor from {n_rows} rows in "
              f"chunks of {CHUNK_ROWS}: {len(spec_a.trees)} trees bit-equal "
              f"to the matrix fit, launches {got}, no bins staged by the "
              f"fit, {wall_a * 1e3!r} ms (host clock, ingest included); "
              f"predict_chunked of {len(Xte)} rows bit-equal to "
              f"predict_margin; card {card}")
        out["a"] = {"launches": got, "wall_ms": wall_a * 1e3}

        # (b) 20 rounds, then 20 appended in segments of 5
        part = pch.fit_ensemble_chunked(src(), device=dev,
                                        **dict(xgb_kw, n_trees=20))
        d0, l0 = counts().get("tree.fit_dispatch", 0.0), _all_launches()
        warm = pch.warm_start_ensemble_chunked(
            part, src(), n_new_trees=20, seed=42, step_size=0.15,
            reg_lambda=1.0, rounds_per_dispatch=5, device=dev)
        got = _launch_delta(l0)
        add(got)
        dispatches = counts().get("tree.fit_dispatch", 0.0) - d0
        same_spec(warm, spec_a, "(b) warm start 20 + 20 vs 40")
        if got["forest_traverse"] != 1 or dispatches != 4:
            raise AssertionError(f"(b) {got['forest_traverse']} replay "
                                 f"launches, {dispatches} fit dispatches")
        print(f"chunked (b) warm start: 20 rounds + 20 appended "
              f"(rounds_per_dispatch=5) bit-equal to (a); the replay one "
              f"forest_traverse launch; tree.fit_dispatch {dispatches!r}")
        out["b"] = {"launches": got, "fit_dispatch": dispatches}

        # (c) a checkpointed fit stopped after its second checkpoint
        class Stop(RuntimeError):
            pass

        def stop_at(t):
            if t == 20:
                raise Stop()

        params = dict(n_trees=40, max_depth=6, max_bins=64, seed=42,
                      categorical=cats, step_size=0.15, reg_lambda=1.0,
                      rounds_per_dispatch=10, device=dev)
        with tempfile.TemporaryDirectory() as tmp:
            whole = checkpointed_fit(src(), os.path.join(tmp, "a"), **params)
            ckdir = os.path.join(tmp, "b")
            try:
                checkpointed_fit(src(), ckdir, on_checkpoint=stop_at,
                                 **params)
                raise AssertionError("(c) the fit was not stopped")
            except Stop:
                pass
            r0 = counts().get("ct.resumes", 0.0)
            resumed = checkpointed_fit(src(), ckdir, **params)
            resumes = counts().get("ct.resumes", 0.0) - r0
            left = os.path.exists(ckdir)
        same_spec(resumed, whole, "(c) resumed vs uninterrupted")
        same_spec(resumed, spec_a, "(c) resumed vs (a)")
        if resumes != 1 or left:
            raise AssertionError(f"(c) ct.resumes +{resumes}, directory "
                                 f"left: {left}")
        print(f"chunked (c) checkpointed fit stopped after round 20 of 40 "
              f"(rounds_per_dispatch=10), resumed (ct.resumes +1): "
              f"bit-equal to the uninterrupted fit and to (a)")

        # (d) ML 07's random forest from chunks, and its chunked CV
        price = np.exp(ytr)
        rf = RandomForestRegressor(numTrees=20, maxDepth=6, maxBins=40,
                                   seed=42)
        _clear_chunk_caches()
        l0 = _all_launches()
        m_chunk = rf.fit_chunked(ArrayChunkSource(Xtr, price,
                                                  chunk_rows=CHUNK_ROWS),
                                 device=dev)
        got = _launch_delta(l0)
        add(got)
        l0 = _all_launches()
        m_mat = rf.fit(Xtr, price, categorical={}, device=dev)
        want = _launch_delta(l0)
        same_spec(m_chunk._spec, m_mat._spec, "(d) RF fit_chunked vs fit")
        if got != want:
            raise AssertionError(f"(d) launches {got} vs {want}")
        l0 = _all_launches()
        t0 = time.perf_counter()
        cv = pch.cross_validate_chunked(
            ArrayChunkSource(Xtr, price, chunk_rows=CHUNK_ROWS), 3, 42,
            categorical={}, max_depth=6, max_bins=40, n_trees=20,
            feature_k=3, bootstrap=True, seed=42, device=dev)
        cv_ms = (time.perf_counter() - t0) * 1e3
        add(_launch_delta(l0))
        if not all(np.isfinite(cv["fold_rmse"])):
            raise AssertionError(f"(d) CV {cv}")
        print(f"chunked (d) ML 07 RandomForestRegressor.fit_chunked: 20 "
              f"trees bit-equal to fit(categorical={{}}), launches {got}; "
              f"cross_validate_chunked k=3 fold rmse {cv['fold_rmse']} "
              f"(avg {cv['avg_rmse']!r}), {cv_ms!r} ms; card {card}")
        out["d"] = {"launches": got, "fold_rmse": cv["fold_rmse"]}

        # (e) a generator source that is never whole
        make = gen_maker(seed)
        gen = lambda: GeneratorChunkSource(  # noqa: E731
            gen_rows, GEN_FEAT, make, chunk_rows=gen_chunk,
            fingerprint=("chip-smoke-13e", seed, gen_rows))
        t_e = time.perf_counter()
        _clear_chunk_caches()
        ings = {}
        for depth_ in (2, 1):
            GLOBAL_CONF.set("sml.data.prefetchChunks", depth_)
            try:
                t0 = time.perf_counter()
                ings[depth_] = pch.ingest_source(
                    gen(), 64, {}, device=dev,
                    sketch=None if depth_ == 2 else ings[2].sketch)
                ings[depth_].stats["wall_s"] = time.perf_counter() - t0
            finally:
                GLOBAL_CONF.unset("sml.data.prefetchChunks")
        ing = ings[2]
        if ing.stats["sketch_exact"]:
            raise AssertionError("(e) the sketch did not compress")
        order = ing.stats["order"]
        if order.index(("dispatch", 1)) > order.index(("drain", 0)):
            raise AssertionError(f"(e) no overlap: {order[:6]}")
        l0 = _all_launches()
        spec_e = pch.fit_ensemble_chunked(
            gen(), device=dev, **dict(CHUNK_XGB, categorical={}, n_trees=10,
                                      seed=seed))
        add(_launch_delta(l0))
        Xg = np.concatenate([make(s, min(s + gen_chunk, gen_rows))[0]
                             for s in range(0, gen_rows, gen_chunk)])
        yg = np.concatenate([make(s, min(s + gen_chunk, gen_rows))[1]
                             for s in range(0, gen_rows, gen_chunk)])
        whole_bins = bin_with(Xg, ing.binning)
        miss0 = counts().get("staging.bin_cache_miss", 0)
        assembled = stage_bins_cached(ing.binned, device).cpu().numpy()
        if counts().get("staging.bin_cache_miss", 0) != miss0:
            raise AssertionError("(e) the assembled matrix is not cached")
        if not np.array_equal(assembled, whole_bins):
            raise AssertionError("(e) the assembled matrix differs from "
                                 "bin_with of the whole rows")
        clear_fit_caches()
        spec_m = _fit_ensemble(
            None, yg, categorical={}, prebinned=(whole_bins, ing.binning),
            device=dev, **dict(CHUNK_XGB, n_trees=10, seed=seed))
        same_spec(spec_e, spec_m, "(e) chunked vs prebinned whole-rows fit")
        probs = np.linspace(0, 1, 65)[1:-1]
        worst = 0.0
        for f in range(GEN_FEAT):
            exact = np.quantile(Xg[:, f], probs)
            err = np.abs(ing.binning.edges[f, :len(probs)] - exact).max()
            if err >= np.diff(exact).max():
                raise AssertionError(f"(e) feature {f} edges off by {err}")
            worst = max(worst, float(err / np.diff(exact).max()))
        e_s = time.perf_counter() - t_e
        compact = ing.stats["compact_bytes"]
        block = gen_chunk * GEN_FEAT
        peak = ing.stats["chunk_stage_peak_bytes"]
        raw = gen_rows * GEN_FEAT * 4
        if peak is not None and peak > compact + 2 * block + 16 * 2 ** 20:
            raise AssertionError(f"(e) pass 2 added {peak} bytes")
        for d_, g in sorted(ings.items(), reverse=True):
            st = g.stats
            print(f"chunked (e) ingest of {gen_rows} x {GEN_FEAT} f32 rows "
                  f"in {st['n_chunks']} chunks at prefetchChunks={d_}: "
                  f"sketch {st['sketch_s']!r} s{' (reused)' if d_ == 1 else ''}"
                  f", prep {st['prep_s']!r} s (summed over workers), "
                  f"dispatch {st['dispatch_s']!r} s, pass 2 "
                  f"{st['pipeline_s']!r} s, wall {st['wall_s']!r} s, "
                  f"{gen_rows / st['wall_s']!r} rows/s (host clock); card "
                  f"{card}")
        print(f"chunked (e) order {order[:8]} ... (dispatch 1 before drain "
              f"0); pass 2 added {peak} bytes of device memory (compact "
              f"{compact}, + 2 chunk blocks {compact + 2 * block}, raw f32 "
              f"{raw}); assembled matrix == bin_with byte for byte; 10 "
              f"trees bit-equal to the prebinned fit; edges within "
              f"{worst!r} of a bin width of np.quantile; phase (e) "
              f"{e_s!r} s")
        out["e"] = {
            "rows": gen_rows, "chunks": ing.stats["n_chunks"],
            "ingest": {str(d_): {k: g.stats[k] for k in (
                "sketch_s", "prep_s", "dispatch_s", "pipeline_s", "wall_s")}
                for d_, g in ings.items()},
            "order_head": order[:8], "pass2_device_bytes": peak,
            "compact_bytes": compact, "chunk_block_bytes": block,
            "raw_f32_bytes": raw, "edge_err_bin_widths": worst,
            "phase_s": e_s}
    if watch.plain_on_cuda:
        raise AssertionError(f"the plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    # the replay and `init` against the plain version, outside the
    # main path's watch
    Bd = stage_bins_cached(bin_with(Xtr, part.binning), device)
    tabs = [torch.from_numpy(np.ascontiguousarray(np.stack(
        [getattr(t, f) for t in part.trees]), dt)).to(device)
        for f, dt in (("split_feature", np.int32),
                      ("split_bin", np.int32),
                      ("leaf_value", np.float32))]
    w = torch.full((20,), 0.15, dtype=torch.float32, device=device)
    replay = tk.forest_traverse(Bd, *tabs, w, depth=6, init=part.base)
    plain = tk.forest_margin_plain(Bd, *tabs, w, 6, init=part.base)
    if not torch.equal(replay, plain):
        raise AssertionError("(b) the replay differs from "
                             "forest_margin_plain")
    print(f"chunked (b) the replay ({n_rows} rows, 20 trees) on the "
          f"card bit-equal to forest_margin_plain with init=base")
    if device.type == "cuda":
        run = lambda: tk.forest_traverse(Bd, *tabs, w, depth=6,  # noqa: E731
                                         init=part.base)
        b_ms, b_by = bound_ms(Bd, tabs[0], tabs[1], 6)
        out["replay"] = {
            "ms": time_ms(run, 50),
            "device_ms": device_ms(run, 50, ("forest_traverse",),
                                   what="forest_traverse replay"),
            "device_seen": seen_of("forest_traverse replay"),
            "plain_ms": time_ms(lambda: tk.forest_margin_plain(
                Bd, *tabs, w, 6, init=part.base), 5),
            "bound_ms": b_ms, "bound_by": b_by,
            "shape": f"ML 11 replay: {n_rows} rows F=10 uint8, T=20 "
                     f"depth=6, init=base"}
        print(f"chunked (b) replay times: {out['replay']}; card {card}")
    # the kernel with `init` on each of its paths, tensor and number
    for i, (shape, n, expect) in enumerate(INIT_PATHS):
        rng = np.random.default_rng([seed, 13, i])
        ops = shape_operands(rng, shape, n, device)
        plan = tk.traverse_plan(n, N_FEAT, ops[0].element_size(),
                                *ops[1].shape, ops[5])
        if any(getattr(plan, k) != v for k, v in expect.items()):
            raise AssertionError(f"init path {shape[0]} x {n}: {plan} "
                                 f"does not hold {expect}")
        start = torch.from_numpy(rng.normal(size=n).astype(
            np.float32)).to(device)
        for init in (start, 0.625):
            k_out = tk.forest_traverse(*ops[:5], depth=ops[5], init=init)
            p_out = tk.forest_margin_plain(*ops, init=init)
            if not torch.equal(k_out, p_out):
                raise AssertionError(f"init path {shape[0]} x {n} "
                                     f"({type(init).__name__}) differs")
        print(f"kernel-vs-plain  forest_traverse init  {shape[0]:<19} "
              f"rows={n:<7}: {plan} bit-equal (tensor and number)  ok")
    out["launches"] = chunked
    print(f"chunked launches on the main path: {chunked}")
    _zero_launches()
    return out


# ------------------------------------------- phase 14: non-tree programs
NT_OHE = [c + "_ohe" for c in DF_CAT]
#: (a) the linear fits: ML 02 (bedrooms alone), ML 03 (one-hot slots and
#: numerics), and ridge and elastic net on ML 03's features
NT_LINEAR = {"ml02": {}, "ml03": {}, "ridge": {"regParam": 0.1},
             "enet": {"regParam": 0.1, "elasticNetParam": 0.5}}
#: card against CPU: linear predictions within this share of the largest
#: |prediction| (the tolerance the CPU tests hold the port to against the
#: JAX package; ML 03's Gram has a condition number near 1e8), AUROC,
#: KMeans centers and cost, and ALS rmse
NT_PRED_TOL = 2e-5
NT_AUC_ATOL = 1e-6
NT_RTOL = 1e-6
#: (d) MLE 01: the golden suite's ratings; MovieLens 1M's users, items
#: and drawn ratings (`bench.py:140-147`)
NT_GOLDEN_RATINGS = (1000, 400, 100_000)
NT_ML1M = (6040, 3700, 1_000_000)
#: (e) `bench.py`'s serving leg: clients, rows a request, requests, max
#: batch rows, flush µs
NT_SERVE = (8, 8, 2000, 256, 1000)


def nt_prep():
    """ML 03's prep stages: Imputer(median), StringIndexer(skip) and
    OneHotEncoder."""
    from sml_tpu_torch.ml.feature import (Imputer, OneHotEncoder,
                                          StringIndexer)
    return [Imputer(strategy="median", inputCols=DF_NUM, outputCols=DF_IMP),
            StringIndexer(inputCols=DF_CAT, outputCols=DF_IDX,
                          handleInvalid="skip"),
            OneHotEncoder(inputCols=DF_IDX, outputCols=NT_OHE)]


def walled(fn, device):
    """(fn(), host-clock ms), the device synchronised on both sides."""
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


#: warm fits timed after each first fit (their median is reported)
NT_REPS = 3


def fit_walls(fit, device):
    """(the first fit's result, its wall ms, the median wall ms of
    NT_REPS more): the first call also loads the kernels it meets."""
    out, first = walled(fit, device)
    warm = float(np.median([walled(fit, device)[1]
                            for _ in range(NT_REPS)]))
    return out, first, warm


def through(stages, frame):
    """`frame` through fitted stages, materialized once."""
    for s in stages:
        frame = s.transform(frame)
    frame = frame.cache()
    frame._whole()
    return frame


def run_on_cpu(fn):
    """fn() with the session's device set to the CPU."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    prev = GLOBAL_CONF.get("sml.device")
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        return fn()
    finally:
        GLOBAL_CONF.set("sml.device", prev)


def nt_busy(label: str, run, span: str, card: str, device) -> dict:
    """The card's busy share over one more `run()` (the span's wall), by
    `torch.profiler`; not measured on the CPU."""
    if device.type != "cuda":
        return {}
    return print_busy(label, *profile_busy(run, span), card)


def mean_baseline(train_col: np.ndarray, test_col: np.ndarray) -> float:
    """The rmse of predicting the training mean."""
    mean = float(np.mean(train_col))
    return float(np.sqrt(np.mean((np.asarray(test_col, np.float64)
                                  - mean) ** 2)))


def _coefs(model) -> np.ndarray:
    """A linear model's coefficients with its intercept last."""
    return np.append(np.asarray(model._coefficients, np.float64),
                     model.intercept)


def nt_linear(train, test, device, card: str, refs: dict) -> tuple:
    """(a) ML 02 / ML 03 and the penalized fits; (b) MLE 03's logistic
    regression. Returns (numbers, the ML 03 pipeline model); `refs` gets
    each fit's rows and the card's (and ML 03's CPU) coefficients, which
    phase 24 holds its ranks to."""
    from sml_tpu_torch import functions as F
    from sml_tpu_torch.ml._staging import extract_xy
    from sml_tpu_torch.ml import (LinearRegression, LogisticRegression,
                                  Pipeline)
    from sml_tpu_torch.ml.evaluation import (BinaryClassificationEvaluator,
                                             RegressionEvaluator)
    from sml_tpu_torch.ml.feature import VectorAssembler
    ev = RegressionEvaluator(labelCol="price")
    # bedrooms is NULL on 3% of the rows: ML 02 reads the imputed column
    va = {"ml02": VectorAssembler(inputCols=["bedrooms_imp"],
                                  outputCol="features"),
          "ml03": VectorAssembler(inputCols=NT_OHE + DF_IMP,
                                  outputCol="features")}
    out, frames, pipes = {}, {}, {}
    for name in ("ml02", "ml03"):
        pipes[name], ms = walled(lambda: Pipeline(stages=nt_prep() + [
            va[name], LinearRegression(labelCol="price")]).fit(train),
            device)
        frames[name] = (through(pipes[name].stages[:-1], train),
                        through(pipes[name].stages[:-1], test))
        out[f"{name}_pipeline_fit_ms"] = ms
    width = frames["ml03"][0]._whole()["features"].shape[1]
    for name in ("ml02", "ml03"):
        refs[f"{name}_X"], refs[f"{name}_y"], _ = extract_xy(
            frames[name][0], "features", "price")
    base = mean_baseline(train._whole()["price"], test._whole()["price"])
    for name, kw in NT_LINEAR.items():
        tr, te = frames["ml02" if name == "ml02" else "ml03"]

        def fit():
            return LinearRegression(labelCol="price", **kw).fit(tr)

        model, ms, warm = fit_walls(fit, device)
        scored = model.transform(te)
        pred = scored._whole()["prediction"]
        rmse = ev.evaluate(scored)
        cpu = run_on_cpu(fit)
        pred_cpu = run_on_cpu(
            lambda: cpu.transform(te)._whole()["prediction"])
        err = float(np.max(np.abs(pred - pred_cpu)))
        same = bool(np.array_equal(model._coefficients, cpu._coefficients)
                    and model.intercept == cpu.intercept)
        print(f"nontree (a) {name}: LinearRegression({kw}) on {tr.count()} "
              f"rows x {model.numFeatures} features: fit {ms!r} ms (warm "
              f"{warm!r}), test "
              f"rmse {rmse!r} (mean-price baseline {base!r}); card against "
              f"CPU: predictions max |diff| {err!r}, coefficients "
              f"bit-equal {same}; card {card}")
        if not rmse < base:
            raise AssertionError(f"{name}: rmse {rmse} not below the "
                                 f"baseline {base}")
        if err > NT_PRED_TOL * float(np.max(np.abs(pred_cpu))):
            raise AssertionError(f"{name}: card predictions differ from "
                                 f"the CPU's by {err}")
        refs[f"coef_{name}"] = _coefs(model)
        if name == "ml03":
            refs["coef_ml03_cpu"] = _coefs(cpu)
        out[name] = {"fit_ms": ms, "fit_ms_warm": warm, "rmse": rmse,
                     "card_cpu_max_diff": err,
                     "coefficients_bit_equal": same,
                     "features": model.numFeatures,
                     "busy": nt_busy(f"LinearRegression {name}", fit,
                                     "program.gram", card, device)}
    out["baseline_rmse"] = base
    if width != 49:
        raise AssertionError(f"ML 03 assembles {width} features, not 49")

    # (b) MLE 03 / ML 07L: priceClass at the training median
    tr, te = frames["ml03"]
    median = float(np.median(train._whole()["price"]))
    label = F.when(F.col("price") >= median, 1.0).otherwise(0.0)
    tr_l, te_l = tr.withColumn("label", label), te.withColumn("label", label)
    tr_l._whole()
    bev = BinaryClassificationEvaluator(labelCol="label")

    def logit():
        return LogisticRegression(labelCol="label").fit(tr_l)

    model, ms, warm = fit_walls(logit, device)
    auc = bev.evaluate(model.transform(te_l))
    cpu = run_on_cpu(logit)
    auc_cpu = run_on_cpu(lambda: bev.evaluate(cpu.transform(te_l)))
    iters = (model.summary.totalIterations, cpu.summary.totalIterations)
    print(f"nontree (b) LogisticRegression on priceClass (median "
          f"{median!r}): fit {ms!r} ms (warm {warm!r}), {iters[0]} IRLS "
          f"iterations (CPU "
          f"{iters[1]}), test AUROC {auc!r} (CPU {auc_cpu!r}), training "
          f"accuracy {model.summary.accuracy!r}; card {card}")
    if iters[0] != iters[1] or abs(auc - auc_cpu) > NT_AUC_ATOL:
        raise AssertionError(f"logistic: card {iters[0]} iterations, AUROC "
                             f"{auc}; CPU {iters[1]}, {auc_cpu}")
    refs["logit_y"] = extract_xy(tr_l, "features", "label")[1]
    refs["coef_logistic"] = np.append(_coefs(model), iters[0])
    out["logistic"] = {"fit_ms": ms, "fit_ms_warm": warm,
                       "iterations": iters[0], "auroc": auc,
                       "auroc_cpu": auc_cpu,
                       "busy": nt_busy("LogisticRegression", logit,
                                       "program.irls", card, device)}
    return out, pipes["ml03"]


def nt_kmeans(train, device, card: str, refs: dict) -> dict:
    """(c) MLE 02: KMeans k=3 and k=8 (20 iterations, seed 221) over the
    7 imputed numerics of the training rows; `refs` gets the rows and the
    card's centers and cost."""
    from sml_tpu_torch.ml import KMeans, Pipeline
    from sml_tpu_torch.ml._staging import extract_features
    from sml_tpu_torch.ml.feature import Imputer, VectorAssembler
    feats = Pipeline(stages=[
        Imputer(strategy="median", inputCols=DF_NUM, outputCols=DF_IMP),
        VectorAssembler(inputCols=DF_IMP, outputCol="features")]).fit(train)
    km = through([feats], train)
    refs["km_X"] = extract_features(km, "features")
    out = {}
    for k in (3, 8):
        def fit():
            return KMeans(k=k, maxIter=20, seed=221).fit(km)

        model, ms, warm = fit_walls(fit, device)
        cpu = run_on_cpu(fit)
        a, b = np.stack(model.clusterCenters()), np.stack(cpu.clusterCenters())
        c_err = float(np.max(np.abs(a - b)) / np.max(np.abs(b)))
        cost, cost_cpu = model.summary.trainingCost, cpu.summary.trainingCost
        flips = int(np.sum(model.transform(km)._whole()["prediction"]
                           != run_on_cpu(lambda: cpu.transform(km)._whole()[
                               "prediction"])))
        print(f"nontree (c) KMeans k={k} on {km.count()} rows x 7: fit "
              f"{ms!r} ms (warm {warm!r}), cost {cost!r} (CPU "
              f"{cost_cpu!r}), centers max "
              f"|diff| / max |center| {c_err!r}, assignments differing "
              f"{flips}; card {card}")
        if flips or c_err > NT_RTOL or abs(cost - cost_cpu) > \
                NT_RTOL * abs(cost_cpu):
            raise AssertionError(f"kmeans k={k}: {flips} flips, centers "
                                 f"{c_err}, cost {cost} vs {cost_cpu}")
        refs[f"km_k{k}"] = np.append(a.ravel(), cost)
        out[f"k{k}"] = {"fit_ms": ms, "fit_ms_warm": warm, "cost": cost,
                        "center_rel_diff": c_err,
                        "busy": nt_busy(f"KMeans k={k}", fit, "program.lloyd",
                                        card, device)}
    return out


def _ratings_of(frame) -> dict:
    whole = frame._whole()
    return {c: np.asarray(whole[c]) for c in ("userId", "movieId", "rating")}


def nt_als(device, card: str, refs: dict, golden=NT_GOLDEN_RATINGS,
           ml1m=NT_ML1M) -> dict:
    """(d) MLE 01: ALS at the golden suite's shape on the card and the
    CPU, MLE 01's CV over rank {4, 12} as placed trials, and ALS at the
    MovieLens 1M shape on the card alone; `refs` gets each shape's
    ratings and the card's factors and test rmse."""
    from sml_tpu_torch.courseware import make_movielens_dataset
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import ALS, CrossValidator, ParamGridBuilder
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.ml.tuning import fused_cv_applies
    ev = RegressionEvaluator(labelCol="rating")
    kw = dict(userCol="userId", itemCol="movieId", ratingCol="rating",
              maxIter=10, regParam=0.1, seed=42, coldStartStrategy="drop")
    out = {}

    def split(shape):
        df = get_session().createDataFrame(make_movielens_dataset(
            *shape, seed=42))
        tr, te = df.randomSplit([0.8, 0.2], seed=42)
        return through([], tr), through([], te)

    def scored(model, te):
        kept = model.transform(te)
        return ev.evaluate(kept), kept._whole()["rating"]

    # (i) the golden shape
    tr, te = split(golden)

    def fit():
        return ALS(rank=8, **kw).fit(tr)

    model, ms, warm = fit_walls(fit, device)
    rmse, kept = scored(model, te)
    cpu = run_on_cpu(fit)
    rmse_cpu = run_on_cpu(lambda: scored(cpu, te)[0])
    base = mean_baseline(tr._whole()["rating"], kept)
    f_err = float(max(np.max(np.abs(model._uf - cpu._uf)),
                      np.max(np.abs(model._if - cpu._if))))
    refs["als_golden"] = dict(train=_ratings_of(tr), test=_ratings_of(te),
                              factors=np.append(model._uf, model._if),
                              rmse=rmse)
    print(f"nontree (d)(i) ALS rank 8 on {tr.count()} ratings "
          f"({len(model._user_ids)} users x {len(model._item_ids)} items): "
          f"fit {ms!r} ms (warm {warm!r}), test rmse {rmse!r} (CPU "
          f"{rmse_cpu!r}, mean-rating "
          f"baseline {base!r}), factors max |card - CPU| {f_err!r}; "
          f"card {card}")
    if not rmse < base or abs(rmse - rmse_cpu) > NT_RTOL * rmse_cpu:
        raise AssertionError(f"als golden: rmse {rmse}, CPU {rmse_cpu}, "
                             f"baseline {base}")
    out["golden"] = {"fit_ms": ms, "fit_ms_warm": warm, "rmse": rmse,
                     "rmse_cpu": rmse_cpu,
                     "baseline_rmse": base, "factor_max_diff": f_err,
                     "busy": nt_busy("ALS golden", fit, "program.als_fit",
                                     card, device)}

    # (ii) MLE 01's CV over rank, placed trials
    als = ALS(**kw)
    grid = ParamGridBuilder().addGrid(als.getParam("rank"), [4, 12]).build()
    if fused_cv_applies(als, grid):
        raise AssertionError("an ALS grid took the fused tree path")
    def cv():
        return CrossValidator(estimator=als, estimatorParamMaps=grid,
                              evaluator=ev, numFolds=3, seed=42).fit(tr)

    cvm, ms = walled(cv, device)
    best = cvm.bestModel.rank
    avg = [float(m) for m in cvm.avgMetrics]
    print(f"nontree (d)(ii) CrossValidator(ALS, rank {{4, 12}}, 3 folds) "
          f"as placed trials: {ms!r} ms, avgMetrics {avg!r}, "
          f"best rank {best}; card {card}")
    if not all(np.isfinite(avg)) or best not in (4, 12):
        raise AssertionError(f"als cv: {avg}, best {best}")
    out["cv"] = {"wall_ms": ms, "avg_rmse": avg, "best_rank": best,
                 "busy": nt_busy("ALS CV (7 fits)", cv, "program.als_fit",
                                 card, device)}

    # (iii) the MovieLens 1M shape, on the card alone
    (tr, te), gen_ms = walled(lambda: split(ml1m), device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()

    def fit1m():
        return ALS(rank=12, **kw).fit(tr)

    model, ms = walled(fit1m, device)
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" \
        else None
    warm = float(np.median([walled(fit1m, device)[1]
                            for _ in range(NT_REPS)]))
    rmse, kept = scored(model, te)
    base = mean_baseline(tr._whole()["rating"], kept)
    refs["als_ml1m"] = dict(train=_ratings_of(tr), test=_ratings_of(te),
                            factors=np.append(model._uf, model._if),
                            rmse=rmse)
    print(f"nontree (d)(iii) ALS rank 12 at the MovieLens 1M shape: "
          f"{tr.count()} training ratings ({len(model._user_ids)} users x "
          f"{len(model._item_ids)} items; made and split in {gen_ms!r} ms): "
          f"fit {ms!r} ms (warm {warm!r}), peak device memory {peak} "
          f"bytes, test rmse "
          f"{rmse!r} (baseline {base!r}); card {card}")
    if not rmse < base:
        raise AssertionError(f"als 1m: rmse {rmse}, baseline {base}")
    out["ml1m"] = {"fit_ms": ms, "fit_ms_warm": warm, "rmse": rmse,
                   "baseline_rmse": base,
                   "ratings": tr.count(), "peak_bytes": peak,
                   "busy": nt_busy("ALS MovieLens 1M", fit1m,
                                   "program.als_fit", card, device)}
    return out


def nt_serving(pipe, n: int, device, card: str) -> dict:
    """(e) `DeviceScorer` on the ML 03 PipelineModel: `score_block`
    against `transform` and its latency, then `bench.py`'s serving leg
    through the batcher."""
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import DeviceScorer
    from sml_tpu_torch.serving import MicroBatcher
    from sml_tpu_torch.utils.profiler import PROFILER
    full = through(pipe.stages[:-1], get_session().createDataFrame(
        make_airbnb_dataset(n=n, seed=42)))
    X = np.asarray(full._whole()["features"], np.float64)
    want = pipe.stages[-1].transform(full)._whole()["prediction"]
    scorer = DeviceScorer(pipe, device=device)
    out = {}
    for rows in (4096, len(X)):
        got = scorer.score_block(X[:rows])
        np.testing.assert_allclose(got, want[:rows], rtol=1e-12, atol=0)
        times = []
        for _ in range(20):
            _, ms = walled(lambda: scorer.score_block(X[:rows]), device)
            times.append(ms)
        out[f"score_block_ms_{rows}"] = float(np.median(times))
        print(f"nontree (e) DeviceScorer(ML 03 PipelineModel).score_block "
              f"at {rows} rows: equal to transform (rtol 1e-12); median "
              f"{out[f'score_block_ms_{rows}']!r} ms of 20 (host clock, "
              f"staging and copy back included); card {card}")

    clients, req_rows, n_req, max_batch, flush = NT_SERVE
    before = PROFILER.counters()
    lat, errors, left = [], [], [n_req]
    lock = threading.Lock()
    rng = np.random.default_rng(7)
    starts = rng.integers(0, len(X) - req_rows, n_req)
    with MicroBatcher(scorer.score_block, max_batch_rows=max_batch,
                      flush_micros=flush) as server:
        def client():
            while True:
                with lock:
                    if left[0] == 0:
                        return
                    left[0] -= 1
                    i = left[0]
                rows = X[starts[i]:starts[i] + req_rows]
                t0 = time.perf_counter()
                try:
                    res = server.submit(rows).result(60)
                except RuntimeError as e:   # RequestShed
                    errors.append(repr(e))
                    continue
                with lock:
                    lat.append((time.perf_counter() - t0) * 1e3)
                want_rows = want[starts[i]:starts[i] + req_rows]
                if not np.allclose(res, want_rows, rtol=1e-12, atol=0):
                    errors.append(f"request {i} differs")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=client) for _ in range(clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=300)
        wall = time.perf_counter() - t0
    after = PROFILER.counters()

    def delta(k):
        return after.get(k, 0.0) - before.get(k, 0.0)

    sheds = delta("serve.shed")
    batches = delta("serve.batches")
    out["serve"] = {"requests": len(lat), "sheds": sheds,
                    "batches": batches, "rows_per_batch":
                    delta("serve.rows") / max(batches, 1),
                    "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)),
                    "requests_per_s": len(lat) / wall}
    print(f"nontree (e) serving leg ({clients} clients, {req_rows}-row "
          f"requests, {n_req} requests, max batch {max_batch}, flush "
          f"{flush} us): {json.dumps(out['serve'])}; card {card}")
    if errors or sheds or len(lat) != n_req:
        raise AssertionError(f"serving: {len(lat)} answered, {sheds} shed, "
                             f"errors {errors[:3]}")
    return out


def phase_nontree(device, card: str, n: int = 100_000,
                  golden=NT_GOLDEN_RATINGS, ml1m=NT_ML1M) -> dict:
    """Phase 14: the non-tree programs on `device` (the session's
    `sml.device`) at the golden suite's widths: (a) ML 02 / ML 03 linear
    regression with ridge and elastic net, (b) MLE 03's logistic
    regression, (c) MLE 02's KMeans, (d) MLE 01's ALS, its CV and the
    MovieLens 1M shape, (e) a linear PipelineModel served; each fit
    against the CPU's. None of them launches a kernel of the port (their
    work is torch matmuls, cumsums and batched solves), and the plain
    versions never run on the card. Smaller `n`, `golden` and `ml1m`
    rehearse it on the CPU. The result's "refs" holds the fits' rows and
    results, which phase 24 holds its ranks to (not printed)."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    GLOBAL_CONF.set("sml.device", device.type)
    _zero_launches()
    t0 = time.perf_counter()
    refs = {}
    with KernelWatch() as watch:
        train, test = df_splits(n)
        linear, ml03 = nt_linear(train, test, device, card, refs)
        out = {"card": card, "tf32": bool(
            torch.backends.cuda.matmul.allow_tf32), "linear": linear,
            "kmeans": nt_kmeans(train, device, card, refs),
            "als": nt_als(device, card, refs, golden, ml1m),
            "serving": nt_serving(ml03, n, device, card)}
    launches = _all_launches()
    if any(launches.values()) or watch.plain_on_cuda:
        raise AssertionError(f"the non-tree programs launched {launches}; "
                             f"plain versions on the card "
                             f"{watch.plain_on_cuda}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"nontree: every check passed in {out['phase_s']!r} s; no "
          f"kernel of the port launched ({launches}); TF32 off")
    out["refs"] = refs
    return out


# ------------------------------ phase 15: time series and the frame's rest
#: Prophet's quick start: Peyton Manning's daily Wikipedia page views, 2,905
#: days from 2007-12-10 (Prophet's documentation); the series is made from
#: the seed with its shape (a random-walk level, weekly and yearly terms,
#: holiday bumps, noise, on the log scale)
TS_QUICKSTART = ("2007-12-10", 2905)
#: the quick start's holidays: the Super Bowls in its documentation and
#: the January play-off Sundays of each season
TS_SUPERBOWLS = ("2010-02-07", "2014-02-02", "2016-02-07")
#: ARIMA on the quick-start series: one difference (its level is a random
#: walk), one AR and one MA term
TS_QUICKSTART_ORDER = (1, 1, 1)
#: card against CPU: ARIMA params within this share of the largest
#: |param|; Prophet within this share of std(y). Both run the same float64
#: ops; each device's BLAS sums Prophet's Gram in its own order, and
#: FISTA's 500 steps carry that (the measured gap is printed)
TS_PARAM_RTOL = 1e-9
TS_PROPHET_TOL = 1e-9
#: the course's ML 00L answer: abs(hash("100000")) ("02 Expected 100000
#: Records", `Labs/ML 00L - Dedup Lab.py:89-90`)
DEDUP_HASH = 972882115


def ts_mle04():
    """MLE 04's 160-point quadratic series (`tests/test_lessons.py:624-628`)
    and its daily dates from 2020-01-01."""
    t = np.arange(160, dtype=float)
    y = 0.02 * t * t + 1.5 * t + 20 \
        + np.random.default_rng(42).normal(scale=1.0, size=len(t))
    ds = np.datetime64("2020-01-01", "us") \
        + np.arange(160) * np.timedelta64(1, "D")
    return ds, y


def ts_quickstart(seed: int, days: int = TS_QUICKSTART[1]):
    """(ds, y, holidays) shaped as Prophet's quick-start series."""
    rng = np.random.default_rng(seed)
    ds = np.datetime64(TS_QUICKSTART[0], "us") \
        + np.arange(days) * np.timedelta64(1, "D")
    day = ds.astype("datetime64[D]")
    t = np.arange(days, dtype=float)
    jan = (day.astype("datetime64[M]").astype(np.int64) % 12 == 0) & \
        ((day.astype(np.int64) + 3) % 7 == 6)
    hol = np.union1d(day[jan], np.array(TS_SUPERBOWLS,
                                        dtype="datetime64[D]"))
    y = (8.0 + np.cumsum(rng.normal(0, 0.03, days))
         + 0.25 * np.sin(2 * np.pi * t / 7) + 0.1 * np.cos(4 * np.pi * t / 7)
         + 0.6 * np.sin(2 * np.pi * t / 365.25)
         + 0.3 * np.cos(2 * np.pi * t / 365.25)
         + 1.2 * np.isin(day, hol) + rng.normal(0, 0.05, days))
    return ds, y, {"ds": hol.astype("datetime64[us]")}


def ts_arima(y, order, device):
    """A fitted ARIMA: (results, L-BFGS evaluations, step-by-step ones)."""
    from sml_tpu_torch.timeseries import ARIMA
    model = ARIMA(y, order=order)
    res = model.fit()
    return res, model.evaluations, model.sequential_evaluations


def ts_eval_ms(y, order, params, device) -> tuple:
    """Median host ms at `params` of one evaluation through the triangular
    solve (loss and gradient) and of the step-by-step loss an overflowed
    evaluation takes again (forward only), each copied back."""
    from sml_tpu_torch.timeseries import css_loss_fn, css_loss_sequential_fn
    p, d, q = order
    diffed = np.diff(y, n=d) if d else y
    solve = css_loss_fn(diffed, p, q, device)
    steps = css_loss_sequential_fn(diffed, p, q, device)

    def through_solve():
        th = torch.tensor(params, dtype=torch.float64, device=device,
                          requires_grad=True)
        f = solve(th)
        (g,) = torch.autograd.grad(f, th)
        return torch.cat([f.detach()[None], g]).cpu()

    def step_by_step():
        return float(steps(torch.tensor(params, dtype=torch.float64,
                                        device=device)).cpu())
    through_solve(), step_by_step()
    return _median_ms(through_solve)[0], _median_ms(step_by_step)[0]


def ts_check_arima(label: str, card, cpu, walls, card_line_: str,
                   eval_ms: tuple) -> dict:
    res, evals, seq = card
    rel = float(np.max(np.abs(res.params - cpu[0].params))
                / np.max(np.abs(cpu[0].params)))
    per_eval = walls[2] / max(evals, 1)
    print(f"timeseries {label}: params {res.params.tolist()} sigma2 "
          f"{res.sigma2!r}; {evals} L-BFGS evaluations ({seq} step by "
          f"step), {per_eval!r} ms an evaluation over the warm fit, one "
          f"evaluation {eval_ms[0]!r} ms through the solve and its loss "
          f"{eval_ms[1]!r} ms step by step; first {walls[1]!r} ms / warm "
          f"median {walls[2]!r} ms; card against CPU params {rel!r} of the "
          f"largest |param|; card {card_line_}")
    if rel > TS_PARAM_RTOL or evals != cpu[1]:
        raise AssertionError(f"{label}: card params {res.params} against "
                             f"CPU {cpu[0].params} ({rel}), evaluations "
                             f"{evals} against {cpu[1]}")
    if not np.all(np.isfinite(res.params)) or not np.isfinite(res.aic):
        raise AssertionError(f"{label}: not finite: {res.params}")
    return {"params": res.params.tolist(), "evaluations": evals,
            "sequential_evaluations": seq, "ms_per_evaluation": per_eval,
            "solve_eval_ms": eval_ms[0], "sequential_eval_ms": eval_ms[1],
            "first_ms": walls[1], "warm_ms": walls[2], "card_vs_cpu": rel}


def ts_check_prophet(label: str, card, cpu, y, walls, card_line_: str
                     ) -> dict:
    a, b = card._whole(), cpu._whole()
    scale = float(np.std(y))
    gap = max(float(np.max(np.abs(a[c] - b[c]))) / scale
              for c in a if c != "ds")
    print(f"timeseries {label}: {len(a['yhat'])} rows, columns "
          f"{list(a)}; first {walls[1]!r} ms / warm median {walls[2]!r} "
          f"ms; card against CPU {gap!r} of std(y); card {card_line_}")
    if not np.array_equal(a["ds"], b["ds"]) or gap > TS_PROPHET_TOL:
        raise AssertionError(f"{label}: card against CPU {gap} of std(y)")
    if not all(np.all(np.isfinite(a[c])) for c in a if c != "ds"):
        raise AssertionError(f"{label}: a forecast is not finite")
    return {"first_ms": walls[1], "warm_ms": walls[2], "card_vs_cpu": gap,
            "rows": len(a["yhat"])}


def ts_mle04_run():
    """MLE 04 at the course's shape: (a)'s calls, results as numpy."""
    from sml_tpu_torch.timeseries import (Holt, Prophet, SimpleExpSmoothing,
                                          adfuller)
    ds, y = ts_mle04()
    adf = adfuller(y)
    m = Prophet().fit({"ds": ds, "y": y})
    fc = m.predict(m.make_future_dataframe(periods=10))
    holt = {"plain": Holt(y).fit().forecast(10),
            "damped": Holt(y, damped=True).fit().forecast(10),
            "exponential": Holt(y, exponential=True).fit().forecast(10),
            "ses": SimpleExpSmoothing(y).fit().forecast(10)}
    return adf, fc, holt


def ts_frames(n: int):
    """(c) the course's frame flows on `make_airbnb_dataset(n, seed=42)`:
    each result's rows, in order."""
    from sml_tpu_torch import functions as F
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.session import get_session
    spark = get_session()
    raw = spark.createDataFrame(make_airbnb_dataset(n=n, seed=42))
    df = raw.select("room_type", "bedrooms", "price").cache()
    out = {"ml00b_counts": df.groupBy("room_type").count()
           .orderBy(F.col("count").desc()).collect()}
    df.createOrReplaceTempView("listings_view")
    out["ml00b_sql"] = spark.sql(
        "SELECT room_type, count(*) AS n FROM listings_view "
        "GROUP BY room_type ORDER BY n DESC").collect()
    out["ml01L_hoods"] = raw.groupBy("neighbourhood_cleansed").count() \
        .orderBy(F.col("count").desc()).collect()
    hood_price = raw.groupBy("neighbourhood_cleansed").agg(
        F.avg("price").alias("hood_price"))
    joined = raw.select("neighbourhood_cleansed", "price").join(
        hood_price, "neighbourhood_cleansed")
    out["join"] = joined.select(F.sum("price"), F.sum("hood_price"),
                                F.count("*")).collect()
    out["cross"] = df.select("room_type").distinct().crossJoin(
        spark.createDataFrame({"k": np.arange(3)})).orderBy(
        "room_type", "k").collect()
    out["selectExpr"] = raw.selectExpr(
        "price * 2 as p2", "log(price + 1) as lp",
        "bedrooms").limit(5).collect()
    out["corr"] = raw.stat.corr("price", "accommodates")
    spark.catalog.dropTempView("listings_view")
    return out


def ts_check_frames(out: dict, n: int) -> None:
    """The frame results against numpy on the same rows."""
    from sml_tpu_torch.courseware import make_airbnb_dataset
    cols = make_airbnb_dataset(n=n, seed=42)
    for key, col in (("ml00b_counts", "room_type"),
                     ("ml01L_hoods", "neighbourhood_cleansed")):
        vals, counts = np.unique(cols[col].astype(str), return_counts=True)
        want = dict(zip(vals.tolist(), counts.tolist()))
        got = [(r[0], r["count"]) for r in out[key]]
        if dict(got) != want or [c for _, c in got] != sorted(
                counts.tolist(), reverse=True):
            raise AssertionError(f"{key}: {got} against {want}")
    if [tuple(r) for r in out["ml00b_sql"]] != \
            [tuple(r) for r in out["ml00b_counts"]]:
        raise AssertionError(f"SQL {out['ml00b_sql']} against groupBy "
                             f"{out['ml00b_counts']}")
    s_price, s_hood, rows = tuple(out["join"][0])
    if rows != n or not np.isclose(s_price, s_hood, rtol=1e-9) or \
            not np.isclose(s_price, float(np.nansum(cols["price"])),
                           rtol=1e-12):
        raise AssertionError(f"join: {out['join']}")
    if len(out["cross"]) != 3 * len(np.unique(cols["room_type"].astype(
            str))):
        raise AssertionError(f"crossJoin: {out['cross']}")
    want = np.corrcoef(cols["price"], cols["accommodates"])[0, 1]
    if not np.isclose(out["corr"], want, rtol=1e-12):
        raise AssertionError(f"corr {out['corr']} against {want}")


def ts_dedup(path: str, n: int, n_unique: int):
    """(d) ML 00L up to the parquet write: the people file written as a
    colon-separated CSV, read back, normalized and deduplicated; (the
    count, the deduplicated frame's columns)."""
    import shutil
    from sml_tpu_torch import functions as F
    from sml_tpu_torch.courseware import make_dedup_dataset
    from sml_tpu_torch.frame.session import get_session
    spark = get_session()
    shutil.rmtree(path, ignore_errors=True)
    make_dedup_dataset(n=n, n_unique=n_unique).write.option(
        "sep", ":").option("header", True).csv(path)
    df = (spark.read.option("header", "true").option("inferSchema", "true")
          .option("sep", ":").csv(path))
    deduped = (df.select(F.col("*"),
                         F.lower(F.col("firstName")).alias("lcFirstName"),
                         F.lower(F.col("lastName")).alias("lcLastName"),
                         F.lower(F.col("middleName")).alias("lcMiddleName"),
                         F.translate(F.col("ssn"), "-", "").alias("ssnNums"))
               .dropDuplicates(["lcFirstName", "lcMiddleName", "lcLastName",
                                "ssnNums", "gender", "birthDate", "salary"])
               .drop("lcFirstName", "lcMiddleName", "lcLastName",
                     "ssnNums"))
    return deduped.count(), deduped._whole()


def same_columns(a: dict, b: dict) -> bool:
    """Two blocks hold the same columns, dtypes and values (NaN equal)."""
    return list(a) == list(b) and all(
        a[c].dtype == b[c].dtype and (
            np.array_equal(a[c], b[c], equal_nan=True)
            if a[c].dtype.kind == "f" else bool(np.all(a[c] == b[c])))
        for c in a)


def phase_timeseries(seed: int, device, card: str, n: int = 100_000,
                     days: int = TS_QUICKSTART[1],
                     dedup=(103_000, 100_000)) -> dict:
    """Phase 15: MLE 04 and the frame's pandas-free remainder on `device`
    (the session's `sml.device`): (a) MLE 04 at the course's shape, (b)
    Prophet and ARIMA at the quick start's length, (c) the frame flows
    of ML 00b / ML 01L on `make_airbnb_dataset(n)`, (d) ML 00L's dedup;
    each held against the same run with the device set to the CPU, and
    timed first call / warm median. No kernel of the port launches and
    no plain version runs on the card. Smaller `n`, `days` and `dedup`
    rehearse it on the CPU."""
    import tempfile
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.native.hashing import hash_scalar
    from sml_tpu_torch.timeseries import Prophet
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    GLOBAL_CONF.set("sml.device", device.type)
    _zero_launches()
    t0 = time.perf_counter()
    out = {"card": card}
    with KernelWatch() as watch:
        # (a) MLE 04 at the course's shape
        _, y160 = ts_mle04()
        arima = fit_walls(lambda: ts_arima(y160, (1, 2, 1), device), device)
        cpu_arima = run_on_cpu(lambda: ts_arima(y160, (1, 2, 1), device))
        out["mle04_arima"] = ts_check_arima(
            "(a) MLE 04 ARIMA(1,2,1), 160 points", arima[0], cpu_arima,
            arima, card, ts_eval_ms(y160, (1, 2, 1), arima[0][0].params,
                                    device))
        fc = arima[0][0].forecast(10)
        if not (np.all(np.isfinite(fc)) and fc[-1] > y160[-1]):
            raise AssertionError(f"(a) forecast {fc}")
        mle04 = fit_walls(ts_mle04_run, device)
        cpu_mle04 = run_on_cpu(ts_mle04_run)
        adf, fc160, holt = mle04[0]
        if not adf[1] > 0.05 or fc160.count() != 170:
            raise AssertionError(f"(a) adf {adf[:2]}, {fc160.count()} rows")
        for k, v in holt.items():
            if not np.array_equal(v, cpu_mle04[2][k]):
                raise AssertionError(f"(a) Holt {k} differs card / CPU")
        out["mle04_prophet"] = ts_check_prophet(
            "(a) MLE 04 adfuller + Prophet (160 days + 10) + Holt x4",
            fc160, cpu_mle04[1], y160, mle04, card)
        # (b) the quick start's length
        ds, y, hol = ts_quickstart(seed, days)

        def prophet_fit():
            m = Prophet(holidays=hol).fit({"ds": ds, "y": y})
            return m, m.predict(m.make_future_dataframe(periods=365))
        prophet = fit_walls(prophet_fit, device)
        cpu_prophet = run_on_cpu(prophet_fit)
        if prophet[0][0]._block_names != ["yearly", "weekly", "holidays"]:
            raise AssertionError(f"(b) blocks {prophet[0][0]._block_names}")
        out["quickstart_prophet"] = ts_check_prophet(
            f"(b) Prophet, {days} days + 365, yearly/weekly/holidays",
            prophet[0][1], cpu_prophet[1], y, prophet, card)
        out["quickstart_prophet"]["busy"] = nt_busy(
            "Prophet quick start", prophet_fit, "program.prophet", card,
            device)
        arima_q = fit_walls(lambda: ts_arima(y, TS_QUICKSTART_ORDER, device),
                           device)
        cpu_arima_q = run_on_cpu(lambda: ts_arima(y, TS_QUICKSTART_ORDER,
                                                  device))
        out["quickstart_arima"] = ts_check_arima(
            f"(b) ARIMA{TS_QUICKSTART_ORDER}, {days} points", arima_q[0],
            cpu_arima_q, arima_q, card,
            ts_eval_ms(y, TS_QUICKSTART_ORDER, arima_q[0][0].params,
                       device))
        out["quickstart_arima"]["busy"] = nt_busy(
            "ARIMA quick start", lambda: ts_arima(y, TS_QUICKSTART_ORDER,
                                                  device),
            "program.arima", card, device)
        # (c) the frame flows
        frames = fit_walls(lambda: ts_frames(n), device)
        cpu_frames = run_on_cpu(lambda: ts_frames(n))
        if frames[0] != cpu_frames:
            raise AssertionError("(c) frame results differ card / CPU")
        ts_check_frames(frames[0], n)
        out["frames"] = {"first_ms": frames[1], "warm_ms": frames[2]}
        print(f"timeseries (c) ML 00b / ML 01L frame flows, {n} rows "
              f"(groupBy, SQL on a temp view, join, crossJoin, selectExpr, "
              f"stat.corr): first {frames[1]!r} ms / warm median "
              f"{frames[2]!r} ms; equal to numpy and to the CPU run; card "
              f"{card}")
        # (d) ML 00L's dedup
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "people-with-dups")
            dd = fit_walls(lambda: ts_dedup(path, *dedup), device)
            cpu_dd = run_on_cpu(lambda: ts_dedup(path, *dedup))
        count = dd[0][0]
        h = hash_scalar(str(count))
        h = h if h == -(1 << 31) else abs(h)
        if not same_columns(dd[0][1], cpu_dd[1]) or count != cpu_dd[0] \
                or count != dedup[1] or (
                dedup[1] == 100_000 and h != DEDUP_HASH):
            raise AssertionError(f"(d) dedup count {count}, hash {h}")
        out["dedup"] = {"count": count, "hash": h, "first_ms": dd[1],
                        "warm_ms": dd[2]}
        print(f"timeseries (d) ML 00L: {dedup[0]} rows written as a "
              f"colon-separated CSV, read back, deduplicated to {count} "
              f"(hash {h}, the course's {DEDUP_HASH}); first {dd[1]!r} ms "
              f"/ warm median {dd[2]!r} ms; card {card}")
    launches = _all_launches()
    if any(launches.values()) or watch.plain_on_cuda:
        raise AssertionError(f"phase 15 launched {launches}; plain "
                             f"versions on the card {watch.plain_on_cuda}")
    out["phase_s"] = time.perf_counter() - t0
    print(f"timeseries: every check passed in {out['phase_s']!r} s; no "
          f"kernel of the port launched ({launches}); TF32 off")
    return out


# -------------- phase 16: the fused featurizer, compact fits, ML 12 scoring
#: (b) the compact chain's rows (`tests/test_compact_linear.py:20-36` at
#: 4,194,304 rows: ~822 MB materialized, ~168 MB compact) and the rows of
#: the compact programs' card-against-CPU check
FZ_COMPACT_ROWS = 4_194_304
FZ_CHECK_ROWS = 65_536
#: card against CPU: the compact moments and coefficients within this
#: share of the largest
FZ_CARD_CPU_RTOL = 1e-9
#: (c) ML 12: batches of (a)'s 100,000 rows, the lookahead, and the
#: factorized scorer's tolerance against the block route
FZ_BATCHES = 10
FZ_DEPTH = 4
FZ_RTOL, FZ_ATOL = 1e-5, 1e-7
#: timed runs after each first one (their median is reported)
FZ_REPS = 3
#: every launch phase 16 makes, summed by kernel
FZ_LAUNCHES: dict = {}
#: the kernels on phase 16's paths: a forest fit's four and the traversal
FZ_KERNELS = FIT_KERNELS + ("forest_traverse",)


def fz_take() -> dict:
    """The launches since the counts were last zeroed (added to
    FZ_LAUNCHES), the counts zeroed again."""
    got = _all_launches()
    for k, v in got.items():
        FZ_LAUNCHES[k] = FZ_LAUNCHES.get(k, 0) + v
    _zero_launches()
    return got


def fz_ml03():
    """ML 03's one-hot LinearRegression pipeline."""
    from sml_tpu_torch.ml import LinearRegression
    from sml_tpu_torch.ml.feature import VectorAssembler
    return nt_prep() + [VectorAssembler(inputCols=NT_OHE + DF_IMP,
                                        outputCol="features"),
                        LinearRegression(labelCol="price")]


def fz_ml07():
    """ML 07's RandomForestRegressor pipeline (phase 11's)."""
    return df_prep() + [df_estimator("rf")]


def fz_same_fit(ta, tb) -> bool:
    """Whether two fitted models are equal bit for bit."""
    if hasattr(ta, "_coefficients"):
        return bool(np.array_equal(ta._coefficients, tb._coefficients)
                    and ta.intercept == tb.intercept)
    return len(ta._spec.trees) == len(tb._spec.trees) and all(
        np.array_equal(getattr(x, f), getattr(y, f))
        for x, y in zip(ta._spec.trees, tb._spec.trees)
        for f in ("split_feature", "split_bin", "leaf_value", "gain",
                  "cover"))


def fz_routes(train, test, device, card: str) -> tuple:
    """(a) ML 03's LR and ML 07's RF pipelines fused and stage by stage
    (`featurizer.stage_by_stage`), in turns: the first fit from empty
    caches (after one untimed fit), the median of FZ_REPS warm fits, and
    transform +
    RegressionEvaluator rmse (median of FZ_REPS); the fits bit-equal,
    the rmse equal and the launches equal. Returns (numbers, the fused
    pipeline models)."""
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.ml.featurizer import stage_by_stage
    ev = RegressionEvaluator(labelCol="price")
    out, models = {}, {}
    train._whole()  # the split's rows made before any timed fit
    test._whole()

    def in_route(route, fn):
        if route == "fused":
            return fn()
        with stage_by_stage():
            return fn()

    for name, stages in (("ml03_lr", fz_ml03), ("ml07_rf", fz_ml07)):
        fitted, rec = {}, {"fused": {}, "stage": {}}
        launches = {"fused": {}, "stage": {}}
        # one untimed fit pays the process's first calls (library set-up,
        # kernel loads), which would land on whichever route went first
        in_route("stage", lambda: Pipeline(stages=stages()).fit(train))
        for route in ("fused", "stage"):
            clear_fit_caches()
            fz_take()
            fitted[route], rec[route]["first_fit_ms"] = walled(
                lambda: in_route(route, lambda: Pipeline(
                    stages=stages()).fit(train)), device)
            launches[route]["fit"] = fz_take()
        warm = {"fused": [], "stage": []}
        evals = {"fused": [], "stage": []}
        rmse = {}
        for rep in range(FZ_REPS + 1):
            for route in ("fused", "stage"):
                if rep:
                    warm[route].append(walled(lambda: in_route(
                        route, lambda: Pipeline(stages=stages()).fit(train)),
                        device)[1])
                    fz_take()
                got, ms = walled(lambda: in_route(route, lambda: ev.evaluate(
                    fitted[route].transform(test))), device)
                if rep == 0:
                    rmse[route] = got
                    launches[route]["evaluate"] = fz_take()
                else:
                    evals[route].append(ms)
                    fz_take()
                    if got != rmse[route]:
                        raise AssertionError(f"{name}: {route} rmse moved")
        for route in ("fused", "stage"):
            rec[route]["warm_fit_ms"] = float(np.median(warm[route]))
            rec[route]["evaluate_ms"] = float(np.median(evals[route]))
            rec[route]["rmse"] = rmse[route]
            rec[route]["launches"] = launches[route]
        same = fz_same_fit(fitted["fused"].stages[-1],
                           fitted["stage"].stages[-1])
        f, st = rec["fused"], rec["stage"]
        print(f"featurizer (a) {name}: fit fused first "
              f"{f['first_fit_ms']!r} ms / warm median {f['warm_fit_ms']!r} "
              f"ms, stage by stage first {st['first_fit_ms']!r} / warm "
              f"{st['warm_fit_ms']!r} ms; transform + evaluate fused "
              f"{f['evaluate_ms']!r} ms, stage {st['evaluate_ms']!r} ms; "
              f"rmse {rmse['fused']!r} / {rmse['stage']!r}; fits bit-equal "
              f"{same}; launches fused {launches['fused']} stage "
              f"{launches['stage']}; card {card}")
        if not same or rmse["fused"] != rmse["stage"] or \
                launches["fused"] != launches["stage"]:
            raise AssertionError(f"{name}: the fused route differs from the "
                                 f"stage path")
        rec["fits_bit_equal"] = same
        out[name] = rec
        models[name] = fitted["fused"]
    return out, models


def fz_rel(a, b) -> float:
    """max |a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(float(np.max(np.abs(b))),
                                             1e-300))


def fz_compact(device, card: str, n: int = FZ_COMPACT_ROWS,
               check_rows: int = FZ_CHECK_ROWS,
               gate: Optional[int] = None) -> dict:
    """(b) the compact chain on `make_airbnb_dataset(n, seed=7)`: the
    fused fit's prep (`try_fast_fit`) at the default gate (the compact
    block) and with the gate at 1 << 40 (the materialized block), then
    LinearRegression on price and LogisticRegression(maxIter=12) on the
    binarized price from each: walls, host -> device bytes and peak
    device memory; coefficients within the CPU tests' tolerances; and
    the compact Gram and IRLS on the card against the CPU at
    `check_rows` rows. `gate` replaces the default gate on the compact
    side (a rehearsal's few rows stay below it)."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.dataframe import DataFrame
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import LinearRegression, LogisticRegression
    from sml_tpu_torch.ml import linear_impl
    from sml_tpu_torch.ml._staging import extract_compact, extract_xy
    from sml_tpu_torch.ml.featurizer import try_fast_fit
    from sml_tpu_torch.utils.profiler import PROFILER
    t0 = time.perf_counter()
    cols = make_airbnb_dataset(n=n, seed=7)
    cols["label"] = (cols["price"] > np.median(cols["price"])).astype(
        np.float64)
    raw = get_session().createDataFrame(cols)._whole()
    del cols
    out = {"rows": n, "made_ms": (time.perf_counter() - t0) * 1e3}
    fits = {}
    for route, at in (("compact", gate), ("materialized", 1 << 40)):
        if at is None:
            GLOBAL_CONF.unset("sml.linear.compactBytes")
        else:
            GLOBAL_CONF.set("sml.linear.compactBytes", at)
        (_, shim), prep_ms = walled(lambda: try_fast_fit(
            fz_ml03(), raw, lambda: DataFrame.from_partitions([raw])),
            device)
        if (getattr(shim, "_featurized_compact", None) is not None) != \
                (route == "compact"):
            raise AssertionError(f"{route}: the gate chose the other route")
        rec = {"prep_ms": prep_ms}
        for est_name, make in (
                ("linear", lambda: LinearRegression(labelCol="price")),
                ("logistic", lambda: LogisticRegression(labelCol="label",
                                                        maxIter=12))):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)
            before = PROFILER.counters().get("staging.h2d_bytes", 0.0)
            model, ms = walled(lambda: make().fit(shim), device)
            h2d = PROFILER.counters().get("staging.h2d_bytes", 0.0) - before
            peak = torch.cuda.max_memory_allocated(device) \
                if device.type == "cuda" else 0
            fits[(route, est_name)] = model
            rec[est_name] = {"fit_ms": ms, "h2d_bytes": h2d,
                             "peak_device_bytes": peak,
                             "iterations": getattr(model.summary,
                                                   "totalIterations", None)}
            print(f"featurizer (b) {route} {est_name} on {n} rows: prep "
                  f"{prep_ms!r} ms, fit {ms!r} ms, host -> device "
                  f"{h2d:.0f} bytes, peak device memory {peak} bytes; "
                  f"card {card}")
        # the device programs alone (the estimator's wall adds the host's
        # label extraction and summary)
        if route == "compact":
            parts, y = extract_compact(shim, "features", "price")
            _, yl = extract_compact(shim, "features", "label")
            programs = (
                lambda: linear_impl.fit_linear_compact(parts, y,
                                                       device=device),
                lambda: linear_impl.fit_logistic_compact(
                    parts, yl, maxIter=12, tol=1e-6, device=device))
        else:
            parts = None
            X, y, _ = extract_xy(shim, "features", "price")
            _, yl, _ = extract_xy(shim, "features", "label")
            programs = (
                lambda: linear_impl.fit_linear(X, y, device=device),
                lambda: linear_impl.fit_logistic(X, yl, maxIter=12,
                                                 tol=1e-6, device=device))
        for est_name, program in zip(("linear", "logistic"), programs):
            rec[est_name]["program_ms"] = walled(program, device)[1]
        print(f"featurizer (b) {route}: the programs alone, linear "
              f"{rec['linear']['program_ms']!r} ms, logistic "
              f"{rec['logistic']['program_ms']!r} ms; card {card}")
        k = min(check_rows, parts.num.shape[0]) \
            if route == "compact" else 0
        if k:
            sub = parts._replace(num=parts.num[:k], codes=parts.codes[:k],
                                 keep=None)
            moments = [linear_impl.gram_stats_compact(sub, y[:k], device=d)
                       for d in (device, "cpu")]
            lin = [linear_impl.fit_linear_compact(sub, y[:k], device=d)
                   for d in (device, "cpu")]
            logit = [linear_impl.fit_logistic_compact(
                sub, yl[:k], maxIter=12, tol=1e-6, device=d)
                for d in (device, "cpu")]
            rel = {"gram_A": fz_rel(moments[0][0], moments[1][0]),
                   "gram_b": fz_rel(moments[0][1], moments[1][1]),
                   "gram_yy": fz_rel(moments[0][3], moments[1][3]),
                   "linear_coefficients": fz_rel(
                       np.append(lin[0].coefficients, lin[0].intercept),
                       np.append(lin[1].coefficients, lin[1].intercept)),
                   "logistic_coefficients": fz_rel(
                       np.append(logit[0].coefficients, logit[0].intercept),
                       np.append(logit[1].coefficients, logit[1].intercept))}
            steps = (logit[0].iterations, logit[1].iterations)
            print(f"featurizer (b) card against CPU at {k} rows: relative "
                  f"differences {json.dumps(rel)}; IRLS steps {steps}")
            if max(rel.values()) > FZ_CARD_CPU_RTOL or steps[0] != steps[1]:
                raise AssertionError(f"compact card/CPU: {rel}, {steps}")
            out["card_cpu"] = dict(rel, rows=k, irls_steps=list(steps))
        out[route] = rec
        del shim, programs
    GLOBAL_CONF.unset("sml.linear.compactBytes")
    c_lin, m_lin = fits[("compact", "linear")], fits[("materialized",
                                                      "linear")]
    c_log, m_log = fits[("compact", "logistic")], fits[("materialized",
                                                        "logistic")]
    lin_equal = fz_same_fit(c_lin, m_lin)
    np.testing.assert_allclose(c_lin._coefficients, m_lin._coefficients,
                               rtol=1e-5, atol=1e-5)
    if abs(c_lin.intercept - m_lin.intercept) > 1e-5:
        raise AssertionError("(b) linear intercepts differ")
    np.testing.assert_allclose(c_log._coefficients, m_log._coefficients,
                               atol=5e-4)
    if abs(c_log.intercept - m_log.intercept) > 5e-4 or abs(
            c_log.summary.accuracy - m_log.summary.accuracy) >= 5e-3 or abs(
            c_log.summary.areaUnderROC - m_log.summary.areaUnderROC) >= 5e-3:
        raise AssertionError("(b) logistic fits differ")
    ratio = out["compact"]["linear"]["h2d_bytes"] / \
        out["materialized"]["linear"]["h2d_bytes"]
    out["linear_bit_equal"] = lin_equal
    out["logistic_max_coef_diff"] = float(np.max(np.abs(
        c_log._coefficients - m_log._coefficients)))
    out["h2d_ratio"] = ratio
    print(f"featurizer (b): compact against materialized: linear bit-equal "
          f"{lin_equal}, logistic max |coef diff| "
          f"{out['logistic_max_coef_diff']!r}, IRLS steps "
          f"{c_log.summary.totalIterations} / "
          f"{m_log.summary.totalIterations}; host -> device bytes compact / "
          f"materialized {ratio!r}")
    if ratio > 0.25:
        raise AssertionError(f"(b) the compact route copied {ratio} of the "
                             f"materialized route's bytes")
    return out


def fz_batches(models: dict, raw: dict, device, card: str) -> dict:
    """(c) ML 12: `score_batches` over the 100,000 raw rows in
    FZ_BATCHES batches at depth FZ_DEPTH, on the LR pipeline's factorized
    route, its block route on the card and the RF pipeline (one
    `forest_traverse` a batch); each concatenation against `score_block`
    of the whole; rows/s (median of FZ_REPS runs after a first) and the
    dispatch / drain order."""
    from sml_tpu_torch.ml.inference import DeviceScorer
    n = len(raw["price"])
    size = n // FZ_BATCHES
    batches = [{k: v[i:i + size] for k, v in raw.items()}
               for i in range(0, n, size)]
    lr_block = DeviceScorer(models["ml03_lr"], device=device)
    lr_block._factorized = None
    routes = {"lr_factorized": DeviceScorer(models["ml03_lr"],
                                            device=device),
              "lr_block": lr_block,
              "rf_block": DeviceScorer(models["ml07_rf"], device=device)}
    out = {}
    for route, scorer in routes.items():
        if (scorer._factorized is not None) != (route == "lr_factorized"):
            raise AssertionError(f"{route}: the scorer's route is wrong")
        whole = scorer.score_block(scorer._featurizer(raw))
        fz_take()
        order = []
        (outs, first) = walled(lambda: list(scorer.score_batches(
            batches, depth=FZ_DEPTH, order=order)), device)
        launches = fz_take()
        got = np.concatenate(outs)
        if route == "lr_factorized":
            ok = got.shape == whole.shape and np.allclose(
                got, whole, rtol=FZ_RTOL, atol=FZ_ATOL)
            err = float(np.max(np.abs(got - whole)))
        else:
            ok = np.array_equal(got, whole)
            err = 0.0 if ok else float(np.max(np.abs(got - whole)))
        walls = []
        for _ in range(FZ_REPS):
            walls.append(walled(lambda: list(scorer.score_batches(
                batches, depth=FZ_DEPTH)), device)[1])
            fz_take()
        ms = float(np.median(walls))
        ahead = all(order.index(("dispatch", i + 1))
                    < order.index(("drain", i))
                    for i in range(len(batches) - 1)) if order else None
        out[route] = {"first_ms": first, "ms": ms, "rows_per_s": n / ms * 1e3,
                      "max_abs_diff": err, "launches": launches,
                      "next_dispatch_before_drain": ahead,
                      "order": [f"{kind} {i}" for kind, i in order[:8]]}
        print(f"featurizer (c) {route}: {FZ_BATCHES} batches of {size} "
              f"rows at depth {FZ_DEPTH}: first {first!r} ms, median "
              f"{ms!r} ms ({n / ms * 1e3:.0f} rows/s); against score_block "
              f"of the whole: max |diff| {err!r}; launches {launches}; "
              f"order {order[:8]}; card {card}")
        if not ok or (order and not ahead):
            raise AssertionError(f"{route}: batches {ok}, overlap {ahead}")
        if route == "rf_block" and launches["forest_traverse"] != FZ_BATCHES:
            raise AssertionError(f"rf_block: {launches['forest_traverse']} "
                                 f"traversals for {FZ_BATCHES} batches")
    return out


def phase_featurizer(device, card: str, compact_rows: int = FZ_COMPACT_ROWS,
                     n: int = 100_000, gate: Optional[int] = None) -> dict:
    """Phase 16: (a) the fused pipeline fit and transform against the
    stage path, (b) the compact linear fits, (c) ML 12's batch scoring,
    on `device` (the session's `sml.device`). Smaller `compact_rows` and
    `n`, with a `gate` below the compact block, rehearse it on the
    CPU."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.session import get_session
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on")
    GLOBAL_CONF.set("sml.device", device.type)
    FZ_LAUNCHES.clear()
    _zero_launches()
    t0 = time.perf_counter()
    with KernelWatch() as watch:
        train, test = df_splits(n)
        routes, models = fz_routes(train, test, device, card)
        raw = get_session().createDataFrame(
            make_airbnb_dataset(n=n, seed=42))._whole()
        batches = fz_batches(models, raw, device, card)
        compact = fz_compact(device, card, compact_rows, gate=gate)
        # the same chain below the default gate (the compact side forced)
        compact["below_gate"] = fz_compact(device, card, n, check_rows=0,
                                           gate=0)
    fz_take()
    if watch.plain_on_cuda:
        raise AssertionError(f"plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    missing = [k for k in FZ_KERNELS if not FZ_LAUNCHES.get(k)]
    if missing:
        raise AssertionError(f"phase 16 never launched {missing}")
    out = {"routes": routes, "batches": batches, "compact": compact,
           "launches": dict(FZ_LAUNCHES),
           "phase_s": time.perf_counter() - t0}
    print(f"featurizer: every check passed in {out['phase_s']!r} s; "
          f"launches {FZ_LAUNCHES}")
    return out


#: phase 17: the registered model's name, the requests of each serving
#: check (phase 4's: 1-64 held-out rows each), the clients, the canary
#: fractions and the AutoML rows (checked card against CPU, then timed
#: on the card alone) and trials
REG_NAME = "airbnb-price"
REG_REQUESTS = 96
REG_CLIENTS = 8
REG_CANARY = (1.0, 0.25)
REG_AUTOML_ROWS = (10_000, 100_000)
REG_AUTOML_TRIALS = 3
REG_AUTOML_COLS = ("bedrooms", "accommodates", "room_type", "price")
#: every launch phase 17 makes on its two paths, by kernel
REG_LAUNCHES: dict = {"endpoint": {}, "automl": {}}
REG_KERNELS = FIT_KERNELS + ("forest_traverse",)


def reg_take(path: str) -> dict:
    """The launches since the counts were last zeroed, added to
    REG_LAUNCHES[path]; the counts zeroed again."""
    got = _all_launches()
    for k, v in got.items():
        REG_LAUNCHES[path][k] = REG_LAUNCHES[path].get(k, 0) + v
    _zero_launches()
    return got


def reg_requests(X: np.ndarray, seed: int = 17) -> list:
    """Phase 4's traffic shape: REG_REQUESTS requests of 1-64 rows,
    consecutive slices of the held-out rows."""
    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 65, size=REG_REQUESTS)
    offs = np.concatenate([[0], np.cumsum(sizes)])
    return [X[offs[i]:offs[i + 1]] for i in range(len(sizes))]


def reg_refs(scorer, reqs: list) -> list:
    """`score_block` of every request's rows (one launch over them all,
    split back: a row's traversal does not depend on its batch mates)."""
    out = scorer.score_block(np.concatenate(reqs, axis=0))
    offs = np.cumsum([0] + [len(r) for r in reqs])
    return [out[offs[i]:offs[i + 1]] for i in range(len(reqs))]


def reg_serve(ep, reqs: list, refs: list, waves: bool) -> np.ndarray:
    """Send `reqs` from REG_CLIENTS threads: all at once (phase 4's
    burst), or with `waves`, REG_CLIENTS at a time with the canary's
    mirrors drained between waves (so no mirror finds the shadow's
    backlog full). Every response must equal its reference bit for bit;
    returns each request's latency in ms (submit to result, host
    clock)."""
    lat = np.zeros(len(reqs))
    got = [None] * len(reqs)

    def one(i):
        t0 = time.perf_counter()
        got[i] = ep.submit(reqs[i]).result(60)
        lat[i] = (time.perf_counter() - t0) * 1e3

    def run(idx):
        width = min(REG_CLIENTS, len(idx))
        barrier = threading.Barrier(width)

        def client(lo):
            barrier.wait()
            for i in idx[lo::width]:
                one(i)
        threads = [threading.Thread(target=client, args=(lo,))
                   for lo in range(width)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            raise AssertionError("a serving client did not finish")

    if not waves:
        run(list(range(len(reqs))))
    else:
        for lo in range(0, len(reqs), REG_CLIENTS):
            run(list(range(lo, min(lo + REG_CLIENTS, len(reqs)))))
            reg_drain(ep)
    for i, (g, want) in enumerate(zip(got, refs)):
        if not np.array_equal(g, want):
            raise AssertionError(f"endpoint response {i} differs from "
                                 f"score_block of its rows")
    return lat


def reg_drain(ep, timeout: float = 60.0) -> dict:
    """The canary stats once every queued mirror has finished."""
    end = time.perf_counter() + timeout
    while ep._shadow_inflight and time.perf_counter() < end:
        time.sleep(0.001)
    if ep._shadow_inflight:
        raise AssertionError("the canary's mirrors did not drain")
    return ep.canary_stats()


def reg_percentiles(lat: np.ndarray) -> dict:
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "max_ms": float(lat.max())}


def reg_endpoint(device, card: str, n: int) -> dict:
    """(a) Two registered versions of a model served on `device`
    through `ServingEndpoint`: the burst, the promote under load, and
    the canary at REG_CANARY."""
    from sml_tpu_torch import functions as F
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml._staging import extract_features
    from sml_tpu_torch.ml.inference import DeviceScorer
    from sml_tpu_torch.native import host_traverse as ht
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.serving import ModelCache, ServingEndpoint
    from sml_tpu_torch.utils.profiler import PROFILER
    from sml_tpu_torch.conf import GLOBAL_CONF

    def counter(name):
        return PROFILER.counters().get(name, 0.0)

    out = {}
    train, test = df_splits(n)
    _zero_launches()
    t0 = time.perf_counter()
    v1 = Pipeline(stages=df_prep() + [df_estimator("xgb")]).fit(
        train.withColumn("label", F.log(F.col("price"))))
    v2 = Pipeline(stages=df_prep() + [df_estimator("rf")]).fit(train)
    fits = reg_take("endpoint")
    want = {k: FITS["xgb"][2][k] + FITS["rf"][2][k] for k in FITS["rf"][2]}
    if {k: fits[k] for k in want} != want or fits["forest_traverse"]:
        raise AssertionError(f"the two fits launched {fits}, not {want}")
    out["fit_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for model in (v1, v2):
        with mlflow.start_run():
            mlflow.spark.log_model(model, "model",
                                   registered_model_name=REG_NAME)
    client = mlflow.MlflowClient()
    client.transition_model_version_stage(REG_NAME, 1, "Production")
    out["log_register_ms"] = (time.perf_counter() - t0) * 1e3
    X = extract_features(_prepped(v1, test), "features")
    if not np.array_equal(X, extract_features(_prepped(v2, test),
                                              "features")):
        raise AssertionError("the two versions assemble other features")
    reqs = reg_requests(X)
    ref1 = reg_refs(DeviceScorer(v1, device=device), reqs)
    ref2 = reg_refs(DeviceScorer(v2, device=device), reqs)
    _zero_launches()  # the references' launches are not the path's

    cache = ModelCache()
    shed0, swaps0 = counter("serve.shed"), counter("serve.hot_swap")
    t0 = time.perf_counter()
    ep = ServingEndpoint(REG_NAME, "Production", model_cache=cache,
                         max_batch_rows=4096, flush_micros=2000)
    out["open_ms"] = (time.perf_counter() - t0) * 1e3
    try:
        if ep.device != device:
            raise AssertionError(f"the endpoint serves on {ep.device}")
        batches0 = counter("serve.batches")
        lat = reg_serve(ep, reqs, ref1, waves=False)
        out["burst"] = dict(reg_percentiles(lat), requests=len(reqs),
                            batches=int(counter("serve.batches")
                                        - batches0))
        kernel = ep.health_report()["endpoint"]["kernel"]
        if device.type == "cuda" and not (kernel and kernel.get("path")):
            raise AssertionError(f"no traversal plan reported: {kernel}")
        out["kernel"] = kernel

        # promote v2 while three clients score; every response is one
        # version's, and the endpoint swaps once
        stop = threading.Event()
        seen, torn = set(), []

        def racer(k):
            i = k
            while not stop.is_set():
                i = (i + 3) % len(reqs)
                g = ep.score(reqs[i], timeout=60)
                if np.array_equal(g, ref1[i]):
                    seen.add(1)
                elif np.array_equal(g, ref2[i]):
                    seen.add(2)
                else:
                    torn.append(i)
        threads = [threading.Thread(target=racer, args=(k,))
                   for k in range(3)]
        for t in threads:
            t.start()
        end = time.perf_counter() + 30
        while 1 not in seen and time.perf_counter() < end:
            time.sleep(0.001)
        t0 = time.perf_counter()
        client.transition_model_version_stage(
            REG_NAME, 2, "Production", archive_existing_versions=True)
        out["promote_ms"] = (time.perf_counter() - t0) * 1e3
        while 2 not in seen and time.perf_counter() < end:
            time.sleep(0.001)
        stop.set()
        for t in threads:
            t.join(timeout=60)
        if any(t.is_alive() for t in threads) or torn or seen != {1, 2}:
            raise AssertionError(f"promote under load: seen {seen}, "
                                 f"{len(torn)} torn responses")
        swaps = counter("serve.hot_swap") - swaps0
        if ep.current_version() != 2 or swaps != 1 or \
                cache.stats()["entries"] != 1:
            raise AssertionError(
                f"after the promote: version {ep.current_version()}, "
                f"{swaps} swaps, cache {cache.stats()}")
        out["swap"] = {"hot_swaps": int(swaps), "cache": cache.stats()}

        # the canary: off, then v1 in Staging at each fraction
        lat = reg_serve(ep, reqs, ref2, waves=True)
        out["canary_off"] = reg_percentiles(lat)
        client.transition_model_version_stage(REG_NAME, 1, "Staging")
        before = ep.canary_stats()
        if before["staging_version"] != 1 or before["mirrored"]:
            raise AssertionError(f"Staging not bound: {before}")
        for frac in REG_CANARY:
            GLOBAL_CONF.set("sml.serve.canaryFraction", frac)
            l0, b0 = tk.LAUNCHES, counter("serve.batches")
            m0, h0 = counter("serve.canary_mirrored"), ht.CALLS
            lat = reg_serve(ep, reqs, ref2, waves=True)
            stats = reg_drain(ep)
            mirrored = stats["mirrored"] - before["mirrored"]
            launches = tk.LAUNCHES - l0
            batches = counter("serve.batches") - b0
            host_scored = counter("serve.canary_mirrored") - m0
            if mirrored != round(frac * len(reqs)) or stats["errors"] \
                    or not stats["mean_abs_diff"] > 0:
                raise AssertionError(f"canary at {frac}: {stats}")
            # the mirrors take the Staging scorer's host route: every one
            # a host traversal, none a launch on the card
            if launches != batches or host_scored != mirrored \
                    or ht.CALLS - h0 != mirrored:
                raise AssertionError(
                    f"canary at {frac}: {launches} traversals for "
                    f"{batches} batches; {mirrored} mirrors, "
                    f"{host_scored} host-scored, "
                    f"{ht.CALLS - h0} host traversals")
            out[f"canary_{frac}"] = dict(
                reg_percentiles(lat), mirrored=mirrored,
                primary_launches=int(batches), mirror_launches=0,
                mirror_host_scored=int(host_scored),
                mean_abs_diff=stats["mean_abs_diff"],
                max_abs_diff=stats["max_abs_diff"],
                errors=stats["errors"])
            before = stats
    finally:
        GLOBAL_CONF.unset("sml.serve.canaryFraction")
        ep.close()
    reg_take("endpoint")
    out["sheds"] = int(counter("serve.shed") - shed0)
    if out["sheds"]:
        raise AssertionError(f"{out['sheds']} requests shed")
    out["health"] = {k: v for k, v in ep.health_report()["endpoint"].items()
                     if k != "canary"}
    for what in ("burst", "canary_off") + tuple(
            f"canary_{f}" for f in REG_CANARY):
        got = out[what]
        print(f"registry endpoint {what}: p50 {got['p50_ms']!r} ms p99 "
              f"{got['p99_ms']!r} ms max {got['max_ms']!r} ms"
              + (f"; mirrored {got['mirrored']} on the host route, "
                 f"launches primary {got['primary_launches']} + mirror "
                 f"{got['mirror_launches']}, mean |diff| "
                 f"{got['mean_abs_diff']!r}" if "mirrored" in got else "")
              + f" [{card}]")
    print(f"registry endpoint: promote {out['promote_ms']!r} ms, swaps 1, "
          f"cache {cache.stats()}, sheds 0, plan {out['kernel']}")
    return out


def reg_automl_frame(n: int):
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.session import get_session
    d = make_airbnb_dataset(n=n, seed=42)
    return get_session().createDataFrame({c: d[c] for c in REG_AUTOML_COLS})


def reg_automl(device, card: str, rows=REG_AUTOML_ROWS) -> dict:
    """(b) `automl.regress` on the card and on the CPU at rows[0]: the
    same families and parameters, val_rmse within the pipeline rules;
    the best model loaded through `runs:/` and scored on the card; then
    the card alone at rows[1]."""
    from sml_tpu_torch import automl
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.conf import GLOBAL_CONF
    out = {}
    frame = reg_automl_frame(rows[0])
    _zero_launches()
    runs = {}
    for dev in (device.type, "cpu"):
        GLOBAL_CONF.set("sml.device", dev)
        t0 = time.perf_counter()
        runs[dev] = automl.regress(frame, target_col="price",
                                   max_trials=REG_AUTOML_TRIALS,
                                   experiment_name=f"automl-{dev}")
        out[f"wall_ms_{dev}"] = (time.perf_counter() - t0) * 1e3
        if dev == device.type:
            reg_take("automl")
    GLOBAL_CONF.set("sml.device", device.type)
    card_run, cpu_run = runs[device.type], runs["cpu"]
    trials = []
    for a, b in zip(card_run.trials, cpu_run.trials):
        if a.model_description != b.model_description or \
                a.params != b.params:
            raise AssertionError(f"trials differ: {a.params} / {b.params}")
        got, want = a.metrics["val_rmse"], b.metrics["val_rmse"]
        tol = 1e-3 * want if a.model_description == "gbt" \
            else max(1e-3, 1e-5 * abs(want))
        if not abs(got - want) <= tol:
            raise AssertionError(f"{a.model_description} val_rmse card "
                                 f"{got!r} CPU {want!r}")
        trials.append({"family": a.model_description,
                       "depth": int(a.params["depth"]),
                       "trees": int(a.params["trees"]),
                       "val_rmse_card": got, "val_rmse_cpu": want})
    if len(trials) != REG_AUTOML_TRIALS:
        raise AssertionError(f"{len(trials)} trials")
    out["trials"] = trials
    best = card_run.best_trial.mlflow_run_id
    pred = mlflow.pyfunc.load_model(f"runs:/{best}/model").predict(frame)
    if pred.shape != (rows[0],) or not np.isfinite(pred).all():
        raise AssertionError(f"the best model scored {pred.shape}")
    reg_take("automl")
    t0 = time.perf_counter()
    big = automl.regress(reg_automl_frame(rows[1]), target_col="price",
                         max_trials=REG_AUTOML_TRIALS,
                         experiment_name="automl-timed")
    out["timed_rows"] = rows[1]
    out["timed_wall_ms"] = (time.perf_counter() - t0) * 1e3
    out["timed_val_rmse"] = [t.metrics["val_rmse"] for t in big.trials]
    reg_take("automl")
    print(f"registry automl: {rows[0]} rows on {device.type} "
          f"{out['wall_ms_' + device.type]!r} ms, CPU "
          f"{out['wall_ms_cpu']!r} ms, trials {trials}; {rows[1]} rows on "
          f"{device.type} {out['timed_wall_ms']!r} ms [{card}]")
    return out


def phase_registry(device, card: str, n: int = 100_000,
                   automl_rows=REG_AUTOML_ROWS) -> dict:
    """Phase 17: the registry, the endpoint and AutoML on `device` (the
    session's `sml.device`), in a temporary tracking directory. Smaller
    `n` and `automl_rows` rehearse it on the CPU."""
    import shutil
    import tempfile
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.conf import GLOBAL_CONF
    GLOBAL_CONF.set("sml.device", device.type)
    for path in REG_LAUNCHES.values():
        path.clear()
    root = tempfile.mkdtemp(prefix="sml-registry-")
    mlflow.set_tracking_uri(root)
    t0 = time.perf_counter()
    try:
        with KernelWatch() as watch:
            endpoint = reg_endpoint(device, card, n)
            am = reg_automl(device, card, automl_rows)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if watch.plain_on_cuda:
        raise AssertionError(f"plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    for path, counts in REG_LAUNCHES.items():
        missing = [k for k in REG_KERNELS if not counts.get(k)]
        if missing:
            raise AssertionError(f"phase 17's {path} path never launched "
                                 f"{missing}")
    out = {"endpoint": endpoint, "automl": am,
           "launches": {k: dict(v) for k, v in REG_LAUNCHES.items()},
           "phase_s": time.perf_counter() - t0}
    print(f"registry: every check passed in {out['phase_s']!r} s; "
          f"launches {out['launches']}")
    return out


#: phase 18: the rows of the host/card comparison, the saturation bound
#: (rows queued or in flight toward the card), the waves of the
#: auto-tuning comparison, and the prewarm child's fit and requests
DSP_ROWS = (64, 4096, 100_000)
DSP_QUEUE_ROWS = 256
DSP_WAVES = 12
DSP_REPS = 5
#: every launch phase 18 makes (its (b)-(d) and (f)), by kernel
DSP_LAUNCHES: dict = {}

PREWARM_CHILD = r"""
import json, sys, time
t_start = time.perf_counter()
import numpy as np
import torch
sys.path.insert(0, ROOT)
import chip_smoke as cs
from sml_tpu_torch.conf import GLOBAL_CONF
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.parallel import prewarm
from sml_tpu_torch.serving import MicroBatcher
GLOBAL_CONF.set("sml.prewarm.enabled", MODE == "on")
dev = torch.device("cuda", 0)
out = {"mode": MODE, "import_s": time.perf_counter() - t_start}
model, cats = cs.ml11_model(SEED)
X, _ = cs.ml11_rows(np.random.default_rng([SEED, 18]), 4096, cats)
Xf, logy, fcats = cs.fit_rows(SEED)
Xf, logy = Xf[:80_000], logy[:80_000]
t0 = time.perf_counter()
stats = prewarm.maybe_prewarm(block=True, device=dev)
out["prewarm_ms"] = (time.perf_counter() - t0) * 1e3
out["prewarm"] = stats
t0 = time.perf_counter()
scorer = DeviceScorer(model, device=dev)
out["scorer_ms"] = (time.perf_counter() - t0) * 1e3
walls = []
with MicroBatcher(scorer.score_block, host_score=scorer.score_block_host,
                  flush_micros=0) as b:
    for i in range(1 + cs.DSP_REPS):
        rows = X[64 * i:64 * (i + 1)]
        t0 = time.perf_counter()
        got = b.submit(rows).result(60)
        walls.append((time.perf_counter() - t0) * 1e3)
        assert got.shape == (64,) and np.isfinite(got).all()
out["first_request_ms"] = walls[0]
out["warm_request_ms"] = float(np.median(walls[1:]))
fits = []
for _ in range(2):
    t0 = time.perf_counter()
    cs._fit_xgb(Xf, logy, fcats, dev)
    torch.cuda.synchronize()
    fits.append((time.perf_counter() - t0) * 1e3)
out["first_fit_ms"], out["warm_fit_ms"] = fits
out["recorded"] = len(prewarm.entries())
print(json.dumps(out))
"""


def dsp_burst(submit, reqs: list, clients: int = REG_CLIENTS) -> tuple:
    """Phase 4's burst: `clients` threads submit every request at once
    (each its share, without waiting); returns (futures, latencies in ms,
    submit to result)."""
    futs, t_sub = [None] * len(reqs), [0.0] * len(reqs)
    barrier = threading.Barrier(clients)

    def client(lo):
        barrier.wait()
        for i in range(lo, len(reqs), clients):
            t_sub[i] = time.perf_counter()
            futs[i] = submit(reqs[i])
    threads = [threading.Thread(target=client, args=(lo,))
               for lo in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    lat = np.zeros(len(reqs))
    for i, f in enumerate(futs):
        try:
            f.result(60)
        except Exception:  # noqa: BLE001 — a shed is counted by the caller
            pass
        lat[i] = (time.perf_counter() - t_sub[i]) * 1e3
    return futs, lat


def dsp_waves(submit, reqs: list, clients: int = REG_CLIENTS) -> np.ndarray:
    """Phase 17's waves: `clients` requests at a time, one a client, each
    wave after the last has been answered; latencies in ms."""
    lat = np.zeros(len(reqs))
    for lo in range(0, len(reqs), clients):
        idx = list(range(lo, min(lo + clients, len(reqs))))
        barrier = threading.Barrier(len(idx))

        def one(i):
            barrier.wait()
            t0 = time.perf_counter()
            submit(reqs[i]).result(60)
            lat[i] = (time.perf_counter() - t0) * 1e3
        threads = [threading.Thread(target=one, args=(i,)) for i in idx]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    return lat


def dsp_take() -> dict:
    got = _all_launches()
    for k, v in got.items():
        DSP_LAUNCHES[k] = DSP_LAUNCHES.get(k, 0) + v
    _zero_launches()
    return got


def dsp_calibration(device, card: str, scorer, X) -> dict:
    """(a) The dispatcher's calibration of the card and its answer: every
    audited scoring and evaluation decision on the card, "local-chip"."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.parallel import dispatch as pd
    used = pd.CALIBRATION.ensure(device).constants()
    fresh = pd._Calibration()
    fresh.ensure(device)
    fresh = fresh.constants()
    hint = scorer._hint(X[:64])
    reason = pd.preroute_reason(hint, device)
    if pd.preroute(hint, device) != "device" or reason != "local-chip":
        raise AssertionError(f"preroute {pd.preroute(hint, device)} "
                             f"({reason}), calibration {used}")
    GLOBAL_CONF.set("sml.obs.enabled", True)
    obs.reset()
    try:
        for n in DSP_ROWS:
            scorer.score_block(X[:n])
        pred = scorer.score_block(X[:20_000])
        df = get_session().createDataFrame(
            {"prediction": pred, "label": pred + 0.1})
        for metric in ("rmse", "r2"):
            RegressionEvaluator(metricName=metric).evaluate(df)
        recs = obs.audit_records()
        routes = sorted({(r.kind, r.route, r.reason) for r in recs})
        if len(recs) != len(DSP_ROWS) + 3 or routes != [
                ("blas", "device", "local-chip"),
                ("traverse", "device", "local-chip")]:
            raise AssertionError(f"audited decisions: {routes} "
                                 f"({len(recs)})")
    finally:
        GLOBAL_CONF.unset("sml.obs.enabled")
        obs.reset()
    out = {"rt_fixed_us": used["rt_fixed_s"] * 1e6,
           "rt_measured_us": used["rt_measured_s"] * 1e6,
           "h2d_GBps": used["h2d_bytes_per_s"] / 1e9,
           "d2h_GBps": used["d2h_bytes_per_s"] / 1e9,
           "again_rt_measured_us": fresh["rt_measured_s"] * 1e6,
           "again_h2d_GBps": fresh["h2d_bytes_per_s"] / 1e9,
           "again_d2h_GBps": fresh["d2h_bytes_per_s"] / 1e9,
           "preroute": "device", "reason": reason,
           "audited_device": len(recs)}
    print(f"dispatch (a) calibration: round trip {out['rt_measured_us']!r} "
          f"us (rt_fixed {out['rt_fixed_us']!r} us, floored at 100), "
          f"H2D {out['h2d_GBps']!r} GB/s, D2H {out['d2h_GBps']!r} GB/s "
          f"(first taking); again: {out['again_rt_measured_us']!r}"
          f" us, {out['again_h2d_GBps']!r} / {out['again_d2h_GBps']!r} "
          f"GB/s; preroute device ({reason}), {len(recs)} audited "
          f"decisions all on the card [{card}]")
    return out


def dsp_host_mode(device, card: str, scorer, X) -> dict:
    """(b) `sml.dispatch.mode=host`: `score_block` through the C++ host
    traversal, bit-equal to the card's, timed beside it; the regression
    statistics on the host route against the card's."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.native import host_traverse as ht
    from sml_tpu_torch.native import traverse_kernel as tk
    out = {}
    for n in DSP_ROWS:
        rows = X[:n]
        card_ms, host_ms = [], []
        on_card = scorer.score_block(rows)  # the binned rows are memoized
        l0, h0 = tk.LAUNCHES, ht.CALLS
        for _ in range(DSP_REPS):
            t0 = time.perf_counter()
            on_card = scorer.score_block(rows)
            card_ms.append((time.perf_counter() - t0) * 1e3)
        GLOBAL_CONF.set("sml.dispatch.mode", "host")
        try:
            for _ in range(DSP_REPS):
                t0 = time.perf_counter()
                host = scorer.score_block(rows)
                host_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            GLOBAL_CONF.unset("sml.dispatch.mode")
        if tk.LAUNCHES - l0 != DSP_REPS or ht.CALLS - h0 != DSP_REPS:
            raise AssertionError(f"{n} rows: {tk.LAUNCHES - l0} launches, "
                                 f"{ht.CALLS - h0} host traversals")
        np.testing.assert_array_equal(host, on_card)
        np.testing.assert_array_equal(scorer.score_block_host(rows),
                                      on_card)
        out[n] = {"host_ms": float(np.median(host_ms)),
                  "card_ms": float(np.median(card_ms))}
        print(f"dispatch (b) mode=host score_block {n} rows: host "
              f"{out[n]['host_ms']!r} ms, card {out[n]['card_ms']!r} ms "
              f"(medians of {DSP_REPS}, binned rows memoized), bit-equal "
              f"[{card}]")
    pred = scorer.score_block(X)
    df = get_session().createDataFrame(
        {"prediction": pred, "label": pred + np.sin(np.arange(len(pred)))})
    metrics = {}
    for metric in ("rmse", "mae", "r2"):
        ev = RegressionEvaluator(metricName=metric)
        on_card = ev.evaluate(df)
        GLOBAL_CONF.set("sml.dispatch.mode", "host")
        try:
            on_host = ev.evaluate(df)
        finally:
            GLOBAL_CONF.unset("sml.dispatch.mode")
        if not abs(on_host - on_card) <= 1e-12 * abs(on_card):
            raise AssertionError(f"{metric}: host {on_host!r} card "
                                 f"{on_card!r}")
        metrics[metric] = {"card": on_card, "host": on_host}
    out["evaluator"] = metrics
    print(f"dispatch (b) RegressionEvaluator host against card: {metrics}")
    return out


def dsp_saturation(device, card: str, scorer, X, reqs, refs) -> dict:
    """(c) Phase 4's burst against a 256-row bound: the overflow on the
    host route (no shed, the card's bits, a launch a flushed batch), then
    with the fallback off (sheds)."""
    from sml_tpu_torch.native import traverse_kernel as tk
    from sml_tpu_torch.parallel.dispatch import DEVICE_QUEUE
    from sml_tpu_torch.serving import MicroBatcher
    from sml_tpu_torch.utils.profiler import PROFILER

    def counter(name):
        return PROFILER.counters().get(name, 0.0)
    out = {}
    for fallback in (True, False):
        c0 = {k: counter(k) for k in ("serve.shed", "serve.host_routed",
                                      "serve.batches")}
        l0 = tk.LAUNCHES
        with MicroBatcher(scorer.score_block,
                          host_score=scorer.score_block_host,
                          host_fallback=fallback, queue_rows=DSP_QUEUE_ROWS,
                          max_batch_rows=4096, flush_micros=2000) as b:
            futs, lat = dsp_burst(b.submit, reqs)
        got = {k: counter(k) - v for k, v in c0.items()}
        launches = tk.LAUNCHES - l0
        if DEVICE_QUEUE.rows():
            raise AssertionError(f"{DEVICE_QUEUE.rows()} rows left queued")
        if launches != got["serve.batches"]:
            raise AssertionError(f"{launches} launches for "
                                 f"{got['serve.batches']} batches")
        if fallback:
            if got["serve.shed"] or not got["serve.host_routed"]:
                raise AssertionError(f"with the fallback: {got}")
            for i, (f, want) in enumerate(zip(futs, refs)):
                if not np.array_equal(f.result(1), want):
                    raise AssertionError(f"response {i} is not score_block's")
        elif not got["serve.shed"] or got["serve.host_routed"]:
            raise AssertionError(f"without the fallback: {got}")
        key = "fallback_on" if fallback else "fallback_off"
        out[key] = dict(reg_percentiles(lat), launches=int(launches),
                        **{k.split(".")[1]: int(v) for k, v in got.items()})
        print(f"dispatch (c) queueRows {DSP_QUEUE_ROWS}, hostFallback "
              f"{fallback}: {out[key]} [{card}]")
    return out


def dsp_autotune(device, card: str, scorer, reqs) -> dict:
    """(d) Phase 17's waves of 8 with `sml.serve.flushAutoTune` off and on
    (the recorder on for both: the tuner reads its histograms)."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.serving import MicroBatcher
    out = {}
    GLOBAL_CONF.set("sml.obs.enabled", True)
    try:
        for auto in (False, True):
            obs.reset()
            with MicroBatcher(scorer.score_block,
                              host_score=scorer.score_block_host,
                              flush_auto=auto, max_batch_rows=4096,
                              flush_micros=2000) as b:
                lat = dsp_waves(b.submit, reqs[:DSP_WAVES * REG_CLIENTS])
                flush = b.flush_micros
            key = "auto" if auto else "fixed"
            out[key] = dict(reg_percentiles(lat), final_flush_micros=flush)
            print(f"dispatch (d) waves of {REG_CLIENTS}, flushAutoTune "
                  f"{auto}: {out[key]} [{card}]")
    finally:
        GLOBAL_CONF.unset("sml.obs.enabled")
        obs.reset()
    return out


def dsp_prewarm(seed: int, card: str) -> dict:
    """(e) In fresh processes, the first 64-row request's wall and the
    first ML 11 fit's wall with `sml.prewarm.enabled` off and on. Both
    use the checkout's manifest (`native/build/`), as phases 1-17 left it
    (written out first); the first process adds its own entries, and the
    second replays them all before its first request."""
    from sml_tpu_torch.parallel import prewarm
    prewarm.flush()
    left = len(prewarm.entries())
    root = os.path.dirname(os.path.abspath(__file__))
    out = {"manifest_entries_before": left}
    for mode in ("off", "on"):
        code = (PREWARM_CHILD.replace("ROOT", repr(root))
                .replace("MODE", repr(mode))
                .replace("SEED", repr(seed)))
        proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise AssertionError(f"prewarm child ({mode}) failed:\n"
                                 f"{proc.stderr[-4000:]}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        out[mode] = got
        print(f"dispatch (e) prewarm {mode}: first request "
              f"{got['first_request_ms']!r} ms (warm "
              f"{got['warm_request_ms']!r}), first ML 11 fit "
              f"{got['first_fit_ms']!r} ms (warm {got['warm_fit_ms']!r})"
              f", prewarm {got['prewarm_ms']!r} ms {got['prewarm']}, "
              f"{got['recorded']} manifest entries ({left} left by phases "
              f"1-17) [{card}]")
    if not out["on"]["prewarm"] or not out["on"]["prewarm"]["replayed"] \
            or out["on"]["prewarm"]["failed"]:
        raise AssertionError(f"the replay: {out['on']['prewarm']}")
    return out


def dsp_recorder(device, card: str, scorer, reqs, refs) -> dict:
    """(f) Phase 4's burst with the recorder off and on: percentiles,
    events recorded, each flush span naming its requests' traces, no
    stall, and the dispatch audit's report."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.serving import MicroBatcher
    out = {}
    for on in (False, True):
        if on:
            GLOBAL_CONF.set("sml.obs.enabled", True)
        obs.reset()
        try:
            with MicroBatcher(scorer.score_block,
                              host_score=scorer.score_block_host,
                              max_batch_rows=4096, flush_micros=2000) as b:
                futs, lat = dsp_burst(b.submit, reqs)
            for i, (f, want) in enumerate(zip(futs, refs)):
                if not np.array_equal(f.result(1), want):
                    raise AssertionError(f"response {i} is not score_block's")
            events = obs.RECORDER.events()
            key = "on" if on else "off"
            out[key] = dict(reg_percentiles(lat), events=len(events))
            if on:
                batches = [e for e in events if e.name == "serve.batch"]
                traced = sorted(t for e in batches
                                for t in e.args["parent_traces"])
                if traced != sorted(f.trace_id for f in futs):
                    raise AssertionError("the flush spans do not name "
                                         "their requests' traces")
                stalls = [e for e in events if e.name.startswith("stall.")]
                inflight = obs.WATCHDOG.report()
                if stalls or inflight["flagged_total"] or inflight["open"]:
                    raise AssertionError(f"watchdog: {inflight}, "
                                         f"{len(stalls)} stall events")
                report = obs.audit_report()
                out["on"].update(batches=len(batches),
                                 audited=len(obs.audit_records()),
                                 dropped=obs.RECORDER.dropped)
                print("dispatch (f) audit report (first lines):\n"
                      + "\n".join(report.splitlines()[:4]))
            elif events:
                raise AssertionError(f"{len(events)} events with the "
                                     f"recorder off")
            print(f"dispatch (f) recorder {key}: {out[key]} [{card}]")
        finally:
            GLOBAL_CONF.unset("sml.obs.enabled")
            obs.reset()
    return out


def phase_dispatch(seed: int, device, card: str, prewarm: bool = True
                   ) -> dict:
    """Phase 18: the dispatcher, the host routes, prewarm and the obs
    core on phase 4's random ML 11 model at the golden widths."""
    from sml_tpu_torch.ml.inference import DeviceScorer
    from sml_tpu_torch.native import host_traverse as ht
    DSP_LAUNCHES.clear()
    t0 = time.perf_counter()
    model, cats = ml11_model(seed)
    X, _ = ml11_rows(np.random.default_rng([seed, 18]), 100_000, cats)
    scorer = DeviceScorer(model, device=device)
    reqs = reg_requests(X)
    refs = reg_refs(scorer, reqs)
    h0 = ht.CALLS
    _zero_launches()
    out = {"calibration": dsp_calibration(device, card, scorer, X)}
    _zero_launches()  # (a)'s launches only price the routes
    with KernelWatch() as watch:
        out["host_mode"] = dsp_host_mode(device, card, scorer, X)
        out["saturation"] = dsp_saturation(device, card, scorer, X, reqs,
                                           refs)
        out["autotune"] = dsp_autotune(device, card, scorer, reqs)
        out["recorder"] = dsp_recorder(device, card, scorer, reqs, refs)
    if watch.plain_on_cuda:
        raise AssertionError(f"plain versions ran {watch.plain_on_cuda} "
                             f"times on CUDA tensors")
    out["launches"] = dsp_take()
    out["host_traversals"] = ht.CALLS - h0
    if not out["launches"]["forest_traverse"]:
        raise AssertionError("phase 18 never launched forest_traverse")
    if prewarm:
        out["prewarm"] = dsp_prewarm(seed, card)
    out["phase_s"] = time.perf_counter() - t0
    print(f"dispatch: every check passed in {out['phase_s']!r} s; "
          f"launches {out['launches']}, host traversals "
          f"{out['host_traversals']}")
    return out


# ------------------ phase 19: the data plane (parquet, Delta, feature store)
#: ML 00L's first check (`Labs/ML 00L:89`): hash("8"), the 8 part files
DP_PARTS_HASH = 1276280174
#: rows a chunk of (g)'s parquet source
DP_CHUNK_ROWS = 1024


def dp_same_block(a: dict, b: dict, what: str) -> None:
    """Two blocks equal value for value: the same columns, dtypes and
    shapes, NULLs in the same rows, floats bit for bit."""
    if list(a) != list(b):
        raise AssertionError(f"{what}: columns {list(a)} vs {list(b)}")
    for c in a:
        x, y = a[c], b[c]
        if x.dtype != y.dtype or x.shape != y.shape:
            raise AssertionError(f"{what}: {c} {x.dtype}{x.shape} vs "
                                 f"{y.dtype}{y.shape}")
        if x.dtype.kind == "f":
            bits = np.dtype(f"u{x.dtype.itemsize}")
            nan = np.isnan(x)
            same = np.array_equal(nan, np.isnan(y)) and np.array_equal(
                x[~nan].view(bits), y[~nan].view(bits))
        elif x.dtype.kind == "O":
            same = x.tolist() == y.tolist()
        else:
            same = np.array_equal(x, y)
        if not same:
            raise AssertionError(f"{what}: column {c} differs")


def dp_table(path: str) -> tuple:
    """(bytes, rows) of a table the install wrote: a CSV or text file (a
    header line), a parquet directory (its footers) or a Delta table
    (its live files' `numRecords`)."""
    from sml_tpu_torch.delta.table import _list_versions, _snapshot
    from sml_tpu_torch.frame.parquet import ParquetFile
    if os.path.isfile(path):
        with open(path, "rb") as fh:
            return os.path.getsize(path), sum(1 for _ in fh) - 1
    nbytes = sum(os.path.getsize(os.path.join(r, f))
                 for r, _, fs in os.walk(path) for f in fs)
    versions = _list_versions(path)
    if versions:
        files = _snapshot(path, versions[-1])["files"]
        return nbytes, sum(f["numRecords"] for f in files)
    return nbytes, sum(ParquetFile(os.path.join(path, f)).num_rows
                       for f in sorted(os.listdir(path))
                       if f.endswith(".parquet"))


def dp_ml11(frame, device) -> dict:
    """ML 11's pipeline from `frame`: randomSplit([0.8, 0.2], seed=42),
    the course's prep and XGBoost on log price, the fit's launches, the
    held-out rmse through the evaluator's pushdown (its launches) and
    the held-out predictions."""
    from sml_tpu_torch import functions as F
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    train, test = frame.randomSplit([0.8, 0.2], seed=42)
    tr = train.withColumn("label", F.log(F.col("price"))).cache()
    te = test.withColumn("label", F.log(F.col("price"))).cache()
    _zero_launches()
    model, fit_ms = walled(lambda: Pipeline(
        stages=df_prep() + [df_estimator("xgb")]).fit(tr), device)
    fit_l = _all_launches()
    _zero_launches()
    pred = model.transform(te).withColumn("prediction",
                                          F.exp(F.col("prediction")))
    rmse = RegressionEvaluator(labelCol="price").evaluate(pred)
    eval_l = _all_launches()
    _zero_launches()
    preds = model.transform(te)._whole()["prediction"]
    pred_l = _all_launches()
    return {"rmse": rmse, "pred": preds, "fit": fit_l, "evaluate": eval_l,
            "predict": pred_l, "fit_ms": fit_ms,
            "rows": (tr.count(), te.count())}


def dp_lr(frame, cols):
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import LinearRegression
    fdf = VectorAssembler(inputCols=cols, outputCol="features") \
        .transform(frame)
    return LinearRegression(labelCol="price").fit(fdf)


def phase_dataplane(device, card: str) -> dict:
    """Phase 19: the course's data plane on `device` (the session's
    `sml.device`), in a temporary directory, with no pyarrow or pandas:
    (a) `ClassroomSetup.install_datasets`; (b) the clean table read back
    as Delta and as parquet, equal to the seeded frame; (c) ML 11 from
    the Delta read, bit-equal to the seeded frame's; (d) ML 05L's
    versions; (e) ML 00L's lab; (f) ML 10's feature store; (g) parquet
    chunks into `fit_chunked`."""
    import shutil
    import tempfile
    from sml_tpu_torch import functions as F
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.courseware import (ClassroomSetup, TestResults,
                                          make_airbnb_dataset)
    from sml_tpu_torch.feature_store import FeatureLookup, FeatureStoreClient
    from sml_tpu_torch.frame.column import block_len
    from sml_tpu_torch.frame.io import read_parquet_chunks
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import RandomForestRegressor
    GLOBAL_CONF.set("sml.device", device.type)
    spark = get_session()
    out = {"card": card}
    tmp = tempfile.mkdtemp(prefix="sml-dataplane-")
    prev_uri = mlflow.get_tracking_uri()
    mlflow.set_tracking_uri(os.path.join(tmp, "mlruns"))
    t_phase = time.perf_counter()
    try:
        with KernelWatch() as watch:
            _zero_launches()
            total = dict.fromkeys(_all_launches(), 0)

            def add(counts):
                for k, v in counts.items():
                    total[k] += v

            # (a) the install
            setup = ClassroomSetup(base_dir=os.path.join(tmp, "classroom"))
            root, install_ms = walled(setup.install_datasets, device)
            sf = os.path.join(root, "airbnb", "sf-listings")
            clean = os.path.join(sf, "sf-listings-2019-03-06-clean")
            tables = {
                "airbnb raw (csv)": os.path.join(
                    sf, "sf-listings-2019-03-06.csv"),
                "airbnb clean (parquet)": clean + ".parquet",
                "airbnb clean (delta)": clean + ".delta",
                "movielens ratings (parquet)": os.path.join(
                    root, "movielens", "ratings.parquet"),
                "dedup people (text)": os.path.join(
                    root, "dedup", "people-with-dups.txt")}
            out["a"] = {"install_ms": install_ms, "tables": {
                name: dict(zip(("bytes", "rows"), dp_table(path)))
                for name, path in tables.items()}}
            print(f"dataplane (a) ClassroomSetup.install_datasets: "
                  f"{install_ms!r} ms (host); card {card}")
            for name, t in out["a"]["tables"].items():
                print(f"dataplane (a)   {name}: {t['rows']} rows, "
                      f"{t['bytes']} bytes")

            # (b) the clean table read back, against the seeded frame
            seeded = spark.createDataFrame(
                spark.createDataFrame(make_airbnb_dataset()).dropna()
                ._whole())
            want = seeded._whole()
            reads = {}
            for fmt, path in (("delta", clean + ".delta"),
                              ("parquet", clean + ".parquet")):
                df, ms = walled(lambda fmt=fmt, path=path: spark.read.format(
                    fmt).load(path).cache(), device)
                _, mat_ms = walled(df._whole, device)
                dp_same_block(df._whole(), want, f"(b) {fmt} read")
                sizes = [block_len(p) for p in df._materialize()]
                if sizes != [block_len(p) for p in seeded._materialize()]:
                    raise AssertionError(f"(b) {fmt} partitions {sizes}")
                reads[fmt] = df
                out.setdefault("b", {})[fmt] = {"read_ms": ms + mat_ms,
                                                "partitions": len(sizes)}
            rows = block_len(want)
            print(f"dataplane (b) read.format('delta') "
                  f"{out['b']['delta']['read_ms']!r} ms, read.parquet "
                  f"{out['b']['parquet']['read_ms']!r} ms: "
                  f"{rows} rows x {len(want)} columns in "
                  f"{out['b']['delta']['partitions']} partitions, equal "
                  f"to the seeded frame value for value; card {card}")

            # (c) ML 11 from the Delta read, against the seeded frame
            ml11 = {what: dp_ml11(frame, device) for what, frame in
                    (("seeded", seeded), ("delta", reads["delta"]))}
            a, b = ml11["delta"], ml11["seeded"]
            want_fit = dict(FITS["xgb"][2], forest_traverse=0)
            want_eval = dict.fromkeys(want_fit, 0)
            want_eval["forest_traverse"] = 1
            if a["rmse"] != b["rmse"] or not np.array_equal(
                    a["pred"].view(np.uint64), b["pred"].view(np.uint64)):
                raise AssertionError(f"(c) rmse {a['rmse']!r} vs "
                                     f"{b['rmse']!r}, predictions differ")
            for r in (a, b):
                if r["fit"] != want_fit or r["evaluate"] != want_eval \
                        or r["predict"] != want_eval:
                    raise AssertionError(f"(c) launches {r['fit']} / "
                                         f"{r['evaluate']} / "
                                         f"{r['predict']}")
                add(r["fit"])
                add(r["evaluate"])
                add(r["predict"])
            c_launches = {k: a["fit"][k] + a["evaluate"][k] +
                          a["predict"][k]
                          for k in ("hist_accumulate", "split_scan",
                                    "forest_traverse")}
            out["c"] = {"rmse": a["rmse"], "rows": a["rows"],
                        "fit_ms": {"delta": a["fit_ms"],
                                   "seeded": b["fit_ms"]},
                        "launches": c_launches}
            print(f"dataplane (c) ML 11 pipeline from the Delta read "
                  f"(train/test {a['rows']}): rmse {a['rmse']!r}, "
                  f"bit-equal to the seeded frame's, predictions bit-equal; "
                  f"launches {c_launches}; fit {a['fit_ms']!r} ms (seeded "
                  f"{b['fit_ms']!r} ms); card {card}")

            # (d) ML 05L: versions, mergeSchema, fits, DESCRIBE HISTORY
            lab = os.path.join(tmp, "delta-lab")
            base = reads["delta"].select("bedrooms", "accommodates",
                                         "price")
            t0 = time.perf_counter()
            base.write.format("delta").mode("overwrite").save(lab)
            m1 = dp_lr(spark.read.format("delta").load(lab), ["bedrooms"])
            base.withColumn("log_price", F.log(F.col("price"))) \
                .write.format("delta").mode("overwrite") \
                .option("mergeSchema", "true").save(lab)
            v0 = spark.read.format("delta").option("versionAsOf", 0) \
                .load(lab)
            latest = spark.read.format("delta").load(lab)
            m0 = dp_lr(v0, ["bedrooms"])
            m2 = dp_lr(latest, ["bedrooms", "accommodates"])
            hist = spark.sql(f"DESCRIBE HISTORY delta.`{lab}`").collect()
            d_ms = (time.perf_counter() - t0) * 1e3
            if "log_price" in v0.columns or "log_price" not in \
                    latest.columns or [r["version"] for r in hist] != [1, 0]:
                raise AssertionError(f"(d) v0 {v0.columns}, latest "
                                     f"{latest.columns}, history {hist}")
            if not (np.array_equal(m0.coefficients.toArray(),
                                   m1.coefficients.toArray())
                    and m0.intercept == m1.intercept):
                raise AssertionError("(d) the v0 fit differs from the fit "
                                     "before the overwrite")
            out["d"] = {"ms": d_ms, "coef_v0": m0.coefficients.toArray()
                        .tolist(), "coef_latest": m2.coefficients.toArray()
                        .tolist(), "history": len(hist)}
            print(f"dataplane (d) ML 05L: overwrite with mergeSchema "
                  f"(log_price), LR on versionAsOf 0 (bit-equal to the fit "
                  f"before it) and on the latest, DESCRIBE HISTORY "
                  f"{[(r['version'], r['operationParameters']) for r in hist]}"
                  f" in {d_ms!r} ms; card {card}")

            # (e) ML 00L: dedup, the 8-part parquet write and read
            people = tables["dedup people (text)"]
            dest = os.path.join(tmp, "people.parquet")
            old = GLOBAL_CONF.get("sml.shuffle.partitions")
            GLOBAL_CONF.set("sml.shuffle.partitions", 8)
            try:
                t0 = time.perf_counter()
                df = (spark.read.option("header", "true")
                      .option("inferSchema", "true").option("sep", ":")
                      .csv(people))
                deduped = (df.select(
                    F.col("*"),
                    F.lower(F.col("firstName")).alias("lcFirstName"),
                    F.lower(F.col("lastName")).alias("lcLastName"),
                    F.lower(F.col("middleName")).alias("lcMiddleName"),
                    F.translate(F.col("ssn"), "-", "").alias("ssnNums"))
                    .dropDuplicates(["lcFirstName", "lcMiddleName",
                                     "lcLastName", "ssnNums", "gender",
                                     "birthDate", "salary"])
                    .drop("lcFirstName", "lcMiddleName", "lcLastName",
                          "ssnNums")).cache()
                deduped.count()
                dedup_ms = (time.perf_counter() - t0) * 1e3
                t0 = time.perf_counter()
                deduped.write.mode("overwrite").parquet(dest)
                write_ms = (time.perf_counter() - t0) * 1e3
            finally:
                GLOBAL_CONF.set("sml.shuffle.partitions", old)
            t0 = time.perf_counter()
            final = spark.read.parquet(dest)
            count = final.count()
            read_ms = (time.perf_counter() - t0) * 1e3
            parts = len([f for f in os.listdir(dest)
                         if f.endswith(".parquet")])
            results = TestResults()
            ok = results.validate_your_answer(
                "01 Parquet File Exists", DP_PARTS_HASH, parts) and \
                results.validate_your_answer(
                    "02 Expected 100000 Records", DEDUP_HASH, count)
            if not ok:
                raise AssertionError(f"(e) {parts} part files, {count} "
                                     f"records: {results.results}")
            dp_same_block(final._whole(), deduped._whole(),
                          "(e) the parquet read")
            out["e"] = {"rows_in": dp_table(people)[1], "count": count,
                        "parts": parts, "read_dedup_ms": dedup_ms,
                        "write_ms": write_ms, "read_ms": read_ms}
            print(f"dataplane (e) ML 00L: {out['e']['rows_in']} rows read "
                  f"(colon-separated) and deduplicated in {dedup_ms!r} ms, "
                  f"{parts} parquet part files written in {write_ms!r} ms "
                  f"and read in {read_ms!r} ms; {count} records, both "
                  f"answers validate ({DP_PARTS_HASH}, {DEDUP_HASH}); "
                  f"card {card}")

            # (f) ML 10: the feature store through score_batch
            fs = FeatureStoreClient(os.path.join(tmp, "feature_store"))
            feats = ["bedrooms", "accommodates", "bathrooms", "beds",
                     "minimum_nights", "number_of_reviews",
                     "review_scores_rating"]
            t0 = time.perf_counter()
            listings = reads["delta"].coalesce(1).withColumn(
                "listing_id", F.monotonically_increasing_id())
            fs.create_table("dataplane.features", "listing_id",
                            df=listings.select("listing_id", *feats))
            labels = listings.select("listing_id", "price")
            ts = fs.create_training_set(
                labels, [FeatureLookup("dataplane.features", "listing_id")],
                label="price")
            tdf = ts.load_df().cache()
            _zero_launches()
            with mlflow.start_run() as run:
                model = Pipeline(stages=[
                    VectorAssembler(inputCols=feats, outputCol="features"),
                    RandomForestRegressor(labelCol="price", numTrees=20,
                                          maxDepth=6, maxBins=40,
                                          seed=42)]).fit(tdf)
                fs.log_model(model, "model", training_set=ts)
            fit_l = _all_launches()
            add(fit_l)
            _zero_launches()
            scored = fs.score_batch(f"runs:/{run.info.run_id}/model",
                                    labels)
            got = scored._whole()["prediction"]
            score_l = _all_launches()
            add(score_l)
            _zero_launches()
            direct = model.transform(tdf)._whole()["prediction"]
            add(_all_launches())
            f_ms = (time.perf_counter() - t0) * 1e3
            if not np.array_equal(got, direct) or len(got) != rows or \
                    score_l["forest_traverse"] != 1:
                raise AssertionError(f"(f) score_batch: {len(got)} rows, "
                                     f"launches {score_l}")
            out["f"] = {"ms": f_ms, "fit_launches": fit_l,
                        "score_launches": score_l}
            print(f"dataplane (f) ML 10: feature table from the Delta read, "
                  f"training set, ML 07's forest pipeline logged with it "
                  f"(launches {fit_l}), score_batch of {len(got)} keys "
                  f"equal to transform bit for bit (launches {score_l}); "
                  f"{f_ms!r} ms; card {card}")

            # (g) parquet chunks into fit_chunked
            rf = RandomForestRegressor(numTrees=20, maxDepth=6, maxBins=40,
                                       seed=42)
            src = read_parquet_chunks(clean + ".parquet", feats, "price",
                                      chunkRows=DP_CHUNK_ROWS)
            _zero_launches()
            m_chunk, g_ms = walled(lambda: rf.fit_chunked(src,
                                                          device=device),
                                   device)
            chunk_l = _all_launches()
            whole = reads["parquet"]._whole()
            X = np.column_stack([whole[c] for c in feats])
            _zero_launches()
            m_mat = rf.fit(X, whole["price"], categorical={}, device=device)
            mat_l = _all_launches()
            same_spec(m_chunk._spec, m_mat._spec,
                      "(g) parquet chunks vs the in-memory fit")
            if chunk_l != mat_l:
                raise AssertionError(f"(g) launches {chunk_l} vs {mat_l}")
            add(chunk_l)
            add(mat_l)
            out["g"] = {"ms": g_ms, "chunks": -(-src.n_rows //
                                               DP_CHUNK_ROWS),
                        "launches": chunk_l}
            print(f"dataplane (g) read_parquet_chunks ({DP_CHUNK_ROWS}-row "
                  f"chunks of {src.n_rows} rows) -> RandomForestRegressor"
                  f".fit_chunked: bit-equal to fit() on the read matrix, "
                  f"launches {chunk_l} each; {g_ms!r} ms; card {card}")
    finally:
        mlflow.set_tracking_uri(prev_uri)
        shutil.rmtree(tmp, ignore_errors=True)
    if watch.plain_on_cuda:
        raise AssertionError(f"(dataplane) plain versions ran "
                             f"{watch.plain_on_cuda} times on the card")
    missing = [k for k, v in total.items() if not v]
    if missing:
        raise AssertionError(f"(dataplane) kernels never launched: "
                             f"{missing} ({total})")
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"dataplane: every check passed in {out['phase_s']!r} s; launches "
          f"{total}; card {card}")
    return out


# ------------------------------------------------ phase 20: the observed path
#: the feature phase 20 shifts (one no label depends on), by OBS_SHIFT of
#: its standard deviations over the training rows
OBS_FEATURE = 9
OBS_SHIFT = 3.0
#: (b)'s traffic: OBS_WAVES waves of OBS_WAVE requests of OBS_ROWS rows
#: drawn from the training rows
OBS_WAVES, OBS_WAVE, OBS_ROWS = 12, 8, 64
#: (d)'s chunks of the training rows, and the one shifted
OBS_CHUNKS, OBS_SHIFTED_CHUNK = 8, 5
#: (f)'s rows (phase 8's card-against-CPU size)
OBS_HOST_ROWS = 16_000
OBS_NAME = "airbnb-observed"
OBS_KEY = f"serve.{OBS_NAME}/Production"
OBS_BLOCKS = {"metrics", "audit", "hbm", "engine", "slo", "skew", "ingest",
              "inflight", "drift", "infer_kernel", "shed", "fleet", "load",
              "endpoint"}


def obs_recorder(on: bool) -> None:
    """The recorder on or off, every obs record reset."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.conf import GLOBAL_CONF
    GLOBAL_CONF.set("sml.obs.enabled", on)
    obs.reset()


def obs_fits(Xtr, ytr, cats, device, card: str) -> dict:
    """(a) ML 11's XGBoost and ML 07's forest, each fitted with the
    recorder off and then on, inside a tracking run, from empty caches:
    the same launches, bit-equal trees; the on-fit carries a baseline,
    its run the engine.* deltas, and every decision it made is
    "local-chip"."""
    from sml_tpu_torch import obs
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.obs import drift
    out = {}
    for name in ("xgb", "rf"):
        fit, _, want = FITS[name]
        runs = {}
        for on in (False, True):
            clear_fit_caches()
            obs_recorder(on)
            capture = []
            orig = drift.capture_fit_baseline

            def timed(*a, _orig=orig, **k):
                t0 = time.perf_counter()
                got = _orig(*a, **k)
                capture.append((time.perf_counter() - t0) * 1e3)
                return got
            drift.capture_fit_baseline = timed
            try:
                _zero_launches()
                with mlflow.start_run() as run:
                    model, ms = walled(lambda: fit(Xtr, ytr, cats, device),
                                       device)
                launches = _all_launches()
            finally:
                drift.capture_fit_baseline = orig
            metrics = mlflow.get_run(run.info.run_id).data.metrics
            runs[on] = {"model": model, "ms": ms, "launches": launches,
                        "capture_ms": sum(capture),
                        "engine": {k: v for k, v in metrics.items()
                                   if k.startswith("engine.")},
                        "decisions": [(r.route, r.reason)
                                      for r in obs.audit_records()]}
        off, on = runs[False], runs[True]
        expect = dict(want, forest_traverse=0)
        if off["launches"] != expect or on["launches"] != expect:
            raise AssertionError(f"(a) {name}: launches off {off['launches']}"
                                 f", on {on['launches']}, not {expect}")
        same_spec(off["model"]._spec, on["model"]._spec,
                  f"(a) {name} recorder on against off")
        if off["model"]._spec.baseline is not None \
                or on["model"]._spec.baseline is None:
            raise AssertionError(f"(a) {name}: a baseline only with the "
                                 f"recorder on")
        if off["engine"] or len(on["engine"]) != 10:
            raise AssertionError(f"(a) {name}: engine metrics off "
                                 f"{off['engine']}, on {on['engine']}")
        peak = on["engine"]["engine.hbm_peak_bytes"]
        card_peak = torch.cuda.max_memory_allocated() \
            if device.type == "cuda" else float("inf")
        if not 0 < peak <= card_peak:
            raise AssertionError(f"(a) {name}: ledger peak {peak} against "
                                 f"the card's {card_peak}")
        reasons = {"local-chip"} if device.type == "cuda" else {"no-tunnel"}
        if not on["decisions"] or {r for _, r in on["decisions"]} \
                != reasons or {r for r, _ in on["decisions"]} != {"device"}:
            raise AssertionError(f"(a) {name}: decisions {on['decisions']}")
        out[name] = {"launches": on["launches"], "fit_ms_off": off["ms"],
                     "fit_ms_on": on["ms"],
                     "capture_ms": on["capture_ms"],
                     "engine": on["engine"],
                     "decisions": len(on["decisions"]),
                     "model": on["model"]}
        print(f"observed (a) {name} fit {len(Xtr)} rows: launches off "
              f"{off['launches']} on {on['launches']}, trees bit-equal; "
              f"wall off {off['ms']!r} ms on {on['ms']!r} ms, baseline "
              f"capture {on['capture_ms']!r} ms (host); "
              f"{len(on['decisions'])} decisions, all {sorted(reasons)}; "
              f"run engine.* {on['engine']} [{card}]")
    return out


def obs_waves(ep, scorer, reqs, observer_s: list) -> dict:
    """OBS_WAVES waves of OBS_WAVE requests on `ep` (a wave submitted,
    then waited for): each response bit-equal to `score_block` of its
    rows; a traversal a flushed batch; latencies (host clock)."""
    from sml_tpu_torch.utils.profiler import PROFILER

    def batches():
        return PROFILER.counters().get("serve.batches", 0.0)
    full = scorer.score_block(np.concatenate(reqs, axis=0))
    offs = np.cumsum([0] + [len(r) for r in reqs])
    refs = [full[offs[i]:offs[i + 1]] for i in range(len(reqs))]
    _zero_launches()   # the references' launch is not the path's
    b0, o0 = batches(), len(observer_s)
    lat = []
    for w in range(0, len(reqs), OBS_WAVE):
        sent = [(time.perf_counter(), ep.submit(r), i)
                for i, r in enumerate(reqs[w:w + OBS_WAVE], w)]
        for t0, fut, i in sent:
            got = fut.result(60)
            lat.append((time.perf_counter() - t0) * 1e3)
            if not np.array_equal(got, refs[i]):
                raise AssertionError(f"(b) response {i} differs from "
                                     f"score_block of its rows")
    launches = _all_launches()
    flushed = int(batches() - b0)
    if launches != dict.fromkeys(launches, 0) | {"forest_traverse":
                                                  flushed}:
        raise AssertionError(f"(b) {launches} for {flushed} batches")
    obs_us = [s * 1e6 for s in observer_s[o0:]]
    return {"p50_ms": float(np.percentile(lat, 50)),
            "p99_ms": float(np.percentile(lat, 99)),
            "batches": flushed, "launches": launches,
            "observer_us_per_batch": float(np.median(obs_us))
            if obs_us else None}


def obs_endpoint(model, Xtr, device, card: str, tmp: str) -> dict:
    """(b) the ML 11 model (with its baseline) logged, registered,
    promoted and served: iid waves flag nothing (drift on, then off for
    the latency pair); the window reset, shifted waves flag OBS_FEATURE
    alone, and its exemplar's trace id is in the exported trace. (c)
    `health_report()`'s blocks."""
    from sml_tpu_torch import obs
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.ml.inference import DeviceScorer
    from sml_tpu_torch.serving import ServingEndpoint
    with mlflow.start_run():
        mlflow.spark.log_model(model, "model",
                               registered_model_name=OBS_NAME)
    mlflow.MlflowClient().transition_model_version_stage(OBS_NAME, 1,
                                                         "Production")
    rng = np.random.default_rng(20)
    sd = float(np.nanstd(Xtr[:, OBS_FEATURE]))

    def traffic(shift: bool) -> list:
        reqs = []
        for _ in range(OBS_WAVES * OBS_WAVE):
            rows = Xtr[rng.integers(0, len(Xtr), OBS_ROWS)].copy()
            if shift:
                rows[:, OBS_FEATURE] += OBS_SHIFT * sd
            reqs.append(rows)
        return reqs

    scorer = DeviceScorer(model, device=device)
    out = {}
    name = f"f{OBS_FEATURE}"
    ep = ServingEndpoint(OBS_NAME, "Production", flush_micros=2000,
                         device=device)
    try:
        observer_s = []
        inner = ep._observe_scores

        def timed_observer(X, preds, traces):
            t0 = time.perf_counter()
            inner(X, preds, traces)
            observer_s.append(time.perf_counter() - t0)
        ep._batcher._observer = timed_observer
        mon = ep._drift
        if mon is None or obs.DRIFT.get(OBS_KEY) is not mon:
            raise AssertionError("(b) the endpoint bound no drift monitor")

        out["iid_drift_on"] = obs_waves(ep, scorer, traffic(False),
                                        observer_s)
        iid = obs.DRIFT.report()[OBS_KEY]
        ep._drift = None            # the observer finds no monitor
        out["iid_drift_off"] = obs_waves(ep, scorer, traffic(False),
                                         observer_s)
        ep._drift = mon
        obs.DRIFT.reset()           # a fresh window for the shift
        out["shift_drift_on"] = obs_waves(ep, scorer, traffic(True),
                                          observer_s)
        shifted = obs.DRIFT.report()[OBS_KEY]
        health = ep.health_report()
    finally:
        ep.close()
    if not iid["ready"] or iid["flagged"]:
        raise AssertionError(f"(b) iid traffic flagged {iid['flagged']}")
    feats = [f for f in shifted["flagged"] if f != "prediction"]
    if feats != [name]:
        raise AssertionError(f"(b) the shift flagged {shifted['flagged']}, "
                             f"not {name} alone")
    row = next(e for e in shifted["features"] if e["feature"] == name)
    trace_path = obs.export_chrome_trace(os.path.join(tmp, "observed.json"))
    with open(trace_path) as f:
        doc = json.load(f)
    tid = int(row["worst_trace"], 16)
    hits = sum(1 for e in doc["traceEvents"]
               if (e.get("args") or {}).get("trace") == tid
               or tid in ((e.get("args") or {}).get("parent_traces") or ()))
    if not hits:
        raise AssertionError(f"(b) exemplar {row['worst_trace']} is not in "
                             f"the exported trace")
    # (c) the health surface
    if set(health) != OBS_BLOCKS or OBS_KEY not in (health["drift"] or {}):
        raise AssertionError(f"(c) health_report blocks {sorted(health)}, "
                             f"drift {health['drift']}")
    plan = health["infer_kernel"]["plan"]
    if device.type == "cuda" and not plan:
        raise AssertionError(f"(c) no traversal plan: "
                             f"{health['infer_kernel']}")
    out["iid"] = {"rows": iid["rows"], "max_severity": iid["max_severity"],
                  "flagged": iid["flagged"]}
    out["shift"] = {"rows": shifted["rows"], "flagged": shifted["flagged"],
                    "severity": row["severity"], "psi": row["psi"],
                    "threshold_psi": row["threshold_psi"],
                    "worst_trace": row["worst_trace"],
                    "trace_events_with_it": hits,
                    "prediction": shifted.get("prediction")}
    out["health"] = {"blocks": sorted(health), "infer_kernel":
                     health["infer_kernel"],
                     "hbm_total": health["hbm"]["_total"],
                     "slo": health["slo"]}
    for what in ("iid_drift_on", "iid_drift_off", "shift_drift_on"):
        got = out[what]
        print(f"observed (b) {what}: p50 {got['p50_ms']!r} ms p99 "
              f"{got['p99_ms']!r} ms, {got['batches']} batches, launches "
              f"{got['launches']}, observer "
              f"{got['observer_us_per_batch']!r} us a batch [{card}]")
    print(f"observed (b) iid: {iid['rows']} rows, nothing flagged (max "
          f"severity {iid['max_severity']!r}); shifted {name} by "
          f"{OBS_SHIFT} sd: flagged {shifted['flagged']}, exemplar "
          f"{row['worst_trace']} in {hits} trace events")
    print(f"observed (c) health_report: {sorted(health)}; plan {plan}")
    return out


def obs_chunked(base, Xtr, ytr, cats, device, card: str) -> dict:
    """(d) the training rows in OBS_CHUNKS chunks, one shifted, into
    ML 11's chunked fit judged against the ML 11 model's baseline: the
    shifted chunk flags OBS_FEATURE alone, no other chunk flags; the
    ingest block names a slowest chunk."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.frame._chunks import ArrayChunkSource
    from sml_tpu_torch.ml._chunked import fit_ensemble_chunked
    n = len(Xtr)
    c = -(-n // OBS_CHUNKS)
    Xs = np.array(Xtr, copy=True)
    lo = OBS_SHIFTED_CHUNK * c
    Xs[lo:lo + c, OBS_FEATURE] += OBS_SHIFT * float(
        np.nanstd(Xtr[:, OBS_FEATURE]))
    obs.reset()
    clear_fit_caches()
    _zero_launches()
    spec, ms = walled(lambda: fit_ensemble_chunked(
        ArrayChunkSource(Xs, ytr, chunk_rows=c), categorical=cats,
        max_depth=6, max_bins=64, n_trees=40, boosting=True,
        step_size=0.15, reg_lambda=1.0, seed=42, device=device,
        drift_baseline=base), device)
    launches = _all_launches()
    want = dict(FITS["xgb"][2], forest_traverse=0)
    if launches != want:
        raise AssertionError(f"(d) launches {launches}, not {want}")
    health = obs.engine_health()
    rep = health["drift"]["ingest"]
    verdicts = {e["chunk"]: e["flagged"] for e in rep["chunks"]["recent"]}
    expect = {i: ([f"f{OBS_FEATURE}"] if i == OBS_SHIFTED_CHUNK else [])
              for i in range(OBS_CHUNKS)}
    if rep["chunks"]["observed"] != OBS_CHUNKS or verdicts != expect:
        raise AssertionError(f"(d) chunk verdicts {verdicts}")
    ingest = health["ingest"]
    if ingest is None or ingest["slowest_device"] not in range(OBS_CHUNKS):
        raise AssertionError(f"(d) ingest block {ingest}")
    if spec.baseline is None or spec.baseline.n_rows != n:
        raise AssertionError("(d) the chunked fit carries no baseline")
    out = {"ms": ms, "launches": launches, "verdicts": verdicts,
           "max_severity": {e["chunk"]: e["max_severity"]
                            for e in rep["chunks"]["recent"]},
           "slowest_chunk": ingest["slowest_device"],
           "skew_ratio": ingest["skew_ratio"]}
    print(f"observed (d) {OBS_CHUNKS} chunks of {c} rows (chunk "
          f"{OBS_SHIFTED_CHUNK} shifted) into fit_chunked with the ML 11 "
          f"baseline: {ms!r} ms, launches {launches}; verdicts {verdicts}; "
          f"slowest chunk {ingest['slowest_device']} (skew "
          f"{ingest['skew_ratio']!r}) [{card}]")
    return out


def obs_blackbox(tmp: str, device, card: str) -> dict:
    """(e) a bundle dumped, its files' sizes, and its events rendered by
    the port's `_tracefmt.py` loaded by file path."""
    import importlib.util
    from sml_tpu_torch import obs
    bundle, ms = walled(lambda: obs.dump_blackbox(
        "phase 20", directory=os.path.join(tmp, "blackbox")), device)
    files = {f: os.path.getsize(os.path.join(bundle, f))
             for f in sorted(os.listdir(bundle))}
    if set(files) != {"MANIFEST.json", "events.jsonl", "metrics.json",
                      "audit.json", "ledger.json"}:
        raise AssertionError(f"(e) bundle files {files}")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "sml_tpu_torch", "obs", "_tracefmt.py")
    spec = importlib.util.spec_from_file_location("_observed_tracefmt",
                                                  path)
    fmt = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fmt)
    with open(os.path.join(bundle, "events.jsonl")) as f:
        records = [json.loads(line) for line in f][1:]
    doc = fmt.trace_doc(records)
    host = next(e for e in doc["traceEvents"]
                if e.get("name") == "process_name" and e["pid"] == 1)
    if host["args"]["name"] != "sml_tpu_torch host" or not records:
        raise AssertionError(f"(e) rendered {host}, {len(records)} events")
    print(f"observed (e) dump_blackbox: {ms!r} ms, files {files}; "
          f"{len(records)} events rendered to {len(doc['traceEvents'])} "
          f"trace events by the port's _tracefmt [{card}]")
    return {"ms": ms, "files": files, "events": len(records)}


def obs_kmeans(X):
    """KMeans (k=5) of X's continuous features on the session's device."""
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml.clustering import KMeans
    from sml_tpu_torch.ml.feature import VectorAssembler
    cols = [f"c{j}" for j in (3, 4, 6, 7, 8)]
    df = get_session().createDataFrame(
        {c: np.nan_to_num(X[:, int(c[1:])]) for c in cols})
    df = VectorAssembler(inputCols=cols, outputCol="features").transform(df)
    return np.asarray(KMeans(k=5, seed=1, maxIter=20).fit(df)
                      .clusterCenters())


def obs_host_mode(X, y, cats, device, card: str) -> dict:
    """(f) `sml.dispatch.mode=host`: ML 11's fit and a KMeans fit asked
    for the card run on the CPU, launch nothing and equal the CPU run;
    in the default mode KMeans decides "local-chip"."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.conf import GLOBAL_CONF
    Xh, yh = X[:OBS_HOST_ROWS], y[:OBS_HOST_ROWS]
    GLOBAL_CONF.set("sml.device", device.type)
    GLOBAL_CONF.set("sml.dispatch.mode", "host")
    try:
        with KernelWatch() as watch:
            _zero_launches()
            fit_host, fit_ms = walled(lambda: _fit_xgb(Xh, yh, cats, None),
                                      device)
            km_host = obs_kmeans(Xh)
            launches = _all_launches()
    finally:
        GLOBAL_CONF.unset("sml.dispatch.mode")
    GLOBAL_CONF.set("sml.device", "cpu")
    try:
        fit_cpu = _fit_xgb(Xh, yh, cats, "cpu")
        km_cpu = obs_kmeans(Xh)
    finally:
        GLOBAL_CONF.set("sml.device", device.type)
    if any(launches.values()) or watch.plain_on_cuda:
        raise AssertionError(f"(f) host mode launched {launches}, plain "
                             f"versions on the card {watch.plain_on_cuda}")
    same_spec(fit_host._spec, fit_cpu._spec, "(f) host mode against CPU")
    if not np.array_equal(km_host, km_cpu):
        raise AssertionError("(f) KMeans on the host route differs from "
                             "the CPU run")
    obs_recorder(True)
    obs_kmeans(Xh)
    reasons = sorted({r.reason for r in obs.audit_records()})
    want = ["local-chip"] if device.type == "cuda" else ["no-tunnel"]
    if reasons != want:
        raise AssertionError(f"(f) default-mode KMeans decided {reasons}")
    print(f"observed (f) sml.dispatch.mode=host: ML 11 fit "
          f"({OBS_HOST_ROWS} rows, {fit_ms!r} ms) and KMeans on the CPU, "
          f"launches {launches}, equal to the CPU run bit for bit; "
          f"default-mode KMeans decisions {reasons} [{card}]")
    return {"launches": launches, "fit_ms": fit_ms,
            "default_reasons": reasons}


def phase_observed(seed: int, device, card: str,
                   n_train: int = 80_000) -> dict:
    """Phase 20: the main path with its monitoring on (the recorder on
    only inside this phase, and reset after it): (a) fits with the
    recorder off and on; (b) the endpoint under drift; (c) its health
    surface; (d) the chunked ingest judged per chunk; (e) a black-box
    bundle; (f) `sml.dispatch.mode=host` (on a card only). `n_train`
    cuts the training rows for a rehearsal on the CPU."""
    import shutil
    import tempfile
    from sml_tpu_torch import tracking as mlflow
    X, logy, cats = fit_rows(seed)
    Xtr, ytr = X[:n_train], logy[:n_train]
    tmp = tempfile.mkdtemp(prefix="sml-observed-")
    prev_uri = mlflow.get_tracking_uri()
    mlflow.set_tracking_uri(os.path.join(tmp, "mlruns"))
    t_phase = time.perf_counter()
    out = {"card": card}
    total: dict = {}

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    try:
        with KernelWatch() as watch:
            fits = obs_fits(Xtr, ytr, cats, device, card)
            for name, got in fits.items():
                add({k: 2 * v for k, v in got["launches"].items()})
            model = fits["xgb"].pop("model")
            fits["rf"].pop("model")
            out["a"] = fits
            obs_recorder(True)
            out["b"] = obs_endpoint(model, Xtr, device, card, tmp)
            for what in ("iid_drift_on", "iid_drift_off", "shift_drift_on"):
                add(out["b"][what]["launches"])
            out["d"] = obs_chunked(model._spec.baseline, Xtr, ytr, cats,
                                   device, card)
            add(out["d"]["launches"])
            out["e"] = obs_blackbox(tmp, device, card)
        if watch.plain_on_cuda:
            raise AssertionError(f"(observed) plain versions ran "
                                 f"{watch.plain_on_cuda} times on the card")
        if device.type == "cuda":
            out["f"] = obs_host_mode(X, logy, cats, device, card)
    finally:
        obs_recorder(False)
        mlflow.set_tracking_uri(prev_uri)
        shutil.rmtree(tmp, ignore_errors=True)
    missing = [k for k, v in total.items() if not v]
    if missing:
        raise AssertionError(f"(observed) kernels never launched: "
                             f"{missing} ({total})")
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"observed: every check passed in {out['phase_s']!r} s; launches "
          f"{total}; card {card}")
    return out


# ------------------------------------- phase 21: fleet, stream and training
FLT_NAME = "airbnb-fleet"
FLT_REPLICAS = 3
#: each replica's admission bound (rows): the class ladder's scale
FLT_QUEUE_ROWS = 256
#: the open-loop trace's request widths (fat-tailed over 1-64 rows) and
#: classes, highest first
FLT_WIDTHS = ((1, 0.40), (2, 0.20), (4, 0.15), (8, 0.10), (16, 0.07),
              (32, 0.05), (64, 0.03))
FLT_CLASSES = (("high", 0.2), ("normal", 0.6), ("low", 0.2))
#: seconds of each load phase; the requests the closed-loop probe
#: measures the sustained rate on
FLT_PHASE_S = 2.5
FLT_PROBE = 200
#: the open-loop driver's pool: the burst's peak (4 x 2 x the probe's
#: ~250-300 req/s) times a queued request's ~50 ms needs ~100 in flight
#: (`scripts/torch_fleet_load.py` measures overruns at 32 and 128)
FLT_WORKERS = 128
#: (c): the replay's seconds and rate, and the requests submitted in one
#: burst just before the kill
FLT_KILL_S, FLT_KILL_RATE, FLT_KILL_BURST = 2.0, 200.0, 64
#: (d)'s appends of held-out rows: under minRefitRows, iid, feature 9
#: shifted (phase 20's OBS_SHIFT), and the gate-failing window (feature 9
#: back, its first sml.ct.gateRows rows with their labels, the rest
#: with labels permuted)
CT_ROWS = (256, 4000, 4000, 8000)
#: (e)'s parquet parts, and the numeric columns of its stream trainer
STREAM_PART_ROWS = 1000
STREAM_COLS = ("accommodates", "bathrooms", "bedrooms", "beds",
               "minimum_nights", "number_of_reviews",
               "review_scores_rating")


def flt_register(model, name: str) -> None:
    """Log `model`, register it as `name` v1 and move it to Production."""
    from sml_tpu_torch import tracking as mlflow
    with mlflow.start_run():
        mlflow.spark.log_model(model, "model", registered_model_name=name)
    mlflow.MlflowClient().transition_model_version_stage(name, 1,
                                                         "Production")


def flt_spec(rate: float, seed: int = 21):
    """The three-phase trace: steady at half the sustained rate, a burst
    (factor 4) averaging twice it, steady again."""
    from sml_tpu_torch.loadgen import PhaseSpec, TraceSpec
    return TraceSpec(
        phases=(PhaseSpec("steady", FLT_PHASE_S, 0.5 * rate),
                PhaseSpec("burst", FLT_PHASE_S, 2.0 * rate,
                          arrival="bursty", burst_factor=4.0),
                PhaseSpec("steady2", FLT_PHASE_S, 0.5 * rate)),
        widths=FLT_WIDTHS, classes=FLT_CLASSES, seed=seed)


def flt_version(name: str, version: int):
    from sml_tpu_torch.ml.base import load
    from sml_tpu_torch.tracking import _store
    return load(os.path.join(_store.model_dir(name), "versions",
                             str(version), "model", "native"))


def flt_same_answers(pool, model, X, device, what: str) -> dict:
    """Every replica's answer to X bit-equal to `score_block` of `model`;
    returns the replicas' launches (the reference's is not counted)."""
    from sml_tpu_torch.ml.inference import DeviceScorer
    ref = DeviceScorer(model, device=device).score_block(X)
    _zero_launches()
    for r in pool.replicas():
        if not np.array_equal(r.endpoint.score(X, timeout=60), ref):
            raise AssertionError(f"{what}: replica {r.rid} differs from "
                                 f"score_block")
    return _all_launches()


def flt_pool(Xte, device, card: str, tmp: str) -> tuple:
    """(a) FLT_REPLICAS replicas of FLT_NAME v1 with prewarm on (the
    first replays the manifest, the rest skip), and every replica's
    answer to the same 64 rows against `score_block`."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.fleet import ReplicaPool
    from sml_tpu_torch.parallel import prewarm
    from sml_tpu_torch.utils.profiler import PROFILER
    prewarm.reset()
    GLOBAL_CONF.set("sml.prewarm.enabled", True)
    skip0 = PROFILER.counters().get("prewarm.replica_skip", 0.0)
    try:
        pool, ms = walled(lambda: ReplicaPool(
            FLT_NAME, replicas=FLT_REPLICAS, device=device,
            queue_rows=FLT_QUEUE_ROWS, canary_fraction=1.0,
            blackbox_dir=os.path.join(tmp, "blackbox")), device)
    finally:
        GLOBAL_CONF.unset("sml.prewarm.enabled")
    skips = PROFILER.counters().get("prewarm.replica_skip", 0.0) - skip0
    first = pool.replicas()[0].endpoint.prewarm_thread
    if first is not None:
        first.join()
    replay = prewarm.status()
    if skips != FLT_REPLICAS - 1 or replay["state"] != "done":
        raise AssertionError(f"(a) prewarm.replica_skip {skips}, replay "
                             f"{replay}")
    X64 = Xte[np.random.default_rng(5).integers(0, len(Xte), 64)]
    launches = flt_same_answers(pool, flt_version(FLT_NAME, 1), X64,
                                device, "(a)")
    print(f"fleet (a) {FLT_REPLICAS} replicas of {FLT_NAME} v1 started in "
          f"{ms!r} ms; prewarm.replica_skip {skips:g}, the first replica's "
          f"replay {replay['stats']}; every replica's answer to 64 rows "
          f"bit-equal to score_block; launches {launches} [{card}]")
    return pool, {"start_ms": ms, "replica_skip": skips,
                  "replay": replay["stats"], "launches": launches}


def flt_counters() -> dict:
    from sml_tpu_torch.utils.profiler import PROFILER
    c = PROFILER.counters()
    return {k: c.get(k, 0.0) for k in
            ("fleet.shed.high", "fleet.shed.normal", "fleet.shed.low",
             "serve.shed.overflow", "serve.shed.deadline", "fleet.requests",
             "fleet.reroutes", "load.overrun", "load.timeout")}


def flt_load(pool, device, card: str) -> dict:
    """(b) the closed-loop probe's sustained rate, then the open-loop
    trace at 0.5x / 2x (bursty, factor 4) / 0.5x of it through the
    router: outcomes, p50 / p99 / p99.9 by phase and class, sheds by
    class, overruns and timeouts."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.fleet import Router
    from sml_tpu_torch.loadgen import OpenLoopDriver, closed_loop_probe
    router = Router(pool)
    wait = float(GLOBAL_CONF.get("sml.load.resultTimeoutSec"))

    def score(X, priority, model):
        return router.score(X, priority, timeout=wait)
    _zero_launches()
    closed = closed_loop_probe(score, flt_spec(100.0).compile()[:FLT_PROBE],
                               feature_dim=N_FEAT)
    rate = len(closed) / (sum(closed) / 1e3)
    c0 = flt_counters()
    rep = OpenLoopDriver(score, flt_spec(rate).compile(),
                         feature_dim=N_FEAT, workers=FLT_WORKERS).run()
    launches = _all_launches()
    delta = {k: v - c0[k] for k, v in flt_counters().items()}
    closed_p99 = float(np.percentile(closed, 99))
    print(f"fleet (b) closed-loop probe: {len(closed)} requests, sustained "
          f"{rate!r} req/s, p50 {float(np.percentile(closed, 50))!r} p99 "
          f"{closed_p99!r} ms; open loop at {0.5 * rate!r} / {2 * rate!r} "
          f"(bursty x4) / {0.5 * rate!r} req/s: {rep['requests']} "
          f"requests in {rep['wall_s']!r} s, served {rep['served']}, shed "
          f"{rep['shed']}, timeout {rep['timeout']}, errors "
          f"{rep['errors']}, overrun {rep['overrun']} [{card}]")
    for name, ph in rep["phases"].items():
        cls = {c: (v["p50_ms"], v["p99_ms"], v["p999_ms"], v["count"])
               for c, v in ph["classes"].items()}
        print(f"fleet (b) {name}: p50 {ph['p50_ms']!r} p99 {ph['p99_ms']!r}"
              f" p99.9 {ph['p999_ms']!r} ms of {ph['requests']} requests, "
              f"worst {ph['worst_ms']!r} ms (trace {ph['worst_trace']}); "
              f"by class (p50, p99, p99.9 ms, n) {cls}")
    print(f"fleet (b) sheds by class: high {delta['fleet.shed.high']:g} "
          f"normal {delta['fleet.shed.normal']:g} low "
          f"{delta['fleet.shed.low']:g}, serve.shed.overflow "
          f"{delta['serve.shed.overflow']:g}; closed-loop p99 "
          f"{closed_p99!r} ms against the open loop's "
          f"{[ph['p99_ms'] for ph in rep['phases'].values()]}; "
          f"launches {launches}")
    if rep["overrun"]:
        # the driver shares the interpreter with the replicas' flush
        # threads: a fire it picks up late is the harness's fault, and
        # its latency is still charged from the schedule
        print(f"fleet (b) the HARNESS was at fault: {rep['overrun']} of "
              f"{rep['requests']} fires left the driver's pool more than "
              f"sml.load.overrunMicros after their scheduled instants")
    if rep["timeout"] or rep["errors"] or delta["load.timeout"]:
        raise AssertionError(f"(b) timeouts {rep['timeout']}, errors "
                             f"{rep['errors']}")
    # the router never sheds the top class: a high request that shed was
    # its replica's overflow (hostFallback is off by default)
    if delta["fleet.shed.high"] or not launches["forest_traverse"]:
        raise AssertionError(f"(b) counters {delta}, launches {launches}")
    return {"rate": rate, "closed_p50_ms": float(np.percentile(closed, 50)),
            "closed_p99_ms": closed_p99, "report": rep, "counters": delta,
            "launches": launches}


def flt_kill(pool, device, card: str) -> dict:
    """(c) a replica whose device call hangs while an open-loop replay
    runs takes a burst of top-class requests (the router breaks ties
    toward the lowest rid, so the hung replica is chosen as that) and is
    killed: every future resolves (its result, a re-route or a typed
    shed), every request it held is re-routed, the bundle is on disk;
    the autoscaler backfills to the floor."""
    from sml_tpu_torch.fleet import Autoscaler, Router
    from sml_tpu_torch.loadgen import OpenLoopDriver, PhaseSpec, TraceSpec
    from sml_tpu_torch.serving import RequestShed
    router = Router(pool)
    spec = TraceSpec(phases=(PhaseSpec("kill", FLT_KILL_S, FLT_KILL_RATE),),
                     widths=FLT_WIDTHS, classes=FLT_CLASSES, seed=22)
    result = {}

    def replay():
        result["rep"] = OpenLoopDriver(
            lambda X, p, m: router.score(X, p, timeout=30.0),
            spec.compile(), feature_dim=N_FEAT, workers=FLT_WORKERS).run()
    victim = min(r.rid for r in pool.replicas())
    hung = pool.get(victim)
    batcher = hung.endpoint._batcher
    score = batcher._score_block
    entered = threading.Event()

    def hang(X):
        # the device call does not return while the replica lives, so
        # its batch and the requests queued behind it are in flight at
        # the kill however fast the card drains; the replica's poison
        # check then raises ReplicaGone on them
        entered.set()
        while hung.alive:
            time.sleep(1e-4)
        return score(X)
    c0 = flt_counters()
    _zero_launches()
    t = threading.Thread(target=replay, name="fleet-kill-replay")
    t.start()
    time.sleep(FLT_KILL_S / 3)
    batcher._score_block = hang
    # a batch that entered the card before the hang drains first: then
    # either the hung call holds replay requests, or the victim stands
    # empty and takes the burst's first request
    while not entered.is_set() and hung.pressure():
        time.sleep(1e-4)
    X = np.zeros((8, N_FEAT), dtype=np.float32)
    futs = [router.submit(X, "high") for _ in range(FLT_KILL_BURST)]
    on_dead = [f.replica_id for f in futs].count(victim)
    bundle, kill_ms = walled(lambda: pool.kill(victim), device)
    outcomes = {"served": 0, "shed": 0}
    for f in futs:
        try:
            f.result(30.0)
            outcomes["served"] += 1
        except RequestShed:
            outcomes["shed"] += 1
    t.join()
    rep = result["rep"]
    delta = {k: v - c0[k] for k, v in flt_counters().items()}
    step = Autoscaler(pool, router, min_replicas=FLT_REPLICAS,
                      max_replicas=FLT_REPLICAS + 1).step()
    launches = _all_launches()
    out = {"victim": victim, "on_dead": on_dead, "burst": outcomes,
           "reroutes": delta["fleet.reroutes"], "kill_ms": kill_ms,
           "replay": {k: rep[k] for k in ("requests", "served", "shed",
                                          "timeout", "errors", "overrun")},
           "bundle_files": sorted(os.listdir(bundle)) if bundle else None,
           "autoscale": step, "size": pool.size(), "launches": launches}
    print(f"fleet (c) replica {victim} hung and killed in {kill_ms!r} ms "
          f"mid-replay with {on_dead} of {FLT_KILL_BURST} burst requests on "
          f"it: burst "
          f"{outcomes}, replay {out['replay']}, fleet.reroutes "
          f"{delta['fleet.reroutes']:g}; bundle {out['bundle_files']}; "
          f"autoscaler {step['action']} to {pool.size()} replicas; "
          f"launches {launches} [{card}]")
    if not out["bundle_files"] or "MANIFEST.json" not in out["bundle_files"]:
        raise AssertionError(f"(c) no bundle for the killed replica")
    if delta["fleet.reroutes"] < max(on_dead, 1) or rep["timeout"] \
            or rep["errors"]:
        raise AssertionError(f"(c) reroutes {delta['fleet.reroutes']}, "
                             f"replay {out['replay']}")
    if step["action"] != "backfill" or pool.size() != FLT_REPLICAS:
        raise AssertionError(f"(c) autoscaler {step}, {pool.size()} live")
    return out


def flt_ct(pool, X, logy, device, card: str, tmp: str) -> dict:
    """(d) a ContinuousTrainer promoting through the fleet over a Delta
    table of held-out rows: under minRefitRows -> accumulate; iid ->
    clean; feature 9 shifted -> a warm refit whose staged rollout
    promotes (every replica then serves v2, bit-equal to its
    `score_block`); a window built to fail the gate -> rollback, the
    candidate Archived, the failing replica evicted with its bundle."""
    from sml_tpu_torch.ct import CanaryGate, ContinuousTrainer, \
        DeltaChunkSource
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.tracking import _store
    cols = [f"c{j}" for j in range(N_FEAT)]
    path = os.path.join(tmp, "ct.delta")
    Xh, yh = X[80_000:], logy[80_000:]
    sd = float(np.nanstd(X[:80_000, OBS_FEATURE]))
    bounds = np.cumsum((0,) + CT_ROWS)
    windows = []
    for i, (lo, hi) in enumerate(zip(bounds[:-1], bounds[1:])):
        Xw, yw = Xh[lo:hi].copy(), yh[lo:hi].copy()
        if i == 2:
            Xw[:, OBS_FEATURE] += OBS_SHIFT * sd
        if i == 3:
            keep = GLOBAL_CONF.getInt("sml.ct.gateRows")
            yw[keep:] = np.random.default_rng(24).permutation(yw[keep:])
        windows.append((Xw, yw))
    trainer = ContinuousTrainer(
        FLT_NAME, DeltaChunkSource(path, cols, "label"), fleet=pool,
        gate=CanaryGate(min_mirrored=4), fit_params={"seed": 42},
        full_severity=1e9, device=device)
    cycles = []
    want = ["accumulate", "clean", "promoted", "rolled_back"]
    for i, (Xw, yw) in enumerate(windows):
        block = {c: Xw[:, j] for j, c in enumerate(cols)}
        block["label"] = yw
        get_session().createDataFrame(block).write.format("delta") \
            .mode("append" if i else "errorifexists").save(path)
        _zero_launches()
        rep, ms = walled(trainer.step, device)
        launches = _all_launches()
        gate = rep.get("gate") or {}
        cyc = {"action": rep["action"], "rows": rep["rows"],
               "severity": rep.get("severity"), "refit": rep.get("refit"),
               "version": rep.get("version"), "ms": ms,
               "passed": gate.get("passed"), "checks": gate.get("checks"),
               "stages": [(s["rid"], s["passed"])
                          for s in gate.get("stages", ())],
               "rmse": (gate.get("rmse_candidate"),
                        gate.get("rmse_incumbent")),
               "evicted": gate.get("evicted"),
               "bundle": bool(gate.get("blackbox")
                              and os.path.isdir(gate["blackbox"])),
               "launches": launches}
        cycles.append(cyc)
        print(f"fleet (d) cycle {i}: {cyc['action']} on {cyc['rows']} rows, "
              f"severity {cyc['severity']!r}, refit {cyc['refit']}, "
              f"{ms!r} ms; gate passed {cyc['passed']} checks "
              f"{cyc['checks']} stages {cyc['stages']} rmse (candidate, "
              f"incumbent) {cyc['rmse']}; evicted {cyc['evicted']}; "
              f"launches {launches} [{card}]")
        if cyc["action"] != want[i]:
            raise AssertionError(f"(d) cycle {i}: {rep}")
        if i == 2:
            if rep["refit"] != "warm" or launches["forest_traverse"] < 1 \
                    or not launches["hist_accumulate"]:
                raise AssertionError(f"(d) the drifted cycle: {cyc}")
            X64 = Xh[np.random.default_rng(6).integers(0, len(Xh), 64)]
            cyc["answers"] = flt_same_answers(
                pool, flt_version(FLT_NAME, 2), X64, device,
                "(d) after the promotion")
            if {r.endpoint.current_version() for r in pool.replicas()} \
                    != {2}:
                raise AssertionError("(d) a replica does not serve v2")
    stages = {v["version"]: v["current_stage"]
              for v in _store.list_model_versions(FLT_NAME)}
    last = cycles[3]
    if stages != {1: "Archived", 2: "Production", 3: "Archived"} \
            or not last["bundle"] or last["checks"].get("quality") \
            or pool.size() != FLT_REPLICAS - 1:
        raise AssertionError(f"(d) stages {stages}, last cycle {last}, "
                             f"{pool.size()} replicas")
    print(f"fleet (d) registry {stages}; {pool.size()} replicas after the "
          f"rollback's eviction")
    total = {}
    for c in cycles:
        for counts in (c["launches"], c.get("answers", {})):
            for k, v in counts.items():
                total[k] = total.get(k, 0) + v
    return {"cycles": cycles, "stages": stages, "launches": total}


def flt_stream(device, card: str, tmp: str) -> dict:
    """(e) MLE 00: the installed clean airbnb table as parquet parts of
    STREAM_PART_ROWS rows, `readStream` (maxFilesPerTrigger 1) ->
    VectorAssembler -> the LR model's `transform` -> a memory sink ->
    `spark.sql`; its predictions bit-equal to the batch transform; then
    a `StreamChunkSource` over the query into one trainer step()."""
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.ct import ContinuousTrainer, StreamChunkSource
    from sml_tpu_torch.courseware import ClassroomSetup
    from sml_tpu_torch.frame import parquet as ppq
    from sml_tpu_torch.frame._chunks import ArrayChunkSource
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml._chunked import fit_ensemble_chunked
    from sml_tpu_torch.ml.feature import VectorAssembler
    from sml_tpu_torch.ml.regression import (GBTRegressionModel,
                                             LinearRegression)
    spark = get_session()
    root, install_ms = walled(ClassroomSetup(
        base_dir=os.path.join(tmp, "classroom")).install_datasets, device)
    clean = os.path.join(root, "airbnb", "sf-listings",
                         "sf-listings-2019-03-06-clean.parquet")
    df = spark.read.parquet(clean).cache()
    whole = df._whole()
    n = df.count()
    src = os.path.join(tmp, "stream-src")
    os.makedirs(src)
    for i, lo in enumerate(range(0, n, STREAM_PART_ROWS)):
        ppq.write_table({k: v[lo:lo + STREAM_PART_ROWS]
                         for k, v in whole.items()},
                        os.path.join(src, f"part-{i:03d}.parquet"))
    vec = VectorAssembler(inputCols=["bedrooms", "accommodates"],
                          outputCol="features")
    lr = LinearRegression(labelCol="price").fit(vec.transform(df))
    stream = spark.readStream.format("parquet") \
        .option("maxFilesPerTrigger", 1).schema(df.schema).load(src)
    q = lr.transform(vec.transform(stream)).writeStream.format("memory") \
        .queryName("mle00_preds") \
        .option("checkpointLocation", os.path.join(tmp, "ckpt")) \
        .trigger(processingTime="0 seconds").start()
    try:
        _, stream_ms = walled(q.processAllAvailable, device)
        count = spark.sql("SELECT count(*) AS n FROM mle00_preds") \
            .collect()[0]["n"]
        got = np.concatenate([b["prediction"] for b in q._mem_parts])
        batch = lr.transform(vec.transform(df))._whole()["prediction"]
        batches = len(q.recentProgress)
        per_batch = [p["durationMs"] for p in q.recentProgress]
        # a tree model of the table's numeric columns, trained with the
        # recorder on (its drift baseline), and one trainer cycle over
        # the stream's committed micro-batches
        cols = list(STREAM_COLS)
        Xs = np.column_stack([whole[c] for c in cols]).astype(np.float64)
        _zero_launches()
        spec = fit_ensemble_chunked(
            ArrayChunkSource(Xs, whole["price"].astype(np.float64),
                             chunk_rows=STREAM_PART_ROWS),
            max_depth=4, max_bins=32, n_trees=10, boosting=True,
            step_size=0.3, seed=42, device=device)
        with mlflow.start_run():
            mlflow.spark.log_model(GBTRegressionModel(spec), "model",
                                   registered_model_name="airbnb-stream")
        mlflow.MlflowClient().transition_model_version_stage(
            "airbnb-stream", 1, "Production")
        src_chunks = StreamChunkSource(q, cols, "price",
                                       chunk_rows=STREAM_PART_ROWS)
        rep, step_ms = walled(ContinuousTrainer(
            "airbnb-stream", src_chunks, device=device).step, device)
        launches = _all_launches()
    finally:
        q.stop()
    out = {"rows": n, "files": len(os.listdir(src)), "count": count,
           "micro_batches": batches, "stream_ms": stream_ms,
           "micro_batch_ms": per_batch, "install_ms": install_ms,
           "trainer": {"action": rep["action"], "rows": rep["rows"],
                       "severity": rep.get("severity"), "ms": step_ms},
           "launches": launches}
    print(f"fleet (e) MLE 00: {n} clean rows in {out['files']} parquet "
          f"parts, {batches} micro-batches in {stream_ms!r} ms (per batch "
          f"{per_batch} ms), spark.sql count {count}, predictions "
          f"bit-equal to the batch transform: "
          f"{bool(np.array_equal(got, batch))}; StreamChunkSource -> "
          f"trainer step(): {out['trainer']}; launches {launches} [{card}]")
    if count != n or batches != out["files"] \
            or not np.array_equal(got, batch) or rep["action"] != "clean" \
            or rep["rows"] != n:
        raise AssertionError(f"(e) {out}")
    return out


def phase_fleet(seed: int, device, card: str, n_train: int = 80_000
                ) -> dict:
    """Phase 21: the fleet, the load harness, continuous training and
    streaming: ML 11's XGBoost (phase 8's rows, `n_train` of them; the
    recorder on, for its drift baseline) registered as FLT_NAME v1 in
    Production; with the recorder off, (a) the pool, (b) the open-loop
    load, (c) the kill and the backfill; with it on (reset after), (d)
    the trainer through the fleet and (e) MLE 00's stream and a trainer
    step over it. `n_train` cuts the seed fit's rows for a rehearsal on
    the CPU."""
    import shutil
    import tempfile
    from sml_tpu_torch import loadgen
    from sml_tpu_torch import obs
    from sml_tpu_torch import tracking as mlflow
    from sml_tpu_torch.conf import GLOBAL_CONF
    X, logy, cats = fit_rows(seed)
    tmp = tempfile.mkdtemp(prefix="sml-fleet-")
    prev_uri = mlflow.get_tracking_uri()
    mlflow.set_tracking_uri(os.path.join(tmp, "mlruns"))
    GLOBAL_CONF.set("sml.device", device.type)
    GLOBAL_CONF.set("sml.obs.blackboxDir", os.path.join(tmp, "blackbox"))
    t_phase = time.perf_counter()
    out = {"card": card}
    total: dict = {}
    pool = None

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    try:
        obs_recorder(True)
        with KernelWatch() as watch:
            _zero_launches()
            with mlflow.start_run():
                model, fit_ms = walled(lambda: _fit_xgb(
                    X[:n_train], logy[:n_train], cats, device), device)
            add(_all_launches())
            if model._spec.baseline is None:
                raise AssertionError("(fleet) the seed fit has no baseline")
            flt_register(model, FLT_NAME)
            print(f"fleet: ML 11 fit on {n_train} rows with the recorder "
                  f"on in {fit_ms!r} ms, registered {FLT_NAME} v1 "
                  f"Production [{card}]")
            # the load runs with the recorder off: it measures serving as
            # deployed (phase 20 measured what monitoring adds; here the
            # drift observer's ~1 ms a batch on three flush threads
            # tripled the burst's p50)
            obs_recorder(False)
            pool, out["a"] = flt_pool(X[80_000:], device, card, tmp)
            add(out["a"]["launches"])
            out["b"] = flt_load(pool, device, card)
            add(out["b"]["launches"])
            out["c"] = flt_kill(pool, device, card)
            add(out["c"]["launches"])
            # the refits stamp their baselines only with the recorder on
            obs_recorder(True)
            out["d"] = flt_ct(pool, X, logy, device, card, tmp)
            add(out["d"]["launches"])
            health = obs.engine_health()
            if health["fleet"] is None or health["load"] is None:
                raise AssertionError("(fleet) engine_health's fleet or load "
                                     "block is empty")
            out["health"] = {"fleet": health["fleet"]["pools"][0]["size"],
                             "load_requests": health["load"]["requests"]}
            pool.close()
            out["e"] = flt_stream(device, card, tmp)
            add(out["e"]["launches"])
        if watch.plain_on_cuda:
            raise AssertionError(f"(fleet) plain versions ran "
                                 f"{watch.plain_on_cuda} times on the card")
    finally:
        if pool is not None:
            pool.close()
        loadgen.reset()
        obs_recorder(False)
        GLOBAL_CONF.unset("sml.obs.blackboxDir")
        mlflow.set_tracking_uri(prev_uri)
        shutil.rmtree(tmp, ignore_errors=True)
    from sml_tpu_torch import fleet
    if fleet.fleet_report() is not None or obs.engine_health()["load"]:
        raise AssertionError("(fleet) a pool or a replay outlived the phase")
    missing = [k for k in ("forest_traverse", "hist_accumulate",
                           "split_scan") if not total.get(k)]
    if missing:
        raise AssertionError(f"(fleet) kernels never launched: {missing} "
                             f"({total})")
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"fleet: every check passed in {out['phase_s']!r} s; launches "
          f"{total}; card {card}")
    return out

# ------------------------------------------------------------ multi-rank
#: the fits of phase 22 (phase 8's ML 11 XGBoost and ML 07 random forest)
MR_FITS = ("xgb", "rf")
#: the launches of ranks: (ranks, backend); 4 ranks fit flat, then as 2
#: host groups
MR_LAUNCHES = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
MR_HOST_GROUPS = 2
#: seconds a launch of ranks may take
MR_TIMEOUT = 300

MR_CHILD = r"""
import json, os, sys, time
t_start = time.perf_counter()
sys.path.insert(0, ROOT)
import numpy as np
import torch
import torch.distributed as dist
import chip_smoke as cs
from sml_tpu_torch.conf import GLOBAL_CONF
from sml_tpu_torch.ml.inference import DeviceScorer
from sml_tpu_torch.native import traverse_kernel as tk
from sml_tpu_torch.parallel import collectives as coll, mesh as M
rank, n, backend, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
# each rank's prewarm manifest in a directory of its own
GLOBAL_CONF.set("sml.compile.cacheDir", os.path.join(out_dir, f"r{rank}"))
dev = torch.device(DEVICE)
if dev.type == "cuda":
    torch.cuda.set_device(dev)
else:    # a rehearsal on the CPU: the plain versions count as launches
    cs.count_plain_as_launches()
t0 = time.perf_counter()
if n == 1:   # a default group of one rank: every collective through it
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=1, rank=0,
                            device_id=dev if backend == "nccl" else None)
    M.bind_rank_device(dev)
else:
    assert coll.initialize_multihost("file://" + store, n, rank,
                                     backend=backend, device=dev,
                                     timeout_s=120)
out = {"rank": rank, "import_s": t0 - t_start,
       "init_s": time.perf_counter() - t0, "backend": dist.get_backend()}
X, logy, cats = cs.fit_rows(SEED)
Xtr, ytr, Xte = X[:80_000], logy[:80_000], X[80_000:]
layouts = ["flat"] + (["hosts"] if n == 4 else [])
for layout in layouts:
    if layout == "hosts":
        GLOBAL_CONF.set("sml.mesh.hostGroups", HOSTS)
        GLOBAL_CONF.set("sml.tree.hierarchicalAllreduce", "auto")
        M.set_mesh(M.host_mesh())
    for name in cs.MR_FITS:
        fit = cs.FITS[name][0]
        with cs.KernelWatch() as watch:
            for counts in cs._launch_counts():
                for k in counts:
                    counts[k] = 0
            tk.LAUNCHES = 0
            coll.reset_counts()
            dist.barrier()
            t0 = time.perf_counter()
            model = fit(Xtr, ytr, cats, None)
            cs._sync(dev)
            wall = time.perf_counter() - t0
            launches = cs._fit_launches()
            pred = DeviceScorer(model, device=dev).score_block(Xte)
            cs._sync(dev)
        launches["forest_traverse"] = tk.LAUNCHES
        spec = model._spec
        np.savez(os.path.join(out_dir, f"{layout}_{name}_{rank}.npz"),
                 base=np.asarray([spec.base], np.float32), pred=pred,
                 **{f: np.stack([getattr(t, f) for t in spec.trees])
                    for f in ("split_feature", "split_bin", "leaf_value",
                              "gain", "cover")})
        out[layout + "_" + name] = {
            "wall_ms": wall * 1e3, "launches": launches,
            "plain_on_cuda": watch.plain_on_cuda,
            "collectives": dict(coll.COUNTS),
            "mesh": repr(M.get_mesh())}
dist.destroy_process_group()
print(json.dumps(out))
"""


def count_plain_as_launches() -> None:
    """For a rehearsal of phase 22 on the CPU: each plain version of a
    kernel adds one to its wrapper's launch count, as the kernel would on
    the card."""
    from sml_tpu_torch.native import hist_kernel as hk
    from sml_tpu_torch.native import prng_kernel as pk
    from sml_tpu_torch.native import traverse_kernel as tk

    def counted(mod, name, kernel):
        fn = getattr(mod, name)

        def call(*args, **kw):
            if kernel == "forest_traverse":
                tk.LAUNCHES += 1
            else:
                mod.LAUNCHES[kernel] += 1
            return fn(*args, **kw)
        setattr(mod, name, call)
    for mod, pairs in (("hist_kernel", FIT_WRAPPERS["hist_kernel"]),
                       ("prng_kernel", FIT_WRAPPERS["prng_kernel"])):
        for name, kernel in pairs:
            counted(hk if mod == "hist_kernel" else pk, f"{name}_plain",
                    kernel)
    counted(tk, "forest_margin_plain", "forest_traverse")


def mr_start(child: str, n: int, backend: str, seed: int, tmp: str, device,
             tag: str = ""):
    """Start `n` ranks of the rank script `child` (`MR_CHILD`, `MT_CHILD`)
    on `device` (the parent has built every library), on a store of
    their own in `tmp`; returns (the processes, n, backend)."""
    root = os.path.dirname(os.path.abspath(__file__))
    code = (child.replace("ROOT", repr(root))
            .replace("SEED", repr(seed)).replace("DEVICE", repr(str(device)))
            .replace("HOSTS", repr(MR_HOST_GROUPS)))
    env = dict(os.environ, OMP_NUM_THREADS="1", NCCL_DEBUG="WARN")
    env.setdefault("NCCL_SOCKET_IFNAME", "lo")
    store = os.path.join(tmp, f"store{tag}{n}")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, str(r), str(n), backend, store, tmp],
        cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(n)]
    return procs, n, backend


def mr_finish(launches: list, timeout: float = MR_TIMEOUT) -> list:
    """Wait for the ranks of every launch (`mr_start`), all under one
    `timeout`, killing what is left on the way out; returns each
    launch's ranks' JSON lines."""
    outs = []
    try:
        deadline = time.monotonic() + timeout
        for procs, _, _ in launches:
            outs.append([p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))
                for p in procs])
    finally:
        for procs, _, _ in launches:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.communicate()
    res = []
    for (procs, n, backend), got in zip(launches, outs):
        ranks = []
        for r, (p, (so, se)) in enumerate(zip(procs, got)):
            if p.returncode != 0:
                raise AssertionError(f"rank {r} of {n} ({backend}) failed "
                                     f"({p.returncode}):\n{se[-4000:]}")
            ranks.append(json.loads(so.strip().splitlines()[-1]))
        res.append(ranks)
    return res


def mr_launch(n: int, backend: str, seed: int, tmp: str, device) -> list:
    """Start `n` ranks of `MR_CHILD` on `device`, each under one timeout;
    returns each rank's JSON line."""
    return mr_finish([mr_start(MR_CHILD, n, backend, seed, tmp, device)])[0]


def mr_trees(tmp: str, layout: str, name: str, rank: int) -> dict:
    return dict(np.load(os.path.join(tmp, f"{layout}_{name}_{rank}.npz")))


def mr_compare(got: dict, ref, what: str) -> None:
    """Hold a rank's trees to the one-card model `ref` bit for bit, as
    `tests/test_torch_multirank.py` does on the CPU: an N-rank float64
    sum adds in another order than the one-rank sum, which could show in
    f32 only where it lies within its float64 error of an f32 rounding
    boundary, and the fit's sums do not."""
    for t, tree in enumerate(ref._spec.trees):
        for f in ("split_feature", "split_bin", "leaf_value", "gain",
                  "cover"):
            np.testing.assert_array_equal(got[f][t], getattr(tree, f),
                                          err_msg=f"{what} tree {t} {f}")
    if got["base"][0] != np.float32(ref._spec.base):
        raise AssertionError(f"{what}: base {got['base'][0]} != "
                             f"{ref._spec.base}")


def mr_payload(name: str) -> tuple:
    """(histogram bytes, leaf bytes, psum calls) of one fit of `name`: the
    float64 histograms of each level's left slots (1 at the root) x F x
    B x 3, each tree's 2^D x 3 leaf statistics, and one psum a level, a
    tree and the base."""
    D, T, B = 6, {"xgb": 40, "rf": 20}[name], {"xgb": 64, "rf": 40}[name]
    slots = [1] + [2 ** (L - 1) for L in range(1, D)]
    return (T * sum(N_FEAT * B * s * 3 * 8 for s in slots),
            T * 2 ** D * 3 * 8, T * (D + 1) + 1)


def phase_multirank(seed: int, device, card: str, fit: dict) -> dict:
    """22. multi-rank fit: phase 8's ML 11 XGBoost and ML 07 random forest
    over a mesh of ranks, each rank a process on cuda:0 fitting its block
    of the 80,000 rows. (a) NCCL, one rank: the trees bit-equal to phase
    8's; (b) gloo, 2 and 4 ranks: every rank's trees identical to every
    other rank's and to phase 8's, bit for bit (`mr_compare`); (c) the 4 ranks as 2 host groups: the same trees, and the
    "dcn" hop's bytes half the "ici" hop's. Each rank's launches are phase
    8's per fit, and one traversal scores its held-out rows, bit-equal
    to phase 8's model's scores."""
    import tempfile
    from sml_tpu_torch.ml.inference import DeviceScorer
    X, logy, cats = fit_rows(seed)
    Xte = X[80_000:]
    ref_pred = {name: DeviceScorer(fit[name], device=device).score_block(Xte)
                for name in MR_FITS}
    out = {"card": card, "launches": {k: 0 for k in
                                      ("hist_accumulate", "split_scan",
                                       "row_weights", "feature_mask",
                                       "forest_traverse")}}
    solo = {}   # the one-rank walls
    with tempfile.TemporaryDirectory(prefix="sml-multirank-") as tmp:
        for n, backend in MR_LAUNCHES:
            if device.type == "cpu":    # a rehearsal: NCCL needs a card
                backend = "gloo"
            t0 = time.perf_counter()
            ranks = mr_launch(n, backend, seed, tmp, device)
            launch_s = time.perf_counter() - t0
            for layout in ("flat", "hosts") if n == 4 else ("flat",):
                cell = f"{n}x{backend}" + ("" if layout == "flat"
                                           else f" {MR_HOST_GROUPS} groups")
                for name in MR_FITS:
                    key = f"{layout}_{name}"
                    hist, leaf, calls = mr_payload(name)
                    trees = [mr_trees(tmp, layout, name, r)
                             for r in range(n)]
                    mr_compare(trees[0], fit[name], f"{cell} {name}")
                    for r in range(1, n):
                        for f, v in trees[0].items():
                            np.testing.assert_array_equal(
                                trees[r][f], v,
                                err_msg=f"{cell} {name}: rank {r} {f}")
                    for r, t in enumerate(trees):
                        np.testing.assert_array_equal(
                            t["pred"], ref_pred[name],
                            err_msg=f"{cell} {name}: rank {r}'s held-out "
                                    f"predictions")
                    for r, rk in enumerate(ranks):
                        got = rk[key]
                        want = dict(FITS[name][2], forest_traverse=1)
                        if got["launches"] != want:
                            raise AssertionError(
                                f"{cell} {name} rank {r}: launches "
                                f"{got['launches']}, not {want}")
                        if got["plain_on_cuda"]:
                            raise AssertionError(f"{cell} {name} rank {r}: "
                                                 f"a plain version ran on "
                                                 f"CUDA tensors")
                        for k, v in got["launches"].items():
                            out["launches"][k] += v
                        c = got["collectives"]
                        if layout == "flat":
                            ok = (c.get("collective.psum") == calls
                                  and c.get("collective.psum_bytes")
                                  == hist + leaf + 16)
                        else:
                            ok = (c.get("collective.psum.ici") == calls - 1
                                  and c.get("collective.psum_bytes.ici")
                                  == hist + leaf
                                  and c.get("collective.psum_bytes.dcn")
                                  == (hist + leaf) / 2
                                  and c.get("collective.psum_bytes") == 16)
                        if not ok:
                            raise AssertionError(f"{cell} {name} rank {r}: "
                                                 f"collectives {c}")
                    c = ranks[0][key]["collectives"]
                    rank_walls = [rk[key]["wall_ms"] for rk in ranks]
                    if n == 1:
                        solo[name] = rank_walls[0]
                    out[f"{cell} {name}"] = {
                        "wall_ms": rank_walls, "collectives": c,
                        "mesh": ranks[0][key]["mesh"]}
                    print(f"multirank {cell:<18} {name}: every rank's "
                          f"{len(fit[name]._spec.trees)} trees and held-out "
                          f"predictions bit-equal to phase 8's; wall "
                          f"{[round(w, 1) for w in rank_walls]} ms a rank "
                          f"(1 rank {solo[name]:.1f} ms; phase 8 "
                          f"first fit {fit['walls'][name] * 1e3:.1f} ms; "
                          f"ranks share the card: information only); "
                          f"collectives {c}  [{card}]")
            out[f"launch_s {n}x{backend}"] = launch_s
            print(f"multirank {n} rank(s) {backend}: launch {launch_s:.1f} s "
                  f"(import {[round(r['import_s'], 1) for r in ranks]} s, "
                  f"init {[round(r['init_s'], 2) for r in ranks]} s)")
    print("multirank: gloo all-reduces CUDA payloads natively; the two "
          "\"ici\" hops of (c) (reduce-scatter, all-gather) go through "
          "host memory under gloo")
    return out


# ------------------------------------- multi-rank tuning and warm start
#: phase 23's launches of ranks, started together: (ranks, backend)
MT_LAUNCHES = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
#: the fused grid's layouts (`sml.cv.trialAxisDevices`): rows split on
#: every launch; on 4 ranks also 2 lanes of 2 ranks and the auto width
MT_LAYOUTS = (("rows", 1), ("lanes2", 2), ("auto", 0))
#: (c)'s placed trials: parallelism 2 on 4 ranks, 2 groups of 2 ranks
MT_PLACED = 2
#: (e)'s elastic fit: rounds a segment (a checkpoint each), the host
#: group the chaos hook kills after the first checkpoint, and its rank
MT_SEGMENT = 4
MT_DEAD = 1
#: the fit parameters `checkpointed_fit` takes, from `CHUNK_XGB`
MT_ELASTIC_KEYS = ("n_trees", "max_depth", "max_bins", "seed", "loss",
                   "step_size", "subsample", "min_instances",
                   "min_info_gain", "reg_lambda", "gamma")

MT_CHILD = r"""
import inspect, json, os, sys, time
t_start = time.perf_counter()
sys.path.insert(0, ROOT)
import torch
import torch.distributed as dist
import chip_smoke as cs
from sml_tpu_torch.conf import GLOBAL_CONF
from sml_tpu_torch.parallel import collectives as coll, mesh as M
rank, n, backend, store, out_dir = (int(sys.argv[1]), int(sys.argv[2]),
                                    sys.argv[3], sys.argv[4], sys.argv[5])
# each rank's prewarm manifest in a directory of its own
GLOBAL_CONF.set("sml.compile.cacheDir", os.path.join(out_dir, f"t{n}r{rank}"))
dev = torch.device(DEVICE)
if dev.type == "cuda":
    torch.cuda.set_device(dev)
else:    # a rehearsal on the CPU: the plain versions count as launches
    cs.count_plain_as_launches()
t0 = time.perf_counter()
if n == 1:   # a default group of one rank: every collective through it
    dist.init_process_group(backend, init_method="file://" + store,
                            world_size=1, rank=0,
                            device_id=dev if backend == "nccl" else None)
    M.bind_rank_device(dev)
else:
    assert coll.initialize_multihost("file://" + store, n, rank,
                                     backend=backend, device=dev,
                                     timeout_s=120)
out = {"rank": rank, "import_s": t0 - t_start,
       "init_s": time.perf_counter() - t0, "backend": dist.get_backend(),
       "torch": torch.__version__,
       "local_sync": "use_local_synchronization"
       in inspect.signature(dist.new_group).parameters}
out.update(cs.mt_rank(n, rank, dev, SEED, out_dir))
dist.destroy_process_group()
print(json.dumps(out))
"""


def mt_measured(fn, dev):
    """(fn(), launches, host-clock ms, collective counts) of one call from
    zeroed counts, every rank of the default group starting it at once."""
    import torch.distributed as dist

    from sml_tpu_torch.parallel import collectives as coll
    _zero_launches()
    coll.reset_counts()
    dist.barrier()
    t0 = time.perf_counter()
    got = fn()
    _sync(dev)
    return (got, _all_launches(), (time.perf_counter() - t0) * 1e3,
            dict(coll.COUNTS))


FIELDS_OF_TREES = ("split_feature", "split_bin", "leaf_value", "gain",
                   "cover")


def mt_save(path: str, specs: dict) -> None:
    """Every table of every tree and the base of each spec of `specs`
    ({name: _EnsembleSpec}) to one .npz."""
    arrays = {}
    for name, spec in specs.items():
        for fld in FIELDS_OF_TREES:
            arrays[f"{name}/{fld}"] = np.stack([getattr(t, fld)
                                                for t in spec.trees])
        arrays[f"{name}/base"] = np.asarray([spec.base], np.float32)
    np.savez(path, **arrays)


def mt_same(path: str, specs: dict, what: str) -> None:
    """Hold the trees saved at `path` (`mt_save`) to `specs` bit for bit."""
    got = dict(np.load(path))
    for name, spec in specs.items():
        for fld in FIELDS_OF_TREES:
            np.testing.assert_array_equal(
                got[f"{name}/{fld}"],
                np.stack([getattr(t, fld) for t in spec.trees]),
                err_msg=f"{what} {name} {fld}")
        if got[f"{name}/base"][0] != np.float32(spec.base):
            raise AssertionError(f"{what} {name}: base {got[name + '/base']}"
                                 f" != {spec.base}")


def mt_rank(n: int, rank: int, dev, seed: int, out_dir: str) -> dict:
    """Phase 23 on one rank of `n`, every rank with the same inputs:
    (a)-(b) the ML 07 grid fused over the ranks in each layout of
    `MT_LAYOUTS` (rows split; on 4 ranks lanes of 2 and the auto width);
    (c) on 4 ranks the ML 07 CrossValidator as placed trials on 2 groups
    of 2 ranks; (d) on 2 and 4 ranks phase 13's ML 11 chunked XGBoost, 20
    rounds then 20 warm-started, each rank ingesting its host view; (e)
    on 4 ranks `elastic_fit` of the same XGBoost in 4 host groups, group
    `MT_DEAD` killed after its first checkpoint. Trees go to .npz files
    in `out_dir`; returns the launches, walls and collective counts."""
    from sml_tpu_torch import obs
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.ct import HostPreempted, elastic_fit
    from sml_tpu_torch.frame._chunks import ArrayChunkSource
    from sml_tpu_torch.ml import Pipeline
    from sml_tpu_torch.ml import _chunked as pch
    from sml_tpu_torch.ml import _tree_models as ptm
    from sml_tpu_torch.ml import tree_impl
    from sml_tpu_torch.parallel import mesh as M
    arg = "cpu" if dev.type == "cpu" else None
    GLOBAL_CONF.set("sml.device", dev.type)
    out = {}
    with KernelWatch() as watch:
        # (a), (b): the fused grid in each layout
        Xs, ys, _, cats = tune_folds(seed)
        trials = tune_grid()
        GLOBAL_CONF.set("sml.cv.maxFusedTrials", 16)
        for layout, knob in MT_LAYOUTS if n == 4 else MT_LAYOUTS[:1]:
            GLOBAL_CONF.set("sml.cv.trialAxisDevices", knob)
            clear_fit_caches()
            models, launches, ms, c = mt_measured(
                lambda: ptm.fit_cv_grid(Xs, ys, cats, trials, device=arg),
                dev)
            mt_save(os.path.join(out_dir, f"grid_{layout}_{n}_{rank}.npz"),
                    {f"{g}_{f}": sp for (g, f), sp in models.items()})
            out[f"grid {layout}"] = {
                "wall_ms": ms, "launches": launches, "collectives": c,
                "width": tree_impl._trial_axis_width(
                    len(models), max(len(y) for y in ys))}
        GLOBAL_CONF.unset("sml.cv.trialAxisDevices")
        GLOBAL_CONF.unset("sml.cv.maxFusedTrials")
        if n == 4:
            # (c) the ML 07 CrossValidator as placed trials over ranks
            train, _ = sel_frames(100_000)
            feat = Pipeline(stages=sel_prep()).fit(train).transform(train)
            feat.cache()
            rf = sel_rf()
            GLOBAL_CONF.set("sml.cv.batchFolds", False)
            mark = len(M.PLACEMENT_LOG)
            clear_fit_caches()
            cvm, launches, ms, c = mt_measured(
                lambda: sel_cv(rf, sel_grid(rf), MT_PLACED).fit(feat), dev)
            GLOBAL_CONF.unset("sml.cv.batchFolds")
            out["placed"] = {
                "avgMetrics": [float(m) for m in cvm.avgMetrics],
                "log": [[i, list(r)] for i, r in M.PLACEMENT_LOG[mark:]],
                "wall_ms": ms, "launches": launches, "collectives": c}
    out["plain_on_cuda"] = watch.plain_on_cuda
    if n < 2:
        return out
    with KernelWatch() as watch:
        # (d) 20 rounds, then 20 warm-started, each rank its host view
        X, logy, cats = fit_rows(seed)
        Xtr, ytr = X[:80_000], logy[:80_000]

        def src():
            return ArrayChunkSource(Xtr, ytr, chunk_rows=CHUNK_ROWS)
        xgb_kw = dict(CHUNK_XGB, categorical=cats)
        _clear_chunk_caches()
        part, l_part, ms_part, _ = mt_measured(
            lambda: pch.fit_ensemble_chunked(
                src(), device=arg, **dict(xgb_kw, n_trees=20)), dev)
        warm, launches, ms, c = mt_measured(
            lambda: pch.warm_start_ensemble_chunked(
                part, src(), n_new_trees=20, seed=42, step_size=0.15,
                reg_lambda=1.0, rounds_per_dispatch=5, device=arg), dev)
        mt_save(os.path.join(out_dir, f"warm_{n}_{rank}.npz"),
                {"xgb": warm})
        ing = pch.ingest_source(src(), CHUNK_XGB["max_bins"], cats,
                                device=arg)   # the fresh fit's, memoized
        out["warm"] = {"part_ms": ms_part, "part_launches": l_part,
                       "wall_ms": ms, "launches": launches,
                       "collectives": c, "block": ing.block,
                       "rows": int(ing.binned.shape[0])}
        if n == 4:
            # (e) elastic: group MT_DEAD's notice after the first checkpoint
            GLOBAL_CONF.set("sml.obs.enabled", True)
            obs.reset()
            fired = []

            def chaos(t_done):
                if rank == MT_DEAD and not fired:
                    fired.append(t_done)
                    raise HostPreempted(group=MT_DEAD)
            d = os.path.join(out_dir, "elastic")

            def fit():
                try:
                    return elastic_fit(
                        src(), d, hosts=4, on_checkpoint=chaos, device=arg,
                        rounds_per_dispatch=MT_SEGMENT, categorical=cats,
                        **{k: CHUNK_XGB[k] for k in MT_ELASTIC_KEYS})
                except HostPreempted as e:
                    return e
            got, launches, ms, c = mt_measured(fit, dev)
            counters = obs.RECORDER.counters()
            GLOBAL_CONF.set("sml.obs.enabled", False)
            if isinstance(got, HostPreempted):
                outcome = f"preempted {got.group}"
            else:
                outcome = "model"
                mt_save(os.path.join(out_dir, f"elastic_{rank}.npz"),
                        {"xgb": got})
            out["elastic"] = {
                "outcome": outcome, "fired_after": fired, "wall_ms": ms,
                "launches": launches, "collectives": c,
                "resume": counters.get("elastic.resume", 0),
                "repartition": counters.get("elastic.repartition", 0)}
    out["plain_on_cuda"] += watch.plain_on_cuda
    return out


def mt_payload(width: int, n: int) -> dict:
    """The collectives of one rank's fused fit of the ML 07 grid (20
    rounds of depth 5 at the maxima, F=10, B=40) over `n` ranks in
    `width` lanes: the rank's lane fits 12 / width elements over n /
    width ranks, with a float64 histogram psum a level (the left slots,
    one an element at the root), a leaf-statistics psum a round and the
    bases' one, and none on a lane of one rank beside other lanes; lanes
    then share their packs and bases in one all-gather (one rank's
    operand: E x (20 x 5 x 63 + 1) f32)."""
    T, D, B, nodes = 20, 5, 40, 2 ** 6 - 1
    E, lane = 12 // width, n // width
    slots = E * (1 + sum(2 ** (L - 1) for L in range(1, D)))
    merged = width == 1 or lane > 1
    return {"psum": T * (D + 1) + 1 if merged else 0,
            "psum_bytes": T * N_FEAT * B * slots * 3 * 8
            + T * E * 2 ** D * 3 * 8 + 2 * E * 8 if merged else 0,
            "all_gather_bytes": E * (T * 5 * nodes + 1) * 4
            if width > 1 else 0}


def phase_multirank_tuning(seed: int, device, card: str, tuning: dict,
                           selection: dict, fit: dict) -> dict:
    """23. multi-rank tuning and warm start: `mt_rank` on 1 (NCCL), 2 and
    4 (gloo) ranks on `device`, each rank a process, the three launches
    at once. Checks: (a) every rank's 12 grid elements bit-equal to phase
    9's fused fit (split tables, leaves, gains, covers, bases), with phase
    9's fused launches and the predicted psum calls and bytes; (b) the
    same trees in lanes of 2 ranks and at the auto width (4 lanes of 1
    rank: no psum, one all-gather of the packs); (c) the placed CV's
    avgMetrics equal to phase 12's bit for bit, both submeshes in
    `PLACEMENT_LOG`, each rank its group's launches; (d) the 20 + 20
    warm start bit-equal to phase 8's ML 11 fit, one replay traversal a
    rank, each rank ingesting its own host view; (e) the elastic fit's 3
    survivors bit-equal to phase 8's fit, `elastic.resume` counted once,
    the dead rank raising `HostPreempted`, the checkpoints cleared."""
    import tempfile
    from sml_tpu_torch.parallel.mesh import host_partition
    out = {"card": card, "launches": dict.fromkeys(CHUNK_KERNELS, 0)}
    trials = tune_grid()
    G = len(trials)
    grid_ref = {f"{g}_{f}": sp for (g, f), sp in tuning["models"].items()}
    fit_want = dict(expected_launches(trials, [list(range(G))]),
                    forest_traverse=0)
    xgb = {"xgb": fit["xgb"]._spec}
    with tempfile.TemporaryDirectory(prefix="sml-multirank-tuning-") as tmp:
        t0 = time.perf_counter()
        launches = [mr_start(MT_CHILD, n, "gloo" if device.type == "cpu"
                             else backend, seed, tmp, device, tag="mt")
                    for n, backend in MT_LAUNCHES]
        results = mr_finish(launches)
        out["launch_s"] = time.perf_counter() - t0
        for (_, n, backend), ranks in zip(launches, results):
            cell = f"{n}x{backend}"
            for r, rk in enumerate(ranks):
                if rk["plain_on_cuda"]:
                    raise AssertionError(f"{cell} rank {r}: a plain version "
                                         f"ran on CUDA tensors")
                for part in [k for k in rk if isinstance(rk[k], dict)
                             and "launches" in rk[k]]:
                    for k, v in rk[part]["launches"].items():
                        out["launches"][k] += v
                    if part == "warm":
                        for k, v in rk[part]["part_launches"].items():
                            out["launches"][k] += v
            # (a), (b): the grid
            for layout, _ in MT_LAYOUTS if n == 4 else MT_LAYOUTS[:1]:
                key = f"grid {layout}"
                width = ranks[0][key]["width"]
                want_width = {"rows": 1, "lanes2": 2, "auto": 4}[layout]
                if width != want_width:
                    raise AssertionError(f"{cell} {layout}: width {width}")
                lane = n // width
                pay = mt_payload(width, n)
                for r, rk in enumerate(ranks):
                    mt_same(os.path.join(tmp, f"grid_{layout}_{n}_{r}.npz"),
                            grid_ref, f"{cell} {layout} rank {r}")
                    if rk[key]["launches"] != fit_want:
                        raise AssertionError(
                            f"{cell} {layout} rank {r}: launches "
                            f"{rk[key]['launches']}, not {fit_want}")
                    c = rk[key]["collectives"]
                    got = {k: c.get("collective." + k, 0.0) for k in pay}
                    if got != pay:
                        raise AssertionError(f"{cell} {layout} rank {r}: "
                                             f"collectives {got}, not {pay}")
                walls = [rk[key]["wall_ms"] for rk in ranks]
                out[f"{cell} grid {layout}"] = {
                    "width": width, "wall_ms": walls, **pay}
                print(f"multirank_tuning {cell:<8} grid {layout:<6} "
                      f"(width {width}, {12 // width} elements a lane of "
                      f"{lane}): every rank's 12 elements bit-equal to "
                      f"phase 9's fused fit; launches {fit_want} a rank; "
                      f"psum {pay['psum']} calls {pay['psum_bytes']} bytes, "
                      f"all-gather {pay['all_gather_bytes']} bytes a rank; "
                      f"wall {[round(w, 1) for w in walls]} ms (ranks share "
                      f"the card: information only)  [{card}]")
            if n == 4:
                # (c) the placed CV
                avg = selection["a"]["avgMetrics"]
                for r, rk in enumerate(ranks):
                    pl = rk["placed"]
                    if pl["avgMetrics"] != avg:
                        raise AssertionError(f"(c) rank {r}: avgMetrics "
                                             f"{pl['avgMetrics']} != {avg}")
                    groups = {tuple(g) for _, g in pl["log"]}
                    if groups != {(0, 1), (2, 3)}:
                        raise AssertionError(f"(c) rank {r}: placements "
                                             f"{pl['log']}")
                    group = r // 2
                    rf = sel_rf()
                    grid = sel_grid(rf)
                    points = [sel_point(rf, pm) for pm in grid]
                    jobs = [i for i in range(len(points) * SEL_FOLDS)
                            if i % MT_PLACED == group]
                    best = int(np.argmin(avg))
                    want = add_launches(
                        fits_launches([points[i % len(points)]
                                       for i in jobs], False),
                        fits_launches([points[best]], False),
                        {"forest_traverse": len(jobs)})
                    if pl["launches"] != want:
                        raise AssertionError(f"(c) rank {r}: launches "
                                             f"{pl['launches']}, not {want}")
                out["4 placed"] = {"avgMetrics": avg,
                                   "wall_ms": [rk["placed"]["wall_ms"]
                                               for rk in ranks]}
                print(f"multirank_tuning 4xgloo (c) ML 07 CrossValidator, "
                      f"placed trials at parallelism {MT_PLACED} "
                      f"(batchFolds off): avgMetrics {avg} equal to phase "
                      f"12's on every rank, trials on {sorted(groups)}, "
                      f"each rank its group's launches; walls "
                      f"{[round(w, 1) for w in out['4 placed']['wall_ms']]}"
                      f" ms  [{card}]")
            if n >= 2:
                # (d) the warm start over ranks
                for r, rk in enumerate(ranks):
                    w = rk["warm"]
                    start, stop = host_partition(80_000, n)[r]
                    if w["block"] != [start, 80_000] \
                            or w["rows"] != stop - start:
                        raise AssertionError(f"(d) {cell} rank {r}: block "
                                             f"{w['block']}, {w['rows']} "
                                             f"rows")
                    mt_same(os.path.join(tmp, f"warm_{n}_{r}.npz"), xgb,
                            f"(d) {cell} rank {r}")
                    want = {"hist_accumulate": 120, "split_scan": 120,
                            "feature_mask": 0, "row_weights": 0,
                            "forest_traverse": 1}
                    if w["launches"] != want:
                        raise AssertionError(f"(d) {cell} rank {r}: launches "
                                             f"{w['launches']}, not {want}")
                out[f"{cell} warm"] = {
                    "wall_ms": [rk["warm"]["wall_ms"] for rk in ranks],
                    "psum_bytes": ranks[0]["warm"]["collectives"].get(
                        "collective.psum_bytes")}
                print(f"multirank_tuning {cell:<8} (d) ML 11 chunked "
                      f"XGBoost, 20 rounds + 20 warm-started: every rank's "
                      f"40 trees bit-equal to phase 8's fit, each rank "
                      f"ingesting its host view "
                      f"{[rk['warm']['block'][0] for rk in ranks]}.. of "
                      f"80000 rows, one replay traversal a rank; warm walls "
                      f"{[round(v, 1) for v in out[cell + ' warm']['wall_ms']]}"
                      f" ms  [{card}]")
            if n == 4:
                # (e) elastic
                # a level kernel a level of each round a rank fitted: the
                # first segment on every rank, the rest on the survivors
                # after one replay of the checkpoint's rounds
                levels = CHUNK_XGB["max_depth"]
                for r, rk in enumerate(ranks):
                    e = rk["elastic"]
                    rounds = MT_SEGMENT if r == MT_DEAD \
                        else CHUNK_XGB["n_trees"]
                    want = {"hist_accumulate": rounds * levels,
                            "split_scan": rounds * levels,
                            "feature_mask": 0, "row_weights": 0,
                            "forest_traverse": int(r != MT_DEAD)}
                    if e["launches"] != want:
                        raise AssertionError(f"(e) rank {r}: launches "
                                             f"{e['launches']}, not {want}")
                    if r == MT_DEAD:
                        if e["outcome"] != f"preempted {MT_DEAD}":
                            raise AssertionError(f"(e) dead rank: {e}")
                        continue
                    if e["outcome"] != "model" or e["resume"] != 1 \
                            or e["repartition"] != 1:
                        raise AssertionError(f"(e) rank {r}: {e}")
                    mt_same(os.path.join(tmp, f"elastic_{r}.npz"), xgb,
                            f"(e) rank {r}")
                if os.path.exists(os.path.join(tmp, "elastic")):
                    raise AssertionError("(e) the checkpoints were not "
                                         "cleared")
                out["4 elastic"] = {
                    "fired_after": ranks[MT_DEAD]["elastic"]["fired_after"],
                    "wall_ms": [rk["elastic"]["wall_ms"] for rk in ranks],
                    "launches": [rk["elastic"]["launches"] for rk in ranks]}
                print(f"multirank_tuning 4xgloo (e) elastic_fit in 4 host "
                      f"groups, group {MT_DEAD} preempted after round "
                      f"{out['4 elastic']['fired_after']}: the 3 survivors' "
                      f"40 trees bit-equal to phase 8's fit, elastic.resume "
                      f"1, the dead rank raised HostPreempted, checkpoints "
                      f"cleared, each rank a level kernel a level of its "
                      f"rounds and one replay a survivor; walls "
                      f"{[round(v, 1) for v in out['4 elastic']['wall_ms']]}"
                      f" ms, launches {out['4 elastic']['launches']}  "
                      f"[{card}]")
            out[f"{cell} ranks"] = [
                {k: rk[k] for k in ("import_s", "init_s", "backend", "torch",
                                    "local_sync")} for rk in ranks]
    print(f"multirank_tuning: the three launches together took "
          f"{out['launch_s']:.1f} s; torch {results[0][0]['torch']}, "
          f"new_group(use_local_synchronization=) "
          f"{results[0][0]['local_sync']}")
    return out


# ------------------------------- phase 24: the non-tree programs over ranks
#: phase 24's launches of ranks, started together: (ranks, backend); 4
#: ranks run flat, then as MR_HOST_GROUPS host groups
NR_LAUNCHES = ((1, "nccl"), (2, "gloo"), (4, "gloo"))
#: the ranks that fit ALS at the MovieLens 1M shape (flat only)
NR_ML1M_RANKS = (1, 4)
#: the ranks that fit under `sml.dispatch.mode=host` (f)
NR_HOST_RANKS = 2
#: seconds phase 24's three launches may take together
NR_TIMEOUT = 600
#: (a)'s compact programs: IRLS steps and tol, as phase 16's
NR_IRLS = dict(maxIter=12, tol=1e-6)
#: the programs of (a)-(d) in the order a rank runs them
NR_LINEAR = tuple(NT_LINEAR) + ("compact_gram", "compact_irls",
                                "logistic")
NR_KMEANS = ("km_k3", "km_k8")

NR_CHILD = MT_CHILD.replace("cs.mt_rank(", "cs.nr_rank(").replace(
    'f"t{n}r{rank}"', 'f"n{n}r{rank}"')


def nr_inputs(refs: dict, tmp: str, device, compact_rows: int) -> dict:
    """Write phase 24's inputs to `tmp` (phase 14's rows, and the ML 03
    compact block of `make_airbnb_dataset(compact_rows, seed=7)` as
    phase 16 builds it) and fit the compact programs once on `device`
    outside any mesh, the one-card results (a)'s compact ranks are held
    to; returns those."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.courseware import make_airbnb_dataset
    from sml_tpu_torch.frame.dataframe import DataFrame
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import linear_impl
    from sml_tpu_torch.ml._staging import extract_compact
    from sml_tpu_torch.ml.featurizer import try_fast_fit
    arrays = {k: refs[k] for k in ("ml02_X", "ml02_y", "ml03_X", "ml03_y",
                                   "logit_y", "km_X")}
    for shape in ("golden", "ml1m"):
        for part in ("train", "test"):
            for c, v in refs[f"als_{shape}"][part].items():
                arrays[f"{shape}_{part}_{c}"] = v
    np.savez(os.path.join(tmp, "nr_inputs.npz"), **arrays)
    cols = make_airbnb_dataset(n=compact_rows, seed=7)
    cols["label"] = (cols["price"] > np.median(cols["price"])).astype(
        np.float64)
    raw = get_session().createDataFrame(cols)._whole()
    del cols
    GLOBAL_CONF.unset("sml.linear.compactBytes")
    if compact_rows < FZ_COMPACT_ROWS:     # a rehearsal's few rows
        GLOBAL_CONF.set("sml.linear.compactBytes", 1)
    try:
        _, shim = try_fast_fit(fz_ml03(), raw,
                               lambda: DataFrame.from_partitions([raw]))
    finally:
        GLOBAL_CONF.unset("sml.linear.compactBytes")
    parts, y = extract_compact(shim, "features", "price")
    _, yl = extract_compact(shim, "features", "label")
    for k, v in (("num", parts.num), ("codes", parts.codes), ("y", y),
                 ("yl", yl)):
        np.save(os.path.join(tmp, f"nr_compact_{k}.npy"), v)
    with open(os.path.join(tmp, "nr_compact.json"), "w") as f:
        json.dump({"layout": parts.layout, "width": parts.width}, f)
    A, b, n, yy = linear_impl.gram_stats_compact(parts, y, device=device)
    fit = linear_impl.fit_logistic_compact(parts, yl, device=device,
                                           **NR_IRLS)
    return {"compact_gram": np.concatenate([A.ravel(), b, [n, yy]]),
            "compact_irls": np.append(fit.coefficients,
                                      [fit.intercept, fit.iterations]),
            "width": parts.width, "rows": len(y)}


def nr_compact_parts(out_dir: str):
    """(CompactParts, y, binary y) from `nr_inputs`' files, memory-mapped."""
    from sml_tpu_torch.ml.featurizer import CompactParts
    with open(os.path.join(out_dir, "nr_compact.json")) as f:
        meta = json.load(f)
    arr = {k: np.load(os.path.join(out_dir, f"nr_compact_{k}.npy"),
                      mmap_mode="r") for k in ("num", "codes", "y", "yl")}
    layout = tuple(tuple(item) for item in meta["layout"])
    return (CompactParts(arr["num"], arr["codes"], layout, meta["width"],
                         None), arr["y"], arr["yl"])


def nr_rank(n: int, rank: int, dev, seed: int, out_dir: str) -> dict:
    """Phase 24 on one rank of `n`, every rank with the same inputs
    (`nr_inputs`): in each layout (flat; on 4 ranks also
    `MR_HOST_GROUPS` host groups) (a) ML 02, ML 03, ridge and elastic net
    and the compact Gram and IRLS, (b) MLE 03's logistic regression, (c)
    MLE 02's KMeans at k 3 and 8, (d) MLE 01's ALS at the golden shape
    (flat on `NR_ML1M_RANKS` ranks also the MovieLens 1M shape), each
    from zeroed counts, and (e) phase 12's ML 07 CrossValidator (fused)
    with its validation folds evaluated over the ranks, the rows of
    every traversal recorded; on `NR_HOST_RANKS` ranks (f) ML 03 under
    `sml.dispatch.mode=host`. Results go to .npz files in `out_dir`;
    returns the launches, walls and collective counts."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import (ALS, KMeans, LinearRegression,
                                  LogisticRegression, Pipeline)
    from sml_tpu_torch.ml import inference, linear_impl
    from sml_tpu_torch.ml.evaluation import RegressionEvaluator
    from sml_tpu_torch.parallel import mesh as M
    GLOBAL_CONF.set("sml.device", dev.type)
    inp = dict(np.load(os.path.join(out_dir, "nr_inputs.npz")))
    parts, y_c, yl_c = nr_compact_parts(out_dir)

    def frame(**cols):
        return get_session().createDataFrame(cols)

    lin = {"ml02": frame(features=inp["ml02_X"], price=inp["ml02_y"]),
           "ml03": frame(features=inp["ml03_X"], price=inp["ml03_y"])}
    logit = frame(features=inp["ml03_X"], label=inp["logit_y"])
    km = frame(features=inp["km_X"])
    ratings = {shape: {part: frame(**{c: inp[f"{shape}_{part}_{c}"]
                                      for c in ("userId", "movieId",
                                                "rating")})
                       for part in ("train", "test")}
               for shape in ("golden", "ml1m")}
    als_kw = dict(userCol="userId", itemCol="movieId", ratingCol="rating",
                  maxIter=10, regParam=0.1, seed=42, coldStartStrategy="drop")
    ev = RegressionEvaluator(labelCol="rating")
    programs = {
        **{name: (lambda kw=kw, name=name: _coefs(LinearRegression(
            labelCol="price", **kw).fit(
                lin["ml02" if name == "ml02" else "ml03"])))
           for name, kw in NT_LINEAR.items()},
        "compact_gram": lambda: np.concatenate([
            np.ravel(m) if np.ndim(m) else [m]
            for m in linear_impl.gram_stats_compact(parts, y_c)]),
        "compact_irls": lambda: (lambda f: np.append(
            f.coefficients, [f.intercept, f.iterations]))(
            linear_impl.fit_logistic_compact(parts, yl_c, **NR_IRLS)),
        "logistic": lambda: (lambda m: np.append(
            _coefs(m), m.summary.totalIterations))(
            LogisticRegression(labelCol="label").fit(logit)),
        **{f"km_k{k}": (lambda k=k: (lambda m: np.append(
            np.stack(m.clusterCenters()).ravel(), m.summary.trainingCost))(
            KMeans(k=k, maxIter=20, seed=221).fit(km))) for k in (3, 8)},
    }
    als_rank = {"golden": 8, "ml1m": 12}
    out = {}
    layouts = ["flat"] + (["hosts"] if n == 4 else [])
    for layout in layouts:
        if layout == "hosts":
            GLOBAL_CONF.set("sml.mesh.hostGroups", MR_HOST_GROUPS)
            GLOBAL_CONF.set("sml.tree.hierarchicalAllreduce", "auto")
            M.set_mesh(M.host_mesh())
        saved = {}
        with KernelWatch() as watch:
            for name, fn in programs.items():
                got, launches, ms, c = mt_measured(fn, dev)
                saved[name] = got
                out[f"{layout} {name}"] = {"wall_ms": ms,
                                           "launches": launches,
                                           "collectives": c}
            shapes = ["golden"] + (["ml1m"] if layout == "flat"
                                   and n in NR_ML1M_RANKS else [])
            for shape in shapes:
                model, launches, ms, c = mt_measured(
                    lambda: ALS(rank=als_rank[shape], **als_kw).fit(
                        ratings[shape]["train"]), dev)
                saved[f"als_{shape}"] = np.append(model._uf, model._if)
                rmse = ev.evaluate(model.transform(ratings[shape]["test"]))
                out[f"{layout} als_{shape}"] = {
                    "wall_ms": ms, "launches": launches, "collectives": c,
                    "rmse": rmse, "users": len(model._user_ids),
                    "items": len(model._item_ids)}
            # (e) the fused CV, each validation fold over the ranks
            train, _ = sel_frames(100_000)
            feat = Pipeline(stages=sel_prep()).fit(train).transform(train)
            feat.cache()
            rf = sel_rf()
            rows = []
            traverse = inference.forest_traverse

            def counted(binned, *a, **k):
                rows.append(int(binned.shape[0]))
                return traverse(binned, *a, **k)
            inference.forest_traverse = counted
            clear_fit_caches()
            try:
                cvm, launches, ms, c = mt_measured(
                    lambda: sel_cv(rf, sel_grid(rf), 4).fit(feat), dev)
            finally:
                inference.forest_traverse = traverse
            out[f"{layout} cv"] = {
                "avgMetrics": [float(m) for m in cvm.avgMetrics],
                "traverse_rows": rows, "wall_ms": ms, "launches": launches,
                "collectives": c}
        out[f"{layout} plain_on_cuda"] = watch.plain_on_cuda
        np.savez(os.path.join(out_dir, f"nr_{layout}_{n}_{rank}.npz"),
                 **saved)
    if n == NR_HOST_RANKS and dev.type == "cuda":
        # (f) the host route under the mesh: the plain CPU fit, all rows
        # (on the CPU, a rehearsal, the host route is the device route)
        GLOBAL_CONF.set("sml.dispatch.mode", "host")
        try:
            got, launches, ms, c = mt_measured(programs["ml03"], dev)
        finally:
            GLOBAL_CONF.unset("sml.dispatch.mode")
        np.save(os.path.join(out_dir, f"nr_host_{rank}.npy"), got)
        out["host ml03"] = {"wall_ms": ms, "launches": launches,
                            "collectives": c}
    return out


def nr_payload(name: str, refs: dict, compact: dict, users_items=None
               ) -> list:
    """The float64 values of each all-reduce of one program of phase 24
    (the table of `ml/linear_impl.py`, `clustering.py` and
    `recommendation.py`): the Gram (d+1)^2 + (d+1) + 2; an IRLS step
    (d+1) + (d+1)^2 + 1; a Lloyd iteration k*(d+1), then the cost; an
    ALS half-step n_out * (r^2 + r + 1)."""
    if name in NT_LINEAR:
        d1 = refs["ml02_X" if name == "ml02" else "ml03_X"].shape[1] + 1
        return [d1 * d1 + d1 + 2]
    if name == "compact_gram":
        w1 = compact["width"] + 1
        return [w1 * w1 + w1 + 2]
    if name == "compact_irls":
        w1 = compact["width"] + 1
        return [w1 + w1 * w1 + 1] * NR_IRLS["maxIter"]
    if name == "logistic":
        d1 = refs["ml03_X"].shape[1] + 1
        return [d1 + d1 * d1 + 1] * int(refs["coef_logistic"][-1])
    if name.startswith("km_k"):
        k, d = int(name[4:]), refs["km_X"].shape[1]
        return [k * (d + 1)] * 20 + [1]
    r = {"als_golden": 8, "als_ml1m": 12}[name]
    per = r * r + r + 1
    U, I = users_items
    return [U * per, I * per] * 10


def nr_collectives_ok(c: dict, values: list, layout: str) -> bool:
    """Whether a program's collective counts are one MIN / MAX pair (the
    input check) and the all-reduces of `values` (flat: `psum`; host
    groups: the payload, padded to the group size, on the "ici" hop and
    half of it on the "dcn" hop)."""
    if c.get("collective.pmin") != 1 or c.get("collective.pmax") != 1:
        return False
    if layout == "flat":
        return (c.get("collective.psum") == len(values)
                and c.get("collective.psum_bytes") == 8 * sum(values))
    per = MR_HOST_GROUPS
    padded = [v + (-v) % per for v in values]
    return (c.get("collective.psum.ici") == len(values)
            and c.get("collective.psum_bytes.ici") == 8 * sum(padded)
            and c.get("collective.psum_bytes.dcn") == 8 * sum(padded) / per
            and "collective.psum_bytes" not in c)


def phase_multirank_nontree(device, card: str, nontree: dict,
                            selection: dict,
                            compact_rows: int = FZ_COMPACT_ROWS) -> dict:
    """24. the non-tree programs over ranks: `nr_rank` on 1 (NCCL), 2 and
    4 (gloo) ranks on `device`, each rank a process, the three launches
    at once, at phase 14's widths. Checks, on every rank of every
    layout: (a)-(c) the linear fits' coefficients, the compact Gram's
    moments and IRLS fit (`compact_rows` rows), the logistic fit, and
    KMeans' centers and cost bit-equal to phase 14's one-card results
    (the compact ones to the same programs fitted once here on the card
    outside any mesh), as the CPU tests found them; (d) ALS's factors
    within 2e-5 and its test rmse within `NT_RTOL` of phase 14's; (e) the
    CV's avgMetrics bit-equal to phase 12's (and so to phase 23's), its
    launches phase 12's, each traversal over the rank's blocks of its
    fold; (f) the host route's ML 03 fit bit-equal to phase 14's CPU fit
    with no launch and no collective. The non-tree fits launch no kernel,
    no plain version runs on the card, and each program's all-reduces
    carry its payload (`nr_payload`)."""
    import tempfile
    from sml_tpu_torch.ml.evaluation import eval_blocks
    refs = nontree["refs"]
    out = {"card": card, "launches": dict.fromkeys(CHUNK_KERNELS, 0)}
    rf = sel_rf()
    grid = sel_grid(rf)
    points = [sel_point(rf, pm) for pm in grid]
    elements = [p for p in points for _ in range(SEL_FOLDS)]
    avg = selection["a"]["avgMetrics"]
    cv_want = add_launches(fits_launches(elements, True),
                           fits_launches([points[int(np.argmin(avg))]],
                                         False),
                           {"forest_traverse": len(elements)})
    zero = dict.fromkeys(CHUNK_KERNELS, 0)
    with tempfile.TemporaryDirectory(prefix="sml-multirank-nontree-") as tmp:
        t0 = time.perf_counter()
        compact = nr_inputs(refs, tmp, device, compact_rows)
        out["inputs_s"] = time.perf_counter() - t0
        want = {name: refs[f"coef_{name}"] for name in NT_LINEAR}
        want.update(compact_gram=compact["compact_gram"],
                    compact_irls=compact["compact_irls"],
                    logistic=refs["coef_logistic"],
                    km_k3=refs["km_k3"], km_k8=refs["km_k8"])
        t0 = time.perf_counter()
        launches = [mr_start(NR_CHILD, n, "gloo" if device.type == "cpu"
                             else backend, 0, tmp, device, tag="nr")
                    for n, backend in NR_LAUNCHES]
        results = mr_finish(launches, NR_TIMEOUT)
        out["launch_s"] = time.perf_counter() - t0
        for (_, n, backend), ranks in zip(launches, results):
            cell = f"{n}x{backend}"
            for layout in ("flat", "hosts") if n == 4 else ("flat",):
                lc = cell + ("" if layout == "flat"
                             else f" {MR_HOST_GROUPS} groups")
                for r, rk in enumerate(ranks):
                    if rk[f"{layout} plain_on_cuda"]:
                        raise AssertionError(f"{lc} rank {r}: a plain "
                                             f"version ran on the card")
                    got = dict(np.load(os.path.join(
                        tmp, f"nr_{layout}_{n}_{r}.npz")))
                    for name, ref in want.items():
                        np.testing.assert_array_equal(
                            got[name], ref,
                            err_msg=f"{lc} rank {r} {name}")
                    shapes = [s for s in ("golden", "ml1m")
                              if f"als_{s}" in got]
                    for shape in shapes:
                        ref = refs[f"als_{shape}"]
                        diff = float(np.max(np.abs(got[f"als_{shape}"]
                                                   - ref["factors"])))
                        rmse = rk[f"{layout} als_{shape}"]["rmse"]
                        rk[f"{layout} als_{shape}"]["factor_max_diff"] = diff
                        if diff > 2e-5 or abs(rmse - ref["rmse"]) > \
                                NT_RTOL * ref["rmse"]:
                            raise AssertionError(
                                f"{lc} rank {r} ALS {shape}: factors "
                                f"{diff}, rmse {rmse} vs {ref['rmse']}")
                    for name in tuple(want) + tuple(f"als_{s}"
                                                    for s in shapes):
                        rec = rk[f"{layout} {name}"]
                        if rec["launches"] != zero:
                            raise AssertionError(f"{lc} rank {r} {name}: "
                                                 f"launches "
                                                 f"{rec['launches']}")
                        ui = (rec["users"], rec["items"]) \
                            if name.startswith("als") else None
                        values = nr_payload(name, refs, compact, ui)
                        if not nr_collectives_ok(rec["collectives"], values,
                                                 layout):
                            raise AssertionError(
                                f"{lc} rank {r} {name}: collectives "
                                f"{rec['collectives']}, payload {values}")
                    cv = rk[f"{layout} cv"]
                    if cv["avgMetrics"] != avg:
                        raise AssertionError(f"{lc} rank {r} (e): avgMetrics"
                                             f" {cv['avgMetrics']} != {avg}")
                    if cv["launches"] != cv_want:
                        raise AssertionError(f"{lc} rank {r} (e): launches "
                                             f"{cv['launches']}, not "
                                             f"{cv_want}")
                    for k, v in cv["launches"].items():
                        out["launches"][k] += v
                # (e) each traversal over the rank's whole blocks of its fold
                folds = [sum(rk[f"{layout} cv"]["traverse_rows"][i]
                             for rk in ranks)
                         for i in range(len(elements))]

                for r, rk in enumerate(ranks):
                    place = types.SimpleNamespace(size=n, rank=r)
                    mine = [eval_blocks(total, place)[2] for total in folds]
                    if rk[f"{layout} cv"]["traverse_rows"] != \
                            [s.stop - s.start for s in mine]:
                        raise AssertionError(
                            f"{lc} rank {r} (e): traversal rows "
                            f"{rk[f'{layout} cv']['traverse_rows']} of "
                            f"folds {folds}")
                rows0 = ranks[0][f"{layout} cv"]["traverse_rows"]
                walls = [round(rk[f"{layout} cv"]["wall_ms"], 1)
                         for rk in ranks]
                print(f"multirank_nontree {lc:<18} (e) ML 07 CrossValidator "
                      f"(fused): avgMetrics equal to phase 12's on every "
                      f"rank; launches {cv_want} a rank, each of the "
                      f"{len(rows0)} traversals over the rank's blocks "
                      f"(rank 0: {rows0} of folds {folds} rows); walls "
                      f"{walls} ms  [{card}]")
                for name in tuple(want) + ("als_golden", "als_ml1m"):
                    key = f"{layout} {name}"
                    if key not in ranks[0]:
                        continue
                    rec = ranks[0][key]
                    c = rec["collectives"]
                    calls = c.get("collective.psum",
                                  c.get("collective.psum.ici", 0))
                    nbytes = c.get("collective.psum_bytes",
                                   c.get("collective.psum_bytes.ici", 0))
                    extra = ""
                    if name.startswith("als"):
                        worst = max(rk[key]["factor_max_diff"]
                                    for rk in ranks)
                        extra = (f", factors max |diff| {worst!r}, rmse "
                                 f"{rec['rmse']!r}")
                    walls = [rk[key]["wall_ms"] for rk in ranks]
                    out[f"{lc} {name}"] = {
                        "psum_calls": calls, "psum_bytes": nbytes,
                        "dcn_bytes": c.get("collective.psum_bytes.dcn"),
                        "wall_ms": walls}
                    exact = "within tolerance" if name.startswith("als") \
                        else "bit-equal"
                    print(f"multirank_nontree {lc:<18} {name}: {exact} on "
                          f"every rank{extra}; no launch; psum {calls} calls "
                          f"{nbytes:.0f} bytes a rank (= the payload)"
                          + (f", dcn {c['collective.psum_bytes.dcn']:.0f}"
                             if layout == "hosts" else "")
                          + f"; wall {[round(v, 1) for v in walls]}"
                          f" ms (ranks share the card: information only)  "
                          f"[{card}]")
            if n == NR_HOST_RANKS and device.type == "cuda":
                for r, rk in enumerate(ranks):
                    got = np.load(os.path.join(tmp, f"nr_host_{r}.npy"))
                    np.testing.assert_array_equal(
                        got, refs["coef_ml03_cpu"],
                        err_msg=f"(f) rank {r}")
                    rec = rk["host ml03"]
                    if rec["launches"] != zero or rec["collectives"]:
                        raise AssertionError(f"(f) rank {r}: {rec}")
                print(f"multirank_nontree {cell:<18} (f) ML 03 under "
                      f"sml.dispatch.mode=host: the plain CPU fit over all "
                      f"rows on every rank, bit-equal to phase 14's CPU fit,"
                      f" no launch, no collective  [{card}]")
            out[f"{cell} ranks"] = [
                {k: rk[k] for k in ("import_s", "init_s", "backend")}
                for rk in ranks]
    print(f"multirank_nontree: inputs {out['inputs_s']:.1f} s, the three "
          f"launches together {out['launch_s']:.1f} s; forest_traverse "
          f"{out['launches']['forest_traverse']} launches in (e)")
    return out


#: modules a lint run must not import
LINT_FORBIDDEN = ("torch", "jax", "sml_tpu", "sml_tpu_torch")


def phase_lint(card: str) -> dict:
    """Phase 25: the port's lint on this machine's Python, in a fresh
    interpreter: `scripts/torch_lint.py --json` must exit 0, and `-X
    importtime`'s record of every import must hold none of
    LINT_FORBIDDEN. Returns the rule count, the suppressions and the
    wall (seconds, the whole subprocess), and the forbidden modules
    imported (none: the phase raises first), which the printed line
    leaves out (`lint_block`)."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime",
         os.path.join(root, "scripts", "torch_lint.py"), "--json"],
        cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"lint exited {proc.returncode}:\n{proc.stdout[-4000:]}\n"
            f"{proc.stderr[-2000:]}")
    imported = {line.rsplit("|", 1)[-1].strip()
                for line in proc.stderr.splitlines()
                if line.startswith("import time:")}
    bad = sorted(m for m in imported
                 if m.split(".")[0] in LINT_FORBIDDEN)
    if bad:
        raise AssertionError(f"the lint imported {bad}")
    report = json.loads(proc.stdout)
    if not report["clean"] or report["violations"]:
        raise AssertionError(f"lint not clean: {report['violations']}")
    out = {"rules": len(report["rules"]), "files": report["files"],
           "suppressed_pragma": report["suppressed"]["pragma"],
           "suppressed_baseline": report["suppressed"]["baseline"],
           "rules_s": sum(report["rule_times"].values()),
           "wall_s": wall, "modules_imported": len(imported),
           "python": sys.version.split()[0], "card": card,
           "forbidden_imported": bad}
    print(f"lint: {out['rules']} rules over {out['files']} files clean "
          f"({out['suppressed_pragma']} suppressed by pragma, "
          f"{out['suppressed_baseline']} by baseline), none of "
          f"{', '.join(LINT_FORBIDDEN)} imported, wall {wall!r} s "
          f"(rules {out['rules_s']!r} s); {card}")
    return out


def lint_block(lint: dict) -> dict:
    """Phase 25's printed block: its result less the forbidden modules
    imported, which only the run record carries."""
    return {k: v for k, v in lint.items() if k != "forbidden_imported"}


#: what phase 26 must find unloaded after the pandas-free imports
PD_FORBIDDEN = ("pandas", "pyarrow", "jax", "jaxlib", "sml_tpu")
#: the four conf keys of the pandas function API, with their defaults
PD_KEYS = {"sml.arrow.maxRecordsPerBatch": 10000,
           "spark.sql.execution.arrow.maxRecordsPerBatch": 10000,
           "sml.applyInPandas.parallelism": 8,
           "sml.shuffle.reuseBytes": 1 << 30}
#: rows a `mapInPandas` batch in ML 12's flow
PD_BATCH_ROWS = 100
PD_IMPORTS = r"""
import json, sys
from sml_tpu_torch import install_shims
install_shims()
import databricks.koalas as ks
from pyspark.sql.functions import pandas_udf
import sml_tpu_torch.pandas_api
from sml_tpu_torch.courseware import make_airbnb_dataset
from sml_tpu_torch.frame.session import get_session
df = get_session().createDataFrame(make_airbnb_dataset())
double = pandas_udf("double")(lambda s: s * 2.0)
built = [df.mapInPandas(lambda batches: batches, "price double"),
         df.groupBy("room_type").applyInPandas(lambda g: g,
                                               "room_type string"),
         df.select(double("price")), ks.DataFrame(df)]
bad = sorted(k for k in sys.modules if k.split(".")[0] in FORBIDDEN)
print(json.dumps({"built": len(built), "loaded": bad,
                  "koalas_is_port": ks is sml_tpu_torch.pandas_api}))
"""


def pd_available() -> bool:
    """Whether this Python can import pandas (False also where a caller
    blocked it with `sys.modules["pandas"] = None`)."""
    import importlib.util
    try:
        return importlib.util.find_spec("pandas") is not None
    except ValueError:
        return False


def pd_versions() -> dict:
    """The version of each module of pandas' stack this Python can import
    (None where it cannot), read from its installed metadata."""
    from importlib import metadata
    out = {}
    for name in ("pandas", "pyarrow", "scikit-learn", "matplotlib"):
        try:
            out[name] = metadata.version(name)
        except metadata.PackageNotFoundError:
            out[name] = None
    return out


def pd_imports() -> dict:
    """Phase 26 (a): in a fresh interpreter, `install_shims()`, the
    Koalas and `pandas_udf` imports, and a `mapInPandas`, an
    `applyInPandas`, a `pandas_udf` column and a Koalas frame built (not
    run) over the course's Airbnb frame load none of PD_FORBIDDEN."""
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-c",
         PD_IMPORTS.replace("FORBIDDEN", repr(PD_FORBIDDEN))],
        cwd=root, capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"the pandas-free imports failed:\n"
                             f"{proc.stderr[-3000:]}")
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    if out["loaded"] or not out["koalas_is_port"]:
        raise AssertionError(f"pandas-free imports: {out}")
    out["wall_s"] = wall
    return out


def pd_conf() -> dict:
    """Phase 26 (b): the four keys read their defaults, and setting the
    course's alias moves `sml.arrow.maxRecordsPerBatch`."""
    from sml_tpu_torch.conf import GLOBAL_CONF
    got = {k: GLOBAL_CONF.get(k) for k in PD_KEYS}
    if got != PD_KEYS:
        raise AssertionError(f"conf defaults {got} vs {PD_KEYS}")
    alias = "spark.sql.execution.arrow.maxRecordsPerBatch"
    GLOBAL_CONF.set(alias, 123)
    try:
        moved = GLOBAL_CONF.getInt("sml.arrow.maxRecordsPerBatch")
    finally:
        GLOBAL_CONF.unset(alias)
    if moved != 123 or GLOBAL_CONF.getInt("sml.arrow.maxRecordsPerBatch") \
            != PD_KEYS["sml.arrow.maxRecordsPerBatch"]:
        raise AssertionError(f"the alias moved the key to {moved}")
    return {"defaults": got, "alias_moves_key": True}


def pd_handouts(df, kdf) -> dict:
    """Phase 26 (c) without pandas: each action that hands a pandas
    object to user code raises the bridge's ImportError naming its API,
    chained from the import's own error. Anything else fails."""
    from sml_tpu_torch.frame.functions import pandas_udf
    double = pandas_udf("double")(lambda s: s * 2.0)
    actions = {
        "mapInPandas": lambda: df.mapInPandas(
            lambda batches: batches, "price double").count(),
        "applyInPandas": lambda: df.groupBy("room_type").applyInPandas(
            lambda g: g, "room_type string").count(),
        "pandas_udf": lambda: df.select(double("price")).collect(),
        "toPandas": df.toPandas,
        "Series.value_counts": lambda: kdf["room_type"].value_counts()}
    out = {}
    for api, action in actions.items():
        try:
            action()
        except ImportError as e:
            if not str(e).startswith(f"{api} hands pandas objects to user "
                                     f"code") \
                    or not isinstance(e.__cause__, ImportError):
                raise AssertionError(f"{api}: not the bridge's error: "
                                     f"{e!r}") from e
            out[api] = type(e.__cause__).__name__
            continue
        raise AssertionError(f"{api} ran with no pandas")
    return out


def pd_flows(scorer, test_df, df, device) -> dict:
    """Phase 26 (c) with pandas: ML 12's `mapInPandas` with a
    `DeviceScorer` inside (`tests/test_lessons.py:460-485`) and its
    scalar-iterator `pandas_udf` over every column (`ML 12:101-112`), in
    batches of PD_BATCH_ROWS, each bit-equal to `score_block` on the same
    rows with one traversal a batch; ML 13's `applyInPandas`, a least
    squares fit a room type (numpy: the card's machine has no sklearn),
    each group's result bit-equal to the same body on the group's rows
    filtered out of the frame; ML 14's `value_counts` summing to the
    rows."""
    import pandas as pd
    from sml_tpu_torch import functions as F
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.frame.column import block_len
    from sml_tpu_torch.pandas_api import DataFrame as KDataFrame

    def predict_map(batches):
        for features in batches:
            yield pd.DataFrame({"prediction": scorer(features)})

    @F.pandas_udf("double")
    def predict_udf(batches: Iterator[tuple]) -> Iterator[pd.Series]:
        for features in batches:
            yield pd.Series(scorer(pd.concat(features, axis=1)))

    runs = {"mapInPandas": lambda: test_df.mapInPandas(
                predict_map, "prediction double")._whole()["prediction"],
            "pandas_udf": lambda: test_df.select(predict_udf(
                *test_df.columns).alias("p"))._whole()["p"]}
    want = scorer.score_block(scorer._prep(test_df))
    n_batches = sum(-(-block_len(p) // PD_BATCH_ROWS)
                    for p in test_df._materialize())
    out = {"rows": int(len(want)), "batches": n_batches}
    launches = dict.fromkeys(_all_launches(), 0)
    GLOBAL_CONF.set("sml.arrow.maxRecordsPerBatch", PD_BATCH_ROWS)
    try:
        for what, run in runs.items():
            _zero_launches()
            got, ms = walled(run, device)
            counts = _all_launches()
            dp_same_block({"prediction": got}, {"prediction": want},
                          f"ML 12 {what}")
            if counts["forest_traverse"] != n_batches:
                raise AssertionError(f"ML 12 {what}: "
                                     f"{counts['forest_traverse']} "
                                     f"traversals for {n_batches} batches")
            out[what] = {"ms": ms, "launches": counts["forest_traverse"]}
            for k, v in counts.items():
                launches[k] += v
    finally:
        GLOBAL_CONF.unset("sml.arrow.maxRecordsPerBatch")

    def train(pdf):
        X = np.column_stack([np.ones(len(pdf)), pdf["bedrooms"].to_numpy(),
                             pdf["accommodates"].to_numpy()])
        y = pdf["price"].to_numpy()
        coef = np.linalg.lstsq(X, y, rcond=None)[0]
        return pd.DataFrame({"room_type": [pdf["room_type"].iloc[0]],
                             "n_used": [len(pdf)],
                             "mse": [float(np.mean((X @ coef - y) ** 2))]})

    fits, ms = walled(lambda: df.groupby("room_type").applyInPandas(
        train, "room_type string, n_used bigint, mse double")._whole(),
        device)
    for i, rt in enumerate(fits["room_type"].tolist()):
        alone = train(df.filter(F.col("room_type") == rt).toPandas())
        if alone["mse"][0] != fits["mse"][i] \
                or alone["n_used"][0] != fits["n_used"][i]:
            raise AssertionError(f"ML 13: {rt} differs from its group alone")
    if int(fits["n_used"].sum()) != df.count():
        raise AssertionError("ML 13: the groups do not cover the frame")
    out["applyInPandas"] = {"groups": len(fits["room_type"]), "ms": ms}
    counts = KDataFrame(df)["room_type"].value_counts()
    if int(counts.sum()) != df.count():
        raise AssertionError("ML 14: value_counts misses rows")
    out["value_counts"] = {str(k): int(v) for k, v in counts.items()}
    out["launches"] = launches
    return out


class PdColumns:
    """pandas' column interface, which the bridge reads
    (`frame/_pandas.block_from_pandas`): `.columns`, and `frame[c]`
    with `.to_numpy()`. (e) hands it to the port's entry points in a
    pandas frame's place, so that the return path runs with or without
    pandas."""

    def __init__(self, block: dict):
        self._block = block
        self.columns = list(block)

    def __getitem__(self, c):
        return types.SimpleNamespace(to_numpy=lambda: self._block[c])


def pd_return_path(model, scorer, test_df, device, tmp: str) -> dict:
    """Phase 26 (e): the way back from user code. ML 12's UDF body hands
    `DeviceScorer` a pandas batch, and the pyfunc model's `predict` takes
    one; both read it through the bridge with no pandas, and score it on
    the card, bit-equal to `score_block`."""
    from sml_tpu_torch import tracking as mlflow
    frame = PdColumns(test_df._whole())
    want = scorer.score_block(scorer._prep(test_df))
    prev_uri = mlflow.get_tracking_uri()
    mlflow.set_tracking_uri(os.path.join(tmp, "mlruns"))
    try:
        with mlflow.start_run() as run:
            mlflow.spark.log_model(model, "model")
        pyfunc = mlflow.pyfunc.load_model(f"runs:/{run.info.run_id}/model")
        _zero_launches()
        got = {"scorer": walled(lambda: scorer(frame), device),
               "pyfunc": walled(lambda: pyfunc.predict(frame), device)}
        launches = _all_launches()
    finally:
        mlflow.set_tracking_uri(prev_uri)
    for what, (pred, _) in got.items():
        dp_same_block({"prediction": np.asarray(pred)},
                      {"prediction": want}, f"(e) {what}")
    if launches["forest_traverse"] != len(got):
        raise AssertionError(f"(e): {launches['forest_traverse']} "
                             f"traversals for {len(got)} calls")
    return {"rows": int(len(want)), "launches": launches,
            "ms": {what: ms for what, (_, ms) in got.items()}}


def pd_koalas(path: str, df) -> dict:
    """Phase 26 (d): ML 14's operations that return port frames, over
    the course's Delta table, each equal to the port's direct frame
    result."""
    import sml_tpu_torch.pandas_api as ks
    kdf = ks.read_delta(path)
    cols = [c for c in df.columns if c in ("bedrooms", "price")]
    dp_same_block(kdf.filter(items=["bedrooms", "price"]).to_spark()
                  ._whole(), df.select(*cols)._whole(), "ks filter(items)")
    distinct = ks.sql("select distinct(room_type) from {kdf}") \
        .to_spark().count()
    want = {"distinct_room_types": df.select("room_type").distinct().count(),
            "len": df.count(), "shape": [df.count(), len(df.columns)]}
    got = {"distinct_room_types": distinct, "len": len(kdf),
           "shape": list(kdf.shape)}
    if got != want:
        raise AssertionError(f"koalas {got} vs the frame's {want}")
    return got


def phase_pandas(seed: int, device, card: str) -> dict:
    """Phase 26: the pandas function API and the Koalas layer on this
    machine's Python. (a) `pd_imports`; (b) `pd_conf`; the course's
    Delta table (`ClassroomSetup`'s install) read on `device` and ML 12's
    pipeline fitted on its 80% split; (c) `pd_handouts` where this
    Python has no pandas, else `pd_flows`; (d) `pd_koalas`; (e)
    `pd_return_path`. The launch counts are zeroed after the fit and
    read after (c) and (e): the "pandas" path."""
    import shutil
    import tempfile
    import sml_tpu_torch.pandas_api as ks
    from sml_tpu_torch.conf import GLOBAL_CONF
    from sml_tpu_torch.courseware import ClassroomSetup
    from sml_tpu_torch.frame.session import get_session
    from sml_tpu_torch.ml import DeviceScorer, Pipeline
    from sml_tpu_torch.ml.feature import StringIndexer, VectorAssembler
    from sml_tpu_torch.ml.regression import RandomForestRegressor
    t_phase = time.perf_counter()
    out = {"pandas": pd_available(), "versions": pd_versions(),
           "a": pd_imports(), "b": pd_conf()}
    print(f"pandas: versions {out['versions']}")
    print(f"pandas (a) pandas-free imports: {out['a']}")
    print(f"pandas (b) conf keys: {out['b']}")
    GLOBAL_CONF.set("sml.device", device.type)
    tmp = tempfile.mkdtemp(prefix="sml-pandas-")
    try:
        with KernelWatch() as watch:
            root = ClassroomSetup(base_dir=os.path.join(
                tmp, "classroom")).install_datasets()
            path = os.path.join(root, "airbnb", "sf-listings",
                                "sf-listings-2019-03-06-clean.delta")
            df = get_session().read.format("delta").load(path)
            train_df, test_df = df.randomSplit([.8, .2], seed=42)
            model = Pipeline(stages=[
                StringIndexer(inputCols=["room_type"],
                              outputCols=["room_typeIndex"],
                              handleInvalid="skip"),
                VectorAssembler(inputCols=["room_typeIndex", "bedrooms",
                                           "accommodates"],
                                outputCol="features"),
                RandomForestRegressor(labelCol="price", numTrees=5,
                                      maxDepth=4, seed=seed + 42)]
            ).fit(train_df)
            scorer = DeviceScorer(model, device=device)
            test_df.cache()
            launches = dict.fromkeys(_all_launches(), 0)
            if out["pandas"]:
                out["c"] = pd_flows(scorer, test_df, df, device)
                for k, v in out["c"]["launches"].items():
                    launches[k] += v
            else:
                out["c"] = pd_handouts(df, ks.DataFrame(df))
            out["d"] = pd_koalas(path, df)
            out["e"] = pd_return_path(model, scorer, test_df, device, tmp)
            for k, v in out["e"]["launches"].items():
                launches[k] += v
        if watch.plain_on_cuda:
            raise AssertionError(f"a plain version ran {watch.plain_on_cuda} "
                                 f"times on the card")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t_phase
    out["card"] = card
    print(f"pandas (c) {'ML 12-14 flows' if out['pandas'] else 'hand-outs'}"
          f": {out['c']}")
    print(f"pandas (d) koalas: {out['d']}")
    print(f"pandas (e) return path: {out['e']}")
    print(f"pandas: wall {out['wall_s']!r} s, launches {launches}; {card}")
    return out


def host_cpu() -> dict:
    """The host CPU's model and logical count, from /proc/cpuinfo. Where
    the model name reads "unknown" (a virtual machine may hide it), the
    model is the vendor, family, model number and clock instead."""
    first, count = {}, 0
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if key == "processor":
                count += 1
            elif key:
                first.setdefault(key, value.strip())
    model = first.get("model name")
    if model in (None, "", "unknown"):
        model = (f"{first.get('vendor_id')} family "
                 f"{first.get('cpu family')} model {first.get('model')} "
                 f"at {first.get('cpu MHz')} MHz")
    return {"model": model, "count": count}


def git_commit() -> Optional[str]:
    """`git rev-parse HEAD` of the checkout, None outside one."""
    try:
        proc = subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            timeout=60, cwd=os.path.dirname(os.path.abspath(__file__)))
    except OSError:
        return None
    return proc.stdout.strip() if proc.returncode == 0 else None


def run_meta(seed: int, card: str, walls: dict, t_start: float,
             proofs: dict) -> dict:
    """The run record's own keys (`regress.META_KEYS`) but its shape."""
    return {"card": card, "host_cpu": host_cpu(),
            "versions": {"torch": torch.__version__,
                         "cuda": torch.version.cuda,
                         "python": sys.version.split()[0]},
            "commit": git_commit(), "seed": seed, "phases": dict(walls),
            "wall_s": time.perf_counter() - t_start, "proofs": dict(proofs)}


def write_record(record: dict, path: str) -> None:
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f)


def rg_injections(regress) -> list:
    """Phase 27's injections: (label, change) pairs, where change(doc)
    alters a copy of the run record and returns the (kind, key) of the
    one regression it must give, None for no finding at all, or False
    where the record lacks what it changes (the smaller record of
    `--only 27`)."""
    def launches(doc):
        for k in doc.get("kernels") or []:
            for path, n in k["launches_by_path"].items():
                if path not in regress.RACY_PATHS and n > 0:
                    k["launches_by_path"][path] = n + 1
                    return "kernel-launches", f"{k['name']}:{path}"
        return False

    def psum_bytes(doc):
        for blk in ("multirank_tuning", "multirank_nontree"):
            for layout, e in (doc.get(blk) or {}).items():
                if isinstance(e, dict) and (e.get("psum_bytes") or 0) > 0:
                    e["psum_bytes"] *= 1.02
                    return ("multirank-collective",
                            f"{blk}/{layout}/psum_bytes")
        return False

    def proof(doc):
        for path in (("nontree", "linear", "ml02", "coefficients_bit_equal"),
                     ("proofs", "pandas.handouts_equal_score_block"),
                     ("proofs", "ok")):
            node = doc
            for p in path[:-1]:
                node = node.get(p) or {}
            if node.get(path[-1]) is True:
                node[path[-1]] = False
                return "proof", ".".join(path)
        return False

    def block(doc):
        name = "dataframe" if "dataframe" in doc else "pandas"
        doc.pop(name)
        return "missing-block", name

    def wall(doc):
        for name, s in doc["phases"].items():
            if name.split(" ", 1)[-1] not in regress.INFO_PHASES and s > 0:
                doc["phases"][name] = s * 1.25
                return "leg-wall", f"phase {name}"
        return False

    def lint_rules(doc):
        doc["lint"]["rules"] = 10
        return "lint-rule-floor", "rules"

    def racy(doc):
        for k in doc.get("kernels") or []:
            n = k["launches_by_path"].get("fleet", 0)
            if n >= 10:
                k["launches_by_path"]["fleet"] = -(-n * 11 // 10)
                return None
        return False

    return [("a deterministic path's launches +1", launches),
            ("a psum byte count +2%", psum_bytes),
            ("a bit-equal proof flipped", proof),
            ("a block removed", block),
            ("a phase wall +25%, same card", wall),
            ("lint rules at 10", lint_rules),
            ("a racy path's launches +10%", racy)]


def phase_regress(record: dict, path: str, card: str) -> dict:
    """Phase 27: the regression gate (`sml_tpu_torch/obs/regress.py`) on
    this run's own record. The record against itself gives no finding;
    each of `rg_injections` gives exactly its finding (or none); the same
    phase wall +25% on another card is not judged; the findings land in
    the flight recorder through `obs.annotate_regressions`; and
    `scripts/torch_bench_diff.py`, in a fresh interpreter under `-X
    importtime`, exits 0 on the written record and 1 on an injected one,
    importing none of LINT_FORBIDDEN. Every check raises on failure."""
    from sml_tpu_torch import GLOBAL_CONF, obs
    from sml_tpu_torch.obs import regress
    t0 = time.perf_counter()
    base = regress.normalize(record)
    self_diff = regress.compare(base, base)
    if self_diff["regressions"] or self_diff["improvements"] \
            or self_diff["not_comparable"] or not self_diff["checked"]:
        raise AssertionError(f"27: the record against itself: {self_diff}")
    out = {"self_checks": self_diff["checked"], "injections": {},
           "skipped": []}

    def judge(doc):
        return regress.compare(base, regress.normalize(doc))

    flagged = None
    for label, change in rg_injections(regress):
        doc = json.loads(json.dumps(record))
        want = change(doc)
        if want is False:
            out["skipped"].append(label)
            continue
        got = judge(doc)
        found = [(f["kind"], f["key"]) for f in got["regressions"]]
        if found != ([want] if want else []) or got["improvements"]:
            raise AssertionError(
                f"27 {label}: regressions {found}, improvements "
                f"{got['improvements']}; want {want}")
        out["injections"][label] = found[0][0] if found else "none"
        if found and flagged is None:
            flagged = (doc, got)
    doc = json.loads(json.dumps(record))
    key = "phase " + next(n for n, s in doc["phases"].items() if s > 0 and
                          n.split(" ", 1)[-1] not in regress.INFO_PHASES)
    doc["phases"][key[len("phase "):]] *= 1.25
    doc["card"] = "another card, 350.00 W"
    got = judge(doc)
    if got["regressions"] or key not in [
            f["key"] for f in got["not_comparable"]]:
        raise AssertionError(f"27 another card: regressions "
                             f"{got['regressions']}, {key} not listed as "
                             f"not comparable")
    out["injections"]["the same wall +25%, another card"] = \
        f"not comparable ({len(got['not_comparable'])} walls)"

    GLOBAL_CONF.set("sml.obs.enabled", True)
    obs.reset()
    try:
        n = obs.annotate_regressions(flagged[1]["regressions"])
        marks = [e for e in obs.RECORDER.events()
                 if e.name == "regress.verdict"]
    finally:
        GLOBAL_CONF.unset("sml.obs.enabled")
        obs.reset()
    if n != 1 or len(marks) != 1 or marks[0].args["key"] != \
            flagged[1]["regressions"][0]["key"]:
        raise AssertionError(f"27: {n} verdicts annotated, {len(marks)} "
                             f"in the recorder")

    root = os.path.dirname(os.path.abspath(__file__))
    injected = path + ".injected.json"
    write_record(flagged[0], injected)
    runs = {}
    try:
        for name, args in (("self", [path]), ("injected", [path, injected])):
            t = time.perf_counter()
            runs[name] = subprocess.run(
                [sys.executable, "-X", "importtime",
                 os.path.join(root, "scripts", "torch_bench_diff.py"),
                 *args, "--json"], cwd=root, capture_output=True, text=True,
                timeout=300)
            out[f"cli_{name}_s"] = time.perf_counter() - t
    finally:
        os.remove(injected)
    for name, rc in (("self", 0), ("injected", 1)):
        proc = runs[name]
        if proc.returncode != rc:
            raise AssertionError(f"27: torch_bench_diff.py ({name}) exited "
                                 f"{proc.returncode}:\n{proc.stdout[-3000:]}"
                                 f"\n{proc.stderr[-2000:]}")
        imported = {line.rsplit("|", 1)[-1].strip()
                    for line in proc.stderr.splitlines()
                    if line.startswith("import time:")}
        bad = sorted(m for m in imported
                     if m.split(".")[0] in LINT_FORBIDDEN)
        if bad:
            raise AssertionError(f"27: torch_bench_diff.py imported {bad}")
    if json.loads(runs["self"].stdout)["regressions"]:
        raise AssertionError("27: torch_bench_diff.py flagged the record "
                             "against itself")
    out["wall_s"] = time.perf_counter() - t0
    out["card"] = card
    print(f"regress: the record against itself {out['self_checks']} checks, "
          f"no finding; injections {out['injections']}"
          f"{'; skipped ' + str(out['skipped']) if out['skipped'] else ''}; "
          f"torch_bench_diff.py exits 0 / 1 importing none of "
          f"{', '.join(LINT_FORBIDDEN)}; wall {out['wall_s']!r} s; {card}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--only", choices=["23", "24", "25", "26", "27"],
                    default=None,
                    help="run phase 23, 24, 25, 26 or 27 and what it "
                         "compares with; no result line")
    ap.add_argument("--record", default=None, metavar="PATH",
                    help="write the run record (JSON) to PATH; with the "
                         "whole script or --only 27")
    args = ap.parse_args(argv)
    if args.record and args.only not in (None, "27"):
        ap.error("--record takes the whole script or --only 27")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from sml_tpu_torch.native import build
    from sml_tpu_torch.obs import regress
    t_start = time.perf_counter()
    walls = {}

    def timed(name: str, phase, *a, **kw):
        """Call one phase; its wall (seconds) adds to walls[name]."""
        t = time.perf_counter()
        try:
            return phase(*a, **kw)
        finally:
            walls[name] = walls.get(name, 0.0) + time.perf_counter() - t

    device = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    timed("02 build", build.build,
          build.kernel_sources() + build.host_sources())
    print(f"build: {build.kernel_sources()} (nvcc) and "
          f"{build.host_sources()} (g++) in {walls['02 build']:.1f} s")

    def regress_phase(blocks: dict, proofs: dict) -> None:
        """Phase 27 on this run's record, written to --record or to a
        temporary file removed after."""
        record = regress.record_from_blocks(
            blocks, run_meta(args.seed, card, walls, t_start,
                             dict(proofs, ok=True)))
        path = args.record
        tmp = None
        if not path:
            import tempfile
            tmp = tempfile.mkdtemp(prefix="chip_smoke_record_")
            path = os.path.join(tmp, "record.json")
        try:
            write_record(record, path)
            print(json.dumps({"regress": phase_regress(record, path,
                                                       card)}))
        finally:
            if tmp:
                import shutil
                shutil.rmtree(tmp, ignore_errors=True)
        if args.record:
            print(f"record: {args.record}")

    def handouts(pandas_: dict) -> str:
        return ("pandas.handouts_equal_score_block" if pandas_["pandas"]
                else "pandas.handouts_raise_import_error")

    if args.only == "23":
        print(json.dumps({"hist_f64": phase_hist_f64(args.seed, device)}))
        fit = phase_fit(args.seed, device)
        tuning = phase_tuning(args.seed, device, card)
        selection = phase_selection(device, card)
        print(json.dumps({"multirank_tuning": phase_multirank_tuning(
            args.seed, device, card, tuning, selection, fit)}))
        print(card)
        return 0
    if args.only == "25":
        print(json.dumps({"lint": lint_block(phase_lint(card))}))
        print(card)
        return 0
    if args.only == "26":
        print(json.dumps({"pandas": phase_pandas(args.seed, device, card)}))
        print(card)
        return 0
    if args.only == "27":
        lint = timed("25 lint", phase_lint, card)
        pandas_ = timed("26 pandas", phase_pandas, args.seed, device, card)
        print(json.dumps({"lint": lint_block(lint)}))
        print(json.dumps({"pandas": pandas_}))
        regress_phase({"lint": lint, "pandas": pandas_},
                      {handouts(pandas_): True})
        print(card)
        return 0
    if args.only == "24":
        selection = phase_selection(device, card)
        nontree = phase_nontree(device, card)
        print(json.dumps({"multirank_nontree": phase_multirank_nontree(
            device, card, nontree, selection)}))
        print(card)
        return 0
    err = timed("03 kernels", phase_kernels, args.seed, device)
    main_path = timed("04 main_path", phase_main_path, args.seed, device)
    times = timed("05 times", phase_times, args.seed, device, card)
    timed("06 breakdown", phase_breakdown, args.seed, device, card)
    binning = timed("06 breakdown", phase_binning, args.seed, card)
    fit_err = timed("07 fit_kernels", phase_fit_kernels, args.seed, device)
    fit_err.update(timed("07 fit_kernels", phase_draw_kernels, device))
    fit = timed("08 fit", phase_fit, args.seed, device)
    fit_times = timed("09 fit_times", phase_fit_times, args.seed, device,
                      card)
    draw_times = timed("09 fit_times", phase_draw_times, device, card)
    timed("09 fit_times", phase_fit_breakdown, args.seed, card,
          "ML 11 XgboostRegressor", _fit_xgb, fit_times["per_fit"])
    timed("09 fit_times", phase_fit_breakdown, args.seed, card,
          "ML 07 RandomForestRegressor", _fit_rf)
    tuning = timed("10 tuning", phase_tuning, args.seed, device, card)
    frames = timed("11 dataframe", phase_dataframe, device, card)
    selection = timed("12 selection", phase_selection, device, card)
    chunked = timed("13 chunked", phase_chunked, args.seed, device, card,
                    fit["xgb"])
    nontree = timed("14 nontree", phase_nontree, device, card)
    timeseries = timed("15 timeseries", phase_timeseries, args.seed, device,
                       card)
    featurizer = timed("16 featurizer", phase_featurizer, device, card)
    registry = timed("17 registry", phase_registry, device, card)
    dispatch = timed("18 dispatch", phase_dispatch, args.seed, device, card)
    dataplane = timed("19 dataplane", phase_dataplane, device, card)
    observed = timed("20 observed", phase_observed, args.seed, device, card)
    fleet = timed("21 fleet", phase_fleet, args.seed, device, card)
    multirank = timed("22 multirank", phase_multirank, args.seed, device,
                      card, fit)
    multirank_tuning = timed("23 multirank_tuning", phase_multirank_tuning,
                             args.seed, device, card, tuning, selection,
                             fit)
    multirank_nontree = timed("24 multirank_nontree",
                              phase_multirank_nontree, device, card,
                              nontree, selection)
    lint = timed("25 lint", phase_lint, card)
    pandas_ = timed("26 pandas", phase_pandas, args.seed, device, card)

    def by_path(kernel: str) -> dict:
        return {"fit": fit["launches"][kernel],
                "tuning": tuning["fused"][kernel],
                "dataframe": frames["fit"][kernel],
                "selection": SEL_LAUNCHES[kernel],
                "chunked": chunked["launches"][kernel],
                "featurizer": featurizer["launches"][kernel],
                "endpoint": registry["launches"]["endpoint"][kernel],
                "automl": registry["launches"]["automl"][kernel],
                "dispatch": dispatch["launches"][kernel],
                "dataplane": dataplane["launches"][kernel],
                "observed": observed["launches"][kernel],
                "fleet": fleet["launches"][kernel],
                "multirank": multirank["launches"][kernel],
                "multirank_tuning": multirank_tuning["launches"][kernel],
                "multirank_nontree": multirank_nontree["launches"][kernel],
                "pandas": pandas_["launches"][kernel]}

    def windows(kernel: str) -> dict:
        return {what: seen for what, seen in DEVICE_WINDOWS.items()
                if what.startswith(kernel)}

    k_ms, d_ms, p_ms, b_ms, b_by = times[100_000]
    kernels = [{
        "name": "forest_traverse", "route": "cuda",
        "device_windows": windows("forest_traverse"),
        "source": "sml_tpu_torch/csrc/forest_traverse.cu",
        "replaces": "sml_tpu/native/traverse_kernel.py:109",
        "launches": main_path["launches"]
        + tuning["fused"]["forest_traverse"]
        + frames["evaluate"]["forest_traverse"]
        + SEL_LAUNCHES["forest_traverse"]
        + chunked["launches"]["forest_traverse"]
        + featurizer["launches"]["forest_traverse"]
        + registry["launches"]["endpoint"]["forest_traverse"]
        + registry["launches"]["automl"]["forest_traverse"]
        + dispatch["launches"]["forest_traverse"]
        + dataplane["launches"]["forest_traverse"]
        + observed["launches"]["forest_traverse"]
        + fleet["launches"]["forest_traverse"]
        + multirank["launches"]["forest_traverse"]
        + multirank_tuning["launches"]["forest_traverse"]
        + multirank_nontree["launches"]["forest_traverse"]
        + pandas_["launches"]["forest_traverse"],
        "launches_by_path": {"serving": main_path["launches"],
                             "tuning": tuning["fused"]["forest_traverse"],
                             "dataframe": frames["evaluate"][
                                 "forest_traverse"],
                             "selection": SEL_LAUNCHES["forest_traverse"],
                             "chunked": chunked["launches"][
                                 "forest_traverse"],
                             "featurizer": featurizer["launches"][
                                 "forest_traverse"],
                             "endpoint": registry["launches"]["endpoint"][
                                 "forest_traverse"],
                             "automl": registry["launches"]["automl"][
                                 "forest_traverse"],
                             "dispatch": dispatch["launches"][
                                 "forest_traverse"],
                             "dataplane": dataplane["launches"][
                                 "forest_traverse"],
                             "observed": observed["launches"][
                                 "forest_traverse"],
                             "fleet": fleet["launches"][
                                 "forest_traverse"],
                             "multirank": multirank["launches"][
                                 "forest_traverse"],
                             "multirank_tuning": multirank_tuning[
                                 "launches"]["forest_traverse"],
                             "multirank_nontree": multirank_nontree[
                                 "launches"]["forest_traverse"],
                             "pandas": pandas_["launches"][
                                 "forest_traverse"]},
        "replay_launches": chunked["b"]["launches"]["forest_traverse"],
        "replay": chunked["replay"],
        "launches_by_rows": main_path["launches_by_rows"],
        "max_abs_err": err,
        "ms": k_ms, "device_ms": d_ms,
        "device_seen": seen_of("forest_traverse rows=100000"),
        "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None,
        "shape": "ML 11: T=40 depth=6 F=10 uint8, 100000 rows",
        "by_rows": {str(n): dict(zip(("ms", "device_ms", "plain_ms",
                                      "bound_ms", "bound_by"), times[n]),
                                 device_seen=seen_of(
                                     f"forest_traverse rows={n}"))
                    for n in TIME_ROWS}}]
    def numbers(t, keys=("ms", "device_ms", "plain_ms", "bound_ms",
                         "bound_by", "library_ms")) -> dict:
        return dict(zip(keys, t))

    ml11 = numbers(fit_times[("hist_accumulate", 16)])
    ml11["device_seen"] = seen_of("hist_accumulate S=16")
    kernels.append(dict(
        name="hist_accumulate", route="cuda",
        device_windows=windows("hist_accumulate"),
        source="sml_tpu_torch/csrc/hist_accumulate.cu",
        replaces="sml_tpu/native/hist_kernel.py:128",
        launches=sum(by_path("hist_accumulate").values()),
        launches_by_path=by_path("hist_accumulate"),
        max_abs_err=fit_err["hist_accumulate"],
        **numbers(fit_times[("hist_accumulate", "fused")]),
        device_seen=seen_of("hist_accumulate fused S=96"),
        shape="ML 07 grid fused: 640008 rows F=10 B=40 uint8, S=96",
        ml11=dict(ml11, shape="ML 11: 80000 rows F=10 B=64 uint8, S=16"),
        deterministic=True,
        f32_acc_ms=fit_times[("hist_f32acc", 16)][0],
        f32_acc_device_ms=fit_times[("hist_f32acc", 16)][1],
        f32_acc_device_seen=seen_of("hist_accumulate f32-accumulating S=16"),
        cells_off_cpu_f64=fit_times[("hist_f32acc", 16)][2],
        cells_off_cpu_f32=fit_times[("hist_f32acc", 16)][3],
        per_fit_device_ms=fit_times["per_fit"]["hist_accumulate"],
        host_us=fit_times["host_us"]["hist_accumulate"],
        f64_out=dict(fit_err["hist_f64"],
                     shape="phase 22's level 5: 40000 and 20000 rows "
                           "F=10 B=64 uint8, S=16; phase 23's fused grid "
                           "last level on one of 4 ranks: 160008 rows F=10 "
                           "B=40 uint8, S=96; float64 output")))
    kernels.append(dict(
        name="split_scan", route="cuda",
        device_windows=windows("split_scan"),
        source="sml_tpu_torch/csrc/split_scan.cu",
        replaces="sml_tpu/native/hist_kernel.py:202",
        launches=sum(by_path("split_scan").values()),
        launches_by_path=by_path("split_scan"),
        max_abs_err=fit_err["split_scan"],
        **numbers(fit_times[("split_scan", "fused")]),
        device_seen=seen_of(f"split_scan fused W={FUSED_NODES}"),
        shape="ML 07 grid fused: F=10 B=40 W=192 (12 x 16), per-node "
              "min_inst",
        ml11=dict(numbers(fit_times[("split_scan", 32)]),
                  device_seen=seen_of("split_scan W=32"),
                  shape="ML 11: F=10 B=64 W=32"),
        per_fit_device_ms=fit_times["per_fit"]["split_scan"],
        host_us=fit_times["host_us"]["split_scan"]))
    draws = "jax.random (XLA) at sml_tpu/ml/tree_impl.py:551-553, :785-796"

    def draw(kernel: str, case: DrawCase, rounds: int) -> dict:
        E = len(case.seeds)
        got = numbers(draw_times[(kernel, case.what, rounds)],
                      ("ms", "device_ms", "plain_ms", "bound_ms",
                       "bound_by", "rows_per_thread"))
        got["device_seen"] = seen_of(f"{kernel} {case.what}: {rounds} x "
                                     f"{E} x {case.n_pad} rows")
        return got

    kernels.append(dict(
        name="row_weights", route="cuda",
        device_windows=windows("row_weights"),
        source="sml_tpu_torch/csrc/threefry.cu", replaces=draws,
        launches=sum(by_path("row_weights").values()),
        launches_by_path=by_path("row_weights"),
        max_abs_err=fit_err["row_weights"],
        **draw("row_weights", FUSED_DRAWS, 20),
        library_ms=None,
        shape="ML 07 grid fused: 20 rounds x 12 elements x 53334 rows, "
              "Poisson rate 1, one launch a fit",
        ml07=dict(draw("row_weights", RF_DRAWS, 20),
                  shape="ML 07 RF: 20 rounds x 80000 rows, Poisson rate 1"),
        ml11_subsample=dict(draw("row_weights", SUB_DRAWS, 40),
                            shape="ML 11 subsample: 40 rounds x 80000 "
                                  "rows, Bernoulli 0.8"),
        one_round={c.what: draw("row_weights", c, 1)
                   for c in (RF_DRAWS, SUB_DRAWS, FUSED_DRAWS)},
        host_us=draw_times["host_us"]["row_weights"]))
    kernels.append(dict(
        name="feature_mask", route="cuda",
        device_windows=windows("feature_mask"),
        source="sml_tpu_torch/csrc/threefry.cu", replaces=draws,
        launches=sum(by_path("feature_mask").values()),
        launches_by_path=by_path("feature_mask"),
        max_abs_err=fit_err["feature_mask"],
        **draw("feature_mask", FUSED_DRAWS, 20),
        library_ms=None,
        shape="ML 07 grid fused: 20 rounds x 12 elements x 31 nodes, "
              "F=10 k=3, one launch a fit",
        ml07=dict(draw("feature_mask", RF_DRAWS, 20),
                  shape="ML 07 RF: 20 rounds x 63 nodes, F=10 k=3"),
        one_round={c.what: draw("feature_mask", c, 1)
                   for c in (RF_DRAWS, FUSED_DRAWS)},
        host_us=draw_times["host_us"]["feature_mask"]))
    host = dispatch["host_mode"]
    blocks = {
        "tuning": {
            "launches_fused": tuning["fused"],
            "launches_one_by_one": tuning["sequential"],
            "walls_ms": tuning["walls"], "busy_ms": tuning["busy"],
            "binning_ms_cpp_numpy": binning, "selection": selection},
        "chunked": {k: v for k, v in chunked.items() if k != "replay"},
        "nontree": {k: v for k, v in nontree.items() if k != "refs"},
        "timeseries": timeseries, "featurizer": featurizer,
        "registry": registry, "dispatch": dispatch, "dataplane": dataplane,
        "observed": observed, "fleet": fleet, "multirank": multirank,
        "multirank_tuning": multirank_tuning,
        "multirank_nontree": multirank_nontree, "lint": lint,
        "pandas": pandas_,
        "dataframe": {
            "launches_fit": frames["fit"], "launches_evaluate":
            frames["evaluate"], "rmse": frames["rmse"],
            "ml07_split_ms": frames["split_ms"]},
        "host_routes": [{
            "name": "forest_host", "route": "c++ (g++, host threads)",
            "source": "sml_tpu_torch/csrc/forest_host.cc",
            "replaces": "sml_tpu/ml/inference.py:600 (score_block_host: "
                        "predict_forest, XLA on the host mesh)",
            "calls": dispatch["host_traversals"]
            + sum(registry["endpoint"][f"canary_{f}"]["mirror_host_scored"]
                  for f in REG_CANARY),
            "calls_by_path": {
                "dispatch": dispatch["host_traversals"],
                "endpoint_canary": sum(
                    registry["endpoint"][f"canary_{f}"][
                        "mirror_host_scored"] for f in REG_CANARY)},
            "bit_equal_to_card": True,
            "by_rows": {str(n): host[n] for n in DSP_ROWS},
            "card": card}]}
    for name, block in blocks.items():
        print(json.dumps({name: lint_block(block) if name == "lint"
                          else block}))
    # what phases 22-24 and 26 assert before they return
    regress_phase(dict(blocks, kernels=kernels), {
        "multirank.trees_equal_one_card": True,
        "multirank_tuning.models_equal_one_card": True,
        "multirank_nontree.fits_match_one_card": True,
        handouts(pandas_): True})
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
