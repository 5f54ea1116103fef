#!/usr/bin/env python3
"""
Smoke test of gordo_tpu_torch on one NVIDIA GPU (written for an H100).

    python3 chip_smoke.py

Run from the root of a checkout; it builds the CUDA kernels from
``gordo_tpu_torch/ops/csrc`` if they are not built, then:

1. prints the card's name and power limit (``nvidia-smi``);
2. builds the kernels (one ``nvcc`` per source, all started together;
   ``[build]`` prints each build's registers, stack and spills);
3. holds K1 (the fleet dense-stack kernel) against its plain PyTorch
   version on the card: feedforward_hourglass(20) at 1000 members x 1008
   rows, feedforward_model(20)'s 256-wide defaults at 64 x 1008, every
   activation on both of the kernel's paths, ragged batches, gather
   indices with repeats, the ingest prologue, layers whose weights stream
   through the wide kernel's ring, odd widths, and the shapes the serving
   path uses;
4. trains the collection it then serves (``[train]``): 64 20-tag machines
   and 8 40-tag ones, each a ``DiffBasedAnomalyDetector`` of a MinMax
   pipeline and a feedforward_hourglass autoencoder (5 epochs, batch 32,
   ``examples/config.yaml``'s settings) on 2000 seeded rows, written as a
   project config in ``examples/config.yaml``'s dialect whose machines
   read CSV files (``FileDataProvider``), normalized to a shard and built
   by the ``build-fleet`` command's function on the card (each machine's
   fetched rows must equal its seeded rows): TimeSeriesSplit(3) cross-validation with
   every fold of every machine of a width in one stacked fit, the folds
   scored by one K1 launch a spec group (checked on the launch counter;
   each forward held against the plain version on its own inputs and
   timed: the 20-tag group's on the narrow kernel, the 40-tag group's on
   the wide one), the final fit, the dump. It prints each phase's wall
   time, steps a second, the CUDA-event time a step and one step's
   device time and the data fetch's time a machine; then it builds 4 of
   the machines again on the CPU from the same shard and holds the card's
   params, thresholds, CV scores and epochs to them. ``[config]`` then
   builds ``examples/config.yaml`` and 16 generated
   ``DiffBasedKFCVAnomalyDetector`` machines (4 weeks of seeded
   ``RandomDataProvider`` readings) in one ``build-fleet`` run: each
   build phase's time, K1 launched once a spec group in CV scoring (the
   KFCV group 80 fold models x ~807 rows), each forward against the
   plain version, 2 KFCV machines against a CPU build, and an anomaly
   request to a KFCV and an example machine on a card app and a CPU app;
5. serves that collection (64 feedforward_hourglass(20) detectors and 8
   feedforward_hourglass(40) ones, a 40-tag bucket which the store sends
   to the wide kernel) through ``build_app`` on a localhost
   ``wsgiref`` thread: three ``/anomaly/prediction`` requests and one
   fleet request for the 64, then one anomaly request to a 40-tag
   machine and one fleet request for the 8 (each 40-tag machine sent its
   own next rows), 1008 rows each; every answer
   must be 200, carry the right column groups, and agree with the same
   app on the CPU; K1's and K2's launch counts over each group of
   requests must be above zero;
6. times K1, its plain version and a cuBLAS ``baddbmm`` chain (the
   library yardstick, used nowhere in the package; also timed with TF32
   allowed, less accurate than the kernel, to show what cuBLAS gives on
   the tensor cores) with CUDA events, beside the card's bound for the
   same work (at the 3xTF32 tensor-core rate, with the CUDA-core f32
   bound beside it); and, at the hourglass(20) shapes, K1 against its
   build with ``FLEET_DENSE_WIDE_ONLY``, which runs them through the wide
   kernel instead of the narrow one (the measurement that keeps two
   kernels in the source).

``[lstm]`` (after ``[config]``) writes 16 LSTM machines as a project
config (``examples/model-configuration.yaml``'s settings, lookback 10,
20 tags, ``LSTM_ROWS`` (1000) seeded rows in ``FileDataProvider`` CSVs, ``LSTM_EPOCHS``
(1, the examples' 5 cut), batch 32, TimeSeriesSplit(3)): 8 lstm_hourglass autoencoders (15-10-10-15), 4
lstm_symmetric forecasters (64-32-32-64) and 4 lstm_model autoencoders at
its 256-128-64-64-128-256 defaults, each a ``DiffBasedAnomalyDetector``
over MinMax. It builds them on the card through ``build-fleet`` (every
``model_offset`` 9 or 10, one windowed CV forward a spec group) and prints
the phases, steps a second, and each group's CV step: kernel launches
and kernel time (``torch.profiler``), the device's idle share; builds one
machine an architecture again on the CPU and holds the card's params,
thresholds, CV scores, epochs and offsets to it; serves the collection
with 4 of ``[train]``'s feedforward machines from one app on the card and
one on the CPU: an anomaly request an architecture (999 rows out of an
autoencoder, 998 of a forecaster), a ``/prediction`` (held to an f64
forward if the apps differ) and a fleet request over all 20 machines,
which must launch K2 once, for the feedforward bucket; and ``[lstm
times]`` times the windowed forward at 1 x 1008 and 16 x 1008 rows for
lstm_model and the hourglass beside its bound and a cuDNN
``torch.nn.LSTM`` stack of the same layers (the yardstick, used nowhere
in the package). Before serving, ``[lstm]`` builds the same shard again
with ``GORDO_TPU_LSTM_SEGMENTED=4`` (``LSTM_SEGMENTS``; PR 18): its CV
folds stay windowed, every final fit must be segmented; it prints the
build's seconds beside the windowed build's, each group's final fit ms
an update against the windowed final fit's ms a step, and one segmented
update at the CV step's members (launches, kernel, device and host ms,
idle share) beside the windowed CV step; it holds ``LSTM_CPU_CHECK``'s
segmented card build to a segmented CPU build within
``LSTM_BUILD_LIMITS`` (a machine whose params pass the limit is held to
an f64 fit of the same member instead: the card at most ``F64_MULTIPLE``
times the CPU's distance), and a G = B bucket on the card to the
windowed fit.

``[arrow]`` (after ``[slo]``, on ``[serve]``'s app and socket; PR 18)
sends a 20-tag and a 40-tag anomaly request, a 20-tag and a 40-tag
``/prediction``, the 64-machine fleet request and two stream ingests of
64 rows a machine first as JSON, then as Arrow IPC bodies (``Accept``
the Arrow stream type; ``GDTAF1`` containers for the fleet and the
stream). Each Arrow answer, read by the port's ``decode_response`` and
``unpack_streams``, must equal its JSON twin to the bit (floats, index,
``start``/``end``, revision, the fleet's errors, the acks); it prints
both's ``Server-Timing`` stages and bytes; K1 must launch once a
per-model request and K2 once for the fleet request and once a flush.
Those K1 and K2 calls are held to the plain versions and timed under
``[times]`` and have rows of their own in the kernel JSON.

``[sequential]`` (after ``[lstm]``) drives the sequential build and the fleet
build's crash recovery. It builds three machines one at a time with
``ModelBuilder`` on the card (machine-000 of ``[train]``, 20 tags, K1's
narrow kernel; compressor-000, 40 tags, the wide one; lstm-hourglass-000
of ``[lstm]``; each at ``SEQUENTIAL_EPOCHS`` epochs), each fold's ``predict`` one K1 launch (3 a feedforward
machine, 0 for the LSTM, read on the counter; the last fold's forward of
each width held against the plain version on its own params and rows, M
= 1 x 500, and timed), prints each build's times beside the fleet
build's ms a machine, and holds each to a CPU ``ModelBuilder`` build of
the same machine within ``SEQUENTIAL_BUILD_LIMITS``. It runs ``python -m
gordo_tpu_torch build`` in a subprocess as a build pod does
(``MACHINE``, ``OUTPUT_DIR``, ``--print-cv-scores``,
``--model-register-dir``), serves the artifact from the card's app, and
runs the command's function once more in its own process with
``--model-register-dir``: a cache hit with the first's ``model.pkl``
bytes. Then the kill drill: ``build-fleet`` of 6 of
``[train]``'s machines in a subprocess with
``GORDO_TPU_FAULTS="process_kill_after_n_machines:*:after=2:kill"`` must
exit 137 with exactly 3 complete artifacts (the site fires after its
machine's artifact landed), ``build-fleet --resume`` must resume those 3
(their ``info.json`` unchanged) and build the other 3 within
``BUILD_LIMITS`` of ``[train]``'s artifacts, and the card's app must list
all 6. The kernel JSON's ``launches_by_path`` has a ``build`` key: the
sequential builds' launches; two of its rows are the fold forwards.

``[routes]`` then drives the rest of the JSON surface on the card's app
over the socket, each answer held to the CPU app's on the same
directories: ``/models``, ``/revisions``, ``/server-version``,
``/expected-models`` and a machine's ``/metadata``; ``/prediction`` for a
20-tag machine (K1's narrow kernel) and a 40-tag one (the wide kernel),
each a K1 launch, then both again pinned (``?revision=``) to a second
revision beside the first (copies of three 20-tag machines and one
40-tag machine, given a smoothing window of a day); a pin to a missing
revision (410); ``?all_columns`` on an anomaly request of the second
revision (14 column groups); ``Accept: text/csv`` (406); ``DELETE`` of
the served revision (409) and of one machine of the second (200), after
which a request pinned to it answers 404. It prints each request's
status and host ms.

``[observability]`` (after ``[routes]``, the same socket) sends
``[serve]``'s requests again (three 20-tag anomaly requests, the fleet
request of 64, a 40-tag anomaly request and the fleet request of 8, 1008
rows each), two ingests of 64 rows a machine on a fresh stream and a
burst of 8 anomaly requests through an engine app, with
``GORDO_TPU_TELEMETRY_DIR`` set and every request exported
(``GORDO_TPU_TRACE_SAMPLE_RATE=1``). It prints each request's
``Server-Timing`` by stage in ms and the share of its walltime the stages
cover; checks that each scoring request launched K1 or K2 and that every
launch (timed on its way to the kernel) lies inside an ``inference``
stage, an engine ``device`` span or a ``stream_score`` span; counts
``serve_trace.jsonl``'s spans by name and its bytes (one ``request`` span
a scoring request, every ``serve_batch`` linked to request spans of the
file); holds ``GET /fleet-health`` to what was sent (each machine's
requests and rows grew by it; the engine app feeds the same ledger, one a
directory for the process) and the residual mean of the rows sent to a
CPU app's on a copy of the collection after the same fleet and stream
requests; renders it with
``fleet-status``; and sends the same requests with
``GORDO_TPU_TELEMETRY=0``, printing both walls (not gated). The kernel
JSON's ``launches_by_path`` has an ``observability`` key: the traced
pass's launches.

``[slo]`` (right after ``[observability]``) reads back what that phase
exported. ``python -m gordo_tpu_torch trace DIR --as-json``, in a
process of its own, must count exactly the requests sent, by route and
status, and explain at least 90% of the median request's walltime by its
stages; it prints each stage's p50. The rollups (``RollupStore``) must
hold exactly the requests, errors, stream rows ingested and scored and
spans sent, one ``serve_batch`` span an engine batch; a second
aggregation must read no byte. ``GET /slo`` on the card app evaluates
that directory. Then the SLO drill runs on a card app over a copy of the
collection with a drill ``slos.toml`` (a 1% budget, the fast rule paging
at 10x): four clean anomaly requests and a fleet request of 16 rows, each
answer held to the CPU app's, four requests to a machine whose
``model.pkl`` is broken on disk (500), then eighty clean ones. ``slo
check`` must exit 0 (inactive), then 0 (pending) and 1 (firing) after the
burst, and 0 (resolved) after the clean traffic; after each stage
``/slo``, ``/fleet-health``'s ``slo`` section and ``fleet-status`` must
equal ``slo status --as-json``. Its K1 and K2 launches are the kernel
JSON's ``slo`` path, and the kernel JSON's own rows; K1 at the drill's
anomaly shape (a gather of 1 of 64 members, 16 rows, the ingest
prologue) and K2 at its fleet shape (4 of 64, 16 rows, y the rows) are
held to the plain versions in ``[kernel]`` and timed under ``[times]``.

K2, the fused anomaly scores (K1 with a per-row MSE epilogue, the same
source), is held the same way: against its plain version on both
kernel paths with ``y`` the input rows (with the ingest prologue), a
separate ``y``, a narrower ``y``, a NaN in ``y``, ragged rows, gather
indices with repeats and the wide-only build (``[kernel]``); the fleet
request must launch it (``[serve]``); and ``[stream]`` drives the
streaming plane over the socket on the same 64 machines with 64-row
watermark windows: one ingest of 1008 rows a machine and three of 64,
the SSE feed and the close, each answer equal to the CPU app's, K2
launched by every flush. ``[times]`` times K2 at six shapes (the wide
kernel's three among them) against its plain version, a ``baddbmm`` chain
plus ``torch.square(out - y).mean(-1)`` in f32 and with TF32, K1 alone at
the same shape, and its bounds.

``[engine]`` then serves the ``[train]`` collection through the
micro-batching engine (``GORDO_TPU_BATCHING``'s ``ServeEngine``, default
knobs but a 30 s batching deadline) on the card over the socket, beside the same app without it: C = 1
and 16 concurrent clients (32 before ``[ingress]`` was added and 8 before
``[mesh]`` was: the cuts pay for them), each on its own 20-tag machine with its own
next 1008 rows, on ``/anomaly/prediction`` then ``/prediction``, every
answer held to the CPU app's; it prints requests a second, p50 and p99
host latency with batching on and off, K1's launches, the engine's
batches, coalesced requests and mean batch, and checks that 16 clients
took fewer K1 launches than requests. One more burst of 16 clients on
``/anomaly/prediction`` runs an engine at every default knob, the 2000 ms
deadline included, and prints how many answered 504 (a reading, not a
check; the 200s are held to the CPU app's). Then 8 clients of the 40-tag
bucket (the wide kernel), a bf16 and an int8 round (the parity gate must
pass; each answer's anomaly verdicts against f32's), and a poisoned member
(``GORDO_TPU_FAULTS``' ``serve_member_poison``): its riders answer 200, it
answers 500 and then 503. The largest batch the engine launched at each
width (its bucket, indices, ingest plan and stacked rows, captured on the
way to K1) is held to K1's plain version and timed under ``[times]``
against its bound, its plain version and the ``baddbmm`` chain, beside
the bf16 and int8 forwards on the same tensors; so is a full batch that
the engine did not reach here (32 x 2048 x 20 gathered from 64 with the
ingest prologue, narrow; 8 x 2048 x 40, wide), on lines of its own.

``[telemetry]`` (right after ``[train]``) reads the files ``[train]``'s
build wrote beside its machines with telemetry on, the default, and
holds them to the build: ``build_status.json`` complete with the build's
counts and every phase's seconds; ``build_trace.jsonl`` with a
``build_phase`` span of every phase, one ``fleet_fit`` span a stacked
fit and one ``fleet_predict`` span a K1 launch of the build (read on
the counter); ``fleet_health.json``'s 72 machines, each with its
``metadata.json``'s final loss; ``fleet_plan.json``'s naive buckets equal
to the final fits the trainer ran; the ``device_utilization`` peak
against ``torch.cuda.max_memory_allocated()``; ``GET .../build-status``
over the socket equal to the file. It then builds the same shard once
more, with ``GORDO_TPU_TELEMETRY=0`` (no trace, status or ledger; the
same plan written; its launches are the kernel JSON's ``telemetry``
path), and prints both wall times (a second build with telemetry on was
cut in PR 18 to keep the smoke's time), the trace's bytes and the status
writes a second. The kill drill of ``[sequential]`` also checks the killed
build's ``build_status.json`` (``running``, 6 completed) and the
resumed one's (``complete``).

``[definitions]`` (after ``[engine]``) builds 26 machines of the model
definitions beyond the plain MinMax autoencoder, from CSVs through
``build-fleet`` on the card: 8 of ``examples/model-configuration.yaml``'s ``raw_spec``
block (16-4-20, tanh, tanh, linear; as a detector's base estimator, its
readings at unit scale), 8 ``StandardScaler`` pipelines with a
``RobustScaler`` error scaler, 4 ``MaxAbsScaler`` ones, 4 non-affine ones
(``InfImputer`` -> ``FunctionTransformer(multiply_by)`` -> clipping
``MinMaxScaler``, ``inf`` cells in an input-only tag) and 2 of
``examples/config-influx-callbacks.yaml``'s model block (10 epochs; 4 until
the smoke's phases were timed, each ~13 s alone),
which go to ``ModelBuilder``'s per-epoch host loop. One machine of each
kind is built again on the CPU and held to the card's within
``DEFINITIONS_BUILD_LIMITS`` (the callbacks machine within
``SEQUENTIAL_BUILD_LIMITS``, every fit's learning rates equal). The
engine then serves one anomaly request a kind (the non-affine bucket
host-transformed, without the prologue) and a fleet request over the
non-affine and raw-spec machines, K1 and K2 read on the counters, each
answer held to a CPU app's; the raw spec's CV forward, the
``StandardScaler`` bucket's and the non-affine bucket's served K1 gathers
and the non-affine bucket's K2 (``y`` the raw rows) are held to the plain
versions and timed under ``[times]``.

The narrow kernel's persistent loop has cases of its own, K1 and K2 (y =
X, a separate y, a NaN in y): many tiles a member (2 x 52,560 rows), more
tiles than resident blocks (2000 x 144), one member (1 x 1 and 1 x 1008),
and gather patterns in which a member leaves a block and comes back.
``[occupancy]`` prints the narrow kernel's launch at the hourglass(20)
shapes: lanes a row, shared memory, blocks an SM and grid; and the wide
kernel's at its timed shapes: weights resident or streamed, rows a tile,
warps a 16-row slice, shared memory, blocks an SM and grid. ``[times]``
prints the launch floor (a one-element ``zero_``) beside each served
shape and K1 at the served anomaly shape with its indices already on the
card, so the index copy shows apart. Where M x B rows make fewer tiles
than the card has SMs, the narrow kernel shares each row among lanes;
``[split]`` times that against the build with ``FLEET_DENSE_NO_SPLIT``,
which ``[kernel]`` also holds against the plain version.

``[metrics]`` lines read the Prometheus exposition
(``gordo_tpu_torch/server/prometheus/``) inside three phases, each
number held to what was built or sent. In ``[telemetry]``, the process
registry after [train]'s build and the telemetry-off one: the build's
machine gauges (72, 72, 0), each phase histogram's count against the
``build_phase`` spans of [train]'s trace (the phases of ``build_status.json``),
the compile histogram's count against the ``device_program`` first calls,
the final-loss count against the members trained, the plan's predicted
seconds against ``fleet_plan.json``. In ``[slo]``, the drill's card app has
``ENABLE_PROMETHEUS=true`` (its copy of the collection is revision
``DRILL_REVISION``), and ``/metrics``, served from the same process on a
socket of its own, is scraped before and after the drill: requests by
method and status grew by what was sent, ``errors_total{kind="server"}``
by the four 500s, the ``inference`` stage by the scoring answers; the SLO
gauges equal ``/slo``'s document, the health gauge sums to the process's
ledgers' machines, the resident bytes equal ``revision_stats()``, the
card's memory is there; K1 still 84 and K2 1 (a scrape launches nothing).
It prints the scrape's ms and bytes, then a warm-up pass and one pair of
16 anomaly requests with metrics on and off (walltimes, not gated), and
``observe()`` alone in microseconds. In ``[engine]``, the default-knob
round runs with metrics on: the batch-size histogram's count equals the
engine's batches and its sum the coalesced requests, the shed counter
the engine's shed counts (its deadline sheds at most the engine's, which
also count a waiter's own timeout).

``[lifecycle]`` (after ``[definitions]``) drives the fleet lifecycle
(``gordo_tpu_torch/lifecycle/``) on a card app over a copy of
``[train]``'s collection (without its health ledger, whose open breaker
from ``[engine]`` the supervisor's breaker feed, on as by default, would
nominate), the supervisor given the app's store: a healthy probe window of
every machine (the day after its training rows; scored by K2) drifts
nothing; a window in which ``machine-007`` and ``compressor-003`` moved 10
training stds drifts exactly those two, which ``rebuild_stale`` rebuilds
on the card from their newest rows, all drifted, replaying
``fleet_plan.json`` (K1 scores their CV folds), published as a canary
taking a quarter of the traffic; 16 anomaly requests before, during
(within one request of 4 from the canary, by the revision each answer
names) and after; the canary is gated (K2 on both fleets) and promoted
with requests running (none 5xx); a second drift (the two back where they
were) is rolled back by a gate the canary cannot pass and quarantined; a
new app over the base directory restores the promotion. Held:
``state.json``'s events in order, ``quarantine.json``, the health ledger's
drift, quarantine and promotion records, the ``gordo_fleet_lifecycle_*``
counters, the K1 launches and the K2 launches by step and width (counted
where they launch), the rebuilt machines against a CPU ``rebuild_stale``
(``BUILD_LIMITS``) and the gate's ratios against a CPU store's over the
same revisions (2e-5 relative). It
prints each step's seconds from the supervisor's span trace, the swap's
and the requests' p50 before, during and after; ``[times]`` has K1 at the
rebuild's CV forwards and K2 at the gates' shapes.

``[packing]`` (after ``[lifecycle]``) drives the packing planner and the
packed fit. A project of 24 machines (16 feedforward_hourglass(20) of
600-2000 rows, 8 of 40 tags of 580-2000; ``examples/config.yaml``'s
detector, ``[train]``'s epochs and batch, TimeSeriesSplit(3)) is planned by
``plan --strategy packed -o plan.json`` with a compile budget of 3 and a
4.5 MB bucket cap (``PACKING_BUDGET``, ``PACKING_HBM_CAP``): one merge
forced past the cost model's break-even, one rung split into siblings
sharing ``m_padded``; it prints that plan beside the naive plan and the
unbudgeted one of the same machines (planned in the smoke's process). ``build-fleet --plan-from plan.json`` with
``GORDO_TPU_PACKING=auto`` builds it on the card: every final fit the
plan's bucket (id, members, rows, ``m_padded``), the ``m_padded`` siblings
unpacked, the others packed x6 (20 tags) and x3 (40), the CV folds packed
live under the plan's strategy; each fit's steps a second, and one packed
step of the 20-tag CV bucket beside an unpacked one (launches, device ms,
paced ms, idle share). The 40-tag trio, alone in its rung, is built again
on the CPU from the same plan and packing (its packs are the card's) and
held to ``BUILD_LIMITS``; a card app serves 4 anomaly requests and a
fleet request of the 24 machines, equal to the CPU app's (K1 4, K2 2);
``plan --calibrate-from`` fits the card's factors from ``[train]``'s
``build_trace.jsonl`` and prints the calibrated plan beside the analytic
one. K1 at the packed build's CV forwards and K2 at the fleet request's
calls join ``[kernel]`` and ``[times]``.

``[ingress]`` (after ``[packing]``) drives every data input the JAX
package reads, with no pyarrow, pandas or network: the committed parquet
files pyarrow wrote (``tests/data/parquet/``, SNAPPY, GZIP and none,
dictionary pages, data pages v1 and v2) decoded to the numbers beside
them, and one ``build-fleet`` on the card of four 20-tag machines of
``[train]``'s width, detector, epochs and split: ``file-wide-000`` (a
wide parquet file the port's writer wrote), ``file-tags-000`` (a
directory of one parquet file a tag, two of them the committed pyarrow
fixtures), ``influx-000`` (InfluxDB 1.x's ``/query`` answered by an
``http.server`` on 127.0.0.1, which records each query: they must be the
JAX provider's InfluxQL byte for byte, ``INGRESS_INFLUXQL``, with basic
auth and the API key) and ``filtered-000`` (a CSV under a ``row_filter``
of backticks, ``&`` and a chained comparison dropping 10-30% of its
rows). The CV forward is one K1 launch, held to the plain version on the
build's own fold params and rows; each machine's X equals its CSV twin's
to the bit (filtered-000's after the same filter in numpy), each fetch
is timed beside its twin's, and a CPU build of the four is held to the
card's under ``BUILD_LIMITS``. A card app then answers a raw-parquet
``/prediction`` and a multipart-parquet (``X`` and ``y``)
``/anomaly/prediction``, both ``?format=parquet``: one K1 launch each,
counted where they launch, and each answer, read by the port's reader,
equal to the same request's JSON answer to the bit; their
``Server-Timing`` stages are printed beside the JSON twins'. Both K1
shapes are ``[times]`` cases and kernel-JSON rows.

``[mesh]`` (after ``[ingress]``) drives the device plane. Ingest:
Arrow anomaly requests for a 20-tag and a 40-tag ``[train]`` machine on a
card app without an engine, 10 rounds with ``GORDO_TPU_INGEST_DLPACK``
on (every request moved by the dlpack rung, counted) and off (none) in
alternating order, then a round of 8 concurrent 20-tag ones through an
engine on each rung; every answer equal to the bit across the rungs;
each rung's median ``device_ingest`` and ``data_decode`` ms, each
rider's staging and K1's launches printed. The sharded build: 16 of
``[train]``'s machines (12 of
20 tags, 4 of 40) built by the ``build-fleet`` command's function in two
processes on the one card, joined through ``JAX_PROCESS_COUNT``,
``JAX_PROCESS_INDEX`` and ``JAX_COORDINATOR_ADDRESS`` into a gloo group,
a ``(2, 1)`` mesh: each rank's CV forward of its block is one K1 launch a
width (counted in its process), rank 1 writes nothing, rank 0's
artifacts are held to ``[train]``'s one-process card build of the same
machines (``BUILD_LIMITS``) and its ``fleet_plan.json`` has ``mesh_shape`` [2, 1];
rank 0's narrow and wide blocks are held to the plain version and timed
under ``[times]``. The data axis: 8 20-tag members at ``(1, 2)`` in a new
group, the gradients all-reduced by gloo on CUDA tensors, held to
``(1, 1)`` on the card within the CPU test's rtol 1e-5, atol 1e-6. The
ring: an LSTM predict of a 16384-row series over ``["cuda:0",
"cuda:0"]`` against the windowed forward on one device (rtol 1e-5, atol
1e-6). With more than one card visible, the build runs once more over
NCCL through the command line (``python -m gordo_tpu_torch build-fleet
--device cuda``, which spawns a rank a card; the ranks above and the
reference build name ``cuda:0`` and never spawn); otherwise the phase
says it did not.

``[deploy]`` (after ``[mesh]``) runs the deploy pod's commands on
``[train]``'s collection: ``wait-for-models`` over its 72 names (exit 0)
and with an absent one and ``--timeout 1`` (exit 1, naming it);
``ensure-single-workflow`` for a revision, ``--check-only`` for the one
before it (stale, exit 1), and again past a planted guard an hour old;
``python -m gordo_tpu_torch run-server --batching`` in a process of its
own on the card (the seconds until ``/healthcheck`` answers 200). The
port's ``Client`` then sends ``predict`` (parquet) for two 20-tag
machines and a 40-tag one over the last ROWS of their own training rows,
``fleet_anomaly_scores`` over the 64 (a day of rows), ``metadata`` and
``download-model`` (the pickle loaded on the card, its params equal to
the file's), every frame held to the same client's answer from the CPU
app in this process. Then 8 ``/prediction`` requests wait in the
server's engine (a 3 s window) when SIGTERM comes: each is answered 200
well inside the window (the drain flushed it) and equal to the CPU app's,
``/healthcheck`` answers 503 ``draining`` meanwhile, and the process exits
0 within 60 s; the drain's seconds and the K1 and K2 launches of the
server's process come from the drain's log line. ``score --input`` a CSV
of a 20-tag and a 40-tag model's next rows runs on the card (one K1
launch each, counted here; each call held to the plain version and timed
under ``[times]``) and with ``--device cpu``: the two parquet files agree
within rtol 1e-5, atol 1e-5 (max abs and max rel printed). Last,
``cleanup-revisions`` of five numbered directories, with and without
``--dry-run``.

``[workflow]`` (after ``[deploy]``) renders a deploy with ``python -m
gordo_tpu_torch workflow generate``: a project config of two of
``[train]``'s 20-tag machines and a 40-tag one (their CSVs), the fleet a
``v5litepod-1`` slice (one builder pod of one card), InfluxDB on (so a
``PostgresReporter`` at ``gordo-postgres-<project>`` on every machine)
and remote logging on for one (an ``MlFlowReporter``); it prints the
documents by kind, the render's seconds and the validation's. It then
runs the rendered builder Job's own ``command``, ``args`` and ``env`` as
a process on the card, with the first shard's ``machines.yaml``,
replacing only the paths, ``python`` by this interpreter, the pod's
completion index by 0, the Postgres host by a stub of the Postgres
backend in this process (``gordo_tpu_torch/reporters/pgstub.py``:
SCRAM-SHA-256 with the user and password of the template's Postgres
StatefulSet) and adding ``GORDO_TPU_MLFLOW_DIR``, each printed. Held:
exit 0; one upsert a machine, each row's metadata equal to its
``metadata.json``; one MLflow run, of the remote-logging machine, its
metrics equal to its CV scores and its ``model_key`` the register's
cache key; K1 launched once for each spec group of the pod's
``fleet_plan.json``, read from the pod's log line, which counts K1's
launches in its process by shape. The stub then refuses the password
and one machine is built again (a cache hit): exit 90, the artifact
dumped first. Last, ``build --model-parameter n_epochs,1`` of a machine
whose model is a template string, with a ``sqlite:///`` Postgres
reporter, on the card: its CV score lines printed, its row equal to its
``metadata.json``, K1 once a fold. K1 is held to its plain version and
timed at each spec group's spec (the plan's) and the shape the pod
logged for it, with seeded params and rows.

``[perfmodel]`` (after ``[workflow]``) fits the learned performance
model (``gordo_tpu_torch/perfmodel/``) on the card's own batches. An app
with a batching engine on ``[train]``'s collection (ladders
``PERFMODEL_LADDERS``), every span exported to a fresh telemetry
directory, takes coalesced requests of the machines' own rows, a thread
each, released together: 1, 4 and 16 20-tag machines x 50, 200 and 1000
rows, three times; 2, 4 and 8 40-tag machines x 200 rows; one JSON
anomaly request; then engines at bf16 and int8 on the same store, 4
machines x each row count. Held: one ``serve_batch`` span a batch. The
``perfmodel fit`` command, a process, fits the corpus (at least 32
``device_ms/fleet_forward`` rows); it prints the populations, each
model's learned and analytic holdout log-MAE (the analytic constants are
the JAX package's) and the gate's verdict; a fit the gate refuses is
installed again with ``--force`` for what follows, and says so.
``perfmodel status`` and ``eval`` read the table; a recalibration
(``GORDO_TPU_PERFMODEL_RECAL=1``) over the same corpus must skip it. A
second app starts under ``GORDO_TPU_PERFMODEL=1``, ``_TABLE``,
``_WARMUP``, ``_BATCH_CAP_BYTES`` (the predicted bytes of the full
member ladder at the middle row rung, so the tallest rung is cut),
``_BREAKER`` and ``_PRECISION``: it prints its warmup order (held to the
predicted costs), the row caps and the precision nomination; the JSON
request sent again goes unbatched over the cap and must equal the first
engine's batched answer to the bit; a replay within the cap, then an
out-of-memory injected at ``serve_device_program`` in a batch of 8, which
must bisect, answer every rider and demote with ``model_informed``. The
``trace`` report prints the prediction accuracy of the first run
(analytic) and the replay (learned); ``plan`` of three of ``[train]``'s
machines with the table, knob off and on, prints the plan's ``learned``.
K1 is held to its plain version and timed at the corpus's largest f32
batch, captured on its way to the kernel.

``[seconds]`` lines give each phase's wall seconds as it ends, and one
line all of them. It prints one line per phase, then a JSON line with the kernel numbers,
then ``nvidia-smi``'s line, and last ``{"ok": true, "device": {...}}``.
Any failure exits non-zero before that last line; so does a machine
without CUDA, and a directory without the package.
"""

import base64
import collections
import contextlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import traceback
import types
import urllib.error
import urllib.request
from datetime import datetime, timedelta, timezone

HERE = os.path.dirname(os.path.abspath(__file__))

#: f32 sums taken in another order (kernel FMA chain vs cuBLAS/CPU BLAS)
RTOL, ATOL = 1e-5, 1e-5
#: where both apps' f32 forwards are themselves beyond ATOL of the exact
#: answer (rows far from what a model was trained on), the card's output may
#: lie at most this many times as far from an f64 forward as the CPU app's
F64_MULTIPLE = 2.0
#: H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, f32 FLOP/s outside tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
#: the fastest f32-accurate rate of the card: TF32 on the tensor cores (495
#: TFLOP/s dense), three products to an f32 one (3xTF32, the wide kernel's)
PEAK_3XTF32_FLOP_PER_S = 495e12 / 3
ROWS = 1008  # one week of 10-minute data
SERVED_MACHINES = 64
#: the 40-tag bucket served beside the 64 20-tag machines: its spec is wider
#: than 32, so the store sends it to the wide kernel
WIDE_MACHINES = 8
WIDE_TAGS = 40
#: the stream phase's watermark and its ingests: 1008 rows a machine, then
#: three of 64; snap_rows cuts 512, 512, 64 and 64 rows a machine
STREAM_WINDOW = 64
STREAM_POSTS = (ROWS, STREAM_WINDOW, STREAM_WINDOW, STREAM_WINDOW)
STREAM_SCORED = (512, 512, 64, 64)
#: [routes]: the served revision's name, a second one beside it, and the
#: smoothing window (a day of 10-minute rows) its detectors are given
REVISION = "1700000000000"
SECOND_REVISION = "1690000000000"
SMOOTH_WINDOW = 144
#: [routes]: what /expected-models lists (a YAML flow list, as deployments write it)
EXPECTED_MODELS = "[machine-000, compressor-000]"
TIMED = 6  # the first cases of kernel_cases(): the full widths and the served shapes
#: the 40-tag anomaly request's kernel shape (the wide kernel, 16-row tiles)
WIDE_ANOMALY = "served anomaly: hourglass40 gather M=1 B=1008 +ingest"
#: the wide kernel's timed shapes, K1 (and K2 with y = X)
WIDE_CASES = ("feedforward_model20 M=64 B=1008", "hourglass40 M=64 B=1008", WIDE_ANOMALY)
#: K1 in the build's CV scoring, by input width: 3 folds of each group's
#: machines x each fold's 500 test rows; the 20-tag group on the narrow
#: kernel, the 40-tag one on the wide kernel (a ragged last row tile)
CV_CASES = {20: "CV fold scoring: hourglass20 M=192 B=500", WIDE_TAGS: "CV fold scoring: hourglass40 M=24 B=500"}
CV_MACHINES = {20: SERVED_MACHINES, WIDE_TAGS: WIDE_MACHINES}
#: the ``[config]`` build's KFCV fold scoring: 16 machines x 5 folds, ~4032 / 5 test rows each
KFCV_CASE = "KFCV fold scoring: hourglass20 M=80"
#: the build of K1 that sends narrow specs through the wide kernel
WIDE_ONLY = ("FLEET_DENSE_WIDE_ONLY",)
#: the build of K1 whose narrow kernel never shares a row among lanes
NO_SPLIT = ("FLEET_DENSE_NO_SPLIT",)
#: the cases in which the narrow kernel shares each row among lanes (fewer
#: tiles than SMs), timed against NO_SPLIT
SPLIT_CASES = (
    "served anomaly: hourglass20 gather M=1 B=1008 +ingest",
    "one member: hourglass20 gather M=1 B=1008",
    "one row: hourglass20 gather M=1 B=1",
)
#: the hourglass(20) cases that the narrow kernel takes, timed against WIDE_ONLY
NARROW_CASES = (
    "hourglass20 M=1000 B=1008",
    "served fleet: hourglass20 M=64 B=1008 +ingest",
    "served anomaly: hourglass20 gather M=1 B=1008 +ingest",
)


class SmokeFailure(Exception):
    pass


def check(condition, message):
    if not condition:
        raise SmokeFailure(message)


def phase(name, detail):
    print(f"[{name}] {detail}", flush=True)


#: wall seconds of each timed phase, in the order they ran
PHASE_WALL = {}


@contextlib.contextmanager
def clocked(name):
    """Time the enclosed phase; print its wall seconds on a line of its own."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        PHASE_WALL[name] = PHASE_WALL.get(name, 0.0) + time.perf_counter() - t0
        print(f"[seconds] {name}: {PHASE_WALL[name]:.1f} s", flush=True)


# -- phase 1: device ----------------------------------------------------------


def device_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed no card")
    return out[0]


# -- phase 3: K1 against its plain version ------------------------------------


def make_bucket(spec, n, seed, device):
    import torch

    from gordo_tpu_torch.models.nn import init_feedforward
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    gen = torch.Generator().manual_seed(seed)
    return stack_member_params([init_feedforward(spec, gen) for _ in range(n)], device)


def make_case(spec, n, m, b, indices=None, ingest=False, seed=0):
    import torch

    device = torch.device("cuda")
    gen = torch.Generator().manual_seed(seed + 1)
    bucket = make_bucket(spec, n, seed, device)
    X = torch.rand(m, b, spec.n_features, generator=gen).to(device)
    plan = None
    if ingest:
        plan = (
            (torch.rand(n, spec.n_features, generator=gen) * 2).to(device),
            (torch.rand(n, spec.n_features, generator=gen) - 0.5).to(device),
        )
    return dict(spec=spec, bucket=bucket, X=X, indices=indices, ingest=plan)


def compare(case, defines=()):
    import torch

    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward, fleet_feedforward_reference

    args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
    got = fleet_feedforward(*args, defines=defines)
    torch.cuda.synchronize()
    expected = fleet_feedforward_reference(*args)
    check(got.shape == expected.shape, f"shape {tuple(got.shape)} != {tuple(expected.shape)}")
    check(bool(torch.isfinite(got).all()), "non-finite kernel output")
    diff = (got - expected).abs()
    max_abs = float(diff.max())
    max_rel = float((diff / expected.abs().clamp_min(1e-6)).max())
    check(
        bool(torch.allclose(got, expected, rtol=RTOL, atol=ATOL)),
        f"kernel disagrees with the plain version: max abs {max_abs}, max rel {max_rel}",
    )
    return max_abs, max_rel


def kernel_cases():
    from gordo_tpu_torch.models.factories import feedforward_hourglass, feedforward_model
    from gordo_tpu_torch.ops.activations import ACTIVATION_NAMES

    hourglass = feedforward_hourglass(20)
    cases = {
        "hourglass20 M=1000 B=1008": make_case(hourglass, 1000, 1000, ROWS),
        "feedforward_model20 M=64 B=1008": make_case(feedforward_model(20), 64, 64, ROWS, seed=1),
        "served fleet: hourglass20 M=64 B=1008 +ingest": make_case(
            hourglass, SERVED_MACHINES, SERVED_MACHINES, ROWS, ingest=True, seed=2
        ),
        "served anomaly: hourglass20 gather M=1 B=1008 +ingest": make_case(
            hourglass, SERVED_MACHINES, 1, ROWS, indices=[17], ingest=True, seed=3
        ),
        # 40 wide: the wide kernel with the member's stack resident (feedforward_model streams it)
        "hourglass40 M=64 B=1008": make_case(feedforward_hourglass(40), 64, 64, ROWS, seed=11),
        WIDE_ANOMALY: make_case(feedforward_hourglass(40), WIDE_MACHINES, 1, ROWS, indices=[5], ingest=True,
                                seed=12),
        "ragged: hourglass7 B=50": make_case(feedforward_hourglass(7), 2, 2, 50, seed=4),
        "ragged: hourglass7 B=129": make_case(feedforward_hourglass(7), 2, 2, 129, seed=4),
        "gather repeats: hourglass20 N=10 M=6 B=301": make_case(
            hourglass, 10, 6, 301, indices=[3, 3, 0, 9, 3, 1], seed=5
        ),
        "ingest: hourglass20 N=10 M=4 B=300": make_case(
            hourglass, 10, 4, 300, indices=[1, 2, 2, 7], ingest=True, seed=6
        ),
        "ingest, wide path: hourglass40 N=10 M=4 B=300": make_case(
            feedforward_hourglass(40), 10, 4, 300, indices=[1, 2, 2, 7], ingest=True, seed=7
        ),
        "chunked 256x256 layer B=200": make_case(
            feedforward_model(256, encoding_dim=(256,), decoding_dim=(256,),
                              encoding_func=("relu",), decoding_func=("gelu",)), 2, 2, 200, seed=8
        ),
        "widest: 512-300-1-512 B=70": make_case(
            feedforward_model(512, encoding_dim=(300,), decoding_dim=(1,),
                              encoding_func=("tanh",), decoding_func=("softmax",)), 2, 2, 70, seed=9
        ),
    }
    # every activation on both kernel paths: a 9-wide (registers) and a
    # 48-wide (shared memory) hidden layer
    for i, name in enumerate(ACTIVATION_NAMES):
        for hidden in (9, 48):
            spec = feedforward_model(
                6, encoding_dim=(hidden,), decoding_dim=(5,),
                encoding_func=(name,), decoding_func=("tanh",), out_func=name,
            )
            cases[f"activation {name}, hidden {hidden}"] = make_case(spec, 3, 3, 37, seed=10 + i)
    # the narrow kernel's persistent loop: every B below leaves a ragged
    # last tile in each member's span
    cases.update({
        "many tiles a member: hourglass20 M=2 B=52560": make_case(hourglass, 2, 2, 52_560, seed=60),
        "more tiles than blocks: hourglass20 M=N=2000 B=144": make_case(hourglass, 2000, 2000, 144, seed=61),
        "one row: hourglass20 gather M=1 B=1": make_case(hourglass, 8, 1, 1, indices=[5], ingest=True, seed=62),
        "one member: hourglass20 gather M=1 B=1008": make_case(hourglass, 8, 1, ROWS, indices=[5], seed=63),
        "member returns: hourglass20 N=10 M=1200 B=144 [3,3,0,9,3,1]": make_case(
            hourglass, 10, 1200, 144, indices=GATHER_6 * 200, ingest=True, seed=64),
        "member returns: hourglass20 N=10 M=1024 B=144 64-long pattern": make_case(
            hourglass, 10, 1024, 144, indices=GATHER_64 * 16, ingest=True, seed=65),
    })
    # the wide kernel: persistent blocks whose member changes (resident and
    # streamed stacks), one row, odd widths
    model = feedforward_model(20)
    cases.update({
        "wide member returns: hourglass40 N=10 M=240 B=144 [3,3,0,9,3,1]": make_case(
            feedforward_hourglass(40), 10, 240, 144, indices=GATHER_6 * 40, ingest=True, seed=70),
        "wide member returns: feedforward_model20 N=10 M=128 B=144 64-long pattern": make_case(
            model, 10, 128, 144, indices=GATHER_64 * 2, ingest=True, seed=71),
        "wide one row: hourglass40 gather M=1 B=1": make_case(
            feedforward_hourglass(40), 8, 1, 1, indices=[5], ingest=True, seed=72),
        "wide one member: feedforward_model20 gather M=1 B=1008": make_case(
            model, 8, 1, ROWS, indices=[5], ingest=True, seed=73),
        "odd widths: 33-27-1-27-33 M=3 B=157": make_case(feedforward_model(
            33, encoding_dim=(27, 1), decoding_dim=(27,), encoding_func=("tanh", "relu"),
            decoding_func=("elu",)), 3, 3, 157, ingest=True, seed=74),
        "odd widths: 300-27-1-33-300 M=3 B=157": make_case(feedforward_model(
            300, encoding_dim=(27, 1), decoding_dim=(33,), encoding_func=("relu", "tanh"),
            decoding_func=("tanh",)), 3, 3, 157, ingest=True, seed=75),
    })
    # [slo]'s drill: its 16-row anomaly requests
    cases[SLO_ANOMALY] = make_case(hourglass, SERVED_MACHINES, 1, SLO_FRAME_ROWS, indices=[17], ingest=True,
                                   seed=76)
    return cases


#: gather patterns in which a member repeats in neighbouring and in distant
#: batch rows, so a block that walks several rows sees its member change
#: and come back
GATHER_6 = [3, 3, 0, 9, 3, 1]
GATHER_64 = [5 if i % 3 == 0 else (i // 2) % 5 * 2 for i in range(64)]
#: K1 cases that K2 also takes, each with y = X, a separate y and a NaN in y
K2_LOOP_CASES = (
    "served anomaly: hourglass20 gather M=1 B=1008 +ingest",
    "many tiles a member: hourglass20 M=2 B=52560",
    "more tiles than blocks: hourglass20 M=N=2000 B=144",
    "one row: hourglass20 gather M=1 B=1",
    "one member: hourglass20 gather M=1 B=1008",
    "gather repeats: hourglass20 N=10 M=6 B=301",
    "member returns: hourglass20 N=10 M=1200 B=144 [3,3,0,9,3,1]",
    "member returns: hourglass20 N=10 M=1024 B=144 64-long pattern",
    "wide member returns: hourglass40 N=10 M=240 B=144 [3,3,0,9,3,1]",
    "wide member returns: feedforward_model20 N=10 M=128 B=144 64-long pattern",
    "wide one row: hourglass40 gather M=1 B=1",
    "wide one member: feedforward_model20 gather M=1 B=1008",
    "odd widths: 33-27-1-27-33 M=3 B=157",
    "odd widths: 300-27-1-33-300 M=3 B=157",
)


def scores_case(case, y="x", seed=0):
    """A K1 case with targets for K2: ``y`` is ``"x"`` (X itself, the
    store's case), ``"same"`` (a separate y as wide as the output),
    ``"narrower"`` (3 columns fewer) or ``"nan"`` (a separate y with one
    NaN)."""
    import torch

    X = case["X"]
    if y == "x":
        return dict(case, y=X)
    M, B, _ = X.shape
    width = case["spec"].n_features_out - (3 if y == "narrower" else 0)
    target = torch.rand(M, B, width, generator=torch.Generator().manual_seed(seed + 2)).to(X.device)
    if y == "nan":
        target[0, B // 2, 1] = float("nan")
    return dict(case, y=target)


def compare_scores(case, defines=()):
    """K2 against its plain version: ``(max abs, max rel)`` over the
    reconstruction and the mse (NaN where the plain version has NaN)."""
    import torch

    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_anomaly_scores_reference

    args = (case["spec"], case["bucket"], case["X"], case["y"], case["indices"], case["ingest"])
    recon, mse = fleet_anomaly_scores(*args, defines=defines)
    torch.cuda.synchronize()
    expected_recon, expected_mse = fleet_anomaly_scores_reference(*args)
    check(recon.shape == expected_recon.shape and mse.shape == expected_mse.shape, "K2 output shapes")
    check(bool((torch.isnan(mse) == torch.isnan(expected_mse)).all()), "K2's NaN rows differ from the plain version's")
    worst = (0.0, 0.0)
    for got, expected in ((recon, expected_recon), (mse, expected_mse)):
        keep = ~torch.isnan(expected)
        got, expected = got[keep], expected[keep]
        if not expected.numel():  # one row, and its target has the NaN
            continue
        diff = (got - expected).abs()
        check(bool(torch.allclose(got, expected, rtol=RTOL, atol=ATOL)),
              f"K2 disagrees with the plain version: max abs {float(diff.max())}")
        worst = max(worst, (float(diff.max()), float((diff / expected.abs().clamp_min(1e-6)).max())))
    return worst


def k2_cases(cases):
    """K2's cases, on K1's buckets and rows where the shapes are the same."""
    from gordo_tpu_torch.models.factories import feedforward_hourglass

    served = cases["served fleet: hourglass20 M=64 B=1008 +ingest"]
    flush = dict(served, X=served["X"][:, :512].contiguous())
    k2 = {
        "K2 hourglass20 M=1000 B=1008 y=X": scores_case(cases["hourglass20 M=1000 B=1008"]),
        "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest": scores_case(flush),
        "K2 feedforward_model20 M=64 B=1008 y=X": scores_case(cases["feedforward_model20 M=64 B=1008"]),
        "K2 served fleet: hourglass20 M=64 B=1008 y=X +ingest": scores_case(served),
        "K2 hourglass40 M=64 B=1008 y=X": scores_case(cases["hourglass40 M=64 B=1008"]),
        f"K2 {WIDE_ANOMALY} y=X": scores_case(cases[WIDE_ANOMALY]),
    }
    for path, name in (("narrow", "served fleet: hourglass20 M=64 B=1008 +ingest"),
                       ("wide", "feedforward_model20 M=64 B=1008")):
        for y in ("same", "narrower", "nan"):
            k2[f"K2 {path}: {name.split(': ')[-1]} y={y}"] = scores_case(cases[name], y, seed=20)
    for path, ragged, gathered in (("narrow", 7, 20), ("wide", 40, 40)):
        for rows in (1, 50, 129):
            k2[f"K2 ragged {path}: hourglass{ragged} B={rows}"] = scores_case(
                make_case(feedforward_hourglass(ragged), 2, 2, rows, seed=30 + rows))
        gather = make_case(feedforward_hourglass(gathered), 10, 6, 301, indices=[3, 3, 0, 9, 3, 1],
                           ingest=True, seed=40)
        k2[f"K2 gather repeats {path}: hourglass{gathered} N=10 M=6 B=301 y=X +ingest"] = scores_case(gather)
        k2[f"K2 gather repeats {path}: hourglass{gathered} N=10 M=6 B=301 y=narrower"] = scores_case(
            gather, "narrower", seed=41)
    activations = [name for name in cases if name.startswith("activation")]
    for name in (*K2_LOOP_CASES, *activations):
        for y in ("x", "same", "nan"):
            k2[f"K2 {name} y={y}"] = scores_case(cases[name], y, seed=50)
    # [slo]'s drill: its fleet request of the 4 clean machines, 16 rows each (y the rows, as the store scores)
    k2[SLO_FLEET] = scores_case(make_case(feedforward_hourglass(20), SERVED_MACHINES, 4, SLO_FRAME_ROWS,
                                          indices=[0, 1, 2, 3], ingest=True, seed=77))
    # [lifecycle]'s gates: one fleet's bucket of each width scores its rebuilt machine's probe window
    for width, members, index in ((20, SERVED_MACHINES, 7), (WIDE_TAGS, WIDE_MACHINES, 3)):
        k2[LIFECYCLE_GATE[width]] = scores_case(make_case(feedforward_hourglass(width), members, 1, LIFECYCLE_ROWS,
                                                          indices=[index], ingest=True, seed=80 + width))
    return k2


#: K2's cases that also go through the wide-only build
K2_WIDE_ONLY = (
    "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest",
    "K2 narrow: hourglass20 M=64 B=1008 +ingest y=narrower",
)


# -- phase 4: serving ------------------------------------------------------------


def sensor_data(seed, rows, n_tags):
    import numpy as np

    rng = np.random.RandomState(seed)
    t = np.arange(rows)[:, None]
    phase_ = rng.uniform(0, 2 * np.pi, n_tags)
    level = rng.uniform(20, 80, n_tags)
    return level + 5 * np.sin(2 * np.pi * t / 144 + phase_) + rng.standard_normal((rows, n_tags))


#: the served collection's detector, as ``examples/config.yaml`` defines it
DEFINITION = {"gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector": {"base_estimator": {
    "sklearn.pipeline.Pipeline": {"steps": [
        "sklearn.preprocessing.MinMaxScaler",
        {"gordo_tpu.models.estimators.JaxAutoEncoder": {"kind": "feedforward_hourglass", "epochs": 5, "batch_size": 32}},
    ]}}}}
DETECTOR_PATH = "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector"
KFCV_DETECTOR = "gordo_tpu.models.anomaly.diff.DiffBasedKFCVAnomalyDetector"
TRAIN_ROWS = 2000
TRAIN_START = datetime(2020, 1, 1, tzinfo=timezone.utc)
#: the generated KFCV project of ``[config]``: machines, and its data's first day
KFCV_MACHINES = 16
KFCV_START = datetime(2020, 2, 1, tzinfo=timezone.utc)
#: the build phases ``[train]`` and ``[config]`` print, in order
BUILD_PHASES = ("plan", "data_fetch", "stage", "cv_train", "cv_predict", "cv_score", "cv_finalize", "final_fit",
                "assemble", "dump")
#: the 40-tag compressors' sensor_data seeds start here (the 20-tag machines' at 0)
WIDE_SEED = 500
#: machines built again on the CPU from the same seeds, 2 of each width
CPU_CHECK = ("machine-000", "machine-001", "compressor-000", "compressor-001")
#: the card's build against the CPU's, TF32 off: f32 sums in other orders
#: (cuBLAS, the CPU's BLAS) through 640 Adam steps a machine. Each limit
#: lies between the sound build's reading and a planted fault's
#: (``scripts/build_tolerance.py`` on an H100; sound / TF32 on / one row
#: swapped between batches in the last epoch): params max abs 1.8e-7 /
#: 4.0e-6 / 9.1e-6; thresholds max rel 3.0e-7 / 4.0e-7 / 3.5e-5; CV
#: scores max |d| / (1 + |cpu|) 2.7e-6 / 2.9e-6 / 2.2e-4. The sound
#: readings repeat to the last digit from run to run at these shapes.
BUILD_PARAM_ATOL = 1e-6
BUILD_THRESHOLD_RTOL = 3e-6
BUILD_SCORE_TOL = 2e-5
BUILD_LIMITS = (BUILD_PARAM_ATOL, BUILD_THRESHOLD_RTOL, BUILD_SCORE_TOL)
#: the same check for the [lstm] build (params, thresholds, CV scores):
#: the recurrence carries the f32 differences through 10 steps a window
#: and 2 layers' more products; ``scripts/build_tolerance.py lstm`` reads
#: the sound build against its planted faults
LSTM_BUILD_LIMITS = (1e-5, 3e-6, 2e-5)


def served_machines():
    """The served collection's machines (``machine_rows``) as fleet-build
    machines of ``DEFINITION`` holding their rows as arrays, the same rows
    ``[train]`` fetches from its project config (``scripts/build_tolerance.py``
    builds them)."""
    from gordo_tpu_torch.machine import Machine

    index = [TRAIN_START + timedelta(minutes=10 * r) for r in range(TRAIN_ROWS)]
    return [
        Machine.from_config({"name": name, "model": DEFINITION, "dataset": {"tag_list": tags, "resolution": "10min"}},
                            "smoke", data=(values, None), index=index)
        for name, tags, values in machine_rows()
    ]


def build_summary(model, metadata):
    """What the card's build is held to the CPU's on: final params,
    thresholds, CV scores, epochs run and the model offset (``metadata`` is
    a machine's ``metadata.json`` tree, or the machine itself)."""
    import numpy as np

    if not isinstance(metadata, dict):
        metadata = metadata.to_dict()
    meta = metadata["metadata"]["build_metadata"]["model"]
    estimator = getattr(model.base_estimator, "estimator", model.base_estimator)  # a pipeline's, or bare
    return {
        "params": {k: {n: t.detach().cpu().numpy() for n, t in layer.items()}
                   for k, layer in estimator.params_.items()},
        "thresholds": np.append(model.feature_thresholds_, model.aggregate_threshold_),
        "scores": meta["cross_validation"]["scores"],
        "epochs_run": meta["training"]["epochs_run"],
        "offset": meta["model_offset"],
    }


def compare_builds(card, cpu, limits=BUILD_LIMITS):
    """The card's build against the CPU's: the largest differences,
    ``[params abs, thresholds rel, scores |d| / (1 + |cpu|)]``, and what
    lies beyond the stated limits, ran another number of epochs or has
    another model offset (empty when the builds agree)."""
    import numpy as np

    param_atol, threshold_rtol, score_tol = limits
    worst, faults = [0.0, 0.0, 0.0], []
    for name, want in cpu.items():
        got = card[name]
        if got["epochs_run"] != want["epochs_run"]:
            faults.append(f"{name}: epochs run {got['epochs_run']} vs {want['epochs_run']}")
        if got["offset"] != want["offset"]:
            faults.append(f"{name}: model_offset {got['offset']} vs {want['offset']}")
        for key, layer in want["params"].items():
            for leaf, value in layer.items():
                diff = float(np.abs(got["params"][key][leaf] - value).max())
                if not diff <= param_atol:
                    faults.append(f"{name} {key}/{leaf}: params {diff} apart")
                worst[0] = max(worst[0], diff)
        rel = float((np.abs(got["thresholds"] - want["thresholds"]) / np.abs(want["thresholds"])).max())
        if not rel <= threshold_rtol:
            faults.append(f"{name}: thresholds {rel} apart (relative)")
        worst[1] = max(worst[1], rel)
        if list(got["scores"]) != list(want["scores"]):
            faults.append(f"{name}: CV score keys differ")
            continue
        for key, folds in want["scores"].items():
            values = np.array(list(folds.values()))
            have = np.array(list(got["scores"][key].values()))
            diff = float((np.abs(have - values) / (1 + np.abs(values))).max())
            if not diff <= score_tol:
                faults.append(f"{name} {key}: {diff} apart")
            worst[2] = max(worst[2], diff)
    return worst, faults


def build_summaries(machines, device, random=None):
    """``{name: build_summary}`` of ``machines`` built with
    ``FleetBuilder`` on ``device``, and the build's seconds."""
    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder

    t0 = time.perf_counter()
    builder = FleetBuilder(machines, device=device, random=random)
    results = builder.build()
    check(not builder.build_errors, f"build errors: {builder.build_errors}")
    return {machine.name: build_summary(model, machine) for model, machine in results}, time.perf_counter() - t0


def yaml_block(value, indent=0):
    """``value`` (dicts, lists, strings, numbers) as block YAML, the way a
    project config is written by hand; the port reads it back with its
    own reader."""
    pad = " " * indent
    if isinstance(value, dict):
        lines = []
        for key, item in value.items():
            if isinstance(item, (dict, list)) and item:
                lines.append(f"{pad}{key}:\n{yaml_block(item, indent + 2)}")
            else:
                lines.append(f"{pad}{key}: {yaml_block(item)}")
        return "\n".join(lines)
    if isinstance(value, list):
        if not value:
            return "[]"
        lines = []
        for item in value:
            body = yaml_block(item, indent + 2).lstrip(" ") if isinstance(item, (dict, list)) else yaml_block(item)
            lines.append(f"{pad}- {body}")
        return "\n".join(lines)
    return str(value)


def machine_seeds():
    """The served collection's (name, tags, sensor_data seed): SERVED_MACHINES
    20-tag machines and WIDE_MACHINES 40-tag compressors."""
    machines = [(f"machine-{i:03d}", 20, i) for i in range(SERVED_MACHINES)]
    return machines + [(f"compressor-{i:03d}", WIDE_TAGS, WIDE_SEED + i) for i in range(WIDE_MACHINES)]


def machine_rows():
    """The served collection: (name, tags, sensor_data rows) of each machine."""
    return [(name, tag_list(n_tags), sensor_data(seed, TRAIN_ROWS, n_tags)) for name, n_tags, seed in machine_seeds()]


def write_project(directory, machines=None, models=None, project="smoke", n_rows=TRAIN_ROWS):
    """A collection as a project config in ``examples/config.yaml``'s
    dialect (a CRD document, ``globals.model`` a ``|`` block holding
    ``DEFINITION``, or each machine's own ``model`` block from ``models``),
    each machine's dataset a ``FileDataProvider`` CSV of its rows
    (``machines``: ``(name, tags, rows)``, default the served collection's
    ``machine_rows``) at 10-minute stamps from TRAIN_START, floats with 17
    significant digits so they read back exactly, and the half-open window
    ``[TRAIN_START, TRAIN_START + n_rows x 10 min)`` holding all of
    them. Returns the config's path and ``{name: rows}``."""
    end = (TRAIN_START + timedelta(minutes=10 * n_rows)).isoformat()
    entries, rows = [], {}
    for name, tags, values in machine_rows() if machines is None else machines:
        path = write_csv(directory, name, tags, values)
        dataset = yaml_block({
            "data_provider": {"type": "FileDataProvider", "path": path, "timestamp_column": "time"},
            "tag_list": "[" + ", ".join(tags) + "]",
            "train_start_date": TRAIN_START.isoformat(),
            "train_end_date": end,
        }, 10)
        model = "" if models is None else f"        model: |\n{yaml_block(models[name], 10)}\n"
        entries.append(f"      - name: {name}\n        dataset: |\n{dataset}\n{model}")
        rows[name] = values
    config = (
        f"apiVersion: equinor.com/v1\nkind: Gordo\nmetadata:\n  name: {project}\nspec:\n  config:\n    machines:\n"
        + "".join(entries)
        + ("    globals:\n      model: |\n" + yaml_block(DEFINITION, 8) + "\n" if models is None else "")
    )
    config_path = os.path.join(directory, f"{project}.yaml")
    with open(config_path, "w") as f:
        f.write(config)
    return config_path, rows


def write_csv(directory, name, tags, values):
    """``values`` as ``directory/<name>.csv``: a ``time`` column of 10-minute
    stamps from TRAIN_START, then a column a tag, floats with 17 significant
    digits so they read back exactly (``inf`` as ``inf``). Returns the path."""
    path = os.path.join(directory, f"{name}.csv")
    with open(path, "w") as f:
        f.write(",".join(["time", *tags]) + "\n")
        for r, row in enumerate(values):
            stamp = (TRAIN_START + timedelta(minutes=10 * r)).isoformat()
            f.write(stamp + "," + ",".join(f"{v:.17g}" for v in row) + "\n")
    return path


@contextlib.contextmanager
def captured_build():
    """During a build: each CV scoring forward (``predict_bucket``) with the
    K1 launches it made, and each machine's fetched rows."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
    from gordo_tpu_torch.parallel.fleet import FleetTrainer
    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder

    forwards, fetched = [], {}
    predict, stage = FleetTrainer.predict_bucket, FleetBuilder._stage_arrays

    def captured_predict(self, spec, stacked, X):
        before = fleet_feedforward.launches
        out = predict(self, spec, stacked, X)
        forwards.append((spec, stacked, X, fleet_feedforward.launches - before))
        return out

    def captured_stage(plan):
        fetched[plan.machine.name] = plan.X
        return stage(plan)

    FleetTrainer.predict_bucket = captured_predict
    FleetBuilder._stage_arrays = staticmethod(captured_stage)
    try:
        yield forwards, fetched
    finally:
        FleetTrainer.predict_bucket = predict
        FleetBuilder._stage_arrays = staticmethod(stage)


def as_case(spec, stacked, X):
    """A CV scoring forward's inputs as a K1 case on the card."""
    import torch

    bucket = {k: {n: torch.as_tensor(t).cuda() for n, t in layer.items()} for k, layer in stacked.items()}
    return dict(spec=spec, bucket=bucket, X=torch.from_numpy(X).cuda(), indices=None, ingest=None)


def build_phases(builder):
    seconds = builder.phase_seconds
    return ", ".join(f"{name} {seconds[name]:.3f} s" for name in BUILD_PHASES)


def fit_rates(builder):
    fits = builder.trainer.fits
    steps = sum(f["steps"] for f in fits)
    fit_s = sum(f["seconds"] for f in fits)
    event_ms = sum(f["event_ms"] for f in fits)
    return fits, steps, fit_s, event_ms


def train_phase(work_dir, directory):
    """Build the served collection on the card from its project config:
    the config written to ``work_dir``, normalized to a shard, built by the
    ``build-fleet`` command's function into ``directory``; each machine's
    fetched rows must equal its ``sensor_data`` rows; a CPU build of
    CPU_CHECK from the same shard is held against the card's; one training
    step timed. Returns the two lists of names, the kernel launches of the
    build, each CV scoring forward as a K1 case on the card with the K1
    launches it made, by input width, and the build's ms a machine."""
    import numpy as np
    import torch

    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    check(torch.backends.cuda.matmul.allow_tf32 is False and torch.get_float32_matmul_precision() == "highest",
          "TF32 is on: training must run in full f32")
    t0 = time.perf_counter()
    config_path, rows = write_project(work_dir)
    shard = os.path.join(work_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke"))
    phase("train", f"project config of {len(rows)} machines (CRD document, FileDataProvider CSVs of {TRAIN_ROWS} "
          f"rows) written and normalized to a shard in {time.perf_counter() - t0:.2f} s")
    series_before = registry_samples()  # the build series this build feeds ([telemetry] reads them)
    with captured_build() as (forwards, fetched):
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    series = (series_before, registry_samples(), directory)
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    check(sorted(fetched) == sorted(rows), "build-fleet fetched other machines")
    unequal = [name for name, X in fetched.items() if not np.array_equal(X, rows[name])]
    check(not unequal, f"fetched rows differ from sensor_data for {unequal[:5]}")
    check(len(forwards) == 2 and launches["K1"] == 2 and all(n == 1 for *_, n in forwards),
          f"CV scoring launched K1 {[n for *_, n in forwards]} times for {len(forwards)} spec groups, "
          f"not once a group")
    cv_cases = {X.shape[-1]: (as_case(spec, stacked, X), n) for spec, stacked, X, n in forwards}
    seconds = builder.phase_seconds
    fits, steps, fit_s, event_ms = fit_rates(builder)
    phase("train", f"build-fleet of {len(fetched)} machines ({SERVED_MACHINES} x 20 tags, {WIDE_MACHINES} x "
          f"{WIDE_TAGS}; hourglass, 5 epochs, batch 32, TimeSeriesSplit(3)) on the card in {wall:.2f} s: "
          f"{build_phases(builder)}; data_fetch {1e3 * seconds['data_fetch'] / len(fetched):.2f} ms a machine "
          f"(CSV read and 10-minute resampling on the host); every machine's fetched X equal to its sensor_data rows")
    phase("train", f"{len(fits)} stacked fits, members {[f['members'] for f in fits]}, {steps} optimizer steps in "
          f"{fit_s:.3f} s: {steps / fit_s:.1f} steps a second, {1e3 * fit_s / steps:.3f} ms a step on the host "
          f"clock, {event_ms / steps:.3f} ms a step between CUDA events; "
          f"K1 launches {launches['K1']} (one per spec group), K2 {launches['K2']}")
    device_ms = step_device_ms(make_step(20, 3 * SERVED_MACHINES))
    phase("train", f"one training step of the 20-tag CV bucket ({3 * SERVED_MACHINES} members x 32 rows) "
          f"with the host's enqueue hidden: {device_ms!r} ms of device time; the steps above take "
          f"{event_ms / steps:.3f} ms between events: the device idles ~{1 - device_ms * steps / event_ms:.0%} "
          f"of a step")

    from gordo_tpu_torch import serializer

    card = {}
    for name in CPU_CHECK:
        model = serializer.load(os.path.join(directory, name), "cpu")
        card[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
    cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in CPU_CHECK], "cpu")
    worst, faults = compare_builds(card, cpu)
    check(not faults, "card build disagrees with the CPU's: " + "; ".join(faults[:5]))
    phase("train", f"card build against a CPU build of {', '.join(CPU_CHECK)} from the same shard "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds "
          f"max rel {worst[1]:.3e} (limit {BUILD_THRESHOLD_RTOL}), CV scores max |d| / (1 + |cpu|) {worst[2]:.3e} "
          f"(limit {BUILD_SCORE_TOL}), epochs run equal")
    names = sorted(n for n in fetched if n.startswith("machine-"))
    wide_names = sorted(n for n in fetched if n.startswith("compressor-"))
    return names, wide_names, launches, cv_cases, 1e3 * wall / len(fetched), (shard, builder, wall, series)


# -- [telemetry]: what [train]'s build wrote beside its machines ------------------------

#: the files a default build writes beside its machines
TELEMETRY_FILES = ("build_status.json", "build_trace.jsonl", "fleet_health.json", "fleet_plan.json")


def build_series_metrics(builds, machines):
    """``[metrics]`` of ``[telemetry]``: what each telemetry-on build of
    the shard added to the process registry (``builds``: the samples
    before and after it, and its directory), held to what it wrote: each
    phase histogram's count against the ``build_phase`` spans of its trace
    (the phases of its ``build_status.json``), the compile histogram's
    against its ``device_program`` first calls, the final-loss count
    against its members trained; right after the last, the machine gauges
    and the predicted seconds against ``fleet_plan.json``."""
    from gordo_tpu_torch import telemetry
    from gordo_tpu_torch.planner import FleetPlan

    t0 = time.perf_counter()
    samples = registry_samples()
    render_ms = (time.perf_counter() - t0) * 1e3
    phase_counts, span_counts = collections.Counter(), collections.Counter()
    compiles = compile_spans = losses = trained = 0
    for before, after, directory in builds:
        def grown(name, **labels):
            return summed(after, name, **labels) - summed(before, name, **labels)

        with open(os.path.join(directory, telemetry.BUILD_TRACE_FILE)) as f:
            spans = [json.loads(line) for line in f]
        counts = {p: grown("gordo_fleet_build_phase_duration_seconds_count", project="smoke", phase=p)
                  for p in label_values(after, "gordo_fleet_build_phase_duration_seconds_count", "phase",
                                        project="smoke")}
        counts = {p: n for p, n in counts.items() if n}
        in_trace = collections.Counter(s["attributes"]["phase"] for s in spans if s["name"] == "build_phase")
        status_phases = set(telemetry.load_status(directory)["phases"])
        check(set(counts) == status_phases and counts == in_trace, f"{directory}: phase histogram counts grew by "
              f"{counts}; build_status.json's phases {sorted(status_phases)}, its build_phase spans {dict(in_trace)}")
        phase_counts.update(counts)
        span_counts.update(in_trace)
        compiles += grown("gordo_fleet_compile_duration_seconds_count", project="smoke")
        compile_spans += sum(1 for s in spans if s["name"] == "device_program" and s["attributes"]["compile"])
        losses += grown("gordo_fleet_member_final_loss_count", project="smoke")
        trained += sum(1 for s in spans if s["name"] == "member_trained")
    check(compiles == compile_spans, f"{compiles} compile observations, {compile_spans} device_program first calls")
    check(losses == trained == len(builds) * machines, f"{losses} final losses observed, {trained} members trained")
    last = builds[-1][1]  # the registry right after the last telemetry-on build
    machines_series = {k: summed(last, f"gordo_fleet_build_machines_{k}", project="smoke")
                       for k in ("total", "completed", "failed")}
    check(machines_series == {"total": machines, "completed": machines, "failed": 0},
          f"gordo_fleet_build_machines_* {machines_series}, the build {machines} machines, none failed")
    planned = FleetPlan.load(os.path.join(builds[-1][2], "fleet_plan.json")).totals["predicted_wall_s"]
    predicted = summed(last, "gordo_fleet_plan_predicted_seconds", project="smoke", strategy="naive")
    check(predicted == planned, f"gordo_fleet_plan_predicted_seconds {predicted}, fleet_plan.json {planned}")
    phase("metrics", f"[telemetry] the process registry in {render_ms:.2f} ms ({len(samples)} samples): what "
          f"[train]'s build added: phase histogram counts "
          f"{dict(sorted(phase_counts.items()))} = their traces' build_phase spans (the phases of each "
          f"build_status.json); compile observations {compiles:.0f} = device_program first calls; final losses "
          f"{losses:.0f} = members trained; after the last, machines total/completed/failed {machines_series} and "
          f"gordo_fleet_plan_predicted_seconds {predicted} = fleet_plan.json's")


def telemetry_phase(work_dir, directory, train_build, train_launches, card):
    """``[telemetry]``: the four files [train]'s build (telemetry on, the
    default) wrote beside its machines, held to the build itself: the
    status' state, counts and phases; the trace's phases, its ``fleet_fit``
    spans (one a stacked fit) and ``fleet_predict`` spans (one a K1 launch
    of the build, read on the counter); the ledger's machines and final
    losses (each machine's ``metadata.json``); the plan's buckets (ids and
    members of the final fits the trainer ran); the ``device_utilization`` peak against
    the allocator's; ``build-status`` over HTTP equal to the file. Then
    the same shard built once more, with ``GORDO_TPU_TELEMETRY=0`` (no
    trace, status or ledger; the same plan written), its wall time beside
    [train]'s (telemetry on). Returns the K1 and K2 launches of that
    build."""
    import torch

    from gordo_tpu_torch import serializer, telemetry
    from gordo_tpu_torch.cli.cli import build_fleet
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.planner import FleetPlan
    from gordo_tpu_torch.server import build_app

    shard, builder, wall, train_series = train_build
    present = [name for name in TELEMETRY_FILES if os.path.exists(os.path.join(directory, name))]
    check(present == list(TELEMETRY_FILES), f"[train]'s build wrote {present}, not {list(TELEMETRY_FILES)}")
    machines = serializer.list_model_dirs(directory)
    status = telemetry.load_status(directory)
    counts = status["machines"]
    check(status["state"] == "complete" and status["phase"] is None, f"build_status.json says {status['state']}")
    check(counts["total"] == len(builder.machines) == len(machines) and counts["completed"] == len(machines)
          and counts["failed"] == len(builder.build_errors) == 0, f"build_status.json counts {counts}")
    missing = [p for p in BUILD_PHASES if p not in status["phases"] or p not in builder.phase_seconds]
    check(not missing, f"phases {missing} missing from build_status.json or phase_seconds")
    drift = max(abs(status["phases"][p]["seconds"] - builder.phase_seconds[p]) for p in status["phases"])
    check(drift < 1e-5, f"build_status.json's phase seconds {drift} s off the builder's")
    writes = builder.progress.writes
    phase("telemetry", f"build_status.json: state complete, machines {counts['completed']}/{counts['total']} "
          f"completed, {counts['failed']} failed, {len(status['phases'])} phases ({', '.join(status['phases'])}), "
          f"each phase's seconds equal to phase_seconds; {writes} status writes in the {wall:.2f} s build "
          f"({writes / wall:.2f} a second)")

    trace_path = os.path.join(directory, telemetry.BUILD_TRACE_FILE)
    with open(trace_path) as f:
        spans = [json.loads(line) for line in f]
    trace_bytes = os.path.getsize(trace_path)
    names = collections.Counter(s["name"] for s in spans)
    phases = collections.Counter(s["attributes"]["phase"] for s in spans if s["name"] == "build_phase")
    programs = [s for s in spans if s["name"] == "device_program"]
    predicts = [s for s in programs if s["attributes"]["program"] == "fleet_predict"]
    fits = [s for s in programs if s["attributes"]["program"] == "fleet_fit"]
    check(all(phases[p] >= 1 for p in BUILD_PHASES), f"build_phase spans {dict(phases)} miss a phase")
    check(len(predicts) == train_launches["K1"], f"{len(predicts)} fleet_predict spans, but [train]'s build "
          f"launched K1 {train_launches['K1']} times")
    check(len(fits) == len(builder.trainer.fits), f"{len(fits)} fleet_fit spans for {len(builder.trainer.fits)} fits")
    check(names["fleet_build"] == 1 and names["machine_built"] == names["member_trained"] == len(machines)
          and names["fleet_plan"] == names["fleet_plan_accuracy"] == 1, f"span names {dict(names)}")
    check(len({s["context"]["trace_id"] for s in spans}) == 1, "the trace holds more than one trace id")
    phase("telemetry", f"build_trace.jsonl: {len(spans)} spans and events in {trace_bytes} bytes "
          f"({trace_bytes / len(spans):.0f} a line): {dict(names)}; build_phase spans {dict(phases)}")
    phase("telemetry", f"fleet_predict spans {len(predicts)} = [train]'s K1 launches {train_launches['K1']} (K1 "
          f"launches inside fleet_predict spans), "
          + ", ".join(f"{s['attributes']['shape']} {s['duration_ms']} ms (compile={s['attributes']['compile']})"
                      for s in predicts)
          + f"; fleet_fit spans {len(fits)} = stacked fits: "
          + ", ".join(f"{s['attributes']['members']} members {s['duration_ms']} ms" for s in fits) + f"; {card}")

    health = telemetry.load_health(directory)
    losses = {}
    for name in machines:
        training = serializer.load_metadata(os.path.join(directory, name))["metadata"]["build_metadata"]["model"][
            "training"]
        losses[name] = training["final_loss"]
    wrong = [n for n in machines if health["machines"].get(n, {}).get("build", {}).get("final_loss") != losses[n]]
    check(sorted(health["machines"]) == machines and not wrong, f"fleet_health.json: {len(health['machines'])} "
          f"machines, final losses differing from metadata.json for {wrong[:5]}")
    check(health["summary"]["healthy"] == len(machines), f"ledger summary {health['summary']}")
    plan = FleetPlan.load(os.path.join(directory, "fleet_plan.json"))
    final_fits = [f for f in builder.trainer.fits if not any("::" in n for n in f["names"])]  # no CV fold
    planned = {b["id"]: b["members"] for b in plan.buckets}
    ran = {f["bucket"]: f["names"] for f in final_fits}
    check(planned == ran and plan.member_names == machines, f"fleet_plan.json buckets {sorted(planned)}, "
          f"the final fits ran {sorted(ran)} (or their members differ)")
    planned = sorted((len(b["members"]), b["n_padded"]) for b in plan.buckets)
    accuracy = health["plan_accuracy"]
    check(accuracy["plan_hash"] == plan.plan_hash, "the ledger's plan accuracy names another plan")
    phase("telemetry", f"fleet_health.json: {len(health['machines'])} machines, each final loss equal to its "
          f"metadata.json's, summary {health['summary']['healthy']} healthy; fleet_plan.json {plan.plan_hash}: "
          f"{len(plan.buckets)} naive buckets (members, rows) {planned}, each with the id and members of a final "
          f"fit the trainer ran; the "
          f"analytic model's prediction {plan.totals['predicted_wall_s']} s against final-fit programs measured at "
          f"{accuracy['actual_fit_s']} s (its constants are uncalibrated; not a time of the card)")

    samples = [s["attributes"] for s in spans if s["name"] == "device_utilization"]
    check(samples and all(a["memory_available"] for a in samples), "no device_utilization sample with memory")
    peak = max(a["memory_peak_bytes_in_use"] for a in samples)
    allocator_peak = torch.cuda.max_memory_allocated()
    check(0 < peak <= allocator_peak and accuracy["measured_hbm_peak_bytes"] == peak,
          f"device_utilization peak {peak} B against torch.cuda.max_memory_allocated() {allocator_peak} B")
    phase("telemetry", f"device_utilization: {len(samples)} samples (phases {[a['phase'] for a in samples]}), "
          f"peak allocated {peak} B <= torch.cuda.max_memory_allocated() {allocator_peak} B (the process's peak so "
          f"far), in use at the last {samples[-1]['memory_bytes_in_use']} B of {samples[-1]['memory_bytes_limit']} B; "
          f"the plan predicted {plan.totals['hbm_peak_bytes']} B for its largest bucket; {card}")

    app = build_app(directory, device="cuda")
    base, stop = serving(app)
    try:
        code, body = http_call(base + "/build-status")
    finally:
        stop()
    served = json.loads(body)
    check(code == 200 and served == {**status, "revision": REVISION}, "GET build-status differs from the file")
    phase("telemetry", f"GET /gordo/v0/smoke/build-status: 200, the file's document (and the revision)")

    # the same shard again with telemetry off, beside [train]'s build (telemetry on): one build, not an on
    # build after the off one, to keep the smoke under its time (PR 18)
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    out = os.path.join(work_dir, "telemetry-off", REVISION)
    previous = os.environ.get(telemetry.TELEMETRY_ENV)
    os.environ[telemetry.TELEMETRY_ENV] = "0"
    try:
        t0 = time.perf_counter()
        code, off_builder = build_fleet(shard, out, device="cuda")
        torch.cuda.synchronize()
        off_wall = time.perf_counter() - t0
    finally:
        if previous is None:
            os.environ.pop(telemetry.TELEMETRY_ENV)
        else:
            os.environ[telemetry.TELEMETRY_ENV] = previous
    check(code == 0 and not off_builder.build_errors, f"the telemetry-off build exited {code}")
    written = [n for n in TELEMETRY_FILES if os.path.exists(os.path.join(out, n))]
    check(written == ["fleet_plan.json"], f"with GORDO_TPU_TELEMETRY=0 the build wrote {written}")
    check(FleetPlan.load(os.path.join(out, "fleet_plan.json")).plan_hash == plan.plan_hash,
          "the telemetry-off build planned another fleet_plan.json")
    launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(launches == train_launches, f"the telemetry-off build launched {launches}, [train]'s {train_launches}")

    def describe(seconds, built):
        phase_s = built.phase_seconds
        return (f"{seconds:.2f} s (without data_fetch {seconds - phase_s['data_fetch']:.2f} s; cv_train "
                f"{phase_s['cv_train']:.3f}, final_fit {phase_s['final_fit']:.3f}, dump {phase_s['dump']:.3f})")

    build_series_metrics([train_series], len(machines))

    phase("telemetry", f"the same {len(machines)} machines built again, telemetry on ([train]) "
          f"{describe(wall, builder)}, off {describe(off_wall, off_builder)}: on - off {wall - off_wall:+.2f} s, "
          f"{(wall - off_wall) / off_wall:+.1%} (one pair; [train]'s build ran first, with cold file caches); with "
          f"GORDO_TPU_TELEMETRY=0 only fleet_plan.json beside the machines, the same plan hash; K1 launches "
          f"{launches['K1']}, K2 {launches['K2']} in the off build; {card}")
    return launches


def kfcv_project(directory):
    """The generated KFCV project: KFCV_MACHINES machines of 20 tags, each
    a ``DiffBasedKFCVAnomalyDetector`` (window 144, ``smm``) over MinMax +
    feedforward_hourglass (5 epochs, batch 32) on ``RandomDataProvider``
    readings (3000-4000 a tag) over 4 weeks from KFCV_START at 10 minutes;
    written as a CRD config, its path returned."""
    definition = {KFCV_DETECTOR: {"window": 144, "smoothing_method": "smm", **DEFINITION[DETECTOR_PATH]}}
    entries = []
    for i in range(KFCV_MACHINES):
        name = f"kfcv-{i:03d}"
        dataset = yaml_block({
            "data_provider": {"type": "RandomDataProvider", "min_size": 3000, "max_size": 4000},
            "tag_list": "[" + ", ".join(f"{name}-tag-{j:02d}" for j in range(20)) + "]",
            "resolution": "10min",
            "train_start_date": KFCV_START.isoformat(),
            "train_end_date": (KFCV_START + timedelta(weeks=4)).isoformat(),
        }, 10)
        entries.append(f"      - name: {name}\n        dataset: |\n{dataset}\n")
    config = (
        "apiVersion: equinor.com/v1\nkind: Gordo\nmetadata:\n  name: kfcv\nspec:\n  config:\n    machines:\n"
        + "".join(entries) + "    globals:\n      model: |\n" + yaml_block(definition, 8) + "\n"
    )
    path = os.path.join(directory, "kfcv.yaml")
    with open(path, "w") as f:
        f.write(config)
    return path


def config_phase(work_dir):
    """``examples/config.yaml`` and the generated KFCV project, built by one
    ``build-fleet`` run on the card into a fresh directory: K1 launched once
    a spec group in CV scoring, each forward held to the plain version; 2
    KFCV machines built again on the CPU from the same shard and held to the
    card's build; a card app and a CPU app over the directory answer
    alike. Returns K1's and K2's launches, and the KFCV forward as a case
    with its launches and its distance from the plain version."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    directory = os.path.join(work_dir, "config-build", REVISION)
    documents = [json.loads(normalize(path, "smoke-config"))
                 for path in (os.path.join(HERE, "examples", "config.yaml"), kfcv_project(work_dir))]
    shard = os.path.join(work_dir, "config-shard.json")
    with open(shard, "w") as f:
        json.dump({"machines": [m for document in documents for m in document["machines"]]}, f)
    with captured_build() as (forwards, fetched):
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        build_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    groups = {(spec, X.shape[-1]) for spec, _, X, _ in forwards}
    check(build_launches["K1"] == len(forwards) == len(groups) == 2 and all(n == 1 for *_, n in forwards),
          f"CV scoring launched K1 {build_launches['K1']} times for {len(groups)} spec groups "
          f"({len(forwards)} forwards)")
    fits, steps, fit_s, _ = fit_rates(builder)
    rows = {name: len(X) for name, X in fetched.items()}
    phase("config", f"build-fleet of examples/config.yaml (3 machines, 3 tags) and {KFCV_MACHINES} KFCV machines "
          f"(20 tags, window 144 smm, KFold(5)) on the card in {wall:.2f} s: {build_phases(builder)}; "
          f"data_fetch {1e3 * builder.phase_seconds['data_fetch'] / len(rows):.2f} ms a machine; {steps} optimizer "
          f"steps in {fit_s:.3f} s, {steps / fit_s:.1f} steps a second; rows a machine {sorted(set(rows.values()))}; "
          f"K1 launches in CV scoring {build_launches['K1']} for {len(groups)} spec groups")
    kfcv = [i for i, (_, _, X, _) in enumerate(forwards) if X.shape[-1] == 20]
    check(len(kfcv) == 1 and forwards[kfcv[0]][2].shape[0] == 5 * KFCV_MACHINES, "the KFCV forward's members")
    cases = [as_case(spec, stacked, X) for spec, stacked, X, _ in forwards]
    errors = [compare(case) for case in cases]
    phase("config", "each CV scoring forward against the plain version on its own inputs: "
          + "; ".join(f"{tuple(c['X'].shape)} max abs {e[0]:.3e}" for c, e in zip(cases, errors))
          + f" (rtol {RTOL}, atol {ATOL})")

    cpu_names = [f"kfcv-{i:03d}" for i in range(2)]
    card_summaries = {}
    for name in cpu_names:
        model = serializer.load(os.path.join(directory, name), "cpu")
        card_summaries[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
    cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in cpu_names], "cpu")
    worst, faults = compare_builds(card_summaries, cpu)
    phase("config", f"card KFCV build against a CPU build of {', '.join(cpu_names)} from the same shard "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds "
          f"max rel {worst[1]:.3e} (limit {BUILD_THRESHOLD_RTOL}), CV scores max |d| / (1 + |cpu|) "
          f"{worst[2]:.3e} (limit {BUILD_SCORE_TOL}), epochs run equal")
    check(not faults, "card KFCV build disagrees with the CPU's: " + "; ".join(faults[:5]))

    apps = build_app(directory, device="cuda"), build_app(directory, device="cpu")
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    for name in ("kfcv-000", "ct-23-0003"):
        X = fetched[name][-ROWS:]
        meta = serializer.load_metadata(os.path.join(directory, name))
        tags = [t["name"] for t in meta["metadata"]["build_metadata"]["dataset"]["dataset_meta"]["tag_list"]]
        start = datetime(2020, 3, 1, tzinfo=timezone.utc)
        keys = [(start + timedelta(minutes=10 * r)).isoformat() for r in range(len(X))]
        frame = {tag: dict(zip(keys, X[:, j].tolist())) for j, tag in enumerate(tags)}
        path = f"/gordo/v0/smoke-config/{name}/anomaly/prediction"
        t0 = time.perf_counter()
        status, body = wsgi_post(apps[0], path, {"X": frame, "y": frame})
        ms = 1e3 * (time.perf_counter() - t0)
        cpu_status, cpu_body = wsgi_post(apps[1], path, {"X": frame, "y": frame})
        check(status == cpu_status == 200, f"{path} answered {status} (CPU app {cpu_status})")
        check(list(body["data"]) == ANOMALY_GROUPS, f"{path}: anomaly groups {list(body['data'])}")
        diff = same_json(cpu_body["data"], body["data"])
        phase("config", f"POST {path} ({len(X)} of its own rows): 200 in {ms:.1f} ms on the card's app, "
              f"max abs diff vs the CPU app {diff:.3e} (rtol {RTOL}, atol {ATOL})")
    launches = {k: build_launches[k] + n for k, n in (("K1", fleet_feedforward.launches),
                                                       ("K2", fleet_anomaly_scores.launches))}
    check(launches["K1"] >= build_launches["K1"] + 1, "the [config] anomaly requests never launched K1")
    return launches, cases[kfcv[0]], forwards[kfcv[0]][3], errors[kfcv[0]]


# -- phase: the LSTM family ----------------------------------------------------------------

#: the [lstm] collection, ``examples/model-configuration.yaml``'s LSTM settings:
#: (name prefix, machines, estimator path, estimator kwargs, model offset)
LSTM_AE = "gordo_tpu.models.estimators.JaxLSTMAutoEncoder"
LSTM_FORECAST = "gordo_tpu.models.estimators.JaxLSTMForecast"
LSTM_GROUPS = (
    ("lstm-hourglass", 8, LSTM_AE,
     {"kind": "lstm_hourglass", "lookback_window": 10, "compression_factor": 0.5, "encoding_layers": 2}, 9),
    ("lstm-forecast", 4, LSTM_FORECAST,
     {"kind": "lstm_symmetric", "lookback_window": 10, "dims": [64, 32], "funcs": ["tanh", "tanh"]}, 10),
    ("lstm-model", 4, LSTM_AE, {"kind": "lstm_model", "lookback_window": 10}, 9),
)
#: the examples' 5 epochs cut to 1: at 5 the card's build took 47 s and
#: the CPU check 91 s (one H100 machine), far past the phase's minute; at 2
#: 21.5 s and 34.2 s, and the smoke near 700 of its 1200 s
LSTM_EPOCHS = 1
#: the LSTM machines' training rows: TRAIN_ROWS cut to half, with
#: LSTM_PROFILE_STEPS, to pay for [deploy] (at 2000 rows the phase took
#: 155.6-196.8 s, 67 s of it the CPU's builds and fits that the card's are
#: held to, which scale with the rows; every check still runs)
LSTM_ROWS = 1000
#: steps ``torch.profiler`` records for each step profiled in [lstm] (once 5
#: and 3: the trace's processing took 59 s of the phase; a step's launches
#: are the same every step)
LSTM_PROFILE_STEPS = 1
#: the LSTM machines' sensor_data seeds start here
LSTM_SEED = 700
#: feedforward machines of the [train] collection served beside the LSTMs
LSTM_FF_MACHINES = ("machine-000", "machine-001", "machine-002", "machine-003")
#: machines built again on the CPU, one an architecture
LSTM_CPU_CHECK = ("lstm-hourglass-000", "lstm-forecast-000", "lstm-model-000")
#: segments an update of [lstm]'s segmented build (GORDO_TPU_LSTM_SEGMENTED):
#: 4 segments of 8 windows, a span of 8 + 10 - 1 = 17 rows
LSTM_SEGMENTS = 4


def lstm_machines():
    """The [lstm] collection: ``(name, tags, rows)`` of each machine and
    ``{name: definition}`` (a detector over MinMax and the group's LSTM
    estimator, LSTM_EPOCHS, batch 32)."""
    machines, models, seed = [], {}, LSTM_SEED
    for prefix, count, path, kwargs, _ in LSTM_GROUPS:
        for i in range(count):
            name = f"{prefix}-{i:03d}"
            machines.append((name, tag_list(20), sensor_data(seed, LSTM_ROWS, 20)))
            estimator = {path: {**kwargs, "epochs": LSTM_EPOCHS, "batch_size": 32}}
            models[name] = {DETECTOR_PATH: {"base_estimator": {"sklearn.pipeline.Pipeline": {
                "steps": ["sklearn.preprocessing.MinMaxScaler", estimator]}}}}
            seed += 1
    return machines, models


def lstm_offsets():
    """``{name: model offset}`` of the [lstm] collection."""
    return {f"{prefix}-{i:03d}": offset for prefix, count, _, _, offset in LSTM_GROUPS for i in range(count)}


def lstm_own_frame(name, seed):
    """An LSTM machine's next ROWS rows (``sensor_data`` from its seed past
    the LSTM_ROWS it trained on), with request_frame's excursion."""
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * (LSTM_ROWS + r))).isoformat() for r in range(ROWS)]
    values = sensor_data(seed, LSTM_ROWS + ROWS, 20)[LSTM_ROWS:]
    values[ROWS // 2:ROWS // 2 + 6, 3] += 25.0
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tag_list(20))}


def lstm_f64_forward(model, X):
    """An LSTM detector's output for raw rows ``X[rows, tags]`` in float64,
    written out apart from the port's code: its ingest plan, every window,
    the recurrence of each layer with the f32 weights widened, the head."""
    import numpy as np
    import torch
    from gordo_tpu_torch.models.estimators import find_estimator
    from gordo_tpu_torch.ops.activations import resolve_activation
    from gordo_tpu_torch.server.fleet_store import member_plan

    estimator = find_estimator(model)
    spec, params = estimator.spec_, estimator.params_
    scale, offset = member_plan(model, X.shape[1])
    x = torch.from_numpy(np.asarray(X, np.float64) * scale.astype(np.float64) + offset.astype(np.float64))
    count = len(x) - estimator.offset
    h_seq = torch.stack([x[t:t + count] for t in range(spec.lookback_window)])  # [T, windows, F]
    for key, activation in spec.layer_names()[:-1]:
        act = resolve_activation(activation)
        Wx, Wh, b = (params[key][n].cpu().double() for n in ("Wx", "Wh", "b"))
        H = Wh.shape[0]
        h = torch.zeros(count, H, dtype=torch.float64)
        c = torch.zeros_like(h)
        hidden = []
        for t in range(spec.lookback_window):
            g = h_seq[t] @ Wx + b + h @ Wh
            c = torch.sigmoid(g[:, H:2 * H]) * c + torch.sigmoid(g[:, :H]) * act(g[:, 2 * H:3 * H])
            h = torch.sigmoid(g[:, 3 * H:]) * act(c)
            hidden.append(h)
        h_seq = torch.stack(hidden)
    head = params["out"]
    return resolve_activation(spec.out_activation)(h_seq[-1] @ head["W"].cpu().double() + head["b"].cpu().double()).numpy()


def lstm_step(spec, members):
    """One optimizer step of an LSTM CV bucket on the card, as a closure:
    ``members`` members of ``spec``, Adam, 32 windows each gathered from a
    seeded 2000-row series (``WindowedFit``'s own gather)."""
    import torch

    from gordo_tpu_torch.models.training import FitConfig, TorchRandom, WindowedFit
    from gordo_tpu_torch.ops.windows import gather_windows
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    fit = WindowedFit(spec, FitConfig(epochs=LSTM_EPOCHS, batch_size=32, shuffle=False))
    params = stack_member_params([TorchRandom().init_params(spec, s) for s in range(members)], "cuda")
    for leaf in fit.leaves(params):
        leaf.requires_grad_(True)
    state = fit.optimizer.init(fit.leaves(params))
    gen = torch.Generator().manual_seed(0)
    series = torch.rand(members, TRAIN_ROWS, spec.n_features, generator=gen).cuda()
    targets = series[:, spec.lookback_window - 1:]
    starts = torch.arange(32, device="cuda").repeat(members, 1) * 7
    wb = torch.ones(members, 32, device="cuda")
    active = torch.ones(members, dtype=torch.bool, device="cuda")

    def step():
        xb = gather_windows(series, starts, spec.lookback_window)
        yb = torch.take_along_dim(targets, starts[..., None], dim=1)
        return fit.train_step(params, state, xb, yb, wb, active)

    return step


def segmented_step(spec, members, segments=LSTM_SEGMENTS):
    """One update of the segmented fit on the card, as a closure:
    ``members`` members of ``spec``, Adam, the update's 32 windows as
    ``segments`` segments of a seeded 2000-row series (``SegmentedFit``'s
    own indices), the twin of :func:`lstm_step`."""
    import torch

    from gordo_tpu_torch.models.training import FitConfig, SegmentedFit, TorchRandom
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    fit = SegmentedFit(spec, FitConfig(epochs=LSTM_EPOCHS, batch_size=32, shuffle=False), segments)
    params = stack_member_params([TorchRandom().init_params(spec, s) for s in range(members)], "cuda")
    for leaf in fit.leaves(params):
        leaf.requires_grad_(True)
    state = fit.optimizer.init(fit.leaves(params))
    gen = torch.Generator().manual_seed(0)
    series = torch.rand(members, TRAIN_ROWS, spec.n_features, generator=gen).cuda()
    targets = series[:, spec.lookback_window - 1:]
    rows, windows = fit.indices(1, series.shape[1], targets.shape[1], "cuda")
    wb = torch.ones(members, 32, device="cuda")
    active = torch.ones(members, dtype=torch.bool, device="cuda")
    return lambda: fit.train_step(params, state, series[:, rows[0]], targets[:, windows[0]], wb, active)


def profile_step(step, steps=5):
    """``(kernel launches, kernel ms)`` a step, from ``torch.profiler`` over
    ``steps`` steps (CPU and CUDA activities)."""
    import torch

    for _ in range(3):
        step()
    torch.cuda.synchronize()
    activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=activities) as prof:
        for _ in range(steps):
            step()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    launches = sum(e.count for e in averages if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    kernel_us = sum(e.self_device_time_total for e in averages if e.device_type == torch.autograd.DeviceType.CUDA)
    return launches / steps, kernel_us / steps / 1e3


@contextlib.contextmanager
def captured_windowed():
    """During a build: each windowed CV forward (``predict_windowed_bucket``)
    as ``(spec, members, windows a member)``."""
    from gordo_tpu_torch.parallel.fleet import FleetTrainer

    forwards, predict = [], FleetTrainer.predict_windowed_bucket

    def captured(self, spec, stacked, series, order, batch_size=256):
        forwards.append((spec, order.shape[0], order.shape[1]))
        return predict(self, spec, stacked, series, order, batch_size)

    FleetTrainer.predict_windowed_bucket = captured
    try:
        yield forwards
    finally:
        FleetTrainer.predict_windowed_bucket = predict


def lstm_case(spec, members, seed=0):
    """A windowed forward on the card: ``members`` members of ``spec``
    (``TorchRandom`` params) over seeded ROWS-row series, every window."""
    import torch

    from gordo_tpu_torch.models.training import TorchRandom
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    params = stack_member_params([TorchRandom().init_params(spec, seed + s) for s in range(members)], "cuda")
    gen = torch.Generator().manual_seed(seed)
    series = torch.rand(members, ROWS, spec.n_features, generator=gen).cuda()
    count = ROWS - spec.lookback_window + 1
    order = torch.arange(count, device="cuda").repeat(members, 1)
    return dict(spec=spec, params=params, series=series, order=order)


def lstm_bound(case):
    """(bound_ms, bound_by) of a windowed forward: the series read once,
    the params once, the output written once, at HBM rate; 2 flops a
    multiply-add of the products (the gates' elementwise work left out)
    at the CUDA-core f32 rate."""
    spec, series, order = case["spec"], case["series"], case["order"]
    M, windows = order.shape
    widths = spec.widths()
    macs = sum(spec.lookback_window * (widths[i] * 4 * widths[i + 1] + widths[i + 1] * 4 * widths[i + 1])
               for i in range(len(spec.dims)))
    macs += widths[-2] * widths[-1]
    params = sum(t[0].numel() for layer in case["params"].values() for t in layer.values())
    byte_count = 4 * (series.numel() + M * params + M * windows * spec.n_features_out)
    byte_ms = byte_count / PEAK_BYTES_PER_S * 1e3
    flop_ms = 2 * M * windows * macs / PEAK_F32_FLOP_PER_S * 1e3
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations"


def cudnn_yardstick(case):
    """The same windowed forward through cuDNN (``torch.nn.LSTM``, one
    module a layer and member, tanh only, ``bias_hh`` zero, a ``Linear``
    head), as a closure, and its output for the first member. Used here
    only, as the measure of what a library recurrence gives."""
    import torch

    from gordo_tpu_torch.ops.windows import gather_windows

    spec, params = case["spec"], case["params"]
    check(set(spec.activations) == {"tanh"} and spec.out_activation == "linear", "the yardstick is tanh only")
    members = []
    for m in range(case["order"].shape[0]):
        layers = []
        for key, _ in spec.layer_names()[:-1]:
            Wx, Wh, b = (params[key][n][m] for n in ("Wx", "Wh", "b"))
            lstm = torch.nn.LSTM(Wx.shape[0], Wh.shape[0], batch_first=False).cuda()
            with torch.no_grad():
                lstm.weight_ih_l0.copy_(Wx.T)
                lstm.weight_hh_l0.copy_(Wh.T)
                lstm.bias_ih_l0.copy_(b)
                lstm.bias_hh_l0.zero_()
            layers.append(lstm)
        head = torch.nn.Linear(*params["out"]["W"][m].shape).cuda()
        with torch.no_grad():
            head.weight.copy_(params["out"]["W"][m].T)
            head.bias.copy_(params["out"]["b"][m])
        members.append((layers, head))

    @torch.no_grad()
    def run():
        outs = []
        for start in range(0, case["order"].shape[1], 256):
            x = gather_windows(case["series"], case["order"][:, start:start + 256], spec.lookback_window)
            batch = []
            for m, (layers, head) in enumerate(members):
                h = x[m]  # [T, B, F]
                for lstm in layers:
                    h = lstm(h)[0]
                batch.append(head(h[-1]))
            outs.append(torch.stack(batch))
        return torch.cat(outs, dim=1)

    return run


def host_step_ms(step, steps=10):
    """Host ms a ``step`` over ``steps`` steps, ending in a synchronise."""
    import torch

    step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        step()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / steps


def lstm_build(work_dir, card):
    """Write the [lstm] collection as a project config and build it on the
    card through ``build-fleet``: the phases, steps a second, every
    ``model_offset``, one windowed CV forward a spec group; each group's CV
    step profiled (launches, device time, idle share); one machine an
    architecture built again on the CPU from the same shard and held to
    the card's. Returns the build's directory, its seeds by machine and
    K1's and K2's launches and the build's ms a machine."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    t0 = time.perf_counter()
    machines, models = lstm_machines()
    lstm_dir = os.path.join(work_dir, "lstm")
    os.makedirs(lstm_dir)
    config_path, rows = write_project(lstm_dir, machines, models, project="smoke-lstm", n_rows=LSTM_ROWS)
    shard = os.path.join(lstm_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke-lstm"))
    phase("lstm", f"project config of {len(rows)} LSTM machines (8 lstm_hourglass autoencoders 15-10-10-15, 4 "
          f"lstm_symmetric forecasters 64-32-32-64, 4 lstm_model autoencoders 256-128-64-64-128-256; lookback 10, "
          f"20 tags, {LSTM_ROWS} rows, {LSTM_EPOCHS} epoch (cut from the examples' 5 to keep the phase near a "
          f"minute), batch 32, TimeSeriesSplit(3)) written and normalized in {time.perf_counter() - t0:.2f} s")
    directory = os.path.join(work_dir, "lstm-build", REVISION)
    with captured_windowed() as forwards:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    check(len(forwards) == len(LSTM_GROUPS), f"CV scoring ran {len(forwards)} windowed forwards for "
          f"{len(LSTM_GROUPS)} spec groups")
    for name, offset in lstm_offsets().items():
        got = serializer.load_metadata(os.path.join(directory, name))["metadata"]["build_metadata"]["model"]
        check(got["model_offset"] == offset, f"{name}: model_offset {got['model_offset']}, not {offset}")
    fits, steps, fit_s, event_ms = fit_rates(builder)
    phase("lstm", f"build-fleet of {len(rows)} machines on the card in {wall:.2f} s: {build_phases(builder)}; "
          f"model_offset 9 (autoencoders) and 10 (forecasters) in every metadata.json; CV scoring "
          f"{len(forwards)} windowed forwards, members x windows {[(m, w) for _, m, w in forwards]}; "
          f"K1 launches {launches['K1']}, K2 {launches['K2']}; {card}")
    phase("lstm", f"{len(fits)} windowed fits, members {[f['members'] for f in fits]}, steps "
          f"{[f['steps'] for f in fits]} ({steps} in all, the all-padding batches left out) in {fit_s:.3f} s: "
          f"{steps / fit_s:.1f} steps a second, {1e3 * fit_s / steps:.3f} ms a step on the host clock, "
          f"{event_ms / steps:.3f} ms between CUDA events; per fit ms a step between events "
          f"{[round(f['event_ms'] / f['steps'], 3) for f in fits]}; {card}")
    cv_steps = {}
    for (prefix, count, *_), fit in zip(LSTM_GROUPS, fits):
        spec = serializer.load(os.path.join(directory, f"{prefix}-000"), "cpu").base_estimator.estimator.spec_
        step = lstm_step(spec, 3 * count)
        device_ms = step_device_ms(step)
        host_ms = host_step_ms(step)
        step_launches, kernel_ms = profile_step(step, steps=LSTM_PROFILE_STEPS)
        fit_ms = fit["event_ms"] / fit["steps"]
        cv_steps[prefix] = (spec, step_launches, kernel_ms, device_ms, host_ms)
        # a step of more launches than the card's queue holds lets the host pace
        # the sleep-hidden timing too: the profiler's kernel time is the device's busy time
        phase("lstm", f"one CV step of {prefix} ({3 * count} members x 32 windows, dims {spec.dims}): "
              f"{step_launches:.0f} kernel launches, {kernel_ms:.3f} ms of kernel time in the profiler "
              f"({device_ms!r} ms between events with the host's enqueue hidden behind a device sleep), "
              f"{host_ms:.3f} ms on the host clock (its CV fit {fit_ms:.3f} ms a step between events): the "
              f"device idles ~{1 - kernel_ms / fit_ms:.0%} of a step; {card}")

    card_summaries = {name: build_summary(serializer.load(os.path.join(directory, name), "cpu"),
                                          serializer.load_metadata(os.path.join(directory, name)))
                      for name in LSTM_CPU_CHECK}
    cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in LSTM_CPU_CHECK], "cpu")
    worst, faults = compare_builds(card_summaries, cpu, LSTM_BUILD_LIMITS)
    phase("lstm", f"card build against a CPU build of {', '.join(LSTM_CPU_CHECK)} from the same shard "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {LSTM_BUILD_LIMITS[0]}), thresholds "
          f"max rel {worst[1]:.3e} (limit {LSTM_BUILD_LIMITS[1]}), CV scores max |d| / (1 + |cpu|) "
          f"{worst[2]:.3e} (limit {LSTM_BUILD_LIMITS[2]}), epochs run and model_offset equal")
    check(not faults, "card LSTM build disagrees with the CPU's: " + "; ".join(faults[:5]))
    segmented_launches = lstm_segmented(work_dir, shard, (builder, wall, directory, cv_steps), card)
    launches = {k: launches[k] + segmented_launches[k] for k in launches}
    seeds = {name: LSTM_SEED + i for i, (name, _, _) in enumerate(machines)}
    return directory, seeds, launches, 1e3 * wall / len(rows)


def lstm_segmented(work_dir, shard, windowed, card):
    """``[lstm]``'s segmented build: the same shard built again on the card
    with ``GORDO_TPU_LSTM_SEGMENTED=LSTM_SEGMENTS``. The CV folds (fold
    weights) keep the windowed fit, as in JAX; every final fit must be
    segmented. Prints the build's seconds beside the windowed build's,
    each group's final fit ms an update against the windowed build's ms a
    step (CUDA events), and one segmented update at the CV step's members
    beside the windowed CV step measured before it (``windowed``'s
    readings): kernel launches and kernel ms (``torch.profiler``), device
    ms and host ms, the device's idle share. Holds LSTM_CPU_CHECK's
    segmented card build to the CPU within LSTM_BUILD_LIMITS: its
    thresholds and CV scores (the windowed CV folds) to the windowed card
    build's, itself held to a CPU build before; its final fits to the
    same segmented fits run on the CPU from the inputs the card's took (a
    machine whose params pass the limit is held to an f64 fit of the same
    member: the card at most F64_MULTIPLE times the CPU's distance).
    Returns K1's and K2's launches."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet
    from gordo_tpu_torch.models.training import SegmentedFit
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    windowed_builder, windowed_wall, windowed_dir, cv_steps = windowed
    directory = os.path.join(work_dir, "lstm-segmented", REVISION)
    os.environ["GORDO_TPU_LSTM_SEGMENTED"] = str(LSTM_SEGMENTS)
    try:
        with captured_segmented_fits() as final_fits:
            fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
            t0 = time.perf_counter()
            code, builder = build_fleet(shard, directory, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    finally:
        os.environ.pop("GORDO_TPU_LSTM_SEGMENTED")
    check(code == 0 and not builder.build_errors, f"segmented build-fleet exited {code}: {builder.build_errors}")

    def final(fits):  # a CV fold's member is named machine::fold
        return [f for f in fits if not any("::" in n for n in f["names"])]

    cv = [f for f in builder.trainer.fits if f not in final(builder.trainer.fits)]
    segmented, windowed_final = final(builder.trainer.fits), final(windowed_builder.trainer.fits)
    check(len(segmented) == len(windowed_final) == len(LSTM_GROUPS)
          and all(f["segmented"] == LSTM_SEGMENTS for f in segmented) and not any(f["segmented"] for f in cv),
          f"segmented build: final fits {[f['segmented'] for f in segmented]}, CV fits {[f['segmented'] for f in cv]}")
    phase("lstm", f"segmented build-fleet (GORDO_TPU_LSTM_SEGMENTED={LSTM_SEGMENTS}) of the same shard on the card "
          f"in {wall:.2f} s against the windowed build's {windowed_wall:.2f} s: {build_phases(builder)}; "
          f"{len(cv)} CV fits windowed (fold weights), {len(segmented)} final fits segmented; K1 launches "
          f"{launches['K1']}, K2 {launches['K2']}; {card}")
    for (prefix, count, *_), seg, win in zip(LSTM_GROUPS, segmented, windowed_final):
        spec, w_launch, w_kernel, w_device, w_host = cv_steps[prefix]
        step = segmented_step(spec, 3 * count)
        s_device = step_device_ms(step)
        s_host = host_step_ms(step, steps=5)
        s_launch, s_kernel = profile_step(step, steps=LSTM_PROFILE_STEPS)
        ratio = seg["event_ms"] * win["steps"] / (seg["steps"] * win["event_ms"])
        phase("lstm", f"{prefix} final fit ({count} members, batch 32): segmented {seg['steps']} updates at "
              f"{seg['event_ms'] / seg['steps']:.3f} ms an update between events, windowed {win['steps']} steps "
              f"at {win['event_ms'] / win['steps']:.3f} ms (x{ratio:.2f}); one update at the CV step's {3 * count} "
              f"members: segmented {s_launch:.0f} launches, {s_kernel:.3f} ms of kernel time, {s_device!r} ms "
              f"device, {s_host:.3f} ms host, idle ~{1 - s_kernel / s_host:.0%}; the windowed CV step "
              f"{w_launch:.0f} launches, {w_kernel:.3f} ms kernel, {w_device!r} ms device, {w_host:.3f} ms host, "
              f"idle ~{1 - w_kernel / w_host:.0%} (launches x{s_launch / w_launch:.2f}, host ms "
              f"x{s_host / w_host:.2f}, kernel ms x{s_kernel / w_kernel:.2f}); {card}")

    def summaries(root):
        return {name: build_summary(serializer.load(os.path.join(root, name), "cpu"),
                                    serializer.load_metadata(os.path.join(root, name))) for name in LSTM_CPU_CHECK}

    card_segmented, card_windowed = summaries(directory), summaries(windowed_dir)
    # the final fits differ by design: only the CV's thresholds and scores are held to the windowed build's
    cv_worst, faults = compare_builds(card_segmented, card_windowed,
                                      (float("inf"), LSTM_BUILD_LIMITS[1], LSTM_BUILD_LIMITS[2]))
    t0 = time.perf_counter()
    distances, held = {}, {}
    for name in LSTM_CPU_CHECK:
        spec, config, segments, series, targets, wtr, wval, init = final_fits[name]
        params = {k: {n: t.clone() for n, t in layer.items()} for k, layer in init.items()}
        cpu = SegmentedFit(spec, config, segments).run(params, series, targets, wtr, wval).params
        cpu = {k: {n: t[0].numpy() for n, t in layer.items()} for k, layer in cpu.items()}
        got = card_segmented[name]["params"]
        distances[name] = max(float(abs(got[k][n] - cpu[k][n]).max()) for k, layer in cpu.items() for n in layer)
        if distances[name] > LSTM_BUILD_LIMITS[0]:
            # a segmented fit's own f32 rounding can pass the limit (a span of 17 steps carries more of it than a
            # window of 10): such a machine is held to an f64 fit of the same member instead
            held[name] = f64_held_params(final_fits[name], got, cpu)
    cpu_s = time.perf_counter() - t0
    phase("lstm", f"segmented card build of {', '.join(LSTM_CPU_CHECK)}: thresholds max rel {cv_worst[1]:.3e} and CV "
          f"scores max |d| / (1 + |windowed|) {cv_worst[2]:.3e} from the windowed card build's (limits "
          f"{LSTM_BUILD_LIMITS[1]}, {LSTM_BUILD_LIMITS[2]}); each final fit run again on the CPU from the card's "
          f"inputs ({cpu_s:.2f} s): params max abs {', '.join(f'{n} {d:.3e}' for n, d in distances.items())} "
          f"(limit {LSTM_BUILD_LIMITS[0]}); past it, held to an f64 fit of the same member (the card at most "
          f"{F64_MULTIPLE} x the CPU's distance or the limit): "
          + (", ".join(f"{name} card {c:.3e}, CPU {p:.3e}" for name, (c, p) in held.items()) or "none"))
    check(not faults, "segmented card build's CV disagrees with the windowed one's: " + "; ".join(faults[:5]))
    for name, (card_err, cpu_err) in held.items():
        limit = F64_MULTIPLE * max(cpu_err, LSTM_BUILD_LIMITS[0])
        check(card_err <= limit, f"{name}: the card's segmented params {card_err:.3e} from the f64 fit, the CPU's "
              f"{cpu_err:.3e} (limit {limit:.3e})")
    segments_equal_windows(card)
    return launches


@contextlib.contextmanager
def captured_segmented_fits():
    """During a build: each segmented final fit's inputs by member name,
    ``(spec, config, segments, series, targets, wtr, wval, initial params)``
    of that member alone."""
    from gordo_tpu_torch.models.training import SegmentedFit
    from gordo_tpu_torch.parallel.fleet import FleetTrainer, stack_member_params

    fits, fit_bucket = {}, FleetTrainer._fit_bucket

    def captured(self, bucket, config, fit, data, wtr, wval, *args, **kwargs):
        if isinstance(fit, SegmentedFit):
            for i, member in enumerate(bucket):
                init = stack_member_params([self.random.init_params(fit.spec, member.seed)], "cpu")
                fits[member.name] = (fit.spec, config, fit.segments, *(t[i:i + 1].cpu().clone() for t in data),
                                     wtr[i:i + 1].cpu().clone(), wval[i:i + 1].cpu().clone(), init)
        return fit_bucket(self, bucket, config, fit, data, wtr, wval, *args, **kwargs)

    FleetTrainer._fit_bucket = captured
    try:
        yield fits
    finally:
        FleetTrainer._fit_bucket = fit_bucket


def f64_held_params(inputs, card, cpu):
    """``(card's, CPU's)`` largest params distance from the same segmented
    fit run in float64 on the CPU (``compute_dtype`` float64, f64 params;
    the head's output is cast to f32 before the loss)."""
    import dataclasses

    from gordo_tpu_torch.models.training import SegmentedFit

    spec, config, segments, series, targets, wtr, wval, init = inputs
    params = {k: {n: t.double().clone() for n, t in layer.items()} for k, layer in init.items()}
    exact = SegmentedFit(dataclasses.replace(spec, compute_dtype="float64"), config, segments).run(
        params, series.double(), targets.double(), wtr.double(), wval.double()).params

    def distance(got):
        return max(float(abs(got[k][n] - exact[k][n][0].numpy()).max()) for k, layer in got.items() for n in layer)

    return distance(card), distance(cpu)


def segments_equal_windows(card):
    """One bucket on the card (3 lstm_hourglass(20) members of 300 rows, a
    validation split) trained by the segmented fit at G = B (one window a
    segment, each starting cold) and by the windowed fit from the same
    params: losses, val losses and params within LSTM_BUILD_LIMITS."""
    import torch

    from gordo_tpu_torch.models.factories import lstm_hourglass
    from gordo_tpu_torch.models.training import FitConfig, SegmentedFit, TorchRandom, WindowedFit
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    spec = lstm_hourglass(20, lookback_window=10, encoding_layers=2)
    config = FitConfig(epochs=2, batch_size=32, validation_split=0.2, shuffle=False)
    series = torch.stack([torch.from_numpy(sensor_data(900 + m, 300, 20)) for m in range(3)]).float().cuda()
    targets = series[:, spec.lookback_window - 1:]
    nw = targets.shape[1]
    nv = -(-nw // 32) * 32
    n_val = int(nw * config.validation_split)
    wtr = torch.zeros(3, nv, device="cuda")
    wval = torch.zeros_like(wtr)
    wtr[:, :nw - n_val], wval[:, nw - n_val:nw] = 1.0, 1.0
    init = [TorchRandom().init_params(spec, seed) for seed in range(3)]
    order = torch.arange(nv, device="cuda").clamp(max=nw - 1).repeat(3, 1)
    windowed = WindowedFit(spec, config).run(stack_member_params(init, "cuda"), series, targets, order, wtr, wval,
                                             None)
    segmented = SegmentedFit(spec, config, 32).run(stack_member_params(init, "cuda"), series, targets, wtr, wval)
    params = max(float((segmented.params[k][n] - leaf).abs().max())
                 for k, layer in windowed.params.items() for n, leaf in layer.items())
    losses = max(float(((got - want).abs() / want.abs()).max()) for got, want in (
        (segmented.losses, windowed.losses), (segmented.val_losses, windowed.val_losses)))
    check(params <= LSTM_BUILD_LIMITS[0] and losses <= LSTM_BUILD_LIMITS[1],
          f"segmented fit at G = B differs from the windowed fit: params {params}, losses {losses} (relative)")
    phase("lstm", f"segmented fit at G = B = 32 against the windowed fit on the card (3 lstm_hourglass(20) members, "
          f"{nw} windows, 2 epochs, a validation split): params max abs {params:.3e} (limit {LSTM_BUILD_LIMITS[0]}), "
          f"losses and val losses max rel {losses:.3e} (limit {LSTM_BUILD_LIMITS[1]}); {card}")


def f64_held(cpu_data, data, reference, path):
    """Both apps' answers (``data`` trees) held to ``reference`` (the same
    answer made from an f64 forward): each group's numeric cells no
    further from it on the card than F64_MULTIPLE times the CPU app's
    distance (or ATOL), everything else equal. Returns ``{group: (card's
    distance, CPU app's)}`` and the largest abs difference of the two."""
    import math

    def cells(tree, prefix=()):
        for key, value in tree.items():
            if isinstance(value, dict):
                yield from cells(value, prefix + (key,))
            else:
                yield prefix + (key,), value

    want, have, exact = dict(cells(cpu_data)), dict(cells(data)), dict(cells(reference))
    check(list(have) == list(want) == list(exact), f"{path}: the answers' keys differ")
    distances, diff = {}, 0.0
    for key, value in want.items():
        group = key[:-2] if len(key) > 2 else key[:1]  # a column's group: (machine,) group for the fleet route
        if all(isinstance(v, float) for v in (value, have[key], exact[key])) and math.isfinite(exact[key]):
            card_err, cpu_err = distances.get(group, (0.0, 0.0))
            distances[group] = (max(card_err, abs(have[key] - exact[key])), max(cpu_err, abs(value - exact[key])))
            diff = max(diff, abs(have[key] - value))
        else:
            check(have[key] == value, f"{path}: {'/'.join(key)}: {have[key]!r} vs {value!r}")
    for group, (card_err, cpu_err) in distances.items():
        limit = F64_MULTIPLE * max(cpu_err, ATOL)
        check(card_err <= limit, f"{path}: {'/'.join(group)} {card_err:.3e} from the f64 answer, the CPU app's "
              f"{cpu_err:.3e} (limit {limit:.3e})")
    return distances, diff


def lstm_serve(directory, collection, seeds, card):
    """An app over the [lstm] collection and LSTM_FF_MACHINES of [train]'s,
    on the card and on the CPU: one anomaly request an LSTM architecture
    (999 rows out of an autoencoder, 998 of a forecaster), one
    ``/prediction`` and one fleet request over all 20 machines (K2 once, for
    the feedforward bucket), each machine sent its own next ROWS rows.
    Each answer equals the CPU app's within RTOL/ATOL, or else both are held
    to the answer an f64 forward gives (``f64_held``). Returns K1's and K2's
    launches."""
    import shutil

    from gordo_tpu_torch.models.spec import LSTMSpec
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app, wire

    for name in LSTM_FF_MACHINES:
        shutil.copytree(os.path.join(collection, name), os.path.join(directory, name))
    apps = build_app(directory, device="cuda"), build_app(directory, device="cpu")
    check(len(apps[0].store.fleet().warm()) == len(seeds) + len(LSTM_FF_MACHINES), "not every model loaded")
    offsets = lstm_offsets()
    frames = {name: lstm_own_frame(name, seed) for name, seed in seeds.items()}
    frames.update({name: own_frame(name, 20) for name in LSTM_FF_MACHINES})
    prefix = "/gordo/v0/smoke-lstm"
    fleet = apps[1].store.fleet()

    def exact(name):
        """``(resolution, X, f64 output)`` of a machine's request rows."""
        resolution = fleet.resolution(name)
        X = wire.verify_frame(wire.decode_frame(frames[name]), resolution.tag_names)
        forward = lstm_f64_forward if isinstance(fleet.loaded_specs()[name], LSTMSpec) else f64_forward
        return resolution, X, forward(resolution.model, X.values)

    def hold(path, body, cpu_body, reference):
        """``(max abs diff, note)``: within RTOL/ATOL of the CPU app's, or
        held to ``reference()``."""
        try:
            return same_json(cpu_body["data"], body["data"]), "within rtol/atol of the CPU app's"
        except SmokeFailure as exc:
            distances, diff = f64_held(cpu_body["data"], body["data"], reference(), path)
            worst = max(distances.values())
            return diff, (
                f"beyond rtol/atol of the CPU app's ({exc}), so both held to the f64 answer: furthest group "
                f"card {worst[0]:.3e}, CPU app {worst[1]:.3e} (limit {F64_MULTIPLE} x max(CPU app's, ATOL))")

    def both(path, payload):
        t0 = time.perf_counter()
        status, body = wsgi_post(apps[0], prefix + path, payload)
        ms = (time.perf_counter() - t0) * 1e3
        cpu_status, cpu_body = wsgi_post(apps[1], prefix + path, payload)
        check(status == cpu_status == 200, f"{path} answered {status} (CPU app {cpu_status})")
        return body, cpu_body, ms

    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    for group, *_ in LSTM_GROUPS:
        name = f"{group}-001"
        path = f"/{name}/anomaly/prediction"
        k1 = fleet_feedforward.launches
        body, cpu_body, ms = both(path, {"X": frames[name], "y": frames[name]})
        check(list(body["data"]) == ANOMALY_GROUPS, f"{path}: anomaly groups {list(body['data'])}")
        lengths = {len(col) for group_ in body["data"].values() for col in group_.values()}
        check(lengths == {ROWS - offsets[name]}, f"{path}: {lengths} rows, not {ROWS - offsets[name]}")

        def reference(name=name):
            resolution, X, output = exact(name)
            table = wire.anomaly_table(resolution.model, X, X, output, frequency=resolution.frequency,
                                       thresholds=resolution.feature_thresholds,
                                       aggregate=resolution.aggregate_threshold)
            return json.loads(wire.encode_response(table))["data"]

        diff, note = hold(path, body, cpu_body, reference)
        phase("lstm", f"POST {path} ({ROWS} rows): 200 in {ms:.1f} ms on the card's app, {ROWS - offsets[name]} "
              f"rows out, K1 launches {fleet_feedforward.launches - k1}, max abs diff vs the CPU app {diff:.3e}: "
              f"{note}; {card}")
    name = "lstm-forecast-002"
    path = f"/{name}/prediction"
    body, cpu_body, ms = both(path, {"X": frames[name]})
    check(len(body["data"]["model-output"]["tag-00"]) == ROWS - offsets[name], f"{path}: rows")

    def reference():
        resolution, X, output = exact(name)
        table = wire.prediction_table(X, output, resolution.tag_names, resolution.target_names)
        return json.loads(wire.encode_response(table))["data"]

    diff, note = hold(path, body, cpu_body, reference)
    phase("lstm", f"POST {path} ({ROWS} rows): 200 in {ms:.1f} ms, {ROWS - offsets[name]} rows out, max abs "
          f"diff vs the CPU app {diff:.3e}: {note}; {card}")
    k2 = fleet_anomaly_scores.launches
    body, cpu_body, ms = both("/prediction/fleet", {"X": frames})
    k2 = fleet_anomaly_scores.launches - k2
    check(k2 == 1, f"the fleet request launched K2 {k2} times, not once for the feedforward bucket")
    check(sorted(body["data"]) == sorted(frames) and "errors" not in body, "the fleet request's machines")
    for name, entry in body["data"].items():
        check(len(entry["total-anomaly-unscaled"]) == ROWS - offsets.get(name, 0), f"fleet entry {name}: rows")

    def reference():
        entries = {}
        for name in body["data"]:
            _, X, output = exact(name)
            tail = X.values[len(X.values) - len(output):]
            keys = wire.index_wire_keys(X.index[len(X.index) - len(output):])
            entries[name] = json.loads(wire.encode_lean_entry(keys, output, ((output - tail) ** 2).mean(-1)))
        return entries

    diff, note = hold("/prediction/fleet", body, cpu_body, reference)
    phase("lstm", f"POST /prediction/fleet ({len(frames)} machines x {ROWS} rows: {len(seeds)} LSTM in "
          f"{len(LSTM_GROUPS)} buckets, {len(LSTM_FF_MACHINES)} feedforward): 200 in {ms:.1f} ms on the card's "
          f"app, K2 launches {k2}, max abs diff vs the CPU app {diff:.3e}: {note}; {card}")
    return {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}


def lstm_times(card):
    """The windowed forward (``forward_lstm_windows``, 256 windows a batch)
    at the anomaly shape (1 x ROWS) and the fleet shape (16 x ROWS) for
    lstm_model's defaults and the hourglass, with CUDA events, beside its
    bound and a cuDNN ``torch.nn.LSTM`` stack of the same layers. Returns
    ``{shape: (ms, bound_ms, bound_by, cudnn_ms, max abs from cuDNN)}``."""
    from gordo_tpu_torch.models.factories import lstm_hourglass, lstm_model
    from gordo_tpu_torch.models.nn import forward_lstm_windows

    out = {}
    for label, spec in (("lstm_model(20)", lstm_model(20, lookback_window=10)),
                        ("lstm_hourglass(20)", lstm_hourglass(20, lookback_window=10, encoding_layers=2))):
        for members in (1, 16):
            case = lstm_case(spec, members)
            args = (spec, case["params"], case["series"], case["order"])
            ms = cuda_ms(lambda: forward_lstm_windows(*args), iters=5, warmup=2)
            yardstick = cudnn_yardstick(case)
            cudnn_ms = cuda_ms(yardstick, iters=5, warmup=2)
            err = float((yardstick() - forward_lstm_windows(*args)).abs().max())
            bound_ms, bound_by = lstm_bound(case)
            shape = f"{label} M={members} B={ROWS}"
            out[shape] = (ms, bound_ms, bound_by, cudnn_ms, err)
            phase("lstm times", f"windowed forward {shape} ({case['order'].shape[1]} windows a member): "
                  f"{ms!r} ms, bound {bound_ms!r} ms ({bound_by}, CUDA-core f32; {bound_ms / ms:.2%} of it), "
                  f"cuDNN nn.LSTM stack {cudnn_ms!r} ms (max abs {err:.3e} from the port's); {card}")
    return out


def make_step(n_features, members, g=1):
    """One optimizer step of the build's stacked fit on the card, as a
    closure: ``members`` feedforward_hourglass(``n_features``) members,
    Adam, 32 seeded rows each; packed in packs of ``g`` when ``g > 1``
    (``PackedFit``, the shared step counts)."""
    import torch

    from gordo_tpu_torch.models.factories import feedforward_hourglass
    from gordo_tpu_torch.models.packing import PackedFit
    from gordo_tpu_torch.models.training import FitConfig, StackedFit, TorchRandom
    from gordo_tpu_torch.parallel.fleet import stack_member_params

    spec = feedforward_hourglass(n_features)
    config = FitConfig(epochs=5, batch_size=32)
    fit = PackedFit(spec, config, g) if g > 1 else StackedFit(spec, config)
    params = stack_member_params([TorchRandom().init_params(spec, s) for s in range(members)], "cuda")
    for leaf in fit.leaves(params):
        leaf.requires_grad_(True)
    state = fit.optimizer.init(fit.leaves(params))
    gen = torch.Generator().manual_seed(0)
    xb = torch.rand(members, 32, n_features, generator=gen).cuda()
    wb = torch.ones(members, 32, device="cuda")
    active = torch.ones(members, dtype=torch.bool, device="cuda")
    return lambda: fit.train_step(params, state, xb, xb, wb, active)


def step_device_ms(step):
    """Device ms of one ``step`` (from :func:`make_step`): CUDA events
    around one step queued behind a device sleep, the median of 5. One
    step at a time: a step is ~350 launches, and more than the card's
    launch queue holds would let the host pace the device again."""
    import statistics

    return statistics.median(cuda_ms(step, iters=1) for _ in range(5))


def tag_list(n_tags):
    """The 20-tag machines' tags, or the 40-tag compressors' own."""
    return [f"tag-{j:02d}" for j in range(n_tags)] if n_tags == 20 else [f"ctag-{j:02d}" for j in range(n_tags)]


def request_frame(seed, rows=ROWS, first_row=0, n_tags=20):
    """``rows`` 10-minute rows of ``n_tags`` tags from row ``first_row`` on."""
    start = datetime(2020, 3, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * (first_row + r))).isoformat() for r in range(rows)]
    values = sensor_data(10_000 + seed, rows, n_tags)
    values[rows // 2:rows // 2 + 6, 3] += 25.0  # an excursion to flag
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tag_list(n_tags))}


def own_frame(name, n_tags):
    """A machine's next ROWS rows, as a deployment sends them: its own
    sensor stream (``sensor_data`` from its build seed) past the
    TRAIN_ROWS it was trained on, with request_frame's excursion."""
    seed = int(name.rsplit("-", 1)[1]) + (WIDE_SEED if name.startswith("compressor-") else 0)
    start = datetime(2020, 1, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * (TRAIN_ROWS + r))).isoformat() for r in range(ROWS)]
    values = sensor_data(seed, TRAIN_ROWS + ROWS, n_tags)[TRAIN_ROWS:]
    values[ROWS // 2:ROWS // 2 + 6, 3] += 25.0
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tag_list(n_tags))}


def post(url, payload):
    request = urllib.request.Request(
        url, data=json.dumps(payload).encode(), headers={"Content-Type": "application/json"}
    )
    t0 = time.perf_counter()
    with urllib.request.urlopen(request, timeout=300) as response:
        body = response.read()
        status = response.status
    return status, json.loads(body), (time.perf_counter() - t0) * 1e3


def wsgi_call(app, method, path, payload=None, query="", headers=None, raw=None, content_type="application/json",
              response_headers=None):
    """One request straight into a WSGI app, without a socket: ``(status,
    body bytes)``; ``raw`` bytes are sent as they are instead of
    ``payload``'s JSON; the response's headers go into the dict
    ``response_headers`` when one is given."""
    import io
    from wsgiref.util import setup_testing_defaults

    body = raw if raw is not None else b"" if payload is None else json.dumps(payload).encode()
    environ = {}
    setup_testing_defaults(environ)
    environ.update(
        REQUEST_METHOD=method, PATH_INFO=path, QUERY_STRING=query, CONTENT_LENGTH=str(len(body)),
        CONTENT_TYPE=content_type, **{"wsgi.input": io.BytesIO(body)},
        **{"HTTP_" + k.upper().replace("-", "_"): v for k, v in (headers or {}).items()},
    )
    status = []

    def start_response(line, pairs):
        status.append(int(line.split()[0]))
        if response_headers is not None:
            response_headers.update(pairs)

    chunks = app(environ, start_response)
    try:
        return status[0], b"".join(chunks)
    finally:
        getattr(chunks, "close", lambda: None)()


def wsgi_post(app, path, payload):
    """One POST straight into a WSGI app: ``(status, parsed JSON)``."""
    status, body = wsgi_call(app, "POST", path, payload)
    return status, json.loads(body)


def wsgi_arrow(app, path, payload):
    """``payload`` (``{"X": frame, "y"?: frame}``) POSTed straight into a
    WSGI app as an Arrow body, answered as Arrow: ``(status, {"data":
    tree})``, the tree the JSON route answers (``arrow_tree``; ``[arrow]``
    holds the two equal to the bit), for a tenth of the JSON codec's host
    time."""
    from gordo_tpu_torch.server import wire

    y = payload.get("y")
    body = wire.encode_request(wire.decode_frame(payload["X"]), None if y is None else wire.decode_frame(y))
    status, answer = wsgi_call(app, "POST", path, raw=body, content_type=ARROW_TYPE, headers={"Accept": ARROW_TYPE})
    return status, {"data": arrow_tree(wire.decode_response(answer)[0])} if status == 200 else json.loads(answer)


def http_call(url, method="GET"):
    """A bodiless request over the socket: ``(status, body bytes)``."""
    with urllib.request.urlopen(urllib.request.Request(url, method=method), timeout=300) as response:
        return response.status, response.read()


def http_request(url, method, payload=None, headers=None):
    """One request over the socket, any status: ``(status, body bytes,
    revision header, host ms)``."""
    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(url, data=data, method=method,
                                     headers={"Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=300) as response:
            status, body, revision = response.status, response.read(), response.headers.get("revision")
    except urllib.error.HTTPError as error:
        status, body, revision = error.code, error.read(), error.headers.get("revision")
    return status, body, revision, (time.perf_counter() - t0) * 1e3


def same_json(expected, got, path="data"):
    """Nested objects equal: same keys in the same order, numbers within
    RTOL/ATOL, everything else exact. Returns the largest abs difference."""
    if isinstance(expected, dict):
        check(isinstance(got, dict) and list(got) == list(expected), f"keys differ at {path}")
        return max([same_json(expected[k], got[k], f"{path}/{k}") for k in expected] or [0.0])
    if isinstance(expected, float) and isinstance(got, float):
        diff = abs(got - expected)
        check(diff <= ATOL + RTOL * abs(expected), f"{path}: {got} vs {expected}")
        return diff
    check(got == expected, f"{path}: {got!r} vs {expected!r}")
    return 0.0


ANOMALY_GROUPS = [
    "start", "end", "model-input", "model-output", "tag-anomaly-scaled", "total-anomaly-scaled",
    "tag-anomaly-unscaled", "total-anomaly-unscaled", "anomaly-confidence", "total-anomaly-confidence",
]


def serve_phase(base, names, wide_names, cpu_app):
    """Three anomaly requests and one fleet request to the 20-tag machines
    of the card's app at ``base``, then one anomaly request to a 40-tag
    machine and one fleet request for the 40-tag bucket (the wide kernel),
    each answer held against the CPU app's; returns the launches of K1 (the
    anomaly route) and K2 (the fleet route) the first four made, and those
    the two 40-tag requests made."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    anomaly_names = [names[0], names[17], names[63]]
    requests = [(f"/{n}/anomaly/prediction", {"X": request_frame(i), "y": request_frame(i)})
                for i, n in enumerate(anomaly_names)]
    fleet_payload = {"X": {n: request_frame(100 + i) for i, n in enumerate(names)}}
    requests.append(("/prediction/fleet", fleet_payload))
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    answers = [post(base + path, payload) for path, payload in requests]
    launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(launches["K1"] >= 1, "the served anomaly requests never launched K1")
    check(launches["K2"] >= 1, "the served fleet request never launched K2")
    max_diff = check_answers(requests, answers, names, 20, cpu_app)
    phase("serve", f"{len(requests)} requests, K1 launches {launches['K1']}, K2 launches {launches['K2']}, "
          f"max abs diff vs the CPU app {max_diff:.3e} (rtol {RTOL}, atol {ATOL})")

    # the 40-tag bucket: its spec is wider than 32, so only the wide kernel runs. Each machine is sent
    # its own next rows: another machine's levels put both apps' f32 forwards beyond ATOL of the exact
    # answer, so they would agree only by chance ([routes] holds one such request to an f64 forward)
    frame = own_frame(wide_names[5], WIDE_TAGS)
    wide_requests = [
        (f"/{wide_names[5]}/anomaly/prediction", {"X": frame, "y": frame}),
        ("/prediction/fleet", {"X": {n: own_frame(n, WIDE_TAGS) for n in wide_names}}),
    ]
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    wide_answers = [post(base + path, payload) for path, payload in wide_requests]
    wide_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(wide_launches["K1"] >= 1, "the 40-tag anomaly request never launched K1's wide kernel")
    check(wide_launches["K2"] >= 1, "the 40-tag fleet request never launched K2's wide kernel")
    wide_diff = check_answers(wide_requests, wide_answers, wide_names, WIDE_TAGS, cpu_app)
    phase("serve", f"{len(wide_requests)} 40-tag requests (hourglass40, the wide kernel), "
          f"K1 launches {wide_launches['K1']}, K2 launches {wide_launches['K2']}, "
          f"max abs diff vs the CPU app {wide_diff:.3e} (rtol {RTOL}, atol {ATOL})")
    return launches, wide_launches


def check_answers(requests, answers, names, n_tags, cpu_app):
    """Each answer 200, of the right shape, equal to the CPU app's; returns
    the largest abs difference."""
    import math

    max_diff = 0.0
    for (path, payload), (status, body, ms) in zip(requests, answers):
        check(status == 200, f"{path} answered {status}")
        cpu_status, cpu_body = wsgi_post(cpu_app, "/gordo/v0/smoke" + path, payload)
        check(cpu_status == 200, f"CPU app answered {cpu_status} on {path}")
        data = body["data"]
        if path.endswith("anomaly/prediction"):
            check(list(data) == ANOMALY_GROUPS, f"anomaly groups {list(data)}")
            check(all(len(col) == ROWS for group in data.values() for col in group.values()), "row count")
            check(all(isinstance(v, float) and math.isfinite(v)
                      for g in ANOMALY_GROUPS[2:] for col in data[g].values() for v in col.values()),
                  "non-finite anomaly values")
            flagged = max(data["total-anomaly-confidence"]["total-anomaly-confidence"].values())
            phase("serve", f"POST {path}: 200 in {ms:.1f} ms, peak total-anomaly-confidence {flagged:.3f}")
        else:
            check(sorted(data) == names, "fleet answered other machines")
            check(all(list(entry) == ["model-output", "total-anomaly-unscaled"] for entry in data.values()),
                  "fleet entry groups")
            check(all(len(entry["model-output"]) == n_tags and len(entry["total-anomaly-unscaled"]) == ROWS
                      for entry in data.values()), "fleet entry shape")
            phase("serve", f"POST {path} ({len(names)} machines x {ROWS} rows): 200 in {ms:.1f} ms")
        max_diff = max(max_diff, same_json(cpu_body["data"], data))
    return max_diff


ARROW_TYPE = "application/vnd.apache.arrow.stream"
#: [arrow]'s K1 and K2 calls on the card, by what they scored: each is held
#: against the plain version and timed in [times]
ARROW_CASES = {
    "K1 narrow": "arrow anomaly and prediction: hourglass20 gather M=1 B=1008 +ingest",
    "K1 wide": "arrow anomaly and prediction: hourglass40 gather M=1 B=1008 +ingest",
    "K2 fleet": "K2 arrow fleet: hourglass20 M=64 B=1008 y=X +ingest",
    "K2 flush": "K2 arrow stream flush: hourglass20 M=64 B=64 y=X +ingest",
}


def raw_post(url, body, content_type, accept=None):
    """One POST of raw bytes over the socket, any status: ``(status, body
    bytes, headers, host ms)``."""
    headers = {"Content-Type": content_type, **({"Accept": accept} if accept else {})}
    request = urllib.request.Request(url, data=body, method="POST", headers=headers)
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=300) as response:
            status, data, got = response.status, response.read(), dict(response.headers)
    except urllib.error.HTTPError as error:
        status, data, got = error.code, error.read(), dict(error.headers)
    return status, data, got, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def captured_store_kernels():
    """While open, each K1 and K2 call of the store on the card as
    ``(kernel, case, launches it made)``, its indices as a list."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import fleet_store

    calls, originals = [], (fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores)

    def listed(indices):
        return None if indices is None else [int(i) for i in (indices.tolist() if hasattr(indices, "tolist")
                                                                else indices)]

    def k1(spec, stacked, X, indices=None, ingest=None, *args, **kwargs):
        before = fleet_feedforward.launches
        out = originals[0](spec, stacked, X, indices, ingest, *args, **kwargs)
        if X.is_cuda:
            calls.append(("K1", dict(spec=spec, bucket=stacked, X=X, indices=listed(indices), ingest=ingest),
                          fleet_feedforward.launches - before))
        return out

    def k2(spec, stacked, X, y, indices=None, ingest=None, *args, **kwargs):
        before = fleet_anomaly_scores.launches
        out = originals[1](spec, stacked, X, y, indices, ingest, *args, **kwargs)
        if X.is_cuda:
            calls.append(("K2", dict(spec=spec, bucket=stacked, X=X, y=y, indices=listed(indices), ingest=ingest),
                          fleet_anomaly_scores.launches - before))
        return out

    fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores = k1, k2
    try:
        yield calls
    finally:
        fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores = originals


def arrow_tree(table):
    """A decoded Arrow response table as the JSON route's ``data`` tree:
    ``{group: {sub (the group for a scalar one): {index key: value}}}``,
    NaN and nulls as None."""
    import math

    from gordo_tpu_torch.server.wire import index_wire_keys

    keys = index_wire_keys(table.index)
    tree = {}
    for column in table.columns:
        values = [None if v is None or (isinstance(v, float) and math.isnan(v)) else v
                  for v in column.values.tolist()]
        tree.setdefault(column.group, {})[column.sub or column.group] = dict(zip(keys, values))
    return tree


def same_tree(expected, got, path):
    """Nested objects equal to the bit: the same keys in the same order."""
    if isinstance(expected, dict):
        check(isinstance(got, dict) and list(got) == list(expected), f"{path}: keys differ")
        for key in expected:
            same_tree(expected[key], got[key], f"{path}/{key}")
    else:
        check(got == expected and type(got) is type(expected), f"{path}: {got!r} vs {expected!r}")


def stage_text(headers):
    stages, wall_ms, _ = server_timing(headers)
    return (", ".join(f"{name} {stages[name]:.2f}" for name in ("data_decode", "inference", "response_assemble",
                                                                  "serialize") if name in stages)
            + f" ms, walltime {wall_ms:.1f} ms")


def arrow_phase(base, names, wide_names, card):
    """``[arrow]`` on the card's app at ``base`` ([serve]'s, no new build):
    a 20-tag and a 40-tag anomaly request, a 20-tag and a 40-tag
    ``/prediction``, a fleet request for the 64 20-tag machines and two
    stream ingests of 64 rows a machine, each sent as JSON and then as
    Arrow (``Content-Type`` and ``Accept`` of the Arrow stream type; the
    fleet and stream bodies ``GDTAF1`` containers). Every Arrow answer,
    decoded by the port's ``decode_response``/``unpack_streams``, must equal
    the JSON answer of the same request to the bit: floats, index,
    ``start``/``end``, revision, the fleet trailer's errors, the stream's
    acks. Prints each pair's ``Server-Timing`` stages and bytes. Counts K1
    and K2 over the Arrow run (one K1 a per-model request, one K2 for the
    fleet request, one a flush) and returns them with the captured
    kernel calls."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import wire

    def arrow_body(X, y=None):
        return wire.encode_request(wire.decode_frame(X), None if y is None else wire.decode_frame(y))

    wide_frame = own_frame(wide_names[5], WIDE_TAGS)
    single = [
        ("20-tag anomaly", f"/{names[0]}/anomaly/prediction", request_frame(500), request_frame(500)),
        ("40-tag anomaly", f"/{wide_names[5]}/anomaly/prediction", wide_frame, wide_frame),
        ("20-tag prediction", f"/{names[17]}/prediction", request_frame(501), None),
        ("40-tag prediction", f"/{wide_names[2]}/prediction", own_frame(wide_names[2], WIDE_TAGS), None),
    ]
    fleet_frames = {n: request_frame(100 + i) for i, n in enumerate(names)}
    stream_posts = [{n: request_frame(600 + 10 * step + i, STREAM_WINDOW, step * STREAM_WINDOW)
                     for i, n in enumerate(names)} for step in range(2)]

    json_answers = {label: raw_post(base + path, json.dumps({"X": X} if y is None else {"X": X, "y": y}).encode(),
                                    "application/json") for label, path, X, y in single}
    json_answers["64-machine fleet"] = raw_post(base + "/prediction/fleet", json.dumps({"X": fleet_frames}).encode(),
                                                "application/json")
    json_acks = [raw_post(base + "/stream/arrow-json/ingest", json.dumps({"X": frames}).encode(), "application/json")
                 for frames in stream_posts]
    t0 = time.perf_counter()
    bodies = {label: arrow_body(X, y) for label, _, X, y in single}
    bodies["64-machine fleet"] = wire.pack_streams({n: arrow_body(f) for n, f in fleet_frames.items()})
    stream_bodies = [wire.pack_streams({n: arrow_body(f) for n, f in frames.items()}) for frames in stream_posts]
    encode_ms = (time.perf_counter() - t0) * 1e3

    with captured_store_kernels() as calls:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        arrow_answers = {label: raw_post(base + path, bodies[label], ARROW_TYPE, ARROW_TYPE)
                         for label, path, _, _ in single}
        arrow_answers["64-machine fleet"] = raw_post(base + "/prediction/fleet", bodies["64-machine fleet"],
                                                     ARROW_TYPE, ARROW_TYPE)
        arrow_acks = [raw_post(base + "/stream/arrow/ingest", body, ARROW_TYPE) for body in stream_bodies]
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    expected = {"K1": len(single), "K2": 1 + len(stream_posts)}
    check(launches == expected, f"[arrow]'s Arrow requests launched {launches}, not {expected}")

    for label, (status, body, headers, ms) in arrow_answers.items():
        json_status, json_body, json_headers, json_ms = json_answers[label]
        check(status == json_status == 200 and headers["Content-Type"] == ARROW_TYPE,
              f"{label}: Arrow answered {status} {headers.get('Content-Type')}, JSON {json_status}")
        answer = json.loads(json_body)
        if label.endswith("fleet"):
            entries, trailer = wire.unpack_streams(body)
            check(list(entries) == list(answer["data"]) == names, f"{label}: machines differ")
            for name, stream in entries.items():
                table, _ = wire.decode_response(stream)
                tree = arrow_tree(table)
                # the JSON lean entry's per-row mse is flat, not nested under its group
                tree["total-anomaly-unscaled"] = tree["total-anomaly-unscaled"]["total-anomaly-unscaled"]
                same_tree(answer["data"][name], tree, f"{label}/{name}")
            check(trailer == {"errors": answer.get("errors", {}), "revision": answer["revision"]},
                  f"{label}: trailer {trailer}")
        else:
            table, extra = wire.decode_response(body)
            same_tree(answer["data"], arrow_tree(table), label)
            check(extra["revision"] == answer["revision"] == headers["revision"]
                  and ("time-seconds" in extra) == ("time-seconds" in answer), f"{label}: envelope {extra}")
        phase("arrow", f"{label}: Arrow {len(body)} B in {ms:.1f} ms ({stage_text(headers)}); JSON "
              f"{len(json_body)} B in {json_ms:.1f} ms ({stage_text(json_headers)}); the answers equal to the bit")
    for step, ((status, body, headers, ms), (json_status, json_body, json_headers, json_ms)) in enumerate(
            zip(arrow_acks, json_acks)):
        ack, json_ack = json.loads(body), json.loads(json_body)
        check(status == json_status == 200 and {**ack, "stream": None} == {**json_ack, "stream": None}
              and ack["scored"] == {n: STREAM_WINDOW for n in names}, f"stream ingest {step}: {ack} vs {json_ack}")
        phase("arrow", f"stream ingest {step} ({len(names)} machines x {STREAM_WINDOW} rows, a GDTAF1 container of "
              f"{len(stream_bodies[step])} B): {ms:.1f} ms ({stage_text(headers)}); JSON {len(json.dumps({'X': stream_posts[step]}))} B "
              f"{json_ms:.1f} ms ({stage_text(json_headers)}); acks equal, {STREAM_WINDOW} rows scored a machine")
    for stream in ("arrow", "arrow-json"):
        check(http_call(f"{base}/stream/{stream}", method="DELETE")[0] == 200, f"closing stream {stream}")

    cases = {}
    for kernel, case, made in calls:
        width = case["spec"].n_features
        key = (f"K1 {'narrow' if width == 20 else 'wide'}" if kernel == "K1"
               else "K2 fleet" if case["X"].shape[1] == ROWS else "K2 flush")
        cases.setdefault(key, [case, 0])[1] += made
    check(sorted(cases) == sorted(ARROW_CASES), f"[arrow]'s kernel calls {sorted(cases)}")
    shapes = {key: (tuple(case["X"].shape), case["indices"]) for key, (case, _) in cases.items()}
    check(shapes["K1 narrow"][0] == (1, ROWS, 20) and shapes["K1 wide"][0] == (1, ROWS, WIDE_TAGS)
          and shapes["K2 fleet"][0] == (SERVED_MACHINES, ROWS, 20)
          and shapes["K2 flush"][0] == (SERVED_MACHINES, STREAM_WINDOW, 20), f"[arrow]'s kernel shapes {shapes}")
    phase("arrow", f"Arrow bodies encoded by the client in {encode_ms:.1f} ms; K1 launches {launches['K1']} (one a "
          f"per-model request), K2 {launches['K2']} (the fleet request, one a flush); by call "
          f"{ {key: made for key, (_, made) in cases.items()} }; {card}")
    return launches, {ARROW_CASES[key]: (case, made) for key, (case, made) in cases.items()}


def sse_events(body):
    """``(id, event, data)`` of each event frame of an SSE body; heartbeat
    comments left out."""
    frames = []
    for frame in body.decode().split("\n\n"):
        if frame and not frame.startswith(":"):
            fields = dict(line.split(": ", 1) for line in frame.split("\n"))
            frames.append((fields.get("id"), fields["event"], json.loads(fields["data"])))
    return frames


def stream_phase(base, names, cpu_app):
    """The streaming plane on the card's app at ``base`` and on the CPU app:
    the same ingests, acks and events; every flush one K2 launch. Returns
    K2's launches, the ingest latencies and the rows scored a second."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    stream = "/stream/smoke"
    local = "/gordo/v0/smoke" + stream  # the same path on the CPU app
    first_row, latencies, scored = 0, [], 0
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    for step, rows in enumerate(STREAM_POSTS):
        payload = {"X": {n: request_frame(300 + 10 * step + i, rows, first_row) for i, n in enumerate(names)}}
        first_row += rows
        status, ack, ms = post(base + stream + "/ingest", payload)
        cpu_status, cpu_ack = wsgi_post(cpu_app, local + "/ingest", payload)
        check(status == cpu_status == 200, f"stream ingest answered {status} (CPU app {cpu_status})")
        same_json(cpu_ack, ack)
        check(ack["scored"] == {n: STREAM_SCORED[step] for n in names} and not ack["errors"],
              f"ingest {step} scored {ack['scored']} with errors {ack['errors']}")
        latencies.append(ms)
        scored += sum(ack["scored"].values())
        phase("stream", f"ingest {step}: {len(names)} machines x {rows} rows, scored {STREAM_SCORED[step]} a machine, "
              f"200 in {ms:.1f} ms")
    launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(launches["K2"] >= len(STREAM_POSTS), f"the stream flushes launched K2 {launches['K2']} times")

    expected_events = len(STREAM_POSTS) * len(names)
    query = f"max_events={expected_events}&idle_timeout_s=5"
    status, body = http_call(f"{base}{stream}/events?{query}")
    cpu_status, cpu_body = wsgi_call(cpu_app, "GET", local + "/events", query=query)
    check(status == cpu_status == 200, f"events answered {status} (CPU app {cpu_status})")
    got, expected = sse_events(body), sse_events(cpu_body)
    check([k for _, k, _ in got] == ["open"] + ["anomaly"] * expected_events, "stream event kinds")
    check([(i, k) for i, k, _ in got] == [(i, k) for i, k, _ in expected], "stream event ids differ from the CPU app's")
    max_diff = max(same_json(want, have) for (_, _, want), (_, _, have) in zip(expected, got))
    check(all(d["mse_mean"] is not None for _, k, d in got if k == "anomaly"), "an anomaly event without mse")
    status, body = http_call(base + stream, method="DELETE")
    cpu_status, cpu_body = wsgi_call(cpu_app, "DELETE", local)
    check(status == cpu_status == 200 and json.loads(body) == json.loads(cpu_body), "stream close")
    rows_per_s = scored / (sum(latencies) / 1e3)
    phase("stream", f"{len(got) - 1} anomaly events equal to the CPU app's (max abs diff {max_diff:.3e}, "
          f"rtol {RTOL}, atol {ATOL}); K2 launches {launches['K2']}, K1 launches {launches['K1']}; "
          f"ingest ms {[round(ms, 1) for ms in latencies]}, {rows_per_s:.0f} rows scored a second")
    return launches, latencies, rows_per_s


def second_revision(collection, machines):
    """A revision beside ``collection`` holding copies of ``machines``,
    each detector given a ``SMOOTH_WINDOW``-row rolling median (as a later
    build of the same config with a window would)."""
    from gordo_tpu_torch import serializer

    second = os.path.join(os.path.dirname(collection), SECOND_REVISION)
    for name in machines:
        source = os.path.join(collection, name)
        with open(os.path.join(source, serializer.MODEL_FILE), "rb") as f:
            detector = serializer.loads(f.read(), device="cpu")
        detector.window, detector.smoothing_method = SMOOTH_WINDOW, "smm"
        serializer.dump(detector, os.path.join(second, name), metadata=serializer.load_metadata(source))
    return second


def f64_forward(model, X):
    """``model``'s reconstruction of raw rows ``X[rows, tags]`` in float64:
    its ingest plan and layers, the f32 weights widened."""
    import numpy as np
    import torch
    from gordo_tpu_torch.models.estimators import find_estimator
    from gordo_tpu_torch.ops.activations import resolve_activation
    from gordo_tpu_torch.server.fleet_store import member_plan

    estimator = find_estimator(model)
    scale, offset = member_plan(model, X.shape[1])
    h = torch.from_numpy(np.asarray(X, np.float64) * scale.astype(np.float64) + offset.astype(np.float64))
    for key, activation in estimator.spec_.layer_names():
        W, b = (estimator.params_[key][n].cpu().double() for n in ("W", "b"))
        h = resolve_activation(activation)(h @ W + b)
    return h.numpy()


def f64_distances(cpu_body, body, reference, path):
    """Pop ``model-output`` from both answers and return the largest abs
    difference of the CPU app's and of the card's from ``reference[rows,
    tags]``; the groups' tags and row keys must be equal."""
    import numpy as np

    outputs = [answer["data"].pop("model-output") for answer in (cpu_body, body)]
    check([(t, list(c)) for t, c in outputs[0].items()] == [(t, list(c)) for t, c in outputs[1].items()],
          f"{path}: model-output tags or rows differ")
    return [float(np.abs(np.array([list(col.values()) for col in out.values()]).T - reference).max())
            for out in outputs]


def routes_phase(base, names, wide_names, cpu_app, collection, card):
    """The JSON routes of the card's app at ``base`` beside a second
    revision, every answer held to the CPU app's on the same directories;
    each ``/prediction`` must launch K1. Returns the phase's launches of K1
    and K2."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server.wire import decode_frame

    root, prefix = base.split("/gordo/v0/")
    prefix = "/gordo/v0/" + prefix
    second = second_revision(collection, names[:3] + wide_names[:1])
    pin = f"revision={SECOND_REVISION}"
    narrow_x, wide_x = own_frame(names[0], 20), own_frame(wide_names[0], WIDE_TAGS)

    def both(method, path, query="", payload=None, headers=None, status=200, cpu_first=None, f64=None):
        """The request to the card's app over the socket and to the CPU app
        (``cpu_first`` runs between the two when given); both answer
        ``status`` with equal bodies, except that with ``f64`` (an f64
        forward of the rows) ``model-output`` is held to it instead: the
        card's at most F64_MULTIPLE times as far as the CPU app's (or ATOL).
        Returns the card's parsed body."""
        url = path if path == "/server-version" else prefix + path
        before = fleet_feedforward.launches
        if cpu_first is not None:
            cpu_status, cpu_body = wsgi_call(cpu_app, method, url, payload, query, headers)
            cpu_first()
        got, body, revision, ms = http_request(root + url + ("?" + query if query else ""), method, payload, headers)
        k1 = fleet_feedforward.launches - before
        if cpu_first is None:
            cpu_status, cpu_body = wsgi_call(cpu_app, method, url, payload, query, headers)
        check(got == cpu_status == status, f"{method} {url}?{query} answered {got} (CPU app {cpu_status}), not {status}")
        body, cpu_body = json.loads(body), json.loads(cpu_body)
        body.pop("time-seconds", None)
        cpu_body.pop("time-seconds", None)
        note = ""
        if f64 is not None:
            cpu_err, card_err = f64_distances(cpu_body, body, f64, path)
            limit = F64_MULTIPLE * max(cpu_err, ATOL)
            check(card_err <= limit, f"{path}: model-output {card_err:.3e} from an f64 forward, "
                  f"the CPU app's {cpu_err:.3e} (limit {limit:.3e})")
            note = (f", model-output max abs from an f64 forward: card {card_err:.3e}, CPU app {cpu_err:.3e} "
                    f"(limit {F64_MULTIPLE} x max(CPU app's, ATOL) = {limit:.3e})")
        same_json(cpu_body, body, path)
        check(revision == body.get("revision"), f"{path}: revision header {revision!r}, body {body.get('revision')!r}")
        if path.endswith("/prediction") and status == 200:
            check(k1 >= 1, f"{method} {url}?{query} never launched K1")
        sent = f"{method} {url}{'?' + query if query else ''}{' ' + json.dumps(headers) if headers else ''}"
        phase("routes", f"{sent}: {got} in {ms:.1f} ms on the host clock, K1 launches {k1}{note}; {card}")
        return body

    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    models = both("GET", "/models")["models"]
    check(models == sorted(names + wide_names), "/models lists other machines")
    revisions = both("GET", "/revisions")
    check(revisions["latest"] == REVISION and SECOND_REVISION in revisions["available-revisions"], "/revisions")
    check(list(both("GET", "/server-version")) == ["version"], "/server-version")
    check(both("GET", "/expected-models")["expected-models"] == ["machine-000", "compressor-000"], "/expected-models")
    check(both("GET", f"/{names[0]}/metadata")["metadata"]["name"] == names[0], "metadata")
    served = [both("POST", f"/{n}/prediction", payload={"X": x}) for n, x in ((names[0], narrow_x), (wide_names[0], wide_x))]
    pinned = [both("POST", f"/{n}/prediction", pin, {"X": x}) for n, x in ((names[0], narrow_x), (wide_names[0], wide_x))]
    for got, want in zip(pinned, served):
        check(got["revision"] == SECOND_REVISION, "a pinned answer carries another revision")
        same_json(want["data"], got["data"])  # the copies score what the originals score
    check(len(served[1]["data"]["model-output"]) == WIDE_TAGS, "40-tag prediction columns")
    # another machine's levels at a 40-tag machine: both apps' f32 forwards lie beyond ATOL of the
    # exact answer here, so each is held to an f64 forward of the same rows
    far_x = request_frame(401, n_tags=WIDE_TAGS)
    reference = f64_forward(serializer.load(os.path.join(collection, wide_names[0]), "cpu"),
                            decode_frame(far_x).values)
    both("POST", f"/{wide_names[0]}/prediction", payload={"X": far_x}, f64=reference)
    both("POST", f"/{names[0]}/anomaly/prediction", "revision=999", {"X": narrow_x, "y": narrow_x}, status=410)
    smooth = both("POST", f"/{names[0]}/anomaly/prediction", pin + "&all_columns", {"X": narrow_x, "y": narrow_x})
    check(len(smooth["data"]) == 14 and "smooth-total-anomaly-scaled" in smooth["data"],
          f"?all_columns gave {len(smooth['data'])} column groups")
    both("POST", f"/{names[0]}/anomaly/prediction", payload={"X": narrow_x, "y": narrow_x},
         headers={"Accept": "text/csv"}, status=406)
    both("DELETE", f"/{names[0]}/revision/{REVISION}", status=409)
    machine_dir = os.path.join(second, names[2])
    kept = shutil.copytree(machine_dir, os.path.join(os.path.dirname(second), "kept"))
    both("DELETE", f"/{names[2]}/revision/{SECOND_REVISION}", cpu_first=lambda: shutil.copytree(kept, machine_dir))
    check(not os.path.exists(machine_dir), "DELETE left the machine's directory")
    both("POST", f"/{names[2]}/prediction", pin, {"X": narrow_x}, status=404)
    return {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}


# -- [engine]: the micro-batching serve engine ------------------------------------------

#: the latency rounds' concurrent clients (1, 8 and 32 until the [ingress] phase's seconds were paid
#: for here: the largest round's JSON bodies were most of the phase; the round of 8 paid for [mesh]'s)
ENGINE_CLIENTS = (1, 16)
ENGINE_ROUTES = ("anomaly/prediction", "prediction")
ENGINE_PRECISIONS = ("bf16", "int8")
#: the member whose forward the drill poisons
ENGINE_POISON = "machine-005"
#: the engine's batching deadline for the latency rounds: 16-32 clients' 1008-row JSON bodies hold the GIL for
#: seconds, and a rehearsal on the CPU at the 2000 ms default shed requests with 504 while their batch waited
#: for it; those rounds measure latency, so they wait (every other knob is the default). One burst runs at
#: the default deadline and reports its 504s
ENGINE_DEADLINE_MS = 30000.0
#: full batches the engine did not reach here, timed beside its real ones: 32 of the 64 20-tag members, and
#: the 8 40-tag ones, at the 2048-row rung
ENGINE_FULL_CASES = {20: "full engine batch: hourglass20 gather M=32 of 64 B=2048 +ingest",
                     WIDE_TAGS: "full engine batch: hourglass40 gather M=8 of 8 B=2048 +ingest"}


#: [observability]: the stream of its two ingests, their rows a machine, and
#: the anomaly burst through an engine app
OBS_STREAM = "observability"
OBS_STREAM_ROWS = STREAM_WINDOW
OBS_BURST = 8
#: a request's stages inside its ``inference`` stage when an engine scored it
ENGINE_SHARES = ("queue_wait", "batch_stack", "batch_device", "batch_scatter")


def traced_request(url, method, payload=None):
    """One request over the socket: ``(status, parsed body, headers, host ms)``."""
    data = None if payload is None else json.dumps(payload).encode()
    request = urllib.request.Request(url, data=data, method=method, headers={"Content-Type": "application/json"})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(request, timeout=300) as response:
            status, body, headers = response.status, response.read(), dict(response.headers)
    except urllib.error.HTTPError as error:
        status, body, headers = error.code, error.read(), dict(error.headers)
    return status, json.loads(body), headers, (time.perf_counter() - t0) * 1e3


def server_timing(headers):
    """``Server-Timing`` as ``({stage: ms}, walltime ms, share of the
    walltime the top-level stages cover)``. With an engine the batch's
    shares (and its ``device_ingest``) are inside ``inference``."""
    stages, wall_ms = {}, None
    for entry in headers["Server-Timing"].split(", "):
        name, dur = entry.split(";dur=")
        if name == "request_walltime_s":
            wall_ms = float(dur) * 1e3
        else:
            stages[name] = float(dur)
    nested = set(ENGINE_SHARES) | ({"device_ingest"} if "queue_wait" in stages else set())
    covered = sum(ms for name, ms in stages.items() if name not in nested)
    return stages, wall_ms, covered / wall_ms


def captured_launch_times():
    """Until ``restore()``: the wall-clock interval of every K1 and K2 call
    on the card through the store (``(kernel, start, end)``), to hold each
    launch inside the stage or span that should enclose it."""
    from gordo_tpu_torch.server import fleet_store

    intervals, originals = [], (fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores)

    def timed(kernel, launch):
        def call(spec, bucket, X, *args, **kwargs):
            start = time.time()
            try:
                return launch(spec, bucket, X, *args, **kwargs)
            finally:
                if X.is_cuda:
                    intervals.append((kernel, start, time.time()))
        return call

    def restore():
        fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores = originals

    fleet_store.fleet_feedforward = timed("K1", originals[0])
    fleet_store.fleet_anomaly_scores = timed("K2", originals[1])
    return intervals, restore


def span_seconds(span):
    return (datetime.fromisoformat(span["start_time"]).timestamp(), datetime.fromisoformat(span["end_time"]).timestamp())


def observability_requests(names, wide_names, first_row):
    """``[serve]``'s requests, then two stream ingests of OBS_STREAM_ROWS
    rows a machine from ``first_row`` on (a fresh stream)."""
    frame = own_frame(wide_names[5], WIDE_TAGS)
    requests = [(f"/{n}/anomaly/prediction", {"X": request_frame(i), "y": request_frame(i)})
                for i, n in enumerate([names[0], names[17], names[63]])]
    requests.append(("/prediction/fleet", {"X": {n: request_frame(100 + i) for i, n in enumerate(names)}}))
    requests.append((f"/{wide_names[5]}/anomaly/prediction", {"X": frame, "y": frame}))
    requests.append(("/prediction/fleet", {"X": {n: own_frame(n, WIDE_TAGS) for n in wide_names}}))
    for step in range(2):
        requests.append((f"/stream/{OBS_STREAM}/ingest", {"X": {
            n: request_frame(500 + 10 * step + i, OBS_STREAM_ROWS, first_row + step * OBS_STREAM_ROWS)
            for i, n in enumerate(names)}}))
    return requests


def gained_residual_mean(before, after):
    """The residual mean of the rows a ledger record's ``serving`` section
    gained between two readings. Below the ledger's window the rolling mean
    is the plain row-weighted one, so the gained rows' mean is the
    difference of the two weighted sums (each mean rounded to 8 places)."""
    from gordo_tpu_torch.telemetry import HEALTH_WINDOW_ROWS

    rows0, rows1 = before.get("rows", 0), after["rows"]
    check(rows1 < HEALTH_WINDOW_ROWS and rows1 > rows0, f"rows {rows0} -> {rows1}")
    return (after["residual_mean"] * rows1 - (before.get("residual_mean") or 0.0) * rows0) / (rows1 - rows0)


def endpoint_of(path):
    """The route name (a request span's ``http.route``) of a path under
    ``/gordo/v0/smoke``."""
    if path.endswith("/anomaly/prediction"):
        return "anomaly-prediction"
    if path.startswith("/prediction/fleet"):
        return "fleet-prediction"
    if path.startswith("/stream/") and path.endswith("/ingest"):
        return "stream-ingest"
    if path.endswith("/prediction"):
        return "prediction"
    return path.strip("/")


def observability_phase(app, base, names, wide_names, collection, telemetry_dir, card):
    """What the server records about its own traffic, on the card's app over
    the socket (see the module docstring), exported to ``telemetry_dir``.
    Returns the K1 and K2 launches of its traced pass, and what it left in
    ``telemetry_dir`` for ``[slo]``: each request by (route, status), the
    stream rows ingested and the engine's batches."""
    import io

    from gordo_tpu_torch.cli.cli import main as cli_main
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.telemetry import render_fleet_status
    from gordo_tpu_torch.telemetry import serving as serve_trace

    # the CPU reference serves a copy without a health snapshot: its ledger is its own and holds only this
    # phase's rows (every app of one directory in a process feeds that directory's one ledger)
    reference_root = tempfile.mkdtemp(prefix="observability-reference-", dir=os.path.join(HERE, "build"))
    reference_dir = os.path.join(reference_root, REVISION)
    shutil.copytree(collection, reference_dir, ignore=shutil.ignore_patterns("fleet_health*", "serve_trace*"))
    cpu_app = build_app(reference_dir, device="cpu")
    saved = {k: os.environ.get(k) for k in ("GORDO_TPU_TELEMETRY_DIR", "GORDO_TPU_TRACE_SAMPLE_RATE",
                                             "GORDO_TPU_TELEMETRY")}
    os.environ.update(GORDO_TPU_TELEMETRY_DIR=telemetry_dir, GORDO_TPU_TRACE_SAMPLE_RATE="1")
    os.environ.pop("GORDO_TPU_TELEMETRY", None)
    serve_trace.reset_serve_recorder()
    engine = stop_engine = None
    try:
        before = app.health_ledger().document()["machines"]
        requests = observability_requests(names, wide_names, first_row=0)
        engine, _ = engine_app(collection, max_size=OBS_BURST, max_delay_ms=20000.0, deadline_ms=60000.0)
        check(engine.health_ledger() is app.health_ledger(), "two apps of one directory feed two ledgers")
        engine_base, stop_engine = serving(engine)
        burst_names = names[:OBS_BURST]
        burst_requests = [(f"/{n}/anomaly/prediction", engine_body("anomaly", own_frame(n, 20)))
                          for n in burst_names]

        # the traced pass: every request exported, the launches timed
        intervals, restore = captured_launch_times()
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        batches_before = engine.engine.stats()["batches"]
        t0 = time.perf_counter()
        answers = []
        #: every exported request by (route, status), and the stream rows ingested, for [slo]
        exported, stream_rows = collections.Counter(), 0
        try:
            for path, payload in requests:
                k1, k2 = fleet_feedforward.launches, fleet_anomaly_scores.launches
                status, body, headers, ms = traced_request(base + path, "POST", payload)
                answers.append((path, status, headers, ms, fleet_feedforward.launches - k1,
                                fleet_anomaly_scores.launches - k2))
                exported[endpoint_of(path), status] += 1
            burst_answers, _ = burst(engine_base, burst_requests)
            exported.update((endpoint_of(path), status)
                            for (path, _), (status, _, _) in zip(burst_requests, burst_answers))
        finally:
            restore()
        on_wall = time.perf_counter() - t0
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
        on_stages = collections.Counter()
        for path, status, headers, ms, k1, k2 in answers:
            check(status == 200, f"{path} answered {status}")
            check(k1 + k2 >= 1, f"{path} launched no kernel")
            stages, wall_ms, share = server_timing(headers)
            on_stages.update(stages)
            phase("observability", f"POST {path}: {ms:.1f} ms on the client, walltime {wall_ms:.1f} ms, stages "
                  + ", ".join(f"{name} {v:.2f}" for name, v in stages.items())
                  + f" ms; stages cover {share:.1%}; K1 {k1}, K2 {k2}; {card}")
        for (path, _), (status, body, ms) in zip(burst_requests, burst_answers):
            check(status == 200, f"engine {path} answered {status}")
        engine_stats = engine.engine.stats()
        phase("observability", f"engine burst: {len(burst_requests)} anomaly requests in {engine_stats['batches']} "
              f"batch(es), K1 launches {engine_stats['launches']}; {card}")

        # serve_trace.jsonl: spans by name; the launches inside their stages
        serve_trace.serve_recorder().flush()
        trace_files = sorted(f for f in os.listdir(telemetry_dir) if f.startswith("serve_trace"))
        spans = []
        for name in trace_files:
            with open(os.path.join(telemetry_dir, name)) as f:
                spans.extend(json.loads(line) for line in f)
        trace_bytes = sum(os.path.getsize(os.path.join(telemetry_dir, n)) for n in trace_files)
        by_name = collections.Counter(s["name"] for s in spans)
        scoring = [s for s in spans if s["name"] == "request" and s["attributes"]["http.route"] in (
            "anomaly-prediction", "prediction", "fleet-prediction", "stream-ingest")]
        check(len(scoring) == len(requests) + len(burst_requests),
              f"{len(scoring)} scoring request spans for {len(requests) + len(burst_requests)} requests")
        contexts = {(s["context"]["trace_id"], s["context"]["span_id"]) for s in scoring}
        batches = [s for s in spans if s["name"] == "serve_batch"]
        check(batches, "the engine burst left no serve_batch span")
        for batch in batches:
            links = [(link["context"]["trace_id"], link["context"]["span_id"]) for link in batch.get("links", [])]
            check(links and set(links) <= contexts, "a serve_batch links to no request span of the trace")
        holders = [span_seconds(s) for s in spans if s["name"] in ("inference", "device", "stream_score")]
        outside = [(kernel, start) for kernel, start, end in intervals
                   if not any(lo - 1e-6 <= start and end <= hi + 1e-6 for lo, hi in holders)]
        check(len(intervals) == launches["K1"] + launches["K2"], f"{len(intervals)} timed launches for {launches}")
        check(not outside, f"{len(outside)} launches outside an inference stage, device or stream_score span")
        phase("observability", f"serve_trace.jsonl: {len(spans)} spans, {trace_bytes} bytes in {len(trace_files)} "
              f"file(s): " + ", ".join(f"{n} {c}" for n, c in sorted(by_name.items()))
              + f"; {len(intervals)} launches (K1 {launches['K1']}, K2 {launches['K2']}), each inside an "
              f"inference stage, device or stream_score span; {len(batches)} serve_batch span(s) linked")

        # the CPU app gets the scoring requests that feed the residual means (after
        # the trace is read: its requests are exported too)
        for path, payload in requests:
            if path.startswith(("/prediction/fleet", "/stream/")):
                cpu_status, _ = wsgi_post(cpu_app, "/gordo/v0/smoke" + path, payload)
                check(cpu_status == 200, f"CPU app answered {cpu_status} on {path}")
                exported[endpoint_of(path), cpu_status] += 1
            if path.startswith("/stream/"):  # the card app's ingest and the CPU app's
                stream_rows += 2 * sum(len(next(iter(frame.values()))) for frame in payload["X"].values())

        # /fleet-health: the serving counts of what was sent (the engine app's burst too, into the same
        # ledger), the residual means of the rows sent held to the CPU app's
        status, doc, _, ms = traced_request(base + "/fleet-health", "GET")
        check(status == 200, f"/fleet-health answered {status}")
        exported["fleet-health", status] += 1
        machines = doc["health"]["machines"]
        sent = collections.Counter(burst_names)
        sent_rows = collections.Counter()
        for path, payload in requests:
            if path.endswith("/anomaly/prediction"):
                sent[path.split("/")[1]] += 1
            else:
                for n in payload["X"]:
                    sent[n] += 1
                    sent_rows[n] += ROWS if path.startswith("/prediction/fleet") else OBS_STREAM_ROWS
        for n in sorted(set(names) | set(wide_names)):
            was = before.get(n, {}).get("serving", {"requests": 0, "rows": 0})
            now = machines[n]["serving"]
            check(now["requests"] - was["requests"] == sent[n] and now["rows"] - was["rows"] == sent_rows[n],
                  f"{n}: requests {was['requests']} -> {now['requests']}, rows {was['rows']} -> {now['rows']}; "
                  f"sent {sent[n]} requests, {sent_rows[n]} rows")
        cpu_machines = cpu_app.health_ledger().document()["machines"]
        worst = 0.0
        for n in sorted(set(names) | set(wide_names)):
            cpu_serving = cpu_machines[n]["serving"]
            check(cpu_serving["rows"] == sent_rows[n] and cpu_serving["residual_mean"] is not None,
                  f"{n}: the CPU app's ledger has {cpu_serving['rows']} rows, mean {cpu_serving['residual_mean']}")
            card_mean = gained_residual_mean(before.get(n, {}).get("serving", {}), machines[n]["serving"])
            diff = abs(card_mean - cpu_serving["residual_mean"])
            check(diff <= ATOL + RTOL * abs(cpu_serving["residual_mean"]),
                  f"{n}: residual mean of the rows sent {card_mean} vs the CPU app's {cpu_serving['residual_mean']}")
            worst = max(worst, diff)
        check(doc["device"]["memory"]["available"], "the device section has no memory reading")
        phase("observability", f"/fleet-health in {ms:.1f} ms: {doc['health']['summary']['machines']} machines, "
              f"{doc['health']['summary']['requests']} requests; each machine's requests and rows grew by what was "
              f"sent; residual means within {worst:.3e} of the CPU app's (rtol {RTOL}, atol {ATOL}); programs "
              f"{doc['programs']}")
        rendered = render_fleet_status(doc)
        check("Health:" in rendered and "(no fleet_health.json)" not in rendered, "render_fleet_status")
        app.health_ledger().flush()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            code = cli_main(["fleet-status", collection])
        check(code == 0 and "Health:" in out.getvalue(), f"fleet-status exited {code}")
        phase("observability", "fleet-status: " + next(line for line in out.getvalue().splitlines()
                                                         if line.startswith("Health:")))

        # the same requests with telemetry off: the wall time, not gated
        os.environ["GORDO_TPU_TELEMETRY"] = "0"
        serve_trace.reset_serve_recorder()
        off_requests = observability_requests(names, wide_names, first_row=2 * OBS_STREAM_ROWS)
        t0 = time.perf_counter()
        off_stages = collections.Counter()
        for path, payload in off_requests:
            status, _, headers, _ = traced_request(base + path, "POST", payload)
            check(status == 200, f"{path} answered {status} with telemetry off")
            off_stages.update(server_timing(headers)[0])
        off_answers, _ = burst(engine_base, burst_requests)
        off_wall = time.perf_counter() - t0
        check(all(status == 200 for status, _, _ in off_answers), "the engine burst failed with telemetry off")
        check(sorted(os.listdir(telemetry_dir)) == trace_files, "telemetry off wrote a file")
        phase("observability", f"the same {len(requests) + len(burst_requests)} requests: telemetry on "
              f"{on_wall:.3f} s, off {off_wall:.3f} s (one pair, not gated; scripts/serve_telemetry_ab.py "
              f"alternates them); the first {len(requests)} summed by stage, on / off: "
              + ", ".join(f"{name} {on_stages[name]:.1f} / {off_stages[name]:.1f}" for name in on_stages)
              + f" ms; {card}")
        return launches, {"sent": exported, "stream_rows": stream_rows,
                          "batches": engine_stats["batches"] - batches_before}
    finally:
        if stop_engine is not None:
            stop_engine()
        if engine is not None:
            engine.shutdown()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        serve_trace.reset_serve_recorder()
        cpu_app.shutdown()
        shutil.rmtree(reference_root, ignore_errors=True)



#: [slo]: the drill's objectives (a 1% budget; the fast rule pages at 10x), its
#: burst of 500s, the clean requests after it (twenty to an error) and their frames
SLO_DRILL = """
[[slo]]
name = "availability"
objective = "availability"
target = 0.99
window = "30d"

[burn]
fast_window = "1h"
fast_threshold = 10.0
fast_severity = "page"
slow_window = "6h"
slow_threshold = 6.0
slow_severity = "ticket"
confirmation_divisor = 12
"""
SLO_BURST = 4
SLO_RECOVERY = 20 * SLO_BURST
SLO_FRAME_ROWS = 16
#: the drill's kernel shapes: K1 for an anomaly request, K2 for the fleet request of 4 machines
SLO_ANOMALY = "slo drill: hourglass20 gather M=1 B=16 +ingest"
SLO_FLEET = "K2 slo drill fleet: hourglass20 N=64 M=4 B=16 y=X +ingest"
#: the drill's copy of the collection: a revision name of its own, so its resident bytes are its own series
DRILL_REVISION = "1710000000000"
#: anomaly requests of the metrics on/off pair, after a warm-up pass of as many
METRICS_AB = 16


def cli_json(*args):
    """``python -m gordo_tpu_torch ARGS --as-json`` in this process (the SLO
    status it evaluates is the one the apps of this process serve):
    ``(exit code, parsed document)``."""
    import io

    from gordo_tpu_torch.cli.cli import main as cli_main

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli_main([*args, "--as-json"])
    return code, json.loads(out.getvalue())


def serving_metrics():
    """The process registry's ``/metrics`` app behind a threaded socket
    server, as ``--metrics-port`` serves it: ``(url, stop)``."""
    from gordo_tpu_torch.server.app import make_wsgi_server
    from gordo_tpu_torch.server.prometheus.server import build_metrics_app

    server = make_wsgi_server(build_metrics_app(), "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        check(not thread.is_alive(), "metrics server thread did not stop")

    return f"http://127.0.0.1:{server.server_port}/metrics", stop


def scrape(url):
    """One scrape over the socket: ``(samples, host ms, bytes)``."""
    t0 = time.perf_counter()
    with urllib.request.urlopen(url, timeout=60) as response:
        body = response.read()
        content_type = response.headers["Content-Type"]
    ms = (time.perf_counter() - t0) * 1e3
    check(content_type == "text/plain; version=0.0.4; charset=utf-8", f"/metrics answered {content_type}")
    return scrape_samples(body.decode()), ms, len(body)


def drill_metrics(before, after, sent_by, app, served, machines, telemetry_dir, scrape_ms, scrape_bytes, card):
    """The drill's scrapes, held to what was sent to its app: requests by
    method and status, server errors, the ``inference`` stage of each
    scoring answer; the SLO gauges to ``/slo``'s document (the status the
    commands left), the health gauge to the process's ledgers, the resident
    bytes to the store's, the card's memory present."""
    from gordo_tpu_torch.telemetry import fleet_health, slo

    def grown(name, **labels):
        return summed(after, name, **labels) - summed(before, name, **labels)

    counted = {key: grown("gordo_server_requests_total", method=key[0], status_code=str(key[1])) for key in sent_by}
    check(counted == dict(sent_by), f"requests_total grew by {counted}, the drill sent {dict(sent_by)}")
    errors = grown("gordo_server_request_errors_total", kind="server")
    server_errors = sum(n for (_, status), n in sent_by.items() if status >= 500)
    check(errors == server_errors == SLO_BURST, f"errors_total{{kind=server}} grew by {errors}, "
          f"{server_errors} answered 5xx")
    scoring = sum(n for (method, status), n in sent_by.items() if method == "POST" and status == 200)
    inference = grown("gordo_server_stage_duration_seconds_count", stage="inference")
    check(inference == scoring, f"{inference} inference stages observed, {scoring} scoring requests answered")

    status_doc = slo.scrape_statuses()[os.path.normpath(telemetry_dir)]
    for spec in status_doc["slos"]:
        name = spec["name"]
        for window, rate in spec["burn_rates"].items():
            got = summed(after, "gordo_slo_burn_rate", slo=name, window=str(window))
            check(got == float(rate), f"gordo_slo_burn_rate {name} {window}: {got}, /slo {rate}")
        got = summed(after, "gordo_slo_error_budget_remaining_ratio", slo=name)
        check(got == float(spec["budget"]["remaining_ratio"]), f"{name}'s budget gauge {got}")
    states = {"inactive": 0, "resolved": 0, "pending": 1, "firing": 2}
    worst = {}
    for alert in status_doc["alerts"]:
        worst[alert["slo"]] = max(worst.get(alert["slo"], 0), states[alert["state"]])
    alert_state = {n: summed(after, "gordo_slo_alert_state", slo=n) for n in label_values(after,
                                                                                        "gordo_slo_alert_state",
                                                                                        "slo")}
    check(alert_state == worst, f"gordo_slo_alert_state {alert_state}, /slo's alerts {worst}")

    summaries = fleet_health.ledger_summaries()
    health = {state: summed(after, "gordo_fleet_health_machines", state=state)
              for state in label_values(after, "gordo_fleet_health_machines", "state")}
    ledger_machines = sum(summary["machines"] for summary in summaries.values() if summary)
    drill_ledger = summaries.get(os.path.abspath(served)) or {}
    check(sum(health.values()) == ledger_machines and drill_ledger.get("machines") == machines,
          f"gordo_fleet_health_machines {health} over {ledger_machines} machines in the process's {len(summaries)} "
          f"ledgers; the drill's ledger {drill_ledger.get('machines')}")
    resident = app.store.revision_stats()[DRILL_REVISION]
    exposed = {kind: summed(after, "gordo_store_revision_bytes", revision=DRILL_REVISION, kind=kind)
               for kind in ("model", "stacked", "cast")}
    stored = {"model": resident["model_bytes"], "stacked": resident["stacked_bytes"], "cast": resident["cast_bytes"]}
    check(stored["model"] > 0 and exposed == stored, f"gordo_store_revision_bytes {exposed}, the store {resident}")
    memory = {kind: summed(after, "gordo_device_memory_bytes", kind=kind)
              for kind in label_values(after, "gordo_device_memory_bytes", "kind")}
    check(set(memory) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"} and memory["bytes_limit"] > 0,
          f"gordo_device_memory_bytes {memory}")
    phase("metrics", f"[slo] scrape of /metrics over the socket in {scrape_ms:.2f} ms, {scrape_bytes} bytes, "
          f"{len(after)} samples; grown by the drill: requests {dict(sorted(counted.items()))} (as sent), "
          f"errors_total{{kind=server}} {errors:.0f}, inference stages {inference:.0f} = scoring answers; "
          f"gordo_slo_alert_state {alert_state} and every burn rate and budget = /slo's; "
          f"gordo_fleet_health_machines {health} = the process's {len(summaries)} ledgers' {ledger_machines} machines; "
          f"gordo_store_revision_bytes {exposed} = revision_stats(); gordo_device_memory_bytes {memory}; {card}")


def metrics_pair(app, base, names, card):
    """The request path's cost of metrics: a warm-up pass, then one pass
    with the app's metrics on and one with them off, of METRICS_AB anomaly
    requests each, walltimes printed; and ``observe`` alone, timed on a
    registry of its own."""
    from gordo_tpu_torch.server.prometheus.metrics import GordoServerPrometheusMetrics
    from gordo_tpu_torch.server.prometheus.registry import CollectorRegistry

    frames = [request_frame(950 + i, rows=SLO_FRAME_ROWS) for i in range(METRICS_AB)]
    metrics, walls = app.prometheus_metrics, {}
    try:
        for label in ("warm-up", "on", "off"):
            app.prometheus_metrics = None if label == "off" else metrics
            t0 = time.perf_counter()
            for i, frame in enumerate(frames):
                status, _, _, _ = http_request(f"{base}/{names[i % len(names)]}/anomaly/prediction", "POST",
                                               {"X": frame, "y": frame})
                check(status == 200, f"metrics {label}: {status}")
            walls[label] = time.perf_counter() - t0
    finally:
        app.prometheus_metrics = metrics
    request, response = dispatched(app, names[0])
    alone = GordoServerPrometheusMetrics(project="smoke", registry=CollectorRegistry())
    calls = 20000
    t0 = time.perf_counter()
    for _ in range(calls):
        alone.observe(request, response, 0.01)
    observe_us = (time.perf_counter() - t0) / calls * 1e6
    phase("metrics", f"[slo] {METRICS_AB} anomaly requests of {SLO_FRAME_ROWS} rows after a warm-up pass "
          f"({walls['warm-up']:.3f} s): metrics on {walls['on']:.3f} s, off {walls['off']:.3f} s (one pair, not "
          f"gated); observe() alone {observe_us:.2f} us a request ({len(response.stage_durations)} stages, host "
          f"clock); {card}")


def dispatched(app, name):
    """One anomaly request through ``app.dispatch``: ``(request, response)``
    with the stages it recorded."""
    import io

    from gordo_tpu_torch.server.app import Request

    frame = request_frame(990, rows=SLO_FRAME_ROWS)
    body = json.dumps({"X": frame, "y": frame}).encode()
    request = Request({"REQUEST_METHOD": "POST", "PATH_INFO": f"/gordo/v0/smoke/{name}/anomaly/prediction",
                       "CONTENT_LENGTH": str(len(body)), "CONTENT_TYPE": "application/json",
                       "wsgi.input": io.BytesIO(body)})
    response = app.dispatch(request)
    check(response.status == 200 and response.stage_durations, f"dispatch answered {response.status}")
    return request, response


def slo_phase(base, names, collection, work_dir, traced, cpu_app, card):
    """The rollups, the SLO engine and trace analysis over what
    ``[observability]`` exported (``traced``), then the SLO drill on a card
    app over a copy of the collection (see the module docstring), its clean
    answers held to ``cpu_app``'s. Returns the phase's K1 and K2 launches."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.telemetry import SERVE_TRACE_FILE, aggregate, slo, trace_analysis
    from gordo_tpu_torch.telemetry import serving as serve_trace

    # the drill's clean requests and its fleet request, answered first by the CPU app (nothing is exported yet)
    clean, broken = names[:4], names[-1]
    clean_frames = [request_frame(700 + i, rows=SLO_FRAME_ROWS) for i in range(len(clean))]
    fleet = {n: request_frame(760 + i, rows=SLO_FRAME_ROWS) for i, n in enumerate(clean)}
    expected = [wsgi_post(cpu_app, f"/gordo/v0/smoke/{n}/anomaly/prediction", {"X": frame, "y": frame})
                for n, frame in zip(clean, clean_frames)]
    expected.append(wsgi_post(cpu_app, "/gordo/v0/smoke/prediction/fleet", {"X": fleet}))
    check(all(status == 200 for status, _ in expected), "the CPU app did not answer the drill's requests")

    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    directory, sent = traced["dir"], traced["sent"]
    requests, errors = sum(sent.values()), sum(n for (_, status), n in sent.items() if status >= 500)

    # trace: the command in a process of its own, over the traced pass's file
    code, out, err, seconds = run_command(["trace", directory, "--as-json"])
    check(code == 0, f"trace exited {code}: {err[-2000:]}")
    doc = json.loads(out)
    breakdown = doc["request_breakdown"]
    spans = list(trace_analysis.read_traces(aggregate.sink_bases(directory, SERVE_TRACE_FILE)))
    by_route = collections.Counter((s["attributes"]["http.route"], s["attributes"]["http.status_code"])
                                   for s in spans if s["name"] == "request")
    check(breakdown["requests"] == requests and by_route == sent,
          f"trace counts {breakdown['requests']} requests, {dict(by_route)}; [observability] sent {dict(sent)}")
    check(breakdown["attribution_coverage"] >= 0.9, f"attribution coverage {breakdown['attribution_coverage']}")
    batch_spans = doc["span_summary"].get("serve_batch", {}).get("count", 0)
    check(batch_spans == traced["batches"], f"{batch_spans} serve_batch spans, {traced['batches']} engine batches")
    phase("slo", f"trace --as-json (a process of its own) in {seconds:.2f} s: {breakdown['requests']} requests, "
          + ", ".join(f"{route} {status} x{n}" for (route, status), n in sorted(by_route.items()))
          + f", as [observability] sent them; stage p50 "
          + ", ".join(f"{name} {d['p50_ms']}" for name, d in breakdown["stages"].items())
          + f" ms; attribution coverage {breakdown['attribution_coverage']:.1%} (bar 90%); "
          f"{traced['batches']} serve_batch spans = the engine's batches")

    # the rollups: everything sent, read once; a second pass reads no byte
    store = aggregate.RollupStore(directory)
    trace_bytes = sum(os.path.getsize(path) for _, path in aggregate.discover_sinks(directory))
    read = []
    for _ in range(2):
        t0 = time.perf_counter()
        summary = store.aggregate()
        with open(store.state_path) as f:
            offsets = sum(entry["offset"] for entry in json.load(f)["files"].values())
        read.append((time.perf_counter() - t0, offsets - sum(r[1] for r in read), summary["spans_read"]))
    rollup = aggregate.summarize_rollup(store.merged())
    stream = rollup["stream"]
    check(read[0][1] == trace_bytes and read[0][2] == len(spans), f"first pass read {read[0]}, trace "
          f"{trace_bytes} bytes and {len(spans)} spans")
    check(read[1][1:] == (0, 0), f"the second pass read {read[1][1]} bytes, {read[1][2]} spans")
    check(rollup["requests"] == requests and rollup["errors"] == errors and rollup["spans"] == len(spans),
          f"rollups hold {rollup['requests']} requests, {rollup['errors']} errors, {rollup['spans']} spans")
    check(stream["rows_in"] == stream["rows_scored"] == traced["stream_rows"]
          and stream["rows_failed"] == stream["rows_shed"] == 0, f"rollups' stream rows {stream}, "
          f"{traced['stream_rows']} ingested")
    phase("slo", f"rollups of {trace_bytes} bytes ({len(spans)} spans): aggregate {read[0][0] * 1e3:.1f} ms "
          f"reading {read[0][1]} bytes, again {read[1][0] * 1e3:.1f} ms reading {read[1][1]}; {rollup['requests']} "
          f"requests, {rollup['errors']} errors, stream rows in {stream['rows_in']} scored {stream['rows_scored']}, "
          f"latency p50 {rollup['latency_p50_ms']} p95 {rollup['latency_p95_ms']} ms (bucket interpolated)")

    saved = {k: os.environ.get(k) for k in ("GORDO_TPU_TELEMETRY_DIR", "GORDO_TPU_TRACE_SAMPLE_RATE",
                                             "GORDO_TPU_SLO_SCRAPE_REFRESH", "GORDO_TPU_TELEMETRY")}
    os.environ.pop("GORDO_TPU_TELEMETRY", None)
    # the commands leave a status the route serves for the whole drill (the default refresh is 60 s)
    os.environ.update(GORDO_TPU_TELEMETRY_DIR=directory, GORDO_TPU_TRACE_SAMPLE_RATE="1",
                      GORDO_TPU_SLO_SCRAPE_REFRESH="3600")
    stop = drill_app = stop_metrics = None
    try:
        # /slo of [observability]'s card app over its traffic: a second reader resumes from the state file
        status, body, _, ms = http_request(base + "/slo", "GET")
        doc = json.loads(body)
        check(status == 200 and doc["ok"] and doc["recent"]["requests"] == requests
              and doc["aggregation"]["spans_read"] == 0, f"/slo answered {status}: {doc.get('recent')}, "
              f"{doc.get('aggregation')}")
        phase("slo", f"GET /slo on the card app in {ms:.1f} ms: " + ", ".join(
            f"{s['name']} budget {s['budget']['remaining_ratio']:.4f} ({s['requests']} events)" for s in doc["slos"])
            + f"; {doc['firing']} firing; new spans read 0")

        # the drill: a card app over a copy of the collection, its own telemetry directory and objectives,
        # with metrics on; the status of [observability]'s directory is dropped, so each SLO has one series
        slo.reset_statuses()
        drill_root = tempfile.mkdtemp(prefix="slo-drill-", dir=work_dir)
        served = os.path.join(drill_root, DRILL_REVISION)
        shutil.copytree(collection, served, ignore=shutil.ignore_patterns("fleet_health*", "*_trace*"))
        telemetry_dir = os.path.join(drill_root, "telemetry")
        os.makedirs(telemetry_dir)
        with open(os.path.join(telemetry_dir, "slos.toml"), "w") as f:
            f.write(SLO_DRILL)
        os.environ["GORDO_TPU_TELEMETRY_DIR"] = telemetry_dir
        os.environ["ENABLE_PROMETHEUS"] = "true"
        try:
            drill_app = build_app(served, device="cuda")
        finally:
            del os.environ["ENABLE_PROMETHEUS"]
        check(drill_app.prometheus_metrics is not None, "ENABLE_PROMETHEUS=true built an app without metrics")
        check(os.path.normpath(telemetry_dir) in slo._watched, "build_app did not watch its telemetry directory")
        drill_base, stop = serving(drill_app)
        metrics_url, stop_metrics = serving_metrics()
        before, _, _ = scrape(metrics_url)
        t_drill = time.perf_counter()
        sent_by = collections.Counter()  # (method, status) of every request to the drill app

        def drill_request(path, method="GET", payload=None):
            status, body, _, _ = http_request(drill_base + path, method, payload)
            sent_by[(method, status)] += 1
            return status, body

        def send(count, name_of, expected, seed):
            for i in range(count):
                frame = request_frame(seed + i, rows=SLO_FRAME_ROWS)
                status, body = drill_request(f"/{name_of(i)}/anomaly/prediction", "POST", {"X": frame, "y": frame})
                check(status == expected, f"{name_of(i)}: {status}, not {expected}: {body[:300]}")
            serve_trace.serve_recorder().flush()

        def alerts(expected_code, expected_state):
            code, doc = cli_json("slo", "check", telemetry_dir)
            states = {a["id"]: a["state"] for a in doc["alerts"]}
            check(code == expected_code and set(states.values()) == {expected_state},
                  f"slo check exited {code} with {states}, not {expected_code} with {expected_state}")
            return f"check {code} ({expected_state}, fast burn {doc['alerts'][0]['burn_rate']}x)"

        def agree(expected_state):
            """``slo status --as-json``, then ``/slo``, ``/fleet-health``'s section
            and ``fleet-status`` (the status just evaluated, served from the cache)."""
            code, status_doc = cli_json("slo", "status", telemetry_dir)
            check(code == 0 and {a["state"] for a in status_doc["alerts"]} == {expected_state},
                  f"slo status exited {code}: {status_doc['alerts']}")
            section = {"firing": status_doc["firing"], "pending": status_doc["pending"], "ok": status_doc["ok"],
                       "alerts": status_doc["alerts"], "evaluated_at": status_doc["generated_at"],
                       "budgets": {s["name"]: s["budget"]["remaining_ratio"] for s in status_doc["slos"]}}
            status, body = drill_request("/slo")
            route = json.loads(body)
            route.pop("revision", None)
            check(status == 200 and route == status_doc, "/slo differs from slo status --as-json")
            status, body = drill_request("/fleet-health")
            check(status == 200 and json.loads(body)["slo"] == section, "/fleet-health's slo section differs")
            code, fleet = cli_json("fleet-status", served)
            check(code == 0 and fleet["slo"] == section, "fleet-status's slo section differs")
            budget = status_doc["slos"][0]
            return (f"status, /slo, /fleet-health, fleet-status agree: {expected_state}, budget remaining "
                    f"{budget['budget']['remaining_ratio']:.4f} of {budget['requests']} requests")

        # the clean stage: each answer held to the CPU app's (numbers within RTOL/ATOL)
        max_diff = 0.0
        for (path, payload), (_, cpu_body) in zip(
                [(f"/{n}/anomaly/prediction", {"X": frame, "y": frame}) for n, frame in zip(clean, clean_frames)]
                + [("/prediction/fleet", {"X": fleet})], expected):
            status, body = drill_request(path, "POST", payload)
            check(status == 200, f"the drill's {path} answered {status}: {body[:300]}")
            max_diff = max(max_diff, same_json(cpu_body["data"], json.loads(body)["data"]))
        serve_trace.serve_recorder().flush()
        phase("slo", f"drill, clean ({len(clean)} anomaly requests and a fleet request of {SLO_FRAME_ROWS} rows, "
              f"max abs {max_diff:.3e} from the CPU app's answers, rtol {RTOL}, atol {ATOL}): "
              f"{alerts(0, 'inactive')}; {agree('inactive')}")
        # the burst: a model whose artifact is broken on disk answers 500
        artifact = os.path.join(served, broken, "model.pkl")
        with open(artifact, "rb") as f:
            original = f.read()
        with open(artifact, "wb") as f:
            f.write(b"not a pickle")
        drill_app.store.invalidate(served)
        send(SLO_BURST, lambda i: broken, 500, 800)
        phase("slo", f"drill, burst ({SLO_BURST} requests to {broken}, its model.pkl broken: 500): "
              f"{alerts(0, 'pending')}, {alerts(1, 'firing')}; {agree('firing')}")
        with open(artifact, "wb") as f:
            f.write(original)
        drill_app.store.invalidate(served)
        send(SLO_RECOVERY, lambda i: clean[i % len(clean)], 200, 900)
        phase("slo", f"drill, recovery ({SLO_RECOVERY} clean requests): {alerts(0, 'resolved')}; "
              f"{agree('inactive')}; the drill took {time.perf_counter() - t_drill:.2f} s")
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
        after, scrape_ms, scrape_bytes = scrape(metrics_url)
        check({"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches} == launches
              == {"K1": len(clean) + SLO_RECOVERY, "K2": 1}, f"the drill launched {launches}, the scrape "
              f"{fleet_feedforward.launches - launches['K1']} more K1")
        phase("slo", f"K1 launches {launches['K1']}, K2 launches {launches['K2']} (the drill's anomaly requests "
              f"and its fleet request; the scrapes launched none); {card}")
        # the ledger counts the clean machines: a model that never loaded is no machine of it
        drill_metrics(before, after, sent_by, drill_app, served, len(clean), telemetry_dir, scrape_ms,
                      scrape_bytes, card)
        metrics_pair(drill_app, drill_base, clean, card)
        return launches
    finally:
        if stop is not None:
            stop()
        if stop_metrics is not None:
            stop_metrics()
        if drill_app is not None:
            drill_app.shutdown()
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        serve_trace.reset_serve_recorder()
        slo.reset_statuses()


def engine_body(route, frame):
    return {"X": frame, "y": frame} if route.startswith("anomaly") else {"X": frame}


def burst(base, requests):
    """``requests`` (``(path, body)``) posted at once, one thread each:
    ``([(status, body bytes, host ms)], wall seconds)``."""
    answers = [None] * len(requests)

    def hit(i):
        status, body, _, ms = http_request(base + requests[i][0], "POST", requests[i][1])
        answers[i] = (status, body, ms)

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(requests))]
    t0 = time.perf_counter()
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    wall = time.perf_counter() - t0
    check(all(a is not None for a in answers), "a client of the burst never returned")
    return answers, wall


def serving(app):
    """``app`` behind a threaded socket server: ``(base url, stop)``."""
    from gordo_tpu_torch.server.app import make_wsgi_server

    server = make_wsgi_server(app, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        check(not thread.is_alive(), "server thread did not stop")

    return f"http://127.0.0.1:{server.server_port}/gordo/v0/smoke", stop


SAMPLE_LINE = re.compile(r"^([a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(.*)\})? (\S+)$")
LABEL_PAIR = re.compile(r'([a-zA-Z_][a-zA-Z0-9_]*)="((?:[^"\\]|\\.)*)"')


def scrape_samples(text):
    """A Prometheus exposition's samples: ``{(name, sorted label pairs):
    value}``."""
    samples = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        found = SAMPLE_LINE.match(line)
        check(found is not None, f"an exposition line does not parse: {line!r}")
        name, labels, value = found.groups()
        pairs = tuple(sorted((k, re.sub(r"\\(.)", lambda m: "\n" if m.group(1) == "n" else m.group(1), v))
                             for k, v in LABEL_PAIR.findall(labels or "")))
        samples[(name, pairs)] = float(value)
    return samples


def registry_samples():
    """The process registry's samples, rendered as a scrape renders them."""
    from gordo_tpu_torch.server.prometheus.registry import REGISTRY, generate_latest

    return scrape_samples(generate_latest(REGISTRY).decode())


def summed(samples, name, **labels):
    """The sum of ``name``'s samples whose labels include ``labels``."""
    return sum(value for (n, pairs), value in samples.items()
               if n == name and all(dict(pairs).get(k) == v for k, v in labels.items()))


def label_values(samples, name, label, **labels):
    """The values of ``label`` among ``name``'s samples matching ``labels``."""
    return {dict(pairs)[label] for (n, pairs) in samples
            if n == name and all(dict(pairs).get(k) == v for k, v in labels.items())}


def engine_app(collection, **config):
    """A card app on ``collection`` with an engine of ``config`` (defaults
    otherwise), its models loaded and its warmup (parity gates and one
    forward a bucket) run to the end: ``(app, warmup ms)``."""
    from gordo_tpu_torch.serve.engine import ServeConfig
    from gordo_tpu_torch.server import build_app

    app = build_app(collection, device="cuda", serve_config=ServeConfig(**config))
    check(len(app.store.fleet().warm()) == SERVED_MACHINES + WIDE_MACHINES, "not every model loaded")
    t0 = time.perf_counter()
    app.start_warmup().join(timeout=600)
    return app, (time.perf_counter() - t0) * 1e3


def captured_engine_batches():
    """Until ``restore()``: the largest coalesced batch (two members or
    more; the unbatched path scores one a call) sent to K1 at each input
    width, as a K1 case on the card (the bucket, the batch's indices, the
    bucket's ingest plan and the stacked rows): ``(batches, restore)``."""
    from gordo_tpu_torch.server import fleet_store

    batches, launch = {}, fleet_store.fleet_feedforward

    def captured(spec, bucket, X, indices=None, ingest=None, **kwargs):
        width, members = X.shape[-1], X.shape[0]
        if members > 1 and (width not in batches or members > batches[width]["X"].shape[0]):
            batches[width] = dict(spec=spec, bucket=bucket, X=X, indices=[int(i) for i in indices], ingest=ingest)
        return launch(spec, bucket, X, indices=indices, ingest=ingest, **kwargs)

    def restore():
        fleet_store.fleet_feedforward = launch

    fleet_store.fleet_feedforward = captured
    return batches, restore


def engine_case_name(case):
    M, B, width = case["X"].shape
    members = case["bucket"]["out"]["W"].shape[0]
    return (f"coalesced engine batch: hourglass{width} gather M={M} of {members} B={B}"
            + (" +ingest" if case["ingest"] is not None else ""))


def verdicts(data):
    """Each row's anomaly verdict: its total-anomaly-confidence above 1."""
    return [v > 1.0 for v in data["total-anomaly-confidence"]["total-anomaly-confidence"].values()]


def metered_round(collection, requests):
    """A burst of ``requests`` at an engine app with every knob at its
    default and metrics on (``ENABLE_PROMETHEUS=true``), then its
    ``[metrics]``: the batch-size histogram grew by the engine's batches
    (count) and coalesced requests (sum), the shed counter by the engine's
    own shed counts. Returns the app (shut down), the answers and the
    burst's wall seconds."""
    os.environ["ENABLE_PROMETHEUS"] = "true"
    try:
        app, _ = engine_app(collection)
    finally:
        del os.environ["ENABLE_PROMETHEUS"]
    check(app.engine.metrics is not None, "ENABLE_PROMETHEUS=true built an engine without its metrics")
    before = registry_samples()
    base, stop = serving(app)
    try:
        answers, wall = burst(base, requests)
    finally:
        stop()
        app.shutdown()
    after = registry_samples()
    stats = app.engine.stats()

    def grown(name, **labels):
        return summed(after, name, **labels) - summed(before, name, **labels)

    batch_count, batch_sum = grown("gordo_server_batch_size_count", project=app.project), grown(
        "gordo_server_batch_size_sum", project=app.project)
    sheds = {reason: grown("gordo_server_batch_shed_total", reason=reason)
             for reason in label_values(after, "gordo_server_batch_shed_total", "reason")}
    check(batch_count == stats["batches"] and batch_sum == stats["coalesced"],
          f"gordo_server_batch_size grew by {batch_count} batches of {batch_sum} requests, the engine ran "
          f"{stats['batches']} of {stats['coalesced']}")
    # the engine's shed_deadline also counts a waiter's own timeout, which the batcher never shed
    shed_stats = {reason: stats.get(f"shed_{reason}", 0) for reason in ("queue_full", "deadline", "runner_error")}
    check(sheds.get("queue_full", 0) == shed_stats["queue_full"]
          and sheds.get("runner_error", 0) == shed_stats["runner_error"]
          and sheds.get("deadline", 0) <= shed_stats["deadline"],
          f"gordo_server_batch_shed_total grew by {sheds}, the engine counted {shed_stats}")
    phase("metrics", f"[engine] the default-knob round with metrics on: gordo_server_batch_size count "
          f"{batch_count:.0f} = the engine's batches, sum {batch_sum:.0f} = its coalesced requests; "
          f"gordo_server_batch_shed_total grew by {sheds}, the engine counted {shed_stats}; "
          f"queue depth now {summed(after, 'gordo_server_batch_queue_depth', project=app.project):.0f}")
    return app, answers, wall


def engine_phase(collection, names, wide_names, cpu_app, plain_app, card):
    """The micro-batching engine on the card (see the module docstring).
    Returns the K1 launches of its main path, narrow and wide, and the
    largest batch it launched at each width."""
    import numpy as np

    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward

    t_phase = time.perf_counter()
    parts, t_part = {}, [t_phase]  # the phase's seconds by part

    def part(name):
        now = time.perf_counter()
        parts[name] = parts.get(name, 0.0) + now - t_part[0]
        t_part[0] = now

    # the apps below warm up in the foreground, timed, instead of in a thread at build
    os.environ["GORDO_TPU_SERVE_WARMUP"] = "0"
    os.environ["GORDO_TPU_BREAKER_THRESHOLD"] = "1"  # the poison drill's breaker opens on its first failure
    on_app, warm_ms = engine_app(collection, deadline_ms=ENGINE_DEADLINE_MS)
    engine = on_app.engine
    check(engine.stats()["warmup_programs"] == 2, f"warmup ran {engine.stats()['warmup_programs']} forwards, not 2")
    phase("engine", f"engine knobs: max_size {engine.config.max_size}, max_delay {engine.config.max_delay_s * 1e3} ms, "
          f"deadline {engine.config.deadline_s * 1e3} ms, row ladder {engine.config.row_ladder}; warmup (one forward "
          f"a bucket, the kernel library loaded) {warm_ms:.1f} ms")
    bodies = {(route, n): engine_body(route, own_frame(n, 20)) for route in ENGINE_ROUTES
              for n in names[:max(ENGINE_CLIENTS)]}
    t0 = time.perf_counter()
    # the CPU app answers as Arrow, read back into the JSON route's tree: the same numbers, less host time
    expected = {key: wsgi_arrow(cpu_app, f"/gordo/v0/smoke/{key[1]}/{key[0]}", body) for key, body in bodies.items()}
    check(all(status == 200 for status, _ in expected.values()), "the CPU app refused a request")
    phase("engine", f"{len(expected)} CPU-app answers (Arrow) to hold the card's to in "
          f"{time.perf_counter() - t0:.1f} s")
    part("engine app and CPU answers")

    launches = {"narrow": 0, "wide": 0}
    (on_base, stop_on), (off_base, stop_off) = serving(on_app), serving(plain_app)
    captured, restore = captured_engine_batches()
    try:
        for clients in ENGINE_CLIENTS:
            for route in ENGINE_ROUTES:
                requests = [(f"/{n}/{route}", bodies[(route, n)]) for n in names[:clients]]
                for label, base in (("off", off_base), ("on", on_base)):
                    before = engine.stats()
                    fleet_feedforward.launches = 0
                    answers, wall = burst(base, requests)
                    k1 = fleet_feedforward.launches
                    after = engine.stats()
                    max_diff = 0.0
                    for (path, _), (status, body, _) in zip(requests, answers):
                        check(status == 200, f"batching {label}: {path} answered {status}")
                        max_diff = max(max_diff, same_json(expected[(route, path.split("/")[1])][1]["data"],
                                                           json.loads(body)["data"]))
                    ms = np.asarray([a[2] for a in answers])
                    line = (f"C={clients} /{route} batching {label}: {clients} requests in {wall:.3f} s "
                            f"({clients / wall:.2f} requests a second), p50 {np.percentile(ms, 50):.1f} ms, "
                            f"p99 {np.percentile(ms, 99):.1f} ms, K1 launches {k1} "
                            f"({k1 / clients:.3f} a request)")
                    if label == "on":
                        batches = after["batches"] - before["batches"]
                        coalesced = after["coalesced"] - before["coalesced"]
                        check(coalesced == clients and batches >= 1, f"the engine scored {coalesced} of {clients}")
                        check(k1 == after["launches"] - before["launches"], "K1 launches the engine did not count")
                        if clients == max(ENGINE_CLIENTS):
                            check(k1 < clients, f"{clients} clients took {k1} K1 launches, not fewer")
                        launches["narrow"] += k1
                        line += f", engine batches {batches}, coalesced {coalesced}, mean batch {coalesced / batches:.2f}"
                    else:
                        check(k1 == clients, f"batching off: {k1} K1 launches for {clients} requests")
                    phase("engine", f"{line}; max abs diff vs the CPU app {max_diff:.3e}; {card}")

        part("latency rounds")
        # the 40-tag bucket: the wide kernel
        requests = [(f"/{n}/anomaly/prediction", engine_body("anomaly", own_frame(n, WIDE_TAGS))) for n in wide_names]
        before = engine.stats()
        fleet_feedforward.launches = 0
        answers, wall = burst(on_base, requests)
        k1, after = fleet_feedforward.launches, engine.stats()
        check(k1 >= 1, "the 40-tag round never launched K1")
        launches["wide"] = k1
        max_diff = 0.0
        for (path, body), (status, got, _) in zip(requests, answers):
            check(status == 200, f"{path} answered {status}")
            max_diff = max(max_diff, same_json(wsgi_post(cpu_app, "/gordo/v0/smoke" + path, body)[1]["data"],
                                               json.loads(got)["data"]))
        phase("engine", f"C={len(requests)} 40-tag /anomaly/prediction batching on (the wide kernel): {wall:.3f} s, "
              f"K1 launches {k1}, engine batches {after['batches'] - before['batches']}, coalesced "
              f"{after['coalesced'] - before['coalesced']}; max abs diff vs the CPU app {max_diff:.3e}; {card}")

        part("40-tag round")
        # the poison drill: the member's riders answer, it answers 500, then 503 from its open breaker
        os.environ["GORDO_TPU_FAULTS"] = f"serve_member_poison:*{ENGINE_POISON}:times=inf"
        try:
            requests = [(f"/{n}/anomaly/prediction", bodies[("anomaly/prediction", n)]) for n in names[:8]]
            answers, _ = burst(on_base, requests)
            statuses = {path.split("/")[1]: status for (path, _), (status, _, _) in zip(requests, answers)}
            check(statuses.pop(ENGINE_POISON) == 500, f"the poisoned member answered {answers}")
            check(set(statuses.values()) == {200}, f"its riders answered {statuses}")
            poisoned = next(r for r in requests if r[0].split("/")[1] == ENGINE_POISON)
            status, _, _, _ = http_request(on_base + poisoned[0], "POST", poisoned[1])
            check(status == 503, f"the quarantined member answered {status}, not 503")
        finally:
            del os.environ["GORDO_TPU_FAULTS"]
        stats = engine.stats()
        part("poison drill")
        phase("engine", f"poisoned {ENGINE_POISON}: 7 riders 200, it 500 then 503; nonfinite_outputs "
              f"{stats['nonfinite_outputs']}, members_isolated {stats['members_isolated']}, breaker_trips "
              f"{stats['breaker_trips']}, breaker_rejects {stats['breaker_rejects']}")
    finally:
        restore()
        stop_on()
        stop_off()
        on_app.shutdown()
    check(sorted(captured) == sorted(ENGINE_FULL_CASES), f"coalesced K1 batches at widths {sorted(captured)}")

    # every knob at its default, the 2000 ms deadline included: how many of 16 clients answer 504; metrics on
    requests = [(f"/{n}/anomaly/prediction", bodies[("anomaly/prediction", n)])
                for n in names[:max(ENGINE_CLIENTS)]]
    default_app, answers, wall = metered_round(collection, requests)
    part("default-knob round")
    stats = default_app.engine.stats()
    statuses = [a[0] for a in answers]
    check(set(statuses) <= {200, 504}, f"the default engine answered {sorted(set(statuses))}")
    max_diff = 0.0
    for (path, _), (status, body, _) in zip(requests, answers):
        if status == 200:
            max_diff = max(max_diff, same_json(expected[("anomaly/prediction", path.split("/")[1])][1]["data"],
                                               json.loads(body)["data"]))
    ms = np.asarray([a[2] for a in answers])
    phase("engine", f"C={len(requests)} /anomaly/prediction at the default knobs (deadline "
          f"{default_app.engine.config.deadline_s * 1e3} ms): {statuses.count(200)} answered 200, "
          f"{statuses.count(504)} answered 504 (shed_deadline {stats['shed_deadline']}), in {wall:.3f} s, p50 "
          f"{np.percentile(ms, 50):.1f} ms, p99 {np.percentile(ms, 99):.1f} ms (every answer), engine batches "
          f"{stats['batches']}, coalesced {stats['coalesced']}; the 200s' max abs diff vs the CPU app {max_diff:.3e}; "
          f"{card}")

    # bf16 and int8: the parity gate, then 8 clients; each answer's verdicts against f32's
    for prec in ENGINE_PRECISIONS:
        app, warm_ms = engine_app(collection, serve_precision=prec, deadline_ms=ENGINE_DEADLINE_MS)
        fleet = app.store.fleet()
        for name in (names[0], wide_names[0]):
            report = fleet.precision_state(fleet.loaded_specs()[name], prec)
            check(report is not None and report["passed"], f"the {prec} gate did not pass: {report}")
            phase("engine", f"{prec} gate of the {fleet.loaded_specs()[name].n_features}-tag bucket: passed, verdict "
                  f"agreement min {report['agreement_min']} over {len(report['members'])} members x "
                  f"{report['probe_rows']} probe rows (warmup {warm_ms:.1f} ms)")
        base, stop = serving(app)
        try:
            requests = [(f"/{n}/anomaly/prediction", bodies[("anomaly/prediction", n)]) for n in names[:8]]
            fleet_feedforward.launches = 0
            answers, wall = burst(base, requests)
            check(fleet_feedforward.launches == 0, f"{prec} requests launched K1")
        finally:
            stop()
            app.shutdown()
        agree = rows = 0
        for (path, _), (status, body, _) in zip(requests, answers):
            check(status == 200, f"{prec}: {path} answered {status}")
            ours, f32 = verdicts(json.loads(body)["data"]), verdicts(expected[("anomaly/prediction",
                                                                              path.split("/")[1])][1]["data"])
            agree += sum(a == b for a, b in zip(ours, f32))
            rows += len(f32)
        stats = app.engine.stats()
        check(stats["precision"]["coalesced"] == {prec: 8}, f"{prec} coalesced {stats['precision']['coalesced']}")
        check(agree / rows >= 0.98, f"{prec} verdicts agree with f32 on {agree} of {rows} rows")
        phase("engine", f"C=8 /anomaly/prediction at {prec}: {wall:.3f} s, coalesced {stats['precision']['coalesced']}"
              f" in {stats['batches']} batches, verdicts equal to f32's on {agree} of {rows} rows "
              f"({agree / rows:.4%}); {card}")
        part(f"{prec} round")
    for name in ("GORDO_TPU_SERVE_WARMUP", "GORDO_TPU_BREAKER_THRESHOLD"):
        del os.environ[name]
    phase("engine", f"the phase took {time.perf_counter() - t_phase:.1f} s: "
          + ", ".join(f"{name} {seconds:.1f}" for name, seconds in parts.items()))
    return launches, captured


def reduced_ms(case, prec):
    """The bf16 or int8 gather forward at ``case``'s shape (indices on the card)."""
    import torch

    from gordo_tpu_torch.serve import precision
    from gordo_tpu_torch.server.fleet_store import fleet_forward_gather

    cast = precision.cast_bucket_params(case["bucket"], prec)
    indices = torch.as_tensor(case["indices"], device="cuda")
    return cuda_ms(lambda: fleet_forward_gather(case["spec"], cast, indices, case["X"], ingest=case["ingest"],
                                                precision=prec))


# -- [definitions]: every model definition the JAX package reads ------------------

#: the [definitions] collection, one group a kind of definition: (prefix, machines). Every machine
#: has 20 tags and TRAIN_ROWS rows
DEFINITION_GROUPS = (("raw", 8), ("standard", 8), ("maxabs", 4), ("nonaffine", 4), ("callbacks", 2))
#: each group's sensor_data seeds start at DEFINITIONS_SEED + 100 x its index
DEFINITIONS_SEED = 900
#: machines built again on the CPU, one of each kind
DEFINITIONS_CPU_CHECK = ("raw-000", "standard-000", "maxabs-000", "nonaffine-000", "callbacks-000")
#: the callbacks block's epochs here (it says 30)
CALLBACK_EPOCHS = 10
#: the card's [definitions] fleet build against the CPU's (params, thresholds, CV scores).
#: ``scripts/build_tolerance.py definitions`` on an H100 (sound / TF32 on / one row swapped):
#: raw, standard, maxabs params 6.3e-7 / 6.3e-4 / 4.0e-4, thresholds 4.0e-7 / 8.4e-6 / 6.5e-3, CV
#: scores 2.6e-6 / 2.2e-5 / 8.8e-3; the non-affine machines params 2.59e-6 (the same to the last
#: digit in every sound build) / 2.59e-6 (TF32 leaves their fits as they were) / 4.5e-6,
#: thresholds 1.0e-7 / 1.0e-7 / 9.0e-6, CV scores 0 (their clipping scoring scaler clips every
#: fold's prediction alike). The port's CPU build and the JAX package's of the same machines
#: differ by 1.0e-6 to 1.4e-6 in params: these 5-epoch fits towards raw targets carry f32 rounding
#: further than [train]'s, so BUILD_LIMITS' 1e-6 is below their sound spread; the limits of the
#: [lstm] and [sequential] builds are kept, and a swapped row still fails the thresholds.
DEFINITIONS_BUILD_LIMITS = (1e-5, 3e-6, 2e-5)
#: the [definitions] shapes that K1 and K2 are held to their plain versions at and timed
DEFINITION_CASES = {
    "raw": "raw spec CV fold scoring: 20-16-4-20 tanh/tanh/linear M=24 B=500",
    "standard": "StandardScaler bucket: hourglass20 gather M=1 +ingest",
    "host": "host-transformed bucket: hourglass20-to-19 gather M=1, no prologue",
}
DEFINITION_K2 = "K2 host-transformed bucket: hourglass20-to-19 M=4 B=1008, y the raw rows"


def definition_models():
    """``{prefix: (definition, evaluation)}`` of DEFINITION_GROUPS, read from
    the examples where they come from:

    - ``raw``: ``examples/model-configuration.yaml``'s ``raw_spec`` block as
      written (16-4-20, tanh, tanh, linear; ``mse``, ``adam``), the base
      estimator of a ``DiffBasedAnomalyDetector`` so the anomaly route
      answers it; no pipeline, so its readings are at unit scale;
    - ``standard``: a ``StandardScaler`` pipeline ahead of the hourglass, a
      ``RobustScaler`` error scaler, a ``StandardScaler`` scoring scaler;
    - ``maxabs``: a ``MaxAbsScaler`` pipeline ahead of a 2-layer hourglass
      (a bucket of its own), a ``MaxAbsScaler`` error scaler and a
      ``RobustScaler`` scoring scaler;
    - ``nonaffine``: ``InfImputer`` -> ``FunctionTransformer(multiply_by,
      factor 2)`` -> ``MinMaxScaler(clip=True)``, ``inf`` / ``-inf`` cells in
      its last tag, which is an input only (the other 19 are the targets:
      an infinite target makes every loss infinite); a clipping
      ``MinMaxScaler`` scoring scaler;
    - ``callbacks``: ``examples/config-influx-callbacks.yaml``'s model block
      (``EarlyStopping``, ``ReduceLROnPlateau``, ``TerminateOnNaN``),
      CALLBACK_EPOCHS epochs; its data provider is the CSV one.
    """
    from gordo_tpu_torch.utils.yaml_lite import safe_load

    with open(os.path.join(HERE, "examples", "model-configuration.yaml")) as f:
        raw = safe_load(f.read())["raw_spec"]
    with open(os.path.join(HERE, "examples", "config-influx-callbacks.yaml")) as f:
        callbacks = safe_load(f.read())["globals"]["model"]
    steps = callbacks[DETECTOR_PATH]["base_estimator"]["sklearn.pipeline.Pipeline"]["steps"]
    steps[-1]["gordo_tpu.models.estimators.JaxAutoEncoder"]["epochs"] = CALLBACK_EPOCHS
    hourglass = {"kind": "feedforward_hourglass", "epochs": 5, "batch_size": 32}

    def detector(pipeline, scaler, **estimator):
        estimator = {"gordo_tpu.models.estimators.JaxAutoEncoder": {**hourglass, **estimator}}
        return {DETECTOR_PATH: {"base_estimator": {"sklearn.pipeline.Pipeline": {"steps": [*pipeline, estimator]}},
                                "scaler": scaler}}

    non_affine = [
        "gordo_tpu.models.transformers.imputer.InfImputer",
        {"sklearn.preprocessing.FunctionTransformer": {
            "func": "gordo_tpu.models.transformer_funcs.general.multiply_by", "kw_args": {"factor": 2}}},
        {"sklearn.preprocessing.MinMaxScaler": {"clip": True}},
    ]
    return {
        "raw": ({DETECTOR_PATH: {"base_estimator": raw}}, {}),
        "standard": (detector(["sklearn.preprocessing.StandardScaler"], "sklearn.preprocessing.RobustScaler"),
                     {"scoring_scaler": "sklearn.preprocessing.StandardScaler"}),
        "maxabs": (detector(["sklearn.preprocessing.MaxAbsScaler"], "sklearn.preprocessing.MaxAbsScaler",
                            encoding_layers=2), {"scoring_scaler": "sklearn.preprocessing.RobustScaler"}),
        "nonaffine": (detector(non_affine, "sklearn.preprocessing.StandardScaler"),
                      {"scoring_scaler": {"sklearn.preprocessing.MinMaxScaler": {"clip": True}}}),
        "callbacks": (callbacks, {}),
    }


def definition_rows(name, rows=TRAIN_ROWS):
    """A [definitions] machine's first ``rows`` readings (its seeded
    ``sensor_data``; the raw spec's at unit scale)."""
    prefix, i = name.rsplit("-", 1)
    group = [p for p, _ in DEFINITION_GROUPS].index(prefix)
    values = sensor_data(DEFINITIONS_SEED + 100 * group + int(i), rows, 20)
    return (values - 50.0) / 30.0 if prefix == "raw" else values


def definitions_project(directory):
    """The [definitions] project config (JSON, which the port's YAML reader
    reads) and a CSV a machine; ``{name: rows}`` beside its path. The
    non-affine machines' CSVs hold ``inf`` / ``-inf`` every 97th row of the
    last tag."""
    models = definition_models()
    end = (TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)).isoformat()
    machines, rows = [], {}
    for prefix, count in DEFINITION_GROUPS:
        model, evaluation = models[prefix]
        for i in range(count):
            name = f"{prefix}-{i:03d}"
            values = definition_rows(name)
            tags = tag_list(20)
            dataset = {"data_provider": {"type": "FileDataProvider", "timestamp_column": "time"},
                       "tag_list": tags, "train_start_date": TRAIN_START.isoformat(), "train_end_date": end}
            if prefix == "nonaffine":
                values = values.copy()
                values[5::97, -1] = [float("inf") if k % 2 else float("-inf") for k in range(len(values[5::97]))]
                dataset["target_tag_list"] = tags[:-1]
            dataset["data_provider"]["path"] = write_csv(directory, name, tags, values)
            machines.append({"name": name, "model": model, "evaluation": evaluation, "dataset": dataset})
            rows[name] = values
    config_path = os.path.join(directory, "definitions.json")
    with open(config_path, "w") as f:
        json.dump({"machines": machines}, f, indent=1)
    return config_path, rows


@contextlib.contextmanager
def captured_host_loops():
    """During a build: the learning rate every host-loop fit
    (``StackedFit._fit_host_loop``) ran each epoch at, one list a fit, in
    order."""
    from gordo_tpu_torch.models.callbacks import Callback
    from gordo_tpu_torch.models.training import StackedFit

    fits, loop = [], StackedFit._fit_host_loop

    class Recorder(Callback):
        def __init__(self, lrs):
            self.lrs = lrs

        def on_epoch_end(self, epoch, logs=None):
            self.lrs.append(logs["lr"])
            return False

    def captured(self, params, wtr, wval, batches, validate, callbacks):
        fits.append([])
        return loop(self, params, wtr, wval, batches, validate, [*callbacks, Recorder(fits[-1])])

    StackedFit._fit_host_loop = captured
    try:
        yield fits
    finally:
        StackedFit._fit_host_loop = loop


@contextlib.contextmanager
def captured_serving_launches():
    """While serving: every K1 and K2 call of the store and the engine, as
    ``("K1" | "K2", case)``, its tensors on the card."""
    from gordo_tpu_torch.server import fleet_store

    calls, k1, k2 = [], fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores

    def captured_k1(spec, bucket, X, indices=None, ingest=None, **kwargs):
        calls.append(("K1", dict(spec=spec, bucket=bucket, X=X, ingest=ingest,
                                 indices=None if indices is None else [int(i) for i in indices])))
        return k1(spec, bucket, X, indices=indices, ingest=ingest, **kwargs)

    def captured_k2(spec, bucket, X, y, indices=None, ingest=None, **kwargs):
        calls.append(("K2", dict(spec=spec, bucket=bucket, X=X, y=y, ingest=ingest,
                                 indices=None if indices is None else [int(i) for i in indices])))
        return k2(spec, bucket, X, y, indices, ingest, **kwargs)

    fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores = captured_k1, captured_k2
    try:
        yield calls
    finally:
        fleet_store.fleet_feedforward, fleet_store.fleet_anomaly_scores = k1, k2


def definition_frame(name, y=False):
    """A [definitions] machine's next ROWS rows past its training rows (its
    target tags alone with ``y``), with request_frame's excursion."""
    keys = [(TRAIN_START + timedelta(minutes=10 * (TRAIN_ROWS + r))).isoformat() for r in range(ROWS)]
    values = definition_rows(name, TRAIN_ROWS + ROWS)[TRAIN_ROWS:]
    values[ROWS // 2:ROWS // 2 + 6, 3] += 25.0 if not name.startswith("raw") else 1.0
    tags = tag_list(20)[:-1] if y and name.startswith("nonaffine") else tag_list(20)
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tags)}


def definitions_phase(work_dir, card):
    """``[definitions]``: every kind of definition the port now reads,
    built on the card from a project config and served by the engine.
    Returns the K1/K2 launches of its build and its serving, the shapes
    DEFINITION_CASES and DEFINITION_K2 name as cases on the card, and the
    launches each of those made on this path."""
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.serve.engine import ServeConfig
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    t_phase = time.perf_counter()
    project_dir = os.path.join(work_dir, "definitions")
    directory = os.path.join(project_dir, REVISION)
    os.makedirs(project_dir)
    config_path, rows = definitions_project(project_dir)
    shard = os.path.join(project_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke"))
    counts = dict(DEFINITION_GROUPS)
    sequential = counts["callbacks"]
    fleet_machines = len(rows) - sequential
    with captured_build() as (forwards, fetched), captured_host_loops() as card_lrs:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, directory, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        build_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
    check(len(fetched) == fleet_machines, f"the fleet path planned {len(fetched)} machines, not {fleet_machines}")
    check(len(card_lrs) == 4 * sequential, f"{len(card_lrs)} host-loop fits, not 4 a callbacks machine")
    # one CV forward a fleet spec group (raw, standard, maxabs, nonaffine), one a sequential fold's predict
    want_k1 = 4 + 3 * sequential
    check(build_launches["K1"] == want_k1 and len(forwards) == 4,
          f"the build launched K1 {build_launches['K1']} times ({len(forwards)} CV forwards), not {want_k1}")
    phase("definitions", f"build-fleet of {len(rows)} machines ({', '.join(f'{n} {p}' for p, n in DEFINITION_GROUPS)};"
          f" 20 tags, {TRAIN_ROWS} CSV rows) on the card in {wall:.2f} s: {build_phases(builder)}, sequential "
          f"{builder.phase_seconds['sequential']:.3f} s (the {sequential} callbacks machines, ModelBuilder, "
          f"{CALLBACK_EPOCHS} epochs); K1 launches {build_launches['K1']} (4 CV spec groups + 3 folds a sequential "
          f"machine), K2 {build_launches['K2']}; {card}")
    for i, lrs in enumerate(card_lrs[:4]):
        phase("definitions", f"callbacks-000 fit {i} (3 folds, then the final fit): {len(lrs)} epochs at "
              f"learning rates {lrs}")
    raw_forward = [f for f in forwards if f[0].dims == (16, 4)]
    check(len(raw_forward) == 1 and raw_forward[0][0].activations == ("tanh", "tanh"),
          "no raw-spec CV forward of 16-4 tanh units")
    spec, stacked, X, raw_launches = raw_forward[0]
    cases = {"raw": as_case(spec, stacked, X)}

    card_summaries = {}
    for name in DEFINITIONS_CPU_CHECK:
        model = serializer.load(os.path.join(directory, name), "cpu")
        card_summaries[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
    with captured_host_loops() as cpu_lrs:
        cpu, cpu_s = build_summaries([m for m in load_fleet_machines(shard) if m.name in DEFINITIONS_CPU_CHECK],
                                     "cpu")
    check(cpu_lrs == card_lrs[:4], f"callbacks-000's learning rates on the CPU {cpu_lrs} vs the card's "
          f"{card_lrs[:4]}")
    for names, limits in ((DEFINITIONS_CPU_CHECK[:-1], DEFINITIONS_BUILD_LIMITS),
                          (DEFINITIONS_CPU_CHECK[-1:], SEQUENTIAL_BUILD_LIMITS)):
        worst, faults = compare_builds(card_summaries, {n: cpu[n] for n in names}, limits)
        check(not faults, "[definitions] card build disagrees with the CPU's: " + "; ".join(faults[:5]))
        phase("definitions", f"card against a CPU build of {', '.join(names)} ({cpu_s:.2f} s on the CPU for all "
              f"{len(DEFINITIONS_CPU_CHECK)}): params max abs {worst[0]:.3e} (limit {limits[0]}), thresholds max rel "
              f"{worst[1]:.3e} (limit {limits[1]}), CV scores max |d| / (1 + |cpu|) {worst[2]:.3e} (limit "
              f"{limits[2]}), epochs run equal" + ("; learning rates of every fit equal" if limits is
                                                    SEQUENTIAL_BUILD_LIMITS else ""))

    # serving, engine on: one anomaly request a group, one fleet request over the non-affine and raw machines
    app = build_app(directory, device="cuda", serve_config=ServeConfig(deadline_ms=ENGINE_DEADLINE_MS))
    check(len(app.store.fleet().warm()) == len(rows), "not every [definitions] model loaded")
    app.start_warmup().join(timeout=600)
    cpu_app = build_app(directory, device="cpu")
    fleet = app.store.fleet()
    specs = fleet.loaded_specs()
    host_spec, standard_spec = specs["nonaffine-000"], specs["standard-000"]
    check(fleet.host_transformed(host_spec) and fleet.ingest_plan(host_spec) is None,
          "the non-affine bucket is not host-transformed")
    check(not fleet.host_transformed(standard_spec) and fleet.ingest_plan(standard_spec) is not None,
          "the StandardScaler bucket has no ingest plan")
    check(specs["callbacks-000"] == standard_spec, "the callbacks machines left the StandardScaler bucket")
    base, stop = serving(app)
    requests = [(f"/{p}-000/anomaly/prediction", {"X": definition_frame(f"{p}-000"),
                                                  "y": definition_frame(f"{p}-000", y=True)})
                for p, _ in DEFINITION_GROUPS]
    fleet_names = [f"nonaffine-{i:03d}" for i in range(counts["nonaffine"])] + [f"raw-{i:03d}" for i in
                                                                               range(counts["raw"])]
    requests.append(("/prediction/fleet", {"X": {n: definition_frame(n) for n in fleet_names}}))
    before = dict(app.engine.stats())
    try:
        with captured_serving_launches() as calls:
            fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
            answers = [post(base + path, payload) for path, payload in requests]
            serve_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    finally:
        stop()
    stats = app.engine.stats()
    app.shutdown()
    check(serve_launches == {"K1": len(DEFINITION_GROUPS), "K2": 2},
          f"serving launched {serve_launches}, not one K1 an anomaly request and one K2 a fleet bucket")
    check(stats["batches"] - before["batches"] == len(DEFINITION_GROUPS) and
          stats["ingest_batches"] - before["ingest_batches"] == 3,
          f"engine batches {stats['batches'] - before['batches']}, with the prologue "
          f"{stats['ingest_batches'] - before['ingest_batches']} (want {len(DEFINITION_GROUPS)} and 3: standard, "
          "maxabs, callbacks)")
    max_diff = 0.0
    for (path, payload), (status, body, ms) in zip(requests, answers):
        check(status == 200, f"{path} answered {status}")
        cpu_status, cpu_body = wsgi_post(cpu_app, "/gordo/v0/smoke" + path, payload)
        check(cpu_status == 200, f"the CPU app answered {cpu_status} on {path}")
        max_diff = max(max_diff, same_json(cpu_body["data"], body["data"]))
        phase("definitions", f"POST {path}: 200 in {ms:.1f} ms")
    k1_calls = [case for kernel, case in calls if kernel == "K1"]
    k2_calls = [case for kernel, case in calls if kernel == "K2"]
    cases["standard"] = next(c for c in k1_calls if c["spec"] == standard_spec)
    cases["host"] = next(c for c in k1_calls if c["spec"] == host_spec)
    host_k2 = next(c for c in k2_calls if c["spec"] == host_spec)
    # each case's launches on this phase's path: its CV forward, or its bucket's calls while serving
    case_launches = {"raw": raw_launches, "standard": sum(c["spec"] == standard_spec for c in k1_calls),
                     "host": sum(c["spec"] == host_spec for c in k1_calls),
                     "K2": sum(c["spec"] == host_spec for c in k2_calls)}
    check(cases["standard"]["ingest"] is not None and cases["host"]["ingest"] is None and host_k2["ingest"] is None,
          "the prologue ran where it should not, or not where it should")
    check(host_k2["y"] is not host_k2["X"] and host_k2["y"].shape == host_k2["X"].shape,
          "the host-transformed bucket's K2 did not take the raw rows as y")
    phase("definitions", f"{len(requests)} requests through the engine, K1 launches {serve_launches['K1']}, K2 "
          f"{serve_launches['K2']} (the non-affine and raw buckets); the non-affine bucket host-transformed, "
          f"no prologue; max abs diff vs the CPU app {max_diff:.3e} (rtol {RTOL}, atol {ATOL}); the phase took "
          f"{time.perf_counter() - t_phase:.1f} s")
    return build_launches, serve_launches, cases, host_k2, case_launches


# -- phase 5: times ----------------------------------------------------------------


# -- [sequential]: the sequential build, the build command, kill and resume --------

#: machines built one at a time by ``ModelBuilder``: a 20-tag and a 40-tag
#: machine of [train] and an lstm_hourglass machine of [lstm], with the K1
#: launches each must make (one a TimeSeriesSplit(3) fold; an LSTM none)
SEQUENTIAL = (("machine-000", 3), ("compressor-000", 3), ("lstm-hourglass-000", 0))
#: the sequential builds' epochs, on the card and the CPU alike: fewer than
#: [train]'s 5 and [lstm]'s, to keep the smoke within its time limit
SEQUENTIAL_EPOCHS = 2
#: the kill-and-resume drill: [train]'s first 6 20-tag machines; the kill
#: site fires after its machine's artifact landed and was journaled, so
#: ``after=2`` dies with exactly 3 artifacts on disk
DRILL_MACHINES = 6
DRILL_KILL = "process_kill_after_n_machines:*:after=2:kill"
DRILL_LEFT = 3
#: the ``build`` command's machine: one week of RandomDataProvider readings
COMMAND_MACHINE = "command-000"
#: a fold forward of each sequential feedforward build, held to the plain
#: version and timed: one member, the fold's 500 test rows
SEQUENTIAL_CASES = {20: "sequential fold scoring: hourglass20 M=1 B=500",
                    WIDE_TAGS: "sequential fold scoring: hourglass40 M=1 B=500"}
#: a sequential build (``ModelBuilder``) on the card against the same on
#: the CPU, TF32 off (params, thresholds, CV scores), for every machine of
#: that path here and in ``tests/test_torch_builder_cuda.py``: a lone
#: member's Adam steps carry the f32 differences further than a stacked
#: bucket's. ``scripts/build_tolerance.py sequential`` on an H100 (sound /
#: TF32 on / one row swapped in the last epoch), [sequential]'s machines at
#: SEQUENTIAL_EPOCHS: feedforward params 3.71e-6 / 3.22e-3 / 4.35e-5,
#: thresholds 5.33e-8 / 2.04e-5 / 2.23e-6, CV scores 5.38e-7 / 6.24e-4 /
#: 1.17e-4 (every planted fault fails a check); LSTM (sound / TF32 on; it never shuffles)
#: params LSTM_SOUND_TF32_PARAMS, thresholds LSTM_SOUND_TF32_THRESHOLDS,
#: CV scores LSTM_SOUND_TF32_SCORES.
SEQUENTIAL_BUILD_LIMITS = (1e-5, 3e-6, 2e-5)


def sequential_machines():
    """``(machine, expected K1 launches, model_offset)`` of SEQUENTIAL, each
    holding its seeded rows, with [train]'s or [lstm]'s definition."""
    from gordo_tpu_torch.machine import Machine

    index = [TRAIN_START + timedelta(minutes=10 * r) for r in range(TRAIN_ROWS)]
    rows = {name: (tags, values) for name, tags, values in machine_rows()}
    lstm, models = lstm_machines()
    rows.update({name: (tags, values) for name, tags, values in lstm})
    out = []
    for name, launches in SEQUENTIAL:
        tags, values = rows[name]
        model = json.loads(re.sub(r'"epochs": \d+', f'"epochs": {SEQUENTIAL_EPOCHS}',
                                  json.dumps(models.get(name, DEFINITION))))
        config = {"name": name, "model": model, "dataset": {"tag_list": tags, "resolution": "10min"}}
        out.append((Machine.from_config(config, "smoke", data=(values, None), index=index[:len(values)]), launches,
                    lstm_offsets().get(name, 0)))
    return out


@contextlib.contextmanager
def captured_fold_forwards():
    """During sequential builds: each ``TorchAutoEncoder.predict``'s K1 call
    as ``(spec, params, X, K1 launches it made)``, its tensors on the card."""
    from gordo_tpu_torch.models import estimators

    forwards, launch = [], estimators.fleet_feedforward

    def captured(spec, bucket, X, *args, **kwargs):
        before = launch.launches
        out = launch(spec, bucket, X, *args, **kwargs)
        forwards.append((spec, bucket, X, launch.launches - before))
        return out

    estimators.fleet_feedforward = captured
    try:
        yield forwards
    finally:
        estimators.fleet_feedforward = launch


def sequential_builds(card, fleet_ms):
    """Build SEQUENTIAL one at a time with ``ModelBuilder`` on the card, each
    K1 launch counted (the counters set to 0 before the first build, read
    after each); print each build's times beside the fleet build's ms a
    machine of its collection (``fleet_ms``: ``{"train": ms, "lstm": ms}``)
    and hold it to a CPU build of the same machine within
    SEQUENTIAL_BUILD_LIMITS. Returns the launches, and each feedforward
    machine's last fold forward as a K1 case on the card with the K1
    launches its build made, by input width."""
    import torch

    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    machines = sequential_machines()
    card_summaries, walls, cases = {}, {}, {}
    with captured_fold_forwards() as forwards:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        before = 0
        for machine, launches, offset in machines:
            first = len(forwards)
            t0 = time.perf_counter()
            model, built = ModelBuilder(machine, device="cuda").build()
            torch.cuda.synchronize()
            walls[machine.name] = 1e3 * (time.perf_counter() - t0)
            made, before = fleet_feedforward.launches - before, fleet_feedforward.launches
            meta = built.metadata["build_metadata"]
            collection = "lstm" if offset else "train"
            phase("sequential", f"{machine.name} built alone by ModelBuilder on the card at {SEQUENTIAL_EPOCHS} "
                  f"epochs in {walls[machine.name]:.1f} ms: fetch {1e3 * meta['dataset']['query_duration_sec']:.3f} ms (rows "
                  f"already in memory), CV {1e3 * meta['model']['cross_validation']['cv_duration_sec']:.1f} ms "
                  f"(3 folds, one after another), final fit {1e3 * meta['model']['model_training_duration_sec']:.1f} "
                  f"ms; [{collection}]'s build-fleet, at its own epochs, took {fleet_ms[collection]:.1f} ms a "
                  f"machine ({walls[machine.name] / fleet_ms[collection]:.1f}x); K1 launches {made} (expected {launches}: "
                  f"one a fold's predict), model_offset {meta['model']['model_offset']}; {card}")
            check(made == launches and len(forwards) - first == launches,
                  f"{machine.name}: the sequential build launched K1 {made} times in {len(forwards) - first} "
                  f"predicts, not {launches}")
            check(meta["model"]["model_offset"] == offset,
                  f"{machine.name}: model_offset {meta['model']['model_offset']}")
            if launches:
                spec, params, X, _ = forwards[-1]
                cases[X.shape[-1]] = (dict(spec=spec, bucket=params, X=X, indices=None, ingest=None), made)
            card_summaries[machine.name] = build_summary(model, built)
        launched = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    t0 = time.perf_counter()
    cpu = {}
    for machine, _, _ in sequential_machines():
        model, built = ModelBuilder(machine, device="cpu").build()
        cpu[machine.name] = build_summary(model, built)
    cpu_s = time.perf_counter() - t0
    limits = SEQUENTIAL_BUILD_LIMITS
    for kind in ("feedforward", "lstm"):
        names = [m.name for m, _, offset in machines if bool(offset) == (kind == "lstm")]
        worst, faults = compare_builds(card_summaries, {n: cpu[n] for n in names}, limits)
        phase("sequential", f"{kind} ({', '.join(names)}): card against a CPU ModelBuilder build of the same "
              f"machine ({cpu_s:.2f} s on the CPU for all three): params max abs {worst[0]:.3e} (limit "
              f"{limits[0]}), thresholds max rel {worst[1]:.3e} (limit {limits[1]}), CV scores max |d| / "
              f"(1 + |cpu|) {worst[2]:.3e} (limit {limits[2]}), epochs run and model_offset equal")
        check(not faults, f"sequential {kind} card build disagrees with the CPU's: " + "; ".join(faults[:5]))
    return launched, cases


def run_command(args, env=None, timeout=600):
    """``python -m gordo_tpu_torch ARGS`` from the checkout: ``(exit code,
    stdout, stderr, seconds)``."""
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", "gordo_tpu_torch", *args], cwd=HERE, capture_output=True,
                          text=True, timeout=timeout, env={**os.environ, **(env or {})})
    return done.returncode, done.stdout, done.stderr, time.perf_counter() - t0


def build_command(work_dir, card):
    """The ``build`` command in a subprocess, as a build pod runs it
    (``MACHINE``, ``OUTPUT_DIR``, ``--print-cv-scores``,
    ``--model-register-dir``): exit 0, the score lines, an artifact the
    port's app serves, registered; then the command's function once more
    in this process with the register: a cache hit with the first's
    ``model.pkl`` bytes."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build as build_machine
    from gordo_tpu_torch.server import build_app

    end = TRAIN_START + timedelta(days=7)
    machine = json.dumps({"name": COMMAND_MACHINE, "project_name": "smoke", "model": DEFINITION, "dataset": {
        "type": "RandomDataset", "train_start_date": TRAIN_START.isoformat(), "train_end_date": end.isoformat(),
        "tag_list": tag_list(20)}})
    collection = os.path.join(work_dir, "command", REVISION)
    output = os.path.join(collection, COMMAND_MACHINE)
    register = os.path.join(work_dir, "register")
    code, out, err, seconds = run_command(["build", "--print-cv-scores", "--model-register-dir", register],
                                          {"MACHINE": machine, "OUTPUT_DIR": output})
    check(code == 0, f"build exited {code}: {err[-2000:]}")
    scores = [line for line in out.splitlines() if "_fold-" in line]
    check(len(scores) == 4 * 21 * 7, f"build printed {len(scores)} score lines, not {4 * 21 * 7}")
    check(serializer.load_metadata(output)["metadata"]["user_defined"].get("date_of_retrieval") is None,
          "the first build was not trained")
    app = build_app(collection, device="cuda")
    status, body = wsgi_call(app, "GET", "/gordo/v0/smoke/models")
    check(status == 200 and json.loads(body)["models"] == [COMMAND_MACHINE], f"models: {status} {body[:200]}")
    frame = request_frame(7)
    status, answer = wsgi_post(app, f"/gordo/v0/smoke/{COMMAND_MACHINE}/anomaly/prediction", {"X": frame, "y": frame})
    check(status == 200, f"anomaly request to the built machine answered {status}")
    confidence = np.array(list(answer["data"]["total-anomaly-confidence"]["total-anomaly-confidence"].values()))
    check(confidence.shape == (ROWS,) and np.isfinite(confidence).all(), "anomaly confidence not finite")
    phase("sequential", f"python -m gordo_tpu_torch build (MACHINE, OUTPUT_DIR, --print-cv-scores, "
          f"--model-register-dir; {COMMAND_MACHINE}: 20 tags, one week of RandomDataProvider readings, hourglass, "
          f"5 epochs) exited 0 in {seconds:.2f} s (a new process: import, kernel load, fetch, 3 folds, fit, dump, "
          f"register), {len(scores)} score lines ({scores[0]}); the port's app on the card serves the artifact: "
          f"anomaly request 200; {card}")
    target = os.path.join(work_dir, "command-register", COMMAND_MACHINE)
    t0 = time.perf_counter()
    code = build_machine(machine, target, device="cuda", model_register_dir=register)
    hit_s = time.perf_counter() - t0
    check(code == 0, f"build --model-register-dir exited {code}")
    retrieved = serializer.load_metadata(target)["metadata"]["user_defined"].get("date_of_retrieval")
    check(retrieved is not None, "the second build was not a cache hit: no date_of_retrieval")
    pickles = []
    for directory in (output, target):
        with open(os.path.join(directory, serializer.MODEL_FILE), "rb") as f:
            pickles.append(f.read())
    check(pickles[0] == pickles[1], "the cache hit's model.pkl differs from the registered build's")
    phase("sequential", f"build --model-register-dir again (the command's function, in this process): it loaded the "
          f"registered build (date_of_retrieval stamped, no training) in {hit_s:.2f} s, model.pkl bytes equal to the "
          f"first's; {card}")


def kill_and_resume(work_dir, train_collection, card):
    """build-fleet of DRILL_MACHINES of [train]'s machines in a subprocess
    killed by ``GORDO_TPU_FAULTS`` (``os._exit(137)``): DRILL_LEFT complete
    artifacts and no half-written model directory; then ``--resume``: the
    DRILL_LEFT resumed from the journal with their ``info.json`` unchanged,
    the rest built within BUILD_LIMITS of [train]'s artifacts of the same
    names (or, where the smaller buckets make them differ, of an
    uninterrupted build of the same shard), and an app listing all of them."""
    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.parallel.journal import BuildJournal, artifact_complete
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.telemetry import load_status
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    drill_dir = os.path.join(work_dir, "drill")
    os.makedirs(drill_dir)
    machines = [m for m in machine_rows() if m[0].startswith("machine-")][:DRILL_MACHINES]
    config_path, _ = write_project(drill_dir, machines)
    shard = os.path.join(drill_dir, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke"))
    out = os.path.join(drill_dir, REVISION)
    # heartbeat 0: the status is written at every landing, before the kill site
    # cuda:0: the drill's builds are one process on one card wherever more are visible
    code, _, err, killed_s = run_command(["build-fleet", shard, out, "--device", "cuda:0"],
                                         {"GORDO_TPU_FAULTS": DRILL_KILL, "GORDO_TPU_TELEMETRY_HEARTBEAT": "0"})
    check(code == 137, f"the killed build-fleet exited {code}, not 137: {err[-2000:]}")
    status = load_status(out)
    check(status["state"] == "running" and status["machines"]["completed"] == DRILL_LEFT,
          f"the killed build's build_status.json: {status['state']}, {status['machines']}")
    left = serializer.list_model_dirs(out)
    staging = [e for e in os.listdir(out) if serializer.is_staging_dir(e)]
    check(len(left) == DRILL_LEFT and all(artifact_complete(os.path.join(out, n)) for n in left),
          f"the kill left {len(left)} model directories ({left}), not {DRILL_LEFT} complete ones")
    journal = BuildJournal.load(out).machines()
    check(sorted(n for n, e in journal.items() if e["status"] == "built") == left, "journal and artifacts differ")
    checksums = {n: serializer.load_info(os.path.join(out, n))["checksum"] for n in left}
    code, _, err, resume_s = run_command(["build-fleet", shard, out, "--resume", "--device", "cuda:0"])
    check(code == 0, f"build-fleet --resume exited {code}: {err[-2000:]}")
    resumed_status = load_status(out)
    check(resumed_status["state"] == "complete" and resumed_status["machines"]["resumed"] == DRILL_LEFT
          and resumed_status["machines"]["completed"] == DRILL_MACHINES - DRILL_LEFT,
          f"the resumed build's build_status.json: {resumed_status['state']}, {resumed_status['machines']}")
    summary = [line for line in err.splitlines() if "Fleet build complete" in line]
    expected = f"{DRILL_MACHINES - DRILL_LEFT} built, {DRILL_LEFT} resumed, 0 failed"
    check(summary and expected in summary[-1], f"the resume reported {summary[-1:]} , not {expected}")
    check({n: serializer.load_info(os.path.join(out, n))["checksum"] for n in left} == checksums,
          "a resumed machine's artifact changed")
    names = serializer.list_model_dirs(out)
    check(names == sorted(m[0] for m in machines), f"after the resume the revision holds {names}")
    rebuilt = [n for n in names if n not in left]
    summaries = {}
    for directory in (out, train_collection):
        summaries[directory] = {n: build_summary(serializer.load(os.path.join(directory, n), "cpu"),
                                                 serializer.load_metadata(os.path.join(directory, n)))
                                for n in rebuilt}
    worst, faults = compare_builds(summaries[out], summaries[train_collection])
    reference = "[train]'s artifacts"
    if faults:
        phase("sequential", f"the resumed machines against [train]'s artifacts: {'; '.join(faults[:3])}; building an "
              f"uninterrupted reference of the same shard")
        reference_dir = os.path.join(drill_dir, "reference")
        code, _, err, _ = run_command(["build-fleet", shard, reference_dir, "--device", "cuda:0"])
        check(code == 0, f"the reference build-fleet exited {code}: {err[-2000:]}")
        ref = {n: build_summary(serializer.load(os.path.join(reference_dir, n), "cpu"),
                                serializer.load_metadata(os.path.join(reference_dir, n))) for n in rebuilt}
        worst, faults = compare_builds(summaries[out], ref)
        reference = "an uninterrupted build of the same shard"
    check(not faults, "resumed machines disagree with their reference: " + "; ".join(faults[:5]))
    # the two processes' CV forwards: each the first K1 call of a fresh process, which loads K1's library
    # (built by this script already, so no nvcc) inside its fleet_predict span
    with open(os.path.join(out, "build_trace.jsonl")) as f:
        predicts = [span for span in map(json.loads, f) if span["name"] == "device_program"
                    and span["attributes"]["program"] == "fleet_predict"]
    check(len(predicts) == 2 and all(s["attributes"]["compile"] for s in predicts),
          f"the drill's trace holds {len(predicts)} fleet_predict spans, not one a process")
    app = build_app(out, device="cuda")
    status, body = wsgi_call(app, "GET", "/gordo/v0/smoke/models")
    listed = json.loads(body)["models"]
    check(status == 200 and listed == names, f"the app lists {listed}")
    phase("sequential", f"kill and resume: build-fleet of {DRILL_MACHINES} [train] machines with GORDO_TPU_FAULTS="
          f"\"{DRILL_KILL}\" exited 137 after {killed_s:.2f} s with {len(left)} complete artifacts, no half-written "
          f"model directory ({len(staging)} staging leftovers, hidden), the journal naming the same {len(left)}, "
          f"build_status.json running with {len(left)} completed; "
          f"--resume exited 0 in {resume_s:.2f} s: {expected}, build_status.json complete, the resumed info.json "
          f"checksums unchanged, the "
          f"{len(rebuilt)} rebuilt within BUILD_LIMITS of {reference} (params max abs {worst[0]:.3e}, thresholds "
          f"max rel {worst[1]:.3e}, CV scores {worst[2]:.3e}); the app lists all {len(listed)} and no journal or "
          f"staging entry; the fleet_predict span of each process (its first K1 call, the library's load inside): "
          f"{', '.join(str(s['duration_ms']) for s in predicts)} ms; {card}")


def sequential_phase(work_dir, train_collection, fleet_ms, card):
    """[sequential]: the sequential builds, the build command and the kill
    drill. Returns K1's and K2's launches in the sequential builds and their
    fold forwards (``sequential_builds``)."""
    t0 = time.perf_counter()
    launches, cases = sequential_builds(card, fleet_ms)
    build_command(work_dir, card)
    kill_and_resume(work_dir, train_collection, card)
    phase("sequential", f"the phase took {time.perf_counter() - t0:.1f} s")
    return launches, cases


# -- [lifecycle]: drift, a partial rebuild, a canary, promotion and rollback --------------------

#: the two machines whose probe window drifts, one of each width
LIFECYCLE_DRIFTED = ("machine-007", "compressor-003")
#: a probe window: the day of rows after each machine's training rows
LIFECYCLE_ROWS = 144
#: the drifted machines' rows move this many training stds
LIFECYCLE_SHIFT = 10.0
LIFECYCLE_FRACTION = 0.25
#: anomaly requests a burst, before, during and after the canary
LIFECYCLE_BURST = 16
#: the gate's ratios, card against a CPU app over the same two revisions
LIFECYCLE_GATE_RTOL = 2e-5
#: the steps of the supervisor's span trace, in the order they run
LIFECYCLE_STEPS = ("lifecycle_observe", "drift_eval", "canary_build", "canary_gate", "promote_swap", "rollback")
LIFECYCLE_EVENTS = ("drift_detected", "canary_serving", "promoted", "canary_rejected", "rolled_back")
LIFECYCLE_CV = {20: "lifecycle rebuild CV fold scoring: hourglass20 M=3 B=500",
                WIDE_TAGS: "lifecycle rebuild CV fold scoring: hourglass40 M=3 B=500"}
LIFECYCLE_GATE = {20: f"K2 lifecycle gate: hourglass20 N={SERVED_MACHINES} M=1 B={LIFECYCLE_ROWS} y=X +ingest",
                  WIDE_TAGS: f"K2 lifecycle gate: hourglass40 N={WIDE_MACHINES} M=1 B={LIFECYCLE_ROWS} y=X +ingest"}


def drifted_series(seed, n_tags, rows):
    """A drifted machine's ``sensor_data`` series of ``rows`` rows: from
    row TRAIN_ROWS on it has moved LIFECYCLE_SHIFT training stds."""
    series = sensor_data(seed, rows, n_tags)
    series[TRAIN_ROWS:] += LIFECYCLE_SHIFT * series[:TRAIN_ROWS].std(axis=0)
    return series


def lifecycle_windows():
    """``(healthy, drifted)`` probe windows of every served machine: the
    LIFECYCLE_ROWS rows that follow its training rows (the same seeded
    series), and the same with LIFECYCLE_DRIFTED's rows drifted
    (``drifted_series``)."""
    healthy, drifted = {}, {}
    for name, n_tags, seed in machine_seeds():
        healthy[name] = sensor_data(seed, TRAIN_ROWS + LIFECYCLE_ROWS, n_tags)[TRAIN_ROWS:]
        drifted[name] = (drifted_series(seed, n_tags, TRAIN_ROWS + LIFECYCLE_ROWS)[TRAIN_ROWS:]
                         if name in LIFECYCLE_DRIFTED else healthy[name])
    return healthy, drifted


def lifecycle_machines(work_dir, shard):
    """The supervisor's machine configs: ``shard``'s, except that each of
    LIFECYCLE_DRIFTED fetches the TRAIN_ROWS rows after its training rows,
    all drifted, as a rebuild fetches the newest data (a CSV of both
    spans, ``drifted_series``). Returns the path of that shard."""
    data_dir = os.path.join(work_dir, "lifecycle-data")
    os.makedirs(data_dir)
    with open(shard) as f:
        doc = json.load(f)
    seeds = {name: (n_tags, seed) for name, n_tags, seed in machine_seeds()}
    for machine in doc["machines"]:
        if machine["name"] in LIFECYCLE_DRIFTED:
            n_tags, seed = seeds[machine["name"]]
            dataset = machine["dataset"]
            dataset["data_provider"]["path"] = write_csv(data_dir, machine["name"], tag_list(n_tags),
                                                         drifted_series(seed, n_tags, 2 * TRAIN_ROWS))
            dataset["train_start_date"] = (TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)).isoformat()
            dataset["train_end_date"] = (TRAIN_START + timedelta(minutes=20 * TRAIN_ROWS)).isoformat()
    path = os.path.join(data_dir, "shard.json")
    with open(path, "w") as f:
        json.dump(doc, f)
    return path


def gate_ratios(store, base_dir, canary_dir, probe, names):
    """Each rebuilt machine's threshold and residual ratios, unrounded, as
    the gates compute them, scored by ``store``'s fleets."""
    import numpy as np

    base, canary = store.fleet(base_dir), store.fleet(canary_dir)
    base_scores, _ = base.fleet_scores({n: probe[n] for n in names})
    canary_scores, _ = canary.fleet_scores({n: probe[n] for n in names})
    out = {}
    for name in names:
        thresholds = [float(fleet.model(name).aggregate_threshold_) for fleet in (base, canary)]
        out[name] = (max(thresholds) / min(thresholds),
                     float(np.mean(canary_scores[name][1])) / float(np.mean(base_scores[name][1])))
    return out


@contextlib.contextmanager
def counted_scores():
    """While open, K2's launches through the store's ``fleet_scores``, by
    step and input width: ``(counts, step)``, where ``counts[step[0],
    width]`` grows by each launch and the caller names the step in
    ``step[0]`` (``"gate"`` until it says otherwise)."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores
    from gordo_tpu_torch.server import fleet_store

    counts, step = collections.Counter(), ["gate"]
    scores = fleet_store.fleet_anomaly_scores

    def counted(spec, stacked, X, *args, **kwargs):
        before = fleet_anomaly_scores.launches
        out = scores(spec, stacked, X, *args, **kwargs)
        counts[step[0], X.shape[-1]] += fleet_anomaly_scores.launches - before
        return out

    fleet_store.fleet_anomaly_scores = counted
    try:
        yield counts, step
    finally:
        fleet_store.fleet_anomaly_scores = scores


def lifecycle_burst(app, names, frames, revisions):
    """LIFECYCLE_BURST anomaly requests through ``app``, round robin over
    ``names``: the revision that answered each (by its ``revision`` header
    and body, which must agree) counted into ``revisions``; their host ms."""
    ms = []
    for i in range(LIFECYCLE_BURST):
        name = names[i % len(names)]
        payload = {"X": frames[name], "y": frames[name]}
        t0 = time.perf_counter()
        status, body = wsgi_call(app, "POST", f"/gordo/v0/smoke/{name}/anomaly/prediction", payload)
        ms.append((time.perf_counter() - t0) * 1e3)
        check(status == 200, f"[lifecycle] {name} answered {status}: {body[:300]!r}")
        revisions[json.loads(body)["revision"]] += 1
    return ms


def lifecycle_phase(work_dir, collection, shard, card):
    """The fleet lifecycle on the card (see the module docstring): a card app
    over a copy of [train]'s collection, the supervisor given its store; a
    healthy window, a drifted one (two machines rebuilt on the card,
    canaried at LIFECYCLE_FRACTION, bursts before, during and after, gated
    and promoted with requests running), a second drift rolled back by a
    gate the canary cannot pass, and a new app restoring the promotion.
    Returns the phase's K1 and K2 launches, the rebuild's CV forwards as K1
    cases by width with their launches, and the gates' K2 launches by
    width."""
    import numpy as np
    import torch

    from gordo_tpu_torch import serializer, telemetry
    from gordo_tpu_torch.cli.cli import load_fleet_machines
    from gordo_tpu_torch.lifecycle import (LIFECYCLE_TRACE_FILE, DriftConfig, GateConfig, LifecycleConfig,
                                           LifecycleState, LifecycleSupervisor)
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.parallel.fleet_build import rebuild_stale
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.server.fleet_store import FleetModelStore

    check(telemetry.enabled() and not os.environ.get("GORDO_TPU_TELEMETRY_DIR"),
          "[lifecycle] reads its steps from the supervisor's own trace: telemetry must be on, in its default place")
    root = os.path.join(work_dir, "lifecycle")
    base_revision = os.path.basename(collection)
    base_dir = os.path.join(root, base_revision)
    # a clean anchor: the health ledger stays behind, with [engine]'s poisoned member's open breaker, which
    # the supervisor's breaker feed (on, as by default) would nominate for a rebuild
    shutil.copytree(collection, base_dir, ignore=shutil.ignore_patterns("fleet_health*"))
    machines = load_fleet_machines(lifecycle_machines(work_dir, shard))
    healthy, drifted = lifecycle_windows()
    frames = {name: request_frame(1200 + i, rows=LIFECYCLE_ROWS, n_tags=healthy[name].shape[1])
              for i, name in enumerate(LIFECYCLE_DRIFTED)}
    app = build_app(base_dir, device="cuda")
    check(app.engine is None, "[lifecycle] serves without the engine (its requests launch K1 themselves)")
    check(len(app.store.fleet().warm()) == SERVED_MACHINES + WIDE_MACHINES, "not every model loaded")
    revisions = collections.Counter()
    lifecycle_burst(app, LIFECYCLE_DRIFTED, frames, revisions)  # the first requests load and stack
    config = LifecycleConfig(canary_fraction=LIFECYCLE_FRACTION, auto_promote=False, quarantine_cooldown_s=0.0,
                             drift=DriftConfig(), gates=GateConfig())
    samples_before = registry_samples()

    # the main path, counted from here
    fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
    with counted_scores() as (k2_counts, step):
        supervisor = LifecycleSupervisor(machines, base_dir, app.store, config=config, engine=app.engine)
        revisions.clear()
        before_ms = lifecycle_burst(app, LIFECYCLE_DRIFTED, frames, revisions)
        check(revisions == {base_revision: LIFECYCLE_BURST}, f"before the canary: {dict(revisions)}")
        observe = supervisor.observe

        def observed(frames_):  # K2 launches of an observation (the rest are the gates')
            step[0] = "observe"
            try:
                return observe(frames_)
            finally:
                step[0] = "gate"

        supervisor.observe = observed
        report = supervisor.run_cycle(healthy)
        check(report.phase == "idle" and not report.drifted and not report.stale,
              f"a healthy window drifted {report.drifted} (phase {report.phase})")
        with captured_build() as (forwards, _fetched):
            report = supervisor.run_cycle(drifted)
            torch.cuda.synchronize()
            first_rebuild = list(forwards)
            canary = report.canary_revision
            check(sorted(report.drifted) == sorted(LIFECYCLE_DRIFTED) and report.stale == sorted(LIFECYCLE_DRIFTED),
                  f"drifted {sorted(report.drifted)}, stale {report.stale}, not {sorted(LIFECYCLE_DRIFTED)}")
            check(report.phase == "canary_serving" and report.gate and report.gate["passed"]
                  and report.details.get("rebuilt") == sorted(LIFECYCLE_DRIFTED),
                  f"the drifted cycle ended in {report.phase}: gate {report.gate}, details {report.details}")
            status = app.store.canary_status()
            check(status is not None and status["fraction"] == LIFECYCLE_FRACTION, f"canary routing {status}")
            check(len(first_rebuild) == 2 and all(n == 1 for *_, n in first_rebuild),
                  f"the rebuild's CV scoring launched K1 {[n for *_, n in first_rebuild]} times for "
                  f"{len(first_rebuild)} spec groups")
            canary_dir = os.path.join(root, canary)

            revisions.clear()
            during_ms = lifecycle_burst(app, LIFECYCLE_DRIFTED, frames, revisions)
            share = revisions[canary] / LIFECYCLE_BURST
            check(abs(revisions[canary] - LIFECYCLE_FRACTION * LIFECYCLE_BURST) <= 1
                  and revisions[canary] + revisions[base_revision] == LIFECYCLE_BURST,
                  f"during the canary: {dict(revisions)} (fraction {LIFECYCLE_FRACTION})")

            # promotion, with requests running through the swap
            statuses, stop = [], threading.Event()

            def hammer():
                name = LIFECYCLE_DRIFTED[0]
                while not stop.is_set():
                    status_, _ = wsgi_call(app, "POST", f"/gordo/v0/smoke/{name}/anomaly/prediction",
                                           {"X": frames[name], "y": frames[name]})
                    statuses.append(status_)

            thread = threading.Thread(target=hammer, daemon=True)
            thread.start()
            try:
                promoted = supervisor.promote()
            finally:
                stop.set()
                thread.join(timeout=120)
            check(not thread.is_alive(), "[lifecycle] request thread did not stop")
            check(promoted.promoted and promoted.gate["passed"], f"promotion: {promoted}")
            check(statuses and all(s < 500 for s in statuses),
                  f"answers across the swap: {collections.Counter(statuses)}")
            swap_s = promoted.details["swap_seconds"]
            revisions.clear()
            after_ms = lifecycle_burst(app, LIFECYCLE_DRIFTED, frames, revisions)
            check(revisions == {canary: LIFECYCLE_BURST}, f"after the promotion: {dict(revisions)}")
            app.live_ledger.flush()
            with open(os.path.join(base_dir, "fleet_health.json")) as f:
                promoted_records = json.load(f)["machines"]

            # a second drift (the promoted machines' rows back where they were before they drifted), whose
            # rebuild fetches the data the promoted revision was built from: a gate the canary cannot pass
            supervisor.config.gates = GateConfig(residual_ratio=0.5)
            rolled = supervisor.run_cycle(healthy)
            check(rolled.rolled_back and rolled.phase == "idle" and not rolled.gate["passed"]
                  and any("residual" in f for f in rolled.gate["failures"]), f"the second drift: {rolled}")
        check(len(forwards) == 4 and all(n == 1 for *_, n in forwards), f"the two rebuilds' CV forwards: "
              f"{[(tuple(X.shape), n) for _, _, X, n in forwards]}")
        # each width's CV forward of the first rebuild as a K1 case, with both rebuilds' launches at that width
        cv_cases = {X.shape[-1]: (as_case(spec, stacked, X),
                                  sum(n for *_, Y, n in forwards if Y.shape[-1] == X.shape[-1]))
                    for spec, stacked, X, _ in first_rebuild}
        second = rolled.canary_revision
        check(app.store.route(base_dir) == canary_dir and app.store.canary_status() is None,
              f"after the rollback the app routes to {app.store.route(base_dir)}")
        supervisor.close()

        # a new app over the base directory serves the promoted revision
        restarted = build_app(base_dir, device="cuda")
        status_, body = wsgi_call(restarted, "POST", f"/gordo/v0/smoke/{LIFECYCLE_DRIFTED[0]}/anomaly/prediction",
                                  {"X": frames[LIFECYCLE_DRIFTED[0]], "y": frames[LIFECYCLE_DRIFTED[0]]})
        check(status_ == 200 and json.loads(body)["revision"] == canary, f"a new app answered {status_} from revision "
              f"{json.loads(body).get('revision')}, not {canary}")
        torch.cuda.synchronize()
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
        k2_by_step = dict(k2_counts)
    # the main path ends here; what follows holds it to references
    gate_k2 = {width: k2_by_step.get(("gate", width), 0) for width in (20, WIDE_TAGS)}
    card_ratios = gate_ratios(app.store, base_dir, canary_dir, drifted, sorted(LIFECYCLE_DRIFTED))

    # the records
    state = LifecycleState.load(root)
    events = [e["event"] for e in state.doc["history"]]
    order = [e for e in events if e in LIFECYCLE_EVENTS]
    check(order == ["drift_detected", "canary_serving", "promoted", "drift_detected", "canary_serving",
                    "canary_rejected", "rolled_back"], f"state.json's events {events}")
    check(state.serving_revision == canary and state.phase == "idle", f"state serves {state.serving_revision}")
    quarantined = state.quarantined()
    check(len(quarantined) == 1 and quarantined[0]["canary_revision"] == second
          and quarantined[0]["machines"] == sorted(LIFECYCLE_DRIFTED), f"quarantine.json {quarantined}")
    app.live_ledger.flush()
    with open(os.path.join(base_dir, "fleet_health.json")) as f:
        records = json.load(f)["machines"]
    for name in LIFECYCLE_DRIFTED:
        record, promoted_record = records[name], promoted_records[name]
        # the promotion cleared drift and moved the build's revision; the rollback quarantined
        check(promoted_record["build"]["revision"] == canary and not promoted_record["drift"]["drifted"]
              and not promoted_record["quarantine"]["active"], f"{name}'s health record after the promotion: "
              f"{promoted_record}")
        check(record["drift"]["drifted"] and record["quarantine"]["active"]
              and record["quarantine"]["revision"] == second,
              f"{name}'s health record: {record['drift']}, {record['quarantine']}")
    check(not any(r["drift"]["drifted"] or r["quarantine"]["active"] for n, r in records.items()
                  if n not in LIFECYCLE_DRIFTED), "a machine that did not drift has a drift or quarantine record")
    samples = registry_samples()
    moved = {event: summed(samples, f"gordo_fleet_lifecycle_{event}_total", project="smoke")
             - summed(samples_before, f"gordo_fleet_lifecycle_{event}_total", project="smoke")
             for event in ("rebuilds", "promotions", "rollbacks")}
    check(moved == {"rebuilds": 4.0, "promotions": 1.0, "rollbacks": 1.0}, f"lifecycle counters moved {moved}")
    check(summed(samples, "gordo_fleet_lifecycle_swap_seconds_count", project="smoke") >= 1.0, "no swap observed")
    spans = collections.defaultdict(float)
    with open(os.path.join(root, ".lifecycle", LIFECYCLE_TRACE_FILE)) as f:
        for line in f:
            span = json.loads(line)
            if span.get("kind") != "event":
                spans[span["name"]] += span["duration_ms"] / 1e3
    check(all(spans[step] > 0 for step in LIFECYCLE_STEPS), f"steps missing from the trace: {dict(spans)}")
    # K2: an observation scores every machine (one launch a width); a gate both fleets' rebuilt machines (one
    # a width and fleet), in 3 cycles and the promotion
    expected = {(step_, width): n for width in (20, WIDE_TAGS) for step_, n in (("observe", 3), ("gate", 6))}
    check(k2_by_step == expected and sum(k2_by_step.values()) == launches["K2"],
          f"K2 launched {k2_by_step} times by step and width ({launches['K2']} in all), expected {expected}")
    # K1: each rebuild's CV forward a width, every anomaly request, and the new app's one
    requests = 3 * LIFECYCLE_BURST + len(statuses) + 1
    check(launches["K1"] == 2 * 2 + requests,
          f"K1 launched {launches['K1']} times, expected {2 * 2 + requests} (4 CV forwards, {requests} requests)")

    # held to the CPU: the rebuild, and the gate over the same two revisions
    t0 = time.perf_counter()
    cpu_dir = os.path.join(work_dir, "lifecycle-cpu-rebuild")
    cpu_builder = rebuild_stale(machines, LIFECYCLE_DRIFTED, cpu_dir,
                                base_plan_path=os.path.join(base_dir, "fleet_plan.json"), device="cpu")
    check(not cpu_builder.build_errors, f"CPU rebuild errors: {cpu_builder.build_errors}")
    cpu, card_ = {}, {}
    for name in LIFECYCLE_DRIFTED:
        for out, directory, device in ((cpu, cpu_dir, "cpu"), (card_, canary_dir, "cpu")):
            model = serializer.load(os.path.join(directory, name), device)
            out[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
    worst, faults = compare_builds(card_, cpu)
    check(not faults, "[lifecycle] card rebuild disagrees with the CPU's: " + "; ".join(faults[:5]))
    cpu_ratios = gate_ratios(FleetModelStore(base_dir, torch.device("cpu")), base_dir, canary_dir, drifted,
                             sorted(LIFECYCLE_DRIFTED))
    gate_err = max(abs(card_ratios[n][i] - cpu_ratios[n][i]) / abs(cpu_ratios[n][i])
                   for n in cpu_ratios for i in range(2))
    check(gate_err <= LIFECYCLE_GATE_RTOL, f"the gate's ratios on the card {card_ratios}, on the CPU {cpu_ratios}")
    for name, (threshold_ratio, residual_ratio) in card_ratios.items():
        check(promoted.gate["checks"]["threshold_parity"][name] == round(threshold_ratio, 4)
              and promoted.gate["checks"]["residual_parity"][name] == round(residual_ratio, 4),
              f"the gate's report {promoted.gate['checks']} against its ratios {card_ratios}")
    cpu_s = time.perf_counter() - t0

    def p50(values):
        return float(np.median(values))

    phase("lifecycle", f"{SERVED_MACHINES + WIDE_MACHINES} machines served by a card app over a copy of [train]'s "
          f"collection; probe windows of {LIFECYCLE_ROWS} rows, {', '.join(LIFECYCLE_DRIFTED)} shifted "
          f"{LIFECYCLE_SHIFT:g} training stds: a healthy window drifted nothing, the shifted one exactly those two; "
          f"rebuilt on the card as canary {canary} (hardlinks for the other {SERVED_MACHINES + WIDE_MACHINES - 2}), "
          f"gated, promoted; a second drift's canary {second} rolled back and quarantined")
    phase("lifecycle", "steps (the supervisor's span trace, seconds summed over the phase): "
          + ", ".join(f"{step} {spans[step]:.3f}" for step in LIFECYCLE_STEPS)
          + f"; swap {swap_s!r} s; {card}")
    phase("lifecycle", f"anomaly requests of {LIFECYCLE_ROWS} rows, host ms p50: before the canary "
          f"{p50(before_ms):.2f}, during {p50(during_ms):.2f} ({share:.0%} of them from the canary), after the "
          f"promotion {p50(after_ms):.2f}; {len(statuses)} requests across the swap, none 5xx; {card}")
    phase("lifecycle", f"card rebuild against a CPU rebuild of the same machines ({cpu_s:.2f} s with the gate's CPU "
          f"check): params max abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds max rel {worst[1]:.3e} "
          f"(limit {BUILD_THRESHOLD_RTOL}), CV scores {worst[2]:.3e} (limit {BUILD_SCORE_TOL}); gate ratios card "
          f"against CPU max rel {gate_err:.3e} (limit {LIFECYCLE_GATE_RTOL}): "
          + ", ".join(f"{n} threshold {r[0]:.6f} residual {r[1]:.6f}" for n, r in card_ratios.items()))
    phase("lifecycle", f"state.json events {order}; quarantine.json 1 record ({second}); health ledger: drift, "
          f"quarantine and promotion records of the two; counters {moved}; K1 {launches['K1']} (4 CV forwards, "
          f"{requests} requests), K2 {launches['K2']} (3 observes and 3 gates, one a width and fleet: gates "
          f"{gate_k2[20]} narrow and {gate_k2[WIDE_TAGS]} wide)")
    return launches, cv_cases, gate_k2


# -- [packing]: the packing planner, a packed plan replayed, packed fits --------------------------------

#: the packing project: 16 feedforward_hourglass(20) machines and 8 (40) ones, their rows spread so that
#: the packed plan differs from the naive one. At GORDO_TPU_PLAN_PAD_RATIO's 1.25 and batch 32 the 20-tag
#: rows fall on rungs 608 and 736 (eleven machines) and 1792 and 2240 (five); padding the eleven up to 2240
#: costs more run time (0.368 s, the analytic model) than the compile it saves (0.351 s), so only the
#: compile budget forces that merge. The 40-tag trio of 580-600 rows keeps rung 608 (merging it would add
#: 0.433 s), the other five take 2240
PACKING_ROWS = {20: (600, 620, 640, 660, 680, 700, 720, 650, 610, 630, 690, 1500, 1700, 1800, 1900, 2000),
                WIDE_TAGS: (600, 590, 580, 1800, 1850, 1900, 2000, 2000)}
PACKING_PROJECT = "smoke-packing"
#: sensor_data seeds of the packing machines start here (by width)
PACKING_SEED = {20: 700, WIDE_TAGS: 800}
#: ``plan``'s knobs: three programs at most (one forced merge: the eleven low 20-tag machines into 2240),
#: and a bucket cap (4.5 MB) under which the sixteen 20-tag machines at 2240 (0.431 MB each, the cost
#: model's bytes) split into sibling bins of 10 and 6 sharing a member rung, m_padded 16, while the five
#: 40-tag ones at 2240 (4.41 MB in all) stay one bucket
PACKING_BUDGET = "3"
PACKING_HBM_CAP = "4500000"
#: built again on the CPU from the same plan and packing: the 40-tag trio, alone in its rung both in
#: the final fit (the plan's bucket, one pack of 3) and in the CV (its 9 fold members, three packs of 3),
#: so the CPU build's packs are the card's
PACKING_CPU_CHECK = ("pack40-000", "pack40-001", "pack40-002")
#: K1 at the packed build's CV scoring: 3 folds of each width's machines x the longest fold's 500 test rows
PACKING_CV = {20: "packed build CV fold scoring: hourglass20 M=48 B=500",
              WIDE_TAGS: "packed build CV fold scoring: hourglass40 M=24 B=500"}
#: the packed machines' fleet request: four of each width, from every final-fit bucket
PACKING_FLEET_MACHINES = {20: (0, 5, 10, 15), WIDE_TAGS: (0, 2, 4, 7)}
#: K2 at that request: each width's bucket of the served revision, its four members gathered
PACKING_FLEET = {20: "K2 packed fleet request: hourglass20 N=16 M=4 B=1008 y=X +ingest",
                 WIDE_TAGS: "K2 packed fleet request: hourglass40 N=8 M=4 B=1008 y=X +ingest"}


def packing_machines():
    """``(name, tags, training rows, the next ROWS rows)`` of the packing project."""
    out = []
    for width, rows in PACKING_ROWS.items():
        for i, n in enumerate(rows):
            values = sensor_data(PACKING_SEED[width] + i, n + ROWS, width)
            out.append((f"pack{width}-{i:03d}", tag_list(width), values[:n], values[n:]))
    return out


def packing_frame(tags, values):
    """A packing machine's next ROWS rows as a request frame, with
    request_frame's excursion."""
    start = datetime(2020, 3, 1, tzinfo=timezone.utc)
    keys = [(start + timedelta(minutes=10 * r)).isoformat() for r in range(ROWS)]
    values = values.copy()
    values[ROWS // 2:ROWS // 2 + 6, 3] += 25.0
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tags)}


@contextlib.contextmanager
def environment(values):
    """``os.environ`` with ``values`` while open."""
    saved = {name: os.environ.get(name) for name in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def cli_stdout(*args, env=None):
    """``python -m gordo_tpu_torch ARGS`` in this process (the card's
    kernels already loaded), ``env`` set for it: ``(exit code, stdout)``."""
    import io

    from gordo_tpu_torch.cli.cli import main

    out = io.StringIO()
    with environment(env or {}), contextlib.redirect_stdout(out):
        code = main(list(args))
    return code, out.getvalue()


def plan_summary(doc):
    """A plan document's buckets, rungs, compiles, predicted seconds and
    padding waste, as one phrase."""
    totals = doc["totals"]
    rungs = sorted({(b["spec"]["n_features"], b["n_padded"]) for b in doc["buckets"]})
    return (f"{totals['buckets']} buckets (members {[len(b['members']) for b in doc['buckets']]}, m_padded "
            f"{[b['m_padded'] for b in doc['buckets']]}), rungs (tags, rows) {rungs}, {totals['compiles']} "
            f"compiles, predicted {totals['predicted_compile_s']} s compile + {totals['predicted_run_s']} s run "
            f"= {totals['predicted_wall_s']} s, padding waste {totals['padding_waste']:.1%}")


def paced_ms(step, iters=20, repeats=5):
    """ms a step between CUDA events around ``iters`` steps run back to
    back (the host's enqueue paces them, as in a build), the median of
    ``repeats`` such runs."""
    import statistics

    import torch

    for _ in range(3):
        step()
    runs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            step()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / iters)
    return statistics.median(runs)


@contextlib.contextmanager
def captured_fleet_scores():
    """While open, each K2 call of the store (``fleet_scores``) as
    ``(case, launches it made)``, its tensors on the card."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores
    from gordo_tpu_torch.server import fleet_store

    calls, scores = [], fleet_store.fleet_anomaly_scores

    def captured(spec, stacked, X, y, indices=None, ingest=None, *args, **kwargs):
        before = fleet_anomaly_scores.launches
        out = scores(spec, stacked, X, y, indices, ingest, *args, **kwargs)
        calls.append((dict(spec=spec, bucket=stacked, X=X, y=y, indices=indices, ingest=ingest),
                      fleet_anomaly_scores.launches - before))
        return out

    fleet_store.fleet_anomaly_scores = captured
    try:
        yield calls
    finally:
        fleet_store.fleet_anomaly_scores = scores


def packing_phase(work_dir, train_collection, card):
    """``[packing]``: the packing project planned by ``plan --strategy
    packed`` under a compile budget and an HBM cap (beside the naive plan
    and the unbudgeted one of the same rows, planned in this process), built on the card by ``build-fleet
    --plan-from`` with ``GORDO_TPU_PACKING=auto`` (each fit's members,
    packing and steps a second; a packed step against an unpacked one of
    the same bucket), held to a CPU build of PACKING_CPU_CHECK from the
    same plan and packing, its machines served by a card app against the
    CPU app, and ``plan --calibrate-from`` over ``[train]``'s trace.
    Returns the phase's K1 and K2 launches, the CV forwards as K1 cases by
    width with their launches, and the fleet request's K2 calls as cases
    by width with their launches."""
    import numpy as np
    import torch

    from gordo_tpu_torch import planner, serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.models.spec import FeedForwardSpec
    from gordo_tpu_torch.models.training import FitConfig
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.parallel.fleet_build import FleetBuilder
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    root = os.path.join(work_dir, "packing")
    os.makedirs(root)
    machines = packing_machines()
    config_path, _ = write_project(root, [(name, tags, values) for name, tags, values, _ in machines],
                                   project=PACKING_PROJECT)
    shard = os.path.join(root, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, PACKING_PROJECT))
    knobs = {"GORDO_TPU_PLAN_COMPILE_BUDGET": PACKING_BUDGET, "GORDO_TPU_PLAN_HBM_CAP_BYTES": PACKING_HBM_CAP}
    plan_path = os.path.join(root, "plan.json")
    t0 = time.perf_counter()
    code, out = cli_stdout("plan", shard, "--device", "cuda", "--strategy", "packed", "-o", plan_path, "--as-json",
                           env=knobs)
    plan_s = time.perf_counter() - t0
    check(code == 0, f"plan --strategy packed exited {code}")
    packed = json.loads(out)
    # the same members (their rows, X and y apart as staged) planned in this process: naive, and packed
    # without the budget (the rungs the voluntary merges leave)
    config = FitConfig(**{k: v for k, v in packed["buckets"][0]["fit_config"].items() if k != "early_stopping"})
    specs = {b["spec"]["n_features"]: FeedForwardSpec.from_dict(b["spec"]) for b in packed["buckets"]}
    proxies = [types.SimpleNamespace(name=f"pack{width}-{i:03d}", spec=specs[width], n=n, X=0, y=1)
               for width, rows in PACKING_ROWS.items() for i, n in enumerate(rows)]
    naive = planner.build_plan_doc([(config, planner.plan_train_buckets(proxies, config, strategy="naive"))],
                                   "naive", packed["config_fingerprint"]).doc
    free = planner.plan_train_buckets(proxies, config, strategy="packed", budget=0, hbm_cap=int(PACKING_HBM_CAP))
    rung_groups = {"budget": len({(b["spec"]["n_features"], b["n_padded"]) for b in packed["buckets"]}),
                   "free": len({(b.spec.n_features, b.n_padded) for b in free})}
    split = [b for b in packed["buckets"] if b["m_padded"]]
    check(rung_groups["budget"] < rung_groups["free"], f"the compile budget forced no merge: {rung_groups}")
    check(split and len({b["m_padded"] for b in split}) == 1 and len(split) > 1,
          f"the HBM cap split no rung into siblings: {[b['m_padded'] for b in packed['buckets']]}")
    check(packed["strategy"] == "packed" and packed["totals"]["members"] == len(machines), "the packed plan")
    phase("packing", f"plan --strategy packed of {len(machines)} machines (16 hourglass20 of "
          f"{min(PACKING_ROWS[20])}-{max(PACKING_ROWS[20])} rows, 8 hourglass40 of {min(PACKING_ROWS[WIDE_TAGS])}-"
          f"{max(PACKING_ROWS[WIDE_TAGS])}; GORDO_TPU_PLAN_COMPILE_BUDGET={PACKING_BUDGET}, "
          f"GORDO_TPU_PLAN_HBM_CAP_BYTES={PACKING_HBM_CAP}) in {plan_s:.2f} s (fetch and stage, no training): "
          f"{plan_summary(packed)}")
    phase("packing", f"the naive plan of the same machines: {plan_summary(naive)}")
    phase("packing", f"rung groups {rung_groups['free']} without the budget (the same rows planned in this process), "
          f"{rung_groups['budget']} with it: a "
          f"forced merge (the eleven low 20-tag machines padded to 2240, past the model's break-even); the cap "
          f"split a rung into {len(split)} siblings of {[len(b['members']) for b in split]} members sharing "
          f"m_padded {split[0]['m_padded']} (the analytic model's constants, not the card's times)")

    out_dir = os.path.join(root, REVISION)
    saved_packing = os.environ.get("GORDO_TPU_PACKING")
    os.environ["GORDO_TPU_PACKING"] = "auto"
    try:
        with captured_build() as (forwards, fetched):
            fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
            t0 = time.perf_counter()
            code, builder = build_fleet(shard, out_dir, device="cuda", plan_from=plan_path)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            build_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
        check(code == 0 and not builder.build_errors, f"build-fleet --plan-from exited {code}: "
              f"{builder and builder.build_errors}")
        check({name: len(X) for name, X in fetched.items()} == {name: len(v) for name, _, v, _ in machines},
              "the build fetched other rows than the machines' CSVs hold")
        check(len(forwards) == 2 and build_launches["K1"] == 2 and all(n == 1 for *_, n in forwards),
              f"CV scoring launched K1 {[n for *_, n in forwards]} times for {len(forwards)} spec groups")
        cv_cases = {X.shape[-1]: (as_case(spec, stacked, X), n) for spec, stacked, X, n in forwards}
        fits = builder.trainer.fits
        plan = planner.FleetPlan.load(plan_path)
        planned = {b["id"]: b for b in plan.buckets}
        final = [f for f in fits if "::fold" not in f["names"][0]]
        check(sorted(f["bucket"] for f in final) == sorted(planned), "the final fit ran other buckets than the plan's")
        for fit in final:
            entry = planned[fit["bucket"]]
            check(fit["names"] == entry["members"] and fit["rows"] == entry["n_padded"]
                  and fit["m_padded"] == entry["m_padded"],
                  f"bucket {fit['bucket']} replayed {fit['names']} at {fit['rows']} rows, not the plan's")
            check((fit["packed"] == 1) == bool(entry["m_padded"]),
                  f"bucket {fit['bucket']} (m_padded {entry['m_padded']}) trained packed x{fit['packed']}")
        check({f["packed"] for f in fits} >= {6, 3}, f"no fit packed x6 and x3: {[f['packed'] for f in fits]}")
        check(builder.fleet_plan.plan_hash == plan.plan_hash, "the build wrote another plan than it replayed")
        for fit in fits:
            kind = "CV" if "::fold" in fit["names"][0] else "final"
            phase("packing", f"{kind} fit {fit['bucket']}: {fit['members']} members, {fit['rows']} rows, "
                  + (f"packed x{fit['packed']}" if fit["packed"] > 1 else "unpacked")
                  + (f" (m_padded {fit['m_padded']})" if fit["m_padded"] else "")
                  + f", {fit['steps']} steps in {fit['seconds']:.3f} s: {fit['steps'] / fit['seconds']:.1f} steps "
                  f"a second, {fit['event_ms'] / fit['steps']:.3f} ms a step between CUDA events")
        steps = sum(f["steps"] for f in fits)
        fit_s = sum(f["seconds"] for f in fits)
        phase("packing", f"build-fleet --plan-from plan.json with GORDO_TPU_PACKING=auto on the card in {wall:.2f} s: "
              f"{build_phases(builder)}; {len(fits)} fits, {steps} steps in {fit_s:.3f} s ({steps / fit_s:.1f} steps "
              f"a second); every final fit the plan's bucket (id, members, rows, m_padded), the m_padded siblings "
              f"unpacked; K1 launches {build_launches['K1']} (CV scoring, one a spec group), K2 "
              f"{build_launches['K2']}; {card}")

        cv_bucket = max((f for f in fits if "::fold" in f["names"][0] and f["packed"] == 6),
                        key=lambda f: f["members"])
        members = cv_bucket["members"]
        steps_ = {"packed x6": make_step(20, members, 6), "unpacked": make_step(20, members)}
        # in turns (packed, unpacked, unpacked, packed): the host's pace drifts within a run
        paced = {label: [] for label in steps_}
        for label in ("packed x6", "unpacked", "unpacked", "packed x6"):
            paced[label].append(paced_ms(steps_[label]))
        for label, step in steps_.items():
            launches_, kernel_ms = profile_step(step)
            device_ms = step_device_ms(step)
            paced_ = min(paced[label])
            phase("packing", f"one {label} step of the 20-tag CV bucket ({members} members x 32 rows): "
                  f"{launches_:.0f} kernel launches, {kernel_ms:.4f} ms of kernels (profiler), {device_ms!r} ms of "
                  f"device time with the host's enqueue hidden, {paced[label][0]!r} and {paced[label][1]!r} ms a "
                  f"step back to back (the two turns' medians): the device idles ~{1 - device_ms / paced_:.0%} of "
                  f"a step; {card}")

        t0 = time.perf_counter()
        cpu_machines = [m for m in load_fleet_machines(shard) if m.name in PACKING_CPU_CHECK]
        cpu_builder = FleetBuilder(cpu_machines, device="cpu", fleet_plan=plan)
        cpu = {machine.name: build_summary(model, machine) for model, machine in cpu_builder.build()}
        cpu_s = time.perf_counter() - t0
    finally:
        if saved_packing is None:
            os.environ.pop("GORDO_TPU_PACKING", None)
        else:
            os.environ["GORDO_TPU_PACKING"] = saved_packing
    check(not cpu_builder.build_errors and sorted(cpu) == sorted(PACKING_CPU_CHECK),
          f"the CPU build: {cpu_builder.build_errors}")
    check([f["packed"] for f in cpu_builder.trainer.fits] == [3, 3], "the CPU build's fits were not packed x3")
    card_summaries = {n: build_summary(serializer.load(os.path.join(out_dir, n), "cpu"),
                                       serializer.load_metadata(os.path.join(out_dir, n))) for n in PACKING_CPU_CHECK}
    worst, faults = compare_builds(card_summaries, cpu)
    check(not faults, "packed card build disagrees with the CPU's: " + "; ".join(faults[:5]))
    phase("packing", f"card build against a CPU build of {', '.join(PACKING_CPU_CHECK)} from the same plan and "
          f"packing ({cpu_s:.2f} s on the CPU; their CV and final fits packed x3 there as on the card): params max "
          f"abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds max rel {worst[1]:.3e} (limit "
          f"{BUILD_THRESHOLD_RTOL}), CV scores max |d| / (1 + |cpu|) {worst[2]:.3e} (limit {BUILD_SCORE_TOL})")

    t0 = time.perf_counter()
    app, cpu_app = build_app(out_dir, device="cuda"), build_app(out_dir, device="cpu")
    for served in (app, cpu_app):  # every machine resident: the fleet request gathers from whole buckets
        check(len(served.store.fleet().warm_buckets()) == len(machines), "not every packed machine loaded")
    by_name = {name: (tags, future) for name, tags, _, future in machines}
    asked = ("pack20-003", "pack20-014", "pack40-001", "pack40-006")
    requests = [(f"/{n}/anomaly/prediction", {"X": packing_frame(*by_name[n]), "y": packing_frame(*by_name[n])})
                for n in asked]
    fleet = [f"pack{width}-{i:03d}" for width, picked in PACKING_FLEET_MACHINES.items() for i in picked]
    requests.append(("/prediction/fleet", {"X": {n: packing_frame(*by_name[n]) for n in fleet}}))
    with captured_fleet_scores() as k2_calls:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        served_t0 = time.perf_counter()
        answers = [wsgi_post(app, f"/gordo/v0/{PACKING_PROJECT}" + path, payload) for path, payload in requests]
        serve_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
        serve_s = time.perf_counter() - served_t0
    check(serve_launches == {"K1": len(asked), "K2": 2}, f"the requests launched {serve_launches}, not K1 "
          f"{len(asked)} (one an anomaly request) and K2 2 (one a width)")
    max_diff = 0.0
    for (path, payload), (status, body) in zip(requests, answers):
        cpu_status, cpu_body = wsgi_post(cpu_app, f"/gordo/v0/{PACKING_PROJECT}" + path, payload)
        check(status == cpu_status == 200, f"{path}: the card app answered {status}, the CPU app {cpu_status}")
        max_diff = max(max_diff, same_json(cpu_body["data"], body["data"]))
    fleet_cases = {case["X"].shape[-1]: (case, n) for case, n in k2_calls}
    phase("packing", f"{len(asked)} anomaly requests ({', '.join(asked)}) and a fleet request of {len(fleet)} "
          f"({', '.join(fleet)}) to a card app over the packed build: {serve_s:.2f} s on the card's app "
          f"({time.perf_counter() - t0:.2f} s with both apps' loads and the CPU app's answers), 200, equal to the "
          f"CPU app's (max abs "
          f"{max_diff:.3e}, rtol {RTOL}, atol {ATOL}); K1 launches {serve_launches['K1']}, K2 "
          f"{serve_launches['K2']} (the fleet request's buckets {sorted(fleet_cases)}-tag)")

    trace = os.path.join(train_collection, "build_trace.jsonl")
    table_path = os.path.join(root, "cost_table.json")
    code, out = cli_stdout("plan", shard, "--device", "cuda", "--strategy", "packed", "--as-json", "--calibrate-from",
                           trace, "--cost-table-out", table_path, env=knobs)
    check(code == 0, f"plan --calibrate-from exited {code}")
    calibrated = json.loads(out)
    table = planner.CostTable.load(table_path)
    check(table.calibrated and calibrated["cost_table"]["calibrated"], "the calibration fitted nothing")
    phase("packing", f"plan --calibrate-from [train]'s build_trace.jsonl: run_factors {table.run_factors}, "
          f"compile_factors {table.compile_factors}, samples {table.samples} (on the card a 'compile' span is a "
          f"stacked shape's first launch: no XLA compile, the factor scales the analytic compile time to that "
          f"launch's warm-up); {card}")
    same = [b["id"] for b in calibrated["buckets"]] == [b["id"] for b in packed["buckets"]]
    phase("packing", f"the calibrated plan of the packing shard: {plan_summary(calibrated)}; against the analytic "
          f"one: {'the same buckets' if same else 'other buckets'}, predicted wall "
          f"{calibrated['totals']['predicted_wall_s']} s against {packed['totals']['predicted_wall_s']} s")
    launches = {k: build_launches[k] + serve_launches[k] for k in ("K1", "K2")}
    return launches, cv_cases, fleet_cases


# -- [ingress]: every data input the JAX package reads ------------------------------

#: [ingress]'s project and machines, each 20 tags of TRAIN_ROWS rows from TRAIN_START, DEFINITION's detector
INGRESS_PROJECT = "smoke-ingress"
INGRESS_MACHINES = ("file-wide-000", "file-tags-000", "influx-000", "filtered-000")
#: their sensor_data seeds: INGRESS_SEED + their position (clear of [train]'s, [lstm]'s and [definitions]')
INGRESS_SEED = 1500
#: file-tags-000's tags read from the parquet files pyarrow wrote (``scripts/make_parquet_fixtures.py``,
#: SNAPPY, dictionary pages, data page v1); its other tags the port's writer writes
INGRESS_FIXTURES = os.path.join("tests", "data", "parquet")
INGRESS_FIXTURE_TAGS = ("tag-00", "tag-01")
#: influx-000's source: InfluxDB 1.x's /query on 127.0.0.1, user, password and API key
INGRESS_INFLUX_AUTH = ("smoke", "ingress-pw")
INGRESS_API_KEY = "ingress-key"
#: the InfluxQL the JAX provider (``gordo_tpu/dataset/data_provider.py:410-423``) writes for each of
#: influx-000's tags over [TRAIN_START, TRAIN_START + TRAIN_ROWS x 10 min) with ``where_tags``
#: ``{"site": "north"}``: a copy, written out here
INGRESS_INFLUXQL = ('SELECT "Value" FROM "sensors" WHERE time >= 1577836800000000000 AND time < 1579036800000000000 '
                    "AND \"tag\" = '{tag}' AND \"site\" = 'north'")
#: filtered-000's row_filter drops between these shares of its rows
INGRESS_DROPPED = (0.10, 0.30)
#: [ingress]'s K1 calls on the card, held against the plain version and timed in [times]
INGRESS_CASES = {
    "cv": "ingress CV fold scoring: hourglass20 M=12 B=500",
    "served": "parquet requests: hourglass20 gather M=1 of 4 B=1008 +ingest",
}


def ingress_rows():
    """``{name: (tags, rows)}`` of [ingress]'s machines: file-tags-000's
    first tags the fixtures' numbers, the rest seeded ``sensor_data``."""
    import numpy as np

    rows = {}
    for i, name in enumerate(INGRESS_MACHINES):
        values = sensor_data(INGRESS_SEED + i, TRAIN_ROWS, 20)
        if name == "file-tags-000":
            for j, tag in enumerate(INGRESS_FIXTURE_TAGS):
                values[:, j] = np.load(os.path.join(HERE, INGRESS_FIXTURES, "tags", f"{tag}.npz"))["values"][:, 0]
        rows[name] = (tag_list(20), values)
    return rows


def ingress_filter(values):
    """filtered-000's ``row_filter`` (backticks, ``&``, a chained comparison)
    from its rows' percentiles, and the rows it keeps in numpy, written apart
    from the port's evaluator."""
    import numpy as np

    low0 = round(float(np.percentile(values[:, 0], 12)), 3)
    low1, high1 = (round(float(np.percentile(values[:, 1], q)), 3) for q in (4, 99))
    text = f"`tag-00` > {low0} & {low1} < `tag-01` <= {high1}"
    keep = (values[:, 0] > low0) & (low1 < values[:, 1]) & (values[:, 1] <= high1)
    return text, keep


def influx_server(values, tags):
    """InfluxDB 1.x's ``GET /query`` on 127.0.0.1 in a thread, answering
    ``tags``' readings (``values``' columns at TRAIN_START's 10-minute stamps,
    measurement ``sensors``, field ``Value``, Influx tag ``tag``) as its JSON
    with ``epoch=ns`` stamps: ``(port, seen, stop)``, ``seen`` each query's
    text, parameters and headers."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    from urllib.parse import parse_qs, urlsplit

    import numpy as np

    stamps = np.datetime64(TRAIN_START.replace(tzinfo=None), "ns").astype(np.int64) + 600 * 10**9 * np.arange(
        len(values), dtype=np.int64)
    pattern = re.compile(r"time >= (\d+) AND time < (\d+) AND \"tag\" = '([^']*)'")
    seen = []

    class Handler(BaseHTTPRequestHandler):
        def do_GET(self):
            params = {k: v[0] for k, v in parse_qs(urlsplit(self.path).query).items()}
            seen.append((params.get("q"), params, dict(self.headers)))
            match = pattern.search(params.get("q", ""))
            series = []
            if match and match.group(3) in tags:
                start, end = int(match.group(1)), int(match.group(2))
                inside = (stamps >= start) & (stamps < end)
                column = values[inside, tags.index(match.group(3))]
                series = [{"name": "sensors", "columns": ["time", "Value"],
                           "values": [[int(t), float(v)] for t, v in zip(stamps[inside], column)]}]
            body = json.dumps({"results": [{"statement_id": 0, **({"series": series} if series else {})}]}).encode()
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()

    def stop():
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        check(not thread.is_alive(), "the Influx server's thread did not stop")

    return server.server_port, seen, stop


def ingress_project(root, port, rows):
    """[ingress]'s sources on disk and its project config (JSON): the wide
    parquet file and the per-tag directory written by the port's writer (two
    of the directory's files copied from the fixtures), filtered-000's CSV
    and its row_filter, influx-000's provider at ``port``. Returns the
    config's path, the row_filter's text and the rows it keeps."""
    import numpy as np

    from gordo_tpu_torch.utils import parquet

    ticks = (np.datetime64(TRAIN_START.replace(tzinfo=None), "us").astype(np.int64)
             + 600 * 10**6 * np.arange(TRAIN_ROWS, dtype=np.int64))
    end = (TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)).isoformat()
    providers = {}
    tags, wide = rows["file-wide-000"]
    path = os.path.join(root, "file-wide-000.parquet")
    with open(path, "wb") as f:
        f.write(parquet.write_frame(tags, [wide[:, j] for j in range(len(tags))], ticks, "us", "UTC"))
    providers["file-wide-000"] = {"type": "FileDataProvider", "path": path}
    tags, per_tag = rows["file-tags-000"]
    directory = os.path.join(root, "file-tags-000")
    os.makedirs(directory)
    for j, tag in enumerate(tags):
        target = os.path.join(directory, f"{tag}.parquet")
        if tag in INGRESS_FIXTURE_TAGS:
            shutil.copyfile(os.path.join(HERE, INGRESS_FIXTURES, "tags", f"{tag}.parquet"), target)
        else:
            with open(target, "wb") as f:
                f.write(parquet.write_frame(["value"], [per_tag[:, j]], ticks, "us", "UTC"))
    providers["file-tags-000"] = {"type": "FileDataProvider", "path": directory}
    user, password = INGRESS_INFLUX_AUTH
    providers["influx-000"] = {"type": "InfluxDataProvider", "measurement": "sensors",
                               "uri": f"{user}:{password}@127.0.0.1:{port}/plant", "api_key": INGRESS_API_KEY,
                               "api_key_header": "X-Ingress-Key", "where_tags": {"site": "north"}}
    tags, filtered = rows["filtered-000"]
    providers["filtered-000"] = {"type": "FileDataProvider", "timestamp_column": "time",
                                 "path": write_csv(root, "filtered-000", tags, filtered)}
    text, keep = ingress_filter(filtered)
    machines = []
    for name in INGRESS_MACHINES:
        dataset = {"data_provider": providers[name], "tag_list": rows[name][0],
                   "train_start_date": TRAIN_START.isoformat(), "train_end_date": end}
        if name == "filtered-000":
            dataset["row_filter"] = text
        machines.append({"name": name, "model": DEFINITION, "dataset": dataset})
    config_path = os.path.join(root, "ingress.json")
    with open(config_path, "w") as f:
        json.dump({"machines": machines}, f, indent=1)
    return config_path, text, keep


def multipart_body(files):
    """``files`` (``{name: bytes}``) as a ``multipart/form-data`` body, as a
    client's upload writes it: ``(body, content type)``."""
    boundary = "ingress-" + os.urandom(8).hex()
    parts = []
    for name, data in files.items():
        parts.append(f'--{boundary}\r\nContent-Disposition: form-data; name="{name}"; filename="{name}"\r\n'
                     "Content-Type: application/octet-stream\r\n\r\n".encode() + data + b"\r\n")
    return b"".join(parts) + f"--{boundary}--\r\n".encode(), f"multipart/form-data; boundary={boundary}"


def ingress_phase(work_dir, card):
    """``[ingress]`` (see the module docstring). Returns the phase's K1
    launches and its K1 calls as cases with their launches."""
    import numpy as np
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.cli.cli import build_fleet, load_fleet_machines
    from gordo_tpu_torch.dataset import GordoBaseDataset
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.server import build_app, wire
    from gordo_tpu_torch.utils import parquet
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    root = os.path.join(work_dir, "ingress")
    os.makedirs(root)

    # the committed pyarrow files, decoded here without pyarrow
    fixtures = sorted(os.path.join(dirpath, name) for dirpath, _, files in os.walk(os.path.join(HERE, INGRESS_FIXTURES))
                      for name in files if name.endswith(".parquet"))
    check(len(fixtures) >= 5, f"the parquet fixtures are missing: {fixtures}")
    for path in fixtures:
        with open(path, "rb") as f:
            data = f.read()
        expected = np.load(path[: -len(".parquet")] + ".npz")
        frame = parquet.read_frame(data)
        index = parquet.timestamp_ns(frame.index) if frame.index.kind == "timestamp" else frame.index.values
        numeric = [(str(label), c.values) for label, c in zip(frame.labels, frame.columns) if c.kind != "timestamp"]
        check(np.array_equal(index, expected["index"]) and [n for n, _ in numeric] == list(expected["names"])
              and np.array_equal(np.column_stack([v for _, v in numeric]), expected["values"], equal_nan=True),
              f"{os.path.relpath(path, HERE)} decodes to other numbers than its .npz")
    fixture = os.path.join(HERE, INGRESS_FIXTURES, "tags", f"{INGRESS_FIXTURE_TAGS[0]}.parquet")
    with open(fixture, "rb") as f:
        data = f.read()
    decode_ms = []
    for _ in range(20):
        t0 = time.perf_counter()
        parquet.read_frame(data)
        decode_ms.append((time.perf_counter() - t0) * 1e3)
    phase("ingress", f"{len(fixtures)} parquet files pyarrow wrote (SNAPPY, GZIP and none; dictionary pages; data "
          f"pages v1 and v2; UTC, naive and Oslo indexes in ms, us and ns) decoded by the port's reader to the "
          f"numbers written beside them; {os.path.relpath(fixture, HERE)} ({len(data)} B, {TRAIN_ROWS} rows, "
          f"SNAPPY, RLE_DICTIONARY, page v1) in {min(decode_ms):.3f} ms (median {np.median(decode_ms):.3f}) on the "
          f"host")

    rows = ingress_rows()
    influx_tags, influx_values = rows["influx-000"]
    port, seen, stop_influx = influx_server(influx_values, influx_tags)
    try:
        config_path, row_filter, keep = ingress_project(root, port, rows)
        dropped = 1 - keep.mean()
        check(INGRESS_DROPPED[0] <= dropped <= INGRESS_DROPPED[1], f"the row_filter drops {dropped:.1%} of the rows")
        shard = os.path.join(root, "shard.json")
        with open(shard, "w") as f:
            f.write(normalize(config_path, INGRESS_PROJECT))
        out_dir = os.path.join(root, REVISION)
        with captured_build() as (forwards, fetched):
            fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
            t0 = time.perf_counter()
            code, builder = build_fleet(shard, out_dir, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            build_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
        check(code == 0 and not builder.build_errors, f"build-fleet exited {code}: {builder and builder.build_errors}")
        check(sorted(fetched) == sorted(INGRESS_MACHINES), f"the build fetched {sorted(fetched)}")
        check(len(forwards) == 1 and build_launches["K1"] == 1 and forwards[0][3] == 1,
              f"CV scoring launched K1 {[n for *_, n in forwards]} times for {len(forwards)} spec groups, not once")
        spec, stacked, X, _ = forwards[0]
        check(X.shape[0] == 3 * len(INGRESS_MACHINES) and X.shape[2] == 20, f"the CV forward's shape {X.shape}")
        cv_case = as_case(spec, stacked, X)
        queries = [q for q, _, _ in seen]
        expected_queries = [INGRESS_INFLUXQL.format(tag=tag) for tag in influx_tags]
        check(queries == expected_queries, f"the Influx server saw {queries[:2]}..., not the JAX provider's InfluxQL "
              f"{expected_queries[:2]}...")
        _, params, headers = seen[-1]
        auth = headers.get("Authorization", "").split()
        check(params.get("db") == "plant" and params.get("epoch") == "ns"
              and headers.get("X-Ingress-Key") == INGRESS_API_KEY and len(auth) == 2
              and base64.b64decode(auth[1]).decode() == ":".join(INGRESS_INFLUX_AUTH),
              f"the Influx reads' parameters {params} and headers {sorted(headers)}")
        fits, steps, fit_s, event_ms = fit_rates(builder)
        phase("ingress", f"build-fleet of {len(fetched)} machines (parquet wide file, per-tag parquet directory, "
              f"InfluxDB over HTTP, CSV under row_filter {row_filter!r}, {dropped:.1%} of its rows dropped; "
              f"hourglass20, 5 epochs, batch 32, TimeSeriesSplit(3)) on the card in {wall:.2f} s: "
              f"{build_phases(builder)}; "
              f"{steps} steps in {fit_s:.3f} s; K1 launches {build_launches['K1']} (the CV forward {tuple(X.shape)}), "
              f"K2 {build_launches['K2']}; the Influx server saw {len(queries)} queries, each the JAX provider's "
              f"InfluxQL byte for byte, with basic auth and the API key")

        # each machine's fetched X against its CSV twin's, and each source's fetch a machine
        machines = {m.name: m for m in load_fleet_machines(shard)}
        end = (TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)).isoformat()
        fetch_ms, twin_ms = {}, {}
        for name in INGRESS_MACHINES:
            tags, values = rows[name]
            twin = {"data_provider": {"type": "FileDataProvider", "timestamp_column": "time",
                                      "path": write_csv(root, f"{name}-twin", tags, values)},
                    "tag_list": tags, "train_start_date": TRAIN_START.isoformat(), "train_end_date": end}
            t0 = time.perf_counter()
            twin_X = GordoBaseDataset.from_dict(twin).get_data()[0]
            twin_ms[name] = (time.perf_counter() - t0) * 1e3
            if name == "filtered-000":
                twin_X = twin_X[keep]
            check(np.array_equal(fetched[name], twin_X), f"{name}: the build's X differs from its CSV twin's")
            t0 = time.perf_counter()
            again = machines[name].dataset.get_data()[0]
            fetch_ms[name] = (time.perf_counter() - t0) * 1e3
            check(np.array_equal(again, twin_X), f"{name}: a second fetch differs")
        phase("ingress", "each machine's X equal to its CSV twin's to the bit (filtered-000's after the same filter, "
              "written in numpy); a fetch a machine on the host (its source, then the CSV twin): "
              + ", ".join(f"{n} {fetch_ms[n]:.2f} ms against {twin_ms[n]:.2f} ms" for n in INGRESS_MACHINES))

        t0 = time.perf_counter()
        cpu, cpu_s = build_summaries(list(machines.values()), "cpu")
    finally:
        stop_influx()
    card_summaries = {n: build_summary(serializer.load(os.path.join(out_dir, n), "cpu"),
                                       serializer.load_metadata(os.path.join(out_dir, n))) for n in INGRESS_MACHINES}
    worst, faults = compare_builds(card_summaries, cpu)
    check(not faults, "the card's [ingress] build disagrees with the CPU's: " + "; ".join(faults[:5]))
    phase("ingress", f"card build against a CPU build of the {len(cpu)} machines from the same shard and sources "
          f"({cpu_s:.2f} s on the CPU): params max abs {worst[0]:.3e} (limit {BUILD_PARAM_ATOL}), thresholds max rel "
          f"{worst[1]:.3e} (limit {BUILD_THRESHOLD_RTOL}), CV scores max |d| / (1 + |cpu|) {worst[2]:.3e} (limit "
          f"{BUILD_SCORE_TOL}), epochs run equal")

    # the parquet routes on a card app, each request beside its JSON twin
    app = build_app(out_dir, device="cuda")
    check(len(app.store.fleet().warm()) == len(INGRESS_MACHINES), "not every [ingress] model loaded")
    base, stop = serving(app)
    try:
        wide_X = own_rows_frame("file-wide-000", rows)
        tags_X, tags_y = own_rows_frame("file-tags-000", rows), own_rows_frame("file-tags-000", rows, shift=0.5)
        requests = {
            "raw-parquet /prediction": ("/file-wide-000/prediction", {"X": wide_X}),
            "multipart-parquet /anomaly/prediction": ("/file-tags-000/anomaly/prediction", {"X": tags_X, "y": tags_y}),
        }
        json_answers = {label: raw_post(base + path, json.dumps(payload).encode(), "application/json")
                        for label, (path, payload) in requests.items()}
        raw_body = wire.dataframe_into_parquet_bytes(wire.decode_frame(wide_X))
        form_body, form_type = multipart_body({
            "X": wire.dataframe_into_parquet_bytes(wire.decode_frame(tags_X)),
            "y": wire.dataframe_into_parquet_bytes(wire.decode_frame(tags_y))})
        bodies = {"raw-parquet /prediction": (raw_body, wire.PARQUET_CONTENT_TYPE),
                  "multipart-parquet /anomaly/prediction": (form_body, form_type)}
        with captured_store_kernels() as calls:
            fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
            answers = {label: raw_post(base + path + "?format=parquet", *bodies[label])
                       for label, (path, _) in requests.items()}
            serve_launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    finally:
        stop()
        app.shutdown()
    check(serve_launches == {"K1": len(requests), "K2": 0}, f"the parquet requests launched {serve_launches}, not "
          f"K1 {len(requests)} (one a request)")
    for label, (status, body, headers, ms) in answers.items():
        json_status, json_body, json_headers, json_ms = json_answers[label]
        check(status == json_status == 200 and headers["Content-Type"] == "application/octet-stream",
              f"{label}: parquet answered {status} {headers.get('Content-Type')}, JSON {json_status}")
        table = wire.table_from_parquet_bytes(body)
        same_tree(json.loads(json_body)["data"], arrow_tree(table), label)
        check(headers["revision"] == json_headers["revision"] == REVISION, f"{label}: revision {headers['revision']}")
        phase("ingress", f"{label}: parquet {len(bodies[label][0])} B in, {len(body)} B out in {ms:.1f} ms "
              f"({stage_text(headers)}); JSON {len(json_body)} B out in {json_ms:.1f} ms ({stage_text(json_headers)}); "
              f"the parquet answer, read by the port's reader, equal to the JSON answer to the bit")
    check(len(calls) == len(requests) and all(kernel == "K1" and made == 1 for kernel, _, made in calls),
          f"[ingress]'s kernel calls {[(k, m) for k, _, m in calls]}")
    served_case = calls[0][1]
    check(tuple(served_case["X"].shape) == (1, ROWS, 20) and served_case["ingest"] is not None,
          f"the parquet request's K1 call: X {tuple(served_case['X'].shape)}")
    phase("ingress", f"K1 launches {serve_launches['K1']} (one a parquet request, counted where they launch), K2 "
          f"{serve_launches['K2']}; {card}")
    launches = {"K1": build_launches["K1"] + serve_launches["K1"], "K2": build_launches["K2"]}
    return launches, {INGRESS_CASES["cv"]: (cv_case, 1), INGRESS_CASES["served"]: (served_case, len(calls))}


# -- [mesh]: the device plane: raw-column transfer, the fleet over ranks, the ring -------

#: [train]'s machines the sharded build takes: 12 of 20 tags, 4 of 40
MESH_MACHINES = tuple(f"machine-{i:03d}" for i in range(12)) + tuple(f"compressor-{i:03d}" for i in range(4))
#: each rank's block of a width's CV fold models (3 folds x the width's machines, over 2 ranks)
MESH_CV = {20: "mesh rank CV fold scoring: hourglass20 M=18 B=500",
           WIDE_TAGS: "mesh rank CV fold scoring: hourglass40 M=6 B=500"}
#: the data-axis bucket: [train]'s first 8 20-tag machines' rows, scaled to [0, 1]
MESH_DATA_MEMBERS = 8
MESH_DATA_CONFIG = dict(epochs=2, batch_size=32, validation_split=0.1)
#: what the data axis is held to against one rank: the CPU test's tolerance (tests/test_torch_mesh.py)
MESH_DATA_RTOL, MESH_DATA_ATOL = 1e-5, 1e-6
#: the ring predict: rows of the series, cut over two devices (the one card, twice)
MESH_RING_ROWS = 16384
MESH_RING_RTOL, MESH_RING_ATOL = 1e-5, 1e-6
MESH_ENGINE_CLIENTS = 8
#: rounds of the two requests without an engine on each rung, the rungs' order alternating a round
MESH_INGEST_ROUNDS = 10
#: seconds the two ranks may take together, start to end
MESH_TIMEOUT = 300

#: one rank's process: ``python -c MESH_RANK <here> <args...>``
MESH_RANK = "import sys; sys.path.insert(0, sys.argv[1]); import chip_smoke; chip_smoke.mesh_rank(*sys.argv[2:])"


def mesh_rank(rank, shard, out_dir, result_path, data_port, data_path):
    """One rank of ``[mesh]`` (a process of its own, the ``JAX_*`` variables
    set by the phase): the ``build-fleet`` command's function over a
    two-rank gloo group on the card, its K1 launches counted from 0 and
    each CV forward captured; then the data-axis bucket at ``(1, 2)`` in a
    new group. Writes its results to ``result_path`` (pickle)."""
    import pickle

    import torch

    from gordo_tpu_torch.cli.cli import build_fleet
    from gordo_tpu_torch.models.training import FitConfig
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward
    from gordo_tpu_torch.parallel import fleet as fleet_module
    from gordo_tpu_torch.parallel.fleet import FleetTrainer
    from gordo_tpu_torch.parallel.mesh import initialize_backend, make_mesh, shutdown_backend

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank = int(rank)
    # each CV forward of this rank's block, as it reaches K1, with the launches it made
    forwards, launch = [], fleet_module.fleet_feedforward

    def captured(spec, stacked, x, *args, **kwargs):
        before = fleet_feedforward.launches
        out = launch(spec, stacked, x, *args, **kwargs)
        forwards.append((spec, {k: {n: t.cpu().numpy() for n, t in layer.items()} for k, layer in stacked.items()},
                         x.cpu().numpy(), fleet_feedforward.launches - before))
        return out

    fleet_module.fleet_feedforward = captured
    try:
        fleet_feedforward.launches = fleet_anomaly_scores.launches = 0
        t0 = time.perf_counter()
        code, builder = build_fleet(shard, out_dir, device="cuda:0", dist_backend="gloo")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"K1": fleet_feedforward.launches, "K2": fleet_anomaly_scores.launches}
    finally:
        fleet_module.fleet_feedforward = launch
    result = {"code": code, "wall": wall, "launches": launches, "forwards": forwards,
              "fits": builder.trainer.fits if builder else [], "phases": dict(builder.phase_seconds) if builder else {}}
    with open(data_path, "rb") as f:
        members = pickle.load(f)
    initialize_backend(f"localhost:{data_port}", 2, rank, backend="gloo", device="cuda:0")
    try:
        trainer = FleetTrainer(mesh=make_mesh(2, device="cuda"))
        t0 = time.perf_counter()
        trained = trainer.train(members, FitConfig(**MESH_DATA_CONFIG))
        torch.cuda.synchronize()
        result["data"] = {"wall": time.perf_counter() - t0, "coords": trainer.mesh.coords, "fits": trainer.fits,
                          "results": [(r.name, r.params, r.history.history, r.error) for r in trained]}
    finally:
        shutdown_backend()
    with open(result_path, "wb") as f:
        pickle.dump(result, f)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def arrow_bits(body):
    """An Arrow answer's index and every column's bytes, or its values when
    they are not numbers (what two rungs' answers must share to the bit)."""
    import numpy as np

    from gordo_tpu_torch.server import wire

    table, _ = wire.decode_response(body)
    return [table.index] + [(c.group, c.sub, values.tobytes() if values.dtype.kind in "fiub" else values.tolist())
                            for c in table.columns for values in [np.asarray(c.values)]]


def mesh_ingest(collection, names, wide_names, card):
    """Arrow anomaly requests (20 and 40 tags) on a card app without an
    engine, MESH_INGEST_ROUNDS rounds with GORDO_TPU_INGEST_DLPACK on and
    off in alternating order, and a round of MESH_ENGINE_CLIENTS
    concurrent ones through an engine on each rung: the answers equal to
    the bit across the rungs, the rung of each request counted, each
    rung's ``device_ingest`` (without an engine; the host rung stacks the
    columns there, the dlpack rung gathers them into the pinned buffer) and
    each rider's staging. Returns the K1 launches of all of them."""
    import numpy as np

    from gordo_tpu_torch.ingest import ingest_stats, reset_ingest_stats
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
    from gordo_tpu_torch.server import build_app, wire

    def arrow_body(name, n_tags):
        frame = wire.decode_frame(own_frame(name, n_tags))
        return wire.encode_request(frame, frame)

    single = [(names[0], arrow_body(names[0], 20)), (wide_names[0], arrow_body(wide_names[0], WIDE_TAGS))]
    round_ = [(n, arrow_body(n, 20)) for n in names[:MESH_ENGINE_CLIENTS]]
    plain_app = build_app(collection, device="cuda")
    check(plain_app.engine is None, "GORDO_TPU_BATCHING is set: [mesh]'s first app must have no engine")
    engine_app_, _ = engine_app(collection)

    def post_arrow(app, name, body):
        headers = {}
        status, answer = wsgi_call(app, "POST", f"/gordo/v0/smoke/{name}/anomaly/prediction", raw=body,
                                   content_type=ARROW_TYPE, headers={"Accept": ARROW_TYPE}, response_headers=headers)
        check(status == 200, f"[mesh] Arrow anomaly request for {name} answered {status}: {answer[:300]}")
        return answer, server_timing(headers)[0]

    answers = {"1": [], "0": []}
    ingest_ms = {(knob, width): [] for knob in ("1", "0") for width in (20, WIDE_TAGS)}
    decode_ms = {key: [] for key in ingest_ms}
    try:
        # one request of each width on each rung first, unread: the pinned staging buffers' first allocations
        for knob in ("1", "0"):
            os.environ["GORDO_TPU_INGEST_DLPACK"] = knob
            for name, body in single:
                post_arrow(plain_app, name, body)
        fleet_feedforward.launches = 0
        for round_i in range(MESH_INGEST_ROUNDS):
            for knob in ("1", "0") if round_i % 2 == 0 else ("0", "1"):
                os.environ["GORDO_TPU_INGEST_DLPACK"] = knob
                for (name, body), width in zip(single, (20, WIDE_TAGS)):
                    before = ingest_stats()
                    answer, stages = post_arrow(plain_app, name, body)
                    after = ingest_stats()
                    took = (after["dlpack_transfers"] - before["dlpack_transfers"],
                            after["host_transfers"] - before["host_transfers"])
                    check(took == ((1, 0) if knob == "1" else (0, 1)),
                          f"[mesh] GORDO_TPU_INGEST_DLPACK={knob}: a {width}-tag request took (dlpack, host) {took}; "
                          f"{after}")
                    ingest_ms[(knob, width)].append(stages.get("device_ingest", 0.0))
                    decode_ms[(knob, width)].append(stages.get("data_decode", 0.0))
                    if round_i == 0:
                        answers[knob].append(arrow_bits(answer))
        alone_k1 = fleet_feedforward.launches
        alone_line = "; ".join(
            f"{width} tags, {rung} rung: device_ingest median {np.median(ingest_ms[(knob, width)]):.4f} ms "
            f"(min {min(ingest_ms[(knob, width)]):.4f}, max {max(ingest_ms[(knob, width)]):.4f}), data_decode "
            f"median {np.median(decode_ms[(knob, width)]):.4f} ms"
            for width in (20, WIDE_TAGS) for knob, rung in (("1", "dlpack"), ("0", "host")))
        phase("mesh", f"ingest without an engine, {MESH_INGEST_ROUNDS} rounds of a 20- and a 40-tag Arrow anomaly "
              f"request ({ROWS} rows) on each rung, the rungs' order alternating a round: {alone_line}; "
              f"K1 launches {alone_k1}; {card}")
        round_k1 = {}
        for knob in ("1", "0"):
            os.environ["GORDO_TPU_INGEST_DLPACK"] = knob
            reset_ingest_stats()
            fleet_feedforward.launches = 0
            before = engine_app_.engine.stats()
            results = [None] * len(round_)

            def hit(i):
                results[i] = post_arrow(engine_app_, *round_[i])

            threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(round_))]
            for thread in threads:
                thread.start()
            for thread in threads:
                thread.join(timeout=300)
            check(all(r is not None for r in results), "[mesh] an engine request never returned")
            after = engine_app_.engine.stats()
            round_k1[knob] = fleet_feedforward.launches
            round_stats = ingest_stats()
            answers[knob] += [arrow_bits(a) for a, _ in results]
            rung = "dlpack" if knob == "1" else "host"
            served = round_stats["dlpack_transfers"] if knob == "1" else round_stats["host_transfers"]
            check(served == len(round_) and round_stats["dlpack_transfers"] == (served if knob == "1" else 0),
                  f"[mesh] with GORDO_TPU_INGEST_DLPACK={knob} the engine round's transfers were {round_stats}")
            staging = [t.get("batch_stack", 0.0) + t.get("device_ingest", 0.0) for _, t in results]
            phase("mesh", f"ingest, GORDO_TPU_INGEST_DLPACK={knob} (the {rung} rung): an engine round of "
                  f"{len(round_)} concurrent 20-tag Arrow anomaly requests: {after['batches'] - before['batches']} "
                  f"batches, a rider's batch_stack + device_ingest (its batch's staging into one pinned buffer "
                  f"and the copy's enqueueing) {', '.join(f'{ms:.3f}' for ms in staging)} ms, transfers "
                  f"{round_stats}; K1 launches {round_k1[knob]}; {card}")
    finally:
        os.environ.pop("GORDO_TPU_INGEST_DLPACK", None)
        engine_app_.shutdown()
    unequal = [i for i, (a, b) in enumerate(zip(answers["1"], answers["0"])) if a != b]
    check(not unequal, f"[mesh] the dlpack rung's answers {unequal} differ from the host rung's")
    launches = alone_k1 + sum(round_k1.values())
    check(alone_k1 >= 2 * len(single) * MESH_INGEST_ROUNDS and min(round_k1.values()) >= 1,
          f"[mesh] the ingest requests launched K1 {alone_k1} and {round_k1} times")
    phase("mesh", f"ingest: every answer of the dlpack rung equal to the host rung's to the bit "
          f"({len(answers['1'])} answers)")
    return launches


def mesh_ring(card):
    """An LSTM predict of a MESH_RING_ROWS-row series cut over two devices
    (the one card, twice) against the windowed forward on one."""
    import numpy as np
    import torch

    from gordo_tpu_torch.models.factories import lstm_model
    from gordo_tpu_torch.models.nn import forward_lstm_windows
    from gordo_tpu_torch.models.training import TorchRandom
    from gordo_tpu_torch.parallel import sequence

    spec = lstm_model(20, lookback_window=10, encoding_dim=(32, 16), encoding_func=("tanh", "tanh"),
                      decoding_dim=(16, 32), decoding_func=("tanh", "tanh"))
    params = {k: {n: torch.as_tensor(t, dtype=torch.float32).cuda() for n, t in layer.items()}
              for k, layer in TorchRandom().init_params(spec, 7).items()}
    X = (sensor_data(77, MESH_RING_ROWS, 20) / 100.0).astype(np.float32)
    os.environ[sequence.RING_PREDICT_ROWS_ENV] = str(MESH_RING_ROWS)
    try:
        check(sequence.ring_predict_enabled(MESH_RING_ROWS, ["cuda:0", "cuda:0"]), "the ring is not enabled")
    finally:
        del os.environ[sequence.RING_PREDICT_ROWS_ENV]
    t0 = time.perf_counter()
    ringed = sequence.ring_windowed_predict(spec, params, X, 10, 0, ["cuda:0", "cuda:0"])
    ring_s = time.perf_counter() - t0
    single = {k: {n: t[None] for n, t in layer.items()} for k, layer in params.items()}
    t0 = time.perf_counter()
    one = forward_lstm_windows(spec, single, torch.from_numpy(X).cuda()[None],
                               torch.arange(len(ringed), device="cuda")[None], 256)[0].cpu().numpy()
    one_s = time.perf_counter() - t0
    check(ringed.shape == one.shape == (MESH_RING_ROWS - 9, 20), f"ring output {ringed.shape}, one device {one.shape}")
    diff = float(np.abs(ringed - one).max())
    check(np.allclose(ringed, one, rtol=MESH_RING_RTOL, atol=MESH_RING_ATOL),
          f"the ring disagrees with one device: max abs {diff}")
    phase("mesh", f"ring predict: lstm_model(20; 32-16-16-32, lookback 10) over {MESH_RING_ROWS} rows cut over "
          f"[cuda:0, cuda:0] in {ring_s:.3f} s against the windowed forward on one device in {one_s:.3f} s: max abs "
          f"{diff:.3e} (rtol {MESH_RING_RTOL}, atol {MESH_RING_ATOL}); {card}")


def mesh_data_members():
    """The data-axis bucket: MESH_DATA_MEMBERS 20-tag machines' rows, each
    column scaled to [0, 1], as fleet members."""
    import numpy as np

    from gordo_tpu_torch.models.factories import feedforward_hourglass
    from gordo_tpu_torch.parallel.fleet import FleetMember

    members = []
    for i, (name, _, values) in enumerate(machine_rows()[:MESH_DATA_MEMBERS]):
        lo, hi = values.min(axis=0), values.max(axis=0)
        X = ((values - lo) / (hi - lo)).astype(np.float32)
        members.append(FleetMember(name, feedforward_hourglass(20), X, X, seed=60 + i))
    return members


def mesh_phase(work_dir, collection, names, wide_names, card):
    """``[mesh]`` (see the module docstring). Returns the K1 launches of
    its main path and each rank-0 CV forward as a K1 case with its
    launches, by width."""
    import pickle

    import numpy as np
    import torch

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.models.training import FitConfig
    from gordo_tpu_torch.parallel.fleet import FleetTrainer
    from gordo_tpu_torch.workflow.workflow_generator import normalize

    t_phase = time.perf_counter()
    ingest_k1 = mesh_ingest(collection, names, wide_names, card)
    root = os.path.join(work_dir, "mesh")
    os.makedirs(root)
    rows = {name: (tags, values) for name, tags, values in machine_rows() if name in MESH_MACHINES}
    config_path, _ = write_project(root, [(n, *rows[n]) for n in MESH_MACHINES], project="smoke")
    shard = os.path.join(root, "shard.json")
    with open(shard, "w") as f:
        f.write(normalize(config_path, "smoke"))
    data_path = os.path.join(root, "members.pkl")
    members = mesh_data_members()
    with open(data_path, "wb") as f:
        pickle.dump(members, f)

    coordinator, data_port = free_port(), free_port()
    outs = [os.path.join(root, f"rank{r}", REVISION) for r in range(2)]
    procs, logs = [], []
    t0 = time.perf_counter()
    try:
        for r in range(2):
            env = {**os.environ, "JAX_PROCESS_COUNT": "2", "JAX_PROCESS_INDEX": str(r),
                   "JAX_COORDINATOR_ADDRESS": f"localhost:{coordinator}", "PYTHONPATH": HERE}
            log = open(os.path.join(root, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-c", MESH_RANK, HERE, str(r), shard, outs[r], os.path.join(root, f"rank{r}.pkl"),
                 str(data_port), data_path], env=env, stdout=log, stderr=subprocess.STDOUT, cwd=root))
        deadline = time.monotonic() + MESH_TIMEOUT
        for proc in procs:
            try:
                proc.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                pass
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        for log in logs:
            log.close()
    ranks_s = time.perf_counter() - t0
    for r, proc in enumerate(procs):
        if proc.returncode != 0:
            with open(os.path.join(root, f"rank{r}.log")) as f:
                print(f.read()[-6000:], flush=True)
        check(proc.returncode == 0, f"[mesh] rank {r} exited {proc.returncode}")
    results = []
    for r in range(2):
        with open(os.path.join(root, f"rank{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    check(all(res["code"] == 0 for res in results), f"[mesh] build-fleet exited {[res['code'] for res in results]}")
    check(not os.path.exists(os.path.dirname(outs[1])), "[mesh] rank 1 wrote into its output directory")
    built = sorted(d for d in os.listdir(outs[0]) if os.path.isdir(os.path.join(outs[0], d)))
    check(built == sorted(MESH_MACHINES), f"[mesh] rank 0 wrote {built}")
    for name in ("build_status.json", "build_trace.jsonl", "fleet_plan.json"):
        check(os.path.exists(os.path.join(outs[0], name)), f"[mesh] rank 0 wrote no {name}")
    with open(os.path.join(outs[0], "fleet_plan.json")) as f:
        mesh_shape = json.load(f)["mesh_shape"]
    check(mesh_shape == [2, 1], f"[mesh] fleet_plan.json's mesh_shape {mesh_shape}")
    for r, res in enumerate(results):
        cv = {X.shape[-1]: (X.shape, n) for _, _, X, n in res["forwards"]}
        check(sorted(cv) == [20, WIDE_TAGS] and all(n == 1 for _, n in cv.values()) and res["launches"]["K1"] == 2,
              f"[mesh] rank {r}'s CV forwards {cv}, K1 launches {res['launches']}")
        phase("mesh", f"rank {r} of a (2, 1) mesh (gloo, both ranks on the one card): build-fleet of "
              f"{len(MESH_MACHINES)} machines in {res['wall']:.2f} s, its stacked fits "
              f"{[(f['members'], f['rows']) for f in res['fits']]}, CV forwards of its blocks "
              f"{[cv[w][0] for w in sorted(cv)]}, K1 launches {res['launches']['K1']} (one a width), K2 "
              f"{res['launches']['K2']}; phases {', '.join(f'{k} {v:.3f}' for k, v in res['phases'].items())} s")
    k1_ranks = [res["launches"]["K1"] for res in results]

    # the one-process card build of the same machines is [train]'s: the same rows, definition and seeds, in
    # one process on the one card (a member's fit does not depend on the bucket it shares)
    single_dir = collection

    def summaries(directory):
        out = {}
        for name in MESH_MACHINES:
            model = serializer.load(os.path.join(directory, name), "cpu")
            out[name] = build_summary(model, serializer.load_metadata(os.path.join(directory, name)))
        return out

    worst, faults = compare_builds(summaries(outs[0]), summaries(single_dir))
    check(not faults, "[mesh] the sharded build disagrees with the one-process build: " + "; ".join(faults[:5]))
    phase("mesh", f"sharded build (two ranks, {ranks_s:.2f} s with both processes' start) against [train]'s "
          f"one-process card build of the same {len(MESH_MACHINES)} machines: params max abs {worst[0]:.3e} "
          f"(limit {BUILD_PARAM_ATOL}), thresholds max rel {worst[1]:.3e} (limit {BUILD_THRESHOLD_RTOL}), CV scores "
          f"{worst[2]:.3e} (limit {BUILD_SCORE_TOL}); rank 1 wrote nothing; fleet_plan.json mesh_shape {mesh_shape}")

    data = [res["data"] for res in results]
    coords = [d["coords"] for d in data]
    check(coords == [(0, 0), (0, 1)], f"[mesh] data-axis coordinates {coords}")
    for (n0, p0, h0, e0), (n1, p1, h1, e1) in zip(data[0]["results"], data[1]["results"]):
        check(n0 == n1 and e0 is None and e1 is None and h0 == h1, f"[mesh] the data ranks disagree on {n0}")
        check(all(np.array_equal(p0[k][n], p1[k][n]) for k in p0 for n in p0[k]), f"[mesh] data ranks' {n0} params")
    t0 = time.perf_counter()
    alone = FleetTrainer("cuda").train(members, FitConfig(**MESH_DATA_CONFIG))
    torch.cuda.synchronize()
    alone_s = time.perf_counter() - t0
    param_diff = loss_diff = 0.0
    for (name, params, history, _), want in zip(data[0]["results"], alone):
        for key, layer in want.params.items():
            for leaf, value in layer.items():
                check(np.allclose(params[key][leaf], value, rtol=MESH_DATA_RTOL, atol=MESH_DATA_ATOL),
                      f"[mesh] (1, 2) {name} {key}/{leaf} beyond rtol {MESH_DATA_RTOL}, atol {MESH_DATA_ATOL}")
                param_diff = max(param_diff, float(np.abs(params[key][leaf] - value).max()))
        for metric, values in want.history.history.items():
            check(np.allclose(history[metric], values, rtol=MESH_DATA_RTOL, atol=MESH_DATA_ATOL),
                  f"[mesh] (1, 2) {name} {metric}")
            loss_diff = max(loss_diff, float(np.abs(np.asarray(history[metric]) - np.asarray(values)).max()))
    steps = sum(f["steps"] for f in data[0]["fits"])
    phase("mesh", f"data axis: {MESH_DATA_MEMBERS} 20-tag members of {TRAIN_ROWS} rows at (1, 2), each rank half of "
          f"every batch, the gradients all-reduced by gloo on CUDA tensors ({steps} steps, one flat buffer a step) in "
          f"{data[0]['wall']:.3f} s against (1, 1) in {alone_s:.3f} s: params max abs {param_diff:.3e}, losses "
          f"{loss_diff:.3e} (rtol {MESH_DATA_RTOL}, atol {MESH_DATA_ATOL}); both ranks' results equal; {card}")

    mesh_ring(card)
    if torch.cuda.device_count() > 1:
        nccl_dir = os.path.join(root, "nccl", REVISION)
        t0 = time.perf_counter()
        # the command line spawns one rank a visible card (the library call never spawns)
        code, _, err, _ = run_command(["build-fleet", shard, nccl_dir, "--device", "cuda"], timeout=MESH_TIMEOUT)
        check(code == 0, f"[mesh] the NCCL build across {torch.cuda.device_count()} cards exited {code}: "
              f"{err[-3000:]}")
        worst, faults = compare_builds(summaries(nccl_dir), summaries(single_dir))
        check(not faults, "[mesh] the NCCL build disagrees: " + "; ".join(faults[:5]))
        phase("mesh", f"NCCL across {torch.cuda.device_count()} cards (a rank a card): build-fleet in "
              f"{time.perf_counter() - t0:.2f} s, params max abs {worst[0]:.3e} from the one-process build")
    else:
        phase("mesh", "NCCL across cards: not run (one card visible)")

    cases = {}
    for spec, stacked, X, n in results[0]["forwards"]:
        cases[X.shape[-1]] = (as_case(spec, stacked, X), n)
    for width, name in MESH_CV.items():
        shape = (3 * sum(1 for m in MESH_MACHINES if (width == 20) == m.startswith("machine-")) // 2,
                 TRAIN_ROWS // 4, width)
        check(tuple(cases[width][0]["X"].shape) == shape, f"[mesh] rank 0's {width}-tag CV block "
              f"{tuple(cases[width][0]['X'].shape)}, not {shape}")
    launches = {"K1": ingest_k1 + sum(k1_ranks), "per_rank": k1_ranks}
    phase("mesh", f"K1 launches: ingest {ingest_k1}, the ranks' CV forwards {k1_ranks}; the phase took "
          f"{time.perf_counter() - t_phase:.1f} s; {card}")
    return launches, cases


# -- [deploy]: the deploy pod's commands -------------------------------------------------

#: [deploy]'s client predictions: two 20-tag machines and a 40-tag one, over the last DEPLOY_ROWS of
#: their own training rows (their dataset configs read the CSVs [train] wrote)
DEPLOY_PREDICT = ("machine-000", "machine-031", "compressor-002")
DEPLOY_ROWS = ROWS
#: the fleet request's window: the last day of the 64 machines' training rows
DEPLOY_FLEET_ROWS = 144
#: the server's batching window (ms): long enough that the burst waits in the engine when SIGTERM comes
DEPLOY_DELAY_MS = 3000
#: the burst's requests (machines past ENGINE_POISON), the wait before SIGTERM, the drain's grace and the
#: bound on the server's exit after the signal
DEPLOY_BURST = 8
DEPLOY_SIGNAL_AFTER_S = 1.0
DEPLOY_GRACE_S = 1.0
DEPLOY_EXIT_LIMIT_S = 60
#: the models ``score`` runs on, each on the card and on the CPU, and its K1 calls' names
DEPLOY_SCORE = ("machine-006", "compressor-001")
DEPLOY_SCORE_CASES = {20: "score: hourglass20 M=1 B=1008", WIDE_TAGS: "score: hourglass40 M=1 B=1008"}
DEPLOY_REVISION = 1700000000002
DRAIN_LINE = re.compile(r"drained in ([0-9.]+) s \((\d+) request thread\(s\) still answering\); kernel launches: "
                        r"K1 (\d+), K2 (\d+)")


def cli_run(*args):
    """``python -m gordo_tpu_torch ARGS`` in this process: ``(exit code,
    stdout, stderr)``."""
    import io

    from gordo_tpu_torch.cli.cli import main as cli_main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            code = cli_main(list(args))
        except SystemExit as exc:
            code = exc.code
    return code, out.getvalue(), err.getvalue()


@contextlib.contextmanager
def captured_estimator_k1():
    """While open, each K1 call of an estimator's ``predict`` on the card
    as ``(case, launches it made)``."""
    from gordo_tpu_torch.models import estimators
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward

    calls, original = [], estimators.fleet_feedforward

    def k1(spec, stacked, X, *args, **kwargs):
        before = fleet_feedforward.launches
        out = original(spec, stacked, X, *args, **kwargs)
        if X.is_cuda:
            calls.append((dict(spec=spec, bucket=stacked, X=X, indices=None, ingest=None),
                          fleet_feedforward.launches - before))
        return out

    estimators.fleet_feedforward = k1
    try:
        yield calls
    finally:
        estimators.fleet_feedforward = original


def same_tables(expected, got, what):
    """Two answers' tables: the same labels, index and strings; numbers
    within RTOL/ATOL (NaN where NaN). Returns the largest abs difference."""
    import numpy as np

    check([(c.group, c.sub) for c in got.columns] == [(c.group, c.sub) for c in expected.columns],
          f"{what}: columns differ")
    check(list(got.index) == list(expected.index), f"{what}: index differs")
    worst = 0.0
    for want, have in zip(expected.columns, got.columns):
        a, b = np.asarray(want.values), np.asarray(have.values)
        if a.dtype.kind != "f":
            check(list(a) == list(b), f"{what}: {want.group}|{want.sub} differs")
            continue
        check(bool(np.array_equal(np.isnan(a), np.isnan(b))), f"{what}: {want.group}|{want.sub} NaN cells differ")
        diff = np.abs(b.astype(np.float64) - a)[~np.isnan(a)]
        check(bool((diff <= ATOL + RTOL * np.abs(a[~np.isnan(a)])).all()),
              f"{what}: {want.group}|{want.sub} beyond rtol {RTOL}, atol {ATOL}: max abs {diff.max():.3e}")
        worst = max(worst, float(diff.max()) if diff.size else 0.0)
    return worst


def score_csv(path, name, n_tags):
    """``own_frame``'s rows of a machine as ``score --input``'s CSV: an
    unnamed index column of ISO times, then a column a tag."""
    frame = own_frame(name, n_tags)
    tags = list(frame)
    keys = list(frame[tags[0]])
    with open(path, "w") as f:
        f.write("," + ",".join(tags) + "\n")
        for key in keys:
            f.write(key + "," + ",".join(repr(frame[tag][key]) for tag in tags) + "\n")
    return path


def deploy_phase(work_dir, collection, names, wide_names, cpu_app, card):
    """The deploy pod's commands on [train]'s collection: see the
    module's docstring. Returns the server process's K1 and K2 launches
    (read on its drain's log line), ``score``'s K1 launches on the card
    and its K1 calls by width."""
    import numpy as np

    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
    from gordo_tpu_torch.server.wire import table_from_parquet_bytes

    t_phase = time.perf_counter()
    every = names + wide_names
    code, out, err = cli_run("wait-for-models", collection, *[a for n in every for a in ("--name", n)],
                             "--timeout", "5", "--poll-interval", "1")
    check(code == 0 and out.strip() == f"All {len(every)} models present in {collection}",
          f"wait-for-models exited {code}: {out!r} {err!r}")
    t0 = time.perf_counter()
    code, out, err = cli_run("wait-for-models", collection, "--name", names[0], "--name", "machine-absent",
                             "--timeout", "1", "--poll-interval", "1")
    check(code == 1 and err.strip() == "Error: Timed out after 1s waiting for models: machine-absent",
          f"wait-for-models of an absent model exited {code}: {err!r}")
    phase("deploy", f"wait-for-models: the {len(every)} models present, exit 0; with machine-absent, exit 1 after "
          f"{time.perf_counter() - t0:.2f} s naming it")

    root = os.path.join(work_dir, "deploy-root")
    revision = str(DEPLOY_REVISION)
    code, out, _ = cli_run("ensure-single-workflow", root, revision)
    check(code == 0 and out.strip() == f"Acquired deploy lock for revision {revision}", f"the lock: {code} {out!r}")
    code, _, err = cli_run("ensure-single-workflow", root, str(DEPLOY_REVISION - 1), "--check-only")
    check(code == 1 and "is stale and must not write" in err, f"--check-only of an older revision: {code} {err!r}")
    guard = os.path.join(root, ".deploy.guard", "owner-1-crashed")
    os.makedirs(guard)
    os.utime(guard, (time.time() - 3600,) * 2)
    code, out, _ = cli_run("ensure-single-workflow", root, str(DEPLOY_REVISION + 1))
    with open(os.path.join(root, "deploy.lock")) as f:
        held = json.load(f)["revision"]
    check(code == 0 and held == str(DEPLOY_REVISION + 1) and not os.path.exists(os.path.dirname(guard)),
          f"acquiring past a planted stale guard: {code}, lock {held}")
    phase("deploy", f"ensure-single-workflow: revision {revision} acquired; {DEPLOY_REVISION - 1} --check-only "
          f"stale, exit 1; a planted guard an hour old broken and {DEPLOY_REVISION + 1} acquired")

    port = free_port()
    log_path = os.path.join(work_dir, "deploy-server.log")
    args = ["run-server", "--batching", "--host", "127.0.0.1", "--port", str(port), "--batch-max-size", "64",
            "--batch-max-delay-ms", str(DEPLOY_DELAY_MS), "--batch-deadline-ms", "60000", "--no-serve-warmup",
            "--drain-grace-s", str(DEPLOY_GRACE_S), "--log-level", "info"]
    base = f"http://127.0.0.1:{port}"
    with open(log_path, "w") as log:
        t0 = time.perf_counter()
        proc = subprocess.Popen([sys.executable, "-m", "gordo_tpu_torch", *args], cwd=HERE, stdout=log,
                                stderr=subprocess.STDOUT, env={**os.environ, "MODEL_COLLECTION_DIR": collection})
        try:
            while True:
                try:
                    if http_call(f"{base}/healthcheck")[0] == 200:
                        break
                except OSError:
                    pass
                check(proc.poll() is None and time.perf_counter() - t0 < 120,
                      f"run-server did not come up: {open(log_path).read()[-2000:]}")
                time.sleep(0.1)
            healthy_s = time.perf_counter() - t0
            phase("deploy", f"run-server --batching on the card answered /healthcheck 200 after {healthy_s:.2f} s "
                  f"(a process of its own, {len(every)} models)")
            served = deploy_client_rounds(base, port, collection, names, wide_names, cpu_app, card)
            burst = deploy_drain(proc, base, names, cpu_app, log_path)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    text = open(log_path).read()
    found = DRAIN_LINE.findall(text)
    check(len(found) == 1, f"the server logged {len(found)} drain lines: {text[-2000:]}")
    drain_s, left, server_k1, server_k2 = float(found[0][0]), int(found[0][1]), int(found[0][2]), int(found[0][3])
    check("--workers, --worker-connections, --threads, --worker-class, --server-app, --with-prometheus-config are "
          "ignored" in text, "run-server did not log the gunicorn options it ignores")
    check(server_k1 >= 2 and server_k2 >= 1, f"the server launched K1 {server_k1} and K2 {server_k2} times")
    phase("deploy", f"SIGTERM with {DEPLOY_BURST} /prediction requests in the engine (window {DEPLOY_DELAY_MS} ms): "
          f"every one answered 200 in {min(burst['spent']):.3f}-{max(burst['spent']):.3f} s of its send (the drain, "
          f"not the window), each equal to the CPU app's (max abs {burst['diff']:.3e}); /healthcheck answered 503 "
          f"'draining' {burst['draining']} times; the drain took {drain_s} s ({left} request threads left), the "
          f"process exited 0 {burst['exit_s']:.2f} s after the signal (limit {DEPLOY_EXIT_LIMIT_S} s); counted in "
          f"the server's process (its drain's log line): K1 launches {server_k1}, K2 {server_k2}; {card}")

    t0 = time.perf_counter()
    outputs, launches, cases, worst = {}, 0, {}, (0.0, 0.0)
    for name in DEPLOY_SCORE:
        n_tags = WIDE_TAGS if name.startswith("compressor-") else 20
        csv_path = score_csv(os.path.join(work_dir, f"score-{name}.csv"), name, n_tags)
        for device in ("cuda", "cpu"):
            out_path = os.path.join(work_dir, f"score-{name}-{device}.parquet")
            with captured_estimator_k1() as calls:
                fleet_feedforward.launches = 0
                code, out, err = cli_run("score", os.path.join(collection, name), out_path, "--input", csv_path,
                                         "--device", device)
                made = fleet_feedforward.launches
            check(code == 0 and out.strip() == f"Scored {ROWS} rows -> {out_path}",
                  f"score {name} on {device}: {code} {out!r} {err!r}")
            with open(out_path, "rb") as f:
                outputs[device] = table_from_parquet_bytes(f.read())
            if device == "cuda":
                check(made == 1 and len(calls) == 1, f"score {name} on the card launched K1 {made} times")
                launches += made
                cases[n_tags] = calls[0]
            else:
                check(made == 0, f"score {name} on the CPU launched K1 {made} times")
        card_t, cpu_t = outputs["cuda"], outputs["cpu"]
        check([c.group for c in card_t.columns][:2] == ["start", "end"] and any(
            c.group.startswith("total-anomaly-confidence") for c in card_t.columns), f"score {name}: columns")
        same_tables(cpu_t, card_t, f"score {name}")
        for a, b in zip(cpu_t.columns, card_t.columns):
            a, b = np.asarray(a.values), np.asarray(b.values)
            if a.dtype.kind == "f" and (~np.isnan(a)).any():
                diff = np.abs(b.astype(np.float64) - a)[~np.isnan(a)]
                rel = diff / np.maximum(np.abs(a[~np.isnan(a)]), 1e-6)
                worst = (max(worst[0], float(diff.max())), max(worst[1], float(rel.max())))
    phase("deploy", f"score --input CSV of {', '.join(DEPLOY_SCORE)} ({ROWS} rows each) on the card and with "
          f"--device cpu: pipe-flattened parquet, {len(card_t.columns)} columns for the 40-tag one; card against "
          f"CPU max abs {worst[0]:.3e}, max rel {worst[1]:.3e} (rtol {RTOL}, atol {ATOL}); K1 launches on the card "
          f"{launches} (one a model, counted in this process) in {time.perf_counter() - t0:.2f} s; {card}")

    revisions_root = os.path.join(work_dir, "deploy-revisions")
    for r in (998, 999, 1000, 1001, 1002):
        os.makedirs(os.path.join(revisions_root, str(r)))
    code, out, _ = cli_run("cleanup-revisions", revisions_root, "999", "--keep", "2", "--dry-run")
    check(code == 0 and sorted(os.listdir(revisions_root)) == ["1000", "1001", "1002", "998", "999"]
          and out.strip().endswith("Revisions: 3 kept, 2 deleted (dry run)"), f"cleanup --dry-run: {code} {out!r}")
    code, out, _ = cli_run("cleanup-revisions", revisions_root, "999", "--keep", "2")
    check(code == 0 and sorted(os.listdir(revisions_root)) == ["1001", "1002", "999"], f"cleanup: {code} {out!r}")
    phase("deploy", f"cleanup-revisions of 998-1002, current 999, --keep 2: the dry run deleted nothing, the run kept "
          f"999, 1001 and 1002 ({out.strip()})")
    phase("deploy", f"the phase took {time.perf_counter() - t_phase:.1f} s: the server up in {healthy_s:.2f} s, its "
          f"drain {drain_s} s; client rounds {served['seconds']:.2f} s")
    return {"server": {"K1": server_k1, "K2": server_k2}, "score": launches}, cases


def deploy_client_rounds(base, port, collection, names, wide_names, cpu_app, card):
    """The port's ``Client`` against the server at ``port``: ``predict``
    (parquet) of DEPLOY_PREDICT, ``fleet_anomaly_scores`` over the 64,
    ``metadata`` and ``download-model``, every answer held to the CPU app's
    (the same client over ``WSGITransport``) for the same rows."""
    import numpy as np

    from gordo_tpu_torch import serializer
    from gordo_tpu_torch.client import Client, WSGITransport

    t_rounds = time.perf_counter()
    client = Client("smoke", host="127.0.0.1", port=port, scheme="http", use_parquet=True, device="cuda")
    reference = Client("smoke", transport=WSGITransport(cpu_app), use_parquet=True, device="cpu")
    end = TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)
    start = (end - timedelta(minutes=10 * DEPLOY_ROWS)).isoformat()
    t0 = time.perf_counter()
    got = client.predict(start, end.isoformat(), targets=list(DEPLOY_PREDICT))
    predict_s = time.perf_counter() - t0
    want = reference.predict(start, end.isoformat(), targets=list(DEPLOY_PREDICT))
    check([r.name for r in got] == [r.name for r in want] and sorted(r.name for r in got) == sorted(DEPLOY_PREDICT),
          "predict answered other machines")
    diff = 0.0
    for result, expected in zip(got, want):
        check(not result.error_messages and len(result.predictions.index) == DEPLOY_ROWS,
              f"predict {result.name}: {result.error_messages}")
        diff = max(diff, same_tables(expected.predictions, result.predictions, f"predict {result.name}"))
    phase("deploy", f"client predict (parquet) of {', '.join(DEPLOY_PREDICT)}, {DEPLOY_ROWS} rows of their own data "
          f"each: {predict_s:.2f} s, every frame equal to the CPU app's (max abs {diff:.3e})")

    fetched = {}
    fetch = client._data_for_window

    def recorded(machine, start_, end_):
        fetched[machine.name] = fetch(machine, start_, end_)
        return fetched[machine.name]

    client._data_for_window = recorded
    reference._data_for_window = lambda machine, start_, end_: fetched[machine.name]
    fleet_start = (end - timedelta(minutes=10 * DEPLOY_FLEET_ROWS)).isoformat()
    t0 = time.perf_counter()
    got = client.fleet_anomaly_scores(fleet_start, end.isoformat(), targets=names)
    fleet_s = time.perf_counter() - t0
    want = reference.fleet_anomaly_scores(fleet_start, end.isoformat(), targets=names)
    check(sorted(got) == sorted(want) == sorted(names), "fleet_anomaly_scores answered other machines")
    diff = 0.0
    for name, result in got.items():
        check(not result.error_messages and len(result.predictions.index) == DEPLOY_FLEET_ROWS,
              f"fleet {name}: {result.error_messages}")
        diff = max(diff, same_tables(want[name].predictions, result.predictions, f"fleet {name}"))
    phase("deploy", f"client fleet_anomaly_scores (lean) over the {len(names)} 20-tag machines, {DEPLOY_FLEET_ROWS} "
          f"rows each: {fleet_s:.2f} s with the data fetch, every entry equal to the CPU app's (max abs {diff:.3e})")

    targets = [names[0], wide_names[0]]
    check(client.get_metadata(targets) == reference.get_metadata(targets), "metadata differs from the CPU app's")
    downloaded = client.download_model([names[1]])[names[1]]
    on_disk = serializer.load(os.path.join(collection, names[1]), "cpu")
    got_params = downloaded.base_estimator.estimator.params_
    want_params = on_disk.base_estimator.estimator.params_
    check(all(got_params[k][n].device.type == "cuda" for k in got_params for n in got_params[k]),
          "the downloaded model is not on the card")
    check(all(np.array_equal(got_params[k][n].cpu().numpy(), want_params[k][n].numpy())
              for k in want_params for n in want_params[k]), "the downloaded model's params differ from the file's")
    phase("deploy", f"client metadata of {', '.join(targets)} equal to the CPU app's; download-model of {names[1]} "
          f"loaded on the card, its params equal to its model.pkl's")
    return {"seconds": time.perf_counter() - t_rounds}


def deploy_drain(proc, base, names, cpu_app, log_path):
    """DEPLOY_BURST concurrent ``/prediction`` requests, each machine's own
    next rows, queued in the server's engine; SIGTERM; ``/healthcheck``
    polled while the server drains; the answers held to the CPU app's."""
    candidates = [n for n in names if n != ENGINE_POISON][8:8 + DEPLOY_BURST]
    requests = [(f"/{n}/prediction", {"X": own_frame(n, 20)}) for n in candidates]
    answers, spent = [None] * len(requests), [None] * len(requests)

    def hit(i):
        t0 = time.perf_counter()
        answers[i] = post(f"{base}/gordo/v0/smoke{requests[i][0]}", requests[i][1])
        spent[i] = time.perf_counter() - t0

    threads = [threading.Thread(target=hit, args=(i,)) for i in range(len(requests))]
    for thread in threads:
        thread.start()
    time.sleep(DEPLOY_SIGNAL_AFTER_S)
    t_signal = time.perf_counter()
    proc.send_signal(signal.SIGTERM)
    draining = 0
    while proc.poll() is None:
        try:
            status, body = http_request(f"{base}/healthcheck", "GET")[:2]
        except OSError:
            break
        draining += status == 503 and body == b"draining"
        time.sleep(0.02)
    for thread in threads:
        thread.join(timeout=DEPLOY_EXIT_LIMIT_S)
    code = proc.wait(timeout=DEPLOY_EXIT_LIMIT_S)
    exit_s = time.perf_counter() - t_signal
    check(code == 0, f"run-server exited {code} after SIGTERM: {open(log_path).read()[-2000:]}")
    check(exit_s <= DEPLOY_EXIT_LIMIT_S, f"run-server took {exit_s:.1f} s to exit")
    check(draining >= 1, "/healthcheck never answered 503 while the server drained")
    check(all(answer is not None and answer[0] == 200 for answer in answers), f"burst answers {answers}")
    check(max(spent) < DEPLOY_DELAY_MS / 1e3, f"the burst waited {max(spent):.2f} s: the window, not the drain")
    diff = 0.0
    for (path, payload), (_, body, _) in zip(requests, answers):
        cpu_status, cpu_body = wsgi_post(cpu_app, "/gordo/v0/smoke" + path, payload)
        check(cpu_status == 200, f"the CPU app answered {cpu_status} on {path}")
        diff = max(diff, same_json(cpu_body["data"], body["data"]))
    return {"spent": spent, "draining": draining, "exit_s": exit_s, "diff": diff}


# -- [workflow]: workflow generate, and the rendered builder pod run on the card --------

#: the machines of the rendered workflow ([train]'s rows), the one whose builder logs to MLflow, and the
#: machine ``build --model-parameter`` builds
WORKFLOW_PROJECT = "smoke-workflow"
WORKFLOW_REVISION = "1700000000003"
WORKFLOW_MACHINES = ("machine-000", "machine-001", "compressor-000")
WORKFLOW_LOGGED = "machine-001"
WORKFLOW_TEMPLATED = "templated-000"
#: ``runtime.fleet.accelerator_type``: a slice of one host of one card
WORKFLOW_ACCELERATOR = "v5litepod-1"
#: the K1 row of the builder pod's CV forward of F tags, at the (M, B) its process logged
WORKFLOW_CV = "workflow build CV fold scoring: hourglass{F} M={M} B={B}"
#: the model of ``build --model-parameter``: DEFINITION with its epochs a template parameter
WORKFLOW_TEMPLATED_MODEL = (
    "gordo_tpu.models.anomaly.diff.DiffBasedAnomalyDetector:\n"
    "  base_estimator:\n"
    "    sklearn.pipeline.Pipeline:\n"
    "      steps:\n"
    "        - sklearn.preprocessing.MinMaxScaler\n"
    "        - gordo_tpu.models.estimators.JaxAutoEncoder:\n"
    "            kind: feedforward_hourglass\n"
    "            epochs: {{ n_epochs }}\n"
    "            batch_size: 32\n"
)
BUILD_LINE = re.compile(r"Fleet build complete: (\d+) built, (\d+) resumed, (\d+) failed; kernel launches: "
                        r"K1 (\d+), K2 (\d+); K1 launches by shape \(members x rows x tags\): (.*)")


def workflow_project(directory):
    """WORKFLOW_MACHINES as a project config (JSON text, which is YAML): a
    CRD document of FileDataProvider CSVs of [train]'s rows, DEFINITION in
    the globals, the fleet a slice of one card, InfluxDB on (the default)
    and remote logging on for WORKFLOW_LOGGED. Returns its path."""
    rows = {name: (tags, values) for name, tags, values in machine_rows() if name in WORKFLOW_MACHINES}
    end = (TRAIN_START + timedelta(minutes=10 * TRAIN_ROWS)).isoformat()
    machines = []
    for name in WORKFLOW_MACHINES:
        tags, values = rows[name]
        machine = {"name": name, "dataset": {
            "data_provider": {"type": "FileDataProvider", "path": write_csv(directory, name, tags, values),
                              "timestamp_column": "time"},
            "tag_list": tags, "train_start_date": TRAIN_START.isoformat(), "train_end_date": end}}
        if name == WORKFLOW_LOGGED:
            machine["runtime"] = {"builder": {"remote_logging": {"enable": True}}}
        machines.append(machine)
    config = {"apiVersion": "equinor.com/v1", "kind": "Gordo", "metadata": {"name": WORKFLOW_PROJECT},
              "spec": {"config": {"machines": machines, "globals": {
                  "model": DEFINITION, "runtime": {"fleet": {"accelerator_type": WORKFLOW_ACCELERATOR}}}}}}
    path = os.path.join(directory, f"{WORKFLOW_PROJECT}.yaml")
    with open(path, "w") as f:
        json.dump(config, f, indent=1)
    return path


def pod_env(container, replace):
    """A rendered container's ``env`` as a dict; a ``valueFrom`` entry
    takes its value from ``replace``, and so does a value ``replace`` names."""
    env = {}
    for var in container.get("env") or []:
        name = var["name"]
        env[name] = replace[name] if name in replace else var.get("value", "")
        check("valueFrom" not in var or name in replace, f"{name} takes its value from {var.get('valueFrom')}")
    return env


def workflow_phase(work_dir, card):
    """``workflow generate`` of WORKFLOW_MACHINES, then the rendered builder
    pod's own command, args and env run on the card with only its paths,
    its Postgres host and its MLflow directory replaced: see the module's
    docstring. Returns the K1 launches of its three builds (the pod's,
    counted in its process and read from its log line; the refused run's and
    the parameter build's, counted in this one), and the pod's CV forwards
    by width: its spec group's spec (its ``fleet_plan.json``), and the
    ``(M, B)`` and launches its process logged for that width."""
    from gordo_tpu_torch.builder import ModelBuilder
    from gordo_tpu_torch.machine import Machine
    from gordo_tpu_torch.models.spec import FeedForwardSpec
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
    from gordo_tpu_torch.reporters import PostgresReporter
    from gordo_tpu_torch.reporters.mlflow import get_machine_log_items
    from gordo_tpu_torch.reporters.pgstub import PostgresStub
    from gordo_tpu_torch.utils import yaml_lite
    from gordo_tpu_torch.workflow.manifest_validation import validate_manifests

    t_phase = time.perf_counter()
    root = os.path.join(work_dir, "workflow")
    os.makedirs(root)
    config_path = workflow_project(root)
    t0 = time.perf_counter()
    code, out, err = cli_run("workflow", "generate", "--machine-config", config_path, "--project-name",
                             WORKFLOW_PROJECT, "--project-revision", WORKFLOW_REVISION)
    generate_s = time.perf_counter() - t0
    check(code == 0, f"workflow generate exited {code}: {err[-2000:]}")
    t0 = time.perf_counter()
    documents = [d for d in yaml_lite.safe_load_all(out) if d]
    errors = validate_manifests(documents)
    validate_s = time.perf_counter() - t0
    check(not errors, f"the rendered manifests fail validation: {errors[:5]}")
    kinds = collections.Counter(d["kind"] for d in documents)
    phase("workflow", f"workflow generate of {len(WORKFLOW_MACHINES)} machines ({WORKFLOW_ACCELERATOR}, InfluxDB on, "
          f"remote logging for {WORKFLOW_LOGGED}): {len(documents)} documents ({dict(sorted(kinds.items()))}) in "
          f"{generate_s:.3f} s, its validation included; read back and validated again in {validate_s:.3f} s: "
          f"passed")

    shard_map = next(d for d in documents if d["kind"] == "ConfigMap" and "machines.yaml" in d.get("data", {}))
    job = next(d for d in documents if d["kind"] == "Job" and d["metadata"]["name"].startswith("gordo-fleet-"))
    pod = job["spec"]["template"]["spec"]
    container = pod["containers"][0]
    check(job["spec"]["parallelism"] == 1 and container["resources"]["limits"]["nvidia.com/gpu"] == 1
          and "cloud.google.com/gke-accelerator" in pod["nodeSelector"],
          f"the builder Job is not one pod of one card: {job['spec']['parallelism']}, {container['resources']}")
    postgres = next(d for d in documents if d["kind"] == "StatefulSet" and d["metadata"]["name"].startswith(
        "gordo-postgres-"))
    pg_env = {e["name"]: e.get("value") for e in postgres["spec"]["template"]["spec"]["containers"][0]["env"]}
    stub = PostgresStub(auth="scram", user=pg_env["POSTGRES_USER"], password=pg_env["POSTGRES_PASSWORD"])
    try:
        shard = yaml_lite.safe_load(shard_map["data"]["machines.yaml"])
        host = f"gordo-postgres-{WORKFLOW_PROJECT}"
        for machine in shard["machines"]:
            for reporter in machine["runtime"]["reporters"]:
                if isinstance(reporter, dict) and "gordo_tpu.reporters.postgres.PostgresReporter" in reporter:
                    kwargs = reporter["gordo_tpu.reporters.postgres.PostgresReporter"]
                    check(kwargs == {"host": host}, f"the injected Postgres reporter: {kwargs}")
                    kwargs.update(host="127.0.0.1", port=stub.port)
        shard_path = os.path.join(root, "machines.yaml")
        with open(shard_path, "w") as f:
            json.dump(shard, f)
        out_dir, register = os.path.join(root, "models"), os.path.join(root, "register")
        mlflow_dir, report_file = os.path.join(root, "mlruns"), os.path.join(root, "termination-log")
        paths = {"/etc/gordo/machines.yaml": shard_path,
                 f"/gordo/models/{WORKFLOW_PROJECT}/models/{WORKFLOW_REVISION}": out_dir}
        command = [sys.executable if part == "python" else part for part in container["command"]]
        args = [paths.get(part, part) for part in container["args"]]
        env = pod_env(container, {"JAX_PROCESS_INDEX": "0", "MODEL_REGISTER_DIR": register,
                                  "EXCEPTIONS_REPORTER_FILE": report_file})
        env["GORDO_TPU_MLFLOW_DIR"] = mlflow_dir
        phase("workflow", f"the builder pod's command {container['command'] + container['args']} run with: python -> "
              f"{sys.executable}; /etc/gordo/machines.yaml and the models path -> temporary files; MODEL_REGISTER_DIR "
              f"and EXCEPTIONS_REPORTER_FILE -> temporary paths; JAX_PROCESS_INDEX (the pod's completion index) -> 0; "
              f"the Postgres reporter's host {host} -> 127.0.0.1:{stub.port}, a SCRAM-SHA-256 stub with the "
              f"template's user and password; GORDO_TPU_MLFLOW_DIR -> a temporary directory added")
        log_path = os.path.join(root, "builder.log")
        t0 = time.perf_counter()
        with open(log_path, "w") as log:
            code = subprocess.run(command + args, cwd=HERE, stdout=log, stderr=subprocess.STDOUT, timeout=600,
                                  env={**os.environ, **env}).returncode
        pod_s = time.perf_counter() - t0
        text = open(log_path).read()
        check(code == 0, f"the builder pod's command exited {code}: {text[-3000:]}")
        found = BUILD_LINE.findall(text)
        check(len(found) == 1, f"the build logged {len(found)} completion lines")
        built, pod_k1 = int(found[0][0]), int(found[0][3])
        # the pod's K1 launches by X's shape, from its log line, and its spec groups, from its fleet_plan.json
        pod_shapes = {}
        for part in found[0][5].split(", "):
            dims, count = part.rsplit(" ", 1)
            M, B, F = map(int, dims.split("x"))
            check(F not in pod_shapes, f"the pod launched K1 at two {F}-tag shapes: {found[0][5]}")
            pod_shapes[F] = (M, B, int(count))
        with open(os.path.join(out_dir, "fleet_plan.json")) as f:
            buckets = {b["spec"]["n_features"]: b for b in json.load(f)["buckets"]}
        check(built == len(WORKFLOW_MACHINES) and sorted(pod_shapes) == sorted(buckets)
              and sum(n for _, _, n in pod_shapes.values()) == pod_k1
              and all(n == 1 and M % len(buckets[F]["members"]) == 0 for F, (M, _, n) in pod_shapes.items()),
              f"the pod built {built} machines with K1 launched {pod_k1} times by shape {found[0][5]}, not once "
              f"for each of its spec groups {sorted(buckets)}")
        pod_specs = {F: FeedForwardSpec.from_dict(b["spec"]) for F, b in buckets.items()}
        upserts = [s for s, _ in stub.statements if s.startswith("INSERT INTO machine")]
        check(len(upserts) == len(WORKFLOW_MACHINES) and sorted(stub.rows) == sorted(WORKFLOW_MACHINES),
              f"the stub took {len(upserts)} upserts for {sorted(stub.rows)}")
        check(all("{" not in s for s, _ in stub.statements), "JSON spliced into the SQL text")
        scores = {}
        for name in WORKFLOW_MACHINES:
            with open(os.path.join(out_dir, name, "metadata.json")) as f:
                artifact = json.load(f)
            row = json.loads(stub.rows[name][2])
            check(row == artifact["metadata"], f"{name}: the Postgres row's metadata differs from metadata.json's")
            scores[name] = artifact["metadata"]["build_metadata"]["model"]["cross_validation"]["scores"]
            check(bool(scores[name]), f"{name}: no CV scores")
        runs = os.listdir(os.path.join(mlflow_dir, WORKFLOW_LOGGED))
        check(sorted(os.listdir(mlflow_dir)) == [WORKFLOW_LOGGED] and len(runs) == 1,
              f"MLflow runs {os.listdir(mlflow_dir)}: one run of {WORKFLOW_LOGGED} expected")
        run_dir = os.path.join(mlflow_dir, WORKFLOW_LOGGED, runs[0])
        with open(os.path.join(out_dir, WORKFLOW_LOGGED, "metadata.json")) as f:
            logged = Machine.from_dict(json.load(f))
        key = ModelBuilder.calculate_cache_key(logged)
        with open(os.path.join(run_dir, "tags.json")) as f:
            tags = json.load(f)
        with open(os.path.join(run_dir, "batches.jsonl")) as f:
            batches = [json.loads(line) for line in f]
        metrics = [tuple(m[:2]) + (m[3],) for batch in batches for m in batch["metrics"]]
        expected = [(m.key, m.value, m.step) for m in get_machine_log_items(logged)[0]]
        check(tags == {"model_key": key} and key in os.listdir(os.path.join(register, "builds")),
              f"the run's tags {tags}, not the cache key {key} of the register")
        check(metrics == expected and open(os.path.join(run_dir, "status")).read() == "FINISHED",
              "the MLflow run's metrics differ from the build's CV scores")
        r2 = scores[WORKFLOW_MACHINES[0]]["r2-score"]["fold-mean"]
        groups = ", ".join(f"{F} tags, {len(b['members'])} members" for F, b in sorted(buckets.items()))
        phase("workflow", f"the builder pod's build-fleet on the card: exit 0 in {pod_s:.2f} s (a process of its "
              f"own); {len(upserts)} upserts over SCRAM-SHA-256 ({len(stub.scram)} logins), each row's metadata "
              f"equal to its metadata.json ({WORKFLOW_MACHINES[0]} r2 fold-mean {r2!r}); an MLflow run of "
              f"{WORKFLOW_LOGGED}, {len(metrics)} metrics equal to its CV scores, model_key {key[:12]}... the "
              f"register's key; K1 launches {pod_k1} (counted in the pod's process and logged by shape: "
              f"{found[0][5]}; the spec groups of its fleet_plan.json: {groups}); {card}")

        stub.refuse = True
        one = dict(shard, machines=shard["machines"][:1])
        with open(shard_path, "w") as f:
            json.dump(one, f)
        refused_dir = os.path.join(root, "refused")
        run_args = [refused_dir if part == out_dir else part for part in args]
        fleet_feedforward.launches = 0
        with environment(env):  # the first run's register: a cache hit, loaded and dumped, then reported
            code, _, err = cli_run(*run_args)
        refused_k1 = fleet_feedforward.launches
        name = WORKFLOW_MACHINES[0]
        check(code == 90 and "PostgresReporterException" in err and stub.refused,
              f"a refused password: exit {code}, {err[-1500:]}")
        check(os.path.isfile(os.path.join(refused_dir, name, "model.pkl")), "nothing dumped before the report")
        with open(report_file) as f:
            report = json.load(f)
        report = (report.get("traceback") or report.get("message") or "").strip().splitlines()[-1:]
        phase("workflow", f"the stub refusing the password: build-fleet of {name} (a cache hit in the register) "
              f"exited 90, its artifact dumped first; its termination report: {report}; K1 launches {refused_k1}")
    finally:
        stub.close()

    database = os.path.join(root, "reports.db")
    with open(config_path) as f:
        dataset = json.load(f)["spec"]["config"]["machines"][0]["dataset"]  # machine-000's rows
    config = {"name": WORKFLOW_TEMPLATED, "project_name": WORKFLOW_PROJECT, "model": WORKFLOW_TEMPLATED_MODEL,
              "dataset": dataset, "runtime": {"reporters": [{"gordo_tpu.reporters.postgres.PostgresReporter": {
                  "host": f"sqlite:///{database}"}}]}}
    one_dir = os.path.join(root, "one")
    fleet_feedforward.launches = 0
    t0 = time.perf_counter()
    code, out, err = cli_run("build", json.dumps(config), one_dir, "--print-cv-scores", "--model-parameter",
                             "n_epochs,1")
    one_s = time.perf_counter() - t0
    one_k1 = fleet_feedforward.launches
    check(code == 0, f"build --model-parameter exited {code}: {err[-2000:]}")
    lines = out.strip().splitlines()
    check(lines and all(re.fullmatch(r"[\w-]+_fold-[\w-]+=\S+", line) for line in lines),
          f"the CV score lines: {lines[:3]}")
    with open(os.path.join(one_dir, "metadata.json")) as f:
        artifact = json.load(f)
    row = PostgresReporter(host=f"sqlite:///{database}").fetch(WORKFLOW_TEMPLATED)
    check(row["metadata"] == artifact["metadata"] and row["model"] == artifact["model"],
          "the sqlite row differs from the build's metadata.json")
    check('"epochs": 1' in json.dumps(artifact["model"]), "the model parameter was not expanded")
    check(one_k1 == 3, f"build --model-parameter launched K1 {one_k1} times, not once a fold")
    phase("workflow", f"build --model-parameter n_epochs,1 of {WORKFLOW_TEMPLATED} (its model a template string) on "
          f"the card: exit 0 in {one_s:.2f} s, {len(lines)} CV score lines printed, its sqlite:/// row equal to its "
          f"metadata.json; K1 launches {one_k1} (a fold each)")
    phase("workflow", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    pod_cv = {F: (pod_specs[F], M, B, n) for F, (M, B, n) in pod_shapes.items()}
    return {"pod": pod_k1, "refused": refused_k1, "parameter": one_k1}, pod_cv


# -- [perfmodel]: the learned performance model, fitted on the card's own batches ------

#: the engines' ladders: three member rungs of the served 20-tag bucket, three row rungs
PERFMODEL_LADDERS = dict(max_size=16, max_delay_ms=25.0, deadline_ms=30000.0, row_ladder=(64, 256, 1024))
#: coalesced members and request rows of the corpus's f32 batches (each 3 times), and of its reduced ones
PERFMODEL_MEMBERS = (1, 4, 16)
PERFMODEL_ROWS = (50, 200, 1000)
PERFMODEL_REPEATS = 3
#: the machines the plan command plans with the fitted table: two 20-tag, one 40-tag
PERFMODEL_PLANNED = ("machine-000", "machine-001", "compressor-000")
#: the member an injected out-of-memory strikes in the capped engine's drill
PERFMODEL_OOM = "machine-003"


def own_matrix(name, rows):
    """A machine's next ``rows`` readings past its training rows, as the
    matrix a request carries (``own_frame``'s values, without the excursion)."""
    n_tags = WIDE_TAGS if name.startswith("compressor-") else 20
    seed = int(name.rsplit("-", 1)[1]) + (WIDE_SEED if name.startswith("compressor-") else 0)
    return sensor_data(seed, TRAIN_ROWS + rows, n_tags)[TRAIN_ROWS:].astype("float32")


def engine_batch(engine, fleet, names, rows):
    """One request of ``rows`` rows from each of ``names`` into ``engine``
    at once (a thread each, released together), to coalesce into one batch:
    each request's reconstruction rows, or None (not batched)."""
    results, barrier = [None] * len(names), threading.Barrier(len(names))
    matrices = [own_matrix(name, rows) for name in names]

    def send(i):
        barrier.wait()
        results[i] = engine.batched_predict(fleet, names[i], fleet.model(names[i]), matrices[i])

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(names))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=120)
    check(not any(thread.is_alive() for thread in threads), "a request of an engine batch never returned")
    return results


def trace_spans(directory, name):
    with open(os.path.join(directory, "serve_trace.jsonl")) as f:
        return [span for span in map(json.loads, f) if span.get("name") == name]


def perfmodel_phase(work_dir, collection, names, wide_names, shard, card):
    """The learned performance model on the card (see the module
    docstring): a corpus of real K1 batches, the fit and its gate, the
    commands, recalibration, the engine's consumers and the planner's.
    Returns the phase's K1 launches and its largest f32 batch as a K1 case."""
    import numpy as np

    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward
    from gordo_tpu_torch.perfmodel import maybe_recalibrate
    from gordo_tpu_torch.planner import CostModel, load_table_safe
    from gordo_tpu_torch.serve import precision
    from gordo_tpu_torch.serve.engine import ServeConfig, ServeEngine
    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.server import fleet_store
    from gordo_tpu_torch.telemetry import serving as serve_trace
    from gordo_tpu_torch.utils import faults

    t_phase = time.perf_counter()
    corpus_dir = tempfile.mkdtemp(prefix="perfmodel-corpus-", dir=work_dir)
    replay_dir = tempfile.mkdtemp(prefix="perfmodel-replay-", dir=work_dir)
    knobs = ("GORDO_TPU_PERFMODEL", "GORDO_TPU_PERFMODEL_TABLE", "GORDO_TPU_PERFMODEL_WARMUP",
             "GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES", "GORDO_TPU_PERFMODEL_BREAKER", "GORDO_TPU_PERFMODEL_PRECISION",
             "GORDO_TPU_PERFMODEL_RECAL")
    check(not any(os.environ.get(k) for k in knobs), "a GORDO_TPU_PERFMODEL knob is set before [perfmodel]")
    fleet_feedforward.launches = 0
    largest, launch = {}, fleet_store.fleet_feedforward

    def captured(spec, bucket, X, indices=None, ingest=None, **kwargs):
        if X.shape[0] * X.shape[1] > largest.get("size", 0) and X.shape[-1] == 20:
            largest.update(size=X.shape[0] * X.shape[1], case=dict(
                spec=spec, bucket=bucket, X=X, indices=[int(i) for i in indices], ingest=ingest))
        return launch(spec, bucket, X, indices=indices, ingest=ingest, **kwargs)

    engines, apps = [], []
    try:
        # 1. the corpus: real batches through a batching engine, every span exported
        with environment({"GORDO_TPU_TELEMETRY_DIR": corpus_dir, "GORDO_TPU_TRACE_SAMPLE_RATE": "1",
                          "GORDO_TPU_SERVE_WARMUP": "0"}):
            serve_trace.reset_serve_recorder()
            app = build_app(collection, device="cuda", serve_config=ServeConfig(**PERFMODEL_LADDERS))
            apps.append(app)
            fleet = app.store.fleet()
            check(len(fleet.warm()) == SERVED_MACHINES + WIDE_MACHINES, "not every model loaded")
            app.engine.warmup_fleet(fleet)
            fleet_store.fleet_feedforward = captured
            try:
                t0 = time.perf_counter()
                for _ in range(PERFMODEL_REPEATS):
                    for members in PERFMODEL_MEMBERS:
                        for rows in PERFMODEL_ROWS:
                            got = engine_batch(app.engine, fleet, names[:members], rows)
                            check(all(r is not None and r.shape == (rows, 20) for r in got),
                                  f"an f32 batch of {members} x {rows} rows was not scored")
                for members in (2, 4, 8):
                    got = engine_batch(app.engine, fleet, wide_names[:members], 200)
                    check(all(r is not None for r in got), f"a 40-tag batch of {members} was not scored")
                body = engine_body("anomaly/prediction", own_frame(names[0], 20))
                path = f"/gordo/v0/smoke/{names[0]}/anomaly/prediction"
                status, uncapped = wsgi_post(app, path, body)
                check(status == 200, f"{path} answered {status}")
            finally:
                fleet_store.fleet_feedforward = launch
            f32_stats = app.engine.stats()
            reduced = {}
            for prec in ENGINE_PRECISIONS:
                engine = ServeEngine(app.store, ServeConfig(serve_precision=prec, **PERFMODEL_LADDERS))
                engines.append(engine)
                engine.warmup_fleet(fleet)
                for rows in PERFMODEL_ROWS:
                    got = engine_batch(engine, fleet, names[:4], rows)
                    check(all(r is not None for r in got), f"a {prec} batch of 4 x {rows} rows was not scored")
                reduced[prec] = engine.stats()
                check(reduced[prec]["precision"]["coalesced"] == {prec: 12},
                      f"the {prec} engine coalesced {reduced[prec]['precision']['coalesced']}")
            serve_trace.serve_recorder().flush()
            corpus_s = time.perf_counter() - t0
        batches = f32_stats["batches"] + sum(s["batches"] for s in reduced.values())
        spans = trace_spans(corpus_dir, "serve_batch")
        check(len(spans) == batches, f"{len(spans)} serve_batch spans for {batches} engine batches")
        shapes = sorted({(s["attributes"]["precision"], s["attributes"]["padded_members"],
                          s["attributes"]["padded_rows"]) for s in spans})
        phase("perfmodel", f"corpus: {batches} engine batches in {corpus_s:.2f} s ({f32_stats['batches']} f32: "
              f"members {PERFMODEL_MEMBERS} x rows {PERFMODEL_ROWS} x {PERFMODEL_REPEATS} of the 20-tag bucket, 3 of "
              f"the 40-tag bucket, one JSON anomaly request of {ROWS} rows; "
              + ", ".join(f"{s['batches']} {p}" for p, s in reduced.items())
              + f"), each a serve_batch span of {len(shapes)} (precision, members, rows) shapes; K1 launches "
              f"{fleet_feedforward.launches}; {card}")

        # 2. the fit, as the command runs it, and its gate against the analytic ruler
        table = os.path.join(work_dir, "perfmodel-cost_table.json")

        def fit(*extra):
            proc = subprocess.run([sys.executable, "-m", "gordo_tpu_torch", "perfmodel", "fit", corpus_dir,
                                   "--table", table, *extra, "--as-json"], cwd=HERE, capture_output=True,
                                  text=True, timeout=300)
            check(proc.returncode == 0, f"perfmodel fit exited {proc.returncode}: {proc.stderr[-2000:]}")
            return json.loads(proc.stdout)

        t0 = time.perf_counter()
        report = fit()
        fit_s = time.perf_counter() - t0
        populations = report["corpus"]["rows_by_model"]
        check(populations.get("device_ms/fleet_forward", 0) >= 32 and "hbm_bytes/fleet_forward" not in populations,
              f"the corpus's populations: {populations}")
        phase("perfmodel", f"perfmodel fit (a process, {fit_s:.2f} s): {report['corpus']['rows']} rows from "
              f"{report['corpus']['spans']} spans, by model {populations}; fingerprint {report['fingerprint']}")
        for entry in report["models"]:
            phase("perfmodel", f"{entry['target']}/{entry['program']}: n={entry['n']}, holdout log-MAE learned "
                  f"{entry['holdout_mae_log']!r}, analytic {entry['analytic_mae_log']!r} (the JAX package's "
                  f"constants, not the card's); verdict: {entry['reason']}")
        phase("perfmodel", f"gate: {'PROMOTED' if report['promoted'] else 'not promoted'} ({report['reason']})")
        if not report["promoted"]:
            check(report["models"], "the fit had no model to gate")
            report = fit("--force")
            check(report["promoted"], f"perfmodel fit --force did not install: {report['reason']}")
            phase("perfmodel", f"the consumers below run on the forced table ({table}): perfmodel fit --force "
                  f"installed {[m['reason'] for m in report['models']]}")
        else:
            phase("perfmodel", f"the consumers below run on the promoted table ({table})")

        # 3. the other two commands on that table
        code, status_doc = cli_json("perfmodel", "status", "--table", table)
        check(code == 0 and status_doc["learned"] and status_doc["corpus"]["fingerprint"] == report["fingerprint"],
              f"perfmodel status: {code} {status_doc}")
        code, evaluation = cli_json("perfmodel", "eval", corpus_dir, "--table", table)
        check(code == 0 and evaluation["models"], f"perfmodel eval exited {code}")
        phase("perfmodel", "perfmodel status: " + "; ".join(
            f"{m['target']}/{m['program']} n={m['n']} holdout_mae_log={m['holdout_mae_log']}"
            for m in status_doc["models"]) + "; perfmodel eval over every row: " + "; ".join(
            f"{m['target']}/{m['program']} learned {m['learned_mae_log']} ({m['learned_scored']} of {m['rows']} in "
            f"its domain), analytic {m['analytic_mae_log']}" for m in evaluation["models"]))

        # 4. the lifecycle's recalibration over the same corpus: nothing new, nothing refitted
        with environment({"GORDO_TPU_PERFMODEL_RECAL": "1"}):
            before = open(table).read()
            recal = maybe_recalibrate(corpus_dir, table_path=table)
        check(recal is not None and recal["reason"] == "corpus unchanged since incumbent fit"
              and open(table).read() == before, f"recalibration over the unchanged corpus: {recal}")
        phase("perfmodel", f"maybe_recalibrate (GORDO_TPU_PERFMODEL_RECAL=1) over the same corpus: "
              f"{recal['reason']}, the table unchanged")

        # 5. a second engine under every consumer knob
        spec20 = fleet.loaded_specs()[names[0]]
        spec40 = fleet.loaded_specs()[wide_names[0]]
        model = CostModel(load_table_safe(table), use_learned=True)
        top = PERFMODEL_LADDERS["max_size"]
        budget = model.predict_serve_hbm_bytes(spec20, top, PERFMODEL_LADDERS["row_ladder"][1], "f32")
        with environment({"GORDO_TPU_TELEMETRY_DIR": replay_dir, "GORDO_TPU_TRACE_SAMPLE_RATE": "1",
                          "GORDO_TPU_SERVE_WARMUP": "0", "GORDO_TPU_PERFMODEL": "1",
                          "GORDO_TPU_PERFMODEL_TABLE": table, "GORDO_TPU_PERFMODEL_WARMUP": "1",
                          "GORDO_TPU_PERFMODEL_BATCH_CAP_BYTES": str(budget), "GORDO_TPU_PERFMODEL_BREAKER": "1",
                          "GORDO_TPU_PERFMODEL_PRECISION": "1"}):
            serve_trace.reset_serve_recorder()
            capped = build_app(collection, device="cuda", serve_config=ServeConfig(**PERFMODEL_LADDERS))
            apps.append(capped)
            capped_fleet = capped.store.fleet()
            check(len(capped_fleet.warm()) == SERVED_MACHINES + WIDE_MACHINES, "not every model loaded")
            engine = capped.engine
            warm = engine.warmup_fleet(capped_fleet)
            warm_rows = max(r for r in PERFMODEL_LADDERS["row_ladder"] if r <= engine.config.warmup_max_rows)
            predicted = {s.n_features: engine._predicted_step_ms(s, top, warm_rows, "f32") for s in warm["order"]}
            hot_first = sorted(warm["order"], key=lambda s: (
                -engine._cost_model().predict_serve_step_s(s, top, warm_rows, "f32"), repr(s)))
            check(warm["order"] == hot_first and warm["programs"] == 2, f"warmup ran {warm}, predicted {predicted}")
            caps = {s.n_features: engine._model_row_cap(s, "f32") for s in (spec20, spec40)}
            check(caps[20] == PERFMODEL_LADDERS["row_ladder"][1], f"the byte budget capped the 20-tag rows at {caps}")
            nominations = {s.n_features: precision.model_preferred(s, top, warm_rows, engine._cost_model())
                           for s in (spec20, spec40)}
            phase("perfmodel", f"second engine (GORDO_TPU_PERFMODEL=1, _TABLE, _WARMUP, _BATCH_CAP_BYTES={budget}, "
                  f"_BREAKER, _PRECISION): warmup order (hot first) "
                  + ", ".join(f"hourglass{n} {predicted[n]!r} ms predicted at {top} x {warm_rows}"
                              for n in [s.n_features for s in warm["order"]])
                  + f"; row caps by the byte budget (predict_serve_hbm_bytes of {top} members x "
                  f"{PERFMODEL_LADDERS['row_ladder'][1]} rows at 20 tags): hourglass20 {caps[20]}, hourglass40 "
                  f"{caps[40]} (ladder {PERFMODEL_LADDERS['row_ladder']}); precision nomination at {top} x "
                  f"{warm_rows}: "
                  + ", ".join(f"hourglass{n} {p or 'none (f32 stays)'}" for n, p in nominations.items()))

            # beyond the cap: unbatched, and the same answer to the bit as the uncapped engine's batch
            before = engine.stats()
            k1 = fleet_feedforward.launches
            status, capped_answer = wsgi_post(capped, path, body)
            after = engine.stats()
            check(status == 200 and after["fallback"] == before["fallback"] + 1 and after["batches"] ==
                  before["batches"], f"the request beyond the cap: {status}, {before['fallback']} -> "
                  f"{after['fallback']} fallbacks")
            check(capped_answer["data"] == uncapped["data"], "the capped engine's unbatched answer differs from the "
                  "uncapped engine's batched one")
            phase("perfmodel", f"POST {path} ({ROWS} rows, over the {caps[20]}-row cap): 200 unbatched (fallback "
                  f"+1, no batch, K1 launches {fleet_feedforward.launches - k1}), its data equal to the uncapped "
                  f"engine's batched answer to the bit")

            # a replay within the cap, for the trace's learned predictions, and the OOM drill
            for members in PERFMODEL_MEMBERS:
                for rows in PERFMODEL_ROWS[:2]:
                    got = engine_batch(engine, capped_fleet, names[:members], rows)
                    check(all(r is not None for r in got), f"a replayed batch of {members} x {rows} was not scored")
            with faults.inject(faults.FaultRule("serve_device_program", match=f"*{PERFMODEL_OOM}", times=1)):
                got = engine_batch(engine, capped_fleet, names[:8], PERFMODEL_ROWS[1])
            check(all(r is not None for r in got), "a rider of the OOM drill's batch was not scored")
            serve_trace.serve_recorder().flush()
            demoted = trace_spans(replay_dir, "serve_rung_demoted")
            stats = engine.stats()
            check(stats["rung_demotions"] == 1 and len(demoted) == 1
                  and demoted[0]["attributes"]["model_informed"] is True,
                  f"the OOM drill: {stats['rung_demotions']} demotions, events {demoted}")
            event = demoted[0]["attributes"]
            phase("perfmodel", f"injected RESOURCE_EXHAUSTED at serve_device_program in a batch of 8 x "
                  f"{PERFMODEL_ROWS[1]} rows: every rider answered (batch_bisects {stats['batch_bisects']}), the "
                  f"{event['axis']} ladder capped at {event['cap']} ({event['precision']}), model_informed "
                  f"{event['model_informed']} (the fixed heuristic would halve to 4)")
        serve_trace.reset_serve_recorder()

        # 6. the trace report: the first run's analytic predictions against the replay's learned ones
        accuracy = {}
        for label, directory in (("analytic (corpus)", corpus_dir), ("learned (replay)", replay_dir)):
            code, doc = cli_json("trace", directory)
            check(code == 0 and doc.get("prediction_accuracy"), f"trace {directory} exited {code}")
            accuracy[label] = doc["prediction_accuracy"]["serve_batch"]
        phase("perfmodel", "trace report's prediction accuracy of serve_batch: " + "; ".join(
            f"{label}: {a['count']} batches, error_p50 {a['error_p50']}, error_p95 {a['error_p95']}, bias "
            f"{a['bias']}" for label, a in accuracy.items()) + f"; {card}")

        # 7. the planner with the table
        with open(shard) as f:
            doc = json.load(f)
        doc["machines"] = [m for m in doc["machines"] if m["name"] in PERFMODEL_PLANNED]
        small = os.path.join(work_dir, "perfmodel-shard.json")
        with open(small, "w") as f:
            json.dump(doc, f)
        plans = {}
        for knob in ("0", "1"):
            code, out = cli_stdout("plan", small, "--device", "cuda", "--strategy", "packed", "--cost-table", table,
                                   "--as-json", env={"GORDO_TPU_PERFMODEL": knob})
            check(code == 0, f"plan with GORDO_TPU_PERFMODEL={knob} exited {code}")
            plans[knob] = json.loads(out)
        check(plans["1"]["cost_table"]["learned"] is True and plans["0"]["cost_table"]["learned"] is False,
              f"the plans' learned: {plans['0']['cost_table']}, {plans['1']['cost_table']}")
        phase("perfmodel", f"plan of {len(doc['machines'])} machines with the table: GORDO_TPU_PERFMODEL=1 "
              f"cost_table.learned {plans['1']['cost_table']['learned']}, predicted_wall_s "
              f"{plans['1']['totals']['predicted_wall_s']} (knob off: learned {plans['0']['cost_table']['learned']}, "
              f"{plans['0']['totals']['predicted_wall_s']}; the table has no training-program model, so the "
              f"buckets cost analytic either way)")
    finally:
        for engine in engines:
            engine.shutdown()
        for app in apps:
            app.shutdown()
        serve_trace.reset_serve_recorder()
    case = largest.get("case")
    check(case is not None, "no coalesced 20-tag f32 batch was captured")
    phase("perfmodel", f"the phase took {time.perf_counter() - t_phase:.1f} s")
    return {"K1": fleet_feedforward.launches}, case


def own_rows_frame(name, rows, shift=0.0):
    """ROWS of an [ingress] machine's readings past its training rows, as a
    JSON frame (the seeded machines' own continuation; file-tags-000's
    fixture tags continue as seeded data), plus ``shift``."""
    tags, _ = rows[name]
    values = sensor_data(INGRESS_SEED + INGRESS_MACHINES.index(name), TRAIN_ROWS + ROWS, 20)[TRAIN_ROWS:] + shift
    keys = [(TRAIN_START + timedelta(minutes=10 * (TRAIN_ROWS + r))).isoformat() for r in range(ROWS)]
    return {tag: dict(zip(keys, values[:, j].tolist())) for j, tag in enumerate(tags)}


def cuda_ms(fn, iters=20, warmup=3):
    """Device ms per call: CUDA events around ``iters`` calls queued behind
    a device sleep that outlasts their enqueueing twice over, so the host's
    time (Python, ctypes) is hidden and the events see only the device's
    work. ``fn`` must not synchronise with the device."""
    import torch

    t0 = time.perf_counter()
    for _ in range(warmup):
        fn()
    host_s = (time.perf_counter() - t0) / warmup
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(max(1e7, 2 * host_s * iters * 2e9)))  # cycles; the SM clock is below 2 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_report(log):
    """``"<kernel>: <registers>, <spills>"`` for each entry function in
    ``nvcc -Xptxas -v``'s output; kernels named ``narrow<S>`` (S lanes a
    row) and ``wide<resident|streamed, 8|16>`` (the member's weights
    staged once or streamed through the ring; at most 8 or 16 fragments a
    warp)."""
    import re

    report, name, spills = [], None, ""
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            wide = re.search(r"wide_kernelILb([01])ELb([01])E", entry.group(1))
            narrow = re.search(r"narrow_kernelILi(\d+)E", entry.group(1))
            name = f"wide<{'resident' if wide.group(1) == '1' else 'streamed'}, {16 if wide.group(2) == '1' else 8}>" \
                if wide else \
                f"narrow<{narrow.group(1)}>" if narrow else \
                "narrow" if "narrow_kernel" in entry.group(1) else entry.group(1)
        elif "spill" in line:
            spills = line.strip()
        elif "registers" in line and name:
            used = re.search(r"Used (\d+) registers", line)
            report.append(f"{name}: {used.group(1) if used else '?'} registers, {spills}")
            name = None
    return report


def narrow_plan(case):
    """``(lanes a row, shared memory bytes a block, blocks an SM, grid)``
    of the narrow kernel at ``case``'s shape, as its launch works them out."""
    import ctypes

    from gordo_tpu_torch.ops import _build

    fn = _build.load("fleet_dense").fleet_dense_narrow_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 4
    fn.restype = ctypes.c_int
    widths = case["spec"].widths()
    dims = (ctypes.c_int * len(widths))(*widths)
    M, B, _ = case["X"].shape
    out = [ctypes.c_int() for _ in range(4)]
    status = fn(len(widths) - 1, ctypes.cast(dims, ctypes.c_void_p), M, B, *map(ctypes.byref, out))
    check(status == 0, f"fleet_dense_narrow_occupancy returned {status}")
    return tuple(v.value for v in out)


def wide_plan(case):
    """``(resident, rows a tile, warps a 16-row slice, shared memory bytes a
    block, blocks an SM, grid)`` of the wide kernel at ``case``'s shape, as
    its launch works them out."""
    import ctypes

    from gordo_tpu_torch.ops import _build

    fn = _build.load("fleet_dense").fleet_dense_wide_occupancy
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 6
    fn.restype = ctypes.c_int
    widths = case["spec"].widths()
    dims = (ctypes.c_int * len(widths))(*widths)
    M, B, _ = case["X"].shape
    out = [ctypes.c_int() for _ in range(6)]
    status = fn(len(widths) - 1, ctypes.cast(dims, ctypes.c_void_p), M, B, *map(ctypes.byref, out))
    check(status == 0, f"fleet_dense_wide_occupancy returned {status}")
    return tuple(v.value for v in out)


def library_chain(case):
    """cuBLAS ``baddbmm`` per layer over pre-gathered params: the library
    yardstick for the same function (in full f32 unless the caller lets
    cuBLAS use TF32, see :func:`with_tf32`)."""
    import torch

    from gordo_tpu_torch.ops.activations import resolve_activation

    spec, bucket, X = case["spec"], case["bucket"], case["X"]
    idx = torch.as_tensor(case["indices"] if case["indices"] is not None else range(X.shape[0]),
                          device=X.device)
    layers = [(bucket[k]["W"][idx].contiguous(), bucket[k]["b"][idx][:, None, :].contiguous(),
               resolve_activation(a)) for k, a in spec.layer_names()]
    ingest = None
    if case["ingest"] is not None:
        ingest = (case["ingest"][0][idx][:, None, :], case["ingest"][1][idx][:, None, :])

    def run():
        h = X if ingest is None else torch.addcmul(ingest[1], X, ingest[0])
        for W, b, act in layers:
            h = act(torch.baddbmm(b, h, W))
        return h

    return run


def bound(case):
    """(bound_ms, bound_by, cuda_core_ms): each input read once and each
    output written once against HBM, and 2 flops per multiply-add against
    the card's fastest f32-accurate rate, the tensor cores' 3xTF32
    (``PEAK_3XTF32_FLOP_PER_S``); ``cuda_core_ms`` is the same bound at the
    f32 rate outside the tensor cores (67 TFLOP/s), the bound before the
    wide kernel used them, kept for the record. With K2's targets
    ``case["y"]``: 4 more bytes a row for the mse, y's bytes when y is not
    X, and 3 flops a compared column."""
    spec, X = case["spec"], case["X"]
    M, B, _ = X.shape
    # only the members the batch reads: a gather touches len(set(indices)) rows
    n = case["bucket"]["out"]["W"].shape[0] if case["indices"] is None else len(set(case["indices"]))
    widths = spec.widths()
    macs = sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1))
    params = n * (macs + sum(widths[1:]))
    byte_count = 4 * (X.numel() + M * B * spec.n_features_out + params + M)
    if case["ingest"] is not None:
        byte_count += 4 * 2 * n * spec.n_features
    flops = 2 * M * B * macs
    y = case.get("y")
    if y is not None:
        byte_count += 4 * M * B + (0 if y is X else 4 * y.numel())
        flops += 3 * M * B * min(spec.n_features_out, y.shape[-1])
    byte_ms = byte_count / PEAK_BYTES_PER_S * 1e3
    flop_ms = flops / PEAK_3XTF32_FLOP_PER_S * 1e3
    cuda_core_ms = max(byte_ms, flops / PEAK_F32_FLOP_PER_S * 1e3)
    return max(byte_ms, flop_ms), "bytes" if byte_ms >= flop_ms else "operations", cuda_core_ms


def with_tf32(fn):
    """``fn`` with cuBLAS allowed TF32 (one product, ~3 decimal digits):
    what the library gives on the tensor cores, less accurate than the
    kernel's 3xTF32; the yardstick stays the f32 chain."""
    import torch

    def run():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return fn()
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    return run


def times(case):
    """K1, its plain version, the f32 ``baddbmm`` chain, the chain with
    TF32, and the bounds."""
    from gordo_tpu_torch.ops.fleet_dense import fleet_feedforward, fleet_feedforward_reference

    args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
    kernel = cuda_ms(lambda: fleet_feedforward(*args))
    plain = cuda_ms(lambda: fleet_feedforward_reference(*args))
    library = cuda_ms(library_chain(case))
    library_tf32 = cuda_ms(with_tf32(library_chain(case)))
    return (kernel, plain, library, library_tf32, *bound(case))


def scores_times(case):
    """K2, its plain version, the library yardstick (the ``baddbmm`` chain
    and ``torch.square(out - y).mean(-1)``) in f32 and with TF32, K1 alone
    at the same shape, and the bounds."""
    import torch

    from gordo_tpu_torch.ops.fleet_dense import (
        fleet_anomaly_scores,
        fleet_anomaly_scores_reference,
        fleet_feedforward,
    )

    y = case["y"]
    w = min(case["spec"].n_features_out, y.shape[-1])
    args = (case["spec"], case["bucket"], case["X"], y, case["indices"], case["ingest"])
    chain = library_chain(case)

    def library():
        out = chain()
        return out, torch.square(out[..., :w] - y[..., :w]).mean(-1)

    kernel = cuda_ms(lambda: fleet_anomaly_scores(*args))
    plain = cuda_ms(lambda: fleet_anomaly_scores_reference(*args))
    library_ms = cuda_ms(library)
    library_tf32 = cuda_ms(with_tf32(library))
    k1 = cuda_ms(lambda: fleet_feedforward(*args[:3], *args[4:]))
    return (kernel, plain, library_ms, library_tf32, k1, *bound(case))


# -- main ------------------------------------------------------------------------------


def main():
    try:
        import torch
    except ImportError:
        raise SmokeFailure("torch is not installed")
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke test needs a GPU")
    sys.path.insert(0, HERE)
    try:
        import gordo_tpu_torch
    except ImportError as exc:
        raise SmokeFailure(f"gordo_tpu_torch is not importable beside this script: {exc}")
    package_dir = os.path.dirname(os.path.abspath(gordo_tpu_torch.__file__))
    check(os.path.dirname(package_dir) == HERE, f"gordo_tpu_torch found at {package_dir}, not beside the script")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = device_line()
    phase("device", f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} visible; host CPU {torch.backends.cpu.get_cpu_capability()}, "
          f"{os.cpu_count()} cores (the CPU builds that the card's are held to run there)")

    from gordo_tpu_torch.ops import _build
    from gordo_tpu_torch.ops.fleet_dense import fleet_anomaly_scores, fleet_feedforward

    t0 = time.perf_counter()
    with clocked("build"):
        libraries = _build.build(variants=((), WIDE_ONLY, NO_SPLIT))
    for stem, path in libraries.items():
        log = path.with_suffix(".log")
        report = ptxas_report(log.read_text()) if log.exists() else ["(prebuilt)"]
        phase("build", f"{stem}: {path.name} in {time.perf_counter() - t0:.1f} s; " + " | ".join(report))

    kernels_t0 = time.perf_counter()
    cases = kernel_cases()
    errors = {}
    for name, case in cases.items():
        errors[name] = compare(case)
        phase("kernel", f"{name}: max abs {errors[name][0]:.3e}, max rel {errors[name][1]:.3e} "
              f"(rtol {RTOL}, atol {ATOL}: f32 sums in another order)")
    scored = k2_cases(cases)
    for name, case in scored.items():
        errors[name] = compare_scores(case)
        phase("kernel", f"{name}: max abs {errors[name][0]:.3e}, max rel {errors[name][1]:.3e} "
              f"over recon and mse (rtol {RTOL}, atol {ATOL})")
    for name in K2_WIDE_ONLY:
        wide_err = compare_scores(scored[name], WIDE_ONLY)
        phase("kernel", f"{name}, wide-only build: max abs {wide_err[0]:.3e}, max rel {wide_err[1]:.3e}")
    for name in SPLIT_CASES:
        for y in ("x", "nan"):
            k2_name = f"K2 {name} y={y}"
            unsplit = max(compare(cases[name], NO_SPLIT), compare_scores(scored[k2_name], NO_SPLIT))
            phase("kernel", f"{name}, K1 and {k2_name}, no-split build: max abs {unsplit[0]:.3e}, "
                  f"max rel {unsplit[1]:.3e}")
    # the activation cases (3 x 37 rows) share rows among lanes; one lane a row too
    activations = [name for name in cases if name.startswith("activation") and name.endswith("hidden 9")]
    unsplit = max(compare(cases[name], NO_SPLIT) for name in activations)
    phase("kernel", f"{len(activations)} activations at hidden 9, no-split build: max abs {unsplit[0]:.3e}, "
          f"max rel {unsplit[1]:.3e}")
    PHASE_WALL["kernel"] = time.perf_counter() - kernels_t0
    print(f"[seconds] kernel: {PHASE_WALL['kernel']:.1f} s", flush=True)

    from gordo_tpu_torch.server import build_app
    from gordo_tpu_torch.server.app import make_wsgi_server

    # the stream plane reads its knobs when the first stream route creates it
    os.environ["GORDO_TPU_STREAM_WINDOW_ROWS"] = str(STREAM_WINDOW)
    os.environ["EXPECTED_MODELS"] = EXPECTED_MODELS
    build_dir = os.path.join(HERE, "build")  # git-ignored; the collection is temporary
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as work_dir:
        collection = os.path.join(work_dir, REVISION)
        with clocked("train"):
            names, wide_names, train_launches, cv_cases, train_ms, train_build = train_phase(work_dir, collection)
        check(sorted(cv_cases) == sorted(CV_CASES), f"CV forwards of widths {sorted(cv_cases)}")
        for width, name in CV_CASES.items():
            cv_case = cv_cases[width][0]
            shape = (3 * CV_MACHINES[width], TRAIN_ROWS // 4, width)
            check(tuple(cv_case["X"].shape) == shape, f"the {width}-tag CV forward had shape "
                  f"{tuple(cv_case['X'].shape)}, not {shape}")
            errors[name] = compare(cv_case)
            phase("kernel", f"{name}, the build's own fold params and test rows: max abs {errors[name][0]:.3e}, "
                  f"max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        with clocked("telemetry"):
            telemetry_launches = telemetry_phase(work_dir, collection, train_build, train_launches, card)
        with clocked("config"):
            config_launches, kfcv_case, kfcv_launches, errors[KFCV_CASE] = config_phase(work_dir)
        t0 = time.perf_counter()
        with clocked("lstm"):
            lstm_directory, lstm_seeds, lstm_build_launches, lstm_ms = lstm_build(work_dir, card)
            lstm_serve_launches = lstm_serve(lstm_directory, collection, lstm_seeds, card)
        phase("lstm", f"the phase took {time.perf_counter() - t0:.1f} s ([lstm times] comes later)")
        lstm_launches = {k: lstm_build_launches[k] + lstm_serve_launches[k] for k in ("K1", "K2")}
        with clocked("sequential"):
            build_launches, sequential_cases = sequential_phase(work_dir, collection,
                                                                {"train": train_ms, "lstm": lstm_ms}, card)
        check(sorted(sequential_cases) == sorted(SEQUENTIAL_CASES),
              f"sequential fold forwards of widths {sorted(sequential_cases)}")
        for width, name in SEQUENTIAL_CASES.items():
            case = sequential_cases[width][0]
            shape = (1, TRAIN_ROWS // 4, width)
            check(tuple(case["X"].shape) == shape, f"the {width}-tag sequential fold forward had shape "
                  f"{tuple(case['X'].shape)}, not {shape}")
            errors[name] = compare(case)
            phase("kernel", f"{name}, a sequential build's own fold params and test rows: max abs "
                  f"{errors[name][0]:.3e}, max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        app = build_app(collection, device="cuda")
        check(len(app.store.fleet().warm()) == SERVED_MACHINES + WIDE_MACHINES, "not every model loaded")
        cpu_app = build_app(collection, device="cpu")
        server = make_wsgi_server(app, "127.0.0.1", 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        base = f"http://127.0.0.1:{server.server_port}/gordo/v0/smoke"
        try:
            with clocked("serve"):
                launches, wide_launches = serve_phase(base, names, wide_names, cpu_app)
            with clocked("stream"):
                stream_launches, _latencies, _rows_per_s = stream_phase(base, names, cpu_app)
            with clocked("routes"):
                route_launches = routes_phase(base, names, wide_names, cpu_app, collection, card)
            telemetry_dir = tempfile.mkdtemp(prefix="observability-", dir=work_dir)
            with clocked("observability"):
                observability_launches, traced = observability_phase(app, base, names, wide_names, collection,
                                                                     telemetry_dir, card)
            with clocked("slo"):
                slo_launches = slo_phase(base, names, collection, work_dir, {**traced, "dir": telemetry_dir},
                                         cpu_app, card)
            with clocked("arrow"):
                arrow_launches, arrow_cases = arrow_phase(base, names, wide_names, card)
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=30)
        check(not thread.is_alive(), "server thread did not stop")
        with clocked("engine"):
            engine_launches, engine_batches = engine_phase(collection, names, wide_names, cpu_app, app, card)
        with clocked("definitions"):
            def_build_launches, def_serve_launches, def_cases, def_k2, def_launches = definitions_phase(work_dir,
                                                                                                        card)
        with clocked("lifecycle"):
            lifecycle_launches, lifecycle_cv, lifecycle_gate_k2 = lifecycle_phase(work_dir, collection,
                                                                                  train_build[0], card)
        for width, name in LIFECYCLE_CV.items():
            case = lifecycle_cv[width][0]
            check(tuple(case["X"].shape) == (3, TRAIN_ROWS // 4, width), f"the {width}-tag rebuild's CV forward had "
                  f"shape {tuple(case['X'].shape)}")
            errors[name] = compare(case)
            phase("kernel", f"{name}, the rebuild's own fold params and test rows: max abs {errors[name][0]:.3e}, "
                  f"max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        with clocked("packing"):
            packing_launches, packing_cv, packing_fleet = packing_phase(work_dir, collection, card)
        for width, name in PACKING_CV.items():
            case = packing_cv[width][0]
            shape = (3 * len(PACKING_ROWS[width]), TRAIN_ROWS // 4, width)
            check(tuple(case["X"].shape) == shape, f"the packed build's {width}-tag CV forward had shape "
                  f"{tuple(case['X'].shape)}, not {shape}")
            errors[name] = compare(case)
            phase("kernel", f"{name}, the packed build's own fold params and test rows: max abs "
                  f"{errors[name][0]:.3e}, max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        with clocked("ingress"):
            ingress_launches, ingress_cases = ingress_phase(work_dir, card)
        with clocked("mesh"):
            mesh_launches, mesh_cases = mesh_phase(work_dir, collection, names, wide_names, card)
        for width, name in MESH_CV.items():
            errors[name] = compare(mesh_cases[width][0])
            phase("kernel", f"{name}, rank 0's own block of fold params and test rows: max abs {errors[name][0]:.3e}, "
                  f"max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        with clocked("deploy"):
            deploy_launches, deploy_cases = deploy_phase(work_dir, collection, names, wide_names, cpu_app, card)
        with clocked("workflow"):
            workflow_launches, workflow_cv = workflow_phase(work_dir, card)
        with clocked("perfmodel"):
            perfmodel_launches, perfmodel_case = perfmodel_phase(work_dir, collection, names, wide_names,
                                                                 train_build[0], card)
        perfmodel_name = engine_case_name(perfmodel_case).replace("coalesced engine batch", "perfmodel corpus batch")
        errors[perfmodel_name] = compare(perfmodel_case)
        phase("kernel", f"{perfmodel_name}, the corpus's largest f32 batch (its bucket, indices, ingest plan and "
              f"rows): max abs {errors[perfmodel_name][0]:.3e}, max rel {errors[perfmodel_name][1]:.3e} "
              f"(rtol {RTOL}, atol {ATOL})")
        for width, name in DEPLOY_SCORE_CASES.items():
            case = deploy_cases[width][0]
            check(tuple(case["X"].shape) == (1, ROWS, width), f"score's {width}-tag K1 call had shape "
                  f"{tuple(case['X'].shape)}")
            errors[name] = compare(case)
            phase("kernel", f"{name}, the scored model's own params and its scaled rows: max abs "
                  f"{errors[name][0]:.3e}, max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        for name, (case, _) in ingress_cases.items():
            errors[name] = compare(case)
            phase("kernel", f"{name} {tuple(case['X'].shape)}, [ingress]'s own params and rows: max abs "
                  f"{errors[name][0]:.3e}, max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
        for width, name in PACKING_FLEET.items():
            case = packing_fleet[width][0]
            picked = list(PACKING_FLEET_MACHINES[width])
            members = case["bucket"]["out"]["W"].shape[0]
            check(tuple(case["X"].shape) == (len(picked), ROWS, width) and members == len(PACKING_ROWS[width])
                  and list(case["indices"]) == picked and case["ingest"] is not None and case["y"] is case["X"],
                  f"the packed fleet request's {width}-tag K2 call: X {tuple(case['X'].shape)}, {members} members, "
                  f"indices {case['indices']}, not {name}")
            errors[name] = compare_scores(case)
            phase("kernel", f"{name}, the served packed build's params and the request's rows: max abs "
                  f"{errors[name][0]:.3e}, max rel {errors[name][1]:.3e} over recon and mse (rtol {RTOL}, "
                  f"atol {ATOL})")
    from gordo_tpu_torch.models.factories import feedforward_hourglass

    # the builder pod's CV forwards ran in its own process: K1 held to the plain version at the spec of its
    # spec group (its fleet_plan.json) and the shape its process logged, with seeded params and rows
    workflow_names = {F: WORKFLOW_CV.format(F=F, M=M, B=B) for F, (_, M, B, _) in workflow_cv.items()}
    workflow_cases = {F: make_case(spec, M, M, B, seed=60 + F) for F, (spec, M, B, _) in workflow_cv.items()}
    for width, name in workflow_names.items():
        errors[name] = compare(workflow_cases[width])
        phase("kernel", f"{name}, seeded params and rows at the spec and shape of the builder pod's {width}-tag CV "
              f"forward: max abs {errors[name][0]:.3e}, max rel {errors[name][1]:.3e} (rtol {RTOL}, atol {ATOL})")
    times_t0 = time.perf_counter()

    for name in (*NARROW_CASES, "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest"):
        split, smem, per_sm, grid = narrow_plan(scored[name] if name.startswith("K2") else cases[name])
        phase("occupancy", f"narrow kernel at {name}: {split} lanes a row, {smem} B of shared memory a block, "
              f"{per_sm} blocks of 128 threads an SM, grid {grid}")
    for name in (*WIDE_CASES, "widest: 512-300-1-512 B=70"):
        resident, rows, wpr, smem, per_sm, grid = wide_plan(cases[name])
        phase("occupancy", f"wide kernel at {name}: weights {'resident' if resident else 'streamed'}, "
              f"{rows}-row tiles, {wpr} warps a 16-row slice, {smem} B of shared memory a block, "
              f"{per_sm} blocks of 512 threads an SM, grid {grid}")

    # what no kernel launch can beat: one launch of a one-element kernel
    one = torch.zeros(1, device="cuda")
    floor = cuda_ms(lambda: one.zero_())
    phase("times", f"launch floor (a one-element zero_): {floor!r} ms; {card}")
    timed = {}
    for name in list(cases)[:TIMED]:
        timed[name] = times(cases[name])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        served = f", launch floor {floor!r} ms" if name.startswith("served") else ""
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
              f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}){served}; {card}")
    for width, name in CV_CASES.items():
        timed[name] = times(cv_cases[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
              f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    for width, name in SEQUENTIAL_CASES.items():
        timed[name] = times(sequential_cases[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
              f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    timed[KFCV_CASE] = times(kfcv_case)
    kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[KFCV_CASE]
    phase("times", f"{KFCV_CASE} {tuple(kfcv_case['X'].shape)}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm "
          f"chain {library!r} ms (with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 "
          f"tensor cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
          f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    engine_names = {width: engine_case_name(case) for width, case in engine_batches.items()}
    engine_cases = {engine_names[width]: case for width, case in engine_batches.items()}
    for width, n, m, indices in ((20, 64, 32, list(range(0, 64, 2))), (WIDE_TAGS, 8, 8, list(range(8)))):
        engine_cases[ENGINE_FULL_CASES[width]] = make_case(feedforward_hourglass(width), n, m, 2048, indices=indices,
                                                           ingest=True, seed=40 + width)
    for name, case in engine_cases.items():
        errors[name] = compare(case)
        timed[name] = times(case)
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        reduced = ", ".join(f"{prec} forward {reduced_ms(case, prec)!r} ms" for prec in ENGINE_PRECISIONS)
        phase("times", f"{name}: K1 {kernel!r} ms (max abs {errors[name][0]:.3e} vs plain), plain {plain!r} ms, "
              f"baddbmm chain {library!r} ms (with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, "
              f"3xTF32 tensor cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}); {reduced}; {card}")
    for key, name in DEFINITION_CASES.items():
        case = def_cases[key]
        errors[name] = compare(case)
        timed[name] = times(case)
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name} {tuple(case['X'].shape)}: K1 {kernel!r} ms (max abs {errors[name][0]:.3e} vs "
              f"plain), plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 {library_tf32!r} ms), bound "
              f"{bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 "
              f"bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
    anomaly = cases[NARROW_CASES[2]]
    on_card = torch.tensor(anomaly["indices"], dtype=torch.int32, device="cuda")
    k1_on_card = cuda_ms(lambda: fleet_feedforward(
        anomaly["spec"], anomaly["bucket"], anomaly["X"], on_card, anomaly["ingest"]))
    phase("times", f"{NARROW_CASES[2]}, indices already on the card: K1 {k1_on_card!r} ms (host indices "
          f"{timed[NARROW_CASES[2]][0]!r} ms), launch floor {floor!r} ms; {card}")
    scored_timed = {}
    for name in list(scored)[:6]:
        scored_timed[name] = scores_times(scored[name])
        kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[name]
        served = f", launch floor {floor!r} ms" if "served" in name or "stream" in name else ""
        phase("times", f"{name}: K2 {kernel!r} ms, plain {plain!r} ms, baddbmm chain + mean {library!r} ms "
              f"(with TF32 {library_tf32!r} ms), K1 alone {k1!r} ms (epilogue {kernel - k1:+.5f} ms), "
              f"bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} of it), "
              f"CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}){served}; {card}")

    errors[DEFINITION_K2] = compare_scores(def_k2)
    scored_timed[DEFINITION_K2] = scores_times(def_k2)
    kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[DEFINITION_K2]
    phase("times", f"{DEFINITION_K2} {tuple(def_k2['X'].shape)}: K2 {kernel!r} ms (max abs "
          f"{errors[DEFINITION_K2][0]:.3e} vs plain), plain {plain!r} ms, baddbmm chain + mean {library!r} ms (with "
          f"TF32 {library_tf32!r} ms), K1 alone {k1!r} ms, bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
          f"{bound_ms / kernel:.1%} of it; y's bytes counted apart), CUDA-core f32 bound {cuda_core_ms!r} ms "
          f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")

    timed[SLO_ANOMALY] = times(cases[SLO_ANOMALY])
    kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[SLO_ANOMALY]
    phase("times", f"{SLO_ANOMALY}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
          f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} of "
          f"it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; "
          f"{card}")
    scored_timed[SLO_FLEET] = scores_times(scored[SLO_FLEET])
    kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[SLO_FLEET]
    phase("times", f"{SLO_FLEET}: K2 {kernel!r} ms, plain {plain!r} ms, baddbmm chain + mean {library!r} ms (with "
          f"TF32 {library_tf32!r} ms), K1 alone {k1!r} ms, bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; "
          f"{bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), "
          f"launch floor {floor!r} ms; {card}")

    for name, (case, _) in arrow_cases.items():
        if name.startswith("K2"):
            errors[name] = compare_scores(case)
            scored_timed[name] = scores_times(case)
            kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[name]
            phase("times", f"{name}: K2 {kernel!r} ms (max abs {errors[name][0]:.3e} vs plain), plain {plain!r} ms, "
                  f"baddbmm chain + mean {library!r} ms (with TF32 {library_tf32!r} ms), K1 alone {k1!r} ms, bound "
                  f"{bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 "
                  f"bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")
        else:
            errors[name] = compare(case)
            timed[name] = times(case)
            kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
            phase("times", f"{name}: K1 {kernel!r} ms (max abs {errors[name][0]:.3e} vs plain), plain {plain!r} ms, "
                  f"baddbmm chain {library!r} ms (with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, "
                  f"3xTF32 tensor cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
                  f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")

    for width, name in LIFECYCLE_CV.items():
        timed[name] = times(lifecycle_cv[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
              f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} "
              f"of it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor "
              f"{floor!r} ms; {card}")
    for name in LIFECYCLE_GATE.values():
        scored_timed[name] = scores_times(scored[name])
        kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[name]
        phase("times", f"{name}: K2 {kernel!r} ms, plain {plain!r} ms, baddbmm chain + mean {library!r} ms (with "
              f"TF32 {library_tf32!r} ms), K1 alone {k1!r} ms, bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor "
              f"cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")

    for width, name in PACKING_CV.items():
        timed[name] = times(packing_cv[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
              f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} "
              f"of it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor "
              f"{floor!r} ms; {card}")
    for width, name in PACKING_FLEET.items():
        scored_timed[name] = scores_times(packing_fleet[width][0])
        kernel, plain, library, library_tf32, k1, bound_ms, bound_by, cuda_core_ms = scored_timed[name]
        phase("times", f"{name}: K2 {kernel!r} ms, plain {plain!r} ms, baddbmm chain + mean {library!r} ms (with "
              f"TF32 {library_tf32!r} ms), K1 alone {k1!r} ms, bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor "
              f"cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")

    for name, (case, _) in ingress_cases.items():
        timed[name] = times(case)
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name} {tuple(case['X'].shape)}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain "
              f"{library!r} ms (with TF32 {library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor "
              f"cores; {bound_ms / kernel:.1%} of it), CUDA-core f32 bound {cuda_core_ms!r} ms "
              f"({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; {card}")

    for width, name in MESH_CV.items():
        timed[name] = times(mesh_cases[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
              f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} "
              f"of it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor "
              f"{floor!r} ms; {card}")

    for width, name in DEPLOY_SCORE_CASES.items():
        timed[name] = times(deploy_cases[width][0])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
              f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} "
              f"of it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor "
              f"{floor!r} ms; {card}")

    for width, name in workflow_names.items():
        timed[name] = times(workflow_cases[width])
        kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[name]
        phase("times", f"{name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
              f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} "
              f"of it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor "
              f"{floor!r} ms; {card}")

    timed[perfmodel_name] = times(perfmodel_case)
    kernel, plain, library, library_tf32, bound_ms, bound_by, cuda_core_ms = timed[perfmodel_name]
    phase("times", f"{perfmodel_name}: K1 {kernel!r} ms, plain {plain!r} ms, baddbmm chain {library!r} ms (with TF32 "
          f"{library_tf32!r} ms), bound {bound_ms!r} ms ({bound_by}, 3xTF32 tensor cores; {bound_ms / kernel:.1%} of "
          f"it), CUDA-core f32 bound {cuda_core_ms!r} ms ({cuda_core_ms / kernel:.1%}), launch floor {floor!r} ms; "
          f"{card}")

    PHASE_WALL["times"] = time.perf_counter() - times_t0
    print(f"[seconds] times: {PHASE_WALL['times']:.1f} s", flush=True)
    with clocked("lstm times"):
        lstm_times(card)
    tail_t0 = time.perf_counter()

    for name in NARROW_CASES:
        case = cases[name]
        args = (case["spec"], case["bucket"], case["X"], case["indices"], case["ingest"])
        wide_err = compare(case, WIDE_ONLY)[0]
        narrow = cuda_ms(lambda: fleet_feedforward(*args))
        wide = cuda_ms(lambda: fleet_feedforward(*args, defines=WIDE_ONLY))
        phase("narrow vs wide", f"{name}: narrow kernel {narrow!r} ms, wide kernel {wide!r} ms "
              f"(wide/narrow {wide / narrow:.2f}; wide max abs {wide_err:.3e}); {card}")
    for name in K2_WIDE_ONLY[:1]:
        case = scored[name]
        args = (case["spec"], case["bucket"], case["X"], case["y"], case["indices"], case["ingest"])
        narrow = cuda_ms(lambda: fleet_anomaly_scores(*args))
        wide = cuda_ms(lambda: fleet_anomaly_scores(*args, defines=WIDE_ONLY))
        phase("narrow vs wide", f"{name}: narrow kernel {narrow!r} ms, wide kernel {wide!r} ms "
              f"(wide/narrow {wide / narrow:.2f}); {card}")

    for name in SPLIT_CASES:
        case = cases[name]
        on_card = torch.tensor(case["indices"], dtype=torch.int32, device="cuda")
        args = (case["spec"], case["bucket"], case["X"], on_card, case["ingest"])
        split = cuda_ms(lambda: fleet_feedforward(*args))
        unsplit = cuda_ms(lambda: fleet_feedforward(*args, defines=NO_SPLIT))
        phase("split", f"{name}, indices on the card: {narrow_plan(case)[0]} lanes a row {split!r} ms, "
              f"one lane a row {unsplit!r} ms (split/one {split / unsplit:.2f}), launch floor {floor!r} ms; {card}")

    PHASE_WALL["narrow vs wide, split"] = time.perf_counter() - tail_t0
    print(f"[seconds] narrow vs wide, split: {PHASE_WALL['narrow vs wide, split']:.1f} s", flush=True)
    phase("seconds", "every phase: " + ", ".join(f"{name} {seconds:.1f}" for name, seconds in PHASE_WALL.items())
          + f"; {sum(PHASE_WALL.values()):.1f} s in all")

    def entry(name, replaces, launches_, by_path, case, numbers):
        kernel, plain, library, library_tf32 = numbers[:4]
        bound_ms, bound_by, cuda_core_ms = numbers[-3:]
        return {
            "name": name, "route": "cuda", "source": "gordo_tpu_torch/ops/csrc/fleet_dense.cu",
            "replaces": replaces, "launches": launches_, "launches_by_path": by_path, "shape": case,
            "max_abs_err": errors[case][0], "ms": kernel, "plain_ms": plain, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library, "library_tf32_ms": library_tf32,
            "cuda_core_bound_ms": cuda_core_ms, "launch_floor_ms": floor,
        }

    k1_by_path = {"train": train_launches["K1"], "config": config_launches["K1"], "serve": launches["K1"],
                  "serve_wide": wide_launches["K1"], "stream": stream_launches["K1"], "routes": route_launches["K1"],
                  "lstm": lstm_launches["K1"], "build": build_launches["K1"],
                  "engine": engine_launches["narrow"] + engine_launches["wide"],
                  "definitions": def_build_launches["K1"] + def_serve_launches["K1"],
                  "telemetry": telemetry_launches["K1"], "observability": observability_launches["K1"],
                  "slo": slo_launches["K1"], "lifecycle": lifecycle_launches["K1"],
                  "packing": packing_launches["K1"], "arrow": arrow_launches["K1"], "ingress": ingress_launches["K1"],
                  "mesh": mesh_launches["K1"],
                  "deploy": deploy_launches["server"]["K1"] + deploy_launches["score"],
                  "workflow": sum(workflow_launches.values()), "perfmodel": perfmodel_launches["K1"]}
    k2_by_path = {"train": train_launches["K2"], "config": config_launches["K2"], "serve": launches["K2"],
                  "serve_wide": wide_launches["K2"], "stream": stream_launches["K2"], "routes": route_launches["K2"],
                  "lstm": lstm_launches["K2"], "build": build_launches["K2"], "engine": 0,
                  "definitions": def_build_launches["K2"] + def_serve_launches["K2"],
                  "telemetry": telemetry_launches["K2"], "observability": observability_launches["K2"],
                  "slo": slo_launches["K2"], "lifecycle": lifecycle_launches["K2"],
                  "packing": packing_launches["K2"], "arrow": arrow_launches["K2"], "ingress": ingress_launches["K2"],
                  "mesh": 0, "deploy": deploy_launches["server"]["K2"], "workflow": 0, "perfmodel": 0}
    k2_wide = f"K2 {WIDE_CASES[0]} y=X"
    print(json.dumps({"kernels": [
        entry("fleet_dense (K1), narrow kernel", "gordo_tpu/ops/pallas_dense.py:114", launches["K1"],
              k1_by_path, "hourglass20 M=1000 B=1008", timed["hourglass20 M=1000 B=1008"]),
        entry("fleet_anomaly_scores (K2), narrow kernel", "gordo_tpu/ops/pallas_dense.py:126",
              stream_launches["K2"], k2_by_path, "K2 stream flush: hourglass20 M=64 B=512 y=X +ingest",
              scored_timed["K2 stream flush: hourglass20 M=64 B=512 y=X +ingest"]),
        entry("fleet_dense (K1), wide kernel", "gordo_tpu/ops/pallas_dense.py:114", wide_launches["K1"],
              k1_by_path, WIDE_CASES[0], timed[WIDE_CASES[0]]),
        entry("fleet_anomaly_scores (K2), wide kernel", "gordo_tpu/ops/pallas_dense.py:126", wide_launches["K2"],
              k2_by_path, k2_wide, scored_timed[k2_wide]),
        # launches: the build's CV forward of that width, read on the counter
        entry("fleet_dense (K1), narrow kernel, CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              cv_cases[20][1], k1_by_path, CV_CASES[20], timed[CV_CASES[20]]),
        entry("fleet_dense (K1), wide kernel, CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              cv_cases[WIDE_TAGS][1], k1_by_path, CV_CASES[WIDE_TAGS], timed[CV_CASES[WIDE_TAGS]]),
        # launches: the [config] build's KFCV forward, read on the counter
        entry("fleet_dense (K1), narrow kernel, KFCV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              kfcv_launches, k1_by_path, KFCV_CASE, timed[KFCV_CASE]),
        # launches: the [sequential] build of that width, one a fold, read on the counter
        entry("fleet_dense (K1), narrow kernel, sequential fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              sequential_cases[20][1], k1_by_path, SEQUENTIAL_CASES[20], timed[SEQUENTIAL_CASES[20]]),
        entry("fleet_dense (K1), wide kernel, sequential fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              sequential_cases[WIDE_TAGS][1], k1_by_path, SEQUENTIAL_CASES[WIDE_TAGS],
              timed[SEQUENTIAL_CASES[WIDE_TAGS]]),
        # launches: the [engine] phase's coalesced batches of that width, read on the counter; the shape:
        # the largest batch it launched at that width, captured on its way to K1
        entry("fleet_dense (K1), narrow kernel, coalesced engine batch", "gordo_tpu/ops/pallas_dense.py:114",
              engine_launches["narrow"], k1_by_path, engine_names[20], timed[engine_names[20]]),
        entry("fleet_dense (K1), wide kernel, coalesced engine batch", "gordo_tpu/ops/pallas_dense.py:114",
              engine_launches["wide"], k1_by_path, engine_names[WIDE_TAGS], timed[engine_names[WIDE_TAGS]]),
        # launches: the [definitions] build's CV forward of the raw spec's group, read on the counter; the
        # served shapes: the K1 calls of that bucket's anomaly requests, through the engine
        entry("fleet_dense (K1), narrow kernel, raw spec CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              def_launches["raw"], k1_by_path, DEFINITION_CASES["raw"], timed[DEFINITION_CASES["raw"]]),
        entry("fleet_dense (K1), narrow kernel, StandardScaler bucket", "gordo_tpu/ops/pallas_dense.py:114",
              def_launches["standard"], k1_by_path, DEFINITION_CASES["standard"], timed[DEFINITION_CASES["standard"]]),
        entry("fleet_dense (K1), narrow kernel, host-transformed bucket", "gordo_tpu/ops/pallas_dense.py:114",
              def_launches["host"], k1_by_path, DEFINITION_CASES["host"], timed[DEFINITION_CASES["host"]]),
        # launches: the fleet request's K2 launch for the non-affine bucket
        entry("fleet_anomaly_scores (K2), narrow kernel, host-transformed bucket", "gordo_tpu/ops/pallas_dense.py:126",
              def_launches["K2"], k2_by_path, DEFINITION_K2, scored_timed[DEFINITION_K2]),
        # launches: the [slo] drill's anomaly requests (K1) and its fleet request (K2), read on the counters
        entry("fleet_dense (K1), narrow kernel, SLO drill anomaly request", "gordo_tpu/ops/pallas_dense.py:114",
              slo_launches["K1"], k1_by_path, SLO_ANOMALY, timed[SLO_ANOMALY]),
        entry("fleet_anomaly_scores (K2), narrow kernel, SLO drill fleet request", "gordo_tpu/ops/pallas_dense.py:126",
              slo_launches["K2"], k2_by_path, SLO_FLEET, scored_timed[SLO_FLEET]),
        # launches: [lifecycle]'s two rebuilds' CV forwards of that width, read on the counter
        entry("fleet_dense (K1), narrow kernel, lifecycle rebuild CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              lifecycle_cv[20][1], k1_by_path, LIFECYCLE_CV[20], timed[LIFECYCLE_CV[20]]),
        entry("fleet_dense (K1), wide kernel, lifecycle rebuild CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              lifecycle_cv[WIDE_TAGS][1], k1_by_path, LIFECYCLE_CV[WIDE_TAGS], timed[LIFECYCLE_CV[WIDE_TAGS]]),
        # launches: [lifecycle]'s three gates' K2 launches at that width, counted where they launch
        entry("fleet_anomaly_scores (K2), narrow kernel, lifecycle gate", "gordo_tpu/ops/pallas_dense.py:126",
              lifecycle_gate_k2[20], k2_by_path, LIFECYCLE_GATE[20], scored_timed[LIFECYCLE_GATE[20]]),
        entry("fleet_anomaly_scores (K2), wide kernel, lifecycle gate", "gordo_tpu/ops/pallas_dense.py:126",
              lifecycle_gate_k2[WIDE_TAGS], k2_by_path, LIFECYCLE_GATE[WIDE_TAGS],
              scored_timed[LIFECYCLE_GATE[WIDE_TAGS]]),
        # launches: [packing]'s build's CV forward of that width and its fleet request's K2 call of that
        # width, read on the counters
        entry("fleet_dense (K1), narrow kernel, packed build CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              packing_cv[20][1], k1_by_path, PACKING_CV[20], timed[PACKING_CV[20]]),
        entry("fleet_dense (K1), wide kernel, packed build CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              packing_cv[WIDE_TAGS][1], k1_by_path, PACKING_CV[WIDE_TAGS], timed[PACKING_CV[WIDE_TAGS]]),
        entry("fleet_anomaly_scores (K2), narrow kernel, packed fleet request", "gordo_tpu/ops/pallas_dense.py:126",
              packing_fleet[20][1], k2_by_path, PACKING_FLEET[20], scored_timed[PACKING_FLEET[20]]),
        entry("fleet_anomaly_scores (K2), wide kernel, packed fleet request", "gordo_tpu/ops/pallas_dense.py:126",
              packing_fleet[WIDE_TAGS][1], k2_by_path, PACKING_FLEET[WIDE_TAGS],
              scored_timed[PACKING_FLEET[WIDE_TAGS]]),
        # launches: [arrow]'s Arrow requests of that kernel and width, read on the counters where they launch
        entry("fleet_dense (K1), narrow kernel, Arrow anomaly and prediction requests",
              "gordo_tpu/ops/pallas_dense.py:114", arrow_cases[ARROW_CASES["K1 narrow"]][1], k1_by_path,
              ARROW_CASES["K1 narrow"], timed[ARROW_CASES["K1 narrow"]]),
        entry("fleet_dense (K1), wide kernel, Arrow anomaly and prediction requests",
              "gordo_tpu/ops/pallas_dense.py:114", arrow_cases[ARROW_CASES["K1 wide"]][1], k1_by_path,
              ARROW_CASES["K1 wide"], timed[ARROW_CASES["K1 wide"]]),
        entry("fleet_anomaly_scores (K2), narrow kernel, Arrow fleet request", "gordo_tpu/ops/pallas_dense.py:126",
              arrow_cases[ARROW_CASES["K2 fleet"]][1], k2_by_path, ARROW_CASES["K2 fleet"],
              scored_timed[ARROW_CASES["K2 fleet"]]),
        entry("fleet_anomaly_scores (K2), narrow kernel, Arrow stream flushes", "gordo_tpu/ops/pallas_dense.py:126",
              arrow_cases[ARROW_CASES["K2 flush"]][1], k2_by_path, ARROW_CASES["K2 flush"],
              scored_timed[ARROW_CASES["K2 flush"]]),
        # launches: [ingress]'s CV forward of its four machines (parquet, Influx, row_filter sources) and its two
        # parquet requests, read on the counters where they launch
        entry("fleet_dense (K1), narrow kernel, ingress CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              ingress_cases[INGRESS_CASES["cv"]][1], k1_by_path, INGRESS_CASES["cv"], timed[INGRESS_CASES["cv"]]),
        entry("fleet_dense (K1), narrow kernel, parquet requests", "gordo_tpu/ops/pallas_dense.py:114",
              ingress_cases[INGRESS_CASES["served"]][1], k1_by_path, INGRESS_CASES["served"],
              timed[INGRESS_CASES["served"]]),
        # launches: rank 0's CV forward of its block of that width in [mesh]'s two-rank build, read on the counter
        entry("fleet_dense (K1), narrow kernel, mesh rank CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              mesh_cases[20][1], k1_by_path, MESH_CV[20], timed[MESH_CV[20]]),
        entry("fleet_dense (K1), wide kernel, mesh rank CV fold scoring", "gordo_tpu/ops/pallas_dense.py:114",
              mesh_cases[WIDE_TAGS][1], k1_by_path, MESH_CV[WIDE_TAGS], timed[MESH_CV[WIDE_TAGS]]),
        # launches: [deploy]'s score of a model of that width on the card, read on the counter where it launches
        entry("fleet_dense (K1), narrow kernel, score", "gordo_tpu/ops/pallas_dense.py:114", deploy_cases[20][1],
              k1_by_path, DEPLOY_SCORE_CASES[20], timed[DEPLOY_SCORE_CASES[20]]),
        entry("fleet_dense (K1), wide kernel, score", "gordo_tpu/ops/pallas_dense.py:114", deploy_cases[WIDE_TAGS][1],
              k1_by_path, DEPLOY_SCORE_CASES[WIDE_TAGS], timed[DEPLOY_SCORE_CASES[WIDE_TAGS]]),
        # launches: the rendered builder pod's CV forwards at that width's shape, counted in its process and
        # logged by shape; the shape timed with seeded params and rows
        entry("fleet_dense (K1), narrow kernel, workflow builder pod CV fold scoring",
              "gordo_tpu/ops/pallas_dense.py:114", workflow_cv[20][3], k1_by_path, workflow_names[20],
              timed[workflow_names[20]]),
        entry("fleet_dense (K1), wide kernel, workflow builder pod CV fold scoring",
              "gordo_tpu/ops/pallas_dense.py:114", workflow_cv[WIDE_TAGS][3], k1_by_path,
              workflow_names[WIDE_TAGS], timed[workflow_names[WIDE_TAGS]]),
        # launches: [perfmodel]'s K1 launches (its corpus's f32 batches, both engines' warmups, the unbatched
        # request over the cap, the replay and the OOM drill), read on the counter; the shape: the corpus's
        # largest f32 batch, captured on its way to K1
        entry("fleet_dense (K1), narrow kernel, perfmodel corpus batch", "gordo_tpu/ops/pallas_dense.py:114",
              perfmodel_launches["K1"], k1_by_path, perfmodel_name, timed[perfmodel_name]),
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}),
        flush=True)


if __name__ == "__main__":
    try:
        main()
    except Exception as exc:  # noqa: BLE001 - every failure ends the run non-zero
        traceback.print_exc()
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr, flush=True)
        sys.exit(1)
