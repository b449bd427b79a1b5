#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints what it found and its seconds; any failure exits
non-zero):

1. environment: python/torch/CUDA versions, the card's name and power
   limit as ``nvidia-smi`` reports them, capability (9, 0);
2. build: every ``src/repro_torch/csrc/*.cu`` with ``nvcc`` (in parallel),
   each kernel's registers and spills as ``ptxas`` reports them (54
   instantiations of ``sim_engine``: balancer × lifecycle × observation
   mode: off, observation, observation and timeline; built as six
   libraries side by side, one for each lifecycle switch and mode);
3. kernel against its plain version on the card: ``hermes_select`` at
   W ∈ {100, 1000}, R ∈ {1, 8}, N ∈ {1, 256}, random and edge states,
   exactly equal; CUDA-event times of both at the serving and per-arrival
   shape (R=4, N=1, W=100; replayed from a CUDA graph, and as called from
   Python) beside the bytes bound;
4. the main path at the paper's large-cluster size (fig4 quick sweep:
   W=100 × 12 cores, 96 slots, ms-trace with 50 functions, loads
   0.5/0.7/0.9/0.97 as R=4, seed 1): ``simulate_many`` on ``cuda`` for
   Hermes, E/LL/PS and E/LOC/PS at the quick depth N=12000, each one
   ``sim_engine`` launch (the fused early-binding loop) and no
   ``hermes_select`` launch, with no host sync in the loop (the counts are
   zeroed just before each run and read just after), and Hermes on the
   first N=500 arrivals of the same inputs; then the batched engine on
   those 500: the plain Hermes run (``backend="torch"``, the fused
   engine's "before"), which the fused Hermes run of the 500 must equal
   in every plane and the one of 12000 in its first 500 choices (worker,
   cold, rejected), and late binding; each fused policy must take ≤ 100
   µs per arrival and ≥ 50× less than the plain Hermes run; then
   ``sim_engine``'s device time on the 500 (its output again equal to
   the plain run's) beside that run's and the bound; 4b. the
   fused Hermes run at N=12000: its wall time beside the kernel's device
   time on the same inputs (CUDA events), the idle share they give, its
   launches and host syncs;
5. the fused kernel against the plain batched engine on the card, equal
   in every plane, for E/{H,LL,LOC,R}/PS at N=500 on the fig4 cluster;
   Hermes against the CPU, equal integer planes and floats within 1e-9;
   then every policy of phase 4, E/R/PS, E/H/FCFS and E/H/SRPT, card
   against CPU, at N=300 on the same cluster and on an overloaded 4 ×
   3-core cluster (rejections, evictions, the late-binding queue), with
   each run's launch counts (the fused policies one ``sim_engine``
   launch; E/H/FCFS and E/H/SRPT, which keep the batched engine, one
   ``hermes_select`` launch per arrival); there the fused kernel equal to
   the plain engine on the card and to its plain version
   (``sim_engine_ref``, on the CPU) in every plane and iteration count,
   and E/H/FCFS and E/H/SRPT equal to the plain engine on the card
   (``backend="kernel"`` against ``"torch"``) in every plane; the plain
   runs go side by side in the worker processes that phases 12-15 use
   too, while the card runs the kernel paths;
6. the attention kernels against their plain versions on the card, in f32
   (atol = rtol = 1e-4: the same f32 math in another summation order) and
   bf16 (2e-2, ``tests/test_kernels.py``'s bf16 tolerance: the output is
   rounded to bf16): ``flash_attention`` at ``tests/test_kernels.py``'s
   shapes, qwen3-14b (GQA) and granite-20b (MQA) attention, the served
   prompt shapes and gemma-2b's (Dh = 256, 8 query heads on 1 KV head, S ∈
   {777, 1500}); ``decode_attention`` at ``tests/test_kernels.py``'s
   shapes, two batched caches whose splits span several chunks, and the
   served caches and gemma-2b's (S_max = 2048, pos ∈ {0, 776, 2047});
   both wrappers refuse a cache (or bf16 input) that is not 16-byte
   aligned; CUDA-event times of the kernel, the plain version and
   ``F.scaled_dot_product_attention`` (the library yardstick, used nowhere
   in the port) beside each kernel's bound and its time before the
   redesign (``BEFORE_REDESIGN_MS``), gemma-2b's shapes among them;
7. the serving path at full width: a ``HermesFrontend`` on ``cuda`` (2
   workers × 2 cores, ``max_len`` 2048) serving ``olmo-1b`` (seed 0) and
   ``musicgen-large`` (seed 1) with ``attn_impl="pallas"``, 6 alternating
   requests, prompts of 200-1500 tokens (``default_rng(1)``), 16 new
   tokens each; all six launch counts are zeroed just before and must
   be Σ L × (requests + cold starts) for ``flash_attention``,
   Σ L × (16 × requests + cold starts) for ``decode_attention``, 6 for
   ``hermes_select`` and 0 for the scans and ``sim_engine``; 7b. a
   profiled stretch of decode steps: the device's busy and idle share,
   its costliest kernels, and ``decode_attention``'s device time per call
   inside the step (its split and combine kernels);
8. prefill plus 8 teacher-forced decode steps through the cache against
   the plain path's full forward (``attn_impl="naive"``, same parameters)
   over the same 785 tokens, for both models and for gemma-2b (seed 4,
   its attention at Dh = 256), at full width: in f32 within
   1e-4 × max |logit|, and in the served bf16 within 6e-2 × max |logit|
   (``tests/test_models.py``'s bf16 tolerance between attention
   implementations, scaled to the logits);
9. the scan kernels against their plain chunked forms on the card:
   ``rwkv6_wkv`` and ``mamba2_ssd`` at ``tests/test_kernels.py``'s shapes
   and chunks, the served shapes (B = 1, T ∈ {8, 777, 1500}), one
   nonzero carry-in state and, for ``rwkv6_wkv``, strong decay (lw =
   -exp(N(2, 1)), B = 2, ragged T, a carry-in), in f32 (y and state within
   1e-4, and within 2e-3 of the per-step oracle) and with bf16
   activations (y within 2e-2, the f32 state within 2e-3); CUDA-graph
   times of both beside the plain version, the bound and their times
   before the redesign at T ∈ {777, 1500}, the device launches per call
   (kernel nodes of one call captured in a CUDA graph) and each launch's
   device time;
10. the recurrent serving path at full width: a fresh ``HermesFrontend``
    serving ``rwkv6-3b`` (seed 2) and ``zamba2-2.7b`` (seed 3) as in
    phase 7 (prompts from ``default_rng(2)``), with the exact launch
    counts of all six kernels; 10b. a profiled stretch of their decode
    steps;
11. phase 8's check for both recurrent models: prefill runs the scan
    kernels over the prompt and hands their final state to the plain step
    recurrence, the full forward runs the kernels over all tokens (and the
    plain attention for zamba2's shared block); both models' ratios beside
    those read before their scan kernel's redesign (``BEFORE_RATIO``);
12. trace replay on the card (``repro_torch.trace``): (a) fig10's full
    mode, the five ``azure-*`` scenarios on the testbed (8 × 12 cores,
    cold-start penalty 0.5 s) at loads 0.3/0.5/0.7/0.85 × seeds 1-5 (R =
    20 a scenario), N = 12 000, through the fused E/H/PS, E/LL/PS and
    E/LOC/PS (one ``sim_engine`` launch, no host sync each) with fig10's
    two claims printed as observations, and late binding on the batched
    engine at N = 500; (b) the five scenarios in one batch
    (``resample_workloads``, load 0.7, F = 60): fused at N = 12 000, equal
    to the plain engine on the card in every plane at N = 500, card
    against CPU at N = 300 (late binding too); (c) fig14's horizon lane,
    1000 workers × 2 cores, 4 slots, ``azure-diurnal`` at N = 43 200 and
    the fig4 loads: the three fused runs side by side, each kernel's
    device time, iterations, bound and idle share, and the first 500
    arrivals of each run equal to the plain engine's run of them (on the
    CPU); the
    host's generation time beside each run; the batched engine's runs
    side by side in worker processes; the phase ≤ 60 s, the script ≤
    600 s;
13. the policy zoo on the card, every run fused (one ``sim_engine``
    launch, no host sync, no ``hermes_select`` launch): (a) fig11's
    quick mode on the paper's small cluster (4 × 12 cores, 96 slots),
    ``ms-trace`` and ``bimodal-exec`` at loads 0.5/0.7/0.8/0.9 (R = 4),
    N = 6000, seed 0, the nine policies of ``registry_policies
    (ZOO_POLICIES)``; (b) its mixed lane (``ms-trace``,
    ``azure-diurnal``, ``azure-bursty`` at 0.7 through
    ``resample_workloads``, N = 3000) and the same at N = 300, card
    against the CPU in every plane with float gaps 0; (c) fig4's zoo
    rows (phase 4's inputs; E/{JSQ2,RR,HIKU,DD,SWARM}/PS), each timed
    by CUDA events beside its bound; the first 500 arrivals of the
    five zoo policies' runs in (a) ms-trace, (b) and (c) equal to the
    batched engine's run of them on the CPU (and a fused run of just
    those equal to it in every plane); ``sim_engine`` equal to
    ``sim_engine_ref`` for the five at W = 4, final balancer state
    included; fig11's verdicts printed, not gated; the CPU runs in the
    worker processes; the phase ≤ 60 s;
14. the keep-alive axis on the card (``repro_torch.lifecycle``, the life
    plane of ``sim_engine``), every run fused (one ``sim_engine`` launch,
    no host sync, no ``hermes_select`` launch) on the paper's testbed (8 ×
    12 cores, 96 slots) at the reference's full depth, N = 15 000, R = 5,
    seed 1, TTL 10 s, the ``openwhisk`` preset: (a) fig12's budget lane
    (``azure-cold-heavy``, F = 60, Hermes under NONE, FIXED_TTL and
    HYBRID_HIST with ``max_idle = 4``) and balancer lane
    (``azure-diurnal``, E/{H,LL,LOC}/PS under FIXED_TTL) at loads
    0.2/0.3/0.5/0.7/0.85; (b) fig7's keep-alive axis (``ms-trace`` and
    ``azure-diurnal`` × the three keep-alives × the three schedulers) at
    0.1/0.3/0.5/0.7/0.9; two timing runs on the budget lane's inputs
    (no lifecycle; FIXED_TTL without the budget); each kernel's device
    time by CUDA events beside its bound; the first 500 arrivals of
    every run of (a) and (b) equal to the batched engine's run of them on
    the CPU (and a fused run of just those equal to it in every plane and
    in the final life state); ``sim_engine`` equal to ``sim_engine_ref``
    for all nine balancers under FIXED_TTL (``max_idle = 2``) and
    HYBRID_HIST on phase 5's overloaded cluster, final life state
    included; the repaired route: E/H/PS at 2048 slots (8 × 256 cores)
    takes the batched engine on the card (one ``hermes_select`` launch an
    arrival, no ``sim_engine`` launch), equal to the plain engine on the
    card and to the CPU; fig12's claims printed, not gated; the CPU runs
    in the worker processes; the phase ≤ 60 s;
15. telemetry and the heterogeneous fleet on the card
    (``repro_torch.telemetry``, ``repro_torch.fleet``: the observation
    plane of ``sim_engine``), every run fused (one ``sim_engine`` launch,
    no host sync, no ``hermes_select`` launch): (a) bench_telemetry's
    sketch lane in full mode (8 × 8 cores, ``ms-trace`` at loads
    0.3/0.6/0.8, seeds 17-21, N = 60 000; the nine E/<B>/PS policies, 27
    runs), the sketch's p50/p99 slowdown within 2 % of the exact pooled
    ``summarize_batch_sim`` (gated); (b) fig13's full mode on the testbed
    (``azure-diurnal``, N = 6000, R = 1): the balancer lane (a ``two-gen``
    fleet, loads 0.5/0.65/0.8 × E/{H,LL,SWARM}/PS) and the frontier lane
    (seeds 1-3 × static W ∈ {5, 6, 7, 8} and the ``TARGET_P99``
    autoscaler, target 3.0, ``min_workers`` 2, cooldown 2 s), its two
    claims printed, not gated; the first 800 arrivals of each of the 51
    runs equal to the batched engine's run of them on the CPU (and a fused
    run of just those equal to it in every plane, the telemetry, the
    autoscaler's state and ``prov_core_s``; an autoscaler's prefix at the
    full run's warmup cutoff); (c) a user's autoscaler on the batched
    engine on the card (no ``sim_engine`` launch, equal to the CPU), and
    ``TARGET_P99``'s two named errors (late binding, no telemetry); (d)
    the plane's cost: phase 4's E/H/PS inputs without it, with a
    ``uniform`` fleet (which changes nothing, so the plane stays off), with
    telemetry and with a ``two-gen`` fleet (other dynamics: more tasks
    at once), CUDA-event times in turns; and
    ``sim_engine`` equal to ``sim_engine_ref`` for the nine balancers
    under telemetry, a ``two-gen`` fleet and ``TARGET_P99`` on phase 5's
    overloaded cluster; the CPU runs in the worker processes; the phase
    ≤ 60 s;
16. the timeline and the serving platform (fig15's lanes,
    ``benchmarks/fig15_timeline.py``): (a) the parity stacks (4 × 3 cores,
    N = 240, R = 2, 32 windows), E/LL/PS, E/H/PS with its mode flips and
    E/LL/PS on a ``two-gen`` fleet under ``TARGET_P99`` fused (one
    ``sim_engine`` launch each), L/LL/FCFS on the batched engine on the
    card, every timeline plane equal to the CPU engine's and the same runs
    without a timeline equal in every other plane; (b) the diurnal lane
    (the testbed, ``azure-diurnal`` at 0.5, N = 4000): fused E/LL/PS and
    ``ServingCluster`` with Hermes on the card (exactly one
    ``hermes_select`` launch per arrival), both through fig15's shape
    checks, the platform equal to its CPU run, wall µs per arrival of
    both; (c) the decision lane (``two-gen`` + ``TARGET_P99``, N = 6000,
    512 events): fused, every plane equal to the CPU engine's, the log
    replaying ``n_on``, a decision logged, every sensor p99 finite; then
    the same through the platform on the card; (d) the plane's cost on
    phase 4's E/H/PS inputs: none, telemetry, telemetry and a timeline,
    CUDA-event times in turns, with the bound; (e) ``python -m
    repro_torch.launch.serve`` in a subprocess on the card, exit 0, its
    CSV and ``.om`` written, its lines and CSV equal to the same run
    in-process on the CPU; and ``sim_engine`` equal to ``sim_engine_ref``
    under the timeline for the nine balancers, plain and under
    ``TARGET_P99``; the CPU runs in the worker processes; the phase ≤ 60 s;
17. streaming (``repro_torch.core.streaming.simulate_stream``) on the
    card: (a) fig14's equivalence lane, its fifteen stacks at N = 240,
    R = 2, chunks 96 and 80, each a fused stream in ``sim_engine``'s chunk
    mode (one launch per chunk, resuming from the carry, and one for the
    drain) equal to the fused monolithic run (``final_states_equal``: slot
    matrices, warm pools, clocks, every plane) and to the CPU's batched
    stream, the kernel's carry after every chunk equal to
    ``sim_engine_ref``'s chunk mode (max abs err 0) and, for two stacks, to
    the CPU's; E/H/FCFS streamed through the batched engine on the card, one
    ``hermes_select`` launch per arrival, equal to the CPU; (b) its horizon
    lane (1000 × 2 cores, ``azure-diurnal`` at 0.7, E/LL/PS) in chunks of
    4096 at N = 12 000 and the full day, N = 86 400 (22 launches), each
    beside the monolithic fused run on the same inputs: final state and
    counters equal, walls and µs per arrival of both, the device peak at
    86 400 no larger than at 12 000, the host peak RSS within 4096 MiB, the
    chunks enqueued with no host sync (torch's sync check); (c) fig15's
    streaming check: the three early-binding parity stacks' timelines and
    final states equal the monolithic runs'; the CPU runs in the worker
    processes; the phase ≤ 60 s;
18. the MoE and MLA families at full width, after the worker processes
    have closed: (a) a fresh ``HermesFrontend`` on ``cuda`` (2 workers × 2
    cores, ``max_len`` 2048, ``H``) serving ``dbrx-132b`` (seed 5) and
    ``deepseek-v2-236b`` (seed 6) at their published widths and bf16
    parameters, cut to 2 layers, ``attn_impl="pallas"`` (dbrx runs the
    flash and decode kernels, deepseek's MLA the reference's einsums), 6
    alternating requests of 200-1500 prompt tokens (``default_rng(3)``),
    16 new tokens each, with phase 7's exact launch counts of all six
    kernels; GB of weights and the device peak; a profiled stretch of
    their decode steps; (b) prefill plus 8 teacher-forced decode steps
    against the full forward over the same 785 tokens and parameters
    (dbrx: ``pallas`` against ``naive``; deepseek: the absorbed latent
    decode against the decompressed forward), bf16 at 2 layers within
    6e-2 × max |logit| and f32 at 1 layer within 1e-4 × max |logit| with
    every routing choice equal; the share of (token, expert) choices on
    which the two paths agree; a compared position whose bf16 routing
    flipped is reported and left out of the logit bound, its router
    logits (like every position's up to its first flip) held to the same
    bound; (c) both attention kernels against their plain versions at
    dbrx's shapes (48 query heads on 8 KV heads, Dh = 128); (d) the
    frontend's nine balancers, each serving 8 requests of the launcher's
    workload (``olmo-tiny``, ``rwkv-tiny``): ``hermes_select`` launched
    once a dispatch under ``H`` and never otherwise, the carried state of
    HIKU, DD and SWARM on the card; (e) ``python -m
    repro_torch.launch.serve --backend models --requests 12`` in a
    subprocess on the card beside (d): exit 0 and 12 lines in the
    reference's format; the phase ≤ 60 s;
19. the training path (``repro_torch.training``): (a) olmo-1b at its
    published widths and all 16 layers, f32 parameters, bf16 compute,
    ``remat="full"``, AdamW with the launcher's defaults (lr 3e-4), lcg
    data at batch 8 × seq 64 in 2 microbatches, 6 steps: ms a step (the
    median of the last 4, host clock around a synchronised step), the
    device peak, loss and grad norm finite at every step; (b) in f32 from
    the same initial weights, one step's loss and gradients on the card
    against the CPU's (worker processes, started before phase 18 and run
    beside it) on a 2 × 64 lcg batch, for olmo-1b at 1 layer, rwkv6-3b at
    2 and zamba2-2.7b at 6 (its shared block once), published widths: the
    loss within 1e-5 relative, every gradient leaf within 1e-4 × its max
    |value| (rwkv6-3b 4e-4: its f32 gradients at published widths differ
    by 1.27e-4 on the CPU against themselves), ``adamw_update`` fed the
    CPU's gradients on both sides within 1e-6 × max |p|; the scans
    through their kernels under
    autograd, launched once a layer and once more in the remat
    recompute (counted); (c) ``python -m repro_torch.launch.train
    --smoke --arch olmo-1b --steps 60 --lr 1e-2 --batch 4 --seq 32
    --ckpt-every 20`` in a subprocess on the card beside (b): exit 0, the
    reference's line with the final loss at least 0.5 below the first, at
    most ``keep`` checkpoint directories; the phase ≤ 45 s;
20. the numpy oracle (``repro_torch.core.sim_ref``) against the card:
    runs that the card made, each held replication by replication to the
    oracle's run of the same inputs at the reference's own oracle
    tolerances (``oracle_gaps``: ``worker``, ``cold``, ``rejected`` and
    the telemetry's and timeline's integer planes equal; ``response`` and
    the end time within 1e-6 s; server and core time within 1e-3
    relative; ``prov_core_s`` within 1e-9 relative; the telemetry's and
    timeline's float integrals within 1e-9), the largest gap of each lane
    printed beside its bound.  The oracle runs in two spawned worker
    processes of its own, started before phase 5 and fed as each earlier
    phase's card runs are made, so that it runs beside the later phases.
    (a) The nine balancers fused (E/<B>/PS) on the paper's small cluster
    (4 × 12 cores, 96 slots), ``ms-trace`` at the fig4 loads, seed 1, the
    first 1000 arrivals, launched here; (b) phase 5's card runs at N =
    300: fig4's E/{H,LL,LOC,R}/PS, the overloaded 4 × 3 cluster's four
    and E/H/FCFS, E/H/SRPT (the batched engine, ``hermes_select`` once an
    arrival) and late binding; and ``ServingCluster`` with Hermes on the
    card with no platform overheads (``hermes_select`` once an arrival),
    under fig12's budgeted FIXED_TTL with telemetry and under a
    ``two-gen`` fleet with ``TARGET_P99``, 1000 arrivals each, launched
    here; (c) the planes: phase 14's fused runs of the first 500 arrivals
    of fig12's six lanes (the life plane: its budget lane under the three
    keep-alives, its balancer lane), phase 15's of fig13's 24 runs (a
    ``two-gen`` fleet, static fleets and ``TARGET_P99``, with telemetry:
    the observation plane and ``prov_core_s``), phase 16's parity stacks (the timeline plane); (d)
    phase 17's fused E/LL/PS stream at chunk 80 (N = 240, R = 2): the
    kernel's telemetry carry after each chunk against
    ``simulate_ref_chunks``' snapshot, and the stream's outputs; the
    phase ≤ 20 s;
21. sharded execution (``repro_torch.distribution.sharding``): two rank
    processes on the one card over a ``gloo`` group with CUDA tensors
    (NCCL refuses two ranks on one device; gloo stages the tensors
    through the host, every product runs on the card), started before
    phase 18 (imports, the rendezvous, the (data 1 x model 2) mesh and a
    probe of gloo: all-gather, reduce-scatter, all-to-all and a DTensor
    tensor-parallel product with its backward, each named if it fails),
    each sharded run against rank 0's one-device run of the same code
    from the same weights: (a) olmo-1b at published widths, 2 layers,
    f32, 2 AdamW steps (the launcher's optimizer): the loss within 2e-3,
    every parameter allclose 1e-3, DTensor's collectives a step counted;
    (b) olmo-1b, 2 layers, bf16, ``pallas``: a prefill of 777 and 32
    decode steps within 6e-2 × max |logit|, ``flash_attention`` 2 and
    ``decode_attention`` 64 launches a rank, each on 8 local heads; (c)
    gemma-2b, 2 layers, f32, its cache's sequence dim sharded over
    ``model``: 4 decode steps through the seq-sharded flash-decode,
    allclose 1e-3; (d) one dbrx-132b MoE layer (8 experts a rank, bf16),
    512 tokens through ``moe_ep`` at capacity factor 16 against
    ``moe_dense``: allclose 2e-2 where the routing agrees, flips counted,
    aux within 1e-3, no token dropped (drops at the published 1.25
    counted); (e) the compressed step on (pod 2 x data 1 x model 1), 3
    steps: the loss falls, the first update within 1e-6 × max |p| of
    AdamW on the int8 sync of the two pods' gradients; the phase ≤ 30 s;
22. the sharded forward of the recurrent families on phase 21's two
    ranks, after 21e, each sharded run against rank 0's one-device run of
    the same code from the same weights (built on the card from the
    seed): (a) rwkv6-3b at published widths (40 heads of 64), 2 layers,
    f32: a prefill of 777 and 8 decode steps, the WKV scan in a manual
    region on each rank's 20 local heads (``rwkv6_wkv`` once a layer a
    rank in the prefill, counted); (b) zamba2-2.7b at published widths
    (80 SSD heads of 64), 6 layers (its shared block once), f32,
    ``pallas``: the same, ``mamba2_ssd`` on 40 local heads once a layer,
    ``flash_attention`` once and ``decode_attention`` once a decode step on
    16; logits within 1e-4 × max |logit|, the carried state allclose 1e-3;
    no DTensor reaches a kernel's entry point; (c) each model's loss and
    gradients on a 2 × 64 batch (``ScanGrad`` on local heads, remat as
    published), each rank's gradient shards against its own one-device
    run's: the loss within 2e-3, every leaf within 1e-3 × its max |value|;
    DTensor's collectives counted; the phase ≤ 15 s;
23. sharded MoE training on phase 21's two ranks, after phase 22: one
    dbrx-132b MoE layer at published widths (d 6144, 16 experts top 4,
    d_ff 10752), f32, 256 tokens, capacity factor 16 (21d's), the loss a
    fixed projection of the output plus the router's aux: its gradients
    through ``moe_ep`` on each rank's 8 local experts against the rank's
    own one-device gradients from the same weights (one leaf at a time;
    no gradient crosses gloo): every routing choice equal, no token
    dropped, the loss within 2e-3, every leaf within 1e-3 × its max
    |value|; DTensor's collectives counted; the phase ≤ 10 s;
24. the dry-run census (``repro_torch.launch.dryrun``) on the host, in
    four spawned processes of its own started before phase 21, beside
    phases 21-23 (torch's fake process group, one world a process,
    nothing allocated on any device): olmo-1b's
    ``decode_32k`` at full depth on the 16 × 16 and 2 × 16 × 16 meshes and
    dbrx-132b's ``train_4k`` through the two-point fit, each ``ok``, its
    per-rank peak against the card's memory; the roofline's three terms
    (``repro_torch.roofline.analysis``, the H100's data-sheet rates) of
    19a's step on one device (a 1 × 1 world) beside 19a's measured ms, as
    measured ÷ bound; the phase ≤ 20 s.

TF32 is off for matrix products and cuDNN throughout.  The line before the
last is ``{"kernels": [...]}``; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout, it exits non-zero and prints no result.  Every number also
goes into one ``report {...}`` line (JSON after the word), printed
whether or not a phase failed.
"""
from __future__ import annotations

import contextlib
import json
import math
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
#: H100 SXM device-memory rate (NVIDIA data sheet), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core peak (NVIDIA data sheet), flop/s
BF16_FLOPS_PER_S = 989e12
#: H100 SXM f64 peak outside the tensor cores (NVIDIA data sheet), flop/s
F64_FLOPS_PER_S = 34e12
#: H100 SXM special-function throughput, exp/s: 16 SFU lanes per SM
#: (Hopper architecture white paper) × 132 SMs × 1.98 GHz boost clock
SFU_PER_S = 16 * 132 * 1.98e9
LOADS = (0.5, 0.7, 0.9, 0.97)
#: the fig4 quick depth, run by the fused engine (E/{H,LL,LOC,R}/PS)
N_MAIN = 12_000
#: the batched engine's runs (the plain Hermes "before" and late binding)
#: take ~7 ms an arrival on the host, so they run the first N_BATCHED
#: arrivals of the main workload, to keep the whole check inside its time
N_BATCHED = 500
#: phase 5 holds the fused E/{H,LL,LOC,R}/PS runs to the plain engine on
#: fig4's cluster over this many arrivals: by then the tasks in flight
#: reach 90 % of their steady count under H, LL and R at every load, and
#: 80 % under LOC, whose workers share cores from the start
#: (``tools/fig4_in_flight.py``)
N_CHECK = 3000
N_SHORT = 300
SEED = 1


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str, report: dict):
        self.name, self.report = name, report

    def __enter__(self):
        self.t0 = time.perf_counter()
        log(f"== {self.name}")
        return self

    def __exit__(self, *exc):
        s = time.perf_counter() - self.t0
        self.report.setdefault("phase_s", {})[self.name] = s
        log(f"== {self.name}: {'ok' if exc[0] is None else 'FAILED'} "
            f"in {s:.2f} s")
        return False


def environment(torch, report):
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    cap = torch.cuda.get_device_capability(0)
    log(f"device 0: {torch.cuda.get_device_name(0)}, capability {cap}, "
        f"{torch.cuda.device_count()} visible")
    check(cap == (9, 0), f"needs a Hopper card (9, 0), got {cap}")
    report["card"] = card
    report["total_memory"] = torch.cuda.get_device_properties(0).total_memory
    log(f"device 0 memory: {report['total_memory'] / 1e9:.2f} GB")


def ptxas_resources(text: str) -> list[tuple[str, str, str]]:
    """(kernel, registers, spills) of each entry function in ``nvcc
    -Xptxas -v`` output, names demangled where ``c++filt`` is found."""
    import re
    import shutil
    rows, name, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            name, spill = m.group(1), ""
        elif "spill" in line:
            spill = line.strip()
        elif name and "Used" in line and "registers" in line:
            rows.append((name, line.split(":", 1)[1].strip(), spill))
            name = None
    if rows and shutil.which("c++filt"):
        out = subprocess.run(["c++filt"], input="\n".join(r[0] for r in rows),
                             capture_output=True, text=True, timeout=60)
        names = out.stdout.splitlines()
        if out.returncode == 0 and len(names) == len(rows):
            rows = [(n.replace("(anonymous namespace)::", ""), *r[1:])
                    for n, r in zip(names, rows)]
    return rows


def build(report):
    from repro_torch.kernels import _build
    secs = _build.build_all()
    for name, s in secs.items():
        log(f"built {name} in {s:.2f} s")
        ptxas = _build.library_path(name).with_suffix(".log").read_text()
        for kernel, regs, spill in ptxas_resources(ptxas):
            log(f"  {kernel.split('(')[0]}: {regs}; {spill}")
    report["build_s"] = secs


def _states(torch, gen, R, N, W, cores, slots, kind):
    """``active [R, W]``, ``warm_cols [R, N, W]`` for one state kind."""
    if kind == "random":
        active = gen.integers(0, slots + 1, (R, W))
    elif kind == "full":
        active = gen.integers(slots, slots + 1, (R, W))
    elif kind == "no-core":
        active = gen.integers(cores, slots, (R, W))
    else:  # "ties": equal loads, no warm executor anywhere
        active = gen.integers(3, 4, (R, W))
    warm = gen.integers(0, 3, (R, N, W)) if kind != "ties" \
        else gen.integers(0, 1, (R, N, W))
    as_dev = lambda x: torch.as_tensor(x.astype("int32"), device="cuda")
    return as_dev(active), as_dev(warm)


def _event_ms(torch, run) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def call_ms(torch, fn, iters) -> float:
    """CUDA-event time per call made from Python, as the engine calls
    it: for a launch-bound function this is the host's launch time."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    return _event_ms(torch, lambda: [fn() for _ in range(iters)]) / iters


def device_ms(torch, fn, iters) -> float:
    """CUDA-event time per call with ``iters`` calls captured in one CUDA
    graph and replayed: the card's own time, without Python between."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return _event_ms(torch, lambda: [graph.replay() for _ in range(5)]) \
        / (5 * iters)


def kernel_vs_plain(torch, np, report, cluster):
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.hermes_select.ref import hermes_select_ref
    C, S = cluster.cores, cluster.slots
    gen = np.random.default_rng(SEED)
    max_err, n_cases = 0, 0
    for W in (100, 1000):
        for R in (1, 8):
            for N in (1, 256):
                for kind in ("random", "full", "no-core", "ties"):
                    active, cols = _states(torch, gen, R, N, W, C, S, kind)
                    ko, ka = hk.hermes_select_batch(active, cols, cores=C,
                                                    slots=S)
                    ro, ra = hermes_select_ref(active, cols, cores=C,
                                               slots=S)
                    torch.cuda.synchronize()
                    err = max(int((ko - ro).abs().max()),
                              int((ka - ra).abs().max()))
                    check(err == 0, f"hermes_select W={W} R={R} N={N} "
                                    f"{kind}: kernel != plain (err {err})")
                    max_err, n_cases = max(max_err, err), n_cases + 1
    log(f"hermes_select: {n_cases} cases, kernel == plain "
        f"(max abs err {max_err})")

    timings = []
    # the main path's shape (R = the fig4 loads, one arrival), then the
    # largest checked shape
    for R, N, W in ((len(LOADS), 1, cluster.n_workers), (8, 256, 1000)):
        active, cols = _states(torch, gen, R, N, W, C, S, "random")

        def kern():
            return hk.hermes_select_batch(active, cols, cores=C, slots=S)

        def plain():
            return hermes_select_ref(active, cols, cores=C, slots=S)

        reps = 200 if N == 1 else 5
        row = dict(R=R, N=N, W=W,
                   ms=device_ms(torch, kern, reps),
                   plain_ms=device_ms(torch, plain, reps),
                   call_ms=call_ms(torch, kern, reps),
                   plain_call_ms=call_ms(torch, plain, reps),
                   bytes=4 * (R * W + R * N * W + R * N + R * W))
        row["bound_ms"] = row["bytes"] / HBM_BYTES_PER_S * 1e3
        timings.append(row)
        log(f"hermes_select R={R} N={N} W={W}: kernel {row['ms']:.6f} ms "
            f"on the card ({row['call_ms']:.6f} ms per call from Python); "
            f"plain version {row['plain_ms']:.6f} ms "
            f"({row['plain_call_ms']:.6f} ms per call; not a yardstick); "
            f"bound {row['bound_ms']:.3e} ms ({row['bytes']} B at "
            f"3.35 TB/s; launch latency is the real floor)")
    # cross-check of the kernel's device time, where the profiler sees it
    active, cols = _states(torch, gen, len(LOADS), 1, cluster.n_workers, C,
                           S, "random")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(100):
            hk.hermes_select_batch(active, cols, cores=C, slots=S)
        torch.cuda.synchronize()
    dev_us = [e.device_time for e in prof.key_averages()
              if "hermes_select" in e.key and e.device_time > 0]
    log(f"profiler device time per hermes_select launch: "
        f"{(f'{dev_us[0]:.3f} us' if dev_us else 'not seen')}")
    report["hermes_select"] = dict(cases=n_cases, max_abs_err=max_err,
                                   timings=timings,
                                   profiler_device_us=dev_us or None)
    return max_err, timings[0]


def profile_main_path(torch, np, report, cluster):
    """Where the main path's time goes: the fused Hermes run of phase 4
    (N_MAIN arrivals, R = 4) on the host clock, beside the kernel's own
    device time on the same inputs (CUDA events around one launch).
    ``torch.profiler`` does not see this launch: its device tracing drops
    what runs at the start of a profile, which here is the whole run."""
    from repro_torch.core import HERMES, ms_trace, replicate_workload
    from repro_torch.core.simulator import LoopStats, simulate_many
    from repro_torch.kernels.sim_engine import kernel as ek

    wb = replicate_workload(ms_trace, cluster, LOADS, N_MAIN, seeds=(SEED,))
    warm_up(cluster)
    stats = LoopStats()
    torch.cuda.synchronize()
    ek.sim_engine.launches = 0
    t0 = time.perf_counter()
    simulate_many(HERMES, cluster, wb, device="cuda", stats=stats)
    torch.cuda.synchronize()
    wall_us = (time.perf_counter() - t0) * 1e6
    launches = ek.sim_engine.launches
    args = engine_inputs(torch, np, wb)
    kernel_us = _event_ms(torch, lambda: ek.sim_engine("H", cluster,
                                                       *args)) * 1e3
    log(f"fused Hermes N={N_MAIN}: wall {wall_us / 1e3:.2f} ms (inputs to "
        f"the card, one sim_engine launch, outputs back), kernel "
        f"{kernel_us / 1e3:.2f} ms on the card = {kernel_us / wall_us:.3f} "
        f"of wall, idle share {1 - kernel_us / wall_us:.3f} at most; "
        f"{launches} sim_engine launch(es), {stats.host_syncs} host syncs "
        f"in the loop, {stats.advance_iters} advance iterations")
    check(launches == 1, f"the fused run launched sim_engine {launches} "
                         f"times, expected 1")
    check(stats.host_syncs == 0, f"{stats.host_syncs} host syncs in the "
                                 f"fused loop")
    report["profile"] = dict(
        n=N_MAIN, wall_us=wall_us, sim_engine_us=kernel_us,
        idle_share=1 - kernel_us / wall_us, sim_engine_launches=launches,
        host_syncs=stats.host_syncs, advance_iters=stats.advance_iters)


def validate(np, out, wb, name, penalty=0.0, speed=None):
    """The reference's invariants (tests/test_simulator.py); a cold start
    adds ``penalty`` to its invocation's work (a scalar, or a cost per
    function), and under a fleet an invocation holds its core for its
    work over its worker's ``speed``."""
    R, N = wb.arrival.shape
    check(out.response.shape == (R, N) and out.worker.dtype == np.int32,
          f"{name}: bad output shape/dtype")
    done = ~out.rejected
    check(bool(np.isfinite(out.response[done]).all()),
          f"{name}: an accepted invocation never completed")
    check(bool((out.response[done] >= wb.service[done] - 1e-6).all()),
          f"{name}: a response is shorter than its service")
    for r in range(R):
        pen = penalty if np.ndim(penalty) == 0 else \
            np.asarray(penalty)[wb.func[r]]
        held = wb.service[r] + pen * out.cold[r]
        if speed is not None:
            held = held / np.asarray(speed)[np.maximum(out.worker[r], 0)]
        work = held[done[r]].sum()
        check(abs(out.core_time[r] - work) < 1e-6 * work,
              f"{name}: core-time {out.core_time[r]} != work {work}")


def warm_up(cluster):
    """Short runs that keep first-use costs (lazy CUDA module loads)
    out of the timed ones."""
    from repro_torch.core import HERMES, LATE_BINDING, ms_trace
    from repro_torch.core.simulator import simulate_many
    wl = ms_trace(cluster, LOADS[-1], 50, seed=SEED)
    for policy, backend in ((HERMES, "auto"), (HERMES, "torch"),
                            (LATE_BINDING, "auto")):
        simulate_many(policy, cluster, [wl], device="cuda", backend=backend)


def engine_inputs(torch, np, wb):
    """The fused engine's input tensors on the card for a workload batch."""
    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device="cuda")
    return (put(wb.arrival, torch.float64), put(wb.func, torch.int32),
            put(wb.service, torch.float64), put(wb.u_lb, torch.float64),
            put(wb.func_home, torch.int32))


def engine_bound(out, n, n_reps, n_functions, budget=False, speed=None
                 ) -> tuple[float, str, int, int]:
    """(ms, "bytes" | "operations", bytes, operations): the least time the
    card could take for a fused run.  Bytes: each input read once (28 B an
    arrival, 4 B a function's home) and each output written once (14 B an
    arrival, 40 B a replication), over 3.35 TB/s; the slot state is the
    function's own working set, which the card can keep on chip.
    Operations: two f64 operations per active task per advance iteration
    (the subtraction of rate*tau and the compare of its finish time), as
    this run's data needed them (the kernel's ``active`` count), over the
    f64 peak.  Under a lifecycle, its state is written once and the
    preset's costs read once, and each placement tests the window of each
    of the worker's pools (a subtraction and an addition each), each
    completion that of its own pool, or of all the worker's pools under a
    ``budget``.  Under the observation plane, only what the run asked
    for: with telemetry returned, its state written once, the edges read
    once, three operations for each busy worker of an advance iteration
    with tau > 0 (the kernel's ``busy_iters``: the busy addition, the
    depth product and addition) and for each recorded completion a
    division and two binary searches of the 1537 edges (11 compares
    each); with a ``speed`` vector not all 1.0, the speeds read once and
    one product for each such busy worker (its rate by its speed; the
    iterations with tau = 0 need it too, so this counts at least what
    the run needs); under the autoscaler, its state written once and the
    provisioned-time integral's three operations an arrival (its rare
    decisions are not counted).  Under the timeline, its state written
    once, one addition for each busy worker of an advance iteration with
    tau > 0 (the windowed busy integral), four operations an arrival (the
    provisioned core-seconds over the gap) and, for each completion the
    telemetry did not record, the division and the two searches that give
    its coarse bins (window indices are index arithmetic, not counted).
    The chain of dependent barriers, not either of these, is what holds
    the kernel back."""
    nbytes = n_reps * (42 * n + 4 * n_functions + 40)
    ops = 2 * int(out["active"].sum())
    if "life_pre" in out:
        placed = int((~out["rejected"]).sum())
        ops += placed * 2 * (n_functions + (n_functions if budget else 1))
        nbytes += 8 * n_functions + sum(
            v.numel() * v.element_size() for k, v in out.items()
            if k.startswith("life_"))
    busy = int(out["busy_iters"].sum()) if "busy_iters" in out else 0
    if "tel_slow_hist" in out:
        ops += 3 * busy + 23 * int(out["tel_slow_hist"].sum())
        nbytes += 8 * 1537
    if speed is not None and any(float(x) != 1.0 for x in speed):
        ops += busy
        nbytes += 8 * len(speed)
    if "fleet_prov_time" in out:
        ops += 3 * n * n_reps
    if "tl_n_on" in out:
        recorded = int(out["tel_slow_hist"].sum()) \
            if "tel_slow_hist" in out else 0
        ops += busy + 4 * n * n_reps + \
            23 * (int(out["tl_slow_hist"].sum()) - recorded)
    nbytes += sum(v.numel() * v.element_size() for k, v in out.items()
                  if k.startswith(("tel_", "fleet_", "tl_")))
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / F64_FLOPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops > t_bytes else "bytes", nbytes, ops)


#: BatchSimOutput plane -> the fused engine's output of the same values
ENGINE_PLANES = dict(response="resp", cold="cold", rejected="rejected",
                     worker="worker_of", server_time="server_time",
                     core_time="core_time", end_time="now")


def same_planes(np, a, b, what: str) -> None:
    """Two runs equal bit for bit in every plane (``b`` a BatchSimOutput;
    ``a`` one too, or the fused engine's output dict)."""
    for plane, key in ENGINE_PLANES.items():
        x = getattr(a, plane) if not isinstance(a, dict) \
            else a[key].cpu().numpy()
        check(np.array_equal(x, getattr(b, plane),
                             equal_nan=plane == "response"),
              f"{what}: not equal in {plane}")


def main_path(torch, np, report, cluster):
    from repro_torch.core import (E_LL_PS, E_LOC_PS, HERMES, LATE_BINDING,
                                  ms_trace, replicate_workload,
                                  summarize_batch_sim)
    from repro_torch.core.simulator import LoopStats, simulate_many
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek

    wb_main = replicate_workload(ms_trace, cluster, LOADS, N_MAIN,
                                 seeds=(SEED,))
    wb_batched = prefix(wb_main, N_BATCHED)
    warm_up(cluster)
    runs, outs = {}, {}
    launches = 0
    # the fused engine at the quick depth and on the first N_BATCHED
    # arrivals, then the batched engine on those: the plain Hermes run (the
    # "before", and what the fused runs must equal) and late binding
    for policy, backend, wb in ((HERMES, "auto", wb_main),
                                (E_LL_PS, "auto", wb_main),
                                (E_LOC_PS, "auto", wb_main),
                                (HERMES, "auto", wb_batched),
                                (HERMES, "torch", wb_batched),
                                (LATE_BINDING, "auto", wb_batched)):
        n = wb.n
        fused = backend == "auto" and policy != LATE_BINDING
        stats = LoopStats()
        torch.cuda.synchronize()
        ek.sim_engine.launches = 0
        hk.hermes_select_batch.launches = 0
        t0 = time.perf_counter()
        out = simulate_many(policy, cluster, wb, device="cuda",
                            backend=backend, stats=stats)
        wall = time.perf_counter() - t0
        counts = (ek.sim_engine.launches, hk.hermes_select_batch.launches)
        want = (1, 0) if fused else (0, 0)
        check(counts == want, f"{policy.name} ({backend}): sim_engine and "
                              f"hermes_select launched {counts}, expected "
                              f"{want}")
        if fused:
            launches += counts[0]
            check(stats.host_syncs == 0, f"{policy.name}: {stats.host_syncs} "
                                         f"host syncs in the fused loop")
        validate(np, out, wb, policy.name)
        summ = summarize_batch_sim(out, wb)
        per_load = [dict(load=load, slow_p99=s.slow_p99,
                         cold_frac=s.cold_frac, n_rejected=s.n_rejected)
                    for load, s in zip(LOADS, summ.per_rep)]
        key = f"{policy.name} {'fused' if fused else 'batched'}" + (
            f" (first {n})" if fused and n != N_MAIN else "")
        outs[key] = out
        runs[key] = dict(
            n=n, wall_s=wall, us_per_arrival=wall / n * 1e6,
            sim_engine_launches=counts[0], advance_iters=stats.advance_iters,
            pop_iters=stats.pop_iters, host_syncs=stats.host_syncs,
            per_load=per_load)
        log(f"{key} N={n}: {wall:.3f} s ({wall / n * 1e6:.2f} us per "
            f"arrival), sim_engine {counts[0]} launch(es), "
            f"{stats.advance_iters} advance iters, {stats.pop_iters} queue "
            f"pops, {stats.host_syncs} host syncs")
        for row in per_load:
            log(f"  load {row['load']}: p99 slowdown {row['slow_p99']:.3f}, "
                f"cold {row['cold_frac']:.4f}, rejected {row['n_rejected']}")
    plain = outs[f"{HERMES.name} batched"]
    same_planes(np, outs[f"{HERMES.name} fused (first {N_BATCHED})"], plain,
                f"{HERMES.name} N={N_BATCHED}: sim_engine vs the plain "
                f"engine")
    same_prefix(np, outs[f"{HERMES.name} fused"], plain,
                f"{HERMES.name} N={N_MAIN}: sim_engine vs the plain engine")
    log(f"{HERMES.name} N={N_BATCHED}: sim_engine == plain engine on the "
        f"card, all planes; at N={N_MAIN} its first {N_BATCHED} arrivals "
        f"== the plain run in worker, cold, rejected")
    before = runs[f"{HERMES.name} batched"]["us_per_arrival"]
    for policy in (HERMES, E_LL_PS, E_LOC_PS):
        us = runs[f"{policy.name} fused"]["us_per_arrival"]
        log(f"{policy.name}: fused {us:.2f} us per arrival at N={N_MAIN}, "
            f"{before / us:.0f}x below the plain engine's Hermes "
            f"({before:.1f} us at N={N_BATCHED})")
        check(us <= 100 and before / us >= 50,
              f"{policy.name}: fused {us:.2f} us per arrival (needs <= 100 "
              f"and >= 50x below the plain engine's {before:.1f})")

    # the fused kernel's own device time (CUDA events around one launch)
    # on the plain Hermes run's inputs, beside that run's synchronised wall
    # time and the bound; its output must be that run's, plane for plane
    args = engine_inputs(torch, np, wb_batched)
    ek.sim_engine("H", cluster, *args)
    torch.cuda.synchronize()
    out = {}
    ms = _event_ms(torch, lambda: out.update(
        ek.sim_engine("H", cluster, *args)))
    same_planes(np, out, plain, f"{HERMES.name} N={N_BATCHED}: the timed "
                                f"sim_engine launch vs the plain engine")
    plain_ms = runs[f"{HERMES.name} batched"]["wall_s"] * 1e3
    bound_ms, bound_by, nbytes, ops = engine_bound(
        out, N_BATCHED, len(LOADS), wb_main.n_functions)
    log(f"sim_engine E/H/PS R={len(LOADS)} N={N_BATCHED}: kernel {ms:.3f} ms "
        f"on the card (one launch; {ms / N_BATCHED * 1e3:.3f} us per "
        f"arrival), equal to the plain engine in every plane; plain batched "
        f"engine {plain_ms:.1f} ms; bound {bound_ms:.5f} ms, {bound_by} "
        f"({nbytes} B at 3.35 TB/s; {ops} f64 operations at 34 TFLOP/s over "
        f"{int(out['iters'].sum())} advance iterations; the chain of "
        f"dependent barriers is the real floor)")
    timing = dict(R=len(LOADS), N=N_BATCHED, ms=ms, plain_ms=plain_ms,
                  bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                  operations=ops, iters=int(out["iters"].sum()),
                  active=int(out["active"].sum()))
    report["main_path"] = dict(n=N_MAIN, n_batched=N_BATCHED, loads=LOADS,
                               seed=SEED, sim_engine_launches=launches,
                               runs=runs, sim_engine=timing)
    return launches, timing


def card_vs_cpu(np, card, cpu, what: str) -> float:
    """Integer planes equal, floats within 1e-9 s; returns the gap."""
    for p in ("cold", "rejected", "worker"):
        check(np.array_equal(getattr(card, p), getattr(cpu, p)),
              f"{what}: card != CPU in {p}")
    gap = 0.0
    for p in ("response", "server_time", "core_time", "end_time"):
        a = np.nan_to_num(getattr(card, p), nan=-1.0)
        b = np.nan_to_num(getattr(cpu, p), nan=-1.0)
        gap = max(gap, float(np.abs(a - b).max()))
    check(gap <= 1e-9, f"{what}: card vs CPU float gap {gap} > 1e-9")
    return gap


def end_to_end(torch, np, report, cluster, pool, oracle=None):
    """Phase 5: the kernel paths against the plain paths.  The batched
    engine's runs that hold them (on the card and on the CPU) and the
    fused kernel's plain version (``sim_engine_ref``, on the CPU) go to
    ``pool``'s workers while the card runs the kernel paths here; the
    card's runs at N_SHORT go to ``oracle`` (phase 20b).  Returns the
    kernel's max abs error against its plain version."""
    from repro_torch.core import (E_LL_PS, E_LOC_PS, E_R_PS, HERMES,
                                  LATE_BINDING, ClusterCfg, WorkerSched,
                                  ms_trace, replicate_workload,
                                  stack_workloads, synth_workload)
    from repro_torch.core.simulator import LoopStats, simulate_many
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek

    fused = (HERMES, E_LL_PS, E_LOC_PS, E_R_PS)
    # Hermes under the other schedulers keeps the batched engine, with the
    # hermes_select kernel making each arrival's choice
    per_arrival = tuple(HERMES._replace(sched=s)
                        for s in (WorkerSched.FCFS, WorkerSched.SRPT))

    def same(a, b, what):
        same_planes(np, a, b, f"{what}: kernel path vs plain engine")

    # the fused kernel against the plain batched engine, both on the card,
    # and Hermes' against the CPU's run; then every policy of phase 4,
    # E/R/PS, E/H/FCFS and E/H/SRPT, card against CPU, on the fig4 cluster
    # at a short horizon and on an overloaded 4x3-core cluster where
    # rejections, evictions and the late-binding queue occur, each with
    # its launch counts; the kernel paths also against the plain engine
    # on the card, and the fused kernel against its plain version
    wb = replicate_workload(ms_trace, cluster, LOADS, N_CHECK, seeds=(SEED,))
    tiny = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                      cold_start_penalty=0.25)
    cases = (
        ("fig4", cluster, replicate_workload(ms_trace, cluster, LOADS,
                                             N_SHORT, seeds=(SEED,))),
        ("overload", tiny, stack_workloads(
            synth_workload(tiny, load, N_SHORT, n_functions=5,
                           hot_fraction=0.8, seed=SEED)
            for load in (1.3, 3.0, 6.0))))
    # (key, device) -> plain_run's arguments, longest first; the CPU's
    # runs take the default backend, as a user's CPU run does
    fig4_key = {p: f"{p.name} fig4 N={N_CHECK}" for p in fused}
    jobs = {(fig4_key[p], "cuda"): (p, cluster, wb, "cuda") for p in fused}
    jobs[fig4_key[HERMES], "cpu"] = (HERMES, cluster, wb, "cpu", None,
                                     "auto")
    ref_jobs = {}
    for label, cl, wbs in cases:
        for policy in (*fused, *per_arrival, LATE_BINDING):
            key = f"{policy.name} {label} N={N_SHORT}"
            jobs[key, "cpu"] = (policy, cl, wbs, "cpu", None, "auto")
            if policy != LATE_BINDING:
                jobs[key, "cuda"] = (policy, cl, wbs, "cuda")
            if policy in fused:
                ref_jobs[key] = (policy.balance, cl, wbs)
    t0 = time.perf_counter()
    plain_done = pool.starmap_async(plain_run, jobs.values(), chunksize=1)
    ref_done = pool.starmap_async(plain_engine_ref, ref_jobs.values(),
                                  chunksize=1)

    # the kernel paths on the card, while the workers run
    kern = {p: simulate_many(p, cluster, wb, device="cuda") for p in fused}
    card = {}
    for label, cl, wbs in cases:
        for policy in (*fused, *per_arrival, LATE_BINDING):
            stats = LoopStats()
            backend = "kernel" if policy in per_arrival else "auto"
            ek.sim_engine.launches = 0
            hk.hermes_select_batch.launches = 0
            out = simulate_many(policy, cl, wbs, device="cuda",
                                backend=backend, stats=stats)
            counts = (ek.sim_engine.launches,
                      hk.hermes_select_batch.launches)
            want = (1, 0) if policy in fused else \
                (0, N_SHORT) if policy in per_arrival else (0, 0)
            key = f"{policy.name} {label} N={N_SHORT}"
            check(counts == want, f"{key} ({backend}): sim_engine and "
                                  f"hermes_select launched {counts}, "
                                  f"expected {want}")
            card[key] = (out, counts, stats)
            if oracle is not None and (label == "overload"
                                       or policy in fused):
                oracle.hold("20b", key, policy, cl, wbs, out, counts)

    done = dict(zip(jobs, plain_done.get()))
    plain = {k: out for k, (out, _) in done.items()}
    plain_s = time.perf_counter() - t0
    log(f"N={N_CHECK}: the plain runs' walls, s: " + ", ".join(
        f"{k[0].split()[0]} on {k[1]} {done[k][1]:.1f}"
        for k in jobs if k[0] in fig4_key.values()))
    for policy in fused:
        same(kern[policy], plain[fig4_key[policy], "cuda"],
             f"{policy.name} fig4 N={N_CHECK}")
        log(f"{policy.name} N={N_CHECK}: sim_engine == plain engine on the "
            f"card, all planes")
    key = fig4_key[HERMES]
    gaps = {key: card_vs_cpu(np, kern[HERMES], plain[key, "cpu"], key)}
    log(f"N={N_CHECK}: {HERMES.name} card == CPU in integer planes, max "
        f"float gap {gaps[key]}")
    for key, (out, counts, stats) in card.items():
        gaps[key] = card_vs_cpu(np, out, plain[key, "cpu"], key)
        log(f"{key}: card == CPU in integer planes, max float gap "
            f"{gaps[key]}; {int(out.rejected.sum())} rejected, "
            f"{stats.pop_iters} queue pops; sim_engine and hermes_select "
            f"launched {counts}")
        if (key, "cuda") in plain:
            same(out, plain[key, "cuda"], key)
            log(f"{key}: kernel path == plain engine on the card in every "
                f"plane")
    max_err = 0.0
    for (key, job), ref in zip(ref_jobs.items(), ref_done.get()):
        max_err = max(max_err, kernel_vs_ref(torch, np, job, ref, key))
    log(f"sim_engine == sim_engine_ref (on the CPU) for "
        f"{', '.join(p.name for p in fused)} on both clusters at "
        f"N={N_SHORT}: every plane (max abs err {max_err})")
    log(f"{len(jobs) + len(ref_jobs)} plain runs in {PLAIN_WORKERS} worker "
        f"processes: {plain_s:.1f} s from their start")
    report["end_to_end"] = dict(n=N_CHECK, n_short=N_SHORT,
                                card_vs_cpu_max_gap=gaps,
                                sim_engine_max_abs_err=max_err,
                                plain_runs_s=plain_s)
    return max_err


# -- attention and serving (phases 6-8, and 10-11 for the recurrent models) --

ATTN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
#: (B, S, H, KV, Dh): tests/test_kernels.py's shapes, qwen3-14b (GQA) and
#: granite-20b (MQA) attention, the served prompt shapes (zamba2-2.7b's
#: shared attention at Dh = 80 among them) and gemma-2b's (Dh = 256, 8
#: query heads on 1 KV head)
FLASH_CASES = ((2, 256, 4, 2, 64), (1, 128, 8, 8, 128), (2, 256, 4, 1, 128),
               (1, 192, 6, 2, 32), (1, 777, 40, 8, 128), (1, 777, 48, 1, 128),
               (1, 777, 16, 16, 128), (1, 1500, 16, 16, 128),
               (1, 777, 32, 32, 64), (1, 777, 32, 32, 80),
               (1, 1500, 32, 32, 80), (1, 777, 8, 1, 256),
               (1, 1500, 8, 1, 256))
#: (B, S_max, H, KV, Dh, pos): tests/test_kernels.py's shapes with its
#: draw of pos (None), the GQA/MQA heads, batched caches whose splits hold
#: several chunks (the kernel's two-stage ring, with one and with several
#: p.V units per thread), the served caches and gemma-2b's
DECODE_CASES = ((2, 512, 4, 2, 64, None), (3, 256, 8, 1, 128, None),
                (1, 2048, 40, 8, 128, 776), (1, 2048, 48, 1, 128, 776),
                (8, 2048, 32, 8, 128, None), (40, 2048, 16, 1, 128, None),
                *((1, 2048, 16, 16, 128, p) for p in (0, 776, 2047)),
                *((1, 2048, 32, 32, 64, p) for p in (0, 776, 2047)),
                *((1, 2048, 32, 32, 80, p) for p in (0, 776, 2047)),
                *((1, 2048, 8, 1, 256, p) for p in (0, 776, 2047)))
#: the timed shapes (bf16, as served): the headline of each kernel first
FLASH_TIMED = ((1, 777, 16, 16, 128), (1, 1500, 16, 16, 128),
               (1, 777, 32, 32, 64), (1, 1500, 32, 32, 64),
               (1, 777, 32, 32, 80), (1, 1500, 32, 32, 80))
DECODE_TIMED = ((1, 2048, 16, 16, 128, 776), (1, 2048, 16, 16, 128, 2047),
                (1, 2048, 32, 32, 64, 776), (1, 2048, 32, 32, 64, 2047),
                (1, 2048, 32, 32, 80, 776), (1, 2048, 32, 32, 80, 2047))
#: gemma-2b's shapes (Dh = 256, 8 query heads on 1 KV head), timed after
#: the served ones; phase 7 does not serve it, and its one-KV-head cache
#: fills 32 split blocks, not the card
GEMMA_FLASH_TIMED = ((1, 777, 8, 1, 256), (1, 1500, 8, 1, 256))
GEMMA_DECODE_TIMED = ((1, 2048, 8, 1, 256, 776), (1, 2048, 8, 1, 256, 2047))
#: device times (ms) of the kernels before their redesign at the first
#: timed shapes of each, in order (the attention kernels: the CUDA-core
#: flash kernel and the decode kernel with one block per KV head; the
#: scans: one block per (b, h) walking the chunks): bf16,
#: CUDA-graph replay, NVIDIA H100 80GB HBM3 at 700.00 W, as PERF.md §6
#: records them.  A shape with none (gemma-2b's) was not built before.
BEFORE_REDESIGN_MS = {
    "flash_attention": (0.2827, 0.6731, 0.2512, 0.6906, 0.3331, 0.9526),
    "decode_attention": (0.1212, 0.3057, 0.0715, 0.1804, 0.0839, 0.2109),
    "mamba2_ssd": (0.9536, 1.7331),
    "rwkv6_wkv": (0.6625, 1.3520)}
SERVED = (("olmo-1b", 0), ("musicgen-large", 1))
#: phase 8's models: the served ones and gemma-2b (Dh = 256, MQA, GeGLU),
#: which phase 7 does not serve
CHECKED_DENSE = (*SERVED, ("gemma-2b", 4))
#: phase 10's models and weight seeds
RECURRENT = (("rwkv6-3b", 2), ("zamba2-2.7b", 3))
N_REQUESTS = 6
N_NEW = 16
MAX_LEN = 2048
PROMPT_MIN, PROMPT_MAX = 200, 1500
CHECK_PROMPT, CHECK_STEPS = 777, 8
#: decode steps in each profiled stretch (phases 7b, 10b and 18a)
PROFILE_STEPS = 2
#: phase 8's bound on max |Δ logit| / max |logit| for each dtype
MODEL_TOL = {"float32": 1e-4, "bfloat16": 6e-2}
#: phase 11's ratios before each recurrent model's scan kernel was
#: redesigned (PERF.md §6): the bf16 ratios are the ones a rounding change
#: would move
BEFORE_RATIO = {"zamba2-2.7b bfloat16": 5.08e-2,
                "zamba2-2.7b float32": 1.06e-5,
                "rwkv6-3b bfloat16": 4.321e-2,
                "rwkv6-3b float32": 1.350e-5}


def _bound(flops: float, nbytes: float, exps: float = 0.0):
    """The least time the card could take for bf16 operands: (ms,
    "operations" | "bytes").  The products run at the tensor cores' peak
    and the exps on the special-function units beside them; the bytes at
    the memory rate."""
    t_ops = max(flops / BF16_FLOPS_PER_S, exps / SFU_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def _flash_inputs(torch, gen, case, dt):
    B, S, H, KV, Dh = case
    return [torch.randn((B, S, n, Dh), generator=gen, device="cuda").to(dt)
            for n in (H, KV, KV)]


def _decode_inputs(torch, gen, np, case, dt):
    B, S, H, KV, Dh, pos = case
    q = torch.randn((B, H, Dh), generator=gen, device="cuda").to(dt)
    k, v = (torch.randn((B, S, KV, Dh), generator=gen, device="cuda").to(dt)
            for _ in range(2))
    p = np.random.default_rng(0).integers(1, S, B) if pos is None \
        else np.full(B, pos)
    return q, k, v, torch.as_tensor(p, dtype=torch.int32, device="cuda")


def attention_kernels(torch, np, report):
    """Phase 6: both attention kernels against their plain versions, and
    their times beside the plain version, SDPA and the bound."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    cases = []
    for dtype, tol in ATTN_TOL.items():
        dt = getattr(torch, dtype)
        for case in FLASH_CASES:
            q, k, v = _flash_inputs(torch, gen, case, dt)
            got, want = fk.flash_attention(q, k, v), flash_attention_ref(q, k, v)
            cases.append(("flash_attention", dtype, case, got, want, tol))
        for case in DECODE_CASES:
            q, k, v, pos = _decode_inputs(torch, gen, np, case, dt)
            got = dk.decode_attention(q, k, v, pos)
            want = decode_attention_ref(q, k, v, pos)
            cases.append(("decode_attention", dtype, case, got, want, tol))
    torch.cuda.synchronize()
    refused = misaligned_refused(torch, fk, dk)
    errs = {"flash_attention": {}, "decode_attention": {}}
    for name, dtype, case, got, want, tol in cases:
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        errs[name][f"{dtype} {case}"] = err
        log(f"{name} {dtype} {case}: max abs err {err:.3e} "
            f"({'ok' if ok else 'FAILED'} at atol = rtol = {tol})")
        check(ok, f"{name} {dtype} {case}: kernel != plain (err {err})")

    def sdpa(q, k, v, causal):
        return F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=q.shape[1] != k.shape[1])

    timings = {"flash_attention": [], "decode_attention": []}
    dt, size = torch.bfloat16, 2
    for case in FLASH_TIMED + GEMMA_FLASH_TIMED:
        B, S, H, KV, Dh = case
        q, k, v = _flash_inputs(torch, gen, case, dt)
        qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        got = fk.flash_attention(q, k, v)
        row = dict(case=case, dtype="bfloat16",
                   max_abs_err=float((got.float() - flash_attention_ref(
                       q, k, v).float()).abs().max()),
                   ms=device_ms(torch, lambda: fk.flash_attention(q, k, v),
                                20),
                   call_ms=call_ms(torch, lambda: fk.flash_attention(q, k, v),
                                   20),
                   plain_ms=device_ms(torch, lambda: flash_attention_ref(
                       q, k, v), 10),
                   library_ms=device_ms(torch, lambda: sdpa(qh, kh, vh, True),
                                        20))
        row["bound_ms"], row["bound_by"] = _bound(
            2 * B * H * S * S * Dh, size * B * S * Dh * (2 * H + 2 * KV))
        timings["flash_attention"].append(row)
    for case in DECODE_TIMED + GEMMA_DECODE_TIMED:
        B, S, H, KV, Dh, pos = case
        q, k, v, p = _decode_inputs(torch, gen, np, case, dt)
        qh = q[:, :, None].contiguous()
        kh, vh = (x[:, :pos + 1].transpose(1, 2).contiguous() for x in (k, v))
        got = dk.decode_attention(q, k, v, p)
        row = dict(case=case, dtype="bfloat16",
                   max_abs_err=float((got.float() - decode_attention_ref(
                       q, k, v, p).float()).abs().max()),
                   ms=device_ms(torch, lambda: dk.decode_attention(
                       q, k, v, p), 50),
                   call_ms=call_ms(torch, lambda: dk.decode_attention(
                       q, k, v, p), 50),
                   plain_ms=device_ms(torch, lambda: decode_attention_ref(
                       q, k, v, p), 20),
                   library_ms=device_ms(torch, lambda: sdpa(qh, kh, vh,
                                                            False), 50))
        row["bound_ms"], row["bound_by"] = _bound(
            4 * B * H * (pos + 1) * Dh,
            size * (2 * B * (pos + 1) * KV * Dh + 2 * B * H * Dh) + 4 * B)
        timings["decode_attention"].append(row)
    for name, rows in timings.items():
        befores = BEFORE_REDESIGN_MS[name]
        for i, row in enumerate(rows):
            before = befores[i] if i < len(befores) else None
            row["before_redesign_ms"] = before
            log(f"{name} bf16 {row['case']}: kernel {row['ms']:.4f} ms on "
                f"the card ({row['call_ms']:.4f} ms per call from Python; "
                + (f"before the redesign {before:.4f} ms, "
                   f"{before / row['ms']:.2f}x" if before else
                   "not built before the redesign") + "), "
                f"plain {row['plain_ms']:.4f} ms, SDPA "
                f"{row['library_ms']:.4f} ms "
                f"({row['ms'] / row['library_ms']:.2f}x), bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}, "
                f"{row['ms'] / row['bound_ms']:.1f}x); CUDA-graph replay, "
                f"CUDA events")
    report["attention"] = dict(max_abs_err=errs, timings=timings,
                               refused=refused)
    return timings


def misaligned_refused(torch, fk, dk):
    """Both wrappers refuse a cache (or bf16 input) that their 16-byte
    copies cannot read: a view one element off a 16-byte boundary, and a
    row stride that is not a multiple of 8 elements.  Returns the
    messages."""
    B, S, KV, Dh = 1, 256, 2, 64
    shape = (B, S, KV, Dh)
    flat = torch.zeros(1 + B * S * KV * Dh, dtype=torch.bfloat16,
                       device="cuda")
    wide = torch.zeros((B, S, KV, Dh + 1), dtype=torch.bfloat16, device="cuda")
    good = torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    q = torch.zeros((B, 2 * KV, Dh), dtype=torch.bfloat16, device="cuda")
    pos = torch.full((B,), S - 1, dtype=torch.int32, device="cuda")
    cases = {
        "decode_attention, cache one element off": lambda: dk.decode_attention(
            q, flat[1:].view(shape), good, pos),
        "decode_attention, row stride Dh + 1": lambda: dk.decode_attention(
            q, good, wide[..., :Dh], pos),
        "flash_attention, k one element off": lambda: fk.flash_attention(
            good, flat[1:].view(shape), good),
    }
    out = {}
    for what, call in cases.items():
        before = (dk.decode_attention.launches, fk.flash_attention.launches)
        try:
            call()
        except fk.UnsupportedShapeError as e:
            out[what] = str(e)
        check(what in out, f"{what}: the wrapper did not refuse it")
        check((dk.decode_attention.launches,
               fk.flash_attention.launches) == before,
              f"{what}: a refused call counted a launch")
        log(f"refused as it should be: {what} ({out[what][:60]}...)")
    return out


def _counters():
    """Every kernel wrapper, by name: each counts its own launches."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.mamba2_ssd import kernel as sk
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.sim_engine import kernel as ek
    return {"hermes_select": hk.hermes_select_batch,
            "sim_engine": ek.sim_engine,
            "flash_attention": fk.flash_attention,
            "decode_attention": dk.decode_attention,
            "rwkv6_wkv": wk.wkv6, "mamba2_ssd": sk.ssd}


def launches_per_call(cfg):
    """({kernel: launches per prefill}, {kernel: launches per decode step})
    of one model: every T > 1 scan and attention is a kernel under
    ``attn_impl="pallas"``; one-token scans are the plain step; MLA's
    attention is the reference's einsums (no kernel)."""
    L = cfg.n_layers
    if cfg.mla is not None:
        return {}, {}
    if cfg.family == "rwkv6":
        return {"rwkv6_wkv": L}, {}
    if cfg.family == "hybrid":
        n_attn = L // cfg.hybrid_attn_every
        return ({"mamba2_ssd": L, "flash_attention": n_attn},
                {"decode_attention": n_attn})
    return {"flash_attention": L}, {"decode_attention": L}


def weights_gb(torch, cfg) -> float:
    """GB of ``cfg``'s parameters in its param dtype."""
    size = torch.empty((), dtype=cfg.p_dtype).element_size()
    return cfg.n_params() * size / 1e9


def serving_path(torch, np, report, served, prompt_seed, key,
                 n_layers=None):
    """Phases 7, 10 and 18a: 6 requests through ``HermesFrontend`` at
    full width (``n_layers`` cuts the depth), with every kernel's launches
    counted over the run."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.serving.backends import (HermesFrontend, Invocation,
                                              ModelRegistry)
    reg = ModelRegistry()
    cfgs = {}
    for name, seed in served:
        cfgs[name] = dataclasses.replace(
            configs.get(name), attn_impl="pallas",
            n_layers=n_layers or configs.get(name).n_layers)
        reg.register(name, cfgs[name], seed=seed)
        log(f"{name}: {weights_gb(torch, cfgs[name]):.2f} GB of "
            f"{cfgs[name].param_dtype} weights at {cfgs[name].n_layers} "
            f"layers (seed {seed})")
    fe = HermesFrontend(reg, n_workers=2, cores=2, max_len=MAX_LEN,
                        device="cuda")
    rng = np.random.default_rng(prompt_seed)
    invs = []
    for i in range(N_REQUESTS):
        name = served[i % 2][0]
        S = int(rng.integers(PROMPT_MIN, PROMPT_MAX + 1))
        invs.append(Invocation(func=name, n_new=N_NEW,
                               prompt=rng.integers(0, cfgs[name].vocab, S)))
    counters = _counters()
    torch.cuda.synchronize()
    for c in counters.values():
        c.launches = 0
    rows, colds = [], []
    t0 = time.perf_counter()
    for inv in invs:
        fe.dispatch(inv)
        row = dict(func=inv.func, prompt=len(inv.prompt), worker=inv.worker,
                   cold=inv.cold, response_ms=inv.response_s * 1e3,
                   prefill_ms=inv.prefill_s * 1e3,
                   decode_ms_per_token=inv.decode_s / N_NEW * 1e3)
        if inv.cold:
            ex = fe.workers[inv.worker].warm[inv.func]
            row["cold_start_s"] = ex.cold_start_s
            colds.append(inv.func)
        rows.append(row)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {n: c.launches for n, c in counters.items()}
    for row, inv in zip(rows, invs):
        log(f"{row['func']} prompt {row['prompt']}: worker {row['worker']}, "
            f"{'cold' if row['cold'] else 'warm'}, response "
            f"{row['response_ms']:.1f} ms, prefill {row['prefill_ms']:.2f} ms, "
            f"decode {row['decode_ms_per_token']:.3f} ms per token"
            + (f"; cold start {row['cold_start_s']:.3f} s"
               if row["cold"] else ""))
        vocab = cfgs[inv.func].vocab
        check(inv.tokens.shape == (N_NEW,) and bool(
            ((inv.tokens >= 0) & (inv.tokens < vocab)).all()),
            f"{inv.func}: bad tokens {inv.tokens}")
    # a request is one prefill and N_NEW decode steps; a cold start's
    # warm-up is one prefill and one step
    want = {n: 0 for n in counters}
    want["hermes_select"] = N_REQUESTS
    for func, steps in [(i.func, N_NEW) for i in invs] + \
            [(f, 1) for f in colds]:
        per_prefill, per_step = launches_per_call(cfgs[func])
        for n, k in per_prefill.items():
            want[n] += k
        for n, k in per_step.items():
            want[n] += steps * k
    log(f"{N_REQUESTS} requests in {wall:.2f} s; {len(colds)} cold starts; "
        f"launches {launches}, expected {want}")
    for n in want:
        check(launches[n] == want[n], f"{n} launched {launches[n]} times in "
                                      f"the serving path, expected {want[n]}")
    report[key] = dict(wall_s=wall, requests=rows, launches=launches,
                       expected_launches=want,
                       weights_gb={n: weights_gb(torch, c)
                                   for n, c in cfgs.items()})
    return fe, launches


def profile_decode(torch, report, fe, served, key):
    """Phases 7b, 10b and 18a: where a decode step's time goes, per
    model, over PROFILE_STEPS steps (the profiler's own processing of the
    events takes most of the phase, so the steps are few)."""
    from torch.profiler import ProfilerActivity, profile
    out = {}
    n = PROFILE_STEPS
    for name, _ in served:
        ex = next(w.warm[name] for w in fe.workers if name in w.warm)
        model, params = ex.model, ex.params
        toks = torch.zeros((1, CHECK_PROMPT), dtype=torch.long, device="cuda")
        cache = model.init_cache(1, MAX_LEN)
        _, cache = model.prefill(params, toks, cache)
        tok = toks[:, :1]
        pos = torch.arange(CHECK_PROMPT, CHECK_PROMPT + n, dtype=torch.int32,
                           device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(n):      # profiler off: the same steps, rewritten
            _, cache = model.decode_step(params, tok, cache, pos[i:i + 1])
        torch.cuda.synchronize()
        plain_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                _, cache = model.decode_step(params, tok, cache, pos[i:i + 1])
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        kernels = [e for e in prof.key_averages()
                   if e.device_type.name != "CPU"
                   and e.self_device_time_total > 0]
        busy = sum(e.self_device_time_total for e in kernels)
        top = sorted(kernels, key=lambda e: e.self_device_time_total,
                     reverse=True)[:6]
        log(f"{name}: {n} decode steps at pos {CHECK_PROMPT}: wall "
            f"{plain_us / n / 1e3:.2f} ms per step with the profiler off, "
            f"{wall_us / n / 1e3:.2f} ms with it on; device busy "
            f"{busy / n / 1e3:.2f} ms per step = {busy / wall_us:.3f}, idle "
            f"share {1 - busy / wall_us:.3f}; "
            f"{sum(e.count for e in kernels) / n:.0f} kernel launches per "
            f"step")
        for e in top:
            log(f"  {e.key[:70]}: {e.count} calls, "
                f"{e.self_device_time_total / n / 1e3:.3f} ms per step")
        # decode attention inside the step: split + combine kernels per call
        attn = [e for e in kernels if "decode_attention" in e.key]
        calls = sum(e.count for e in attn if "split" in e.key)
        attn_ms = (sum(e.self_device_time_total for e in attn) / calls / 1e3
                   if calls else None)
        if calls:
            log(f"  decode_attention in the step: {calls // n} calls per "
                f"step, {attn_ms:.4f} ms per call (split and combine kernels,"
                f" profiler device time)")
        out[name] = dict(decode_attention_ms_per_call=attn_ms, steps=n,
                         wall_us_per_step=wall_us / n,
                         wall_us_per_step_profiler_off=plain_us / n,
                         busy_us_per_step=busy / n,
                         launches_per_step=sum(e.count for e in kernels) / n,
                         top=[dict(kernel=e.key, count=e.count,
                                   us_per_step=e.self_device_time_total / n)
                              for e in top])
    report[key] = out


def prefill_decode_vs_forward(torch, np, report, served, key):
    """Phases 8 and 11: the kernel path's prefill and decode steps through
    the cache against the full forward over the same tokens, whose
    attention is the plain path (``attn_impl="naive"``; rwkv6 has none,
    and its forward runs the scan kernel over all tokens)."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import build_model
    out = {}
    n = CHECK_PROMPT + CHECK_STEPS
    for name, seed in served:
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, configs.get(name).vocab, (1, n)), device="cuda")
        for dtype, tol in MODEL_TOL.items():
            cfg = dataclasses.replace(configs.get(name), attn_impl="pallas",
                                      dtype=dtype)
            model = build_model(cfg, "cuda")
            plain = build_model(dataclasses.replace(cfg, attn_impl="naive"),
                                "cuda")
            params = model.init(
                torch.Generator(device="cuda").manual_seed(seed))
            want = plain.forward(params, toks)[0][:, CHECK_PROMPT - 1:]
            cache = model.init_cache(1, MAX_LEN)
            logits, cache = model.prefill(params, toks[:, :CHECK_PROMPT],
                                          cache)
            got = [logits]
            for i in range(CHECK_PROMPT, n):
                logits, cache = model.decode_step(
                    params, toks[:, i:i + 1], cache,
                    torch.full((1,), i, dtype=torch.int32, device="cuda"))
                got.append(logits)
            got = torch.cat(got, dim=1).float()
            want = want.float()
            check(got.shape == want.shape and bool(got.isfinite().all()),
                  f"{name} {dtype}: logits {tuple(got.shape)} vs "
                  f"{tuple(want.shape)} or not finite")
            err = float((got - want).abs().max())
            scale = float(want.abs().max())
            # the RMS gap relative to the RMS logit: a quieter reading than
            # the max, which one flipped bf16 rounding can move
            rms = float((got - want).square().mean().sqrt()
                        / want.square().mean().sqrt())
            before = BEFORE_RATIO.get(f"{name} {dtype}")
            log(f"{name} {dtype}: prefill of {CHECK_PROMPT} + {CHECK_STEPS} "
                f"decode steps vs the plain forward over {n} tokens: max "
                f"|Δ| {err:.4e}, max |logit| {scale:.4f}, ratio "
                f"{err / scale:.3e} (bound {tol:g}"
                + (f"; before the scan kernel's redesign: {before:.4g}"
                   if before else "")
                + f"), RMS ratio {rms:.3e}")
            check(err <= tol * scale, f"{name} {dtype}: kernel path != plain "
                                      f"forward ({err} > {tol} × {scale})")
            out[f"{name} {dtype}"] = dict(max_abs_err=err, max_abs_logit=scale,
                                          rms_ratio=rms, bound=tol)
            del params, cache
            torch.cuda.empty_cache()
    report[key] = out


# -- recurrent scans and serving (phases 9-11) ------------------------------

#: phase 9's tolerances: y and the f32 state against the plain chunked form
#: on the same inputs (f32: the same math in another order; bf16: y is
#: rounded to bf16), and f32 against the per-step oracle (tests/test_kernels
#: .py:70's 2e-3: another algorithm)
SCAN_TOL = {"float32": (1e-4, 1e-4), "bfloat16": (2e-2, 2e-3)}
ORACLE_TOL = 2e-3
#: the WKV case drawn with strong decay, lw = -exp(N(2, 1)) (a decay of
#: e^-7.4 a step at the median), which drives e^{lc} and e^{lx} to 0: at
#: rwkv6-3b's widths, two rows, a ragged last chunk and a carry-in state
STRONG_DECAY = (2, 300, 40, 64, 32, True)
#: (B, T, H, K, chunk, carry-in): tests/test_kernels.py's WKV shapes and
#: chunks (and its model-path case), rwkv6-3b's served shapes (H = 40,
#: K = 64, chunk 32; a cold start's 8 tokens and ragged prompts), one
#: nonzero carry-in state and strong decay
WKV_CASES = (*((B, T, H, 64, c, False) for B, T, H in ((2, 128, 3),
                                                       (1, 64, 2))
               for c in (16, 32)),
             (1, 96, 2, 64, 32, False),
             *((1, T, 40, 64, 32, False) for T in (8, 777, 1500)),
             (1, 777, 40, 64, 32, True), STRONG_DECAY)
#: (B, T, H, P, N, chunk, carry-in): tests/test_kernels.py's SSD shapes and
#: chunks, zamba2-2.7b's served shapes (H = 80, P = N = 64, chunk 128) and
#: one nonzero carry-in state
SSD_CASES = (*((B, T, H, P, N, c, False)
               for B, T, H, P, N in ((2, 128, 4, 32, 16), (1, 64, 2, 16, 8))
               for c in (32, 64)),
             *((1, T, 80, 64, 64, 128, False) for T in (8, 777, 1500)),
             (1, 777, 80, 64, 64, 128, True))
#: the timed served shapes (bf16 activations), the headline first
SCAN_TIMED_T = (777, 1500)
def _chunk_lens(T, chunk):
    c = min(chunk, T)
    return [min(c, T - t0) for t0 in range(0, T, c)]


def wkv_work(B, T, H, K, chunk, size, carry):
    """(flops, exps, bytes) a WKV call needs: the strict lower triangle's
    products per chunk, r·exp(lx), k·exp(lc−li) and the state products;
    r, k, v, lw read once, y and the state written once (and the carry-in
    read).  The exps are those the kernel's cut of a chunk needs, into
    16-row tiles and those into 8-row halves: exp(li − lx) in the rows
    inside each diagonal 8 × 8 block (their running products are its
    decays); one per element of each factor of the products below those
    blocks, r·exp(lx − lx_j) and k·exp(lx_j − li), for the lower-left
    8 × 8 block of each diagonal tile (j = 16 i + 8) and for the rows
    s < 16 i below tile row i (j = 16 i); r·exp(lx − lx_16i) in every row
    and exp(lx_16i) in every tile (their product is r·exp(lx)); then
    exp(lc − li) and exp(lc)."""
    flops = exps = 0
    for L in _chunk_lens(T, chunk):
        pairs = L * (L - 1) // 2
        tiles = [min(16, L - s0) for s0 in range(0, L, 16)]
        halves = [min(8, L - s0) for s0 in range(0, L, 8)]
        exps += K * (sum(max(n - 2, 0) for n in halves)
                     + sum(n for n in tiles if n > 8)
                     + sum(16 * i for i in range(1, len(tiles)))
                     + 2 * L + len(tiles) + 1)
        flops += (3 * pairs * K + 3 * L * K + 2 * (pairs + L) * K
                  + 4 * L * K * K + 2 * K * K + 2 * L * K)
    nbytes = (B * T * H * K * (4 * size + 4) + H * K * 4
              + B * H * K * K * 4 * (2 if carry else 1))
    return B * H * flops, B * H * exps, nbytes


def ssd_work(B, T, H, P, N, chunk, size, carry):
    """(flops, exps, bytes) an SSD call needs: C·B once per chunk (shared
    by the heads), the masked scores, M·x, the carry-in C·S and the state
    update per head; x, dt, B, C read once, y and the state written once
    (and the carry-in read)."""
    flops = exps = 0
    for L in _chunk_lens(T, chunk):
        pairs = L * (L + 1) // 2
        flops += 2 * pairs * N + H * (3 * pairs + 2 * pairs * P
                                      + 4 * L * N * P + 2 * L * P
                                      + L * N * P + 2 * P * N)
        exps += H * (pairs + 2 * L + 1)
    nbytes = (B * T * H * P * 2 * size + B * T * H * 4 + 2 * B * T * N * size
              + H * 4 + B * H * P * N * 4 * (2 if carry else 1))
    return B * flops, B * exps, nbytes


def _wkv_inputs(torch, gen, case, dt):
    B, T, H, K, _, carry = case
    r, k, v = (torch.randn((B, T, H, K), generator=gen, device="cuda")
               .mul_(0.5).to(dt) for _ in range(3))
    mu = 2.0 if case == STRONG_DECAY else 0.0
    lw = -torch.exp(torch.randn((B, T, H, K), generator=gen, device="cuda")
                    + mu)
    u = torch.randn((H, K), generator=gen, device="cuda") * 0.1
    s0 = torch.randn((B, H, K, K), generator=gen, device="cuda") \
        if carry else None
    return r, k, v, lw, u, s0


def _ssd_inputs(torch, gen, case, dt):
    B, T, H, P, N, _, carry = case
    x = torch.randn((B, T, H, P), generator=gen, device="cuda").to(dt)
    dt_h = torch.nn.functional.softplus(
        torch.randn((B, T, H), generator=gen, device="cuda"))
    bm, cm = (torch.randn((B, T, N), generator=gen, device="cuda")
              .mul_(0.5).to(dt) for _ in range(2))
    a = -torch.exp(torch.linspace(-1, 1, H, device="cuda"))
    h0 = torch.randn((B, H, P, N), generator=gen, device="cuda") \
        if carry else None
    return x, dt_h, bm, cm, a, h0


def device_launches(torch, fn) -> int:
    """Kernels the card runs per call of ``fn``: the kernel nodes of one
    call captured in a CUDA graph, counted with libcuda's
    ``cuGraphGetNodes``.  The wrappers allocate from PyTorch's caching
    allocator, which adds no node."""
    import ctypes
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    cuda = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    check(cuda.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    check(cuda.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0,
          "cuGraphGetNodes failed")
    kernels, kind = 0, ctypes.c_int()
    for node in nodes:
        check(cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0,
              "cuGraphNodeGetType failed")
        kernels += kind.value == 0     # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def kernel_device_us(torch, fn, calls=10) -> dict:
    """Mean device time of each kernel that ``fn`` launches once per call
    (µs per launch, over the launches ``torch.profiler`` recorded in
    ``calls`` calls after a warm-up call; late in the script it records
    only some of them, and none may be seen), by kernel name."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type.name != "CPU" and e.self_device_time_total > 0:
            name = e.key.replace("(anonymous namespace)::", "")
            name = name.removeprefix("void ").split("(")[0].split("<")[0]
            out[name] = e.self_device_time_total / e.count
    return out


def scan_kernels(torch, report):
    """Phase 9: both scan kernels against their plain chunked forms (and,
    in f32, the per-step oracles), and their times beside the plain
    version and the bound at the served shapes."""
    from repro_torch.kernels.mamba2_ssd import kernel as sk
    from repro_torch.kernels.mamba2_ssd.ref import ssd_chunked_ref, ssd_ref
    from repro_torch.kernels.rwkv6_wkv import kernel as wk
    from repro_torch.kernels.rwkv6_wkv.ref import wkv6_chunked_ref, wkv6_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    kinds = {
        "rwkv6_wkv": (WKV_CASES, _wkv_inputs, wk.wkv6, wkv6_chunked_ref,
                      wkv6_ref),
        "mamba2_ssd": (SSD_CASES, _ssd_inputs, sk.ssd, ssd_chunked_ref,
                       ssd_ref)}
    errs = {name: {} for name in kinds}
    for name, (cases, make, kern, plain, oracle) in kinds.items():
        for dtype, (y_tol, s_tol) in SCAN_TOL.items():
            for case in cases:
                args = make(torch, gen, case, getattr(torch, dtype))
                chunk = case[-2]
                got = kern(*args, chunk=chunk)
                checks = [("plain", plain(*args, chunk=chunk),
                           (y_tol, s_tol))]
                if dtype == "float32":
                    checks.append(("oracle", oracle(*args),
                                   (ORACLE_TOL, ORACLE_TOL)))
                torch.cuda.synchronize()
                for against, want, tols in checks:
                    for part, g, w, tol in zip(("y", "state"), got, want,
                                               tols):
                        check(g.shape == w.shape and g.dtype == w.dtype,
                              f"{name} {dtype} {case}: {part} is "
                              f"{tuple(g.shape)} {g.dtype}, expected "
                              f"{tuple(w.shape)} {w.dtype}")
                        err = float((g.float() - w.float()).abs().max())
                        ok = bool(torch.allclose(g.float(), w.float(),
                                                 rtol=tol, atol=tol))
                        errs[name][f"{dtype} {case} {part} vs {against}"] = \
                            err
                        log(f"{name} {dtype} {case} {part} vs {against}: "
                            f"max abs err {err:.3e} "
                            f"({'ok' if ok else 'FAILED'} at atol = rtol = "
                            f"{tol})")
                        check(ok, f"{name} {dtype} {case}: {part} != "
                                  f"{against} (err {err})")

    timings = {name: [] for name in kinds}
    dt, size = torch.bfloat16, 2
    for T in SCAN_TIMED_T:
        for name, case, work in (
                ("rwkv6_wkv", (1, T, 40, 64, 32, False), wkv_work),
                ("mamba2_ssd", (1, T, 80, 64, 64, 128, False), ssd_work)):
            _, make, kern, plain, _ = kinds[name]
            args = make(torch, gen, case, dt)
            chunk = case[-2]
            got, want = kern(*args, chunk=chunk), plain(*args, chunk=chunk)
            row = dict(case=case, dtype="bfloat16",
                       max_abs_err=float((got[0].float() - want[0].float())
                                         .abs().max()),
                       ms=device_ms(torch, lambda: kern(*args, chunk=chunk),
                                    10),
                       call_ms=call_ms(torch, lambda: kern(*args,
                                                           chunk=chunk), 10),
                       plain_ms=device_ms(torch, lambda: plain(
                           *args, chunk=chunk), 3))
            flops, exps, nbytes = work(*case[:-1], size, case[-1])
            row.update(flops=flops, exps=exps, bytes=nbytes,
                       device_launches=device_launches(
                           torch, lambda: kern(*args, chunk=chunk)),
                       kernel_us=kernel_device_us(
                           torch, lambda: kern(*args, chunk=chunk)))
            row["bound_ms"], row["bound_by"] = _bound(flops, nbytes, exps)
            befores = BEFORE_REDESIGN_MS.get(name, ())
            before = befores[len(timings[name])] \
                if len(timings[name]) < len(befores) else None
            row["before_redesign_ms"] = before
            timings[name].append(row)
            log(f"{name} bf16 {case}: kernel {row['ms']:.4f} ms on the card "
                f"({row['call_ms']:.4f} ms per call from Python; "
                + (f"before the redesign {before:.4f} ms, kernel / before "
                   f"{row['ms'] / before:.3f}; " if before else "")
                + f"{row['device_launches']} device launches per call), "
                f"plain {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({row['bound_by']}: {flops:.3e} "
                f"flop, {exps:.3e} exp, {nbytes} B), kernel / bound "
                f"{row['ms'] / row['bound_ms']:.1f}; CUDA-graph replay, "
                f"CUDA events; by kernel (profiler device time per "
                f"launch): " + (", ".join(f"{k} {us:.2f} us" for k, us in
                                          row["kernel_us"].items())
                                or "not seen"))
    report["scans"] = dict(max_abs_err=errs, timings=timings)
    return timings


# -- trace replay (phase 12) --

#: the trace-replay scenarios of ``repro_torch.trace.catalog``
AZURE = ("azure-diurnal", "azure-bursty", "azure-cold-heavy",
         "azure-flash-crowd", "azure-fixture")
#: fig10's full mode (benchmarks/fig10_trace_replay.py:33-38) on the
#: paper's testbed: its loads, depth and cold-start penalty; seeds 1-5
FIG10_LOADS = (0.3, 0.5, 0.7, 0.85)
FIG10_SEEDS = (1, 2, 3, 4, 5)
FIG10_PENALTY = 0.5
N_FIG10 = 12_000
#: depth of phase 12's batched-engine runs: late binding, and the plain
#: runs that hold the fused ones
N_TRACE_PLAIN = 500
#: the mixed batch: every scenario at this load and seed ``SEED``
MIXED_LOAD = 0.7
#: fig14's horizon lane (benchmarks/fig14_stream.py:57-66): one synthetic
#: Azure-schema day on 1000 workers × 2 cores, capacity factor 2 (4 slots)
HORIZON = dict(n_workers=1000, cores=2, capacity_factor=2)
HORIZON_N = 86_400
#: phase 12's run of the horizon lane: half the day (phase 17 streams the
#: whole day), as the three fused runs of the whole day take ~5 s each of
#: card time alone
TRACE_HORIZON_N = HORIZON_N // 2
TRACE_PHASE_S = 60.0
SCRIPT_S = 600.0
#: worker processes for the batched engine's check runs.  Each run is
#: bound by the host's op issue (~300 launches an arrival), so they go
#: side by side, each in a process of its own; those that need not be on
#: the card run on the CPU, beside the horizon runs, and those on the card
#: after them
PLAIN_WORKERS = 8


def _warm_worker():
    """A worker process's imports and CUDA context, made before its first
    run; one intra-op thread, so that the workers do not oversubscribe the
    host."""
    import torch

    import repro_torch.core.simulator  # noqa: F401
    torch.set_num_threads(1)
    torch.zeros(1, device="cuda")


def plain_run(policy, cluster, wb, device, telemetry=None,
              backend="torch", timeline=None):
    """One run of the batched engine (``backend="torch"``, or on the CPU
    ``"auto"``, whose route is the batched engine too) on ``device``:
    (output, wall s).  Top-level, so that a worker process can run it."""
    from repro_torch.core.simulator import simulate_many
    t0 = time.perf_counter()
    out = simulate_many(policy, cluster, wb, device=device, backend=backend,
                        telemetry=telemetry, timeline=timeline)
    return out, time.perf_counter() - t0


@contextlib.contextmanager
def engine_events(torch):
    """Inside the block, each ``sim_engine`` call that ``simulate_many``
    makes goes through the wrapper as before (which counts the launch),
    with CUDA events on the launching stream just before and just after
    it: yields the list of (start, end, the engine's outputs) it fills."""
    from repro_torch.kernels.sim_engine import kernel as ek
    from repro_torch.kernels.sim_engine import ops
    seen = []

    def timed(*args):
        start, end = (torch.cuda.Event(enable_timing=True) for _ in "se")
        start.record()
        res = ek.sim_engine(*args)
        end.record()
        seen.append((start, end, res))
        return res

    ops.kernel = types.SimpleNamespace(sim_engine=timed)
    try:
        yield seen
    finally:
        ops.kernel = ek


def fused_run(torch, np, policy, cluster, wb, what, telemetry=None,
              timeline=None):
    """One ``simulate_many`` on the card with the launch counts zeroed just
    before it and read just after: (output, wall s, LoopStats, kernel),
    ``kernel`` the launch's device time in ms (CUDA events just around
    it) and the engine's own outputs (``iters``, ``active``).  It must be
    one ``sim_engine`` launch, no ``hermes_select`` launch and no host
    sync."""
    from repro_torch.core.simulator import LoopStats, simulate_many
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek
    stats = LoopStats()
    torch.cuda.synchronize()
    ek.sim_engine.launches = 0
    hk.hermes_select_batch.launches = 0
    with engine_events(torch) as seen:
        t0 = time.perf_counter()
        out = simulate_many(policy, cluster, wb, device="cuda", stats=stats,
                            telemetry=telemetry, timeline=timeline)
        wall = time.perf_counter() - t0
    counts = (ek.sim_engine.launches, hk.hermes_select_batch.launches)
    check(counts == (1, 0) and len(seen) == 1,
          f"{what}: sim_engine and hermes_select launched {counts}, "
          f"expected (1, 0)")
    check(stats.host_syncs == 0, f"{what}: {stats.host_syncs} host syncs "
                                 f"in the fused loop")
    validate(np, out, wb, what, cold_cost(cluster, wb.n_functions),
             speed_of(cluster))
    start, end, res = seen[0]
    return out, wall, stats, dict(ms=start.elapsed_time(end), res=res)


def speed_of(cluster):
    """The cluster's per-worker speeds, ``None`` without a fleet."""
    from repro_torch.fleet import speeds_for
    fleet = cluster.fleet
    return None if fleet is None else speeds_for(fleet, cluster.n_workers)


def cold_cost(cluster, n_functions):
    """What a cold start adds to an invocation's work: the cluster's
    scalar penalty, or its lifecycle preset's cost per function."""
    from repro_torch.lifecycle import cold_costs_for
    life = cluster.lifecycle
    costs = None if life is None else cold_costs_for(life.coldstart,
                                                     n_functions)
    return cluster.cold_start_penalty if costs is None else costs


def prefix(wb, n):
    """The first ``n`` arrivals of each replication of a workload batch."""
    import dataclasses
    return dataclasses.replace(wb, **{
        f: getattr(wb, f)[:, :n] for f in ("arrival", "func", "service",
                                           "u_lb")})


def same_prefix(np, out, plain, what):
    """A fused run's first arrivals equal the plain engine's run of just
    those in ``worker``, ``cold`` and ``rejected``: each arrival's choice
    depends only on the arrivals before it (its response does not)."""
    n = plain.worker.shape[1]
    for plane in ("worker", "cold", "rejected"):
        check(np.array_equal(getattr(out, plane)[:, :n],
                             getattr(plain, plane)),
              f"{what}: the first {n} arrivals differ from the plain "
              f"engine's run of them in {plane}")


def _per_load(out, wb, loads, reps):
    """fig10's rows (benchmarks/common.py ``sweep_policies``): per load,
    the mean and 95 % half-width over its ``reps`` seeds after a 10 %
    warm-up."""
    from repro_torch.core import summarize_batch_sim
    rows = []
    for i, load in enumerate(loads):
        sl = slice(i * reps, (i + 1) * reps)
        row = summarize_batch_sim(out[sl], wb[sl], warmup_frac=0.1).row()
        rows.append(dict(load=load, slow_p99_mean=row["slow_p99_mean"],
                         slow_p99_ci95=row["slow_p99_ci95"],
                         cold_frac_mean=row["cold_frac_mean"],
                         n_rejected=row["n_rejected"]))
    return rows


def _log_rows(label, rows):
    for r in rows:
        log(f"  {label} load {r['load']}: p99 slowdown "
            f"{r['slow_p99_mean']:.3f} ± {r['slow_p99_ci95']:.3f}, cold "
            f"{r['cold_frac_mean']:.4f}, rejected {r['n_rejected']}")


def plain_pool():
    """The worker processes of the batched engine's check runs (phases 5
    and 12-17)."""
    import multiprocessing
    return multiprocessing.get_context("spawn").Pool(
        PLAIN_WORKERS, initializer=_warm_worker)


def trace_replay(torch, np, report, pool):
    """Phase 12: the Azure-schema trace scenarios (``repro_torch.trace``)
    through ``simulate_many`` on the card.  (a) fig10's full mode on the
    testbed, (b) the five scenarios in one mixed batch, (c) fig14's
    horizon lane, each run alone on the card; the batched engine's runs go
    side by side in worker processes, those on the CPU beside (c) and
    those on the card after it, in ``pool``'s workers (idle while (a) and
    (b) run).  Returns the ``sim_engine`` launches of every fused run
    here."""
    from repro_torch.core import (E_LL_PS, E_LOC_PS, HERMES, LATE_BINDING,
                                  PAPER_TESTBED, WORKLOADS, ClusterCfg,
                                  replicate_workload, summarize_batch_sim)
    from repro_torch.trace import (SCENARIOS, load_trace, per_minute_counts,
                                   replay_trace, resample_workloads,
                                   synthesize_trace)
    from repro_torch.trace.catalog import (FIXTURE_DURATIONS,
                                           FIXTURE_INVOCATIONS)

    t_phase = time.perf_counter()
    fused = (HERMES, E_LL_PS, E_LOC_PS)
    testbed = PAPER_TESTBED._replace(cold_start_penalty=FIG10_PENALTY)
    lane_cl = ClusterCfg(**HORIZON)
    reps = len(FIG10_SEEDS)
    gen_s, runs, launches = {}, {}, 0

    def generate(key, make):
        t0 = time.perf_counter()
        wb = make()
        gen_s[key] = time.perf_counter() - t0
        return wb

    def mixed(n):
        return resample_workloads(WORKLOADS[name](testbed, MIXED_LOAD, n,
                                                  SEED) for name in AZURE)

    # the workloads, on the host
    fig10 = {name: generate(f"fig10 {name}", lambda: replicate_workload(
        WORKLOADS[name], testbed, FIG10_LOADS, N_FIG10,
        seeds=FIG10_SEEDS)) for name in AZURE}
    fig10_late = {name: replicate_workload(
        WORKLOADS[name], testbed, FIG10_LOADS, N_TRACE_PLAIN,
        seeds=FIG10_SEEDS) for name in AZURE}
    mixed_main = generate("mixed", lambda: mixed(N_FIG10))
    mixed_check, mixed_short = mixed(N_TRACE_PLAIN), mixed(N_SHORT)
    lane = generate("horizon azure-diurnal", lambda: replicate_workload(
        WORKLOADS["azure-diurnal"], lane_cl, LOADS, TRACE_HORIZON_N,
        seeds=(SEED,)))
    for key, s in gen_s.items():
        log(f"host generation, {key}: {s:.3f} s")

    # host round trip: an unscaled, untiled replay gives the trace's
    # per-minute counts back
    for scen in (*SCENARIOS, "fixture"):
        trace = load_trace(FIXTURE_INVOCATIONS, FIXTURE_DURATIONS) \
            if scen == "fixture" else synthesize_trace(scen, seed=SEED)
        wl = replay_trace(trace, testbed, seed=SEED)
        check(np.array_equal(per_minute_counts(wl, trace.n_functions,
                                               trace.minutes),
                             trace.counts_matrix()),
              f"{scen}: per_minute_counts != the trace's counts")
    log(f"host round trip: per_minute_counts == counts_matrix() for "
        f"{', '.join(SCENARIOS)} and the fixture")

    def fused_logged(policy, cluster, wb, key, gen):
        """``fused_run``, counted and logged with its device time."""
        nonlocal launches
        out, wall, stats, kern = fused_run(torch, np, policy, cluster, wb,
                                           key)
        launches += 1
        ms = kern["ms"]
        runs[key] = dict(n=wb.n, reps=wb.n_reps, wall_s=wall,
                         us_per_arrival=wall / wb.n * 1e6, ms=ms,
                         idle_share=1 - ms / (wall * 1e3),
                         advance_iters=stats.advance_iters, gen_s=gen)
        log(f"{key} W={cluster.n_workers} S={cluster.slots} R={wb.n_reps} "
            f"F={wb.n_functions} N={wb.n}: wall {wall:.3f} s "
            f"({wall / wb.n * 1e6:.2f} us per arrival; host generation "
            f"{gen:.3f} s); sim_engine {ms:.3f} ms on the card, idle share "
            f"{runs[key]['idle_share']:.3f} at most; 1 sim_engine launch, "
            f"0 host syncs, {stats.advance_iters} advance iters")
        return out, kern

    # (a) fig10's full mode, fused, each scenario one batch of R = 20
    summary, fig10_out = {}, {}
    for name, wb in fig10.items():
        for policy in fused:
            key = f"fig10 {name} {policy.name}"
            out, _ = fused_logged(policy, testbed, wb, key,
                                  gen_s[f"fig10 {name}"])
            fig10_out[(name, policy)] = out
            rows = _per_load(out, wb, FIG10_LOADS, reps)
            summary[(name, policy.name)] = runs[key]["per_load"] = rows
            _log_rows(key, rows)

    def cell(name, policy, load):
        return summary[(name, policy.name)][FIG10_LOADS.index(load)]

    h, v, ll = (cell("azure-diurnal", p, 0.5)
                for p in (HERMES, E_LOC_PS, E_LL_PS))
    observed = {
        "hermes_p99_below_half_vanilla": bool(
            h["slow_p99_mean"] < 0.5 * v["slow_p99_mean"]),
        "hermes_fewer_cold_than_ll": bool(
            h["cold_frac_mean"] < ll["cold_frac_mean"])}
    verdict = {k: "holds" if ok else "does not hold"
               for k, ok in observed.items()}
    log(f"fig10 observation (benchmarks/run.py:206-221; not a gate), "
        f"azure-diurnal at 0.5: Hermes p99 slowdown "
        f"{h['slow_p99_mean']:.3f} vs vanilla OW (E/LOC/PS) "
        f"{v['slow_p99_mean']:.3f}: 'Hermes >=50% below' "
        f"{verdict['hermes_p99_below_half_vanilla']}; Hermes cold "
        f"{h['cold_frac_mean']:.4f} vs least-loaded "
        f"{ll['cold_frac_mean']:.4f}: 'fewer cold starts' "
        f"{verdict['hermes_fewer_cold_than_ll']}")

    # (b) the mixed batch, fused: the depth run, and the check runs
    mixed_out = {}
    for policy in fused:
        key = f"mixed {policy.name}"
        out, _ = fused_logged(policy, testbed, mixed_main, key, gen_s["mixed"])
        for name, s in zip(AZURE, summarize_batch_sim(
                out, mixed_main, warmup_frac=0.1).per_rep):
            log(f"  {key} {name}: p99 slowdown {s.slow_p99:.3f}, cold "
                f"{s.cold_frac:.4f}, rejected {s.n_rejected}")
        mixed_out[policy] = tuple(
            fused_logged(policy, testbed, wb, f"{key} N={wb.n}",
                         gen_s["mixed"])[0]
            for wb in (mixed_check, mixed_short))

    # the fused run of each scenario in (a) whose first arrivals are held
    # to the plain engine's: each policy, each F and R = 20 are covered,
    # and the plain runs fit beside (c)
    checked = {name: fused[i % len(fused)] for i, name in enumerate(AZURE)}
    lane_prefix = prefix(lane, N_TRACE_PLAIN)
    # the plain runs that need not be on the card, on the CPU (whose
    # engine the card equals in every plane: the card-vs-CPU check
    # below), while (c) runs: the prefixes of (a) and (c), and (b)'s
    # short batch
    t0 = time.perf_counter()
    cpu_jobs = [(p, testbed, prefix(fig10[name], N_TRACE_PLAIN), "cpu")
                for name, p in checked.items()]
    cpu_jobs += [(p, lane_cl, lane_prefix, "cpu") for p in fused]
    cpu_jobs += [(p, testbed, mixed_short, "cpu")
                 for p in (*fused, LATE_BINDING)]
    cpu_done = pool.starmap_async(plain_run, cpu_jobs, chunksize=1)

    # (c) fig14's horizon lane, each fused run alone on the card
    lane_out, lane_timing = {}, {}
    for policy in fused:
        key = f"horizon {policy.name}"
        out, kern = fused_logged(policy, lane_cl, lane, key,
                                 gen_s["horizon azure-diurnal"])
        lane_out[policy] = out
        bound_ms, bound_by, nbytes, ops = engine_bound(
            kern["res"], lane.n, lane.n_reps, lane.n_functions)
        t = lane_timing[policy.name] = runs[key]
        t.update(iters=int(kern["res"]["iters"].sum()),
                 active=int(kern["res"]["active"].sum()),
                 bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                 operations=ops, rejected=int(out.rejected.sum()))
        log(f"  {key}: sim_engine {t['ms'] / lane.n * 1e3:.3f} us per "
            f"arrival; {t['iters']} advance iters, {t['active']} "
            f"active; bound {bound_ms:.5f} ms, {bound_by} ({nbytes} B, "
            f"{ops} f64 operations), kernel / bound "
            f"{t['ms'] / bound_ms:.0f}; {t['rejected']} rejected")
        for load, s in zip(LOADS, summarize_batch_sim(
                out, lane, warmup_frac=0.1).per_rep):
            log(f"  {key} load {load}: p99 slowdown {s.slow_p99:.3f}, "
                f"cold {s.cold_frac:.4f}, rejected {s.n_rejected}")

    # then the batched engine's runs on the card, longest first
    card_jobs = [(LATE_BINDING, testbed, wb, "cuda")
                 for wb in fig10_late.values()]
    card_jobs += [(p, testbed, mixed_check, "cuda") for p in fused]
    card_jobs += [(LATE_BINDING, testbed, mixed_short, "cuda")]
    card_done = iter(pool.starmap(plain_run, card_jobs, chunksize=1))
    cpu_done = iter(cpu_done.get())
    plain_s = time.perf_counter() - t0
    log(f"{len(cpu_jobs)} batched-engine runs on the CPU, then "
        f"{len(card_jobs)} on the card, in {PLAIN_WORKERS} worker "
        f"processes: {plain_s:.1f} s")

    # the first arrivals of each fused run of (a) and (c) against the
    # plain engine's run of just those
    for name, policy in checked.items():
        plain, wall = next(cpu_done)
        key = f"fig10 {name} {policy.name}"
        validate(np, plain, prefix(fig10[name], N_TRACE_PLAIN),
                 f"{key} prefix", FIG10_PENALTY)
        same_prefix(np, fig10_out[(name, policy)], plain, key)
        log(f"{key}: the first {N_TRACE_PLAIN} arrivals == the plain "
            f"engine's run of them on the CPU in worker, cold, rejected "
            f"({wall:.1f} s)")
    for policy in fused:
        plain, wall = next(cpu_done)
        key = f"horizon {policy.name}"
        validate(np, plain, lane_prefix, f"{key} prefix",
                 lane_cl.cold_start_penalty)
        same_prefix(np, lane_out[policy], plain, key)
        log(f"{key}: the first {N_TRACE_PLAIN} arrivals == the plain "
            f"engine's run of them on the CPU in worker, cold, rejected "
            f"({wall:.1f} s)")
    # late binding on fig10's cells
    for name, wb in fig10_late.items():
        out, wall = next(card_done)
        key = f"fig10 {name} {LATE_BINDING.name}"
        validate(np, out, wb, key, FIG10_PENALTY)
        rows = _per_load(out, wb, FIG10_LOADS, reps)
        runs[key] = dict(n=wb.n, reps=wb.n_reps, wall_s=wall, per_load=rows)
        log(f"{key} R={wb.n_reps} N={wb.n}: batched engine, wall {wall:.3f} "
            f"s beside the other runs (not the engine's own time)")
        _log_rows(key, rows)
    # the mixed batch: fused == plain on the card
    for policy in fused:
        plain, wall = next(card_done)
        same_planes(np, mixed_out[policy][0], plain,
                    f"mixed {policy.name} N={N_TRACE_PLAIN}: sim_engine vs "
                    f"the plain engine")
        log(f"mixed {policy.name} N={N_TRACE_PLAIN}: sim_engine == plain "
            f"engine on the card, all planes ({wall:.1f} s)")
    # the mixed batch: card == CPU
    late_card, _ = next(card_done)
    validate(np, late_card, mixed_short, f"mixed {LATE_BINDING.name}",
             FIG10_PENALTY)
    gaps = {}
    for policy, card in ((*((p, mixed_out[p][1]) for p in fused),
                          (LATE_BINDING, late_card))):
        cpu, _ = next(cpu_done)
        key = f"mixed {policy.name} N={N_SHORT}"
        gaps[key] = card_vs_cpu(np, card, cpu, key)
        log(f"{key}: card == CPU in integer planes, max float gap "
            f"{gaps[key]}; {int(card.rejected.sum())} rejected, "
            f"{int(card.cold.sum())} cold")

    phase_s = time.perf_counter() - t_phase
    report["trace_replay"] = dict(
        fig10=dict(loads=FIG10_LOADS, seeds=FIG10_SEEDS, n=N_FIG10,
                   n_late=N_TRACE_PLAIN, penalty=FIG10_PENALTY,
                   observed=observed),
        horizon=dict(cluster=HORIZON, n=TRACE_HORIZON_N, loads=LOADS,
                     seed=SEED,
                     timing=lane_timing),
        runs=runs, gen_s=gen_s, plain_runs_s=plain_s,
        card_vs_cpu_max_gap=gaps, sim_engine_launches=launches,
        phase_s=phase_s)
    log(f"phase 12: {launches} sim_engine launches, {phase_s:.1f} s")
    check(phase_s <= TRACE_PHASE_S, f"phase 12 took {phase_s:.1f} s "
                                    f"(limit {TRACE_PHASE_S:.0f} s)")
    return launches


# -- the policy zoo (phase 13) --

#: fig11's quick mode (benchmarks/fig11_policy_zoo.py:41-55) on the
#: paper's small cluster: its loads, depth and seed; its mixed lane at
#: half the depth (R = 3, one replication a workload)
FIG11_LOADS = (0.5, 0.7, 0.8, 0.9)
N_FIG11 = 6_000
FIG11_SEED = 0
FIG11_MIXED = ("ms-trace", "azure-diurnal", "azure-bursty")
#: depth of the plain runs that hold phase 13's fused runs
N_ZOO_PLAIN = 500
ZOO_PHASE_S = 60.0


def registry_policies(base):
    """``base`` plus E/<B>/PS for every balancer the port has, in the
    reference's order (``benchmarks/common.py`` ``registry_policies``)."""
    from repro_torch.core import Binding, PolicySpec, WorkerSched
    from repro_torch.policy import balancer_names
    pols, seen = list(base), {p.name for p in base}
    for name in balancer_names():
        cand = PolicySpec(Binding.EARLY, name, WorkerSched.PS)
        if cand.name not in seen:
            pols.append(cand)
            seen.add(cand.name)
    return tuple(pols)


def plain_engine_ref(balance, cluster, wb, telemetry=None, timeline=None):
    """``sim_engine_ref`` on the CPU for a workload batch, as numpy.
    Top-level, so that a worker process can run it."""
    import numpy as np
    import torch

    from repro_torch.kernels.sim_engine.ref import sim_engine_ref

    def put(x, dtype):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
    out = sim_engine_ref(balance, cluster, put(wb.arrival, torch.float64),
                         put(wb.func, torch.int32),
                         put(wb.service, torch.float64),
                         put(wb.u_lb, torch.float64),
                         put(wb.func_home, torch.int32), telemetry, timeline)
    return {k: v.numpy() for k, v in out.items()}


def kernel_vs_ref(torch, np, job, plain, what: str) -> float:
    """``sim_engine`` on the card for one of :func:`plain_engine_ref`'s
    jobs (balance, cluster, workloads[, telemetry]) against that job's
    output ``plain``: the same outputs, dtypes and values, the final state
    included.  These launches compare; they are not a main path's.
    Returns the max abs error."""
    from repro_torch.kernels.sim_engine import kernel as ek
    balance, cl, wb, *tel = job
    got = ek.sim_engine(balance, cl, *engine_inputs(torch, np, wb), *tel)
    check(sorted(got) == sorted(plain),
          f"sim_engine {balance}: outputs {sorted(got)} != the plain "
          f"version's {sorted(plain)}")
    err = 0.0
    for name, want in plain.items():
        a = got[name].cpu().numpy()
        check(a.dtype == want.dtype and np.array_equal(
            a, want, equal_nan=a.dtype.kind == "f"),
            f"{what}: sim_engine != sim_engine_ref in {name}")
        err = max(err, float(np.abs(
            np.nan_to_num(a.astype(np.float64), nan=-1.0)
            - np.nan_to_num(want.astype(np.float64), nan=-1.0)).max()))
    return err


def policy_zoo(torch, np, report, pool):
    """Phase 13: the policy zoo through ``simulate_many`` on the card, all
    fused: (a) fig11's quick mode (two lanes, nine policies), (b) fig11's
    mixed lane, (c) fig4's zoo rows.  The batched engine's runs that hold
    them go to ``pool``'s workers, on the CPU, while the fused runs have
    the card.  Returns (``sim_engine`` launches of the fused runs, the
    kernel's max abs error against ``sim_engine_ref``)."""
    from repro_torch.core import (E_DD_PS, E_HIKU_PS, E_JSQ2_PS, E_RR_PS,
                                  E_SWARM_PS, PAPER_LARGE, PAPER_SMALL,
                                  WORKLOADS, ZOO_POLICIES, ClusterCfg,
                                  bimodal_exec, ms_trace,
                                  replicate_workload, stack_workloads,
                                  summarize_batch_sim, synth_workload)
    from repro_torch.trace import resample_workloads

    t_phase = time.perf_counter()
    zoo = (E_JSQ2_PS, E_RR_PS, E_HIKU_PS, E_DD_PS, E_SWARM_PS)
    fig11 = registry_policies(ZOO_POLICIES)
    small = PAPER_SMALL
    tiny = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                      cold_start_penalty=0.25)

    def mixed(n):
        return resample_workloads(WORKLOADS[name](small, 0.7, n, FIG11_SEED)
                                  for name in FIG11_MIXED)

    lanes = {name: replicate_workload(make, small, FIG11_LOADS, N_FIG11,
                                      seeds=(FIG11_SEED,))
             for name, make in (("ms-trace", ms_trace),
                                ("bimodal-exec", bimodal_exec))}
    mixed_main, mixed_short = mixed(N_FIG11 // 2), mixed(N_SHORT)
    fig4 = replicate_workload(ms_trace, PAPER_LARGE, LOADS, N_MAIN,
                              seeds=(SEED,))
    overload = stack_workloads(
        synth_workload(tiny, load, N_SHORT, n_functions=5, hot_fraction=0.8,
                       seed=SEED) for load in (1.3, 3.0, 6.0))
    # the fused runs whose first arrivals are held to the plain engine's,
    # the longest plain runs first
    held = {"fig4": (PAPER_LARGE, fig4),
            "ms-trace": (small, lanes["ms-trace"]),
            "mixed": (small, mixed_main)}

    # the batched engine's runs and the plain version's, on the CPU in the
    # worker processes, while the card runs (a)-(c)
    t0 = time.perf_counter()
    plain_jobs = [(p, cl, prefix(wb, N_ZOO_PLAIN), "cpu")
                  for cl, wb in held.values() for p in zoo]
    plain_jobs += [(p, small, mixed_short, "cpu") for p in fig11]
    plain_done = pool.starmap_async(plain_run, plain_jobs, chunksize=1)
    ref_jobs = [(p.balance, cl, wb) for cl, wb in ((small, mixed_short),
                                                   (tiny, overload))
                for p in zoo]
    ref_done = pool.starmap_async(plain_engine_ref, ref_jobs, chunksize=1)

    runs, launches = {}, 0

    def fused(policy, cluster, wb, key):
        nonlocal launches
        out, wall, stats, kern = fused_run(torch, np, policy, cluster, wb,
                                           key)
        launches += 1
        runs[key] = dict(n=wb.n, reps=wb.n_reps, wall_s=wall,
                         us_per_arrival=wall / wb.n * 1e6, ms=kern["ms"],
                         idle_share=1 - kern["ms"] / (wall * 1e3),
                         advance_iters=stats.advance_iters)
        return out, kern

    def rows(out, wb, labels):
        summ = summarize_batch_sim(out, wb, warmup_frac=0.1).per_rep
        return {label: dict(slow_p99=s.slow_p99, slow_mean=s.slow_mean,
                            cold_frac=s.cold_frac, n_rejected=s.n_rejected)
                for label, s in zip(labels, summ)}

    # (a) fig11's quick mode: both lanes, the nine policies
    table, outs = {}, {}
    for lane, wb in lanes.items():
        for policy in fig11:
            key = f"fig11 {lane} {policy.name}"
            outs[key], _ = fused(policy, small, wb, key)
            table[(lane, policy.name)] = rows(outs[key], wb, FIG11_LOADS)
    # (b) the mixed lane, at its depth and at N_SHORT (card vs CPU)
    short = {}
    for policy in fig11:
        key = f"fig11 mixed {policy.name}"
        outs[key], _ = fused(policy, small, mixed_main, key)
        for name, row in rows(outs[key], mixed_main, FIG11_MIXED).items():
            table[(f"mixed {name}", policy.name)] = {0.7: row}
        short[policy.name], _ = fused(policy, small, mixed_short,
                                      f"{key} N={N_SHORT}")
    # (c) fig4's zoo rows, each timed beside its bound
    fig4_t = {}
    for policy in zoo:
        key = f"fig4 {policy.name}"
        outs[key], kern = fused(policy, PAPER_LARGE, fig4, key)
        bound_ms, bound_by, nbytes, ops = engine_bound(
            kern["res"], fig4.n, fig4.n_reps, fig4.n_functions)
        t = fig4_t[policy.name] = runs[key]
        t.update(bound_ms=bound_ms, bound_by=bound_by, bytes=nbytes,
                 operations=ops, iters=int(kern["res"]["iters"].sum()),
                 per_load=rows(outs[key], fig4, LOADS))
    # the held runs' first arrivals, fused, for the every-plane check
    prefix_out = {(name, p.name): fused(
        p, cl, prefix(wb, N_ZOO_PLAIN),
        f"{name} {p.name} N={N_ZOO_PLAIN}")[0]
        for name, (cl, wb) in held.items() for p in zoo}
    for key, r in runs.items():
        log(f"{key}: wall {r['wall_s']:.3f} s ({r['us_per_arrival']:.2f} us "
            f"per arrival, R={r['reps']}, N={r['n']}); sim_engine "
            f"{r['ms']:.3f} ms, idle share {r['idle_share']:.3f} at most; 1 "
            f"launch, 0 host syncs, {r['advance_iters']} advance iters")
    for name, t in fig4_t.items():
        log(f"fig4 {name} R={fig4.n_reps} N={fig4.n}: sim_engine "
            f"{t['ms']:.3f} ms ({t['ms'] / fig4.n * 1e3:.3f} us per arrival); "
            f"bound {t['bound_ms']:.5f} ms, {t['bound_by']} ({t['bytes']} B, "
            f"{t['operations']} f64 operations over {t['iters']} advance "
            f"iterations), kernel / bound {t['ms'] / t['bound_ms']:.0f}")
        for load, row in t["per_load"].items():
            log(f"  load {load}: p99 slowdown {row['slow_p99']:.3f}, cold "
                f"{row['cold_frac']:.4f}, rejected {row['n_rejected']}")
    for (lane, name), by_load in table.items():
        for load, row in by_load.items():
            log(f"  fig11 {lane} {name} load {load}: p99 slowdown "
                f"{row['slow_p99']:.3f}, mean {row['slow_mean']:.3f}, cold "
                f"{row['cold_frac']:.4f}, rejected {row['n_rejected']}")

    # fig11's verdicts in the reference's words (benchmarks/run.py:240-265),
    # from the port's rows: printed, not gated
    def p99(lane, name, load):
        return table[(lane, name)][load]["slow_p99"]
    jsq2, r_, ll = (p99("ms-trace", n, 0.9)
                    for n in ("E/JSQ2/PS", "E/R/PS", "E/LL/PS"))
    dd, rb = (p99("bimodal-exec", n, 0.8) for n in ("E/DD/PS", "E/R/PS"))
    verdicts = {
        "Zoo: two choices beat one — E/JSQ2/PS p99 < E/R/PS @0.9":
            jsq2 < r_,
        "Zoo: JSQ2 tracks full-information LL (≤1.5x p99) @0.9":
            jsq2 <= 1.5 * ll,
        "Zoo: data-driven DD beats size-blind R on bimodal durations @0.8 "
        "(learned per-function estimates)": dd < rb}
    for claim, ok in verdicts.items():
        log(f"fig11 verdict (not a gate): {claim}: "
            f"{'holds' if ok else 'does not hold'}")
    log(f"fig11 values: JSQ2 {jsq2:.3f}, R {r_:.3f}, LL {ll:.3f} "
        f"(ms-trace @0.9); DD {dd:.3f}, R {rb:.3f} (bimodal-exec @0.8)")
    log(f"fig11 observation @0.9: RR p99 "
        f"{p99('ms-trace', 'E/RR/PS', 0.9):.3f} (blind rotation, between R "
        f"and JSQ2); HIKU p99 {p99('ms-trace', 'E/HIKU/PS', 0.9):.3f} vs LL "
        f"p99 {ll:.3f}")
    log(f"fig11 mixed-batch observation: bursty replay @0.7 HIKU p99 "
        f"{p99('mixed azure-bursty', 'E/HIKU/PS', 0.7):.3f} DD p99 "
        f"{p99('mixed azure-bursty', 'E/DD/PS', 0.7):.3f} LL p99 "
        f"{p99('mixed azure-bursty', 'E/LL/PS', 0.7):.3f}")

    # the kernel against its plain version at the small shapes, final
    # balancer state included (these launches compare, they are not the
    # main path's)
    max_err = 0.0
    for job, plain in zip(ref_jobs, ref_done.get()):
        balance, cl, wb = job
        max_err = max(max_err, kernel_vs_ref(
            torch, np, job, plain,
            f"{balance} W={cl.n_workers} R={wb.n_reps}"))
    log(f"sim_engine == sim_engine_ref (on the CPU) for "
        f"{', '.join(p.balance for p in zoo)} at W=4, N={N_SHORT}, the fig11 "
        f"mixed batch and an overloaded cluster: every plane and the final "
        f"balancer state (max abs err {max_err})")

    # the held runs against the batched engine on the CPU, then (b)'s
    # short runs card against CPU
    plain = iter(plain_done.get())
    plain_s = time.perf_counter() - t0
    for name, (cl, wb) in held.items():
        for p in zoo:
            cpu, wall = next(plain)
            key = f"{name} {p.name}"
            same_prefix(np, outs[f"fig11 {name} {p.name}" if name != "fig4"
                             else f"fig4 {p.name}"], cpu, key)
            same_planes(np, prefix_out[(name, p.name)], cpu,
                        f"{key} N={N_ZOO_PLAIN}: card vs CPU")
            log(f"{key}: the first {N_ZOO_PLAIN} arrivals == the batched "
                f"engine's run of them on the CPU (worker, cold, rejected "
                f"of the fused run; every plane of the fused run of just "
                f"those) ({wall:.1f} s)")
    gaps = {}
    for policy in fig11:
        cpu, _ = next(plain)
        key = f"fig11 mixed {policy.name} N={N_SHORT}"
        gaps[key] = card_vs_cpu(np, short[policy.name], cpu, key)
        check(gaps[key] == 0, f"{key}: card vs CPU float gap {gaps[key]}")
        log(f"{key}: card == CPU in every plane, float gap 0")
    log(f"{len(plain_jobs) + len(ref_jobs)} runs on the CPU in "
        f"{PLAIN_WORKERS} worker processes: {plain_s:.1f} s from their start")

    phase_s = time.perf_counter() - t_phase
    report["policy_zoo"] = dict(
        fig11=dict(loads=FIG11_LOADS, n=N_FIG11, seed=FIG11_SEED,
                   mixed=FIG11_MIXED, n_mixed=N_FIG11 // 2,
                   rows={f"{lane} {name}": by_load
                         for (lane, name), by_load in table.items()},
                   verdicts=verdicts),
        fig4=fig4_t, runs=runs, card_vs_cpu_max_gap=gaps,
        sim_engine_max_abs_err=max_err, plain_runs_s=plain_s,
        sim_engine_launches=launches, phase_s=phase_s)
    log(f"phase 13: {launches} sim_engine launches, {phase_s:.1f} s")
    check(phase_s <= ZOO_PHASE_S, f"phase 13 took {phase_s:.1f} s (limit "
                                  f"{ZOO_PHASE_S:.0f} s)")
    return launches, max_err


# -- the keep-alive axis (phase 14) --

#: fig12's full mode (benchmarks/fig12_keepalive.py:37-50, 66-67) and
#: fig7's keep-alive axis (benchmarks/fig7_coldstarts.py:30-35, 45-46) on
#: the paper's testbed: their loads, depth, seed, TTL, budget and preset
FIG12_LOADS = (0.2, 0.3, 0.5, 0.7, 0.85)
FIG7_LOADS = (0.1, 0.3, 0.5, 0.7, 0.9)
N_LIFE = 15_000
LIFE_SEED = 1
LIFE_TTL_S = 10.0
LIFE_MAX_IDLE = 4
LIFE_PRESET = "openwhisk"
LIFE_KEEPALIVES = ("NONE", "FIXED_TTL", "HYBRID_HIST")
FIG7_WORKLOADS = ("ms-trace", "azure-diurnal")
#: depth of the plain runs that hold phase 14's fused runs
N_LIFE_PLAIN = 500
LIFE_PHASE_S = 60.0


def keepalive_axis(torch, np, report, pool, oracle=None):
    """Phase 14: the container lifecycle through ``simulate_many`` on the
    card, every run fused: (a) fig12's full mode (its budget and balancer
    lanes), (b) fig7's keep-alive axis, with two timing runs beside
    fig12's budget lane (its Hermes inputs without the lifecycle, and
    under FIXED_TTL without the budget).  The batched engine's runs that
    hold them, the plain version's and the repair's go to ``pool``'s
    workers while the card runs; the fused runs of fig12's first arrivals go
    to ``oracle`` (phase 20c).  Returns (``sim_engine`` launches of the
    fused runs, the kernel's max abs error against ``sim_engine_ref``)."""
    from repro_torch.core import (E_LL_PS, E_LOC_PS, HERMES, PAPER_TESTBED,
                                  WORKLOADS, ClusterCfg, LifecycleCfg,
                                  ms_trace, replicate_workload,
                                  stack_workloads, summarize_batch_sim,
                                  synth_workload)
    from repro_torch.core.simulator import LoopStats, simulate_many
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek
    from repro_torch.policy import balancer_names, engine

    t_phase = time.perf_counter()
    testbed = PAPER_TESTBED
    schedulers = {"hermes": HERMES, "least-loaded": E_LL_PS,
                  "vanilla-ow": E_LOC_PS}

    def life(keepalive, max_idle=0):
        return testbed._replace(lifecycle=LifecycleCfg(
            keepalive, LIFE_TTL_S, max_idle, LIFE_PRESET))

    def batch(name, loads):
        return replicate_workload(WORKLOADS[name], testbed, loads, N_LIFE,
                                  seeds=(LIFE_SEED,))

    budget_wb = batch("azure-cold-heavy", FIG12_LOADS)
    lanes = {"balancer": batch("azure-diurnal", FIG12_LOADS),
             **{name: batch(name, FIG7_LOADS) for name in FIG7_WORKLOADS}}
    # every fused run: key -> (policy, cluster, workloads)
    plan = {f"fig12 budget {ka} hermes": (HERMES, life(ka, LIFE_MAX_IDLE),
                                          budget_wb)
            for ka in LIFE_KEEPALIVES}
    plan.update({f"fig12 balancer FIXED_TTL {s}": (
        p, life("FIXED_TTL"), lanes["balancer"])
        for s, p in schedulers.items()})
    plan.update({f"fig7 {name} {ka} {s}": (p, life(ka), lanes[name])
                 for name in FIG7_WORKLOADS for ka in LIFE_KEEPALIVES
                 for s, p in schedulers.items()})
    timing = {"timing budget lifecycle off hermes": (HERMES, testbed,
                                                     budget_wb),
              "timing budget FIXED_TTL unbudgeted hermes": (
                  HERMES, life("FIXED_TTL"), budget_wb)}
    # the repaired route: S = 2048 slots, beyond the kernel's 2047
    big = ClusterCfg(n_workers=8, cores=256)
    big_wb = replicate_workload(ms_trace, big, (0.5, 0.9), N_SHORT,
                                seeds=(SEED,))
    # the plain version's check: phase 5's overloaded cluster, where
    # slot-pressure and budget evictions, stale pools and rejections occur
    tiny = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                      cold_start_penalty=0.25)
    overload = stack_workloads(
        synth_workload(tiny, load, N_SHORT, n_functions=5, hot_fraction=0.8,
                       seed=SEED) for load in (1.3, 3.0, 6.0))
    ref_lives = (LifecycleCfg("FIXED_TTL", 2.0, 2, "aws-lambda"),
                 LifecycleCfg("HYBRID_HIST", 2.0, 2))
    ref_jobs = [(b, tiny._replace(lifecycle=lc), overload)
                for lc in ref_lives for b in balancer_names()]

    # the batched engine's runs and the plain version's, on the CPU in the
    # worker processes, while the card runs the fused ones
    t0 = time.perf_counter()
    plain_jobs = [(p, cl, prefix(wb, N_LIFE_PLAIN), "cpu")
                  for p, cl, wb in plan.values()]
    plain_jobs.append((HERMES, big, big_wb, "cpu"))
    plain_done = pool.starmap_async(plain_run, plain_jobs, chunksize=1)
    ref_done = pool.starmap_async(plain_engine_ref, ref_jobs, chunksize=1)

    runs, outs, launches = {}, {}, 0
    for key, (policy, cl, wb) in {**plan, **timing}.items():
        out, wall, stats, kern = fused_run(torch, np, policy, cl, wb, key)
        launches += 1
        outs[key] = out
        bound_ms, bound_by, nbytes, ops = engine_bound(
            kern["res"], wb.n, wb.n_reps, wb.n_functions,
            budget=cl.lifecycle is not None and cl.lifecycle.max_idle > 0)
        summ = summarize_batch_sim(out, wb, warmup_frac=0.1).per_rep
        loads = FIG7_LOADS if key.startswith("fig7") else FIG12_LOADS
        runs[key] = dict(
            n=wb.n, reps=wb.n_reps, functions=wb.n_functions, wall_s=wall,
            us_per_arrival=wall / wb.n * 1e6, ms=kern["ms"],
            idle_share=1 - kern["ms"] / (wall * 1e3),
            iters=int(kern["res"]["iters"].sum()), bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, operations=ops,
            rows={load: dict(cold_frac=s.cold_frac, slow_p99=s.slow_p99,
                             n_rejected=s.n_rejected)
                  for load, s in zip(loads, summ)})
    # the held runs' first arrivals, fused, for the every-plane check
    prefix_out = {key: fused_run(torch, np, p, cl, prefix(wb, N_LIFE_PLAIN),
                                 f"{key} N={N_LIFE_PLAIN}")[0]
                  for key, (p, cl, wb) in plan.items()}
    launches += len(prefix_out)
    for key, (p, cl, wb) in plan.items():
        if oracle is not None and key.startswith("fig12"):
            oracle.hold("20c life", key, p, cl, prefix(wb, N_LIFE_PLAIN),
                        prefix_out[key], (1, 0))

    for key, r in runs.items():
        log(f"{key} R={r['reps']} F={r['functions']} N={r['n']}: wall "
            f"{r['wall_s']:.3f} s ({r['us_per_arrival']:.2f} us per "
            f"arrival); sim_engine {r['ms']:.3f} ms "
            f"({r['ms'] / r['n'] * 1e3:.3f} us per arrival), idle share "
            f"{r['idle_share']:.3f} at most; bound {r['bound_ms']:.5f} ms, "
            f"{r['bound_by']} ({r['bytes']} B, {r['operations']} f64 "
            f"operations over {r['iters']} advance iterations), kernel / "
            f"bound {r['ms'] / r['bound_ms']:.0f}; 1 launch, 0 host syncs")
        for load, row in r["rows"].items():
            log(f"  {key} load {load}: cold {row['cold_frac']:.4f}, p99 "
                f"slowdown {row['slow_p99']:.3f}, rejected "
                f"{row['n_rejected']}")

    # fig12's claims in the reference's words (benchmarks/run.py:268-295),
    # from the port's rows: printed, not gated
    def cold_sum(key):
        return sum(row["cold_frac"] for row in runs[key]["rows"].values())
    cold_of = {ka: cold_sum(f"fig12 budget {ka} hermes")
               for ka in LIFE_KEEPALIVES}
    h12, l12 = (cold_sum(f"fig12 balancer FIXED_TTL {s}")
                for s in ("hermes", "least-loaded"))
    claims = {
        "Lifecycle: HYBRID_HIST fewer cold starts than FIXED_TTL at equal "
        "warm-pool budget (learned per-function windows)":
            cold_of["HYBRID_HIST"] < cold_of["FIXED_TTL"],
        "Lifecycle: NONE is the cold-start upper bound":
            cold_of["NONE"] >= max(cold_of["FIXED_TTL"],
                                   cold_of["HYBRID_HIST"]),
        "Lifecycle: Hermes keeps its cold-start edge over LL under "
        "FIXED_TTL on azure-diurnal": h12 < l12}
    for claim, ok in claims.items():
        log(f"fig12 claim (not a gate): {claim}: "
            f"{'holds' if ok else 'does not hold'}")
    log(f"fig12 values (cold_frac summed over the loads): NONE "
        f"{cold_of['NONE']:.4f}, FIXED_TTL {cold_of['FIXED_TTL']:.4f}, "
        f"HYBRID_HIST {cold_of['HYBRID_HIST']:.4f} (budget lane); hermes "
        f"{h12:.4f} vs least-loaded {l12:.4f} (balancer lane)")

    # the repaired route on the card: E/H/PS at S = 2048 takes the batched
    # engine (one hermes_select launch an arrival, no sim_engine launch),
    # equal to the plain engine on the card and to the CPU's
    check(engine(HERMES, "cuda", "auto", big) == "batched",
          f"S={big.slots}: the route is not the batched engine")
    stats = LoopStats()
    ek.sim_engine.launches = 0
    hk.hermes_select_batch.launches = 0
    t0_big = time.perf_counter()
    big_card = simulate_many(HERMES, big, big_wb, device="cuda",
                             stats=stats)
    big_wall = time.perf_counter() - t0_big
    counts = (ek.sim_engine.launches, hk.hermes_select_batch.launches)
    check(counts == (0, N_SHORT), f"S={big.slots}: sim_engine and "
                                  f"hermes_select launched {counts}, "
                                  f"expected (0, {N_SHORT})")
    validate(np, big_card, big_wb, f"E/H/PS S={big.slots}")
    same_planes(np, big_card, simulate_many(HERMES, big, big_wb,
                                            device="cuda", backend="torch"),
                f"E/H/PS S={big.slots}: kernel path vs plain engine")

    # the kernel against its plain version on the overloaded cluster,
    # final life and balancer state included (these launches compare,
    # they are not the main path's)
    max_err = 0.0
    for job, plain in zip(ref_jobs, ref_done.get()):
        balance, cl, _ = job
        max_err = max(max_err, kernel_vs_ref(
            torch, np, job, plain, f"{balance} {cl.lifecycle.keepalive}"))
    log(f"sim_engine == sim_engine_ref (on the CPU) for all "
        f"{len(balancer_names())} balancers under FIXED_TTL (max_idle 2, "
        f"aws-lambda) and HYBRID_HIST (max_idle 2) on the overloaded "
        f"4 x 3-core cluster at N={N_SHORT}: every plane, the final life "
        f"and balancer state (max abs err {max_err})")

    # the held runs against the batched engine on the CPU
    plain = iter(plain_done.get())
    plain_s = time.perf_counter() - t0
    for key in plan:
        cpu, _ = next(plain)
        same_prefix(np, outs[key], cpu, key)
        card = prefix_out[key]
        same_planes(np, card, cpu, f"{key} N={N_LIFE_PLAIN}: card vs CPU")
        check(sorted(card.life) == sorted(cpu.life) and all(
            card.life[k].tobytes() == cpu.life[k].tobytes()
            for k in cpu.life),
            f"{key} N={N_LIFE_PLAIN}: card vs CPU differ in the life state")
    log(f"the first {N_LIFE_PLAIN} arrivals of each of the {len(plan)} "
        f"fused runs == the batched engine's run of them on the CPU "
        f"(worker, cold, rejected of the fused run; every plane and the "
        f"final life state of the fused run of just those)")
    big_cpu, big_cpu_wall = next(plain)
    big_gap = card_vs_cpu(np, big_card, big_cpu, f"E/H/PS S={big.slots}")
    log(f"E/H/PS S={big.slots} R={big_wb.n_reps} N={N_SHORT}: batched engine "
        f"on the card, {counts[1]} hermes_select launches, no sim_engine "
        f"launch, {big_wall:.1f} s; == the plain engine on the card in "
        f"every plane; == the CPU's run in integer planes, max float gap "
        f"{big_gap} ({big_cpu_wall:.1f} s)")
    log(f"{len(plain_jobs) + len(ref_jobs)} runs on the CPU in "
        f"{PLAIN_WORKERS} worker processes: {plain_s:.1f} s from their start")

    # what the lifecycle costs the kernel on the budget lane's inputs
    off, unbudgeted, budgeted = (runs[k]["ms"] for k in (
        "timing budget lifecycle off hermes",
        "timing budget FIXED_TTL unbudgeted hermes",
        "fig12 budget FIXED_TTL hermes"))
    log(f"E/H/PS on fig12's budget inputs: sim_engine {off:.3f} ms without "
        f"the lifecycle, {unbudgeted:.3f} ms under FIXED_TTL, "
        f"{budgeted:.3f} ms under FIXED_TTL with max_idle "
        f"{LIFE_MAX_IDLE} (the LRU scan at each completion)")

    phase_s = time.perf_counter() - t_phase
    report["keepalive_axis"] = dict(
        fig12=dict(loads=FIG12_LOADS, ttl_s=LIFE_TTL_S,
                   max_idle=LIFE_MAX_IDLE, preset=LIFE_PRESET,
                   cold_sums=dict(cold_of, hermes=h12, least_loaded=l12),
                   claims=claims),
        fig7=dict(loads=FIG7_LOADS, workloads=FIG7_WORKLOADS),
        n=N_LIFE, seed=LIFE_SEED, runs=runs,
        repair=dict(slots=big.slots, wall_s=big_wall,
                    hermes_select_launches=counts[1], card_vs_cpu=big_gap),
        sim_engine_max_abs_err=max_err, plain_runs_s=plain_s,
        sim_engine_launches=launches, phase_s=phase_s)
    log(f"phase 14: {launches} sim_engine launches, {phase_s:.1f} s")
    check(phase_s <= LIFE_PHASE_S, f"phase 14 took {phase_s:.1f} s (limit "
                                   f"{LIFE_PHASE_S:.0f} s)")
    return launches, max_err


# -- telemetry and the fleet (phase 15) --

#: bench_telemetry's sketch lane in full mode (benchmarks/
#: bench_telemetry.py:50-80): 8 workers × 8 cores, ms-trace at three loads,
#: seeds 17-21 (R = 5), N = 60 000, a 10 % warm-up, the 2 % gate
TEL_CLUSTER = dict(n_workers=8, cores=8)
TEL_LOADS = (0.3, 0.6, 0.8)
TEL_SEEDS = (17, 18, 19, 20, 21)
N_TEL = 60_000
TEL_WARMUP = 0.1
TEL_TOL = 0.02
#: fig13's full mode (benchmarks/fig13_autoscale.py:33-56, 60-112) on the
#: testbed: azure-diurnal, N = 6000, R = 1; the balancer lane's two-gen
#: fleet and loads, the frontier lane's static fleets and TARGET_P99
FIG13_WORKLOAD = "azure-diurnal"
FIG13_BAL_LOADS = (0.5, 0.65, 0.8)
FIG13_BAL_LOAD = 0.8
FIG13_FRONTIER_LOAD = 0.85
FIG13_SEEDS = (1, 2, 3)
FIG13_STATIC = (5, 6, 7, 8)
FIG13_TARGET = 3.0
N_FIG13 = 6_000
#: depth of the plain runs that hold phase 15's fused runs
N_OBS_PLAIN = 800
OBS_PHASE_S = 60.0
TEL_FIELDS = ("slow_hist", "lat_hist", "n_cold", "n_warm", "n_evict",
              "n_reject", "busy_time", "depth_time", "qlen_time",
              "decisions")


def shed_autoscaler(cfg, n_workers, device):
    """A user's autoscaler (15c): one worker fewer at each decision, down
    to ``min_workers``.  Top-level, so that it pickles."""
    import torch

    def decide(n_on, window):
        return torch.clamp(n_on - 1, min=int(cfg.min_workers)).to(
            torch.int32)
    return decide


def held_telemetry(n_full, n_held, cfg):
    """The telemetry config whose warmup cutoff on the first ``n_held``
    arrivals is ``cfg``'s on all ``n_full``: an autoscaler reads the
    sketch, so its decisions on the prefix follow the full run's only
    with the same cutoff."""
    from repro_torch.telemetry import TelemetryCfg, warmup_cutoff
    cut = warmup_cutoff(n_full, cfg)
    held = TelemetryCfg(warmup_frac=cut / n_held)
    check(warmup_cutoff(n_held, held) == cut,
          f"no warmup fraction gives cutoff {cut} on {n_held} arrivals")
    return held


def same_obs(np, a, b, what: str) -> None:
    """Two runs' telemetry, autoscaler state and provisioned core-seconds
    equal bit for bit."""
    check((a.telemetry is None) == (b.telemetry is None)
          and (a.fleet is None) == (b.fleet is None),
          f"{what}: one run has telemetry or a fleet state, not the other")
    if a.telemetry is not None:
        for f in TEL_FIELDS:
            check(getattr(a.telemetry, f).tobytes()
                  == getattr(b.telemetry, f).tobytes(),
                  f"{what}: not equal in the telemetry's {f}")
    for k in b.fleet or {}:
        check(a.fleet[k].tobytes() == b.fleet[k].tobytes(),
              f"{what}: not equal in the autoscaler's {k}")
    check(np.asarray(a.prov_core_s).tobytes()
          == np.asarray(b.prov_core_s).tobytes(),
          f"{what}: not equal in prov_core_s")


def telemetry_fleet(torch, np, report, pool, oracle=None):
    """Phase 15: telemetry and the heterogeneous fleet through
    ``simulate_many`` on the card, every run fused (one ``sim_engine``
    launch, the observation plane): (a) bench_telemetry's sketch lane in
    full mode, gated at 2 %; (b) fig13's full mode (its balancer and
    frontier lanes); the first arrivals of each run held to the batched
    engine on the CPU in every plane, telemetry and autoscaler state too;
    (c) the routes: a user's autoscaler on the batched engine on the card,
    and the two named errors; (d) the plane's cost on fig4's E/H/PS
    inputs; and ``sim_engine`` against ``sim_engine_ref`` for the nine
    balancers under the plane.  The CPU runs go to ``pool``'s workers
    while the card runs; the fused runs of fig13's first arrivals go to
    ``oracle`` (phase 20c).  Returns (``sim_engine`` launches of the fused
    runs, the kernel's max abs error against ``sim_engine_ref``, the
    plane's timing on fig4's inputs)."""
    from repro_torch.core import (E_LL_PS, E_SWARM_PS, HERMES, LATE_BINDING,
                                  PAPER_LARGE, PAPER_TESTBED, WORKLOADS,
                                  ClusterCfg, FleetCfg, ms_trace,
                                  replicate_workload, stack_workloads,
                                  summarize, summarize_batch_sim,
                                  synth_workload)
    from repro_torch.core.simulator import LoopStats, simulate_many
    from repro_torch.fleet import register_autoscaler, unregister_autoscaler
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek
    from repro_torch.policy import balancer_names, engine
    from repro_torch.telemetry import TelemetryCfg

    t_phase = time.perf_counter()
    tel_cfg = TelemetryCfg(warmup_frac=TEL_WARMUP)
    tel_cl = ClusterCfg(**TEL_CLUSTER)
    # every fused run: key -> (policy, cluster, workloads, telemetry)
    plan = {}
    for load in TEL_LOADS:
        wb = stack_workloads(ms_trace(tel_cl, load, N_TEL, seed=s)
                             for s in TEL_SEEDS)
        for p in registry_policies(()):
            plan[f"sketch {p.name} {load}"] = (p, tel_cl, wb, tel_cfg)
    make = WORKLOADS[FIG13_WORKLOAD]
    two_gen = PAPER_TESTBED._replace(fleet=FleetCfg(preset="two-gen"))
    auto = PAPER_TESTBED._replace(fleet=FleetCfg(
        preset="uniform", autoscale="TARGET_P99", target_p99=FIG13_TARGET,
        min_workers=2, cooldown_s=2.0))
    schedulers = {"hermes": HERMES, "least-loaded": E_LL_PS,
                  "swarm": E_SWARM_PS}
    for load in FIG13_BAL_LOADS:
        wb = stack_workloads([make(PAPER_TESTBED, load, N_FIG13, seed=1)])
        for s, p in schedulers.items():
            plan[f"fig13 balancer {load} {s}"] = (p, two_gen, wb, None)
    for seed in FIG13_SEEDS:
        wb = stack_workloads([make(PAPER_TESTBED, FIG13_FRONTIER_LOAD,
                                   N_FIG13, seed=seed)])
        for wn in FIG13_STATIC:
            plan[f"fig13 frontier {seed} static-{wn}"] = (
                HERMES, ClusterCfg(n_workers=wn, cores=PAPER_TESTBED.cores),
                wb, None)
        plan[f"fig13 frontier {seed} auto"] = (HERMES, auto, wb,
                                                TelemetryCfg())

    def held(key):
        """The run that holds ``key``'s first arrivals: with telemetry
        (the autoscaler's at the full run's cutoff) so that its planes are
        held too."""
        p, cl, wb, tel = plan[key]
        if cl.fleet is not None and cl.fleet.autoscale != "STATIC":
            tel = held_telemetry(wb.n, N_OBS_PLAIN, tel)
        return p, cl, prefix(wb, N_OBS_PLAIN), tel or TelemetryCfg()

    # the plain version's check: phase 5's overloaded cluster (rejections,
    # evictions) under telemetry, a two-gen fleet and TARGET_P99
    tiny = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                      cold_start_penalty=0.25)
    overload = stack_workloads(
        synth_workload(tiny, load, N_SHORT, n_functions=5, hot_fraction=0.8,
                       seed=SEED) for load in (0.7, 1.3, 3.0))
    ref_cases = {
        "telemetry": (tiny, TelemetryCfg()),
        "two-gen": (tiny._replace(fleet=FleetCfg(preset="two-gen")), None),
        "TARGET_P99": (tiny._replace(fleet=FleetCfg(
            preset="long-tail", autoscale="TARGET_P99", target_p99=4.0,
            cooldown_s=1.0)), TelemetryCfg())}
    ref_jobs = [(b, cl, overload, tel) for cl, tel in ref_cases.values()
                for b in balancer_names()]

    # the CPU runs, in the worker processes, while the card runs
    t0 = time.perf_counter()
    plain_jobs = [(p, cl, wb, "cpu", tel)
                  for p, cl, wb, tel in map(held, plan)]
    plain_done = pool.starmap_async(plain_run, plain_jobs, chunksize=1)
    ref_done = pool.starmap_async(plain_engine_ref, ref_jobs, chunksize=1)

    # (a) and (b), fused
    runs, outs, launches = {}, {}, 0
    for key, (policy, cl, wb, tel) in plan.items():
        out, wall, stats, kern = fused_run(torch, np, policy, cl, wb, key,
                                           telemetry=tel)
        launches += 1
        outs[key] = out
        bound_ms, bound_by, nbytes, ops = engine_bound(
            kern["res"], wb.n, wb.n_reps, wb.n_functions,
            speed=speed_of(cl))
        runs[key] = dict(
            n=wb.n, reps=wb.n_reps, wall_s=wall,
            us_per_arrival=wall / wb.n * 1e6, ms=kern["ms"],
            idle_share=1 - kern["ms"] / (wall * 1e3),
            iters=int(kern["res"]["iters"].sum()), bound_ms=bound_ms,
            bound_by=bound_by, bytes=nbytes, operations=ops)
        if key.startswith("sketch"):
            exact = summarize_batch_sim(out, wb,
                                        warmup_frac=TEL_WARMUP).pooled
            row = {}
            for q, want in ((50, exact.slow_p50), (99, exact.slow_p99)):
                got = out.telemetry.slow_percentile(q)
                row.update({f"sketch_p{q}": got, f"exact_p{q}": want,
                            f"rel_err_p{q}": abs(got - want)
                            / max(abs(want), 1e-12)})
            runs[key].update(row)
            check(row["rel_err_p50"] <= TEL_TOL
                  and row["rel_err_p99"] <= TEL_TOL,
                  f"{key}: sketch p50/p99 {row['sketch_p50']:.6f}/"
                  f"{row['sketch_p99']:.6f} vs exact {row['exact_p50']:.6f}/"
                  f"{row['exact_p99']:.6f}: beyond {TEL_TOL:.0%}")
        else:
            s = summarize(out.response[0], wb.service[0], out.cold[0],
                          out.rejected[0], out.server_time[0],
                          out.core_time[0], out.end_time[0])
            runs[key].update(slow_p50=s.slow_p50, slow_p99=s.slow_p99,
                             cold_frac=s.cold_frac, n_rejected=s.n_rejected,
                             prov_core_s=float(out.prov_core_s[0]))
    prefix_out = {key: fused_run(torch, np, p, cl, wb,
                                 f"{key} N={N_OBS_PLAIN}", telemetry=tel)[0]
                  for key, (p, cl, wb, tel) in zip(plan, map(held, plan))}
    launches += len(prefix_out)
    for key, (p, cl, wb, tel) in zip(plan, map(held, plan)):
        if oracle is not None and key.startswith("fig13"):
            oracle.hold("20c observation", key, p, cl, wb, prefix_out[key],
                        (1, 0), telemetry=tel)

    for key, r in runs.items():
        extra = (f"sketch p50 {r['sketch_p50']:.6f} (exact "
                 f"{r['exact_p50']:.6f}, rel err {r['rel_err_p50']:.5f}), "
                 f"p99 {r['sketch_p99']:.6f} (exact {r['exact_p99']:.6f}, "
                 f"rel err {r['rel_err_p99']:.5f})"
                 if key.startswith("sketch") else
                 f"p99 slowdown {r['slow_p99']:.4f}, cold "
                 f"{r['cold_frac']:.4f}, rejected {r['n_rejected']}, "
                 f"prov_core_s {r['prov_core_s']:.1f}")
        log(f"{key} R={r['reps']} N={r['n']}: wall {r['wall_s']:.3f} s "
            f"({r['us_per_arrival']:.2f} us per arrival); sim_engine "
            f"{r['ms']:.3f} ms, idle share {r['idle_share']:.3f} at most; "
            f"bound {r['bound_ms']:.5f} ms, {r['bound_by']} ({r['bytes']} "
            f"B, {r['operations']} f64 operations); {extra}")

    # fig13's claims in the reference's words (benchmarks/run.py:300-330),
    # from the port's rows: printed, not gated
    sw = runs[f"fig13 balancer {FIG13_BAL_LOAD} swarm"]["slow_p99"]
    ll = runs[f"fig13 balancer {FIG13_BAL_LOAD} least-loaded"]["slow_p99"]
    auto_ok, bits = True, []
    for seed in FIG13_SEEDS:
        a = runs[f"fig13 frontier {seed} auto"]
        meet = [(runs[f"fig13 frontier {seed} static-{wn}"]["prov_core_s"],
                 f"static-{wn}") for wn in FIG13_STATIC
                if runs[f"fig13 frontier {seed} static-{wn}"]["slow_p99"]
                <= FIG13_TARGET]
        cap, best = min(meet) if meet else (float("inf"), "none")
        auto_ok &= a["slow_p99"] <= FIG13_TARGET and a["prov_core_s"] < cap
        bits.append(f"seed{seed}: p99={a['slow_p99']:.2f} "
                    f"prov={a['prov_core_s']:.0f} vs {best}={cap:.0f}")
    claims = {
        "Fleet: SWARM ≤ speed-blind LL p99 slowdown on a two-gen fleet "
        "@0.8 (learned per-worker slowness)": sw <= ll,
        "Fleet: TARGET_P99 autoscaler meets the p99 target with fewer "
        "provisioned core-seconds than the smallest static fleet meeting "
        f"it (target={FIG13_TARGET})": auto_ok}
    for claim, ok in claims.items():
        log(f"fig13 claim (not a gate): {claim}: "
            f"{'holds' if ok else 'does not hold'}")
    log(f"fig13 values: SWARM={sw:.2f} vs LL={ll:.2f}; {'; '.join(bits)}")

    # (d) the plane's cost on fig4's E/H/PS inputs (phase 4's), the
    # variants in turns, twice; telemetry must not change a plane
    fig4 = replicate_workload(ms_trace, PAPER_LARGE, LOADS, N_MAIN,
                              seeds=(SEED,))
    args = engine_inputs(torch, np, fig4)
    variants = {"off": (PAPER_LARGE, None),
                "uniform": (PAPER_LARGE._replace(fleet=FleetCfg()), None),
                "telemetry": (PAPER_LARGE, TelemetryCfg()),
                "two-gen": (PAPER_LARGE._replace(fleet=FleetCfg(
                    preset="two-gen")), None)}
    short = [a[:, :50].contiguous() for a in args[:4]] + [args[4]]
    for cl, tel in variants.values():     # first-use costs
        ek.sim_engine("H", cl, *short, tel)
    torch.cuda.synchronize()
    plane_ms, plane_res = {k: [] for k in variants}, {}
    for _ in range(2):
        for name, (cl, tel) in variants.items():
            res = {}
            plane_ms[name].append(_event_ms(torch, lambda: res.update(
                ek.sim_engine("H", cl, *args, tel))))
            plane_res[name] = res
    for key in ENGINE_PLANES.values():
        for name in ("uniform", "telemetry"):
            check(np.array_equal(plane_res["off"][key].cpu().numpy(),
                                 plane_res[name][key].cpu().numpy(),
                                 equal_nan=key == "resp"),
                  f"fig4 E/H/PS: the plane ({name}) changed {key}")
    plane = {}
    for name, ms in plane_ms.items():
        b_ms, b_by, nbytes, ops = engine_bound(
            plane_res[name], N_MAIN, len(LOADS), fig4.n_functions,
            speed=speed_of(variants[name][0]))
        plane[name] = dict(ms=min(ms), ms_runs=ms, bound_ms=b_ms,
                           bound_by=b_by, bytes=nbytes, operations=ops)
        runs_ms = ", ".join(f"{m:.3f}" for m in ms)
        log(f"fig4 E/H/PS R={len(LOADS)} N={N_MAIN}, plane {name}: "
            f"sim_engine {min(ms):.3f} ms (runs {runs_ms}), "
            f"{min(ms) / min(plane_ms['off']):.3f} x off; bound "
            f"{b_ms:.5f} ms, {b_by} ({nbytes} B, {ops} f64 operations)")

    # (c) the routes: a user's autoscaler takes the batched engine on the
    # card (no sim_engine launch; Hermes' choice by hermes_select, one
    # launch an arrival), equal to the CPU's run; the two named errors
    small = replicate_workload(ms_trace, PAPER_TESTBED, (0.5, 0.9), N_SHORT,
                               seeds=(SEED,))
    register_autoscaler("SHED", make_torch=shed_autoscaler,
                        doc="one worker fewer at each decision")
    try:
        shed = PAPER_TESTBED._replace(fleet=FleetCfg(
            autoscale="SHED", min_workers=2, cooldown_s=1.0))
        check(engine(HERMES, "cuda", "auto", shed) == "batched",
              "a user's autoscaler: the route is not the batched engine")
        stats = LoopStats()
        ek.sim_engine.launches = 0
        hk.hermes_select_batch.launches = 0
        card = simulate_many(HERMES, shed, small, device="cuda",
                             telemetry=TelemetryCfg(), stats=stats)
        counts = (ek.sim_engine.launches, hk.hermes_select_batch.launches)
        check(counts == (0, N_SHORT), f"a user's autoscaler: sim_engine and "
                                      f"hermes_select launched {counts}, "
                                      f"expected (0, {N_SHORT})")
        cpu = simulate_many(HERMES, shed, small, device="cpu",
                            telemetry=TelemetryCfg())
        shed_gap = card_vs_cpu(np, card, cpu, "E/H/PS under SHED")
        for f in TEL_FIELDS:
            a, b = getattr(card.telemetry, f), getattr(cpu.telemetry, f)
            check(np.array_equal(a, b) if a.dtype.kind == "i" else
                  np.allclose(a, b, rtol=1e-9, atol=0.0),
                  f"E/H/PS under SHED: card != CPU in the telemetry's {f}")
        check(card.fleet["n_on"].tolist() == cpu.fleet["n_on"].tolist()
              and max(card.fleet["n_on"]) < PAPER_TESTBED.n_workers,
              f"E/H/PS under SHED: n_on {card.fleet['n_on']} (CPU "
              f"{cpu.fleet['n_on']})")
    finally:
        unregister_autoscaler("SHED")
    errors = {}
    for what, policy, tel, words in (
            ("late binding", LATE_BINDING, TelemetryCfg(),
             "requires early binding"),
            ("no telemetry", HERMES, None, "telemetry")):
        ek.sim_engine.launches = 0
        try:
            simulate_many(policy, auto, small, device="cuda", telemetry=tel)
            raised = None
        except ValueError as e:
            raised = str(e)
        check(raised is not None and words in raised
              and ek.sim_engine.launches == 0,
              f"TARGET_P99 under {what}: expected a ValueError naming "
              f"{words!r} before any launch, got {raised!r}")
        errors[what] = raised
    log(f"a user's autoscaler (SHED): the batched engine on the card, "
        f"{counts[1]} hermes_select launches, no sim_engine launch, == the "
        f"CPU's run (float gap {shed_gap}, n_on {card.fleet['n_on']}); "
        f"TARGET_P99 raises under late binding and without telemetry")

    # the kernel against its plain version under the plane, final state
    # included (these launches compare, they are not the main path's)
    max_err = 0.0
    for job, plain in zip(ref_jobs, ref_done.get()):
        balance, cl, _, _ = job
        max_err = max(max_err, kernel_vs_ref(
            torch, np, job, plain, f"{balance} under {cl.fleet}"))
    log(f"sim_engine == sim_engine_ref (on the CPU) for all "
        f"{len(balancer_names())} balancers under telemetry, a two-gen "
        f"fleet and TARGET_P99 on the overloaded 4 x 3-core cluster at "
        f"N={N_SHORT}: every plane, the telemetry and the autoscaler's "
        f"state (max abs err {max_err})")

    # the held runs against the batched engine on the CPU
    plain = iter(plain_done.get())
    plain_s = time.perf_counter() - t0
    for key in plan:
        cpu, _ = next(plain)
        same_prefix(np, outs[key], cpu, key)
        card = prefix_out[key]
        same_planes(np, card, cpu, f"{key} N={N_OBS_PLAIN}: card vs CPU")
        same_obs(np, card, cpu, f"{key} N={N_OBS_PLAIN}: card vs CPU")
    log(f"the first {N_OBS_PLAIN} arrivals of each of the {len(plan)} "
        f"fused runs == the batched engine's run of them on the CPU "
        f"(worker, cold, rejected of the fused run; every plane, the "
        f"telemetry and the autoscaler's state of the fused run of just "
        f"those)")
    log(f"{len(plain_jobs) + len(ref_jobs)} runs on the CPU in "
        f"{PLAIN_WORKERS} worker processes: {plain_s:.1f} s from their start")

    phase_s = time.perf_counter() - t_phase
    report["telemetry_fleet"] = dict(
        sketch=dict(cluster=TEL_CLUSTER, loads=TEL_LOADS, seeds=TEL_SEEDS,
                    n=N_TEL, tol=TEL_TOL),
        fig13=dict(workload=FIG13_WORKLOAD, n=N_FIG13,
                   balancer_loads=FIG13_BAL_LOADS, seeds=FIG13_SEEDS,
                   target=FIG13_TARGET, claims=claims,
                   swarm_p99=sw, ll_p99=ll, frontier=bits),
        runs=runs, plane=plane, routes=dict(
            shed_hermes_select_launches=counts[1], shed_gap=shed_gap,
            errors=errors),
        sim_engine_max_abs_err=max_err, plain_runs_s=plain_s,
        sim_engine_launches=launches, phase_s=phase_s)
    log(f"phase 15: {launches} sim_engine launches, {phase_s:.1f} s")
    check(phase_s <= OBS_PHASE_S, f"phase 15 took {phase_s:.1f} s (limit "
                                  f"{OBS_PHASE_S:.0f} s)")
    return launches, max_err, plane


# -- the timeline and the serving platform (phase 16) --

#: fig15's parity lane (benchmarks/fig15_timeline.py:53-57, 104-117): 4 ×
#: 3 cores, capacity 2, N = 240, (load, seed) (0.6, 0) and (1.0, 1), 32
#: windows, 96 coarse bins, 128 events, with telemetry
FIG15_N = 240
FIG15_LOADS = ((0.6, 0), (1.0, 1))
#: the diurnal lane (:61-64, 209-244): the testbed, azure-diurnal at 0.5,
#: N = 4000, seed 3, the default timeline
DIURNAL = ("azure-diurnal", 0.5, 4_000, 3)
#: the decision lane (:69-73, 247-285): HERMES on a two-gen fleet under
#: TARGET_P99 (target 3.0, floor 2, cooldown 2 s), azure-diurnal at 0.85,
#: N = 6000, seed 1, 512 events
DECISION = ("azure-diurnal", 0.85, 6_000, 1)
#: 16e: the launcher's run
LAUNCH_FLAGS = ("--policy", "E/H/PS", "--load", "0.6", "-n", "2000")
TL_INT = ("mode", "arrivals", "n_cold", "n_warm", "n_evict", "n_reject",
          "slow_hist", "lat_hist", "n_on", "ev_kind", "ev_val", "ev_count")
TL_F64 = ("window_s", "busy_time", "qlen_time", "prov_core", "ev_t",
          "ev_p99")
TL_PHASE_S = 60.0


def serve_run(policy, cluster, wl, device, telemetry=None, timeline=None,
              use_kernel=False):
    """One ``ServingCluster`` run on ``device``: (result, wall s).
    Top-level, so that a worker process can run it."""
    from repro_torch.serving.engine import ServeCfg, ServingCluster
    sc = ServingCluster(ServeCfg(cluster=cluster), policy,
                        use_kernel=use_kernel, telemetry=telemetry,
                        timeline=timeline, device=device)
    t0 = time.perf_counter()
    out = sc.run(wl)
    return out, time.perf_counter() - t0


def launcher_lines(flags, path):
    """What ``python -m repro_torch.launch.serve`` prints for ``flags``
    (with ``--timeline-out path``), made in-process with the platform on
    the CPU, and the CSV it writes.  Top-level, so that a worker process
    can run it."""
    import io
    from contextlib import redirect_stdout

    from repro_torch.launch import serve
    out = io.StringIO()
    with redirect_stdout(out):
        serve.main([*flags, "--timeline-out", path], device="cpu")
    return out.getvalue(), Path(path).read_text()


def same_timeline(np, a, b, what: str) -> None:
    """Two timelines equal bit for bit, every plane."""
    for f in TL_INT + TL_F64:
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        check(x.dtype == y.dtype and x.shape == y.shape
              and x.tobytes() == y.tobytes(),
              f"{what}: not equal in the timeline's {f}")


def serve_same(np, a, b, what: str) -> None:
    """Two platform runs equal bit for bit."""
    for f in ("response", "cold", "rejected", "worker", "redispatched",
              "server_time", "core_time", "end_time", "prov_core_s"):
        check(np.asarray(getattr(a, f)).tobytes()
              == np.asarray(getattr(b, f)).tobytes(),
              f"{what}: card != CPU in {f}")
    same_timeline(np, a.timeline, b.timeline, f"{what}: card vs CPU")


def timeline_shape(np, tl, wl, cold, rejected, what: str) -> dict:
    """fig15's ``_check_shape`` (:177-206): the width, the arrivals against
    a host recount, the reject, cold and placement totals, the sketch
    total equal to the placements, and the diurnal peak above 1.25 × the
    median window."""
    from repro_torch.telemetry import auto_window_s, window_index_np
    K = tl.n_windows
    ws = auto_window_s(float(wl.arrival[-1]), tl.cfg)
    check(float(tl.window_s) == ws, f"{what}: window_s {float(tl.window_s)}"
                                    f" != {ws}")
    expect = np.bincount(np.asarray([window_index_np(float(t), ws, K)
                                     for t in wl.arrival]), minlength=K)
    check(np.array_equal(tl.arrivals, expect),
          f"{what}: arrivals != the host's recount")
    n_rej, n_cold = int(np.sum(rejected)), int(np.sum(cold))
    placed = wl.n - n_rej
    check(int(tl.n_reject.sum()) == n_rej, f"{what}: the reject total")
    check(int(tl.n_cold.sum()) == n_cold, f"{what}: the cold total")
    check(int(tl.n_cold.sum() + tl.n_warm.sum()) == placed,
          f"{what}: the placement total")
    check(int(tl.slow_hist.sum()) == placed,
          f"{what}: the sketch total != the placements")
    arr = np.asarray(tl.arrivals, dtype=np.float64)
    med = float(np.median(arr))
    check(arr.max() > 1.25 * max(med, 1.0),
          f"{what}: no diurnal shape (peak {arr.max():.0f}, median "
          f"{med:.0f})")
    return dict(window_s=ws, peak=int(arr.max()), median=med,
                rejected=n_rej, cold=n_cold)


def replay_checks(np, tl, n_workers, max_events, what: str) -> dict:
    """fig15's decision lane (:247-285): the log within its bound replays
    ``n_on`` on every window with an arrival; a decision was logged; every
    sensor p99 is finite."""
    n_seen = int(tl.ev_count)
    check(n_seen <= max_events, f"{what}: the log was truncated "
                                f"({n_seen} > {max_events})")
    has = np.asarray(tl.arrivals) > 0
    check(np.array_equal(tl.replay_n_on(n_workers)[has],
                         np.asarray(tl.n_on)[has]),
          f"{what}: the replayed n_on != the engine's")
    evs = tl.events()
    auto = [e for e in evs if e["kind"] == "autoscale"]
    check(len(auto) >= 1, f"{what}: no decision logged")
    check(all(np.isfinite(e["sensor_p99"]) for e in auto),
          f"{what}: a sensor p99 is not finite")
    return dict(events=n_seen, autoscale=len(auto),
                n_on_min=int(np.min(tl.n_on[has])),
                n_on_max=int(np.max(tl.n_on[has])))


def timeline_platform(torch, np, report, pool, oracle=None):
    """Phase 16: the timeline plane and the serving platform on the card.
    (a) fig15's parity stacks, E/LL/PS, E/H/PS (its mode flips) and
    E/LL/PS on a two-gen fleet under TARGET_P99 fused, L/LL/FCFS on the
    batched engine on the card: every timeline plane equal to the CPU
    engine's, and the same runs without a timeline equal to them in every
    other plane; (b) the diurnal lane, fused E/LL/PS and
    ``ServingCluster`` with Hermes (one ``hermes_select`` launch per
    arrival) on the card, both through fig15's shape checks, the platform
    equal to its CPU run; (c) the decision lane fused, every plane equal
    to the CPU engine's, the log replayed, and again through the platform
    on the card; (d) the plane's cost on fig4's E/H/PS inputs (none,
    telemetry, telemetry and timeline); (e) ``python -m
    repro_torch.launch.serve`` in a subprocess, its lines and files equal
    to the same run in-process on the CPU; and ``sim_engine`` against
    ``sim_engine_ref`` for the nine balancers under the timeline.  The CPU
    runs go to ``pool``'s workers while the card runs; the parity stacks'
    card runs go to ``oracle`` (phase 20c).  Returns
    (``sim_engine`` launches of the fused runs, ``hermes_select`` launches
    of the platform's runs, the kernel's max abs error against its plain
    version, the plane's timing)."""
    import os
    import tempfile

    from repro_torch.core import (E_LL_PS, HERMES, PAPER_LARGE,
                                  PAPER_TESTBED, WORKLOADS, ClusterCfg,
                                  FleetCfg, ms_trace, parse_policy,
                                  replicate_workload, stack_workloads,
                                  summarize, synth_workload)
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek
    from repro_torch.policy import balancer_names
    from repro_torch.telemetry import TelemetryCfg, TimelineCfg

    t_phase = time.perf_counter()
    tel = TelemetryCfg()
    par_tl = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
    par = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)
    late = parse_policy("L/LL/FCFS")
    stacks = {
        "E/LL/PS": (E_LL_PS, par),
        "E/H/PS|mode-flips": (HERMES, par),
        "E/LL/PS|fleet|auto": (E_LL_PS, par._replace(fleet=FleetCfg(
            preset="two-gen", autoscale="TARGET_P99", min_workers=2,
            target_p99=4.0, cooldown_s=2.0))),
        "L/LL/FCFS": (late, par)}
    par_wb = {k: stack_workloads(synth_workload(cl, load, FIG15_N,
                                                n_functions=5, seed=seed)
                                 for load, seed in FIG15_LOADS)
              for k, (_, cl) in stacks.items()}
    name, load, n, seed = DIURNAL
    di_wl = WORKLOADS[name](PAPER_TESTBED, load, n, seed=seed)
    di_tl = TimelineCfg()
    name, load, n, seed = DECISION
    dec_cl = PAPER_TESTBED._replace(fleet=FleetCfg(
        preset="two-gen", autoscale="TARGET_P99", target_p99=3.0,
        min_workers=2, cooldown_s=2.0))
    dec_wl = WORKLOADS[name](PAPER_TESTBED, load, n, seed=seed)
    dec_tl = TimelineCfg(max_events=512)
    # the plain version's check: phase 5's overloaded cluster under the
    # timeline, with telemetry and TARGET_P99
    tiny = ClusterCfg(n_workers=4, cores=3, capacity_factor=2,
                      cold_start_penalty=0.25)
    overload = stack_workloads(
        synth_workload(tiny, ld, N_SHORT, n_functions=5, hot_fraction=0.8,
                       seed=SEED) for ld in (0.7, 1.3, 3.0))
    tiny_tl = TimelineCfg(n_windows=16, coarse_bins=48, max_events=16)
    auto_tiny = tiny._replace(fleet=FleetCfg(
        preset="long-tail", autoscale="TARGET_P99", target_p99=4.0,
        cooldown_s=1.0))
    ref_jobs = [(b, cl, overload, t, tiny_tl) for cl, t in
                ((tiny, None), (auto_tiny, tel)) for b in balancer_names()]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tl_")

    # the CPU runs, in the worker processes, while the card runs
    t0 = time.perf_counter()
    cpu_par = pool.starmap_async(plain_run, [
        (p, cl, par_wb[k], "cpu", tel, "torch", par_tl)
        for k, (p, cl) in stacks.items()], chunksize=1)
    cpu_dec = pool.apply_async(plain_run, (HERMES, dec_cl,
                                           stack_workloads([dec_wl]), "cpu",
                                           tel, "torch", dec_tl))
    cpu_di = pool.apply_async(plain_run, (E_LL_PS, PAPER_TESTBED,
                                          stack_workloads([di_wl]), "cpu",
                                          None, "torch", di_tl))
    cpu_serve = pool.starmap_async(serve_run, [
        (HERMES, PAPER_TESTBED, di_wl, "cpu", None, di_tl),
        (HERMES, dec_cl, dec_wl, "cpu", tel, dec_tl)], chunksize=1)
    cpu_launch = pool.apply_async(launcher_lines, (
        LAUNCH_FLAGS, os.path.join(tmp, "cpu", "tl.csv")))
    ref_done = pool.starmap_async(plain_engine_ref, ref_jobs, chunksize=1)

    # (d) the plane's cost on fig4's E/H/PS inputs, in turns, twice, before
    # anything else shares the card
    fig4 = replicate_workload(ms_trace, PAPER_LARGE, LOADS, N_MAIN,
                              seeds=(SEED,))
    args = engine_inputs(torch, np, fig4)
    variants = {"off": (None, None), "telemetry": (tel, None),
                "telemetry+timeline": (tel, TimelineCfg())}
    short = [a[:, :50].contiguous() for a in args[:4]] + [args[4]]
    for t, tl in variants.values():     # first-use costs
        ek.sim_engine("H", PAPER_LARGE, *short, t, tl)
    torch.cuda.synchronize()
    plane_ms, plane_res = {k: [] for k in variants}, {}
    for _ in range(2):
        for key, (t, tl) in variants.items():
            res = {}
            plane_ms[key].append(_event_ms(torch, lambda: res.update(
                ek.sim_engine("H", PAPER_LARGE, *args, t, tl))))
            plane_res[key] = res
    for key in ENGINE_PLANES.values():
        check(np.array_equal(plane_res["off"][key].cpu().numpy(),
                             plane_res["telemetry+timeline"][key]
                             .cpu().numpy(), equal_nan=key == "resp"),
              f"fig4 E/H/PS: the timeline changed {key}")
    for key in ("tel_slow_hist", "tel_busy_time", "tel_depth_time"):
        check(torch.equal(plane_res["telemetry"][key],
                          plane_res["telemetry+timeline"][key]),
              f"fig4 E/H/PS: the timeline changed {key}")
    plane = {}
    for key, ms in plane_ms.items():
        b_ms, b_by, nbytes, ops = engine_bound(
            plane_res[key], N_MAIN, len(LOADS), fig4.n_functions)
        plane[key] = dict(ms=min(ms), ms_runs=ms, bound_ms=b_ms,
                          bound_by=b_by, bytes=nbytes, operations=ops,
                          us_per_arrival=min(ms) / N_MAIN * 1e3)
        log(f"fig4 E/H/PS R={len(LOADS)} N={N_MAIN}, {key}: sim_engine "
            f"{min(ms):.3f} ms (runs {', '.join(f'{m:.3f}' for m in ms)}), "
            f"{plane[key]['us_per_arrival']:.4f} us per arrival, "
            f"{min(ms) / min(plane_ms['off']):.3f} x off; bound "
            f"{b_ms:.5f} ms, {b_by} ({nbytes} B, {ops} f64 operations)")

    # (e) the launcher, in a subprocess on the card, beside the rest
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launch_csv = os.path.join(tmp, "card", "tl.csv")
    t_launch = time.perf_counter()
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", *LAUNCH_FLAGS,
         "--timeline-out", launch_csv], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)

    runs, launches = {}, 0
    # (a) the parity stacks: fused (late binding: the batched engine on
    # the card), with and without the timeline
    par_out = {}
    for key, (policy, cl) in stacks.items():
        if key == "L/LL/FCFS":
            out, wall = plain_run(policy, cl, par_wb[key], "cuda", tel,
                                  "auto", par_tl)
            off, _ = plain_run(policy, cl, par_wb[key], "cuda", tel, "auto")
        else:
            out, wall, _, kern = fused_run(torch, np, policy, cl,
                                           par_wb[key], key, tel, par_tl)
            off = fused_run(torch, np, policy, cl, par_wb[key],
                            f"{key} without a timeline", tel)[0]
            launches += 2
        same_planes(np, off, out, f"{key}: with and without the timeline")
        same_obs(np, off, out, f"{key}: with and without the timeline")
        par_out[key] = out
        if oracle is not None:
            oracle.hold("20c timeline", key, policy, cl, par_wb[key], out,
                        (0, 0) if key == "L/LL/FCFS" else (1, 0),
                        telemetry=tel, timeline=par_tl)
        runs[f"parity {key}"] = dict(wall_s=wall,
                                     events=out.timeline.ev_count.tolist())

    # (b) the diurnal lane: fused E/LL/PS, then the platform with Hermes
    di_out, wall, _, kern = fused_run(torch, np, E_LL_PS, PAPER_TESTBED,
                                      stack_workloads([di_wl]),
                                      "diurnal E/LL/PS", None, di_tl)
    launches += 1
    runs["diurnal E/LL/PS fused"] = dict(
        wall_s=wall, us_per_arrival=wall / di_wl.n * 1e6, ms=kern["ms"],
        **timeline_shape(np, di_out.timeline.rep(0), di_wl,
                         di_out.cold[0], di_out.rejected[0],
                         "diurnal E/LL/PS fused"))
    torch.cuda.synchronize()
    hk.hermes_select_batch.launches = 0
    ek.sim_engine.launches = 0
    di_sv, wall = serve_run(HERMES, PAPER_TESTBED, di_wl, "cuda",
                            timeline=di_tl)
    serve_launches = hk.hermes_select_batch.launches
    check(serve_launches == di_wl.n and ek.sim_engine.launches == 0,
          f"diurnal platform: hermes_select launched {serve_launches} "
          f"(expected {di_wl.n}), sim_engine {ek.sim_engine.launches}")
    runs["diurnal Hermes platform"] = dict(
        wall_s=wall, us_per_arrival=wall / di_wl.n * 1e6,
        hermes_select_launches=serve_launches,
        **timeline_shape(np, di_sv.timeline, di_wl, di_sv.cold,
                         di_sv.rejected, "diurnal Hermes platform"))

    # (c) the decision lane: fused, then the platform's --autoscale path
    dec_out, wall, _, kern = fused_run(torch, np, HERMES, dec_cl,
                                       stack_workloads([dec_wl]),
                                       "decision HERMES", tel, dec_tl)
    launches += 1
    runs["decision HERMES fused"] = dict(
        wall_s=wall, us_per_arrival=wall / dec_wl.n * 1e6, ms=kern["ms"],
        **replay_checks(np, dec_out.timeline.rep(0), dec_cl.n_workers,
                        dec_tl.max_events, "decision HERMES fused"))
    hk.hermes_select_batch.launches = 0
    dec_sv, wall = serve_run(HERMES, dec_cl, dec_wl, "cuda", tel, dec_tl)
    dec_launches = hk.hermes_select_batch.launches
    check(dec_launches == dec_wl.n, f"decision platform: hermes_select "
                                    f"launched {dec_launches}, expected "
                                    f"{dec_wl.n}")
    serve_launches += dec_launches
    runs["decision Hermes platform"] = dict(
        wall_s=wall, us_per_arrival=wall / dec_wl.n * 1e6,
        hermes_select_launches=dec_launches,
        prov_core_s=dec_sv.prov_core_s,
        **replay_checks(np, dec_sv.timeline, dec_cl.n_workers,
                        dec_tl.max_events, "decision Hermes platform"))

    # the launcher's subprocess
    stdout, stderr = launcher.communicate(timeout=TL_PHASE_S)
    launch_s = time.perf_counter() - t_launch
    check(launcher.returncode == 0,
          f"the launcher exited {launcher.returncode}: {stderr[-2000:]}")
    check(os.path.exists(launch_csv) and os.path.exists(launch_csv + ".om"),
          "the launcher wrote no timeline CSV or .om file")

    # the CPU's runs against the card's
    for (key, _), (cpu, _) in zip(stacks.items(), cpu_par.get()):
        same_planes(np, par_out[key], cpu, f"parity {key}: card vs CPU")
        same_timeline(np, par_out[key].timeline, cpu.timeline,
                      f"parity {key}: card vs CPU")
    cpu, _ = cpu_di.get()
    same_planes(np, di_out, cpu, "diurnal E/LL/PS: card vs CPU")
    same_timeline(np, di_out.timeline, cpu.timeline,
                  "diurnal E/LL/PS: card vs CPU")
    cpu, _ = cpu_dec.get()
    same_planes(np, dec_out, cpu, "decision HERMES: card vs CPU")
    same_obs(np, dec_out, cpu, "decision HERMES: card vs CPU")
    same_timeline(np, dec_out.timeline, cpu.timeline,
                  "decision HERMES: card vs CPU")
    (di_cpu, di_cpu_s), (dec_cpu, dec_cpu_s) = cpu_serve.get()
    serve_same(np, di_sv, di_cpu, "diurnal Hermes platform")
    serve_same(np, dec_sv, dec_cpu, "decision Hermes platform")
    runs["diurnal Hermes platform"]["cpu_wall_s"] = di_cpu_s
    runs["decision Hermes platform"]["cpu_wall_s"] = dec_cpu_s
    cpu_lines, cpu_csv = cpu_launch.get()
    strip = [ln for ln in stdout.splitlines() if "timeline     :" not in ln]
    want = [ln for ln in cpu_lines.splitlines()
            if "timeline     :" not in ln]
    check(strip == want, f"the launcher printed {strip}, the in-process "
                         f"CPU run {want}")
    check(Path(launch_csv).read_text() == cpu_csv,
          "the launcher's timeline CSV != the in-process CPU run's")
    max_err = 0.0
    for job, plain in zip(ref_jobs, ref_done.get()):
        max_err = max(max_err, kernel_vs_ref(
            torch, np, job, plain, f"{job[0]} under the timeline "
                                   f"({job[1].fleet})"))
    cpu_s = time.perf_counter() - t0
    for key, r in runs.items():
        log(f"{key}: " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in r.items()))
    log(f"the launcher (subprocess on the card, {launch_s:.1f} s): "
        + " | ".join(strip))
    log(f"every timeline plane of the parity stacks, the diurnal and the "
        f"decision lanes == the CPU engine's; the platform's runs == their "
        f"CPU runs; sim_engine == sim_engine_ref under the timeline for "
        f"the {len(balancer_names())} balancers, plain and under "
        f"TARGET_P99 (max abs err {max_err}); {len(ref_jobs) + 9} CPU runs "
        f"in {PLAIN_WORKERS} worker processes, {cpu_s:.1f} s from their "
        f"start")
    phase_s = time.perf_counter() - t_phase
    report["timeline_platform"] = dict(
        runs=runs, plane=plane, launcher_s=launch_s,
        launcher_lines=strip, sim_engine_launches=launches,
        hermes_select_launches=serve_launches, sim_engine_max_abs_err=max_err,
        plain_runs_s=cpu_s, phase_s=phase_s)
    log(f"phase 16: {launches} sim_engine launches, {serve_launches} "
        f"hermes_select launches, {phase_s:.1f} s")
    check(phase_s <= TL_PHASE_S, f"phase 16 took {phase_s:.1f} s (limit "
                                 f"{TL_PHASE_S:.0f} s)")
    return launches, serve_launches, max_err, plane


# -- streaming (phase 17) --

#: fig14's equivalence lane (benchmarks/fig14_stream.py:45-94): 4 × 3
#: cores, capacity 2, N = 240, (load, seed) (0.6, 0) and (1.0, 1), the full
#: mode's chunks (96 does not divide 240)
FIG14_N = 240
FIG14_LOADS = ((0.6, 0), (1.0, 1))
FIG14_CHUNKS = (96, 80)
#: its horizon lane (:56-69): 1000 × 2 cores, capacity 2, azure-diurnal at
#: 0.7, seed 1, chunk 4096, the full day and the quick one
STREAM_CHUNK = 4096
STREAM_N_QUICK = 12_000
PEAK_MB_BUDGET = 4096.0
#: fig15's streaming check (benchmarks/fig15_timeline.py:118-160)
FIG15_CHUNK = 96
STREAM_PHASE_S = 60.0


def fig14_stacks():
    """fig14's fifteen equivalence stacks (fig14_stream.py:72-94): (label,
    policy, cluster)."""
    from repro_torch.core import (Binding, ClusterCfg, FleetCfg,
                                  LifecycleCfg, PolicySpec, WorkerSched)
    from repro_torch.policy import balancer_names
    eq = ClusterCfg(n_workers=4, cores=3, capacity_factor=2)

    def early(b):
        return PolicySpec(Binding.EARLY, b, WorkerSched.PS)
    stacks = [(early(b).name, early(b), eq) for b in balancer_names()]
    for ka in ("NONE", "FIXED_TTL", "HYBRID_HIST"):
        stacks.append((f"E/LL/PS|ka={ka}", early("LL"), eq._replace(
            lifecycle=LifecycleCfg(keepalive=ka))))
    het = eq._replace(fleet=FleetCfg(preset="two-gen"))
    stacks += [("E/LL/PS|fleet", early("LL"), het),
               ("E/SWARM/PS|fleet", early("SWARM"), het)]
    stacks.append(("E/DD/PS|ka=HYBRID_HIST|fleet|auto", early("DD"),
                   eq._replace(
                       lifecycle=LifecycleCfg(keepalive="HYBRID_HIST",
                                              ttl_s=2.0, max_idle=3,
                                              coldstart="paper-sim"),
                       fleet=FleetCfg(preset="two-gen",
                                      autoscale="TARGET_P99", min_workers=2,
                                      target_p99=4.0, cooldown_s=2.0))))
    return stacks


def fig14_batch(cluster):
    from repro_torch.core import stack_workloads, synth_workload
    return stack_workloads(synth_workload(cluster, load, FIG14_N,
                                          n_functions=5, seed=seed)
                           for load, seed in FIG14_LOADS)


def stream_run(policy, cluster, wb, chunk, device, timeline=None,
               segments=False):
    """One ``simulate_stream`` with its per-arrival planes and final state
    (on the host), and with ``segments`` the carry after each chunk:
    (output, carries, wall s).  Top-level, so that a worker process can
    run it."""
    import dataclasses

    from repro_torch.core.streaming import simulate_stream
    seen = []
    t0 = time.perf_counter()
    out = simulate_stream(
        policy, cluster, wb, chunk_size=chunk, device=device,
        timeline=timeline, collect_outputs=True, keep_final_state=True,
        chunk_callback=(lambda c, st: seen.append(
            {k: v.cpu().clone() for k, v in st.items()}))
        if segments else None)
    wall = time.perf_counter() - t0
    final = {k: v.cpu() for k, v in out.final_state.items()}
    return dataclasses.replace(out, final_state=final), seen, wall


def plain_chunks(balance, cluster, wb, chunk, timeline=None):
    """``sim_engine``'s chunk mode in its plain version on the CPU, chunk
    by chunk: the carry after each chunk (the last one drained) and the
    per-arrival planes.  Top-level, so that a worker process can run it."""
    import numpy as np
    import torch

    from repro_torch.kernels.sim_engine import ops
    from repro_torch.telemetry import TelemetryCfg, warmup_cutoff
    tel = TelemetryCfg()
    R, N = wb.n_reps, wb.n
    plan = ops.chunk_plan(balance, cluster, R, wb.n_functions, "cpu", tel,
                          timeline)
    home = torch.as_tensor(wb.func_home, dtype=torch.int32)
    ws = None if timeline is None else \
        wb.arrival[:, -1] / np.float64(timeline.n_windows)
    carry, segs, outs = None, [], []
    for g0 in range(0, N, chunk):
        sl = slice(g0, min(g0 + chunk, N))
        ins = [torch.as_tensor(np.ascontiguousarray(x[:, sl]), dtype=d)
               for x, d in ((wb.arrival, torch.float64),
                            (wb.func, torch.int32),
                            (wb.service, torch.float64),
                            (wb.u_lb, torch.float64))]
        carry, o = ops.sim_engine_chunk(plan, carry, *ins, home, g0=g0,
                                        drain=sl.stop == N,
                                        cutoff=warmup_cutoff(N, tel),
                                        window_s=ws)
        segs.append({k: v.clone() for k, v in carry.items()})
        outs.append(o)
    planes = {k: torch.cat([o[k] for o in outs], dim=1).numpy()
              for k in outs[0]}
    return segs, planes


def same_stream(np, a, b, what: str) -> None:
    """Two streams' outputs equal bit for bit: the per-arrival planes, the
    counters, means, clocks and the sketches."""
    for f in ("cold", "rejected", "worker", "n_done", "n_observed",
              "resp_mean", "slow_mean", "server_time", "core_time",
              "end_time", "prov_core_s"):
        x, y = np.asarray(getattr(a, f)), np.asarray(getattr(b, f))
        check(x.dtype == y.dtype and x.tobytes() == y.tobytes(),
              f"{what}: not equal in {f}")
    for f in TEL_FIELDS:
        check(getattr(a.telemetry, f).tobytes()
              == getattr(b.telemetry, f).tobytes(),
              f"{what}: not equal in the telemetry's {f}")


def fused_layout(st: dict, n_functions: int) -> dict:
    """The batched engine's carry in the fused engine's layout (no pad
    column, no dropped bin, no queue counters, i32 function mirrors)."""
    import torch

    from repro_torch.telemetry import N_BINS
    out = {}
    for k, v in st.items():
        if k in ("q_head", "q_tail") or k.startswith("tl_"):
            continue
        if k in ("warm", "life_idle_since"):
            v = v[:, :, :n_functions]
        elif k in ("tel_slow_hist", "tel_lat_hist"):
            v = v[:, :N_BINS]
        elif k == "task_fn":
            v = v.to(torch.int32)
        out[k] = v
    return out


def same_carry(np, a: dict, b: dict, what: str, keys=None) -> float:
    """Two carries equal bit for bit in every plane both hold (NaN equals
    NaN); ``keys`` those that must be among them.  Returns the max abs
    error."""
    shared = sorted(set(a) & set(b))
    missing = set(keys or ()) - set(shared)
    check(not missing, f"{what}: planes missing: {sorted(missing)}")
    err = 0.0
    for k in shared:
        x, y = a[k].cpu().numpy(), b[k].cpu().numpy()
        check(x.dtype == y.dtype and x.shape == y.shape
              and np.array_equal(x, y, equal_nan=x.dtype.kind == "f"),
              f"{what}: not equal in {k}")
        fx = np.nan_to_num(x.astype(np.float64), nan=-1.0, posinf=0.0)
        fy = np.nan_to_num(y.astype(np.float64), nan=-1.0, posinf=0.0)
        err = max(err, float(np.abs(fx - fy).max(initial=0.0)))
    return err


def _rss_mb() -> float:
    """This process's resident set now, MiB (``/proc/self/status``)."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return float(line.split()[1]) / 1024.0
    return float("nan")


class RssSampler:
    """The largest resident set of this process seen while the block runs
    (``/proc/self/status`` every 2 ms, from a thread), MiB."""

    def __enter__(self):
        import threading
        self.peak = _rss_mb()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)
        self._thread.start()
        return self

    def _sample(self):
        while not self._stop.wait(0.002):
            self.peak = max(self.peak, _rss_mb())

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=5.0)
        self.peak = max(self.peak, _rss_mb())
        return False


def horizon_lane(go, results) -> None:
    """fig14's horizon lane on the card, E/LL/PS in chunks of 4096 at the
    quick day's N = 12 000 and the full day's 86 400, each after a reset of
    the device's peak with nothing else allocated, then the monolithic
    fused run on the same inputs (wall and the CUDA-event span of each);
    then the stream's own chunk loop under torch's sync check.  Run in a
    fresh process, so that no earlier phase shares its device allocator:
    its imports, a short warm-up of both runs and the workloads come
    first, then it waits for ``go`` (set when the parent leaves the card
    to it) and puts what it measured, or the error, into ``results``; the
    caller checks it.  The stream's host memory is the largest
    resident set sampled while it runs less the resident set before it:
    ``import torch`` alone holds more than the reference's 4096 MiB budget
    on the card's machine, whose kernel keeps no ``VmHWM`` and refuses
    ``reset_peak_rss``, so ``peak_rss_mb`` there reads ``ru_maxrss``,
    which a spawned process inherits from its parent across ``exec``
    (both are reported).  Top-level, so that a spawned process can run
    it."""
    import traceback
    try:
        results.put(_horizon_lane(go))
    except Exception:
        results.put({"error": traceback.format_exc()})


def _horizon_lane(go) -> dict:
    import gc

    import numpy as np
    import torch

    from repro_torch.core import (E_LL_PS, WORKLOADS, ClusterCfg,
                                  stack_workloads)
    from repro_torch.core import streaming as stream_mod
    from repro_torch.core.streaming import (final_states_equal,
                                            monolithic_state,
                                            simulate_stream)
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek
    from repro_torch.telemetry import TelemetryCfg, warmup_cutoff
    from repro_torch.telemetry.manifest import peak_rss_mb, reset_peak_rss
    rss_torch = _rss_mb()
    torch.zeros(1, device="cuda")
    tel = TelemetryCfg()
    hc = ClusterCfg(**HORIZON)
    make = WORKLOADS["azure-diurnal"]
    # first-use costs (module loads, the pinned allocator) out of the timed
    # runs, and the inputs made, before the card is this process's alone
    warm = make(hc, 0.7, 300, seed=1)
    simulate_stream(E_LL_PS, hc, warm, chunk_size=128, device="cuda")
    monolithic_state(E_LL_PS, hc, warm, device="cuda", telemetry=tel)
    days = {}
    for n in (STREAM_N_QUICK, HORIZON_N):
        t_gen = time.perf_counter()
        days[n] = (make(hc, 0.7, n, seed=1), time.perf_counter() - t_gen)
    torch.cuda.synchronize()
    if not go.wait(timeout=2 * STREAM_PHASE_S):
        raise RuntimeError("the card was not left to the horizon lane")
    out_rows = {}

    def span_ms(start):
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    for n in (STREAM_N_QUICK, HORIZON_N):
        wl, gen_s = days[n]
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset = reset_peak_rss()
        rss0 = _rss_mb()
        ek.sim_engine.launches = 0
        hk.hermes_select_batch.launches = 0
        with RssSampler() as rss:
            start = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            out = simulate_stream(E_LL_PS, hc, wl, chunk_size=STREAM_CHUNK,
                                  device="cuda", keep_final_state=True)
            wall = time.perf_counter() - t0
            span = span_ms(start)
        row = dict(n=n, chunks=out.n_chunks,
                   launches=ek.sim_engine.launches,
                   hermes_select_launches=hk.hermes_select_batch.launches,
                   generate_s=gen_s, wall_s=wall, span_ms=span,
                   us_per_arrival=wall / n * 1e6,
                   n_done=int(out.n_done[0]),
                   n_observed=int(out.n_observed[0]),
                   slow_p99=float(out.telemetry.slow_percentile(99.0)),
                   slow_mean=float(out.slow_mean[0]),
                   resp_mean=float(out.resp_mean[0]),
                   device_peak_bytes=torch.cuda.max_memory_allocated()
                   - base, device_base_bytes=base, rss_reset=reset,
                   host_rss_torch_mb=rss_torch, host_rss_before_mb=rss0,
                   host_rss_peak_mb=rss.peak,
                   host_rss_growth_mb=rss.peak - rss0,
                   peak_rss_mb=peak_rss_mb())
        state = out.final_state
        del out
        ek.sim_engine.launches = 0
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        mono = monolithic_state(E_LL_PS, hc, wl, device="cuda",
                                telemetry=tel)
        torch.cuda.synchronize()
        row["mono_wall_s"] = time.perf_counter() - t0
        row["mono_span_ms"] = span_ms(start)
        row["mono_us_per_arrival"] = row["mono_wall_s"] / n * 1e6
        row["mono_launches"] = ek.sim_engine.launches
        row["state_differs"] = final_states_equal(state, mono)[1]
        resp = mono["resp"].cpu().numpy()
        done = ~np.isnan(resp)
        row["mono_n_done"] = int(done.sum())
        row["mono_n_observed"] = int(
            (done & (np.arange(n) >= warmup_cutoff(n, tel))).sum())
        out_rows[n] = row
        del state, mono, resp
    # the chunks go to the card with no host sync between them: the
    # stream's own loop under torch's sync check
    wl = make(hc, 0.7, STREAM_N_QUICK, seed=1)
    run = stream_mod._Run(E_LL_PS, hc, stack_workloads([wl]), STREAM_CHUNK,
                          torch.device("cuda"), "auto", tel, None,
                          warmup_cutoff(STREAM_N_QUICK, tel))
    n_chunks = -(-STREAM_N_QUICK // STREAM_CHUNK)
    torch.cuda.synchronize()
    ek.sim_engine.launches = 0
    synced = None
    t0 = time.perf_counter()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for c in range(n_chunks):
            run.chunk(slice(c * STREAM_CHUNK,
                            min((c + 1) * STREAM_CHUNK, STREAM_N_QUICK)),
                      c == n_chunks - 1, False)
    except RuntimeError as e:
        synced = str(e)
    finally:
        enqueue_s = time.perf_counter() - t0
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    out_rows["enqueue"] = dict(chunks=n_chunks, enqueue_s=enqueue_s,
                               with_device_s=time.perf_counter() - t0,
                               launches=ek.sim_engine.launches,
                               synced=synced)
    return out_rows


def streaming(torch, np, report, pool, oracle=None):
    """Phase 17: horizon-scale streaming (``simulate_stream``) on the card.
    (a) fig14's equivalence lane: its fifteen stacks at chunks 96 and 80,
    each a fused stream (one ``sim_engine`` launch per chunk in chunk mode,
    and one for the drain after the chunk callback) equal to the fused
    monolithic run (``final_states_equal``) and to the port's batched
    stream on the CPU, the kernel's carry after each chunk equal to
    ``sim_engine_ref``'s chunk mode (and for two stacks to the batched
    stream's); E/H/FCFS streamed through the batched engine on the card
    (one ``hermes_select`` launch per arrival) equal to the CPU's.  (b) its
    horizon lane at the full day, N = 86 400 in chunks of 4096 (22
    launches) beside the monolithic fused run on the same inputs: the
    final state and counters equal; the device peak no larger than at the
    quick day's N = 12 000; the host peak RSS within the reference's
    budget; the chunks enqueued with no host sync.  (c) fig15's streaming
    check: the three early-binding parity stacks' timelines and final
    states equal the monolithic runs'.  The CPU runs go to ``pool``'s
    workers while the card runs; E/LL/PS's stream at ORACLE_CHUNK, with
    its carry after each chunk, goes to ``oracle`` (phase 20d).  Returns
    (``sim_engine`` launches, ``hermes_select`` launches, the chunk mode's
    max abs error against its plain version)."""
    import multiprocessing

    from repro_torch.core import E_LL_PS, HERMES, FleetCfg, parse_policy
    from repro_torch.core.simulator import simulate_many
    from repro_torch.core.streaming import (final_states_equal,
                                            monolithic_state)
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek
    from repro_torch.telemetry import TelemetryCfg, TimelineCfg

    t_phase = time.perf_counter()
    tel = TelemetryCfg()
    stacks = fig14_stacks()
    batches = {label: fig14_batch(cl) for label, _, cl in stacks}
    eq = stacks[0][2]
    fcfs = parse_policy("E/H/FCFS")
    fcfs_wb = fig14_batch(eq)
    par_tl = TimelineCfg(n_windows=32, coarse_bins=96, max_events=128)
    parity = [("E/LL/PS", E_LL_PS, eq), ("E/H/PS|mode-flips", HERMES, eq),
              ("E/LL/PS|fleet|auto", E_LL_PS, eq._replace(fleet=FleetCfg(
                  preset="two-gen", autoscale="TARGET_P99", min_workers=2,
                  target_p99=4.0, cooldown_s=2.0)))]
    seg_checked = ("E/H/PS", "E/DD/PS|ka=HYBRID_HIST|fleet|auto")

    # the CPU runs, in the worker processes, while the card runs
    t0 = time.perf_counter()
    jobs = [(p, cl, batches[label], k, "cpu", None, label in seg_checked)
            for label, p, cl in stacks for k in FIG14_CHUNKS]
    cpu_streams = pool.starmap_async(stream_run, jobs, chunksize=1)
    ref_jobs = [(p.balance, cl, batches[label], k)
                for label, p, cl in stacks for k in FIG14_CHUNKS]
    cpu_refs = pool.starmap_async(plain_chunks, ref_jobs, chunksize=1)
    cpu_fcfs = pool.apply_async(stream_run, (fcfs, eq, fcfs_wb, 96, "cpu"))

    # (b) the horizon lane, in a fresh process of its own (its host memory
    # and device allocator the stream's, not the earlier phases'): it
    # starts now and times its runs once the card is left to it, below
    ctx = multiprocessing.get_context("spawn")
    lane_go, lane_results = ctx.Event(), ctx.Queue()
    lane = ctx.Process(target=horizon_lane, args=(lane_go, lane_results),
                       daemon=True)
    lane.start()
    launches = 0

    # (a) the equivalence lane on the card
    eq_rows, segs_card, streams_card = {}, {}, {}
    for label, policy, cl in stacks:
        wb = batches[label]
        ek.sim_engine.launches = 0
        mono = monolithic_state(policy, cl, wb, device="cuda", telemetry=tel)
        launches += ek.sim_engine.launches
        for k in FIG14_CHUNKS:
            ek.sim_engine.launches = 0
            hk.hermes_select_batch.launches = 0
            out, seen, wall = stream_run(policy, cl, wb, k, "cuda",
                                         segments=True)
            n_chunks = -(-FIG14_N // k)
            check((ek.sim_engine.launches, hk.hermes_select_batch.launches)
                  == (n_chunks + 1, 0),
                  f"{label} chunk {k}: launched sim_engine "
                  f"{ek.sim_engine.launches}, hermes_select "
                  f"{hk.hermes_select_batch.launches} (expected "
                  f"{n_chunks + 1}, 0)")
            launches += n_chunks + 1
            ok, bad = final_states_equal(out.final_state, mono)
            check(ok, f"{label} chunk {k}: stream != monolithic in {bad}")
            for plane, key in (("cold", "cold"), ("rejected", "rejected"),
                               ("worker", "worker_of")):
                check(np.array_equal(getattr(out, plane),
                                     mono[key].cpu().numpy()),
                      f"{label} chunk {k}: stream != monolithic in {plane}")
            segs_card[label, k], streams_card[label, k] = seen, out
            eq_rows[f"{label} k{k}"] = dict(wall_s=wall, chunks=n_chunks)
            if oracle is not None and label == "E/LL/PS" and \
                    k == ORACLE_CHUNK:
                oracle.hold("20d", f"{label} chunk {k}", policy, cl, wb,
                            out, (n_chunks + 1, 0), telemetry=tel,
                            chunk=k, segments=seen)
    # E/H/FCFS through the batched engine on the card
    ek.sim_engine.launches = 0
    hk.hermes_select_batch.launches = 0
    fcfs_out, _, fcfs_wall = stream_run(fcfs, eq, fcfs_wb, 96, "cuda")
    fcfs_launches = hk.hermes_select_batch.launches
    check(fcfs_launches == FIG14_N and ek.sim_engine.launches == 0,
          f"E/H/FCFS stream: hermes_select launched {fcfs_launches} "
          f"(expected {FIG14_N}), sim_engine {ek.sim_engine.launches}")

    # (c) fig15's streaming check
    fig15 = {}
    for label, policy, cl in parity:
        wb = batches["E/LL/PS"] if cl == eq else fig14_batch(cl)
        ek.sim_engine.launches = 0
        out, _, wall = stream_run(policy, cl, wb, FIG15_CHUNK, "cuda",
                                  par_tl)
        mono_out = simulate_many(policy, cl, wb, device="cuda",
                                 telemetry=tel, timeline=par_tl)
        mono = monolithic_state(policy, cl, wb, device="cuda",
                                telemetry=tel, timeline=par_tl)
        n_chunks = -(-FIG14_N // FIG15_CHUNK)
        check(ek.sim_engine.launches == n_chunks + 2,
              f"fig15 {label}: sim_engine launched "
              f"{ek.sim_engine.launches}, expected {n_chunks + 2}")
        launches += n_chunks + 2
        same_timeline(np, out.timeline, mono_out.timeline,
                      f"fig15 {label}: stream vs monolithic")
        ok, bad = final_states_equal(out.final_state, mono)
        check(ok, f"fig15 {label}: stream != monolithic in {bad}")
        fig15[label] = dict(wall_s=wall,
                            events=out.timeline.ev_count.tolist())

    # the card to the horizon lane alone; the CPU's checks meanwhile
    torch.cuda.synchronize()
    lane_go.set()

    # the CPU's runs against the card's
    max_err = 0.0
    for (label, policy, cl), (k, (cpu, cpu_seen, _)) in zip(
            [s for s in stacks for _ in FIG14_CHUNKS],
            zip(FIG14_CHUNKS * len(stacks), cpu_streams.get())):
        card = streams_card[label, k]
        same_stream(np, card, cpu, f"{label} chunk {k}: card vs CPU")
        same_carry(np, card.final_state,
                   fused_layout(cpu.final_state, 5),
                   f"{label} chunk {k}: card vs CPU carry",
                   ("remaining", "task_idx", "task_fn", "task_svc", "warm"))
        if cpu_seen:
            for c, (a, b) in enumerate(zip(segs_card[label, k], cpu_seen)):
                same_carry(np, a, fused_layout(b, 5),
                           f"{label} chunk {k}: card vs CPU after chunk {c}",
                           ("remaining", "task_idx", "warm",
                            "stream_slow_sum"))
    for (label, k), (segs, planes) in zip(
            [(label, k) for label, _, _ in stacks for k in FIG14_CHUNKS],
            cpu_refs.get()):
        card = segs_card[label, k]
        check(len(card) == len(segs),
              f"{label} chunk {k}: {len(card)} chunks, plain {len(segs)}")
        # the card's last carry is before its drain launch; the plain
        # version drained its last chunk: the final states compare
        for c, (a, b) in enumerate(zip(card[:-1], segs[:-1])):
            max_err = max(max_err, same_carry(
                np, a, b, f"{label} chunk {k}: sim_engine != sim_engine_ref"
                          f" after chunk {c}"))
            check(set(a) == set(b), f"{label}: carries of other planes")
        max_err = max(max_err, same_carry(
            np, streams_card[label, k].final_state, segs[-1],
            f"{label} chunk {k}: sim_engine != sim_engine_ref (final)"))
        for plane, key in (("cold", "cold"), ("rejected", "rejected"),
                           ("worker", "worker_of")):
            check(np.array_equal(getattr(streams_card[label, k], plane),
                                 planes[key]),
                  f"{label} chunk {k}: sim_engine != sim_engine_ref in "
                  f"{plane}")
    cpu, _, fcfs_cpu_s = cpu_fcfs.get()
    same_stream(np, fcfs_out, cpu, "E/H/FCFS stream: card vs CPU")
    ok, bad = final_states_equal(fcfs_out.final_state, cpu.final_state)
    check(ok, f"E/H/FCFS stream: card vs CPU carry in {bad}")
    cpu_s = time.perf_counter() - t0

    # the horizon lane's runs
    horizon = lane_results.get(timeout=STREAM_PHASE_S)
    lane.join(timeout=STREAM_PHASE_S)
    check("error" not in horizon,
          f"the horizon lane failed: {horizon.get('error')}")
    for n in (STREAM_N_QUICK, HORIZON_N):
        r = horizon[n]
        check(r["launches"] == -(-n // STREAM_CHUNK)
              and r["hermes_select_launches"] == 0,
              f"horizon N={n}: sim_engine launched {r['launches']} times, "
              f"expected {-(-n // STREAM_CHUNK)}")
        check(r["mono_launches"] == 1, f"horizon N={n}: the monolithic run "
                                       f"launched {r['mono_launches']} times")
        launches += r["launches"] + r["mono_launches"]
        check(not r["state_differs"], f"horizon N={n}: stream != "
                                      f"monolithic in {r['state_differs']}")
        check(r["n_done"] == r["mono_n_done"]
              and r["n_observed"] == r["mono_n_observed"],
              f"horizon N={n}: the counters != the monolithic run's")
        check(r["host_rss_growth_mb"] <= PEAK_MB_BUDGET,
              f"horizon N={n}: the stream's host memory "
              f"{r['host_rss_growth_mb']:.1f} MiB > {PEAK_MB_BUDGET}")
    peaks = {n: horizon[n]["device_peak_bytes"]
             for n in (STREAM_N_QUICK, HORIZON_N)}
    check(peaks[HORIZON_N] <= peaks[STREAM_N_QUICK],
          f"the device peak grew with the horizon: {peaks}")
    check(horizon["enqueue"]["synced"] is None,
          f"the stream's chunk loop synced the host: "
          f"{horizon['enqueue']['synced']}")
    launches += horizon["enqueue"]["launches"]

    for n in (STREAM_N_QUICK, HORIZON_N):
        r = horizon[n]
        log(f"horizon lane N={n} ({r['chunks']} chunks of {STREAM_CHUNK}, "
            f"{r['launches']} launches): stream {r['wall_s']:.3f} s "
            f"({r['us_per_arrival']:.2f} us per arrival; CUDA-event span "
            f"{r['span_ms']:.3f} ms), monolithic {r['mono_wall_s']:.3f} s "
            f"({r['mono_us_per_arrival']:.2f}; {r['mono_span_ms']:.3f} ms);"
            f" stream / monolithic {r['wall_s'] / r['mono_wall_s']:.4f} "
            f"(wall), {r['span_ms'] / r['mono_span_ms']:.4f} (span); "
            f"n_done {r['n_done']}, sketch p99 slowdown {r['slow_p99']:.4f},"
            f" mean {r['slow_mean']:.4f}; device peak "
            f"{r['device_peak_bytes']} B over {r['device_base_bytes']} B "
            f"allocated before; host: RSS {r['host_rss_before_mb']:.1f} MiB"
            f" before the stream (after importing torch: "
            f"{r['host_rss_torch_mb']:.1f}), at most "
            f"{r['host_rss_peak_mb']:.1f} while it ran: the stream's "
            f"{r['host_rss_growth_mb']:.1f} MiB (peak_rss_mb "
            f"{r['peak_rss_mb']:.1f}, reset_peak_rss {r['rss_reset']})")
    e = horizon["enqueue"]
    log(f"horizon lane enqueue: {e['chunks']} chunks in "
        f"{e['enqueue_s'] * 1e3:.2f} ms with no host sync "
        f"({e['with_device_s']:.3f} s with the card's work)")
    log(f"fig14 equivalence: {len(stacks)} stacks x chunks {FIG14_CHUNKS}: "
        f"stream == monolithic fused run, == the CPU's batched stream, "
        f"sim_engine == sim_engine_ref after every chunk (max abs err "
        f"{max_err}); E/H/FCFS on the card: {fcfs_launches} hermes_select "
        f"launches, {fcfs_wall:.2f} s (CPU {fcfs_cpu_s:.2f} s); "
        f"{len(jobs) + len(ref_jobs) + 1} CPU runs, {cpu_s:.1f} s")
    for label, r in fig15.items():
        log(f"fig15 stream {label}: timeline and state == monolithic, "
            f"events {r['events']}")
    phase_s = time.perf_counter() - t_phase
    report["streaming"] = dict(
        horizon={str(k): v for k, v in horizon.items()}, equivalence=eq_rows,
        fig15=fig15, fcfs_hermes_select_launches=fcfs_launches,
        sim_engine_launches=launches, sim_engine_max_abs_err=max_err,
        plain_runs_s=cpu_s, phase_s=phase_s)
    log(f"phase 17: {launches} sim_engine launches, {fcfs_launches} "
        f"hermes_select launches, {phase_s:.1f} s")
    check(phase_s <= STREAM_PHASE_S, f"phase 17 took {phase_s:.1f} s "
                                     f"(limit {STREAM_PHASE_S:.0f} s)")
    return launches, fcfs_launches, max_err


# -- MoE and MLA serving at full width (phase 18) -----------------------------

#: phase 18's models and weight seeds, at their published widths and bf16
#: parameters, cut to MOE_LAYERS layers: a full stack is ~264 GB (dbrx)
#: or ~472 GB (deepseek) of bf16 weights, one card holds 80 GB, and the
#: phase keeps up to four warm copies (2 workers × 2 functions)
MOE_SERVED = (("dbrx-132b", 5), ("deepseek-v2-236b", 6))
MOE_LAYERS = 2
#: 18b's depth per dtype: an f32 copy of one layer is ~13 GB (dbrx) or
#: ~16 GB (deepseek) beside its embeddings
MOE_CHECK_LAYERS = {"bfloat16": 2, "float32": 1}
MOE_PROMPT_SEED = 3
MOE_PHASE_S = 60.0
#: 18c and 18d: the launcher's registrations and workload
#: (``python -m repro_torch.launch.serve --backend models``)
ZOO_REQUESTS = 8
LAUNCHER_REQUESTS = 12
#: dbrx-132b's attention at the served prompt lengths and cache: 48 query
#: heads on 8 KV heads, Dh = 128 (bf16, as served)
DBRX_FLASH_CASES = ((1, 777, 48, 8, 128), (1, 1500, 48, 8, 128))
DBRX_DECODE_CASES = tuple((1, MAX_LEN, 48, 8, 128, p) for p in (0, 776, 2047))


class RouteRecorder:
    """Every call of the port's MoE router while it is installed: the
    chosen experts ``[T, k]`` and the f32 router logits ``[T, E]``, in
    call order (one call a layer)."""

    def __init__(self):
        from repro_torch.models import moe
        self.moe, self.real, self.calls = moe, moe._router, []

    def __enter__(self):
        def spy(cfg, p, xf):
            out = self.real(cfg, p, xf)
            self.calls.append((out[1], xf.float() @ p["router"].float()))
            return out
        self.moe._router = spy
        return self

    def __exit__(self, *exc):
        self.moe._router = self.real
        return False

    def take(self):
        calls, self.calls = self.calls, []
        return calls


def route_compare(fwd_calls, path_calls, n_layers, prompt, steps):
    """The full forward's routing (one call a layer over ``prompt + steps``
    tokens) against the prefill's (one a layer over the prompt) and the
    decode steps' (one a layer, a token each).  Returns the share of
    (token, expert) choices the two paths agree on, the compared
    positions (the prompt's last and each step's) whose choices differ in
    some layer, and the largest |Δ router logit| / max |router logit| at
    the compared positions over the layers before their first flip."""
    fwd_idx = [c[0] for c in fwd_calls]
    fwd_log = [c[1] for c in fwd_calls]
    pre = path_calls[:n_layers]
    dec = path_calls[n_layers:]
    check(len(fwd_calls) == n_layers and len(dec) == n_layers * steps,
          f"router calls: forward {len(fwd_calls)}, path {len(path_calls)}")
    agree = total = 0
    flipped, gap = set(), 0.0
    for layer in range(n_layers):
        a = fwd_idx[layer][:prompt].sort(dim=-1).values
        b = pre[layer][0].sort(dim=-1).values
        agree += int((a[..., :, None] == b[..., None, :]).any(-1).sum())
        total += a.numel()
    for layer in range(n_layers):
        for i in range(steps + 1):
            t = prompt - 1 + i
            got = (pre[layer] if i == 0 else dec[(i - 1) * n_layers + layer])
            row = 0 if i else prompt - 1
            idx_b, log_b = got[0][row], got[1][row]
            idx_a, log_a = fwd_idx[layer][t], fwd_log[layer][t]
            if i:
                agree += int((idx_a.sort().values[:, None]
                              == idx_b.sort().values[None, :]).any(-1).sum())
                total += idx_a.numel()
            if t not in flipped:
                gap = max(gap, float((log_a - log_b).abs().max()
                                     / fwd_log[layer][t].abs().max()))
            if set(idx_a.tolist()) != set(idx_b.tolist()):
                flipped.add(t)
    return agree / total, sorted(flipped), gap


def moe_prefill_decode_vs_forward(torch, np, report):
    """18b: for both models at full width, prefill plus CHECK_STEPS
    teacher-forced decode steps through the cache against the full
    forward over the same tokens and parameters (dbrx: ``pallas`` against
    ``naive``; deepseek: MLA's absorbed latent decode against its
    decompressed forward), bf16 at 2 layers and f32 at 1.  Every compared
    position whose routing agrees in every layer is held to the phase 8
    bound (``MODEL_TOL`` × max |logit|); a position where one path picked
    another expert is reported, its router logits (like every compared
    position's, up to its first flip) held to the same bound.  f32 allows
    no flip."""
    import dataclasses

    from repro_torch import configs
    from repro_torch.models.transformer import build_model
    out = {}
    n = CHECK_PROMPT + CHECK_STEPS
    for name, seed in MOE_SERVED:
        toks = torch.as_tensor(np.random.default_rng(seed).integers(
            0, configs.get(name).vocab, (1, n)), device="cuda")
        for dtype, tol in MODEL_TOL.items():
            L = MOE_CHECK_LAYERS[dtype]
            cfg = dataclasses.replace(configs.get(name), attn_impl="pallas",
                                      dtype=dtype, param_dtype=dtype,
                                      n_layers=L)
            model = build_model(cfg, "cuda")
            plain = build_model(dataclasses.replace(cfg, attn_impl="naive"),
                                "cuda")
            params = model.init(
                torch.Generator(device="cuda").manual_seed(seed))
            with RouteRecorder() as rec:
                want = plain.forward(params, toks)[0][:, CHECK_PROMPT - 1:]
                fwd_calls = rec.take()
                cache = model.init_cache(1, MAX_LEN)
                logits, cache = model.prefill(params, toks[:, :CHECK_PROMPT],
                                              cache)
                got = [logits]
                for i in range(CHECK_PROMPT, n):
                    logits, cache = model.decode_step(
                        params, toks[:, i:i + 1], cache,
                        torch.full((1,), i, dtype=torch.int32,
                                   device="cuda"))
                    got.append(logits)
                path_calls = rec.take()
            got = torch.cat(got, dim=1).float()
            want = want.float()
            check(got.shape == want.shape and bool(got.isfinite().all()),
                  f"{name} {dtype}: logits {tuple(got.shape)} vs "
                  f"{tuple(want.shape)} or not finite")
            share, flipped, gap = route_compare(
                fwd_calls, path_calls, L, CHECK_PROMPT, CHECK_STEPS)
            keep = [i for i in range(CHECK_STEPS + 1)
                    if CHECK_PROMPT - 1 + i not in flipped]
            scale = float(want.abs().max())
            err_all = float((got - want).abs().max())
            err = float((got[:, keep] - want[:, keep]).abs().max()) \
                if keep else 0.0
            log(f"{name} {dtype} at {L} layers: prefill of {CHECK_PROMPT} + "
                f"{CHECK_STEPS} decode steps vs the plain forward over {n} "
                f"tokens: routing agrees on {share:.6f} of (token, expert) "
                f"choices; flipped compared positions {flipped}; max |Δ| "
                f"{err:.4e} over the {len(keep)} unflipped, max |logit| "
                f"{scale:.4f}, ratio {err / scale:.3e} (bound {tol:g}; "
                f"every position: {err_all / scale:.3e}); router logits "
                f"ratio {gap:.3e}")
            if dtype == "float32":
                check(not flipped, f"{name} f32: routing flipped at "
                                   f"{flipped}")
            check(err <= tol * scale, f"{name} {dtype}: kernel path != "
                                      f"plain forward ({err} > {tol} × "
                                      f"{scale})")
            check(gap <= tol, f"{name} {dtype}: router logits differ by "
                              f"{gap:.3e} of their max (bound {tol:g})")
            out[f"{name} {dtype}"] = dict(
                n_layers=L, max_abs_err=err, max_abs_logit=scale,
                ratio=err / scale, ratio_every_position=err_all / scale,
                bound=tol, routing_agree=share, flipped_positions=flipped,
                router_logit_ratio=gap)
            del params, cache, model, plain
            torch.cuda.empty_cache()
    report["moe_prefill_decode_vs_forward"] = out
    return out


def dbrx_attention_kernels(torch, np):
    """Both attention kernels against their plain versions at dbrx-132b's
    shapes (bf16, ``ATTN_TOL``): the largest errors."""
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention.ref import decode_attention_ref
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention.ref import flash_attention_ref
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dt, tol = torch.bfloat16, ATTN_TOL["bfloat16"]
    errs = {}
    for case in DBRX_FLASH_CASES:
        q, k, v = _flash_inputs(torch, gen, case, dt)
        errs[f"flash_attention {case}"] = (fk.flash_attention(q, k, v),
                                           flash_attention_ref(q, k, v))
    for case in DBRX_DECODE_CASES:
        q, k, v, pos = _decode_inputs(torch, gen, np, case, dt)
        errs[f"decode_attention {case}"] = (
            dk.decode_attention(q, k, v, pos),
            decode_attention_ref(q, k, v, pos))
    out = {}
    for what, (got, want) in errs.items():
        err = float((got.float() - want.float()).abs().max())
        ok = bool(torch.allclose(got.float(), want.float(), rtol=tol,
                                 atol=tol))
        log(f"dbrx-132b {what} bf16: max abs err {err:.3e} "
            f"({'ok' if ok else 'FAILED'} at atol = rtol = {tol})")
        check(ok, f"dbrx-132b {what}: kernel != plain (err {err})")
        out[what] = err
    return out


def frontend_zoo(torch, np, report):
    """18c: every balancer of ``balancer_names()`` behind a frontend on
    the card serving the launcher's workload; ``hermes_select`` launched
    once a dispatch under ``H`` and never otherwise; the carried state of
    HIKU, DD and SWARM on the card after every dispatch.  Returns the
    ``hermes_select`` and ``rwkv6_wkv`` launches."""
    from repro_torch import configs
    from repro_torch.policy import balancer_names
    from repro_torch.serving.backends import (HermesFrontend, Invocation,
                                              ModelRegistry)
    counters = _counters()
    reg = ModelRegistry()
    reg.register("olmo-tiny", configs.get_smoke("olmo-1b"))
    reg.register("rwkv-tiny", configs.get_smoke("rwkv6-3b"))
    rows, totals = {}, {"hermes_select": 0, "rwkv6_wkv": 0}
    for bal in balancer_names():
        fe = HermesFrontend(reg, n_workers=2, cores=2, max_len=64,
                            balancer=bal, device="cuda")
        rng = np.random.default_rng(0)
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        t0 = time.perf_counter()
        placed = []
        for i in range(ZOO_REQUESTS):
            fn = ("olmo-tiny", "rwkv-tiny")[i % 2]
            inv = fe.dispatch(Invocation(func=fn, n_new=4,
                                         prompt=rng.integers(0, 100, 8)))
            check(inv.tokens.shape == (4,), f"{bal}: bad tokens")
            placed.append((inv.worker, inv.cold))
            if fe._lb_state is not None:
                devs = {t.device.type for t in fe._lb_state.values()}
                check(devs == {"cuda"}, f"{bal}: the balancer's state left "
                                        f"the card ({devs})")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        want_h = ZOO_REQUESTS if bal == "H" else 0
        check(launches["hermes_select"] == want_h,
              f"{bal}: hermes_select launched {launches['hermes_select']} "
              f"times, expected {want_h}")
        check(launches["sim_engine"] == 0 and
              launches["flash_attention"] == 0, f"{bal}: {launches}")
        for k in totals:
            totals[k] += launches[k]
        rows[bal] = dict(placed=placed, wall_s=wall, launches=launches,
                         stateful=fe._lb_state is not None)
        log(f"frontend {bal}: {ZOO_REQUESTS} requests in {wall:.2f} s, "
            f"(worker, cold) {placed}, launches {launches}"
            + ("; its state on the card" if fe._lb_state is not None
               else ""))
        del fe
    report["frontend_zoo"] = rows
    return totals


def moe_serving(torch, np, report):
    """Phase 18: the MoE and MLA families served at full width (18a) and a
    profiled stretch of their decode steps, their prefill and decode
    against the full forward (18b), both attention
    kernels at dbrx's shapes, the frontend's nine balancers (18c) and the
    launcher's ``--backend models`` in a subprocess (18d).  Returns the
    launches to add to the kernels line and the largest kernel error."""
    import os
    import re
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fe, launches = serving_path(torch, np, report, MOE_SERVED,
                                MOE_PROMPT_SEED, "moe_serving",
                                n_layers=MOE_LAYERS)
    peak = torch.cuda.max_memory_allocated()
    n_warm = sum(len(w.warm) for w in fe.workers)
    log(f"18a: {n_warm} warm copies; device peak "
        f"{peak / 1e9:.2f} GB (torch.cuda.max_memory_allocated)")
    report["moe_serving"]["max_memory_allocated_gb"] = peak / 1e9
    report["moe_serving"]["warm_copies"] = n_warm
    profile_decode(torch, report, fe, MOE_SERVED, "moe_decode_profile")
    del fe
    torch.cuda.empty_cache()
    moe_prefill_decode_vs_forward(torch, np, report)
    kernel_err = dbrx_attention_kernels(torch, np)
    report["moe_attention_kernels"] = kernel_err
    # 18d beside 18c: the launcher in a subprocess on the card
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t_launch = time.perf_counter()
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.serve", "--backend",
         "models", "--requests", str(LAUNCHER_REQUESTS)], env=env,
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    zoo = frontend_zoo(torch, np, report)
    stdout, stderr = launcher.communicate(timeout=MOE_PHASE_S)
    launch_s = time.perf_counter() - t_launch
    check(launcher.returncode == 0,
          f"the launcher exited {launcher.returncode}: {stderr[-2000:]}")
    line = re.compile(r"^req +\d+ (olmo|rwkv)-tiny +worker=\d "
                      r"(COLD|warm) +\d+\.\dms$")
    lines = stdout.splitlines()
    check(len(lines) == LAUNCHER_REQUESTS and all(line.match(ln)
                                                  for ln in lines),
          f"the launcher printed {lines}")
    log(f"18d: the launcher (subprocess on the card, {launch_s:.1f} s) "
        f"printed {len(lines)} lines, the first {lines[0]!r}")
    report["moe_launcher"] = dict(lines=lines, wall_s=launch_s)
    phase_s = time.perf_counter() - t_phase
    log(f"phase 18: {phase_s:.1f} s")
    check(phase_s <= MOE_PHASE_S, f"phase 18 took {phase_s:.1f} s (limit "
                                  f"{MOE_PHASE_S:.0f} s)")
    totals = {k: launches[k] for k in ("flash_attention",
                                       "decode_attention", "hermes_select",
                                       "rwkv6_wkv")}
    for k, v in zoo.items():
        totals[k] += v
    return totals, kernel_err


# ---------------------------------------------------------------------------
# Phase 19: the training path
# ---------------------------------------------------------------------------

#: 19a: olmo-1b at published widths and depth, f32 parameters, bf16
#: compute, remat "full", the launcher's AdamW defaults, lcg data
TRAIN_ARCH = "olmo-1b"
TRAIN_BATCH, TRAIN_SEQ, TRAIN_MICRO, TRAIN_STEPS = 8, 64, 2, 6
TRAIN_TIMED = 4                     # the last steps, whose median is reported
#: 19b: (arch, layers) held card against CPU in f32 at published widths,
#: cut in depth only; zamba2-2.7b's 6 layers run its shared block once
TRAIN_CHECKED = (("olmo-1b", 1), ("rwkv6-3b", 2), ("zamba2-2.7b", 6))
CHECK_BATCH, CHECK_SEQ = 2, 64
TRAIN_SEED = 7
#: the loss, relative; AdamW fed the CPU's gradients on both sides, ×
#: max |p|
TRAIN_LOSS_TOL, TRAIN_OPT_TOL = 1e-5, 1e-6
#: every gradient leaf, × its max |value|: the port's f32 model bound,
#: 1e-4, where the f32 gradients of a model at published widths reproduce
#: that closely.  rwkv6-3b's do not: the CPU against itself at 2 and 3
#: intra-op threads differs by up to 1.27e-4 (layers/0/tm/bonus;
#: olmo-1b 1.56e-6, zamba2-2.7b 1.07e-5; tools/train_grad_noise.py), so
#: it is held to about 3× that spread
TRAIN_GRAD_TOL = {"olmo-1b": 1e-4, "rwkv6-3b": 4e-4, "zamba2-2.7b": 1e-4}
#: the CPU side's intra-op threads in each of its three workers (of the
#: card machine's 8 cores; the rest for phases 18 and 19's host work)
TRAIN_WORKER_THREADS = 2
#: 19c: the launcher, as the reference's ``test_train_loss_decreases``
TRAIN_LAUNCH_FLAGS = ("--smoke", "--arch", "olmo-1b", "--steps", "60",
                      "--lr", "1e-2", "--batch", "4", "--seq", "32",
                      "--ckpt-every", "20")
TRAIN_KEEP = 3                      # CheckpointManager's default
TRAIN_PHASE_S = 45.0


def _checked_cfg(arch, n_layers):
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get(arch), n_layers=n_layers,
                               dtype="float32")


def _train_opt_cfg():
    """The launcher's AdamW for a run of ``TRAIN_STEPS`` steps."""
    from repro_torch.training.optimizer import OptCfg
    return OptCfg(lr=3e-4, warmup_steps=min(50, TRAIN_STEPS // 10 + 1),
                  total_steps=TRAIN_STEPS)


def _write_trees(path, **trees) -> dict:
    """The trees' leaves written back to back to one raw file (a pickle-free
    file that the main process maps); returns where each leaf lies."""
    from repro_torch.training.tree import tree_leaves
    index, offset = {}, 0
    with open(path, "wb") as f:
        for name, tree in trees.items():
            index[name] = []
            for leaf in tree_leaves(tree):
                a = leaf.detach().contiguous().numpy()
                a.tofile(f)
                index[name].append((offset, a.shape, a.dtype.str))
                offset += a.nbytes
    return index


def _read_tree(np, torch, path, like, index):
    """``like``'s structure with the leaves of ``index`` read from the raw
    file at ``path`` (mapped, not copied)."""
    from repro_torch.training.tree import unflatten_like
    data = np.memmap(path, dtype=np.uint8, mode="c")
    leaves = [torch.from_numpy(np.ndarray(shape, dtype=np.dtype(dt),
                                          buffer=data, offset=off))
              for off, shape, dt in index]
    return unflatten_like(like, leaves)


def cpu_train_check(arch, n_layers, out_dir):
    """19b's CPU side, in a worker process: ``arch`` at published widths
    and ``n_layers`` from ``TRAIN_SEED``, its loss and gradients on the
    lcg batch of step 0, and AdamW's first step fed those gradients; the
    initial parameters, the gradients and the updated parameters written
    to a raw file in ``out_dir``; the card's remat left out.  Returns
    (path, the parameters' tree with 0 for each leaf, the leaf index,
    loss, seconds of each part).  Top-level, so that a worker process can
    run it."""
    t0 = time.perf_counter()
    import dataclasses

    import torch

    from repro_torch.data.pipeline import lcg_batch
    from repro_torch.models.transformer import build_model
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    from repro_torch.training.train import value_and_grad
    from repro_torch.training.tree import tree_map
    torch.set_num_threads(TRAIN_WORKER_THREADS)
    secs = {"import": time.perf_counter() - t0}
    t = time.perf_counter()
    # no recompute on the CPU: remat gives its gradients bit for bit
    # there (tests/test_torch_training.py)
    cfg = dataclasses.replace(_checked_cfg(arch, n_layers), remat="none")
    model = build_model(cfg, "cpu")
    params = model.init(torch.Generator().manual_seed(TRAIN_SEED))
    secs["init"], t = time.perf_counter() - t, time.perf_counter()
    tokens, labels = (torch.from_numpy(a) for a in
                      lcg_batch(0, CHECK_BATCH, CHECK_SEQ, cfg.vocab))
    loss, grads = value_and_grad(model.loss, params, tokens, labels)
    secs["grad"], t = time.perf_counter() - t, time.perf_counter()
    new, _, _ = adamw_update(_train_opt_cfg(), params, grads,
                             init_opt_state(params))
    secs["adamw"], t = time.perf_counter() - t, time.perf_counter()
    path = str(Path(out_dir) / f"{arch}.bin")
    index = _write_trees(path, params=params, grads=grads, new=new)
    secs["write"] = time.perf_counter() - t
    skeleton = tree_map(lambda _: 0, params)
    return path, skeleton, index, float(loss), secs


def _tree_ratio(torch, got, want):
    """(max over leaves of max |got − want| ÷ max |want|, its leaf's
    path); ``want`` may lie on the CPU."""
    from repro_torch.training.tree import flatten_with_paths, tree_leaves
    worst, where = 0.0, ""
    for (path, g), w in zip(flatten_with_paths(got), tree_leaves(want)):
        check(g.shape == w.shape, f"{'/'.join(path)}: {tuple(g.shape)} "
                                  f"against {tuple(w.shape)}")
        if not w.numel():
            continue
        w = w.to(g.device)
        err = (g.float() - w.float()).abs().max().item()
        scale = w.float().abs().max().item()
        ratio = err / scale if scale else (0.0 if err == 0 else float("inf"))
        if ratio > worst or not where:
            worst, where = ratio, "/".join(path)
    return worst, where


def train_full_width(torch, report):
    """19a: ``TRAIN_STEPS`` AdamW steps of olmo-1b at full width and
    depth; ms a step (median of the last ``TRAIN_TIMED``, host clock
    around a synchronised step), the device peak, loss and grad norm
    finite at every step, no kernel launched (dense, ``xla_chunked``)."""
    from repro_torch import configs
    from repro_torch.data.pipeline import make_data_iter
    from repro_torch.models.transformer import build_model
    from repro_torch.training.train import build_train_step, init_train_state
    cfg = configs.get(TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = build_model(cfg)
    state = init_train_state(model,
                             torch.Generator("cuda").manual_seed(TRAIN_SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    step = build_train_step(model, _train_opt_cfg(), microbatches=TRAIN_MICRO)
    data = make_data_iter("lcg", TRAIN_BATCH, TRAIN_SEQ, cfg.vocab)
    counters = _counters()
    for c in counters.values():
        c.launches = 0
    rows = []
    for i in range(TRAIN_STEPS):
        tokens, labels = data(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, tokens, labels)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        row = dict(ms=ms, **{k: float(v) for k, v in m.items()})
        check(all(math.isfinite(row[k]) for k in ("loss", "grad_norm")),
              f"19a: step {i} gave {row}")
        log(f"19a: step {i}: {ms:.1f} ms, loss {row['loss']:.4f}, grad norm "
            f"{row['grad_norm']:.4f}, lr {row['lr']:.3e}")
        rows.append(row)
    peak = torch.cuda.max_memory_allocated()
    launches = {n: c.launches for n, c in counters.items()}
    check(not any(launches.values()), f"19a launched kernels: {launches}")
    med = statistics.median(r["ms"] for r in rows[-TRAIN_TIMED:])
    tokens = TRAIN_BATCH * TRAIN_SEQ
    n = cfg.n_params()
    # 6 N per token (forward and backward), 8 N under full remat
    mfu = 8 * n * tokens / (med / 1e3) / BF16_FLOPS_PER_S
    log(f"19a: {TRAIN_ARCH} at {cfg.n_layers} layers ({n / 1e9:.3f} B "
        f"params, f32, bf16 compute, remat {cfg.remat}), batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches: "
        f"{med:.1f} ms a step (median of the last {TRAIN_TIMED}; all "
        f"{[round(r['ms'], 1) for r in rows]}), {tokens / med * 1e3:.0f} "
        f"tokens/s, {mfu:.4f} of the bf16 peak at 8N per token; device "
        f"peak {peak / 1e9:.2f} GB; init {init_s:.1f} s")
    report["train_full_width"] = dict(
        init_s=init_s, steps=rows, ms_per_step=med,
        tokens_per_s=tokens / med * 1e3,
        bf16_peak_share=mfu, max_memory_allocated_gb=peak / 1e9,
        n_params=n)
    del state
    torch.cuda.empty_cache()


def train_card_vs_cpu(torch, np, report, jobs):
    """19b's card side: each checked model from the CPU's initial
    parameters, its loss and gradients on the card (the scans through
    their kernels, counted) against the CPU's, and AdamW fed the CPU's
    gradients on both sides.  Returns the scan kernels' launches."""
    from repro_torch.data.pipeline import lcg_batch, place
    from repro_torch.models.transformer import build_model
    from repro_torch.training.optimizer import adamw_update, init_opt_state
    from repro_torch.training.train import value_and_grad
    from repro_torch.training.tree import tree_map
    counters = _counters()
    total = {n: 0 for n in counters}
    out = {}
    for (arch, n_layers), job in zip(TRAIN_CHECKED, jobs):
        t_wait = time.perf_counter()
        path, skeleton, index, cpu_loss, cpu_s = job.get(
            timeout=TRAIN_PHASE_S)
        t_card = time.perf_counter()
        cfg = _checked_cfg(arch, n_layers)
        model = build_model(cfg)
        cpu = {k: _read_tree(np, torch, path, skeleton, index[k])
               for k in index}
        params = tree_map(lambda t: t.to("cuda"), cpu["params"])
        tokens, labels = place(*lcg_batch(0, CHECK_BATCH, CHECK_SEQ,
                                          cfg.vocab))
        torch.cuda.synchronize()
        for c in counters.values():
            c.launches = 0
        loss, grads = value_and_grad(model.loss, params, tokens, labels)
        torch.cuda.synchronize()
        launches = {n: c.launches for n, c in counters.items()}
        # one launch a layer in the forward, one more in the remat
        # recompute; the backward is the plain chunked form's
        per_layer = 2 if cfg.remat != "none" else 1
        want = {n: 0 for n in counters}
        if cfg.family == "rwkv6":
            want["rwkv6_wkv"] = per_layer * n_layers
        elif cfg.family == "hybrid":
            want["mamba2_ssd"] = per_layer * n_layers
        check(launches == want, f"19b {arch}: launches {launches}, "
                                f"expected {want}")
        for n, k in launches.items():
            total[n] += k
        loss_rel = abs(float(loss) / cpu_loss - 1)
        grad_ratio, grad_leaf = _tree_ratio(torch, grads, cpu["grads"])
        cpu_grads = tree_map(lambda t: t.to("cuda"), cpu["grads"])
        new, _, _ = adamw_update(_train_opt_cfg(), params, cpu_grads,
                                 init_opt_state(params))
        opt_ratio, opt_leaf = _tree_ratio(torch, new, cpu["new"])
        card_s = time.perf_counter() - t_card
        log(f"19b: {arch} at {n_layers} layers: loss {float(loss):.6f} (CPU "
            f"{cpu_loss:.6f}, {loss_rel:.3e} relative); gradients "
            f"{grad_ratio:.3e} x max |leaf| at worst ({grad_leaf}); AdamW on "
            f"the CPU's gradients {opt_ratio:.3e} x max |p| ({opt_leaf}); "
            f"launches {dict((n, k) for n, k in launches.items() if k)}; "
            f"the CPU side in its worker "
            f"{ {k: round(v, 1) for k, v in cpu_s.items()} } s, waited for "
            f"{t_card - t_wait:.1f} s, the card side {card_s:.1f} s")
        check(loss_rel <= TRAIN_LOSS_TOL, f"19b {arch}: loss {loss_rel:.3e}")
        check(grad_ratio <= TRAIN_GRAD_TOL[arch],
              f"19b {arch}: gradient {grad_leaf} {grad_ratio:.3e}")
        check(opt_ratio <= TRAIN_OPT_TOL,
              f"19b {arch}: AdamW {opt_leaf} {opt_ratio:.3e}")
        out[arch] = dict(n_layers=n_layers, loss=float(loss),
                         cpu_loss=cpu_loss, loss_rel=loss_rel,
                         grad_ratio=grad_ratio, grad_leaf=grad_leaf,
                         opt_ratio=opt_ratio, opt_leaf=opt_leaf,
                         launches=launches, cpu_s=cpu_s, card_s=card_s)
        del cpu, params, grads, cpu_grads, new
        Path(path).unlink()
        torch.cuda.empty_cache()
    report["train_card_vs_cpu"] = out
    return total


def train_launcher_line(stdout: str) -> tuple[float, float]:
    """(first loss, final loss) of the launcher's line, checked against
    the reference's format."""
    import re
    lines = stdout.strip().splitlines()
    m = re.fullmatch(r"(\d+) steps in \d+s; loss (-?[\d.]+) → "
                     r"(-?[\d.]+); restarts=(\d+)", lines[-1] if lines else "")
    check(m is not None and int(m[1]) == int(TRAIN_LAUNCH_FLAGS[4])
          and m[4] == "0", f"19c: the launcher printed {lines}")
    return float(m[2]), float(m[3])


@contextlib.contextmanager
def train_checks():
    """19b's CPU side, started before phase 18 and run beside it: a
    scratch directory under ``build/`` and a worker process per checked
    model, each running :func:`cpu_train_check` at once.  Yields (the
    directory, the jobs)."""
    import multiprocessing
    import tempfile
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp, \
            multiprocessing.get_context("spawn").Pool(
                len(TRAIN_CHECKED)) as pool:
        yield tmp, [pool.apply_async(cpu_train_check, (arch, n, tmp))
                    for arch, n in TRAIN_CHECKED]


def training(torch, np, report, tmp, jobs):
    """Phase 19: the training path (19a full width; 19b card against CPU,
    the CPU side from ``jobs``; 19c the launcher in a subprocess, started
    first and run beside 19a and 19b).  Returns the scan kernels'
    launches."""
    import os
    t_phase = time.perf_counter()
    ckpt = Path(tmp) / "ckpt"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    launcher = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train",
         *TRAIN_LAUNCH_FLAGS, "--ckpt-dir", str(ckpt)], env=env,
        cwd=str(ROOT), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        train_full_width(torch, report)
        launches = train_card_vs_cpu(torch, np, report, jobs)
        stdout, stderr = launcher.communicate(timeout=TRAIN_PHASE_S)
    finally:
        if launcher.poll() is None:
            launcher.kill()
            launcher.communicate()
    launch_s = time.perf_counter() - t_phase
    check(launcher.returncode == 0,
          f"19c: the launcher exited {launcher.returncode}: "
          f"{stderr[-2000:]}")
    first, last = train_launcher_line(stdout)
    dirs = sorted(os.listdir(ckpt))
    log(f"19c: the launcher (subprocess on the card, done {launch_s:.1f} s "
        f"into the phase) printed {stdout.strip().splitlines()[-1]!r}; "
        f"checkpoints {dirs}")
    check(last <= first - 0.5, f"19c: the loss fell from {first} to {last}, "
                               f"less than 0.5")
    check(0 < len(dirs) <= TRAIN_KEEP and all(d.isdigit() for d in dirs)
          and dirs[-1] == TRAIN_LAUNCH_FLAGS[4],
          f"19c: checkpoint directories {dirs}")
    report["train_launcher"] = dict(line=stdout.strip().splitlines()[-1],
                                    done_s=launch_s, checkpoints=dirs)
    phase_s = time.perf_counter() - t_phase
    log(f"phase 19: {phase_s:.1f} s")
    report["train_phase_s"] = phase_s
    check(phase_s <= TRAIN_PHASE_S, f"phase 19 took {phase_s:.1f} s (limit "
                                    f"{TRAIN_PHASE_S:.0f} s)")
    return launches


# -- the numpy oracle against the card (phase 20) --

#: depth of the runs launched for the oracle (20a and the platform)
ORACLE_N = 1_000
#: the oracle's worker processes (numpy on the host, one run a job)
ORACLE_WORKERS = 2
#: 20d: phase 17's E/LL/PS stream at this chunk
ORACLE_CHUNK = 80
ORACLE_PHASE_S = 20.0


def _oracle_worker():
    """An oracle worker's imports, made before its first job."""
    import repro_torch.core.sim_ref  # noqa: F401


def oracle_pool():
    """Phase 20's worker processes for the numpy oracle."""
    import multiprocessing
    return multiprocessing.get_context("spawn").Pool(
        ORACLE_WORKERS, initializer=_oracle_worker)


def oracle_run(policy, cluster, wb, telemetry=None, timeline=None,
               chunk=None):
    """The numpy oracle on each replication of a workload batch: (its
    results, with ``chunk`` each with its per-chunk telemetry snapshots,
    s).  Top-level, so that a worker process can run it."""
    from repro_torch.core.sim_ref import simulate_ref, simulate_ref_chunks
    t0 = time.perf_counter()
    if chunk:
        runs = [simulate_ref_chunks(policy, cluster, wb.rep(r),
                                    chunk_size=chunk, telemetry=telemetry)
                for r in range(wb.n_reps)]
    else:
        runs = [simulate_ref(policy, cluster, wb.rep(r),
                             telemetry=telemetry, timeline=timeline)
                for r in range(wb.n_reps)]
    return runs, time.perf_counter() - t0


class Oracle:
    """Phase 20's runs: each card run to hold, with its inputs, beside the
    oracle's run of the same inputs, sent to ``pool`` when it is held (so
    that the oracle runs beside the later phases).  ``card`` is the card's
    output (filled in later for the runs phase 20 launches itself) and
    ``launches`` the (``sim_engine``, ``hermes_select``) launches that made
    it."""

    def __init__(self, pool):
        self.pool, self.runs = pool, {}

    def hold(self, lane, key, policy, cluster, wb, card=None,
             launches=(0, 0), telemetry=None, timeline=None, chunk=None,
             segments=None):
        job = self.pool.apply_async(
            oracle_run, (policy, cluster, wb, telemetry, timeline, chunk))
        self.runs[lane, key] = dict(
            policy=policy, cluster=cluster, wb=wb, card=card,
            launches=launches, telemetry=telemetry, timeline=timeline,
            segments=segments, job=job)

    def lane(self, lane):
        return [(key, run) for (ln, key), run in self.runs.items()
                if ln == lane]

    def hold_launched_here(self):
        """The inputs of the runs phase 20 launches itself, held at once:
        (a) the nine balancers on the paper's small cluster; the platform
        under a budgeted lifecycle and under an autoscaled fleet."""
        from repro_torch.core import (HERMES, PAPER_SMALL, PAPER_TESTBED,
                                      WORKLOADS, FleetCfg, LifecycleCfg,
                                      ms_trace, parse_policy,
                                      replicate_workload, stack_workloads)
        from repro_torch.policy import balancer_names
        from repro_torch.telemetry import TelemetryCfg
        wb = replicate_workload(ms_trace, PAPER_SMALL, LOADS, ORACLE_N,
                                seeds=(SEED,))
        for b in balancer_names():
            self.hold("20a", f"E/{b}/PS", parse_policy(f"E/{b}/PS"),
                      PAPER_SMALL, wb)
        budget = PAPER_TESTBED._replace(lifecycle=LifecycleCfg(
            "FIXED_TTL", LIFE_TTL_S, LIFE_MAX_IDLE, LIFE_PRESET))
        auto = PAPER_TESTBED._replace(fleet=FleetCfg(
            preset="two-gen", autoscale="TARGET_P99",
            target_p99=FIG13_TARGET, min_workers=2, cooldown_s=2.0))
        for key, cl, name, load in (
                ("FIXED_TTL budget", budget, "azure-cold-heavy", 0.85),
                ("two-gen TARGET_P99", auto, "azure-diurnal", 0.85)):
            wl = WORKLOADS[name](PAPER_TESTBED, load, ORACLE_N, seed=SEED)
            self.hold("20b platform", key, HERMES, cl,
                      stack_workloads([wl]), telemetry=TelemetryCfg())


def platform_run(policy, cluster, wl, telemetry):
    """``ServingCluster`` on the card with no platform overheads (the
    cluster's cold cost, no controller latency), which makes it the
    oracle's event loop: (result, wall s)."""
    from repro_torch.serving.engine import ServeCfg, ServingCluster
    sc = ServingCluster(ServeCfg(cluster=cluster,
                                 cold_start_s=cluster.cold_start_penalty,
                                 ctrl_latency_s=0.0), policy,
                        telemetry=telemetry, device="cuda")
    t0 = time.perf_counter()
    out = sc.run(wl)
    return out, time.perf_counter() - t0


def stream_gaps(np, out, r, ref, snaps, segments, what) -> dict:
    """A fused stream's replication ``r`` held to the oracle: the kernel's
    telemetry carry after each chunk to ``simulate_ref_chunks``' snapshot,
    then the stream's per-arrival planes, telemetry, times and exact
    counters to the oracle's run."""
    from repro_torch.core.sim_ref import (PLANE_TOL, RESPONSE_ATOL,
                                          TIME_RTOL, OracleMismatch,
                                          telemetry_gap)
    from repro_torch.telemetry import warmup_cutoff
    check(len(segments) == len(snaps),
          f"{what}: {len(segments)} chunks, the oracle {len(snaps)}")
    gaps = {"telemetry": 0.0}
    for c, (carry, snap) in enumerate(zip(segments, snaps)):
        tel = {k[4:]: v[r].numpy() for k, v in carry.items()
               if k.startswith("tel_")}
        gaps["telemetry"] = max(gaps["telemetry"], telemetry_gap(
            tel, snap, f"{what} after chunk {c}"))
    for name in ("worker", "cold", "rejected"):
        check(np.array_equal(getattr(out, name)[r], getattr(ref, name)),
              f"{what}: {name} differs from the oracle")
    gaps["telemetry"] = max(gaps["telemetry"], telemetry_gap(
        out.telemetry.rep(r), ref.telemetry, what))
    cut = warmup_cutoff(len(ref.response), out.telemetry.cfg)
    obs = ~ref.rejected[cut:]
    check(int(out.n_observed[r]) == int(obs.sum())
          and int(out.n_done[r]) == int((~ref.rejected).sum()),
          f"{what}: completion counts differ from the oracle")
    gaps["response"] = abs(float(out.resp_mean[r])
                           - float(ref.response[cut:][obs].mean()))
    gaps["end_time"] = abs(float(out.end_time[r]) - ref.end_time)
    gaps["times"] = max(abs(float(getattr(out, k)[r]) - getattr(ref, k))
                        / max(1.0, abs(getattr(ref, k)))
                        for k in ("server_time", "core_time"))
    gaps["prov_core_s"] = abs(float(out.prov_core_s[r]) - ref.prov_core_s) \
        / max(1.0, ref.prov_core_s)
    if max(gaps["response"], gaps["end_time"]) > RESPONSE_ATOL or \
            gaps["times"] > TIME_RTOL or gaps["prov_core_s"] > PLANE_TOL:
        raise OracleMismatch(f"{what}: beyond the oracle's tolerances "
                             f"({gaps})")
    return gaps


def numpy_oracle(torch, np, report, oracle):
    """Phase 20: the card's runs against the numpy oracle, lane by lane
    (see the module docstring).  Launches 20a's nine fused runs and the
    platform's two runs here, collects the oracle's runs from its worker
    processes and holds every replication.  Returns the (``sim_engine``,
    ``hermes_select``) launches made here."""
    import multiprocessing

    from repro_torch.core.sim_ref import (PLANE_TOL, RESPONSE_ATOL,
                                          TIME_RTOL, OracleMismatch,
                                          oracle_gaps)
    from repro_torch.kernels.hermes_select import kernel as hk
    from repro_torch.kernels.sim_engine import kernel as ek

    # the reference's oracle tolerances, printed beside each lane's gaps
    bounds = dict(response=RESPONSE_ATOL, end_time=RESPONSE_ATOL,
                  times=TIME_RTOL, prov_core_s=PLANE_TOL,
                  telemetry=PLANE_TOL, timeline=PLANE_TOL)
    t_phase = time.perf_counter()
    launched = [0, 0]
    # (a) the nine balancers, fused, one sim_engine launch each
    for key, run in oracle.lane("20a"):
        run["card"] = fused_run(torch, np, run["policy"], run["cluster"],
                                run["wb"], f"20a {key}")[0]
        run["launches"] = (1, 0)
        launched[0] += 1
    # (b) the platform on the card, one hermes_select launch an arrival
    for key, run in oracle.lane("20b platform"):
        wl = run["wb"].rep(0)
        torch.cuda.synchronize()
        ek.sim_engine.launches = 0
        hk.hermes_select_batch.launches = 0
        run["card"], wall = platform_run(run["policy"], run["cluster"], wl,
                                         run["telemetry"])
        counts = (ek.sim_engine.launches, hk.hermes_select_batch.launches)
        check(counts == (0, wl.n), f"20b platform {key}: sim_engine and "
                                   f"hermes_select launched {counts}, "
                                   f"expected (0, {wl.n})")
        run["launches"] = counts
        launched[1] += counts[1]
        log(f"20b platform {key}: ServingCluster on the card, {wall:.2f} s "
            f"({wall / wl.n * 1e6:.1f} us per arrival), {counts[1]} "
            f"hermes_select launches")
    card_s = time.perf_counter() - t_phase

    # every held run against the oracle's run of its inputs
    t_wait = time.perf_counter()
    lanes, oracle_s = {}, 0.0
    for (lane, key), run in oracle.runs.items():
        try:
            refs, s = run["job"].get(timeout=ORACLE_PHASE_S)
        except multiprocessing.TimeoutError:
            raise SmokeFailure(f"{lane} {key}: the oracle's run did not "
                               f"end within {ORACLE_PHASE_S:.0f} s") from None
        oracle_s += s
        row = lanes.setdefault(lane, dict(
            card_runs=0, replications=0, sim_engine_launches=0,
            hermes_select_launches=0, gaps={}))
        row["card_runs"] += 1
        row["sim_engine_launches"] += run["launches"][0]
        row["hermes_select_launches"] += run["launches"][1]
        out = run["card"]
        for r, ref in enumerate(refs):
            what = f"{lane} {key} rep {r}"
            try:
                if run["segments"] is not None:
                    ref, snaps = ref
                    gaps = stream_gaps(np, out, r, ref, snaps,
                                       run["segments"], what)
                else:
                    # a BatchSimOutput's replication, or the platform's
                    # one run
                    one = out.rep(r) if hasattr(out, "rep") else out
                    gaps = oracle_gaps(one, ref, what)
            except OracleMismatch as e:
                raise SmokeFailure(str(e)) from None
            row["replications"] += 1
            for k, g in gaps.items():
                row["gaps"][k] = max(row["gaps"].get(k, 0.0), g)
    wait_s = time.perf_counter() - t_wait
    for lane, row in lanes.items():
        log(f"{lane}: {row['replications']} replications of "
            f"{row['card_runs']} card runs ({row['sim_engine_launches']} "
            f"sim_engine, {row['hermes_select_launches']} hermes_select "
            f"launches) == the oracle in worker, cold, rejected and every "
            f"integer plane; largest gaps " + ", ".join(
                f"{k} {g!r} (bound {bounds[k]:g})"
                for k, g in row["gaps"].items()))
    phase_s = time.perf_counter() - t_phase
    log(f"phase 20: the card's runs in {card_s:.2f} s, the oracle's "
        f"{oracle_s:.1f} s of work in {ORACLE_WORKERS} worker processes "
        f"beside the earlier phases, {wait_s:.2f} s to collect and hold "
        f"them; {launched[0]} sim_engine and {launched[1]} hermes_select "
        f"launches here; {phase_s:.1f} s")
    report["oracle"] = dict(lanes=lanes, bounds=bounds,
                            card_s=card_s, oracle_cpu_s=oracle_s,
                            collect_s=wait_s,
                            sim_engine_launches=launched[0],
                            hermes_select_launches=launched[1],
                            phase_s=phase_s)
    check(phase_s <= ORACLE_PHASE_S, f"phase 20 took {phase_s:.1f} s "
                                     f"(limit {ORACLE_PHASE_S:.0f} s)")
    return launched


# -- sharded execution on two ranks of the card (phase 21) --

#: phase 21's process group: two rank processes on the one card over
#: gloo (NCCL refuses two ranks on one device); gloo stages CUDA tensors
#: through the host, every product runs on the card
SHARD_WORLD = 2
SHARD_SEED = 11
SHARD_LAYERS = 2
#: 21a: AdamW steps (the launcher's optimizer, phase 19's) and
#: tests/test_distributed.py:25-67's bounds (the loss; every parameter as
#: allclose(rtol=atol))
SHARD_STEPS = 2
SHARD_LOSS_TOL = 2e-3
SHARD_PARAM_TOL = 1e-3
#: 21b: a request of phase 7's prompt length and 32 decode steps, phase
#: 7's dtype and phase 8's bound
SHARD_PROMPT, SHARD_DECODE = CHECK_PROMPT, 32
#: 21c: gemma-2b's prompt, decode steps, cache length and
#: tests/test_distributed.py:172-202's bound
SEQ_PROMPT, SEQ_STEPS, SEQ_LEN = 511, 4, 1024
SEQ_TOL = 1e-3
#: 21d: dbrx-132b's MoE layer: tokens, the raised capacity factor (the
#: reference test's) and tests/test_distributed.py:70-95's bounds
MOE_EP_TOKENS = (2, 256)
MOE_EP_CF = 16.0
MOE_EP_TOL = 2e-2
MOE_AUX_TOL = 1e-3
#: 21e: compressed steps and the bound on the first update
POD_STEPS = 3
POD_TOL = 1e-6
SHARD_PHASE_S = 30.0
#: phase 22: the recurrent families at published widths, depth cut (the
#: hybrid to 6 layers, so that its shared block runs once, as in 19b);
#: phase 9's served prompt, 8 decode steps, f32 and phase 8's model bound,
#: 21c's state bound; 22c: tests/test_distributed.py:25-67's loss bound
#: and phase 19b's gradient bound scaled to each leaf
RECURRENT_SHARDED = (("22a", "rwkv6-3b", 2), ("22b", "zamba2-2.7b", 6))
REC_PROMPT, REC_STEPS = CHECK_PROMPT, 8
REC_STATE_TOL = SEQ_TOL
REC_LOSS_TOL = SHARD_LOSS_TOL
REC_GRAD_TOL = 1e-3
REC_PHASE_S = 15.0
#: phase 23: one dbrx-132b MoE layer's gradients at published widths, f32,
#: 21d's capacity factor; 22c's bounds
MOE_GRAD_TOKENS = (1, 256)
MOE_GRAD_TOL = REC_GRAD_TOL
MOE_GRAD_PHASE_S = 10.0


def shard_rank(rank, port, conn, dev="cuda", cfg_of=None):
    """One rank of phases 21-23, in a spawned process: joins the gloo
    group, imports the port, makes the (data 1 x model 2) mesh and probes
    gloo on it (:func:`_probe_gloo`), says it is ready, and runs
    :func:`sharded_checks` when the main process says go, then
    :func:`recurrent_checks` and :func:`moe_grad_checks` at the next two
    (``"stop"`` ends it).  Between ready and the first go it builds phase
    22's weights (:func:`recurrent_weights`), beside the main process's
    phases 18-20; they are dropped after phase 22.  Top-level, so that
    spawn can run it."""
    import datetime
    import traceback
    t0 = time.perf_counter()
    dist = None
    try:
        import numpy as np
        import torch
        import torch.distributed as dist
        sys.path.insert(0, str(ROOT / "src"))
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev == "cuda":
            torch.cuda.set_device(0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}",
            world_size=SHARD_WORLD, rank=rank,
            timeout=datetime.timedelta(seconds=4 * SHARD_PHASE_S))
        from repro_torch.distribution import sharding as sh
        from repro_torch.launch.mesh import make_test_mesh
        mesh = make_test_mesh((1, SHARD_WORLD), ("data", "model"),
                              device_type=dev)
        _probe_gloo(torch, dist, sh, mesh, rank, dev)
        conn.send(("ready", time.perf_counter() - t0))
        cfg_of = cfg_of or _published
        steps = [(sharded_checks, {}),
                 (recurrent_checks, dict(weights=recurrent_weights(
                     torch, cfg_of, dev))),
                 (moe_grad_checks, {})]
        for checks, kw in steps:
            if conn.recv() != "go":
                return
            done = checks(torch, np, rank, conn, dev, cfg_of, mesh, **kw)
            kw.clear()
            conn.send(("done", done))
    except BaseException:                                # noqa: BLE001
        conn.send(("error", traceback.format_exc()))
    finally:
        if dist is not None and dist.is_initialized():
            dist.destroy_process_group()


def _published(name, **kw):
    import dataclasses

    from repro_torch import configs
    return dataclasses.replace(configs.get(name), **kw)


def _allclose_excess(torch, got, want, tol):
    """max(|got − want| − tol·|want|): allclose(rtol=atol=tol) holds when
    it is at most tol."""
    return float(((got.float() - want.float()).abs()
                  - tol * want.float().abs()).max()) if want.numel() \
        else -math.inf


def _leaf_ratio(got, want, scale) -> float:
    """max |got − want| over ``scale``, the whole leaf's max |value| (an
    all-zero leaf holds only an all-zero ``got``)."""
    gap = float((got - want).abs().max()) if want.numel() else 0.0
    return gap / scale if scale else (0.0 if gap == 0 else math.inf)


def _probe_gloo(torch, dist, sh, mesh, rank, dev):
    """What the steps need of gloo on this device's tensors, each named
    if it fails: the three collectives DTensor and the manual regions
    use, and a DTensor tensor-parallel product with its backward."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    def named(what, fn):
        try:
            fn()
        except Exception as e:                          # noqa: BLE001
            raise RuntimeError(f"gloo on {dev} tensors: {what} failed: "
                               f"{e}") from e

    x = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank

    def all_gather():
        out = torch.empty(16, device=dev)
        dist.all_gather_into_tensor(out, x)
        assert out.tolist() == [float(i + 10 * r) for r in (0, 1)
                                for i in range(8)], out

    def reduce_scatter():
        out = torch.empty(4, device=dev)
        dist.reduce_scatter_tensor(out, x)
        assert out.tolist() == [float(2 * i + 10 + 8 * rank)
                                for i in range(4)], out

    def all_to_all():
        out = torch.empty(8, device=dev)
        dist.all_to_all_single(out, x)
        assert out.tolist() == [float(i + 4 * rank + 10 * r)
                                for r in (0, 1) for i in range(4)], out

    def tp_product():
        g = torch.Generator(dev).manual_seed(0)
        a = torch.randn(64, 128, generator=g, device=dev)
        w1 = torch.randn(128, 256, generator=g, device=dev)
        w2 = torch.randn(256, 128, generator=g, device=dev)
        ws = [distribute_tensor(w, mesh, [Replicate(), Shard(d)],
                                src_data_rank=None).requires_grad_()
              for w, d in ((w1, 1), (w2, 0))]
        with sh.plain_as_replicated():
            y = torch.relu(a @ ws[0]) @ ws[1]
            g1, g2 = torch.autograd.grad((y * y).mean(), ws)
        wr = [w.clone().requires_grad_() for w in (w1, w2)]
        yr = torch.relu(a @ wr[0]) @ wr[1]
        r1, r2 = torch.autograd.grad((yr * yr).mean(), wr)
        gap = max(float((y.full_tensor() - yr).abs().max() / yr.abs().max()),
                  float((g1.full_tensor() - r1).abs().max() / r1.abs().max()),
                  float((g2.full_tensor() - r2).abs().max() / r2.abs().max()))
        assert gap <= 1e-5, gap

    for what, fn in (("all_gather_into_tensor", all_gather),
                     ("reduce_scatter_tensor", reduce_scatter),
                     ("all_to_all_single", all_to_all),
                     ("a DTensor tensor-parallel product and its backward",
                      tp_product)):
        named(what, fn)


def _rank_helpers(torch, conn, dev, secs):
    """A rank's ``stage(name)`` (tells the main process, and times the
    stage before it into ``secs``), ``sync()``, ``free()`` and ``gen(seed)``
    (a generator on ``dev``)."""
    t_stage = [time.perf_counter(), None]

    def stage(name):
        if t_stage[1]:
            secs[t_stage[1]] = time.perf_counter() - t_stage[0]
        t_stage[:] = [time.perf_counter(), name]
        conn.send(("stage", name))

    def sync():
        if dev == "cuda":
            torch.cuda.synchronize()

    def free():
        if dev == "cuda":
            torch.cuda.empty_cache()

    def gen(seed=SHARD_SEED):
        return torch.Generator(dev).manual_seed(seed)
    return stage, sync, free, gen


def sharded_checks(torch, np, rank, conn, dev, cfg_of, mesh):
    """Phase 21 on this rank: 21a-e, each sharded run beside rank 0's
    one-device run of the same code from the same weights.  Returns this
    rank's numbers (rank 0's hold the gaps)."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.data.pipeline import lcg_batch, place
    from repro_torch.distribution import sharding as sh
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.launch.mesh import make_ctx, make_test_mesh
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import build_model
    from repro_torch.training.compression import init_error_feedback
    from repro_torch.training.optimizer import (OptCfg, adamw_update,
                                                init_opt_state)
    from repro_torch.training.train import (TrainState, _inner,
                                            build_train_step,
                                            build_train_step_compressed,
                                            shard_train_state, value_and_grad)
    from repro_torch.training.tree import tree_leaves, unflatten_like
    out, secs = {}, {}
    stage, sync, free, gen = _rank_helpers(torch, conn, dev, secs)

    # 21a: the sharded train step
    stage("21a")
    cfg = cfg_of("olmo-1b", n_layers=SHARD_LAYERS, dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(gen())
    tokens, labels = place(*lcg_batch(0, CHECK_BATCH, CHECK_SEQ, cfg.vocab),
                           device=dev)
    ocfg = _train_opt_cfg()
    ctx = make_ctx(mesh, cfg)
    with sh.sharding_ctx(ctx):
        state = shard_train_state(
            TrainState(params, init_opt_state(params), None), model, ctx)
        placed = sorted({str(p.placements) for p in
                         tree_leaves(state.params)})
        step = build_train_step(model, ocfg)
        losses = []
        sh.ROUTED_CALLS.clear()
        for _ in range(SHARD_STEPS):
            state, m = step(state, tokens, labels)
            losses.append(float(m["loss"]))
        out["collectives_a_step"] = {k: v / SHARD_STEPS for k, v in
                                     sh.ROUTED_CALLS.items()}
    got = [sh.full(p) for p in tree_leaves(state.params)]
    del state
    if rank == 0:
        s = TrainState(params, init_opt_state(params), None)
        step = build_train_step(model, ocfg)
        want = []
        for _ in range(SHARD_STEPS):
            s, m = step(s, tokens, labels)
            want.append(float(m["loss"]))
        excess = [_allclose_excess(torch, a, b, SHARD_PARAM_TOL)
                  for a, b in zip(got, tree_leaves(s.params))]
        gap = max(float((a - b).abs().max()) for a, b in
                  zip(got, tree_leaves(s.params)) if b.numel())
        # where the worst parameter is: its leaf and its first-step
        # gradient on one device beside AdamW's eps
        leaf = max(range(len(excess)), key=excess.__getitem__)
        a, b = got[leaf], tree_leaves(s.params)[leaf]
        at = int(((a - b).abs() - SHARD_PARAM_TOL * b.abs()).argmax())
        _, g0 = value_and_grad(model.loss, params, tokens, labels)
        g_at = float(tree_leaves(g0)[leaf].flatten()[at])
        g_max = float(tree_leaves(g0)[leaf].abs().max())
        del g0
        out["21a"] = dict(losses=losses, one_device=want,
                          loss_gap=max(abs(a - b) for a, b in
                                       zip(losses, want)),
                          param_gap=gap, param_excess=max(excess),
                          worst=dict(leaf=leaf, index=at, grad=g_at,
                                     leaf_max_grad=g_max),
                          placements=placed, lr=ocfg.lr)
        del s
    del params, got
    free()

    # 21b: sharded prefill and decode under pallas, the kernels on each
    # rank's local heads
    stage("21b")
    cfg = cfg_of("olmo-1b", n_layers=SHARD_LAYERS, attn_impl="pallas")
    model = build_model(cfg, dev)
    params = model.init(gen())
    n = SHARD_PROMPT + SHARD_DECODE
    toks = torch.as_tensor(np.random.default_rng(SHARD_SEED).integers(
        0, cfg.vocab, (1, n)), device=dev)

    def serve(pp, cache):
        lg, cache = model.prefill(pp, toks[:, :SHARD_PROMPT], cache)
        outs = [sh.full(lg)]
        for i in range(SHARD_PROMPT, n):
            lg, cache = model.decode_step(
                pp, toks[:, i:i + 1], cache,
                torch.full((1,), i, dtype=torch.int32, device=dev))
            outs.append(sh.full(lg))
        return torch.cat(outs, dim=1).float()

    heads = {"flash_attention": [], "decode_attention": []}
    fa0, da0 = fa_ops.flash_attention, da_ops.decode_attention

    def fa(q, k, v, **kw):
        heads["flash_attention"].append(q.shape[2])
        return fa0(q, k, v, **kw)

    def da(q, k, v, pos, **kw):
        heads["decode_attention"].append(q.shape[1])
        return da0(q, k, v, pos, **kw)

    ctx = make_ctx(mesh, cfg)
    counters = _counters()
    with sh.sharding_ctx(ctx):
        pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
        cache = sh.param_sharding_tree(model.init_cache(1, MAX_LEN),
                                       model.cache_specs(1, MAX_LEN), mesh)
        fa_ops.flash_attention, da_ops.decode_attention = fa, da
        try:
            sync()
            for c in counters.values():
                c.launches = 0
            sh.ROUTED_CALLS.clear()
            got = serve(pd, cache)
            sync()
            launches = {k: counters[k].launches for k in heads}
            out["collectives_21b"] = dict(sh.ROUTED_CALLS)
        finally:
            fa_ops.flash_attention, da_ops.decode_attention = fa0, da0
    out["launches"] = launches
    out["local_heads"] = {k: sorted(set(v)) for k, v in heads.items()}
    del pd, cache
    if rank == 0:
        want = serve(params, model.init_cache(1, MAX_LEN))
        out["21b"] = dict(max_abs_err=float((got - want).abs().max()),
                          max_abs_logit=float(want.abs().max()),
                          finite=bool(got.isfinite().all()),
                          shape=list(got.shape), vocab=cfg.vocab,
                          local_heads=cfg.n_heads // SHARD_WORLD)
    del params, got
    free()

    # 21c: the seq-sharded flash-decode over gemma-2b's cache
    stage("21c")
    cfg = cfg_of("gemma-2b", n_layers=SHARD_LAYERS, dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(gen())
    toks = torch.as_tensor(np.random.default_rng(SHARD_SEED + 1).integers(
        0, cfg.vocab, (1, SEQ_PROMPT + SEQ_STEPS)), device=dev)
    cache = model.init_cache(1, SEQ_LEN)
    model.prefill(params, toks[:, :SEQ_PROMPT], cache)
    cache_1 = {k: v.clone() for k, v in cache.items()}

    def decode(pp, cache):
        outs = []
        for i in range(SEQ_PROMPT, SEQ_PROMPT + SEQ_STEPS):
            lg, cache = model.decode_step(
                pp, toks[:, i:i + 1], cache,
                torch.full((1,), i, dtype=torch.int32, device=dev))
            outs.append(sh.full(lg))
        return torch.cat(outs, dim=1)

    ctx = make_ctx(mesh, cfg)
    with sh.sharding_ctx(ctx):
        cspec = model.cache_specs(1, SEQ_LEN)
        pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
        got = decode(pd, sh.param_sharding_tree(cache, cspec, mesh))
    out["21c_cache_spec"] = repr(cspec["k"])
    out["21c_seq_sharded"] = cspec["k"][2] is not None
    if rank == 0:
        want = decode(params, cache_1)
        out["21c"] = dict(
            max_abs_err=float((got - want).abs().max()),
            excess=_allclose_excess(torch, got, want, SEQ_TOL),
            max_abs_logit=float(want.abs().max()))
    del params, pd, cache, cache_1, got
    free()

    # 21d: moe_ep against moe_dense, one dbrx-132b MoE layer
    stage("21d")
    pub = cfg_of("dbrx-132b")
    cfg = dataclasses.replace(pub, moe=dataclasses.replace(
        pub.moe, capacity_factor=MOE_EP_CF))
    p = moe_mod.init_moe(gen(), cfg)
    B, S = MOE_EP_TOKENS
    x = torch.randn((B, S, cfg.d_model), generator=gen(SHARD_SEED + 2),
                    device=dev).to(cfg.act_dtype)
    ctx = make_ctx(mesh, cfg)
    x_spec = sh.Spec(ctx.rules["batch"], ctx.tp_axis, None)
    with sh.sharding_ctx(ctx):
        specs = build_model(cfg, "meta").param_specs()["layers"][0]["mlp"]
        pd = sh.param_sharding_tree(p, specs, mesh)
        with sh.plain_as_replicated():
            y, aux = moe_mod.moe_ep(cfg, pd, x)
        xl = sh.to_local_as(x, x_spec)
        T_l = xl.shape[0] * xl.shape[1]
        _, idx_l, _ = moe_mod._router(cfg, p, xl.reshape(T_l, cfg.d_model))
        idx = sh.full(sh.from_local_as(
            idx_l.reshape(*xl.shape[:2], -1), x_spec))
    y, aux = sh.full(y).float(), float(sh.full(aux))
    counts = torch.bincount(idx_l.flatten(), minlength=cfg.moe.n_experts)
    out["21d_drops"] = {
        "published": int((counts - moe_mod._capacity(T_l, pub)).clamp_min(0)
                          .sum()),
        "raised": int((counts - moe_mod._capacity(T_l, cfg)).clamp_min(0)
                      .sum()),
        "capacity_published": moe_mod._capacity(T_l, pub),
        "capacity_raised": moe_mod._capacity(T_l, cfg), "tokens": T_l}
    del pd
    if rank == 0:
        y_d, aux_d = moe_mod.moe_dense(cfg, p, x)
        _, idx_d, _ = moe_mod._router(cfg, p, x.reshape(B * S, cfg.d_model))
        same = (idx.reshape(B * S, -1).sort(-1).values
                == idx_d.sort(-1).values).all(-1)
        y_d = y_d.float().reshape(B * S, -1)
        ok = y.reshape(B * S, -1)[same]
        flips = (~same).nonzero().flatten().tolist()
        out["21d"] = dict(
            tokens=B * S, flips=len(flips), first_flip=flips[:1],
            max_abs_err=float((ok - y_d[same]).abs().max()),
            excess=_allclose_excess(torch, ok, y_d[same], MOE_EP_TOL),
            aux=aux, aux_dense=float(aux_d), aux_gap=abs(aux - float(aux_d)))
        del y_d
    del p, x, y
    free()

    # 21e: the compressed cross-pod step, a pod a rank
    stage("21e")
    cfg = cfg_of("olmo-1b", n_layers=SHARD_LAYERS, dtype="float32")
    model = build_model(cfg, dev)
    params = model.init(gen())
    pmesh = make_test_mesh((SHARD_WORLD, 1, 1), ("pod", "data", "model"),
                           device_type=dev)
    ctx = make_ctx(pmesh, cfg)
    ocfg = OptCfg(lr=5e-3, warmup_steps=2, total_steps=20)
    tokens, labels = place(*lcg_batch(0, CHECK_BATCH, CHECK_SEQ, cfg.vocab),
                           device=dev)
    b = CHECK_BATCH // SHARD_WORLD
    pod = pmesh.get_local_rank("pod")
    with sh.sharding_ctx(ctx):
        sc = shard_train_state(TrainState(params, init_opt_state(params),
                                          init_error_feedback(params)),
                               model, ctx)
        step = build_train_step_compressed(model, ocfg)
        with sh.sharding_ctx(_inner(ctx)), sh.plain_as_replicated():
            _, g = value_and_grad(model.loss, sc.params,
                                  tokens[pod * b:(pod + 1) * b],
                                  labels[pod * b:(pod + 1) * b])
        g = [sh.full(t) for t in tree_leaves(g)]
        losses = []
        for i in range(POD_STEPS):
            sc, m = step(sc, tokens, labels)
            losses.append(float(m["loss"]))
            if i == 0:
                after = [sh.full(t).clone() for t in tree_leaves(sc.params)]
    del sc
    # the int8 error-feedback sync of the two pods' gradients, here
    synced = []
    for t in g:
        if not t.numel():
            synced.append(t)
            continue
        both = torch.empty(SHARD_WORLD * t.numel(), device=dev)
        dist.all_gather_into_tensor(both, t.reshape(-1))
        both = both.view(SHARD_WORLD, -1)
        scale = torch.clamp(both.abs().amax(1), min=1e-12) / 127.0
        scale = scale.max()
        q = torch.clamp(torch.round(both / scale), -127, 127).to(torch.int32)
        synced.append((q.sum(0).float() * scale / SHARD_WORLD).view(t.shape))
    want, _, _ = adamw_update(ocfg, params, unflatten_like(params, synced),
                              init_opt_state(params))
    gap = max(float((a - w).abs().max() / w.abs().max())
              for a, w in zip(after, tree_leaves(want)) if w.numel())
    out["21e"] = dict(losses=losses, update_gap=gap)
    del params, g, after, want, synced
    free()
    stage("end")
    out["secs"] = secs
    return out


def recurrent_weights(torch, cfg_of, dev):
    """Phase 22's configs and weights, built on ``dev`` from the seed
    before the go, beside the main process's phases: ``{arch: (cfg,
    params)}``.  On the card they come from the card's generator: with
    these weights the f32 floor of 22c's rwkv6-3b gradients lies well
    below REC_GRAD_TOL (``tools/recurrent_grad_floor.py``)."""
    from repro_torch.models.transformer import build_model
    built = {}
    for _, arch, n_layers in RECURRENT_SHARDED:
        cfg = cfg_of(arch, n_layers=n_layers, dtype="float32",
                     attn_impl="pallas")
        built[arch] = (cfg, build_model(cfg, dev).init(
            torch.Generator(dev).manual_seed(SHARD_SEED)))
    if dev == "cuda":
        torch.cuda.synchronize()
    return built


def recurrent_checks(torch, np, rank, conn, dev, cfg_of, mesh, weights):
    """Phase 22 on this rank: the sharded forward of the recurrent families
    (22a rwkv6-3b, 22b zamba2-2.7b: a prefill and decode steps under
    ``pallas``, against rank 0's one-device run of the same code from the
    same weights; 22c both models' loss and gradients from those weights,
    each rank's shards against its own one-device run's, so that no
    gradient crosses gloo).  ``weights`` are :func:`recurrent_weights`'s;
    this phase drops them.  Returns this rank's numbers (rank 0's hold
    the forward's gaps, each rank its shards' gradient gaps)."""
    import dataclasses

    from repro_torch.data.pipeline import lcg_batch, place
    from repro_torch.distribution import sharding as sh
    from repro_torch.kernels.decode_attention import ops as da_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models.transformer import build_model
    from repro_torch.training.train import value_and_grad
    from repro_torch.training.tree import tree_leaves
    out, secs = {}, {}
    stage, sync, free, _ = _rank_helpers(torch, conn, dev, secs)
    counters = _counters()
    # each kernel's entry point noting the heads it was given (every one
    # takes [B, T, H, ...] but decode, which takes [B, H, Dh])
    heads = {}
    entries = ((wkv_ops, "wkv6", "rwkv6_wkv", 2),
               (ssd_ops, "ssd", "mamba2_ssd", 2),
               (fa_ops, "flash_attention", "flash_attention", 2),
               (da_ops, "decode_attention", "decode_attention", 1))
    originals = [getattr(mod, fn) for mod, fn, _, _ in entries]

    def noting(fn, kernel, dim):
        def entry(*args, **kw):
            heads.setdefault(kernel, set()).add(args[0].shape[dim])
            if any(sh.is_dtensor(a) for a in args):
                out.setdefault("dtensor_entries", []).append(kernel)
            return fn(*args, **kw)
        return entry

    def launches():
        return {k: c.launches for k, c in counters.items() if c.launches}

    def zero_counts():
        sync()
        heads.clear()
        for c in counters.values():
            c.launches = 0
        sh.ROUTED_CALLS.clear()

    built = {}
    for (mod, fn, kernel, dim), orig in zip(entries, originals):
        setattr(mod, fn, noting(orig, kernel, dim))
    try:
        for tag, arch, n_layers in RECURRENT_SHARDED:
            stage(tag)
            cfg, params = weights.pop(arch)
            model = build_model(cfg, dev)
            n = REC_PROMPT + REC_STEPS
            toks = torch.as_tensor(np.random.default_rng(SHARD_SEED).integers(
                0, cfg.vocab, (1, n)), device=dev)
            state = "wkv" if cfg.family == "rwkv6" else "ssm"

            def serve(pp, cache):
                lg, cache = model.prefill(pp, toks[:, :REC_PROMPT], cache)
                outs = [sh.full(lg)]
                for i in range(REC_PROMPT, n):
                    lg, cache = model.decode_step(
                        pp, toks[:, i:i + 1], cache,
                        torch.full((1,), i, dtype=torch.int32, device=dev))
                    outs.append(sh.full(lg))
                return torch.cat(outs, dim=1).float(), sh.full(cache[state])

            ctx = make_ctx(mesh, cfg)
            with sh.sharding_ctx(ctx):
                pd = sh.param_sharding_tree(params, model.param_specs(), mesh)
                cspec = model.cache_specs(1, n)
                cache = sh.param_sharding_tree(model.init_cache(1, n), cspec,
                                               mesh)
                zero_counts()
                got, got_state = serve(pd, cache)
                sync()
                out[tag] = dict(
                    launches=launches(),
                    local_heads={k: sorted(v) for k, v in heads.items()},
                    collectives=dict(sh.ROUTED_CALLS),
                    cache_spec=repr(cspec[state]))
            del cache
            if rank == 0:
                want, want_state = serve(params, model.init_cache(1, n))
                out[tag].update(
                    max_abs_err=float((got - want).abs().max()),
                    max_abs_logit=float(want.abs().max()),
                    finite=bool(got.isfinite().all()),
                    shape=list(got.shape), vocab=cfg.vocab,
                    state_gap=float((got_state - want_state).abs().max()),
                    state_excess=_allclose_excess(torch, got_state,
                                                  want_state, REC_STATE_TOL),
                    max_abs_state=float(want_state.abs().max()))
            built[arch] = (cfg, params, pd)
            del got, got_state
            free()
    finally:
        for (mod, fn, _, _), orig in zip(entries, originals):
            setattr(mod, fn, orig)

    # 22c: the loss and its gradients through ScanGrad on local heads (the
    # config's attn_impl: the attention kernels refuse a gradient)
    stage("22c")
    out["22c"] = {}
    for _, arch, n_layers in RECURRENT_SHARDED:
        cfg, params, pd = built.pop(arch)
        cfg = dataclasses.replace(cfg, attn_impl=cfg_of(arch).attn_impl)
        model = build_model(cfg, dev)
        tokens, labels = place(*lcg_batch(0, CHECK_BATCH, CHECK_SEQ,
                                          cfg.vocab), device=dev)
        t0 = time.perf_counter()
        with sh.sharding_ctx(make_ctx(mesh, cfg)):
            zero_counts()
            with sh.plain_as_replicated():
                loss, g = value_and_grad(model.loss, pd, tokens, labels)
            loss = float(sh.full(loss))
            sync()
            res = dict(loss=loss, launches=launches(),
                       collectives=dict(sh.ROUTED_CALLS))
        t1 = time.perf_counter()
        want_loss, want = value_and_grad(model.loss, params, tokens, labels)
        sync()
        t2 = time.perf_counter()
        ratios = [_leaf_ratio(*_shard_pair(a, b), float(b.abs().max()))
                  for a, b in zip(tree_leaves(g), tree_leaves(want))
                  if b.numel()]
        res.update(one_device=float(want_loss),
                   loss_gap=abs(loss - float(want_loss)),
                   grad_ratio=max(ratios), leaves=len(ratios),
                   secs=dict(sharded=t1 - t0, one_device=t2 - t1,
                             compare=time.perf_counter() - t2))
        out["22c"][arch] = res
        del params, pd, g, want
        free()
    stage("end")
    out["secs"] = secs
    return out


def moe_grad_checks(torch, np, rank, conn, dev, cfg_of, mesh):
    """Phase 23 on this rank: the loss (a fixed projection of one
    dbrx-132b MoE layer's output plus its aux) and its gradients through
    ``moe_ep`` on the rank's local experts, against the rank's own
    one-device gradients from the same weights, one leaf at a time (each
    rank's shards against the same slice of the whole leaf, so that no
    gradient crosses gloo).  Returns this rank's numbers."""
    import dataclasses

    from repro_torch.distribution import sharding as sh
    from repro_torch.launch.mesh import make_ctx
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.transformer import build_model
    secs = {}
    stage, sync, free, gen = _rank_helpers(torch, conn, dev, secs)
    free()
    stage("23 weights")
    pub = cfg_of("dbrx-132b", dtype="float32", param_dtype="float32")
    cfg = dataclasses.replace(pub, moe=dataclasses.replace(
        pub.moe, capacity_factor=MOE_EP_CF))
    p = moe_mod.init_moe(gen(SHARD_SEED + 3), cfg)
    B, S = MOE_GRAD_TOKENS
    D = cfg.d_model
    x = torch.randn((B, S, D), generator=gen(SHARD_SEED + 4), device=dev)
    proj = torch.randn((B, S, D), generator=gen(SHARD_SEED + 5), device=dev)
    names = list(p)
    ctx = make_ctx(mesh, cfg)
    x_spec = sh.Spec(ctx.rules["batch"], ctx.tp_axis, None)
    sync()
    stage("23 sharded")
    with sh.sharding_ctx(ctx):
        specs = build_model(cfg, "meta").param_specs()["layers"][0]["mlp"]
        pd = {k: sh.distribute(p[k], sh.NamedSharding(mesh, specs[k]))
              .requires_grad_() for k in names}
        sh.ROUTED_CALLS.clear()
        with sh.plain_as_replicated():
            y, aux = moe_mod.moe_ep(cfg, pd, x)
            loss = (y * proj).sum() + aux
            # each gradient in its parameter's layout (the router's comes
            # back as a partial sum over the token axes)
            grads = {k: g.redistribute(pd[k].device_mesh, pd[k].placements)
                     for k, g in zip(names, torch.autograd.grad(
                         loss, [pd[k] for k in names]))}
        sync()
        collectives = dict(sh.ROUTED_CALLS)
        loss = float(sh.full(loss.detach()))
        xl = sh.to_local_as(x, x_spec)
    # the routing of this rank's tokens, by its own product with the router
    T_l = xl.shape[0] * xl.shape[1]
    _, idx_l, _ = moe_mod._router(cfg, p, xl.reshape(T_l, D))
    counts = torch.bincount(idx_l.flatten(), minlength=cfg.moe.n_experts)
    drops = int((counts - moe_mod._capacity(T_l, cfg)).clamp_min(0).sum())
    del pd, y, aux
    free()
    stage("23 one device")
    _, idx_d, _ = moe_mod._router(cfg, p, x.reshape(B * S, D))
    lo = ctx.mesh.get_local_rank(ctx.tp_axis) * T_l // B
    mine = idx_d.reshape(B, S, -1)[:, lo:lo + T_l // B].reshape(T_l, -1)
    same = (idx_l.sort(-1).values == mine.sort(-1).values).all(-1)
    ratios, one_loss = {}, None
    for k in names:
        leaf = p[k].requires_grad_()
        y1, aux1 = moe_mod.moe(cfg, {**p, k: leaf}, x)
        l1 = (y1 * proj).sum() + aux1
        (g,) = torch.autograd.grad(l1, [leaf])
        leaf.requires_grad_(False)
        one_loss = float(l1.detach())
        got, want = _shard_pair(grads[k], g)
        ratios[k] = _leaf_ratio(got, want, float(g.abs().max()))
        del y1, aux1, l1, g, got, want
        free()
    sync()
    stage("end")
    return {"23": dict(loss=loss, one_device=one_loss,
                       loss_gap=abs(loss - one_loss), ratios=ratios,
                       flips=int((~same).sum()), tokens=T_l, drops=drops,
                       capacity=moe_mod._capacity(T_l, cfg),
                       local_experts=int(grads["w_in"].to_local().shape[0]),
                       collectives=collectives),
            "secs": secs}


def _shard_pair(got, full):
    """This rank's shard of the leaf ``got`` and the slice of the full
    tensor ``full`` that the shard holds (no communication; a plain leaf
    and ``full`` as they are)."""
    from repro_torch.distribution import sharding as sh
    if not sh.is_dtensor(got):
        return got, full
    from torch.distributed.tensor import distribute_tensor
    return got.to_local(), distribute_tensor(
        full, got.device_mesh, got.placements, src_data_rank=None).to_local()


@contextlib.contextmanager
def shard_ranks(dev="cuda", cfg_of=None):
    """Phase 21's two rank processes, started before phase 18 so that
    their imports and the gloo rendezvous run beside phases 18-20; they
    wait for the go.  Yields (processes, pipes)."""
    import multiprocessing
    import socket
    mp = multiprocessing.get_context("spawn")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs, conns = [], []
    for r in range(SHARD_WORLD):
        mine, theirs = mp.Pipe()
        p = mp.Process(target=shard_rank, args=(r, port, theirs, dev, cfg_of),
                       daemon=True)
        p.start()
        procs.append(p)
        conns.append(mine)
    try:
        yield procs, conns
    finally:
        for c in conns:
            with contextlib.suppress(OSError):
                c.send("stop")
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()


def _ranks_run(torch, ranks, phase, limit_s):
    """Says go to the waiting ranks and returns each rank's result,
    failing the phase, named by the stage it was in, where a rank fails,
    dies or runs past four times ``limit_s``."""
    procs, conns = ranks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for c in conns:
        c.send("go")
    results, stage = [None] * SHARD_WORLD, ["go"] * SHARD_WORLD
    deadline = time.perf_counter() + 4 * limit_s
    while any(r is None for r in results):
        for r, c in enumerate(conns):
            if results[r] is not None:
                continue
            if c.poll(0.02):
                kind, val = c.recv()
                if kind == "stage":
                    stage[r] = val
                elif kind == "error":
                    raise SmokeFailure(f"{phase}: rank {r} failed in "
                                       f"{stage[r]}: {val[-3000:]}")
                else:
                    results[r] = val
            elif not procs[r].is_alive():
                raise SmokeFailure(f"{phase}: rank {r} died (exit "
                                   f"{procs[r].exitcode}) in {stage[r]}")
        check(time.perf_counter() < deadline,
              f"{phase}: the ranks did not finish (stages {stage})")
    return results


def sharded_execution(torch, report, ranks):
    """Phase 21: the sharded paths on two ranks of the card (21a-e), each
    against the one-device run of the same code.  Returns the attention
    kernels' launches of 21b, summed over the ranks."""
    procs, conns = ranks
    t_phase = time.perf_counter()
    ready = []
    for r, c in enumerate(conns):
        check(c.poll(4 * SHARD_PHASE_S), f"21: rank {r} never got ready")
        kind, val = c.recv()
        check(kind == "ready", f"21: rank {r} failed to start: {val}")
        ready.append(val)
    wait_s = time.perf_counter() - t_phase
    results = _ranks_run(torch, ranks, "21", SHARD_PHASE_S)
    r0 = results[0]
    a, b, c_, d, e = (r0[k] for k in ("21a", "21b", "21c", "21d", "21e"))
    log(f"21: the ranks were ready {['%.1f s' % s for s in ready]} after "
        f"they started (waited {wait_s:.1f} s here); gloo carried "
        f"all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single "
        f"and a DTensor tensor-parallel product with its backward on CUDA "
        f"tensors; seconds a stage on rank 0 "
        f"{ {k: round(v, 2) for k, v in r0['secs'].items()} }")
    log(f"21a: olmo-1b at published widths, {SHARD_LAYERS} layers, f32, "
        f"(data 1 x model {SHARD_WORLD}), {SHARD_STEPS} AdamW steps at lr "
        f"{a['lr']:g}: losses {a['losses']} against one device "
        f"{a['one_device']}: gap {a['loss_gap']:.3e} (bound "
        f"{SHARD_LOSS_TOL:g}); parameters max |Δ| {a['param_gap']:.3e}, "
        f"allclose excess {a['param_excess']:.3e} (bound "
        f"{SHARD_PARAM_TOL:g}) at leaf {a['worst']['leaf']} element "
        f"{a['worst']['index']}, whose first-step gradient is "
        f"{a['worst']['grad']:.3e} (the leaf's largest "
        f"{a['worst']['leaf_max_grad']:.3e}, AdamW's eps 1e-08); "
        f"placements {a['placements']}; DTensor's collectives a step "
        f"{r0['collectives_a_step']}")
    check(a["loss_gap"] <= SHARD_LOSS_TOL, f"21a: loss gap {a['loss_gap']}")
    check(a["param_excess"] <= SHARD_PARAM_TOL,
          f"21a: parameter gap {a['param_excess']}")
    check(any("Shard" in p for p in a["placements"]),
          f"21a: nothing sharded: {a['placements']}")
    ratio = b["max_abs_err"] / b["max_abs_logit"]
    tol = MODEL_TOL["bfloat16"]
    launches = {k: sum(r["launches"][k] for r in results)
                for k in ("flash_attention", "decode_attention")}
    log(f"21b: olmo-1b at published widths, {SHARD_LAYERS} layers, bf16, "
        f"pallas: prefill of {SHARD_PROMPT} + {SHARD_DECODE} decode steps "
        f"sharded "
        f"against one device: max |Δ| {b['max_abs_err']:.4e}, max |logit| "
        f"{b['max_abs_logit']:.4f}, ratio {ratio:.3e} (bound {tol:g}); "
        f"launches a rank {[r['launches'] for r in results]}, the kernels' "
        f"local heads {[r['local_heads'] for r in results]}; DTensor's "
        f"collectives over the prefill and {SHARD_DECODE} steps "
        f"{r0['collectives_21b']}")
    check(b["finite"] and b["shape"] == [1, SHARD_DECODE + 1, b["vocab"]],
          f"21b: logits {b}")
    check(ratio <= tol, f"21b: sharded != one device ({ratio:.3e})")
    heads = b["local_heads"]
    for r in results:
        check(r["launches"] == {"flash_attention": SHARD_LAYERS,
                                "decode_attention": SHARD_LAYERS * SHARD_DECODE},
              f"21b: launches {r['launches']}")
        check(r["local_heads"] == {"flash_attention": [heads],
                                   "decode_attention": [heads]},
              f"21b: the kernels saw heads {r['local_heads']}")
    log(f"21c: gemma-2b at published widths (8 heads, 1 KV head, Dh 256, "
        f"shard_heads=False), {SHARD_LAYERS} layers, f32: cache "
        f"{r0['21c_cache_spec']}, {SEQ_STEPS} decode steps after a prompt of "
        f"{SEQ_PROMPT}: max |Δ| {c_['max_abs_err']:.3e}, allclose excess "
        f"{c_['excess']:.3e} (bound {SEQ_TOL:g}), max |logit| "
        f"{c_['max_abs_logit']:.3f}")
    check(r0["21c_seq_sharded"], f"21c: the cache's sequence dim is not "
                                 f"sharded: {r0['21c_cache_spec']}")
    check(c_["excess"] <= SEQ_TOL, f"21c: gap {c_['excess']}")
    drops = [r["21d_drops"] for r in results]
    log(f"21d: one dbrx-132b MoE layer (d 6144, 16 experts top 4, bf16; "
        f"{16 // SHARD_WORLD} experts a rank), {d['tokens']} tokens, "
        f"capacity factor {MOE_EP_CF:g}: moe_ep against moe_dense at the "
        f"{d['tokens'] - d['flips']} tokens whose routing agrees: max |Δ| "
        f"{d['max_abs_err']:.3e}, allclose excess {d['excess']:.3e} (bound "
        f"{MOE_EP_TOL:g}); {d['flips']} routing flips {d['first_flip']}; aux "
        f"{d['aux']:.6f} against {d['aux_dense']:.6f} (gap "
        f"{d['aux_gap']:.3e}, bound {MOE_AUX_TOL:g}); tokens dropped a rank "
        f"at the published capacity factor "
        f"{_published('dbrx-132b').moe.capacity_factor:g} "
        f"{[x['published'] for x in drops]} (capacity "
        f"{drops[0]['capacity_published']}), at {MOE_EP_CF:g} "
        f"{[x['raised'] for x in drops]}")
    check(all(x["raised"] == 0 for x in drops), f"21d: drops {drops}")
    check(d["excess"] <= MOE_EP_TOL, f"21d: gap {d['excess']}")
    check(d["aux_gap"] <= MOE_AUX_TOL, f"21d: aux gap {d['aux_gap']}")
    log(f"21e: (pod {SHARD_WORLD} x data 1 x model 1), olmo-1b "
        f"{SHARD_LAYERS} layers f32, {POD_STEPS} compressed steps: losses "
        f"{[round(x, 5) for x in e['losses']]}; the first update against "
        f"AdamW on the int8 sync of the two pods' gradients "
        f"{e['update_gap']:.3e} x max |p| (bound {POD_TOL:g})")
    check(e["losses"][-1] < e["losses"][0], f"21e: losses {e['losses']}")
    check(e["update_gap"] <= POD_TOL, f"21e: update gap {e['update_gap']}")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 21: {phase_s:.1f} s")
    report["sharded"] = dict(ready_s=ready, wait_s=wait_s, phase_s=phase_s,
                             ranks=results, launches=launches)
    check(phase_s <= SHARD_PHASE_S, f"phase 21 took {phase_s:.1f} s (limit "
                                    f"{SHARD_PHASE_S:.0f} s)")
    return launches


def sharded_recurrent(torch, report, ranks):
    """Phase 22: the sharded forward of rwkv6-3b and zamba2-2.7b on phase
    21's two ranks (22a-c), each against the one-device run of the same
    code.  Returns the kernels' launches of 22a and 22b's sharded runs,
    summed over the ranks."""
    t_phase = time.perf_counter()
    results = _ranks_run(torch, ranks, "22", REC_PHASE_S)
    r0 = results[0]
    log(f"22: seconds a stage on rank 0 "
        f"{ {k: round(v, 2) for k, v in r0['secs'].items()} }")
    check(not any(r.get("dtensor_entries") for r in results),
          f"22: a DTensor reached a kernel's entry point: "
          f"{[r.get('dtensor_entries') for r in results]}")
    tol = MODEL_TOL["float32"]
    launches = {}
    for tag, arch, n_layers in RECURRENT_SHARDED:
        a = r0[tag]
        cfg = _published(arch)
        ratio = a["max_abs_err"] / a["max_abs_logit"]
        if cfg.family == "rwkv6":
            scan_heads = cfg.d_model // cfg.rwkv.head_size
            want = {"rwkv6_wkv": n_layers}
            want_heads = {"rwkv6_wkv": [scan_heads // SHARD_WORLD]}
        else:
            scan_heads = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
            n_attn = n_layers // cfg.hybrid_attn_every
            want = {"mamba2_ssd": n_layers, "flash_attention": n_attn,
                    "decode_attention": n_attn * REC_STEPS}
            want_heads = {"mamba2_ssd": [scan_heads // SHARD_WORLD],
                          "flash_attention": [cfg.n_heads // SHARD_WORLD],
                          "decode_attention": [cfg.n_heads // SHARD_WORLD]}
        log(f"{tag}: {arch} at published widths ({scan_heads} scan heads), "
            f"{n_layers} layers, f32, pallas, (data 1 x model "
            f"{SHARD_WORLD}): prefill of {REC_PROMPT} + {REC_STEPS} decode "
            f"steps sharded against one device: max |Δ| "
            f"{a['max_abs_err']:.4e}, max |logit| {a['max_abs_logit']:.4f}, "
            f"ratio {ratio:.3e} (bound {tol:g}); the carried state "
            f"{a['cache_spec']}: max |Δ| {a['state_gap']:.3e}, allclose "
            f"excess {a['state_excess']:.3e} (bound {REC_STATE_TOL:g}), max "
            f"|state| {a['max_abs_state']:.3f}; launches a rank "
            f"{[r[tag]['launches'] for r in results]}, the kernels' local "
            f"heads {[r[tag]['local_heads'] for r in results]}; DTensor's "
            f"collectives {a['collectives']}")
        check(a["finite"] and a["shape"] == [1, REC_STEPS + 1, a["vocab"]],
              f"{tag}: logits {a}")
        check(ratio <= tol, f"{tag}: sharded != one device ({ratio:.3e})")
        check(a["state_excess"] <= REC_STATE_TOL,
              f"{tag}: state gap {a['state_excess']}")
        check("'model'" in a["cache_spec"],
              f"{tag}: the state's heads are not split: {a['cache_spec']}")
        for r in results:
            check(r[tag]["launches"] == want,
                  f"{tag}: launches {r[tag]['launches']}, expected {want}")
            check(r[tag]["local_heads"] == want_heads,
                  f"{tag}: the kernels saw heads {r[tag]['local_heads']}, "
                  f"expected {want_heads}")
            for k, v in r[tag]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    for _, arch, n_layers in RECURRENT_SHARDED:
        c = r0["22c"][arch]
        ratio = max(r["22c"][arch]["grad_ratio"] for r in results)
        loss_gap = max(r["22c"][arch]["loss_gap"] for r in results)
        log(f"22c: {arch}, {n_layers} layers, f32, a {CHECK_BATCH} x "
            f"{CHECK_SEQ} batch: loss {c['loss']:.6f} against one device "
            f"{c['one_device']:.6f} (gap {loss_gap:.3e}, bound "
            f"{REC_LOSS_TOL:g}); the largest gradient gap over its leaf's "
            f"max |value| {ratio:.3e} over {c['leaves']} leaves, each rank's "
            f"shards (bound {REC_GRAD_TOL:g}); launches a rank (forward and "
            f"remat recompute) "
            f"{[r['22c'][arch]['launches'] for r in results]}; DTensor's "
            f"collectives {c['collectives']}; seconds on rank 0 "
            f"{ {k: round(v, 2) for k, v in c['secs'].items()} }")
        check(loss_gap <= REC_LOSS_TOL, f"22c {arch}: loss gap {loss_gap}")
        check(ratio <= REC_GRAD_TOL, f"22c {arch}: gradient gap {ratio}")
        for r in results:
            for k, v in r["22c"][arch]["launches"].items():
                launches[k] = launches.get(k, 0) + v
    phase_s = time.perf_counter() - t_phase
    log(f"phase 22: {phase_s:.1f} s")
    report["sharded_recurrent"] = dict(phase_s=phase_s, ranks=results,
                                       launches=launches)
    check(phase_s <= REC_PHASE_S, f"phase 22 took {phase_s:.1f} s (limit "
                                  f"{REC_PHASE_S:.0f} s)")
    return launches


def sharded_moe_grads(torch, report, ranks):
    """Phase 23: one dbrx-132b MoE layer's gradients through ``moe_ep`` on
    phase 21's two ranks against each rank's one-device gradients."""
    t_phase = time.perf_counter()
    results = _ranks_run(torch, ranks, "23", MOE_GRAD_PHASE_S)
    for r, res in enumerate(results):
        c = res["23"]
        worst = max(c["ratios"], key=c["ratios"].get)
        ratios = {k: float(f"{v:.3e}") for k, v in c["ratios"].items()}
        log(f"23: rank {r}: dbrx-132b's MoE layer at published widths, f32, "
            f"{c['local_experts']} local experts, {c['tokens']} of its "
            f"tokens (capacity {c['capacity']}, {c['drops']} dropped), "
            f"{c['flips']} routing flips; loss {c['loss']:.6f} against one "
            f"device {c['one_device']:.6f} (gap {c['loss_gap']:.3e}, bound "
            f"{REC_LOSS_TOL:g}); the gradient gap over each leaf's max "
            f"|value| {ratios} (worst {worst}, bound {MOE_GRAD_TOL:g}); "
            f"DTensor's "
            f"collectives {c['collectives']}; seconds "
            f"{ {k: round(v, 2) for k, v in res['secs'].items()} }")
        check(c["flips"] == 0, f"23: rank {r}: {c['flips']} routing flips")
        check(c["drops"] == 0, f"23: rank {r}: {c['drops']} tokens dropped")
        check(c["local_experts"] == 16 // SHARD_WORLD,
              f"23: rank {r} holds {c['local_experts']} experts")
        check(c["loss_gap"] <= REC_LOSS_TOL,
              f"23: rank {r}: loss gap {c['loss_gap']}")
        check(c["ratios"][worst] <= MOE_GRAD_TOL,
              f"23: rank {r}: gradient gap {c['ratios']}")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 23: {phase_s:.1f} s")
    report["sharded_moe_grads"] = dict(phase_s=phase_s, ranks=results)
    check(phase_s <= MOE_GRAD_PHASE_S, f"phase 23 took {phase_s:.1f} s "
                                       f"(limit {MOE_GRAD_PHASE_S:.0f} s)")


#: phase 24: the census's work, split over four processes: olmo-1b's
#: decode at full depth on both meshes; dbrx-132b's train step traced at 1
#: and at 2 layers (the two-point fit's traces, combined here) and its
#: arguments at full depth; 19a's step on one device
CENSUS_FIT = ("dbrx-132b", "train_4k", False)
CENSUS_JOBS = ((("olmo-1b", "decode_32k", False, 16),
                ("olmo-1b", "decode_32k", True, 16)),
               ((*CENSUS_FIT, 1),), ((*CENSUS_FIT, 2), "args"), ("19a",))
CENSUS_PHASE_S = 20.0


def census_job(cells) -> list:
    """Phase 24's work in a spawned process of its own (a fake world
    cannot share a process with a real one): each cell's census row, at
    the depth it names; for ``"19a"`` the census of phase 19a's step on
    one device; for ``"args"`` the fitted cell's arguments at full depth.
    Top-level, so that spawn can run it."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import configs
    from repro_torch.configs.shapes import ShapeCfg
    from repro_torch.launch import dryrun
    rows = []
    for cell in cells:
        if cell == "19a":
            rows.append(dryrun.run_one_device(
                configs.get(TRAIN_ARCH),
                ShapeCfg("19a", TRAIN_SEQ, TRAIN_BATCH, "train"),
                microbatches=TRAIN_MICRO).row())
        elif cell == "args":
            arch, shape, multi = CENSUS_FIT
            rows.append(dryrun.arg_census(arch, shape, multi_pod=multi))
        else:
            arch, shape, multi, n_layers = cell
            rows.append(dryrun.run_cell(arch, shape, multi_pod=multi,
                                        n_layers=n_layers).row())
    return rows


@contextlib.contextmanager
def census_jobs():
    """Phase 24's processes, started before phase 21 so that the census's
    host work runs beside phases 21-23 (whose work is on the card and in
    gloo); yields ``(their start time, the pending results)``."""
    import multiprocessing
    pool = multiprocessing.get_context("spawn").Pool(len(CENSUS_JOBS))
    try:
        yield time.perf_counter(), pool.map_async(census_job, CENSUS_JOBS)
    finally:
        pool.terminate()
        pool.join()


def census(report, pending):
    """Phase 24: the dry-run census on the host beside the card's numbers
    (each cell ok and its per-rank peak against the card's memory; 19a's
    measured step against the roofline's bound of its work).  ``pending``
    is :func:`census_jobs`'s."""
    from repro_torch import configs
    from repro_torch.launch.dryrun import fitted
    from repro_torch.roofline import analysis as roof
    t_phase = time.perf_counter()
    t_start, results = pending
    results.wait(4 * CENSUS_PHASE_S)
    check(results.ready(), "24: the census did not finish")
    (s16, s512), (one_l,), (two_l, args), (one,) = results.get()
    census_s = time.perf_counter() - t_start
    # the fitted cell: its traces at 1 and 2 layers to the full depth
    full = configs.get(CENSUS_FIT[0]).n_layers
    rows = [s16, s512, dict(two_l, **fitted(one_l, two_l, 1, full, args),
                            n_layers=full,
                            seconds=one_l["seconds"] + two_l["seconds"]),
            one]
    total = report["total_memory"]
    for r in rows:
        c = r["collectives"]
        log(f"24: {r['arch']} {r['shape']} on {r['mesh']} ({r['n_layers']} "
            f"layers; {r['seconds']:.1f} s of host time): {r['status']} "
            f"{r['reason'][:200]}; a rank's {r['flops']:.4e} FLOPs, "
            f"{r['bytes_accessed']:.4e} bytes, peak "
            f"{r['peak_memory_bytes'] / 1e9:.2f} GB (arguments "
            f"{r['arg_bytes'] / 1e9:.2f}, parameters "
            f"{r['param_bytes'] / 1e9:.3f}) against the card's "
            f"{total / 1e9:.2f} GB; collectives "
            f"{c.get('total', 0) / 1e6:.3f} MB "
            f"({c.get('cross_node', 0) / 1e6:.3f} across nodes, "
            f"{c.get('cross_pod', 0) / 1e6:.3f} across pods)")
        check(r["status"] == "ok", f"24: {r['arch']} {r['shape']} "
                                   f"{r['mesh']}: {r['reason']}")
        check(r["flops"] > 0 and r["peak_memory_bytes"] > 0, f"24: {r}")
    t_comp, t_mem = (one["flops"] / roof.PEAK_FLOPS,
                     one["bytes_accessed"] / roof.HBM_BW)
    bound = max(t_comp, t_mem)
    ms = report["train_full_width"]["ms_per_step"]
    log(f"24: 19a's step on one device ({TRAIN_ARCH}, {TRAIN_BATCH} x "
        f"{TRAIN_SEQ} in {TRAIN_MICRO} microbatches, {one['n_layers']} "
        f"layers): compute {t_comp * 1e3:.3f} ms, memory "
        f"{t_mem * 1e3:.3f} ms, collective 0 ms (one device; H100 "
        f"data-sheet rates) -> bound {bound * 1e3:.3f} ms by "
        f"{'bytes' if t_mem >= t_comp else 'operations'}; measured in 19a "
        f"{ms:.1f} ms, {ms / 1e3 / bound:.2f} x the bound; the census's "
        f"peak {one['peak_memory_bytes'] / 1e9:.2f} GB against 19a's "
        f"{report['train_full_width']['max_memory_allocated_gb']:.2f} GB")
    phase_s = time.perf_counter() - t_phase
    log(f"phase 24: {phase_s:.1f} s (the census's processes ran "
        f"{census_s:.1f} s from their start before phase 21 to their last "
        f"result)")
    report["census"] = dict(phase_s=phase_s, census_s=census_s, rows=rows,
                            train_19a=dict(
                                t_compute_ms=t_comp * 1e3,
                                t_memory_ms=t_mem * 1e3,
                                bound_ms=bound * 1e3, measured_ms=ms,
                                ratio=ms / 1e3 / bound))
    check(phase_s <= CENSUS_PHASE_S, f"phase 24 took {phase_s:.1f} s "
                                     f"(limit {CENSUS_PHASE_S:.0f} s)")


def main() -> int:
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run it from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    import numpy as np
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.core import PAPER_LARGE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report = {}
    t_start = time.perf_counter()
    try:
        with Phase("1 environment", report):
            environment(torch, report)
        with Phase("2 build", report):
            build(report)
        with Phase("3 kernel vs plain", report):
            max_err, t = kernel_vs_plain(torch, np, report, PAPER_LARGE)
        with Phase("4 main path", report):
            engine_launches, engine_t = main_path(torch, np, report,
                                                  PAPER_LARGE)
        with Phase("4b profile of the main path", report):
            profile_main_path(torch, np, report, PAPER_LARGE)
        # phase 20's numpy oracle runs in worker processes of its own, fed
        # as the card's runs it holds are made (phases 5 and 14-17)
        with oracle_pool() as opool:
            oracle = Oracle(opool)
            oracle.hold_launched_here()
            # the batched engine's check runs of phases 5 and 12-17 go to
            # worker processes
            with contextlib.ExitStack() as workers:
                with Phase("5 kernel path vs plain path", report):
                    pool = workers.enter_context(plain_pool())
                    engine_err = end_to_end(torch, np, report, PAPER_LARGE,
                                            pool, oracle)
                with Phase("6 attention kernels vs plain", report):
                    attn_t = attention_kernels(torch, np, report)
                with Phase("7 serving path at full width", report):
                    frontend, serve_launches = serving_path(
                        torch, np, report, SERVED, 1, "serving")
                with Phase("7b profile of decode steps", report):
                    profile_decode(torch, report, frontend, SERVED,
                                   "decode_profile")
                del frontend
                torch.cuda.empty_cache()
                with Phase("8 prefill and decode vs full forward", report):
                    prefill_decode_vs_forward(torch, np, report, CHECKED_DENSE,
                                              "prefill_decode_vs_forward")
                with Phase("9 scan kernels vs plain", report):
                    scan_t = scan_kernels(torch, report)
                with Phase("10 recurrent serving at full width", report):
                    frontend, rec_launches = serving_path(
                        torch, np, report, RECURRENT, 2, "recurrent_serving")
                with Phase("10b profile of recurrent decode steps", report):
                    profile_decode(torch, report, frontend, RECURRENT,
                                   "recurrent_decode_profile")
                del frontend
                torch.cuda.empty_cache()
                with Phase("11 recurrent prefill and decode vs full forward",
                           report):
                    prefill_decode_vs_forward(
                        torch, np, report, RECURRENT,
                        "recurrent_prefill_decode_vs_forward")
                with Phase("12 trace replay on the card", report):
                    trace_launches = trace_replay(torch, np, report, pool)
                with Phase("13 policy zoo on the card", report):
                    zoo_launches, zoo_err = policy_zoo(torch, np, report, pool)
                with Phase("14 keep-alive axis on the card", report):
                    life_launches, life_err = keepalive_axis(torch, np, report,
                                                             pool, oracle)
                with Phase("15 telemetry and fleet on the card", report):
                    obs_launches, obs_err, _ = telemetry_fleet(
                        torch, np, report, pool, oracle)
                with Phase("16 timeline and serving platform on the card",
                           report):
                    tl_launches, platform_launches, tl_err, _ = \
                        timeline_platform(torch, np, report, pool, oracle)
                with Phase("17 streaming on the card", report):
                    stream_launches, fcfs_launches, stream_err = streaming(
                        torch, np, report, pool, oracle)
            # phase 21's two ranks start here and join their gloo group
            # beside phases 18-20
            with shard_ranks() as ranks:
                # 19b's CPU side runs in its worker processes beside phase 18
                with train_checks() as (train_tmp, train_jobs):
                    with Phase("18 MoE and MLA serving at full width",
                               report):
                        moe_launches, moe_kernel_err = moe_serving(
                            torch, np, report)
                    with Phase("19 training on the card", report):
                        train_launches = training(torch, np, report,
                                                  train_tmp, train_jobs)
                with Phase("20 the numpy oracle against the card", report):
                    oracle_launches = numpy_oracle(torch, np, report, oracle)
                # phase 24's census runs on the host beside phases 21-23
                with census_jobs() as pending:
                    with Phase("21 sharded execution on two ranks", report):
                        shard_launches = sharded_execution(torch, report,
                                                           ranks)
                    with Phase("22 the sharded recurrent forward", report):
                        for k, v in sharded_recurrent(torch, report,
                                                      ranks).items():
                            shard_launches[k] = shard_launches.get(k, 0) + v
                    with Phase("23 sharded MoE training", report):
                        sharded_moe_grads(torch, report, ranks)
                    with Phase("24 the dry-run census on the host", report):
                        census(report, pending)
        total_s = time.perf_counter() - t_start
        check(total_s <= SCRIPT_S, f"the script took {total_s:.1f} s (limit "
                                   f"{SCRIPT_S:.0f} s)")
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        report["total_s"] = time.perf_counter() - t_start
        log("report " + json.dumps(report, separators=(",", ":")))
    # hermes_select's path is serving (phases 7 and 18: one launch per
    # dispatch; phase 16: one per dispatch of the platform's controller) and
    # the batched engine's E/H/FCFS stream (phase 17: one per arrival) and
    # the platform held to the oracle (phase 20b: one per arrival); the
    # simulator's E/H/PS makes its choice inside sim_engine (phases 4,
    # 12-17 and 20a: every fused run's launch and every stream's chunk
    # launch on those paths; its times from phase 4, where the plain engine
    # runs the same inputs)
    kernels = [{
        "name": "hermes_select", "route": "cuda",
        "source": "src/repro_torch/csrc/hermes_select.cu",
        "replaces": "src/repro/kernels/hermes_select/kernel.py:66",
        "launches": serve_launches["hermes_select"] + platform_launches
        + fcfs_launches + moe_launches["hermes_select"] + oracle_launches[1],
        "max_abs_err": max_err,
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "sim_engine", "route": "cuda",
        "source": "src/repro_torch/csrc/sim_engine.cu",
        "replaces": "src/repro/kernels/hermes_select/kernel.py:66",
        "launches": engine_launches + trace_launches + zoo_launches
        + life_launches + obs_launches + tl_launches + stream_launches
        + oracle_launches[0],
        "max_abs_err": max(engine_err, zoo_err, life_err, obs_err, tl_err,
                           stream_err),
        "ms": engine_t["ms"], "plain_ms": engine_t["plain_ms"],
        "bound_ms": engine_t["bound_ms"], "bound_by": engine_t["bound_by"],
        "library_ms": None}]
    # the headline shape of each: olmo-1b's attention, rwkv6-3b's and
    # zamba2-2.7b's scans at T = 777, bf16; launches from the paths that
    # serve them (phases 7 and 18 for attention, phase 10 for the scans,
    # phase 18 for the launcher's rwkv-tiny), train them (phase 19b:
    # the scans' forwards and remat recomputes) and run sharded (phase
    # 21b: attention on each rank's local heads; phase 22: the scans and
    # zamba2's attention on local heads, its gradients' forwards and remat
    # recomputes among them); the error the largest of
    # the headline shape's and, for attention, dbrx-132b's shapes (phase 18)
    for name, path, rows, n in (
            ("flash_attention", "flash_attention/kernel.py:63",
             attn_t["flash_attention"], serve_launches),
            ("decode_attention", "decode_attention/kernel.py:60",
             attn_t["decode_attention"], serve_launches),
            ("rwkv6_wkv", "rwkv6_wkv/kernel.py:66", scan_t["rwkv6_wkv"],
             rec_launches),
            ("mamba2_ssd", "mamba2_ssd/kernel.py:60", scan_t["mamba2_ssd"],
             rec_launches)):
        row = rows[0]
        err = max([row["max_abs_err"]] + [
            e for what, e in moe_kernel_err.items() if what.startswith(name)])
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": f"src/repro/kernels/{path}",
            "launches": n[name] + moe_launches.get(name, 0)
            + train_launches[name] + shard_launches.get(name, 0),
            "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row.get("library_ms")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
