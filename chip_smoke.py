"""Drive the PyTorch/CUDA port (edl_tpu_torch) on one NVIDIA GPU.

Run from the repository root on a machine with a Hopper card and the CUDA
toolkit:

    python3 chip_smoke.py

Phases, each of which raises on failure:

(a) build the hand-written kernels from ``edl_tpu_torch/csrc`` (nvcc,
    sm_90a), print the build seconds and, for each flash and GroupNorm
    kernel, the registers, static shared memory and spill bytes ptxas
    reported;
(b) hold each flash kernel — forward, dQ, dK/dV — against its plain PyTorch
    version at FLAGSHIP attention shapes (bf16, b 16, s 1024, h 8, hk 2,
    d 128), causal and non-causal, and time the kernel, the plain version
    and ``F.scaled_dot_product_attention`` (a yardstick the port never
    calls) beside the least time the card could take;
(c) the FLAGSHIP path: ``ElasticTrainer`` on FLAGSHIP with the flash
    kernels, adamw(3e-4), batch 16 x seq 1024 of seeded tokens, 1 warm-up
    step and 5 timed steps; every loss finite, the loss falling, and each
    kernel launched once per layer per step;
(d) the port's entry point, and the model's logits through the flash
    kernels against its reference attention path on a small input, with
    the same model's attention output zeroed as a control that must fail;
(e) the GroupNorm kernels against their plain versions at every distinct
    ResNet-50 site shape at b 256 (12 shapes, G 32, bf16), each shape's
    cluster plan in each direction (k blocks an image, rows a block, rows
    resident in shared memory) and the clusters the card runs at once,
    timed beside ``F.group_norm`` (a yardstick) and their byte bounds, and
    summed over the 53 sites of a step; a plan past clusters of 8 is also
    timed capped at 8;
(f) the flash kernels at the BERT-base shape (b 32, s 512, h = hk = 12,
    d 64, non-causal), at (k)'s micro-batch (b 2, FLAGSHIP's s, h, hk and
    d, causal), at the local batch of a live rank of (j) and (l) on a
    world of 2 (b 8), at a rank's heads on (m)'s tp 2 (b 16, h 4,
    hk 1), at (o)'s tp-2 micro-batch (b 2, h 4, hk 1), at a rank's
    heads of BERT-base on (r)'s tp 2 (b 32, s 512, h = hk = 6, d 64,
    non-causal), at (w)'s ring chunk (b 4, s 2 048, FLAGSHIP's heads,
    full and causal), and at (aa)'s LLAMA3_8B shape (b 1, s 8 192, h 32,
    hk 8, d 128, causal), checked and timed as in (b);
(g) the ResNet-50 path: ``ElasticTrainer`` on RESNET50 at b 256 x 224²,
    adamw(3e-4), 1 warm-up and 5 timed steps, 53 launches of each GroupNorm
    kernel per step; the same steps from fresh weights with
    ``EDL_GN_PALLAS=0`` (the plain versions, no launch); and the logits of
    the kernel path against the plain path's on a small input, with one
    stage's ``norm3`` scales zeroed as a control that must fail;
(h) the BERT-base path: ``ElasticTrainer`` on BERT_BASE at 32 x 512 MLM,
    1 warm-up and 5 timed steps, 12 launches of each flash kernel per step;
(i) the serving path: FLAGSHIP decoded token by token through
    ``flagship_decode_fleet`` (8 slots, 64-token prefill chunks, a paged KV
    pool of 16-token blocks).  The paged logits of 3 prompts of 256 tokens
    and 16 decode steps against ``transformer.apply`` on the same
    sequences, with a control that reads another session's context; 16
    mixed-priority sessions through a 2-replica fleet scaled to 1 once every
    session has its first token, token-equal to an undisturbed 1-replica
    fleet with no session dropped; the same sessions with speculative
    decode, equal to single-token decode wherever its logits' top-2 margin
    clears the logits check's tolerance, and ``verify_step`` fed perfect
    drafts held to the same rule; tokens/s, TTFT and TPOT, the device
    time of a decode step and of a prefill chunk, and 0 launches of the
    hand-written kernels (no Pallas kernel lies on the decode path);
(j) the multi-rank trainer: two spawned processes share the card and join
    one gloo process group through ``entry.flagship_elastic_world``
    (FLAGSHIP, the global batch of (c)).  Two steps on a world of 1 (rank 1
    stands by), ``resize(2)``, two steps on 2, ``resize(1)``, two steps on
    1; rank 1's params and optimizer state bitwise equal to rank 0's after
    the grow, every parameter bitwise equal across the ranks after each step
    of 2, each live rank launching every flash kernel once per layer a step
    and a rank standing by none, every loss within ``WORLD_LOSS_ATOL`` of a
    one-rank control (the same steps from the same init, in this process);
    then one more ``resize(2)`` with an allocation failure planted on rank 1
    only, which both ranks roll back, stepping on at world 1.  Two ranks on
    one card prove the protocol, not scaling: the world-2 step time is no
    data-parallel speed-up.
(k) the durable virtual-worker loop: two spawned ranks share the card over
    gloo (``entry.flagship_virtual_world``: FLAGSHIP's width at
    ``DURABLE_LAYERS`` layers — (k), (o), (p) and (q)'s virtual drive are
    bound by saving and restoring the whole state, which the depth sets —
    8 virtual workers, a constant global batch of 16 x 1024 as 8
    micro-batches, replicated accumulation).  ``VirtualWorkerLoop`` runs 9
    steps through worlds 1→2, rank 0 checkpointing every 3 steps
    (``ElasticCheckpointer``, one DCP directory a step, in a temporary
    directory deleted at the end); every rank is then killed
    mid-accumulation (``abort_after=3`` on world 2), and fresh trainers
    restore step 9 and run steps 10-12, shrinking to 1.  The stitched 12
    losses must equal a one-process control's bitwise, every row be
    trained exactly once, each live rank launch every flash kernel once a
    layer and micro-batch a step (8 micro-batches) and one standing by
    none, and no loop's stall watchdog see a stall (each watches its own
    loop, not the restore or the drills).  Rank 0 then tears the newest step
    (12), past which a fresh checkpointer must fall back to 9, and times one
    synchronous save of the whole state (its folds and its CRC32s alone
    too) and one ``save_async`` (its pause, then its persist).  The same
    schedule in dp-packed mode must stay within ``trajectories_equivalent``
    of the control.
(l) fsdp: two spawned ranks share the card over gloo
    (``entry.flagship_elastic_world`` with ``param_sharding="fsdp"`` and
    ``MeshSpec(dp=1, fsdp=-1)``: FLAGSHIP, the global batch of (c)) through
    (j)'s schedule of worlds 1→2→1.  Each resize's planned ``bytes_moved``
    against the bytes its broadcasts sent, and the full parameters bitwise
    the same before and after it; each rank's resting state on the world of
    2 (its blocks of the parameters and of Adam's moments, and
    ``torch.cuda.memory_allocated``) against the replicated trainer's, every
    sharded leaf holding exactly half its bytes; the collective census of a
    step by mesh axis; step times by rank (not a scaling figure); each
    live rank launching every flash kernel once per layer a step and one
    standing by none; every loss within ``WORLD_LOSS_ATOL`` of the
    one-rank control.
(m) Megatron tp: two spawned ranks share the card over gloo
    (``entry.flagship_tp_world``: FLAGSHIP laid out by its partition specs
    over ``MeshSpec(tp=-1)``, the global batch of (c)) through (j)'s
    schedule of worlds 1→2→1.  On the world of 2 each rank holds half of
    every matrix (the attention and MLP weights by heads and hidden
    columns, embed and lm_head by vocabulary) and of its Adam moments, and
    the whole norms; the flash kernels see 4 query and 1 kv head a rank
    (checked at that shape in (f)).  Gates: every split leaf and moment at
    exactly half its bytes on each rank of 2; the norms bitwise equal
    across the ranks after every world-2 step; the whole params bitwise
    kept through each resize; each resize's broadcast bytes the plan's
    ``bytes_moved`` less Adam's 4-byte count at most; every loss within
    ``WORLD_LOSS_ATOL`` of the one-rank control; each live rank launching
    every flash kernel once per layer a step and one standing by none; a
    world-2 step's census tp all-reduces alone (its count printed).
(n) ``entry.dryrun_multichip(2)``, ``(4)``, ``(8)`` and ``(16)`` on the
    card: n ranks share it over gloo and take one step of TINY placed by
    its partition specs (fsdp 2, dp2×fsdp2, dp2×fsdp2×tp2,
    dp2×fsdp2×tp2×sp2, the last ringing 16-token chunks over sp), the four
    sizes at once, each printing its ``DRYRUN_COMM`` line and where its
    ranks' seconds went.
(o) the sharded lineage.  (o-1): (k)'s job on fsdp trainers
    (``entry.flagship_virtual_world`` with ``param_sharding="fsdp"`` and
    ``MeshSpec(dp=1, fsdp=-1)``, world 2 being fsdp 2): each save gathers
    the whole state leaf by leaf to rank 0's host memory; the kill after
    step 9, the restore on fresh fsdp trainers and steps 10-12.  Gates: the
    12 losses bitwise (k)'s control, every row once, 8 launches of each
    flash kernel a layer a step on a live rank and none on one standing by,
    and a torn newest step falling back to 9 on both ranks.  (o-2): a tp-2
    trainer (two ranks, FLAGSHIP's partition specs) and a world-1
    replicated trainer (this process) restore step 12: gathered, each
    holds the fsdp job's final params and Adam moments bitwise, with its
    count and step; each takes step 13, the tp loss within
    ``WORLD_LOSS_ATOL`` of the world-1 one; and the world-1 trainer's save
    of that state has the fsdp run's manifest fingerprint.  (o-3): a
    FLAGSHIP ``DecodeFleet`` from seed-0 weights reloads the lineage's
    newest step, and four prompts decode as on a fresh fleet built from the
    restored weights; ``watch_lineage`` ships the world-1 trainer's step 13
    within ``LINEAGE_PICKUP_S`` while sessions decode, dropping none; a
    step with a forged manifest is skipped and counted.  Prints the
    gather's census bytes, time and peak ``memory_allocated``, the sharded
    save's ``save_ms``, GB/s and ``save_async`` pause beside (k)'s, each
    ``restore_ms`` and the fleet's ``reload_ms``.
(p) the SDC defense plane on (k)'s job (``entry.flagship_virtual_world``),
    ``SDC_STEPS`` steps against (k)'s one-process control, each run with an
    ``SdcPlane`` (device-fold fingerprints, the anomaly gate, a shadow
    recompute on a fresh world-1 trainer).  (p-1): one process, a
    checkpoint every ``SDC_CKPT_EVERY`` steps, ``flip_param_bits`` on the
    final norm's first scale after step ``SDC_STRIKE_STEP`` (bit 30 makes it
    inf or NaN, so the next loss is NaN): the gate trips, the shadow
    confirms, the loop rolls back to the last verified step and replays;
    losses bitwise the control's, every row once, a flight record with the
    verdict trail.  (p-2): ``PoisonLoss`` refuted, no rollback, the repaired
    loss bitwise the control's.  (p-3): two one-rank workers in this
    process sharing a ``MemoryKV``; ``CorruptGradient`` strikes one, the
    fingerprints split, the shadow names and quarantines it, and both
    trajectories are the control's.  (p-4): two spawned ranks on a
    replicated world of 2 over gloo; the flip lands on both replicas, rank
    0 judges, both ranks take one verdict and roll back to one step, both
    bitwise the control's.  (p-5): the same ranks, fresh trainers on a
    world of 1: ``prewarm([2])``, ``prewarm_quiesce()``, ``resize(2)`` is a
    prewarm hit, and the state after it is bitwise a cold ``resize(2)``'s.
    Also checks the device fold against the host fold on every leaf of the
    state, and prints the fingerprint's step-loop pause by each
    fold, the shadow's and the rollback's ms, both resizes' ``compile_ms``
    and the flash launches a step.

(q) the control plane's elastic job: two spawned ranks share the card over
    gloo (``entry.flagship_local_job``: the FLAGSHIP trainer, replicated,
    and on rank 0 a ``PyCoordService``, a ``FakeCluster`` of two one-card
    nodes, the ``TrainingJob`` and 8 leased tasks of one global batch of 16
    x 1024 each).  ``LocalElasticJob`` runs on both ranks: rank 0 reads the
    pods, leases the batch and broadcasts one frame a step; the harness
    turns the dial 1 → 2 after step 3 and 2 → 1 after step 6, and after
    step 2 a second lease holder takes a task and dies
    (``release_worker``).  Gates: every task trained once and the queue
    drained; the worlds following the dial with 2 resizes and no deferred
    step; every loss within ``WORLD_LOSS_ATOL`` of a one-rank control fed
    rank 0's batches in its order; 8 launches of each flash kernel a step
    on a live rank and none on one standing by.  Then the virtual drive
    (``virtual=`` (k)'s config and shard stream) for 4 steps with the dial
    turned to 2 after step 2: its losses bitwise (k)'s control's, no row
    duplicated or missing, 8 launches a layer a step on a live rank.  Prints
    step ms by world, the lease-and-broadcast ms of each step, each resize's
    ``compile_ms``, ``reshard_ms`` and ``bytes_moved``,
    ``resize_deferred_steps`` and ``prewarm_hits``.
(r) BERT-base MLM at tp 2: two spawned ranks share the card over gloo
    (``entry.bert_tp_world``: BERT-base laid out by its partition specs
    over ``MeshSpec(tp=-1)``, 32 x 512, adamw(3e-4)) for 3 steps.  Gates:
    every split leaf and its Adam moments at exactly half their bytes on
    each rank; the norms and losses bitwise equal across the ranks after
    every step; the losses within ``WORLD_LOSS_ATOL`` of a world-1 control
    from the same weights and batch; 12 launches of each flash kernel a
    step on each rank.

(s) the multi-process elastic job: the port's native coordinator server
    (``edl_tpu_torch.coord.server.spawn_server``, its binary built from
    ``edl_tpu_torch/coord/native`` under ``build/edl_tpu_torch/``) and
    supervisors ``python -m edl_tpu_torch.runtime.multihost_worker --model
    transformer --model-config flagship --n-layers MH_LAYERS --device
    cuda:0`` sharing the card, each world child an ``ElasticTrainer`` over
    a gloo group of the epoch's members (one card for every rank means
    gloo).  FLAGSHIP's width at ``MH_LAYERS`` layers (each generation's
    save and restore of the whole state bound the phase's time; adam 3e-3,
    the reference task's), ``MH_TASKS`` leased tasks of 8 x 1024 seeded
    successor tokens through the port's ``ShardRegistry``, a generation every
    ``MH_CKPT_EVERY`` steps: w0 and w1 form a world of 2, w1 is SIGKILLed
    after w0's step ``MH_KILL_AFTER`` (its world child dies with it), w0
    reforms a world of 1 from the newest generation, w2 joins and a world of
    2 forms again, until the queue drains.  Gates: every task done once and
    ``all_done`` (the server's ``stats()``); worlds 2, 1, 2 with the members
    the plans name; the reformed world's parameters CRC32 and step equal
    to the newest generation the world of 2 saved (at most
    ``MH_CKPT_EVERY`` steps lost), the joiner's equal to the generation at
    w0's last world-1 step, neither the cold init's; every
    loss finite; each trained step of a world child launching every flash
    kernel once a layer; the supervisors reporting CUDA never initialised.
    Prints each world's ``world_phases``, the kill to the reformed world's
    first step, the steps lost, each generation's save ms and bytes, step
    ms by world and the server's ``server_metrics()``.

(t) the autoscaled job under a seeded fault campaign: two spawned ranks
    share the card over gloo (``entry.flagship_controlled_job``: the
    FLAGSHIP trainer at ``DURABLE_LAYERS`` layers, replicated; on rank 0
    the port's native coordinator with a state file behind a ``ChaosProxy``, a ``CoordClient`` dialling
    the proxy, a ``FakeCluster`` of two one-card nodes in two NVLink
    domains with a system pod holding the second card, a ``Controller``
    (``max_load_desired`` 1.0, 50 ms loops) that created the job's pods, and
    an ``ElasticCheckpointer``; 24 leased tasks of 16 x 1024 seeded
    tokens).  ``entry.controlled_campaign`` runs the ``LocalElasticJob``
    while a ``FaultPlanEngine`` in rank 0's ``on_step`` fires
    ``FaultPlan.random(CONTROLLED_SEED)`` over the eight training kinds:
    the coordinator SIGKILLed and respawned from its state file (the proxy
    retargeted), a trainer pod killed, a network flake through the proxy,
    a whole NVLink domain preempted, the newest checkpoint torn, a full
    disk, and a stalled step and a wedged collective, each wedging rank
    0's loop until a ``StallWatchdog`` (floor 1 s, paused over saves and
    the restore) detects it.  The system pod goes after step
    ``CONTROLLED_RELEASE_AT`` and comes back after ``CONTROLLED_RETURN_AT``;
    no line calls ``update_trainer_parallelism``.  Gates: every kind fired
    and the watched recoveries completed; the torn step's fallback restore
    verified; each stall detected within 2x the deadline then in force;
    the coordinator's ``done`` the task count, ``todo``, ``leased`` and
    ``dropped`` 0, after the kill and the respawn; world 2 after the
    release and 1 after the return; losses within ``WORLD_LOSS_ATOL`` of
    a one-rank control fed rank 0's batches in its order;
    ``DURABLE_LAYERS`` launches of each flash kernel a step on a live rank
    and none on one standing by;
    no coordinator left running.  Prints step ms by world, each autoscaler
    tick's target and its tick-to-resize seconds, each resize's
    ``compile_ms``, ``reshard_ms`` and ``bytes_moved``, each fault's
    fire-to-recovery seconds, the coordinator's respawn and each save's ms.

(u) the single-shot serving plane under its SLO control loop:
    ``entry.flagship_scoring_fleet`` (FLAGSHIP, seed-0 weights, batches of
    ``SCORE_BATCH`` rows of 1 024 tokens, the next-token logits of each
    row, 8 flash forward launches a serve iteration) behind a
    ``Controller`` whose ``ServingScaler`` reads ``fleet.stats`` and hints
    ``fleet.hint``, over a ``FakeCluster`` of two one-card nodes; the
    harness sets the fleet to the job's Running server pods every
    ``SCORE_FOLLOW_S``.  One replica's closed-loop capacity C (rows/s,
    saturated), then seeded Poisson traffic: steady at a quarter of C, a
    burst at three quarters (the QPS target of C/2 a replica plans 2
    replicas, built from the hint), a rolling reload onto generation 2
    mid-burst (one step of a FLAGSHIP trainer saved to an
    ``ElasticCheckpointer`` lineage, taken by ``reload_from_lineage``), and
    a trickle at a tenth of C until the policy drains the fleet to 1 (a
    window with no request decides nothing, by the reference's rule).
    Both replicas share the card: the phase proves the protocol, not
    added capacity.  Gates: no request dropped, failed or timed out; the
    plans 1 -> 2 and 2 -> 1; a prewarm hit; ``serving-gen/<job>`` reading
    2 in the fleet's ``PyCoordService``; 8 answers completed before the
    reload and 8 submitted after it held by (d)'s rule to the plain
    attention path's last-token logits on their generation, another row's
    logits as the control; 8 flash forward launches for every forward the
    fleet ran and no backward launch.  Prints C, p50/p99 by traffic phase,
    rows per iteration, a serve iteration's device ms, each replica's
    build ms and the reload's ms.  Then ``serve_main`` as a pod runs it, in
    a subprocess on the card (``mlp:16,64,4``, the legacy front door, a
    lineage watched every 0.5 s): ``/healthz`` 200, 64 ``/predict`` rows
    equal to the plain MLP within 1e-5, generation 2's answers within
    ``SERVE_MAIN_PICKUP_S`` of its save, and exit 0 on SIGTERM;
(v) the serving data plane: the port's native coordinator, two replica
    processes of ``entry.flagship_frontdoor_replica`` on the card
    (FLAGSHIP at 8 layers, batches of ``FD_BATCH``, seed-0 weights as
    generation 1), each behind a ``ChaosProxy`` whose address it publishes
    to ``serving-addr/<job>/``, and a ``ServingLB`` discovering them; the
    clients are ``FD_CLIENTS`` keep-alive connections pipelining raw-f32
    rows of 1 024 token ids, every answer held by (d)'s rule to its row's
    plain-path logits on generation 1 or 2.  Windows: the capacity C
    through the LB (closed loop), one door alone at C/4, steady at C/2,
    a reload (generation 2 from a lineage, ``POST /admin/reload`` to r0,
    routed around), the five serving fault kinds of
    ``FaultPlan.random(FD_CHAOS_SEED, kinds=SERVING_KINDS)`` through the
    proxies (the gray in its corrupt mode: wrong-nonce echoes with garbage
    bodies), and r1 SIGKILLed (rescued onto r0), all at C/2.  Gates: no
    wrong payload; errors at most ``FD_ERROR_SHARE`` of the chaos window
    and none in the others; each kind injected and recovered once; the
    LB's nonce check caught at least one corrupt answer; each breaker
    closed → open → half-open → closed; 8 flash forward launches a
    forward in each replica (r1's read idle before the kill window; its
    launches up to the SIGKILL are what the kernels line counts), no
    backward; sampled answers of each
    generation straight from a door within (d)'s rule, another row's
    failing it.  While the replicas build: ``/generate`` over one socket
    to a ``FleetApp`` on ``flagship_decode_fleet`` (8 sessions, tokens
    equal to the same fleet's undisturbed greedy tokens, no session
    failed), and ``serve_main`` on its async front door (u-2's drill with
    rows also pipelined over one socket).  Prints C, p50/p99 a window
    through the LB and through the door alone, hedges, rescues and sheds,
    each replica's build and ready seconds, and the reload's ms.
(w) sequence parallelism: two ranks share the card over gloo
    (``entry.flagship_sp_world``: FLAGSHIP, replicated, every world
    ``MeshSpec(sp=-1)``, a global batch of 4 x 4 096 tokens, each rank of
    sp 2 training its 2 048-token chunk of every sequence through the
    flash ring, its hops staged through host memory), a warm-up and 3
    timed steps on sp 2, ``resize(1)`` and a step on world 1 (rank 1
    standing by; the flash kernels on the whole sequence), ``resize(2)``
    and a step.  Gates: every loss finite and within ``WORLD_LOSS_ATOL`` of
    a world-1 control (the same steps from the same init in this process);
    the params bitwise equal across the ranks after each sp-2 step and
    bitwise kept through each resize, the grow's broadcasts the plan's
    ``bytes_moved`` less Adam's count; rank r launching each flash kernel
    (r + 1) x 8 times an sp-2 step (the chunk above the diagonal launches
    nothing), 8 on world 1 and none standing by; the census of an sp-2 step
    on each rank 64 sp collective-permutes of the bytes the ring sends and
    one all-reduce; each rank's peak memory over a step's start below the
    control's.  Then one layer's attention at the step's shapes through the
    flash ring, held to the same ring on the kernels' plain versions by the
    kernels' rule and to the plain ring in fp32 by (d)'s rule (the plain
    ring in bf16 beside it), each ring timed.

(x) Train+serve card arbitration: two ranks sharing the card over gloo
    train FLAGSHIP as (t)'s leased job (``entry.flagship_arbitrated_job``),
    and rank 0 also holds the arbitration plane (a Controller planning by
    the goodput objective over the curves in the native coordinator, its
    scraper) and the FLAGSHIP scoring fleet of (u), whose replicas are
    threads outside the trainer's process group; ``entry.
    arbitrated_campaign`` drives both on a FakeCluster of three one-card
    nodes.  The trainer's curve gets world 1's and world 2's median
    tokens/s (the planner grows it to 2 when node1's card frees), the
    fleet is submitted as an arbitrated ServingJob of 1 to 2 replicas at
    the closed-loop capacity C, and Poisson windows of C/4, 1.25 C and C/10
    follow.  Gates: every tick after both curves plans in mode goodput and
    re-plans equal on its recorded inputs; at most 3 cards granted, no
    world below its min, nothing left pending; the trainer's worlds go
    1 -> 2 -> 1 and the fleet 1 -> 2 by a rebalance plan; the fleet's
    uid is observe_only in the SLO policy, which actuates nothing and
    hints at least once; the losses within 2e-2 of a one-rank control,
    each leased task once, 8 launches of each flash kernel a live step and
    8 forward launches a fleet forward; no request lost; the sampled
    answers within (d)'s rule and another row's outside it; the scraped
    qps within X_QPS_RTOL and p99 within one bucket of the fleet's own
    stats; a burn-rate alert within 2 evaluations of an injected SLO
    breach and a target-down alert within 3 due sweeps of the fleet's
    /metrics going away; no coordinator left.
(y) the deployed control plane: a FLAGSHIP ``TrainingJob`` (fault
    tolerant, 1 to 2 trainers of one ``nvidia.com/gpu``, (s)'s supervised
    worker and its ``EDL_MH_*`` settings at ``MH_LAYERS`` layers, the
    kernels' build root the script's own through ``EDL_COMPILE_CACHE``)
    written as a JSON manifest, checked by ``cli validate`` and loaded by
    ``load_manifest_file`` with ``yaml`` and ``kubernetes`` unimportable,
    then run by ``entry.kubelet_campaign``: an in-memory CR store
    (:class:`CrStore`), a ``TrainingJobSyncLoop`` polling it, a
    ``Controller`` on a ``FakeCluster`` of one node of two
    ``nvidia.com/gpu`` and a ``ProcessKubelet`` running its pods as real
    process groups.  The two cards are bookkeeping for the one card: every
    world child runs on ``cuda:0`` over gloo, as in (s).  Gates: the
    spawned pods run the jobparser's ``edl_tpu_torch`` modules and nothing
    of the JAX package; world 1 trains; the autoscaler, started then, grows
    the job to 2; a ``KillTrainer`` through the kubelet SIGKILLs one
    trainer pod's group, the reaper reports it Failed, the Job controller
    replaces it and a world of 2 forms again, each world starting bitwise
    from the newest generation saved before it; a ``KillCoordinator``
    through the kubelet kills the coordinator pod, which respawns on its
    per-job state file; every task done once; the surviving workers done,
    their pods Succeeded (exit 0) and the CR's recorded status Succeeded;
    every loss finite and falling; each trained step of a world child
    launching each flash kernel ``MH_LAYERS`` times; deleting the CR tears
    the job down through the sync loop, no pod process group left; the
    card's free memory back.  Beside the job, ``python -m
    edl_tpu_torch.examples.train_ft --device cuda:0`` (word2vec on the
    shipped corpus, no hand-written kernel) trains and its loss falls.
    Prints the submit → world 1's first step, the grow tick → world 2's
    first step, the kill → the re-formed world's first step and the
    coordinator kill → the next completed task seconds, the ``cli``
    status and list tables after the grow and at the end, and (y)'s wall.
(z) serving replicas wider than one card: FLAGSHIP's scoring forward
    (``entry.score_last_token``, the flash forward) through
    ``flagship_scoring_fleet(chips_per_replica=2)`` over the card named
    ``WIDE_SLOTS`` times, each replica two rank processes forked from the
    fork server (``serving.wide_replica_rank``) sharing the card over gloo,
    the batch split between them, rank 0 broadcasting each batch from the
    fleet's pipe.  ``WIDE_ROWS`` seeded rows held to a world-1
    ``ElasticServer`` in this process by the kernels' rule; then Poisson
    traffic at ``WIDE_SHARE`` of (u)'s C through ``hint(2)``,
    ``scale_to(2)`` (four rank processes), ``rolling_reload`` onto
    generation 2 (seed ``WIDE_GEN2_SEED``), a SIGKILL of one rank of the
    first replica and ``scale_to(1)``.  Gates: every answer within (d)'s
    rule of its row's plain logits on the generation it may come from; no
    request lost but the killed replica's, each failing as
    ``ReplicaRankDied`` within ``WIDE_FAIL_S``; the replica stopped, the
    dead one pruned, no rank process left; each rank's flash forward
    launches 8 a forward, no backward.  Then a heads-sharded FLAGSHIP
    ``DecodeFleet(devices_per_replica=2)`` (two shards on the card) on
    (i)'s traffic, token-equal to (i)'s one-device fleet, its
    ``per_device_used_bytes`` and ``kv_reserved_bytes_per_device`` printed
    and held to halves of the pool; and one decode step of 8 slots over
    the split pool, logits equal to one device's, with the bytes that
    cross to the other shard and both steps' device ms.
(aa) LLAMA3_8B's width (d 4 096, 32/8 heads of 128, d_ff 14 336, vocab
    32 000) at ``L8B_LAYERS`` layers (the cut: 32 → 4), remat and adamw
    on: one world-1 ``ElasticTrainer`` through ``entry.flagship_trainer``,
    one row of ``L8B_SEQ`` tokens, a warm-up and ``L8B_TIMED`` timed
    steps.  Gates: the first loss finite and within 1 of ln 32 000 + 1
    (``L8B_INIT_EXCESS``: random targets under the He-initialized lm_head);
    the bytes of the parameters and of Adam's moments on the card, counted
    from the tensors, ``models.planning.fsdp_memory_plan(cfg, 1)``'s to the
    byte; each step launching the flash forward twice a layer (remat
    recomputes it) and each backward kernel once; an H100 80GB's
    ``total_memory`` ``planning.H100_MEMORY_BYTES``.  Prints the step ms,
    tokens/s, ``max_memory_allocated`` and ``total_memory``.

Each phase prints its wall seconds (``phase (x) wall_s``), and a ``phase
seconds`` line sums them with the build's.

Each path runs with the launch counts set to 0 just before it and read just
after ((s)'s and (y)'s world children, (v)'s replicas and (z)'s rank
processes are fresh processes, each counting from 0).  Each kernel is held to the element-wise rule of
``edl_tpu_torch/ops/kernel_check.py``; ``python -m
edl_tpu_torch.ops.kernel_check`` shows that faults planted in the kernels
fail it.

Prints the card's name and power limit, one JSON line of kernels, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, with no result, when
there is no CUDA device.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import io
import itertools
import json
import math
import os
import random
import re
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from edl_tpu_torch.entry import (ARBITRATION_BATCH, ARBITRATION_DOWN_AFTER,
                                 ARBITRATION_FLEET_JOB, ARBITRATION_LOOP_S,
                                 ARBITRATION_QUEUE_MS, ARBITRATION_ROWS,
                                 ARBITRATION_SCRAPE_S, ARBITRATION_SHARDS,
                                 ARBITRATION_SLO_MS,
                                 ARBITRATION_TARGET_SHARE,
                                 ARBITRATION_WINDOW_S, CONTROLLED_ROWS,
                                 CONTROLLED_SHARDS, DECODE_DEFAULTS,
                                 VIRTUAL_ROWS, arbitrated_campaign,
                                 flagship_arbitrated_job,
                                 VIRTUAL_SHARDS, bert_tp_world, bert_trainer,
                                 controlled_campaign, dryrun_multichip, entry,
                                 flagship_controlled_job,
                                 flagship_decode_fleet, flagship_elastic_world,
                                 flagship_local_job, flagship_scoring_fleet,
                                 flagship_sp_world, flagship_tp_world,
                                 flagship_trainer,
                                 flagship_virtual_world, kubelet_campaign,
                                 kubelet_job_manifest, log_field,
                                 rank_processes, step_records,
                                 resnet_trainer, score_last_token)
from edl_tpu_torch.models import llama, resnet
from edl_tpu_torch.models import transformer as tfm
from edl_tpu_torch.observability.collector import get_counters
from edl_tpu_torch.observability import metrics
from edl_tpu_torch.observability.metrics import get_registry
from edl_tpu_torch.parallel.mesh import MeshSpec
from edl_tpu_torch.runtime import checkpoint as ckpt
from edl_tpu_torch.runtime import serving
from edl_tpu_torch.runtime.checkpoint import ElasticCheckpointer
from edl_tpu_torch.runtime.elastic import AccumulationAborted
from edl_tpu_torch.runtime.faults import (SERVING_KINDS, TRAINING_KINDS,
                                          CorruptGradient, FaultContext,
                                          FaultPlan, FaultPlanEngine,
                                          PoisonLoss)
from edl_tpu_torch.runtime import sdc
from edl_tpu_torch.observability.tracing import get_tracer
from edl_tpu_torch.runtime.kvcache import KVBlockPool
from edl_tpu_torch.runtime.multihost import free_port
from edl_tpu_torch.runtime.virtual import (DEFAULT_LOSS_ATOL,
                                           DEFAULT_LOSS_RTOL, VirtualBatches,
                                           VirtualConfig, VirtualWorkerLoop,
                                           loss_divergence,
                                           trajectories_equivalent)
from edl_tpu_torch.runtime.watchdog import StallWatchdog
from edl_tpu_torch.ops import _build
from edl_tpu_torch.ops import flash_attention as fa
from edl_tpu_torch.ops import group_norm as gn
from edl_tpu_torch.ops import kernel_check as kc

#: H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside the
#: tensor cores, and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
#: FLAGSHIP attention at bench.py's accelerator batch
B, S, H, HK, D = 16, 1024, 8, 2, 128
#: BERT-base attention at bench.py's model-zoo batch
BERT_B, BERT_S, BERT_H, BERT_D = 32, 512, 12, 64
#: ResNet-50 at bench.py's model-zoo batch
RESNET_B, RESNET_HW = 256, 224
WARMUP_STEPS, TIMED_STEPS = 1, 5
KERNEL_ITERS, PLAIN_ITERS = 20, 3
#: phase (e): the largest cluster every Hopper part runs; a plan past it is
#: also timed capped at it
PORTABLE_CLUSTER = 8
#: cuda_ms: ~10 ms at the H100's 1.98 GHz boost clock, far longer than the
#: host takes to queue KERNEL_ITERS calls of any kernel timed here
QUEUE_SLEEP_CYCLES = 20_000_000
#: phase (d): the logits of the flash and reference attention paths of the
#: bf16 model, element by element: |flash - reference| <= 2^-7 |reference|
#: + MODEL_ATOL * rms(reference).  The two paths round the attention
#: output at different points and the difference grows through 8 layers.
#: The floor sits between what the two paths need and what the model with
#: its attention output zeroed needs; phase (d) prints both (on an H100,
#: below 0.2 and above 7 rms)
MODEL_ATOL = 0.5
#: phase (g): the same rule for the ResNet-50 logits of the GroupNorm
#: kernels against the plain versions.  Both round at the same points; they
#: differ where an fp32 sum taken in another order moves a rounding, and
#: that grows through 53 norms.  Phase (g) prints the floor each side needs
RESNET_MODEL_ATOL = 0.25
#: phase (g)'s small input
RESNET_CHECK_BATCH = 4
#: arithmetic of each GroupNorm kernel per element (fp32, outside the
#: tensor cores): forward x·x, two sums, x·p + q; backward dy·x, two sums,
#: dy·p − x·q + r
GN_OPS_PER_ELEMENT = {"group_norm_fwd": 5, "group_norm_bwd": 7}
#: phase (i): the logits check's prompts, and the traffic of the resize
#: and speculative checks (prompt lengths uniform in SERVE_PROMPT_LENS)
LOGITS_PROMPTS, LOGITS_PROMPT_LEN, LOGITS_STEPS = 3, 256, 16
SERVE_SESSIONS, SERVE_NEW_TOKENS, SERVE_PROMPT_LENS = 16, 64, (64, 512)
SPEC_TOKENS = 4
#: phase (i): the paged logits against transformer.apply's, by the rule of
#: check_against.  The two round K/V and the attention output at other
#: points (bf16 cache, fp32 paged attention).  The floor sits between what
#: the two paths need and what the control (another session's context)
#: needs; phase (i) prints both (on an H100: 0.1445 and 7.28 rms)
SERVING_ATOL = 0.25
#: phase (i): a decode step or prefill chunk is ~550 launches, which take
#: the host 10-30 ms to queue; the card's launch queue holds about one
#: call's worth, so a timed call is one call behind a ~0.1 s device sleep,
#: and the record the median of SERVE_TIMED_REPS of them
SERVE_TIMED_REPS, SERVE_SLEEP_CYCLES = 5, 200_000_000
#: phase (j): the ranks sharing the card, the world each step runs on (the
#: trainer resizes where it changes), and each rank's time limit
WORLD_RANKS = 2
WORLD_SCHEDULE = (1, 1, 2, 2, 1, 1)
WORLD_CHILD_TIMEOUT_S = 600
#: phase (j): |loss - one-rank control's loss| for every step.  A world of
#: 2 splits the batch and averages two half-batch gradients, so its bf16
#: loss and every step after it drift from the control's in their last
#: digits (losses ~9.7); the world-1 steps before the first resize run the
#: control's exact computation
WORLD_LOSS_ATOL = 2e-2
#: phase (l): the fsdp trainer's layout (every rank on the fsdp axis)
FSDP_SPEC = MeshSpec(dp=1, fsdp=-1)
#: phase (n): the dryrun's sizes, the reference's layouts for each
DRYRUN_SIZES = (2, 4, 8, 16)
#: phase (k): steps of the job, its checkpoint cadence, the step the first
#: loop stops at (the kill lands in the next one), the stall watchdog's
#: deadline floor, and the ranks' join deadline
VIRTUAL_STEPS = 12
VIRTUAL_CKPT_EVERY = 3
VIRTUAL_KILL_AFTER = 9
VIRTUAL_STALL_FLOOR_S = 30.0
VIRTUAL_CHILD_TIMEOUT_S = 900
#: phase (k)'s micro-batch: the global batch B over the job's 8 virtual
#: workers (entry.flagship_virtual_world's defaults); the flash kernels
#: are held against their plain versions at this batch too
VIRTUAL_MICRO_BATCH = B // 8
#: phase (o-2): the tp trainer's layout, (m)'s
TP_SPEC = MeshSpec(tp=-1)
#: phase (o-3): the prompts decoded on the reloaded and a fresh fleet and
#: their new tokens; the watcher's poll, the seconds it may take to ship a
#: step once saved, and the sessions kept decoding meanwhile (a new one
#: submitted whenever fewer are in flight)
LINEAGE_PROMPT_LENS, LINEAGE_NEW_TOKENS = (64, 192, 320, 512), 32
LINEAGE_POLL_S, LINEAGE_PICKUP_S = 0.5, 5.0
WATCH_SESSIONS, WATCH_PROMPT_LEN, WATCH_NEW_TOKENS = 4, 64, 256
#: phase (p): steps of each drill, the checkpoint cadence, the step after
#: which a strike lands (the next step is the first to carry it), and the
#: flip: bit 30 of the final norm's first scale (the last leaf in flatten
#: order), the exponent's top bit of a value near 1.0, which makes it inf
#: or NaN; the fingerprint pauses are each the median of SDC_PAUSE_REPS
SDC_STEPS, SDC_CKPT_EVERY, SDC_STRIKE_STEP = 5, 3, 4
SDC_FLIP = dict(leaf=-1, bit=30)
SDC_PAUSE_REPS = 3

#: phase (q): after step k the harness turns the trainer count to
#: LOCAL_DIAL[k]; after step LOCAL_GHOST_AT a second lease holder takes a
#: task and dies; the virtual drive's steps and its dial
LOCAL_DIAL = {3: 2, 6: 1}
LOCAL_GHOST_AT = 2
LOCAL_VIRTUAL_STEPS = 4
LOCAL_VIRTUAL_DIAL = {2: 2}
#: phase (r): the steps at tp 2, and BERT-base's layers (one launch of each
#: flash kernel a layer a step)
BERT_TP_STEPS = 3
BERT_LAYERS = 12
#: phase (s): the job's leased tasks (each one rank's local batch of
#: MH_ROWS x S tokens, so a world-2 step trains (j)'s 16 x 1024), the step
#: of w0's after which w1 is killed, the generation cadence, each step's
#: pause (paces the job so the kill and the join land mid-job), the
#: member TTL and task timeout of the server (a dead member is pruned, and
#: its leased task dispatched again, after them), the process groups'
#: rendezvous and collective timeout (the stall watchdog's floor too), and
#: the whole job's deadline
MH_TASKS, MH_ROWS = 32, 8
MH_KILL_AFTER, MH_CKPT_EVERY, MH_STEP_SLEEP_S = 4, 2, 0.25
MH_MEMBER_TTL_MS, MH_TASK_TIMEOUT_MS = 3000, 5000
MH_GROUP_TIMEOUT_S, MH_TIMEOUT_S = 120, 420
#: (s)'s FLAGSHIP depth (its time is bound by each generation's save and
#: restore of the whole state)
MH_LAYERS = 2

#: phases (k), (o), (p) and (q)'s virtual drive: the FLAGSHIP width at
#: DURABLE_LAYERS layers (their time is bound by saving and restoring the
#: whole state, which the depth sets; the width, the shapes every kernel
#: sees, stays FLAGSHIP's); (t) too, which took 32-52 s less at 2 layers
#: than at 8 on one NVIDIA H100 80GB HBM3 at 700 W (PERF.md)
DURABLE_LAYERS = 2
DURABLE_CFG = dataclasses.replace(tfm.FLAGSHIP, n_layers=DURABLE_LAYERS)

#: phase (t): the campaign's seed and schedule (eight faults between steps
#: CONTROLLED_FIRST and CONTROLLED_LAST at least CONTROLLED_GAP apart), the
#: checkpoint cadence, the steps after which the system pod gives the
#: second card back and takes it again, and the phase's deadline
CONTROLLED_SEED = 11
CONTROLLED_FIRST, CONTROLLED_LAST, CONTROLLED_GAP = 3, 20, 2
CONTROLLED_SAVE_EVERY = 4
CONTROLLED_RELEASE_AT, CONTROLLED_RETURN_AT = 5, 14
CONTROLLED_TIMEOUT_S = 600

#: phase (u): the scoring fleet's batch and admission window, the QPS
#: target of a replica (a share of the measured capacity C), the lax p99
#: objective (two replicas share one card), the scaler's loop and
#: down-cooldown, the harness's pod-following period, the seconds of each
#: traffic phase and its rate as a share of C, the fleet's stats window,
#: and the sampled answers before and after the reload
SCORE_BATCH, SCORE_QUEUE_MS = 8, 2.0
SCORE_TARGET_SHARE, SCORE_SLO_MS = 0.5, 1000.0
SCORE_LOOP_S, SCORE_DOWN_COOLDOWN_S, SCORE_FOLLOW_S = 0.25, 3.0, 0.05
SCORE_CAPACITY_S, SCORE_WINDOW_S = 2.0, 2.0
SCORE_PHASES = (("steady", 0.25, 3.0), ("burst", 0.75, 5.0))
SCORE_TRICKLE_SHARE, SCORE_DRAIN_TIMEOUT_S = 0.1, 20.0
SCORE_SAMPLES = 8
#: phase (u-2): serve_main's model, its rows, the lineage poll and how
#: long generation 2 may take to show in the replies
SERVE_MAIN_MODEL, SERVE_MAIN_ROWS = (16, 64, 4), 64
SERVE_MAIN_POLL_S, SERVE_MAIN_PICKUP_S = 0.5, 5.0
SERVE_MAIN_TIMEOUT_S = 120
#: phase (v): the data plane's job, its two replica processes, their batch,
#: the load's keep-alive connections and closed-loop depth a connection,
#: the client rows (their plain-path answers are computed for both
#: generations, so every answer is checked), the seconds of the capacity,
#: door-alone and steady windows, the reload and kill windows and when in
#: them the event fires, the serving chaos plan (steps are deciseconds of
#: the window) with its deadline and error budget, the /generate sessions,
#: the sampled answers a generation, the replicas' start deadline, and the
#: LB's settings (the serving soak's breaker, but tripped by 2 errors in a
#: row, so that a partition or a connection flap on one replica trips it as
#: a gray replica trips the other's; a 5 s request timeout)
FD_JOB = "default/flagship-frontdoor"
FD_REPLICAS = ("r0", "r1")
FD_BATCH = 8  # flagship_frontdoor_replica's max_batch
FD_CLIENTS, FD_DEPTH = 4, 8
FD_ROWS = 64
FD_CAPACITY_S, FD_WINDOW_S = 2.0, 2.0
FD_RELOAD_S, FD_RELOAD_AT_S = 4.0, 1.0
FD_KILL_S, FD_KILL_AT_S = 3.0, 1.0
FD_CHAOS_SEED, FD_CHAOS_TIMEOUT_S, FD_ERROR_SHARE = 7, 30.0, 0.15
FD_CHAOS_PLAN = dict(n_faults=5, first_step=5, last_step=45, min_gap=8,
                     flake_duration_s=0.8)
FD_GEN_SESSIONS, FD_GEN_PROMPT, FD_GEN_NEW = 8, 64, 16
FD_SAMPLES = 8
FD_READY_TIMEOUT_S = 240
FD_LB = dict(pool=2, discovery_s=0.1, sweep_ms=3.0, hedge_floor_ms=25.0,
             hedge_cap_ms=250.0, request_timeout_s=5.0, breaker_errors=2,
             breaker_ratio=0.5, breaker_min=10, breaker_window_s=0.5,
             breaker_cooldown_s=0.3, breaker_probes=1)

#: phase (w): the sp job's global batch (the 16 384 tokens of (c) in
#: sequences of 4 096, each rank of sp 2 holding a chunk of 2 048), its
#: schedule (a warm-up and SP_TIMED timed steps on sp 2, then resize(1), a
#: step, resize(2), a step), and the ring hold's seed and timed repetitions
SP_B, SP_S = 4, 4096
SP_TIMED = 3
SP_SCHEDULE = (2,) * (1 + SP_TIMED) + (1, 2)
SP_HOLD_SEED, SP_HOLD_REPS = 5, 3

#: phase (x): the phase's deadline (its schedule is entry.arbitrated_
#: campaign's defaults: four live steps a world before its curve point,
#: steps paced to 0.5 s on rank 0, the scoring fleet's batch 8 and p99 SLO
#: of 1 s, a replica's QPS target 0.2 C, windows of C/4, 1.25 C and C/10),
#: and how far the scraped qps may sit from the fleet's own
X_TIMEOUT_S = 600
X_QPS_RTOL = 0.25

#: phase (y): the TrainingJob's name; its tasks (MH_ROWS x S tokens each)
#: and each step's pause, which paces world 1 so that the grown pod joins
#: mid-job; the supervisors' settle, longer than the member TTL, so that a
#: killed pod's prune and its replacement's join land in one plan; the
#: job's deadline, the example's, and the card memory the pods may leave
Y_JOB = "flagship-kubelet"
Y_TASKS, Y_STEP_SLEEP_S, Y_SETTLE_S = 18, 0.25, 4.0
Y_TIMEOUT_S, Y_TRAIN_FT_TIMEOUT_S = 420, 300
Y_MEM_SLACK_BYTES = 64 << 20
#: phase (z): ranks a wide replica (each a rank process), the card named
#: once a rank slot (two replicas of two), the rows held to a world-1
#: replica, the pool of rows the traffic draws from, its share of (u)'s
#: capacity C, generation 2's seed, the pause between the drill's steps,
#: and the seconds a killed rank's requests may take to fail
WIDE_CHIPS, WIDE_SLOTS = 2, 4
WIDE_ROWS, WIDE_ROW_POOL, WIDE_SHARE = 32, 64, 0.5
WIDE_GEN2_SEED, WIDE_SETTLE_S, WIDE_FAIL_S = 2, 1.0, 10.0
#: phase (z): the seconds the survivor may take to serve out the traffic's
#: backlog (two ranks on a shared card serve ~0.6 C; a slow host queues)
WIDE_DRAIN_S = 300
#: phase (aa): LLAMA3_8B's width at this many layers (its 32 cut for one
#: card and the script's time), one row of this many tokens, timed steps
L8B_LAYERS, L8B_SEQ, L8B_TIMED = 4, 8192, 3
#: phase (aa): what the first loss exceeds ln(vocab) by at the init: the
#: lm_head's He init (variance 2/d) on the final RMS norm's unit-RMS
#: features gives each logit variance σ² = 2, and cross entropy on random
#: targets ln(vocab) + σ²/2 (11.37 at vocab 32 000; the reference's init
#: is the same).  The gate holds the first loss within 1 of that
L8B_INIT_EXCESS = 1.0

KERNELS = {
    "flash_fwd": dict(source="edl_tpu_torch/csrc/flash_fwd.cu",
                      replaces="edl_tpu/ops/flash_attention.py:96",
                      products=2),
    "flash_bwd_dq": dict(source="edl_tpu_torch/csrc/flash_bwd.cu",
                         replaces="edl_tpu/ops/flash_attention.py:210",
                         products=3),
    "flash_bwd_dkv": dict(source="edl_tpu_torch/csrc/flash_bwd.cu",
                          replaces="edl_tpu/ops/flash_attention.py:251",
                          products=4),
    "group_norm_fwd": dict(source="edl_tpu_torch/csrc/group_norm.cu",
                           replaces="edl_tpu/ops/group_norm.py:67"),
    "group_norm_bwd": dict(source="edl_tpu_torch/csrc/group_norm.cu",
                           replaces="edl_tpu/ops/group_norm.py:128"),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
GROUP_NORM = ("group_norm_fwd", "group_norm_bwd")


def cuda_ms(fn, iters: int, sleep_cycles: int = QUEUE_SLEEP_CYCLES
            ) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls, after
    one warm-up call (CUDA events).  The card first sleeps for
    ``sleep_cycles`` while the host queues every call, so that a call
    shorter than its own launch cost on the host is timed on the card."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def roofline(flops: float, peak_flops: float, tensors) -> tuple[float, str]:
    """Least time for the work on this card (ms): the larger of its
    operations at ``peak_flops`` and its bytes (each input read once, each
    output written once) at the memory rate."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def print_ptxas_report() -> None:
    """(a): what ptxas reported for each flash and GroupNorm kernel
    instantiation.  The register count is the one a block is launched
    with; the flash kernels then move registers from their producer
    warpgroup to their consumers with setmaxnreg
    (csrc/hopper_common.cuh)."""
    for lib in ("flash_fwd", "flash_bwd", "group_norm"):
        for r in _build.ptxas_report(lib):
            print(f"ptxas {lib} {r['kernel']}: registers {r['registers']} "
                  f"static_smem_bytes {r['static_smem_bytes']} "
                  f"spill_store_bytes {r['spill_store_bytes']} "
                  f"spill_load_bytes {r['spill_load_bytes']}", flush=True)


def phase_flash(b: int, s: int, h: int, hk: int, d: int, causal_modes,
                label: str) -> dict:
    """(b) and (f): every flash kernel against its plain version at one
    shape; the timings of the first mode are the record."""
    rows = {name: {"max_abs_err": 0.0} for name in FLASH}
    dev = torch.device("cuda")
    for seed, causal in enumerate(causal_modes):
        q, k, v, do = kc.random_inputs(b * h, b * hk, s, d, seed, dev)
        readings, got = kc.compare(q, k, v, do, causal, h, hk)
        tag = f"{label} {'causal' if causal else 'full'}"
        for name, r in readings.items():
            print(f"check {name} {tag}: max |kernel - plain| "
                  f"{r['max_abs_err']:.4e}, {r['worst']:.3f} of its limit "
                  f"(floor needed {r['need_atol']:.4f} rms)", flush=True)
        failed = kc.failures(readings)
        if failed:
            raise AssertionError(f"kernels vs plain versions ({tag}): "
                                 + "; ".join(failed))
        errs = {name: max(readings[o]["max_abs_err"] for o in outs
                          if o != "lse")
                for name, outs in kc.OUTPUTS.items() if name in FLASH}
        for name, e in errs.items():
            rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)

        # timings at these inputs; the library yardstick is SDPA with GQA
        # on the [b, h, s, d] views of the same buffers
        out, lse, delta = got["out"], got["lse"], got["delta"]
        q4, k4, v4 = (x.view(b, -1, s, d) for x in (q, k, v))
        qg, kg, vg = (x.detach().requires_grad_() for x in (q4, k4, v4))
        lib_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                                 enable_gqa=True)
        do4 = do.view(b, h, s, d)
        times = {
            "flash_fwd": (
                lambda: fa.flash_forward_cuda(q, k, v, causal, h, hk),
                lambda: fa.flash_forward_plain(q, k, v, causal, h, hk),
                lambda: F.scaled_dot_product_attention(
                    q4, k4, v4, is_causal=causal, enable_gqa=True),
                (q, k, v, out, lse)),
            "flash_bwd_dq": (
                lambda: fa.flash_bwd_dq_cuda(q, k, v, do, lse, delta, causal,
                                             h, hk),
                lambda: fa.flash_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                              h, hk),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                            retain_graph=True),
                (q, k, v, do, lse, delta, got["dq"])),
            "flash_bwd_dkv": (
                lambda: fa.flash_bwd_dkv_cuda(q, k, v, do, lse, delta,
                                              causal, h, hk),
                lambda: fa.flash_bwd_dkv_plain(q, k, v, do, lse, delta,
                                               causal, h, hk),
                lambda: torch.autograd.grad(lib_out, (qg, kg, vg), do4,
                                            retain_graph=True),
                (q, k, v, do, lse, delta, got["dk"], got["dv"])),
        }
        pairs = s * (s + 1) // 2 if causal else s * s
        for name, (kern, plain, lib, tensors) in times.items():
            ms = cuda_ms(kern, KERNEL_ITERS)
            plain_ms = cuda_ms(plain, PLAIN_ITERS)
            library_ms = cuda_ms(lib, KERNEL_ITERS)
            flops = KERNELS[name]["products"] * 2.0 * b * h * pairs * d
            bound_ms, bound_by = roofline(flops, PEAK_BF16_FLOPS, tensors)
            print(f"kernel {name} {tag}: max_abs_err {errs[name]:.4e} "
                  f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by})", flush=True)
            if causal == causal_modes[0]:
                rows[name].update(ms=ms, plain_ms=plain_ms,
                                  library_ms=library_ms, bound_ms=bound_ms,
                                  bound_by=bound_by)
        del lib_out
    return rows


def run_path(label: str, trainer, batch, counters: dict, want: dict,
             unit: str, per_step_units: int) -> tuple[dict, float]:
    """1 warm-up and 5 timed steps of ``trainer`` with ``counters`` set to 0
    just before; every step must grow each counter by ``want`` and every
    loss be finite, the loss falling.  Returns (the counts just after, the
    mean timed step in ms)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    for name in counters:
        counters[name] = 0
    for i in range(WARMUP_STEPS + TIMED_STEPS):
        before = dict(counters)
        t0 = time.perf_counter()
        losses.append(trainer.step(batch))  # float(loss) waits for the step
        step_s.append(time.perf_counter() - t0)
        grown = {n: counters[n] - before[n] for n in counters}
        if grown != want:
            raise AssertionError(f"{label} step {i}: launches {grown}, "
                                 f"want {want}")
    launches = dict(counters)
    timed = losses[WARMUP_STEPS:]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not timed[-1] < timed[0]:
        raise AssertionError(f"{label}: loss did not fall: {timed}")
    step_ms = 1e3 * float(np.mean(step_s[WARMUP_STEPS:]))
    median_ms = 1e3 * float(np.median(step_s[WARMUP_STEPS:]))
    print(f"path {label}: losses {[round(x, 4) for x in losses]} "
          f"step_ms {step_ms:.2f} median_step_ms {median_ms:.2f} "
          f"(per step {[round(1e3 * x, 2) for x in step_s]}) "
          f"{unit}_per_second {per_step_units / (step_ms / 1e3):.1f} "
          f"peak_mem_gb {torch.cuda.max_memory_allocated() / 1e9:.2f} "
          f"launches {launches}", flush=True)
    return launches, step_ms


def phase_flagship() -> dict:
    """(c): FLAGSHIP train steps through ElasticTrainer with the kernels."""
    trainer, batch = flagship_trainer(B, S)
    n = trainer.state.params.cfg.n_layers
    launches, _ = run_path(f"flagship b{B} s{S}", trainer, batch,
                           fa.launches, {k: n for k in FLASH}, "tokens",
                           B * S)
    return launches


def phase_model_check() -> None:
    """(d): the entry point's logits, and the flash path's logits against
    the reference attention path's on one small input; the same model with
    every attention output projection zeroed must fail that check."""
    fn, (model, tokens) = entry()
    with torch.no_grad():
        logits = fn(model, tokens)
    if logits.shape != (2, 256, model.cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError(f"entry logits {tuple(logits.shape)} not "
                             "finite of the expected shape")
    rng = np.random.default_rng(2)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab_size,
                                         (2, 256))).cuda()
    with torch.no_grad():
        out = {}
        for use_flash in (True, False):
            model.cfg = dataclasses.replace(model.cfg, use_flash=use_flash)
            out[use_flash] = fn(model, toks)
        for layer in model.layers:
            layer.wo.zero_()
        out["no attention"] = fn(model, toks)
    check_against(out[False], out[True], out["no attention"], MODEL_ATOL,
                  "flash vs reference logits", "attention zeroed")


def check_against(ref, got, control, atol: float, what: str,
                  control_what: str) -> None:
    """``got`` must pass 2^-7·|ref| + atol·rms(ref) element by element and
    ``control`` must fail it."""
    rms = ref.float().square().mean().sqrt().item()
    r, c = (kc.reading(x, ref, kc.BF16_RTOL, atol * rms)
            for x in (got, control))
    print(f"model check: {what} max |diff| {r['max_abs_err']:.4f}, "
          f"{r['worst']:.3f} of the limit (floor needed "
          f"{r['need_atol']:.4f} rms); {control_what} {c['worst']:.3f} of "
          f"it ({c['need_atol']:.4f} rms)", flush=True)
    if not r["worst"] <= 1.0:
        raise AssertionError(f"{what}: off the reference")
    if c["worst"] <= 1.0:
        raise AssertionError(f"{what}: the check passes its control "
                             f"({control_what})")


def gn_plan(name: str, tag: str, hw: int, c: int, dtype,
            max_k: int = gn.MAX_CLUSTER) -> tuple[int, int, int]:
    """(e): one kernel's cluster plan at one site shape, printed with the
    clusters of it the card runs at once."""
    backward = name == "group_norm_bwd"
    itemsize = torch.finfo(dtype).bits // 8
    k, rows, resident = plan = gn.cluster_plan(hw, c, itemsize, backward,
                                               max_k)
    held = ("resident" if resident == (1 + backward) * rows
            else "reads rows again")
    print(f"plan {name} {tag}: k {k} rows {rows} resident {resident} "
          f"({held}) active_clusters "
          f"{gn.active_clusters(c, dtype, backward, plan)}", flush=True)
    return plan


def phase_group_norm(sites) -> dict:
    """(e): both GroupNorm kernels against their plain versions at every
    site shape of the ResNet-50 step; per-step sums over the sites."""
    rows = {name: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, library_ms=0.0,
                       bound_ms=0.0, bound_by="bytes") for name in GROUP_NORM}
    dev, groups = torch.device("cuda"), resnet.RESNET50.groups
    for seed, ((hw, c), count) in enumerate(sorted(sites.items())):
        x, dy, scale, bias = kc.gn_random_inputs(RESNET_B, hw, c, seed, dev)
        readings, got = kc.gn_compare(x, dy, scale, bias, groups)
        tag = f"[{RESNET_B},{hw},{c}] x{count}"
        plans = {name: gn_plan(name, tag, hw, c, x.dtype)
                 for name in GROUP_NORM}
        for name, r in readings.items():
            print(f"check {name} {tag}: max |kernel - plain| "
                  f"{r['max_abs_err']:.4e}, {r['worst']:.3f} of its limit "
                  f"(floor needed {r['need_atol']:.6f} rms)", flush=True)
        failed = kc.failures(readings)
        if failed:
            raise AssertionError(f"group norm kernels vs plain versions "
                                 f"({tag}): " + "; ".join(failed))
        mean, inv = got["mean"], got["inv"]
        # the yardstick: F.group_norm on the channels-last NCHW view of the
        # same memory (its parameters in x's dtype, cast before timing)
        side = math.isqrt(hw)
        nchw = (lambda t: t.view(RESNET_B, side, side, c)  # noqa: E731
                .permute(0, 3, 1, 2))
        xg = nchw(x).detach().requires_grad_()
        sg, bg = (t.to(x.dtype).requires_grad_() for t in (scale, bias))
        lib_out = F.group_norm(xg, groups, sg, bg, 1e-5)
        times = {
            "group_norm_fwd": (
                lambda plan=None: gn.group_norm_fwd_cuda(
                    x, scale, bias, groups, 1e-5, plan),
                lambda: gn.group_norm_fwd_plain(x, scale, bias, groups, 1e-5),
                lambda: F.group_norm(nchw(x), groups, sg.detach(),
                                     bg.detach(), 1e-5),
                (x, scale, bias, got["y"], mean, inv)),
            "group_norm_bwd": (
                lambda plan=None: gn.group_norm_bwd_cuda(
                    x, dy, scale, mean, inv, groups, plan),
                lambda: gn.group_norm_bwd_plain(x, dy, scale, mean, inv,
                                                groups),
                lambda: torch.autograd.grad(lib_out, (xg, sg, bg), nchw(dy),
                                            retain_graph=True),
                (x, dy, scale, mean, inv, got["dx"], got["dgamma"],
                 got["dbeta"])),
        }
        for name, (kern, plain, lib, tensors) in times.items():
            ms = cuda_ms(kern, KERNEL_ITERS)
            plain_ms = cuda_ms(plain, PLAIN_ITERS)
            library_ms = cuda_ms(lib, KERNEL_ITERS)
            if plans[name][0] > PORTABLE_CLUSTER:
                # a plan past the portable cluster size against the one
                # capped at it, which keeps dy and reads x again
                alt = gn_plan(name, tag, hw, c, x.dtype, PORTABLE_CLUSTER)
                alt_ms = cuda_ms(lambda: kern(plan=alt), KERNEL_ITERS)
                print(f"alt_plan {name} {tag}: kernel_ms {alt_ms:.4f} at k "
                      f"{alt[0]}, {ms:.4f} at k {plans[name][0]}",
                      flush=True)
            bound_ms, bound_by = roofline(
                GN_OPS_PER_ELEMENT[name] * x.numel(), PEAK_FP32_FLOPS,
                tensors)
            err = readings["y" if name == "group_norm_fwd" else "dx"][
                "max_abs_err"]
            print(f"kernel {name} {tag}: max_abs_err {err:.4e} "
                  f"kernel_ms {ms:.4f} plain_ms {plain_ms:.4f} "
                  f"library_ms {library_ms:.4f} bound_ms {bound_ms:.4f} "
                  f"({bound_by})", flush=True)
            row = rows[name]
            row["max_abs_err"] = max(row["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms),
                             ("library_ms", library_ms),
                             ("bound_ms", bound_ms)):
                row[key] += count * val
            if bound_by != "bytes":
                row["bound_by"] = bound_by
        del lib_out, xg
    for name, row in rows.items():
        print(f"kernel {name} per ResNet-50 step ({sum(sites.values())} "
              f"sites): kernel_ms {row['ms']:.4f} plain_ms "
              f"{row['plain_ms']:.4f} library_ms {row['library_ms']:.4f} "
              f"bound_ms {row['bound_ms']:.4f}", flush=True)
    return rows


@contextlib.contextmanager
def plain_group_norm():
    """Within the block, GroupNorm on the card runs its plain versions
    (``EDL_GN_PALLAS=0``)."""
    kept = os.environ.get("EDL_GN_PALLAS")
    os.environ["EDL_GN_PALLAS"] = "0"
    try:
        yield
    finally:
        if kept is None:
            del os.environ["EDL_GN_PALLAS"]
        else:
            os.environ["EDL_GN_PALLAS"] = kept


def phase_resnet(n_sites: int) -> dict:
    """(g): ResNet-50 train steps with the GroupNorm kernels, the same steps
    with the plain versions, and the logits check."""
    label = f"resnet50 b{RESNET_B} {RESNET_HW}x{RESNET_HW}"
    trainer, batch = resnet_trainer(RESNET_B, RESNET_HW)
    launches, step_ms = run_path(label, trainer, batch, gn.launches,
                                 {k: n_sites for k in GROUP_NORM}, "images",
                                 RESNET_B)
    del trainer, batch
    torch.cuda.empty_cache()
    with plain_group_norm():
        trainer, batch = resnet_trainer(RESNET_B, RESNET_HW)
        _, plain_step_ms = run_path(label + " EDL_GN_PALLAS=0", trainer,
                                    batch, gn.launches,
                                    {k: 0 for k in GROUP_NORM}, "images",
                                    RESNET_B)
    del trainer, batch
    torch.cuda.empty_cache()
    print(f"resnet50 A/B: step_ms {step_ms:.2f} with the GroupNorm kernels, "
          f"{plain_step_ms:.2f} with their plain versions", flush=True)

    model = resnet.ResNet(resnet.RESNET50, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(3)
    images = torch.randn(RESNET_CHECK_BATCH, RESNET_HW, RESNET_HW, 3,
                         generator=gen, device="cuda")
    with torch.no_grad():
        # GroupNorm scales and biases off their init (1 and 0), so that p
        # and q of every site are rounded values of their own
        for norm in model.modules():
            if isinstance(norm, resnet.Norm):
                norm.scale.add_(0.1 * torch.randn(
                    norm.scale.shape, generator=gen, device="cuda"))
                norm.bias.add_(0.1 * torch.randn(
                    norm.bias.shape, generator=gen, device="cuda"))
        kernel = resnet.apply(model, images)
        with plain_group_norm():
            plain = resnet.apply(model, images)
        for blk in model.stages[-1]:
            blk.norm3.scale.zero_()
        control = resnet.apply(model, images)
    if not torch.isfinite(kernel).all() or kernel.shape != (
            RESNET_CHECK_BATCH, resnet.RESNET50.num_classes):
        raise AssertionError("resnet50 logits not finite of the expected "
                             "shape")
    check_against(plain, kernel, control, RESNET_MODEL_ATOL,
                  "resnet50 kernel vs plain GroupNorm logits",
                  "last stage's norm3 scales zeroed")
    return launches


def phase_bert() -> dict:
    """(h): BERT-base MLM train steps through the flash kernels."""
    trainer, batch = bert_trainer(BERT_B, BERT_S)
    n = trainer.state.params.cfg.n_layers
    launches, _ = run_path(f"bert_base b{BERT_B} s{BERT_S}", trainer, batch,
                           fa.launches, {k: n for k in FLASH}, "tokens",
                           BERT_B * BERT_S)
    return launches

# -- phase (i): the serving path -------------------------------------------


def zero_launch_counts() -> None:
    for counts in (fa.launches, gn.launches):
        for name in counts:
            counts[name] = 0


def serving_pool(cfg, job: str, dev) -> KVBlockPool:
    """(i): a pool of the fleet's shapes, with a block for every slot at
    full context."""
    maxb = DECODE_DEFAULTS["max_blocks_per_session"]
    return KVBlockPool(cfg, DECODE_DEFAULTS["slots"] * maxb,
                       DECODE_DEFAULTS["kv_block_size"], maxb, job=job,
                       device=dev)


def serving_logits_check(model, dev) -> None:
    """(i): the paged path's logits — the last prefill chunk's last row,
    then LOGITS_STEPS decode steps at the fleet's 8 slots — against
    ``transformer.apply`` on the same full sequences; the control reads
    each session's context through the next session's block table."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    n, plen = LOGITS_PROMPTS, LOGITS_PROMPT_LEN
    pool = serving_pool(cfg, "smoke/logits", dev)
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (n, plen))
    tables = np.full((slots, pool.max_blocks_per_session), pool.num_blocks)
    for i in range(n):
        pool.ensure_capacity(i, plen + LOGITS_STEPS)
        tables[i] = pool.block_table(i)
    rolled = tables.copy()
    rolled[:n] = np.roll(tables[:n], 1, axis=0)

    def scratch():
        return {name: t.clone() for name, t in pool.cache.items()}

    got, control = [], []
    for start in range(0, plen, chunk):
        rows, ctrl_rows = [], []
        for i in range(n):
            toks = prompts[i, start:start + chunk]
            if start + chunk >= plen:
                lc, _ = llama.prefill(params, scratch(), toks, rolled[i],
                                      start, len(toks))
                ctrl_rows.append(lc[len(toks) - 1])
            lg, _ = llama.prefill(params, pool.cache, toks, tables[i], start,
                                  len(toks))
            rows.append(lg[len(toks) - 1])
    got.append(torch.stack(rows))
    control.append(torch.stack(ctrl_rows))
    seqs = prompts.tolist()
    live = np.arange(slots) < n
    for step in range(LOGITS_STEPS):
        nxt = got[-1].argmax(dim=-1).tolist()
        toks = np.zeros(slots, np.int64)
        toks[:n] = nxt
        pos = np.where(live, plen + step, 0)
        for seq, t in zip(seqs, nxt):
            seq.append(t)
        lc, _ = llama.decode_step(params, scratch(), toks, pos, rolled, live)
        lg, _ = llama.decode_step(params, pool.cache, toks, pos, tables, live)
        got.append(lg[:n])
        control.append(lc[:n])
    full = torch.tensor(seqs, device=dev)
    with torch.no_grad():
        ref = [tfm.apply(model, full[:, :plen + step])[:, -1]
               for step in range(LOGITS_STEPS + 1)]
    check_against(torch.stack(ref), torch.stack(got), torch.stack(control),
                  SERVING_ATOL, "paged decode vs transformer.apply logits",
                  "another session's context")


def serving_timings(model, dev) -> None:
    """(i): the device time of one decode step at 8 slots with 512 cached
    tokens a slot, and of one 64-token prefill chunk over 448 cached
    tokens, with their byte bounds; and the host's time a decode step."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    cached = 512
    pool = serving_pool(cfg, "smoke/timing", dev)
    for i in range(slots):
        pool.ensure_capacity(i, cached + 1)
    tables = np.stack([pool.block_table(i) for i in range(slots)])
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, chunk)
    pos = np.full(slots, cached)
    live = np.ones(slots, bool)

    def decode():
        return llama.decode_step(params, pool.cache, toks[:slots], pos,
                                 tables, live)

    def prefill():
        return llama.prefill(params, pool.cache, toks, tables[0],
                             cached - chunk, chunk)

    def device_ms(fn):
        return float(np.median([cuda_ms(fn, 1, SERVE_SLEEP_CYCLES)
                                for _ in range(SERVE_TIMED_REPS)]))

    decode_ms, prefill_ms = device_ms(decode), device_ms(prefill)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(SERVE_TIMED_REPS):
        decode()[0].argmax(dim=-1).tolist()  # the loop's one read
    host_ms = 1e3 * (time.perf_counter() - t0) / SERVE_TIMED_REPS
    weights = sum(t.numel() * t.element_size()
                  for layer in params.layers for name, t in layer.items()
                  if name.startswith("w")) + (
        params.lm_head.numel() * params.lm_head.element_size())
    mm_params = weights // params.lm_head.element_size()
    kv_token = llama.cache_bytes(cfg, 1, 1)
    for label, ms, rows, kv_tokens in (
            ("decode_step 8 slots x 512 cached", decode_ms, slots,
             slots * (cached + 1)),
            ("prefill chunk 64 over 448 cached", prefill_ms, chunk, cached)):
        nbytes = weights + kv_tokens * kv_token
        t_bytes = nbytes / PEAK_BYTES_PER_S
        t_ops = 2.0 * mm_params * rows / PEAK_BF16_FLOPS
        bound = max(t_bytes, t_ops) * 1e3
        print(f"serve {label}: device_ms {ms:.4f} bound_ms {bound:.4f} "
              f"({'bytes' if t_bytes >= t_ops else 'operations'}: "
              f"{nbytes / 1e6:.1f} MB of weights and K/V)", flush=True)
    print(f"serve decode_step host_ms {host_ms:.4f} a step with its argmax "
          f"read (the loop's pace)", flush=True)


def serving_traffic(cfg) -> list[tuple[list[int], int]]:
    """(i): SERVE_SESSIONS (prompt, priority): lengths uniform in
    SERVE_PROMPT_LENS and ids uniform over the vocabulary, from seed 1;
    priorities high, normal and low in turn."""
    rng = np.random.default_rng(1)
    lo, hi = SERVE_PROMPT_LENS
    lens = rng.integers(lo, hi + 1, SERVE_SESSIONS)
    pris = (serving.PRI_HIGH, serving.PRI_NORMAL, serving.PRI_LOW)
    return [(rng.integers(0, cfg.vocab_size, int(n)).tolist(), pris[i % 3])
            for i, n in enumerate(lens)]


def serve(label: str, fleet, traffic, resize_to=None) -> dict:
    """(i): every session of ``traffic`` through ``fleet`` (stopped after);
    with ``resize_to``, ``scale_to(resize_to)`` once every session has its
    first token.  Prints tokens/s, TTFT and TPOT (from the sessions, and
    the histogram buckets holding p50/p99) and returns the run."""
    try:
        t0 = time.perf_counter()
        sessions = [fleet.submit(p, SERVE_NEW_TOKENS, priority=pri)
                    for p, pri in traffic]
        if resize_to is not None:
            for s in sessions:
                s.wait_first_token(300)
            t_scale = time.perf_counter()
            fleet.scale_to(resize_to)
            scale_ms = 1e3 * (time.perf_counter() - t_scale)
        tokens = [s.wait(300) for s in sessions]
        wall = time.perf_counter() - t0
        run = dict(tokens=tokens, failed=fleet.sessions_failed,
                   migrations=fleet.migrations,
                   d2d_bytes=fleet.migration_bytes_d2d,
                   host_bytes=fleet.migration_bytes_host,
                   kv_bytes=fleet.kv_bytes(),
                   drafted=sum(r.spec_drafted for r in fleet._replicas),
                   accepted=sum(r.spec_accepted for r in fleet._replicas))
    finally:
        fleet.stop()
    n_tok = sum(len(t) for t in tokens)
    ttft = 1e3 * np.array([s.ttft_s for s in sessions])
    tpot = 1e3 * np.array([s.tpot_s for s in sessions])
    reg = get_registry()
    hist = {name: [reg.histogram(f"serving_{name}_seconds")
                   .quantile_bucket(q, job=fleet.job) for q in (0.5, 0.99)]
            for name in ("ttft", "tpot")}
    resize = (f" scale_to({resize_to}) {scale_ms:.1f} ms"
              if resize_to is not None else "")
    print(f"serve {label}: sessions {len(sessions)} tokens {n_tok} wall_s "
          f"{wall:.3f} decode_tokens_per_s {n_tok / wall:.1f} ttft_ms p50 "
          f"{np.percentile(ttft, 50):.2f} p99 {np.percentile(ttft, 99):.2f} "
          f"tpot_ms p50 {np.percentile(tpot, 50):.3f} p99 "
          f"{np.percentile(tpot, 99):.3f} (histogram buckets: ttft_s "
          f"<= {hist['ttft']}, tpot_s <= {hist['tpot']}) failed "
          f"{run['failed']} migrations {run['migrations']} d2d_bytes "
          f"{run['d2d_bytes']} host_bytes {run['host_bytes']} kv_bytes "
          f"{run['kv_bytes']}{resize}", flush=True)
    return run


def single_token_margins(model, traffic, tokens, dev) -> list:
    """(i): the single-token path's logits teacher-forced with ``tokens``
    (the single-token fleet's), the sessions in groups of the fleet's
    slots at its shapes: per session and generated position, the top-2
    logits, the rms of the logits and their argmax."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    out = []
    for lo in range(0, len(traffic), slots):
        group = list(range(lo, min(lo + slots, len(traffic))))
        pool = serving_pool(cfg, "smoke/margins", dev)
        rows = {}
        for i in group:
            prompt = traffic[i][0]
            pool.ensure_capacity(i, len(prompt) + SERVE_NEW_TOKENS)
            for start in range(0, len(prompt), chunk):
                n = min(chunk, len(prompt) - start)
                toks = np.zeros(chunk, np.int64)
                toks[:n] = prompt[start:start + n]
                lg, _ = llama.prefill(params, pool.cache, toks,
                                      pool.block_table(i), start, n)
            rows[i] = [lg[n - 1]]
        tables = np.full((slots, pool.max_blocks_per_session),
                         pool.num_blocks)
        live = np.zeros(slots, bool)
        for j, i in enumerate(group):
            tables[j], live[j] = pool.block_table(i), True
        for step in range(SERVE_NEW_TOKENS - 1):
            toks = np.zeros(slots, np.int64)
            pos = np.zeros(slots, np.int64)
            for j, i in enumerate(group):
                toks[j] = tokens[i][step]
                pos[j] = len(traffic[i][0]) + step
            lg, _ = llama.decode_step(params, pool.cache, toks, pos, tables,
                                      live)
            for j, i in enumerate(group):
                rows[i].append(lg[j])
        for i in group:
            logits = torch.stack(rows[i])
            out.append((logits.topk(2, dim=-1).values.cpu(),
                        logits.square().mean(dim=-1).sqrt().cpu(),
                        logits.argmax(dim=-1).cpu()))
    return out


def perfect_draft_check(model, traffic, tokens, margins, dev) -> None:
    """(i): ``verify_step`` fed the single-token tokens as its drafts
    (every draft right, SPEC_TOKENS rows a slot, the fleet's shapes): each
    row's argmax must be the next single-token token wherever that token's
    top-2 margin clears the tolerance of :func:`spec_check`."""
    cfg, params = model.cfg, llama.as_decode_params(model)
    slots, chunk = DECODE_DEFAULTS["slots"], DECODE_DEFAULTS["prefill_chunk"]
    rows = above = wrong = 0
    for lo in range(0, len(traffic), slots):
        group = list(range(lo, min(lo + slots, len(traffic))))
        pool = serving_pool(cfg, "smoke/drafts", dev)
        for i in group:
            prompt = traffic[i][0]
            pool.ensure_capacity(i, len(prompt) + SERVE_NEW_TOKENS)
            for start in range(0, len(prompt), chunk):
                n = min(chunk, len(prompt) - start)
                toks = np.zeros(chunk, np.int64)
                toks[:n] = prompt[start:start + n]
                llama.prefill(params, pool.cache, toks, pool.block_table(i),
                              start, n)
        tables = np.full((slots, pool.max_blocks_per_session),
                         pool.num_blocks)
        for j, i in enumerate(group):
            tables[j] = pool.block_table(i)
        for first in range(0, SERVE_NEW_TOKENS - 1, SPEC_TOKENS):
            feed = np.zeros((slots, SPEC_TOKENS), np.int64)
            pos = np.zeros(slots, np.int64)
            nts = np.zeros(slots, np.int64)
            for j, i in enumerate(group):
                k = min(SPEC_TOKENS, SERVE_NEW_TOKENS - 1 - first)
                feed[j, :k] = tokens[i][first:first + k]
                pos[j] = len(traffic[i][0]) + first
                nts[j] = k
            best = llama.verify_step(params, pool.cache, feed, pos, nts,
                                     tables)[0].argmax(dim=-1).tolist()
            for j, i in enumerate(group):
                top2, rms, _ = margins[i]
                for r in range(int(nts[j])):
                    t = first + r + 1  # the generated position row r feeds
                    tol = (kc.BF16_RTOL * top2[t].abs().sum()
                           + 2 * SERVING_ATOL * rms[t])
                    clear = bool(top2[t, 0] - top2[t, 1] > tol)
                    rows += 1
                    above += clear
                    wrong += clear and best[j][r] != tokens[i][t]
    print(f"serve verify with perfect drafts: {rows} rows, {above} above the "
          f"margin, {wrong} of those off the single-token token", flush=True)
    if wrong:
        raise AssertionError(f"verify_step: {wrong} rows above the margin "
                             "disagree with single-token decode")


def spec_check(single, spec, margins) -> None:
    """(i): speculative tokens equal single-token ones up to each
    session's first difference, which must fall where the single-token
    logits' top-2 margin is within the logits check's tolerance for those
    two logits (2^-7 of each, plus SERVING_ATOL rms each)."""
    compared = under = forced_equal = 0
    first_diffs = []
    for i, (a, b) in enumerate(zip(single, spec)):
        top2, rms, best = margins[i]
        forced_equal += int((best == torch.tensor(a)).sum())
        tol = kc.BF16_RTOL * top2.abs().sum(dim=-1) + 2 * SERVING_ATOL * rms
        low = (top2[:, 0] - top2[:, 1]) <= tol
        for j, (x, y) in enumerate(zip(a, b)):
            compared += 1
            under += int(low[j])
            if x != y:
                first_diffs.append((i, j, bool(low[j])))
                break
    print(f"serve spec vs single: compared {compared} tokens, {under} under "
          f"the margin; first differences (session, position, under the "
          f"margin) {first_diffs}; teacher-forced single-token argmax "
          f"equals the fleet's tokens at {forced_equal} of "
          f"{sum(len(a) for a in single)}", flush=True)
    bad = [d for d in first_diffs if not d[2]]
    if bad:
        raise AssertionError(f"speculative decode differs from single-token "
                             f"decode above the margin: {bad}")


def phase_serving() -> dict:
    """(i): FLAGSHIP served on the card through the decode plane."""
    zero_launch_counts()
    dev = torch.device("cuda")
    model = tfm.Transformer(tfm.FLAGSHIP, device=dev, seed=0)
    serving_logits_check(model, dev)
    serving_timings(model, dev)
    traffic = serving_traffic(model.cfg)
    resized = serve("2->1 resize", flagship_decode_fleet(
        roles={"decode": 2}, job="smoke/resize"), traffic, resize_to=1)
    single = serve("1 replica", flagship_decode_fleet(job="smoke/single"),
                   traffic)
    if resized["failed"] or resized["migrations"] < 1:
        raise AssertionError(f"resize: {resized['failed']} sessions failed, "
                             f"{resized['migrations']} migrations")
    differ = [(i, next(j for j, (x, y) in enumerate(zip(a + [None], b))
                       if x != y))
              for i, (a, b) in enumerate(zip(resized["tokens"],
                                             single["tokens"])) if a != b]
    print(f"serve resize vs undisturbed: {len(traffic) - len(differ)} of "
          f"{len(traffic)} sessions token-equal; (session, first differing "
          f"position) {differ}", flush=True)
    if differ:
        raise AssertionError(f"2->1 resize tokens differ from the "
                             f"undisturbed fleet's: {differ}")
    spec = serve(f"1 replica spec_tokens {SPEC_TOKENS}", flagship_decode_fleet(
        job="smoke/spec", spec_tokens=SPEC_TOKENS), traffic)
    print(f"serve spec acceptance: {spec['accepted']} of {spec['drafted']} "
          f"drafts ({spec['accepted'] / max(spec['drafted'], 1):.4f})",
          flush=True)
    margins = single_token_margins(model, traffic, single["tokens"], dev)
    spec_check(single["tokens"], spec["tokens"], margins)
    perfect_draft_check(model, traffic, single["tokens"], margins, dev)
    launches = {**fa.launches, **gn.launches}
    print(f"serve launches of the hand-written kernels over phase (i): "
          f"{launches} (no Pallas kernel lies on the decode path)",
          flush=True)
    if any(launches.values()):
        raise AssertionError(f"phase (i) launched {launches}")
    return dict(launches=launches, single=single["tokens"])


# -- phase (j): the multi-rank trainer ---------------------------------------


def checksum(tensors) -> list[list[int]]:
    """A bitwise fingerprint of each 4-byte-element tensor, taken on its
    device: the sum of its words as int32, and their sum weighted by
    position (mod 65521, plus 1)."""
    out = []
    for t in tensors:
        w = t.detach().contiguous().view(torch.int32).reshape(-1).long()
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append([int(w.sum()), int((w * pos).sum())])
    return out


def state_tensors(trainer, with_opt: bool) -> list[torch.Tensor]:
    params = list(trainer.state.params.parameters())
    if not with_opt:
        return params
    opt = trainer.state.opt_state.state
    return params + [v for p in params for _, v in sorted(opt[p].items())
                     if v.device == trainer.device]


def world_rank(rank: int, store: str, out: str) -> None:
    """(j), one rank of the job: the schedule with what one rank can see of
    it (losses, step times, launches, fingerprints, resize events), written
    as JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_elastic_world(
        rank, WORLD_RANKS, store, batch=B, seq=S,
        initial_world_size=WORLD_SCHEDULE[0])
    rec = dict(rank=rank, steps=[], resized=[])
    fa.reset_launches()
    for world in WORLD_SCHEDULE:
        if world != trainer.world_size:
            grow = world > trainer.world_size
            rec["resized"].append(trainer.resize(world))
            if grow:
                rec["after_grow"] = checksum(state_tensors(trainer, True))
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            params=(checksum(state_tensors(trainer, False))
                    if trainer.world_size > 1 else None)))

    def no_memory(*args, **kwargs):
        raise RuntimeError("planted: out of memory staging the resize")

    if rank == 1:
        elastic._fresh = no_memory
    rec["planted"] = trainer.resize(WORLD_RANKS)
    rec["planted_failed"] = trainer.resizes_failed
    before = dict(fa.launches)
    loss = trainer.step(batch)
    rec["after_planted"] = dict(
        world=trainer.world_size, loss=loss,
        launches={k: fa.launches[k] - before[k] for k in fa.launches})
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def run_ranks(target, phase: str, timeout_s: float, *args) -> list[dict]:
    """(j) and (k): start WORLD_RANKS processes of ``target(rank, store,
    out, *args)`` (forked from ``entry.rank_processes``' server, which has
    imported this script once), join them within ``timeout_s`` (killing
    any left), and return each rank's record, the JSON it wrote to
    ``out``."""
    ctx = rank_processes()
    with tempfile.TemporaryDirectory() as tmp:
        outs = [os.path.join(tmp, f"rank{r}.json") for r in range(WORLD_RANKS)]
        procs = [ctx.Process(target=target,
                             args=(r, os.path.join(tmp, "store"), outs[r],
                                   *args))
                 for r in range(WORLD_RANKS)]
        try:
            for p in procs:
                p.start()
            end = time.monotonic() + timeout_s
            for p in procs:
                p.join(max(end - time.monotonic(), 0.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(30)
        bad = [(r, p.exitcode) for r, p in enumerate(procs)
               if p.exitcode != 0 or not os.path.exists(outs[r])]
        if bad:
            raise AssertionError(f"phase ({phase}): ranks (rank, exit code) "
                                 f"{bad} failed or ran past {timeout_s} s")
        recs = []
        for out in outs:
            with open(out) as f:
                recs.append(json.load(f))
    return recs


def world_control() -> list[float]:
    """(j) and (l)'s one-rank control: WORLD_SCHEDULE's steps of phase
    (c)'s trainer from the same init on the same batch, in this process."""
    torch.cuda.empty_cache()
    trainer, batch = flagship_trainer(B, S)
    control = [trainer.step(batch) for _ in WORLD_SCHEDULE]
    del trainer, batch
    torch.cuda.empty_cache()
    return control


def phase_world(card: str) -> dict:
    """(j): FLAGSHIP over two ranks sharing the card through 1→2→1, against
    a one-rank control; returns the launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(world_rank, "j", WORLD_CHILD_TIMEOUT_S)
    control = world_control()
    n = tfm.FLAGSHIP.n_layers
    per_step = {k: n for k in FLASH}
    r0, r1 = recs
    for rec in recs:
        for evt in rec["events"]:
            print(f"world rank {rec['rank']} resize_event {json.dumps(evt)}",
                  flush=True)
    for world in sorted(set(WORLD_SCHEDULE)):
        # rank 0 is live on every world and waits out the all-reduce, so
        # its step spans the world's; the first step on each world warms
        # a rank up (its first kernels, or its first all-reduce)
        ms = {rec["rank"]: [round(s["ms"], 2) for s in rec["steps"]
                            if s["world"] == world and s["live"]]
              for rec in recs}
        print(f"world {world} step_ms by rank {ms} median after the first "
              f"{float(np.median(ms[0][1:])):.2f} (b{B} s{S} global batch; "
              f"two ranks share one card: not a scaling figure) on {card}",
              flush=True)
    losses = [s["loss"] for s in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"world losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |world - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    failures = []
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["after_grow"] != r1["after_grow"]:
        failures.append("rank 1's state after resize(2) is not rank 0's")
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1 and (a["params"] != b["params"]
                               or a["loss"] != b["loss"]):
            failures.append(f"step {i}: the ranks' params or loss differ")
        for rank, st in enumerate((a, b)):
            want = per_step if st["live"] else {k: 0 for k in FLASH}
            if st["launches"] != want:
                failures.append(f"step {i} rank {rank}: launches "
                                f"{st['launches']}, want {want}")
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    for rank, rec in enumerate(recs):
        after = rec["after_planted"]
        live = rank < after["world"]
        want = per_step if live else {k: 0 for k in FLASH}
        if (rec["planted"] or rec["planted_failed"] != 1
                or after["world"] != 1 or after["launches"] != want
                or (after["loss"] is not None) != live):
            failures.append(f"rank {rank}: planted resize "
                            f"{rec['planted']}, resizes_failed "
                            f"{rec['planted_failed']}, then {after}")
    print(f"world planted failure on rank 1: resize -> "
          f"{[rec['planted'] for rec in recs]}, resizes_failed "
          f"{[rec['planted_failed'] for rec in recs]}, next step world "
          f"{r0['after_planted']['world']} loss "
          f"{r0['after_planted']['loss']:.6f}; bitwise state after grow "
          f"{r0['after_grow'] == r1['after_grow']}; launches "
          f"{[rec['launches'] for rec in recs]}", flush=True)
    if failures:
        raise AssertionError("phase (j): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (l): fsdp over two ranks sharing the card --------------------------


def split_leaves(trainer) -> set:
    """The leaves some axis of the live mesh splits."""
    return {n for n, spec in trainer.partition_specs().items()
            if any(e is not None and getattr(trainer.shape, e) > 1
                   for e in spec)}


def resting_state(trainer) -> dict:
    """(l) and (m): what this rank holds at rest: its blocks of the
    parameters and of Adam's moments (bytes summed, and each split leaf's
    share of its full bytes), what a replicated trainer's rank holds of the
    same leaves (each at its full shape), and what the caching allocator
    holds in this process."""
    opt = trainer.state.opt_state.state
    split, shapes = split_leaves(trainer), trainer.full_shapes()
    nbytes, replicated, shares = 0, 0, set()
    for name, shard in trainer.shards.items():
        for t in [shard] + [v for v in opt.get(shard, {}).values()
                            if v.shape == shard.shape]:
            full = math.prod(shapes[name]) * t.element_size()
            nbytes += t.nbytes
            replicated += full
            if name in split:
                shares.add(t.nbytes / full)
    return dict(state_bytes=nbytes, replicated_bytes=replicated,
                shares=sorted(shares),
                replicated=sorted(set(shapes) - split),
                allocated=torch.cuda.memory_allocated(trainer.device))


def fsdp_rank(rank: int, store: str, out: str) -> None:
    """(l), one rank of the job: WORLD_SCHEDULE on an fsdp trainer, with
    what one rank can see of it written as JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_elastic_world(
        rank, WORLD_RANKS, store, batch=B, seq=S,
        initial_world_size=WORLD_SCHEDULE[0], param_sharding="fsdp",
        spec=FSDP_SPEC)
    rec = dict(rank=rank, steps=[], resized=[], moved=[], kept=[])
    fa.reset_launches()
    for world in WORLD_SCHEDULE:
        if world != trainer.world_size:
            # rank 0, live on every world, fingerprints the whole params
            full = checksum(trainer.full_params().values())
            elastic.reset_census()
            rec["resized"].append(trainer.resize(world))
            rec["moved"].append(elastic.collective_census())
            after = checksum(trainer.full_params().values())
            rec["kept"].append(full == after if rank == 0 else None)
        before = dict(fa.launches)
        elastic.reset_census()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            census=elastic.collective_census()))
        if trainer.world_size == WORLD_RANKS and "rest" not in rec:
            torch.cuda.synchronize()
            rec["rest"] = resting_state(trainer)
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_fsdp(card: str) -> dict:
    """(l): FLAGSHIP with fsdp parameter sharding over two ranks sharing
    the card through 1→2→1, against a one-rank control; returns the
    launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(fsdp_rank, "l", WORLD_CHILD_TIMEOUT_S)
    control = world_control()
    n = tfm.FLAGSHIP.n_layers
    per_step = {k: n for k in FLASH}
    r0, r1 = recs
    failures = []
    for rec in recs:
        for evt, moved, kept in zip(rec["events"], rec["moved"],
                                    rec["kept"]):
            sent = sum(slot["bytes"] for label, slot in moved.items()
                       if label != "world")
            print(f"fsdp rank {rec['rank']} resize to {evt['shape']}: "
                  f"bytes_moved {evt['bytes_moved']} (plan; bytes_naive "
                  f"{evt['bytes_naive']}), broadcast {sent} bytes, "
                  f"reshard_ms {evt['reshard_ms']}, full params bitwise "
                  f"kept {kept}", flush=True)
            # the plan counts Adam's step count, which travels by value
            if kept is False or not 0 <= evt["bytes_moved"] - sent <= 4:
                failures.append(f"rank {rec['rank']} resize {evt}: "
                                f"broadcast {sent}, kept {kept}")
    for rec in recs:
        rest = rec["rest"]
        print(f"fsdp rank {rec['rank']} resting state on fsdp2: "
              f"{rest['state_bytes'] / 1e9:.4f} GB of params and Adam "
              f"moments (a replicated trainer's rank: "
              f"{rest['replicated_bytes'] / 1e9:.4f} GB), each "
              f"sharded leaf's share {rest['shares']}, replicated leaves "
              f"{rest['replicated']}, torch.cuda.memory_allocated "
              f"{rest['allocated'] / 1e9:.4f} GB on {card}", flush=True)
        if rest["shares"] != [0.5]:
            failures.append(f"rank {rec['rank']}: shares {rest['shares']}")
    for world in sorted(set(WORLD_SCHEDULE)):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"fsdp world {world} step_ms by rank {ms} median after the "
              f"first {float(np.median(ms[0][1:])):.2f} (b{B} s{S} global "
              f"batch; two ranks share one card: not a scaling figure) on "
              f"{card}", flush=True)
    census = next(st["census"] for st in r0["steps"]
                  if st["world"] == WORLD_RANKS)
    print(f"fsdp census of one fsdp2 step, rank 0 (gloo, handed the CUDA "
          f"tensors as they are): {json.dumps(census)}", flush=True)
    fops = census.get("fsdp", {}).get("ops", {})
    if fops.get("all-gather") != 1 or fops.get("reduce-scatter") != 1:
        failures.append(f"census {census}")
    losses = [st["loss"] for st in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"fsdp losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |fsdp - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["kept"] != [True, True]:
        failures.append(f"full params kept through the resizes "
                        f"{r0['kept']}")
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1 and a["loss"] != b["loss"]:
            failures.append(f"step {i}: the ranks' losses differ")
        for rank, st in enumerate((a, b)):
            want = per_step if st["live"] else {k: 0 for k in FLASH}
            if st["launches"] != want:
                failures.append(f"step {i} rank {rank}: launches "
                                f"{st['launches']}, want {want}")
    print(f"fsdp launches {[rec['launches'] for rec in recs]}", flush=True)
    if failures:
        raise AssertionError("phase (l): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (m): Megatron tp over two ranks sharing the card -------------------


def tp_rank(rank: int, store: str, out: str) -> None:
    """(m), one rank of the job: WORLD_SCHEDULE on a trainer laid out by
    FLAGSHIP's partition specs over tp, with what one rank can see of it
    written as JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_tp_world(
        rank, WORLD_RANKS, store, batch=B, seq=S,
        initial_world_size=WORLD_SCHEDULE[0])
    norms = [n for n, spec in trainer.partition_specs().items()
             if not any(spec)]
    rec = dict(rank=rank, steps=[], resized=[], moved=[], kept=[])
    fa.reset_launches()
    for world in WORLD_SCHEDULE:
        if world != trainer.world_size:
            # rank 0, live on every world, fingerprints the whole params
            full = checksum(trainer.full_params().values())
            elastic.reset_census()
            rec["resized"].append(trainer.resize(world))
            rec["moved"].append(elastic.collective_census())
            after = checksum(trainer.full_params().values())
            rec["kept"].append(full == after if rank == 0 else None)
        before = dict(fa.launches)
        elastic.reset_census()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            census=elastic.collective_census(),
            norms=(checksum(trainer.shards[n] for n in norms)
                   if trainer.world_size > 1 else None)))
        if trainer.world_size == WORLD_RANKS and "rest" not in rec:
            torch.cuda.synchronize()
            rec["rest"] = resting_state(trainer)
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_tp(card: str) -> dict:
    """(m): FLAGSHIP with Megatron tp over two ranks sharing the card
    through 1→2→1, against a one-rank control; returns the launches of
    both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(tp_rank, "m", WORLD_CHILD_TIMEOUT_S)
    control = world_control()
    n = tfm.FLAGSHIP.n_layers
    per_step = {k: n for k in FLASH}
    r0, r1 = recs
    failures = []
    for rec in recs:
        for evt, moved, kept in zip(rec["events"], rec["moved"],
                                    rec["kept"]):
            sent = sum(slot["bytes"] for label, slot in moved.items()
                       if label != "world")
            print(f"tp rank {rec['rank']} resize to {evt['shape']}: "
                  f"bytes_moved {evt['bytes_moved']} (plan; bytes_naive "
                  f"{evt['bytes_naive']}), broadcast {sent} bytes, "
                  f"reshard_ms {evt['reshard_ms']}, full params bitwise "
                  f"kept {kept}", flush=True)
            # the plan counts Adam's step count, which travels by value
            if kept is False or not 0 <= evt["bytes_moved"] - sent <= 4:
                failures.append(f"rank {rec['rank']} resize {evt}: "
                                f"broadcast {sent}, kept {kept}")
    for rec in recs:
        rest = rec["rest"]
        print(f"tp rank {rec['rank']} resting state on tp2: "
              f"{rest['state_bytes'] / 1e9:.4f} GB of params and Adam "
              f"moments (a replicated trainer's rank: "
              f"{rest['replicated_bytes'] / 1e9:.4f} GB), each split "
              f"leaf's share {rest['shares']}, whole leaves "
              f"{rest['replicated']}, torch.cuda.memory_allocated "
              f"{rest['allocated'] / 1e9:.4f} GB on {card}", flush=True)
        if rest["shares"] != [0.5]:
            failures.append(f"rank {rec['rank']}: shares {rest['shares']}")
    for world in sorted(set(WORLD_SCHEDULE)):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"tp world {world} step_ms by rank {ms} median after the "
              f"first {float(np.median(ms[0][1:])):.2f} (b{B} s{S} global "
              f"batch; two ranks share one card: not a scaling figure) on "
              f"{card}", flush=True)
    census = next(st["census"] for st in r0["steps"]
                  if st["world"] == WORLD_RANKS)
    reduces = census.get("tp", {}).get("ops", {}).get("all-reduce", 0)
    print(f"tp census of one tp2 step, rank 0 (gloo, handed the CUDA "
          f"tensors as they are): {reduces} tp all-reduces, "
          f"{json.dumps(census)}", flush=True)
    if set(census) != {"tp"} or set(census["tp"]["ops"]) != {"all-reduce"}:
        failures.append(f"census {census}")
    losses = [st["loss"] for st in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"tp losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |tp - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["kept"] != [True, True]:
        failures.append(f"full params kept through the resizes "
                        f"{r0['kept']}")
    equal = []
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1:
            equal.append(a["norms"] == b["norms"])
            if a["loss"] != b["loss"] or a["norms"] != b["norms"]:
                failures.append(f"step {i}: the ranks' losses or norms "
                                "differ")
        for rank, st in enumerate((a, b)):
            want = per_step if st["live"] else {k: 0 for k in FLASH}
            if st["launches"] != want:
                failures.append(f"step {i} rank {rank}: launches "
                                f"{st['launches']}, want {want}")
    print(f"tp norms bitwise equal across the ranks after each world-2 "
          f"step: {equal}; launches {[rec['launches'] for rec in recs]}",
          flush=True)
    if failures:
        raise AssertionError("phase (m): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


def phase_dryrun() -> None:
    """(n): the sharded dryrun on the card at each of DRYRUN_SIZES, the
    sizes at once (their ranks spend most of their time starting); each
    raises on a failed check and prints its DRYRUN_COMM line."""
    t0 = time.perf_counter()

    def one(n):
        rec = dryrun_multichip(n)
        return rec, time.perf_counter() - t0

    with ThreadPoolExecutor(len(DRYRUN_SIZES)) as pool:
        done = list(pool.map(one, DRYRUN_SIZES))
    for n, (rec, secs) in zip(DRYRUN_SIZES, done):
        print(f"dryrun_multichip({n}) ok on the card {secs:.1f} s into the "
              f"phase: mesh {rec['mesh']}, "
              f"{rec['param_bytes_per_device_max']} of "
              f"{rec['param_bytes_total']} param bytes a rank", flush=True)


# -- phase (k): the durable virtual-worker loop -------------------------------


def durable_world(*args, **kw):
    """``entry.flagship_virtual_world`` at DURABLE_CFG: (k)'s job, which
    (o), (p) and (q)'s virtual drive share."""
    return flagship_virtual_world(*args, cfg=DURABLE_CFG, **kw)


def virtual_world(step: int) -> int:
    """(k)'s schedule: world 1 for steps 0-2, 2 for steps 3-8, 1 after."""
    return 2 if 3 <= step < VIRTUAL_KILL_AFTER else 1


def instrument(trainer, steps: list, watchdog=None) -> None:
    """Record every ``step_accumulate`` of ``trainer`` into ``steps``: its
    world, whether this rank was live, its loss, its host ms between two
    ``synchronize()``s and its flash launches; then beat ``watchdog``
    (armed by its first beat, so it watches only this trainer's loop)."""
    real = trainer.step_accumulate

    def timed(micro, **kw):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real(micro, **kw)
        torch.cuda.synchronize()
        steps.append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in FLASH}))
        if watchdog is not None:
            watchdog.beat()
        return loss

    trainer.step_accumulate = timed


def rows_once(reports, steps: int = VIRTUAL_STEPS) -> dict:
    """The exactly-once ledger of several runs of one job over ``steps``
    steps, merged."""
    rows: dict[int, int] = {}
    for rep in reports:
        for gid, c in rep.rows_trained.items():
            rows[gid] = rows.get(gid, 0) + c
    want = steps * B
    return dict(duplicated=sum(c - 1 for c in rows.values() if c > 1),
                missing=want - len(rows), trained=sum(rows.values()))


def step_files(store: str, step: int) -> list[str]:
    root = os.path.join(store, str(step))
    return [os.path.join(d, f) for d, _, fs in os.walk(root) for f in fs]


def checkpoint_drills(trainer, store: str) -> dict:
    """(k), rank 0 after the restored run: the newest step torn and a fresh
    checkpointer's fallback, then one synchronous and one async save of the
    FLAGSHIP state timed, with the fold and the CRC of a save timed
    alone."""
    tree = {"params": trainer.state.params, "opt": trainer.state.opt_state}
    got = {}
    newest = max(int(p) for p in os.listdir(store) if p.isdigit())
    victim = max(step_files(store, newest), key=os.path.getsize)
    with open(victim, "r+b") as f:
        f.truncate(os.path.getsize(victim) // 2)
    counters = get_counters()
    before = (counters.get("checkpoint_corruption_detected"),
              counters.get("recoveries_completed", type="corrupt_checkpoint"))
    fresh = ElasticCheckpointer(store)
    t0 = time.perf_counter()
    fresh.restore(tree)
    torch.cuda.synchronize()
    got.update(
        torn=newest, fallback=fresh.last_restored_step,
        fallback_ms=1e3 * (time.perf_counter() - t0),
        hash_ok=fresh.last_restore_hash_ok,
        corruption=counters.get("checkpoint_corruption_detected") - before[0],
        recoveries=counters.get("recoveries_completed",
                                type="corrupt_checkpoint") - before[1])

    pause_dir = store + "-pause"
    ck = ElasticCheckpointer(pause_dir, max_to_keep=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ck.save(1, tree)
    got["save_ms"] = 1e3 * (time.perf_counter() - t0)
    got["file_bytes"] = sum(os.path.getsize(f)
                            for f in step_files(pause_dir, 1))
    got["state_bytes"] = sum(t.numel() * t.element_size()
                             for t in state_tensors(trainer, True))
    t0 = time.perf_counter()
    ElasticCheckpointer._tree_folds(tree)
    got["fold_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    ckpt._fingerprint_tree(os.path.join(pause_dir, "1"))
    got["crc_ms"] = 1e3 * (time.perf_counter() - t0)
    t0 = time.perf_counter()
    got["pause_ms"] = 1e3 * ck.save_async(2, tree)
    ck.wait_pending()
    got["persist_ms"] = 1e3 * (time.perf_counter() - t0)
    ck.finalize()
    got["async_verified"] = ck.latest_verified_step()
    shutil.rmtree(pause_dir)
    return got


def virtual_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(k), one rank of the job: the replicated run through 1→2 with its
    kill mid-accumulation, the restore on fresh trainers and the run's end
    through 2→1; on rank 0 the checkpoint drills; then the dp-mode run.
    Each of the three trainers' loops has its own stall watchdog, stopped
    when the loop ends, so that the restore, the drills and the rebuilds
    between the loops are not watched.  What the rank saw is written as
    JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    watchdogs: list[StallWatchdog] = []

    def watched(trainer, steps: list) -> None:
        watchdogs.append(StallWatchdog(
            floor_s=VIRTUAL_STALL_FLOOR_S,
            scope=f"virtual-rank{rank}-loop{len(watchdogs)}").start())
        instrument(trainer, steps, watchdogs[-1])

    rec = dict(rank=rank, steps=[], dp_steps=[])
    fa.reset_launches()
    trainer, reg, ids, cfg = durable_world(
        rank, WORLD_RANKS, store, initial_world_size=virtual_world(0))
    watched(trainer, rec["steps"])
    batches = VirtualBatches(cfg, ids, reg.get)
    first = VirtualWorkerLoop(
        trainer, cfg, batches, checkpointer=ElasticCheckpointer(ckpt_dir),
        ckpt_every=VIRTUAL_CKPT_EVERY).run(max_steps=VIRTUAL_KILL_AFTER,
                                           world_size_for=virtual_world)
    before = dict(fa.launches)
    rec["kill_world"] = trainer.world_size
    try:
        trainer.step_accumulate(batches.next_step(), abort_after=3)
        rec["killed"] = False
    except AccumulationAborted:
        rec["killed"] = True
    watchdogs[-1].stop()
    rec["kill_launches"] = {k: fa.launches[k] - before[k] for k in FLASH}
    del trainer, batches
    torch.cuda.empty_cache()

    trainer, reg, ids, cfg = durable_world(
        rank, WORLD_RANKS, store, initial_world_size=WORLD_RANKS)
    loop = VirtualWorkerLoop(
        trainer, cfg, VirtualBatches(cfg, ids, reg.get),
        checkpointer=ElasticCheckpointer(ckpt_dir),
        ckpt_every=VIRTUAL_CKPT_EVERY)
    t0 = time.perf_counter()
    rec["restored"] = loop.restore_latest()
    torch.cuda.synchronize()
    rec["restore_ms"] = 1e3 * (time.perf_counter() - t0)
    watched(trainer, rec["steps"])
    second = loop.run(max_steps=VIRTUAL_STEPS - VIRTUAL_KILL_AFTER,
                      world_size_for=virtual_world)
    watchdogs[-1].stop()
    rec.update(losses=first.losses + second.losses,
               resizes=[first.resizes, second.resizes],
               rows=rows_once([first, second]))
    if rank == 0:
        rec["drills"] = checkpoint_drills(trainer, ckpt_dir)
    torch.distributed.barrier()
    del loop, trainer
    torch.cuda.empty_cache()

    trainer, reg, ids, cfg = durable_world(
        rank, WORLD_RANKS, store, accum_mode="dp",
        initial_world_size=virtual_world(0))
    watched(trainer, rec["dp_steps"])
    dp = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get)
                           ).run(max_steps=VIRTUAL_STEPS,
                                 world_size_for=virtual_world)
    watchdogs[-1].stop()
    rec.update(dp_losses=dp.losses, dp_rows=rows_once([dp]),
               stalls=sum(w.stalls_detected for w in watchdogs),
               launches=dict(fa.launches))
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_virtual(card: str) -> dict:
    """(k): the durable virtual-worker loop on two ranks sharing the card,
    against a one-process control; returns the launches of the ranks and
    the control summed, the control's losses and rank 0's checkpoint
    drills."""
    torch.cuda.empty_cache()
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        recs = run_ranks(virtual_rank, "k", VIRTUAL_CHILD_TIMEOUT_S,
                         os.path.join(tmp, "ckpt"))
    torch.cuda.empty_cache()
    trainer, reg, ids, cfg = durable_world(0, 1, None)
    assert cfg.micro_batch == VIRTUAL_MICRO_BATCH, cfg
    steps: list = []
    instrument(trainer, steps)
    control = VirtualWorkerLoop(trainer, cfg, VirtualBatches(
        cfg, ids, reg.get)).run(max_steps=VIRTUAL_STEPS).losses
    control_launches = dict(fa.launches)
    del trainer
    torch.cuda.empty_cache()
    r0, r1 = recs
    d = r0["drills"]
    print(f"virtual phase (k): FLAGSHIP width at {DURABLE_LAYERS} layers, "
          f"V {cfg.vw_count}, global batch {cfg.global_batch} x {S}, two "
          f"ranks sharing the card over gloo, on {card}", flush=True)
    per_world = {}
    for st in r0["steps"]:
        per_world.setdefault(st["world"], []).append(round(st["ms"], 2))
    per_world["control"] = [round(st["ms"], 2) for st in steps]
    for world, ms in per_world.items():
        print(f"virtual step_ms world {world} rank 0 {ms} median "
              f"{float(np.median(ms)):.2f} on {card}", flush=True)
    bitwise = r0["losses"] == control
    div = loss_divergence(control, r0["dp_losses"])
    print(f"virtual losses {r0['losses']} control {control} bitwise "
          f"{bitwise}; rows duplicated {r0['rows']['duplicated']} missing "
          f"{r0['rows']['missing']} of {VIRTUAL_STEPS * cfg.global_batch}; "
          f"resizes {r0['resizes']}; restored step {r0['restored']}",
          flush=True)
    print(f"virtual dp losses {r0['dp_losses']} max |dp - control| "
          f"{div['max_loss_divergence']:.3e} equivalent "
          f"{trajectories_equivalent(control, r0['dp_losses'])} (atol "
          f"{DEFAULT_LOSS_ATOL}, rtol {DEFAULT_LOSS_RTOL})", flush=True)
    gbps = d["file_bytes"] / d["save_ms"] / 1e6
    print(f"checkpoint save_ms {d['save_ms']:.2f} bytes {d['file_bytes']} "
          f"(state {d['state_bytes']}) GB/s {gbps:.3f} fold_ms "
          f"{d['fold_ms']:.2f} crc_ms {d['crc_ms']:.2f} on {card}",
          flush=True)
    print(f"save_async pause_ms {d['pause_ms']:.2f} persist_ms "
          f"{d['persist_ms']:.2f} on {card}", flush=True)
    print(f"restore_ms {r0['restore_ms']:.2f} (rank 0, step "
          f"{r0['restored']}) {r1['restore_ms']:.2f} (rank 1); restore "
          f"fallback {d['torn']} -> {d['fallback']} in "
          f"{d['fallback_ms']:.2f} ms, checkpoint_corruption_detected "
          f"+{d['corruption']}, recoveries_completed{{type="
          f"corrupt_checkpoint}} +{d['recoveries']}, last_restore_hash_ok "
          f"{d['hash_ok']}", flush=True)
    print(f"virtual stalls_detected {[rec['stalls'] for rec in recs]} "
          f"(floor {VIRTUAL_STALL_FLOOR_S} s)", flush=True)
    failures = []
    n = DURABLE_CFG.n_layers * cfg.vw_count
    for rec in recs:
        got = sorted({(st["live"], tuple(st["launches"].values()))
                      for st in rec["steps"]})
        print(f"virtual launches rank {rec['rank']}: (live, per step) "
              f"{got}; kill {rec['kill_launches']}; total "
              f"{rec['launches']}", flush=True)
        for st in rec["steps"]:
            want = n if st["live"] else 0
            if set(st["launches"].values()) != {want}:
                failures.append(f"rank {rec['rank']} launches {st}")
        if not rec["killed"] or rec["kill_world"] != 2:
            failures.append(f"rank {rec['rank']}: kill {rec['killed']} on "
                            f"world {rec['kill_world']}")
        if rec["restored"] != VIRTUAL_KILL_AFTER:
            failures.append(f"rank {rec['rank']} restored {rec['restored']}")
        if rec["stalls"]:
            failures.append(f"rank {rec['rank']} stalls {rec['stalls']}")
    if not bitwise or not all(np.isfinite(control)):
        failures.append(f"losses {r0['losses']} vs control {control}")
    if r0["rows"]["duplicated"] or r0["rows"]["missing"]:
        failures.append(f"rows {r0['rows']}")
    if r0["resizes"] != [1, 1]:
        failures.append(f"resizes {r0['resizes']}")
    if (not trajectories_equivalent(control, r0["dp_losses"])
            or r0["dp_rows"]["duplicated"] or r0["dp_rows"]["missing"]):
        failures.append(f"dp {r0['dp_losses']} rows {r0['dp_rows']}")
    if (d["torn"], d["fallback"], d["corruption"], d["recoveries"],
            d["hash_ok"]) != (VIRTUAL_STEPS, VIRTUAL_KILL_AFTER, 1, 1, True):
        failures.append(f"torn step drill {d}")
    if d["async_verified"] != 2:
        failures.append(f"save_async not verified: {d['async_verified']}")
    if control_launches != {k: n * VIRTUAL_STEPS for k in FLASH}:
        failures.append(f"control launches {control_launches}")
    if failures:
        raise AssertionError("phase (k): " + "; ".join(failures))
    return dict(launches={k: control_launches[k] + sum(
        rec["launches"][k] for rec in recs) for k in FLASH},
        control=control, drills=d)


# -- phase (o): the sharded lineage -------------------------------------------


def trainer_tree(trainer) -> dict:
    return {"params": trainer.state.params, "opt": trainer.state.opt_state}


def state_digest(trainer):
    """{checkpoint path: checksum} of the trainer's whole state, each leaf
    summed on the card (collective over the live group): rank 0's, None
    on the other ranks."""
    tree = type(trainer).whole_state(trainer)
    if tree is None:
        return None
    return {k: checksum([torch.as_tensor(v).to("cuda")])[0]
            for k, v in sorted(ckpt._flatten(tree).items())}


def instrument_gather(trainer, record: list) -> None:
    """Record every ``whole_state`` of ``trainer`` (a save's gather) into
    ``record``: its step and world, its host ms between two
    ``synchronize()``s, the bytes and all-gathers of its census label, and
    ``memory_allocated`` before it and at its peak."""
    from edl_tpu_torch.runtime import elastic

    real = trainer.whole_state

    def timed():
        torch.cuda.synchronize()
        elastic.reset_census()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        tree = real()
        torch.cuda.synchronize()
        slot = elastic.collective_census().get(
            elastic.CHECKPOINT_LABEL, {"ops": {}, "bytes": 0})
        record.append(dict(
            step=trainer.state.step, world=trainer.world_size,
            ms=1e3 * (time.perf_counter() - t0), bytes=slot["bytes"],
            gathers=slot["ops"].get("all-gather", 0), allocated=base,
            peak=torch.cuda.max_memory_allocated()))
        return tree

    trainer.whole_state = timed


def instrument_saves(ck, record: list) -> None:
    """Record every ``save`` of ``ck`` (rank 0's) into ``record``: its step,
    its host ms (the gather included) and the bytes it wrote."""
    real = ck.save

    def timed(step, tree, **kw):
        t0 = time.perf_counter()
        ok = real(step, tree, **kw)
        record.append(dict(step=step, ms=1e3 * (time.perf_counter() - t0),
                           bytes=sum(os.path.getsize(f) for f in
                                     step_files(str(ck.directory), step))))
        return ok

    ck.save = timed


def tear_copy(directory: str, copy: str) -> int:
    """``copy``: the lineage at ``directory`` as hard links, with its newest
    step's largest file replaced by the first half of its bytes (the
    lineage itself untouched); returns that step."""
    shutil.copytree(directory, copy, copy_function=os.link)
    newest = max(int(p) for p in os.listdir(copy) if p.isdigit())
    victim = max(step_files(copy, newest), key=os.path.getsize)
    with open(victim, "rb") as src, open(victim + ".torn", "wb") as dst:
        dst.write(src.read(os.path.getsize(victim) // 2))
    os.replace(victim + ".torn", victim)
    return newest


def forge_step(directory: str, step: int, forged: int) -> None:
    """Step ``forged`` of the lineage: ``step``'s files (hard links) under
    ``step``'s manifest with the fold of ``['params']['embed']`` changed,
    so its files verify and its leaves do not."""
    shutil.copytree(os.path.join(directory, str(step)),
                    os.path.join(directory, str(forged)),
                    copy_function=os.link)
    mdir = os.path.join(directory, ".integrity")
    with open(os.path.join(mdir, f"{step}.json")) as f:
        manifest = json.load(f)
    key = "['params']['embed']"
    manifest["step"] = forged
    manifest["leaves"][key] = f"{int(manifest['leaves'][key], 16) ^ 1:016x}"
    with open(os.path.join(mdir, f"{forged}.json"), "w") as f:
        json.dump(manifest, f)


def durable_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(o-1), one rank of the fsdp job: (k)'s schedule with its kill and
    restore, each save's gather and rank 0's saves recorded, one sharded
    ``save_async`` after step 9, the final state's digest, and a torn
    newest step restored on both ranks; written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[], gathers=[], saves=[])
    fa.reset_launches()

    def job(n0: int):
        trainer, reg, ids, cfg = durable_world(
            rank, WORLD_RANKS, store, initial_world_size=n0,
            param_sharding="fsdp", spec=FSDP_SPEC)
        instrument(trainer, rec["steps"])
        instrument_gather(trainer, rec["gathers"])
        ck = ElasticCheckpointer(ckpt_dir)
        instrument_saves(ck, rec["saves"])
        return trainer, cfg, VirtualBatches(cfg, ids, reg.get), ck

    trainer, cfg, batches, ck = job(virtual_world(0))
    first = VirtualWorkerLoop(trainer, cfg, batches, checkpointer=ck,
                              ckpt_every=VIRTUAL_CKPT_EVERY).run(
        max_steps=VIRTUAL_KILL_AFTER, world_size_for=virtual_world)
    if rank == 0:
        pause_dir = ckpt_dir + "-pause"
        pk = ElasticCheckpointer(pause_dir, max_to_keep=1)
        t0 = time.perf_counter()
        rec["pause_ms"] = 1e3 * pk.save_async(VIRTUAL_KILL_AFTER,
                                              trainer.whole_state)
        pk.wait_pending()
        rec["persist_ms"] = 1e3 * (time.perf_counter() - t0)
        pk.finalize()
        rec["async_verified"] = pk.latest_verified_step()
        rec["async_same_print"] = (
            pk.manifest(VIRTUAL_KILL_AFTER)["tree_hash"]
            == ck.manifest(VIRTUAL_KILL_AFTER)["tree_hash"])
        shutil.rmtree(pause_dir)
    else:
        trainer.whole_state()
    before = dict(fa.launches)
    rec["kill_world"] = trainer.world_size
    try:
        trainer.step_accumulate(batches.next_step(), abort_after=3)
        rec["killed"] = False
    except AccumulationAborted:
        rec["killed"] = True
    rec["kill_launches"] = {k: fa.launches[k] - before[k] for k in FLASH}
    del trainer, batches
    torch.cuda.empty_cache()

    trainer, cfg, batches, ck = job(WORLD_RANKS)
    loop = VirtualWorkerLoop(trainer, cfg, batches, checkpointer=ck,
                             ckpt_every=VIRTUAL_CKPT_EVERY)
    t0 = time.perf_counter()
    rec["restored"] = loop.restore_latest()
    torch.cuda.synchronize()
    rec["restore_ms"] = 1e3 * (time.perf_counter() - t0)
    second = loop.run(max_steps=VIRTUAL_STEPS - VIRTUAL_KILL_AFTER,
                      world_size_for=virtual_world)
    rec.update(losses=first.losses + second.losses,
               resizes=[first.resizes, second.resizes],
               rows=rows_once([first, second]), final=state_digest(trainer),
               launches=dict(fa.launches))

    torch.distributed.barrier()
    drill = ckpt_dir + "-torn"
    if rank == 0:
        rec["torn"] = tear_copy(ckpt_dir, drill)
    torch.distributed.barrier()
    counters = get_counters()
    c0 = (counters.get("checkpoint_corruption_detected"),
          counters.get("recoveries_completed", type="corrupt_checkpoint"))
    fresh = ElasticCheckpointer(drill)
    t0 = time.perf_counter()
    fresh.restore(trainer_tree(trainer), shardings=trainer)
    torch.cuda.synchronize()
    rec["drill"] = dict(
        fallback=fresh.last_restored_step, hash_ok=fresh.last_restore_hash_ok,
        ms=1e3 * (time.perf_counter() - t0),
        corruption=counters.get("checkpoint_corruption_detected") - c0[0],
        recoveries=counters.get("recoveries_completed",
                                type="corrupt_checkpoint") - c0[1])
    torch.distributed.barrier()
    if rank == 0:
        shutil.rmtree(drill)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def tp_restore_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(o-2), one rank of a tp-2 trainer laid out by FLAGSHIP's partition
    specs: the lineage's newest step restored, its digest, and step 13;
    written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[])
    trainer, reg, ids, cfg = durable_world(
        rank, WORLD_RANKS, store, initial_world_size=WORLD_RANKS,
        param_sharding=tfm.param_partition_specs(DURABLE_CFG),
        spec=TP_SPEC)
    fa.reset_launches()
    loop = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                             checkpointer=ElasticCheckpointer(ckpt_dir))
    t0 = time.perf_counter()
    rec["restored"] = loop.restore_latest()
    torch.cuda.synchronize()
    rec.update(restore_ms=1e3 * (time.perf_counter() - t0),
               state_step=trainer.state.step, digest=state_digest(trainer))
    instrument(trainer, rec["steps"])
    rec["losses"] = loop.run(max_steps=1).losses
    rec["launches"] = dict(fa.launches)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def decode_all(fleet, prompts: list, new_tokens: int) -> list:
    sessions = [fleet.submit(p, max_new_tokens=new_tokens) for p in prompts]
    return [s.wait(600) for s in sessions]


def keep_decoding(fleet, rng, sessions: list,
                  stop: threading.Event) -> threading.Thread:
    """A thread that keeps WATCH_SESSIONS sessions in flight on ``fleet``
    until ``stop``, each appended to ``sessions`` when submitted."""
    def feed():
        while not stop.is_set():
            if fleet.sessions_active() < WATCH_SESSIONS:
                sessions.append(fleet.submit(rng.integers(
                    1, tfm.FLAGSHIP.vocab_size, WATCH_PROMPT_LEN).tolist(),
                    max_new_tokens=WATCH_NEW_TOKENS))
            else:
                time.sleep(0.01)

    thread = threading.Thread(target=feed, name="lineage-feed", daemon=True)
    thread.start()
    return thread


def phase_durable(card: str, control: list, k_drills: dict) -> dict:
    """(o): the sharded lineage: the fsdp job on two ranks sharing the
    card, its newest step restored into a tp-2 and a world-1 trainer, and
    a FLAGSHIP decode fleet reloading the lineage; returns the launches of
    the fsdp job and of the restored trainers' step."""
    torch.cuda.empty_cache()
    fa.reset_launches()
    rng = np.random.default_rng(5)
    with tempfile.TemporaryDirectory() as tmp:
        lineage_dir = os.path.join(tmp, "lineage")
        recs = run_ranks(durable_rank, "o-1", VIRTUAL_CHILD_TIMEOUT_S,
                         lineage_dir)
        tp_recs = run_ranks(tp_restore_rank, "o-2", VIRTUAL_CHILD_TIMEOUT_S,
                            lineage_dir)
        torch.cuda.empty_cache()

        # (o-2) in this process: a world-1 replicated trainer
        trainer, reg, ids, cfg = durable_world(0, 1, None)
        lineage = ElasticCheckpointer(lineage_dir)
        loop = VirtualWorkerLoop(trainer, cfg,
                                 VirtualBatches(cfg, ids, reg.get),
                                 checkpointer=lineage, ckpt_every=1)
        t0 = time.perf_counter()
        w1 = dict(restored=loop.restore_latest())
        torch.cuda.synchronize()
        w1.update(restore_ms=1e3 * (time.perf_counter() - t0),
                  state_step=trainer.state.step,
                  digest=state_digest(trainer))
        again = ElasticCheckpointer(os.path.join(tmp, "world1"))
        t0 = time.perf_counter()
        again.save(w1["restored"], trainer.whole_state)
        w1["save_ms"] = 1e3 * (time.perf_counter() - t0)
        w1["same_print"] = (again.manifest(w1["restored"])["tree_hash"]
                            == lineage.manifest(w1["restored"])["tree_hash"])
        shutil.rmtree(again.directory)

        # (o-3): a fleet from seed-0 weights reloads the lineage
        fleet = flagship_decode_fleet(cfg=DURABLE_CFG, job="lineage")
        t0 = time.perf_counter()
        sv = dict(reloaded=fleet.reload_from_lineage(
            ElasticCheckpointer(lineage_dir)))
        sv.update(reload_ms=1e3 * (time.perf_counter() - t0),
                  generation=fleet.generation)
        prompts = [rng.integers(1, tfm.FLAGSHIP.vocab_size, n).tolist()
                   for n in LINEAGE_PROMPT_LENS]
        sv["tokens"] = decode_all(fleet, prompts, LINEAGE_NEW_TOKENS)
        weights = lineage.restore({"params": llama.param_template(
            DURABLE_CFG)}, step=sv["reloaded"])["params"]
        fresh = flagship_decode_fleet(cfg=DURABLE_CFG, params=weights,
                                      job="lineage-fresh")
        del weights
        sv["fresh_tokens"] = decode_all(fresh, prompts, LINEAGE_NEW_TOKENS)
        fresh.stop()
        del fresh
        torch.cuda.empty_cache()

        # the world-1 trainer takes step 13 and saves it while sessions
        # decode on the watched fleet
        watcher = fleet.watch_lineage(ElasticCheckpointer(lineage_dir),
                                      poll_s=LINEAGE_POLL_S)
        sessions: list = []
        stop = threading.Event()
        feeder = keep_decoding(fleet, rng, sessions, stop)
        while len(sessions) < WATCH_SESSIONS:
            time.sleep(0.01)
        for sess in sessions[:WATCH_SESSIONS]:
            sess.wait_first_token(600)
        w1_steps: list = []
        instrument(trainer, w1_steps)
        before = dict(fa.launches)
        t0 = time.perf_counter()
        w1["losses"] = loop.run(max_steps=1).losses
        sv["step_and_save_ms"] = 1e3 * (time.perf_counter() - t0)
        w1["launches"] = {k: fa.launches[k] - before[k] for k in FLASH}
        newer = trainer.state.step
        t0 = time.perf_counter()
        while (fleet.generation != newer
               and time.perf_counter() - t0 < 4 * LINEAGE_PICKUP_S):
            time.sleep(0.01)
        sv.update(pickup_s=time.perf_counter() - t0,
                  watched=fleet.generation, newer=newer,
                  active_at_pickup=fleet.sessions_active())
        stop.set()
        feeder.join()
        sv["watch_tokens"] = sorted({len(sess.wait(600))
                                     for sess in sessions})
        sv.update(watch_sessions=len(sessions),
                  failed=fleet.sessions_failed)
        watcher.stop()
        forge_step(lineage_dir, newer, newer + 1)
        skipped = get_counters().get("serving_reload_skipped_unverified")
        sv["forged"] = fleet.reload_from_lineage(
            ElasticCheckpointer(lineage_dir))
        sv.update(forged_skipped=get_counters().get(
            "serving_reload_skipped_unverified") - skipped,
            after_forged=fleet.generation)
        fleet.stop()
        del fleet, trainer, loop
        torch.cuda.empty_cache()

    r0, r1 = recs
    failures = []
    n = DURABLE_CFG.n_layers * cfg.vw_count
    print(f"lineage phase (o): FLAGSHIP width at {DURABLE_LAYERS} layers, "
          f"V {cfg.vw_count}, global batch {cfg.global_batch} x {S}, fsdp 2 "
          f"on two ranks sharing the card over gloo, on {card}", flush=True)
    bitwise = r0["losses"] == control
    print(f"lineage fsdp losses {r0['losses']} bitwise (k)'s control "
          f"{bitwise}; rows duplicated {r0['rows']['duplicated']} missing "
          f"{r0['rows']['missing']} of {VIRTUAL_STEPS * cfg.global_batch}; "
          f"resizes {r0['resizes']}; restored step {r0['restored']}",
          flush=True)
    for rec in recs:
        for g in rec["gathers"]:
            print(f"lineage gather rank {rec['rank']} step {g['step']} world "
                  f"{g['world']}: {g['gathers']} all-gathers of "
                  f"{g['bytes']} bytes (census 'checkpoint') in "
                  f"{g['ms']:.2f} ms, memory_allocated "
                  f"{g['allocated'] / 1e9:.4f} GB before, peak "
                  f"{g['peak'] / 1e9:.4f} GB during, on {card}", flush=True)
    kgbps = k_drills["file_bytes"] / k_drills["save_ms"] / 1e6
    for sv_ in r0["saves"]:
        print(f"lineage save step {sv_['step']}: save_ms {sv_['ms']:.2f} "
              f"(gather included) bytes {sv_['bytes']} GB/s "
              f"{sv_['bytes'] / sv_['ms'] / 1e6:.3f}; (k)'s replicated "
              f"save_ms {k_drills['save_ms']:.2f} GB/s {kgbps:.3f} on {card}",
              flush=True)
    print(f"lineage save_async pause_ms {r0['pause_ms']:.2f} (gather "
          f"included) persist_ms {r0['persist_ms']:.2f}; (k)'s replicated "
          f"pause_ms {k_drills['pause_ms']:.2f} persist_ms "
          f"{k_drills['persist_ms']:.2f} on {card}", flush=True)
    print(f"lineage restore_ms fsdp2 {r0['restore_ms']:.2f} (rank 0) "
          f"{r1['restore_ms']:.2f} (rank 1); tp2 "
          f"{tp_recs[0]['restore_ms']:.2f} {tp_recs[1]['restore_ms']:.2f}; "
          f"world1 {w1['restore_ms']:.2f}; "
          f"torn {r0.get('torn')} -> {[r['drill']['fallback'] for r in recs]} "
          f"in {[round(r['drill']['ms'], 2) for r in recs]} ms on {card}",
          flush=True)
    for rec in recs:
        got = sorted({(st["live"], tuple(st["launches"].values()))
                      for st in rec["steps"]})
        print(f"lineage launches rank {rec['rank']}: (live, per step) {got}; "
              f"kill {rec['kill_launches']}; total {rec['launches']}",
              flush=True)
        for st in rec["steps"]:
            want = n if st["live"] else 0
            if set(st["launches"].values()) != {want}:
                failures.append(f"rank {rec['rank']} launches {st}")
        if not rec["killed"] or rec["kill_world"] != 2:
            failures.append(f"rank {rec['rank']}: kill {rec['killed']} on "
                            f"world {rec['kill_world']}")
        if rec["restored"] != VIRTUAL_KILL_AFTER:
            failures.append(f"rank {rec['rank']} restored {rec['restored']}")
        d = rec["drill"]
        drill = (d["fallback"], d["corruption"], d["recoveries"],
                 d["hash_ok"])
        if drill != (VIRTUAL_KILL_AFTER, 1, 1, True):
            failures.append(f"rank {rec['rank']} torn drill {d}")
    if not bitwise:
        failures.append(f"fsdp losses {r0['losses']} vs control {control}")
    if r0["rows"]["duplicated"] or r0["rows"]["missing"]:
        failures.append(f"rows {r0['rows']}")
    if r0["torn"] != VIRTUAL_STEPS:
        failures.append(f"tore step {r0['torn']}")
    if not any(g["world"] == WORLD_RANKS and g["gathers"]
               for g in r0["gathers"]):
        failures.append("no save gathered over fsdp 2")
    if (r0["async_verified"], r0["async_same_print"]) != (
            VIRTUAL_KILL_AFTER, True):
        failures.append(f"save_async {r0['async_verified']} fingerprint "
                        f"equal {r0['async_same_print']}")

    final = r0["final"]
    tp_loss, w1_loss = tp_recs[0]["losses"], w1["losses"]
    print(f"lineage restored into tp2 (step {tp_recs[0]['restored']}, "
          f"counter {tp_recs[0]['state_step']}) bitwise the fsdp job's "
          f"final state {tp_recs[0]['digest'] == final}; into world1 (step "
          f"{w1['restored']}, counter {w1['state_step']}) "
          f"{w1['digest'] == final}; world1 save of it in "
          f"{w1['save_ms']:.2f} ms, manifest fingerprint the fsdp run's "
          f"{w1['same_print']}; step 13 losses tp2 {tp_loss} world1 "
          f"{w1_loss} (limit {WORLD_LOSS_ATOL})", flush=True)
    for rec in tp_recs:
        if (rec["restored"], rec["state_step"]) != (VIRTUAL_STEPS,) * 2:
            failures.append(f"tp rank {rec['rank']} restored "
                            f"{rec['restored']} at {rec['state_step']}")
        for st in rec["steps"]:
            if set(st["launches"].values()) != {n}:
                failures.append(f"tp rank {rec['rank']} launches {st}")
    if tp_recs[0]["digest"] != final or w1["digest"] != final:
        failures.append("a restored state differs from the fsdp job's")
    if (w1["restored"], w1["state_step"]) != (VIRTUAL_STEPS,) * 2:
        failures.append(f"world1 restored {w1['restored']} at "
                        f"{w1['state_step']}")
    if not w1["same_print"]:
        failures.append("the world-1 save's fingerprint differs")
    if (len(tp_loss) != 1 or len(w1_loss) != 1
            or abs(tp_loss[0] - w1_loss[0]) > WORLD_LOSS_ATOL):
        failures.append(f"step 13 losses tp {tp_loss} world1 {w1_loss}")
    if set(w1["launches"].values()) != {n}:
        failures.append(f"world1 launches {w1['launches']}")

    equal = sv["tokens"] == sv["fresh_tokens"]
    print(f"lineage fleet reload_from_lineage -> {sv['reloaded']} "
          f"(generation {sv['generation']}) in {sv['reload_ms']:.2f} ms; "
          f"{len(prompts)} prompts of {list(LINEAGE_PROMPT_LENS)} tokens, "
          f"{LINEAGE_NEW_TOKENS} new, token-equal to a fresh fleet on the "
          f"restored weights {equal}; watch_lineage(poll_s="
          f"{LINEAGE_POLL_S}) shipped step {sv['watched']} (saved "
          f"{sv['newer']}) {sv['pickup_s']:.3f} s after the save, "
          f"{sv['active_at_pickup']} sessions decoding then, "
          f"{sv['watch_sessions']} sessions through the step and the save "
          f"with {sv['watch_tokens']} tokens each, sessions failed "
          f"{sv['failed']}; forged "
          f"step {sv['newer'] + 1} -> {sv['forged']}, "
          f"serving_reload_skipped_unverified +{sv['forged_skipped']}, "
          f"generation {sv['after_forged']} on {card}", flush=True)
    if (sv["reloaded"], sv["generation"]) != (VIRTUAL_STEPS,) * 2:
        failures.append(f"reload {sv['reloaded']} generation "
                        f"{sv['generation']}")
    if not equal:
        failures.append(f"reloaded tokens {sv['tokens']} vs fresh "
                        f"{sv['fresh_tokens']}")
    if (sv["watched"] != sv["newer"] or sv["pickup_s"] > LINEAGE_PICKUP_S
            or not sv["active_at_pickup"] or sv["failed"]
            or sv["watch_tokens"] != [WATCH_NEW_TOKENS]):
        failures.append(f"watch {sv}")
    if (sv["forged"], sv["forged_skipped"], sv["after_forged"]) != (
            None, 1, sv["newer"]):
        failures.append(f"forged step shipped or uncounted: {sv}")
    if failures:
        raise AssertionError("phase (o): " + "; ".join(failures))
    return dict(fsdp={k: r0["launches"][k] + r1["launches"][k]
                      for k in FLASH},
                restore={k: sum(r["launches"][k] for r in tp_recs)
                         + w1["launches"][k] for k in FLASH})


# -- phase (p): the SDC defense plane -----------------------------------------


def sdc_rig(make_trainer, cfg, reg, ids, ck=None, kv=None, worker="w0",
            flight_dir=None, job="sdc"):
    """An SdcPlane whose shadow replays on ``make_trainer()``."""
    shadow = sdc.ShadowRecompute(
        make_trainer, lambda: VirtualBatches(cfg, ids, reg.get), cfg,
        checkpointer=ck)
    return sdc.SdcPlane(
        fingerprinter=sdc.UpdateFingerprinter(kv=kv, job=job, worker=worker),
        detector=sdc.AnomalyDetector(), shadow=shadow, checkpointer=ck,
        flight_dir=flight_dir)


def verdicts(plane) -> list:
    """Each verdict as every rank holds it."""
    return [dict(step=v.step, trigger=v.trigger, outcome=v.outcome,
                 rollback=v.rollback_step, quarantined=v.quarantined)
            for v in plane.verdicts]


def trace_ms(name: str) -> list:
    """The ``elapsed_ms`` of every ``name`` trace event of this process:
    ``sdc_shadow_recompute`` (the judging rank's restore, replay and
    fingerprint) and ``sdc_rollback``."""
    return [e.args["elapsed_ms"] for e in get_tracer().events()
            if e.name == name]


def state_leaves(trainer) -> dict:
    """The trainer's whole state as a tree of tensors on the card."""
    opt = trainer.state.opt_state.state
    return {"params": trainer.state.params,
            "opt": {n: [v for _, v in sorted(opt[p].items())
                        if torch.is_tensor(v) and v.is_cuda]
                    for n, p in trainer.state.params.named_parameters()}}


def fold_drill(trainer) -> dict:
    """The device fold against the host fold on every leaf of the state,
    and the fingerprint's step-loop pause by each, on the card."""
    tree = state_leaves(trainer)
    leaves = list(sdc._leaves_with_path(tree))
    words = sdc.device_tree_folds(tree)
    agree = sum(sdc._mix_tail(w, sdc._nbytes(x), sdc._dtype_name(x))
                == sdc.leaf_fold(x) for (_, x), w in zip(leaves, words))
    pauses = {}
    for name, device in (("device", True), ("host", False)):
        fp = sdc.UpdateFingerprinter()
        fp._prefer_device = device
        fp.record(0, tree)  # the device path's one check against the host
        for i in range(SDC_PAUSE_REPS):
            fp.record(i + 1, tree)
        pauses[name] = 1e3 * float(np.median(fp.pauses_s[1:]))
    return dict(leaves=len(leaves), agree=agree,
                bytes=sum(sdc._nbytes(x) for _, x in leaves), **pauses)


def sdc_single(tmp: str) -> dict:
    """(p-1) in this process: the flip, rolled back."""
    trainer, reg, ids, cfg = durable_world(0, 1, None)
    ck = ElasticCheckpointer(os.path.join(tmp, "p1"))
    plane = sdc_rig(lambda: durable_world(0, 1, None)[0], cfg, reg,
                    ids, ck=ck, flight_dir=os.path.join(tmp, "fr"))
    steps: list = []
    instrument(trainer, steps)
    loop = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                             checkpointer=ck, ckpt_every=SDC_CKPT_EVERY,
                             sdc=plane)

    def strike(step, loss, world):
        if step == SDC_STRIKE_STEP and plane.healthy():
            trainer.flip_param_bits(**SDC_FLIP)

    before = [len(trace_ms(n)) for n in ("sdc_shadow_recompute",
                                          "sdc_rollback")]
    rep = loop.run(max_steps=SDC_STEPS, on_step=strike)
    recs = [f for f in os.listdir(os.path.join(tmp, "fr"))
            if f.endswith(".json")]
    trail = []
    if recs:
        with open(os.path.join(tmp, "fr", recs[0])) as f:
            trail = json.load(f)["extra"]["sdc_verdict_trail"]
    got = dict(losses=rep.losses, rows=rows_once([rep]),
               rollbacks=rep.rollbacks, verdicts=verdicts(plane),
               shadow_ms=trace_ms("sdc_shadow_recompute")[before[0]:],
               rollback_ms=trace_ms("sdc_rollback")[before[1]:], trail=trail,
               launches=[st["launches"] for st in steps],
               folds=fold_drill(trainer))
    ck.close()
    return got


def sdc_poison() -> dict:
    """(p-2) in this process: a poisoned loss report, refuted."""
    trainer, reg, ids, cfg = durable_world(0, 1, None)
    plane = sdc_rig(lambda: durable_world(0, 1, None)[0], cfg, reg,
                    ids)
    engine = FaultPlanEngine(
        FaultPlan(actions=[PoisonLoss(at_step=SDC_STRIKE_STEP - 1)]),
        FaultContext(trainer=trainer))
    before = len(trace_ms("sdc_shadow_recompute"))
    rep = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                            sdc=plane).run(max_steps=SDC_STEPS,
                                           on_step=engine)
    return dict(losses=rep.losses, rollbacks=rep.rollbacks,
                verdicts=verdicts(plane),
                shadow_ms=trace_ms("sdc_shadow_recompute")[before:],
                recovered=engine.recovered)


def sdc_pair(tmp: str) -> dict:
    """(p-3) in this process: two one-rank workers sharing a MemoryKV, a
    corrupt gradient on one of them."""
    kv = sdc.MemoryKV()
    rigs = {}
    for worker in ("wA", "wB"):
        trainer, reg, ids, cfg = durable_world(0, 1, None)
        ck = ElasticCheckpointer(os.path.join(tmp, worker))
        plane = sdc_rig(lambda: durable_world(0, 1, None)[0], cfg,
                        reg, ids, ck=ck, kv=kv, worker=worker, job="pair")
        rigs[worker] = (trainer, VirtualWorkerLoop(
            trainer, cfg, VirtualBatches(cfg, ids, reg.get),
            checkpointer=ck, ckpt_every=SDC_CKPT_EVERY, sdc=plane), plane, ck)
    engine = FaultPlanEngine(
        FaultPlan(actions=[CorruptGradient(at_step=SDC_STRIKE_STEP)]),
        FaultContext(trainer=rigs["wB"][0]))
    before = len(trace_ms("sdc_shadow_recompute"))
    for i in range(1, SDC_STEPS + 1):
        engine(i)
        for worker in ("wA", "wB"):
            rigs[worker][1].run(max_steps=1)
    got = {w: dict(losses=r[1].report.losses, rollbacks=r[1].report.rollbacks,
                   verdicts=verdicts(r[2]))
           for w, r in rigs.items()}
    got.update(quarantined=sorted(sdc.quarantined_names(kv)),
               shadow_ms=trace_ms("sdc_shadow_recompute")[before:],
               recovered=engine.recovered)
    for r in rigs.values():
        r[3].close()
    return got


def sdc_rank(rank: int, store: str, out: str, ckpt_dir: str) -> None:
    """(p-4) and (p-5), one rank: the flip drill on a replicated world of
    2, then a prewarmed and a cold resize 1→2 of fresh trainers."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fa.reset_launches()
    trainer, reg, ids, cfg = durable_world(
        rank, WORLD_RANKS, store, initial_world_size=WORLD_RANKS)
    ck = ElasticCheckpointer(ckpt_dir)
    plane = sdc_rig(lambda: durable_world(
        rank, WORLD_RANKS, store, initial_world_size=1)[0], cfg, reg, ids,
        ck=ck)
    steps: list = []
    instrument(trainer, steps)
    loop = VirtualWorkerLoop(trainer, cfg, VirtualBatches(cfg, ids, reg.get),
                             checkpointer=ck, ckpt_every=SDC_CKPT_EVERY,
                             sdc=plane)

    def strike(step, loss, world):
        if step == SDC_STRIKE_STEP and plane.healthy():
            trainer.flip_param_bits(**SDC_FLIP)

    rep = loop.run(max_steps=SDC_STEPS, on_step=strike)
    rec = dict(rank=rank, losses=rep.losses, rows=rows_once([rep]),
               rollbacks=rep.rollbacks, verdicts=verdicts(plane),
               shadow_ms=trace_ms("sdc_shadow_recompute"),
               rollback_ms=trace_ms("sdc_rollback"),
               launches=[st["launches"] for st in steps])
    del loop, plane, trainer
    torch.cuda.empty_cache()

    for name in ("cold", "prewarmed"):
        trainer, batch = flagship_elastic_world(
            rank, WORLD_RANKS, store, batch=B, seq=S, initial_world_size=1)
        trainer.step(batch)
        if name == "prewarmed":
            trainer.prewarm([WORLD_RANKS])
            rec["quiet"] = trainer.prewarm_quiesce(VIRTUAL_CHILD_TIMEOUT_S)
        rec[name] = dict(resized=trainer.resize(WORLD_RANKS),
                         event=trainer.resize_events[-1],
                         state=checksum(state_tensors(trainer, True)))
        del trainer
        torch.cuda.empty_cache()
    rec["total_launches"] = dict(fa.launches)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_sdc(card: str, control: list) -> dict:
    """(p): the SDC plane's drills and the prewarmed resize, against (k)'s
    control; returns the flash launches of the phase."""
    torch.cuda.empty_cache()
    want = control[:SDC_STEPS]
    fa.reset_launches()
    with tempfile.TemporaryDirectory() as tmp:
        single = sdc_single(tmp)
        torch.cuda.empty_cache()
        poison = sdc_poison()
        torch.cuda.empty_cache()
        pair = sdc_pair(tmp)
        torch.cuda.empty_cache()
        launches = dict(fa.launches)
        recs = run_ranks(sdc_rank, "p", VIRTUAL_CHILD_TIMEOUT_S,
                         os.path.join(tmp, "p4"))
    torch.cuda.empty_cache()
    for k in FLASH:
        launches[k] += sum(r["total_launches"][k] for r in recs)
    f = single["folds"]
    print(f"sdc phase (p): FLAGSHIP width at {DURABLE_LAYERS} layers, V 8, "
          f"{SDC_STEPS} steps, a checkpoint every {SDC_CKPT_EVERY}, strikes "
          f"after step {SDC_STRIKE_STEP}, on {card}", flush=True)
    print(f"sdc device fold vs host fold: {f['agree']} of {f['leaves']} "
          f"leaves equal over {f['bytes']} bytes of state; fingerprint "
          f"pause device {f['device']:.2f} ms host {f['host']:.2f} ms "
          f"(median of {SDC_PAUSE_REPS}) on {card}", flush=True)
    print(f"sdc (p-1) flip: verdicts {single['verdicts']} shadow_ms "
          f"{single['shadow_ms']} rollback_ms "
          f"{single['rollback_ms']} losses {single['losses']} control {want} "
          f"bitwise {single['losses'] == want}; rows {single['rows']}; "
          f"trail {[t['outcome'] for t in single['trail']]} on {card}",
          flush=True)
    print(f"sdc (p-2) poison: verdicts {poison['verdicts']} shadow_ms "
          f"{poison['shadow_ms']} losses "
          f"{poison['losses']} bitwise {poison['losses'] == want}; "
          f"recovered {poison['recovered']} on {card}", flush=True)
    print(f"sdc (p-3) pair: wB verdicts {pair['wB']['verdicts']} shadow_ms "
          f"{pair['shadow_ms']} wA "
          f"{pair['wA']['verdicts']}; quarantined {pair['quarantined']}; "
          f"bitwise wA {pair['wA']['losses'] == want} wB "
          f"{pair['wB']['losses'] == want}; recovered {pair['recovered']} "
          f"on {card}", flush=True)
    for r in recs:
        print(f"sdc (p-4) rank {r['rank']}: verdicts {r['verdicts']} "
              f"shadow_ms {r['shadow_ms']} rollback_ms {r['rollback_ms']} "
              f"bitwise "
              f"{r['losses'] == want}; flash launches a step "
              f"{sorted({tuple(x.values()) for x in r['launches']})} on "
              f"{card}", flush=True)
        for name in ("cold", "prewarmed"):
            e = r[name]["event"]
            print(f"sdc (p-5) rank {r['rank']} {name} resize(2): "
                  f"prewarm_hit {e['prewarm_hit']} compile_ms "
                  f"{e['compile_ms']} reshard_ms {e['reshard_ms']} "
                  f"replan_ms {e['replan_ms']} on {card}", flush=True)
    failures = []
    n = DURABLE_CFG.n_layers * 8
    v = single["verdicts"]
    if (single["rollbacks"] != 1 or len(v) != 1
            or (v[0]["outcome"], v[0]["rollback"], v[0]["step"])
            != ("confirmed", SDC_CKPT_EVERY, SDC_STRIKE_STEP + 1)
            or v[0]["trigger"] not in ("nan", "loss_spike")):
        failures.append(f"(p-1) {single['verdicts']} {single['rollbacks']}")
    if (single["losses"] != want or single["rows"]["duplicated"]
            or single["rows"]["trained"] != SDC_STEPS * B):
        failures.append(f"(p-1) losses {single['losses']} rows "
                        f"{single['rows']}")
    if not single["trail"] or single["trail"][-1]["rollback_step"] != \
            SDC_CKPT_EVERY:
        failures.append(f"(p-1) flight record trail {single['trail']}")
    if any(set(x.values()) != {n} for x in single["launches"]):
        failures.append(f"(p-1) launches {single['launches']}")
    if f["agree"] != f["leaves"]:
        failures.append(f"device fold {f}")
    pv = poison["verdicts"]
    if (len(pv) != 1 or (pv[0]["trigger"], pv[0]["outcome"])
            != ("nan", "refuted") or poison["rollbacks"]
            or poison["losses"] != want
            or poison["recovered"] != ["poison_loss"]):
        failures.append(f"(p-2) {poison}")
    bv = pair["wB"]["verdicts"]
    if (len(bv) != 1 or (bv[0]["trigger"], bv[0]["outcome"],
                         bv[0]["quarantined"])
            != ("fp_mismatch", "confirmed", "wB")
            or pair["wA"]["verdicts"] or pair["quarantined"] != ["wB"]
            or pair["wB"]["rollbacks"] != 1
            or pair["wA"]["losses"] != want or pair["wB"]["losses"] != want
            or pair["recovered"] != ["corrupt_gradient"]):
        failures.append(f"(p-3) {pair}")
    for r in recs:
        if ([(x["step"], x["outcome"], x["rollback"]) for x in r["verdicts"]]
                != [(SDC_STRIKE_STEP + 1, "confirmed", SDC_CKPT_EVERY)]):
            failures.append(f"(p-4) rank {r['rank']} {r['verdicts']}")
        if r["rollbacks"] != 1 or r["losses"] != want:
            failures.append(f"(p-4) rank {r['rank']} {r['losses']}")
        if any(set(x.values()) != {n} for x in r["launches"]):
            failures.append(f"(p-4) rank {r['rank']} launches")
        if (r["cold"]["event"]["prewarm_hit"]
                or not r["prewarmed"]["event"]["prewarm_hit"]
                or not (r["cold"]["resized"] and r["prewarmed"]["resized"])
                or r["cold"]["state"] != r["prewarmed"]["state"]
                or not r["quiet"]):
            failures.append(f"(p-5) rank {r['rank']}")
    if recs[0]["verdicts"] != recs[1]["verdicts"]:
        failures.append("(p-4) the ranks' verdicts differ")
    if failures:
        raise AssertionError("phase (p): " + "; ".join(failures))
    return {k: launches[k] for k in FLASH}


# -- phase (q): the control plane's elastic job ---------------------------------


def instrument_steps(trainer, steps: list) -> None:
    """Record every ``step`` of ``trainer`` into ``steps``: its world,
    whether this rank was live, its loss, its host ms between two
    ``synchronize()``s and its flash launches."""
    real = trainer.step

    def timed(batch):
        before = dict(fa.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = real(batch)
        torch.cuda.synchronize()
        steps.append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in FLASH}))
        return loss

    trainer.step = timed


def local_rank(rank: int, store: str, out: str) -> None:
    """(q), one rank of the elastic job: the lease path on the dial
    LOCAL_DIAL with a lease holder dying with a task after step
    LOCAL_GHOST_AT, then the virtual drive over (k)'s data with one dial
    change; what the rank saw is written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[], virtual_steps=[])
    fa.reset_launches()
    runner, reg, ids = flagship_local_job(rank, WORLD_RANKS, store)
    instrument_steps(runner.trainer, rec["steps"])
    order: list = []
    if rank == 0:
        fetch = runner.fetch

        def counted(payload):
            order.append(json.loads(payload.decode())["shard"])
            return fetch(payload)

        runner.fetch = counted

    def dial(schedule, ghost_at=None):
        def on_step(step, loss, world):
            if runner.cluster is not None and step in schedule:
                runner.cluster.update_trainer_parallelism(runner.job,
                                                          schedule[step])
            if runner.coord is not None and step == ghost_at:
                runner.coord.lease("ghost")
                rec["ghost_released"] = runner.coord.release_worker("ghost")
        return on_step

    rep = runner.run(on_step=dial(LOCAL_DIAL, LOCAL_GHOST_AT))
    rec.update(losses=rep.losses, worlds=rep.world_sizes,
               resizes=rep.resizes, data_ms=rep.data_ms,
               compile_ms=rep.resize_compile_ms,
               reshard_ms=rep.resize_reshard_ms,
               bytes_moved=rep.resize_bytes_moved,
               deferred=rep.resize_deferred_steps,
               prewarm_hits=rep.prewarm_hits, order=order,
               tasks=len(ids) if ids else None,
               all_done=runner.coord.all_done() if rank == 0 else None)
    del runner
    torch.cuda.empty_cache()

    runner, reg, ids = flagship_local_job(
        rank, WORLD_RANKS, store, cfg=DURABLE_CFG, rows=VIRTUAL_ROWS,
        shards=VIRTUAL_SHARDS,
        virtual=VirtualConfig(vw_count=B // VIRTUAL_MICRO_BATCH,
                              global_batch=B))
    instrument(runner.trainer, rec["virtual_steps"])
    vrep = runner.run(max_steps=LOCAL_VIRTUAL_STEPS,
                      on_step=dial(LOCAL_VIRTUAL_DIAL))
    rec.update(virtual_losses=vrep.losses, virtual_worlds=vrep.world_sizes,
               virtual_resizes=vrep.resizes,
               virtual_rows=rows_once([vrep.virtual],
                                      LOCAL_VIRTUAL_STEPS),
               launches=dict(fa.launches))
    del runner
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_local(card: str, control_k: list) -> dict:
    """(q): the elastic job the control plane dials, on two ranks sharing
    the card, against a one-rank control fed rank 0's batches in its order
    (the lease path) and (k)'s control (the virtual drive); returns the
    launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(local_rank, "q", WORLD_CHILD_TIMEOUT_S)
    r0, r1 = recs
    runner, reg, _ = flagship_local_job(0, 1, None)
    trainer = runner.trainer
    control = [trainer.step(reg.get(i)) for i in r0["order"]]
    del runner, trainer
    torch.cuda.empty_cache()
    print(f"local phase (q): FLAGSHIP, global batch {B} x {S} in "
          f"{r0['tasks']} leased tasks, a FakeCluster of two one-card "
          f"nodes dialled {LOCAL_DIAL} after those steps, two ranks "
          f"sharing the card over gloo, on {card}", flush=True)
    for world in sorted(set(r0["worlds"])):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"local world {world} step_ms by rank {ms} median "
              f"{float(np.median(ms[0])):.2f} on {card}", flush=True)
    for rec in recs:
        print(f"local rank {rec['rank']} lease-and-broadcast ms a step "
              f"{[round(x, 3) for x in rec['data_ms']]} median "
              f"{float(np.median(rec['data_ms'])):.3f} (host clock around "
              f"rank 0's lease and pod reading and the frame broadcast)",
              flush=True)
    for i, (c, rs, b) in enumerate(zip(r0["compile_ms"], r0["reshard_ms"],
                                       r0["bytes_moved"])):
        print(f"local resize {i}: compile_ms {c} reshard_ms {rs} "
              f"bytes_moved {b} on {card}", flush=True)
    print(f"local resize_deferred_steps {r0['deferred']} prewarm_hits "
          f"{r0['prewarm_hits']}; worlds {r0['worlds']} resizes "
          f"{r0['resizes']}; tasks trained in order {r0['order']} "
          f"(a ghost lease released {r0.get('ghost_released')}), "
          f"all_done {r0['all_done']}", flush=True)
    diff = [abs(a - b) for a, b in zip(r0["losses"], control)]
    print(f"local losses {[round(x, 6) for x in r0['losses']]} control "
          f"{[round(x, 6) for x in control]} max |job - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    want_v = control_k[:LOCAL_VIRTUAL_STEPS]
    print(f"local virtual losses {r0['virtual_losses']} (k)'s control "
          f"{want_v} bitwise {r0['virtual_losses'] == want_v}; worlds "
          f"{r0['virtual_worlds']}; rows {r0['virtual_rows']}", flush=True)
    failures = []
    want_worlds = []
    world = 1
    for step in range(1, len(r0["order"]) + 1):
        want_worlds.append(world)
        world = LOCAL_DIAL.get(step, world)
    if (sorted(r0["order"]) != list(range(r0["tasks"]))
            or not r0["all_done"] or r0.get("ghost_released") != 1):
        failures.append(f"tasks {r0['order']} all_done {r0['all_done']}")
    for rec in recs:
        if rec["worlds"] != want_worlds or rec["resizes"] != 2:
            failures.append(f"rank {rec['rank']} worlds {rec['worlds']} "
                            f"resizes {rec['resizes']}")
        for st in rec["steps"]:
            want = tfm.FLAGSHIP.n_layers if st["live"] else 0
            if set(st["launches"].values()) != {want}:
                failures.append(f"rank {rec['rank']} launches {st}")
        n = DURABLE_CFG.n_layers * B // VIRTUAL_MICRO_BATCH
        for st in rec["virtual_steps"]:
            if set(st["launches"].values()) != {n if st["live"] else 0}:
                failures.append(f"rank {rec['rank']} virtual launches {st}")
    if r0["deferred"] or not all(np.isfinite(r0["losses"])) \
            or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {r0['losses']} vs control {control}, "
                        f"deferred {r0['deferred']}")
    if (r0["virtual_losses"] != want_v or r0["virtual_resizes"] != 1
            or r0["virtual_rows"]["duplicated"]
            or r0["virtual_rows"]["missing"]):
        failures.append(f"virtual drive {r0['virtual_losses']} "
                        f"{r0['virtual_rows']} resizes "
                        f"{r0['virtual_resizes']}")
    if failures:
        raise AssertionError("phase (q): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (r): BERT-base at tp 2 -----------------------------------------------


def bert_tp_rank(rank: int, store: str, out: str) -> None:
    """(r), one rank: BERT_TP_STEPS steps of BERT-base at tp 2, with what
    one rank can see of them written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = bert_tp_world(rank, WORLD_RANKS, store, batch=BERT_B,
                                   seq=BERT_S)
    norms = [n for n, spec in trainer.partition_specs().items()
             if not any(spec)]
    rec = dict(rank=rank, steps=[])
    fa.reset_launches()
    instrument_steps(trainer, rec["steps"])
    for _ in range(BERT_TP_STEPS):
        trainer.step(batch)
        rec["steps"][-1]["norms"] = checksum(trainer.shards[n]
                                             for n in norms)
        # Adam's moments exist from the first step on
        rec.setdefault("rest", resting_state(trainer))
    rec["launches"] = dict(fa.launches)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def phase_bert_tp(card: str) -> dict:
    """(r): BERT-base MLM at tp 2 on two ranks sharing the card, against a
    world-1 control from the same weights and batch; returns the launches
    of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(bert_tp_rank, "r", WORLD_CHILD_TIMEOUT_S)
    trainer, batch = bert_trainer(BERT_B, BERT_S)
    control = [trainer.step(batch) for _ in range(BERT_TP_STEPS)]
    del trainer, batch
    torch.cuda.empty_cache()
    r0, r1 = recs
    failures = []
    for rec in recs:
        rest = rec["rest"]
        print(f"bert_tp rank {rec['rank']} resting state on tp2: "
              f"{rest['state_bytes'] / 1e9:.4f} GB of params and Adam "
              f"moments (a replicated trainer's rank: "
              f"{rest['replicated_bytes'] / 1e9:.4f} GB), each split "
              f"leaf's share {rest['shares']}, {len(rest['replicated'])} "
              f"whole leaves (the norms and pos) on {card}", flush=True)
        print(f"bert_tp rank {rec['rank']} step_ms "
              f"{[round(st['ms'], 2) for st in rec['steps']]} (b{BERT_B} "
              f"s{BERT_S}; two ranks share one card: not a scaling figure) "
              f"on {card}", flush=True)
        if rest["shares"] != [0.5]:
            failures.append(f"rank {rec['rank']}: shares {rest['shares']}")
        for st in rec["steps"]:
            if st["launches"] != {k: BERT_LAYERS for k in FLASH}:
                failures.append(f"rank {rec['rank']} launches "
                                f"{st['launches']}")
    equal = [a["norms"] == b["norms"] and a["loss"] == b["loss"]
             for a, b in zip(r0["steps"], r1["steps"])]
    losses = [st["loss"] for st in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"bert_tp losses {[round(x, 6) for x in losses]} world-1 control "
          f"{[round(x, 6) for x in control]} max |tp - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL}); norms and losses "
          f"bitwise equal across the ranks {equal}; launches "
          f"{[rec['launches'] for rec in recs]}", flush=True)
    if not all(equal):
        failures.append(f"the ranks' norms or losses differ: {equal}")
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    if failures:
        raise AssertionError("phase (r): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (s): the multi-process elastic job ----------------------------------


def mh_spawn(port: int, name: str, ckpt_dir: str, min_members: int,
             env: dict, log: str, config: str, device: str,
             timeout_s: float, n_layers: int) -> subprocess.Popen:
    """One supervisor of (s): ``python -m
    edl_tpu_torch.runtime.multihost_worker`` against the server on
    ``port``, its output to ``log``; ``timeout_s`` is its process groups'
    timeout and its stall watchdog's floor; ``n_layers`` the model's depth
    (0: the config's)."""
    return subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.runtime.multihost_worker",
         "--coord", f"127.0.0.1:{port}", "--name", name,
         "--ckpt-dir", ckpt_dir, "--min-members", str(min_members),
         "--settle-s", "0.5", "--heartbeat-timeout-s", "10",
         "--init-timeout-s", str(timeout_s),
         "--stall-floor-s", str(timeout_s),
         "--model", "transformer", "--model-config", config,
         "--n-layers", str(n_layers), "--device", device],
        stdout=open(log, "w"), stderr=subprocess.STDOUT, env=env,
        cwd=os.path.dirname(os.path.abspath(__file__)))


def mh_wait_line(log: str, needle: str, procs: dict, deadline: float
                 ) -> str:
    """The first line of ``log`` holding ``needle``; raises when a
    supervisor exits early or the deadline passes."""
    while time.monotonic() < deadline:
        with open(log) as f:
            for line in f:
                if needle in line:
                    return line.strip()
        dead = {n: p.returncode for n, p in procs.items()
                if p.poll() is not None}
        if dead:
            raise AssertionError(f"phase (s): supervisors {dead} exited "
                                 f"before {needle!r} appeared in {log}")
        time.sleep(0.1)
    raise AssertionError(f"phase (s): {needle!r} never appeared in {log}")


def phase_multihost(card: str, config: str = "flagship",
                    device: str = "cuda:0",
                    timeout_s: float = MH_GROUP_TIMEOUT_S,
                    n_layers: int = MH_LAYERS) -> dict:
    """(s): the multi-process elastic job.  The port's native server; two
    supervisors form a world of 2 on the card, one is SIGKILLed, the
    survivor reforms a world of 1 from the newest generation, a third
    joins late and a world of 2 forms again, until the queue drains; the
    model ``config`` at ``n_layers`` layers (0: the config's depth).
    Returns the flash launches of every world child summed.
    (``scripts/time_multihost.py`` runs it over NCCL, one card a rank.)"""
    from edl_tpu_torch.coord import bindings
    from edl_tpu_torch.coord.server import spawn_server
    from edl_tpu_torch.runtime.multihost import world_backend

    torch.cuda.empty_cache()
    bindings.ensure_built()
    srv = spawn_server(member_ttl_ms=MH_MEMBER_TTL_MS,
                       task_timeout_ms=MH_TASK_TIMEOUT_MS)
    binary = srv.process.args[0]
    print(f"multihost server: {os.path.relpath(binary)} (built in "
          f"{bindings.last_build_s:.2f} s) on port {srv.port}", flush=True)
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mh-")
    procs: dict = {}
    try:
        if not os.path.abspath(binary).startswith(
                os.path.join(root, "build", "edl_tpu_torch") + os.sep):
            raise AssertionError(f"phase (s): server binary {binary} is "
                                 "not the port's build")
        env = dict(os.environ, PYTHONPATH=root,
                   EDL_MH_EXAMPLES=str(MH_TASKS * MH_ROWS),
                   EDL_MH_SHARDS=str(MH_TASKS), EDL_MH_BATCH=str(MH_ROWS),
                   EDL_MH_SEQ=str(S), EDL_MH_CKPT_EVERY=str(MH_CKPT_EVERY),
                   EDL_MH_STEP_SLEEP=str(MH_STEP_SLEEP_S),
                   EDL_MH_DIGEST="1",
                   EDL_MH_DIE_WITH_PARENT="1")
        logs = {n: os.path.join(tmp, f"{n}.log") for n in ("w0", "w1", "w2")}
        ckpt = os.path.join(tmp, "ckpt")
        deadline = time.monotonic() + MH_TIMEOUT_S
        for n in ("w0", "w1"):
            procs[n] = mh_spawn(srv.port, n, ckpt, 2, env, logs[n], config,
                                device, timeout_s, n_layers)
        mh_wait_line(logs["w0"], f" step {MH_KILL_AFTER} ", procs, deadline)
        t_kill = time.time()
        procs["w1"].kill()
        procs["w1"].wait(30)
        killed = procs.pop("w1")
        mh_wait_line(logs["w0"], " world=1 ms=", procs, deadline)
        procs["w2"] = mh_spawn(srv.port, "w2", ckpt, 1, env, logs["w2"],
                               config, device, timeout_s, n_layers)
        rcs = {}
        for n, p in procs.items():
            rcs[n] = p.wait(max(deadline - time.monotonic(), 1.0))
        client = srv.client()
        stats, all_done = client.stats(), client.all_done()
        metrics = client.server_metrics()
        client.close()
        texts = {n: open(path).read() for n, path in logs.items()}
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase (s): the job ran past {MH_TIMEOUT_S} s")
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(30)
        srv.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"multihost phase (s): {config.upper()} "
          f"({n_layers or 'all its'} layers) over "
          f"{MH_TASKS} leased tasks of {MH_ROWS} x {S} tokens, supervisors "
          f"w0 and w1 on {device} over {world_backend(device)}, w1 "
          f"SIGKILLed after step "
          f"{MH_KILL_AFTER}, w2 joining once w0 trains on a world of 1, "
          f"a generation every {MH_CKPT_EVERY} steps, on {card}", flush=True)
    failures = []
    worlds, entries, steps = {}, {}, {}
    for n, text in texts.items():
        worlds[n] = [(int(log_field(ln, "world")), log_field(ln, "members"))
                     for ln in text.splitlines() if "devices ready" in ln]
        entries[n] = [ln for ln in text.splitlines()
                      if "entering world" in ln]
        steps[n] = step_records(text.splitlines())
        for ln in text.splitlines():
            if "world_phases" in ln or "saved generation" in ln:
                print(f"multihost {ln.strip()}", flush=True)
    saved = {}
    for text in texts.values():
        for ln in text.splitlines():
            if "saved generation" in ln:
                saved[ln.split("saved generation ", 1)[1].split()[0]] = (
                    int(log_field(ln, "step")), log_field(ln, "digest"))
    cold = [d for f, (st, d) in saved.items() if st == 0]
    print(f"multihost worlds w0 {worlds['w0']} w1 {worlds['w1']} w2 "
          f"{worlds['w2']}; exits {rcs} (w1 SIGKILLed: "
          f"{killed.returncode}); tasks {stats}, all_done {all_done}",
          flush=True)
    if rcs != {"w0": 0, "w2": 0} or killed.returncode != -signal.SIGKILL:
        failures.append(f"exits {rcs}, w1 {killed.returncode}")
    if (stats.done != MH_TASKS or stats.todo or stats.leased
            or stats.dropped or not all_done):
        failures.append(f"tasks {stats} all_done {all_done}")
    if (worlds["w0"] != [(2, "w0,w1"), (1, "w0"), (2, "w0,w2")]
            or worlds["w1"] != [(2, "w0,w1")]
            or worlds["w2"] != [(2, "w0,w2")]):
        failures.append(f"worlds {worlds}")
    # the reformed world starts bitwise from the newest generation the
    # world of 2 saved, the late joiner from the one the world of 1 ended
    # on, and neither from a cold init
    starts = [(n, log_field(ln, "digest"), int(ln.rsplit("step=", 1)[1]))
              for n, k in (("w0", 1), ("w2", 0)) for ln in entries[n][k:k + 1]]
    epoch_2 = log_field(entries["w0"][0], "epoch") if entries["w0"] else None
    newest_2 = max((pair for f, pair in saved.items()
                    if f.startswith(f"mid-{epoch_2}-")), default=None)
    # w0's steps in its first world of 2 (up to the kill) and in world 1
    reform = next((i for i, st in enumerate(steps["w0"])
                   if st["world"] == 1), 0)
    w0_1 = [st for st in steps["w0"][reform:] if st["world"] == 1]
    if not reform or not w0_1:
        raise AssertionError("phase (s): " + "; ".join(
            failures + ["w0 never trained on a world of 1 after one of 2"]))
    before_kill = max(st["step"] for st in steps["w0"][:reform])
    last_1 = max(st["step"] for st in w0_1)
    print(f"multihost restores (worker, digest, step): {starts}; saved "
          f"generations {saved}; cold init {cold}; w0 must resume at the "
          f"newest mid-world generation of epoch {epoch_2} {newest_2}, w2 "
          f"at w0's last world-1 step {last_1}", flush=True)
    lost = before_kill - starts[0][2] if starts else None
    if (len(starts) != 2
            or any((st, d) not in saved.values() or d in cold
                   for _, d, st in starts)
            or (starts[0][2], starts[0][1]) != newest_2
            or starts[1][2] != last_1 or not 0 <= lost <= MH_CKPT_EVERY):
        failures.append(f"restores {starts} (lost {lost}), want w0 at "
                        f"{newest_2} and w2 at step {last_1}")
    first_1 = w0_1[0]
    aborted = [float(log_field(ln, "wall")) for ln in texts["w0"].splitlines()
               if "aborted wall=" in ln]
    ready = [float(log_field(ln, "wall")) for ln in texts["w0"].splitlines()
             if "devices ready" in ln and "world=1 " in ln]
    abort = (f"{aborted[0] - t_kill:.3f} s" if aborted else
             "not logged (ended by a signal: NCCL's watchdog or the stall "
             "watchdog's)")
    print(f"multihost kill to w0's world child aborting {abort}, to the "
          f"world of 1's devices ready "
          f"{ready[0] - t_kill if ready else float('nan'):.3f} s, to its "
          f"first step {first_1['wall'] - t_kill:.3f} s", flush=True)
    print(f"multihost kill to the reformed world's first step "
          f"{first_1['wall'] - t_kill:.3f} s; steps lost to the kill "
          f"{lost} (w0 had finished step {before_kill}, the world of 1 "
          f"resumed at step {starts[0][2] if starts else None})", flush=True)
    for world in (2, 1):
        ms = {n: [round(st["ms"], 2) for st in steps[n]
                  if st["world"] == world and st["loss"] != 0]
              for n in texts}
        shared = ("two ranks share one card over gloo: not a scaling figure"
                  if world_backend(device) == "gloo"
                  else "one card a rank over nccl")
        print(f"multihost world {world} step_ms {ms} ({shared}; a step of "
              f"the leader that drains a generation save is slower) on "
              f"{card}", flush=True)
    print(f"multihost server_metrics {metrics}", flush=True)
    depth = n_layers or tfm.FLAGSHIP.n_layers
    want = depth if device.startswith("cuda") else 0
    losses = [st["loss"] for n in texts for st in steps[n]]
    bad = [(n, st) for n in texts for st in steps[n]
           if st["launches"] != [want if st["loss"] != 0 else 0] * 3]
    if bad or not losses or not all(np.isfinite(losses)):
        failures.append(f"launches or losses {bad[:3]} {losses[:4]}")
    for n in ("w0", "w2"):
        if "supervisor cuda initialized False" not in texts[n]:
            failures.append(f"{n}'s supervisor initialised CUDA")
    if failures:
        raise AssertionError("phase (s): " + "; ".join(failures))
    total = {k: 0 for k in FLASH}
    for n in texts:
        for st in steps[n]:
            for k, c in zip(sorted(FLASH), st["launches"]):
                total[k] += c
    return total


# -- phase (t): the autoscaled job under a seeded fault campaign ---------------


def controlled_rank(rank: int, store: str, out: str) -> None:
    """(t), one rank of the job a ``Controller`` runs: the FLAGSHIP
    trainer, on rank 0 the control plane; ``entry.controlled_campaign``
    fires the eight training kinds from CONTROLLED_SEED while a system pod
    gives the second card back after step CONTROLLED_RELEASE_AT and takes it
    again after CONTROLLED_RETURN_AT; what the rank saw is written as JSON
    to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[], restarts_s=[])
    fa.reset_launches()
    runner, plane, reg = flagship_controlled_job(rank, WORLD_RANKS, store,
                                                 cfg=DURABLE_CFG)
    instrument_steps(runner.trainer, rec["steps"])
    order: list = []
    if plane is not None:
        fetch, restart = runner.fetch, plane.restart_coordinator

        def counted(payload):
            order.append(json.loads(payload.decode())["shard"])
            return fetch(payload)

        def timed_restart():
            t0 = time.perf_counter()
            restart()
            rec["restarts_s"].append(time.perf_counter() - t0)

        runner.fetch = counted
        plane.restart_coordinator = timed_restart

    def elasticity(step, loss, world):
        if plane is None:
            return
        if step == CONTROLLED_RELEASE_AT:
            plane.cluster.remove_system_pod("hold-node1")
        if step == CONTROLLED_RETURN_AT:
            plane.cluster.add_system_pod("hold-node1", "node1", gpus=1)

    got = controlled_campaign(
        runner, plane, CONTROLLED_SEED, first_step=CONTROLLED_FIRST,
        last_step=CONTROLLED_LAST, min_gap=CONTROLLED_GAP,
        save_every=CONTROLLED_SAVE_EVERY, on_step=elasticity)
    rep = got["report"]
    rec.update(losses=rep.losses, worlds=rep.world_sizes,
               resizes=rep.resizes, resize_steps=rep.resize_steps,
               resize_seconds=rep.resize_seconds, data_ms=rep.data_ms,
               compile_ms=rep.resize_compile_ms,
               reshard_ms=rep.resize_reshard_ms,
               bytes_moved=rep.resize_bytes_moved, order=order,
               step_ends=got["steps"], launches=dict(fa.launches))
    if plane is not None:
        stats = plane.coord.stats()
        counters = get_counters()
        rec.update(
            {k: got[k] for k in ("plan", "fired", "recovered", "unfired",
                                 "quiescent", "fired_s", "recovered_s",
                                 "stalls", "audit", "saves")},
            ticks=plane.controller.autoscaler.tick_history,
            stats=dict(done=stats.done, todo=stats.todo, leased=stats.leased,
                       dropped=stats.dropped),
            injected={k: counters.get("faults_injected", type=k)
                      for k in TRAINING_KINDS},
            recoveries={k: counters.get("recoveries_completed", type=k)
                        for k in TRAINING_KINDS},
            tasks=CONTROLLED_SHARDS)
        plane.close()
        rec["leaked"] = plane.leaked_servers()
    del runner
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def recovery_seconds(fired, fired_s, recovered_s) -> list:
    """Each fired fault's (step, kind, seconds from firing to its watched
    recovery, or None when the engine watches none)."""
    pending = list(recovered_s)
    out = []
    for (step, kind), t in zip(fired, fired_s):
        hit = next((r for r in pending if r[0] == kind and r[1] >= t), None)
        if hit is not None:
            pending.remove(hit)
        out.append((step, kind, None if hit is None else hit[1] - t))
    return out


def tick_latencies(r0: dict) -> list:
    """Each autoscaler plan: (target, seconds from the tick's start to the
    resize that took the job to that world, or None)."""
    starts = [end - secs for (end, _), secs in
              zip([r0["step_ends"][s] for s in r0["resize_steps"]],
                  r0["resize_seconds"])]
    worlds = [r0["worlds"][s] for s in r0["resize_steps"]]
    out = []
    for t, targets in r0["ticks"]:
        n = next(iter(targets.values()))
        hit = next((st for st, w in zip(starts, worlds)
                    if w == n and st >= t), None)
        out.append((n, None if hit is None else hit - t))
    return out


def phase_controlled(card: str) -> dict:
    """(t): the FLAGSHIP job a ``Controller`` runs, on two ranks sharing the
    card, its autoscaler alone growing it to 2 when a card frees and
    shrinking it to 1 when the card is taken back, under a seeded campaign
    of the eight training fault kinds; against a one-rank control fed rank
    0's batches in its order.  Returns the launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(controlled_rank, "t", CONTROLLED_TIMEOUT_S)
    r0, r1 = recs
    runner, reg, _ = flagship_local_job(0, 1, None, cfg=DURABLE_CFG,
                                        rows=CONTROLLED_ROWS,
                                        shards=CONTROLLED_SHARDS)
    trainer = runner.trainer
    control = [trainer.step(reg.get(i)) for i in r0["order"]]
    del runner, trainer
    torch.cuda.empty_cache()
    print(f"controlled phase (t): FLAGSHIP at {DURABLE_LAYERS} of its "
          f"{tfm.FLAGSHIP.n_layers} layers, global batch {B} x {S} in "
          f"{r0['tasks']} leased tasks, a Controller (max_load_desired 1.0) "
          f"over a FakeCluster of two one-card nodes in two NVLink domains, "
          f"the second card held until step {CONTROLLED_RELEASE_AT} and "
          f"taken again at step {CONTROLLED_RETURN_AT}; campaign seed "
          f"{CONTROLLED_SEED} "
          f"{[(d['kind'], d['at_step']) for d in r0['plan']]}"
          f"; two ranks sharing the card over gloo, on {card}", flush=True)
    for world in sorted(set(r0["worlds"])):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"controlled world {world} step_ms by rank {ms} median "
              f"{float(np.median(ms[0])):.2f} on {card}", flush=True)
    for target, secs in tick_latencies(r0):
        print(f"controlled autoscaler tick -> target {target}: tick to "
              f"resize {secs if secs is None else round(secs, 3)} s",
              flush=True)
    for i, (c, rs, b) in enumerate(zip(r0["compile_ms"], r0["reshard_ms"],
                                       r0["bytes_moved"])):
        print(f"controlled resize {i} to world "
              f"{r0['worlds'][r0['resize_steps'][i]]}: compile_ms {c} "
              f"reshard_ms {rs} bytes_moved {b} on {card}", flush=True)
    recovery = recovery_seconds(r0["fired"], r0["fired_s"],
                                r0["recovered_s"])
    for step, kind, secs in recovery:
        print(f"controlled fault {kind} at step {step}: fire to recovery "
              f"{'not watched' if secs is None else f'{secs:.3f} s'}",
              flush=True)
    print(f"controlled coordinator respawn s "
          f"{[round(x, 3) for x in r0['restarts_s']]}; stalls (silent_s, "
          f"deadline_s) {r0['stalls']}; corruption audit {r0['audit']}",
          flush=True)
    saves = [(st, round(ms, 2), ok) for st, ms, ok in r0["saves"]]
    print(f"controlled save ms {saves}"
          f" on {card}", flush=True)
    print(f"controlled worlds {r0['worlds']} resizes {r0['resizes']}; "
          f"tasks trained in order {r0['order']}; coordinator stats "
          f"{r0['stats']}; faults_injected {r0['injected']} "
          f"recoveries_completed {r0['recoveries']}", flush=True)
    diff = [abs(a - b) for a, b in zip(r0["losses"], control)]
    print(f"controlled losses {[round(x, 6) for x in r0['losses']]} control "
          f"{[round(x, 6) for x in control]} max |job - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    failures = []
    if any(n < 1 for n in r0["injected"].values()) or not r0["quiescent"]:
        failures.append(f"faults {r0['injected']} unfired {r0['unfired']}")
    for kind in ("kill_trainer", "kill_coordinator", "network_flake",
                 "preempt_domain", "stall_step", "wedge_collective",
                 "corrupt_checkpoint", "disk_full"):
        if r0["recoveries"][kind] < 1:
            failures.append(f"no recovery of {kind}")
    if len(r0["audit"]) != 1 or r0["audit"][0]["hash_ok"] is False:
        failures.append(f"corruption audit {r0['audit']}")
    if (len(r0["stalls"]) != 2 or None in r0["stalls"]
            or any(sl > 2 * dl for sl, dl in r0["stalls"])):
        failures.append(f"stalls {r0['stalls']}")
    if r0["stats"] != dict(done=r0["tasks"], todo=0, leased=0, dropped=0) \
            or sorted(set(r0["order"])) != list(range(r0["tasks"])):
        failures.append(f"tasks {r0['order']} stats {r0['stats']}")
    worlds = r0["worlds"]
    if (2 not in worlds[CONTROLLED_RELEASE_AT:CONTROLLED_RETURN_AT + 2]
            or worlds[-1] != 1 or worlds[0] != 1
            or r1["worlds"] != worlds):
        failures.append(f"worlds {worlds} / {r1['worlds']}")
    for rec in recs:
        for st in rec["steps"]:
            want = DURABLE_LAYERS if st["live"] else 0
            if set(st["launches"].values()) != {want}:
                failures.append(f"rank {rec['rank']} launches {st}")
    if len(r0["losses"]) != len(control):
        failures.append(f"{len(r0['losses'])} steps trained, "
                        f"{len(control)} tasks fetched")
    if not all(np.isfinite(r0["losses"])) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {r0['losses']} vs control {control}")
    if r0["leaked"]:
        failures.append(f"{r0['leaked']} coordinator servers left running")
    if failures:
        raise AssertionError("phase (t): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (u): the single-shot serving plane --------------------------------


def follow_pods(fleet, cluster, job, stop: threading.Event,
                errors: list) -> None:
    """(u): the harness's kubelet: every SCORE_FOLLOW_S the fleet's replica
    count becomes the job's Running server pods."""
    while not stop.wait(SCORE_FOLLOW_S):
        try:
            n = sum(p.phase.value == "Running" for p in cluster.list_pods(
                job_uid=job.full_name, role="server"))
            if n and n != fleet.replicas_active():
                fleet.scale_to(n)
        except Exception as exc:  # surfaced by the phase's gates
            errors.append(repr(exc))
            return


def closed_loop_capacity(fleet, rows: np.ndarray, seconds: float) -> float:
    """(u): C, the rows a second the fleet serves with two batches of
    requests always in flight (saturated)."""
    inflight: list = []
    served, i = 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        while len(inflight) < 2 * fleet.max_batch_size:
            inflight.append(fleet.submit((rows[i % len(rows)],)))
            i += 1
        inflight.pop(0).wait(60)
        served += 1
    elapsed = time.perf_counter() - t0
    for req in inflight:
        req.wait(60)
    return served / elapsed


def scoring_check(answers: dict, refs: dict, rows_of: dict,
                  phase: str = "u") -> None:
    """(u), (v): each generation's sampled answers against the plain
    attention path's last-token logits of their rows on that generation,
    by (d)'s rule; the control (each answer against another row's
    reference) must fail it."""
    for gen, got in answers.items():
        ref = refs[gen]
        got = torch.from_numpy(np.stack(got)).to(ref.device)
        rms = ref.float().square().mean().sqrt().item()
        r, c = (kc.reading(x, ref, kc.BF16_RTOL, MODEL_ATOL * rms)
                for x in (got, got.roll(1, 0)))
        print(f"model check: scoring answers of generation {gen} "
              f"(rows {rows_of[gen]}) vs plain attention logits max |diff| "
              f"{r['max_abs_err']:.4f}, {r['worst']:.3f} of the limit "
              f"(floor needed {r['need_atol']:.4f} rms); another row's "
              f"{c['worst']:.3f} of it ({c['need_atol']:.4f} rms)",
              flush=True)
        if not r["worst"] <= 1.0:
            raise AssertionError(f"phase ({phase}): generation {gen}'s "
                                 "answers off the plain path")
        if c["worst"] <= 1.0:
            raise AssertionError(f"phase ({phase}): the scoring check "
                                 "passes its control")


def serve_main_drill(card: str, device: str = "cuda",
                     frontdoor: str = "legacy") -> dict:
    """(u-2), and (v-3) with ``frontdoor="async"``: ``python -m
    edl_tpu_torch.runtime.serving`` over a lineage holding generation 1 of
    the MLP SERVE_MAIN_MODEL (seed 0), on the given front door: /healthz,
    SERVE_MAIN_ROWS rows against the plain MLP (on the async door also
    pipelined over one socket, JSON and raw f32 in turn, answered in
    order), generation 2 (seed 1) saved and picked up, SIGTERM."""

    from edl_tpu_torch.models import mlp

    tmp = tempfile.mkdtemp(prefix="smoke-serve-main-")
    sizes = list(SERVE_MAIN_MODEL)
    gens = {g: mlp.MLP(sizes, device="cpu", seed=g - 1) for g in (1, 2)}
    ck = ElasticCheckpointer(os.path.join(tmp, "lineage"))
    ck.save(1, {"params": gens[1]})
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, EDL_SERVING_MODEL_DIR=os.path.join(tmp, "lineage"),
               EDL_SERVING_MODEL="mlp:" + ",".join(map(str, sizes)),
               EDL_SERVING_FRONTDOOR=frontdoor, EDL_SERVING_PORT="0",
               EDL_HEALTH_PORT="-1",
               EDL_SERVING_RELOAD_POLL_S=str(SERVE_MAIN_POLL_S),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log = os.path.join(tmp, "server.log")
    rows = np.random.default_rng(4).normal(
        size=(SERVE_MAIN_ROWS, sizes[0])).astype(np.float32)
    with torch.no_grad():
        want = {g: mlp.apply(m, torch.from_numpy(rows)).numpy()
                for g, m in gens.items()}

    def post(port: int, row) -> dict:
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}/predict",
            data=json.dumps({"inputs": row.tolist()}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            return json.loads(r.read())

    def answers(port: int, gen: int) -> float:
        worst = 0.0
        for row, w in zip(rows, want[gen]):
            doc = post(port, row)
            got = np.asarray(doc["outputs"], np.float32)
            if doc["generation"] != gen or not np.allclose(
                    got, w, rtol=1e-5, atol=1e-5):
                raise AssertionError(
                    f"phase (u-2): generation {doc['generation']} answer "
                    f"{got} for generation {gen}'s {w}")
            worst = max(worst, float(np.abs(got - w).max()))
        return worst

    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "edl_tpu_torch.runtime.serving",
             "--device", device], stdout=out, stderr=subprocess.STDOUT,
            env=env, cwd=root)
    try:
        port = None
        deadline = time.monotonic() + SERVE_MAIN_TIMEOUT_S
        while port is None and time.monotonic() < deadline:
            if proc.poll() is not None:
                break
            with open(log) as f:
                for line in f:
                    if line.startswith("model server ready port="):
                        port = int(line.split("port=")[1].split()[0])
            time.sleep(0.1)
        if port is None:
            with open(log) as f:
                raise AssertionError("phase (u-2): no ready line:\n"
                                     + f.read()[-3000:])
        ready_s = time.perf_counter() - t0
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                    timeout=10) as r:
            health = r.status
        if health != 200:
            raise AssertionError(f"phase (u-2): /healthz {health}")
        err1 = answers(port, 1)
        if frontdoor == "async":
            err1 = max(err1, pipelined_answers(port, rows, want[1]))
        t_save = time.perf_counter()
        ck.save(2, {"params": gens[2]})
        saved = time.perf_counter()
        pickup = None
        while time.perf_counter() - saved < SERVE_MAIN_PICKUP_S:
            if post(port, rows[0])["generation"] == 2:
                pickup = time.perf_counter() - saved
                break
            time.sleep(0.05)
        if pickup is None:
            raise AssertionError("phase (u-2): generation 2 not served "
                                 f"within {SERVE_MAIN_PICKUP_S} s")
        err2 = answers(port, 2)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            with open(log) as f:
                raise AssertionError(f"phase (u-2): exit {rc} on SIGTERM:\n"
                                     + f.read()[-3000:])
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(10)
        ck.close()
        shutil.rmtree(tmp, ignore_errors=True)
    out = dict(ready_s=ready_s, err1=err1, err2=err2,
               save_s=saved - t_save, pickup_s=pickup)
    print(f"serve_main mlp:{','.join(map(str, sizes))} on {device} "
          f"({frontdoor} front door): ready "
          f"in {ready_s:.2f} s, /healthz 200, {SERVE_MAIN_ROWS} rows of "
          f"generation 1 max |diff| {err1:.3e} vs the plain MLP; "
          f"generation 2 saved in {out['save_s']:.3f} s and served "
          f"{pickup:.3f} s after (poll {SERVE_MAIN_POLL_S} s), "
          f"{SERVE_MAIN_ROWS} rows max |diff| {err2:.3e}; SIGTERM exit 0 "
          f"on {card}", flush=True)
    return out


def pipelined_answers(port: int, rows: np.ndarray, want: np.ndarray
                      ) -> float:
    """(v-3): every row pipelined over ONE socket, JSON and raw f32 in
    turn; the answers must come back in order, each within 1e-5 of the
    plain MLP.  Returns the largest difference."""
    from edl_tpu_torch.runtime.frontdoor import build_predict_request

    blob = b""
    for i, row in enumerate(rows):
        if i % 2:
            body = json.dumps({"inputs": row.tolist()}).encode()
            blob += (b"POST /predict HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body)) + body
        else:
            blob += build_predict_request(row)
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(blob)
        reader = WireReader(sock)
        worst = 0.0
        for i, w in enumerate(want):
            status, head, body = reader.next(timeout=30)
            got = (np.asarray(json.loads(body)["outputs"], np.float32)
                   if i % 2 else np.frombuffer(body, "<f4"))
            if status != 200 or not np.allclose(got, w, rtol=1e-5,
                                                atol=1e-5):
                raise AssertionError(f"phase (v-3): pipelined row {i} "
                                     f"answered {status} {got} for {w}")
            worst = max(worst, float(np.abs(got - w).max()))
    return worst


def phase_serving_plane(card: str, cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                        device: str = "cuda", seq: int = S) -> dict:
    """(u): the FLAGSHIP scoring fleet dialled by the controller's SLO
    policy through capacity, steady, burst (with a rolling reload onto
    generation 2) and trickle traffic, then serve_main as a pod runs it.
    ``cfg``, ``device`` and ``seq`` let the phase be rehearsed on the CPU
    at TINY.  Returns the kernels' launches on the fleet's path."""
    from edl_tpu_torch.api.types import (JobPhase, ResourceRequirements,
                                         ServingJob, ServingSpec)
    from edl_tpu_torch.cluster.fake import FakeCluster
    from edl_tpu_torch.controller import Controller
    from edl_tpu_torch.coord import PyCoordService

    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    kv = PyCoordService()
    job_name = "flagship-scoring"
    fleet = flagship_scoring_fleet(
        device=device, params=tfm.Transformer(cfg, device=dev, seed=0),
        seq=seq, job=f"default/{job_name}", max_batch_size=SCORE_BATCH,
        max_queue_ms=SCORE_QUEUE_MS, slo_p99_ms=SCORE_SLO_MS, kv=kv)
    built: list = []
    new_replica = fleet._new_replica

    def tracked(slot):
        r = new_replica(slot)
        built.append(r)
        return r

    fleet._new_replica = tracked
    fleet.scale_to(1)
    # generation 2: one step of a trainer of the same model, saved into a
    # lineage the fleet reloads from mid-burst (before the counts are set
    # to 0: the step runs the backward kernels)
    trainer, batch = flagship_trainer(SCORE_BATCH, seq, device=device,
                                      cfg=cfg)
    gen2_loss = trainer.step(batch)
    lineage = tempfile.mkdtemp(prefix="smoke-scoring-lineage-")
    ck = ElasticCheckpointer(lineage)
    t0 = time.perf_counter()
    ck.save(2, {"params": trainer.state.params})
    gen2_save_s = time.perf_counter() - t0
    gen2 = trainer.state.params
    del trainer, batch
    rows = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (256, seq), dtype=np.int64)

    cluster = FakeCluster()
    for name, domain in (("node0", "nvlink0"), ("node1", "nvlink1")):
        cluster.add_node(name, cpu_milli=16_000, memory_mega=64_000, gpus=1,
                         nvlink_domain=domain)
    ctl = Controller(cluster, updater_convert_seconds=0.05,
                     updater_confirm_seconds=0.025,
                     serving_stats_for=lambda uid: fleet.stats(
                         window_s=SCORE_WINDOW_S),
                     serving_loop_seconds=SCORE_LOOP_S,
                     coord_for=lambda job: kv)
    scaler = ctl.serving_scaler
    scaler.hint_sink = lambda uid, n: fleet.hint(n)
    scaler.scale_down_cooldown_s = SCORE_DOWN_COOLDOWN_S
    stop, errors = threading.Event(), []
    follower = None
    tallies, sent = {}, []
    try:
        zero_launch_counts()
        forwards0 = {id(r): r.server.forwards for r in built}
        capacity = closed_loop_capacity(fleet, rows, SCORE_CAPACITY_S)
        time.sleep(SCORE_WINDOW_S)  # C's completions leave the window
        job = ServingJob(name=job_name, spec=ServingSpec(
            min_replicas=1, max_replicas=2, slo_p99_ms=SCORE_SLO_MS,
            target_qps_per_replica=SCORE_TARGET_SHARE * capacity,
            max_batch_size=SCORE_BATCH, max_queue_ms=SCORE_QUEUE_MS,
            resources=ResourceRequirements(requests={"cpu": "1"},
                                           limits={"nvidia.com/gpu": "1"})))
        ctl.start()
        ctl.submit(job)
        deadline = time.monotonic() + 30
        while ctl.phase(job) != JobPhase.RUNNING:
            if time.monotonic() > deadline:
                raise AssertionError(f"phase (u): job {ctl.phase(job)}")
            time.sleep(0.02)
        follower = threading.Thread(
            target=follow_pods, args=(fleet, cluster, job, stop, errors),
            daemon=True)
        follower.start()

        def make_row(i):
            return (rows[i % len(rows)],)

        reload: dict = {}
        restore = ck.restore

        def timed_restore(*args, **kw):
            t = time.perf_counter()
            got = restore(*args, **kw)
            reload["restore_ms"] = 1e3 * (time.perf_counter() - t)
            return got

        ck.restore = timed_restore

        def reload_mid_burst(after_s: float) -> None:
            time.sleep(after_s)
            reload["t0"] = time.perf_counter()
            reload["gen"] = fleet.reload_from_lineage(ck)
            reload["t1"] = time.perf_counter()

        for seed, (label, share, seconds) in enumerate(SCORE_PHASES, 11):
            traffic = serving.PoissonTraffic(fleet, make_row,
                                             qps=share * capacity, seed=seed)
            reloader = None
            if label == "burst":
                reloader = threading.Thread(target=reload_mid_burst,
                                            args=(seconds / 2,))
                reloader.start()
            traffic.run(seconds)
            if reloader is not None:
                reloader.join(120)
            tallies[label] = traffic
            sent.extend(traffic.sent)
        trickle = serving.PoissonTraffic(
            fleet, make_row, qps=SCORE_TRICKLE_SHARE * capacity, seed=14)
        t_end = time.monotonic() + SCORE_DRAIN_TIMEOUT_S
        while time.monotonic() < t_end:
            trickle.run(0.5)
            if fleet.replicas_active() == 1 and any(
                    p["target"] < p["from"] for p in scaler.plan_history):
                break
        tallies["trickle"] = trickle
        sent.extend(trickle.sent)
        tally = {k: t.await_all(timeout_s=60) for k, t in tallies.items()}
    finally:
        stop.set()
        if follower is not None:
            follower.join(30)
        ctl.stop()
    launches = dict(fa.launches)
    forwards = sum(r.server.forwards - forwards0.get(id(r), 0)
                   for r in built if r.server is not None)
    iterations = sum(r.iterations for r in built)
    served = sum(t["served"] for t in tally.values())
    # a serve iteration's device time, outside the traffic path
    server = fleet.replicas()[0].server
    iter_ms = None
    if on_card:
        ms = []
        for _ in range(5):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            server.serve(fleet.example_batch)
            end.record()
            torch.cuda.synchronize()
            ms.append(start.elapsed_time(end))
        iter_ms = float(np.median(ms))
    pairs = [(p["from"], p["target"]) for p in scaler.plan_history]
    generation = kv.kv_get(f"serving-gen/{fleet.job}")
    curve = kv.kv_get(f"goodput-curve/{fleet.job}")
    fleet.stop()

    # the sampled answers against the plain path on their generation
    before = [r for r in tallies["steady"].sent[:SCORE_SAMPLES]]
    after = [r for r in sent if "t1" in reload
             and r.t_enqueue > reload["t1"]][:SCORE_SAMPLES]
    gen0 = tfm.Transformer(cfg, device=dev, seed=0)
    refs, answers, rows_of = {}, {}, {}
    for gen, model, reqs in ((0, gen0, before), (2, gen2, after)):
        model.cfg = dataclasses.replace(model.cfg, use_flash=False)
        tokens = torch.from_numpy(np.stack([r.payload[0] for r in reqs]))
        with torch.no_grad():
            refs[gen] = score_last_token(model, (tokens.to(dev),))
        answers[gen] = [np.asarray(r.result) for r in reqs]
        rows_of[gen] = [r.id for r in reqs]
    del gen0, gen2
    ck.close()
    shutil.rmtree(lineage, ignore_errors=True)

    fleet_line = (f"scoring fleet {fleet.job}: FLAGSHIP"
                  if cfg is tfm.FLAGSHIP else f"scoring fleet {fleet.job}")
    print(f"{fleet_line} rows of {seq} tokens, batch {SCORE_BATCH}, "
          f"capacity C {capacity:.1f} rows/s (closed loop, one replica); "
          f"QPS target {SCORE_TARGET_SHARE} C a replica, p99 SLO "
          f"{SCORE_SLO_MS} ms; two replicas share {card}", flush=True)
    for label, t in tally.items():
        share = dict((lab, sh) for lab, sh, _ in SCORE_PHASES).get(
            label, SCORE_TRICKLE_SHARE)
        print(f"scoring {label} at {share} C: sent {t['sent']} served "
              f"{t['served']} dropped {t['dropped']} errors {t['errors']} "
              f"timeouts {t['timeouts']} p50_ms {t['p50_ms']} p99_ms "
              f"{t['p99_ms']} max_ms {t['max_ms']}", flush=True)
    if "t1" in reload:
        split = {"before": [], "during": [], "after": []}
        for r in tallies["burst"].sent:
            key = ("before" if r.t_enqueue < reload["t0"] else "during"
                   if r.t_enqueue < reload["t1"] else "after")
            split[key].append(1e3 * r.latency_s)
        print("scoring burst by the reload: " + "; ".join(
            f"{k} {len(v)} requests p50_ms {np.percentile(v, 50):.3f} "
            f"p99_ms {np.percentile(v, 99):.3f}"
            for k, v in split.items() if v), flush=True)
    print(f"scoring plans {pairs}; prewarm hits {fleet.prewarm_hits} "
          f"misses {fleet.prewarm_misses}; replicas built "
          f"{[(r.name, r.build_ms) for r in built]} build_ms; iterations "
          f"{iterations} rows per iteration {served / max(iterations, 1):.2f};"
          f" serve iteration device ms {iter_ms} on {card}", flush=True)
    reload_ms = (1e3 * (reload["t1"] - reload["t0"]) if "t1" in reload
                 else None)
    swaps = [e.args["swap_ms"] for e in get_tracer().events("serving")
             if e.name == "serving_weights_reloaded"
             and e.args.get("replica", "").startswith(fleet.job)]
    print(f"scoring reload: generation 2 (one trainer step, loss "
          f"{gen2_loss:.4f}, saved in {gen2_save_s:.3f} s) rolled "
          f"{reload.get('gen')} in {reload_ms} ms mid-burst (restore "
          f"{reload.get('restore_ms')} ms, swaps {swaps} ms); serving-gen "
          f"{generation}; goodput curve {goodput_summary(curve)}",
          flush=True)
    print(f"scoring launches {launches} over {forwards} forwards "
          f"({cfg.n_layers} flash forward launches each)", flush=True)

    failures = list(errors)
    for label, t in tally.items():
        if t["dropped"] or t["errors"] or t["timeouts"] or not t["served"]:
            failures.append(f"{label} tally {t}")
    if (1, 2) not in pairs or (2, 1) not in pairs[pairs.index((1, 2)):] \
            or pairs[-1][1] != 1:
        failures.append(f"plans {pairs}")
    if fleet.prewarm_hits < 1:
        failures.append(f"prewarm hits {fleet.prewarm_hits}")
    if generation != b"2" or reload.get("gen") != 2:
        failures.append(f"serving-gen {generation}, reload {reload}")
    if len(before) != SCORE_SAMPLES or len(after) != SCORE_SAMPLES:
        failures.append(f"sampled {len(before)} before and {len(after)} "
                        "after the reload")
    want = {"flash_fwd": cfg.n_layers * forwards if on_card else 0,
            "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
    if launches != want:
        failures.append(f"launches {launches}, want {want}")
    if failures:
        raise AssertionError("phase (u): " + "; ".join(failures))
    scoring_check(answers, refs, rows_of)
    main_drill = serve_main_drill(card, device)
    return dict(launches=launches, capacity=capacity, tally=tally,
                pairs=pairs, iter_ms=iter_ms, reload_ms=reload_ms,
                serve_main=main_drill)


# -- phase (v): the serving data plane ---------------------------------------


class WireReader:
    """Incremental HTTP/1.1 response reader over one socket: a bytearray
    consumed by offset, so a deep pipeline of 64 KiB answers is not
    re-copied per answer."""

    def __init__(self, sock: socket.socket) -> None:
        self.sock = sock
        self.buf = bytearray()
        self.pos = 0

    def next(self, timeout: float = 30.0) -> tuple[int, bytes, bytes]:
        self.sock.settimeout(timeout)
        while True:
            idx = self.buf.find(b"\r\n\r\n", self.pos)
            if idx >= 0:
                head = bytes(self.buf[self.pos:idx + 4])
                m = re.search(rb"\r\n[Cc]ontent-[Ll]ength: (\d+)", head)
                end = idx + 4 + (int(m.group(1)) if m else 0)
                if len(self.buf) >= end:
                    body = bytes(self.buf[idx + 4:end])
                    self.pos = end
                    if self.pos > (1 << 20):
                        del self.buf[:self.pos]
                        self.pos = 0
                    return int(head.split(b" ", 2)[1]), head, body
            chunk = self.sock.recv(1 << 20)
            if not chunk:
                raise ConnectionError("connection closed")
            self.buf += chunk


def http_call(port: int, method: str, path: str, body: bytes = b"",
              timeout: float = 30.0) -> tuple[int, bytes]:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(f"{method} {path} HTTP/1.1\r\nHost: smoke\r\n"
                  f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
        status, _head, out = WireReader(s).next(timeout)
    return status, out


def scrape(port: int) -> dict:
    """A replica child's ``/metrics``: its flash launches by kernel, its
    forwards (the warm-up's included) and the generation it serves."""
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                timeout=10) as r:
        text = r.read().decode()
    out = {"launches": {k: 0 for k in FLASH}}
    for line in text.splitlines():
        m = re.match(r'edl_flash_launches_total\{kernel="(\w+)"\} (\d+)',
                     line)
        if m:
            out["launches"][m.group(1)] = int(m.group(2))
        for name in ("frontdoor_forwards_total", "frontdoor_generation"):
            if line.startswith(f"edl_{name} "):
                out[name.split("_")[1]] = int(float(line.split()[1]))
    return out


class AnswerCheck:
    """Holds an answer against its row's plain-path logits on each
    generation, by (d)'s rule: which generation it matches, or wrong."""

    def __init__(self, refs: dict) -> None:
        self.refs = refs  # generation -> [rows, vocab] fp32 numpy
        self.atol = {g: MODEL_ATOL * np.sqrt(np.square(r).mean(axis=1))
                     for g, r in refs.items()}

    def __call__(self, row: int, body: bytes) -> str:
        got = np.frombuffer(body, "<f4")
        for gen, ref in self.refs.items():
            want = ref[row]
            if got.shape == want.shape and np.all(
                    np.abs(got - want)
                    <= kc.BF16_RTOL * np.abs(want) + self.atol[gen][row]):
                return f"gen{gen}"
        return "wrong"


class LoadClient:
    """One keep-alive connection pipelining raw-f32 rows of token ids: a
    sender (closed loop at a fixed depth, or open loop at Poisson times)
    and a receiver that pairs answers with requests in order and holds
    each against its row's answers."""

    def __init__(self, port: int, reqs: list, check: AnswerCheck,
                 seed: int) -> None:
        self.port, self.reqs, self.check = port, reqs, check
        self.rng = np.random.default_rng(seed)
        self.results: list = []
        self.pending: collections.deque = collections.deque()
        self.lock = threading.Lock()
        self.room: Optional[threading.Semaphore] = None
        self.sock = None
        #: one permit a request sent on the current connection
        self.sent: Optional[threading.Semaphore] = None

    def _connect(self) -> None:
        self.sock = socket.create_connection(("127.0.0.1", self.port),
                                             timeout=30)
        self.sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self.sent = threading.Semaphore(0)
        threading.Thread(target=self._receive, args=(self.sock, self.sent),
                         daemon=True).start()

    def _receive(self, sock, sent: threading.Semaphore) -> None:
        reader = WireReader(sock)
        while True:
            if not sent.acquire(timeout=0.5):
                if sock.fileno() < 0:
                    return
                continue
            with self.lock:
                entry = self.pending[0]
            try:
                status, _head, body = reader.next(timeout=60)
                verdict = (self.check(entry[0], body) if status == 200
                           else None)
            except (OSError, ConnectionError):
                status, verdict = -1, None
            with self.lock:
                self.pending.popleft()
                self.results.append((entry[2], status,
                                     time.perf_counter() - entry[1],
                                     entry[0], verdict))
            if self.room is not None:
                self.room.release()
            if status == -1:
                with self.lock:
                    dead = list(self.pending)
                    self.pending.clear()
                    for e in dead:
                        self.results.append((e[2], -1, 0.0, e[0], None))
                try:
                    sock.close()
                except OSError:
                    pass
                if self.sock is sock:
                    self.sock = None
                return

    def send(self, label: str) -> None:
        if self.sock is None:
            self._connect()
        row = int(self.rng.integers(len(self.reqs)))
        with self.lock:
            self.pending.append((row, time.perf_counter(), label))
        self.sent.release()
        try:
            self.sock.sendall(self.reqs[row])
        except OSError:
            pass  # the receiver records the connection's failure

    def closed_loop(self, label: str, depth: int,
                    stop: threading.Event) -> None:
        self.room = threading.Semaphore(depth)
        while not stop.is_set():
            if self.room.acquire(timeout=0.05):
                self.send(label)

    def open_loop(self, label: str, rate: float,
                  stop: threading.Event) -> None:
        self.room = None
        next_at = time.perf_counter()
        while not stop.wait(max(next_at - time.perf_counter(), 0.0)):
            self.send(label)
            next_at += float(self.rng.exponential(1.0 / rate))

    def drain(self, timeout_s: float = 60.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            with self.lock:
                if not self.pending:
                    return
            time.sleep(0.01)
        raise AssertionError(f"phase (v): {len(self.pending)} requests "
                             f"unanswered after {timeout_s} s")

    def close(self) -> None:
        if self.sock is not None:
            try:
                self.sock.close()
            except OSError:
                pass


def lb_counts(job: str) -> dict:
    c = get_counters()
    return dict(
        hedges=c.get("lb_hedges_fired", job=job),
        hedge_wins=c.get("lb_hedges", job=job, result="win"),
        rescues=c.get("lb_rescues", job=job),
        sheds=sum(c.get("lb_overload_sheds", job=job, priority=p)
                  for p in ("high", "normal", "low")),
        timeouts=c.get("lb_timeouts", job=job),
        integrity_failures=c.get("lb_integrity_failures", job=job))


def run_window(clients: list, label: str, *, job: str,
               rate: Optional[float] = None, depth: Optional[int] = None,
               seconds: float = 0.0, during=None) -> dict:
    """One traffic window: every client sends (closed loop at ``depth``,
    or open loop at ``rate`` rows/s shared among them) until ``seconds``
    pass or ``during(t0)`` returns, then every answer is awaited.
    Returns the window's tally and the LB's counters over it."""
    before = lb_counts(job)
    stop = threading.Event()
    senders = [threading.Thread(
        target=c.closed_loop if depth else c.open_loop,
        args=(label, depth if depth else rate / len(clients), stop),
        daemon=True) for c in clients]
    t0 = time.perf_counter()
    for t in senders:
        t.start()
    extra = during(t0) if during is not None else None
    while time.perf_counter() - t0 < seconds:
        time.sleep(0.01)
    stop.set()
    elapsed = time.perf_counter() - t0
    for t in senders:
        t.join(30)
    for c in clients:
        c.drain()
    got = [r for c in clients for r in c.results if r[0] == label]
    lats = np.sort([r[2] for r in got if r[1] == 200]) * 1e3
    after = lb_counts(job)
    out = dict(label=label, sent=len(got), seconds=elapsed,
               ok=sum(r[1] == 200 for r in got),
               shed=sum(r[1] == 429 for r in got),
               errors=sum(r[1] not in (200, 429) for r in got),
               wrong=sum(r[4] == "wrong" for r in got),
               gens={g: sum(r[4] == g for r in got)
                     for g in ("gen1", "gen2")},
               rows_per_s=sum(r[1] == 200 for r in got) / elapsed,
               p50_ms=float(np.percentile(lats, 50)) if len(lats) else None,
               p99_ms=float(np.percentile(lats, 99)) if len(lats) else None,
               max_ms=float(lats[-1]) if len(lats) else None,
               lb={k: after[k] - before[k] for k in after}, extra=extra)
    return out


class SeverableKV:
    """The LB's discovery client, with a window in which every read fails
    as a partitioned coordinator's would (CoordPartition's hook)."""

    def __init__(self, kv) -> None:
        self.kv = kv
        self.until = 0.0

    def sever(self, seconds: float) -> None:
        self.until = time.monotonic() + seconds

    def _check(self) -> None:
        if time.monotonic() < self.until:
            raise OSError("coordinator partitioned (injected)")

    def kv_keys(self, prefix: str = ""):
        self._check()
        return self.kv.kv_keys(prefix)

    def kv_get(self, key: str):
        self._check()
        return self.kv.kv_get(key)

    def close(self) -> None:
        self.kv.close()


def breaker_arcs(events: list, names) -> dict:
    """Each upstream's breaker states in order (0 closed, 1 open, 2 half
    open), repeats folded, from discovery (closed)."""
    arcs = {n: [0] for n in names}
    for _t, name, state in events:
        if name in arcs and arcs[name][-1] != state:
            arcs[name].append(state)
    return arcs


def completed_arc(states: list) -> bool:
    """closed → open → half-open → closed, in that order, ending closed."""
    want, i = [0, 1, 2, 0], 0
    for s in states:
        if i < len(want) and s == want[i]:
            i += 1
    return i == len(want) and states[-1] == 0


def fd_wait_ready(logs: dict, procs: dict, t_spawn: float,
                  deadline: float) -> dict:
    """Each replica child's ready line and the seconds from the spawn to
    it; raises with a log's tail when its child exits first (no CUDA
    device, a failed build) or never gets ready."""
    lines: dict = {}
    while len(lines) < len(logs) and time.monotonic() < deadline:
        for name, log in logs.items():
            if name in lines:
                continue
            with open(log) as f:
                got = [ln for ln in f if ln.startswith("frontdoor ready ")]
            if got:
                lines[name] = (got[0].strip(), time.perf_counter() - t_spawn)
            elif procs[name].poll() is not None:
                deadline = 0.0  # fails below with this child's log
        time.sleep(0.05)
    for name, log in logs.items():
        if name not in lines:
            with open(log) as f:
                raise AssertionError(
                    f"phase (v): replica {name} exit {procs[name].poll()} "
                    f"without a ready line:\n{f.read()[-3000:]}")
    return lines


def door_answers(port: int, reqs: list) -> list:
    """``reqs`` pipelined straight to one replica's door; its answers."""
    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(b"".join(reqs))
        reader = WireReader(sock)
        out = []
        for _ in reqs:
            status, _head, body = reader.next()
            if status != 200:
                raise AssertionError(f"phase (v): door {port} answered "
                                     f"{status}")
            out.append(np.frombuffer(body, "<f4"))
    return out


def generate_drill(card: str, cfg: tfm.TransformerConfig, device: str
                   ) -> dict:
    """(v-2): ``FleetApp(decode_fleet=flagship_decode_fleet())`` behind a
    ``FrontDoor``: FD_GEN_SESSIONS ``/generate`` sessions pipelined over
    one socket, then the same prompts submitted to the fleet directly;
    their greedy tokens must be equal, every answer carrying its
    ``X-EDL-Session``, no session failed."""
    from edl_tpu_torch.runtime.frontdoor import FleetApp, FrontDoor

    fleet = flagship_decode_fleet(device=device, cfg=cfg,
                                  job="default/flagship-generate")
    door = FrontDoor(FleetApp(None, 1, decode_fleet=fleet),
                     host="127.0.0.1", job="default/flagship-generate")
    door.start()
    try:
        prompts = np.random.default_rng(21).integers(
            0, cfg.vocab_size, (FD_GEN_SESSIONS, FD_GEN_PROMPT)).tolist()
        blob = b""
        for p in prompts:
            body = json.dumps({"prompt": p,
                               "max_new_tokens": FD_GEN_NEW}).encode()
            blob += (b"POST /generate HTTP/1.1\r\nHost: smoke\r\n"
                     b"Content-Type: application/json\r\n"
                     b"Content-Length: %d\r\n\r\n" % len(body)) + body
        t0 = time.perf_counter()
        with socket.create_connection(("127.0.0.1", door.port),
                                      timeout=60) as sock:
            sock.sendall(blob)
            reader = WireReader(sock)
            resps = [reader.next(timeout=120) for _ in prompts]
        wall_s = time.perf_counter() - t0
        docs, failures = [], []
        for i, (status, head, body) in enumerate(resps):
            if status != 200:
                failures.append(f"session {i} status {status}")
                continue
            doc = json.loads(body)
            docs.append(doc)
            if f"X-EDL-Session: {doc['session']}".encode() not in head:
                failures.append(f"session {i} without X-EDL-Session")
        direct = [fleet.submit(p, FD_GEN_NEW) for p in prompts]
        want = [s.wait(120) for s in direct]
        got = [d["tokens"] for d in docs]
        equal = sum(g == w for g, w in zip(got, want))
        ttft = [d["ttft_ms"] for d in docs]
        print(f"generate: {len(prompts)} sessions of {FD_GEN_PROMPT} + "
              f"{FD_GEN_NEW} tokens pipelined over one socket in "
              f"{wall_s:.3f} s; {equal} of {len(prompts)} token-equal to "
              f"the undisturbed fleet's greedy tokens; TTFT p50 "
              f"{np.percentile(ttft, 50) if ttft else None} ms; sessions "
              f"failed {fleet.sessions_failed} on {card}", flush=True)
        if equal != len(prompts):
            failures.append(f"{equal} of {len(prompts)} token-equal")
        if fleet.sessions_failed:
            failures.append(f"sessions failed {fleet.sessions_failed}")
        if failures:
            raise AssertionError("phase (v-2): " + "; ".join(failures))
        return dict(wall_s=wall_s, equal=equal)
    finally:
        door.stop()
        fleet.stop()


def phase_data_plane(card: str, cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
                     device: str = "cuda", seq: int = S,
                     config: str = "flagship") -> dict:
    """(v): FLAGSHIP served through the port's LB tier to two replica
    processes on the card, then ``/generate`` and ``serve_main``'s async
    front door.  ``cfg``, ``device``, ``seq`` and ``config`` (the
    children's ``--config``) let the phase be rehearsed on the CPU at
    TINY.  Returns the replicas' flash launches."""
    from edl_tpu_torch.coord.server import spawn_server
    from edl_tpu_torch.entry import spawn_flagship_frontdoor_replica
    from edl_tpu_torch.runtime.faults import ChaosProxy, GrayReplica
    from edl_tpu_torch.runtime.frontdoor import (FD_RELOADING,
                                                 bootstrap_kv,
                                                 build_predict_request)
    from edl_tpu_torch.runtime.lb import ServingLB

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="smoke-frontdoor-")
    lineage = os.path.join(tmp, "lineage")
    job = FD_JOB
    srv = spawn_server()
    coord = f"127.0.0.1:{srv.port}"
    procs, proxies, logs, clients = {}, {}, {}, []
    lb = kv = None
    drill: dict = {}
    drill_thread = None
    try:
        # generation 2 in the lineage the replicas reload from
        ck = ElasticCheckpointer(lineage)
        ck.save(2, {"params": tfm.Transformer(cfg, device=dev, seed=2)})
        ck.close()

        def main_drill():
            try:
                drill["out"] = serve_main_drill(card, device, "async")
            except BaseException as exc:  # surfaced after the join
                drill["error"] = exc

        drill_thread = threading.Thread(target=main_drill, daemon=True)
        drill_thread.start()
        ports = {}
        t_spawn = time.perf_counter()
        for name in FD_REPLICAS:
            with socket.socket() as probe:
                probe.bind(("127.0.0.1", 0))
                ports[name] = probe.getsockname()[1]
            proxies[name] = ChaosProxy(("127.0.0.1", ports[name]))
            logs[name] = os.path.join(tmp, f"{name}.log")
            procs[name] = spawn_flagship_frontdoor_replica(
                name, coord=coord, job=job, device=device, config=config,
                port=ports[name], advertise_port=proxies[name].port,
                lineage=lineage, generation=1, log_path=logs[name])
        # while the replicas build: the plain path's answers for every
        # client row on both generations, and /generate
        rows = np.random.default_rng(31).integers(
            0, cfg.vocab_size, (FD_ROWS, seq), dtype=np.int64)
        refs = {}
        for gen, seed in ((1, 0), (2, 2)):
            model = tfm.Transformer(cfg, device=dev, seed=seed)
            model.cfg = dataclasses.replace(model.cfg, use_flash=False)
            with torch.no_grad():
                refs[gen] = torch.cat([
                    score_last_token(model, (torch.from_numpy(
                        rows[i:i + FD_BATCH]).to(dev),)).float().cpu()
                    for i in range(0, FD_ROWS, FD_BATCH)]).numpy()
            del model
        check = AnswerCheck(refs)
        gen_out = generate_drill(card, cfg, device)
        ready = {}
        for name, (line, seen_s) in fd_wait_ready(
                logs, procs, t_spawn,
                time.monotonic() + FD_READY_TIMEOUT_S).items():
            ready[name] = dict(
                port=int(log_field(line, "port")),
                metrics=int(log_field(line, "metrics_port")),
                build_s=float(log_field(line, "build_s")),
                main_s=float(log_field(line, "ready_s")),
                spawn_s=round(seen_s, 3))
        drill_thread.join(SERVE_MAIN_TIMEOUT_S + 60)
        if "error" in drill:
            raise drill["error"]
        kv = SeverableKV(bootstrap_kv({"EDL_COORD_ENDPOINT": coord},
                                      disabled="no discovery"))
        lb = ServingLB(job=job, host="127.0.0.1", kv=kv, **FD_LB).start()
        transitions: list = []
        gauge_set = lb.app._breaker_gauge.set

        def record(v, **labels):
            transitions.append((time.perf_counter(), labels.get("upstream"),
                                int(v)))
            gauge_set(v, **labels)

        lb.app._breaker_gauge.set = record
        deadline = time.monotonic() + 30
        while sum(u.routable() for u in lb.app.upstreams.values()) < 2:
            if time.monotonic() > deadline:
                raise AssertionError(f"phase (v): LB upstreams "
                                     f"{lb.app.upstreams}")
            time.sleep(0.02)
        reqs = [build_predict_request(r.astype(np.float32)) for r in rows]
        clients = [LoadClient(lb.port, reqs, check, seed=40 + i)
                   for i in range(FD_CLIENTS)]
        windows = {}
        windows["capacity"] = run_window(clients, "capacity", job=job,
                                         depth=FD_DEPTH,
                                         seconds=FD_CAPACITY_S)
        capacity = windows["capacity"]["rows_per_s"]
        door_clients = [LoadClient(ready["r0"]["port"], reqs, check,
                                   seed=50 + i) for i in range(2)]
        windows["door r0 alone"] = run_window(
            door_clients, "door r0 alone", job=job, rate=capacity / 4,
            seconds=FD_WINDOW_S)
        for c in door_clients:
            c.close()
        windows["steady"] = run_window(clients, "steady", job=job,
                                       rate=capacity / 2,
                                       seconds=FD_WINDOW_S)

        def reload(t0):
            time.sleep(FD_RELOAD_AT_S)
            t_post = time.perf_counter()
            status, _ = http_call(ready["r0"]["port"], "POST",
                                  "/admin/reload")
            seen = set()
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                seen.add(lb.app.upstreams["r0"].state)
                if (FD_RELOADING in seen
                        and lb.app.upstreams["r0"].state == "ready"
                        and scrape(ready["r0"]["metrics"])["generation"]
                        == 2):
                    break
                time.sleep(0.005)
            ms = 1e3 * (time.perf_counter() - t_post)
            time.sleep(0.5)
            return dict(status=status, ms=ms, seen=sorted(seen))

        windows["reload"] = run_window(clients, "reload", job=job,
                                       rate=capacity / 2,
                                       seconds=FD_RELOAD_S, during=reload)
        plan = FaultPlan.random(FD_CHAOS_SEED, kinds=SERVING_KINDS,
                                **FD_CHAOS_PLAN)
        targets = itertools.cycle(FD_REPLICAS)
        for a in plan.actions:
            if isinstance(a, GrayReplica):
                # corrupt: wrong-nonce echoes with garbage bodies, which
                # only the LB's integrity check can catch
                a.rate, a.mode = max(a.rate, 0.85), "corrupt"
            if hasattr(a, "replica"):
                a.replica = next(targets)

        def gray(name):
            def hook(rate, mode, duration_s):
                status, _ = http_call(ready[name]["port"], "POST",
                                      "/admin/gray",
                                      f"{rate} {mode} {duration_s}".encode())
                if status != 200:
                    raise RuntimeError(f"/admin/gray on {name}: {status}")
            return hook

        def partition_coord(duration_s):
            kv.sever(duration_s)
            until = time.monotonic() + duration_s
            return lambda: (time.monotonic() >= until + 0.3
                            and len(lb.app.upstreams) == len(FD_REPLICAS))

        ctx = FaultContext(replica_proxies=proxies,
                           gray={n: gray(n) for n in FD_REPLICAS},
                           serving_lb=lb.app,
                           partition_coord=partition_coord,
                           rng=random.Random(FD_CHAOS_SEED))
        counters = get_counters()
        inj0 = {k: counters.get("faults_injected", type=k)
                for k in SERVING_KINDS}
        rec0 = {k: counters.get("recoveries_completed", type=k)
                for k in SERVING_KINDS}
        engine = FaultPlanEngine(plan, ctx)

        def chaos(t0):
            t_start = time.monotonic()
            while time.monotonic() - t_start < FD_CHAOS_TIMEOUT_S:
                engine(int((time.monotonic() - t_start) * 10))
                if engine.quiescent():
                    break
                time.sleep(0.02)
            # a recovery predicate can see a breaker closed between two
            # strikes of one fault: the window lasts until every breaker is
            # closed again, then a little traffic runs on the healed plane
            healed = time.monotonic() + FD_CHAOS_TIMEOUT_S
            while time.monotonic() < healed and any(
                    u.breaker.state for u in lb.app.upstreams.values()):
                time.sleep(0.01)
            time.sleep(0.5)
            return dict(quiescent=engine.quiescent(),
                        fired=[k for _, k in engine.fired],
                        recovered=list(engine.recovered),
                        seconds=time.monotonic() - t_start)

        t_chaos = time.perf_counter()
        windows["chaos"] = run_window(clients, "chaos", job=job,
                                      rate=capacity / 2, during=chaos)
        arcs = breaker_arcs([e for e in transitions if e[0] >= t_chaos],
                            FD_REPLICAS)
        injected = {k: counters.get("faults_injected", type=k) - inj0[k]
                    for k in SERVING_KINDS}
        recovered = {k: counters.get("recoveries_completed", type=k)
                     - rec0[k] for k in SERVING_KINDS}
        # the victim's counts and generation-1 samples, read while it is
        # idle, before it dies: the counts gate launches per forward
        time.sleep(0.3)
        victim = FD_REPLICAS[1]
        sample_rows = {1: np.arange(FD_SAMPLES),
                       2: np.arange(FD_SAMPLES, 2 * FD_SAMPLES)}
        answers = {1: door_answers(ready[victim]["port"],
                                   [reqs[i] for i in sample_rows[1]])}
        counts = {victim: scrape(ready[victim]["metrics"])}

        def kill(t0):
            time.sleep(FD_KILL_AT_S)
            # its launches up to the SIGKILL, under load (a forward may be
            # in flight, so this read counts launches, not forwards)
            counts[victim]["at_kill"] = scrape(ready[victim]["metrics"])
            procs[victim].kill()
            procs[victim].wait(30)
            return dict(killed=victim)

        windows["kill"] = run_window(clients, "kill", job=job,
                                     rate=capacity / 2, seconds=FD_KILL_S,
                                     during=kill)
        # sampled answers on their generation, straight from each door:
        # generation 2 from the reloaded r0, generation 1 from r1 before
        # it dies (read above, before the kill window)
        answers[2] = door_answers(ready["r0"]["port"],
                                  [reqs[i] for i in sample_rows[2]])
        lb.stop()
        lb = None
        for c in clients:
            c.close()
        procs["r0"].send_signal(signal.SIGTERM)
        rc0 = procs["r0"].wait(60)
        with open(logs["r0"]) as f:
            lines = [ln for ln in f if ln.startswith("frontdoor launches ")]
        if rc0 != 0 or not lines:
            raise AssertionError(f"phase (v): r0 exit {rc0}, no launches "
                                 "line")
        counts["r0"] = json.loads(lines[-1][len("frontdoor launches "):])
    finally:
        if lb is not None:
            lb.stop()
        for c in clients:
            c.close()
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait(10)
        for p in proxies.values():
            p.close()
        if kv is not None:
            kv.close()
        srv.process.kill()
        if drill_thread is not None:
            drill_thread.join(5)
        shutil.rmtree(tmp, ignore_errors=True)

    label = "FLAGSHIP" if cfg is tfm.FLAGSHIP else "TINY"
    print(f"frontdoor tier: {label} ({cfg.n_layers} layers) rows of {seq} "
          f"token ids as raw f32, {len(FD_REPLICAS)} replica processes on "
          f"{card} behind chaos proxies, one ServingLB discovering "
          f"serving-addr/{job}/, {FD_CLIENTS} keep-alive client "
          f"connections; each replica's seconds from its spawn to its ready "
          f"line (spawn_s), from its main to ready (main_s, imports before "
          f"it) and from its door's bind to ready (build_s: the model, the "
          f"warm-up forward): "
          + "; ".join(f"{n} spawn_s {r['spawn_s']} main_s {r['main_s']} "
                      f"build_s {r['build_s']}" for n, r in ready.items()),
          flush=True)
    print(f"frontdoor capacity C {capacity:.1f} rows/s through the LB "
          f"(closed loop, depth {FD_DEPTH} a connection) on {card}",
          flush=True)
    for w in windows.values():
        print(f"frontdoor window {w['label']}: {w['sent']} sent in "
              f"{w['seconds']:.2f} s, {w['rows_per_s']:.1f} rows/s served, "
              f"200 {w['ok']} 429 {w['shed']} errors {w['errors']} wrong "
              f"{w['wrong']} {w['gens']}; p50_ms {w['p50_ms']} p99_ms "
              f"{w['p99_ms']} max_ms {w['max_ms']}; LB {w['lb']}"
              + (f"; {w['extra']}" if w["extra"] else ""), flush=True)
    reload_ms = windows["reload"]["extra"]["ms"]
    print(f"frontdoor reload: POST /admin/reload to r0, gate "
          f"{windows['reload']['extra']['seen']} seen by the LB, generation "
          f"2 served {reload_ms:.1f} ms after the POST", flush=True)
    print(f"frontdoor chaos: plan {plan.describe()}; injected {injected}; "
          f"recovered {recovered}; breaker states "
          f"{ {n: [('closed', 'open', 'half_open')[s] for s in a]
               for n, a in arcs.items()} }", flush=True)
    print(f"frontdoor launches {counts} ({cfg.n_layers} flash forward "
          f"launches a forward)", flush=True)

    failures = []
    for w in windows.values():
        if w["wrong"]:
            failures.append(f"{w['label']}: {w['wrong']} wrong payloads")
        if not w["ok"]:
            failures.append(f"{w['label']}: nothing served")
    for label_ in ("capacity", "door r0 alone", "steady"):
        if windows[label_]["gens"]["gen2"] or windows[label_]["errors"]:
            failures.append(f"{label_}: {windows[label_]}")
    for label_ in ("reload", "kill"):
        if windows[label_]["errors"]:
            failures.append(f"{label_}: {windows[label_]['errors']} errors")
    rl = windows["reload"]["extra"]
    if rl["status"] != 200 or FD_RELOADING not in rl["seen"] \
            or not windows["reload"]["gens"]["gen2"]:
        failures.append(f"reload {rl}, {windows['reload']['gens']}")
    ch = windows["chaos"]
    if ch["errors"] > FD_ERROR_SHARE * ch["sent"]:
        failures.append(f"chaos errors {ch['errors']} of {ch['sent']}")
    if not ch["extra"]["quiescent"] or any(
            injected[k] != 1 or recovered[k] != 1 for k in SERVING_KINDS):
        failures.append(f"chaos injected {injected} recovered {recovered}")
    if not all(completed_arc(a) for a in arcs.values()):
        failures.append(f"breaker arcs {arcs}")
    if not windows["kill"]["lb"]["rescues"]:
        failures.append(f"kill: no rescue {windows['kill']['lb']}")
    if ch["lb"]["integrity_failures"] < 1:
        failures.append(f"chaos: the corrupt gray was never caught by the "
                        f"nonce {ch['lb']}")
    for name, cnt in counts.items():
        want = {"flash_fwd": cfg.n_layers * cnt["forwards"]
                if dev.type == "cuda" else 0,
                "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        if cnt["launches"] != want or not cnt["forwards"]:
            failures.append(f"{name} launches {cnt}, want {want}")
    late = counts[victim]["at_kill"]["launches"]
    if late["flash_fwd"] < counts[victim]["launches"]["flash_fwd"] or \
            late["flash_bwd_dq"] or late["flash_bwd_dkv"]:
        failures.append(f"{victim} launches at its kill {late}")
    if failures:
        raise AssertionError("phase (v): " + "; ".join(failures))
    scoring_check(answers, {g: torch.from_numpy(refs[g][sample_rows[g]])
                            for g in answers},
                  {g: list(sample_rows[g]) for g in answers}, phase="v")
    launches = {k: sum(c.get("at_kill", c)["launches"][k]
                       for c in counts.values()) for k in FLASH}
    return dict(launches=launches, capacity=capacity, windows=windows,
                reload_ms=reload_ms, generate=gen_out,
                serve_main=drill["out"])


# -- phase (w): sequence parallelism over two ranks sharing the card ---------


def ring_hold(rank: int) -> dict:
    """(w): one layer's attention at the sp step's shapes (this rank's
    chunk of a global [SP_B, SP_S] batch, FLAGSHIP's heads, bf16, from one
    seed on both ranks), forward and backward, through the flash ring and:

    * the same ring on the kernels' plain versions
      (``ring_flash_attention_plain``), which round where the kernels
      round: out, dq, dk and dv held element by element to the kernels'
      rule, 2^-7·|plain| + 2^-5·rms(plain);
    * the plain ring on fp32 copies of the same bf16 values (the exact
      arithmetic): held to (d)'s rule, 2^-7·|plain| + MODEL_ATOL·rms(plain),
      since bf16 attention itself is further from it than the kernels'
      rule, most on the first chunk of a causal sequence, whose early rows
      sum few terms that cancel; the plain ring in bf16 against the same
      fp32 run is printed beside it as that floor.

    The flash ring and the plain ring in bf16 are each timed.  The ring's
    hop is ``exchange`` with the other rank (next and previous are the same
    rank on a ring of two), outside the trainer's census."""
    from edl_tpu_torch.parallel import ring_attention as ring

    dev = torch.device("cuda", torch.cuda.current_device())
    peer = 1 - rank
    sp = ring.SPContext(size=WORLD_RANKS, rank=rank,
                        hop=lambda ts, reverse=False: ring.exchange(
                            ts, peer, peer))
    g = torch.Generator(device=dev).manual_seed(SP_HOLD_SEED)

    def chunk(heads):
        x = torch.randn(SP_B, SP_S, heads, D, generator=g, device=dev)
        return ring.local_chunk(x, sp).to(torch.bfloat16).contiguous()

    q, k, v, do = chunk(H), chunk(HK), chunk(HK), chunk(H)

    def run(fn, dtype=torch.bfloat16, repeat=False):
        qg, kg, vg = (x.detach().to(dtype).requires_grad_()
                      for x in (q, k, v))
        kk, vv = kg, vg
        if repeat:
            kk, vv = (x.repeat_interleave(H // HK, dim=2) for x in (kg, vg))
        out = fn(qg, kk, vv, sp=sp)
        out.backward(do.to(dtype))
        return out.detach(), qg.grad, kg.grad, vg.grad

    def flash():
        return run(ring.ring_flash_attention_sharded)

    def plain():
        return run(ring.ring_attention_sharded, repeat=True)

    rec = {}
    fa.reset_launches()
    got = flash()
    rec["launches"] = dict(fa.launches)
    exact = run(ring.ring_attention_sharded, torch.float32, repeat=True)
    for label, ref, other, rule in (
            ("kernels", run(ring.ring_flash_attention_plain), got,
             kc.BF16_ATOL),
            ("exact", exact, got, MODEL_ATOL),
            ("plain_bf16", exact, plain(), MODEL_ATOL)):
        rec[label] = {}
        for name, a, b in zip(("out", "dq", "dk", "dv"), other, ref):
            rms = b.float().square().mean().sqrt().item()
            r = kc.reading(a, b, kc.BF16_RTOL, rule * rms)
            rec[label][name] = {key: r[key] for key in (
                "max_abs_err", "worst", "need_atol")}
    torch.cuda.synchronize()
    for label, fn in (("flash_ms", flash), ("plain_ms", plain)):
        times = []
        for _ in range(SP_HOLD_REPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        rec[label] = float(np.median(times))
    return rec


def sp_rank(rank: int, store: str, out: str) -> None:
    """(w), one rank of the job: SP_SCHEDULE on FLAGSHIP with the sequence
    split over sp (``entry.flagship_sp_world``), with what one rank can see
    of it (losses, step times, each step's peak memory over its start,
    launches, census, parameter fingerprints, each resize's bytes and
    whether the whole params were kept), then :func:`ring_hold`, written as
    JSON to ``out``."""
    from edl_tpu_torch.runtime import elastic

    torch.backends.cuda.matmul.allow_tf32 = False
    trainer, batch = flagship_sp_world(rank, WORLD_RANKS, store, batch=SP_B,
                                       seq=SP_S)
    rec = dict(rank=rank, steps=[], resized=[], moved=[], kept=[],
               n_params=sum(p.numel() for p in trainer.shards.values()))
    fa.reset_launches()
    for world in SP_SCHEDULE:
        if world != trainer.world_size:
            full = checksum(trainer.full_params().values())
            elastic.reset_census()
            rec["resized"].append(trainer.resize(world))
            rec["moved"].append(elastic.collective_census())
            after = checksum(trainer.full_params().values())
            rec["kept"].append(full == after if rank == 0 else None)
        before = dict(fa.launches)
        elastic.reset_census()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        loss = trainer.step(batch)
        torch.cuda.synchronize()
        rec["steps"].append(dict(
            world=trainer.world_size, live=trainer.live, loss=loss,
            ms=1e3 * (time.perf_counter() - t0),
            launches={k: fa.launches[k] - before[k] for k in fa.launches},
            census=elastic.collective_census(),
            rise=torch.cuda.max_memory_allocated() - start,
            peak=torch.cuda.max_memory_allocated(),
            params=(checksum(trainer.shards.values())
                    if trainer.world_size > 1 else None)))
    rec["launches"] = dict(fa.launches)
    rec["events"] = trainer.resize_events
    del trainer, batch
    torch.cuda.empty_cache()
    rec["hold"] = ring_hold(rank)
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f)


def sp_control() -> tuple[list, list]:
    """(w)'s world-1 control: SP_SCHEDULE's steps of ``flagship_trainer``
    at the sp job's global batch, from the same init on the same batch, in
    this process, the flash kernels on the whole sequence: (losses, each
    step's peak memory over its start)."""
    torch.cuda.empty_cache()
    trainer, batch = flagship_trainer(SP_B, SP_S)
    losses, rises = [], []
    for _ in SP_SCHEDULE:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        start = torch.cuda.memory_allocated()
        losses.append(trainer.step(batch))
        torch.cuda.synchronize()
        rises.append(torch.cuda.max_memory_allocated() - start)
    del trainer, batch
    torch.cuda.empty_cache()
    return losses, rises


def sp_hop_bytes(cfg: tfm.TransformerConfig) -> tuple[int, int]:
    """(w): the collective-permutes and their bytes a rank sends in a step
    on sp 2 without remat: each layer's forward hops its k and v chunk
    once; its backward hops k, v and their fp32 dK/dV once, and dK/dV once
    more to bring them home."""
    kv = SP_B * cfg.n_kv_heads * (SP_S // WORLD_RANKS) * cfg.head_dim
    per_layer = 2 * kv * 2 + 2 * kv * 2 + 2 * kv * 4 + 2 * kv * 4
    return 8 * cfg.n_layers, per_layer * cfg.n_layers


def phase_sp(card: str) -> dict:
    """(w): FLAGSHIP with its sequence split over sp on two ranks sharing
    the card, through 2→1→2, against a world-1 control on the whole
    sequence, and the flash ring held to the plain ring; returns the
    launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(sp_rank, "w", WORLD_CHILD_TIMEOUT_S)
    control, control_rise = sp_control()
    n = tfm.FLAGSHIP.n_layers
    permutes, nbytes = sp_hop_bytes(tfm.FLAGSHIP)
    failures = []
    print(f"sp phase (w): FLAGSHIP, global batch {SP_B} x {SP_S}, sp "
          f"{WORLD_RANKS} (each rank {SP_B} x {SP_S // WORLD_RANKS}), the "
          f"flash ring; two ranks sharing the card over gloo (the hops "
          f"staged through host memory), on {card}", flush=True)
    for rec in recs:
        for evt, moved, kept in zip(rec["events"], rec["moved"],
                                    rec["kept"]):
            sent = sum(slot["bytes"] for label, slot in moved.items()
                       if label != "world")
            print(f"sp rank {rec['rank']} resize to {evt['shape']}: "
                  f"bytes_moved {evt['bytes_moved']} (plan), broadcast "
                  f"{sent} bytes, reshard_ms {evt['reshard_ms']}, full "
                  f"params bitwise kept {kept}", flush=True)
            # the plan counts Adam's step count, which travels by value
            if kept is False or not 0 <= evt["bytes_moved"] - sent <= 4:
                failures.append(f"rank {rec['rank']} resize {evt}: "
                                f"broadcast {sent}, kept {kept}")
    for world in sorted(set(SP_SCHEDULE)):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"sp world {world} step_ms by rank {ms} (b{SP_B} s{SP_S} "
              f"global batch; two ranks share one card) on {card}",
              flush=True)
    for rec in recs:
        rises = [st["rise"] for st in rec["steps"]
                 if st["world"] == WORLD_RANKS]
        peaks = [st["peak"] for st in rec["steps"]
                 if st["world"] == WORLD_RANKS]
        print(f"sp rank {rec['rank']} step memory on sp2: peak over the "
              f"step's start {max(rises) / 1e9:.4f} GB (peak "
              f"{max(peaks) / 1e9:.4f} GB); the world-1 control's "
              f"{max(control_rise[1:]) / 1e9:.4f} GB on {card}", flush=True)
        if not max(rises) < min(control_rise[1:]):
            failures.append(f"rank {rec['rank']} step memory {rises} not "
                            f"below the control's {control_rise}")
    r0, r1 = recs
    for rec in recs:
        census = next(st["census"] for st in rec["steps"]
                      if st["world"] == WORLD_RANKS)
        sp_slot = census.get("sp", {"ops": {}, "bytes": 0})
        got = sp_slot["ops"].get("collective-permute", 0)
        # beside the hops, one all-reduce of the fp32 gradients and loss
        hops = sp_slot["bytes"] - 4 * (rec["n_params"] + 1)
        print(f"sp census of one sp2 step, rank {rec['rank']}: {got} sp "
              f"collective-permutes of {hops} bytes (want {permutes} of "
              f"{nbytes}), {json.dumps(census)}", flush=True)
        if (got != permutes or hops != nbytes or set(census) != {"sp"}
                or sp_slot["ops"].get("all-reduce") != 1):
            failures.append(f"rank {rec['rank']} census {census}")
    losses = [st["loss"] for st in r0["steps"]]
    diff = [abs(a - b) for a, b in zip(losses, control)]
    print(f"sp losses {[round(x, 6) for x in losses]} control "
          f"{[round(x, 6) for x in control]} max |sp - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL})", flush=True)
    if not all(np.isfinite(losses)) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {losses} vs control {control}")
    if r0["resized"] != [True, True] or r1["resized"] != [True, True]:
        failures.append(f"resizes {r0['resized']} {r1['resized']}")
    if r0["kept"] != [True, True]:
        failures.append(f"full params kept through the resizes "
                        f"{r0['kept']}")
    for i, (a, b) in enumerate(zip(r0["steps"], r1["steps"])):
        if a["world"] > 1 and (a["params"] != b["params"]
                               or a["loss"] != b["loss"]):
            failures.append(f"step {i}: the ranks' params or loss differ")
        for rank, st in enumerate((a, b)):
            if not st["live"]:
                want = 0
            elif st["world"] == 1:
                want = n
            else:  # rank r of the ring computes r + 1 chunks
                want = (rank + 1) * n
            if st["launches"] != {k: want for k in FLASH}:
                failures.append(f"step {i} rank {rank} on world "
                                f"{st['world']}: launches "
                                f"{st['launches']}, want {want} each")
    for rec in recs:
        hold = rec["hold"]
        for label, what in (("kernels", "the kernels' plain versions, rule "
                             "2^-5 rms"),
                            ("exact", "the plain ring in fp32, (d)'s rule"),
                            ("plain_bf16", "the plain ring in bf16 against "
                             "fp32, (d)'s rule")):
            print(f"sp rank {rec['rank']} ring hold (one layer, b{SP_B} "
                  f"sc{SP_S // WORLD_RANKS} h{H} hk{HK} d{D} bf16) vs "
                  f"{what}: " + ", ".join(
                      f"{o} max |diff| {hold[label][o]['max_abs_err']:.4e} "
                      f"{hold[label][o]['worst']:.3f} of the limit (floor "
                      f"needed {hold[label][o]['need_atol']:.4f} rms)"
                      for o in ("out", "dq", "dk", "dv")), flush=True)
        print(f"sp rank {rec['rank']} ring fwd+bwd flash_ms "
              f"{hold['flash_ms']:.3f} plain_ms (bf16) "
              f"{hold['plain_ms']:.3f}; launches {hold['launches']} on "
              f"{card}", flush=True)
        for label in ("kernels", "exact"):
            bad = [o for o, r in hold[label].items() if not r["worst"] <= 1]
            if bad:
                failures.append(f"rank {rec['rank']}: the flash ring's {bad}"
                                f" off the {label} reference")
        if hold["launches"] != {k: rec["rank"] + 1 for k in FLASH}:
            failures.append(f"rank {rec['rank']} hold launches "
                            f"{hold['launches']}")
    print(f"sp launches by rank {[rec['launches'] for rec in recs]}",
          flush=True)
    if failures:
        raise AssertionError("phase (w): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (x): train+serve card arbitration ----------------------------------


def answer_readings(answers: np.ndarray, tokens: np.ndarray, dev) -> dict:
    """(x): the fleet's sampled answers against the plain attention path's
    last-token logits of their rows (FLAGSHIP from seed 0, the fleet's
    weights), by (d)'s rule, and the control: each answer against another
    row's reference."""
    model = tfm.Transformer(tfm.FLAGSHIP, device=dev, seed=0)
    model.cfg = dataclasses.replace(model.cfg, use_flash=False)
    with torch.no_grad():
        ref = score_last_token(model, (torch.from_numpy(tokens).to(dev),))
    del model
    got = torch.from_numpy(answers).to(ref.device)
    rms = ref.float().square().mean().sqrt().item()
    r, c = (kc.reading(x, ref, kc.BF16_RTOL, MODEL_ATOL * rms)
            for x in (got, got.roll(1, 0)))
    return {k: {f: v[f] for f in ("max_abs_err", "worst", "need_atol")}
            for k, v in (("answers", r), ("another_row", c))}


def arbitrated_rank(rank: int, store: str, out: str) -> None:
    """(x), one rank of the FLAGSHIP trainer whose cards the goodput
    planner arbitrates against the FLAGSHIP scoring fleet: rank 0 also
    holds the arbitration plane (the controller, its scraper, the native
    coordinator) and the fleet, whose replicas are threads of this process
    outside the trainer's process group; ``entry.arbitrated_campaign``
    drives both.  What the rank saw is written as JSON to ``out``."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rec = dict(rank=rank, steps=[])
    runner, plane, _ = flagship_arbitrated_job(rank, WORLD_RANKS, store)
    instrument_steps(runner.trainer, rec["steps"])
    order: list = []
    fleet = rows = None
    built: list = []
    if plane is not None:
        fetch = runner.fetch

        def counted(payload):
            order.append(json.loads(payload.decode())["shard"])
            return fetch(payload)

        runner.fetch = counted
        fleet = flagship_scoring_fleet(
            job=f"default/{ARBITRATION_FLEET_JOB}",
            max_batch_size=ARBITRATION_BATCH,
            max_queue_ms=ARBITRATION_QUEUE_MS,
            slo_p99_ms=ARBITRATION_SLO_MS, kv=plane.coord)
        new_replica = fleet._new_replica

        def tracked(slot):
            r = new_replica(slot)
            built.append(r)
            return r

        fleet._new_replica = tracked
        fleet.scale_to(1)
        fleet.serve_metrics(port=0, replica="r0")
        rows = np.random.default_rng(3).integers(
            0, tfm.FLAGSHIP.vocab_size, (256, S), dtype=np.int64)
    forwards0 = {id(r): r.server.forwards for r in built}
    fa.reset_launches()
    t0 = time.perf_counter()
    got = arbitrated_campaign(runner, plane, fleet, rows)
    rec["wall_s"] = time.perf_counter() - t0
    rec["launches"] = dict(fa.launches)
    rep = got["report"]
    rec.update(losses=rep.losses, worlds=rep.world_sizes,
               resize_steps=rep.resize_steps,
               resize_seconds=rep.resize_seconds)
    if plane is not None:
        rec["forwards"] = sum(r.server.forwards - forwards0.get(id(r), 0)
                              for r in built if r.server is not None)
        sampled = got.pop("sampled", None)
        fleet.stop()
        stats = plane.coord.stats()
        plane.close()
        rec.update({k: v for k, v in got.items()
                    if k not in ("report", "steps")},
                   order=order, leaked=plane.leaked_servers(),
                   stats=dict(done=stats.done, todo=stats.todo,
                              leased=stats.leased, dropped=stats.dropped))
        if sampled is not None:
            rec["sampled_ids"] = sampled["ids"]
            rec["answer_check"] = answer_readings(
                sampled["answers"], sampled["tokens"],
                runner.trainer.device)
    del runner
    torch.distributed.destroy_process_group()
    with open(out, "w") as f:
        json.dump(rec, f, default=str)


def scrape_agrees(compared: dict) -> tuple[bool, bool]:
    """(x): the scraped view against the fleet's own stats over one
    window: qps within X_QPS_RTOL of the fleet's, and p99 within one bucket
    of the serving latency histogram (their buckets' indices at most 1
    apart)."""
    own, seen = compared["fleet"], compared["scraped"]
    qps_ok = abs(seen["qps"] - own["qps"]) <= X_QPS_RTOL * own["qps"]
    edges = list(metrics.SERVING_LATENCY_BUCKETS) + [math.inf]

    def bucket(ms: float) -> int:
        return next(i for i, e in enumerate(edges) if ms / 1e3 <= e)

    return qps_ok, abs(bucket(seen["p99_ms"]) - bucket(own["p99_ms"])) <= 1


def phase_arbitrated(card: str) -> dict:
    """(x): the FLAGSHIP trainer (1 to 2 ranks on the card over gloo) and
    the FLAGSHIP scoring fleet (1 to 2 one-card replicas) sharing a
    cluster of three one-card nodes, the goodput planner dividing the cards
    between them; against a one-rank control fed rank 0's batches in its
    order.  Returns the launches of both ranks summed."""
    torch.cuda.empty_cache()
    recs = run_ranks(arbitrated_rank, "x", X_TIMEOUT_S)
    r0, r1 = recs
    runner, reg, _ = flagship_local_job(0, 1, None, rows=ARBITRATION_ROWS,
                                        shards=ARBITRATION_SHARDS)
    trainer = runner.trainer
    control = [trainer.step(reg.get(i)) for i in r0["order"]]
    del runner, trainer
    torch.cuda.empty_cache()
    uid_t, uid_f = r0["trainer_job"], r0["fleet_job"]
    print(f"arbitrated phase (x): FLAGSHIP trainer {uid_t} (1 to 2 ranks, "
          f"global batch {B} x {S}, leased tasks) and the FLAGSHIP scoring "
          f"fleet {uid_f} (1 to 2 replicas, rows of {S} tokens, batch "
          f"{ARBITRATION_BATCH}) on a FakeCluster of three one-card nodes in "
          f"three NVLink domains, a Controller planning by the goodput "
          f"objective (loop {ARBITRATION_LOOP_S} s), the fleet's SLO policy "
          f"fed by a scraper over its /metrics (sweep every "
          f"{ARBITRATION_SCRAPE_S} s, window {ARBITRATION_WINDOW_S} s); two "
          f"ranks sharing {card} over gloo", flush=True)
    for world, ms, tok_s, t in r0["curve_points"]:
        print(f"arbitrated trainer curve point world {world}: median step "
              f"{ms} ms, {tok_s} tok/s (recorded at {t} s) on {card}",
              flush=True)
    print(f"arbitrated curves {r0['curves']} on {card}", flush=True)
    resizes = {uid_t: [(a, b, t) for a, b, t in r0["trainer_resizes"]],
               uid_f: [(a, b, t0) for a, b, t0, _ in r0["fleet_resizes"]]}
    for tick in r0["ticks"]:
        lat = {}
        for uid, n in tick["target"].items():
            hit = next((t for a, b, t in resizes.get(uid, ())
                        if b == n and t >= tick["t"]), None)
            lat[uid] = None if hit is None else round(hit - tick["t"], 3)
        print(f"arbitrated tick at {tick['t']} s: mode {tick['mode']} "
              f"marginals {tick['marginals']} diff {tick['diff']} target "
              f"{tick['target']} reclaims {tick['reclaims']} re-planned "
              f"equal {tick['audit_ok']}; tick to resize s {lat} on {card}",
              flush=True)
    modes = collections.Counter(m for _, m in r0["modes"])
    print(f"arbitrated tick modes {dict(modes)} over {len(r0['modes'])} "
          f"ticks; fleet resizes (from, to, start s, end s) "
          f"{r0['fleet_resizes']}; trainer resizes (from, to, start s) "
          f"{[(a, b, round(t, 3)) for a, b, t in r0['trainer_resizes']]}; "
          f"hints {r0['hints']}; prewarm {r0['fleet_prewarm']} on {card}",
          flush=True)
    print(f"arbitrated fleet capacity C {r0['capacity']:.1f} rows/s "
          f"(closed loop, one replica, the trainer at world 2 on the same "
          f"card); QPS target {ARBITRATION_TARGET_SHARE} C a replica, p99 "
          f"SLO {ARBITRATION_SLO_MS} ms on {card}", flush=True)
    for label, w in r0["windows"].items():
        t = w["tally"]
        print(f"arbitrated {label} at {w['share']} C ({w['start']} to "
              f"{w['end']} s): sent {t['sent']} served {t['served']} "
              f"dropped {t['dropped']} errors {t['errors']} timeouts "
              f"{t['timeouts']} p50_ms {t['p50_ms']} p99_ms {t['p99_ms']} "
              f"max_ms {t['max_ms']}; replicas {w['stats']['replicas_active']}"
              f" on {card}", flush=True)
    print(f"arbitrated scrape vs fleet over {r0['compared']['window_s']} s "
          f"at {r0['compared']['at']} s: fleet {r0['compared']['fleet']} "
          f"scraped {r0['compared']['scraped']}; sweeps {r0['sweeps']} "
          f"staleness {r0['staleness']} on {card}", flush=True)
    burn = r0["burn_drill"]
    print(f"arbitrated alerts: burn control {burn['control_firing']}"
          f" fired after (evaluations, s) {burn['fired_after']}; "
          f"target down at sweep {r0['down_drill']['fired_at_sweep']} "
          f"(threshold {ARBITRATION_DOWN_AFTER}) on {card}", flush=True)
    for world in sorted(set(r0["worlds"])):
        ms = {rec["rank"]: [round(st["ms"], 2) for st in rec["steps"]
                            if st["world"] == world and st["live"]]
              for rec in recs}
        print(f"arbitrated world {world} step_ms by rank {ms} median "
              f"{float(np.median(ms[0])):.2f} on {card}", flush=True)
    check = r0.get("answer_check", {})
    print(f"model check: arbitrated fleet answers (rows "
          f"{r0.get('sampled_ids')}) vs plain attention logits {check} "
          f"on {card}", flush=True)
    diff = [abs(a - b) for a, b in zip(r0["losses"], control)]
    print(f"arbitrated losses {[round(x, 6) for x in r0['losses']]} control "
          f"{[round(x, 6) for x in control]} max |job - control| "
          f"{max(diff):.3e} (limit {WORLD_LOSS_ATOL}); worlds "
          f"{r0['worlds']}; tasks trained {len(r0['order'])}, coordinator "
          f"stats {r0['stats']}; launches rank 0 {r0['launches']} rank 1 "
          f"{r1['launches']} over {r0['forwards']} fleet forwards on "
          f"{card}", flush=True)

    failures = list(r0["errors"])
    # the allocator decides
    both = min((t for w, _, _, t in r0["curve_points"] if w == 2),
               default=None)
    after = [m for t, m in r0["modes"] if both is not None and t > both]
    if not after or set(after) != {"goodput"}:
        failures.append(
            f"modes after both curves {collections.Counter(after)}")
    if not r0["ticks"] or not all(t["audit_ok"] for t in r0["ticks"]):
        failures.append(f"ticks {r0['ticks']}")
    # card accounting
    for t, train, fl, held, pending in r0["card_samples"]:
        if train + fl + held > 3 or train < 1:
            failures.append(f"cards at {t} s: trainer {train} fleet {fl} "
                            f"held {held}")
            break
    last = r0["card_samples"][-1] if r0["card_samples"] else None
    if last is None or last[4] != 0:
        failures.append(f"pods left pending {last}")
    if min(r0["worlds"]) < 1:
        failures.append(f"worlds {r0['worlds']}")
    # the rebalance happens, each change a planner decision
    worlds = r0["worlds"]
    i2 = worlds.index(2) if 2 in worlds else None
    if (worlds[0] != 1 or i2 is None or 1 not in worlds[i2:]
            or worlds[-1] != 1 or r1["worlds"] != worlds):
        failures.append(f"trainer worlds {worlds} / {r1['worlds']}")
    planned = {(u, n) for tick in r0["ticks"] for u, n in
               tick["target"].items()}
    if [(a, b) for a, b, _, _ in r0["fleet_resizes"]] != [(1, 2)] \
            or (uid_f, 2) not in planned or (uid_t, 1) not in planned \
            or (uid_t, 2) not in planned:
        failures.append(f"fleet resizes {r0['fleet_resizes']} plans "
                        f"{sorted(planned)}")
    if not any(rc[0] == uid_t and rc[1] == uid_f and rc[4] == "rebalance"
               for tick in r0["ticks"] for rc in tick["reclaims"]):
        failures.append("no rebalance of the trainer's card to the fleet")
    # the fleet's dial is the planner's
    if not r0["observe_only"] or not r0["in_autoscaler"] \
            or r0["serving_plans"]:
        failures.append(f"observe_only {r0['observe_only']} autoscaler "
                        f"{r0['in_autoscaler']} serving plans "
                        f"{r0['serving_plans']}")
    if not any(h[0] == "slo_policy" and h[1] == uid_f for h in r0["hints"]):
        failures.append(f"no prewarm hint from the SLO policy {r0['hints']}")
    # the trainer is correct
    if r0["stats"]["leased"] or r0["stats"]["dropped"] \
            or r0["stats"]["done"] != len(r0["order"]) \
            or len(set(r0["order"])) != len(r0["order"]):
        failures.append(f"tasks {r0['order']} stats {r0['stats']}")
    if len(r0["losses"]) != len(control) or not all(
            np.isfinite(r0["losses"])) or max(diff) > WORLD_LOSS_ATOL:
        failures.append(f"losses {r0['losses']} vs control {control}")
    live0 = sum(st["live"] for st in r0["steps"])
    for rec in recs:
        for st in rec["steps"]:
            want = tfm.FLAGSHIP.n_layers if st["live"] else 0
            keys = FLASH if rec["rank"] == 1 else FLASH[1:]
            if any(st["launches"][k] != want for k in keys):
                failures.append(f"rank {rec['rank']} launches {st}")
                break
    # the fleet is correct: every forward 8 flash forwards, no backward
    n = tfm.FLAGSHIP.n_layers
    want0 = {"flash_fwd": n * (live0 + r0["forwards"]),
             "flash_bwd_dq": n * live0, "flash_bwd_dkv": n * live0}
    if r0["launches"] != want0:
        failures.append(f"rank 0 launches {r0['launches']}, want {want0}")
    tallies = {label: w["tally"] for label, w in r0["windows"].items()}
    tallies.update(burn_quiet=r0["burn_drill"]["quiet"],
                   burn_breach=r0["burn_drill"]["tally"])
    for label, t in tallies.items():
        if t["dropped"] or t["errors"] or t["timeouts"] or not t["served"]:
            failures.append(f"{label} tally {t}")
    if not check or check["answers"]["worst"] > 1.0 \
            or check["another_row"]["worst"] <= 1.0:
        failures.append(f"answer check {check}")
    # the scrape plane matches the fleet
    qps_ok, p99_ok = scrape_agrees(r0["compared"])
    if not (qps_ok and p99_ok):
        failures.append(f"scraped {r0['compared']}")
    # the alert rules fire
    if burn["control_firing"] or burn["fired_after"] is None \
            or burn["fired_after"][0] > 2:
        failures.append(f"burn drill {burn}")
    down = r0["down_drill"]["fired_at_sweep"]
    if down is None or down > ARBITRATION_DOWN_AFTER:
        failures.append(f"target-down drill {r0['down_drill']}")
    if r0["leaked"]:
        failures.append(f"{r0['leaked']} coordinator servers left running")
    if failures:
        raise AssertionError("phase (x): " + "; ".join(failures))
    return {k: r0["launches"][k] + r1["launches"][k] for k in FLASH}


# -- phase (y): a TrainingJob from its manifest, through real pod processes ---


class CrStore:
    """The TrainingJob custom resources of (y), in memory: the CR surface
    the sync loop and ``cli.format_status``/``format_job_list`` read (the
    apiserver's role; the card's machine has no ``kubernetes`` package)."""

    def __init__(self) -> None:
        self._crs: dict = {}
        self._lock = threading.Lock()

    @staticmethod
    def _key(name: str, namespace: Optional[str]) -> tuple:
        return (namespace or "default", name)

    def create_training_job_cr(self, manifest: dict) -> None:
        meta = manifest["metadata"]
        with self._lock:
            self._crs[self._key(meta["name"], meta.get("namespace"))] = (
                json.loads(json.dumps(manifest)))

    def list_training_job_crs(self) -> list:
        with self._lock:
            return [json.loads(json.dumps(cr)) for cr in self._crs.values()]

    def get_training_job_cr(self, name: str,
                            namespace: Optional[str] = None):
        with self._lock:
            cr = self._crs.get(self._key(name, namespace))
            return None if cr is None else json.loads(json.dumps(cr))

    def patch_training_job_status(self, name: str, status: dict,
                                  namespace: Optional[str] = None) -> bool:
        with self._lock:
            cr = self._crs.get(self._key(name, namespace))
            if cr is None:
                return False
            cr["status"] = json.loads(json.dumps(status))
            return True

    def delete_training_job_cr(self, name: str,
                               namespace: Optional[str] = None) -> bool:
        with self._lock:
            return self._crs.pop(self._key(name, namespace), None) is not None


@contextlib.contextmanager
def modules_blocked(*names):
    """Any import of ``names`` raises ImportError inside the block."""
    saved = {n: sys.modules.get(n, False) for n in names}
    for n in names:
        sys.modules[n] = None
    try:
        yield
    finally:
        for n, mod in saved.items():
            if mod is False:
                sys.modules.pop(n, None)
            else:
                sys.modules[n] = mod


def kubelet_manifest(tmp: str, config: str, device: str, n_layers: int,
                     timeout_s: float) -> dict:
    """(y)'s TrainingJob: (s)'s supervised worker and ``EDL_MH_*``
    settings, at Y_TASKS tasks and Y_STEP_SLEEP_S a step, with the
    kernels' build root the script's own (``EDL_COMPILE_CACHE``)."""
    root = os.path.dirname(os.path.abspath(__file__))
    worker = (f"--settle-s {Y_SETTLE_S} --heartbeat-timeout-s 10 "
              f"--init-timeout-s {timeout_s} --stall-floor-s {timeout_s} "
              f"--model transformer --model-config {config} "
              f"--n-layers {n_layers} --device {device}")
    env = dict(EDL_MH_EXAMPLES=Y_TASKS * MH_ROWS, EDL_MH_SHARDS=Y_TASKS,
               EDL_MH_BATCH=MH_ROWS, EDL_MH_SEQ=S,
               EDL_MH_CKPT_EVERY=MH_CKPT_EVERY,
               EDL_MH_STEP_SLEEP=Y_STEP_SLEEP_S, EDL_MH_DIGEST=1,
               EDL_COMPILE_CACHE=os.path.join(root, "build"))
    return kubelet_job_manifest(Y_JOB, free_port(), os.path.join(tmp, "ckpt"),
                                worker, env)


def phase_kubelet(card: str, config: str = "flagship",
                  device: str = "cuda:0", n_layers: int = MH_LAYERS,
                  timeout_s: float = MH_GROUP_TIMEOUT_S) -> dict:
    """(y): a FLAGSHIP TrainingJob from its JSON manifest to Succeeded
    through the port's deployed control plane, its pods real processes
    (``entry.kubelet_campaign``'s gates a–h), then the shipped example
    (``python -m edl_tpu_torch.examples.train_ft``) on ``device``.  The
    cluster's two ``nvidia.com/gpu`` are bookkeeping for the one card:
    every world child runs on ``device`` over gloo, as in (s), since NCCL
    puts no two ranks on one GPU.  Returns the flash launches of every
    world child of every pod, summed."""
    from edl_tpu_torch import cli
    from edl_tpu_torch.api.serde import load_manifest_file
    from edl_tpu_torch.coord import bindings
    from edl_tpu_torch.runtime.multihost import world_backend

    t0 = time.perf_counter()
    on_card = device.startswith("cuda")
    if on_card:
        torch.cuda.empty_cache()
        free_before = torch.cuda.mem_get_info(0)[0]
    bindings.ensure_built()
    root = os.path.dirname(os.path.abspath(__file__))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-kubelet-")
    # the shipped example, standalone on the card, beside the job (its
    # process is idle while the pods start, and the card is not the
    # job's bound)
    ft = subprocess.Popen(
        [sys.executable, "-m", "edl_tpu_torch.examples.train_ft",
         "--device", device],
        env=dict(os.environ, PYTHONPATH=root,
                 EDL_DATA_DIR=os.path.join(tmp, "train_ft")),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        cwd=root)
    try:
        with modules_blocked("yaml", "kubernetes"):
            manifest = kubelet_manifest(tmp, config, device, n_layers,
                                        timeout_s)
            path = os.path.join(tmp, f"{Y_JOB}.json")
            with open(path, "w") as f:
                json.dump(manifest, f, indent=2)
            echo = io.StringIO()
            with contextlib.redirect_stdout(echo):
                rc = cli.main(["--log-level", "warn", "validate", path])
            job = load_manifest_file(path)
            if rc != 0 or json.loads(echo.getvalue())["metadata"][
                    "name"] != Y_JOB or job.gpus_per_trainer() != 1:
                raise AssertionError(f"phase (y): cli validate rc {rc} "
                                     f"{echo.getvalue()[:200]!r}")
            with open(path) as f:
                doc = json.load(f)
            print(f"kubelet manifest {os.path.basename(path)} (JSON, no "
                  f"yaml or kubernetes module): cli validate rc {rc}; "
                  f"{config.upper()} at {n_layers} of its "
                  f"{tfm.FLAGSHIP.n_layers} layers (depth cut, as (s)), "
                  f"trainers {job.group_range()} of "
                  f"{job.gpus_per_trainer()} nvidia.com/gpu, "
                  f"{Y_TASKS} tasks of {MH_ROWS} x {S} tokens", flush=True)
            out = kubelet_campaign(
                CrStore(), os.path.join(tmp, "kubelet"), doc,
                kubelet_env=dict(
                    EDL_HEALTH_PORT="0", EDL_MH_DIE_WITH_PARENT="1",
                    EDL_COORD_MEMBER_TTL_MS=str(MH_MEMBER_TTL_MS),
                    EDL_COORD_TASK_TIMEOUT_MS=str(MH_TASK_TIMEOUT_MS)),
                timeout_s=Y_TIMEOUT_S)
        t_job = time.perf_counter() - t0
        rec = out["records"]
        print(f"kubelet pods spawned: coordinator "
              f"`{out['commands']['coordinator']}`, trainer "
              f"`{out['commands']['trainer']}`, entry "
              f"`{out['entry']}`", flush=True)
        print(f"kubelet worlds (epoch, size) {out['worlds']} on {device} "
              f"over {world_backend(device)}; killed {out['victims']}, "
              f"replaced by {out['replacement']}; coordinator respawned "
              f"as {out['coord_respawned']}, tasks done "
              f"{out['coord_done'][0]} -> {out['coord_done'][1]}; queue "
              f"{out['stats']}; exits {out['exit_codes']}", flush=True)
        print("kubelet status after the grow:\n" + out["status_after_grow"],
              flush=True)
        print("kubelet status at the end:\n" + out["status_end"],
              flush=True)
        t_sub = out["t_submit"]
        events = sorted([(w - t_sub, f"{pod} spawned") for pod, w in
                         out["spawns"]] + [
            (r["wall"] - t_sub, f"{r['pod']} devices ready epoch "
             f"{r['epoch']}") for r in rec["ready"]] + [
            (max(st["wall"] for st in rec["steps"]) - t_sub, "last step"),
            (out["t_succeeded"] - t_sub, "the CR's status Succeeded")])
        print("kubelet timeline (s after the submit): " + "; ".join(
            f"{t:.2f} {what}" for t, what in events), flush=True)
        for pod, line in rec["phases"]:
            print(f"kubelet {pod} world_phases {line}", flush=True)
        ms = sorted(rec["save_ms"])
        print(f"kubelet generations saved {len(ms)}, save ms median "
              f"{ms[len(ms) // 2]:.1f} max {ms[-1]:.1f}", flush=True)
        for label, key in (("submit to world 1's first step",
                            "submit_to_world1_s"),
                           ("grow tick to world 2's first step",
                            "grow_to_world2_s"),
                           ("kill to the re-formed world's first step",
                            "kill_to_world2_s"),
                           ("coordinator kill to the next completed task",
                            "coord_kill_to_task_s")):
            print(f"kubelet {label} {out[key]:.3f} s on {card}", flush=True)
        for world in (1, 2):
            ms = sorted(st["ms"] for st in rec["steps"]
                        if st["world"] == world and st["loss"] != 0)
            print(f"kubelet world {world} step_ms n {len(ms)} median "
                  f"{ms[len(ms) // 2]:.2f} min {ms[0]:.2f} max {ms[-1]:.2f} "
                  f"(two pods share one card over gloo: not a scaling "
                  f"figure) on {card}", flush=True)
        want = n_layers if on_card else 0
        bad = [st for st in rec["steps"] if st["launches"]
               != [want if st["loss"] != 0 else 0] * 3]
        if bad:
            raise AssertionError(f"phase (y): launches {bad[:3]}")
        print(f"kubelet losses {out['losses'][0]:.5f} -> "
              f"{out['losses'][1]:.5f} over {len(rec['steps'])} step "
              f"lines; CR deleted: {out['groups']} pod process groups "
              f"gone", flush=True)
        ft_out = ft.communicate(timeout=Y_TRAIN_FT_TIMEOUT_S)[0]
        done = [ln for ln in ft_out.splitlines() if " done on " in ln]
        if ft.returncode != 0 or not done:
            raise AssertionError(f"phase (y): train_ft rc {ft.returncode}"
                                 f" {ft_out[-800:]}")
        print(f"kubelet train_ft: {done[0].strip()}", flush=True)
    finally:
        if ft.poll() is None:
            ft.kill()
            ft.wait(30)
        shutil.rmtree(tmp, ignore_errors=True)
    if on_card:
        free_after = torch.cuda.mem_get_info(0)[0]
        print(f"kubelet card memory free before {free_before / 2**30:.3f} "
              f"GiB, after {free_after / 2**30:.3f} GiB on {card}",
              flush=True)
        if free_after < free_before - Y_MEM_SLACK_BYTES:
            raise AssertionError("phase (y): the pods left memory on the "
                                 "card")
    wall = time.perf_counter() - t0
    print(f"kubelet (y) wall {wall:.3f} s (the job {t_job:.3f} s) on "
          f"{card}", flush=True)
    total = {k: 0 for k in FLASH}
    for st in rec["steps"]:
        for k, c in zip(sorted(FLASH), st["launches"]):
            total[k] += c
    return total


# -- phase (z): serving replicas wider than one card --------------------------


def wide_reference(model, rows: np.ndarray, dev) -> torch.Tensor:
    """(z): the plain attention path's last-token logits of ``rows`` on
    ``model`` (its flash flag off for the call), eight rows a forward."""
    flash = model.cfg
    model.cfg = dataclasses.replace(flash, use_flash=False)
    try:
        with torch.no_grad():
            return torch.cat([score_last_token(model, (torch.from_numpy(
                rows[i:i + SCORE_BATCH]).to(dev),))
                for i in range(0, len(rows), SCORE_BATCH)])
    finally:
        model.cfg = flash


def wide_counts(servers: list) -> list:
    """(z): each rank's launch counts of the wide replicas that stopped
    cleanly (a killed replica's ranks are gone with theirs)."""
    return [c for srv in servers for c in (srv.final_counts or [])]


def wide_decode_step(cfg, model, dev) -> dict:
    """(z): one decode step of 8 slots with 512 cached tokens a slot of
    seeded random K/V, over a pool split by heads on [card, card], against
    the same step on one device: logits bitwise equal, the bytes that
    cross to the other shard, and each step's device ms (on the card)."""
    params = llama.as_decode_params(model, dev)
    slots, cached = DECODE_DEFAULTS["slots"], 512
    maxb = DECODE_DEFAULTS["max_blocks_per_session"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, slots)
    pos, live = np.full(slots, cached), np.ones(slots, bool)
    gen = torch.Generator(device=dev).manual_seed(5)
    content = {name: torch.randn(
        (cfg.n_layers, slots * maxb, DECODE_DEFAULTS["kv_block_size"],
         cfg.n_kv_heads, cfg.head_dim), generator=gen, device=dev
    ).to(cfg.dtype) for name in ("k", "v")}
    got = {}
    for label, devices in (("one device", None), ("heads split", [dev] * 2)):
        pool = KVBlockPool(cfg, slots * maxb, DECODE_DEFAULTS["kv_block_size"],
                           maxb, job=f"smoke/wide-step-{len(devices or [1])}",
                           device=dev, devices=devices)
        llama.write_blocks(pool.cache, range(slots * maxb), content)
        for i in range(slots):
            pool.ensure_capacity(i, cached + 1)
        tables = np.stack([pool.block_table(i) for i in range(slots)])

        def step():
            return llama.decode_step(params, pool.cache, toks, pos, tables,
                                     live)

        step()
        before = getattr(pool.cache, "cross_bytes", 0)
        logits, _ = step()  # the step rewrites its own cells: repeatable
        moved = getattr(pool.cache, "cross_bytes", 0) - before
        ms = (float(np.median([cuda_ms(step, 1, SERVE_SLEEP_CYCLES)
                               for _ in range(SERVE_TIMED_REPS)]))
              if dev.type == "cuda" else None)
        got[label] = dict(logits=logits, moved=moved, ms=ms,
                          reserved=pool.reserved_bytes_per_device())
        print(f"wide decode_step {label}: {slots} slots x {cached} cached, "
              f"device_ms {ms} bytes crossing to the other shard {moved} "
              f"reserved bytes a device {got[label]['reserved']}",
              flush=True)
    if not torch.equal(got["one device"]["logits"],
                       got["heads split"]["logits"]):
        raise AssertionError("phase (z): the heads-split decode step's "
                             "logits differ from one device's")
    return got


def phase_wide(card: str, capacity: float, single_tokens=None,
               cfg: tfm.TransformerConfig = tfm.FLAGSHIP,
               device: str = "cuda", seq: int = S) -> dict:
    """(z): FLAGSHIP scored through ``ServingFleet(chips_per_replica=2)``,
    each replica two rank processes sharing the card over gloo, and a
    heads-sharded ``DecodeFleet(devices_per_replica=2)``.  ``capacity`` is
    (u)'s one-replica C from this run, ``single_tokens`` (i)'s one-device
    fleet's tokens (run again when None).  ``cfg``, ``device`` and ``seq``
    let the phase be rehearsed on the CPU at TINY.  Returns the kernels'
    launches on the phase's paths."""
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
    zero_launch_counts()
    pool_rows = np.random.default_rng(23).integers(
        0, cfg.vocab_size, (WIDE_ROW_POOL, seq), dtype=np.int64)
    gen1 = tfm.Transformer(cfg, device=dev, seed=0)
    gen2 = tfm.Transformer(cfg, device=dev, seed=WIDE_GEN2_SEED)
    refs = {g: wide_reference(m, pool_rows, dev)
            for g, m in ((1, gen1), (2, gen2))}
    fleet = flagship_scoring_fleet(
        device=device, params=gen1, seq=seq, job="smoke/wide",
        max_batch_size=SCORE_BATCH, max_queue_ms=SCORE_QUEUE_MS,
        chips_per_replica=WIDE_CHIPS, devices=[dev] * WIDE_SLOTS)
    servers, marks = [], {}
    try:
        t0 = time.perf_counter()
        fleet.scale_to(1)
        marks["build_s"] = time.perf_counter() - t0
        first = fleet.replicas()[0]
        servers.append(first.server)
        # the world-1 replica: the same weights, the same kernels, in this
        # process, on the same rows
        one = serving.ElasticServer(score_last_token, copy.deepcopy(gen1),
                                    devices=[dev])
        rows = pool_rows[:WIDE_ROWS]
        with torch.inference_mode():
            world1 = torch.cat([one.serve((rows[i:i + SCORE_BATCH],))
                                for i in range(0, WIDE_ROWS, SCORE_BATCH)])
        del one
        reqs = [fleet.submit((r,)) for r in rows]
        wide = torch.from_numpy(np.stack([np.asarray(q.wait(120))
                                          for q in reqs])).to(dev)
        rms = world1.float().square().mean().sqrt().item()
        held = kc.reading(wide, world1, kc.BF16_RTOL, kc.BF16_ATOL * rms)
        print(f"wide answers: {WIDE_ROWS} rows of a replica of "
              f"{WIDE_CHIPS} ranks vs a world-1 replica's: max |diff| "
              f"{held['max_abs_err']:.4e}, {held['worst']:.3f} of the "
              f"kernels' rule (floor needed {held['need_atol']:.4f} rms); "
              f"built in {marks['build_s']:.1f} s", flush=True)
        if not held["worst"] <= 1.0:
            raise AssertionError("phase (z): the wide replica's answers "
                                 "off the world-1 replica's")

        # Poisson traffic at WIDE_SHARE C through hint, scale_to(2), a
        # rolling reload, a killed rank and scale_to(1)
        qps = WIDE_SHARE * capacity
        traffic = serving.PoissonTraffic(
            fleet, lambda i: (pool_rows[i % WIDE_ROW_POOL],), qps=qps,
            seed=29)
        stop = threading.Event()

        def drive():
            while not stop.is_set():
                traffic.run(0.5)

        feeder = threading.Thread(target=drive, daemon=True)
        feeder.start()
        t0 = time.perf_counter()
        fleet.hint(2)
        fleet._hinted[0].wait_ready(600)
        marks["hint_ready_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        fleet.scale_to(2)
        marks["scale_up_s"] = time.perf_counter() - t0
        servers += [r.server for r in fleet.replicas() if r is not first]
        time.sleep(WIDE_SETTLE_S)
        marks["reload0"] = time.perf_counter()
        swapped = fleet.rolling_reload(gen2, 2)
        marks["reload1"] = time.perf_counter()
        time.sleep(WIDE_SETTLE_S)
        victim = first.server.procs[1]
        marks["kill"] = time.perf_counter()
        os.kill(victim.pid, signal.SIGKILL)
        deadline = time.monotonic() + WIDE_FAIL_S
        while first.state != serving.STOPPED \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        marks["dead_s"] = time.perf_counter() - marks["kill"]
        t0 = time.perf_counter()
        after_kill = fleet.scale_to(1)
        marks["scale_down_s"] = time.perf_counter() - t0
        time.sleep(WIDE_SETTLE_S)
        stop.set()
        feeder.join(60)
        tally = traffic.await_all(timeout_s=WIDE_DRAIN_S)
        survivor = fleet.replicas()
    finally:
        fleet.stop()
    dropped = [q for q in traffic.sent if q.error is not None]
    typed = [q for q in dropped if isinstance(q.error,
                                              serving.ReplicaRankDied)]
    late = [q.t_done - marks["kill"] for q in typed]
    wrong, served = [], []
    for i, q in enumerate(traffic.sent):
        if q.error is not None:
            continue
        served.append(q)
        i %= WIDE_ROW_POOL
        gens = ((1,) if q.t_enqueue < marks["reload0"] else (2,)
                if q.t_enqueue > marks["reload1"] else (1, 2))
        got = torch.from_numpy(np.asarray(q.result))[None].to(dev)
        ok = False
        for g in gens:
            ref = refs[g][i:i + 1]
            r = kc.reading(got, ref, kc.BF16_RTOL,
                           MODEL_ATOL * refs[g].float().square().mean()
                           .sqrt().item())
            ok = ok or r["worst"] <= 1.0
        if not ok:
            wrong.append(q.id)
    lat = 1e3 * np.array([q.latency_s for q in served])
    print(f"wide traffic at {WIDE_SHARE} C ({qps:.1f} rows/s): sent "
          f"{tally['sent']} served {tally['served']} dropped "
          f"{tally['dropped']} ({len(typed)} ReplicaRankDied, failed "
          f"{max(late, default=0):.3f} s after the kill at most) errors "
          f"{tally['errors']} timeouts {tally['timeouts']} wrong payloads "
          f"{len(wrong)}; p50_ms {np.percentile(lat, 50):.1f} p99_ms "
          f"{np.percentile(lat, 99):.1f}; hint ready "
          f"{marks['hint_ready_s']:.1f} s, scale_to(2) "
          f"{marks['scale_up_s']:.2f} s (prewarm hits {fleet.prewarm_hits}),"
          f" rolling reload of {swapped} replicas "
          f"{marks['reload1'] - marks['reload0']:.2f} s, killed rank's "
          f"replica stopped in {marks['dead_s']:.3f} s, scale_to(1) "
          f"{marks['scale_down_s']:.2f} s -> {after_kill} replica "
          f"({[r.name for r in survivor]}); rank processes left alive "
          f"{[p.pid for srv in servers for p in srv.procs if p.is_alive()]}",
          flush=True)

    counts = wide_counts(servers)
    in_process = dict(fa.launches)
    launches = {name: in_process[name] + sum(c["flash"][name]
                                            for c in counts)
                for name in FLASH}
    print(f"wide launches: in this process {in_process}; by rank "
          f"{[(c['forwards'], c['flash']) for c in counts]}", flush=True)

    # the heads-sharded decode fleet on (i)'s traffic
    decode_traffic = serving_traffic(cfg)
    if single_tokens is None:
        single_tokens = serve("1 replica (z)", flagship_decode_fleet(
            device=device, cfg=cfg, job="smoke/wide-single"),
            decode_traffic)["tokens"]
    dfleet = flagship_decode_fleet(device=device, cfg=cfg,
                                   job="smoke/wide-decode",
                                   devices_per_replica=WIDE_CHIPS)
    try:
        pool = dfleet._replicas[0].pool
        t0 = time.perf_counter()
        sessions = [dfleet.submit(p, SERVE_NEW_TOKENS, priority=pri)
                    for p, pri in decode_traffic]
        for sess in sessions:
            sess.wait_first_token(300)
        per_device = pool.per_device_used_bytes()
        reserved = dfleet.kv_reserved_bytes_per_device()
        tokens = [sess.wait(300) for sess in sessions]
        wall = time.perf_counter() - t0
        failed, chips = dfleet.sessions_failed, dfleet.chips()
    finally:
        dfleet.stop()
    differ = [i for i, (a, b) in enumerate(zip(tokens, single_tokens))
              if a != b]
    n_tok = sum(len(t) for t in tokens)
    print(f"wide decode: FLAGSHIP pool split by {pool.shard_axis} over "
          f"{len(pool.devices)} shards of {card}; {len(tokens)} sessions "
          f"{n_tok} tokens in {wall:.3f} s ({n_tok / wall:.1f} tokens/s); "
          f"{len(tokens) - len(differ)} token-equal to the one-device "
          f"fleet's (differ: {differ}); failed {failed}; chips {chips}; "
          f"per_device_used_bytes at every first token {per_device}; "
          f"kv_reserved_bytes_per_device {reserved} of "
          f"{pool.total_bytes()}", flush=True)
    step = wide_decode_step(cfg, gen1, dev)

    failures = []
    if wrong:
        failures.append(f"{len(wrong)} wrong payloads: {wrong[:8]}")
    if tally["errors"] or tally["timeouts"] or len(typed) != len(dropped):
        failures.append(f"lost beyond the killed replica's: {tally}, "
                        f"{len(typed)} typed of {len(dropped)}")
    if late and max(late) > WIDE_FAIL_S:
        failures.append(f"the killed replica's requests failed "
                        f"{max(late):.1f} s after the kill")
    if first.state != serving.STOPPED or after_kill != 1 or swapped != 2 \
            or fleet.prewarm_hits < 1:
        failures.append(f"drill: replica {first.state}, scale_to(1) "
                        f"{after_kill}, swapped {swapped}, prewarm hits "
                        f"{fleet.prewarm_hits}")
    if any(p.is_alive() for srv in servers for p in srv.procs):
        failures.append("a rank process outlived the fleet")
    bad = [c for c in counts
           if c["flash"]["flash_fwd"] != (cfg.n_layers * c["forwards"]
                                          if on_card else 0)
           or c["flash"]["flash_bwd_dq"] or c["flash"]["flash_bwd_dkv"]]
    if bad or not counts:
        failures.append(f"rank launches {bad or counts}")
    if differ or failed or pool.shard_axis != "heads" \
            or chips != WIDE_CHIPS:
        failures.append(f"decode: sessions {differ} differ, {failed} "
                        f"failed, axis {pool.shard_axis}, chips {chips}")
    if reserved != pool.total_bytes() // WIDE_CHIPS \
            or len(set(per_device.values())) != 1 \
            or not sum(per_device.values()):
        failures.append(f"decode accounting: reserved {reserved}, per "
                        f"device {per_device}")
    if failures:
        raise AssertionError("phase (z): " + "; ".join(failures))
    return dict(launches=launches, cross_bytes=step["heads split"]["moved"])


# -- phase (aa): LLAMA3_8B's width on one card ----------------------------------


def phase_llama8b(device: str = "cuda", seq: int = L8B_SEQ,
                  cfg: Optional[tfm.TransformerConfig] = None) -> dict:
    """(aa): one world-1 trainer of LLAMA3_8B's width at ``L8B_LAYERS``
    layers, remat and adamw on, one row of ``seq`` tokens: a warm-up and
    ``L8B_TIMED`` timed steps.  Gates: the first loss finite and within 1
    of ln(vocab) + ``L8B_INIT_EXCESS``, the loss of random targets at the
    init; the bytes of the parameters and Adam's moments on the
    card, counted from the tensors, the memory plan's to the byte; an H100
    80GB's ``total_memory`` the plan's card's; each
    step launching each flash kernel as remat runs it (the forward twice a
    layer: once in the forward, once recomputed in the backward)."""
    from edl_tpu_torch.models import planning

    if cfg is None:
        cfg = dataclasses.replace(tfm.LLAMA3_8B, n_layers=L8B_LAYERS)
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    zero_launch_counts()
    t0 = time.perf_counter()
    trainer, batch = flagship_trainer(1, seq, device=device, cfg=cfg)
    build_s = time.perf_counter() - t0
    n = cfg.n_layers
    want = ({"flash_fwd": 2 * n if cfg.remat else n, "flash_bwd_dq": n,
             "flash_bwd_dkv": n} if on_card
            else dict.fromkeys(FLASH, 0))
    losses, step_s = [], []
    for i in range(1 + L8B_TIMED):
        before = dict(fa.launches)
        t = time.perf_counter()
        losses.append(trainer.step(batch))
        step_s.append(time.perf_counter() - t)
        grown = {k: fa.launches[k] - before[k] for k in FLASH}
        if grown != want:
            raise AssertionError(f"phase (aa) step {i}: launches {grown}, "
                                 f"want {want}")
    launches = dict(fa.launches)
    opt = trainer.state.opt_state.state
    param_bytes = sum(t.numel() * t.element_size()
                      for t in trainer.shards.values())
    moment_bytes = sum(v.numel() * v.element_size()
                       for t in trainer.shards.values()
                       for v in opt[t].values() if v.dim())
    plan = planning.fsdp_memory_plan(cfg, 1)
    peak = torch.cuda.max_memory_allocated() if on_card else None
    total = (torch.cuda.get_device_properties(dev).total_memory if on_card
             else None)
    timed = step_s[1:]
    tokens = seq
    print(f"llama3_8b width x {n} layers (d {cfg.d_model}, {cfg.n_heads}/"
          f"{cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab_size}, remat {cfg.remat_policy if cfg.remat else 'off'}"
          f"): built in {build_s:.1f} s; losses {[round(x, 4) for x in losses]}"
          f" (ln vocab {math.log(cfg.vocab_size):.4f}, the first "
          f"{losses[0] - math.log(cfg.vocab_size):.4f} above it); step_ms "
          f"{[round(1e3 * x, 2) for x in step_s]} median "
          f"{1e3 * float(np.median(timed)):.2f} tokens_per_second "
          f"{tokens / float(np.median(timed)):.1f}; params {param_bytes} and "
          f"moments {moment_bytes} bytes on the card, the plan's "
          f"{plan.param_bytes_per_device} and {plan.opt_bytes_per_device} "
          f"({plan.state_gb_per_device:.3f} GB); max_memory_allocated "
          f"{peak} of total_memory {total} (the plan's card "
          f"{planning.H100_MEMORY_BYTES}); launches {launches}", flush=True)
    failures = []
    if not (math.isfinite(losses[0])
            and abs(losses[0] - math.log(cfg.vocab_size)
                    - L8B_INIT_EXCESS) < 1.0):
        failures.append(f"first loss {losses[0]}")
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"losses {losses}")
    if (param_bytes, moment_bytes) != (plan.param_bytes_per_device,
                                       plan.opt_bytes_per_device):
        failures.append(f"bytes {param_bytes} + {moment_bytes} against the "
                        f"plan's {plan.param_bytes_per_device} + "
                        f"{plan.opt_bytes_per_device}")
    if (on_card and "H100 80GB" in torch.cuda.get_device_name(dev)
            and total != planning.H100_MEMORY_BYTES):
        failures.append(f"the card's total_memory {total} is not the plan's "
                        f"{planning.H100_MEMORY_BYTES}")
    if failures:
        raise AssertionError("phase (aa): " + "; ".join(failures))
    del trainer, batch
    return launches


def stop_descendants() -> list[str]:
    """Stop every process this one started that still runs, and return
    the command lines of those other than multiprocessing's fork server
    and resource tracker (those two end only when this process does, so
    they are stopped here, before it exits, and waited for)."""
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    parent = {}
    for pid in os.listdir("/proc"):
        try:
            with open(f"/proc/{pid}/stat") as f:
                parent[int(pid)] = int(f.read().rsplit(")", 1)[1].split()[1])
        except (OSError, ValueError):
            continue
    left, frontier = [], [os.getpid()]
    while frontier:
        kids = [pid for pid, pp in parent.items() if pp == frontier[-1]]
        frontier.pop()
        left += kids
        frontier += kids
    cmds = []
    for pid in left:
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                cmds.append(f.read().replace(b"\0", b" ").decode().strip())
            os.kill(pid, signal.SIGKILL)
        except OSError:
            continue
        if parent[pid] == os.getpid():
            os.waitpid(pid, 0)
    return cmds


def goodput_summary(raw) -> dict:
    from edl_tpu_torch.observability.goodput import ScalingCurve

    return {} if not raw else ScalingCurve.from_json(raw.decode()).summary()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_s = _build.build()
    print(f"build: {build_s:.2f} s into {_build.build_dir()}", flush=True)
    seconds = {"build": build_s}

    def timed(label: str, fn, *args):
        """Run one phase, print its wall seconds on a line of its own."""
        t0 = time.perf_counter()
        got = fn(*args)
        seconds[label] = time.perf_counter() - t0
        print(f"phase ({label}) wall_s {seconds[label]:.1f}", flush=True)
        return got

    print_ptxas_report()
    rows = timed("b", phase_flash, B, S, H, HK, D, (True, False), "flagship")
    paths = {"flagship": timed("c", phase_flagship)}
    timed("d", phase_model_check)
    sites = resnet.group_norm_sites(resnet.RESNET50, RESNET_HW)
    rows.update(timed("e", phase_group_norm, sites))

    def more_flash():
        return {label: phase_flash(*shape, label) for label, shape in (
            ("bert_base", (BERT_B, BERT_S, BERT_H, BERT_H, BERT_D, (False,))),
            ("flagship_virtual", (VIRTUAL_MICRO_BATCH, S, H, HK, D,
                                  (True,))),
            ("flagship_world", (B // WORLD_RANKS, S, H, HK, D, (True,))),
            ("flagship_tp", (B, S, H // WORLD_RANKS, HK // WORLD_RANKS, D,
                             (True,))),
            ("flagship_durable_tp", (VIRTUAL_MICRO_BATCH, S,
                                     H // WORLD_RANKS, HK // WORLD_RANKS, D,
                                     (True,))),
            ("bert_tp", (BERT_B, BERT_S, BERT_H // WORLD_RANKS,
                         BERT_H // WORLD_RANKS, BERT_D, (False,))),
            ("flagship_sp", (SP_B, SP_S // WORLD_RANKS, H, HK, D,
                             (False, True))),
            ("llama3_8b", (1, L8B_SEQ, tfm.LLAMA3_8B.n_heads,
                           tfm.LLAMA3_8B.n_kv_heads,
                           tfm.LLAMA3_8B.head_dim, (True,))))}

    extra = timed("f", more_flash)
    paths["resnet50"] = timed("g", phase_resnet, sum(sites.values()))
    paths["bert_base"] = timed("h", phase_bert)
    decode = timed("i", phase_serving)
    paths["flagship_world"] = timed("j", phase_world, card)
    virtual = timed("k", phase_virtual, card)
    paths["flagship_virtual"] = virtual["launches"]
    paths["flagship_fsdp"] = timed("l", phase_fsdp, card)
    paths["flagship_tp"] = timed("m", phase_tp, card)
    timed("n", phase_dryrun)
    durable = timed("o", phase_durable, card, virtual["control"],
                    virtual["drills"])
    paths["flagship_durable_fsdp"] = durable["fsdp"]
    paths["flagship_durable_restore"] = durable["restore"]
    paths["flagship_sdc"] = timed("p", phase_sdc, card, virtual["control"])
    paths["flagship_local"] = timed("q", phase_local, card,
                                    virtual["control"])
    paths["bert_tp"] = timed("r", phase_bert_tp, card)
    paths["flagship_multihost"] = timed("s", phase_multihost, card)
    paths["flagship_controlled"] = timed("t", phase_controlled, card)
    scoring = timed("u", phase_serving_plane, card)
    paths["flagship_scoring"] = scoring["launches"]
    paths["flagship_frontdoor"] = timed("v", phase_data_plane,
                                        card)["launches"]
    paths["flagship_sp"] = timed("w", phase_sp, card)
    paths["flagship_arbitrated"] = timed("x", phase_arbitrated, card)
    paths["flagship_kubelet"] = timed("y", phase_kubelet, card)
    paths["flagship_wide"] = timed("z", phase_wide, card,
                                   scoring["capacity"],
                                   decode["single"])["launches"]
    paths["llama3_8b"] = timed("aa", phase_llama8b)
    left = stop_descendants()
    print(f"processes left running at the end, now stopped: {left}",
          flush=True)
    rounded = {k: round(v, 1) for k, v in seconds.items()}
    print(f"phase seconds {json.dumps(rounded)} "
          f"total {sum(seconds.values()):.1f} on {card}", flush=True)

    kernels = []
    for name, meta in KERNELS.items():
        by_path = {p: n[name] for p, n in paths.items() if name in n}
        row = rows[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=sum(by_path.values()),
            max_abs_err=row["max_abs_err"], ms=row["ms"],
            plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
            bound_by=row["bound_by"], library_ms=row["library_ms"],
            launches_by_path=by_path))
        for label, at in extra.items():
            if name in at:
                kernels[-1][f"at_{label}"] = at[name]
    print(json.dumps({"kernels": kernels}))
    # every path ran on the one device it was given
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
