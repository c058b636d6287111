#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (BFS on the 1-D and 2-D partitions in the
dense, queue and auto modes, BFS serving over HTTP, LM prefill, DeepFM
serving and the EmbeddingBag op, DeepFM training, LM decode serving, LM
training, GNN training, the Mixture-of-Experts and other LM configs, and
elastic resharding with the dry run) on one card.

    python3 chip_smoke.py            # full size, as the acceptance run
    python3 chip_smoke.py --profile  # also profile one run of each path

Phases (any failed check raises and the script exits non-zero):

1. build — compiles every ``src/repro_torch/csrc/*.cu`` (the BFS kernels,
   the attention kernels and the EmbeddingBag kernel, one nvcc each, in
   parallel) for sm_90a into
   one library under ``build/kernels/`` and prints the compiler's
   register report (and ``bsr_expand_bits``' lines of it on their own)
   and the card's name and power limit; counts the
   ``HGMMA`` and ``UTMALDG`` instructions in the SASS of the bf16 A4
   kernel (``cuobjdump -sass``) and fails if either is 0; prints the
   register report of A2's ``bsr_spmm_kernel``, failing on a spill, and
   its ``HGMMA`` and ``UTMALDG`` counts, failing on a 0; the same for
   A4's f32 route (``flash_fwd_tf32``, each head width), and the register
   report of its pre-pass
   (``split_kv_kernel``), failing on a spill; the
   register report of A5's ``bag_gather_kernel`` (each dtype and
   granule), failing on a spill, and counts its ``LDGSTS`` (``cp.async``)
   and ``UBLKCP`` (bulk copy) instructions, failing if it has no
   asynchronous copy.
2. path 1 — ``rmat_1m`` (Graph500 Kronecker, scale 20, edge factor 16)
   with the default dense expansion, S = 64 roots: once on a 4-shard
   ``LocalMesh`` with default options (packed wire, fused tail = kernel
   A1) and once on one shard with ``wire_format="packed"``.
3. path 3 — the same graph and roots with ``use_kernel=True`` on 4
   shards, default options: the one-bit tile expansion
   (``bsr_expand_bits``) and A1; distances bitwise equal to path 1's.
4. path 2 — ``small_world_100k`` (Watts-Strogatz k = 16, beta = 0.1)
   with ``use_kernel=True`` (``bsr_expand_bits`` and A1), one shard,
   packed wire, S = 64, against the same plan without ``use_kernel``.
   Every path resets the kernels' launch counts just before it runs and
   reads them just after; every kernel of the path must have launched,
   and under ``use_kernel`` the f32 A2 and A3 never.
   Distances are checked with ``validate_bfs`` (Graph500 rules) on every
   column and against scipy's BFS on four columns, bitwise.  Then the
   cost of the level loop's profiler ranges on this host-bound engine:
   its run time with the ranges as shipped (idle: nothing records with
   no profiler), replaced by a no-op, and forced (a ``record_function`` a
   range), in alternating rounds in this one process (printed, not
   checked: host times vary by more than the ranges cost).
5. path 4 — ``rmat_1m`` with path 1's roots, p = 4, default options, in the
   modes that mix level kinds: (a) ``mode="auto"``, S = 64 (dense and
   packed bottom-up levels, the fused tail A1 on the dense ones); (b)
   ``mode="auto"`` and (c) ``mode="queue"``, S = 1 (the visited sieve and
   the compressed queue wire), on the first 8 roots, the first three times.
   Distances bitwise path 1's (columns); (a)'s and (b)'s ``mode_counts``
   equal a numpy replay of the auto rule from the distances; A1 launches
   once per dense level of (a) and no other kernel does.
6. path 5 — the same graph and roots on the 2-D edge partition:
   ``to_2d(g, 2, 2)`` on a 2 x 2 ``LocalMesh.grid``, default options
   (packed expand and fold wires, A1 on the fused fold tail): (a)
   ``mode="dense"``, S = 64, three runs, A1 exactly once a level and no
   other kernel, ``comm_bytes`` the float32 sum of ``dense_level_bytes``
   a level; (b) ``mode="auto"``, S = 64; (c) ``mode="auto"`` and (d)
   ``mode="queue"``, S = 1, on the first 8 roots.  Distances bitwise path
   1's (columns); the auto ``mode_counts`` equal the numpy replay (the
   2-D auto rule is the 1-D rule on the same statistics).  Logs each
   cell's edges, ``e_cap`` and the host seconds of ``to_2d`` and of the
   bottom-up blocks.
7. path 6 — serving: path 1's ``rmat_1m`` and path 2's
   ``small_world_100k`` behind ``BFSService`` and ``serve_http``, with one
   ``GraphCatalog`` and one ``EngineCache``, ladder (1, 8, 64) on four
   lanes: ``rmat`` (p = 4, default options: A1 on the fused tail),
   ``rmat2d`` (the catalog's 2 x 2 view, path 5's cached ``to_2d``),
   ``sw`` (``use_kernel``, packed wire: ``bsr_expand_bits`` and A1) and
   ``rmat_alias`` (rmat's graph under a second name: its plans key equal,
   so it compiles nothing).  Every rung is compiled through the cache and
   run once at full S first: its ``estimated_device_bytes()`` must cover
   the measured ``max_memory_allocated`` rise, and a lane's later rungs
   hold the first rung's block uploads (memory grows by their working
   buffers).  Then 8 client threads (stdlib ``urllib``, 60 s a call) send
   48 ``POST /v1/traverse``, lanes in rotation, fan-outs drawn from
   {1, 3, 8, 17, 64}, sources from the paths' 64 roots, a quarter with
   parents: depths bitwise the paths' columns, parents by the JAX
   client's rule, the cache's compiles equal the 9 distinct plan keys, A1
   launched once a level of the 48 runs and ``bsr_expand_bits`` once a
   level of the ``sw`` runs, no other kernel; a ``BFSService.step`` of
   one request a lane against the lanes one at a time (the round's
   overlap); ``/admin/shutdown`` drains and stops.  Then a second cache
   with a byte budget between two and three ``rmat`` rung estimates:
   serving S = 1, 8, 64 evicts S = 1, freeing at least its working
   buffers, and S = 1 then recompiles bitwise.  Last, a ``FaultPlan``
   failing ``cache.compile`` for ``rmat``'s S = 64 rung: a 40-source
   request is served by the ``split:8`` arm, five runs of one engine,
   bitwise, and ``/metrics`` shows the arm.
8. path 7 — the launchers, each ``main(argv)`` called in process so the
   kernel counts see its launches: (a) ``bfs_run --workload rmat_1m
   --devices 4 --mode dense --sources 64 --repeats 2 --profile DIR`` (not
   cut): run 0 (sources 0..63) prints the levels, visited, modes and
   ``comm_bytes/chip`` of path 1's p = 4 engine on those sources, its
   distances pass ``validate_bfs`` and scipy, A1 launches once a level of
   the two runs and no other kernel, and ``analysis.trace_model``'s
   summary has a row a level, the device events it places at their
   launch cover all but 1% of the device time in the trace file,
   ``other`` is under 2% of the time inside the levels, and ``expand``
   is the largest phase; (b) the same on the
   2 x 2 grid in ``auto`` (``--repeats 1``): levels, visited and modes of
   path 5 (b)'s engine on 0..63; (c) after path 6's service is released,
   ``bfs_serve --devices 4 --http`` on ``rmat:1048576``, its 2 x 2 twin
   and ``small_world:100000`` (``bfs_serve``'s generator defaults, as the
   JAX launcher's: rmat edge factor 8, small-world k = 8), ladder
   (1, 8, 64), a 5 s watchdog, in a thread; ``bfs_client --requests 12
   --max-retries 2 --verify`` on each lane in subprocesses (the last with
   ``--shutdown``) exits 0, the server drains and returns 0, A1 launched;
   (d) ``bfs_chaos --devices 4 --secs 20 --n 100000`` exits 0 with at
   least one ``cache.get`` storm and a bitwise 200 requested after it.
9. path 8 — the plan audits (``analysis.collective_audit``, ``lint``,
   ``locks``), each entry point called in process: (a) ``bfs_audit
   --graph er:4096 --all-variants --devices 4 --census --out
   build/chip_smoke_path8/BENCH_audit_torch.json`` exits 0: 48 variants
   planned, each distinct one audited clean, with the host reads of
   every level counted by ``torch.cuda.set_sync_debug_mode`` within the
   budget; it prints the data collectives a level by level kind and the
   least and most recorded-to-modeled byte ratio by role; (b) ``bfs_run
   --workload rmat_1m --devices 4 --mode dense --sources 64 --repeats 2
   --audit`` (not cut): the audit passes, each ``dense`` row receives
   ``describe()["dense_level_bytes"]`` within the tolerance, the audited
   run's distances are bitwise path 1's p = 4 engine on sources 0..63,
   run 0 prints that engine's line, and A1 launches once a level of the
   audited run, the audit's two buffer-check runs and the two timed
   runs; then a ``use_kernel`` engine on ``small_world_100k`` at p = 4,
   audited from path 2's roots: clean, distances bitwise path 2's,
   ``bsr_expand_bits`` and A1 once a level.  Paths 1, 3, 4 (a) and 5 (a)
   print each level kind's ``describe()["roofline"]`` ``t_level_s``
   beside the measured ms a level, and the share.
10. path 9 — ``DistMesh``, one shard a process (``core.dist_mesh``): the
   parent writes the graphs and expected distances it already holds to
   ``build/chip_smoke_path9/`` once (no rank regenerates R-MAT), then
   starts the processes with ``spawn`` (the kernels were built before;
   a process group's collectives time out after 120 s, and every process
   is killed and failed at 420 s).  (a) ``nccl`` at world size 1:
   ``rmat_1m`` at p = 1, packed wire, S = 64, path 1's roots: bitwise
   path 1's p = 1 run, A1 once a level.  Then four ``gloo`` processes
   sharing ``cuda:0`` (NCCL refuses two ranks on one GPU; a ``gloo``
   collective that refuses CUDA tensors is staged through the host, and
   the transport is printed): (b) ``rmat_1m`` p = 4, default options,
   S = 64: distances, ``levels`` and ``comm_bytes`` bitwise path 1's
   p = 4 run, A1 once a level on each rank, each rank's
   ``estimated_device_bytes`` and ``memory_allocated`` after compile, and
   the ranks' ``resident`` terms summing to the stacked engine's; (f)
   every rank audits (b)'s engine and rank 0's census is printed: clean,
   every role at ratio 1.000, the host reads within the budget; (c)
   ``auto`` S = 1 on path 4's first 8 roots: bitwise, ``mode_counts``
   equal to ``replay_modes``; (d) ``DistMesh.grid(2, 2)`` dense S = 64:
   bitwise path 5 (a), its levels and ``comm_bytes``; (e)
   ``small_world_100k`` with ``use_kernel`` at p = 4: bitwise path 2,
   ``bsr_expand_bits`` once a level on each rank; and a planted fault,
   rank 1 reporting the next shard's index, whose distances must fail
   the check.  (b)'s and (d)'s ms a level print beside paths 1's and 5
   (a)'s: ``gloo`` through the host on one card, not a multi-card figure.
11. prefill — gemma3-12b at full width (d_model 3840, 16 q / 8 kv heads of
   256, d_ff 15360, vocab 262144, bf16) through ``build_bundle(...,
   "prefill_32k")``, cut to 12 layers (two 5 local + 1 global groups) and
   batch 2 x seq 8192, with random weights from a seeded generator on the
   card.  Three runs, each with kernel A4's bf16 route launched once per
   layer; runs 2
   and 3 bitwise equal; then the same prefill with the plain attention,
   held to a stated tolerance (the first layer's cache bitwise), which
   two planted faults (every local window one key off) must fail.
12. recsys — DeepFM at its full configuration (39 fields x 1,000,000 rows
   x 10, a 1.56 GB f32 table, MLP 403-400-400-400-1), not cut, through
   ``build_bundle(get_arch("deepfm"), ...)`` for ``serve_p99``,
   ``serve_bulk`` and ``retrieval_cand``, with random weights from a
   seeded generator on the card.  Three runs of each step (runs 2 and 3
   bitwise equal), held to the port's own steps on the CPU in float64
   from the same weights: gathered rows bitwise, the FM term, logits and
   scores at a stated relative L2 limit.  Two planted faults must fail
   that hold: every field offset one row off, and (serve) TF32 products.  DeepFM looks its fields up
   with a row gather, as the JAX package does, so no kernel launches.
13. embedding bag — the lookup op ``kernels.embedding_bag.ops.embedding_bag``
   (kernel A5) on (a) the ``serve_bulk`` batch's own flat ids as bags
   over DeepFM's table (the op's main path, three calls; also held to the
   serve path's ``emb.sum(1)``), (b) the same bags cut to seeded ragged
   lengths, sum and mean, both on the gather route (``bag_gather_kernel``),
   (c) ``bench_kernels``' shape, (256, 8) over (10,000, 128), in f32 and
   bf16, and (d) bf16 over (10,000, 127), these three tables in L2 and so
   on the plain-load route (``bag_sum_kernel``); bitwise to its plain
   version each time, by the route the shape takes and by the other one.
   Timed on (a) and (b): the wrapper, its index check, the launch alone
   and each route's launch (each held bitwise), beside the bound of the
   useful bytes and that of the 32-byte sectors the rows span; and on
   (a)'s ids over a (V, 8) f32 table (one sector a row) and over the
   table's first 100,000 rows (a 4 MB table, the plain-load route).
14. kernels — each kernel against its plain torch version on the card at
   the shapes of the paths (A4 also each (batch, head) slice, with the
   window one key off failing; ``bsr_expand_bits`` on path 2's densest
   level and on a random 5% frontier, and the f32 A2 + A3 chain of
   ``ops.frontier_expand_packed``, driven on its own, held bitwise to
   it), then timed beside its bound (and, for A2,
   beside ``torch.sparse_bsr_tensor @ x``; for A4, beside
   ``F.scaled_dot_product_attention`` on the global layer's shape and, with
   the window as a boolean ``attn_mask``, on the local layer's; for A5,
   beside ``F.embedding_bag`` with per-slot weights on (a)).  A2 (split
   TF32 on ``wgmma``) is also run twice on the same operands (equal y),
   and one pass of TF32 (the plain bmm under ``allow_tf32``) must fail its
   f32 hold; its bound is the bytes' or three TF32 products', the f32-FMA
   and TF32 times beside it.  A3 is timed alone, 50 launches in a CUDA
   graph, beside its wrapper.  A4's f32 route (split TF32 on ``wgmma``
   after its pre-pass) is driven through ``ops.attention`` at the global
   and local layer's shapes in f32 (one f32 launch and one pre-pass a
   call), held to the plain version, run twice on the same operands
   (equal outputs), and a planted fault, the plain version with TF32
   products (``allow_tf32``: one pass of TF32), must miss the 2e-5 head
   limit; timed beside its bounds, the pre-pass alone beside its byte
   bound, the plain version and SDPA in f32 (the backend it took and its error printed).

15. path 10 — DeepFM training at full width (``train_batch``: 39 fields x
   1,000,000 rows x 10 f32, MLP 403-400-400-400-1, batch 65,536; not cut),
   allow_tf32 off: (a) ``launch.train.main(["--arch", "deepfm", "--shape",
   "train_batch", "--steps", "20", "--ckpt-every", "10", ...])`` in
   process: 20 clean steps with finite losses, no kernel launched (a row
   gather and the plain AdamW), the step ms (median of steps 2-20),
   examples/s, peak memory and each checkpoint's bytes and seconds; (b)
   (a)'s step-20 checkpoint restored (timed) and one more step held to the
   same step in f64 on the card: the loss, the grad norm and each leaf's
   update (new - old) within ``TRAIN_TOL``, which the bias correction
   dropped and TF32 products must fail; (c) ``Trainer`` with a fault at
   step 12 and checkpoints every 10: one restart at step 10, (a)'s final
   loss, the largest parameter difference from (a)'s state printed; (d)
   ``make_compressed_train_step`` with ``topk`` (1/32) and ``bf16``, three
   steps each: the losses, ``sent + new_ef == g + ef`` bitwise, the
   table leaf's threshold by ``torch.topk`` and by ``torch.kthvalue``
   (equal, each timed) and ``wire_bytes``.  Its checkpoints live in
   ``build/chip_smoke_path10/`` and are removed at the end.
16. path 11 — gemma3-12b decode, bf16, seeded weights: (a) at the prefill
   phase's cut (12 layers, batch 2) through the ``decode_32k`` bundle: an
   8,191-token prompt prefilled with A4 into a 32,768-deep cache, one
   decode step at per-sequence pos 8,191 (past the 1,024-key local
   window) held to the last-token logits of A4's prefill of the 8,192
   tokens (``DECODE_TOL``), the same step at a scalar pos bitwise, four
   greedy steps timed; then the same in f32 (the weights cast, the plain
   prefill; ``DECODE_F32_TOL``); every local window one key off in the
   decode step must fail both; A4 launched once a layer of each A4
   prefill and never by decode.  (b) ``launch.serve.main(["--arch",
   "gemma3_12b", "--requests", "8", "--slots", "4", "--max-len", "2048",
   "--max-new-tokens", "64"])`` at full depth (48 layers): every request
   finishes with 64 tokens, request 0 served alone gives the same tokens,
   and each first token is the argmax of A4's prefill of the sequence the
   server fed (the prompt, its last token again) wherever the top-2
   margin exceeds twice the drift between that prefill and the decode
   path (at least one row must); ms a decode step and tok/s printed.

17. path 12 — gemma3-12b ``train_4k`` at full width (d 3840, 16 / 8 heads
   of 256, d_ff 15,360, vocab 262,144, bf16, untied, windows 1,024 and 0,
   remat ``block``), cut to 6 layers (one pattern group) and batch 4, seq
   4,096 not cut; the host memory and free disk checked against the 33.6
   GB train state first.  (a) ``Trainer`` over the cut bundle, 5 steps on
   one fixed batch, ``AdamWConfig(warmup_steps=1, total_steps=5)``: the
   first loss within 0.1 of ln V + 1/2, the loss falling at every step,
   every leaf finite, A4 never launched; step ms (median of steps 2-5),
   tokens/s, peak; the step-5 checkpoint (keep 1, under
   ``build/chip_smoke_path12/``, removed after) restored to the host and
   held to the state bitwise, its bytes and seconds.  (e) the trained
   params served: ``Transformer.from_tree`` over the state's tensors, a
   prefill of the batch with A4 (6 launches) and 4 greedy decode steps,
   logits finite.  (b) ``flash_train`` at B 1, Hq 16, Hkv 8, S 4,096, Dh
   256, chunk 1,024, windows 1,024 and 0, f32: out, dq, dk, dv within
   ``FLASH_TOL`` of autograd through the plain masked softmax, which a
   window one key off and the causal mask dropped must fail; both timed.
   (c) the bf16 step's loss and gradients at batch 1 against the same
   step in f32 (``STEP_TOL``), which the labels one position on and a
   local layer given the global window must fail.  (d) remat ``none``,
   ``block`` and ``dots`` at batch 2: the same gradients bitwise, each
   policy's peak; microbatches 2 against 1 on one batch of 4 through the
   bundle (``MICRO_LOSS_TOL``, ``MICRO_NORM_TOL``).

18. path 13 — the GNN family at full width, f32, allow_tf32 off, seeded
   weights, the bundles' own synthetic batches; no kernel launches (JAX's
   GNN routes are gathers, segment sums and matrix products, no Pallas
   kernel): (a) ``gcn_cora`` on ``ogb_products``, not cut (2,449,152
   padded nodes x 100, 61,859,200 edge slots), through
   ``launch.train.main(["--arch", "gcn_cora", "--shape", "ogb_products",
   "--steps", "3", ...])``: clean steps, the device step ms apart from
   ``make_batch``'s host seconds, peak, real edges beside slots; the
   step-3 checkpoint restored and one step's loss and every gradient leaf
   held to the same step in f64 on the card (``GNN_TOL``), which every
   valid edge's dst one node on must fail.  (b) ``gatedgcn`` on
   ``minibatch_lg``'s sampled dims (169,984 x 602 nodes, 168,960 edges),
   5 ``Trainer`` steps, the same hold and fault; then ``NeighborSampler``
   over path 1's ``rmat_1m`` CSR through ``graph_minibatch_stream`` (1,024
   seeds, fanout (15, 10)): the bundle's shapes, every sampled edge a
   graph edge, the stream bitwise the sampler, host ms a batch.  (c)
   ``schnet`` on ``molecule`` (128 graphs, 3,840 nodes, 8,192 slots), 5
   steps, the hold and fault, every value finite.  (d) ``graphcast`` (d
   512, 16 layers, 227 vars) on ``ogb_products`` cut by ``GRAPHCAST_CUT``
   (``erdos_renyi`` at its degree): the global loss against
   owner-exchange on a 4-shard ``LocalMesh`` with the same weights, every
   edge routed once, the loss and the ``enc_h`` / ``dec`` gradients
   within JAX's limits (``OWNER_*_TOL``), one shard's ``serve_ids``
   rolled by a row failing them; each route's forward + backward ms and
   peak, and the exchange's bytes a layer beside the global route's two
   table gathers.  Its checkpoints live in ``build/chip_smoke_path13/``.

19. path 14 — Mixture-of-Experts and the four LM configs of its slice at
   full width, bf16, seeded weights, TF32 off: (a) ``dbrx_132b`` (16
   experts top-4) cut to 4 layers and (b) ``llama4_maverick_400b_a17b``
   (128 experts top-1 and a shared expert; one dense, one MoE layer) cut
   to 2, each through the ``prefill_32k`` and ``decode_32k`` bundles at
   batch 2: an 8,192-token A4 prefill (A4 once a layer) with each MoE
   layer's dropped count printed; each MoE layer's bf16 output on its
   recorded input held to its f32 twin (``MOE_TOL``; routing identical,
   ``dropped`` equal, ``lb_loss`` within ``LB_TOL``), which the dispatch
   one slot off from the combine and unnormalised gates must fail; the
   decode step at pos 8,191 held to the last-token logits of an A4
   prefill of 8,192 tokens (``DECODE_TOL``) on a second pair of prefills
   under a capacity factor where no layer drops (E / k for dbrx; for
   llama4, whose one MoE layer's input does not depend on capacity, the
   least covering its busiest expert), row by row where every MoE layer
   routes the last token alike; greedy decode steps timed; then (b)'s
   MoE layer through ``moe_apply_sharded`` on a (data 1, model 4)
   ``LocalMesh`` against the local route (``SHARDED_TOL``, ``lb_loss``
   and ``dropped`` equal), both timed.  (c) ``launch.serve.main`` on
   ``yi_34b`` at 60 layers (not cut; ``YI_SERVE_ARGV``): every request
   finishes, request 0 alone gives the same tokens, ms a decode step,
   tok/s and peak printed.  (d) ``qwen1_5_110b`` cut to 4 layers with
   its q/k/v biases drawn nonzero (JAX's are zero): the A4 prefill held
   to the plain one (``PREFILL_TOL``), which ``bk`` dropped must fail,
   and the decode step to the A4 prefill.  (e) ``dbrx_132b``
   ``train_4k`` cut to 1 layer and batch 1 (seq 4,096) through the
   ``Trainer`` (3 steps, one batch, no checkpoint), free device memory
   checked against the 53.9 GB of parameters, gradients and moments
   first: losses finite and falling, every leaf finite, ``lb_loss`` and
   ``dropped`` a step, step ms, tokens/s and peak; A4 never.  First,
   the bytes of drawing yi's and llama4's largest leaf whole in f32
   against ``layers.core.scaled_normal``'s slices.

20. path 15 — elastic resharding, the sharding plan and the dry run:
   (a) path 1's p = 4 ``rmat_1m`` graph through
   ``train.elastic.repartition_graph`` to p = 2 and p = 1, each run twice
   in ``mode="dense"`` with ``wire_format="packed"`` (A1 at every shard
   count): distances bitwise path 1's, A1 exactly once a level and no
   other kernel, path 1's p = 4 distances through
   ``repartition_vertex_array`` equal to the p = 2 engine's, each
   repartition's host seconds beside the run's ms a level; (b)
   ``small_world_100k`` under ``use_kernel=True`` at p = 4, repartitioned
   to 2, then to 1: distances bitwise path 2's, ``bsr_expand_bits`` once
   a level; (c) DeepFM ``train_batch`` uncut (the 5.2 GB state of path
   10), deterministic scatters: 3 steps, ``reshard_state`` onto a (data
   1, model 4) ``LocalMesh`` under ``state_specs(recsys_param_specs)``
   (on the card: every leaf a new, equal tensor), a CPU copy resharded
   back onto the card (through the host), 3 more steps: losses and the
   final state bitwise 6 uninterrupted steps, each reshard's bytes and
   seconds; ``P("model", None)`` on a 7-way model axis must raise; (d)
   ``launch.dryrun.lower_cell`` on a 1-chip meta mesh for path 12's
   gemma3 cut (6 layers, batch 4) and DeepFM ``train_batch``: its
   ``arg_bytes`` equal to the real state's and batch's bytes on the card
   and within ``DRY_MEM_TOL`` of the bytes the allocator was asked for
   (``memory_allocated``, which counts 2 MiB segments, within 1 MiB a
   leaf of them), its trace's dot FLOPs equal to ``FlopCounterMode``'s count of one real
   step on the card (no kernel launched), the measured temporaries,
   ``t_compute_s`` against a timed step and ``useful_flops_ratio``
   printed; then both cells' 16 x 16 and 2 x 16 x 16 rows (meta, no card
   memory).

The last line is ``{"ok": true, "device": {...}}``; before it come one
``{"kernels": [...]}`` JSON line (every kernel's row, with its launches
in each path that runs it; paths 13 to 15 add no row, path 14 launches
A4 alone and path 15 A1 and ``bsr_expand_bits``) and the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import multiprocessing
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SEED = 0
S = 64
MEM_BW = 3.35e12          # H100 SXM HBM3 bytes/s (NVIDIA data sheet)
F32_FLOPS = 67e12         # H100 SXM f32 FLOP/s outside the tensor cores
BF16_FLOPS = 989e12       # H100 SXM dense bf16 tensor-core FLOP/s
TF32_FLOPS = 495e12       # H100 SXM dense TF32 tensor-core FLOP/s
# the prefill phase: gemma3-12b's prefill_32k cell, cut in depth and size
PREFILL_LAYERS, PREFILL_BATCH, PREFILL_SEQ = 12, 2, 8192
# A4 against its plain version, bf16: the largest relative L2 error of one
# (batch, head) slice.  The kernel rounds each p to bf16 before PV (a
# relative error of at most 2^-8, RMS 2^-8/sqrt(3)) and both round the
# output to bf16 once.  On an H100 the correct kernel reads at most
# 0.0023 (2^-8.8) a head and a window one key off at least 0.020
# (2^-5.6), at the prefill's shapes; 2^-7 sits a factor of about 3 from
# each, and the script checks that the planted fault fails.
A4_HEAD_TOL = 2.0 ** -7
# the prefill with A4 against the same prefill with the plain attention:
# relative L2 of the logits and of each layer's cache.  The bf16 drift
# grows with depth: 0.0078 in layer 1's cache to 0.0184 in the logits at
# 12 layers (seed 0, H100); 2^-5 leaves a factor of 1.7.
PREFILL_TOL = 2.0 ** -5
# the recsys phase: DeepFM's steps, not cut, and the rows of each held to
# the f64 CPU twin (the first rows of the batch, or of the candidates)
RECSYS_CELLS = ("serve_p99", "serve_bulk", "retrieval_cand")
RECSYS_HOLD = {"serve_p99": 512, "serve_bulk": 4096,
               "retrieval_cand": 65_536}
# f32 on the card (matrix products in full f32: allow_tf32 is False)
# against f64 on the CPU: relative L2 of the logits and scores (serve) and
# of the scores (retrieval); the FM term (about 1e-2 of the logits) is held
# on its own.  On an H100 the correct steps read at most 2.6e-7 (serve_bulk
# logits) and the FM term 2.2e-7; field offsets one row off read at least
# 0.043 (serve scores) and FM 1.4.  2^-20 sits 3.7 times above the worst
# correct reading; the serve steps with TF32 products (10-bit mantissa),
# a second planted fault, must fail it too.
RECSYS_TOL = 2.0 ** -20
FM_TOL = 2.0 ** -20


def log(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls
    (CUDA events, after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float = 0.0, peak: float = F32_FLOPS):
    """Least time (ms) for the work on the card, and what bounds it."""
    t_mem, t_ops = nbytes / MEM_BW, flops / peak
    return max(t_mem, t_ops) * 1e3, ("bytes" if t_mem >= t_ops
                                     else "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


T_START = 0.0            # main's start, for the script's total

# the highest device memory of the phases before the last peak reset
_EARLIER_PEAK = 0


def reset_peak() -> None:
    """Start a phase's peak memory reading; the script's own peak keeps
    the highest reading of every phase."""
    global _EARLIER_PEAK
    torch.cuda.synchronize()
    _EARLIER_PEAK = max(_EARLIER_PEAK, torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    """Peak device memory since the script started, in GiB."""
    return max(_EARLIER_PEAK, torch.cuda.max_memory_allocated()) / 2**30


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def scipy_check(src, dst, n, roots, dist_host, inf):
    """Bitwise agreement of four columns with scipy's unweighted BFS."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    adj = csr_matrix((np.ones(src.shape[0], np.int8), (src, dst)),
                     shape=(n, n))
    sp = shortest_path(adj, method="D", directed=True, unweighted=True,
                       indices=roots[:4])
    want = np.where(np.isinf(sp), inf, sp).astype(np.int32).T
    check(np.array_equal(dist_host[:, :4], want),
          "dist differs from scipy's BFS on the first four roots")


def reset_counts(kernels) -> None:
    """Set every kernel's launch counts (A4's per-route ones too) to 0."""
    for k in kernels.values():
        for attr in ("launches", "launches_bf16", "launches_f32",
                     "launches_gather", "launches_loads"):
            if hasattr(k, attr):
                setattr(k, attr, 0)


def library_sass(lib: Path) -> str:
    """The SASS of the built library (``cuobjdump -sass``)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout


def sass_counts(sass: str, pattern: str, ops) -> dict:
    """For each kernel whose mangled name matches ``pattern`` (keyed by
    its groups joined with "/"), the count of each instruction of ``ops``
    and the highest register named in its SASS."""
    import re

    counts, fn = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : \S*" + pattern, line)
        if m or "Function : " in line:
            fn = "/".join(m.groups()) if m else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0) | {"max_reg": 0}
        elif fn:
            for op in ops:
                counts[fn][op] += op in line
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            counts[fn]["max_reg"] = max([counts[fn]["max_reg"], *regs])
    return counts


def drive(kernels, eng, roots, runs: int = 3):
    """Reset the launch counts, run the engine ``runs`` times and read the
    counts; returns (host dist of the last run, per-run ms of runs 2..,
    last result, counts)."""
    reset_counts(kernels)
    run_ms, last_host, res = [], None, None
    for i in range(runs):
        t0 = time.perf_counter()
        res = eng.run(roots)
        run_ms.append((time.perf_counter() - t0) * 1e3)
        host = res.dist_host
        if last_host is not None:
            check(np.array_equal(host, last_host),
                  "two runs of one engine disagree")
        last_host = host
    counts = {name: k.launches for name, k in kernels.items()}
    return last_host, run_ms[1:], res, counts


def span_cost(eng, roots, rounds: int = 20, per_round: int = 10,
              calls: int = 100_000) -> dict:
    """The level loop's profiler ranges priced on ``eng`` (path 2): the
    host ms of a run ending in its result read, with ``core.spans.span``
    as shipped (``idle``), swapped for a no-op (``no-op``: the call sites
    still enter a ``with``) and for a bare ``record_function``
    (``forced``), the settings alternating in rounds; the ranges a run
    enters (one run under a CPU profiler); and the us of one range in
    each setting over ``calls`` calls."""
    import contextlib
    import importlib
    import statistics

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import spans

    users = [importlib.import_module(f"repro_torch.core.{m}")
             for m in ("bfs", "mesh")]
    check(all(u.span is spans.span for u in users),
          "span_cost: a level-loop module does not use core.spans.span")
    idle = contextlib.nullcontext()
    settings = {"idle": spans.span, "no-op": lambda name: idle,
                "forced": torch.profiler.record_function}
    times = {name: [] for name in settings}
    per_range_us = {}
    try:
        for _ in range(rounds):
            for name, fn in settings.items():
                for u in users:
                    u.span = fn
                for _ in range(per_round):
                    t0 = time.perf_counter()
                    eng.run(roots).dist_host
                    times[name].append((time.perf_counter() - t0) * 1e3)
        for name, fn in settings.items():
            t0 = time.perf_counter()
            for _ in range(calls):
                with fn(spans.EXPAND):
                    pass
            per_range_us[name] = (time.perf_counter() - t0) / calls * 1e6
    finally:
        for u in users:
            u.span = spans.span
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        eng.run(roots).dist_host
    ranges = sum(e.count for e in prof.key_averages()
                 if e.key.startswith("bfs."))
    med = {name: statistics.median(t) for name, t in times.items()}
    return {"runs_per_setting": rounds * per_round,
            "ms_per_run_median": med,
            "ms_per_run_mean": {name: statistics.fmean(t)
                                for name, t in times.items()},
            "ranges_per_run": ranges, "us_per_range": per_range_us,
            "idle_over_noop": med["idle"] / med["no-op"] - 1,
            "forced_over_noop": med["forced"] / med["no-op"] - 1}


def report_run(name, compile_ms, run_ms, res, counts) -> None:
    st = res.run_stats
    log(f"{name}: compile {compile_ms:.1f} ms; runs {[round(t, 3) for t in run_ms]} ms; "
        f"levels {st.levels}; per-level ms "
        f"{[round(t * 1e3, 3) for t in st.level_seconds]}; "
        f"comm_bytes {st.comm_bytes}; launches {counts}")


def ptxas_reports(log_text: str, name: str) -> dict:
    """The ``-Xptxas -v`` report of each kernel whose mangled name holds
    ``name``, keyed by that name: stack, spills, registers and barriers."""
    lines, out = log_text.splitlines(), {}
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and name in line:
            fn = line.split("'")[1] if "'" in line else line
            out[fn] = " | ".join(x.strip() for x in lines[i + 2:i + 4])
    return out


def ptxas_lines(log_text: str, name: str) -> str:
    """The report of the first kernel whose mangled name holds ``name``."""
    return next(iter(ptxas_reports(log_text, name).values()), "")


def densest_frontier(host: np.ndarray, n: int, inf: int, dev):
    """The largest frontier of a run: the ``(n, S)`` uint8 mask of the
    depth that holds the most (vertex, source) pairs; with the depth and
    the pair count."""
    counts = np.bincount(host[host < inf].ravel())
    depth = int(np.argmax(counts))
    mask = np.zeros((n, host.shape[1]), np.uint8)
    mask[:host.shape[0]] = host == depth
    return torch.from_numpy(mask).to(dev), depth, int(counts[depth])


def frontier_words(mask: torch.Tensor, p: int, col_pad: int):
    """An ``(n, S)`` uint8 frontier of ``p`` shards as ``bsr_expand_bits``
    takes it: each shard's rows zero-padded to ``col_pad``, packed along
    the vertex axis."""
    from repro_torch.core.frontier import pack_bits

    n, s = mask.shape
    x = torch.zeros((p, col_pad, s), dtype=torch.uint8, device=mask.device)
    x[:, : n // p] = mask.reshape(p, n // p, s)
    return pack_bits(x).reshape(-1, s)


def expand_bound(tiles, cmask, rows, cols, fwords, out) -> dict:
    """``bsr_expand_bits``' byte bound: the column masks, block indices,
    frontier words and output, and the tiles this frontier makes it read
    (those whose column mask meets some source's frontier word); beside
    it the bound with every tile read, which no skip can pass."""
    any_src = fwords[:, 0].clone()
    for j in range(1, fwords.shape[1]):
        any_src |= fwords[:, j]
    words = cols.long()[:, None] * 4 + torch.arange(4, device=cols.device)
    read = int(((any_src[words] & cmask) != 0).any(dim=1).sum())
    fixed = nbytes(cmask, rows, cols, fwords, out)
    b_ms, b_by = bound(fixed + read * tiles[0].numel() * tiles.element_size())
    all_ms, _ = bound(fixed + nbytes(tiles))
    return {"bound_ms": b_ms, "bound_by": b_by, "bound_all_tiles_ms": all_ms,
            "tiles_read": read, "tiles": tiles.shape[0]}


def path3_phase(kernels, g, src, dst, roots, want, dev, profile: bool):
    """``rmat_1m`` with ``use_kernel`` on 4 shards (module docstring, phase
    3); returns ``bsr_expand_bits``' reading at these shapes."""
    from repro_torch.core import BFSOptions, plan
    from repro_torch.core import frontier as fr
    from repro_torch.core.ref import validate_bfs
    from repro_torch.kernels.bsr_spmm.kernel import bsr_expand_bits

    part = g.part
    p, shard, n = part.p, part.shard_size, part.n
    reset_peak()
    t0 = time.perf_counter()
    pl = plan(g, BFSOptions(use_kernel=True), num_sources=S)
    eng = pl.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    tiles, cmask, row_ptr, rows, cols = eng.kernel_arrays
    d = pl.describe()
    log(f"path 3: p={p} dense_exchange={d['dense_exchange']} fused="
        f"{d['use_fused_tail']}; {tiles.shape[0]} tiles in "
        f"{nbytes(tiles) / 1e9:.3f} GB of bit tiles (compile, the bit-tile "
        f"build included: {compile_ms:.1f} ms)")
    host, run_ms, res, counts = drive(kernels, eng, roots)
    levels = res.run_stats.levels
    check(counts["bsr_expand_bits"] == 3 * levels,
          f"path 3: bsr_expand_bits launched {counts['bsr_expand_bits']} "
          f"times in 3 runs of {levels} levels")
    check(counts["bsr_spmm"] == 0 and counts["bitpack_words"] == 0,
          "path 3: the f32 A2 or A3 launched under use_kernel")
    check(counts["fold_update"] > 0, "path 3: kernel A1 never launched")
    validate_bfs(src, dst, roots, res.dist[:part.n_logical, :S])
    check(np.array_equal(host, want),
          "path 3: distances differ from path 1's p4_default")
    report_run("path 3 use_kernel p4", compile_ms, run_ms, res, counts)
    roofline_line("path 3 use_kernel p4", d, res.run_stats,
                  ["dense"] * levels)
    log(f"path 3: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run("path 3 use_kernel", lambda: eng.run(roots))

    # the kernel at these shapes on the run's densest frontier, held to
    # the plain scatter-max expansion over the edge list (the plain
    # version's f32 tiles would be 695 GB), then timed beside its bound
    mask, depth, pairs = densest_frontier(host, n, fr.INF, dev)
    fwords = frontier_words(mask, p, -(-shard // 128) * 128)
    layout = dict(n_valid=n, n_blocks=p, rows_per_group=-(-n // 128) * 128)
    out = bsr_expand_bits(*eng.kernel_arrays, fwords, **layout)
    # shard j's group holds the candidates of shard j's own edges, packed
    # per owner, as the engine ships them
    src_d, dst_d = torch.from_numpy(src).to(dev), torch.from_numpy(dst).to(dev)
    owner = src_d // shard
    for j in range(p):
        sel = owner == j
        want_j = fr.pack_bits(fr.expand_dense_edges(mask, src_d[sel],
                                                    dst_d[sel], n), p)
        check(torch.equal(out.reshape(p, -1, S)[j], want_j),
              f"path 3: shard {j}'s candidate words differ from the "
              f"scatter-max expansion over its edges")
        del sel, want_j
    del src_d, dst_d, owner
    ms = timed_ms(lambda: bsr_expand_bits(*eng.kernel_arrays, fwords,
                                          **layout), 10)
    pack_ms = timed_ms(lambda: fr.pack_bits(mask.view(p, shard, S)), 10)
    b = expand_bound(tiles, cmask, rows, cols, fwords, out)
    log(f"bsr_expand_bits at path 3 (depth {depth}, {pairs} frontier "
        f"pairs, the densest level): {ms} ms; bound {b['bound_ms']} ms "
        f"({b['bound_by']}; {b['tiles_read']} of {b['tiles']} tiles read), "
        f"every tile {b['bound_all_tiles_ms']} ms; each shard's words "
        f"agree bitwise with the scatter-max expansion over its edges; "
        f"pack_bits of the frontier (a run's "
        f"first level) {pack_ms} ms")
    del eng, res, tiles, cmask, row_ptr, cols, rows, out
    torch.cuda.empty_cache()
    return {"ms": ms, **b, "depth": depth, "frontier_pairs": pairs,
            "pack_ms": pack_ms, "compile_ms": compile_ms,
            "shape": f"{b['tiles']} tiles over 4 shards, frontier words "
                     f"{tuple(fwords.shape)}"}


def replay_modes(host: np.ndarray, deg: np.ndarray, n_edges: int, s: int,
                 inf: int):
    """numpy replay of the ``auto`` rule (JAX ``bfs.py:244-245, 379-413``)
    from a run's distances, independent of the port's loop: level ``L``'s
    frontier is ``dist == L-1``; ``f_verts`` counts its pairs over every
    column, ``f_edges`` the out-edges of column 0's frontier.  Returns the
    level count (the largest finite distance + 1) and each level's mode."""
    from repro_torch.core import BFSOptions

    opts = BFSOptions()
    queue_cut = max(1, int(opts.queue_threshold * n_edges))
    bottom_up_cut = max(1, int(opts.bottom_up_threshold * host.shape[0]))
    levels = int(host[host < inf].max()) + 1
    modes = []
    for level in range(1, levels + 1):
        front = host == level - 1
        f_verts, f_edges = int(front.sum()), int(deg[front[:, 0]].sum())
        if f_verts > bottom_up_cut:
            modes.append("bottom_up")
        elif s == 1 and f_edges < queue_cut:
            modes.append("queue")
        else:
            modes.append("dense")
    return levels, modes


def mode_counts(modes) -> dict:
    return {m: modes.count(m) for m in ("dense", "queue", "bottom_up")}


def build_engine(label: str, g, opts, s: int, **plan_kw):
    """Plan and compile one engine of a BFS path; logs its resolved wires
    and compile time.  Returns (plan, engine, describe())."""
    from repro_torch.core import plan

    reset_peak()
    t0 = time.perf_counter()
    pl = plan(g, opts, num_sources=s, **plan_kw)
    eng = pl.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    d = pl.describe()
    keys = ("dense_exchange", "queue_exchange", "expand_exchange",
            "fold_exchange", "expand_sparse_exchange",
            "fold_sparse_exchange")
    log(f"{label}: wires {d['wire_formats']}, "
        f"{', '.join(f'{k} {d[k]}' for k in keys if k in d)}, sieve "
        f"{d['sieve']}, fused {d['use_fused_tail']}; compile "
        f"{compile_ms:.1f} ms")
    return pl, eng, d


def report_modes(label: str, run_ms, st: dict, modes, res) -> None:
    log(f"{label}: runs {[round(t, 3) for t in run_ms]} ms; "
        f"levels {st['levels']}; per-level ms (mode) "
        f"{[f'{t * 1e3:.3f} ({m})' for t, m in zip(res.run_stats.level_seconds, modes)]}; "
        f"comm_bytes {st['comm_bytes']}; sieve_hits {st['sieve_hits']}; "
        f"overflowed {st['overflowed']}; mode_counts {st['mode_counts']}")


def single_source_roots(kernels, label: str, eng, mode: str, roots, want,
                        deg, n_edges: int, profile: bool) -> None:
    """One S = 1 engine over the first 8 roots (the first three times):
    each root's distances bitwise ``want``'s column, ``auto``'s
    ``mode_counts`` equal to the numpy replay, ``queue`` a queue level a
    level."""
    from repro_torch.core.frontier import INF

    totals = dict.fromkeys(("dense", "queue", "bottom_up"), 0)
    for i, root in enumerate(roots[:8]):
        if i == 0:
            host, run_ms, res, _ = drive(kernels, eng, [root])
        else:
            t0 = time.perf_counter()
            res = eng.run([root])
            run_ms = [(time.perf_counter() - t0) * 1e3]
            host = res.dist_host
        st = res.run_stats.to_host()
        check(np.array_equal(host, want[:, i:i + 1]),
              f"{label}: root {i}'s distances differ from path 1's column "
              f"{i}")
        levels, modes = replay_modes(host, deg, n_edges, 1, INF)
        if mode == "auto":
            check(levels == st["levels"]
                  and mode_counts(modes) == st["mode_counts"],
                  f"{label}: root {i}'s mode_counts {st['mode_counts']}, "
                  f"the replay {mode_counts(modes)}")
        else:
            modes = ["queue"] * st["levels"]
            check(st["levels"] == levels
                  and st["mode_counts"]["queue"] == levels,
                  f"{label}: root {i} ran {st}")
        for k in totals:
            totals[k] += st["mode_counts"][k]
        report_modes(f"{label} root {i}", run_ms, st, modes, res)
        if profile and i == 0:
            profile_run(f"{label} root 0", lambda: eng.run([root]))
    log(f"{label}: 8 roots bitwise path 1's columns; mode totals {totals}; "
        f"peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")


def path4_phase(kernels, g, src, roots, want, profile: bool) -> None:
    """``rmat_1m`` on the queue and ``auto`` modes (module docstring, phase
    5): (a) auto, S = 64; (b) auto and (c) queue, S = 1, on the first 8
    roots; distances bitwise path 1's p4_default columns."""
    from repro_torch.core import BFSOptions
    from repro_torch.core.frontier import INF

    deg = np.bincount(src, minlength=g.part.n_logical)
    others = [k for k in kernels if k != "fold_update"]

    # (a) auto, S = 64: dense and bottom-up levels only
    pl, eng, d = build_engine("path 4 (a) auto S=64", g,
                              BFSOptions(mode="auto"), S)
    check(d["wire_formats"]["bottom_up"] == "packed" and d["use_fused_tail"],
          "path 4 (a): the plan does not resolve a packed bottom-up wire "
          "and the fused tail")
    host, run_ms, res, counts = drive(kernels, eng, roots)
    st = res.run_stats.to_host()
    check(np.array_equal(host, want),
          "path 4 (a): distances differ from path 1's p4_default")
    levels, modes = replay_modes(host, deg, g.n_edges, S, INF)
    check(levels == st["levels"] and mode_counts(modes) == st["mode_counts"],
          f"path 4 (a): mode_counts {st['mode_counts']} over {st['levels']} "
          f"levels, the replay {mode_counts(modes)} over {levels}")
    check(counts["fold_update"] == 3 * st["mode_counts"]["dense"],
          f"path 4 (a): A1 launched {counts['fold_update']} times in 3 runs "
          f"of {st['mode_counts']['dense']} dense levels")
    check(not any(counts[k] for k in others),
          f"path 4 (a): a kernel off the path launched: {counts}")
    report_modes("path 4 (a) auto S=64", run_ms, st, modes, res)
    roofline_line("path 4 (a) auto S=64", d, res.run_stats, modes)
    log(f"path 4 (a): launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run("path 4 (a) auto S=64", lambda: eng.run(roots))
    del eng, res

    # (b) auto and (c) queue, S = 1: the first root three times, the next
    # seven once each
    for label, mode in (("(b) auto S=1", "auto"), ("(c) queue S=1", "queue")):
        pl, eng, d = build_engine(f"path 4 {label}", g,
                                  BFSOptions(mode=mode), 1)
        check(d["sieve"], f"path 4 {label}: the sieve is off")
        single_source_roots(kernels, f"path 4 {label}", eng, mode, roots,
                            want, deg, g.n_edges, profile)
        del eng
    torch.cuda.empty_cache()


def path5_phase(kernels, g, src, roots, want, profile: bool) -> int:
    """``rmat_1m`` on the 2-D partition, a 2 x 2 ``LocalMesh`` grid with
    default options (module docstring, phase 6): (a) dense, S = 64; (b)
    auto, S = 64; (c) auto and (d) queue, S = 1, on the first 8 roots;
    distances bitwise path 1's p4_default (columns).  Returns A1's
    launches in (a) and (a)'s last run stats."""
    from repro_torch.core import BFSOptions, LocalMesh
    from repro_torch.core.frontier import INF
    from repro_torch.graphs import to_2d

    t0 = time.perf_counter()
    g2 = to_2d(g, 2, 2)
    to2d_s = time.perf_counter() - t0
    per_cell = (g2.dst_fold >= 0).sum(1).tolist()
    log(f"path 5: to_2d(2, 2) in {to2d_s:.3f} s (host); e_cap "
        f"{g2.e_cap}, edges per cell {per_cell} (mean "
        f"{g2.n_edges / 4:.0f})")
    mesh = LocalMesh.grid(2, 2, torch.device("cuda", 0))
    deg = np.bincount(src, minlength=g.part.n_logical)
    others = [k for k in kernels if k != "fold_update"]

    # (a) dense, S = 64: packed expand and fold, A1 on the fused fold tail
    label = "path 5 (a) dense S=64"
    pl, eng, d = build_engine(label, g2, BFSOptions(), S, mesh=mesh)
    check(d["grid"] == (2, 2) and d["wire_formats"]["expand"] == "packed"
          and d["wire_formats"]["fold"] == "packed" and d["use_fused_tail"],
          f"{label}: the plan does not resolve packed expand and fold "
          f"wires and the fused tail: {d['wire_formats']}")
    host, run_ms, res, counts = drive(kernels, eng, roots)
    st = res.run_stats.to_host()
    check(np.array_equal(host, want),
          f"{label}: distances differ from path 1's p4_default")
    levels = st["levels"]
    check(st["mode_counts"] == {"dense": levels, "queue": 0,
                                "bottom_up": 0},
          f"{label}: mode_counts {st['mode_counts']}")
    check(counts["fold_update"] == 3 * levels,
          f"{label}: A1 launched {counts['fold_update']} times in 3 runs of "
          f"{levels} levels")
    check(not any(counts[k] for k in others),
          f"{label}: a kernel off the path launched: {counts}")
    want_bytes = np.float32(0)
    for _ in range(levels):
        want_bytes = np.float32(want_bytes
                                + np.float32(d["dense_level_bytes"]))
    check(st["comm_bytes"] == float(want_bytes),
          f"{label}: comm_bytes {st['comm_bytes']}, not {levels} x "
          f"{d['dense_level_bytes']} as float32")
    report_modes(label, run_ms, st, ["dense"] * levels, res)
    roofline_line(label, d, res.run_stats, ["dense"] * levels)
    log(f"{label}: launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run(label, lambda: eng.run(roots))
    a1_launches, stats_a = counts["fold_update"], res.run_stats
    del eng, res

    # (b) auto, S = 64: the bottom-up blocks are built here, on first use
    t0 = time.perf_counter()
    g2.bottom_up_blocks()
    log(f"path 5: bottom_up_blocks in {time.perf_counter() - t0:.3f} s "
        f"(host); in_e_cap {g2.in_e_cap}")
    label = "path 5 (b) auto S=64"
    pl, eng, d = build_engine(label, g2, BFSOptions(mode="auto"), S,
                              mesh=mesh)
    host, run_ms, res, counts = drive(kernels, eng, roots)
    st = res.run_stats.to_host()
    check(np.array_equal(host, want),
          f"{label}: distances differ from path 1's p4_default")
    levels, modes = replay_modes(host, deg, g2.n_edges, S, INF)
    check(levels == st["levels"] and mode_counts(modes) == st["mode_counts"],
          f"{label}: mode_counts {st['mode_counts']} over {st['levels']} "
          f"levels, the replay {mode_counts(modes)} over {levels}")
    check(counts["fold_update"] == 3 * st["mode_counts"]["dense"]
          and not any(counts[k] for k in others),
          f"{label}: launches {counts} in 3 runs of {st['mode_counts']}")
    report_modes(label, run_ms, st, modes, res)
    log(f"{label}: launches {counts}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    if profile:
        profile_run(label, lambda: eng.run(roots))
    del eng, res

    # (c) auto and (d) queue, S = 1, the first 8 roots
    for label, mode in (("(c) auto S=1", "auto"), ("(d) queue S=1", "queue")):
        pl, eng, d = build_engine(f"path 5 {label}", g2,
                                  BFSOptions(mode=mode), 1, mesh=mesh)
        check(d["sieve"], f"path 5 {label}: the sieve is off")
        single_source_roots(kernels, f"path 5 {label}", eng, mode, roots,
                            want, deg, g2.n_edges, profile)
        del eng
    torch.cuda.empty_cache()
    return a1_launches, stats_a


# ---------------------------------------------------------------------------
# path 6: BFS serving over HTTP
# ---------------------------------------------------------------------------

LADDER = (1, 8, 64)
FANOUTS = (1, 3, 8, 17, 64)
N_REQUESTS, N_CLIENTS, CLIENT_TIMEOUT_S = 48, 8, 60.0


def http_call(url: str, path: str, body=None) -> bytes:
    """One stdlib HTTP call with the client timeout; returns the body."""
    import urllib.request

    data = json.dumps(body).encode() if body is not None else None
    req = urllib.request.Request(
        url + path, data=data, method="GET" if body is None else "POST",
        headers={"Content-Type": "application/json"} if data else {})
    with urllib.request.urlopen(req, timeout=CLIENT_TIMEOUT_S) as rsp:
        return rsp.read()


def depth_rows(want: np.ndarray, roots) -> dict:
    """Each root's row of depths as the server writes it inside a
    response (``schema.json_int_rows``: fixed-width numbers), keyed by
    root: a response's depths are checked by comparing bytes, not by
    parsing a million ints a source."""
    from repro_torch.serve.frontend.schema import json_int_rows

    n = want.shape[0]
    text = memoryview(json_int_rows(np.ascontiguousarray(want.T)))
    width = len(text[1:]) // len(roots)
    check(width * len(roots) + 1 == len(text) and width % n == 0,
          "path 6: the depth rows are not fixed-width")
    return {int(r): bytes(text[1 + i * width: (i + 1) * width])
            for i, r in enumerate(roots)}


def read_traverse(body: bytes, sources, rows: dict, n: int) -> dict:
    """A ``/v1/traverse`` response whose depths must equal ``rows``'
    (bytes, each row but its closing byte, then the closings); returns
    its other fields (json), with the parents parsed by numpy."""
    tag = b'"depths": '
    start = body.index(tag) + len(tag)
    width = len(rows[sources[0]]) + 1
    end = start + 1 + len(sources) * width
    view = memoryview(body)
    check(view[start] == ord("[") and bytes(view[end - 2:end]) == b"]]"
          and body.startswith(b', "stats": ', end),
          "path 6: a response's depths are not the expected layout")
    for q, s in enumerate(sources):
        a = start + 1 + q * width
        check(view[a:a + width - 1] == rows[s]
              and view[a + width - 1] in b",]",
              f"path 6: the depths of source {s} differ from the path's")
    parents = None
    tag = b', "parents": '
    k = body.find(tag, end)
    if k >= 0:
        text = body[k + len(tag):-1]
        parents = np.fromstring(text.translate(None, b"[]"), dtype=np.int64,
                                sep=",")
        check(parents.size == len(sources) * n,
              f"path 6: {parents.size} parents for {len(sources)} x {n}")
        tail = body[end:k] + b"}"
    else:
        tail = body[end:]
    out = json.loads(body[:start] + b"null" + tail)
    out["parents"] = (None if parents is None
                      else parents.reshape(len(sources), n))
    return out


def check_parents(depths, parents, sources, unreached) -> None:
    """The JAX client's rule (``bfs_client._verify_depths``): each root
    is its own parent, an unreached vertex has -1, and every other
    reached vertex's parent is one level up."""
    for d, par, s in zip(depths, parents, sources):
        reached = d < unreached
        inner = reached & (d > 0)
        ok = (par[s] == s and np.all(par[reached] >= 0)
              and np.all(par[~reached] == -1)
              and np.all(d[par[inner]] == d[inner] - 1))
        check(bool(ok), f"path 6: the parents of source {s} break the rule")


def run_clients(url, requests, want, roots):
    """The requests from ``N_CLIENTS`` threads, each response checked:
    depths by bytes against the paths' distances (each lane's smallest
    response also parsed whole by json), parents by the JAX client's rule.
    Returns ``(results, errors)``: a request's client seconds, stats and
    bucket."""
    lanes = list(want)
    col = {name: {int(r): j for j, r in enumerate(roots[name])}
           for name in lanes}
    rows, by_array = {}, {}
    for name in lanes:                  # rmat's rows serve its 3 lanes
        if id(want[name]) not in by_array:
            by_array[id(want[name])] = depth_rows(want[name], roots[name])
        rows[name] = by_array[id(want[name])]
    smallest = {name: min((i for i, q in enumerate(requests)
                           if q[0] == name),
                          key=lambda i: len(requests[i][1]))
                for name in lanes}
    results, errors = [None] * len(requests), []

    def client(c):
        for i in range(c, len(requests), N_CLIENTS):
            name, srcs, parents = requests[i]
            n = want[name].shape[0]
            t0 = time.perf_counter()
            try:
                body = http_call(url, "/v1/traverse", {
                    "graph": name, "sources": srcs,
                    "include_parents": parents})
                dt = time.perf_counter() - t0
                out = read_traverse(body, srcs, rows[name], n)
                cols = [col[name][s] for s in srcs]
                if i == smallest[name]:
                    whole = json.loads(body)
                    check(np.array_equal(np.asarray(whole["depths"]),
                                         want[name][:, cols].T),
                          f"path 6: request {i}'s json depths differ")
                if parents:
                    check_parents(want[name][:, cols].T, out["parents"],
                                  srcs, out["unreached"])
                results[i] = (dt, out["stats"], out["bucket"])
            except Exception as exc:          # reported by the caller
                errors.append(f"request {i}: {type(exc).__name__}: {exc}")

    return client, results, errors


def client_process(conn, url, requests, want, roots) -> None:
    """The body of path 6's client process: build the expected rows, say
    "ready", wait for "go", send the 48 requests from ``N_CLIENTS``
    threads, send back ``(results, errors)``."""
    import threading

    sys.path.insert(0, str(ROOT / "src"))
    try:
        client, results, errors = run_clients(url, requests, want, roots)
        conn.send("ready")
        conn.recv()
        threads = [threading.Thread(target=client, args=(c,))
                   for c in range(N_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        conn.send((results, errors))
    except Exception as exc:
        conn.send(([], [f"client process: {type(exc).__name__}: {exc}"]))


def rung_memory(label, cache, plan_, roots, want):
    """Compile one rung through ``cache`` and run it once at full S,
    reading the device memory it takes: the ``max_memory_allocated``
    rise over both, against ``estimated_device_bytes``, and what stays
    allocated after."""
    reset_peak()
    m0 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    eng = cache.get_or_compile(plan_)
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    s = plan_.num_sources
    res = eng.run(roots[:s])
    check(np.array_equal(res.dist_host, want[:, :s]),
          f"{label}: distances differ from the path's own")
    del res
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - m0
    kept = torch.cuda.memory_allocated() - m0
    est = plan_.estimated_device_bytes()
    terms = plan_.device_byte_terms()
    t0 = time.perf_counter()
    eng.run(roots[:s]).dist_host
    run_ms = (time.perf_counter() - t0) * 1e3
    log(f"{label}: compile {compile_ms:.1f} ms; a second run {run_ms:.3f} "
        f"ms; device bytes: estimate {est} ({terms}), measured peak rise "
        f"{rise} (estimate / measured {est / max(rise, 1):.3f}), kept {kept}")
    check(est >= rise, f"{label}: estimated_device_bytes {est} is below the "
                       f"measured rise {rise}")
    return {"compile_ms": compile_ms, "run_ms": run_ms, "estimate": est,
            "measured": rise, "kept": kept, "work": terms["work"]}


def serving_phase(kernels, g1, want1, roots1, g2, want2, roots2, dev,
                  card: str) -> dict:
    """``BFSService`` behind ``serve_http`` (module docstring, phase 7):
    four lanes, 48 requests from 8 client threads, the cache's counters,
    the shared blocks, the memory estimate, a byte budget's eviction and
    a split arm under an injected compile fault.  Returns A1's and
    ``bsr_expand_bits``' launches in the traffic."""
    import gc
    import threading

    from repro_torch.core import BFSOptions, LocalMesh
    from repro_torch.core.frontier import INF
    from repro_torch.graphs import device_block_cache, to_2d
    from repro_torch.serve.bfs_service import BFSService, TraversalRequest
    from repro_torch.serve.engine_cache import EngineCache, GraphCatalog
    from repro_torch.serve.frontend import serve_http
    from repro_torch.serve.resilience import faults
    from repro_torch.serve.resilience.faults import FaultPlan, FaultSpec

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    catalog = GraphCatalog()
    catalog.register("rmat", g1)
    catalog.register("rmat_alias", g1)
    catalog.register("sw", g2)
    g1_2d = catalog.get_2d("rmat", 2, 2)
    check(g1_2d is to_2d(g1, 2, 2) and "_graph2d" in g1.__dict__,
          "path 6: the catalog's 2 x 2 view is not path 5's cached to_2d")
    cache = EngineCache()
    svc = BFSService(opts=BFSOptions(), batch_buckets=LADDER, cache=cache,
                     catalog=catalog, device=dev)
    svc.add_graph("rmat")
    svc.add_graph("rmat2d", g1_2d, mesh=LocalMesh.grid(2, 2, dev))
    svc.add_graph("sw", opts=BFSOptions(use_kernel=True,
                                        wire_format="packed"))
    svc.add_graph("rmat_alias")
    lanes = svc.graph_names()
    want = {"rmat": want1, "rmat2d": want1, "rmat_alias": want1,
            "sw": want2}
    roots = {"rmat": roots1, "rmat2d": roots1, "rmat_alias": roots1,
             "sw": roots2}
    keys = {name: [pl.plan_key() for pl in svc.lane(name).plans.values()]
            for name in lanes}
    check(keys["rmat_alias"] == keys["rmat"],
          "path 6: rmat_alias's plans key apart from rmat's")
    distinct = {k for ks in keys.values() for k in ks}
    check(len(distinct) == 9, f"path 6: {len(distinct)} distinct plan keys")
    for name in lanes:
        d = svc.lane(name).plan.describe()
        log(f"path 6 lane {name}: p={d['p']} partition={d['partition']} "
            f"wires {d['wire_formats']} fused={d['use_fused_tail']} "
            f"use_kernel={d['use_kernel']} ladder {svc.lane(name).ladder}")

    # every rung compiled through the cache and run once at full S, with
    # its device memory read; a graph's rungs share one upload a group
    rungs = {}
    for name in ("rmat", "rmat2d", "sw"):
        lane = svc.lane(name)
        owner = lane.plan.graph2d if name == "rmat2d" else lane.graph
        blocks = device_block_cache(owner)
        groups = None
        for s in LADDER:
            label = f"path 6 {name} S={s}"
            rungs[label] = row = rung_memory(label, cache, lane.plans[s],
                                             roots[name], want[name])
            held = dict(blocks.map.items())
            if groups is not None:
                check(held == groups, f"{label}: the block map changed: "
                      f"{sorted(k[2] for k in groups)} -> "
                      f"{sorted(k[2] for k in held)}")
                # dist and frontier: each block may round up to 2 MiB
                check(row["kept"] <= 1.05 * row["work"] + 2 * 2**21,
                      f"{label}: memory grew by {row['kept']} bytes, past "
                      f"its working buffers {row['work']} plus 5% and "
                      "the allocator's rounding")
            groups = held
        log(f"path 6 {name}: block groups {sorted(k[2] for k in groups)}, "
            "one upload each across the rungs")
    st = cache.stats()
    check(st["misses"] == 9 and st["entries"] == 9,
          f"path 6: {st['misses']} compiles for 9 plan keys")

    # the traffic: 48 requests from 8 client threads over HTTP
    spec = {"rmat": {"kind": "rmat", "n": g1.part.n_logical, "seed": SEED},
            "sw": {"kind": "small_world", "n": g2.part.n_logical,
                   "seed": SEED}}
    httpd, fe = serve_http(svc, "127.0.0.1", 0, max_queue_depth=64,
                           max_inflight_mb=65536.0, graph_specs=spec,
                           log=lambda *a: None)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    rng = np.random.default_rng(SEED)
    with_parents = set(rng.choice(N_REQUESTS, N_REQUESTS // 4,
                                  replace=False).tolist())
    requests = []
    for i in range(N_REQUESTS):
        name = lanes[i % len(lanes)]
        k = int(rng.choice(FANOUTS))
        srcs = rng.choice(roots[name], k, replace=False).tolist()
        requests.append((name, srcs, i in with_parents))
    # the clients run in a process of their own, so that their reading
    # and checking of the responses does not hold the server's GIL
    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=client_process, daemon=True,
                       args=(child, url, requests, want, roots))
    proc.start()
    def receive(what):
        while not conn.poll(1.0):
            check(proc.is_alive(), f"path 6: the client process died {what}")
        return conn.recv()

    try:
        check(receive("starting") == "ready",
              "path 6: the client process did not start")
        reset_counts(kernels)
        t0 = time.perf_counter()
        conn.send("go")
        results, errors = receive("sending")
        wall = time.perf_counter() - t0
    finally:
        proc.join(timeout=60)
        if proc.is_alive():
            proc.terminate()
            proc.join()
    counts = {name: k.launches for name, k in kernels.items()}
    check(not errors, f"path 6: {len(errors)} requests failed: {errors[:3]}")
    levels = sum(r[1]["levels"] for r in results)
    sw_levels = sum(r[1]["levels"] for r, q in zip(results, requests)
                    if q[0] == "sw")
    check(counts["fold_update"] == levels,
          f"path 6: A1 launched {counts['fold_update']} times in "
          f"{levels} levels of the 48 runs")
    check(counts["bsr_expand_bits"] == sw_levels,
          f"path 6: bsr_expand_bits launched {counts['bsr_expand_bits']} "
          f"times in {sw_levels} levels of the sw runs")
    check(not any(v for k, v in counts.items()
                  if k not in ("fold_update", "bsr_expand_bits")),
          f"path 6: a kernel off the path launched: {counts}")
    metrics = json.loads(http_call(url, "/metrics"))
    st = metrics["engine_cache"]
    check(st["misses"] == 9 and st["evictions"] == 0,
          f"path 6: the traffic compiled or evicted: {st}")
    # the engines' own time for the 48 requests, each at its rung's
    # solo run time: what the card was busy with at most
    engine_s = sum(rungs[f"path 6 {'rmat' if q[0] == 'rmat_alias' else q[0]}"
                         f" S={r[2]}"]["run_ms"] for r, q in
                   zip(results, requests)) / 1e3
    log(f"path 6: {card}; 48 requests from {N_CLIENTS} clients in "
        f"{wall:.3f} s ({N_REQUESTS / wall:.3f} requests/s); the runs "
        f"alone take {engine_s:.3f} s (card busy at most "
        f"{engine_s / wall:.3f} of the traffic); launches {counts}; cache "
        f"{st}")
    per_lane = {}
    for name in lanes:
        m = metrics["lanes"][name]
        dts = sorted(r[0] for r, q in zip(results, requests)
                     if q[0] == name)
        per_lane[name] = {
            "requests": m["completed"], "buckets": m["buckets"],
            "e2e_p50_ms": m["e2e"]["p50_ms"], "e2e_p99_ms": m["e2e"]["p99_ms"],
            "queue_wait_s": m["queue_wait"]["sum_ms"] / 1e3,
            "device_s": m["device"]["sum_ms"] / 1e3,
            "client_p50_s": dts[len(dts) // 2], "client_max_s": dts[-1]}
        log(f"path 6 lane {name}: {per_lane[name]}")

    col = {name: {int(r): j for j, r in enumerate(roots[name])}
           for name in lanes}
    # the overlap of one round: a request a lane through BFSService.step
    # against the same requests one lane at a time
    alone = 0.0
    for name in ("rmat", "rmat2d", "sw"):
        t0 = time.perf_counter()
        svc.traverse(name, [int(roots[name][0])])
        alone += time.perf_counter() - t0
    for i, name in enumerate(("rmat", "rmat2d", "sw")):
        svc.submit(TraversalRequest(rid=i, source=int(roots[name][0]),
                                    graph=name))
    t0 = time.perf_counter()
    done = svc.step()
    step_s = time.perf_counter() - t0
    check(len(done) == 3 and all(np.array_equal(
        r.dist, want[r.graph][:, col[r.graph][r.source]]) for r in done),
        "path 6: a step's results differ from the path's distances")
    log(f"path 6: one step of a request a lane {step_s:.4f} s, the lanes "
        f"one at a time {alone:.4f} s (overlap {1 - step_s / alone:.3f})")

    http_call(url, "/admin/shutdown", {})
    server.join(timeout=60.0)
    check(not server.is_alive() and fe.draining,
          "path 6: the server did not drain and stop")
    httpd.server_close()

    # a byte budget between two and three rmat rungs: the LRU rung goes
    ests = [svc.lane("rmat").plans[s].estimated_device_bytes()
            for s in LADDER]
    budget = (sum(ests) + ests[1] + ests[2]) // 2
    cache2 = EngineCache(max_device_bytes=budget)
    svc2 = BFSService(opts=BFSOptions(), batch_buckets=LADDER, cache=cache2,
                      catalog=catalog, device=dev)
    svc2.add_graph("rmat")
    for s in LADDER[:2]:
        res, _ = svc2.traverse("rmat", roots1[:s])
        check(np.array_equal(res.dist_host, want1[:, :s]),
              f"path 6 budget: S={s} differs")
        del res
    torch.cuda.synchronize()
    m_before = torch.cuda.memory_allocated()
    res, _ = svc2.traverse("rmat", roots1[:S])
    check(np.array_equal(res.dist_host, want1), "path 6 budget: S=64 differs")
    del res
    torch.cuda.synchronize()
    m_after = torch.cuda.memory_allocated()
    plans2 = svc2.lane("rmat").plans
    work = {s: plans2[s].device_byte_terms()["work"] for s in LADDER}
    freed = m_before + work[S] - m_after
    st2 = cache2.stats()
    check(st2["evictions"] == 1 and plans2[1] not in cache2
          and plans2[8] in cache2 and plans2[64] in cache2,
          f"path 6 budget: not the LRU rung evicted: {st2}")
    check(freed >= work[1], f"path 6 budget: the eviction freed {freed} "
                            f"bytes, below the rung's {work[1]}")
    res, _ = svc2.traverse("rmat", roots1[:1])
    check(np.array_equal(res.dist_host, want1[:, :1])
          and cache2.stats()["misses"] == 4,
          "path 6 budget: the evicted rung did not recompile bitwise")
    del res
    log(f"path 6 budget: {budget} bytes; the S=1 rung evicted for S=64, "
        f"{freed} bytes freed (its work {work[1]}), recompiled bitwise; "
        f"cache {cache2.stats()}")
    del svc2, cache2

    # a compile fault on rmat's S=64 rung: 40 sources on the split:8 arm,
    # five runs of one engine, each read back before the next
    svc3 = BFSService(opts=BFSOptions(), batch_buckets=LADDER,
                      cache=EngineCache(), catalog=catalog, device=dev)
    svc3.add_graph("rmat")
    tag = faults.plan_tag(svc3.lane("rmat").plans[S])
    httpd, fe = serve_http(svc3, "127.0.0.1", 0, max_inflight_mb=65536.0,
                           log=lambda *a: None)
    server = threading.Thread(target=httpd.serve_forever, daemon=True)
    server.start()
    url = f"http://127.0.0.1:{httpd.server_address[1]}"
    srcs = roots1[:40].tolist()
    reset_counts(kernels)
    with faults.active(FaultPlan([FaultSpec(site="cache.compile",
                                            match=tag)])):
        out = read_traverse(http_call(url, "/v1/traverse",
                                      {"graph": "rmat", "sources": srcs}),
                            srcs, depth_rows(want1, roots1), want1.shape[0])
    lane_m = json.loads(http_call(url, "/metrics"))["lanes"]["rmat"]
    check(lane_m["degraded"] == {"split:8": 1} and out["bucket"] == 8,
          f"path 6 degraded: /metrics shows {lane_m['degraded']}, bucket "
          f"{out['bucket']}")
    check(kernels["fold_update"].launches == out["stats"]["mode_counts"][
        "dense"], "path 6 degraded: A1 not once a level of the five runs")
    log(f"path 6 degraded: {tag!r} failing, 40 sources served on "
        f"{lane_m['degraded']} (retries {lane_m['retries']}), bitwise path "
        f"1's; cache {svc3.cache.stats()}")
    http_call(url, "/admin/shutdown", {})
    server.join(timeout=60.0)
    check(not server.is_alive(), "path 6 degraded: the server did not stop")
    httpd.server_close()
    wall6 = time.perf_counter() - t_phase
    log(f"path 6: wall {wall6:.1f} s; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return {"fold_update": counts["fold_update"],
            "bsr_expand_bits": counts["bsr_expand_bits"], "rungs": rungs,
            "lanes": per_lane, "requests_per_s": N_REQUESTS / wall,
            "engine_s": engine_s,
            "wall_s": wall6}



# ---------------------------------------------------------------------------
# path 7: the launchers, called in process
# ---------------------------------------------------------------------------

class _Tee:
    """Standard output that is printed and kept (a launcher's lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s: str) -> int:
        self.out.write(s)
        self.lines.append(s)
        return len(s)

    def flush(self) -> None:
        self.out.flush()

    def text(self) -> str:
        return "".join(self.lines)


def run_launcher(label: str, main, argv, **kw):
    """``main(argv)`` with its standard output printed and kept; returns
    (exit code, output, wall seconds)."""
    log(f"{label}: {' '.join(argv)}")
    tee = _Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        rc = main(argv, **kw)
    wall = time.perf_counter() - t0
    log(f"{label}: exit {rc}, wall {wall:.1f} s")
    check(rc == 0, f"{label}: exit {rc}")
    return rc, tee.text(), wall


_RUN_LINE = (r"^run\[(\d+)\] sources=.*?: levels=(\d+) visited=(\d+) "
             r"modes=(\{.*?\}) comm_bytes/chip=(\S+) wall=(\S+)s")


def run_lines(text: str) -> list:
    """The ``run[i]`` lines of ``bfs_run``: (levels, visited, modes,
    comm_bytes/chip) each, as printed."""
    return [m.groups()[1:5] for m in (re.match(_RUN_LINE, line)
                                      for line in text.splitlines()) if m]


def engine_line(res) -> tuple:
    """A result's fields as ``bfs_run`` prints them on its run line."""
    st = res.stats()
    return (str(st.levels), str(st.visited), str(st.mode_counts),
            f"{st.comm_bytes:.2e}")


def trace_device_ms(logdir: str) -> float:
    """Device time of a captured trace, read straight from the file: the
    kernels, copies and sets, each once."""
    from repro_torch.analysis import trace_model

    with open(trace_model.find_trace_file(logdir)) as f:
        events = json.load(f)["traceEvents"]
    return sum(float(e.get("dur", 0)) for e in events
               if e.get("ph") == "X"
               and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")) / 1e3


def launchers_phase(kernels, g1, src1, dst1, dev, tmp: Path) -> dict:
    """The launchers' ``main(argv)`` in process (module docstring, path
    7): (a) ``bfs_run`` dense at p = 4 with ``--profile``, (b) ``bfs_run``
    on the 2 x 2 grid in auto, (c) ``bfs_serve --http`` on three lanes
    with the port's ``bfs_client --verify``, (d) ``bfs_chaos``.  Returns
    A1's launches in each."""
    import gc
    import threading

    from repro_torch.analysis import trace_model
    from repro_torch.core import BFSOptions, LocalMesh, plan
    from repro_torch.core.frontier import INF
    from repro_torch.core.ref import validate_bfs
    from repro_torch.graphs import to_2d
    from repro_torch.launch import bfs_chaos, bfs_run, bfs_serve
    from repro_torch.serve.engine_cache import default_engine_cache

    t_phase = time.perf_counter()
    n1 = g1.part.n_logical
    sources = list(range(S))
    others = [k for k in kernels if k != "fold_update"]
    a1 = {}

    def release():
        default_engine_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the 1-D dense launcher against path 1's p = 4 engine on the
    # launcher's run 0 sources, 0..63
    eng = plan(g1, BFSOptions(), num_sources=S).compile()
    ref = engine_line(eng.run(sources))
    del eng
    release()
    run0 = []

    def hold_run0(rep, srcs, res):
        # the host copy the run line's stats read; checked after the
        # launcher returns, so no check's device work enters the profile
        if rep == 0:
            run0.append((srcs, res.dist_host))

    prof = tmp / "profile_a"
    reset_counts(kernels)
    _, out, wall_a = run_launcher(
        "path 7 (a) bfs_run", bfs_run.main,
        ["--workload", "rmat_1m", "--devices", "4", "--mode", "dense",
         "--sources", str(S), "--repeats", "2", "--profile", str(prof)],
        on_run=hold_run0)
    counts = {name: k.launches for name, k in kernels.items()}
    runs = run_lines(out)
    check(len(runs) == 2 and len(run0) == 1 and run0[0][0] == sources,
          f"path 7 (a): {len(runs)} run lines, run 0 {run0[:1]}")
    validate_bfs(src1, dst1, np.asarray(sources),
                 torch.from_numpy(run0[0][1]).to(dev))
    scipy_check(src1, dst1, n1, np.asarray(sources), run0[0][1], INF)
    del run0
    check(runs[0] == ref, f"path 7 (a): run 0 {runs[0]}, path 1's p = 4 "
          f"engine on sources 0..63 {ref}")
    levels = sum(int(r[0]) for r in runs)
    check(counts["fold_update"] == levels
          and not any(counts[k] for k in others),
          f"path 7 (a): launches {counts}, not A1 once a level of "
          f"{levels}")
    a1["a"] = counts["fold_update"]
    t = trace_model.parse_trace(str(prof), n_levels=levels)
    rows = sum(line.startswith("  level[") for line in out.splitlines())
    dev_ms = trace_device_ms(str(prof))
    phase_ms = {ph: s * 1e3 for ph, s in t.total_s.items()}
    # the device time the join placed at a launch, against the file's
    placed = sum(phase_ms.values()) - t.unanchored_s * 1e3
    level_ms = sum(sum(lv.values()) for lv in t.levels) * 1e3
    level_other = sum(lv["other"] for lv in t.levels) * 1e3
    log(f"path 7 (a): trace {t.n_ops} device events, phases "
        f"{ {ph: round(v, 3) for ph, v in phase_ms.items()} } ms; "
        f"{placed:.3f} ms placed at a launch of {dev_ms:.3f} ms of device "
        f"time in the file ({t.unanchored} events, "
        f"{t.unanchored_s * 1e3:.3f} ms, with no launch found); "
        f"{level_ms:.3f} ms inside the levels, {level_other:.3f} ms of it "
        f"other; {len(t.levels)} level segments, {rows} level rows, "
        f"{levels} levels")
    check(len(t.levels) == levels and rows == levels,
          f"path 7 (a): {len(t.levels)} segments and {rows} rows for "
          f"{levels} levels")
    check(dev_ms > 0 and dev_ms - placed <= 0.01 * dev_ms,
          f"path 7 (a): {placed:.3f} ms of {dev_ms:.3f} ms of device time "
          "placed at a launch")
    check(level_other < 0.02 * level_ms,
          f"path 7 (a): other is {level_other:.3f} ms of the "
          f"{level_ms:.3f} ms inside the levels")
    check(max(phase_ms, key=phase_ms.get) == "expand",
          f"path 7 (a): expand is not the largest phase: {phase_ms}")
    release()

    # (b) the 2-D launcher against path 5 (b)'s engine on 0..63
    g2 = to_2d(g1, 2, 2)
    eng = plan(g2, BFSOptions(mode="auto"), num_sources=S,
               mesh=LocalMesh.grid(2, 2, dev)).compile()
    ref = engine_line(eng.run(sources))
    del eng
    release()
    reset_counts(kernels)
    _, out, wall_b = run_launcher(
        "path 7 (b) bfs_run", bfs_run.main,
        ["--workload", "rmat_1m", "--devices", "4", "--partition", "2d",
         "--grid", "2x2", "--mode", "auto", "--sources", str(S),
         "--repeats", "1"])
    runs = run_lines(out)
    check(len(runs) == 1 and runs[0][:3] == ref[:3],
          f"path 7 (b): run 0 {runs}, path 5 (b)'s engine {ref}")
    a1["b"] = kernels["fold_update"].launches
    release()

    # (c) bfs_serve --http on three lanes, the port's client verifying
    log(f"path 7 (c): device memory in use at the start "
        f"{torch.cuda.memory_allocated() / 2**30:.3f} GiB")
    port_file = tmp / "port"
    reset_counts(kernels)
    served = []
    argv = ["--devices", "4", "--graph", "rmat=rmat:1048576", "--graph",
            "rmat2d=rmat:1048576:2x2", "--graph", "sw=small_world:100000",
            "--http", "127.0.0.1:0", "--buckets", "1,8,64",
            "--watchdog-secs", "5", "--port-file", str(port_file)]
    log(f"path 7 (c) bfs_serve: {' '.join(argv)}")
    t0 = time.perf_counter()
    server = threading.Thread(target=lambda: served.append(
        bfs_serve.main(argv)), daemon=True)
    server.start()
    while not (port_file.exists() and port_file.read_text()):
        check(server.is_alive(), "path 7 (c): the server exited early")
        check(time.perf_counter() - t0 < 120, "path 7 (c): no port")
        time.sleep(0.2)
    url = f"http://127.0.0.1:{int(port_file.read_text())}"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}

    def client(lane, *extra):
        return subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.bfs_client", "--url",
             url, "--graph", lane, "--requests", "12", "--max-retries", "2",
             "--verify", *extra], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)

    outs = {}
    for group in (("rmat", "rmat2d"), ("sw",)):
        procs = {lane: client(lane, *(("--shutdown",) if lane == "sw"
                                      else ())) for lane in group}
        for lane, proc in procs.items():
            text, _ = proc.communicate(timeout=300)
            outs[lane] = text
            log(f"path 7 (c) bfs_client --graph {lane}: exit "
                f"{proc.returncode}\n{text.strip()}")
            check(proc.returncode == 0 and "match the numpy reference "
                  "bitwise" in text, f"path 7 (c): the {lane} client failed")
    server.join(timeout=120)
    wall_c = time.perf_counter() - t0
    check(not server.is_alive() and served == [0],
          f"path 7 (c): the server did not drain and stop ({served})")
    a1["c"] = kernels["fold_update"].launches
    check(a1["c"] > 0, "path 7 (c): A1 never launched")
    log(f"path 7 (c): wall {wall_c:.1f} s")
    release()

    # (d) the chaos soak at the size of erdos_renyi_100k
    reset_counts(kernels)
    _, out, wall_d = run_launcher(
        "path 7 (d) bfs_chaos", bfs_chaos.main,
        ["--devices", "4", "--secs", "20", "--n", "100000", "--seed", "0",
         "--out", str(tmp / "chaos.json")])
    ledger = json.loads((tmp / "chaos.json").read_text())
    after = re.search(r"; (\d+) bitwise 200\(s\) requested after the first",
                      out)
    storms = ledger["faults"]["by_kind"].get("storm", 0)
    log(f"path 7 (d): faults {ledger['faults']['by_kind']}, outcomes "
        f"{ledger['outcomes']}, watchdog {ledger['watchdog']}")
    check(ledger["ok"] and storms >= 1 and after and int(after.group(1)) >= 1,
          f"path 7 (d): {storms} storms, 200s after one: "
          f"{after.group(1) if after else None}")
    a1["d"] = kernels["fold_update"].launches
    release()
    log(f"path 7: walls (a) {wall_a:.1f} s, (b) {wall_b:.1f} s, (c) "
        f"{wall_c:.1f} s, (d) {wall_d:.1f} s; A1 launches {a1}; path 7 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return a1


# ---------------------------------------------------------------------------
# path 8: the plan audits
# ---------------------------------------------------------------------------

def roofline_line(label: str, d: dict, stats, modes) -> dict:
    """Each level kind's ``describe()["roofline"]`` ``t_level_s`` beside
    the run's measured mean ms a level of that kind (``level_seconds``,
    the host clock to the level's read) and the share, model over
    measured; logged with the card's name and power limit."""
    rows = {}
    for kind, row in d["roofline"].items():
        ms = [t * 1e3 for t, m in zip(stats.level_seconds, modes)
              if m == kind]
        if ms:
            model = row["t_level_s"] * 1e3
            rows[kind] = {"model_ms": model, "measured_ms": sum(ms) / len(ms),
                          "levels": len(ms),
                          "share": model / (sum(ms) / len(ms)),
                          "bottleneck": row["bottleneck"]}
    log(f"{label} roofline ({card_line()}): " + "; ".join(
        f"{k} t_level_s {v['model_ms']:.6f} ms ({v['bottleneck']}) beside "
        f"{v['measured_ms']:.3f} ms measured a level over {v['levels']}, "
        f"share {v['share']:.6f}" for k, v in rows.items()))
    return rows


def census_rows(text: str, role: str) -> list:
    """``(recv B, model B)`` of the ``role`` rows of a printed census
    table."""
    out = []
    for line in text.splitlines():
        f = line.split()
        if len(f) >= 7 and f[0] == role and f[4].isdigit():
            out.append((float(f[4]), float(f[5])))
    return out


def audit_phase(kernels, g1, src1, dst1, g_sw, host_sw, roots_sw, dev,
                tmp: Path) -> dict:
    """The plan audits on the card (module docstring, path 8): (a)
    ``bfs_audit --all-variants``, (b) ``bfs_run --audit`` on ``rmat_1m``
    and the audit of a ``use_kernel`` engine on ``small_world_100k``.
    Returns the kernels' launches in (b)."""
    import gc

    from repro_torch.analysis import collective_audit
    from repro_torch.core import BFSOptions, plan
    from repro_torch.core.ref import validate_bfs
    from repro_torch.graphs import shard_graph
    from repro_torch.launch import bfs_audit, bfs_run
    from repro_torch.serve.engine_cache import default_engine_cache

    t_phase = time.perf_counter()
    card = card_line()
    lo, hi = collective_audit.DEFAULT_TOLERANCE
    launches = {}

    def release():
        default_engine_cache().clear()
        gc.collect()
        torch.cuda.empty_cache()

    # (a) the gate: every variant of er:4096 at p = 4 on the card
    ledger_path = tmp / "BENCH_audit_torch.json"
    _, out, wall_a = run_launcher(
        "path 8 (a) bfs_audit", bfs_audit.main,
        ["--graph", "er:4096", "--all-variants", "--devices", "4",
         "--census", "--out", str(ledger_path)])
    ledger = json.loads(ledger_path.read_text())["audit"]
    reports = [r for r in ledger["reports"] if r["name"].startswith("census")]
    check(ledger["ok"] and ledger["device"].startswith("cuda")
          and ledger["variants"]["planned"] == 48
          and len(reports) == ledger["variants"]["audited"],
          f"path 8 (a): ledger {ledger['ok']}, variants "
          f"{ledger['variants']}, {len(reports)} reports")
    check(all(r["info"]["host_reads"]["counted_by"] == "sync"
              for r in reports),
          "path 8 (a): the host reads were not counted by sync debug mode")
    per_level, reads = {}, {}
    for r in reports:
        for k, v in r["info"]["collectives"]["per_level"].items():
            per_level.setdefault(k, set()).add(v)
        for k, v in r["info"]["host_reads"]["max_per_level"].items():
            reads[k] = max(reads.get(k, 0), v)
    check(reads and all(reads[k] <= collective_audit.HOST_READ_BUDGET[k]
                        for k in reads),
          f"path 8 (a): host reads a level {reads}")
    check(ledger["byte_ratios"] and per_level
          and all(lo <= a and b <= hi
                  for a, b in ledger["byte_ratios"].values()),
          f"path 8 (a): byte ratios {ledger['byte_ratios']}, collectives a "
          f"level {per_level}")
    log(f"path 8 (a): {ledger['variants']['planned']} variants planned, "
        f"{ledger['variants']['audited']} audited, all clean ({card}); data "
        f"collectives a level by kind "
        f"{ {k: sorted(v) for k, v in per_level.items()} }; synchronizing "
        f"calls a level at most (sync debug mode) {reads}; recorded/modeled "
        f"bytes by role (least, most) {ledger['byte_ratios']}; wall "
        f"{wall_a:.1f} s")

    # (b) bfs_run --audit on rmat_1m at p = 4, dense, S = 64 (not cut),
    # against path 1's p = 4 engine on the audited sources 0..63, and on
    # the two single sources the audit's buffer check runs
    sources = list(range(S))
    eng = plan(g1, BFSOptions(), num_sources=S).compile()
    d = eng.plan.describe()
    res = eng.run(sources)
    want, ref = res.dist_host, engine_line(res)
    check_levels = [eng.run([k]).run_stats.levels for k in (0, 1)]
    del eng, res
    release()
    held = {}

    def hold(rep, srcs, res):
        if rep in ("audit", 0):
            held[rep] = (list(srcs), res.dist_host, res.run_stats.levels)

    reset_counts(kernels)
    _, out, wall_b = run_launcher(
        "path 8 (b) bfs_run --audit", bfs_run.main,
        ["--workload", "rmat_1m", "--devices", "4", "--mode", "dense",
         "--sources", str(S), "--repeats", "2", "--audit"], on_run=hold)
    counts = {name: k.launches for name, k in kernels.items()}
    runs = run_lines(out)
    check(f"[census:1d:dense:auto:S{S}:fused] ok" in out,
          "path 8 (b): the audit did not pass")
    check(held["audit"][0] == sources
          and np.array_equal(held["audit"][1], want),
          "path 8 (b): the audited run's distances differ from path 1's "
          "p = 4 engine on sources 0..63")
    validate_bfs(src1, dst1, np.asarray(sources),
                 torch.from_numpy(held["audit"][1]).to(dev))
    check(len(runs) == 2 and runs[0] == ref,
          f"path 8 (b): run 0 {runs[:1]}, path 1's engine {ref}")
    levels = (held["audit"][2] + sum(check_levels)
              + sum(int(r[0]) for r in runs))
    check(counts["fold_update"] == levels
          and not any(v for k, v in counts.items() if k != "fold_update"),
          f"path 8 (b): launches {counts}, not A1 once a level of {levels}")
    dense = census_rows(out, "dense")
    check(dense and all(m == d["dense_level_bytes"] and lo <= r / m <= hi
                        for r, m in dense),
          f"path 8 (b): dense rows {dense}, model "
          f"{d['dense_level_bytes']}")
    launches["rmat"] = counts["fold_update"]
    log(f"path 8 (b): the audited run bitwise path 1's engine on 0..63 "
        f"({held['audit'][2]} levels), A1 {counts['fold_update']} launches "
        f"= once a level of the audit, its two buffer-check runs "
        f"{check_levels} and the two timed runs; dense received / modeled "
        f"{[r / m for r, m in dense]}; wall {wall_b:.1f} s")
    del held
    release()

    # (b) with use_kernel: small_world_100k at p = 4, bsr_expand_bits and
    # A1 under the audit, from path 2's roots, bitwise path 2's distances
    t0 = time.perf_counter()
    eng = plan(shard_graph(g_sw[0], g_sw[1], g_sw[2], 4),
               BFSOptions(use_kernel=True), num_sources=S).compile()
    check_levels = [eng.run([k]).run_stats.levels for k in (0, 1)]
    got = []
    reset_counts(kernels)
    rep = collective_audit.audit_engine(
        eng, sources=roots_sw, on_result=lambda r: got.append(
            (r.dist_host, r.run_stats.levels)))
    counts = {name: k.launches for name, k in kernels.items()}
    log(f"path 8 (b) use_kernel: {rep.summary()}\n"
        + collective_audit.census_table(rep))
    for v in rep.violations:
        log(f"  {v}")
    check(rep.ok() and rep.info["host_reads"]["counted_by"] == "sync",
          "path 8 (b) use_kernel: the audit failed")
    check(np.array_equal(got[0][0], host_sw),
          "path 8 (b) use_kernel: distances differ from path 2's")
    levels = got[0][1] + sum(check_levels)
    check(counts["bsr_expand_bits"] == levels
          and counts["fold_update"] == levels
          and counts["bsr_spmm"] == counts["bitpack_words"] == 0,
          f"path 8 (b) use_kernel: launches {counts}, not "
          f"bsr_expand_bits and A1 once a level of {levels}")
    launches["sw"] = counts
    log(f"path 8 (b) use_kernel: small_world_100k p=4 from path 2's roots "
        f"bitwise path 2's distances ({got[0][1]} levels); launches "
        f"{counts}; host reads {rep.info['host_reads']}; wall "
        f"{time.perf_counter() - t0:.1f} s")
    del eng, got
    release()
    log(f"path 8: walls (a) {wall_a:.1f} s, (b) {wall_b:.1f} s; path 8 "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# path 9: the torch.distributed mesh, one shard a process
# ---------------------------------------------------------------------------

#: every process of path 9 is gone by then, or killed and failed
PATH9_DEADLINE_S = 420
#: the process groups' timeout: a collective that waits longer raises
PATH9_PG_TIMEOUT_S = 120


def save_blocks(d: Path, graph, names) -> None:
    """Write a sharded graph's host blocks (one ``.npy`` each) and its
    sizes, for path 9's processes to map."""
    d.mkdir(parents=True, exist_ok=True)
    for name in names:
        np.save(d / f"{name}.npy", getattr(graph, name))
    part = graph.part
    (d / "meta.json").write_text(json.dumps({
        "n": part.n_logical, "p": part.p, "n_edges": int(graph.n_edges),
        "grid": [part.r, part.c] if hasattr(part, "r") else None}))


def load_blocks(d: Path):
    """The graph ``save_blocks`` wrote, its blocks mapped from the files
    (copy on write: a rank reads the rows it uploads)."""
    from repro_torch.core import Partition1D, Partition2D
    from repro_torch.graphs import ShardedGraph, ShardedGraph2D

    meta = json.loads((d / "meta.json").read_text())
    arrays = {f.stem: np.load(f, mmap_mode="c") for f in d.glob("*.npy")}
    if meta["grid"]:
        return ShardedGraph2D(part=Partition2D(meta["n"], *meta["grid"]),
                              n_edges=meta["n_edges"], **arrays)
    return ShardedGraph(part=Partition1D(meta["n"], meta["p"]),
                        n_edges=meta["n_edges"], **arrays)


def path9_kernels() -> dict:
    from repro_torch.kernels.bsr_spmm.kernel import bsr_expand_bits
    from repro_torch.kernels.fold_update import fold_update

    return {"fold_update": fold_update, "bsr_expand_bits": bsr_expand_bits}


def path9_drive(kernels, eng, roots, runs: int = 2):
    """``runs`` runs of ``eng`` (all ranks at once) with the launch counts
    reset before: (last result, its host dist, counts, run ms)."""
    reset_counts(kernels)
    run_ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = eng.run(roots)
        run_ms.append((time.perf_counter() - t0) * 1e3)
    counts = {name: k.launches for name, k in kernels.items()}
    return res, res.dist_host, counts, run_ms


def run_summary(res, counts, run_ms) -> dict:
    st = res.run_stats
    return {"stats": st.to_host(), "counts": counts, "run_ms": run_ms,
            "level_ms": [t * 1e3 for t in st.level_seconds]}


def path9_rank(rank: int, world: int, backend: str, tmp: str) -> None:
    """One process of path 9: join the group (``file://`` rendezvous in
    ``tmp``, no port), run its phases on ``cuda:0``, write its results
    (``result_<backend>_<rank>.json``) and leave the group."""
    import datetime

    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    tmp = Path(tmp)
    dist.init_process_group(
        backend, init_method=f"file://{tmp / f'rendezvous_{backend}'}",
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=PATH9_PG_TIMEOUT_S))
    try:
        body = path9_nccl if backend == "nccl" else path9_gloo
        out = body(rank, dev, tmp)
        (tmp / f"result_{backend}_{rank}.json").write_text(json.dumps(out))
    finally:
        dist.destroy_process_group()


def path9_nccl(rank: int, dev, tmp: Path) -> dict:
    """(a): ``nccl`` at world size 1: ``rmat_1m`` at p = 1 with the packed
    wire, S = 64, on path 1's roots."""
    import torch.distributed as dist

    from repro_torch.core import BFSOptions, DistMesh, plan
    from repro_torch.graphs import shard_graph

    kernels = path9_kernels()
    one = torch.ones(1, device=dev)
    dist.all_reduce(one)                  # the communicator forms
    want = np.load(tmp / "want1.npy", mmap_mode="r")
    roots = np.load(tmp / "roots1.npy").tolist()
    src = np.load(tmp / "src1.npy", mmap_mode="r")
    dst = np.load(tmp / "dst1.npy", mmap_mode="r")
    g = shard_graph(src, dst, want.shape[0], 1)
    mesh = DistMesh.flat(dev)
    pl = plan(g, BFSOptions(wire_format="packed"), mesh=mesh, num_sources=S)
    eng = pl.compile()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots)
    return {"a": run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want)),
        "all_reduce": float(one.item()), "mesh": pl.describe()["mesh"],
        "nccl": str(torch.cuda.nccl.version())}}


def path9_gloo(rank: int, dev, tmp: Path) -> dict:
    """(b)-(f) and the planted fault: ``gloo``, 4 ranks on ``cuda:0``."""
    import gc

    from repro_torch.analysis import collective_audit
    from repro_torch.core import BFSOptions, DistMesh, plan
    from repro_torch.core.frontier import INF

    kernels = path9_kernels()
    out = {}
    want1 = np.load(tmp / "want1.npy", mmap_mode="r")
    roots1 = np.load(tmp / "roots1.npy").tolist()
    deg1 = np.load(tmp / "deg1.npy")
    g1 = load_blocks(tmp / "rmat4")

    def release():
        gc.collect()
        torch.cuda.empty_cache()

    # (b) dense, default options (packed wire, A1 on the fused tail)
    mesh = DistMesh.flat(dev)
    pl = plan(g1, BFSOptions(), mesh=mesh, num_sources=S)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = pl.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    allocated = torch.cuda.memory_allocated()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots1)
    out["b"] = run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want1)),
        "compile_ms": compile_ms, "memory_allocated": allocated,
        "estimated_device_bytes": pl.estimated_device_bytes(),
        "terms": pl.device_byte_terms(), "mesh": pl.describe()["mesh"],
        "rows": list(eng._dist.shape),
        "roofline_dense": pl.describe()["roofline"]["dense"]}

    # (f) every rank audits (b)'s engine; rank 0's census is the one read
    rep = collective_audit.audit_engine(eng, sources=roots1)
    out["f"] = {"ok": rep.ok(), "summary": rep.summary(),
                "violations": [str(v) for v in rep.violations],
                "ratios": rep.info["ratios"],
                "host_reads": rep.info["host_reads"],
                "collectives": rep.info["collectives"],
                "table": collective_audit.census_table(rep)}
    del eng, res, rep
    release()

    # (c) auto, S = 1, path 4's first roots: bitwise, schedules replayed
    pl = plan(g1, BFSOptions(mode="auto"), mesh=mesh, num_sources=1)
    eng = pl.compile()
    rows = []
    for i, root in enumerate(roots1[:8]):
        res, host, counts, run_ms = path9_drive(kernels, eng, [root], runs=1)
        st = res.run_stats.to_host()
        levels, modes = replay_modes(host, deg1, g1.n_edges, 1, INF)
        rows.append(run_summary(res, counts, run_ms) | {
            "bitwise": bool(np.array_equal(host, want1[:, i:i + 1])),
            "replayed": levels == st["levels"]
            and mode_counts(modes) == st["mode_counts"], "modes": modes})
    out["c"] = rows
    del eng, res
    release()

    # (d) the 2 x 2 grid, dense, S = 64 (path 5 (a))
    g2d = load_blocks(tmp / "rmat2d")
    pl = plan(g2d, BFSOptions(), mesh=DistMesh.grid(2, 2, dev),
              num_sources=S)
    eng = pl.compile()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots1)
    out["d"] = run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want1)),
        "rows": list(eng._dist.shape)}
    del eng, res, g2d
    release()

    # (e) small_world_100k, use_kernel, p = 4 (path 2's roots)
    want2 = np.load(tmp / "want2.npy")
    roots2 = np.load(tmp / "roots2.npy").tolist()
    g_sw = load_blocks(tmp / "sw4")
    pl = plan(g_sw, BFSOptions(use_kernel=True), mesh=mesh, num_sources=S)
    eng = pl.compile()
    res, host, counts, run_ms = path9_drive(kernels, eng, roots2)
    out["e"] = run_summary(res, counts, run_ms) | {
        "bitwise": bool(np.array_equal(host, want2)),
        "tiles": int(eng.kernel_arrays[0].shape[0])}
    del eng, res
    release()

    # the planted fault: rank 1 reports the next shard's index
    class WrongIndex(DistMesh):
        @property
        def local_shards(self):
            k = (self.rank + 1) % self.p if self.rank == 1 else self.rank
            return range(k, k + 1)

    pl = plan(g_sw, BFSOptions(), mesh=WrongIndex((4,), ("bfs_p",), dev),
              num_sources=S)
    host = pl.compile().run(roots2).dist_host
    out["fault"] = {"rejected": not np.array_equal(host, want2)}
    return out


def path9_group(ctx, world: int, backend: str, tmp: Path, deadline: float):
    """Start ``world`` processes of ``path9_rank`` and wait for them until
    ``deadline`` (``time.monotonic``), then kill the rest; returns their
    results, or fails."""
    procs = [ctx.Process(target=path9_rank, args=(k, world, backend,
                                                  str(tmp)))
             for k in range(world)]
    for proc in procs:
        proc.start()
    try:
        for proc in procs:
            proc.join(max(0.0, deadline - time.monotonic()))
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
                proc.join()
    codes = [proc.exitcode for proc in procs]
    check(codes == [0] * world,
          f"path 9 ({backend}): the processes exited {codes}")
    return [json.loads((tmp / f"result_{backend}_{k}.json").read_text())
            for k in range(world)]


def path9_phase(g1, src1, dst1, roots1, want1, path1, path5_stats, g_sw_src,
                host2, roots2, card: str, tmp: Path) -> dict:
    """``DistMesh`` on the card (module docstring, path 9).  Writes the
    graphs and expected distances once, then runs (a) in one ``nccl``
    process and (b)-(f) and the planted fault in four ``gloo`` processes
    on ``cuda:0``, all started with ``spawn`` after the parent built the
    kernels.  Returns each rank's launches."""
    import gc

    from repro_torch.core import BFSOptions, plan
    from repro_torch.graphs import shard_graph, to_2d
    from repro_torch.kernels import _build

    t_phase = time.perf_counter()
    _build.build()                        # built before any rank starts
    t0 = time.perf_counter()
    names1 = ("src_local", "dst_global", "in_src_global", "in_dst_local")
    save_blocks(tmp / "rmat4", g1, names1)
    save_blocks(tmp / "rmat2d", to_2d(g1, 2, 2), ("src_rowlocal",
                                                  "dst_fold"))
    save_blocks(tmp / "sw4", shard_graph(*g_sw_src, 4), names1)
    np.save(tmp / "src1.npy", src1.astype(np.int32))
    np.save(tmp / "dst1.npy", dst1.astype(np.int32))
    np.save(tmp / "deg1.npy", np.bincount(src1, minlength=g1.part.n_logical))
    np.save(tmp / "roots1.npy", np.asarray(roots1))
    np.save(tmp / "want1.npy", want1)
    np.save(tmp / "roots2.npy", np.asarray(roots2))
    np.save(tmp / "want2.npy", host2)
    write_s = time.perf_counter() - t0
    stacked = plan(g1, BFSOptions(), num_sources=S).device_byte_terms()
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    deadline = time.monotonic() + PATH9_DEADLINE_S

    # (a) nccl at world size 1
    t0 = time.perf_counter()
    a = path9_group(ctx, 1, "nccl", tmp, deadline)[0]["a"]
    wall_a = time.perf_counter() - t0
    p1 = path1["p1_packed"][3]
    check(a["bitwise"] and a["mesh"]["backend"] == "nccl"
          and a["all_reduce"] == 1.0,
          f"path 9 (a): distances or the nccl group wrong: {a['mesh']}")
    check(a["stats"]["levels"] == p1.levels
          and a["stats"]["comm_bytes"] == p1.comm_bytes,
          f"path 9 (a): {a['stats']}, path 1 p1_packed {p1.levels} levels")
    check(a["counts"]["fold_update"] == 2 * a["stats"]["levels"]
          and a["counts"]["bsr_expand_bits"] == 0,
          f"path 9 (a): launches {a['counts']} in 2 runs")
    log(f"path 9 (a) nccl {a['nccl']}, world size 1, rmat_1m p=1 packed "
        f"S=64: bitwise path 1 p1_packed, levels {a['stats']['levels']}, "
        f"comm_bytes {a['stats']['comm_bytes']}, runs {a['run_ms']} ms, "
        f"per-level ms {a['level_ms']}, launches {a['counts']}; wall "
        f"{wall_a:.1f} s ({card})")

    # (b)-(f): gloo, four ranks sharing cuda:0
    t0 = time.perf_counter()
    ranks = path9_group(ctx, 4, "gloo", tmp, deadline)
    wall_g = time.perf_counter() - t0
    p4 = path1["p4_default"][3]
    for k, r in enumerate(ranks):
        b = r["b"]
        check(b["bitwise"] and b["stats"]["levels"] == p4.levels
              and b["stats"]["comm_bytes"] == p4.comm_bytes,
              f"path 9 (b) rank {k}: bitwise {b['bitwise']}, {b['stats']}; "
              f"path 1 p4_default {p4.levels} levels, {p4.comm_bytes}")
        check(b["counts"]["fold_update"] == 2 * b["stats"]["levels"]
              and b["counts"]["bsr_expand_bits"] == 0,
              f"path 9 (b) rank {k}: launches {b['counts']} in 2 runs")
        check(b["rows"] == [g1.part.shard_size, S]
              and b["memory_allocated"] <= b["estimated_device_bytes"],
              f"path 9 (b) rank {k}: dist {b['rows']}, allocated "
              f"{b['memory_allocated']} over the estimate "
              f"{b['estimated_device_bytes']}")
    resident = [r["b"]["terms"]["resident"] for r in ranks]
    check(sum(resident) == stacked["resident"],
          f"path 9 (b): the ranks' resident bytes {resident} do not sum to "
          f"the stacked engine's {stacked['resident']}")
    transport = ranks[0]["b"]["mesh"]["transport"]
    for k, r in enumerate(ranks):
        log(f"path 9 (b) rank {k}: estimated_device_bytes "
            f"{r['b']['estimated_device_bytes']} (resident "
            f"{r['b']['terms']['resident']}), memory_allocated after compile "
            f"{r['b']['memory_allocated']}, compile {r['b']['compile_ms']:.1f}"
            f" ms, runs {r['b']['run_ms']} ms, launches {r['b']['counts']}")
    b0 = ranks[0]["b"]
    log(f"path 9 (b) {transport}, 4 ranks on one "
        f"card ({card}), not a multi-card figure: rmat_1m p=4 dense S=64 "
        f"bitwise path 1 p4_default, levels {b0['stats']['levels']}, "
        f"comm_bytes {b0['stats']['comm_bytes']}; per-level ms (rank 0) "
        f"{[round(t, 3) for t in b0['level_ms']]} beside path 1 p4_default "
        f"{[round(t * 1e3, 3) for t in p4.level_seconds]}; the ranks' "
        f"resident bytes {resident} sum to the stacked engine's "
        f"{stacked['resident']}; roofline dense link "
        f"{b0['roofline_dense']['link']} t_level_s "
        f"{b0['roofline_dense']['t_level_s']}")

    f = ranks[0]["f"]
    log(f"path 9 (f) rank 0's census of (b): {f['summary']}\n{f['table']}")
    check(all(r["f"]["ok"] for r in ranks),
          f"path 9 (f): an audit failed: {f['violations']}")
    check(f["ratios"] and all(v["min"] == v["max"] == 1.0
                              for v in f["ratios"].values()),
          f"path 9 (f): recorded/modeled ratios {f['ratios']}")
    from repro_torch.analysis.collective_audit import HOST_READ_BUDGET
    check(all(n <= HOST_READ_BUDGET[k]
              for k, n in f["host_reads"]["max_per_level"].items()),
          f"path 9 (f): host reads {f['host_reads']}")
    log(f"path 9 (f): ratios {f['ratios']}; host reads a level "
        f"{f['host_reads']['max_per_level']} (counted by "
        f"{f['host_reads']['counted_by']}); collectives "
        f"{f['collectives']}")

    for k, r in enumerate(ranks):
        for i, row in enumerate(r["c"]):
            check(row["bitwise"] and row["replayed"],
                  f"path 9 (c) rank {k} root {i}: bitwise {row['bitwise']},"
                  f" {row['stats']['mode_counts']} against the replay")
    c0 = ranks[0]["c"]
    # A1 runs on the dense levels and on the queue levels that escalate
    log(f"path 9 (c) auto S=1, {len(c0)} roots: bitwise path 4's columns, "
        f"mode_counts == the replay: "
        f"{[row['stats']['mode_counts'] for row in c0]}; overflowed "
        f"{[row['stats']['overflowed'] for row in c0]}; A1 "
        f"{[row['counts']['fold_update'] for row in c0]}; runs "
        f"{[round(row['run_ms'][0], 3) for row in c0]} ms")

    s5 = path5_stats
    for k, r in enumerate(ranks):
        d = r["d"]
        check(d["bitwise"] and d["stats"]["levels"] == s5.levels
              and d["stats"]["comm_bytes"] == s5.comm_bytes
              and d["stats"]["mode_counts"]["dense"] == s5.levels,
              f"path 9 (d) rank {k}: bitwise {d['bitwise']}, {d['stats']}")
        check(d["counts"]["fold_update"] == 2 * d["stats"]["levels"],
              f"path 9 (d) rank {k}: launches {d['counts']} in 2 runs")
    d0 = ranks[0]["d"]
    log(f"path 9 (d) 2 x 2 DistMesh.grid dense S=64, gloo through the host "
        f"on one card ({card}): bitwise path 5 (a), levels "
        f"{d0['stats']['levels']}, comm_bytes {d0['stats']['comm_bytes']}; "
        f"per-level ms (rank 0) {[round(t, 3) for t in d0['level_ms']]} "
        f"beside path 5 (a) {[round(t * 1e3, 3) for t in s5.level_seconds]}")

    for k, r in enumerate(ranks):
        e = r["e"]
        check(e["bitwise"], f"path 9 (e) rank {k}: distances differ from "
                            "path 2's")
        check(e["counts"]["bsr_expand_bits"] == 2 * e["stats"]["levels"]
              and e["counts"]["fold_update"] == 2 * e["stats"]["levels"],
              f"path 9 (e) rank {k}: launches {e['counts']} in 2 runs of "
              f"{e['stats']['levels']} levels")
        check(r["fault"]["rejected"],
              f"path 9 fault: rank {k}'s distances passed with a wrong "
              "shard index")
    e0 = ranks[0]["e"]
    log(f"path 9 (e) small_world_100k use_kernel p=4: bitwise path 2, "
        f"bsr_expand_bits {[r['e']['counts']['bsr_expand_bits'] for r in ranks]}"
        f" a rank in 2 runs of {e0['stats']['levels']} levels; tiles a rank "
        f"{[r['e']['tiles'] for r in ranks]}; the planted wrong shard index "
        f"rejected on every rank")
    log(f"path 9: writes {write_s:.1f} s, (a) {wall_a:.1f} s, (b)-(f) "
        f"{wall_g:.1f} s; path 9 {time.perf_counter() - t_phase:.1f} s")
    return {"fold_update": [a["counts"]["fold_update"]]
            + [r["b"]["counts"]["fold_update"] for r in ranks],
            "bsr_expand_bits": [r["e"]["counts"]["bsr_expand_bits"]
                                for r in ranks]}


def profile_run(name, run) -> None:
    """One more call of ``run`` under ``torch.profiler``: device time by
    op, and the share of the call's wall time the device was busy."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.key_averages()
    # device-side entries only: a host op's device time repeats its kernels'
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    log(f"{name} profile: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy_us / 1e3:.3f} ms ({100 * busy_us / wall_us:.1f}%)")
    log(events.table(sort_by="self_device_time_total", row_limit=12))


def visible_pairs(sq: int, skv: int, causal: bool, window: int) -> int:
    """(q, k) pairs the causal / window mask keeps (A4's work)."""
    q = np.arange(sq, dtype=np.int64)
    hi = np.minimum(q + 1, skv) if causal else np.full(sq, skv, np.int64)
    lo = np.maximum(q - window + 1, 0) if window > 0 else np.zeros(sq,
                                                                   np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against ``want``, in f32."""
    want = want.float()
    return float((got.float() - want).norm() / want.norm())


def head_rel_errs(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """Relative L2 error of each (batch, head) slice of an attention
    output ``(B, H, S, Dh)``."""
    want = want.float()
    diff = (got.float() - want).flatten(2).norm(dim=-1)
    return diff / want.flatten(2).norm(dim=-1).clamp_min(1e-30)


def hold_a4(q, k, v, causal: bool, window: int, what: str):
    """A4 against its plain version: elementwise with the bound of
    tests/test_torch_cuda.py (f32 2e-5; bf16 atol 2^-9 max|v|, rtol
    2^-6), and each (batch, head) slice within A4_HEAD_TOL relative L2
    (bf16; 2e-5 for f32).  Returns the max abs error and the plain
    output."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    got = flash_attention(q, k, v, causal=causal, window=window)
    want = attention_ref(q, k, v, causal=causal, window=window)
    if q.dtype == torch.float32:
        atol = rtol = head_tol = 2e-5
    else:
        atol, rtol = 2.0 ** -9 * float(v.abs().max()), 2.0 ** -6
        head_tol = A4_HEAD_TOL
    diff = (got.float() - want.float()).abs()
    err = float(diff.max())
    ok = bool((diff <= atol + rtol * want.float().abs()).all())
    heads = head_rel_errs(got, want)
    log(f"A4 {what}: max abs err {err} (atol {atol}, rtol {rtol}); rel L2 "
        f"a head: mean {float(heads.mean())}, max {float(heads.max())} "
        f"(limit {head_tol})")
    check(ok and float(heads.max()) <= head_tol,
          f"A4 differs from attention_ref at {what}")
    return err, want


def planted_a4(q, k, v, window: int, want, what: str) -> torch.Tensor:
    """A planted fault: A4 with the causal window one key wider and one
    narrower, read against the plain output ``want`` at ``window``;
    returns the smallest relative L2 error a head."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention

    worst = float("inf")
    for delta in (-1, 1):
        heads = head_rel_errs(flash_attention(
            q, k, v, causal=True, window=window + delta), want)
        log(f"A4 planted fault at {what} (window {window + delta} against "
            f"{window}): rel L2 a head: min {float(heads.min())}, max "
            f"{float(heads.max())} (limit {A4_HEAD_TOL})")
        worst = min(worst, float(heads.min()))
    return worst


def shifted_windows(cfg, delta: int):
    """``cfg`` with every local layer's window moved by ``delta``: a
    planted fault, for reading what the prefill check catches."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(sp, window=sp.window + delta) if sp.window
        else sp for sp in cfg.pattern))


def prefill_phase(kernels, dev, profile: bool) -> dict:
    """gemma3-12b prefill at full width, cut in depth and size (module
    docstring, phase 8); returns A4's launches and what the kernel phase
    needs of the run."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models import transformer as tf

    spec = get_arch("gemma3_12b")
    full, full_shape = spec.config, get_shape(spec, "prefill_32k")
    cfg = dataclasses.replace(full, n_layers=PREFILL_LAYERS)
    shape = dataclasses.replace(full_shape, seq_len=PREFILL_SEQ,
                                global_batch=PREFILL_BATCH)
    log(f"prefill: {full.name} prefill_32k, d_model {cfg.d_model}, heads "
        f"{cfg.n_heads} q / {cfg.n_kv_heads} kv x {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, random weights "
        f"(seed {SEED})")
    log(f"prefill cut: layers {full.n_layers} -> {cfg.n_layers} "
        f"({cfg.n_groups} groups of {len(cfg.pattern)}: 5 local, window "
        f"{cfg.pattern[0].window}, + 1 global)")
    log(f"prefill cut: batch {full_shape.global_batch} -> "
        f"{shape.global_batch}")
    log(f"prefill cut: seq_len (prompt = max_len) {full_shape.seq_len} -> "
        f"{shape.seq_len}")
    bundle = build_bundle(dataclasses.replace(spec, config=cfg), shape,
                          device=dev)
    t0 = time.perf_counter()
    params = bundle.make_state(bundle.init_params(
        torch.Generator(device=dev).manual_seed(SEED)))
    batch = bundle.make_batch(SEED)
    torch.cuda.synchronize()
    log(f"prefill: {sum(p.numel() for p in params.parameters())} weights "
        f"({sum(p.numel() * p.element_size() for p in params.parameters()) / 1e9:.3f} GB) "
        f"drawn in {time.perf_counter() - t0:.3f} s; tokens "
        f"{tuple(batch['tokens'].shape)}")

    run_ms, outs, launches = [], [], 0
    a4 = kernels["flash_attention"]
    for i in range(3):
        reset_counts(kernels)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = bundle.fn(params, batch)
        torch.cuda.synchronize()
        run_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {name: k.launches for name, k in kernels.items()}
        check(counts["flash_attention"] == cfg.n_layers
              and a4.launches_bf16 == cfg.n_layers and a4.launches_f32 == 0,
              f"prefill run {i + 1}: A4 launched "
              f"{counts['flash_attention']} times ({a4.launches_bf16} bf16, "
              f"{a4.launches_f32} f32), not {cfg.n_layers} bf16")
        launches += counts["flash_attention"]
        outs.append((logits, cache))
    logits, cache = outs[-1]
    b, s = batch["tokens"].shape
    check(logits.shape == (b, cfg.vocab), f"logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()), "prefill logits not finite")
    check(torch.equal(outs[1][0], logits)
          and all(torch.equal(x[n], y[n]) for x, y in zip(outs[1][1], cache)
                  for n in "kv"), "prefill runs 2 and 3 differ")
    log(f"prefill: first run {run_ms[0]:.1f} ms; runs 2, 3 "
        f"{[round(t, 3) for t in run_ms[1:]]} ms = "
        f"{[round(b * s / (t / 1e3), 1) for t in run_ms[1:]]} prompt "
        f"tokens/s; A4 launches {cfg.n_layers} a run")
    del outs
    if profile:
        profile_run("prefill", lambda: bundle.fn(params, batch))

    # the same prefill with the plain attention (attention_ref)
    plain_logits, plain_cache = bundle.fn(params, batch, use_kernel=False)
    torch.cuda.synchronize()
    # Tolerance: each layer's attention output may differ from the plain
    # one by the kernel phase's limit (2^-7 relative L2 a head); the
    # residual stream carries 12 such differences to the logits and to
    # the later layers' k, v, which are held to PREFILL_TOL relative L2.
    # The first layer's k, v are computed before any attention, so its
    # cache is bitwise equal.
    err = rel_err(logits, plain_logits)
    layer_errs = [max(rel_err(c[n][g], pc[n][g]) for n in "kv")
                  for g in range(cfg.n_groups)
                  for c, pc in zip(cache, plain_cache)]
    max_abs = float((logits.float() - plain_logits.float()).abs().max())
    log(f"prefill vs plain attention: logits rel L2 {err} (max abs "
        f"{max_abs}); cache rel L2 by layer {layer_errs}; tolerance "
        f"{PREFILL_TOL}")
    check(err <= PREFILL_TOL and max(layer_errs) <= PREFILL_TOL,
          "prefill with A4 differs from the plain-attention prefill")
    check(torch.equal(cache[0]["k"][0], plain_cache[0]["k"][0])
          and torch.equal(cache[0]["v"][0], plain_cache[0]["v"][0]),
          "the first layer's cache differs from the plain prefill's")
    del plain_cache
    # planted faults, read only: every local window one key off moves the
    # logits by 0.036 and 0.044 (H100), too close to the correct kernel's
    # 0.018 for the logits to be the gate; the per-layer hold below is.
    for delta in (-1, 1):
        bad, _, _ = tf.prefill(shifted_windows(cfg, delta), params,
                               batch["tokens"], shape.seq_len)
        log(f"prefill planted fault (local windows {delta:+d}): logits rel "
            f"L2 {rel_err(bad, plain_logits)} against the plain prefill")
    del plain_logits

    # A4 on each layer's own q, k, v (the kernel's contiguous operands),
    # recorded from one more prefill
    recorded, attention = [], tf.attention

    def record(q, k, v, *, causal, window, use_kernel):
        recorded.append((q.contiguous(), k.contiguous(), v.contiguous(),
                         window))
        return attention(q, k, v, causal=causal, window=window,
                         use_kernel=use_kernel)

    tf.attention = record
    try:
        bundle.fn(params, batch)
    finally:
        tf.attention = attention
    check(len(recorded) == cfg.n_layers, "a layer's attention not recorded")
    for i, (q, k, v, window) in enumerate(recorded):
        _, want = hold_a4(q, k, v, True, window,
                          f"prefill layer {i} (window {window})")
        if i == 0:      # every head must fail with the window one key off
            check(planted_a4(q, k, v, window, want, "prefill layer 0")
                  > A4_HEAD_TOL, "the A4 check passes a window one key off "
                                 "at prefill layer 0")
    del recorded, q, k, v, want
    return {"launches": launches, "cfg": cfg, "batch": b, "seq": s}


def attention_rows(lay: dict, dev, sass: dict) -> dict:
    """A4 against its plain version at the prefill's shapes (local and
    global layer) and at Dh = 128 on an unaligned length; timed beside its
    bound, the plain version and SDPA (both layers)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         attention_ref)

    cfg, b, s = lay["cfg"], lay["batch"], lay["seq"]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def qkv(dtype, sq, skv, d):
        return (torch.randn((b, hq, sq, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, hkv, skv, d), generator=gen, device=dev
                            ).to(dtype),
                torch.randn((b, hkv, skv, d), generator=gen, device=dev
                            ).to(dtype))

    errs = []
    for dtype in (torch.float32, torch.bfloat16):   # unaligned, non-causal
        q, k, v = qkv(dtype, 1000, 1500, 128)
        errs.append(hold_a4(q, k, v, False, 0, f"{dtype} Dh 128 Sq 1000 "
                            f"Skv 1500 non-causal")[0])
    # the prefill's widths with a ragged last q and kv tile
    q, k, v = qkv(torch.bfloat16, s - 1, s - 1, dh)
    errs.append(hold_a4(q, k, v, True, cfg.pattern[0].window,
                        f"bf16 Dh {dh} Sq = Skv = {s - 1} window "
                        f"{cfg.pattern[0].window}")[0])
    q, k, v = qkv(torch.bfloat16, s, s, dh)
    row = {}
    for window in (cfg.pattern[0].window, 0):       # local, then global
        what = f"bf16 {tuple(q.shape)} kv {tuple(k.shape)} window {window}"
        err, want = hold_a4(q, k, v, True, window, what)
        errs.append(err)
        if window:      # every head must fail with the window one key off
            check(planted_a4(q, k, v, window, want, what) > A4_HEAD_TOL,
                  f"the A4 check passes a window one key off at {what}")
        del want
        pairs = visible_pairs(s, s, True, window)
        flops = 4.0 * b * hq * dh * pairs
        b_ms, b_by = bound(nbytes(q, k, v, q), flops, BF16_FLOPS)
        ms = timed_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window), 5)
        plain_ms = timed_ms(lambda: attention_ref(q, k, v, causal=True,
                                                  window=window), 3)
        tflops = flops / ms / 1e9
        log(f"A4 {what}: {ms} ms = {tflops} TFLOP/s, {b_ms / ms:.4f} of the "
            f"bound {b_ms} ms ({b_by}; {pairs} visible pairs a head); plain "
            f"{plain_ms} ms")
        row[window] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                       "bound_by": b_by, "tflops": tflops,
                       "bound_share": b_ms / ms}
    # the one-call yardsticks (timed only; the port never calls SDPA): the
    # global layer causal with GQA, the local layer with its window as a
    # boolean mask over kv heads expanded to q heads beforehand
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
    sdpa_err = float((sdpa().float()
                      - attention_ref(q, k, v, causal=True).float()
                      ).abs().max())
    library_ms = timed_ms(sdpa, 10)
    log(f"SDPA (global layer): {library_ms} ms, max abs err vs plain "
        f"{sdpa_err}")
    w_loc = cfg.pattern[0].window
    k_rep, v_rep = (x.repeat_interleave(hq // hkv, dim=1) for x in (k, v))
    mask = attention_mask(s, s, causal=True, window=w_loc, device=dev)
    sdpa_local = lambda: F.scaled_dot_product_attention(q, k_rep, v_rep,
                                                        attn_mask=mask)
    local_err = float((sdpa_local().float()
                       - attention_ref(q, k, v, causal=True,
                                       window=w_loc).float()).abs().max())
    library_local_ms = timed_ms(sdpa_local, 5)
    log(f"SDPA (local layer, boolean attn_mask): {library_local_ms} ms, max "
        f"abs err vs plain {local_err}")
    del k_rep, v_rep, mask
    local, glob = row[w_loc], row[0]
    return {
        "name": "flash_attention", "route": "cuda",
        "design": "bf16: wgmma + TMA, warp-specialised; f32: CUDA cores",
        "source": "src/repro_torch/csrc/attention_kernels.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "launches": lay["launches"], "max_abs_err": max(errs),
        "ms": glob["ms"], "plain_ms": glob["plain_ms"],
        "bound_ms": glob["bound_ms"], "bound_by": glob["bound_by"],
        "library_ms": library_ms,
        "tflops": glob["tflops"], "bound_share": glob["bound_share"],
        "shape": f"global layer: q {tuple(q.shape)} bf16, kv "
                 f"{tuple(k.shape)}, causal",
        "local_window": w_loc,
        "local_ms": local["ms"], "local_plain_ms": local["plain_ms"],
        "local_bound_ms": local["bound_ms"],
        "local_tflops": local["tflops"],
        "local_bound_share": local["bound_share"],
        "library_local_ms": library_local_ms, "sass": sass}


def sdpa_backend(q, k, v, **kw) -> str:
    """The backend ``F.scaled_dot_product_attention`` dispatches to for
    these operands (torch's own choice, ``torch._fused_sdp_choice``)."""
    from torch.nn.attention import SDPBackend

    choice = int(torch._fused_sdp_choice(q, k, v, **kw))
    names = {int(b): name for name, b in SDPBackend.__members__.items()}
    return names.get(choice, f"backend {choice}")


def attention_f32_row(lay: dict, kernels, dev, sass: dict) -> dict:
    """A4's f32 route (``attn_flash_fwd_f32``: split TF32 on wgmma after
    its pre-pass ``split_kv``) at the prefill's global and local layer
    shapes in f32, driven once each through ``ops.attention`` (its
    launches), held to the plain version, run twice (equal outputs), the
    plain version with one pass of TF32 read against the hold (a planted
    fault it must catch), and timed beside its bounds (bytes; f32 FMA;
    three TF32 products, the least the tensor cores could take at f32
    accuracy), the pre-pass alone, the plain version and SDPA in f32, whose backend and error are read beside it."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.flash_attention.kernel import (flash_attention,
                                                            split_kv)
    from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                         attention_ref)

    cfg, b, s = lay["cfg"], lay["batch"], lay["seq"]
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    w_loc = cfg.pattern[0].window
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    q = torch.randn((b, hq, s, dh), generator=gen, device=dev)
    k = torch.randn((b, hkv, s, dh), generator=gen, device=dev)
    v = torch.randn((b, hkv, s, dh), generator=gen, device=dev)
    reset_counts(kernels)
    split_kv.launches = 0
    for window in (0, w_loc):
        attn_ops.attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    launches = flash_attention.launches_f32
    check(launches == 2 and flash_attention.launches_bf16 == 0
          and split_kv.launches == 2,
          f"A4 f32: {launches} f32 and {flash_attention.launches_bf16} "
          f"bf16 launches, {split_kv.launches} pre-passes for two f32 calls")
    pre_launches = split_kv.launches
    # the pre-pass alone: reads k and v, writes K's hi and lo, V^T and its lo
    parts = split_kv(k, v)
    pre_bytes = nbytes(k, v, *parts)
    pre_bound_ms, _ = bound(pre_bytes)
    pre_ms = timed_ms(lambda: split_kv(k, v), 10)
    del parts
    log(f"A4 f32 pre-pass (split_kv) at kv {tuple(k.shape)}: {pre_ms} ms, "
        f"{pre_bound_ms / pre_ms:.4f} of its byte bound {pre_bound_ms} ms "
        f"({pre_bytes} bytes)")
    row = {}
    for window in (0, w_loc):                       # global, then local
        what = f"f32 {tuple(q.shape)} kv {tuple(k.shape)} window {window}"
        err, want = hold_a4(q, k, v, True, window, what)
        got = flash_attention(q, k, v, causal=True, window=window)
        check(torch.equal(got, flash_attention(q, k, v, causal=True,
                                               window=window)),
              f"A4 f32 at {what}: two calls differ")
        del got
        # planted fault: one pass of TF32 (the plain version's matrix
        # products under allow_tf32) must miss the f32 head limit
        tf32_flag = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            one_pass = head_rel_errs(attention_ref(
                q, k, v, causal=True, window=window), want)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_flag
        planted = (float(one_pass.min()), float(one_pass.max()))
        log(f"A4 f32 planted fault at {what} (the plain version in one pass "
            f"of TF32): rel L2 a head: min {planted[0]}, max {planted[1]} "
            f"(limit 2e-05; the kernel's max abs err {err})")
        check(planted[1] > 2e-5, f"the A4 f32 hold passes one pass of TF32 "
                                 f"at {what}")
        pairs = visible_pairs(s, s, True, window)
        flops = 4.0 * b * hq * dh * pairs
        b_ms, b_by = bound(nbytes(q, k, v, q), 3 * flops, TF32_FLOPS)
        ms = timed_ms(lambda: flash_attention(q, k, v, causal=True,
                                              window=window), 3)
        plain_ms = timed_ms(lambda: attention_ref(q, k, v, causal=True,
                                                  window=window), 2)
        if window:    # the window as a boolean mask, kv heads expanded
            k_rep, v_rep = (t.repeat_interleave(hq // hkv, dim=1)
                            for t in (k, v))
            mask = attention_mask(s, s, causal=True, window=window,
                                  device=dev)
            args, kw = (q, k_rep, v_rep), {"attn_mask": mask}
        else:
            args, kw = (q, k, v), {"is_causal": True, "enable_gqa": True}
        backend = sdpa_backend(*args, **kw)
        sdpa = lambda: F.scaled_dot_product_attention(*args, **kw)
        sdpa_err = float((sdpa() - want).abs().max())
        library_ms = timed_ms(sdpa, 2)
        del args, kw, want
        log(f"A4 {what}: {ms} ms = {flops / ms / 1e9} TFLOP/s, "
            f"{b_ms / ms:.4f} of the bound {b_ms} ms ({b_by}; f32 FMA "
            f"{flops / F32_FLOPS * 1e3} ms); plain {plain_ms} ms; SDPA {library_ms} ms ({backend}, max "
            f"abs err vs plain {sdpa_err})")
        row[window] = {
            "ms": ms,
            "planted_one_pass_head_min": planted[0],
            "planted_one_pass_head_max": planted[1],
            "plain_ms": plain_ms, "bound_ms": b_ms,
            "bound_by": b_by, "bound_fma_ms": flops / F32_FLOPS * 1e3,
            "bound_tf32x3_ms": 3 * flops / TF32_FLOPS * 1e3,
            "tflops": flops / ms / 1e9, "bound_share": b_ms / ms,
            "library_ms": library_ms, "library_backend": backend,
            "library_max_abs_err": sdpa_err, "max_abs_err": err}
    glob, local = row[0], row[w_loc]
    return {
        "name": "flash_attention_f32", "route": "cuda",
        "design": "split TF32 (3 products) on wgmma m64n64k8 / m64n32k8, "
                  "TMA slot rings, two consumer warpgroups on alternate kv "
                  "tiles merged at the end (flash_fwd_tf32), after a "
                  "pre-pass (split_kv_kernel: K's hi and lo, V^T and its lo, keys "
                  "0 2 4 6 1 3 5 7 in each group of 8)",
        "source": "src/repro_torch/csrc/attention_kernels.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:31",
        "path": "ops.attention in f32 (no model path runs f32 attention)",
        "launches": launches,
        "max_abs_err": max(glob["max_abs_err"], local["max_abs_err"]),
        "prepass_launches": pre_launches, "prepass_ms": pre_ms,
        "prepass_bound_ms": pre_bound_ms, "prepass_bytes": pre_bytes,
        **{key: glob[key] for key in (
            "ms", "planted_one_pass_head_min",
            "planted_one_pass_head_max", "plain_ms", "bound_ms", "bound_by",
            "bound_fma_ms", "bound_tf32x3_ms", "tflops", "bound_share",
            "library_ms", "library_backend", "library_max_abs_err")},
        "shape": f"global layer: q {tuple(q.shape)} f32, kv "
                 f"{tuple(k.shape)}, causal",
        "local_window": w_loc,
        **{f"local_{key}": local[key] for key in (
            "ms", "planted_one_pass_head_min",
            "planted_one_pass_head_max", "plain_ms", "bound_ms", "bound_by",
            "bound_fma_ms", "bound_tf32x3_ms", "tflops", "bound_share",
            "library_ms", "library_backend", "library_max_abs_err")},
        "sass": sass}


def to_host64(tree):
    """A float64 copy on the host of a DeepFM weight tree."""
    if isinstance(tree, dict):
        return {k: to_host64(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_host64(v) for v in tree]
    return tree.detach().cpu().double()


def rel_err64(got: torch.Tensor, want: torch.Tensor) -> float:
    """Relative L2 error of ``got`` against the f64 host ``want``."""
    return float((got.cpu().double() - want).norm() / want.norm())


def serve_twin(cfg, host, batch, n: int) -> dict:
    """The port's serve step on the CPU in float64 (weights ``host``) for
    the first ``n`` rows of ``batch``: gathered rows, FM term, logits."""
    from repro_torch.models.recsys import deepfm

    hb = {"sparse": batch["sparse"][:n].cpu(),
          "dense": batch["dense"][:n].cpu().double()}
    emb, _ = deepfm._embed(cfg, host, hb["sparse"])
    return {"emb": emb, "fm": deepfm.fm_term(emb),
            "logits": deepfm.forward(cfg, host, hb)}


def retrieval_twin(cfg, host, batch, n: int) -> dict:
    """The port's retrieval step on the CPU in float64 for the first ``n``
    candidates: the query's rows, the candidates' rows and the scores."""
    from repro_torch.models.recsys import deepfm

    hb = {"sparse": batch["sparse"].cpu(),
          "cand_ids": batch["cand_ids"][:n].cpu()}
    emb, _ = deepfm._embed(cfg, host, hb["sparse"])
    return {"emb": emb, "cand": host["table"][hb["cand_ids"]],
            "scores": deepfm.retrieval_step(cfg, host, hb)}


def hold_serve(cfg, params, batch, scores, twin: dict) -> dict:
    """A serve step's ``scores`` on the card against its f64 ``twin`` on
    the twin's rows: the gathered rows bitwise (f32 -> f64 is exact), the
    FM term, logits and scores at relative L2.  Returns the readings, with
    ``ok``."""
    from repro_torch.models.recsys import deepfm

    n = twin["logits"].shape[0]
    emb, _ = deepfm._embed(cfg, params, batch["sparse"])
    fm = deepfm.fm_term(emb)[:n]
    r = {"emb_bitwise": torch.equal(emb[:n].cpu().double(), twin["emb"]),
         "fm": rel_err64(fm, twin["fm"]),
         "logits": rel_err64(deepfm.forward(cfg, params, batch)[:n],
                             twin["logits"]),
         "scores": rel_err64(scores[:n], torch.sigmoid(twin["logits"])),
         "fm_abs_mean": float(twin["fm"].abs().mean()),
         "logits_abs_mean": float(twin["logits"].abs().mean())}
    r["ok"] = (r["emb_bitwise"] and r["fm"] <= FM_TOL
               and max(r["logits"], r["scores"]) <= RECSYS_TOL)
    return r


def hold_retrieval(cfg, params, batch, scores, twin: dict) -> dict:
    """A retrieval step's ``scores`` on the card against its f64 ``twin``
    on the twin's candidates: the query's rows and the candidates' rows
    bitwise, the scores at relative L2."""
    from repro_torch.models.recsys import deepfm

    n = twin["scores"].shape[0]
    emb, _ = deepfm._embed(cfg, params, batch["sparse"])
    cand = params["table"][batch["cand_ids"][:n]]
    r = {"emb_bitwise": (torch.equal(emb.cpu().double(), twin["emb"])
                         and torch.equal(cand.cpu().double(), twin["cand"])),
         "scores": rel_err64(scores[:n], twin["scores"]),
         "scores_abs_mean": float(twin["scores"].abs().mean())}
    r["ok"] = r["emb_bitwise"] and r["scores"] <= RECSYS_TOL
    return r


def recsys_phase(kernels, dev, profile: bool) -> dict:
    """DeepFM's serve and retrieval steps at the full configuration (module
    docstring, phase 9); returns the table and the serve_bulk batch for the
    EmbeddingBag phase."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models.recsys import deepfm

    spec = get_arch("deepfm")
    cfg = spec.config
    bundles = {name: build_bundle(spec, name) for name in RECSYS_CELLS}
    log(f"recsys: {cfg.name} ({spec.source}): {cfg.n_sparse} fields x "
        f"{cfg.vocab_per_field} rows x {cfg.embed_dim}, {cfg.n_dense} dense, "
        f"MLP {cfg.n_sparse * cfg.embed_dim + cfg.n_dense}-"
        f"{'-'.join(map(str, cfg.mlp_dims))}-1, not cut; random weights "
        f"(seed {SEED})")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    params = bundles["serve_p99"].init_params(gen)
    # At init the first-order weights are zero, and the 0.01-scale table
    # makes the FM term about a tenth of the logits (0.0065 beside 0.07 in
    # mean magnitude, H100): the hold draws the first-order weights (and
    # the bias) at the table's scale, so that the lookups of lin_table are
    # read, and holds the FM term on its own.
    for name in ("lin_table", "lin_dense", "bias"):
        params[name].normal_(0.0, 0.01, generator=gen)
    torch.cuda.synchronize()
    leaves = [params[k] for k in ("table", "lin_table", "lin_dense", "bias")]
    leaves += [t for layer in params["mlp"] for t in layer.values()]
    log(f"recsys: table {tuple(params['table'].shape)} "
        f"({nbytes(params['table']) / 1e9:.3f} GB), lin_table "
        f"{nbytes(params['lin_table']) / 1e6:.1f} MB, "
        f"{sum(t.numel() for t in leaves)} weights drawn in "
        f"{time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    host = to_host64(params)
    log(f"recsys: f64 host twin of the weights in "
        f"{time.perf_counter() - t0:.1f} s")

    bulk = None
    for name, bundle in bundles.items():
        batch = bundle.make_batch(SEED)
        n_items = (bundle.shape.n_candidates if bundle.step_kind == "retrieval"
                   else bundle.shape.batch)
        unit = "candidates" if bundle.step_kind == "retrieval" else "examples"
        reset_counts(kernels)
        run_ms, outs = [], []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs.append(bundle.fn(params, batch))
            torch.cuda.synchronize()
            run_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {n: k.launches for n, k in kernels.items()}
        check(not any(counts.values()),
              f"recsys {name}: a kernel launched {counts}; DeepFM looks its "
              f"fields up with a row gather")
        out = outs[-1]
        check(out.shape == (n_items,), f"recsys {name}: {tuple(out.shape)}")
        check(torch.equal(outs[1], out), f"recsys {name}: runs 2 and 3 differ")
        check(bool(torch.isfinite(out).all()),
              f"recsys {name}: scores not finite")
        if bundle.step_kind == "serve":
            check(bool(((out >= 0) & (out <= 1)).all()),
                  f"recsys {name}: a score outside [0, 1]")
        log(f"recsys {name}: first run {run_ms[0]:.3f} ms; runs 2, 3 "
            f"{[round(t, 4) for t in run_ms[1:]]} ms = "
            f"{[round(n_items / (t / 1e3), 1) for t in run_ms[1:]]} "
            f"{unit}/s; launches {counts}")
        if profile:
            profile_run(f"recsys {name}", lambda: bundle.fn(params, batch))

        # run 3's own scores against the f64 twin
        n = RECSYS_HOLD[name]
        t0 = time.perf_counter()
        if bundle.step_kind == "serve":
            hold, twin = hold_serve, serve_twin(cfg, host, batch, n)
        else:
            hold, twin = hold_retrieval, retrieval_twin(cfg, host, batch, n)
        twin_s = time.perf_counter() - t0
        r = hold(cfg, params, batch, out, twin)
        del outs, out
        log(f"recsys {name} against the f64 CPU twin ({n} rows, "
            f"{twin_s:.1f} s): {r}; limits rel L2 {RECSYS_TOL}, FM {FM_TOL}")
        check(r["ok"], f"recsys {name} differs from its f64 CPU twin")
        # planted fault on the card: every field offset one row down (field
        # 0's id 0 reads row -1, the table's last, as torch indexing wraps it)
        offsets = deepfm.field_offsets
        deepfm.field_offsets = lambda c, device=None: offsets(c, device) - 1
        try:
            bad = hold(cfg, params, batch, bundle.fn(params, batch), twin)
        finally:
            deepfm.field_offsets = offsets
        log(f"recsys {name} planted fault (field offsets - 1): {bad}")
        check(not bad["ok"], f"recsys {name}: the hold passes field offsets "
                             f"one row off")
        if bundle.step_kind == "serve":     # planted: a lower precision
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                bad = hold(cfg, params, batch, bundle.fn(params, batch), twin)
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            log(f"recsys {name} planted fault (TF32 products): {bad}")
            check(not bad["ok"], f"recsys {name}: the hold passes TF32 "
                                 f"products")
        if name == "serve_bulk":
            bulk = batch
    del host
    return {"cfg": cfg, "table": params["table"], "bulk": bulk}


def sector_bytes(idx: torch.Tensor, table: torch.Tensor) -> int:
    """Bytes of the 32-byte sectors the valid slots' rows span, each row
    counted once a slot, from the table's own address."""
    row = table.shape[1] * table.element_size()
    start = table.data_ptr() + idx[idx >= 0].long() * row
    return 32 * int(((start + row - 1) // 32 - start // 32 + 1).sum())


def bag_phase(rec: dict, kernels, dev) -> dict:
    """Kernel A5 through the lookup op on DeepFM's table (module docstring,
    phase 10); returns A5's row of the kernels line."""
    import torch.nn.functional as F

    from repro_torch.kernels.embedding_bag import ops as bag_ops
    from repro_torch.kernels.embedding_bag.kernel import (
        _launch, embedding_bag_sum, embedding_bag_sum_plain)
    from repro_torch.kernels.embedding_bag.ref import bag_mean
    from repro_torch.models.recsys import deepfm

    cfg, table = rec["cfg"], rec["table"]

    def drive(what: str, calls: int, fn, route: str):
        """Reset the counts, run ``fn``, check that A5 and nothing else
        launched ``calls`` times, each on ``route``; returns fn's result
        and the counts."""
        reset_counts(kernels)
        out = fn()
        torch.cuda.synchronize()
        counts = {n: k.launches for n, k in kernels.items()}
        want = dict.fromkeys(kernels, 0) | {"embedding_bag_sum": calls}
        check(counts == want, f"A5 {what}: launches {counts}, not {want}")
        on_route = getattr(embedding_bag_sum, f"launches_{route}")
        check(on_route == calls, f"A5 {what}: {on_route} of {calls} launches "
                                 f"on the {route} route")
        return out, counts

    def max_err(got, want) -> float:
        return float((got.float() - want.float()).abs().max())

    def other_route(idx, tab, want, what: str) -> float:
        """The route the shape does not take, launched on ``idx`` over
        ``tab`` (gather where it takes the rows), held bitwise to the
        plain version's ``want``; returns its max abs error."""
        out = torch.empty_like(want)
        other = "gather" if _launch(idx, tab, out).route == "loads" else \
            "loads"
        out.zero_()
        _launch(idx, tab, out, other)
        check(torch.equal(out, want), f"A5 {what}: the {other} route differs "
                                      f"from the plain version")
        return max_err(out, want)

    def timings(idx, what: str, tab=table) -> dict:
        """The wrapper, its index check, the launch alone by the shape's
        route and by each route on ``idx`` over ``tab`` (each route's
        output held bitwise to the plain version), beside the useful-byte
        and the sector bounds."""
        want = embedding_bag_sum_plain(idx, tab)
        out = torch.empty_like(want)
        valid = int((idx >= 0).sum())
        useful = valid * tab.shape[1] * tab.element_size()
        b_ms, b_by = bound(useful + nbytes(idx, out))
        sector_ms, _ = bound(sector_bytes(idx, tab) + nbytes(idx, out))
        route = _launch(idx, tab, out).route
        t = {"route": route,
             "ms": timed_ms(lambda: embedding_bag_sum(idx, tab), 20),
             "check_ms": timed_ms(lambda: int(idx.max()), 20),
             "kernel_ms": timed_ms(lambda: _launch(idx, tab, out), 20)}
        for r in ("gather", "loads"):
            out.zero_()
            t[f"{r}_kernel_ms"] = timed_ms(lambda: _launch(idx, tab, out, r),
                                           20)
            check(torch.equal(out, want), f"A5 {what}: the {r} route differs "
                                          f"from the plain version")
        t |= {"bound_ms": b_ms, "bound_by": b_by,
              "sector_bound_ms": sector_ms, "valid_rows": valid}
        log(f"A5 {what}: wrapper {t['ms']} ms, index check {t['check_ms']} "
            f"ms, launch alone {t['kernel_ms']} ms ({route} route; gather "
            f"{t['gather_kernel_ms']} ms, plain loads {t['loads_kernel_ms']} "
            f"ms, each bitwise); bound {b_ms} ms ({b_by}, {valid} valid "
            f"rows), sector bound {sector_ms} ms")
        return t

    # (a) the serve_bulk batch's flat ids as bags: the op's main path
    emb, bags = deepfm._embed(cfg, {"table": table}, rec["bulk"]["sparse"])
    b, l = bags.shape
    calls = 3
    outs, counts = drive("(a) serve_bulk bags", calls,
                         lambda: [bag_ops.embedding_bag(bags, table)
                                  for _ in range(calls)], "gather")
    got = outs[-1]
    check(torch.equal(outs[1], got), "A5 (a): calls 2 and 3 differ")
    del outs
    want = embedding_bag_sum_plain(bags, table)
    errs = [max_err(got, want), other_route(bags, table, want, "(a)")]
    check(torch.equal(got, want), "A5 (a) differs from its plain version")
    # against the serve path's emb.sum(1), summed in another order: two
    # f32 sums of L terms differ by at most 2 (L - 1) eps sum |x|
    eps = float(torch.finfo(torch.float32).eps)
    gap = (got - emb.sum(dim=1)).abs()
    tol = 2 * (l - 1) * eps * emb.abs().sum(dim=1)
    log(f"A5 (a) bags {tuple(bags.shape)} over {tuple(table.shape)}: "
        f"bitwise to the plain version by both routes; against emb.sum(1): "
        f"max abs {float(gap.max())}, max share of the order bound "
        f"{float((gap / tol.clamp_min(1e-30)).max())}")
    check(bool((gap <= tol).all()), "A5 (a) differs from emb.sum(1) by more "
                                    "than the summation-order bound")
    del emb, gap, tol

    # (b) the same bags cut to ragged lengths 0..L (about 1 in L + 1 empty)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    lengths = torch.randint(0, l + 1, (b, 1), generator=gen, device=dev)
    slot = torch.arange(l, device=dev)[None, :]
    rag = torch.where(slot < lengths, bags, -1).to(torch.int32)
    (s_k, m_k), _ = drive("(b) ragged", 2, lambda: (
        bag_ops.embedding_bag(rag, table),
        bag_ops.embedding_bag(rag, table, mode="mean")), "gather")
    s_p = embedding_bag_sum_plain(rag, table)
    m_p = bag_mean(s_p, rag)
    empty = (lengths[:, 0] == 0)
    errs += [max_err(s_k, s_p), max_err(m_k, m_p),
             other_route(rag, table, s_p, "(b)")]
    check(torch.equal(s_k, s_p) and torch.equal(m_k, m_p),
          "A5 (b) differs from its plain version")
    check(not s_k[empty].any() and not m_k[empty].any(),
          "A5 (b): an all-padded bag is not zero")
    log(f"A5 (b) ragged: {int(empty.sum())} of {b} bags all padded "
        f"({100 * float(empty.float().mean()):.2f}%), "
        f"{int((rag >= 0).sum())} valid slots; sum and mean bitwise")
    del s_k, m_k, s_p, m_p

    # (c) bench_kernels' shape, f32 and bf16, and (d) bf16 with odd D: tables
    # the L2 holds, so the plain-load route (the gather held beside it)
    for what, dtype, d in (("(c)", torch.float32, 128),
                           ("(c)", torch.bfloat16, 128),
                           ("(d)", torch.bfloat16, 127)):
        t = torch.randn((10_000, d), generator=gen, device=dev).to(dtype)
        i = torch.randint(-1, 10_000, (256, 8), generator=gen, device=dev,
                          dtype=torch.int32)
        out, _ = drive(f"{what} {dtype}", 1, lambda: embedding_bag_sum(i, t),
                       "loads")
        plain = embedding_bag_sum_plain(i, t)
        errs.append(max_err(out, plain))
        check(torch.equal(out, plain),
              f"A5 {what} {dtype} differs from its plain version")
        if d % 2 == 0:
            errs.append(other_route(i, t, plain, f"{what} {dtype}"))
        log(f"A5 {what} {dtype} (256, 8) over (10000, {d}): plain loads "
            f"bitwise{', the gather too' if d % 2 == 0 else ''}")

    # timing on (a) and (b)
    geo = _launch(bags, table, torch.empty_like(got))
    log(f"A5 (a) geometry: {dataclasses.asdict(geo)}")
    t_a = timings(bags, "(a)")
    t_b = timings(rag, "(b) ragged")
    # two references on the same ids: one 32-byte sector a row, and the
    # table's first 100,000 rows, a 4 MB table the 50 MB L2 holds (the
    # plain-load route by the rule)
    sector_table = torch.randn((table.shape[0], 8), generator=gen,
                               device=dev)
    t_sector = timings(bags, "(a) over a (V, 8) f32 table", sector_table)
    del sector_table
    t_l2 = timings(torch.where(bags >= 0, bags % 100_000, bags),
                   "(a) ids mod 100,000 over the first 100,000 rows (a 4 MB "
                   "table)", table[:100_000])
    plain_ms = timed_ms(lambda: embedding_bag_sum_plain(bags, table), 3)
    # the one-call yardstick (timed here only; the port never calls it)
    idx64, weights = bags.clamp(min=0).long(), (bags >= 0).to(table.dtype)
    lib = lambda: F.embedding_bag(idx64, table, mode="sum",
                                  per_sample_weights=weights)
    lib_err = float((lib() - got).abs().max())
    library_ms = timed_ms(lib, 20)
    log(f"A5 (a): plain {plain_ms} ms, F.embedding_bag {library_ms} ms (max "
        f"abs err vs A5 {lib_err})")
    rest = lambda t: {k: v for k, v in t.items() if k != "bound_by"}
    return {
        "name": "embedding_bag_sum", "route": "cuda",
        "design": "persistent grid, indices and rows by cp.async into a "
                  "3-stage mbarrier ring, sum in slot order from shared "
                  "memory; plain loads for rows over 40 bytes and for 20- "
                  "to 40-byte rows of a table of at most 48 MiB",
        "source": "src/repro_torch/csrc/embedding_bag_kernels.cu",
        "replaces": "src/repro/kernels/embedding_bag/kernel.py:28",
        "launches": counts["embedding_bag_sum"], "max_abs_err": max(errs),
        "ms": t_a["ms"], "plain_ms": plain_ms, "bound_ms": t_a["bound_ms"],
        "bound_by": t_a["bound_by"], "library_ms": library_ms,
        "shape": f"bags {tuple(bags.shape)} int32 (serve_bulk flat ids) over "
                 f"the table {tuple(table.shape)} f32",
        "check_ms": t_a["check_ms"], "kernel_ms": t_a["kernel_ms"],
        "sector_bound_ms": t_a["sector_bound_ms"],
        "gather_kernel_ms": t_a["gather_kernel_ms"],
        "loads_kernel_ms": t_a["loads_kernel_ms"],
        "geometry": dataclasses.asdict(geo), "ragged": rest(t_b),
        "one_sector_rows": rest(t_sector), "l2_table": rest(t_l2)}


# ---------------------------------------------------------------------------
# path 10: DeepFM training through the train launcher
# ---------------------------------------------------------------------------

TRAIN_STEPS, TRAIN_CKPT_EVERY, TRAIN_FAULT_STEP = 20, 10, 12
TOPK_FRAC = 1 / 32
# (b) one f32 step on the card against the same step in f64 on the card,
# from (a)'s step-20 state: relative error of the loss and the grad norm,
# relative L2 of each leaf's update (new - old; ``update_errs``).  On an
# H100 the correct step reads at most 5.4e-4 (opt/v/mlp/0/w; the MLP's
# gradients sum 65,536 examples of random labels, which cancel, so f32's
# error grows about as sqrt(N)), the grad norm 1.6e-6; TF32 products read
# 0.035 and the bias correction dropped 0.097.  2^-8 sits 7.2 times above
# the worst correct reading and 8.8 times below TF32.
TRAIN_TOL = 2.0 ** -8


def _f64(tree):
    from repro_torch import tree as tr

    return tr.map_tree(lambda x: x.double() if x.is_floating_point() else x,
                       tree)


def update_errs(old, new32, new64) -> dict:
    """Relative L2 of each float leaf's f32 update against the f64 one:
    ``|new32 - round(new64)| / |new64 - old|``, where ``round`` stores the
    f64 result in the leaf's dtype (``old`` is exact in f64).  The f32
    rounding of the stored leaf, up to half an ulp of a parameter, is
    large beside an update of ``lr`` (6.3e-5 at step 21) times O(1) and is
    no error of the step; what stays is the step's arithmetic."""
    from repro_torch import tree as tr

    out = {}
    for (path, o), n32, n64 in zip(tr.leaves_with_paths(old),
                                   tr.leaves(new32), tr.leaves(new64)):
        if not o.is_floating_point():
            continue
        ref = n64.to(o.dtype).double()
        out[tr.key_of(path)] = float((n32.double() - ref).norm()
                                     / (n64 - o.double()).norm()
                                     .clamp_min(1e-300))
    return out


def hold_train_step(bundle, state, batch, state64, batch64, twin) -> dict:
    """One f32 train step against its f64 ``twin`` (new state, metrics):
    the loss and grad norm at relative error, each leaf's update at
    relative L2; ``ok`` when every reading is within TRAIN_TOL."""
    new, m = bundle.fn(state, batch)
    new64, m64 = twin
    r = {"loss": abs(float(m["loss"]) - float(m64["loss"]))
         / abs(float(m64["loss"])),
         "grad_norm": abs(float(m["grad_norm"]) - float(m64["grad_norm"]))
         / abs(float(m64["grad_norm"])),
         "updates": update_errs(state, new, new64)}
    r["worst_update"] = max(r["updates"].values())
    r["ok"] = max(r["loss"], r["grad_norm"], r["worst_update"]) <= TRAIN_TOL
    return r


def train_phase(kernels, dev, tmp: Path) -> dict:
    """DeepFM ``train_batch`` at full width (module docstring, path 10):
    (a) the launcher, (b) one step against its f64 twin with two planted
    faults, (c) the fault replay, (d) the compressed steps."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models.recsys import deepfm
    from repro_torch.optim import adamw
    from repro_torch.train import compress as comp
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import (Trainer, TrainerConfig,
                                           make_compressed_train_step)

    spec = get_arch("deepfm")
    cfg, shape = spec.config, get_shape(spec, "train_batch")
    opt_cfg = adamw.AdamWConfig(total_steps=TRAIN_STEPS)
    log(f"path 10: {cfg.name} train_batch ({spec.source}): {cfg.n_sparse} "
        f"fields x {cfg.vocab_per_field} rows x {cfg.embed_dim} f32, "
        f"{cfg.n_dense} dense, MLP {cfg.n_sparse * cfg.embed_dim + cfg.n_dense}"
        f"-{'-'.join(map(str, cfg.mlp_dims))}-1, batch {shape.batch}, not "
        f"cut; seed-{SEED} weights; AdamW {opt_cfg}; disk free "
        f"{shutil.disk_usage(tmp).free / 1e9:.1f} GB")
    out = {}

    # (a) the launcher: 20 steps, checkpoints at 10 and 20
    reset_counts(kernels)
    reset_peak()
    seen = {}
    argv = ["--arch", "deepfm", "--shape", "train_batch", "--steps",
            str(TRAIN_STEPS), "--ckpt-every", str(TRAIN_CKPT_EVERY),
            "--ckpt-dir", str(tmp / "a")]
    _, _, wall = run_launcher("path 10 (a) launch.train", train_launcher.main,
                              argv, on_trainer=lambda t: seen.update(t=t))
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()),
          f"path 10 (a): a kernel launched {counts}; DeepFM trains with a "
          f"row gather and the plain AdamW")
    tr_a = seen["t"]
    check(len(tr_a.step_times) == TRAIN_STEPS
          and not any("event" in m for m in tr_a.metrics_log),
          f"path 10 (a): not {TRAIN_STEPS} clean steps: {tr_a.metrics_log}")
    losses = [m["loss"] for m in tr_a.metrics_log if "loss" in m]
    check(all(math.isfinite(l) for l in losses), f"path 10 (a): {losses}")
    step_ms = float(np.median([dt for _, dt in tr_a.step_times[1:]])) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    saves = tr_a.mgr.saves
    ck_dir = tmp / "a" / f"step_{TRAIN_STEPS}"
    disk = sum(f.stat().st_size for f in ck_dir.iterdir())
    out["a"] = {"step_ms_median_2_20": step_ms,
                "step_ms_first": tr_a.step_times[0][1] * 1e3,
                "examples_per_s": shape.batch / (step_ms / 1e3),
                "peak_gib": peak, "losses": losses, "wall_s": wall,
                "saves": saves, "ckpt_files_bytes": disk}
    log(f"path 10 (a): step {step_ms} ms (median of steps 2-"
        f"{TRAIN_STEPS}; step 1 {out['a']['step_ms_first']} ms) = "
        f"{out['a']['examples_per_s']} examples/s; peak {peak:.3f} GiB; "
        f"losses {losses}; checkpoints {saves} ({disk} bytes of files at "
        f"step {TRAIN_STEPS}); no kernel launched")
    del seen, tr_a

    # (b) one step from (a)'s step-20 state against the f64 twin
    bundle = build_bundle(spec, "train_batch", device=dev, opt_cfg=opt_cfg)
    like = bundle.make_state(bundle.init_params(
        torch.Generator(device=dev).manual_seed(SEED)))
    mgr = CheckpointManager(str(tmp / "a"))
    t0 = time.perf_counter()
    state20, step = mgr.restore(like)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del like
    check(step == TRAIN_STEPS, f"path 10 (b): restored step {step}")
    batch = bundle.make_batch(SEED * 1_000_003 + TRAIN_STEPS)
    batch64 = _f64(batch)
    state64 = _f64(state20)
    reset_peak()
    twin = bundle.fn(state64, batch64)
    r = hold_train_step(bundle, state20, batch, state64, batch64, twin)
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    log(f"path 10 (b): restore of step {step} in {restore_s:.3f} s; the f32 "
        f"step against the f64 step (peak {peak_b:.3f} GiB): {r}; limit "
        f"{TRAIN_TOL}")
    check(r["ok"], "path 10 (b): the f32 train step differs from its f64 "
                   "twin")
    planted = {}
    real_bc = adamw.bias_correction
    adamw.bias_correction = lambda beta, s: torch.ones_like(s)
    try:
        planted["no_bias_correction"] = hold_train_step(
            bundle, state20, batch, state64, batch64, twin)
    finally:
        adamw.bias_correction = real_bc
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        planted["tf32_products"] = hold_train_step(
            bundle, state20, batch, state64, batch64, twin)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for name, bad in planted.items():
        log(f"path 10 (b) planted fault ({name}): worst update "
            f"{bad['worst_update']}, loss {bad['loss']}, grad_norm "
            f"{bad['grad_norm']}")
        check(not bad["ok"], f"path 10 (b): the hold passes {name}")
    out["b"] = {"restore_s": restore_s, "peak_gib": peak_b, "hold": r,
                "planted": {k: v["worst_update"] for k, v in planted.items()}}
    del state64, batch64, twin

    # (c) the fault contract: a fault at step 12, checkpoints every 10
    fired = {"n": 0}

    def fault(s):
        if s == TRAIN_FAULT_STEP and not fired["n"]:
            fired["n"] += 1
            raise RuntimeError("injected node failure")

    tcfg = TrainerConfig(num_steps=TRAIN_STEPS, ckpt_every=TRAIN_CKPT_EVERY,
                         ckpt_dir=str(tmp / "c"), keep=1, log_every=1)
    trainer = Trainer(bundle, tcfg, opt_cfg=opt_cfg, fault_hook=fault)
    t0 = time.perf_counter()
    final = trainer.run()
    wall_c = time.perf_counter() - t0
    events = [m for m in trainer.metrics_log if m.get("event") == "restart"]
    check(len(events) == 1 and events[0]["restored_step"] == TRAIN_CKPT_EVERY,
          f"path 10 (c): restarts {events}")
    last = [m["loss"] for m in trainer.metrics_log if "loss" in m][-1]
    want_last = out["a"]["losses"][-1]
    check(math.isclose(last, want_last, rel_tol=1e-5),
          f"path 10 (c): final loss {last}, the clean run's {want_last}")
    diff = max(float((a - b).abs().max()) for a, b in zip(
        tr.leaves(final["params"]), tr.leaves(state20["params"])))
    out["c"] = {"restarts": events, "final_loss": last,
                "clean_final_loss": want_last, "max_param_diff": diff,
                "wall_s": wall_c, "saves": trainer.mgr.saves}
    log(f"path 10 (c): one restart {events[0]}; final loss {last} (clean "
        f"run {want_last}); largest parameter difference from the clean "
        f"run {diff}; {wall_c:.1f} s; saves {trainer.mgr.saves}")
    del final, state20, trainer
    shutil.rmtree(tmp / "c")

    # (d) the compressed steps, three each, from the seed-0 weights
    loss_fn = lambda p, b: deepfm.loss_fn(cfg, p, b)      # noqa: E731
    out["d"] = {}
    for method in ("topk", "bf16"):
        make_state, step_fn = make_compressed_train_step(
            loss_fn, opt_cfg, method, TOPK_FRAC)
        st = make_state(bundle.init_params(
            torch.Generator(device=dev).manual_seed(SEED)))
        ls = []
        for i in range(3):
            st, m = step_fn(st, bundle.make_batch(SEED * 1_000_003 + i))
            ls.append(float(m["loss"]))
        check(all(math.isfinite(l) for l in ls),
              f"path 10 (d) {method}: losses {ls}")
        out["d"][method] = {"losses": ls}
        log(f"path 10 (d) {method}: losses {ls}")
        if method == "topk":
            grads, _ = torch.func.grad_and_value(loss_fn, has_aux=True)(
                st["params"], bundle.make_batch(SEED * 1_000_003 + 3))
            ef = st["ef"]
            sent, new_ef = comp.compress_topk(grads, ef, TOPK_FRAC)
            check(all(torch.equal(s + e, g.float() + f) for s, e, g, f in zip(
                tr.leaves(sent), tr.leaves(new_ef), tr.leaves(grads),
                tr.leaves(ef))), "path 10 (d): sent + new_ef != g + ef")
            flat = (grads["table"].float() + ef["table"]).reshape(-1).abs()
            n = flat.numel()
            k = max(1, int(n * TOPK_FRAC))
            thr = comp.topk_threshold(flat, k)
            kth = torch.kthvalue(flat, n - k + 1).values
            check(float(thr) == float(kth), f"path 10 (d): topk threshold "
                                            f"{float(thr)}, kthvalue "
                                            f"{float(kth)}")
            topk_ms = timed_ms(lambda: comp.topk_threshold(flat, k), 3)
            kth_ms = timed_ms(lambda: torch.kthvalue(flat, n - k + 1), 3)
            sent_n = int((sent["table"] != 0).sum())
            out["d"]["table_topk_ms"] = topk_ms
            out["d"]["table_kthvalue_ms"] = kth_ms
            out["d"]["wire_bytes"] = {mm: comp.wire_bytes(grads, mm,
                                                          TOPK_FRAC)
                                      for mm in ("none", "bf16", "topk")}
            log(f"path 10 (d): the table leaf ({n} entries, k = {k}): "
                f"the threshold by torch.topk {topk_ms} ms, by "
                f"torch.kthvalue {kth_ms} ms (equal), {sent_n} entries sent; sent + new_ef == g + ef on "
                f"every leaf; wire bytes {out['d']['wire_bytes']}")
            del grads, ef, sent, new_ef, flat
        del st
    return out


# ---------------------------------------------------------------------------
# path 11: gemma3-12b decode and serving
# ---------------------------------------------------------------------------

DECODE_MAX_LEN, DECODE_GREEDY = 32_768, 4
# (a) the decode step at per-sequence pos 8191 over a prefill's cache
# against the same prefill of the whole prompt: relative L2 of the logits.
# Over A4's cache against A4's prefill, an H100 reads 0.0180 (the prefill
# phase's A4-vs-plain reads 0.0184): one position's bf16 arithmetic through
# 12 layers, summed in another order, differs that much.  Every local
# window one key off reads 0.0345 and 0.0423, so 0.025 (the geometric
# middle) parts them by 1.4 either way.  The sharp gate is the same check
# in f32 (the weights cast, the plain prefill): 6.0e-6 on an H100, the
# faults 0.0283 and 0.0369; 2^-12 sits 40 times above the one and 116
# times below the others.
DECODE_TOL = 0.025
DECODE_F32_TOL = 2.0 ** -12
SERVE_ARGV = ["--arch", "gemma3_12b", "--requests", "8", "--slots", "4",
              "--max-len", "2048", "--max-new-tokens", "64"]


def decode_phase(kernels, dev) -> dict:
    """gemma3-12b decode (module docstring, path 11): (a) at the prefill
    phase's cut against the A4 prefill, with a planted window fault; (b)
    the serve launcher at full depth."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models import transformer as tf
    from repro_torch.serve.batcher import Request, Server

    spec = get_arch("gemma3_12b")
    full = spec.config
    cfg = dataclasses.replace(full, n_layers=PREFILL_LAYERS)
    cut = dataclasses.replace(spec, config=cfg)
    dshape = dataclasses.replace(get_shape(spec, "decode_32k"),
                                 global_batch=PREFILL_BATCH)
    pshape = dataclasses.replace(get_shape(spec, "prefill_32k"),
                                 seq_len=PREFILL_SEQ,
                                 global_batch=PREFILL_BATCH)
    log(f"path 11 (a): {full.name} decode_32k, cut as the prefill phase: "
        f"layers {full.n_layers} -> {cfg.n_layers}, batch "
        f"{get_shape(spec, 'decode_32k').global_batch} -> "
        f"{dshape.global_batch}; cache depth {dshape.seq_len} (not cut); "
        f"prompt {PREFILL_SEQ - 1} tokens then one decode step at pos "
        f"{PREFILL_SEQ - 1}")
    bundle = build_bundle(cut, dshape, device=dev)
    prefill = build_bundle(cut, pshape, device=dev)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(SEED))
    tokens = prefill.make_batch(SEED)["tokens"]          # (2, 8192)
    b, s = tokens.shape
    reset_counts(kernels)
    reset_peak()
    want, full_cache = prefill.fn(params, {"tokens": tokens})
    del full_cache
    _, cache, _ = tf.prefill(cfg, params, tokens[:, :-1], DECODE_MAX_LEN)
    torch.cuda.synchronize()
    a4 = kernels["flash_attention"].launches
    check(a4 == 2 * cfg.n_layers, f"path 11 (a): A4 launched {a4} times in "
                                  f"two prefills of {cfg.n_layers} layers")
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    batch = {"cache": cache, "pos": pos, "last_token": tokens[:, -1]}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = bundle.fn(params, batch)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    check(kernels["flash_attention"].launches == a4,
          "path 11 (a): the decode step launched A4")
    check(logits.shape == (b, cfg.vocab)
          and bool(torch.isfinite(logits).all()), "path 11 (a): logits")
    rel = rel_err(logits, want)
    top = want.float().topk(2, dim=-1).values
    agree = bool((logits.argmax(-1) == want.argmax(-1)).all())
    log(f"path 11 (a): decode at pos {s - 1} against the A4 prefill of "
        f"{s} tokens: rel L2 {rel} (limit {DECODE_TOL}; the prefill "
        f"phase's A4-vs-plain limit {PREFILL_TOL}); argmax agree {agree}; "
        f"top-2 margins {(top[:, 0] - top[:, 1]).tolist()}; first step "
        f"{first_ms:.3f} ms")
    check(rel <= DECODE_TOL, "path 11 (a): decode differs from the prefill")
    scalar, cache = bundle.fn(params, {**batch, "pos": torch.tensor(
        s - 1, dtype=torch.int32, device=dev)})
    check(torch.equal(scalar, logits), "path 11 (a): the scalar position "
                                       "differs from the per-sequence one")
    # greedy decoding on from the decode step
    tok, steps_ms, greedy = logits.argmax(-1), [], []
    for i in range(DECODE_GREEDY):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = bundle.fn(params, {"cache": cache, "pos": pos + 1 + i,
                                        "last_token": tok})
        tok = nxt.argmax(-1)
        greedy.append(tok.tolist())
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(nxt).all()), "path 11 (a): greedy logits")
    log(f"path 11 (a): greedy tokens {greedy}; ms a decode step (12 "
        f"layers, batch {b}, a {DECODE_MAX_LEN}-deep cache) {steps_ms}")
    # planted: every local window one key off, in the decode step alone
    # (it rewrites row s - 1 of the cache and reads no later row)
    bad = {}
    for delta in (-1, 1):
        got, cache = tf.decode_step(shifted_windows(cfg, delta), params,
                                    cache, pos, tokens[:, -1])
        bad[delta] = rel_err(got, want)
    log(f"path 11 (a) planted fault (local windows one key off): rel L2 "
        f"{bad}")
    check(min(bad.values()) > DECODE_TOL,
          "path 11 (a): the check passes a window one key off")
    launches_a = kernels["flash_attention"].launches
    del cache, want, logits, scalar, nxt, batch
    # the f32 route: the same weights in f32, the plain attention's
    # prefill (f32 softmax, as the decode attention's; allow_tf32 is off),
    # where no bf16 rounding hides a fault
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = tf.Transformer.from_tree(tr.map_tree(
        lambda t: t.detach().float(), params.tree()))
    del params
    want32, _, _ = tf.prefill(cfg32, params32, tokens, s, use_kernel=False)
    _, cache, _ = tf.prefill(cfg32, params32, tokens[:, :-1], DECODE_MAX_LEN,
                             use_kernel=False)
    got32, cache = tf.decode_step(cfg32, params32, cache, pos, tokens[:, -1])
    rel32 = rel_err(got32, want32)
    bad32 = {}
    for delta in (-1, 1):
        got, cache = tf.decode_step(shifted_windows(cfg32, delta), params32,
                                    cache, pos, tokens[:, -1])
        bad32[delta] = rel_err(got, want32)
    log(f"path 11 (a) in f32: decode against the plain prefill rel L2 "
        f"{rel32} (limit {DECODE_F32_TOL}); local windows one key off "
        f"{bad32}")
    check(rel32 <= DECODE_F32_TOL,
          "path 11 (a): the f32 decode differs from the f32 prefill")
    check(min(bad32.values()) > DECODE_F32_TOL,
          "path 11 (a): the f32 check passes a window one key off")
    check(kernels["flash_attention"].launches == launches_a,
          "path 11 (a): the f32 route launched A4")
    peak_a = torch.cuda.max_memory_allocated() / 2**30
    out = {"a": {"rel_l2": rel, "planted": bad, "f32_rel_l2": rel32,
                 "f32_planted": bad32, "first_ms": first_ms,
                 "step_ms": steps_ms, "peak_gib": peak_a,
                 "a4_launches": launches_a}}
    del params32, cache, want32, got32, got

    # (b) the serve launcher at full depth
    reset_counts(kernels)
    reset_peak()
    seen = {}
    _, text, wall = run_launcher(
        "path 11 (b) launch.serve", serve_launcher.main, SERVE_ARGV,
        on_done=lambda srv, done, secs: seen.update(srv=srv, done=done,
                                                    secs=secs))
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()), f"path 11 (b): a kernel launched "
                                    f"{counts}; the server decodes only")
    srv, done = seen["srv"], sorted(seen["done"], key=lambda r: r.rid)
    check(len(done) == 8 and all(len(r.out) == 64 for r in done),
          f"path 11 (b): {[len(r.out) for r in done]} tokens")
    n_steps = srv.decode_steps
    ms_step = seen["secs"] * 1e3 / n_steps
    peak_b = torch.cuda.max_memory_allocated() / 2**30
    log(f"path 11 (b): {full.n_layers} layers; {srv.decode_steps} decode "
        f"steps (batch {srv.n_slots}, a {srv.max_len}-deep cache) in "
        f"{seen['secs']:.3f} s = {ms_step:.3f} ms a step; peak "
        f"{peak_b:.3f} GiB")
    # the first request served alone: the same tokens
    params = srv.params
    alone = Server(full, params, batch_slots=srv.n_slots,
                   max_len=srv.max_len)
    again = Request(rid=0, prompt=done[0].prompt,
                    max_new_tokens=done[0].max_new_tokens)
    alone.submit(again)
    alone.run_until_drained()
    check(again.out == done[0].out, "path 11 (b): request 0 alone gives "
                                    "other tokens than in the batch")
    del alone, srv, seen
    # each first token against the A4 prefill of the sequence the server
    # fed (the prompt, then its last token again: slot-local prefill)
    seqs = torch.from_numpy(np.stack([np.concatenate(
        [r.prompt, r.prompt[-1:]]) for r in done])).to(dev)
    pre, _, _ = tf.prefill(full, params, seqs, seqs.shape[1])
    n_a4 = kernels["flash_attention"].launches
    check(n_a4 == full.n_layers, f"path 11 (b): A4 launched {n_a4} times in "
                                 f"a {full.n_layers}-layer prefill")
    # the same sequences streamed through decode: the drift a row
    dcache = tf.init_cache(full, len(done), seqs.shape[1], device=dev)
    for j in range(seqs.shape[1]):
        dec, dcache = tf.decode_step(full, params, dcache, j, seqs[:, j])
    del dcache
    drift = (dec.float() - pre.float()).abs().amax(-1)
    top = pre.float().topk(2, dim=-1)
    margin = top.values[:, 0] - top.values[:, 1]
    clear = margin > 2 * drift
    first = torch.tensor([r.out[0] for r in done], device=dev)
    ok = bool(((first == top.indices[:, 0]) | ~clear).all())
    log(f"path 11 (b): first tokens {first.tolist()}, prefill argmax "
        f"{top.indices[:, 0].tolist()}; top-2 margins {margin.tolist()}; "
        f"drift (max |decode - prefill| a row) {drift.tolist()}; "
        f"{int(clear.sum())} of {len(done)} rows with a margin above twice "
        f"the drift, each equal")
    check(ok and bool(clear.any()), "path 11 (b): a first token differs "
          "from the prefill's argmax where the margin exceeds the drift, or "
          "no margin does")
    out["b"] = {"run_line": text.strip().splitlines()[-1],
                "decode_steps": n_steps, "ms_per_step": ms_step,
                "seconds": wall, "peak_gib": peak_b,
                "clear_rows": int(clear.sum()), "a4_launches": n_a4}
    return out


# ---------------------------------------------------------------------------
# path 12: gemma3-12b training at full width
# ---------------------------------------------------------------------------

LM_TRAIN_LAYERS, LM_TRAIN_BATCH, LM_TRAIN_STEPS = 6, 4, 5
LM_SERVE_STEPS = 4
# (b) the flash-train Function against autograd through the plain masked
# softmax, f32, TF32 off: relative L2 of out, dq, dk and dv.  On an H100
# the correct route reads at most 5.4e-7 (out, window 0), a window one key
# off at least 0.0182 (out) and the causal mask dropped 0.88; 2^-13 sits
# 226 times above the one and 149 times below the other.
FLASH_TOL = 2.0 ** -13
# (c) the bf16 step against the same step in f32 (the weights upcast),
# batch 1: relative error of the loss, relative L2 of each gradient leaf.
# On an H100 the correct step reads 2.2e-5 on the loss and at most 0.0259
# on a leaf (blocks/3/attn/wk); the labels one position on read 1.40 and
# a local layer given the global window 1.06 (on other layers' leaves).
# 2^-3 sits 4.8 times above the one and 8.5 times below the other.
STEP_TOL = 2.0 ** -3
# (d) microbatches 2 against 1 on one batch of 4: the loss (f32 sums in
# another order; an H100 reads 7.3e-8) and the grad norm (two bf16
# gradients summed in f32 against one bf16 gradient: 1.4e-5).
MICRO_LOSS_TOL, MICRO_NORM_TOL = 2.0 ** -16, 2.0 ** -12


def lm_state_bytes(cfg) -> int:
    """Bytes of a train state: the parameters, f32 m and v, the step."""
    itemsize = {"bfloat16": 2, "float32": 4}[cfg.dtype]
    return cfg.param_count() * (itemsize + 8) + 4


def host_bytes_available() -> int:
    """MemAvailable of /proc/meminfo, in bytes."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemAvailable:"):
            return int(line.split()[1]) * 1024
    raise RuntimeError("no MemAvailable in /proc/meminfo")


def plain_attention(q, k, v, causal: bool, window: int):
    """Softmax over the masked (Sq, Skv) scores in f32: the reference the
    flash-train route is held to, differentiated by autograd."""
    b, hq, s, dh = q.shape
    hkv = k.shape[1]
    qg = q.reshape(b, hkv, hq // hkv, s, dh)
    sc = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * dh ** -0.5
    i = torch.arange(s, device=q.device)
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= i[:, None] >= i[None, :]
    if window > 0:
        mask &= (i[:, None] - i[None, :]) < window
    p = sc.masked_fill(~mask, float("-inf")).softmax(-1)
    return torch.einsum("bhgqk,bhkd->bhgqd", p, v).reshape(b, hq, s, dh)


def attn_with_grads(fn, q, k, v, do):
    """(out, dq, dk, dv) of ``fn(q, k, v)`` against the cotangent do."""
    q, k, v = (x.detach().requires_grad_() for x in (q, k, v))
    out = fn(q, k, v)
    grads = torch.autograd.grad(out, (q, k, v), do)
    return (out.detach(), *grads)


def attn_errs(got, want) -> dict:
    return {n: rel_err(a, b) for n, a, b in zip(("out", "dq", "dk", "dv"),
                                                 got, want)}


def leaf_errs(got: list, want: list, paths: list) -> dict:
    """Relative L2 error of each gradient leaf, by its key."""
    return {key: rel_err(a, b) for key, a, b in zip(paths, got, want)}


def lm_train_phase(kernels, dev, tmp: Path, profile: bool) -> dict:
    """gemma3-12b ``train_4k`` at full width, 6 layers, batch 4 (module
    docstring, path 12): (a) the Trainer, its checkpoint restored
    bitwise; (e) the trained state served; (b) the flash-train attention
    held to the plain softmax; (c) the bf16 step held to f32; (d) remat
    and microbatches."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import steps
    from repro_torch.layers.core import flash_train
    from repro_torch.models import transformer as tf
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.checkpoint import CheckpointManager
    from repro_torch.train.trainer import Trainer, TrainerConfig

    spec = get_arch("gemma3_12b")
    full, full_shape = spec.config, get_shape(spec, "train_4k")
    cfg = dataclasses.replace(full, n_layers=LM_TRAIN_LAYERS)
    cut = dataclasses.replace(spec, config=cfg)
    shape = dataclasses.replace(full_shape, global_batch=LM_TRAIN_BATCH)
    opt_cfg = AdamWConfig(warmup_steps=1, total_steps=LM_TRAIN_STEPS)
    state_bytes = lm_state_bytes(cfg)
    host = host_bytes_available()
    disk = shutil.disk_usage(tmp).free
    log(f"path 12: {full.name} train_4k ({spec.source}): d {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}, untied, windows "
        f"{sorted({sp.window for sp in cfg.pattern})}, remat {cfg.remat}, "
        f"attn_chunk {cfg.attn_chunk}, loss chunk 512; cut: layers "
        f"{full.n_layers} -> {cfg.n_layers} (one pattern group), batch "
        f"{full_shape.global_batch} -> {shape.global_batch}; seq "
        f"{shape.seq_len} (not cut); {cfg.param_count()} parameters, a "
        f"{state_bytes}-byte train state; host memory available {host} "
        f"bytes, disk free {disk} bytes; device memory held before the "
        f"path {torch.cuda.memory_allocated()} bytes")
    check(host > 1.2 * state_bytes,
          f"path 12: {host} bytes of host memory cannot hold a checkpoint "
          f"snapshot of {state_bytes} bytes")
    check(disk > 1.1 * state_bytes,
          f"path 12: {disk} bytes of free disk cannot hold a checkpoint of "
          f"{state_bytes} bytes")
    out = {}

    # (a) the Trainer, 5 steps on one fixed batch, a checkpoint at the last
    bundle = steps.build_bundle(cut, shape, device=dev, opt_cfg=opt_cfg)
    fixed = bundle.make_batch(SEED)
    bundle = dataclasses.replace(bundle, make_batch=lambda seed=0: fixed)
    tcfg = TrainerConfig(num_steps=LM_TRAIN_STEPS, ckpt_every=LM_TRAIN_STEPS,
                         keep=1, log_every=1, ckpt_dir=str(tmp / "a"),
                         seed=SEED)
    trainer = Trainer(bundle, tcfg, opt_cfg=opt_cfg)
    reset_counts(kernels)
    reset_peak()
    t0 = time.perf_counter()
    state = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()), f"path 12 (a): a kernel launched "
          f"{counts}; the train step's attention is flash_train, not A4")
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    check(len(trainer.step_times) == LM_TRAIN_STEPS
          and len(losses) == LM_TRAIN_STEPS, f"path 12 (a): not "
          f"{LM_TRAIN_STEPS} clean steps: {trainer.metrics_log}")
    want0 = math.log(cfg.vocab) + 0.5
    check(abs(losses[0] - want0) <= 0.1, f"path 12 (a): first loss "
          f"{losses[0]}, not within 0.1 of ln V + 1/2 = {want0}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"path 12 (a): the loss does not fall at every step: {losses}")
    check(all(bool(torch.isfinite(t).all()) for t in tr.leaves(state)
              if t.is_floating_point()), "path 12 (a): a non-finite leaf")
    step_ms = float(np.median([dt for _, dt in trainer.step_times[1:]])) * 1e3
    tokens = shape.global_batch * shape.seq_len
    save = trainer.mgr.saves[-1]
    log(f"path 12 (a): losses {losses}; step {step_ms} ms (median of steps "
        f"2-{LM_TRAIN_STEPS}; step 1 {trainer.step_times[0][1] * 1e3} ms) = "
        f"{tokens / (step_ms / 1e3)} tokens/s; peak {peak:.3f} GiB; the "
        f"trainer's wall {wall:.1f} s; A4 launched 0 times; save {save}")
    # the checkpoint, restored to the host and held to the state bitwise
    like = tr.map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype), state)
    t0 = time.perf_counter()
    restored, step = CheckpointManager(str(tmp / "a")).restore(like)
    restore_s = time.perf_counter() - t0
    check(step == LM_TRAIN_STEPS, f"path 12 (a): restored step {step}")
    same = all(torch.equal(r.to(dev), s) for r, s in zip(
        tr.leaves(restored), tr.leaves(state)))
    check(same, "path 12 (a): the restored checkpoint differs from the "
                "state")
    restored_bytes = sum(nbytes(t) for t in tr.leaves(restored))
    log(f"path 12 (a): step {step} restored to the host in {restore_s:.3f} "
        f"s ({restored_bytes} bytes), every leaf bitwise the state's")
    del like, restored
    shutil.rmtree(tmp / "a")
    if profile:                  # one more step: the state moves on to 6
        profile_run("path 12 (a) train step",
                    lambda: bundle.fn(state, fixed))
    out["a"] = {"losses": losses, "step_ms_median_2_5": step_ms,
                "step_ms_first": trainer.step_times[0][1] * 1e3,
                "tokens_per_s": tokens / (step_ms / 1e3), "peak_gib": peak,
                "wall_s": wall, "save": save, "restore_s": restore_s,
                "restore_bytes": restored_bytes}
    params = state["params"]
    del state, trainer, bundle

    # (e) the trained state serves: A4's prefill, then greedy decode steps
    model = tf.Transformer.from_tree(params)
    prompt = fixed["tokens"][:, :shape.seq_len]
    reset_counts(kernels)
    reset_peak()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache, pos = tf.prefill(cfg, model, prompt,
                                    shape.seq_len + LM_SERVE_STEPS)
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    finite = bool(torch.isfinite(logits).all())
    tok, greedy = logits.argmax(-1), []
    for i in range(LM_SERVE_STEPS):
        logits, cache = tf.decode_step(cfg, model, cache, pos + i, tok)
        tok = logits.argmax(-1)
        greedy.append(tok.tolist())
        finite = finite and bool(torch.isfinite(logits).all())
    a4 = kernels["flash_attention"].launches
    log(f"path 12 (e): the trained params served: A4 prefill of "
        f"{tuple(prompt.shape)} tokens {prefill_ms:.3f} ms, A4 launched "
        f"{a4} times, {LM_SERVE_STEPS} greedy tokens {greedy}, logits "
        f"finite {finite}")
    check(finite, "path 12 (e): non-finite logits")
    check(a4 == cfg.n_layers, f"path 12 (e): A4 launched {a4} times in a "
                              f"{cfg.n_layers}-layer prefill")
    out["e"] = {"a4_launches": a4, "prefill_ms": prefill_ms,
                "greedy": greedy}
    del model, params, cache, logits, fixed, prompt

    # (b) the flash-train attention at full head dims against the plain
    # masked softmax, f32, with planted faults
    gen = torch.Generator(device=dev).manual_seed(SEED)
    s, dh = shape.seq_len, cfg.head_dim
    q = torch.randn((1, cfg.n_heads, s, dh), generator=gen, device=dev)
    k = torch.randn((1, cfg.n_kv_heads, s, dh), generator=gen, device=dev)
    v = torch.randn((1, cfg.n_kv_heads, s, dh), generator=gen, device=dev)
    do = torch.randn(q.shape, generator=gen, device=dev)
    reset_peak()
    out["b"] = {}
    for window in sorted({sp.window for sp in cfg.pattern}, reverse=True):
        ref = attn_with_grads(lambda a, b_, c: plain_attention(
            a, b_, c, True, window), q, k, v, do)
        got = attn_with_grads(lambda a, b_, c: flash_train(
            a, b_, c, True, window, cfg.attn_chunk), q, k, v, do)
        errs = attn_errs(got, ref)
        faults = {"causal mask dropped": (False, window)}
        if window > 0:
            faults.update({f"window {window + d}": (True, window + d)
                           for d in (-1, 1)})
        bad = {}
        for name, (causal, w) in faults.items():
            bad[name] = attn_errs(attn_with_grads(
                lambda a, b_, c: flash_train(a, b_, c, causal, w,
                                             cfg.attn_chunk),
                q, k, v, do), ref)
        flash_ms = timed_ms(lambda: attn_with_grads(
            lambda a, b_, c: flash_train(a, b_, c, True, window,
                                         cfg.attn_chunk), q, k, v, do), 3)
        plain_ms = timed_ms(lambda: attn_with_grads(
            lambda a, b_, c: plain_attention(a, b_, c, True, window),
            q, k, v, do), 3)
        log(f"path 12 (b) window {window}: flash_train against the plain "
            f"softmax, rel L2 {errs} (limit {FLASH_TOL}); planted faults "
            f"{bad}; forward + backward {flash_ms} ms, the plain softmax "
            f"{plain_ms} ms (B 1, Hq {cfg.n_heads}, Hkv {cfg.n_kv_heads}, "
            f"S {s}, Dh {dh}, chunk {cfg.attn_chunk}, f32)")
        check(max(errs.values()) <= FLASH_TOL,
              f"path 12 (b): flash_train differs at window {window}")
        for name, e in bad.items():
            check(max(e.values()) > FLASH_TOL,
                  f"path 12 (b): the hold passes {name}")
        out["b"][window] = {"rel_l2": errs, "planted": {
            n: max(e.values()) for n, e in bad.items()},
            "flash_ms": flash_ms, "plain_ms": plain_ms}
        del ref, got
    out["b"]["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    del q, k, v, do

    # (c) the bf16 step against the same step in f32, batch 1, no
    # optimizer state; planted faults in the bf16 step
    tree = tf.init_tree(cfg, torch.Generator(device=dev).manual_seed(SEED))
    paths = [tr.key_of(p) for p, _ in tr.leaves_with_paths(tree)]
    tokens1 = steps.build_bundle(cut, dataclasses.replace(
        shape, global_batch=1), device=dev).make_batch(SEED + 1)["tokens"]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    reset_peak()
    g32, (l32, _) = steps.autograd_grads(lambda p, t: tf.lm_loss(
        cfg32, p, t))(tr.map_tree(lambda t: t.float(), tree), tokens1)

    def bf16_step(cfg_):
        g, (loss, _) = steps.autograd_grads(lambda p, t: tf.lm_loss(
            cfg_, p, t))(tree, tokens1)
        errs = leaf_errs(g, g32, paths)
        return {"loss": abs(float(loss) - float(l32)) / abs(float(l32)),
                "worst_leaf": max(errs.values()),
                "worst_key": max(errs, key=errs.get), "leaves": errs}

    r = bf16_step(cfg)
    peak_c = torch.cuda.max_memory_allocated() / 2**30
    bad = {}
    real_nll = tf._chunk_nll         # planted: each label one position on
    tf._chunk_nll = lambda h, lab, head: real_nll(h, torch.roll(lab, 1, 1),
                                                  head)
    try:
        bad["labels shifted by one"] = bf16_step(cfg)
    finally:
        tf._chunk_nll = real_nll
    bad["local layer 0 given the global window"] = bf16_step(
        dataclasses.replace(cfg, pattern=(dataclasses.replace(
            cfg.pattern[0], window=0),) + cfg.pattern[1:]))
    log(f"path 12 (c): the bf16 step against f32 (batch 1): loss {float(l32)}"
        f" (f32), rel err {r['loss']}, worst gradient leaf {r['worst_key']} "
        f"{r['worst_leaf']} (limit {STEP_TOL}); every leaf {r['leaves']}; "
        f"peak {peak_c:.3f} GiB")
    for name, b in bad.items():
        log(f"path 12 (c) planted fault ({name}): loss {b['loss']}, worst "
            f"leaf {b['worst_key']} {b['worst_leaf']}")
    check(max(r["loss"], r["worst_leaf"]) <= STEP_TOL,
          "path 12 (c): the bf16 step differs from the f32 step")
    for name, b in bad.items():
        check(max(b["loss"], b["worst_leaf"]) > STEP_TOL,
              f"path 12 (c): the hold passes {name}")
    out["c"] = {"loss_rel": r["loss"], "worst_leaf": r["worst_leaf"],
                "worst_key": r["worst_key"], "peak_gib": peak_c,
                "planted": {n: b["worst_leaf"] for n, b in bad.items()}}
    del g32

    # (d) remat none / block / dots at batch 2: the same gradients, each
    # policy's peak; then microbatches 2 against 1 at batch 4
    tokens2 = steps.build_bundle(cut, dataclasses.replace(
        shape, global_batch=2), device=dev).make_batch(SEED + 2)["tokens"]
    out["d"] = {"remat": {}}
    base = None
    for remat in ("none", "block", "dots"):
        cfg_r = dataclasses.replace(cfg, remat=remat)
        reset_peak()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        g, (loss, _) = steps.autograd_grads(lambda p, t: tf.lm_loss(
            cfg_r, p, t))(tree, tokens2)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        peak_r = torch.cuda.max_memory_allocated()
        row = {"peak_gib": peak_r / 2**30,
               "peak_over_held_gib": (peak_r - held) / 2**30,
               "loss": float(loss), "ms": ms}
        if base is None:
            base = (g, loss)
        else:
            row["bitwise"] = torch.equal(loss, base[1]) and all(
                torch.equal(a, b) for a, b in zip(g, base[0]))
            check(row["bitwise"], f"path 12 (d): remat {remat} gradients "
                                  f"differ from none's")
        out["d"]["remat"][remat] = row
        log(f"path 12 (d) remat {remat} (batch 2): {row}")
        del g
    del base, tree
    mb = {}
    for n_micro in (1, 2):
        b = steps.build_bundle(cut, shape, device=dev, opt_cfg=opt_cfg,
                               microbatches=n_micro)
        st = b.make_state(b.init_params(
            torch.Generator(device=dev).manual_seed(SEED)))
        reset_peak()
        st, m = b.fn(st, b.make_batch(SEED))
        mb[n_micro] = {"loss": float(m["loss"]),
                       "grad_norm": float(m["grad_norm"]),
                       "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
        del st, b
    rel_loss = abs(mb[2]["loss"] - mb[1]["loss"]) / mb[1]["loss"]
    rel_gn = abs(mb[2]["grad_norm"] - mb[1]["grad_norm"]) / mb[1]["grad_norm"]
    log(f"path 12 (d) microbatches (batch {shape.global_batch}): {mb}; loss "
        f"rel {rel_loss} (limit {MICRO_LOSS_TOL}), grad norm rel {rel_gn} "
        f"(limit {MICRO_NORM_TOL})")
    check(rel_loss <= MICRO_LOSS_TOL and rel_gn <= MICRO_NORM_TOL,
          "path 12 (d): microbatches 2 differ from 1")
    out["d"]["microbatches"] = {**mb, "loss_rel": rel_loss,
                                "grad_norm_rel": rel_gn}
    return out


# ---------------------------------------------------------------------------
# path 13: the GNN family trained at full width
# ---------------------------------------------------------------------------

GNN_STEPS, GNN_LAUNCH_STEPS, SAMPLER_BATCHES = 5, 3, 2
# (d): ogb_products' nodes divided by GRAPHCAST_CUT (a power of two: the
# least whose global step peaks under 60 GiB), at its degree (61,859,140
# directed edges over 2,449,029 nodes), over GRAPHCAST_SHARDS shards
GRAPHCAST_CUT, GRAPHCAST_DEGREE, GRAPHCAST_SHARDS = 64, 25.26, 4
# (a)-(c): one f32 step on the card against the same step in f64 on the
# card (weights and batch cast): relative error of the loss, relative L2
# of each gradient leaf, by arch.  On an H100 (700 W; three runs; the
# atomic adds of index_add round in another order each run) gcn_cora
# reads 4.3e-7 to 3.6e-6 (layers/0/0/w) and its dst fault 0.23;
# gatedgcn, 16 layers of gates and norms, 2.5e-4 to 3.0e-4
# (layers/0/A/0/w: f32's cancellation; the CPU's f32 against f64 reads
# 1.2e-3 on a 4-layer cut) and its fault 0.44; schnet 1.6e-6 to 2.1e-6
# (out/1/b) and its fault 0.90.  2^-12 sits 67 times above gcn_cora's
# worst reading and 940 below its fault; 2^-9 6.4 times above
# gatedgcn's and 225 below; 2^-15 15 times above schnet's and 30,000
# below.
GNN_TOL = {"gcn_cora": 2.0 ** -12, "gatedgcn": 2.0 ** -9,
           "schnet": 2.0 ** -15}
# (d): JAX's own limits for owner-exchange GraphCast against the global
# model (tests/helpers/owner_gnn.py): the loss, and the enc_h and dec
# gradients element by element
OWNER_LOSS_TOL = {"rtol": 2e-5, "atol": 2e-5}
OWNER_GRAD_TOL = {"rtol": 5e-4, "atol": 5e-5}


def gnn_grads(cfg, params, batch):
    """(gradients in leaf order, loss) of the GNN family's loss, by the
    bundle's route (``autograd_grads``)."""
    from repro_torch.launch.steps import autograd_grads
    from repro_torch.models.gnn import models as gm

    grads, (loss, _) = autograd_grads(
        lambda p, b: gm.loss_fn(cfg, p, b))(params, batch)
    return grads, loss


def dst_one_on(batch: dict) -> dict:
    """The planted fault: every valid edge's destination one node on."""
    dst = batch["edge_dst"]
    n = batch["node_feats"].shape[0]
    return {**batch, "edge_dst": torch.where(dst >= 0, (dst + 1) % n, dst)}


def grad_errs(paths, grads, loss, want, want_loss) -> dict:
    """Relative error of the loss and relative L2 of each gradient leaf
    against ``want`` (an all-zero leaf, which the loss does not reach, by
    its absolute L2)."""
    leaves = {}
    for key, g, w in zip(paths, grads, want):
        ref = w.norm()
        diff = (g.to(w.dtype) - w).norm()
        leaves[key] = float(diff / ref if ref > 0 else diff)
    worst = max(leaves, key=leaves.get)
    return {"loss": abs(float(loss) - float(want_loss)) / abs(float(want_loss)),
            "worst_leaf": leaves[worst], "worst_key": worst}


def hold_gnn(label: str, cfg, params, batch, arch_id: str) -> dict:
    """The f32 loss and gradients against the same step in f64 on the
    card, within GNN_TOL[arch_id], every value finite; the planted fault
    (dst one node on) against the same twin must fail the limit."""
    from repro_torch import tree as tr

    tol = GNN_TOL[arch_id]
    paths = [tr.key_of(p) for p, _ in tr.leaves_with_paths(params)]
    reset_peak()
    t0 = time.perf_counter()
    want, want_loss = gnn_grads(cfg, _f64(params), _f64(batch))
    torch.cuda.synchronize()
    f64_s = time.perf_counter() - t0
    peak64 = torch.cuda.max_memory_allocated() / 2**30
    grads, loss = gnn_grads(cfg, params, batch)
    finite = math.isfinite(float(loss)) and all(
        bool(torch.isfinite(g).all()) for g in grads)
    ok = grad_errs(paths, grads, loss, want, want_loss)
    del grads
    bad = grad_errs(paths, *gnn_grads(cfg, params, dst_one_on(batch)),
                    want, want_loss)
    log(f"{label}: f32 against f64 on the card: loss {ok['loss']}, worst "
        f"leaf {ok['worst_leaf']} ({ok['worst_key']}); planted fault (dst "
        f"one node on): loss {bad['loss']}, worst leaf {bad['worst_leaf']} "
        f"({bad['worst_key']}); limit {tol}; f64 step {f64_s:.3f} s, "
        f"peak {peak64:.3f} GiB")
    check(finite, f"{label}: a non-finite loss or gradient")
    check(max(ok["loss"], ok["worst_leaf"]) <= tol,
          f"{label}: the f32 step differs from its f64 twin")
    check(max(bad["loss"], bad["worst_leaf"]) > tol,
          f"{label}: the hold passes the dst fault")
    return {"f32_vs_f64": ok, "dst_fault": bad, "f64_s": f64_s,
            "peak64_gib": peak64, "loss": float(loss)}


def gnn_trainer(bundle, tmp: Path, steps: int):
    """``Trainer`` over ``bundle``: ``steps`` clean steps, a metric line a
    step; returns (trainer, final state)."""
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    trainer = Trainer(bundle, TrainerConfig(
        num_steps=steps, ckpt_every=steps, log_every=1, ckpt_dir=str(tmp)),
        opt_cfg=AdamWConfig(total_steps=steps))
    state = trainer.run()
    check(len(trainer.step_times) == steps
          and not any("event" in m for m in trainer.metrics_log),
          f"{bundle.arch_id}: not {steps} clean steps: {trainer.metrics_log}")
    return trainer, state


def step_report(trainer) -> dict:
    times = [dt * 1e3 for _, dt in trainer.step_times]
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    return {"step_ms_median": float(np.median(times[1:])),
            "step_ms_first": times[0], "losses": losses,
            "peak_gib": torch.cuda.max_memory_allocated() / 2**30}


def sampler_phase(bundle, graph) -> dict:
    """(b)'s neighbour sampler over ``rmat_1m``'s CSR through
    ``graph_minibatch_stream``: the bundle's shapes, every sampled edge a
    graph edge (a parent with no neighbours samples itself), the stream's
    batches bitwise the sampler's own, host ms a batch."""
    from repro_torch.data.pipeline import graph_minibatch_stream
    from repro_torch.data.synthetic import _gnn_dims
    from repro_torch.graphs import csr_from_coo
    from repro_torch.graphs.sampler import NeighborSampler

    src, dst, n = graph
    shape = bundle.shape
    t0 = time.perf_counter()
    indptr, indices = csr_from_coo(src, dst, n)
    csr_s = time.perf_counter() - t0
    sampler = NeighborSampler(indptr, indices)
    n_pad, e_pad = _gnn_dims(bundle.cfg, shape, 128)
    st = graph_minibatch_stream(sampler, shape.batch_nodes, shape.fanout,
                                n_pad=n_pad, e_pad=e_pad,
                                d_feat=shape.d_feat, seed=SEED)
    try:
        got = [next(st) for _ in range(SAMPLER_BATCHES)]
    finally:
        st.close()
    want = bundle.make_batch(SEED)
    keys = np.sort(np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
                   * n + indices)
    deg = np.diff(indptr)
    host_ms = []
    for step, (k, b) in enumerate(got):
        check(k == step, f"path 13 (b): the stream gave step {k}")
        t0 = time.perf_counter()
        seeds = np.random.default_rng(SEED * 7_777_777 + step).integers(
            0, n, size=shape.batch_nodes)
        again = sampler.sample(seeds, shape.fanout, seed=SEED * 13 + step,
                               n_pad=n_pad, e_pad=e_pad, d_feat=shape.d_feat)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        check(all(np.array_equal(again[x], b[x]) for x in b),
              "path 13 (b): the stream's batch differs from the sampler's")
        for x in ("node_feats", "edge_src", "edge_dst", "valid_nodes"):
            check(b[x].shape == tuple(want[x].shape),
                  f"path 13 (b): sampled {x} {b[x].shape}, the bundle's "
                  f"{tuple(want[x].shape)}")
        m = b["edge_dst"] >= 0
        gids = b["global_ids"]
        child, parent = gids[b["edge_src"][m]], gids[b["edge_dst"][m]]
        key = parent * n + child
        pos = np.minimum(np.searchsorted(keys, key), keys.size - 1)
        real = (keys[pos] == key) | ((child == parent) & (deg[parent] == 0))
        check(bool(real.all()), f"path 13 (b): {int((~real).sum())} sampled "
                                f"edges are not graph edges")
    edges = int((got[0][1]["edge_dst"] >= 0).sum())
    out = {"csr_s": csr_s, "host_ms": host_ms, "n_pad": n_pad,
           "e_pad": e_pad, "edges": edges,
           "self_loops": int(sum(int((b["edge_src"] == b["edge_dst"]).sum())
                                 for _, b in got))}
    log(f"path 13 (b) sampler: rmat_1m CSR in {csr_s:.3f} s; "
        f"{SAMPLER_BATCHES} batches of {shape.batch_nodes} seeds, fanout "
        f"{shape.fanout}: ({n_pad}, {shape.d_feat}) nodes, {edges} edges in "
        f"{e_pad} slots, each edge a graph edge, the stream bitwise the "
        f"sampler; host ms a batch {host_ms}")
    return out


def routed_pairs(routing) -> np.ndarray:
    """The (src, dst) keys of every edge the routing tables carry, as
    ``src * n + dst`` over the padded ids."""
    part, r_cap = routing["part"], routing["r_cap"]
    ss, out = part.shard_size, []
    for j in range(part.p):
        k = np.flatnonzero(routing["dst_local"][j] >= 0)
        o, slot = np.divmod(routing["src_slot"][j, k].astype(np.int64), r_cap)
        s = o * ss + routing["serve_ids"][o, j, slot]
        out.append(s * part.n + j * ss + routing["dst_local"][j, k])
    return np.sort(np.concatenate(out))


def owner_hold(label, grads, loss, want, want_loss, paths) -> dict:
    """JAX's owner_gnn.py hold: the loss, and every enc_h and dec leaf
    element by element; the worst relative L2 of every leaf printed."""
    ok = bool(np.isclose(float(loss), float(want_loss), **OWNER_LOSS_TOL))
    held = [k for k in paths if k.startswith(("enc_h/", "dec/"))]
    for key, g, w in zip(paths, grads, want):
        if key in held:
            ok &= bool(torch.allclose(g, w, **OWNER_GRAD_TOL))
    errs = grad_errs(paths, grads, loss, want, want_loss)
    errs["held"] = ok
    return errs


def graphcast_phase(dev, profile: bool) -> dict:
    """(d): GraphCast at full width on ogb_products cut by GRAPHCAST_CUT:
    the global loss against owner-exchange on a GRAPHCAST_SHARDS-shard
    ``LocalMesh``, one set of weights, both timed; a planted fault."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.graphs import erdos_renyi
    from repro_torch.launch.steps import autograd_grads
    from repro_torch.models.gnn import dist_graphcast as dg

    spec = get_arch("graphcast")
    cfg, shape = spec.config, get_shape(spec, "ogb_products")
    n, p = shape.n_nodes // GRAPHCAST_CUT, GRAPHCAST_SHARDS
    torch.cuda.synchronize()
    held_before = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    src, dst = erdos_renyi(n, avg_degree=GRAPHCAST_DEGREE, seed=SEED)
    e = src.size
    rng = np.random.default_rng(SEED)
    feats = rng.standard_normal((n, shape.d_feat)).astype(np.float32)
    targets = rng.standard_normal((n, cfg.d_out)).astype(np.float32)
    e_pad = -(-e // 128) * 128
    es = np.zeros(e_pad, np.int32)
    ed = np.full(e_pad, -1, np.int32)
    es[:e], ed[:e] = src, dst
    gen_s = time.perf_counter() - t0
    log(f"path 13 (d): {cfg.name} ({spec.source}): d {cfg.d_hidden}, "
        f"{cfg.n_layers} layers, {cfg.n_vars} vars, f32, seeded weights; "
        f"ogb_products cut by {GRAPHCAST_CUT}: {n} nodes (of "
        f"{shape.n_nodes}), erdos_renyi at degree {GRAPHCAST_DEGREE}: {e} "
        f"directed edges in {e_pad} slots, d_feat {shape.d_feat}, edge "
        f"features ones (as owner_gnn.py); built in {gen_s:.1f} s")
    params = dg.init_params(cfg, shape.d_feat,
                            torch.Generator(device=dev).manual_seed(SEED))
    paths = [tr.key_of(q) for q, _ in tr.leaves_with_paths(params)]
    glob = {"node_feats": torch.from_numpy(feats).to(dev),
            "edge_src": torch.from_numpy(es).to(dev),
            "edge_dst": torch.from_numpy(ed).to(dev),
            "edge_feats": torch.ones((e_pad, 4), device=dev),
            "valid_nodes": torch.ones(n, dtype=torch.bool, device=dev),
            "targets": torch.from_numpy(targets).to(dev)}
    out = {"n": n, "edges": e, "shards": p}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        return got, (time.perf_counter() - t0) * 1e3

    reset_peak()
    (want, want_loss), ms = timed(lambda: gnn_grads(cfg, params, glob))
    out["global"] = {"fwd_bwd_ms": ms, "loss": float(want_loss),
                     "peak_gib": torch.cuda.max_memory_allocated() / 2**30
                     - held_before}
    log(f"path 13 (d) global loss_fn: loss {float(want_loss)}; forward + "
        f"backward {ms:.3f} ms; peak "
        f"{out['global']['peak_gib']:.3f} GiB above the {held_before:.3f} "
        f"GiB the script held before")
    check(out["global"]["peak_gib"] < 60, "path 13 (d): the global step "
          "peaks over 60 GiB; cut the graph further")
    if profile:
        profile_run("path 13 (d) global", lambda: gnn_grads(cfg, params,
                                                            glob))
    del glob

    t0 = time.perf_counter()
    routing = dg.build_routing(src, dst, n, p)
    routing_s = time.perf_counter() - t0
    part = routing["part"]
    check(np.array_equal(routed_pairs(routing),
                         np.sort(src.astype(np.int64) * part.n + dst)),
          "path 13 (d): the routing does not carry every edge once")
    batch = {"node_feats": torch.from_numpy(part.pad_vertex_array(feats)),
             "edge_feats": torch.ones((p * routing["e_cap"], 4)),
             "serve_ids": torch.from_numpy(routing["serve_ids"]),
             "src_slot": torch.from_numpy(routing["src_slot"]),
             "dst_local": torch.from_numpy(routing["dst_local"]),
             "valid_nodes": torch.from_numpy(np.arange(part.n) < n),
             "targets": torch.from_numpy(part.pad_vertex_array(targets))}
    batch = {k: v.to(dev) for k, v in batch.items()}
    mesh = LocalMesh.flat(p, dev, "p")
    owner = autograd_grads(dg.make_loss_fn(cfg, mesh, "p"))
    reset_peak()
    (grads, (loss, _)), ms = timed(lambda: owner(params, batch))
    peak = torch.cuda.max_memory_allocated() / 2**30 - held_before
    if profile:
        profile_run("path 13 (d) owner-exchange",
                    lambda: owner(params, batch))
    ok = owner_hold("path 13 (d)", grads, loss, want, want_loss, paths)
    del grads
    bad_batch = dict(batch)
    bad_batch["serve_ids"] = batch["serve_ids"].clone()
    bad_batch["serve_ids"][1] = torch.roll(batch["serve_ids"][1], 1, dims=1)
    bad_grads, (bad_loss, _) = owner(params, bad_batch)
    bad = owner_hold("path 13 (d)", bad_grads, bad_loss, want, want_loss,
                     paths)
    del bad_grads, bad_batch
    wire = dg.exchange_bytes(routing, cfg.d_hidden)
    out["owner"] = {"fwd_bwd_ms": ms, "loss": float(loss),
                    "peak_gib": peak, "routing_s": routing_s,
                    "r_cap": routing["r_cap"], "e_cap": routing["e_cap"],
                    "bytes_a_layer": wire, "hold": ok, "fault": bad}
    log(f"path 13 (d) owner-exchange on a {p}-shard LocalMesh: routing "
        f"{routing_s:.3f} s (r_cap {routing['r_cap']}, e_cap "
        f"{routing['e_cap']}), every edge routed once; loss {float(loss)}; "
        f"forward + backward {ms:.3f} ms; peak {peak:.3f} GiB "
        f"(the same base); against the global model: {ok}; one shard's "
        f"serve_ids rolled by a row: {bad}; bytes a shard a layer "
        f"{wire['exchange']} (the "
        f"exchange) against {wire['global_gathers']} (the global route's "
        f"two table gathers)")
    check(ok["held"], "path 13 (d): owner-exchange GraphCast differs from "
                      "the global model")
    check(not bad["held"], "path 13 (d): the hold passes rolled serve_ids")
    return out


def gcn_products_phase(dev, tmp: Path, profile: bool) -> dict:
    """(a): gcn_cora on ogb_products, not cut, through launch.train; the
    step-3 state's step held to f64; the scatter's time split between
    the real edges and the padding slots."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import train as train_launcher
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models.gnn import common as C
    from repro_torch.train.checkpoint import CheckpointManager

    spec = get_arch("gcn_cora")
    shape = get_shape(spec, "ogb_products")
    log(f"path 13 (a): {spec.config.name} ({spec.source}): "
        f"{spec.config.n_layers} layers, d {spec.config.d_hidden}, "
        f"{spec.config.d_out} classes, f32, seeded weights; ogb_products "
        f"({shape.n_nodes} nodes, {shape.n_edges} edges, d_feat "
        f"{shape.d_feat}), not cut")
    reset_peak()
    seen = {}
    argv = ["--arch", "gcn_cora", "--shape", "ogb_products", "--steps",
            str(GNN_LAUNCH_STEPS), "--ckpt-every", str(GNN_LAUNCH_STEPS),
            "--ckpt-dir", str(tmp / "a")]
    _, _, wall = run_launcher("path 13 (a) launch.train",
                              train_launcher.main, argv,
                              on_trainer=lambda t: seen.update(t=t))
    t = seen.pop("t")
    check(len(t.step_times) == GNN_LAUNCH_STEPS
          and not any("event" in m for m in t.metrics_log),
          f"path 13 (a): not {GNN_LAUNCH_STEPS} clean steps: "
          f"{t.metrics_log}")
    out = step_report(t) | {"wall_s": wall}
    bundle = build_bundle(spec, shape, device=dev)
    like = bundle.make_state(bundle.init_params(
        torch.Generator(device=dev).manual_seed(SEED)))
    state, step = CheckpointManager(str(tmp / "a")).restore(like)
    check(step == GNN_LAUNCH_STEPS, f"path 13 (a): restored step {step}")
    t0 = time.perf_counter()
    batch = bundle.make_batch(SEED * 1_000_003 + step)
    torch.cuda.synchronize()
    make_s = time.perf_counter() - t0
    dst = batch["edge_dst"]
    n, real = batch["node_feats"].shape[0], int((dst >= 0).sum())
    out |= {"make_batch_s": make_s, "edges_real": real,
            "edge_slots": dst.numel(), "nodes": n}
    log(f"path 13 (a): step {out['step_ms_median']:.3f} ms (median of "
        f"steps 2-{GNN_LAUNCH_STEPS}; step 1 {out['step_ms_first']:.3f}), "
        f"make_batch {make_s:.3f} s on the host a step (launcher wall "
        f"{wall:.1f} s), peak {out['peak_gib']:.3f} GiB, loss "
        f"{out['losses']}; {n} nodes, {real} real directed edges in "
        f"{dst.numel()} slots")
    out["hold"] = hold_gnn("path 13 (a)", bundle.cfg, state["params"], batch,
                           "gcn_cora")
    if profile:
        profile_run("path 13 (a) step", lambda: bundle.fn(state, batch))
    # the scatter of layer 0's (E, 16) messages: every slot, then the real
    # edges alone (gnn_batch puts them first) and the padding alone, which
    # all adds into the one spare row n
    check(bool((dst[:real] >= 0).all()), "path 13 (a): padding not last")
    idx = torch.where(dst >= 0, dst, n)
    msg = torch.randn((dst.numel(), spec.config.d_hidden), device=dev,
                      generator=torch.Generator(device=dev).manual_seed(SEED))
    split = {part: timed_ms(lambda: C.segment_sum(msg[sl], idx[sl], n + 1), 3)
             for part, sl in (("all", slice(None)),
                              ("real", slice(0, real)),
                              ("padding", slice(real, None)))}
    split["bound_all"] = bound(nbytes(msg, idx) + (n + 1) * msg.shape[1] * 4)[0]
    out["scatter_ms"] = split
    log(f"path 13 (a): one (E, {msg.shape[1]}) scatter-add (index_add) over "
        f"all {dst.numel()} slots {split['all']:.3f} ms, the {real} real "
        f"edges {split['real']:.3f} ms, the {dst.numel() - real} padding "
        f"slots into one row {split['padding']:.3f} ms; byte bound of all "
        f"{split['bound_all']:.3f} ms")
    return out


def gatedgcn_phase(dev, tmp: Path, graph, profile: bool) -> dict:
    """(b): gatedgcn on minibatch_lg's sampled dims through the Trainer,
    the hold, then the neighbour sampler."""
    from repro_torch.configs import get_arch
    from repro_torch.data.synthetic import _gnn_dims
    from repro_torch.launch.steps import build_bundle

    spec = get_arch("gatedgcn")
    bundle = build_bundle(spec, "minibatch_lg", device=dev)
    log(f"path 13 (b): {bundle.cfg.name} ({spec.source}): "
        f"{bundle.cfg.n_layers} layers, d {bundle.cfg.d_hidden}; "
        f"minibatch_lg's sampled dims (nodes, edges) "
        f"{_gnn_dims(bundle.cfg, bundle.shape, 128)}, d_feat "
        f"{bundle.shape.d_feat}, not cut")
    reset_peak()
    trainer, state = gnn_trainer(bundle, tmp / "b", GNN_STEPS)
    out = step_report(trainer)
    log(f"path 13 (b): step {out['step_ms_median']:.3f} ms (median of "
        f"steps 2-{GNN_STEPS}; step 1 {out['step_ms_first']:.3f}), peak "
        f"{out['peak_gib']:.3f} GiB, losses {out['losses']}")
    batch = bundle.make_batch(SEED * 1_000_003 + GNN_STEPS)
    out["hold"] = hold_gnn("path 13 (b)", bundle.cfg, state["params"], batch,
                           "gatedgcn")
    if profile:
        profile_run("path 13 (b) step", lambda: bundle.fn(state, batch))
    out["sampler"] = sampler_phase(bundle, graph)
    return out


def schnet_phase(dev, tmp: Path, profile: bool) -> dict:
    """(c): schnet on molecule through the Trainer, the hold, every value
    finite."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch
    from repro_torch.launch.steps import build_bundle

    spec = get_arch("schnet")
    bundle = build_bundle(spec, "molecule", device=dev)
    batch = bundle.make_batch(SEED * 1_000_003 + GNN_STEPS)
    log(f"path 13 (c): {bundle.cfg.name} ({spec.source}): "
        f"{bundle.cfg.n_layers} interactions, d {bundle.cfg.d_hidden}, rbf "
        f"{bundle.cfg.rbf}; molecule: {bundle.shape.batch_graphs} graphs, "
        f"{tuple(batch['node_feats'].shape)} nodes, "
        f"{batch['edge_dst'].numel()} edge slots "
        f"({int((batch['edge_dst'] < 0).sum())} padding), not cut")
    reset_peak()
    trainer, state = gnn_trainer(bundle, tmp / "c", GNN_STEPS)
    out = step_report(trainer)
    log(f"path 13 (c): step {out['step_ms_median']:.3f} ms (median of "
        f"steps 2-{GNN_STEPS}; step 1 {out['step_ms_first']:.3f}), peak "
        f"{out['peak_gib']:.3f} GiB, losses {out['losses']}")
    check(all(bool(torch.isfinite(x).all()) for x in tr.leaves(state)),
          "path 13 (c): a non-finite leaf in the trained state")
    out["hold"] = hold_gnn("path 13 (c)", bundle.cfg, state["params"], batch,
                           "schnet")
    if profile:
        profile_run("path 13 (c) step", lambda: bundle.fn(state, batch))
    return out


def gnn_phase(kernels, dev, tmp: Path, graph, profile: bool) -> dict:
    """The GNN family at full width (module docstring, path 13); no
    kernel may launch."""
    reset_counts(kernels)
    out = {"a": gcn_products_phase(dev, tmp, profile),
           "b": gatedgcn_phase(dev, tmp, graph, profile),
           "c": schnet_phase(dev, tmp, profile),
           "d": graphcast_phase(dev, profile)}
    counts = {name: k.launches for name, k in kernels.items()}
    check(not any(counts.values()),
          f"path 13: a kernel launched {counts}; the GNN family runs on "
          f"gathers, index_add and matrix products")
    out["launches"] = counts
    return out


# ---------------------------------------------------------------------------
# path 14: Mixture-of-Experts and the four LM configs at full width
# ---------------------------------------------------------------------------

# (a), (b): layers of the MoE configs' prefill and decode (dbrx: 4 MoE
# layers; llama4: one dense and one MoE layer), batch PREFILL_BATCH, the
# prompt PREFILL_SEQ tokens, the cache DECODE_MAX_LEN deep
MOE_LAYERS = {"dbrx_132b": 4, "llama4_maverick_400b_a17b": 2}
# (d): qwen1.5-110b's layers
QWEN_LAYERS = 4
# (a), (b): an MoE layer's bf16 output against its f32 twin (the same
# routing, the experts in f32, cast expert by expert): relative L2.  The
# bf16 layer rounds x, h, u, silu(h) * u, the expert outputs and the
# combine to bf16 (8 bits each, RMS 2^-9 relative a rounding).  On an
# H100 the correct layer reads 0.0043 (llama4) to 0.0053 (dbrx); a token
# given another slot's output (the dispatch one slot off from the
# combine) reads 0.89 to 1.35 and gates that do not sum to 1 0.38 to
# 0.62.  2^-5 sits 5.9 times above the one and 12 times below the other.
MOE_TOL = 2.0 ** -5
# (a), (b): lb_loss of the bf16 layer against its f32 twin, relative:
# both read the same f32 probabilities, so they should agree to rounding
LB_TOL = 1e-6
# (b): moe_apply_sharded on LocalMesh (1, 4) against the local route,
# relative L2.  At top-1 each token's routed output has one term: the
# local route keeps it in bf16, the sharded one adds it to f32 zeros and
# psums three zero partials before the cast, so both are bitwise equal
# (as on an H100 at llama4's MoE layer); 2^-8 (one bf16 rounding) bounds
# another summation order
SHARDED_TOL = 2.0 ** -8
# (c): yi-34b served at full depth
YI_SERVE_ARGV = ["--arch", "yi_34b", "--requests", "8", "--slots", "4",
                 "--max-len", "1024", "--max-new-tokens", "32"]
# (e): dbrx-132b train_4k, one layer, batch 1, seq 4,096, with path 12's
# one-step warmup at learning rate MOE_TRAIN_LR.  Adam's first step moves
# each weight by about the learning rate, coherently over d = 6,144
# coordinates of the head and the embedding: on an H100 the one-layer
# cut's loss fell from 12.01 to 7.77 (lr 3e-4) or 6.05 (1e-4) in one step
# and rose in the next, an overshoot.  A rate far below bf16's half-ulp of
# these weights (about 3e-5 at |w| = 0.0128) moves few of them at all
MOE_TRAIN_LAYERS, MOE_TRAIN_BATCH, MOE_TRAIN_STEPS = 1, 1, 3
MOE_TRAIN_LR = 5e-5


class _NoCheckpoints:
    """A checkpoint manager that keeps nothing: (e) times the train step
    of a 54 GB state, whose save path 12 already covers at 34 GB."""

    def save(self, step, state) -> None:
        pass

    def wait(self) -> None:
        pass

    def restore(self, like):
        return None, None


@contextlib.contextmanager
def recording_moe(sink: list):
    """A context in which every ``moe.moe_apply`` call (the transformer's
    MoE blocks) appends ``{"params", "x", "lb_loss", "dropped"}`` to
    ``sink`` (device tensors: no host read)."""
    from repro_torch.models import moe

    real = moe.moe_apply

    def record(params, x, cfg, *a, **kw):
        out, aux = real(params, x, cfg, *a, **kw)
        sink.append({"params": params, "x": x.detach(),
                     "lb_loss": aux["lb_loss"].detach(),
                     "dropped": aux["dropped"].detach()})
        return out, aux

    moe.moe_apply = record
    try:
        yield sink
    finally:
        moe.moe_apply = real


def moe_f32_twin(p: dict, x: torch.Tensor, cfg):
    """The local MoE route in f32 on the same inputs: x and the shared
    expert cast whole, the experts' weights cast 8 experts at a time (a
    whole llama4 MoE layer in f32 is 64 GB); the router is f32 already."""
    from repro_torch.models import moe

    real = moe._experts

    def experts_f32(w, expert_in):
        out = torch.empty_like(expert_in)
        for e0 in range(0, expert_in.shape[0], 8):
            chunk = {n: w[n][e0:e0 + 8].float()
                     for n in ("w_gate", "w_up", "w_down")}
            out[e0:e0 + 8] = real(chunk, expert_in[e0:e0 + 8])
        return out

    p32 = dict(p)
    if "shared" in p:
        p32["shared"] = {n: w.float() for n, w in p["shared"].items()}
    moe._experts = experts_f32
    try:
        return moe._moe_apply_local(p32, x.float(), cfg)
    finally:
        moe._experts = real


def planted_moe(p: dict, x: torch.Tensor, cfg, want) -> dict:
    """The bf16 layer with a planted fault, read against ``want`` (the f32
    twin): the dispatch one slot on from the combine (each token gets the
    output of the assignment before it in its expert's bucket), and the
    top-k gates left unnormalised."""
    from repro_torch.models import moe

    real_dispatch = moe._dispatch

    def dispatch_off(x_, slot, stok, n_slots):
        return real_dispatch(x_, torch.where(slot < n_slots, slot + 1,
                                             slot).clamp_max(n_slots),
                             stok, n_slots)

    def route_unnormalised(router, x_, k):
        probs = torch.softmax(torch.matmul(x_.float().to(router.dtype),
                                           router), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        return probs, vals[:, :k], idx[:, :k]

    out = {}
    for name, attr, fake in (("dispatch one slot off", "_dispatch",
                              dispatch_off),
                             ("gates unnormalised", "_route",
                              route_unnormalised)):
        real = getattr(moe, attr)
        setattr(moe, attr, fake)
        try:
            bad, _ = moe._moe_apply_local(p, x, cfg)
        finally:
            setattr(moe, attr, real)
        out[name] = rel_err(bad, want)
    return out


def hold_moe_layer(label: str, p: dict, x: torch.Tensor, cfg) -> dict:
    """One MoE layer's bf16 local route against its f32 twin on the same
    input: the routing (experts and gates) identical, ``dropped`` equal,
    ``lb_loss`` within LB_TOL, the output within MOE_TOL, each planted
    fault past it; and the layer's time."""
    from repro_torch.models import moe

    out, aux = moe._moe_apply_local(p, x, cfg)
    want, aux32 = moe_f32_twin(p, x, cfg)
    _, gate, expert = moe._route(p["router"], x, cfg.top_k)
    _, gate32, expert32 = moe._route(p["router"], x.float(), cfg.top_k)
    routing = torch.equal(expert, expert32) and torch.equal(gate, gate32)
    dropped, dropped32 = int(aux["dropped"]), int(aux32["dropped"])
    lb, lb32 = float(aux["lb_loss"]), float(aux32["lb_loss"])
    err = rel_err(out, want)
    bad = planted_moe(p, x, cfg, want)
    ms = timed_ms(lambda: moe._moe_apply_local(p, x, cfg), 3)
    t = x.shape[0]
    c = moe.capacity(t, cfg)
    flops = 2.0 * cfg.n_experts * c * x.shape[1] * cfg.d_ff * 3 + 2.0 * t * (
        x.shape[1] * cfg.n_experts
        + 3 * x.shape[1] * cfg.d_ff * cfg.shared_experts)
    log(f"{label}: {t} tokens, capacity {c}, dropped {dropped} (f32 twin "
        f"{dropped32}), routing identical {routing}, lb_loss {lb} (f32 "
        f"{lb32}), bf16 against f32 rel L2 {err} (limit {MOE_TOL}); "
        f"planted {bad}; {ms} ms a call ({flops / ms / 1e9:.1f} TFLOP/s of "
        f"router, expert slots and shared products)")
    check(routing, f"{label}: the bf16 layer routes otherwise than f32")
    check(dropped == dropped32, f"{label}: dropped {dropped} != {dropped32}")
    check(abs(lb - lb32) <= LB_TOL * abs(lb32),
          f"{label}: lb_loss {lb} against {lb32}")
    check(err <= MOE_TOL, f"{label}: bf16 differs from f32 by {err}")
    for name, e in bad.items():
        check(e > MOE_TOL, f"{label}: the hold passes {name} ({e})")
    return {"tokens": t, "capacity": c, "dropped": dropped,
            "lb_loss": lb, "rel_l2": err, "planted": bad, "ms": ms,
            "tflops": flops / ms / 1e9}


def nodrop_capacity_factor(cfg, rec: list, tokens: int) -> float:
    """A capacity factor under which no MoE layer of the prefill drops:
    E / k (capacity = every token) where several MoE layers follow each
    other (a later layer's input moves with an earlier one's drops);
    where one MoE layer is the model's only one, its input does not
    depend on the capacity, so the least factor whose capacity at
    ``tokens`` covers its busiest expert (plus one slot of 8)."""
    from repro_torch.models import moe

    m = cfg.moe
    if len(rec) > 1:
        return m.n_experts / m.top_k
    _, _, expert = moe._route(rec[0]["params"]["router"], rec[0]["x"],
                              m.top_k)
    busiest = int(torch.bincount(expert.reshape(-1),
                                 minlength=m.n_experts).max())
    return (busiest + 8) * m.n_experts / (tokens * m.top_k)


def moe_lm_phase(kernels, dev, arch: str, sharded: bool) -> dict:
    """(a) / (b): an MoE config at full width, cut in depth and batch,
    through the prefill_32k and decode_32k bundles: the A4 prefill with
    each MoE layer's dropped count, each MoE layer held to its f32 twin
    with two planted faults, and the decode step held to the prefill's
    last-token logits where no MoE layer drops; with ``sharded``, the
    first MoE layer's prefill input through ``moe_apply_sharded``."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.steps import build_bundle
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tf

    label = "path 14 (a)" if arch == "dbrx_132b" else "path 14 (b)"
    spec = get_arch(arch)
    full = spec.config
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS[arch])
    cut = dataclasses.replace(spec, config=cfg)
    pshape = dataclasses.replace(get_shape(spec, "prefill_32k"),
                                 seq_len=PREFILL_SEQ,
                                 global_batch=PREFILL_BATCH)
    dshape = dataclasses.replace(get_shape(spec, "decode_32k"),
                                 global_batch=PREFILL_BATCH)
    m = cfg.moe
    log(f"{label}: {full.name} ({spec.source}): d {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, "
        f"{m.n_experts} experts top-{m.top_k} of width {m.d_ff}, "
        f"shared {m.shared_experts}, capacity factor {m.capacity_factor}, "
        f"pattern {[sp.moe for sp in cfg.pattern]} (moe), vocab "
        f"{cfg.vocab}, {cfg.dtype}, random weights (seed {SEED}); cut: "
        f"layers {full.n_layers} -> {cfg.n_layers}, batch "
        f"{get_shape(spec, 'prefill_32k').global_batch} (prefill) / "
        f"{get_shape(spec, 'decode_32k').global_batch} (decode) -> "
        f"{PREFILL_BATCH}, prompt {get_shape(spec, 'prefill_32k').seq_len} "
        f"-> {PREFILL_SEQ} tokens; cache depth {dshape.seq_len} (not cut); "
        f"{cfg.param_count()} parameters")
    prefill = build_bundle(cut, pshape, device=dev)
    decode = build_bundle(cut, dshape, device=dev)
    reset_peak()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    params = prefill.init_params(torch.Generator(device=dev).manual_seed(
        SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated() - base
    held = torch.cuda.memory_allocated() - base
    tokens = prefill.make_batch(SEED)["tokens"]
    b, s = tokens.shape
    log(f"{label}: weights {held} bytes drawn in {init_s:.3f} s, peak "
        f"{init_peak} bytes while drawing (the f32 transient "
        f"{init_peak - held} bytes); tokens {tuple(tokens.shape)}")

    # the A4 prefill, each MoE layer's input and dropped count recorded
    reset_counts(kernels)
    rec = []
    with recording_moe(rec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill.fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
    a4 = kernels["flash_attention"]
    check(a4.launches == cfg.n_layers and a4.launches_bf16 == cfg.n_layers
          and a4.launches_f32 == 0,
          f"{label}: A4 launched {a4.launches} times ({a4.launches_bf16} "
          f"bf16) in a {cfg.n_layers}-layer prefill")
    check(logits.shape == (b, cfg.vocab) and bool(
        torch.isfinite(logits).all()), f"{label}: prefill logits")
    del cache
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits2, cache = prefill.fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    del cache, logits2
    check(a4.launches == 2 * cfg.n_layers, f"{label}: A4 launched "
                                           f"{a4.launches} times in two "
                                           f"prefills")
    dropped = [int(r["dropped"]) for r in rec]
    lbs = [float(r["lb_loss"]) for r in rec]
    log(f"{label}: A4 prefill {first_ms:.3f} ms (first), {prefill_ms:.3f} "
        f"ms (second) = {b * s / (prefill_ms / 1e3):.1f} prompt tokens/s; "
        f"dropped assignments by MoE layer {dropped} of {b * s * m.top_k} "
        f"each; lb_loss by MoE layer {lbs}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")

    # each MoE layer against its f32 twin, with two planted faults
    holds = [hold_moe_layer(f"{label} MoE layer {i}", r["params"], r["x"],
                            m) for i, r in enumerate(rec)]

    # the decode step against the prefill's last-token logits, on a
    # second pair of prefills under a capacity factor where nothing drops
    # (capacity is computed on B * S tokens in the prefill and on B in
    # decode, and a prompt one token shorter moves other tokens' ranks).
    # A row is held where every MoE layer routes its last token to the
    # same experts in both (bf16 drift may flip a near-tie; printed)
    cf = nodrop_capacity_factor(cfg, rec, b * (s - 1))
    cfg_nd = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=cf))
    rec_ref, rec_nd, rec_dec = [], [], []
    with recording_moe(rec_ref):
        want, cache, _ = tf.prefill(cfg_nd, params, tokens, s)
    del cache
    with recording_moe(rec_nd):
        _, cache, _ = tf.prefill(cfg_nd, params, tokens[:, :-1],
                                 DECODE_MAX_LEN)
    nd_dropped = [int(r["dropped"]) for r in rec_ref + rec_nd]
    check(not any(nd_dropped), f"{label}: the no-drop prefills dropped "
                               f"{nd_dropped} under capacity factor {cf}")
    check(a4.launches == 4 * cfg.n_layers,
          f"{label}: A4 launched {a4.launches} times in four prefills of "
          f"{cfg.n_layers} layers")
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    with recording_moe(rec_dec):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got, cache = decode.fn(params, {"cache": cache, "pos": pos,
                                        "last_token": tokens[:, -1]})
        torch.cuda.synchronize()
        decode_first_ms = (time.perf_counter() - t0) * 1e3
    check(a4.launches == 4 * cfg.n_layers, f"{label}: decode launched A4")
    last = torch.arange(1, b + 1, device=dev) * s - 1
    same = torch.ones(b, dtype=torch.bool, device=dev)
    for r, d in zip(rec_ref, rec_dec):
        _, _, e_ref = moe_lib._route(r["params"]["router"], r["x"][last],
                                     m.top_k)
        _, _, e_dec = moe_lib._route(d["params"]["router"], d["x"], m.top_k)
        same &= (e_ref.sort(-1).values == e_dec.sort(-1).values).all(-1)
    del rec_ref, rec_nd, rec_dec
    rows = [i for i in range(b) if bool(same[i])]
    rel = [rel_err(got[i], want[i]) for i in range(b)]
    log(f"{label}: capacity factor {cf} (no drops in either prefill); "
        f"decode at pos {s - 1} against the A4 prefill of {s} tokens: rel "
        f"L2 by row {rel} (limit {DECODE_TOL}), rows routed alike in every "
        f"MoE layer {rows}; argmax agree "
        f"{(got.argmax(-1) == want.argmax(-1)).tolist()}; first step "
        f"{decode_first_ms:.3f} ms")
    check(rows and all(rel[i] <= DECODE_TOL for i in rows),
          f"{label}: decode differs from the prefill")
    tok, steps_ms = got.argmax(-1), []
    for i in range(DECODE_GREEDY):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nxt, cache = decode.fn(params, {"cache": cache, "pos": pos + 1 + i,
                                        "last_token": tok})
        tok = nxt.argmax(-1)
        torch.cuda.synchronize()
        steps_ms.append((time.perf_counter() - t0) * 1e3)
        check(bool(torch.isfinite(nxt).all()), f"{label}: greedy logits")
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{label}: ms a decode step ({cfg.n_layers} layers, batch {b}, a "
        f"{DECODE_MAX_LEN}-deep cache) {steps_ms}; peak {peak:.3f} GiB")
    out = {"init_s": init_s, "init_peak_bytes": init_peak,
           "weights_bytes": held, "prefill_ms": prefill_ms,
           "prefill_first_ms": first_ms, "dropped": dropped, "lb_loss": lbs,
           "holds": holds, "nodrop_capacity_factor": cf,
           "decode_rel_l2": rel, "decode_ms": steps_ms,
           "peak_gib": peak, "a4_launches": a4.launches}
    del cache, want, got, nxt
    if sharded:
        out["sharded"] = sharded_phase(rec[0]["params"], rec[0]["x"], m, dev)
    return out


def sharded_phase(p: dict, x: torch.Tensor, cfg, dev) -> dict:
    """(b): ``moe_apply_sharded`` on a (data 1, model 4) ``LocalMesh``
    against the local route on the MoE layer's prefill input."""
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.models import moe

    mesh = LocalMesh((1, 4), ("data", "model"), dev)
    got, aux = moe.moe_apply_sharded(p, x, cfg, mesh, ("data",), "model")
    want, loc = moe._moe_apply_local(p, x, cfg)
    err = rel_err(got, want)
    same_lb = torch.equal(aux["lb_loss"], loc["lb_loss"])
    dropped, dropped_loc = int(aux["dropped"]), int(loc["dropped"])
    sharded_ms = timed_ms(lambda: moe.moe_apply_sharded(
        p, x, cfg, mesh, ("data",), "model"), 3)
    local_ms = timed_ms(lambda: moe._moe_apply_local(p, x, cfg), 3)
    log(f"path 14 (b) sharded: LocalMesh (data 1, model 4), "
        f"{cfg.n_experts // 4} experts a shard, {x.shape[0]} tokens: rel "
        f"L2 against the local route {err} (limit {SHARDED_TOL}), bitwise "
        f"{torch.equal(got, want)}; lb_loss equal {same_lb}; dropped "
        f"{dropped} (local {dropped_loc}); {sharded_ms} ms against the "
        f"local route's {local_ms} ms")
    check(err <= SHARDED_TOL, "path 14 (b): the sharded route differs")
    check(same_lb and dropped == dropped_loc,
          "path 14 (b): the sharded route's lb_loss or dropped differs")
    return {"rel_l2": err, "bitwise": torch.equal(got, want),
            "dropped": dropped, "sharded_ms": sharded_ms,
            "local_ms": local_ms}


def draw_transients(dev) -> dict:
    """The device bytes of drawing one bf16 leaf, alone on the card: the
    whole leaf in f32 then cast (the init before it drew in slices) against
    ``scaled_normal``'s slices, for yi-34b's stacked ``w_gate`` and
    llama4's stacked expert ``w_gate``."""
    from repro_torch.layers.core import scaled_normal

    out = {}
    for name, shape in (("yi_34b w_gate", (60, 7168, 20480)),
                        ("llama4 moe w_gate", (1, 128, 5120, 8192))):
        row = {}
        for how in ("whole f32 draw", "scaled_normal"):
            gen = torch.Generator(device=dev).manual_seed(SEED)
            reset_peak()
            base = torch.cuda.memory_allocated()
            if how == "scaled_normal":
                w = scaled_normal(shape, shape[-2] ** -0.5, torch.bfloat16,
                                  gen)
            else:
                w = torch.randn(shape, generator=gen, device=dev).mul_(
                    shape[-2] ** -0.5).to(torch.bfloat16)
            torch.cuda.synchronize()
            row[how] = torch.cuda.max_memory_allocated() - base
            del w
        row["leaf_bytes"] = math.prod(shape) * 2
        out[name] = row
    log(f"path 14: peak bytes of drawing one bf16 leaf {out}")
    return out


def yi_phase(kernels, dev) -> dict:
    """(c): yi-34b at full depth through ``launch.serve``."""
    from repro_torch.configs import get_arch
    from repro_torch.launch import serve as serve_launcher
    from repro_torch.serve.batcher import Request, Server

    full = get_arch("yi_34b").config
    log(f"path 14 (c): {full.name}: {full.n_layers} layers (not cut), d "
        f"{full.d_model}, {full.n_heads} / {full.n_kv_heads} heads of "
        f"{full.head_dim}, d_ff {full.d_ff}, vocab {full.vocab}, "
        f"{full.param_count()} parameters ({full.param_count() * 2} bytes "
        f"bf16)")
    reset_counts(kernels)
    reset_peak()
    seen = {}
    _, text, wall = run_launcher(
        "path 14 (c) launch.serve", serve_launcher.main, YI_SERVE_ARGV,
        on_done=lambda srv, done, secs: seen.update(srv=srv, done=done,
                                                    secs=secs))
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()), f"path 14 (c): a kernel launched "
                                    f"{counts}; the server decodes only")
    srv, done = seen["srv"], sorted(seen["done"], key=lambda r: r.rid)
    check(len(done) == 8 and all(len(r.out) == 32 for r in done),
          f"path 14 (c): {[len(r.out) for r in done]} tokens")
    ms_step = seen["secs"] * 1e3 / srv.decode_steps
    toks = sum(len(r.out) for r in done)
    peak = torch.cuda.max_memory_allocated() / 2**30
    alone = Server(full, srv.params, batch_slots=srv.n_slots,
                   max_len=srv.max_len)
    again = Request(rid=0, prompt=done[0].prompt,
                    max_new_tokens=done[0].max_new_tokens)
    alone.submit(again)
    alone.run_until_drained()
    check(again.out == done[0].out, "path 14 (c): request 0 alone gives "
                                    "other tokens than in the batch")
    log(f"path 14 (c): {srv.decode_steps} decode steps (batch "
        f"{srv.n_slots}, a {srv.max_len}-deep cache) in {seen['secs']:.3f} "
        f"s = {ms_step:.3f} ms a step, {toks / seen['secs']:.1f} tok/s; "
        f"peak {peak:.3f} GiB; request 0 alone: the same tokens")
    out = {"run_line": text.strip().splitlines()[-1],
           "decode_steps": srv.decode_steps, "ms_per_step": ms_step,
           "tok_per_s": toks / seen["secs"], "seconds": wall,
           "peak_gib": peak}
    del alone, srv, seen
    return out


def qwen_phase(kernels, dev) -> dict:
    """(d): qwen1.5-110b at full width, 4 layers, with seeded nonzero
    q/k/v biases: the A4 prefill against the plain prefill, the bias of
    k dropped failing that hold, and the decode step."""
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch.steps import build_bundle

    spec = get_arch("qwen1_5_110b")
    full = spec.config
    cfg = dataclasses.replace(full, n_layers=QWEN_LAYERS)
    cut = dataclasses.replace(spec, config=cfg)
    pshape = dataclasses.replace(get_shape(spec, "prefill_32k"),
                                 seq_len=PREFILL_SEQ,
                                 global_batch=PREFILL_BATCH)
    dshape = dataclasses.replace(get_shape(spec, "decode_32k"),
                                 global_batch=PREFILL_BATCH)
    log(f"path 14 (d): {full.name} ({spec.source}): d {cfg.d_model}, "
        f"{cfg.n_heads} / {cfg.n_kv_heads} heads of {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}, qkv_bias {cfg.qkv_bias}; cut: "
        f"layers {full.n_layers} -> {cfg.n_layers}, batch -> "
        f"{PREFILL_BATCH}, prompt -> {PREFILL_SEQ}; {cfg.param_count()} "
        f"parameters")
    prefill = build_bundle(cut, pshape, device=dev)
    decode = build_bundle(cut, dshape, device=dev)
    reset_peak()
    params = prefill.init_params(torch.Generator(device=dev).manual_seed(
        SEED))
    # JAX initialises the biases to zero, under which a port that ignored
    # them would pass: draw them N(0, 1), seeded
    gen = torch.Generator(device=dev).manual_seed(SEED + 14)
    for blk in params.blocks:
        for n in ("bq", "bk", "bv"):
            w = getattr(blk.attn, n)
            w.copy_(torch.randn(w.shape, generator=gen, device=dev))
            check(bool((w != 0).all()), f"path 14 (d): a zero {n}")
    tokens = prefill.make_batch(SEED)["tokens"]
    b, s = tokens.shape
    reset_counts(kernels)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = prefill.fn(params, {"tokens": tokens})
    torch.cuda.synchronize()
    prefill_ms = (time.perf_counter() - t0) * 1e3
    a4 = kernels["flash_attention"]
    check(a4.launches == cfg.n_layers, f"path 14 (d): A4 launched "
                                       f"{a4.launches} times")
    plain, plain_cache = prefill.fn(params, {"tokens": tokens},
                                    use_kernel=False)

    def hold(lg, cc) -> float:
        errs = [rel_err(lg, plain)] + [
            rel_err(c[n][g], pc[n][g]) for c, pc in zip(cc, plain_cache)
            for n in "kv" for g in range(cfg.n_groups)]
        return max(errs)

    err = hold(logits, cache)
    # planted: the bias of k dropped in every layer
    saved = [blk.attn.bk.clone() for blk in params.blocks]
    for blk in params.blocks:
        blk.attn.bk.zero_()
    bad_logits, bad_cache = prefill.fn(params, {"tokens": tokens})
    bad = hold(bad_logits, bad_cache)
    for blk, w in zip(params.blocks, saved):
        blk.attn.bk.copy_(w)
    del bad_cache, saved, cache, plain_cache
    log(f"path 14 (d): A4 prefill {prefill_ms:.3f} ms; against the plain "
        f"prefill the worst of the logits and each layer's k, v cache rel "
        f"L2 {err} (limit {PREFILL_TOL}); bk dropped {bad}")
    check(err <= PREFILL_TOL, "path 14 (d): the A4 prefill differs from "
                              "the plain prefill")
    check(bad > PREFILL_TOL, "path 14 (d): the hold passes the bias of k "
                             "dropped")
    from repro_torch.models import transformer as tf

    _, cache, _ = tf.prefill(cfg, params, tokens[:, :-1], DECODE_MAX_LEN)
    pos = torch.full((b,), s - 1, dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got, cache = decode.fn(params, {"cache": cache, "pos": pos,
                                    "last_token": tokens[:, -1]})
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3
    rel = rel_err(got, logits)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"path 14 (d): decode at pos {s - 1} against the A4 prefill: rel L2 "
        f"{rel} (limit {DECODE_TOL}); {decode_ms:.3f} ms; A4 launches "
        f"{a4.launches}; peak {peak:.3f} GiB")
    check(rel <= DECODE_TOL, "path 14 (d): decode differs from the prefill")
    check(a4.launches == 3 * cfg.n_layers,
          f"path 14 (d): A4 launched {a4.launches} times")
    return {"prefill_ms": prefill_ms, "rel_l2": err, "bk_dropped": bad,
            "decode_rel_l2": rel, "decode_ms": decode_ms, "peak_gib": peak,
            "a4_launches": a4.launches}


def moe_train_phase(kernels, dev, tmp: Path) -> dict:
    """(e): dbrx-132b train_4k at full width, one layer, batch 1 x 4,096,
    3 Trainer steps on one fixed batch."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import steps
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.trainer import Trainer, TrainerConfig

    spec = get_arch("dbrx_132b")
    full, full_shape = spec.config, get_shape(spec, "train_4k")
    cfg = dataclasses.replace(full, n_layers=MOE_TRAIN_LAYERS)
    cut = dataclasses.replace(spec, config=cfg)
    shape = dataclasses.replace(full_shape, global_batch=MOE_TRAIN_BATCH)
    # bf16 parameters and gradients, f32 moments
    state_bytes = cfg.param_count() * (2 + 2 + 8)
    free, total = torch.cuda.mem_get_info()
    log(f"path 14 (e): {full.name} train_4k: cut layers {full.n_layers} -> "
        f"{cfg.n_layers}, batch {full_shape.global_batch} -> "
        f"{shape.global_batch}, seq {shape.seq_len} (not cut), lr "
        f"{MOE_TRAIN_LR}, warmup 1, remat {cfg.remat}; "
        f"{cfg.param_count()} parameters, {state_bytes} bytes of parameters, "
        f"gradients and moments; device memory free {free} of {total}")
    check(free > 1.1 * state_bytes, f"path 14 (e): {free} bytes free "
                                    f"cannot hold {state_bytes}")
    opt_cfg = AdamWConfig(lr=MOE_TRAIN_LR, warmup_steps=1,
                          total_steps=MOE_TRAIN_STEPS)
    bundle = steps.build_bundle(cut, shape, device=dev, opt_cfg=opt_cfg)
    fixed = bundle.make_batch(SEED)
    bundle = dataclasses.replace(bundle, make_batch=lambda seed=0: fixed)
    trainer = Trainer(bundle, TrainerConfig(
        num_steps=MOE_TRAIN_STEPS, ckpt_every=MOE_TRAIN_STEPS, log_every=1,
        ckpt_dir=str(tmp), seed=SEED), opt_cfg=opt_cfg)
    trainer.mgr = _NoCheckpoints()
    reset_counts(kernels)
    reset_peak()
    rec = []
    with recording_moe(rec):
        t0 = time.perf_counter()
        state = trainer.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()), f"path 14 (e): a kernel launched "
                                    f"{counts}")
    losses = [m["loss"] for m in trainer.metrics_log if "loss" in m]
    check(len(losses) == MOE_TRAIN_STEPS and all(map(math.isfinite, losses)),
          f"path 14 (e): not {MOE_TRAIN_STEPS} finite losses: "
          f"{trainer.metrics_log}")
    check(all(b < a for a, b in zip(losses, losses[1:])),
          f"path 14 (e): the loss does not fall at every step: {losses}")
    check(all(bool(torch.isfinite(t).all()) for t in tr.leaves(state)
              if t.is_floating_point()), "path 14 (e): a non-finite leaf")
    # the MoE calls of a step: its forward's first; the block's recompute
    # in the backward (remat "block") stops inside the layer once it has
    # what the backward needs, so it records only where it runs through
    per_step = len(rec) // MOE_TRAIN_STEPS
    check(per_step in (cfg.n_layers, 2 * cfg.n_layers)
          and len(rec) % MOE_TRAIN_STEPS == 0,
          f"path 14 (e): {len(rec)} MoE calls in {MOE_TRAIN_STEPS} steps")
    lb = [float(r["lb_loss"]) for r in rec[::per_step]]
    dropped = [int(r["dropped"]) for r in rec[::per_step]]
    step_ms = float(np.median([dt for _, dt in trainer.step_times[1:]])) * 1e3
    tokens = shape.global_batch * shape.seq_len
    log(f"path 14 (e): losses {losses}; lb_loss by step {lb}; dropped by "
        f"step {dropped} of {tokens * cfg.moe.top_k}; step {step_ms} ms "
        f"(median of steps 2-{MOE_TRAIN_STEPS}; step 1 "
        f"{trainer.step_times[0][1] * 1e3} ms) = {tokens / (step_ms / 1e3)} "
        f"tokens/s; peak {peak:.3f} GiB; wall {wall:.1f} s; A4 launched 0 "
        f"times")
    out = {"losses": losses, "lb_loss": lb, "dropped": dropped,
           "step_ms_median": step_ms,
           "step_ms_first": trainer.step_times[0][1] * 1e3,
           "tokens_per_s": tokens / (step_ms / 1e3), "peak_gib": peak,
           "state_bytes": state_bytes}
    del state, trainer, bundle, rec, fixed
    return out


def moe_phase(kernels, dev, tmp: Path) -> dict:
    """Path 14 (module docstring): (a) dbrx and (b) llama4 prefill, decode
    and MoE holds, (b)'s sharded route; (c) yi-34b served at full depth;
    (d) qwen1.5-110b with its biases; (e) dbrx's train step."""
    import gc

    launches = dict.fromkeys(kernels, 0)

    def free():
        # each part resets the counts before it runs: add up its launches
        for n, k in kernels.items():
            launches[n] += k.launches
        reset_counts(kernels)
        gc.collect()
        torch.cuda.empty_cache()

    reset_counts(kernels)
    free()
    log(f"path 14: device memory held from earlier paths "
        f"{torch.cuda.memory_allocated()} bytes")
    out = {"draw": draw_transients(dev)}
    free()
    out["a"] = moe_lm_phase(kernels, dev, "dbrx_132b", sharded=False)
    free()
    out["b"] = moe_lm_phase(kernels, dev, "llama4_maverick_400b_a17b",
                            sharded=True)
    free()
    out["c"] = yi_phase(kernels, dev)
    free()
    out["d"] = qwen_phase(kernels, dev)
    free()
    out["e"] = moe_train_phase(kernels, dev, tmp)
    free()
    want = dict.fromkeys(kernels, 0) | {"flash_attention": (
        out["a"]["a4_launches"] + out["b"]["a4_launches"]
        + out["d"]["a4_launches"])}
    check(launches == want, f"path 14: launches {launches}, not {want}")
    out["launches"] = launches
    return out


# ---------------------------------------------------------------------------
# path 15: elastic resharding, the sharding plan and the dry run
# ---------------------------------------------------------------------------

# (c) steps before the reshards and after them
ELASTIC_STEPS = 3
# (c) the planted fault: 39,000,000 table rows do not divide over 7
ELASTIC_BAD_MODEL = 7
# (d) the dry run's arg_bytes against the bytes the allocator was asked
# for by the real state and batch (``requested_bytes``; its
# ``memory_allocated`` also counts each large block's rounding to the
# 2 MiB segment that holds it, up to 1 MiB a leaf)
DRY_MEM_TOL = 1e-3


def elastic_bfs_phase(kernels, g4, roots, want, pad4, card) -> dict:
    """(a): path 1's p = 4 ``rmat_1m`` graph repartitioned to p = 2 and
    p = 1, each traversed in ``mode="dense"`` with the packed wire."""
    from repro_torch.core import BFSOptions, plan
    from repro_torch.train.elastic import (repartition_graph,
                                           repartition_vertex_array)

    out = {}
    for new_p in (2, 1):
        t0 = time.perf_counter()
        g = repartition_graph(g4, new_p)
        host_s = time.perf_counter() - t0
        check(g.p == new_p and g.n_edges == g4.n_edges,
              f"path 15 (a): p = {new_p} holds {g.n_edges} edges, not "
              f"{g4.n_edges}")
        eng = plan(g, BFSOptions(mode="dense", wire_format="packed"),
                   num_sources=S).compile()
        host, run_ms, res, counts = drive(kernels, eng, roots, runs=2)
        levels = res.run_stats.levels
        check(np.array_equal(host, want),
              f"path 15 (a) p = {new_p}: distances differ from path 1's")
        check(counts["fold_update"] == 2 * levels
              and sum(counts.values()) == counts["fold_update"],
              f"path 15 (a) p = {new_p}: launches {counts} in 2 runs of "
              f"{levels} levels")
        row = {"repartition_host_s": host_s, "levels": levels,
               "run_ms": run_ms[0], "ms_a_level": run_ms[0] / levels,
               "a1_launches": counts["fold_update"], "e_cap": g.e_cap}
        if new_p == 2:
            t0 = time.perf_counter()
            moved = repartition_vertex_array(pad4, g4.part, g.part)
            row["vertex_array_host_s"] = time.perf_counter() - t0
            check(np.array_equal(moved, res.dist.cpu().numpy()),
                  "path 15 (a): path 1's p = 4 distances repartitioned "
                  "differ from the p = 2 engine's")
        out[f"p{new_p}"] = row
        log(f"path 15 (a) p = {new_p}: repartition_graph {host_s:.3f} s on "
            f"the host (e_cap {g.e_cap}); run {run_ms[0]} ms, "
            f"{row['ms_a_level']} ms a level over {levels} levels; A1 "
            f"{counts['fold_update']} launches in 2 runs; distances bitwise "
            f"path 1's [{card}]")
        del eng, res
    return out


def elastic_bits_phase(kernels, src, dst, n, roots, want, card) -> dict:
    """(b): ``small_world_100k`` with ``use_kernel=True`` at p = 4, then
    repartitioned to 2, then to 1."""
    from repro_torch.core import BFSOptions, plan
    from repro_torch.graphs import shard_graph
    from repro_torch.train.elastic import repartition_graph

    out, g = {}, shard_graph(src, dst, n, 4)
    for p in (4, 2, 1):
        host_s = 0.0
        if p != 4:
            t0 = time.perf_counter()
            g = repartition_graph(g, p)
            host_s = time.perf_counter() - t0
        eng = plan(g, BFSOptions(use_kernel=True, wire_format="packed"),
                   num_sources=S).compile()
        host, run_ms, res, counts = drive(kernels, eng, roots, runs=2)
        levels = res.run_stats.levels
        check(np.array_equal(host, want),
              f"path 15 (b) p = {p}: distances differ from path 2's")
        check(counts["bsr_expand_bits"] == 2 * levels
              and counts["bsr_spmm"] == counts["bitpack_words"] == 0,
              f"path 15 (b) p = {p}: launches {counts} in 2 runs of "
              f"{levels} levels")
        out[f"p{p}"] = {"repartition_host_s": host_s, "run_ms": run_ms[0],
                        "levels": levels, "launches": counts}
        log(f"path 15 (b) p = {p}: repartition {host_s:.3f} s; run "
            f"{run_ms[0]} ms over {levels} levels; bsr_expand_bits "
            f"{counts['bsr_expand_bits']}, A1 {counts['fold_update']} "
            f"launches in 2 runs; distances bitwise path 2's [{card}]")
        del eng, res
    return out


def elastic_train_phase(kernels, dev, card) -> dict:
    """(c): DeepFM ``train_batch`` uncut: 3 steps, ``reshard_state`` onto
    a (data 1, model 4) mesh on the card, then from a CPU copy back onto
    the card, 3 more steps; bitwise 6 steps without a reshard."""
    from repro_torch import tree as tr
    from repro_torch.configs import get_arch
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.launch.shardings import (P, recsys_param_specs,
                                              state_specs)
    from repro_torch.launch.steps import build_bundle
    from repro_torch.train.elastic import reshard_state

    spec = get_arch("deepfm")
    cfg = spec.config
    bundle = build_bundle(spec, "train_batch", device=dev)
    params = bundle.init_params(torch.Generator(device=dev).manual_seed(SEED))
    batch = bundle.make_batch(SEED)
    state0 = bundle.make_state(params)

    def run(state, steps):
        losses = []
        for _ in range(steps):
            state, m = bundle.fn(state, batch)
            losses.append(m["loss"].item())
        return state, losses

    def placed(mesh):
        return state_specs(recsys_param_specs(cfg, mesh), params, mesh)

    # the embedding gradient's scatter-add is deterministic only so
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True, warn_only=True)
    reset_counts(kernels)
    try:
        want, want_l = run(state0, 2 * ELASTIC_STEPS)
        state, l1 = run(state0, ELASTIC_STEPS)
        mesh4 = LocalMesh((1, 4), ("data", "model"), dev)
        nb = nbytes(*tr.leaves(state))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        moved = reshard_state(state, mesh4, placed(mesh4))
        torch.cuda.synchronize()
        d2d_s = time.perf_counter() - t0
        check(all(a.data_ptr() != b.data_ptr() and torch.equal(a, b)
                  for a, b in zip(tr.leaves(moved), tr.leaves(state))),
              "path 15 (c): a leaf resharded on the card is not a new, "
              "equal tensor")
        del state
        host = tr.map_tree(lambda x: x.cpu(), moved)
        del moved
        mesh1 = LocalMesh((1, 1), ("data", "model"), dev)
        t0 = time.perf_counter()
        back = reshard_state(host, mesh1, placed(mesh1))
        torch.cuda.synchronize()
        h2d_s = time.perf_counter() - t0
        check(all(x.device == dev for x in tr.leaves(back)),
              "path 15 (c): a leaf resharded from the host is not on the "
              "card")
        del host
        got, l2 = run(back, ELASTIC_STEPS)
    finally:
        torch.use_deterministic_algorithms(False)
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()), f"path 15 (c): launches {counts}")
    check(l1 + l2 == want_l, f"path 15 (c): losses {l1} + {l2}, not the "
                             f"uninterrupted {want_l}")
    check(all(torch.equal(a, b) for a, b in zip(tr.leaves(got),
                                                  tr.leaves(want))),
          "path 15 (c): the final state differs from 6 uninterrupted "
          "steps")
    bad = LocalMesh((1, ELASTIC_BAD_MODEL), ("data", "model"), dev)
    try:
        reshard_state({"table": want["params"]["table"]}, bad,
                      {"table": P("model", None)})
        raised = False
    except ValueError as e:
        raised, why = True, str(e)
    check(raised, f"path 15 (c): P('model', None) on a "
                  f"{ELASTIC_BAD_MODEL}-way model axis was placed")
    log(f"path 15 (c): losses {l1} | {l2} == {want_l}; reshard on the card "
        f"{nb} bytes in {d2d_s:.4f} s ({nb / d2d_s / 1e9:.1f} GB/s), from "
        f"the host {nb} bytes in {h2d_s:.4f} s ({nb / h2d_s / 1e9:.1f} "
        f"GB/s); final state bitwise; planted fault raised: {why} [{card}]")
    out = {"losses": want_l, "state_bytes": nb, "device_to_device_s": d2d_s,
           "host_to_device_s": h2d_s}
    del want, got, back, state0, params
    return out


def dry_card_cell(kernels, dev, label: str, arch: str, spec, shape,
                  card) -> dict:
    """(d) for one cell: ``dryrun.lower_cell`` on a 1-chip meta mesh
    against the real state, batch and step on the card."""
    from repro_torch import tree as tr
    from repro_torch.core.mesh import LocalMesh
    from repro_torch.launch import dryrun, step_stats
    from repro_torch.launch.mesh import META
    from repro_torch.launch.steps import build_bundle

    one = LocalMesh((1, 1), ("data", "model"), META)
    t0 = time.perf_counter()
    _, row = dryrun.lower_cell(arch, shape, multi_pod=False, spec=spec,
                               mesh=one)
    trace_s = time.perf_counter() - t0
    def requested() -> int:
        return torch.cuda.memory_stats()["requested_bytes.all.current"]

    torch.cuda.synchronize()
    before, before_req = torch.cuda.memory_allocated(), requested()
    bundle = build_bundle(spec, shape, device=dev)
    state = bundle.make_state(bundle.init_params(
        torch.Generator(device=dev).manual_seed(SEED)))
    batch = bundle.make_batch(SEED)
    torch.cuda.synchronize()
    added = torch.cuda.memory_allocated() - before
    added_req = requested() - before_req
    nb = nbytes(*tr.leaves(state), *tr.leaves(batch))
    n_leaves = len(tr.leaves(state)) + len(tr.leaves(batch))
    check(row["arg_bytes"] == nb, f"path 15 (d) {label}: arg_bytes "
                                  f"{row['arg_bytes']}, the card's {nb}")
    check(abs(added_req - nb) <= DRY_MEM_TOL * nb,
          f"path 15 (d) {label}: the allocator was asked for {added_req} "
          f"bytes, arg_bytes {nb}")
    check(nb <= added <= nb + n_leaves * 2**20,
          f"path 15 (d) {label}: memory_allocated rose {added} for "
          f"{nb} bytes in {n_leaves} leaves")
    reset_counts(kernels)
    trace = step_stats.trace_step(bundle.fn, (state, batch))
    torch.cuda.synchronize()
    counts = {n: k.launches for n, k in kernels.items()}
    check(not any(counts.values()), f"path 15 (d) {label}: launches "
                                    f"{counts}")
    check(trace.dot_flops == row["trace_flops"],
          f"path 15 (d) {label}: the card's step {trace.dot_flops} FLOPs, "
          f"the dry run's {row['trace_flops']}")
    state = trace.out[0]
    del trace
    reset_peak()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    state, _ = bundle.fn(state, batch)
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    temps = torch.cuda.max_memory_allocated() - held
    out = {"arg_bytes": nb, "memory_allocated_rise": added,
           "requested_bytes_rise": added_req, "leaves": n_leaves,
           "dot_flops": row["trace_flops"], "trace_s": trace_s,
           "t_compute_s": row["t_compute_s"], "step_s": step_s,
           "temporaries_bytes": temps, "bytes_per_device":
           row["bytes_per_device"],
           "useful_flops_ratio": row["useful_flops_ratio"]}
    log(f"path 15 (d) {label}: arg_bytes {nb} == the card's state and "
        f"batch ({n_leaves} leaves); the allocator was asked for "
        f"{added_req} bytes ({added_req / nb - 1:+.6%}), memory_allocated "
        f"rose {added} ({added / nb - 1:+.6%}); dot FLOPs "
        f"{row['trace_flops']} == the card step's; temporaries "
        f"(max_memory_allocated less what the step held) {temps} bytes, "
        f"which the dry run's bytes_per_device ({row['bytes_per_device']}) "
        f"leaves out; t_compute_s {row['t_compute_s']} against a measured "
        f"step of {step_s} s; useful_flops_ratio "
        f"{row['useful_flops_ratio']}; meta trace {trace_s:.1f} s [{card}]")
    del state, batch, bundle
    return out


def dry_card_phase(kernels, dev, card) -> dict:
    """(d): the dry run held to the card on path 12's gemma3 cut and on
    DeepFM ``train_batch``, then both cells' production rows."""
    import gc

    from repro_torch.configs import get_arch, get_shape
    from repro_torch.launch import dryrun

    g = get_arch("gemma3_12b")
    cut = dataclasses.replace(g, config=dataclasses.replace(
        g.config, n_layers=LM_TRAIN_LAYERS))
    cut_shape = dataclasses.replace(get_shape(g, "train_4k"),
                                    global_batch=LM_TRAIN_BATCH)
    out = {"gemma3": dry_card_cell(
        kernels, dev, f"gemma3_12b train_4k ({LM_TRAIN_LAYERS} layers, "
        f"batch {LM_TRAIN_BATCH})", "gemma3_12b", cut, cut_shape, card)}
    gc.collect()
    torch.cuda.empty_cache()
    d = get_arch("deepfm")
    out["deepfm"] = dry_card_cell(kernels, dev, "deepfm train_batch",
                                  "deepfm", d, "train_batch", card)
    gc.collect()
    torch.cuda.empty_cache()
    rows = []
    for arch, shape in (("gemma3_12b", "train_4k"),
                        ("deepfm", "train_batch")):
        for mp in (False, True):
            _, row = dryrun.lower_cell(arch, shape, multi_pod=mp)
            rows.append(row)
            log(f"path 15 (d) dry run {arch} {shape} {row['mesh']}: "
                f"{json.dumps(row)}")
    out["production_rows"] = rows
    return out


def elastic_phase(kernels, dev, g4, roots1, want1, pad4, sw, roots2, want2,
                  card) -> dict:
    """Path 15 (module docstring): (a), (b) elastic BFS, (c) an elastic
    train state, (d) the dry run against the card.  Each part resets the
    launch counts before each run it makes and reads them after; (c) and
    (d) launch none."""
    import gc

    out, times = {}, {}
    for key, fn in (
            ("a", lambda: elastic_bfs_phase(kernels, g4, roots1, want1,
                                            pad4, card)),
            ("b", lambda: elastic_bits_phase(kernels, *sw, roots2, want2,
                                             card)),
            ("c", lambda: elastic_train_phase(kernels, dev, card)),
            ("d", lambda: dry_card_phase(kernels, dev, card))):
        t0 = time.perf_counter()
        out[key] = fn()
        times[key] = time.perf_counter() - t0
        gc.collect()
        torch.cuda.empty_cache()
    launches = dict.fromkeys(kernels, 0)
    launches["fold_update"] = sum(r["a1_launches"] for r in out["a"].values())
    for r in out["b"].values():
        for n, c in r["launches"].items():
            launches[n] += c
    check(launches["fold_update"] > 0 and launches["bsr_expand_bits"] > 0,
          f"path 15: launches {launches}")
    out["launches"], out["seconds"] = launches, times
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="profile one more run of each path")
    args = ap.parse_args(argv)
    global T_START
    T_START = time.perf_counter()

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; the port's "
              "kernels need a CUDA card", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))

    from repro_torch.configs import bfs_workload
    from repro_torch.core import BFSOptions, plan
    from repro_torch.core.frontier import INF, pack_bits
    from repro_torch.core.ref import validate_bfs
    from repro_torch.graphs import generate, shard_graph
    from repro_torch.kernels import _build
    from repro_torch.kernels.bsr_spmm import ops as spmm_ops
    from repro_torch.kernels.bsr_spmm.kernel import (bitpack_words,
                                                     bitpack_words_plain,
                                                     block_row_ptr,
                                                     bsr_expand_bits,
                                                     bsr_expand_bits_plain,
                                                     bsr_spmm)
    from repro_torch.kernels.bsr_spmm.ref import bsr_spmm_ref
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_sum
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.fold_update import fold_update, fold_update_plain

    # the plain A2 is an f32 bmm, DeepFM's MLP f32 matrix products
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernels = {"fold_update": fold_update, "bsr_spmm": bsr_spmm,
               "bitpack_words": bitpack_words,
               "bsr_expand_bits": bsr_expand_bits,
               "flash_attention": flash_attention,
               "embedding_bag_sum": embedding_bag_sum}

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    lib = _build.build()
    _build.library()
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    build_log = lib.with_suffix(".log").read_text().strip()
    log(build_log)
    xptxas = ptxas_lines(build_log, "bsr_expand_bits_kernel")
    log(f"build: bsr_expand_bits_kernel (-Xptxas -v): {xptxas}; dynamic "
        f"shared memory {_build.library().bfs_expand_bits_smem()} bytes")
    check(bool(xptxas), "build: no ptxas report for bsr_expand_bits_kernel")
    sass_text = library_sass(lib)
    sass = {int(k): v for k, v in sass_counts(
        sass_text, r"flash_fwd_wgmmaILi(\d+)E", ("HGMMA", "UTMALDG")).items()}
    log(f"build: bf16 A4 SASS (cuobjdump -sass): {sass}")
    check(len(sass) == 4 and all(c["HGMMA"] and c["UTMALDG"]
                                 for c in sass.values()),
          "build: a bf16 A4 kernel has no HGMMA or no UTMALDG in its SASS")
    a2_ptxas = ptxas_lines(build_log, "bsr_spmm_kernel")
    a2_sass = sass_counts(sass_text, r"(bsr_spmm_kernel)",
                          ("HGMMA", "UTMALDG")).get("bsr_spmm_kernel", {})
    a2_serial = [line.strip() for line in build_log.splitlines()
                 if "C7520" in line and "bsr_spmm_kernel" in line]
    log(f"build: A2 bsr_spmm_kernel (-Xptxas -v): {a2_ptxas}; SASS "
        f"(cuobjdump -sass): {a2_sass}; wgmma serialised: {a2_serial}")
    check("0 bytes spill stores, 0 bytes spill loads" in a2_ptxas,
          "build: bsr_spmm_kernel has no ptxas report or spills")
    check(a2_sass.get("HGMMA", 0) > 0 and a2_sass.get("UTMALDG", 0) > 0,
          "build: bsr_spmm_kernel has no HGMMA or no UTMALDG in its SASS")
    f32_ptxas = ptxas_reports(build_log, "flash_fwd_tf32")
    f32_sass = sass_counts(sass_text, r"flash_fwd_tf32ILi(\d+)E",
                           ("HGMMA", "UTMALDG"))
    split_ptxas = ptxas_lines(build_log, "split_kv_kernel")
    for fn, line in f32_ptxas.items():
        log(f"build: A4 f32 {fn} (-Xptxas -v): {line}")
    log(f"build: A4 f32 flash_fwd_tf32 SASS (cuobjdump -sass; head width): "
        f"{f32_sass}; pre-pass split_kv_kernel (-Xptxas -v): "
        f"{split_ptxas}")
    check(len(f32_ptxas) == 4 and all(
        "0 bytes spill stores, 0 bytes spill loads" in line
        for line in f32_ptxas.values())
        and "0 bytes spill stores, 0 bytes spill loads" in split_ptxas,
        "build: an f32 A4 kernel or its pre-pass has no ptxas report or "
        "spills")
    check(len(f32_sass) == 4 and all(c["HGMMA"] and c["UTMALDG"]
                                     for c in f32_sass.values()),
          "build: an f32 A4 kernel has no HGMMA or no UTMALDG in its SASS")
    gather_ptxas = ptxas_reports(build_log, "bag_gather_kernel")
    for fn, line in gather_ptxas.items():
        log(f"build: A5 {fn} (-Xptxas -v): {line}")
    check(len(gather_ptxas) == 6 and all(
        "0 bytes spill stores, 0 bytes spill loads" in line
        for line in gather_ptxas.values()),
        "build: a bag_gather_kernel has no ptxas report or spills")
    gather_sass = sass_counts(sass_text, r"bag_gather_kernelI(\w+?)Li(\d+)E",
                              ("LDGSTS", "UBLKCP"))
    log(f"build: A5 bag_gather_kernel SASS (cuobjdump -sass; dtype/granule): "
        f"{gather_sass}")
    check(len(gather_sass) == 6 and all(c["LDGSTS"] + c["UBLKCP"]
                                        for c in gather_sass.values()),
          "build: a bag_gather_kernel has no asynchronous copy in its SASS")
    card = card_line()
    log(f"card: {card}")

    # --------------------------------------------------------------- path 1
    w1 = bfs_workload("rmat_1m")
    n1 = w1.n_vertices
    t0 = time.perf_counter()
    src1, dst1 = generate(w1.graph, n1, seed=SEED, **dict(w1.gen_kwargs))
    deg = np.bincount(src1, minlength=n1)
    roots1 = np.random.default_rng(SEED).choice(np.flatnonzero(deg > 0), S,
                                                replace=False)
    log(f"path 1: {w1.name} n={n1} directed edges={src1.size} "
        f"(generated in {time.perf_counter() - t0:.1f} s), S={S}")
    path1, g1_p4 = {}, None
    for label, p, opts in (("p4_default", 4, BFSOptions()),
                           ("p1_packed", 1, BFSOptions(wire_format="packed"))):
        g = shard_graph(src1, dst1, n1, p)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pl = plan(g, opts, num_sources=S)
        eng = pl.compile()
        torch.cuda.synchronize()
        compile_ms = (time.perf_counter() - t0) * 1e3
        d = pl.describe()
        log(f"path 1 {label}: dense_exchange={d['dense_exchange']} "
            f"fused={d['use_fused_tail']} dense_level_bytes="
            f"{d['dense_level_bytes']}")
        host, run_ms, res, counts = drive(kernels, eng, roots1)
        check(counts["fold_update"] > 0,
              f"path 1 {label}: kernel A1 never launched")
        validate_bfs(src1, dst1, roots1, res.dist[:n1, :S])
        report_run(f"path 1 {label}", compile_ms, run_ms, res, counts)
        roofline_line(f"path 1 {label}", d, res.run_stats,
                      ["dense"] * res.run_stats.levels)
        if args.profile:
            profile_run(f"path 1 {label}", lambda: eng.run(roots1))
        path1[label] = (host, counts, d, res.run_stats)
        if p == 4:
            g1_p4 = g
            pad4 = res.dist.cpu().numpy()      # path 15 (a) repartitions it
        del eng, res
    check(np.array_equal(path1["p4_default"][0], path1["p1_packed"][0]),
          "path 1: p=4 and p=1 distances differ")
    scipy_check(src1, dst1, n1, roots1, path1["p4_default"][0], INF)
    log("path 1: validate_bfs on all columns, scipy on 4 columns, p=4 == p=1: ok")

    # --------------------------------------------------------------- path 3
    path3 = path3_phase(kernels, g1_p4, src1, dst1, roots1,
                        path1["p4_default"][0], dev, args.profile)
    log("path 3: validate_bfs on all columns, distances == path 1 "
        "p4_default, bsr_expand_bits once a level: ok")

    # --------------------------------------------------------------- path 2
    w2 = bfs_workload("small_world_100k")
    n2 = w2.n_vertices
    src2, dst2 = generate(w2.graph, n2, seed=SEED, **dict(w2.gen_kwargs))
    roots2 = np.random.default_rng(SEED).choice(n2, S, replace=False)
    g2 = shard_graph(src2, dst2, n2, 1)
    log(f"path 2: {w2.name} n={n2} directed edges={src2.size}, S={S}")
    reset_peak()
    t0 = time.perf_counter()
    pl2 = plan(g2, BFSOptions(use_kernel=True, wire_format="packed"),
               num_sources=S)
    eng2 = pl2.compile()
    torch.cuda.synchronize()
    compile_ms = (time.perf_counter() - t0) * 1e3
    host2, run_ms, res2, counts2 = drive(kernels, eng2, roots2)
    check(counts2["fold_update"] > 0, "path 2: kernel A1 never launched")
    check(counts2["bsr_expand_bits"] == 3 * res2.run_stats.levels,
          f"path 2: bsr_expand_bits launched {counts2['bsr_expand_bits']} "
          f"times in 3 runs of {res2.run_stats.levels} levels")
    check(counts2["bsr_spmm"] == 0 and counts2["bitpack_words"] == 0,
          "path 2: the f32 A2 or A3 launched under use_kernel")
    validate_bfs(src2, dst2, roots2, res2.dist[:n2, :S])
    report_run("path 2 use_kernel", compile_ms, run_ms, res2, counts2)
    log(f"path 2: peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; the engine's "
        f"bit tiles {nbytes(eng2.kernel_arrays[0]) / 1e9:.3f} GB")
    if args.profile:
        profile_run("path 2 use_kernel", lambda: eng2.run(roots2))
    eng2b = plan(g2, BFSOptions(wire_format="packed"), num_sources=S).compile()
    host2b = eng2b.run(roots2).dist_host
    del eng2b
    check(np.array_equal(host2, host2b),
          "path 2: use_kernel distances differ from the plain expansion")
    scipy_check(src2, dst2, n2, roots2, host2, INF)
    log("path 2: validate_bfs on all columns, scipy on 4 columns, "
        "use_kernel == plain expansion: ok")
    log(f"path 2: span cost {json.dumps(span_cost(eng2, roots2))}")

    # --------------------------------------------------------------- path 4
    # (after path 2, so that path 2 runs where it ran before path 4 came)
    path4_phase(kernels, g1_p4, src1, roots1, path1["p4_default"][0],
                args.profile)
    log("path 4: auto (S = 64 and 1) and queue (S = 1) distances == path 1, "
        "auto mode_counts == the numpy replay, A1 once a dense level: ok")

    # --------------------------------------------------------------- path 5
    a1_path5, path5_a = path5_phase(kernels, g1_p4, src1, roots1,
                                    path1["p4_default"][0], args.profile)
    log("path 5: the 2 x 2 grid in dense (S = 64), auto (S = 64 and 1) and "
        "queue (S = 1): distances == path 1, auto mode_counts == the numpy "
        "replay, A1 once a dense level: ok")

    # --------------------------------------------------------------- path 6
    path6 = serving_phase(kernels, g1_p4, path1["p4_default"][0], roots1,
                          g2, host2, roots2, dev, card)
    log("path 6: 48 HTTP requests on four lanes bitwise the paths' "
        "distances, parents valid, 9 compiles for 9 plan keys, one block "
        "upload a group, estimates above the measured peaks, the LRU rung "
        "evicted and freed, the split:8 arm bitwise: ok")

    # --------------------------------------------------------------- path 7
    tmp7 = ROOT / "build" / "chip_smoke_path7"
    if tmp7.exists():
        shutil.rmtree(tmp7)
    tmp7.mkdir(parents=True)
    path7 = launchers_phase(kernels, g1_p4, src1, dst1, dev, tmp7)
    log("path 7: bfs_run (1-D dense with its phase split, 2-D auto) equal "
        "to the engines, A1 once a level, bfs_serve --http verified by "
        "bfs_client on three lanes and drained, the chaos soak's verdict "
        "with a storm served: ok")

    # --------------------------------------------------------------- path 8
    tmp8 = ROOT / "build" / "chip_smoke_path8"
    if tmp8.exists():
        shutil.rmtree(tmp8)
    tmp8.mkdir(parents=True)
    path8 = audit_phase(kernels, g1_p4, src1, dst1, (src2, dst2, n2), host2,
                        roots2, dev, tmp8)
    log("path 8: bfs_audit --all-variants clean with the host reads counted "
        "by sync debug mode, bfs_run --audit on rmat_1m bitwise path 1's "
        "engine with A1 once a level, bsr_expand_bits audited on "
        "small_world_100k bitwise path 2: ok")

    # --------------------------------------------------------------- path 9
    tmp9 = ROOT / "build" / "chip_smoke_path9"
    shutil.rmtree(tmp9, ignore_errors=True)
    tmp9.mkdir(parents=True)
    path9 = path9_phase(g1_p4, src1, dst1, roots1, path1["p4_default"][0],
                        path1, path5_a, (src2, dst2, n2), host2, roots2,
                        card, tmp9)
    shutil.rmtree(tmp9)            # the graphs' files, gigabytes of them
    log("path 9: DistMesh, nccl at world size 1 bitwise path 1 p=1; gloo, "
        "4 ranks on the card: dense, auto S = 1, the 2 x 2 grid and "
        "use_kernel bitwise paths 1, 4, 5 (a) and 2, A1 and "
        "bsr_expand_bits once a level on every rank, the census at ratio "
        "1.000 within the read budget, a wrong shard index rejected: ok")

    # -------------------------------------------------------------- prefill
    lay = prefill_phase(kernels, dev, args.profile)
    log("prefill: logits finite, runs 2 == 3, A4 12 a run, within "
        "tolerance of the plain attention: ok")

    # --------------------------------------------------------------- recsys
    rec = recsys_phase(kernels, dev, args.profile)
    log("recsys: serve and retrieval runs 2 == 3, held to the f64 CPU twin, "
        "the planted offset fault fails: ok")

    # -------------------------------------------------------- embedding bag
    bag_row = bag_phase(rec, kernels, dev)
    del rec
    log("embedding bag: A5 bitwise to its plain version on (a)-(d), "
        "by both routes: ok")

    # -------------------------------------------------------------- kernels
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = []

    # A1 at path 1's p=4 shapes: (4, W, S) words against (4, m, S) dist
    part = shard_graph(src1[:1], dst1[:1], n1, 4).part
    m, w = part.shard_size, (part.shard_size + 31) // 32
    words = torch.randint(-2 ** 31, 2 ** 31, (4, w, S), generator=gen,
                          device=dev, dtype=torch.int64).to(torch.int32)
    if m % 32:                             # pad bits of the last word zero
        words[:, -1] &= (1 << (m % 32)) - 1
    dist = torch.where(torch.rand((4, m, S), generator=gen, device=dev) < 0.5,
                       INF, torch.randint(0, 12, (4, m, S), generator=gen,
                                          device=dev)).to(torch.int32)
    got = fold_update(words, dist, 7)
    want = fold_update_plain(words, dist, 7)
    err1 = max(int((a.long() - b.long()).abs().max()) for a, b in zip(got, want))
    check(err1 == 0, f"A1 differs from its plain version by {err1}")
    b_ms, b_by = bound(nbytes(words, dist, *got))
    rows.append({
        "name": "fold_update", "route": "cuda",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/fold_update.py:57",
        "launches": path1["p4_default"][1]["fold_update"],
        "launches_path5": a1_path5,
        "launches_path6": path6["fold_update"],
        "launches_path7": sum(path7.values()),
        "launches_path8": path8["rmat"] + path8["sw"]["fold_update"],
        "launches_path9": path9["fold_update"],
        "max_abs_err": err1,
        "ms": timed_ms(lambda: fold_update(words, dist, 7), 50),
        "plain_ms": timed_ms(lambda: fold_update_plain(words, dist, 7),
                             10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "shape": f"words {tuple(words.shape)}, dist {tuple(dist.shape)}"})
    del words, dist, got, want

    # bsr_expand_bits at path 2's shapes: the engine's own operands, on the
    # run's densest level and on a random 5% frontier
    xops_in = eng2.kernel_arrays
    xtiles, xmask, _, xrows, xcols = xops_in
    part2 = g2.part
    pad2 = -(-part2.n // 128) * 128        # p = 1: rows and columns alike
    layout = dict(n_valid=part2.n, n_blocks=1, rows_per_group=pad2)
    dense, depth, pairs = densest_frontier(host2, part2.n, INF, dev)
    fronts = {f"the densest level (depth {depth}, {pairs} pairs)": dense,
              "a random 5% frontier": (torch.rand(
                  (part2.n, S), generator=gen, device=dev) < 0.05).to(
                      torch.uint8)}
    xops, errx = {}, 0
    for what, mask in fronts.items():
        fw = frontier_words(mask, 1, pad2)
        got = bsr_expand_bits(*xops_in, fw, **layout)
        want = bsr_expand_bits_plain(*xops_in, fw, **layout)
        errx = max(errx, int((got.long() - want.long()).abs().max()))
        check(torch.equal(got, want),
              f"bsr_expand_bits differs from its plain version on {what}")
        log(f"bsr_expand_bits on {what}: bitwise to its plain version")
        xops[what] = (mask, fw, got)
        del want
    dense_what = next(iter(xops))
    _, fw, got = xops[dense_what]
    xb = expand_bound(xtiles, xmask, xrows, xcols, fw, got)
    x_ms = timed_ms(lambda: bsr_expand_bits(*xops_in, fw, **layout), 20)
    x_plain_ms = timed_ms(lambda: bsr_expand_bits_plain(*xops_in, fw,
                                                        **layout), 2)
    log(f"bsr_expand_bits at path 2 on {dense_what}: {x_ms} ms; bound "
        f"{xb['bound_ms']} ms ({xb['bound_by']}; {xb['tiles_read']} of "
        f"{xb['tiles']} tiles read), every tile {xb['bound_all_tiles_ms']} "
        f"ms; plain {x_plain_ms} ms")
    xrow = {
        "name": "bsr_expand_bits", "route": "cuda",
        "design": "one-bit tiles, skip by column mask, cp.async + mbarrier "
                  "ring, atomicOr merge of split rows",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:38",
        "fuses": "src/repro/kernels/bsr_spmm/kernel.py:100",
        "launches": counts2["bsr_expand_bits"],
        "launches_path6": path6["bsr_expand_bits"],
        "launches_path8": path8["sw"]["bsr_expand_bits"],
        "launches_path9": path9["bsr_expand_bits"], "max_abs_err": errx,
        "ms": x_ms, "plain_ms": x_plain_ms, "bound_ms": xb["bound_ms"],
        "bound_by": xb["bound_by"], "library_ms": None,
        "bound_all_tiles_ms": xb["bound_all_tiles_ms"],
        "tiles_read": xb["tiles_read"], "tiles": xb["tiles"],
        "shape": f"path 2: {xtiles.shape[0]} bit tiles, frontier words "
                 f"{tuple(fw.shape)} ({dense_what})",
        "path3": path3}

    # the f32 A2 + A3 chain, driven through its entry point
    # ops.frontier_expand_packed on path 2's f32 tiles and both frontiers,
    # held bitwise to bsr_expand_bits
    blocks, brs, bcs, row_pad2, col_pad2 = g2.bsr_shards(device=dev)
    tiles, trows, tcols = blocks[0], brs[0], bcs[0]
    del blocks
    row_ptr = block_row_ptr(trows, tcols, row_pad2 // 128, col_pad2 // 128)
    reset_counts(kernels)
    for what, (mask, _, got) in xops.items():
        x = torch.zeros((col_pad2, S), dtype=torch.uint8, device=dev)
        x[:part2.n] = mask
        words = spmm_ops.frontier_expand_packed(
            tiles, trows, tcols, x, n_rows_pad=row_pad2, n_valid=part2.n,
            n_blocks=1, row_ptr=row_ptr)
        check(torch.equal(words, got), f"the f32 A2 + A3 chain differs from "
                                       f"bsr_expand_bits on {what}")
    torch.cuda.synchronize()
    counts_ops = {name: k.launches for name, k in kernels.items()}
    check(counts_ops == dict.fromkeys(kernels, 0) | {
        "bsr_spmm": len(xops), "bitpack_words": len(xops)},
        f"ops.frontier_expand_packed: launches {counts_ops}")
    log(f"ops.frontier_expand_packed (f32 A2 + A3) on both frontiers: "
        f"bitwise to bsr_expand_bits; launches {counts_ops}")
    del xops, fronts, dense

    # A2 at path 2's shapes: the f32 tiles against an (n_cols_pad, S) x
    n_rows_pad = row_pad2
    n_x = col_pad2                         # p = 1: one shard, square tiles
    x01 = (torch.rand((n_x, S), generator=gen, device=dev) < 0.05).float()
    xf = torch.rand((n_x, S), generator=gen, device=dev) * 2 - 1
    y01 = bsr_spmm(tiles, row_ptr, tcols, x01, n_rows_pad=n_rows_pad)
    check(torch.equal(y01, bsr_spmm_ref(tiles, trows, tcols, x01,
                                        n_rows_pad=n_rows_pad)),
          "A2 differs from bsr_spmm_ref on 0/1 operands")
    yf = bsr_spmm(tiles, row_ptr, tcols, xf, n_rows_pad=n_rows_pad)
    yf_ref = bsr_spmm_ref(tiles, trows, tcols, xf, n_rows_pad=n_rows_pad)
    err2 = float((yf - yf_ref).abs().max())
    # f32 sums in another order: each output sums at most `deg_max` terms
    # of magnitude <= 1, so the two orders differ by at most
    # 2 * deg_max * eps * deg_max
    deg_max = int(np.bincount(dst2, minlength=n2).max())
    tol2 = 2.0 * deg_max * deg_max * float(torch.finfo(torch.float32).eps)
    check(err2 <= tol2, f"A2 differs from bsr_spmm_ref by {err2} > {tol2}")
    # one consumer owns each output block and sums its tiles in order
    check(torch.equal(yf, bsr_spmm(tiles, row_ptr, tcols, xf,
                                   n_rows_pad=n_rows_pad)),
          "A2 gives another y on a second run on the same operands")
    # a planted fault the hold must catch: the same product in one pass of
    # TF32 (the plain version's bmm with allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        y_tf32 = bsr_spmm_ref(tiles, trows, tcols, xf, n_rows_pad=n_rows_pad)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err_tf32 = float((y_tf32 - yf_ref).abs().max())
    del y_tf32
    log(f"A2 f32 hold on x in [-1, 1): split TF32 (the kernel) {err2}, one "
        f"pass of TF32 (bmm, allow_tf32) {err_tf32}, tol2 {tol2}")
    check(err_tf32 > tol2, f"the A2 hold passes one-pass TF32 products "
                           f"({err_tf32} <= {tol2})")
    flops = 2.0 * tiles.shape[0] * 128 * 128 * S
    b_ms, b_by = bound(nbytes(tiles, row_ptr, tcols, x01, y01), 3 * flops,
                       TF32_FLOPS)
    # the one-call yardstick (timed here only; the port never calls it)
    bsr = torch.sparse_bsr_tensor(row_ptr, tcols, tiles,
                                  size=(n_rows_pad, n_x),
                                  check_invariants=False)
    check(torch.equal(bsr @ x01, y01), "torch BSR @ x disagrees on 0/1")
    library_ms = timed_ms(lambda: bsr @ x01, 5)
    a2_ms = timed_ms(lambda: bsr_spmm(tiles, row_ptr, tcols, x01,
                                      n_rows_pad=n_rows_pad), 20)
    log(f"A2 at path 2 ({tiles.shape[0]} tiles, x {tuple(x01.shape)}): "
        f"{a2_ms} ms = {flops / a2_ms / 1e9} TFLOP/s, {b_ms / a2_ms:.4f} of "
        f"the bound {b_ms} ms ({b_by}); torch BSR {library_ms} ms")
    rows.append({
        "name": "bsr_spmm", "route": "cuda",
        "design": "split TF32 (3 products) on wgmma m64n128k8, TMA panel "
                  "ring, persistent grid by block row",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:38",
        "path": "ops.frontier_expand_packed / ops.spmm (not the engine's)",
        "launches": counts_ops["bsr_spmm"], "max_abs_err": err2,
        "max_abs_err_one_pass_tf32": err_tf32,
        "ms": a2_ms,
        "plain_ms": timed_ms(lambda: bsr_spmm_ref(
            tiles, trows, tcols, x01, n_rows_pad=n_rows_pad), 3),
        "bound_ms": b_ms, "bound_by": b_by,
        "bound_fma_ms": flops / F32_FLOPS * 1e3,
        "bound_tf32x3_ms": 3 * flops / TF32_FLOPS * 1e3,
        "library_ms": library_ms,
        "tflops": flops / a2_ms / 1e9, "bound_share": b_ms / a2_ms,
        "shape": f"{tiles.shape[0]} tiles, x {tuple(x01.shape)}",
        "tolerance_f32": tol2, "sass": a2_sass})
    del xf, yf, yf_ref, bsr

    # A3 at path 2's shapes: pack the (n, S) expansion sums
    mask = y01[:n2] if n2 % 32 == 0 else y01[: n2 - n2 % 32]
    packed = bitpack_words(mask)
    want3 = bitpack_words_plain(mask)
    err3 = int((packed.long() - want3.long()).abs().max())
    check(err3 == 0 and torch.equal(want3, pack_bits(mask > 0)),
          f"A3 differs from its plain version by {err3}")
    b_ms, b_by = bound(nbytes(mask, packed))
    # the kernel alone: 50 launches captured in a CUDA graph, so no host
    # time between launches (the wrapper's time is 50 calls from Python);
    # over one mask, which stays in L2 after the first launch (as A2's y
    # does when ops.frontier_expand_packed packs it), and over four masks
    # in turn, 102 MB, past the 50 MB L2: each launch reads from HBM
    def graph_ms(inputs) -> float:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            bitpack_words(inputs[0])
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for i in range(50):
                bitpack_words(inputs[i % len(inputs)])
        return timed_ms(graph.replay, 10) / 50

    a3_warm_ms = graph_ms([mask])
    a3_kernel_ms = graph_ms([mask] + [mask.clone() for _ in range(3)])
    a3_ms = timed_ms(lambda: bitpack_words(mask), 50)
    log(f"A3 at path 2 (mask {tuple(mask.shape)}): the kernel alone "
        f"{a3_kernel_ms} ms from HBM, {a3_warm_ms} ms from L2 (CUDA graphs "
        f"of 50 launches), the wrapper {a3_ms} ms (50 calls); bound {b_ms} "
        f"ms ({b_by})")
    rows.append({
        "name": "bitpack_words", "route": "cuda",
        "source": "src/repro_torch/csrc/bfs_kernels.cu",
        "replaces": "src/repro/kernels/bsr_spmm/kernel.py:100",
        "path": "ops.frontier_expand_packed (not the engine's)",
        "launches": counts_ops["bitpack_words"], "max_abs_err": err3,
        "ms": a3_kernel_ms, "ms_l2": a3_warm_ms, "wrapper_ms": a3_ms,
        "plain_ms": timed_ms(lambda: bitpack_words_plain(mask), 10),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "bound_share": b_ms / a3_kernel_ms,
        "shape": f"mask {tuple(mask.shape)}"})
    rows.append(xrow)
    del tiles, y01, x01

    rows.append(attention_rows(lay, dev, sass))
    rows.append(attention_f32_row(lay, kernels, dev, f32_sass))
    rows.append(bag_row)

    # -------------------------------------------------------------- path 10
    tmp10 = ROOT / "build" / "chip_smoke_path10"
    shutil.rmtree(tmp10, ignore_errors=True)
    tmp10.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        path10 = train_phase(kernels, dev, tmp10)
    finally:
        shutil.rmtree(tmp10, ignore_errors=True)   # the checkpoints, GBs
    log(f"path 10: DeepFM train_batch uncut through launch.train, 20 "
        f"finite losses, one f32 step within {TRAIN_TOL} of its f64 twin "
        f"(no bias correction and TF32 products fail it), the fault at step "
        f"{TRAIN_FAULT_STEP} replayed from step {TRAIN_CKPT_EVERY} to the "
        f"clean run's loss, topk and bf16 steps: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"path 10 summary: {json.dumps(path10)}")

    # -------------------------------------------------------------- path 11
    t0 = time.perf_counter()
    path11 = decode_phase(kernels, dev)
    log(f"path 11: decode within {DECODE_TOL} of the A4 prefill (a window "
        f"one key off fails it), gemma3-12b served at 48 layers, request 0 "
        f"alone equal, first tokens the prefill's argmax where clear: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"path 11 summary: {json.dumps(path11)}")

    # -------------------------------------------------------------- path 12
    tmp12 = ROOT / "build" / "chip_smoke_path12"
    shutil.rmtree(tmp12, ignore_errors=True)
    tmp12.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        path12 = lm_train_phase(kernels, dev, tmp12, args.profile)
    finally:
        shutil.rmtree(tmp12, ignore_errors=True)   # the checkpoint, 34 GB
    log(f"path 12: gemma3-12b train_4k at full width (6 layers, batch 4) "
        f"through the Trainer, the loss falling from ln V + 1/2, A4 never "
        f"launched, the checkpoint restored bitwise, flash_train within "
        f"{FLASH_TOL} of the plain softmax, the bf16 step within {STEP_TOL} "
        f"of f32 (each planted fault fails them), remat and microbatches "
        f"agree, the trained state served with A4: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"path 12 summary: {json.dumps(path12)}")
    # -------------------------------------------------------------- path 13
    tmp13 = ROOT / "build" / "chip_smoke_path13"
    shutil.rmtree(tmp13, ignore_errors=True)
    tmp13.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        path13 = gnn_phase(kernels, dev, tmp13, (src1, dst1, n1),
                           args.profile)
    finally:
        shutil.rmtree(tmp13, ignore_errors=True)
    log(f"path 13: gcn_cora on ogb_products uncut through launch.train, "
        f"gatedgcn on minibatch_lg and schnet on molecule through the "
        f"Trainer, each f32 step within {GNN_TOL} of its f64 twin (the dst "
        f"fault fails it), the sampler's edges real and its shapes the "
        f"bundle's, graphcast owner-exchange within JAX's limits of the "
        f"global model (rolled serve_ids fail them), no kernel launched: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"path 13 summary: {json.dumps(path13)}")
    # -------------------------------------------------------------- path 14
    tmp14 = ROOT / "build" / "chip_smoke_path14"
    shutil.rmtree(tmp14, ignore_errors=True)
    tmp14.mkdir(parents=True)
    t0 = time.perf_counter()
    try:
        path14 = moe_phase(kernels, dev, tmp14)
    finally:
        shutil.rmtree(tmp14, ignore_errors=True)
    log(f"path 14: dbrx-132b (4 layers) and llama4-maverick (2 layers) at "
        f"full width, each MoE layer within {MOE_TOL} of its f32 twin (the "
        f"dispatch one slot off and unnormalised gates fail it), decode "
        f"within {DECODE_TOL} of the no-drop A4 prefill, llama4's sharded "
        f"route on LocalMesh (1, 4) within {SHARDED_TOL} of the local one; "
        f"yi-34b served at 60 layers; qwen1.5-110b's A4 prefill with "
        f"nonzero biases within {PREFILL_TOL} of the plain one (bk dropped "
        f"fails it); dbrx train_4k falling through the Trainer: ok "
        f"({time.perf_counter() - t0:.1f} s)")
    log(f"path 14 summary: {json.dumps(path14)}")
    # -------------------------------------------------------------- path 15
    t0 = time.perf_counter()
    path15 = elastic_phase(kernels, dev, g1_p4, roots1,
                           path1["p4_default"][0], pad4, (src2, dst2, n2),
                           roots2, host2, card)
    del g1_p4, pad4
    log(f"path 15: rmat_1m repartitioned 4 -> 2 and 4 -> 1 and "
        f"small_world_100k 4 -> 2 -> 1 under use_kernel, distances bitwise "
        f"paths 1 and 2, A1 and bsr_expand_bits once a level; DeepFM "
        f"train_batch resharded on the card and from the host, losses and "
        f"state bitwise 6 uninterrupted steps, the 7-way spec refused; the "
        f"dry run's arg_bytes and dot FLOPs equal to the card's on path "
        f"12's gemma3 cut and DeepFM: ok "
        f"({time.perf_counter() - t0:.1f} s; parts {path15['seconds']})")
    log(f"path 15 summary: {json.dumps(path15)}")
    # paths 13 to 15 add no kernel: each row carries its launches there
    for row in rows:
        if row["name"] not in kernels:   # A4's f32 route: ops.attention only
            continue
        if row["name"] == "flash_attention":
            row["launches_path11"] = (path11["a"]["a4_launches"]
                                      + path11["b"]["a4_launches"])
            row["launches_path12"] = path12["e"]["a4_launches"]
        row["launches_path13"] = path13["launches"][row["name"]]
        row["launches_path14"] = path14["launches"][row["name"]]
        row["launches_path15"] = path15["launches"][row["name"]]

    log(f"peak device memory over the whole script {peak_gib():.2f} GiB")
    log(f"chip_smoke: {time.perf_counter() - T_START:.1f} s in all")
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
